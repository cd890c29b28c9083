"""`chip_smoke.py` refuses to report success where it cannot run the port's
kernels: on a machine without CUDA, and alone in a directory without the
rest of the repository; its phase-13 accuracy check fails a tracker that
stops; and the tool behind that check's bars runs the port without JAX."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def _run(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300,
    )


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    res = _run(REPO)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "torch.cuda.is_available() is False" in res.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    res = _run(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def _loop_with_frozen_rotation(gt):
    est = np.tile(np.eye(4), (len(gt), 1, 1))
    est[:, :3, 3] = gt[:, :3, 3]
    return est


@pytest.mark.parametrize("case", ["ground truth", "never moves", "rotation stops", "ATE over its bar", "no loop link"])
def test_host_loop_check_separates_a_tracker_from_one_that_stops(case):
    """Phase 13's accuracy check (`chip_smoke.host_loop_check`) on the
    100-frame loop: the ground truth passes; a camera that never moves, one
    whose rotation stops (ATE 0), a path stretched past the ATE bar, and a
    loop without a loop-closure link each fail."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from onepiece_tpu_torch.utils import synthetic

    gt = synthetic.loop_trajectory(chip_smoke.LOOP_FRAMES).astype(np.float64)
    cell = "BASlam loop"
    est, lc = gt, 1
    if case == "never moves":
        est = np.tile(np.eye(4), (len(gt), 1, 1))
    elif case == "rotation stops":
        est = _loop_with_frozen_rotation(gt)
    elif case == "ATE over its bar":
        est = gt.copy()
        est[:, :3, 3] *= 2.0
    elif case == "no loop link":
        lc = 0
    if case == "ground truth":
        r = chip_smoke.host_loop_check(cell, chip_smoke.MAX_LOOP_ATE_M, est, gt, 0, lc)
        assert r["ate_m"] < 1e-6 and r["rpe_span_deg"] < 1e-3
    else:
        with pytest.raises(AssertionError):
            chip_smoke.host_loop_check(cell, chip_smoke.MAX_LOOP_ATE_M, est, gt, 0, lc)


def test_ate_gap_tool_runs_the_port_without_jax():
    """`tools/host_loop_ate_gap.py --packages port` (what runs on the card's
    machine, which has no JAX) with the JAX packages blocked, at 80x60 on a
    9-frame orbit: BASlam at two seeds, and a camera that never moves."""
    argv = ["--packages", "port", "--level", "3", "--orbit-frames", "9", "--cells", "BASlam orbit", "--seeds", "0", "1"]
    code = (
        "import sys, importlib.abc\n"
        "class NoJax(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'onepiece_tpu'):\n"
        "            raise ImportError(name + ' is blocked')\n"
        "sys.meta_path.insert(0, NoJax())\n"
        "import runpy, torch\n"
        "torch.set_num_threads(1)\n"
        f"sys.argv = ['host_loop_ate_gap.py', *{argv!r}]\n"
        f"runpy.run_path({str(REPO / 'tools' / 'host_loop_ate_gap.py')!r}, run_name='__main__')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(out["runs"]) == {"BASlam orbit"}
    for cell in out["runs"].values():
        assert set(cell) == {"port"} and all(len(v) == 2 for v in cell["port"].values())
        assert np.isfinite(cell["port"]["ate_m"]).all()
    assert out["frozen"]["orbit"]["rpe_span_deg"] > 0


def test_scene_phase_checks():
    """Phase 14's pure checks: pixel agreement counts differing pixels;
    `planes_found` finds a plane through a patch within 5 deg and 2 cm (either
    sign of its model), misses one tilted or shifted past those, and does not
    ask for a plane with too little support; `divider_split` holds only
    labels that split the faces at x = 0."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from onepiece_tpu_torch.algorithm.patch_detection import Patch

    a = np.zeros((4, 5, 3), np.float32)
    b = a.copy()
    b[1, 2, 0] = 1.0
    assert cs.pixel_agreement(a, a) == (1.0, 0) and cs.pixel_agreement(a, b) == (19 / 20, 1)

    rng = np.random.default_rng(0)
    floor = np.c_[rng.uniform(-1, 1, 3000), np.full(3000, 0.8), rng.uniform(1, 3, 3000)]
    planes = np.array([[0.0, -1.0, 0.0, 0.8], [0.0, 0.0, -1.0, 3.6]])
    tilt = np.radians(6.0)

    def patch(n, d):
        return Patch(np.arange(10), np.array([*n, d]))

    cases = {
        "found": ([patch((0, -1, 0), 0.8)], True),
        "found, other sign": ([patch((0, 2, 0), -1.6)], True),
        "found within bounds": ([patch((0, -np.cos(np.radians(4)), np.sin(np.radians(4))), 0.815)], True),
        "tilted": ([patch((0, -np.cos(tilt), np.sin(tilt)), 0.8)], False),
        "shifted": ([patch((0, -1, 0), 0.83)], False),
        "no patch": ([], False),
    }
    for name, (patches, ok) in cases.items():
        found = cs.planes_found(floor, patches, planes)
        assert found[0]["asked"] and found[0]["ok"] == ok, (name, found[0])
        assert not found[1]["asked"] and found[1]["ok"] and found[1]["support"] == 0, name

    cents = np.array([[-1.0, 0.0], [-0.5, 0.3], [1.0, 0.0]])
    assert cs.divider_split(np.array([0, 0, 1]), cents)
    assert not cs.divider_split(np.array([0, 1, 1]), cents)
    assert not cs.divider_split(np.array([0, 0, 0]), cents)
