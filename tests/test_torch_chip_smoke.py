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


def test_scannet_phase_rehearsed_on_the_cpu(tmp_path, monkeypatch):
    """Phase 16 end to end on the CPU with the plain versions: the wrappers'
    launch counts are bumped where the plain versions run (the kernels do
    not exist here), CUDA timing is stubbed, the depth is rendered with 8
    sphere-tracing steps and the CLI runs with --device cpu. Every check of
    the phase runs: the decoder and remap hashes, 7 frames integrated with 7
    TSDF and 1 marching-cubes counts, the CPU-against-CPU mesh rule, the
    scene distance, the CLI and the converter read back."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from onepiece_tpu_torch import _build
    from onepiece_tpu_torch.ops import marching_cubes as mc_ops
    from onepiece_tpu_torch.ops import tsdf_slots
    from onepiece_tpu_torch.utils import synthetic

    def bumping(fn, kernel):
        def run(*args, **kwargs):
            kernel.launches += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(tsdf_slots, "integrate_slots", bumping(tsdf_slots.integrate_slots, _build.TSDF_INTEGRATE))
    monkeypatch.setattr(mc_ops, "extract_triangles", bumping(mc_ops.extract_triangles, _build.MARCHING_CUBES))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "cuda_ms", lambda fn, reps=20, warmup=3: 0.0)
    monkeypatch.setattr(cs, "SCANNET_RENDER_STEPS", 8)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the CLI subprocess, pinned as this test is
    monkeypatch.setattr(cs, "SCANNET_CLI_ARGS", (*cs.SCANNET_CLI_ARGS, "--device", "cpu"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = cs.scannet_phase("cpu", "cpu rehearsal", synthetic.default_scene("cpu"), str(tmp_path), 0.0)
    finally:
        torch.set_num_threads(threads)
    assert out["launches"]["tsdf_integrate"] == 7 and out["launches"]["marching_cubes"] == 1
    assert sum(out["launches"].values()) == 8
    assert out["voxels"]["outside"] == 0 and out["voxels"]["seen"] > 10000  # CPU against CPU: equal pools


def test_pool_band_finds_wrong_voxels():
    """Phase 16's voxel-by-voxel rule (`chip_smoke.pool_band`) finds a wrong
    colour, a wrong sdf or a lost weight on a few voxels, and a block that
    one pool lacks, where the block and triangle counts would not; blocks
    are matched by key, not by slot."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from onepiece_tpu_torch.integration.blocks import TSDFVolume

    rng = np.random.default_rng(0)
    keys = [(0, 0, 0), (1, 0, 0), (0, 2, -1)]

    def volume(order):
        vol = TSDFVolume(voxel_size=0.02, truncation=0.1, device="cpu")
        vol.allocate(np.asarray([keys[i] for i in order]))
        return vol

    a, b = volume([0, 1, 2]), volume([2, 0, 1])  # the same blocks in other slots
    sdf = rng.uniform(-1, 1, (3, 512)).astype(np.float32)
    w = rng.integers(0, 4, (3, 512)).astype(np.float32)
    color = rng.uniform(0, 1, (3, 512, 3)).astype(np.float32)
    for vol in (a, b):
        for k, key in enumerate(keys):
            row = vol.slot_of[key]
            vol.sdf[row] = torch.from_numpy(sdf[k].reshape(8, 8, 8))
            vol.weight[row] = torch.from_numpy(w[k].reshape(8, 8, 8))
            vol.color[row] = torch.from_numpy(color[k].reshape(8, 8, 8, 3))
    seen = int((w > 0).sum())
    assert cs.pool_band(a, b, 5e-4, 5e-3) == (0, seen, 0.0, 0.0)
    first = np.argwhere(w[1] > 0)[:3, 0]
    row = b.slot_of[keys[1]]
    b.color.view(-1, 512, 3)[row, first[0], 1] += 0.01
    b.sdf.view(-1, 512)[row, first[1]] += 1e-3
    b.weight.view(-1, 512)[row, first[2]] += 1.0
    outside, n, sdf_err, color_err = cs.pool_band(a, b, 5e-4, 5e-3)
    assert (outside, n) == (3, seen) and sdf_err > 5e-4 and color_err > 5e-3
    c = volume([0, 1])  # the third block lost
    for key in keys[:2]:
        for f in ("sdf", "weight", "color"):
            getattr(c, f)[c.slot_of[key]] = getattr(a, f)[a.slot_of[key]]
    assert cs.pool_band(a, c, 5e-4, 5e-3)[:2] == (int((w[2] > 0).sum()), seen)
