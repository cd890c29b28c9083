"""The harness on the CPU: every cell's traffic at a tiny size, the refusal
without a card, cells and metrics found by name, the import guard, the
trace reduction, and `correct` coming out false under the control and under
each fault the cells can have."""

from __future__ import annotations

import importlib
import importlib.util
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import ROOT, cells, tiny

from portbench import guard, metrics, run, trace
from portbench.traffic import closed_scans

SEED = 2**31 + 123


@pytest.mark.parametrize("cell", cells())
def test_cell_traffic_runs_tiny_then_refuses_without_a_card(cell, capsys):
    _, cfg, mix = tiny(*run.load_cell(cell))
    r = closed_scans.run(cfg, mix, SEED, 0.5, False, device="cpu")
    assert r["frames"] >= mix["chunk"] and r["chunk_ms"]
    assert all(v == 0.0 for v in r["readings"].values()), r["readings"]
    if torch.cuda.is_available():
        pytest.skip("a card is here: the refusal cannot be seen")
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_whole_run_on_the_cpu_is_correct(tiny_run):
    rc, res = tiny_run("dense.loop")
    assert rc == 0 and res["correct"] is True
    assert set(res) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(res)[-1] == "checks"
    assert {"frames_per_s", "setup_s"} <= set(res["metrics"])
    rc, res = tiny_run("dense.loop", trace=1)
    assert rc == 0 and res["correct"] is True and "breakdown" in res
    assert "frames_per_s" not in res["metrics"]


def _patch_fault(monkeypatch, fault: str):
    from onepiece_tpu_torch.odometry import dense
    from onepiece_tpu_torch.systems import fused_slam

    if fault == "integration_leaves_state_unchanged":
        monkeypatch.setattr(fused_slam.tsdf_slots, "integrate_slots", lambda vox, *a, **k: vox)
    elif fault == "tracking_leaves_state_unchanged":
        orig = dense.dops.gauss_newton
        monkeypatch.setattr(dense.dops, "gauss_newton", lambda T, *a: orig(T.clone(), *a))
    elif fault == "half_of_each_chunk_left_out":
        orig = fused_slam.FusedDenseFusion.process_chunk
        monkeypatch.setattr(fused_slam.FusedDenseFusion, "process_chunk",
                            lambda self, g, d, c=None: orig(self, g[::2], d[::2], None if c is None else c[::2]))
    elif fault == "pose_altered_where_produced":
        orig = dense.chain_pose

        def chain(T_w, T_ts):
            out = orig(T_w, T_ts).clone()
            out[0, 3] += 2e-3
            return out

        monkeypatch.setattr(fused_slam.dense, "chain_pose", chain)
    elif fault == "voxel_altered_where_produced":
        orig = fused_slam.tsdf_slots.integrate_slots

        def integrate(vox, *a, **k):
            out = orig(vox, *a, **k)
            seen = torch.nonzero(vox[:-1, 1] > 0)
            if seen.numel():
                r, v = seen[len(seen) // 2].tolist()
                vox[r, 0, v] += 0.05
            return out

        monkeypatch.setattr(fused_slam.tsdf_slots, "integrate_slots", integrate)
    elif fault == "mesh_altered_where_produced":
        from portbench.systems import fused_dense_fusion as system

        orig = system.dedup_triangle_soup

        def dedup(tv, tc):
            v, f, c = orig(tv, tc)
            v = v.clone()
            v[len(v) // 2] += 1e-3
            return v, f, c

        monkeypatch.setattr(system, "dedup_triangle_soup", dedup)
    else:
        raise ValueError(fault)


FAULTS = ("integration_leaves_state_unchanged", "tracking_leaves_state_unchanged", "half_of_each_chunk_left_out",
          "pose_altered_where_produced", "voxel_altered_where_produced", "mesh_altered_where_produced")


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_makes_the_run_incorrect(fault, monkeypatch, tiny_run):
    _patch_fault(monkeypatch, fault)
    rc, res = tiny_run("dense.loop")
    assert rc == 0 and res["correct"] is False, res["checks"]


def _patch_sparse_fault(monkeypatch, fault: str):
    from onepiece_tpu_torch.systems import fused_sparse

    if fault == "tracking_leaves_state_unchanged":
        orig = fused_sparse.FusedFBASlam._track

        def track(self, *a, **k):
            res, summ = orig(self, *a, **k)
            return res, summ._replace(T_ts=torch.eye(4, dtype=summ.T_ts.dtype, device=summ.T_ts.device))

        monkeypatch.setattr(fused_sparse.FusedFBASlam, "_track", track)
    elif fault == "half_of_each_chunk_left_out":
        orig = fused_sparse.FusedFBASlam.process_chunk
        monkeypatch.setattr(fused_sparse.FusedFBASlam, "process_chunk",
                            lambda self, g, d: orig(self, g[::2], d[::2]))
    elif fault == "ba_leaves_state_unchanged":
        from onepiece_tpu_torch.systems import fused_ba

        orig = fused_ba.bundle.optimize_device
        monkeypatch.setattr(fused_ba.bundle, "optimize_device", lambda *a, **k: orig(*a, **{**k, "max_iters": 0}))
    elif fault == "pose_altered_where_produced":
        orig = fused_sparse.FusedFBASlam.trajectory

        def trajectory(self):
            t = orig(self).copy()
            t[len(t) // 2, 0, 3] += 0.05
            return t

        monkeypatch.setattr(fused_sparse.FusedFBASlam, "trajectory", trajectory)
    else:
        raise ValueError(fault)


SPARSE_FAULTS = ("tracking_leaves_state_unchanged", "ba_leaves_state_unchanged", "half_of_each_chunk_left_out",
                 "pose_altered_where_produced")


@pytest.mark.parametrize("fault", SPARSE_FAULTS)
def test_sparse_fault_makes_the_run_incorrect(fault, monkeypatch, tiny_run):
    _patch_sparse_fault(monkeypatch, fault)
    rc, res = tiny_run("ba.loop")
    assert rc == 0 and res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", ["dense.loop", "ba.loop"])
def test_control_fails_the_committed_limits(cell):
    w, cfg, mix = tiny(*run.load_cell(cell))
    judge = importlib.import_module(f"portbench.reference.{cfg['system']}")
    frames = closed_scans.make_frames(cfg, mix, SEED, torch.device("cpu"))
    g, d, c = frames.scan(int(closed_scans.scan_starts(mix, SEED)[0]), mix["scan_frames"])
    out = judge.control_scan(g, d, c, {**cfg, **mix})
    readings = judge.judge(out, g, d, c, {**cfg, **mix})
    limits = json.loads((ROOT / f"portbench/reference/limits/{w['config']}.json").read_text())["limits"]
    ok, _, lines = run.checks(readings, limits)
    assert not ok, lines


def test_a_new_cell_and_metric_are_found_without_an_edit(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    mix = json.loads((pb / "traffic/loop100_chunk10.json").read_text())
    (pb / "traffic/loop50_chunk5.json").write_text(json.dumps({**mix, "scan_frames": 50, "chunk": 5}))
    (pb / "workloads/dense.short.json").write_text(
        json.dumps({"config": "tum_dense_fusion", "traffic": "loop50_chunk5", "chips": 1}))
    (pb / "metrics/frames_per_chunk.py").write_text(
        'KIND = "per_layer"\nUNIT = "frames"\n\n\ndef read(ctx):\n    return ctx.mix["chunk"]\n')
    spec = importlib.util.spec_from_file_location("copied_run", pb / "run.py")
    copied = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copied)
    workload, cfg, mix2 = copied.load_cell("dense.short")
    assert cfg["name"] == "tum_dense_fusion" and mix2["chunk"] == 5
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from portbench import metrics; "
            "print(sorted(metrics.load_all()))")
    names = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True, text=True, check=True)
    assert "frames_per_chunk" in names.stdout
    if not torch.cuda.is_available():
        res = subprocess.run([sys.executable, str(pb / "run.py"), "--workload", "dense.short", "--seed", "1",
                              "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300)
        assert res.returncode != 0 and res.stdout == ""


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules(["onepiece_tpu_torch", "onepiece_tpu_torch.ops", "numpy"]) == []
    assert guard.forbidden_modules(["onepiece_tpu.ops.tsdf", "jaxlib.xla_client", "flax"]) == \
        ["flax", "jaxlib", "onepiece_tpu"]
    assert guard.forbidden_modules(["jax_utils", "jaxx"]) == []


def test_nothing_the_harness_loads_is_jax_or_the_jax_package():
    code = (
        "import sys, pkgutil, importlib; sys.path.insert(0, sys.argv[1]); import portbench\n"
        "for m in pkgutil.walk_packages(portbench.__path__, 'portbench.'):\n"
        "    if '.tests' not in m.name: importlib.import_module(m.name)\n"
        "from portbench import metrics, guard; metrics.load_all()\n"
        "print(guard.forbidden_modules())"
    )
    res = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True, check=True)
    assert res.stdout.strip() == "[]", res.stdout


def test_trace_merges_device_intervals():
    s = np.array([0, 5, 2, 20, 30], np.int64)
    e = np.array([3, 8, 4, 25, 31], np.int64)
    ms, me = trace.merge(s, e)
    assert ms.tolist() == [0, 5, 20, 30] and me.tolist() == [4, 8, 25, 31]
    assert trace.busy_ns(s, e, 1, 24) == 3 + 3 + 4


def test_p95_needs_twenty_values():
    assert metrics.p95(list(range(19))) is None
    assert metrics.p95([float(i) for i in range(1, 201)]) == pytest.approx(190.95)
