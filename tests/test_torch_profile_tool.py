"""The profiling tools run end to end at a tiny size on the CPU:
`tools/profile_torch_slice.py` reports every stage of the fused frame step,
`tools/profile_torch_dense_slam.py` every layer of DenseSlam (device
numbers are null there)."""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import profile_torch_slice  # noqa: E402


def test_profile_tool_reports_every_stage_on_cpu(capsys):
    assert profile_torch_slice.main(
        ["--device", "cpu", "--level", "3", "--frames", "2", "--render-steps", "24"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["size"] == "80x60" and out["device"] == "cpu"
    assert list(out["stage_ms_per_frame"]) == [
        "preprocess_frame", "dense_tracking", "pose chain + bilateral_filter",
        "touched_block_keys", "hash insert", "integrate_slots"]
    assert all(ms > 0 for ms in out["stage_ms_per_frame"].values())
    assert set(out["gn_iteration_ms"]) == {"gauss_newton_step", "normal_equations"}
    assert out["host_sync_sites_in_process_chunk"] is None
    assert out["profile"]["wall_ms"] > 0 and out["profile"]["device_busy_ms"] is None


def test_dense_slam_profile_tool_reports_every_layer_on_cpu(capsys):
    import profile_torch_dense_slam

    assert profile_torch_dense_slam.main(
        ["--device", "cpu", "--level", "3", "--frames", "6", "--submap-size", "2",
         "--render-steps", "24"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["size"] == "80x60" and out["device"] == "cpu" and out["frames"] == 6
    layers = out["layers"]
    assert list(layers["ms"]) == list(profile_torch_dense_slam.LAYERS) + ["rest of update_frame"]
    # three submaps: two ICP calls (1 -> 0, 2 -> 1), one RANSAC attempt (2 -> 0)
    assert layers["calls"]["ICP"] >= 2 and layers["calls"]["RANSAC"] == 1
    assert layers["calls"]["normals + FPFH"] == 3
    assert all(ms > 0 for name, ms in layers["ms"].items() if name != "rest of update_frame")
    assert out["host_sync_sites"] is None
    assert out["profile"]["wall_ms"] > 0 and out["profile"]["device_busy_ms"] is None


def test_sparse_profile_tool_reports_every_stage_on_cpu(capsys):
    import profile_torch_sparse

    assert profile_torch_sparse.main(
        ["--device", "cpu", "--level", "2", "--frames", "4", "--chunk", "4", "--max-keypoints", "200",
         "--render-steps", "24"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["size"] == "160x120" and out["device"] == "cpu" and out["frames"] == 4
    stages = out["stages"]
    assert list(stages["ms"]) == list(profile_torch_sparse.STAGES) + ["rest of process_chunk"]
    assert stages["calls"]["tracking loop"] == 4 and stages["calls"]["features"] == 1
    assert stages["ms"]["tracking loop"] > 0
    assert out["host_sync_sites"] is None and out["profile"]["device_busy_ms"] is None


def test_sparse_profile_tool_reports_ba_stages_on_cpu(capsys):
    """`--system ba`: FusedBASlam's stages, the track linker and the LM loop
    among them, each called once a chunk."""
    import profile_torch_sparse

    assert profile_torch_sparse.main(
        ["--device", "cpu", "--system", "ba", "--level", "2", "--frames", "2", "--chunk", "1",
         "--max-keypoints", "200", "--render-steps", "24"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["system"] == "ba" and out["size"] == "160x120" and out["device"] == "cpu"
    stages = out["stages"]
    assert list(stages["ms"]) == [*profile_torch_sparse.STAGES, *profile_torch_sparse.BA_STAGES,
                                  "rest of process_chunk"]
    assert stages["calls"]["track linker"] == 2 and stages["calls"]["LM loop"] == 2
    assert stages["ms"]["track linker"] > 0 and stages["ms"]["LM loop"] > 0
    assert out["host_sync_sites"] is None and out["profile"]["device_busy_ms"] is None
