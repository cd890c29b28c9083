"""`tools/profile_torch_slice.py` runs end to end at a tiny size on the CPU
and reports every stage of the frame step (device numbers are null there)."""

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
    assert set(out["gn_iteration_ms"]) == {"normal_equations", "solve_and_update"}
    assert out["host_sync_sites_in_process_chunk"] is None
    assert out["profile"]["wall_ms"] > 0 and out["profile"]["device_busy_ms"] is None
