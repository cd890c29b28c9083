"""Shared set-up of the benchmark's CPU tests: the cells cut to 80x60 frames
and a dozen loop frames (the sparse cells to 320x240 and 16 frames), and a
way to drive `run.main` on the CPU past its look for a card. Run them with

    python -m pytest portbench/tests -q --durations=0

(the repository's own `tests/` are collected apart). Nothing here needs a
card: the card runs are `run.py` and `calibrate.py` themselves."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402

TINY_CAMERA = dict(fx=517.3 / 8, fy=516.5 / 8, cx=(318.6 + 0.5) / 8 - 0.5, cy=(255.3 + 0.5) / 8 - 0.5,
                   width=80, height=60)
TINY_CFG = dict(capacity=2048, table_size=8192, kmax=2048, stride=2, iters=[4, 2, 1], voxel_size=0.04,
                truncation=0.16)
TINY_MIX = dict(loop_frames=12, scan_frames=12, chunk=4, render_steps=32, render_batch=6, judged_scans=2)


# the sparse path finds too few corners at 80x60 to make world points: 320x240
SPARSE_CAMERA = dict(fx=517.3 / 2, fy=516.5 / 2, cx=(318.6 + 0.5) / 2 - 0.5, cy=(255.3 + 0.5) / 2 - 0.5,
                     width=320, height=240)
SPARSE_MIX = dict(loop_frames=16, scan_frames=16, chunk=8, render_steps=32, render_batch=8, judged_scans=2)


def tiny(workload: dict, cfg: dict, mix: dict) -> tuple[dict, dict, dict]:
    if cfg["system"] == "fused_ba":
        cfg = {**cfg, "camera": {**cfg["camera"], **SPARSE_CAMERA}}
        mix = {**mix, **SPARSE_MIX}
        return workload, cfg, mix
    cfg = {**cfg, **TINY_CFG, "camera": {**cfg["camera"], **TINY_CAMERA}}
    mix = {**mix, **TINY_MIX}
    return workload, cfg, mix


def cells() -> list[str]:
    return sorted(p.stem for p in (ROOT / "portbench" / "workloads").glob("*.json"))


@pytest.fixture
def tiny_run(monkeypatch, capsys):
    """run.main on the CPU at the tiny size: (exit code, result or None)."""
    orig = run.load_cell
    monkeypatch.setattr(run, "load_cell", lambda name: tiny(*orig(name)))
    monkeypatch.setattr(run, "DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def go(cell: str, seed: int = 2**31 + 11, trace: int = 0):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "1", "--trace", str(trace)])
        out = capsys.readouterr().out.strip().splitlines()
        return rc, (json.loads(out[-1]) if rc == 0 and out else None)

    return go
