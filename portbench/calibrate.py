"""The readings that the limits of `reference/limits/<config>.json` are set
from: on each seed, one scan of a cell's traffic through the program (the
same entry and chunking as the timed window) and, on the control seeds, the
control (the reference in bfloat16 storage in the program's place), each
judged by the comparison. Prints one JSON line a reading, then the largest
program reading and the smallest control reading of each number.

    python3 portbench/calibrate.py --workload dense.loop --seeds 1,2,3 --control-seeds 4,5,6

Not run by the benchmark's runs.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def one_seed(cfg, mix, seed, device, control: bool) -> dict:
    import torch

    from portbench.traffic import closed_scans

    system = importlib.import_module(f"portbench.systems.{cfg['system']}")
    judge = importlib.import_module(f"portbench.reference.{cfg['system']}")
    dev = torch.device(device)
    frames = closed_scans.make_frames(cfg, mix, seed, dev)
    start = int(closed_scans.scan_starts(mix, seed)[0])
    g, d, c = frames.scan(start, mix["scan_frames"])
    t0 = time.perf_counter()
    if control:
        out = judge.control_scan(g, d, c, {**cfg, **mix})
    else:
        scan = system.Scan(cfg, dev)
        for i in range(0, mix["scan_frames"], mix["chunk"]):
            scan.feed(g[i : i + mix["chunk"]], d[i : i + mix["chunk"]], c[i : i + mix["chunk"]])
            scan.grow()
        out = scan.finish()
    t1 = time.perf_counter()
    readings = judge.judge(out, g, d, c, {**cfg, **mix})
    t2 = time.perf_counter()
    del out
    return dict(seed=seed, side="control" if control else "program", start=start, readings=readings,
                scan_s=t1 - t0, judge_s=t2 - t1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.run import load_cell

    _, cfg, mix = load_cell(args.workload)
    rows = []
    for side, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for s in filter(None, seeds.split(",")):
            rec = one_seed(cfg, mix, int(s), args.device, side == "control")
            rows.append(rec)
            print(json.dumps(rec), flush=True)
    summary = {}
    for side, pick in (("program", max), ("control", min)):
        got = [r["readings"] for r in rows if r["side"] == side]
        if got:
            summary[side] = {k: pick((g[k] for g in got), key=lambda v: float("inf") if v is None else v)
                             for k in got[0]}
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
