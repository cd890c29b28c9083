"""The benchmark of `onepiece_tpu_torch` on NVIDIA cards: one cell, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (`workloads/<cell>.json`) names a configuration (`configs/<config>.json`:
the system and its settings) and a traffic mix (`traffic/<mix>.json`: its
parameters and the driver, `traffic/<driver>.py`, that plays them). The run
makes its inputs from the seed, warms up, measures for `--seconds`, then
judges the outputs of a scan drawn from the seed against the plain
reference (`reference/`), with the limits of `reference/limits/<config>.json`.

It prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (with `--trace 0` the end-to-end metrics,
with `--trace 1` the per-layer ones, each read by `metrics/<name>.py`),
`device`, with `--trace 1` a `breakdown`, and last `checks`: every number
compared, beside its limit. The same numbers end standard error.

It needs a CUDA card for each chip the cell asks for, and exits non-zero
without a result where there is none, where anything fails, or where the
process holds a module of JAX or of the JAX package once the window has
closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
THREADS = 2  # host threads for the program's CPU-side tensor work, per process
DEVICE = "cuda"  # where the program runs; the CPU tests alone set "cpu"


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(THREADS)


def load_cell(name: str) -> tuple[dict, dict, dict]:
    """(workload, configuration, mix) of a cell, by name."""
    workload = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    cfg = json.loads((HERE / "configs" / f"{workload['config']}.json").read_text())
    mix = json.loads((HERE / "traffic" / f"{workload['traffic']}.json").read_text())
    return workload, cfg, mix


def checks(readings: dict, limits: dict) -> tuple[bool, dict, list[str]]:
    """The verdict: each number beside its limit (a number that could not be
    read counts as failed)."""
    out, ok, lines = {}, True, []
    for name, limit in limits.items():
        val = readings.get(name)
        good = val is not None and val <= limit
        ok &= good
        out[name] = {"value": val, "limit": limit}
        lines.append(f"check {name} {'n/a' if val is None else repr(val)} limit {limit!r}{'' if good else ' FAIL'}")
    return ok, out, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    import torch

    workload, cfg, mix = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"portbench: the cell asks for {workload['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return 2
    torch.set_num_threads(THREADS)
    import importlib

    from portbench import guard, metrics

    driver = importlib.import_module(f"portbench.traffic.{mix['driver']}")
    limits = json.loads((HERE / "reference" / "limits" / f"{workload['config']}.json").read_text())["limits"]
    rec = driver.run(cfg, mix, args.seed, args.seconds, bool(args.trace), DEVICE, T_START)

    found = guard.forbidden_modules()
    if found:
        print(f"portbench: the measured process loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    ctx = metrics.Context(rec, cfg, mix)
    kind = "per_layer" if args.trace else "end_to_end"
    values = {}
    for name, reader in metrics.load_all().items():
        if reader.KIND == kind:
            v = reader.read(ctx)
            if v is not None:
                values[name] = {"value": float(v), "unit": reader.UNIT}
    correct, compared, lines = checks(rec["readings"], limits)
    device = {"platform": "gpu", "kind": rec["device_name"], "count": workload["chips"],
              "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": len(ctx.chunk_ms), "failed": 0, "metrics": values,
              "device": device}
    if args.trace:
        st = ctx.stretch()
        device["busy_s"], device["window_s"] = st if st is not None else (None, None)
        from portbench import trace as trace_mod

        t = ctx.traced or {"seconds": {}, "gaps": {}}
        result["breakdown"] = {"device_ops": trace_mod.top(t["seconds"]), "idle_gaps": trace_mod.top(t["gaps"])}
    result["checks"] = compared
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
