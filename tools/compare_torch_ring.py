#!/usr/bin/env python3
"""Decoder threads against decoder processes for the TUM prefetch ring.

    python3 tools/compare_torch_ring.py                      # on the card
    python3 tools/compare_torch_ring.py --frames 4 --scale 8 --device cpu --threads 1 2 --processes 1 2

Writes the synthetic orbit (`--frames` frames, rendered on `--device`) as a
TUM folder, then decodes it, in turns (`--rounds` rounds), as:

  - `eager`: in the calling thread, 8 frames' PNGs to one `decode_many`
    call (the reader before the ring);
  - `threads N`: a pool of N threads, each frame decoded by
    `io/tum_frames.read_frames` + `to_floats`, at most 2N frames ahead;
  - `processes N ring R`: the ring itself (`PrefetchingRGBDLoader`, N
    worker processes, R = f N slots for each f of `--ring-factors`).

Every frame of every form must equal the eager decode. Prints host ms per
frame (the whole pass, worker start included, and after the first frame)
beside `os.cpu_count()`; on the card also `FusedDenseFusion` in chunks of 8
fed by each form at each N (median ms/frame over the rounds, the frames
uploaded as the dataset CLIs upload them) and preloaded on the card, with
the card's name and power limit. One JSON line of the results last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_common import chunks, scaled_camera  # noqa: E402
from onepiece_tpu_torch.geometry.camera import TUM_CAMERA  # noqa: E402
from onepiece_tpu_torch.io import tum  # noqa: E402
from onepiece_tpu_torch.io.native_loader import PrefetchingRGBDLoader  # noqa: E402
from onepiece_tpu_torch.io.tum_frames import read_frames, to_floats  # noqa: E402

EAGER_BATCH = 8  # the reader before the ring decoded 8 frames' PNGs at a time
CHUNK = 8  # frames a process_chunk call, as the dataset CLIs run FusedDenseFusion


def eager(pairs, scale, gray: bool = True):
    """(depth, image) frames of (depth_path, rgb_path) pairs decoded in the
    calling thread, EAGER_BATCH frames at a time."""
    for at in range(0, len(pairs), EAGER_BATCH):
        for rgb, d16 in read_frames(pairs[at : at + EAGER_BATCH]):
            yield to_floats(rgb, d16, scale, gray)


def threads(pairs, scale, n):
    """N decoder threads, at most 2N frames ahead, frames in order."""
    def one(pair):
        ((rgb, d16),) = read_frames([pair])
        return to_floats(rgb, d16, scale, True)

    with ThreadPoolExecutor(n) as pool:
        pending = [pool.submit(one, p) for p in pairs[: 2 * n]]
        for i in range(len(pairs)):
            frame = pending[i].result()
            if i + 2 * n < len(pairs):
                pending.append(pool.submit(one, pairs[i + 2 * n]))
            yield frame


def processes(pairs, scale, n, ring):
    return PrefetchingRGBDLoader(pairs, depth_scale=scale, gray=True, n_threads=n, ring=ring)


def timed_pass(frames) -> tuple[list, float, float]:
    """(frames, ms per frame over the pass, ms per frame after the first)."""
    t = time.perf_counter()
    it = iter(frames)
    out = [next(it)]
    t1 = time.perf_counter()
    out.extend(it)
    t2 = time.perf_counter()
    return out, (t2 - t) * 1e3 / len(out), (t2 - t1) * 1e3 / max(len(out) - 1, 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--scale", type=int, default=1, help="camera downscale factor (power of 2)")
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4, 6], help="decoder thread counts")
    ap.add_argument("--processes", type=int, nargs="+", default=[1, 2, 4, 6], help="decoder process counts")
    ap.add_argument("--ring-factors", type=int, nargs="+", default=[2], help="ring slots a decoder process")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cam = scaled_camera(TUM_CAMERA, args.scale)
    card = None
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(card, flush=True)
    forms = {"eager": lambda p, s: eager(p, s)}
    for n in args.threads:
        forms[f"threads {n}"] = lambda p, s, n=n: threads(p, s, n)
    for n in args.processes:
        for f in args.ring_factors:
            forms[f"processes {n} ring {f * n}"] = lambda p, s, n=n, r=f * n: processes(p, s, n, r)
    res = {"cpu_count": os.cpu_count(), "frames": args.frames, "decode": {}, "loop": {}}
    with tempfile.TemporaryDirectory(prefix="compare_ring_") as root:
        tum.write_synthetic_tum(root, num_frames=args.frames, camera=cam, device=dev)
        seq = tum.TumSequence(root, depth_scale=cam.depth_scale)
        pairs = [(os.path.join(root, d), os.path.join(root, r)) for _, r, d in seq.pairs]
        ref = list(eager(pairs, seq.depth_scale))
        order = list(forms)
        runs = {k: [] for k in forms}
        for r in range(args.rounds):
            for name in order if r % 2 == 0 else order[::-1]:
                out, whole, steady = timed_pass(forms[name](pairs, seq.depth_scale))
                if not all(np.array_equal(a, b) for f, g in zip(out, ref) for a, b in zip(f, g)):
                    raise AssertionError(f"{name}: frames differ from the eager decode")
                runs[name].append((whole, steady))
        for name, rs in runs.items():
            whole, steady = (float(np.median([x[i] for x in rs])) for i in (0, 1))
            res["decode"][name] = dict(ms_per_frame=whole, steady_ms_per_frame=steady)
            print(f"decode {name}: {whole:.2f} ms/frame over the pass, {steady:.2f} after the first frame "
                  f"(medians of {args.rounds}; os.cpu_count() {os.cpu_count()})", flush=True)
        if dev.type == "cuda":
            from onepiece_tpu_torch.systems.fused_slam import FusedDenseFusion

            def loop(frames):
                torch.cuda.synchronize()
                t = time.perf_counter()
                s = FusedDenseFusion(cam, device=dev)
                for g, d in chunks(((0.0, g, d) for d, g in frames), CHUNK, dev):
                    s.process_chunk(g, d)
                s.finalize()
                torch.cuda.synchronize()
                return (time.perf_counter() - t) * 1e3 / args.frames

            pre = [tuple(torch.from_numpy(np.stack([f[k] for f in ref[i : i + CHUNK]])).to(dev) for k in (1, 0))
                   for i in range(0, args.frames, CHUNK)]
            feeds = {name: (lambda name=name: forms[name](pairs, seq.depth_scale)) for name in order}
            feeds["preloaded"] = None
            loop(ref)  # warm
            times = {k: [] for k in feeds}
            for r in range(args.rounds):
                for name in list(feeds) if r % 2 == 0 else list(feeds)[::-1]:
                    if name == "preloaded":
                        torch.cuda.synchronize()
                        t = time.perf_counter()
                        s = FusedDenseFusion(cam, device=dev)
                        for g, d in pre:
                            s.process_chunk(g, d)
                        s.finalize()
                        torch.cuda.synchronize()
                        times[name].append((time.perf_counter() - t) * 1e3 / args.frames)
                    else:
                        times[name].append(loop(feeds[name]()))
            for name, ts in times.items():
                res["loop"][name] = float(np.median(ts))
                print(f"FusedDenseFusion fed by {name}: {res['loop'][name]:.2f} ms/frame (median of "
                      f"{args.rounds}: {[round(t, 2) for t in ts]}) on {card}", flush=True)
    res["card"] = card
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
