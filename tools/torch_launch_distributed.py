#!/usr/bin/env python3
"""Multi-process bring-up of the port's sharded runtime (the port's
`tools/launch_distributed.py`).

    python3 tools/torch_launch_distributed.py                        # NCCL, one rank a card
    python3 tools/torch_launch_distributed.py --num-processes 2 --backend gloo          # ranks share a card
    python3 tools/torch_launch_distributed.py --device cpu --backend gloo                # CPU processes

Starts `--num-processes` ranks with `onepiece_tpu_torch/parallel/launch.spawn`
(the `spawn` start method, a FileStore rendezvous in a temporary folder).
Each rank checks a `psum` of 1..n across the process boundary, then tracks
the JAX tool's synthetic 80x60 pair with the source pixels sharded over the
ranks (`parallel/dense.dense_tracking_sharded`) and holds the pose to its
own single-rank exact track within 1e-4. Prints `k/n workers ok`; exits 1
unless every rank passed. NCCL needs one card per rank: asking for more
ranks than cards raises and names `--backend gloo`.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from onepiece_tpu_torch.geometry.camera import PinholeCamera  # noqa: E402
from onepiece_tpu_torch.parallel import drive, launch  # noqa: E402

TOL = 1e-4  # sharded against the single-rank exact track (the JAX tool's bar)
H, W = 60, 80
TIMEOUT_S = 300.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    launch.check_request(args.num_processes, args.backend, args.device)

    cam = PinholeCamera(fx=W / 2.0, fy=W / 2.0, cx=(W - 1) / 2.0, cy=(H - 1) / 2.0, width=W, height=H,
                        depth_scale=1000.0)
    pair = drive.render_pair(cam)
    results = launch.spawn(args.num_processes, drive.launch_check, cam, pair, TOL, backend=args.backend,
                           device=args.device, timeout=TIMEOUT_S)
    for r in results:
        print(f"[p{r['rank']}] psum ok ({r['psum']:g}); sharded dense tracking ok (max|dT|={r['max_dT']:.2e})")
    print(f"{len(results)}/{args.num_processes} workers ok")
    return 0 if len(results) == args.num_processes else 1


if __name__ == "__main__":
    sys.exit(main())
