#!/usr/bin/env python3
"""Copy per-point labels (colours) between clouds by nearest neighbour (the
port's `tools/transfer_labels.py`).

    python3 tools/torch_transfer_labels.py labeled.ply target.ply out.ply [--max-dist 0.1]

For each point of the target cloud, the colour of its nearest point in the
labelled cloud (`ops/knn.py`, exact brute force on the device); a target
point farther than `--max-dist` from every labelled point gets colour 0.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from _torch_common import add_device_arg  # noqa: E402
from onepiece_tpu_torch.io.ply import read_ply, write_ply_pointcloud  # noqa: E402
from onepiece_tpu_torch.ops.knn import knn  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("labeled", help="PLY with colors = labels")
    ap.add_argument("target", help="PLY to label")
    ap.add_argument("output")
    ap.add_argument("--max-dist", type=float, default=0.1)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    src = read_ply(args.labeled)
    tgt = read_ply(args.target)
    if "colors" not in src:
        raise SystemExit("labeled cloud has no color/label channel")
    ref = torch.from_numpy(src["vertices"]).to(args.device)
    idx, d2 = knn(torch.from_numpy(tgt["vertices"]).to(args.device), ref,
                  torch.ones(len(ref), dtype=torch.bool, device=ref.device), k=1)
    idx, ok = idx[:, 0].cpu().numpy(), (d2[:, 0] <= args.max_dist**2).cpu().numpy()
    colors = src["colors"][idx]
    colors[~ok] = 0.0
    write_ply_pointcloud(args.output, tgt["vertices"], colors=colors)
    print(f"labeled {ok.sum()}/{len(ok)} points -> {args.output}")
    return dict(labeled=int(ok.sum()), points=len(ok))


if __name__ == "__main__":
    main()
