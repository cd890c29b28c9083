"""Rank bodies for the port's parallel tests (`launch.spawn` imports this
module in each rank by its path, so it imports no JAX)."""

import numpy as np
import torch

from onepiece_tpu_torch.parallel import drive


def failing_rank(group):
    """Rank 1 raises; rank 0 waits in a collective it never completes."""
    if group.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    group.psum(torch.ones(1, device=group.device))
    return {}


def parallel_checks(group, inps: dict, wide_bas: dict, faults: dict) -> dict:
    """At each world w of `inps`, over the subgroup of the first w ranks:
    every module on `inps[w]` and the BA step again on `wide_bas[w]`; at the
    smallest world also the checks of `faults`: the first frame's fused step
    at the touched-key cap `faults["kmax"]` and at the inputs' `kmax`, and
    meshing the pool of `faults["mc"]`. Returns {w: results} for the worlds
    this rank took part in."""
    out = {}
    for w in sorted(inps):
        sub = group.subgroup(w)  # collective: every rank creates every subgroup
        if sub is None:
            continue
        inp = inps[w]
        res = drive.run_modules(sub, inp)
        res["wide_ba"] = drive.run_modules(sub, dict(inp, ba=wide_bas[w]), ("ba",))["ba"]
        if w == min(inps):
            f0 = inp["fused"]
            fused = []
            for k in (faults["kmax"], f0["kmax"]):
                f = dict(f0, depths=f0["depths"][:1], grays=f0["grays"][:1], poses=f0["poses"][:1], kmax=k)
                r = drive.run_modules(sub, dict(inp, fused=f), ("fused",), keep_arrays=False)["fused"]
                fused.append(dict(saturated=r["key_saturated_frames"] > 0, kmax=r["kmax"],
                                  num_active=r["num_active"], pool_digest=r["pool_digest"]))
            mc = drive.run_modules(sub, dict(mc=faults["mc"]), ("mc",))["mc"]
            res["faults"] = dict(fused=fused, mc=mc)
        out[w] = res
    return out


def collectives(group) -> dict:
    """Each collective of `comm.py` once on rank-dependent tensors of the
    rank's device, and what the group counted (`expected_collectives` gives
    the values)."""
    dev, r, n = group.device, group.rank, group.world
    x = torch.arange(6, dtype=torch.float32, device=dev) + 10 * r
    out = dict(psum=group.psum(x), all_gather=group.all_gather(x.reshape(2, 3)), ring_shift=group.ring_shift(x),
               all_to_all=group.all_to_all(torch.stack([x + 100 * d for d in range(n)])))
    devices = {k: str(v.device) for k, v in out.items()}
    return dict(out, devices=devices, stats=group.stats())


def expected_collectives(rank: int, world: int) -> dict:
    x = np.arange(6, dtype=np.float32)
    return dict(psum=world * x + 10 * sum(range(world)),
                all_gather=np.stack([(x + 10 * s).reshape(2, 3) for s in range(world)]),
                ring_shift=x + 10 * ((rank - 1) % world),
                all_to_all=np.stack([x + 10 * s + 100 * rank for s in range(world)]))
