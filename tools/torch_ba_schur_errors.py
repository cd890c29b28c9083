#!/usr/bin/env python3
"""How far the float32 BA Schur reduction lies from float64, for the kernel
of `csrc/ba_schur.cu` and for the plain versions, and how far the LM
damping moves it.

    python3 tools/torch_ba_schur_errors.py                            # on the card
    python3 tools/torch_ba_schur_errors.py --device cpu --models 2d --cases orbit loop
    JAX_PLATFORMS=cpu python3 tools/torch_ba_schur_errors.py --device cpu --bundle-problem

On the card tests' problems (`tests/test_torch_cuda._ba_problem`: the
orbit's and the loop's capacities, a point seen once, padding points, a
frame without observations, two observations of one point in one frame,
F = 1,613 and F = 2,048) and for each damping lam, it prints one
JSON object a row with max |x - x64| / max |x64| of S, rhs_c, V^-1 of the
observed points and dp (the back-substitution of a fixed camera step) for:

  - `kernel`: the CUDA kernel (on the card only);
  - `plain`: the plain version on the device;
  - `plain_cpu`: the plain version on the CPU (the two largest-F cases are
    left out there: their dense systems are 0.4 and 0.6 GB);
  - `plain_cpu_lu`: the same with V inverted by the library's LU
    (`torch.linalg.inv`) in place of the pivoted elimination written out
    in both versions (`ops/ba_schur.inv3`);

x64 being the plain version run in float64, and `moved`: how far lam moves
the plain system from lam = 0. With `--bundle-problem` it prints instead,
for `tests/test_torch_bundle.py`'s problem (which imports the JAX
package), how far one float32 2-D `_ba_step_masked` lies from the float64
step with the written-out pivoted inverse, with the library's LU inverse,
and with either and the solve made in float64. With `--library-match` it
prints, for the damped V blocks of the observed points of each case (at the
first lam), the share whose pivoted LU factors equal the library's
(`torch.linalg.lu_factor`) bit for bit, with the first column's multipliers
made by division or by one reciprocal of the pivot (as `inv3` does), and
each multiply-subtract rounded twice (as `inv3` does) or once (a fused
multiply-add, emulated in float64), and the share of `inv3` inverses equal
to `torch.linalg.inv`'s.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np
import torch

from onepiece_tpu_torch.ops import ba_schur


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@contextlib.contextmanager
def lu_inverse():
    """The plain versions invert V by the library's LU while the block runs."""
    pivoted = ba_schur.inv3
    ba_schur.inv3 = torch.linalg.inv
    try:
        yield
    finally:
        ba_schur.inv3 = pivoted


def lu3(M: torch.Tensor, reciprocal: bool, fused: bool) -> torch.Tensor:
    """`ba_schur.inv3`'s pivoted factors of the 3x3 blocks M, packed as
    getrf packs them (rows in pivot order, L below the diagonal), with the
    first column's multipliers made by one reciprocal of the pivot if
    `reciprocal`, and each c - a b rounded once if `fused`."""
    def fms(c, a, b):
        return (c.double() - a.double() * b.double()).float() if fused else c - a * b

    a = [[M[:, i, j] for j in range(3)] for i in range(3)]

    def swap_rows(i: int, j: int, swap: torch.Tensor) -> None:
        a[i], a[j] = ([torch.where(swap, y, x) for x, y in zip(a[i], a[j])],
                      [torch.where(swap, x, y) for x, y in zip(a[i], a[j])])

    take1 = a[1][0].abs() > a[0][0].abs()
    take2 = a[2][0].abs() > torch.where(take1, a[1][0].abs(), a[0][0].abs())
    swap_rows(0, 2, take2)
    swap_rows(0, 1, take1 & ~take2)
    l1, l2 = (a[1][0] * (1 / a[0][0]), a[2][0] * (1 / a[0][0])) if reciprocal else (a[1][0] / a[0][0],
                                                                                      a[2][0] / a[0][0])
    a[1] = [l1, fms(a[1][1], l1, a[0][1]), fms(a[1][2], l1, a[0][2])]
    a[2] = [l2, fms(a[2][1], l2, a[0][1]), fms(a[2][2], l2, a[0][2])]
    swap_rows(1, 2, a[2][1].abs() > a[1][1].abs())
    a[2][1] = a[2][1] / a[1][1]
    a[2][2] = fms(a[2][2], a[2][1], a[1][2])
    return torch.stack([torch.stack(r, -1) for r in a], -2)


def library_match_rows(cases, models, lam: float) -> list[dict]:
    from test_torch_cuda import _ba_problem

    rows = []
    for model in models:
        for case in cases:
            args, _ = _ba_problem(case, model, "cpu")
            blocks = []
            pivoted = ba_schur.inv3
            ba_schur.inv3 = lambda M: blocks.append(M) or pivoted(M)  # noqa: E731
            try:
                ba_schur.reduced_system_reference(*on(args, "cpu", lam))
            finally:
                ba_schur.inv3 = pivoted
            lists = ba_schur.build_lists(args[2], args[3], args[5], args[0].shape[0], args[1].shape[0])
            V = blocks[0][lists.point_ptr.diff() > 0]
            lu_lib = torch.linalg.lu_factor(V)[0]
            row = dict(model=model, case=case, lam=lam, blocks=V.shape[0],
                       inv3_equals_library_inv=float((ba_schur.inv3(V) == torch.linalg.inv(V)).all((1, 2))
                                                     .double().mean()))
            for reciprocal in (False, True):
                for fused in (False, True):
                    same = (lu3(V, reciprocal, fused) == lu_lib).all((1, 2)).double().mean()
                    row[f"lu_equals_library{'_reciprocal' * reciprocal}{'_fused' * fused}"] = float(same)
            rows.append(row)
    return rows


def on(args, device, lam, dtype=None):
    out = [a.to(device) if torch.is_tensor(a) else a for a in args]
    if dtype is not None:
        out = [a.to(dtype) if torch.is_tensor(a) and a.is_floating_point() else a for a in out]
    out[6] = torch.tensor(lam, dtype=out[0].dtype, device=device)
    return out


def case_rows(case: str, model: str, dev: str, lams) -> list[dict]:
    from test_torch_cuda import _ba_problem

    args, n_pts = _ba_problem(case, model, dev)
    frame, point, valid = args[2], args[3], args[5]
    lists = ba_schur.build_lists(frame, point, valid, args[0].shape[0], args[1].shape[0])
    obs = (lists.point_ptr.diff() > 0).cpu()
    dc = torch.from_numpy(np.random.default_rng(1).normal(size=6 * args[0].shape[0]) * 1e-3)
    with_cpu = case not in ("max_frames", "f2048_few_live")

    def system(a, kernel_lists=None):
        step = dc.to(a[0].device, a[0].dtype)
        if kernel_lists is None:
            s = ba_schur.reduced_system_reference(*a)
            return s, ba_schur.back_substitute_reference(s, step, a[2], a[3])
        s = ba_schur.reduced_system(*a, lists=kernel_lists)
        return s, ba_schur.back_substitute(s, step, a[2], a[3], kernel_lists)

    def errs(got, want):
        (s, d), (x, dx) = got, want
        return dict(S=rel(s.S, x.S), rhs_c=rel(s.rhs_c, x.rhs_c), Vinv=rel(s.Vinv.cpu()[obs], x.Vinv.cpu()[obs]),
                    dp=rel(d[:n_pts], dx[:n_pts]))

    rows, plain0 = [], None
    for lam in (0.0, *lams):
        x = system(on(args, dev, lam, torch.float64))
        row = dict(model=model, case=case, lam=lam)
        if dev == "cuda":
            row["kernel"] = errs(system(on(args, dev, lam), lists), x)
        p = system(on(args, dev, lam))
        row["plain"] = errs(p, x)
        if with_cpu:
            row["plain_cpu"] = errs(system(on(args, "cpu", lam)), x)
            with lu_inverse():
                row["plain_cpu_lu"] = errs(system(on(args, "cpu", lam)), x)
        if plain0 is None:
            plain0 = p
        else:
            row["moved"] = errs(p, plain0)
        rows.append(row)
    return rows


def bundle_problem_rows() -> list[dict]:
    from test_torch_bundle import INTR, make_problem, torch_obs
    from onepiece_tpu_torch.optimization import bundle

    pr = make_problem()

    def step(dtype):
        f = (lambda a: a.astype(dtype) if a.dtype == np.float32 else a)  # noqa: E731
        obs = torch_obs(pr)._replace(uv=torch.from_numpy(f(pr["uv"])))
        lam = torch.tensor(3e-5, dtype=torch.float64 if dtype == np.float64 else torch.float32)
        out = bundle._ba_step_masked(torch.from_numpy(f(pr["poses"])), torch.from_numpy(f(pr["points"])), obs,
                                     torch.from_numpy(pr["solve"]), lam, *INTR)
        return out[0].double(), out[1].double()

    solve = torch.linalg.solve_ex

    def solve64(A, b):
        x, info = solve(A.double(), b.double())
        return x.to(A.dtype), info

    x = step(np.float64)
    rows = []
    for inverse in ("pivoted", "lu"):
        for solve_in in ("float32", "float64"):
            with lu_inverse() if inverse == "lu" else contextlib.nullcontext():
                torch.linalg.solve_ex = solve64 if solve_in == "float64" else solve
                try:
                    poses, points = step(np.float32)
                finally:
                    torch.linalg.solve_ex = solve
            rows.append(dict(problem="test_torch_bundle", model="2d", lam=3e-5, inverse=inverse, solve=solve_in,
                             poses=float((poses - x[0]).abs().max()), points=float((points - x[1]).abs().max())))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--models", nargs="+", default=["2d", "3d"])
    ap.add_argument("--cases", nargs="+", default=["orbit", "loop", "one_observation", "padding_points",
                                                    "frame_without_observations", "two_in_one_frame", "max_frames",
                                                    "f2048_few_live"])
    ap.add_argument("--lams", nargs="+", type=float, default=[3e-5, 3e-5 * 2**8, 1.0])
    ap.add_argument("--bundle-problem", action="store_true")
    ap.add_argument("--library-match", action="store_true")
    args = ap.parse_args(argv)
    if args.bundle_problem:
        rows = bundle_problem_rows()
    elif args.library_match:
        rows = library_match_rows([c for c in args.cases if c not in ("max_frames", "f2048_few_live")],
                                  args.models, args.lams[0])
    else:
        rows = [r for m in args.models for c in args.cases for r in case_rows(c, m, args.device, args.lams)]
    for r in rows:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
