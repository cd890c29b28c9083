"""The port's bundle adjustment (`optimization/bundle.py`, the plain versions
of `ops/ba_schur.py`) against the JAX package's `optimization/bundle.py`,
on the CPU.

The problem is `tests/test_optimization.py`'s BATest-style one (6 cameras
on a quarter circle, 120 points, 0.5 px noise), drawn here from its own
seeded generator, and padded to capacities as the fused system pads it:
F = 8 frames (pose 0 and the two padding frames inactive), P = 128 points
(8 never observed), and invalid observation rows with in-range indices and
finite garbage measurements. The RGB-D model observes the camera-frame
points with 2 mm noise.

Tolerances, each with its reason:
- observation models: 1e-5 relative (the same float32 operations; einsum
  sums in another order);
- one step of the RGB-D model: new poses and points within 1e-4 (sums in
  another order, the 3x3 point blocks inverted by a written-out pivoted LU
  here and by LAPACK's in JAX, the LU of the reduced system by another library); of the 2-D
  model: see `test_ba_step_masked_matches_jax_2d`;
- the reduced system against a float64 assembly written in the test: see
  `test_plain_reduced_system_matches_float64_assembly`;
- the LM loops: 1e-3 on the poses and 2 % on the mean squared error after
  10 iterations (10 steps of the above, each accepted by a float32 cost
  comparison).
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepiece_tpu.optimization import bundle as jb
from onepiece_tpu_torch.geometry import se3
from onepiece_tpu_torch.ops import ba_schur
from onepiece_tpu_torch.optimization import bundle as tb
from test_optimization import CX, CY, FX, FY, circular_trajectory

F_CAP, P_CAP = 8, 128
INTR = (FX, FY, CX, CY)


def make_problem(seed: int = 11, n_invalid: int = 9):
    """The padded problem as numpy arrays (both packages take the same)."""
    rng = np.random.default_rng(seed)
    T_cw = np.linalg.inv(circular_trajectory(6))
    pts = rng.uniform(-0.8, 0.8, size=(120, 3))
    frames, pids, uvs, pcs = [], [], [], []
    for f in range(6):
        pc = (T_cw[f] @ np.c_[pts, np.ones(120)].T).T[:, :3]
        u = pc[:, 0] / pc[:, 2] * FX + CX
        v = pc[:, 1] / pc[:, 2] * FY + CY
        ok = (pc[:, 2] > 0.3) & (u > 0) & (u < 2 * CX) & (v > 0) & (v < 2 * CY)
        for p in np.nonzero(ok)[0]:
            frames.append(f)
            pids.append(p)
            uvs.append([u[p] + rng.normal() * 0.5, v[p] + rng.normal() * 0.5])
            pcs.append(pc[p] + rng.normal(size=3) * 0.002)
    n = len(frames)
    frame = np.concatenate([frames, rng.integers(0, F_CAP, n_invalid)]).astype(np.int64)
    point = np.concatenate([pids, rng.integers(0, P_CAP, n_invalid)]).astype(np.int64)
    uv = np.concatenate([uvs, rng.uniform(0, 300, (n_invalid, 2))]).astype(np.float32)
    pc_obs = np.concatenate([pcs, rng.uniform(0.5, 3, (n_invalid, 3))]).astype(np.float32)
    valid = np.arange(n + n_invalid) < n
    pert = rng.normal(size=(6, 6)) * 0.03
    pert[0] = 0
    poses = np.tile(np.eye(4, dtype=np.float32), (F_CAP, 1, 1))
    poses[:6] = se3.se3_exp(torch.from_numpy(pert.astype(np.float32))).numpy() @ T_cw.astype(np.float32)
    points = np.zeros((P_CAP, 3), np.float32)
    points[:120] = pts + rng.normal(size=pts.shape) * 0.05
    solve = (np.arange(F_CAP) > 0) & (np.arange(F_CAP) < 6)
    return dict(poses=poses, points=points, frame=frame, point=point, uv=uv, pc_obs=pc_obs, valid=valid,
                solve=solve)


@pytest.fixture(scope="module")
def prob():
    return make_problem()


def jax_obs(pr):
    return jb.BAObservations(jnp.asarray(pr["frame"], jnp.int32), jnp.asarray(pr["point"], jnp.int32),
                             jnp.asarray(pr["uv"]), jnp.asarray(pr["valid"]), jnp.zeros((1, 1), jnp.int32))


def torch_obs(pr):
    t = torch.from_numpy
    return tb.BAObservations(t(pr["frame"]), t(pr["point"]), t(pr["uv"]), t(pr["valid"]),
                             torch.zeros((1, 1), dtype=torch.int64))


def _obs_args(pr):
    o = torch_obs(pr)
    return o.frame, o.point, o.uv, o.valid


def _close(a, b, rel, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert err <= rel, (what, err)


@pytest.mark.parametrize("model", ["2d", "3d"])
def test_observation_models_match_jax(prob, model):
    jp, tp = (jnp.asarray(prob["poses"]), jnp.asarray(prob["points"])), \
        (torch.from_numpy(prob["poses"]), torch.from_numpy(prob["points"]))
    if model == "2d":
        want = jb._residuals_jacobians(*jp, jax_obs(prob), *INTR)
        got = ba_schur.residuals_jacobians_2d(*tp, *_obs_args(prob), *INTR)
    else:
        want = jb._residuals_jacobians_3d(*jp, jax_obs(prob), jnp.asarray(prob["pc_obs"]), *INTR)
        frame, point, _, valid = _obs_args(prob)
        got = ba_schur.residuals_jacobians_3d(*tp, frame, point, torch.from_numpy(prob["pc_obs"]), valid)
    for name, a, b in zip(("r", "J_pose", "J_point", "w"), got, want):
        _close(a.numpy(), b, 1e-5, name)
    assert float(got[3][~torch.from_numpy(prob["valid"])].abs().max()) == 0.0


def _steps(prob, model, dtype):
    """One `_ba_step_masked` of each package on the problem in `dtype`."""
    pc = prob["pc_obs"] if model == "3d" else None
    f = (lambda a: a.astype(dtype) if a.dtype == np.float32 else a)
    jobs = jb.BAObservations(jnp.asarray(prob["frame"], jnp.int32), jnp.asarray(prob["point"], jnp.int32),
                             jnp.asarray(f(prob["uv"])), jnp.asarray(prob["valid"]), jnp.zeros((1, 1), jnp.int32))
    want = jb._ba_step_masked(jnp.asarray(f(prob["poses"])), jnp.asarray(f(prob["points"])), jobs,
                              jnp.asarray(prob["solve"]), jnp.asarray(3e-5, dtype), *INTR,
                              pc_obs=None if pc is None else jnp.asarray(f(pc)))
    tobs = torch_obs(prob)._replace(uv=torch.from_numpy(f(prob["uv"])))
    got = tb._ba_step_masked(torch.from_numpy(f(prob["poses"])), torch.from_numpy(f(prob["points"])), tobs,
                             torch.from_numpy(prob["solve"]), torch.tensor(3e-5, dtype=torch.from_numpy(
                                 np.zeros(1, dtype)).dtype), *INTR,
                             pc_obs=None if pc is None else torch.from_numpy(f(pc)))
    assert bool(got[2]) and bool(want[2])
    assert got[0].dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    return [x.numpy() for x in got[:2]], [np.asarray(x) for x in want[:2]]


def test_ba_step_masked_matches_jax_3d(prob):
    (poses, points), (jposes, jpoints) = _steps(prob, "3d", np.float32)
    assert np.abs(poses - jposes).max() <= 1e-4 and np.abs(points - jpoints).max() <= 1e-4
    # the step moved the solved poses; pose 0 and the padding frames stayed
    moved = np.abs(poses - prob["poses"]).max((1, 2))
    assert (moved[1:6] > 1e-3).all() and (moved[[0, 6, 7]] == 0).all()
    assert (points[120:] == 0).all()


def test_ba_step_masked_matches_jax_2d(prob):
    """The 2-D model leaves the scale unobservable (the 7th gauge): the
    reduced system is singular there up to its 1e-7 jitter, so in float32
    the step along it is set by rounding (on this problem JAX's float32
    step lies 6.6e-4 from the float64 step, the port's 2.2e-3, and their
    reprojection costs 0.3 % below and 1.0 % above it). So the step is held
    to JAX's in float64, where the two packages give the same step to
    ~5e-12 (tolerance 1e-9), and the port's float32 step by its
    reprojection cost, within 2 % of the float64 step's."""
    with jax.enable_x64():
        (poses, points), (jposes, jpoints) = _steps(prob, "2d", np.float64)
    assert np.abs(poses - jposes).max() <= 1e-9 and np.abs(points - jpoints).max() <= 1e-9
    moved = np.abs(poses - prob["poses"]).max((1, 2))
    assert (moved[1:6] > 1e-3).all() and (moved[[0, 6, 7]] == 0).all()
    obs64 = torch_obs(prob)._replace(uv=torch.from_numpy(prob["uv"]).double())

    def cost(a, b):
        return float(tb.ba_cost(tb.BAProblem(torch.from_numpy(a).double(), torch.from_numpy(b).double(), obs64),
                                *INTR)[0])

    (poses32, points32), _ = _steps(prob, "2d", np.float32)
    exact, port, start = cost(poses, points), cost(poses32, points32), cost(prob["poses"], prob["points"])
    assert abs(port - exact) <= 0.02 * exact and exact < 0.01 * start, (port, exact, start)


@pytest.mark.parametrize("model,dtype", [("2d", np.float32), ("3d", np.float32), ("2d", np.float64),
                                         ("3d", np.float64)])
def test_plain_reduced_system_matches_float64_assembly(prob, model, dtype):
    """S = U - W V^-1 W^T and rhs_c = b_c - W V^-1 b_p, written out in float64
    from the port's residuals and Jacobians, one observation at a time. The
    plain version run in float64 gives the same system to 1e-10 (the
    formula; the written-out pivoted LU against LAPACK's); in float32 the RGB-D model's to 1e-5
    (rounding of float32 sums), the 2-D model's to 1e-4: a point seen from one or two cameras
    has a 2-D block V near rank 2 (condition ~3e4 after damping), whose
    float32 inverse is good to ~2e-3 in its weak direction, and
    S, which W projects onto the others, to ~4e-5."""
    t = {k: torch.from_numpy(v.astype(dtype) if v.dtype == np.float32 else v) for k, v in prob.items()}
    pc = t["pc_obs"] if model == "3d" else None
    lam = 3e-5
    sys_ = ba_schur.reduced_system(t["poses"], t["points"], t["frame"], t["point"], t["uv"], t["valid"],
                                   torch.tensor(lam, dtype=t["poses"].dtype), INTR, pc)
    r, Jc, Jp, w = (x.double().numpy() for x in ba_schur._linearize(
        t["poses"], t["points"], t["frame"], t["point"], t["uv"], t["valid"], INTR, pc))
    U = np.zeros((F_CAP, 6, 6))
    V = np.zeros((P_CAP, 3, 3))
    bc = np.zeros((F_CAP, 6))
    bp = np.zeros((P_CAP, 3))
    Wd = np.zeros((F_CAP, P_CAP, 6, 3))
    for o, (f, p) in enumerate(zip(prob["frame"], prob["point"])):
        wc, wp = Jc[o] * w[o][:, None], Jp[o] * w[o][:, None]
        U[f] += wc.T @ Jc[o]
        V[p] += wp.T @ Jp[o]
        bc[f] += wc.T @ r[o]
        bp[p] += wp.T @ r[o]
        Wd[f, p] += wc.T @ Jp[o]

    def damp(M):
        d = np.trace(M, axis1=1, axis2=2) / M.shape[-1]
        idx = np.arange(M.shape[-1])
        M = M.copy()
        M[:, idx, idx] += lam * np.abs(M[:, idx, idx]) + 1e-6 * d[:, None] + 1e-9
        return M

    Vinv = np.linalg.inv(damp(V))
    S = np.zeros((6 * F_CAP, 6 * F_CAP))
    rhs = bc.reshape(-1).copy()
    Ud = damp(U)
    for f in range(F_CAP):
        S[6 * f:6 * f + 6, 6 * f:6 * f + 6] += Ud[f]
        for p in range(P_CAP):
            Y = Wd[f, p] @ Vinv[p]
            rhs[6 * f:6 * f + 6] -= Y @ bp[p]
            for g in range(F_CAP):
                S[6 * f:6 * f + 6, 6 * g:6 * g + 6] -= Y @ Wd[g, p].T
    tol = 1e-10 if dtype == np.float64 else 1e-5 if model == "3d" else 1e-4
    _close(sys_.S.numpy(), S, tol, "S")
    _close(sys_.rhs_c.numpy(), rhs, tol, "rhs_c")
    _close(sys_.b_p.numpy(), bp, 1e-10 if dtype == np.float64 else 1e-6, "b_p")
    observed = np.bincount(prob["point"][prob["valid"]], minlength=P_CAP) > 0
    _close(sys_.Vinv.numpy()[observed], Vinv[observed], 1e-10 if dtype == np.float64 else 1e-6 if model == "3d"
           else 1e-2, "Vinv of observed points")
    # a point with no observation damps to 1e-9 I
    assert np.allclose(sys_.Vinv.numpy()[~observed], 1e9 * np.eye(3), rtol=1e-6)


def _lists_problem(prob):
    """`prob` with a repeated (frame, point) (row 0 again, another
    measurement), a frame without observations in the middle (frame 3's
    rows invalid) beside the two padding frames, and the invalid rows."""
    pr = {k: v.copy() for k, v in prob.items()}
    for k, extra in (("frame", None), ("point", None), ("uv", pr["uv"][0] + 1.5), ("pc_obs", pr["pc_obs"][0] + 0.002),
                     ("valid", True)):
        pr[k] = np.concatenate([pr[k], [pr[k][0] if extra is None else extra]])
    pr["valid"] &= pr["frame"] != 3
    return pr


def _numpy_lists(frame, point, valid, F, P):
    """`build_lists`' fields, written out with Python sorts."""
    rows = range(len(frame))
    ok = [o for o in rows if valid[o] and 0 <= frame[o] < F and 0 <= point[o] < P]
    bad = [o for o in rows if o not in set(ok)]
    by_frame = sorted(ok, key=lambda o: (frame[o], point[o], o)) + bad
    by_point = sorted(ok, key=lambda o: (point[o], o)) + bad
    f_count = np.bincount(frame[ok], minlength=F)
    live = [f for f in range(F) if f_count[f] > 0]
    return dict(frame_ptr=np.r_[0, np.cumsum(f_count)], frame_obs=by_frame,
                point_ptr=np.r_[0, np.cumsum(np.bincount(point[ok], minlength=P))], point_obs=by_point,
                frame_point=[point[o] for o in by_frame[: len(ok)]] + [P] * len(bad),
                live_frames=live + [F] * (F - len(live)), num_live=len(live))


def _launch_b_pairs(lists, num_frames: int, chunk: int) -> list[tuple]:
    """The pairs (f, g, o1, o2) that launch B of `csrc/ba_schur.cu` sums,
    walked as it walks them: for each frame f, its keys (the points of its
    observations, ascending) in chunks of `chunk`; for each live column g and
    each of g's observations, the number of f's keys below its point by
    binary lifting (the largest power of two <= n first), then the run of
    keys equal to it."""
    fp, fo, fpt = (x.tolist() for x in (lists.frame_ptr, lists.frame_obs, lists.frame_point))
    live = lists.live_frames[: int(lists.num_live)].tolist()
    pairs = []
    for f in range(num_frames):
        for c0 in range(fp[f], fp[f + 1], chunk):
            keys = fpt[c0 : min(c0 + chunk, fp[f + 1])]
            n = len(keys)
            for g in live:
                for b in range(fp[g], fp[g + 1]):
                    q, pos, step = fpt[b], 0, 1 << (n.bit_length() - 1)
                    while step:
                        if pos + step <= n and keys[pos + step - 1] < q:
                            pos += step
                        step >>= 1
                    while pos < n and keys[pos] == q:
                        pairs.append((f, g, fo[c0 + pos], fo[b]))
                        pos += 1
    return pairs


@pytest.mark.parametrize("chunk", [512, 3])
def test_build_lists_match_numpy_and_launch_b_finds_every_pair(prob, chunk):
    """`build_lists` (the lists the kernel walks, made once per LM loop)
    against a numpy construction, on the padded problem with a repeated
    (frame, point), a frame without observations and invalid rows. Launch
    B's walk over them (`_launch_b_pairs`, in the kernel's chunks of 512
    observations and in chunks of 3) finds every pair of valid observations
    of one point once: sum over points of n_p^2 pairs, and summing Y_o1
    W_o2^T over them, with damp(U) on the diagonal, gives the plain
    version's S in float64 (to 1e-10: the same terms in another order)."""
    pr = _lists_problem(prob)
    t = {k: torch.from_numpy(v) for k, v in pr.items()}
    lists = ba_schur.build_lists(t["frame"], t["point"], t["valid"], F_CAP, P_CAP)
    want = _numpy_lists(pr["frame"], pr["point"], pr["valid"], F_CAP, P_CAP)
    for name, got in lists._asdict().items():
        assert got.dtype == torch.int64 and np.array_equal(got.numpy(), np.asarray(want[name])), name
    assert lists.live_frames[: int(lists.num_live)].tolist() == [0, 1, 2, 4, 5]

    pairs = _launch_b_pairs(lists, F_CAP, chunk)
    n_p = np.bincount(pr["point"][pr["valid"]], minlength=P_CAP)
    ok = np.nonzero(pr["valid"])[0]
    every = {(pr["frame"][a], pr["frame"][b], a, b) for a in ok for b in ok if pr["point"][a] == pr["point"][b]}
    assert len(pairs) == int((n_p**2).sum()) == len(every) and set(pairs) == every

    d = {k: v.double() if v.is_floating_point() else v for k, v in t.items()}
    lam = torch.tensor(3e-5, dtype=torch.float64)
    plain = ba_schur.reduced_system_reference(d["poses"], d["points"], d["frame"], d["point"], d["uv"], d["valid"],
                                              lam, INTR, d["pc_obs"])
    Y = torch.einsum("oij,ojk->oik", plain.W, plain.Vinv[d["point"]])
    S = torch.zeros((6 * F_CAP, 6 * F_CAP), dtype=torch.float64)
    for f, g, o1, o2 in pairs:
        S[6 * f : 6 * f + 6, 6 * g : 6 * g + 6] -= Y[o1] @ plain.W[o2].T
    _, J_pose, _, w = ba_schur._linearize(d["poses"], d["points"], d["frame"], d["point"], d["uv"], d["valid"],
                                          INTR, d["pc_obs"])
    U = torch.zeros((F_CAP, 6, 6), dtype=torch.float64).index_add_(
        0, d["frame"], torch.einsum("oki,ok,okj->oij", J_pose, w, J_pose))
    S += torch.block_diag(*ba_schur.damp(U, lam))
    _close(S.numpy(), plain.S.numpy(), 1e-10, "S from the walked pairs")


@pytest.mark.parametrize("model", ["2d", "3d"])
def test_optimize_device_matches_jax(prob, model):
    pc = prob["pc_obs"] if model == "3d" else None
    kw = dict(max_iters=10, anchor_scale=model == "2d")
    want = jax.jit(lambda ps, pt: jb.optimize_device(
        ps, pt, jax_obs(prob), jnp.asarray(prob["solve"]), *INTR,
        pc_obs=None if pc is None else jnp.asarray(pc), **kw))(jnp.asarray(prob["poses"]), jnp.asarray(prob["points"]))
    got = tb.optimize_device(torch.from_numpy(prob["poses"]), torch.from_numpy(prob["points"]), torch_obs(prob),
                             torch.from_numpy(prob["solve"]), *INTR,
                             pc_obs=None if pc is None else torch.from_numpy(pc), **kw)
    # the frames with observations (a padding frame moves only with 2-D's
    # re-anchored scale, where the two float32 runs differ: see the step test)
    assert np.abs(got[0].numpy()[:6] - np.asarray(want[0])[:6]).max() <= 1e-3
    mse_j, mse_t = float(want[2]), float(got[2])
    assert abs(mse_t - mse_j) <= 0.02 * mse_j, (mse_t, mse_j)
    # converged to the noise: 0.5 px (2-D) or 2 mm in sigma units (3-D)
    assert mse_t < (1.0 if model == "2d" else 3.0)


def test_host_optimize_matches_jax():
    """`optimize` (host LM with `ba_step`, the scale re-anchor) on the
    unpadded problem, every observation valid."""
    pr = make_problem(seed=3, n_invalid=0)
    n_pts = 120
    jp = jb.BAProblem(jnp.asarray(pr["poses"][:6]), jnp.asarray(pr["points"][:n_pts]),
                      jb.build_observations(pr["frame"], pr["point"], pr["uv"], n_pts))
    tp = tb.BAProblem(torch.from_numpy(pr["poses"][:6]), torch.from_numpy(pr["points"][:n_pts]),
                      tb.build_observations(pr["frame"], pr["point"], pr["uv"], n_pts))
    assert np.array_equal(tp.obs.obs_of_point.numpy(), np.asarray(jp.obs.obs_of_point))
    want, mse_j = jb.optimize(jp, *INTR, max_iters=10)
    got, mse_t = tb.optimize(tp, *INTR, max_iters=10)
    assert np.abs(got.poses.numpy() - np.asarray(want.poses)).max() <= 1e-3
    assert abs(mse_t - mse_j) <= 0.02 * mse_j and mse_t < 1.0, (mse_t, mse_j)
    assert np.array_equal(got.poses[0].numpy(), pr["poses"][0])  # the gauge
    cost_j = jb.ba_cost(want, *INTR, 6, n_pts)
    cost_t = tb.ba_cost(got, *INTR)
    assert abs(float(cost_t[1]) - float(cost_j[1])) == 0  # the same observations count


def test_schur_errors_tool_on_cpu(capsys):
    """`tools/torch_ba_schur_errors.py` on the CPU: a small card-test case
    (no kernel row; the plain version on the device is the CPU's; lam = 1
    halves the RGB-D model's V^-1), then the 2-D step on this file's
    problem in its four variants, then the shares of V blocks whose factors
    and inverse equal the library's."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import torch_ba_schur_errors as tool

    assert tool.main(["--device", "cpu", "--models", "3d", "--cases", "one_observation", "--lams", "1.0"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["lam"] for r in rows] == [0.0, 1.0] and "kernel" not in rows[0]
    assert all(r["plain"] == r["plain_cpu"] and max(r["plain_cpu_lu"].values()) < 1e-4 for r in rows)
    assert abs(rows[1]["moved"]["Vinv"] - 0.5) < 0.01
    assert tool.main(["--device", "cpu", "--bundle-problem"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [(r["inverse"], r["solve"]) for r in rows] == [("pivoted", "float32"), ("pivoted", "float64"),
                                                           ("lu", "float32"), ("lu", "float64")]
    assert all(0 < r["poses"] < 1e-2 and 0 < r["points"] < 1e-2 for r in rows)
    assert tool.main(["--device", "cpu", "--models", "3d", "--cases", "one_observation", "--library-match"]) == 0
    (row,) = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    shares = {k: v for k, v in row.items() if k.startswith(("lu_equals", "inv3_equals"))}
    assert row["blocks"] > 0 and len(shares) == 5 and all(0 <= v <= 1 for v in shares.values())


def test_compare_ba_schur_tool_on_cpu(capsys):
    """`tools/compare_torch_ba_schur.py` on the CPU, this tree against
    itself: 4 orbit frames at 160x120, 300 keypoints, no loop, one round.
    Both trees' plain versions are held to the plain version, no device time
    is reported, and the two trees' FusedBASlam runs agree. One intra-op
    thread: the run is thousands of small operations, whose thread pools
    stall each other when the test workers share the cores."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import compare_torch_ba_schur as tool

    root = str(Path(__file__).resolve().parent.parent)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert tool.main(["--parent", root, "--device", "cpu", "--level", "2", "--frames", "4", "--loop-frames", "0",
                          "--max-keypoints", "300", "--rounds", "1"]) == 0
    finally:
        torch.set_num_threads(threads)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["launch_b_speedup"] is None and list(out["bound"]) == ["orbit"]
    assert out["bound"]["orbit"]["pairs"] > 0 and out["bound"]["orbit"]["frames"] == 64
    for name in ("other", "this"):
        rows = out["steps"][name]["orbit"]
        assert len(rows) == 2 and all(r["step_ms"] is None and r["host_ms"] > 0 and r["max_rel_err"] == 0
                                      for r in rows)
    runs = out["fused_ba_slam"]
    assert runs["this"]["orbit"][0]["points"] > 0 and runs["other"]["orbit"][0] == {
        **runs["this"]["orbit"][0], "ms_per_frame": runs["other"]["orbit"][0]["ms_per_frame"]}
