"""The bundle-adjustment step's Schur reduction: the two observation models,
the damped blocks, the reduced camera system and the point back-substitution.

Port of lines :246-280 and :293-294 of `onepiece_tpu/optimization/bundle.py
_ba_step_masked` (and the observation models `_residuals_jacobians` :74 and
`_residuals_jacobians_3d` :205). For the weighted residuals r, pose
Jacobians J_c and point Jacobians J_p of the valid observations:

  U_f = sum_o J_c^T w J_c  (F, 6, 6),    b_c,f = sum_o J_c^T w r
  V_p = sum_o J_p^T w J_p  (P, 3, 3),    b_p,p = sum_o J_p^T w r
  W_o = J_c^T w J_p        (one 6x3 block per observation)
  damp(M) = M + (lam |M_ii| + 1e-6 tr(M) / n + 1e-9) on the diagonal
  S = damp(U) - W damp(V)^-1 W^T  (6F, 6F),  rhs_c = b_c - W damp(V)^-1 b_p
  dp = -damp(V)^-1 (b_p + W^T dc)  (the back-substitution, given dc)

The JAX package scatters W into a dense (F, 6, P, 3) tensor and contracts it
on the MXU. On CUDA tensors `reduced_system` and `back_substitute` launch
the hand-written kernels of `csrc/ba_schur.cu`, which work block-sparse:
S's block (f, g) is summed over the points that frames f and g share, in a
fixed order, with no atomics, so two calls are bit-equal, and S is written
straight to device memory, so F is bounded by device memory alone. They
take the observations sorted by point and by (frame, point), and the list
of frames that hold an observation (`build_lists`, once per LM loop: the
observation set is fixed while it runs). On CPU tensors the plain versions
run: JAX's dense formulation, literally, with the sequential `index_add_`
of the CPU.

V is inverted by a LAPACK-style LU with partial pivoting in both versions,
written out element by element (`inv3`), where the JAX package calls
`jnp.linalg.inv`: the kernel and its plain version then differ only in the
order of their sums.

Frozen copy for the benchmark's reference: the plain version on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3

# Depth-noise model of the RGB-D observation weights: sigma(z) = A + B (z -
# 0.4)^2 (Khoshelham & Elberink 2012's Kinect axial fit); the residual is
# weighted 1 / sigma(z)^2 and the Huber kernel acts in sigma units.
SIGMA_Z_A = 0.0015  # m
SIGMA_Z_B = 0.0019  # m^-1
HUBER_DELTA_SIGMA = 3.0
# the kernel's row of floats per observation: W_o, Y_o, U_o, g_o, each at a
# 16-byte boundary (csrc/ba_schur.cu kObsStride); W_o leads it
OBS_ROW = 84


class ObsLists(NamedTuple):
    """The valid observations sorted by (frame, point) and by point (stable,
    so observations of one frame and point, or of one point, keep their
    order), with CSR offsets; the point of each entry of the frame lists;
    the frames that hold an observation."""

    frame_ptr: torch.Tensor  # (F + 1,) int64
    frame_obs: torch.Tensor  # (O,) int64 observation indices, by frame, then point
    point_ptr: torch.Tensor  # (P + 1,) int64
    point_obs: torch.Tensor  # (O,) int64 observation indices, by point
    frame_point: torch.Tensor  # (O,) int64 the point of each frame_obs entry (P past the valid ones)
    live_frames: torch.Tensor  # (F,) int64 the frames with an observation, ascending, then F
    num_live: torch.Tensor  # () int64 how many frames have an observation


class SchurSystem(NamedTuple):
    S: torch.Tensor  # (6F, 6F) the reduced camera system
    rhs_c: torch.Tensor  # (6F,)
    Vinv: torch.Tensor  # (P, 3, 3) inverse of the damped point blocks
    b_p: torch.Tensor  # (P, 3)
    W: torch.Tensor  # (O, 6, 3) per observation (the kernel writes only the listed rows)
    U: torch.Tensor | None = None  # (F, 6, 6) undamped U blocks, with `undamped_u` only


def residuals_jacobians_2d(poses, points, frame, point, uv, valid, fx, fy, cx, cy):
    """Reprojection model: r (O, 2), J_pose (O, 2, 6), J_point (O, 2, 3), w (O,)."""
    T = poses[frame]
    pw = points[point]
    pc = torch.einsum("oij,oj->oi", T[:, :3, :3], pw) + T[:, :3, 3]
    z = pc[:, 2]
    zs = torch.where(z > 1e-6, z, 1.0)
    u = pc[:, 0] / zs * fx + cx
    v = pc[:, 1] / zs * fy + cy
    r = torch.stack([u, v], -1) - uv
    w = (valid & (z > 1e-6)).to(pc.dtype)
    iz = 1.0 / zs
    zero = torch.zeros_like(z)
    J_pc = torch.stack([
        torch.stack([fx * iz, zero, -fx * pc[:, 0] * iz * iz], -1),
        torch.stack([zero, fy * iz, -fy * pc[:, 1] * iz * iz], -1),
    ], 1)
    # pose: p_cam = exp(xi) T p_w, so dp/dxi = [I | -[p_cam]_x]
    Jp_ang = torch.einsum("okj,oji->oki", J_pc, -se3.skew(pc))
    J_pose = torch.cat([J_pc, Jp_ang], -1)
    J_point = torch.einsum("okj,oji->oki", J_pc, T[:, :3, :3])
    return r, J_pose, J_point, w


def residuals_jacobians_3d(poses, points, frame, point, pc_obs, valid):
    """RGB-D model: r = T_cw p_w - p_obs (O, 3), J_pose = [I | -[p_cam]_x]
    (O, 3, 6), J_point = R_cw (O, 3, 3), w (O, 3) = valid x Huber / sigma^2."""
    T = poses[frame]
    pw = points[point]
    pc = torch.einsum("oij,oj->oi", T[:, :3, :3], pw) + T[:, :3, 3]
    r = pc - pc_obs
    z_obs = torch.clamp(pc_obs[:, 2], min=0.0)
    sigma = SIGMA_Z_A + SIGMA_Z_B * torch.square(torch.clamp(z_obs - 0.4, min=0.0))
    rn = torch.linalg.vector_norm(r, dim=-1) / sigma
    w_huber = torch.clamp(HUBER_DELTA_SIGMA / torch.clamp(rn, min=1e-9), max=1.0)
    w = (valid.to(pc.dtype) * w_huber / torch.square(sigma))[:, None].expand(r.shape)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(r.shape[0], 3, 3)
    J_pose = torch.cat([eye, -se3.skew(pc)], -1)
    return r, J_pose, T[:, :3, :3], w


def _linearize(poses, points, frame, point, uv, valid, intr, pc_obs):
    """(r, J_pose, J_point, w per component) of the model pc_obs selects."""
    if pc_obs is None:
        r, J_pose, J_point, w = residuals_jacobians_2d(poses, points, frame, point, uv, valid, *intr)
        return r, J_pose, J_point, w[:, None].expand(r.shape)
    return residuals_jacobians_3d(poses, points, frame, point, pc_obs, valid)


def damp(M: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """M + (lam |M| + 1e-6 tr(M) / n + 1e-9) on the diagonal of each block."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    d = torch.einsum("bii->b", M) / n
    return M + (lam * torch.abs(M) + (1e-6 * d[:, None, None] + 1e-9)) * eye


def inv3(M: torch.Tensor) -> torch.Tensor:
    """Inverse of a batch of 3x3 matrices by a LAPACK-style LU with partial
    pivoting (getrf, then getrs against the identity), written out element
    by element: the kernel's `inv3`, operation for operation. A pivot is the
    first largest |entry| of its column; rows swap as one transposition."""
    a = [[M[:, i, j] for j in range(3)] for i in range(3)]
    one, zero = torch.ones_like(a[0][0]), torch.zeros_like(a[0][0])
    b = [[one if i == j else zero for j in range(3)] for i in range(3)]  # the identity, rows permuted as a's

    def swap_rows(i: int, j: int, swap: torch.Tensor) -> None:
        for m in (a, b):
            m[i], m[j] = ([torch.where(swap, y, x) for x, y in zip(m[i], m[j])],
                          [torch.where(swap, x, y) for x, y in zip(m[i], m[j])])

    take1 = torch.abs(a[1][0]) > torch.abs(a[0][0])
    take2 = torch.abs(a[2][0]) > torch.where(take1, torch.abs(a[1][0]), torch.abs(a[0][0]))
    swap_rows(0, 2, take2)
    swap_rows(0, 1, take1 & ~take2)
    r = 1 / a[0][0]  # the first column scaled by one reciprocal, as getf2 scales it
    l1 = a[1][0] * r
    l2 = a[2][0] * r
    a[1][1], a[1][2] = a[1][1] - l1 * a[0][1], a[1][2] - l1 * a[0][2]
    a[2][1], a[2][2] = a[2][1] - l2 * a[0][1], a[2][2] - l2 * a[0][2]
    a[1][0], a[2][0] = l1, l2
    swap_rows(1, 2, torch.abs(a[2][1]) > torch.abs(a[1][1]))
    l21 = a[2][1] / a[1][1]
    u22 = a[2][2] - l21 * a[1][2]
    cols = []
    for j in range(3):
        # L y = P e_j (unit lower), then U x = y (back substitution, LAPACK's column order)
        y0 = b[0][j]
        y1 = b[1][j] - y0 * a[1][0]
        y2 = (b[2][j] - y0 * a[2][0]) - y1 * l21
        x2 = y2 / u22
        y1 = y1 - x2 * a[1][2]
        y0 = y0 - x2 * a[0][2]
        x1 = y1 / a[1][1]
        y0 = y0 - x1 * a[0][1]
        cols.append(torch.stack([y0 / a[0][0], x1, x2], -1))
    return torch.stack(cols, -1)


def build_lists(frame, point, valid, num_frames: int, num_points: int) -> ObsLists:
    """Stable sorts of the valid observations by (frame, point) and by
    point, and the frames that hold one, on the device and without a host
    read. An invalid row, or one whose indices lie outside the capacities,
    takes the key past the last (F P, P) and falls off the lists."""
    ok = valid & (frame >= 0) & (frame < num_frames) & (point >= 0) & (point < num_points)
    dev = frame.device

    def csr(key, n, stride=1):
        key = torch.where(ok, key, n * stride)
        srt, order = torch.sort(key, stable=True)
        return srt, torch.searchsorted(srt, torch.arange(n + 1, device=dev) * stride), order

    fsrt, fp, fo = csr(frame * num_points + point, num_frames, num_points)
    _, pp, po = csr(point, num_points)
    frame_point = torch.where(fsrt < num_frames * num_points, fsrt % num_points, num_points)
    live = fp.diff() > 0
    frames = torch.arange(num_frames, device=dev)
    live_frames = torch.sort(torch.where(live, frames, num_frames)).values
    return ObsLists(fp, fo, pp, po, frame_point, live_frames, live.sum())


def reduced_system_reference(poses, points, frame, point, uv, valid, lam, intr, pc_obs=None,
                             undamped_u: bool = False) -> SchurSystem:
    """Plain version: JAX's dense formulation (`bundle.py:246-280`)."""
    F, P = poses.shape[0], points.shape[0]
    r, J_pose, J_point, w = _linearize(poses, points, frame, point, uv, valid, intr, pc_obs)
    dt = dict(dtype=poses.dtype, device=poses.device)
    U = torch.zeros((F, 6, 6), **dt).index_add_(0, frame, torch.einsum("oki,ok,okj->oij", J_pose, w, J_pose))
    V = torch.zeros((P, 3, 3), **dt).index_add_(0, point, torch.einsum("oki,ok,okj->oij", J_point, w, J_point))
    W = torch.einsum("oki,ok,okj->oij", J_pose, w, J_point)
    b_c = torch.zeros((F, 6), **dt).index_add_(0, frame, torch.einsum("oki,ok,ok->oi", J_pose, w, r))
    b_p = torch.zeros((P, 3), **dt).index_add_(0, point, torch.einsum("oki,ok,ok->oi", J_point, w, r))
    if not undamped_u:
        U = damp(U, lam)
    Vinv = inv3(damp(V, lam))
    Wd = torch.zeros((F, P, 6, 3), **dt).index_put_((frame, point), W, accumulate=True).permute(0, 2, 1, 3)
    Y = torch.einsum("fipk,pkl->fipl", Wd, Vinv)
    Ym = Y.reshape(F * 6, P * 3)
    S = -Ym @ Wd.reshape(F * 6, P * 3).T
    S = S + torch.block_diag(*U)
    rhs_c = b_c.reshape(F * 6) - Ym @ b_p.reshape(P * 3)
    return SchurSystem(S, rhs_c, Vinv, b_p, W, U if undamped_u else None)


def back_substitute_reference(system: SchurSystem, dc, frame, point) -> torch.Tensor:
    """Plain version of dp = -V^-1 (b_p + W^T dc) (`bundle.py:293-294`)."""
    wtdc = torch.zeros_like(system.b_p).index_add_(
        0, point, torch.einsum("oij,oi->oj", system.W, dc.reshape(-1, 6)[frame]))
    return -torch.einsum("pij,pj->pi", system.Vinv, system.b_p + wtdc)


def reduced_system(poses, points, frame, point, uv, valid, lam, intr, pc_obs=None,
                   lists: ObsLists | None = None, undamped_u: bool = False) -> SchurSystem:
    """The reduced camera system of one damped step: the CUDA kernel on CUDA
    tensors (over `lists`, the `build_lists` of these observations), the
    plain version on CPU tensors. `pc_obs` (O, 3) selects the RGB-D model,
    else the 2-D reprojection model over `uv`; `lam` is a 0-d float32
    tensor; `intr` is (fx, fy, cx, cy). With `undamped_u`, S holds U
    undamped (S = U - W damp(V)^-1 W^T) and the system carries U's blocks
    (`U`, (F, 6, 6)): a point-sharded step sums both over its shards and
    damps U once, after the sum."""
    return reduced_system_reference(poses, points, frame, point, uv, valid, lam, intr, pc_obs, undamped_u)


def back_substitute(system: SchurSystem, dc, frame, point, lists: ObsLists | None = None) -> torch.Tensor:
    """dp = -V^-1 (b_p + W^T dc) (P, 3) for the camera step dc (6F,): the
    CUDA kernel on CUDA tensors (over the point lists `reduced_system` used),
    the plain version on CPU tensors."""
    return back_substitute_reference(system, dc, frame, point)
