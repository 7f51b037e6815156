"""Bundle adjustment with Schur-complement landmark marginalization.

Array-native replacement for the reference's g2o BA stack
(src/optimizers/BundleAdjustment.cc, LocalBundleAdjustment.cc,
GlobalBundleAdjustment.cc): Levenberg-Marquardt over keyframe poses [K] and
landmark positions [L], with the landmark block eliminated exactly as g2o
does via `setMarginalized(true)` (BundleAdjustment.cc:221) — but assembled
as dense matmul-heavy linear algebra instead of sparse CPU factorization:

  For each landmark l with (padded) observations o:
    V_l     = sum_o w J_pt^T J_pt + lambda diag      (3x3)
    W_lo    = w J_pose^T J_pt                         (6x3)
    Y_lo    = W_lo M_l,  M_l M_l^T = V_l^{-1}         (6x3)
  Scatter Y into Z[l, k] (one obs per (l,k) pair at most) and the reduced
  camera system becomes a sequence of rank-3C matmul updates:
    S  = Hpp_diag - sum_chunks Z_c^T Z_c              ([6K, 6K], matmuls)
    b^ = b_pose   - sum_chunks Z_c^T y_c
  solved densely (Cholesky-class) per LM iteration; landmarks back-substitute
  in closed form. Landmark chunking bounds peak memory; chunks shard across
  devices with a psum reduction of (S, b^) for multi-host BA
  (hyslam_tpu.parallel.dist_ba).

Layout: observations are grouped per landmark in padded [L, O] blocks
(SURVEY.md §7.1 arena design). Per-KF intrinsics arrays make the kernel
camera-generic (multi-camera maps, System.cc:91-117).
"""

from __future__ import annotations

from functools import partial

from hyslam_tpu.utils.precision import f32 as _f32
from typing import NamedTuple

import jax
import jax.numpy as jnp

from hyslam_tpu.geometry import se3, so3
from hyslam_tpu.solver import robust
from hyslam_tpu.solver.priors import (
    PosePriors,
    linearize_priors,
    linearize_priors_blocks,
    prior_cost,
    tie_offdiag_dense,
    tie_offdiag_matvec,
)


class CamArrays(NamedTuple):
    """Per-keyframe pinhole parameters [K] (camera-generic BA kernel)."""

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    bf: jnp.ndarray


class BAObservations(NamedTuple):
    """Padded per-landmark observation blocks.

    kf:          [L, O] int32 keyframe index (any value where invalid)
    uv:          [L, O, 2] pixel observations
    ur:          [L, O] right-image u (stereo rows only)
    inv_sigma2:  [L, O] per-observation information
    stereo:      [L, O] bool
    valid:       [L, O] bool
    """

    kf: jnp.ndarray
    uv: jnp.ndarray
    ur: jnp.ndarray
    inv_sigma2: jnp.ndarray
    stereo: jnp.ndarray
    valid: jnp.ndarray


class BAProblem(NamedTuple):
    kf_Tcw: jnp.ndarray      # [K, 4, 4]
    kf_fixed: jnp.ndarray    # [K] bool: pose held constant (fixed observers /
                             # origin KF, LocalBundleAdjustment.cc:251-272)
    cams: CamArrays          # [K] intrinsics
    lm_pos: jnp.ndarray      # [L, 3]
    lm_valid: jnp.ndarray    # [L] bool
    obs: BAObservations
    priors: PosePriors | None = None  # sensor + tiepoint pose priors
                             # (BundleAdjustment.cc:60-201)


class BAResult(NamedTuple):
    kf_Tcw: jnp.ndarray
    lm_pos: jnp.ndarray
    obs_chi2: jnp.ndarray     # [L, O] final chi2 per observation
    obs_inlier: jnp.ndarray   # [L, O] chi2 <= threshold & positive depth
    cost: jnp.ndarray         # final robust cost


def _obs_residuals(p: BAProblem, kf_Tcw, lm_pos):
    """Residuals r [L,O,3], camera-frame points pc [L,O,3], per-obs camera
    row-gathered from kf index."""
    kf = jnp.clip(p.obs.kf, 0, kf_Tcw.shape[0] - 1)
    T = kf_Tcw[kf]                       # [L, O, 4, 4]
    pc = se3.apply(T, lm_pos[:, None, :])
    fx = p.cams.fx[kf]
    fy = p.cams.fy[kf]
    cx = p.cams.cx[kf]
    cy = p.cams.cy[kf]
    bf = p.cams.bf[kf]
    z = pc[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = fx * pc[..., 0] / zs + cx
    v = fy * pc[..., 1] / zs + cy
    ur = u - bf / zs
    r3 = jnp.where(p.obs.stereo, ur - p.obs.ur, 0.0)
    r = jnp.stack([u - p.obs.uv[..., 0], v - p.obs.uv[..., 1], r3], axis=-1)
    return r, pc, (fx, fy, bf), T


def _obs_jacobians(pc, fx, fy, bf, stereo, T):
    """J_pose [L,O,3,6] (left-mult tangent), J_point [L,O,3,3]."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    iz = 1.0 / zs
    iz2 = iz * iz
    zero = jnp.zeros_like(x)
    Ju = jnp.stack([fx * iz, zero, -fx * x * iz2], axis=-1)
    Jv = jnp.stack([zero, fy * iz, -fy * y * iz2], axis=-1)
    Jur = jnp.stack([fx * iz, zero, -fx * x * iz2 + bf * iz2], axis=-1)
    Jur = jnp.where(stereo[..., None], Jur, 0.0)
    Jproj = jnp.stack([Ju, Jv, Jur], axis=-2)            # [L,O,3,3]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), pc.shape[:-1] + (3, 3))
    dpc = jnp.concatenate([-so3.hat(pc), eye], axis=-1)  # [L,O,3,6]
    J_pose = Jproj @ dpc
    J_point = Jproj @ T[..., :3, :3]
    return J_pose, J_point


def _inv3x3(A):
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    det = jnp.where(jnp.abs(det) < 1e-18, 1e-18, det)
    adj = jnp.stack(
        [
            jnp.stack([co00, co01, co02], -1),
            jnp.stack([co10, co11, co12], -1),
            jnp.stack([co20, co21, co22], -1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def _chol3x3(A):
    """Batched closed-form lower Cholesky of SPD 3x3 (guarded sqrt)."""
    def s(x):
        return jnp.sqrt(jnp.maximum(x, 1e-18))

    l00 = s(A[..., 0, 0])
    l10 = A[..., 1, 0] / l00
    l11 = s(A[..., 1, 1] - l10 * l10)
    l20 = A[..., 2, 0] / l00
    l21 = (A[..., 2, 1] - l20 * l10) / l11
    l22 = s(A[..., 2, 2] - l20 * l20 - l21 * l21)
    z = jnp.zeros_like(l00)
    return jnp.stack(
        [
            jnp.stack([l00, z, z], -1),
            jnp.stack([l10, l11, z], -1),
            jnp.stack([l20, l21, l22], -1),
        ],
        axis=-2,
    )


def _robust_cost(p: BAProblem, kf_Tcw, lm_pos, huber: bool):
    r, pc, _, _ = _obs_residuals(p, kf_Tcw, lm_pos)
    c2 = p.obs.inv_sigma2 * jnp.sum(r * r, axis=-1)
    delta2 = jnp.where(p.obs.stereo, robust.CHI2_STEREO, robust.CHI2_MONO)
    cost = jnp.where(huber, robust.huber_rho(c2, delta2), c2)
    w_valid = (p.obs.valid & p.lm_valid[:, None] & (pc[..., 2] > 0.0)).astype(r.dtype)
    total = jnp.sum(cost * w_valid)
    if p.priors is not None:
        total = total + prior_cost(kf_Tcw, p.priors)
    return total


def _linearize_factors(p: BAProblem, kf_Tcw, lm_pos, lam, obs_active,
                       huber: bool):
    """Linearize all observations and eliminate the landmark block.

    Returns (Hpp [K,6,6], b_pose [K,6], Y [L,O,6,3], y [L,3],
    Vinv [L,3,3], Wlo [L,O,6,3], b_lm [L,3], kf_idx [L,O]), where
    S_red = sum_l A_l A_l^T with A_{l,k} = sum_{o: kf=k} Y[l,o] — the
    factored form consumed either densely (_schur_reduce_dense) or
    matrix-free by the CG solve (_solve_poses_cg)."""
    K = kf_Tcw.shape[0]
    dtype = kf_Tcw.dtype

    r, pc, (fx, fy, bf), T = _obs_residuals(p, kf_Tcw, lm_pos)
    c2 = p.obs.inv_sigma2 * jnp.sum(r * r, axis=-1)
    delta2 = jnp.where(p.obs.stereo, robust.CHI2_STEREO, robust.CHI2_MONO)
    w_h = jnp.where(huber, robust.huber_weight(c2, delta2), 1.0)
    w = (
        p.obs.inv_sigma2
        * w_h
        * (obs_active & p.lm_valid[:, None] & (pc[..., 2] > 0.0)).astype(dtype)
    )

    J_pose, J_point = _obs_jacobians(pc, fx, fy, bf, p.obs.stereo, T)
    kf_idx = jnp.clip(p.obs.kf, 0, K - 1)

    # ---- pose-diagonal blocks & gradient (scatter by kf) ----
    Hpp_blk = jnp.einsum("lo,lori,lorj->loij", w, J_pose, J_pose)  # [L,O,6,6]
    bp_blk = -jnp.einsum("lo,lori,lor->loi", w, J_pose, r)          # [L,O,6]
    Hpp = jax.ops.segment_sum(
        Hpp_blk.reshape(-1, 6, 6), kf_idx.reshape(-1), num_segments=K
    )
    b_pose = jax.ops.segment_sum(
        bp_blk.reshape(-1, 6), kf_idx.reshape(-1), num_segments=K
    )

    # ---- landmark blocks ----
    V = jnp.einsum("lo,lori,lorj->lij", w, J_point, J_point)        # [L,3,3]
    b_lm = -jnp.einsum("lo,lori,lor->li", w, J_point, r)            # [L,3]
    V_d = V + lam * jnp.eye(3, dtype=dtype) * jnp.maximum(
        jnp.einsum("lii->l", V)[:, None, None] / 3.0, 1e-6
    )
    Vinv = _inv3x3(V_d)
    M = _chol3x3(Vinv)                                              # Vinv = M M^T

    Wlo = jnp.einsum("lo,lori,lorj->loij", w, J_pose, J_point)      # [L,O,6,3]
    Y = Wlo @ M[:, None]                                            # [L,O,6,3]
    y = jnp.einsum("lji,lj->li", M, b_lm)                           # M^T b  [L,3]
    return Hpp, b_pose, Y, y, Vinv, Wlo, b_lm, kf_idx


def _schur_reduce_dense(Y, y, kf_idx, K: int, chunk: int):
    """Dense Schur reduction over landmark chunks (rank-3C matmul updates).

    Returns (S_red [6K,6K], b_red [K,6])."""
    L, O = kf_idx.shape
    dtype = Y.dtype
    n_chunks = (L + chunk - 1) // chunk
    Lp = n_chunks * chunk
    pad = Lp - L

    def padL(x):
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

    Y_p = padL(Y).reshape(n_chunks, chunk, O, 6, 3)
    y_p = padL(y).reshape(n_chunks, chunk, 3)
    kf_p = padL(kf_idx).reshape(n_chunks, chunk, O)

    def chunk_step(carry, inp):
        S_acc, bh_acc = carry
        Yc, yc, kfc = inp
        # scatter obs into Z[l, k, 6, 3]; at most one obs per (l, k)
        Z = jnp.zeros((chunk, K, 6, 3), dtype)
        lidx = jnp.broadcast_to(
            jnp.arange(chunk)[:, None], (chunk, O)
        )
        Z = Z.at[lidx.reshape(-1), kfc.reshape(-1)].add(
            Yc.reshape(-1, 6, 3)
        )
        Zf = Z.transpose(0, 3, 1, 2).reshape(chunk * 3, K * 6)  # [(l b), (k a)]
        S_acc = S_acc + Zf.T @ Zf
        # b^ contribution: sum_l Z[l,k] @ y_l
        bh_acc = bh_acc + jnp.einsum("lkab,lb->ka", Z, yc)
        return (S_acc, bh_acc), None

    S0 = jnp.zeros((K * 6, K * 6), dtype)
    bh0 = jnp.zeros((K, 6), dtype)
    (S_red, b_red), _ = jax.lax.scan(
        chunk_step, (S0, bh0), (Y_p, y_p, kf_p)
    )
    return S_red, b_red


def _reduced_matvec(Y, kf_idx, x):
    """Matrix-free S_red @ x for x [K,6]: t_l = sum_o Y[l,o]^T x[kf(l,o)],
    then scatter sum_o Y[l,o] t_l back by keyframe. O(L*O) per product —
    never materializes [6K,6K]."""
    K = x.shape[0]
    t = jnp.einsum("loac,loa->lc", Y, x[kf_idx])                    # [L,3]
    u = jnp.einsum("loac,lc->loa", Y, t)                            # [L,O,6]
    return jax.ops.segment_sum(
        u.reshape(-1, 6), kf_idx.reshape(-1), num_segments=K
    )


def _reduced_rhs(Y, y, kf_idx, K: int):
    """b_red [K,6] = sum_l A_{l,k} y_l, matrix-free."""
    u = jnp.einsum("loac,lc->loa", Y, y)
    return jax.ops.segment_sum(
        u.reshape(-1, 6), kf_idx.reshape(-1), num_segments=K
    )


def _reduced_diag(Y, kf_idx, K: int):
    """Block-diagonal of S_red [K,6,6] (for the block-Jacobi CG
    preconditioner): sum over observations of Y Y^T scattered by kf."""
    D = jnp.einsum("loac,lobc->loab", Y, Y)                         # [L,O,6,6]
    return jax.ops.segment_sum(
        D.reshape(-1, 6, 6), kf_idx.reshape(-1), num_segments=K
    )


def _linearize(p: BAProblem, kf_Tcw, lm_pos, lam, obs_active, huber: bool,
               chunk: int):
    """Linearize all observations and reduce the landmark block (dense form).

    Returns (Hpp [K,6,6], b_pose [K,6], S_red [6K,6K], b_red [K,6],
    Vinv [L,3,3], Wlo [L,O,6,3], b_lm [L,3], kf_idx [L,O]).

    The first four are SUMS over landmarks — in multi-device BA each shard
    computes them for its landmark slice and they are psum'ed
    (hyslam_tpu.parallel.dist_ba); the rest stay shard-local for
    back-substitution."""
    K = kf_Tcw.shape[0]
    Hpp, b_pose, Y, y, Vinv, Wlo, b_lm, kf_idx = _linearize_factors(
        p, kf_Tcw, lm_pos, lam, obs_active, huber
    )
    S_red, b_red = _schur_reduce_dense(Y, y, kf_idx, K, chunk)
    return Hpp, b_pose, S_red, b_red, Vinv, Wlo, b_lm, kf_idx


def _solve_poses(Hpp, b_pose, S_red, b_red, kf_fixed, lam):
    """Solve the reduced camera system (replicated across shards in the
    distributed path). Returns delta_pose [K, 6]."""
    K = Hpp.shape[0]
    dtype = Hpp.dtype
    Hpp_d = Hpp + lam * jnp.eye(6, dtype=dtype) * jnp.maximum(
        jnp.einsum("kii->k", Hpp)[:, None, None] / 6.0, 1e-6
    )
    S = jnp.zeros((K, 6, K, 6), dtype)
    S = S.at[jnp.arange(K), :, jnp.arange(K), :].set(Hpp_d)
    S = S.reshape(K * 6, K * 6) - S_red
    bhat = (b_pose - b_red).reshape(K * 6)

    # fixed / unused poses: identity rows+cols, zero rhs
    free = (~kf_fixed) & (jnp.einsum("kii->k", Hpp) > 0)
    fmask = jnp.repeat(free.astype(dtype), 6)
    S = S * fmask[:, None] * fmask[None, :] + jnp.diag(1.0 - fmask)
    bhat = bhat * fmask

    delta_pose = jax.scipy.linalg.solve(S, bhat, assume_a="pos").reshape(K, 6)
    return jnp.where(jnp.isfinite(delta_pose), delta_pose, 0.0)


def _solve_poses_cg(Hpp, b_pose, b_red, Y, kf_idx, kf_fixed, lam,
                    priors: PosePriors | None = None,
                    Hab: jnp.ndarray | None = None,
                    n_cg: int = 200, tol: float = 1e-5,
                    psum_axis: str | None = None):
    """Solve the reduced camera system with preconditioned CG on
    matrix-free S-products (no [6K,6K] ever materialized) — the K >~ 1k
    path where the dense solve becomes a memory/flops wall.

    S x = Hpp_d x - S_red x (+ tiepoint off-diagonal), with S_red products
    via _reduced_matvec. Preconditioner: block-Jacobi on the exact 6x6
    diagonal blocks of S. With psum_axis set, Y/kf_idx are landmark-shard
    local and every S-product psums a [K,6] — communication per CG step is
    O(K), not O(K^2) (hyslam_tpu.parallel.dist_ba)."""
    K = Hpp.shape[0]
    dtype = Hpp.dtype
    Hpp_d = Hpp + lam * jnp.eye(6, dtype=dtype) * jnp.maximum(
        jnp.einsum("kii->k", Hpp)[:, None, None] / 6.0, 1e-6
    )
    free = (~kf_fixed) & (jnp.einsum("kii->k", Hpp) > 0)
    fm = free[:, None].astype(dtype)                               # [K,1]

    def psum(v):
        return jax.lax.psum(v, psum_axis) if psum_axis else v

    def S_mv(x):
        xz = x * fm
        out = jnp.einsum("kij,kj->ki", Hpp_d, xz) - psum(
            _reduced_matvec(Y, kf_idx, xz))
        if priors is not None and Hab is not None:
            out = out + tie_offdiag_matvec(priors, Hab, xz, K)
        # identity on fixed/unused coordinates keeps S SPD
        return out * fm + x * (1.0 - fm)

    # block-Jacobi preconditioner from the exact diagonal blocks of S
    D = Hpp_d - psum(_reduced_diag(Y, kf_idx, K))
    eye6 = jnp.eye(6, dtype=dtype)
    D = jnp.where(free[:, None, None], D, eye6)
    Dinv = jnp.linalg.inv(D)

    def precond(r):
        return jnp.einsum("kij,kj->ki", Dinv, r) * fm + r * (1.0 - fm)

    bhat = (b_pose - psum(b_red)) * fm
    delta, _ = jax.scipy.sparse.linalg.cg(
        S_mv, bhat, M=precond, tol=tol, maxiter=n_cg
    )
    return jnp.where(jnp.isfinite(delta) & free[:, None], delta, 0.0)


def _backsub(Vinv, Wlo, b_lm, kf_idx, delta_pose, lm_valid):
    """Per-landmark back-substitution (shard-local)."""
    dp_obs = delta_pose[kf_idx]                                      # [L,O,6]
    rhs = b_lm - jnp.einsum("loij,loi->lj", Wlo, dp_obs)             # W^T dp
    delta_lm = jnp.einsum("lij,lj->li", Vinv, rhs)
    return jnp.where(
        (lm_valid[:, None]) & jnp.isfinite(delta_lm), delta_lm, 0.0
    )


def _assemble_and_solve(p: BAProblem, kf_Tcw, lm_pos, lam, obs_active, huber: bool,
                        chunk: int, solver: str = "dense"):
    """One Gauss-Newton/LM linearization + Schur solve.

    solver: 'dense' materializes the [6K,6K] reduced system and solves by
    Cholesky-class factorization; 'cg' runs matrix-free preconditioned CG
    (memory O(K), for K >~ 1k maps). Returns (delta_pose [K,6],
    delta_lm [L,3])."""
    K = kf_Tcw.shape[0]
    Hpp, b_pose, Y, y, Vinv, Wlo, b_lm, kf_idx = _linearize_factors(
        p, kf_Tcw, lm_pos, lam, obs_active, huber
    )
    Hab = None
    if p.priors is not None:
        Hd_pr, b_pr, Hab = linearize_priors_blocks(kf_Tcw, p.priors)
        Hpp = Hpp + Hd_pr           # damped with the reprojection diagonal
        b_pose = b_pose + b_pr
    if solver == "cg":
        b_red = _reduced_rhs(Y, y, kf_idx, K)
        delta_pose = _solve_poses_cg(
            Hpp, b_pose, b_red, Y, kf_idx, p.kf_fixed, lam,
            priors=p.priors, Hab=Hab,
        )
    else:
        S_red, b_red = _schur_reduce_dense(Y, y, kf_idx, K, chunk)
        if p.priors is not None:
            S_red = S_red - tie_offdiag_dense(p.priors, Hab, K, Hpp.dtype)
        delta_pose = _solve_poses(Hpp, b_pose, S_red, b_red, p.kf_fixed, lam)
    delta_lm = _backsub(Vinv, Wlo, b_lm, kf_idx, delta_pose, p.lm_valid)
    return delta_pose, delta_lm


@_f32
@partial(jax.jit, static_argnames=("n_iters", "huber", "chunk", "solver"))
def bundle_adjustment(
    p: BAProblem,
    n_iters: int = 10,
    huber: bool = True,
    chunk: int = 256,
    obs_active: jnp.ndarray | None = None,
    lam0: float = 1e-4,
    solver: str = "auto",
) -> BAResult:
    """LM bundle adjustment over (poses, landmarks).

    obs_active optionally masks observations (the two-phase local-BA driver
    passes the phase-1 inlier mask here, LocalBundleAdjustment.cc:113-152).
    solver: 'dense' | 'cg' | 'auto' (auto = cg when the dense [6K,6K]
    reduced system would exceed the small-map regime, K >= 512).
    """
    if solver == "auto":
        solver = "cg" if p.kf_Tcw.shape[0] >= 512 else "dense"
    if obs_active is None:
        obs_active = p.obs.valid
    else:
        obs_active = obs_active & p.obs.valid

    def step(state, _):
        kf_Tcw, lm_pos, lam, cost = state
        dp, dl = _assemble_and_solve(p, kf_Tcw, lm_pos, lam, obs_active, huber,
                                     chunk, solver)
        kf_new = se3.exp(dp) @ kf_Tcw
        kf_new = jnp.where(p.kf_fixed[:, None, None], kf_Tcw, kf_new)
        lm_new = lm_pos + dl
        new_cost = _robust_cost(
            p._replace(obs=p.obs._replace(valid=obs_active)), kf_new, lm_new, huber
        )
        accept = new_cost < cost
        kf_out = jnp.where(accept, kf_new, kf_Tcw)
        lm_out = jnp.where(accept, lm_new, lm_pos)
        lam_out = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e4)
        return (kf_out, lm_out, lam_out, jnp.minimum(new_cost, cost)), None

    cost0 = _robust_cost(
        p._replace(obs=p.obs._replace(valid=obs_active)), p.kf_Tcw, p.lm_pos, huber
    )
    init = (p.kf_Tcw, p.lm_pos, jnp.asarray(lam0, p.kf_Tcw.dtype), cost0)
    (kf_Tcw, lm_pos, _, cost), _ = jax.lax.scan(step, init, None, length=n_iters)

    r, pc, _, _ = _obs_residuals(p, kf_Tcw, lm_pos)
    c2 = p.obs.inv_sigma2 * jnp.sum(r * r, axis=-1)
    th = jnp.where(p.obs.stereo, robust.CHI2_STEREO, robust.CHI2_MONO)
    inlier = p.obs.valid & (c2 <= th) & (pc[..., 2] > 0.0)
    return BAResult(kf_Tcw=kf_Tcw, lm_pos=lm_pos, obs_chi2=c2, obs_inlier=inlier, cost=cost)


def local_ba_two_phase(p: BAProblem, chunk: int = 256,
                       solver: str = "auto") -> BAResult:
    """The reference's local-BA schedule (LocalBundleAdjustment.cc:113-152):
    5 robust iterations, demote chi2 outliers, then 10 more iterations without
    them; caller erases outlier associations from the map afterwards."""
    phase1 = bundle_adjustment(p, n_iters=5, huber=True, chunk=chunk,
                               solver=solver)
    p2 = p._replace(kf_Tcw=phase1.kf_Tcw, lm_pos=phase1.lm_pos)
    phase2 = bundle_adjustment(
        p2, n_iters=10, huber=False, chunk=chunk, obs_active=phase1.obs_inlier,
        solver=solver,
    )
    return phase2
