"""Pose-only optimization: `Optimizer::PoseOptimization` as one program.

The reference (src/optimizers/Optimizer.cc:48-280) optimizes a single frame
pose against its matched landmarks with g2o LM: 4 rounds x 10 iterations,
Huber at sqrt(5.991) mono / sqrt(7.815) stereo, reclassifying outliers
between rounds by chi2 and dropping the robust kernel for later rounds.

Here the whole schedule is ONE jitted program over fixed-size padded arrays:
landmark positions [N,3], observations [N,2]+[N], per-level information
[N], masks [N]. The normal equations are a single 6x6 system per iteration —
assembled with einsum over the batch — so the entire 40-iteration schedule
runs on-device with no host sync (the hot per-frame path, called 1-2x per
tracked frame as in Tracking.cc call stacks, SURVEY.md §3.2).
"""

from __future__ import annotations

from functools import partial

from hyslam_tpu.utils.precision import f32 as _f32
from typing import NamedTuple

import jax
import jax.numpy as jnp

from hyslam_tpu.geometry import se3
from hyslam_tpu.geometry.camera import Camera
from hyslam_tpu.ops import pose_opt_pallas
from hyslam_tpu.solver import robust
from hyslam_tpu.solver.residuals import (
    camera_point,
    chi2,
    reproj_jacobians,
    reproj_residual,
)


class PoseOptResult(NamedTuple):
    Tcw: jnp.ndarray        # [4,4] optimized pose
    inliers: jnp.ndarray    # [N] bool, valid & chi2 below threshold
    num_inliers: jnp.ndarray  # scalar int32
    chi2: jnp.ndarray       # [N] final per-observation chi2


def _lm_rounds(
    cam: Camera,
    Tcw0: jnp.ndarray,
    X: jnp.ndarray,
    uv: jnp.ndarray,
    ur: jnp.ndarray,
    inv_sigma2: jnp.ndarray,
    valid: jnp.ndarray,
    stereo: jnp.ndarray,
    n_rounds: int,
    iters_per_round: int,
):
    chi2_th = jnp.where(stereo, robust.CHI2_STEREO, robust.CHI2_MONO)

    def residual_chi2(T):
        pc = camera_point(T, X)
        r = reproj_residual(cam, pc, uv, ur, stereo)
        c2 = chi2(r, inv_sigma2, stereo)
        # behind-camera points are hard outliers (reference marks depth<0
        # via isDepthPositive checks in the matcher before optimization)
        c2 = jnp.where(pc[..., 2] > 0.05, c2, 1e9)
        return pc, r, c2

    def one_round(carry, round_idx):
        T, active = carry
        use_huber = round_idx < 2  # reference drops the kernel after 2 rounds
        delta2 = jnp.where(stereo, robust.CHI2_STEREO, robust.CHI2_MONO)

        def lm_iter(state, _):
            T, lam, _prev_cost = state
            pc, r, c2 = residual_chi2(T)
            w_h = jnp.where(use_huber, robust.huber_weight(c2, delta2), 1.0)
            w = inv_sigma2 * w_h * active.astype(r.dtype)
            Jp, _ = reproj_jacobians(cam, T, pc, stereo)
            # H = sum_i w_i J_i^T J_i  (per-row weight is scalar: Omega = w*I)
            H = jnp.einsum("n,nri,nrj->ij", w, Jp, Jp)
            g = -jnp.einsum("n,nri,nr->i", w, Jp, r)
            cost = jnp.sum(w * jnp.sum(r * r, axis=-1))

            D = jnp.diag(jnp.maximum(jnp.diag(H), 1e-6))
            delta = jnp.linalg.solve(H + lam * D, g)
            T_new = se3.exp(delta) @ T

            _, r2, c2_2 = residual_chi2(T_new)
            w2 = inv_sigma2 * jnp.where(
                use_huber, robust.huber_weight(c2_2, delta2), 1.0
            ) * active.astype(r.dtype)
            new_cost = jnp.sum(w2 * jnp.sum(r2 * r2, axis=-1))

            accept = (new_cost < cost) & jnp.all(jnp.isfinite(delta))
            T_out = jnp.where(accept, T_new, T)
            lam_out = jnp.where(accept, lam * 0.5, lam * 4.0)
            lam_out = jnp.clip(lam_out, 1e-9, 1e6)
            return (T_out, lam_out, jnp.where(accept, new_cost, cost)), None

        init = (T, jnp.asarray(1e-3, T.dtype), jnp.asarray(jnp.inf, T.dtype))
        (T, _, _), _ = jax.lax.scan(lm_iter, init, None, length=iters_per_round)

        # reclassify: outliers excluded from the next round (Optimizer.cc:195)
        _, _, c2 = residual_chi2(T)
        active_next = valid & (c2 <= chi2_th)
        return (T, active_next), None

    (T, active), _ = jax.lax.scan(
        one_round, (Tcw0, valid), jnp.arange(n_rounds), length=n_rounds
    )
    _, _, c2 = residual_chi2(T)
    inliers = valid & (c2 <= chi2_th)
    return T, inliers, c2


@_f32
@partial(jax.jit, static_argnames=("cam", "n_rounds", "iters_per_round"))
def pose_optimization(
    cam: Camera,
    Tcw0: jnp.ndarray,
    X: jnp.ndarray,
    uv: jnp.ndarray,
    ur: jnp.ndarray,
    inv_sigma2: jnp.ndarray,
    valid: jnp.ndarray,
    stereo: jnp.ndarray,
    n_rounds: int = 4,
    iters_per_round: int = 10,
) -> PoseOptResult:
    """Optimize a single camera pose against fixed landmarks.

    Args:
      cam: camera intrinsics (static).
      Tcw0: [4,4] initial world->cam pose.
      X: [N,3] landmark world positions (padded; mask with `valid`).
      uv: [N,2] observed pixels; ur: [N] observed right-u (0 where mono).
      inv_sigma2: [N] per-observation information (1/sigma^2 of its level).
      valid: [N] bool — real observations.
      stereo: [N] bool — rows with a valid right-u measurement.

    Returns PoseOptResult. Mirrors Optimizer::PoseOptimization semantics:
    the returned inlier mask is what the tracker uses to prune outliers
    (TrackMotionModel.cpp:60-80).
    """
    T, inliers, c2 = _lm_rounds(
        cam, Tcw0, X, uv, ur, inv_sigma2, valid, stereo, n_rounds, iters_per_round
    )
    return PoseOptResult(
        Tcw=T,
        inliers=inliers,
        num_inliers=jnp.sum(inliers.astype(jnp.int32)),
        chi2=c2,
    )


def use_pose_kernel() -> bool:
    """Platform rule for the per-frame pose LM: the single-launch Triton
    kernel (ops/pose_opt_pallas.py) on the GPU, the plain XLA solver on
    every other backend."""
    return jax.default_backend() == "gpu"


def pose_optimization_fast(
    cam: Camera,
    Tcw0: jnp.ndarray,
    X: jnp.ndarray,
    uv: jnp.ndarray,
    ur: jnp.ndarray,
    inv_sigma2: jnp.ndarray,
    valid: jnp.ndarray,
    stereo: jnp.ndarray,
    n_rounds: int = 4,
    iters_per_round: int = 10,
) -> PoseOptResult:
    """pose_optimization for the per-frame tracking path: the whole LM
    schedule in one kernel launch where `use_pose_kernel()` says so, the
    plain solver otherwise. Both give the same result up to float32
    reduction order (tests/test_pose_opt_pallas.py)."""
    if not use_pose_kernel():
        return pose_optimization(
            cam, Tcw0, X, uv, ur, inv_sigma2, valid, stereo,
            n_rounds=n_rounds, iters_per_round=iters_per_round,
        )
    T, c2 = pose_opt_pallas.pose_optimization_pallas(
        cam, Tcw0, X, uv, ur, inv_sigma2, valid, stereo,
        n_rounds=n_rounds, iters_per_round=iters_per_round,
    )
    chi2_th = jnp.where(stereo, robust.CHI2_STEREO, robust.CHI2_MONO)
    inliers = valid & (c2 <= chi2_th)
    return PoseOptResult(
        Tcw=T, inliers=inliers,
        num_inliers=jnp.sum(inliers.astype(jnp.int32)), chi2=c2,
    )
