"""PnP-RANSAC: absolute pose from 3D-2D correspondences.

Replaces src/estimators/PnPsolver.{h,cc} (EPnP inside RANSAC, used by
relocalization, TrackPlaceRecognition.cpp). array-native formulation: all
RANSAC hypotheses evaluate as ONE batched tensor program — minimal sets of
6 points solved by normalized DLT (batched 12x12 eigh) with orthonormality
projection and cheirality disambiguation, scored by chi2 reprojection.

EPnP's control-point parameterization exists to stabilize small CPU
solves; inside a 256-hypothesis batch followed by the standard pose-only
LM refinement (solver.pose_opt) the simpler DLT hypothesis generator
reaches the same final accuracy — the refinement, inlier gating (chi2
5.991 sigma^2), and iteration protocol mirror the reference.
"""

from __future__ import annotations

from functools import partial

from hyslam_tpu.utils.precision import f32 as _f32

import jax
import jax.numpy as jnp

from hyslam_tpu.geometry import se3
from hyslam_tpu.geometry.camera import Camera
from hyslam_tpu.solver.pose_opt import pose_optimization

N_HYPOTHESES = 256
MIN_SET = 6
CHI2_PNP = 5.991


def _dlt_pose(Xs, xs):
    """One minimal set: Xs [m,3] world, xs [m,2] NORMALIZED image coords.
    Returns Tcw [4,4] (possibly reflected/ill-conditioned; caller scores)."""
    m = Xs.shape[0]
    zeros = jnp.zeros((m, 4))
    Xh = jnp.concatenate([Xs, jnp.ones((m, 1))], -1)
    r1 = jnp.concatenate([Xh, zeros, -xs[:, 0:1] * Xh], -1)
    r2 = jnp.concatenate([zeros, Xh, -xs[:, 1:2] * Xh], -1)
    A = jnp.concatenate([r1, r2], 0)                       # [2m, 12]
    _, vecs = jnp.linalg.eigh(A.T @ A)
    p = vecs[:, 0].reshape(3, 4)
    R_raw = p[:, :3]
    u, s, vt = jnp.linalg.svd(R_raw)
    det = jnp.linalg.det(u @ vt)
    scale = jnp.mean(s) * det
    R = (u * jnp.asarray([1.0, 1.0, det])[None, :]) @ vt
    t = p[:, 3] / jnp.where(jnp.abs(scale) < 1e-12, 1e-12, scale)
    return se3.from_Rt(R, t)


@_f32
@partial(jax.jit, static_argnames=("cam",))
def pnp_ransac(
    cam: Camera,
    X: jnp.ndarray,          # [N, 3] world points
    uv: jnp.ndarray,         # [N, 2] pixels
    inv_sigma2: jnp.ndarray, # [N]
    valid: jnp.ndarray,      # [N]
    key,
):
    """Returns (Tcw [4,4], inliers [N], n_inliers). Refine with
    pose_optimization afterwards (the reference's staged protocol)."""
    N = X.shape[0]
    Kinv = jnp.linalg.inv(cam.K())
    xh = jnp.concatenate([uv, jnp.ones((N, 1))], -1) @ Kinv.T
    xn = xh[:, :2] / xh[:, 2:3]

    # sample minimal sets FROM THE VALID ROWS ONLY (uniform over all padded
    # slots makes a clean 6-point set exponentially unlikely at realistic
    # valid fractions — the round-3 relocalization flakiness)
    logits = jnp.where(valid, 0.0, -jnp.inf)
    idx = jax.random.categorical(
        key, jnp.broadcast_to(logits, (N_HYPOTHESES * MIN_SET, N)), axis=-1
    ).reshape(N_HYPOTHESES, MIN_SET)
    idx = jnp.where(jnp.any(valid), idx, 0)
    Ts = jax.vmap(lambda i: _dlt_pose(X[i], xn[i]))(idx)    # [S,4,4]

    def score(T):
        pc = se3.apply(T, X)
        z = pc[:, 2]
        zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        u = cam.fx * pc[:, 0] / zs + cam.cx
        v = cam.fy * pc[:, 1] / zs + cam.cy
        c2 = inv_sigma2 * ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2)
        ok = valid & (z > 0.05) & (c2 < CHI2_PNP)
        return jnp.sum(ok.astype(jnp.int32)), ok

    counts, inls = jax.vmap(score)(Ts)
    best = jnp.argmax(counts)
    return Ts[best], inls[best], counts[best]


def pnp_ransac_refined(cam, X, uv, inv_sigma2, valid, key, min_inliers=10):
    """RANSAC + pose-only LM refinement on the inlier set (PnPsolver::
    iterate followed by PoseOptimization, TrackPlaceRecognition.cpp)."""
    T0, inl, n = pnp_ransac(cam, X, uv, inv_sigma2, valid, key)
    res = pose_optimization(
        cam, T0, X, uv, jnp.full(X.shape[:1], -1.0), inv_sigma2,
        inl, jnp.zeros(X.shape[:1], bool),
    )
    return res.Tcw, res.inliers, res.num_inliers
