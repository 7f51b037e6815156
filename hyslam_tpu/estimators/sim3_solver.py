"""Sim3 RANSAC between two keyframes' matched landmarks.

Replaces src/estimators/Sim3Solver.{h,cc}: 3-point minimal Horn closed-form
hypotheses inside RANSAC, scored by reprojection chi2 in BOTH images
(th 9.21 * sigma2 per the reference), optional fixed scale for stereo.
All hypotheses evaluate as one batch.
"""

from __future__ import annotations

from functools import partial

from hyslam_tpu.utils.precision import f32 as _f32

import jax
import jax.numpy as jnp

from hyslam_tpu.geometry import se3, sim3
from hyslam_tpu.geometry.camera import Camera
from hyslam_tpu.geometry.horn import horn_sim3

N_HYPOTHESES = 128
CHI2_SIM3 = 9.21  # 99% 2-dof (Sim3Solver's mvnMaxError base)


@_f32
@partial(jax.jit, static_argnames=("cam1", "cam2", "fix_scale"))
def sim3_ransac(
    cam1: Camera,
    cam2: Camera,
    X1: jnp.ndarray,        # [N, 3] matched landmarks in cam-1 coords
    X2: jnp.ndarray,        # [N, 3] same landmarks in cam-2 coords
    uv1: jnp.ndarray,       # [N, 2] observed pixels in image 1
    uv2: jnp.ndarray,       # [N, 2]
    inv_sigma2_1: jnp.ndarray,
    inv_sigma2_2: jnp.ndarray,
    valid: jnp.ndarray,     # [N]
    key,
    fix_scale: bool = False,
):
    """Returns (g12 packed Sim3 mapping cam2-coords -> cam1-coords, inliers
    [N], n_inliers). Convention matches Sim3Solver: estimates S12 such that
    X1 ~ S12 * X2."""
    N = X1.shape[0]
    # sample 3-point sets FROM THE VALID PAIRS ONLY — uniform sampling over
    # all padded slots makes a clean triple exponentially unlikely at
    # realistic match fractions ((30 valid / 512 slots)^3 * 128 hypotheses
    # ~= 0.03 valid triples: loop-closure Sim3 RANSAC found 0 inliers on
    # an earlier long run while the reference's Sim3Solver samples from its
    # match list, Sim3Solver.h:33-55). Same fix as estimators/pnp.py.
    logits = jnp.where(valid, 0.0, -jnp.inf)
    idx = jax.random.categorical(
        key, jnp.broadcast_to(logits, (N_HYPOTHESES * 3, N)), axis=-1
    ).reshape(N_HYPOTHESES, 3)
    idx = jnp.where(jnp.any(valid), idx, 0)

    def one(i3):
        return horn_sim3(X2[i3], X1[i3], fix_scale=fix_scale)

    gs = jax.vmap(one)(idx)                                # [S, 8]

    def project(cam, pc):
        z = jnp.maximum(pc[..., 2], 1e-6)
        return jnp.stack(
            [cam.fx * pc[..., 0] / z + cam.cx, cam.fy * pc[..., 1] / z + cam.cy],
            axis=-1,
        )

    def score(g):
        # project X2 through S12 into image 1 and X1 through S21 into image 2
        p1 = project(cam1, sim3.apply(g, X2))
        p2 = project(cam2, sim3.apply(sim3.inverse(g), X1))
        e1 = jnp.sum((p1 - uv1) ** 2, -1) * inv_sigma2_1
        e2 = jnp.sum((p2 - uv2) ** 2, -1) * inv_sigma2_2
        ok = valid & (e1 < CHI2_SIM3) & (e2 < CHI2_SIM3)
        return jnp.sum(ok.astype(jnp.int32)), ok

    counts, inls = jax.vmap(score)(gs)
    best = jnp.argmax(counts)
    g_best = gs[best]
    inl = inls[best]
    # refit on inliers for the final estimate
    w = inl.astype(jnp.float32)
    g_ref = horn_sim3(X2, X1, weights=w, fix_scale=fix_scale)
    n_ref, inl_ref = score(g_ref)
    better = n_ref >= counts[best]
    g_out = jnp.where(better, g_ref, g_best)
    inl_out = jnp.where(better, inl_ref, inl)
    return g_out, inl_out, jnp.maximum(n_ref, counts[best])
