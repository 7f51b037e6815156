"""Rectified stereo feature matching.

Replaces Stereomatcher (src/features/Stereomatcher.{h,cpp}): the row-bucket
LUT + per-keypoint candidate loop becomes one dense masked Hamming matrix
as a matmul (left features x right features), with row-band, disparity-range,
level-compatibility and distance-threshold gates, followed by a left->right
argmin. Fills ur/depth like the reference fills mvuRight/mvDepth.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from hyslam_tpu.core.frame import FrameFeatures
from hyslam_tpu.ops.hamming import hamming_matrix

TH_HIGH = 100  # descriptor distance gate (FeatureMatcher TH_HIGH analog)


@partial(jax.jit, static_argnames=("bf", "min_z", "max_disp_slack"))
def match_stereo(
    left: FrameFeatures,
    right: FrameFeatures,
    bf: float,
    min_z: float = 0.1,
    max_disp_slack: float = 2.0,
) -> FrameFeatures:
    """Returns `left` with ur/depth filled for matched features.

    Gates per candidate pair (l, r):
    - |v_l - v_r| <= 2 * scale(level_l)  (rectified row band, reference uses
      a per-level row window)
    - 0.3 <= disparity <= bf/min_z
    - |level_l - level_r| <= 1
    - Hamming distance <= TH_HIGH, and the best over candidates.
    """
    d = hamming_matrix(left.desc, right.desc)              # [FL, FR]
    scale_l = 1.2 ** left.level.astype(jnp.float32)
    row_tol = max_disp_slack * scale_l[:, None]
    dv = jnp.abs(left.uv[:, 1:2] - right.uv[None, :, 1])
    disp = left.uv[:, 0:1] - right.uv[None, :, 0]
    max_disp = bf / min_z
    lvl_ok = jnp.abs(left.level[:, None] - right.level[None, :]) <= 1
    ok = (
        (dv <= row_tol)
        & (disp >= 0.3)
        & (disp <= max_disp)
        & lvl_ok
        & left.valid[:, None]
        & right.valid[None, :]
    )
    d = jnp.where(ok, d, 1 << 16)
    best = jnp.argmin(d, axis=1)
    best_d = jnp.take_along_axis(d, best[:, None], axis=1)[:, 0]
    matched = best_d <= TH_HIGH
    ur = jnp.where(matched, right.uv[best, 0], -1.0)
    disp_best = jnp.maximum(left.uv[:, 0] - ur, 1e-3)
    depth = jnp.where(matched, bf / disp_best, -1.0)
    return left._replace(ur=jnp.where(matched, ur, -1.0), depth=depth)


_SAD_R = 5      # 11x11 correlation window (reference W=5)
_SEARCH = 4     # +/- shift range around the descriptor match (reference L=5)


@partial(jax.jit, static_argnames=("bf",))
def refine_subpixel(
    matched: FrameFeatures,
    img_l: jnp.ndarray,
    img_r: jnp.ndarray,
    bf: float,
) -> FrameFeatures:
    """Sub-pixel disparity refinement by SAD correlation + parabola fit
    (the reference's ComputeStereoMatches sliding-window stage,
    Stereomatcher.cpp / ORB-SLAM2 lineage): integer-pixel keypoint disparity
    alone gives O(25%) depth error at far range; the parabola on the SAD
    trough recovers ~0.1 px.
    """
    uv = matched.uv
    ur0 = matched.ur
    ok = matched.valid & (ur0 > 0)
    x0 = jnp.round(uv[:, 0]).astype(jnp.int32)
    y0 = jnp.round(uv[:, 1]).astype(jnp.int32)
    xr0 = jnp.round(ur0).astype(jnp.int32)

    h, W_ = img_l.shape
    side = 2 * _SAD_R + 1                                # 11
    wide = side + 2 * _SEARCH                            # 19: all 9 shifts

    # per-keypoint windows via vmapped dynamic_slice; pad by the window
    # radius so starts never clamp the window off-center
    pad_y, pad_xl, pad_xr = _SAD_R, _SAD_R, _SAD_R + _SEARCH
    il_p = jnp.pad(img_l, ((pad_y, pad_y), (pad_xl, pad_xl)), mode="edge")
    ir_p = jnp.pad(img_r, ((pad_y, pad_y), (pad_xr, pad_xr)), mode="edge")

    def cut_l(y, x):                                     # centered at (y,x)
        return jax.lax.dynamic_slice(il_p, (y, x), (side, side))

    def cut_r(y, x):                                     # x = xr0 start
        return jax.lax.dynamic_slice(ir_p, (y, x), (side, wide))

    yc = jnp.clip(y0, 0, h - 1)
    patch_l = jax.vmap(cut_l)(yc, jnp.clip(x0, 0, W_ - 1))     # [N,11,11]
    win_r = jax.vmap(cut_r)(yc, jnp.clip(xr0, 0, W_ - 1))      # [N,11,wide]
    # normalize by center intensity like the reference (IL - IL(center))
    patch_l = patch_l - patch_l[:, _SAD_R : _SAD_R + 1, _SAD_R : _SAD_R + 1]

    n_sh = 2 * _SEARCH + 1
    # shift s covers columns [s : s+11] of the right window
    patch_r = jnp.stack(
        [win_r[:, :, s : s + side] for s in range(n_sh)], axis=1
    )                                                    # [N,9,11,11]
    patch_r = patch_r - patch_r[:, :, _SAD_R : _SAD_R + 1, _SAD_R : _SAD_R + 1]

    sad = jnp.sum(jnp.abs(patch_r - patch_l[:, None]), axis=(-1, -2))  # [N, 9]
    bi = jnp.argmin(sad, axis=-1)
    bic = jnp.clip(bi, 1, sad.shape[1] - 2)
    c0 = jnp.take_along_axis(sad, bic[:, None] - 1, axis=1)[:, 0]
    c1 = jnp.take_along_axis(sad, bic[:, None], axis=1)[:, 0]
    c2 = jnp.take_along_axis(sad, bic[:, None] + 1, axis=1)[:, 0]
    denom = jnp.maximum(c0 + c2 - 2.0 * c1, 1e-6)
    delta = jnp.clip(0.5 * (c0 - c2) / denom, -1.0, 1.0)
    ur_ref = xr0.astype(jnp.float32) + (bic - _SEARCH).astype(jnp.float32) + delta
    # keep fractional part of the left keypoint column as well
    ur_ref = ur_ref + (uv[:, 0] - x0.astype(jnp.float32))
    disp = jnp.clip(uv[:, 0] - ur_ref, 1e-3, None)
    good = ok & (disp > 0.2)
    depth = jnp.where(good, bf / disp, -1.0)
    return matched._replace(
        ur=jnp.where(good, ur_ref, -1.0), depth=depth
    )


def match_stereo_refined(left, right, img_l, img_r, bf, min_z=0.1):
    """Descriptor matching + SAD sub-pixel refinement (the full reference
    stereo path)."""
    m = match_stereo(left, right, bf=bf, min_z=min_z)
    return refine_subpixel(m, img_l, img_r, bf=bf)
