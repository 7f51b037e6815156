"""Map sparsification: cull successive keyframes that are near-duplicates.

Replaces GenUtils::sparsifyMap (src/util/GenUtils.cpp:135-166, invoked by
System::RunImagingBundleAdjustment, src/main/System.cc:262-263 with
criterion 0.98): walking keyframes in id order, a keyframe is culled when
more than `overlap_criterion` of the previous kept keyframe's associated
landmarks are visible (frustum-project) in it.

array-native split: the expensive part — "which of KF i's landmarks are
visible in KF j" for ALL pairs — is one batched [K,L] projection plus one
matmul of the association incidence against the visibility matrix; the
greedy keep/cull walk (inherently sequential, O(K) scalar ops) runs on host.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from hyslam_tpu.core import mapstate as M
from hyslam_tpu.core.mapstate import MapState
from hyslam_tpu.geometry import se3
from hyslam_tpu.geometry.camera import Camera, in_image, project


@partial(jax.jit, static_argnames=("cam",))
def keyframe_overlap_fractions(ms: MapState, cam: Camera) -> jnp.ndarray:
    """[K, K] frac[i, j] = fraction of KF i's associated landmarks that are
    visible in KF j (KeyFrame::isLandMarkVisible = projects in front of the
    camera into image bounds)."""
    lm_ok = ms.lm.valid & ~ms.lm.bad
    Xc = jax.vmap(lambda T: se3.apply(T, ms.lm.pos))(ms.kf.Tcw)   # [K, L, 3]
    uv, z = project(cam, Xc)
    vis = in_image(cam, uv) & (z > 0.2) & lm_ok[None, :]          # [K, L]
    I = M.incidence_matrix(ms) & lm_ok[None, :]                   # [K, L]
    counts = jax.lax.dot_general(
        I.astype(jnp.bfloat16), vis.astype(jnp.bfloat16),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )                                                             # [K, K]
    denom = jnp.maximum(jnp.sum(I, axis=-1).astype(jnp.float32), 1.0)
    return counts / denom[:, None]


def sparsify_map(ms: MapState, cam: Camera,
                 overlap_criterion: float = 0.98) -> tuple[MapState, int]:
    """Greedy successive-keyframe culling (GenUtils::sparsifyMap): walk
    keyframes in id order; cull the next keyframe while > overlap_criterion
    of the current kept keyframe's landmarks are visible in it. Origin
    keyframes are never culled (set_keyframes_bad enforces this — the
    reference walks them too but SetBadKeyFrame refuses origins).
    Returns (ms, n_culled)."""
    kf_ok = np.asarray(ms.kf.valid & ~ms.kf.bad)
    ids = np.nonzero(kf_ok)[0]
    if len(ids) < 2:
        return ms, 0
    frac = np.asarray(keyframe_overlap_fractions(ms, cam))
    origin = np.asarray(ms.kf.origin)
    cull = np.zeros(ms.K, bool)
    cur = ids[0]
    for tgt in ids[1:]:
        if frac[cur, tgt] > overlap_criterion and not origin[tgt]:
            cull[tgt] = True
        else:
            cur = tgt
    n = int(cull.sum())
    if n == 0:
        return ms, 0
    ms = M.set_keyframes_bad(ms, jnp.asarray(cull))
    ms = M.refresh_covisibility(ms)
    return ms, n
