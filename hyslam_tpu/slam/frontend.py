"""Fused per-frame front-end entry points.

The per-frame hot path (SURVEY.md §3.2: SearchByProjection ->
PoseOptimization, TrackMotionModel.cpp:14-83 / TrackLocalMap.cpp:9-184)
crosses several library calls; running the glue between them eagerly costs
one device dispatch per op. These entry points fuse match + association
gather + pose-only LM into ONE compiled program with every device array
passed as an argument, which is how the bench and the pipeline front-end
call them.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from hyslam_tpu.core.frame import feature_inv_sigma2
from hyslam_tpu.features.atlas import extract_atlas_batch
from hyslam_tpu.features.extractor import ExtractorConfig
from hyslam_tpu.features.matcher import search_by_projection_landmarks
from hyslam_tpu.geometry.camera import Camera
from hyslam_tpu.ops.stereo import match_stereo_refined
from hyslam_tpu.solver.pose_opt import pose_optimization_fast


class FrontendResult(NamedTuple):
    Tcw: jnp.ndarray          # [4,4] optimized pose
    lm_id: jnp.ndarray        # [F] landmark row per feature (-1 = none),
                              # outliers pruned
    n_matches: jnp.ndarray    # matches found by projection search
    n_inliers: jnp.ndarray    # inliers after pose optimization


@partial(jax.jit, static_argnames=("cam", "th", "ratio"))
def project_and_optimize(
    cam: Camera,
    feats,
    Tcw0: jnp.ndarray,
    lm_pos: jnp.ndarray,       # [L,3] landmark positions
    lm_normal: jnp.ndarray,    # [L,3] viewing normals
    lm_desc: jnp.ndarray,      # [L,8] u32 descriptors
    lm_max_dist: jnp.ndarray,  # [L] scale-invariance distance bounds
    lm_min_dist: jnp.ndarray,
    lm_valid: jnp.ndarray,     # [L]
    inv_sigma2: jnp.ndarray,   # [F] per-feature information
    th: float = 3.0,
    ratio: float = 0.8,
    n_levels: int = 8,
    scale_factor: float = 1.2,
) -> FrontendResult:
    """Projection-match the landmark table against the frame, then optimize
    the frame pose on the matched set: the TrackLocalMap hot pair
    (FeatureMatcher.cc:123 + Optimizer.cc:48) as one device program."""
    F = feats.uv.shape[0]
    L = lm_pos.shape[0]
    res = search_by_projection_landmarks(
        cam, feats, Tcw0, lm_pos, lm_normal, lm_desc, lm_max_dist,
        lm_min_dist, lm_valid, jnp.zeros((F,), bool), th=th, ratio=ratio,
        n_levels=n_levels, scale_factor=scale_factor,
    )
    lm_id = res.lm_for_feature
    X = lm_pos[jnp.clip(lm_id, 0, L - 1)]
    has = lm_id >= 0
    opt = pose_optimization_fast(
        cam, Tcw0, X, feats.uv, feats.ur, inv_sigma2, has,
        has & (feats.ur > 0),
    )
    return FrontendResult(
        Tcw=opt.Tcw,
        lm_id=jnp.where(opt.inliers, lm_id, -1),
        n_matches=res.n_matches,
        n_inliers=opt.num_inliers,
    )


@partial(jax.jit, static_argnames=("cam", "cfg", "capacity", "th", "ratio"))
def track_stereo_frame(
    cam: Camera,
    cfg: ExtractorConfig,
    capacity: int,
    pair: jnp.ndarray,         # [2,H,W] grayscale stereo pair
    Tcw0: jnp.ndarray,         # [4,4] pose prediction
    lm_pos: jnp.ndarray,       # [L,3] local-map landmark positions
    lm_normal: jnp.ndarray,    # [L,3] viewing normals
    lm_desc: jnp.ndarray,      # [L,8] u32 descriptors
    lm_max_dist: jnp.ndarray,  # [L] scale-invariance bounds
    lm_min_dist: jnp.ndarray,
    lm_valid: jnp.ndarray,     # [L]
    th: float = 3.0,
    ratio: float = 0.8,
):
    """The ENTIRE per-frame stereo front-end as ONE device program:
    batched ORB extraction of both images (ImageProcessing::
    ProcessStereoImage, two extractor threads at ImageProcessing.cpp:82-84)
    -> stereo match + sub-pixel refinement (Stereomatcher.cpp:36) ->
    local-map projection matching (FeatureMatcher.cc:123) -> pose-only LM
    (Optimizer.cc:48).

    One dispatch per frame instead of two. Returns (FrontendResult,
    matched left features).
    """
    feats2 = extract_atlas_batch(pair, cfg, capacity=capacity)
    fl = jax.tree.map(lambda x: x[0], feats2)
    fr = jax.tree.map(lambda x: x[1], feats2)
    fl = match_stereo_refined(fl, fr, pair[0], pair[1], bf=cam.bf)
    inv_s2 = feature_inv_sigma2(fl.level, cfg.n_levels, cfg.scale_factor)
    res = project_and_optimize(
        cam, fl, Tcw0, lm_pos, lm_normal, lm_desc, lm_max_dist, lm_min_dist,
        lm_valid, inv_s2, th=th, ratio=ratio,
        n_levels=cfg.n_levels, scale_factor=cfg.scale_factor,
    )
    return res, fl
