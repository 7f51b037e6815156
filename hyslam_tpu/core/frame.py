"""Per-image feature containers: the array-native Frame.

Replaces src/core/Frame.{h,cc} + FeatureViews + LandMarkMatches: an SoA
bundle of fixed-capacity padded feature arrays plus pose and per-feature
landmark associations / outlier flags.

The reference's 64x48 keypoint grid for windowed candidate lookup
(Frame.h:69-70,184-188) is deliberately NOT replicated: windowed matching
is a dense masked distance matrix (all landmarks x all features) computed
as one matmul instead of gather-heavy grid indexing (SURVEY.md §7.1
matching design).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


# Pyramid scale model mirrored from the reference's extractor settings
# (FeatureExtractorSettings.h: scale factor 1.2, 8 levels, sigma^2 = scale^2L).
DEFAULT_SCALE_FACTOR = 1.2
DEFAULT_N_LEVELS = 8


def level_scales(n_levels=DEFAULT_N_LEVELS, scale=DEFAULT_SCALE_FACTOR):
    return jnp.asarray(scale ** np.arange(n_levels), jnp.float32)


def level_sigma2(n_levels=DEFAULT_N_LEVELS, scale=DEFAULT_SCALE_FACTOR):
    s = np.asarray(scale ** np.arange(n_levels), np.float32)
    return jnp.asarray(s * s)


def level_inv_sigma2(n_levels=DEFAULT_N_LEVELS, scale=DEFAULT_SCALE_FACTOR):
    return 1.0 / level_sigma2(n_levels, scale)


def feature_inv_sigma2(level, n_levels=DEFAULT_N_LEVELS,
                       scale=DEFAULT_SCALE_FACTOR):
    """Per-feature information weight from pyramid level [..] -> [..].
    Clips to the configured level count so SURF-style families (1.4 factor)
    or deeper pyramids get correct weights (ADVICE r2)."""
    return level_inv_sigma2(n_levels, scale)[jnp.clip(level, 0, n_levels - 1)]


class FrameFeatures(NamedTuple):
    """Extracted features of one image, padded to capacity F.

    uv:     [F, 2] pixel coords (level-0 / full-res frame)
    ur:     [F]    right-image u for stereo matches, -1 where absent
    depth:  [F]    stereo depth, -1 where absent
    level:  [F]    pyramid level (int32)
    angle:  [F]    orientation (radians)
    desc:   [F, 8] packed 256-bit binary descriptor (uint32 lanes)
    valid:  [F]    real feature mask
    """

    uv: jnp.ndarray
    ur: jnp.ndarray
    depth: jnp.ndarray
    level: jnp.ndarray
    angle: jnp.ndarray
    desc: jnp.ndarray
    valid: jnp.ndarray

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]


def empty_features(F: int) -> FrameFeatures:
    return FrameFeatures(
        uv=jnp.zeros((F, 2), jnp.float32),
        ur=jnp.full((F,), -1.0, jnp.float32),
        depth=jnp.full((F,), -1.0, jnp.float32),
        level=jnp.zeros((F,), jnp.int32),
        angle=jnp.zeros((F,), jnp.float32),
        desc=jnp.zeros((F, 8), jnp.uint32),
        valid=jnp.zeros((F,), bool),
    )


class Frame(NamedTuple):
    """A frame in the tracking pipeline: features + pose + associations.

    lm_id:    [F] landmark index (-1 = unmatched)  — LandMarkMatches analog
    outlier:  [F] pose-opt outlier flag
    tracked:  [F] consecutive-frame tracking counts (propagateTracking analog)
    """

    features: FrameFeatures
    Tcw: jnp.ndarray
    timestamp: jnp.ndarray
    frame_id: jnp.ndarray
    lm_id: jnp.ndarray
    outlier: jnp.ndarray
    tracked: jnp.ndarray

    @property
    def n_matches(self):
        return jnp.sum((self.lm_id >= 0) & ~self.outlier)


def make_frame(features: FrameFeatures, Tcw, timestamp, frame_id) -> Frame:
    F = features.capacity
    return Frame(
        features=features,
        Tcw=jnp.asarray(Tcw, jnp.float32),
        timestamp=jnp.asarray(timestamp, jnp.float32),
        frame_id=jnp.asarray(frame_id, jnp.int32),
        lm_id=jnp.full((F,), -1, jnp.int32),
        outlier=jnp.zeros((F,), bool),
        tracked=jnp.zeros((F,), jnp.int32),
    )
