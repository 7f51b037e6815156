"""Multi-camera data-parallel front-end: shard the camera/frame batch axis
of feature extraction across a device mesh.

The reference parallelizes extraction inside a stage with threads — two
threads for the stereo pair (ImageProcessing.cpp:82-84) and per-camera
extractor trios (ImageProcessing.cpp:28-37). The array-native equivalent
(SURVEY.md §2.10) is the batch axis: a camera rig's frames stack into
[C, H, W] and the batch axis shards over the mesh, so every chip extracts
its cameras' images concurrently. XLA partitions the vmapped extraction
program along the sharded axis with no collectives (the work is
embarrassingly parallel until matching).

The same entry also serves frame-batched offline mapping (SfM mode): a
sequence chunk of C frames extracts in one sharded program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hyslam_tpu.core.frame import FrameFeatures
from hyslam_tpu.features.atlas import extract_atlas_batch
from hyslam_tpu.features.extractor import ExtractorConfig


def extract_cameras_sharded(
    imgs: jnp.ndarray,
    cfg: ExtractorConfig,
    capacity: int,
    mesh: Mesh,
    axis: str = "lm",
) -> FrameFeatures:
    """Extract features from [C, H, W] images with the camera axis sharded
    over `mesh[axis]`. C must be divisible by the axis size. Returns
    FrameFeatures with a leading [C] axis, sharded the same way (downstream
    per-camera tracking consumes its local shard without a gather)."""
    n = mesh.shape[axis]
    C = imgs.shape[0]
    if C % n != 0:
        raise ValueError(f"camera batch {C} not divisible by mesh axis {n}")
    sharding = NamedSharding(mesh, P(axis, None, None))
    imgs = jax.device_put(imgs, sharding)
    return extract_atlas_batch(imgs, cfg, capacity=capacity)
