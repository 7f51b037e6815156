"""FAST-16 corner detection + grid-distributed keypoint selection.

Replaces the reference's per-cell FAST with threshold fallback + quadtree
spatial distribution (ORBExtractor::ComputeKeyPointsOctTree / DistributeOctTree,
src/features/ORBExtractor.cpp:179-495) with a fully batched formulation:

- corner scores for EVERY pixel in one vectorized pass (16 rolled images,
  run-length test via packed bit shifts — elementwise, no data-dependent
  control flow),
- 3x3 non-max suppression,
- per-grid-cell top-k + global top-N = the spatial spreading the quadtree
  exists to provide (SURVEY.md §7.1: behaviorally equivalent spreading).

The low-threshold pass is always computed (score at min threshold), so the
reference's "retry cell at lower threshold" fallback is subsumed: cells with
only weak corners still surface their best ones through the per-cell quota.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# Bresenham circle radius 3 (dy, dx), standard FAST-16 order (clockwise)
CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LEN = 9  # contiguous run length for FAST-9/16


def fast_scores(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Per-pixel FAST-9/16 corner score [H, W] f32 (0 = not a corner).

    Score = max(total bright excess, total dark excess) over the 16 circle
    pixels, gated by the 9-contiguous-run cornerness test (the OpenCV
    simplified score used for NMS ranking).
    """
    c = img
    brights = []
    darks = []
    excess_b = jnp.zeros_like(img)
    excess_d = jnp.zeros_like(img)
    for dy, dx in CIRCLE:
        p = jnp.roll(img, (-int(dy), -int(dx)), axis=(0, 1))
        db = p - c - threshold
        dd = c - p - threshold
        brights.append(db > 0)
        darks.append(dd > 0)
        excess_b = excess_b + jnp.maximum(db, 0.0)
        excess_d = excess_d + jnp.maximum(dd, 0.0)

    def has_run(flags):
        # pack 16 flags into uint32 bits, duplicate for circular runs, then
        # AND-shift ARC_LEN-1 times: nonzero iff some 9-run is all set.
        # uint32 is essential: int32 >> would arithmetic-shift sign bits in.
        m = jnp.zeros(img.shape, jnp.uint32)
        for i, f in enumerate(flags):
            m = m | (f.astype(jnp.uint32) << jnp.uint32(i))
        x = m | (m << jnp.uint32(16))
        y = x
        for i in range(1, ARC_LEN):
            y = y & (x >> jnp.uint32(i))
        return y != 0

    corner_b = has_run(brights)
    corner_d = has_run(darks)
    score = jnp.maximum(
        jnp.where(corner_b, excess_b, 0.0), jnp.where(corner_d, excess_d, 0.0)
    )
    # kill the rolled-around border (radius 3)
    h, w = img.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    interior = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return jnp.where(interior, score, 0.0)


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """Keep strict local maxima over 3x3 neighborhoods."""
    m = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where(score >= m, score, 0.0)


@partial(jax.jit, static_argnames=("n_keypoints", "cell", "border"))
def select_keypoints(
    score: jnp.ndarray,
    n_keypoints: int,
    cell: int = 32,
    border: int = 16,
):
    """Grid-distributed top-N selection from a score map.

    Returns (uv [N, 2] f32 (x, y), kp_score [N], valid [N]). Spatial
    spreading: per-cell quota via top-k inside each `cell`x`cell` tile, then
    global top-N over the pooled candidates (quadtree-equivalent).
    """
    h, w = score.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    ok = (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    s = jnp.where(ok, score, 0.0)

    ncy = (h + cell - 1) // cell
    ncx = (w + cell - 1) // cell
    ph, pw = ncy * cell, ncx * cell
    sp = jnp.pad(s, ((0, ph - h), (0, pw - w)))
    tiles = sp.reshape(ncy, cell, ncx, cell).transpose(0, 2, 1, 3).reshape(
        ncy * ncx, cell * cell
    )
    quota = max(1, min(cell * cell, -(-n_keypoints // (ncy * ncx)) + 2))
    top_s, top_i = jax.lax.top_k(tiles, quota)          # [C, q]
    # convert flat in-tile index -> global pixel coords
    cidx = jnp.arange(ncy * ncx)
    cy = (cidx // ncx) * cell
    cx = (cidx % ncx) * cell
    py = cy[:, None] + top_i // cell
    px = cx[:, None] + top_i % cell

    pool_s = top_s.reshape(-1)
    pool_y = py.reshape(-1)
    pool_x = px.reshape(-1)
    n_take = min(n_keypoints, pool_s.shape[0])
    best_s, best_i = jax.lax.top_k(pool_s, n_take)
    uv = jnp.stack(
        [pool_x[best_i].astype(jnp.float32), pool_y[best_i].astype(jnp.float32)],
        axis=-1,
    )
    valid = best_s > 0
    if n_take < n_keypoints:
        pad = n_keypoints - n_take
        uv = jnp.pad(uv, ((0, pad), (0, 0)))
        best_s = jnp.pad(best_s, (0, pad))
        valid = jnp.pad(valid, (0, pad))
    return uv, best_s, valid
