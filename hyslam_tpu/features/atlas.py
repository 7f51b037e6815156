"""Atlas extractor: the full ORB pipeline with pyramid levels packed into
ONE canvas.

The per-level extractor (features/extractor.py) runs the FAST/NMS/blur/
orientation/descriptor chain once per level (x2 images for stereo) —
hundreds of device kernels per frame, so launch latency bounds it. Here
the 8 pyramid levels are placed side by side in
a single [H0, sum(Wl)] canvas (zero-padded below each level), so every
dense stage runs ONCE; only the per-level grid top-k selection (a handful
of reshapes + top_k each) iterates. Keypoint metadata (level id, canvas
offset, scale-back factors) is precomputed as numpy constants.

The result is bit-compatible in structure with features/extractor.extract
(same FrameFeatures contract: uv in level-0 coordinates, packed u32
descriptors) and behaviorally equivalent: same FAST scores, same spatial
spreading, same steered BRIEF pattern — seams and out-of-level regions are
masked off.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from hyslam_tpu.core.frame import FrameFeatures
from hyslam_tpu.features.extractor import ExtractorConfig, level_budgets
from hyslam_tpu.ops.fast import fast_scores, nms3x3
from hyslam_tpu.ops.orb import orient_and_describe
from hyslam_tpu.ops.pyramid import pyramid_shapes


class AtlasLayout(NamedTuple):
    shapes: tuple            # ((Hl, Wl), ...)
    x_off: tuple             # canvas x offset per level
    canvas_hw: tuple         # (H0, Wc)


def atlas_layout(h: int, w: int, cfg: ExtractorConfig) -> AtlasLayout:
    shapes = tuple(pyramid_shapes(h, w, cfg.n_levels, cfg.scale_factor))
    x_off = []
    x = 0
    for (hl, wl) in shapes:
        x_off.append(x)
        x += wl
    return AtlasLayout(shapes=shapes, x_off=tuple(x_off), canvas_hw=(h, x))


def _build_canvas(img: jnp.ndarray, layout: AtlasLayout, cfg: ExtractorConfig):
    """[H, W] -> [H0, Wc] canvas with all levels placed left to right."""
    H0, Wc = layout.canvas_hw
    parts = []
    cur = img
    for lv, (hl, wl) in enumerate(layout.shapes):
        if lv > 0:
            cur = jax.image.resize(cur, (hl, wl), method="bilinear")
        parts.append(jnp.pad(cur, ((0, H0 - hl), (0, 0))))
    return jnp.concatenate(parts, axis=1)


def _select_level(
    score_slice: jnp.ndarray, hl: int, wl: int, n_kp: int, cell: int,
    border: int,
):
    """Grid top-k inside one level region of the canvas score map
    ([H0, wl] slice; rows >= hl are zero)."""
    H0 = score_slice.shape[0]
    yy = jax.lax.broadcasted_iota(jnp.int32, (H0, wl), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H0, wl), 1)
    ok = (yy >= border) & (yy < hl - border) & (xx >= border) & (xx < wl - border)
    s = jnp.where(ok, score_slice, 0.0)
    ncy = (hl + cell - 1) // cell
    ncx = (wl + cell - 1) // cell
    ph, pw = ncy * cell, ncx * cell
    sp = jnp.pad(s[:min(H0, ph)], ((0, max(0, ph - H0)), (0, pw - wl)))
    sp = sp[:ph]
    tiles = sp.reshape(ncy, cell, ncx, cell).transpose(0, 2, 1, 3).reshape(
        ncy * ncx, cell * cell
    )
    quota = max(1, min(cell * cell, -(-n_kp // (ncy * ncx)) + 2))
    top_s, top_i = jax.lax.top_k(tiles, quota)
    cidx = jnp.arange(ncy * ncx)
    py = (cidx // ncx)[:, None] * cell + top_i // cell
    px = (cidx % ncx)[:, None] * cell + top_i % cell
    pool_s = top_s.reshape(-1)
    n_take = min(n_kp, pool_s.shape[0])
    best_s, best_i = jax.lax.top_k(pool_s, n_take)
    uv = jnp.stack(
        [px.reshape(-1)[best_i].astype(jnp.float32),
         py.reshape(-1)[best_i].astype(jnp.float32)], -1,
    )
    valid = best_s > 0
    pad = n_kp - n_take
    if pad > 0:
        uv = jnp.pad(uv, ((0, pad), (0, 0)))
        valid = jnp.pad(valid, (0, pad))
    return uv, valid


@partial(jax.jit, static_argnames=("cfg", "capacity", "h", "w"))
def _extract_atlas_hw(img: jnp.ndarray, cfg: ExtractorConfig, capacity: int,
                      h: int, w: int) -> FrameFeatures:
    layout = atlas_layout(h, w, cfg)
    budgets = level_budgets(cfg)
    canvas = _build_canvas(img, layout, cfg)

    score = nms3x3(fast_scores(canvas, cfg.fast_threshold))

    uvs_canvas, uvs_lv0, levels, valids = [], [], [], []
    for lv, ((hl, wl), xo, n_lv) in enumerate(
            zip(layout.shapes, layout.x_off, budgets)):
        if n_lv <= 0:
            continue
        border = max(4, int(round(cfg.border / cfg.scale_factor ** lv)),
                     17)  # patches must stay inside the level region
        uv_loc, valid = _select_level(
            jax.lax.slice_in_dim(score, xo, xo + wl, axis=1),
            hl, wl, n_lv, cfg.cell_size, border,
        )
        uv_canvas = uv_loc + jnp.asarray([float(xo), 0.0])
        scale = cfg.scale_factor ** lv
        uvs_canvas.append(uv_canvas)
        uvs_lv0.append(uv_loc * scale)
        levels.append(jnp.full((n_lv,), lv, jnp.int32))
        valids.append(valid)

    uv_canvas = jnp.concatenate(uvs_canvas)
    uv0 = jnp.concatenate(uvs_lv0)
    level = jnp.concatenate(levels)
    valid = jnp.concatenate(valids)

    # orientation + descriptors in ONE batch over all levels (canvas
    # coords): fused patch path — vmapped dynamic_slice windows + steering
    # matmuls; the blur is applied per patch, so no full-canvas
    # blur pass is needed (ops/orb.orient_and_describe)
    ang, desc = orient_and_describe(canvas, uv_canvas)

    n = uv0.shape[0]
    pad = capacity - n
    if pad < 0:
        raise ValueError(f"capacity {capacity} < total budget {n}")
    F = capacity
    return FrameFeatures(
        uv=jnp.pad(uv0, ((0, pad), (0, 0))),
        ur=jnp.full((F,), -1.0, jnp.float32),
        depth=jnp.full((F,), -1.0, jnp.float32),
        level=jnp.pad(level, (0, pad)),
        angle=jnp.pad(ang, (0, pad)),
        desc=jnp.pad(desc, ((0, pad), (0, 0))),
        valid=jnp.pad(valid, (0, pad)),
    )


def extract_atlas(img: jnp.ndarray, cfg: ExtractorConfig, capacity: int
                  ) -> FrameFeatures:
    h, w = img.shape
    return _extract_atlas_hw(img, cfg, capacity, h, w)


@partial(jax.jit, static_argnames=("cfg", "capacity", "h", "w"))
def _extract_atlas_batch_hw(imgs: jnp.ndarray, cfg: ExtractorConfig,
                            capacity: int, h: int, w: int) -> FrameFeatures:
    return jax.vmap(lambda im: _extract_atlas_hw(im, cfg, capacity, h, w))(imgs)


def extract_atlas_batch(imgs: jnp.ndarray, cfg: ExtractorConfig,
                        capacity: int) -> FrameFeatures:
    """Batched extraction: [B, H, W] -> FrameFeatures with leading batch
    axis. One compiled program runs all images' dense stages together —
    ~2x frame-rate over per-image calls for a stereo pair (the reference
    extracts left/right in two threads, ImageProcessing.cpp:82-84; here the
    batch axis is the data parallelism)."""
    b, h, w = imgs.shape
    return _extract_atlas_batch_hw(imgs, cfg, capacity, h, w)
