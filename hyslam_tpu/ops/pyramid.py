"""Image pyramid + Gaussian blur (ORBExtractor::ComputePyramid analog,
src/features/ORBExtractor.cpp:564).

Images are [H, W] float32 in [0, 255]. Levels are produced by bilinear
resize with the reference's 1.2 scale factor; the 7x7 sigma=2 Gaussian blur
matches the blur applied before descriptor sampling
(ORBExtractor.cpp:496-562 GaussianBlur(7,7,2,2)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def gaussian_kernel_1d(ksize: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return jnp.asarray(k / k.sum(), jnp.float32)


def gaussian_blur(img: jnp.ndarray, ksize: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    """Separable Gaussian blur, replicate-padded borders. img: [H, W] f32.

    Implemented as shifted multiply-adds instead of a 1-channel
    conv_general_dilated: the 2*ksize shifted adds fuse into a couple of
    elementwise passes."""
    import numpy as _np

    x0 = _np.arange(ksize) - (ksize - 1) / 2.0
    kk = _np.exp(-0.5 * (x0 / sigma) ** 2)
    kk = (kk / kk.sum()).astype(_np.float32)
    pad = ksize // 2
    H, W = img.shape
    x = jnp.pad(img, ((pad, pad), (0, 0)), mode="edge")
    acc = jnp.zeros_like(img)
    for i in range(ksize):
        acc = acc + float(kk[i]) * jax.lax.slice_in_dim(x, i, i + H, axis=0)
    x = jnp.pad(acc, ((0, 0), (pad, pad)), mode="edge")
    out = jnp.zeros_like(img)
    for i in range(ksize):
        out = out + float(kk[i]) * jax.lax.slice_in_dim(x, i, i + W, axis=1)
    return out


def pyramid_shapes(h: int, w: int, n_levels: int = 8, scale: float = 1.2):
    """Static per-level (H, W) shapes."""
    shapes = []
    for lv in range(n_levels):
        s = scale ** lv
        shapes.append((max(int(round(h / s)), 16), max(int(round(w / s)), 16)))
    return shapes


def build_pyramid(img: jnp.ndarray, n_levels: int = 8, scale: float = 1.2):
    """Returns a list of [Hl, Wl] f32 level images (level 0 = input)."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale)
    levels = [img]
    for lv in range(1, n_levels):
        levels.append(
            jax.image.resize(levels[-1], shapes[lv], method="bilinear")
        )
    return levels


def to_grayscale(img: jnp.ndarray) -> jnp.ndarray:
    """[H, W, 3] RGB (or [H, W]) -> [H, W] f32 luminance
    (ImageProcessing::PreProcessImg grayscale conversion)."""
    if img.ndim == 2:
        return img.astype(jnp.float32)
    w = jnp.asarray([0.299, 0.587, 0.114], jnp.float32)
    return jnp.einsum("hwc,c->hw", img.astype(jnp.float32), w)


def preprocess_image(img: jnp.ndarray, scale: float = 1.0) -> jnp.ndarray:
    """ImageProcessing::PreProcessImg (ImageProcessing.cpp:118): grayscale
    conversion + optional pre-scaling (the Imaging camera runs at scale 0.5
    of its 2704x2028 native resolution,
    config/sample_primary_config_file.yaml:43-71)."""
    gray = to_grayscale(img)
    if scale != 1.0:
        h, w = gray.shape
        gray = jax.image.resize(
            gray, (max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)),
            method="bilinear",
        )
    return gray
