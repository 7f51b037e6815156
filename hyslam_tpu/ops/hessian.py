"""SURF-family feature ops: box-filter determinant-of-Hessian detection and
binary Haar-response descriptors.

Capability parity with the reference's second feature family
(src/features/SURFExtractor.cpp / SURFFinder, which wrap OpenCV SURF).
array-native design: SURF's integral-image box filters become cumsum
prefix-sum differences — dense full-map filter responses at four filter
sizes (9/15/21/27, the standard first octave) evaluated as pure elementwise
shifts, perfectly fused by XLA. Instead of SURF's float L1 descriptor
(DescriptorDistance.h SURF = L1), the descriptor binarizes an 8x8 grid of
upright Haar responses into the same 256-bit format as ORB so the entire
downstream stack (Hamming matmul matcher, arenas, BoW) is family-agnostic.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from hyslam_tpu.ops.hamming import pack_bits

FILTER_SIZES = (9, 15, 21, 27)   # SURF first-octave box-filter sizes


def box_filter(img: jnp.ndarray, ky: int, kx: int) -> jnp.ndarray:
    """Centered ky x kx box sum at every pixel (zero padding outside),
    via two cumsum prefix differences — O(HW) independent of kernel size."""
    h, w = img.shape
    ry0, ry1 = ky // 2, ky - ky // 2
    rx0, rx1 = kx // 2, kx - kx // 2
    cy = jnp.pad(jnp.cumsum(img, 0), ((1, 0), (0, 0)))
    cy = jnp.pad(cy, ((ry0, ry1), (0, 0)), mode="edge")
    v = (cy[ky:, :] - cy[:-ky, :])[:h, :]
    cx = jnp.pad(jnp.cumsum(v, 1), ((0, 0), (1, 0)))
    cx = jnp.pad(cx, ((0, 0), (rx0, rx1)), mode="edge")
    return (cx[:, kx:] - cx[:, :-kx])[:, :w]


def _shift(x: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Shift with zero fill (value at (y,x) comes from (y+dy, x+dx))."""
    return jnp.roll(x, (-dy, -dx), axis=(0, 1)) * _edge_mask(x.shape, dy, dx)


def _edge_mask(shape, dy, dx):
    h, w = shape
    yy = np.arange(h)
    xx = np.arange(w)
    my = (yy + dy >= 0) & (yy + dy < h)
    mx = (xx + dx >= 0) & (xx + dx < w)
    return jnp.asarray(np.outer(my, mx).astype(np.float32))


def doh_response(img: jnp.ndarray, L: int) -> jnp.ndarray:
    """Determinant-of-Hessian response map for box-filter size L (SURF
    Fast-Hessian: Dxx/Dyy from 3-lobe boxes, Dxy from 4 diagonal lobes,
    det = Dxx*Dyy - (0.9*Dxy)^2, normalized by filter area^2)."""
    l = L // 3
    wide = 2 * l - 1
    # Dyy: column of three l x wide boxes, weights (+1, -2, +1)
    byy = box_filter(img, l, wide)
    Dyy = _shift(byy, -l, 0) - 2.0 * byy + _shift(byy, l, 0)
    bxx = box_filter(img, wide, l)
    Dxx = _shift(bxx, 0, -l) - 2.0 * bxx + _shift(bxx, 0, l)
    # Dxy: four l x l boxes at diagonal quadrant centers
    bxy = box_filter(img, l, l)
    o = (l + 1) // 2 + 1
    Dxy = (
        _shift(bxy, -o, -o) + _shift(bxy, o, o)
        - _shift(bxy, -o, o) - _shift(bxy, o, -o)
    )
    inv_area = 1.0 / (L * L)
    Dxx = Dxx * inv_area
    Dyy = Dyy * inv_area
    Dxy = Dxy * inv_area
    return Dxx * Dyy - (0.9 * Dxy) ** 2


def haar_responses(img: jnp.ndarray, size: int):
    """Dense upright Haar wavelet responses (dx, dy) of the given size:
    dx = right-half box - left-half box, dy = bottom - top."""
    half = max(size // 2, 1)
    b = box_filter(img, 2 * half, half)
    dx = _shift(b, 0, (half + 1) // 2) - _shift(b, 0, -(half + 1) // 2)
    b2 = box_filter(img, half, 2 * half)
    dy = _shift(b2, (half + 1) // 2, 0) - _shift(b2, -(half + 1) // 2, 0)
    return dx, dy


def binary_haar_descriptors(img: jnp.ndarray, uv: jnp.ndarray,
                            scale: float = 1.0) -> jnp.ndarray:
    """256-bit descriptors from an 8x8 grid of Haar responses around each
    keypoint: bits = [dx>0, dy>0, |dx|>mean|dx|, |dy|>mean|dy|] per cell
    (an upright-SURF derivative binarized for Hamming matching).

    uv: [N, 2] (x, y). Returns [N, 8] uint32."""
    h, w = img.shape
    step = max(int(round(2 * scale)), 2)
    dx_map, dy_map = haar_responses(img, step)

    offs = (np.arange(8) - 3.5) * step
    gy, gx = np.meshgrid(offs, offs, indexing="ij")
    gx = jnp.asarray(gx.reshape(-1), jnp.float32)   # [64]
    gy = jnp.asarray(gy.reshape(-1), jnp.float32)

    x = jnp.clip(jnp.round(uv[:, 0, None] + gx[None, :]), 0, w - 1).astype(
        jnp.int32)
    y = jnp.clip(jnp.round(uv[:, 1, None] + gy[None, :]), 0, h - 1).astype(
        jnp.int32)
    dx = dx_map[y, x]                                # [N, 64]
    dy = dy_map[y, x]
    adx, ady = jnp.abs(dx), jnp.abs(dy)
    bits = jnp.concatenate(
        [
            dx > 0,
            dy > 0,
            adx > jnp.mean(adx, axis=-1, keepdims=True),
            ady > jnp.mean(ady, axis=-1, keepdims=True),
        ],
        axis=-1,
    )                                                # [N, 256]
    return pack_bits(bits)
