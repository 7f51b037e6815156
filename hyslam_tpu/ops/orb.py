"""ORB keypoint orientation + steered binary descriptors, batched.

Replaces the reference's IC_Angle + rBRIEF computation
(src/features/ORBExtractor.cpp:496-562, ORBFinder rBRIEF from the WILLOW
GARAGE lineage). Differences by design:

- The sampling pattern is NOT the learned OpenCV constellation; it is a
  deterministic seeded Gaussian BRIEF pattern (sigma = patch/5, the classic
  BRIEF-32 recipe). Matching is always our-descriptor vs our-descriptor, so
  only internal consistency matters; a Gaussian pattern performs within a
  few percent of the learned one on matching benchmarks.
- All keypoints are processed as one [N, 961] gather batch + [N, 256, 2]
  rotated-pattern gather: no per-keypoint loops.

Angles follow the reference convention: intensity-centroid moments over a
radius-15 circular patch.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

PATCH_RADIUS = 15            # HALF_PATCH_SIZE in the reference
PATTERN_BITS = 256
_PATTERN_CLIP = 13           # keep rotated samples inside the 31x31 patch


def _make_pattern(seed: int = 7, n_bits: int = PATTERN_BITS) -> np.ndarray:
    """[n_bits, 2, 2] int32 (pair, point, (dx, dy)) Gaussian BRIEF pattern."""
    rng = np.random.default_rng(seed)
    sigma = (2 * PATCH_RADIUS + 1) / 5.0
    pts = rng.normal(0.0, sigma, size=(n_bits, 2, 2))
    return np.clip(np.round(pts), -_PATTERN_CLIP, _PATTERN_CLIP).astype(np.int32)

PATTERN = _make_pattern()

# circular patch mask offsets for the orientation moments
_dy, _dx = np.mgrid[-PATCH_RADIUS : PATCH_RADIUS + 1, -PATCH_RADIUS : PATCH_RADIUS + 1]
_CIRC = (_dy * _dy + _dx * _dx) <= PATCH_RADIUS * PATCH_RADIUS
PATCH_DY = _dy.reshape(-1)
PATCH_DX = _dx.reshape(-1)
PATCH_MASK = _CIRC.reshape(-1)


def _gather_pixels(img: jnp.ndarray, ys: jnp.ndarray, xs: jnp.ndarray) -> jnp.ndarray:
    """Clamped 2D gather: img [H, W], ys/xs [...] int32 -> [...].

    Linearized to a 1D take on the flattened image."""
    h, w = img.shape
    ys = jnp.clip(ys, 0, h - 1)
    xs = jnp.clip(xs, 0, w - 1)
    return jnp.take(img.reshape(-1), ys * w + xs)


@jax.jit
def orientations(img: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid angles (radians) for keypoints uv [N, 2] (x, y)
    on a level image [H, W] (ORBExtractor IC_Angle analog)."""
    x0 = jnp.round(uv[:, 0]).astype(jnp.int32)
    y0 = jnp.round(uv[:, 1]).astype(jnp.int32)
    ys = y0[:, None] + jnp.asarray(PATCH_DY)[None, :]
    xs = x0[:, None] + jnp.asarray(PATCH_DX)[None, :]
    p = _gather_pixels(img, ys, xs) * jnp.asarray(PATCH_MASK, jnp.float32)[None, :]
    m10 = jnp.sum(p * jnp.asarray(PATCH_DX, jnp.float32)[None, :], axis=-1)
    m01 = jnp.sum(p * jnp.asarray(PATCH_DY, jnp.float32)[None, :], axis=-1)
    return jnp.arctan2(m01, m10)


# ---------------------------------------------------------------------------
# Fused patch path: orientation + steered descriptor without global gathers
# ---------------------------------------------------------------------------
#
# The production extraction path. Instead of per-keypoint global gathers
# (the orientations/descriptors functions below), each keypoint's 48x48
# neighborhood is cut out with ONE vmapped dynamic_slice, the
# orientation moments become a single [N,2304]x[2304,2] matmul, and the
# steered-BRIEF sampling becomes 30 matmuls against constant +/-1
# selection matrices — one per 12-degree rotation bin, the same steering
# quantization OpenCV's ORB uses. The Gaussian blur that the dense path
# applied to the whole canvas is applied to the patches instead (rolls on
# the tiny patch tensor), so the full-canvas blur disappears from the
# pipeline.

PATCH = 48                    # window: +/-19 rotated samples + blur context
PATCH_C = PATCH // 2
N_ROT_BINS = 30               # 12-degree steering bins (OpenCV ORB's
                              # factorPI quantization; also the rotation-
                              # histogram granularity, FeatureMatcher.cc).
                              # Measured on the PR harness: 60 bins scored
                              # WORSE (AUC-PR 0.63 vs 0.71) — steering-bin
                              # flip noise is not the discrimination
                              # bottleneck at this operating point


def _make_rot_tables():
    """[N_ROT_BINS, PATCH*PATCH, 256] f32 steering selection matrices:
    column s of bin b has +1 at sample point p2 and -1 at p1 of pattern
    pair s rotated by the bin-center angle; descriptor bit s is then
    (patch_flat @ SEL[b])[s] > 0  ==  I(p1) < I(p2)."""
    sel = np.zeros((N_ROT_BINS, PATCH * PATCH, PATTERN_BITS), np.float32)
    pat = PATTERN.astype(np.float64)          # [256, 2, 2] (dx, dy)
    for b in range(N_ROT_BINS):
        a = 2.0 * np.pi * b / N_ROT_BINS
        ca, sa = np.cos(a), np.sin(a)
        rx = np.clip(np.round(ca * pat[..., 0] - sa * pat[..., 1]),
                     -_PATTERN_CLIP - 6, _PATTERN_CLIP + 6).astype(np.int64)
        ry = np.clip(np.round(sa * pat[..., 0] + ca * pat[..., 1]),
                     -_PATTERN_CLIP - 6, _PATTERN_CLIP + 6).astype(np.int64)
        lin = (PATCH_C + ry) * PATCH + (PATCH_C + rx)     # [256, 2]
        for s in range(PATTERN_BITS):
            sel[b, lin[s, 0], s] -= 1.0
            sel[b, lin[s, 1], s] += 1.0
    return sel


_SEL_NP = _make_rot_tables()                              # baked literal

# orientation moment weights over the radius-15 disc, in 48x48 coords
_W48 = np.zeros((PATCH * PATCH, 2), np.float32)
_lin48 = (PATCH_C + _dy.reshape(-1)) * PATCH + (PATCH_C + _dx.reshape(-1))
np.add.at(_W48, (_lin48, 0), np.where(PATCH_MASK, PATCH_DX, 0))
np.add.at(_W48, (_lin48, 1), np.where(PATCH_MASK, PATCH_DY, 0))

_BLUR_K = None


def _blur_taps(ksize=7, sigma=2.0):
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@jax.jit
def orient_and_describe(img: jnp.ndarray, uv: jnp.ndarray):
    """Fused orientation + descriptor for keypoints uv [N,2] on a RAW
    (unblurred) image [H,W]: returns (angle [N] f32, desc [N,8] u32).

    Matches the reference semantics: IC_Angle moments on the raw image,
    rBRIEF sampled from the 7-tap Gaussian-blurred image, steering
    quantized to 12-degree bins (OpenCV ORB does the same)."""
    H, W = img.shape
    N = uv.shape[0]
    padded = jnp.pad(img, ((PATCH_C, PATCH_C), (PATCH_C, PATCH_C)),
                     mode="edge")
    y0 = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), 0, H - 1)
    x0 = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), 0, W - 1)

    def cut(y, x):
        return jax.lax.dynamic_slice(padded, (y, x), (PATCH, PATCH))

    patches = jax.vmap(cut)(y0, x0)                       # [N,48,48] raw
    flat_raw = patches.reshape(N, PATCH * PATCH)

    m = flat_raw @ jnp.asarray(_W48)                      # [N,2]
    ang = jnp.arctan2(m[:, 1], m[:, 0])

    # blur the patches (separable 7-tap; roll wrap artifacts live in the
    # outer 3-px ring, outside the +/-19 sample range)
    taps = _blur_taps()
    pb = jnp.zeros_like(patches)
    for i, t in enumerate(taps):
        pb = pb + float(t) * jnp.roll(patches, 3 - i, axis=1)
    pb2 = jnp.zeros_like(pb)
    for i, t in enumerate(taps):
        pb2 = pb2 + float(t) * jnp.roll(pb, 3 - i, axis=2)
    flat_b = pb2.reshape(N, PATCH * PATCH)
    # center per patch before the bf16 cast: the +/-1 selection columns are
    # shift-invariant (sum to 0), and centered intensities keep ~1-gray-
    # level resolution in bf16 where raw 0..255 values would quantize to ~2
    flat_b = flat_b - jnp.mean(flat_b, axis=1, keepdims=True)
    flat_b = flat_b.astype(jnp.bfloat16)

    two_pi = 2.0 * np.pi
    bins = jnp.round(jnp.mod(ang, two_pi) / (two_pi / N_ROT_BINS))
    bins = jnp.mod(bins.astype(jnp.int32), N_ROT_BINS)    # [N]

    sel = jnp.asarray(_SEL_NP, jnp.bfloat16)              # [30, 2304, 256]
    diff = jnp.zeros((N, PATTERN_BITS), jnp.float32)
    for b in range(N_ROT_BINS):
        mask = (bins == b).astype(jnp.bfloat16)[:, None]
        diff = diff + jnp.dot(flat_b * mask, sel[b],
                              preferred_element_type=jnp.float32)
    bits = diff > 0.0
    from hyslam_tpu.ops.hamming import pack_bits

    return ang, pack_bits(bits)


@jax.jit
def descriptors(
    img_blur: jnp.ndarray, uv: jnp.ndarray, angle: jnp.ndarray
) -> jnp.ndarray:
    """Steered BRIEF-256 descriptors [N, 8] uint32 from a BLURRED level
    image. uv [N, 2] (x, y) in level coords, angle [N] radians."""
    pat = jnp.asarray(PATTERN, jnp.float32)        # [256, 2, 2] (dx, dy)
    ca = jnp.cos(angle)[:, None, None]
    sa = jnp.sin(angle)[:, None, None]
    dx = pat[None, ..., 0]
    dy = pat[None, ..., 1]
    rx = jnp.round(ca * dx - sa * dy).astype(jnp.int32)   # [N, 256, 2]
    ry = jnp.round(sa * dx + ca * dy).astype(jnp.int32)
    x0 = jnp.round(uv[:, 0]).astype(jnp.int32)[:, None, None]
    y0 = jnp.round(uv[:, 1]).astype(jnp.int32)[:, None, None]
    vals = _gather_pixels(img_blur, y0 + ry, x0 + rx)     # [N, 256, 2]
    bits = vals[..., 0] < vals[..., 1]                     # [N, 256]
    from hyslam_tpu.ops.hamming import pack_bits

    return pack_bits(bits)
