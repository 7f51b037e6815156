"""Binary descriptor (256-bit ORB) Hamming distances.

Replaces DescriptorDistance (src/features/DescriptorDistance.h:8-35, the
popcount bit-hack credited in Dependencies.md) with two paths:

1. `hamming_pairwise` — XOR + `lax.population_count` on uint32 words,
   exact, for small/medium candidate sets.
2. `hamming_matrix` — the matmul path for all-pairs matching: unpack bits
   to {0,1} bf16 planes and use one matmul:
      H(a, b) = popcnt(a) + popcnt(b) - 2 * <bits(a), bits(b)>
   which turns the SearchByProjection / BoW / stereo candidate scoring at
   [Q, F] scale into one dense bf16 product (SURVEY.md §7.1).

Descriptors are [..., 8] uint32 (256 bits). Distances are int32 in [0, 256].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def popcount(desc: jnp.ndarray) -> jnp.ndarray:
    """Total set bits per descriptor [..., 8]u32 -> [...] int32."""
    return jnp.sum(jax.lax.population_count(desc).astype(jnp.int32), axis=-1)


def hamming_pairwise(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Elementwise Hamming distance between broadcast-compatible descriptor
    arrays [..., 8]u32 -> [...]."""
    return popcount(jnp.bitwise_xor(a, b))


def unpack_bits(desc: jnp.ndarray, dtype=jnp.bfloat16) -> jnp.ndarray:
    """[..., 8]u32 -> [..., 256] {0,1} planes (bit order: word-major, LSB
    first — consistent with pack_bits)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[..., :, None] >> shifts) & jnp.uint32(1)  # [..., 8, 32]
    return bits.reshape(desc.shape[:-1] + (256,)).astype(dtype)


def pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """[..., 256] bool/{0,1} -> [..., 8]u32 (inverse of unpack_bits)."""
    b = bits.reshape(bits.shape[:-1] + (8, 32)).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts, axis=-1, dtype=jnp.uint32)


def hamming_matrix(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """All-pairs Hamming distances as one bf16 matmul.

    a: [Q, 8]u32, b: [F, 8]u32 -> [Q, F] int32.

    Uses bf16 bit-plane matmul (values are 0/1 and dot products <= 256, so
    bf16 accumulation in f32 is exact).
    """
    pa = popcount(a)  # [Q]
    pb = popcount(b)  # [F]
    ba = unpack_bits(a)
    bb = unpack_bits(b)
    dot = jax.lax.dot_general(
        ba,
        bb,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT,  # 0/1 bf16 inputs: exact
    )
    return (pa[:, None] + pb[None, :] - 2 * dot.astype(jnp.int32)).astype(jnp.int32)
