"""Vocabulary IO: DBoW2 text parsing and npz serialization.

Backs tools/vocabulary.py (the bin_vocabulary.cc analog: text -> binary
vocabulary conversion for fast startup).

Replaces tools/bin_vocabulary.cc (text -> binary vocabulary conversion for
fast startup, bin_vocabulary.cc:48-56). The DBoW2 text format is

    k L scoring_type weighting_type
    parent_id is_leaf b0 b1 ... b31 weight      (one line per non-root node)

with node ids implicit in line order (root = 0). This loads that tree into
the array-native array layout (features.bow.Vocabulary: packed u32 centers,
children table, leaf word ids) and saves/loads it as npz.

Usage:
    python -m tools.vocabulary ORBvoc.txt ORBvoc.npz
"""

from __future__ import annotations

import sys

import numpy as np


def load_dbow2_text(path: str):
    """Parse a DBoW2 text vocabulary into features.bow.Vocabulary."""
    import jax.numpy as jnp
    from hyslam_tpu.features.bow import Vocabulary
    from hyslam_tpu.ops.hamming import pack_bits

    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])

        parents, leaves, descs, weights = [], [], [], []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            leaves.append(int(parts[1]) != 0)
            descs.append([int(b) for b in parts[2:34]])
            weights.append(float(parts[34]))

    n = len(parents) + 1                     # + root
    centers_u8 = np.zeros((n, 32), np.uint8)
    centers_u8[1:] = np.asarray(descs, np.uint8)
    # bytes -> 256 bits (LSB-first per byte) -> packed u32 words
    bits = np.unpackbits(centers_u8, axis=-1, bitorder="little")
    centers = np.asarray(pack_bits(jnp.asarray(bits)), np.uint32)

    children = np.full((n, k), -1, np.int32)
    counts = np.zeros(n, np.int32)
    word_id = np.full(n, -1, np.int32)
    idf = []
    w = 0
    for i, (p, is_leaf) in enumerate(zip(parents, leaves)):
        node = i + 1
        if counts[p] < k:
            children[p, counts[p]] = node
            counts[p] += 1
        if is_leaf:
            word_id[node] = w
            idf.append(weights[i])
            w += 1
    return Vocabulary(
        centers=jnp.asarray(centers),
        children=jnp.asarray(children),
        word_id=jnp.asarray(word_id),
        idf=jnp.asarray(np.asarray(idf, np.float32)),
        k=k,
        depth=L,
    )


def save_vocabulary(path: str, vocab) -> None:
    np.savez_compressed(
        path,
        centers=np.asarray(vocab.centers),
        children=np.asarray(vocab.children),
        word_id=np.asarray(vocab.word_id),
        idf=np.asarray(vocab.idf),
        k=vocab.k,
        depth=vocab.depth,
    )


def load_vocabulary(path: str):
    import jax.numpy as jnp
    from hyslam_tpu.features.bow import Vocabulary

    z = np.load(path)
    return Vocabulary(
        centers=jnp.asarray(z["centers"]),
        children=jnp.asarray(z["children"]),
        word_id=jnp.asarray(z["word_id"]),
        idf=jnp.asarray(z["idf"]),
        k=int(z["k"]),
        depth=int(z["depth"]),
    )


def main(argv=None):
    argv = argv or sys.argv[1:]
    if len(argv) != 2:
        print("usage: python -m tools.vocabulary <in: ORBvoc.txt|.npz> "
              "<out: .npz>")
        return 1
    src, dst = argv
    voc = load_vocabulary(src) if src.endswith(".npz") else \
        load_dbow2_text(src)
    save_vocabulary(dst, voc)
    print(f"{src} -> {dst}: {voc.n_words} words, k={voc.k}, L={voc.depth}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
