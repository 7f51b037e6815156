"""Pretrain a place-recognition vocabulary at scale (the analog of the
reference's shipped ~1M-word DBoW2 ORB vocabulary, System.cc:86).

Renders many random sparse-textured worlds, extracts ORB descriptors with
the production atlas extractor, and trains a k=10 hierarchical k-medians
tree with tf-idf weights (features.bow.train_vocabulary_batched). Ships as
Vocabulary/synthetic_orb.npz, which System loads by default when no
vocab_path is configured.

    python tools/train_synthetic_vocab.py --worlds 150 --poses 2 \
        --depth 4 --out Vocabulary/synthetic_orb.npz
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


def build_corpus(n_worlds: int, n_poses: int, n_features: int, seed: int = 0):
    import jax.numpy as jnp

    from helpers import DEFAULT_CAM, render_world
    from hyslam_tpu.features.extractor import ExtractorConfig
    from hyslam_tpu.features.factory import make_family
    from hyslam_tpu.geometry import se3

    cam = DEFAULT_CAM
    fam = make_family(ExtractorConfig(n_features=n_features, n_levels=4))
    rng = np.random.default_rng(seed)
    descs, docs = [], []
    F = 512
    for w in range(n_worlds):
        pts = np.stack([
            rng.uniform(-8, 8, 500), rng.uniform(-5, 5, 500),
            rng.uniform(2.5, 30, 500),
        ], -1).astype(np.float32)
        for p in range(n_poses):
            xi = np.r_[rng.normal(0, 0.05, 3), rng.normal(0, 0.4, 3)]
            T = np.asarray(se3.exp(jnp.asarray(xi, jnp.float32)))
            img, _, _ = render_world(cam, T.astype(np.float32), pts,
                                     point_seed=w * 7919 + 13)
            f = fam.extract(jnp.asarray(img), F)
            v = np.asarray(f.valid)
            d = np.asarray(f.desc)[v]
            descs.append(d)
            docs.append(np.full(len(d), w * n_poses + p, np.int64))
        if (w + 1) % 25 == 0:
            print(f"  {w + 1}/{n_worlds} worlds, "
                  f"{sum(len(d) for d in descs)} descriptors")
    return np.concatenate(descs), np.concatenate(docs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=150)
    ap.add_argument("--poses", type=int, default=2)
    ap.add_argument("--features", type=int, default=500)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--out", default="Vocabulary/synthetic_orb.npz")
    args = ap.parse_args(argv)

    from hyslam_tpu.features.bow import train_vocabulary_batched
    from hyslam_tpu.features.vocab_io import save_vocabulary

    t0 = time.time()
    print("building corpus ...")
    descs, docs = build_corpus(args.worlds, args.poses, args.features)
    print(f"corpus: {len(descs)} descriptors from {docs.max() + 1} images "
          f"({time.time() - t0:.0f}s)")
    t0 = time.time()
    voc = train_vocabulary_batched(
        descs, k=args.k, depth=args.depth, doc_id=docs, iters=args.iters
    )
    print(f"trained: {voc.n_words} words, k={voc.k}, depth={voc.depth} "
          f"({time.time() - t0:.0f}s)")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_vocabulary(args.out, voc)
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    from hyslam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())
