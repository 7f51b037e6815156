"""Measure place-recognition quality: precision/recall of BoW loop scoring
on held-out rendered revisits vs non-revisits (VERDICT r3 weak #5 — the
shipped vocabulary's discrimination was unvalidated; the reference ships a
~1M-word DBoW2 vocabulary, System.cc:86, but publishes no PR numbers).

Protocol: W held-out worlds (never seen by the vocabulary trainer; distinct
point constellations). For each world, render a reference view and a
REVISIT view (same place, perturbed pose — the loop-closure situation).
Positive pairs: (reference, revisit) of the same world. Negative pairs:
(reference_i, revisit_j) cross-world — i.e. the query side is always a
revisit view, exactly the query the loop detector scores. Score = BoW L1
similarity
(features.bow.l1_score, the quantity PlaceRecognizer thresholds).
Sweeps the score threshold -> PR curve; reports AUC-PR, best-F1 operating
point, and the separation margin.

    python tools/eval_loop_pr.py [--worlds 40] [--out pr_curve.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


def build_views(n_worlds: int, seed: int = 123, n_features: int = 400):
    """Held-out worlds: seed offset far from the trainer's (which uses
    point_seed = w*7919+13 with w < ~2000)."""
    import jax.numpy as jnp

    from helpers import DEFAULT_CAM, render_world
    from hyslam_tpu.features.extractor import ExtractorConfig
    from hyslam_tpu.features.factory import make_family
    from hyslam_tpu.geometry import se3

    cam = DEFAULT_CAM
    fam = make_family(ExtractorConfig(n_features=n_features, n_levels=4))
    rng = np.random.default_rng(seed)
    F = 512
    refs, revs = [], []
    for w in range(n_worlds):
        pts = np.stack([
            rng.uniform(-8, 8, 500), rng.uniform(-5, 5, 500),
            rng.uniform(2.5, 30, 500),
        ], -1).astype(np.float32)
        pseed = 10_000_019 + w * 104729  # disjoint from trainer seeds
        img0, _, _ = render_world(cam, np.eye(4, dtype=np.float32), pts,
                                  point_seed=pseed)
        # revisit: same place, different approach (pose perturbation of the
        # magnitude a loop closure must bridge: ~0.5 m + ~5 deg)
        xi = np.r_[rng.normal(0, 0.04, 3), rng.normal(0, 0.35, 3)]
        T = np.asarray(se3.exp(jnp.asarray(xi, jnp.float32))).astype(
            np.float32)
        img1, _, _ = render_world(cam, T, pts, point_seed=pseed)
        for img, dst in ((img0, refs), (img1, revs)):
            f = fam.extract(jnp.asarray(img), F)
            dst.append((np.asarray(f.desc), np.asarray(f.valid)))
        if (w + 1) % 10 == 0:
            print(f"  rendered {w + 1}/{n_worlds} worlds", flush=True)
    return refs, revs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=40)
    ap.add_argument("--vocab", default=None,
                    help="vocabulary npz (default: the shipped one)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import jax.numpy as jnp

    from hyslam_tpu.features.bow import bow_vector, l1_score
    from hyslam_tpu.features.vocab_io import load_vocabulary
    from hyslam_tpu.slam.system import default_vocab_path

    vp = args.vocab or default_vocab_path()
    vocab = load_vocabulary(vp)
    print(f"vocabulary: {vp} ({vocab.n_words} words)")

    t0 = time.time()
    refs, revs = build_views(args.worlds)

    vecs_ref = [np.asarray(bow_vector(vocab, jnp.asarray(d),
                                      jnp.asarray(v))[0]) for d, v in refs]
    vecs_rev = [np.asarray(bow_vector(vocab, jnp.asarray(d),
                                      jnp.asarray(v))[0]) for d, v in revs]

    pos = np.asarray([float(l1_score(jnp.asarray(a), jnp.asarray(b)))
                      for a, b in zip(vecs_ref, vecs_rev)])
    neg = []
    n = len(vecs_ref)
    for i in range(n):
        for j in range(i + 1, n):
            neg.append(float(l1_score(jnp.asarray(vecs_ref[i]),
                                      jnp.asarray(vecs_rev[j]))))
    neg = np.asarray(neg)

    # PR sweep over score thresholds
    ths = np.unique(np.concatenate([pos, neg]))
    rows = []
    best = None
    for th in ths:
        tp = int((pos >= th).sum())
        fp = int((neg >= th).sum())
        fn = int((pos < th).sum())
        if tp + fp == 0:
            continue
        p = tp / (tp + fp)
        r = tp / (tp + fn)
        f1 = 2 * p * r / max(p + r, 1e-9)
        rows.append({"threshold": round(float(th), 4), "precision": round(p, 4),
                     "recall": round(r, 4), "f1": round(f1, 4)})
        if best is None or f1 > best["f1"]:
            best = rows[-1]
    # AUC-PR by trapezoid over recall
    rs = np.asarray([r["recall"] for r in rows])
    ps = np.asarray([r["precision"] for r in rows])
    order = np.argsort(rs)
    auc = float(np.trapezoid(ps[order], rs[order]))

    out = {
        "vocab": vp,
        "n_words": int(vocab.n_words),
        "n_worlds": args.worlds,
        "n_pos_pairs": len(pos),
        "n_neg_pairs": len(neg),
        "pos_scores": {"mean": round(float(pos.mean()), 4),
                       "min": round(float(pos.min()), 4)},
        "neg_scores": {"mean": round(float(neg.mean()), 4),
                       "max": round(float(neg.max()), 4)},
        "auc_pr": round(auc, 4),
        "best_f1_operating_point": best,
        "wall_s": round(time.time() - t0, 1),
        "curve": rows[:: max(1, len(rows) // 50)],
    }
    print(json.dumps({k: v for k, v in out.items() if k != "curve"},
                     indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print("wrote", args.out)
    return 0


if __name__ == "__main__":
    from hyslam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    raise SystemExit(main())
