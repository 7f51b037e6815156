"""Tests for loop-closing building blocks: BoW vocabulary/scoring, Sim3
RANSAC, Sim3 refinement, essential-graph optimization."""

import numpy as np
import jax
import jax.numpy as jnp

from hyslam_tpu.estimators.sim3_solver import sim3_ransac
from hyslam_tpu.features.bow import (
    PlaceRecognizer,
    bow_vector,
    l1_score,
    train_vocabulary,
)
from hyslam_tpu.geometry import se3, sim3, so3
from hyslam_tpu.geometry.camera import project
from hyslam_tpu.solver.pose_graph import optimize_pose_graph
from hyslam_tpu.solver.sim3_opt import optimize_sim3

from helpers import DEFAULT_CAM, make_world


def random_descs(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def corrupt(rng, d, n_bits):
    out = d.copy()
    for _ in range(n_bits):
        w = rng.integers(0, 8, len(d))
        b = rng.integers(0, 32, len(d)).astype(np.uint32)
        out[np.arange(len(d)), w] ^= np.uint32(1) << b
    return out


class TestBow:
    def test_same_frame_high_score(self, rng):
        train = random_descs(rng, 2000)
        vocab = train_vocabulary(train, k=8, depth=3)
        assert vocab.n_words > 50
        d = random_descs(rng, 200)
        va = jnp.ones(200, bool)
        v1, words = bow_vector(vocab, jnp.asarray(d), va)
        v2, _ = bow_vector(vocab, jnp.asarray(corrupt(rng, d, 2)), va)
        v3, _ = bow_vector(vocab, jnp.asarray(random_descs(rng, 200)), va)
        s_same = float(l1_score(v1, v2))
        s_diff = float(l1_score(v1, v3))
        assert s_same > s_diff + 0.1
        assert abs(float(jnp.sum(jnp.abs(v1))) - 1.0) < 1e-5

    def test_place_recognizer_retrieves(self, rng):
        train = random_descs(rng, 2000)
        vocab = train_vocabulary(train, k=8, depth=3)
        pr = PlaceRecognizer(vocab, K=16)
        frames = [random_descs(rng, 150) for _ in range(8)]
        va = jnp.ones(150, bool)
        for k, d in enumerate(frames):
            pr.add_keyframe(k, jnp.asarray(d), va)
        # query with a noisy version of frame 5
        q = corrupt(rng, frames[5], 3)
        s = pr.scores(jnp.asarray(q), va)
        assert s.argmax() == 5
        covis = np.zeros((16, 16), np.int32)
        cands = pr.detect_relocalization_candidates(jnp.asarray(q), va, covis)
        assert 5 in cands


class TestSim3Ransac:
    def test_recovers_known_sim3(self, rng):
        cam = DEFAULT_CAM
        N = 100
        X1 = jnp.asarray(make_world(rng, N, extent=(4.0, 3.0, 10.0), z_min=3.0))
        g_true = sim3.pack(
            jnp.asarray(1.3), so3.exp(jnp.asarray([0.05, -0.1, 0.03])),
            jnp.asarray([0.4, -0.2, 0.5]),
        )
        X2 = sim3.apply(sim3.inverse(g_true), X1)
        uv1, _ = project(cam, X1)
        uv2, _ = project(cam, X2)
        valid = np.ones(N, bool)
        # inject mismatches
        bad = rng.choice(N, 20, replace=False)
        X2n = np.array(X2)
        X2n[bad] += rng.uniform(1, 3, (20, 3))
        g, inl, n = sim3_ransac(
            cam, cam, X1, jnp.asarray(X2n), uv1, uv2,
            jnp.ones(N), jnp.ones(N), jnp.asarray(valid),
            jax.random.PRNGKey(0),
        )
        assert int(n) > 60
        s, R, t = sim3.unpack(g)
        np.testing.assert_allclose(float(s), 1.3, atol=0.02)
        inl = np.asarray(inl)
        assert (~inl[bad]).mean() > 0.9

    def test_fix_scale(self, rng):
        cam = DEFAULT_CAM
        N = 60
        X1 = jnp.asarray(make_world(rng, N, extent=(4.0, 3.0, 10.0), z_min=3.0))
        g_true = sim3.pack(
            jnp.asarray(1.0), so3.exp(jnp.asarray([0.02, -0.04, 0.01])),
            jnp.asarray([0.2, 0.1, -0.3]),
        )
        X2 = sim3.apply(sim3.inverse(g_true), X1)
        uv1, _ = project(cam, X1)
        uv2, _ = project(cam, X2)
        g, inl, n = sim3_ransac(
            cam, cam, X1, X2, uv1, uv2, jnp.ones(N), jnp.ones(N),
            jnp.ones(N, bool), jax.random.PRNGKey(1), fix_scale=True,
        )
        s, _, _ = sim3.unpack(g)
        assert abs(float(s) - 1.0) < 1e-5
        assert int(n) > 50


class TestOptimizeSim3:
    def test_padded_sparse_matches(self, rng):
        """Loop-closure operating point: a 512-slot padded feature table
        with only ~30 valid matched pairs, 40% of them mismatched. RANSAC
        must sample its triples from the valid pairs (uniform sampling over
        padded slots gives (30/512)^3*128 ~ 0.03 valid hypotheses — an
        earlier long run found 0 inliers) and optimize_sim3 must stay in
        the RANSAC basin when seeded (unseeded, the 40% outlier mass pulled
        it off: 24 ransac inliers -> 0 after refinement)."""
        cam = DEFAULT_CAM
        F, n_pairs, n_bad = 512, 30, 12
        Xw = jnp.asarray(make_world(rng, F, extent=(4.0, 3.0, 10.0), z_min=3.0))
        g_true = sim3.pack(
            jnp.asarray(1.0), so3.exp(jnp.asarray([0.02, -0.05, 0.01])),
            jnp.asarray([0.35, 0.0, 0.35]),
        )
        X1 = Xw
        X2 = np.array(sim3.apply(sim3.inverse(g_true), X1))
        # mismatches: wrong correspondences for n_bad of the pairs
        bad = rng.choice(n_pairs, n_bad, replace=False)
        X2[bad] = X2[rng.permutation(bad)] + rng.uniform(0.5, 1.5, (n_bad, 3))
        uv1, _ = project(cam, X1)
        uv2, _ = project(cam, jnp.asarray(X2))
        valid = np.zeros(F, bool)
        valid[:n_pairs] = True
        g, inl, n = sim3_ransac(
            cam, cam, X1, jnp.asarray(X2), uv1, uv2,
            jnp.ones(F), jnp.ones(F), jnp.asarray(valid),
            jax.random.PRNGKey(3), fix_scale=True,
        )
        assert int(n) >= n_pairs - n_bad - 3, f"ransac inliers {int(n)}"
        g2, inl2, n2 = optimize_sim3(
            cam, cam, g, X1, jnp.asarray(X2), uv1, uv2,
            jnp.ones(F), jnp.ones(F), jnp.asarray(valid),
            fix_scale=True, seed_inliers=inl,
        )
        assert int(n2) >= n_pairs - n_bad - 3, f"opt inliers {int(n2)}"
        err = jnp.linalg.norm(
            sim3.apply(g2, jnp.asarray(X2))[:n_pairs][~np.isin(
                np.arange(n_pairs), bad)]
            - X1[:n_pairs][~np.isin(np.arange(n_pairs), bad)], axis=-1)
        assert float(jnp.median(err)) < 0.05

    def test_refines_perturbed(self, rng):
        cam = DEFAULT_CAM
        N = 80
        X1 = jnp.asarray(make_world(rng, N, extent=(4.0, 3.0, 10.0), z_min=3.0))
        g_true = sim3.pack(
            jnp.asarray(0.8), so3.exp(jnp.asarray([0.03, 0.06, -0.02])),
            jnp.asarray([0.3, -0.1, 0.2]),
        )
        X2 = sim3.apply(sim3.inverse(g_true), X1)
        uv1, _ = project(cam, X1)
        uv2, _ = project(cam, X2)
        uv1 = uv1 + jnp.asarray(rng.normal(0, 0.3, (N, 2)).astype(np.float32))
        g0 = sim3.compose(
            sim3.exp(jnp.asarray([0.02, 0.01, -0.01, 0.01, 0.05, -0.03, 0.02])),
            g_true,
        )
        g, inl, n = optimize_sim3(
            cam, cam, g0, X1, X2, uv1, uv2, jnp.ones(N), jnp.ones(N),
            jnp.ones(N, bool),
        )
        assert int(n) > 70
        # refined g should map X2 close to X1
        err = jnp.linalg.norm(sim3.apply(g, X2) - X1, axis=-1)
        assert float(jnp.median(err)) < 0.02


class TestPoseGraph:
    def test_loop_correction_distributes_drift(self, rng):
        """Classic loop: chain of K poses with odometry edges + one loop
        edge from the drifted end back to the start; optimization should
        spread the accumulated drift across the chain."""
        K = 12
        # ground truth: circle-ish chain
        g_true = []
        cur = sim3.identity()
        step = sim3.exp(jnp.asarray([0.0, 0.0, 0.5, 0.0, 0.4, 0.0, 0.0]))
        for k in range(K):
            g_true.append(cur)
            cur = sim3.compose(step, cur)
        g_true = jnp.stack(g_true)
        # odometry measurements are exact; initial estimates drift
        drift = sim3.exp(jnp.asarray([0.0, 0.0, 0.015, 0.0, 0.02, 0.0, 0.0]))
        g_est = [g_true[0]]
        for k in range(1, K):
            meas = sim3.compose(g_true[k], sim3.inverse(g_true[k - 1]))
            g_est.append(sim3.compose(drift, sim3.compose(meas, g_est[-1])))
        g_est = jnp.stack(g_est)

        ei, ej, meas = [], [], []
        for k in range(1, K):
            ei.append(k - 1)
            ej.append(k)
            meas.append(sim3.compose(g_true[k], sim3.inverse(g_true[k - 1])))
        # loop edge: K-1 -> 0 with the TRUE relative transform
        ei.append(0)
        ej.append(K - 1)
        meas.append(sim3.compose(g_true[K - 1], sim3.inverse(g_true[0])))

        # error before
        err0 = float(jnp.linalg.norm(g_est[K - 1][5:] - g_true[K - 1][5:]))
        g_opt = optimize_pose_graph(
            g_est, jnp.asarray(np.arange(K) == 0),
            jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32),
            jnp.stack(meas)[:, None, :].squeeze(1),
            jnp.ones(len(ei), bool),
        )
        err1 = float(jnp.linalg.norm(g_opt[K - 1][5:] - g_true[K - 1][5:]))
        assert err1 < 0.1 * err0, (err0, err1)
        # every pose close to truth now
        terr = np.linalg.norm(np.asarray(g_opt[:, 5:] - g_true[:, 5:]), axis=-1)
        assert terr.max() < 0.05
