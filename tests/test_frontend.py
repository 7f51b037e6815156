"""Tests for the fused front-end entry points (slam.frontend) and the
batched extraction path added for the per-frame hot loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hyslam_tpu.features.atlas import extract_atlas, extract_atlas_batch
from hyslam_tpu.features.extractor import ExtractorConfig
from hyslam_tpu.features.factory import make_family
from hyslam_tpu.geometry.camera import Camera
from hyslam_tpu.slam.frontend import project_and_optimize
from hyslam_tpu.solver.pose_opt import pose_optimization, pose_optimization_fast

from helpers import make_world, render_world


CAM = Camera(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480,
             bf=45.0)
SMALL_CAM = Camera(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320,
                   height=240, bf=30.0)


def _textured(rng, h=240, w=320):
    cam = Camera(fx=300.0, fy=300.0, cx=w / 2, cy=h / 2, width=w, height=h,
                 bf=30.0)
    pts = make_world(rng, 120, extent=(4.0, 3.0, 10.0), z_min=3.0)
    img, _, _ = render_world(cam, np.eye(4, dtype=np.float32), pts)
    return img.astype(np.float32)


def test_extract_atlas_batch_matches_single(rng):
    cfg = ExtractorConfig(n_features=200, n_levels=4)
    imgs = np.stack([
        _textured(rng),
        _textured(rng),
    ])
    batched = extract_atlas_batch(jnp.asarray(imgs), cfg, capacity=256)
    for b in range(2):
        single = extract_atlas(jnp.asarray(imgs[b]), cfg, capacity=256)
        np.testing.assert_allclose(
            np.asarray(batched.uv[b]), np.asarray(single.uv), atol=1e-5)
        assert np.array_equal(np.asarray(batched.desc[b]),
                              np.asarray(single.desc))
        assert np.array_equal(np.asarray(batched.valid[b]),
                              np.asarray(single.valid))


def test_family_extract_batch_orb(rng):
    fam = make_family(ExtractorConfig(n_features=100, n_levels=4))
    imgs = np.stack([_textured(rng, 120, 160)] * 2)
    out = fam.extract_batch(jnp.asarray(imgs), capacity=128)
    assert out.uv.shape == (2, 128, 2)


def test_family_extract_batch_surf(rng):
    fam = make_family(ExtractorConfig(n_features=64, family="SURF"))
    imgs = np.stack([_textured(rng, 120, 160)] * 2)
    out = fam.extract_batch(jnp.asarray(imgs), capacity=64)
    assert out.uv.shape == (2, 64, 2)


def _synthetic_observations(rng, n=512, noise=0.5):
    X = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                  rng.uniform(3, 12, n)], -1).astype(np.float32)
    z = X[:, 2]
    uv = np.stack([CAM.fx * X[:, 0] / z + CAM.cx,
                   CAM.fy * X[:, 1] / z + CAM.cy], -1).astype(np.float32)
    uv += rng.normal(0, noise, uv.shape).astype(np.float32)
    ur = (uv[:, 0] - CAM.bf / z).astype(np.float32)
    return X, uv, ur


@pytest.mark.parametrize("kernel", [False, True])
def test_pose_optimization_fast_platform_choice(rng, monkeypatch, kernel):
    """pose_optimization_fast follows use_pose_kernel(): the plain solver
    exactly where it says no (every backend but the GPU), the Triton kernel
    (here through the interpreter) where it says yes, with the inlier mask
    and count rebuilt from the kernel's chi2."""
    from functools import partial

    from hyslam_tpu.ops import pose_opt_pallas
    from hyslam_tpu.solver import pose_opt

    assert pose_opt.use_pose_kernel() is False   # CPU test backend
    monkeypatch.setattr(pose_opt, "use_pose_kernel", lambda: kernel)
    monkeypatch.setattr(
        pose_opt_pallas, "pose_optimization_pallas",
        partial(pose_opt_pallas.pose_optimization_pallas, interpret=True))
    X, uv, ur = _synthetic_observations(rng)
    n = X.shape[0]
    w = jnp.ones(n)
    valid = jnp.ones(n, bool)
    st = jnp.ones(n, bool)
    T0 = jnp.eye(4)
    a = pose_optimization(CAM, T0, jnp.asarray(X), jnp.asarray(uv),
                          jnp.asarray(ur), w, valid, st)
    b = pose_optimization_fast(CAM, T0, jnp.asarray(X), jnp.asarray(uv),
                               jnp.asarray(ur), w, valid, st)
    if kernel:
        np.testing.assert_allclose(np.asarray(a.Tcw), np.asarray(b.Tcw),
                                   atol=1e-5)
        assert abs(int(a.num_inliers) - int(b.num_inliers)) <= 2
        assert int(b.num_inliers) == int(np.asarray(b.inliers).sum())
    else:
        np.testing.assert_allclose(np.asarray(a.Tcw), np.asarray(b.Tcw))
        assert int(a.num_inliers) == int(b.num_inliers)


def test_track_stereo_frame_matches_staged_pipeline(rng):
    """The single-dispatch fused frame step (extract+stereo+match+opt in one
    program) must produce the same result as the staged composition."""
    from hyslam_tpu.core.frame import level_inv_sigma2
    from hyslam_tpu.ops.stereo import match_stereo_refined
    from hyslam_tpu.slam.frontend import track_stereo_frame

    h, w = 240, 320
    cam = SMALL_CAM
    cfg = ExtractorConfig(n_features=200, n_levels=4)
    F = 256
    pts = make_world(rng, 150, extent=(4.0, 3.0, 10.0), z_min=3.0)
    img_l, _, _ = render_world(cam, np.eye(4, dtype=np.float32), pts)
    Tr = np.eye(4, dtype=np.float32)
    Tr[0, 3] = -cam.bf / cam.fx  # right camera: baseline along +x
    img_r, _, _ = render_world(cam, Tr, pts)
    pair = jnp.asarray(np.stack([img_l, img_r]).astype(np.float32))

    L = 512
    lm_pos = jnp.asarray(np.pad(pts, ((0, L - len(pts)), (0, 0))).astype(np.float32))
    dist = jnp.maximum(jnp.linalg.norm(lm_pos, axis=-1), 1e-3)
    lm_normal = lm_pos / dist[:, None]
    lm_desc = jnp.asarray(rng.integers(0, 2**32, (L, 8), dtype=np.uint32))
    lm_valid = jnp.arange(L) < len(pts)

    res_f, fl_f = track_stereo_frame(
        cam, cfg, F, pair, jnp.eye(4), lm_pos, lm_normal, lm_desc,
        dist * 1.1, dist / 1.2**8, lm_valid,
    )

    feats2 = extract_atlas_batch(pair, cfg, capacity=F)
    fl = jax.tree.map(lambda x: x[0], feats2)
    fr = jax.tree.map(lambda x: x[1], feats2)
    fl = match_stereo_refined(fl, fr, pair[0], pair[1], bf=cam.bf)
    inv_s2 = level_inv_sigma2()[jnp.clip(fl.level, 0, 7)]
    res_s = project_and_optimize(
        cam, fl, jnp.eye(4), lm_pos, lm_normal, lm_desc,
        dist * 1.1, dist / 1.2**8, lm_valid, inv_s2,
    )
    np.testing.assert_allclose(np.asarray(res_f.Tcw), np.asarray(res_s.Tcw),
                               atol=1e-6)
    assert int(res_f.n_matches) == int(res_s.n_matches)
    assert int(res_f.n_inliers) == int(res_s.n_inliers)
    np.testing.assert_allclose(np.asarray(fl_f.ur), np.asarray(fl.ur),
                               atol=1e-5)


def test_project_and_optimize_recovers_pose(rng):
    """Fused match+optimize converges to the true pose from a perturbed
    initial guess, matching the unfused strategy composition."""
    from hyslam_tpu.core.frame import empty_features
    from hyslam_tpu.geometry import se3

    L = 1024
    F = 512
    X = np.stack([rng.uniform(-4, 4, L), rng.uniform(-3, 3, L),
                  rng.uniform(4, 12, L)], -1).astype(np.float32)
    desc = rng.integers(0, 2**32, (L, 8), dtype=np.uint32)

    # true pose: small offset from identity
    xi = jnp.asarray([0.01, -0.02, 0.005, 0.05, -0.03, 0.08], jnp.float32)
    T_true = se3.exp(xi)
    pc = np.asarray(se3.apply(T_true, jnp.asarray(X)))
    z = pc[:, 2]
    uv = np.stack([CAM.fx * pc[:, 0] / z + CAM.cx,
                   CAM.fy * pc[:, 1] / z + CAM.cy], -1).astype(np.float32)
    inside = ((uv[:, 0] > 10) & (uv[:, 0] < 630) & (uv[:, 1] > 10)
              & (uv[:, 1] < 470) & (z > 0.1))
    order = np.nonzero(inside)[0][:F]
    n = len(order)
    assert n > 300

    feats = empty_features(F)
    feats = feats._replace(
        uv=feats.uv.at[:n].set(jnp.asarray(uv[order])),
        ur=feats.ur.at[:n].set(jnp.asarray(uv[order, 0] - CAM.bf / z[order])),
        desc=feats.desc.at[:n].set(jnp.asarray(desc[order])),
        valid=feats.valid.at[:n].set(True),
    )
    dist = np.linalg.norm(X, axis=-1).astype(np.float32)
    res = project_and_optimize(
        CAM, feats, jnp.eye(4),
        jnp.asarray(X), jnp.asarray(X / dist[:, None]), jnp.asarray(desc),
        jnp.asarray(dist * 1.1), jnp.asarray(dist / 1.2**8),
        jnp.ones(L, bool), jnp.ones(F), th=15.0,
    )
    assert int(res.n_inliers) > 200
    err = np.abs(np.asarray(res.Tcw) - np.asarray(T_true)).max()
    assert err < 5e-3, err
    # pruned associations point at real landmark rows
    lm_id = np.asarray(res.lm_id)
    assert (lm_id[lm_id >= 0] < L).all()
