"""Pose-LM kernel (Pallas, Triton route) vs the plain XLA solver: same
convergence on the same problems. The kernel runs through the Pallas
interpreter here; its GPU lowering is checked by lowering for CUDA, which
needs no card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hyslam_tpu.ops.pose_opt_pallas import padded_size, pose_optimization_pallas
from hyslam_tpu.solver import pose_opt
from hyslam_tpu.solver.pose_opt import pose_optimization

from helpers import DEFAULT_CAM, make_world, make_trajectory, observe, perturb_pose, pose_error


def problem(rng, n=256, outlier_frac=0.0, stereo_frac=1.0):
    cam = DEFAULT_CAM
    pts = make_world(rng, n)
    T_true = make_trajectory(3)[2]
    uv, ur, vis, stereo = observe(cam, T_true, pts, noise=0.3, rng=rng,
                                  stereo_frac=stereo_frac)
    n_out = int(outlier_frac * n)
    out_idx = rng.choice(n, n_out, replace=False)
    uv[out_idx] += rng.uniform(30, 120, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    T0 = perturb_pose(rng, T_true, rot=0.03, trans=0.15)
    return cam, T_true, T0, pts, uv, ur, vis, stereo, out_idx


def _args(T0, pts, uv, ur, vis, stereo):
    return (jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(uv),
            jnp.asarray(ur), jnp.ones(len(pts)), jnp.asarray(vis),
            jnp.asarray(stereo & vis))


def _kernel(cam, *args):
    Tk, c2 = pose_optimization_pallas(cam, *args, interpret=True)
    valid, stereo = np.asarray(args[5]), np.asarray(args[6])
    th = np.where(stereo, 7.815, 5.991)
    inl = valid & (np.asarray(c2) <= th)
    return np.asarray(Tk), inl, np.asarray(c2)


class TestPallasPoseOpt:
    def test_matches_reference_solver(self, rng):
        cam, T_true, T0, pts, uv, ur, vis, stereo, _ = problem(rng)
        args = _args(T0, pts, uv, ur, vis, stereo)
        ref = pose_optimization(cam, *args)
        Tk, inl, _ = _kernel(cam, *args)
        rot_err, t_err = pose_error(Tk, T_true)
        assert rot_err < 0.1 and t_err < 0.01, (rot_err, t_err)
        # agreement with the jnp solver
        d_rot, d_t = pose_error(Tk, np.asarray(ref.Tcw))
        assert d_rot < 0.05 and d_t < 0.01
        assert abs(int(inl.sum()) - int(ref.num_inliers)) <= 10

    def test_outlier_rejection(self, rng):
        cam, T_true, T0, pts, uv, ur, vis, stereo, out_idx = problem(
            rng, outlier_frac=0.25)
        Tk, inl, _ = _kernel(cam, *_args(T0, pts, uv, ur, vis, stereo))
        rot_err, t_err = pose_error(Tk, T_true)
        assert rot_err < 0.2 and t_err < 0.02
        assert (~inl[out_idx] | ~vis[out_idx]).mean() > 0.95

    def test_mono(self, rng):
        cam, T_true, T0, pts, uv, ur, vis, stereo, _ = problem(
            rng, stereo_frac=0.0)
        Tk, inl, _ = _kernel(cam, *_args(T0, pts, uv, ur, vis, stereo))
        rot_err, t_err = pose_error(Tk, T_true)
        assert rot_err < 0.2 and t_err < 0.05

    @pytest.mark.parametrize("n", [1024, 700])
    @pytest.mark.parametrize("variant", ["stereo", "mono", "outliers"])
    def test_agrees_at_width(self, n, variant):
        """At the tracker's width (N=1024) and at a width that needs
        padding: pose within 1e-4 rad / 1e-4 m of the plain solver, inlier
        counts within 2, chi2 of the real rows equal."""
        rng = np.random.default_rng(n)
        cam, _, T0, pts, uv, ur, vis, stereo, _ = problem(
            rng, n=n, outlier_frac=0.25 if variant == "outliers" else 0.0,
            stereo_frac=0.0 if variant == "mono" else 1.0)
        args = _args(T0, pts, uv, ur, vis, stereo)
        ref = pose_optimization(cam, *args)
        Tk, inl, c2 = _kernel(cam, *args)
        d_rot, d_t = pose_error(Tk, np.asarray(ref.Tcw))
        assert np.radians(d_rot) < 1e-4 and d_t < 1e-4, (d_rot, d_t)
        assert abs(int(inl.sum()) - int(ref.num_inliers)) <= 2
        assert c2.shape == (n,)
        ok = vis & (np.asarray(ref.chi2) < 1e3)
        np.testing.assert_allclose(c2[ok], np.asarray(ref.chi2)[ok],
                                   rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n,expect", [(1, 16), (16, 16), (17, 32),
                                      (700, 1024), (1024, 1024),
                                      (1025, 2048)])
def test_padded_size(n, expect):
    assert padded_size(n) == expect


def test_padding_rows_carry_no_weight(rng):
    """Padded rows repeat the last observation with valid=0: appending
    invalid rows to a problem leaves the solution unchanged."""
    cam, _, T0, pts, uv, ur, vis, stereo, _ = problem(rng, n=200)
    a = _args(T0, pts, uv, ur, vis, stereo)
    Ta, _, _ = _kernel(cam, *a)
    pad = 56
    b = (a[0],) + tuple(
        jnp.concatenate([x, x[-1:].repeat(pad, 0)]) for x in a[1:5]
    ) + (jnp.concatenate([a[5], jnp.zeros(pad, bool)]),
         jnp.concatenate([a[6], a[6][-1:].repeat(pad)]))
    Tb, inl_b, _ = _kernel(cam, *b)
    np.testing.assert_allclose(Tb, Ta, atol=1e-5)
    assert not inl_b[200:].any()


def test_lowers_to_triton_for_cuda():
    """The kernel lowers to one Triton custom call for the CUDA platform
    (lowering needs no card; compiling to PTX happens on the card)."""
    n = 1024
    args = (jnp.eye(4), jnp.ones((n, 3)), jnp.ones((n, 2)), jnp.ones(n),
            jnp.ones(n), jnp.ones(n, bool), jnp.ones(n, bool))
    lowered = jax.jit(
        lambda *a: pose_optimization_pallas(DEFAULT_CAM, *a)
    ).trace(*args).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1


@pytest.mark.parametrize("backend,kernel", [("gpu", True), ("cpu", False)])
def test_platform_rule(monkeypatch, backend, kernel):
    monkeypatch.setattr(pose_opt.jax, "default_backend", lambda: backend)
    assert pose_opt.use_pose_kernel() is kernel
