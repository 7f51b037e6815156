"""Distributed BA on the virtual 8-device CPU mesh: the sharded Schur
reduction must match the single-device solver."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from hyslam_tpu.parallel.mesh import make_mesh
from hyslam_tpu.parallel.dist_ba import distributed_bundle_adjustment
from hyslam_tpu.solver.ba import bundle_adjustment

from helpers import pose_error
from test_solver import build_ba_problem


class TestDistributedBA:
    def test_matches_single_device(self, rng):
        prob, Ts_true, pts_true = build_ba_problem(rng, n_lm=160)
        mesh = make_mesh(8)
        res_d = distributed_bundle_adjustment(prob, mesh, n_iters=6, chunk=20)
        res_s = bundle_adjustment(prob, n_iters=6, chunk=20)
        # same optimum (iteration paths may differ by reduction order)
        for k in range(len(Ts_true)):
            rot, tr = pose_error(np.asarray(res_d.kf_Tcw[k]),
                                 np.asarray(res_s.kf_Tcw[k]))
            assert rot < 0.05 and tr < 0.01, (k, rot, tr)
        assert abs(float(res_d.cost) - float(res_s.cost)) < 0.1 * float(res_s.cost) + 5.0

    def test_converges_to_truth(self, rng):
        prob, Ts_true, _ = build_ba_problem(rng, n_lm=160)
        mesh = make_mesh(8)
        res = distributed_bundle_adjustment(prob, mesh, n_iters=10, chunk=20)
        for k in range(2, len(Ts_true)):
            rot, tr = pose_error(np.asarray(res.kf_Tcw[k]), Ts_true[k])
            assert rot < 0.2 and tr < 0.04, (k, rot, tr)

    def test_runs_on_subset_mesh(self, rng):
        prob, _, _ = build_ba_problem(rng, n_lm=160)
        mesh = make_mesh(4)
        res = distributed_bundle_adjustment(prob, mesh, n_iters=2, chunk=20)
        assert np.isfinite(float(res.cost))


class TestDistributedBA2D:
    """Keyframe-AND-landmark sharded BA on a (kf=2, lm=4) mesh: the column-
    sharded Schur system must reach the same optimum as the single-device
    solver (BASELINE north star: partition keyframes and map blocks per
    host)."""

    def test_matches_single_device(self, rng):
        from hyslam_tpu.parallel.dist_ba import (
            distributed_bundle_adjustment_2d,
        )
        from hyslam_tpu.parallel.mesh import make_mesh_2d

        prob, Ts_true, _ = build_ba_problem(rng, n_kf=8, n_lm=160)
        mesh = make_mesh_2d(8, kf=2)
        assert mesh.shape == {"kf": 2, "lm": 4}
        res_d = distributed_bundle_adjustment_2d(
            prob, mesh, n_iters=6, chunk=20)
        res_s = bundle_adjustment(prob, n_iters=6, chunk=20, solver="cg")
        for k in range(len(Ts_true)):
            rot, tr = pose_error(np.asarray(res_d.kf_Tcw[k]),
                                 np.asarray(res_s.kf_Tcw[k]))
            assert rot < 0.05 and tr < 0.01, (k, rot, tr)
        assert abs(float(res_d.cost) - float(res_s.cost)) \
            < 0.1 * float(res_s.cost) + 5.0

    def test_priors_match_single_device(self, rng):
        """Sensor + tiepoint priors on the keyframe-partitioned path
        (VERDICT r4 missing #6: the 2-D solver rejected priors, so the
        reference's signature BA blocks, BundleAdjustment.cc:60-201,
        could not ride the scaled-out solver)."""
        from hyslam_tpu.parallel.dist_ba import (
            distributed_bundle_adjustment_2d,
        )
        from hyslam_tpu.parallel.mesh import make_mesh_2d
        from hyslam_tpu.solver.priors import empty_pose_priors

        prob, Ts_true, _ = build_ba_problem(rng, n_kf=8, n_lm=160)
        K = prob.kf_Tcw.shape[0]
        Ts = np.stack(Ts_true)
        centers = -np.einsum("kji,kj->ki", Ts[:, :3, :3], Ts[:, :3, 3])
        pr = empty_pose_priors(K, E=1)._replace(
            gps_pos=jnp.asarray(centers.astype(np.float32)),
            gps_info=jnp.full((K, 3), 25.0),
            gps_valid=jnp.asarray(np.arange(K) % 2 == 0),
            tie_a=jnp.asarray([1], jnp.int32),
            tie_b=jnp.asarray([6], jnp.int32),
            tie_T=jnp.asarray(
                (Ts[6] @ np.linalg.inv(Ts[1])).astype(np.float32)[None]),
            tie_info=jnp.asarray([100.0]),
            tie_valid=jnp.asarray([True]),
        )
        prob = prob._replace(priors=pr)
        mesh = make_mesh_2d(8, kf=2)
        res_d = distributed_bundle_adjustment_2d(
            prob, mesh, n_iters=6, chunk=20)
        res_s = bundle_adjustment(prob, n_iters=6, chunk=20, solver="cg")
        for k in range(len(Ts_true)):
            rot, tr = pose_error(np.asarray(res_d.kf_Tcw[k]),
                                 np.asarray(res_s.kf_Tcw[k]))
            assert rot < 0.05 and tr < 0.01, (k, rot, tr)
        assert abs(float(res_d.cost) - float(res_s.cost)) \
            < 0.1 * float(res_s.cost) + 5.0


def test_extract_cameras_sharded_matches_unsharded(rng):
    """Camera-axis-sharded extraction (parallel.multicam) must equal the
    single-device batched program."""
    import jax.numpy as jnp
    from hyslam_tpu.features.atlas import extract_atlas_batch
    from hyslam_tpu.features.extractor import ExtractorConfig
    from hyslam_tpu.parallel.mesh import make_mesh
    from hyslam_tpu.parallel.multicam import extract_cameras_sharded

    cfg = ExtractorConfig(n_features=64, n_levels=3)
    imgs = rng.uniform(0, 255, (8, 96, 128)).astype(np.float32)
    mesh = make_mesh(8)
    out_s = extract_cameras_sharded(jnp.asarray(imgs), cfg, capacity=64,
                                    mesh=mesh)
    out_r = extract_atlas_batch(jnp.asarray(imgs), cfg, capacity=64)
    np.testing.assert_allclose(np.asarray(out_s.uv), np.asarray(out_r.uv),
                               atol=1e-5)
    assert np.array_equal(np.asarray(out_s.desc), np.asarray(out_r.desc))
    assert np.array_equal(np.asarray(out_s.valid), np.asarray(out_r.valid))


def test_extract_cameras_sharded_rejects_indivisible(rng):
    import jax.numpy as jnp
    import pytest
    from hyslam_tpu.features.extractor import ExtractorConfig
    from hyslam_tpu.parallel.mesh import make_mesh
    from hyslam_tpu.parallel.multicam import extract_cameras_sharded

    mesh = make_mesh(8)
    with pytest.raises(ValueError):
        extract_cameras_sharded(
            jnp.zeros((3, 64, 64)), ExtractorConfig(n_features=32, n_levels=2),
            capacity=32, mesh=mesh)


class TestDistributedBACG:
    """Distributed matrix-free PCG: per-CG-step communication is a [K,6]
    psum instead of the dense path's replicated [6K,6K] psum."""

    def test_cg_matches_dense_dist(self, rng):
        prob, Ts_true, _ = build_ba_problem(rng, n_lm=160)
        mesh = make_mesh(8)
        rd = distributed_bundle_adjustment(prob, mesh, n_iters=6, chunk=20,
                                           solver="dense")
        rc = distributed_bundle_adjustment(prob, mesh, n_iters=6, chunk=20,
                                           solver="cg")
        for k in range(len(Ts_true)):
            rot, tr = pose_error(np.asarray(rd.kf_Tcw[k]),
                                 np.asarray(rc.kf_Tcw[k]))
            assert rot < 0.05 and tr < 0.01, (k, rot, tr)

    def test_cg_matches_single_device(self, rng):
        prob, Ts_true, _ = build_ba_problem(rng, n_lm=160)
        mesh = make_mesh(8)
        rc = distributed_bundle_adjustment(prob, mesh, n_iters=6, chunk=20,
                                           solver="cg")
        rs = bundle_adjustment(prob, n_iters=6, chunk=20, solver="cg")
        for k in range(len(Ts_true)):
            rot, tr = pose_error(np.asarray(rc.kf_Tcw[k]),
                                 np.asarray(rs.kf_Tcw[k]))
            assert rot < 0.05 and tr < 0.01, (k, rot, tr)


_ROWS_WORKER = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
sys.path.insert(0, os.getcwd())
from bench_multihost import build_problem
from hyslam_tpu.parallel import dist_ba
from hyslam_tpu.parallel.mesh import make_mesh_2d

prob = build_problem(K=16, L=512, O=4)
mesh = make_mesh_2d(4, kf=2)
ref = dist_ba.distributed_bundle_adjustment_2d(prob, mesh, n_iters=3, chunk=64)
lin, cost = dist_ba._linearize_factors, dist_ba._robust_cost

def lin_rows_differ(*a, **k):
    out = lin(*a, **k)
    row = jax.lax.axis_index("kf").astype(out[0].dtype)
    return (out[0] * (1 + 0.5 * row), out[1] * (1 + 0.5 * row)) + out[2:]

def cost_rows_differ(*a, **k):
    return cost(*a, **k) + 1e3 * jax.lax.axis_index("kf")

dist_ba._linearize_factors = lin_rows_differ
dist_ba._robust_cost = cost_rows_differ
got = dist_ba.distributed_bundle_adjustment_2d(prob, mesh, n_iters=3, chunk=64)
np.testing.assert_allclose(np.asarray(got.kf_Tcw), np.asarray(ref.kf_Tcw),
                           atol=1e-6)
assert float(got.cost) == float(ref.cost)
print("ROWS_AGREE")
'''


def test_2d_replicated_sums_ignore_row_copies():
    """The kf rows of the 2-D mesh hold copies of the same landmark shard;
    on a GPU their partial sums can differ in the last bits (atomic
    scatter-adds). Every replicated sum (normal equations, gradient, cost)
    must come out identical on all devices, or the rows' CG loops run
    different numbers of collectives. Here the copies on kf-row 1 are
    made to differ grossly; the result must equal the unperturbed one.
    Runs in its own process on 4 virtual devices, under a time limit, so
    a deadlock fails the test instead of stalling the suite."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    r = subprocess.run([sys.executable, "-c", _ROWS_WORKER], cwd=repo,
                       env=env | {"JAX_PLATFORMS": "cpu"},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "ROWS_AGREE" in r.stdout, r.stderr[-3000:]
