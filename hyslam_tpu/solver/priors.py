"""Pose-prior residual blocks for bundle adjustment: GPS / IMU / depth
sensor edges and submap-tiepoint SE3 edges.

Capability parity with the reference's sensor-fusion edge setup
(src/optimizers/BundleAdjustment.cc:60-201) and its custom g2o types
(Thirdparty/g2o/g2o/types/slam3d_addons/SE3_sensor_edges.h:30-115,
EdgeSE3Expmap in types/sba/types_six_dof_expmap.h:108-127):

- IMU:   unary 4-dim residual  q(R_cw) - q_meas   (EdgeIMUQuat; quaternion
         stored (w,x,y,z), hemisphere-aligned before differencing).
- depth: unary 1-dim residual  t_z(Tcw) - d_meas  (EdgeDepth compares the
         z component of the Tcw translation, SE3_sensor_edges.h:73-78).
- GPS:   unary 3-dim residual  camera_center(Tcw) - p_meas with per-axis
         diagonal information. (The reference fits its Horn GPS->SLAM
         alignment on camera CENTERS, BundleAdjustment.cc:116, but its edge
         compares the Tcw TRANSLATION, SE3_sensor_edges.h:105-113; we use
         the center on both sides for self-consistency.)
- tie:   binary 6-dim residual log(T_b^-1 M T_a) between a submap-origin
         keyframe b and its parent tiepoint keyframe a with measurement
         M = Tcw_b Tcw_a^-1 at registration (Tse3Parent, Map.h:72-77;
         SetSubMapOriginEdges, BundleAdjustment.cc:182-201).

array-native design: all priors of one type are linearized as a single
batched jacfwd over the left-multiplicative se3 tangent (the same
parameterization as the reprojection Jacobians in solver.ba), producing
per-pose 6x6 diagonal blocks + a dense off-diagonal block matrix that add
directly into the Schur-reduced camera system — no graph bookkeeping.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from hyslam_tpu.geometry import se3, so3


class PosePriors(NamedTuple):
    """Slot-aligned prior measurements for a BAProblem's K poses.

    All information weights are absolute (reference optParams.Info_* already
    multiplied in). Invalid rows are masked, not compacted (static shapes).
    """

    gps_pos: jnp.ndarray     # [K, 3] target camera center (SLAM frame)
    gps_info: jnp.ndarray    # [K, 3] per-axis diagonal information
    gps_valid: jnp.ndarray   # [K] bool
    imu_quat: jnp.ndarray    # [K, 4] measured world->cam quat (w,x,y,z)
    imu_info: jnp.ndarray    # [K]
    imu_valid: jnp.ndarray   # [K] bool
    depth: jnp.ndarray       # [K] measured t_z of Tcw
    depth_info: jnp.ndarray  # [K]
    depth_valid: jnp.ndarray # [K] bool
    tie_a: jnp.ndarray       # [E] parent keyframe slot
    tie_b: jnp.ndarray       # [E] submap-origin keyframe slot
    tie_T: jnp.ndarray       # [E, 4, 4] measurement M (= Tcw_b Tcw_a^-1)
    tie_info: jnp.ndarray    # [E]
    tie_valid: jnp.ndarray   # [E] bool


def empty_pose_priors(K: int, E: int = 0, dtype=jnp.float32) -> PosePriors:
    return PosePriors(
        gps_pos=jnp.zeros((K, 3), dtype),
        gps_info=jnp.zeros((K, 3), dtype),
        gps_valid=jnp.zeros((K,), bool),
        imu_quat=jnp.tile(jnp.asarray([1.0, 0, 0, 0], dtype), (K, 1)),
        imu_info=jnp.zeros((K,), dtype),
        imu_valid=jnp.zeros((K,), bool),
        depth=jnp.zeros((K,), dtype),
        depth_info=jnp.zeros((K,), dtype),
        depth_valid=jnp.zeros((K,), bool),
        tie_a=jnp.zeros((E,), jnp.int32),
        tie_b=jnp.zeros((E,), jnp.int32),
        tie_T=jnp.tile(jnp.eye(4, dtype=dtype), (E, 1, 1)),
        tie_info=jnp.zeros((E,), dtype),
        tie_valid=jnp.zeros((E,), bool),
    )


def _gps_residual(T, m):
    R = T[:3, :3]
    t = T[:3, 3]
    return (-R.T @ t) - m


def _imu_residual(T, q_meas):
    q = so3.quat_from_mat(T[:3, :3])
    q = jnp.where(jnp.sum(q * q_meas) < 0, -q, q)
    return q - q_meas


def _depth_residual(T, d):
    return (T[2, 3] - d)[None]


def _tie_residual(Ta, Tb, M):
    return se3.log(se3.inverse(Tb) @ M @ Ta)


def _unary_blocks(res_fn, kf_Tcw, meas, w):
    """Batched residual + left-tangent Jacobian for one unary prior type.

    w: [K, d] per-component information (zeros mask invalid rows).
    Returns (H [K,6,6], b [K,6], cost scalar)."""
    dtype = kf_Tcw.dtype
    z6 = jnp.zeros((6,), dtype)

    def one(T, m):
        f = lambda xi: res_fn(se3.exp(xi) @ T, m)
        return f(z6), jax.jacfwd(f)(z6)

    r, J = jax.vmap(one)(kf_Tcw, meas)           # [K,d], [K,d,6]
    H = jnp.einsum("kdi,kd,kdj->kij", J, w, J)
    b = -jnp.einsum("kdi,kd->ki", J, w * r)
    cost = jnp.sum(w * r * r)
    return H, b, cost


def prior_cost(kf_Tcw: jnp.ndarray, pr: PosePriors) -> jnp.ndarray:
    """Total quadratic prior cost (sensor edges carry no robust kernel in
    the reference)."""
    dtype = kf_Tcw.dtype
    r_gps = jax.vmap(_gps_residual)(kf_Tcw, pr.gps_pos)
    r_imu = jax.vmap(_imu_residual)(kf_Tcw, pr.imu_quat)
    r_dep = jax.vmap(_depth_residual)(kf_Tcw, pr.depth)
    cost = jnp.sum(pr.gps_info * pr.gps_valid[:, None] * r_gps**2)
    cost += jnp.sum(pr.imu_info[:, None] * pr.imu_valid[:, None] * r_imu**2)
    cost += jnp.sum(pr.depth_info[:, None] * pr.depth_valid[:, None] * r_dep**2)
    E = pr.tie_a.shape[0]
    if E:
        K = kf_Tcw.shape[0]
        Ta = kf_Tcw[jnp.clip(pr.tie_a, 0, K - 1)]
        Tb = kf_Tcw[jnp.clip(pr.tie_b, 0, K - 1)]
        r_tie = jax.vmap(_tie_residual)(Ta, Tb, pr.tie_T)
        w_tie = pr.tie_info * pr.tie_valid * (pr.tie_a != pr.tie_b)
        cost += jnp.sum(w_tie[:, None] * r_tie**2)
    return cost.astype(dtype)


def linearize_priors_blocks(kf_Tcw: jnp.ndarray, pr: PosePriors):
    """Linearize all priors about kf_Tcw, keeping the tiepoint coupling as
    sparse edge blocks (matrix-free form for the CG reduced-camera solve).

    Returns (Hd [K,6,6] pose-diagonal blocks, b [K,6], Hab [E,6,6] tiepoint
    off-diagonal blocks coupling (pr.tie_a, pr.tie_b)). Hd adds into the BA
    Hpp (so LM damping sees it)."""
    K = kf_Tcw.shape[0]
    dtype = kf_Tcw.dtype

    Hg, bg, _ = _unary_blocks(
        _gps_residual, kf_Tcw, pr.gps_pos, pr.gps_info * pr.gps_valid[:, None]
    )
    Hi, bi, _ = _unary_blocks(
        _imu_residual, kf_Tcw, pr.imu_quat,
        (pr.imu_info * pr.imu_valid)[:, None] * jnp.ones((1, 4), dtype),
    )
    Hz, bz, _ = _unary_blocks(
        _depth_residual, kf_Tcw, pr.depth,
        (pr.depth_info * pr.depth_valid)[:, None],
    )
    Hd = Hg + Hi + Hz
    b = bg + bi + bz

    E = pr.tie_a.shape[0]
    Hab = jnp.zeros((E, 6, 6), dtype)
    if E:
        a = jnp.clip(pr.tie_a, 0, K - 1)
        bb_idx = jnp.clip(pr.tie_b, 0, K - 1)
        Ta = kf_Tcw[a]
        Tb = kf_Tcw[bb_idx]
        z12 = jnp.zeros((12,), dtype)

        def one(Ta1, Tb1, M1):
            def f(xi):
                return _tie_residual(
                    se3.exp(xi[:6]) @ Ta1, se3.exp(xi[6:]) @ Tb1, M1
                )
            return f(z12), jax.jacfwd(f)(z12)

        r, J = jax.vmap(one)(Ta, Tb, pr.tie_T)   # [E,6], [E,6,12]
        Ja, Jb = J[..., :6], J[..., 6:]
        # a degenerate self-edge (a == b, e.g. masked padding rows) would
        # land its off-diagonal block on the diagonal: zero its weight
        w = pr.tie_info * pr.tie_valid * (a != bb_idx)
        Haa = jnp.einsum("edi,e,edj->eij", Ja, w, Ja)
        Hbb = jnp.einsum("edi,e,edj->eij", Jb, w, Jb)
        Hab = jnp.einsum("edi,e,edj->eij", Ja, w, Jb)
        ba_ = -jnp.einsum("edi,ed->ei", Ja, w[:, None] * r)
        bb_ = -jnp.einsum("edi,ed->ei", Jb, w[:, None] * r)
        Hd = Hd.at[a].add(Haa).at[bb_idx].add(Hbb)
        b = b.at[a].add(ba_).at[bb_idx].add(bb_)
    return Hd, b, Hab


def tie_offdiag_matvec(pr: PosePriors, Hab: jnp.ndarray, x: jnp.ndarray,
                       K: int) -> jnp.ndarray:
    """Apply the tiepoint off-diagonal coupling to x [K,6] without
    materializing the [6K,6K] matrix: out[a] += Hab x[b], out[b] += Hab^T
    x[a] for every tiepoint edge."""
    E = pr.tie_a.shape[0]
    if not E:
        return jnp.zeros_like(x)
    a = jnp.clip(pr.tie_a, 0, K - 1)
    bb = jnp.clip(pr.tie_b, 0, K - 1)
    xa = jnp.einsum("eij,ej->ei", Hab, x[bb])
    xb = jnp.einsum("eji,ej->ei", Hab, x[a])
    return jnp.zeros_like(x).at[a].add(xa).at[bb].add(xb)


def tie_offdiag_dense(pr: PosePriors, Hab: jnp.ndarray, K: int,
                      dtype=jnp.float32) -> jnp.ndarray:
    """Materialize the tiepoint off-diagonal coupling as a dense [6K,6K]
    (zero diagonal blocks) — the dense-solve counterpart of
    tie_offdiag_matvec."""
    Hoff = jnp.zeros((K, 6, K, 6), dtype)
    E = pr.tie_a.shape[0]
    if E:
        a = jnp.clip(pr.tie_a, 0, K - 1)
        bb_idx = jnp.clip(pr.tie_b, 0, K - 1)
        Hoff = Hoff.at[a, :, bb_idx, :].add(Hab)
        Hoff = Hoff.at[bb_idx, :, a, :].add(Hab.transpose(0, 2, 1))
    return Hoff.reshape(K * 6, K * 6)


def linearize_priors(kf_Tcw: jnp.ndarray, pr: PosePriors):
    """Linearize all priors about kf_Tcw (dense form).

    Returns (Hd [K,6,6] pose-diagonal blocks, Hoff [6K,6K] off-diagonal
    contributions with zero diagonal blocks, b [K,6]). Hd adds into the BA
    Hpp (so LM damping sees it); Hoff/b fold into the reduced system."""
    K = kf_Tcw.shape[0]
    Hd, b, Hab = linearize_priors_blocks(kf_Tcw, pr)
    return Hd, tie_offdiag_dense(pr, Hab, K, kf_Tcw.dtype), b
