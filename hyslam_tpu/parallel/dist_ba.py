"""Distributed bundle adjustment: landmark-sharded Schur reduction over psum.

The multi-host scale-out of the BA solver (BASELINE.json north star):
keyframe poses are replicated (small), the landmark axis of the observation
blocks is sharded over the mesh 'lm' axis. Each device linearizes its
landmark slice, contributes partial (Hpp, b_pose, S_red, b_red) which are
reduced with psum across the devices, the dense reduced camera system is solved
replicated, and landmark back-substitution stays shard-local. One LM
iteration is therefore: local einsums + one psum of a [6K, 6K] + [K, 6]
pair + replicated Cholesky-class solve — the communication volume is
independent of the number of landmarks/observations.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from hyslam_tpu.geometry import se3
from hyslam_tpu.solver import robust
from hyslam_tpu.solver.ba import (
    BAProblem,
    BAResult,
    _backsub,
    _linearize_factors,
    _reduced_rhs,
    _schur_reduce_dense,
    _obs_residuals,
    _robust_cost,
    _solve_poses,
    _solve_poses_cg,
)
from hyslam_tpu.solver.priors import (
    PosePriors,
    linearize_priors_blocks,
    prior_cost,
    tie_offdiag_dense,
)


def ba_problem_spec(p: BAProblem) -> BAProblem:
    """PartitionSpec tree for a BAProblem under the 'lm' mesh axis: poses
    and cameras replicated, landmark/observation blocks sharded. Exposed so
    multi-process drivers can build global arrays with the same layout
    (jax.make_array_from_callback) before calling
    distributed_bundle_adjustment."""
    rep = P()
    lm = P("lm")
    return BAProblem(
        kf_Tcw=rep, kf_fixed=rep,
        cams=type(p.cams)(*([rep] * len(p.cams))),
        lm_pos=lm, lm_valid=lm,
        obs=type(p.obs)(*([lm] * len(p.obs))),
        priors=None if p.priors is None
        else PosePriors(*([rep] * len(p.priors))),
    )


def distributed_bundle_adjustment(
    p: BAProblem,
    mesh: Mesh,
    n_iters: int = 10,
    huber: bool = True,
    chunk: int = 256,
    lam0: float = 1e-4,
    solver: str = "auto",
) -> BAResult:
    """LM bundle adjustment with the landmark axis sharded over mesh('lm').

    Requires p.lm_pos.shape[0] divisible by the 'lm' axis size. Produces the
    same result as solver.ba.bundle_adjustment (up to reduction order).

    solver 'dense' psums a replicated [6K,6K] reduced system per LM
    iteration; 'cg' runs distributed matrix-free PCG where every S-product
    psums only a [K,6] — per-iteration communication drops from O(K^2) to
    O(K) and no device ever holds a [6K,6K] (the keyframe-scale path,
    SURVEY §2.10 north star). 'auto' switches to cg at K >= 512."""
    if solver == "auto":
        solver = "cg" if p.kf_Tcw.shape[0] >= 512 else "dense"
    n_shards = mesh.shape["lm"]
    L = p.lm_pos.shape[0]
    assert L % n_shards == 0, f"L={L} not divisible by lm axis {n_shards}"

    prob_spec = ba_problem_spec(p)
    rep = P()
    lm = P("lm")

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(prob_spec,),
        out_specs=(rep, lm, lm, lm, rep),
        check_vma=False,
    )
    def run(pl: BAProblem):
        obs_active = pl.obs.valid
        # priors are pose-only and replicated: keep them out of the
        # shard-local cost/linearization (they would be multiplied by the
        # shard count under psum) and add them once after the reduction
        pl_noprior = pl._replace(priors=None)

        def cost_of(kf_Tcw, lm_pos):
            local = _robust_cost(pl_noprior, kf_Tcw, lm_pos, huber)
            total = jax.lax.psum(local, "lm")
            if pl.priors is not None:
                total = total + prior_cost(kf_Tcw, pl.priors)
            return total

        def step(state, _):
            kf_Tcw, lm_pos, lam, cost = state
            K = kf_Tcw.shape[0]
            Hpp, b_pose, Y, yv, Vinv, Wlo, b_lm, kf_idx = _linearize_factors(
                pl, kf_Tcw, lm_pos, lam, obs_active, huber
            )
            # reduce the pose blocks over landmark shards
            Hpp = jax.lax.psum(Hpp, "lm")
            b_pose = jax.lax.psum(b_pose, "lm")
            Hab = None
            if pl.priors is not None:
                Hd_pr, b_pr, Hab = linearize_priors_blocks(kf_Tcw, pl.priors)
                Hpp = Hpp + Hd_pr
                b_pose = b_pose + b_pr
            if solver == "cg":
                # matrix-free distributed PCG: Y stays shard-local; each
                # S-product psums a [K,6] across the devices
                b_red = _reduced_rhs(Y, yv, kf_idx, K)
                delta_pose = _solve_poses_cg(
                    Hpp, b_pose, b_red, Y, kf_idx, pl.kf_fixed, lam,
                    priors=pl.priors, Hab=Hab, psum_axis="lm",
                )
            else:
                S_red, b_red = _schur_reduce_dense(Y, yv, kf_idx, K, chunk)
                # the [6K,6K] collective at the heart of dense distributed BA
                S_red = jax.lax.psum(S_red, "lm")
                b_red = jax.lax.psum(b_red, "lm")
                if pl.priors is not None:
                    S_red = S_red - tie_offdiag_dense(
                        pl.priors, Hab, K, Hpp.dtype)
                delta_pose = _solve_poses(Hpp, b_pose, S_red, b_red,
                                          pl.kf_fixed, lam)
            delta_lm = _backsub(Vinv, Wlo, b_lm, kf_idx, delta_pose, pl.lm_valid)

            kf_new = se3.exp(delta_pose) @ kf_Tcw
            kf_new = jnp.where(pl.kf_fixed[:, None, None], kf_Tcw, kf_new)
            lm_new = lm_pos + delta_lm
            new_cost = cost_of(kf_new, lm_new)
            accept = new_cost < cost
            kf_out = jnp.where(accept, kf_new, kf_Tcw)
            lm_out = jnp.where(accept, lm_new, lm_pos)
            lam_out = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e4)
            return (kf_out, lm_out, lam_out, jnp.minimum(new_cost, cost)), None

        cost0 = cost_of(pl.kf_Tcw, pl.lm_pos)
        init = (pl.kf_Tcw, pl.lm_pos, jnp.asarray(lam0, pl.kf_Tcw.dtype), cost0)
        (kf_Tcw, lm_pos, _, cost), _ = jax.lax.scan(step, init, None, length=n_iters)

        r, pc, _, _ = _obs_residuals(pl, kf_Tcw, lm_pos)
        c2 = pl.obs.inv_sigma2 * jnp.sum(r * r, axis=-1)
        th = jnp.where(pl.obs.stereo, robust.CHI2_STEREO, robust.CHI2_MONO)
        inlier = pl.obs.valid & (c2 <= th) & (pc[..., 2] > 0.0)
        return kf_Tcw, lm_pos, inlier, c2, cost

    kf_Tcw, lm_pos, inlier, c2, cost = jax.jit(run)(p)
    return BAResult(
        kf_Tcw=kf_Tcw, lm_pos=lm_pos, obs_chi2=c2, obs_inlier=inlier, cost=cost
    )


# ---------------------------------------------------------------------------
# 2-D (kf x lm) sharded BA — keyframe AND map-block partitioning
# ---------------------------------------------------------------------------

def _schur_cols(Y, y, kf_idx, K: int, Kb: int, col0, chunk: int):
    """Column-block Schur reduction: returns (S_cb [6K, 6Kb], b_red [K,6])
    where S_cb holds this kf-shard's 6Kb COLUMNS of the (landmark-shard
    partial) reduced term  sum_l A_l A_l^T.  Each kf-shard does 1/n_kf of
    the rank-3C matmul flops and stores 1/n_kf of the [6K,6K] — the
    keyframe-axis partition of the reduced camera system (BASELINE north
    star: "partition keyframes and map blocks per host")."""
    L, O = kf_idx.shape
    dtype = Y.dtype
    n_chunks = (L + chunk - 1) // chunk
    Lp = n_chunks * chunk
    pad = Lp - L

    def padL(x):
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

    Y_p = padL(Y).reshape(n_chunks, chunk, O, 6, 3)
    y_p = padL(y).reshape(n_chunks, chunk, 3)
    kf_p = padL(kf_idx).reshape(n_chunks, chunk, O)

    def chunk_step(carry, inp):
        S_acc, bh_acc = carry
        Yc, yc, kfc = inp
        Z = jnp.zeros((chunk, K, 6, 3), dtype)
        lidx = jnp.broadcast_to(jnp.arange(chunk)[:, None], (chunk, O))
        Z = Z.at[lidx.reshape(-1), kfc.reshape(-1)].add(Yc.reshape(-1, 6, 3))
        Zf = Z.transpose(0, 3, 1, 2).reshape(chunk * 3, K * 6)
        Zcols = jax.lax.dynamic_slice_in_dim(Zf, col0 * 6, Kb * 6, axis=1)
        S_acc = S_acc + Zf.T @ Zcols                       # [6K, 6Kb]
        bh_acc = bh_acc + jnp.einsum("lkab,lb->ka", Z, yc)
        return (S_acc, bh_acc), None

    S0 = jnp.zeros((K * 6, Kb * 6), dtype)
    bh0 = jnp.zeros((K, 6), dtype)
    (S_cb, b_red), _ = jax.lax.scan(chunk_step, (S0, bh0), (Y_p, y_p, kf_p))
    return S_cb, b_red


def distributed_bundle_adjustment_2d(
    p: BAProblem,
    mesh: Mesh,
    n_iters: int = 10,
    huber: bool = True,
    chunk: int = 256,
    lam0: float = 1e-4,
) -> BAResult:
    """LM bundle adjustment on a 2-D ('kf', 'lm') mesh.

    Layout: landmark/observation blocks sharded over 'lm' (map blocks per
    host); the reduced camera system's column blocks sharded over 'kf'
    (keyframe blocks per host). Per CG step each device multiplies its
    [6K, 6K/n_kf] column block by its x-block and the result is psum'ed
    over BOTH axes — compute and memory of the Schur system drop by n_kf
    while communication stays O(K) per step. Poses/cameras replicated
    (small). Produces the same result as solver.ba.bundle_adjustment.

    Requires K divisible by mesh 'kf' and L divisible by mesh 'lm'.

    PosePriors (IMU/GPS/depth unary edges + submap tiepoint SE3 edges —
    the reference's signature BA blocks, BundleAdjustment.cc:60-201) ride
    replicated like the poses: their diagonal blocks add into Hpp AFTER
    the landmark psum, and the tiepoint off-diagonal coupling applies
    matrix-free inside every CG product (tie_offdiag_matvec), outside the
    collectives so no shard-count scaling occurs."""
    from hyslam_tpu.solver.ba import _reduced_diag
    from hyslam_tpu.solver.priors import tie_offdiag_matvec

    n_kf = mesh.shape["kf"]
    n_lm = mesh.shape["lm"]
    K = p.kf_Tcw.shape[0]
    L = p.lm_pos.shape[0]
    assert K % n_kf == 0, f"K={K} not divisible by kf axis {n_kf}"
    assert L % n_lm == 0, f"L={L} not divisible by lm axis {n_lm}"
    Kb = K // n_kf

    rep = P()
    lm = P("lm")
    prob_spec = BAProblem(
        kf_Tcw=rep, kf_fixed=rep,
        cams=type(p.cams)(*([rep] * len(p.cams))),
        lm_pos=lm, lm_valid=lm,
        obs=type(p.obs)(*([lm] * len(p.obs))),
        priors=None if p.priors is None
        else PosePriors(*([rep] * len(p.priors))),
    )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(prob_spec,),
        out_specs=(rep, lm, lm, lm, rep),
        check_vma=False,
    )
    def run(pl: BAProblem):
        obs_active = pl.obs.valid
        my_kf = jax.lax.axis_index("kf")
        col0 = my_kf * Kb

        def lm_sum(x):
            """Sum over landmark shards, bitwise identical on every device.
            The kf rows hold copies of the same landmark shard, but a GPU
            scatter-add (atomics) can leave the copies' partials different
            in the last bits; summed over 'lm' alone, the rows would then
            disagree, and the CG loop, whose trip count follows these
            values, would issue a different number of collectives per row
            and deadlock. Row 0 contributes, the other rows add zero."""
            return jax.lax.psum(jnp.where(my_kf == 0, x, jnp.zeros_like(x)),
                                ("kf", "lm"))

        # priors are replicated pose-only blocks: keep them out of the
        # shard-local cost/linearization and add them once post-reduction
        pl_noprior = pl._replace(priors=None)

        def cost_of(kf_Tcw, lm_pos):
            local = _robust_cost(pl_noprior, kf_Tcw, lm_pos, huber)
            total = lm_sum(local)
            if pl.priors is not None:
                total = total + prior_cost(kf_Tcw, pl.priors)
            return total

        def step(state, _):
            kf_Tcw, lm_pos, lam, cost = state
            Hpp, b_pose, Y, yv, Vinv, Wlo, b_lm, kf_idx = _linearize_factors(
                pl_noprior, kf_Tcw, lm_pos, lam, obs_active, huber
            )
            Hpp = lm_sum(Hpp)
            b_pose = lm_sum(b_pose)
            Hab = None
            if pl.priors is not None:
                Hd_pr, b_pr, Hab = linearize_priors_blocks(kf_Tcw, pl.priors)
                Hpp = Hpp + Hd_pr
                b_pose = b_pose + b_pr
            S_cb, b_red = _schur_cols(Y, yv, kf_idx, K, Kb, col0, chunk)
            b_red = lm_sum(b_red)

            dtype = Hpp.dtype
            Hpp_d = Hpp + lam * jnp.eye(6, dtype=dtype) * jnp.maximum(
                jnp.einsum("kii->k", Hpp)[:, None, None] / 6.0, 1e-6
            )
            free = (~pl.kf_fixed) & (jnp.einsum("kii->k", Hpp) > 0)
            fm = free[:, None].astype(dtype)

            def S_mv(x):
                xz = (x * fm).reshape(K * 6)
                xb = jax.lax.dynamic_slice_in_dim(xz, col0 * 6, Kb * 6)
                red = jax.lax.psum(
                    (S_cb @ xb).reshape(K, 6), ("kf", "lm"))
                out = jnp.einsum("kij,kj->ki", Hpp_d, x * fm) - red
                if pl.priors is not None and Hab is not None:
                    # replicated (outside the collectives: no shard-count
                    # scaling) tiepoint off-diagonal coupling
                    out = out + tie_offdiag_matvec(pl.priors, Hab,
                                                   x * fm, K)
                return out * fm + x * (1.0 - fm)

            D = Hpp_d - lm_sum(_reduced_diag(Y, kf_idx, K))
            D = jnp.where(free[:, None, None], D, jnp.eye(6, dtype=dtype))
            Dinv = jnp.linalg.inv(D)

            def precond(r):
                return jnp.einsum("kij,kj->ki", Dinv, r) * fm + r * (1.0 - fm)

            bhat = (b_pose - b_red) * fm
            delta_pose, _ = jax.scipy.sparse.linalg.cg(
                S_mv, bhat, M=precond, tol=1e-5, maxiter=200
            )
            delta_pose = jnp.where(
                jnp.isfinite(delta_pose) & free[:, None], delta_pose, 0.0)
            delta_lm = _backsub(Vinv, Wlo, b_lm, kf_idx, delta_pose,
                                pl.lm_valid)

            kf_new = se3.exp(delta_pose) @ kf_Tcw
            kf_new = jnp.where(pl.kf_fixed[:, None, None], kf_Tcw, kf_new)
            lm_new = lm_pos + delta_lm
            new_cost = cost_of(kf_new, lm_new)
            accept = new_cost < cost
            kf_out = jnp.where(accept, kf_new, kf_Tcw)
            lm_out = jnp.where(accept, lm_new, lm_pos)
            lam_out = jnp.clip(
                jnp.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e4)
            return (kf_out, lm_out, lam_out,
                    jnp.minimum(new_cost, cost)), None

        cost0 = cost_of(pl.kf_Tcw, pl.lm_pos)
        init = (pl.kf_Tcw, pl.lm_pos, jnp.asarray(lam0, pl.kf_Tcw.dtype),
                cost0)
        (kf_Tcw, lm_pos, _, cost), _ = jax.lax.scan(
            step, init, None, length=n_iters)

        r, pc, _, _ = _obs_residuals(pl, kf_Tcw, lm_pos)
        c2 = pl.obs.inv_sigma2 * jnp.sum(r * r, axis=-1)
        th = jnp.where(pl.obs.stereo, robust.CHI2_STEREO, robust.CHI2_MONO)
        inlier = pl.obs.valid & (c2 <= th) & (pc[..., 2] > 0.0)
        return kf_Tcw, lm_pos, inlier, c2, cost

    kf_Tcw, lm_pos, inlier, c2, cost = jax.jit(run)(p)
    return BAResult(
        kf_Tcw=kf_Tcw, lm_pos=lm_pos, obs_chi2=c2, obs_inlier=inlier,
        cost=cost
    )
