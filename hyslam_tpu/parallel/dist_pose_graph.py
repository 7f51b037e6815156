"""Distributed Sim3 pose-graph optimization: edge-sharded normal equations
reduced over psum.

The essential-graph optimizer (solver.pose_graph, the loop-closing
OptimizeEssentialGraph analog) scales with the edge count (spanning tree +
strong covisibility + loop edges ~ O(K) to O(K^2) edges at loop-closure
time). Here the EDGE axis is sharded over the mesh: every device holds the
replicated [K, 8] pose vector, linearizes its slice of edges, and the dense
[7K, 7K] + [7K] normal equations are reduced with psum across devices before a
replicated solve. Communication per LM iteration is O(K^2) independent of
the edge count — the same reduce-then-solve shape as parallel.dist_ba.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from hyslam_tpu.geometry import sim3
from hyslam_tpu.solver.pose_graph import _edge_residual


def distributed_pose_graph(
    g: jnp.ndarray,           # [K, 8] packed Sim3 world->cam (initial)
    fixed: jnp.ndarray,       # [K] bool
    edge_i: jnp.ndarray,      # [E] int32 (E divisible by the mesh axis)
    edge_j: jnp.ndarray,      # [E] int32
    edge_meas: jnp.ndarray,   # [E, 8] S_ji measurements
    edge_valid: jnp.ndarray,  # [E]
    mesh: Mesh,
    axis: str = "lm",
    edge_weight: jnp.ndarray | None = None,
    n_iters: int = 20,
    fix_scale: bool = False,
):
    """Edge-sharded optimize_pose_graph; same result up to reduction order.

    Pad the edge arrays (edge_valid=False) to a multiple of the mesh axis
    size. Poses are replicated; only edges shard."""
    K = g.shape[0]
    E = edge_i.shape[0]
    n_shards = mesh.shape[axis]
    assert E % n_shards == 0, f"E={E} not divisible by mesh axis {n_shards}"
    if edge_weight is None:
        edge_weight = jnp.ones((E,), g.dtype)

    rep = P()
    sh = P(axis)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(rep, rep, sh, sh, sh, sh, sh),
        out_specs=rep,
        check_vma=False,
    )
    def run(gv0, fixedv, ei_s, ej_s, meas_s, valid_s, wgt_s):
        w = wgt_s * valid_s.astype(gv0.dtype)
        ei = jnp.clip(ei_s, 0, K - 1)
        ej = jnp.clip(ej_s, 0, K - 1)

        def cost_of(gv):
            r = jax.vmap(_edge_residual)(gv[ei], gv[ej], meas_s)
            return jax.lax.psum(jnp.sum(w * jnp.sum(r * r, -1)), axis)

        def res_tangent(xi2, gi, gj, meas):
            di = xi2[:7]
            dj = xi2[7:]
            if fix_scale:
                di = di.at[0].set(0.0)
                dj = dj.at[0].set(0.0)
            return _edge_residual(
                sim3.compose(sim3.exp(di), gi),
                sim3.compose(sim3.exp(dj), gj), meas,
            )

        def lm_iter(state, _):
            gv, lam, cost = state
            r = jax.vmap(_edge_residual)(gv[ei], gv[ej], meas_s)
            J = jax.vmap(
                lambda gi, gj, m: jax.jacfwd(res_tangent)(
                    jnp.zeros(14), gi, gj, m)
            )(gv[ei], gv[ej], meas_s)
            Ji = J[..., :7]
            Jj = J[..., 7:]

            Hii = jnp.einsum("e,eri,erj->eij", w, Ji, Ji)
            Hjj = jnp.einsum("e,eri,erj->eij", w, Jj, Jj)
            Hij = jnp.einsum("e,eri,erj->eij", w, Ji, Jj)
            bi = -jnp.einsum("e,eri,er->ei", w, Ji, r)
            bj = -jnp.einsum("e,eri,er->ei", w, Jj, r)

            H = jnp.zeros((K, K, 7, 7), gv.dtype)
            H = H.at[ei, ei].add(Hii)
            H = H.at[ej, ej].add(Hjj)
            H = H.at[ei, ej].add(Hij)
            H = H.at[ej, ei].add(jnp.swapaxes(Hij, -1, -2))
            b = jnp.zeros((K, 7), gv.dtype).at[ei].add(bi).at[ej].add(bj)

            # THE collective: reduce shard-local normal equations
            H = jax.lax.psum(H, axis)
            b = jax.lax.psum(b, axis)

            free = ~fixedv
            fmask = jnp.repeat(free.astype(gv.dtype), 7)
            Hm = H.transpose(0, 2, 1, 3).reshape(K * 7, K * 7)
            diag = jnp.diag(Hm)
            Hm = Hm + lam * jnp.diag(jnp.maximum(diag, 1e-6))
            Hm = Hm * fmask[:, None] * fmask[None, :] + jnp.diag(1.0 - fmask)
            bv = b.reshape(K * 7) * fmask
            dx = jnp.linalg.solve(Hm, bv).reshape(K, 7)
            if fix_scale:
                dx = dx.at[:, 0].set(0.0)
            dx = jnp.where(jnp.isfinite(dx), dx, 0.0)

            g_new = jax.vmap(lambda d, gg: sim3.compose(sim3.exp(d), gg))(
                dx, gv)
            g_new = jnp.where(fixedv[:, None], gv, g_new)
            cost_new = cost_of(g_new)
            accept = cost_new < cost
            gv_out = jnp.where(accept, g_new, gv)
            lam_out = jnp.clip(
                jnp.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e5)
            return (gv_out, lam_out, jnp.minimum(cost_new, cost)), None

        init = (gv0, jnp.asarray(1e-4, gv0.dtype), cost_of(gv0))
        (g_out, _, _), _ = jax.lax.scan(lm_iter, init, None, length=n_iters)
        return g_out

    return jax.jit(run)(
        g, fixed, edge_i, edge_j, edge_meas, edge_valid, edge_weight
    )
