"""Sim3 pose-graph optimization (essential graph).

Replaces Optimizer::OptimizeEssentialGraph (src/optimizers/Optimizer.cc:
283-552): vertices are per-keyframe Sim3 world->cam poses; edges are
spanning-tree links, strong covisibility links (weight >= 100), and loop
edges, each with measurement S_ji = S_j S_i^{-1} captured at edge-creation
time; the loop keyframes start from their Sim3-corrected poses.

Residual per edge: r = log(S_ji_meas o S_i o S_j^{-1})  (7-dof), Jacobians
by forward-mode autodiff over both endpoint tangents. Normal equations are
either assembled dense over [7K, 7K] (K <= a few hundred -> one
dense Cholesky, same strategy as the BA reduced system) or solved
matrix-free with block-Jacobi preconditioned CG over edge-block products
(solver='cg'; memory O(K + E), the K >~ 1k loop-closure path).
"""

from __future__ import annotations

from functools import partial

from hyslam_tpu.utils.precision import f32 as _f32

import jax
import jax.numpy as jnp

from hyslam_tpu.geometry import sim3


def _edge_residual(g_i, g_j, meas_ji):
    """r = log(meas_ji o g_i o g_j^{-1}) [7]."""
    return sim3.log(sim3.compose(meas_ji, sim3.compose(g_i, sim3.inverse(g_j))))


@_f32
@partial(jax.jit, static_argnames=("n_iters", "fix_scale", "solver"))
def optimize_pose_graph(
    g: jnp.ndarray,          # [K, 8] packed Sim3 world->cam (initial)
    fixed: jnp.ndarray,      # [K] bool
    edge_i: jnp.ndarray,     # [E] int32
    edge_j: jnp.ndarray,     # [E] int32
    edge_meas: jnp.ndarray,  # [E, 8] S_ji measurements
    edge_valid: jnp.ndarray, # [E]
    edge_weight: jnp.ndarray | None = None,
    n_iters: int = 20,
    fix_scale: bool = False,
    solver: str = "auto",
):
    """Gauss-Newton/LM over the Sim3 pose graph. Returns g_opt [K, 8].

    solver: 'dense' | 'cg' | 'auto' (cg when K >= 512 — the dense [7K,7K]
    assembly is quadratic in keyframes)."""
    K = g.shape[0]
    if solver == "auto":
        solver = "cg" if K >= 512 else "dense"
    E = edge_i.shape[0]
    if edge_weight is None:
        edge_weight = jnp.ones((E,), g.dtype)
    w = edge_weight * edge_valid.astype(g.dtype)
    ei = jnp.clip(edge_i, 0, K - 1)
    ej = jnp.clip(edge_j, 0, K - 1)

    def res_of(gv):
        return jax.vmap(_edge_residual)(gv[ei], gv[ej], edge_meas)

    def res_tangent(xi2, gi, gj, meas):
        """Residual as function of both endpoint perturbations [14]."""
        di = xi2[:7]
        dj = xi2[7:]
        if fix_scale:
            di = di.at[0].set(0.0)
            dj = dj.at[0].set(0.0)
        return _edge_residual(
            sim3.compose(sim3.exp(di), gi), sim3.compose(sim3.exp(dj), gj), meas
        )

    def lm_iter(state, _):
        gv, lam, _ = state
        r = res_of(gv)                                     # [E, 7]
        J = jax.vmap(
            lambda gi, gj, m: jax.jacfwd(res_tangent)(jnp.zeros(14), gi, gj, m)
        )(gv[ei], gv[ej], edge_meas)                       # [E, 7, 14]
        Ji = J[..., :7]
        Jj = J[..., 7:]

        Hii = jnp.einsum("e,eri,erj->eij", w, Ji, Ji)
        Hjj = jnp.einsum("e,eri,erj->eij", w, Jj, Jj)
        Hij = jnp.einsum("e,eri,erj->eij", w, Ji, Jj)
        bi = -jnp.einsum("e,eri,er->ei", w, Ji, r)
        bj = -jnp.einsum("e,eri,er->ei", w, Jj, r)
        b = jnp.zeros((K, 7), gv.dtype).at[ei].add(bi).at[ej].add(bj)
        free = ~fixed

        if solver == "cg":
            # matrix-free PCG over edge-block products: memory O(K + E),
            # never materializes [7K,7K]
            Hd = (jnp.zeros((K, 7, 7), gv.dtype)
                  .at[ei].add(Hii).at[ej].add(Hjj))         # diag blocks
            dvec = jnp.einsum("kii->ki", Hd)                # [K,7]
            damp = lam * jnp.maximum(dvec, 1e-6)
            fm = free[:, None].astype(gv.dtype)

            def mv(x):
                xz = x * fm
                oi = (jnp.einsum("eij,ej->ei", Hii, xz[ei])
                      + jnp.einsum("eij,ej->ei", Hij, xz[ej]))
                oj = (jnp.einsum("eji,ej->ei", Hij, xz[ei])
                      + jnp.einsum("eij,ej->ei", Hjj, xz[ej]))
                out = (jnp.zeros((K, 7), gv.dtype)
                       .at[ei].add(oi).at[ej].add(oj)) + damp * xz
                return out * fm + x * (1.0 - fm)

            Dp = Hd + jnp.zeros((K, 7, 7), gv.dtype).at[
                :, jnp.arange(7), jnp.arange(7)].add(damp)
            Dp = jnp.where(free[:, None, None], Dp,
                           jnp.eye(7, dtype=gv.dtype))
            Dinv = jnp.linalg.inv(Dp)

            def precond(rr):
                return (jnp.einsum("kij,kj->ki", Dinv, rr) * fm
                        + rr * (1.0 - fm))

            # chain-like graphs condition as O(K^2) under block-Jacobi:
            # let CG run up to ~4K products (each is O(E) — still far
            # cheaper than the O(K^3) dense factorization it replaces)
            dx, _ = jax.scipy.sparse.linalg.cg(
                mv, b * fm, M=precond, tol=1e-6, maxiter=4 * K
            )
        else:
            # assemble dense [K,7,K,7]
            H = jnp.zeros((K, K, 7, 7), gv.dtype)
            H = H.at[ei, ei].add(Hii)
            H = H.at[ej, ej].add(Hjj)
            H = H.at[ei, ej].add(Hij)
            H = H.at[ej, ei].add(jnp.swapaxes(Hij, -1, -2))

            fmask = jnp.repeat(free.astype(gv.dtype), 7)
            Hm = H.transpose(0, 2, 1, 3).reshape(K * 7, K * 7)
            diag = jnp.diag(Hm)
            Hm = Hm + lam * jnp.diag(jnp.maximum(diag, 1e-6))
            Hm = Hm * fmask[:, None] * fmask[None, :] + jnp.diag(1.0 - fmask)
            bv = b.reshape(K * 7) * fmask
            dx = jnp.linalg.solve(Hm, bv).reshape(K, 7)
        if fix_scale:
            dx = dx.at[:, 0].set(0.0)
        dx = jnp.where(jnp.isfinite(dx) & (~fixed)[:, None], dx, 0.0)

        g_new = jax.vmap(lambda d, gg: sim3.compose(sim3.exp(d), gg))(dx, gv)
        g_new = jnp.where(fixed[:, None], gv, g_new)
        cost = jnp.sum(w * jnp.sum(r * r, -1))
        r_new = res_of(g_new)
        cost_new = jnp.sum(w * jnp.sum(r_new * r_new, -1))
        accept = cost_new < cost
        gv_out = jnp.where(accept, g_new, gv)
        lam_out = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e5)
        return (gv_out, lam_out, jnp.minimum(cost_new, cost)), None

    init = (g, jnp.asarray(1e-4, g.dtype), jnp.asarray(jnp.inf, g.dtype))
    (g_out, _, _), _ = jax.lax.scan(lm_iter, init, None, length=n_iters)
    return g_out
