"""Distributed Schur-complement pose-graph solve (SURVEY.md §2b N14/N15).

BASELINE.json config 5: keyframes partition into contiguous blocks, one per
host. Each host linearizes only its own factors, eliminates its *interior*
poses (those touched by no cross-block factor) with a local dense Cholesky,
and contributes a Schur complement onto the shared *separator* poses
(endpoints of cross-block factors — block boundaries and loop closures).
One `psum` over the graph axis reduces the separator system; every host
solves the same small reduced system (stays replicated, no broadcast) and
back-substitutes its interior update locally. Communication per GN iteration
is exactly one psum of (Ns·6)² + Ns·6 floats — the collective equivalent of
the reference-era MPI gather (the reference itself had no multi-device path
at all, SURVEY.md §2a).

Graph *structure* (partition, separator set) is host-computed per call —
the backend runs once per N keyframes, so a re-trace per graph is cheap; all
*numeric* work (linearize, assemble, eliminate, reduce, back-substitute) is
jitted inside one `shard_map`.

Block routing uses dummy slots: every factor contribution is scatter-added
into H_II, H_IS and H_SS with effective indices that fall on a dummy
row/column unless the endpoint kinds match that matrix — no boolean gathers,
no dynamic shapes.
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from tpu_icp_slam.backend import pose_graph as pg
from tpu_icp_slam.core import se3


@dataclasses.dataclass
class SchurPlan:
    """Host-computed static partition of a PoseGraph (all numpy)."""

    n_blocks: int
    n_active: int  # active pose count
    separator: np.ndarray  # (Ns,) global pose ids
    interior: np.ndarray  # (B, Ni_max) global pose ids, -1 padded
    fidx: np.ndarray  # (B, Fb_max) factor ids, -1 padded
    i_kind: np.ndarray  # (B, Fb_max) 0=interior, 1=separator
    i_slot: np.ndarray  # (B, Fb_max) slot in interior (local) or separator list
    j_kind: np.ndarray
    j_slot: np.ndarray
    block_of_pose: np.ndarray  # (K,)


def make_plan(fi, fj, weight, pose_mask, n_blocks: int) -> SchurPlan:
    """Partition active poses into contiguous blocks; separators = endpoints
    of cross-block factors plus pose 0 (the gauge anchor)."""
    fi = np.asarray(fi)
    fj = np.asarray(fj)
    w = np.asarray(weight)
    mask = np.asarray(pose_mask)
    k = mask.shape[0]
    active = np.flatnonzero(mask)
    n_active = len(active)
    # contiguous ranges over the active poses
    bounds = np.linspace(0, n_active, n_blocks + 1).astype(int)
    block_of_rank = np.zeros(n_active, np.int32)
    for b in range(n_blocks):
        block_of_rank[bounds[b]:bounds[b + 1]] = b
    rank_of_pose = np.full(k, -1, np.int64)
    rank_of_pose[active] = np.arange(n_active)
    block_of_pose = np.full(k, -1, np.int32)
    block_of_pose[active] = block_of_rank

    live = w > 0
    cross = live & (block_of_pose[fi] != block_of_pose[fj])
    sep_ids = np.unique(
        np.concatenate([fi[cross], fj[cross], [0] if mask[0] else []])
    ).astype(np.int64)
    is_sep = np.zeros(k, bool)
    is_sep[sep_ids] = True

    # interior lists per block
    interiors = []
    for b in range(n_blocks):
        ids = active[(block_of_rank == b) & ~is_sep[active]]
        interiors.append(ids)
    ni_max = max(1, max(len(x) for x in interiors))
    interior = np.full((n_blocks, ni_max), -1, np.int64)
    for b, ids in enumerate(interiors):
        interior[b, : len(ids)] = ids

    # factor assignment: to the block of endpoint i (cross factors touch only
    # separators, so any owner is correct)
    owner = np.where(live, block_of_pose[fi], 0)
    fidx_lists = [np.flatnonzero(live & (owner == b)) for b in range(n_blocks)]
    fb_max = max(1, max(len(x) for x in fidx_lists))
    fidx = np.full((n_blocks, fb_max), -1, np.int64)
    for b, ids in enumerate(fidx_lists):
        fidx[b, : len(ids)] = ids

    # endpoint routing tables
    sep_slot = np.full(k, -1, np.int64)
    sep_slot[sep_ids] = np.arange(len(sep_ids))
    int_slot = np.full(k, -1, np.int64)
    for b, ids in enumerate(interiors):
        int_slot[ids] = np.arange(len(ids))

    def route(pid_arr, valid):
        kind = np.where(is_sep[pid_arr], 1, 0).astype(np.int32)
        slot = np.where(is_sep[pid_arr], sep_slot[pid_arr], int_slot[pid_arr])
        slot = np.where(valid, slot, 0).astype(np.int32)
        kind = np.where(valid, kind, 0).astype(np.int32)
        return kind, slot

    valid = fidx >= 0
    fid_safe = np.where(valid, fidx, 0)
    i_kind, i_slot = route(fi[fid_safe], valid)
    j_kind, j_slot = route(fj[fid_safe], valid)
    return SchurPlan(
        n_blocks=n_blocks,
        n_active=n_active,
        separator=sep_ids,
        interior=interior,
        fidx=fidx,
        i_kind=i_kind,
        i_slot=i_slot,
        j_kind=j_kind,
        j_slot=j_slot,
        block_of_pose=block_of_pose,
    )


def _gn_step_distributed(
    poses, pose_mask, fi, fj, T_meas, weight,
    plan_dev, *, ni, ns, huber_delta, damping, anchor_weight, mesh, axis,
):
    """One distributed GN step: returns replicated dx (K, 6)."""
    k = poses.shape[0]
    dtype = poses.dtype
    interior, fidx, i_kind, i_slot, j_kind, j_slot, sep_ids = plan_dev

    def block_fn(interior_b, fidx_b, ik_b, isl_b, jk_b, jsl_b):
        # local shapes: interior_b (1, Ni), fidx_b (1, Fb) etc. — drop lead axis
        interior_b = interior_b[0]
        fidx_b = fidx_b[0]
        ik, isl = ik_b[0], isl_b[0]
        jk, jsl = jk_b[0], jsl_b[0]
        fvalid = (fidx_b >= 0)
        f_safe = jnp.where(fvalid, fidx_b, 0)

        # linearize local factors against the replicated poses
        lfi = fi[f_safe]
        lfj = fj[f_safe]
        Xi = poses[lfi]
        Xj = poses[lfj]
        A = se3.inverse(Xi) @ Xj
        E = se3.inverse(T_meas[f_safe]) @ A
        r = se3.log(E)
        Jr_inv = se3.right_jacobian_inv(r)
        Jj = Jr_inv
        Ji = -(Jr_inv @ se3.adjoint(se3.inverse(A)))
        w = weight[f_safe] * fvalid.astype(dtype)
        if huber_delta > 0.0:
            rn = jnp.linalg.norm(r, axis=-1)
            w = w * jnp.minimum(1.0, huber_delta / jnp.maximum(rn, 1e-12))

        wJi = Ji * w[:, None, None]
        wJj = Jj * w[:, None, None]
        Hii = jnp.einsum("fab,fac->fbc", Ji, wJi)
        Hjj = jnp.einsum("fab,fac->fbc", Jj, wJj)
        Hij = jnp.einsum("fab,fac->fbc", Ji, wJj)
        Hji = jnp.swapaxes(Hij, -1, -2)
        gi = jnp.einsum("fab,fa->fb", wJi, r)
        gj = jnp.einsum("fab,fa->fb", wJj, r)

        # dummy-slot routing: interior index Ni / separator index Ns absorb
        ii = jnp.where(ik == 0, isl, ni)
        si = jnp.where(ik == 1, isl, ns)
        ij = jnp.where(jk == 0, jsl, ni)
        sj = jnp.where(jk == 1, jsl, ns)

        H_II = jnp.zeros((ni + 1, ni + 1, 6, 6), dtype)
        H_IS = jnp.zeros((ni + 1, ns + 1, 6, 6), dtype)
        H_SS = jnp.zeros((ns + 1, ns + 1, 6, 6), dtype)
        g_I = jnp.zeros((ni + 1, 6), dtype)
        g_S = jnp.zeros((ns + 1, 6), dtype)

        # (i,i) diagonal blocks
        H_II = H_II.at[ii, ii].add(Hii)
        H_SS = H_SS.at[si, si].add(Hii)
        # (j,j)
        H_II = H_II.at[ij, ij].add(Hjj)
        H_SS = H_SS.at[sj, sj].add(Hjj)
        # (i,j) off-diagonals: route by kind pair
        H_II = H_II.at[ii, ij].add(Hij)
        H_II = H_II.at[ij, ii].add(Hji)
        H_IS = H_IS.at[ii, sj].add(Hij)
        H_IS = H_IS.at[ij, si].add(Hji)
        H_SS = H_SS.at[si, sj].add(Hij)
        H_SS = H_SS.at[sj, si].add(Hji)
        g_I = g_I.at[ii].add(gi)
        g_S = g_S.at[si].add(gi)
        g_I = g_I.at[ij].add(gj)
        g_S = g_S.at[sj].add(gj)

        # interior diagonal regularization for poses owned by this block;
        # dummy/padded interior slots get identity so the Cholesky is SPD
        int_valid = interior_b >= 0
        int_safe = jnp.where(int_valid, interior_b, 0)
        eye6 = jnp.eye(6, dtype=dtype)
        int_boost = jnp.where(int_valid, damping, 1.0).astype(dtype)
        # pose 0 anchor if it happens to be interior (it is a separator by
        # construction, but stay safe)
        int_boost = int_boost + jnp.where(
            int_valid & (int_safe == 0), anchor_weight, 0.0
        )
        H_II = H_II.at[jnp.arange(ni), jnp.arange(ni)].add(
            int_boost[:ni, None, None] * eye6[None]
        )
        # strip dummies, flatten to matrices
        Hii_m = jnp.transpose(H_II[:ni, :ni], (0, 2, 1, 3)).reshape(ni * 6, ni * 6)
        His_m = jnp.transpose(H_IS[:ni, :ns], (0, 2, 1, 3)).reshape(ni * 6, ns * 6)
        Hss_m = jnp.transpose(H_SS[:ns, :ns], (0, 2, 1, 3)).reshape(ns * 6, ns * 6)
        gI_v = g_I[:ni].reshape(ni * 6)
        gS_v = g_S[:ns].reshape(ns * 6)

        # eliminate interiors: S = Hss - Hsi Hii^-1 His ; rhs = gS - Hsi Hii^-1 gI
        L = jnp.linalg.cholesky(Hii_m)
        rhs_all = jnp.concatenate([His_m, gI_v[:, None]], axis=1)
        y = jax.scipy.linalg.solve_triangular(L, rhs_all, lower=True)
        X = jax.scipy.linalg.solve_triangular(L.T, y, lower=False)
        Xh, xg = X[:, :-1], X[:, -1]
        S_b = Hss_m - His_m.T @ Xh
        rhs_b = gS_v - His_m.T @ xg

        # reduce the separator system across blocks
        S_tot = lax.psum(S_b, axis)
        rhs_tot = lax.psum(rhs_b, axis)
        # separator regularization + anchor (added once: identical on all blocks)
        sep_boost = damping + jnp.where(sep_ids == 0, anchor_weight, 0.0)
        S_tot = S_tot + jnp.diag(jnp.repeat(sep_boost.astype(dtype), 6))
        Ls = jnp.linalg.cholesky(S_tot)
        ys = jax.scipy.linalg.solve_triangular(Ls, -rhs_tot, lower=True)
        dx_S = jax.scipy.linalg.solve_triangular(Ls.T, ys, lower=False)

        # back-substitute interiors: dx_I = -Hii^-1 (gI + His dx_S)
        rhs_i = gI_v + His_m @ dx_S
        yi = jax.scipy.linalg.solve_triangular(L, -rhs_i, lower=True)
        dx_I = jax.scipy.linalg.solve_triangular(L.T, yi, lower=False)

        # scatter into a (K, 6) update: interiors owned here + separators / B
        dx = jnp.zeros((k, 6), dtype)
        dx = dx.at[int_safe].add(
            jnp.where(int_valid[:, None], dx_I.reshape(ni, 6), 0.0)
        )
        nb = lax.psum(jnp.ones((), dtype), axis)
        dx = dx.at[sep_ids].add(dx_S.reshape(ns, 6) / nb)
        dx = lax.psum(dx, axis)
        return dx[None]  # re-add the sharded lead axis

    specs = P(axis)
    fn = jax.shard_map(
        block_fn,
        mesh=mesh,
        in_specs=(specs, specs, specs, specs, specs, specs),
        out_specs=specs,
        check_vma=False,
    )
    dx_all = fn(interior, fidx, i_kind, i_slot, j_kind, j_slot)
    # every block row holds the same replicated dx; take row 0
    return dx_all[0]


def optimize_distributed(
    g: "pg.PoseGraph",
    mesh: jax.sharding.Mesh,
    axis: str = "graph",
    iters: int = 10,
    damping: float = 1e-6,
    huber_delta: float = 0.0,
    anchor_weight: float = 1e6,
):
    """Distributed-Schur GN over `mesh[axis]` blocks; mirrors pg.optimize."""
    n_blocks = mesh.shape[axis]
    plan = make_plan(g.fi, g.fj, g.weight, g.pose_mask, n_blocks)
    ni = plan.interior.shape[1]
    ns = len(plan.separator)
    plan_dev = (
        jnp.asarray(plan.interior),
        jnp.asarray(plan.fidx),
        jnp.asarray(plan.i_kind),
        jnp.asarray(plan.i_slot),
        jnp.asarray(plan.j_kind),
        jnp.asarray(plan.j_slot),
        jnp.asarray(plan.separator),
    )
    # sep_ids is replicated input to every block: broadcast over the axis
    interior, fidx, ik, isl, jk, jsl, sep = plan_dev
    sep_rep = sep  # captured (replicated) inside block_fn

    step_j = _compiled_step(
        mesh, axis, ni, ns, huber_delta, damping, anchor_weight
    )

    graph = g
    chis = []
    plan_args = (interior, fidx, ik, isl, jk, jsl, sep_rep)
    for _ in range(iters):
        r, _, _, w = pg.linearize(graph, huber_delta)
        chis.append(float(jnp.sum(w * jnp.sum(r * r, axis=-1))))
        dx = step_j(
            graph.poses, graph.pose_mask, graph.fi, graph.fj,
            graph.T_meas, graph.weight, plan_args,
        )
        graph = pg.apply_update(graph, dx)
    return graph, np.asarray(chis)


@functools.lru_cache(maxsize=32)
def _compiled_step(mesh, axis, ni, ns, huber_delta, damping, anchor_weight):
    """One jit cache entry per (mesh, partition-shape, hyperparams) — repeat
    optimizations over same-shaped graphs skip the shard_map re-trace."""
    fn = partial(
        _gn_step_distributed,
        ni=ni,
        ns=ns,
        huber_delta=huber_delta,
        damping=damping,
        anchor_weight=anchor_weight,
        mesh=mesh,
        axis=axis,
    )
    return jax.jit(fn)
