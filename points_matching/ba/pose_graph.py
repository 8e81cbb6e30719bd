"""Pose-graph optimization (SURVEY.md §7 stage 6: "Pose-graph optimizer
(SE(3) retraction) for loop closure" — absent in the reference, which has no
trajectory at all).

Problem: poses T_i (world→camera) and relative measurements Z_ij ≈ T_i T_j⁻¹
from odometry and loop closures.  Cost = Σ ‖log(Z_ij⁻¹ T_i T_j⁻¹)‖²_Λ.

Shape discipline: the edge list is fixed-capacity
(``edges_i/edges_j/Z/weight/mask`` arrays), residuals and Jacobians evaluate
batched over edges (elementwise), and the Gauss-Newton normal equations assemble by
segment-sum scatter-adds into the [P, 6, 6] block structure — then one dense
Cholesky on the (small) pose system.  The whole GN loop is one jit region
(``lax.while_loop``), like ``ba/lm.py``.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from points_matching.core import struct
from jax import Array

from points_matching.core.types import Pose
from points_matching.geometry.se3 import se3_exp, se3_log


@struct.dataclass
class PoseGraph:
    """Fixed-capacity pose graph.

    Attributes:
      poses:   Pose with [P] batch — current estimates (world→camera).
      edges_i: [E] int32 — source pose index.
      edges_j: [E] int32 — target pose index.
      Z:       Pose with [E] batch — measured relative transform T_i T_j⁻¹.
      weight:  [E] float32 — per-edge information scale (loop vs odom).
      mask:    [E] bool — valid edges.
      fixed:   [P] bool — gauge-fixed poses (typically pose 0).
    """

    poses: Pose
    edges_i: Array
    edges_j: Array
    Z: Pose
    weight: Array
    mask: Array
    fixed: Array

    @property
    def num_poses(self) -> int:
        return self.poses.t.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edges_i.shape[0]


def edge_residuals(g: PoseGraph) -> Array:
    """[E, 6] SE(3) log residuals log(Z⁻¹ T_i T_j⁻¹) (masked → 0)."""
    Ti = jax.tree.map(lambda a: a[g.edges_i], g.poses)
    Tj = jax.tree.map(lambda a: a[g.edges_j], g.poses)
    rel = Ti.compose(Tj.inverse())            # T_i T_j⁻¹
    err = g.Z.inverse().compose(rel)          # Z⁻¹ (T_i T_j⁻¹)
    r = se3_log(err.R, err.t)
    return jnp.where(g.mask[:, None], r, 0.0)


def pose_graph_cost(g: PoseGraph) -> Array:
    r = edge_residuals(g)
    return 0.5 * jnp.sum(g.weight * g.mask * jnp.sum(r * r, axis=-1))


def _edge_jacobians(g: PoseGraph) -> Tuple[Array, Array, Array]:
    """Residual + Jacobians wrt left-multiplicative tangents of T_i and T_j.

    Exact forward-mode derivatives of r(ξi, ξj) = log(Z⁻¹ exp(ξi)T_i
    (exp(ξj)T_j)⁻¹) at ξ = 0, vmapped over the edge list.
    Returns (r [E, 6], Ji [E, 6, 6], Jj [E, 6, 6]).
    """
    z6 = jnp.zeros((6,), g.poses.t.dtype)

    def res_one(xi, xj, Ri, ti, Rj, tj, Rz, tz):
        Rdi, tdi = se3_exp(xi)
        Rdj, tdj = se3_exp(xj)
        Ri_n, ti_n = Rdi @ Ri, Rdi @ ti + tdi
        Rj_n, tj_n = Rdj @ Rj, Rdj @ tj + tdj
        # rel = T_i T_j⁻¹
        Rrel = Ri_n @ Rj_n.T
        trel = ti_n - Rrel @ tj_n
        # err = Z⁻¹ rel
        Re = Rz.T @ Rrel
        te = Rz.T @ (trel - tz)
        return se3_log(Re, te)

    def one(i, j, Rz, tz):
        Ri, ti = g.poses.R[i], g.poses.t[i]
        Rj, tj = g.poses.R[j], g.poses.t[j]
        f = lambda xi, xj: res_one(xi, xj, Ri, ti, Rj, tj, Rz, tz)
        r = f(z6, z6)
        Ji = jax.jacfwd(f, argnums=0)(z6, z6)
        Jj = jax.jacfwd(f, argnums=1)(z6, z6)
        return r, Ji, Jj

    r, Ji, Jj = jax.vmap(one)(g.edges_i, g.edges_j, g.Z.R, g.Z.t)
    m = g.mask[:, None]
    return (
        jnp.where(m, r, 0.0),
        jnp.where(m[..., None], Ji, 0.0),
        jnp.where(m[..., None], Jj, 0.0),
    )


class PGOStats(NamedTuple):
    iterations: Array
    initial_cost: Array
    final_cost: Array


def _solve_dense(g: PoseGraph, Hii, Hjj, Hij, b, damping) -> Array:
    """Materialize [6P, 6P] and Cholesky-solve — exact, O(P²) memory."""
    P = g.num_poses
    H = jnp.zeros((P, 6, P, 6), b.dtype)
    H = H.at[g.edges_i, :, g.edges_i, :].add(Hii)
    H = H.at[g.edges_j, :, g.edges_j, :].add(Hjj)
    H = H.at[g.edges_i, :, g.edges_j, :].add(Hij)
    H = H.at[g.edges_j, :, g.edges_i, :].add(jnp.swapaxes(Hij, -1, -2))

    # Gauge fixing: project fixed poses out of the system.
    free = (~g.fixed).astype(b.dtype)
    Hd = H.reshape(P * 6, P * 6)
    fr = jnp.repeat(free, 6)
    Hd = Hd * fr[:, None] * fr[None, :]
    Hd = Hd + jnp.diag(jnp.where(fr > 0, damping, 1.0))
    bd = b.reshape(P * 6) * fr

    L = jnp.linalg.cholesky(Hd + 1e-9 * jnp.eye(P * 6, dtype=b.dtype))
    return jax.scipy.linalg.cho_solve((L, True), bd).reshape(P, 6)


def _solve_pcg(g: PoseGraph, Hii, Hjj, Hij, b, damping,
               iterations: int) -> Array:
    """Matrix-free block-sparse PCG (VERDICT r1 item 10).

    Never materializes [6P, 6P]: the Hessian-vector product gathers x at
    the edge endpoints, applies the per-edge 6×6 blocks (batched einsum —
    matmul work), and scatter-adds back — O(E·36) memory, so KITTI-00-length
    trajectories (thousands of poses) fit.  Block-Jacobi preconditioner
    from the exact 6×6 diagonal blocks.
    """
    P = g.num_poses
    free = (~g.fixed).astype(b.dtype)[:, None]          # [P, 1]
    b = b * free

    def hv(x: Array) -> Array:
        x = x * free
        xi = x[g.edges_i]
        xj = x[g.edges_j]
        ci = jnp.einsum("eij,ej->ei", Hii, xi) + jnp.einsum(
            "eij,ej->ei", Hij, xj)
        cj = jnp.einsum("eji,ej->ei", Hij, xi) + jnp.einsum(
            "eij,ej->ei", Hjj, xj)
        out = jax.ops.segment_sum(ci, g.edges_i, num_segments=P)
        out = out + jax.ops.segment_sum(cj, g.edges_j, num_segments=P)
        return (out + damping * x) * free

    # Block-Jacobi: exact diagonal blocks, damped; identity on fixed poses
    # (their rows of b are zero, so PCG keeps them at zero).
    D = jax.ops.segment_sum(Hii, g.edges_i, num_segments=P)
    D = D + jax.ops.segment_sum(Hjj, g.edges_j, num_segments=P)
    D = D + damping * jnp.eye(6, dtype=b.dtype)
    D = jnp.where(g.fixed[:, None, None], jnp.eye(6, dtype=b.dtype), D)
    Minv = jnp.linalg.inv(D)
    precond = lambda r: jnp.einsum("pij,pj->pi", Minv, r) * free

    x = jnp.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = jnp.sum(r * z)

    def body(_, carry):
        x, r, p, rz = carry
        Ap = hv(p)
        alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-20)
        p = z + beta * p
        return x, r, p, rz_new

    x, _, _, _ = jax.lax.fori_loop(0, iterations, body, (x, r, p, rz))
    return x


# Above this many poses the dense [6P, 6P] Cholesky is replaced by the
# matrix-free PCG under solver="auto" (dense is exact and faster when small).
_DENSE_POSE_LIMIT = 384


@partial(jax.jit, static_argnames=("max_iterations", "solver",
                                   "pcg_iterations"))
def optimize_pose_graph(
    g: PoseGraph,
    max_iterations: int = 20,
    damping: float = 1e-6,
    rtol: float = 1e-9,
    solver: str = "auto",
    pcg_iterations: int = 100,
) -> Tuple[PoseGraph, PGOStats]:
    """Gauss-Newton (lightly damped) pose-graph optimization.

    ``solver``: "dense" (Cholesky on the materialized [6P, 6P] system),
    "pcg" (matrix-free block-sparse PCG — linear memory in edges), or
    "auto" (dense up to ``_DENSE_POSE_LIMIT`` poses, PCG beyond).
    """
    P = g.num_poses
    if solver == "auto":
        solver = "dense" if P <= _DENSE_POSE_LIMIT else "pcg"
    if solver not in ("dense", "pcg"):
        raise ValueError(f"unknown pose-graph solver: {solver!r}")
    cost0 = pose_graph_cost(g)

    def step(carry):
        g, cost, it, done = carry
        r, Ji, Jj = _edge_jacobians(g)
        w = (g.weight * g.mask).astype(r.dtype)

        # Per-edge normal-equation blocks.
        Hii = jnp.einsum("e,eki,ekj->eij", w, Ji, Ji)
        Hjj = jnp.einsum("e,eki,ekj->eij", w, Jj, Jj)
        Hij = jnp.einsum("e,eki,ekj->eij", w, Ji, Jj)
        bi = -jnp.einsum("e,eki,ek->ei", w, Ji, r)
        bj = -jnp.einsum("e,eki,ek->ei", w, Jj, r)
        b = jnp.zeros((P, 6), r.dtype)
        b = b.at[g.edges_i].add(bi)
        b = b.at[g.edges_j].add(bj)

        if solver == "dense":
            dx = _solve_dense(g, Hii, Hjj, Hij, b, damping)
        else:
            dx = _solve_pcg(g, Hii, Hjj, Hij, b, damping, pcg_iterations)
        dx = jnp.where(g.fixed[:, None], 0.0, dx)

        Rd, td = se3_exp(dx)
        newR = Rd @ g.poses.R
        newt = jnp.einsum("pij,pj->pi", Rd, g.poses.t) + td
        g_new = g.replace(poses=Pose(R=newR, t=newt))
        new_cost = pose_graph_cost(g_new)

        accept = new_cost < cost
        g = jax.tree.map(lambda a, b_: jnp.where(accept, a, b_), g_new, g)
        cost_next = jnp.where(accept, new_cost, cost)
        rel = jnp.abs(cost - cost_next) / jnp.maximum(cost, 1e-12)
        done = jnp.logical_or(~accept, rel < rtol)
        return g, cost_next, it + 1, done

    def cond(carry):
        _, _, it, done = carry
        return jnp.logical_and(it < max_iterations, jnp.logical_not(done))

    g, cost, it, _ = jax.lax.while_loop(
        cond, step, (g, cost0, jnp.asarray(0), jnp.asarray(False))
    )
    return g, PGOStats(iterations=it, initial_cost=cost0, final_cost=cost)


def make_odometry_chain(
    poses_gt: Pose,
    key: Array,
    odom_noise: float = 0.01,
    loop_edges: Tuple[Tuple[int, int], ...] = (),
    loop_weight: float = 10.0,
) -> PoseGraph:
    """Build a test pose graph: noisy odometry chain + exact loop closures."""
    Pn = poses_gt.t.shape[0]
    ei = jnp.arange(Pn - 1, dtype=jnp.int32)
    ej = ei + 1

    Ti = jax.tree.map(lambda a: a[ei], poses_gt)
    Tj = jax.tree.map(lambda a: a[ej], poses_gt)
    Z = Ti.compose(Tj.inverse())
    if odom_noise > 0:
        xi = odom_noise * jax.random.normal(key, (Pn - 1, 6))
        Rd, td = se3_exp(xi)
        Z = Pose(R=Rd @ Z.R, t=jnp.einsum("eij,ej->ei", Rd, Z.t) + td)
    w = jnp.ones((Pn - 1,), jnp.float32)

    if loop_edges:
        li = jnp.asarray([a for a, _ in loop_edges], jnp.int32)
        lj = jnp.asarray([b for _, b in loop_edges], jnp.int32)
        Tli = jax.tree.map(lambda a: a[li], poses_gt)
        Tlj = jax.tree.map(lambda a: a[lj], poses_gt)
        Zl = Tli.compose(Tlj.inverse())
        ei = jnp.concatenate([ei, li])
        ej = jnp.concatenate([ej, lj])
        Z = Pose(
            R=jnp.concatenate([Z.R, Zl.R]), t=jnp.concatenate([Z.t, Zl.t])
        )
        w = jnp.concatenate([w, loop_weight * jnp.ones((li.shape[0],), jnp.float32)])

    E = ei.shape[0]
    return PoseGraph(
        poses=poses_gt,
        edges_i=ei,
        edges_j=ej,
        Z=Z,
        weight=w,
        mask=jnp.ones((E,), bool),
        fixed=jnp.arange(Pn) == 0,
    )
