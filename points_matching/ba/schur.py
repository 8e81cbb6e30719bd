"""Schur-complement reduction for the BA normal equations.

Structure: the Gauss-Newton system on (camera, landmark) unknowns is

    [ U   W ] [dc]   [bc]
    [ Wᵀ  V ] [dl] = [bl]

with U block-diag over cameras (6×6), V block-diag over landmarks (3×3) and
W the camera×landmark coupling.  Eliminating landmarks gives the reduced
camera system  S dc = g,  S = U − W V⁻¹ Wᵀ,  g = bc − W V⁻¹ bl — then
dl = V⁻¹ (bl − Wᵀ dc).

On the dense [C, L] grid every step is an einsum or a batched 3×3
inverse (elementwise): S assembly is the ``clik,lkm,dljm->cidj`` contraction —
exactly the "Schur GEMMs" BASELINE designates as the matmul-bound BA kernel.
The same contraction distributes: shard L over devices, psum S and g
(see ``parallel/sharded_ba.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import Array


class NormalEqBlocks(NamedTuple):
    U: Array   # [C, 6, 6]
    V: Array   # [L, 3, 3]
    W: Array   # [C, L, 6, 3]
    bc: Array  # [C, 6]
    bl: Array  # [L, 3]


def build_normal_equations(
    r: Array, Jc: Array, Jl: Array, weights: Array
) -> NormalEqBlocks:
    """Weighted GN blocks from grid residuals/Jacobians.

    Args:
      r:  [C, L, 2]; Jc: [C, L, 2, 6]; Jl: [C, L, 2, 3];
      weights: [C, L] (IRLS/robust × validity; 0 for invalid cells).
    """
    w = weights[..., None, None]
    U = jnp.einsum("clki,clkj->cij", Jc * w[..., 0:1, :], Jc)
    V = jnp.einsum("clki,clkj->lij", Jl * w[..., 0:1, :], Jl)
    W = jnp.einsum("clki,clkj->clij", Jc * w[..., 0:1, :], Jl)
    wr = r * weights[..., None]
    bc = -jnp.einsum("clki,clk->ci", Jc, wr)
    bl = -jnp.einsum("clki,clk->li", Jl, wr)
    return NormalEqBlocks(U=U, V=V, W=W, bc=bc, bl=bl)


def _damp(M: Array, lam: Array) -> Array:
    """Levenberg damping: M + λ·diag(M) + λ·εI (keeps blocks SPD)."""
    d = jnp.einsum("...ii->...i", M)
    eye = jnp.eye(M.shape[-1], dtype=M.dtype)
    return M + lam * (d[..., None] * eye) + 1e-9 * eye


def _inv3(V: Array) -> Array:
    """Batched closed-form 3×3 symmetric inverse (adjugate/det — cheaper and
    more fusable than LU for this size)."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    e, f_ = V[..., 1, 1], V[..., 1, 2]
    i = V[..., 2, 2]
    A = e * i - f_ * f_
    B = c * f_ - b * i
    C = b * f_ - c * e
    E = a * i - c * c
    F = b * c - a * f_
    I = a * e - b * b
    det = a * A + b * B + c * C
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    rows = [
        jnp.stack([A, B, C], axis=-1),
        jnp.stack([B, E, F], axis=-1),
        jnp.stack([C, F, I], axis=-1),
    ]
    return jnp.stack(rows, axis=-2) / det[..., None, None]


def schur_reduce(
    blocks: NormalEqBlocks, lam: Array
) -> Tuple[Array, Array, Array]:
    """Damped Schur complement.

    Returns (S [C, 6, C, 6] reduced camera Hessian, g [C, 6], Vinv [L, 3, 3]).
    """
    C = blocks.U.shape[0]
    U = _damp(blocks.U, lam)
    V = _damp(blocks.V, lam)
    Vinv = _inv3(V)

    # Y_{c,l} = W_{c,l} V_l⁻¹ : [C, L, 6, 3]
    Y = jnp.einsum("clij,ljk->clik", blocks.W, Vinv)
    # S_{c,d} = δ U_c − Σ_l Y_{c,l} W_{d,l}ᵀ  (contraction over l, 3)
    S_off = jnp.einsum("clik,dljk->cidj", Y, blocks.W)
    S = -S_off
    idx = jnp.arange(C)
    S = S.at[idx, :, idx, :].add(U)
    g = blocks.bc - jnp.einsum("clik,lk->ci", Y, blocks.bl)
    return S, g, Vinv


def solve_schur(
    blocks: NormalEqBlocks, lam: Array
) -> Tuple[Array, Array]:
    """Solve the damped GN system via dense Cholesky on the reduced camera
    system + landmark back-substitution.

    Returns (dc [C, 6], dl [L, 3]).
    """
    C = blocks.U.shape[0]
    S, g, Vinv = schur_reduce(blocks, lam)
    Sd = S.reshape(C * 6, C * 6)
    gd = g.reshape(C * 6)
    # solve via Cholesky (S is SPD after damping)
    Lc = jnp.linalg.cholesky(Sd)
    dc = jax.scipy.linalg.cho_solve((Lc, True), gd).reshape(C, 6)
    # back-substitute landmarks: dl = V⁻¹ (bl − Wᵀ dc)
    rhs = blocks.bl - jnp.einsum("clij,ci->lj", blocks.W, dc)
    dl = jnp.einsum("lij,lj->li", Vinv, rhs)
    return dc, dl


def schur_matvec(blocks: NormalEqBlocks, Vinv: Array, lam: Array, x: Array) -> Array:
    """Implicit S @ x for PCG — O(C·L) memory, no [C6, C6] materialization.

    x: [C, 6] → [C, 6].
    """
    U = _damp(blocks.U, lam)
    Ux = jnp.einsum("cij,cj->ci", U, x)
    Wtx = jnp.einsum("clij,ci->lj", blocks.W, x)       # [L, 3]
    VWtx = jnp.einsum("lij,lj->li", Vinv, Wtx)
    WVWtx = jnp.einsum("clij,lj->ci", blocks.W, VWtx)
    return Ux - WVWtx


def solve_schur_pcg(
    blocks: NormalEqBlocks, lam: Array, iterations: int = 50
) -> Tuple[Array, Array]:
    """Jacobi-preconditioned CG on the reduced camera system (the scalable
    path for large C / distributed BA; matvecs shard over L with one psum).
    """
    _, g, Vinv = _pcg_prep(blocks, lam)

    # Jacobi preconditioner: inverse of the 6×6 diagonal blocks of S.
    Y = jnp.einsum("clij,ljk->clik", blocks.W, Vinv)
    S_diag = _damp(blocks.U, lam) - jnp.einsum("clik,cljk->cij", Y, blocks.W)
    Minv = jnp.linalg.inv(S_diag)

    def mv(x):
        return schur_matvec(blocks, Vinv, lam, x)

    def precond(r):
        return jnp.einsum("cij,cj->ci", Minv, r)

    x = jnp.zeros_like(g)
    r = g - mv(x)
    z = precond(r)
    p = z
    rz = jnp.sum(r * z)

    def body(i, carry):
        x, r, p, rz = carry
        Ap = mv(p)
        alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-12)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-12)
        p = z + beta * p
        return x, r, p, rz_new

    x, r, p, rz = jax.lax.fori_loop(0, iterations, body, (x, r, p, rz))
    dc = x
    rhs = blocks.bl - jnp.einsum("clij,ci->lj", blocks.W, dc)
    dl = jnp.einsum("lij,lj->li", Vinv, rhs)
    return dc, dl


def _pcg_prep(blocks: NormalEqBlocks, lam: Array):
    V = _damp(blocks.V, lam)
    Vinv = _inv3(V)
    g = blocks.bc - jnp.einsum(
        "clij,ljk,lk->ci", blocks.W, Vinv, blocks.bl
    )
    return None, g, Vinv
