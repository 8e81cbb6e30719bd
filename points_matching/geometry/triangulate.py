"""Batched DLT triangulation (extension beyond the reference demo, required
by BASELINE configs 2-4)."""
from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
from jax import Array

from points_matching.core.precision import f32_matmuls
from points_matching.geometry.eigen import smallest_eigvec_psd


@f32_matmuls
def triangulate_dlt(
    P1: Array, P2: Array, p1: Array, p2: Array
) -> Tuple[Array, Array]:
    """Linear (DLT) two-view triangulation.

    Args:
      P1, P2: [..., 3, 4] projection matrices (K [R|t]).
      p1, p2: [..., N, 2] pixel coordinates.

    Returns:
      (X [..., N, 3] world points, depth_ok [..., N] — positive depth in
      BOTH cameras, the cheirality mask).
    """
    # Gauge shift: translate the world origin to the camera-pair midpoint.
    # Far from the origin (‖C‖ ≫ baseline — the tail of a long SfM
    # trajectory), the t-column of P carries ‖C‖-scale entries and the DLT
    # rows lose significance to f32 cancellation — measured: median
    # triangulation error 12 world units at ‖C‖ ≈ 80 without the shift,
    # 0.5 with it, for BOTH this solver and LAPACK eigh.  With X' = X − Cm,
    # P' = [M | M Cm + t] has t'-entries at baseline scale.
    def center(P):
        # C = −M⁻¹ t; M is a general 3×3 (callers pass both K[R|t] and
        # plain [R|t]), so a direct solve — NOT Mᵀ, which assumes a rotation.
        # A degenerate M (failed hypothesis camera) would make the solve
        # inf/NaN and poison EVERY point's depth_ok for that batch element,
        # so fall back to Cm = 0 (no gauge shift — finite per-point garbage
        # that downstream scoring can discard) when M is near-singular.
        C = -jnp.linalg.solve(P[..., :3], P[..., 3:4])[..., 0]
        ok = jnp.all(jnp.isfinite(C), axis=-1, keepdims=True)
        return jnp.where(ok, C, 0.0)

    Cm = 0.5 * (center(P1) + center(P2))  # [..., 3]

    def shift(P):
        t_new = jnp.einsum("...ij,...j->...i", P[..., :3], Cm) + P[..., 3]
        return jnp.concatenate([P[..., :3], t_new[..., None]], axis=-1)

    P1s = shift(P1)
    P2s = shift(P2)

    # Rows of A: x*P[2] - P[0], y*P[2] - P[1] for each view → [..., N, 4, 4]
    def rows(P, p):
        P0 = P[..., None, 0, :]
        P1_ = P[..., None, 1, :]
        P2_ = P[..., None, 2, :]
        x = p[..., 0:1]
        y = p[..., 1:2]
        return jnp.stack([x * P2_ - P0, y * P2_ - P1_], axis=-2)

    A = jnp.concatenate([rows(P1s, p1), rows(P2s, p2)], axis=-2)  # [..., N, 4, 4]
    # Row equilibration: constraint-row magnitudes grow with the camera's
    # distance from the world origin (t entries enter the rows), so far
    # from the origin AᵀA's condition number grows ~‖t‖² and the f32
    # nullspace solve degrades — measured as landmark-creation starvation
    # once the SfM camera passed x ≈ 20 world units.  Unit-normalizing each
    # row keeps the system scale-free (the DLT row weighting is arbitrary
    # anyway).
    A = A / jnp.maximum(
        jnp.linalg.norm(A, axis=-1, keepdims=True), 1e-12
    )
    ATA = jnp.einsum("...ki,...kj->...ij", A, A)
    # Smallest eigenvector via fixed-count Cholesky inverse iteration —
    # static control flow in the per-point hot loop (geometry/eigen.py).
    Xh = smallest_eigvec_psd(ATA, iters=8)
    w = Xh[..., 3:4]
    w_safe = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    Xs = Xh[..., :3] / w_safe

    Xh1 = jnp.concatenate([Xs, jnp.ones_like(Xs[..., :1])], axis=-1)
    z1 = jnp.einsum("...j,...j->...", Xh1, jnp.broadcast_to(P1s[..., None, 2, :], Xh1.shape))
    z2 = jnp.einsum("...j,...j->...", Xh1, jnp.broadcast_to(P2s[..., None, 2, :], Xh1.shape))
    depth_ok = jnp.logical_and(z1 > 0, z2 > 0)
    # un-shift back to the caller's world frame
    return Xs + Cm[..., None, :], depth_ok
