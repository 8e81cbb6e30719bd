"""Perspective-n-Point: camera pose from 2D↔3D correspondences.

Needed by incremental SfM registration (SURVEY.md §7 stage 7); absent in
the reference (it never leaves two views).  Batched shape: the DLT solve
is a batched 12×12 eigenproblem under ``vmap``; RANSAC evaluates ALL
hypotheses at once like ``geometry/ransac.py``; refinement is a fixed-count
Gauss-Newton loop on the SE(3) tangent (no data-dependent control flow).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import Array

from points_matching.core.precision import f32_matmuls
from points_matching.core.types import Pose
from points_matching.geometry.eigen import (
    nearest_rotation_so3,
    smallest_eigvec_psd,
)
from points_matching.geometry.se3 import se3_exp


@f32_matmuls
def pnp_dlt(X: Array, uv_norm: Array, weights: Array | None = None) -> Pose:
    """Direct linear transform PnP (≥6 points).

    Args:
      X:       [..., N, 3] world points.
      uv_norm: [..., N, 2] normalized camera coordinates (K⁻¹ applied).
      weights: [..., N] optional weights/mask.

    Returns world→camera Pose (R orthonormalized via Horn's quaternion
    method, t scaled so that the projection is consistent;
    cheirality-corrected sign).
    """
    N = X.shape[-2]
    if weights is None:
        weights = jnp.ones(X.shape[:-1], X.dtype)
    w = weights[..., None]

    # Hartley-style normalization of the 3-D points: center on the weighted
    # centroid and scale to RMS √3.  Without it the DLT columns span the
    # scene's coordinate magnitude (world points far from the origin make
    # AᵀA's condition number grow with extent²) and the f32 nullspace solve
    # degrades — measured as a PnP registration death-spiral once the SfM
    # camera passed x ≈ 20 world units.  The pose is un-normalized below.
    cen = jnp.sum(X * w, axis=-2) / jnp.maximum(
        jnp.sum(w, axis=-2), 1e-12
    )  # [..., 3]
    Xc_ = X - cen[..., None, :]
    rms = jnp.sqrt(
        jnp.sum(jnp.sum(Xc_ * Xc_, axis=-1) * weights, axis=-1)
        / jnp.maximum(jnp.sum(weights, axis=-1), 1e-12)
    )
    s = jnp.sqrt(3.0) / jnp.maximum(rms, 1e-9)  # [...]
    X_n = Xc_ * s[..., None, None]

    ones = jnp.ones(X.shape[:-1] + (1,), X.dtype)
    Xh = jnp.concatenate([X_n, ones], axis=-1)  # [..., N, 4]
    z = jnp.zeros_like(Xh)
    u = uv_norm[..., 0:1]
    v = uv_norm[..., 1:2]
    # rows: [X 0 -u·X], [0 X -v·X]
    r1 = jnp.concatenate([Xh, z, -u * Xh], axis=-1) * w
    r2 = jnp.concatenate([z, Xh, -v * Xh], axis=-1) * w
    A = jnp.concatenate([r1, r2], axis=-2)  # [..., 2N, 12]

    AtA = jnp.einsum("...ki,...kj->...ij", A, A)
    # 12×12 smallest eigenvector via fixed-count Cholesky inverse iteration
    # (geometry/eigen.py) — this runs per RANSAC hypothesis under vmap.
    p = smallest_eigvec_psd(AtA, iters=6)
    P = p.reshape(p.shape[:-1] + (3, 4))

    M = P[..., :3]
    # sign: points must be in front — use the mean cheirality (in the
    # normalized frame; the positive scale s preserves depth signs)
    depth = jnp.einsum("...ij,...nj->...ni", M, X_n)[..., 2] + P[..., 2, 3][..., None]
    sign = jnp.where(jnp.sum(jnp.sign(depth) * weights, axis=-1) < 0, -1.0, 1.0)
    P = P * sign[..., None, None]
    M = P[..., :3]

    # nearest PROPER rotation via Horn's quaternion method (static power
    # iteration, det(R) = +1 by construction — geometry/eigen.py), replacing
    # SVD polar decomposition + det fix.  The optimal R maximizes tr(RᵀM) =
    # Σσᵢ, so tr(RᵀM)/3 equals mean(σ) — the same consistent scale the SVD
    # route used.
    R = nearest_rotation_so3(M)
    scale = jnp.einsum("...ij,...ij->...", R, M) / 3.0
    # Un-normalize: the solved projection maps X_n = s(X − c), so
    # [M' | t'] ∝ [M/s | M c + t]  ⇒  t = (t'/σ)/s − R c  with σ = mean(σᵢ).
    t_n = P[..., 3] / jnp.maximum(scale, 1e-12)[..., None]
    t = t_n / s[..., None] - jnp.einsum("...ij,...j->...i", R, cen)
    return Pose(R=R, t=t)


@f32_matmuls
def pnp_refine(
    pose: Pose,
    X: Array,
    uv_norm: Array,
    weights: Array,
    iterations: int = 5,
    damping: float = 1e-6,
) -> Pose:
    """Fixed-count Gauss-Newton refinement of a PnP pose (normalized
    coordinates; minimizes masked reprojection error)."""

    def residual(pose):
        Xc = pose.transform(X)
        z = jnp.maximum(Xc[..., 2:3], 1e-6)
        return (Xc[..., :2] / z - uv_norm) * weights[..., None]

    def step(i, pose):
        z6 = jnp.zeros((6,), X.dtype)

        def r_of_xi(xi):
            Rd, td = se3_exp(xi)
            p = Pose(R=Rd @ pose.R, t=Rd @ pose.t + td)
            return residual(p).reshape(-1)

        r = r_of_xi(z6)
        J = jax.jacfwd(r_of_xi)(z6)
        H = J.T @ J + damping * jnp.eye(6, dtype=X.dtype)
        g = -J.T @ r
        dx = jnp.linalg.solve(H, g)
        Rd, td = se3_exp(dx)
        return Pose(R=Rd @ pose.R, t=Rd @ pose.t + td)

    return jax.lax.fori_loop(0, iterations, step, pose)


class PnPResult(NamedTuple):
    pose: Pose
    inlier_mask: Array
    num_inliers: Array


@f32_matmuls
def ransac_pnp(
    key: Array,
    X: Array,
    uv_norm: Array,
    mask: Array,
    num_hypotheses: int = 256,
    sample_size: int = 6,
    inlier_threshold: float = 0.01,
    refine_iterations: int = 5,
    sample_logits: Array | None = None,
    refine_top_k: int = 8,
    prior_pose: Pose | None = None,
) -> PnPResult:
    """Batched-hypothesis RANSAC PnP with top-k LO refinement.

    Args:
      X:       [N, 3] world points; uv_norm: [N, 2] normalized image coords.
      mask:    [N] valid correspondences.
      inlier_threshold: reprojection error in *normalized* units
                        (pixels / focal length).
      sample_logits: [N] optional log-weights biasing minimal-set sampling
        toward trusted correspondences (Gumbel-top-k, P ∝ exp(logits),
        without replacement within a set — see sample_index_sets).  With
        a 6-point DLT sample, inlier fractions below ~50% starve uniform
        RANSAC — (0.45)⁶ ≈ 0.8% clean samples — so callers that KNOW some
        rows are higher-precision (e.g. tracked vs bank-matched in SfM
        registration) should say so here.  Scoring still uses all rows.
      refine_top_k: LO-RANSAC over the k best-by-count hypotheses, not just
        the argmax: each is GN-refined on its own consensus and re-gated,
        and the best REFINED consensus wins.  This is the variance killer —
        measured on a 100-frame SfM run, argmax-only refinement made
        registration collapse for ~1 key in 5 (8 vs ~70 inliers from the
        same data) because at ~35% inlier rate only a couple of the minimal
        samples are clean, and the single best raw count often sits on a
        degenerate sample.  All k refinements run batched under vmap.
      prior_pose: optional extra hypothesis (e.g. the previous frame's pose
        in incremental tracking — a constant-position motion model).  It
        enters the pool like any sampled hypothesis, so a good prior
        rescues frames where minimal-set sampling starves, and a bad prior
        costs nothing.
    """
    from points_matching.geometry.ransac import sample_minimal_points

    mask = mask.astype(bool)
    n = X.shape[0]

    # gather-free sampling (see sample_minimal_points)
    sX, suv = sample_minimal_points(
        key, mask, num_hypotheses, sample_size, (X, uv_norm),
        logits=sample_logits,
    )                                       # [H, S, 3], [H, S, 2]

    poses = pnp_dlt(sX, suv)               # batched over H
    if prior_pose is not None:
        poses = jax.tree.map(
            lambda a, p: jnp.concatenate([a, p[None]], axis=0),
            poses, prior_pose,
        )

    def reproj_err(pose):
        Xc = pose.transform(X)
        z = Xc[..., 2:3]
        ok_z = z[..., 0] > 1e-3
        uv = Xc[..., :2] / jnp.maximum(z, 1e-6)
        e = jnp.linalg.norm(uv - uv_norm, axis=-1)
        return jnp.where(ok_z, e, jnp.inf)

    errs = jax.vmap(reproj_err)(poses)     # [H, N]
    inl = jnp.logical_and(errs < inlier_threshold, mask[None])
    counts = jnp.sum(inl.astype(jnp.int32), axis=-1)

    # LO step over the k best hypotheses, batched: refine on own consensus,
    # re-gate, count again.
    k = min(refine_top_k, counts.shape[0])
    _, top = jax.lax.top_k(counts, k)
    cand = jax.tree.map(lambda a: a[top], poses)
    cand_w = inl[top].astype(X.dtype)      # [k, N]
    refined = jax.vmap(
        lambda p, w: pnp_refine(p, X, uv_norm, w,
                                iterations=refine_iterations)
    )(cand, cand_w)
    r_errs = jax.vmap(reproj_err)(refined)
    r_inl = jnp.logical_and(r_errs < inlier_threshold, mask[None])
    r_counts = jnp.sum(r_inl.astype(jnp.int32), axis=-1)
    best = jnp.argmax(r_counts)
    pose = jax.tree.map(lambda a: a[best], refined)

    # final polish on the winning consensus
    inl1 = r_inl[best]
    pose = pnp_refine(pose, X, uv_norm, inl1.astype(X.dtype),
                      iterations=refine_iterations)
    final_inl = jnp.logical_and(reproj_err(pose) < inlier_threshold, mask)
    return PnPResult(
        pose=pose,
        inlier_mask=final_inl,
        num_inliers=jnp.sum(final_inl.astype(jnp.int32)),
    )
