"""Fundamental / essential matrix estimation — batched, mask-aware, f32-safe.

Accelerator replacement for OpenCV's ``cvFindFundamentalMat`` (implicit native
component N4, SURVEY.md §2.2; demo call site ``Points Matching/main.cpp:95-98``)
and ``cvComputeCorrespondEpilines`` (N5, ``main.cpp:128-132``).

Conventions (matching OpenCV): with correspondences (p1 in image 1, p2 in
image 2), the estimated F satisfies  p2ᵀ F p1 = 0.  The reference demo audits
the *transpose* form p1ᵀ F p2 (``main.cpp:108-121``); both are provided.

All solvers are pure functions of fixed-shape inputs with weight/mask
vectors, so they ``vmap`` cleanly over RANSAC hypotheses and image pairs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import Array

from points_matching.geometry.eigen import (
    project_rank2,
    smallest_eigvec_psd,
    smallest_eigvecs_psd,
    svd3_rotational,
)
from points_matching.geometry.homogeneous import to_homogeneous
from points_matching.geometry.normalize import hartley_normalize

from points_matching.core.precision import f32_matmuls


def _constraint_rows(p1: Array, p2: Array) -> Array:
    """Epipolar constraint rows: A f = 0 for f = vec(F) (row-major), with
    the convention p2ᵀ F p1 = 0.

    Args:  p1, p2: [..., N, 2].
    Returns: [..., N, 9].
    """
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = jnp.ones_like(x1)
    return jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], axis=-1
    )


def _smallest_eigvec_9(ATA: Array) -> Array:
    """Eigenvector of the smallest eigenvalue of a symmetric 9×9 (batched).

    AᵀA instead of SVD of A: half the flops, batch-friendly, and the Hartley
    normalization upstream keeps the conditioning acceptable in f32
    (SURVEY.md §7 'hard parts').  Solved by fixed-iteration Cholesky inverse
    iteration (geometry/eigen.py) — static control flow instead of
    iterative eigh/LAPACK loops (see eigen.py module docstring)."""
    return smallest_eigvec_psd(ATA)


def _project_rank2(F: Array) -> Array:
    """Project to the rank-2 manifold (zero the smallest singular value)."""
    return project_rank2(F)


def _sign_normalize(F: Array, eps: float = 1e-12) -> Array:
    """Scale to unit Frobenius norm and fix the overall sign (largest-|entry|
    positive) so estimates are comparable across solvers/backends."""
    F = F / jnp.maximum(jnp.linalg.norm(F, axis=(-2, -1), keepdims=True), eps)
    flat = F.reshape(*F.shape[:-2], 9)
    idx = jnp.argmax(jnp.abs(flat), axis=-1)
    pivot = jnp.take_along_axis(flat, idx[..., None], axis=-1)[..., 0]
    sign = jnp.where(pivot < 0, -1.0, 1.0)
    return F * sign[..., None, None]


@f32_matmuls
def eight_point(
    p1: Array,
    p2: Array,
    weights: Optional[Array] = None,
) -> Array:
    """Normalized 8-point (least-squares) fundamental-matrix solve.

    Equivalent of OpenCV's CV_FM_8POINT path that the reference's
    ``CV_FM_7POINT`` call falls back to for >7 correspondences
    (``main.cpp:95-98``; SURVEY.md §0 item 5).  Batched over any leading
    dims; masked points get zero weight.

    Args:
      p1, p2:  [..., N, 2] corresponding pixel coordinates (N ≥ 8 valid).
      weights: [..., N] optional weights / validity mask.

    Returns: [..., 3, 3] rank-2, Frobenius-normalized F with p2ᵀ F p1 ≈ 0.
    """
    if weights is None:
        weights = jnp.ones(p1.shape[:-1], p1.dtype)
    w = weights.astype(p1.dtype)

    p1n, T1 = hartley_normalize(p1, w)
    p2n, T2 = hartley_normalize(p2, w)

    A = _constraint_rows(p1n, p2n) * w[..., None]
    ATA = jnp.einsum("...ni,...nj->...ij", A, A)
    f = _smallest_eigvec_9(ATA)
    Fn = f.reshape(*f.shape[:-1], 3, 3)
    Fn = _project_rank2(Fn)

    F = jnp.swapaxes(T2, -1, -2) @ Fn @ T1
    return _sign_normalize(F)


def _cubic_roots_real(a: Array, b: Array, c: Array, d: Array, eps: float = 1e-12):
    """Real roots of a·x³+b·x²+c·x+d (batched, branchless).

    Returns (roots [..., 3], valid [..., 3]) — trig/Cardano method; when the
    cubic degenerates to a quadratic/linear the extra slots are masked out.
    """
    dtype = a.dtype
    is_cubic = jnp.abs(a) > eps
    a_safe = jnp.where(is_cubic, a, jnp.ones_like(a))

    # Depressed cubic t³ + pt + q, x = t - b/(3a)
    bn = b / a_safe
    cn = c / a_safe
    dn = d / a_safe
    shift = bn / 3.0
    p = cn - bn * bn / 3.0
    q = 2.0 * bn**3 / 27.0 - bn * cn / 3.0 + dn

    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3

    # Three real roots (disc <= 0): trig method.
    p_neg = jnp.minimum(p, -eps)
    m = 2.0 * jnp.sqrt(-p_neg / 3.0)
    acos_arg = jnp.clip(3.0 * q / (p_neg * m), -1.0, 1.0)
    theta = jnp.arccos(acos_arg) / 3.0
    two_pi_3 = jnp.asarray(2.0 * jnp.pi / 3.0, dtype)
    r_trig = jnp.stack(
        [m * jnp.cos(theta), m * jnp.cos(theta - two_pi_3), m * jnp.cos(theta + two_pi_3)],
        axis=-1,
    )

    # One real root (disc > 0): Cardano.
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    u = jnp.cbrt(-q / 2.0 + sq)
    v = jnp.cbrt(-q / 2.0 - sq)
    r_card = (u + v)[..., None] * jnp.ones((3,), dtype)

    one_real = disc > 0
    roots = jnp.where(one_real[..., None], r_card, r_trig) - shift[..., None]
    valid = jnp.where(
        one_real[..., None],
        jnp.array([True, False, False]),
        jnp.ones((3,), bool),
    )

    # Quadratic fallback (a ≈ 0): b·x² + c·x + d.
    is_quad = jnp.logical_and(~is_cubic, jnp.abs(b) > eps)
    b_safe = jnp.where(jnp.abs(b) > eps, b, jnp.ones_like(b))
    qdisc = c * c - 4.0 * b * d
    qs = jnp.sqrt(jnp.maximum(qdisc, 0.0))
    qroots = jnp.stack(
        [(-c + qs) / (2.0 * b_safe), (-c - qs) / (2.0 * b_safe), jnp.zeros_like(c)],
        axis=-1,
    )
    qvalid = jnp.stack(
        [qdisc >= 0, qdisc >= 0, jnp.zeros_like(qdisc, bool)], axis=-1
    )
    # Linear fallback (a ≈ b ≈ 0): c·x + d.
    is_lin = jnp.logical_and(~is_cubic, ~(jnp.abs(b) > eps))
    c_safe = jnp.where(jnp.abs(c) > eps, c, jnp.ones_like(c))
    lroots = jnp.stack([-d / c_safe, jnp.zeros_like(c), jnp.zeros_like(c)], axis=-1)
    lvalid = jnp.stack(
        [jnp.abs(c) > eps, jnp.zeros_like(is_lin), jnp.zeros_like(is_lin)], axis=-1
    )

    roots = jnp.where(is_cubic[..., None], roots, jnp.where(is_quad[..., None], qroots, lroots))
    valid = jnp.where(is_cubic[..., None], valid, jnp.where(is_quad[..., None], qvalid, lvalid))
    return roots, valid


@f32_matmuls
def seven_point(p1: Array, p2: Array) -> Tuple[Array, Array]:
    """7-point fundamental solve — up to 3 solutions.

    Parity with the flag the reference actually passes
    (``CV_FM_7POINT``, ``main.cpp:98``), which OpenCV 2.4 honors only for
    exactly 7 correspondences.

    Args:   p1, p2: [..., 7, 2].
    Returns (F [..., 3, 3, 3], valid [..., 3]) — candidate matrices and a
    mask of which candidate slots hold real roots.
    """
    w = jnp.ones(p1.shape[:-1], p1.dtype)
    p1n, T1 = hartley_normalize(p1, w)
    p2n, T2 = hartley_normalize(p2, w)

    A = _constraint_rows(p1n, p2n)  # [..., 7, 9]
    ATA = jnp.einsum("...ni,...nj->...ij", A, A)
    # Any orthonormal basis of the 2-dim nullspace parametrizes the same
    # pencil F1 + λF2, so the basis from fixed-iteration subspace inverse
    # iteration (geometry/eigen.py — static control flow, no eigh) is as
    # good as the eigenvalue-ordered pair.
    vecs = smallest_eigvecs_psd(ATA, k=2, iters=6)
    f1 = vecs[..., :, 0]
    f2 = vecs[..., :, 1]
    F1 = f1.reshape(*f1.shape[:-1], 3, 3)
    F2 = f2.reshape(*f2.shape[:-1], 3, 3)

    # det(F1 + λ F2) is cubic in λ: coefficients via the trilinear expansion
    # det(X+Y) = det(X) + tr(adj(X) Y)-type terms, evaluated numerically by
    # sampling det at λ ∈ {0, 1, -1, 2} and solving the Vandermonde system.
    d0 = jnp.linalg.det(F1)
    d1 = jnp.linalg.det(F1 + F2)
    dm1 = jnp.linalg.det(F1 - F2)
    d2 = jnp.linalg.det(F1 + 2.0 * F2)
    # det(λ) = aλ³ + bλ² + cλ + d with d = d0:
    #   λ=1:  a + b + c = d1 - d0
    #   λ=-1: -a + b - c = dm1 - d0
    #   λ=2:  8a + 4b + 2c = d2 - d0
    s1 = d1 - d0
    sm1 = dm1 - d0
    s2 = d2 - d0
    b_ = (s1 + sm1) / 2.0
    a_ = (s2 - 2.0 * b_ - 2.0 * s1) / 6.0
    c_ = s1 - a_ - b_

    roots, valid = _cubic_roots_real(a_, b_, c_, d0)

    Fn = F1[..., None, :, :] + roots[..., :, None, None] * F2[..., None, :, :]
    T2t = jnp.swapaxes(T2, -1, -2)
    F = T2t[..., None, :, :] @ Fn @ T1[..., None, :, :]
    return _sign_normalize(F), valid


@f32_matmuls
def find_fundamental(
    p1: Array, p2: Array, mask: Array
) -> Tuple[Array, Array]:
    """OpenCV ``findFundamentalMat(..., CV_FM_7POINT)`` dispatch parity
    (the exact call the reference makes, ``main.cpp:95-98``): the 7-point
    solver runs only when exactly 7 valid correspondences are given;
    otherwise the normalized 8-point least-squares path runs (SURVEY.md §0
    item 5).  Branchless under jit via ``lax.cond`` on the valid count.

    Args:
      p1, p2: [N, 2] correspondences (padded rows allowed, N ≥ 7).
      mask:   [N] validity.

    Returns (F [3, 3, 3] candidate stack, valid [3]): the 7-point branch
    fills up to 3 real-root candidates; the 8-point branch fills slot 0
    only.  (OpenCV returns the candidates row-stacked as a 9×3 matrix;
    a fixed [3, 3, 3] + mask is the static-shape equivalent.)
    """
    mask = mask.astype(bool)
    n_valid = jnp.sum(mask.astype(jnp.int32))
    # compact valid correspondences to the front (stable), so the 7-point
    # branch sees exactly the valid seven
    order = jnp.argsort(~mask, stable=True)
    c1 = jnp.take(p1, order, axis=0)
    c2 = jnp.take(p2, order, axis=0)

    def branch_7pt(_):
        F, valid = seven_point(c1[:7], c2[:7])
        return F, valid

    def branch_8pt(_):
        F = eight_point(p1, p2, mask.astype(p1.dtype))
        Fs = jnp.stack([F, F, F], axis=0)
        return Fs, jnp.array([True, False, False])

    return jax.lax.cond(n_valid == 7, branch_7pt, branch_8pt, operand=None)


@f32_matmuls
def epipolar_residuals(F: Array, p1: Array, p2: Array) -> Array:
    """Algebraic residual p2ᵀ F p1 per correspondence.  [..., N]."""
    p1h = to_homogeneous(p1)
    p2h = to_homogeneous(p2)
    return jnp.einsum("...ni,...ij,...nj->...n", p2h, F, p1h)


@f32_matmuls
def epipolar_residual_audit(
    F: Array,
    p1: Array,
    p2: Array,
    mask: Optional[Array] = None,
    form: str = "reference",
) -> Tuple[Array, Array]:
    """The reference demo's self-audit (``main.cpp:103-123``): per-match
    algebraic residual and the mean of absolute values.

    ``form='reference'`` computes p1ᵀ F p2 exactly as the demo does
    (``temp1*fundemental*temp2``, ``main.cpp:117``); ``form='standard'``
    computes the constraint direction p2ᵀ F p1.

    Returns (residuals [..., N], mean_abs [...]).
    """
    if form == "reference":
        r = jnp.einsum(
            "...ni,...ij,...nj->...n", to_homogeneous(p1), F, to_homogeneous(p2)
        )
    elif form == "standard":
        r = epipolar_residuals(F, p1, p2)
    else:
        raise ValueError(f"unknown form: {form!r}")
    if mask is None:
        mean = jnp.mean(jnp.abs(r), axis=-1)
    else:
        m = mask.astype(r.dtype)
        mean = jnp.sum(jnp.abs(r) * m, axis=-1) / jnp.maximum(jnp.sum(m, axis=-1), 1.0)
    return r, mean


@f32_matmuls
def sampson_distance(F: Array, p1: Array, p2: Array, eps: float = 1e-12) -> Array:
    """First-order geometric (Sampson) distance per correspondence — the
    RANSAC gating metric.  [..., N]."""
    p1h = to_homogeneous(p1)
    p2h = to_homogeneous(p2)
    Fp1 = jnp.einsum("...ij,...nj->...ni", F, p1h)
    Ftp2 = jnp.einsum("...ji,...nj->...ni", F, p2h)
    r = jnp.einsum("...ni,...ni->...n", p2h, Fp1)
    denom = Fp1[..., 0] ** 2 + Fp1[..., 1] ** 2 + Ftp2[..., 0] ** 2 + Ftp2[..., 1] ** 2
    return (r * r) / jnp.maximum(denom, eps)


@f32_matmuls
def compute_epilines(points: Array, which_image: int, F: Array) -> Array:
    """Epipolar lines for points — ``cv::computeCorrespondEpilines`` parity
    (demo call site ``main.cpp:128-132``).

    For points in image 1 (``which_image=1``) returns lines in image 2:
    l2 = F p1; for image 2, l1 = Fᵀ p2.  Lines (a, b, c) are normalized so
    a² + b² = 1.

    Args:   points [..., N, 2].
    Returns lines [..., N, 3].
    """
    ph = to_homogeneous(points)
    if which_image == 1:
        lines = jnp.einsum("...ij,...nj->...ni", F, ph)
    elif which_image == 2:
        lines = jnp.einsum("...ji,...nj->...ni", F, ph)
    else:
        raise ValueError("which_image must be 1 or 2")
    norm = jnp.linalg.norm(lines[..., :2], axis=-1, keepdims=True)
    return lines / jnp.maximum(norm, 1e-12)


@f32_matmuls
def essential_from_fundamental(F: Array, K1: Array, K2: Array) -> Array:
    """E = K2ᵀ F K1, projected to the essential manifold (σ = (1, 1, 0)).

    Uses the static-control-flow 3×3 SVD (geometry/eigen.py) — same
    rationale as the 8-point solver."""
    E = jnp.swapaxes(K2, -1, -2) @ F @ K1
    U, S, Vt = svd3_rotational(E)
    s = (S[..., 0] + S[..., 1]) / 2.0
    S_proj = jnp.stack([s, s, jnp.zeros_like(s)], axis=-1)
    return U @ (S_proj[..., :, None] * Vt)


@f32_matmuls
def fundamental_from_essential(E: Array, K1: Array, K2: Array) -> Array:
    """F = K2⁻ᵀ E K1⁻¹."""
    K1_inv = jnp.linalg.inv(K1)
    K2_inv_t = jnp.swapaxes(jnp.linalg.inv(K2), -1, -2)
    return _sign_normalize(K2_inv_t @ E @ K1_inv)
