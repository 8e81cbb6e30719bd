"""Small-matrix eigen-solvers with STATIC control flow — no LAPACK-style
convergence loops.

Why this module exists: the batched 8/7-point solves need the smallest
eigenvector(s) of a 9×9 symmetric matrix per RANSAC hypothesis (replacing
OpenCV's SVD inside ``cvFindFundamentalMat`` — implicit native component N4,
``Points Matching/main.cpp:95-98``).  ``jnp.linalg.eigh``/``svd`` lower to
iterative algorithms with data-dependent while-loops.  Fixed-trip-count
direct algebra instead makes every op below a dense matmul / triangular
solve / elementwise op with a statically known cost, so XLA can fuse and
schedule it like any other code, batched over hypotheses.

The algorithm: shift-regularized **inverse subspace iteration**.  For a PSD
matrix M = AᵀA, the smallest-eigenvalue subspace of M is the dominant
subspace of (M + εI)⁻¹; each iteration is one Cholesky triangular solve pair
(direct, static shape) + Gram–Schmidt, and the amplification ratio
(λ₂+ε)/(λ_min+ε) is enormous for near-singular M (the 8-point case: λ_min ≈ 0
by construction), so a handful of fixed iterations reach f32 machine
precision.  No convergence test, no data-dependent trip counts.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array

from points_matching.core.precision import f32_matmuls

def _cholesky_unrolled(M: Array) -> list:
    """Batched Cholesky of a small SPD matrix, fully unrolled at trace time.

    XLA's Cholesky/TriangularSolve HLOs are tuned for large matrices; for
    the [B, 9, 9]-at-B≈32k shapes of batched minimal solves they serialize
    into tiny per-matrix ops that dominate the RANSAC step.  Unrolling the
    n³/6 multiply-adds as [B]-shaped elementwise ops lets XLA fuse and
    vectorize across the batch instead.

    Returns the lower factor as a Python list-of-lists of [...] scalars
    (L[i][j], j ≤ i) — kept unstacked so the paired solves below index it
    at trace time for free.
    """
    n = M.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = M[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = jnp.sqrt(jnp.maximum(s, 1e-30))
        inv_d = 1.0 / d
        L[j][j] = d
        for i in range(j + 1, n):
            s = M[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    return L


def _cho_solve_unrolled(L: list, b: Array) -> Array:
    """Solve (L Lᵀ) x = b with the unrolled factor; b is [..., n]."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


@f32_matmuls
def smallest_eigvecs_psd(M: Array, k: int = 1, iters: int = 8,
                         eps_scale: float = 1e-5) -> Array:
    """Orthonormal basis of the k-smallest-eigenvalue subspace of PSD ``M``.

    Batched over leading dims; [..., n, n] → [..., n, k].  For k > 1 the
    returned columns span the subspace but individual columns are not
    eigenvalue-ordered (sufficient for the 7-point nullspace pencil, where
    any basis of the 2-dim nullspace parametrizes the same solution set).

    Contract: designed for NEAR-SINGULAR matrices — nullspace extraction
    from constraint normal matrices (8/7-point AᵀA, DLT, triangulation),
    where λ_min ≪ λ_{k+1} and a few iterations reach f32 precision.  For a
    matrix whose bottom eigenvalues are nearly equal the returned basis
    mixes them (each returned direction is still accurate to within the
    subspace — which is what a least-squares nullspace consumer needs).

    ``iters`` is a STATIC trip count (lax.scan) — see module docstring.
    """
    n = M.shape[-1]
    dtype = M.dtype
    # Shift keeps the Cholesky positive-definite when M is exactly singular
    # (the noise-free 8-point case); scaled to the matrix magnitude so the
    # conditioning is dimensionless.  eps also bounds the f32 condition
    # number of the solves (κ ≈ λ_max/ε ≲ n/eps_scale): too small a shift
    # makes each triangular solve inject O(κ·u) noise that caps the
    # attainable residual.
    tr = jnp.trace(M, axis1=-2, axis2=-1)[..., None, None]
    eps = eps_scale * tr / n + jnp.asarray(1e-20, dtype)
    # Unrolled factorization (not jnp.linalg.cholesky): the sqrt(max(·, tiny))
    # pivots also make a non-PD/non-finite input produce finite garbage
    # instead of NaNs — the caller's scoring discards those hypotheses.
    L = _cholesky_unrolled(M + eps * jnp.eye(n, dtype=dtype))

    # Fixed pseudo-random orthonormal-ish start (deterministic constants):
    # a basis-vector start can be EXACTLY orthogonal to the target direction
    # (e.g. an axis-aligned nullspace), which stalls inverse iteration; a
    # dense irrational-phase start is never structurally orthogonal to
    # anything a real problem produces.
    phase = jnp.arange(n * k, dtype=dtype).reshape(n, k)
    V0 = jnp.cos(phase * 2.399963) + 0.1  # golden-angle phases, non-zero mean
    V0 = jnp.broadcast_to(V0, (*M.shape[:-2], n, k))

    def orthonormalize(X: Array) -> Array:
        cols = []
        for j in range(k):
            v = X[..., :, j]
            for q in cols:
                v = v - jnp.sum(q * v, axis=-1, keepdims=True) * q
            norm = jnp.linalg.norm(v, axis=-1, keepdims=True)
            # Degenerate direction (collapsed subspace) or non-finite input
            # (NaN/Inf constraint rows): fall back to a fixed basis vector
            # instead of dividing by ~0 / propagating NaN — the caller's
            # scoring discards the resulting garbage hypothesis.
            ok = jnp.logical_and(norm > 1e-20, jnp.isfinite(norm))
            fallback = jnp.zeros_like(v).at[..., j].set(1.0)
            v = jnp.where(ok, v / jnp.maximum(norm, 1e-20), fallback)
            cols.append(v)
        return jnp.stack(cols, axis=-1)

    # Python-unrolled (NOT lax.scan): iters is static and small, and scan
    # bodies cannot fuse across trips — unrolling lets XLA fuse the whole
    # solve chain into a few elementwise kernels.
    V = V0
    for _ in range(iters):
        X = jnp.stack(
            [_cho_solve_unrolled(L, V[..., :, j]) for j in range(k)], axis=-1
        )
        V = orthonormalize(X)
    return V


def smallest_eigvec_psd(M: Array, iters: int = 4) -> Array:
    """[..., n, n] PSD → [..., n] unit eigenvector of the smallest eigenvalue."""
    return smallest_eigvecs_psd(M, k=1, iters=iters)[..., :, 0]


@f32_matmuls
def nearest_rotation_so3(M: Array, iters: int = 24) -> Array:
    """Nearest proper rotation (Frobenius) to a 3×3 — det(R) = +1 guaranteed.

    Horn's quaternion method: the optimal R maximizing tr(RᵀM) over SO(3) is
    given by the dominant eigenvector of a symmetric 4×4 built from M.  The
    dominant eigenvector comes from shifted power iteration with a STATIC
    trip count (for M near a rotation cR the spectrum is {3c, −c, −c, −c} —
    a wide gap, so convergence is fast; far-from-rotation inputs only occur
    for degenerate RANSAC samples whose hypotheses score ~0 inliers anyway).
    Unlike the SVD route (U diag(1,1,det) Vᵀ), no sign fix is needed — the
    quaternion parametrization cannot leave SO(3).
    """
    dtype = M.dtype
    # Horn's K is conventionally built from the correlation matrix S = Σaᵢbᵢᵀ
    # with R mapping a→b; for "nearest rotation to M" the roles give S = Mᵀ.
    S = jnp.swapaxes(M, -1, -2)
    Sxx, Sxy, Sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    Syx, Syy, Syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    Szx, Szy, Szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    row = lambda *e: jnp.stack(e, axis=-1)
    K = jnp.stack([
        row(Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx),
        row(Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz),
        row(Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy),
        row(Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz),
    ], axis=-2)
    # |λ(K)| ≤ Σσᵢ(M) ≤ √3‖M‖_F, so +2‖M‖_F I makes the target eigenvalue
    # strictly dominant in magnitude.
    shift = 2.0 * jnp.linalg.norm(M, axis=(-2, -1))[..., None, None] + 1e-20
    Ks = K + shift * jnp.eye(4, dtype=dtype)
    Ks = jnp.where(jnp.isfinite(Ks), Ks, jnp.eye(4, dtype=dtype))

    q0 = jnp.broadcast_to(
        jnp.asarray([1.0, 0.0, 0.0, 0.0], dtype), (*M.shape[:-2], 4)
    )

    def body(q, _):
        q = jnp.einsum("...ij,...j->...i", Ks, q)
        return q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True),
                               1e-20), None

    q, _ = jax.lax.scan(body, q0, None, length=iters)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack([
        row(1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        row(2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        row(2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    ], axis=-2)


@f32_matmuls
def svd3_rotational(A: Array, iters: int = 24) -> tuple[Array, Array, Array]:
    """SVD of a 3×3 with det(U) = det(V) = +1 ("SVD with rotations").

    Exactly the form essential-matrix decomposition wants (``cv::recoverPose``
    enforces the same determinant signs after LAPACK SVD).  Construction:
      * v₃ = smallest eigenvector of AᵀA       (Cholesky inverse iteration)
      * v₁, v₂ = exact closed-form diagonalization of AᵀA restricted to the
        plane ⊥ v₃ (one Jacobi angle on the 2×2 restriction) — robust even
        when σ₁ ≈ σ₂ (the essential-matrix case, where iterative separation
        of the top pair cannot converge)
      * v₂ re-derived as v₃ × v₁  → det(V) = +1 by construction
      * uᵢ = A vᵢ / σᵢ for i = 1, 2;  u₃ = u₁ × u₂ → det(U) = +1
    Every step is fixed-count dense algebra — no LAPACK loops (see module
    docstring for why that matters batched over hypotheses).

    Returns (U, s, Vt) with s[0] ≥ s[1] ≥ |s[2]|; s[2] is SIGNED
    (sign(det A) — the signed-SVD convention rotation-constrained factors
    force, since det(A) = s₀s₁s₂ with det(U) = det(V) = +1).
    """
    M = jnp.swapaxes(A, -1, -2) @ A
    v3 = smallest_eigvec_psd(M, iters=8)

    # Top-2 singular directions in CLOSED FORM: build any orthonormal basis
    # {a, b} of the plane ⊥ v₃ (cross products — pick the better-conditioned
    # of two candidates), restrict M to it (a symmetric 2×2) and diagonalize
    # exactly with one Jacobi angle.  Power iteration on M was tried first
    # and is wrong here: for a near-essential matrix σ₁ ≈ σ₂, the top-2
    # eigenvalues of M nearly coincide, the iteration cannot separate them,
    # and a mixed v₁ puts an O(σ₁−σ₂) error into the factorization —
    # measured as a 50× ATE regression on the 100-frame SfM sequence via
    # essential_from_fundamental's manifold projection.
    ez = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], A.dtype), v3.shape)
    ey = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0], A.dtype), v3.shape)
    a = jnp.cross(v3, ez)
    a_alt = jnp.cross(v3, ey)
    use_alt = (
        jnp.linalg.norm(a, axis=-1, keepdims=True)
        < jnp.linalg.norm(a_alt, axis=-1, keepdims=True)
    )
    a = jnp.where(use_alt, a_alt, a)
    a = a / jnp.maximum(jnp.linalg.norm(a, axis=-1, keepdims=True), 1e-20)
    b = jnp.cross(v3, a)

    Ma = jnp.einsum("...ij,...j->...i", M, a)
    Mb = jnp.einsum("...ij,...j->...i", M, b)
    maa = jnp.sum(a * Ma, axis=-1)
    mab = jnp.sum(a * Mb, axis=-1)
    mbb = jnp.sum(b * Mb, axis=-1)
    theta = 0.5 * jnp.arctan2(2.0 * mab, maa - mbb)
    c = jnp.cos(theta)[..., None]
    s = jnp.sin(theta)[..., None]
    v1 = c * a + s * b
    v2c = -s * a + c * b
    # order: v1 must carry the LARGER eigenvalue
    lam1 = jnp.einsum("...i,...ij,...j->...", v1, M, v1)
    lam2 = jnp.einsum("...i,...ij,...j->...", v2c, M, v2c)
    swap = (lam2 > lam1)[..., None]
    v1 = jnp.where(swap, v2c, v1)
    v2 = jnp.cross(v3, v1)

    Av1 = jnp.einsum("...ij,...j->...i", A, v1)
    Av2 = jnp.einsum("...ij,...j->...i", A, v2)
    Av3 = jnp.einsum("...ij,...j->...i", A, v3)
    s1 = jnp.linalg.norm(Av1, axis=-1)
    s2 = jnp.linalg.norm(Av2, axis=-1)
    u1 = Av1 / jnp.maximum(s1, 1e-20)[..., None]
    u2 = Av2 / jnp.maximum(s2, 1e-20)[..., None]
    # u2 need not be exactly ⊥ u1 when σ1 ≈ σ2 left finite-iteration error
    # in v1 — re-orthogonalize so U is a rotation to machine precision.
    u2 = u2 - jnp.sum(u1 * u2, axis=-1, keepdims=True) * u1
    u2 = u2 / jnp.maximum(jnp.linalg.norm(u2, axis=-1, keepdims=True), 1e-20)
    u3 = jnp.cross(u1, u2)
    # With both factors constrained to rotations, det(A) = s1·s2·s3 — so the
    # smallest "singular value" carries det's sign (the signed-SVD
    # convention): s3 is the projection of A v3 onto the constructed u3.
    s3 = jnp.sum(u3 * Av3, axis=-1)

    U = jnp.stack([u1, u2, u3], axis=-1)
    Vt = jnp.stack([v1, v2, v3], axis=-2)
    s = jnp.stack([s1, s2, s3], axis=-1)
    return U, s, Vt


@f32_matmuls
def project_rank2(F: Array) -> Array:
    """Nearest rank-2 matrix (Frobenius) to a 3×3 — SVD-free.

    With F = Σ σᵢ uᵢ vᵢᵀ, the projection is F − σ₃ u₃ v₃ᵀ = F − (F v₃) v₃ᵀ
    where v₃ is the smallest right singular vector, i.e. the smallest
    eigenvector of FᵀF.  One 3×3 inverse-iteration + one outer product
    replaces the iterative 3×3 SVD in the per-hypothesis RANSAC path.
    """
    M = jnp.swapaxes(F, -1, -2) @ F
    v3 = smallest_eigvec_psd(M, iters=8)
    Fv = jnp.einsum("...ij,...j->...i", F, v3)
    return F - Fv[..., :, None] * v3[..., None, :]
