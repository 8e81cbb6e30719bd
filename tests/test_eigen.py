"""Static-control-flow small-matrix eigen/SVD solvers (geometry/eigen.py)
vs LAPACK ground truth.  These replace eigh/svd in every per-hypothesis hot
path (8/7-point, rank-2 projection, PnP, triangulation, essential
decomposition) — see eigen.py's module docstring for the backend-stability
rationale."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from points_matching.geometry.eigen import (
    nearest_rotation_so3,
    project_rank2,
    smallest_eigvec_psd,
    smallest_eigvecs_psd,
    svd3_rotational,
)


def _rand_psd(rng, b, n, rank=None):
    A = rng.randn(b, n + 3, n).astype(np.float32)
    if rank is not None:
        # exact nullspace of dimension n - rank
        A[..., rank:] = A[..., :1] * 0.0
    return np.einsum("bki,bkj->bij", A, A)


def _psd_with_spectrum(rng, b, n, eigs):
    """Random-orthogonal PSD batch with a prescribed spectrum."""
    Q, _ = np.linalg.qr(rng.randn(b, n, n).astype(np.float32))
    d = np.asarray(eigs, np.float32)
    return np.einsum("bik,k,bjk->bij", Q, d, Q), Q


def test_smallest_eigvec_matches_eigh():
    """Near-singular spectra — the production contract (nullspace of
    constraint normal matrices, λ_min ≪ λ₂)."""
    rng = np.random.RandomState(0)
    eigs = [1e-4, 0.7, 1.1, 1.9, 2.4, 3.0, 3.3, 4.1, 5.0]
    M, Q = _psd_with_spectrum(rng, 64, 9, eigs)
    v = smallest_eigvec_psd(jnp.asarray(M))
    cos = np.abs(np.einsum("bi,bi->b", np.asarray(v), Q[..., :, 0]))
    np.testing.assert_allclose(cos, 1.0, atol=1e-4)
    rq = np.einsum("bi,bij,bj->b", np.asarray(v), M, np.asarray(v))
    np.testing.assert_allclose(rq, eigs[0], rtol=0.3, atol=2e-4)


def test_smallest_eigvec_exact_nullspace():
    """The 8-point case: noise-free constraints → exactly singular AᵀA."""
    rng = np.random.RandomState(1)
    M = _rand_psd(rng, 32, 9, rank=8)
    v = np.asarray(smallest_eigvec_psd(jnp.asarray(M)))
    res = np.einsum("bij,bj->bi", M, v)
    scale = np.linalg.norm(M, axis=(1, 2))
    assert np.all(np.linalg.norm(res, axis=-1) / scale < 1e-5)


def test_two_smallest_subspace():
    """7-point case: rank-7 9×9 (two-dim nullspace) — the k=2 basis must
    span the two-smallest eig subspace."""
    rng = np.random.RandomState(2)
    M = _rand_psd(rng, 32, 9, rank=7)
    V = np.asarray(smallest_eigvecs_psd(jnp.asarray(M), k=2, iters=8))
    _, v_np = np.linalg.eigh(M)
    ref = v_np[..., :, :2]  # [b, 9, 2]
    # projection of each returned column onto the reference subspace ≈ 1
    proj = np.einsum("bik,bij->bkj", V, ref)  # [b, 2(ours), 2(ref)]
    norms = np.linalg.norm(proj, axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-3)
    # and the two columns are orthonormal
    gram = np.einsum("bik,bil->bkl", V, V)
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(2), gram.shape),
                               atol=1e-5)


def test_nearest_rotation_vs_svd():
    rng = np.random.RandomState(3)
    # near-rotation inputs (the PnP case): R·scale + noise
    import scipy.spatial.transform as sst
    R_true = sst.Rotation.random(48, random_state=4).as_matrix().astype(np.float32)
    M = 2.5 * R_true + 0.05 * rng.randn(48, 3, 3).astype(np.float32)
    R = np.asarray(nearest_rotation_so3(jnp.asarray(M)))
    # ground truth via SVD with det fix
    U, s, Vt = np.linalg.svd(M)
    d = np.linalg.det(np.einsum("bij,bjk->bik", U, Vt))
    fix = np.stack([np.ones_like(d), np.ones_like(d), d], -1)
    R_ref = np.einsum("bij,bj,bjk->bik", U, fix, Vt)
    np.testing.assert_allclose(R, R_ref, atol=2e-3)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-4)
    np.testing.assert_allclose(
        np.einsum("bij,bkj->bik", R, R),
        np.broadcast_to(np.eye(3), R.shape), atol=1e-4)


def test_svd3_rotational_reconstructs():
    """Gapped spectra, both det signs (signed-SVD convention: s[2] carries
    sign(det))."""
    rng = np.random.RandomState(5)
    import scipy.spatial.transform as sst
    U0 = sst.Rotation.random(64, random_state=50).as_matrix().astype(np.float32)
    V0 = sst.Rotation.random(64, random_state=51).as_matrix().astype(np.float32)
    sign = np.where(rng.rand(64) < 0.5, -1.0, 1.0).astype(np.float32)
    s_true = np.stack([np.full(64, 2.5, np.float32),
                       np.full(64, 1.2, np.float32),
                       0.4 * sign], axis=-1)
    A = np.einsum("bij,bj,bkj->bik", U0, s_true, V0)
    U, s, Vt = map(np.asarray, svd3_rotational(jnp.asarray(A)))
    recon = np.einsum("bij,bj,bjk->bik", U, s, Vt)
    np.testing.assert_allclose(recon, A, atol=2e-3)
    np.testing.assert_allclose(np.linalg.det(U), 1.0, atol=1e-3)
    np.testing.assert_allclose(np.linalg.det(Vt), 1.0, atol=1e-3)
    np.testing.assert_allclose(s[:, :2], s_true[:, :2], rtol=1e-2)
    np.testing.assert_allclose(s[:, 2], s_true[:, 2], atol=1e-2)


def test_svd3_on_essential_matrices():
    """The decompose_essential case: σ = (s, s, 0)."""
    import scipy.spatial.transform as sst
    R = sst.Rotation.random(32, random_state=6).as_matrix().astype(np.float32)
    rng = np.random.RandomState(7)
    t = rng.randn(32, 3).astype(np.float32)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    tx = np.zeros((32, 3, 3), np.float32)
    tx[:, 0, 1], tx[:, 0, 2] = -t[:, 2], t[:, 1]
    tx[:, 1, 0], tx[:, 1, 2] = t[:, 2], -t[:, 0]
    tx[:, 2, 0], tx[:, 2, 1] = -t[:, 1], t[:, 0]
    E = np.einsum("bij,bjk->bik", tx, R)
    U, s, Vt = map(np.asarray, svd3_rotational(jnp.asarray(E)))
    recon = np.einsum("bij,bj,bjk->bik", U, s, Vt)
    np.testing.assert_allclose(recon, E, atol=2e-3)
    np.testing.assert_allclose(s[:, 2], 0.0, atol=1e-4)
    np.testing.assert_allclose(s[:, 0], s[:, 1], rtol=1e-3, atol=1e-3)


def test_project_rank2_matches_svd():
    rng = np.random.RandomState(8)
    F = rng.randn(64, 3, 3).astype(np.float32)
    out = np.asarray(project_rank2(jnp.asarray(F)))
    U, s, Vt = np.linalg.svd(F)
    s0 = s.copy()
    s[..., 2] = 0.0
    ref = np.einsum("bij,bj,bjk->bik", U, s, Vt)
    # Result must be (numerically) rank-2 ...
    assert np.all(np.abs(np.linalg.det(out)) < 1e-3)
    # ... and as close to F (Frobenius) as the optimal projection: when
    # σ₂ ≈ σ₃ the minimizer is nearly non-unique, so compare distances, not
    # entries (‖F − proj‖_F = σ₃ for the optimum).
    d_out = np.linalg.norm(out - F, axis=(1, 2))
    # ≥ σ₃ always; ≤ σ₃·(1+δ) with δ from subspace mixing at small σ₂/σ₃ gaps
    assert np.all(d_out > s0[..., 2] * (1 - 1e-3))
    assert np.all(d_out < s0[..., 2] * 1.08 + 2e-3)
    # on well-separated spectra the entries match LAPACK's projection too
    gap = (s0[..., 1] - s0[..., 2]) / s0[..., 1] > 0.5
    np.testing.assert_allclose(out[gap], ref[gap], atol=5e-3)


def test_jit_and_vmap_compose():
    rng = np.random.RandomState(9)
    M = jnp.asarray(_rand_psd(rng, 8, 4))
    f = jax.jit(jax.vmap(lambda m: smallest_eigvec_psd(m)))
    v = f(M)
    assert v.shape == (8, 4)
    assert bool(jnp.all(jnp.isfinite(v)))
