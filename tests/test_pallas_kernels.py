"""Pallas kernels vs their plain-jnp references (SURVEY.md §4 "Kernel
tests"): the Triton kernels through the Pallas interpreter on the CPU, the
``backend`` routing, and the plain XLA paths that replaced the removed
kernels (Hamming top-2, Sampson scoring) against NumPy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from points_matching.core.config import MatcherConfig, RansacConfig
from points_matching.core.types import Descriptors
from points_matching.ops.matching import (
    distance_matrix, knn_match, match_descriptors, match_descriptors_points,
)
from points_matching.ops.pallas import dispatch
from points_matching.ops.pallas.eightpoint_kernel import minimal_eight_point
from points_matching.ops.pallas.matching_kernel import fused_l2_top2


def _unit(key, shape):
    x = jax.random.normal(key, shape)
    return x / jnp.linalg.norm(x, axis=-1, keepdims=True)


def _ref_top2(q, t, t_mask, compute_dtype="f32"):
    d1 = Descriptors(data=q, mask=jnp.ones((q.shape[0],), bool))
    d2 = Descriptors(data=t, mask=t_mask)
    return knn_match(d1, d2, k=2, compute_dtype=compute_dtype)


# ------------------------------------------------------ fused L2 top-2


@pytest.mark.parametrize("n1,n2,d", [(512, 512, 64), (300, 450, 64),
                                     (64, 700, 64), (5, 3, 20),
                                     (130, 77, 32)])
def test_fused_l2_top2_matches_reference(n1, n2, d):
    """Odd sizes pad to the tiles, widths pad to a power of two; the last
    17 train rows are masked out."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    q = _unit(k1, (n1, d))
    t = _unit(k2, (n2, d))
    t_mask = jnp.arange(n2) < max(2, n2 - 17)

    ref_dist, ref_idx = _ref_top2(q, t, t_mask)
    out_dist, out_idx = fused_l2_top2(q, t, t_mask, interpret=True)

    np.testing.assert_array_equal(np.asarray(out_idx[:, 0]),
                                  np.asarray(ref_idx[:, 0]))
    np.testing.assert_allclose(np.asarray(out_dist), np.asarray(ref_dist),
                               atol=1e-5)
    # runner-up index: must differ from the 1-NN and attain the runner-up
    # distance (tie-robust — any argmin among ties is acceptable)
    dmat = np.asarray(distance_matrix(
        Descriptors(data=q, mask=jnp.ones((n1,), bool)),
        Descriptors(data=t, mask=t_mask)))
    i2 = np.asarray(out_idx[:, 1])
    assert np.all(i2 != np.asarray(out_idx[:, 0]))
    np.testing.assert_allclose(dmat[np.arange(n1), i2],
                               np.asarray(ref_dist[:, 1]), atol=1e-5)


def test_fused_l2_top2_duplicate_descriptors():
    # exact duplicates: second-best distance must equal best (both ~0)
    q = jnp.eye(8, 64, dtype=jnp.float32)
    t = jnp.concatenate([q, q], axis=0)  # every query appears twice
    t_mask = jnp.ones((16,), bool)
    dist, idx = fused_l2_top2(q, t, t_mask, block_q=16, block_t=16,
                              interpret=True)
    np.testing.assert_allclose(np.asarray(dist[:, 0]), 0.0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(dist[:, 1]), 0.0, atol=1e-6)
    # ties resolve to the lowest index; the runner-up is the other copy
    np.testing.assert_array_equal(np.asarray(idx[:, 0]), np.arange(8))
    np.testing.assert_array_equal(np.asarray(idx[:, 1]), np.arange(8) + 8)


def test_fused_l2_top2_duplicate_minima_across_tiles():
    """The duplicate sits in a later train tile than the first copy: the
    carry must keep the lower index as 1-NN and the copy as runner-up."""
    q = _unit(jax.random.PRNGKey(4), (16, 64))
    t = jnp.concatenate([q, _unit(jax.random.PRNGKey(5), (48, 64)), q])
    t_mask = jnp.ones((80,), bool)
    dist, idx = fused_l2_top2(q, t, t_mask, block_q=16, block_t=16,
                              interpret=True)
    np.testing.assert_array_equal(np.asarray(idx[:, 0]), np.arange(16))
    np.testing.assert_array_equal(np.asarray(idx[:, 1]), np.arange(16) + 64)
    np.testing.assert_allclose(np.asarray(dist), 0.0, atol=1e-5)


def test_fused_l2_top2_all_train_masked_out_but_some():
    q = jax.random.normal(jax.random.PRNGKey(1), (32, 64))
    t = jax.random.normal(jax.random.PRNGKey(2), (128, 64))
    t_mask = jnp.zeros((128,), bool).at[5].set(True)
    dist, idx = fused_l2_top2(q, t, t_mask, interpret=True)
    np.testing.assert_array_equal(np.asarray(idx[:, 0]), np.full(32, 5))
    assert np.all(np.asarray(dist[:, 1]) > 1e20)  # runner-up is the +inf pad


def test_fused_l2_top2_vmap_leading_batch():
    """vmap adds a leading grid axis; each batch row matches its own
    reference."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(9))
    q = _unit(k1, (3, 100, 64))
    t = _unit(k2, (3, 130, 64))
    m = jnp.arange(130)[None, :] < jnp.asarray([[130], [90], [17]])
    dist, idx = jax.vmap(
        lambda a, b, c: fused_l2_top2(a, b, c, interpret=True))(q, t, m)
    assert dist.shape == (3, 100, 2) and idx.shape == (3, 100, 2)
    for b in range(3):
        rd, ri = _ref_top2(q[b], t[b], m[b])
        np.testing.assert_array_equal(np.asarray(idx[b, :, 0]),
                                      np.asarray(ri[:, 0]))
        np.testing.assert_allclose(np.asarray(dist[b]), np.asarray(rd),
                                   atol=1e-5)


def test_fused_l2_top2_bf16_matches_xla_bf16():
    """bf16 operands, f32 accumulation, f32 norms — the XLA path's
    compute_dtype='bf16' semantics."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(12))
    q = _unit(k1, (200, 64))
    t = q[::-1] + 0.05 * jax.random.normal(k2, (200, 64))
    t_mask = jnp.ones((200,), bool)
    rd, ri = _ref_top2(q, t, t_mask, compute_dtype="bf16")
    dist, idx = fused_l2_top2(q, t, t_mask, compute_dtype="bf16",
                              interpret=True)
    np.testing.assert_array_equal(np.asarray(idx[:, 0]),
                                  np.asarray(ri[:, 0]))
    np.testing.assert_allclose(np.asarray(dist), np.asarray(rd), atol=2e-2)


def test_match_descriptors_pallas_backend_agrees():
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    q = _unit(k1, (200, 64))
    t = q[jnp.arange(200)[::-1]] + 0.03 * jax.random.normal(k2, (200, 64))
    t = t / jnp.linalg.norm(t, axis=-1, keepdims=True)
    d1 = Descriptors(data=q, mask=jnp.arange(200) < 190)
    d2 = Descriptors(data=t, mask=jnp.ones((200,), bool))

    ref = match_descriptors(d1, d2, MatcherConfig(backend="xla"))
    out = match_descriptors(d1, d2, MatcherConfig(backend="interpret"))

    np.testing.assert_array_equal(np.asarray(ref.mask), np.asarray(out.mask))
    m = np.asarray(ref.mask)
    np.testing.assert_array_equal(np.asarray(ref.train_idx)[m],
                                  np.asarray(out.train_idx)[m])
    np.testing.assert_allclose(np.asarray(ref.distance)[m],
                               np.asarray(out.distance)[m], atol=1e-5)


def test_match_descriptors_pallas_cross_check_agrees():
    """Mutual cross-check through the kernel (the reverse pass rides the
    same route) must agree with the XLA path."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(21))
    q = _unit(k1, (160, 64))
    t = q[jnp.arange(160)[::-1]] + 0.05 * jax.random.normal(k2, (160, 64))
    t = t / jnp.linalg.norm(t, axis=-1, keepdims=True)
    d1 = Descriptors(data=q, mask=jnp.arange(160) < 150)
    d2 = Descriptors(data=t, mask=jnp.arange(160) >= 6)

    cfg = dict(filter="ratio", ratio=0.9, cross_check=True)
    ref = match_descriptors(d1, d2, MatcherConfig(backend="xla", **cfg))
    out = match_descriptors(d1, d2, MatcherConfig(backend="interpret", **cfg))

    np.testing.assert_array_equal(np.asarray(ref.mask), np.asarray(out.mask))
    m = np.asarray(ref.mask)
    np.testing.assert_array_equal(np.asarray(ref.train_idx)[m],
                                  np.asarray(out.train_idx)[m])


def test_fused_l2_top2_points_matches_gather():
    """match_descriptors_points through the kernel: the returned point is
    the explicit gather of the returned train index on every row."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(3), 3)
    n1, n2 = 300, 450
    q = _unit(k1, (n1, 64))
    t = _unit(k2, (n2, 64))
    t_mask = jnp.arange(n2) < (n2 - 17)
    t_pts = jax.random.uniform(k3, (n2, 2), minval=0.0, maxval=993.0)
    cfg = MatcherConfig(metric="l2", filter="none", compact=False,
                        backend="interpret")
    m, pts = match_descriptors_points(
        Descriptors(data=q, mask=jnp.ones((n1,), bool)),
        Descriptors(data=t, mask=t_mask), t_pts, cfg)
    _, ri = _ref_top2(q, t, t_mask)
    np.testing.assert_array_equal(np.asarray(m.train_idx),
                                  np.asarray(ri[:, 0]))
    ref = np.asarray(t_pts)[np.asarray(m.train_idx)]
    np.testing.assert_array_equal(np.asarray(pts), ref)


def test_match_descriptors_points_fallback_agrees():
    """The ops-level wrapper's XLA path must produce the same matches and
    gathered points as match_descriptors + take."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(5), 3)
    n = 200
    q = _unit(k1, (n, 64))
    t = q + 0.1 * jax.random.normal(k2, (n, 64))
    t = t / jnp.linalg.norm(t, axis=-1, keepdims=True)
    pts = jax.random.uniform(k3, (n, 2), maxval=640.0)
    mask = jnp.ones((n,), bool)
    cfg = MatcherConfig(metric="l2", filter="ratio", ratio=0.85,
                        compact=False, backend="xla")
    m_ref = match_descriptors(Descriptors(data=q, mask=mask),
                              Descriptors(data=t, mask=mask), cfg)
    m, got = match_descriptors_points(
        Descriptors(data=q, mask=mask), Descriptors(data=t, mask=mask),
        pts, cfg)
    np.testing.assert_array_equal(np.asarray(m.mask), np.asarray(m_ref.mask))
    np.testing.assert_array_equal(np.asarray(m.train_idx),
                                  np.asarray(m_ref.train_idx))
    ref = np.asarray(pts)[np.clip(np.asarray(m_ref.train_idx), 0, n - 1)]
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-5)


# ------------------------------------------------------ minimal 8-point


def _minimal_samples(h, seed=0, num_points=64):
    from points_matching.data.synthetic import make_two_view_scene

    scene = make_two_view_scene(jax.random.PRNGKey(3), num_points=num_points,
                                noise=0.0)
    rng = np.random.RandomState(seed)
    idx = np.stack([rng.choice(num_points, 8, replace=False)
                    for _ in range(h)])
    return (jnp.asarray(np.asarray(scene.p1)[idx]),
            jnp.asarray(np.asarray(scene.p2)[idx]))


def test_minimal_eight_point_matches_reference_noise_free():
    """Fused 8-point kernel vs geometry.eight_point on NOISE-FREE minimal
    samples: λ_min(AᵀA) = 0 exactly, both fixed-iteration chains converge
    hard, entries must agree to f32 tolerance.  (On noisy samples both
    paths sit at the same algorithmic noise floor and only quality-level
    agreement holds — covered by the RANSAC end-to-end test below.)"""
    from points_matching.geometry.fundamental import eight_point

    sp1, sp2 = _minimal_samples(32)
    F_ref = eight_point(sp1, sp2)
    F_pal = minimal_eight_point(sp1, sp2, interpret=True)
    err = np.max(np.abs(np.asarray(F_ref) - np.asarray(F_pal)), axis=(1, 2))
    # unit-Frobenius matrices; a handful of ill-conditioned samples (near-
    # collinear draws) may sit higher — median must be at rounding level
    assert np.median(err) < 2e-4, np.median(err)
    assert np.mean(err < 1e-2) >= 0.9, err

    # degenerate sample (all points identical): finite garbage, no NaN
    spd = jnp.ones((1, 8, 2), jnp.float32) * 5.0
    Fd = minimal_eight_point(spd, spd, interpret=True)
    assert bool(jnp.all(jnp.isfinite(Fd)))


def test_minimal_eight_point_batch_shapes():
    """Any leading batch shape, and a batch that is not a multiple of the
    block (padding rows are sliced away); vmap gives the same answer."""
    from points_matching.geometry.fundamental import eight_point

    sp1, sp2 = _minimal_samples(150, seed=1)
    F = minimal_eight_point(sp1.reshape(3, 50, 8, 2),
                            sp2.reshape(3, 50, 8, 2), block_h=64,
                            interpret=True)
    assert F.shape == (3, 50, 3, 3)
    Fv = jax.vmap(lambda a, b: minimal_eight_point(a, b, interpret=True))(
        sp1.reshape(3, 50, 8, 2), sp2.reshape(3, 50, 8, 2))
    np.testing.assert_allclose(np.asarray(F), np.asarray(Fv), atol=1e-6)
    err = np.max(np.abs(np.asarray(F).reshape(150, 3, 3)
                        - np.asarray(eight_point(sp1, sp2))), axis=(1, 2))
    assert np.median(err) < 2e-4, np.median(err)


def test_ransac_fundamental_pallas_backend_agrees():
    """End-to-end RANSAC with the minimal solve in the kernel must pick an
    equivalent model (same inlier set) as the XLA chain."""
    rng = np.random.RandomState(0)
    N = 256
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    X = np.concatenate(
        [rng.uniform(-2, 2, (N, 2)), rng.uniform(4, 8, (N, 1))], axis=1
    ).astype(np.float32)
    p1 = (X / X[:, 2:3]) @ K.T
    X2 = X + np.array([0.3, 0.05, 0.0], np.float32)
    p2 = (X2 / X2[:, 2:3]) @ K.T
    p1, p2 = p1[:, :2], p2[:, :2]
    p2[: N // 3] = rng.uniform(0, 640, (N // 3, 2))  # outliers

    from points_matching.geometry.ransac import ransac_fundamental

    key = jax.random.PRNGKey(0)
    mask = jnp.ones((N,), bool)
    ref = ransac_fundamental(key, jnp.asarray(p1), jnp.asarray(p2), mask,
                             RansacConfig(num_hypotheses=128, backend="xla"))
    out = ransac_fundamental(
        key, jnp.asarray(p1), jnp.asarray(p2), mask,
        RansacConfig(num_hypotheses=128, backend="interpret"))
    # per-hypothesis F's agree with the XLA chain only to the inverse-
    # iteration noise floor, so the two paths are equivalent-quality, not
    # bit-equal: both must recover the true consensus and agree on (nearly)
    # the same inlier set.
    rm = np.asarray(ref.inlier_mask)
    om = np.asarray(out.inlier_mask)
    overlap = (rm & om).sum() / max(1, (rm | om).sum())
    assert overlap >= 0.9, f"inlier-set IoU {overlap:.2f}"
    assert int(out.num_inliers) >= int(0.6 * N)
    assert int(ref.num_inliers) >= int(0.6 * N)


# ------------------------------------------------------ routing


def _lowered(fn, platform, *args):
    return jax.jit(fn).trace(*args).lower(
        lowering_platforms=(platform,)).as_text()


def test_auto_routes_kernel_on_cuda_and_xla_on_cpu():
    """'auto' lowers the Triton kernel for a CUDA device and the plain XLA
    path for the CPU, from one traced function — for bf16 operands; f32
    matching stays on XLA everywhere (the kernel lost to it there)."""
    q = _unit(jax.random.PRNGKey(0), (64, 64))
    m = jnp.ones((64,), bool)

    def matcher(dtype):
        def f(a, b):
            return match_descriptors(
                Descriptors(a, m), Descriptors(b, m),
                MatcherConfig(compute_dtype=dtype)).mask
        return f

    assert "triton" in _lowered(matcher("bf16"), "cuda", q, q)
    assert "triton" not in _lowered(matcher("bf16"), "cpu", q, q)
    assert "triton" not in _lowered(matcher("f32"), "cuda", q, q)
    # an explicit request still compiles the kernel in f32
    f = lambda a, b: match_descriptors(  # noqa: E731
        Descriptors(a, m), Descriptors(b, m),
        MatcherConfig(backend="pallas")).mask
    assert "triton" in _lowered(f, "cuda", q, q)


def test_xla_backend_never_lowers_kernel():
    sp1, sp2 = _minimal_samples(16)
    f = lambda a, b: dispatch("xla", minimal_eight_point,  # noqa: E731
                              jax.vmap(lambda x, y: x + y), a, b)
    assert "triton" not in _lowered(f, "cuda", sp1, sp2)
    g = lambda a, b: dispatch("auto", minimal_eight_point,  # noqa: E731
                              lambda x, y: jnp.zeros(x.shape[:-2] + (3, 3)),
                              a, b)
    assert "triton" in _lowered(g, "cuda", sp1, sp2)


def test_dispatch_rejects_unknown_backend():
    with pytest.raises(ValueError, match="unknown backend"):
        dispatch("tensorcore", lambda *a, interpret: a, lambda *a: a, 1.0)


def test_l2_distance_matrix_precision_argument():
    """compute_dtype='f32' pins HIGHEST (no TF32 on a GPU); 'bf16' feeds
    bf16 operands at DEFAULT precision."""
    from points_matching.ops.matching import l2_distance_matrix

    a = jnp.ones((8, 16))
    b = jnp.ones((4, 16))

    def dot_params(dtype):
        jaxpr = jax.make_jaxpr(
            lambda x, y: l2_distance_matrix(x, y, dtype))(a, b)
        eqns = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
        assert len(eqns) == 1
        return eqns[0].params["precision"], eqns[0].invars[0].aval.dtype

    prec, dt = dot_params("f32")
    assert prec == (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert dt == jnp.float32
    prec, dt = dot_params("bf16")
    assert prec in (None, (jax.lax.Precision.DEFAULT,) * 2)
    assert dt == jnp.bfloat16


# ------------------------------------------------------ plain paths vs NumPy
# (replacing the removed Hamming and Sampson-scoring kernels' tests)


def _np_hamming(a, b):
    x = np.bitwise_xor(a[:, None, :], b[None, :, :])
    bits = np.unpackbits(x.view(np.uint8), axis=-1)
    return bits.sum(axis=-1).astype(np.int64)


@pytest.mark.parametrize("n1,n2", [(256, 512), (100, 300)])
def test_hamming_distance_matrix_matches_numpy(n1, n2):
    from points_matching.ops.matching import hamming_distance_matrix

    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    q = np.array(jax.random.bits(k1, (n1, 8), jnp.uint32))
    t = np.array(jax.random.bits(k2, (n2, 8), jnp.uint32))
    t[:50] = q[:50]
    got = np.asarray(hamming_distance_matrix(jnp.asarray(q), jnp.asarray(t)))
    np.testing.assert_array_equal(got, _np_hamming(q, t))


def test_hamming_top2_matches_numpy():
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    n1, n2 = 120, 200
    q = np.array(jax.random.bits(k1, (n1, 8), jnp.uint32))
    t = np.array(jax.random.bits(k2, (n2, 8), jnp.uint32))
    t[:40] = q[:40]
    t_mask = np.arange(n2) < n2 - 13
    dist, idx = knn_match(
        Descriptors(jnp.asarray(q), jnp.ones((n1,), bool), binary=True),
        Descriptors(jnp.asarray(t), jnp.asarray(t_mask), binary=True),
        k=2, metric="hamming")
    ref = _np_hamming(q, t).astype(np.float64)
    ref[:, ~t_mask] = np.inf
    order = np.sort(ref, axis=1)
    np.testing.assert_array_equal(np.asarray(dist), order[:, :2])
    np.testing.assert_array_equal(np.asarray(idx[:, 0]),
                                  np.argmin(ref, axis=1))
    np.testing.assert_array_equal(np.asarray(dist[:40, 0]), 0.0)


def test_match_descriptors_hamming_ratio_matches_numpy():
    k1, k2 = jax.random.split(jax.random.PRNGKey(11))
    q = np.array(jax.random.bits(k1, (128, 8), jnp.uint32))
    flips = (np.asarray(jax.random.uniform(k2, (128, 8, 32))) < 0.02)
    t = q ^ np.packbits(flips, axis=-1, bitorder="little").view(
        np.uint32).reshape(128, 8)
    qm = np.arange(128) < 120
    out = match_descriptors(
        Descriptors(jnp.asarray(q), jnp.asarray(qm), binary=True),
        Descriptors(jnp.asarray(t), jnp.ones((128,), bool), binary=True),
        MatcherConfig(metric="hamming", filter="ratio", ratio=0.8,
                      compact=False))
    d = _np_hamming(q, t).astype(np.float64)
    srt = np.sort(d, axis=1)
    keep = (srt[:, 0] < 0.8 * np.maximum(srt[:, 1], 1e-12)) & qm
    np.testing.assert_array_equal(np.asarray(out.mask), keep)
    np.testing.assert_array_equal(np.asarray(out.train_idx)[keep],
                                  np.argmin(d, axis=1)[keep])


def _np_sampson_counts(F, p1, p2, mask, thr):
    F = np.asarray(F, np.float64)
    x1 = np.concatenate([p1, np.ones((len(p1), 1))], 1).astype(np.float64)
    x2 = np.concatenate([p2, np.ones((len(p2), 1))], 1).astype(np.float64)
    Fx1 = np.einsum("hij,nj->hni", F, x1)
    Ftx2 = np.einsum("hji,nj->hni", F, x2)
    num = np.einsum("ni,hni->hn", x2, Fx1) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2
           + Ftx2[..., 1] ** 2)
    d = num / den
    return ((d < thr ** 2) & mask[None]).sum(-1), d


@pytest.mark.parametrize("h,n", [(512, 512), (100, 300)])
def test_sampson_inlier_counts_match_numpy(h, n):
    """The [H, N] Sampson gate + count that scores RANSAC hypotheses, in
    f32 on the device, against float64 NumPy (rows within 1e-3 of the
    gate may flip)."""
    from points_matching.geometry.fundamental import sampson_distance

    ks = jax.random.split(jax.random.PRNGKey(5), 3)
    F_h = jax.random.normal(ks[0], (h, 3, 3))
    p1 = jax.random.uniform(ks[1], (n, 2), minval=0, maxval=640)
    p2 = p1 + 2.0 * jax.random.normal(ks[2], (n, 2))
    mask = np.arange(n) < n - 7
    thr = 1.5
    got = jnp.sum(jnp.logical_and(
        sampson_distance(F_h, p1[None], p2[None]) < thr ** 2,
        jnp.asarray(mask)[None]).astype(jnp.int32), axis=-1)
    ref, d = _np_sampson_counts(np.asarray(F_h), np.asarray(p1),
                                np.asarray(p2), mask, thr)
    near = (np.abs(d - thr ** 2) < 1e-3 * thr ** 2) & mask[None]
    assert np.all(np.abs(np.asarray(got) - ref) <= near.sum(-1))


def test_ransac_counts_vmap_match_numpy():
    """The same scoring under vmap over pairs (the batched two-view path)."""
    from points_matching.geometry.fundamental import sampson_distance

    ks = jax.random.split(jax.random.PRNGKey(6), 3)
    B, H, N = 3, 64, 128
    F_b = jax.random.normal(ks[0], (B, H, 3, 3))
    p1 = jax.random.uniform(ks[1], (B, N, 2), minval=0, maxval=640)
    p2 = p1 + 2.0 * jax.random.normal(ks[2], (B, N, 2))
    thr = 1.5
    got = jax.vmap(lambda f, a, b: jnp.sum(
        (sampson_distance(f, a[None], b[None]) < thr ** 2).astype(jnp.int32),
        axis=-1))(F_b, p1, p2)
    for b in range(B):
        ref, d = _np_sampson_counts(np.asarray(F_b[b]), np.asarray(p1[b]),
                                    np.asarray(p2[b]), np.ones(N, bool), thr)
        near = np.abs(d - thr ** 2) < 1e-3 * thr ** 2
        assert np.all(np.abs(np.asarray(got[b]) - ref) <= near.sum(-1))
