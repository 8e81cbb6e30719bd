"""Matching-op tests: GEMM distance vs scipy cdist, top-k vs argsort,
filters incl. the reference's midpoint rule (SURVEY.md §4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from points_matching.core.config import MatcherConfig
from points_matching.core.types import Descriptors
from points_matching.ops.matching import (
    distance_matrix,
    hamming_distance_matrix,
    knn_match,
    l2_distance_matrix,
    match_descriptors,
    match_stats,
)


def _rand_desc(key, n, d=64, valid=None):
    data = jax.random.normal(key, (n, d))
    data = data / jnp.linalg.norm(data, axis=-1, keepdims=True)
    mask = jnp.ones((n,), bool) if valid is None else jnp.arange(n) < valid
    return Descriptors(data=data.astype(jnp.float32), mask=mask)


def test_l2_matches_cdist():
    from scipy.spatial.distance import cdist

    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    a = np.asarray(jax.random.normal(k1, (37, 64)))
    b = np.asarray(jax.random.normal(k2, (53, 64)))
    ours = np.asarray(l2_distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    ref = cdist(a, b, "sqeuclidean")
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


def test_hamming_matches_numpy():
    rng = np.random.RandomState(0)
    a = rng.randint(0, 2**32, size=(20, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.randint(0, 2**32, size=(15, 8), dtype=np.uint64).astype(np.uint32)
    ours = np.asarray(hamming_distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    xor = a[:, None, :] ^ b[None, :, :]
    ref = np.unpackbits(xor.view(np.uint8), axis=-1).sum(-1)
    np.testing.assert_array_equal(ours, ref)


def test_knn_vs_argsort():
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    d1 = _rand_desc(k1, 40)
    d2 = _rand_desc(k2, 60)
    dist, idx = knn_match(d1, d2, k=2)
    full = np.asarray(l2_distance_matrix(d1.data, d2.data))
    ref_idx = np.argsort(full, axis=-1)[:, :2]
    np.testing.assert_array_equal(np.asarray(idx), ref_idx)


def test_masked_rows_excluded():
    k1, k2 = jax.random.split(jax.random.PRNGKey(2))
    d1 = _rand_desc(k1, 32, valid=20)
    d2 = _rand_desc(k2, 32, valid=25)
    m = match_descriptors(d1, d2, MatcherConfig(filter="none"))
    valid = np.asarray(m.mask)
    qi = np.asarray(m.query_idx)[valid]
    ti = np.asarray(m.train_idx)[valid]
    assert (qi < 20).all()
    assert (ti < 25).all()


def test_identity_matching():
    d = _rand_desc(jax.random.PRNGKey(3), 50)
    m = match_descriptors(d, d, MatcherConfig(filter="threshold", threshold=1e-3))
    valid = np.asarray(m.mask)
    assert valid.sum() == 50
    np.testing.assert_array_equal(
        np.asarray(m.query_idx)[valid], np.asarray(m.train_idx)[valid]
    )


def test_midpoint_filter_reference_semantics():
    """Reproduce main.cpp:49-69 on a hand-built distance configuration."""
    # descriptors placed so 1-NN distances are known exactly
    d2 = jnp.eye(8, dtype=jnp.float32)
    # queries: close to basis vectors with varying offsets
    offsets = jnp.asarray([0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7])[:, None]
    d1 = d2 + offsets * jnp.ones((8, 8)) / jnp.sqrt(8.0)
    desc1 = Descriptors(data=d1, mask=jnp.ones(8, bool))
    desc2 = Descriptors(data=d2, mask=jnp.ones(8, bool))
    m = match_descriptors(desc1, desc2, MatcherConfig(filter="none"))
    dmin, dmax = match_stats(m)
    dmin_r = min(float(jnp.min(m.distance)), 1.0)  # ref init: minMatch=1
    dmax_r = max(float(jnp.max(m.distance)), 0.0)
    assert np.isclose(float(dmin), dmin_r)
    assert np.isclose(float(dmax), dmax_r)

    mp = match_descriptors(desc1, desc2, MatcherConfig(filter="midpoint"))
    thresh = dmin_r + (dmax_r - dmin_r) / 2.0
    expect = np.asarray(m.distance) < thresh
    got = np.zeros(8, bool)
    got[np.asarray(mp.query_idx)[np.asarray(mp.mask)]] = True
    want = np.zeros(8, bool)
    want[np.asarray(m.query_idx)[expect & np.asarray(m.mask)]] = True
    np.testing.assert_array_equal(got, want)


def test_ratio_filter():
    # query 0: ambiguous (two equidistant trains); query 1: unambiguous
    d1 = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], jnp.float32)
    d2 = jnp.asarray(
        [[0.9, 0.1, 0.0], [0.9, -0.1, 0.0], [0.0, 1.0, 0.05]], jnp.float32
    )
    m = match_descriptors(
        Descriptors(data=d1, mask=jnp.ones(2, bool)),
        Descriptors(data=d2, mask=jnp.ones(3, bool)),
        MatcherConfig(filter="ratio", ratio=0.8),
    )
    valid = np.asarray(m.mask)
    kept_queries = set(np.asarray(m.query_idx)[valid].tolist())
    assert kept_queries == {1}


def test_cross_check():
    # train 0 is the best for BOTH queries; cross-check keeps only the mutual pair
    d1 = jnp.asarray([[1.0, 0.0], [0.8, 0.1]], jnp.float32)
    d2 = jnp.asarray([[1.0, 0.05]], jnp.float32)
    m = match_descriptors(
        Descriptors(data=d1, mask=jnp.ones(2, bool)),
        Descriptors(data=d2, mask=jnp.ones(1, bool)),
        MatcherConfig(filter="none", cross_check=True),
    )
    valid = np.asarray(m.mask)
    assert valid.sum() == 1
    assert np.asarray(m.query_idx)[valid][0] == 0


def test_match_vs_opencv_bfmatcher():
    cv2 = pytest.importorskip("cv2")
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    d1 = _rand_desc(k1, 100)
    d2 = _rand_desc(k2, 120)
    m = match_descriptors(d1, d2, MatcherConfig(filter="none"))
    bf = cv2.BFMatcher(cv2.NORM_L2)
    cv_matches = bf.match(np.asarray(d1.data), np.asarray(d2.data))
    cv_by_q = {mm.queryIdx: mm for mm in cv_matches}
    valid = np.asarray(m.mask)
    for q, t, d in zip(
        np.asarray(m.query_idx)[valid],
        np.asarray(m.train_idx)[valid],
        np.asarray(m.distance)[valid],
    ):
        assert cv_by_q[int(q)].trainIdx == int(t)
        assert abs(cv_by_q[int(q)].distance - float(d)) < 1e-3


def test_match_descriptors_uncompacted_agrees():
    """compact=False (query-order + mask) must contain exactly the same
    matches as the compacted form."""
    import jax

    from points_matching.core.config import MatcherConfig
    from points_matching.core.types import Descriptors
    from points_matching.ops.matching import match_descriptors

    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    q = jax.random.normal(k1, (200, 32))
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    t = q[jnp.arange(200)[::-1]] + 0.05 * jax.random.normal(k2, (200, 32))
    t = t / jnp.linalg.norm(t, axis=-1, keepdims=True)
    d1 = Descriptors(data=q, mask=jnp.arange(200) < 180)
    d2 = Descriptors(data=t, mask=jnp.ones((200,), bool))

    ref = match_descriptors(d1, d2, MatcherConfig(ratio=0.9))
    raw = match_descriptors(d1, d2, MatcherConfig(ratio=0.9, compact=False))

    # identical (query, train, distance) sets
    rm = np.asarray(ref.mask)
    pairs_ref = set(zip(np.asarray(ref.query_idx)[rm].tolist(),
                        np.asarray(ref.train_idx)[rm].tolist()))
    m = np.asarray(raw.mask)
    assert np.array_equal(np.asarray(raw.query_idx), np.arange(200))
    pairs_raw = set(zip(np.asarray(raw.query_idx)[m].tolist(),
                        np.asarray(raw.train_idx)[m].tolist()))
    assert pairs_ref == pairs_raw
    np.testing.assert_allclose(
        np.sort(np.asarray(ref.distance)[rm]),
        np.sort(np.asarray(raw.distance)[m]), atol=1e-6)
