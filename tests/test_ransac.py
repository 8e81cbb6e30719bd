"""Batched-RANSAC tests (SURVEY.md §4; BASELINE configs 0-1)."""
import jax
import jax.numpy as jnp
import numpy as np

from points_matching.core.config import RansacConfig
from points_matching.data.synthetic import make_two_view_scene
from points_matching.geometry import ransac_fundamental, sampson_distance


def test_ransac_clean_scene():
    scene = make_two_view_scene(jax.random.PRNGKey(0), num_points=128, noise=0.3)
    est = ransac_fundamental(jax.random.PRNGKey(1), scene.p1, scene.p2, scene.mask)
    assert int(est.num_inliers) > 120
    d = sampson_distance(est.F, scene.p1, scene.p2)
    assert float(jnp.median(d)) < 1.0


def test_ransac_with_outliers():
    scene = make_two_view_scene(
        jax.random.PRNGKey(2), num_points=256, noise=0.3, outlier_fraction=0.4
    )
    cfg = RansacConfig(num_hypotheses=1024, inlier_threshold=2.0)
    est = ransac_fundamental(jax.random.PRNGKey(3), scene.p1, scene.p2, scene.mask, cfg)
    # ~60% inliers in the scene; RANSAC should find most of them
    n_in = int(est.num_inliers)
    assert 256 * 0.45 < n_in <= 256 * 0.7
    # recovered F must gate the true inliers: compare against true-F sampson
    d_true = sampson_distance(scene.F, scene.p1, scene.p2)
    true_inliers = d_true < 2.0**2
    agree = jnp.mean(
        (est.inlier_mask == true_inliers).astype(jnp.float32)
    )
    assert float(agree) > 0.9


def test_ransac_respects_mask():
    scene = make_two_view_scene(jax.random.PRNGKey(4), num_points=64, noise=0.2)
    # poison half the rows, mask them out
    p2 = scene.p2.at[32:].add(300.0)
    mask = jnp.arange(64) < 32
    est = ransac_fundamental(jax.random.PRNGKey(5), scene.p1, p2, mask)
    assert not bool(jnp.any(est.inlier_mask[32:]))
    assert int(est.num_inliers) >= 28


def test_ransac_7pt_with_outliers():
    scene = make_two_view_scene(
        jax.random.PRNGKey(2), num_points=256, noise=0.3, outlier_fraction=0.4
    )
    cfg = RansacConfig(solver="7pt", num_hypotheses=1024, inlier_threshold=2.0)
    est = ransac_fundamental(jax.random.PRNGKey(3), scene.p1, scene.p2, scene.mask, cfg)
    n_in = int(est.num_inliers)
    assert 256 * 0.45 < n_in <= 256 * 0.7
    d_true = sampson_distance(scene.F, scene.p1, scene.p2)
    true_inliers = d_true < 2.0**2
    agree = jnp.mean((est.inlier_mask == true_inliers).astype(jnp.float32))
    assert float(agree) > 0.9


def test_ransac_7pt_sample_efficiency():
    """At a small fixed hypothesis count and high outlier rate, 7-point
    minimal samples (all-inlier probability (1-ε)^7 vs (1-ε)^8, ×3 roots)
    must find at least as much consensus as 8-point sampling — the
    sample-efficiency argument for minimal solvers (VERDICT r1 item 4)."""
    wins_7, wins_8 = 0, 0
    for seed in range(6):
        scene = make_two_view_scene(
            jax.random.PRNGKey(100 + seed), num_points=256, noise=0.3,
            outlier_fraction=0.5,
        )
        k = jax.random.PRNGKey(seed)
        n7 = int(ransac_fundamental(
            k, scene.p1, scene.p2, scene.mask,
            RansacConfig(solver="7pt", num_hypotheses=24, refit=False),
        ).num_inliers)
        n8 = int(ransac_fundamental(
            k, scene.p1, scene.p2, scene.mask,
            RansacConfig(solver="8pt", num_hypotheses=24, refit=False),
        ).num_inliers)
        wins_7 += n7 >= n8
        wins_8 += n8 > n7
    assert wins_7 >= wins_8, f"7pt won {wins_7}/6 trials vs 8pt {wins_8}"


def test_ransac_jit_and_deterministic():
    scene = make_two_view_scene(jax.random.PRNGKey(6), num_points=96, noise=0.2)
    f = jax.jit(
        lambda k: ransac_fundamental(k, scene.p1, scene.p2, scene.mask)
    )
    a = f(jax.random.PRNGKey(7))
    b = f(jax.random.PRNGKey(7))
    assert jnp.allclose(a.F, b.F)
    assert int(a.num_inliers) == int(b.num_inliers)


def test_sample_index_sets_properties():
    """Stratified inverse-CDF sampler: no duplicates within a set, only
    valid indices, ~uniform marginal inclusion, and logits bias the draw
    (the contract geometry/pnp.py and ransac_fundamental rely on)."""
    from points_matching.geometry.ransac import sample_index_sets

    mask = jnp.arange(100) < 80
    idx = np.asarray(sample_index_sets(jax.random.PRNGKey(0), mask, 512, 8))
    assert idx.shape == (512, 8)
    assert all(len(set(r)) == 8 for r in idx), "duplicate index in a set"
    assert (idx < 80).all(), "invalid index sampled"

    counts = np.bincount(idx.ravel(), minlength=100)
    expect = 512 * 8 / 80
    # every valid index reachable, none wildly over-sampled
    assert counts[:80].min() > 0
    assert counts[:80].max() < 3 * expect

    # weighted: the 10 heavy rows (logit +3 ≈ e³ ≈ 20× weight) must be
    # drawn far above their uniform share
    logits = jnp.where(jnp.arange(100) < 10, 3.0, 0.0)
    idx2 = np.asarray(
        sample_index_sets(jax.random.PRNGKey(1), mask, 512, 8, logits=logits)
    )
    assert all(len(set(r)) == 8 for r in idx2)
    frac_heavy = (idx2 < 10).mean()
    assert frac_heavy > 2.5 * (10 / 80), frac_heavy

    # starving mask (fewer valid than sample_size): still shaped, still
    # in-range picks; callers gate on inlier counts downstream
    mask2 = jnp.arange(100) < 3
    idx3 = np.asarray(sample_index_sets(jax.random.PRNGKey(2), mask2, 16, 8))
    assert ((0 <= idx3) & (idx3 < 100)).all()
