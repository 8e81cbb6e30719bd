"""End-to-end two-view pipeline tests — the reference demo's behavior on its
own bundled images (golden/parity tests, SURVEY.md §4)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from points_matching.core.config import (
    DetectorConfig,
    MatcherConfig,
    TwoViewConfig,
    orb_default_config,
    surf_parity_config,
)
from points_matching.pipelines.two_view import run_two_view_demo, two_view_pipeline

REF_DIR = "/root/reference/Points Matching"
IMG1 = os.path.join(REF_DIR, "img01.JPG")
IMG2 = os.path.join(REF_DIR, "img02.JPG")

needs_images = pytest.mark.skipif(
    not (os.path.exists(IMG1) and os.path.exists(IMG2)),
    reason="reference images unavailable",
)


def _small_config(use_ransac: bool, **matcher_kw) -> TwoViewConfig:
    base = surf_parity_config()
    return TwoViewConfig(
        detector=DetectorConfig(kind="hessian", threshold=8000.0, max_keypoints=256,
                                num_octaves=3),
        descriptor=base.descriptor,
        matcher=MatcherConfig(metric="l2", **matcher_kw),
        use_ransac=use_ransac,
    )


@needs_images
def test_reference_parity_pipeline(tmp_path):
    """SURF-class → 1-NN → midpoint filter → 8-point F on the demo's bundled
    img01/img02 (main.cpp:14-15 commented-in alternative)."""
    res = run_two_view_demo(
        IMG1,
        IMG2,
        config=_small_config(use_ransac=False, filter="midpoint"),
        out_dir=str(tmp_path),
        verbose=False,
    )
    n_kp1 = int(np.asarray(res.kps1.mask).sum())
    n_kp2 = int(np.asarray(res.kps2.mask).sum())
    n_matches = int(np.asarray(res.matches.mask).sum())
    assert n_kp1 > 50 and n_kp2 > 50
    assert n_matches >= 8
    # F is rank 2 and unit norm
    F = np.asarray(res.estimate.F)
    s = np.linalg.svd(F, compute_uv=False)
    assert s[2] / s[0] < 1e-5
    assert np.isclose(np.linalg.norm(F), 1.0, atol=1e-4)
    # the three reference windows were rendered
    for f in ["keypoints1.png", "keypoints2.png", "matches.png", "epilines.png"]:
        assert (tmp_path / f).exists()


@needs_images
def test_ransac_pipeline_inliers(tmp_path):
    res = run_two_view_demo(
        IMG1,
        IMG2,
        config=_small_config(use_ransac=True, filter="ratio", ratio=0.85),
        verbose=False,
    )
    n_matches = int(np.asarray(res.matches.mask).sum())
    n_inl = int(res.estimate.num_inliers)
    assert n_matches >= 20
    assert n_inl >= 12
    # RANSAC inliers must have small Sampson distance under the model
    from points_matching.geometry import sampson_distance

    d = sampson_distance(
        jnp.asarray(res.estimate.F), jnp.asarray(res.p1), jnp.asarray(res.p2)
    )
    inl = np.asarray(res.estimate.inlier_mask)
    assert float(np.median(np.asarray(d)[inl])) < 2.0**2


@needs_images
def test_eight_point_agrees_with_opencv_on_same_matches():
    """Oracle check: on OUR matched inlier points, our F and OpenCV's F must
    agree (the solver-parity half of the golden test)."""
    cv2 = pytest.importorskip("cv2")
    res = run_two_view_demo(
        IMG1, IMG2, config=_small_config(use_ransac=True, filter="ratio", ratio=0.85),
        verbose=False,
    )
    inl = np.asarray(res.estimate.inlier_mask) & np.asarray(res.matches.mask)
    p1 = np.asarray(res.p1)[inl].astype(np.float64)
    p2 = np.asarray(res.p2)[inl].astype(np.float64)
    if len(p1) < 9:
        pytest.skip("too few inliers")
    F_cv, _ = cv2.findFundamentalMat(p1, p2, cv2.FM_8POINT)
    from points_matching.geometry import eight_point

    F = np.asarray(eight_point(jnp.asarray(p1, jnp.float32), jnp.asarray(p2, jnp.float32)))
    F_cv = F_cv / np.linalg.norm(F_cv)
    d = min(np.linalg.norm(F - F_cv), np.linalg.norm(F + F_cv))
    assert d < 2e-2


def test_pipeline_jit_static_shapes():
    """Pipeline compiles once and returns fixed shapes for any image pair."""
    rng = np.random.RandomState(0)
    im1 = jnp.asarray(rng.rand(120, 160).astype(np.float32) * 255.0)
    im2 = jnp.asarray(rng.rand(120, 160).astype(np.float32) * 255.0)
    cfg = _small_config(use_ransac=True, filter="ratio")
    res = two_view_pipeline(im1, im2, jax.random.PRNGKey(0), cfg)
    assert res.kps1.xy.shape == (256, 2)
    assert res.estimate.F.shape == (3, 3)
    assert res.epilines2.shape[-1] == 3


def test_orb_config_pipeline():
    """BASELINE config 0: ORB detect + hamming ratio match + RANSAC."""
    rng = np.random.RandomState(2)
    from points_matching.ops.detect import gaussian_blur

    base = gaussian_blur(jnp.asarray(rng.rand(160, 200).astype(np.float32)) * 255.0, 1.2)
    im2 = jnp.roll(base, (4, 9), axis=(0, 1))
    cfg = orb_default_config()
    res = two_view_pipeline(base, im2, jax.random.PRNGKey(1), cfg)
    n = int(np.asarray(res.matches.mask).sum())
    assert n >= 16
    p1, p2 = np.asarray(res.p1), np.asarray(res.p2)
    valid = np.asarray(res.matches.mask)
    med = np.median((p2 - p1)[valid], axis=0)
    assert np.allclose(med, [9, 4], atol=1.0)
