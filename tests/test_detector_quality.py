"""Detector/match quality evidence (VERDICT r1 item 8).

Two measurable corridors replace the old ``>50 keypoints`` smoke assertion
(the reference's SURF detect+match is `main.cpp:23-46`; its only quality
signal was eyeballing the imshow windows):

1. **Repeatability** — top-256 Hessian keypoints on ``img01.JPG`` must be
   re-detected within 2px under known homography warps (rotation, scale,
   translation).  Calibrated values on this image: 0.89 / 0.70 / 0.94 / 1.00
   for the four warps below; we assert >=0.65 each and >=0.78 mean.
2. **cv2 corridor** — on the bundled pair, our full ratio+RANSAC pipeline
   must land in the quality corridor spanned by cv2 SIFT and ORB with the
   same budget (256 features, 0.85 ratio, RANSAC F).  Calibrated:
   SIFT 141 matches / 0.943 inlier ratio, ORB 198 / 0.869,
   ours 176 / 0.932.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from points_matching.core.config import (
    DetectorConfig,
    MatcherConfig,
    TwoViewConfig,
    surf_parity_config,
)
from points_matching.data.images import load_image
from points_matching.ops.detect import detect_keypoints

REF_DIR = "/root/reference/Points Matching"
IMG1 = os.path.join(REF_DIR, "img01.JPG")
IMG2 = os.path.join(REF_DIR, "img02.JPG")

needs_images = pytest.mark.skipif(
    not (os.path.exists(IMG1) and os.path.exists(IMG2)),
    reason="reference images unavailable",
)

_DET = DetectorConfig(kind="hessian", threshold=8000.0, max_keypoints=256,
                      num_octaves=3)
_BORDER = 16  # keypoints projected into the warp border are not scoreable


def _detect_xy(img: np.ndarray) -> np.ndarray:
    kp = detect_keypoints(jnp.asarray(img), _DET)
    return np.asarray(kp.xy)[np.asarray(kp.mask)]


def _warp_matrix(cv2, shape, angle_deg, scale, tx, ty) -> np.ndarray:
    h, w = shape
    M = np.eye(3, dtype=np.float64)
    M[:2] = cv2.getRotationMatrix2D((w / 2, h / 2), angle_deg, scale)
    M[0, 2] += tx
    M[1, 2] += ty
    return M


@needs_images
def test_repeatability_under_homography():
    cv2 = pytest.importorskip("cv2")
    img = load_image(IMG1, grayscale=True)
    h, w = img.shape
    base = _detect_xy(img)
    assert len(base) >= 200

    warps = [(5, 1.0, 0, 0), (0, 0.9, 0, 0), (10, 1.1, 8, -5), (0, 1.0, 12, 7)]
    reps = []
    for angle, scale, tx, ty in warps:
        M = _warp_matrix(cv2, (h, w), angle, scale, tx, ty)
        warped = cv2.warpPerspective(img, M, (w, h), flags=cv2.INTER_LINEAR)
        kw = _detect_xy(warped)

        proj = (M @ np.concatenate([base, np.ones((len(base), 1))], axis=1).T).T
        proj = proj[:, :2] / proj[:, 2:3]
        inb = ((proj[:, 0] >= _BORDER) & (proj[:, 0] < w - _BORDER)
               & (proj[:, 1] >= _BORDER) & (proj[:, 1] < h - _BORDER))
        proj = proj[inb]
        assert len(proj) >= 150 and len(kw) >= 150

        d = np.linalg.norm(proj[:, None, :] - kw[None, :, :], axis=-1).min(axis=1)
        rep = float(np.mean(d < 2.0))
        reps.append(rep)
        assert rep >= 0.65, f"repeatability {rep:.3f} @2px under warp {(angle, scale, tx, ty)}"
    assert float(np.mean(reps)) >= 0.78, reps


def _cv2_quality(cv2, det, norm, g1, g2, ratio=0.85):
    """cv2 oracle: detect → BF 2-NN ratio test → RANSAC F. Returns
    (good_matches, inliers, inlier_ratio)."""
    k1, d1 = det.detectAndCompute(g1, None)
    k2, d2 = det.detectAndCompute(g2, None)
    knn = cv2.BFMatcher(norm).knnMatch(d1, d2, k=2)
    good = [m for m, n in knn if m.distance < ratio * n.distance]
    p1 = np.float32([k1[m.queryIdx].pt for m in good])
    p2 = np.float32([k2[m.trainIdx].pt for m in good])
    _, mask = cv2.findFundamentalMat(p1, p2, cv2.FM_RANSAC, 1.5, 0.999)
    n_inl = int(mask.sum()) if mask is not None else 0
    return len(good), n_inl, n_inl / max(len(good), 1)


@needs_images
def test_match_quality_corridor_vs_cv2():
    cv2 = pytest.importorskip("cv2")
    from points_matching.pipelines.two_view import run_two_view_demo

    g1 = cv2.imread(IMG1, cv2.IMREAD_GRAYSCALE)
    g2 = cv2.imread(IMG2, cv2.IMREAD_GRAYSCALE)
    sift_m, sift_inl, sift_ratio = _cv2_quality(
        cv2, cv2.SIFT_create(nfeatures=256), cv2.NORM_L2, g1, g2)
    orb_m, orb_inl, orb_ratio = _cv2_quality(
        cv2, cv2.ORB_create(nfeatures=256), cv2.NORM_HAMMING, g1, g2)

    base = surf_parity_config()
    cfg = TwoViewConfig(
        detector=_DET,
        descriptor=base.descriptor,
        matcher=MatcherConfig(metric="l2", filter="ratio", ratio=0.85),
        use_ransac=True,
    )
    res = run_two_view_demo(IMG1, IMG2, config=cfg, verbose=False)
    n_m = int(np.asarray(res.matches.mask).sum())
    n_inl = int(res.estimate.num_inliers)
    ratio = n_inl / max(n_m, 1)

    # corridor: at least half the match/inlier volume of the stronger cv2
    # detector, and an inlier ratio competitive with both (ours measures
    # 0.932 vs SIFT 0.943 / ORB 0.869 on this pair)
    assert n_m >= 0.5 * max(sift_m, orb_m), (n_m, sift_m, orb_m)
    assert n_inl >= 0.5 * max(sift_inl, orb_inl), (n_inl, sift_inl, orb_inl)
    assert ratio >= 0.85, ratio
    assert ratio >= 0.9 * min(sift_ratio, orb_ratio), (ratio, sift_ratio, orb_ratio)
