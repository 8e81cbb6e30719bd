"""Golden parity tests: our geometry/matching vs OpenCV as oracle on the
SAME inputs (SURVEY.md §4 "Golden/parity tests" — the reference's entire
compute stack IS OpenCV, so agreeing with cv2 is agreeing with the
reference's semantics; call sites cited per test)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from points_matching.core.config import MatcherConfig
from points_matching.core.types import CameraIntrinsics, Descriptors, Pose
from points_matching.data.synthetic import make_two_view_scene
from points_matching.geometry import (
    compute_epilines,
    eight_point,
    epipolar_residuals,
    ransac_fundamental,
    triangulate_dlt,
)
from points_matching.geometry.fundamental import _sign_normalize
from points_matching.geometry.pnp import ransac_pnp
from points_matching.geometry.pose import recover_pose
from points_matching.ops.matching import match_descriptors


def _scene(noise=0.3, n=96, outliers=0.0, seed=0):
    return make_two_view_scene(
        jax.random.PRNGKey(seed), num_points=n, noise=noise,
        outlier_fraction=outliers,
    )


def _norm(F):
    return np.asarray(_sign_normalize(jnp.asarray(F, jnp.float32)))


# ---------------------------------------------------------------------------
# Matching (reference main.cpp:44-46 — FLANN 1-NN; BFMatcher = exact oracle)
# ---------------------------------------------------------------------------

def test_bruteforce_1nn_matches_cv2():
    rng = np.random.RandomState(0)
    d1 = rng.randn(128, 64).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 = rng.randn(160, 64).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)

    bf = cv2.BFMatcher(cv2.NORM_L2)
    cv_matches = bf.match(d1, d2)
    cv_train = {m.queryIdx: m.trainIdx for m in cv_matches}
    cv_dist = {m.queryIdx: m.distance for m in cv_matches}

    ours = match_descriptors(
        Descriptors(data=jnp.asarray(d1), mask=jnp.ones(128, bool)),
        Descriptors(data=jnp.asarray(d2), mask=jnp.ones(160, bool)),
        MatcherConfig(metric="l2", filter="none"),
    )
    q = np.asarray(ours.query_idx)
    t = np.asarray(ours.train_idx)
    d = np.asarray(ours.distance)
    m = np.asarray(ours.mask)
    for qi, ti, di in zip(q[m], t[m], d[m]):
        assert cv_train[int(qi)] == int(ti)
        np.testing.assert_allclose(di, cv_dist[int(qi)], rtol=1e-4)


def test_midpoint_filter_matches_reference_rule():
    """The demo's keep-if d < min + (max-min)/2 with min init 1, max init 0
    (main.cpp:49-69)."""
    rng = np.random.RandomState(1)
    d1 = rng.randn(64, 32).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 = d1 + 0.1 * rng.randn(64, 32).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)

    bf = cv2.BFMatcher(cv2.NORM_L2)
    cv_matches = bf.match(d1, d2)
    dists = np.asarray([m.distance for m in cv_matches])
    dmin = min(dists.min(), 1.0)
    dmax = max(dists.max(), 0.0)
    keep_ref = {m.queryIdx for m in cv_matches
                if m.distance < dmin + (dmax - dmin) / 2}

    ours = match_descriptors(
        Descriptors(data=jnp.asarray(d1), mask=jnp.ones(64, bool)),
        Descriptors(data=jnp.asarray(d2), mask=jnp.ones(64, bool)),
        MatcherConfig(metric="l2", filter="midpoint"),
    )
    keep_ours = set(np.asarray(ours.query_idx)[np.asarray(ours.mask)].tolist())
    assert keep_ours == keep_ref


# ---------------------------------------------------------------------------
# Fundamental matrix (main.cpp:95-98)
# ---------------------------------------------------------------------------

def test_eight_point_matches_cv2_fm8point():
    sc = _scene(noise=0.2)
    p1 = np.asarray(sc.p1, np.float64)
    p2 = np.asarray(sc.p2, np.float64)
    F_cv, _ = cv2.findFundamentalMat(p1, p2, cv2.FM_8POINT)
    F_ours = eight_point(sc.p1, sc.p2)
    np.testing.assert_allclose(_norm(F_ours), _norm(F_cv), atol=2e-3)


def test_seven_point_contains_cv2_solution():
    from points_matching.geometry import seven_point

    sc = _scene(noise=0.0, n=7)
    F_cv, _ = cv2.findFundamentalMat(
        np.asarray(sc.p1, np.float64), np.asarray(sc.p2, np.float64),
        cv2.FM_7POINT,
    )
    Fs, valid = seven_point(sc.p1, sc.p2)
    ours = [_norm(Fs[i]) for i in range(3) if bool(valid[i])]
    # every cv2 root must match one of ours
    for k in range(F_cv.shape[0] // 3):
        F_k = _norm(F_cv[3 * k: 3 * k + 3])
        errs = [np.abs(F_k - Fo).max() for Fo in ours]
        assert min(errs) < 5e-3, f"root {k}: {errs}"


def test_find_fundamental_exactly7_dispatch_matches_cv2():
    """The exact call the reference makes — findFundamentalMat(CV_FM_7POINT)
    with exactly 7 points (main.cpp:95-98) — through our dispatch."""
    from points_matching.geometry import find_fundamental

    sc = _scene(noise=0.0, n=16, seed=2)
    mask = jnp.arange(16) < 7  # exactly 7 valid → 7-point branch
    Fs, valid = find_fundamental(sc.p1, sc.p2, mask)
    F_cv, _ = cv2.findFundamentalMat(
        np.asarray(sc.p1[:7], np.float64), np.asarray(sc.p2[:7], np.float64),
        cv2.FM_7POINT,
    )
    ours = [_norm(Fs[i]) for i in range(3) if bool(valid[i])]
    for k in range(F_cv.shape[0] // 3):
        F_k = _norm(F_cv[3 * k: 3 * k + 3])
        errs = [np.abs(F_k - Fo).max() for Fo in ours]
        assert min(errs) < 5e-3, f"root {k}: {errs}"

    # >7 valid → 8-point least-squares branch (OpenCV 2.4's fallback)
    from points_matching.geometry import eight_point as _8pt

    full_mask = jnp.ones((16,), bool)
    Fs8, valid8 = find_fundamental(sc.p1, sc.p2, full_mask)
    assert bool(valid8[0]) and not bool(valid8[1])
    np.testing.assert_allclose(
        _norm(Fs8[0]), _norm(_8pt(sc.p1, sc.p2)), atol=1e-5
    )


def test_ransac_7pt_inliers_match_cv2():
    """7-point minimal sampling through the full RANSAC path vs cv2's
    FM_RANSAC consensus (cv2's own RANSAC also samples 7-point sets)."""
    from points_matching.core.config import RansacConfig

    sc = _scene(noise=0.5, n=256, outliers=0.3, seed=4)
    est = ransac_fundamental(
        jax.random.PRNGKey(0), sc.p1, sc.p2, sc.mask,
        RansacConfig(solver="7pt", num_hypotheses=512),
    )
    F_cv, mask_cv = cv2.findFundamentalMat(
        np.asarray(sc.p1, np.float64), np.asarray(sc.p2, np.float64),
        cv2.FM_RANSAC, 1.5, 0.999,
    )
    ours = np.asarray(est.inlier_mask)
    cv = mask_cv.ravel().astype(bool)
    iou = (ours & cv).sum() / max((ours | cv).sum(), 1)
    assert iou > 0.85, f"inlier IoU {iou}"


def test_ransac_inliers_match_cv2():
    sc = _scene(noise=0.5, n=256, outliers=0.3, seed=4)
    est = ransac_fundamental(jax.random.PRNGKey(0), sc.p1, sc.p2, sc.mask)
    F_cv, mask_cv = cv2.findFundamentalMat(
        np.asarray(sc.p1, np.float64), np.asarray(sc.p2, np.float64),
        cv2.FM_RANSAC, 1.5, 0.999,
    )
    ours = np.asarray(est.inlier_mask)
    cv = mask_cv.ravel().astype(bool)
    # the two RANSACs must agree on the consensus set (IoU, not equality —
    # threshold semantics differ slightly)
    iou = (ours & cv).sum() / max((ours | cv).sum(), 1)
    assert iou > 0.85, f"inlier IoU {iou}"


# ---------------------------------------------------------------------------
# Epilines (main.cpp:127-143)
# ---------------------------------------------------------------------------

def test_epilines_match_cv2():
    sc = _scene()
    F = np.asarray(eight_point(sc.p1, sc.p2), np.float64)
    lines_cv = cv2.computeCorrespondEpilines(
        np.asarray(sc.p1).reshape(-1, 1, 2), 1, F
    ).reshape(-1, 3)
    lines_ours = np.asarray(compute_epilines(sc.p1, 1, jnp.asarray(F, jnp.float32)))
    # both are (a,b,c) with a²+b²=1, up to sign
    sign = np.sign(np.sum(lines_cv * lines_ours, axis=1, keepdims=True))
    np.testing.assert_allclose(lines_ours * sign, lines_cv, atol=1e-3)


# ---------------------------------------------------------------------------
# Pose recovery + triangulation (BASELINE config 2; cv2.recoverPose oracle)
# ---------------------------------------------------------------------------

def test_recover_pose_matches_cv2():
    sc = _scene(noise=0.0)
    K = np.asarray(sc.K, np.float64)
    E = np.asarray(sc.E, np.float64)
    _, R_cv, t_cv, _ = cv2.recoverPose(
        E, np.asarray(sc.p1, np.float64), np.asarray(sc.p2, np.float64), K
    )
    Kj = CameraIntrinsics.from_matrix(sc.K)
    pose, X, cheir = recover_pose(
        sc.E, Kj.normalize_points(sc.p1), Kj.normalize_points(sc.p2),
        sc.mask,
    )
    np.testing.assert_allclose(np.asarray(pose.R), R_cv, atol=1e-4)
    t_ours = np.asarray(pose.t) / np.linalg.norm(np.asarray(pose.t))
    np.testing.assert_allclose(t_ours, t_cv.ravel(), atol=1e-4)


def test_triangulation_matches_cv2():
    sc = _scene(noise=0.0)
    K = np.asarray(sc.K, np.float64)
    P1 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = K @ np.hstack([np.asarray(sc.pose.R), np.asarray(sc.pose.t)[:, None]])
    X_cv = cv2.triangulatePoints(
        P1, P2, np.asarray(sc.p1, np.float64).T, np.asarray(sc.p2, np.float64).T
    )
    X_cv = (X_cv[:3] / X_cv[3]).T
    X_ours, ok = triangulate_dlt(
        jnp.asarray(P1, jnp.float32), jnp.asarray(P2, jnp.float32),
        sc.p1, sc.p2,
    )
    assert bool(jnp.all(ok))
    np.testing.assert_allclose(np.asarray(X_ours), X_cv, atol=5e-2)


def test_pnp_matches_cv2_solvepnp():
    sc = _scene(noise=0.0)
    K = np.asarray(sc.K, np.float64)
    X = np.asarray(sc.X, np.float64)
    p2 = np.asarray(sc.p2, np.float64)
    ok, rvec, tvec, inl = cv2.solvePnPRansac(
        X, p2.reshape(-1, 1, 2), K, None, flags=cv2.SOLVEPNP_ITERATIVE
    )
    R_cv, _ = cv2.Rodrigues(rvec)
    Kj = CameraIntrinsics.from_matrix(sc.K)
    res = ransac_pnp(
        jax.random.PRNGKey(0), sc.X, Kj.normalize_points(sc.p2),
        sc.mask, inlier_threshold=0.01,
    )
    np.testing.assert_allclose(np.asarray(res.pose.R), R_cv, atol=1e-3)
    np.testing.assert_allclose(np.asarray(res.pose.t), tvec.ravel(), atol=1e-2)


# ---------------------------------------------------------------------------
# The reference's own audit statistic (main.cpp:103-123)
# ---------------------------------------------------------------------------

def test_residual_audit_form_matches_manual():
    sc = _scene(noise=0.2)
    F = eight_point(sc.p1, sc.p2)
    r = np.asarray(epipolar_residuals(F, sc.p1, sc.p2))
    Fn = np.asarray(F, np.float64)
    p1h = np.hstack([np.asarray(sc.p1), np.ones((sc.p1.shape[0], 1))])
    p2h = np.hstack([np.asarray(sc.p2), np.ones((sc.p2.shape[0], 1))])
    manual = np.einsum("ni,ij,nj->n", p2h, Fn, p1h)
    np.testing.assert_allclose(r, manual, atol=1e-3)
