"""Geometry-core unit tests (SURVEY.md §4: closed-form / oracle checks)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from points_matching.core.types import Pose
from points_matching.data.synthetic import make_two_view_scene
from points_matching.geometry import (
    compute_epilines,
    decompose_essential,
    eight_point,
    epipolar_residual_audit,
    epipolar_residuals,
    essential_from_fundamental,
    fundamental_from_essential,
    from_homogeneous,
    hartley_normalize,
    recover_pose,
    sampson_distance,
    se3_exp,
    se3_log,
    seven_point,
    skew,
    so3_exp,
    so3_log,
    to_homogeneous,
    triangulate_dlt,
)
from points_matching.geometry.fundamental import _sign_normalize


def _f_dist(Fa, Fb):
    """Distance between fundamental matrices modulo scale/sign."""
    Fa = np.asarray(Fa) / np.linalg.norm(Fa)
    Fb = np.asarray(Fb) / np.linalg.norm(Fb)
    return min(np.linalg.norm(Fa - Fb), np.linalg.norm(Fa + Fb))


class TestHomogeneous:
    def test_roundtrip(self):
        x = jnp.asarray([[1.0, 2.0], [3.0, 4.0]])
        assert jnp.allclose(from_homogeneous(to_homogeneous(x)), x)

    def test_skew_cross(self):
        a = jnp.asarray([1.0, -2.0, 0.5])
        b = jnp.asarray([0.3, 4.0, -1.0])
        assert jnp.allclose(skew(a) @ b, jnp.cross(a, b), atol=1e-6)


class TestHartley:
    def test_stats(self):
        pts = jax.random.uniform(jax.random.PRNGKey(0), (100, 2)) * 500.0
        pn, T = hartley_normalize(pts)
        assert jnp.allclose(jnp.mean(pn, axis=0), 0.0, atol=1e-4)
        assert jnp.allclose(jnp.mean(jnp.linalg.norm(pn, axis=-1)), np.sqrt(2), atol=1e-4)
        # T applied to homogeneous points reproduces pn
        ph = to_homogeneous(pts) @ T.T
        assert jnp.allclose(ph[:, :2], pn, atol=1e-4)

    def test_masked(self):
        pts = jax.random.uniform(jax.random.PRNGKey(1), (50, 2)) * 100.0
        mask = jnp.arange(50) < 30
        # garbage in the masked-out rows must not affect the transform
        pts_dirty = pts.at[30:].set(1e6)
        _, T_clean = hartley_normalize(pts[:30])
        _, T_masked = hartley_normalize(pts_dirty, mask.astype(jnp.float32))
        assert jnp.allclose(T_clean, T_masked, rtol=1e-4, atol=1e-4)


class TestEightPoint:
    def test_noise_free_exact(self):
        scene = make_two_view_scene(jax.random.PRNGKey(2), num_points=64)
        F = eight_point(scene.p1, scene.p2)
        r = epipolar_residuals(F, scene.p1, scene.p2)
        # residuals for a unit-norm F on ~VGA pixels: near machine epsilon
        assert float(jnp.max(jnp.abs(r))) < 1e-2
        assert _f_dist(F, scene.F) < 1e-3
        # rank 2
        s = jnp.linalg.svd(F, compute_uv=False)
        assert float(s[2]) < 1e-6

    def test_masked_ignores_outliers(self):
        scene = make_two_view_scene(jax.random.PRNGKey(3), num_points=64)
        p2_bad = scene.p2.at[:16].add(250.0)
        w = (jnp.arange(64) >= 16).astype(jnp.float32)
        F = eight_point(scene.p1, p2_bad, w)
        assert _f_dist(F, scene.F) < 1e-3

    def test_batched(self):
        keys = jax.random.split(jax.random.PRNGKey(4), 5)
        scenes = [make_two_view_scene(k, num_points=32) for k in keys]
        P1 = jnp.stack([s.p1 for s in scenes])
        P2 = jnp.stack([s.p2 for s in scenes])
        F = eight_point(P1, P2)
        assert F.shape == (5, 3, 3)
        for i, s in enumerate(scenes):
            assert _f_dist(F[i], s.F) < 1e-3

    def test_vs_opencv(self):
        cv2 = pytest.importorskip("cv2")
        scene = make_two_view_scene(jax.random.PRNGKey(5), num_points=48, noise=0.3)
        p1 = np.asarray(scene.p1, np.float64)
        p2 = np.asarray(scene.p2, np.float64)
        F_cv, _ = cv2.findFundamentalMat(p1, p2, cv2.FM_8POINT)
        F = eight_point(scene.p1, scene.p2)
        assert _f_dist(F, F_cv) < 5e-3


class TestSevenPoint:
    def test_exact_seven(self):
        scene = make_two_view_scene(jax.random.PRNGKey(6), num_points=7)
        Fs, valid = seven_point(scene.p1, scene.p2)
        assert Fs.shape == (3, 3, 3)
        assert bool(jnp.any(valid))
        # at least one candidate must fit the true geometry
        dists = [
            _f_dist(Fs[i], scene.F) if bool(valid[i]) else np.inf for i in range(3)
        ]
        assert min(dists) < 5e-3

    def test_candidates_satisfy_constraints(self):
        scene = make_two_view_scene(jax.random.PRNGKey(7), num_points=7)
        Fs, valid = seven_point(scene.p1, scene.p2)
        for i in range(3):
            if bool(valid[i]):
                r = epipolar_residuals(Fs[i], scene.p1, scene.p2)
                assert float(jnp.max(jnp.abs(r))) < 1e-2
                s = jnp.linalg.svd(Fs[i], compute_uv=False)
                assert float(s[2] / s[0]) < 1e-3

    def test_vs_opencv(self):
        cv2 = pytest.importorskip("cv2")
        scene = make_two_view_scene(jax.random.PRNGKey(8), num_points=7)
        p1 = np.asarray(scene.p1, np.float64)
        p2 = np.asarray(scene.p2, np.float64)
        F_cv, _ = cv2.findFundamentalMat(p1, p2, cv2.FM_7POINT)
        assert F_cv is not None
        n_cv = F_cv.shape[0] // 3
        Fs, valid = seven_point(scene.p1, scene.p2)
        ours = [np.asarray(Fs[i]) for i in range(3) if bool(valid[i])]
        # every OpenCV solution matches one of ours
        for k in range(n_cv):
            d = min(_f_dist(F_cv[3 * k : 3 * k + 3], F) for F in ours)
            assert d < 1e-2


class TestResidualsAndLines:
    def test_audit_forms(self):
        scene = make_two_view_scene(jax.random.PRNGKey(9), num_points=32)
        r_std, m_std = epipolar_residual_audit(scene.F, scene.p1, scene.p2, form="standard")
        assert float(m_std) < 1e-4
        # reference (transposed) form is computable and finite
        r_ref, m_ref = epipolar_residual_audit(scene.F, scene.p1, scene.p2, form="reference")
        assert np.isfinite(float(m_ref))

    def test_masked_mean(self):
        scene = make_two_view_scene(jax.random.PRNGKey(10), num_points=32)
        p2_bad = scene.p2.at[16:].add(100.0)
        mask = jnp.arange(32) < 16
        _, m = epipolar_residual_audit(scene.F, scene.p1, p2_bad, mask, form="standard")
        assert float(m) < 1e-4

    def test_epilines_contain_matches(self):
        scene = make_two_view_scene(jax.random.PRNGKey(11), num_points=32)
        lines2 = compute_epilines(scene.p1, 1, scene.F)
        # matching point in image 2 lies on the line: |a x + b y + c| ≈ 0
        d = jnp.abs(jnp.sum(lines2[:, :2] * scene.p2, axis=-1) + lines2[:, 2])
        assert float(jnp.max(d)) < 1e-2
        lines1 = compute_epilines(scene.p2, 2, scene.F)
        d1 = jnp.abs(jnp.sum(lines1[:, :2] * scene.p1, axis=-1) + lines1[:, 2])
        assert float(jnp.max(d1)) < 1e-2

    def test_epilines_vs_opencv(self):
        cv2 = pytest.importorskip("cv2")
        scene = make_two_view_scene(jax.random.PRNGKey(12), num_points=16)
        F = np.asarray(eight_point(scene.p1, scene.p2), np.float64)
        ours = np.asarray(compute_epilines(scene.p1, 1, jnp.asarray(F, jnp.float32)))
        cv = cv2.computeCorrespondEpilines(
            np.asarray(scene.p1, np.float64).reshape(-1, 1, 2), 1, F
        ).reshape(-1, 3)
        # lines are defined up to sign
        for a, b in zip(ours, cv):
            assert min(np.linalg.norm(a - b), np.linalg.norm(a + b)) < 1e-3

    def test_sampson_zero_on_inliers(self):
        scene = make_two_view_scene(jax.random.PRNGKey(13), num_points=32)
        d = sampson_distance(scene.F, scene.p1, scene.p2)
        assert float(jnp.max(d)) < 1e-4


class TestSE3:
    def test_so3_roundtrip(self):
        w = jnp.asarray([[0.1, -0.2, 0.3], [1e-7, 0, 0], [2.0, 1.0, -0.5]])
        R = so3_exp(w)
        # orthonormal, det 1
        assert jnp.allclose(R @ jnp.swapaxes(R, -1, -2), jnp.eye(3), atol=1e-5)
        assert jnp.allclose(jnp.linalg.det(R), 1.0, atol=1e-5)
        w2 = so3_log(R)
        assert jnp.allclose(w, w2, atol=1e-4)

    def test_so3_log_near_pi(self):
        axis = jnp.asarray([0.6, 0.8, 0.0])
        w = axis * 3.10
        R = so3_exp(w)
        w2 = so3_log(R)
        assert jnp.allclose(jnp.abs(w), jnp.abs(w2), atol=1e-2)

    def test_se3_roundtrip(self):
        xi = jnp.asarray([[0.1, 0.2, -0.3, 0.05, -0.1, 0.2], [0.0] * 6])
        R, t = se3_exp(xi)
        xi2 = se3_log(R, t)
        assert jnp.allclose(xi, xi2, atol=1e-4)

    def test_pose_compose_inverse(self):
        k = jax.random.PRNGKey(14)
        R = so3_exp(jax.random.normal(k, (3,)) * 0.5)
        t = jax.random.normal(jax.random.fold_in(k, 1), (3,))
        p = Pose(R=R, t=t)
        pi = p.inverse()
        ident = p.compose(pi)
        assert jnp.allclose(ident.R, jnp.eye(3), atol=1e-5)
        assert jnp.allclose(ident.t, 0.0, atol=1e-5)


class TestTriangulation:
    def test_roundtrip(self):
        scene = make_two_view_scene(jax.random.PRNGKey(15), num_points=32)
        eye34 = jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=-1)
        P1 = scene.K @ eye34
        P2 = scene.K @ scene.pose.matrix34()
        X, ok = triangulate_dlt(P1, P2, scene.p1, scene.p2)
        assert bool(jnp.all(ok))
        assert jnp.allclose(X, scene.X, atol=1e-2, rtol=1e-3)


class TestPoseRecovery:
    def test_recover_pose(self):
        scene = make_two_view_scene(jax.random.PRNGKey(16), num_points=64)
        K_inv = jnp.linalg.inv(scene.K)
        p1n = (to_homogeneous(scene.p1) @ K_inv.T)[:, :2]
        p2n = (to_homogeneous(scene.p2) @ K_inv.T)[:, :2]
        pose, X, good = recover_pose(scene.E, p1n, p2n, scene.mask)
        assert int(jnp.sum(good)) == 64
        assert jnp.allclose(pose.R, scene.pose.R, atol=1e-3)
        t_est = pose.t / jnp.linalg.norm(pose.t)
        t_true = scene.pose.t / jnp.linalg.norm(scene.pose.t)
        assert float(jnp.linalg.norm(t_est - t_true)) < 1e-3

    def test_essential_fundamental_roundtrip(self):
        scene = make_two_view_scene(jax.random.PRNGKey(17), num_points=32)
        E = essential_from_fundamental(scene.F, scene.K, scene.K)
        F2 = fundamental_from_essential(E, scene.K, scene.K)
        assert _f_dist(F2, scene.F) < 1e-4
