"""Incremental SfM integration tests on a synthetic sequence
(SURVEY.md §4 "Integration tests": trajectory ATE bound)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from points_matching.core.config import (
    MatcherConfig,
    RansacConfig,
    SfMConfig,
    TwoViewConfig,
)
from points_matching.core.types import CameraIntrinsics, Pose
from points_matching.geometry.pnp import pnp_dlt, ransac_pnp
from points_matching.geometry.se3 import so3_exp
from points_matching.pipelines.sfm import camera_centers, run_incremental_sfm
from points_matching.utils.evaluation import absolute_trajectory_error


def _make_sequence(num_frames=10, num_landmarks=300, n_feat=256, seed=0,
                   px_noise=0.3):
    """Synthetic trajectory: camera sweeping sideways viewing a cloud of
    descriptor-tagged landmarks; per-frame features = visible projections
    with noisy copies of the landmark descriptor."""
    rng = np.random.RandomState(seed)
    w, h = 640, 480
    fx = fy = 500.0
    K = CameraIntrinsics(fx=jnp.float32(fx), fy=jnp.float32(fy),
                         cx=jnp.float32(w / 2), cy=jnp.float32(h / 2))

    X = rng.uniform([-4, -3, 6], [4, 3, 14], (num_landmarks, 3)).astype(np.float32)
    desc_gt = rng.randn(num_landmarks, 32).astype(np.float32)
    desc_gt /= np.linalg.norm(desc_gt, axis=-1, keepdims=True)

    Rs, ts, frames = [], [], []
    for i in range(num_frames):
        ang = 0.02 * i
        R = np.asarray(so3_exp(jnp.asarray([0.0, ang, 0.0])), np.float32)
        t = np.asarray([-0.35 * i, 0.0, 0.0], np.float32)  # world→cam translation
        Rs.append(R), ts.append(t)
        Xc = X @ R.T + t
        uv = Xc[:, :2] / Xc[:, 2:3] * np.asarray([fx, fy]) + np.asarray([w / 2, h / 2])
        vis = (Xc[:, 2] > 0.5) & (uv[:, 0] >= 0) & (uv[:, 0] < w) & \
              (uv[:, 1] >= 0) & (uv[:, 1] < h)
        idx = np.nonzero(vis)[0]
        rng.shuffle(idx)
        idx = idx[:n_feat]
        k = len(idx)
        xy = np.zeros((n_feat, 2), np.float32)
        dd = np.zeros((n_feat, 32), np.float32)
        mm = np.zeros((n_feat,), bool)
        xy[:k] = uv[idx] + px_noise * rng.randn(k, 2)
        d = desc_gt[idx] + 0.05 * rng.randn(k, 32).astype(np.float32)
        dd[:k] = d / np.linalg.norm(d, axis=-1, keepdims=True)
        mm[:k] = True
        frames.append((jnp.asarray(xy), jnp.asarray(dd), jnp.asarray(mm)))

    gt_centers = np.stack([-(R.T @ t) for R, t in zip(Rs, ts)])
    return frames, K, jnp.asarray(gt_centers), X


def _sfm_config():
    return SfMConfig(
        two_view=TwoViewConfig(
            matcher=MatcherConfig(metric="l2", filter="ratio", ratio=0.8),
            ransac=RansacConfig(num_hypotheses=256, inlier_threshold=2.0),
        ),
        max_cameras=16,
        max_landmarks=1024,
        max_observations=8192,
        pnp_min_inliers=12,
    )


def test_pnp_dlt_exact():
    rng = np.random.RandomState(0)
    X = rng.uniform(-2, 2, (32, 3)).astype(np.float32) + [0, 0, 8]
    R = np.asarray(so3_exp(jnp.asarray([0.1, -0.2, 0.05])), np.float32)
    t = np.asarray([0.3, -0.1, 0.5], np.float32)
    Xc = X @ R.T + t
    uvn = Xc[:, :2] / Xc[:, 2:3]
    pose = pnp_dlt(jnp.asarray(X), jnp.asarray(uvn))
    np.testing.assert_allclose(np.asarray(pose.R), R, atol=1e-3)
    np.testing.assert_allclose(np.asarray(pose.t), t, atol=1e-2)


def test_ransac_pnp_with_outliers():
    rng = np.random.RandomState(1)
    N = 128
    X = rng.uniform(-2, 2, (N, 3)).astype(np.float32) + [0, 0, 8]
    R = np.asarray(so3_exp(jnp.asarray([0.05, 0.15, -0.1])), np.float32)
    t = np.asarray([0.2, 0.1, -0.3], np.float32)
    Xc = X @ R.T + t
    uvn = (Xc[:, :2] / Xc[:, 2:3]).astype(np.float32)
    uvn[: N // 3] = rng.uniform(-0.5, 0.5, (N // 3, 2))  # 33% outliers
    res = ransac_pnp(jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(uvn),
                     jnp.ones((N,), bool), inlier_threshold=0.01)
    assert int(res.num_inliers) > N // 2
    np.testing.assert_allclose(np.asarray(res.pose.R), R, atol=1e-3)
    np.testing.assert_allclose(np.asarray(res.pose.t), t, atol=1e-2)


def test_incremental_sfm_trajectory():
    frames, K, gt_centers, _ = _make_sequence(num_frames=10)
    res = run_incremental_sfm(frames, K, _sfm_config(), ba_every=4)
    assert all(res.registered), f"frames dropped: {res.registered}"

    est = np.asarray(res.trajectory)[: len(frames)]
    ate = absolute_trajectory_error(jnp.asarray(est), gt_centers)
    # monocular scale is free → Sim(3)-aligned ATE; trajectory spans ~3.2
    # world units, so 5cm-equivalent bound = 1.5% of extent
    assert float(ate.rmse) < 0.05, f"ATE rmse {float(ate.rmse)}"


def test_incremental_sfm_map_consistency():
    frames, K, _, X_gt = _make_sequence(num_frames=6)
    res = run_incremental_sfm(frames, K, _sfm_config(), ba_every=3)
    st = res.state
    n_lms = int(st.num_lms)
    n_obs = int(st.num_obs)
    assert n_lms > 50
    assert n_obs > 2 * n_lms  # every landmark observed ≥ 2×
    # observation indices point at valid cameras/landmarks
    oc = np.asarray(st.obs_cam)[np.asarray(st.obs_mask)]
    ol = np.asarray(st.obs_lm)[np.asarray(st.obs_mask)]
    assert oc.max() < int(st.num_cams)
    assert ol.max() < n_lms
    lm_mask = np.asarray(st.lm_mask)
    assert lm_mask.sum() == n_lms


def test_ate_alignment_invariance():
    rng = np.random.RandomState(3)
    gt = rng.randn(20, 3).astype(np.float32)
    R = np.asarray(so3_exp(jnp.asarray([0.3, 0.1, -0.2])), np.float32)
    est = 2.5 * gt @ R.T + np.asarray([1.0, -2.0, 0.5], np.float32)
    ate = absolute_trajectory_error(jnp.asarray(est), jnp.asarray(gt))
    assert float(ate.rmse) < 1e-5  # similarity transform fully removed
    np.testing.assert_allclose(float(ate.scale), 1 / 2.5, rtol=1e-4)
