"""Synthetic two-view / multi-view scene generators for tests & benchmarks.

The reference has no tests (SURVEY.md §4); these generators provide the
closed-form ground truth its console prints could not: true F/E/pose and
noise-free correspondences.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from points_matching.core.types import Pose
from points_matching.geometry.homogeneous import skew
from points_matching.geometry.se3 import so3_exp


class TwoViewScene(NamedTuple):
    p1: Array            # [N, 2] pixel coords in view 1
    p2: Array            # [N, 2] pixel coords in view 2
    X: Array             # [N, 3] world points (cam-1 frame)
    K: Array             # [3, 3] shared intrinsics
    pose: Pose           # cam1 → cam2
    E: Array             # essential (= [t]x R)
    F: Array             # fundamental (unit Frobenius norm, sign-normalized)
    mask: Array          # [N] all-True


def essential_from_pose(R: Array, t: Array) -> Array:
    """E = [t]× R for x2 ~ R x1 + t (so p2ᵀ E p1 = 0 in normalized coords)."""
    return skew(t) @ R


def make_two_view_scene(
    key: Array,
    num_points: int = 128,
    noise: float = 0.0,
    image_size: Tuple[int, int] = (640, 480),
    rotation_scale: float = 0.15,
    baseline: float = 0.5,
    outlier_fraction: float = 0.0,
) -> TwoViewScene:
    """Random well-conditioned two-view scene.

    Points are drawn in the view-1 frustum at depths 4-12; view 2 is a random
    small rotation plus a baseline translation.  With outlier_fraction > 0,
    that fraction of p2 rows is replaced by uniform random pixels (mask stays
    all-True — RANSAC is expected to find them).
    """
    w, h = image_size
    fx = fy = 0.8 * w
    cx, cy = w / 2.0, h / 2.0
    K = jnp.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], jnp.float32)

    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    # Sample in normalized image coords, unproject at random depth.
    uv = jax.random.uniform(k1, (num_points, 2), minval=-0.4, maxval=0.4)
    z = jax.random.uniform(k2, (num_points, 1), minval=4.0, maxval=12.0)
    X = jnp.concatenate([uv * z, z], axis=-1)

    wvec = rotation_scale * jax.random.normal(k3, (3,))
    R = so3_exp(wvec)
    t = baseline * jnp.asarray([1.0, 0.2, 0.1]) + 0.05 * jax.random.normal(k4, (3,))
    t = t.astype(jnp.float32)
    pose = Pose(R=R.astype(jnp.float32), t=t)

    X2 = pose.transform(X)

    def project(P):
        uvn = P[..., :2] / P[..., 2:3]
        return uvn * jnp.asarray([fx, fy]) + jnp.asarray([cx, cy])

    p1 = project(X)
    p2 = project(X2)

    if noise > 0:
        n1, n2 = jax.random.split(k5)
        p1 = p1 + noise * jax.random.normal(n1, p1.shape)
        p2 = p2 + noise * jax.random.normal(n2, p2.shape)

    if outlier_fraction > 0:
        k6, k7 = jax.random.split(k5, 2)
        num_out = int(round(outlier_fraction * num_points))
        rand_px = jax.random.uniform(
            k6, (num_points, 2), minval=jnp.asarray([0.0, 0.0]), maxval=jnp.asarray([w, h])
        )
        is_out = jnp.arange(num_points) < num_out
        perm = jax.random.permutation(k7, num_points)
        is_out = jnp.take(is_out, perm)
        p2 = jnp.where(is_out[:, None], rand_px, p2)

    E = essential_from_pose(pose.R, pose.t)
    K_inv = jnp.linalg.inv(K)
    F = K_inv.T @ E @ K_inv
    from points_matching.geometry.fundamental import _sign_normalize

    return TwoViewScene(
        p1=p1.astype(jnp.float32),
        p2=p2.astype(jnp.float32),
        X=X.astype(jnp.float32),
        K=K,
        pose=pose,
        E=E,
        F=_sign_normalize(F),
        mask=jnp.ones((num_points,), bool),
    )


def make_ba_problem(
    key: Array,
    num_cameras: int = 6,
    num_landmarks: int = 64,
    noise: float = 0.5,
    image_size: Tuple[int, int] = (640, 480),
):
    """Synthetic multi-view bundle-adjustment problem: a camera arc looking
    at a point cloud, every camera observing every landmark.

    Returns dict with K, poses (Pose [C]), X [L, 3], uv [C, L, 2] noisy
    observations, mask [C, L].
    """
    w, h = image_size
    fx = fy = 0.8 * w
    cx, cy = w / 2.0, h / 2.0
    K = jnp.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], jnp.float32)

    k1, k2, k3 = jax.random.split(key, 3)
    X = jax.random.uniform(k1, (num_landmarks, 3), minval=-2.0, maxval=2.0)
    X = X + jnp.asarray([0.0, 0.0, 8.0])

    angles = jnp.linspace(-0.3, 0.3, num_cameras)
    wvecs = jnp.stack([jnp.zeros_like(angles), angles, jnp.zeros_like(angles)], axis=-1)
    Rs = so3_exp(wvecs)
    ts = jnp.stack(
        [jnp.linspace(-1.0, 1.0, num_cameras), jnp.zeros_like(angles), jnp.zeros_like(angles)],
        axis=-1,
    )
    poses = Pose(R=Rs.astype(jnp.float32), t=ts.astype(jnp.float32))

    Xc = jnp.einsum("cij,lj->cli", poses.R, X) + poses.t[:, None, :]
    uv = Xc[..., :2] / Xc[..., 2:3] * jnp.asarray([fx, fy]) + jnp.asarray([cx, cy])
    uv = uv + noise * jax.random.normal(k2, uv.shape)

    mask = jnp.logical_and(
        jnp.logical_and(uv[..., 0] >= 0, uv[..., 0] < w),
        jnp.logical_and(uv[..., 1] >= 0, uv[..., 1] < h),
    )
    mask = jnp.logical_and(mask, Xc[..., 2] > 0.1)

    return dict(
        K=K,
        poses=poses,
        X=X.astype(jnp.float32),
        uv=uv.astype(jnp.float32),
        mask=mask,
    )


def make_sparse_ba_problem(
    seed: int = 0,
    num_cameras: int = 64,
    num_landmarks: int = 16384,
    obs_per_landmark: int = 8,
    noise: float = 0.5,
    image_size: Tuple[int, int] = (640, 480),
):
    """Synthetic BASELINE-scale sparse BA problem in observation-list form.

    Unlike ``make_ba_problem`` (every camera sees every landmark — a dense
    [C, L] grid), this builds the sparsity realistic SfM produces: each
    landmark is observed by a contiguous window of ``obs_per_landmark``
    cameras along the trajectory (track locality), so O = L·obs ≪ C·L and
    the observation-sharded solver (``ba/sparse.py``) is the only layout
    that fits.  Host-side numpy (it exists to PARAMETERIZE benchmarks and
    tests, not to run under jit).

    Returns dict with K [3,3], poses (Pose [C]), X [L,3],
    cam_idx/lm_idx/uv/obs_mask flat [O] arrays (all observations valid;
    out-of-frustum rows are masked).
    """
    w, h = image_size
    fx = fy = 0.8 * w
    cx, cy = w / 2.0, h / 2.0
    K = jnp.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], jnp.float32)

    rng = np.random.RandomState(seed)
    # landmarks spread along the trajectory corridor
    span = num_cameras * 0.25
    X = np.stack([
        rng.uniform(-span / 2 - 2, span / 2 + 2, num_landmarks),
        rng.uniform(-2.0, 2.0, num_landmarks),
        rng.uniform(6.0, 10.0, num_landmarks),
    ], axis=-1).astype(np.float32)

    angles = np.linspace(-0.3, 0.3, num_cameras)
    wvecs = np.stack([np.zeros_like(angles), angles, np.zeros_like(angles)],
                     axis=-1)
    Rs = np.asarray(so3_exp(jnp.asarray(wvecs, jnp.float32)))
    ts = np.stack([
        np.linspace(-span / 2, span / 2, num_cameras),
        np.zeros_like(angles), np.zeros_like(angles),
    ], axis=-1).astype(np.float32)
    # world→camera translation t = -R C with C the camera center: place
    # centers along the corridor so each sees the landmarks near it
    ts = -np.einsum("cij,cj->ci", Rs, ts)
    poses = Pose(R=jnp.asarray(Rs, jnp.float32), t=jnp.asarray(ts))

    # each landmark tracked by a window of cameras nearest its x position
    base = np.clip(
        np.round(
            (X[:, 0] + span / 2) / max(span, 1e-6) * (num_cameras - 1)
        ).astype(np.int64) - obs_per_landmark // 2,
        0, num_cameras - obs_per_landmark,
    )
    lm_idx = np.repeat(np.arange(num_landmarks), obs_per_landmark)
    cam_idx = (base[:, None] + np.arange(obs_per_landmark)[None, :]).reshape(-1)

    Xc = np.einsum("oij,oj->oi", Rs[cam_idx], X[lm_idx]) + ts[cam_idx]
    z = Xc[:, 2:3]
    uv = Xc[:, :2] / np.maximum(z, 1e-6) * np.asarray([fx, fy]) \
        + np.asarray([cx, cy])
    uv = (uv + noise * rng.randn(*uv.shape)).astype(np.float32)
    obs_mask = (
        (z[:, 0] > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < w)
        & (uv[:, 1] >= 0) & (uv[:, 1] < h)
    )

    return dict(
        K=K,
        poses=poses,
        X=jnp.asarray(X),
        cam_idx=jnp.asarray(cam_idx, jnp.int32),
        lm_idx=jnp.asarray(lm_idx, jnp.int32),
        uv=jnp.asarray(uv),
        obs_mask=jnp.asarray(obs_mask),
    )


def make_matched_pairs(
    batch: int,
    num_keypoints: int = 512,
    dim: int = 64,
    outlier_fraction: float = 0.3,
    seed: int = 0,
):
    """A batch of two-view matching problems with known geometry.

    Query descriptors are random unit vectors; each train set is a permuted
    noisy copy (a realistic 1-NN structure).  Query points are uniform in a
    640×480 frame; train points are their projections under a pure
    translation with 0.5 px noise, and the first ``outlier_fraction`` of
    the train rows get uniform random points.  Host-side numpy.

    Returns (d1 [B, N, D], d2 [B, N, D], p1 [B, N, 2], p2 [B, N, 2]).
    """
    rng = np.random.RandomState(seed)
    n = num_keypoints
    d1 = rng.randn(batch, n, dim).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    perm = np.stack([rng.permutation(n) for _ in range(batch)])
    d2 = np.take_along_axis(d1, perm[..., None], axis=1)
    d2 += 0.1 * rng.randn(*d2.shape).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)

    p1 = rng.uniform(0, 640, (batch, n, 2)).astype(np.float32)
    depth = rng.uniform(4, 12, (batch, n, 1)).astype(np.float32)
    K = np.array([[512.0, 0, 320], [0, 512.0, 240], [0, 0, 1]], np.float32)
    uv1 = np.concatenate([p1, np.ones((batch, n, 1), np.float32)], -1) \
        @ np.linalg.inv(K).T
    X2 = uv1 * depth + np.array([0.5, 0.05, 0.02], np.float32)
    uv2 = X2 / X2[..., 2:3]
    p2_aligned = (uv2 @ K.T)[..., :2] \
        + 0.5 * rng.randn(batch, n, 2).astype(np.float32)
    # train row j holds the descriptor of query perm[j], so its keypoint
    # is the projection of query perm[j]'s 3-D point
    p2 = np.take_along_axis(p2_aligned, perm[..., None], axis=1)
    n_out = int(outlier_fraction * n)
    p2[:, :n_out] = rng.uniform(0, 640, (batch, n_out, 2)).astype(np.float32)
    return d1, d2, p1, p2


def make_tracked_sequence(
    num_frames: int = 20,
    num_landmarks: int = 400,
    num_features: int = 256,
    noise: float = 0.3,
    seed: int = 0,
    loop: bool = False,
    image_size: Tuple[int, int] = (640, 480),
    focal: float = 500.0,
):
    """Synthetic tracked sequence for incremental SfM: a camera sliding
    along x with a slow yaw, each frame observing up to ``num_features``
    visible landmarks with ``noise`` px of pixel noise and 32-d unit
    descriptors (the landmark's descriptor + 0.05 noise).  ``loop`` runs
    out and back so the last frames revisit the first.  Host-side numpy.

    Returns (frames: list of (xy [F, 2], desc [F, 32], mask [F]) numpy
    tuples, gt_centers [num_frames, 3], (fx, fy, cx, cy)).
    """
    rng = np.random.RandomState(seed)
    w, h = image_size
    X = rng.uniform([-4, -3, 6], [4, 3, 14],
                    (num_landmarks, 3)).astype(np.float32)
    desc_gt = rng.randn(num_landmarks, 32).astype(np.float32)
    desc_gt /= np.linalg.norm(desc_gt, axis=-1, keepdims=True)

    if loop:
        half = num_frames // 2
        offs = list(range(half)) + list(range(half - 2, -2, -1))
        offs = (offs + [0] * num_frames)[:num_frames]
    else:
        offs = list(range(num_frames))

    frames, gt_centers = [], []
    for o in offs:
        R = np.asarray(so3_exp(jnp.asarray([0.0, 0.015 * o, 0.0])), np.float32)
        t = np.asarray([-0.25 * o, 0.0, 0.0], np.float32)
        gt_centers.append(-(R.T @ t))
        Xc = X @ R.T + t
        uv = Xc[:, :2] / Xc[:, 2:3] * focal + np.asarray([w / 2, h / 2])
        vis = (Xc[:, 2] > 0.5) & (uv[:, 0] >= 0) & (uv[:, 0] < w) & \
              (uv[:, 1] >= 0) & (uv[:, 1] < h)
        idx = np.nonzero(vis)[0]
        rng.shuffle(idx)
        idx = idx[:num_features]
        k = len(idx)
        xy = np.zeros((num_features, 2), np.float32)
        dd = np.zeros((num_features, 32), np.float32)
        mm = np.zeros((num_features,), bool)
        xy[:k] = uv[idx] + noise * rng.randn(k, 2)
        d = desc_gt[idx] + 0.05 * rng.randn(k, 32).astype(np.float32)
        dd[:k] = d / np.linalg.norm(d, axis=-1, keepdims=True)
        mm[:k] = True
        frames.append((xy, dd, mm))
    return frames, np.stack(gt_centers), (focal, focal, w / 2.0, h / 2.0)
