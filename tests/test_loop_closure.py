"""Loop detection + pose-graph closure tests (BASELINE config 3)."""
import jax
import jax.numpy as jnp
import numpy as np

from points_matching.core.types import CameraIntrinsics, Pose
from points_matching.geometry.se3 import se3_exp, so3_exp
from points_matching.pipelines.loop_closure import (
    close_loops,
    detect_loop_candidates,
    verify_loop,
)

from tests.test_sfm import _sfm_config


def _revisit_sequence(num_frames=12, num_landmarks=400, n_feat=256, seed=0):
    """Camera pans right then returns to the start — frame N-1 revisits
    frame 0's view."""
    rng = np.random.RandomState(seed)
    w, h, fx = 640, 480, 500.0
    K = CameraIntrinsics(fx=jnp.float32(fx), fy=jnp.float32(fx),
                         cx=jnp.float32(w / 2), cy=jnp.float32(h / 2))
    X = rng.uniform([-14, -3, 6], [14, 3, 14], (num_landmarks, 3)).astype(np.float32)
    desc_gt = rng.randn(num_landmarks, 32).astype(np.float32)
    desc_gt /= np.linalg.norm(desc_gt, axis=-1, keepdims=True)

    # out-and-back translation: 0 … peak … back to 0
    half = num_frames // 2
    offsets = list(range(half)) + list(range(half - 2, -2, -1))[: num_frames - half]
    Rs, ts, frames = [], [], []
    for i in range(num_frames):
        o = offsets[i]
        R = np.eye(3, dtype=np.float32)
        t = np.asarray([-1.2 * o, 0.0, 0.0], np.float32)
        Rs.append(R), ts.append(t)
        Xc = X @ R.T + t
        uv = Xc[:, :2] / Xc[:, 2:3] * fx + np.asarray([w / 2, h / 2])
        vis = (Xc[:, 2] > 0.5) & (uv[:, 0] >= 0) & (uv[:, 0] < w) & \
              (uv[:, 1] >= 0) & (uv[:, 1] < h)
        idx = np.nonzero(vis)[0]
        rng.shuffle(idx)
        idx = idx[:n_feat]
        k = len(idx)
        xy = np.zeros((n_feat, 2), np.float32)
        dd = np.zeros((n_feat, 32), np.float32)
        mm = np.zeros((n_feat,), bool)
        xy[:k] = uv[idx] + 0.3 * rng.randn(k, 2)
        d = desc_gt[idx] + 0.05 * rng.randn(k, 32).astype(np.float32)
        dd[:k] = d / np.linalg.norm(d, axis=-1, keepdims=True)
        mm[:k] = True
        frames.append((jnp.asarray(xy), jnp.asarray(dd), jnp.asarray(mm)))
    poses_gt = Pose(R=jnp.asarray(np.stack(Rs)), t=jnp.asarray(np.stack(ts)))
    return frames, K, poses_gt


def test_detect_loop_candidates_finds_revisit():
    frames, K, _ = _revisit_sequence()
    desc = jnp.stack([f[1] for f in frames])
    mask = jnp.stack([f[2] for f in frames])
    cands = detect_loop_candidates(desc, mask, min_gap=5, min_score=30)
    assert cands, "no loop candidates found"
    # the strongest loop must connect two frames at (nearly) the same pose
    half = 6
    offsets = list(range(half)) + list(range(half - 2, -2, -1))[: 12 - half]
    top = cands[0]
    assert abs(offsets[top.i] - offsets[top.j]) <= 1, (top.i, top.j)


def test_verify_loop_geometric():
    frames, K, _ = _revisit_sequence()
    ok, rel, ninl = verify_loop(
        *frames[11], *frames[1], K, _sfm_config(), jax.random.PRNGKey(0),
    )
    assert ok and ninl > 50
    # frames 11 and 1 share (nearly) the same camera pose → tiny rotation
    ang = np.degrees(np.arccos(np.clip((np.trace(np.asarray(rel.R)) - 1) / 2, -1, 1)))
    assert ang < 5.0, f"relative rotation {ang} deg"


def test_close_loops_reduces_drift():
    frames, K, poses_gt = _revisit_sequence()
    C = poses_gt.t.shape[0]
    # simulate accumulated odometry drift: grow a bias along the chain
    key = jax.random.PRNGKey(3)
    drift = jnp.cumsum(
        0.02 * jax.random.normal(key, (C, 6)), axis=0
    ).at[0].set(0.0)
    Rd, td = se3_exp(drift)
    drifted = Pose(R=Rd @ poses_gt.R,
                   t=jnp.einsum("cij,cj->ci", Rd, poses_gt.t) + td)

    corrected, cands = close_loops(
        drifted, C, frames, K, _sfm_config(), min_gap=5, min_score=30,
    )
    assert any(c.verified for c in cands)

    def err(p):
        return float(jnp.mean(jnp.linalg.norm(p.t - poses_gt.t, axis=-1)))

    assert err(corrected) < err(drifted), (err(corrected), err(drifted))
