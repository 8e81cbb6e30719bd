"""Images → trajectory, end to end (VERDICT r1 item 2; SURVEY.md §4
"Integration tests").

The reference's entire observable behavior is image-in → geometry-out
(``Points Matching/main.cpp:14-98``); these tests close that loop at
sequence scale: a rendered synthetic sequence (``data/render.py``) goes
through the REAL frontend (``detect_keypoints → extract_descriptors``) —
no synthetic keypoints/descriptors anywhere — then incremental SfM,
loop closure, and distributed submap SLAM, with ATE asserted against the
renderer's ground-truth trajectory.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from points_matching.core.config import (
    DescriptorConfig,
    DetectorConfig,
    MatcherConfig,
    RansacConfig,
    SfMConfig,
    TwoViewConfig,
)
from points_matching.core.types import CameraIntrinsics
from points_matching.data.render import render_sequence
from points_matching.ops.descriptors import extract_descriptors
from points_matching.ops.detect import detect_keypoints
from points_matching.pipelines.sfm import camera_centers, run_incremental_sfm
from points_matching.utils.evaluation import absolute_trajectory_error

NUM_FRAMES = 16
TRAJ_EXTENT = 2.0  # renderer loop trajectory spans ~2 world units


@pytest.fixture(scope="module")
def rendered_pipeline():
    """Render an out-and-back sequence and run the real frontend on every
    frame; shared across the tests below (frontend is the slow part)."""
    imgs, gt_pos, _, (fx, fy, cx, cy) = render_sequence(
        num_frames=NUM_FRAMES, num_landmarks=300, image_size=(512, 384),
        seed=0, loop=True,
    )
    K = CameraIntrinsics(fx=jnp.float32(fx), fy=jnp.float32(fy),
                         cx=jnp.float32(cx), cy=jnp.float32(cy))
    dcfg = DetectorConfig(kind="hessian", threshold=100.0, max_keypoints=256)
    xcfg = DescriptorConfig(kind="surf")

    @jax.jit
    def frontend(im):
        kp = detect_keypoints(im, dcfg)
        d = extract_descriptors(im, kp, xcfg)
        return kp.xy, d.data, jnp.logical_and(kp.mask, d.mask)

    frames = [tuple(frontend(jnp.asarray(im))) for im in imgs]
    cfg = SfMConfig(
        two_view=TwoViewConfig(
            matcher=MatcherConfig(metric="l2", filter="ratio", ratio=0.8),
            ransac=RansacConfig(num_hypotheses=256, inlier_threshold=2.0),
        ),
        max_cameras=32, max_landmarks=2048, max_observations=8192,
    )
    return imgs, frames, K, cfg, gt_pos


def test_frontend_quality_on_rendered_frames(rendered_pipeline):
    """The detector/descriptor must produce dense, matchable features on
    every rendered frame — the precondition for everything below."""
    _, frames, _, _, _ = rendered_pipeline
    for xy, desc, mask in frames:
        assert int(jnp.sum(mask)) >= 128
    # frame 0 ↔ frame 1 matches must be displacement-coherent (camera
    # translates ~-4 px/frame at this depth)
    from points_matching.core.types import Descriptors
    from points_matching.ops.matching import match_descriptors

    (xy0, d0, m0), (xy1, d1, m1) = frames[0], frames[1]
    m = match_descriptors(
        Descriptors(data=d0, mask=m0), Descriptors(data=d1, mask=m1),
        MatcherConfig(filter="ratio", ratio=0.8),
    )
    assert int(jnp.sum(m.mask)) >= 60
    sel = np.asarray(m.mask)
    disp = (np.asarray(xy1)[np.asarray(m.train_idx)[sel]]
            - np.asarray(xy0)[np.asarray(m.query_idx)[sel]])
    med = np.median(disp, axis=0)
    mad = np.median(np.abs(disp - med), axis=0)
    assert med[0] < -2.0          # leftward image flow
    assert np.all(mad < 3.0)      # coherent (parallax spread only)


def test_incremental_sfm_from_images(rendered_pipeline):
    _, frames, K, cfg, gt_pos = rendered_pipeline
    res = run_incremental_sfm(frames, K, cfg, seed=0)
    assert sum(res.registered) >= NUM_FRAMES - 1, res.registered
    assert int(res.state.num_lms) > 100
    est = jnp.asarray(np.asarray(res.trajectory)[:NUM_FRAMES])
    ate = absolute_trajectory_error(est, jnp.asarray(gt_pos))
    # ≤10% of trajectory extent after Sim(3) alignment (observed ~0.13)
    assert float(ate.rmse) < 0.10 * TRAJ_EXTENT, float(ate.rmse)


def test_loop_closure_fires_from_images(rendered_pipeline):
    from points_matching.pipelines.loop_closure import close_loops

    _, frames, K, cfg, gt_pos = rendered_pipeline
    res = run_incremental_sfm(frames, K, cfg, seed=0)
    corrected, cands = close_loops(
        res.state.poses, int(res.state.num_cams), frames, K, cfg, seed=0,
    )
    assert len(cands) >= 1
    assert sum(c.verified for c in cands) >= 1  # the revisit is detected
    traj = np.asarray(camera_centers(corrected, res.state.cam_mask))
    ate = absolute_trajectory_error(
        jnp.asarray(traj[:NUM_FRAMES]), jnp.asarray(gt_pos)
    )
    assert float(ate.rmse) < 0.12 * TRAJ_EXTENT, float(ate.rmse)


def test_distributed_slam_from_images(rendered_pipeline):
    from points_matching.pipelines.distributed_slam import (
        run_distributed_slam,
    )

    _, frames, K, cfg, gt_pos = rendered_pipeline
    kxy = jnp.stack([f[0] for f in frames])
    dsc = jnp.stack([f[1] for f in frames])
    msk = jnp.stack([f[2] for f in frames])
    res = run_distributed_slam(
        kxy, dsc, msk, K, cfg, segment_len=12, overlap=5, seed=0,
    )
    assert res.cam_valid.sum() >= 0.8 * len(res.cam_valid)
    ate = absolute_trajectory_error(
        jnp.asarray(res.trajectory),
        jnp.asarray(gt_pos[: len(res.trajectory)]),
        jnp.asarray(res.cam_valid),
    )
    assert float(ate.rmse) < 0.15 * TRAJ_EXTENT, float(ate.rmse)
    assert res.ba_stats is not None
    assert float(res.ba_stats.final_cost) <= float(res.ba_stats.initial_cost)
