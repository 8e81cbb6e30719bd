#!/usr/bin/env python
"""Sequence SLAM/SfM runner on real data (BASELINE configs 3-4 entry
point): TUM RGB-D or KITTI odometry directory → native batch decode →
device-resident detection/description → incremental SfM (+ optional loop
closure) → ATE vs ground truth.

Usage:
  python examples/slam_demo.py --tum  /path/to/rgbd_dataset_freiburg1_xyz [--frames 100]
  python examples/slam_demo.py --kitti /path/to/kitti_odometry --seq 00 [--frames 200]
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import argparse
import sys
import time


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--tum", help="TUM RGB-D sequence directory")
    g.add_argument("--kitti", help="KITTI odometry root directory")
    p.add_argument("--seq", default="00", help="KITTI sequence id")
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--features", type=int, default=512)
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    p.add_argument("--loop-closure", action="store_true")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save the final map state here (Orbax)")
    p.add_argument("--ba-every", type=int, default=4)
    p.add_argument("--distributed", action="store_true",
                   help="submap-parallel SLAM over all local devices "
                        "(segment axis sharded on the mesh's data axis)")
    p.add_argument("--segment-len", type=int, default=16)
    p.add_argument("--overlap", type=int, default=4)
    args = p.parse_args()

    from points_matching.utils.platform import use_platform

    use_platform(args.platform)
    import jax

    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from points_matching.core.config import (
        DetectorConfig, MatcherConfig, RansacConfig, SfMConfig, TwoViewConfig,
    )
    from points_matching.data.datasets import load_kitti_sequence, load_tum_sequence
    from points_matching.data.images import load_batch
    from points_matching.ops.descriptors import extract_descriptors
    from points_matching.ops.detect import detect_keypoints
    from points_matching.pipelines.sfm import run_incremental_sfm
    from points_matching.utils.evaluation import absolute_trajectory_error
    from points_matching.utils.logging import get_logger

    log = get_logger("slam")

    if args.tum:
        seq = load_tum_sequence(args.tum, max_frames=args.frames)
    else:
        seq = load_kitti_sequence(args.kitti, args.seq, max_frames=args.frames)
    log.info("sequence: %d frames", len(seq))

    t0 = time.time()
    images = load_batch(seq.image_paths)
    log.info("decoded %d frames in %.2fs (%s)", len(seq), time.time() - t0,
             "native" if images.flags.c_contiguous else "pil")

    cfg = SfMConfig(
        two_view=TwoViewConfig(
            detector=DetectorConfig(kind="hessian", threshold=400.0,
                                    max_keypoints=args.features),
            matcher=MatcherConfig(metric="l2", filter="ratio", ratio=0.85),
            ransac=RansacConfig(num_hypotheses=256, inlier_threshold=2.0),
        ),
        max_cameras=max(16, args.frames + 2),
        max_landmarks=64 * args.features,
        max_observations=256 * args.features,
    )

    # per-frame features: jitted detect + describe, map kept on device
    det = jax.jit(detect_keypoints, static_argnums=1)
    desc = jax.jit(extract_descriptors, static_argnums=2)

    frames = []
    t0 = time.time()
    for i in range(len(seq)):
        img = jnp.asarray(images[i])
        kps = det(img, cfg.two_view.detector)
        d = desc(img, kps, cfg.two_view.descriptor)
        frames.append((kps.xy, d.data, d.mask))
    jax.block_until_ready(frames[-1])
    dt = time.time() - t0
    log.info("features: %.2fs (%.1f frames/s incl. compile)", dt, len(seq) / dt)

    if args.distributed:
        return _run_distributed(args, frames, seq, cfg, log)

    t0 = time.time()
    res = run_incremental_sfm(frames, seq.K, cfg, ba_every=args.ba_every)
    dt = time.time() - t0
    n_reg = sum(res.registered)
    log.info("registered %d/%d frames in %.2fs (%.2f frames/s)",
             n_reg, len(seq), dt, len(seq) / dt)
    log.info("landmarks: %d  observations: %d",
             int(res.state.num_lms), int(res.state.num_obs))

    traj = np.asarray(res.trajectory)[: len(seq)]
    if args.loop_closure:
        from points_matching.pipelines.loop_closure import close_loops
        from points_matching.pipelines.sfm import camera_centers

        corrected, cands = close_loops(
            res.state.poses, int(res.state.num_cams), frames, seq.K, cfg
        )
        log.info("loops: %d candidates, %d verified", len(cands),
                 sum(c.verified for c in cands))
        traj = np.asarray(camera_centers(corrected, res.state.cam_mask))[: len(seq)]

    # camera slots are compact over REGISTERED frames: slot k ↔ the k-th
    # frame with registered=True; align ground truth accordingly
    reg_idx = [i for i, r in enumerate(res.registered) if r]
    est = traj[: len(reg_idx)]
    gt = seq.gt_positions[reg_idx]
    gt_ok = np.isfinite(gt).all(axis=-1)
    if gt_ok.sum() >= 3:
        ate = absolute_trajectory_error(
            jnp.asarray(est), jnp.asarray(np.nan_to_num(gt)),
            mask=jnp.asarray(gt_ok),
        )
        log.info("ATE rmse: %.4f m  mean: %.4f m (Sim3-aligned, %d poses)",
                 float(ate.rmse), float(ate.mean), int(gt_ok.sum()))
    else:
        log.info("no ground truth — skipping ATE")

    if args.checkpoint_dir:
        from points_matching.utils.checkpoint import CheckpointManager

        with CheckpointManager(args.checkpoint_dir) as mgr:
            mgr.save(len(seq), res.state)
        log.info("checkpointed map state to %s", args.checkpoint_dir)

    return 0 if n_reg == len(seq) else 1


def _run_distributed(args, frames, seq, cfg, log):
    """Submap-parallel path: segments sharded over the data axis of a mesh
    spanning all local devices, Sim(3) merge, landmark-sharded global BA."""
    import dataclasses
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from points_matching.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
    from points_matching.pipelines.distributed_slam import (
        run_distributed_slam, segment_frames,
    )
    from points_matching.utils.evaluation import absolute_trajectory_error

    kps = jnp.stack([f[0] for f in frames])
    dsc = jnp.stack([f[1] for f in frames])
    msk = jnp.stack([f[2] for f in frames])

    n_dev = len(jax.devices())
    stride = args.segment_len - args.overlap
    n_seg = (len(frames) - args.overlap) // stride
    # data axis must divide the segment count; give leftover devices to model
    n_data = 1
    for d in range(min(n_dev, n_seg), 0, -1):
        if n_seg % d == 0 and n_dev % d == 0:
            n_data = d
            break
    mesh = make_mesh((n_data, n_dev // n_data), (DATA_AXIS, MODEL_AXIS))
    log.info("mesh: %s over %d devices, %d segments (len %d, overlap %d)",
             dict(mesh.shape), n_dev, n_seg, args.segment_len, args.overlap)

    cfg = dataclasses.replace(
        cfg, max_cameras=args.segment_len,
        local_ba_window=min(cfg.local_ba_window, args.segment_len),
        max_landmarks=-(-8 * args.features // mesh.shape[MODEL_AXIS])
        * mesh.shape[MODEL_AXIS],
        max_observations=32 * args.features,
    )

    t0 = time.time()
    res = run_distributed_slam(
        kps, dsc, msk, seq.K, config=cfg, mesh=mesh,
        segment_len=args.segment_len, overlap=args.overlap,
    )
    dt = time.time() - t0
    n_frames = len(res.cam_valid)
    log.info("distributed SLAM: %d frames in %.2fs (%.2f frames/s incl. "
             "compile), %d/%d frames valid",
             n_frames, dt, n_frames / dt, int(res.cam_valid.sum()), n_frames)
    if res.ba_stats is not None:
        log.info("global BA cost: %.1f -> %.1f",
                 float(res.ba_stats.initial_cost), float(res.ba_stats.final_cost))

    gt = seq.gt_positions[:n_frames]
    gt_ok = np.isfinite(gt).all(axis=-1) & res.cam_valid
    if gt_ok.sum() >= 3:
        ate = absolute_trajectory_error(
            jnp.asarray(res.trajectory), jnp.asarray(np.nan_to_num(gt)),
            mask=jnp.asarray(gt_ok),
        )
        log.info("ATE rmse: %.4f m  mean: %.4f m (Sim3-aligned, %d poses)",
                 float(ate.rmse), float(ate.mean), int(gt_ok.sum()))
    return 0 if res.cam_valid.all() else 1


if __name__ == "__main__":
    sys.exit(main())
