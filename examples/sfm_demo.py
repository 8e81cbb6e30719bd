#!/usr/bin/env python
"""Incremental SfM demo (BASELINE config 3 shape): runs the full
register→triangulate→local-BA loop on a synthetic trajectory (or a directory
of images once frame IO lands) and reports ATE vs ground truth.

Usage:
  python examples/sfm_demo.py [--frames N] [--landmarks L] [--platform cpu|gpu]
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import argparse
import sys


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--landmarks", type=int, default=400)
    p.add_argument("--features", type=int, default=256)
    p.add_argument("--noise", type=float, default=0.3, help="pixel noise sigma")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--loop-closure", action="store_true",
                   help="out-and-back trajectory + detect/verify/close loops")
    args = p.parse_args()

    from points_matching.utils.platform import use_platform

    use_platform(args.platform)

    import numpy as np
    import jax.numpy as jnp

    from points_matching.core.config import (
        MatcherConfig, RansacConfig, SfMConfig, TwoViewConfig,
    )
    from points_matching.core.types import CameraIntrinsics
    from points_matching.data.synthetic import make_tracked_sequence
    from points_matching.pipelines.sfm import run_incremental_sfm
    from points_matching.utils.evaluation import absolute_trajectory_error

    frames_np, gt, (fx, fy, cx, cy) = make_tracked_sequence(
        args.frames, args.landmarks, args.features, args.noise, args.seed,
        loop=args.loop_closure)
    gt_centers = list(gt)
    K = CameraIntrinsics(fx=jnp.float32(fx), fy=jnp.float32(fy),
                         cx=jnp.float32(cx), cy=jnp.float32(cy))
    frames = [tuple(jnp.asarray(a) for a in f) for f in frames_np]

    cfg = SfMConfig(
        two_view=TwoViewConfig(
            matcher=MatcherConfig(metric="l2", filter="ratio", ratio=0.8),
            ransac=RansacConfig(num_hypotheses=256, inlier_threshold=2.0),
        ),
        max_cameras=max(32, args.frames + 2),
        max_landmarks=4 * args.landmarks,
        max_observations=16 * args.landmarks,
    )

    import time
    t0 = time.time()
    res = run_incremental_sfm(frames, K, cfg, seed=args.seed)
    dt = time.time() - t0

    st = res.state
    n_reg = sum(res.registered)
    print(f"frames registered: {n_reg}/{args.frames}")
    print(f"landmarks: {int(st.num_lms)}  observations: {int(st.num_obs)}")
    print(f"wall time: {dt:.2f}s ({args.frames/dt:.2f} frames/s incl. compile)")

    est = np.asarray(res.trajectory)[: args.frames]
    ate = absolute_trajectory_error(jnp.asarray(est), jnp.asarray(np.stack(gt_centers)))
    print(f"ATE rmse: {float(ate.rmse):.4f}  mean: {float(ate.mean):.4f}  "
          f"(scale {float(ate.scale):.3f})")

    if args.loop_closure:
        from points_matching.pipelines.loop_closure import close_loops
        from points_matching.pipelines.sfm import (
            camera_centers,
            local_bundle_adjust,
        )

        corrected, cands = close_loops(
            res.state.poses, int(res.state.num_cams), frames, K, cfg,
            seed=args.seed,
        )
        n_ver = sum(c.verified for c in cands)
        print(f"loop candidates: {len(cands)}  verified: {n_ver}")
        traj2 = np.asarray(camera_centers(corrected, res.state.cam_mask))[: args.frames]
        ate2 = absolute_trajectory_error(
            jnp.asarray(traj2), jnp.asarray(np.stack(gt_centers))
        )
        print(f"ATE after loop closure: {float(ate2.rmse):.4f}")

        # standard SLAM backend order: pose-graph closure, then a global BA
        # re-polish (the pose graph alone discards landmark information)
        st2, _ = local_bundle_adjust(
            res.state.replace(poses=corrected), K, cfg,
            window=int(res.state.num_cams),
        )
        traj3 = np.asarray(camera_centers(st2.poses, st2.cam_mask))[: args.frames]
        ate3 = absolute_trajectory_error(
            jnp.asarray(traj3), jnp.asarray(np.stack(gt_centers))
        )
        print(f"ATE after closure + global BA: {float(ate3.rmse):.4f}")
    return 0 if n_reg == args.frames else 1


if __name__ == "__main__":
    sys.exit(main())
