#!/usr/bin/env python
"""SfM per-frame cost decomposition at bench shapes.

Variants of bench.py's sfm section (marginal chunk slope, same synthetic
tracked sequence):
  full        - production register_frames_chunk (BA every 4 frames)
  no_ba       - ba_every > num_frames (isolates the BA share)
  pnp64       - pnp_hypotheses=64 instead of 1024 (isolates PnP-solve share)
  no_ba_pnp64 - both

Usage: python sfm_slices.py [variant ...]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def run_variant(name):
    import dataclasses

    import jax
    import jax.numpy as jnp

    import bench
    from points_matching.core.config import (
        MatcherConfig, RansacConfig, SfMConfig, TwoViewConfig,
    )
    from points_matching.core.types import CameraIntrinsics
    from points_matching.pipelines.sfm import (
        bootstrap_two_view, init_sfm_state, register_frames_chunk,
    )

    num_frames, chunk_size, n_feat, d_dim = 64, 16, 256, 32
    np_frames, fx, (w, h) = bench._make_sfm_sequence(num_frames, n_feat, d_dim)
    K = CameraIntrinsics(fx=jnp.float32(fx), fy=jnp.float32(fx),
                         cx=jnp.float32(w / 2), cy=jnp.float32(h / 2))
    frames = [(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
              for a, b, c, _ in np_frames]

    cfg = SfMConfig(
        two_view=TwoViewConfig(
            matcher=MatcherConfig(metric="l2", filter="ratio", ratio=0.8),
            ransac=RansacConfig(num_hypotheses=256, inlier_threshold=2.0),
        ),
        max_cameras=128, max_landmarks=4096, max_observations=32768,
        pnp_min_inliers=12,
    )
    ba_every = 4
    if "no_ba" in name:
        ba_every = 10 ** 6
    if "pnp64" in name:
        cfg = dataclasses.replace(cfg, pnp_hypotheses=64)

    key = jax.random.PRNGKey(0)
    key, k0 = jax.random.split(key)
    state0, _ = bootstrap_two_view(
        init_sfm_state(cfg, n_feat, d_dim),
        frames[0][0], frames[0][1], frames[0][2],
        frames[1][0], frames[1][1], frames[1][2], K, k0, cfg,
    )
    rest = frames[2:]
    xy = jnp.stack([f[0] for f in rest])
    dd = jnp.stack([f[1] for f in rest])
    mm = jnp.stack([f[2] for f in rest])

    def run_chunks(k):
        st = state0
        reg = None
        kk = jax.random.PRNGKey(1)
        for i in range(k):
            c0 = (i * chunk_size) % (len(rest) - chunk_size + 1)
            idx = jnp.arange(c0 + 2, c0 + 2 + chunk_size, dtype=jnp.int32)
            kk, kc = jax.random.split(kk)
            st, sts = register_frames_chunk(
                st, xy[c0:c0 + chunk_size], dd[c0:c0 + chunk_size],
                mm[c0:c0 + chunk_size], idx, K, kc, cfg, ba_every,
                cfg.local_ba_window,
            )
            reg = sts.num_pnp_inliers
        return float(jnp.sum(reg))

    t0 = time.time(); run_chunks(1); compile_s = time.time() - t0
    best_s = 1e9
    for _ in range(3):
        t0 = time.time(); run_chunks(1); best_s = min(best_s, time.time() - t0)
    t0 = time.time(); run_chunks(2)
    per = max(time.time() - t0 - best_s, 1e-3)
    k = 1 + max(2, int(4.0 / per))
    best_l = 1e9
    for _ in range(2):
        t0 = time.time(); run_chunks(k); best_l = min(best_l, time.time() - t0)
    gap = best_l - best_s
    fps = (k - 1) * chunk_size / gap
    print(json.dumps(dict(variant=name, frames_per_sec=round(fps, 1),
                          ms_per_frame=round(1e3 / fps, 1),
                          gap_s=round(gap, 2),
                          compile_s=round(compile_s, 1))), flush=True)


def main():
    for name in (sys.argv[1:] or ["full", "no_ba", "pnp64", "no_ba_pnp64"]):
        run_variant(name)


if __name__ == "__main__":
    main()
