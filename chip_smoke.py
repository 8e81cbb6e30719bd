#!/usr/bin/env python
"""On-device smoke test: drive the engine's main paths once on one GPU and
check each against the plain float32 reference on the host CPU.

Usage:
  python chip_smoke.py                # phases 0-5 on one GPU
  python chip_smoke.py --four-cards   # phase 6 only, on a 4-GPU host

Phases (each prints one JSON line with its numbers and the card):
  0. device      — JAX must see a GPU; no fallback to the CPU.
  1. image_to_f  — two rendered 993×660 frames through
                   ``pipelines.two_view.two_view_pipeline`` (the two-view
                   demo's ``--config ransac``).
  2. two_view    — 64 pairs × 512 keypoints × 64-d, 30 % outliers, through
                   ``match_descriptors_points`` + ``ransac_fundamental``
                   under vmap, matcher in f32 and in bf16.
  3. sfm         — a 32-frame tracked loop sequence through
                   ``run_incremental_sfm`` + ``close_loops``.
  4. sparse_ba   — 64 cameras × 16,384 landmarks × 131,072 observations
                   through ``bundle_adjust_sparse``, both reduction layouts.
  5. kernels     — each Pallas kernel compiled for the card against the
                   plain XLA path at the phase-2 widths, alone and end to
                   end.
  6. four_cards  — distributed sparse BA and the ring all-pairs scorer on
                   a 4-GPU mesh against the same problem on one GPU.

Every comparison runs the same function in this process on
``jax.devices("cpu")[0]`` (the reference) and on the GPU.  Any failed
check raises, so the script exits nonzero; the last stdout line is
``{"ok": true, "device": {...}}`` only when every phase passed.  The
full log also goes to ``chiprun_out/chip_smoke.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

OUT_PATH = os.path.join("chiprun_out", "chip_smoke.jsonl")


class SmokeFailure(AssertionError):
    """A phase's result is outside its stated tolerance."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------- helpers


def card_info() -> str:
    """``nvidia-smi`` name and power limit of the visible cards."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(l.strip() for l in out.stdout.splitlines() if l.strip())


def run_on(dev, fn, *args):
    """Run ``fn(*args)`` with its inputs committed to ``dev``; blocks."""
    import jax

    args = jax.device_put(args, dev)
    with jax.default_device(dev):
        return jax.block_until_ready(fn(*args))


def timed(thunk, reps: int = 10) -> dict:
    """Median / min / max wall seconds of ``thunk()`` after one warm-up
    call, each call ended by ``block_until_ready``."""
    import jax

    jax.block_until_ready(thunk())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(thunk())
        ts.append(time.perf_counter() - t0)
    return dict(median_s=statistics.median(ts), min_s=min(ts), max_s=max(ts),
                reps=reps)


def time_on(dev, fn, *args, reps: int = 10) -> dict:
    """``timed`` of ``fn(*args)`` with its inputs committed to ``dev``."""
    import jax

    args = jax.device_put(args, dev)
    with jax.default_device(dev):
        return timed(lambda: fn(*args), reps)


def sampson_np(F, p1, p2) -> np.ndarray:
    """Squared Sampson distance in float64 NumPy (an independent check of
    the device's geometry)."""
    F = np.asarray(F, np.float64)
    x1 = np.concatenate([np.asarray(p1, np.float64),
                         np.ones((len(p1), 1))], axis=1)
    x2 = np.concatenate([np.asarray(p2, np.float64),
                         np.ones((len(p2), 1))], axis=1)
    Fx1 = x1 @ F.T
    Ftx2 = x2 @ F
    num = np.sum(x2 * Fx1, axis=1) ** 2
    den = Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2
    return num / np.maximum(den, 1e-30)


# ----------------------------------------------------------------- phases


def phase_image_to_f(dev, ref_dev, image_size=(993, 660), keypoints=512,
                     reps=5) -> dict:
    """Phase 1: rendered image pair → F through the two-view pipeline."""
    import jax

    from points_matching.core.config import ratio_ransac_config
    from points_matching.data.render import render_sequence
    from points_matching.pipelines.two_view import two_view_pipeline

    images, _, _, _ = render_sequence(num_frames=2, num_landmarks=400,
                                      image_size=image_size, seed=0)
    cfg = ratio_ransac_config(keypoints)
    key = jax.random.PRNGKey(0)

    def fn(a, b, k):
        return two_view_pipeline(a, b, k, cfg)

    def summary(res):
        inl = np.asarray(res.estimate.inlier_mask)
        F = np.asarray(res.estimate.F)
        p1, p2 = np.asarray(res.p1)[inl], np.asarray(res.p2)[inl]
        return dict(
            keypoints=[int(np.asarray(res.kps1.mask).sum()),
                       int(np.asarray(res.kps2.mask).sum())],
            good_matches=int(np.asarray(res.matches.mask).sum()),
            inliers=int(res.estimate.num_inliers),
            mean_sampson_px2=float(np.mean(sampson_np(F, p1, p2)))
            if len(p1) else float("nan"),
            F_finite=bool(np.all(np.isfinite(F))),
            F_rank2_sv3=float(np.linalg.svd(F, compute_uv=False)[2]),
        )

    def cross_sampson(res, other):
        """Mean Sampson² of ``res``'s inliers under ``other``'s F."""
        inl = np.asarray(res.estimate.inlier_mask)
        return float(np.mean(sampson_np(np.asarray(other.estimate.F),
                                        np.asarray(res.p1)[inl],
                                        np.asarray(res.p2)[inl])))

    res_gpu = run_on(dev, fn, images[0], images[1], key)
    res_ref = run_on(ref_dev, fn, images[0], images[1], key)
    gpu, ref = summary(res_gpu), summary(res_ref)
    gpu["inliers_sampson_px2_under_other_F"] = cross_sampson(res_gpu, res_ref)
    ref["inliers_sampson_px2_under_other_F"] = cross_sampson(res_ref, res_gpu)
    t = time_on(dev, fn, images[0], images[1], key, reps=reps)

    # Tolerances.  The detector sums separable convolutions in another
    # order on the GPU, so near-threshold and near-tie responses may flip:
    # keypoint counts within 2 % of capacity.  Matches and RANSAC inherit
    # those flips, and one changed correspondence reshuffles the random
    # minimal samples, so the consensus may land on a slightly different
    # inlier set: good matches and inliers within 10 %.  Both F must fit
    # their own inliers well under the 1.5 px gate (Sampson² ≤ 1 px²), and
    # each F must fit the other run's inliers within the gate on average
    # (Sampson² ≤ 2.25 px²): the two estimates describe the same geometry.
    check(gpu["F_finite"], "GPU F is not finite")
    for i in range(2):
        check(abs(gpu["keypoints"][i] - ref["keypoints"][i])
              <= 0.02 * keypoints,
              f"keypoints {gpu['keypoints']} vs CPU {ref['keypoints']}")
    check(abs(gpu["good_matches"] - ref["good_matches"])
          <= 0.10 * max(ref["good_matches"], 1),
          f"good matches {gpu['good_matches']} vs CPU {ref['good_matches']}")
    check(ref["inliers"] >= 8, f"CPU reference found {ref['inliers']} inliers")
    check(abs(gpu["inliers"] - ref["inliers"]) <= 0.10 * ref["inliers"],
          f"inliers {gpu['inliers']} vs CPU {ref['inliers']}")
    check(gpu["mean_sampson_px2"] <= 1.0 and ref["mean_sampson_px2"] <= 1.0,
          f"mean Sampson² {gpu['mean_sampson_px2']} / "
          f"{ref['mean_sampson_px2']} px² above 1")
    cross = (gpu["inliers_sampson_px2_under_other_F"],
             ref["inliers_sampson_px2_under_other_F"])
    check(max(cross) <= 2.25, f"cross Sampson² {cross} px² above the gate")
    return dict(image_size=list(image_size), keypoint_capacity=keypoints,
                gpu=gpu, cpu=ref, pair_time=t)


def _two_view_step(mcfg, rcfg, nkp):
    """vmapped per-pair match + RANSAC; returns (inliers [B], matches)."""
    import jax
    import jax.numpy as jnp

    from points_matching.core.types import Descriptors
    from points_matching.geometry.ransac import ransac_fundamental
    from points_matching.ops.matching import match_descriptors_points

    def per_pair(a, b, pa, pb, k):
        m = jnp.ones((nkp,), bool)
        matches, q2 = match_descriptors_points(
            Descriptors(data=a, mask=m), Descriptors(data=b, mask=m), pb,
            mcfg)
        est = ransac_fundamental(k, pa, q2, matches.mask, rcfg)
        return est.num_inliers, matches.mask, matches.train_idx

    return jax.jit(jax.vmap(per_pair))


def two_view_inputs(pairs, nkp, dim, seed=0):
    import jax

    from points_matching.data.synthetic import make_matched_pairs

    d1, d2, p1, p2 = make_matched_pairs(pairs, nkp, dim, 0.3, seed)
    keys = jax.random.split(jax.random.PRNGKey(seed), pairs)
    return d1, d2, p1, p2, keys


def _match_agreement(a, b) -> float:
    """Share of query rows with the same (kept, train index) decision."""
    ma, ia = np.asarray(a[1]), np.asarray(a[2])
    mb, ib = np.asarray(b[1]), np.asarray(b[2])
    same = (ma == mb) & (~ma | (ia == ib))
    return float(same.mean())


def phase_two_view(dev, ref_dev, pairs=64, nkp=512, dim=64,
                   hypotheses=512, reps=10) -> dict:
    """Phase 2: batched match + RANSAC on descriptors."""
    from points_matching.core.config import MatcherConfig, RansacConfig

    inputs = two_view_inputs(pairs, nkp, dim)
    rcfg = RansacConfig(num_hypotheses=hypotheses, refit_iterations=2)
    out = dict(pairs=pairs, keypoints=nkp, dim=dim, hypotheses=hypotheses)
    ref = None
    for dtype in ("f32", "bf16"):
        mcfg = MatcherConfig(metric="l2", filter="ratio", ratio=0.85,
                             compute_dtype=dtype, compact=False)
        step = _two_view_step(mcfg, rcfg, nkp)
        if ref is None:
            # the reference is the f32 matcher on the CPU
            ref = run_on(ref_dev, step, *inputs)
        got = run_on(dev, step, *inputs)
        agree = _match_agreement(got, ref)
        inl_gpu = float(np.mean(np.asarray(got[0])))
        inl_ref = float(np.mean(np.asarray(ref[0])))
        t = time_on(dev, step, *inputs, reps=reps)
        # f32 on the GPU is full f32 (HIGHEST / IEEE), so only near-exact
        # distance ties may flip: ≥ 99.5 % of rows agree.  bf16 operands
        # keep ~3 significant digits, which moves rows whose best and
        # second-best distances are within ~1e-2 of each other across the
        # 0.85 ratio gate: ≥ 97 % agree.  Mean inliers per pair within 2 %
        # (different matches and float order reshuffle the samples).
        min_agree = 0.995 if dtype == "f32" else 0.97
        check(agree >= min_agree,
              f"{dtype} match agreement {agree:.4f} < {min_agree}")
        check(abs(inl_gpu - inl_ref) <= 0.02 * inl_ref,
              f"{dtype} mean inliers {inl_gpu} vs CPU {inl_ref}")
        out[dtype] = dict(match_agreement=agree, mean_inliers=inl_gpu,
                          mean_inliers_cpu=inl_ref, step_time=t,
                          pairs_per_s=pairs / t["median_s"])
    return out


def phase_sfm(dev, ref_dev, frames=32, features=256, landmarks=400) -> dict:
    """Phase 3: incremental SfM + loop closure on a tracked sequence."""
    import jax
    import jax.numpy as jnp

    from points_matching.core.config import (
        MatcherConfig, RansacConfig, SfMConfig, TwoViewConfig,
    )
    from points_matching.core.types import CameraIntrinsics
    from points_matching.data.synthetic import make_tracked_sequence
    from points_matching.pipelines.loop_closure import close_loops
    from points_matching.pipelines.sfm import (
        camera_centers, run_incremental_sfm,
    )
    from points_matching.utils.evaluation import absolute_trajectory_error

    frames_np, gt, (fx, fy, cx, cy) = make_tracked_sequence(
        frames, landmarks, features, noise=0.3, seed=0, loop=True)
    cfg = SfMConfig(
        two_view=TwoViewConfig(
            matcher=MatcherConfig(metric="l2", filter="ratio", ratio=0.8),
            ransac=RansacConfig(num_hypotheses=256, inlier_threshold=2.0),
        ),
        max_cameras=max(32, frames + 2),
        max_landmarks=4 * landmarks,
        max_observations=16 * landmarks,
    )

    def run(d):
        with jax.default_device(d):
            K = CameraIntrinsics(fx=jnp.float32(fx), fy=jnp.float32(fy),
                                 cx=jnp.float32(cx), cy=jnp.float32(cy))
            fr = [tuple(jax.device_put(a, d) for a in f) for f in frames_np]
            t0 = time.perf_counter()
            res = run_incremental_sfm(fr, K, cfg, seed=0)
            corrected, cands = close_loops(
                res.state.poses, int(res.state.num_cams), fr, K, cfg, seed=0)
            jax.block_until_ready(corrected)
            wall = time.perf_counter() - t0
            gt_j = jnp.asarray(gt)
            ate = absolute_trajectory_error(
                jnp.asarray(np.asarray(res.trajectory)[:frames]), gt_j)
            traj2 = np.asarray(camera_centers(corrected, res.state.cam_mask))
            ate2 = absolute_trajectory_error(jnp.asarray(traj2[:frames]),
                                             gt_j)
            return dict(registered=int(sum(res.registered)),
                        ate_rmse=float(ate.rmse),
                        ate_rmse_after_closure=float(ate2.rmse),
                        loops_verified=int(sum(c.verified for c in cands)),
                        wall_s_incl_compile=wall)

    gpu = run(dev)
    ref = run(ref_dev)
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    # Every frame must register on both.  ATE: the trajectory is
    # estimated up to similarity from 0.3 px noise, so both runs sit at a
    # noise floor of a few hundredths of the path; float-order differences
    # change RANSAC samples and hence which noisy solution each run lands
    # on.  Bound: GPU ATE ≤ 2 × CPU ATE + 1 % of the path length.
    bound = 2.0 * ref["ate_rmse"] + 0.01 * path
    check(gpu["registered"] == frames and ref["registered"] == frames,
          f"registered {gpu['registered']} (GPU) / {ref['registered']} (CPU)"
          f" of {frames}")
    check(gpu["ate_rmse"] <= bound,
          f"ATE {gpu['ate_rmse']} above bound {bound}")
    return dict(frames=frames, features=features, landmarks=landmarks,
                path_length=path, ate_bound=bound, gpu=gpu, cpu=ref)


def sparse_ba_inputs(cameras, landmarks, obs_per_landmark, seed=1):
    from points_matching.ba.sparse import make_sparse_ba_state
    from points_matching.core.types import CameraIntrinsics
    from points_matching.data.synthetic import make_sparse_ba_problem

    prob = make_sparse_ba_problem(seed=seed, num_cameras=cameras,
                                  num_landmarks=landmarks,
                                  obs_per_landmark=obs_per_landmark)
    K = CameraIntrinsics.from_matrix(prob["K"])
    state = make_sparse_ba_state(prob["poses"], prob["X"], prob["cam_idx"],
                                 prob["lm_idx"], prob["uv"], prob["obs_mask"])
    return state, K


def phase_sparse_ba(dev, ref_dev, cameras=64, landmarks=16384,
                    obs_per_landmark=8, iterations=3, timed_iterations=5,
                    reps=3) -> dict:
    """Phase 4: sparse LM bundle adjustment at the working size."""
    import jax

    from points_matching.ba.sparse import bundle_adjust_sparse
    from points_matching.core.config import BAConfig

    state, K = sparse_ba_inputs(cameras, landmarks, obs_per_landmark)
    out = dict(cameras=cameras, landmarks=landmarks,
               observations=int(state.num_observations))

    def chain(d, layout):
        """``iterations`` one-iteration LM calls, chained: comparable
        iteration for iteration across devices."""
        cfg = BAConfig(max_iterations=1, rtol=0.0, pcg_iterations=25,
                       obs_layout=layout)
        step = jax.jit(lambda s, k: bundle_adjust_sparse(s, k, cfg))
        s, k = jax.device_put((state, K), d)
        costs = []
        with jax.default_device(d):
            for _ in range(iterations):
                s, st = step(s, k)
                costs.append(float(st.final_cost))
        return costs

    ref_costs = chain(ref_dev, "scatter")
    for layout in ("scatter", "sorted"):
        costs = chain(dev, layout)
        cfg = BAConfig(max_iterations=timed_iterations, rtol=0.0,
                       pcg_iterations=25, obs_layout=layout)
        solve = jax.jit(lambda s, k: bundle_adjust_sparse(s, k, cfg))
        t = time_on(dev, solve, state, K, reps=reps)
        init_cost = float(run_on(dev, solve, state, K)[1].initial_cost)
        rel = [abs(a - b) / b for a, b in zip(costs, ref_costs)]
        # One LM step solves the normal equations by 25 PCG iterations in
        # f32; segment sums in another order (atomics on the GPU) change
        # the step in the last digits, and the cost at the noise floor is
        # a sum of 131k squared residuals: per-iteration costs agree with
        # the CPU to 1 %.  LM is monotone: the cost must not rise.
        check(max(rel) <= 1e-2,
              f"{layout}: per-iteration cost vs CPU rel {rel}")
        check(all(b <= a for a, b in zip([init_cost] + costs, costs))
              and costs[-1] < init_cost,
              f"{layout}: costs {init_cost} → {costs} not decreasing")
        out[layout] = dict(
            initial_cost=init_cost, costs=costs, cpu_costs=ref_costs,
            cost_drop=init_cost / costs[-1],
            rel_diff_vs_cpu=rel,
            time_per_iteration_s=t["median_s"] / timed_iterations,
            solve_time=t)
    return out


def phase_kernels(dev, pairs=64, nkp=512, dim=64, hypotheses=512,
                  reps=20, ab_rounds=10, loop_steps=16,
                  interpret=False) -> dict:
    """Phase 5: each Pallas kernel, compiled for the card, against the
    plain XLA path on the same card — alone and end to end.
    ``interpret=True`` runs the kernels through the Pallas interpreter
    instead (for tests on a host without a GPU)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from points_matching.core.config import MatcherConfig, RansacConfig
    from points_matching.core.types import Descriptors
    from points_matching.data.synthetic import make_two_view_scene
    from points_matching.geometry.fundamental import eight_point
    from points_matching.ops.matching import knn_match
    from points_matching.ops.pallas.eightpoint_kernel import (
        minimal_eight_point,
    )
    from points_matching.ops.pallas.matching_kernel import fused_l2_top2

    inputs = two_view_inputs(pairs, nkp, dim)
    d1, d2 = inputs[0], inputs[1]
    mask = np.ones((pairs, nkp), bool)
    out = {}

    # -- fused L2 top-2 vs XLA knn_match (k=2), both on the card
    for dtype in ("f32", "bf16"):
        kern = jax.jit(jax.vmap(lambda q, t, m: fused_l2_top2(
            q, t, m, compute_dtype=dtype, interpret=interpret)))
        xla = jax.jit(jax.vmap(lambda q, t, m: knn_match(
            Descriptors(q, jnp.ones(q.shape[:1], bool)), Descriptors(t, m),
            k=2, compute_dtype=dtype)))
        kd, ki = run_on(dev, kern, d1, d2, mask)
        xd, xi = run_on(dev, xla, d1, d2, mask)
        idx_agree = float(np.mean(np.asarray(ki[..., 0])
                                  == np.asarray(xi[..., 0])))
        dist_err = float(np.max(np.abs(np.asarray(kd) - np.asarray(xd))))
        # f32: both sides are full-f32 products summed in different orders
        # (|error| ~1e-6 on unit vectors): 1-NN agrees on ≥ 99.9 % of rows,
        # distances to 1e-4.  bf16: both round the operands the same way but
        # accumulate in different orders: ≥ 99 % of rows, distances to 2e-2.
        tol_agree, tol_dist = (0.999, 1e-4) if dtype == "f32" else (0.99, 2e-2)
        check(idx_agree >= tol_agree,
              f"fused_l2_top2 {dtype}: 1-NN agreement {idx_agree}")
        check(dist_err <= tol_dist,
              f"fused_l2_top2 {dtype}: max |dist err| {dist_err}")
        out[f"fused_l2_top2_{dtype}"] = dict(
            nn_agreement=idx_agree, max_abs_dist_err=dist_err,
            kernel=time_on(dev, kern, d1, d2, mask, reps=reps),
            xla=time_on(dev, xla, d1, d2, mask, reps=reps))

    # -- minimal 8-point vs the XLA chain, on noise-free minimal samples
    scene = make_two_view_scene(jax.random.PRNGKey(3), num_points=256,
                                noise=0.0)
    rng = np.random.RandomState(0)
    idx = np.stack([rng.choice(256, 8, replace=False)
                    for _ in range(pairs * hypotheses)])
    sp1 = np.asarray(scene.p1)[idx].reshape(pairs, hypotheses, 8, 2)
    sp2 = np.asarray(scene.p2)[idx].reshape(pairs, hypotheses, 8, 2)
    kern = jax.jit(lambda a, b: minimal_eight_point(a, b,
                                                    interpret=interpret))
    xla = jax.jit(jax.vmap(eight_point))
    Fk = np.asarray(run_on(dev, kern, sp1, sp2))
    Fx = np.asarray(run_on(dev, xla, sp1, sp2))
    err = np.max(np.abs(Fk - Fx), axis=(-2, -1)).ravel()
    # Same algorithm and constants; on noise-free samples both converge
    # hard, so unit-norm entries agree to f32 rounding (median ≤ 2e-4);
    # near-collinear draws are ill-conditioned: ≥ 90 % within 1e-2.
    check(bool(np.all(np.isfinite(Fk))), "minimal_eight_point: non-finite F")
    check(float(np.median(err)) <= 2e-4,
          f"minimal_eight_point: median err {np.median(err)}")
    check(float(np.mean(err < 1e-2)) >= 0.9,
          f"minimal_eight_point: {np.mean(err < 1e-2)} within 1e-2")
    out["minimal_eight_point"] = dict(
        median_abs_err=float(np.median(err)),
        share_within_1e_2=float(np.mean(err < 1e-2)),
        kernel=time_on(dev, kern, sp1, sp2, reps=reps),
        xla=time_on(dev, xla, sp1, sp2, reps=reps))

    # -- plain XLA paths that replaced the removed kernels, for the record
    from points_matching.geometry.fundamental import sampson_distance

    F_h = rng.randn(pairs, hypotheses, 3, 3).astype(np.float32)
    count = jax.jit(jax.vmap(lambda f, a, b: jnp.sum(
        (sampson_distance(f, a[None], b[None]) < 2.25).astype(jnp.int32),
        axis=-1)))
    words = rng.randint(0, 2**31, (2, pairs, nkp, 8)).astype(np.uint32)
    ham = jax.jit(jax.vmap(lambda a, b: knn_match(
        Descriptors(a, jnp.ones(a.shape[:1], bool), binary=True),
        Descriptors(b, jnp.ones(b.shape[:1], bool), binary=True),
        k=2, metric="hamming")))
    out["xla_paths_of_removed_kernels"] = dict(
        sampson_count=time_on(dev, count, F_h, inputs[2], inputs[3],
                              reps=reps),
        hamming_top2=time_on(dev, ham, words[0], words[1], reps=reps))

    # -- end to end: the phase-2 step with one kernel on against both off,
    # ``loop_steps`` steps per device program, in alternating pairs (the
    # first side alternates)
    rcfg = RansacConfig(num_hypotheses=hypotheses, refit_iterations=2)
    e2e = {}
    on = "interpret" if interpret else "pallas"
    for dtype in ("f32", "bf16"):
        mcfg = MatcherConfig(metric="l2", filter="ratio", ratio=0.85,
                             compute_dtype=dtype, compact=False)

        def step(mb, rb):
            return _device_loop(_two_view_step(
                dataclasses.replace(mcfg, backend=mb),
                dataclasses.replace(rcfg, backend=rb), nkp), loop_steps)

        base = step("xla", "xla")
        for name, kern in (("matching_kernel", step(on, "xla")),
                           ("eightpoint_kernel", step("xla", on))):
            e2e[f"{dtype}_{name}"] = ab_pairs(dev, base, kern, inputs,
                                              pairs=ab_rounds, reps=reps,
                                              steps=loop_steps)
    out["two_view_end_to_end"] = e2e
    return out


def _device_loop(step, steps):
    """``steps`` two-view steps back to back in one device program, so the
    host's dispatch stays out of the per-step time.  Step ``i`` rolls the
    query rows (descriptors with their points) by ``i`` and folds ``i``
    into the keys: no step's matching or sampling is loop-invariant."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(d1, d2, p1, p2, keys):
        def body(i, acc):
            k = jax.vmap(lambda k: jax.random.fold_in(k, i))(keys)
            inl, _, _ = step(jnp.roll(d1, i, axis=1), d2,
                             jnp.roll(p1, i, axis=1), p2, k)
            return acc + jnp.sum(inl)

        return jax.lax.fori_loop(0, steps, body, jnp.int32(0))

    return run


def ab_pairs(dev, fa, fb, args, pairs=10, reps=20, steps=1) -> dict:
    """``pairs`` rounds timing A and B (medians of ``reps`` calls each),
    alternating which side runs first; times are per step (a call runs
    ``steps``).  B's wins count rounds where B's median is lower."""
    ta, tb = [], []
    for i in range(pairs):
        first_a = i % 2 == 0
        for f in ((fa, fb) if first_a else (fb, fa)):
            t = time_on(dev, f, *args, reps=reps)["median_s"] / steps
            (ta if f is fa else tb).append(t)
    return dict(steps_per_call=steps,
                xla_median_s=statistics.median(ta),
                kernel_median_s=statistics.median(tb),
                xla_quartiles_s=statistics.quantiles(ta, n=4)
                if pairs > 1 else ta,
                kernel_quartiles_s=statistics.quantiles(tb, n=4)
                if pairs > 1 else tb,
                kernel_wins=sum(b < a for a, b in zip(ta, tb)), rounds=pairs)


def phase_four_cards(devices, cameras=64, landmarks=16384,
                     obs_per_landmark=8, iterations=5, images=256,
                     keypoints=256, dim=64, reps=3) -> dict:
    """Phase 6: distributed sparse BA and ring all-pairs on a mesh of
    ``devices`` against the same problem on ``devices[0]`` alone."""
    import jax

    from points_matching.ba.sparse import bundle_adjust_sparse
    from points_matching.core.config import BAConfig
    from points_matching.parallel.all_pairs import all_pairs_scores
    from points_matching.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
    from points_matching.parallel.sharded_ba import (
        distributed_bundle_adjust_sparse,
    )

    n = len(devices)
    out = dict(n_devices=n)

    state, K = sparse_ba_inputs(cameras, landmarks, obs_per_landmark)
    cfg = BAConfig(max_iterations=iterations, rtol=0.0, pcg_iterations=25)
    one = jax.jit(lambda s, k: bundle_adjust_sparse(s, k, cfg))
    mesh = make_mesh((n,), (MODEL_AXIS,), devices=devices)

    def dist(s, k):
        return distributed_bundle_adjust_sparse(s, k, mesh, cfg)

    ref = run_on(devices[0], one, state, K)[1]
    got = dist(state, K)[1]
    jax.block_until_ready(got)
    rel = abs(float(got.final_cost) - float(ref.final_cost)) \
        / float(ref.final_cost)
    # psum partials reduce in another order than one segment_sum, and five
    # LM steps carry that forward: final costs agree to 1 %.
    check(rel <= 1e-2, f"distributed BA final cost rel diff {rel}")
    t1 = time_on(devices[0], one, state, K, reps=reps)
    tn = timed(lambda: dist(state, K), reps)
    out["sparse_ba"] = dict(
        cameras=cameras, landmarks=landmarks,
        observations=int(state.num_observations), iterations=iterations,
        initial_cost=float(ref.initial_cost),
        final_cost_1=float(ref.final_cost), final_cost_n=float(got.final_cost),
        rel_diff=rel, time_1_device=t1, time_n_devices=tn,
        speedup=t1["median_s"] / tn["median_s"])

    rng = np.random.RandomState(3)
    desc = rng.randn(images, keypoints, dim).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    # every 4th image is a noisy copy of its predecessor: real covisibility
    desc[1::4] = desc[0::4] + 0.05 * rng.randn(images // 4, keypoints, dim)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    mask = np.ones((images, keypoints), bool)
    ap_one = jax.jit(lambda d, m: all_pairs_scores(d, m, mesh=None))
    ap_mesh = make_mesh((n,), (DATA_AXIS,), devices=devices)
    ap_n = jax.jit(lambda d, m: all_pairs_scores(d, m, mesh=ap_mesh))
    s1 = np.asarray(run_on(devices[0], ap_one, desc, mask))
    sn = np.asarray(jax.block_until_ready(ap_n(desc, mask)))
    exact = float(np.mean(s1 == sn))
    max_diff = int(np.max(np.abs(s1 - sn)))
    # The same block GEMMs on each side, but in other shapes and orders:
    # a ratio-gate near-tie may flip one match in a pair's count.
    # ≥ 99 % of pair counts equal, none off by more than 2.
    check(exact >= 0.99 and max_diff <= 2,
          f"all-pairs: {exact} equal, max diff {max_diff}")
    t1 = time_on(devices[0], ap_one, desc, mask, reps=reps)
    tn = timed(lambda: ap_n(desc, mask), reps)
    out["all_pairs"] = dict(
        images=images, keypoints=keypoints, dim=dim, equal_share=exact,
        max_abs_diff=max_diff, time_1_device=t1, time_n_devices=tn,
        pairs_per_s_1=images * images / t1["median_s"],
        pairs_per_s_n=images * images / tn["median_s"])
    return out


# ------------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only phase 6 (needs 4 GPUs)")
    args = ap.parse_args()

    # the GPU first, the host CPU beside it for the references
    os.environ["JAX_PLATFORMS"] = "cuda,cpu"
    import jax

    import points_matching  # noqa: F401  (compile cache settings)

    want = 4 if args.four_cards else 1
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if len(gpus) < want:
        print(f"chip_smoke: needs {want} GPU(s), JAX found "
              f"{[d.platform for d in jax.devices()]}", file=sys.stderr)
        return 2
    gpus = gpus[:want]
    cpu = jax.devices("cpu")[0]
    cards = card_info()
    # the nvidia-smi lines as they are, before the JSON lines
    print(cards.replace("; ", "\n"), flush=True)
    device = dict(platform=gpus[0].platform, kind=gpus[0].device_kind,
                  count=len(gpus))

    os.makedirs(os.path.dirname(OUT_PATH), exist_ok=True)
    log = open(OUT_PATH, "w")

    def emit(phase, t0, **rec):
        line = json.dumps(dict(phase=phase, cards=cards, device=device,
                               seconds=time.perf_counter() - t0, **rec))
        print(line, flush=True)
        log.write(line + "\n")
        log.flush()

    t0 = time.perf_counter()
    emit("device", t0, jax_version=jax.__version__,
         devices=[str(d) for d in jax.devices()],
         compile_cache=points_matching.compile_cache_dir())
    if args.four_cards:
        phases = [("four_cards", lambda: phase_four_cards(gpus))]
    else:
        dev = gpus[0]
        phases = [
            ("image_to_f", lambda: phase_image_to_f(dev, cpu)),
            ("two_view", lambda: phase_two_view(dev, cpu)),
            ("sfm", lambda: phase_sfm(dev, cpu)),
            ("sparse_ba", lambda: phase_sparse_ba(dev, cpu)),
            ("kernels", lambda: phase_kernels(dev)),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        emit(name, t0, **fn())
    log.close()
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
