#!/usr/bin/env python
"""Cumulative-slice probe of the match+RANSAC step at bench shapes —
chunked fetch-synced slope timing per slice (bench.py methodology).

Slices (cumulative):
  match     - match_descriptors only (NOTE: the compaction scatter inside
              match_descriptors is dead code in this slice — only the mask
              is consumed — so 'match' under-reports the production
              matcher; 'gather' is the first slice that pays it)
  gather    - + matched-point gathers (makes query/train_idx live)
  sample    - + sample_index_sets + minimal-set gathers
  solve     - + batched 8-point over hypotheses (RansacConfig.backend,
              PMT_PROBE_BACKEND=auto|xla|pallas)
  score     - + Sampson scoring + argmax
  refit     - + 2 refit rounds (= production ransac_fundamental)

Usage: python ransac_slices.py [slice ...]
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

BATCH, NKP, DIM, HYP, POOL, RATIO = 64, 512, 64, 512, 16, 0.85
CHUNK = 64
TARGET_GAP_S = 3.0


def main():
    slices = sys.argv[1:] or [
        "match", "gather", "sample", "solve", "score", "refit"]

    import jax
    import jax.numpy as jnp

    from points_matching.core.config import MatcherConfig, RansacConfig
    from points_matching.core.types import Descriptors
    from points_matching.geometry.fundamental import (
        eight_point, sampson_distance)
    from points_matching.geometry.ransac import (
        ransac_fundamental, sample_minimal_points)
    from points_matching.ops.matching import match_descriptors
    from points_matching.ops.pallas import dispatch
    from points_matching.ops.pallas.eightpoint_kernel import (
        minimal_eight_point)

    rng = np.random.RandomState(0)
    d1 = rng.randn(POOL * BATCH, NKP, DIM).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 = d1 + 0.1 * rng.randn(*d1.shape).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    p1 = rng.uniform(0, 640, (POOL * BATCH, NKP, 2)).astype(np.float32)
    p2 = p1 + rng.randn(POOL * BATCH, NKP, 2).astype(np.float32)
    sh = lambda x: jnp.asarray(x.reshape(POOL, BATCH, *x.shape[1:]))
    pd1, pd2, pp1, pp2 = sh(d1), sh(d2), sh(p1), sh(p2)

    mcfg = MatcherConfig(metric="l2", filter="ratio", ratio=RATIO,
                         compute_dtype="bf16", compact=False)
    rcfg = RansacConfig(
        num_hypotheses=HYP,
        backend=os.environ.get("PMT_PROBE_BACKEND", "auto"),
    )
    mask1 = jnp.ones((NKP,), bool)

    def solve_fn(sp1, sp2):
        return dispatch(rcfg.backend, minimal_eight_point, eight_point,
                        sp1, sp2)

    def do_match(a, b):
        return match_descriptors(
            Descriptors(data=a, mask=mask1), Descriptors(data=b, mask=mask1),
            mcfg)

    from points_matching.ops.matching import match_descriptors_points
    from points_matching.core.types import Descriptors as _D

    def upto(stage):
        def per_pair(a, b, pa, pb, k):
            if stage == "match":
                m = do_match(a, b)
                return jnp.sum(m.mask.astype(jnp.float32))
            # query side is gather-free (query-order matches)
            m, q2 = match_descriptors_points(
                _D(data=a, mask=mask1), _D(data=b, mask=mask1), pb, mcfg)
            q1 = pa
            if stage == "gather":
                return jnp.sum(q1) * 1e-6 + jnp.sum(q2) * 1e-6
            sp1, sp2 = sample_minimal_points(k, m.mask, HYP, 8, (q1, q2))
            if stage == "sample":
                return jnp.sum(sp1) * 1e-6
            F_h = solve_fn(sp1, sp2)
            if stage == "solve":
                return jnp.sum(F_h) * 1e-3
            d = sampson_distance(F_h, q1[None], q2[None])
            inl = jnp.logical_and(d < rcfg.inlier_threshold**2, m.mask[None])
            counts = jnp.sum(inl.astype(jnp.int32), axis=-1)
            if stage == "score":
                return jnp.max(counts).astype(jnp.float32)
            est = ransac_fundamental(k, q1, q2, m.mask, rcfg)
            return est.num_inliers.astype(jnp.float32)

        def step(a, b, pa, pb, ks):
            return jnp.sum(jax.vmap(per_pair)(a, b, pa, pb, ks))

        return step

    for name in slices:
        per_step = upto(name)

        @jax.jit
        def run_chunk(pd1, pd2, pp1, pp2, acc0, cid):
            # pools are ARGUMENTS, not closure captures: captured arrays are
            # baked into the HLO as literals.
            def body(carry, ks):
                i, acc = carry
                sl = i % POOL
                take = lambda p: jax.lax.dynamic_index_in_dim(
                    p, sl, 0, keepdims=False)
                s = per_step(take(pd1), take(pd2), take(pp1), take(pp2), ks)
                return (i + 1, acc + s * 1e-6), None

            keys = jax.random.split(
                jax.random.fold_in(jax.random.PRNGKey(0), cid), (CHUNK, BATCH))
            (_, acc), _ = jax.lax.scan(body, (jnp.int32(0), acc0), keys)
            return acc

        def run(k):
            acc = jnp.float32(0.0)
            for i in range(k):
                acc = run_chunk(pd1, pd2, pp1, pp2, acc, jnp.int32(i))
            return float(acc)

        try:
            t0 = time.time(); run(1); compile_s = time.time() - t0
        except Exception as e:
            print(json.dumps(dict(slice=name,
                                  error=f"{type(e).__name__}: {e}"[:200])),
                  flush=True)
            continue
        best_s = float("inf")
        for _ in range(3):
            t0 = time.time(); run(1); best_s = min(best_s, time.time() - t0)
        t0 = time.time(); run(3)
        per_chunk = max((time.time() - t0 - best_s) / 2.0, 1e-3)
        k_long = 1 + max(3, int(TARGET_GAP_S / per_chunk))
        best_l = float("inf")
        for _ in range(2):
            t0 = time.time(); run(k_long); best_l = min(best_l, time.time() - t0)
        gap = best_l - best_s
        pps = (k_long - 1) * CHUNK * BATCH / gap
        print(json.dumps(dict(
            slice=name, pairs_per_sec=round(pps),
            us_per_pair=round(1e6 / pps, 1), gap_s=round(gap, 3),
            compile_s=round(compile_s, 1))), flush=True)


if __name__ == "__main__":
    main()
