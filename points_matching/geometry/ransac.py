"""Massively-batched RANSAC for fundamental/essential estimation.

The reference calls ``findFundamentalMat`` once, with no RANSAC
(``Points Matching/main.cpp:95-98``).  On an accelerator the idiomatic
design is the opposite of sequential hypothesis loops: ALL hypotheses are
sampled, solved (``vmap`` over the 8-point solver) and scored (one [H, N]
Sampson-distance evaluation) in a single traced program — dense, with no
data-dependent control flow (BASELINE north-star: "per-pair RANSAC becomes
massively batched hypothesis evaluation").
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import Array

from points_matching.core.config import RansacConfig
from points_matching.core.types import TwoViewEstimate
from points_matching.core.precision import f32_matmuls
from points_matching.ops.pallas import dispatch
from points_matching.ops.pallas.eightpoint_kernel import minimal_eight_point
from points_matching.geometry.fundamental import (
    eight_point,
    epipolar_residual_audit,
    sampson_distance,
    seven_point,
)


@f32_matmuls
def sample_index_sets(
    key: Array,
    mask: Array,
    num_hypotheses: int,
    sample_size: int,
    logits: Optional[Array] = None,
) -> Array:
    """Sample [H, S] index sets WITHOUT replacement within a set, with
    P ∝ exp(logits) over valid entries.

    Implementation: STRATIFIED Gumbel sampling over one shared random
    partition.  A fresh random permutation splits the N slots into S
    equal buckets; every hypothesis draws its k-th element as the Gumbel
    argmax (P ∝ exp(logits) — the Gumbel-max trick) within bucket k.
    Buckets are disjoint, so a minimal set can never contain duplicates —
    the property that matters: a with-replacement inverse-CDF sampler was
    measured as a 50× ATE regression on the 100-frame SfM sequence,
    because under sharp ``logits`` it repeats top rows within a set and
    collapses the 6-point DLT to fewer constraints.

    Why stratified and not exact top-k: the previous S-masked-argmax
    implementation generated an [H, N] Gumbel matrix (threefry bits are
    ~tens of integer ops per element) and made S full read+modify passes
    over it; the cost sat in the [H·N] random-bit generation itself.
    Stratified inverse-CDF
    sampling needs only [H, S] uniforms — S·(N/S)·≈64× fewer random bits
    — and its one O(H·N) op is a fused broadcast-compare-reduce against
    a shared [S, N/S] prefix table.  Distribution per (hypothesis,
    bucket): P(pick i) = wᵢ / Σ_bucket w exactly, the same within-bucket
    law as Gumbel argmax; the partition is a fresh uniform permutation
    per call, so by exchangeability every S-subset has equal marginal
    probability under uniform logits.  Hypotheses within one call share
    the partition (pairs co-bucketed this call never co-occur — RANSAC
    diversity comes from the within-bucket draws; re-drawn next call).

    Degenerate-mask behavior (ADVICE r3): an all-invalid bucket has zero
    total weight, so its draw clips to the bucket's last slot — a
    duplicate-free but possibly invalid pick whose hypothesis scores ~0
    inliers and loses the consensus argmax; callers that can starve
    (SfM registration) additionally gate on a minimum inlier count.

    Hot paths use ``sample_minimal_points`` below, which returns the
    sampled POINTS via a bucket-blocked one-hot matmul instead of [H, S]
    per-hypothesis gathers.
    """
    j, slot_idx, bucket = _stratified_positions(
        key, mask, num_hypotheses, sample_size, logits
    )
    S = sample_size
    picks = slot_idx[jnp.arange(S)[None, :] * bucket + j]
    return picks.astype(jnp.int32)


def _stratified_positions(
    key: Array,
    mask: Array,
    num_hypotheses: int,
    sample_size: int,
    logits: Optional[Array] = None,
) -> Tuple[Array, Array, int]:
    """Shared core of the stratified samplers: bucket-local draw positions.

    Returns (j [H, S] position within each bucket, slot_idx [S·bucket]
    original index per slot, bucket size).  See ``sample_index_sets`` for
    the distribution contract.
    """
    n = mask.shape[-1]
    S = sample_size
    bucket = -(-n // S)                # slots per bucket (ceil)
    m = bucket * S

    k_perm, k_u = jax.random.split(key)
    perm = jax.random.permutation(k_perm, m).astype(jnp.int32)  # [m]
    # slots ≥ n are virtual padding → invalid
    slot_idx = jnp.minimum(perm, n - 1)
    slot_valid = jnp.logical_and(perm < n, mask[slot_idx])
    slot_logits = None if logits is None else \
        jnp.where(mask, logits, -jnp.inf)[slot_idx]
    j = _bucket_draws(k_u, slot_valid, slot_logits, num_hypotheses, S, bucket)
    return j, slot_idx, bucket


def _bucket_draws(
    k_u: Array,
    slot_valid: Array,
    slot_logits: Optional[Array],
    num_hypotheses: int,
    S: int,
    bucket: int,
) -> Array:
    """Within-bucket inverse-CDF draws given per-slot validity/logits
    (slots already in bucket-permuted order).  Split out of
    ``_stratified_positions`` so ``sample_minimal_points`` can supply
    validity/logits from its fused table gather."""
    if slot_logits is None:
        w = slot_valid.astype(jnp.float32)
    else:
        # Shift by the PER-BUCKET max so exp() cannot overflow (ADVICE r4:
        # a global max degenerates any bucket sitting > 60 nats below it
        # to uniform-within-bucket weights — the draw is bucket-local, so
        # only the within-bucket shift matters and it is distribution-
        # exact).  Invalid slots → weight 0.
        lgb = jnp.where(slot_valid, slot_logits, -jnp.inf).reshape(S, bucket)
        lmax = jnp.max(lgb, axis=-1, keepdims=True)          # [S, 1]
        lmax = jnp.where(jnp.isfinite(lmax), lmax, 0.0)
        w = jnp.where(
            slot_valid.reshape(S, bucket),
            jnp.exp(jnp.clip(lgb - lmax, -60.0, 0.0)), 0.0
        ).reshape(-1)

    cdf = jnp.cumsum(w.reshape(S, bucket), axis=-1)       # [S, bucket]
    total = cdf[:, -1]                                    # [S]
    u = jax.random.uniform(k_u, (num_hypotheses, S)) * total[None, :]
    # smallest j with cdf[j] > u  ==  #{j : cdf[j] <= u}; empty bucket
    # (total = 0, cdf ≡ 0, u = 0) counts `bucket` and clips to the last slot
    j = jnp.sum((cdf[None] <= u[..., None]).astype(jnp.int32), axis=-1)
    j = jnp.minimum(j, bucket - 1)                        # [H, S]
    return j


@f32_matmuls
def sample_minimal_points(
    key: Array,
    mask: Array,
    num_hypotheses: int,
    sample_size: int,
    tables: Tuple[Array, ...],
    logits: Optional[Array] = None,
) -> Tuple[Array, ...]:
    """Stratified minimal-set sampling that returns the sampled ROWS of
    ``tables`` directly — the gather-free fast path for RANSAC solvers.

    Same draw distribution as ``sample_index_sets`` (shared core), but the
    [H, S] indexed reads are restructured as a bucket-blocked one-hot
    matmul: the concatenated [N, C] table is permuted once into bucket
    order ([m] row gather), and each hypothesis row is Σ_b onehot[h,s,b] ·
    table[s,b,:] — S batched [H, bucket] × [bucket, C] GEMMs at f32
    precision (exact: one nonzero 0/1 term per output).  Whether this
    beats a plain [H, S] gather on the GPU is not measured yet.

    Args:
      tables: arrays [N, C_i] sharing the leading axis with ``mask``.

    Returns: tuple of [H, S, C_i] sampled rows, in table order.
    """
    n = mask.shape[-1]
    S = sample_size
    bucket = -(-n // S)
    m = bucket * S

    k_perm, k_u = jax.random.split(key)
    perm = jax.random.permutation(k_perm, m).astype(jnp.int32)   # [m]
    slot_idx = jnp.minimum(perm, n - 1)

    widths = [t.shape[-1] for t in tables]
    # ONE fused row gather for coordinates + validity (+ logits), riding
    # them as extra f32 columns instead of separate gathers.
    cols = list(tables) + [mask.astype(jnp.float32)[:, None]]
    if logits is not None:
        cols.append(jnp.where(mask, logits, 0.0).astype(jnp.float32)[:, None])
    table = jnp.concatenate(cols, axis=-1).astype(jnp.float32)   # [N, ΣC+1(+1)]
    gathered = table[slot_idx]                                   # [m, ·]
    C = sum(widths)
    slot_valid = jnp.logical_and(perm < n, gathered[:, C] > 0.5)
    slot_logits = None if logits is None else \
        jnp.where(slot_valid, gathered[:, C + 1], -jnp.inf)
    j = _bucket_draws(k_u, slot_valid, slot_logits, num_hypotheses, S, bucket)
    tab_b = gathered[:, :C].reshape(S, bucket, C)                # [S, b, C]
    onehot = (
        j[..., None] == jnp.arange(bucket, dtype=j.dtype)
    ).astype(jnp.float32)                                         # [H, S, b]
    # HIGHEST: the coordinate operand carries pixel values ~600, which a
    # TF32 or bf16 pass would round to a sub-pixel grid (core/precision.py).
    sp = jnp.einsum(
        "hsb,sbc->hsc", onehot, tab_b,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    out = []
    c0 = 0
    for w in widths:
        out.append(sp[..., c0:c0 + w])
        c0 += w
    return tuple(out)


# Backwards-compatible alias (the uniform-over-mask case).
def _sample_minimal_sets(
    key: Array, mask: Array, num_hypotheses: int, sample_size: int
) -> Array:
    return sample_index_sets(key, mask, num_hypotheses, sample_size)


@f32_matmuls
def ransac_fundamental(
    key: Array,
    p1: Array,
    p2: Array,
    mask: Array,
    config: RansacConfig = RansacConfig(),
) -> TwoViewEstimate:
    """Batched-hypothesis RANSAC for F with least-squares refit.

    Args:
      key:   PRNG key.
      p1, p2: [N, 2] matched pixel coordinates (padded rows allowed).
      mask:  [N] validity of each correspondence.
      config: static RansacConfig.

    Returns TwoViewEstimate (F, inlier mask, count, reference-form residual).
    """
    n = p1.shape[0]
    mask = mask.astype(bool)

    sample_size = 7 if config.solver == "7pt" else config.sample_size
    sp1, sp2 = sample_minimal_points(
        key, mask, config.num_hypotheses, sample_size, (p1, p2)
    )  # [H, S, 2] each — gather-free (see sample_minimal_points)

    # Solve all hypotheses at once.
    if config.solver == "7pt":
        # 7-point minimal solve: each sample yields ≤3 real cubic roots;
        # all roots enter the hypothesis pool (so H samples → 3H scored
        # models).  Minimal samples need fewer draws to be all-inlier than
        # 8-point samples at the same outlier rate — the standard way to
        # make RANSAC sample-efficient (VERDICT r1 item 4; the reference's
        # own method flag is CV_FM_7POINT, main.cpp:98).
        F_cand, root_valid = seven_point(sp1, sp2)      # [H, 3, 3, 3], [H, 3]
        F_h = F_cand.reshape(-1, 3, 3)                  # [3H, 3, 3]
        hyp_valid = root_valid.reshape(-1)              # [3H]
    elif sample_size == 8:
        # fused minimal solve (ops/pallas/eightpoint_kernel.py) or the
        # vmapped XLA chain, per config.backend
        F_h = dispatch(config.backend, minimal_eight_point, eight_point,
                       sp1, sp2)  # [H, 3, 3]
        hyp_valid = jnp.ones((F_h.shape[0],), bool)
    else:
        F_h = eight_point(sp1, sp2)  # [H, 3, 3]
        hyp_valid = jnp.ones((F_h.shape[0],), bool)

    # Score all hypotheses against all correspondences: one [H, N]
    # Sampson gate + count, which XLA fuses into one pass.
    d = sampson_distance(F_h, p1[None], p2[None])
    inliers_h = jnp.logical_and(d < config.inlier_threshold**2, mask[None])
    counts = jnp.sum(inliers_h.astype(jnp.int32), axis=-1)
    counts = jnp.where(hyp_valid, counts, -1)
    best = jnp.argmax(counts)
    best_inliers = inliers_h[best]
    F = F_h[best]

    if config.refit:
        def refit_once(carry, _):
            F_cur, inl = carry
            w = inl.astype(p1.dtype)
            # Guard: refitting needs ≥8 inliers; otherwise keep the model.
            enough = jnp.sum(w) >= 8.0
            F_new = eight_point(p1, p2, w)
            F_next = jnp.where(enough, F_new, F_cur)
            d_new = sampson_distance(F_next, p1, p2)
            inl_new = jnp.logical_and(d_new < config.inlier_threshold**2, mask)
            return (F_next, inl_new), None

        (F, best_inliers), _ = jax.lax.scan(
            refit_once, (F, best_inliers), None, length=config.refit_iterations
        )

    num_inliers = jnp.sum(best_inliers.astype(jnp.int32))
    _, res_mean = epipolar_residual_audit(F, p1, p2, best_inliers, form="reference")
    return TwoViewEstimate(
        F=F,
        inlier_mask=best_inliers,
        num_inliers=num_inliers,
        residual_mean=res_mean,
    )
