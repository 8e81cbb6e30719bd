"""Descriptor matching as distance GEMMs + top-2 — the accelerator
replacement for FLANN's KD-trees (implicit native component N3, SURVEY.md
§2.2; demo call site ``Points Matching/main.cpp:44-46``).

Where FLANN builds randomized KD-trees and answers approximate 1-NN queries,
a GPU prefers the exact brute-force form: the [N1, N2] squared-L2 matrix is
``‖a‖² + ‖b‖² − 2 a bᵀ`` — one GEMM — followed by a row-wise top-k.  Exact,
batched, and faster per pair than tree traversal at these sizes.  Binary
(ORB) descriptors use popcount-Hamming on bit-packed words.  The plain-l2
top-2 has a fused Pallas kernel (``ops/pallas/matching_kernel.py``) that
never forms the distance matrix; ``MatcherConfig.backend`` chooses it.

Filters: Lowe ratio (default), absolute threshold, mutual cross-check, and
the reference demo's midpoint rule ``d < min + (max−min)/2``
(``main.cpp:49-69``) for parity.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import Array

from points_matching.core.config import MatcherConfig
from points_matching.core.types import Descriptors, Matches
from points_matching.ops.pallas import dispatch
from points_matching.ops.pallas.matching_kernel import fused_l2_top2

_BIG = 1e30


def hamming_distance_matrix(a_bits: Array, b_bits: Array) -> Array:
    """[N1, W] × [N2, W] packed uint32 → [N1, N2] int32 Hamming distances
    (XOR + popcount over the word axis)."""
    x = jnp.bitwise_xor(a_bits[..., :, None, :], b_bits[..., None, :, :])
    return jnp.sum(jax.lax.population_count(x).astype(jnp.int32), axis=-1)


def l2_distance_matrix(a: Array, b: Array, compute_dtype: str = "f32") -> Array:
    """[N1, D] × [N2, D] → [N1, N2] squared-L2 distances via the GEMM
    identity ‖a−b‖² = ‖a‖² + ‖b‖² − 2⟨a, b⟩.

    ``compute_dtype='f32'`` pins the GEMM to full f32 (``HIGHEST``): at
    DEFAULT a GPU may run an f32 product in TF32 (10-bit mantissa), which
    flips near-tie nearest neighbours.  ``'bf16'`` feeds it bf16 operands
    with f32 accumulation; the norms stay f32 either way.
    """
    a2 = jnp.sum(a * a, axis=-1, keepdims=True)
    b2 = jnp.sum(b * b, axis=-1, keepdims=True)
    if compute_dtype == "bf16":
        a = a.astype(jnp.bfloat16)
        b = b.astype(jnp.bfloat16)
        precision = jax.lax.Precision.DEFAULT
    else:
        precision = jax.lax.Precision.HIGHEST
    ab = jnp.einsum("...id,...jd->...ij", a, b,
                    preferred_element_type=jnp.float32, precision=precision)
    d2 = a2 + jnp.swapaxes(b2, -1, -2) - 2.0 * ab
    return jnp.maximum(d2, 0.0)


def distance_matrix(
    d1: Descriptors, d2: Descriptors, metric: str = "l2",
    compute_dtype: str = "f32",
) -> Array:
    """Masked distance matrix [N1, N2]; invalid rows/cols get +inf-like."""
    if metric == "hamming":
        d = hamming_distance_matrix(d1.data, d2.data).astype(jnp.float32)
    elif metric == "l2":
        d = l2_distance_matrix(d1.data, d2.data, compute_dtype)
    elif metric == "dot":
        d = -jnp.einsum(
            "...id,...jd->...ij", d1.data, d2.data, preferred_element_type=jnp.float32
        )
    else:
        raise ValueError(f"unknown metric: {metric!r}")
    invalid = jnp.logical_or(
        ~d1.mask[..., :, None], ~d2.mask[..., None, :]
    )
    return jnp.where(invalid, _BIG, d)


def _argmin_top2(d: Array) -> Tuple[Array, Array]:
    """Exact top-2 smallest per row via two masked argmin passes (O(N)
    each, against the sort behind ``lax.top_k``).  Ties resolve to the
    lowest index, same as top_k over distinct values; for duplicated
    minima the pair {best, second} is still correct (two distinct
    positions).
    """
    n = d.shape[-1]
    i1 = jnp.argmin(d, axis=-1)
    v1 = jnp.take_along_axis(d, i1[..., None], axis=-1)[..., 0]
    masked = jnp.where(jnp.arange(n) == i1[..., None], _BIG, d)
    i2 = jnp.argmin(masked, axis=-1)
    v2 = jnp.take_along_axis(masked, i2[..., None], axis=-1)[..., 0]
    return (
        jnp.stack([v1, v2], axis=-1),
        jnp.stack([i1, i2], axis=-1).astype(jnp.int32),
    )


def knn_match(
    d1: Descriptors, d2: Descriptors, k: int = 2, metric: str = "l2",
    compute_dtype: str = "f32",
) -> Tuple[Array, Array]:
    """k nearest train descriptors per query row.

    Returns (dist [N1, k], idx [N1, k]); distances are squared-L2 for the
    'l2' metric (take sqrt for FLANN/DMatch parity).
    """
    d = distance_matrix(d1, d2, metric, compute_dtype)
    if k == 1:
        i1 = jnp.argmin(d, axis=-1)
        v1 = jnp.take_along_axis(d, i1[..., None], axis=-1)
        return v1, i1[..., None].astype(jnp.int32)
    if k == 2:
        return _argmin_top2(d)
    neg_topk, idx = jax.lax.top_k(-d, k)
    return -neg_topk, idx


def _uses_kernel(d1: Descriptors, config: MatcherConfig) -> bool:
    """The fused top-2 kernel covers the plain-l2 path on 2-D descriptor
    sets (a vmap level counts as 2-D); everything else is XLA.  'auto'
    takes it only for bf16 operands: its IEEE-f32 form runs without tensor
    cores and measured slower than XLA's f32 GEMM path on the H100
    (PERF.md)."""
    if config.metric != "l2" or config.backend == "xla" or d1.data.ndim != 2:
        return False
    return config.backend != "auto" or config.compute_dtype == "bf16"


def match_descriptors(
    d1: Descriptors,
    d2: Descriptors,
    config: MatcherConfig = MatcherConfig(),
) -> Matches:
    """1-NN matching with the configured filter — the full replacement for
    ``FlannBasedMatcher::match`` + the reference's min/max scan and midpoint
    filter (``main.cpp:44-79``).

    Returns a fixed-capacity Matches (capacity = query capacity, or
    ``config.max_matches``) with surviving matches compacted to the front.
    """
    k = 2 if (config.filter == "ratio") else 1
    use_kernel = _uses_kernel(d1, config)

    def _top2(dq: Descriptors, dt: Descriptors) -> Tuple[Array, Array]:
        def kernel(q, t, t_mask, q_mask, interpret):
            dist, idx = fused_l2_top2(q, t, t_mask, interpret=interpret,
                                      compute_dtype=config.compute_dtype)
            # query-side masking (the kernel only masks train rows)
            return jnp.where(q_mask[..., None], dist, _BIG), idx

        def reference(q, t, t_mask, q_mask):
            return knn_match(Descriptors(q, q_mask), Descriptors(t, t_mask),
                             k=2, compute_dtype=config.compute_dtype)

        return dispatch(config.backend, kernel, reference,
                        dq.data, dt.data, dt.mask, dq.mask)

    if use_kernel:
        dist, idx = _top2(d1, d2)
    else:
        dist, idx = knn_match(d1, d2, k=k, metric=config.metric,
                              compute_dtype=config.compute_dtype)
    best = dist[..., 0]
    best_idx = idx[..., 0]

    valid = jnp.logical_and(d1.mask, best < _BIG / 2)

    if config.metric == "l2":
        # FLANN reports true L2 (OpenCV takes sqrt of FLANN's squared L2) —
        # match that so thresholds/ratios are comparable.
        best_reported = jnp.sqrt(best)
        second_reported = jnp.sqrt(dist[..., 1]) if k == 2 else None
    else:
        best_reported = best
        second_reported = dist[..., 1] if k == 2 else None

    if config.filter == "ratio":
        keep = best_reported < config.ratio * jnp.maximum(second_reported, 1e-12)
    elif config.filter == "midpoint":
        # Reference rule (main.cpp:49-69): min initialized to 1, max to 0;
        # keep d < min + (max-min)/2.
        masked = jnp.where(valid, best_reported, jnp.inf)
        dmin = jnp.minimum(jnp.min(masked, axis=-1, keepdims=True), 1.0)
        masked_neg = jnp.where(valid, best_reported, -jnp.inf)
        dmax = jnp.maximum(jnp.max(masked_neg, axis=-1, keepdims=True), 0.0)
        keep = best_reported < dmin + (dmax - dmin) / 2.0
    elif config.filter == "threshold":
        keep = best_reported < config.threshold
    elif config.filter == "none":
        keep = jnp.ones_like(valid)
    else:
        raise ValueError(f"unknown filter: {config.filter!r}")
    keep = jnp.logical_and(keep, valid)

    if config.cross_check:
        # mutual 1-NN: train j's best query must be this query i.  The
        # reverse pass rides the same route as the forward one.
        if use_kernel:
            _, it = _top2(d2, d1)
        else:
            _, it = knn_match(d2, d1, k=1, metric=config.metric,
                              compute_dtype=config.compute_dtype)
        reverse_best = jnp.take(it[..., 0], jnp.clip(best_idx, 0, d2.capacity - 1), axis=-1)
        qi = jnp.arange(d1.capacity)
        keep = jnp.logical_and(keep, reverse_best == qi)

    query_idx = jnp.arange(d1.capacity, dtype=jnp.int32)

    if not config.compact:
        # Query-order form: row i is query i's best match, mask = survived.
        # No cumsum/scatter epilogue — mask-aware consumers (RANSAC) don't
        # need the dense prefix.
        return Matches(
            query_idx=query_idx,
            train_idx=jnp.where(keep, best_idx.astype(jnp.int32), 0),
            distance=jnp.where(keep, best_reported, 0.0),
            mask=keep,
        )

    # Clamp to the query capacity: a max_matches beyond it would slice into
    # the overflow slot (whose discarded arbitrary entry must never surface)
    # and desync the buffer/mask lengths (ADVICE r3).
    cap = min(config.max_matches or d1.capacity, d1.capacity)
    # Compact surviving matches to the front (stable) so downstream
    # fixed-capacity consumers see a dense prefix.  One cumsum + one
    # scatter — O(N), no sort; discarded entries all land in an overflow
    # slot that the final slice drops.
    slot = jnp.where(keep, jnp.cumsum(keep) - 1, d1.capacity)
    n_keep = jnp.sum(keep.astype(jnp.int32))

    def compact(vals, fill):
        buf = jnp.full((d1.capacity + 1,), fill, dtype=vals.dtype)
        return buf.at[slot].set(vals, mode="drop")[:cap]

    return Matches(
        query_idx=compact(query_idx, jnp.int32(0)),
        train_idx=compact(best_idx.astype(jnp.int32), jnp.int32(0)),
        distance=compact(best_reported, jnp.float32(0.0)),
        mask=jnp.arange(cap) < n_keep,
    )


def match_descriptors_points(
    d1: Descriptors,
    d2: Descriptors,
    t_points: Array,
    config: MatcherConfig = MatcherConfig(),
) -> Tuple[Matches, Array]:
    """``match_descriptors`` + the matched TRAIN POINT per match row.

    Returns (Matches, pts [M, P]) with ``pts[i] == t_points[train_idx[i]]``
    on EVERY row — filtered rows report train_idx 0 and t_points[0].
    With ``compact=False`` the rows are in query order.
    """
    m = match_descriptors(d1, d2, config)
    n2 = t_points.shape[0]
    pts = jnp.take(t_points, jnp.clip(m.train_idx, 0, n2 - 1), axis=0)
    return m, pts


def match_stats(m: Matches) -> Tuple[Array, Array]:
    """(min, max) distance over valid matches — the reference's min/max scan
    (``main.cpp:49-59``), including its min=1 / max=0 initialization."""
    dmin = jnp.minimum(jnp.min(jnp.where(m.mask, m.distance, jnp.inf), axis=-1), 1.0)
    dmax = jnp.maximum(jnp.max(jnp.where(m.mask, m.distance, -jnp.inf), axis=-1), 0.0)
    return dmin, dmax
