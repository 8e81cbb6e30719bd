"""Fused L2-distance + top-2 matching kernel (Pallas through Triton).

The XLA path (``ops/matching.py``) writes the [N1, N2] distance matrix to
device memory and reads it back for the validity mask and the two argmin
passes.  This kernel never forms that matrix: one program owns a tile of
query rows, loops over the train rows tile by tile, computes each distance
tile as one ``pl.dot`` and folds it into a running (best, second-best,
argbest, arg-second) held in registers.  Only four [N1] vectors leave the
kernel.  Reference call site: ``Points Matching/main.cpp:44-46``.

Layout: grid = (query tiles,), plus a leading grid axis per ``vmap``
level.  The train loop runs inside the program, so no state crosses
program boundaries.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import Array
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

_BIG = 1e30


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _tile_top2(d: Array, base: Array, block_t: int):
    """Row-wise (m1, m2, g1, g2) of a [BQ, BT] distance tile: best and
    runner-up value and their global column (``base`` + local); ties go to
    the lowest column."""
    col = jax.lax.broadcasted_iota(jnp.int32, d.shape, 1)
    m1 = jnp.min(d, axis=1)
    l1 = jnp.min(jnp.where(d <= m1[:, None], col, block_t), axis=1)
    masked = jnp.where(col == l1[:, None], _BIG, d)
    m2 = jnp.min(masked, axis=1)
    l2 = jnp.min(jnp.where(masked <= m2[:, None], col, block_t), axis=1)
    return m1, m2, base + l1, base + l2


def _carry_duel(b1, b2, i1, i2, m1, m2, g1, g2):
    """Merge the running (best, second) with a new tile's top-2.

    Runner-up = best of (loser of the b1/m1 duel, min(b2, m2)), with values
    and indices tracked together so i2 is the true 2-NN.  The earlier tile
    wins ties, which keeps the lowest index."""
    take1 = m1 < b1
    new_b1 = jnp.minimum(b1, m1)
    new_i1 = jnp.where(take1, g1, i1)
    loser_v = jnp.maximum(b1, m1)
    loser_i = jnp.where(take1, i1, g1)
    cand_v = jnp.minimum(b2, m2)
    cand_i = jnp.where(m2 < b2, g2, i2)
    new_b2 = jnp.minimum(loser_v, cand_v)
    new_i2 = jnp.where(loser_v < cand_v, loser_i, cand_i)
    return new_b1, new_b2, new_i1, new_i2


def _top2_kernel(q_ref, t_ref, t2_ref, b1_ref, b2_ref, i1_ref, i2_ref, *,
                 block_t: int, gemm_dtype, precision):
    q = q_ref[...]                                    # [BQ, D] f32
    bq = q.shape[0]
    qg = q.astype(gemm_dtype)
    n_tiles = t_ref.shape[0] // block_t

    def body(j, carry):
        base = j * block_t
        sl = pl.ds(base, block_t)
        t = t_ref[sl, :].astype(gemm_dtype)           # [BT, D]
        t2 = t2_ref[sl]                               # [BT]
        # ‖q‖² is constant per row: added once after the loop.
        d = t2[None, :] - 2.0 * pl.dot(qg, t, trans_b=True,
                                       precision=precision)
        return _carry_duel(*carry, *_tile_top2(d, base, block_t))

    inf = jnp.full((bq,), jnp.inf, jnp.float32)
    zero = jnp.zeros((bq,), jnp.int32)
    b1, b2, i1, i2 = jax.lax.fori_loop(0, n_tiles, body,
                                       (inf, inf, zero, zero))
    q2 = jnp.sum(q * q, axis=1)
    b1_ref[...] = jnp.maximum(b1 + q2, 0.0)
    b2_ref[...] = jnp.maximum(b2 + q2, 0.0)
    i1_ref[...] = i1
    i2_ref[...] = i2


def _pad_rows(x: Array, n: int, value=0.0) -> Array:
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    cfg = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, cfg, constant_values=value)


@functools.partial(jax.jit, static_argnames=(
    "block_q", "block_t", "num_warps", "num_stages", "interpret",
    "compute_dtype"))
def fused_l2_top2(
    q: Array,
    t: Array,
    t_mask: Array,
    block_q: int = 64,
    block_t: int = 64,
    num_warps: int = 4,
    num_stages: int = 2,
    interpret: bool = False,
    compute_dtype: str = "f32",
) -> Tuple[Array, Array]:
    """Squared-L2 (best, second-best) distances and indices per query row.

    Args:
      q: [N1, D] query descriptors; t: [N2, D] train descriptors.
      t_mask: [N2] — invalid train rows are excluded (treated as +inf).
      compute_dtype: 'f32' runs the distance product in IEEE f32 (no TF32);
        'bf16' feeds it bf16 operands with f32 accumulation.  The norms
        stay f32 either way, as in ``l2_distance_matrix``.
      interpret: run through the Pallas interpreter (tests without a GPU).

    Returns:
      (dist [N1, 2] squared-L2 — column 1 is the runner-up for the ratio
      test, idx [N1, 2] int32 — the 1-NN and 2-NN train indices).

    Matches ``knn_match(..., k=2)`` on valid rows; the caller applies
    query-side masking.  Shapes are padded to the tiles (rows) and to a
    power of two (descriptor width); padded train rows are masked out.
    """
    n1, d = q.shape
    n2 = t.shape[0]
    dp = max(16, _next_pow2(d))
    bt = min(block_t, max(16, _next_pow2(n2)))
    bq = min(block_q, max(16, _next_pow2(n1)))
    n1p = -(-n1 // bq) * bq
    n2p = -(-n2 // bt) * bt

    q = q.astype(jnp.float32)
    t = t.astype(jnp.float32)
    qp = jnp.pad(_pad_rows(q, n1p), ((0, 0), (0, dp - d)))
    tp = jnp.pad(_pad_rows(t, n2p), ((0, 0), (0, dp - d)))
    valid = _pad_rows(t_mask.astype(bool), n2p, False)
    # invalid/padded train rows → huge ‖t‖² → never selected
    t2 = jnp.where(valid, jnp.sum(tp * tp, axis=-1), _BIG)

    bf16 = compute_dtype == "bf16"
    kernel = functools.partial(
        _top2_kernel, block_t=bt,
        gemm_dtype=jnp.bfloat16 if bf16 else jnp.float32,
        precision=(jax.lax.Precision.DEFAULT if bf16
                   else jax.lax.Precision.HIGHEST))
    row = pl.BlockSpec((bq,), lambda i: (i,))
    b1, b2, i1, i2 = pl.pallas_call(
        kernel,
        grid=(n1p // bq,),
        in_specs=[
            pl.BlockSpec((bq, dp), lambda i: (i, 0)),
            pl.BlockSpec((n2p, dp), lambda i: (0, 0)),
            pl.BlockSpec((n2p,), lambda i: (0,)),
        ],
        out_specs=[row, row, row, row],
        out_shape=[
            jax.ShapeDtypeStruct((n1p,), jnp.float32),
            jax.ShapeDtypeStruct((n1p,), jnp.float32),
            jax.ShapeDtypeStruct((n1p,), jnp.int32),
            jax.ShapeDtypeStruct((n1p,), jnp.int32),
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=num_stages),
        interpret=interpret,
        name="fused_l2_top2",
    )(qp, tp, t2)
    dist = jnp.stack([b1[:n1], b2[:n1]], axis=-1)
    idx = jnp.stack([i1[:n1], i2[:n1]], axis=-1)
    return dist, idx
