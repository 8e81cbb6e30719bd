"""Sharded all-pairs descriptor matching (BASELINE config 1: "all-pairs
matching of 1k images" over a device mesh; SURVEY.md §2.3 P1/P4).

Layout: image descriptors ``[N, K, D]`` are sharded over the ``data`` axis
(each device owns a block of images).  Scores for *all* ordered pairs are
computed with a **ring exchange**: at step s every device scores its local
query block against the train block it currently holds, then forwards that
block one hop around the ring (``ppermute`` → neighbor links — NVLink on a GPU host).  After ``n_devices`` steps each device has scored its queries against
every image without ever materializing the full descriptor set per device —
the covisibility analogue of ring attention (SURVEY.md §5).

Pair score = number of ratio-test-passing 1-NN matches — the covisibility
statistic used for loop detection / view-graph construction in the SfM
layer.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from points_matching.parallel.comm import Comm
from points_matching.parallel.mesh import DATA_AXIS

Array = jax.Array

_BIG = 1e30


def _pair_scores_block(
    qd: Array, qm: Array, td: Array, tm: Array, ratio: float
) -> Array:
    """Score every (query image, train image) pair in two blocks.

    qd: [Q, K, D]; qm: [Q, K]; td: [T, K, D]; tm: [T, K] → [Q, T] int32
    counts of ratio-test-passing 1-NN matches.  The inner distance matrix is
    one big batched GEMM ([Q*T, K, K] tiles).
    """
    # [Q, T, K, K] squared-L2 via the GEMM identity
    q2 = jnp.sum(qd * qd, axis=-1)  # [Q, K]
    t2 = jnp.sum(td * td, axis=-1)  # [T, K]
    ip = jnp.einsum("qkd,tld->qtkl", qd, td, preferred_element_type=jnp.float32)
    d2 = q2[:, None, :, None] + t2[None, :, None, :] - 2.0 * ip
    d2 = jnp.maximum(d2, 0.0)
    invalid = ~qm[:, None, :, None] | ~tm[None, :, None, :]
    d2 = jnp.where(invalid, _BIG, d2)

    # top-2 over the train-keypoint axis for the ratio test: two masked
    # min-reductions — three O(N) passes instead of a sort (same
    # trick as ops/matching._argmin_top2; duplicate minima still yield
    # second == best, which the ratio gate must see)
    best = jnp.min(d2, axis=-1)
    i1 = jnp.argmin(d2, axis=-1)
    kl = d2.shape[-1]
    masked = jnp.where(jnp.arange(kl) == i1[..., None], _BIG, d2)
    second = jnp.min(masked, axis=-1)
    ok = (best < ratio * ratio * second) & (best < _BIG / 2) & qm[:, None, :]
    return jnp.sum(ok.astype(jnp.int32), axis=-1)  # [Q, T]


def _ring_all_pairs(qd, qm, comm: Comm, ratio: float, train_chunk: int):
    """Ring loop body shared by the shard_map and single-device paths.

    qd/qm double as the initial train block; returns [Q_local, N_total].
    """
    n_dev = comm.size()
    my = comm.index()

    def score_vs_block(td, tm):
        # chunk the train block to bound the [Q, T, K, K] working set
        T = td.shape[0]
        c = min(train_chunk, T)
        pad = (-T) % c
        tdp = jnp.pad(td, ((0, pad), (0, 0), (0, 0)))
        tmp = jnp.pad(tm, ((0, pad), (0, 0)))
        chunks_d = tdp.reshape(-1, c, *td.shape[1:])
        chunks_m = tmp.reshape(-1, c, tm.shape[1])
        out = lax.map(
            lambda ab: _pair_scores_block(qd, qm, ab[0], ab[1], ratio),
            (chunks_d, chunks_m),
        )  # [nc, Q, c]
        out = jnp.moveaxis(out, 0, 1).reshape(qd.shape[0], -1)
        return out[:, :T]

    def step(s, carry):
        td, tm, scores = carry
        # ring_shift(+1) forwards blocks clockwise, so after s hops the
        # block in hand originated at device (my - s) mod n
        src = (my - s) % n_dev
        blk = score_vs_block(td, tm)  # [Q, B]
        scores = lax.dynamic_update_slice(
            scores, blk.astype(scores.dtype), (0, src * td.shape[0])
        )
        # forward the train block one hop (no-op on the last step's result)
        td = comm.ring_shift(td, 1)
        tm = comm.ring_shift(tm, 1)
        return td, tm, scores

    n_total = qd.shape[0] * n_dev
    scores0 = jnp.zeros((qd.shape[0], n_total), jnp.int32)
    if comm.axis is not None:
        # mark the carry as device-varying so the fori_loop types check under
        # shard_map's varying-manual-axes discipline
        scores0 = lax.pcast(scores0, comm.axis, to="varying")
    _, _, scores = lax.fori_loop(0, n_dev, step, (qd, qm, scores0))
    return scores


def all_pairs_scores(
    desc: Array,
    mask: Array,
    mesh: Optional[Mesh] = None,
    ratio: float = 0.8,
    train_chunk: int = 8,
) -> Array:
    """[N, K, D] float descriptors + [N, K] masks → [N, N] match-count
    matrix (diagonal included; caller typically zeroes it).

    With a mesh: images sharded over ``data``, ring exchange between neighbors.
    Without: same code on the no-op Comm backend (single device).
    """
    if mesh is None or mesh.size == 1:
        comm = Comm(None)
        return _ring_all_pairs(desc, mask, comm, ratio, train_chunk)

    n_dev = mesh.shape[DATA_AXIS]
    if desc.shape[0] % n_dev != 0:
        raise ValueError(
            f"num images ({desc.shape[0]}) must divide the data axis ({n_dev}); "
            "pad with masked images"
        )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(DATA_AXIS),
    )
    def run(d_local, m_local):
        return _ring_all_pairs(d_local, m_local, Comm(DATA_AXIS), ratio, train_chunk)

    return run(desc, mask)
