"""Pipeline parallelism (SURVEY.md §2.3 P3): stage the streaming SLAM
pipeline (frontend → matching → geometry → refine) across devices and
microbatch frames through the stages — GPipe-style.

The reference processes one image pair, one stage at a time, on one CPU
(``Points Matching/main.cpp:9-146``).  Here each pipeline *stage* lives on
its own device along a ``stage`` mesh axis; microbatches (frames / pairs)
stream through, with activations handed to the next stage via a
single-hop ``ppermute`` per tick.  With M microbatches and S stages the
schedule takes M + S − 1 ticks and every device is busy in the steady
state — bubble fraction (S−1)/(M+S−1), exactly GPipe's.

Design constraints that make this XLA-friendly:

* every stage maps the same "wire" pytree to itself (pad heterogeneous
  stage signatures into one wire format — static shapes are mandatory
  under jit anyway),
* stage dispatch is a ``lax.switch`` on the device's stage index: one
  traced program for all devices (SPMD), each executing only its branch,
* the tick loop is a ``lax.fori_loop``; validity of in-flight activations
  is tracked with a boolean so warmup/drain ticks are predicated, never
  branched.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from points_matching.parallel.comm import Comm

Array = jax.Array

STAGE_AXIS = "stage"


def _zeros_like_wire(wire):
    return jax.tree.map(lambda x: jnp.zeros_like(x), wire)


def _select_wire(pred, a, b):
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)


def pipeline_stages(
    stage_fns: Sequence[Callable],
    xs,
    mesh: Optional[Mesh] = None,
    axis: str = STAGE_AXIS,
):
    """Run ``xs`` (a pytree of arrays with leading microbatch dim M) through
    ``stage_fns`` as a device pipeline over ``mesh[axis]``.

    Every ``stage_fns[s]`` must map one microbatch of the wire pytree to the
    same wire pytree (same shapes/dtypes).  Returns the wire pytree with
    leading dim M — microbatch m's output after all S stages.

    Without a mesh (or a 1-device mesh) the stages are composed sequentially
    on one device — the no-op backend, same numerics, used by unit tests and
    single-chip runs.
    """
    S = len(stage_fns)
    M = jax.tree.leaves(xs)[0].shape[0]

    def compose(x):
        for f in stage_fns:
            x = f(x)
        return x

    if mesh is None or S == 1 or axis not in mesh.shape or mesh.shape[axis] == 1:
        return lax.map(compose, xs)

    n_dev = mesh.shape[axis]
    if n_dev != S:
        raise ValueError(
            f"stage axis has {n_dev} devices but {S} stage functions were "
            "given; pad stages with identities or reshape the mesh"
        )

    wire0 = jax.tree.map(lambda x: x[0], xs)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(),),  # microbatch stream replicated; device 0 injects
        out_specs=P(),
        check_vma=False,  # outputs are psum'd to replicated below
    )
    def run(xs_rep):
        comm = Comm(axis)
        s = comm.index()
        n_ticks = M + S - 1

        def tick(t, carry):
            act, act_valid, outs, outs_valid = carry
            # device 0 injects microbatch t (if any); everyone else uses the
            # activation ppermuted from the previous stage last tick
            inject = jax.tree.map(
                lambda x: lax.dynamic_index_in_dim(
                    x, jnp.minimum(t, M - 1), keepdims=False
                ),
                xs_rep,
            )
            is_first = s == 0
            take_inject = is_first & (t < M)
            x_in = _select_wire(take_inject, inject, act)
            in_valid = jnp.where(is_first, t < M, act_valid)

            y = lax.switch(s, list(stage_fns), x_in)

            # the last stage retires microbatch m = t - (S - 1)
            m_out = t - (S - 1)
            is_last = s == S - 1
            write = is_last & in_valid & (m_out >= 0)
            idx = jnp.clip(m_out, 0, M - 1)
            outs = jax.tree.map(
                lambda o, v: lax.dynamic_update_index_in_dim(
                    o,
                    jnp.where(
                        write,
                        v,
                        lax.dynamic_index_in_dim(o, idx, keepdims=False),
                    ),
                    idx,
                    axis=0,
                ),
                outs,
                y,
            )
            outs_valid = outs_valid.at[idx].set(
                jnp.where(write, True, outs_valid[idx])
            )

            # hand the activation to the next stage (ring hop; the wrap-around
            # edge S-1 → 0 carries garbage that the validity bit kills)
            act = comm.ring_shift(y, 1)
            act_valid = comm.ring_shift(in_valid, 1) & (s != 0)
            return act, act_valid, outs, outs_valid

        act0 = _zeros_like_wire(wire0)
        outs0 = jax.tree.map(
            lambda x: jnp.zeros((M,) + x.shape, x.dtype), wire0
        )
        carry = (act0, jnp.asarray(False), outs0, jnp.zeros((M,), bool))
        _, _, outs, outs_valid = lax.fori_loop(0, n_ticks, tick, carry)

        # only the last stage holds real outputs; psum replicates them
        outs = jax.tree.map(
            lambda o: comm.psum(jnp.where(s == S - 1, 1.0, 0.0).astype(o.dtype) * o
                                if jnp.issubdtype(o.dtype, jnp.inexact)
                                else jnp.where(s == S - 1, o, jnp.zeros_like(o))),
            outs,
        )
        return outs

    return run(xs)
