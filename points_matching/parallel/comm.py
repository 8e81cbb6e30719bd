"""Thin communication wrapper over XLA collectives — the framework's
"NCCL layer" (SURVEY.md §2.3 P6; the reference has no distributed code at
all, so this is a from-scratch design).

Why a wrapper instead of raw ``lax.psum`` calls: (a) a single-device no-op
backend lets every distributed code path run un-sharded in unit tests
(SURVEY.md §4, "comm abstraction with a single-device no-op backend");
(b) a fault-injection hook can perturb or drop a collective in tests
(SURVEY.md §5, failure detection); (c) collectives are named/centralized
for tracing and roofline accounting.

On a GPU host XLA hands the collectives to NCCL over NVLink within a host
and the network across hosts — that routing is XLA's job; ours is to keep
the axis layout such that the heavy reductions (Schur blocks, match scores)
stay within a host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import jax
import jax.numpy as jnp
from jax import lax

Array = jax.Array

# Fault-injection hook: fn(name, value) -> value, applied to every
# collective's *input*.  Tests install e.g. a perturbation for one axis to
# emulate a flaky link; production leaves it None.
_FAULT_HOOK: Optional[Callable[[str, Array], Array]] = None


def set_fault_hook(hook: Optional[Callable[[str, Array], Array]]) -> None:
    global _FAULT_HOOK
    _FAULT_HOOK = hook


def _maybe_inject(name: str, x):
    if _FAULT_HOOK is None:
        return x
    return jax.tree.map(lambda v: _FAULT_HOOK(name, v), x)


@dataclasses.dataclass(frozen=True)
class Comm:
    """Collectives bound to a mesh axis name.

    ``axis=None`` is the no-op single-device backend: psum/all_gather etc.
    become identities, so the same model code runs with or without a mesh.
    """

    axis: Optional[str] = None

    # -- introspection ----------------------------------------------------
    def index(self) -> Array:
        if self.axis is None:
            return jnp.asarray(0, jnp.int32)
        return lax.axis_index(self.axis)

    def size(self) -> int:
        if self.axis is None:
            return 1
        return lax.axis_size(self.axis)

    # -- reductions -------------------------------------------------------
    def psum(self, x):
        if self.axis is None:
            return x
        return lax.psum(_maybe_inject("psum", x), self.axis)

    def pmean(self, x):
        if self.axis is None:
            return x
        return lax.pmean(_maybe_inject("pmean", x), self.axis)

    def pmax(self, x):
        if self.axis is None:
            return x
        return lax.pmax(_maybe_inject("pmax", x), self.axis)

    def pmin(self, x):
        if self.axis is None:
            return x
        return lax.pmin(_maybe_inject("pmin", x), self.axis)

    # -- data movement ----------------------------------------------------
    def all_gather(self, x, axis: int = 0, tiled: bool = False):
        if self.axis is None:
            return x if tiled else jax.tree.map(lambda v: v[None], x)
        return lax.all_gather(
            _maybe_inject("all_gather", x), self.axis, axis=axis, tiled=tiled
        )

    def reduce_scatter(self, x, axis: int = 0):
        if self.axis is None:
            return x
        return lax.psum_scatter(
            _maybe_inject("reduce_scatter", x), self.axis,
            scatter_dimension=axis, tiled=True,
        )

    def all_to_all(self, x, split_axis: int, concat_axis: int):
        if self.axis is None:
            return x
        return lax.all_to_all(
            _maybe_inject("all_to_all", x), self.axis, split_axis, concat_axis,
            tiled=True,
        )

    def ppermute(self, x, perm: Sequence[tuple]):
        if self.axis is None:
            return x
        return lax.ppermute(_maybe_inject("ppermute", x), self.axis, perm=perm)

    def ring_shift(self, x, shift: int = 1):
        """Send to the neighbor ``shift`` steps clockwise on the ring —
        the halo/covisibility exchange primitive (SURVEY.md §5 long-context
        analogue; maps onto neighbor ppermute)."""
        if self.axis is None:
            return x
        n = lax.axis_size(self.axis)
        perm = [(i, (i + shift) % n) for i in range(n)]
        return self.ppermute(x, perm)
