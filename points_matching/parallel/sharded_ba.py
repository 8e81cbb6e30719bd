"""Distributed bundle adjustment: landmark-sharded Schur reduction
(SURVEY.md §2.3 P2/P4, §5 "Distributed Schur": shard the landmark axis,
reduce per-block Hᵀ H contributions with one collective).

Idiom: GSPMD.  The LM loop in ``ba/lm.py`` is pure and already expresses
the Schur complement as einsums over the landmark axis; here we only
*annotate* the state's shardings (landmarks and the [C, L] observation grid
split on ``model``; poses replicated) and let XLA insert the psum for the
reduced camera system S = U − Σ_l Y_l W_lᵀ and its Cholesky on replicated
data.  Per the scaling-book recipe: pick the mesh, annotate, let the
compiler place the collectives.

The camera axis stays replicated because C ≪ L in SfM problems (hundreds of
cameras vs 10⁴-10⁶ landmarks) and the camera solve is the sequential
bottleneck; the landmark elimination — the O(C²·L) FLOPs — is what shards.
"""
from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from points_matching.ba.lm import BAState, LMStats, bundle_adjust
from points_matching.ba.sparse import (
    SparseBAState,
    SparseLMStats,
    _bundle_adjust_sparse_impl,
)
from points_matching.core.config import BAConfig
from points_matching.core.types import CameraIntrinsics, Pose
from points_matching.parallel.mesh import MODEL_AXIS


def ba_state_shardings(mesh: Mesh) -> BAState:
    """The sharding pytree for ``BAState``: landmark axis on ``model``."""
    rep = NamedSharding(mesh, P())
    lm = NamedSharding(mesh, P(MODEL_AXIS))
    grid = NamedSharding(mesh, P(None, MODEL_AXIS))
    return BAState(
        poses=Pose(R=rep, t=rep),
        X=lm,
        uv=grid,
        mask=grid,
        cam_fixed=rep,
    )


def shard_ba_state(state: BAState, mesh: Mesh) -> BAState:
    """Place a BAState onto the mesh with landmark sharding."""
    return jax.device_put(state, ba_state_shardings(mesh))


def distributed_bundle_adjust(
    state: BAState,
    K: CameraIntrinsics,
    mesh: Mesh,
    config: BAConfig = BAConfig(),
) -> Tuple[BAState, LMStats]:
    """Landmark-sharded LM bundle adjustment.

    The landmark capacity must divide the ``model`` axis size.  Inputs are
    re-placed onto the mesh if not already sharded; outputs keep the same
    shardings (X/uv/mask sharded, poses replicated).
    """
    L = state.X.shape[0]
    n_model = mesh.shape[MODEL_AXIS]
    if L % n_model != 0:
        raise ValueError(
            f"landmark capacity ({L}) must divide model axis ({n_model}); "
            "pad with masked landmarks"
        )
    state = shard_ba_state(state, mesh)
    K = jax.device_put(K, NamedSharding(mesh, P()))
    return bundle_adjust(state, K, config)


def pad_sparse_state_for_mesh(
    state: SparseBAState, n_shards: int
) -> SparseBAState:
    """Pad the observation axis to a multiple of ``n_shards`` with masked
    rows (zero weight ⇒ zero normal-equation contribution — exact)."""
    O = state.num_observations
    rem = (-O) % n_shards
    if rem == 0:
        return state
    padi = lambda a: jnp.concatenate(
        [a, jnp.zeros((rem,) + a.shape[1:], a.dtype)], axis=0
    )
    return state.replace(
        cam_idx=padi(state.cam_idx),
        lm_idx=padi(state.lm_idx),
        uv=padi(state.uv),
        obs_mask=padi(state.obs_mask),
    )


def distributed_bundle_adjust_sparse(
    state: SparseBAState,
    K: CameraIntrinsics,
    mesh: Mesh,
    config: BAConfig = BAConfig(),
    axis: str = MODEL_AXIS,
) -> Tuple[SparseBAState, SparseLMStats]:
    """Observation-sharded sparse LM bundle adjustment.

    The plan promised in ``ba/sparse.py``'s docstring, realized: the flat
    ``[O]`` observation arrays are split on the ``axis`` mesh axis under
    ``shard_map``; poses/landmarks stay replicated; every segment_sum in
    assembly, implicit-Schur matvec, preconditioner and back-substitution
    reduces locally and ``psum``s to global.  This is the path that scales
    to BASELINE-size problems (10⁴–10⁶ landmarks) where the dense ``[C, L]``
    grid of ``distributed_bundle_adjust`` cannot exist.  Communication per
    LM iteration: the O(C·36 + L·9) block psums in assembly + two
    O(L·3 / C·6) psums per PCG iteration — no observation data
    ever moves.
    """
    n = mesh.shape[axis]
    state = pad_sparse_state_for_mesh(state, n)
    return _sharded_sparse_ba_fn(mesh, config, axis)(state, K)


@lru_cache(maxsize=32)
def _sharded_sparse_ba_fn(mesh: Mesh, config: BAConfig, axis: str):
    """Memoized jitted shard_map program for the sparse distributed BA.

    Without the cache, every ``distributed_bundle_adjust_sparse`` call
    built a fresh lambda → fresh ``jax.jit`` → FULL RECOMPILE per call
    (measured: the r3 scaling harness timed ~2.7 s/call of which nearly
    all was compilation — the reported 'anti-scaling' was recompile cost,
    not the sharded program).  Mesh/BAConfig are hashable, so the compiled
    executable is reused across calls of matching shapes."""
    obs = P(axis)
    rep = P()
    in_state_specs = SparseBAState(
        poses=Pose(R=rep, t=rep),
        X=rep,
        cam_idx=obs,
        lm_idx=obs,
        uv=obs,
        obs_mask=obs,
        cam_fixed=rep,
        lm_fixed=rep,
    )
    out_state_specs = in_state_specs
    stats_specs = SparseLMStats(
        iterations=rep, initial_cost=rep, final_cost=rep, lam=rep
    )
    K_specs = CameraIntrinsics(fx=rep, fy=rep, cx=rep, cy=rep)

    fn = partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(in_state_specs, K_specs),
        out_specs=(out_state_specs, stats_specs),
        check_vma=False,  # replicated outputs are psum-derived on every shard
    )(lambda st, k: _bundle_adjust_sparse_impl(st, k, config, axis_name=axis))
    return jax.jit(fn)
