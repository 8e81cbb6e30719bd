"""Levenberg-Marquardt bundle adjustment driver (SURVEY.md §7 stage 6;
BASELINE: "Schur-complement bundle adjustment ... BA iterations/sec ≥70%
of roofline").

The whole LM loop is a ``lax.while_loop`` inside one jit region: residual +
Jacobian evaluation (elementwise), normal-equation assembly and Schur reduction
(einsums), damped solve, and accept/reject logic as ``lax.cond``-free
masked updates — no host round-trips per iteration.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from points_matching.core import struct
from jax import Array

from points_matching.core.precision import f32_matmuls
from points_matching.ba.residuals import (
    huber_weights,
    reprojection_residuals,
    residuals_and_jacobians,
)
from points_matching.ba.schur import (
    build_normal_equations,
    solve_schur,
    solve_schur_pcg,
)
from points_matching.core.config import BAConfig
from points_matching.core.types import CameraIntrinsics, Pose
from points_matching.geometry.se3 import se3_exp


@struct.dataclass
class BAState:
    """Bundle-adjustment problem state on the dense [C, L] grid."""

    poses: Pose               # [C] world→camera
    X: Array                  # [L, 3]
    uv: Array                 # [C, L, 2] measurements
    mask: Array               # [C, L] observation validity
    cam_fixed: Array          # [C] bool — gauge-fixed cameras (no update)

    @property
    def num_cameras(self) -> int:
        return self.X.shape[0] if False else self.poses.t.shape[0]

    @property
    def num_landmarks(self) -> int:
        return self.X.shape[0]


def make_ba_state(
    poses: Pose,
    X: Array,
    uv: Array,
    mask: Array,
    num_fixed_cameras: int = 1,
) -> BAState:
    """Fix the first ``num_fixed_cameras`` poses to remove the gauge freedom
    (all-free BA is rank-deficient; LM damping alone leaves the gauge
    drifting)."""
    C = poses.t.shape[0]
    return BAState(
        poses=poses,
        X=X,
        uv=uv,
        mask=mask,
        cam_fixed=jnp.arange(C) < num_fixed_cameras,
    )


def ba_cost(state: BAState, K: CameraIntrinsics, huber_delta: float = 0.0) -> Array:
    """Total (optionally Huber-robustified) reprojection cost."""
    r = reprojection_residuals(state.poses, state.X, state.uv, state.mask, K)
    if huber_delta > 0:
        n = jnp.linalg.norm(r, axis=-1)
        quad = 0.5 * n**2
        lin = huber_delta * (n - 0.5 * huber_delta)
        per = jnp.where(n <= huber_delta, quad, lin)
    else:
        per = 0.5 * jnp.sum(r * r, axis=-1)
    return jnp.sum(jnp.where(state.mask, per, 0.0))


def _apply_update(state: BAState, dc: Array, dl: Array) -> BAState:
    """Left-multiplicative retraction of pose deltas + landmark addition,
    with gauge-fixed cameras masked out."""
    dc = jnp.where(state.cam_fixed[:, None], 0.0, dc)
    Rd, td = se3_exp(dc)
    newR = Rd @ state.poses.R
    newt = jnp.einsum("cij,cj->ci", Rd, state.poses.t) + td
    return state.replace(poses=Pose(R=newR, t=newt), X=state.X + dl)


class LMStats(NamedTuple):
    iterations: Array
    initial_cost: Array
    final_cost: Array
    lam: Array


@partial(jax.jit, static_argnames=("config",))
@f32_matmuls
def bundle_adjust(
    state: BAState,
    K: CameraIntrinsics,
    config: BAConfig = BAConfig(),
) -> Tuple[BAState, LMStats]:
    """Run LM to convergence (or ``config.max_iterations``).

    Returns (optimized state, stats).  Cost is monotonically non-increasing:
    rejected steps keep the previous state and raise the damping.
    """
    cost0 = ba_cost(state, K, config.huber_delta)

    def step(carry):
        state, lam, cost, it, done = carry
        r, Jc, Jl = residuals_and_jacobians(
            state.poses, state.X, state.uv, state.mask, K
        )
        w = huber_weights(r, config.huber_delta) * state.mask.astype(r.dtype)
        blocks = build_normal_equations(r, Jc, Jl, w)
        if config.solver == "pcg":
            dc, dl = solve_schur_pcg(blocks, lam, config.pcg_iterations)
        else:
            dc, dl = solve_schur(blocks, lam)

        new_state = _apply_update(state, dc, dl)
        new_cost = ba_cost(new_state, K, config.huber_delta)
        accept = new_cost < cost

        state = jax.tree.map(
            lambda a, b: jnp.where(accept, a, b), new_state, state
        )
        cost_next = jnp.where(accept, new_cost, cost)
        lam = jnp.where(accept, lam * config.damping_down, lam * config.damping_up)
        lam = jnp.clip(lam, 1e-10, 1e6)
        rel = jnp.abs(cost - cost_next) / jnp.maximum(cost, 1e-12)
        done = jnp.logical_and(accept, rel < config.rtol)
        return state, lam, cost_next, it + 1, done

    def cond(carry):
        _, _, _, it, done = carry
        return jnp.logical_and(it < config.max_iterations, jnp.logical_not(done))

    lam0 = jnp.asarray(config.damping_init, jnp.float32)
    state, lam, cost, it, _ = jax.lax.while_loop(
        cond, step, (state, lam0, cost0, jnp.asarray(0), jnp.asarray(False))
    )
    return state, LMStats(iterations=it, initial_cost=cost0, final_cost=cost, lam=lam)


def grid_from_obs(
    cam_idx: Array,
    lm_idx: Array,
    uv: Array,
    obs_mask: Array,
    num_cameras: int,
    num_landmarks: int,
) -> Tuple[Array, Array]:
    """Convert a flattened ``Observations`` list to the dense [C, L] grid
    (last write wins for duplicate (c, l) pairs; invalid entries land in a
    scratch cell and are dropped)."""
    C, L = num_cameras, num_landmarks
    uv_grid = jnp.zeros((C + 1, L + 1, 2), uv.dtype)
    m_grid = jnp.zeros((C + 1, L + 1), bool)
    c = jnp.where(obs_mask, cam_idx, C)
    l = jnp.where(obs_mask, lm_idx, L)
    uv_grid = uv_grid.at[c, l].set(uv)
    m_grid = m_grid.at[c, l].set(obs_mask)
    return uv_grid[:C, :L], m_grid[:C, :L]
