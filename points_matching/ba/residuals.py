"""Reprojection residuals + Jacobians for bundle adjustment.

Layout choice (SURVEY.md §7 'sparse BA on dense hardware'):
observations live on a dense ``[C, L]`` camera×landmark grid with a validity
mask.  Block-sparse Jacobian structure then becomes dense einsums — the
Schur reduction is matmul work, the residual/Jacobian evaluation is elementwise work,
and there is no scatter/gather in the hot loop.  (The flattened
``Observations`` list converts to this grid; see ``ba.lm.grid_from_obs``.)

Jacobians are exact: forward-mode JVPs of the residual at zero tangent
(left-multiplicative SE(3) perturbation for poses), vmapped over the grid —
no finite differences, no hand-derived chain rules to get wrong.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import Array

from points_matching.core.types import CameraIntrinsics, Pose
from points_matching.geometry.se3 import se3_exp


def _project(K: CameraIntrinsics, x_cam: Array, eps: float = 1e-6) -> Array:
    z = jnp.maximum(x_cam[..., 2:3], eps)  # BA keeps points in front; clamp guards
    uv = x_cam[..., :2] / z
    f = jnp.stack([K.fx, K.fy], axis=-1)
    c = jnp.stack([K.cx, K.cy], axis=-1)
    return uv * f + c


def _residual_one(
    delta_pose: Array,   # [6] tangent (v, w), evaluated at 0
    delta_lm: Array,     # [3]
    R: Array,            # [3, 3]
    t: Array,            # [3]
    X: Array,            # [3]
    uv: Array,           # [2]
    K: CameraIntrinsics,
) -> Array:
    Rd, td = se3_exp(delta_pose)
    Rn = Rd @ R
    tn = Rd @ t + td
    Xn = X + delta_lm
    return _project(K, Rn @ Xn + tn) - uv


def reprojection_residuals(
    poses: Pose, X: Array, uv: Array, mask: Array, K: CameraIntrinsics
) -> Array:
    """Masked residuals on the [C, L] grid → [C, L, 2] (invalid → 0)."""
    x_cam = jnp.einsum("cij,lj->cli", poses.R, X) + poses.t[:, None, :]
    r = _project(K, x_cam) - uv
    return jnp.where(mask[..., None], r, 0.0)


def residuals_and_jacobians(
    poses: Pose, X: Array, uv: Array, mask: Array, K: CameraIntrinsics
) -> Tuple[Array, Array, Array]:
    """Residuals and per-observation Jacobians on the grid.

    Returns:
      r:  [C, L, 2]   masked residuals.
      Jc: [C, L, 2, 6] ∂r/∂(pose tangent).
      Jl: [C, L, 2, 3] ∂r/∂(landmark).
    """
    z6 = jnp.zeros((6,), X.dtype)
    z3 = jnp.zeros((3,), X.dtype)

    def one(R, t, Xl, uvi):
        f = lambda dp, dl: _residual_one(dp, dl, R, t, Xl, uvi, K)
        r = f(z6, z3)
        Jc = jax.jacfwd(f, argnums=0)(z6, z3)
        Jl = jax.jacfwd(f, argnums=1)(z6, z3)
        return r, Jc, Jl

    over_l = jax.vmap(one, in_axes=(None, None, 0, 0))
    over_cl = jax.vmap(over_l, in_axes=(0, 0, None, 0))
    r, Jc, Jl = over_cl(poses.R, poses.t, X, uv)

    m = mask[..., None]
    r = jnp.where(m, r, 0.0)
    Jc = jnp.where(m[..., None], Jc, 0.0)
    Jl = jnp.where(m[..., None], Jl, 0.0)
    return r, Jc, Jl


def huber_weights(r: Array, delta: float) -> Array:
    """IRLS weights for the Huber loss on per-observation L2 norms.

    delta <= 0 disables robustification (returns ones).  [C, L]."""
    if delta <= 0:
        return jnp.ones(r.shape[:-1], r.dtype)
    norm = jnp.linalg.norm(r, axis=-1)
    return jnp.where(norm <= delta, 1.0, delta / jnp.maximum(norm, 1e-12))
