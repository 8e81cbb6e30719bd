"""SO(3)/SE(3) exponential and logarithm maps — batched, f32-safe, and
**differentiable at the identity**.

The optimization layers (bundle adjustment, pose-graph) parameterize pose
updates in the tangent space, retract with these maps, and take exact
Jacobians via ``jax.jacfwd`` *at ξ = 0* — so θ = 0 is not an edge case, it
is the linearization point of every Gauss-Newton step.  A naive
``norm(w)``/``arccos`` formulation has NaN tangents there (d‖w‖/dw = w/‖w‖);
``jnp.where`` does not save you, because the *untaken* branch still
propagates NaN through the chain rule.  The discipline used throughout:

  1. compute the smooth quantity θ² = Σw² (polynomial — clean tangents),
  2. express each trig coefficient as a function of θ² with a Taylor branch,
  3. substitute a SAFE dummy value into the non-smooth op (sqrt, arccos,
     division) for the branch that is not taken, so its NaN tangent never
     exists in the first place.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
from jax import Array

from points_matching.geometry.homogeneous import skew

_EPS = 1e-8
_SMALL_T2 = 1e-8  # θ² switch point: θ < 1e-4


def _coefficients(t2: Array) -> Tuple[Array, Array, Array]:
    """(A, B, C) = (sinθ/θ, (1−cosθ)/θ², (1−sinθ/θ)/θ²) from θ² with
    Taylor branches; all smooth in θ² and NaN-free under differentiation."""
    small = t2 < _SMALL_T2
    t2_safe = jnp.where(small, jnp.ones_like(t2), t2)
    theta = jnp.sqrt(t2_safe)
    A = jnp.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0, jnp.sin(theta) / theta)
    B = jnp.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0, (1.0 - jnp.cos(theta)) / t2_safe)
    C = jnp.where(small, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0, (1.0 - A) / t2_safe)
    return A, B, C


def so3_exp(w: Array) -> Array:
    """Rodrigues: [..., 3] axis-angle → [..., 3, 3] rotation."""
    t2 = jnp.sum(w * w, axis=-1)
    A, B, _ = _coefficients(t2)
    W = skew(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * W2


def so3_log(R: Array) -> Array:
    """[..., 3, 3] rotation → [..., 3] axis-angle (|w| ≤ pi).

    Differentiable at the identity (the small-angle branch is a polynomial
    in the smooth quantity ‖vee(R−Rᵀ)/2‖² = sin²θ).
    """
    trace = jnp.trace(R, axis1=-2, axis2=-1)
    cos_theta = jnp.clip((trace - 1.0) / 2.0, -1.0, 1.0)
    # vee(R - Rᵀ)/2 = sin(θ)·axis — smooth in R
    v = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    ) * 0.5
    s2 = jnp.sum(v * v, axis=-1)  # sin²θ, smooth

    small = cos_theta > 1.0 - 1e-6      # θ ≲ 1.4e-3
    near_pi = cos_theta < -1.0 + 1e-5   # θ ≈ π

    # General branch: θ/sinθ with safe inputs for the other branches.
    cos_safe = jnp.where(jnp.logical_or(small, near_pi), 0.0, cos_theta)
    theta_g = jnp.arccos(cos_safe)
    # cos_safe is bounded away from ±1 (other branches got the dummy 0), so
    # 1−cos² ≥ ~2e-6 here; the floor is only a NaN guard for the tangents.
    sin_safe = jnp.sqrt(jnp.maximum(1.0 - cos_safe * cos_safe, 1e-12))
    w_general = v * (theta_g / sin_safe)[..., None]

    # Small branch: sinθ ≈ θ ⇒ w ≈ v·(1 + sin²θ/6) (series of θ/sinθ in s2).
    w_small = v * (1.0 + s2 / 6.0)[..., None]

    # Near-π branch: vee vanishes; recover axis from the diagonal.
    theta_pi = jnp.arccos(jnp.where(near_pi, cos_theta, 0.0))
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    one_m_cos = jnp.maximum(1.0 - cos_theta[..., None], _EPS)
    axis_sq = jnp.clip((diag - cos_theta[..., None]) / one_m_cos, 0.0, 1.0)
    axis = jnp.sqrt(jnp.maximum(axis_sq, 1e-12))
    sign_y = jnp.where(R[..., 0, 1] + R[..., 1, 0] < 0, -1.0, 1.0)
    sign_z = jnp.where(R[..., 0, 2] + R[..., 2, 0] < 0, -1.0, 1.0)
    axis = axis * jnp.stack([jnp.ones_like(sign_y), sign_y, sign_z], axis=-1)
    w_pi = axis * theta_pi[..., None]

    out = jnp.where(small[..., None], w_small, w_general)
    return jnp.where(near_pi[..., None], w_pi, out)


def _left_jacobian(w: Array) -> Array:
    """SO(3) left Jacobian V(w): the se3_exp translation factor."""
    t2 = jnp.sum(w * w, axis=-1)
    _, B, C = _coefficients(t2)
    W = skew(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + B[..., None, None] * W + C[..., None, None] * W2


def se3_exp(xi: Array) -> Tuple[Array, Array]:
    """[..., 6] twist (v, w) → (R [..., 3, 3], t [..., 3])."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    V = _left_jacobian(w)
    t = jnp.einsum("...ij,...j->...i", V, v)
    return R, t


def se3_log(R: Array, t: Array) -> Array:
    """(R, t) → [..., 6] twist (v, w)."""
    w = so3_log(R)
    V = _left_jacobian(w)
    v = jnp.linalg.solve(V, t[..., :, None])[..., 0]
    return jnp.concatenate([v, w], axis=-1)
