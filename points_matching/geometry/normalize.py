"""Hartley normalization — the numerical backbone of the 8-point solver.

OpenCV's ``cvFindFundamentalMat`` normalizes internally (the implicit native
component N4 in SURVEY.md §2.2); in f32 this step is what keeps
the 9×9 eigen-solve well-conditioned, so it is explicit and mask-aware here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
from jax import Array


def hartley_normalize(
    pts: Array, weights: Optional[Array] = None, eps: float = 1e-9
) -> Tuple[Array, Array]:
    """Translate the (weighted) centroid to the origin and scale so the mean
    distance from the origin is sqrt(2).

    Args:
      pts:     [..., N, 2] points.
      weights: [..., N] optional non-negative weights (a validity mask may be
               passed directly); None → all-ones.

    Returns:
      (pts_norm [..., N, 2], T [..., 3, 3]) with
      ``pts_norm_h = (T @ pts_h)`` for homogeneous points.
    """
    if weights is None:
        weights = jnp.ones(pts.shape[:-1], pts.dtype)
    w = weights.astype(pts.dtype)
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), eps)

    centroid = jnp.sum(pts * w[..., None], axis=-2, keepdims=True) / wsum[..., None]
    centered = pts - centroid
    dist = jnp.linalg.norm(centered, axis=-1)
    mean_dist = jnp.sum(dist * w, axis=-1, keepdims=True) / wsum
    scale = jnp.sqrt(jnp.asarray(2.0, pts.dtype)) / jnp.maximum(mean_dist, eps)

    pts_norm = centered * scale[..., None]

    s = scale[..., 0]
    cx = centroid[..., 0, 0]
    cy = centroid[..., 0, 1]
    z = jnp.zeros_like(s)
    o = jnp.ones_like(s)
    T = jnp.stack(
        [
            jnp.stack([s, z, -s * cx], axis=-1),
            jnp.stack([z, s, -s * cy], axis=-1),
            jnp.stack([z, z, o], axis=-1),
        ],
        axis=-2,
    )
    return pts_norm, T
