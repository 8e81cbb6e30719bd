"""Pose recovery from the essential matrix (BASELINE config 2; the
reference demo stops at F — this is the extension the north-star mandates).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import Array

from points_matching.core.precision import f32_matmuls
from points_matching.core.types import Pose
from points_matching.geometry.eigen import svd3_rotational
from points_matching.geometry.triangulate import triangulate_dlt


@f32_matmuls
def decompose_essential(E: Array) -> Tuple[Array, Array, Array]:
    """Decompose E into the 4 (R, t) candidates.

    Returns (R [..., 2, 3, 3], t [..., 2, 3]) stacked as R ∈ {Ra, Rb} and
    t ∈ {+u3, -u3}; the four combinations are the candidate poses.
    """
    # Static-control-flow 3×3 SVD with det(U) = det(V) = +1 by construction
    # (geometry/eigen.py) — the determinant fix LAPACK-based code needs is
    # built into the factorization here.
    U, _, Vt = svd3_rotational(E)

    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    Ra = U @ W @ Vt
    Rb = U @ jnp.swapaxes(W, -1, -2) @ Vt
    u3 = U[..., :, 2]
    R = jnp.stack([Ra, Rb], axis=-3)
    t = jnp.stack([u3, -u3], axis=-2)
    return R, t, u3


@f32_matmuls
def recover_pose(
    E: Array,
    p1_norm: Array,
    p2_norm: Array,
    weights: Array,
) -> Tuple[Pose, Array, Array]:
    """Select the (R, t) candidate with the most points in front of both
    cameras (cheirality test) — ``cv::recoverPose`` equivalent.

    Args:
      E:        [3, 3] essential matrix.
      p1_norm:  [N, 2] normalized camera coords in view 1.
      p2_norm:  [N, 2] normalized camera coords in view 2.
      weights:  [N] validity mask for the correspondences.

    Returns:
      (pose (world=cam1 → cam2), X [N, 3] triangulated points in cam-1
      frame for the winning candidate, cheirality_mask [N]).
    """
    R2, t2, _ = decompose_essential(E)  # [2,3,3], [2,3]

    eye34 = jnp.concatenate([jnp.eye(3, dtype=E.dtype), jnp.zeros((3, 1), E.dtype)], axis=-1)

    def score(Ri, ti):
        P2 = jnp.concatenate([Ri, ti[:, None]], axis=-1)
        X, ok = triangulate_dlt(eye34, P2, p1_norm, p2_norm)
        good = jnp.logical_and(ok, weights > 0)
        return jnp.sum(good.astype(jnp.int32)), X, good

    # 4 candidates: (Ra,+t), (Ra,-t), (Rb,+t), (Rb,-t)
    Rs = jnp.stack([R2[0], R2[0], R2[1], R2[1]], axis=0)
    ts = jnp.stack([t2[0], t2[1], t2[0], t2[1]], axis=0)
    counts, Xs, goods = jax.vmap(score)(Rs, ts)

    best = jnp.argmax(counts)
    pose = Pose(R=Rs[best], t=ts[best])
    return pose, Xs[best], goods[best]
