"""Core pytree types for the SLAM/SfM engine.

Every container here follows the *static-shape + validity-mask* discipline:
XLA traces once per shape, so data-dependent counts (how many keypoints
were detected, how many matches survived a filter, how many RANSAC inliers)
are represented as fixed-capacity arrays plus a boolean/float mask.  This is
the accelerator replacement for the reference's dynamically-sized
``std::vector<KeyPoint>`` / ``std::vector<DMatch>`` containers
(reference: ``Points Matching/main.cpp:24,45,62``).

All types are ``core.struct`` dataclasses, i.e. registered JAX pytrees —
they can be passed through ``jit``/``vmap``/``shard_map`` and sharded with
``jax.sharding.NamedSharding`` directly.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from points_matching.core import struct

Array = jax.Array


@struct.dataclass
class Keypoints:
    """Fixed-capacity set of 2D keypoints.

    Replaces OpenCV ``vector<KeyPoint>`` (reference ``main.cpp:24``).

    Attributes:
      xy:    [N, 2] float32 — (x, y) pixel coordinates (x = column).
      scale: [N]    float32 — detection scale (sigma, pixels).
      angle: [N]    float32 — orientation in radians ([-pi, pi); 0 if upright).
      score: [N]    float32 — detector response (Hessian / Harris / FAST score).
      mask:  [N]    bool    — True for valid entries; padded slots are False.
    """

    xy: Array
    scale: Array
    angle: Array
    score: Array
    mask: Array

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]

    @property
    def count(self) -> Array:
        return jnp.sum(self.mask.astype(jnp.int32), axis=-1)

    @classmethod
    def empty(cls, capacity: int, dtype=jnp.float32) -> "Keypoints":
        return cls(
            xy=jnp.zeros((capacity, 2), dtype),
            scale=jnp.ones((capacity,), dtype),
            angle=jnp.zeros((capacity,), dtype),
            score=jnp.zeros((capacity,), dtype),
            mask=jnp.zeros((capacity,), bool),
        )


@struct.dataclass
class Descriptors:
    """Fixed-capacity descriptor set.

    Replaces OpenCV ``Mat imageDesc`` (reference ``main.cpp:38``).
    Float descriptors (SURF-class) are L2-normalized rows; binary descriptors
    (ORB-class) are bit-packed into uint32 words.

    Attributes:
      data: [N, D] float32 (float descriptors) or [N, W] uint32 (packed bits).
      mask: [N] bool.
      binary: static marker — True if ``data`` holds packed bits.
    """

    data: Array
    mask: Array
    binary: bool = struct.field(pytree_node=False, default=False)

    @property
    def capacity(self) -> int:
        return self.data.shape[-2]

    @property
    def dim(self) -> int:
        return self.data.shape[-1]


@struct.dataclass
class Matches:
    """Fixed-capacity correspondence set between two keypoint sets.

    Replaces OpenCV ``vector<DMatch>`` (reference ``main.cpp:45``).
    Entry i matches query index ``query_idx[i]`` to train index
    ``train_idx[i]`` with descriptor distance ``distance[i]``.

    Attributes:
      query_idx: [M] int32 — index into the query (image-1) keypoints.
      train_idx: [M] int32 — index into the train (image-2) keypoints.
      distance:  [M] float32 — descriptor distance (L2 or Hamming).
      mask:      [M] bool.
    """

    query_idx: Array
    train_idx: Array
    distance: Array
    mask: Array

    @property
    def capacity(self) -> int:
        return self.query_idx.shape[-1]

    @property
    def count(self) -> Array:
        return jnp.sum(self.mask.astype(jnp.int32), axis=-1)

    def gather_points(self, kps1: Keypoints, kps2: Keypoints):
        """Return ([M,2], [M,2]) matched point arrays (padded rows are junk;
        use ``self.mask``). Replaces ``KeyPoint::convert`` with index lists
        (reference ``main.cpp:89-91``)."""
        p1 = jnp.take(kps1.xy, jnp.clip(self.query_idx, 0, kps1.capacity - 1), axis=0)
        p2 = jnp.take(kps2.xy, jnp.clip(self.train_idx, 0, kps2.capacity - 1), axis=0)
        return p1, p2


@struct.dataclass
class CameraIntrinsics:
    """Pinhole intrinsics.

    Attributes:
      fx, fy, cx, cy: scalars (float32).
    """

    fx: Array
    fy: Array
    cx: Array
    cy: Array

    @classmethod
    def from_matrix(cls, K: Array) -> "CameraIntrinsics":
        return cls(fx=K[..., 0, 0], fy=K[..., 1, 1], cx=K[..., 0, 2], cy=K[..., 1, 2])

    def matrix(self) -> Array:
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        rows = [
            jnp.stack([self.fx, z, self.cx], axis=-1),
            jnp.stack([z, self.fy, self.cy], axis=-1),
            jnp.stack([z, z, o], axis=-1),
        ]
        return jnp.stack(rows, axis=-2)

    def normalize_points(self, xy: Array) -> Array:
        """Pixel → normalized camera coordinates."""
        f = jnp.stack([self.fx, self.fy], axis=-1)
        c = jnp.stack([self.cx, self.cy], axis=-1)
        return (xy - c) / f

    def project(self, xyz_cam: Array, eps: float = 1e-9) -> Array:
        """Camera-frame 3D points → pixel coordinates."""
        z = xyz_cam[..., 2:3]
        uv = xyz_cam[..., :2] / jnp.where(jnp.abs(z) < eps, eps, z)
        f = jnp.stack([self.fx, self.fy], axis=-1)
        c = jnp.stack([self.cx, self.cy], axis=-1)
        return uv * f + c


@struct.dataclass
class Pose:
    """SE(3) world→camera transform: x_cam = R @ x_world + t.

    Attributes:
      R: [..., 3, 3] rotation.
      t: [..., 3] translation.
    """

    R: Array
    t: Array

    @classmethod
    def identity(cls, batch: tuple = (), dtype=jnp.float32) -> "Pose":
        R = jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch + (3, 3))
        t = jnp.zeros(batch + (3,), dtype)
        return cls(R=R, t=t)

    def compose(self, other: "Pose") -> "Pose":
        """self ∘ other: apply ``other`` first, then ``self``."""
        return Pose(
            R=self.R @ other.R,
            t=jnp.einsum("...ij,...j->...i", self.R, other.t) + self.t,
        )

    def inverse(self) -> "Pose":
        Rt = jnp.swapaxes(self.R, -1, -2)
        return Pose(R=Rt, t=-jnp.einsum("...ij,...j->...i", Rt, self.t))

    def transform(self, xyz: Array) -> Array:
        return jnp.einsum("...ij,...j->...i", self.R, xyz) + self.t

    def matrix34(self) -> Array:
        return jnp.concatenate([self.R, self.t[..., :, None]], axis=-1)


@struct.dataclass
class Landmarks:
    """Fixed-capacity 3D map points.

    Attributes:
      xyz:   [L, 3] float32 world coordinates.
      mask:  [L] bool — valid landmarks.
    """

    xyz: Array
    mask: Array

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @classmethod
    def empty(cls, capacity: int, dtype=jnp.float32) -> "Landmarks":
        return cls(xyz=jnp.zeros((capacity, 3), dtype), mask=jnp.zeros((capacity,), bool))


@struct.dataclass
class Observations:
    """Fixed-capacity reprojection-observation list for bundle adjustment.

    Each entry links camera ``cam_idx[k]`` and landmark ``lm_idx[k]`` to a
    measured pixel ``uv[k]``.  This is the block-sparse Jacobian structure
    flattened into dense, segment-summable tensors.

    Attributes:
      cam_idx: [K] int32.
      lm_idx:  [K] int32.
      uv:      [K, 2] float32 measured pixel coordinates.
      mask:    [K] bool.
    """

    cam_idx: Array
    lm_idx: Array
    uv: Array
    mask: Array

    @property
    def capacity(self) -> int:
        return self.cam_idx.shape[-1]


@struct.dataclass
class TwoViewEstimate:
    """Result of two-view geometry estimation (the reference's end product,
    extended with RANSAC statistics; reference ``main.cpp:95-123``).

    Attributes:
      F:            [3, 3] fundamental matrix (rank 2, Frobenius-normalized).
      inlier_mask:  [M] bool over the match list used for estimation.
      num_inliers:  scalar int32.
      residual_mean: scalar float32 — mean |p2ᵀ F p1| over inliers (the
                     reference's audit statistic, ``main.cpp:123``).
    """

    F: Array
    inlier_mask: Array
    num_inliers: Array
    residual_mean: Array
