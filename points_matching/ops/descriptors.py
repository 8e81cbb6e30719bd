"""Device-resident descriptor extraction (implicit native component N2,
SURVEY.md §2.2 — replaces ``cv::SurfDescriptorExtractor``, demo call site
``Points Matching/main.cpp:37-40``).

Two families:
  * ``surf``: 64-dim float, unit-norm — a 4×4 grid of (Σdx, Σdy, Σ|dx|,
    Σ|dy|) Haar-type responses in an oriented, scale-adaptive window, as in
    Bay et al.; on an accelerator the per-keypoint integral-image box
    filters become a single batched bilinear-gather + difference over a
    fixed 20×20 lattice (dense [N, 400, 4]-tap tensor math — no
    data-dependent code).
  * ``orb``: 256-bit binary (BRIEF pairs steered by keypoint angle), packed
    into 8 uint32 words for popcount-Hamming matching.

Padded (masked-out) keypoints produce zero descriptors with mask=False.
"""
from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from points_matching.core.config import DescriptorConfig
from points_matching.core.types import Descriptors, Keypoints
from points_matching.ops.detect import gaussian_blur
from points_matching.ops.sampling import bilinear_sample


# ---------------------------------------------------------------------------
# SURF-class 64-d float descriptor
# ---------------------------------------------------------------------------

_GRID = 20  # 20×20 sample lattice → 4×4 cells of 5×5 samples
_EXT = _GRID + 2  # extended lattice: the Haar taps of every inner sample


def _surf_lattice() -> Tuple[Array, Array]:
    """Sample offsets in the canonical (unrotated, unit-scale) frame and the
    SURF Gaussian weights (σ = 3.3 in lattice units of s)."""
    step = 1.0
    coords = (jnp.arange(_GRID, dtype=jnp.float32) - (_GRID - 1) / 2.0) * step
    oy, ox = jnp.meshgrid(coords, coords, indexing="ij")
    offs = jnp.stack([ox, oy], axis=-1).reshape(-1, 2)  # [400, 2]
    w = jnp.exp(-0.5 * (offs[:, 0] ** 2 + offs[:, 1] ** 2) / 3.3**2)
    return offs, w


def _surf_lattice_ext() -> Array:
    """22×22 extended lattice: the Haar taps p ± s·ux / p ± s·uy of every
    20×20 inner sample land EXACTLY on neighboring lattice points (the
    lattice spacing equals the Haar spacing s), so sampling the extended
    grid once and differencing shifted views reproduces the four
    per-sample Haar taps bit-exactly at 1/3.3 of the bilinear-gather
    count."""
    coords = (jnp.arange(_EXT, dtype=jnp.float32) - (_EXT - 1) / 2.0)
    oy, ox = jnp.meshgrid(coords, coords, indexing="ij")
    return jnp.stack([ox, oy], axis=-1).reshape(-1, 2)  # [484, 2]


def surf_describe(image: Array, kps: Keypoints, upright: bool = False) -> Descriptors:
    """64-d float SURF-class descriptors for all (padded) keypoints at once.

    Args:
      image: [H, W] float32 grayscale.
      kps:   Keypoints (capacity N).

    Returns Descriptors([N, 64] float32, unit rows).
    """
    _, w = _surf_lattice()          # [400] Gaussian weights (inner lattice)
    ext = _surf_lattice_ext()       # [484, 2] extended offsets
    n = kps.capacity

    angle = jnp.where(upright, 0.0, kps.angle)
    ca, sa = jnp.cos(angle), jnp.sin(angle)
    # rotation matrices per keypoint: R = [[ca, -sa], [sa, ca]]
    rot = jnp.stack(
        [jnp.stack([ca, -sa], -1), jnp.stack([sa, ca], -1)], axis=-2
    )  # [N, 2, 2]

    s = jnp.maximum(kps.scale, 0.8)  # [N]
    # world offsets: R @ (ext_offs * s)
    offs_world = jnp.einsum("nij,pj->npi", rot, ext) * s[:, None, None]
    pts = kps.xy[:, None, :] + offs_world            # [N, 484, 2]

    # ONE extended-lattice sampling; the Haar taps of inner sample (iy, ix)
    # are its lattice neighbors (see _surf_lattice_ext):
    #   dx[iy, ix] = E[iy+1, ix+2] − E[iy+1, ix]   (± s·ux)
    #   dy[iy, ix] = E[iy+2, ix+1] − E[iy,   ix+1] (± s·uy)
    E = bilinear_sample(image, pts).reshape(n, _EXT, _EXT)
    dx = E[:, 1:-1, 2:] - E[:, 1:-1, :-2]            # [N, 20, 20]
    dy = E[:, 2:, 1:-1] - E[:, :-2, 1:-1]

    wg = w.reshape(_GRID, _GRID)[None]
    dx = (dx * wg).reshape(n, -1)
    dy = (dy * wg).reshape(n, -1)

    # 4×4 cells of 5×5 samples
    def cells(v):
        v = v.reshape(n, 4, 5, 4, 5)
        return jnp.sum(v, axis=(2, 4))  # [N, 4, 4]

    dxg = dx.reshape(n, _GRID, _GRID)
    dyg = dy.reshape(n, _GRID, _GRID)
    feat = jnp.stack(
        [
            cells(dxg).reshape(n, 16),
            cells(dyg).reshape(n, 16),
            cells(jnp.abs(dxg)).reshape(n, 16),
            cells(jnp.abs(dyg)).reshape(n, 16),
        ],
        axis=-1,
    ).reshape(n, 64)  # per-cell (Σdx, Σdy, Σ|dx|, Σ|dy|) interleaved

    norm = jnp.linalg.norm(feat, axis=-1, keepdims=True)
    feat = feat / jnp.maximum(norm, 1e-9)
    feat = jnp.where(kps.mask[:, None], feat, 0.0)
    return Descriptors(data=feat.astype(jnp.float32), mask=kps.mask, binary=False)


# ---------------------------------------------------------------------------
# ORB-class 256-bit binary descriptor
# ---------------------------------------------------------------------------

def _brief_pattern(num_bits: int = 256, patch: float = 31.0, seed: int = 7):
    """Deterministic BRIEF test pattern: Gaussian-distributed point pairs in
    the patch (σ = patch/5), clipped to the patch — generated once at trace
    time (NumPy), a compile-time constant on device."""
    rng = np.random.RandomState(seed)
    sigma = patch / 5.0
    a = np.clip(rng.randn(num_bits, 2) * sigma, -patch / 2, patch / 2)
    b = np.clip(rng.randn(num_bits, 2) * sigma, -patch / 2, patch / 2)
    return jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)


def orb_describe(image: Array, kps: Keypoints, num_bits: int = 256) -> Descriptors:
    """Rotation-steered BRIEF (ORB-class) binary descriptors, bit-packed.

    Returns Descriptors([N, num_bits/32] uint32, binary=True).
    """
    assert num_bits % 32 == 0
    pa, pb = _brief_pattern(num_bits)
    smoothed = gaussian_blur(image, 2.0)

    ca, sa = jnp.cos(kps.angle), jnp.sin(kps.angle)
    rot = jnp.stack(
        [jnp.stack([ca, -sa], -1), jnp.stack([sa, ca], -1)], axis=-2
    )  # [N, 2, 2]
    s = jnp.maximum(kps.scale / 1.2, 1.0)[:, None, None]  # pattern scales with σ

    pts_a = kps.xy[:, None, :] + jnp.einsum("nij,pj->npi", rot, pa) * s
    pts_b = kps.xy[:, None, :] + jnp.einsum("nij,pj->npi", rot, pb) * s

    va = bilinear_sample(smoothed, pts_a)  # [N, B]
    vb = bilinear_sample(smoothed, pts_b)
    bits = (va < vb).astype(jnp.uint32)

    n = kps.capacity
    words = bits.reshape(n, num_bits // 32, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    packed = jnp.sum(words * weights, axis=-1).astype(jnp.uint32)
    packed = jnp.where(kps.mask[:, None], packed, jnp.uint32(0))
    return Descriptors(data=packed, mask=kps.mask, binary=True)


def extract_descriptors(
    image: Array, kps: Keypoints, config: DescriptorConfig = DescriptorConfig()
) -> Descriptors:
    """Dispatch on the configured family."""
    if config.kind == "surf":
        return surf_describe(image, kps, upright=config.upright)
    if config.kind == "orb":
        return orb_describe(image, kps)
    raise ValueError(f"unknown descriptor kind: {config.kind!r}")
