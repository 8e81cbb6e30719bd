"""Fused batched minimal 8-point solve — the RANSAC hypothesis factory
(Pallas through Triton).

The XLA path (``geometry/fundamental.eight_point`` over vmapped hypothesis
samples) is algebraically identical but is a long chain of tiny [B·H]-wide
elementwise ops that XLA splits into many fusions, with intermediates in
device memory between them.  The arithmetic itself is small (~2 kFLOP per
hypothesis).

Design: one hypothesis per GPU thread.  The input is laid out
variable-major ([32, B]: x1 | y1 | x2 | y2, 8 points each), so each
scalar of the unrolled solve (``geometry/eigen.py``'s static-control-flow
algorithm) is one [BH]-wide register vector op, and the whole chain

    Hartley normalize → constraint AᵀA (9×9) → shifted Cholesky →
    inverse iteration → rank-2 projection → denormalize → sign-normalize

runs in one kernel: 32 input floats and 9 output floats per hypothesis
touch device memory.  Replaces OpenCV's per-sample solve inside
``cvFindFundamentalMat`` (reference call site ``Points
Matching/main.cpp:95-98``; implicit native component N4, SURVEY.md §2.2).

Numerical contract: identical algorithm and guard constants as
``geometry/eigen.py`` / ``geometry/fundamental.eight_point`` (same shift
eps, same golden-angle start vector, same iteration counts), so the two
paths agree to f32 rounding — parity-tested in
``tests/test_pallas_kernels.py``.  Degenerate samples (coincident points,
masked garbage) produce finite garbage F whose consensus score is ~0, same
as the XLA path.
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

# A multiplicative identity sentinel: constraint-row entry a[8] ≡ 1, so
# products against it are free.
_ONE = None


def _mul(a, b):
    if a is _ONE:
        return b
    if b is _ONE:
        return a
    return a * b


def _chol_unrolled(M: dict, n: int):
    """Cholesky of a symmetric matrix given as {(i, j): array, i ≥ j}.

    Mirrors ``geometry/eigen._cholesky_unrolled`` (same sqrt(max(·, 1e-30))
    pivot guard) but additionally returns the reciprocal diagonal so the
    solves below multiply instead of divide."""
    L: dict = {}
    invd = [None] * n
    for j in range(n):
        s = M[(j, j)]
        for k in range(j):
            s = s - L[(j, k)] * L[(j, k)]
        d = jnp.sqrt(jnp.maximum(s, 1e-30))
        inv = 1.0 / d
        L[(j, j)] = d
        invd[j] = inv
        for i in range(j + 1, n):
            s = M[(i, j)]
            for k in range(j):
                s = s - L[(i, k)] * L[(j, k)]
            L[(i, j)] = s * inv
    return L, invd


def _chol_solve_unrolled(L: dict, invd: list, b: list, n: int) -> list:
    """(L Lᵀ) x = b with b a list of n per-variable arrays."""
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[(i, k)] * y[k]
        y[i] = s * invd[i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[(k, i)] * x[k]
        x[i] = s * invd[i]
    return x


def _smallest_eigvec(M: dict, n: int, iters: int) -> list:
    """Inverse-iteration smallest eigenvector of PSD {(i,j): array}.

    Same algorithm/constants as ``geometry/eigen.smallest_eigvecs_psd``
    (k=1): shift ε = 1e-5·tr/n + 1e-20, golden-angle start, fixed trip
    count, basis-vector fallback on collapsed/non-finite norms."""
    tr = M[(0, 0)]
    for i in range(1, n):
        tr = tr + M[(i, i)]
    eps = tr * (1e-5 / n) + 1e-20
    Ms = dict(M)
    for i in range(n):
        Ms[(i, i)] = M[(i, i)] + eps
    L, invd = _chol_unrolled(Ms, n)

    v = [
        jnp.full_like(tr, math.cos(i * 2.399963) + 0.1) for i in range(n)
    ]
    for _ in range(iters):
        x = _chol_solve_unrolled(L, invd, v, n)
        ss = x[0] * x[0]
        for i in range(1, n):
            ss = ss + x[i] * x[i]
        norm = jnp.sqrt(ss)
        ok = jnp.logical_and(norm > 1e-20, jnp.isfinite(norm))
        inv = 1.0 / jnp.maximum(norm, 1e-20)
        v = [
            jnp.where(ok, x[i] * inv, 1.0 if i == 0 else 0.0)
            for i in range(n)
        ]
    return v


def _hartley(xs: list, ys: list):
    """Unweighted Hartley normalization over the 8 sample points.

    Matches ``geometry/normalize.hartley_normalize`` with all-one weights:
    centroid to origin, mean distance to sqrt(2), max(mean_dist, 1e-9)."""
    npts = len(xs)
    cx = xs[0]
    cy = ys[0]
    for p in range(1, npts):
        cx = cx + xs[p]
        cy = cy + ys[p]
    cx = cx * (1.0 / npts)
    cy = cy * (1.0 / npts)
    dxs = [x - cx for x in xs]
    dys = [y - cy for y in ys]
    md = jnp.sqrt(dxs[0] * dxs[0] + dys[0] * dys[0])
    for p in range(1, npts):
        md = md + jnp.sqrt(dxs[p] * dxs[p] + dys[p] * dys[p])
    md = md * (1.0 / npts)
    s = math.sqrt(2.0) / jnp.maximum(md, 1e-9)
    xn = [d * s for d in dxs]
    yn = [d * s for d in dys]
    return xn, yn, cx, cy, s


def _eightpoint_kernel(in_ref, out_ref, *, iters_9: int, iters_3: int):
    # per-variable [BH] row loads: x1 | y1 | x2 | y2, 8 points each
    x1 = [in_ref[p, :] for p in range(8)]
    y1 = [in_ref[8 + p, :] for p in range(8)]
    x2 = [in_ref[16 + p, :] for p in range(8)]
    y2 = [in_ref[24 + p, :] for p in range(8)]

    x1n, y1n, cx1, cy1, s1 = _hartley(x1, y1)
    x2n, y2n, cx2, cy2, s2 = _hartley(x2, y2)

    # AᵀA accumulation over the 8 constraint rows
    # row = [x2x1, x2y1, x2, y2x1, y2y1, y2, x1, y1, 1]
    ATA: dict = {}
    for p in range(8):
        a = [
            x2n[p] * x1n[p], x2n[p] * y1n[p], x2n[p],
            y2n[p] * x1n[p], y2n[p] * y1n[p], y2n[p],
            x1n[p], y1n[p], _ONE,
        ]
        for i in range(9):
            for j in range(i + 1):
                prod = _mul(a[i], a[j])
                if prod is _ONE:
                    prod = jnp.full_like(x1n[p], 1.0)
                key = (i, j)
                ATA[key] = prod if p == 0 else ATA[key] + prod

    f = _smallest_eigvec(ATA, 9, iters_9)  # vec(Fn), row-major

    # rank-2 projection: Fn ← Fn − (Fn v₃) v₃ᵀ, v₃ from FᵀF
    Fn = [[f[3 * i + j] for j in range(3)] for i in range(3)]
    M: dict = {}
    for i in range(3):
        for j in range(i + 1):
            s = Fn[0][i] * Fn[0][j]
            for k in range(1, 3):
                s = s + Fn[k][i] * Fn[k][j]
            M[(i, j)] = s
    v3 = _smallest_eigvec(M, 3, iters_3)
    Fv = [
        Fn[i][0] * v3[0] + Fn[i][1] * v3[1] + Fn[i][2] * v3[2]
        for i in range(3)
    ]
    Fr = [[Fn[i][j] - Fv[i] * v3[j] for j in range(3)] for i in range(3)]

    # denormalize: F = T2ᵀ Fr T1 with T = [[s,0,-s·cx],[0,s,-s·cy],[0,0,1]]
    G = [[None] * 3 for _ in range(3)]
    for i in range(3):
        G[i][0] = Fr[i][0] * s1
        G[i][1] = Fr[i][1] * s1
        G[i][2] = Fr[i][2] - cx1 * G[i][0] - cy1 * G[i][1]
    F = [[None] * 3 for _ in range(3)]
    for j in range(3):
        F[0][j] = G[0][j] * s2
        F[1][j] = G[1][j] * s2
        F[2][j] = G[2][j] - cx2 * F[0][j] - cy2 * F[1][j]

    # Frobenius + sign normalization (geometry/fundamental._sign_normalize):
    # unit norm, then flip so the largest-|entry| (first on ties) is positive.
    ss = F[0][0] * F[0][0]
    for i in range(3):
        for j in range(3):
            if i or j:
                ss = ss + F[i][j] * F[i][j]
    inv = 1.0 / jnp.maximum(jnp.sqrt(ss), 1e-12)
    flat = [F[i][j] * inv for i in range(3) for j in range(3)]
    best_abs = jnp.abs(flat[0])
    best = flat[0]
    for k in range(1, 9):
        ak = jnp.abs(flat[k])
        take = ak > best_abs
        best_abs = jnp.where(take, ak, best_abs)
        best = jnp.where(take, flat[k], best)
    sign = jnp.where(best < 0, -1.0, 1.0)
    for k in range(9):
        out_ref[k, :] = flat[k] * sign


@functools.partial(jax.jit, static_argnames=("block_h", "num_warps",
                                             "interpret"))
def minimal_eight_point(
    sp1: Array, sp2: Array, block_h: int = 128, num_warps: int = 4,
    interpret: bool = False,
) -> Array:
    """Batched normalized 8-point solve for minimal RANSAC samples.

    Args:
      sp1, sp2: [..., 8, 2] sampled correspondences (any leading batch
        shape; typically [H, 8, 2] per pair, vmapped over pairs).
      interpret: run through the Pallas interpreter (tests without a GPU).

    Returns [..., 3, 3] rank-2, Frobenius/sign-normalized F with
    p2ᵀ F p1 ≈ 0 — same contract as ``geometry.fundamental.eight_point``
    on unweighted 8-point samples.

    The batch is padded to a multiple of ``block_h``; padding rows compute
    finite garbage that is sliced away.
    """
    batch_shape = sp1.shape[:-2]
    B = int(np.prod(batch_shape)) if batch_shape else 1
    s1 = sp1.reshape(B, 8, 2).astype(jnp.float32)
    s2 = sp2.reshape(B, 8, 2).astype(jnp.float32)

    Bp = -(-B // block_h) * block_h
    # [32, Bp] variable-major: row k holds one scalar of every hypothesis,
    # so each row load is one coalesced vector (x1 points 0..7 | y1 | x2 | y2)
    packed = jnp.concatenate(
        [s1[:, :, 0], s1[:, :, 1], s2[:, :, 0], s2[:, :, 1]], axis=-1
    )
    x = jnp.pad(packed, ((0, Bp - B), (0, 0))).T

    out = pl.pallas_call(
        functools.partial(_eightpoint_kernel, iters_9=4, iters_3=8),
        grid=(Bp // block_h,),
        in_specs=[pl.BlockSpec((32, block_h), lambda g: (0, g))],
        # 16 rows (a power of two); rows 9..15 stay unwritten and unread
        out_specs=pl.BlockSpec((16, block_h), lambda g: (0, g)),
        out_shape=jax.ShapeDtypeStruct((16, Bp), jnp.float32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        interpret=interpret,
        name="minimal_eight_point",
    )(x)
    return out[:9, :B].T.reshape(*batch_shape, 3, 3)
