"""Float32-exact matmul precision for the geometry/solver paths.

On a GPU, an f32×f32 contraction at JAX's DEFAULT precision may run in
TF32 (10-bit mantissa, ~3 significant digits) on the tensor cores.  For
neural-net workloads that is the right default; for epipolar geometry it
is not:

  * pixel coordinates ~600 would round to a ~0.5 px grid inside the
    one-hot sampling GEMM — every minimal sample perturbed;
  * the Sampson residual r = p2ᵀFp1 is a near-cancellation of O(1) terms,
    so reduced-precision products flip the d < τ² inlier gate;
  * the refit AᵀA loses the conditioning Hartley normalization bought.

The cure is cheap because every affected contraction is tiny (K ≤ 9
minimal-sample algebra, 3×3 matvecs); the deep GEMMs that earn bf16
(descriptor distance matrices) opt into it explicitly via
``compute_dtype`` and are not routed through this helper.

Usage: decorate geometry/BA entry points with ``@f32_matmuls``, or pass
``precision=F32_EXACT`` at individual call sites.
"""
from __future__ import annotations

import functools

import jax

# Exact f32 contraction (no TF32 / bf16 passes).
F32_EXACT = jax.lax.Precision.HIGHEST


def f32_matmuls(fn):
    """Trace ``fn`` under float32-exact default matmul precision.

    The context is a trace-time config: jit caches key on it, so
    decorating the public entry point covers the whole call tree."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapper
