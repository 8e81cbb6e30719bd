"""Numerical sanitizers (SURVEY.md §5 "race detection / sanitizers").

JAX's functional model removes data races by construction (the reference is
single-threaded C++ with /RTC1 only — no sanitizers of its own), so the
failure modes left are NUMERICAL: NaN/Inf escaping an ill-conditioned solve
(8-point F, Schur complements) and out-of-bounds gathers hidden by XLA's
index-clamping semantics.  This module wraps ``jax.experimental.checkify`` and the
debug-nans/disable-jit flags behind the three calls the pipelines need.

Usage:
    checked_fn = checked(two_view_pipeline)          # NaN + OOB checking
    out, err = checked_fn(img1, img2, key)
    err.throw()                                      # raises with location

    with debug_mode():                               # interactive debugging
        pipeline(...)  # eager, NaN-trapping
"""
from __future__ import annotations

import contextlib
from typing import Callable

import jax
from jax.experimental import checkify

# float_checks: every primitive producing NaN/Inf is flagged at its source.
# index_checks: gathers/scatters with OOB indices (XLA silently clamps —
# exactly the bug class fixed-capacity masked layouts can hide).
DEFAULT_CHECKS = checkify.float_checks | checkify.index_checks


def checked(fn: Callable, errors=DEFAULT_CHECKS) -> Callable:
    """Wrap ``fn`` with checkify: returns ``(err, out)``-style callable
    ``f(*args) -> (out, err)``; call ``err.throw()`` to raise on failure.

    The wrapped function stays jittable — checks compile into the XLA
    program (a few % overhead), so it runs on the device, under vmap, in
    scans.

    Two limitations:
      * checkify does not instrument Pallas kernel INTERIORS: checkify
        pipelines with ``backend='xla'`` in their Matcher/Ransac configs;
        the kernels are checked against the XLA path by
        tests/test_pallas_kernels.py and, compiled, by chip_smoke.py.
      * checkify-instrumenting the batched RANSAC hypothesis path makes
        the XLA CPU compile pathological (hours at any hypothesis count);
        check the frontend and the no-RANSAC pipeline instead (see
        tests/test_utils.py) and rely on RANSAC's unit checks.
    """
    cfn = checkify.checkify(fn, errors=errors)

    def wrapper(*args, **kwargs):
        err, out = cfn(*args, **kwargs)
        return out, err

    return wrapper


def check_finite(x: jax.Array, name: str) -> None:
    """In-graph assertion that ``x`` is finite — usable inside any traced
    function that is run under ``checked``/``checkify`` (no-op otherwise)."""
    import jax.numpy as jnp

    checkify.check(
        jnp.all(jnp.isfinite(x)), "non-finite values in {name}", name=name
    )


@contextlib.contextmanager
def debug_mode(nans: bool = True, disable_jit: bool = False):
    """Interactive debugging: trap NaNs at the op that produced them
    (``jax_debug_nans``) and optionally run eagerly (``jax_disable_jit``)."""
    prev_nans = jax.config.jax_debug_nans
    prev_jit = jax.config.jax_disable_jit
    try:
        jax.config.update("jax_debug_nans", nans)
        jax.config.update("jax_disable_jit", disable_jit)
        yield
    finally:
        jax.config.update("jax_debug_nans", prev_nans)
        jax.config.update("jax_disable_jit", prev_jit)
