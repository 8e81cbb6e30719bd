"""Pallas kernels, compiled through Triton for the GPU, for the hot ops
where a hand-fused kernel beats what XLA makes of the plain version
(SURVEY.md §7 stage 4).  Every kernel has a plain-jnp reference in
``ops/`` or ``geometry/`` and is tested against it through the Pallas
interpreter on the CPU."""
from __future__ import annotations

from typing import Callable

import jax

# MatcherConfig.backend / RansacConfig.backend values.
BACKENDS = ("auto", "xla", "pallas", "interpret")


def dispatch(backend: str, kernel: Callable, reference: Callable, *args):
    """Run ``kernel(*args, interpret=...)`` or ``reference(*args)``.

    'auto' picks per lowering platform (``lax.platform_dependent``): the
    compiled kernel where the computation is lowered for a CUDA device, the
    plain XLA reference on every other platform, so one function serves a
    GPU and a CPU device alike.  'xla' is the reference, 'pallas' the
    compiled kernel (GPU only), 'interpret' the kernel through the Pallas
    interpreter (tests on hosts without a GPU).  Both sides must return
    the same shapes and dtypes.
    """
    if backend == "xla":
        return reference(*args)
    if backend == "pallas":
        return kernel(*args, interpret=False)
    if backend == "interpret":
        return kernel(*args, interpret=True)
    if backend != "auto":
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")
    return jax.lax.platform_dependent(
        *args, default=reference,
        cuda=lambda *a: kernel(*a, interpret=False))
