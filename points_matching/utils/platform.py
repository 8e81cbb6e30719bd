"""Platform selection for the command-line entry points."""
from __future__ import annotations

from typing import Optional

import jax

PLATFORMS = ("cpu", "gpu")


def use_platform(name: Optional[str]) -> None:
    """Pin JAX to ``name`` ('cpu' or 'gpu'); None keeps JAX's default.

    Call before anything touches a device.  Asking for 'gpu' where JAX
    finds none raises: there is no fallback to the CPU.
    """
    if name is None:
        return
    if name not in PLATFORMS:
        raise ValueError(f"unknown platform {name!r}; expected {PLATFORMS}")
    jax.config.update("jax_platforms", "cuda" if name == "gpu" else name)
    found = jax.devices()[0].platform
    if found != name:
        raise RuntimeError(f"asked for platform {name!r}, JAX found {found!r}")
