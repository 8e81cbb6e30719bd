"""Tracing / profiling / roofline accounting (SURVEY.md §5: the reference's
only observability is console prints; here: ``jax.profiler`` traces,
``named_scope`` stage markers, and per-function roofline reports against
the device's published peaks).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Optional

import jax


# Peak rates per device, keyed by a lowercased ``device_kind`` substring.
#   H100: NVIDIA H100 SXM data sheet and Hopper architecture white paper,
#     dense (no sparsity) tensor-core rates at the full 700 W power limit:
#     989 TFLOP/s bf16, 495 TFLOP/s TF32, 3.35 TB/s HBM3.
#   cpu: a nominal row so CPU test runs produce a report; not a measurement.
_CHIP_PEAKS = {
    "h100": dict(flops=989e12, tf32_flops=495e12, hbm_gbps=3350.0),
    "cpu": dict(flops=1e12, tf32_flops=1e12, hbm_gbps=100.0),
}


def chip_peaks(device=None) -> Dict[str, float]:
    """Peak rates of ``device`` (default: the first device).  A device kind
    that is not in the table raises: there is no assumed default."""
    dev = device if device is not None else jax.devices()[0]
    kind = dev.device_kind.lower()
    for key, peaks in _CHIP_PEAKS.items():
        if key in kind:
            return peaks
    raise KeyError(f"no peak rates known for device kind {dev.device_kind!r} "
                   f"(platform {dev.platform!r})")


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace viewable in TensorBoard/Perfetto."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def stage(name: str):
    """Named scope for pipeline stages (shows up in traces)."""
    return jax.named_scope(name)


@dataclasses.dataclass
class RooflineReport:
    wall_s: float
    flops: Optional[float]
    bytes_accessed: Optional[float]
    achieved_tflops: Optional[float]
    peak_tflops: float
    fraction_of_roofline: Optional[float]
    bandwidth_gbps: Optional[float]
    arithmetic_intensity: Optional[float]

    def __str__(self):
        f = lambda v, fmt: (fmt % v) if v is not None else "n/a"
        return (
            f"wall {self.wall_s*1e3:.3f} ms | "
            f"{f(self.achieved_tflops, '%.2f')} TFLOP/s "
            f"({f(self.fraction_of_roofline and self.fraction_of_roofline * 100, '%.1f')}% of "
            f"{self.peak_tflops:.0f} peak) | "
            f"{f(self.bandwidth_gbps, '%.1f')} GB/s | "
            f"AI {f(self.arithmetic_intensity, '%.1f')} flop/byte"
        )


def roofline(fn: Callable, *args, iters: int = 20, **kwargs) -> RooflineReport:
    """Measure a jitted function against the device roofline.

    Uses XLA's compiled cost analysis for flop/byte counts and the host
    clock around ``iters`` back-to-back calls ended by
    ``block_until_ready`` for the rate (after one warm-up call).
    """
    jitted = jax.jit(fn) if not hasattr(fn, "lower") else fn
    jax.block_until_ready(jitted(*args, **kwargs))  # compile + warm up
    t0 = time.perf_counter()
    for _ in range(iters):
        out = jitted(*args, **kwargs)
    jax.block_until_ready(out)
    wall = (time.perf_counter() - t0) / iters

    ca = jitted.lower(*args, **kwargs).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else (ca or {})
    flops = float(ca.get("flops", 0.0)) or None
    bts = float(ca.get("bytes accessed", 0.0)) or None

    peaks = chip_peaks()
    achieved = flops / wall / 1e12 if flops else None
    return RooflineReport(
        wall_s=wall,
        flops=flops,
        bytes_accessed=bts,
        achieved_tflops=achieved,
        peak_tflops=peaks["flops"] / 1e12,
        fraction_of_roofline=(achieved / (peaks["flops"] / 1e12)) if achieved else None,
        bandwidth_gbps=(bts / wall / 1e9) if bts else None,
        arithmetic_intensity=(flops / bts) if (flops and bts) else None,
    )
