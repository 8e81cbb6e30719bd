"""points_matching — a SLAM/SfM engine in JAX/XLA/Pallas.

A brand-new framework covering (and extending) the capabilities of the
``wenxiaoshuai/Points-Matching`` reference demo (``Points Matching/
main.cpp``): keypoint detection, descriptor extraction, nearest-neighbor
matching, fundamental-matrix estimation, epipolar residual auditing and
epipolar-line visualization — plus batched RANSAC, pose recovery,
triangulation, Schur-complement bundle adjustment, pose-graph optimization,
incremental SfM and distributed SLAM over accelerator device meshes.

Design principles:
  * static shapes + validity masks everywhere (jit-ability),
  * matching as distance GEMMs + fused top-2,
  * batched linear algebra under ``vmap``,
  * parallelism via ``jax.sharding`` / ``shard_map`` over a ``Mesh``,
  * Pallas kernels (through Triton on the GPU) only where they beat XLA.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent compilation cache, on by default: the detector and pipeline
# graphs take far longer to compile than to run.  JAX reads
# JAX_COMPILATION_CACHE_DIR itself when it is set; otherwise the cache
# lives at a fixed path inside the checkout (git-ignored), so every process
# of this checkout hits the same entries.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir() -> str:
    """The directory the persistent compile cache uses."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR


if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)

from points_matching.core import types, config  # noqa: F401,E402
