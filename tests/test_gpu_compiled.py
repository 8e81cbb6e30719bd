"""Compiled (not interpreted) Pallas kernels against the XLA path on a GPU.

Marked ``gpu``: the ``gpu_device`` fixture skips them where JAX finds no
GPU.  On a GPU host:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu_compiled.py -m gpu

``chip_smoke.py`` (phase 5) runs the same comparisons at the benchmark
widths and times both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from points_matching.core.types import Descriptors

pytestmark = pytest.mark.gpu


def test_fused_l2_top2_compiled_parity(gpu_device):
    from points_matching.ops.matching import knn_match
    from points_matching.ops.pallas.matching_kernel import fused_l2_top2

    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    n1, n2 = 512, 768
    q = jax.random.normal(k1, (n1, 64))
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    t = jax.random.normal(k2, (n2, 64))
    t = t / jnp.linalg.norm(t, axis=-1, keepdims=True)
    t_mask = jnp.arange(n2) < (n2 - 33)
    q, t, t_mask = jax.device_put((q, t, t_mask), gpu_device)

    for dtype, atol in (("f32", 1e-4), ("bf16", 2e-2)):
        dist, idx = fused_l2_top2(q, t, t_mask, compute_dtype=dtype)
        ref_dist, ref_idx = knn_match(
            Descriptors(data=q, mask=jnp.ones((n1,), bool)),
            Descriptors(data=t, mask=t_mask), k=2, compute_dtype=dtype)
        agree = np.mean(np.asarray(idx[:, 0]) == np.asarray(ref_idx[:, 0]))
        assert agree >= 0.99, (dtype, agree)
        np.testing.assert_allclose(np.asarray(dist), np.asarray(ref_dist),
                                   atol=atol)
        assert np.all(np.asarray(idx[:, 1]) != np.asarray(idx[:, 0]))


def test_minimal_eight_point_compiled_parity(gpu_device):
    from points_matching.data.synthetic import make_two_view_scene
    from points_matching.geometry.fundamental import eight_point
    from points_matching.ops.pallas.eightpoint_kernel import (
        minimal_eight_point,
    )

    scene = make_two_view_scene(jax.random.PRNGKey(3), num_points=256,
                                noise=0.0)
    rng = np.random.RandomState(0)
    idx = np.stack([rng.choice(256, 8, replace=False) for _ in range(512)])
    sp1 = jax.device_put(np.asarray(scene.p1)[idx], gpu_device)
    sp2 = jax.device_put(np.asarray(scene.p2)[idx], gpu_device)
    F_k = np.asarray(minimal_eight_point(sp1, sp2))
    F_x = np.asarray(eight_point(sp1, sp2))
    err = np.max(np.abs(F_k - F_x), axis=(1, 2))
    assert np.all(np.isfinite(F_k))
    assert np.median(err) < 2e-4, np.median(err)
    assert np.mean(err < 1e-2) >= 0.9
