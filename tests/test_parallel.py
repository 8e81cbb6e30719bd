"""Distributed-layer tests on the faked 8-device CPU mesh (SURVEY.md §4:
every shard_map / collective path runs in CI on one process)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from points_matching.ba.lm import bundle_adjust, make_ba_state, ba_cost
from points_matching.core.config import BAConfig
from points_matching.core.types import CameraIntrinsics
from points_matching.data.synthetic import make_ba_problem
from points_matching.parallel import (
    Comm,
    all_pairs_scores,
    distributed_bundle_adjust,
    make_mesh,
    set_fault_hook,
)
from points_matching.parallel.mesh import DATA_AXIS, MODEL_AXIS


def test_devices_available():
    assert len(jax.devices()) >= 8, "conftest must fake 8 CPU devices"


def test_comm_noop_backend():
    c = Comm(None)
    x = jnp.arange(4.0)
    assert c.size() == 1
    np.testing.assert_array_equal(c.psum(x), x)
    np.testing.assert_array_equal(c.ring_shift(x), x)
    np.testing.assert_array_equal(c.reduce_scatter(x), x)


def test_comm_collectives_under_shard_map():
    mesh = make_mesh((8,), (DATA_AXIS,))
    x = jnp.arange(8.0)

    def f(v):
        c = Comm(DATA_AXIS)
        return c.psum(v), c.ring_shift(v, 1)

    from jax.sharding import PartitionSpec as P

    ps, shifted = jax.shard_map(
        f, mesh=mesh, in_specs=P(DATA_AXIS), out_specs=(P(DATA_AXIS), P(DATA_AXIS))
    )(x)
    np.testing.assert_allclose(np.asarray(ps), np.full(8, 28.0))
    # ring_shift(1): device i's value lands on device i+1
    np.testing.assert_allclose(np.asarray(shifted), np.roll(np.arange(8.0), 1))


def _random_descriptors(key, n_img, k=16, d=32):
    ks = jax.random.split(key, 2)
    base = jax.random.normal(ks[0], (n_img, k, d))
    base = base / jnp.linalg.norm(base, axis=-1, keepdims=True)
    mask = jnp.ones((n_img, k), bool)
    return base, mask


def test_all_pairs_single_device_symmetryish():
    d, m = _random_descriptors(jax.random.PRNGKey(0), 8)
    s = all_pairs_scores(d, m, mesh=None, ratio=0.95)
    assert s.shape == (8, 8)
    # image matched to a noisy copy of itself scores higher than to strangers
    d2 = d.at[1].set(d[0] + 0.01 * jax.random.normal(jax.random.PRNGKey(1), d[0].shape))
    s2 = all_pairs_scores(d2, m, mesh=None, ratio=0.95)
    off_diag = np.asarray(s2)[0]
    assert off_diag[1] == max(off_diag[i] for i in range(1, 8))


def test_all_pairs_sharded_matches_single_device():
    d, m = _random_descriptors(jax.random.PRNGKey(42), 16)
    ref = all_pairs_scores(d, m, mesh=None, ratio=0.9)
    mesh = make_mesh((8,), (DATA_AXIS,))
    out = all_pairs_scores(d, m, mesh=mesh, ratio=0.9)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(out))


def test_all_pairs_rejects_indivisible():
    d, m = _random_descriptors(jax.random.PRNGKey(0), 6)
    mesh = make_mesh((8,), (DATA_AXIS,))
    with pytest.raises(ValueError):
        all_pairs_scores(d, m, mesh=mesh)


def _ba_setup(num_landmarks=64):
    prob = make_ba_problem(jax.random.PRNGKey(3), num_cameras=4, num_landmarks=num_landmarks)
    K = CameraIntrinsics.from_matrix(prob["K"])
    # perturb so BA has something to do
    key = jax.random.PRNGKey(7)
    X0 = prob["X"] + 0.05 * jax.random.normal(key, prob["X"].shape)
    state = make_ba_state(prob["poses"], X0, prob["uv"], prob["mask"])
    return state, K


def test_distributed_ba_matches_single_device():
    state, K = _ba_setup()
    mesh = make_mesh((1, 8), (DATA_AXIS, MODEL_AXIS))

    # One LM iteration is a deterministic step — sharded and unsharded must
    # agree to f32 reduction-order tolerance.
    cfg1 = BAConfig(max_iterations=1)
    ref_state, ref_stats = bundle_adjust(state, K, cfg1)
    out_state, out_stats = distributed_bundle_adjust(state, K, mesh, cfg1)
    np.testing.assert_allclose(
        np.asarray(ref_stats.final_cost), np.asarray(out_stats.final_cost),
        rtol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(ref_state.X), np.asarray(out_state.X), atol=1e-3
    )

    # Over many iterations accept/reject branches can diverge on rounding;
    # both runs must still converge to comparable cost.
    cfg5 = BAConfig(max_iterations=5)
    _, ref5 = bundle_adjust(state, K, cfg5)
    _, out5 = distributed_bundle_adjust(state, K, mesh, cfg5)
    assert float(out5.final_cost) < float(out5.initial_cost)
    assert float(ref5.final_cost) < float(ref5.initial_cost)
    np.testing.assert_allclose(
        np.asarray(ref5.final_cost), np.asarray(out5.final_cost), rtol=0.1
    )


def test_distributed_ba_rejects_indivisible():
    state, K = _ba_setup(num_landmarks=60)
    mesh = make_mesh((1, 8), (DATA_AXIS, MODEL_AXIS))
    with pytest.raises(ValueError):
        distributed_bundle_adjust(state, K, mesh)


def test_fault_injection_hook_perturbs_psum():
    mesh = make_mesh((8,), (DATA_AXIS,))
    from jax.sharding import PartitionSpec as P

    def f(v):
        return Comm(DATA_AXIS).psum(v)

    g = jax.shard_map(f, mesh=mesh, in_specs=P(DATA_AXIS), out_specs=P(DATA_AXIS))
    x = jnp.ones((8,))
    clean = np.asarray(g(x))
    set_fault_hook(lambda name, v: v * 2.0)
    try:
        faulty = np.asarray(g(x))
    finally:
        set_fault_hook(None)
    np.testing.assert_allclose(clean, np.full(8, 8.0))
    np.testing.assert_allclose(faulty, np.full(8, 16.0))
