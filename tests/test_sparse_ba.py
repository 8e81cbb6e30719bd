"""Sparse observation-list BA vs the dense-grid engine (SURVEY.md §7
"sparse BA on dense hardware"; VERDICT r1 item 3: segment-sum assembly,
dense/sparse parity, and a scale smoke test the dense grid cannot hold)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from points_matching.ba.lm import bundle_adjust, make_ba_state
from points_matching.ba.residuals import residuals_and_jacobians
from points_matching.ba.schur import (
    build_normal_equations,
    schur_matvec,
    _damp,
    _inv3,
)
from points_matching.ba.sparse import (
    build_sparse_normal_equations,
    bundle_adjust_sparse,
    make_sparse_ba_state,
    sparse_ba_cost,
    sparse_residuals_and_jacobians,
    sparse_schur_matvec,
    solve_sparse_schur_pcg,
)
from points_matching.core.config import BAConfig
from points_matching.core.types import CameraIntrinsics, Pose
from points_matching.data.synthetic import make_ba_problem
from points_matching.geometry.se3 import so3_exp


def _problem_pair(seed=0, cameras=5, landmarks=48, drop=0.2, noise=0.5):
    """The same BA problem in both layouts: dense [C, L] grid state and the
    flat observation list (with some observations masked out)."""
    prob = make_ba_problem(
        jax.random.PRNGKey(seed), num_cameras=cameras, num_landmarks=landmarks,
        noise=noise,
    )
    K = CameraIntrinsics.from_matrix(prob["K"])
    rng = np.random.RandomState(seed)
    mask = np.asarray(prob["mask"]) & (rng.rand(cameras, landmarks) > drop)

    dense = make_ba_state(prob["poses"], prob["X"], prob["uv"],
                          jnp.asarray(mask))

    c_idx, l_idx = np.nonzero(mask)
    uv = np.asarray(prob["uv"])[c_idx, l_idx]
    # pad the list to a static capacity with invalid rows
    O = c_idx.size + 7
    pad = O - c_idx.size
    cam_idx = np.concatenate([c_idx, np.zeros(pad, np.int64)])
    lm_idx = np.concatenate([l_idx, np.zeros(pad, np.int64)])
    uv = np.concatenate([uv, np.full((pad, 2), 1e6, np.float32)])
    obs_mask = np.concatenate([np.ones(c_idx.size, bool), np.zeros(pad, bool)])
    sparse = make_sparse_ba_state(
        prob["poses"], prob["X"], jnp.asarray(cam_idx), jnp.asarray(lm_idx),
        jnp.asarray(uv), jnp.asarray(obs_mask),
    )
    return dense, sparse, K


def test_normal_equation_blocks_match_dense():
    dense, sparse, K = _problem_pair()
    r, Jc, Jl = residuals_and_jacobians(
        dense.poses, dense.X, dense.uv, dense.mask, K
    )
    w_grid = dense.mask.astype(jnp.float32)
    blocks = build_normal_equations(r, Jc, Jl, w_grid)

    rs, Jcs, Jls = sparse_residuals_and_jacobians(sparse, K)
    eq = build_sparse_normal_equations(
        sparse, rs, Jcs, Jls, sparse.obs_mask.astype(jnp.float32)
    )

    # f32 summation order differs (segment_sum vs dense einsum), and the
    # sparse engine's ANALYTIC Jacobians (r5) associate the 1/z products
    # differently than the dense engine's jacfwd chain — measured ~7e-5
    # relative on the gradient blocks; rtol 3e-4 is still far below the
    # normal equations' own f32 noise floor at these magnitudes
    np.testing.assert_allclose(np.asarray(eq.U), np.asarray(blocks.U),
                               rtol=3e-4, atol=1e-2)
    np.testing.assert_allclose(np.asarray(eq.V), np.asarray(blocks.V),
                               rtol=3e-4, atol=1e-2)
    np.testing.assert_allclose(np.asarray(eq.bc), np.asarray(blocks.bc),
                               rtol=3e-4, atol=1e-2)
    np.testing.assert_allclose(np.asarray(eq.bl), np.asarray(blocks.bl),
                               rtol=3e-4, atol=1e-2)

    # implicit Schur matvec parity against the dense form
    lam = jnp.asarray(1e-3)
    Vinv = _inv3(_damp(blocks.V, lam))
    x = jax.random.normal(jax.random.PRNGKey(9), (dense.poses.t.shape[0], 6))
    dense_Sx = schur_matvec(blocks, Vinv, lam, x)
    sparse_Sx = sparse_schur_matvec(eq, Vinv, lam, x)
    np.testing.assert_allclose(np.asarray(sparse_Sx), np.asarray(dense_Sx),
                               rtol=1e-4, atol=1e-2)


def test_sparse_lm_matches_dense_lm():
    dense, sparse, K = _problem_pair(seed=3, noise=0.3)
    # perturb initial geometry identically in both layouts so the initial
    # cost sits far above the measurement-noise floor
    key = jax.random.PRNGKey(11)
    dX = 0.08 * jax.random.normal(key, sparse.X.shape)
    dense = dense.replace(X=dense.X + dX)
    sparse = sparse.replace(X=sparse.X + dX)
    cfg = BAConfig(max_iterations=15, rtol=0.0, solver="pcg",
                   pcg_iterations=60)
    d_out, d_stats = bundle_adjust(dense, K, cfg)
    s_out, s_stats = bundle_adjust_sparse(sparse, K, cfg)

    np.testing.assert_allclose(float(s_stats.initial_cost),
                               float(d_stats.initial_cost), rtol=1e-4)
    # both engines must reach the same optimum
    np.testing.assert_allclose(float(s_stats.final_cost),
                               float(d_stats.final_cost), rtol=5e-2)
    assert float(s_stats.final_cost) < 0.3 * float(s_stats.initial_cost)
    np.testing.assert_allclose(np.asarray(s_out.poses.t),
                               np.asarray(d_out.poses.t), atol=5e-2)


def test_sparse_lm_noise_free_converges_to_zero():
    dense, sparse, K = _problem_pair(seed=5, noise=0.0, drop=0.1)
    # perturb the initial geometry so there is something to optimize
    key = jax.random.PRNGKey(1)
    dX = 0.05 * jax.random.normal(key, sparse.X.shape)
    sparse = sparse.replace(X=sparse.X + dX)
    cfg = BAConfig(max_iterations=25, rtol=0.0, pcg_iterations=60)
    out, stats = bundle_adjust_sparse(sparse, K, cfg)
    assert float(stats.final_cost) < 1e-2 * float(stats.initial_cost)


def test_sparse_handles_duplicate_observations():
    """Duplicate (c, l) rows must contribute additively (the dense grid's
    last-write-wins conversion cannot represent this)."""
    _, sparse, K = _problem_pair(seed=7)
    # duplicate the first 5 valid observations
    dup = sparse.replace(
        cam_idx=jnp.concatenate([sparse.cam_idx, sparse.cam_idx[:5]]),
        lm_idx=jnp.concatenate([sparse.lm_idx, sparse.lm_idx[:5]]),
        uv=jnp.concatenate([sparse.uv, sparse.uv[:5]]),
        obs_mask=jnp.concatenate([sparse.obs_mask, sparse.obs_mask[:5]]),
    )
    base_cost = float(sparse_ba_cost(sparse, K))
    dup_cost = float(sparse_ba_cost(dup, K))
    assert dup_cost > base_cost  # duplicated residuals add
    out, stats = bundle_adjust_sparse(dup, K, BAConfig(max_iterations=5,
                                                       rtol=0.0))
    assert float(stats.final_cost) < float(stats.initial_cost)


def test_distributed_sparse_ba_matches_single_device():
    """Observation-sharded LM on the faked 8-device mesh must reproduce the
    single-device result bit-for-policy (same math, psum-completed sums;
    VERDICT r2 item 4)."""
    from points_matching.parallel.mesh import MODEL_AXIS, make_mesh
    from points_matching.parallel.sharded_ba import (
        distributed_bundle_adjust_sparse,
    )

    _, sparse, K = _problem_pair(seed=3, noise=0.3)
    key = jax.random.PRNGKey(11)
    sparse = sparse.replace(X=sparse.X + 0.08 * jax.random.normal(key, sparse.X.shape))
    cfg = BAConfig(max_iterations=10, rtol=0.0, pcg_iterations=40)

    ref_out, ref_stats = bundle_adjust_sparse(sparse, K, cfg)

    mesh = make_mesh((8,), axes=(MODEL_AXIS,))
    out, stats = distributed_bundle_adjust_sparse(sparse, K, mesh, cfg)

    assert int(stats.iterations) == int(ref_stats.iterations)
    np.testing.assert_allclose(float(stats.initial_cost),
                               float(ref_stats.initial_cost), rtol=1e-5)
    # psum partials reduce in a different f32 order than one segment_sum;
    # 10 LM accept/reject decisions amplify that — same tolerance class as
    # the dense-vs-sparse parity test above
    np.testing.assert_allclose(float(stats.final_cost),
                               float(ref_stats.final_cost), rtol=7e-2)
    assert float(stats.final_cost) < 0.5 * float(stats.initial_cost)
    np.testing.assert_allclose(np.asarray(out.poses.t),
                               np.asarray(ref_out.poses.t), atol=5e-2)
    np.testing.assert_allclose(np.asarray(out.X), np.asarray(ref_out.X),
                               atol=1e-1)


def test_distributed_sparse_ba_pads_ragged_observation_axis():
    """O not divisible by the mesh axis: padding with masked rows must not
    change the optimum."""
    from points_matching.parallel.mesh import MODEL_AXIS, make_mesh
    from points_matching.parallel.sharded_ba import (
        distributed_bundle_adjust_sparse,
    )

    _, sparse, K = _problem_pair(seed=9, cameras=4, landmarks=21, drop=0.3)
    assert sparse.num_observations % 8 != 0  # the case under test
    cfg = BAConfig(max_iterations=4, rtol=0.0, pcg_iterations=25)
    ref_out, ref_stats = bundle_adjust_sparse(sparse, K, cfg)
    mesh = make_mesh((8,), axes=(MODEL_AXIS,))
    out, stats = distributed_bundle_adjust_sparse(sparse, K, mesh, cfg)
    np.testing.assert_allclose(float(stats.final_cost),
                               float(ref_stats.final_cost), rtol=1e-3)


def test_sparse_ba_at_scale_dense_grid_cannot_hold():
    """256 cameras × 65 536 landmarks: the dense coupling W would be
    [256, 65536, 6, 3] f32 ≈ 1.2 TB.  The sparse engine runs it in
    O(observations) memory (131 072 obs ≈ tens of MB)."""
    C, L, O = 256, 65536, 131072
    rng = np.random.RandomState(0)

    X = np.concatenate(
        [rng.uniform(-8, 8, (L, 2)), rng.uniform(6, 18, (L, 1))], axis=1
    ).astype(np.float32)
    angles = np.linspace(-0.25, 0.25, C).astype(np.float32)
    w = np.stack([np.zeros(C, np.float32), angles, np.zeros(C, np.float32)], 1)
    R = np.asarray(so3_exp(jnp.asarray(w)))
    t = np.stack(
        [np.linspace(-2, 2, C), np.zeros(C), np.zeros(C)], 1
    ).astype(np.float32)
    poses = Pose(R=jnp.asarray(R), t=jnp.asarray(t))
    K = CameraIntrinsics.from_matrix(
        jnp.asarray([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    )

    cam_idx = rng.randint(0, C, O)
    lm_idx = rng.randint(0, L, O)
    # perfect projections + noise → a well-posed problem
    Xg = X[lm_idx]
    xc = np.einsum("oij,oj->oi", R[cam_idx], Xg) + t[cam_idx]
    uv = xc[:, :2] / xc[:, 2:3] * 500.0 + np.array([320.0, 240.0])
    uv = (uv + 0.5 * rng.randn(O, 2)).astype(np.float32)

    state = make_sparse_ba_state(
        poses, jnp.asarray(X), jnp.asarray(cam_idx), jnp.asarray(lm_idx),
        jnp.asarray(uv), jnp.ones((O,), bool),
    )
    cfg = BAConfig(max_iterations=2, rtol=0.0, pcg_iterations=15)
    out, stats = bundle_adjust_sparse(state, K, cfg)
    assert np.isfinite(float(stats.final_cost))
    assert float(stats.final_cost) < float(stats.initial_cost)


def test_sorted_layout_matches_scatter():
    """obs_layout='sorted' (sort-once + cumsum-diff landmark
    sums + one-hot-GEMM camera sums) must reproduce the scatter
    segment_sum path: same per-iteration algebra to f32 tolerance, same
    final cost trajectory, and the returned state must keep the caller's
    observation ordering."""
    import dataclasses

    from points_matching.core.config import BAConfig

    _, sparse, K = _problem_pair(seed=7, cameras=6, landmarks=64, drop=0.3)
    # perturb so BA has real work
    sparse = sparse.replace(
        X=sparse.X + 0.03 * jax.random.normal(jax.random.PRNGKey(1),
                                              sparse.X.shape)
    )
    cfg_scatter = BAConfig(max_iterations=8, rtol=0.0, pcg_iterations=20,
                           obs_layout="scatter")
    cfg_sorted = dataclasses.replace(cfg_scatter, obs_layout="sorted")

    out_a, st_a = bundle_adjust_sparse(sparse, K, cfg_scatter)
    out_b, st_b = bundle_adjust_sparse(sparse, K, cfg_sorted)

    np.testing.assert_allclose(float(st_b.initial_cost),
                               float(st_a.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(st_b.final_cost),
                               float(st_a.final_cost), rtol=2e-3)
    # observation ordering preserved for the caller
    np.testing.assert_array_equal(np.asarray(out_b.lm_idx),
                                  np.asarray(sparse.lm_idx))
    np.testing.assert_array_equal(np.asarray(out_b.cam_idx),
                                  np.asarray(sparse.cam_idx))
    # same solution to solver tolerance
    np.testing.assert_allclose(np.asarray(out_b.poses.t),
                               np.asarray(out_a.poses.t), atol=5e-3)
    lm_seen = np.zeros(sparse.num_landmarks, bool)
    lm_seen[np.asarray(sparse.lm_idx)[np.asarray(sparse.obs_mask)]] = True
    np.testing.assert_allclose(np.asarray(out_b.X)[lm_seen],
                               np.asarray(out_a.X)[lm_seen], atol=2e-2)


def test_distributed_sparse_ba_sorted_layout():
    """obs_layout='sorted' under shard_map (per-shard sort + scatter-free
    reductions + psum) must match the
    scatter distributed path on the faked 8-device mesh."""
    import dataclasses

    from points_matching.parallel.mesh import MODEL_AXIS, make_mesh
    from points_matching.parallel.sharded_ba import (
        distributed_bundle_adjust_sparse,
    )

    _, sparse, K = _problem_pair(seed=5, noise=0.3)
    key = jax.random.PRNGKey(13)
    sparse = sparse.replace(
        X=sparse.X + 0.05 * jax.random.normal(key, sparse.X.shape)
    )
    cfg = BAConfig(max_iterations=6, rtol=0.0, pcg_iterations=25,
                   obs_layout="scatter")
    mesh = make_mesh((8,), axes=(MODEL_AXIS,))
    ref_out, ref_stats = distributed_bundle_adjust_sparse(sparse, K, mesh, cfg)
    out, stats = distributed_bundle_adjust_sparse(
        sparse, K, mesh, dataclasses.replace(cfg, obs_layout="sorted")
    )
    np.testing.assert_allclose(float(stats.initial_cost),
                               float(ref_stats.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(stats.final_cost),
                               float(ref_stats.final_cost), rtol=5e-2)
    assert float(stats.final_cost) < 0.5 * float(stats.initial_cost)
    np.testing.assert_allclose(np.asarray(out.poses.t),
                               np.asarray(ref_out.poses.t), atol=5e-2)


def test_lm_fixed_freezes_landmarks_exactly():
    """``SparseBAState.lm_fixed`` (r5, the windowed-capacity local BA's
    anchoring mechanism — pipelines/sfm.py local_bundle_adjust): frozen
    landmarks must not move AT ALL (their V⁻¹ rows are zeroed, so dl is
    exactly 0), their observations must still constrain cameras, and the
    solve must still reduce cost on the free part."""
    _, sparse, K = _problem_pair(seed=3, noise=0.3)
    key = jax.random.PRNGKey(11)
    sparse = sparse.replace(
        X=sparse.X + 0.08 * jax.random.normal(key, sparse.X.shape)
    )
    L = sparse.num_landmarks
    frozen = jnp.arange(L) < L // 2
    st = sparse.replace(lm_fixed=frozen)
    cfg = BAConfig(max_iterations=10, rtol=0.0, pcg_iterations=40)
    out, stats = bundle_adjust_sparse(st, K, cfg)

    # frozen rows: bitwise unchanged
    np.testing.assert_array_equal(
        np.asarray(out.X[: L // 2]), np.asarray(sparse.X[: L // 2])
    )
    # free rows must move and cost must drop (cameras + free landmarks)
    assert float(jnp.abs(out.X[L // 2 :] - sparse.X[L // 2 :]).max()) > 0
    assert float(stats.final_cost) < float(stats.initial_cost)

    # with NO frozen rows the default state reproduces the old behavior
    out_all, stats_all = bundle_adjust_sparse(sparse, K, cfg)
    assert float(stats_all.final_cost) <= float(stats.final_cost) * 1.05


def test_sorted_layout_auto_gates_on_problem_size():
    """The default takes scatter segment_sum at every problem size and on
    every platform; only an explicit 'sorted' request chooses the sorted
    layout, and an unknown layout name raises."""
    from points_matching.ba import sparse as sp

    assert not sp._use_sorted_layout(BAConfig())
    assert not sp._use_sorted_layout(BAConfig(obs_layout="scatter"))
    assert sp._use_sorted_layout(BAConfig(obs_layout="sorted"))
    with pytest.raises(ValueError):
        sp._use_sorted_layout(BAConfig(obs_layout="auto"))


def test_analytic_jacobians_match_jacfwd():
    """The closed-form residual Jacobians (r5 — replacing the vmapped
    jacfwd chain) must match the forward-mode reference to rounding,
    including the z-clamp gate for points at/behind the camera plane."""
    from points_matching.ba.sparse import (
        _sparse_residuals_and_jacobians_jacfwd,
        sparse_residuals,
        sparse_residuals_and_jacobians,
    )

    _, sparse, K = _problem_pair(seed=3, noise=0.3)
    # push a few landmarks behind the camera to exercise the clamp branch
    sparse = sparse.replace(
        X=sparse.X.at[:3].set(jnp.asarray([[0.0, 0.0, -5.0]] * 3))
    )
    r_a, Jc_a, Jl_a = sparse_residuals_and_jacobians(sparse, K)
    r_f, Jc_f, Jl_f = _sparse_residuals_and_jacobians_jacfwd(sparse, K)
    np.testing.assert_allclose(np.asarray(r_a), np.asarray(r_f),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(Jc_a), np.asarray(Jc_f),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(Jl_a), np.asarray(Jl_f),
                               rtol=1e-5, atol=1e-3)
    # residual-only helper agrees too
    np.testing.assert_allclose(np.asarray(sparse_residuals(sparse, K)),
                               np.asarray(r_f), rtol=1e-5, atol=1e-4)
