"""Pipeline parallelism (SURVEY.md §2.3 P3): GPipe-style staged execution
over a ``stage`` mesh axis must match sequential composition exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from points_matching.parallel.mesh import make_mesh
from points_matching.parallel.pipeline import STAGE_AXIS, pipeline_stages


def _wire(m, key=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(key))
    return {
        "x": jax.random.normal(k1, (m, 4, 3), jnp.float32),
        "n": jnp.arange(m, dtype=jnp.int32),
        "w": jax.random.normal(k2, (m, 3), jnp.float32),
    }


def _stages():
    def frontend(w):
        return {**w, "x": jnp.tanh(w["x"]), "n": w["n"] + 1}

    def matching(w):
        return {**w, "w": w["x"].sum(0) + w["w"], "n": w["n"] * 2}

    def geometry(w):
        return {**w, "x": w["x"] * w["w"][None, :], "n": w["n"] + 3}

    def refine(w):
        return {**w, "x": w["x"] - w["x"].mean(), "w": 2.0 * w["w"]}

    return [frontend, matching, geometry, refine]


def _sequential(stage_fns, xs):
    def compose(x):
        for f in stage_fns:
            x = f(x)
        return x

    return jax.lax.map(compose, xs)


def test_single_device_matches_composition():
    xs = _wire(5)
    got = pipeline_stages(_stages(), xs, mesh=None)
    want = _sequential(_stages(), xs)
    jax.tree.map(np.testing.assert_allclose, got, want)


@pytest.mark.parametrize("m", [1, 4, 9])
def test_staged_matches_sequential(m):
    mesh = make_mesh((4,), (STAGE_AXIS,), devices=jax.devices()[:4])
    xs = _wire(m, key=m)
    got = jax.jit(
        lambda xs: pipeline_stages(_stages(), xs, mesh=mesh)
    )(xs)
    want = _sequential(_stages(), xs)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6),
        got,
        want,
    )


def test_two_stage_pipeline():
    mesh = make_mesh((2,), (STAGE_AXIS,), devices=jax.devices()[:2])
    fns = _stages()[:2]
    xs = _wire(6, key=7)
    got = pipeline_stages(fns, xs, mesh=mesh)
    want = _sequential(fns, xs)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6),
        got,
        want,
    )


def test_stage_count_mismatch_raises():
    mesh = make_mesh((4,), (STAGE_AXIS,), devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="stage axis"):
        pipeline_stages(_stages()[:3], _wire(2), mesh=mesh)


# ---------------------------------------------------------------------------
# Real stages (VERDICT r1 item 6): the actual detect → describe → match →
# geometry pipeline microbatched through the 4-device stage mesh, with
# output parity vs the sequential compose path AND vs two_view_pipeline.
# ---------------------------------------------------------------------------

def _pair_batch(m=3, h=64, w=96, seed=11):
    """Synthetic textured pairs: img2 is img1 shifted by 3px (so matching
    and RANSAC find real structure, not noise)."""
    key = jax.random.PRNGKey(seed)
    base = 128.0 + 40.0 * jax.random.normal(key, (m, h, w + 8), jnp.float32)
    # mild blur so the Hessian detector finds blobs, not pixel noise
    k = jnp.ones((3, 3), jnp.float32) / 9.0
    base = jax.vmap(
        lambda im: jax.scipy.signal.convolve2d(im, k, mode="same")
    )(base)
    img1 = base[:, :, :w]
    img2 = base[:, :, 3 : w + 3]
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(m, dtype=jnp.uint32))
    return img1, img2, keys


def _staged_config():
    from points_matching.core.config import (
        DetectorConfig, MatcherConfig, RansacConfig, TwoViewConfig)
    return TwoViewConfig(
        detector=DetectorConfig(kind="hessian", threshold=10.0,
                                max_keypoints=64, num_octaves=2,
                                layers_per_octave=2, border=8),
        matcher=MatcherConfig(metric="l2", filter="ratio", ratio=0.9),
        ransac=RansacConfig(num_hypotheses=32),
        use_ransac=True,
    )


def test_real_two_view_stages_parity():
    from points_matching.pipelines.staged_two_view import staged_two_view

    cfg = _staged_config()
    img1, img2, keys = _pair_batch()
    mesh = make_mesh((4,), (STAGE_AXIS,), devices=jax.devices()[:4])

    got = jax.jit(lambda a, b, k: staged_two_view(a, b, k, cfg, mesh=mesh))(
        img1, img2, keys)
    want = jax.jit(lambda a, b, k: staged_two_view(a, b, k, cfg, mesh=None))(
        img1, img2, keys)

    def _f_angle(a, b):
        """Scale/sign-invariant distance between two F estimates."""
        a = np.asarray(a).ravel(); b = np.asarray(b).ravel()
        a = a / np.linalg.norm(a); b = b / np.linalg.norm(b)
        return float(np.sqrt(max(0.0, 1.0 - np.dot(a, b) ** 2)))

    # the RANSAC refit (eigh of AᵀA) amplifies fp reduction-order noise
    # between the shard_map'd and sequential compilations; everything up to
    # the geometry stage must agree tightly, F up to a small angle.
    for name in got:
        if name == "F":
            for i in range(img1.shape[0]):
                assert _f_angle(got["F"][i], want["F"][i]) < 5e-3
        elif name == "residual_mean":
            np.testing.assert_allclose(got[name], want[name],
                                       rtol=5e-2, atol=1e-4)
        else:
            np.testing.assert_allclose(got[name], want[name],
                                       rtol=1e-5, atol=1e-5, err_msg=name)

    # and vs the monolithic pipeline: same correspondences, same inlier
    # count (integer — immune to fp noise), compatible F per pair
    from points_matching.pipelines.two_view import two_view_pipeline
    for i in range(img1.shape[0]):
        res = jax.jit(
            lambda a, b, k: two_view_pipeline(a, b, k, cfg)
        )(img1[i], img2[i], keys[i])
        # ratio-test near-ties can flip under a different XLA fusion; demand
        # >=98% identical correspondences rather than bitwise equality
        same = np.all(np.isclose(np.asarray(got["p1"][i]),
                                 np.asarray(res.p1), atol=1e-5), axis=-1)
        assert float(same.mean()) >= 0.98, float(same.mean())
        assert abs(int(got["num_inliers"][i])
                   - int(res.estimate.num_inliers)) <= 2
        # the shifted pair is homography-related, so F itself is non-unique
        # (any [e]ₓH fits) — check the staged F explains the monolithic
        # pipeline's correspondences instead of comparing matrices
        from points_matching.geometry import sampson_distance
        d = np.asarray(sampson_distance(got["F"][i], res.p1, res.p2))
        m = np.asarray(res.matches.mask)
        assert float(np.median(d[m])) < cfg.ransac.inlier_threshold ** 2
    # the pipeline found real geometry, not padding
    assert int(np.asarray(got["num_inliers"]).min()) >= 8


def test_binary_descriptor_wire_staged_parity():
    """ORB/Hamming config through the staged pipeline (VERDICT r2 item 9):
    the uint32 bit-packed descriptor leaves must ride the psum-based
    handoff and match the sequential compose path exactly (integer
    descriptors + integer Hamming distances ⇒ bitwise parity everywhere
    except the RANSAC refit's fp tail)."""
    import dataclasses

    from points_matching.core.config import (
        DescriptorConfig, DetectorConfig, MatcherConfig)
    from points_matching.pipelines.staged_two_view import staged_two_view

    cfg = _staged_config()
    cfg = dataclasses.replace(
        cfg,
        detector=DetectorConfig(kind="fast", threshold=5.0, max_keypoints=64,
                                num_octaves=1, layers_per_octave=2, border=8),
        descriptor=DescriptorConfig(kind="orb"),
        matcher=MatcherConfig(metric="hamming", filter="ratio", ratio=0.95),
    )
    img1, img2, keys = _pair_batch(m=3)
    mesh = make_mesh((4,), (STAGE_AXIS,), devices=jax.devices()[:4])

    got = jax.jit(lambda a, b, k: staged_two_view(a, b, k, cfg, mesh=mesh))(
        img1, img2, keys)
    want = jax.jit(lambda a, b, k: staged_two_view(a, b, k, cfg, mesh=None))(
        img1, img2, keys)

    assert got["desc1"].dtype == jnp.uint32
    # packed bits must survive the wire untouched
    np.testing.assert_array_equal(np.asarray(got["desc1"]),
                                  np.asarray(want["desc1"]))
    np.testing.assert_array_equal(np.asarray(got["mmask"]),
                                  np.asarray(want["mmask"]))
    np.testing.assert_allclose(np.asarray(got["p1"]), np.asarray(want["p1"]),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got["num_inliers"]),
                                  np.asarray(want["num_inliers"]))
    # the wire carried real features, not zero padding
    assert int(np.asarray(got["kmask1"]).sum()) > 0
    assert int(np.asarray(got["mmask"]).sum()) > 0
