"""Detector / descriptor tests (implicit components N1-N2, SURVEY.md §4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from points_matching.core.config import DescriptorConfig, DetectorConfig
from points_matching.core.types import Keypoints
from points_matching.ops.descriptors import orb_describe, surf_describe
from points_matching.ops.detect import (
    detect_keypoints,
    fast_response,
    gaussian_blur,
    harris_response,
    hessian_response,
)


def _blob_image(centers, sigma=4.0, size=(128, 128), amp=200.0):
    """Grayscale image with Gaussian blobs at given (x, y) centers."""
    H, W = size
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.zeros((H, W), np.float32)
    for cx, cy in centers:
        img += amp * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sigma**2))
    return jnp.asarray(img)


def _checkerboard(size=(96, 96), cell=16, amp=200.0):
    H, W = size
    yy, xx = np.mgrid[0:H, 0:W]
    img = (((yy // cell) + (xx // cell)) % 2) * amp
    return jnp.asarray(img.astype(np.float32))


class TestHessianDetector:
    def test_finds_blobs(self):
        centers = [(32, 32), (96, 32), (32, 96), (96, 96), (64, 64)]
        img = _blob_image(centers)
        cfg = DetectorConfig(kind="hessian", max_keypoints=16, threshold=10.0)
        kps = detect_keypoints(img, cfg)
        n = int(kps.count)
        assert n >= len(centers)
        found = np.asarray(kps.xy)[np.asarray(kps.mask)]
        for c in centers:
            d = np.linalg.norm(found - np.asarray(c), axis=-1).min()
            assert d < 2.0, f"blob {c} not found (closest {d:.1f}px)"

    def test_scale_selection(self):
        # single blob: detected scale should grow with blob size
        img_small = _blob_image([(64, 64)], sigma=3.0)
        img_large = _blob_image([(64, 64)], sigma=8.0)
        cfg = DetectorConfig(kind="hessian", max_keypoints=4, threshold=10.0)
        s_small = detect_keypoints(img_small, cfg)
        s_large = detect_keypoints(img_large, cfg)
        assert float(s_small.scale[0]) < float(s_large.scale[0])

    def test_shift_equivariance(self):
        img = _blob_image([(50, 40), (80, 90)])
        cfg = DetectorConfig(kind="hessian", max_keypoints=8, threshold=10.0)
        k0 = detect_keypoints(img, cfg)
        img_shift = jnp.roll(img, shift=(7, 11), axis=(0, 1))  # dy=7, dx=11
        k1 = detect_keypoints(img_shift, cfg)
        p0 = np.asarray(k0.xy)[np.asarray(k0.mask)]
        p1 = np.asarray(k1.xy)[np.asarray(k1.mask)]
        for p in p0:
            moved = p + np.asarray([11, 7])
            if (moved < 100).all() and (moved > 20).all():
                d = np.linalg.norm(p1 - moved, axis=-1).min()
                assert d < 1.0

    def test_static_shapes_and_jit(self):
        img = _blob_image([(40, 40)])
        cfg = DetectorConfig(kind="hessian", max_keypoints=32)
        f = jax.jit(lambda im: detect_keypoints(im, cfg))
        kps = f(img)
        assert kps.xy.shape == (32, 2)
        assert kps.mask.shape == (32,)


class TestCornerDetectors:
    def test_harris_on_checkerboard(self):
        img = _checkerboard()
        cfg = DetectorConfig(kind="harris", max_keypoints=64, threshold=1.0,
                             num_octaves=1, layers_per_octave=1, border=8)
        kps = detect_keypoints(img, cfg)
        found = np.asarray(kps.xy)[np.asarray(kps.mask)]
        assert len(found) >= 9
        # corners of the checkerboard lie on the 16-pixel grid
        for p in found[:9]:
            assert abs(p[0] % 16) < 2.5 or abs(16 - p[0] % 16) < 2.5

    def test_fast_on_squares(self):
        # FAST-9 does not fire on checkerboard X-junctions (two ~8-long arcs);
        # it fires on L-corners — use isolated bright squares.
        img = np.zeros((96, 96), np.float32)
        for cy, cx in [(24, 24), (24, 64), (64, 24), (64, 64)]:
            img[cy : cy + 14, cx : cx + 14] = 200.0
        cfg = DetectorConfig(kind="fast", max_keypoints=64, threshold=30.0, border=8)
        kps = detect_keypoints(jnp.asarray(img), cfg)
        assert int(kps.count) >= 8  # ≥2 corners per square in-border

    def test_fast_blank_image(self):
        img = jnp.zeros((64, 64), jnp.float32)
        cfg = DetectorConfig(kind="fast", max_keypoints=16, threshold=20.0, border=8)
        kps = detect_keypoints(img, cfg)
        assert int(kps.count) == 0


class TestDescriptors:
    def _kps_at(self, pts, scale=2.0, angle=0.0):
        n = len(pts)
        return Keypoints(
            xy=jnp.asarray(pts, jnp.float32),
            scale=jnp.full((n,), scale, jnp.float32),
            angle=jnp.full((n,), angle, jnp.float32),
            score=jnp.ones((n,), jnp.float32),
            mask=jnp.ones((n,), bool),
        )

    def test_surf_shape_norm(self):
        img = _blob_image([(40, 40), (70, 80)])
        kps = self._kps_at([(40, 40), (70, 80), (55, 55)])
        d = surf_describe(img, kps)
        assert d.data.shape == (3, 64)
        norms = jnp.linalg.norm(d.data, axis=-1)
        np.testing.assert_allclose(np.asarray(norms), 1.0, atol=1e-4)

    def test_surf_masked_rows_zero(self):
        img = _blob_image([(40, 40)])
        kps = self._kps_at([(40, 40), (60, 60)])
        kps = kps.replace(mask=jnp.asarray([True, False]))
        d = surf_describe(img, kps)
        assert float(jnp.abs(d.data[1]).max()) == 0.0

    def test_surf_discriminative(self):
        # same blob pattern at two locations → similar descriptors;
        # different patterns → dissimilar
        img = _blob_image([(32, 32), (96, 96)], sigma=4.0)
        img = img + _checkerboard((128, 128), cell=8, amp=60.0) * (
            jnp.arange(128)[None, :] > 64
        )
        kps = self._kps_at([(32, 32), (96, 96)], scale=3.0)
        d = surf_describe(img, kps)
        sim_same = float(jnp.dot(d.data[0], d.data[1]))
        assert sim_same > 0.35  # both blobs (right one has texture added)

    def test_surf_rotation_steering(self):
        # a descriptor extracted with angle θ on an image rotated by θ
        # should match the descriptor at angle 0 on the unrotated image
        from scipy.ndimage import rotate

        rng = np.random.RandomState(0)
        base = gaussian_blur(jnp.asarray(rng.rand(128, 128).astype(np.float32)) * 255.0, 1.5)
        theta_deg = 30.0
        rot = rotate(np.asarray(base), -theta_deg, reshape=False, order=1)
        kp0 = self._kps_at([(64, 64)], scale=2.0, angle=0.0)
        kp1 = self._kps_at([(64, 64)], scale=2.0, angle=np.deg2rad(theta_deg))
        d0 = surf_describe(base, kp0)
        d1 = surf_describe(jnp.asarray(rot), kp1)
        sim = float(jnp.dot(d0.data[0], d1.data[0]))
        assert sim > 0.8

    def test_orb_packed(self):
        rng = np.random.RandomState(3)
        img = gaussian_blur(
            jnp.asarray(rng.rand(128, 128).astype(np.float32)) * 255.0, 1.5
        )
        kps = self._kps_at([(40, 40), (80, 80), (60, 60)])
        d = orb_describe(img, kps)
        assert d.data.shape == (3, 8)
        assert d.data.dtype == jnp.uint32
        assert d.binary
        # different locations → nonzero hamming distance
        from points_matching.ops.matching import hamming_distance_matrix

        hd = hamming_distance_matrix(d.data, d.data)
        assert int(hd[0, 0]) == 0
        assert int(hd[0, 1]) > 20

    def test_end_to_end_detect_describe_match(self):
        """Same image shifted: detect+describe+match must recover the shift."""
        from points_matching.core.config import MatcherConfig
        from points_matching.ops.matching import match_descriptors

        rng = np.random.RandomState(1)
        img = gaussian_blur(jnp.asarray(rng.rand(160, 160).astype(np.float32)) * 255.0, 2.0)
        shift = (6, 10)  # dy, dx
        img2 = jnp.roll(img, shift, axis=(0, 1))
        cfg = DetectorConfig(kind="hessian", max_keypoints=64, threshold=1e-3, border=24)
        k1 = detect_keypoints(img, cfg)
        k2 = detect_keypoints(img2, cfg)
        d1 = surf_describe(img, k1)
        d2 = surf_describe(img2, k2)
        m = match_descriptors(d1, d2, MatcherConfig(filter="ratio", ratio=0.8))
        p1, p2 = m.gather_points(k1, k2)
        valid = np.asarray(m.mask)
        assert valid.sum() >= 10
        delta = np.asarray(p2 - p1)[valid]
        med = np.median(delta, axis=0)
        assert np.allclose(med, [shift[1], shift[0]], atol=1.0)


def test_bilinear_sample_left_top_border_fringe():
    """Regression (r5 review): samples with x or y in [-1, 0) must
    interpolate toward pixel column/row 0, not column/row 1 — the packed
    corner path originally clipped the base index and read the wrong
    neighborhood on the one-pixel top/left fringe."""
    from points_matching.ops.sampling import bilinear_sample

    img = jnp.asarray([[10.0, 100.0, 200.0],
                       [30.0, 40.0, 50.0],
                       [60.0, 70.0, 80.0]])
    # x = -0.25: taps at x0=-1 (fill=0) and x=0 with weight wx=0.75;
    # reference value = 0.75 * img[0,0] = 7.5
    v = float(bilinear_sample(img, jnp.asarray([[-0.25, 0.0]]))[0])
    np.testing.assert_allclose(v, 7.5, atol=1e-6)
    v = float(bilinear_sample(img, jnp.asarray([[1.0, -0.5]]))[0])
    np.testing.assert_allclose(v, 0.5 * 100.0, atol=1e-6)
    # interior unchanged
    v = float(bilinear_sample(img, jnp.asarray([[0.5, 0.5]]))[0])
    np.testing.assert_allclose(v, (10 + 100 + 30 + 40) / 4.0, atol=1e-5)
    # bottom/right fringe
    v = float(bilinear_sample(img, jnp.asarray([[2.5, 2.0]]))[0])
    np.testing.assert_allclose(v, 0.5 * 80.0, atol=1e-6)
