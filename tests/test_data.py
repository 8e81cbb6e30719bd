"""Native C++ decode layer vs PIL oracle (SURVEY.md §2.2 N7)."""
import os

import numpy as np
import pytest
from PIL import Image

from points_matching.data import native
from points_matching.data.images import load_batch, load_image, rgb_to_gray

REF_JPG = "/root/reference/Points Matching/img01.JPG"

needs_native = pytest.mark.skipif(
    native.load_library() is None, reason="native library not built"
)


def _make_test_images(tmp_path):
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 255, (40, 56, 3), np.uint8)
    paths = {}
    for fmt, name in [("PNG", "a.png"), ("BMP", "a.bmp"), ("JPEG", "a.jpg"),
                      ("PPM", "a.ppm")]:
        p = str(tmp_path / name)
        Image.fromarray(rgb).save(p, fmt)
        paths[fmt] = p
    gray = rng.randint(0, 255, (40, 56), np.uint8)
    p = str(tmp_path / "g.pgm")
    Image.fromarray(gray).save(p, "PPM")  # PIL writes P5 for gray 'PPM'
    paths["PGM"] = p
    return rgb, gray, paths


@needs_native
def test_native_info_and_decode_formats(tmp_path):
    rgb, gray, paths = _make_test_images(tmp_path)
    for fmt in ["PNG", "BMP", "PPM"]:  # lossless → exact luma match
        assert native.image_info(paths[fmt]) == (56, 40), fmt
        out = native.decode_gray(paths[fmt])
        np.testing.assert_allclose(out, rgb_to_gray(rgb), atol=0.51, err_msg=fmt)
    out = native.decode_gray(paths["PGM"])
    np.testing.assert_allclose(out, gray.astype(np.float32), atol=0.01)


@needs_native
def test_native_jpeg_close_to_pil(tmp_path):
    _, _, paths = _make_test_images(tmp_path)
    ours = native.decode_gray(paths["JPEG"])
    with Image.open(paths["JPEG"]) as im:
        ref = rgb_to_gray(np.asarray(im.convert("RGB")))
    # independent IDCTs may differ by a couple of gray levels
    assert np.mean(np.abs(ours - ref)) < 2.0


@needs_native
def test_native_reference_image():
    if not os.path.exists(REF_JPG):
        pytest.skip("reference images not mounted")
    assert native.image_info(REF_JPG) == (993, 660)
    img = native.decode_gray(REF_JPG)
    assert img.shape == (660, 993)
    assert 20 < img.mean() < 240


@needs_native
def test_batch_decode(tmp_path):
    rgb, _, paths = _make_test_images(tmp_path)
    batch = native.decode_batch_gray(
        [paths["PNG"], paths["BMP"], "/nonexistent.png"], 56, 40
    )
    assert batch.shape == (3, 40, 56)
    np.testing.assert_allclose(batch[0], rgb_to_gray(rgb), atol=0.51)
    np.testing.assert_allclose(batch[1], rgb_to_gray(rgb), atol=0.51)
    np.testing.assert_array_equal(batch[2], 0.0)  # failed slot zero-filled


def test_load_image_pil_fallback(tmp_path, monkeypatch):
    rgb, _, paths = _make_test_images(tmp_path)
    monkeypatch.setattr(native, "decode_gray", lambda p: None)
    out = load_image(paths["PNG"])
    np.testing.assert_allclose(out, rgb_to_gray(rgb), atol=0.51)


def test_load_batch_api(tmp_path):
    rgb, _, paths = _make_test_images(tmp_path)
    out = load_batch([paths["PNG"], paths["PPM"]])
    assert out.shape == (2, 40, 56)
    np.testing.assert_allclose(out[0], rgb_to_gray(rgb), atol=0.51)
