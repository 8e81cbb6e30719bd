"""TUM / KITTI format loaders against synthetic fixture trees."""
import os

import numpy as np
import pytest
from PIL import Image

from points_matching.data.datasets import (
    _quat_to_rot,
    _rot_to_quat,
    load_kitti_sequence,
    load_tum_sequence,
)


def _write_tum(tmp_path, n=5):
    root = tmp_path / "tum"
    (root / "rgb").mkdir(parents=True)
    rgb_lines = ["# rgb images", "# ts filename"]
    gt_lines = ["# ground truth"]
    rng = np.random.RandomState(0)
    for i in range(n):
        ts = 1000.0 + 0.033 * i
        name = f"rgb/{ts:.6f}.png"
        Image.fromarray(rng.randint(0, 255, (24, 32), np.uint8)).save(str(root / name))
        rgb_lines.append(f"{ts:.6f} {name}")
        # gt at slightly offset timestamps
        gt_lines.append(
            f"{ts + 0.005:.6f} {0.1*i:.4f} 0.0 0.0 0.0 0.0 0.0 1.0"
        )
    (root / "rgb.txt").write_text("\n".join(rgb_lines))
    (root / "groundtruth.txt").write_text("\n".join(gt_lines))
    return str(root)


def test_tum_loader(tmp_path):
    root = _write_tum(tmp_path)
    seq = load_tum_sequence(root)
    assert len(seq) == 5
    assert all(os.path.exists(p) for p in seq.image_paths)
    # gt associated within 20 ms
    np.testing.assert_allclose(seq.gt_positions[:, 0],
                               0.1 * np.arange(5), atol=1e-6)
    assert np.isfinite(seq.gt_quats).all()
    poses = seq.world_to_camera_poses()
    assert poses.R.shape == (5, 3, 3)
    # identity quats → world→camera t = -C
    np.testing.assert_allclose(np.asarray(poses.t)[:, 0],
                               -0.1 * np.arange(5), atol=1e-5)


def test_tum_loader_no_gt(tmp_path):
    root = _write_tum(tmp_path)
    os.remove(os.path.join(root, "groundtruth.txt"))
    seq = load_tum_sequence(root, max_frames=3)
    assert len(seq) == 3
    assert np.isnan(seq.gt_positions).all()


def _write_kitti(tmp_path, n=4):
    root = tmp_path / "kitti"
    img = root / "sequences" / "00" / "image_0"
    img.mkdir(parents=True)
    rng = np.random.RandomState(1)
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (20, 40), np.uint8)).save(
            str(img / f"{i:06d}.png")
        )
    (root / "sequences" / "00" / "calib.txt").write_text(
        "P0: 700.0 0.0 600.0 0.0 0.0 700.0 180.0 0.0 0.0 0.0 1.0 0.0\n"
    )
    (root / "sequences" / "00" / "times.txt").write_text(
        "\n".join(f"{0.1*i:.6f}" for i in range(n))
    )
    (root / "poses").mkdir()
    lines = []
    for i in range(n):
        P = np.hstack([np.eye(3), np.asarray([[1.5 * i], [0.0], [0.2 * i]])])
        lines.append(" ".join(f"{v:.6e}" for v in P.ravel()))
    (root / "poses" / "00.txt").write_text("\n".join(lines))
    return str(root)


def test_kitti_loader(tmp_path):
    root = _write_kitti(tmp_path)
    seq = load_kitti_sequence(root, "00")
    assert len(seq) == 4
    assert float(seq.K.fx) == 700.0 and float(seq.K.cx) == 600.0
    np.testing.assert_allclose(seq.gt_positions[:, 0], 1.5 * np.arange(4))
    np.testing.assert_allclose(seq.timestamps, 0.1 * np.arange(4))


def test_quat_roundtrip():
    rng = np.random.RandomState(2)
    q = rng.randn(16, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q *= np.sign(q[:, 3:4])  # qw >= 0 canonical form
    R = _quat_to_rot(q)
    q2 = _rot_to_quat(R)
    np.testing.assert_allclose(q, q2, atol=1e-6)
    # orthonormality
    np.testing.assert_allclose(
        np.einsum("nij,nkj->nik", R, R),
        np.broadcast_to(np.eye(3), (16, 3, 3)), atol=1e-8,
    )
