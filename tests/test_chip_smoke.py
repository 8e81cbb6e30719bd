"""chip_smoke.py's phases as library functions at small sizes on the CPU,
with the CPU standing in for both the device and the reference (kernels
through the Pallas interpreter).  Only the device check needs a GPU: run
without one, the script must fail and print no result."""
import json
import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


@pytest.fixture(scope="module")
def cpu():
    return jax.devices("cpu")[0]


def test_phase_image_to_f(cpu):
    r = cs.phase_image_to_f(cpu, cpu, image_size=(160, 120), keypoints=64,
                            reps=1)
    assert r["gpu"] == r["cpu"]
    assert r["gpu"]["inliers"] >= 8 and r["gpu"]["F_finite"]


def test_phase_two_view(cpu):
    r = cs.phase_two_view(cpu, cpu, pairs=4, nkp=64, hypotheses=64, reps=1)
    for dtype in ("f32", "bf16"):
        assert r[dtype]["match_agreement"] >= 0.97
        assert r[dtype]["mean_inliers"] > 0


def test_phase_sfm(cpu):
    r = cs.phase_sfm(cpu, cpu, frames=8, features=128, landmarks=200)
    assert r["gpu"]["registered"] == 8
    assert r["gpu"]["ate_rmse"] <= r["ate_bound"]


def test_phase_sparse_ba(cpu):
    r = cs.phase_sparse_ba(cpu, cpu, cameras=8, landmarks=256,
                           obs_per_landmark=4, iterations=2,
                           timed_iterations=2, reps=1)
    for layout in ("scatter", "sorted"):
        assert max(r[layout]["rel_diff_vs_cpu"]) <= 1e-2
        assert r[layout]["costs"][-1] < r[layout]["initial_cost"]


def test_phase_kernels_interpreted(cpu):
    r = cs.phase_kernels(cpu, pairs=2, nkp=64, hypotheses=64, reps=1,
                         ab_rounds=2, loop_steps=2, interpret=True)
    assert r["fused_l2_top2_f32"]["nn_agreement"] >= 0.999
    assert r["minimal_eight_point"]["median_abs_err"] <= 2e-4
    e2e = r["two_view_end_to_end"]
    assert len(e2e) == 4
    assert all(0 <= v["kernel_wins"] <= v["rounds"] == 2
               and v["steps_per_call"] == 2 for v in e2e.values())
    assert set(r["xla_paths_of_removed_kernels"]) == {"sampson_count",
                                                      "hamming_top2"}


def test_phase_four_cards_on_faked_mesh():
    devices = jax.devices()[:4]
    assert len(devices) == 4  # conftest fakes 8 CPU devices
    r = cs.phase_four_cards(devices, cameras=8, landmarks=256,
                            obs_per_landmark=4, iterations=2, images=16,
                            keypoints=32, dim=32, reps=1)
    assert r["n_devices"] == 4
    assert r["sparse_ba"]["rel_diff"] <= 1e-2
    assert r["all_pairs"]["max_abs_diff"] <= 2


def test_script_fails_without_gpu():
    """No GPU: nonzero exit and no result line (no CPU fallback)."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            assert json.loads(line).get("ok") is not True
