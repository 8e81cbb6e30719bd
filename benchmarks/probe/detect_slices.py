#!/usr/bin/env python
"""Detector per-stage cost decomposition on the device (993×660, 512 kp).

Cumulative slices of ops.detect.detect_keypoints (Hessian kind, SURF
parity config), each jitted as an 8-iteration dependent chain and
slope-timed against a 1-iteration chain — same methodology as
bench.py's sections.

Slices:
  resp       - 8-sigma Hessian response pyramid (the shift-FMA convs)
  nms        - + spatial/scale NMS + border/threshold mask
  topk       - + 2x2-block reduce + top-k (index decode)
  subpix     - + sub-pixel offset maps and their gathers
  full       - + orientation (= production detect_keypoints)
  describe   - surf_describe on the full detection (per-image cost)

Usage: python detect_slices.py [out.txt]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from jax import lax

    from points_matching.core.config import surf_parity_config
    from points_matching.ops import detect as D
    from points_matching.ops.descriptors import surf_describe

    cfg = surf_parity_config().detector
    H, W = 660, 993
    sigmas = D.detector_sigmas(cfg)
    rng = np.random.RandomState(0)
    img0 = jnp.asarray(128.0 + 40.0 * rng.randn(H, W).astype(np.float32))

    def resp_only(img):
        r = jnp.stack([D.hessian_response(img, s) for s in sigmas], axis=0)
        return jnp.sum(r) * 1e-12

    def nms_cut(img):
        r = jnp.stack([D.hessian_response(img, s) for s in sigmas], axis=0)
        pk = jnp.logical_and(D._spatial_nms(r, cfg.nms_radius), D._scale_nms(r))
        yy = jnp.arange(H)[None, :, None]
        xx = jnp.arange(W)[None, None, :]
        b = cfg.border
        ok = (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)
        v = pk & ok & (r > cfg.threshold * 1e-4)
        return jnp.sum(jnp.where(v, r, 0.0)) * 1e-12

    def topk_cut(img):
        # production path with orientation + subpixel disabled via config
        import dataclasses
        c = dataclasses.replace(cfg, compute_orientation=False)
        kp = D.detect_keypoints(img, c)
        return jnp.sum(kp.xy) * 1e-12

    def full_cut(img):
        kp = D.detect_keypoints(img, cfg)
        return jnp.sum(kp.xy) * 1e-12

    def describe_cut(img):
        kp = D.detect_keypoints(img, cfg)
        desc = surf_describe(img, kp)
        return jnp.sum(desc.data) * 1e-12

    variants = [
        ("resp", resp_only),
        ("nms", nms_cut),
        ("topk", topk_cut),
        ("full", full_cut),
        ("describe", describe_cut),
    ]

    lines = []
    prev = 0.0
    for name, fn in variants:
        import functools

        @functools.partial(jax.jit, static_argnums=(1,))
        def chain(img, n, fn=fn):
            def body(carry, _):
                out = fn(img + carry)
                return carry + out, None
            acc, _ = lax.scan(body, jnp.float32(0.0), None, length=n)
            return acc

        def run(k):
            return float(chain(img0, k))

        run(1)  # compile n=1
        t0 = time.perf_counter(); run(1); t1 = time.perf_counter()
        chain(img0, 9).block_until_ready()  # compile n=9
        t2 = time.perf_counter(); float(chain(img0, 9)); t3 = time.perf_counter()
        per = ((t3 - t2) - (t1 - t0)) / 8.0 * 1e3
        lines.append(f"{name:10s} cum {per:7.2f} ms/image   delta {per - prev:+7.2f}")
        print(lines[-1], flush=True)
        prev = per

    out = sys.argv[1] if len(sys.argv) > 1 else None
    if out:
        with open(out, "w") as f:
            f.write("Detector stage decomposition (993x660, 512 kp)\n")
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
