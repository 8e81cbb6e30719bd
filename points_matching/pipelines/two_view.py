"""Two-view pipeline — the reference demo, end to end, as ONE jit region.

Reference call stack (``Points Matching/main.cpp:9-146``, SURVEY.md §3.1):
imread → SURF detect → SURF describe → FLANN match → min/max + midpoint
filter → findFundamentalMat → residual audit → epilines → draw/imshow.

Here: host decode (``data/images.py``) → one ``device_put`` → a single
traced function [detect → describe → match(GEMM+top-k) → filter →
8-point / batched RANSAC → residual audit → epilines] → host viz
(SURVEY.md §3.2 ``two_view``; BASELINE configs 0 and 2).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from points_matching.core import struct
from jax import Array

from points_matching.core.config import TwoViewConfig, surf_parity_config
from points_matching.core.types import (
    Descriptors,
    Keypoints,
    Matches,
    TwoViewEstimate,
)
from points_matching.geometry import (
    compute_epilines,
    epipolar_residual_audit,
    find_fundamental,
    ransac_fundamental,
    sampson_distance,
)
from points_matching.ops.descriptors import extract_descriptors
from points_matching.ops.detect import detect_keypoints
from points_matching.ops.matching import match_descriptors, match_stats


@struct.dataclass
class TwoViewResult:
    """Everything the reference demo prints/draws, in device arrays."""

    kps1: Keypoints
    kps2: Keypoints
    matches: Matches
    dist_min: Array          # reference's "Min Match" print (main.cpp:59)
    dist_max: Array          # reference's "Max Match" print (main.cpp:58)
    estimate: TwoViewEstimate
    p1: Array                # [M, 2] matched points image 1
    p2: Array                # [M, 2] matched points image 2
    residuals: Array         # [M] per-match p1ᵀFp2 (reference audit form)
    epilines2: Array         # [M, 3] lines in image 2 for p1 (main.cpp:128)


@functools.partial(jax.jit, static_argnames=("config",))
def two_view_pipeline(
    image1: Array,
    image2: Array,
    key: Array,
    config: TwoViewConfig = surf_parity_config(),
) -> TwoViewResult:
    """The full two-view geometry pipeline as one traced function.

    Args:
      image1, image2: [H, W] float32 grayscale (0-255).
      key: PRNG key (RANSAC sampling; unused when config.use_ransac=False).
      config: static pipeline configuration.
    """
    kps1 = detect_keypoints(image1, config.detector)
    kps2 = detect_keypoints(image2, config.detector)

    d1 = extract_descriptors(image1, kps1, config.descriptor)
    d2 = extract_descriptors(image2, kps2, config.descriptor)

    matches = match_descriptors(d1, d2, config.matcher)
    dmin, dmax = match_stats(matches)

    p1, p2 = matches.gather_points(kps1, kps2)
    w = matches.mask

    if config.use_ransac:
        est = ransac_fundamental(key, p1, p2, w, config.ransac)
    else:
        # OpenCV CV_FM_7POINT dispatch parity (main.cpp:95-98): 7-point for
        # exactly 7 good matches, normalized 8-point least squares
        # otherwise; among ≤3 root candidates keep the best-supported one.
        F_cand, cand_valid = find_fundamental(p1, p2, w)
        d_cand = sampson_distance(F_cand, p1[None], p2[None])        # [3, M]
        counts = jnp.sum(
            jnp.logical_and(d_cand < config.ransac.inlier_threshold ** 2,
                            w[None]).astype(jnp.int32), axis=-1)
        counts = jnp.where(cand_valid, counts, -1)
        F = F_cand[jnp.argmax(counts)]
        d = sampson_distance(F, p1, p2)
        inl = jnp.logical_and(d < config.ransac.inlier_threshold ** 2, w)
        _, res_mean = epipolar_residual_audit(F, p1, p2, w, form="reference")
        est = TwoViewEstimate(
            F=F,
            inlier_mask=inl,
            num_inliers=jnp.sum(inl.astype(jnp.int32)),
            residual_mean=res_mean,
        )

    residuals, _ = epipolar_residual_audit(est.F, p1, p2, w, form="reference")
    epilines2 = compute_epilines(p1, 1, est.F)

    return TwoViewResult(
        kps1=kps1,
        kps2=kps2,
        matches=matches,
        dist_min=dmin,
        dist_max=dmax,
        estimate=est,
        p1=p1,
        p2=p2,
        residuals=residuals,
        epilines2=epilines2,
    )


def run_two_view_demo(
    path1: str,
    path2: str,
    config: Optional[TwoViewConfig] = None,
    out_dir: Optional[str] = None,
    seed: int = 0,
    verbose: bool = True,
):
    """Host driver reproducing the reference demo's observable behavior:
    prints max/min match distance (``main.cpp:58-59``), each good match
    (``main.cpp:76``), per-match epipolar residuals and their mean
    (``main.cpp:119-123``), and writes the three windows it showed —
    keypoints, matches, epilines — as PNGs (``main.cpp:32-33,84,143``).
    """
    import os

    import numpy as np

    from points_matching.data.images import load_image
    from points_matching.utils.logging import get_logger
    from points_matching.viz.draw import (
        draw_epilines,
        draw_keypoints,
        draw_matches,
        save_png,
    )

    log = get_logger("two_view")
    config = config or surf_parity_config()

    img1 = load_image(path1)
    img2 = load_image(path2)
    image1 = jax.device_put(jnp.asarray(img1))
    image2 = jax.device_put(jnp.asarray(img2))

    res = two_view_pipeline(image1, image2, jax.random.PRNGKey(seed), config)
    res = jax.device_get(res)

    if verbose:
        # the reference's console output, in order (main.cpp:58-59,76,119,123)
        log.info("max match distance: %.6f", float(res.dist_max))
        log.info("min match distance: %.6f", float(res.dist_min))
        n_matches = int(np.asarray(res.matches.mask).sum())
        log.info("good matches: %d", n_matches)
        log.info("num inliers: %d", int(res.estimate.num_inliers))
        log.info("mean |p1' F p2| residual: %.6e", float(res.estimate.residual_mean))

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        save_png(draw_keypoints(img1, res.kps1), os.path.join(out_dir, "keypoints1.png"))
        save_png(
            draw_keypoints(img2, res.kps2, rich=True),
            os.path.join(out_dir, "keypoints2.png"),
        )
        save_png(
            draw_matches(img1, res.kps1, img2, res.kps2, res.matches),
            os.path.join(out_dir, "matches.png"),
        )
        ep_mask = np.asarray(res.matches.mask) & np.asarray(res.estimate.inlier_mask)
        img2_kp = draw_keypoints(img2, res.kps2)
        save_png(
            draw_epilines(img2_kp, np.asarray(res.epilines2), ep_mask),
            os.path.join(out_dir, "epilines.png"),
        )
    return res
