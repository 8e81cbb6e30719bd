#!/usr/bin/env python
"""Two-view demo CLI — the reference console app, reimagined
(``Points Matching/main.cpp:9-146``): loads two images, runs the
two-view pipeline, prints the reference's statistics and writes the three
"windows" (keypoints / matches / epilines) as PNGs.

Usage:
  python examples/two_view_demo.py IMG1 IMG2 [--out OUT_DIR]
      [--config surf_parity|orb|ransac] [--platform cpu|gpu] [--seed N]
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import argparse
import sys


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("img1")
    p.add_argument("img2")
    p.add_argument("--out", default="out_two_view")
    p.add_argument(
        "--config",
        default="ransac",
        choices=["surf_parity", "orb", "ransac"],
        help="surf_parity = reference semantics (midpoint filter, no RANSAC); "
        "ransac = SURF-class + ratio test + batched RANSAC; orb = BASELINE config 0",
    )
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-keypoints", type=int, default=512)
    args = p.parse_args()

    from points_matching.utils.platform import use_platform

    use_platform(args.platform)

    import dataclasses

    from points_matching.core.config import (
        orb_default_config,
        ratio_ransac_config,
        surf_parity_config,
    )
    from points_matching.pipelines.two_view import run_two_view_demo

    if args.config == "ransac":
        cfg = ratio_ransac_config(args.max_keypoints)
    else:
        cfg = (surf_parity_config() if args.config == "surf_parity"
               else orb_default_config())
        cfg = dataclasses.replace(cfg, detector=dataclasses.replace(
            cfg.detector, max_keypoints=args.max_keypoints))

    res = run_two_view_demo(args.img1, args.img2, cfg, out_dir=args.out, seed=args.seed)
    import numpy as np

    print(f"keypoints: {int(np.asarray(res.kps1.mask).sum())} / "
          f"{int(np.asarray(res.kps2.mask).sum())}")
    print(f"good matches: {int(np.asarray(res.matches.mask).sum())}")
    print(f"inliers: {int(res.estimate.num_inliers)}")
    print(f"mean |p1' F p2|: {float(res.estimate.residual_mean):.6e}")
    print(f"F =\n{np.asarray(res.estimate.F)}")
    print(f"wrote {args.out}/keypoints1.png keypoints2.png matches.png epilines.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
