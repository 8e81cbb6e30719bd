from points_matching.viz.draw import (  # noqa: F401
    draw_keypoints,
    draw_matches,
    draw_epilines,
    save_png,
)
