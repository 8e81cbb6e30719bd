from points_matching.ops.matching import (  # noqa: F401
    distance_matrix,
    match_descriptors,
    knn_match,
)
from points_matching.ops.detect import detect_keypoints  # noqa: F401
from points_matching.ops.descriptors import extract_descriptors  # noqa: F401
