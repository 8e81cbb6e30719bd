from points_matching.ba.lm import bundle_adjust, BAState  # noqa: F401
from points_matching.ba.residuals import reprojection_residuals  # noqa: F401
from points_matching.ba.pose_graph import optimize_pose_graph  # noqa: F401
from points_matching.ba.sparse import (  # noqa: F401
    SparseBAState,
    bundle_adjust_sparse,
    make_sparse_ba_state,
)
