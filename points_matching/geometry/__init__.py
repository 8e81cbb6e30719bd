from points_matching.geometry.homogeneous import (  # noqa: F401
    to_homogeneous,
    from_homogeneous,
    skew,
)
from points_matching.geometry.normalize import hartley_normalize  # noqa: F401
from points_matching.geometry.fundamental import (  # noqa: F401
    eight_point,
    seven_point,
    find_fundamental,
    essential_from_fundamental,
    fundamental_from_essential,
    epipolar_residuals,
    epipolar_residual_audit,
    sampson_distance,
    compute_epilines,
)
from points_matching.geometry.se3 import (  # noqa: F401
    so3_exp,
    so3_log,
    se3_exp,
    se3_log,
)
from points_matching.geometry.pose import (  # noqa: F401
    decompose_essential,
    recover_pose,
)
from points_matching.geometry.triangulate import triangulate_dlt  # noqa: F401
from points_matching.geometry.ransac import ransac_fundamental  # noqa: F401
from points_matching.geometry.pnp import (  # noqa: F401
    pnp_dlt,
    pnp_refine,
    ransac_pnp,
)
