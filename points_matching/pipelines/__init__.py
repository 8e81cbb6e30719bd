from points_matching.pipelines.two_view import (  # noqa: F401
    two_view_pipeline,
    TwoViewResult,
    run_two_view_demo,
)
from points_matching.pipelines.distributed_slam import (  # noqa: F401
    DistributedSlamResult,
    build_submap,
    build_submaps,
    run_distributed_slam,
)
