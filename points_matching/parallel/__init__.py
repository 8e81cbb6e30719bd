from points_matching.parallel.comm import Comm, set_fault_hook  # noqa: F401
from points_matching.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    initialize_distributed,
    make_mesh,
    replicated,
    shard,
)
from points_matching.parallel.all_pairs import all_pairs_scores  # noqa: F401
from points_matching.parallel.pipeline import (  # noqa: F401
    STAGE_AXIS,
    pipeline_stages,
)
from points_matching.parallel.sharded_ba import (  # noqa: F401
    distributed_bundle_adjust,
    shard_ba_state,
)
