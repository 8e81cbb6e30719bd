from points_matching.utils import metrics, logging  # noqa: F401
