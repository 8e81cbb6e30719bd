from points_matching.core import config, types  # noqa: F401
