from points_matching.data import synthetic  # noqa: F401
