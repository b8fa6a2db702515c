from .grid import DEFAULT_GRID, Grid  # noqa: F401
