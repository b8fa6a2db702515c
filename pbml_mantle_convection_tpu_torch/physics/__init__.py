from . import advection, viscosity  # noqa: F401
