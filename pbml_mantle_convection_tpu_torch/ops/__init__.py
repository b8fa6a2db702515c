from . import curl, resize, stencils  # noqa: F401
