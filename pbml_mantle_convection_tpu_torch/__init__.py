"""PyTorch/CUDA port of ``pbml_mantle_convection_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference; this package imports none of
it. Entry points run on the card unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

from . import constants  # noqa: F401,E402
