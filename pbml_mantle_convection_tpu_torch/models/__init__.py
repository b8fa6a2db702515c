from .fluidnet import (  # noqa: F401
    FluidNet, HalfNewFluidNet, MultiScaleNewFluidNet, NewFluidNet)
from .layers import (  # noqa: F401
    BoundaryLearnedConvolution2D, Conv2dTorch, FluidLayer, SpectralConv2d,
    SpectralFluidLayer, SymmetricConv2d)
from .registry import ModelConfig, build_model  # noqa: F401
from .transolver import (  # noqa: F401
    PhysicsAttentionIrregularMesh, PhysicsAttentionStructuredMesh2D,
    TransolverIrregular, TransolverStructured2D)
from .unet import ConvAE, Unet  # noqa: F401
from .vit import ViT  # noqa: F401
