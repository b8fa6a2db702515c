"""``layer_stack``: a stack of learned-boundary FluidLayers as one call.

Replaces the TPU kernel ``pbml_mantle_convection_tpu/ops/branch_kernel.py::
_stack_kernel`` (``LayerStack``). On a CUDA tensor it launches the
hand-written kernels of ``csrc/layer_stack.cu``; on a CPU tensor it runs
:func:`layer_stack_plain`, the same function in plain PyTorch (9 VALID
``F.conv2d`` + ``torch.cat`` in the stitch order of the reference, then
``F.group_norm`` and exact ``F.gelu``).

What bounds it on the card, and how the kernel is laid out against that,
is written at the top of ``csrc/layer_stack.cu``: operations (float32 FMAs
of the 5×5 convs); a shared-memory tiled interior conv with all output
channels in registers, a small direct kernel for the boundary ring, and
GroupNorm statistics as double-precision per-block partial sums.

Fields are planar (C, H, W) tensors of one simulation (B = 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..models.layers import blc_conv2d
from . import _cuda
from .resize import avg_pool_nchw


@dataclasses.dataclass(frozen=True)
class StackWeights:
    """Weights of R learned-boundary layers with c_o outputs each.

    ``kernels[i]`` holds layer i's 9 OIHW kernels in ``BLC_CLASSES``
    order (the plain version reads them); ``packed`` is the same weights
    as back-to-back (9, c_in_i, 25, c_o) blocks (the kernel reads them).
    """

    kernels: tuple
    packed: torch.Tensor
    bias: torch.Tensor        # (R, c_o)
    gn_scale: torch.Tensor    # (R, c_o)
    gn_bias: torch.Tensor     # (R, c_o)
    c_in: int
    c_o: int
    groups: int
    use_gn: bool
    use_act: bool

    @property
    def R(self) -> int:
        return len(self.kernels)


def pack_stack(layers: Sequence, groups: int, use_gn: bool = True,
               use_act: bool = True) -> StackWeights:
    """``layers``: per layer (9 OIHW kernels, bias (c_o,), gn scale,
    gn bias); the GN tensors may be None when ``use_gn`` is off. Every
    layer after the first maps c_o → c_o."""
    with torch.no_grad():
        kernels = tuple(tuple(k.detach() for k in w9)
                        for w9, _, _, _ in layers)
        c_o, c_in = kernels[0][0].shape[:2]
        for w9 in kernels[1:]:
            if w9[0].shape[1] != c_o:
                raise ValueError("layers after the first must map c_o → c_o")
        packed = torch.cat([
            torch.stack(w9).permute(0, 2, 3, 4, 1).reshape(-1)
            for w9 in kernels]).contiguous()
        ones = torch.ones_like(layers[0][1])
        bias = torch.stack([b.detach() for _, b, _, _ in layers])
        gs = torch.stack([(s if s is not None else ones).detach()
                          for _, _, s, _ in layers])
        gb = torch.stack([(b if b is not None else 0 * ones).detach()
                          for _, _, _, b in layers])
    return StackWeights(kernels, packed, bias.contiguous(), gs.contiguous(),
                        gb.contiguous(), int(c_in), int(c_o), groups,
                        use_gn, use_act)


def layer_stack_plain(x: torch.Tensor, sw: StackWeights, pool: bool = False
                      ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of :func:`layer_stack`."""
    pooled = avg_pool_nchw(x, 2) if pool else None
    y = x[None]
    for i in range(sw.R):
        y = blc_conv2d(y, sw.kernels[i], sw.bias[i])
        if sw.use_gn:
            y = F.group_norm(y, sw.groups, sw.gn_scale[i], sw.gn_bias[i],
                             eps=1e-5)
        if sw.use_act:
            y = F.gelu(y)
    return y[0], pooled


def layer_stack(x: torch.Tensor, sw: StackWeights, pool: bool = False
                ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """R learned-boundary layers on ``x`` (c_in, H, W) → (y (c_o, H, W),
    the VALID 2×2 average pool of ``x`` when ``pool`` else None)."""
    if x.device.type == "cpu":
        return layer_stack_plain(x, sw, pool)
    C, H, W = x.shape
    _cuda.check_cuda_f32("layer_stack x", x, (sw.c_in, H, W))
    for name in ("packed", "bias", "gn_scale", "gn_bias"):
        t = getattr(sw, name)
        _cuda.check_cuda_f32(f"layer_stack {name}", t)
        if t.device != x.device:
            raise ValueError(f"layer_stack {name} is on {t.device}, "
                             f"x on {x.device}")
    lib = _cuda.library()
    y = torch.empty((sw.c_o, H, W), device=x.device)
    scratch = torch.empty_like(y) if sw.R > 1 else None
    stats = torch.empty((_cuda.gn_stats_len(sw.groups),),
                        dtype=torch.float64, device=x.device)
    pooled = (torch.empty((C, H // 2, W // 2), device=x.device)
              if pool else None)
    err = lib.pmc_layer_stack(
        x.data_ptr(), y.data_ptr(), _cuda.ptr(scratch), stats.data_ptr(),
        sw.packed.data_ptr(), sw.bias.data_ptr(), sw.gn_scale.data_ptr(),
        sw.gn_bias.data_ptr(), _cuda.ptr(pooled), sw.c_in, sw.c_o, H, W,
        sw.R, sw.groups, int(sw.use_gn), int(sw.use_act), _cuda.stream(x))
    layer_stack.launches += 1
    _cuda.raise_on_error(err, "layer_stack")
    return y, pooled


layer_stack.launches = 0
