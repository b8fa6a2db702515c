"""Fused executor of a NewFluidNet: the network as 8 + 1 kernel calls.

Counterpart of the JAX package's ``models/fast_path.py::FastNewFluidNet``
with ``megakernel=True``: stem → one ``layer_stack`` per pyramid level
(each also emitting the 2×2 pool of its input, the next level's input) →
``trunk`` (bicubic upsampling + merge-1 + GN0 + GELU) → merge 2 (GELU, no
GN) → merge 3 (plain) → the raw stream function ψ. The engine hands ψ to
the fused curl + advection epilogue (``ops/epilogue_kernel.py``).

Fields are dense planar (C, H, W) tensors of one simulation (B = 1); the
TPU block layouts of the JAX executor do not exist here. On CUDA tensors
every stage is a hand-written kernel; on CPU tensors each stage runs its
plain PyTorch version.

Supported: the flagship form — learned padding with k = 5, pooling factor
2, GELU, curl head with c_o = 1 and no pressure output. The constructor
raises on anything else.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..constants import COORD_SCALE, visc_feature
from ..ops.branch_kernel import StackWeights, layer_stack, pack_stack
from ..ops.merge_kernel import trunk, trunk_weights
from ..physics.viscosity import fk_viscosity_clipped
from .fluidnet import NewFluidNet
from .layers import fluid_layer_groups


def _unsupported(m: NewFluidNet) -> Optional[str]:
    if m.r_p != "learned" or m.f != 5:
        return f"r_p={m.r_p!r}, f={m.f} (needs learned padding, k=5)"
    if m.factor != 2:
        return f"factor={m.factor} (needs 2)"
    if m.act_fn != "gelu":
        return f"act_fn={m.act_fn!r} (the kernels apply exact GELU)"
    if m.loss_type != "curl" or m.c_o != 1 or m.p_pred:
        return "needs the curl head with c_o=1 and no pressure output"
    if m.c_h not in (8, 16):
        return f"c_h={m.c_h} (the kernels are built for 8 or 16)"
    return None


class FastNewFluidNet:
    """Fused executor of ``model`` on an H × W grid (see module doc).

    ``fast(x)`` with x (1, H, W, c_i) NHWC returns (u, v, None) like the
    module; ``fast.apply_psi_from_T(T)`` returns the raw stream function
    from a (1, H, W) temperature once :meth:`bind_input_assembly` has
    fixed the grid's static input channels.
    """

    def __init__(self, model: NewFluidNet, H: int, W: int):
        reason = _unsupported(model)
        if reason is not None:
            raise ValueError(f"FastNewFluidNet: unsupported config: {reason}")
        model.check_size(H, W)
        self.m = model
        self.H, self.W = H, W
        g = fluid_layer_groups(model.c_h)

        def fluid(layers) -> StackWeights:
            return pack_stack([(lay.conv.kernels(), lay.conv.learnable_bias,
                                lay.gn.weight, lay.gn.bias)
                               for lay in layers], groups=g)

        def merge(blc, gn=None, use_act=True) -> StackWeights:
            return pack_stack(
                [(blc.kernels(), blc.learnable_bias,
                  gn.weight if gn is not None else None,
                  gn.bias if gn is not None else None)],
                groups=max(1, model.c_h // 4) if gn is not None else 1,
                use_gn=gn is not None, use_act=use_act)

        self.stem = fluid([model.conv_0])
        self.branches = [
            fluid([getattr(model, f"convs_{l}_{r}")
                   for r in range(model.repeats)])
            for l in range(model.levels)]
        coarse_hw = [(H // 2 ** l, W // 2 ** l)
                     for l in range(1, model.levels)]
        self.trunk = trunk_weights(merge(model.conv_1, model.gn_0),
                                   coarse_hw, H, W)
        self.merge2 = merge(model.conv_2)
        self.merge3 = merge(model.conv_3, use_act=False)
        # set by bind_input_assembly
        self._static_x = self._depth = None
        self._in_static = self._in_params = None

    def psi(self, x: torch.Tensor) -> torch.Tensor:
        """(c_i, H, W) planar input → (1, H, W) raw stream function."""
        b_in, _ = layer_stack(x, self.stem)
        outs = []
        last = len(self.branches) - 1
        for l, sw in enumerate(self.branches):
            y, b_in = layer_stack(b_in, sw, pool=l < last)
            outs.append(y)
        y = trunk(outs[0], outs[1:], x, self.trunk)
        y, _ = layer_stack(y, self.merge2)
        y, _ = layer_stack(y, self.merge3)
        return y

    def __call__(self, x: torch.Tensor):
        """(1, H, W, c_i) NHWC input → (u, v, None), each (1, H, W)."""
        if x.shape[0] != 1:
            raise ValueError("FastNewFluidNet runs one simulation (B=1)")
        psi = self.psi(x[0].permute(2, 0, 1).contiguous())
        return self.m.head(psi[None])

    def bind_input_assembly(self, static, params) -> None:
        """Fix the five input channels that are constants of the
        (grid, params) pair (xc/4, yc/4, raq, fkt, fkp); per step only
        the viscosity and temperature channels change
        (``sim/stepper.py::assemble_fluidnet_input``)."""
        z = torch.zeros_like(static.xc_feat)
        self._static_x = torch.stack(
            [static.xc_feat, static.yc_feat, z, static.raq_nd,
             static.fkt_nd, static.fkp_nd, z]).contiguous()
        self._depth = (1.0 - static.yc_feat * COORD_SCALE).contiguous()
        self._in_static, self._in_params = static, params

    def input_from_T(self, T: torch.Tensor, V=None) -> torch.Tensor:
        """(1, H, W) temperature → (7, H, W) planar network input."""
        if V is None:
            V = fk_viscosity_clipped(self._in_params.fkt,
                                     self._in_params.fkp, self._depth, T)
        x = self._static_x.clone()
        x[2] = visc_feature(V[0])
        x[6] = T[0]
        return x

    def apply_from_T(self, T: torch.Tensor, V=None):
        """(1, H, W) temperature (and its clipped viscosity, when the
        caller has it) → (u, v, None) through the bound input."""
        return self.m.head(self.psi(self.input_from_T(T, V))[None])

    def apply_psi_from_T(self, T: torch.Tensor, V=None) -> torch.Tensor:
        """(1, H, W) temperature → (1, H, W) raw stream function (merge-3
        output before mean subtraction and a_bound) for the epilogue."""
        return self.psi(self.input_from_T(T, V))
