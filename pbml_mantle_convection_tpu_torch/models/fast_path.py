"""Fused executor of a NewFluidNet: the network as 4 + 1 kernel calls.

Counterpart of the JAX package's ``models/fast_path.py::FastNewFluidNet``
with ``megakernel=True``: stem (``layer_stack``, also emitting the
successive 2×2 pools of its output: the pyramid levels' inputs) → the
branch stacks of every level in one ``layer_stacks`` call → ``trunk``
(bicubic upsampling + merge-1 + GN0 + act) → merge 2 (act, no GN) →
merge 3 (plain) → the head's c_o raw channels (the stream function ψ
of the curl head), where act is the model's ``act_fn`` (each of the
seven activations has its kernel instances). For a plain curl head the
engine hands ψ to the fused curl + advection epilogue
(``ops/epilogue_kernel.py``); other heads go through the module's head.
On the card that is 13 kernel launches per forward: stem 2, branches 6
+ 1, trunk 2, merges 1 + 1.

Fields are dense planar (C, H, W) tensors of one simulation (B = 1); the
TPU block layouts of the JAX executor do not exist here. On CUDA tensors
every stage is a hand-written kernel; on CPU tensors each stage runs its
plain PyTorch version.

Supported: the flagship form — k = 5, pooling factor 2, c_h 8 or 16,
any activation of ``models/layers.py``, with or without ``blurr`` — with
any head JAX's executor runs: the curl head (c_o = 1, or 2 with the
pressure output ``p_pred``) or the ``mae``/``mass`` heads (u, v and with
``p_pred`` p: c_o = 2 or 3), merge 3 a ``layer_stack`` of the model's
c_o; and with either padding the JAX executor takes: learned padding
(every layer a learned-boundary conv, the kernels' learned instance) or
zero padding (``r_p="zeros"``: every layer a zero-padded SAME conv with
its own bias, the kernels' zero instance; the 3×3 merge convs run as
5×5 kernels with a zero ring, the same function). The constructor
raises on anything else; :func:`executor_or_module` is how the CLIs
choose between it and the module.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from ..ops.branch_kernel import (StackWeights, layer_stack, layer_stacks,
                                 pack_stack)
from ..ops.merge_kernel import trunk, trunk_weights
from ..utils.profiling import span
from .fluidnet import NewFluidNet
from .layers import BoundaryLearnedConvolution2D, fluid_layer_groups


# the JAX CLI's failures in bfloat16 on its fused executor (the port's
# kernels of it are float32): where JAX fails, the port refuses, and why
BF16_LEARNED = (
    "the fused executor in bfloat16 with learned padding: JAX's builds the "
    "boundary bands from float32 resize matrices and bfloat16 slabs and "
    "fails (fast_path.py::_bands_from_slabs, a TypeError: "
    "'lax.conv_general_dilated requires arguments to have the same "
    "dtypes, got float32, bfloat16')")
BF16_ZERO_ROLLOUT = (
    "a bfloat16 rollout through the fused executor with zero padding: "
    "JAX's step returns T, u, v and t in float32 from a bfloat16 state, "
    "and its lax.scan refuses the changed carry (a TypeError: 'scan body "
    "function carry input and carry output must have equal types')")


def refusal_reason(m) -> Optional[str]:
    """Why JAX's ``FastNewFluidNet`` constructor raises on ``m``
    (fast_path.py:177-186), or None: a network that is no NewFluidNet,
    symmetric or dilated convs, spectral convs or dropout, a padding
    other than learned or zeros."""
    if not isinstance(m, NewFluidNet):
        return f"{type(m).__name__} (the executor runs NewFluidNet)"
    if m.use_symm or m.dilation != 1:
        return (f"use_symm={m.use_symm}, dilation={m.dilation} (needs "
                f"plain convs, dilation 1)")
    if m.spectral_conv or m.drop_rate:
        return (f"spectral_conv={m.spectral_conv}, drop_rate={m.drop_rate} "
                f"(no spectral convs or dropout)")
    if m.r_p not in ("learned", "zeros"):
        return f"r_p={m.r_p!r} (needs learned or zero padding)"
    return None


def unsupported_reason(m) -> Optional[str]:
    """Why the fused executor cannot run ``m``, or None: what JAX's
    constructor refuses (:func:`refusal_reason`), and what JAX's
    megakernel gate sends to its standard path (``_mk_unsupported``,
    fast_path.py:228-271: k ≠ 5, factor ≠ 2; here also c_h ∉ {8, 16},
    the widths the layer kernels are built for). It runs learned and
    zero padding, ``blurr`` (the module's head blurs the stream
    function; the engine then takes no fused epilogue), every head
    (merge 3 at the model's c_o; :meth:`NewFluidNet.head` splits the
    channels), and any activation of ``models/layers.py`` (each has its
    kernel instances; ``ops/branch_kernel.py::act_code`` raises on one
    that has none)."""
    reason = refusal_reason(m)
    if reason is not None:
        return reason
    if m.f != 5:
        return f"k={m.f} (needs 5)"
    if m.factor != 2:
        return f"factor={m.factor} (needs 2)"
    if m.c_h not in (8, 16):
        return f"c_h={m.c_h} (the kernels are built for 8 or 16)"
    return None


def executor_or_module(model, H: int, W: int):
    """The NewFluidNet ``model`` as JAX's ``FastNewFluidNet(model, ...)``
    computes it on an H × W grid, chosen from the configuration alone:
    (the fused executor, its route line) where the executor runs it,
    else (``model``, the route line with the gate's reason) — the
    function JAX's executor computes on its standard path when its
    megakernel gate refuses. Raises ValueError where JAX's constructor
    raises (:func:`refusal_reason`)."""
    reason = refusal_reason(model)
    if reason is not None:
        raise ValueError(f"FastNewFluidNet: unsupported config: {reason}")
    reason = unsupported_reason(model)
    if reason is not None:
        return model, f"route: module ({reason})"
    return (FastNewFluidNet(model, H, W),
            f"route: fused executor (c_o={model.c_o}, {model.loss_type} "
            f"head{', p_pred' if model.p_pred else ''})")


def conv_weights(conv) -> tuple:
    """A layer's conv as ``pack_stack`` takes it: (its 9 kernels, its
    learnable bias) for a learned-boundary conv; ((its kernel as 5×5,),
    its bias) for a zero-padded SAME conv — a k×k kernel with (k-1)/2
    zeros on each side is the same function on a field padded by 2."""
    if isinstance(conv, BoundaryLearnedConvolution2D):
        return conv.kernels(), conv.learnable_bias
    k = conv.weight.shape[-1]
    if (conv.pad_mode != "constant" or k % 2 == 0 or k > 5
            or conv.pad != ((k - 1) // 2,) * 4 or conv.bias is None):
        raise ValueError(f"FastNewFluidNet: a {k}×{k} conv with padding "
                         f"{conv.pad} ({conv.pad_mode}) is no zero-padded "
                         f"SAME conv with bias")
    p = (5 - k) // 2
    return (torch.nn.functional.pad(conv.weight.detach(), (p, p, p, p)),
            ), conv.bias


class FastNewFluidNet:
    """Fused executor of ``model`` on an H × W grid (see module doc).

    ``fast(x)`` with x (1, H, W, c_i) NHWC returns (u, v, p|None) like
    the module (p with ``p_pred``); ``fast.psi(x)`` with x (c_i, H, W)
    planar returns merge 3's raw (c_o, H, W) output (the stepper builds
    that input: ``sim/stepper.py::TimeStepper.executor_input``).
    """

    def __init__(self, model: NewFluidNet, H: int, W: int):
        reason = unsupported_reason(model)
        if reason is not None:
            raise ValueError(f"FastNewFluidNet: unsupported config: {reason}")
        model.check_size(H, W)
        self.m = model
        self.H, self.W = H, W
        g = fluid_layer_groups(model.c_h)
        act = model.act_fn

        def fluid(layers) -> StackWeights:
            return pack_stack([(*conv_weights(lay.conv), lay.gn.weight,
                                lay.gn.bias) for lay in layers], groups=g,
                              act=act)

        def merge(conv, gn=None, use_act=True) -> StackWeights:
            return pack_stack(
                [(*conv_weights(conv),
                  gn.weight if gn is not None else None,
                  gn.bias if gn is not None else None)],
                groups=max(1, model.c_h // 4) if gn is not None else 1,
                use_gn=gn is not None, use_act=use_act, act=act)

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

    @property
    def zero_pad(self) -> bool:
        """Whether the layers run the kernels' zero-padded instance."""
        return self.stem.zero_pad

    def psi(self, x: torch.Tensor) -> torch.Tensor:
        """(c_i, H, W) planar input → merge 3's raw (c_o, H, W) output:
        the stream function (and p) of the curl head, u, v (and p) of
        the ``mae``/``mass`` heads, before the mean subtraction."""
        with span("pmc.executor"):
            b_in, pyr = layer_stack(x, self.stem,
                                    pyramid=len(self.branches) - 1)
            outs = layer_stacks([b_in, *(pyr or [])], self.branches)
            y = trunk(outs[0], outs[1:], x, self.trunk)
            y, _ = layer_stack(y, self.merge2)
            y, _ = layer_stack(y, self.merge3)
            return y

    def __call__(self, x: torch.Tensor):
        """(1, H, W, c_i) NHWC input → (u, v, p|None), each (1, H, W)."""
        if x.shape[0] != 1:
            raise ValueError("FastNewFluidNet runs one simulation (B=1)")
        psi = self.psi(x[0].permute(2, 0, 1).contiguous())
        return self.m.head(psi[None])

    @classmethod
    def float32_of(cls, model: NewFluidNet, H: int, W: int):
        """The executor of a bfloat16 ``model`` as JAX's runs it: JAX's
        executor takes the bfloat16 weights, and its float32 constants
        promote what follows them, so it returns float32 (its CLI's
        ``--what inference -pad zeros --dtype bfloat16``). The kernels
        here are float32 throughout: the executor of a float32 copy of
        the weights (every bfloat16 value is a float32 one). Feed it the
        input in float32; it returns float32."""
        return cls(copy.deepcopy(model).float(), H, W)
