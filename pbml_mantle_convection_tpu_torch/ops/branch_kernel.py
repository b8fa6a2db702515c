"""``layer_stack``: stacks of FluidLayers as one call.

Replaces the TPU kernel ``pbml_mantle_convection_tpu/ops/branch_kernel.py::
_stack_kernel`` (``LayerStack``), every instance of it: learned-boundary
layers (``learned=True``) and zero-padded ones (``learned=False``: a 5×5
SAME conv over the zero-padded field with the conv's own bias), each with
any of the seven activations of ``models/layers.py`` (the JAX kernel's
``act``; ``StackWeights.act``). On a CUDA tensor :func:`layer_stack` and
:func:`layer_stacks` launch the hand-written kernels of
``csrc/layer_stack.cu``; on a CPU tensor they run
:func:`layer_stack_plain`, the same function in plain PyTorch (learned: 9
VALID ``F.conv2d`` + ``torch.cat`` in the stitch order of the reference;
zero: ``F.conv2d(F.pad(x, (2, 2, 2, 2)), w, b)``; then ``F.group_norm``
and the activation of ``models/layers.py::get_activation``).

What was built for the card (the note at the top of
``csrc/layer_stack.cu`` has the detail): one launch per layer, in which the
5×5 conv of the interior and of the boundary ring runs on the tensor cores
as an implicit GEMM in 3xTF32 (float32 accuracy), the previous layer's
GroupNorm and activation are applied while the input is staged, and the
last block of each field turns per-block double sums into the layer's
GroupNorm statistics; one more pass after the last GroupNorm layer. The
five pyramid levels' branch stacks share each launch
(:func:`layer_stacks`), and the stem's last pass also writes the pyramid
inputs (``pyramid``).

Fields are planar (C, H, W) tensors of one simulation (B = 1).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from ..models.layers import blc_conv2d, float32_convs, get_activation
from ..utils.profiling import span
from . import _cuda
from .resize import avg_pool_nchw

# successive 2×2 pools the stem's last pass can write
MAX_PYRAMID = 4
# the activation codes of the C entry points (csrc/blc_layer.cuh::Act; 0
# applies none): every activation of models/layers.py has its instance
ACT_CODES = {"gelu": 1, "selu": 2, "elu": 3, "silu": 4, "relu": 5,
             "tanh": 6, "sine": 7}


def act_code(name: str) -> int:
    """The kernels' code of activation ``name``; an activation without a
    kernel instance raises."""
    try:
        return ACT_CODES[name]
    except KeyError:
        raise ValueError(f"the layer kernels have no instance of activation "
                         f"{name!r}; they take {sorted(ACT_CODES)}") from None


def _tf32(w: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (10 mantissa bits, ties away from
    zero: PTX ``cvt.rna.tf32.f32``), as float32."""
    b = w.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def weight_fragments(ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """One layer's OIHW kernels (c_o, c_in, 5, 5), one per weight class (9
    for the learned-boundary conv, 1 for the zero-padded one), as the
    kernel's mma B fragments: (class, 8-channel input chunk q, tap,
    8-channel output tile j, lane, 4), one class's chunk contiguous as the
    kernel copies it to shared memory. Lane 4·g + t holds, for co = 8j +
    g, the weights of ci = 8q + t and 8q + t + 4, each split into TF32 hi
    and lo parts: [hi(t), hi(t+4), lo(t), lo(t+4)]. Channels past c_in or
    c_o are 0."""
    n = len(ws)
    c_o, c_in = ws[0].shape[:2]
    nq, nj = math.ceil(c_in / 8), math.ceil(c_o / 8)
    w = torch.zeros(n, 25, nq * 8, nj * 8, device=ws[0].device)
    w[:, :, :c_in, :c_o] = (torch.stack([k.detach().float() for k in ws])
                            .reshape(n, c_o, c_in, 25).permute(0, 3, 2, 1))
    # (class, tap, q, k, j, g) → (class, q, tap, j, g, k)
    b = w.reshape(n, 25, nq, 8, nj, 8).permute(0, 2, 1, 4, 5, 3)
    b0, b1 = b[..., :4], b[..., 4:]
    h0, h1 = _tf32(b0), _tf32(b1)
    frag = torch.stack([h0, h1, _tf32(b0 - h0), _tf32(b1 - h1)], dim=-1)
    return frag.reshape(-1).contiguous()


@dataclasses.dataclass(frozen=True)
class StackWeights:
    """Weights of R layers with c_o outputs each: learned-boundary layers,
    or zero-padded ones when ``zero_pad``; ``act`` names the activation
    that ``use_act`` applies after each layer (a key of ``ACT_CODES``).

    ``kernels[i]`` holds layer i's OIHW 5×5 kernels, 9 in ``BLC_CLASSES``
    order or the one zero-padded conv's (the plain version reads them);
    ``frag`` is the same weights as the layers' :func:`weight_fragments`
    back to back (the kernel reads them).
    """

    kernels: tuple
    frag: torch.Tensor
    bias: torch.Tensor        # (R, c_o)
    gn_scale: torch.Tensor    # (R, c_o)
    gn_bias: torch.Tensor     # (R, c_o)
    c_in: int
    c_o: int
    groups: int
    use_gn: bool
    use_act: bool
    zero_pad: bool = False
    act: str = "gelu"

    @property
    def R(self) -> int:
        return len(self.kernels)


def pack_stack(layers: Sequence, groups: int, use_gn: bool = True,
               use_act: bool = True, act: str = "gelu") -> StackWeights:
    """``layers``: per layer (its OIHW 5×5 kernels, bias (c_o,), gn scale,
    gn bias): 9 kernels in ``BLC_CLASSES`` order for a learned-boundary
    layer and its learnable bias, or 1 for a zero-padded SAME conv and
    the conv's bias; the GN tensors may be None when ``use_gn`` is off.
    Every layer has the same kind, and every layer after the first maps
    c_o → c_o. ``act``: the activation's name (``ACT_CODES``)."""
    act_code(act)
    with torch.no_grad():
        kernels = tuple(tuple(k.detach() for k in ws)
                        for ws, _, _, _ in layers)
        n_cls = len(kernels[0])
        if n_cls not in (1, 9) or any(len(ws) != n_cls for ws in kernels):
            raise ValueError("each layer needs 9 learned-boundary kernels "
                             "or 1 zero-padded one, all layers alike")
        if any(k.shape[-2:] != (5, 5) for ws in kernels for k in ws):
            raise ValueError("the layer kernels take 5×5 convs")
        c_o, c_in = kernels[0][0].shape[:2]
        for ws in kernels[1:]:
            if ws[0].shape[1] != c_o:
                raise ValueError("layers after the first must map c_o → c_o")
        frag = torch.cat([weight_fragments(ws) for ws in kernels])
        ones = torch.ones_like(layers[0][1])
        bias = torch.stack([b.detach() for _, b, _, _ in layers])
        gs = torch.stack([(s if s is not None else ones).detach()
                          for _, _, s, _ in layers])
        gb = torch.stack([(b if b is not None else 0 * ones).detach()
                          for _, _, _, b in layers])
    return StackWeights(kernels, frag, bias.contiguous(), gs.contiguous(),
                        gb.contiguous(), int(c_in), int(c_o), groups,
                        use_gn, use_act, n_cls == 1, act)


def zero_pad_conv2d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """The zero instance's conv: a 5×5 SAME conv of the zero-padded
    (B, C, H, W) field, plus bias."""
    with float32_convs(x):
        return F.conv2d(F.pad(x, (2, 2, 2, 2)), w, bias)


def layer_stack_plain(x: torch.Tensor, sw: StackWeights, pool: bool = False,
                      pyramid: int = 0):
    """Plain PyTorch version of :func:`layer_stack`."""
    pooled = avg_pool_nchw(x, 2) if pool else None
    act = get_activation(sw.act)
    y = x[None]
    for i in range(sw.R):
        if sw.zero_pad:
            y = zero_pad_conv2d(y, sw.kernels[i][0], sw.bias[i])
        else:
            y = blc_conv2d(y, sw.kernels[i], sw.bias[i])
        if sw.use_gn:
            y = F.group_norm(y, sw.groups, sw.gn_scale[i], sw.gn_bias[i],
                             eps=1e-5)
        if sw.use_act:
            y = act(y)
    y = y[0]
    if pyramid:
        pooled = [avg_pool_nchw(y, 2)]
        for _ in range(pyramid - 1):
            pooled.append(avg_pool_nchw(pooled[-1], 2))
    return y, pooled


def layer_stacks_plain(xs: Sequence[torch.Tensor],
                       sws: Sequence[StackWeights]) -> list:
    """Plain PyTorch version of :func:`layer_stacks`."""
    return [layer_stack_plain(x, sw)[0] for x, sw in zip(xs, sws)]


def _launch(xs, sws, pool: bool = False, pyramid: int = 0):
    """One ``pmc_layer_stacks`` call over the fields ``xs``."""
    sw = sws[0]
    dev = xs[0].device
    for s in sws[1:]:
        if (s.R, s.c_in, s.c_o, s.groups, s.use_gn, s.use_act,
                s.zero_pad, s.act) != (sw.R, sw.c_in, sw.c_o, sw.groups,
                                       sw.use_gn, sw.use_act, sw.zero_pad,
                                       sw.act):
            raise ValueError("layer_stacks: the stacks differ in shape")
    if not 1 <= len(xs) <= _cuda.MAX_LEVELS or len(xs) != len(sws):
        raise ValueError(f"layer_stacks: 1..{_cuda.MAX_LEVELS} fields, one "
                         f"stack each; got {len(xs)} and {len(sws)}")
    for x, s in zip(xs, sws):
        _cuda.check_cuda("layer_stack x", x, torch.float32)
        if x.dim() != 3 or x.shape[0] != sw.c_in:
            raise ValueError(f"layer_stack x: expected ({sw.c_in}, H, W), "
                             f"got {tuple(x.shape)}")
        for name in ("frag", "bias", "gn_scale", "gn_bias"):
            t = getattr(s, name)
            _cuda.check_cuda_f32(f"layer_stack {name}", t)
            if t.device != dev or x.device != dev:
                raise ValueError(f"layer_stack {name} is on {t.device}, "
                                 f"x on {x.device}")
    hw = [(x.shape[1], x.shape[2]) for x in xs]
    if not sw.zero_pad and min(min(h, w) for h, w in hw) < 6:
        raise ValueError(f"layer_stack: learned-boundary fields must be at "
                         f"least 6×6: {hw}")
    H, W = hw[0]
    if not 0 <= pyramid <= MAX_PYRAMID or min(H, W) >> pyramid < 1:
        raise ValueError(f"layer_stack: pyramid={pyramid} at {H}×{W}")
    lib = _cuda.library()
    ys = [torch.empty((sw.c_o, h, w), device=dev) for h, w in hw]
    scratch = ([torch.empty_like(y) for y in ys] if sw.R > 1
               else [None] * len(xs))
    groups = sw.groups if sw.use_gn else 1
    stats = torch.empty((len(xs) * sw.R * groups * 2,), device=dev)
    stride = max(_cuda.work_items(h, w, sw.zero_pad)
                 for h, w in hw) * sw.c_o * 2
    partial = torch.empty((len(xs) * stride,), dtype=torch.float64,
                          device=dev)
    pooled = (torch.empty((sw.c_in, H // 2, W // 2), device=dev)
              if pool else None)
    pyr = [torch.empty((sw.c_o, H >> l, W >> l), device=dev)
           for l in range(1, pyramid + 1)]

    def ptrs(ts):
        return (ctypes.c_void_p * len(ts))(*[_cuda.ptr(t) for t in ts])

    err = lib.pmc_layer_stacks(
        len(xs), ptrs(xs), ptrs(ys), ptrs(scratch),
        (ctypes.c_int * (2 * len(xs)))(*[v for p in hw for v in p]),
        ptrs([s.frag for s in sws]), ptrs([s.bias for s in sws]),
        ptrs([s.gn_scale for s in sws]), ptrs([s.gn_bias for s in sws]),
        stats.data_ptr(), partial.data_ptr(), stride,
        _cuda.counters(dev).data_ptr(), ptrs(pyr or [None]), pyramid,
        _cuda.ptr(pooled), sw.c_in, sw.c_o, sw.R, groups, int(sw.use_gn),
        act_code(sw.act) if sw.use_act else 0, int(sw.zero_pad),
        _cuda.stream(xs[0]))
    layer_stack.launches += 1
    _cuda.raise_on_error(err, "layer_stack")
    return ys, pooled, pyr


def layer_stack(x: torch.Tensor, sw: StackWeights, pool: bool = False,
                pyramid: int = 0):
    """R layers on ``x`` (c_in, H, W) → (y (c_o, H, W),
    extra): extra is the VALID 2×2 average pool of ``x`` when ``pool``,
    the list of ``pyramid`` successive VALID 2×2 pools of ``y`` (odd sizes
    floor) when ``pyramid`` > 0, else None."""
    if pool and pyramid:
        raise ValueError("layer_stack: pool and pyramid are exclusive")
    with span("pmc.kernel.layer_stack"):
        if x.device.type == "cpu":
            return layer_stack_plain(x, sw, pool, pyramid)
        ys, pooled, pyr = _launch([x], [sw], pool, pyramid)
        return ys[0], (pyr if pyramid else pooled)


def layer_stacks(xs: Sequence[torch.Tensor],
                 sws: Sequence[StackWeights]) -> list:
    """Stacks of equal R, c_in, c_o, norm flags and activation on up to
    five fields of any sizes (the pyramid levels' branches) → their
    outputs; on the card layer r of every field runs in one launch."""
    with span("pmc.kernel.layer_stack"):
        if xs[0].device.type == "cpu":
            return layer_stacks_plain(xs, sws)
        return _launch(list(xs), list(sws))[0]


layer_stack.launches = 0
