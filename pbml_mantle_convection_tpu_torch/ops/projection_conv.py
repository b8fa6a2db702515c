"""The two conv projections of a structured-mesh Transolver block on the
card.

``in_project_fx`` and ``in_project_x`` of
``models/transolver.py::PhysicsAttentionStructuredMesh2D`` are k × k SAME,
zero-padded convs of one channels-last image. The JAX package leaves them
to XLA (``pbml_mantle_convection_tpu/models/transolver.py``); so does the
port's ``PhysicsAttentionStructuredMesh2D._conv`` (``F.conv2d``) wherever
:func:`route` says "plain".

:func:`projection_conv` launches the hand-written kernel of
``csrc/projection_conv.cu``: one launch computes both 3 × 3 projections
(an implicit GEMM with the two projections' output channels side by side,
3xTF32 products on the tensor cores through wgmma, float32-accurate, the
bias added). It replaces no TPU kernel. What bounds it (operations) and
its design are written at the top of the CUDA source. It reads the
(B, C, H, W) channels-last view of the block's (B, H·W, C) rows where they
lie, pads nothing, and writes each projection into its own channels-last
(B, C_out, H, W) tensor, the layout ``F.conv2d`` gives for such an input,
so the slice kernels read the same views. The weights go in as
:func:`pack_weights` lays them out: split into TF32 hi and lo parts and
cut into the kernel's stage blocks, once for as long as the weights stay
the same (the model keeps the packed tensor), not at every call.

Which path runs (:func:`route`) follows from what the inputs show: float32
tensors on the card, outside autograd, a 3 × 3 kernel, and channel counts
the tiling takes (at least 128 in and 128 out, multiples of 32) take the
kernel; everything else takes the plain path: CPU tensors, inputs that
require grad under grad mode (the kernel has no backward; training runs
the plain path), bfloat16, float16 and float64, other kernel sizes and
narrower channels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profiling import span
from . import _cuda

KERNEL = 3
MIN_CHANNELS = 128
CHANNEL_STEP = 32
# the kernel's tiling (csrc/projection_conv.cu): output channels of a tile,
# input channels of a staged image row (two stages of 16)
TILE_N = 128
ROW_K = 32


def route(device_type: str, dtype: torch.dtype, grad: bool, kernel: int,
          c_in: int, c_out: int) -> str:
    """"kernel" or "plain" for a k × k projection pair from ``c_in`` to
    ``c_out`` channels on inputs on ``device_type`` of ``dtype``, ``grad``
    when autograd records them."""
    if device_type != "cuda" or dtype != torch.float32 or grad:
        return "plain"
    if kernel != KERNEL:
        return "plain"
    if any(c < MIN_CHANNELS or c % CHANNEL_STEP for c in (c_in, c_out)):
        return "plain"
    return "kernel"


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 ``x`` = hi + lo exactly, hi rounded to TF32 (its low 13
    mantissa bits zero) and lo = x - hi: the kernel's split
    (``csrc/pmc_common.cuh::split``) to the bit."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, x - hi


def pack_weights(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """Both projections' (C_out, C, 3, 3) float32 weights as the kernel
    reads them: [2 projections][C_out / 128 tiles, zero-padded][C / 32
    channel rows][3 tap rows][2 stages of 16 channels][hi, lo][3 taps of
    the row][2 steps of 8 channels][16 groups of 8 output channels][2 k
    halves][8 output channels][4]; a stage's block (48 KB) is contiguous.
    Within a step, k-index k < 4 is channel 2k and k ≥ 4 channel
    2(k - 4) + 1, as the kernel's A fragments read the image."""
    if w0.shape != w1.shape or w0.dim() != 4 or w0.shape[2:] != (3, 3):
        raise ValueError(f"pack_weights: two (C_out, C, 3, 3) weights, got "
                         f"{tuple(w0.shape)} and {tuple(w1.shape)}")
    c_out, c_in = w0.shape[:2]
    if c_in % ROW_K:
        raise ValueError(f"pack_weights: C a multiple of {ROW_K}, got "
                         f"{c_in}")
    tiles = -(-c_out // TILE_N)
    parts = []
    for w in (w0, w1):
        w = F.pad(w.detach().to(torch.float32),
                  (0, 0, 0, 0, 0, 0, 0, tiles * TILE_N - c_out))
        # o = 128 tile + 8 group + row;
        # c = 32 chunk + 16 stage + 8 step + 2 k4 + k half
        w = w.reshape(tiles, 16, 8, c_in // ROW_K, 2, 2, 4, 2, 3, 3)
        # tile, chunk, tap row, stage, tap, step, group, k half, row, k4
        w = w.permute(0, 3, 8, 4, 9, 5, 1, 7, 2, 6)
        parts.append(torch.stack(tf32_split(w), dim=4))
    return torch.stack(parts).contiguous()


def _aligned(t) -> bool:
    return t.data_ptr() % 16 == 0


def projection_conv(img, packed, c_out, b0=None, b1=None):
    """``F.conv2d(img, w, b, padding="same")`` for (w, b) = (w0, b0) and
    (w1, b1) in one launch, ``packed`` = ``pack_weights(w0, w1)`` of
    (c_out, C, 3, 3) weights. ``img`` (B, C, H, W) float32 on the card, a
    channels-last view with 16-byte aligned memory; ``b0``, ``b1``
    (c_out,) or None. Returns the two (B, c_out, H, W) channels-last
    outputs. Raises ValueError for inputs that :func:`route` does not send
    to the kernel, and for tensors the kernel cannot read in place."""
    biases = [t for t in (b0, b1) if t is not None]
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in [img, packed, *biases])
    if img.dim() != 4 or packed.dim() != 12:
        raise ValueError(f"projection_conv: expected a (B, C, H, W) image "
                         f"and pack_weights' output, got {tuple(img.shape)} "
                         f"and {tuple(packed.shape)}")
    B, C, H, W = img.shape
    if route(img.device.type, img.dtype, grad, KERNEL, C,
             c_out) != "kernel":
        raise ValueError(f"projection_conv: the kernel takes float32 card "
                         f"tensors outside autograd and {MIN_CHANNELS} or "
                         f"more channels in and out in steps of "
                         f"{CHANNEL_STEP}; got {img.dtype} on "
                         f"{img.device.type}, grad {grad}, {C} -> {c_out}")
    with span("pmc.kernel.projection_conv"):
        want = (2, -(-c_out // TILE_N), C // ROW_K, 3, 2, 2, 3, 2, 16, 2,
                8, 4)
        if tuple(packed.shape) != want or not packed.is_contiguous():
            raise ValueError(f"projection_conv: packed weights must be "
                             f"pack_weights' contiguous {want}, got "
                             f"{tuple(packed.shape)}")
        for name, t in (("b0", b0), ("b1", b1)):
            if t is not None and (tuple(t.shape) != (c_out,)
                                  or not t.is_contiguous()):
                raise ValueError(f"projection_conv: {name} must be a "
                                 f"contiguous ({c_out},) tensor")
        for t in (packed, *biases):
            if t.device != img.device or t.dtype != img.dtype:
                raise ValueError("projection_conv: the image, weights and "
                                 "biases must share one device and dtype")
        if not (img.is_contiguous(memory_format=torch.channels_last)
                and _aligned(img) and _aligned(packed)):
            raise ValueError(f"projection_conv: the image must be a "
                             f"channels-last view of (B, H, W, C) rows, "
                             f"16-byte aligned, got strides {img.stride()} "
                             f"at address {img.data_ptr()}")
        y0, y1 = (torch.empty(B, H, W, c_out, dtype=img.dtype,
                              device=img.device).permute(0, 3, 1, 2)
                  for _ in range(2))
        err = _cuda.library().pmc_projection_conv(
            img.data_ptr(), packed.data_ptr(), _cuda.ptr(b0), _cuda.ptr(b1),
            y0.data_ptr(), y1.data_ptr(), B, H, W, C, c_out,
            _cuda.stream(img))
        projection_conv.launches += 1
        _cuda.raise_on_error(err, "projection_conv")
        return y0, y1


projection_conv.launches = 0
