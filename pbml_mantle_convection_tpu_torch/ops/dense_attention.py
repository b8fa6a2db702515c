"""Dense softmax attention on the card: the ViT's attention core.

softmax(q·kᵀ·scale)·v for every (batch, head) of (B, H, N, 64) tensors.
The JAX package computes it as einsum + scale + softmax + einsum
(``pbml_mantle_convection_tpu/models/vit.py::Attention``); so does the
port's ``models/vit.py::Attention.forward`` wherever :func:`route` says
"plain".

:func:`dense_attention` launches the hand-written kernel of
``csrc/dense_attention.cu``: one fused kernel per call that never writes
the (B, H, N, N) scores (online softmax over tiles of 64 keys; q·kᵀ and
the weighted sum of v in 3xTF32 on the tensor cores, float32-accurate).
It replaces no TPU kernel. What bounds it (operations) and its design are
written at the top of the CUDA source. It reads q, k and v as (B, H, N, 64)
views with a channel stride of 1, rows that start 16-byte aligned, so the
three parts of the qkv projection's output go in without a copy, and it
writes the (B, N, H·64) rows that the output projection reads.

Which path runs (:func:`route`) follows from what the inputs show: float32
tensors on the card, outside autograd, take the kernel, which takes a head
width of 64 and raises for any other; the plain path takes everything
else: CPU tensors, an input that requires grad while grad mode is on (the
kernel has no backward; ViT training runs the plain path, as the JAX
model trains), and bfloat16, float16 and float64.
"""

from __future__ import annotations

import math

import torch

from ..utils.profiling import span
from . import _cuda

HEAD_WIDTH = 64
LOG2E = 1.0 / math.log(2.0)


def route(device_type: str, dtype: torch.dtype, grad: bool,
          head_width: int) -> str:
    """"kernel" or "plain" for inputs on ``device_type`` of ``dtype``,
    ``grad`` when autograd records them. Raises ValueError where the
    kernel is due but does not take ``head_width``."""
    if device_type != "cuda" or dtype != torch.float32 or grad:
        return "plain"
    if head_width != HEAD_WIDTH:
        raise ValueError(f"dense_attention: the kernel takes a head width "
                         f"of {HEAD_WIDTH}, got {head_width}")
    return "kernel"


def _rows16(t):
    """Whether every (b, h, n) row of ``t`` starts 16-byte aligned with
    its channels adjacent, as the kernel's cp.async loads read them."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 4 == 0 for s in t.stride()[:3]))


def dense_attention(q, k, v, scale):
    """q, k, v (B, H, N, 64) float32 on the card → softmax(q·kᵀ·scale)·v,
    the (B, H, N, 64) view of a (B, N, H·64) tensor, so
    ``out.transpose(1, 2).reshape(B, N, -1)`` is a view. Raises ValueError
    for inputs that :func:`route` does not send to the kernel, and for
    rows the kernel cannot read in place."""
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    if route(q.device.type, q.dtype, grad, q.shape[-1]) != "kernel":
        raise ValueError(f"dense_attention: the kernel takes float32 card "
                         f"tensors outside autograd, got {q.dtype} on "
                         f"{q.device.type}, grad {grad}")
    with span("pmc.kernel.dense_attention"):
        if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
            raise ValueError(f"dense_attention: q, k and v must be (B, H, "
                             f"N, {HEAD_WIDTH}) alike, got {tuple(q.shape)}, "
                             f"{tuple(k.shape)}, {tuple(v.shape)}")
        for t in (k, v):
            if t.device != q.device or t.dtype != q.dtype:
                raise ValueError("dense_attention: q, k and v must share "
                                 "one device and dtype")
        for t in (q, k, v):
            if not _rows16(t):
                raise ValueError(f"dense_attention: every (b, h, n) row must "
                                 f"start 16-byte aligned with a channel "
                                 f"stride of 1 (strides in multiples of 4 "
                                 f"floats), got strides {t.stride()} at "
                                 f"address {t.data_ptr()}")
        B, H, N, D = q.shape
        out = torch.empty(B, N, H * D, dtype=q.dtype, device=q.device)
        out = out.view(B, N, H, D).permute(0, 2, 1, 3)
        err = _cuda.library().pmc_dense_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            N, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], scale * LOG2E, _cuda.stream(q))
        dense_attention.launches += 1
        _cuda.raise_on_error(err, "dense_attention")
        return out


dense_attention.launches = 0
