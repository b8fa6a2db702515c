"""SAM's ViT image encoder as a field surrogate.

The image encoder of the Segment Anything Model (Kirillov et al., ICCV
2023, arXiv:2304.02643; github.com/facebookresearch/segment-anything,
``modeling/image_encoder.py``, ``build_sam.py::build_sam_vit_b``), the
plain ViT backbone of ViTDet (Li et al., ECCV 2022, arXiv:2203.16527),
with a per-token head that regresses the field. It has no counterpart in
the JAX package.

* Embedding: a convolution with kernel and stride equal to the patch
  (with bias) over the (B, H, W, C) field, then a learned absolute
  position embedding of the token grid's shape; no cls token.
* Blocks (pre-norm): ``x + proj(attn(norm1(x)))``, then ``x +
  mlp(norm2(x))``; the MLP is Linear → exact GELU → Linear; LayerNorm eps
  1e-6. A window block (``window_size`` > 0) zero-pads ``norm1(x)`` at the
  bottom and right to a multiple of the window and cuts it into windows
  (:func:`window_partition`); attention, its qkv and output projections
  included, runs within each window over the padded tokens, which are not
  masked (their k and v are the qkv biases); the result is unpartitioned
  and cropped (:func:`window_unpartition`). A global block attends over
  the whole token grid.
* Attention: qkv with bias, softmax((q·scale)·kᵀ + rel_h + rel_w)·v per
  head, where the decomposed relative-position bias
  (:func:`rel_pos_bias`) is taken from the unscaled q and each block's
  tables have 2·size − 1 rows for its own grid (nothing is interpolated).
  The core (:func:`attend`) materialises the scores: the scale, the score
  product, the bias added, softmax, the product with v, in the inputs'
  precision on every device.
* Neck: 1×1 conv (no bias), LayerNorm over channels, 3×3 conv (padding
  1, no bias), LayerNorm over channels; no norm before it.
* Head: one Linear per token from the neck's width to c_o·ph·pw values,
  unpatchified to (B, c_o, H, W) and read as (u, v, p|None).

The activations stay channels-last (B, h, w, C) throughout. While a
profiler collects, a forward opens the spans (``utils/profiling.py
::span``) ``pmc.samvit.forward`` around it all and inside it
``pmc.samvit.embed``, ``pmc.samvit.norm`` (each LayerNorm of a block),
``pmc.samvit.partition`` (pad and partition, unpartition and crop),
``pmc.samvit.qkv``, ``pmc.samvit.attn.window`` and
``pmc.samvit.attn.global`` (a block's core: scores, scale, bias, softmax,
the product with v), ``pmc.samvit.relpos`` inside those (the tables'
gather and the two einsums), ``pmc.samvit.out`` (the heads' merge and
the output projection), ``pmc.samvit.mlp``, ``pmc.samvit.neck`` and
``pmc.samvit.head``; the residual adds lie in none but the forward's. The
Linear layers are ``models/vit.py::_Linear``: on the card, in float32
outside autograd, the blocks' qkv, output and MLP layers run the
``dense_gemm`` kernel (the MLP's GELU in its epilogue, a
``pmc.kernel.dense_gemm`` span inside the caller's); the field head (32
outputs) stays on ``F.linear``.

Weights are drawn from ``np.random.default_rng(seed)``: Linear and conv
weights U(-1/√fan_in, 1/√fan_in) with zero biases; the position
embedding and the relative-position tables start at zero, as SAM's do.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.profiling import span
from .layers import LayerNorm, keep_float32
from .vit import _Linear

EPS = 1e-6


def sam_global_blocks(depth: int) -> Tuple[int, ...]:
    """SAM's global blocks: the last of each quarter of the depth
    (ViT-B's 2, 5, 8, 11; ViT-L's 5, 11, 17, 23; ViT-H's 7, 15, 23,
    31)."""
    return tuple(sorted({(i + 1) * depth // 4 - 1 for i in range(4)}
                        - {-1}))


def padded_grid(h: int, w: int, window: int) -> Tuple[int, int]:
    """(Hp, Wp): the token grid padded to a multiple of ``window``."""
    return -(-h // window) * window, -(-w // window) * window


def window_partition(x, window: int):
    """(B, H, W, C) → (B·nW, window, window, C) windows of the grid
    zero-padded at the bottom and right, and the padded (Hp, Wp)."""
    B, H, W, C = x.shape
    Hp, Wp = padded_grid(H, W, window)
    if (Hp, Wp) != (H, W):
        x = F.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
    x = x.view(B, Hp // window, window, Wp // window, window, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C)
    return x, (Hp, Wp)


def window_unpartition(x, window: int, padded: Tuple[int, int],
                       hw: Tuple[int, int]):
    """The inverse of :func:`window_partition`, the padding cropped."""
    Hp, Wp = padded
    H, W = hw
    B = x.shape[0] // (Hp // window * (Wp // window))
    x = x.view(B, Hp // window, Wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


def get_rel_pos(size: int, table):
    """(size, size, C): ``table[i − j + size − 1]`` for query i and key
    j of one axis; ``table`` has 2·size − 1 rows (no interpolation)."""
    if table.shape[0] != 2 * size - 1:
        raise ValueError(f"a relative-position table of {table.shape[0]} "
                         f"rows does not fit an axis of {size}")
    i = torch.arange(size, device=table.device)
    return table[i[:, None] - i[None, :] + (size - 1)]


def rel_pos_bias(q, table_h, table_w, hw: Tuple[int, int]):
    """The decomposed relative-position terms of (B·heads, h·w, C) queries
    over an h × w grid, from the unscaled q: rel_h (B·heads, h, w, h) and
    rel_w (B·heads, h, w, w)."""
    h, w = hw
    r_q = q.reshape(q.shape[0], h, w, q.shape[-1])
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, get_rel_pos(h, table_h))
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, get_rel_pos(w, table_w))
    return rel_h, rel_w


def attend(q, k, v, rel_h, rel_w, scale: float):
    """softmax((q·scale)·kᵀ + rel_h + rel_w)·v over (B·heads, h·w, C)
    tensors, the scores materialised."""
    n = q.shape[0]
    _, h, w, _ = rel_h.shape
    attn = (q * scale) @ k.transpose(-2, -1)
    attn.view(n, h, w, h, w).add_(rel_h[..., None]).add_(
        rel_w[:, :, :, None, :])
    return torch.softmax(attn, dim=-1) @ v


class _Conv(nn.Module):
    """A bias-optional convolution on channels-last (B, h, w, C) tensors,
    its (c_out, c_in, kh, kw) weight ~ U(-1/√fan_in, 1/√fan_in) from
    ``rng``."""

    def __init__(self, rng: np.random.Generator, c_in: int, c_out: int,
                 kernel: Tuple[int, int], stride: Tuple[int, int] = (1, 1),
                 padding: int = 0, bias: bool = False):
        super().__init__()
        bound = 1.0 / math.sqrt(c_in * kernel[0] * kernel[1])
        self.weight = nn.Parameter(torch.as_tensor(
            rng.uniform(-bound, bound, size=(c_out, c_in, *kernel)),
            dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None
        self.stride, self.padding = tuple(stride), padding

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), b,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class _Attention(nn.Module):
    """Multi-head attention over a (B, h, w, C) grid with qkv bias and the
    decomposed relative-position bias; its tables fit the ``size`` grid
    it attends over."""

    def __init__(self, dim: int, heads: int, size: Tuple[int, int],
                 rng: np.random.Generator):
        super().__init__()
        self.heads, self.dim_head = heads, dim // heads
        self.scale = self.dim_head ** -0.5
        self.qkv = _Linear(rng, dim, 3 * dim)
        self.proj = _Linear(rng, dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size[0] - 1,
                                                  self.dim_head))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size[1] - 1,
                                                  self.dim_head))

    def forward(self, x, kind: str):
        B, h, w, C = x.shape
        with span("pmc.samvit.qkv"):
            qkv = self.qkv(x).reshape(B, h * w, 3, self.heads,
                                      self.dim_head).permute(2, 0, 3, 1, 4)
            q, k, v = qkv.reshape(3, B * self.heads, h * w,
                                  self.dim_head).unbind(0)
        with span(f"pmc.samvit.attn.{kind}"):
            with span("pmc.samvit.relpos"):
                rel_h, rel_w = rel_pos_bias(q, self.rel_pos_h,
                                            self.rel_pos_w, (h, w))
            out = attend(q, k, v, rel_h, rel_w, self.scale)
        with span("pmc.samvit.out"):
            out = out.view(B, self.heads, h, w, self.dim_head)
            return self.proj(out.permute(0, 2, 3, 1, 4).reshape(B, h, w, C))


class _MLP(nn.Module):
    """Linear → exact GELU → Linear (SAM's ``MLPBlock``)."""

    def __init__(self, dim: int, hidden: int, rng: np.random.Generator):
        super().__init__()
        self.lin1 = _Linear(rng, dim, hidden)
        self.lin2 = _Linear(rng, hidden, dim)

    def forward(self, x):
        return self.lin2(self.lin1(x, gelu=True))


class _Block(nn.Module):
    """A pre-norm block over the (B, h, w, C) grid: windowed attention
    where ``window_size`` > 0, else global."""

    def __init__(self, dim: int, heads: int, mlp_dim: int, window_size: int,
                 grid: Tuple[int, int], rng: np.random.Generator):
        super().__init__()
        self.window_size = window_size
        size = (window_size, window_size) if window_size else grid
        self.norm1 = LayerNorm(dim, eps=EPS)
        self.attn = _Attention(dim, heads, size, rng)
        self.norm2 = LayerNorm(dim, eps=EPS)
        self.mlp = _MLP(dim, mlp_dim, rng)

    def forward(self, x):
        with span("pmc.samvit.norm"):
            y = self.norm1(x)
        ws = self.window_size
        if ws:
            with span("pmc.samvit.partition"):
                y, padded = window_partition(y, ws)
            y = self.attn(y, "window")
            with span("pmc.samvit.partition"):
                y = window_unpartition(y, ws, padded, x.shape[1:3])
        else:
            y = self.attn(y, "global")
        x = x + y
        with span("pmc.samvit.norm"):
            y = self.norm2(x)
        with span("pmc.samvit.mlp"):
            return x + self.mlp(y)


class SamViTField(nn.Module):
    """SAM's ViT image encoder with a field head: image (B, H, W, C) →
    (u, v, p|None), each (B, H, W).

    ``global_attn_indexes`` None takes SAM's rule
    (:func:`sam_global_blocks`); every other block attends within
    ``window_size`` × ``window_size`` windows. ``padded_slots`` of the
    ``window_slots`` token slots of a window block are padding."""

    def __init__(self, image_size: Tuple[int, int],
                 patch_size: Tuple[int, int] = (16, 16), c_o: int = 2,
                 dim: int = 768, depth: int = 12, heads: int = 12,
                 mlp_dim: int = 3072, window_size: int = 14,
                 global_attn_indexes: Sequence[int] = None,
                 neck_chans: int = 256, channels: int = 7,
                 p_pred: bool = False, seed=0, device=None,
                 dtype=torch.float32):
        super().__init__()
        H, W = self.image_size = tuple(image_size)
        ph, pw = self.patch_size = tuple(patch_size)
        if H % ph or W % pw:
            raise ValueError("Image dimensions must be divisible by the "
                             "patch size.")
        self.c_o, self.p_pred = c_o, p_pred
        h, w = self.grid = (H // ph, W // pw)
        if global_attn_indexes is None:
            global_attn_indexes = sam_global_blocks(depth)
        self.global_attn_indexes = tuple(global_attn_indexes)
        Hp, Wp = padded_grid(h, w, window_size)
        self.window_slots = Hp * Wp
        self.padded_slots = Hp * Wp - h * w
        rng = np.random.default_rng(seed)
        self.patch_embed = _Conv(rng, channels, dim, (ph, pw), (ph, pw),
                                 bias=True)
        self.pos_embed = nn.Parameter(torch.zeros(1, h, w, dim))
        self.blocks = nn.ModuleList(
            _Block(dim, heads, mlp_dim,
                   0 if i in self.global_attn_indexes else window_size,
                   self.grid, rng) for i in range(depth))
        self.neck = nn.Sequential(
            _Conv(rng, dim, neck_chans, (1, 1)),
            LayerNorm(neck_chans, eps=EPS),
            _Conv(rng, neck_chans, neck_chans, (3, 3), padding=1),
            LayerNorm(neck_chans, eps=EPS))
        self.head = _Linear(rng, neck_chans, c_o * ph * pw)
        self.to(device=device or "cuda", dtype=dtype)
        keep_float32(self, (LayerNorm, _Linear, _Conv), dtype)

    def forward(self, img):
        (H, W), (ph, pw), (h, w) = self.image_size, self.patch_size, self.grid
        B = img.shape[0]
        with span("pmc.samvit.forward"):
            with span("pmc.samvit.embed"):
                x = self.patch_embed(img) + self.pos_embed
            for blk in self.blocks:
                x = blk(x)
            with span("pmc.samvit.neck"):
                x = self.neck(x)
            with span("pmc.samvit.head"):
                # b h w (ph pw c) -> b c (h ph) (w pw)
                y = self.head(x).reshape(B, h, w, ph, pw, self.c_o)
                y = y.permute(0, 5, 1, 3, 2, 4).reshape(B, self.c_o, H, W)
        p = y[:, 2] if (self.p_pred and self.c_o > 2) else None
        return y[:, 0], y[:, 1], p
