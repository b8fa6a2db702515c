"""ViT baseline (the stock lucidrains architecture).

Counterparts of ``FeedForward``, ``Attention``, ``Transformer``, ``ViT``
and ``ViTField`` in the JAX package's ``models/vit.py`` (reference:
vit_pytorch-checkpoint.py:85-133: patch embedding, cls token, pre-norm
transformer, an MLP head regressing the flattened output fields). The
submodules carry Flax's automatic names (``LayerNorm_0``, ``Dense_0``,
``Transformer_0``, ``attn_{i}``, ``ff_{i}``, ...), so a Flax tree loads
through ``utils/flax_convert.py`` (a Dense kernel (in, out) becomes a
Linear weight (out, in)). LayerNorm eps 1e-5, exact GELU, cls pooling.
The attention is the plain einsum + softmax, as JAX computes it: no
library attention kernel, so the float32 path stays comparable.

While a profiler collects, a forward opens the spans (``utils/profiling.py
::span``) ``pmc.vit.forward`` around it all and inside it
``pmc.vit.embed`` (patch LayerNorm, Dense, LayerNorm, cls and position),
``pmc.vit.norm`` (each pre-norm and the final norm), ``pmc.vit.qkv``,
``pmc.vit.attn.core`` (scores, scale, softmax, the weighted sum of v),
``pmc.vit.attn.out`` (the heads' merge and the output projection),
``pmc.vit.mlp`` (Dense, GELU, Dense) and ``pmc.vit.head`` (the pooling
and the last Dense); the residual adds lie in none but the forward's.

Weights are drawn from ``np.random.default_rng(seed)``: Linear weights
U(-1/√in, 1/√in) with zero biases (Flax's Dense with torch's fan-in
bound), the position embedding and cls token N(0, 1); the model is moved
to ``device`` (default: the card). Under a 16-bit dtype the LayerNorm and
Linear parameters stay float32, as the Flax built-ins keep them
(``param_dtype``): a Linear casts its weights to the input's type at use,
a LayerNorm computes in float32 and casts its result; the position
embedding and cls token take the dtype.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.profiling import span
from .layers import LayerNorm, keep_float32


class _Linear(nn.Module):
    """``F.linear`` with a (d_out, d_in) weight ~ U(-1/√d_in, 1/√d_in)
    from ``rng`` and a zero bias (no draw from torch's global
    generator)."""

    def __init__(self, rng: np.random.Generator, d_in: int, d_out: int,
                 bias: bool = True):
        super().__init__()
        bound = 1.0 / math.sqrt(d_in)
        self.weight = nn.Parameter(torch.as_tensor(
            rng.uniform(-bound, bound, size=(d_out, d_in)),
            dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


def _layer_norm(dim: int) -> LayerNorm:
    return LayerNorm(dim, eps=1e-5)


class FeedForward(nn.Module):
    """LayerNorm → Linear → exact GELU → Linear."""

    def __init__(self, dim: int, hidden_dim: int, rng: np.random.Generator):
        super().__init__()
        self.LayerNorm_0 = _layer_norm(dim)
        self.Dense_0 = _Linear(rng, dim, hidden_dim)
        self.Dense_1 = _Linear(rng, hidden_dim, dim)

    def forward(self, x):
        with span("pmc.vit.norm"):
            x = self.LayerNorm_0(x)
        with span("pmc.vit.mlp"):
            return self.Dense_1(F.gelu(self.Dense_0(x)))


class Attention(nn.Module):
    """Pre-norm multi-head self-attention: LayerNorm, one bias-free qkv
    projection, softmax(q·kᵀ/√dim_head)·v per head, and an output
    projection unless one head of width ``dim``."""

    def __init__(self, dim: int, rng: np.random.Generator, heads: int = 8,
                 dim_head: int = 64):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.LayerNorm_0 = _layer_norm(dim)
        self.Dense_0 = _Linear(rng, dim, inner * 3, bias=False)
        self.project_out = not (heads == 1 and dim_head == dim)
        if self.project_out:
            self.Dense_1 = _Linear(rng, inner, dim)

    def forward(self, x):
        B, N, _ = x.shape
        with span("pmc.vit.norm"):
            x = self.LayerNorm_0(x)
        with span("pmc.vit.qkv"):
            qkv = self.Dense_0(x)

        def heads(t):
            return t.reshape(B, N, self.heads, self.dim_head).transpose(1, 2)

        q, k, v = (heads(t) for t in qkv.chunk(3, dim=-1))
        with span("pmc.vit.attn.core"):
            attn = torch.softmax(torch.einsum("bhnd,bhmd->bhnm", q, k)
                                 * self.dim_head ** -0.5, dim=-1)
            out = torch.einsum("bhnm,bhmd->bhnd", attn, v)
        with span("pmc.vit.attn.out"):
            out = out.transpose(1, 2).reshape(B, N,
                                              self.heads * self.dim_head)
            return self.Dense_1(out) if self.project_out else out


class Transformer(nn.Module):
    """``depth`` × (attention + residual, feed-forward + residual), then
    a LayerNorm."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, rng: np.random.Generator):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"attn_{i}", Attention(dim, rng, heads, dim_head))
            self.add_module(f"ff_{i}", FeedForward(dim, mlp_dim, rng))
        self.LayerNorm_0 = _layer_norm(dim)

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"attn_{i}")(x) + x
            x = getattr(self, f"ff_{i}")(x) + x
        with span("pmc.vit.norm"):
            return self.LayerNorm_0(x)


class ViT(nn.Module):
    """image (B, H, W, C) → (B, num_classes): patches of ``patch_size``
    flattened as (ph, pw, C), LayerNorm → Linear → LayerNorm, a cls token
    in front, the position embedding added, the transformer, the cls
    token's (or with ``pool="mean"`` the tokens' mean) features through
    the head."""

    def __init__(self, image_size: Tuple[int, int],
                 patch_size: Tuple[int, int], num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int,
                 rng: np.random.Generator, pool: str = "cls",
                 channels: int = 3, dim_head: int = 64):
        super().__init__()
        H, W = image_size
        ph, pw = patch_size
        if H % ph or W % pw:
            raise ValueError("Image dimensions must be divisible by the "
                             "patch size.")
        self.patch_size, self.pool, self.dim = (ph, pw), pool, dim
        n = (H // ph) * (W // pw)
        patch_dim = ph * pw * channels
        self.LayerNorm_0 = _layer_norm(patch_dim)
        self.Dense_0 = _Linear(rng, patch_dim, dim)
        self.LayerNorm_1 = _layer_norm(dim)
        self.pos_embedding = nn.Parameter(torch.as_tensor(
            rng.standard_normal((1, n + 1, dim)), dtype=torch.float32))
        self.cls_token = nn.Parameter(torch.as_tensor(
            rng.standard_normal((1, 1, dim)), dtype=torch.float32))
        self.Transformer_0 = Transformer(dim, depth, heads, dim_head,
                                         mlp_dim, rng)
        self.Dense_1 = _Linear(rng, dim, num_classes)

    def forward(self, img):
        ph, pw = self.patch_size
        B, H, W, C = img.shape
        nh, nw = H // ph, W // pw
        n = nh * nw
        with span("pmc.vit.forward"):
            with span("pmc.vit.embed"):
                # b (h ph) (w pw) c -> b (h w) (ph pw c)
                x = img.reshape(B, nh, ph, nw, pw, C).permute(0, 1, 3, 2,
                                                              4, 5)
                x = self.LayerNorm_1(self.Dense_0(self.LayerNorm_0(
                    x.reshape(B, n, ph * pw * C))))
                cls = self.cls_token.expand(B, 1, self.dim)
                x = (torch.cat((cls, x), dim=1)
                     + self.pos_embedding[:, :n + 1])
            x = self.Transformer_0(x)
            with span("pmc.vit.head"):
                x = x.mean(dim=1) if self.pool == "mean" else x[:, 0]
                return self.Dense_1(x)


class ViTField(nn.Module):
    """ViT with a field-regression head: image (B, H, W, C) →
    (u, v, p|None), each (B, H, W): the head's c_o·H·W outputs read as
    (c_o, H, W) (the reference trains its stock ViT on the uvpT task
    through ``one_epoch_AD``, train_uvpT_vit-checkpoint.ipynb)."""

    def __init__(self, image_size: Tuple[int, int],
                 patch_size: Tuple[int, int] = (8, 8), c_o: int = 2,
                 dim: int = 128, depth: int = 4, heads: int = 4,
                 mlp_dim: int = 256, channels: int = 7,
                 p_pred: bool = False, seed=0, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.image_size, self.c_o, self.p_pred = tuple(image_size), c_o, p_pred
        H, W = self.image_size
        self.vit = ViT(self.image_size, patch_size, c_o * H * W, dim, depth,
                       heads, mlp_dim, np.random.default_rng(seed),
                       channels=channels)
        self.to(device=device or "cuda", dtype=dtype)
        keep_float32(self, (LayerNorm, _Linear), dtype)

    def forward(self, img):
        H, W = self.image_size
        y = self.vit(img).reshape(-1, self.c_o, H, W)
        p = y[:, 2] if (self.p_pred and self.c_o > 2) else None
        return y[:, 0], y[:, 1], p
