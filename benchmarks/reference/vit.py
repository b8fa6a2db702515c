"""Plain reference of the ViT field surrogate: the stock ViT of
lucidrains' ``vit-pytorch`` that the reference trains as its baseline
(vit_pytorch-checkpoint.py:85-133; Dosovitskiy et al., "An Image is Worth
16x16 Words", ICLR 2021), with a Dense head regressing the whole field.

The image (B, H, W, 7) is cut into ph × pw patches, each flattened as
(ph, pw, C); LayerNorm → Dense → LayerNorm embeds them; a cls token goes
in front and the position embedding is added. Each of the ``n_layers``
blocks is pre-norm: x + Attention(LayerNorm(x)), then x + MLP(LayerNorm
(x)), and a LayerNorm closes the stack. Attention: one bias-free Dense to
q, k, v of ``n_head`` heads of 64, softmax(q·kᵀ / 8)·v per head, the heads
concatenated and mixed by a Dense. MLP: Dense → exact GELU → Dense. The
cls token's features go through one Dense to 2·H·W values, read as
(u, v), each (B, H, W).

Departures from lucidrains: dropout is off, as in eval; LayerNorm eps is
1e-5 (PyTorch's default); the head is one Dense after the stack's closing
LayerNorm, as the program's JAX counterpart has it (lucidrains' versions
differ on whether ``mlp_head`` carries a LayerNorm of its own; the
reference's checkpoint file is not in this repository to say which); the
head's 2·H·W outputs are the field, not classes. The attention is
computed whole, as written, in the precision of the inputs. Weights are
a {name: tensor} dict under the measured model's parameter names, linear
weights (out, in); nothing of the program is imported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dense(x, w, prefix, bias=True):
    return F.linear(x, w[f"{prefix}.weight"],
                    w[f"{prefix}.bias"] if bias else None)


def layer_norm(x, w, prefix):
    return F.layer_norm(x, x.shape[-1:], w[f"{prefix}.weight"],
                        w[f"{prefix}.bias"], eps=1e-5)


def attention(x, w, p, heads, dim_head):
    B, N, _ = x.shape
    qkv = dense(layer_norm(x, w, f"{p}.LayerNorm_0"), w, f"{p}.Dense_0",
                bias=False)
    q, k, v = (t.reshape(B, N, heads, dim_head).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    att = torch.softmax(q @ k.transpose(-1, -2) * dim_head ** -0.5, dim=-1)
    out = (att @ v).transpose(1, 2).reshape(B, N, heads * dim_head)
    return dense(out, w, f"{p}.Dense_1")


def mlp(x, w, p):
    x = layer_norm(x, w, f"{p}.LayerNorm_0")
    return dense(F.gelu(dense(x, w, f"{p}.Dense_0")), w, f"{p}.Dense_1")


def forward(img, w, m: dict):
    """(B, H, W, 7) → (u, v), each (B, H, W)."""
    B, H, W, C = img.shape
    ph, pw = m["patch"]
    n = (H // ph) * (W // pw)
    x = img.reshape(B, H // ph, ph, W // pw, pw, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, n, ph * pw * C)
    x = layer_norm(dense(layer_norm(x, w, "vit.LayerNorm_0"), w,
                         "vit.Dense_0"), w, "vit.LayerNorm_1")
    cls = w["vit.cls_token"].expand(B, 1, x.shape[-1])
    x = torch.cat((cls, x), dim=1) + w["vit.pos_embedding"][:, :n + 1]
    for i in range(m["n_layers"]):
        p = f"vit.Transformer_0.attn_{i}"
        x = attention(x, w, p, m["n_head"], m["dim_head"]) + x
        x = mlp(x, w, f"vit.Transformer_0.ff_{i}") + x
    x = layer_norm(x, w, "vit.Transformer_0.LayerNorm_0")
    y = dense(x[:, 0], w, "vit.Dense_1").reshape(B, -1, H, W)
    return y[:, 0], y[:, 1]
