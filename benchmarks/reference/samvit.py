"""Plain reference of SAM's ViT image encoder as a field surrogate: the
image encoder of the Segment Anything Model (Kirillov et al., ICCV 2023,
arXiv:2304.02643; github.com/facebookresearch/segment-anything,
``modeling/image_encoder.py``: ``ImageEncoderViT``, ``Block``,
``Attention``, ``window_partition``, ``window_unpartition``,
``get_rel_pos``, ``add_decomposed_rel_pos``; ``build_sam.py
::build_sam_vit_b``), the plain backbone of ViTDet (Li et al., ECCV 2022,
arXiv:2203.16527), written again here from those equations.

The image (B, H, W, 7) goes through a convolution with kernel and stride
equal to the patch (with bias), in NCHW as SAM's ``PatchEmbed`` runs it,
then channels-last; the absolute position embedding is added. Each of
the ``n_layers`` blocks is pre-norm: ``x + proj(attn(norm1(x)))``, then
``x + mlp(norm2(x))`` (Linear → exact GELU → Linear), LayerNorm eps
1e-6. A block not in ``global_attn_indexes`` pads ``norm1(x)`` with zeros
at the bottom and right to a multiple of ``window_size``, cuts it into
windows, runs attention (its qkv and output projection included) within
each window over the padded tokens, unmasked, and puts the windows back,
the padding cropped. Attention: ``attn = (q·scale)·kᵀ``, plus
``rel_h[q, k_row] + rel_w[q, k_col]`` from the unscaled q, where
``Rh[i, j] = rel_pos_h[i − j + size − 1]``; softmax; ``·v``; the heads
merged; the output projection. The neck: a 1×1 conv (no bias),
LayerNorm2d, a 3×3 conv (padding 1, no bias), LayerNorm2d, in NCHW.

Departures from SAM: the patch is 8×2, the registry's rule for the
128×506 field (16×16 does not divide 506), over 7 input channels; the
position embedding has the token grid's shape (16 × 253), not 64 × 64
interpolated; each global block's relative-position tables have
2·size − 1 rows for its own grid (31 and 505), so ``get_rel_pos``
interpolates nothing; a field head follows the neck, one Linear per token
from the neck's width to c_o·ph·pw values, unpatchified to (c_o, H, W)
and read as (u, v). Everything is computed in the precision of the
inputs; nothing sets TF32. Weights are a {name: tensor} dict under the
measured model's parameter names, linear weights (out, in); nothing of
the program is imported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear(x, w, prefix, bias=True):
    return F.linear(x, w[f"{prefix}.weight"],
                    w[f"{prefix}.bias"] if bias else None)


def layer_norm(x, w, prefix):
    return F.layer_norm(x, x.shape[-1:], w[f"{prefix}.weight"],
                        w[f"{prefix}.bias"], eps=1e-6)


def layer_norm_2d(x, w, prefix):
    """SAM's ``LayerNorm2d``: over the channels of (B, C, H, W)."""
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + 1e-6)
    return (w[f"{prefix}.weight"][:, None, None] * x
            + w[f"{prefix}.bias"][:, None, None])


def window_partition(x, ws):
    B, H, W, C = x.shape
    pad_h = (ws - H % ws) % ws
    pad_w = (ws - W % ws) % ws
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // ws, ws, Wp // ws, ws, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, C)
    return windows, (Hp, Wp)


def window_unpartition(windows, ws, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // ws // ws)
    x = windows.view(B, Hp // ws, Wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, Hp, Wp, -1)
    if Hp > H or Wp > W:
        x = x[:, :H, :W, :].contiguous()
    return x


def get_rel_pos(q_size, k_size, rel_pos):
    """SAM's ``get_rel_pos`` where the table already has
    2·max(q_size, k_size) − 1 rows."""
    if rel_pos.shape[0] != 2 * max(q_size, k_size) - 1:
        raise ValueError("the table would need interpolating")
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long().to(rel_pos.device)]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size):
    q_h, q_w = q_size
    k_h, k_w = k_size
    Rh = get_rel_pos(q_h, k_h, rel_pos_h)
    Rw = get_rel_pos(q_w, k_w, rel_pos_w)
    B, _, dim = q.shape
    r_q = q.reshape(B, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = (attn.view(B, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :]).view(B, q_h * q_w, k_h * k_w)
    return attn


def attention(x, w, p, heads):
    B, H, W, C = x.shape
    qkv = linear(x, w, f"{p}.qkv").reshape(B, H * W, 3, heads, -1)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, B * heads, H * W, -1).unbind(0)
    scale = (C // heads) ** -0.5
    attn = (q * scale) @ k.transpose(-2, -1)
    attn = add_decomposed_rel_pos(attn, q, w[f"{p}.rel_pos_h"],
                                  w[f"{p}.rel_pos_w"], (H, W), (H, W))
    attn = attn.softmax(dim=-1)
    x = (attn @ v).view(B, heads, H, W, -1).permute(0, 2, 3, 1, 4)
    return linear(x.reshape(B, H, W, -1), w, f"{p}.proj")


def block(x, w, p, heads, ws):
    shortcut = x
    x = layer_norm(x, w, f"{p}.norm1")
    if ws > 0:
        H, W = x.shape[1], x.shape[2]
        x, pad_hw = window_partition(x, ws)
    x = attention(x, w, f"{p}.attn", heads)
    if ws > 0:
        x = window_unpartition(x, ws, pad_hw, (H, W))
    x = shortcut + x
    y = layer_norm(x, w, f"{p}.norm2")
    y = linear(F.gelu(linear(y, w, f"{p}.mlp.lin1")), w, f"{p}.mlp.lin2")
    return x + y


def forward(img, w, m: dict):
    """(B, H, W, 7) → (u, v), each (B, H, W)."""
    B, H, W, _ = img.shape
    ph, pw = m["patch"]
    x = F.conv2d(img.permute(0, 3, 1, 2), w["patch_embed.weight"],
                 w["patch_embed.bias"], stride=(ph, pw))
    x = x.permute(0, 2, 3, 1) + w["pos_embed"]
    for i in range(m["n_layers"]):
        ws = 0 if i in m["global_attn_indexes"] else m["window_size"]
        x = block(x, w, f"blocks.{i}", m["n_head"], ws)
    x = x.permute(0, 3, 1, 2)
    x = layer_norm_2d(F.conv2d(x, w["neck.0.weight"]), w, "neck.1")
    x = layer_norm_2d(F.conv2d(x, w["neck.2.weight"], padding=1), w,
                      "neck.3")
    h, wt = H // ph, W // pw
    y = linear(x.permute(0, 2, 3, 1), w, "head")
    y = y.reshape(B, h, wt, ph, pw, -1).permute(0, 5, 1, 3, 2, 4)
    y = y.reshape(B, -1, H, W)
    return y[:, 0], y[:, 1]
