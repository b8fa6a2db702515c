"""Plain reference of the NewFluidNet forward (pytorch_networks_convae.py:
1068-1386): stem → ``levels`` parallel branches (branch l average-pools
l times by 2, runs ``repeats`` layers, bicubic-resizes back) → concat with
the input → merge 1 + GroupNorm + act → merge 2 + act → merge 3 → minus
the spatial mean → the curl head of ``a_bound`` · channel 0.

Every conv is the learned-boundary conv of the reference: nine VALID
convs (interior, four edges, four corners) on slabs of width k+1 (k = 5),
stitched bottom-slab, interior, top-slab with the reference's row flip,
plus a learnable bias; each layer adds GroupNorm(C/4 groups, eps 1e-5)
and the exact GELU. Weights are a {name: tensor} dict under the
parameter names of the measured model; this module imports nothing of
the program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .physics import curl_padded

CLASSES = ("conv_bottom_left", "conv_bottom", "conv_bottom_right",
           "conv_left", "conv", "conv_right",
           "conv_top_left", "conv_top", "conv_top_right")
ACTS = {"gelu": F.gelu, "selu": F.selu, "elu": F.elu, "silu": F.silu,
        "relu": F.relu, "tanh": torch.tanh,
        "sine": lambda x: torch.sin(30.0 * x)}


def blc_conv(x, w, prefix: str):
    """Learned-boundary conv (bc = 1) of (B, C, H, W) → (B, O, H, W)."""
    k = [w[f"{prefix}.{c}.weight"] for c in CLASSES]
    kk = k[4].shape[-1]
    s = kk + 1 if kk == 5 else kk
    c = F.conv2d
    tl, bl = c(x[:, :, :s, :s], k[6]), c(x[:, :, -s:, :s], k[0])
    tr, br = c(x[:, :, :s, -s:], k[8]), c(x[:, :, -s:, -s:], k[2])
    top, bottom = c(x[:, :, :s, :], k[7]), c(x[:, :, -s:, :], k[1])
    left, right = c(x[:, :, :, :s], k[3]), c(x[:, :, :, -s:], k[5])
    inner = c(x, k[4])
    y = torch.cat([torch.cat([bl, bottom, br], dim=3),
                   torch.cat([left, inner, right], dim=3),
                   torch.cat([tl, top, tr], dim=3)], dim=2)
    return y + w[f"{prefix}.learnable_bias"].view(1, -1, 1, 1)


@functools.lru_cache(maxsize=None)
def _cubic(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) Keys cubic (a = -0.75) resampling matrix, half-pixel
    source coordinates, source indices clamped."""
    M = np.zeros((n_out, n_in))
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    a = -0.75
    for tap in range(-1, 3):
        d = np.abs(tap - frac)
        wgt = np.where(d <= 1.0, (a + 2) * d**3 - (a + 3) * d**2 + 1,
                       np.where(d < 2.0, a * d**3 - 5 * a * d**2
                                + 8 * a * d - 4 * a, 0.0))
        np.add.at(M, (np.arange(n_out), np.clip(base + tap, 0, n_in - 1)),
                  wgt)
    return M


def resize(x, H: int, W: int):
    My = torch.as_tensor(_cubic(x.shape[-2], H), dtype=x.dtype,
                         device=x.device)
    Mx = torch.as_tensor(_cubic(x.shape[-1], W), dtype=x.dtype,
                         device=x.device)
    return torch.einsum("pw,...ow->...op", Mx,
                        torch.einsum("oh,...hw->...ow", My, x))


def avg_pool(x):
    h, w = x.shape[-2] // 2, x.shape[-1] // 2
    x = x[..., :2 * h, :2 * w]
    return x.reshape(x.shape[:-2] + (h, 2, w, 2)).mean(dim=(-3, -1))


def layer(x, w, prefix, act, c_h):
    y = blc_conv(x, w, f"{prefix}.conv")
    y = F.group_norm(y, c_h // min(4, c_h), w[f"{prefix}.gn.weight"],
                     w[f"{prefix}.gn.bias"], eps=1e-5)
    return act(y)


def psi(x, w, m: dict):
    """(B, 7, H, W) input → merge 3's (B, c_o, H, W) output."""
    act = ACTS[m["act_fn"]]
    H, W = x.shape[-2:]
    x_in = layer(x, w, "conv_0", act, m["c_h"])
    outs = []
    for l in range(m["levels"]):
        y = x_in
        for _ in range(l):
            y = avg_pool(y)
        for r in range(m["repeats"]):
            y = layer(y, w, f"convs_{l}_{r}", act, m["c_h"])
        outs.append(resize(y, H, W) if l else y)
    y = blc_conv(torch.cat(outs + [x], dim=1), w, "conv_1")
    y = act(F.group_norm(y, max(1, m["c_h"] // 4), w["gn_0.weight"],
                         w["gn_0.bias"], eps=1e-5))
    y = act(blc_conv(y, w, "conv_2"))
    return blc_conv(y, w, "conv_3")


def forward(x_nhwc, w, m: dict):
    """(B, H, W, 7) input → (u, v) of the curl head, each (B, H, W)."""
    y = psi(x_nhwc.permute(0, 3, 1, 2), w, m)
    y = y - y.mean(dim=(2, 3), keepdim=True)
    return curl_padded(y[:, 0] * m["a_bound"])
