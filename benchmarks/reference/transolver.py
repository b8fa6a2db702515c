"""Plain reference of the structured-mesh Transolver forward (Wu et al.,
"Transolver: A Fast Transformer Solver for PDEs on General Geometries",
ICML 2024; Transolver_Structured_Mesh_2D-checkpoint.py,
Physics_Attention-checkpoint.py): an MLP lifts the points, then each
block is LayerNorm → Physics-Attention → residual → LayerNorm → MLP →
residual, the last with LayerNorm → Dense to the stream function, and
the VALID curl head of ``a_bound`` times it.

Physics-Attention on the H × W grid: two 3×3 SAME convs project the
points to per-head features fx and keys x; every point weighs G slices,
w = softmax((x·ws + bs)/clamp(temperature, 0.1, 5)); the slice tokens
are wᵀfx / (Σw + 1e-5); softmax attention among the G tokens (scale
D^-1/2); each point takes back w·tokens; a Dense mixes the heads.
Weights are a {name: tensor} dict under the measured model's parameter
names, linear weights (out, in); nothing of the program is imported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .physics import curl_valid


def dense(x, w, prefix, bias=True):
    return F.linear(x, w[f"{prefix}.weight"],
                    w[f"{prefix}.bias"] if bias else None)


def mlp(x, w, prefix):
    return dense(F.gelu(dense(x, w, f"{prefix}.linear_pre")), w,
                 f"{prefix}.linear_post")


def layer_norm(x, w, prefix):
    return F.layer_norm(x, x.shape[-1:], w[f"{prefix}.weight"],
                        w[f"{prefix}.bias"], eps=1e-5)


def physics_attention(x, w, p, m):
    B, N, C = x.shape
    H, W, heads = m["H"], m["W"], m["n_head"]
    D = C // heads
    img = x.reshape(B, H, W, C).permute(0, 3, 1, 2)

    def project(name):
        y = F.conv2d(img, w[f"{p}.{name}.weight"], w[f"{p}.{name}.bias"],
                     padding="same")
        return y.reshape(B, heads, D, N).transpose(2, 3)

    fx, xm = project("in_project_fx"), project("in_project_x")
    temp = torch.clamp(w[f"{p}.temperature"], 0.1, 5.0)
    logits = dense(xm, w, f"{p}.in_project_slice") / temp
    sw = torch.softmax(logits, dim=-1)                       # B h N G
    tok = sw.transpose(-1, -2) @ fx                          # B h G D
    tok = tok / (sw.sum(dim=2)[..., None] + 1e-5)
    q = tok @ w[f"{p}.to_q.weight"].t()
    k = tok @ w[f"{p}.to_k.weight"].t()
    v = tok @ w[f"{p}.to_v.weight"].t()
    att = torch.softmax(q @ k.transpose(-1, -2) * D ** -0.5, dim=-1) @ v
    out = sw @ att                                           # B h N D
    return dense(out.transpose(1, 2).reshape(B, N, C), w, f"{p}.to_out")


def forward(data, w, m: dict):
    """(B, H·W, 7) points → (u, v), each (B, H-2, W-2)."""
    fx = mlp(data, w, "preprocess")
    for i in range(m["n_layers"]):
        b = f"blocks_{i}"
        fx = physics_attention(layer_norm(fx, w, f"{b}.ln_1"), w,
                               f"{b}.Attn", m) + fx
        fx = mlp(layer_norm(fx, w, f"{b}.ln_2"), w, f"{b}.mlp") + fx
    fx = dense(layer_norm(fx, w, f"blocks_{m['n_layers'] - 1}.ln_3"), w,
               f"blocks_{m['n_layers'] - 1}.mlp2")
    psi = fx[..., 0].reshape(-1, m["H"], m["W"])
    return curl_valid(psi * m["a_bound"])
