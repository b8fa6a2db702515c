"""Operations and bytes of the ViT field surrogate's forward and of its
attention core, counted from the model's shapes (Dosovitskiy et al.,
ICLR 2021; lucidrains' vit-pytorch), never from how a kernel runs them.

A Dense of c_in → c_out over N tokens is 2·N·c_in·c_out operations. The
attention core of one block is q·kᵀ and the weighted sum of v: 2·N²·64
operations each, per head. LayerNorm, the scale, softmax, GELU and the
residual adds are left out (under 1% of the total). The core's bytes
are q, k and v read once and its output written once, in float32: the
scores are an intermediate that a fused kernel never writes, so the
yardstick stays when one replaces the einsum + softmax.
"""

from __future__ import annotations

F32 = 4


def tokens(m: dict) -> int:
    """Patches plus the cls token."""
    ph, pw = m["patch"]
    return (m["H"] // ph) * (m["W"] // pw) + 1


def attention_core(m: dict, batch: int = 1) -> tuple:
    """(operations, bytes) of one block's attention core."""
    N, inner = tokens(m), m["n_head"] * m["dim_head"]
    flops = 2 * 2 * batch * m["n_head"] * N * N * m["dim_head"]
    return flops, 4 * batch * N * inner * F32


def block_dense_flops(m: dict, batch: int = 1) -> int:
    """The Dense layers of one block: qkv, the output projection and the
    MLP."""
    N, C = tokens(m), m["n_hidden"]
    inner = m["n_head"] * m["dim_head"]
    return 2 * batch * N * (C * 3 * inner + inner * C + 2 * C * m["mlp_dim"])


def forward_flops(m: dict, batch: int = 1) -> int:
    """Operations of one forward: the patch embedding, the blocks and the
    field head (one token's features to c_o·H·W values)."""
    ph, pw = m["patch"]
    C = m["n_hidden"]
    embed = 2 * batch * (tokens(m) - 1) * ph * pw * m["channels"] * C
    blocks = m["n_layers"] * (block_dense_flops(m, batch)
                              + attention_core(m, batch)[0])
    head = 2 * batch * C * m["c_o"] * m["H"] * m["W"]
    return embed + blocks + head
