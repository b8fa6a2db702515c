"""Operations and bytes of SAM's ViT image encoder as a field surrogate
and of its two kinds of attention core, counted from the model's shapes
(Kirillov et al., ICCV 2023; ViTDet, Li et al., ECCV 2022), never from
how a kernel runs them.

Only what the real tokens need is counted, so the yardstick stays valid
for a kernel that skips the padded queries of the window blocks or adds
the bias inside the softmax:

* a Dense of c_in → c_out is 2·N·c_in·c_out operations over the N real
  tokens (the window blocks' qkv and output projection also run on the
  padded slots; those rows are not counted);
* the attention core of one block, per head and real query: q·kᵀ and
  the product with v, 2·64 operations each per key of its window
  (padded keys included: every real query attends to them; a global
  block's query to every token), and the two relative-position einsums,
  2·64 operations per row of Rh and of Rw (the window's or the grid's
  side). The scale, the bias adds and softmax are left out;
* the core's bytes: the real tokens' q, k, v and output moved once in
  float32, and the block's two relative-position tables. Padded keys
  count no bytes, since their k and v are the qkv biases. The scores are
  an intermediate that a fused kernel never writes.

LayerNorm, GELU, the residual adds and the partition copies are left
out (under 1% of the total).
"""

from __future__ import annotations

F32 = 4


def grid(m: dict) -> tuple:
    """(h, w): the token grid."""
    ph, pw = m["patch"]
    return m["H"] // ph, m["W"] // pw


def tokens(m: dict) -> int:
    h, w = grid(m)
    return h * w


def window_slots(m: dict) -> tuple:
    """(slots, padded slots) of a window block: the grid padded to a
    multiple of the window, and how many of its slots are padding."""
    h, w = grid(m)
    ws = m["window_size"]
    slots = (-(-h // ws) * ws) * (-(-w // ws) * ws)
    return slots, slots - h * w


def kinds(m: dict) -> dict:
    """{"window": n, "global": n}: how many blocks of each kind."""
    n_global = sum(1 for i in m["global_attn_indexes"]
                   if 0 <= i < m["n_layers"])
    return {"window": m["n_layers"] - n_global, "global": n_global}


def attention_core(m: dict, kind: str, batch: int = 1) -> tuple:
    """(operations, bytes) of one block's attention core, ``kind``
    "window" or "global"."""
    N, d, heads = tokens(m), m["dim_head"], m["n_head"]
    if kind == "window":
        ws = m["window_size"]
        keys, side_h, side_w = ws * ws, ws, ws
    else:
        side_h, side_w = grid(m)
        keys = N
    flops = batch * heads * N * (2 * 2 * d * keys + 2 * d * (side_h + side_w))
    tables = (2 * side_h - 1 + 2 * side_w - 1) * d * F32
    return flops, 4 * batch * N * heads * d * F32 + tables


def block_dense_flops(m: dict, batch: int = 1) -> int:
    """The Dense layers of one block over the real tokens: qkv, the output
    projection and the MLP."""
    C = m["n_hidden"]
    return 2 * batch * tokens(m) * (C * 3 * C + C * C + 2 * C * m["mlp_dim"])


def forward_flops(m: dict, batch: int = 1) -> int:
    """Operations of one forward: the patch embedding, the blocks, the
    neck (1×1 and 3×3 convs) and the field head (c_o·ph·pw values a
    token)."""
    ph, pw = m["patch"]
    N, C, nc = batch * tokens(m), m["n_hidden"], m["neck_chans"]
    embed = 2 * N * ph * pw * m["channels"] * C
    blocks = m["n_layers"] * block_dense_flops(m, batch) + sum(
        n * attention_core(m, kind, batch)[0]
        for kind, n in kinds(m).items())
    neck = 2 * N * C * nc + 2 * N * nc * nc * 9
    head = 2 * N * nc * m["c_o"] * ph * pw
    return embed + blocks + neck + head
