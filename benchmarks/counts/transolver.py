"""Operations and bytes of the structured-mesh Transolver forward and of
its two slice kernels, counted from the model's shapes (Wu et al., ICML
2024; Transolver_Structured_Mesh_2D-checkpoint.py), never from how a
kernel runs them.

A Dense of c_in → c_out over N points is 2·N·c_in·c_out operations; a
k×k conv the same times k². Slice weights are N·G·D multiply-adds per
head for the logits; pooling is N·G·D more, and so is taking the tokens
back. LayerNorm, softmax, GELU and the token attention among G slices
are left out (under 1% of the total). Bytes count every input and output
of a kernel call once, in float32; the slice projections (D·G values)
are counted too.
"""

from __future__ import annotations

F32 = 4


def _dims(m: dict):
    N = m["H"] * m["W"]
    C, heads, G = m["n_hidden"], m["n_head"], m["slice_num"]
    return N, C, heads, C // heads, G


def slice_pool(m: dict, batch: int = 1) -> tuple:
    """(operations, bytes) of one ``slice_pool`` call: the slice weights
    of every point and the weighted sums of its features and weights."""
    N, C, heads, D, G = _dims(m)
    BH = batch * heads
    flops = 2 * BH * N * D * G * 2
    vals = 2 * BH * N * D + D * G + G + heads + BH * G * (D + 1)
    return flops, vals * F32


def slice_deslice(m: dict, batch: int = 1) -> tuple:
    """(operations, bytes) of one ``slice_deslice`` call: the slice
    weights again and every point's mix of the attended tokens."""
    N, C, heads, D, G = _dims(m)
    BH = batch * heads
    flops = 2 * BH * N * D * G * 2
    vals = BH * N * D + BH * G * D + D * G + G + heads + BH * N * D
    return flops, vals * F32


def projections_flops(m: dict, batch: int = 1) -> int:
    """The two k×k conv projections of one block."""
    N, C, _, _, _ = _dims(m)
    return 2 * 2 * batch * N * C * C * m["kernel_proj"] ** 2


def forward_flops(m: dict, batch: int = 1) -> int:
    """Operations of one forward."""
    N, C, heads, D, G = _dims(m)
    c_in = m["space_dim"] + m["fun_dim"]
    hid = C * m["mlp_ratio"]
    pre = 2 * batch * N * (c_in * 2 * C + 2 * C * C)
    block = (projections_flops(m, batch)
             + slice_pool(m, batch)[0] + slice_deslice(m, batch)[0]
             + 2 * batch * N * C * C                  # to_out
             + 2 * batch * N * (C * hid + hid * C))   # the MLP
    head = 2 * batch * N * C * m["out_dim"]
    return pre + m["n_layers"] * block + head
