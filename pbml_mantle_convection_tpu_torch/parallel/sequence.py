"""Sequence-parallel Physics-Attention: the point axis split over ranks.

Counterpart of the JAX package's ``parallel/sequence.py``. The slice
attention pools the N points into ``slice_num`` tokens through softmax
slice weights, attends among the tokens and broadcasts them back
(Physics_Attention-checkpoint.py:31-57). The pooled numerator and
denominator are sums over N, so the layer runs over point shards with two
all-reduces of (B, heads, G, D) and (B, heads, G): the traffic does not
grow with N.

:func:`physics_attention_sharded` runs it through the port's slice
kernels (``ops/slice_attention.py``), which already return those two sums
before they are divided: per rank the projections, one ``slice_pool``
launch, the two all-reduces, the token attention, one ``slice_deslice``
launch and the output projection. The sums are reduced in float32 for
16-bit inputs (float64 for float64): the kernel accumulates in float32
and rounds each rank's sum to the storage type once, and the reduction
adds no further rounding. On CPU tensors the kernels' plain versions run,
as every wrapper of the port does. It is a forward, as JAX's is: the
kernels refuse an input that requires grad, and so does this function.

:func:`physics_attention_ref` is the single-process forward of
``models/transolver.py::PhysicsAttentionIrregularMesh`` in the einsum
formulation, read from the module or its ``state_dict``.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.slice_attention import (kernel_view, slice_attention_plain,
                                   slice_deslice, slice_pool,
                                   token_attention)


def _params(module_or_state) -> Mapping[str, torch.Tensor]:
    if isinstance(module_or_state, torch.nn.Module):
        return dict(module_or_state.named_parameters())
    return module_or_state


def _local_qkv(p, x, heads: int, dim_head: int):
    """The per-point projections (local in N), as (B, heads, n, D)
    views."""
    B, n, _ = x.shape

    def split(y):
        return y.reshape(B, n, heads, dim_head).transpose(1, 2)

    return (split(F.linear(x, p["in_project_fx.weight"],
                           p["in_project_fx.bias"])),
            split(F.linear(x, p["in_project_x.weight"],
                           p["in_project_x.bias"])))


def _core_weights(p):
    """(ws, bs, wq, wk, wv) in the JAX orientation (``x @ w``)."""
    return (p["in_project_slice.weight"].t(), p["in_project_slice.bias"],
            p["to_q.weight"].t(), p["to_k.weight"].t(), p["to_v.weight"].t())


def _out(p, o, B: int, n: int):
    return F.linear(o.transpose(1, 2).reshape(B, n, -1), p["to_out.weight"],
                    p["to_out.bias"])


def physics_attention_ref(module_or_state, x: torch.Tensor, heads: int,
                          dim_head: int) -> torch.Tensor:
    """The irregular-mesh Physics-Attention forward of (B, N, C) points
    in the einsum formulation (no kernel): the module's function."""
    p = _params(module_or_state)
    B, N, _ = x.shape
    fx_mid, x_mid = _local_qkv(p, x, heads, dim_head)
    ws, bs, wq, wk, wv = _core_weights(p)
    o = slice_attention_plain(fx_mid, x_mid, ws, bs, p["temperature"], wq,
                              wk, wv)
    return _out(p, o, B, N)


def physics_attention_sharded(module_or_state, x_local: torch.Tensor, group,
                              heads: int, dim_head: int) -> torch.Tensor:
    """The forward of this rank's (B, n, C) block of the points, the
    blocks of all ranks of ``group`` making the sequence; returns this
    rank's (B, n, C) block of the output. ``group`` None runs the layer
    alone (no all-reduce)."""
    p = _params(module_or_state)
    B, n, _ = x_local.shape
    fx_mid, x_mid = _local_qkv(p, x_local, heads, dim_head)
    ws, bs, wq, wk, wv = _core_weights(p)
    temp = p["temperature"].reshape(heads).to(x_local.dtype)
    xm = kernel_view(x_mid)
    num, den = slice_pool(kernel_view(fx_mid), xm, ws, bs, temp)
    if group is not None:
        wide = torch.float64 if num.dtype == torch.float64 else \
            torch.float32
        num, den = num.to(wide), den.to(wide)
        dist.all_reduce(num, group=group)
        dist.all_reduce(den, group=group)
    token = (num / (den[..., None] + 1e-5)).to(x_local.dtype)
    o = slice_deslice(xm, token_attention(token, wq, wk, wv), ws, bs, temp)
    return _out(p, o, B, n)
