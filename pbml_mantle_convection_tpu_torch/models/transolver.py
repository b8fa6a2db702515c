"""Transolver: Physics-Attention surrogates (irregular and structured mesh).

Counterpart of the JAX package's ``models/transolver.py`` (reference:
Physics_Attention-checkpoint.py:6-175,
Transolver_Structured_Mesh_2D-checkpoint.py:13-204,
Transolver-checkpoint.py:126-217). Points are (B, N, C) as in JAX.
Parameter names are the Flax paths joined by dots, so
``utils/flax_convert.py::from_jax_params`` loads a Flax tree.

Every Physics-Attention calls ``ops/slice_attention.py::
slice_attention``: on the card the two slice-attention CUDA kernels, on
the CPU their plain versions, with or without autograd (its backward
recomputes the einsum formulation). The train and eval steps run the
models inside ``plain_slice_attention``, where it is the einsum
formulation that the JAX model trains on. The 2-D structured projections
run as one launch of ``ops/projection_conv.py``'s kernel where its
``route`` says so (inference in float32 on the card at 3 × 3), else as
two ``F.conv2d``.

Weights are drawn from ``np.random.default_rng(seed)``: Dense layers
trunc-normal(0.02) cut at ±2σ with zero bias (the reference's
``_init_weights``), the 2-D projections torch's conv default, the 3-D
projections trunc-normal(0.02), temperature 0.5. Under a 16-bit dtype
(the JAX CLI's ``--dtype bfloat16``) every parameter takes it but the
LayerNorms', which stay float32 as Flax's ``nn.LayerNorm`` keeps them;
they normalise in float32 and return the input's type. On the card the
bfloat16 model runs the bfloat16 instances of both slice kernels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops._cuda import packed_once
from ..ops.curl import curl_head_valid
from ..ops.projection_conv import pack_weights, projection_conv
from ..ops.projection_conv import route as projection_conv_route
from ..ops.slice_attention import slice_attention
from ..utils.profiling import span
from .layers import (Conv2dTorch, LayerNorm, float32_convs, get_activation,
                     keep_float32)


def trunc_normal(rng: np.random.Generator, shape, std: float = 0.02):
    """std · N(0, 1) redrawn outside ±2, as a float32 tensor."""
    a = rng.standard_normal(shape)
    bad = np.abs(a) > 2.0
    while bad.any():
        a[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(a) > 2.0
    return torch.as_tensor(std * a, dtype=torch.float32)


class Dense(nn.Linear):
    """Linear layer, trunc-normal(0.02) weight and zero bias."""

    def __init__(self, c_i: int, features: int, rng: np.random.Generator,
                 use_bias: bool = True):
        super().__init__(c_i, features, bias=use_bias)
        with torch.no_grad():
            self.weight.copy_(trunc_normal(rng, (features, c_i)))
            if use_bias:
                self.bias.zero_()

    def reset_parameters(self) -> None:
        """Drawn from the seeded generator in ``__init__`` instead."""


class TransolverMLP(nn.Module):
    """MLP with optional residual hidden layers
    (Transolver_Structured_Mesh_2D-checkpoint.py:13-38)."""

    def __init__(self, c_i: int, n_hidden: int, n_output: int,
                 rng: np.random.Generator, n_layers: int = 1,
                 act: str = "gelu", res: bool = True):
        super().__init__()
        self.n_layers, self.res = n_layers, res
        self.act = get_activation(act)
        self.linear_pre = Dense(c_i, n_hidden, rng)
        for i in range(n_layers):
            self.add_module(f"linears_{i}", Dense(n_hidden, n_hidden, rng))
        self.linear_post = Dense(n_hidden, n_output, rng)

    def forward(self, x):
        x = self.act(self.linear_pre(x))
        for i in range(self.n_layers):
            h = self.act(getattr(self, f"linears_{i}")(x))
            x = h + x if self.res else h
        return self.linear_post(x)


class _PhysicsAttention(nn.Module):
    """What the three variants share: the temperature, the slice and
    token projections, the core and the output projection. A subclass
    sets ``in_project_fx``/``in_project_x`` and maps (B, N, C) points to
    the (B, heads, N, dim_head) projections in :meth:`project`."""

    clamp_temperature = True

    def __init__(self, dim: int, heads: int, dim_head: int, slice_num: int,
                 rng: np.random.Generator):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.temperature = nn.Parameter(torch.full((1, heads, 1, 1), 0.5))
        self.in_project_slice = Dense(dim_head, slice_num, rng)
        for name in ("to_q", "to_k", "to_v"):
            self.add_module(name, Dense(dim_head, dim_head, rng,
                                        use_bias=False))
        self.to_out = Dense(heads * dim_head, dim, rng)

    def split_heads(self, y, B, N):
        """Channel-first (B, heads·dim_head, …) → (B, heads, N, dim_head)."""
        return y.reshape(B, self.heads, self.dim_head, N).transpose(2, 3)

    def forward(self, x):
        B, N, _ = x.shape
        with span("pmc.attn.project"):
            fx_mid, x_mid = self.project(x)
        with span("pmc.attn.slice"):
            temp = self.temperature
            if self.clamp_temperature:
                temp = torch.clamp(temp, 0.1, 5.0)
            args = (fx_mid, x_mid, self.in_project_slice.weight.t(),
                    self.in_project_slice.bias, temp, self.to_q.weight.t(),
                    self.to_k.weight.t(), self.to_v.weight.t())
            out = slice_attention(*args)
        with span("pmc.attn.out"):
            return self.to_out(out.transpose(1, 2).reshape(B, N, -1))


class PhysicsAttentionIrregularMesh(_PhysicsAttention):
    """Linear projections; the temperature is not clamped
    (Physics_Attention-checkpoint.py:6-57)."""

    clamp_temperature = False

    def __init__(self, dim: int, rng: np.random.Generator, heads: int = 8,
                 dim_head: int = 64, slice_num: int = 64):
        super().__init__(dim, heads, dim_head, slice_num, rng)
        inner = heads * dim_head
        self.in_project_fx = Dense(dim, inner, rng)
        self.in_project_x = Dense(dim, inner, rng)

    def project(self, x):
        B, N, _ = x.shape

        def heads(y):
            return y.reshape(B, N, self.heads, self.dim_head).transpose(1, 2)

        return heads(self.in_project_fx(x)), heads(self.in_project_x(x))


class PhysicsAttentionStructuredMesh2D(_PhysicsAttention):
    """kernel × kernel SAME zero-padded conv projections on the H × W
    grid; temperature clamped to [0.1, 5]
    (Physics_Attention-checkpoint.py:60-116)."""

    def __init__(self, dim: int, H: int, W: int, rng: np.random.Generator,
                 heads: int = 8, dim_head: int = 64, slice_num: int = 64,
                 kernel: int = 5):
        super().__init__(dim, heads, dim_head, slice_num, rng)
        self.H, self.W = H, W
        inner = heads * dim_head
        self.in_project_fx = Conv2dTorch(dim, inner, kernel, rng,
                                         padding="SAME", pad_mode="constant")
        self.in_project_x = Conv2dTorch(dim, inner, kernel, rng,
                                        padding="SAME", pad_mode="constant")
        # channels-last weights, as the input: else cuDNN copies them into
        # that format on every call (``to`` and ``load_state_dict`` keep it)
        for conv in (self.in_project_fx, self.in_project_x):
            conv.weight.data = conv.weight.data.contiguous(
                memory_format=torch.channels_last)
        self._packed = self._packed_key = None

    def _conv(self, img, conv):
        """``conv`` (SAME, zero-padded) with the padding left to the conv
        itself: no padded copy of the input. The input is a channels-last
        view, and so is the output, whose heads are then rows of dim_head
        adjacent values, as the slice kernels read them."""
        with float32_convs(img):
            return F.conv2d(img, conv.weight, conv.bias, padding="same")

    def packed_weights(self):
        """Both projections' weights as the kernel reads them
        (``ops/projection_conv.py::pack_weights``): packed once, and again
        only when a weight is replaced or written in place."""
        return packed_once(self, pack_weights, self.in_project_fx.weight,
                           self.in_project_x.weight)

    def project(self, x):
        """Both projections: one launch of ``ops/projection_conv.py``'s
        kernel where its ``route`` says so (float32 on the card outside
        autograd, 3 × 3, wide channels), else ``F.conv2d`` twice."""
        B, N, C = x.shape
        if N != self.H * self.W:
            raise ValueError(f"expected N = {self.H}·{self.W}, got {N}")
        img = x.reshape(B, self.H, self.W, C).permute(0, 3, 1, 2)
        fx, xx = self.in_project_fx, self.in_project_x
        grad = torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, fx.weight, fx.bias, xx.weight, xx.bias))
        c_out, _, k, _ = fx.weight.shape
        if projection_conv_route(x.device.type, x.dtype, grad, k, C,
                                 c_out) == "kernel":
            fx_mid, x_mid = projection_conv(img, self.packed_weights(), c_out,
                                            fx.bias, xx.bias)
        else:
            fx_mid, x_mid = self._conv(img, fx), self._conv(img, xx)
        return self.split_heads(fx_mid, B, N), self.split_heads(x_mid, B, N)


class PhysicsAttentionStructuredMesh3D(_PhysicsAttention):
    """kernel³ SAME zero-padded conv projections on the H × W × D grid;
    temperature clamped (Physics_Attention-checkpoint.py:119-175). The
    kernels are the Flax leaves ``in_project_{fx,x}_kernel`` (OIDHW here)
    and ``_bias``."""

    def __init__(self, dim: int, H: int, W: int, D: int,
                 rng: np.random.Generator, heads: int = 8,
                 dim_head: int = 64, slice_num: int = 32, kernel: int = 3):
        super().__init__(dim, heads, dim_head, slice_num, rng)
        self.H, self.W, self.D, self.kernel = H, W, D, kernel
        inner = heads * dim_head
        for name in ("in_project_fx", "in_project_x"):
            setattr(self, f"{name}_kernel", nn.Parameter(trunc_normal(
                rng, (inner, dim, kernel, kernel, kernel))))
            setattr(self, f"{name}_bias", nn.Parameter(torch.zeros(inner)))

    def _conv(self, vol, name):
        lo = (self.kernel - 1) // 2
        hi = self.kernel - 1 - lo
        vol = F.pad(vol, (lo, hi) * 3)
        with float32_convs(vol):
            return F.conv3d(vol, getattr(self, f"{name}_kernel"),
                            getattr(self, f"{name}_bias"))

    def project(self, x):
        B, N, C = x.shape
        if N != self.H * self.W * self.D:
            raise ValueError(f"expected N = {self.H}·{self.W}·{self.D}, "
                             f"got {N}")
        vol = x.reshape(B, self.H, self.W, self.D, C).permute(0, 4, 1, 2, 3)
        return (self.split_heads(self._conv(vol, "in_project_fx"), B, N),
                self.split_heads(self._conv(vol, "in_project_x"), B, N))


class TransolverBlock(nn.Module):
    """LayerNorm → Physics-Attention → residual → MLP → residual, and on
    the last layer LayerNorm → Dense to ``out_dim``
    (Transolver_Structured_Mesh_2D-checkpoint.py:41-77)."""

    def __init__(self, num_heads: int, hidden_dim: int, H: int, W: int,
                 rng: np.random.Generator, mlp_ratio: int = 4,
                 last_layer: bool = False, out_dim: int = 1,
                 slice_num: int = 32, kernel: int = 3,
                 structured: bool = True):
        super().__init__()
        self.last_layer = last_layer
        dim_head = hidden_dim // num_heads
        self.ln_1 = LayerNorm(hidden_dim, eps=1e-5)
        if structured:
            self.Attn = PhysicsAttentionStructuredMesh2D(
                hidden_dim, H, W, rng, heads=num_heads, dim_head=dim_head,
                slice_num=slice_num, kernel=kernel)
        else:
            self.Attn = PhysicsAttentionIrregularMesh(
                hidden_dim, rng, heads=num_heads, dim_head=dim_head,
                slice_num=slice_num)
        self.ln_2 = LayerNorm(hidden_dim, eps=1e-5)
        self.mlp = TransolverMLP(hidden_dim, hidden_dim * mlp_ratio,
                                 hidden_dim, rng, n_layers=0, res=False)
        if last_layer:
            self.ln_3 = LayerNorm(hidden_dim, eps=1e-5)
            self.mlp2 = Dense(hidden_dim, out_dim, rng)

    def forward(self, fx):
        with span("pmc.transolver.norm"):
            h = self.ln_1(fx)
        fx = self.Attn(h) + fx
        with span("pmc.transolver.norm"):
            h = self.ln_2(fx)
        with span("pmc.transolver.mlp"):
            h = self.mlp(h)
        fx = h + fx
        if self.last_layer:
            with span("pmc.transolver.norm"):
                h = self.ln_3(fx)
            with span("pmc.transolver.mlp"):
                return self.mlp2(h)
        return fx


def unified_pos_features(H: int, W: int, ref_x: int, ref_y: int,
                         dtype=torch.float32, device=None):
    """Distances of every grid point to a ref_x × ref_y reference grid,
    (1, H·W, ref_x·ref_y) (Transolver_Structured_Mesh_2D-checkpoint.py:
    153-169)."""
    grid = np.stack(np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                                indexing="ij"), axis=-1)
    ref = np.stack(np.meshgrid(np.linspace(0, 1, ref_x),
                               np.linspace(0, 1, ref_y), indexing="ij"),
                   axis=-1).reshape(-1, 2)
    pos = np.sqrt(((grid[:, :, None, :] - ref[None, None]) ** 2).sum(-1))
    return torch.as_tensor(pos.reshape(1, H * W, ref_x * ref_y),
                           dtype=dtype, device=device)


class TransolverStructured2D(nn.Module):
    """Structured-mesh Transolver with the VALID curl head.

    Input (B, H·W, space_dim + fun_dim), the first ``space_dim`` channels
    the coordinates; output (u, v, p|None), u and v of (B, H-2, W-2)
    (Transolver_Structured_Mesh_2D-checkpoint.py:171-204). Like the JAX
    model, ``p_pred`` returns channel 0 (the stream function) as p.
    """

    def __init__(self, H: int = 128, W: int = 506, space_dim: int = 2,
                 fun_dim: int = 5, n_layers: int = 5, n_hidden: int = 256,
                 n_head: int = 8, mlp_ratio: int = 1, out_dim: int = 1,
                 slice_num: int = 32, ref: int = 8, unified_pos: bool = False,
                 a_bound: float = 10.0, p_pred: bool = False,
                 kernel: int = 3, seed: int = 0, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.H, self.W, self.space_dim = H, W, space_dim
        self.out_dim, self.a_bound, self.p_pred = out_dim, a_bound, p_pred
        self.unified_pos = unified_pos
        rng = np.random.default_rng(seed)
        c_x = ref * ref * 4 if unified_pos else space_dim
        self.preprocess = TransolverMLP(c_x + fun_dim, n_hidden * 2,
                                        n_hidden, rng, n_layers=0, res=False)
        for i in range(n_layers):
            self.add_module(f"blocks_{i}", TransolverBlock(
                n_head, n_hidden, H, W, rng, mlp_ratio=mlp_ratio,
                last_layer=i == n_layers - 1, out_dim=out_dim,
                slice_num=slice_num, kernel=kernel))
        self.n_layers, self.ref = n_layers, ref
        self._pos = {}      # unified_pos features by (dtype, device)
        self.to(device=device or "cuda", dtype=dtype)
        keep_float32(self, LayerNorm, dtype)

    def pos_features(self, data):
        key = (data.dtype, data.device)
        if key not in self._pos:
            self._pos[key] = unified_pos_features(
                self.H, self.W, self.ref, self.ref * 4, *key)
        return self._pos[key]

    def forward(self, data):
        with span("pmc.transolver.forward"):
            x = data[:, :, :self.space_dim]
            fx = data[:, :, self.space_dim:]
            if self.unified_pos:
                x = self.pos_features(data).expand(data.shape[0], -1, -1)
            x = torch.cat((x, fx), dim=-1)
            with span("pmc.transolver.mlp"):
                fx = self.preprocess(x)
            for i in range(self.n_layers):
                fx = getattr(self, f"blocks_{i}")(fx)
            fx = fx.reshape(-1, self.H, self.W, self.out_dim)
            p = fx[:, 1:-1, 1:-1, 0] if self.p_pred else None
            u, v = curl_head_valid(fx[..., 0] * self.a_bound)
            return u, v, p


class TransolverIrregular(nn.Module):
    """Irregular-mesh Transolver (point clouds): (B, N, space_dim +
    fun_dim) → (B, N, out_dim) (Transolver-checkpoint.py:126-217). The
    learned ``placeholder`` is added only when fun_dim == 0."""

    def __init__(self, space_dim: int = 3, fun_dim: int = 0,
                 n_layers: int = 5, n_hidden: int = 256, n_head: int = 8,
                 mlp_ratio: int = 1, out_dim: int = 1, slice_num: int = 32,
                 seed: int = 0, device=None, dtype=torch.float32):
        super().__init__()
        self.fun_dim, self.n_layers = fun_dim, n_layers
        rng = np.random.default_rng(seed)
        self.preprocess = TransolverMLP(space_dim + fun_dim, n_hidden * 2,
                                        n_hidden, rng, n_layers=0, res=False)
        self.placeholder = nn.Parameter(torch.as_tensor(
            rng.uniform(size=n_hidden) / n_hidden, dtype=torch.float32))
        for i in range(n_layers):
            self.add_module(f"blocks_{i}", TransolverBlock(
                n_head, n_hidden, 0, 0, rng, mlp_ratio=mlp_ratio,
                last_layer=i == n_layers - 1, out_dim=out_dim,
                slice_num=slice_num, structured=False))
        self.to(device=device or "cuda", dtype=dtype)
        keep_float32(self, LayerNorm, dtype)

    def forward(self, data):
        fx = self.preprocess(data)
        if self.fun_dim == 0:
            fx = fx + self.placeholder
        for i in range(self.n_layers):
            fx = getattr(self, f"blocks_{i}")(fx)
        return fx
