"""Slice attention: the Physics-Attention core of the Transolver.

Replaces the TPU kernels ``pbml_mantle_convection_tpu/ops/slice_attention.py::
_pool_kernel`` and ``::_deslice_kernel``; this module is the port of
``slice_attention_fused``. From the projected features ``fx_mid`` and
``x_mid`` (B, heads, N, D) it

1. weighs every point over G slices, w = softmax((x_mid·ws + bs)/temp);
2. pools the slice tokens, token = wᵀ·fx / (Σₙ w + 1e-5)
   (:func:`slice_pool`: num and den);
3. attends among the G tokens (:func:`token_attention`, torch ops: G × G
   is small, and XLA ran it outside the Pallas kernels too);
4. broadcasts the attended tokens back to the points, out = w·tok
   (:func:`slice_deslice`).

On CUDA tensors steps 1-2 and 1+4 are the two hand-written kernels of
``csrc/slice_attention.cu`` (D, G ≤ 128; float32, float64, bfloat16 or
float16 storage, 16-bit values loaded into float32 math and the results
stored in the input type, as the Pallas kernel does), which recompute the
weights instead of storing the (B, heads, N, G) tensor; on CPU tensors the
two wrappers run their plain versions, with the same math types. The einsum
formulation of the JAX model (``models/transolver.py::_slice_attention``)
is :func:`slice_attention_plain`. What bounds the kernels (bytes at the
serving shape) and their design are written at the top of the CUDA
source.

Weights keep the JAX orientation: ws (D, G), bs (G,), wq/wk/wv (D, D)
applied as ``x @ w``; temperature (1, heads, 1, 1), clamped by the caller
where the model clamps it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda

_ENTRY = {torch.float32: "f32", torch.float64: "f64",
          torch.bfloat16: "bf16", torch.float16: "f16"}
MAX_DIM = 128                   # csrc/slice_attention.cu kMaxDim (D and G)


def slice_weights(x_mid, ws, bs, temperature):
    """(…, N, D) → softmax slice weights (…, N, G)."""
    return torch.softmax((x_mid @ ws + bs) / temperature, dim=-1)


def token_attention(token, wq, wk, wv):
    """Softmax attention among the slice tokens (…, G, D)."""
    q, k, v = token @ wq, token @ wk, token @ wv
    dots = q @ k.transpose(-1, -2) * token.shape[-1] ** -0.5
    return torch.softmax(dots, dim=-1) @ v


def slice_attention_plain(fx_mid, x_mid, ws, bs, temperature, wq, wk, wv):
    """The einsum formulation (any dtype): (B, heads, N, D) → same."""
    w = slice_weights(x_mid, ws, bs, temperature)           # B H N G
    num = torch.einsum("bhnc,bhng->bhgc", fx_mid, w)
    token = num / (w.sum(dim=2)[..., None] + 1e-5)
    out_tok = token_attention(token, wq, wk, wv)
    return torch.einsum("bhgc,bhng->bhnc", out_tok, w)


def _math(*ts):
    """The kernels' math type: float64 for float64, else float32."""
    wide = torch.float64 if ts[0].dtype == torch.float64 else torch.float32
    return [t.to(wide) for t in ts]


def slice_pool_plain(fx, xm, ws, bs, temp):
    """Plain version of :func:`slice_pool`."""
    dtype = xm.dtype
    fx, xm, ws, bs, temp = _math(fx, xm, ws, bs, temp)
    w = slice_weights(xm, ws, bs, temp[:, None, None])
    return (w.transpose(1, 2) @ fx).to(dtype), w.sum(dim=1).to(dtype)


def slice_deslice_plain(xm, tok, ws, bs, temp):
    """Plain version of :func:`slice_deslice`."""
    dtype = xm.dtype
    xm, tok, ws, bs, temp = _math(xm, tok, ws, bs, temp)
    return (slice_weights(xm, ws, bs, temp[:, None, None]) @ tok).to(dtype)


def _check(name, xm, ws, bs, temp):
    if xm.dtype not in _ENTRY:
        raise TypeError(f"{name}: the kernel takes float32, float64, "
                        f"bfloat16 or float16, got {xm.dtype}")
    BH, N, D = xm.shape
    G = ws.shape[-1]
    if not (1 <= D <= MAX_DIM and 1 <= G <= MAX_DIM):
        raise ValueError(f"{name}: the kernel takes D, G ≤ {MAX_DIM}, got "
                         f"D={D}, G={G}")
    _cuda.check_cuda(f"{name} x_mid", xm, xm.dtype)
    _cuda.check_cuda(f"{name} ws", ws, xm.dtype, (D, G))
    _cuda.check_cuda(f"{name} bs", bs, xm.dtype, (G,))
    _cuda.check_cuda(f"{name} temp", temp, xm.dtype, (BH,))
    for t in (ws, bs, temp):
        if t.device != xm.device:
            raise ValueError(f"{name}: inputs on different devices")
    return BH, N, D, G


@functools.lru_cache(maxsize=None)
def _pool_plan(entry, device, BH, N, D, G):
    """(chunks, tiles per chunk) of a slice_pool launch: one wave of
    blocks on the card, from its SM count and the kernel's occupancy."""
    chunks, per_chunk = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        err = getattr(_cuda.library(), f"pmc_slice_pool_plan_{entry}")(
            BH, N, D, G, ctypes.byref(chunks), ctypes.byref(per_chunk))
    _cuda.raise_on_error(err, "slice_pool")
    return chunks.value, per_chunk.value


def slice_pool(fx, xm, ws, bs, temp):
    """fx, xm (BH, N, D); ws (D, G); bs (G,); temp (BH,) → num (BH, G, D),
    den (BH, G): the softmax-weighted sums of fx and of the weights."""
    if xm.device.type == "cpu":
        return slice_pool_plain(fx, xm, ws, bs, temp)
    BH, N, D, G = _check("slice_pool", xm, ws, bs, temp)
    _cuda.check_cuda("slice_pool fx", fx, xm.dtype, xm.shape)
    chunks, per_chunk = _pool_plan(_ENTRY[xm.dtype], xm.device, BH, N, D,
                                   G)
    wide = torch.float64 if xm.dtype == torch.float64 else torch.float32
    part = torch.empty(BH * chunks * G * (D + 1), dtype=wide,
                       device=xm.device)
    num = torch.empty(BH, G, D, dtype=xm.dtype, device=xm.device)
    den = torch.empty(BH, G, dtype=xm.dtype, device=xm.device)
    err = getattr(_cuda.library(), f"pmc_slice_pool_{_ENTRY[xm.dtype]}")(
        fx.data_ptr(), xm.data_ptr(), ws.data_ptr(), bs.data_ptr(),
        temp.data_ptr(), part.data_ptr(), num.data_ptr(), den.data_ptr(),
        BH, N, D, G, chunks, per_chunk, _cuda.stream(xm))
    slice_pool.launches += 1
    _cuda.raise_on_error(err, "slice_pool")
    return num, den


def slice_deslice(xm, tok, ws, bs, temp):
    """xm (BH, N, D); tok (BH, G, D); ws (D, G); bs (G,); temp (BH,) →
    (BH, N, D): each point's softmax-weighted sum of the tokens."""
    if xm.device.type == "cpu":
        return slice_deslice_plain(xm, tok, ws, bs, temp)
    BH, N, D, G = _check("slice_deslice", xm, ws, bs, temp)
    _cuda.check_cuda("slice_deslice tok", tok, xm.dtype, (BH, G, D))
    out = torch.empty_like(xm)
    err = getattr(_cuda.library(), f"pmc_slice_deslice_{_ENTRY[xm.dtype]}")(
        xm.data_ptr(), tok.data_ptr(), ws.data_ptr(), bs.data_ptr(),
        temp.data_ptr(), out.data_ptr(), BH, N, D, G, _cuda.stream(xm))
    slice_deslice.launches += 1
    _cuda.raise_on_error(err, "slice_deslice")
    return out


slice_pool.launches = 0
slice_deslice.launches = 0


def slice_attention_fused(fx_mid, x_mid, ws, bs, temperature, wq, wk, wv):
    """The Physics-Attention core: (B, heads, N, D) → (B, heads, N, D),
    the result of :func:`slice_attention_plain` through :func:`slice_pool`
    and :func:`slice_deslice` (the kernels, on CUDA tensors)."""
    B, H, N, D = x_mid.shape
    fx = fx_mid.reshape(B * H, N, D).contiguous()
    xm = x_mid.reshape(B * H, N, D).contiguous()
    temp = temperature.reshape(1, H).expand(B, H).reshape(B * H)
    temp = temp.to(x_mid.dtype).contiguous()
    ws, bs = ws.contiguous(), bs.contiguous()
    num, den = slice_pool(fx, xm, ws, bs, temp)
    token = num / (den[..., None] + 1e-5)
    out_tok = token_attention(token, wq, wk, wv).contiguous()
    return slice_deslice(xm, out_tok, ws, bs, temp).reshape(B, H, N, D)
