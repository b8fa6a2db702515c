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
``csrc/slice_attention.cu`` (float32, float64, bfloat16 or float16
storage, 16-bit values loaded into float32 math and the results stored in
the input type, as the Pallas kernel does), which recompute the weights
instead of storing the (B, heads, N, G) tensor: on the tensor cores for
16- and 32-bit storage at D, G ≤ 128, else SIMT, for any D and G whose
16-point tiles fit in shared memory (the CUDA plan decides, :func:`_plan`).
They read x_mid and fx as (B, heads, N, D) views with any strides but a
channel stride of 1, so the projections' own outputs go in without a copy,
and :func:`slice_deslice` writes the (B, N, heads·D) rows that the output
projection reads. On CPU tensors the two wrappers run their plain versions,
with the same math types. The einsum formulation of the JAX model
(``models/transolver.py::_slice_attention``) is
:func:`slice_attention_plain`. What bounds the kernels (bytes at the
serving shape) and their design are written at the top of the CUDA source.

Models call :func:`slice_attention`: the kernels on every forward, with
or without autograd. The kernels have no backward of their own; under
autograd their outputs carry a graph whose backward recomputes
:func:`slice_attention_plain` from the saved inputs, as remat recomputes.
Inside :func:`plain_slice_attention` (the train and eval steps) models
run the einsum formulation itself, as the JAX model trains, and launch no
kernel.

Weights keep the JAX orientation: ws (D, G), bs (G,), wq/wk/wv (D, D)
applied as ``x @ w``; temperature (1, heads, 1, 1), clamped by the caller
where the model clamps it.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import torch

from ..utils.profiling import span
from . import _cuda

_ENTRY = {torch.float32: "f32", torch.float64: "f64",
          torch.bfloat16: "bf16", torch.float16: "f16"}
_INVALID_VALUE = 1  # cudaErrorInvalidValue


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
    return (w.transpose(-1, -2) @ fx).to(dtype), w.sum(dim=-2).to(dtype)


def slice_deslice_plain(xm, tok, ws, bs, temp):
    """Plain version of :func:`slice_deslice` (a dense result)."""
    dtype = xm.dtype
    xm, tok, ws, bs, temp = _math(xm, tok, ws, bs, temp)
    return (slice_weights(xm, ws, bs, temp[:, None, None]) @ tok).to(dtype)


def kernel_view(t):
    """``t`` itself where its channels (last dimension) are adjacent, as
    the kernels read them, so a projection's output view goes in with no
    copy; otherwise a contiguous copy, made here and openly (e.g. a conv
    output that is not channels-last)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _rows(t):
    """(B, H) and the (b, h, n) element strides of a (B·H, N, D) or
    (B, H, N, D) view, read as B = 1 for three dimensions; a dimension of
    size 1 gets stride 0."""
    if t.dim() == 3:
        shape, strides = (1, *t.shape[:2]), (0, *t.stride()[:2])
    else:
        shape, strides = t.shape[:3], t.stride()[:3]
    return shape[:2], [0 if n == 1 else s for n, s in zip(shape, strides)]


def _check(name, xm, ws, bs, temp):
    """Validates the inputs of one kernel call; returns (B, H, N, D, G)
    and x_mid's row strides."""
    if xm.dtype not in _ENTRY:
        raise TypeError(f"{name}: the kernel takes float32, float64, "
                        f"bfloat16 or float16, got {xm.dtype}")
    if not xm.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {xm.device}")
    if xm.dim() not in (3, 4) or xm.stride(-1) != 1:
        raise ValueError(f"{name}: x_mid must be (B·H, N, D) or (B, H, N, "
                         f"D) with a channel stride of 1, got shape "
                         f"{tuple(xm.shape)}, strides {xm.stride()}")
    (B, H), strides = _rows(xm)
    N, D = xm.shape[-2:]
    G = ws.shape[-1]
    if ws.dim() != 2 or ws.shape[0] != D or not (N >= 1 and G >= 1):
        raise ValueError(f"{name}: expected ws (D={D}, G), N ≥ 1, got ws "
                         f"{tuple(ws.shape)}, N={N}")
    if B * H > 65535:
        raise ValueError(f"{name}: the kernels take B·H ≤ 65535, got "
                         f"{B * H}")
    for t in (ws, bs, temp):
        if t.device != xm.device:
            raise ValueError(f"{name}: inputs on different devices")
    if ws.dtype != xm.dtype:
        raise TypeError(f"{name}: the kernel takes ws in {xm.dtype}, got "
                        f"{ws.dtype}")
    _cuda.check_cuda(f"{name} bs", bs, xm.dtype, (G,))
    _cuda.check_cuda(f"{name} temp", temp, xm.dtype, (H,))
    return B, H, N, D, G, strides


@functools.lru_cache(maxsize=None)
def _plan(kernel, entry, device, BH, N, D, G):
    """(chunks, tiles per chunk) of a launch of ``kernel`` ("pool" or
    "deslice"): one wave of blocks on the card, from its SM count and the
    kernel's occupancy (SIMT slice_deslice: one tile per block). The CUDA
    plan alone decides which D and G fit: it returns cudaErrorInvalidValue
    where not even a 16-point SIMT tile fits in a block's shared memory
    (the shapes ``_check`` passes are otherwise valid)."""
    chunks, per_chunk = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        err = getattr(_cuda.library(), f"pmc_slice_{kernel}_plan_{entry}")(
            BH, N, D, G, ctypes.byref(chunks), ctypes.byref(per_chunk))
    if err == _INVALID_VALUE:
        raise ValueError(
            f"slice_{kernel}: the kernels take D and G up to what shared "
            f"memory holds: a 16-point tile of D={D}, G={G} in {entry} "
            f"does not fit in a block's shared memory")
    _cuda.raise_on_error(err, f"slice_{kernel}")
    return chunks.value, per_chunk.value


def _no_graph(name, *ts):
    """The kernels write fresh tensors with no autograd graph: under
    autograd they would drop the gradients of every input silently, so
    they refuse (:func:`slice_attention` gives them a backward)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            f"{name}: an input requires grad, and the kernel has no "
            f"backward; call slice_attention (a backward through the "
            f"einsum formulation) or slice_attention_plain under autograd, "
            f"or run under torch.no_grad()")


def slice_pool(fx, xm, ws, bs, temp):
    """fx, xm (B·H, N, D) or (B, H, N, D), channel stride 1; ws (D, G);
    bs (G,); temp (H,) (H = B·H for three dimensions) → num (…, G, D),
    den (…, G): the softmax-weighted sums of fx and of the weights.
    Raises under autograd (an input requires grad), on any device."""
    _no_graph("slice_pool", fx, xm, ws, bs, temp)
    with span("pmc.kernel.slice_pool"):
        if xm.device.type == "cpu":
            return slice_pool_plain(fx, xm, ws, bs, temp)
        B, H, N, D, G, xs = _check("slice_pool", xm, ws, bs, temp)
        if fx.dtype != xm.dtype or fx.shape != xm.shape \
                or fx.device != xm.device or fx.stride(-1) != 1:
            raise ValueError(f"slice_pool: fx must match x_mid's shape, type "
                             f"and device with a channel stride of 1, got "
                             f"{tuple(fx.shape)} {fx.dtype}, strides "
                             f"{fx.stride()}")
        entry = _ENTRY[xm.dtype]
        chunks, per_chunk = _plan("pool", entry, xm.device, B * H, N, D, G)
        wide = torch.float64 if xm.dtype == torch.float64 else torch.float32
        part = torch.empty(B * H * chunks * G * (D + 1), dtype=wide,
                           device=xm.device)
        lead = xm.shape[:-2]
        num = torch.empty(*lead, G, D, dtype=xm.dtype, device=xm.device)
        den = torch.empty(*lead, G, dtype=xm.dtype, device=xm.device)
        err = getattr(_cuda.library(), f"pmc_slice_pool_{entry}")(
            fx.data_ptr(), xm.data_ptr(), ws.data_ptr(), bs.data_ptr(),
            temp.data_ptr(), part.data_ptr(), num.data_ptr(), den.data_ptr(),
            B * H, H, N, D, G, *_rows(fx)[1], *xs, *ws.stride(), chunks,
            per_chunk, _cuda.stream(xm))
        slice_pool.launches += 1
        _cuda.raise_on_error(err, "slice_pool")
        return num, den


def _deslice_out(xm):
    """The result of :func:`slice_deslice`: dense (B·H, N, D) for three
    dimensions; for four, the (B, H, N, D) view of a (B, N, H·D) tensor,
    the rows the output projection reads."""
    if xm.dim() == 3:
        return torch.empty(xm.shape, dtype=xm.dtype, device=xm.device)
    B, H, N, D = xm.shape
    out = torch.empty(B, N, H * D, dtype=xm.dtype, device=xm.device)
    return out.view(B, N, H, D).permute(0, 2, 1, 3)


def slice_deslice(xm, tok, ws, bs, temp):
    """xm (B·H, N, D) or (B, H, N, D), channel stride 1; tok (…, G, D);
    ws (D, G); bs (G,); temp (H,) → out (…, N, D): each point's
    softmax-weighted sum of the tokens. For four dimensions the result is
    the (B, H, N, D) view of a (B, N, H·D) tensor, so that
    ``out.transpose(1, 2).reshape(B, N, -1)`` is a view. Raises under
    autograd (an input requires grad), on any device."""
    _no_graph("slice_deslice", xm, tok, ws, bs, temp)
    with span("pmc.kernel.slice_deslice"):
        if xm.device.type == "cpu":
            out = slice_deslice_plain(xm, tok, ws, bs, temp)
            return out if xm.dim() == 3 else _deslice_out(xm).copy_(out)
        B, H, N, D, G, xs = _check("slice_deslice", xm, ws, bs, temp)
        _cuda.check_cuda("slice_deslice tok", tok, xm.dtype,
                         (*xm.shape[:-2], G, D))
        out = _deslice_out(xm)
        entry = _ENTRY[xm.dtype]
        chunks, per_chunk = _plan("deslice", entry, xm.device, B * H, N, D, G)
        err = getattr(_cuda.library(), f"pmc_slice_deslice_{entry}")(
            xm.data_ptr(), tok.data_ptr(), ws.data_ptr(), bs.data_ptr(),
            temp.data_ptr(), out.data_ptr(), B * H, H, N, D, G, *xs,
            *_rows(out)[1], *ws.stride(), chunks, per_chunk, _cuda.stream(xm))
        slice_deslice.launches += 1
        _cuda.raise_on_error(err, "slice_deslice")
        return out


slice_pool.launches = 0
slice_deslice.launches = 0


def slice_attention_fused(fx_mid, x_mid, ws, bs, temperature, wq, wk, wv):
    """The Physics-Attention core: (B, heads, N, D) → (B, heads, N, D),
    the result of :func:`slice_attention_plain` through :func:`slice_pool`
    and :func:`slice_deslice` (the kernels, on CUDA tensors). The
    projections' views go in as they are (:func:`kernel_view`); the result
    is the (B, heads, N, D) view of a (B, N, heads·D) tensor."""
    H = x_mid.shape[1]
    fx, xm = kernel_view(fx_mid), kernel_view(x_mid)
    temp = temperature.reshape(H).to(x_mid.dtype)
    num, den = slice_pool(fx, xm, ws, bs, temp)
    token = num / (den[..., None] + 1e-5)
    out_tok = token_attention(token, wq, wk, wv)
    return slice_deslice(xm, out_tok, ws, bs, temp)


class _SliceAttention(torch.autograd.Function):
    """:func:`slice_attention_fused` forward; the backward recomputes
    :func:`slice_attention_plain` from the saved inputs and returns its
    gradients. Saving the eight inputs, not the (B, heads, N, G) slice
    weights, keeps the forward's memory that of the kernels."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return slice_attention_fused(*args)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad
        args = [a.detach().requires_grad_(n)
                for a, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = slice_attention_plain(*args)
        got = iter(torch.autograd.grad(
            out, [a for a in args if a.requires_grad], grad))
        return tuple(next(got) if n else None for n in need)


_route = threading.local()


@contextlib.contextmanager
def plain_slice_attention():
    """Inside, :func:`slice_attention` is :func:`slice_attention_plain`:
    the einsum formulation, no kernel launch, as the JAX model trains.
    The flag is the calling thread's; enter it inside a function that
    ``torch.utils.checkpoint`` recomputes, which may run on the autograd
    engine's thread."""
    before = getattr(_route, "plain", False)
    _route.plain = True
    try:
        yield
    finally:
        _route.plain = before


def slice_attention(fx_mid, x_mid, ws, bs, temperature, wq, wk, wv):
    """The Physics-Attention core as the models call it: the kernels
    (:func:`slice_attention_fused`) on every forward; under autograd (grad
    mode on and an input that requires grad) with a backward through
    :func:`slice_attention_plain` recomputed; inside
    :func:`plain_slice_attention` the einsum formulation itself."""
    args = (fx_mid, x_mid, ws, bs, temperature, wq, wk, wv)
    if getattr(_route, "plain", False):
        return slice_attention_plain(*args)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _SliceAttention.apply(*args)
    return slice_attention_fused(*args)
