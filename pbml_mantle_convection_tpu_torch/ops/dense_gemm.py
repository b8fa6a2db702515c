"""The ViT family's Dense layers on the card: y = x·Wᵀ + b, optionally
followed by exact GELU.

``models/vit.py::_Linear`` (which ``models/samvit.py`` shares) is a Dense
layer; the JAX package leaves Dense to XLA
(``pbml_mantle_convection_tpu/models/vit.py``), and so does ``_Linear``
wherever :func:`route` says "plain": ``F.linear``, and ``F.gelu`` after it
where the caller asks.

:func:`dense_gemm` launches the hand-written kernel of
``csrc/dense_gemm.cu``: one launch a layer, 3xTF32 products on the tensor
cores through wgmma (float32-accurate), the bias and GELU in its epilogue.
It replaces no TPU kernel. What bounds it (operations), its design and
which shapes take which tiling are written at the top of the CUDA source.
It reads the (rows, d_in) rows of x where they lie (leading dimensions
flattened, no copy) and writes the (..., d_out) output once. The weight
goes in as :func:`pack_weight` lays it out: split into TF32 hi and lo parts
and cut into the kernel's stage blocks, once for as long as the weight
stays the same (``_Linear.packed_weight`` keeps it), not at every call.
:func:`dense_gemm_plain` is the kernel's arithmetic in plain PyTorch.
:func:`linear` is a Dense layer on whichever path its inputs take.

Which path runs (:func:`route`) follows from what the inputs show: float32
tensors on the card, outside autograd, d_in a multiple of the K stage
(32), d_out a multiple of the column tile (128), at least one row tile
(192 rows) and no more output columns than rows take the kernel;
everything else takes the plain path: CPU tensors, inputs that require
grad under grad mode (the kernel has no backward; training runs the plain
path), bfloat16, float16 and float64, and the shapes the kernel does not
take (ViT-Base's 112-wide patch embedding, SAM's 32-wide field head,
ViT-Base's field head, 768 → 129,536, at any batch below 129,536). A
layer whose weight has more output columns than the layer has rows is
bound by reading that weight, which the kernel's packed hi/lo copy would
double, in memory and in bytes read: it keeps ``F.linear`` and its weight
is never packed. :func:`linear` takes the kernel only for rows it can read
where they lie (contiguous and 16-byte aligned: not, say, the ViT head's
cls token, ``x[:, 0]``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profiling import span
from . import _cuda
from .projection_conv import tf32_split

# the kernel's tiling (csrc/dense_gemm.cu): inputs of a K stage, output
# columns of a tile, rows of a tile
STAGE_K = 32
TILE_N = 128
TILE_M = 192
K_STEPS = STAGE_K // 8


def route(device_type: str, dtype: torch.dtype, grad: bool, rows: int,
          d_in: int, d_out: int) -> str:
    """"kernel" or "plain" for a Dense layer from ``d_in`` to ``d_out``
    over ``rows`` rows on ``device_type`` of ``dtype``, ``grad`` when
    autograd records them."""
    if device_type != "cuda" or dtype != torch.float32 or grad:
        return "plain"
    if d_in % STAGE_K or d_out % TILE_N or rows < max(TILE_M, d_out):
        return "plain"
    return "kernel"


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """A (d_out, d_in) weight as the kernel reads it: [d_out / 128 tiles]
    [d_in / 32 stages][hi, lo][4 k-steps][16 groups of 8 output columns]
    [2 k halves][8 output columns][4]; a stage's block (32 KB) is
    contiguous. Step q of a stage holds its inputs 4q .. 4q + 3 and 16 +
    4q .. 16 + 4q + 3 (the 16-byte units q and q + 4 of a 32-float row, as
    the kernel's A fragments read the swizzled rows): k-index k < 4 is
    input 16 (k // 2) + 4q + 2 (k % 2) and k ≥ 4 the input after k - 4's."""
    if w.dim() != 2 or w.shape[0] % TILE_N or w.shape[1] % STAGE_K:
        raise ValueError(f"pack_weight: a (d_out, d_in) weight with d_out a "
                         f"multiple of {TILE_N} and d_in of {STAGE_K}, got "
                         f"{tuple(w.shape)}")
    d_out, d_in = w.shape
    # o = 128 tile + 8 group + row; c = 32 stage + 16 a + 4 step + 2 b +
    # k half, k4 = 2 a + b
    w = w.detach().to(torch.float32).reshape(
        d_out // TILE_N, 16, 8, d_in // STAGE_K, 2, K_STEPS, 2, 2)
    # tile, stage, step, group, k half, row, k4
    w = w.permute(0, 3, 5, 1, 7, 2, 4, 6).reshape(
        d_out // TILE_N, d_in // STAGE_K, K_STEPS, 16, 2, 8, 4)
    return torch.stack(tf32_split(w), dim=2).contiguous()


def packed_shape(d_in: int, d_out: int) -> tuple:
    return (d_out // TILE_N, d_in // STAGE_K, 2, K_STEPS, 16, 2, 8, 4)


def dense_gemm_plain(x, weight, bias=None, gelu=False):
    """The kernel's arithmetic in plain PyTorch: x and W split into TF32
    hi and lo parts, each stage of 32 inputs summed as x_lo·W_hiᵀ +
    x_hi·W_loᵀ + x_hi·W_hiᵀ and added to float32 sums that start at the
    bias, then exact GELU where asked."""
    d_out, d_in = weight.shape
    xh, xl = tf32_split(x.reshape(-1, d_in).float())
    wh, wl = tf32_split(weight.float())
    out = torch.zeros(xh.shape[0], d_out, dtype=torch.float32,
                      device=x.device)
    if bias is not None:
        out += bias.float()
    for k in range(0, d_in, STAGE_K):
        s = slice(k, k + STAGE_K)
        out += (xl[:, s] @ wh[:, s].T + xh[:, s] @ wl[:, s].T
                + xh[:, s] @ wh[:, s].T)
    if gelu:
        out = F.gelu(out)
    return out.reshape(*x.shape[:-1], d_out)


def _aligned(t) -> bool:
    return t.data_ptr() % 16 == 0


def _refusal(x, d_out, tensors):
    """Why the kernel does not take ``x`` (..., d_in) to ``d_out``
    columns beside ``tensors`` (the weight, packed or not, and the bias),
    or None where it does: :func:`route`, then rows it cannot read where
    they lie."""
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, *tensors))
    d_in = x.shape[-1] if x.dim() else 0
    rows = x.numel() // d_in if d_in else 0
    if route(x.device.type, x.dtype, grad, rows, d_in, d_out) != "kernel":
        return (f"dense_gemm: the kernel takes float32 card tensors "
                f"outside autograd, d_in a multiple of {STAGE_K}, d_out of "
                f"{TILE_N} and at least max({TILE_M}, d_out) rows; got "
                f"{x.dtype} on {x.device.type}, grad {grad}, {rows} rows, "
                f"{d_in} -> {d_out}")
    if not (x.is_contiguous() and _aligned(x)):
        return (f"dense_gemm: x must be contiguous (..., d_in) rows, "
                f"16-byte aligned, got strides {x.stride()} at address "
                f"{x.data_ptr()}")
    return None


def _launch(x, packed, bias, gelu):
    d_out = packed.shape[0] * TILE_N
    d_in = x.shape[-1]
    with span("pmc.kernel.dense_gemm"):
        y = torch.empty(*x.shape[:-1], d_out, dtype=x.dtype, device=x.device)
        err = _cuda.library().pmc_dense_gemm(
            x.data_ptr(), packed.data_ptr(), _cuda.ptr(bias), y.data_ptr(),
            x.numel() // d_in, d_in, d_out, int(gelu), _cuda.stream(x))
        dense_gemm.launches += 1
        _cuda.raise_on_error(err, "dense_gemm")
        return y


def dense_gemm(x, packed, bias=None, gelu=False):
    """``F.linear(x, w, bias)``, then ``F.gelu`` where ``gelu``, in one
    launch, ``packed`` = ``pack_weight(w)`` of a (d_out, d_in) float32
    weight. ``x`` (..., d_in) float32 on the card, contiguous and 16-byte
    aligned; ``bias`` (d_out,) or None. Returns the (..., d_out) output.
    Raises ValueError for inputs that :func:`route` does not send to the
    kernel, and for tensors the kernel cannot read in place."""
    if x.dim() < 1 or packed.dim() != 8:
        raise ValueError(f"dense_gemm: expected (..., d_in) rows and "
                         f"pack_weight's output, got {tuple(x.shape)} and "
                         f"{tuple(packed.shape)}")
    d_out = packed.shape[0] * TILE_N
    why = _refusal(x, d_out, (packed, bias))
    if why is not None:
        raise ValueError(why)
    want = packed_shape(x.shape[-1], d_out)
    if tuple(packed.shape) != want or not packed.is_contiguous():
        raise ValueError(f"dense_gemm: packed weight must be "
                         f"pack_weight's contiguous {want}, got "
                         f"{tuple(packed.shape)}")
    if bias is not None and (tuple(bias.shape) != (d_out,)
                             or not bias.is_contiguous()):
        raise ValueError(f"dense_gemm: bias must be a contiguous "
                         f"({d_out},) tensor")
    for t in (packed, bias):
        if t is not None and (t.device != x.device or t.dtype != x.dtype):
            raise ValueError("dense_gemm: x, the weight and the bias "
                             "must share one device and dtype")
    if not _aligned(packed):
        raise ValueError("dense_gemm: the packed weight must be 16-byte "
                         "aligned")
    return _launch(x, packed, bias, gelu)


dense_gemm.launches = 0


def linear(x, weight, bias=None, gelu=False, packed=None):
    """A Dense layer: ``F.linear(x, weight, bias)``, then ``F.gelu`` where
    ``gelu``. One :func:`dense_gemm` launch where the kernel takes it
    (:func:`route`, and rows it reads where they lie), on ``packed()``,
    the caller's ``pack_weight(weight)`` (called only then, so a weight
    off the kernel's route is never packed); else ``F.linear`` and
    ``F.gelu`` in ``x``'s dtype."""
    b = None if bias is None else bias.to(x.dtype)
    # a width that does not match goes to F.linear, which names it
    if (x.dim() and x.shape[-1] == weight.shape[1]
            and _refusal(x, weight.shape[0], (weight, bias)) is None):
        return _launch(x, packed(), b, gelu)
    y = F.linear(x, weight.to(x.dtype), b)
    return F.gelu(y) if gelu else y
