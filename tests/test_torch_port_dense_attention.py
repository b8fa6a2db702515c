"""The ViT's attention core, ``ops/dense_attention.py``.

On the CPU (every test without the ``cuda`` marker):

1. The plain path of ``Attention.forward`` is the einsum + scale +
   softmax + einsum that the port's ViT computed before the kernel, to
   the bit in float64 at ragged N (1, 17, 65, 4,049 at small widths) and
   B > 1, on the strided views of one qkv tensor.
2. The routing rule as a pure predicate of (device type, dtype, grad, head
   width): the kernel for float32 on the card outside autograd at a head
   width of 64 (any other width there raises), the plain path for CPU
   tensors, inputs that require grad under grad mode, bfloat16, float16
   and float64.
3. The CPU path launches nothing (``dense_attention.launches`` unchanged)
   and lets gradients through; ``dense_attention`` itself refuses CPU
   tensors and inputs that require grad.
4. The kernel is among the library's sources and its ctypes signature
   passes every pointer and the stream as ``c_void_p``.

On the card (marked ``cuda``; they skip without one, and the file imports
no JAX, so it runs on the card's machine)::

    python -m pytest -o addopts="" --noconftest -m cuda \\
        tests/test_torch_port_dense_attention.py

5. The kernel against float64 at (B, H, N) of the cell and of ragged,
   tiny and batched shapes, reading q, k and v as strided views of one
   qkv tensor: max |Δ| / max |float64| ≤ 5e-6 (float32 inputs, 3xTF32
   products and exp2 in float32; the plain float32 path reads ~1e-6), the
   same bits on a second call, one launch per call; rows that do not
   start 16-byte aligned raise instead of being copied.
6. ViT-Base of the benchmark's cell through ``ViTField`` against the
   benchmark's plain reference in float64 under the cell's limit (3e-5),
   12 launches a forward.
7. Under ``torch.enable_grad()`` with weights that require grad the plain
   path runs (no launch) and the gradients reach every weight.
"""

import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pbml_mantle_convection_tpu_torch.models import vit as tvit
from pbml_mantle_convection_tpu_torch.ops import _cuda
from pbml_mantle_convection_tpu_torch.ops import dense_attention as da

ROOT = Path(__file__).resolve().parents[1]
F32, F64 = torch.float32, torch.float64


def qkv_views(B, H, N, D, dtype=F64, seed=0, device="cpu", std=1.0):
    """q, k, v as the (B, H, N, D) views of one (B, N, 3·H·D) tensor that
    the ViT's qkv projection gives."""
    x = torch.as_tensor(np.random.default_rng(seed).normal(
        0.0, std, size=(B, N, 3 * H * D)), dtype=dtype).to(device)
    return tuple(t.reshape(B, N, H, D).transpose(1, 2)
                 for t in x.chunk(3, dim=-1))


def einsum_softmax(q, k, v, scale):
    """The port's ViT attention core before the kernel, as it was."""
    attn = torch.softmax(torch.einsum("bhnd,bhmd->bhnm", q, k) * scale,
                         dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", attn, v)


@pytest.mark.parametrize("B,H,N,D", [(1, 2, 1, 8), (2, 3, 17, 8),
                                     (3, 2, 65, 16), (1, 1, 4049, 8)])
def test_plain_path_is_the_einsum_softmax_to_the_bit(B, H, N, D):
    """The attention core's output, as ``Dense_1`` receives it, against
    the einsum formulation on the qkv projection's strided views."""
    dim = 12
    attn = tvit.Attention(dim, np.random.default_rng(N), H, D).double()
    x = torch.as_tensor(np.random.default_rng(B).normal(size=(B, N, dim)),
                        dtype=F64)
    seen = []
    attn.Dense_1.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    with torch.no_grad():
        attn(x)
        q, k, v = (t.reshape(B, N, H, D).transpose(1, 2) for t in
                   attn.Dense_0(attn.LayerNorm_0(x)).chunk(3, dim=-1))
    assert N == 1 or q.stride(2) == k.stride(2) == 3 * H * D
    scale = D ** -0.5
    want = einsum_softmax(q, k, v, scale)
    assert torch.equal(seen[0], want.transpose(1, 2).reshape(B, N, H * D))
    # and against softmax written out, in float64
    s = (q @ k.transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    ref = (p / p.sum(-1, keepdim=True)) @ v
    assert float((want - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.parametrize("B,N", [(1, 17), (2, 65)])
def test_attention_forward_is_unchanged_on_the_cpu(B, N):
    """``Attention.forward`` in float64 on the CPU gives the bits of the
    einsum formulation it ran before the kernel."""
    dim, heads = 48, 3
    attn = tvit.Attention(dim, np.random.default_rng(1), heads, 64).double()
    x = torch.as_tensor(np.random.default_rng(N).normal(size=(B, N, dim)),
                        dtype=F64)
    with torch.no_grad():
        got = attn(x)
        h = attn.LayerNorm_0(x)
        q, k, v = (t.reshape(B, N, heads, 64).transpose(1, 2)
                   for t in attn.Dense_0(h).chunk(3, dim=-1))
        out = einsum_softmax(q, k, v, 64 ** -0.5)
        want = attn.Dense_1(out.transpose(1, 2).reshape(B, N, heads * 64))
    assert torch.equal(got, want)


@pytest.mark.parametrize("device,dtype,grad,width,want", [
    ("cuda", F32, False, 64, "kernel"),
    ("cpu", F32, False, 64, "plain"),
    ("cpu", F32, False, 32, "plain"),
    ("cpu", F64, True, 64, "plain"),
    ("cuda", F32, True, 64, "plain"),
    ("cuda", torch.bfloat16, False, 64, "plain"),
    ("cuda", torch.float16, False, 64, "plain"),
    ("cuda", F64, False, 64, "plain"),
    ("cuda", F64, False, 32, "plain"),
])
def test_route(device, dtype, grad, width, want):
    assert da.route(device, dtype, grad, width) == want


@pytest.mark.parametrize("width", [32, 128])
def test_route_refuses_other_widths_on_the_kernels_path(width):
    with pytest.raises(ValueError, match="head width of 64"):
        da.route("cuda", F32, False, width)


def test_cpu_path_launches_nothing_and_lets_gradients_through():
    n0 = da.dense_attention.launches
    field = tvit.ViTField((16, 20), (8, 2), dim=48, depth=1, heads=3,
                          mlp_dim=96, device="cpu")
    x = torch.rand(2, 16, 20, 7, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        field(x)
    u, v, _ = field(x)
    (u.square().mean() + v.square().mean()).backward()
    assert da.dense_attention.launches == n0
    dense_0 = field.vit.Transformer_0.attn_0.Dense_0.weight
    assert dense_0.grad is not None and float(dense_0.grad.abs().max()) > 0
    q, k, v = qkv_views(1, 2, 9, 64, F32)
    with pytest.raises(ValueError, match="float32 card tensors"):
        da.dense_attention(q, k, v, 0.125)
    assert da.dense_attention.launches == n0


def test_kernel_signature_passes_pointers_as_void_p():
    assert "dense_attention.cu" in _cuda.SOURCES
    sig = _cuda._SIGNATURES["pmc_dense_attention"]
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert sig == [P] * 4 + [I] * 3 + [L] * 12 + [ctypes.c_float, P]


# -- on the card ----------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel(a, b):
    return float((a.double() - b).abs().max()) / float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,N,std", [(1, 12, 4049, 1.0), (2, 4, 65, 1.0),
                                       (1, 3, 17, 1.0), (1, 1, 1, 1.0),
                                       (1, 2, 128, 1.0), (1, 2, 128, 3.0)])
def test_cuda_kernel_matches_float64(cuda, B, H, N, std):
    q, k, v = qkv_views(B, H, N, 64, F32, seed=N, device=cuda, std=std)
    n0 = da.dense_attention.launches
    out = da.dense_attention(q, k, v, 0.125)
    again = da.dense_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert da.dense_attention.launches == n0 + 2
    # the (B, N, H·64) rows that the output projection reads, as a view
    assert out.transpose(1, 2).is_contiguous()
    want = einsum_softmax(q.double(), k.double(), v.double(), 0.125)
    err = rel(out, want)
    assert err <= 5e-6, err
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_cuda_kernel_refuses_unaligned_rows(cuda):
    x = torch.randn(1, 17, 3 * 2 * 64 + 1, device=cuda)
    q, k, v = (t.reshape(1, 17, 2, 64).transpose(1, 2)
               for t in x[..., 1:].chunk(3, dim=-1))
    n0 = da.dense_attention.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        da.dense_attention(q, k, v, 0.125)
    assert da.dense_attention.launches == n0


@pytest.mark.cuda
def test_cuda_vit_base_matches_the_reference(cuda):
    """The cell's model (ViT-Base at 128×506, 4,049 tokens) on the kernel's
    route against the benchmark's plain reference in float64."""
    sys.path.insert(0, str(ROOT))
    from benchmarks.models import vit as family
    from benchmarks.reference import vit as ref

    cfg = json.loads((ROOT / "benchmarks/configs/vit-base.json").read_text())
    limit = json.loads((ROOT / "benchmarks/limits/vit-serve-b1.json")
                       .read_text())["uv_rel_max"]
    model, w = family.build(cfg, 2 ** 31 + 11, cuda)
    m = family.dims(cfg)
    x = torch.rand(1, 128, 506, 7, device=cuda,
                   generator=torch.Generator(cuda).manual_seed(5))
    n0 = da.dense_attention.launches
    with torch.no_grad():
        u, v, _ = model(x)
        torch.cuda.synchronize()
        assert da.dense_attention.launches == n0 + 12
        ur, vr = ref.forward(x.double(), {k: t.double() for k, t in
                                          w.items()}, m)
    scale = max(float(ur.abs().max()), float(vr.abs().max()))
    err = max(float((u.double() - ur).abs().max()),
              float((v.double() - vr).abs().max())) / scale
    assert err <= limit, err


@pytest.mark.cuda
def test_cuda_training_takes_the_plain_path(cuda):
    field = tvit.ViTField((16, 20), (8, 2), dim=128, depth=2, heads=2,
                          mlp_dim=256, device=cuda)
    x = torch.rand(2, 16, 20, 7, device=cuda,
                   generator=torch.Generator(cuda).manual_seed(4))
    n0 = da.dense_attention.launches
    with torch.enable_grad():
        u, v, _ = field(x)
        (u.square().mean() + v.square().mean()).backward()
    assert da.dense_attention.launches == n0
    for name, p in field.named_parameters():
        if ".attn_" in name:
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
    with torch.no_grad():
        field(x)
    assert da.dense_attention.launches == n0 + 2
