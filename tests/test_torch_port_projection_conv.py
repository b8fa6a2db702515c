"""The structured Transolver's projection convs, ``ops/projection_conv.py``.

On the CPU (every test without the ``cuda`` marker):

1. The routing rule as a pure predicate of (device type, dtype, grad,
   kernel size, channels in, channels out): the kernel for float32 on the
   card outside autograd at 3 × 3 with 128 or more channels in and out in
   steps of 32; the plain path for CPU tensors, inputs that require grad
   under grad mode, bfloat16, float16 and float64, other kernel sizes and
   narrower or ragged channels.
2. ``projection_conv`` refuses inputs off its route (ValueError, no
   launch); ``pack_weights`` lays the weights out as the kernel reads them
   (every element against the layout written out index by index, hi + lo
   = w to the bit, the padded output channels zero) and refuses shapes it
   cannot lay out.
3. The plain path of ``PhysicsAttentionStructuredMesh2D.project`` is the
   two ``F.conv2d`` to the bit (float32 and float64, kernel 3 and 5, at the
   kernel's widths), launches nothing and lets gradients through; the
   packed weights are made once and again only when a weight changes.
4. The kernel is among the library's sources and its ctypes signature
   passes every pointer and the stream as ``c_void_p``.

On the card (marked ``cuda``; they skip without one, and the file imports
no JAX, so it runs on the card's machine)::

    python -m pytest -o addopts="" --noconftest -m cuda \\
        tests/test_torch_port_projection_conv.py

5. The kernel against ``F.conv2d`` in float64 at the cell's shape (B = 1
   and 2, 128 × 506, 128 → 2 × 128, 3 × 3): max |Δ| / max |float64| no
   worse than twice plain float32's (cuDNN, TF32 off), over the whole
   output and over its border rows and columns; the same bits on a second
   call; one launch a call.
6. The bias: zero weights give the bias to the bit; no bias gives the
   conv without one.
7. The outputs' strides are ``F.conv2d``'s, and the heads' views that the
   slice kernels read are the plain path's.
8. A ``TransolverStructured2D`` forward launches the kernel once a block
   without grad, never under autograd (gradients reach the projections)
   and never in bfloat16.
9. The benchmark cell's Transolver (8 blocks, 64 slices, 128 × 506) on
   the kernel's route against the same model on the ``F.conv2d`` path
   (the stream function within 1e-4 of its max; u and v, which the curl
   head takes from its differences, within twice the ``F.conv2d`` path's
   own distance from float64) and against the benchmark's float64
   reference under the cell's limit.
"""

import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pbml_mantle_convection_tpu_torch.models import transolver as tt
from pbml_mantle_convection_tpu_torch.ops import _cuda
from pbml_mantle_convection_tpu_torch.ops import projection_conv as pc

ROOT = Path(__file__).resolve().parents[1]
F32, F64 = torch.float32, torch.float64


def attention(dim=128, heads=8, kernel=3, H=6, W=10, dtype=F32, seed=0,
              device="cpu"):
    return tt.PhysicsAttentionStructuredMesh2D(
        dim, H, W, np.random.default_rng(seed), heads=heads,
        dim_head=dim // heads, slice_num=4, kernel=kernel).to(device, dtype)


def plain_projections(attn, x):
    """The two projections as the port computed them before the kernel:
    ``F.conv2d`` (SAME) of the channels-last view, split into heads."""
    B, N, C = x.shape
    img = x.reshape(B, attn.H, attn.W, C).permute(0, 3, 1, 2)
    return tuple(attn.split_heads(F.conv2d(img, c.weight, c.bias,
                                           padding="same"), B, N)
                 for c in (attn.in_project_fx, attn.in_project_x))


@pytest.mark.parametrize("device,dtype,grad,kernel,c_in,c_out,want", [
    ("cuda", F32, False, 3, 128, 128, "kernel"),
    ("cuda", F32, False, 3, 256, 256, "kernel"),
    ("cuda", F32, False, 3, 128, 160, "kernel"),
    ("cpu", F32, False, 3, 128, 128, "plain"),
    ("cpu", F64, True, 3, 128, 128, "plain"),
    ("cuda", F32, True, 3, 128, 128, "plain"),
    ("cuda", torch.bfloat16, False, 3, 128, 128, "plain"),
    ("cuda", torch.float16, False, 3, 128, 128, "plain"),
    ("cuda", F64, False, 3, 128, 128, "plain"),
    ("cuda", F32, False, 5, 128, 128, "plain"),
    ("cuda", F32, False, 1, 128, 128, "plain"),
    ("cuda", F32, False, 3, 64, 128, "plain"),
    ("cuda", F32, False, 3, 128, 96, "plain"),
    ("cuda", F32, False, 3, 144, 128, "plain"),
    ("cuda", F32, False, 3, 128, 136, "plain"),
])
def test_route(device, dtype, grad, kernel, c_in, c_out, want):
    assert pc.route(device, dtype, grad, kernel, c_in, c_out) == want


def test_refuses_inputs_off_its_route():
    attn = attention()
    img = torch.randn(1, 128, 6, 10).contiguous(
        memory_format=torch.channels_last)
    packed = pc.pack_weights(attn.in_project_fx.weight,
                             attn.in_project_x.weight)
    n0 = pc.projection_conv.launches
    with pytest.raises(ValueError, match="float32 card tensors"):
        pc.projection_conv(img, packed, 128, attn.in_project_fx.bias,
                           attn.in_project_x.bias)
    with pytest.raises(ValueError, match=r"\(B, C, H, W\) image"):
        pc.projection_conv(img[0], packed, 128)
    assert pc.projection_conv.launches == n0


def packed_index(p, o, c, ky, kx, hl, tiles, stages):
    """Where ``pack_weights`` puts part ``hl`` (0 hi, 1 lo) of weight
    (o, c, ky, kx) of projection ``p``, written out index by index."""
    tile, o = divmod(o, 128)
    group, row = divmod(o, 8)
    chunk, c = divmod(c, 32)
    sub, c = divmod(c, 16)
    step, c = divmod(c, 8)
    k4, half = divmod(c, 2)
    stage = (3 * chunk + ky) * 2 + sub
    block = ((p * tiles + tile) * stages + stage) * 2 + hl
    return ((block * 3 + kx) * 2 + step) * 1024 + (group * 64 + half * 32
                                                   + row * 4 + k4)


@pytest.mark.parametrize("c_out,c_in", [(128, 128), (160, 32)])
def test_pack_weights_layout(c_out, c_in):
    g = torch.Generator().manual_seed(c_out)
    w0, w1 = (torch.randn(c_out, c_in, 3, 3, generator=g) for _ in range(2))
    packed = pc.pack_weights(w0, w1)
    tiles, stages = -(-c_out // 128), 3 * c_in // 16
    assert packed.shape == (2, tiles, c_in // 32, 3, 2, 2, 3, 2, 16, 2, 8,
                            4)
    flat = packed.reshape(-1)
    p, o, c, ky, kx = np.indices((2, c_out, c_in, 3, 3)).reshape(5, -1)
    w = torch.stack((w0, w1)).reshape(-1)
    where = [torch.as_tensor(packed_index(p, o, c, ky, kx, hl, tiles,
                                          stages)) for hl in (0, 1)]
    hi, lo = (flat[i] for i in where)
    assert torch.equal(hi + lo, w)
    assert torch.equal(hi, pc.tf32_split(w)[0])
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    # every element is one weight's part, or a zero past c_out
    rest = torch.ones_like(flat, dtype=torch.bool)
    rest[torch.cat(where)] = False
    assert int(rest.sum()) == flat.numel() - 2 * w.numel()
    assert not flat[rest].any()


def test_tf32_split_rounds_to_nearest():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 - 2.0 ** -23,
                      -3.5, 0.0, 1e-30])
    hi, lo = pc.tf32_split(x)
    assert torch.equal(hi + lo, x)
    assert hi.tolist()[:3] == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10]
    assert float(lo.abs().max() / x.abs().max()) <= 2.0 ** -11


@pytest.mark.parametrize("shapes", [((128, 128, 3, 3), (128, 128, 5, 5)),
                                    ((128, 128, 3, 3), (96, 128, 3, 3)),
                                    ((128, 48, 3, 3), (128, 48, 3, 3))])
def test_pack_weights_refuses(shapes):
    with pytest.raises(ValueError, match="pack_weights"):
        pc.pack_weights(*(torch.zeros(s) for s in shapes))


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("kernel", [3, 5])
def test_plain_project_is_conv2d_to_the_bit(dtype, kernel):
    attn = attention(kernel=kernel, dtype=dtype)
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(2, 60, 128)),
                        dtype=dtype)
    n0 = pc.projection_conv.launches
    with torch.no_grad():
        got = attn.project(x)
        want = plain_projections(attn, x)
    for a, b in zip(got, want):
        assert a.stride() == b.stride() and torch.equal(a, b)
    assert pc.projection_conv.launches == n0
    assert attn._packed is None      # packed only on the kernel's route


def test_plain_project_lets_gradients_through():
    attn = attention()
    x = torch.randn(1, 60, 128, requires_grad=True)
    fx_mid, x_mid = attn.project(x)
    (fx_mid.square().sum() + x_mid.sum()).backward()
    for t in (x, attn.in_project_fx.weight, attn.in_project_x.bias):
        assert t.grad is not None and float(t.grad.abs().max()) > 0


def test_packed_weights_follow_the_weights():
    attn = attention()
    fx, xx = attn.in_project_fx, attn.in_project_x
    first = attn.packed_weights()
    assert attn.packed_weights() is first
    assert torch.equal(first, pc.pack_weights(fx.weight, xx.weight))
    with torch.no_grad():
        xx.weight.mul_(2.0)
    second = attn.packed_weights()
    assert second is not first
    assert torch.equal(second, pc.pack_weights(fx.weight, xx.weight))
    attn.load_state_dict({k: v.clone() + 1 for k, v in
                          attn.state_dict().items()})
    third = attn.packed_weights()
    assert third is not second
    assert torch.equal(third, pc.pack_weights(fx.weight, xx.weight))
    assert fx.weight.is_contiguous(memory_format=torch.channels_last)


def test_kernel_signature_passes_pointers_as_void_p():
    assert "projection_conv.cu" in _cuda.SOURCES
    sig = _cuda._SIGNATURES["pmc_projection_conv"]
    P, I = ctypes.c_void_p, ctypes.c_int
    assert sig == [P] * 6 + [I] * 5 + [P]


# -- on the card ----------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def conv_inputs(B, H, W, C, c_out, device, seed=0):
    """A (B, C, H, W) channels-last view of (B, H·W, C) rows and two
    projections' weights (channels-last, PyTorch's default bound) and
    biases."""
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn(B, H * W, C, generator=g, device=device)
    bound = (9 * C) ** -0.5

    def u(*shape):
        return (torch.rand(*shape, generator=g, device=device) * 2 - 1) * bound

    ws = [u(c_out, C, 3, 3).contiguous(memory_format=torch.channels_last)
          for _ in range(2)]
    return x.reshape(B, H, W, C).permute(0, 3, 1, 2), ws, [u(c_out), u(c_out)]


def rel(a, ref, scale):
    return float((a.double() - ref).abs().max()) / scale


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2])
def test_cuda_kernel_matches_float64(cuda, B):
    img, ws, bs = conv_inputs(B, 128, 506, 128, 128, cuda, seed=B)
    packed = pc.pack_weights(*ws)
    n0 = pc.projection_conv.launches
    with torch.no_grad():
        got = pc.projection_conv(img, packed, 128, *bs)
        again = pc.projection_conv(img, packed, 128, *bs)
        torch.cuda.synchronize()
        assert pc.projection_conv.launches == n0 + 2
        for y, y2, w, b in zip(got, again, ws, bs):
            ref = F.conv2d(img.double(), w.double(), b.double(),
                           padding="same")
            plain = F.conv2d(img, w, b, padding="same")
            scale = float(ref.abs().max())
            limit = 2 * rel(plain, ref, scale)
            assert torch.equal(y, y2)
            for region in (np.s_[:], np.s_[..., [0, -1], :],
                           np.s_[..., :, [0, -1]]):
                err = rel(y[region], ref[region], scale)
                assert err <= limit, (region, err, limit)


@pytest.mark.cuda
def test_cuda_bias(cuda):
    img, ws, bs = conv_inputs(1, 33, 70, 128, 128, cuda, seed=3)
    zeros = pc.pack_weights(torch.zeros_like(ws[0]), torch.zeros_like(ws[1]))
    with torch.no_grad():
        for y, b in zip(pc.projection_conv(img, zeros, 128, *bs), bs):
            assert torch.equal(y, b.view(1, -1, 1, 1).expand_as(y))
        got = pc.projection_conv(img, pc.pack_weights(*ws), 128)
        for y, w in zip(got, ws):
            ref = F.conv2d(img.double(), w.double(), padding="same")
            plain = F.conv2d(img, w, padding="same")
            scale = float(ref.abs().max())
            assert rel(y, ref, scale) <= 2 * rel(plain, ref, scale)


@pytest.mark.cuda
def test_cuda_output_strides_are_the_conv_paths(cuda, monkeypatch):
    img, ws, bs = conv_inputs(2, 16, 40, 128, 128, cuda)
    with torch.no_grad():
        got = pc.projection_conv(img, pc.pack_weights(*ws), 128, *bs)
        plain = F.conv2d(img, ws[0], bs[0], padding="same")
        assert all(y.stride() == plain.stride() for y in got)
        attn = attention(H=16, W=40, device=cuda)
        x = torch.randn(2, 640, 128, device=cuda)
        n0 = pc.projection_conv.launches
        views = attn.project(x)
        assert pc.projection_conv.launches == n0 + 1
        monkeypatch.setattr(tt, "projection_conv_route", lambda *a: "plain")
        plain_views = attn.project(x)
        assert pc.projection_conv.launches == n0 + 1
    for a, b in zip(views, plain_views):
        assert a.shape == b.shape == (2, 8, 640, 16)
        assert a.stride() == b.stride() == (640 * 128, 16, 128, 1)


@pytest.mark.cuda
def test_cuda_launches_once_a_block_without_grad(cuda):
    model = tt.TransolverStructured2D(H=32, W=64, n_layers=3, n_hidden=128,
                                      n_head=8, slice_num=8, device=cuda)
    x = torch.rand(1, 32 * 64, 7, device=cuda,
                   generator=torch.Generator(cuda).manual_seed(1))
    n0 = pc.projection_conv.launches
    with torch.no_grad():
        model(x)
        model(x)
    assert pc.projection_conv.launches == n0 + 6
    with torch.enable_grad():
        u, v, _ = model(x)
        (u.square().mean() + v.square().mean()).backward()
    assert pc.projection_conv.launches == n0 + 6
    for name, p in model.named_parameters():
        if "in_project" in name:
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
    bf16 = tt.TransolverStructured2D(H=32, W=64, n_layers=2, n_hidden=128,
                                     n_head=8, slice_num=8, device=cuda,
                                     dtype=torch.bfloat16)
    with torch.no_grad():
        bf16(x.bfloat16())
    assert pc.projection_conv.launches == n0 + 6


@pytest.mark.cuda
def test_cuda_cell_transolver_matches_the_conv_path(cuda, monkeypatch):
    """The ``transolver-serve-b1`` cell's model on the kernel's route
    against itself on the ``F.conv2d`` path and against the benchmark's
    plain reference in float64."""
    sys.path.insert(0, str(ROOT))
    from benchmarks.drivers.serve import make_inputs
    from benchmarks.models import transolver as family
    from benchmarks.reference import transolver as ref

    cfg = json.loads((ROOT / "benchmarks/configs/transolver-structured.json")
                     .read_text())
    limit = json.loads((ROOT / "benchmarks/limits/transolver-serve-b1.json")
                       .read_text())["uv_rel_max"]
    model, w = family.build(cfg, 2 ** 31 + 25, cuda)
    x = make_inputs(1, 128, 506, 2 ** 31 + 25, cuda)[0]
    last = getattr(model, f"blocks_{model.n_layers - 1}")
    psi = []
    hook = last.register_forward_hook(lambda m, i, o: psi.append(o))
    n0 = pc.projection_conv.launches
    try:
        with torch.no_grad():
            u, v, _ = model(x)
            torch.cuda.synchronize()
            assert pc.projection_conv.launches == n0 + model.n_layers
            monkeypatch.setattr(tt, "projection_conv_route",
                                lambda *a: "plain")
            up, vp, _ = model(x)
            assert pc.projection_conv.launches == n0 + model.n_layers
    finally:
        hook.remove()
    assert rel(psi[0], psi[1].double(), float(psi[1].abs().max())) <= 1e-4
    with torch.no_grad():
        ur, vr = ref.forward(x.double(), {k: t.double() for k, t in
                                          w.items()}, family.dims(cfg))
    scale = max(float(ur.abs().max()), float(vr.abs().max()))
    # the curl head's differences lose digits: u and v of the two float32
    # paths agree as well as the F.conv2d path agrees with float64
    plain_err = max(rel(up, ur, scale), rel(vp, vr, scale))
    assert max(rel(u, up.double(), scale),
               rel(v, vp.double(), scale)) <= 2 * plain_err
    err = max(rel(u, ur, scale), rel(v, vr, scale))
    assert err <= limit, err
