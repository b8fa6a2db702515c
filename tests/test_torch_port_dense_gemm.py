"""The ViT family's Dense layers, ``ops/dense_gemm.py`` and
``models/vit.py::_Linear``.

On the CPU (every test without the ``cuda`` marker):

1. The routing rule as a pure predicate of (device type, dtype, grad,
   rows, d_in, d_out): the kernel for float32 on the card outside autograd
   with d_in a multiple of 32, d_out of 128, at least 192 rows and no more
   output columns than rows (every Dense layer of ViT-Base's and SAM
   ViT-B's blocks, and of ``ModelConfig``'s default ViT); the plain path
   for CPU tensors, inputs that require grad under grad mode, bfloat16,
   float16 and float64, ViT-Base's field head (768 → 129,536) at 1, 128
   and 4,096 rows, its 112-wide patch embedding and SAM's 32-wide field
   head.
2. ``pack_weight`` lays the weight out as the kernel reads it (every
   element against the layout written out index by index, hi + lo = w and
   hi = ``tf32_split(w)``'s to the bit) and refuses shapes it cannot lay
   out; ``dense_gemm`` refuses inputs off its route (ValueError, no
   launch); the kernel's plain version agrees with ``F.linear`` (and
   GELU) in float64 as float32 does.
3. ``_Linear`` off the kernel's route is ``F.linear`` (with ``gelu=True``
   ``F.gelu`` after it) to the bit, float32 and float64, launches nothing,
   packs nothing and lets gradients through; the packed weight is made
   once and again only when the weight is written in place or replaced
   (``ops/_cuda.py::packed_once``, which the Transolver's projections
   share).
4. The kernel is among the library's sources and its ctypes signature
   passes every pointer and the stream as ``c_void_p``.
5. ``vit_dense_kernel_share`` and ``samvit_dense_kernel_share`` on the
   program's spans: the device time launched inside
   ``pmc.kernel.dense_gemm`` over that inside the Dense layers' spans;
   None on a trace without the kernel's span (the parent's, or the plain
   path's).

On the card (marked ``cuda``; they skip without one, and the file imports
no JAX, so it runs on the card's machine)::

    python -m pytest -o addopts="" --noconftest -m cuda \\
        tests/test_torch_port_dense_gemm.py

6. The kernel against ``F.linear`` in float64 at every Dense shape of the
   two cells (ViT-Base at 4,049 rows, SAM ViT-B at 4,048 and at 7,448
   padded window slots) and at ragged row counts (four tiles and one
   row; four and sixteen tiles and 81 rows), bias and GELU on and off:
   max |Δ| / max |float64| no worse than 1.5× float32 ``F.linear``'s
   (cuBLAS, TF32 off);
   the same bits on a second call; one launch a call. At the default
   ViT's widths (d_in 128, 256), where float32 ``F.linear`` sums only a
   few hundred terms and reads ~2e-7, the kernel is held to 1e-6.
7. It refuses rows it cannot read in place (not contiguous), and
   ``_Linear`` gives such rows to ``F.linear``.
8. ViT-Base and SAM ViT-B at the cells' shapes against the benchmark's
   float64 references under each cell's limit, 48 launches a forward;
   training (grad on) launches none; ViT-Base at B = 128 without grad
   (an evaluation after training at that batch) runs its blocks on the
   kernel and its field head (cls pooling: the strided ``x[:, 0]``) on
   ``F.linear``, never packing that head's weight.
"""

import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pbml_mantle_convection_tpu_torch.models import vit as tvit
from pbml_mantle_convection_tpu_torch.ops import _cuda
from pbml_mantle_convection_tpu_torch.ops import dense_gemm as dg
from pbml_mantle_convection_tpu_torch.ops.projection_conv import tf32_split

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks import run  # noqa: E402
from benchmarks.harness import program_spans as ps  # noqa: E402
from benchmarks.harness.common import TraceView  # noqa: E402
from benchmarks.harness.trace import Trace  # noqa: E402

F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize("device,dtype,grad,rows,d_in,d_out,want", [
    ("cuda", F32, False, 4049, 768, 2304, "kernel"),     # ViT qkv
    ("cuda", F32, False, 4049, 3072, 768, "kernel"),     # MLP2
    ("cuda", F32, False, 7448, 768, 768, "kernel"),      # SAM window proj
    ("cuda", F32, False, 1009, 128, 768, "kernel"),      # default ViT qkv
    ("cuda", F32, False, 192, 32, 128, "kernel"),
    ("cuda", F32, False, 768, 768, 768, "kernel"),
    ("cuda", F32, False, 1, 768, 129536, "plain"),       # ViT-Base's head
    ("cuda", F32, False, 128, 768, 129536, "plain"),     # at B = 128
    ("cuda", F32, False, 4096, 768, 129536, "plain"),    # at B = 4,096
    ("cuda", F32, False, 767, 768, 768, "plain"),
    ("cuda", F32, False, 4048, 112, 768, "plain"),       # its embedding
    ("cuda", F32, False, 4048, 256, 32, "plain"),        # SAM's head
    ("cuda", F32, False, 191, 32, 128, "plain"),
    ("cuda", F32, False, 4049, 784, 768, "plain"),
    ("cuda", F32, False, 4049, 768, 192, "plain"),
    ("cuda", F32, True, 4049, 768, 768, "plain"),
    ("cuda", F64, False, 4049, 768, 768, "plain"),
    ("cuda", torch.bfloat16, False, 4049, 768, 768, "plain"),
    ("cuda", torch.float16, False, 4049, 768, 768, "plain"),
    ("cpu", F32, False, 4049, 768, 768, "plain"),
])
def test_route(device, dtype, grad, rows, d_in, d_out, want):
    assert dg.route(device, dtype, grad, rows, d_in, d_out) == want


def packed_index(o, c, hl, stages):
    """Where ``pack_weight`` puts part ``hl`` (0 hi, 1 lo) of weight
    (o, c), written out index by index."""
    tile, o = divmod(o, 128)
    group, row = divmod(o, 8)
    stage, c = divmod(c, 32)
    a, c = divmod(c, 16)
    step, c = divmod(c, 4)
    b, half = divmod(c, 2)
    k4 = 2 * a + b
    block = ((tile * stages + stage) * 2 + hl) * 4 + step
    return block * 1024 + group * 64 + half * 32 + row * 4 + k4


@pytest.mark.parametrize("d_out,d_in", [(128, 256), (256, 64)])
def test_pack_weight_layout(d_out, d_in):
    w = torch.randn(d_out, d_in, generator=torch.Generator().manual_seed(d_in))
    packed = dg.pack_weight(w)
    assert packed.shape == dg.packed_shape(d_in, d_out)
    assert packed.is_contiguous() and packed.numel() == 2 * w.numel()
    o, c = np.indices((d_out, d_in)).reshape(2, -1)
    hi, lo = (packed.reshape(-1)[torch.as_tensor(packed_index(
        o, c, hl, d_in // 32))] for hl in (0, 1))
    w = w.reshape(-1)
    assert torch.equal(hi + lo, w)
    assert torch.equal(hi, tf32_split(w)[0])
    assert torch.equal(lo, tf32_split(w)[1])


@pytest.mark.parametrize("shape", [(128, 48), (192, 64), (64, 64),
                                   (128, 64, 1)])
def test_pack_weight_refuses(shape):
    with pytest.raises(ValueError, match="pack_weight"):
        dg.pack_weight(torch.zeros(shape))


def test_refuses_inputs_off_its_route():
    w = torch.randn(128, 64)
    packed = dg.pack_weight(w)
    n0 = dg.dense_gemm.launches
    with pytest.raises(ValueError, match="float32 card tensors"):
        dg.dense_gemm(torch.randn(256, 64), packed)
    with pytest.raises(ValueError, match="pack_weight's output"):
        dg.dense_gemm(torch.randn(256, 64), w)
    assert dg.dense_gemm.launches == n0


@pytest.mark.parametrize("bias,gelu", [(True, True), (False, False)])
def test_plain_version_agrees_with_linear(bias, gelu):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 45, 96, generator=g)
    w = (torch.rand(128, 96, generator=g) * 2 - 1) / 96 ** 0.5
    b = torch.rand(128, generator=g) if bias else None

    def linear(*a):
        y = F.linear(*a)
        return F.gelu(y) if gelu else y

    want = linear(x.double(), w.double(), None if b is None else b.double())
    scale = float(want.abs().max())
    got = dg.dense_gemm_plain(x, w, b, gelu)
    assert got.shape == want.shape and got.dtype == F32
    f32 = float((linear(x, w, b).double() - want).abs().max()) / scale
    assert float((got.double() - want).abs().max()) / scale <= 2 * f32


@pytest.mark.parametrize("dtype", [F32, F64])
def test_linear_off_the_route_is_f_linear_to_the_bit(dtype):
    lin = tvit._Linear(np.random.default_rng(0), 96, 256).to(dtype=dtype)
    with torch.no_grad():
        lin.bias.uniform_(-1, 1)
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(3, 50, 96)),
                        dtype=dtype)
    n0 = dg.dense_gemm.launches
    with torch.no_grad():
        y = F.linear(x, lin.weight, lin.bias)
        assert torch.equal(lin(x), y)
        assert torch.equal(lin(x, gelu=True), F.gelu(y))
    assert dg.dense_gemm.launches == n0
    assert lin._packed is None       # packed only on the kernel's route


def test_linear_lets_gradients_through():
    lin = tvit._Linear(np.random.default_rng(2), 64, 128)
    x = torch.randn(200, 64, requires_grad=True)
    lin(x, gelu=True).square().sum().backward()
    for t in (x, lin.weight, lin.bias):
        assert t.grad is not None and float(t.grad.abs().max()) > 0


def test_packed_weight_follows_the_weight():
    lin = tvit._Linear(np.random.default_rng(4), 64, 128)
    first = lin.packed_weight()
    assert lin.packed_weight() is first
    assert torch.equal(first, dg.pack_weight(lin.weight))
    with torch.no_grad():
        lin.weight.mul_(2.0)
    second = lin.packed_weight()
    assert second is not first
    assert torch.equal(second, dg.pack_weight(lin.weight))
    lin.load_state_dict({k: v.clone() + 1 for k, v in
                         lin.state_dict().items()})
    third = lin.packed_weight()
    assert third is not second
    assert torch.equal(third, dg.pack_weight(lin.weight))


def test_kernel_signature_passes_pointers_as_void_p():
    assert "dense_gemm.cu" in _cuda.SOURCES
    P, I = ctypes.c_void_p, ctypes.c_int
    assert _cuda._SIGNATURES["pmc_dense_gemm"] == [P] * 4 + [I] * 4 + [P]


# -- the two metrics on a trace -------------------------------------------
def span(name, a, b):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a,
            "dur": b - a}


def op(name, a, b, corr, launch):
    return [{"ph": "X", "cat": "kernel", "name": name, "ts": a,
             "dur": b - a, "args": {"correlation": corr}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": launch, "dur": 1, "args": {"correlation": corr}}]


# one block of each model: the Dense layers' spans, the kernel's span in
# two of them, a copy launched in the third outside the kernel's span
SHARES = {
    "vit_dense_kernel_share": ("vit-serve-b1", "vit", [
        "pmc.vit.forward", "pmc.vit.qkv", "pmc.vit.attn.out",
        "pmc.vit.mlp"]),
    "samvit_dense_kernel_share": ("samvit-serve-b1", "samvit", [
        "pmc.samvit.forward", "pmc.samvit.qkv", "pmc.samvit.out",
        "pmc.samvit.mlp"]),
}
KERNEL = [span("pmc.kernel.dense_gemm", 6, 9),
          span("pmc.kernel.dense_gemm", 26, 29)]
CHANGE = (op("dense_gemm_kernel", 100, 400, 1, 7)
          + op("copy", 400, 500, 2, 17)
          + op("dense_gemm_kernel", 500, 1100, 3, 27))
PARENT = (op("sgemm", 100, 900, 1, 7) + op("copy", 900, 1000, 2, 17)
          + op("sgemm", 1000, 2600, 3, 27))


def share(tmp_path, monkeypatch, name, events):
    cell, family_name, _ = SHARES[name]
    family = __import__(f"benchmarks.models.{family_name}",
                        fromlist=["dims"])
    monkeypatch.setattr(ps, "TRACES", tmp_path)
    (tmp_path / f"{cell}.json").write_text(
        json.dumps({"traceEvents": events}))
    cfg = run.cell_of(run.load_manifest(), cell)[1]
    view = TraceView(Trace(events), 1, 2.5e-3, 2.5e-3, {}, cfg,
                     family.dims(cfg), cfg["peaks"])
    return run.reader(name)(view)


def spans_of(name):
    forward, *dense = SHARES[name][2]
    return [span(forward, 0, 100)] + [span(s, 10 * i + 5, 10 * i + 10)
                                      for i, s in enumerate(dense)]


@pytest.mark.parametrize("name", sorted(SHARES))
def test_share_of_the_dense_spans_in_the_kernels_span(tmp_path, monkeypatch,
                                                      name):
    got = share(tmp_path, monkeypatch, name,
                spans_of(name) + KERNEL + CHANGE)
    assert got == pytest.approx(100 * 900 / 1000)


@pytest.mark.parametrize("name", sorted(SHARES))
@pytest.mark.parametrize("with_spans", [True, False])
def test_share_is_none_without_the_kernels_span(tmp_path, monkeypatch, name,
                                                with_spans):
    events = (spans_of(name) if with_spans else []) + PARENT
    assert share(tmp_path, monkeypatch, name, events) is None


@pytest.mark.parametrize("name", sorted(SHARES))
def test_share_listed_for_its_cell_alone(name):
    m, = [m for m in run.load_manifest()["per_layer"] if m["name"] == name]
    assert (m["layer"], m["moves"], m["source"], m["workloads"]) == (
        "kernels", "forwards_per_s", "device_trace", [SHARES[name][0]])


# -- on the card ----------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel(a, ref):
    return float((a.double() - ref).abs().max()) / float(ref.abs().max())


def operands(rows, d_in, d_out, bias, device, seed):
    """Unit-normal rows (a LayerNorm's output) and a weight and bias
    ~ U(-1/√d_in, 1/√d_in), as ``_Linear`` draws them."""
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn(rows, d_in, generator=g, device=device)
    bound = d_in ** -0.5
    w = (torch.rand(d_out, d_in, generator=g, device=device) * 2 - 1) * bound
    b = ((torch.rand(d_out, generator=g, device=device) * 2 - 1) * bound
         if bias else None)
    return x, w, b


# (rows, d_in, d_out, bias, gelu): the cells' shapes (ViT-Base's qkv has
# no bias; SAM's has), then ragged row counts at their widths
CELL_SHAPES = [(4049, 768, 2304, False, False), (4049, 768, 768, True, False),
               (4049, 768, 3072, True, True), (4049, 3072, 768, True, False),
               (4048, 768, 2304, True, False), (4048, 768, 768, True, False),
               (4048, 768, 3072, True, True), (4048, 3072, 768, True, False),
               (7448, 768, 2304, True, False), (7448, 768, 768, True, False),
               (769, 768, 768, True, True), (849, 3072, 768, False, False),
               (3153, 768, 3072, False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d_in,d_out,bias,gelu", CELL_SHAPES)
def test_cuda_kernel_matches_float64(cuda, rows, d_in, d_out, bias, gelu):
    x, w, b = operands(rows, d_in, d_out, bias, cuda, rows + d_out)
    packed = dg.pack_weight(w)
    n0 = dg.dense_gemm.launches
    got = dg.dense_gemm(x, packed, b, gelu)
    again = dg.dense_gemm(x, packed, b, gelu)
    torch.cuda.synchronize()
    assert dg.dense_gemm.launches == n0 + 2
    want = F.linear(x.double(), w.double(), None if b is None else b.double())
    plain = F.linear(x, w, b)
    if gelu:
        want, plain = F.gelu(want), F.gelu(plain)
    err, limit = rel(got, want), 1.5 * rel(plain, want)
    assert err <= limit, (err, limit)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d_in,d_out", [(1009, 128, 768),
                                             (1009, 256, 128), (193, 32, 128)])
def test_cuda_kernel_at_narrow_widths(cuda, rows, d_in, d_out):
    x, w, b = operands(rows, d_in, d_out, True, cuda, rows)
    got = dg.dense_gemm(x.view(1, rows, d_in), dg.pack_weight(w), b, True)
    assert got.shape == (1, rows, d_out)
    want = F.gelu(F.linear(x.double(), w.double(), b.double()))
    assert rel(got[0], want) <= 1e-6


@pytest.mark.cuda
def test_cuda_kernel_refuses_rows_it_cannot_read_in_place(cuda):
    x, w, _ = operands(256, 128, 128, False, cuda, 0)
    n0 = dg.dense_gemm.launches
    with pytest.raises(ValueError, match="contiguous"):
        dg.dense_gemm(x.t().contiguous().t(), dg.pack_weight(w))
    lin = tvit._Linear(np.random.default_rng(0), 128, 128).to(cuda)
    strided = torch.randn(256, 2, 128, device=cuda)[:, 0]
    with torch.no_grad():
        got = lin(strided, gelu=True)
    assert dg.dense_gemm.launches == n0 and lin._packed is None
    assert torch.equal(got, F.gelu(F.linear(strided, lin.weight, lin.bias)))


def cell_reading(cell, config, module, seed):
    """The cell's model at its shapes on the card, the kernel's launches in
    one forward, and its check number against the float64 reference."""
    family = __import__(f"benchmarks.models.{module}", fromlist=["build"])
    ref = __import__(f"benchmarks.reference.{module}", fromlist=["forward"])
    cfg = json.loads((ROOT / "benchmarks/configs" / config).read_text())
    limit = json.loads((ROOT / "benchmarks/limits" / f"{cell}.json")
                       .read_text())["uv_rel_max"]
    model, w = family.build(cfg, seed, "cuda")
    x = torch.as_tensor(np.random.default_rng(seed).uniform(
        0.0, 1.0, size=(1, 128, 506, 7)), dtype=F32, device="cuda")
    with torch.no_grad():
        model(x)
        n0 = dg.dense_gemm.launches
        u, v, _ = model(x)
        torch.cuda.synchronize()
        launches = dg.dense_gemm.launches - n0
        ur, vr = ref.forward(x.double(), {k: t.double() for k, t in
                                          w.items()}, family.dims(cfg))
    scale = max(float(ur.abs().max()), float(vr.abs().max()))
    err = max(float((u.double() - ur).abs().max()),
              float((v.double() - vr).abs().max())) / scale
    return launches, err, limit


@pytest.mark.cuda
@pytest.mark.parametrize("cell,config,module", [
    ("vit-serve-b1", "vit-base.json", "vit"),
    ("samvit-serve-b1", "sam-vit-b.json", "samvit")])
def test_cuda_cell_models_match_float64(cuda, cell, config, module):
    launches, err, limit = cell_reading(cell, config, module, 2 ** 31 + 27)
    assert launches == 48
    assert err <= limit, err


@pytest.mark.cuda
def test_cuda_training_takes_the_plain_path(cuda):
    """A ViTField of 21 tokens (16 × 20 field, 8 × 2 patches) whose four
    Dense layers a block (at most 384 outputs) take the kernel at 20 × 21
    = 420 rows."""
    field = tvit.ViTField((16, 20), (8, 2), dim=128, depth=2, heads=2,
                          mlp_dim=256, device=cuda)
    x = torch.rand(20, 16, 20, 7, device=cuda,
                   generator=torch.Generator(cuda).manual_seed(4))
    n0 = dg.dense_gemm.launches
    with torch.enable_grad():
        u, v, _ = field(x)
        (u.square().mean() + v.square().mean()).backward()
    assert dg.dense_gemm.launches == n0
    for name, p in field.named_parameters():
        if "Transformer_0" in name:
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
    with torch.no_grad():
        field(x)
        assert dg.dense_gemm.launches == n0 + 2 * 4
        field(x[:8])            # 168 rows: below one row tile
    assert dg.dense_gemm.launches == n0 + 2 * 4


@pytest.mark.cuda
def test_cuda_vit_base_at_b128_keeps_its_head_on_f_linear(cuda):
    """ViT-Base at the cell's configuration, B = 128 without grad: the
    blocks' 48 Dense layers on the kernel (at 128 × 4,049 rows), the field
    head (128 cls rows, strided, 768 → 129,536) on ``F.linear`` with its
    weight never packed; sample 0 as at B = 1, within the cell's limit."""
    from pbml_mantle_convection_tpu_torch.models.registry import (
        ModelConfig, build_model)
    cfg = json.loads((ROOT / "benchmarks/configs/vit-base.json").read_text())
    limit = json.loads((ROOT / "benchmarks/limits/vit-serve-b1.json")
                       .read_text())["uv_rel_max"]
    model = build_model(ModelConfig(**cfg["model"], **cfg["grid"]),
                        device=cuda)
    x = torch.rand(128, 128, 506, 7, device=cuda,
                   generator=torch.Generator(cuda).manual_seed(5))
    head = model.vit.Dense_1
    with torch.no_grad():
        n0 = dg.dense_gemm.launches
        u, v, _ = model(x)
        torch.cuda.synchronize()
        assert dg.dense_gemm.launches == n0 + 48
        u1, v1, _ = model(x[:1])
    assert head._packed is None
    assert torch.isfinite(u).all() and torch.isfinite(v).all()
    scale = max(float(u1.abs().max()), float(v1.abs().max()))
    assert max(float((u[:1] - u1).abs().max()),
               float((v[:1] - v1).abs().max())) <= limit * scale
