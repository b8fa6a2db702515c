"""SAM's ViT image encoder on the port's normal path, on the CPU (and one
check on the card).

1. The port's ``SamViTField`` against the benchmark's plain reference
   (``benchmarks/reference/samvit.py``) on the benchmark's seeded weights
   (nonzero relative-position tables and qkv biases) at a size where both
   block kinds and padding on both axes occur: a 10 × 11 token grid,
   windows of 4 (padded to 12 × 12), 4 blocks of which 1 and 3 global,
   2 heads of 32. float64 ≤ 1e-10 of the largest output; float32 ≤ 1e-5
   (float32's unit roundoff over sums of up to 64 terms, softmaxes of up
   to 110 keys and 4 blocks' LayerNorms reads ~1e-7).
2. Three planted faults read far above that tolerance and over 10× the
   cell's limit (``benchmarks/limits/samvit-serve-b1.json``): the
   relative-position tables zeroed, the padded keys masked out of the
   window softmax, the global blocks run windowed.
3. The parts: ``window_partition`` and ``window_unpartition`` round-trip;
   ``get_rel_pos`` equals a loop over i − j; SAM's rule for the global
   blocks; the padded-slot count (3,400 of 7,448 at the cell's grid).
4. No forward of ``samvit`` launches ``dense_attention`` (which would
   drop the bias), and the new ``ModelConfig`` fields leave every other
   network of ``build_model`` unchanged to the bit.
5. The benchmark's ``sam-vit-b`` configuration builds at SAM ViT-B's
   published widths (3 of its 12 blocks here: one period), and a forward
   opens its ``pmc.samvit.*`` spans.
"""

import collections
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pbml_mantle_convection_tpu_torch.models import registry as treg
from pbml_mantle_convection_tpu_torch.models import samvit as tsam
from pbml_mantle_convection_tpu_torch.ops import dense_attention

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks.harness.weights import make_weights  # noqa: E402
from benchmarks.models import samvit as family  # noqa: E402
from benchmarks.reference import samvit as ref  # noqa: E402
from benchmarks.tests.test_bench_samvit import (  # noqa: E402
    mask_padded_keys, run_global_windowed, zero_rel_pos)

F64 = torch.float64
H, W = 80, 22                    # 8×2 patches: a 10 × 11 token grid
SMALL = dict(network="samvit", n_layers=4, n_hidden=64, n_head=2,
             mlp_dim=128, window_size=4, global_attn_indexes=(1, 3),
             neck_chans=8, p_pred=False)
CONFIG = json.loads((ROOT / "benchmarks/configs/sam-vit-b.json")
                    .read_text())
LIMIT = json.loads((ROOT / "benchmarks/limits/samvit-serve-b1.json")
                   .read_text())["uv_rel_max"]


def small(seed=5, dtype=F64, **over):
    """(the port's SamViTField at SMALL with the benchmark's seeded
    weights, the weights, the dimensions, a seeded (2, H, W, 7) input)."""
    model_cfg = {**SMALL, **over}
    cfg = {"model": model_cfg, "grid": {"H": H, "W": W}}
    model = treg.build_model(treg.ModelConfig(**model_cfg, H=H, W=W,
                                              dtype=dtype), device="cpu")
    w = make_weights({k: tuple(p.shape) for k, p in
                      model.named_parameters()}, family.weight_rule, seed,
                     "cpu", dtype)
    model.load_state_dict(w, strict=True)
    model.eval()
    x = torch.as_tensor(np.random.default_rng(seed).uniform(
        0.0, 1.0, size=(2, H, W, 7)), dtype=dtype)
    return model, w, family.dims(cfg), x


def reading(model, w, m, x) -> float:
    """The cell's check number: max|Δu,v| / max|u,v| of the float64
    reference."""
    w64 = {k: v.double() for k, v in w.items()}
    with torch.no_grad():
        u, v, _ = model(x)
        ur, vr = ref.forward(x.double(), w64, m)
    scale = max(float(ur.abs().max()), float(vr.abs().max()))
    return max(float((u.double() - ur).abs().max()),
               float((v.double() - vr).abs().max())) / scale


def test_small_size_has_both_kinds_and_padding():
    model, w, m, _ = small()
    assert [b.window_size for b in model.blocks] == [4, 0, 4, 0]
    assert model.grid == (10, 11) and m["patch"] == (8, 2)
    assert (model.window_slots, model.padded_slots) == (144, 34)
    for i in range(4):
        p = f"blocks.{i}.attn"
        assert float(w[f"{p}.rel_pos_h"].abs().max()) > 0.05
        assert float(w[f"{p}.rel_pos_w"].abs().max()) > 0.05
        assert float(w[f"{p}.qkv.bias"].abs().max()) > 0.01
    g = model.blocks[1].attn
    assert (g.rel_pos_h.shape, g.rel_pos_w.shape) == ((19, 32), (21, 32))


def test_port_matches_the_reference_in_float64():
    model, w, m, x = small()
    assert reading(model, w, m, x) <= 1e-10


def test_port_matches_the_reference_in_float32():
    model, w, m, x = small(seed=6, dtype=torch.float32)
    assert reading(model, w, m, x.float()) <= 1e-5


def test_p_pred_head_reads_three_fields():
    model, w, m, x = small(seed=7, p_pred=True)
    with torch.no_grad():
        u, v, p = model(x)
        ur, vr = ref.forward(x, w, {**m, "c_o": 3})
    assert p.shape == u.shape == (2, H, W)
    assert float((u - ur).abs().max()) <= 1e-12
    assert float((v - vr).abs().max()) <= 1e-12


@pytest.mark.parametrize("plant", ["zero_rel_pos", "mask_padded_keys",
                                   "run_global_windowed"])
def test_planted_fault_reads_far_above_the_limit(plant, monkeypatch):
    model, w, m, x = small(seed=8)
    if plant == "mask_padded_keys":
        mask_padded_keys(monkeypatch)
    else:
        {"zero_rel_pos": zero_rel_pos,
         "run_global_windowed": run_global_windowed}[plant](model)
    r = reading(model, w, m, x)
    assert r > 10 * LIMIT and r > 1e6 * 1e-10


@pytest.mark.parametrize("shape,window", [((1, 10, 11, 3), 4),
                                          ((2, 16, 253, 5), 14),
                                          ((1, 8, 12, 2), 4)])
def test_window_partition_round_trips(shape, window):
    x = torch.randn(*shape, dtype=F64)
    win, padded = tsam.window_partition(x, window)
    Hp, Wp = padded
    assert (Hp % window, Wp % window) == (0, 0)
    assert Hp - window < shape[1] <= Hp and Wp - window < shape[2] <= Wp
    assert win.shape == (shape[0] * Hp * Wp // window ** 2, window, window,
                         shape[3])
    # window (b, i, j) holds rows i·window.., columns j·window..
    nj = Wp // window
    assert torch.equal(win[nj + 1, 0, 0], x[0, window, window])
    pad = Hp * Wp - shape[1] * shape[2]
    assert int((win == 0).all(-1).sum()) == shape[0] * pad
    assert torch.equal(tsam.window_unpartition(win, window, padded,
                                               shape[1:3]), x)
    assert torch.equal(win, ref.window_partition(x, window)[0])


def test_cells_padding_is_3400_of_7448_slots():
    assert tsam.padded_grid(16, 253, 14) == (28, 266)
    assert 28 * 266 == 7448 == 38 * 196 and 7448 - 16 * 253 == 3400


@pytest.mark.parametrize("size", [1, 4, 14, 16])
def test_get_rel_pos_is_a_loop_over_i_minus_j(size):
    table = torch.randn(2 * size - 1, 3, dtype=F64)
    got = tsam.get_rel_pos(size, table)
    for i in range(size):
        for j in range(size):
            assert torch.equal(got[i, j], table[i - j + size - 1])
    with pytest.raises(ValueError, match="does not fit"):
        tsam.get_rel_pos(size + 1, table)


@pytest.mark.parametrize("depth,want", [(12, (2, 5, 8, 11)),
                                        (24, (5, 11, 17, 23)),
                                        (32, (7, 15, 23, 31)),
                                        (4, (0, 1, 2, 3)), (2, (0, 1))])
def test_sams_rule_for_the_global_blocks(depth, want):
    assert tsam.sam_global_blocks(depth) == want
    assert family.global_blocks(depth) == want


def test_unset_global_blocks_take_sams_rule():
    cfg = treg.ModelConfig(network="samvit", n_layers=8, n_hidden=8,
                           n_head=1, mlp_dim=8, window_size=4, neck_chans=4,
                           H=32, W=20)
    model = treg.build_model(cfg, device="cpu")
    assert cfg.global_attn_indexes is None
    assert model.global_attn_indexes == (1, 3, 5, 7)
    assert [b.window_size for b in model.blocks] == [4, 0] * 4


def test_a_forward_never_launches_dense_attention(monkeypatch):
    """The kernel computes softmax(q·kᵀ·scale)·v with no additive term:
    neither block kind may take it."""
    from pbml_mantle_convection_tpu_torch.models import vit

    kernel = dense_attention.dense_attention
    n = kernel.launches

    def refuse(*a, **k):
        raise AssertionError("dense_attention would drop the bias")

    monkeypatch.setattr(dense_attention, "dense_attention", refuse)
    monkeypatch.setattr(vit, "dense_attention", refuse)
    model, _, _, x = small(seed=9)
    with torch.no_grad():
        model(x)
    assert kernel.launches == n


OTHERS = [("newfluidnet", {}), ("fluidnet", {}), ("ifluidnet", {}),
          ("halfnewfluidnet", {}),
          ("multiscalenewfluidnet", {"multi_scales": (1e-3, 1e1)}),
          ("unet", {}), ("iunet", {}), ("convae", {"r_p": "zeros"}),
          ("transolver", {"n_hidden": 16, "n_layers": 1, "n_head": 2,
                          "slice_num": 4}),
          ("transolver_structured", {"n_hidden": 16, "n_layers": 1,
                                     "n_head": 2, "slice_num": 4}),
          ("vit", {"n_hidden": 16, "n_layers": 1, "n_head": 2})]


@pytest.mark.parametrize("net,extra", OTHERS, ids=[n for n, _ in OTHERS])
def test_new_fields_leave_other_networks_unchanged(net, extra):
    kw = dict(network=net, levels=2, c_h=8, repeats=1, H=16, W=20, **extra)
    a = treg.build_model(treg.ModelConfig(**kw), device="cpu")
    b = treg.build_model(treg.ModelConfig(
        **kw, window_size=3, global_attn_indexes=(0,), neck_chans=5),
        device="cpu")
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    if net == "vit":
        x = torch.rand(1, 16, 20, 7)
        with torch.no_grad():
            ya, yb = a(x), b(x)
        assert all(torch.equal(p, q) for p, q in zip(ya[:2], yb[:2]))


def test_sam_vit_b_config_builds_at_its_published_widths():
    """The configuration file's model, through ``build_model``: 12 heads
    of 64 over 768, MLP 3,072, windows of 14, global blocks 2, 5, 8, 11,
    neck 256 (blocks 0-2 here, one period of window, window, global); the
    full model's 89.2 M parameters from the shapes."""
    m = CONFIG["model"]
    assert (m["n_layers"], m["n_hidden"], m["n_head"], m["mlp_dim"],
            m["window_size"], m["global_attn_indexes"], m["neck_chans"]) == \
        (12, 768, 12, 3072, 14, [2, 5, 8, 11], 256)
    assert CONFIG["reduced"] == [] and CONFIG["family"] == "samvit"
    model = treg.build_model(treg.ModelConfig(**{**m, "n_layers": 3},
                                              **CONFIG["grid"]),
                             device="cpu")
    s = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert model.grid == (16, 253) and model.patch_size == (8, 2)
    assert [b.window_size for b in model.blocks] == [14, 14, 0]
    assert model.padded_slots == 3400 and model.window_slots == 7448
    a0, a2 = model.blocks[0].attn, model.blocks[2].attn
    assert (a0.heads, a0.dim_head) == (12, 64)
    assert model.blocks[0].norm1.eps == 1e-6
    assert s["blocks.0.attn.qkv.weight"] == (2304, 768)
    assert s["blocks.0.attn.qkv.bias"] == (2304,)
    assert s["blocks.0.mlp.lin1.weight"] == (3072, 768)
    assert s["blocks.0.attn.rel_pos_h"] == s["blocks.0.attn.rel_pos_w"] == \
        (27, 64)
    assert (a2.rel_pos_h.shape, a2.rel_pos_w.shape) == ((31, 64), (505, 64))
    assert s["patch_embed.weight"] == (768, 7, 8, 2)
    assert s["pos_embed"] == (1, 16, 253, 768)
    assert s["neck.0.weight"] == (256, 768, 1, 1)
    assert s["neck.2.weight"] == (256, 256, 3, 3)
    assert s["head.weight"] == (2 * 8 * 2, 256)
    n = {k: int(np.prod(v)) for k, v in s.items()}
    block = sum(v for k, v in n.items() if k.startswith("blocks.0.")
                and "rel_pos" not in k)
    assert block == (2 * 768 + 768 * 2304 + 2304 + 768 * 768 + 768
                     + 2 * 768 + 768 * 3072 + 3072 + 3072 * 768 + 768)
    three = sum(n.values())
    full = three + 6 * (block + 2 * 27 * 64) + 3 * (block + 536 * 64)
    assert round(full / 1e6, 1) == 89.2


def test_a_forward_opens_the_samvit_spans(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    model, _, _, x = small(seed=11)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(x)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in
             json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"
             and e["name"].startswith("pmc.")]
    L, win = 4, 2
    assert collections.Counter(n for n, _, _ in spans) == {
        "pmc.samvit.forward": 1, "pmc.samvit.embed": 1,
        "pmc.samvit.norm": 2 * L, "pmc.samvit.partition": 2 * win,
        "pmc.samvit.qkv": L, "pmc.samvit.attn.window": win,
        "pmc.samvit.attn.global": L - win, "pmc.samvit.relpos": L,
        "pmc.samvit.out": L, "pmc.samvit.mlp": L, "pmc.samvit.neck": 1,
        "pmc.samvit.head": 1}
    (_, a, b), = [s for s in spans if s[0] == "pmc.samvit.forward"]
    assert all(a <= s[1] and s[2] <= b for s in spans)
    cores = [s for s in spans if s[0].startswith("pmc.samvit.attn.")]
    for _, c, d in [s for s in spans if s[0] == "pmc.samvit.relpos"]:
        assert any(lo <= c and d <= hi for _, lo, hi in cores)


@pytest.mark.cuda
def test_the_cells_model_on_the_card_against_float64():
    """The cell's model at its published widths on the card (float32, TF32
    off): the float64 reference's check number under the cell's limit,
    and no ``dense_attention`` launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's model at its widths")
    from pbml_mantle_convection_tpu_torch.ops.dense_attention import (
        dense_attention as kernel)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, weights = family.build(CONFIG, 2 ** 31 + 41, "cuda")
    m = family.dims(CONFIG)
    x = torch.as_tensor(np.random.default_rng(41).uniform(
        0.0, 1.0, size=(1, 128, 506, 7)), dtype=torch.float32,
        device="cuda")
    n = kernel.launches
    assert reading(model, weights, m, x) <= LIMIT
    assert kernel.launches == n
