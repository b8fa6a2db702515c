"""ViT-Base on the port's normal path, on the CPU.

1. ``ModelConfig.mlp_dim``: unset, the registry builds the ViT with the
   JAX registry's MLP width, 2 · n_hidden (names and shapes of JAX's
   ``eval_shape``); set, the blocks' MLPs take it (ViT-Base's 4 · 768),
   and the benchmark's ``vit-base`` configuration file builds at its
   published widths (one block and a small grid here: the full model is
   187.8 M parameters).
2. The port's ``ViTField`` against the benchmark's plain reference
   (``benchmarks/reference/vit.py``) on the benchmark's seeded weights at
   a small size (16×20 grid, 8×2 patches, dim 48, 3 heads of 64): float64
   ≤ 1e-10 of the largest output; float32 ≤ 1e-5 (float32's unit
   roundoff, 6e-8, over Dense sums of up to 192 terms, a 21-token
   softmax and two blocks' LayerNorms reads ~3e-7; 1e-5 leaves room and
   stays far below the faults of item 4).
3. ``benchmarks/counts/vit.py`` at the published shapes against counts
   made by hand: 1.293 TFLOP a forward, 604 GFLOP and 597 MB of it in
   the attention core.
4. Under ``torch.profiler`` a forward opens its ``pmc.vit.*`` spans, each
   block's inside the forward's: one embedding and one head, per block
   two LayerNorms, the qkv, the attention core, its output and the MLP,
   and the closing LayerNorm.
5. Two planted faults read over 10× the cell's limit
   (``benchmarks/limits/vit-serve-b1.json``): the 1/√64 scale left out of
   the scores (0.04-0.05 at this width, where the scores are small), and
   mean pooling in place of the cls token (~1).
"""

import collections
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.models import registry as jreg  # noqa: E402
from pbml_mantle_convection_tpu_torch.models import registry as treg  # noqa: E402
from pbml_mantle_convection_tpu_torch.models import vit as tvit  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks.counts import vit as counts  # noqa: E402
from benchmarks.harness.weights import make_weights  # noqa: E402
from benchmarks.models import vit as family  # noqa: E402
from benchmarks.reference import vit as ref  # noqa: E402

F64 = torch.float64
H, W = 16, 20
SMALL = dict(network="vit", n_layers=2, n_hidden=48, n_head=3, mlp_dim=192,
             p_pred=False)
CONFIG = json.loads((ROOT / "benchmarks/configs/vit-base.json").read_text())
LIMIT = json.loads((ROOT / "benchmarks/limits/vit-serve-b1.json")
                   .read_text())["uv_rel_max"]


def shapes(model):
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("width,depth,heads", [(32, 2, 2), (48, 1, 3)])
def test_default_mlp_width_is_jaxs(width, depth, heads):
    kw = dict(network="vit", n_hidden=width, n_layers=depth, n_head=heads,
              H=H, W=W)
    jcfg, tcfg = jreg.ModelConfig(**kw), treg.ModelConfig(**kw)
    assert tcfg.mlp_dim is None
    x = jnp.zeros((1, H, W, jcfg.channels[0]))
    p = jax.eval_shape(jreg.build_model(jcfg).init, jax.random.PRNGKey(0), x)
    want = {k: tuple(v.shape) for k, v in from_jax_params(
        jax.tree.map(lambda a: np.zeros(a.shape), p)).items()}
    got = shapes(treg.build_model(tcfg, device="cpu"))
    assert got == want
    assert got["vit.Transformer_0.ff_0.Dense_0.weight"] == (2 * width, width)


def test_explicit_mlp_width_builds_four_times_n_hidden():
    kw = dict(network="vit", n_hidden=32, n_layers=2, n_head=2, H=H, W=W)
    base = shapes(treg.build_model(treg.ModelConfig(**kw), device="cpu"))
    wide = shapes(treg.build_model(treg.ModelConfig(**kw, mlp_dim=128),
                                   device="cpu"))
    assert set(wide) == set(base)
    for i in range(2):
        ff = f"vit.Transformer_0.ff_{i}"
        assert wide[f"{ff}.Dense_0.weight"] == (128, 32)
        assert wide[f"{ff}.Dense_0.bias"] == (128,)
        assert wide[f"{ff}.Dense_1.weight"] == (32, 128)
    assert {k: v for k, v in wide.items() if ".ff_" not in k} == \
        {k: v for k, v in base.items() if ".ff_" not in k}


def test_vit_base_config_builds_at_its_published_widths():
    """The configuration file's model, through ``build_model``: 12 heads
    of 64 over 768, MLP 3,072 (one block on a 16×20 grid here; the cell
    runs all 12 at 128×506)."""
    m = CONFIG["model"]
    assert (m["n_layers"], m["n_hidden"], m["n_head"], m["mlp_dim"]) == \
        (12, 768, 12, 3072)
    assert CONFIG["reduced"] == [] and CONFIG["family"] == "vit"
    model = treg.build_model(treg.ModelConfig(**{**m, "n_layers": 1},
                                              H=H, W=W), device="cpu")
    s = shapes(model)
    attn = model.vit.Transformer_0.attn_0
    assert (attn.heads, attn.dim_head) == (12, 64)
    assert s["vit.Transformer_0.attn_0.Dense_0.weight"] == (3 * 768, 768)
    assert s["vit.Transformer_0.ff_0.Dense_0.weight"] == (3072, 768)
    assert model.vit.patch_size == (8, 2)
    # the full model's parameters, from the shapes
    N = 16 * 253 + 1
    block = (3 * 768 * 768 + 768 * 768 + 768 + 2 * 768 * 3072 + 3072 + 768
             + 4 * 768)
    full = (12 * block + 2 * 112 + 112 * 768 + 768 + 2 * 768
            + N * 768 + 768 + 2 * 768 + 768 * 2 * 128 * 506 + 2 * 128 * 506)
    assert round(full / 1e6, 1) == 187.8


def small(seed=5, dtype=F64):
    """(the port's ViTField at SMALL with the benchmark's seeded weights,
    the weights, the dimensions, a seeded (2, H, W, 7) input)."""
    cfg = {"model": SMALL, "grid": {"H": H, "W": W}}
    model = treg.build_model(treg.ModelConfig(**SMALL, H=H, W=W,
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


def test_port_matches_the_reference_in_float64():
    model, w, m, x = small()
    assert m["patch"] == (8, 2) and m["dim_head"] == 64
    assert reading(model, w, m, x) <= 1e-10


def test_port_matches_the_reference_in_float32():
    model, w, m, x = small(seed=6, dtype=torch.float32)
    assert reading(model, w, m, x.float()) <= 1e-5


def test_counts_at_the_published_shapes():
    m = family.dims(CONFIG)
    N = 16 * 253 + 1
    assert counts.tokens(m) == N == 4049
    core = 2 * 2 * 12 * N * N * 64
    assert counts.attention_core(m) == (core, 4 * N * 768 * 4)
    dense = 2 * N * (768 * 2304 + 768 * 768 + 2 * 768 * 3072)
    embed = 2 * 4048 * 112 * 768
    head = 2 * 768 * 2 * 128 * 506
    total = embed + 12 * (dense + core) + head
    assert counts.forward_flops(m) == total
    assert round(total / 1e12, 3) == 1.293
    assert round(12 * core / 1e9) == 604
    assert round(12 * counts.attention_core(m)[1] / 1e6) == 597


def test_a_forward_opens_the_vit_spans(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    model, _, _, x = small(seed=9)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(x)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in
             json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"
             and e["name"].startswith("pmc.")]
    L = SMALL["n_layers"]
    assert collections.Counter(n for n, _, _ in spans) == {
        "pmc.vit.forward": 1, "pmc.vit.embed": 1, "pmc.vit.norm": 2 * L + 1,
        "pmc.vit.qkv": L, "pmc.vit.attn.core": L, "pmc.vit.attn.out": L,
        "pmc.vit.mlp": L, "pmc.vit.head": 1}
    (_, a, b), = [s for s in spans if s[0] == "pmc.vit.forward"]
    assert all(a <= s[1] and s[2] <= b for s in spans)


class _Unscaled:
    """``torch`` as ``models/vit.py`` sees it, but for a softmax whose
    argument is multiplied back by √64: the scores' 1/√64 left out."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def softmax(x, dim):
        return torch.softmax(x * 8.0, dim=dim)


def test_scale_left_out_reads_far_above_the_limit(monkeypatch):
    model, w, m, x = small(seed=7)
    monkeypatch.setattr(tvit, "torch", _Unscaled())
    assert reading(model, w, m, x) > 10 * LIMIT


def test_mean_pooling_reads_far_above_the_limit():
    model, w, m, x = small(seed=8)
    model.vit.pool = "mean"
    assert reading(model, w, m, x) > 10 * LIMIT
