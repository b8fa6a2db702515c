"""The other models of the port against the JAX package's, in float64 on
the CPU, with the Flax weights carried across by ``from_jax_params``:

1. ``ops/curl.py::blur3x3`` and ``curl_head_cropped`` (≤1e-12);
2. ``models/layers.py``: ``SymmetricConv2d`` (every symmetry kind, SAME
   with each padding mode and dilation 2), ``SymmetricConv3d``,
   ``SpectralConv2d`` (also H < 2·modes, where the bottom rows' modes
   win), ``SpectralFluidLayer``, ``FluidLayer`` with ``use_symm``,
   ``dilation`` and ``drop_rate`` in eval (≤1e-12 for the layers);
3. ``models/vit.py``: ViTField and ViT (≤1e-9 of each output's max;
   the FluidNet family and the U-Net's options are in
   tests/test_torch_port_fluidnet_item6.py);
4. dropout on its own: the keep fraction within binomial bounds, kept
   values scaled by exactly 1/(1 − p), the same generator seed giving the
   same output, p = 0 giving the eval output;
5. the registry building every network as JAX's does (names, shapes),
   FluidNet ``-l 6`` at 128×506 refused eagerly where JAX's forward fails;
6. both converters against JAX's: ``from_jax_params`` of JAX's
   ``convert_fluidnet``/``convert_vit`` output equals the port's
   ``utils/torch_convert.py`` on the same reference state_dict (symmetric
   and spectral convs, FluidNet, the ViT), loaded strictly.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.models import layers as jl  # noqa: E402
from pbml_mantle_convection_tpu.models import registry as jreg  # noqa: E402
from pbml_mantle_convection_tpu.models import vit as jvit  # noqa: E402
from pbml_mantle_convection_tpu.ops import curl as jcurl  # noqa: E402
from pbml_mantle_convection_tpu.utils import torch_convert as jconv  # noqa: E402

from pbml_mantle_convection_tpu_torch.models import fluidnet as tfn  # noqa: E402
from pbml_mantle_convection_tpu_torch.models import layers as tl  # noqa: E402
from pbml_mantle_convection_tpu_torch.models import registry as treg  # noqa: E402
from pbml_mantle_convection_tpu_torch.models import vit as tvit  # noqa: E402
from pbml_mantle_convection_tpu_torch.ops import curl as tcurl  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils import torch_convert as tconv  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)

F64 = torch.float64


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _init(jm, x, key=0):
    return jax.jit(jm.init)(jax.random.PRNGKey(key), jnp.asarray(x))


def _apply(jm, p, x):
    return jax.jit(jm.apply)(p, jnp.asarray(x))


def _load(tm, params):
    tm = tm.to(F64)
    tm.load_state_dict(from_jax_params(_np(params)), strict=True)
    return tm


def _close(a, b, rel):
    """max |a − b| ≤ rel · max |b| (a torch tensor, b anything)."""
    b = np.asarray(b)
    a = a.detach().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-300)
    assert float(np.abs(a - b).max()) <= rel * scale


def _nchw(x):
    return torch.as_tensor(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


# ---------------------------------------------------------------- ops


@pytest.mark.parametrize("shape", [(9, 13), (2, 3, 7, 11)])
def test_blur3x3_and_cropped_curl_head_match_jax(shape):
    a = np.random.default_rng(0).normal(size=shape)
    _close(tcurl.blur3x3(torch.as_tensor(a)), jcurl.blur3x3(jnp.asarray(a)),
           1e-12)
    for got, want in zip(tcurl.curl_head_cropped(torch.as_tensor(a)),
                         jcurl.curl_head_cropped(jnp.asarray(a))):
        assert got.shape[-2:] == (shape[-2] - 2, shape[-1] - 2)
        _close(got, want, 1e-12)


# ------------------------------------------------------------- layers


SYMM2D = [
    dict(features=8, k=3, symmetry={"h": 4}),
    dict(features=8, k=5, symmetry={"v": 2}),
    dict(features=8, k=3, symmetry={"hv": 4}),
    dict(features=12, k=3, symmetry={"h": 2, "v": 2, "hv": 4}),
    dict(features=4, k=5, symmetry=None, use_bias=False),
    dict(features=8, k=3, symmetry={"h": 2}, padding="SAME",
         pad_mode="replicate", dilation=2),
    dict(features=8, k=5, symmetry={"hv": 8}, padding="SAME",
         pad_mode="constant"),
    dict(features=8, k=3, symmetry={"v": 4}, padding="SAME",
         pad_mode="reflect"),
]


@pytest.mark.parametrize("cfg", SYMM2D)
def test_symmetric_conv2d_matches_flax(cfg):
    """The unique (k, k, c_i, n_unique) kernel goes across as
    (n_unique, c_i, k, k); the mirrored filters come out in JAX's order and
    flip axes, so the outputs agree to 1e-12."""
    kw = {k: v for k, v in cfg.items() if k != "k"}
    jm = jl.SymmetricConv2d(kernel_size=cfg["k"], **kw)
    x = np.random.default_rng(1).normal(size=(2, 11, 14, 3))
    p = _init(jm, x)
    tkw = dict(kw)
    tkw.pop("features")
    tm = _load(tl.SymmetricConv2d(3, cfg["features"], cfg["k"],
                                  np.random.default_rng(0), **tkw), p)
    n_unique = jl.SymmetricConv2d.unique_out_channels(cfg["features"],
                                                      cfg["symmetry"] or {})
    assert tuple(tm.weight.shape) == (n_unique, 3, cfg["k"], cfg["k"])
    assert tm.kernel().shape[0] == cfg["features"]
    _close(_nhwc(tm(_nchw(x))), _apply(jm, p, x), 1e-12)


@pytest.mark.parametrize("symmetry", [
    {"h": 2, "v": 2, "z": 2}, {"hv": 4, "hz": 4}, {"vz": 4, "hvz": 8},
    {"h": 2, "hv": 4, "hvz": 8}])
def test_symmetric_conv3d_matches_flax(symmetry):
    jm = jl.SymmetricConv3d(features=16, kernel_size=3, symmetry=symmetry)
    x = np.random.default_rng(2).normal(size=(1, 5, 6, 7, 2))
    p = _init(jm, x)
    sd = from_jax_params(_np(p))
    tm = tl.SymmetricConv3d(2, 16, 3, np.random.default_rng(0),
                            symmetry).to(F64)
    tm.load_state_dict(sd, strict=True)
    got = tm(torch.as_tensor(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    _close(got, _apply(jm, p, x), 1e-12)


@pytest.mark.parametrize("H,W", [(16, 20), (6, 9), (5, 11)])
def test_spectral_conv2d_matches_flax(H, W):
    """rFFT2 → the 4 × 4 low modes mixed → irFFT2; at H < 8 the top and
    bottom rows' modes overlap and the bottom ones win, as in JAX."""
    jm = jl.SpectralConv2d(features=5)
    x = np.random.default_rng(3).normal(size=(2, H, W, 3))
    p = _init(jm, x)
    tm = _load(tl.SpectralConv2d(3, 5, np.random.default_rng(0)), p)
    _close(_nhwc(tm(_nchw(x))), _apply(jm, p, x), 1e-12)


LAYERS = [
    ("spectral", dict(features=8, act_fn="gelu")),
    ("fluid", dict(features=8, act_fn="gelu", r_p="zeros", use_symm=True,
                   kernel_size=5)),
    ("fluid", dict(features=8, act_fn="selu", r_p="replicate",
                   use_symm=True, dilation=2, kernel_size=3)),
    ("fluid", dict(features=4, act_fn="gelu", r_p="learned", use_symm=True,
                   kernel_size=5)),
    ("fluid", dict(features=8, act_fn="gelu", r_p="zeros", dilation=3,
                   kernel_size=3, drop_rate=0.3)),
]


@pytest.mark.parametrize("kind,cfg", LAYERS)
def test_fluid_layers_match_flax(kind, cfg):
    x = np.random.default_rng(4).normal(size=(2, 16, 20, 3))
    rng = np.random.default_rng(0)
    if kind == "spectral":
        jm = jl.SpectralFluidLayer(**cfg)
        tm = tl.SpectralFluidLayer(3, cfg["features"], rng, cfg["act_fn"])
    else:
        jm = jl.FluidLayer(**cfg)
        tkw = {k: v for k, v in cfg.items() if k != "features"}
        tm = tl.FluidLayer(3, cfg["features"], rng, **tkw)
    p = _init(jm, x)
    _load(tm, p)
    # eval: no generator, no dropout (JAX's deterministic=True)
    _close(_nhwc(tm(_nchw(x))), _apply(jm, p, x), 1e-12)


# ------------------------------------------------------------- models


def _cfg(**kw):
    base = dict(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu",
                loss_type="curl", repeats=1, f=5, p_pred=False)
    return {**base, **kw}


_CLASSES = {"newfluidnet": "NewFluidNet", "fluidnet": "FluidNet"}


def _fluid_input(H, W, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 0.5, size=(2, H, W, 7))
    x[..., 2] = rng.uniform(-1.0, 0.0, size=(2, H, W))   # log10(V)/8
    return x


VITS = [
    dict(image_size=(16, 24), patch_size=(8, 2), c_o=2, dim=32, depth=2,
         heads=4, mlp_dim=64, channels=7),
    dict(image_size=(8, 12), patch_size=(2, 2), c_o=3, dim=16, depth=1,
         heads=1, mlp_dim=32, channels=7, p_pred=True),
]


@pytest.mark.parametrize("cfg", VITS)
def test_vit_field_matches_flax(cfg):
    H, W = cfg["image_size"]
    x = np.random.default_rng(6).normal(size=(2, H, W, 7))
    jm = jvit.ViTField(**cfg)
    p = _init(jm, x)
    tm = tvit.ViTField(**cfg, device="cpu")
    assert set(tm.state_dict()) == set(from_jax_params(_np(p)))
    _load(tm, p)
    ref = _apply(jm, p, x)
    with torch.no_grad():
        out = tm(torch.as_tensor(x))
    assert (out[2] is None) == (ref[2] is None)
    for a, b in zip(out, ref):
        if b is not None:
            _close(a, b, 1e-9)


def test_vit_mean_pool_and_one_head_match_flax():
    """ViT alone: mean pooling, and one head as wide as ``dim`` (no output
    projection)."""
    kw = dict(image_size=(8, 8), patch_size=(4, 2), num_classes=5, dim=64,
              depth=2, heads=1, mlp_dim=32, channels=3, pool="mean")
    x = np.random.default_rng(7).normal(size=(3, 8, 8, 3))
    jm = jvit.ViT(**kw)
    p = _init(jm, x)
    tm = tvit.ViT(**{k: v for k, v in kw.items() if k != "pool"},
                  rng=np.random.default_rng(0), pool="mean")
    assert not tm.Transformer_0.attn_0.project_out
    _load(tm, p)
    with torch.no_grad():
        _close(tm(torch.as_tensor(x)), _apply(jm, p, x), 1e-9)


# ------------------------------------------------------------ dropout


def test_dropout_keeps_scales_and_repeats():
    """The keep fraction within 5 binomial sigmas, every kept value scaled
    by exactly 1/(1 − p), the rest 0; the same generator seed gives the
    same mask, another seed another; p = 0 and no generator give the eval
    output."""
    p, n = 0.3, 200_000
    x = torch.rand(n, dtype=F64) + 0.5
    y = tl.dropout(x, p, torch.Generator().manual_seed(3))
    kept = y != 0
    frac = float(kept.double().mean())
    assert abs(frac - (1 - p)) <= 5 * np.sqrt(p * (1 - p) / n)
    assert torch.equal(y[kept], x[kept] / (1 - p))
    assert torch.equal(y, tl.dropout(x, p, torch.Generator().manual_seed(3)))
    assert not torch.equal(y, tl.dropout(x, p,
                                         torch.Generator().manual_seed(4)))

    rng = np.random.default_rng(0)
    lay = tl.FluidLayer(3, 8, rng, "gelu", "zeros", 3, drop_rate=p).to(F64)
    lay0 = tl.FluidLayer(3, 8, rng, "gelu", "zeros", 3, drop_rate=0.0)
    lay0 = lay0.to(F64)
    lay0.load_state_dict(lay.state_dict())
    xi = torch.randn(2, 3, 9, 11, dtype=F64)
    with torch.no_grad():
        ev = lay(xi)
        assert torch.equal(lay0(xi, torch.Generator().manual_seed(1)), ev)
        tr = lay(xi, torch.Generator().manual_seed(1))
        assert torch.equal(tr, lay(xi, torch.Generator().manual_seed(1)))
        on = tr != 0
        assert torch.allclose(tr[on], ev[on] / (1 - p), rtol=0, atol=0)
    m = tfn.NewFluidNet(**_cfg(r_p="zeros", drop_rate=p), device="cpu",
                        dtype=F64)
    xm = torch.as_tensor(_fluid_input(16, 24))
    with torch.no_grad():
        a = m(xm, torch.Generator().manual_seed(9))[0]
        b = m(xm, torch.Generator().manual_seed(9))[0]
        c = m(xm, torch.Generator().manual_seed(10))[0]
        d = m(xm)[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, d)


# ------------------------------------------------------------ registry


@pytest.mark.parametrize("net,extra", [
    ("fluidnet", {}), ("ifluidnet", {}), ("halfnewfluidnet", {}),
    ("multiscalenewfluidnet", {"multi_scales": (1e-3, 1e1)}),
    ("vit", {"n_hidden": 16, "n_layers": 1, "n_head": 2}),
    ("newfluidnet", {"use_symm": True, "blurr": True, "drop_rate": 0.1}),
    ("newfluidnet", {"spectral_conv": True, "r_p": "zeros"}),
    ("unet", {"use_symm": True, "dilation": 2, "r_p": "replicate"})])
def test_registry_builds_every_network_as_jax(net, extra):
    """Parameter names and shapes of the module the JAX registry builds;
    the ViT's patch rule (8, or 2 where 8 does not divide)."""
    kw = dict(network=net, levels=2, c_h=8, repeats=1, H=16, W=20, **extra)
    jcfg, tcfg = jreg.ModelConfig(**kw), treg.ModelConfig(**kw)
    assert jcfg.channels == tcfg.channels
    x = jnp.zeros((1, 16, 20, jcfg.channels[0]))
    p = jax.eval_shape(jreg.build_model(jcfg).init, jax.random.PRNGKey(0), x)
    tm = treg.build_model(tcfg, device="cpu")
    want = {k: tuple(v.shape) for k, v in from_jax_params(
        jax.tree.map(lambda a: np.zeros(a.shape), p)).items()}
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == want
    if net == "vit":
        assert tm.vit.patch_size == (8, 2)


def test_fluidnet_six_levels_at_the_production_grid_refused_eagerly():
    """``fluidnet_base``'s levels at 128×506: the deepest branch is 4 rows,
    below the 6-row slab; JAX's forward fails (IndexError), the port
    raises a ValueError naming the sizes before any layer runs."""
    cfg = treg.ModelConfig(network="fluidnet", levels=6, c_h=4, repeats=1)
    jm = jreg.build_model(jreg.ModelConfig(network="fluidnet", levels=6,
                                           c_h=4, repeats=1))
    with pytest.raises(IndexError):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 128, 506, 7), jnp.float32))
    m = treg.build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="FluidNet: levels=6 .* 4x15"):
        m(torch.zeros(1, 128, 506, 7))


# ---------------------------------------------------------- converters


def _ref_fluid_layer(sd, src, dst, flax_sd):
    """The reference FluidLayer's names (layers.0 conv, layers.1 GN) for
    the port's ``dst`` entries of ``flax_sd``."""
    for k, v in flax_sd.items():
        if not k.startswith(dst + "."):
            continue
        rest = k[len(dst) + 1:]
        if rest.startswith("conv."):
            sd[f"{src}.layers.0.{rest[5:]}"] = v
        else:
            sd[f"{src}.layers.1.{rest[3:]}"] = v


def _reference_fluidnet_sd(port_sd, levels, repeats):
    """A reference-layout state_dict from the port's names: FluidLayers
    under ``conv.0`` / ``convs.{l}.{r}``, merges ``conv.1|2|3``, ``gn.0``;
    the BLC learnable bias as (1, C, 1, 1); spectral weights complex."""
    sd = {}
    _ref_fluid_layer(sd, "conv.0", "conv_0", port_sd)
    for l in range(levels):
        for r in range(repeats):
            _ref_fluid_layer(sd, f"convs.{l}.{r}", f"convs_{l}_{r}", port_sd)
    for i in (1, 2, 3):
        for k, v in port_sd.items():
            if k.startswith(f"conv_{i}."):
                sd[f"conv.{i}." + k[len(f"conv_{i}."):]] = v
    for k in ("weight", "bias"):
        sd[f"gn.0.{k}"] = port_sd[f"gn_0.{k}"]
    out = {}
    for k, v in sd.items():
        if k.endswith("learnable_bias"):
            v = v.reshape(1, -1, 1, 1)
        if k.endswith("_imag"):
            continue
        if k.endswith("_real"):
            k, v = k[:-5], torch.complex(v, sd[k[:-5] + "_imag"])
        out[k] = v.clone()
    return out


@pytest.mark.parametrize("net,cfg", [
    ("newfluidnet", _cfg(r_p="learned", use_symm=True)),
    ("newfluidnet", _cfg(r_p="zeros", use_symm=True)),
    ("newfluidnet", _cfg(r_p="zeros", spectral_conv=True)),
    ("fluidnet", _cfg(r_p="learned"))])
def test_reference_conversion_matches_jax_converter(net, cfg):
    """The port's ``convert_fluidnet`` on a reference state_dict equals
    ``from_jax_params`` of JAX's ``convert_fluidnet`` on it (symmetric
    convs' unique filters straight across, spectral weights split into
    real and imaginary parts), and loads strictly."""
    cls = getattr(tfn, _CLASSES[net])
    src = cls(**cfg, device="cpu", dtype=F64, seed=3)
    ref_sd = _reference_fluidnet_sd(src.state_dict(), cfg["levels"],
                                    cfg["repeats"])
    got = tconv.convert_fluidnet(ref_sd, cfg["levels"], cfg["repeats"])
    want = from_jax_params(jconv.convert_fluidnet(
        {k: v.numpy() for k, v in ref_sd.items()}, cfg["levels"],
        cfg["repeats"]))
    assert set(got) == set(want) == set(src.state_dict())
    for k in got:
        assert torch.equal(got[k], want[k]), k
    dst = cls(**cfg, device="cpu", dtype=F64)
    dst.load_state_dict(got, strict=True)
    x = torch.as_tensor(_fluid_input(16, 24))
    with torch.no_grad():
        for a, b in zip(dst(x), src(x)):
            if b is not None:
                assert torch.equal(a, b)


def test_reference_vit_conversion_matches_jax_converter(tmp_path):
    """A lucidrains ViT state_dict: the port's ``convert_vit`` (and
    ``load_reference_checkpoint(..., "vit", depth, ...)``) equals
    ``from_jax_params`` of JAX's ``convert_vit(sd, depth, ("vit",))`` and
    loads strictly into ViTField."""
    depth, dim, H, W = 2, 16, 8, 12
    field = tvit.ViTField((H, W), (2, 2), c_o=2, dim=dim, depth=depth,
                          heads=2, mlp_dim=32, channels=7, seed=4,
                          device="cpu", dtype=F64)
    names = {"LayerNorm_0": "to_patch_embedding.1",
             "Dense_0": "to_patch_embedding.2",
             "LayerNorm_1": "to_patch_embedding.3", "Dense_1": "mlp_head",
             "Transformer_0.LayerNorm_0": "transformer.norm"}
    for i in range(depth):
        a, f = f"transformer.layers.{i}.0", f"transformer.layers.{i}.1"
        names.update({
            f"Transformer_0.attn_{i}.LayerNorm_0": f"{a}.norm",
            f"Transformer_0.attn_{i}.Dense_0": f"{a}.to_qkv",
            f"Transformer_0.attn_{i}.Dense_1": f"{a}.to_out.0",
            f"Transformer_0.ff_{i}.LayerNorm_0": f"{f}.net.0",
            f"Transformer_0.ff_{i}.Dense_0": f"{f}.net.1",
            f"Transformer_0.ff_{i}.Dense_1": f"{f}.net.4"})
    ref_sd = {}
    for k, v in field.vit.state_dict().items():
        mod, _, leaf = k.rpartition(".")
        ref_sd[f"{names[mod]}.{leaf}" if mod else k] = v.clone()
    got = tconv.convert_vit(ref_sd, depth, prefix="vit.")
    want = from_jax_params(jconv.convert_vit(
        {k: v.numpy() for k, v in ref_sd.items()}, depth, ("vit",)))
    assert set(got) == set(want) == set(field.state_dict())
    for k in got:
        assert torch.equal(got[k], want[k]), k
    path = str(tmp_path / "vit.pt")
    torch.save(ref_sd, path)
    loaded = tconv.load_reference_checkpoint(path, "vit", depth, 1)
    dst = tvit.ViTField((H, W), (2, 2), c_o=2, dim=dim, depth=depth,
                        heads=2, mlp_dim=32, channels=7, device="cpu",
                        dtype=F64)
    dst.load_state_dict(loaded, strict=True)
    x = torch.randn(1, H, W, 7, dtype=F64)
    with torch.no_grad():
        assert torch.equal(dst(x)[0], field(x)[0])
