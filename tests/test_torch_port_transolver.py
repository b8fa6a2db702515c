"""The port's Transolver family against the JAX package, through the
Flax → torch weight bridge, in float64 on the CPU: ≤ 1e-9 (the forward
standard of PARITY.md), ≤ 1e-12 for the curl head. The Flax weights are
perturbed by seeded noise so that no bias, LayerNorm scale or
temperature keeps its trivial initial value; one temperature lies below
the structured variants' clamp."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.models import NewFluidNet as JNewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu.models import registry as jreg  # noqa: E402
from pbml_mantle_convection_tpu.models import transolver as jt  # noqa: E402
from pbml_mantle_convection_tpu.ops.curl import (  # noqa: E402
    curl_head_valid as j_curl_head_valid)

from pbml_mantle_convection_tpu_torch.models import registry as treg  # noqa: E402
from pbml_mantle_convection_tpu_torch.models import transolver as tt  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu_torch.ops.curl import curl_head_valid  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)

F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-9)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _init(jm, x, seed=0, temperature=None):
    """Flax params of ``jm`` at input ``x``, perturbed, as numpy; the
    ``temperature`` leaves set to the given per-head values."""
    p = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    rng = _rng(seed + 100)
    p = jax.tree.map(lambda a: np.asarray(a)
                     + 0.05 * rng.normal(size=np.shape(a)), p)
    if temperature is not None:
        def set_temp(path, a):
            if getattr(path[-1], "key", None) == "temperature":
                return np.asarray(temperature, a.dtype).reshape(a.shape)
            return a
        p = jax.tree_util.tree_map_with_path(set_temp, p)
    return p


def _port(tm, p):
    """Load Flax params into a port module (strict: every name maps)."""
    tm.to(F64).load_state_dict(from_jax_params(p))
    return tm


def _run(tm, x):
    with torch.no_grad():
        return tm(torch.as_tensor(x))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


def test_curl_head_valid():
    a = _rng(1).normal(size=(2, 9, 13))
    ju, jv = j_curl_head_valid(jnp.asarray(a))
    tu, tv = curl_head_valid(torch.as_tensor(a))
    assert tu.shape == (2, 7, 11)
    _close(tu, ju, rtol=1e-12, atol=1e-12)
    _close(tv, jv, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_layers,res", [(0, False), (2, True), (1, False)])
def test_transolver_mlp(n_layers, res):
    x = _rng(2).normal(size=(2, 7, 6))
    jm = jt.TransolverMLP(12, 5, n_layers=n_layers, res=res)
    p = _init(jm, x)
    tm = _port(tt.TransolverMLP(6, 12, 5, _rng(), n_layers=n_layers,
                                res=res), p)
    _close(_run(tm, x), jm.apply(p, jnp.asarray(x)))


def _attention(kind):
    """(JAX module, port module, input) at the sizes of
    tests/test_transolver.py."""
    rng = _rng()
    if kind == "irregular":
        return (jt.PhysicsAttentionIrregularMesh(dim=16, heads=2, dim_head=8,
                                                 slice_num=4),
                tt.PhysicsAttentionIrregularMesh(16, rng, heads=2,
                                                 dim_head=8, slice_num=4),
                _rng(3).normal(size=(2, 50, 16)))
    if kind == "structured2d":
        return (jt.PhysicsAttentionStructuredMesh2D(
                    dim=8, H=6, W=10, heads=2, dim_head=4, slice_num=4,
                    kernel=3),
                tt.PhysicsAttentionStructuredMesh2D(
                    8, 6, 10, rng, heads=2, dim_head=4, slice_num=4,
                    kernel=3),
                _rng(4).normal(size=(1, 60, 8)))
    return (jt.PhysicsAttentionStructuredMesh3D(
                dim=8, H=4, W=5, D=6, heads=2, dim_head=4, slice_num=4),
            tt.PhysicsAttentionStructuredMesh3D(
                8, 4, 5, 6, rng, heads=2, dim_head=4, slice_num=4),
            _rng(5).normal(size=(1, 120, 8)))


@pytest.mark.parametrize("kind", ["irregular", "structured2d",
                                  "structured3d"])
def test_physics_attention(kind):
    jm, tm, x = _attention(kind)
    p = _init(jm, x, temperature=[0.05, 0.7])
    tm = _port(tm, p)
    out = _run(tm, x)
    assert out.shape == x.shape
    _close(out, jm.apply(p, jnp.asarray(x)))


@pytest.mark.parametrize("grad", [False, True])
def test_structured_attention_at_the_projection_kernels_widths(grad):
    """At the widths where the card takes ``ops/projection_conv.py``'s
    kernel (128 channels, 8 heads, 3×3), the CPU runs the plain path, with
    and without autograd: the JAX model's output (≤ 1e-9) and the two
    ``F.conv2d`` of the projections to the bit."""
    jm = jt.PhysicsAttentionStructuredMesh2D(dim=128, H=6, W=10, heads=8,
                                             dim_head=16, slice_num=4,
                                             kernel=3)
    x = _rng(8).normal(size=(2, 60, 128))
    p = _init(jm, x, temperature=[0.05, 0.7, 1.0, 2.0, 0.3, 0.5, 6.0, 0.2])
    tm = _port(tt.PhysicsAttentionStructuredMesh2D(
        128, 6, 10, _rng(), heads=8, dim_head=16, slice_num=4, kernel=3), p)
    xt = torch.as_tensor(x)
    with torch.set_grad_enabled(grad):
        out = tm(xt)
        fx_mid, x_mid = tm.project(xt)
    _close(out.detach(), jm.apply(p, jnp.asarray(x)))
    img = xt.reshape(2, 6, 10, 128).permute(0, 3, 1, 2)
    for got, conv in ((fx_mid, tm.in_project_fx), (x_mid, tm.in_project_x)):
        want = tm.split_heads(torch.nn.functional.conv2d(
            img, conv.weight, conv.bias, padding="same"), 2, 60)
        assert torch.equal(got.detach(), want.detach())
    assert tm._packed is None


@pytest.mark.parametrize("kernel", [3, 5, 4])
def test_structured_projection_reads_heads_in_place(kernel):
    """The 2-D projection pads inside the conv (odd kernels) and keeps its
    weights channels-last: the same values as the ``Conv2dTorch`` module
    call (F.pad, then the conv), float64 ≤ 1e-12, and fx_mid, x_mid are
    views whose heads are rows of dim_head adjacent values (the layout
    the slice kernels read)."""
    attn = tt.PhysicsAttentionStructuredMesh2D(
        8, 6, 10, _rng(), heads=2, dim_head=4, slice_num=4,
        kernel=kernel).to(F64)
    x = torch.as_tensor(_rng(7).normal(size=(1, 60, 8)))
    img = x.reshape(1, 6, 10, 8).permute(0, 3, 1, 2)
    with torch.no_grad():
        for conv in (attn.in_project_fx, attn.in_project_x):
            assert conv.weight.is_contiguous(
                memory_format=torch.channels_last)
            np.testing.assert_allclose(attn._conv(img, conv).numpy(),
                                       conv(img).numpy(), rtol=1e-12,
                                       atol=1e-12)
        for y in attn.project(x):
            assert y.shape == (1, 2, 60, 4)
            assert y.stride(-1) == 1 and y.stride(2) == 8


@pytest.mark.parametrize("structured", [True, False])
@pytest.mark.parametrize("last_layer", [False, True])
def test_transolver_block(structured, last_layer):
    x = _rng(6).normal(size=(2, 60, 16))
    kw = dict(mlp_ratio=2, last_layer=last_layer, out_dim=3, slice_num=4,
              kernel=3, structured=structured)
    jm = jt.TransolverBlock(num_heads=2, hidden_dim=16, H=6, W=10, **kw)
    p = _init(jm, x)
    tm = _port(tt.TransolverBlock(2, 16, 6, 10, _rng(), **kw), p)
    out = _run(tm, x)
    assert out.shape == (2, 60, 3 if last_layer else 16)
    _close(out, jm.apply(p, jnp.asarray(x)))


@pytest.mark.parametrize("extra", [{}, {"unified_pos": True},
                                   {"p_pred": True, "out_dim": 2}])
def test_transolver_structured_2d(extra):
    H, W = 16, 24
    kw = dict(H=H, W=W, fun_dim=5, n_layers=2, n_hidden=16, n_head=2,
              slice_num=4, out_dim=1, p_pred=False)
    kw.update(extra)
    x = _rng(7).normal(size=(2, H * W, 7))
    jm = jt.TransolverStructured2D(**kw)
    p = _init(jm, x)
    tm = _port(tt.TransolverStructured2D(**kw, device="cpu", dtype=F64), p)
    tu, tv, tp = _run(tm, x)
    ju, jv, jp = jm.apply(p, jnp.asarray(x))
    assert tu.shape == (2, H - 2, W - 2)
    _close(tu, ju)
    _close(tv, jv)
    if kw["p_pred"]:
        _close(tp, jp)
    else:
        assert tp is None and jp is None


@pytest.mark.parametrize("space_dim,fun_dim", [(2, 5), (3, 0)])
def test_transolver_irregular(space_dim, fun_dim):
    kw = dict(space_dim=space_dim, fun_dim=fun_dim, n_layers=2, n_hidden=16,
              n_head=2, slice_num=4, out_dim=2)
    x = _rng(8).normal(size=(2, 90, space_dim + fun_dim))
    jm = jt.TransolverIrregular(**kw)
    p = _init(jm, x)
    tm = _port(tt.TransolverIrregular(**kw, device="cpu", dtype=F64), p)
    out = _run(tm, x)
    assert out.shape == (2, 90, 2)
    _close(out, jm.apply(p, jnp.asarray(x)))


def test_newfluidnet_still_bridges():
    cfg = dict(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu", r_p="learned",
               loss_type="curl", repeats=1, f=5, p_pred=False)
    x = _rng(9).normal(size=(1, 20, 28, 7))
    jm = JNewFluidNet(**cfg)
    p = _init(jm, x)
    tm = _port(NewFluidNet(**cfg, device="cpu", dtype=F64), p)
    tu, tv, _ = _run(tm, x)
    ju, jv, _ = jm.apply(p, jnp.asarray(x))
    _close(tu, ju)
    _close(tv, jv)


def test_unified_pos_features():
    ref = np.asarray(jt.unified_pos_features(5, 7, 3, 4, jnp.float64))
    out = tt.unified_pos_features(5, 7, 3, 4, dtype=F64)
    _close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("net", ["transolver_structured", "transolver",
                                 "newfluidnet"])
def test_registry_builds_the_jax_models(net):
    """The port's build_model gives the JAX model's parameters, name for
    name and shape for shape."""
    kw = dict(network=net, levels=2, c_h=8, repeats=1, kernel=5, H=16, W=24,
              n_hidden=16, n_head=2, n_layers=2, slice_num=4)
    jcfg, tcfg = jreg.ModelConfig(**kw), treg.ModelConfig(**kw)
    assert jcfg.channels == tcfg.channels
    c_i, _ = jcfg.channels
    x = np.zeros((1, 16 * 24, c_i) if "transolver" in net
                 else (1, 16, 24, c_i))
    p = jreg.build_model(jcfg).init(jax.random.PRNGKey(0), jnp.asarray(x))
    sd = from_jax_params(jax.tree.map(np.asarray, p))
    tm = treg.build_model(tcfg, device="cpu")
    ref = tm.state_dict()
    assert set(sd) == set(ref)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(ref[k].shape), k


@pytest.mark.parametrize("net", ["fluidnet", "ifluidnet", "halfnewfluidnet",
                                 "vit", "multiscalenewfluidnet"])
def test_registry_builds_the_other_networks_as_jax(net):
    """The networks of the JAX registry beside the Transolvers build, with
    the parameter names and shapes of the Flax module JAX's registry
    builds (at ModelConfig's defaults but for width and depth); so does
    NewFluidNet with ``use_symm``; an unknown network raises."""
    kw = dict(network=net, levels=2, c_h=8, repeats=1, n_hidden=16,
              n_layers=1, n_head=2, H=16, W=24)
    cfg = treg.ModelConfig(**kw)
    assert cfg.channels == jreg.ModelConfig(**kw).channels
    for kw in (kw, dict(kw, network="newfluidnet", use_symm=True)):
        jcfg, tcfg = jreg.ModelConfig(**kw), treg.ModelConfig(**kw)
        x = jnp.zeros((1, 16, 24, jcfg.channels[0]))
        p = jax.eval_shape(jreg.build_model(jcfg).init,
                           jax.random.PRNGKey(0), x)
        want = {k: tuple(v.shape) for k, v in from_jax_params(
            jax.tree.map(lambda a: np.zeros(a.shape), p)).items()}
        got = treg.build_model(tcfg, device="cpu").state_dict()
        assert {k: tuple(v.shape) for k, v in got.items()} == want
    with pytest.raises(ValueError, match="unknown network"):
        treg.build_model(treg.ModelConfig(network="resnet"), device="cpu")


def test_seeded_init_and_bridge_leaf_layouts():
    kw = dict(H=6, W=10, n_layers=1, n_hidden=8, n_head=2, slice_num=4,
              device="cpu")
    a, b = tt.TransolverStructured2D(**kw), tt.TransolverStructured2D(**kw)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    w = a.preprocess.linear_pre.weight.detach()
    assert float(w.abs().max()) <= 0.04 and float(w.std()) > 0.005
    k = np.arange(2 * 3 * 3 * 3 * 5, dtype=np.float64).reshape(2, 3, 3, 3, 5)
    sd = from_jax_params({"m": {"in_project_x_kernel": k,
                                "kernel": np.ones((3, 4))}})
    assert sd["m.in_project_x_kernel"].shape == (5, 3, 2, 3, 3)
    assert float(sd["m.in_project_x_kernel"][4, 2, 1, 0, 2]) == k[1, 0, 2, 2, 4]
    assert sd["m.weight"].shape == (4, 3)
    with pytest.raises(ValueError, match="3-D 'kernel'"):
        from_jax_params({"kernel": np.ones((2, 2, 2))})
