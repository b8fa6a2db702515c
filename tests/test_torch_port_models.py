"""PyTorch port vs the JAX package: layers and NewFluidNet through the
Flax → torch weight bridge, in float64 on the CPU (≤1e-9, the forward
standard of PARITY.md)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.models import NewFluidNet as JNewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu.models import layers as jl  # noqa: E402

from pbml_mantle_convection_tpu_torch.models import layers as tl  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)

F64 = torch.float64


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _nchw(x):
    return torch.as_tensor(np.asarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _port_module(mod, params):
    """Load a Flax module's params into a port module (state_dict names
    are the Flax paths joined by dots)."""
    mod.to(F64).load_state_dict(from_jax_params(_np_tree(params)))
    return mod


@pytest.mark.parametrize("cio", [(7, 16), (16, 16), (87, 16), (16, 1)])
def test_blc_conv(cio):
    c_i, c_o = cio
    x = np.random.default_rng(0).normal(size=(1, 14, 19, c_i))
    jm = jl.BoundaryLearnedConvolution2D(c_o, 5)
    p = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    # a non-zero learnable bias so the bridge's reshape is exercised
    p = jax.tree.map(lambda a: a + 0.1 if a.ndim == 4 and a.shape[:3]
                     == (1, 1, 1) else a, p)
    ref = jm.apply(p, jnp.asarray(x))
    tm = _port_module(tl.BoundaryLearnedConvolution2D(
        c_i, c_o, 5, np.random.default_rng(0)), p)
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), np.asarray(ref),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("r_p", ["learned", "zeros", "replicate"])
def test_fluid_layer(r_p):
    x = np.random.default_rng(1).normal(size=(1, 12, 17, 7))
    jm = jl.FluidLayer(16, act_fn="gelu", r_p=r_p, kernel_size=5)
    p = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    p = jax.tree.map(lambda a: a * 1.3 + 0.05, p)   # non-trivial GN affine
    ref = jm.apply(p, jnp.asarray(x))
    tm = _port_module(tl.FluidLayer(7, 16, np.random.default_rng(0),
                                    act_fn="gelu", r_p=r_p, kernel_size=5), p)
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), np.asarray(ref),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["gelu", "selu", "tanh", "relu", "silu",
                                  "elu"])
def test_activations(name):
    x = np.linspace(-6, 6, 1001)
    np.testing.assert_allclose(
        tl.get_activation(name)(torch.as_tensor(x)).numpy(),
        np.asarray(jl.get_activation(name)(jnp.asarray(x))),
        rtol=1e-12, atol=1e-14)


def _models(H, W, **kw):
    cfg = dict(c_i=7, c_o=1, act_fn="gelu", r_p="learned", loss_type="curl",
               f=5, p_pred=False)
    cfg.update(kw)
    jm = JNewFluidNet(**cfg)
    tm = NewFluidNet(**cfg, device="cpu", dtype=F64)
    return jm, tm


@pytest.mark.parametrize("shape,cfg", [
    ((20, 28), dict(levels=2, c_h=8, repeats=1)),
    ((16, 30), dict(levels=2, c_h=8, repeats=2)),
    ((24, 32), dict(levels=2, c_h=8, repeats=1, r_p="zeros",
                    loss_type="mae", c_o=3, p_pred=True)),
])
def test_newfluidnet_bridge_small(shape, cfg):
    H, W = shape
    jm, tm = _models(H, W, **cfg)
    x = np.random.default_rng(3).normal(size=(2, H, W, 7))
    p = jm.init(jax.random.PRNGKey(42), jnp.asarray(x))
    tm.load_state_dict(from_jax_params(_np_tree(p)))
    ju, jv, jp = jm.apply(p, jnp.asarray(x))
    with torch.no_grad():
        tu, tv, tp = tm(torch.as_tensor(x))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-9,
                               atol=1e-9)
    if cfg.get("p_pred"):
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-9,
                                   atol=1e-9)


def test_newfluidnet_bridge_flagship():
    """The flagship config at the reference's 128×506 grid, float64."""
    H, W = 128, 506
    jm, tm = _models(H, W, levels=5, c_h=16, repeats=6)
    x = np.random.default_rng(4).normal(size=(1, H, W, 7))
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 7)))
    n_params = sum(a.size for a in jax.tree.leaves(p))
    assert n_params == sum(t.numel() for t in tm.parameters())
    assert 2.0e6 < n_params < 2.3e6
    tm.load_state_dict(from_jax_params(_np_tree(p)))
    ju, jv, _ = jax.jit(jm.apply)(p, jnp.asarray(x))
    with torch.no_grad():
        tu, tv, _ = tm(torch.as_tensor(x))
    scale = float(np.abs(np.asarray(ju)).max())
    assert float(np.abs(tu.numpy() - np.asarray(ju)).max()) <= 1e-9 * scale
    assert float(np.abs(tv.numpy() - np.asarray(jv)).max()) <= 1e-9 * scale


def test_bridge_names_match_exactly():
    jm, tm = _models(20, 28, levels=2, c_h=8, repeats=2)
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 20, 28, 7)))
    sd = from_jax_params(_np_tree(p))
    assert set(sd) == set(tm.state_dict())
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(tm.state_dict()[k].shape), k


def test_min_size_check_and_seeded_init():
    tm = NewFluidNet(levels=5, c_i=7, c_h=8, c_o=1, r_p="learned",
                     loss_type="curl", f=5, p_pred=False, device="cpu")
    with pytest.raises(ValueError, match="below the 6x6 minimum"):
        tm(torch.zeros((1, 64, 64, 7)))
    tm2 = NewFluidNet(levels=5, c_i=7, c_h=8, c_o=1, r_p="learned",
                      loss_type="curl", f=5, p_pred=False, device="cpu")
    for a, b in zip(tm.parameters(), tm2.parameters()):
        assert torch.equal(a, b)
