"""The U-Net and the ConvAE of the port with the layer options of this
slice (``use_symm``, ``dilation``, ``spectral_conv`` and, for the U-Net,
``drop_rate`` in eval) against the JAX package's Flax modules in float64
on the CPU, the Flax weights carried across by ``from_jax_params``:
every output ≤1e-9 of its max.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.models import unet as jun  # noqa: E402

from pbml_mantle_convection_tpu_torch.models import unet as tun  # noqa: E402
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


UNET_OPTIONS = [
    ("unet", dict(levels=2, c_i=10, c_h=8, c_o=2, r_p="replicate",
                  use_symm=True, dilation=2)),
    ("unet", dict(levels=2, c_i=10, c_h=8, c_o=2, r_p="zeros",
                  spectral_conv=True)),
    ("unet", dict(levels=2, c_i=10, c_h=8, c_o=4, r_p="learned",
                  use_symm=True, drop_rate=0.1)),
    ("convae", dict(levels=1, c_i=3, c_h=16, c_o=2, loss_type="curl",
                    p_pred=False, use_symm=True, dilation=2)),
    ("convae", dict(levels=1, c_i=3, c_h=4, c_o=3, loss_type="curl",
                    p_pred=True, spectral_conv=True)),
]


@pytest.mark.parametrize("net,cfg", UNET_OPTIONS)
def test_unet_family_options_match_flax(net, cfg):
    """The U-Net and the ConvAE take use_symm, dilation, spectral_conv
    and (the U-Net) drop_rate through the layers, as JAX's do."""
    H, W = (32, 40)
    x = np.random.default_rng(8).normal(size=(2, H, W, cfg["c_i"]))
    jm = (jun.Unet if net == "unet" else jun.ConvAE)(**cfg)
    p = _init(jm, x)
    tm = (tun.Unet if net == "unet" else tun.ConvAE)(**cfg, device="cpu")
    _load(tm, p)
    ref = _apply(jm, p, x)
    with torch.no_grad():
        out = tm(torch.as_tensor(x))
    if net == "convae":
        _close(out, ref, 1e-9)
        return
    for a, b in zip(out, ref):
        if b is not None:
            _close(a, b, 1e-9)
