"""The older FluidNet, the HalfNewFluidNet and the multi-scale ensemble of
the port against the JAX package's Flax modules in float64 on the CPU,
the Flax weights carried across by ``from_jax_params``: every output
≤1e-9 of its max.

1. FluidNet: learned and zero padding, curl (merge-1 grows the field to
   (H+2, W+2), the mean is taken there, the head crops it back) and mae,
   with ``blurr``, ``dilation`` and ``use_symm``;
2. HalfNewFluidNet: its raw, mean-subtracted (B, H, W, c_o) head;
3. MultiScaleNewFluidNet: members ``nets_{i}`` on their re-centred
   viscosity channel, the softmax gate, both heads.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.models import fluidnet as jfn  # noqa: E402

from pbml_mantle_convection_tpu_torch.models import fluidnet as tfn  # noqa: E402
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


def _cfg(**kw):
    base = dict(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu",
                loss_type="curl", repeats=1, f=5, p_pred=False)
    return {**base, **kw}


FLUIDNETS = [
    ("fluidnet", (16, 24), _cfg(r_p="learned")),
    ("fluidnet", (16, 24), _cfg(r_p="zeros", f=3, c_o=2, p_pred=True)),
    ("fluidnet", (16, 24), _cfg(r_p="replicate", loss_type="mae", c_o=2,
                                dilation=2, blurr=True)),
    ("fluidnet", (16, 24), _cfg(r_p="learned", use_symm=True, blurr=True)),
    ("halfnewfluidnet", (16, 24), _cfg(r_p="learned", use_symm=True)),
    ("halfnewfluidnet", (16, 24), _cfg(r_p="zeros", c_o=2)),
    ("multiscalenewfluidnet", (16, 24), _cfg(r_p="learned",
                                             scales=(1e-5, 1e1))),
    ("multiscalenewfluidnet", (16, 24),
     _cfg(r_p="zeros", loss_type="mae", c_o=3, p_pred=True, blurr=True)),
]
_CLASSES = {"newfluidnet": "NewFluidNet", "fluidnet": "FluidNet",
            "halfnewfluidnet": "HalfNewFluidNet",
            "multiscalenewfluidnet": "MultiScaleNewFluidNet"}


def _fluid_input(H, W, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 0.5, size=(2, H, W, 7))
    x[..., 2] = rng.uniform(-1.0, 0.0, size=(2, H, W))   # log10(V)/8
    return x


@pytest.mark.parametrize("net,shape,cfg", FLUIDNETS)
def test_fluidnet_family_matches_flax(net, shape, cfg):
    """Every output against the Flax module (≤1e-9 of its max): FluidNet's
    merge-1 grows the field under curl and its head crops it, the
    ensemble's members see their re-centred viscosity channel."""
    x = _fluid_input(*shape)
    jm = getattr(jfn, _CLASSES[net])(**cfg)
    p = _init(jm, x)
    tm = getattr(tfn, _CLASSES[net])(**cfg, device="cpu")
    assert set(tm.state_dict()) == set(from_jax_params(_np(p)))
    _load(tm, p)
    ref = _apply(jm, p, x)
    with torch.no_grad():
        out = tm(torch.as_tensor(x))
    if net == "halfnewfluidnet":
        _close(out, ref, 1e-9)
        return
    assert (out[2] is None) == (ref[2] is None)
    for a, b in zip(out, ref):
        if b is not None:
            _close(a, b, 1e-9)
