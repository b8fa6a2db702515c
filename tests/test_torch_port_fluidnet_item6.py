"""NewFluidNet of the port with each option of this slice against the JAX
package's Flax module in float64 on the CPU, the Flax weights carried
across by ``from_jax_params``: every output ≤1e-9 of its max. The
options: ``use_symm`` (learned and zero padding), ``spectral_conv``,
``blurr``, ``dilation`` 2 (which reaches the plain merge-1 only),
``drop_rate`` in eval, the mae head. (The FluidNet, HalfNewFluidNet and
the ensemble: tests/test_torch_port_fluidnet_family_item6.py; the U-Net
family's options: tests/test_torch_port_unet_item6.py.)
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
    ("newfluidnet", (16, 24), _cfg(r_p="learned", use_symm=True)),
    ("newfluidnet", (16, 24), _cfg(r_p="zeros", use_symm=True)),
    ("newfluidnet", (16, 24), _cfg(r_p="zeros", spectral_conv=True,
                                   levels=3, repeats=2)),
    ("newfluidnet", (16, 24), _cfg(r_p="learned", blurr=True)),
    ("newfluidnet", (16, 24), _cfg(r_p="zeros", f=3, dilation=2,
                                   act_fn="selu")),
    ("newfluidnet", (16, 24), _cfg(r_p="learned", drop_rate=0.2)),
    ("newfluidnet", (16, 24), _cfg(r_p="replicate", use_symm=True,
                                   loss_type="mae", c_o=3, p_pred=True,
                                   c_h=4)),
]
_CLASSES = {"newfluidnet": "NewFluidNet"}


def _fluid_input(H, W, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 0.5, size=(2, H, W, 7))
    x[..., 2] = rng.uniform(-1.0, 0.0, size=(2, H, W))   # log10(V)/8
    return x


@pytest.mark.parametrize("net,shape,cfg", FLUIDNETS)
def test_fluidnet_family_matches_flax(net, shape, cfg):
    """Every output against the Flax module (≤1e-9 of its max): the
    options reach the layers as in JAX."""
    x = _fluid_input(*shape)
    jm = getattr(jfn, _CLASSES[net])(**cfg)
    p = _init(jm, x)
    tm = getattr(tfn, _CLASSES[net])(**cfg, device="cpu")
    assert set(tm.state_dict()) == set(from_jax_params(_np(p)))
    _load(tm, p)
    ref = _apply(jm, p, x)
    with torch.no_grad():
        out = tm(torch.as_tensor(x))
    assert (out[2] is None) == (ref[2] is None)
    for a, b in zip(out, ref):
        if b is not None:
            _close(a, b, 1e-9)


def test_dilation_reaches_the_plain_merge_1_only():
    """JAX's asymmetry kept: with zero padding and dilation 2 the plain
    merge-1 (3×3, padded by 1) shrinks the field by 2 each way, merges 2
    and 3 keep their dilation 1."""
    m = tfn.NewFluidNet(**_cfg(r_p="zeros", f=3, dilation=2), device="cpu")
    assert m.conv_1.dilation == 2 and m.conv_1.pad == (1, 1, 1, 1)
    assert m.conv_2.dilation == m.conv_3.dilation == 1
    assert m.conv_0.conv.dilation == 2 and m.conv_0.conv.pad == (2,) * 4
    with torch.no_grad():
        u, _, _ = m(torch.zeros(1, 16, 24, 7))
    assert u.shape == (1, 14, 22)
