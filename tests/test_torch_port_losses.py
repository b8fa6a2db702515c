"""The port's training losses (train/losses.py) against the JAX package's,
in float64 on the CPU, on the same seeded fields: ≤ 1e-12."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.train import losses as jl  # noqa: E402
from pbml_mantle_convection_tpu_torch.train import losses as tl  # noqa: E402

TOL = dict(rtol=1e-12, atol=1e-12)
LOSS_TYPES = ("curl", "mass", "mae")


def _fields(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s) * 10 ** rng.uniform(-2, 1) for s in shapes]


def _close(t, j):
    if isinstance(t, tuple):
        for a, b in zip(t, j):
            _close(a, b)
        return
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _both(fn_t, fn_j, *arrays, **kw):
    return (fn_t(*[torch.as_tensor(a) for a in arrays], **kw),
            fn_j(*[jnp.asarray(a) for a in arrays], **kw))


def test_l1():
    _close(*_both(tl.l1, jl.l1, *_fields(0, (3, 10, 14), (3, 10, 14))))


@pytest.mark.parametrize("loss_scale", [True, False])
def test_scaled_boundary_l1(loss_scale):
    a, b = _fields(1, (3, 10, 14), (3, 10, 14))
    a[1] *= 0.01                  # a sample whose scaler clips at 10
    _close(*_both(tl.scaled_boundary_l1, jl.scaled_boundary_l1, a, b,
                  loss_scale=loss_scale))


def test_derivative_loss():
    _close(*_both(tl.derivative_loss, jl.derivative_loss,
                  *_fields(2, *[(2, 12, 16)] * 4)))


def test_mass_residual():
    _close(*_both(tl.mass_residual, jl.mass_residual,
                  *_fields(3, (2, 12, 16), (2, 12, 16))))


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_mass_penalty(loss_type):
    (m,) = _fields(4, (2, 10, 14))
    _close(*_both(tl.mass_penalty, jl.mass_penalty, np.abs(m),
                  loss_type=loss_type))


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
@pytest.mark.parametrize("p_pred,loss_scale,loss_derivative", [
    (False, True, True), (True, True, False), (False, False, False),
    (True, False, True)])
def test_fluidnet_loss(loss_type, p_pred, loss_scale, loss_derivative):
    u, v, p, y = _fields(5, (2, 12, 16), (2, 12, 16), (2, 12, 16),
                         (2, 3, 12, 16))
    kw = dict(p_pred=p_pred, loss_scale=loss_scale,
              loss_derivative=loss_derivative, loss_type=loss_type)
    t = tl.fluidnet_loss(*map(torch.as_tensor, (u, v, p, y)), **kw)
    j = jl.fluidnet_loss(*map(jnp.asarray, (u, v, p, y)), **kw)
    assert isinstance(t, tl.LossBreakdown) and len(t) == 6
    _close(tuple(t), tuple(j))
    np.testing.assert_allclose(t.stack().numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
@pytest.mark.parametrize("p_pred,loss_derivative", [
    (False, True), (True, False)])
def test_unet_loss(loss_type, p_pred, loss_derivative):
    c = 4 if p_pred else 3
    u, v, p, T, y = _fields(6, (2, 12, 16), (2, 12, 16), (2, 12, 16),
                            (2, 12, 16), (2, c, 12, 16))
    kw = dict(p_pred=p_pred, loss_scale=True,
              loss_derivative=loss_derivative, loss_type=loss_type)
    t = tl.unet_loss(*map(torch.as_tensor, (u, v, p, T, y)), **kw)
    j = jl.unet_loss(*map(jnp.asarray, (u, v, p, T, y)), **kw)
    _close(tuple(t), tuple(j))


def test_perfect_prediction_leaves_only_the_mass_term():
    (y,) = _fields(7, (2, 2, 10, 12))
    y = torch.as_tensor(y)
    br = tl.fluidnet_loss(y[:, 0], y[:, 1], None, y, loss_type="mae")
    assert float(br.u) == 0.0 and float(br.v) == 0.0
    assert float(br.total) == 0.0 and float(br.mass) > 0.0
