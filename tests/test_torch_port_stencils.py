"""The energy-step and stencil functions that have no caller on the
rollout path, against the JAX package in float64 on the CPU (≤1e-12):
``advect_diffuse_step_weno``, ``du_dy``, ``dv_dx``, ``laplace``,
``get_mass(bc=True)``, ``pad_grad``, ``pad_uvp`` and
``resize_bilinear_nhwc``, on the inputs of tests/test_stencils.py and
tests/test_resize.py and on seeded fields."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.ops import resize as jresize  # noqa: E402
from pbml_mantle_convection_tpu.ops import stencils as jst  # noqa: E402
from pbml_mantle_convection_tpu.physics import advection as jadv  # noqa: E402

from pbml_mantle_convection_tpu_torch.ops import resize as tresize  # noqa: E402
from pbml_mantle_convection_tpu_torch.ops import stencils as tst  # noqa: E402
from pbml_mantle_convection_tpu_torch.physics import advection as tadv  # noqa: E402

TOL = 1e-12


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _close(port, ref, tol=TOL):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=tol, atol=tol)


def _field():
    """tests/test_stencils.py's ``field``."""
    return np.random.default_rng(0).normal(size=(12, 17))


@pytest.mark.parametrize("name", ["du_dy", "dv_dx", "laplace"])
@pytest.mark.parametrize("shape", [(12, 17), (2, 3, 9, 11)])
def test_cross_and_laplace_stencils(name, shape):
    x = (_field() if shape == (12, 17)
         else np.random.default_rng(5).normal(size=shape))
    _close(getattr(tst, name)(_t(x)), getattr(jst, name)(jnp.asarray(x)))


@pytest.mark.parametrize("bc", [False, True])
@pytest.mark.parametrize("shape,seed", [((1, 16, 20), 1), ((14, 18), 2)])
def test_get_mass(bc, shape, seed):
    rng = np.random.default_rng(seed)
    u, v = rng.normal(size=shape), rng.normal(size=shape)
    _close(tst.get_mass(_t(u), _t(v), bc=bc),
           jst.get_mass(jnp.asarray(u), jnp.asarray(v), bc=bc))


@pytest.mark.parametrize("p", [(1, 1, 1, 1), (2, 0, 1, 3), (0, 3, 2, 0)])
def test_pad_grad(p):
    x = _field()[None, None]
    _close(tst.pad_grad(_t(x), p), jst.pad_grad(jnp.asarray(x), p))


@pytest.mark.parametrize("with_p", [False, True])
def test_pad_uvp(with_p):
    rng = np.random.default_rng(3)
    u, v, p = (rng.normal(size=(1, 10, 12)) for _ in range(3))
    got = tst.pad_uvp(_t(u), _t(v), _t(p) if with_p else None)
    ref = jst.pad_uvp(jnp.asarray(u), jnp.asarray(v),
                      jnp.asarray(p) if with_p else None)
    for a, b in zip(got[:2], ref[:2]):
        _close(a, b)
    if with_p:
        _close(got[2], ref[2])
    else:
        assert got[2] is None and ref[2] is None


@pytest.mark.parametrize("in_hw,out_hw,align", [
    ((32, 506), (128, 506), False),       # tests/test_resize.py
    ((9, 14), (20, 31), False), ((9, 14), (20, 31), True),
    ((20, 31), (9, 14), False)])
def test_resize_bilinear_nhwc(in_hw, out_hw, align):
    x = np.random.default_rng(1).normal(size=(2, *in_hw, 3))
    _close(tresize.resize_bilinear_nhwc(_t(x), out_hw, align_corners=align),
           jresize.resize_bilinear_nhwc(jnp.asarray(x), out_hw,
                                        align_corners=align))


def _weno_inputs(seed, B=2, H=14, W=19):
    rng = np.random.default_rng(seed)
    T = rng.uniform(0.0, 1.0, size=(B, H, W))
    u, v = (rng.normal(scale=50.0, size=(B, H, W)) for _ in range(2))
    return T, u, v


@pytest.mark.parametrize("src", ["scalar", "field"])
@pytest.mark.parametrize("given_dt", [False, True])
def test_advect_diffuse_step_weno(src, given_dt):
    T, u, v = _weno_inputs(6)
    raq = (3.0 if src == "scalar" else
           np.random.default_rng(7).uniform(0, 5, size=(2, 12, 17)))
    dt = 2.5e-6 if given_dt else None
    kw = dict(dx=1.0 / 30.0, cn_max=0.99)
    got_T, got_dt = tadv.advect_diffuse_step_weno(
        _t(u), _t(v), _t(T), raq if src == "scalar" else _t(raq),
        dt=None if dt is None else _t(dt), **kw)
    ref_T, ref_dt = jadv.advect_diffuse_step_weno(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(T),
        raq if src == "scalar" else jnp.asarray(raq),
        dt=None if dt is None else jnp.asarray(dt), **kw)
    _close(got_dt, ref_dt)
    _close(got_T, ref_T)
    assert bool((got_T[:, 0] == 1.0).all() and (got_T[:, -1] == 0.0).all())


def test_advect_diffuse_step_weno_at_rest_takes_the_diffusive_dt():
    """Zero velocity: the advective dt is infinite and the diffusive
    limit 0.25·dx² sets the step, as in JAX; the default dx is the
    reference's 1/126."""
    T, _, _ = _weno_inputs(8)
    z = np.zeros_like(T)
    got_T, got_dt = tadv.advect_diffuse_step_weno(_t(z), _t(z), _t(T), 1.0)
    ref_T, ref_dt = jadv.advect_diffuse_step_weno(
        jnp.asarray(z), jnp.asarray(z), jnp.asarray(T), 1.0)
    assert float(got_dt) == float(ref_dt) == pytest.approx(0.25 / 126 ** 2)
    _close(got_T, ref_T)
