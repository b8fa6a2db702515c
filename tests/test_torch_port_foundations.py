"""PyTorch port vs the JAX package: constants, grid, viscosity, stencils,
curl head, resampling and the energy step, in float64 on the CPU.

Inputs come from a numpy seed and go through both packages; the port is
held to ≤1e-12 (rtol 1e-12 for the energy step).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu import constants as jc  # noqa: E402
from pbml_mantle_convection_tpu.ops import curl as jcurl  # noqa: E402
from pbml_mantle_convection_tpu.ops import resize as jresize  # noqa: E402
from pbml_mantle_convection_tpu.ops import stencils as jst  # noqa: E402
from pbml_mantle_convection_tpu.physics import advection as jadv  # noqa: E402
from pbml_mantle_convection_tpu.physics import viscosity as jvisc  # noqa: E402
from pbml_mantle_convection_tpu.sim.grid import Grid as JGrid  # noqa: E402

from pbml_mantle_convection_tpu_torch import constants as tc  # noqa: E402
from pbml_mantle_convection_tpu_torch.ops import curl as tcurl  # noqa: E402
from pbml_mantle_convection_tpu_torch.ops import resize as tresize  # noqa: E402
from pbml_mantle_convection_tpu_torch.ops import stencils as tst  # noqa: E402
from pbml_mantle_convection_tpu_torch.physics import advection as tadv  # noqa: E402
from pbml_mantle_convection_tpu_torch.physics import viscosity as tvisc  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.grid import Grid as TGrid  # noqa: E402

TOL = 1e-12


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("p", [(3.0, 1e8, 10.0), (0.5, 2e6, 1.3),
                               (9.0, 7e9, 95.0)])
def test_constants_and_params(p):
    jp, tp = jc.SimParams(*p), tc.SimParams(*p)
    for name in ("raq_nd", "fkt_nd", "fkp_nd", "scaler"):
        assert getattr(tp, name) == getattr(jp, name)
    assert tc.COORD_SCALE == jc.COORD_SCALE
    V = np.random.default_rng(0).uniform(1e-10, 2.0, size=(7, 9))
    _close(tc.visc_feature(_t(V)), jc.visc_feature(jnp.asarray(V)))
    _close(tc.velocity_scaler(*p), jc.velocity_scaler(*p))
    raq = np.linspace(0.2, 9.5, 7)
    _close(tc.velocity_scaler(raq, p[1], p[2]),
           jc.velocity_scaler(raq, p[1], p[2]))
    _close(tc.nondim_raq(raq), jc.nondim_raq(raq))
    fk = np.logspace(0.1, 9.8, 7)
    _close(tc.nondim_fkt(fk), jc.nondim_fkt(fk))
    _close(tc.nondim_fkp(fk), jc.nondim_fkp(fk))


@pytest.mark.parametrize("hwa", [(128, 506, 4.0), (256, 256, 1.0),
                                 (20, 28, 4.0)])
def test_grid(hwa):
    H, W, a = hwa
    jg, tg = JGrid(H=H, W=W, aspect=a), TGrid(H=H, W=W, aspect=a)
    np.testing.assert_array_equal(tg.xc, jg.xc_np)
    np.testing.assert_array_equal(tg.yc, jg.yc_np)
    assert tg.dy == jg.dy
    xc, yc = tg.coords("cpu", torch.float64)
    np.testing.assert_array_equal(xc.numpy(), jg.xc_np)
    np.testing.assert_array_equal(yc.numpy(), jg.yc_np)


def test_viscosity():
    rng = np.random.default_rng(1)
    z = rng.uniform(0, 1, (16, 24))
    T = rng.uniform(-0.1, 1.2, (2, 16, 24))
    for fkt, fkp in ((1e8, 10.0), (1e6, 2.5)):
        _close(tvisc.fk_viscosity(fkt, fkp, _t(z), _t(T)),
               jvisc.fk_viscosity(fkt, fkp, jnp.asarray(z), jnp.asarray(T)))
        _close(tvisc.fk_viscosity_clipped(fkt, fkp, _t(z), _t(T)),
               jvisc.fk_viscosity_clipped(fkt, fkp, jnp.asarray(z),
                                          jnp.asarray(T)))


@pytest.mark.parametrize("name", ["dx_left", "dx_right", "dx_center",
                                  "dy_top", "dy_bot", "dy_center"])
def test_stencils(name):
    x = np.random.default_rng(2).normal(size=(2, 13, 17))
    _close(getattr(tst, name)(_t(x)), getattr(jst, name)(jnp.asarray(x)))


def test_mass_pad_and_bcs():
    rng = np.random.default_rng(3)
    u, v = rng.normal(size=(2, 13, 17)), rng.normal(size=(2, 13, 17))
    _close(tst.get_mass(_t(u), _t(v)),
           jst.get_mass(jnp.asarray(u), jnp.asarray(v)))
    for pad in ((1, 1, 1, 1), (2, 0, 1, 3)):
        _close(tst.replicate_pad(_t(u), pad),
               jst.replicate_pad(jnp.asarray(u), pad))
    _close(tst.stamp_temperature_bc(_t(u)),
           jst.stamp_temperature_bc(jnp.asarray(u)))


def test_curl_head():
    a = np.random.default_rng(4).normal(size=(2, 20, 28))
    tu, tv = tcurl.curl_head_padded(_t(a))
    ju, jv = jcurl.curl_head_padded(jnp.asarray(a))
    _close(tu, ju)
    _close(tv, jv)
    # divergence-free interior, the property the head guarantees
    assert float(tst.get_mass(tu, tv)[..., 1:-1, 1:-1].abs().max()) < 1e-12


@pytest.mark.parametrize("io", [(8, 128), (31, 506), (63, 506), (126, 506),
                                (253, 506), (16, 256), (5, 7)])
def test_resize_matrix_and_bicubic(io):
    i, o = io
    np.testing.assert_array_equal(tresize._resize_matrix_np(i, o),
                                  jresize._resize_matrix_np(i, o))
    x = np.random.default_rng(5).normal(size=(1, i, 9, 3))
    _close(tresize.resize_bicubic_nhwc(_t(x), (o, 12)),
           jresize.resize_bicubic_nhwc(jnp.asarray(x), (o, 12)))


def test_bicubic_matches_torch_interpolate():
    """The resize matrices are torch's own bicubic (a=-0.75, half-pixel,
    clamped borders): F.interpolate is the yardstick the card times."""
    x = torch.as_tensor(np.random.default_rng(6).normal(size=(3, 8, 31)))
    ref = torch.nn.functional.interpolate(
        x[None], size=(128, 506), mode="bicubic", align_corners=False)[0]
    _close(tresize.resize_bicubic_nchw(x, (128, 506)), ref, tol=1e-10)


@pytest.mark.parametrize("hw", [(128, 506), (63, 253), (8, 31), (7, 9)])
def test_avg_pool_valid_floor(hw):
    x = np.random.default_rng(7).normal(size=(1,) + hw + (4,))
    _close(tresize.avg_pool_nhwc(_t(x), 2),
           jresize.avg_pool_nhwc(jnp.asarray(x), 2))


@pytest.mark.parametrize("hwa", [(20, 28, 4.0), (32, 32, 1.0)])
def test_advect_diffuse_step(hwa):
    H, W, a = hwa
    jg = JGrid(H=H, W=W, aspect=a)
    rng = np.random.default_rng(8)
    u, v = rng.normal(size=(2, 1, H, W)) * 50.0
    T = rng.uniform(0, 1, (1, H, W))
    jm = jadv.grid_metrics(jnp.asarray(jg.xc_np), jnp.asarray(jg.yc_np),
                           aspect=a)
    tm = tadv.grid_metrics(_t(jg.xc_np), _t(jg.yc_np), aspect=a)
    for f in tm._fields:
        _close(getattr(tm, f), getattr(jm, f))
    for dt in (None, 1e-5):
        jT, jdt = jadv.advect_diffuse_step(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(T), 3.0, jm,
            dt=dt, cn_max=0.99)
        tT, tdt = tadv.advect_diffuse_step(
            _t(u), _t(v), _t(T), 3.0, tm,
            dt=None if dt is None else torch.tensor(dt, dtype=torch.float64),
            cn_max=0.99)
        np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(float(tdt), float(jdt), rtol=1e-12)
    ju = jnp.asarray(u[..., 1:-1, 1:-1])
    _close(tadv.stability_dt(_t(u[..., 1:-1, 1:-1]), _t(v[..., 1:-1, 1:-1]),
                             tm.dx_min, 0.5),
           jadv.stability_dt(ju, jnp.asarray(v[..., 1:-1, 1:-1]),
                             jm.dx_min, 0.5))
