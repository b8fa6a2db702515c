"""The port's energy step against the JAX package's: the plain version of
``ops/advect_kernel.py`` against the Pallas ``advect_diffuse_step_pallas``
in interpret mode (as tests/test_pallas_kernels.py runs it) and against
the XLA ``advect_diffuse_step`` for field sources; ``viscous_dissipation``
and the core-cooling BC stamp. Inputs come from numpy seeds; the CUDA
kernel itself is held against the plain version on the card by
tests/test_torch_port_cuda.py."""

import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.ops import stencils as jst  # noqa: E402
from pbml_mantle_convection_tpu.ops.pallas_kernels import (  # noqa: E402
    advect_diffuse_step_pallas)
from pbml_mantle_convection_tpu.physics import advection as jadv  # noqa: E402
from pbml_mantle_convection_tpu.sim.grid import Grid as JGrid  # noqa: E402

from pbml_mantle_convection_tpu_torch.ops import _cuda  # noqa: E402
from pbml_mantle_convection_tpu_torch.ops import stencils as tst  # noqa: E402
from pbml_mantle_convection_tpu_torch.ops.advect_kernel import (  # noqa: E402
    advect_diffuse_step_fused, advect_diffuse_step_plain)
from pbml_mantle_convection_tpu_torch.physics.advection import (  # noqa: E402
    grid_metrics, viscous_dissipation)
from pbml_mantle_convection_tpu_torch.sim.grid import Grid  # noqa: E402

F64 = torch.float64


def _metrics(H, W):
    g = Grid(H=H, W=W)
    jg = JGrid(H=H, W=W)
    return (grid_metrics(*g.coords("cpu", F64), aspect=g.aspect),
            jadv.grid_metrics(jg.xc, jg.yc))


def _fields(seed, B, H, W, scale, t_scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, W)) * scale,
            rng.normal(size=(B, H, W)) * scale,
            rng.uniform(size=(B, H, W)) * t_scale)


def test_plain_energy_step_matches_pallas_kernel():
    """tests/test_pallas_kernels.py::test_pallas_advect_matches_xla:
    float64, B=2, 24×40, dt rtol 1e-14, T rtol 1e-12."""
    tm, jm = _metrics(24, 40)
    u, v, T = _fields(0, 2, 24, 40, 50.0)
    T_pal, dt_pal = advect_diffuse_step_pallas(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(T), 2.5, jm, cn_max=0.5)
    n0 = advect_diffuse_step_fused.launches
    T_t, dt_t = advect_diffuse_step_fused(
        torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(T), 2.5, tm,
        cn_max=0.5)
    assert advect_diffuse_step_fused.launches == n0   # CPU: plain version
    np.testing.assert_allclose(float(dt_t), float(dt_pal), rtol=1e-14)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_pal), rtol=1e-12,
                               atol=1e-13)


@pytest.mark.parametrize("core_cool,clip_T,B,H,W", [
    (True, True, 1, 16, 24),
    (False, True, 2, 16, 24),
    (True, False, 2, 18, 26)])
def test_plain_core_cool_and_clip_match_pallas_kernel(core_cool, clip_T, B,
                                                      H, W):
    """tests/test_pallas_kernels.py::test_pallas_advect_core_cool_and_clip
    (T up to 3 so the clip acts): the whole field at rtol 1e-12, and the
    kernel's BC order — interior clipped before the BCs, row 0 a copy of
    row 1 under core cooling."""
    tm, jm = _metrics(H, W)
    u, v, T = _fields(1, B, H, W, 10.0, t_scale=3.0)
    T_pal, dt_pal = advect_diffuse_step_pallas(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(T), 1.0, jm,
        core_cool=core_cool, clip_T=clip_T)
    T_t, dt_t = advect_diffuse_step_plain(
        torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(T), 1.0, tm,
        core_cool=core_cool, clip_T=clip_T)
    np.testing.assert_allclose(float(dt_t), float(dt_pal), rtol=1e-14)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_pal), rtol=1e-12,
                               atol=1e-13)
    T_t = T_t.numpy()
    if clip_T:
        assert T_t.max() <= 2.0 and T_t.min() >= 0.0
    if core_cool:
        np.testing.assert_array_equal(T_t[:, 0], T_t[:, 1])
    else:
        assert np.all(T_t[:, 0] == 1.0)
    assert np.all(T_t[:, -1] == 0.0)


@pytest.mark.parametrize("core_cool", [False, True])
def test_field_source_matches_xla_step(core_cool):
    """A (B, H-2, W-2) source (the EBA terms) vs the XLA
    advect_diffuse_step, where the Pallas wrapper sends it; float64,
    rtol 1e-12, with the adaptive and with a given dt."""
    B, H, W = 2, 20, 30
    tm, jm = _metrics(H, W)
    u, v, T = _fields(2, B, H, W, 20.0)
    src = np.random.default_rng(3).normal(size=(B, H - 2, W - 2)) + 2.0
    for dt in (None, 1.3e-5):
        jT, jdt = jadv.advect_diffuse_step(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(T), jnp.asarray(src),
            jm, dt=None if dt is None else jnp.asarray(dt), cn_max=0.99,
            core_cool=core_cool)
        tT, tdt = advect_diffuse_step_fused(
            torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(T),
            torch.as_tensor(src), tm,
            dt=None if dt is None else torch.tensor(dt, dtype=F64),
            cn_max=0.99, core_cool=core_cool)
        np.testing.assert_allclose(float(tdt), float(jdt), rtol=1e-14)
        np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=1e-12,
                                   atol=1e-13)


def test_unbatched_fields_keep_their_shape():
    tm, _ = _metrics(16, 24)
    u, v, T = (torch.as_tensor(a[0]) for a in _fields(4, 1, 16, 24, 5.0))
    T2, dt2 = advect_diffuse_step_fused(u, v, T, 1.5, tm)
    T3, dt3 = advect_diffuse_step_fused(u[None], v[None], T[None], 1.5, tm)
    assert T2.shape == (16, 24) and dt2.shape == ()
    assert torch.equal(T2, T3[0]) and torch.equal(dt2, dt3)


def test_viscous_dissipation_matches_jax():
    """rtol 1e-12, float64, B=2 at 22×30."""
    B, H, W = 2, 22, 30
    tm, jm = _metrics(H, W)
    rng = np.random.default_rng(5)
    u, v = rng.normal(size=(2, B, H, W)) * 30
    V = np.exp(rng.normal(size=(B, H, W)))
    ref = jadv.viscous_dissipation(jnp.asarray(u), jnp.asarray(v),
                                   jnp.asarray(V), jm)
    out = viscous_dissipation(torch.as_tensor(u), torch.as_tensor(v),
                              torch.as_tensor(V), tm)
    assert out.shape == (B, H - 2, W - 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12)


@pytest.mark.parametrize("core_cool", [False, True])
def test_stamp_temperature_bc_core_cool(core_cool):
    T = np.random.default_rng(6).uniform(size=(2, 12, 18))
    out = tst.stamp_temperature_bc(torch.as_tensor(T), core_cool=core_cool)
    ref = jst.stamp_temperature_bc(jnp.asarray(T), core_cool=core_cool)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_kernel_entry_points_match_their_ctypes_signatures():
    """csrc/advect.cu has no compiler here: its two C entry points must at
    least take the arguments the wrapper's ctypes signature declares."""
    src = (_cuda.CSRC / "advect.cu").read_text()
    assert "advect.cu" in _cuda.SOURCES
    m = re.search(r"extern \"C\" int NAME\((.*?)\)\s*\{", src, re.S)
    params = [p for p in m.group(1).replace("\\", "").split(",") if p.strip()]
    kinds = [_cuda._P if "*" in p else _cuda._D if "double" in p else _cuda._I
             for p in params]
    for name in ("pmc_advect_f32", "pmc_advect_f64"):
        assert f"PMC_ADVECT_ENTRY({name}," in src
        assert _cuda._SIGNATURES[name] == kinds
