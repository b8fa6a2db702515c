"""The port's SimEngine modes against the JAX package's SimEngine: GAIA,
GAIA with momentum skip, ML_PRE (analytic surrogate, and NewFluidNet
weights through the weight bridge and the fused executor), ML == ML_STOKES,
core cooling and Di > 0 — float64 rollouts at 24×34 with the analytic
surrogate of tests/test_engine.py, rtol 1e-10. The core-cooling and GAIA
comparisons run the JAX stepper with ``use_pallas=True``, so the Pallas
energy kernel (interpret mode) is in the reference loop."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.constants import SimParams as JParams  # noqa: E402
from pbml_mantle_convection_tpu.models import NewFluidNet as JNewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu.physics.stokes import (  # noqa: E402
    make_stokes_fn as j_make_stokes_fn)
from pbml_mantle_convection_tpu.sim.engine import SimEngine as JEngine  # noqa: E402
from pbml_mantle_convection_tpu.sim.grid import Grid as JGrid  # noqa: E402
from pbml_mantle_convection_tpu.sim.stepper import TimeStepper as JStepper  # noqa: E402

from pbml_mantle_convection_tpu_torch.constants import SimParams  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.fast_path import (  # noqa: E402
    FastNewFluidNet)
from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu_torch.ops.advect_kernel import (  # noqa: E402
    advect_diffuse_step_fused)
from pbml_mantle_convection_tpu_torch.physics.stokes import (  # noqa: E402
    make_stokes_fn)
from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.grid import Grid  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)

H, W = 24, 34
RAQ, FKT, FKP = 2.0, 1e7, 3.0
F64 = torch.float64


def _j_surrogate(grid, amp=1.0):
    """tests/test_engine.py::_analytic_surrogate: one convection cell."""
    xc, yc = grid.xc.astype(jnp.float64), grid.yc.astype(jnp.float64)
    u = amp * np.pi * jnp.cos(np.pi * yc) * jnp.sin(np.pi * xc / grid.aspect)
    v = -amp * (np.pi / grid.aspect) * jnp.sin(np.pi * yc) * jnp.cos(
        np.pi * xc / grid.aspect)

    def apply_fn(x):
        b = x.shape[0]
        return (jnp.broadcast_to(u, (b,) + u.shape),
                jnp.broadcast_to(v, (b,) + v.shape), None)
    return apply_fn


def _t_surrogate(grid, amp=1.0):
    """The same cell in PyTorch on the port's grid."""
    xc, yc = torch.as_tensor(grid.xc), torch.as_tensor(grid.yc)
    u = amp * np.pi * torch.cos(np.pi * yc) * torch.sin(np.pi * xc
                                                        / grid.aspect)
    v = -amp * (np.pi / grid.aspect) * torch.sin(np.pi * yc) * torch.cos(
        np.pi * xc / grid.aspect)

    def apply_fn(x):
        b = x.shape[0]
        return u.expand((b,) + u.shape), v.expand((b,) + v.shape), None
    return apply_fn


def _engines(mode="ML_STOKES", surrogate=True, use_pallas=False, n_iter=300,
             pre_iter=None, j_apply=None, t_apply=None, **kw):
    """(JAX engine, port engine) of one configuration."""
    jg, tg = JGrid(H=H, W=W), Grid(H=H, W=W)
    jp, tp = JParams(RAQ, FKT, FKP), SimParams(RAQ, FKT, FKP)
    cc = kw.get("core_cool", False)
    jst = JStepper(grid=jg, params=jp,
                   apply_fn=j_apply or _j_surrogate(jg), cn_max=0.99,
                   dtype=jnp.float64, core_cool=cc, use_pallas=use_pallas)
    apply_fn = (t_apply or _t_surrogate(tg)) if surrogate else None
    tst = TimeStepper(tg, tp, apply_fn, cn_max=0.99, core_cool=cc,
                      dtype=F64, device="cpu")
    jkw, tkw = dict(kw), dict(kw)
    if mode in ("GAIA", "ML_PRE"):
        jkw["stokes_fn"] = j_make_stokes_fn(jg, RAQ, n_iter=n_iter,
                                            pre_iter=pre_iter)
        tkw["stokes_fn"] = make_stokes_fn(tg, RAQ, n_iter=n_iter,
                                          pre_iter=pre_iter)
    jeng = JEngine(grid=jg, params=jp, stepper=jst, mode=mode,
                   dtype=jnp.float64, **jkw)
    return jeng, SimEngine(tst, mode=mode, **tkw)


def _T0(amp=0.2):
    g = Grid(H=H, W=W)
    return (1.0 - g.yc + amp * np.cos(np.pi * g.xc / g.aspect)
            * np.sin(np.pi * g.yc))[None]


def _rollout_both(jeng, teng, n, T0=None):
    T0 = _T0() if T0 is None else T0
    js, jtr = jax.jit(jeng.multi_step, static_argnums=1)(
        jeng.init_state(jnp.asarray(T0)), n)
    ts, ttr = teng.multi_step(teng.init_state(T0), n)
    return js, jtr, ts, ttr


def _assert_states_close(js, jtr, ts, ttr, rtol=1e-10):
    for name in ("T", "u", "v", "p", "V"):
        a, b = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=rtol * max(np.abs(b).max(), 1.0),
                                   err_msg=name)
    for name in ("t", "dt", "T_core"):
        np.testing.assert_allclose(float(getattr(ts, name)),
                                   float(getattr(js, name)), rtol=rtol,
                                   err_msg=name)
    assert int(ts.n_step) == int(js.n_step)
    np.testing.assert_allclose(ttr.mean_T.numpy(), np.asarray(jtr.mean_T),
                               rtol=rtol)
    np.testing.assert_allclose(ttr.dt.numpy(), np.asarray(jtr.dt), rtol=rtol)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_gaia_rollout_matches_jax(use_pallas):
    """mode GAIA: the PT solve (ptol early stop) on the unclipped FK
    viscosity every step; the port's stepper has no surrogate."""
    jeng, teng = _engines("GAIA", surrogate=False, use_pallas=use_pallas)
    assert teng.stepper.apply_fn is None and teng._epi is None
    n0 = advect_diffuse_step_fused.launches
    _assert_states_close(*_rollout_both(jeng, teng, 4))
    assert advect_diffuse_step_fused.launches == n0     # CPU: plain only
    assert teng.stokes_fn.n_done.shape == (1,)
    # the unclipped viscosity: the cold plate is stiffer than the clip
    assert float(teng.multi_step(teng.init_state(_T0()), 1)[0].V.max()) > 1.0


def test_gaia_momentum_skip_matches_jax():
    """GAIA-skip3 (MMSolverSkip, prepare_gaia_ini.py:152): steps 0 and 3
    solve, 1, 2, 4, 5 reuse the velocities (tests/test_engine.py:153-175),
    step by step and across multi_step calls that start mid-cycle."""
    jeng, teng = _engines("GAIA", surrogate=False, intervene_ts=3)
    jstep = jax.jit(jeng.step)
    js, ts = jeng.init_state(jnp.asarray(_T0())), teng.init_state(_T0())
    us = []
    for _ in range(6):
        js, ts = jstep(js), teng.step(ts)
        us.append(ts.u.numpy())
        np.testing.assert_allclose(ts.T.numpy(), np.asarray(js.T),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u),
                                   rtol=1e-10,
                                   atol=1e-10 * np.abs(np.asarray(js.u)).max())
    np.testing.assert_array_equal(us[0], us[1])
    np.testing.assert_array_equal(us[1], us[2])
    assert np.abs(us[3] - us[2]).max() > 0
    np.testing.assert_array_equal(us[3], us[4])
    # 2 + 4 steps through multi_step land on the same state as 6 steps
    s2, _ = teng.multi_step(teng.init_state(_T0()), 2)
    s6, _ = teng.multi_step(s2, 4)
    assert torch.equal(s6.T, ts.T) and torch.equal(s6.u, ts.u)


def test_ml_pre_analytic_matches_jax():
    """ML_PRE: the surrogate's prediction warm-starts pre_iter PT
    iterations (advect_wi_gaia.py:221,488); p falls back to the state's."""
    jeng, teng = _engines("ML_PRE", n_iter=3000, pre_iter=400)
    _assert_states_close(*_rollout_both(jeng, teng, 3))
    assert teng.stokes_fn.n_done.tolist() == [500]


def test_ml_pre_newfluidnet_fused_matches_jax():
    """ML_PRE with NewFluidNet weights (Flax init, through from_jax_params)
    run by the port's fused executor, against the Flax module in the JAX
    engine."""
    jm = JNewFluidNet(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu",
                      r_p="learned", loss_type="curl", repeats=1, f=5,
                      p_pred=False)
    w = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, H, W, 7), jnp.float64))
    net = NewFluidNet(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu",
                      r_p="learned", loss_type="curl", repeats=1, f=5,
                      p_pred=False, device="cpu", dtype=F64)
    net.load_state_dict(from_jax_params(jax.tree.map(np.asarray, w)))
    jeng, teng = _engines("ML_PRE", n_iter=1000, pre_iter=100,
                          j_apply=lambda x: jm.apply(w, x),
                          t_apply=FastNewFluidNet(net, H, W))
    assert teng._epi is None
    _assert_states_close(*_rollout_both(jeng, teng, 3))


def test_ml_equals_ml_stokes_and_matches_jax():
    """ML and ML_STOKES coincide in-framework (tests/test_engine.py:136-150);
    both equal the JAX ML_STOKES rollout."""
    jeng, t_ml = _engines("ML", intervene_ts=3)
    _, t_mls = _engines("ML_STOKES")
    s1, tr1 = t_ml.multi_step(t_ml.init_state(_T0()), 40)
    s2, tr2 = t_mls.multi_step(t_mls.init_state(_T0()), 40)
    assert torch.equal(s1.T, s2.T) and torch.equal(tr1.mean_T, tr2.mean_T)
    js, jtr = jax.jit(jeng.multi_step, static_argnums=1)(
        jeng.init_state(jnp.asarray(_T0())), 40)
    _assert_states_close(js, jtr, s1, tr1)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_core_cooling_matches_jax(use_pallas):
    """Core cooling: T_core falls with the CMB heat flux, row 0 holds
    T_core; with radioactive decay too (use_pallas: the JAX stepper's
    Pallas kernel leaves row 0 free, as the port's kernel does)."""
    jeng, teng = _engines(core_cool=True, radioactive_decay=True,
                          use_pallas=use_pallas)
    assert teng._epi is None
    js, jtr, ts, ttr = _rollout_both(jeng, teng, 30, T0=_T0(0.3))
    _assert_states_close(js, jtr, ts, ttr)
    assert float(ts.T_core) < 1.0
    np.testing.assert_array_equal(ts.T[0, 0].numpy(),
                                  np.full(W, float(ts.T_core)))


def test_eba_di_matches_jax():
    """Di = 0.5: the adiabatic -Di·v·T and the viscous dissipation
    +Di·Φ as a field source of the energy step."""
    jeng, teng = _engines(Di=0.5)
    T0 = _T0()
    state = teng.init_state(T0)
    u, v, _, V = teng.stepper.stokes(state.T)
    src = teng._energy_sources(state, state.T, u, v, V)
    assert src.shape == (1, H - 2, W - 2)
    js, jtr, ts, ttr = _rollout_both(jeng, teng, 20, T0=T0)
    _assert_states_close(js, jtr, ts, ttr)
    _, t0 = _engines()
    s0, _ = t0.multi_step(t0.init_state(T0), 20)
    assert float((s0.T - ts.T).abs().max()) > 0


def test_get_state_contract_and_config_errors():
    jeng, teng = _engines()
    ts = teng.step(teng.init_state(_T0()))
    js = jax.jit(jeng.step)(jeng.init_state(jnp.asarray(_T0())))
    d, jd = teng.get_state(ts), jeng.get_state(js)
    assert set(d) == set(jd)
    for k in ("T", "v", "P", "V", "pos"):
        assert d[k].shape == jd[k].shape
        np.testing.assert_allclose(d[k], jd[k], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(d["time"], jd["time"], rtol=1e-10)
    st = teng.stepper
    with pytest.raises(ValueError, match="stokes_fn"):
        SimEngine(st, mode="GAIA")
    with pytest.raises(ValueError, match="mode"):
        SimEngine(st, mode="UNET")
    bare = TimeStepper(Grid(H=H, W=W), SimParams(RAQ, FKT, FKP), None,
                       dtype=F64, device="cpu")
    with pytest.raises(ValueError, match="surrogate"):
        SimEngine(bare)
    with pytest.raises(ValueError, match="surrogate"):
        bare.stokes(ts.T)
