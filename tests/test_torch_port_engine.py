"""The port's coupled ML_STOKES rollout against the JAX package's.

1. The golden trajectory of tests/test_golden_rollout.py (float64, 20×28,
   weights from PRNGKey(42) through the weight bridge) at rtol 1e-10,
   through the module path and through the fused executor (whose stages
   run their plain versions on the CPU).
2. The path bench.py times, in float32 at 16×30 with 2 levels: the JAX
   SimEngine over FastNewFluidNet(megakernel=True) with the fused epilogue,
   all in Pallas interpret mode, vs the port's engine over its fused
   executor — at the tolerances of tests/test_fast_path.py and
   tests/test_epilogue_kernel.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.constants import SimParams as JParams  # noqa: E402
from pbml_mantle_convection_tpu.models import NewFluidNet as JNewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu.models.fast_path import (  # noqa: E402
    FastNewFluidNet as JFast)
from pbml_mantle_convection_tpu.sim.engine import SimEngine as JEngine  # noqa: E402
from pbml_mantle_convection_tpu.sim.grid import Grid as JGrid  # noqa: E402
from pbml_mantle_convection_tpu.sim.stepper import TimeStepper as JStepper  # noqa: E402

from pbml_mantle_convection_tpu_torch.constants import SimParams  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.fast_path import (  # noqa: E402
    FastNewFluidNet)
from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu_torch.ops.branch_kernel import layer_stack  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.engine import (  # noqa: E402
    SimEngine, decay_heating)
from pbml_mantle_convection_tpu_torch.sim.grid import Grid  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)

# tests/test_golden_rollout.py
GOLDEN_MEAN_T = np.array([
    0.50852435396219, 0.51523988800937, 0.52018929939515,
    0.52298553430237, 0.52387808893873])
GOLDEN_T_SUM = 293.37172980569


def _port_net(jax_params, dtype, **cfg):
    net = NewFluidNet(c_i=7, c_o=1, act_fn="gelu", r_p="learned",
                      loss_type="curl", f=5, p_pred=False, device="cpu",
                      dtype=dtype, **cfg)
    net.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                     jax_params)))
    return net


@pytest.mark.parametrize("fused", [False, True])
def test_golden_rollout(fused):
    grid = Grid(H=20, W=28)
    params = SimParams(raq=4.0, fkt=1e7, fkp=5.0)
    jm = JNewFluidNet(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu",
                      r_p="learned", loss_type="curl", repeats=1, f=5,
                      p_pred=False)
    w = jm.init(jax.random.PRNGKey(42), jnp.zeros((1, 20, 28, 7),
                                                   jnp.float64))
    net = _port_net(w, torch.float64, levels=2, c_h=8, repeats=1)
    fn = FastNewFluidNet(net, 20, 28) if fused else net
    engine = SimEngine(TimeStepper(grid, params, fn, cn_max=0.99,
                                   dtype=torch.float64, device="cpu"))
    assert (engine._epi is not None) == fused
    T0 = np.clip(1.0 - grid.yc + 0.05 * np.sin(3 * grid.xc), 0, 1)[None]
    n0 = layer_stack.launches
    state, trace = engine.multi_step(engine.init_state(T0), 50)
    assert layer_stack.launches == n0          # CPU: plain versions only
    np.testing.assert_allclose(trace.mean_T.numpy()[[9, 19, 29, 39, 49]],
                               GOLDEN_MEAN_T, rtol=1e-10)
    np.testing.assert_allclose(float(state.T.sum()), GOLDEN_T_SUM,
                               rtol=1e-10)
    assert int(state.n_step) == 50
    np.testing.assert_allclose(float(state.t), float(trace.dt.sum()),
                               rtol=1e-12)


def test_fused_rollout_matches_jax_megakernel_path():
    """Step by step: u, v after the first step at the megakernel standard
    (tests/test_fast_path.py:184-187, on the unscaled network output),
    T and dt at the fused-epilogue standard
    (tests/test_epilogue_kernel.py:193-199) for every step."""
    H, W, levels, n = 16, 30, 2, 3
    jm = JNewFluidNet(levels=levels, c_i=7, c_h=8, c_o=1, act_fn="gelu",
                      r_p="learned", loss_type="curl", repeats=2, f=5,
                      p_pred=False)
    w = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 7), jnp.float32))
    fast = JFast(jm, w, H, W, megakernel=True)
    assert fast.use_megakernel
    jgrid = JGrid(H=H, W=W, aspect=(W - 2) / (H - 2), dtype="float32")
    pp = JParams(3.0, 1e8, 10.0)
    jeng = JEngine(grid=jgrid, params=pp, dtype=jnp.float32,
                   stepper=JStepper(grid=jgrid, params=pp, apply_fn=fast,
                                    cn_max=0.99, dtype=jnp.float32))
    assert jeng._fused_eligible()
    T0 = np.clip(1.0 - jgrid.yc_np + 0.05 * np.sin(6.28 * jgrid.xc_np),
                 0, 1).astype(np.float32)[None]

    net = _port_net(w, torch.float32, levels=levels, c_h=8, repeats=2)
    grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2))
    eng = SimEngine(TimeStepper(grid, SimParams(3.0, 1e8, 10.0),
                                FastNewFluidNet(net, H, W), cn_max=0.99,
                                device="cpu"))
    assert eng._epi is not None
    s = eng.stepper.scaler

    jstep = jax.jit(jeng.step)
    js, ts = jeng.init_state(jnp.asarray(T0)), eng.init_state(T0)
    for i in range(n):
        js, ts = jstep(js), eng.step(ts)
        np.testing.assert_allclose(ts.T.numpy(), np.asarray(js.T),
                                   rtol=3e-5, atol=3e-5)
        np.testing.assert_allclose(float(ts.t), float(js.t), rtol=1e-5)
        if i == 0:
            for name in ("u", "v"):
                np.testing.assert_allclose(
                    getattr(ts, name).numpy() / s,
                    np.asarray(getattr(js, name)) / s, rtol=1e-6, atol=2e-6)
    # f32 exp of arguments of magnitude ~20: ~1e-6 relative
    np.testing.assert_allclose(ts.V.numpy(), np.asarray(js.V), rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_decay_rollout_matches_jax(fused):
    """Radioactive-decay heating (a device scalar fed to the epilogue):
    10 float64 steps vs the JAX engine at rtol 1e-10."""
    jgrid = JGrid(H=20, W=28)
    pp = JParams(raq=4.0, fkt=1e7, fkp=5.0)
    jm = JNewFluidNet(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu",
                      r_p="learned", loss_type="curl", repeats=1, f=5,
                      p_pred=False)
    w = jm.init(jax.random.PRNGKey(42), jnp.zeros((1, 20, 28, 7),
                                                   jnp.float64))
    jeng = JEngine(grid=jgrid, params=pp, dtype=jnp.float64,
                   radioactive_decay=True,
                   stepper=JStepper(grid=jgrid, params=pp,
                                    apply_fn=lambda x: jm.apply(w, x),
                                    cn_max=0.99, dtype=jnp.float64))
    T0 = np.clip(1.0 - jgrid.yc_np + 0.05 * np.sin(3 * jgrid.xc_np), 0, 1)
    js, jtr = jax.jit(jeng.multi_step, static_argnums=1)(
        jeng.init_state(jnp.asarray(T0)[None]), 10)

    net = _port_net(w, torch.float64, levels=2, c_h=8, repeats=1)
    fn = FastNewFluidNet(net, 20, 28) if fused else net
    eng = SimEngine(TimeStepper(Grid(H=20, W=28), SimParams(4.0, 1e7, 5.0),
                                fn, cn_max=0.99, dtype=torch.float64,
                                device="cpu"), radioactive_decay=True)
    ts, ttr = eng.multi_step(eng.init_state(T0[None]), 10)
    np.testing.assert_allclose(ttr.mean_T.numpy(), np.asarray(jtr.mean_T),
                               rtol=1e-10)
    np.testing.assert_allclose(ts.T.numpy(), np.asarray(js.T), rtol=1e-10,
                               atol=1e-12)


def test_decay_heating_and_unsupported_configs():
    t = torch.tensor(0.05, dtype=torch.float64)
    from pbml_mantle_convection_tpu.sim.engine import (
        decay_heating as j_decay)
    for on in (False, True):
        np.testing.assert_allclose(
            float(decay_heating(3.0, t, on)),
            float(j_decay(3.0, jnp.asarray(0.05), on, jnp.float64)),
            rtol=1e-14)
    net = NewFluidNet(levels=2, c_i=7, c_h=8, c_o=1, act_fn="selu",
                      r_p="learned", loss_type="curl", f=5, p_pred=False,
                      device="cpu")
    with pytest.raises(ValueError, match="act_fn"):
        FastNewFluidNet(net, 16, 30)
    with pytest.raises(ValueError, match="learned padding"):
        FastNewFluidNet(NewFluidNet(levels=2, c_i=7, c_h=8, c_o=1,
                                    act_fn="gelu", r_p="zeros",
                                    loss_type="curl", f=5, p_pred=False,
                                    device="cpu"), 16, 30)


@pytest.mark.parametrize("fused", [False, True])
def test_stepper_step_and_rollout_snapshots(fused):
    """TimeStepper.step (Stokes surrogate + energy step + BCs) vs the JAX
    stepper in float64; SimEngine.rollout with snapshots equals one
    multi_step run."""
    H, W = 20, 28
    jgrid = JGrid(H=H, W=W)
    pp = JParams(raq=4.0, fkt=1e7, fkp=5.0)
    jm = JNewFluidNet(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu",
                      r_p="learned", loss_type="curl", repeats=1, f=5,
                      p_pred=False)
    w = jm.init(jax.random.PRNGKey(7), jnp.zeros((1, H, W, 7), jnp.float64))
    jst = JStepper(grid=jgrid, params=pp, apply_fn=lambda x: jm.apply(w, x),
                   cn_max=0.99, dtype=jnp.float64)
    T0 = np.clip(1.0 - jgrid.yc_np + 0.05 * np.sin(3 * jgrid.xc_np),
                 0, 1)[None]
    jT, jdt, ju, jv, _, jV = jst.step(jnp.asarray(T0))

    net = _port_net(w, torch.float64, levels=2, c_h=8, repeats=1)
    fn = FastNewFluidNet(net, H, W) if fused else net
    st = TimeStepper(Grid(H=H, W=W), SimParams(4.0, 1e7, 5.0), fn,
                     cn_max=0.99, dtype=torch.float64, device="cpu")
    tT, tdt, tu, tv, tp, tV = st.step(torch.as_tensor(T0))
    assert tp is None
    for a, b in ((tT, jT), (tu, ju), (tv, jv), (tV, jV)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-10 * float(np.abs(b).max()))
    np.testing.assert_allclose(float(tdt), float(jdt), rtol=1e-10)

    eng = SimEngine(st)
    s6, tr6 = eng.multi_step(eng.init_state(T0), 6)
    sr, trr, snaps = eng.rollout(eng.init_state(T0), 6, snapshot_every=4)
    assert [float(s["t"]) for s in snaps] == [float(trr.t[3]),
                                              float(trr.t[5])]
    assert snaps[-1]["T"].shape == (1, H, W)
    assert torch.equal(sr.T, s6.T) and torch.equal(trr.mean_T, tr6.mean_T)
