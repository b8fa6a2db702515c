"""B > 1 coupled rollouts through the fused executor, on the CPU (where
its stages run their plain versions), float64:

1. B = 3 through ``FastNewFluidNet`` against the JAX engine over the
   module at B = 3 (rtol 1e-10 on T and dt, the golden rollout's
   tolerance), with B executor inputs per step and no epilogue;
2. the same B = 3 trajectory against three B = 1 trajectories of the
   port, each advanced with the batch's dt (one dt for the batch: the
   smallest of the three adaptive steps).
The fields are the CLI's phase-shifted ones.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.constants import SimParams as JParams  # noqa: E402
from pbml_mantle_convection_tpu.models import NewFluidNet as JNewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu.sim.engine import SimEngine as JEngine  # noqa: E402
from pbml_mantle_convection_tpu.sim.grid import Grid as JGrid  # noqa: E402
from pbml_mantle_convection_tpu.sim.stepper import TimeStepper as JStepper  # noqa: E402

from pbml_mantle_convection_tpu_torch.cli.benchmark import (  # noqa: E402
    initial_temperature)
from pbml_mantle_convection_tpu_torch.constants import SimParams  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.fast_path import (  # noqa: E402
    FastNewFluidNet)
from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu_torch.ops import epilogue_kernel  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim import engine as engine_mod  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.grid import Grid  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)

H, W, B, STEPS = 20, 28, 3, 6
CFG = dict(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu", r_p="learned",
           loss_type="curl", repeats=1, f=5, p_pred=False)


@pytest.fixture(scope="module")
def setup():
    jm = JNewFluidNet(**CFG)
    w = jax.jit(jm.init)(jax.random.PRNGKey(0),
                         jnp.zeros((1, H, W, 7), jnp.float64))
    net = NewFluidNet(device="cpu", dtype=torch.float64, **CFG)
    net.load_state_dict(from_jax_params(jax.tree.map(np.asarray, w)))
    grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2))
    return jm, w, net, grid, initial_temperature(grid, B)


def _port_engine(net, grid):
    stepper = TimeStepper(grid, SimParams(3.0, 1e8, 10.0),
                          FastNewFluidNet(net, H, W), cn_max=0.99,
                          dtype=torch.float64, device="cpu")
    calls = []
    planar = stepper.executor_input

    def counted(T, V):
        calls.append(T.shape)
        return planar(T, V)

    stepper.executor_input = counted
    return SimEngine(stepper), calls


def test_batched_fused_rollout_matches_the_jax_engine(setup, monkeypatch):
    jm, w, net, grid, T0 = setup
    jgrid = JGrid(H=H, W=W, aspect=(W - 2) / (H - 2), dtype="float64")
    pp = JParams(3.0, 1e8, 10.0)
    jeng = JEngine(grid=jgrid, params=pp, dtype=jnp.float64,
                   stepper=JStepper(grid=jgrid, params=pp,
                                    apply_fn=lambda x: jm.apply(w, x),
                                    net="newfluidnet", cn_max=0.99,
                                    dtype=jnp.float64))
    jstate, jtrace = jax.jit(jeng.multi_step, static_argnums=1)(
        jeng.init_state(jnp.asarray(T0)), STEPS)

    epilogue_calls = []
    monkeypatch.setattr(engine_mod, "curl_advect_epilogue",
                        lambda *a: epilogue_calls.append(1)
                        or epilogue_kernel.curl_advect_epilogue(*a))
    eng, calls = _port_engine(net, grid)
    assert eng._epi is not None          # the B = 1 path would fuse
    state, trace = eng.multi_step(eng.init_state(T0), STEPS)
    assert calls == [(1, H, W)] * (B * STEPS)
    assert epilogue_calls == []
    assert state.T.shape == (B, H, W)
    np.testing.assert_allclose(trace.dt.numpy(), np.asarray(jtrace.dt),
                               rtol=1e-10)
    np.testing.assert_allclose(trace.mean_T.numpy(),
                               np.asarray(jtrace.mean_T), rtol=1e-10)
    for f in ("T", "u", "v"):
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   np.asarray(getattr(jstate, f)),
                                   rtol=1e-10, atol=1e-10)


def test_batched_rollout_is_three_single_rollouts_at_the_batch_dt(setup):
    _, _, net, grid, T0 = setup
    eng, _ = _port_engine(net, grid)
    stepper = eng.stepper
    state = eng.init_state(T0)
    singles = [torch.as_tensor(T0[b:b + 1]) for b in range(B)]
    for _ in range(STEPS):
        own_dt = [float(stepper.step(T)[1]) for T in singles]
        state = eng.step(state)
        assert float(state.dt) == min(own_dt)
        singles = [torch.clamp(stepper.step(T, dt=state.dt)[0], 0.0, 2.0)
                   for T in singles]
        for b in range(B):
            np.testing.assert_allclose(singles[b].numpy(),
                                       state.T[b:b + 1].numpy(),
                                       rtol=1e-12, atol=1e-14)
