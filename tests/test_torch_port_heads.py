"""The fused executor of a NewFluidNet with the heads beyond the curl
head (ROADMAP queue 1 item 12) against the JAX package on the CPU,
float64:

1. the port's ``FastNewFluidNet`` (its stages' plain versions; merge 3
   a ``layer_stack`` of the model's c_o) with the ``mae`` head (c_o 2),
   the ``mass`` head (c_o 2), a curl head with ``p_pred`` (c_o 2) and
   the ``mae`` head with ``p_pred`` (c_o 3), each with learned and zero
   padding, against JAX's ``FastNewFluidNet(megakernel=True)`` in Pallas
   interpret mode (its ``_finish_mergek`` splits the channels) and
   against the Flax module, levels=2, c_h=8, repeats=2 at 16×32, at
   PARITY.md's forward bound 1e-9 (max |diff| / max |ref|): zero padding
   here, learned padding in tests/test_torch_port_heads_executor.py (two
   files, so two workers share JAX's traces);
2. a ``p_pred`` rollout (curl head, and ``mae`` + ``p_pred``) through
   the executor at B = 1 and B = 2 (each simulation through the B = 1
   executor in turn, p stacked) against the JAX engine over the Flax
   module, rtol 1e-10 on dt, the mean-T trace and T, u, v, p; the engine
   takes no fused epilogue for these heads (JAX's gates it off,
   engine.py:184-188), and p reaches the state;
3. the route the CLIs take (``executor_or_module``): the executor for
   every head, the module where the executor lacks the width or kernel
   size, a raise where JAX's constructor raises.
"""

import functools

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

from pbml_mantle_convection_tpu_torch.cli.benchmark import (  # noqa: E402
    initial_temperature)
from pbml_mantle_convection_tpu_torch.constants import SimParams  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.fast_path import (  # noqa: E402
    FastNewFluidNet, executor_or_module, unsupported_reason)
from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim import engine as engine_mod  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.grid import Grid  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)

F64 = torch.float64
TOL = 1e-9
H, W = 16, 32
# (loss_type, p_pred) → merge 3's c_o
HEADS = {("mae", False): 2, ("mass", False): 2, ("curl", True): 2,
         ("mae", True): 3}


def _cfg(loss_type, p_pred, r_p, levels=2, repeats=2):
    return dict(levels=levels, c_i=7, c_h=8, c_o=HEADS[loss_type, p_pred],
                act_fn="gelu", r_p=r_p, loss_type=loss_type, repeats=repeats,
                f=5, p_pred=p_pred)


@functools.lru_cache(maxsize=None)
def _params(loss_type, p_pred, r_p):
    """Seeded Flax params and a seeded input."""
    x = jnp.asarray(np.random.default_rng(7).normal(size=(1, H, W, 7)))
    jm = JNewFluidNet(**_cfg(loss_type, p_pred, r_p))
    return jax.jit(jm.init)(jax.random.PRNGKey(0), x), x


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= TOL, f"{what}: {err:.3e} > {TOL}"


HEAD_IDS = [f"{lt}{'+p' if pp else ''}" for lt, pp in HEADS]


def check_executor_head(loss_type, p_pred, r_p):
    """(1) of the module doc for one head and padding."""
    cfg = _cfg(loss_type, p_pred, r_p)
    jm = JNewFluidNet(**cfg)
    p, x = _params(loss_type, p_pred, r_p)
    jfast = JFast(jm, p, H, W, megakernel=True)
    assert jfast.use_megakernel
    tm = NewFluidNet(**cfg, device="cpu", dtype=F64)
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, p)))
    assert unsupported_reason(tm) is None
    fast = FastNewFluidNet(tm, H, W)
    assert fast.merge3.c_o == cfg["c_o"] and fast.zero_pad == (r_p == "zeros")
    with torch.no_grad():
        got = fast(torch.as_tensor(np.array(x)))
        psi = fast.psi(torch.as_tensor(np.array(x[0])).permute(2, 0, 1)
                       .contiguous())
    assert psi.shape == (cfg["c_o"], H, W)
    want, mod = jfast(x), jm.apply(p, x)
    for i, name in enumerate("uvp"):
        if name == "p" and not p_pred:
            assert got[2] is None and want[2] is None and mod[2] is None
            continue
        _close(got[i].numpy(), want[i], f"executor {name} vs JAX megakernel")
        _close(got[i].numpy(), mod[i], f"executor {name} vs Flax module")


@pytest.mark.parametrize("loss_type,p_pred", list(HEADS), ids=HEAD_IDS)
def test_zero_padded_executor_heads_match_jax(loss_type, p_pred):
    """:func:`check_executor_head` with zero padding; learned padding
    (JAX's interpret-mode kernels trace ~4× longer there):
    tests/test_torch_port_heads_executor.py."""
    check_executor_head(loss_type, p_pred, "zeros")


def _rollout_nets(loss_type, B):
    """The JAX engine over the Flax module and the port's engine over the
    executor, same weights, float64, at 20×28 with B simulations."""
    Hs, Ws = 20, 28
    cfg = _cfg(loss_type, True, "learned", repeats=1)
    jm = JNewFluidNet(**cfg)
    w = jax.jit(jm.init)(jax.random.PRNGKey(3),
                         jnp.zeros((1, Hs, Ws, 7), jnp.float64))
    tm = NewFluidNet(**cfg, device="cpu", dtype=F64)
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, w)))
    grid = Grid(H=Hs, W=Ws, aspect=(Ws - 2) / (Hs - 2))
    jgrid = JGrid(H=Hs, W=Ws, aspect=(Ws - 2) / (Hs - 2), dtype="float64")
    pp = JParams(3.0, 1e8, 10.0)
    jeng = JEngine(grid=jgrid, params=pp, dtype=jnp.float64,
                   stepper=JStepper(grid=jgrid, params=pp,
                                    apply_fn=lambda x: jm.apply(w, x),
                                    net="newfluidnet", cn_max=0.99,
                                    dtype=jnp.float64))
    eng = SimEngine(TimeStepper(grid, SimParams(3.0, 1e8, 10.0),
                                FastNewFluidNet(tm, Hs, Ws), cn_max=0.99,
                                dtype=F64, device="cpu"))
    return jeng, eng, initial_temperature(grid, B)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("loss_type", ["curl", "mae"])
def test_p_pred_rollout_matches_the_jax_engine(loss_type, B, monkeypatch):
    steps = 5
    jeng, eng, T0 = _rollout_nets(loss_type, B)
    assert eng._epi is None                  # the engine's one gate: closed

    def no_epilogue(*a):
        raise AssertionError("the fused epilogue ran for a p_pred head")

    monkeypatch.setattr(engine_mod, "curl_advect_epilogue", no_epilogue)
    jstate, jtrace = jax.jit(jeng.multi_step, static_argnums=1)(
        jeng.init_state(jnp.asarray(T0)), steps)
    state, trace = eng.multi_step(eng.init_state(T0), steps)
    np.testing.assert_allclose(trace.dt.numpy(), np.asarray(jtrace.dt),
                               rtol=1e-10)
    np.testing.assert_allclose(trace.mean_T.numpy(),
                               np.asarray(jtrace.mean_T), rtol=1e-10)
    u, v, p, _ = eng.stepper.stokes(state.T)
    assert p is not None and p.shape == (B, 20, 28)
    assert float(state.p.abs().max()) > 0    # p reached the state
    for f in ("T", "u", "v", "p"):
        want = np.asarray(getattr(jstate, f))
        np.testing.assert_allclose(getattr(state, f).numpy(), want,
                                   rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())


def test_cli_route_is_chosen_from_the_configuration():
    base = dict(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu",
                r_p="learned", loss_type="curl", repeats=1, f=5,
                p_pred=False, device="cpu")
    for (lt, pp), c_o in HEADS.items():
        for r_p in ("learned", "zeros"):
            m = NewFluidNet(**{**base, "c_o": c_o, "loss_type": lt,
                               "p_pred": pp, "r_p": r_p})
            fn, route = executor_or_module(m, H, W)
            assert isinstance(fn, FastNewFluidNet), route
            assert route.startswith("route: fused executor"), route
    for bad, why in ((dict(c_h=32), "c_h=32"), (dict(c_h=12), "c_h=12"),
                     (dict(f=3), "k=3"), (dict(factor=4), "factor=4")):
        m = NewFluidNet(**{**base, **bad})
        fn, route = executor_or_module(m, H, W)
        assert fn is m and route.startswith("route: module") and why in route
        with pytest.raises(ValueError, match="unsupported config"):
            FastNewFluidNet(m, H, W)
    for bad in (dict(r_p="replicate"), dict(use_symm=True),
                dict(drop_rate=0.1)):
        with pytest.raises(ValueError, match="unsupported config"):
            executor_or_module(NewFluidNet(**{**base, **bad}), H, W)
