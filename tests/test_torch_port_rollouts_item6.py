"""Coupled rollouts of the other models on the port against the JAX
package's, in float64 on the CPU, the Flax weights carried across by
``from_jax_params``:

1. the legacy iterative ``ifluidnet`` branch: ``assemble_ifluidnet_input``
   (with ``Grid.sdf``/``sdf2``), ``TimeStepper.stokes_iterative`` and
   ``step_iterative`` against JAX's, ≤1e-12 of max for the input, rtol
   1e-10 for the step;
2. ``SimEngine`` ML_STOKES rollouts of the symmetric NewFluidNet, FluidNet,
   the multi-scale ensemble and the ViT (the module path and the energy
   step) against the JAX engine over the Flax modules, rtol 1e-10 on dt,
   the mean-T trace and the fields;
3. the ``blurr`` flagship through ``FastNewFluidNet`` and ``SimEngine``
   against JAX's engine over JAX's ``FastNewFluidNet`` (its Pallas
   megakernel in interpret mode, as JAX's own fast-path tests run it on
   the CPU), rtol 1e-10; the fused epilogue is not taken (it would skip
   the blur).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.constants import SimParams as JParams  # noqa: E402
from pbml_mantle_convection_tpu.models import fluidnet as jfn  # noqa: E402
from pbml_mantle_convection_tpu.models import vit as jvit  # noqa: E402
from pbml_mantle_convection_tpu.models.fast_path import (  # noqa: E402
    FastNewFluidNet as JFast)
from pbml_mantle_convection_tpu.sim import stepper as jstepper  # noqa: E402
from pbml_mantle_convection_tpu.sim.engine import SimEngine as JEngine  # noqa: E402
from pbml_mantle_convection_tpu.sim.grid import Grid as JGrid  # noqa: E402

from pbml_mantle_convection_tpu_torch.constants import SimParams  # noqa: E402
from pbml_mantle_convection_tpu_torch.models import fluidnet as tfn  # noqa: E402
from pbml_mantle_convection_tpu_torch.models import vit as tvit  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.fast_path import (  # noqa: E402
    FastNewFluidNet, unsupported_reason)
from pbml_mantle_convection_tpu_torch.sim import engine as tengine  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim import stepper as tstepper  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.grid import Grid  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)

F64 = torch.float64
PP = (3.0, 1e8, 10.0)


def _grids(H, W):
    aspect = (W - 2) / (H - 2)
    return (JGrid(H=H, W=W, aspect=aspect, dtype="float64"),
            Grid(H=H, W=W, aspect=aspect))


def _T0(grid):
    return np.clip(1.0 - grid.yc + 0.05 * np.sin(6.28 * grid.xc), 0, 1)[None]


def _pair(jm, tm, H, W, c_i=7, scale=1.0, seed=0):
    """Flax weights (scaled by ``scale``) and the port module with them."""
    w = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                         jnp.zeros((1, H, W, c_i), jnp.float64))
    w = jax.tree.map(lambda a: np.asarray(a) * scale, w)
    tm.load_state_dict(from_jax_params(w), strict=True)
    return w, tm


def _close(a, b, rtol):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                               atol=rtol * max(float(np.abs(b).max()), 1e-30))


# ------------------------------------------------------- legacy ifluidnet


def test_ifluidnet_input_and_iterative_step_match_jax():
    """The 9-channel input (the boundary rings in place of the
    coordinates, the velocity iterate fed back), then two iterations of
    the FluidNet with c_i = 9 on the W-padded input, cropped, unscaled,
    its corners zeroed, and the energy step."""
    H, W = 16, 24
    jgrid, grid = _grids(H, W)
    np.testing.assert_array_equal(grid.sdf, np.asarray(jgrid.sdf))
    np.testing.assert_array_equal(grid.sdf2, np.asarray(jgrid.sdf2))
    cfg = dict(levels=2, c_i=9, c_h=8, c_o=1, act_fn="gelu", r_p="zeros",
               loss_type="curl", repeats=1, f=5, p_pred=False)
    jm = jfn.FluidNet(**cfg)
    w, tm = _pair(jm, tfn.FluidNet(**cfg, device="cpu", dtype=F64), H, W + 6,
                  c_i=9, scale=0.5)
    jst = jstepper.TimeStepper(grid=jgrid, params=JParams(*PP),
                               apply_fn=lambda x: jm.apply(w, x),
                               net="ifluidnet", cn_max=0.99,
                               dtype=jnp.float64)
    tst = tstepper.TimeStepper(grid, SimParams(*PP), tm, cn_max=0.99,
                               dtype=F64, device="cpu", net="ifluidnet")
    T = _T0(grid)
    rng = np.random.default_rng(0)
    u, v = rng.normal(size=(2, 1, H, W))
    x, V = tstepper.assemble_ifluidnet_input(
        torch.as_tensor(T), torch.as_tensor(u), torch.as_tensor(v), grid,
        tst.static, tst.params)
    jx, jV = jstepper.assemble_ifluidnet_input(
        jnp.asarray(T), jnp.asarray(u), jnp.asarray(v), jgrid, jst._static,
        jst.params)
    _close(x, jx, 1e-12)
    _close(V, jV, 1e-12)
    got = tst.stokes_iterative(torch.as_tensor(T), n_iter=2)
    want = jst.stokes_iterative(jnp.asarray(T), n_iter=2)
    assert got[2] is None and want[2] is None
    for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):
        _close(a, b, 1e-10)
    assert float(got[0][..., 0, 0].abs().max()) == 0.0
    got = tst.step_iterative(torch.as_tensor(T))
    want = jst.step_iterative(jnp.asarray(T))
    for a, b in zip(got, want):
        if b is not None:
            _close(torch.as_tensor(a), b, 1e-10)


# ------------------------------------------------------ engine rollouts


def _models(name, H, W):
    """(Flax module, port module) of each network with a module-path
    rollout, at test width."""
    fl = dict(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu",
              loss_type="curl", repeats=1, f=5, p_pred=False, a_bound=4.0)
    if name == "symm":
        cfg = dict(fl, r_p="learned", use_symm=True)
        return jfn.NewFluidNet(**cfg), tfn.NewFluidNet(**cfg, device="cpu",
                                                       dtype=F64)
    if name == "fluidnet":
        cfg = dict(fl, r_p="learned")
        return jfn.FluidNet(**cfg), tfn.FluidNet(**cfg, device="cpu",
                                                 dtype=F64)
    if name == "multiscale":
        cfg = dict(fl, r_p="zeros", scales=(1e-5, 1e-1))
        return (jfn.MultiScaleNewFluidNet(**cfg),
                tfn.MultiScaleNewFluidNet(**cfg, device="cpu", dtype=F64))
    cfg = dict(image_size=(H, W), patch_size=(8, 2), c_o=2, dim=16, depth=1,
               heads=2, mlp_dim=32, channels=7)
    return jvit.ViTField(**cfg), tvit.ViTField(**cfg, device="cpu",
                                               dtype=F64)


@pytest.mark.parametrize("name,scale", [("symm", 0.5), ("fluidnet", 0.5),
                                        ("multiscale", 0.5), ("vit", 0.02)])
def test_module_rollout_matches_the_jax_engine(name, scale):
    """Five coupled ML_STOKES steps: the network's module, velocity
    unscaling, the energy step (its plain version on the CPU) and BCs,
    against the JAX engine over the Flax module; no fused epilogue on
    either side."""
    H, W, steps = 16, 24, 5
    jgrid, grid = _grids(H, W)
    jm, tm = _models(name, H, W)
    w, tm = _pair(jm, tm, H, W, scale=scale, seed=3)
    jeng = JEngine(grid=jgrid, params=JParams(*PP), dtype=jnp.float64,
                   stepper=jstepper.TimeStepper(
                       grid=jgrid, params=JParams(*PP),
                       apply_fn=lambda x: jm.apply(w, x), cn_max=0.99,
                       dtype=jnp.float64))
    jstate, jtrace = jax.jit(jeng.multi_step, static_argnums=1)(
        jeng.init_state(jnp.asarray(_T0(grid))), steps)
    eng = SimEngine(tstepper.TimeStepper(grid, SimParams(*PP), tm,
                                         cn_max=0.99, dtype=F64,
                                         device="cpu"))
    assert eng._epi is None
    state, trace = eng.multi_step(eng.init_state(_T0(grid)), steps)
    np.testing.assert_allclose(trace.dt.numpy(), np.asarray(jtrace.dt),
                               rtol=1e-10)
    np.testing.assert_allclose(trace.mean_T.numpy(),
                               np.asarray(jtrace.mean_T), rtol=1e-10)
    for f in ("T", "u", "v", "V"):
        _close(getattr(state, f), getattr(jstate, f), 1e-10)
    assert float((state.T - torch.as_tensor(_T0(grid))).abs().max()) > 0


def test_blurr_flagship_through_the_executor_matches_jax_fast_path(
        monkeypatch):
    """The ``blurr`` NewFluidNet through the fused executor (its stages'
    plain versions on the CPU) and the engine's module epilogue — the
    blurred curl head and the energy step, 4 + 1 + 0 + 1 calls per step
    on the card — against the JAX engine over JAX's FastNewFluidNet with
    its megakernel in interpret mode, float64, six steps at rtol 1e-10.
    The fused epilogue must not run: it takes the raw stream function and
    would skip the blur."""
    H, W, steps = 20, 28, 6
    cfg = dict(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu", r_p="learned",
               loss_type="curl", repeats=1, f=5, p_pred=False, blurr=True)
    jm = jfn.NewFluidNet(**cfg)
    w, tm = _pair(jm, tfn.NewFluidNet(**cfg, device="cpu", dtype=F64), H, W)
    assert unsupported_reason(tm) is None
    jgrid, grid = _grids(H, W)
    jfast = JFast(jm, w, H, W, megakernel=True)
    assert jfast.use_megakernel
    jeng = JEngine(grid=jgrid, params=JParams(*PP), dtype=jnp.float64,
                   stepper=jstepper.TimeStepper(
                       grid=jgrid, params=JParams(*PP), apply_fn=jfast,
                       cn_max=0.99, dtype=jnp.float64))
    assert jeng._epi is None
    jstate, jtrace = jeng.multi_step(jeng.init_state(jnp.asarray(_T0(grid))),
                                     steps)

    def no_epilogue(*a, **k):
        raise AssertionError("the fused epilogue ran for a blurr network")

    monkeypatch.setattr(tengine, "curl_advect_epilogue", no_epilogue)
    eng = SimEngine(tstepper.TimeStepper(grid, SimParams(*PP),
                                         FastNewFluidNet(tm, H, W),
                                         cn_max=0.99, dtype=F64,
                                         device="cpu"))
    assert eng._epi is None                  # the engine's one gate: closed
    state, trace = eng.multi_step(eng.init_state(_T0(grid)), steps)
    np.testing.assert_allclose(trace.dt.numpy(), np.asarray(jtrace.dt),
                               rtol=1e-10)
    np.testing.assert_allclose(trace.mean_T.numpy(),
                               np.asarray(jtrace.mean_T), rtol=1e-10)
    for f in ("T", "u", "v"):
        _close(getattr(state, f), getattr(jstate, f), 1e-10)
    # the same network without blurr takes the fused epilogue
    plain = tfn.NewFluidNet(**{**cfg, "blurr": False}, device="cpu",
                            dtype=F64)
    eng = SimEngine(tstepper.TimeStepper(grid, SimParams(*PP),
                                         FastNewFluidNet(plain, H, W),
                                         dtype=F64, device="cpu"))
    assert eng._epi is not None
