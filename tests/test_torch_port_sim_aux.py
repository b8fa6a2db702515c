"""The port's ini writer, profile MLP and native-engine binding against the
JAX package's, and the port's energy step, EBA step and PT solver against
the native C++ engine (native/gaia_engine.cpp), as tests/test_sim_aux.py
holds the JAX ones.

* ``create_ini_file`` and ``run_name``: byte for byte / equal strings;
* ``calc_mlp_profile``: both numpy, at most 1e-15 apart (equal in
  practice), ``ml_prof.txt`` byte for byte, the asset's arrays equal;
* the port's ``Direct`` at 32×62 (``layers=30, aspect_ratio=2.0``): the
  state contract, 10 ``doTimestep``s with the same seeded velocities bit
  for bit the JAX binding's (each binding loads its own build of the same
  source), the energy step (``ops/advect_kernel.py::
  advect_diffuse_step_fused``, its plain version on the CPU) and the EBA
  step against ``doTimestepDt`` at rtol 1e-12, ``physics/stokes.py``'s PT
  solver against ``solveMomentum`` at rtol 1e-9 (float64).
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from pbml_mantle_convection_tpu.sim import gaia_native as jnative  # noqa: E402
from pbml_mantle_convection_tpu.sim import ini as jini  # noqa: E402
from pbml_mantle_convection_tpu.sim import profiles as jprof  # noqa: E402

from pbml_mantle_convection_tpu_torch.ops.advect_kernel import (  # noqa: E402
    advect_diffuse_step_fused)
from pbml_mantle_convection_tpu_torch.physics.advection import (  # noqa: E402
    grid_metrics, viscous_dissipation)
from pbml_mantle_convection_tpu_torch.physics.stokes import PTStokesSolver  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim import gaia_native as tnative  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim import ini as tini  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim import profiles as tprof  # noqa: E402

INI_CASES = {
    "defaults": {},
    "iterative_cool_decay_di": dict(
        mode="ML_STOKES", raq=2.5, fkt=1e7, fkp=5.0, solver="iterative",
        urf=0.9, core_cool=True, radioactive_decay=True, Di=0.5),
    "small_grid": dict(mode="ML_STOKES", raq=2.0, fkt=1e7, fkp=3.0,
                       layers=30, aspect_ratio=2.0),
    "gaia_linear_cool": dict(mode="GAIA", raq=5.0, fkt=1e4, fkp=3.0,
                             initialization="linear", core_cool=True,
                             intervene_ts=3, warm_up_steps=2),
    "perfect_decay_profile": dict(initialization="perfect",
                                  radioactive_decay=True,
                                  profile_file="/some/dir/ml_prof.txt"),
}


@pytest.mark.parametrize("case", sorted(INI_CASES))
def test_create_ini_file_is_the_jax_file(tmp_path, case):
    kw = INI_CASES[case]
    create = {"jax": (jini.create_ini_file, jini.GaiaIniConfig),
              "port": (tini.create_ini_file, tini.GaiaIniConfig)}
    blobs = {}
    for name, (fn, cfg) in create.items():
        path = str(tmp_path / f"{name}.ini")
        fn(path, cfg(**kw))
        blobs[name] = open(path, "rb").read()
    assert blobs["port"] == blobs["jax"]


@pytest.mark.parametrize("case", sorted(INI_CASES))
@pytest.mark.parametrize("network", ["newfluidnet", "unet"])
def test_run_name_is_the_jax_name(case, network):
    kw = INI_CASES[case]
    assert (tini.run_name(tini.GaiaIniConfig(**kw), network=network,
                          extra="_x")
            == jini.run_name(jini.GaiaIniConfig(**kw), network=network,
                             extra="_x"))


@pytest.mark.parametrize("params", [([3.0], [1e8], [10.0]),
                                    ([0.5, 7.0], [1e7, 3e9], [3.0, 50.0])])
def test_profile_mlp_is_the_jax_one(tmp_path, params):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jy, jyp = jprof.calc_mlp_profile(*params, str(tmp_path / "jax"))
    ty, typ = tprof.calc_mlp_profile(*params, str(tmp_path / "port"))
    assert ty.shape == jy.shape == (len(params[0]), 128)
    np.testing.assert_array_equal(typ, jyp)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-15)
    assert (open(tmp_path / "port" / "ml_prof.txt", "rb").read()
            == open(tmp_path / "jax" / "ml_prof.txt", "rb").read())


def test_profile_asset_is_the_jax_asset():
    """The port's copy of the weights: the same arrays, and the port
    reads its own file, not the JAX package's."""
    assert os.path.dirname(tprof._ASSET) != os.path.dirname(jprof._ASSET)
    jm, tm = jprof.load_mlp(), tprof.load_mlp()
    assert len(tm) == len(jm) == 6
    for (tw, tb), (jw, jb) in zip(tm, jm):
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(tb, jb)
    assert (open(tprof._ASSET, "rb").read()
            == open(jprof._ASSET, "rb").read())


def _direct(mod, ini_path):
    sim = mod.Direct()
    sim.init1()
    sim.iniLoad("ini/default.ini")   # absent → ignored, like the reference
    sim.iniLoad(ini_path)
    sim.init2()
    return sim


def _ini(tmp_path, name="Gaia.ini", **kw):
    path = str(tmp_path / name)
    tini.create_ini_file(path, tini.GaiaIniConfig(**kw))
    return path


SMALL = dict(mode="ML_STOKES", raq=2.0, fkt=1e7, fkp=3.0, layers=30,
             aspect_ratio=2.0)


def test_native_library_is_the_ports_own_build(tmp_path):
    """Each binding owns its library: the port's lives in build/native/,
    and both load in one process."""
    tlib, jlib = tnative.load_library(), jnative.load_library()
    assert tlib._name != jlib._name
    assert os.path.dirname(tlib._name) == str(tnative.BUILD_DIR)
    sims = [_direct(m, _ini(tmp_path, **SMALL)) for m in (tnative, jnative)]
    assert sims[0].shape == sims[1].shape == (32, 62)


def test_native_state_contract(tmp_path):
    sim = _direct(tnative, _ini(tmp_path, **SMALL))
    state = sim.getState()
    H, W = sim.shape
    assert (H, W) == (32, 62)
    N = H * W
    assert state["T"].shape == (N,) and state["V"].shape == (N,)
    assert state["P"].shape == (N,)
    assert state["v"].shape == (N, 3) and state["pos"].shape == (N, 2)
    assert state["pos"][:, 0].max() == 2.0
    assert state["pos"][:, 1].max() == 1.0
    T = state["T"].reshape(H, W)
    assert np.allclose(T[0], 1.0) and np.allclose(T[-1], 0.0)
    # zero-copy views: writes reach the engine; raw.time is a setter
    state["v"][:, 0] = 0.0
    state["raw"].time = 5.0
    assert state["raw"].time == 5.0
    assert sim.getState()["v"] is state["v"]


def test_native_timesteps_bitwise_against_the_jax_binding(tmp_path):
    ini = _ini(tmp_path, **SMALL)
    sims = {"port": _direct(tnative, ini), "jax": _direct(jnative, ini)}
    H, W = sims["port"].shape
    rng = np.random.default_rng(0)
    u = rng.normal(size=(H, W)) * 10
    v = rng.normal(size=(H, W)) * 10
    dts = {}
    for name, sim in sims.items():
        state = sim.getState()
        state["v"][:, 0] = u.reshape(-1)
        state["v"][:, 1] = v.reshape(-1)
        dts[name] = [sim.doTimestep() for _ in range(10)]
    assert dts["port"] == dts["jax"] and min(dts["port"]) > 0
    for key in ("T", "V", "P", "v", "pos"):
        np.testing.assert_array_equal(sims["port"].getState()[key],
                                      sims["jax"].getState()[key],
                                      err_msg=key)
    assert (sims["port"].getState()["raw"].time
            == sims["jax"].getState()["raw"].time)


def _random_state(sim, seed):
    """Seeded velocities and a mid-range T (the engine's [0, 2] clip never
    triggers) written into the engine; returns (u, v, T0) as (H, W)."""
    state = sim.getState()
    H, W = sim.shape
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(H, W)) * 20
    v = rng.normal(size=(H, W)) * 20
    state["v"][:, 0] = u.reshape(-1)
    state["v"][:, 1] = v.reshape(-1)
    T0 = 0.3 + 0.4 * rng.random((H, W))
    T0[0], T0[-1] = 1.0, 0.0
    T0[:, 0], T0[:, -1] = T0[:, 1], T0[:, -2]
    state["T"][:] = T0.reshape(-1)
    return u, v, T0


def _native_metrics(sim, aspect):
    state = sim.getState()
    H, W = sim.shape
    xc = torch.tensor(state["pos"][:, 0].reshape(H, W).copy())
    yc = torch.tensor(state["pos"][:, 1].reshape(H, W).copy())
    return grid_metrics(xc, yc, aspect=aspect)


def test_energy_step_matches_native(tmp_path):
    """The port's energy step against the C++ one, same state, velocities
    and dt (the dt-override hook), 3 steps, metrics from the engine's own
    positions (tests/test_sim_aux.py::test_energy_step_matches_jax)."""
    sim = _direct(tnative, _ini(tmp_path, **SMALL))
    H, W = sim.shape
    u, v, T0 = _random_state(sim, 7)
    metrics = _native_metrics(sim, 2.0)
    dt = torch.tensor(2e-5, dtype=torch.float64)
    ut, vt = torch.tensor(u)[None], torch.tensor(v)[None]
    T = torch.tensor(T0)[None]
    for _ in range(3):
        sim.doTimestepDt(float(dt))
        T, _ = advect_diffuse_step_fused(ut, vt, T, 2.0, metrics, dt=dt)
    np.testing.assert_allclose(sim.getState()["T"].reshape(H, W),
                               T[0].numpy(), rtol=1e-12, atol=1e-14)


def test_eba_energy_step_matches_native(tmp_path):
    """Di > 0: the C++ EBA step (adiabatic -Di·v·T + viscous dissipation
    +Di·Φ) against the port's composition, src = RaQ - Di·v·T + Di·Φ with
    Φ from physics/advection.py::viscous_dissipation, on the pre-step FK
    viscosity (tests/test_sim_aux.py::test_eba_energy_step_matches_jax)."""
    sim = _direct(tnative, _ini(tmp_path, mode="ML_STOKES", raq=2.0,
                                fkt=1e5, fkp=3.0, layers=30,
                                aspect_ratio=2.0, Di=0.5))
    H, W = sim.shape
    state = sim.getState()
    u, v, T0 = _random_state(sim, 11)
    sim.updateViscosity()
    metrics = _native_metrics(sim, 2.0)
    Di, dt = 0.5, torch.tensor(2e-6, dtype=torch.float64)
    ut, vt = torch.tensor(u)[None], torch.tensor(v)[None]
    T = torch.tensor(T0)[None]
    for _ in range(3):
        V = torch.tensor(state["V"].reshape(H, W).copy())[None]
        sim.doTimestepDt(float(dt))
        src = (2.0 - Di * vt[..., 1:-1, 1:-1] * T[..., 1:-1, 1:-1]
               + Di * viscous_dissipation(ut, vt, V, metrics))
        T, _ = advect_diffuse_step_fused(ut, vt, T, src, metrics, dt=dt)
    np.testing.assert_allclose(state["T"].reshape(H, W), T[0].numpy(),
                               rtol=1e-12, atol=1e-14)


def test_pt_solver_matches_native_momentum(tmp_path):
    """physics/stokes.py's PT solver against the C++ urf_mm solve after the
    same 1500 iterations (tests/test_sim_aux.py::
    test_native_momentum_matches_jax_pt_solver)."""
    sim = _direct(tnative, _ini(tmp_path, mode="GAIA", raq=5.0, fkt=1e4,
                                fkp=3.0, layers=16, aspect_ratio=2.0,
                                solver="iterative", urf=1.0))
    H, W = sim.shape
    assert (H, W) == (18, 34)
    state = sim.getState()
    y = state["pos"][:, 1].reshape(H, W)
    x = state["pos"][:, 0].reshape(H, W)
    T0 = (1.0 - y) + 0.2 * np.exp(-((x - 0.75) ** 2 + (y - 0.4) ** 2) / 0.05)
    T0[0], T0[-1] = 1.0, 0.0
    state["T"][:] = T0.reshape(-1)
    sim.updateViscosity()
    V0 = state["V"].reshape(H, W).copy()
    n_iter = 1500
    sim.solveMomentum(n_iter)
    solver = PTStokesSolver(ny=H - 2, nx=W - 2, dy=1.0 / 16,
                            dx=2.0 / (W - 2), raq=5.0, n_iter=n_iter,
                            ptol=0.0)
    res = solver.solve(torch.tensor(T0[1:-1, 1:-1]),
                       torch.tensor(V0[1:-1, 1:-1]))
    for got, want in ((state["v"][:, 0], res.u), (state["v"][:, 1], res.v),
                      (state["P"], res.p)):
        np.testing.assert_allclose(got.reshape(H, W), want.numpy(),
                                   rtol=1e-9, atol=1e-12)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed g++ raises with the compiler's message; nothing falls
    back."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_SRC", str(bad))
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed"):
        tnative._build_lib()
