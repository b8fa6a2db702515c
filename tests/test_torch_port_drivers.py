"""The port's rollout drivers (sim/rollout.py) and rollout CLI against the
JAX package's, on the CPU.

1. ``rollout_torch`` vs ``rollout_jax``: a NewFluidNet (levels 2, c_h 8,
   repeats 1, learned padding) at 32×64 in float64, weights through
   utils/flax_convert.py; the port on its fused executor (the kernels'
   plain versions on the CPU, with the fused epilogue), JAX on its module
   path; 12 steps, ``snapshot_every=5``, ``timed_steps=3``: T_vec, t_vec
   and the snapshot fields at rtol 1e-10, the same pickle keys and
   lengths, and no torch object in any pickle.
2. ``rollout_native`` vs the JAX one, each on its own binding's
   ``Direct`` at 32×62, float64 surrogates: ML_STOKES, ML with
   ``intervene_ts=2``, GAIA (the engine's own momentum solve) and the
   U-Net, 4-6 steps, at rtol 1e-10.
3. The rollout CLI against the JAX CLI at 128×506 in float32, a tiny net
   (-l 2 -f 8 -r 1 -s 0) with the same weights through each package's
   ``--nn_dir``: equal run-directory names, byte-equal ``Gaia.ini`` and
   ``ml_prof.txt``, T_vec at rtol 1e-5 over 6 steps (t_vec at 1e-4:
   dt is set by max |v| of the float32 surrogate, which at this start
   each package's float32 step gives 5e-6 and 9e-6 off float64, while
   the float64 steps agree to 2e-14), with ``-pad
   replicate`` and with ``-pad learned --fast 0``; the port's ``--fast 1``
   (its executor's plain path; JAX's would be its Pallas executor in
   interpret mode, too slow here) against its own ``--fast 0`` at 1e-5;
   ``--engine native`` for 4 steps on both; the refusals (a Transolver
   rollout, which JAX's stepper fails too; no card without ``--device
   cpu``). The parser's default ``-s 1``, ``-net fluidnet`` and ``-net
   vit`` against the JAX CLI: tests/test_torch_port_cli_item6.py.
4. ROADMAP §3 fault 12: the port's ``--fast 1`` raised for NewFluidNets
   the JAX CLI runs. Now ``-f 32`` and ``-k 3`` (the module: the
   function JAX's executor computes on its standard path), ``-pp 1`` and
   ``-lt mae`` (the fused executor's other heads) run, each with its
   route line, against the JAX CLI's ``--fast 1`` at the tolerances of
   (3), the weights through each package's ``--nn_dir``.
"""

import os
import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.cli import rollout as jcli  # noqa: E402
from pbml_mantle_convection_tpu.constants import SimParams as JParams  # noqa: E402
from pbml_mantle_convection_tpu.models import NewFluidNet as JNewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu.models.registry import (  # noqa: E402
    ModelConfig as JConfig, build_model as j_build)
from pbml_mantle_convection_tpu.models.unet import Unet as JUnet  # noqa: E402
from pbml_mantle_convection_tpu.sim import gaia_native as jnative  # noqa: E402
from pbml_mantle_convection_tpu.sim.engine import SimEngine as JEngine  # noqa: E402
from pbml_mantle_convection_tpu.sim.grid import Grid as JGrid  # noqa: E402
from pbml_mantle_convection_tpu.sim.rollout import (  # noqa: E402
    rollout_jax, rollout_native as jrollout_native)
from pbml_mantle_convection_tpu.sim.stepper import TimeStepper as JStepper  # noqa: E402
from pbml_mantle_convection_tpu.utils.checkpoint import (  # noqa: E402
    save_checkpoint as jsave_checkpoint)

from pbml_mantle_convection_tpu_torch.cli import rollout as tcli  # noqa: E402
from pbml_mantle_convection_tpu_torch.constants import SimParams  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.fast_path import (  # noqa: E402
    FastNewFluidNet)
from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.unet import Unet  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim import gaia_native as tnative  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.grid import Grid  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.ini import (  # noqa: E402
    GaiaIniConfig, create_ini_file)
from pbml_mantle_convection_tpu_torch.sim.rollout import (  # noqa: E402
    rollout_native, rollout_torch)
from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper  # noqa: E402
from pbml_mantle_convection_tpu_torch.train.trainer import LOG_HEADER  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_pickle, save_checkpoint)
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)

PICKLES = ("snapshots", "T_vec", "t_vec", "TS_vec")


def _pickles(run_dir, mode):
    return {name: load_pickle(os.path.join(run_dir, f"{name}_{mode}.pkl"))
            for name in PICKLES}


def _no_torch(obj, where="pickle"):
    """Numpy arrays, numpy or Python scalars, lists and dicts only."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _no_torch(v, f"{where}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _no_torch(v, f"{where}[{i}]")
    else:
        assert isinstance(obj, (np.ndarray, np.generic, float, int)), \
            f"{where}: {type(obj)}"


def _jax_fluidnet(H, W, seed, dtype=jnp.float64, r_p="learned"):
    jm = JNewFluidNet(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu", r_p=r_p,
                      loss_type="curl", repeats=1, f=5, p_pred=False)
    w = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                         jnp.zeros((1, H, W, 7), dtype))
    return jm, jax.tree.map(np.asarray, w)


def _port_fluidnet(w, dtype=torch.float64, r_p="learned"):
    net = NewFluidNet(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu", r_p=r_p,
                      loss_type="curl", repeats=1, f=5, p_pred=False,
                      device="cpu", dtype=dtype)
    net.load_state_dict(from_jax_params(w))
    return net


def _initial_T(xc, yc):
    return np.clip(1.0 - yc + 0.05 * np.sin(3 * xc), 0, 1)[None]


def test_rollout_torch_matches_rollout_jax(tmp_path):
    H, W = 32, 64
    pp = (3.0, 1e8, 10.0)
    jm, w = _jax_fluidnet(H, W, 5)
    jgrid = JGrid(H=H, W=W)
    jst = JStepper(grid=jgrid, params=JParams(*pp),
                   apply_fn=lambda x: jm.apply(w, x), cn_max=0.99,
                   dtype=jnp.float64)
    jeng = JEngine(grid=jgrid, params=JParams(*pp), stepper=jst,
                   dtype=jnp.float64)
    grid = Grid(H=H, W=W)
    T0 = _initial_T(grid.xc, grid.yc)
    eng = SimEngine(TimeStepper(grid, SimParams(*pp),
                                FastNewFluidNet(_port_fluidnet(w), H, W),
                                cn_max=0.99, dtype=torch.float64,
                                device="cpu"))
    assert eng._epi is not None          # the fused epilogue path
    kw = dict(n_steps=12, mode="ML_STOKES", snapshot_every=5, timed_steps=3)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    js, jtr, jsn = rollout_jax(jeng, jnp.asarray(T0),
                               gaia_dir=str(tmp_path / "jax"), **kw)
    ts, ttr, tsn = rollout_torch(eng, torch.as_tensor(T0),
                                 gaia_dir=str(tmp_path / "port"), **kw)
    np.testing.assert_allclose(ts.T.numpy(), np.asarray(js.T), rtol=1e-10,
                               atol=1e-12)
    got = _pickles(tmp_path / "port", "ML_STOKES")
    want = _pickles(tmp_path / "jax", "ML_STOKES")
    _no_torch(got)
    for name in ("T_vec", "t_vec", "TS_vec"):
        assert len(got[name]) == len(want[name]) == 12, name
    np.testing.assert_allclose(got["T_vec"], want["T_vec"], rtol=1e-10)
    np.testing.assert_allclose(got["t_vec"], want["t_vec"], rtol=1e-10)
    assert set(got["snapshots"]) == set(want["snapshots"])
    # 3 timed steps, then chunks of 5 and 4: snapshots after steps 8, 12
    for var in ("v", "P", "T"):
        assert len(got["snapshots"][var]) == len(want["snapshots"][var]) == 2
        for a, b in zip(got["snapshots"][var], want["snapshots"][var]):
            b = np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype, var
            np.testing.assert_allclose(a, b, rtol=1e-10,
                                       atol=1e-10 * np.abs(b).max())
    for c in ("xcc", "ycc"):
        np.testing.assert_array_equal(got["snapshots"][c],
                                      np.asarray(want["snapshots"][c]))
    assert got["snapshots"]["v"][0].shape == (H * W, 3)
    assert not got["snapshots"]["v"][0][:, 2].any()
    assert all(isinstance(x, np.float64) for x in got["T_vec"])
    assert [type(x) for x in got["t_vec"]] == [type(x) for x in want["t_vec"]]


def test_rollout_torch_leaves_the_initial_state(tmp_path):
    """The warm-up step runs on the initial state and is thrown away: the
    first timed step starts from T0 (the trace's first time is one step's
    dt), and the run equals one multi_step of the same length."""
    H, W = 20, 28
    _, w = _jax_fluidnet(H, W, 3)
    grid = Grid(H=H, W=W)
    eng = SimEngine(TimeStepper(grid, SimParams(3.0, 1e8, 10.0),
                                FastNewFluidNet(_port_fluidnet(w), H, W),
                                cn_max=0.99, dtype=torch.float64,
                                device="cpu"))
    T0 = torch.as_tensor(_initial_T(grid.xc, grid.yc))
    T0_copy = T0.clone()
    s, tr, snaps = rollout_torch(eng, T0, 7, snapshot_every=3)
    assert torch.equal(T0, T0_copy)
    s1, tr1 = eng.multi_step(eng.init_state(T0), 7)
    assert torch.equal(s.T, s1.T) and torch.equal(tr.t, tr1.t)
    assert len(snaps["T"]) == 3      # chunks of 3, 3, 1


NATIVE_CASES = {
    "ML_STOKES": dict(mode="ML_STOKES", steps=5),
    "ML_intervene2": dict(mode="ML", steps=6, intervene_ts=2),
    "GAIA": dict(mode="GAIA", steps=4),
    "unet": dict(mode="ML_STOKES", steps=5, net="unet"),
}


def _native_pair(tmp_path, mode):
    ini = str(tmp_path / "Gaia.ini")
    create_ini_file(ini, GaiaIniConfig(mode=mode, raq=2.0, fkt=1e7, fkp=3.0,
                                       layers=30, aspect_ratio=2.0,
                                       initialization="linear"))
    sims = []
    for mod in (jnative, tnative):
        sim = mod.Direct()
        sim.init1()
        sim.iniLoad(ini)
        sim.init2()
        if mode == "GAIA":
            sim.setSolveMomentum(True)
        sims.append(sim)
    return sims


def _native_steppers(net, H, W, aspect):
    pp = (2.0, 1e7, 3.0)
    jgrid, grid = JGrid(H=H, W=W, aspect=aspect), Grid(H=H, W=W,
                                                       aspect=aspect)
    if net == "unet":
        jm = JUnet(levels=2, c_i=10, c_h=8, c_o=2, act_fn="gelu",
                   r_p="replicate", loss_type="curl", repeats=1, f=3,
                   p_pred=False)
        w = jax.tree.map(np.asarray, jax.jit(jm.init)(
            jax.random.PRNGKey(4), jnp.zeros((1, H, W, 10), jnp.float64)))
        tm = Unet(levels=2, c_i=10, c_h=8, c_o=2, act_fn="gelu",
                  r_p="replicate", loss_type="curl", repeats=1, f=3,
                  p_pred=False, device="cpu", dtype=torch.float64)
        tm.load_state_dict(from_jax_params(w))
    else:
        jm, w = _jax_fluidnet(H, W, 9)
        tm = _port_fluidnet(w)
    jst = JStepper(grid=jgrid, params=JParams(*pp),
                   apply_fn=lambda x: jm.apply(w, x), cn_max=0.99,
                   dtype=jnp.float64, net=net)
    tst = TimeStepper(grid, SimParams(*pp), tm, cn_max=0.99,
                      dtype=torch.float64, device="cpu", net=net)
    return jst, tst


@pytest.mark.parametrize("case", sorted(NATIVE_CASES))
def test_rollout_native_matches_jax(tmp_path, case):
    c = NATIVE_CASES[case]
    jsim, tsim = _native_pair(tmp_path, c["mode"])
    H, W = tsim.shape
    if c["mode"] == "GAIA":
        jst = tst = None
    else:
        jst, tst = _native_steppers(c.get("net", "newfluidnet"), H, W, 2.0)
    kw = dict(mode=c["mode"], intervene_ts=c.get("intervene_ts", 1),
              max_steps=c["steps"], save_steps=400, write_steps=400)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jout = jrollout_native(jsim, jst, gaia_dir=str(tmp_path / "jax"), **kw)
    tout = rollout_native(tsim, tst, gaia_dir=str(tmp_path / "port"), **kw)
    assert tout[1] == jout[1] == c["steps"]
    np.testing.assert_allclose(tout[0], jout[0], rtol=1e-10)
    for got, want in zip(tout[3:5], jout[3:5]):          # T_vec, t_vec
        assert len(got) == len(want) == c["steps"] + 1
        np.testing.assert_allclose(got, want, rtol=1e-10)
    for var in ("v", "P", "T"):
        assert len(tout[2][var]) == len(jout[2][var])
        for a, b in zip(tout[2][var], jout[2][var]):
            np.testing.assert_allclose(a, b, rtol=1e-10,
                                       atol=1e-10 * max(np.abs(b).max(), 1))
    for key in ("T", "v", "V", "P"):
        np.testing.assert_allclose(tsim.getState()[key],
                                   jsim.getState()[key], rtol=1e-10,
                                   atol=1e-10 * max(np.abs(
                                       jsim.getState()[key]).max(), 1))
    got = _pickles(tmp_path / "port", c["mode"])
    _no_torch(got)
    assert set(got["snapshots"]) == set(
        _pickles(tmp_path / "jax", c["mode"])["snapshots"])


# --------------------------------------------------------------- the CLI

TINY = ["-raq", "3.0", "-fkt", "1e8", "-fkp", "10", "-l", "2", "-f", "8",
        "-r", "1", "-s", "0", "-init", "perfect"]


@pytest.fixture(scope="module")
def nn_dirs(tmp_path_factory):
    """The same tiny-net weights as a JAX Trainer checkpoint and as a port
    Trainer checkpoint, each beside a two-epoch loss log (so both CLIs
    pick epoch 0), for each padding."""
    root = tmp_path_factory.mktemp("nn")
    log = LOG_HEADER + "".join(f"{e},[0.5, 0.4],[0.6, 0.5],0.001\n"
                               for e in range(2))
    dirs = {}
    for r_p in ("replicate", "learned"):
        # (the weights' shapes do not depend on the grid)
        _, w = _jax_fluidnet(16, 24, 11, jnp.float32, r_p=r_p)
        for pkg in ("jax", "port"):
            d = root / f"{pkg}_{r_p}"
            d.mkdir()
            (d / "fluidnet_uvpT.txt").write_text(log)
            ckpt = str(d / "0_fluidnet_uvp.ckpt")
            if pkg == "jax":
                jsave_checkpoint(ckpt, {"params": w, "epoch": 0})
            else:
                save_checkpoint(ckpt, {"model": from_jax_params(w),
                                       "epoch": 0})
            dirs[pkg, r_p] = str(d)
    return dirs


def _run_cli(main, cwd, argv, monkeypatch):
    """``main(argv)`` from ``cwd`` with the relative ``--out_dir runs``:
    Gaia.ini names the profile by its path, so runs from different
    directories compare byte for byte. Returns (its result, the run
    directory)."""
    os.makedirs(cwd, exist_ok=True)
    monkeypatch.chdir(cwd)
    out = main(argv + ["--out_dir", "runs"])
    runs = os.listdir(os.path.join(cwd, "runs"))
    assert len(runs) == 1
    return out, os.path.join(cwd, "runs", runs[0])


@pytest.mark.parametrize("r_p", ["replicate", "learned"])
def test_rollout_cli_matches_the_jax_cli(tmp_path, nn_dirs, r_p,
                                         monkeypatch):
    argv = TINY + ["-m", "ML_STOKES", "-pad", r_p, "--max_steps", "6"]
    _, jrun = _run_cli(jcli.main, str(tmp_path / "jax"),
                       argv + ["--fast", "0", "--engine", "jax",
                               "--nn_dir", nn_dirs["jax", r_p]],
                       monkeypatch)
    runs = {}
    for fast in ("0", "1"):
        _, runs[fast] = _run_cli(
            tcli.main, str(tmp_path / f"port{fast}"),
            argv + ["--fast", fast, "--device", "cpu",
                    "--nn_dir", nn_dirs["port", r_p]], monkeypatch)
    trun = runs["0"]
    assert os.path.basename(trun) == os.path.basename(jrun)
    for f in ("Gaia.ini", "ml_prof.txt"):
        with open(os.path.join(trun, f), "rb") as a, \
                open(os.path.join(jrun, f), "rb") as b:
            assert a.read() == b.read(), f
    got, want = _pickles(trun, "ML_STOKES"), _pickles(jrun, "ML_STOKES")
    _no_torch(got)
    assert len(got["T_vec"]) == len(want["T_vec"]) == 6
    assert all(type(x) is np.float32 for x in got["T_vec"])
    assert [type(x) for x in got["T_vec"]] == [type(x)
                                               for x in want["T_vec"]]
    assert set(got["snapshots"]) == set(want["snapshots"])
    np.testing.assert_allclose(got["T_vec"], want["T_vec"], rtol=1e-5)
    np.testing.assert_allclose(got["t_vec"], want["t_vec"], rtol=1e-4)
    fast = _pickles(runs["1"], "ML_STOKES")
    np.testing.assert_allclose(fast["T_vec"], got["T_vec"], rtol=1e-5)
    np.testing.assert_allclose(fast["t_vec"], got["t_vec"], rtol=1e-4)


# fault 12: flags the port's --fast 1 refused, the route each takes, and
# the network's (c_h, k, loss_type, p_pred)
FAULT12 = {
    "f32": (["-f", "32"], "module", (32, 5, "curl", False)),
    "k3": (["-k", "3"], "module", (8, 3, "curl", False)),
    "pp1": (["-pp", "1"], "fused executor", (8, 5, "curl", True)),
    "mae": (["-lt", "mae"], "fused executor", (8, 5, "mae", False)),
}


def _write_nn_dir(d, weights, jax_ckpt):
    """A Trainer directory with a two-epoch loss log (epoch 0 is the
    best) and ``weights`` as epoch 0's checkpoint of one package."""
    d.mkdir()
    (d / "fluidnet_uvpT.txt").write_text(
        LOG_HEADER + "".join(f"{e},[0.5, 0.4],[0.6, 0.5],0.001\n"
                             for e in range(2)))
    ckpt = str(d / "0_fluidnet_uvp.ckpt")
    if jax_ckpt:
        jsave_checkpoint(ckpt, {"params": weights, "epoch": 0})
    else:
        save_checkpoint(ckpt, {"model": from_jax_params(weights),
                               "epoch": 0})


@pytest.mark.parametrize("case", sorted(FAULT12))
def test_rollout_cli_fast_runs_what_jax_runs(tmp_path, case, monkeypatch,
                                             capsys):
    flags, route, (c_h, k, loss_type, p_pred) = FAULT12[case]
    jm = j_build(JConfig(network="newfluidnet", levels=2, c_h=c_h,
                         repeats=1, kernel=k, loss_type=loss_type,
                         p_pred=p_pred, r_p="learned", dtype=jnp.float32))
    w = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(13), jnp.zeros((1, 16, 24, 7), jnp.float32)))
    _write_nn_dir(tmp_path / "nn_jax", w, True)
    _write_nn_dir(tmp_path / "nn_port", w, False)
    argv = [a for a in TINY if a not in ("-f", "8")] + flags + [
        "-m", "ML_STOKES", "-pad", "learned", "--max_steps", "6",
        "--fast", "1"]
    if "-f" not in flags:
        argv += ["-f", "8"]
    _, jrun = _run_cli(jcli.main, str(tmp_path / "jax"),
                       argv + ["--engine", "jax", "--nn_dir",
                               str(tmp_path / "nn_jax")], monkeypatch)
    capsys.readouterr()
    _, trun = _run_cli(tcli.main, str(tmp_path / "port"),
                       argv + ["--device", "cpu", "--nn_dir",
                               str(tmp_path / "nn_port")], monkeypatch)
    routes = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("route: ")]
    assert len(routes) == 1 and routes[0].startswith(f"route: {route}"), \
        routes
    assert os.path.basename(trun) == os.path.basename(jrun)
    got, want = _pickles(trun, "ML_STOKES"), _pickles(jrun, "ML_STOKES")
    _no_torch(got)
    assert len(got["T_vec"]) == len(want["T_vec"]) == 6
    np.testing.assert_allclose(got["T_vec"], want["T_vec"], rtol=1e-5)
    np.testing.assert_allclose(got["t_vec"], want["t_vec"], rtol=1e-4)
    assert set(got["snapshots"]) == set(want["snapshots"])
    # the pressure JAX records is the port's: the network's p with
    # p_pred, the state's zeros without
    for a, b in zip(got["snapshots"]["P"], want["snapshots"]["P"]):
        b = np.asarray(b)
        assert bool(np.abs(b).max() > 0) == p_pred
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * max(np.abs(b).max(), 1e-30))


def test_rollout_cli_native_matches_the_jax_cli(tmp_path, nn_dirs,
                                                monkeypatch):
    argv = TINY + ["-m", "ML_STOKES", "-pad", "replicate", "--engine",
                   "native", "--max_steps", "4"]
    jout, jrun = _run_cli(jcli.main, str(tmp_path / "jax"),
                          argv + ["--nn_dir", nn_dirs["jax", "replicate"]],
                          monkeypatch)
    tout, trun = _run_cli(tcli.main, str(tmp_path / "port"),
                          argv + ["--device", "cpu", "--nn_dir",
                                  nn_dirs["port", "replicate"]],
                          monkeypatch)
    assert os.path.basename(trun) == os.path.basename(jrun)
    assert tout[1] == jout[1] == 4
    np.testing.assert_allclose(tout[3], jout[3], rtol=1e-5)   # T_vec
    np.testing.assert_allclose(tout[4], jout[4], rtol=1e-4)   # t_vec
    _no_torch(_pickles(trun, "ML_STOKES"))


@pytest.mark.parametrize("flags", [
    ["-s", "0", "-net", "transolver_structured"],
    ["-s", "0", "-net", "transolver"]],
    ids=["transolver_structured", "transolver"])
def test_rollout_cli_refuses_what_is_not_ported(tmp_path, flags):
    """A Transolver rollout fails in JAX too (its stepper hands the
    network an image where a Transolver reads points): the port refuses
    with that reason before anything is written."""
    argv = ["-m", "ML_STOKES", "-raq", "3.0", "-fkt", "1e8", "-fkp", "10",
            "--device", "cpu", "--max_steps", "1",
            "--out_dir", str(tmp_path)] + flags
    with pytest.raises(ValueError, match="Transolver reads"):
        tcli.main(argv)
    assert os.listdir(tmp_path) == []        # nothing written


def test_rollout_cli_needs_a_card_or_the_cpu_flag(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        tcli.main(["-m", "GAIA", "-raq", "3.0", "-fkt", "1e8", "-fkp", "10",
                   "--max_steps", "1", "--out_dir", str(tmp_path)])


def test_rollout_cli_parser_is_the_jax_parser():
    """Every flag and default of the JAX parser; the engine choices are
    {torch, native} (JAX: {jax, native}), plus --device."""
    req = ["-raq", "1", "-fkt", "1", "-fkp", "1"]
    j = vars(jcli.build_parser().parse_args(req))
    t = vars(tcli.build_parser().parse_args(req))
    assert t.pop("device") == "cuda"
    assert (t.pop("engine"), j.pop("engine")) == ("torch", "jax")
    assert t == j
    eng = next(a for a in tcli.build_parser()._actions if a.dest == "engine")
    assert eng.choices == ["torch", "native"]


def test_rollout_cli_pickles_read_without_torch(tmp_path, monkeypatch):
    """A pickle of the port's CLI unpickles in a process that has no torch
    module at all (the JAX package's analysis CLI, the notebooks)."""
    import subprocess
    import sys
    _, run = _run_cli(tcli.main, str(tmp_path), TINY + [
        "-m", "ML_STOKES", "-pad", "replicate", "--max_steps", "2",
        "--device", "cpu"], monkeypatch)
    code = ("import sys, pickle; sys.modules['torch'] = None\n"
            "for n in sys.argv[1:]:\n"
            "    pickle.load(open(n, 'rb'))\n")
    files = [os.path.join(run, f"{n}_ML_STOKES.pkl") for n in PICKLES]
    subprocess.run([sys.executable, "-c", code, *files], check=True)
    with open(files[0], "rb") as f:
        assert isinstance(pickle.load(f)["T"][0], np.ndarray)
