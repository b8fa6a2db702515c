"""The port's analysis CLI, evaluation and profiling utilities and the
reference-checkpoint bridge against the JAX package's, on the CPU.

* ``utils/evaluation.py``: each function against JAX's on seeded inputs,
  exact (both numpy), but ``model_error_sweep`` (the two packages'
  float64 forwards over their datasets built from one synthetic store) at
  1e-9;
* ``cli/analyze.py``: the rows and the ``--json`` file equal to JAX's on
  the fake runs of tests/test_cli.py; ``--figures`` where matplotlib is
  installed;
* ``utils/profiling.py``: ``trace`` (a Chrome trace file);
* ``utils/torch_convert.py``: reference-named state_dicts built here from
  the name map (seeded values) for NewFluidNet (learned, zero and
  replicate padding), the U-Net and TransolverStructured2D: equal to
  ``from_jax_params`` of the JAX converter's tree, loaded with
  ``strict=True``, a float64 forward equal to the JAX model's at 1e-9;
  so are symmetric and spectral convs, and a NewFluidNet checkpoint loads
  into a FluidNet (the same names); the HalfNewFluidNet and the ensemble,
  classes the reference lost, raise.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.cli import analyze as janalyze  # noqa: E402
from pbml_mantle_convection_tpu.constants import SimParams as JParams  # noqa: E402
from pbml_mantle_convection_tpu.data import dataset as jd  # noqa: E402
from pbml_mantle_convection_tpu.data import synthetic as jsyn  # noqa: E402
from pbml_mantle_convection_tpu.models import NewFluidNet as JNewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu.models import transolver as jt  # noqa: E402
from pbml_mantle_convection_tpu.models.unet import Unet as JUnet  # noqa: E402
from pbml_mantle_convection_tpu.utils import evaluation as jev  # noqa: E402
from pbml_mantle_convection_tpu.utils import torch_convert as jconv  # noqa: E402

from pbml_mantle_convection_tpu_torch.cli import analyze as tanalyze  # noqa: E402
from pbml_mantle_convection_tpu_torch.constants import SimParams  # noqa: E402
from pbml_mantle_convection_tpu_torch.data import dataset as td  # noqa: E402
from pbml_mantle_convection_tpu_torch.data import synthetic as tsyn  # noqa: E402
from pbml_mantle_convection_tpu_torch.models import transolver as tt  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.fluidnet import (  # noqa: E402
    FluidNet, NewFluidNet)
from pbml_mantle_convection_tpu_torch.models.unet import Unet  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils import evaluation as tev  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils import torch_convert as tconv  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)
from pbml_mantle_convection_tpu_torch.utils.profiling import trace  # noqa: E402

F64 = torch.float64


# ------------------------------------------------------------ evaluation

def _fields(seed, shape=(2, 12, 20)):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape), rng.normal(size=shape)


@pytest.mark.parametrize("seed", [0, 1])
def test_field_metrics_are_the_jax_ones(seed):
    a, b = _fields(seed)
    assert tev.field_mae(a, b) == jev.field_mae(a, b)
    assert tev.field_mae(torch.tensor(a), torch.tensor(b)) == \
        jev.field_mae(a, b)
    assert tev.pearson(a, a + 0.3 * b) == jev.pearson(a, a + 0.3 * b)
    assert tev.pearson(a, np.ones_like(a)) == jev.pearson(
        a, np.ones_like(a)) == 0.0
    assert tev.temperature_rmse(a, b) == jev.temperature_rmse(a, b)
    assert tev.temperature_rmse(a.astype(np.float32), b) == \
        jev.temperature_rmse(a.astype(np.float32), b)


@pytest.mark.parametrize("seed", [0, 1])
def test_compare_rollouts_is_the_jax_one(seed):
    rng = np.random.default_rng(seed)
    t_a = np.cumsum(rng.random(50) * 1e-3)
    t_b = np.cumsum(rng.random(70) * 8e-4)
    T_a = 0.5 + 0.01 * np.sin(t_a * 100)
    T_b = 0.5 + 0.01 * np.sin(t_b * 100 + 0.1)
    got = tev.compare_rollouts(t_a, T_a, t_b, T_b, n_points=64)
    assert got == jev.compare_rollouts(t_a, T_a, t_b, T_b, n_points=64)


def test_speedup_table_is_the_jax_one():
    rng = np.random.default_rng(2)
    ts = {"GAIA": list(rng.random(30) + 1.0),
          "ML_STOKES": list(rng.random(40) * 0.01),
          "ML_PRE": list(rng.random(10) * 0.1)}
    assert tev.speedup_table(ts) == jev.speedup_table(ts)
    del ts["GAIA"]
    assert tev.speedup_table(ts) == jev.speedup_table(ts)


def test_model_error_sweep_is_the_jax_one():
    params = [(3.0, 1e8, 10.0), (1.0, 1e7, 3.0)]
    jstore = jsyn.synthetic_store(params_list=[JParams(*p) for p in params],
                                  n_snapshots=6, seed=0)
    tstore = tsyn.synthetic_store(params_list=[SimParams(*p)
                                               for p in params],
                                  n_snapshots=6, seed=0)
    jds = jd.SnapshotDataset(jstore, dtype=jnp.float64)
    tds = td.SnapshotDataset(tstore, dtype=F64, device="cpu")
    H, W = jstore.T.shape[-2:]
    jm = JNewFluidNet(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu",
                      r_p="learned", loss_type="curl", repeats=1, f=5,
                      p_pred=False)
    w = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, H, W, 7), jnp.float64)))
    tm = NewFluidNet(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu",
                     r_p="learned", loss_type="curl", repeats=1, f=5,
                     p_pred=False, device="cpu", dtype=F64)
    tm.load_state_dict(from_jax_params(w))
    fwd = jax.jit(lambda x: jm.apply(w, x))
    want = jev.model_error_sweep(fwd, jds, batch_size=4, max_batches=2,
                                 rng=np.random.default_rng(5))
    got = tev.model_error_sweep(tm, tds, batch_size=4, max_batches=2,
                                rng=np.random.default_rng(5))
    assert set(got) == set(want) == {"u", "v", "p"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-12)
    assert got["u"] > 0


def test_inference_latency_times_the_forward():
    calls = []

    def fwd(x):
        calls.append(1)
        return x * 2

    s = tev.inference_latency(fwd, torch.ones(4), iters=7)
    assert len(calls) == 8 and 0 < s < 1      # one warm-up + 7 timed


# --------------------------------------------------------------- profiling

def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(None):
        pass
    assert os.listdir(tmp_path) == []
    d = tmp_path / "trace"
    with trace(str(d)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.load(open(d / files[0]))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


# ------------------------------------------------------------ analyze CLI

def _fake_run(path, mode, H=12, W=20, n_steps=30, n_snaps=3, seed=0,
              dt_wall=0.01, drift=0.0):
    """Write a sim/rollout.py-layout pickle set (advect_wi_gaia.py:
    654-668) with a smooth synthetic temperature history (copied from
    tests/test_cli.py)."""
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    y = (np.arange(H) + 0.5) / H
    x = (np.arange(W) + 0.5) / W * 4
    yy, xx = np.meshgrid(y, x, indexing="ij")
    snaps = {"v": [], "P": [], "T": [],
             "xcc": xx, "ycc": yy}
    for s in range(n_snaps):
        T = np.clip(1 - yy + 0.1 * np.sin(3 * xx + s) + drift, 0, 1)
        snaps["T"].append(T.reshape(-1))
        snaps["P"].append(rng.normal(size=H * W))
        u = rng.normal(size=(H * W, 1))
        snaps["v"].append(np.concatenate(
            [u, rng.normal(size=(H * W, 1)), np.zeros_like(u)], axis=1))
    t_vec = np.linspace(0, 1.0, n_steps)
    T_vec = 0.5 + 0.01 * np.sin(t_vec) + drift
    TS_vec = np.full(n_steps, dt_wall)
    for name, obj in [("snapshots", snaps), ("t_vec", list(t_vec)),
                      ("T_vec", list(T_vec)), ("TS_vec", list(TS_vec))]:
        with open(os.path.join(path, f"{name}_{mode}.pkl"), "wb") as f:
            pickle.dump(obj, f)


def _fake_runs(tmp_path):
    _fake_run(str(tmp_path / "gaia"), "GAIA", dt_wall=0.10)
    _fake_run(str(tmp_path / "ml"), "ML_STOKES", dt_wall=0.01,
              drift=0.002, seed=1)
    _fake_run(str(tmp_path / "pre"), "ML_PRE", dt_wall=0.03,
              drift=-0.01, seed=2, n_steps=20)
    return [str(tmp_path / n) for n in ("gaia", "ml", "pre")]


@pytest.mark.parametrize("extra", [[], ["--snap-index", "0"],
                                   ["--truth", "ml"]],
                         ids=["default", "snap0", "truth"])
def test_analyze_rows_are_the_jax_rows(tmp_path, capsys, extra):
    runs = _fake_runs(tmp_path)
    extra = [str(tmp_path / e) if e == "ml" else e for e in extra]
    outs, rows = {}, {}
    for name, mod in (("jax", janalyze), ("port", tanalyze)):
        js = str(tmp_path / f"{name}.json")
        rows[name] = mod.main(runs + extra + ["--json", js])
        outs[name] = capsys.readouterr().out
        rows[name + "_json"] = json.load(open(js))
    assert rows["port"] == rows["jax"]
    assert rows["port_json"] == rows["jax_json"]
    assert outs["port"] == outs["jax"]
    assert "Pearson(T)" in outs["port"]
    assert len(rows["port"]) == 3


def test_analyze_helpers_are_the_jax_ones(tmp_path):
    runs = _fake_runs(tmp_path)
    t_run, j_run = tanalyze.load_run(runs[1]), janalyze.load_run(runs[1])
    for k in ("t", "T", "TS"):
        np.testing.assert_array_equal(t_run[k], j_run[k])
    z = tanalyze._field(t_run["snapshots"], -1)
    for a, b in zip(tanalyze.profile(z), janalyze.profile(z)):
        np.testing.assert_array_equal(a, b)
    truth = tanalyze.load_run(runs[0])
    assert tanalyze.compare(t_run, truth) == janalyze.compare(
        j_run, janalyze.load_run(runs[0]))
    with pytest.raises(ValueError, match="--mode"):
        _fake_run(runs[1], "ML_PRE")
        tanalyze.load_run(runs[1])


def test_analyze_figures(tmp_path):
    pytest.importorskip("matplotlib")
    runs = _fake_runs(tmp_path)
    fig_dir = tmp_path / "figs"
    tanalyze.main(runs + ["--figures", str(fig_dir)])
    names = sorted(os.listdir(fig_dir))
    assert "mean_T_trace.png" in names and "profiles.png" in names
    assert "snapshot_gaia.png" in names and "snapshot_ml.png" in names


# ---------------------------------------------------------- torch_convert

def _ref_fluid(prefix):
    """Port FluidLayer prefix → reference prefix (the name map)."""
    return {"conv": f"{prefix}.layers.0", "gn": f"{prefix}.layers.1"}


def _ref_name_fluidnet(k):
    head, rest = k.split(".", 1)
    if head == "conv_0" or head.startswith("convs_"):
        ref = ("conv.0" if head == "conv_0"
               else "convs." + ".".join(head.split("_")[1:]))
        sub, tail = rest.split(".", 1)
        return f"{_ref_fluid(ref)[sub]}.{tail}"
    if head == "gn_0":
        return f"gn.0.{rest}"
    return f"conv.{head[-1]}.{rest}"                    # conv_1|2|3


def _ref_name_unet(k, repeats):
    head, rest = k.split(".", 1)
    merges = {"conv_m3": f"conv.{repeats}", "conv_m2": f"conv.{repeats + 1}",
              "conv_m1": f"conv.{repeats + 2}", "gn_0": "gn.0"}
    if head in merges:
        return f"{merges[head]}.{rest}"
    name, *idx = head.split("_")
    sub, tail = rest.split(".", 1)
    return f"{_ref_fluid(name + '.' + '.'.join(idx))[sub]}.{tail}"


def _ref_name_transolver(k):
    name = "." + k + "."
    for a, b in ((".to_out.", ".to_out.0."),
                 (".linear_pre.", ".linear_pre.0.")):
        name = name.replace(a, b)
    if name.startswith(".blocks_"):
        name = ".blocks." + name[len(".blocks_"):]
    return name[1:-1]


def _reference_sd(tm, rename, seed):
    """A seeded reference-format state_dict for the port module ``tm``:
    its names through ``rename``, BLC learnable biases as (1, C, 1, 1),
    temperatures positive."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in tm.state_dict().items():
        a = rng.normal(size=tuple(v.shape)) * 0.3
        if k.endswith("learnable_bias"):
            a = a.reshape(1, -1, 1, 1)
        if k.endswith("temperature"):
            a = 0.5 + np.abs(a)
        sd[rename(k)] = torch.tensor(a)
    return sd


def _check_bridge(sd, tm, jm, jtree, x, port_sd):
    """port_sd against from_jax_params(jtree), strict load, forwards."""
    want = from_jax_params(jax.tree.map(np.asarray, jtree))
    assert set(port_sd) == set(want)
    for k in want:
        assert port_sd[k].shape == want[k].shape, k
        np.testing.assert_array_equal(port_sd[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    tm.load_state_dict(port_sd, strict=True)
    with torch.no_grad():
        got = tm(torch.as_tensor(x))
    ref = jm.apply(jtree, jnp.asarray(x))
    for a, b in zip(got, ref):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-9)


def _np_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("r_p", ["learned", "zeros", "replicate"])
def test_convert_fluidnet(r_p):
    H, W = 16, 24
    kw = dict(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu", r_p=r_p,
              loss_type="curl", repeats=2, f=5, p_pred=False)
    tm = NewFluidNet(**kw, device="cpu", dtype=F64)
    sd = _reference_sd(tm, _ref_name_fluidnet, 1)
    jtree = jconv.convert_fluidnet(_np_sd(sd), 2, 2)
    x = np.random.default_rng(2).random((1, H, W, 7))
    _check_bridge(sd, tm, JNewFluidNet(**kw), jtree, x,
                  tconv.convert_fluidnet(sd, 2, 2))


@pytest.mark.parametrize("levels", [2, 3])
def test_convert_unet(levels):
    H, W = 16, 24
    kw = dict(levels=levels, c_i=10, c_h=8, c_o=2, act_fn="gelu",
              r_p="replicate", loss_type="curl", repeats=2, f=3,
              p_pred=False)
    tm = Unet(**kw, device="cpu", dtype=F64)
    sd = _reference_sd(tm, lambda k: _ref_name_unet(k, 2), 3)
    jtree = jconv.convert_unet(_np_sd(sd), levels, 2)
    x = np.random.default_rng(4).random((1, H, W, 10))
    _check_bridge(sd, tm, JUnet(**kw), jtree, x,
                  tconv.convert_unet(sd, levels, 2))


def test_convert_transolver_structured():
    H, W = 16, 24
    kw = dict(H=H, W=W, fun_dim=5, n_layers=2, n_hidden=16, n_head=2,
              slice_num=4, out_dim=1, p_pred=False)
    tm = tt.TransolverStructured2D(**kw, device="cpu", dtype=F64)
    sd = _reference_sd(tm, _ref_name_transolver, 5)
    jtree = jconv.convert_transolver(_np_sd(sd), 2)
    x = np.random.default_rng(6).normal(size=(2, H * W, 7))
    _check_bridge(sd, tm, jt.TransolverStructured2D(**kw), jtree, x,
                  tconv.convert_transolver(sd, 2))


def test_load_reference_checkpoint(tmp_path):
    """A reference ``.pt`` file read with ``weights_only`` into the
    port's model."""
    kw = dict(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu", r_p="learned",
              loss_type="curl", repeats=1, f=5, p_pred=False)
    tm = NewFluidNet(**kw, device="cpu", dtype=F64)
    sd = _reference_sd(tm, _ref_name_fluidnet, 7)
    path = str(tmp_path / "3_fluidnet_uvp.pt")
    torch.save(sd, path)
    got = tconv.load_reference_checkpoint(path, "newfluidnet", 2, 1)
    tm.load_state_dict(got, strict=True)
    np.testing.assert_array_equal(
        tm.conv_0.conv.learnable_bias.detach().numpy(),
        sd["conv.0.layers.0.learnable_bias"].numpy().reshape(-1))
    # the FluidNet's reference names are NewFluidNet's, and its learned
    # merge-1 (bc = 2) has kernels of the same shapes: the checkpoint
    # loads into it strictly (the ViT's reading: tests/
    # test_torch_port_models_item6.py)
    fm = FluidNet(**kw, device="cpu", dtype=F64)
    fm.load_state_dict(tconv.load_reference_checkpoint(path, "fluidnet",
                                                       2, 1), strict=True)
    assert torch.equal(fm.conv_1.conv.weight, tm.conv_1.conv.weight)
    for net in ("halfnewfluidnet", "multiscalenewfluidnet"):
        with pytest.raises(NotImplementedError, match="reference lost"):
            tconv.load_reference_checkpoint(path, net, 2, 1)
    with pytest.raises(NotImplementedError, match="ConvAE"):
        tconv.load_reference_checkpoint(path, "convae", 2, 1)


def _complex_spectral(sd):
    """The reference's SpectralConv2d holds complex ``weights1|2``."""
    out = {}
    for k, v in sd.items():
        if k.endswith("_imag"):
            continue
        if k.endswith("_real"):
            k, v = k[:-5], torch.complex(v, sd[k[:-5] + "_imag"])
        out[k] = v
    return out


@pytest.mark.parametrize("kind", ["symmetric", "symmetric_learned",
                                  "spectral"])
def test_convert_takes_symmetric_and_spectral_convs(kind):
    """A symmetric conv's unique filters go straight across (plain and
    learned-boundary layers), a spectral conv's complex weights split into
    real and imaginary parts: equal to ``from_jax_params`` of the JAX
    converter's tree, a strict load, the forward equal to the Flax
    model's at 1e-9."""
    H, W = 16, 24
    kw = dict(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu", repeats=1, f=5,
              loss_type="curl", p_pred=False,
              **{"symmetric": dict(r_p="replicate", use_symm=True),
                 "symmetric_learned": dict(r_p="learned", use_symm=True),
                 "spectral": dict(r_p="zeros",
                                  spectral_conv=True)}[kind])
    tm = NewFluidNet(**kw, device="cpu", dtype=F64)
    sd = _complex_spectral(_reference_sd(tm, _ref_name_fluidnet, 8))
    if kind != "spectral":
        assert sd["convs.1.0.layers.0.weight" if kind == "symmetric"
                  else "conv.2.conv_top.weight"].shape[0] == 7  # of 8
    jtree = jconv.convert_fluidnet(_np_sd(sd), 2, 1)
    x = np.random.default_rng(2).random((1, H, W, 7))
    _check_bridge(sd, tm, JNewFluidNet(**kw), jtree, x,
                  tconv.convert_fluidnet(sd, 2, 1))
