"""The port's study tools against the JAX package's, on the CPU: the
speedup study and the interleave fidelity tool, and the reference-scale
study's choice of parameter triples. (The reference-scale training and the
HBM-scale epoch: tests/test_torch_port_studies_training.py.)

1. ``tools/torch_port_speedup_study.py`` vs ``tools/speedup_study.py`` at
   18×26, 8 steps, 4 train batches, 200 PT iterations, float64, the
   surrogate's initial weights JAX's (``from_jax_params``): the ground
   truth's vigor figures and the GAIA-skip10 row's T-RMSE, Pearson r and
   trace RMSE at rtol 1e-10 (the trace RMSE, 2.5e-6 here, also within
   1e-14 absolute: it is a difference of mean temperatures near 0.5);
   the trained ML_STOKES and ML_PRE rows at rtol 1e-6; the final train
   loss to JAX's five printed decimals. Wall times are not compared.
2. ``tools/torch_port_interleave_fidelity.py`` vs
   ``tools/interleave_fidelity.py`` at ``--layers 14 --ar 2 --steps 12``
   (a 16×30 grid, so the surrogate is cut to ``--levels 2 --c_h 8
   --repeats 2``: the flagship's 5 levels need 6 pixels in the deepest
   branch), float32, JAX's seed-3 weights: legs B and C's trace RMSE and
   maximum deviation from leg A within 1e-6 absolute (measured ≤ 3e-8:
   float32 mean temperatures near 0.5), the legs' end times at rtol 1e-5
   (measured 1.4e-7); ``--weights`` reads a port checkpoint.
3. ``real_paras`` of the reference-scale tools on one sims.pt file: the
   same triples and ids, and None where too few simulations pass.
"""

import importlib.util
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.models import NewFluidNet as JNewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.checkpoint import (  # noqa: E402
    save_checkpoint)
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)

ROOT = Path(__file__).resolve().parents[1]


def _load(rel):
    spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jspeed = _load("tools/speedup_study.py")
tspeed = _load("tools/torch_port_speedup_study.py")
jinter = _load("tools/interleave_fidelity.py")
tinter = _load("tools/torch_port_interleave_fidelity.py")
jref = _load("tools/reference_scale_study.py")
tref = _load("tools/torch_port_reference_scale_study.py")


def _torch_weights(model, seed, shape, dtype=jnp.float64):
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros(shape, dtype))
    return from_jax_params(jax.tree.map(np.asarray, params))


def _close(got, want, rtol, atol=0.0, what=""):
    assert abs(got - want) <= atol + rtol * abs(want), (what, got, want)


def test_speedup_study_matches_jax(tmp_path, capsys):
    argv = ["--H", "18", "--W", "26", "--steps", "8", "--train-iters", "4",
            "--n-iter", "200"]
    (tmp_path / "jax").mkdir()
    jrows = jspeed.main(argv + ["--out-dir", str(tmp_path / "jax")])
    jloss = float(re.search(r"final train loss ([-0-9.e+]+)",
                            capsys.readouterr().out).group(1))
    with open(tmp_path / "jax" / "STUDY.json") as f:
        jrec = json.load(f)

    w0 = _torch_weights(JNewFluidNet(**tspeed.ARCH), 0, (8, 18, 26, 7))
    rec = tspeed.main(argv + ["--device", "cpu", "--out-dir",
                              str(tmp_path / "port")], init_weights=w0)
    assert sorted(os.listdir(tmp_path / "port")) == [
        "torch_port_speedup.json", "torch_port_speedup.md"]
    with open(tmp_path / "port" / "torch_port_speedup.json") as f:
        assert json.load(f)["rows"].keys() == rec["rows"].keys()

    assert rec["device"] == "cpu" and rec["grid"] == jrec["grid"]
    for k, v in jrec["vigor"].items():
        _close(rec["vigor"][k], v, 1e-10, what=k)
    assert list(rec["rows"]) == list(jrows) == [
        "GAIA", "GAIA-skip10", "ML_STOKES", "ML_PRE"]
    for name, rtol in (("GAIA-skip10", 1e-10), ("ML_STOKES", 1e-6),
                       ("ML_PRE", 1e-6)):
        got, want = rec["rows"][name], jrows[name]
        _close(got["t_rmse"], want["t_rmse"], rtol, what=name)
        _close(got["pearson"], want["pearson"], rtol, what=name)
        _close(got["trace_rmse"], want["trace_rmse"], rtol, 1e-14,
               what=name)
        # on the CPU no kernel wrapper launches
        assert set(got["launches_per_step"].values()) == {0}
    assert rec["rows"]["GAIA"]["t_rmse"] == 0.0
    assert abs(rec["train_loss"] - jloss) <= 5e-6


def _interleave_weights():
    m = JNewFluidNet(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu",
                     r_p="learned", loss_type="curl", repeats=2, f=5,
                     p_pred=False, dtype=jnp.float32)
    return _torch_weights(m, 3, (1, 16, 30, 7), jnp.float32)


def test_interleave_fidelity_matches_jax(tmp_path):
    argv = ["--layers", "14", "--ar", "2", "--steps", "12", "--levels", "2",
            "--c_h", "8", "--repeats", "2"]
    jout = jinter.main(argv + ["--device", "cpu"])
    w = _interleave_weights()
    out = tinter.main(argv + ["--device", "cpu", "--json", "--out-dir",
                              str(tmp_path)], init_weights=w)
    with open(tmp_path / "torch_port_interleave.json") as f:
        assert json.load(f) == out
    assert out["grid"] == jout["grid"] == [16, 30]
    _close(out["A_t_end"], jout["A_t_end"], 1e-5, what="A t_end")
    _close(out["mean_T_drift_A"], jout["mean_T_drift_A"], 0.0, 1e-6)
    for leg in ("B_native_interleave", "C_native_everystep"):
        got, want = out[leg], jout[leg]
        _close(got["trace_rmse"], want["trace_rmse"], 0.0, 1e-6, leg)
        _close(got["trace_max_abs"], want["trace_max_abs"], 0.0, 1e-6, leg)
        _close(got["t_end"], want["t_end"], 1e-5, what=leg)
        assert set(got["launches_per_step"].values()) == {0}
    assert out["B_native_interleave"]["steps"] == 12
    assert not out["trained_weights"]

    # --weights: the same network from a port checkpoint
    ckpt = tmp_path / "0_fluidnet_uvp.ckpt"
    save_checkpoint(str(ckpt), {"model": w, "epoch": 0})
    again = tinter.main(argv + ["--device", "cpu", "--weights", str(ckpt),
                                "--out-dir", str(tmp_path)])
    assert again["trained_weights"]
    for leg in ("B_native_interleave", "C_native_everystep"):
        assert again[leg]["trace_rmse"] == out[leg]["trace_rmse"]


def _sims(n_train=5, n_test=4):
    """A sims.pt list in the reference's layout (id, split, raq, fkt, fkp,
    grid, ar, path), the blacklisted ids 8 and 39 among the train sims
    and one above fkt_max."""
    rs = np.random.default_rng(7)
    ids = [8, 39, 200] + list(range(100, 100 + n_train + n_test))
    sims = []
    for i, sid in enumerate(ids):
        split = "train" if i < 3 + n_train else "test"
        fkt = 1e10 if sid == 200 else float(10 ** rs.uniform(6, 8))
        sims.append((sid, split, float(rs.uniform(1, 9)), fkt,
                     float(rs.uniform(1, 100)), "128x506", 4.0, f"s{sid}"))
    return sims


@pytest.mark.parametrize("n_train,n_test", [(2, 4), (3, 4), (5, 3),
                                            (6, 4), (3, 2)])
def test_real_paras_picks_as_jax(tmp_path, monkeypatch, n_train, n_test):
    path = tmp_path / "sims.pt"
    torch.save(_sims(5, n_test), path)
    monkeypatch.setattr(jref, "SIMS_PT", str(path))
    want = jref.real_paras(n_train)
    assert tref.real_paras(n_train, path=str(path)) == want
    assert (want is None) == (n_train > 5 or n_test < 3)
    assert tref.real_paras(n_train) is None
    assert tref.real_paras(n_train, path=str(tmp_path / "none.pt")) is None


def test_study_tools_refuse_without_a_card(tmp_path):
    """With no CUDA device and no --device cpu, each tool exits with an
    error naming the flag, and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    hbm = _load("tools/torch_port_hbm_scale_study.py")
    for tool in (tspeed, tref, tinter, hbm):
        with pytest.raises(SystemExit, match="--device cpu"):
            tool.main(["--out-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
