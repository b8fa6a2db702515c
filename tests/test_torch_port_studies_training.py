"""The port's reference-scale training study against the JAX package's,
on the CPU, in float32 with JAX's initial weights (``from_jax_params``).
Wall times are not compared. (The speedup and interleave studies:
tests/test_torch_port_studies.py.)

``tools/torch_port_reference_scale_study.py`` vs
``tools/reference_scale_study.py`` at ``--H 34 --W 66 --steps 9 --epochs
2 --n-iter 1000``, the network cut to ``--levels 2 --c_h 8 --repeats 2``
(the fallback triples are three simulations whatever ``--n-train-sims``;
9 steps is the least that gives the cv store a snapshot, whose every 8th
index lies past each simulation's 5 init snapshots: at 6 or 8 JAX's
study fails on the empty store). JAX runs in a subprocess with one CPU
device, as the port's Trainer runs in one process: the 8-device mesh of
tests/conftest.py would give JAX's Trainer another init-batch split. The
held-out rows' T-RMSE, Pearson r, trace RMSE and profile MAE within 1e-6
absolute (measured ≤ 3.8e-8), the margin at rtol 1e-4 (7e-7), the loss
log's epochs, learning rates and losses at rtol 1e-4 (2.2e-6: the
datasets' 1e-5 input noise is each package's own draw, jax.random and a
torch generator, which the FK viscosity's exponent, ln fkt ≈ 14-16,
carries into the losses, and Adam's first steps move each weight by
about lr whatever the size of its gradient), and the restart at epoch 1.
(The HBM-scale study: tests/test_torch_port_studies_hbm.py.)
"""

import glob
import importlib.util
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from pbml_mantle_convection_tpu_torch.train.trainer import parse_loss_log  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)

ROOT = Path(__file__).resolve().parents[1]


def _load(rel):
    spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tref = _load("tools/torch_port_reference_scale_study.py")

REF_ARGV = ["--H", "34", "--W", "66", "--steps", "9", "--epochs", "2",
            "--n-train-sims", "2", "--n-iter", "1000", "--levels", "2",
            "--c_h", "8", "--repeats", "2"]
# JAX's study, its Trainer's initial weights (seed 0) and the untrained
# baseline's (seed 123), in a process of one CPU device
JAX_REFSCALE = """
import pickle, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/tools")
import reference_scale_study as study
from pbml_mantle_convection_tpu.models.registry import (ModelConfig,
                                                        build_model)
assert len(jax.devices()) == 1
rows = study.main(sys.argv[3:])
m = build_model(ModelConfig(network="newfluidnet", levels=2, c_h=8,
                            repeats=2, kernel=5, r_p="learned",
                            loss_type="curl", p_pred=False, H=34, W=66,
                            dtype=jnp.float32))
x0 = jnp.zeros((1, 34, 66, 7), jnp.float32)
w = {s: jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(s), x0))
     for s in (0, 123)}
with open(sys.argv[2], "wb") as f:
    pickle.dump({"rows": rows, "weights": w}, f)
"""


def _one_device_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f)
    return env


def _loss_log(run_dir):
    (path,) = glob.glob(os.path.join(run_dir, "*", "fluidnet_uvpT.txt"))
    return parse_loss_log(path)


def test_reference_scale_study_matches_jax(tmp_path):
    out = tmp_path / "jax.pkl"
    subprocess.run(
        [sys.executable, "-c", JAX_REFSCALE, str(ROOT), str(out), *REF_ARGV,
         "--device", "cpu", "--out-dir", str(tmp_path / "jax"),
         "--run-dir", str(tmp_path / "jrun")],
        check=True, env=_one_device_env(), capture_output=True, text=True)
    with open(out, "rb") as f:
        got = pickle.load(f)
    jrows, w = got["rows"], got["weights"]
    with open(tmp_path / "jax" / "STUDY_REFSCALE.json") as f:
        jrec = json.load(f)

    rec = tref.main(REF_ARGV + ["--device", "cpu", "--out-dir",
                                str(tmp_path / "port"), "--run-dir",
                                str(tmp_path / "trun")],
                    init_weights=from_jax_params(w[0]),
                    untrained_weights=from_jax_params(w[123]))
    assert sorted(os.listdir(tmp_path / "port")) == [
        "torch_port_refscale.json", "torch_port_refscale.md"]
    assert rec["n_devices"] == jrec["n_devices"] == 1
    assert [tuple(p) for p in rec["train_paras"]] == tref.TRAIN_PARAS
    assert rec["snapshots"] == [9, 3, 15]
    assert rec["start_epoch_after_restart"] == 1
    assert list(rec["rows"]) == list(jrows)
    for name, want in jrows.items():
        for col in ("t_rmse", "pearson", "trace_rmse", "profile_mae"):
            assert abs(rec["rows"][name][col] - want[col]) <= 1e-6, (
                name, col, rec["rows"][name][col], want[col])
        assert set(rec["rows"][name]["launches_per_step"].values()) == {0}
    assert abs(rec["margin"] - jrec["margin"]) <= 1e-4 * jrec["margin"]

    jlog, tlog = _loss_log(tmp_path / "jrun"), _loss_log(tmp_path / "trun")
    assert [e["epoch"] for e in tlog] == [e["epoch"] for e in jlog] == [0, 1]
    assert [e["lr"] for e in tlog] == [e["lr"] for e in jlog]
    for a, b in zip(tlog, jlog):
        np.testing.assert_allclose(a["train"], b["train"], rtol=1e-4)
        np.testing.assert_allclose(a["cv"], b["cv"], rtol=1e-4)
