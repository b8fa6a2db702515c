"""The port's HBM-scale study against the JAX package's, on the CPU, in
float32 with JAX's initial weights (``from_jax_params``).

``tools/torch_port_hbm_scale_study.py`` vs ``tools/hbm_scale_study.py``:
``phase_probe`` and ``phase_epoch`` 0 and 1 on ``--sims 2 --snaps 6
--batch 2 --steps_cap 1``, the flagship at 128×506: the store's files
byte for byte, its size and snapshot count, the residency choice; the
epochs' losses and loss log at rtol 2e-4 (the log's columns also within
1e-6 absolute: the smallest, the derivative term, is ~8e-4 of a loss
near 1) and the restart into epoch 1;
the JSON record of ``--phase inline``. Each epoch is one Adam step, whose
first update is about lr·sign(g): a gradient component that rounding
moves across zero moves its weight by a whole step, so the losses after
it differ by more than float32 rounding (measured 3.9e-5 in epoch 1,
8e-7 in epoch 0); the 1e-5 input noise is each package's own draw. Wall times
are not compared.
"""

import glob
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.models.registry import (  # noqa: E402
    ModelConfig as JConfig, build_model as j_build)
from pbml_mantle_convection_tpu_torch.train.trainer import parse_loss_log  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)

ROOT = Path(__file__).resolve().parents[1]


def _load(rel):
    spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jhbm = _load("tools/hbm_scale_study.py")
thbm = _load("tools/torch_port_hbm_scale_study.py")


def _loss_log(run_dir):
    (path,) = glob.glob(os.path.join(run_dir, "*", "fluidnet_uvpT.txt"))
    return parse_loss_log(path)


HBM_ARGV = ["--sims", "2", "--snaps", "6", "--batch", "2", "--steps_cap",
            "1", "--pipeline_steps", "2"]


def test_hbm_scale_study_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PMC_COMPILE_CACHE", "")
    monkeypatch.setattr(jhbm, "RUN_DIR", str(tmp_path / "jrun"))
    ja = jhbm.build_argparser().parse_args(
        HBM_ARGV + ["--path", str(tmp_path / "jstore")])
    jprobe = jhbm.phase_probe(ja)
    jep = [jhbm.phase_epoch(ja, k) for k in (0, 1)]

    x0 = jnp.zeros((1, 128, 506, 7), jnp.float32)
    mc = JConfig(network="newfluidnet", levels=5, c_h=16, repeats=6,
                 kernel=5, r_p="learned", loss_type="curl")
    w0 = from_jax_params(jax.tree.map(
        np.asarray, j_build(mc).init(jax.random.PRNGKey(0), x0)))
    rec = thbm.main(HBM_ARGV + [
        "--device", "cpu", "--phase", "inline", "--path",
        str(tmp_path / "tstore"), "--run-dir", str(tmp_path / "trun"),
        "--out-dir", str(tmp_path / "out")], init_weights=w0)
    with open(tmp_path / "out" / "torch_port_hbm.json") as f:
        assert json.load(f) == rec

    for name in ("T.dat", "u.dat", "v.dat"):
        a = (tmp_path / "tstore" / name).read_bytes()
        assert a == (tmp_path / "jstore" / name).read_bytes(), name
    jstore = jhbm.open_store(ja)[0]
    assert rec["store_bytes"] == jstore.field_nbytes(4) == 9326592
    for k in ("store_snapshots", "store_gb", "auto_would_pick_host"):
        assert rec[k] == jprobe[k], k
    assert rec["pipeline_batches"] == 2
    for k in (0, 1):
        assert rec["steps_measured"] == jep[k]["steps_measured"] == 1
        assert rec["steps_per_epoch_full"] == jep[k]["steps_per_epoch_full"]
        np.testing.assert_allclose(rec[f"loss_epoch{k}"],
                                   jep[k][f"loss_epoch{k}"], rtol=2e-4)
    assert (rec["start_epoch0"], rec["start_epoch1"]) == (0, 1)
    assert rec["epoch_extrapolated_s"] > 0

    jlog = _loss_log(tmp_path / "jrun")
    tlog = _loss_log(tmp_path / "trun")
    assert [e["epoch"] for e in tlog] == [e["epoch"] for e in jlog] == [0, 1]
    for a, b in zip(tlog, jlog):
        np.testing.assert_allclose(a["train"], b["train"], rtol=2e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(a["cv"], b["cv"], rtol=2e-4, atol=1e-6)
