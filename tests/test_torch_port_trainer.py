"""The port's Trainer, epoch loop, checkpoints and training CLIs on the CPU.

The slice as a whole: the JAX package's Trainer and the port's on the
same synthetic stores, seed and initial weights (carried across by
``from_jax_params``), two epochs with init-batch mixing, in float64. The
per-epoch 6-column train and cv losses agree at rtol 1e-9 and the loss
logs parse to the same epochs and learning rates.
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.constants import SimParams as JParams  # noqa: E402
from pbml_mantle_convection_tpu.data import SnapshotDataset as JDataset  # noqa: E402
from pbml_mantle_convection_tpu.data import synthetic_store as j_store  # noqa: E402
from pbml_mantle_convection_tpu.models import ModelConfig as JConfig  # noqa: E402
from pbml_mantle_convection_tpu.train import experiments as jexp  # noqa: E402
from pbml_mantle_convection_tpu.train import trainer as jtr  # noqa: E402

from pbml_mantle_convection_tpu_torch.cli import benchmark, train  # noqa: E402
from pbml_mantle_convection_tpu_torch.constants import SimParams  # noqa: E402
from pbml_mantle_convection_tpu_torch.data.dataset import SnapshotDataset  # noqa: E402
from pbml_mantle_convection_tpu_torch.data.synthetic import synthetic_store  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.registry import (  # noqa: E402
    ModelConfig, build_model)
from pbml_mantle_convection_tpu_torch.train import experiments  # noqa: E402
from pbml_mantle_convection_tpu_torch.train.functional import one_epoch  # noqa: E402
from pbml_mantle_convection_tpu_torch.train.train_step import (  # noqa: E402
    TrainStepConfig, make_eval_step, make_train_step)
from pbml_mantle_convection_tpu_torch.train.trainer import (  # noqa: E402
    TrainConfig, Trainer, adam_l2, best_epoch_from_log, parse_loss_log)
from pbml_mantle_convection_tpu_torch.utils.checkpoint import (  # noqa: E402
    restore_checkpoint)
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)

PARAMS = ((3.0, 1e8, 10.0), (1.0, 1e7, 3.0))
MODEL = dict(network="newfluidnet", levels=2, c_h=4, repeats=1, kernel=5,
             r_p="learned", loss_type="curl", p_pred=False, H=32, W=68)
TRAIN = dict(epochs=2, batch_size=4, start_lr=1e-3, milestones=(1,),
             loss_derivative=True)


def _port_data(n=(8, 4, 2), dtype=torch.float64):
    p = [SimParams(*q) for q in PARAMS]
    kw = dict(dtype=dtype, device="cpu")
    return (SnapshotDataset(synthetic_store(params_list=p, n_snapshots=n[0],
                                            seed=0), **kw),
            SnapshotDataset(synthetic_store(params_list=p[:1],
                                            n_snapshots=n[1], seed=1), **kw),
            SnapshotDataset(synthetic_store(params_list=p, n_snapshots=n[2],
                                            seed=2), **kw))


def _port_cfg(**kw):
    return TrainConfig(model=ModelConfig(**MODEL, dtype=torch.float64),
                       device="cpu", **{**TRAIN, **kw})


def test_two_epochs_match_the_jax_trainer(tmp_path):
    p = [JParams(*q) for q in PARAMS]
    jdata = [JDataset(j_store(params_list=p, n_snapshots=8, seed=0),
                      dtype=jnp.float64),
             JDataset(j_store(params_list=p[:1], n_snapshots=4, seed=1),
                      dtype=jnp.float64),
             JDataset(j_store(params_list=p, n_snapshots=2, seed=2),
                      dtype=jnp.float64)]
    jcfg = jtr.TrainConfig(model=JConfig(**MODEL), **TRAIN)
    jt = jtr.Trainer(jcfg, jdata[0], jdata[1], train_data_init=jdata[2],
                     cv_data_init=jdata[2], nn_dir=str(tmp_path / "jax"))
    x0 = jnp.zeros((1, 32, 68, 7), jnp.float64)
    jt.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                             jt.model.init(jax.random.PRNGKey(0), x0))
    jt.opt_state = jt.optimizer.init(jt.params)

    data = _port_data()
    tt = Trainer(_port_cfg(), data[0], data[1], train_data_init=data[2],
                 cv_data_init=data[2], nn_dir=str(tmp_path / "port"))
    tt.model.load_state_dict(from_jax_params(
        jax.tree.map(np.asarray, jt.params)))
    assert tt.small_batch == jt.small_batch == 2

    for epoch in range(2):
        jt._set_lr(epoch)
        tt._set_lr(epoch)
        (jl, jcv), (tl, tcv) = jt.run_epoch(epoch), tt.run_epoch(epoch)
        np.testing.assert_allclose(tl, jl, rtol=1e-9, err_msg="train")
        np.testing.assert_allclose(tcv, jcv, rtol=1e-9, err_msg="cv")
        jt.save(epoch, jl, jcv)
        tt.save(epoch, tl, tcv)
    assert tt.rng.integers(0, 2**31) == jt.rng.integers(0, 2**31)

    jlog, tlog = parse_loss_log(jt.log_path), parse_loss_log(tt.log_path)
    assert [e["epoch"] for e in tlog] == [e["epoch"] for e in jlog] == [0, 1]
    assert [e["lr"] for e in tlog] == [e["lr"] for e in jlog] == [1e-3, 5e-4]
    for a, b in zip(tlog, jlog):
        np.testing.assert_allclose(a["train"], b["train"], rtol=1e-9)
        np.testing.assert_allclose(a["cv"], b["cv"], rtol=1e-9)
    assert jtr.parse_loss_log(tt.log_path) == tlog
    with open(tt.log_path) as f, open(jt.log_path) as g:
        assert f.readline() == g.readline() == jtr.LOG_HEADER
    assert best_epoch_from_log(tt.log_path) == 0


def test_train_restart_resumes_epoch_and_adam_state(tmp_path, capsys):
    data = _port_data()
    tr = Trainer(_port_cfg(), *data[:2], nn_dir=str(tmp_path))
    tr.train(2)
    assert os.path.exists(os.path.join(tr.nn_dir, "1_fluidnet_uvp.ckpt"))
    with open(os.path.join(tr.nn_dir, "epoch_metrics.txt")) as f:
        walls = [line.split(",") for line in f.read().splitlines()]
    assert [int(e) for e, _ in walls] == [0, 1]
    assert all(float(w) > 0 for _, w in walls)

    raw = restore_checkpoint(os.path.join(tr.nn_dir, "1_fluidnet_uvp.ckpt"))
    assert raw["epoch"] == 1 and set(raw) == {"model", "optimizer", "epoch"}
    tr2 = Trainer(_port_cfg(), *data[:2], nn_dir=str(tmp_path), restart=True)
    assert tr2.start_epoch == 2
    assert "Restarting from epoch 2, lr 0.0005" in capsys.readouterr().out
    for (n, a), b in zip(tr.model.named_parameters(),
                         tr2.model.parameters()):
        assert torch.equal(a, b), n
    s1, s2 = tr.optimizer.state_dict(), tr2.optimizer.state_dict()
    assert len(s2["state"]) == len(list(tr.model.parameters())) > 0
    for k, st in s1["state"].items():
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(st[name], s2["state"][k][name]), (k, name)
    tr2.train(3)
    log = parse_loss_log(tr2.log_path)
    assert [e["epoch"] for e in log] == [0, 1, 2]
    assert log[2]["lr"] == 5e-4
    assert all(np.isfinite(e["train"]).all() for e in log)


def test_schedule_for_is_jaxs():
    for net in ("newfluidnet", "ifluidnet", "transolver_structured"):
        for debug in (False, True):
            assert TrainConfig.schedule_for(net, debug) == \
                jtr.TrainConfig.schedule_for(net, debug)
    cfg = TrainConfig(milestones=(2, 4), start_lr=1.0)
    assert [cfg.lr_at_epoch(e) for e in range(6)] == \
        [1.0, 1.0, 0.5, 0.5, 0.25, 0.25]
    assert ModelConfig(**MODEL).run_name == JConfig(**MODEL).run_name


def test_small_batch_is_clamped(tmp_path):
    data = _port_data()
    kw = dict(train_data_init=data[2], cv_data_init=data[2],
              nn_dir=str(tmp_path))
    assert Trainer(_port_cfg(batch_size=2), *data[:2], **kw).small_batch == 1
    assert Trainer(_port_cfg(batch_size=1), *data[:2], **kw).small_batch == 0
    assert Trainer(_port_cfg(), *data[:2], nn_dir=str(tmp_path)
                   ).small_batch == 0
    with pytest.raises(RuntimeError, match="torch.distributed world"):
        Trainer(_port_cfg(n_devices=2), *data[:2], **kw)


def test_no_training_batches_raises(tmp_path):
    data = _port_data()
    tr = Trainer(_port_cfg(batch_size=64), *data[:2], nn_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no training batches"):
        tr.train(1)


def test_one_epoch_is_the_step_loop():
    data = _port_data()
    cfg = TrainStepConfig(loss_derivative=True)
    models = [build_model(_port_cfg().model, device="cpu")
              for _ in range(2)]
    steps = [make_train_step(m, adam_l2(m.parameters(), 1e-3), cfg)
             for m in models]
    got = one_epoch(data[0], np.random.default_rng(1), 4, train_step=steps[0])
    ref = [steps[1](b).stack() for b in data[0].epoch_batches(
        np.random.default_rng(1), 4)]
    np.testing.assert_allclose(got, (sum(ref) / len(ref)).numpy(),
                               rtol=1e-14)
    ev = one_epoch(data[1], np.random.default_rng(2), 2,
                   eval_step=make_eval_step(models[0], cfg))
    assert len(ev) == 6 and np.isfinite(ev).all()


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_benchmark_train_metric_and_keys_are_the_jax_clis(capsys,
                                                          monkeypatch):
    from pbml_mantle_convection_tpu.cli.benchmark import main as jax_main
    monkeypatch.setenv("PMC_COMPILE_CACHE", "")
    # the default batch, 8, splits over the JAX tests' 8 CPU devices
    argv = ["--what", "train", "-l", "1", "-f", "4", "-r", "1", "-k", "3",
            "--H", "8", "--W", "12", "--iters", "1"]
    jax_main(argv)
    ref = _last_json(capsys)
    ms = benchmark.main(argv + ["--device", "cpu"])
    rec = _last_json(capsys)
    assert rec["metric"] == ref["metric"] == "train_step_newfluidnet_8x12_B8"
    assert set(ref) <= set(rec)
    assert rec["value"] == round(ms, 3) and rec["n_devices"] == 1
    assert np.isfinite(rec["loss"]) and rec["samples_per_s"] > 0
    assert rec["device"] == "cpu" and rec["power_limit"] is None
    assert rec["tf32_conv"] is False and rec["peak_memory_bytes"] is None


@pytest.mark.parametrize("argv,metric", [
    (["-l", "2", "-f", "4", "-r", "1", "--H", "20", "--W", "28"],
     "train_step_newfluidnet_20x28_B8"),
    (["-l", "2", "-f", "4", "-r", "1", "--H", "20", "--W", "28", "--remat",
      "--donate", "--batch", "3"],
     "train_step_newfluidnet_20x28_B3_remat"),
    (["-net", "transolver_structured", "--H", "8", "--W", "12",
      "--batch", "2"], "train_step_transolver_structured_8x12_B2"),
    (["-net", "transolver", "--H", "6", "--W", "8", "--batch", "2"],
     "train_step_transolver_6x8_B2"),
])
def test_benchmark_train(capsys, argv, metric):
    benchmark.main(["--what", "train", "--iters", "2", "--device", "cpu",
                    *argv])
    rec = _last_json(capsys)
    assert rec["metric"] == metric and rec["unit"] == "ms"
    assert np.isfinite(rec["loss"])


def test_benchmark_train_profile(capsys):
    """``--profile`` adds where a step's time goes; on the CPU the device
    numbers read "not measured"."""
    benchmark.main(["--what", "train", "--iters", "1", "--device", "cpu",
                    "-net", "transolver_structured", "--H", "8", "--W", "12",
                    "--batch", "2", "--profile"])
    prof = _last_json(capsys)["profile"]
    assert set(prof) == {"phase_ms", "device_kernel_ms_per_step",
                         "device_idle_share", "device_launches_per_step",
                         "top_kernels_ms_per_step"}
    assert prof["device_idle_share"] == "not measured"


def test_benchmark_train_batch_is_the_jax_clis():
    b = benchmark.train_batch("newfluidnet", 2, 6, 8, 7, torch.float64, "cpu")
    rs = np.random.default_rng(0)
    np.testing.assert_array_equal(b["x"].numpy(), rs.normal(size=(2, 6, 8, 7)))
    np.testing.assert_array_equal(b["y"].numpy(), rs.normal(size=(2, 2, 6, 8)))
    bt = benchmark.train_batch("transolver", 2, 6, 8, 7, torch.float64,
                               "cpu")
    np.testing.assert_array_equal(bt["x"].numpy(),
                                  b["x"].numpy().reshape(2, 48, 7))


def test_train_cli_synthetic_one_epoch(tmp_path, capsys):
    tr = train.main(["-l", "2", "-f", "4", "-r", "1", "-p", "learned",
                     "-b", "8", "-l_sc", "1", "-l_de", "1", "--synthetic",
                     "--epochs", "1", "--device", "cpu",
                     "--nn_dir", str(tmp_path)])
    assert "epoch 0: train" in capsys.readouterr().out
    log = parse_loss_log(tr.log_path)
    assert len(log) == 1 and np.isfinite(log[0]["train"]).all()
    assert tr.small_batch == 2 and tr.train_data_init is not None
    assert len(tr.train_data) == 48
    # the stores are the JAX CLI's (JAX cli/train.py:94-101)
    p = [JParams(*q) for q in PARAMS]
    for ours, (params, n, seed) in zip(train.synthetic_stores(),
                                       ((p, 24, 0), (p[:1], 8, 1),
                                        (p, 4, 2))):
        ref = j_store(params_list=params, n_snapshots=n, seed=seed)
        np.testing.assert_array_equal(ours.T, ref.T)
        np.testing.assert_array_equal(ours.paras, ref.paras)


def test_train_cli_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        train.main(["--synthetic", "--epochs", "1"])


@pytest.mark.parametrize("argv,match", [
    (["-net", "halfnewfluidnet"], "raw .* head"),
])
def test_train_cli_unported_raise(tmp_path, argv, match):
    """A HalfNewFluidNet's raw head is no (u, v, p): JAX's train step
    fails unpacking it, and the port's raises with that reason."""
    with pytest.raises(ValueError, match=match):
        train.main(["-l", "2", "--synthetic", "--epochs", "1", "--device",
                    "cpu", "--nn_dir", str(tmp_path), *argv])


@pytest.mark.parametrize("argv", [["-net", "vit"], ["-s", "1"],
                                  ["-d_r", "0.1"]],
                         ids=["vit", "use_symm", "dropout"])
def test_train_cli_runs_the_other_models(tmp_path, argv):
    """The ViT, symmetric convs and dropout train through the CLI (one
    epoch on the JAX CLI's synthetic stores, finite losses; their
    gradients against JAX: tests/test_torch_port_train_item6.py); with
    dropout the masks come from the Trainer's generator (seed + 1), so a
    second run repeats the first to the bit and differs from the run
    without dropout."""
    def run(extra, d):
        return train.main(["-l", "2", "-f", "8", "-r", "1", "--synthetic",
                           "--epochs", "1", "--device", "cpu", "--nn_dir",
                           str(tmp_path / d), *extra])

    tr = run(argv, "a")
    log = parse_loss_log(tr.log_path)
    assert [e["epoch"] for e in log] == [0]
    assert np.isfinite(log[0]["train"]).all() and np.isfinite(
        log[0]["cv"]).all()
    if argv[0] == "-d_r":
        assert tr.dropout_generator.device == torch.device("cpu")
        again = parse_loss_log(run(argv, "b").log_path)
        assert again[0]["train"] == log[0]["train"]
        assert again[0]["cv"] == log[0]["cv"]
        plain = parse_loss_log(run([], "c").log_path)
        assert plain[0]["train"] != log[0]["train"]
    else:
        assert tr.dropout_generator is None


def test_experiments_are_jaxs(tmp_path):
    """The registry is JAX's; the U-Net and ConvAE entries train through
    the Trainer (one epoch on the synthetic stores, finite losses);
    ``fluidnet_base``'s six learned levels on the stores' 32×68 grid
    raise naming the sizes (JAX's FluidNet fails there with an
    IndexError; the other models' entries: tests/
    test_torch_port_train_item6.py)."""
    assert experiments.EXPERIMENTS == jexp.EXPERIMENTS
    for name in ("unet_roll1", "unet_roll2", "unet_roll4", "convae"):
        tr = experiments.run_experiment(name, [
            "--device", "cpu", "--epochs", "1",
            "--nn_dir", str(tmp_path / name)])
        log = parse_loss_log(tr.log_path)
        assert [e["epoch"] for e in log] == [0]
        assert np.isfinite(log[0]["train"]).all()
    with pytest.raises(ValueError, match="FluidNet: levels=6 .* 32x68"):
        experiments.run_experiment("fluidnet_base", [
            "--device", "cpu", "--epochs", "1", "--nn_dir", str(tmp_path)])
