"""The port's benchmark CLI on the CPU (``--device cpu``) at small grids:
inference of the Transolvers and NewFluidNet, the NewFluidNet rollout
at B = 1 and B > 1,
the JAX CLI's metric names and inputs (and the first rollout step's dt
from them), TF32 off, and the choices JAX's CLI fails on too."""

import json

import numpy as np
import pytest
import torch

from pbml_mantle_convection_tpu_torch.cli.benchmark import (
    inference_input, initial_temperature, main)
from pbml_mantle_convection_tpu_torch.constants import SimParams
from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet
from pbml_mantle_convection_tpu_torch.models.registry import ModelConfig
from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine
from pbml_mantle_convection_tpu_torch.sim.grid import Grid
from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("argv,metric", [
    (["-net", "transolver_structured", "--H", "16", "--W", "24"],
     "inference_latency_transolver_structured_16x24"),
    (["-net", "transolver", "--H", "8", "--W", "12"],
     "inference_latency_transolver_8x12"),
    (["-l", "2", "--H", "20", "--W", "28"],
     "inference_latency_newfluidnet_20x28"),
    (["-l", "2", "--H", "20", "--W", "28", "--raw-module"],
     "inference_latency_newfluidnet_20x28"),
    (["-net", "transolver_structured", "--H", "10", "--W", "12",
      "--dtype", "float64"],
     "inference_latency_transolver_structured_10x12"),
])
def test_inference(capsys, argv, metric):
    ms = main(["--what", "inference", "--iters", "2", "--device", "cpu",
               *argv])
    rec = _last_json(capsys)
    assert rec["metric"] == metric and rec["unit"] == "ms"
    assert rec["iters"] == 2 and rec["device"] == "cpu"
    assert ms > 0 and rec["value"] == round(ms, 4)
    assert rec["tf32_conv"] is False and rec["tf32_matmul"] is False


def test_rollout(capsys):
    sps = main(["--what", "rollout", "-l", "2", "--H", "20", "--W", "28",
                "--steps", "3", "--device", "cpu"])
    rec = _last_json(capsys)
    assert rec["metric"] == "rollout_steps_per_s_20x28"
    assert rec["unit"] == "steps/s" and sps > 0
    assert rec["tf32_conv"] is False and rec["tf32_matmul"] is False


@pytest.mark.parametrize("pad", ["learned", "zeros"])
def test_batched_rollout(capsys, monkeypatch, pad):
    """--batch 2: B simulations per step, the fused executor once per
    simulation (learned padding and zero padding, its two instances),
    sim-steps/s."""
    from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper
    calls = []
    planar = TimeStepper.executor_input
    monkeypatch.setattr(TimeStepper, "executor_input",
                        lambda self, T, V: calls.append(T.shape[0])
                        or planar(self, T, V))
    sps = main(["--what", "rollout", "-l", "2", "-f", "8", "-r", "1",
                "--H", "20", "--W", "28", "--steps", "2", "--batch", "2",
                "-pad", pad, "--device", "cpu"])
    rec = _last_json(capsys)
    assert rec["metric"] == "rollout_steps_per_s_20x28_B2"
    assert rec["unit"] == "steps/s" and rec["value"] == round(sps, 2)
    assert rec["sim_steps_per_s"] == round(2 * sps, 2)
    # warm-up and timed steps: 2 + 2, two simulations each
    assert calls == [1] * 8


@pytest.mark.parametrize("network,H,W", [
    ("transolver_structured", 16, 24), ("transolver", 8, 12),
    ("newfluidnet", 20, 28)])
def test_inputs_are_the_jax_clis(network, H, W):
    """Inference feeds the JAX CLI's zeros (JAX cli/benchmark.py:79-82) of
    its shapes, the rollout starts from its noise-free field (:199-200)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from pbml_mantle_convection_tpu.models.registry import (
        ModelConfig as JConfig)
    from pbml_mantle_convection_tpu.sim.grid import Grid as JGrid
    c_i, _ = JConfig(network=network, H=H, W=W).channels
    assert ModelConfig(network=network, H=H, W=W).channels[0] == c_i
    ref = (jnp.zeros((1, H * W, c_i), jnp.float32)
           if "transolver" in network
           else jnp.zeros((1, H, W, c_i), jnp.float32))
    x = inference_input(network, H, W, c_i, torch.float32, "cpu")
    assert x.dtype == torch.float32
    np.testing.assert_array_equal(x.numpy(), np.asarray(ref))

    jgrid = JGrid(H=H, W=W, aspect=(W - 2) / (H - 2), dtype="float64")
    T0 = jnp.clip(1.0 - jgrid.yc + 0.05 * jnp.sin(6.28 * jgrid.xc), 0, 1)
    grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2))
    T = initial_temperature(grid)
    assert T.shape == (1, H, W)
    np.testing.assert_allclose(T[0], np.asarray(T0), rtol=1e-15, atol=0)
    # B > 1: phase-shifted fields (JAX cli/benchmark.py:201-206)
    T0s = jnp.stack([jnp.clip(1.0 - jgrid.yc
                              + 0.05 * jnp.sin(6.28 * jgrid.xc + 0.37 * b),
                              0, 1) for b in range(3)])
    T = initial_temperature(grid, 3)
    assert T.shape == (3, H, W)
    np.testing.assert_allclose(T, np.asarray(T0s), rtol=1e-15, atol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_first_rollout_dt_matches_the_jax_cli(fused):
    """One coupled step from each CLI's initial field at 20×28, float64,
    with the same weights: the port's dt is the JAX engine's (rtol
    1e-10, the golden rollout's tolerance)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from pbml_mantle_convection_tpu.constants import SimParams as JParams
    from pbml_mantle_convection_tpu.models import NewFluidNet as JNewFluidNet
    from pbml_mantle_convection_tpu.sim.engine import SimEngine as JEngine
    from pbml_mantle_convection_tpu.sim.grid import Grid as JGrid
    from pbml_mantle_convection_tpu.sim.stepper import (
        TimeStepper as JStepper)
    from pbml_mantle_convection_tpu_torch.models.fast_path import (
        FastNewFluidNet)
    from pbml_mantle_convection_tpu_torch.utils.flax_convert import (
        from_jax_params)
    H, W = 20, 28
    cfg = dict(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu", r_p="learned",
               loss_type="curl", repeats=1, f=5, p_pred=False)
    jm = JNewFluidNet(**cfg)
    w = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 7), jnp.float64))
    # the JAX CLI's rollout set-up (JAX cli/benchmark.py:186-200)
    jgrid = JGrid(H=H, W=W, aspect=(W - 2) / (H - 2), dtype="float64")
    pp = JParams(3.0, 1e8, 10.0)
    jeng = JEngine(grid=jgrid, params=pp, dtype=jnp.float64,
                   stepper=JStepper(grid=jgrid, params=pp,
                                    apply_fn=lambda x: jm.apply(w, x),
                                    net="newfluidnet", cn_max=0.99,
                                    dtype=jnp.float64))
    T0 = jnp.clip(1.0 - jgrid.yc + 0.05 * jnp.sin(6.28 * jgrid.xc), 0, 1)
    js = jax.jit(jeng.step)(jeng.init_state(T0[None]))

    net = NewFluidNet(device="cpu", dtype=torch.float64, **cfg)
    net.load_state_dict(from_jax_params(jax.tree.map(np.asarray, w)))
    grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2))
    eng = SimEngine(TimeStepper(grid, SimParams(3.0, 1e8, 10.0),
                                FastNewFluidNet(net, H, W) if fused else net,
                                cn_max=0.99, dtype=torch.float64,
                                device="cpu"))
    ts = eng.step(eng.init_state(initial_temperature(grid)))
    assert float(js.dt) > 0
    np.testing.assert_allclose(float(ts.dt), float(js.dt), rtol=1e-10)
    np.testing.assert_allclose(ts.T.numpy(), np.asarray(js.T), rtol=1e-10,
                               atol=1e-12)


def test_metric_name_matches_the_jax_cli(capsys, monkeypatch):
    pytest.importorskip("jax")
    from pbml_mantle_convection_tpu.cli.benchmark import main as jax_main
    monkeypatch.setenv("PMC_COMPILE_CACHE", "")
    argv = ["--what", "inference", "-net", "transolver_structured",
            "--H", "16", "--W", "24", "--iters", "1"]
    jax_main(argv)
    ref = _last_json(capsys)
    main(argv + ["--device", "cpu"])
    rec = _last_json(capsys)
    assert rec["metric"] == ref["metric"]
    assert set(ref) <= set(rec)
    # the B > 1 rollout (JAX cli/benchmark.py:256-267), at a size that
    # compiles quickly
    argv = ["--what", "rollout", "-l", "1", "-f", "4", "-r", "1", "-k", "3",
            "--H", "8", "--W", "12", "--steps", "1", "--batch", "3"]
    jax_main(argv)
    ref = _last_json(capsys)
    main(argv + ["--device", "cpu"])
    rec = _last_json(capsys)
    assert rec["metric"] == ref["metric"] == "rollout_steps_per_s_8x12_B3"
    assert set(ref) <= set(rec)


@pytest.mark.parametrize("argv,exc,match", [
    (["--what", "train", "-net", "halfnewfluidnet"], ValueError,
     "raw .* head"),
    (["--what", "rollout", "--dtype", "bfloat16"], TypeError,
     "got float32, bfloat16"),
    (["--what", "rollout", "-net", "transolver_structured"], ValueError,
     "Transolver reads"),
    (["--what", "rollout", "-net", "halfnewfluidnet"], ValueError,
     "raw .* head"),
    (["--what", "rollout", "--dtype", "bfloat16", "-pad", "zeros"],
     TypeError, "carry input and carry output must have equal types"),
    (["--what", "rollout", "--dtype", "bfloat16", "--sharded"], TypeError,
     "got float32, bfloat16"),
])
def test_unported_choices_raise(argv, exc, match):
    """What JAX's CLI fails on, refused with its reason: a
    HalfNewFluidNet's raw head in a train step or a rollout, a Transolver
    in the stepper, the bfloat16 rollouts of the fused executor (learned
    padding, sharded or not, and zero padding)."""
    with pytest.raises(exc, match=match):
        main(argv + ["--device", "cpu", "--H", "8", "--W", "12"])


@pytest.mark.parametrize("what,net", [
    ("inference", "halfnewfluidnet"), ("inference", "vit"),
    ("rollout", "fluidnet"), ("rollout", "multiscalenewfluidnet"),
    ("rollout", "vit"), ("train", "vit"), ("train", "fluidnet")])
def test_other_models_run_under_the_jax_clis_metric_names(capsys, what, net,
                                                          monkeypatch):
    """The other models through the benchmark CLI, against the JAX CLI's
    run of the same argv: the same metric name, its record's keys among
    ours, a finite value (and loss)."""
    pytest.importorskip("jax")
    from pbml_mantle_convection_tpu.cli.benchmark import main as jax_main
    monkeypatch.setenv("PMC_COMPILE_CACHE", "")
    argv = ["--what", what, "-net", net, "-l", "1", "-f", "4", "-r", "1",
            "-k", "3", "--H", "8", "--W", "12", "--iters", "1", "--steps",
            "2", "--batch", "8" if what == "train" else "1"]
    jax_main(argv)
    ref = _last_json(capsys)
    main(argv + ["--device", "cpu"])
    rec = _last_json(capsys)
    assert rec["metric"] == ref["metric"]
    assert set(ref) <= set(rec)
    assert np.isfinite(rec["value"]) and np.isfinite(rec.get("loss", 0.0))


def test_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["--what", "inference", "-net", "transolver_structured",
              "--H", "8", "--W", "12"])
