"""The port's benchmark CLI on the CPU (``--device cpu``) at small grids:
inference of the Transolvers and NewFluidNet, the NewFluidNet rollout,
the JAX CLI's metric names, and the choices that are not ported yet."""

import json

import pytest
import torch

from pbml_mantle_convection_tpu_torch.cli.benchmark import main


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


def test_rollout(capsys):
    sps = main(["--what", "rollout", "-l", "2", "--H", "20", "--W", "28",
                "--steps", "3", "--device", "cpu"])
    rec = _last_json(capsys)
    assert rec["metric"] == "rollout_steps_per_s_20x28"
    assert rec["unit"] == "steps/s" and sps > 0


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


@pytest.mark.parametrize("argv,match", [
    (["--what", "train"], "ROADMAP queue 1 item 4"),
    (["--what", "rollout", "--sharded"], "ROADMAP queue 1 item 7"),
    (["--what", "rollout", "--batch", "2"], "ROADMAP queue 1 item 3"),
    (["--what", "rollout", "-net", "transolver_structured"],
     "ROADMAP queue 1 item 6"),
    (["--what", "inference", "-net", "unet"], "ROADMAP queue 1 item 5"),
    (["--what", "inference", "-net", "vit"], "ROADMAP queue 1 item 6"),
])
def test_unported_choices_raise(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        main(argv + ["--device", "cpu", "--H", "8", "--W", "12"])


def test_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["--what", "inference", "-net", "transolver_structured",
              "--H", "8", "--W", "12"])
