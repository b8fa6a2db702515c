"""The benchmark CLI's ``--sharded`` rollout and its world, on the CPU
(``--device cpu``): the JAX CLI's metric and keys in one process, and two
gloo ranks started as torchrun starts them (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``): the sharded rollout over both and a
train step whose batch they split."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from pbml_mantle_convection_tpu_torch.cli.benchmark import main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["-l", "1", "-f", "4", "-r", "1", "-k", "3", "--H", "8", "--W",
         "12", "--steps", "1", "--iters", "1"]


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def test_sharded_matches_the_jax_clis_record(capsys):
    """World of one: the JAX CLI's metric name (over its 8 CPU devices:
    B = 8), its record's keys among ours; B = world = 1 here, or
    ``--batch``."""
    pytest.importorskip("jax")
    from pbml_mantle_convection_tpu.cli.benchmark import main as jax_main
    argv = ["--what", "rollout", "--sharded"] + SMALL
    jax_main(argv)
    ref = _last_json(capsys.readouterr().out)
    main(argv + ["--device", "cpu"])
    rec = _last_json(capsys.readouterr().out)
    assert rec["metric"] == ref["metric"] == "sharded_rollout_8x12"
    assert set(ref) <= set(rec)
    assert rec["n_devices"] == 1 and rec["batch"] == 1
    assert rec["unit"] == "sim_steps/s" and np.isfinite(rec["value"])
    main(argv + ["--device", "cpu", "--batch", "3"])
    rec = _last_json(capsys.readouterr().out)
    assert rec["batch"] == 3
    assert rec["value"] == pytest.approx(3 * rec["rollout_steps_per_s"],
                                         rel=1e-2)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _two_ranks(argv):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pbml_mantle_convection_tpu_torch.cli."
         "benchmark", "--device", "cpu"] + argv, cwd=ROOT,
        stdout=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1", "RANK": str(r),
             "LOCAL_RANK": str(r), "WORLD_SIZE": "2",
             "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0]
    assert outs[1].strip() == ""        # rank 0 prints
    return _last_json(outs[0])


def test_sharded_over_two_gloo_ranks():
    rec = _two_ranks(["--what", "rollout", "--sharded"] + SMALL)
    assert rec["metric"] == "sharded_rollout_8x12"
    assert rec["n_devices"] == 2 and rec["batch"] == 2
    assert np.isfinite(rec["value"])


def test_train_splits_the_batch_over_two_ranks(capsys):
    """Two ranks, two rows each: the loss printed is the whole batch's
    (the ranks' losses all-reduced), as one process's at B = 4 is."""
    argv = ["--what", "train", "--batch", "4"] + SMALL
    rec = _two_ranks(argv)
    assert rec["metric"] == "train_step_newfluidnet_8x12_B4"
    assert rec["n_devices"] == 2 and np.isfinite(rec["loss"])
    main(argv + ["--device", "cpu"])
    one = _last_json(capsys.readouterr().out)
    assert one["n_devices"] == 1
    assert rec["loss"] == pytest.approx(one["loss"], rel=1e-5)


def test_sharded_needs_a_card_unless_told_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["--what", "rollout", "--sharded"] + SMALL)
