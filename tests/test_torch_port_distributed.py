"""Data parallelism of the port over ``torch.distributed`` (gloo, two CPU
processes, ``tests/torch_port_dp_worker.py``): 3 steps of the two-rank
train step, each rank on half the batch, equal the single-process steps
on the full batch (parameters, gradients and the mean 6-column loss,
≤ 1e-12 of each tensor's scale; the one parameter whose gradient is
rounding noise aside), as the JAX package's ``pmean`` step equals its
single-device step; and a Trainer epoch with ``n_devices=2``
(small_batch 1) leaves both ranks with the same parameters."""

import os
import socket
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_port_dp_worker as worker  # noqa: E402

from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet  # noqa: E402


# the last conv's bias: the head subtracts the spatial mean after it, so
# its gradient is rounding noise, which Adam turns into ±lr steps
# (tests/test_torch_port_train_step.py); the losses show it does nothing
NOISE = "conv_3.learnable_bias"


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _scaled_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def test_two_rank_step_equals_the_full_batch_step(tmp_path):
    port, world = _free_port(), 2
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_port_dp_worker.py"),
         str(r), str(world), str(port), str(tmp_path)], env=env)
        for r in range(world)]
    try:
        codes = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0, 0]
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
             for r in range(world)]

    model = NewFluidNet(device="cpu", dtype=torch.float64, **worker.NFN)
    brs = worker.steps(model, worker.full_batch())
    for rank in ranks:
        assert _scaled_err(rank["breakdowns"], brs) <= 1e-12
        for n, p in model.named_parameters():
            if n == NOISE:
                continue
            assert _scaled_err(rank["params"][n], p.detach()) <= 1e-12, n
            assert _scaled_err(rank["grads"][n], p.grad) <= 1e-12, n

    assert ranks[0]["small_batch"] == ranks[1]["small_batch"] == 1
    for n, p in ranks[0]["trainer"].items():
        assert torch.equal(p, ranks[1]["trainer"][n]), n
    log = os.path.join(tmp_path, "runs")
    assert any(f == "fluidnet_uvpT.txt" for _, _, fs in os.walk(log)
               for f in fs)


def test_train_cli_two_ranks(tmp_path):
    """``cli/train.py --n_devices 2`` in two gloo processes with the world
    in the environment (as torchrun sets it): one synthetic epoch, one
    log line written by rank 0."""
    port = _free_port()
    argv = [sys.executable, "-m", "pbml_mantle_convection_tpu_torch.cli.train",
            "-l", "2", "-f", "4", "-r", "1", "-p", "learned", "-b", "8",
            "--synthetic", "--epochs", "1", "--device", "cpu",
            "--n_devices", "2", "--nn_dir", str(tmp_path)]
    procs = [subprocess.Popen(
        argv, cwd=os.path.dirname(HERE),
        env={**os.environ, "OMP_NUM_THREADS": "1", "RANK": str(r),
             "LOCAL_RANK": str(r), "WORLD_SIZE": "2",
             "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
        for r in range(2)]
    try:
        codes = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0, 0]
    logs = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path) for f in fs
            if f == "fluidnet_uvpT.txt"]
    assert len(logs) == 1
    with open(logs[0]) as f:
        lines = f.read().splitlines()
    assert len(lines) == 2 and lines[1].startswith("0,[")
