"""One rank of the port's data-parallel train step on gloo, for
tests/test_torch_port_distributed.py (run as a script, one process per
rank)::

    python tests/torch_port_dp_worker.py RANK WORLD PORT OUT_DIR

It trains the same seeded NewFluidNet in float64 on the CPU: 3 steps of
``make_train_step(..., process_group=WORLD)`` on this rank's share of a
seeded batch, then one Trainer epoch with ``n_devices=WORLD``; it writes
its parameters, gradients and loss breakdowns to OUT_DIR/rank{RANK}.pt.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pbml_mantle_convection_tpu_torch.constants import SimParams  # noqa: E402
from pbml_mantle_convection_tpu_torch.data.dataset import SnapshotDataset  # noqa: E402
from pbml_mantle_convection_tpu_torch.data.synthetic import synthetic_store  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.registry import ModelConfig  # noqa: E402
from pbml_mantle_convection_tpu_torch.train.train_step import (  # noqa: E402
    TrainStepConfig, make_train_step)
from pbml_mantle_convection_tpu_torch.train.trainer import (  # noqa: E402
    TrainConfig, Trainer, adam_l2)

NFN = dict(levels=2, c_i=7, c_h=4, c_o=1, act_fn="gelu", r_p="learned",
           loss_type="curl", repeats=1, f=5, p_pred=False)
STEP = TrainStepConfig(loss_scale=True, loss_derivative=True,
                       loss_type="curl")


def full_batch(B=4, H=32, W=68):
    rng = np.random.default_rng(0)
    return {"x": torch.as_tensor(rng.normal(size=(B, H, W, 7))),
            "y": torch.as_tensor(rng.normal(size=(B, 2, H, W)))}


def steps(model, batch, group=None, n=3):
    """``n`` train steps; returns the breakdowns, stacked."""
    step = make_train_step(model, adam_l2(model.parameters(), 1e-3, 1e-3),
                           STEP, process_group=group)
    return torch.stack([step(batch).stack() for _ in range(n)])


def main(rank, world, port, out):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        batch = full_batch()
        b = batch["x"].shape[0] // world
        shard = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
        model = NewFluidNet(device="cpu", dtype=torch.float64, **NFN)
        brs = steps(model, shard, dist.group.WORLD)

        params = [SimParams(3.0, 1e8, 10.0), SimParams(1.0, 1e7, 3.0)]
        data = [SnapshotDataset(synthetic_store(params_list=p, n_snapshots=n,
                                                seed=s),
                                dtype=torch.float64, device="cpu")
                for p, n, s in ((params, 8, 0), (params[:1], 4, 1),
                                (params, 2, 2))]
        cfg = TrainConfig(
            model=ModelConfig(network="newfluidnet", levels=2, c_h=4,
                              repeats=1, kernel=5, r_p="learned",
                              loss_type="curl", H=32, W=68,
                              dtype=torch.float64),
            epochs=1, batch_size=4, n_devices=world, device="cpu")
        tr = Trainer(cfg, data[0], data[1], train_data_init=data[2],
                     cv_data_init=data[2], nn_dir=os.path.join(out, "runs"))
        tr.train(1)
        torch.save({"params": {n: p.detach() for n, p in
                               model.named_parameters()},
                    "grads": {n: p.grad for n, p in
                              model.named_parameters()},
                    "breakdowns": brs, "small_batch": tr.small_batch,
                    "trainer": {n: p.detach() for n, p in
                                tr.model.named_parameters()}},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
