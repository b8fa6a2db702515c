"""One rank of the port's parallel paths on gloo, for
tests/test_torch_port_parallel.py (run as a script, one process per
rank)::

    python tests/torch_port_parallel_worker.py RANK WORLD PORT DIR

It reads DIR/inputs.pt (written by the test: the Physics-Attention's and
the small flagship's weights, the points, the initial fields) and, on
this rank's share, runs in float64 on the CPU:

* ``physics_attention_sharded`` over the points split into WORLD blocks;
* with WORLD = 2 also the per-simulation sharded rollout at local batch 1
  and 2, the coupled batch-sharded rollout (one dt over the ranks) at
  local batch 4, the refusals of a batch that does not divide and of a
  coupled engine, and a distributed-checkpoint round trip into a target.

Each rank writes what it gathered to DIR/rank{RANK}.pt.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pbml_mantle_convection_tpu_torch.constants import SimParams  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.fast_path import (  # noqa: E402
    FastNewFluidNet)
from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.transolver import (  # noqa: E402
    PhysicsAttentionIrregularMesh)
from pbml_mantle_convection_tpu_torch.parallel.mesh import (  # noqa: E402
    gather_rows, shard_batch)
from pbml_mantle_convection_tpu_torch.parallel.rollout import (  # noqa: E402
    make_batch_sharded, rollout_batch_sharded)
from pbml_mantle_convection_tpu_torch.parallel.sequence import (  # noqa: E402
    physics_attention_sharded)
from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.grid import Grid  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.checkpoint import (  # noqa: E402
    restore_checkpoint_distributed, save_checkpoint_distributed)

ATTN = dict(heads=2, dim_head=8, slice_num=4)
NFN = dict(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu", r_p="learned",
           loss_type="curl", repeats=1, f=5, p_pred=False)
H, W, STEPS = 20, 28, 6


def attention(inp, group):
    m = PhysicsAttentionIrregularMesh(16, np.random.default_rng(0), **ATTN)
    m.double().load_state_dict(inp["attn"])
    x = inp["x_attn"]
    with torch.no_grad():
        local = shard_batch(group, x.transpose(0, 1)).transpose(0, 1)
        out = physics_attention_sharded(m, local, group,
                                        ATTN["heads"], ATTN["dim_head"])
    return gather_rows(group, out, dim=1)


def flagship_engine(inp, group=None):
    net = NewFluidNet(device="cpu", dtype=torch.float64, **NFN)
    net.load_state_dict(inp["net"])
    grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2))
    stepper = TimeStepper(grid, SimParams(3.0, 1e8, 10.0),
                          FastNewFluidNet(net, H, W), cn_max=0.99,
                          dtype=torch.float64, device="cpu")
    return SimEngine(stepper, process_group=group)


def main(rank, world, port, out):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    group = dist.group.WORLD
    try:
        inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=True)
        res = {"attention": attention(inp, group)}
        if world == 2:
            eng = flagship_engine(inp)
            T0 = inp["T0"]
            res["per_sim_b2"] = rollout_batch_sharded(eng, T0[:2], STEPS,
                                                      group)._asdict()
            res["per_sim_b4"] = rollout_batch_sharded(eng, T0[:4], STEPS,
                                                      group)._asdict()
            coupled = flagship_engine(inp, group)
            st, tr = coupled.multi_step(
                coupled.init_state(shard_batch(group, T0)), STEPS)
            res["coupled"] = {"T": gather_rows(group, st.T), "t": st.t,
                              "dt": tr.dt, "mean_T": tr.mean_T}
            for name, fn in (
                    ("not_divisible",
                     lambda: rollout_batch_sharded(eng, T0[:3], 1, group)),
                    ("coupled_refused",
                     lambda: make_batch_sharded(coupled, 1, group))):
                try:
                    fn()
                except ValueError as e:
                    res[name] = str(e)
            state = {"model": inp["net"], "epoch": 3, "rank_lr": [1e-3]}
            path = os.path.join(out, "ckpt")
            save_checkpoint_distributed(path, state)
            target = {"model": {k: torch.zeros_like(v)
                                for k, v in inp["net"].items()},
                      "epoch": 0, "rank_lr": [0.0]}
            res["restored"] = restore_checkpoint_distributed(path, target)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
