"""Multi-rank dry run in gloo processes on the CPU.

Counterpart of the JAX package's ``parallel/dryrun.py``, which checks the
multi-device surface on N virtual CPU devices; here N processes join one
gloo process group and run, at tiny shapes:

1. one data-parallel train step (``train/train_step.py::make_train_step``
   with the process group: gradients all-reduced to their mean, the
   reference's DDP all-reduce, multigpu.py:69,319), one sample per rank;
2. the sequence-parallel Physics-Attention (``parallel/sequence.py``),
   the points split over the ranks;
3. the coupled batch-sharded rollout (``SimEngine`` with the process
   group: one shared dt), one simulation per rank;
4. the per-simulation sharded rollout (``parallel/rollout.py``).

Rank 0 prints one ``dryrun_multichip(N): ...`` line for each::

    python -m pbml_mantle_convection_tpu_torch.parallel.dryrun 4
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

MODULE = "pbml_mantle_convection_tpu_torch.parallel.dryrun"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dryrun(n: int, group) -> list[str]:
    """The four checks on this rank; returns rank 0's lines."""
    from ..constants import SimParams
    from ..models.fluidnet import NewFluidNet
    from ..models.transolver import PhysicsAttentionIrregularMesh
    from ..sim.engine import SimEngine
    from ..sim.grid import Grid
    from ..sim.stepper import TimeStepper
    from ..train.train_step import TrainStepConfig, make_train_step
    from ..train.trainer import adam_l2
    from .mesh import gather_rows, mesh_size, shard_batch
    from .rollout import rollout_batch_sharded
    from .sequence import physics_attention_sharded

    lines = []
    fluid = dict(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu",
                 r_p="learned", loss_type="curl", repeats=1, f=5,
                 p_pred=False, device="cpu")
    gen = torch.Generator().manual_seed(1)

    # 1. data-parallel train step, one sample per rank
    H, W = 16, 24
    model = NewFluidNet(**fluid)
    cfg = TrainStepConfig(net="newfluidnet", p_pred=False, loss_scale=True,
                          loss_derivative=True, loss_type="curl")
    step = make_train_step(model, adam_l2(model.parameters(), 1e-3), cfg,
                           process_group=group)
    batch = {"x": torch.randn(n, H, W, 7, generator=gen),
             "y": torch.randn(n, 2, H, W, generator=gen)}
    br = step(shard_batch(group, batch))
    lines.append(f"dryrun_multichip({n}): loss={float(br.total):.4f} "
                 f"mass={float(br.mass):.4f}")

    # 2. sequence-parallel attention: the points split over the ranks
    attn = PhysicsAttentionIrregularMesh(16, np.random.default_rng(2),
                                         heads=2, dim_head=8, slice_num=4)
    xs = torch.randn(1, 8 * n, 16, generator=gen)
    with torch.no_grad():
        out = physics_attention_sharded(
            attn, shard_batch(group, xs.transpose(0, 1)).transpose(0, 1),
            group, heads=2, dim_head=8)
    out = gather_rows(group, out, dim=1)
    lines.append(f"dryrun_multichip({n}): sequence-parallel attention "
                 f"ok {tuple(out.shape)}")

    # 3. coupled batch-sharded rollout, one simulation per rank
    grid = Grid(H=12, W=16)
    sp = SimParams(2.0, 1e6, 3.0)
    stepper = TimeStepper(grid, sp, NewFluidNet(**fluid, seed=3),
                          device="cpu")
    T0 = torch.as_tensor(1.0 - grid.yc, dtype=torch.float32).expand(
        n, grid.H, grid.W)
    eng = SimEngine(stepper, process_group=group)
    st, tr = eng.multi_step(eng.init_state(shard_batch(group, T0)), 3)
    lines.append(f"dryrun_multichip({n}): batch-sharded rollout ok "
                 f"meanT={float(tr.mean_T[-1]):.3f} "
                 f"devices={mesh_size(group)}")

    # 4. per-simulation rollout: each rank its own, own dt
    out = rollout_batch_sharded(SimEngine(stepper), T0, 3, group)
    lines.append(f"dryrun_multichip({n}): per-sim rollout ok "
                 f"meanT={float(out.mean_T[-1].mean()):.3f} "
                 f"devices={mesh_size(group)}")
    return lines


def _rank_main(rank: int, world: int, port: int) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        lines = _dryrun(world, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print("\n".join(lines), flush=True)


def run(n_ranks: int, timeout: float = 300.0) -> list[str]:
    """Starts ``n_ranks`` gloo processes on the CPU, waits for them,
    prints rank 0's four lines and returns them; raises if a rank
    fails."""
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", MODULE, "--rank", str(r), str(n_ranks),
         str(port)], cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True)
        for r in range(n_ranks)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"dryrun: rank exit codes {codes}")
    lines = [ln for ln in outs[0].splitlines()
             if ln.startswith("dryrun_multichip")]
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        _rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
    else:
        run(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
