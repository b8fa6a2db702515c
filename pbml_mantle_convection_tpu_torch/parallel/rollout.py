"""Batch-sharded multi-simulation rollouts: each rank its own simulations.

Counterpart of the JAX package's ``parallel/rollout.py``. The coupled
batched rollout (``sim/engine.py``) advances a batch with ONE shared CFL
dt. For parameter sweeps (the reference launches independent GAIA
processes per parameter set, multigpu.py:694-759) each simulation runs
on its own instead:

* every rank takes its B / world rows of the global initial fields and
  runs each of them at B = 1 through ``engine.init_state`` +
  ``engine.multi_step``, one after another (JAX's ``lax.map`` at a local
  batch above 1), so on the card each simulation-step is the fused
  executor's 4 ``layer_stack`` + 1 ``trunk`` + 1 ``curl_advect_epilogue``
  launches (+ 1 ``advect_diffuse_step_fused`` in place of the epilogue
  for the heads it does not take: ``blurr``, ``p_pred``, ``mae``/
  ``mass``, whose p each simulation's state carries);
* each simulation advances with its OWN dt, the same bits as a
  standalone B = 1 rollout of it;
* no collective runs during the rollout; at its end one ``all_gather``
  per result field gives every rank the global arrays.

The engine must have no process group (its simulations are not
coupled). Coupled batch sharding is ``SimEngine(..., process_group=...)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .mesh import gather_rows, mesh_size, shard_batch


class ShardedRollout(NamedTuple):
    """Per-simulation results: (B, H, W) fields, (B,) per-simulation
    clocks (each simulation has its own, unlike the coupled batch's
    0-d ``SimState.t``/``dt``), an (n_steps, B) mean-T trace."""

    T: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor
    V: torch.Tensor
    t: torch.Tensor       # (B,) per-simulation time
    dt: torch.Tensor      # (B,) per-simulation last dt
    mean_T: torch.Tensor  # (n_steps, B)


def _check_divisible(B: int, n: int) -> None:
    if B % n:
        raise ValueError(f"batch {B} not divisible by mesh size {n}")


def make_batch_sharded(engine, n_steps: int, mesh):
    """The rollout as one callable ``f(T0) -> tuple`` (the raw
    :class:`ShardedRollout` fields, global on every rank), built once so
    a benchmark reuses it across its warm-up and timed calls. ``T0`` is
    the global (B, H, W) initial temperature, B divisible by the mesh
    size; each rank reads its own rows of it."""
    if engine.group is not None:
        raise ValueError("make_batch_sharded: the engine has a process "
                         "group (a coupled rollout); the per-simulation "
                         "rollout takes an engine of its own")

    def f(T0):
        T0 = torch.as_tensor(T0, dtype=engine.dtype, device=engine.device)
        _check_divisible(T0.shape[0], mesh_size(mesh))
        outs = []
        for T0_i in shard_batch(mesh, T0):
            st, tr = engine.multi_step(engine.init_state(T0_i[None]),
                                       n_steps)
            outs.append((st.T[0], st.u[0], st.v[0], st.p[0], st.V[0],
                         st.t, st.dt, tr.mean_T))
        local = [torch.stack(x) for x in zip(*outs)]
        local[7] = local[7].transpose(0, 1).contiguous()   # (n_steps, b)
        return tuple(gather_rows(mesh, x, dim=1 if i == 7 else 0)
                     for i, x in enumerate(local))

    return f


def rollout_batch_sharded(engine, T0, n_steps: int,
                          mesh) -> ShardedRollout:
    """Advance B independent simulations, B / mesh size per rank; ``T0``
    (B, H, W) with B divisible by the mesh size. Every rank returns the
    global results."""
    _check_divisible(len(T0), mesh_size(mesh))
    return ShardedRollout(*make_batch_sharded(engine, n_steps, mesh)(T0))
