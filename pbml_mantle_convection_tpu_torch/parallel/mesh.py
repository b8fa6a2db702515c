"""Process groups for data-, batch- and sequence-parallel work.

Counterpart of the JAX package's ``parallel/mesh.py``. JAX lays a 1-D
``Mesh`` over its chips and lets XLA route the collectives; here one
process drives one card (torchrun's model, the reference's DDP:
multigpu.py:16-34), and the 1-D mesh is the process group of those
processes. A mesh is that group, or None where no process group exists
(one process alone), and no collective runs. :func:`shard_batch` gives a
rank its rows of the leading axis, :func:`gather_rows` puts the ranks'
rows back together.

:func:`maybe_initialize_distributed` reads the launcher's environment
(torchrun's ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, or SLURM's
``SLURM_NTASKS``, ``SLURM_PROCID``, ``SLURM_LOCALID``, with
``MASTER_ADDR``/``MASTER_PORT``) and is a no-op for a world of one. The
backend follows from the device: NCCL on the card, each rank bound to
``cuda:{LOCAL_RANK}``, and gloo with ``device="cpu"``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"


def _env_int(*names, default: int) -> int:
    for n in names:
        if n in os.environ:
            return int(os.environ[n])
    return default


def _world() -> int:
    return _env_int("WORLD_SIZE", "SLURM_NTASKS", default=1)


def maybe_initialize_distributed(device="cuda") -> bool:
    """Initialise the default process group from the launcher's
    environment when it names a world of more than one process; returns
    whether it did (False for a world of one, or a group that already
    exists). NCCL for ``device`` "cuda", the rank bound to
    ``cuda:{LOCAL_RANK}`` first; gloo for "cpu". A one-element all-reduce
    then checks the group, so a failed NCCL initialisation raises here,
    not in the first step."""
    world = _world()
    if world <= 1 or dist.is_initialized():
        return False
    device = local_device(device)
    rank = _env_int("RANK", "SLURM_PROCID", default=0)
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, rank=rank, world_size=world, **kw)
    check = torch.ones(1, device=device)
    dist.all_reduce(check)
    if float(check) != world:
        raise RuntimeError(f"{backend}: an all-reduce over {world} ranks "
                           f"gave {float(check)}")
    return True


def local_device(device="cuda") -> torch.device:
    """The device this rank runs on: under a launcher's world of more
    than one process ``cuda:{LOCAL_RANK}`` on the card; else ``device``
    as given (its own index kept); the CPU for "cpu"."""
    device = torch.device(device)
    if device.type != "cuda" or _world() <= 1:
        return device
    return torch.device("cuda", _env_int("LOCAL_RANK", "SLURM_LOCALID",
                                         default=0))


def make_mesh(n_devices: Optional[int] = None):
    """The 1-D mesh over the world's ranks: the world's process group, or
    None when no process group exists (one process alone).
    ``n_devices``, JAX's argument, must be the world's size when
    given."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices in a world of "
                         f"{world}")
    return dist.group.WORLD if dist.is_initialized() else None


def mesh_size(mesh) -> int:
    """The number of ranks of a mesh (1 for None)."""
    return 1 if mesh is None else dist.get_world_size(mesh)


def mesh_rank(mesh) -> int:
    """This process's rank in a mesh (0 for None)."""
    return 0 if mesh is None else dist.get_rank(mesh)


def batch_sharding(mesh=None):
    """The placement of a batch over the mesh: its leading axis split
    (``torch.distributed.tensor.Shard(0)``), JAX's ``P(DATA_AXIS)``."""
    from torch.distributed.tensor import Shard
    return (Shard(0),)


def replicated_sharding(mesh=None):
    """The placement of a tensor every rank holds whole (``Replicate()``),
    JAX's ``P()``."""
    from torch.distributed.tensor import Replicate
    return (Replicate(),)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh, batch):
    """This rank's rows of the leading axis of every tensor of ``batch``
    (a tensor, or a dict, list or tuple of them): the global batch split
    into ``mesh_size`` equal blocks, in rank order."""
    n, r = mesh_size(mesh), mesh_rank(mesh)

    def rows(t):
        if t.shape[0] % n:
            raise ValueError(f"batch {t.shape[0]} not divisible by mesh "
                             f"size {n}")
        b = t.shape[0] // n
        return t[r * b:(r + 1) * b]

    return _tree_map(rows, batch)


def shard_host_local_batch(mesh, batch):
    """Each process already holds its own rows of the global batch (the
    reference's per-rank simulation lists, multigpu.py:694-707): the
    batch as given."""
    del mesh
    return batch


def gather_rows(mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The ranks' blocks of ``t`` along ``dim``, concatenated in rank
    order (every rank gets the whole); ``t`` itself for a world of one.
    ``all_gather`` takes CUDA tensors on NCCL and on gloo."""
    if mesh is None:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh_size(mesh))]
    dist.all_gather(parts, t.contiguous(), group=mesh)
    return torch.cat(parts, dim=dim)
