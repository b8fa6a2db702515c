"""Checkpoints of the full train state: model, optimizer, epoch.

Counterpart of the JAX package's default (msgpack) backend in
``utils/checkpoint.py``, which upgrades the reference's model-only
``state_dict`` checkpoints (multigpu.py:412-436: no optimizer state,
resume rebuilds the LR schedule from the loss log). Here a checkpoint is
one ``torch.save`` file of ``{"model": state_dict, "optimizer":
state_dict, "epoch": int}``: tensors, numbers, strings and plain
containers only, so :func:`restore_checkpoint` reads it with the
restricted ``weights_only`` loader. It is written to a temporary file
and renamed, so a reader never sees half a checkpoint.

The JAX package's Orbax backend (sharding-aware, multi-host
directories) is ported on ``torch.distributed.checkpoint``:
:func:`save_checkpoint_distributed` writes a directory (an existing one
is replaced, Orbax's ``force=True``), with or without a process group:
in a group every rank writes its share and rank 0 the metadata.
:func:`restore_checkpoint_distributed` reads it into a target, whose
structure, dtypes and devices the result follows (each rank loads the
tensors in place), or, with no target, into the tree the metadata
records: tensors on the CPU and every dict key a string (an optimizer's
integer parameter ids become "0", "1", ...).

:func:`save_pickle` and :func:`load_pickle` write and read the rollout
drivers' pickles (``sim/rollout.py``), as the JAX module's do.
"""

from __future__ import annotations

import os
import pickle
import shutil
from typing import Any, Optional

import torch
import torch.distributed as dist


def save_checkpoint(path: str, state: Any) -> None:
    """``torch.save`` of ``state`` to ``path``, atomically (a temporary
    file, then a rename)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, device="cpu") -> Any:
    """The state saved by :func:`save_checkpoint`, its tensors on
    ``device``. The default, the CPU, is what ``load_state_dict`` of a
    module and of an optimizer expect: both move the tensors onto their
    parameters' device, and a (non-capturable) Adam keeps its step counts
    on the host."""
    return torch.load(path, map_location=device, weights_only=True)


def _barrier(group) -> None:
    if dist.is_initialized():
        dist.barrier(group=group)


def save_checkpoint_distributed(path: str, state: Any,
                                process_group=None) -> None:
    """``torch.distributed.checkpoint.save`` of ``state`` (nested dicts
    and lists of tensors and plain values) into the directory ``path``,
    replacing an existing one. With a process group initialised, every
    rank of ``process_group`` (default: the world) calls it with its own
    ``state``; alone, it writes from this process."""
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    lead = not dist.is_initialized() or dist.get_rank(process_group) == 0
    if lead and os.path.exists(path):
        shutil.rmtree(path)
    _barrier(process_group)
    dcp.save(state, checkpoint_id=path, process_group=process_group)
    _barrier(process_group)


def _set(root: dict, path: tuple, value) -> None:
    """Puts ``value`` at ``path`` (str keys, int list indices) under
    ``root``, making the dicts and lists on the way."""
    node = root
    for part, nxt in zip(path, path[1:]):
        if isinstance(part, int):
            node.extend([None] * (part + 1 - len(node)))
            if node[part] is None:
                node[part] = [] if isinstance(nxt, int) else {}
        else:
            node.setdefault(part, [] if isinstance(nxt, int) else {})
        node = node[part]
    if isinstance(path[-1], int):
        node.extend([None] * (path[-1] + 1 - len(node)))
    node[path[-1]] = value


def restore_checkpoint_distributed(path: str, target: Optional[Any] = None,
                                   process_group=None) -> Any:
    """The state saved by :func:`save_checkpoint_distributed`. With a
    ``target`` (the structure saved, e.g. a freshly built train state),
    its tensors are loaded in place and it is returned, in its own
    dtypes and devices; its plain values are replaced by the saved ones.
    Without one, the saved tree is rebuilt from the metadata, tensors on
    the CPU."""
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    if target is None:
        from torch.distributed.checkpoint.metadata import (
            TensorStorageMetadata)
        md = dcp.FileSystemReader(path).read_metadata()
        flat = {}
        for key, meta in md.state_dict_metadata.items():
            if isinstance(meta, TensorStorageMetadata):
                flat[key] = torch.empty(tuple(meta.size),
                                        dtype=meta.properties.dtype)
            else:
                flat[key] = None
        # the saved keys, flat: the planner loads the plain values into
        # this dict itself (no flattening copy of it)
        dcp.load(flat, checkpoint_id=path, process_group=process_group,
                 planner=dcp.DefaultLoadPlanner(
                     flatten_state_dict=False,
                     flatten_sharded_tensors=False))
        tree: dict = {}
        for key, value in flat.items():
            _set(tree, tuple((md.planner_data or {}).get(key, (key,))),
                 value)
        return tree
    dcp.load(target, checkpoint_id=path, process_group=process_group)
    return target


def save_pickle(path: str, obj: Any) -> None:
    """Rollout snapshot pickles (the reference's periodic dumps,
    advect_wi_gaia.py:659-668). ``obj`` holds numpy arrays and Python or
    numpy scalars only, so a reader needs no torch."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)
