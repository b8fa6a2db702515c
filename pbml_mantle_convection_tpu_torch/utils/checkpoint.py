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

The JAX package's Orbax backend (sharding-aware, multi-host) has no
counterpart yet (ROADMAP queue 1 item 7, with ``torch.distributed.
checkpoint``).

:func:`save_pickle` and :func:`load_pickle` write and read the rollout
drivers' pickles (``sim/rollout.py``), as the JAX module's do.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import torch


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
