"""Flax → PyTorch weight bridge for the FluidNet family.

``from_jax_params`` turns a NewFluidNet parameter tree of the JAX package
(every leaf already a numpy array, so no JAX import is needed here) into
a ``state_dict`` of this package's :class:`~..models.fluidnet.NewFluidNet`.
It is the inverse of the JAX package's ``utils/torch_convert.py``:

  conv_0/conv/{conv, conv_top, …}/kernel  → conv_0.conv.{conv, …}.weight
  conv_0/conv/learnable_bias (1,1,1,C)     → conv_0.conv.learnable_bias (C,)
  conv_0/gn/GroupNorm_0/{scale, bias}      → conv_0.gn.{weight, bias}
  convs_{l}_{r}/…, conv_1..3/…             → the same pattern
  gn_0/GroupNorm_0/{scale, bias}           → gn_0.{weight, bias}

Conv kernels go from HWIO to OIHW.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_jax_params(tree: Mapping) -> dict:
    """Flax NewFluidNet params (numpy leaves) → torch ``state_dict``."""
    if "params" in tree:
        tree = tree["params"]
    out = {}
    for path, leaf in _flatten(tree):
        a = np.asarray(leaf)
        parts = [p for p in path if p != "GroupNorm_0"]
        name = parts[-1]
        if name == "kernel":
            parts[-1] = "weight"
            a = a.transpose(3, 2, 0, 1)          # HWIO → OIHW
        elif name == "scale":
            parts[-1] = "weight"
        elif name == "learnable_bias":
            a = a.reshape(-1)
        out[".".join(parts)] = torch.tensor(a)
    return out
