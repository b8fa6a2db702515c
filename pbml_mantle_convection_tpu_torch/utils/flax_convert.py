"""Flax → PyTorch weight bridge for the port's models.

``from_jax_params`` turns a parameter tree of the JAX package (every leaf
already a numpy array, so no JAX import is needed here) into a
``state_dict`` of this package's model of the same family: the FluidNet
family (``models/fluidnet.py``, the multi-scale ensemble's members under
``nets_{i}``), the U-Net family (``models/unet.py``: ``Unet``,
``ConvAE``), the Transolvers (``models/transolver.py``) and the ViT
(``models/vit.py``, whose modules carry Flax's automatic names). A path's
parts joined by dots name the parameter; the leaf is turned by its name
and rank:

  …/kernel, 2-D (in, out)              → ….weight (out, in)   Dense
  …/kernel, 4-D HWIO                   → ….weight OIHW        conv (a
                                          symmetric conv's (k, k, c_i,
                                          n_unique): its unique filters)
  …/kernel, 5-D DHWIO                  → ….weight OIDHW       3-D conv
  …/in_project_{fx,x}_kernel, 5-D DHWIO → the same name, OIDHW (3-D conv)
  …/scale                              → ….weight   GroupNorm, LayerNorm
  …/learnable_bias (1,1,1,C)           → …, (C,)
  GroupNorm_0 path parts                 are dropped
  anything else (bias, temperature, placeholder, the 3-D ``_bias``, the
  spectral conv's ``weights{1,2}_{real,imag}``, the ViT's
  ``pos_embedding`` and ``cls_token``) as it is.

It is the inverse of the JAX package's ``utils/torch_convert.py`` on the
FluidNet family. Each leaf keeps its type: a bfloat16 leaf (numpy's
``bfloat16`` from ``ml_dtypes``, which torch cannot read directly) crosses
as its bits and becomes a ``torch.bfloat16`` tensor.
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


def _leaf(name: str, a: np.ndarray) -> tuple[str, np.ndarray]:
    if name == "kernel":
        if a.ndim == 2:
            return "weight", a.T
        if a.ndim == 4:
            return "weight", a.transpose(3, 2, 0, 1)
        if a.ndim == 5:
            return "weight", a.transpose(4, 3, 0, 1, 2)
        raise ValueError(f"a {a.ndim}-D 'kernel' leaf has no torch layout")
    if name.endswith("_kernel") and a.ndim == 5:
        return name, a.transpose(4, 3, 0, 1, 2)
    if name == "scale":
        return "weight", a
    if name == "learnable_bias":
        return name, a.reshape(-1)
    return name, a


def from_jax_params(tree: Mapping) -> dict:
    """Flax params (numpy leaves) → torch ``state_dict``."""
    if "params" in tree:
        tree = tree["params"]
    out = {}
    for path, leaf in _flatten(tree):
        parts = [p for p in path if p != "GroupNorm_0"]
        parts[-1], a = _leaf(parts[-1], np.asarray(leaf))
        out[".".join(parts)] = _tensor(np.ascontiguousarray(a))
    return out


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.tensor(a)
