"""The ViT of a configuration file (the reference's ViT baseline with a
field head): the program's module with the benchmark's seeded weights,
and the dimensions the reference and the counts read."""

from __future__ import annotations

import math

import torch

from ..harness.weights import load_into, make_weights

STD = 0.02 * math.sqrt(3.0)     # a uniform draw of standard deviation 0.02


def weight_rule(name: str, shape: tuple):
    """(centre, scale) of a leaf's uniform draw: Dense weights, the
    position embedding and the cls token with the standard deviation 0.02
    of ViT's init (so the 12 blocks stay O(1)), biases small, LayerNorm
    scales near 1."""
    if len(shape) == 2 or name.endswith(("pos_embedding", "cls_token")):
        return 0.0, STD
    if "LayerNorm" in name and name.endswith("weight"):
        return 1.0, 0.1
    return 0.0, 0.02


def patch(H: int, W: int) -> tuple:
    """The registry's patch for an H × W grid: 8 along an axis it
    divides, else 2."""
    return 8 if H % 8 == 0 else 2, 8 if W % 8 == 0 else 2


def dims(cfg: dict) -> dict:
    m = dict(cfg["model"])
    H, W = cfg["grid"]["H"], cfg["grid"]["W"]
    m.setdefault("mlp_dim", 2 * m["n_hidden"])
    m.update(H=H, W=W, patch=patch(H, W), channels=7, dim_head=64,
             c_o=3 if m.get("p_pred") else 2)
    return m


def build(cfg: dict, seed: int, device, dtype=torch.float32):
    """(the program's ViTField with the seeded weights, the weights)."""
    from pbml_mantle_convection_tpu_torch.models.registry import (
        ModelConfig, build_model)

    H, W = cfg["grid"]["H"], cfg["grid"]["W"]
    model = build_model(ModelConfig(**cfg["model"], H=H, W=W, dtype=dtype),
                        device=device)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    weights = make_weights(shapes, weight_rule, seed, device, dtype)
    load_into(model, weights)
    model.eval()
    return model, weights
