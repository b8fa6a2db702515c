"""The structured-mesh Transolver of a configuration file: the program's
module with the benchmark's seeded weights, and the dimensions the
reference and the counts read."""

from __future__ import annotations

import math

import torch

from ..harness.weights import conv_bound, load_into, make_weights


def weight_rule(name: str, shape: tuple):
    """(centre, scale) of a leaf's uniform draw: Dense weights with the
    standard deviation 0.02 of the published init, the conv projections
    at PyTorch's default bound, biases small, LayerNorm scales near 1,
    the temperature near its initial 0.5."""
    if name.endswith("temperature"):
        return 0.5, 0.1
    if len(shape) == 4:
        return 0.0, conv_bound(shape)
    if len(shape) == 2:
        return 0.0, 0.02 * math.sqrt(3.0)
    if ".ln_" in name and name.endswith("weight"):
        return 1.0, 0.1
    return 0.0, 0.02


def dims(cfg: dict) -> dict:
    m = dict(cfg["model"])
    m.update(H=cfg["grid"]["H"], W=cfg["grid"]["W"], space_dim=2,
             fun_dim=5, out_dim=1, kernel_proj=3)
    return m


def build(cfg: dict, seed: int, device, dtype=torch.float32):
    """(the program's Transolver with the seeded weights, the weights)."""
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
