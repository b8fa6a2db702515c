"""The NewFluidNet of a configuration file: the program's module with
the benchmark's seeded weights, and the dimensions the reference and the
counts read."""

from __future__ import annotations

import torch

from ..harness.weights import conv_bound, load_into, make_weights


def weight_rule(name: str, shape: tuple):
    """(centre, scale) of a leaf's uniform draw: the convs at PyTorch's
    default bound; the boundary biases, GroupNorm scales and shifts
    near their initial 0 and 1, so that every leaf is exercised."""
    if len(shape) == 4:
        return 0.0, conv_bound(shape)
    if name.endswith("learnable_bias"):
        return 0.0, 0.05
    if name.endswith("gn.weight") or name == "gn_0.weight":
        return 1.0, 0.1
    return 0.0, 0.1


def dims(cfg: dict) -> dict:
    return dict(cfg["model"])


def build(cfg: dict, seed: int, device, dtype=torch.float32):
    """(the program's NewFluidNet with the seeded weights, the weights)."""
    from pbml_mantle_convection_tpu_torch.models.registry import (
        ModelConfig, build_model)

    H, W = cfg["grid"]["H"], cfg["grid"]["W"]
    model = build_model(ModelConfig(**cfg["model"], H=H, W=W, dtype=dtype),
                        device=device)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    weights = make_weights(shapes, weight_rule, seed, device, dtype)
    load_into(model, weights)
    return model, weights
