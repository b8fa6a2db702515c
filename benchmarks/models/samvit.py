"""SAM's ViT image encoder of a configuration file (with a field head):
the program's module with the benchmark's seeded weights, and the
dimensions the reference and the counts read."""

from __future__ import annotations

import torch

from ..harness.weights import conv_bound, load_into, make_weights
from .vit import STD, patch


def weight_rule(name: str, shape: tuple):
    """(centre, scale) of a leaf's uniform draw: Linear weights and the
    position embedding with the standard deviation 0.02 of ViT's init (so
    the 12 blocks stay O(1)), the convolutions at PyTorch's default
    bound, the relative-position tables at a standard deviation of 0.1
    (SAM starts them at zero; trained, they move the scores by O(0.1)),
    biases small, LayerNorm scales near 1."""
    if "rel_pos" in name:
        return 0.0, 0.1 * 3.0 ** 0.5
    if len(shape) == 2 or name == "pos_embed":
        return 0.0, STD
    if len(shape) == 4:
        return 0.0, conv_bound(shape)
    if "norm" in name or name.startswith("neck."):
        if name.endswith("weight"):
            return 1.0, 0.1
    return 0.0, 0.02


def global_blocks(depth: int) -> tuple:
    """SAM's rule: the last block of each quarter of the depth."""
    return tuple(sorted({(i + 1) * depth // 4 - 1 for i in range(4)}
                        - {-1}))


def dims(cfg: dict) -> dict:
    m = dict(cfg["model"])
    H, W = cfg["grid"]["H"], cfg["grid"]["W"]
    m.setdefault("mlp_dim", 4 * m["n_hidden"])
    m.setdefault("window_size", 14)
    m.setdefault("neck_chans", 256)
    g = m.get("global_attn_indexes")
    m["global_attn_indexes"] = tuple(global_blocks(m["n_layers"])
                                     if g is None else g)
    m.update(H=H, W=W, patch=patch(H, W), channels=7,
             dim_head=m["n_hidden"] // m["n_head"],
             c_o=3 if m.get("p_pred") else 2)
    return m


def build(cfg: dict, seed: int, device, dtype=torch.float32):
    """(the program's SamViTField with the seeded weights, the
    weights)."""
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
