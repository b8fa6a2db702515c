"""Seeded inputs and weights, made on the device.

The benchmark makes every weight itself, from ``--seed``, in one draw on
the device, and hands the same tensors to the program and to the
reference. The program's own initialisation is overwritten.
"""

from __future__ import annotations

import math

import torch

# sub-streams of one run's seed
WEIGHTS, INPUTS, TRAFFIC, CHECK = range(4)


def sub_seed(seed: int, stream: int) -> int:
    """A seed for one use of ``seed``; any whole number goes in."""
    return (int(seed) * 1_000_003 + 7919 * stream) % (2 ** 63)


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g


def conv_bound(shape) -> float:
    """PyTorch's conv and linear default: U(±1/√fan_in)."""
    return 1.0 / math.sqrt(math.prod(shape[1:]))


def make_weights(shapes: dict, rule, seed: int, device,
                 dtype=torch.float32) -> dict:
    """{name: tensor} for every (name, shape) of ``shapes``: one uniform
    draw in [-1, 1) on the device, cut in the order given, each leaf
    ``centre + scale · u`` with (centre, scale) = ``rule(name, shape)``."""
    total = sum(math.prod(s) for s in shapes.values())
    g = generator(seed, WEIGHTS, device)
    flat = torch.rand(total, generator=g, device=device,
                      dtype=torch.float32).mul_(2.0).sub_(1.0)
    out, i = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        centre, scale = rule(name, tuple(shape))
        out[name] = (centre + scale * flat[i:i + n].view(shape)).to(dtype)
        i += n
    return out


def load_into(model: torch.nn.Module, weights: dict) -> None:
    """Copy ``weights`` into the model's parameters (each one, no more)."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"weights do not match the model's parameters: "
                         f"{sorted(set(params) ^ set(weights))[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
