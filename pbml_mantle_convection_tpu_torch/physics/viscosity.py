"""Frank-Kamenetskii viscosity law (reference:
pytorch_networks_convae.py:86-102, datasetio.py:25-27)."""

from __future__ import annotations

import math

import torch


def fk_viscosity(gamma: float, beta: float, z, T):
    """eta = exp(ln(gamma)*(-T) + ln(beta)*z).

    gamma is the temperature viscosity contrast (fkt), beta the depth
    contrast (fkp) and ``z`` the depth coordinate (the reference passes
    ``1 - yc``).
    """
    return torch.exp(math.log(gamma) * (0.0 - T) + math.log(beta) * z)


def fk_viscosity_clipped(gamma: float, beta: float, z, T, lo=1e-8, hi=1.0):
    """FK viscosity clipped to the surrogate's training range
    (reference: pytorch_networks_convae.py:389, datasetio.py:619)."""
    return torch.clamp(fk_viscosity(gamma, beta, z, T), lo, hi)
