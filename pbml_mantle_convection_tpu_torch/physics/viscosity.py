"""Frank-Kamenetskii viscosity law and its input featurization
(reference: pytorch_networks_convae.py:86-102, datasetio.py:25-27,
268)."""

from __future__ import annotations

import math

import torch

from ..constants import visc_feature


def _log(a):
    return torch.log(a) if isinstance(a, torch.Tensor) else math.log(a)


def fk_viscosity(gamma, beta, z, T, Tref=0.0, zref=0.0):
    """eta = exp(ln(gamma)*(Tref - T) + ln(beta)*(z - zref)).

    gamma is the temperature viscosity contrast (fkt), beta the depth
    contrast (fkp): floats, or tensors that broadcast against T (one
    value per sample, as the datasets pass them); ``z`` is the depth
    coordinate (the reference passes ``1 - yc``); ``Tref`` and ``zref``
    the reference temperature and depth (floats; 0, as the reference
    calls it).
    """
    # no subtraction at zref = 0 (z - 0 is z): the viscosity of every
    # step launches no extra elementwise kernel for it
    dz = z if zref == 0.0 else z - zref
    return torch.exp(_log(gamma) * (Tref - T) + _log(beta) * dz)


def fk_viscosity_clipped(gamma: float, beta: float, z, T, lo=1e-8, hi=1.0):
    """FK viscosity clipped to the surrogate's training range
    (reference: pytorch_networks_convae.py:389, datasetio.py:619)."""
    return torch.clamp(fk_viscosity(gamma, beta, z, T), lo, hi)


def fk_viscosity_feature(gamma, beta, z, T):
    """log10(clip(eta, 1e-8, 1)) / 8 input channel
    (reference: datasetio.py:268, pytorch_networks_convae.py:389-394)."""
    return visc_feature(fk_viscosity(gamma, beta, z, T))
