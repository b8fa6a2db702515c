"""Normalization and physics constants of the mantle-convection setup.

The values are kept bit-for-bit equal to the JAX package's
``pbml_mantle_convection_tpu/constants.py`` so rollouts of the two packages
stay numerically comparable (reference: scaler.py:4-36,
datasetio.py:124-136, calculate_profiles.py:13-38).

The scaling law, the non-dimensionalizations and their inverses take
Python floats or numpy arrays; :func:`visc_feature` works on a torch tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Velocity scaling law (reference: scaler.py:4-36, datasetio.py:239-246):
#   scaler = exp((raq/10)*A + ln(fkt)*B - ln(fkp)*C) * 5
SCALER_RAQ_COEFF = 1.80167667
SCALER_FKT_COEFF = 0.4330392
SCALER_FKP_COEFF = -0.46052953
SCALER_PREFACTOR = 5.0

# Parameter non-dimensionalization (reference: datasetio.py:124-136).
RAQ_MIN = 0.12624371
RAQ_MAX = 9.70723344
LOG10_FKT_MIN = 6.00352841978384
LOG10_FKT_MAX = 9.888820429862925
LOG10_FKP_MIN = 0.005251646002323797
LOG10_FKP_MAX = 1.9927988938926755

# Viscosity input-channel featurization (reference: datasetio.py:268).
VISC_CLIP_MIN = 1e-8
VISC_CLIP_MAX = 1.0
VISC_LOG_SCALE = 8.0

# Coordinate featurization: xc/4, yc/4 (reference: datasetio.py:630-632).
COORD_SCALE = 4.0

# Default grid (reference: prepare_gaia_ini.py:23-26): 126 interior
# layers at aspect ratio 4 → 128 rows × 506 cols with the boundary ones.
GRID_H = 128
GRID_W = 506
ASPECT_RATIO = 4.0
N_LAYERS = 126  # interior layers; dx = 1/126 (advect_wi_gaia.py:739)

# Simulations the reference drops from every split (datasetio.py:33, 96).
IGNORE_SIM_INDICES = (8, 39)

# Per-snapshot time weight 6/(i+1)^0.25 (reference: datasetio.py:472).
T_WEIGHT_NUM = 6.0
T_WEIGHT_POW = 0.25


def velocity_scaler(raq, fkt, fkp):
    """Convective-velocity scaling law (reference: scaler.py:4-36)."""
    return (
        np.exp(
            (raq / 10.0) * SCALER_RAQ_COEFF
            + np.log(fkt) * SCALER_FKT_COEFF
            + np.log(fkp) * SCALER_FKP_COEFF
        )
        * SCALER_PREFACTOR
    )


def _scaler(x, raq, fkt, fkp):
    """The scaling law's value(s) in ``x``'s kind: a float, an array, or
    a tensor of ``x``'s dtype and device."""
    s = velocity_scaler(raq, fkt, fkp)
    if np.ndim(s) == 0:
        return float(s)
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(s, dtype=x.dtype, device=x.device)
    return s


def scale_var(x, raq, fkt, fkp, var):
    """Scale a variable by the velocity scaling law (reference:
    scaler.py:4-36): ``uprev`` / ``vprev`` are divided by it; p, V and T
    pass through unchanged. ``x`` is a numpy array or a tensor, the
    parameters floats or arrays that broadcast against it; nothing is
    changed in place."""
    if var in ("uprev", "vprev"):
        return x / _scaler(x, raq, fkt, fkp)
    return x


def unscale_var(x, raq, fkt, fkp, var):
    """Inverse of :func:`scale_var` (reference: scaler.py:39-71)."""
    if var in ("uprev", "vprev"):
        return x * _scaler(x, raq, fkt, fkp)
    return x


def nondim_raq(raq):
    """raq → [0, 1] (reference: datasetio.py:124-126)."""
    return (raq - RAQ_MIN) / (RAQ_MAX - RAQ_MIN)


def nondim_fkt(fkt):
    """log10(fkt) → [0, 1] (reference: datasetio.py:127-131)."""
    return (np.log10(fkt) - LOG10_FKT_MIN) / (LOG10_FKT_MAX - LOG10_FKT_MIN)


def nondim_fkp(fkp):
    """log10(fkp) → [0, 1] (reference: datasetio.py:132-136)."""
    return (np.log10(fkp) - LOG10_FKP_MIN) / (LOG10_FKP_MAX - LOG10_FKP_MIN)


def dim_raq(x):
    """Inverse of :func:`nondim_raq` (reference:
    calculate_profiles.py:27-28)."""
    return x * (RAQ_MAX - RAQ_MIN) + RAQ_MIN


def dim_fkt(x):
    """Inverse of :func:`nondim_fkt` (reference:
    calculate_profiles.py:31-32)."""
    return 10.0 ** (x * (LOG10_FKT_MAX - LOG10_FKT_MIN) + LOG10_FKT_MIN)


def dim_fkp(x):
    """Inverse of :func:`nondim_fkp` (reference:
    calculate_profiles.py:35-38)."""
    return 10.0 ** (x * (LOG10_FKP_MAX - LOG10_FKP_MIN) + LOG10_FKP_MIN)


def visc_feature(V: torch.Tensor) -> torch.Tensor:
    """log10(clip(V, 1e-8, 1)) / 8 viscosity input channel
    (reference: datasetio.py:268, 619-634)."""
    return torch.log10(torch.clamp(V, VISC_CLIP_MIN, VISC_CLIP_MAX)) \
        / VISC_LOG_SCALE


@dataclasses.dataclass(frozen=True)
class SimParams:
    """The (raq, fkt, fkp) control-parameter triple of one simulation:
    internal-heating Rayleigh number, Frank-Kamenetskii temperature and
    depth viscosity contrasts."""

    raq: float
    fkt: float
    fkp: float

    @property
    def raq_nd(self) -> float:
        return float(nondim_raq(self.raq))

    @property
    def fkt_nd(self) -> float:
        return float(nondim_fkt(self.fkt))

    @property
    def fkp_nd(self) -> float:
        return float(nondim_fkp(self.fkp))

    @property
    def scaler(self) -> float:
        return float(velocity_scaler(self.raq, self.fkt, self.fkp))
