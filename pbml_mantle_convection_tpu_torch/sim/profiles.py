"""Steady-state T(z) profile predictor (the "ml_prof" MLP).

The port's own copy of the JAX package's ``sim/profiles.py``: the
reference's pure-NumPy inference of a 5×128 SELU MLP with residual
accumulation and an input re-concat before the last hidden layer,
predicting the horizontally-averaged steady-state temperature profile
from (raq_nd, fkt_nd, fkp_nd, y) (calculate_profiles.py:57-134). It stays
in numpy on the host, as in JAX: a 5×128 MLP over 128 points. The
trained weights ship as ``assets/profile_mlp.npz``, a byte-identical copy
of the JAX package's asset (converted from the reference's
``mlp_[128, 128, 128, 128, 128].pkl``: pure weight data).

The predicted profile seeds GAIA-compatible runs via ``ml_prof.txt``
(ReadASCII initialization, prepare_gaia_ini.py:100) and the "perfect"
initialization of the rollout CLI.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from ..constants import nondim_fkp, nondim_fkt, nondim_raq

_ASSET = os.path.join(os.path.dirname(__file__), "assets",
                      "profile_mlp.npz")


def _selu(x):
    alpha = 1.6732632423543772848170429916717
    scale = 1.0507009873554804934193349852946
    return scale * (np.maximum(0, x) + np.minimum(alpha * (np.expm1(x)), 0))


def load_mlp(path: Optional[str] = None):
    """Load the profile MLP as a list of (W, b) pairs."""
    z = np.load(path or _ASSET)
    n = len(z.files) // 2
    return [(z[f"W{i}"], z[f"b{i}"]) for i in range(n)]


def profile_inputs(raq_list, fkt_list, fkp_list, y_prof) -> np.ndarray:
    """(n_sims * n_y, 4) non-dimensionalized MLP inputs
    (calculate_profiles.py:41-54)."""
    rows = []
    for r, t, v in zip(raq_list, fkt_list, fkp_list):
        for y in y_prof:
            rows.append([nondim_raq(r), nondim_fkt(t), nondim_fkp(v), y])
    return np.asarray(rows, np.float64)


def predict_profile(inp: np.ndarray, mlp=None, num_sims: int = 1,
                    correction: bool = True) -> np.ndarray:
    """Forward pass with residual accumulation + boundary-layer correction
    (calculate_profiles.py:57-99).

    The architecture quirk is preserved: each hidden activation is added to
    every later pre-activation, and the raw input is concatenated onto the
    features entering the last hidden layer; boundary rows are overwritten
    (T=1 at y-index 0, T=0 at the end) and the thermal boundary layers are
    linearly corrected below y<0.04 / above y>0.985.
    """
    mlp = mlp or load_mlp()
    num_layers = len(mlp) - 1
    y = inp
    res = []
    for l, (W, b) in enumerate(mlp):
        y = y @ W.T + b
        if l == num_layers - 1:
            y = np.concatenate((inp, y), axis=-1)
        if l != num_layers:
            for r in res:
                y = y + r
            y = _selu(y)
            res.append(y)

    y = y.reshape(num_sims, -1)
    y[:, 0] = 1.0
    y[:, -1] = 0.0

    if correction:
        inp_r = inp.reshape(num_sims, -1, inp.shape[-1])
        for s in range(num_sims):
            yy = inp_r[s, :, 3]
            inds = np.where(yy < 0.04)[0]
            if len(inds):
                slope = (0.0 - y[s, inds[0]]) / (0.0 - yy[inds[0]])
                y[s, inds] = slope * yy[inds]
            inds = np.where(yy > 0.985)[0]
            if len(inds):
                x_old = [yy[inds[-1]], 1.0]
                y_old = [y[s, inds[-1]], 1.0]
                y[s, inds] = np.interp(yy[inds], x_old, y_old)
    return y


def calc_mlp_profile(
    raq_list: Sequence[float], fkt_list: Sequence[float],
    fkp_list: Sequence[float], simulation_dir: Optional[str] = None,
    num_points: int = 128,
) -> Tuple[np.ndarray, np.ndarray]:
    """Predict profiles and (optionally) write ``ml_prof.txt``
    (calculate_profiles.py:102-134). y_prof runs top-to-bottom:
    [1, cell centres reversed, 0]."""
    y_prof = np.concatenate((
        [1.0],
        np.linspace(1.0 / (num_points * 2), 1 - 1.0 / (num_points * 2),
                    num_points - 2)[::-1],
        [0.0]))
    x_in = profile_inputs(raq_list, fkt_list, fkp_list, y_prof)
    y_pred = predict_profile(x_in, num_sims=len(raq_list))

    if simulation_dir is not None:
        path = os.path.join(simulation_dir, "ml_prof.txt")
        with open(path, "w") as f:
            for i in range(len(raq_list)):
                for j in range(len(y_prof)):
                    f.write(f"{y_prof[j]}   {y_pred[i, j]}\n")
    return y_pred, y_prof
