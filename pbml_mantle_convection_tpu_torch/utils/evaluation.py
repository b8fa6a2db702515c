"""Evaluation utilities: error sweeps, rollout comparisons, correlations.

Counterpart of the JAX package's ``utils/evaluation.py``: programmatic
equivalents of the reference's evaluation notebooks (load_fluidnet.ipynb
cells 2-7: model-zoo MAE sweeps and the inference-latency harness;
load_advection_results-checkpoint.ipynb: rollout comparisons against
GAIA, Pearson correlations, per-study ablations). The comparisons are
numpy, as in JAX; :func:`model_error_sweep` runs over the port's
datasets (``data/dataset.py``) and :func:`inference_latency` times a
forward on its tensors' device.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def field_mae(pred, true) -> float:
    return float(np.mean(np.abs(_np(pred) - _np(true))))


@torch.no_grad()
def model_error_sweep(apply_fn: Callable, dataset, batch_size: int = 8,
                      max_batches: Optional[int] = None,
                      rng: Optional[np.random.Generator] = None) -> Dict:
    """Per-channel MAE over a dataset (load_fluidnet.ipynb cells 2-5).

    apply_fn: x → (u, v, p|None). Returns {"u": mae, "v": mae, "p": mae}.
    """
    rng = rng or np.random.default_rng(0)
    sums = {"u": 0.0, "v": 0.0, "p": 0.0}
    n = 0
    for i, batch in enumerate(dataset.epoch_batches(rng, batch_size)):
        if max_batches is not None and i >= max_batches:
            break
        u, v, p = apply_fn(batch["x"])
        y = _np(batch["y"])
        sums["u"] += field_mae(u, y[:, 0])
        sums["v"] += field_mae(v, y[:, 1])
        if p is not None and y.shape[1] > 2:
            sums["p"] += field_mae(p, y[:, 2])
        n += 1
    return {k: v / max(n, 1) for k, v in sums.items()}


def _sync(x) -> None:
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


@torch.no_grad()
def inference_latency(apply_fn: Callable, x, iters: int = 500) -> float:
    """Mean forward latency over ``iters`` passes (the reference's
    500-pass harness, load_fluidnet.ipynb cell 7): one warm-up forward,
    then ``iters`` forwards between two synchronizations of ``x``'s card.
    Returns seconds."""
    apply_fn(x)
    _sync(x)
    t0 = time.perf_counter()
    for _ in range(iters):
        apply_fn(x)
    _sync(x)
    return (time.perf_counter() - t0) / iters


def pearson(a, b) -> float:
    """Pearson correlation between two flattened fields
    (load_advection_results-checkpoint.ipynb cell 4)."""
    a = _np(a).reshape(-1)
    b = _np(b).reshape(-1)
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / denom) if denom > 0 else 0.0


def compare_rollouts(t_a: Sequence[float], T_a: Sequence[float],
                     t_b: Sequence[float], T_b: Sequence[float],
                     n_points: int = 200) -> Dict:
    """Compare two mean-temperature traces on a common time axis
    (the reference's GAIA-vs-ML T_vec comparisons). Returns RMSE / max
    deviation / Pearson r of the resampled traces."""
    t_a = np.asarray(t_a, np.float64)
    t_b = np.asarray(t_b, np.float64)
    t_end = min(t_a[-1], t_b[-1])
    ts = np.linspace(0, t_end, n_points)
    Ta = np.interp(ts, t_a, np.asarray(T_a, np.float64))
    Tb = np.interp(ts, t_b, np.asarray(T_b, np.float64))
    return {
        "rmse": float(np.sqrt(np.mean((Ta - Tb) ** 2))),
        "max_abs": float(np.max(np.abs(Ta - Tb))),
        "pearson": pearson(Ta, Tb),
        "t_end": float(t_end),
    }


def temperature_rmse(T_pred, T_true) -> float:
    """Field RMSE, the north-star accuracy metric (BASELINE.md)."""
    d = _np(T_pred).astype(np.float64) - _np(T_true).astype(np.float64)
    return float(np.sqrt(np.mean(d * d)))


def speedup_table(ts_vecs: Dict[str, Sequence[float]]) -> Dict[str, Dict]:
    """Per-mode wall-time stats from TS_vec traces, the reference's
    speedup study (load_advection_results-checkpoint.ipynb cell 5)."""
    out = {}
    base = None
    for mode, ts in ts_vecs.items():
        ts = np.asarray(ts, np.float64)
        out[mode] = {"mean_s": float(ts.mean()),
                     "steps_per_s": float(1.0 / ts.mean())}
        if mode == "GAIA":
            base = ts.mean()
    if base:
        for mode in out:
            out[mode]["speedup_vs_gaia"] = float(base / np.asarray(
                ts_vecs[mode], np.float64).mean())
    return out
