"""Snapshot-selection preprocessing pipeline.

Counterpart of the JAX package's ``data/preprocess.py``. Programmatic
equivalent of the reference's ``preprocess.ipynb`` (cells
2-4): per simulation, select all of steps 1-199 plus ≤500 random samples
from the tail, take the first 5 as the "init" set, and write the
``*_select{_init}.pt``-style tensors plus the ``i_vec`` index lists. Here
the output is ``.npz`` per simulation, and the dt-range scan is a
function.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .dataset import SnapshotStore, select_snapshot_indices


def split_select_init(store: SnapshotStore, rng: np.random.Generator
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sim selection: returns (select_idx, init_idx) into the store
    (preprocess.ipynb cell 2 semantics via select_snapshot_indices)."""
    sel_all = []
    init_all = []
    for s in np.unique(store.sim_id):
        where = np.nonzero(store.sim_id == s)[0]
        n_times = len(where) + 2
        sel = select_snapshot_indices(n_times, rng, is_init=False)
        init = select_snapshot_indices(n_times, rng, is_init=True)
        sel = sel[sel - 1 < len(where)]
        init = init[init - 1 < len(where)]
        sel_all.append(where[sel - 1])   # i_vec counts from step 1
        init_all.append(where[init - 1])
    return np.concatenate(sel_all), np.concatenate(init_all)


def write_selected(store: SnapshotStore, out_dir: str,
                   rng: Optional[np.random.Generator] = None) -> Dict:
    """Write per-sim selected/init npz files in the reference's directory
    shape (``sim_{id}/e1_*_select*.npz``)."""
    rng = rng or np.random.default_rng(0)
    manifest = {}
    for s in np.unique(store.sim_id):
        where = np.nonzero(store.sim_id == s)[0]
        sub = {k: getattr(store, k)[where]
               for k in ("T", "u", "v", "step_index", "times")}
        n_times = len(where) + 2
        sel = select_snapshot_indices(n_times, rng)
        init = select_snapshot_indices(n_times, rng, is_init=True)
        sel = sel[sel - 1 < len(where)] - 1
        init = init[init - 1 < len(where)] - 1

        sim_dir = os.path.join(out_dir, f"sim_{int(s)}")
        os.makedirs(sim_dir, exist_ok=True)
        np.savez_compressed(
            os.path.join(sim_dir, "e1_select.npz"),
            T=sub["T"][sel], u=sub["u"][sel], v=sub["v"][sel],
            i_vec=sub["step_index"][sel], times=sub["times"][sel])
        np.savez_compressed(
            os.path.join(sim_dir, "e1_select_init.npz"),
            T=sub["T"][init], u=sub["u"][init], v=sub["v"][init],
            i_vec=sub["step_index"][init], times=sub["times"][init])
        manifest[int(s)] = {"n_select": len(sel), "n_init": len(init)}
    return manifest


def scan_dt_range(times: Sequence[np.ndarray]) -> Tuple[float, float]:
    """Global (min, max) dt across simulations (preprocess.ipynb cell 4)."""
    dts = np.concatenate([np.diff(np.asarray(t)) for t in times])
    dts = dts[dts > 0]
    return float(dts.min()), float(dts.max())
