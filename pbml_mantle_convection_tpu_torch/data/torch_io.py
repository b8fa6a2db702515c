"""Loading the reference's on-disk ``.pt`` snapshot layout.

The reference stores per-simulation tensors under
``{data_dir}/{split}/sim_{id}/e1_{u,v,p,T}prev_data[_select|_select_init|
_select_snaps].pt`` plus ``times.pt``, ``xc.pt``, ``yc.pt``, an ``i_vec``
index list, and a top-level ``sims.pt`` metadata list of tuples
``(id, split, raq, fkt, fkp, grid, ar, path)`` (datasetio.py:30-60,
283-317, 425-558). This module reads that layout (on the CPU) into
:class:`SnapshotStore` arrays, for the datasets of data/dataset.py.
Counterpart of the JAX package's ``data/torch_io.py``.

The files are the reference's own pickles (``sims.pt`` is a list of
lists), which the restricted ``weights_only`` loader reads.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import IGNORE_SIM_INDICES
from .dataset import SnapshotStore


def _load_pt(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def load_sims_metadata(data_dir: str):
    """sims.pt: list of (id, split, raq, fkt, fkp, grid, ar, path)."""
    return _load_pt(os.path.join(data_dir, "sims.pt"))


def get_indices(data_dir: str, an: str, is_init: bool = False,
                debug: bool = True) -> Tuple[list, list]:
    """Per-split (sim_id, snapshot-index) enumerator — reference
    ``get_indices`` (datasetio.py:283-317)."""
    sims = load_sims_metadata(data_dir)
    sims_vec: List = []
    times_vec: List = []
    for si, sim in enumerate(sims):
        check = sim[1] == ("train" if an == "train" else "cv")
        if not check or si in IGNORE_SIM_INDICES:
            continue
        py_dir = os.path.join(data_dir, sim[1], f"sim_{sim[0]}")
        if is_init:
            i_vec = _load_pt(os.path.join(py_dir, "e1_i_vec_select_init.pt"))
        elif debug:
            u = _load_pt(os.path.join(
                py_dir, "e1_uprev_data_select_snaps.pt"))
            i_vec = np.arange(u.shape[0])
        else:
            i_vec = _load_pt(os.path.join(py_dir, "e1_i_vec_select.pt"))
        for i_prev in i_vec:
            sims_vec.append(sim[0])
            times_vec.append(i_prev)
    return sims_vec, times_vec


def get_indices_time(data_dir: str, an: str, is_init: bool = False,
                     debug: bool = True, roll_forward: int = 1
                     ) -> Tuple[list, list]:
    """Time-pair enumerator for the U-Net — reference ``get_indices_time``
    (datasetio.py:30-60)."""
    sims = load_sims_metadata(data_dir)
    sims_vec: List = []
    times_vec: List = []
    for si, sim in enumerate(sims):
        check = sim[1] == ("train" if an == "train" else "cv")
        if not check or si in IGNORE_SIM_INDICES:
            continue
        py_dir = os.path.join(data_dir, sim[1], f"sim_{sim[0]}")
        if debug:
            u = _load_pt(os.path.join(
                py_dir, "e1_uprev_data_select_init.pt"))
            times = _load_pt(os.path.join(py_dir, "times.pt"))
            times = times[: u.shape[0] * roll_forward * 2]
        else:
            times = _load_pt(os.path.join(py_dir, "times.pt"))[:750][:-2]
        for i, t in enumerate(times):
            if i < len(times) - roll_forward - 1:
                sims_vec.append(sim[0])
                times_vec.append(t)
    return sims_vec, times_vec


def load_store(
    data_dir: str,
    an: str = "train",
    is_init: bool = False,
    debug: bool = True,
    p_pred: bool = False,
    sims_filter: Optional[Sequence[int]] = None,
    variant: str = "select",
) -> SnapshotStore:
    """Load one split into a :class:`SnapshotStore`.

    ``variant``: "select" | "select_init" | "select_snaps" | "full"
    — the reference's tensor flavours (datasetio.py:425-558). ``debug``
    maps to "select_snaps" (or "select_init" with ``is_init``), mirroring
    the reference's debug mode.
    """
    sims = load_sims_metadata(data_dir)
    if is_init:
        suffix = "_select_init"
    elif debug:
        suffix = "_select_snaps"
    elif variant == "full":
        suffix = ""
    else:
        suffix = "_" + variant

    Ts, us, vs, ps = [], [], [], []
    paras, steps, sim_ids, times_all = [], [], [], []
    xc = yc = None

    for si, sim in enumerate(sims):
        sid, split, raq, fkt, fkp = sim[0], sim[1], sim[2], sim[3], sim[4]
        if split != an or si in IGNORE_SIM_INDICES:
            continue
        if sims_filter is not None and sid not in sims_filter:
            continue
        py_dir = os.path.join(data_dir, split, f"sim_{sid}")
        times = np.asarray(_load_pt(os.path.join(py_dir, "times.pt")))
        if len(times) <= 1:
            continue

        u = np.asarray(_load_pt(
            os.path.join(py_dir, f"e1_uprev_data{suffix}.pt")))
        v = np.asarray(_load_pt(
            os.path.join(py_dir, f"e1_vprev_data{suffix}.pt")))
        T = np.asarray(_load_pt(
            os.path.join(py_dir, f"e1_Tprev_data{suffix}.pt")))
        p = None
        if p_pred:
            p = np.asarray(_load_pt(
                os.path.join(py_dir, f"e1_pprev_data{suffix}.pt")))

        ivec_name = os.path.join(py_dir, f"e1_i_vec{suffix}.pt")
        if os.path.exists(ivec_name):
            i_vec = np.asarray(_load_pt(ivec_name))
        else:
            i_vec = np.arange(u.shape[0])

        if xc is None:
            xc = np.asarray(_load_pt(os.path.join(py_dir, "xc.pt")))
            yc = np.asarray(_load_pt(os.path.join(py_dir, "yc.pt")))
            xc[:, 0] = 0.0
            xc[:, -1] = 4.0
            yc[0, :] = 0.0
            yc[-1, :] = 1.0

        n = u.shape[0]
        Ts.append(T.reshape(n, *T.shape[-2:]))
        us.append(u.reshape(n, *u.shape[-2:]))
        vs.append(v.reshape(n, *v.shape[-2:]))
        if p is not None:
            ps.append(p.reshape(n, *p.shape[-2:]))
        paras.append(np.tile([raq, fkt, fkp], (n, 1)))
        steps.append(np.asarray(i_vec[:n]))
        sim_ids.append(np.full(n, sid))
        t_of = times[np.clip(np.asarray(i_vec[:n], int), 0,
                             len(times) - 1)]
        times_all.append(t_of)

    if not Ts:
        raise FileNotFoundError(
            f"no simulations found for split {an!r} in {data_dir}")

    return SnapshotStore(
        T=np.concatenate(Ts), u=np.concatenate(us), v=np.concatenate(vs),
        p=np.concatenate(ps) if ps else None,
        paras=np.concatenate(paras),
        step_index=np.concatenate(steps).astype(np.float64),
        sim_id=np.concatenate(sim_ids),
        times=np.concatenate(times_all),
        xc=xc, yc=yc)
