"""Datasets: snapshot stores with batch assembly on the device.

Counterpart of the JAX package's ``data/dataset.py`` (reference:
datasetio.py). Snapshots are kept as compact arrays (T, u, v[, p],
params), and each batch's 7-11 input channels are assembled with torch
ops on the batch's device, not per sample on the host as the reference's
``__getitem__`` does (datasetio.py:595-654).

Two residency modes, chosen by store size against
``PMC_DEVICE_STORE_BYTES`` (default 32 GiB):

* **device-resident**: the whole store is moved to the device once; a
  batch is one indexed gather plus the assembly, with no host traffic.
* **host-resident** (reference scale: 96 simulations × ~700 snapshots of
  128×506 are 50-70 GB): the store stays NumPy (plain or ``np.memmap``);
  a worker thread (``data/prefetch.py``) gathers each batch's rows on the
  host, copies them to the device synchronously, and runs the same
  assembly, up to ``prefetch`` batches ahead of the train step.

Every draw from the numpy ``Generator`` happens in the JAX package's
order (the epoch permutation, then one ``integers(0, 2**31)`` per batch),
so a seed gives the same indices as there. That integer seeds the batch's
noise through its own ``torch.Generator``; the noise values differ from
``jax.random``'s. Both modes run one assembly function, so they give the
same bits for the same indices.

Datasets: :class:`SnapshotDataset` (reference ``NewADDataset``),
:class:`UnstructuredDataset` and :class:`ConvAEDataset` (the JAX
package's reconstructions of the reference's lost classes), and
:class:`TimePairDataset` (reference ``ADTimeDataset``, with its
every-8th init-pair remap).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..constants import (
    COORD_SCALE, T_WEIGHT_NUM, T_WEIGHT_POW, nondim_fkp, nondim_fkt,
    nondim_raq, velocity_scaler, visc_feature)
from ..physics.viscosity import fk_viscosity
from .prefetch import prefetch_iter

# Stores whose big fields exceed this stay host-resident and are fed per
# batch; below it the whole store moves to the device once. An H100 has
# 80 GB: 32 GiB of store leaves ~48 GB for the model, the optimizer
# state, the activations of a train step (the Transolver's slice weights
# are ~0.5 GB per block at B = 8 on 128×506) and the assembled batches;
# the reference's full training split (50-70 GB) stays on the host.
# PMC_DEVICE_STORE_BYTES overrides it.
_DEVICE_STORE_BYTES_DEFAULT = 32 << 30

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _device_store_limit() -> int:
    env = os.environ.get("PMC_DEVICE_STORE_BYTES")
    return int(env) if env else _DEVICE_STORE_BYTES_DEFAULT


@dataclasses.dataclass
class SnapshotStore:
    """Compact per-snapshot arrays for one or more simulations.

    All arrays are stacked over the snapshot axis N:
      T, u, v: (N, H, W); p: (N, H, W) or None;
      paras: (N, 3) = (raq, fkt, fkp); step_index: (N,) the snapshot's
      time-step index i (for the 6/(i+1)^0.25 weight, datasetio.py:472);
      sim_id: (N,) integer simulation id; times: (N,) physical time.
    xc, yc: (H, W) coordinates (boundary-clamped).
    """

    T: np.ndarray
    u: np.ndarray
    v: np.ndarray
    p: Optional[np.ndarray]
    paras: np.ndarray
    step_index: np.ndarray
    sim_id: np.ndarray
    times: np.ndarray
    xc: np.ndarray
    yc: np.ndarray

    def __len__(self):
        return self.T.shape[0]

    def field_nbytes(self, itemsize: int = 4) -> int:
        """Bytes the big per-snapshot fields (T, u, v[, p]) take at the
        given item size: what decides device or host residency."""
        n_fields = 3 + (1 if self.p is not None else 0)
        return int(np.prod(self.T.shape)) * itemsize * n_fields

    @property
    def paras_nd(self) -> np.ndarray:
        raq, fkt, fkp = self.paras[:, 0], self.paras[:, 1], self.paras[:, 2]
        return np.stack([nondim_raq(raq), nondim_fkt(fkt), nondim_fkp(fkp)],
                        axis=1)

    @property
    def scaler(self) -> np.ndarray:
        return velocity_scaler(self.paras[:, 0], self.paras[:, 1],
                               self.paras[:, 2])


def select_snapshot_indices(n_times: int, rng: np.random.Generator,
                            is_init: bool = False) -> np.ndarray:
    """The reference's snapshot-selection rule (datasetio.py:441-457 and
    preprocess.ipynb): steps 1..199 plus ≤500 random samples from the
    tail when a run is long (>700 steps); ``is_init`` takes the first 5,
    otherwise the rest."""
    times = n_times - 2
    rest = list(range(200, times)) if times > 200 else []
    if times > 700:
        rest = list(rng.choice(rest, size=min(500, rest[-1] - 200),
                               replace=True))
        i_vec = list(range(1, 200)) + rest
    else:
        i_vec = list(range(1, times))
    return np.asarray(i_vec[:5] if is_init else i_vec[5:], dtype=np.int64)


def _auto_residency(store, dtype, host_resident):
    if host_resident is None:
        itemsize = torch.empty((), dtype=dtype).element_size()
        host_resident = store.field_nbytes(itemsize) > _device_store_limit()
    return bool(host_resident)


class _Resident:
    """The store's arrays for one residency mode: ``gather(idx_by_key)``
    returns the rows of each named array on ``device``; ``static`` holds
    the (H, W) coordinates there."""

    def __init__(self, arrays: dict, xc, yc, dtype, device, host_resident):
        self.device, self.dtype = torch.device(device), dtype
        self.host_resident = host_resident
        self.static = {"xc": torch.as_tensor(xc, dtype=dtype, device=device),
                       "yc": torch.as_tensor(yc, dtype=dtype, device=device)}
        if host_resident:
            np_d = _NP_DTYPES[dtype]
            # big fields stay as they are (a memmap stays on disk); the
            # small vectors are converted once
            self.arrays = {k: (a if a.ndim == 3 else np.asarray(a, np_d))
                           for k, a in arrays.items()}
            self.np_dtype = np_d
        else:
            self.arrays = {k: torch.as_tensor(np.asarray(a), dtype=dtype,
                                              device=device)
                           for k, a in arrays.items()}

    def gather(self, rows: dict) -> dict:
        """{name: (source array key, integer indices)} → {name: rows on
        the device}. Host-resident: a NumPy gather, then a synchronous
        copy (the host buffer is free when this returns)."""
        if self.host_resident:
            return {k: torch.as_tensor(np.ascontiguousarray(
                        self.arrays[src][np.asarray(idx)],
                        dtype=self.np_dtype)).to(self.device)
                    for k, (src, idx) in rows.items()}
        index = {}          # one copy to the device per index array
        out = {}
        for k, (src, idx) in rows.items():
            if id(idx) not in index:
                index[id(idx)] = torch.as_tensor(
                    np.asarray(idx), dtype=torch.long, device=self.device)
            out[k] = self.arrays[src][index[id(idx)]]
        return out


def _plane(c, shape):
    return c[:, None, None].expand(shape)


class SnapshotDataset:
    """Single-snapshot dataset with assembly on the device
    (reference ``NewADDataset``, datasetio.py:320-654)."""

    def __init__(self, store: SnapshotStore, scale: bool = True,
                 p_pred: bool = False, noise: float = 0.0,
                 max_examples_percent_per_epoch: float = 100.0,
                 dtype=torch.float32, host_resident: Optional[bool] = None,
                 prefetch: int = 2, device="cuda"):
        self.store = store
        self.scale = scale
        self.p_pred = p_pred and store.p is not None
        self.noise = noise
        self.dtype = dtype
        self.prefetch = prefetch
        n = len(store)
        self.num_examples = min(
            int(n * max_examples_percent_per_epoch / 100.0), n)
        self.host_resident = _auto_residency(store, dtype, host_resident)
        arrays = {"T": store.T, "u": store.u, "v": store.v,
                  "paras": store.paras, "paras_nd": store.paras_nd,
                  "scaler": store.scaler, "steps": store.step_index}
        if self.p_pred:
            arrays["p"] = store.p
        self._res = _Resident(arrays, store.xc, store.yc, dtype, device,
                              self.host_resident)

    def __len__(self):
        return self.num_examples

    def _assemble(self, idx, noise_seed: int):
        """(x, y, t_weight, scaler) of the snapshots ``idx``
        (datasetio.py:595-654 semantics)."""
        g = self._res.gather({k: (k, idx) for k in self._res.arrays})
        return self._assemble_gathered(g, noise_seed)

    def _assemble_gathered(self, g, noise_seed: int):
        T, u, v = g["T"], g["u"], g["v"]
        paras, paras_nd = g["paras"], g["paras_nd"]
        xc, yc = self._res.static["xc"], self._res.static["yc"]

        if self.noise > 0:
            # uniform(-1e-5, 1e-5) on the [2:-2, 2:-2] interior, clipped
            # to [0, 1.35] (datasetio.py:604-613)
            gen = torch.Generator(device=T.device).manual_seed(noise_seed)
            inner = T[:, 2:-2, 2:-2]
            n = torch.empty(inner.shape, dtype=T.dtype,
                            device=T.device).uniform_(-1e-5, 1e-5,
                                                      generator=gen)
            T = T.clone()
            T[:, 2:-2, 2:-2] = torch.clamp(inner + n, 0.0, 1.35)

        V = fk_viscosity(paras[:, 1][:, None, None],
                         paras[:, 2][:, None, None], 1.0 - yc[None], T)
        V = torch.clamp(V, 1e-8, 1.0)
        shape = T.shape
        x = torch.stack([(xc / COORD_SCALE).expand(shape),
                         (yc / COORD_SCALE).expand(shape), visc_feature(V),
                         _plane(paras_nd[:, 0], shape),
                         _plane(paras_nd[:, 1], shape),
                         _plane(paras_nd[:, 2], shape), T], dim=-1)

        s = (g["scaler"] if self.scale
             else torch.ones_like(g["scaler"]))[:, None, None]
        ys = [u / s, v / s]
        if self.p_pred:
            ys.append(g["p"])
        y = torch.stack(ys, dim=1)

        t_weight = T_WEIGHT_NUM / (g["steps"] + 1.0) ** T_WEIGHT_POW
        return {"x": x, "y": y, "t_weight": t_weight, "scaler": g["scaler"]}

    def batch(self, rng: np.random.Generator, batch_size: int,
              noise_seed: Optional[int] = None):
        """A random batch (numpy indices, assembly on the device)."""
        idx = rng.integers(0, self.num_examples, size=batch_size)
        if noise_seed is None:
            noise_seed = int(rng.integers(0, 2**31))
        return self._assemble(idx, noise_seed)

    def epoch_batches(self, rng: np.random.Generator, batch_size: int,
                      drop_last: bool = True):
        """Shuffled epoch iterator (reference DataLoader shuffle=True,
        multigpu.py:772-779). Every draw happens up front, so the
        host-resident prefetch worker shares no mutable state with the
        consumer."""
        perm = rng.permutation(self.num_examples)
        n_full = len(perm) // batch_size
        bounds = [(i * batch_size, (i + 1) * batch_size)
                  for i in range(n_full)]
        if not drop_last and len(perm) % batch_size:
            bounds.append((n_full * batch_size, len(perm)))
        seeds = [int(rng.integers(0, 2**31)) for _ in bounds]

        def make(i):
            lo, hi = bounds[i]
            return self._assemble(perm[lo:hi], seeds[i])

        depth = self.prefetch if self.host_resident else 0
        yield from prefetch_iter(make, len(bounds), depth)


class UnstructuredDataset:
    """Point-cloud view of a snapshot store for Transolver training.

    The reference's ``UnstructuredDataset`` is lost (multigpu.py:690
    names it, nothing defines it); this is the JAX package's
    reconstruction: ``x`` (B, H·W, 7) = (xc/4, yc/4 | log10V/8, raq_nd,
    fkt_nd, fkp_nd, T) flattened over the grid (the Transolver input,
    Transolver_Structured_Mesh_2D-checkpoint.py:171-181), ``y`` (B, C, H,
    W) as :class:`SnapshotDataset`.
    """

    def __init__(self, store: SnapshotStore, scale: bool = True,
                 p_pred: bool = False, dtype=torch.float32, **kw):
        self._inner = SnapshotDataset(store, scale=scale, p_pred=p_pred,
                                      dtype=dtype, **kw)
        self.host_resident = self._inner.host_resident

    def __len__(self):
        return len(self._inner)

    @staticmethod
    def _flatten(batch):
        B, H, W, C = batch["x"].shape
        return {**batch, "x": batch["x"].reshape(B, H * W, C)}

    def batch(self, rng, batch_size, **kw):
        return self._flatten(self._inner.batch(rng, batch_size, **kw))

    def epoch_batches(self, rng, batch_size, **kw):
        for b in self._inner.epoch_batches(rng, batch_size, **kw):
            yield self._flatten(b)


class ConvAEDataset:
    """(u, v, T) → itself, for the ConvAE surrogate.

    The reference's ``ConvAEDataset`` is lost (multigpu.py:688); the JAX
    package's reconstruction: the scaled velocity pair plus temperature
    (c_i = 3, multigpu.py:1075-1077), the target is the input.
    """

    def __init__(self, store: SnapshotStore, scale: bool = True,
                 dtype=torch.float32, **kw):
        kw.pop("p_pred", None)
        self._inner = SnapshotDataset(store, scale=scale, p_pred=False,
                                      dtype=dtype, **kw)
        self.host_resident = self._inner.host_resident

    def __len__(self):
        return len(self._inner)

    @staticmethod
    def _to_ae(batch):
        y = batch["y"]                      # (B, 2, H, W) scaled u, v
        T = batch["x"][..., 6]              # temperature channel
        return {"x": torch.stack([y[:, 0], y[:, 1], T], dim=-1),
                "y": torch.cat([y, T[:, None]], dim=1),
                "scaler": batch["scaler"]}

    def batch(self, rng, batch_size, **kw):
        return self._to_ae(self._inner.batch(rng, batch_size, **kw))

    def epoch_batches(self, rng, batch_size, **kw):
        for b in self._inner.epoch_batches(rng, batch_size, **kw):
            yield self._to_ae(b)


class TimePairDataset:
    """(t, t + roll_forward) pairs for the U-Net
    (reference ``ADTimeDataset``, datasetio.py:63-280)."""

    def __init__(self, store: SnapshotStore, roll_forward: int = 1,
                 p_pred: bool = False, dtype=torch.float32,
                 host_resident: Optional[bool] = None, prefetch: int = 2,
                 device="cuda"):
        self.store = store
        self.roll_forward = roll_forward
        self.p_pred = p_pred and store.p is not None
        self.dtype = dtype
        self.prefetch = prefetch

        # (idx0, idx1) pairs within each simulation (datasetio.py:189-201):
        # snapshots of the same sim, roll_forward apart, skipping the last
        pairs, init_pairs = [], []
        for s in np.unique(store.sim_id):
            where = np.nonzero(store.sim_id == s)[0]
            for j in range(len(where) - roll_forward - 1):
                pairs.append((where[j], where[j + roll_forward]))
                if j == 0:
                    init_pairs.append((where[0], where[roll_forward]))
        self.pairs = np.asarray(pairs, dtype=np.int64)
        self.init_pairs = np.asarray(init_pairs, dtype=np.int64)

        self.host_resident = _auto_residency(store, dtype, host_resident)
        arrays = {"T": store.T, "u": store.u, "v": store.v,
                  "paras": store.paras, "paras_nd": store.paras_nd,
                  "scaler": store.scaler, "times": store.times}
        if self.p_pred:
            arrays["p"] = store.p
        self._res = _Resident(arrays, store.xc, store.yc, dtype, device,
                              self.host_resident)

    def __len__(self):
        return len(self.pairs)

    def _remap_init(self, pair_idx: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
        """Every pair whose idx0 % 8 == 0 is replaced by a random init pair
        (the reference's quirk, datasetio.py:233-236)."""
        pairs = self.pairs[pair_idx].copy()
        mask = pairs[:, 0] % 8 == 0
        if mask.any() and len(self.init_pairs):
            repl = self.init_pairs[
                rng.integers(0, len(self.init_pairs), size=int(mask.sum()))]
            pairs[mask] = repl
        return pairs

    def _assemble(self, idx0, idx1):
        rows = {"T0": ("T", idx0), "u0": ("u", idx0), "v0": ("v", idx0),
                "paras": ("paras", idx0), "paras_nd": ("paras_nd", idx0),
                "scaler": ("scaler", idx0), "t0": ("times", idx0),
                "t1": ("times", idx1), "T1": ("T", idx1),
                "u1": ("u", idx1), "v1": ("v", idx1)}
        if self.p_pred:
            rows.update(p0=("p", idx0), p1=("p", idx1))
        return self._assemble_gathered(self._res.gather(rows))

    def _assemble_gathered(self, g):
        T0, u0, v0 = g["T0"], g["u0"], g["v0"]
        paras, paras_nd = g["paras"], g["paras_nd"]
        xc, yc = self._res.static["xc"], self._res.static["yc"]
        scaler = g["scaler"][:, None, None]
        dt = (g["t1"] - g["t0"])[:, None, None]

        V = fk_viscosity(paras[:, 1][:, None, None],
                         paras[:, 2][:, None, None], 1.0 - yc[None], T0)
        shape = T0.shape
        chans = [(xc / COORD_SCALE).expand(shape),
                 (yc / COORD_SCALE).expand(shape), dt.expand(shape),
                 _plane(paras_nd[:, 0], shape), _plane(paras_nd[:, 1], shape),
                 _plane(paras_nd[:, 2], shape), visc_feature(V), T0,
                 u0 / scaler, v0 / scaler]
        if self.p_pred:
            # 11th channel: the previous pressure (the reference declares
            # c_i = 11 for p_pred but assembles 10, datasetio.py:258-274;
            # the JAX package completes the contract, and so does this)
            chans.append(g["p0"])
        x = torch.stack(chans, dim=-1)

        ys = [g["u1"] / scaler, g["v1"] / scaler]
        if self.p_pred:
            ys.append(g["p1"])
        ys.append(g["T1"])
        y = torch.stack(ys, dim=1)
        return {"x": x, "y": y, "scaler": scaler[:, 0, 0], "paras": paras,
                "yc": yc[None].expand(shape)}

    def batch(self, rng: np.random.Generator, batch_size: int):
        pair_idx = rng.integers(0, len(self.pairs), size=batch_size)
        pairs = self._remap_init(pair_idx, rng)
        return self._assemble(pairs[:, 0], pairs[:, 1])

    def epoch_batches(self, rng: np.random.Generator, batch_size: int):
        """Shuffled epoch iterator; the pair remaps and every draw happen
        up front (see :meth:`SnapshotDataset.epoch_batches`)."""
        perm = rng.permutation(len(self.pairs))
        n_full = len(perm) // batch_size
        all_pairs = [self._remap_init(
            perm[i * batch_size:(i + 1) * batch_size], rng)
            for i in range(n_full)]

        def make(i):
            return self._assemble(all_pairs[i][:, 0], all_pairs[i][:, 1])

        depth = self.prefetch if self.host_resident else 0
        yield from prefetch_iter(make, n_full, depth)
