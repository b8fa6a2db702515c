"""Synthetic snapshot stores for tests, demos and benchmarks.

Counterpart of the JAX package's ``data/synthetic.py``, with the same
numpy draws in the same order, so a seed gives the same arrays. The
reference's data lives on a cluster filesystem that is not shipped; this
module fabricates snapshot stores of the same structure (convection-cell
velocity from a stream function, boundary-layer temperature profiles) so
every pipeline stage runs without it. The debug-mode ``*_select_init``
tensors of the reference (datasetio.py:159-172) play the same role.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..constants import SimParams, velocity_scaler
from ..sim.grid import Grid
from .dataset import SnapshotStore


def synthetic_store(
    grid: Optional[Grid] = None,
    params_list: Sequence[SimParams] = (SimParams(3.0, 1e8, 10.0),),
    n_snapshots: int = 16,
    with_p: bool = False,
    seed: int = 0,
) -> SnapshotStore:
    """Build a synthetic :class:`SnapshotStore` of evolving convection
    cells for each parameter triple."""
    grid = grid or Grid(H=32, W=68)
    rng = np.random.default_rng(seed)
    xc = grid.xc
    yc = grid.yc
    H, W = xc.shape

    Ts, us, vs, ps = [], [], [], []
    paras, steps, sims, times = [], [], [], []
    for sim_i, sp in enumerate(params_list):
        scale = velocity_scaler(sp.raq, sp.fkt, sp.fkp)
        phase = rng.uniform(0, 2 * np.pi)
        k = rng.integers(1, 4)
        t = 0.0
        for i in range(n_snapshots):
            t += 1e-4 * (1.0 + 0.1 * rng.random())
            amp = 1.0 - np.exp(-5.0 * t / 1e-3)
            a = np.sin(np.pi * yc) * np.sin(
                k * np.pi * xc / grid.aspect + phase + 0.5 * t / 1e-4)
            u = np.pi * np.cos(np.pi * yc) * np.sin(
                k * np.pi * xc / grid.aspect + phase) * amp * scale
            v = -(k * np.pi / grid.aspect) * np.sin(np.pi * yc) * np.cos(
                k * np.pi * xc / grid.aspect + phase) * amp * scale
            T = np.clip(
                1.0 - yc + 0.1 * amp * a
                + 0.01 * rng.standard_normal((H, W)), 0.0, 1.0)
            T[0, :] = 1.0
            T[-1, :] = 0.0
            Ts.append(T)
            us.append(u)
            vs.append(v)
            if with_p:
                ps.append(np.cos(np.pi * yc) * amp)
            paras.append([sp.raq, sp.fkt, sp.fkp])
            steps.append(i + 1)
            sims.append(sim_i)
            times.append(t)

    return SnapshotStore(
        T=np.asarray(Ts), u=np.asarray(us), v=np.asarray(vs),
        p=np.asarray(ps) if with_p else None,
        paras=np.asarray(paras), step_index=np.asarray(steps),
        sim_id=np.asarray(sims), times=np.asarray(times),
        xc=xc, yc=yc)


def synthetic_store_memmap(
    path: str,
    grid: Optional[Grid] = None,
    params_list: Sequence[SimParams] = (SimParams(3.0, 1e8, 10.0),),
    n_snapshots_per_sim: int = 700,
    seed: int = 0,
    chunk: int = 256,
) -> SnapshotStore:
    """A reference-scale :class:`SnapshotStore` backed by disk memmaps.

    The real training split (96 sims × ~700 snapshots of 128×506,
    datasetio.py:33,96) is ~50-70 GB: more than the device store limit
    of data/dataset.py, and too big to fabricate in RAM in one piece.
    This writes the big fields (T, u, v; float32) to
    ``<path>/{T,u,v}.dat`` in ``chunk``-snapshot slices
    and the small metadata to ``<path>/meta.npz``, then returns a store
    whose field arrays are read-only memmaps — exactly what the
    host-resident dataset mode consumes. Re-calling with an existing,
    size-consistent ``path`` reopens without regenerating.
    """
    grid = grid or Grid()
    xc = grid.xc
    yc = grid.yc
    H, W = xc.shape
    n_sims = len(params_list)
    N = n_sims * n_snapshots_per_sim
    shape = (N, H, W)

    os.makedirs(path, exist_ok=True)
    meta_path = os.path.join(path, "meta.npz")
    dat = {f: os.path.join(path, f + ".dat") for f in ("T", "u", "v")}
    want_bytes = int(np.prod(shape)) * 4

    if os.path.exists(meta_path) and all(
            os.path.exists(p) and os.path.getsize(p) == want_bytes
            for p in dat.values()):
        meta = np.load(meta_path)
        if tuple(meta["shape"]) == shape:
            return SnapshotStore(
                T=np.memmap(dat["T"], np.float32, "r", shape=shape),
                u=np.memmap(dat["u"], np.float32, "r", shape=shape),
                v=np.memmap(dat["v"], np.float32, "r", shape=shape),
                p=None, paras=meta["paras"],
                step_index=meta["steps"], sim_id=meta["sims"],
                times=meta["times"], xc=xc, yc=yc)

    rng = np.random.default_rng(seed)
    T_mm = np.memmap(dat["T"], np.float32, "w+", shape=shape)
    u_mm = np.memmap(dat["u"], np.float32, "w+", shape=shape)
    v_mm = np.memmap(dat["v"], np.float32, "w+", shape=shape)

    paras = np.empty((N, 3))
    steps = np.empty(N, np.int64)
    sims = np.empty(N, np.int64)
    times = np.empty(N)

    for sim_i, sp in enumerate(params_list):
        scale = velocity_scaler(sp.raq, sp.fkt, sp.fkp)
        phase = rng.uniform(0, 2 * np.pi)
        k = int(rng.integers(1, 4))
        t = 1e-4 * np.cumsum(1.0 + 0.1 * rng.random(n_snapshots_per_sim))
        base = sim_i * n_snapshots_per_sim
        paras[base:base + n_snapshots_per_sim] = (sp.raq, sp.fkt, sp.fkp)
        steps[base:base + n_snapshots_per_sim] = \
            np.arange(1, n_snapshots_per_sim + 1)
        sims[base:base + n_snapshots_per_sim] = sim_i
        times[base:base + n_snapshots_per_sim] = t

        sin_y = np.sin(np.pi * yc)
        cos_y = np.cos(np.pi * yc)
        for lo in range(0, n_snapshots_per_sim, chunk):
            hi = min(lo + chunk, n_snapshots_per_sim)
            tc = t[lo:hi, None, None]
            amp = 1.0 - np.exp(-5.0 * tc / 1e-3)
            arg = k * np.pi * xc / grid.aspect + phase
            a = sin_y * np.sin(arg + 0.5 * tc / 1e-4)
            u = np.pi * cos_y * np.sin(arg) * amp * scale
            v = -(k * np.pi / grid.aspect) * sin_y * np.cos(arg) \
                * amp * scale
            T = np.clip(
                1.0 - yc + 0.1 * amp * a
                + 0.01 * rng.standard_normal((hi - lo, H, W)), 0.0, 1.0)
            T[:, 0, :] = 1.0
            T[:, -1, :] = 0.0
            s = slice(base + lo, base + hi)
            T_mm[s] = T.astype(np.float32)
            u_mm[s] = np.broadcast_to(u, T.shape).astype(np.float32)
            v_mm[s] = np.broadcast_to(v, T.shape).astype(np.float32)

    T_mm.flush(), u_mm.flush(), v_mm.flush()
    del T_mm, u_mm, v_mm
    np.savez(meta_path, shape=np.asarray(shape), paras=paras,
             steps=steps, sims=sims, times=times)
    return SnapshotStore(
        T=np.memmap(dat["T"], np.float32, "r", shape=shape),
        u=np.memmap(dat["u"], np.float32, "r", shape=shape),
        v=np.memmap(dat["v"], np.float32, "r", shape=shape),
        p=None, paras=paras, step_index=steps, sim_id=sims,
        times=times, xc=xc, yc=yc)
