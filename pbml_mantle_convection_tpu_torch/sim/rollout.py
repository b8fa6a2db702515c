"""Coupled-rollout drivers: the engine on the card, and the native engine.

Counterpart of the JAX package's ``sim/rollout.py``: the reference's
``attempt()`` / ``attempt_unet()`` loops (advect_wi_gaia.py:538-833) in
two strategies.

* :func:`rollout_torch`, the counterpart of ``rollout_jax``: the coupled
  loop is ``SimEngine.multi_step`` (every step queued on the card, with
  the fused kernels where the engine runs them), in chunks of
  ``snapshot_every`` steps, each ending in a synchronization and the
  host copy of the chunk's end state (the reference's periodic pickle
  snapshots).
* :func:`rollout_native`, the counterpart of the JAX ``rollout_native``:
  drives the native C++ engine (``sim/gaia_native.py``, GAIA's stand-in,
  on the host) step by step with the surrogate's velocities from the
  card, reproducing the reference's per-step host exchange
  (advect_wi_gaia.py:583-677) including the ``intervene_TS``
  (MMSolverSkip) logic and warm-up steps.

Both record T_vec / t_vec / TS_vec and snapshot dictionaries in the
reference's pickle layout (advect_wi_gaia.py:654-668), holding numpy
arrays and numpy or Python scalars only: either package, and the
reference's notebooks, read them without torch.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..utils.checkpoint import save_pickle
from .engine import RolloutTrace, SimEngine
from .stepper import TimeStepper

# steps that rollout_torch runs on the initial state, and throws away,
# before its first timed window (the kernels' nvcc build, first
# allocations): the JAX driver compiles its chunk sizes there instead
WARMUP_STEPS = 1


def _dump(gaia_dir, mode, snapshots, TS_vec, t_vec, T_vec):
    save_pickle(os.path.join(gaia_dir, f"snapshots_{mode}.pkl"), snapshots)
    save_pickle(os.path.join(gaia_dir, f"TS_vec_{mode}.pkl"), TS_vec)
    save_pickle(os.path.join(gaia_dir, f"t_vec_{mode}.pkl"), t_vec)
    save_pickle(os.path.join(gaia_dir, f"T_vec_{mode}.pkl"), T_vec)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_state(state) -> dict:
    return {name: getattr(state, name).cpu().numpy()
            for name in ("T", "u", "v", "p", "V", "t")}


def rollout_torch(
    engine: SimEngine,
    T0,
    n_steps: int,
    gaia_dir: Optional[str] = None,
    mode: str = "ML_STOKES",
    snapshot_every: int = 200,
    timed_steps: int = 0,
):
    """Rollout on the engine's device with reference-format outputs.

    TS_vec per-step wall times (the reference records one per step,
    advect_wi_gaia.py:650-652): the first ``timed_steps`` steps are
    queued one at a time, each ending in a synchronization, giving true
    per-step latencies; the remainder runs in ``snapshot_every``-sized
    chunks of ``SimEngine.multi_step``, each chunk wall-timed up to its
    synchronization and amortized over its steps. Before the first
    window, :data:`WARMUP_STEPS` step(s) run on the initial state and are
    thrown away (the engine allocates new outputs every step, so the
    initial state is left as it was). Returns (state, trace, snapshots).
    """
    state = engine.init_state(T0)
    if n_steps > 0:
        engine.multi_step(state, WARMUP_STEPS)
        _sync(engine.device)

    TS_vec: list = []
    traces = []
    snaps = []
    done = 0
    for _ in range(min(timed_steps, n_steps)):
        t0 = time.time()
        state, tr = engine.multi_step(state, 1)
        _sync(engine.device)
        TS_vec.append(time.time() - t0)
        traces.append(tr)
        done += 1
        if snapshot_every and done % snapshot_every == 0:
            snaps.append(_host_state(state))

    # remainder: chunks, per-chunk wall amortization
    while done < n_steps:
        k = min(snapshot_every or (n_steps - done), n_steps - done)
        t0 = time.time()
        state, tr = engine.multi_step(state, k)
        _sync(engine.device)
        wall = time.time() - t0
        TS_vec.extend([wall / k] * k)
        traces.append(tr)
        done += k
        if snapshot_every:
            snaps.append(_host_state(state))

    trace = RolloutTrace(*(torch.cat(x) for x in zip(*traces)))
    T_vec = list(trace.mean_T.cpu().numpy())
    t_vec = list(trace.t.cpu().numpy())

    snapshots = {"v": [], "P": [], "T": [],
                 "xcc": np.asarray(engine.grid.xc),
                 "ycc": np.asarray(engine.grid.yc)}
    for s in snaps:
        u = s["u"].reshape(-1, 1)
        v = s["v"].reshape(-1, 1)
        snapshots["v"].append(
            np.concatenate([u, v, np.zeros_like(u)], axis=1))
        snapshots["P"].append(s["p"].reshape(-1))
        snapshots["T"].append(s["T"].reshape(-1))

    if gaia_dir is not None:
        _dump(gaia_dir, mode, snapshots, TS_vec, t_vec, T_vec)
    return state, trace, snapshots


def _field(x, stepper: TimeStepper, H: int, W: int) -> torch.Tensor:
    """A copy of a native state column, (1, H, W) on the stepper's device
    in its dtype."""
    return torch.tensor(x, dtype=stepper.dtype,
                        device=stepper.device).reshape(1, H, W)


@torch.no_grad()
def rollout_native(
    sim,                       # gaia_native.Direct (already init2'd)
    stepper: Optional[TimeStepper],
    mode: str = "ML_STOKES",
    t_end: float = 10.0,
    intervene_ts: int = 1,
    warm_up_steps: int = 0,
    save_steps: int = 200,
    write_steps: int = 200,
    gaia_dir: Optional[str] = None,
    core_cool: bool = False,
    p_pred: bool = False,
    max_steps: Optional[int] = None,
):
    """The reference ``attempt()`` loop against the native engine
    (advect_wi_gaia.py:538-679). ``stepper`` supplies surrogate velocities
    for the ML modes (computed on its device, copied to the host with
    ``.cpu()`` and written into the engine's zero-copy views in place);
    ``mode='GAIA'`` steps the native engine alone.
    """
    H, W = sim.shape
    state = sim.getState()
    save_every = t_end / save_steps
    write_every = t_end / write_steps

    T_vec = [float(np.copy(state["T"].mean()))]
    t_vec = [0.0]
    TS_vec = []
    snapshots = {"v": [], "P": [], "T": []}

    t = 0.0
    n_step = 0
    while n_step < warm_up_steps:
        n_step += 1
        sim.doTimestep()

    for var in ["v", "P", "T"]:
        snapshots[var].append(np.copy(state[var]))
    snapshots["xcc"] = np.copy(state["pos"][:, 0]).reshape(H, W)
    snapshots["ycc"] = np.copy(state["pos"][:, 1]).reshape(H, W)

    is_unet = stepper is not None and stepper.net in ("unet", "iunet")

    save_t = 0.0
    write_t = 0.0
    while t < t_end:
        if max_steps is not None and n_step >= warm_up_steps + max_steps:
            break
        n_step += 1
        t0 = time.time()

        if mode != "GAIA" and is_unet:
            # the reference's attempt_unet: driver-level CFL dt, the
            # network advances T itself; GAIA only holds state
            # (advect_wi_gaia.py:734-797)
            s = float(stepper.scaler)
            Tp = _field(state["T"], stepper, H, W)
            up = _field(state["v"][:, 0], stepper, H, W) / s
            vp = _field(state["v"][:, 1], stepper, H, W) / s
            dt = stepper.unet_dt(up, vp)
            T_new, u, v, p, V = stepper.step_unet(Tp, up, vp, dt)
            state["v"][:, 0] = u.cpu().numpy().reshape(-1)
            state["v"][:, 1] = v.cpu().numpy().reshape(-1)
            state["v"][:, 2] = 0.0
            state["V"][:] = V.cpu().numpy().reshape(-1)
            Tg = np.array(T_new.cpu().numpy()).reshape(H, W)
            if not core_cool:
                Tg[0, :] = 1.0
            Tg[-1, :] = 0.0
            Tg[:, 0] = Tg[:, 1]
            Tg[:, -1] = Tg[:, -2]
            np.clip(Tg, 0.0, 2.0, out=Tg)
            state["T"][:] = Tg.reshape(-1)
            state["raw"].time = t
            dt = float(dt)
        elif mode != "GAIA":
            Tp = _field(state["T"], stepper, H, W)
            T_new, dt_ml, u, v, p, V = stepper.step(Tp)
            state["v"][:, 0] = u.cpu().numpy().reshape(-1)
            state["v"][:, 1] = v.cpu().numpy().reshape(-1)
            state["v"][:, 2] = 0.0
            if p_pred and p is not None:
                state["P"][:] = p.cpu().numpy().reshape(-1)
            state["V"][:] = V.cpu().numpy().reshape(-1)

            if mode != "ML" or n_step % intervene_ts == 0:
                # native energy step (the GAIA intervention)
                dt = sim.doTimestep()
                Tg = state["T"].reshape(H, W)
                if not core_cool:
                    Tg[0, :] = 1.0
                Tg[-1, :] = 0.0
                Tg[:, 0] = Tg[:, 1]
                Tg[:, -1] = Tg[:, -2]
                np.clip(Tg, 0.0, 2.0, out=Tg)
            else:
                # ML off-step: the explicit AD update from the stepper
                state["T"][:] = T_new.cpu().numpy().reshape(-1)
                dt = float(dt_ml)
            state["raw"].time = t
        else:
            dt = sim.doTimestep()

        t += float(dt)
        T_vec.append(float(np.copy(state["T"].mean())))
        t_vec.append(t)
        TS_vec.append(time.time() - t0)

        if t > save_t:
            save_t = t + save_every
            for var in ["v", "P", "T"]:
                snapshots[var].append(np.copy(state[var]))
        if gaia_dir is not None and t > write_t:
            write_t = t + write_every
            _dump(gaia_dir, mode, snapshots, TS_vec, t_vec, T_vec)

    if gaia_dir is not None:
        _dump(gaia_dir, mode, snapshots, TS_vec, t_vec, T_vec)
    return t, n_step, snapshots, T_vec, t_vec, TS_vec
