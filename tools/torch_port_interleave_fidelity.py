"""ML-mode interleave fidelity on the port: the native COURANT energy step
interleaved with the surrogate's, against the in-framework ML_STOKES.

The port's counterpart of ``tools/interleave_fidelity.py``, with its flags
and defaults. The reference's ML mode alternates the surrogate's
temperature updates with GAIA's own COURANT-stepped energy solve every
``intervene_TS`` steps (advect_wi_gaia.py:618-635): two dt rules
interleaved. The engine's ML mode coincides with ML_STOKES. This tool
measures what that choice costs: one case rolled out three ways with the
same surrogate (the flagship through the fused executor),

  A. in-framework ML     — ``SimEngine.multi_step`` in ML_STOKES: the
                           explicit energy step every step (on the card
                           the fused epilogue: 4 + 1 + 1 + 0 launches);
  B. native interleave   — ``sim/rollout.py::rollout_native(mode="ML",
                           intervene_ts=N)``: the native C++ engine
                           (``sim/gaia_native.py::Direct``, on the host)
                           every N-th step, the surrogate's energy step
                           (4 + 1 + 0 + 1) in between;
  C. native every step   — ``mode="ML_STOKES"`` against the native
                           energy step each step,

and reports the mean-T trace RMSE and max deviation of B and C against A
on a common time axis (``utils/evaluation.py::compare_rollouts``), each
leg's end time, and each leg's kernel launches per step.

``--weights`` reads a port checkpoint (``{epoch}_fluidnet_uvp.ckpt`` of
the Trainer, the file the rollout CLI reads); without it the surrogate
has seeded random weights. Prints one JSON object and writes it to
``torch_port_interleave.json`` under ``--out-dir`` (default
``build/studies/``)::

    python3 tools/torch_port_interleave_fidelity.py [--layers 126 --ar 4]
        [--steps 400] [--intervene 10] [--weights CKPT]
    python3 tools/torch_port_interleave_fidelity.py --device cpu \\
        --layers 30 --ar 2 --steps 120

It runs on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_port_study_util import (  # noqa: E402
    OUT_DIR, launches, launches_per_step, study_device, sync)
from pbml_mantle_convection_tpu_torch.constants import SimParams  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.fast_path import (  # noqa: E402
    FastNewFluidNet)
from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.gaia_native import Direct  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.grid import Grid  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.ini import (  # noqa: E402
    GaiaIniConfig, create_ini_file)
from pbml_mantle_convection_tpu_torch.sim.rollout import rollout_native  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.checkpoint import (  # noqa: E402
    restore_checkpoint)
from pbml_mantle_convection_tpu_torch.utils.card import card_info  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.evaluation import (  # noqa: E402
    compare_rollouts)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--layers", type=int, default=126,
                   help="GAIA interior layers (126 -> 128x506 at AR 4)")
    p.add_argument("--ar", type=float, default=4.0)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--intervene", type=int, default=10,
                   help="intervene_TS: native energy step every N steps")
    p.add_argument("--raq", type=float, default=3.0)
    p.add_argument("--fkt", type=float, default=1e7)
    p.add_argument("--fkp", type=float, default=10.0)
    p.add_argument("--levels", type=int, default=5)
    p.add_argument("--c_h", type=int, default=16)
    p.add_argument("--repeats", type=int, default=6)
    p.add_argument("--weights", type=str, default=None,
                   help="the port Trainer's checkpoint of the surrogate "
                        "(default: seeded random weights)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--json", action="store_true")
    p.add_argument("--out-dir", type=str, default=OUT_DIR)
    return p


def main(argv=None, init_weights=None):
    """Runs the three legs; returns the JSON record. ``init_weights``: the
    surrogate's state dict when no ``--weights`` is given (default: a
    seeded torch init, seed 3)."""
    args = build_parser().parse_args(argv)
    device = study_device("torch_port_interleave_fidelity", args.device)

    H = args.layers + 2
    W = int(args.layers * args.ar) + 2
    dtype = torch.float32
    grid = Grid(H=H, W=W, aspect=args.ar)
    pp = SimParams(args.raq, args.fkt, args.fkp)
    print(f"grid {H}x{W}, params raq={pp.raq} fkt={pp.fkt:.0e} "
          f"fkp={pp.fkp}, intervene_TS={args.intervene}", file=sys.stderr)

    model = NewFluidNet(levels=args.levels, c_i=7, c_h=args.c_h, c_o=1,
                        act_fn="gelu", r_p="learned", loss_type="curl",
                        repeats=args.repeats, f=5, p_pred=False, seed=3,
                        device=device, dtype=dtype)
    if args.weights:
        model.load_state_dict(restore_checkpoint(args.weights)["model"])
    elif init_weights is not None:
        model.load_state_dict(init_weights)
    fast = FastNewFluidNet(model, H, W)

    def mk_stepper():
        return TimeStepper(grid, pp, fast, cn_max=0.99, dtype=dtype,
                           device=device)

    T0 = np.clip(1.0 - grid.yc + 0.04 * np.cos(3 * np.pi * grid.xc
                                               / args.ar)
                 * np.sin(np.pi * grid.yc), 0.0, 1.0)
    T0[0, :], T0[-1, :] = 1.0, 0.0

    # ---- A. in-framework ML (the energy step every step) ----
    eng = SimEngine(mk_stepper(), mode="ML_STOKES")
    st = eng.init_state(torch.as_tensor(T0, dtype=dtype)[None])
    before = launches()
    st, trace = eng.multi_step(st, args.steps)
    sync(device)
    launch_A = launches_per_step(before, args.steps)
    tA = trace.t.cpu().numpy().astype(np.float64)
    mA = trace.mean_T.cpu().numpy().astype(np.float64)
    print(f"A in-framework ML: t_end={tA[-1]:.5f} meanT={mA[-1]:.5f}",
          file=sys.stderr)

    # ---- native paths ----
    def native_run(mode, intervene):
        with tempfile.TemporaryDirectory() as tmp:
            ini = os.path.join(tmp, "Gaia.ini")
            create_ini_file(ini, GaiaIniConfig(
                mode=mode, raq=pp.raq, fkt=pp.fkt, fkp=pp.fkp,
                layers=args.layers, aspect_ratio=args.ar))
            sim = Direct()
            sim.init1()
            sim.iniLoad(ini)
            sim.init2()
        if sim.shape != (H, W):
            raise RuntimeError(f"native grid {sim.shape}, want {(H, W)}")
        state = sim.getState()
        state["T"][:] = T0.reshape(-1)       # identical initial state
        sim.updateViscosity()
        before = launches()
        t, n, snaps, T_vec, t_vec, TS_vec = rollout_native(
            sim, mk_stepper(), mode=mode, t_end=float(tA[-1]) * 1.05,
            intervene_ts=intervene, max_steps=args.steps,
            save_steps=1, write_steps=10**9)
        return (np.asarray(t_vec[1:], np.float64),
                np.asarray(T_vec[1:], np.float64), n,
                launches_per_step(before, n),
                float(np.sum(TS_vec)) / max(n, 1))

    tB, mB, nB, launch_B, sB = native_run("ML", args.intervene)
    print(f"B native interleave (every {args.intervene}): "
          f"t_end={tB[-1]:.5f} meanT={mB[-1]:.5f} steps={nB}",
          file=sys.stderr)
    tC, mC, nC, launch_C, sC = native_run("ML_STOKES", 1)
    print(f"C native every-step: t_end={tC[-1]:.5f} meanT={mC[-1]:.5f} "
          f"steps={nC}", file=sys.stderr)

    rB = compare_rollouts(tA, mA, tB, mB)
    rC = compare_rollouts(tA, mA, tC, mC)
    out = {
        "grid": [H, W], "steps": args.steps,
        "intervene_ts": args.intervene,
        "params": [pp.raq, pp.fkt, pp.fkp],
        "trained_weights": bool(args.weights),
        **card_info(device),
        "A_t_end": float(tA[-1]),
        "A_launches_per_step": launch_A,
        "B_native_interleave": {"trace_rmse": rB["rmse"],
                                "trace_max_abs": rB["max_abs"],
                                "t_end": float(tB[-1]), "steps": nB,
                                "s_per_step": sB,
                                "launches_per_step": launch_B},
        "C_native_everystep": {"trace_rmse": rC["rmse"],
                               "trace_max_abs": rC["max_abs"],
                               "t_end": float(tC[-1]), "steps": nC,
                               "s_per_step": sC,
                               "launches_per_step": launch_C},
        "mean_T_drift_A": float(abs(mA[-1] - mA[0])),
    }
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "torch_port_interleave.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out) if args.json else json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
