"""Coupled-rollout CLI: the port's ``advect_wi_gaia.py`` equivalent.

Counterpart of the JAX package's ``cli/rollout.py``, with its flags and
defaults, plus ``--device``. Modes (advect_wi_gaia.py:218-222):
  GAIA       — the native engine alone, its own urf_mm momentum solve
  ML         — surrogate + explicit AD update, native energy step every
               ``--intervene_TS`` steps (native engine)
  ML_STOKES  — surrogate Stokes + energy step every step
  ML_PRE     — surrogate prediction warm-starts a short iterative PT
               momentum solve each step (advect_wi_gaia.py:221,488;
               solver config prepare_gaia_ini.py:146)

``--engine torch`` (default) runs the coupled loop on the device through
``SimEngine`` (with ``--fast 1`` the flagship family runs the fused
executor and its kernels, as the JAX CLI runs its own, with every head
``-lt``/``-pp`` offer; widths and kernel sizes the executor lacks run
the module, as JAX's fall back to its standard path; the CLI prints the
route it took); ``--engine
native`` (and ``-m GAIA``) drives the C++ engine step by step on the
host, the surrogate on the device. Writes the run directory
``run_name(...)`` under ``--out_dir`` with ``ml_prof.txt``, ``Gaia.ini``
and the reference pickle set (snapshots/T_vec/t_vec/TS_vec)::

    python -m pbml_mantle_convection_tpu_torch.cli.rollout -m ML_STOKES \\
        -raq 3.0 -fkt 1e8 -fkp 10 -l 5 -f 16 -r 6 -k 5 -s 0 \\
        -pad learned -init perfect --max_steps 2000

It runs on the card; only ``--device cpu`` runs it elsewhere, and with no
card and no such flag it fails. The parser's defaults are the JAX
parser's (``-s 1 -l 6 -r 4``; ``-l 6`` pools the 128×506 grid below the
learned-padding slab, which JAX refuses too, so the flagship runs with
``-l 5 -r 6``): ``-s 1`` runs the symmetric network on the module path,
as JAX's CLI does. The networks with no coupled rollout
(``sim/stepper.py::NO_ROLLOUT``: a HalfNewFluidNet, the Transolvers, the
ConvAE) raise with the reason, which JAX's CLI shares, before anything is
written.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Advect with the sim engine")
    p.add_argument("-f", "--c_h", type=int, default=16)
    p.add_argument("-s", "--use_symm", type=int, default=1)
    p.add_argument("-l", "--levels", type=int, default=6)
    p.add_argument("-r", "--repeats", type=int, default=4)
    p.add_argument("-k", "--kernel", type=int, default=5)
    p.add_argument("-w", "--warm_up_steps", type=int, default=0)
    p.add_argument("-i", "--intervene_TS", type=int, default=1)
    p.add_argument("-t", "--t_end", type=float, default=10.0)
    p.add_argument("-m", "--mode", type=str, default="GAIA")
    p.add_argument("-save", "--save_steps", type=int, default=200)
    p.add_argument("-write", "--write_steps", type=int, default=200)
    p.add_argument("-ad", "--advection_scheme", type=int, default=2)
    p.add_argument("-raq", "--raq", type=float, required=True)
    p.add_argument("-fkt", "--fkt", type=float, required=True)
    p.add_argument("-fkp", "--fkp", type=float, required=True)
    p.add_argument("-pp", "--p_pred", type=int, default=0)
    p.add_argument("-lt", "--loss_type", type=str, default="curl")
    p.add_argument("-net", "--network", type=str, default="newfluidnet")
    p.add_argument("-fac", "--factor", type=int, default=2)
    p.add_argument("-pad", "--r_p", type=str, default="learned")
    p.add_argument("-e", "--epoch", type=int, default=-1)
    p.add_argument("-cool", "--core_cool", type=int, default=0)
    p.add_argument("-decay", "--radioactive_decay", type=int, default=0)
    p.add_argument("-init", "--initialization", type=str, default="hot")
    p.add_argument("-sol", "--solver", type=str, default="mumps")
    p.add_argument("-u", "--urf", type=float, default=1.0)
    p.add_argument("-di", "--Di", type=float, default=0.0)
    p.add_argument("--nn_dir", type=str, default=None,
                   help="trained-network dir of the port's Trainer "
                        "(None: seeded random weights)")
    p.add_argument("--out_dir", type=str, default="./GAIA_ML_RUNS")
    p.add_argument("--engine", type=str, default="torch",
                   choices=["torch", "native"])
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--fast", type=int, default=1,
                   help="run newfluidnet with learned or zero padding "
                        "through the fused executor (its kernels)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def initial_temperature(grid, raq: float, fkt: float, fkp: float,
                        initialization: str) -> np.ndarray:
    """(H, W) float64 initial field as the JAX CLI builds it: the
    predicted profile ("perfect"), linear, cold or hot starts
    (prepare_gaia_ini.py:64-67, 94-96), plus a cosine perturbation, with
    the bottom row 1 and the top row 0."""
    from ..sim.profiles import calc_mlp_profile
    y_pred, y_prof = calc_mlp_profile([raq], [fkt], [fkp])
    yc = grid.yc
    if initialization == "perfect":
        prof = np.interp(1.0 - yc[:, 0], y_prof[::-1], y_pred[0][::-1])
        T0 = np.broadcast_to(prof[:, None], yc.shape).copy()
    elif initialization == "linear":
        T0 = 1.0 - yc
    elif initialization == "cold":
        T0 = np.zeros_like(yc)
    else:
        T0 = np.ones_like(yc)
    xc = grid.xc
    T0 = T0 + 0.01 * np.cos(np.pi * xc / grid.aspect) * np.sin(np.pi * yc)
    T0[0, :] = 1.0
    T0[-1, :] = 0.0
    return T0


def build_surrogate(args, grid, device):
    """The surrogate of the ML modes: the registry's model, its
    weights from ``--nn_dir`` (the port Trainer's
    ``{epoch}_fluidnet_uvp.ckpt``) or seed 0. Where the JAX CLI builds
    its ``FastNewFluidNet`` (``--fast 1``, newfluidnet, learned or zero
    padding, ``use_symm`` off), ``models/fast_path.py::
    executor_or_module`` picks the fused executor or, for what the
    executor does not run (c_h ∉ {8, 16}, k ≠ 5, factor ≠ 2), the module:
    the function JAX's executor computes on its standard path. Else the
    module (JAX's CLI builds the ViT at the registry's 128×506 default,
    the grid). Prints one line naming the route and why."""
    import torch

    from ..models.fast_path import executor_or_module
    from ..models.registry import ModelConfig, build_model
    from ..utils.checkpoint import restore_checkpoint

    mc = ModelConfig(
        network=args.network, levels=args.levels, c_h=args.c_h,
        act_fn="gelu", r_p=args.r_p, loss_type=args.loss_type,
        use_symm=bool(args.use_symm), repeats=args.repeats,
        kernel=args.kernel, p_pred=bool(args.p_pred), factor=args.factor,
        H=grid.H, W=grid.W, dtype=torch.float32)
    model = build_model(mc, seed=0, device=device)
    if args.nn_dir:
        from ..train.trainer import best_epoch_from_log
        log = os.path.join(args.nn_dir, "fluidnet_uvpT.txt")
        epoch = (best_epoch_from_log(log) if args.epoch == -1
                 else args.epoch)
        ckpt = os.path.join(args.nn_dir, f"{epoch}_fluidnet_uvp.ckpt")
        model.load_state_dict(restore_checkpoint(ckpt)["model"])
        print(f"loaded epoch {epoch}")
    model.eval()
    if (args.fast and args.network == "newfluidnet"
            and args.r_p in ("learned", "zeros") and not args.use_symm):
        fn, route = executor_or_module(model, grid.H, grid.W)
    else:
        fn, route = model, (
            f"route: module (--fast {args.fast} -net {args.network} -pad "
            f"{args.r_p} -s {args.use_symm}: the executor takes --fast 1 "
            f"newfluidnet with learned or zero padding and -s 0)")
    print(route)
    return fn


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from ..sim.stepper import NO_ROLLOUT
    if args.mode != "GAIA" and args.network in NO_ROLLOUT:
        # GAIA builds no surrogate
        raise ValueError(NO_ROLLOUT[args.network])

    from ..constants import SimParams
    from ..sim.engine import SimEngine
    from ..sim.grid import Grid
    from ..sim.ini import GaiaIniConfig, create_ini_file, run_name
    from ..sim.profiles import calc_mlp_profile
    from ..sim.rollout import rollout_native, rollout_torch
    from ..sim.stepper import TimeStepper

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("rollout: no CUDA device (pass --device cpu to "
                         "run on the CPU)")
    grid = Grid()
    dtype = torch.float32

    # surrogate (ML modes); built before anything is written, so that a
    # network or option the port lacks leaves no run directory behind
    apply_fn = None
    if args.mode != "GAIA":
        apply_fn = build_surrogate(args, grid, device)

    params_phys = SimParams(args.raq, args.fkt, args.fkp)
    ini_cfg = GaiaIniConfig(
        mode=args.mode, raq=args.raq, fkt=args.fkt, fkp=args.fkp,
        advection_scheme=args.advection_scheme,
        intervene_ts=args.intervene_TS, warm_up_steps=args.warm_up_steps,
        solver=args.solver, initialization=args.initialization,
        urf=args.urf, Di=args.Di, core_cool=bool(args.core_cool),
        radioactive_decay=bool(args.radioactive_decay))

    gaia_dir = os.path.join(args.out_dir,
                            run_name(ini_cfg, network=args.network))
    os.makedirs(gaia_dir, exist_ok=True)

    # T(z) profile init (advect_wi_gaia.py:227)
    calc_mlp_profile([args.raq], [args.fkt], [args.fkp], gaia_dir)
    f_ini = os.path.join(gaia_dir, "Gaia.ini")
    create_ini_file(f_ini, dataclasses.replace(
        ini_cfg, profile_file=os.path.join(gaia_dir, "ml_prof.txt")))

    stepper = None
    if apply_fn is not None:
        stepper = TimeStepper(
            grid, params_phys, apply_fn, cn_max=0.99,
            core_cool=bool(args.core_cool), dtype=dtype, device=device,
            net=args.network)

    if args.engine == "native" or args.mode == "GAIA":
        from ..sim.gaia_native import Direct
        sim = Direct()
        sim.init1()
        sim.iniLoad(os.path.join(gaia_dir, "ini", "default.ini"))
        sim.iniLoad(f_ini)
        sim.init2()
        if args.mode == "GAIA":
            # self-contained native run: momentum from the engine's own
            # urf_mm iterative solver (prepare_gaia_ini.py:139-146)
            sim.setSolveMomentum(True)
        out = rollout_native(
            sim, stepper, mode=args.mode, t_end=args.t_end,
            intervene_ts=args.intervene_TS,
            warm_up_steps=args.warm_up_steps,
            save_steps=args.save_steps, write_steps=args.write_steps,
            gaia_dir=gaia_dir, core_cool=bool(args.core_cool),
            p_pred=bool(args.p_pred), max_steps=args.max_steps)
        print(f"native rollout done: t={out[0]:.4f} steps={out[1]}")
        return out

    stokes_fn = None
    if args.mode == "ML_PRE":
        from ..physics.stokes import make_stokes_fn
        stokes_fn = make_stokes_fn(grid, args.raq)

    engine = SimEngine(
        stepper, mode=args.mode, intervene_ts=args.intervene_TS,
        radioactive_decay=bool(args.radioactive_decay),
        core_cool=bool(args.core_cool), Di=args.Di, stokes_fn=stokes_fn)

    T0 = initial_temperature(grid, args.raq, args.fkt, args.fkp,
                             args.initialization)
    n_steps = args.max_steps or 2000
    state, trace, _ = rollout_torch(
        engine, torch.as_tensor(T0, dtype=dtype)[None], n_steps,
        gaia_dir=gaia_dir, mode=args.mode,
        snapshot_every=max(1, n_steps // args.save_steps))
    print(f"torch rollout done: t={float(state.t):.5f} steps={n_steps} "
          f"meanT={float(trace.mean_T[-1]):.4f}")
    return state


if __name__ == "__main__":
    main()
