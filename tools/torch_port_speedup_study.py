"""Hermetic speedup / ablation study on the port: the reference's solver
comparison (load_advection_results-checkpoint.ipynb cell 5: GAIA-MUMPS vs
GAIA-momentum-skips vs ML_STOKES), without the reference dataset.

The port's counterpart of ``tools/speedup_study.py``, with its flags,
defaults, float64 and numpy draws:

1. ground truth: a ``mode="GAIA"`` rollout with the converged PT Stokes
   solve (``physics/stokes.py``, the MUMPS stand-in), timed per step;
2. the surrogate (NewFluidNet levels 2, c_h 8, repeats 2, k 5, learned
   padding, curl head) trained on that trajectory: every 4th step's
   fields in a ``SnapshotStore``, ``--train-iters`` batches of 8 through
   ``train/train_step.py`` with ``torch.optim.Adam(2e-3)``; one batch is
   drawn first, as JAX draws one for ``model.init``, so that both train
   on the same batches;
3. the same span rolled out in each solver configuration: GAIA-skipN
   (momentum every N steps, MMSolverSkip), ML_STOKES (the surrogate's
   velocities every step, the module path) and ML_PRE (the surrogate
   warm-starts a PT refinement of n_iter // 10 iterations);
4. per mode: wall/step (host clock around each step, ending in a
   ``torch.cuda.synchronize()``, one warm-up step first), speedup vs GAIA,
   final T-RMSE and Pearson r against the ground truth, the mean-T
   trace RMSE (``utils/evaluation.py``), the PT iterations of each
   momentum solve (``StokesFn.n_done``, read after the step's timing),
   and the kernel wrappers' launches per step.

Writes ``torch_port_speedup.md`` and ``torch_port_speedup.json`` under
``--out-dir`` (default ``build/studies/``), with the card's name and
power limit::

    python3 tools/torch_port_speedup_study.py [--steps 300] [--H 128 --W 506]
    python3 tools/torch_port_speedup_study.py --device cpu --H 18 --W 26 \\
        --steps 8 --train-iters 4 --n-iter 200

It runs on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_port_study_util import (  # noqa: E402
    OUT_DIR, launches, launches_per_step, study_device, sync)
from pbml_mantle_convection_tpu_torch.constants import SimParams  # noqa: E402
from pbml_mantle_convection_tpu_torch.data.dataset import (  # noqa: E402
    SnapshotDataset, SnapshotStore)
from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu_torch.physics.stokes import make_stokes_fn  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.grid import Grid  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper  # noqa: E402
from pbml_mantle_convection_tpu_torch.train.train_step import (  # noqa: E402
    TrainStepConfig, make_train_step)
from pbml_mantle_convection_tpu_torch.utils.card import card_info  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.evaluation import (  # noqa: E402
    compare_rollouts, pearson, temperature_rmse)

# the surrogate of JAX's study (speedup_study.py:158-160)
ARCH = dict(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu", r_p="learned",
            loss_type="curl", repeats=2, f=5, p_pred=False)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--train-iters", type=int, default=160)
    ap.add_argument("--out-dir", type=str, default=OUT_DIR)
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (default) or 'cpu'")
    # the time-dependent regime of JAX's defaults (every economy has a
    # measurable cost there)
    ap.add_argument("--H", type=int, default=50)
    ap.add_argument("--W", type=int, default=74)
    ap.add_argument("--raq", type=float, default=9.0)
    ap.add_argument("--fkt", type=float, default=1e5)
    ap.add_argument("--fkp", type=float, default=2.0)
    ap.add_argument("--n-iter", type=int, default=4000,
                    help="converged PT iterations (the MUMPS stand-in)")
    ap.add_argument("--skip", type=int, default=10,
                    help="GAIA-skipN momentum-solve cadence")
    return ap


def run(engine, T0, n_steps, device, record=False):
    """Step-by-step timed rollout (one warm-up step first, from the same
    start); returns (final state, per-step seconds, t, mean T, snapshots
    of every 4th step if ``record``, launches per step, the PT iterations
    of each momentum solve)."""
    engine.step(engine.init_state(T0))
    sync(device)
    state = engine.init_state(T0)
    ts, t_vec, mT, snaps, pt = [], [], [], [], []
    fn = engine.stokes_fn
    before = launches()
    for i in range(n_steps):
        done = fn.n_done if fn is not None else None
        t0 = time.perf_counter()
        state = engine.step(state)
        sync(device)
        ts.append(time.perf_counter() - t0)
        if fn is not None and fn.n_done is not done:   # a solve ran
            pt.append(int(fn.n_done.max()))
        t_vec.append(float(state.t))
        mT.append(float(state.T.mean()))
        if record and i % 4 == 0:
            snaps.append(tuple(f[0].cpu().numpy()
                               for f in (state.T, state.u, state.v)))
    return (state, np.asarray(ts), np.asarray(t_vec), np.asarray(mT), snaps,
            launches_per_step(before, n_steps), pt)


def pt_record(pt):
    """The momentum solves of a rollout and their mean PT iterations."""
    return {"solves": len(pt),
            "pt_iters_per_solve": float(np.mean(pt)) if pt else None}


def main(argv=None, init_weights=None):
    """Runs the study; returns its record (the JSON file's contents).
    ``init_weights``: the surrogate's initial state dict (default: a
    seeded torch init)."""
    args = build_parser().parse_args(argv)
    device = study_device("torch_port_speedup_study", args.device)
    f64 = torch.float64

    grid = Grid(H=args.H, W=args.W, aspect=(args.W - 2) / (args.H - 2))
    params = SimParams(raq=args.raq, fkt=args.fkt, fkp=args.fkp)
    n_steps, N_ITER = args.steps, args.n_iter
    PRE_ITER = max(N_ITER // 10, 50)  # ML_PRE refinement budget

    T0 = np.clip(1.0 - grid.yc + 0.05 * np.sin(4 * grid.xc)
                 * np.sin(np.pi * grid.yc), 0, 1)[None]
    null_stepper = TimeStepper(grid, params, None, dtype=f64, device=device)

    def stokes(**kw):
        return make_stokes_fn(grid, raq=params.raq, n_iter=N_ITER, **kw)

    # ---- 1. ground truth ----
    print("[1/4] ground-truth GAIA rollout (converged PT solver)...")
    eng_gaia = SimEngine(null_stepper, mode="GAIA", stokes_fn=stokes())
    st_ref, ts_gaia, tv_ref, mT_ref, snaps, gaia_launch, gaia_pt = run(
        eng_gaia, T0, n_steps, device, record=True)
    T_final_ref = st_ref.T[0].cpu().numpy()
    vigor = {
        "mean_T_drift": float(np.ptp(mT_ref)),
        "mean_T_late_std": float(np.std(mT_ref[len(mT_ref) // 2:])),
        "v_rms_final": float(np.sqrt(np.mean(
            st_ref.u[0].cpu().numpy() ** 2
            + st_ref.v[0].cpu().numpy() ** 2))),
    }
    print(f"    regime vigor: mean-T drift {vigor['mean_T_drift']:.2e}, "
          f"late std {vigor['mean_T_late_std']:.2e}, "
          f"v_rms {vigor['v_rms_final']:.3g}")

    # ---- 2. train the surrogate on the trajectory ----
    print("[2/4] training the surrogate on the trajectory...")
    n = len(snaps)
    store = SnapshotStore(
        T=np.asarray([s[0] for s in snaps]),
        u=np.asarray([s[1] for s in snaps]),
        v=np.asarray([s[2] for s in snaps]), p=None,
        paras=np.tile([params.raq, params.fkt, params.fkp], (n, 1)),
        step_index=np.arange(1, n + 1, dtype=np.float64),
        sim_id=np.zeros(n), times=np.zeros(n), xc=grid.xc, yc=grid.yc)
    ds = SnapshotDataset(store, scale=True, dtype=f64, device=device)
    model = NewFluidNet(**ARCH, seed=0, device=device, dtype=f64)
    if init_weights is not None:
        model.load_state_dict(init_weights)
    rng = np.random.default_rng(0)
    ds.batch(rng, 8)            # JAX's model.init batch
    opt = torch.optim.Adam(model.parameters(), lr=2e-3)
    tstep = make_train_step(model, opt, TrainStepConfig(
        net="newfluidnet", loss_type="curl", loss_derivative=True))
    t0 = time.perf_counter()
    for _ in range(args.train_iters):
        br = tstep(ds.batch(rng, 8))
    train_loss = float(br.total)
    train_s = time.perf_counter() - t0
    print(f"    final train loss {train_loss:.5f} ({train_s:.1f} s)")
    model.eval()
    ml_stepper = TimeStepper(grid, params, model, dtype=f64, device=device)

    # ---- 3. the solver configurations ----
    configs = {
        f"GAIA-skip{args.skip}": SimEngine(
            null_stepper, mode="GAIA", intervene_ts=args.skip,
            stokes_fn=stokes()),
        "ML_STOKES": SimEngine(ml_stepper, mode="ML_STOKES"),
        "ML_PRE": SimEngine(ml_stepper, mode="ML_PRE",
                            stokes_fn=stokes(pre_iter=PRE_ITER)),
    }
    rows = {"GAIA": dict(
        wall_per_step=float(ts_gaia.mean()), speedup=1.0, t_rmse=0.0,
        pearson=1.0, trace_rmse=0.0, launches_per_step=gaia_launch,
        **pt_record(gaia_pt))}
    for i, (name, eng) in enumerate(configs.items()):
        print(f"[3/4] rollout {name} ({i + 1}/{len(configs)})...")
        st, ts, tv, mT, _, launch, pt = run(eng, T0, n_steps, device)
        T_final = st.T[0].cpu().numpy()
        rows[name] = dict(
            wall_per_step=float(ts.mean()),
            speedup=float(ts_gaia.mean() / ts.mean()),
            t_rmse=temperature_rmse(T_final, T_final_ref),
            pearson=pearson(T_final, T_final_ref),
            trace_rmse=compare_rollouts(tv_ref, mT_ref, tv, mT)["rmse"],
            launches_per_step=launch, **pt_record(pt))

    # ---- 4. report ----
    card = card_info(device)
    print("[4/4] writing torch_port_speedup.md / .json")
    lines = [
        "# Speedup / ablation table of the PyTorch port",
        "",
        f"Solver-configuration comparison on a {grid.H}x{grid.W} grid "
        f"(aspect {grid.aspect}, raq={params.raq}, fkt={params.fkt:g}, "
        f"fkp={params.fkp:g}), {n_steps} coupled steps, float64, "
        f"{card['device']} ({card['power_limit']}). Ground truth: mode=GAIA "
        f"with the converged PT Stokes solve ({N_ITER} it/step at most, "
        "ptol 1e-5). The surrogate is trained on the ground-truth "
        f"trajectory ({args.train_iters} batches of 8, final loss "
        f"{train_loss:.5f}; tools/torch_port_speedup_study.py).",
        "",
        "| mode | wall/step (ms) | speedup vs GAIA | final T-RMSE | "
        "Pearson r | mean-T trace RMSE | PT its/solve (solves) | "
        "launches/step (ls+tr+ep+adv) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for name, r in rows.items():
        lp = r["launches_per_step"]
        lines.append(
            f"| {name} | {r['wall_per_step'] * 1e3:.2f} | "
            f"{r['speedup']:.2f}x | {r['t_rmse']:.5f} | "
            f"{r['pearson']:.5f} | {r['trace_rmse']:.6f} | "
            f"{r['pt_iters_per_solve'] or 0:.0f} ({r['solves']}) | "
            f"{lp['layer_stack']:g}+{lp['trunk']:g}+"
            f"{lp['curl_advect_epilogue']:g}+"
            f"{lp['advect_diffuse_step_fused']:g} |")
    lines += [
        "",
        f"Regime vigor (ground truth over the span): mean-T drift "
        f"{vigor['mean_T_drift']:.2e}, late-half mean-T std "
        f"{vigor['mean_T_late_std']:.2e}, final v_rms "
        f"{vigor['v_rms_final']:.3g}.",
        "",
    ]
    out = {"grid": [grid.H, grid.W], "steps": n_steps,
           "params": [params.raq, params.fkt, params.fkp],
           "n_iter": N_ITER, "pre_iter": PRE_ITER,
           "train_iters": args.train_iters, "train_loss": train_loss,
           "train_s": train_s, "vigor": vigor, **card, "rows": rows}
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "torch_port_speedup.md"), "w") as f:
        f.write("\n".join(lines))
    with open(os.path.join(args.out_dir, "torch_port_speedup.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print("\n".join(lines))
    return out


if __name__ == "__main__":
    main()
