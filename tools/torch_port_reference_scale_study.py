"""Reference-scale training study on the port: the flagship trained on
multi-simulation GAIA data at 128×506, restarted from its checkpoint
halfway, then rolled out on a held-out simulation.

The port's counterpart of ``tools/reference_scale_study.py``, with its
flags and defaults (the reference: multigpu.py:694-759, 150 epochs over
rank-sharded simulation lists, rolled out through
advect_wi_gaia.py:583-677):

1. **data**: ``--n-train-sims`` GAIA-mode simulations at ``--H`` ×
   ``--W`` with dataset-range viscosity contrasts (fkt ≥ 1e6,
   prepare_gaia_ini.py:33-35), each rolled out with the ptol-converged PT
   Stokes solve (``physics/stokes.py``, the MUMPS stand-in) and
   snapshotted into one multi-simulation ``SnapshotStore``; each
   simulation's first 5 snapshots form the "init" store
   (datasetio.py:441-457), every 8th other one the cv store;
2. **training**: the flagship (levels 5, c_h 16, repeats 6, k 5, learned
   padding, curl head, loss_scale + derivative loss) through
   ``train/trainer.py::Trainer`` (init-batch mixing, MultiStepLR, the
   reference-format loss log) in float32, stopped at half the epochs and
   resumed by a second ``Trainer(restart=True)``, which must start at that
   epoch (multigpu.py:621-670). One process per card: under ``torchrun``
   the world's size is ``n_devices``;
3. **evaluation**: a held-out simulation rolled out in ML_STOKES and
   ML_PRE through the fused executor (``models/fast_path.py``:
   ``layer_stack``, ``trunk`` and ``curl_advect_epilogue`` or
   ``advect_diffuse_step_fused`` on the card), against its GAIA
   trajectory: final-T RMSE and Pearson r, mean-T trace RMSE, the
   horizontally averaged profile's MAE, beside an untrained surrogate
   (a seeded torch init, seed 123): the trained-vs-untrained margin.

The (raq, fkt, fkp) triples are JAX's: ``--sims-pt`` names the
reference's ``Paper/FiguresData/sims.pt`` (130 simulations), from which
:func:`real_paras` picks as JAX does; without it, or when too few
simulations pass the filters, the fallback triples ``TRAIN_PARAS`` and
``HOLDOUT_PARA``.

Writes ``torch_port_refscale.md`` and ``torch_port_refscale.json`` under
``--out-dir`` (default ``build/studies/``), with the card's name and
power limit; the Trainer's run directory is ``--run-dir``::

    python3 tools/torch_port_reference_scale_study.py [--steps 150]
    python3 tools/torch_port_reference_scale_study.py --device cpu \\
        --H 34 --W 66 --steps 6 --epochs 2 --n-train-sims 2

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
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_port_study_util import (  # noqa: E402
    OUT_DIR, launches, launches_per_step, study_device, sync)
from pbml_mantle_convection_tpu_torch.constants import SimParams  # noqa: E402
from pbml_mantle_convection_tpu_torch.data.dataset import (  # noqa: E402
    SnapshotDataset, SnapshotStore)
from pbml_mantle_convection_tpu_torch.models.fast_path import (  # noqa: E402
    FastNewFluidNet)
from pbml_mantle_convection_tpu_torch.models.registry import (  # noqa: E402
    ModelConfig, build_model)
from pbml_mantle_convection_tpu_torch.physics.stokes import make_stokes_fn  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.grid import Grid  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper  # noqa: E402
from pbml_mantle_convection_tpu_torch.train.trainer import (  # noqa: E402
    TrainConfig, Trainer)
from pbml_mantle_convection_tpu_torch.utils.card import card_info  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.evaluation import (  # noqa: E402
    compare_rollouts, pearson, temperature_rmse)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--H", type=int, default=128)
    p.add_argument("--W", type=int, default=506)
    p.add_argument("--steps", type=int, default=150,
                   help="GAIA ground-truth steps per simulation")
    p.add_argument("--snap-every", type=int, default=1)
    p.add_argument("--epochs", type=int, default=24)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--levels", type=int, default=5)
    p.add_argument("--c_h", type=int, default=16)
    p.add_argument("--repeats", type=int, default=6)
    p.add_argument("--n-train-sims", type=int, default=3)
    p.add_argument("--n-iter", type=int, default=20000,
                   help="PT iteration budget per solve (ptol early-stops)")
    p.add_argument("--eval-steps", type=int, default=0,
                   help="rollout steps for evaluation (0 = --steps)")
    p.add_argument("--out-dir", type=str, default=OUT_DIR)
    p.add_argument("--run-dir", type=str,
                   default=os.path.join(OUT_DIR, "refscale_run"))
    p.add_argument("--sims-pt", type=str, default=None,
                   help="the reference's sims.pt (default: the fallback "
                        "parameter triples)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


# Fallback parameter triples inside the dataset's ranges (constants.py
# clip bounds; prepare_gaia_ini.py:33-35): raq in [~1, 9.4], fkt to
# 10^9.9, fkp to 100. Used when the reference's sims.pt metadata (130
# sims, tuples (id, split, raq, fkt, fkp, grid, ar, path),
# datasetio.py:33,96) is not given.
TRAIN_PARAS = [(3.0, 1e6, 5.0), (5.0, 1e7, 10.0), (2.0, 3e6, 2.0)]
HOLDOUT_PARA = (4.0, 3e6, 7.0)
BLACKLIST = (8, 39)  # datasetio.py:96


def real_paras(n_train: int, fkt_max: float = 3e8, path=None):
    """Real (raq, fkt, fkp) triples from the reference's sims.pt at
    ``path``: ``n_train`` train-split sims plus one test-split holdout,
    skipping the blacklist [8, 39] (datasetio.py:33,96), ranked by fkt and
    picked at even quantiles below ``fkt_max`` (the PT solve's practical
    bound on the study's iteration budget). Returns (train_paras,
    holdout_para, (train ids, holdout id)), or None without the file or
    when too few sims pass the filters (then the fallback triples)."""
    if path is None or not os.path.exists(path):
        return None
    sims = torch.load(path, weights_only=True)

    def pick(split, k):
        rows = sorted((s for s in sims
                       if s[1] == split and s[0] not in BLACKLIST
                       and s[3] <= fkt_max),
                      key=lambda s: s[3])
        if len(rows) < k:
            return None
        idx = [round(i * (len(rows) - 1) / max(k - 1, 1))
               for i in range(k)]
        return [rows[i] for i in idx]

    tr = pick("train", n_train)
    ho_rows = pick("test", 3)
    if tr is None or ho_rows is None:
        return None
    ho = ho_rows[1]  # the mid-quantile test sim
    paras = [(float(s[2]), float(s[3]), float(s[4])) for s in tr]
    return paras, (float(ho[2]), float(ho[3]), float(ho[4])), (
        [int(s[0]) for s in tr], int(ho[0]))


def main(argv=None, init_weights=None, untrained_weights=None):
    """Runs the study; returns its record (the JSON file's contents).
    ``init_weights`` / ``untrained_weights``: state dicts of the
    Trainer's initial model and of the untrained baseline (default:
    seeded torch inits, seeds 0 and 123)."""
    args = build_parser().parse_args(argv)
    device = study_device("torch_port_reference_scale_study", args.device)
    eval_steps = args.eval_steps or args.steps

    sel = real_paras(args.n_train_sims, path=args.sims_pt)
    if sel is not None:
        train_paras, holdout_para, (train_ids, holdout_id) = sel
        print(f"[paras] real sims.pt triples: train ids {train_ids}, "
              f"holdout id {holdout_id} (test split)")
    else:
        train_paras, holdout_para = TRAIN_PARAS, HOLDOUT_PARA
        train_ids, holdout_id = None, None
        print("[paras] sims.pt not given; using the fallback triples")

    dtype = torch.float32
    grid = Grid(H=args.H, W=args.W, aspect=(args.W - 2) / (args.H - 2))
    card = card_info(device)
    print(f"device={card['device']} grid={args.H}x{args.W} "
          f"aspect={grid.aspect:.2f}")

    def t_init(seed):
        """Smooth conductive + perturbation initial state."""
        rs = np.random.default_rng(seed)
        amp = 0.04 + 0.02 * rs.random()
        kx = rs.integers(2, 5)
        T0 = (1.0 - grid.yc + amp * np.cos(kx * np.pi * grid.xc
                                           / grid.aspect)
              * np.sin(np.pi * grid.yc))
        T0[0, :], T0[-1, :] = 1.0, 0.0
        return torch.as_tensor(np.clip(T0, 0, 1.35), dtype=dtype)[None]

    def gaia_rollout(paras, seed, n_steps):
        """Ground-truth trajectory: the converged PT solve every step."""
        params = SimParams(*paras)
        fn = make_stokes_fn(grid, raq=params.raq, n_iter=args.n_iter)
        eng = SimEngine(
            TimeStepper(grid, params, None, dtype=dtype, device=device),
            mode="GAIA", stokes_fn=fn)
        state = eng.init_state(t_init(seed))
        snaps, t_vec, mT = [], [], []
        for i in range(n_steps):
            state = eng.step(state)
            pt_iters.append(int(fn.n_done.max()))
            if i % args.snap_every == 0:
                snaps.append(tuple(f[0].cpu().numpy()
                                   for f in (state.T, state.u, state.v)))
            t_vec.append(float(state.t))
            mT.append(float(state.T.mean()))
        return state, snaps, np.asarray(t_vec), np.asarray(mT)

    # ---- 1. ground-truth data ----
    pt_iters = []               # PT iterations of every GAIA solve
    t_start = time.time()
    all_snaps, all_paras, all_steps, all_sids = [], [], [], []
    for sid, paras in enumerate(train_paras):
        t0 = time.time()
        _, snaps, _, _ = gaia_rollout(paras, seed=100 + sid,
                                      n_steps=args.steps)
        print(f"[data] sim {sid} raq={paras[0]} fkt={paras[1]:.0e} "
              f"fkp={paras[2]}: {len(snaps)} snapshots "
              f"({time.time() - t0:.0f}s)")
        all_snaps += snaps
        all_paras += [paras] * len(snaps)
        all_steps += [i * args.snap_every + 1 for i in range(len(snaps))]
        all_sids += [sid] * len(snaps)
    data_s = time.time() - t_start

    def mk_store(sel):
        return SnapshotStore(
            T=np.asarray([all_snaps[i][0] for i in sel]),
            u=np.asarray([all_snaps[i][1] for i in sel]),
            v=np.asarray([all_snaps[i][2] for i in sel]), p=None,
            paras=np.asarray([all_paras[i] for i in sel], np.float64),
            step_index=np.asarray([all_steps[i] for i in sel], np.float64),
            sim_id=np.asarray([all_sids[i] for i in sel], np.float64),
            times=np.zeros(len(sel)), xc=grid.xc, yc=grid.yc)

    idx = np.arange(len(all_snaps))
    is_init = np.asarray([all_steps[i] <= 5 * args.snap_every for i in idx])
    main_idx = idx[~is_init]
    ds_main = mk_store(main_idx[main_idx % 8 != 0])
    ds_cv = mk_store(main_idx[main_idx % 8 == 0])
    ds_init = mk_store(idx[is_init])
    print(f"[data] store: {len(ds_main)} train / {len(ds_cv)} cv / "
          f"{len(ds_init)} init snapshots ({data_s:.0f}s total)")
    kw = dict(scale=True, dtype=dtype, device=device)
    train_data = SnapshotDataset(ds_main, noise=1e-5, **kw)
    cv_data = SnapshotDataset(ds_cv, **kw)
    init_data = SnapshotDataset(ds_init, **kw)

    # ---- 2. flagship training through Trainer, with a restart ----
    # learned-padding k=5 layers need >= 6 px in the deepest pooled
    # branch: clamp for small grids
    levels = args.levels
    while levels > 1 and min(args.H, args.W) // 2 ** (levels - 1) < 6:
        levels -= 1
    if levels != args.levels:
        print(f"[cfg] levels {args.levels} -> {levels} for the "
              f"{args.H}x{args.W} grid (deepest branch >= 6 px)")
    args.levels = levels
    mc = ModelConfig(network="newfluidnet", levels=args.levels,
                     c_h=args.c_h, repeats=args.repeats, kernel=5,
                     r_p="learned", loss_type="curl", p_pred=False,
                     H=args.H, W=args.W, dtype=dtype)
    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    cfg = TrainConfig(
        model=mc, epochs=args.epochs, batch_size=args.batch_size,
        start_lr=2e-3, loss_scale=True, loss_derivative=True,
        milestones=tuple(int(args.epochs * f) for f in (0.4, 0.65, 0.85)),
        n_devices=n_dev, seed=0, device=str(device))
    os.makedirs(args.run_dir, exist_ok=True)

    half = max(1, args.epochs // 2)
    t0 = time.time()
    tr = Trainer(cfg, train_data, cv_data, train_data_init=init_data,
                 cv_data_init=init_data, nn_dir=args.run_dir)
    if init_weights is not None:
        tr.model.load_state_dict(init_weights)
    tr.train(epochs=half)
    print(f"[train] first leg done at epoch {half} "
          f"({time.time() - t0:.0f}s); restarting from checkpoint")
    # a fresh Trainer re-derives the epoch from the loss log and reloads
    # the weights and the optimizer state (multigpu.py:621-670)
    tr2 = Trainer(cfg, train_data, cv_data, train_data_init=init_data,
                  cv_data_init=init_data, nn_dir=args.run_dir, restart=True)
    if tr2.start_epoch != half:
        raise RuntimeError(f"restart resumed at epoch {tr2.start_epoch}, "
                           f"not {half}")
    model = tr2.train()
    sync(device)
    train_wall = time.time() - t0
    print(f"[train] {args.epochs} epochs in {train_wall:.0f}s")

    untrained = build_model(mc, seed=123, device=device)
    if untrained_weights is not None:
        untrained.load_state_dict(untrained_weights)

    # ---- 3. held-out evaluation ----
    params_h = SimParams(*holdout_para)
    st_ref, _, tv_ref, mT_ref = gaia_rollout(holdout_para, seed=999,
                                             n_steps=eval_steps)
    T_ref = st_ref.T[0].cpu().numpy()

    def surrogate_rollout(net, mode):
        fast = FastNewFluidNet(net, args.H, args.W)
        stepper = TimeStepper(grid, params_h, fast, cn_max=0.99,
                              dtype=dtype, device=device)
        kw = {}
        if mode == "ML_PRE":
            kw["stokes_fn"] = make_stokes_fn(
                grid, raq=params_h.raq, n_iter=args.n_iter,
                pre_iter=max(args.n_iter // 10, 1))
        eng = SimEngine(stepper, mode=mode, **kw)
        state = eng.init_state(t_init(999))
        sync(device)
        before = launches()
        t0 = time.time()
        state, trace = eng.multi_step(state, eval_steps)
        sync(device)
        wall = time.time() - t0
        cmp = compare_rollouts(tv_ref, mT_ref, trace.t.cpu().numpy(),
                               trace.mean_T.cpu().numpy())
        Tp = state.T[0].cpu().numpy()
        prof_mae = float(np.mean(np.abs(Tp.mean(axis=1)
                                        - T_ref.mean(axis=1))))
        return dict(t_rmse=temperature_rmse(Tp, T_ref),
                    pearson=pearson(Tp, T_ref),
                    trace_rmse=cmp["rmse"], profile_mae=prof_mae,
                    wall_s=wall,
                    launches_per_step=launches_per_step(before, eval_steps))

    rows = {}
    for name, net, mode in [("ML_STOKES (trained)", model, "ML_STOKES"),
                            ("ML_PRE (trained)", model, "ML_PRE"),
                            ("ML_STOKES (untrained)", untrained,
                             "ML_STOKES")]:
        print(f"[eval] rollout {name}...")
        rows[name] = surrogate_rollout(net, mode)
        print(f"       {rows[name]}")

    # ---- 4. report ----
    margin = (rows["ML_STOKES (untrained)"]["t_rmse"]
              / max(rows["ML_STOKES (trained)"]["t_rmse"], 1e-12))
    lines = [
        "# Reference-scale training study of the PyTorch port",
        "",
        f"Flagship config (levels={args.levels}, c_h={args.c_h}, "
        f"repeats={args.repeats}, k=5, learned padding, curl head, "
        "loss_scale + derivative loss) trained through `Trainer` "
        "(init-batch mixing, MultiStepLR, reference-format loss log, "
        f"checkpoint restart at epoch {half}) on a {len(ds_main)}-snapshot "
        f"multi-sim store: {len(train_paras)} GAIA simulations at "
        f"{args.H}x{args.W} (sims.pt train ids {train_ids}), {args.steps} "
        "converged-PT-solve steps each (fkt up to "
        f"{max(p[1] for p in train_paras):.0e}). Held-out sim (sims.pt "
        f"test id {holdout_id}): raq={holdout_para[0]:.3f}, "
        f"fkt={holdout_para[1]:.2e}, fkp={holdout_para[2]:.3f}, "
        f"{eval_steps} steps. {card['device']} ({card['power_limit']}), "
        f"{args.epochs} epochs over {n_dev} process(es), float32, train "
        f"wall {train_wall:.0f}s, data {data_s:.0f}s ({len(pt_iters)} "
        f"GAIA steps, {np.mean(pt_iters):.0f} PT iterations per solve, "
        f"at most {max(pt_iters)}) "
        "(tools/torch_port_reference_scale_study.py).",
        "",
        "| rollout | final T-RMSE | Pearson r | mean-T trace RMSE | "
        "profile MAE | wall (s) |",
        "|---|---|---|---|---|---|",
    ]
    for name, r in rows.items():
        lines.append(
            f"| {name} | {r['t_rmse']:.5f} | {r['pearson']:.5f} | "
            f"{r['trace_rmse']:.6f} | {r['profile_mae']:.5f} | "
            f"{r['wall_s']:.2f} |")
    lines += ["", f"Trained-vs-untrained margin: **{margin:.1f}x** lower "
              "final-T RMSE on the held-out simulation.", ""]
    out = {"grid": [args.H, args.W], "epochs": args.epochs,
           "steps": args.steps, "eval_steps": eval_steps,
           "levels": args.levels, **card, "n_devices": n_dev,
           "train_wall_s": train_wall, "data_s": data_s,
           "start_epoch_after_restart": tr2.start_epoch,
           "gaia_steps": len(pt_iters),
           "pt_iters_per_solve": float(np.mean(pt_iters)),
           "pt_iters_max": max(pt_iters),
           "train_paras": train_paras, "holdout_para": holdout_para,
           "train_sim_ids": train_ids, "holdout_sim_id": holdout_id,
           "snapshots": [len(ds_main), len(ds_cv), len(ds_init)],
           "margin": margin, "rows": rows}
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "torch_port_refscale.md"),
              "w") as f:
        f.write("\n".join(lines))
    with open(os.path.join(args.out_dir, "torch_port_refscale.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print("\n".join(lines))
    return out


if __name__ == "__main__":
    main()
