#!/usr/bin/env python3
"""Coupled rollout throughput of the PyTorch/CUDA port: ``bench.py``'s
benchmark on one NVIDIA card.

The configuration is ``bench.py``'s: a 256×256 grid (``PMC_BENCH_H``,
``PMC_BENCH_W``), ``SimParams(3.0, 1e8, 10.0)``, the flagship NewFluidNet
(levels=5, c_h=16, repeats=6, k=5, learned padding, GELU, curl head) with
weights from ``np.random.default_rng(0)``, run through the fused executor
(``models/fast_path.py::FastNewFluidNet``) in the ML_STOKES engine with
cn_max 0.99, from ``bench.py``'s initial field. 20 warm-up steps, then the
best of 3 × 500 timed steps, each timed run ending in
``torch.cuda.synchronize()``. While timing it counts the kernel wrappers'
launches and fails unless each step made 4 ``layer_stack``, 1 ``trunk``
and 1 ``curl_advect_epilogue`` launches (and no
``advect_diffuse_step_fused``): the number is the kernels' number. It
fails if T is not finite.

Prints ONE JSON line on stdout::

  {"metric": "torch_coupled_rollout_steps_per_s_{H}x{W}", "value": N,
   "unit": "steps/s", "device": ..., "power_limit": ..., ...}

It runs on the card (``python3 bench_torch.py``); ``--device cpu`` runs
it on the CPU with 4 warm-up and 10 timed steps, where each stage runs its
plain PyTorch version and no kernel is launched (so every launch count
must be 0). With no CUDA device and no ``--device cpu`` it exits with an
error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# wrapper launches per fused ML_STOKES step on the card
LAUNCHES_PER_STEP = {"layer_stack": 4, "trunk": 1, "curl_advect_epilogue": 1,
                     "advect_diffuse_step_fused": 0}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def counters():
    """The kernel wrappers of the fused step, by name (each counts its
    launches in ``.launches``)."""
    from pbml_mantle_convection_tpu_torch.ops.advect_kernel import (
        advect_diffuse_step_fused)
    from pbml_mantle_convection_tpu_torch.ops.branch_kernel import layer_stack
    from pbml_mantle_convection_tpu_torch.ops.epilogue_kernel import (
        curl_advect_epilogue)
    from pbml_mantle_convection_tpu_torch.ops.merge_kernel import trunk
    return {"layer_stack": layer_stack, "trunk": trunk,
            "curl_advect_epilogue": curl_advect_epilogue,
            "advect_diffuse_step_fused": advect_diffuse_step_fused}


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("bench_torch: no CUDA device (pass --device cpu to "
                         "run on the CPU)")
    from pbml_mantle_convection_tpu_torch.cli.benchmark import (
        initial_temperature)
    from pbml_mantle_convection_tpu_torch.constants import SimParams
    from pbml_mantle_convection_tpu_torch.models.fast_path import (
        FastNewFluidNet)
    from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet
    from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine
    from pbml_mantle_convection_tpu_torch.sim.grid import Grid
    from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper
    from pbml_mantle_convection_tpu_torch.utils.card import card_info

    H = int(os.environ.get("PMC_BENCH_H", "256"))
    W = int(os.environ.get("PMC_BENCH_W", "256"))
    card = card_info(device)
    log(f"device: {card['device']}, power limit {card['power_limit']}")
    grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2) if H != W else 1.0)
    params = SimParams(raq=3.0, fkt=1e8, fkp=10.0)
    model = NewFluidNet(levels=5, c_i=7, c_h=16, c_o=1, act_fn="gelu",
                        r_p="learned", loss_type="curl", repeats=6, f=5,
                        p_pred=False, seed=0, device=device)
    log(f"model params: {sum(p.numel() for p in model.parameters())}")
    engine = SimEngine(TimeStepper(grid, params, FastNewFluidNet(model, H, W),
                                   cn_max=0.99, device=device),
                       mode="ML_STOKES")
    state = engine.init_state(initial_temperature(grid))

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    n_warm, n_bench, reps = (20, 500, 3) if on_card else (4, 10, 3)
    t0 = time.perf_counter()
    state, _ = engine.multi_step(state, n_warm)
    sync()
    log(f"warm-up (kernel build included): {time.perf_counter() - t0:.1f}s")

    fns = counters()
    before = {k: fn.launches for k, fn in fns.items()}
    best = 0.0
    for rep in range(reps):
        t0 = time.perf_counter()
        state, trace = engine.multi_step(state, n_bench)
        sync()
        dt_wall = time.perf_counter() - t0
        best = max(best, n_bench / dt_wall)
        log(f"rep {rep}: {n_bench} steps in {dt_wall:.3f}s -> "
            f"{n_bench / dt_wall:.1f} steps/s "
            f"(meanT={float(trace.mean_T[-1]):.4f})")
    steps = reps * n_bench
    got = {k: fn.launches - before[k] for k, fn in fns.items()}
    want = {k: n * steps * on_card for k, n in LAUNCHES_PER_STEP.items()}
    if got != want:
        raise RuntimeError(f"bench_torch: launches {got} in {steps} steps, "
                           f"want {want}")
    if not bool(torch.isfinite(state.T).all()):
        raise RuntimeError("bench_torch: rollout diverged (T not finite)")

    rec = {"metric": f"torch_coupled_rollout_steps_per_s_{H}x{W}",
           "value": round(best, 2), "unit": "steps/s", **card,
           "steps": n_bench, "reps": reps, "warmup_steps": n_warm,
           "launches_per_step": {k: n / steps for k, n in got.items()}}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
