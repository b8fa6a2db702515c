"""500-step T-RMSE of the port's float32 card paths against its float64
trajectory (the method of ``tools/tpu_accuracy.py``).

One coupled rollout (``bench.py``'s configuration: the flagship
NewFluidNet, levels=5, c_h=16, repeats=6, k=5, learned padding, curl
head, weights from ``np.random.default_rng(seed)``; SimParams(3.0, 1e8,
10.0); ``bench.py``'s initial field; cn_max 0.99) runs from the same start
with the same weights several times:

1. **reference** — the port's plain module path in float64 on the card:
   the NewFluidNet module with the float32 weights cast, and the energy
   step's plain PyTorch version (``advect_diffuse_step_plain``, put in
   place of the kernel wrapper in ``sim/stepper.py`` and ``sim/engine.py``
   for this leg), so the reference shares no hand-written kernel with the
   legs it judges. The golden-rollout tests hold that path against the
   JAX engine at rtol 1e-10, so no JAX is needed here;
2. **variants**, each in float32 on the card:

   * ``fused`` — the fused executor (``models/fast_path.py``), the path
     ``bench_torch.py`` times: 4 ``layer_stack`` + 1 ``trunk`` calls and
     the fused epilogue per ML_STOKES step; in the core-cooling/Di mode
     the engine runs it with the energy-step kernel instead;
   * ``module_f32`` — the module path, its cuDNN convolutions in float32
     (the port's default);
   * ``module_tf32`` — the module path with ``torch.backends.cudnn.
     allow_tf32`` on and the port's float32 guard
     (``models/layers.py::float32_convs``) lifted, inside this variant
     only; both are restored after it.

For each variant: ``T_rmse = sqrt(mean((T - T_ref)²))`` of the final field
and ``trace_mae = mean |mean_T - mean_T_ref|`` over the steps, in float64
(``tools/tpu_accuracy.py:193-195``), and steps/s of its timed run (the
rollout itself, after 2 warm-up steps, host clock ending in
``torch.cuda.synchronize()``). Each leg also counts its kernel wrappers'
launches per step (``bench_torch.counters()``), so a caller can check
which kernels each leg ran. One JSON line per run: grid, mode, steps, the
card's name and power limit, the float64 leg's seconds and launches, each
variant's three numbers and launches.

``--pad zeros`` runs the flagship with zero padding (the layer kernels'
zero-padded instance) instead of learned padding; ``--act NAME`` with
another activation of ``models/layers.py`` (the kernels' instance of
it) instead of GELU; ``--loss_type mae|mass`` and ``--p_pred 1`` with
the rollout CLI's other heads (merge 3 at c_o 2 or 3; the fused leg
then takes the energy-step kernel, as the engine gives these heads no
fused epilogue).

Runs (default): the flagship ML_STOKES rollout at 128×506 and 256×256,
and ML_STOKES with core cooling, Di=0.5 and radioactive decay (the mode
``chip_smoke.py`` drives) at 128×506::

    python3 tools/torch_port_accuracy.py [--run 128x506:ML_STOKES ...]
        [--steps 500] [--seed 0] [--device cpu]

It runs on the card; ``--device cpu`` runs it on the CPU, where every
kernel wrapper runs its plain version. With no CUDA device and no such
flag it exits with an error.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from unittest import mock

import numpy as np
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from bench_torch import counters  # noqa: E402
from pbml_mantle_convection_tpu_torch.cli.benchmark import (  # noqa: E402
    initial_temperature)
from pbml_mantle_convection_tpu_torch.constants import SimParams  # noqa: E402
from pbml_mantle_convection_tpu_torch.models import layers  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.fast_path import (  # noqa: E402
    FastNewFluidNet)
from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu_torch.ops.advect_kernel import (  # noqa: E402
    advect_diffuse_step_plain)
from pbml_mantle_convection_tpu_torch.sim import engine as engine_mod  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim import stepper as stepper_mod  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.grid import Grid  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.card import card_info  # noqa: E402

# bench.py's network and physics
ARCH = dict(levels=5, c_i=7, c_h=16, c_o=1, act_fn="gelu", r_p="learned",
            loss_type="curl", repeats=6, f=5, p_pred=False)
PARAMS = SimParams(raq=3.0, fkt=1e8, fkp=10.0)
DI_MODE = "ML_STOKES-core_cool-Di0.5-decay"
# engine options of each mode
MODES = {"ML_STOKES": {},
         DI_MODE: dict(core_cool=True, Di=0.5, radioactive_decay=True)}
# variant → (surrogate path, TF32 convs)
VARIANTS = {"fused": ("fused", False), "module_f32": ("module", False),
            "module_tf32": ("module", True)}
MODE_VARIANTS = {"ML_STOKES": ("fused", "module_f32", "module_tf32"),
                 DI_MODE: ("fused", "module_f32")}
RUNS = ("128x506:ML_STOKES", "256x256:ML_STOKES", f"128x506:{DI_MODE}")


def flagship_weights(seed: int = 0, arch=None) -> dict:
    """float32 state dict of the NewFluidNet ``arch`` (default: the
    flagship) drawn from ``np.random.default_rng(seed)``, on the CPU."""
    return NewFluidNet(**(arch or ARCH), seed=seed, device="cpu").state_dict()


@contextlib.contextmanager
def tf32_convs():
    """Inside the block the module convs run cuDNN's TF32 kernels: the
    flag is on and the port's float32 guard is lifted; both restored."""
    cudnn = torch.backends.cudnn
    old = cudnn.allow_tf32
    cudnn.allow_tf32 = True
    try:
        with mock.patch.object(layers, "float32_convs",
                               contextlib.nullcontext):
            yield
    finally:
        cudnn.allow_tf32 = old


@contextlib.contextmanager
def plain_energy_step():
    """Inside the block the stepper and the engine take the energy step's
    plain PyTorch version, not the ``advect_diffuse_step_fused`` kernel."""
    with mock.patch.object(stepper_mod, "advect_diffuse_step_fused",
                           advect_diffuse_step_plain), \
            mock.patch.object(engine_mod, "advect_diffuse_step_fused",
                              advect_diffuse_step_plain):
        yield


def rollout(weights: dict, H: int, W: int, steps: int, *,
            mode: str = "ML_STOKES", path: str = "module",
            dtype=torch.float64, device="cuda", arch=None) -> dict:
    """``steps`` coupled steps of ``mode`` from ``bench.py``'s field, the
    surrogate a NewFluidNet ``arch`` holding ``weights`` (cast to
    ``dtype``) run as the module (``path="module"``) or through the
    fused executor (``"fused"``). Returns {"T": final (1, H, W) field,
    "mean_T": (steps,) trace, both float64 numpy, "seconds": the timed
    rollout's wall time, "launches_per_step": each kernel wrapper's
    launches per step, warm-up included}."""
    device = torch.device(device)
    grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2) if H != W else 1.0)
    model = NewFluidNet(**(arch or ARCH), device=device, dtype=dtype)
    model.load_state_dict(weights)
    apply_fn = FastNewFluidNet(model, H, W) if path == "fused" else model
    engine = SimEngine(TimeStepper(grid, PARAMS, apply_fn, cn_max=0.99,
                                   dtype=dtype, device=device),
                       **MODES[mode])
    T0 = initial_temperature(grid)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fns = counters()
    before = {k: fn.launches for k, fn in fns.items()}
    n_warm = 2
    engine.multi_step(engine.init_state(T0), n_warm)    # builds, plans
    sync()
    t0 = time.perf_counter()
    state, trace = engine.multi_step(engine.init_state(T0), steps)
    sync()
    seconds = time.perf_counter() - t0
    return {"T": state.T.to(torch.float64).cpu().numpy(),
            "mean_T": trace.mean_T.to(torch.float64).cpu().numpy(),
            "seconds": seconds,
            "launches_per_step": {k: (fn.launches - before[k])
                                  / (n_warm + steps)
                                  for k, fn in fns.items()}}


def reference(weights: dict, H: int, W: int, steps: int, *,
              mode: str = "ML_STOKES", device="cuda", arch=None) -> dict:
    """The float64 leg: :func:`rollout` of the module path in float64
    with the energy step's plain version."""
    with plain_energy_step():
        return rollout(weights, H, W, steps, mode=mode, path="module",
                       dtype=torch.float64, device=device, arch=arch)


def errors(T, mean_T, T_ref, mean_T_ref) -> dict:
    """T_rmse of the final fields and trace_mae of the mean-T traces,
    float64 (``tools/tpu_accuracy.py:193-195``)."""
    T = np.asarray(T, np.float64)
    mean_T = np.asarray(mean_T, np.float64)
    return {"T_rmse": float(np.sqrt(np.mean((T - T_ref) ** 2))),
            "trace_mae": float(np.mean(np.abs(mean_T - mean_T_ref)))}


def measure(weights: dict, H: int, W: int, steps: int,
            mode: str = "ML_STOKES", device="cuda", arch=None,
            variants=None) -> dict:
    """The float64 leg and each of ``variants`` (default: the mode's
    ``MODE_VARIANTS``) for the NewFluidNet ``arch`` holding ``weights`` →
    the run's JSON record."""
    kw = dict(mode=mode, device=device, arch=arch)
    ref = reference(weights, H, W, steps, **kw)
    rec = {"grid": f"{H}x{W}", "mode": mode, "steps": steps,
           **card_info(device), "f64_seconds": ref["seconds"],
           "f64_steps_per_s": steps / ref["seconds"],
           "f64_launches_per_step": ref["launches_per_step"]}
    if not np.isfinite(ref["T"]).all():
        raise RuntimeError(f"{H}x{W} {mode}: the float64 leg diverged")
    for name in variants or MODE_VARIANTS[mode]:
        path, tf32 = VARIANTS[name]
        with tf32_convs() if tf32 else contextlib.nullcontext():
            got = rollout(weights, H, W, steps, path=path,
                          dtype=torch.float32, **kw)
        rec[name] = {**errors(got["T"], got["mean_T"], ref["T"],
                              ref["mean_T"]),
                     "steps_per_s": steps / got["seconds"],
                     "launches_per_step": got["launches_per_step"]}
    return rec


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run", action="append", default=None,
                   metavar="HxW:MODE",
                   help=f"grid and mode, repeatable (default: {RUNS}); "
                        f"modes: {sorted(MODES)}")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pad", type=str, default="learned",
                   choices=["learned", "zeros"],
                   help="the flagship's padding: learned, or zeros (the "
                        "layer kernels' zero-padded instance)")
    p.add_argument("--act", type=str, default="gelu",
                   help="the flagship's activation (an act_fn of "
                        "models/layers.py; the layer kernels' instance "
                        "of it)")
    p.add_argument("--loss_type", type=str, default="curl",
                   choices=["curl", "mae", "mass"],
                   help="the flagship's head, as the rollout CLI's -lt")
    p.add_argument("--p_pred", type=int, default=0,
                   help="1: the head also predicts p (the CLI's -pp)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def head_arch(arch, loss_type: str, p_pred: bool) -> dict:
    """``arch`` with the head ``loss_type`` (+ p with ``p_pred``) and the
    c_o it needs (the registry's: 1 for the curl head, 2 for u, v; one
    more for p)."""
    c_o = (1 if loss_type == "curl" else 2) + bool(p_pred)
    return {**arch, "loss_type": loss_type, "p_pred": bool(p_pred),
            "c_o": c_o}


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_port_accuracy: no CUDA device (pass "
                         "--device cpu to run on the CPU)")
    arch = head_arch({**ARCH, "r_p": args.pad, "act_fn": args.act},
                     args.loss_type, args.p_pred)
    weights = flagship_weights(args.seed, arch)
    out = []
    for run in args.run or RUNS:
        grid, mode = run.split(":", 1)
        H, W = (int(n) for n in grid.split("x"))
        if mode not in MODES:
            raise SystemExit(f"torch_port_accuracy: mode {mode!r}: one of "
                             f"{sorted(MODES)}")
        rec = {"r_p": args.pad, "act_fn": args.act,
               "loss_type": args.loss_type, "p_pred": bool(args.p_pred),
               **measure(weights, H, W, args.steps, mode, device=device,
                         arch=arch)}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
