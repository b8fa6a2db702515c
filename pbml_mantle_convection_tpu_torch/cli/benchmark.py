"""Benchmark CLI: surrogate inference latency and coupled rollout throughput.

Counterpart of the JAX package's ``cli/benchmark.py``, with its arguments
and its metric names; prints one JSON line. ``--what inference`` times
``--iters`` forward passes at batch 1 after one warm-up pass (the
reference's timing loop, load_fluidnet.ipynb cell 7): NewFluidNet through
the fused executor (``--raw-module``: the module), the Transolvers through
their forward. ``--what rollout`` times ``--steps`` coupled ML_STOKES
steps of a NewFluidNet after a short warm-up, ``--batch`` simulations
per step (the fused executor runs them one after another, the energy
step runs once for the batch). The inputs are the JAX CLI's: zeros for
inference, the field of ``bench.py`` for the rollout, phase-shifted per
simulation when B > 1; the weights come from seed 0::

    python -m pbml_mantle_convection_tpu_torch.cli.benchmark \\
        --what inference -net transolver_structured

It runs on the card; only ``--device cpu`` runs it elsewhere, and with no
card and no such flag it fails. It turns TF32 off for cuDNN convolutions
and matrix products (float32 throughout, as the metrics are defined) and
prints both flags beside the result.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..constants import SimParams
from ..models.fast_path import FastNewFluidNet, unsupported_reason
from ..models.registry import ModelConfig, build_model
from ..sim.engine import SimEngine
from ..sim.grid import Grid
from ..sim.stepper import TimeStepper

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def build_parser():
    p = argparse.ArgumentParser(description="benchmarks")
    p.add_argument("--what", choices=["inference", "rollout", "train"],
                   default="inference")
    p.add_argument("-net", "--network", type=str, default="newfluidnet")
    p.add_argument("-l", "--levels", type=int, default=5)
    p.add_argument("-f", "--c_h", type=int, default=16)
    p.add_argument("-r", "--repeats", type=int, default=6)
    p.add_argument("-k", "--kernel", type=int, default=5)
    p.add_argument("-pad", "--r_p", type=str, default="learned")
    p.add_argument("--H", type=int, default=128)
    p.add_argument("--W", type=int, default=506)
    p.add_argument("--iters", type=int, default=500)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--dtype", type=str, default="float32",
                   choices=sorted(_DTYPES))
    p.add_argument("--batch", type=int, default=1,
                   help="simultaneous simulations per rollout step")
    p.add_argument("--roll_forward", type=int, default=1,
                   help="--what train (not ported)")
    p.add_argument("--raw-module", action="store_true",
                   help="time the plain module instead of the fused "
                        "executor")
    p.add_argument("--donate", action="store_true",
                   help="--what train (not ported)")
    p.add_argument("--remat", action="store_true",
                   help="--what train (not ported)")
    p.add_argument("--sharded", action="store_true",
                   help="multi-card rollout (not ported)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


def _unported(args) -> str | None:
    if args.what == "train":
        return "--what train (ROADMAP queue 1 item 4)"
    if args.sharded:
        return "--sharded (ROADMAP queue 1 item 7)"
    if args.what == "rollout" and args.network != "newfluidnet":
        return (f"rollout of {args.network!r} (the port's stepper runs the "
                f"FluidNet family; ROADMAP queue 1 item 6)")
    return None


def initial_temperature(grid: Grid, batch: int = 1) -> np.ndarray:
    """(B, H, W) initial fields of the rollout as the JAX CLI builds them
    (JAX ``cli/benchmark.py:199-206``): simulation b's phase shifted by
    0.37·b, so simulation 0's is ``bench.py``'s."""
    return np.stack([np.clip(1.0 - grid.yc
                             + 0.05 * np.sin(6.28 * grid.xc + 0.37 * b),
                             0.0, 1.0) for b in range(batch)])


def inference_input(network: str, H: int, W: int, c_i: int, dtype,
                    device) -> torch.Tensor:
    """The JAX CLI's inference input (JAX ``cli/benchmark.py:79-82``):
    zeros of (1, H·W, c_i) for the Transolvers, (1, H, W, c_i) else."""
    shape = (1, H * W, c_i) if "transolver" in network else (1, H, W, c_i)
    return torch.zeros(shape, dtype=dtype, device=device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = build_parser().parse_args(argv)
    reason = _unported(args)
    if reason is not None:
        raise NotImplementedError(f"not ported yet: {reason}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("benchmark: no CUDA device (pass --device cpu to "
                         "run on the CPU)")
    dtype = _DTYPES[args.dtype]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    flags = {"tf32_conv": torch.backends.cudnn.allow_tf32,
             "tf32_matmul": torch.backends.cuda.matmul.allow_tf32}
    H, W = args.H, args.W
    mc = ModelConfig(network=args.network, levels=args.levels,
                     c_h=args.c_h, repeats=args.repeats, kernel=args.kernel,
                     r_p=args.r_p, loss_type="curl", p_pred=False,
                     H=H, W=W, dtype=dtype)
    model = build_model(mc, device=device)
    grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2))
    params = SimParams(3.0, 1e8, 10.0)
    fast = (not args.raw_module and args.network == "newfluidnet"
            and dtype == torch.float32 and unsupported_reason(model) is None)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")

    if args.what == "inference":
        x = inference_input(args.network, H, W, mc.channels[0], dtype,
                            device)
        fwd = FastNewFluidNet(model, H, W) if fast else model
        with torch.no_grad():
            fwd(x)
            sync(device)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                fwd(x)
            sync(device)
        ms = (time.perf_counter() - t0) / args.iters * 1e3
        print(json.dumps({
            "metric": f"inference_latency_{args.network}_{H}x{W}",
            "value": round(ms, 4), "unit": "ms", "iters": args.iters,
            "device": name, **flags}))
        return ms

    # rollout: the coupled ML_STOKES engine, B simulations
    apply_fn = FastNewFluidNet(model, H, W) if (
        dtype == torch.float32 and unsupported_reason(model) is None) \
        else model
    engine = SimEngine(TimeStepper(grid, params, apply_fn, cn_max=0.99,
                                   dtype=dtype, device=device))
    state = engine.init_state(initial_temperature(grid, args.batch))
    state, _ = engine.multi_step(state, min(args.steps, 20))   # warm-up
    sync(device)
    t0 = time.perf_counter()
    state, _ = engine.multi_step(state, args.steps)
    sync(device)
    sps = args.steps / (time.perf_counter() - t0)
    if not bool(torch.isfinite(state.T).all()):
        raise RuntimeError("rollout: T is not finite")
    B = args.batch
    out = {"metric": f"rollout_steps_per_s_{H}x{W}"
                     + (f"_B{B}" if B > 1 else ""),
           "value": round(sps, 2), "unit": "steps/s"}
    if B > 1:
        out["sim_steps_per_s"] = round(sps * B, 2)
    print(json.dumps({**out, "device": name, **flags}))
    return sps


if __name__ == "__main__":
    main()
