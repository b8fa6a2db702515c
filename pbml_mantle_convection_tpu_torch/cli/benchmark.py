"""Benchmark CLI: surrogate inference latency and coupled rollout throughput.

Counterpart of the JAX package's ``cli/benchmark.py``, with its arguments
and its metric names; prints one JSON line. ``--what inference`` times
``--iters`` forward passes at batch 1 after one warm-up pass (the
reference's timing loop, load_fluidnet.ipynb cell 7): NewFluidNet through
the fused executor with learned or zero padding (``-pad``; ``--raw-module``:
the module), every other network of the registry through its forward.
``--what rollout`` times ``--steps`` coupled ML_STOKES steps of a
NewFluidNet after a short warm-up, ``--batch`` simulations per step (the
fused executor runs them one after another, the energy step runs once for
the batch), of a FluidNet, a multi-scale ensemble or a ViT (the module,
then the energy step), or of the U-Net (``-net unet|iunet``: the network
advances T itself); a network other than NewFluidNet under its own metric
name (``rollout_steps_per_s_{net}_{H}x{W}``). The networks with no
coupled rollout (``sim/stepper.py::NO_ROLLOUT``: a HalfNewFluidNet, the
Transolvers, the ConvAE) raise with the reason, which JAX's CLI shares.
``--what train`` times ``--iters`` train
steps (train/train_step.py: curl loss with loss scaling and the
derivative term, Adam 1e-3) at ``--batch`` (default 8) after one warm-up
step, and prints the peak device memory beside them; ``--profile`` adds
where a step's time goes (:func:`train_profile`). The inputs are the
JAX CLI's: zeros for inference, the field of ``bench.py`` for the
rollout, phase-shifted per simulation when B > 1, seeded normal x and y
for training (the U-Net's y with T, and its parameters and depth for
the roll-forward); the weights come from seed 0::

    python -m pbml_mantle_convection_tpu_torch.cli.benchmark \\
        --what inference -net transolver_structured

``--sharded`` times the per-simulation sharded rollout
(``parallel/rollout.py``): B simulations (``--batch`` if above 1, else the
world size), B / world per rank, each at B = 1 through the fused
executor with its own dt; one warm-up call from initial fields of another
phase (0.11), then the timed call; the metric is
``sharded_rollout_{H}x{W}`` in simulation-steps/s. The world is
torchrun's (``parallel/mesh.py::maybe_initialize_distributed``: NCCL on
the card, gloo with ``--device cpu``), or one process. Under torchrun
``--what train`` splits its batch over the ranks, whose gradients are
all-reduced (``make_train_step(..., process_group=...)``). Rank 0 prints.

``--dtype`` is float32 (default), float64 or bfloat16. In bfloat16 the
port runs where the JAX CLI runs and refuses, with JAX's reason and
before any work, where it fails: the NewFluidNet fused executor with
learned padding (``--what inference`` without ``--raw-module``, and
``--what rollout``) and the zero-padded rollout
(``models/fast_path.py::BF16_LEARNED``, ``BF16_ZERO_ROLLOUT``). The
zero-padded bfloat16 inference runs the fused executor, as JAX's does,
and returns float32 as JAX's does (``FastNewFluidNet.float32_of``: the
kernels over float32 copies of the bfloat16 weights); a bfloat16
rollout's energy step runs in float32 (``sim/engine.py``); the bfloat16
Transolvers run the bfloat16 slice kernels.

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
import torch.distributed as dist

from ..constants import SimParams
from ..models.fast_path import (BF16_LEARNED, BF16_ZERO_ROLLOUT,
                                FastNewFluidNet, executor_or_module,
                                unsupported_reason)
from ..models.registry import ModelConfig, build_model
from ..sim.engine import SimEngine
from ..sim.grid import Grid
from ..sim.stepper import NO_ROLLOUT, TimeStepper
from ..models.layers import float32_convs
from ..parallel.mesh import (local_device, make_mesh, mesh_rank, mesh_size,
                             maybe_initialize_distributed, shard_batch)
from ..parallel.rollout import make_batch_sharded
from ..train.train_step import (TrainStepConfig, make_loss_fn,
                                make_train_step)
from ..train.trainer import adam_l2
from ..utils.card import card_info

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


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
    p.add_argument("--batch", type=int, default=None,
                   help="simultaneous simulations per rollout step "
                        "(default 1); for --what train, the train-step "
                        "batch size (default 8, the production size)")
    p.add_argument("--roll_forward", type=int, default=1,
                   help="--what train, unet: autoregressive unroll "
                        "depth (multigpu.py:207-251)")
    p.add_argument("--raw-module", action="store_true",
                   help="time the plain module instead of the fused "
                        "executor")
    p.add_argument("--donate", action="store_true",
                   help="--what train: accepted for the JAX CLI's flag "
                        "and ignored (the optimizer updates in place); "
                        "the metric is the one without it")
    p.add_argument("--profile", action="store_true",
                   help="--what train: add where a step's time goes "
                        "(forward, backward, Adam; device kernels, idle "
                        "share, launches, top kernels)")
    p.add_argument("--remat", action="store_true",
                   help="--what train: recompute the forward in the "
                        "backward (torch.utils.checkpoint)")
    p.add_argument("--sharded", action="store_true",
                   help="per-simulation sharded rollout over the world's "
                        "ranks (torchrun; one process alone: one card), "
                        "each simulation at B = 1 on the fused executor")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p


# networks with a coupled rollout: the FluidNet family (NewFluidNet through
# the fused executor), the multi-scale ensemble, the ViT, and the U-Net,
# which advances T itself
ROLLOUT_NETS = ("newfluidnet", "fluidnet", "multiscalenewfluidnet", "vit",
                "unet", "iunet")


def initial_temperature(grid: Grid, batch: int = 1,
                        phase: float = 0.0) -> np.ndarray:
    """(B, H, W) initial fields of the rollout as the JAX CLI builds them
    (JAX ``cli/benchmark.py:199-206, 225-228``): simulation b's phase
    shifted by 0.37·b + ``phase``, so simulation 0's is ``bench.py``'s at
    phase 0."""
    return np.stack([np.clip(1.0 - grid.yc
                             + 0.05 * np.sin(6.28 * grid.xc + 0.37 * b
                                             + phase),
                             0.0, 1.0) for b in range(batch)])


def bf16_refusal(args) -> str | None:
    """JAX's reason where its CLI fails in bfloat16 on its fused executor
    (a NewFluidNet with learned or zero padding and k = 5), else None."""
    if (args.dtype != "bfloat16" or args.network != "newfluidnet"
            or args.r_p not in ("learned", "zeros") or args.kernel != 5):
        return None
    if args.what == "rollout":
        return BF16_LEARNED if args.r_p == "learned" else BF16_ZERO_ROLLOUT
    if args.what == "inference" and not args.raw_module \
            and args.r_p == "learned":
        return BF16_LEARNED
    return None


def inference_input(network: str, H: int, W: int, c_i: int, dtype,
                    device) -> torch.Tensor:
    """The JAX CLI's inference input (JAX ``cli/benchmark.py:79-82``):
    zeros of (1, H·W, c_i) for the Transolvers, (1, H, W, c_i) else."""
    shape = (1, H * W, c_i) if "transolver" in network else (1, H, W, c_i)
    return torch.zeros(shape, dtype=dtype, device=device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_batch(network: str, B: int, H: int, W: int, c_i: int, dtype,
                device) -> dict:
    """The JAX CLI's train batch (JAX ``cli/benchmark.py:137-150``): x
    then y drawn from ``np.random.default_rng(0)``, normal, (B, H, W, c_i)
    and (B, 2, H, W); the U-Net's y is (B, 3, H, W) (u, v, T), and its
    batch also holds the roll-forward's parameters (3.0, 1e8, 10.0) per
    sample and the grid's yc. The Transolvers read points, so their x is
    the same draws as (B, H·W, c_i) (the JAX CLI passes the grid shape
    there, which its Transolver rejects)."""
    rs = np.random.default_rng(0)
    unet = network in ("unet", "iunet")
    x = rs.normal(size=(B, H, W, c_i))
    y = rs.normal(size=(B, 3 if unet else 2, H, W))
    if "transolver" in network:
        x = x.reshape(B, H * W, c_i)
    batch = {"x": torch.as_tensor(x, dtype=dtype, device=device),
             "y": torch.as_tensor(y, dtype=dtype, device=device)}
    if unet:
        grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2))
        batch["paras"] = torch.tensor([[3.0, 1e8, 10.0]] * B, dtype=dtype,
                                      device=device)
        batch["yc"] = torch.as_tensor(grid.yc, dtype=dtype,
                                      device=device).expand(B, H, W)
    return batch


def train_profile(model, opt, cfg, step, batch, wall_ms, steps,
                  device) -> dict:
    """Where a train step's time goes: forward + loss, backward and the
    Adam update by CUDA events over ``steps`` steps (the step's calls in
    its order); from ``torch.profiler`` over 3 steps the device kernel ms
    per step, the launches per step and the top kernels by time. The
    idle share is 1 − kernel ms / ``wall_ms``, the unprofiled host time
    per step (the profiler's own host work would inflate a profiled
    one). Device numbers read "not measured" on the CPU."""
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    loss_fn = make_loss_fn(model, cfg)
    phases = {"forward_loss": 0.0, "backward": 0.0, "adam": 0.0}
    for _ in range(steps if cuda else 0):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        with float32_convs(batch["x"]):
            opt.zero_grad(set_to_none=False)
            ev[0].record()
            loss = loss_fn(batch).total
            ev[1].record()
            loss.backward()
            ev[2].record()
            opt.step()
            ev[3].record()
        torch.cuda.synchronize(device)
        for i, k in enumerate(phases):
            phases[k] += ev[i].elapsed_time(ev[i + 1]) / steps
    n_prof = 3
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        for _ in range(n_prof):
            step(batch)
        sync(device)
    by_kernel, launches = {}, 0
    for e in prof.events():
        # device kernels and copies; not the ranges that annotate them
        # (Optimizer.step#..., which would count their kernels twice)
        if e.device_type == torch.autograd.DeviceType.CUDA and not (
                getattr(e, "is_user_annotation", False)
                or "#" in e.name or e.name.startswith("ProfilerStep")):
            by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                                 + e.device_time_total / 1e3 / n_prof)
            launches += 1
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    na = "not measured"
    return {
        "phase_ms": ({k: round(v, 3) for k, v in phases.items()}
                     if cuda else na),
        "device_kernel_ms_per_step": round(busy, 3) if cuda else na,
        "device_idle_share": round(1.0 - busy / wall_ms, 4) if cuda else na,
        "device_launches_per_step": launches / n_prof if cuda else na,
        "top_kernels_ms_per_step": {k[:90]: round(v, 3) for k, v in top}}


def train_benchmark(args, model, c_i, dtype, device,
                    mesh=None) -> tuple[float, dict]:
    """``--what train``: one warm-up step, then ``--iters`` steps ending
    in a synchronize; with ``--profile``, then :func:`train_profile`.
    Over a ``mesh`` each rank steps on its rows of the batch and the
    gradients are all-reduced (JAX: the step over its device mesh).
    Returns (ms per step, the JSON record)."""
    B, H, W = args.batch, args.H, args.W
    if B % mesh_size(mesh):
        raise SystemExit(f"--batch {B} not divisible by "
                         f"{mesh_size(mesh)} devices")
    cfg = TrainStepConfig(net=args.network, p_pred=False, loss_scale=True,
                          loss_derivative=True, loss_type="curl",
                          remat=args.remat, roll_forward=args.roll_forward)
    opt = adam_l2(model.parameters(), 1e-3)
    step = make_train_step(model, opt, cfg, process_group=mesh)
    batch = shard_batch(mesh, train_batch(args.network, B, H, W, c_i, dtype,
                                          device))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    br = step(batch)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        br = step(batch)
    sync(device)
    dt = (time.perf_counter() - t0) / args.iters
    rf = f"_rf{args.roll_forward}" if args.roll_forward > 1 else ""
    rf += "_remat" if args.remat else ""
    rec = {
        "metric": f"train_step_{args.network}_{H}x{W}_B{B}{rf}",
        "value": round(dt * 1e3, 3), "unit": "ms",
        "samples_per_s": round(B / dt, 2), "n_devices": mesh_size(mesh),
        "loss": float(br.total),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None)}
    if args.profile:
        rec["profile"] = train_profile(model, opt, cfg, step, batch,
                                       dt * 1e3, args.iters, device)
    return dt * 1e3, rec


def sharded_benchmark(args, engine, grid, mesh, name, flags) -> float:
    """``--sharded``: B simulations over the mesh's ranks, each at B = 1
    with its own dt (``parallel/rollout.py``); one warm-up call from
    initial fields of phase 0.11, then the timed one. Returns
    simulation-steps/s."""
    n_dev = mesh_size(mesh)
    B = args.batch if args.batch > 1 else n_dev
    if B % n_dev:
        raise SystemExit(f"--batch {B} not divisible by {n_dev} devices")
    f = make_batch_sharded(engine, args.steps, mesh)
    f(initial_temperature(grid, B, 0.11))
    sync(engine.device)
    T0 = initial_temperature(grid, B)
    t0 = time.perf_counter()
    out = f(T0)
    sync(engine.device)
    sps = args.steps / (time.perf_counter() - t0)
    if not bool(torch.isfinite(out[0]).all()):
        raise RuntimeError("sharded rollout: T is not finite")
    if mesh_rank(mesh) == 0:
        print(json.dumps({
            "metric": f"sharded_rollout_{args.H}x{args.W}",
            "value": round(sps * B, 2), "unit": "sim_steps/s",
            "n_devices": n_dev, "batch": B,
            "rollout_steps_per_s": round(sps, 2), "device": name,
            **flags}))
    return sps * B


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.batch is None:
        args.batch = 8 if args.what == "train" else 1
    if args.what == "rollout" and args.network in NO_ROLLOUT:
        raise ValueError(NO_ROLLOUT[args.network])
    reason = bf16_refusal(args)
    if reason is not None:
        raise TypeError(reason)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("benchmark: no CUDA device (pass --device cpu to "
                         "run on the CPU)")
    # torchrun's world, or one process
    owns_world = maybe_initialize_distributed(args.device)
    try:
        return _benchmark(args, local_device(args.device))
    finally:
        if owns_world:
            dist.destroy_process_group()


def _benchmark(args, device):
    dtype = _DTYPES[args.dtype]
    mesh = make_mesh()
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
    # the executor where JAX's CLI builds its own (newfluidnet, learned
    # or zero padding; executor_or_module runs the module where the
    # executor does not take the configuration), in float32, and in
    # bfloat16 where JAX's runs (bf16_refusal leaves it the zero-padded
    # inference)
    jax_fast = (args.network == "newfluidnet"
                and args.r_p in ("learned", "zeros"))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")

    if args.what == "train":
        ms, rec = train_benchmark(args, model, mc.channels[0], dtype, device,
                                  mesh)
        if mesh_rank(mesh) == 0:
            print(json.dumps({**rec, **card_info(device), **flags}))
        return ms

    if args.what == "inference":
        x = inference_input(args.network, H, W, mc.channels[0], dtype,
                            device)
        fwd = model
        if jax_fast and not args.raw_module:
            if dtype == torch.bfloat16 and unsupported_reason(model) is None:
                fwd, x = FastNewFluidNet.float32_of(model, H, W), x.float()
            elif dtype == torch.float32:
                fwd, _ = executor_or_module(model, H, W)
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

    # rollout: the coupled engine, B simulations
    apply_fn = model
    if jax_fast and dtype == torch.float32:
        apply_fn, _ = executor_or_module(model, H, W)
    engine = SimEngine(TimeStepper(grid, params, apply_fn, cn_max=0.99,
                                   dtype=dtype, device=device,
                                   net=args.network))
    if args.sharded:
        return sharded_benchmark(args, engine, grid, mesh, name, flags)
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
    # networks other than the flagship's under their own name (JAX
    # cli/benchmark.py:257-263)
    tag = "" if args.network == "newfluidnet" else f"_{args.network}"
    out = {"metric": f"rollout_steps_per_s{tag}_{H}x{W}"
                     + (f"_B{B}" if B > 1 else ""),
           "value": round(sps, 2), "unit": "steps/s"}
    if B > 1:
        out["sim_steps_per_s"] = round(sps * B, 2)
    print(json.dumps({**out, "device": name, **flags}))
    return sps


if __name__ == "__main__":
    main()
