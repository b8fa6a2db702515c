#!/usr/bin/env python3
"""Where a step of the PyTorch port's flagship rollout spends its time.

Runs the coupled ML_STOKES rollout of the flagship NewFluidNet (levels=5,
c_h=16, repeats=6, k=5, learned padding, curl head; seeded random weights;
built by ``chip_smoke.py::flagship``) through the fused executor on one
NVIDIA GPU — or, with ``--mode``, one of the other engine modes of
``chip_smoke.py::mode_engines`` (GAIA, GAIA-skip3, ML_PRE, or ML_STOKES
with core cooling, Di=0.5 and decay) — and prints:

* wall time per step with a synchronise at the end of the run, and the
  host's time to enqueue one step (median over 2-step runs that start on
  an idle device, short enough that the launch queue never fills);
* from ``torch.profiler`` over a short steady window: device kernel time
  per step, grouped by kernel name and again by (kernel, launch grid) —
  which separates the pyramid levels — and the device's idle share
  (1 − summed kernel time / wall time; one stream, so kernels do not
  overlap).

Usage (from the repository root, on the machine with the card)::

    python3 tools/torch_port_profile.py [--H 128] [--W 506] [--steps 50]
        [--mode GAIA] [--trace-dir build/profiles]

The Chrome trace goes to
``<trace-dir>/torch_port_profile_<mode>_<H>x<W>.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--H", type=int, default=128)
    ap.add_argument("--W", type=int, default=506)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--mode", default="ML_STOKES",
                    help="ML_STOKES (the fused flagship) or a name of "
                         "chip_smoke.py::mode_engines")
    ap.add_argument("--trace-dir", default=str(ROOT / "build" / "profiles"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_port_profile: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import flagship, mode_engines

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    H, W, n = args.H, args.W, args.steps
    if args.mode == "ML_STOKES":
        _, fast, engine, T0 = flagship(H, W, "cuda")  # chip_smoke.py's model
        eng = engine(fast)
    else:
        T0, modes = mode_engines(H, W)
        eng = modes[args.mode][0]
    warm = 20 if args.mode == "ML_STOKES" else 1
    state, _ = eng.multi_step(eng.init_state(T0), warm)   # builds, warms
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    state, _ = eng.multi_step(state, n)
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t0
    host = []
    for _ in range(10 if args.mode == "ML_STOKES" else 2):
        t0 = time.perf_counter()
        state, _ = eng.multi_step(state, 2)
        host.append((time.perf_counter() - t0) / 2)
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        state, _ = eng.multi_step(state, n)
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t1
    out = Path(args.trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    trace_path = out / f"torch_port_profile_{args.mode}_{H}x{W}.json"
    prof.export_chrome_trace(str(trace_path))

    by_kernel = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] += e.device_time_total / 1e3     # µs → ms
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    result = {
        "card": card, "mode": args.mode, "grid": [H, W], "steps": n,
        "wall_ms_per_step": t_wall / n * 1e3,
        "host_enqueue_ms_per_step": float(np.median(host)) * 1e3,
        "profiled_wall_ms_per_step": t_prof / n * 1e3,
        "device_kernel_ms_per_step": busy / n,
        "device_idle_share": 1.0 - busy / (t_prof * 1e3),
        "kernels_ms_per_step": {k: v / n for k, v in top[:15]},
    }
    for k, v in top[:15]:
        print(f"{v / n:9.4f} ms/step  {k[:100]}")
    by_grid = defaultdict(lambda: [0, 0.0])
    for e in json.loads(trace_path.read_text())["traceEvents"]:
        if e.get("cat") == "kernel":
            name = e["name"].replace("(anonymous namespace)::", "")
            key = (name.split("(")[0][-48:],
                   tuple(e["args"].get("grid", ())))
            by_grid[key][0] += 1
            by_grid[key][1] += e["dur"]
    for (name, grid_dims), (count, us) in sorted(
            by_grid.items(), key=lambda kv: -kv[1][1])[:20]:
        print(f"{us / n / 1e3:9.4f} ms/step {us / count:8.2f} us/launch "
              f"{count // n:3d}/step grid={grid_dims} {name}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
