#!/usr/bin/env python3
"""Alternating runs of two trees of the port on the card, for the two
end-to-end metrics.

Each run is one process, started in the root of a tree (a repository
root with ``chip_smoke.py`` and the port's package, e.g. a parent commit
unpacked by ``git archive`` into a git-ignored directory), that imports
that tree's code and measures

* coupled ML_STOKES steps/s of the flagship at 128×506 and 256×256
  (``chip_smoke.py::run_main_path``: best of 3 × 200 steps after 20
  warm-up steps);
* ms per ``transolver_structured`` forward at 128×506 through the CLI
  (``cli/benchmark.py --what inference``, 50 forwards, TF32 off);
* the device-only ms of the flagship's 4 ``layer_stack`` calls of a step
  (summed) and of its ``trunk`` call at 128×506, learned padding, each
  call queued 200 times behind a spin (``chip_smoke.py::queued_ms``).

The two trees run in the order a, b, b, a, a, b, ... (``--pairs`` pairs);
one JSON line per run, then each tree's runs and medians. Needs the card.

Usage (from the repository root, on the machine with the card)::

    python3 tools/torch_port_pairs.py --roots build/parent . --pairs 5
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys


def layer_kernel_ms(H=128, W=506) -> tuple[float, float]:
    """Device-only ms of the flagship's 4 ``layer_stack`` calls of one
    step (summed) and of its ``trunk`` call at H × W, on the main path's
    inputs, with the tree's own code."""
    from chip_smoke import flagship, queued_ms
    from pbml_mantle_convection_tpu_torch.ops.branch_kernel import (
        layer_stack, layer_stacks)
    from pbml_mantle_convection_tpu_torch.ops.merge_kernel import trunk
    from pbml_mantle_convection_tpu_torch.sim.stepper import viscosity
    _, fast, engine, T0 = flagship(H, W, "cuda")
    eng = engine(fast)
    st, T = eng.stepper, eng.init_state(T0).T
    x = st.executor_input(T, viscosity(T, st.static, st.params))
    n_pyr = len(fast.branches) - 1
    b, pyr = layer_stack(x, fast.stem, pyramid=n_pyr)
    xs = [b, *pyr]
    outs = layer_stacks(xs, fast.branches)
    y1 = trunk(outs[0], outs[1:], x, fast.trunk)
    y2, _ = layer_stack(y1, fast.merge2)
    calls = (lambda: layer_stack(x, fast.stem, pyramid=n_pyr),
             lambda: layer_stacks(xs, fast.branches),
             lambda: layer_stack(y1, fast.merge2),
             lambda: layer_stack(y2, fast.merge3))
    return (sum(queued_ms(c) for c in calls),
            queued_ms(lambda: trunk(outs[0], outs[1:], x, fast.trunk)))


def measure() -> dict:
    """The metrics of the tree in the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    from chip_smoke import run_main_path
    from pbml_mantle_convection_tpu_torch.cli.benchmark import (
        main as benchmark)
    from pbml_mantle_convection_tpu_torch.ops.advect_kernel import (
        advect_diffuse_step_fused)
    from pbml_mantle_convection_tpu_torch.ops.branch_kernel import layer_stack
    from pbml_mantle_convection_tpu_torch.ops.epilogue_kernel import (
        curl_advect_epilogue)
    from pbml_mantle_convection_tpu_torch.ops.merge_kernel import trunk
    if not torch.cuda.is_available():
        raise SystemExit("torch_port_pairs: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = {"layer_stack": layer_stack, "trunk": trunk,
                "curl_advect_epilogue": curl_advect_epilogue,
                "advect_diffuse_step_fused": advect_diffuse_step_fused}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run_main_path(counters)
        ms = benchmark(["--what", "inference", "-net",
                        "transolver_structured", "--iters", "50", "--H",
                        "128", "--W", "506", "--device", "cuda"])
    steps = dict(re.findall(r"main path (\d+x\d+): ([\d.]+) steps/s",
                            out.getvalue()))
    stack_ms, trunk_ms = layer_kernel_ms()
    return {"steps_per_s_128x506": float(steps["128x506"]),
            "steps_per_s_256x256": float(steps["256x256"]),
            "transolver_forward_ms": ms,
            "layer_stack_device_ms_128x506": stack_ms,
            "trunk_device_ms_128x506": trunk_ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs=2, metavar=("A", "B"),
                    help="the two trees' roots")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--measure", action="store_true",
                    help="measure the tree in the working directory")
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure()))
        return 0
    script = os.path.abspath(__file__)
    runs = {root: [] for root in args.roots}
    order = []
    for p in range(args.pairs):
        order += list(args.roots if p % 2 == 0 else reversed(args.roots))
    for root in order:
        res = subprocess.run([sys.executable, script, "--measure"],
                             cwd=root, capture_output=True, text=True)
        if res.returncode:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        runs[root].append(rec)
        print(json.dumps({"root": root, **rec}), flush=True)
    for root, recs in runs.items():
        summary = {k: {"runs": [r[k] for r in recs],
                       "median": statistics.median(r[k] for r in recs)}
                   for k in recs[0]}
        print(json.dumps({"root": root, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
