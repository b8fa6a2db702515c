#!/usr/bin/env python3
"""Readings that a cell's check limits are set from, on the card.

    python benchmarks/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--seconds 3] [--fault NAME]

For each seed: the cell's set-up, a window of ``--seconds`` of its traffic
(the timed path at the cell's own size), then the check's readings of
what the program produced against the reference (the lower readings).
For each control seed also the readings of the control: the reference
in the nearest precision below the configuration's (float32 with TF32
on), put in the program's place (the upper readings). One JSON line per
seed. It reads the staged cells (``benchmarks/staged/``) too. With
``--fault`` the program runs with that fault of
``benchmarks/tests/test_bench_faults.py`` planted under the timed path
(the readings a training cell's upper limits may come from). The
benchmark's own runs do not run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks.run import cell_of, load_manifest  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default="")
    args = ap.parse_args(argv)
    import importlib

    import torch
    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    w, cfg, traffic, _ = cell_of(load_manifest(staged=True), args.workload)
    mod = importlib.import_module(f"benchmarks.drivers.{traffic['driver']}")
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    if args.fault:
        from _pytest.monkeypatch import MonkeyPatch

        from benchmarks.tests.test_bench_faults import FAULTS
        plant = {f.__name__: f for f in FAULTS[args.workload]}[args.fault]
        plant(MonkeyPatch())
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        drv = mod.Driver(cfg, traffic, seed, torch.device("cuda", 0))
        drv.setup()
        win = drv.window(args.seconds)
        drv.release()
        t1 = time.perf_counter()
        rec = {"seed": seed, "fault": args.fault or None,
               "units": win.units, "failed": win.failed,
               "program": drv.check()}
        t2 = time.perf_counter()
        if hasattr(drv, "look"):
            rec["look"] = drv.look
        if seed in controls:
            rec["control"] = drv.check(control=True)
            if hasattr(drv, "look"):
                rec["control_look"] = drv.look
        rec["seconds"] = {"setup_window": t1 - t0, "check": t2 - t1,
                          "control": time.perf_counter() - t2}
        print(json.dumps(rec), flush=True)
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
