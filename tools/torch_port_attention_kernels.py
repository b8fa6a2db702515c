#!/usr/bin/env python3
"""The device kernels of one Physics-Attention forward, by name, in one or
more trees of the port.

For each tree root (a repository root with the port's package, e.g. a
parent commit unpacked by ``git archive`` into a git-ignored directory,
and ``.``), one process started in that root imports that tree's port,
builds the serving ``transolver_structured`` and the irregular
``transolver`` at 128×506 (seed-0 weights, float32, TF32 off) and records
one forward of block 0's Physics-Attention, after a warm-up forward, with
``torch.profiler``. One JSON line per tree and path: the device kernels by
name, the copy kernels among them (by name: ``copy``), and cuDNN's layout
transposes (``nchwToNhwc``, ``nhwcToNchw``), which a count of copies by
name does not see. Needs the card.

Usage (from the repository root, on the machine with the card)::

    python3 tools/torch_port_attention_kernels.py --roots build/parent .
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(H: int, W: int) -> list[dict]:
    """One record per path for the tree in the working directory."""
    # this tree's chip_smoke.device_kernels, whichever tree is measured
    spec = importlib.util.spec_from_file_location("smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, os.getcwd())
    import torch

    from pbml_mantle_convection_tpu_torch.models.registry import (
        ModelConfig, build_model)
    if not torch.cuda.is_available():
        raise SystemExit("torch_port_attention_kernels: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    recs = []
    for net in ("transolver_structured", "transolver"):
        attn = build_model(ModelConfig(network=net, H=H, W=W)).blocks_0.Attn
        h = torch.randn(1, H * W, attn.heads * attn.dim_head, device="cuda")
        with torch.no_grad():
            kernels = smoke.device_kernels(lambda: attn(h))
        if not kernels:
            raise SystemExit(f"{net}: the profiler saw no device kernels")

        def count(pattern):
            return sum(n for k, n in kernels.items()
                       if re.search(pattern, k, re.I))

        recs.append({"net": net, "device_kernels": sum(kernels.values()),
                     "copies": count(r"copy"),
                     "cudnn_transposes": count(r"nchwToNhwc|nhwcToNchw"),
                     "kernels": dict(sorted(kernels.items()))})
    return recs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=["."])
    ap.add_argument("--H", type=int, default=128)
    ap.add_argument("--W", type=int, default=506)
    ap.add_argument("--measure", action="store_true",
                    help="measure the tree in the working directory")
    args = ap.parse_args()
    if args.measure:
        for rec in measure(args.H, args.W):
            print(json.dumps(rec))
        return 0
    script = os.path.abspath(__file__)
    for root in args.roots:
        res = subprocess.run([sys.executable, script, "--measure", "--H",
                              str(args.H), "--W", str(args.W)],
                             cwd=root, capture_output=True, text=True)
        if res.returncode:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        for line in res.stdout.strip().splitlines():
            print(json.dumps({"root": root, **json.loads(line)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
