#!/usr/bin/env python3
"""Build and time variants of the layer kernel (``csrc/blc_layer.cuh``).

A variant is the checked-in source with a few textual edits (``VARIANTS``
below). For each variant named on the command line, in that order (name
one twice to see the spread between two runs of the same code), this
prints the ptxas registers and spills of ``blc_fused_kernel``, and for
the main path's layer calls on the flagship's stage inputs (stem with its
pyramid, the grouped branch stacks, trunk, merges 2 and 3): the largest
max |kernel − plain| / max |plain| and each call's device time
(``chip_smoke.py::queued_ms``); then the coupled ML_STOKES steps/s (best
of 2 × 200 steps); with ``--t-rmse``, also the fused path's 500-step
T_rmse and trace_mae against the float64 module path
(``tools/torch_port_accuracy.py``) for the flagship ML_STOKES rollout and
the core-cooling Di=0.5 mode (``--modes``), with the weights of each of
``--seeds``. Needs the card and nvcc; each variant builds into the
git-ignored ``build/``.

Usage (from the repository root, on the machine with the card)::

    python3 tools/layer_kernel_variants.py [--H 128] [--W 506] \\
        current lb2 t16 lolo [--t-rmse [--seeds 0 1] [--modes ML_STOKES]]
"""

from __future__ import annotations

import argparse
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# name → [(text in blc_layer.cuh, replacement), ...]
VARIANTS = {
    "current": [],
    # 2 blocks per SM for the stack instances too (≤ 128 registers)
    "lb2": [("__launch_bounds__(kThreads, TRUNK ? 2 : 3)",
             "__launch_bounds__(kThreads, 2)")],
    # 8×16 interior tiles, one M fragment per warp: every item 128 pixels
    "t16": [("kFragsPerWarp = 2;", "kFragsPerWarp = 1;"),
            ("IT_H = 8, IT_W = 32,", "IT_H = 8, IT_W = 16,")],
    # a fourth product, a_lo * w_lo (pass -1), before the other three
    "lolo": [("for (int pass = 0; pass < 3; ++pass)",
              "for (int pass = -1; pass < 3; ++pass)"),
             ("(pass ? ", "(pass > 0 ? "),
             ("if (pass == 1)", "if (pass == 1 || pass < 0)")],
}


def use_variant(name: str) -> str:
    """Point the kernel build at a copy of csrc with the variant's edits;
    returns the ptxas lines of blc_fused_kernel."""
    from pbml_mantle_convection_tpu_torch.ops import _cuda
    src = ROOT / "pbml_mantle_convection_tpu_torch" / "csrc"
    d = _cuda.BUILD_DIR.parent / "variants" / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, d)
    f = d / "blc_layer.cuh"
    text = f.read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} not in blc_layer.cuh")
        text = text.replace(old, new)
    f.write_text(text)
    _cuda.CSRC = d
    _cuda.library.cache_clear()
    _cuda.work_items.cache_clear()
    _, _, report = _cuda.build()
    _cuda.library()
    lines, cur = [], False
    for line in report.splitlines():
        if "Function properties" in line:
            cur = "blc_fused_kernel" in line
        elif cur and ("Used" in line or "spill" in line):
            lines.append(line.strip().replace("ptxas info    : ", ""))
    return "; ".join(lines)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--H", type=int, default=128)
    ap.add_argument("--W", type=int, default=506)
    ap.add_argument("--t-rmse", action="store_true",
                    help="also each variant's 500-step T_rmse")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0],
                    help="weight seeds of the --t-rmse rollouts")
    ap.add_argument("--modes", nargs="+", default=None,
                    help="modes of the --t-rmse rollouts (default: all of "
                         "tools/torch_port_accuracy.py's)")
    ap.add_argument("variants", nargs="*", default=["current"],
                    choices=sorted(VARIANTS))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("layer_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import (accuracy_tool, card_line, flagship, queued_ms,
                            rel_err)
    from pbml_mantle_convection_tpu_torch.ops.branch_kernel import (
        layer_stack, layer_stack_plain, layer_stacks, layer_stacks_plain)
    from pbml_mantle_convection_tpu_torch.ops.merge_kernel import (
        trunk, trunk_plain)
    from pbml_mantle_convection_tpu_torch.sim.stepper import viscosity

    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_line()}")
    H, W = args.H, args.W
    _, fast, engine, T0 = flagship(H, W, "cuda")
    eng = engine(fast)
    T = eng.init_state(T0).T
    st = eng.stepper
    x = st.executor_input(T, viscosity(T, st.static, st.params))
    n_pyr = len(fast.branches) - 1
    b, pyr = layer_stack_plain(x, fast.stem, pyramid=n_pyr)
    xs = [b, *pyr]
    outs = layer_stacks_plain(xs, fast.branches)
    y1 = trunk_plain(outs[0], outs[1:], x, fast.trunk)
    y2, _ = layer_stack_plain(y1, fast.merge2)
    psi, _ = layer_stack_plain(y2, fast.merge3)

    def stem():
        y, pools = layer_stack(x, fast.stem, pyramid=n_pyr)
        return [y, *pools]

    calls = {   # name → (kernel call → list of fields, plain fields)
        "stem": (stem, xs),
        "branches": (lambda: layer_stacks(xs, fast.branches), outs),
        "trunk": (lambda: [trunk(outs[0], outs[1:], x, fast.trunk)], [y1]),
        "merge2": (lambda: [layer_stack(y1, fast.merge2)[0]], [y2]),
        "merge3": (lambda: [layer_stack(y2, fast.merge3)[0]], [psi]),
    }
    if args.t_rmse:
        # the float64 legs, once: the module path and the energy step's
        # plain version, which no variant edits
        acc = accuracy_tool()
        weights = {s: acc.flagship_weights(s) for s in args.seeds}
        refs = {(mode, s): acc.reference(weights[s], H, W, 500, mode=mode)
                for mode in args.modes or acc.MODE_VARIANTS
                for s in args.seeds}
    for name in args.variants:
        print(f"{name}: {use_variant(name)}")
        err, times = 0.0, []
        for call, (fn, ref) in calls.items():
            err = max([err] + [rel_err(a, r)[1] for a, r in zip(fn(), ref)])
            times.append(f"{call} {queued_ms(fn):.4f}")
        st, _ = eng.multi_step(eng.init_state(T0), 20)
        torch.cuda.synchronize()
        best = 0.0
        for _ in range(2):
            t0 = time.perf_counter()
            st, _ = eng.multi_step(st, 200)
            torch.cuda.synchronize()
            best = max(best, 200 / (time.perf_counter() - t0))
        ok = bool(torch.isfinite(st.T).all())
        print(f"{name} {H}x{W}: max rel err {err:.2e}; device ms "
              f"{', '.join(times)}; {best:.1f} steps/s, T finite {ok}",
              flush=True)
        for (mode, s), ref in (refs.items() if args.t_rmse else ()):
            got = acc.rollout(weights[s], H, W, 500, mode=mode, path="fused",
                              dtype=torch.float32)
            e = acc.errors(got["T"], got["mean_T"], ref["T"], ref["mean_T"])
            print(f"{name} {H}x{W} {mode} seed {s}: fused 500-step T_rmse "
                  f"{e['T_rmse']:.3e}, trace_mae {e['trace_mae']:.3e}",
                  flush=True)
        if not (err <= 1e-4 and ok):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
