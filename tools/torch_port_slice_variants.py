#!/usr/bin/env python3
"""Times textual variants of the ``slice_pool`` kernel on the card.

A variant is the checked-in ``csrc/slice_attention.cu`` with a few textual
edits (``VARIANTS`` below). For each variant named on the command line, in
that order (name one twice to see the spread between two runs of the same
code), this prints the ptxas registers of the float32 ``slice_pool_kernel``
instances, the opcode histogram of the SASS of ``slice_pool_kernel<float,
32>`` (``--sass``), and for BH=8, N=64,768 at each (D, G) of ``--shapes``:
max |kernel − plain float64| / max |plain| of num and den and the
device-only ms per call (``chip_smoke.py::queued_ms``). Needs the card and
nvcc; each variant builds into the git-ignored ``build/``.

Usage (from the repository root, on the machine with the card)::

    python3 tools/torch_port_slice_variants.py --sass current kw1
"""

from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

_INT_SPLIT = """  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));"""

_SUMS_LOOP = "for (int ks = kg; ks < nks; ks += L.kw) {"
_NO_SUMS = (_SUMS_LOOP, "for (int ks = kg; ks < 0; ks += L.kw) {")
_NO_LOGITS = ("for (int ks = 0; ks < L.Dk / 8; ++ks) {",
              "for (int ks = 0; ks < 0; ++ks) {")

# name → [(text in slice_attention.cu, replacement), ...]
VARIANTS = {
    "current": [],
    # hi and lo rounded by cvt.rna.tf32.f32
    "rna_split": [(_INT_SPLIT, """  hi = pmc::to_tf32(x);
  lo = pmc::to_tf32(x - __uint_as_float(hi));""")],
    # diagnostic, wrong results: one TF32 product instead of three
    "one_pass": [("""  mma_tf32(d, al[0], al[1], al[2], al[3], bh0, bh1);
  mma_tf32(d, ah[0], ah[1], ah[2], ah[3], bl0, bl1);
""", "")],
    # the largest tile that fits, even where it leaves one block per SM
    "p_max": [("if (!fit(G <= 64 ? kSmemTwoBlocks : kSmemMax)",
               "if (!fit(kSmemMax)")],
    # every warp over all of a tile's points (no warp groups)
    "kw1": [("  L.kw = 1;\n  while (", "  L.kw = 1;\n  while (false && ")],
    # three resident blocks per SM for G <= 32 (<= 85 registers)
    "lb3": [("__global__ void __launch_bounds__(kThreads)\nslice_pool_kernel(",
             "__global__ void __launch_bounds__(kThreads, GT == 32 ? 3 : 1)"
             "\nslice_pool_kernel(")],
    # the sums' k-step loop unrolled twice (next loads ahead of the MMAs)
    "unroll2": [(_SUMS_LOOP, "#pragma unroll 2\n    " + _SUMS_LOOP)],
    # diagnostics, wrong results: without the sums' products, without the
    # logits' products, without either (loads, softmax and barriers left);
    # without the exps; without any tile (launch, set-up, write-out and the
    # chunk-sum kernel)
    "no_sums": [_NO_SUMS],
    "no_logits": [_NO_LOGITS],
    "no_products": [_NO_SUMS, _NO_LOGITS],
    "no_exp": [("acc[j][h] = expf(acc[j][h] - mx0);",
                "acc[j][h] = acc[j][h] - mx0;"),
               ("acc[j][2 + h] = expf(acc[j][2 + h] - mx1);",
                "acc[j][2 + h] = acc[j][2 + h] - mx1;")],
    "no_tiles": [("const int count = min(", "const int count = 0 * min(")],
}


def use_variant(name: str):
    """Point the kernel build at a copy of csrc with the variant's edits;
    returns (library path, ptxas lines of the float32 pool kernels)."""
    from pbml_mantle_convection_tpu_torch.ops import _cuda, slice_attention
    src = ROOT / "pbml_mantle_convection_tpu_torch" / "csrc"
    d = _cuda.BUILD_DIR.parent / "variants" / f"slice_{name}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, d)
    f = d / "slice_attention.cu"
    text = f.read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} not in the source")
        text = text.replace(old, new)
    f.write_text(text)
    _cuda.CSRC = d
    _cuda.library.cache_clear()
    slice_attention._pool_plan.cache_clear()
    so, _, report = _cuda.build()
    _cuda.library()
    lines, cur = [], False
    for line in report.splitlines():
        if "Compiling entry" in line:
            cur = "slice_pool_kernelIf" in line
            if cur:
                lines.append(re.search(r"Li(\d+)E", line).group(1))
        elif cur and ("Used" in line or "spill" in line):
            lines.append(line.strip().replace("ptxas info    : ", ""))
    return so, " ".join(lines)


def sass_histogram(so, top: int = 24) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    ops, cur = collections.Counter(), False
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = "slice_pool_kernelIfLi32E" in m.group(1)
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if cur and m:
            ops[m.group(2)] += 1
    return ", ".join(f"{k} {v}" for k, v in ops.most_common(top))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="16x32,32x64",
                    help="comma-separated DxG (BH=8, N=64,768)")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("variants", nargs="*", default=["current"],
                    choices=sorted(VARIANTS))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_port_slice_variants: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import card_line, queued_ms, rel_err, slice_inputs
    from pbml_mantle_convection_tpu_torch.ops.slice_attention import (
        slice_pool, slice_pool_plain)
    print(f"card: {card_line()}")
    shapes = [tuple(map(int, s.split("x"))) for s in args.shapes.split(",")]
    inputs = {}
    for D, G in shapes:
        a = slice_inputs(8, 128 * 506, D, G, torch.float32, D)
        wide = slice_pool_plain(*(t.double() for t in a[:5]))
        inputs[D, G] = (a[:5], wide)
    for name in args.variants:
        so, regs = use_variant(name)
        print(f"{name}: registers {regs}")
        if args.sass:
            print(f"{name}: SASS of slice_pool_kernel<float, 32>: "
                  f"{sass_histogram(so)}")
        for (D, G), (a, ref) in inputs.items():
            num, den = slice_pool(*a)
            err = max(rel_err(num.double(), ref[0])[1],
                      rel_err(den.double(), ref[1])[1])
            ms = queued_ms(lambda: slice_pool(*a))
            print(f"{name} D={D} G={G}: rel err {err:.2e}, device ms "
                  f"{ms:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
