#!/usr/bin/env python3
"""Times textual variants of the two slice kernels on the card.

A variant is the checked-in ``csrc/slice_attention.cu`` with a few textual
edits (``VARIANTS`` below). For each variant named on the command line, in
that order (name one twice to see the spread between two runs of the same
code), this prints the ptxas registers of the float32 instances of the
kernels named by ``--kernels`` (``slice_pool_kernel``,
``slice_deslice_kernel``), the opcode histogram of the SASS of each
kernel's ``<float, 32>`` instance (``--sass``), and for BH=8, N=64,768 at
each (D, G) of ``--shapes``: max |kernel − plain float64| / max |plain|
(num and den for the pool; the largest over ``--seeds`` inputs) and the
device-only ms per call (``chip_smoke.py::queued_ms``). ``--layout heads`` gives the kernels
x_mid and fx as the (1, 8, N, D) views of (1, N, 8·D) rows that the
Transolver's projections give them (default: dense (8, N, D)). Needs the
card and nvcc; each variant builds into the git-ignored ``build/``.

Usage (from the repository root, on the machine with the card)::

    python3 tools/torch_port_slice_variants.py --kernels deslice \\
        --layout heads current stages2 current
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
# both kernels' logits (warp_logits)
_NO_LOGITS = ("for (int ks = 0; ks < Dk / 8; ++ks) {",
              "for (int ks = 0; ks < 0; ++ks) {")
_OUT_LOOP = "for (int cb = 0; cb < L.D16; cb += 16) {"

# name → [(text in slice_attention.cu, replacement), ...]; every
# occurrence of the text is replaced
VARIANTS = {
    "current": [],
    # hi and lo rounded by cvt.rna.tf32.f32
    "rna_split": [(_INT_SPLIT, """  hi = pmc::to_tf32(x);
  lo = pmc::to_tf32(x - __uint_as_float(hi));""")],
    # lo rounded to TF32 by integer ops too (else the tensor cores
    # truncate it)
    "round_lo": [("  lo = __float_as_uint(x - __uint_as_float(hi));",
                  "  lo = (__float_as_uint(x - __uint_as_float(hi)) + "
                  "0x1000u) & 0xffffe000u;")],
    # the logits summed in float32 registers per k-step (a fresh MMA
    # accumulator for each 8-deep step) in both kernels at every G, or in
    # neither (the deslice flushes at G > 64 as checked in)
    "logit_flush": [("warp_logits<S, NT, false>", "warp_logits<S, NT, true>"),
                    ("warp_logits<S, NT, GT == 128>",
                     "warp_logits<S, NT, true>")],
    "no_logit_flush": [("warp_logits<S, NT, GT == 128>",
                        "warp_logits<S, NT, false>")],
    # the softmax's exps as __expf (MUFU.EX2 of x log2 e)
    "fast_exp": [("acc[j][h] = expf(acc[j][h] - mx0);",
                  "acc[j][h] = __expf(acc[j][h] - mx0);"),
                 ("acc[j][2 + h] = expf(acc[j][2 + h] - mx1);",
                  "acc[j][2 + h] = __expf(acc[j][2 + h] - mx1);")],
    # diagnostic, wrong results: one TF32 product instead of three
    "one_pass": [("""  mma_tf32(d, al[0], al[1], al[2], al[3], bh0, bh1);
  mma_tf32(d, ah[0], ah[1], ah[2], ah[3], bl0, bl1);
""", "")],
    # slice_pool: the largest tile that fits, even where it leaves one
    # block per SM
    "p_max": [("if (!fit(G <= 64 ? kSmemTwoBlocks : kSmemMax)",
               "if (!fit(kSmemMax)")],
    # slice_pool: every warp over all of a tile's points (no warp groups)
    "kw1": [("  L.kw = 1;\n  while (", "  L.kw = 1;\n  while (false && ")],
    # slice_pool: three resident blocks per SM for G <= 32 (<= 85
    # registers)
    "lb3": [("__global__ void __launch_bounds__(kThreads)\nslice_pool_kernel(",
             "__global__ void __launch_bounds__(kThreads, GT == 32 ? 3 : 1)"
             "\nslice_pool_kernel(")],
    # slice_pool: the sums' k-step loop unrolled twice
    "unroll2": [(_SUMS_LOOP, "#pragma unroll 2\n    " + _SUMS_LOOP)],
    # slice_deslice: rings of two stages (one tile in flight per warp)
    "stages2": [("for (L.stages = 4;", "for (L.stages = 2;")],
    # slice_deslice: rings of three stages
    "stages3": [("for (L.stages = 4;", "for (L.stages = 3;")],
    # slice_deslice: registers left to the compiler (no second resident
    # block asked for at G <= 64), or three resident blocks at G <= 32
    # (<= 85 registers)
    "dlb1": [("__launch_bounds__(kThreads, GT <= 64 ? 2 : 1)",
              "__launch_bounds__(kThreads)")],
    "dlb3": [("__launch_bounds__(kThreads, GT <= 64 ? 2 : 1)",
              "__launch_bounds__(kThreads, GT == 32 ? 3 : (GT == 64 ? 2 : "
              "1))")],
    # diagnostics, wrong results: without the pool's sums' products,
    # without either kernel's logits' products, without the pool's
    # products, without the deslice's output products; without the exps;
    # without any tile (launch, set-up, write-out and the chunk-sum kernel)
    "no_sums": [_NO_SUMS],
    "no_logits": [_NO_LOGITS],
    "no_products": [_NO_SUMS, _NO_LOGITS],
    "no_out": [(_OUT_LOOP, "for (int cb = 0; cb < 0; cb += 16) {")],
    "no_out_products": [(_OUT_LOOP, "for (int cb = 0; cb < 0; cb += 16) {"),
                        _NO_LOGITS],
    "no_exp": [("acc[j][h] = expf(acc[j][h] - mx0);",
                "acc[j][h] = acc[j][h] - mx0;"),
               ("acc[j][2 + h] = expf(acc[j][2 + h] - mx1);",
                "acc[j][2 + h] = acc[j][2 + h] - mx1;")],
    "no_tiles": [("const int count = min(", "const int count = 0 * min(")],
}
KERNELS = {"pool": "slice_pool_kernel", "deslice": "slice_deslice_kernel"}


def use_variant(name: str, kernels):
    """Point the kernel build at a copy of csrc with the variant's edits;
    returns (library path, ptxas lines of the float32 instances)."""
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
    slice_attention._plan.cache_clear()
    so, _, report = _cuda.build()
    _cuda.library()
    lines, cur = [], False
    for line in report.splitlines():
        if "Compiling entry" in line:
            cur = any(f"{KERNELS[k]}If" in line for k in kernels)
            if cur:
                k = "pool" if "slice_pool" in line else "deslice"
                lines.append(f"{k}<{re.search(r'Li(\d+)E', line).group(1)}>")
        elif cur and ("Used" in line or "spill" in line):
            lines.append(line.strip().replace("ptxas info    : ", ""))
    return so, " ".join(lines)


def sass_histogram(so, kernel, top: int = 24) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    ops, cur = collections.Counter(), False
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = f"{kernel}IfLi32E" in m.group(1)
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if cur and m:
            ops[m.group(2)] += 1
    return ", ".join(f"{k} {v}" for k, v in ops.most_common(top))


def dump_sass(so, kernels, path):
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    keep, out = False, []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            keep = any(f"{KERNELS[k]}IfLi32E" in m.group(1) for k in kernels)
        if keep:
            out.append(line)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="16x32,32x64",
                    help="comma-separated DxG (BH=8, N=64,768)")
    ap.add_argument("--kernels", default="pool,deslice",
                    help="comma-separated: pool, deslice")
    ap.add_argument("--layout", choices=("dense", "heads"), default="dense")
    ap.add_argument("--seeds", type=int, default=1,
                    help="inputs per shape for the error (seeds D, D + 1, "
                         "...); the first is timed")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--dump", metavar="DIR",
                    help="write each variant's SASS of the kernels' <float, "
                         "32> instances into DIR")
    ap.add_argument("variants", nargs="*", default=["current"],
                    choices=sorted(VARIANTS))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_port_slice_variants: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import (card_line, heads_view, queued_ms, rel_err,
                            slice_inputs)
    from pbml_mantle_convection_tpu_torch.ops.slice_attention import (
        slice_deslice, slice_deslice_plain, slice_pool, slice_pool_plain)
    print(f"card: {card_line()}")
    kernels = args.kernels.split(",")
    shapes = [tuple(map(int, s.split("x"))) for s in args.shapes.split(",")]
    inputs = {}
    for D, G in shapes:
        for seed in range(D, D + args.seeds):
            fx, xm, ws, bs, temp, tok = slice_inputs(8, 128 * 506, D, G,
                                                     torch.float32, seed)
            wide = [t.double() for t in (fx, xm, ws, bs, temp, tok)]
            ref = {"pool": slice_pool_plain(*wide[:5]),
                   "deslice": slice_deslice_plain(wide[1], wide[5],
                                                  *wide[2:5])}
            if args.layout == "heads":
                fx, xm, tok = heads_view(fx), heads_view(xm), tok[None]
            inputs.setdefault((D, G), []).append(
                ((fx, xm, ws, bs, temp, tok), ref))
    for name in args.variants:
        so, regs = use_variant(name, kernels)
        print(f"{name}: registers {regs}")
        if args.dump:
            dump_sass(so, kernels, Path(args.dump) / f"{name}.sass")
        if args.sass:
            for k in kernels:
                print(f"{name}: SASS of {KERNELS[k]}<float, 32>: "
                      f"{sass_histogram(so, KERNELS[k])}")
        for (D, G), cases in inputs.items():
            for k in kernels:
                errs = []
                for (fx, xm, ws, bs, temp, tok), ref in cases:
                    calls = {
                        "pool": lambda: slice_pool(fx, xm, ws, bs, temp),
                        "deslice": lambda: slice_deslice(xm, tok, ws, bs,
                                                         temp)}
                    got = calls[k]()
                    got = got if k == "pool" else (got.reshape(
                        ref[k].shape),)
                    want = ref[k] if k == "pool" else (ref[k],)
                    errs.append(max(
                        rel_err(a.double().reshape(b.shape), b)[1]
                        for a, b in zip(got, want)))
                    if len(errs) == 1:
                        ms = queued_ms(calls[k])
                each = (f" (seeds: {', '.join(f'{e:.2e}' for e in errs)})"
                        if len(errs) > 1 else "")
                print(f"{name} {k} D={D} G={G}: rel err {max(errs):.2e}"
                      f"{each}, device ms {ms:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
