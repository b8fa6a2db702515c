#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

1. prints the card's name and power limit, builds the CUDA kernels from
   ``pbml_mantle_convection_tpu_torch/csrc`` (nvcc, sm_90a) and prints the
   build time;
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the flagship's 128×506 rollout gives it (TF32 off), and times
   both;
3. drives the main path — the coupled ML_STOKES rollout of the flagship
   NewFluidNet (levels=5, c_h=16, repeats=6, k=5, learned padding, curl
   head; seeded random weights) through the fused executor at 128×506 and
   256×256 — checks the kernel launch counts per step and that T stays
   finite, prints steps/s, and compares 10 steps of the kernel path with
   the plain-PyTorch module path;
4. prints one JSON line of per-kernel numbers, the card line again, and
   last ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero and prints no result
line; so does a machine without a CUDA device or a directory without the
package. The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

# peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
# outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
REPLACES = {
    "layer_stack": "pbml_mantle_convection_tpu/ops/branch_kernel.py:609",
    "trunk": "pbml_mantle_convection_tpu/ops/merge_kernel.py:76",
    "curl_advect_epilogue":
        "pbml_mantle_convection_tpu/ops/epilogue_kernel.py:60",
}
SOURCES = {
    "layer_stack": "pbml_mantle_convection_tpu_torch/csrc/layer_stack.cu",
    "trunk": "pbml_mantle_convection_tpu_torch/csrc/trunk.cu",
    "curl_advect_epilogue":
        "pbml_mantle_convection_tpu_torch/csrc/epilogue.cu",
}
# kernel vs plain version, max |diff| / max |plain|: both are float32 with
# sums in another order (25·c_in-term conv dots, double vs float GroupNorm
# statistics, the epilogue's analytic mean cancellation)
TOL = {"layer_stack": 1e-4, "trunk": 1e-4, "curl_advect_epilogue": 1e-5}
# 10 coupled steps, kernel path vs module path: the random-weight network
# (34 GroupNorm layers) feeds its float32 reassociation noise back through
# T → viscosity → velocities every step
TOL_ROLLOUT = {"T": 1e-3, "u": 2e-2, "v": 2e-2}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, n: int = 20, warm: int = 3) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    tb, to = n_bytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def stack_work(sw, H, W, pool):
    """(bytes, flops) of one layer_stack call: inputs read once, outputs
    written once; conv FMAs as 2 flops, + bias, GroupNorm (~4/elem) and
    GELU (~6/elem), 4 flops per pooled output."""
    hw = H * W
    flops = 0.0
    c_in = sw.c_in
    for _ in range(sw.R):
        flops += (2 * c_in * 25 + 1 + 4 * sw.use_gn + 6 * sw.use_act) \
            * sw.c_o * hw
        c_in = sw.c_o
    n_pool = sw.c_in * (H // 2) * (W // 2) if pool else 0
    flops += 4 * n_pool
    n_bytes = 4 * (sw.c_in * hw + sw.packed.numel() + 3 * sw.bias.numel()
                   + sw.c_o * hw + n_pool)
    return n_bytes, flops


def rel_err(a, b) -> tuple[float, float]:
    d = float((a - b).abs().max())
    return d, d / max(float(b.abs().max()), 1e-30)


def flagship(H, W, device):
    from pbml_mantle_convection_tpu_torch.constants import SimParams
    from pbml_mantle_convection_tpu_torch.models.fast_path import (
        FastNewFluidNet)
    from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet
    from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine
    from pbml_mantle_convection_tpu_torch.sim.grid import Grid
    from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper
    grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2) if H != W else 1.0)
    params = SimParams(raq=3.0, fkt=1e8, fkp=10.0)
    model = NewFluidNet(levels=5, c_i=7, c_h=16, c_o=1, act_fn="gelu",
                        r_p="learned", loss_type="curl", repeats=6, f=5,
                        p_pred=False, seed=0, device=device)
    fast = FastNewFluidNet(model, H, W)

    def engine(apply_fn):
        return SimEngine(TimeStepper(grid, params, apply_fn, cn_max=0.99,
                                     device=device))

    T0 = np.clip(1.0 - grid.yc + 0.05 * np.sin(6.28 * grid.xc), 0.0, 1.0)
    return model, fast, engine, T0[None]


def check_kernels(H, W):
    """Phase 2: every kernel against its plain version at main-path
    shapes. Returns the per-kernel records (launches filled later)."""
    import torch
    import torch.nn.functional as F
    from pbml_mantle_convection_tpu_torch.ops.branch_kernel import (
        layer_stack, layer_stack_plain)
    from pbml_mantle_convection_tpu_torch.ops.epilogue_kernel import (
        curl_advect_epilogue, curl_advect_epilogue_plain)
    from pbml_mantle_convection_tpu_torch.ops.merge_kernel import (
        trunk, trunk_plain)

    _, fast, engine, T0 = flagship(H, W, "cuda")
    eng = engine(fast)
    T = eng.init_state(T0).T
    eng.stepper._bound_fast()          # binds the static input channels
    x = fast.input_from_T(T)

    # the main path's stage inputs, from the plain chain
    stacks = [("stem", x, fast.stem, False)]
    b, _ = layer_stack_plain(x, fast.stem)
    outs = []
    for l, sw in enumerate(fast.branches):
        pool = l < len(fast.branches) - 1
        stacks.append((f"level{l}", b, sw, pool))
        y, b = layer_stack_plain(b, sw, pool)
        outs.append(y)
    y1 = trunk_plain(outs[0], outs[1:], x, fast.trunk)
    y2, _ = layer_stack_plain(y1, fast.merge2)
    stacks += [("merge2", y1, fast.merge2, False),
               ("merge3", y2, fast.merge3, False)]
    psi, _ = layer_stack_plain(y2, fast.merge3)

    rec = {}
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, rel=0.0,
               bytes=0.0, flops=0.0)
    for name, inp, sw, pool in stacks:
        yk, pk = layer_stack(inp, sw, pool)
        yp, pp = layer_stack_plain(inp, sw, pool)
        err, rel = rel_err(yk, yp)
        if pool:
            e2, r2 = rel_err(pk, pp)
            err, rel = max(err, e2), max(rel, r2)
        ms = cuda_ms(lambda: layer_stack(inp, sw, pool))
        pms = cuda_ms(lambda: layer_stack_plain(inp, sw, pool), n=5)
        nb, fl = stack_work(sw, inp.shape[1], inp.shape[2], pool)
        bms, _ = bound_ms(nb, fl)
        print(f"layer_stack {name:7s} c_in={sw.c_in:2d} c_o={sw.c_o:2d} "
              f"R={sw.R} {inp.shape[1]}x{inp.shape[2]} pool={pool:d}: "
              f"max_abs_err={err:.3e} rel={rel:.3e} (tol {TOL['layer_stack']})"
              f" ms={ms:.4f} plain_ms={pms:.4f} bound_ms={bms:.4f}")
        if not rel <= TOL["layer_stack"]:
            raise AssertionError(f"layer_stack {name} disagrees: {rel}")
        tot["ms"] += ms
        tot["plain_ms"] += pms
        tot["bytes"] += nb
        tot["flops"] += fl
        tot["err"] = max(tot["err"], err)
    bms, by = bound_ms(tot["bytes"], tot["flops"])
    rec["layer_stack"] = dict(max_abs_err=tot["err"], ms=tot["ms"],
                              plain_ms=tot["plain_ms"], bound_ms=bms,
                              bound_by=by, library_ms=None)

    # trunk
    yk = trunk(outs[0], outs[1:], x, fast.trunk)
    err, rel = rel_err(yk, y1)
    ms = cuda_ms(lambda: trunk(outs[0], outs[1:], x, fast.trunk))
    pms = cuda_ms(lambda: trunk_plain(outs[0], outs[1:], x, fast.trunk), n=5)

    def interp():
        return [F.interpolate(c[None], size=(H, W), mode="bicubic",
                              align_corners=False) for c in outs[1:]]
    lib_ms = cuda_ms(interp)
    from pbml_mantle_convection_tpu_torch.ops.resize import (
        resize_bicubic_nchw)
    e_int = max(rel_err(a[0], resize_bicubic_nchw(c, (H, W)))[1]
                for a, c in zip(interp(), outs[1:]))
    c_h = fast.trunk.merge.c_o
    n_coarse = sum(c.numel() for c in outs[1:])
    nb, fl = stack_work(fast.trunk.merge, H, W, False)
    nb += 4 * n_coarse - 4 * c_h * len(outs[1:]) * H * W
    fl += 40 * c_h * len(outs[1:]) * H * W
    bms, by = bound_ms(nb, fl)
    print(f"trunk c_in={fast.trunk.merge.c_in} {H}x{W}: max_abs_err="
          f"{err:.3e} rel={rel:.3e} (tol {TOL['trunk']}) ms={ms:.4f} "
          f"plain_ms={pms:.4f} bound_ms={bms:.4f} library_ms(4x "
          f"F.interpolate bicubic)={lib_ms:.4f} (F.interpolate vs resize "
          f"matrices rel {e_int:.2e})")
    if not rel <= TOL["trunk"]:
        raise AssertionError(f"trunk disagrees: {rel}")
    rec["trunk"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                        bound_by=by, library_ms=lib_ms)

    # epilogue
    consts, s, src = eng._epi, eng.stepper.scaler, eng._raq
    outk = curl_advect_epilogue(psi[0], T[0], consts, s, src)
    outp = curl_advect_epilogue_plain(psi[0], T[0], consts, s, src)
    errs = [rel_err(a, b) for a, b in zip(outk, outp)]
    err, rel = max(e for e, _ in errs), max(r for _, r in errs)
    ms = cuda_ms(lambda: curl_advect_epilogue(psi[0], T[0], consts, s, src))
    pms = cuda_ms(lambda: curl_advect_epilogue_plain(psi[0], T[0], consts,
                                                     s, src), n=5)
    nb = 4 * (2 * H * W + 4 * (H - 2) * (W - 2) + 3 * H * W + 1)
    bms, by = bound_ms(nb, 45 * H * W)
    print(f"curl_advect_epilogue {H}x{W}: max_abs_err={err:.3e} "
          f"rel={rel:.3e} (tol {TOL['curl_advect_epilogue']}) ms={ms:.4f} "
          f"plain_ms={pms:.4f} bound_ms={bms:.4f}")
    if not rel <= TOL["curl_advect_epilogue"]:
        raise AssertionError(f"curl_advect_epilogue disagrees: {rel}")
    rec["curl_advect_epilogue"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                       bound_ms=bms, bound_by=by,
                                       library_ms=None)
    return rec


def run_main_path(counters):
    """Phase 3: the flagship rollout through the kernels at both grids.
    Returns the launch counts of the timed runs."""
    import torch
    launch = {n: 0 for n in counters}
    for H, W in ((128, 506), (256, 256)):
        _, fast, engine, T0 = flagship(H, W, "cuda")
        eng = engine(fast)
        state = eng.init_state(T0)
        state, _ = eng.multi_step(state, 20)          # warm-up
        torch.cuda.synchronize()
        n, reps, best = 200, 3, 0.0
        for fn in counters.values():
            fn.launches = 0
        for _ in range(reps):
            t0 = time.perf_counter()
            state, trace = eng.multi_step(state, n)
            torch.cuda.synchronize()
            best = max(best, n / (time.perf_counter() - t0))
        got = {k: fn.launches for k, fn in counters.items()}
        steps = n * reps
        want = {"layer_stack": 8 * steps, "trunk": steps,
                "curl_advect_epilogue": steps}
        if got != want:
            raise AssertionError(f"{H}x{W}: launches {got}, want {want}")
        if not bool(torch.isfinite(state.T).all()):
            raise AssertionError(f"{H}x{W}: T is not finite")
        mean_T = trace.mean_T.cpu().numpy()
        print(f"main path {H}x{W}: {best:.1f} steps/s (best of {reps} x "
              f"{n} steps), launches {got} = 8+1+1 per step, "
              f"mean T {mean_T[-1]:.6f}")
        for k in launch:
            launch[k] += got[k]
    return launch


def compare_paths(H, W, K=10):
    """Phase 3b: K steps of the kernel path vs the plain module path."""
    model, fast, engine, T0 = flagship(H, W, "cuda")
    finals = []
    for apply_fn in (fast, model):
        eng = engine(apply_fn)
        finals.append(eng.multi_step(eng.init_state(T0), K)[0])
    sk, sp = finals
    for name in ("T", "u", "v"):
        err, rel = rel_err(getattr(sk, name), getattr(sp, name))
        print(f"{K} steps {H}x{W} kernel vs plain path: {name} "
              f"max_abs_err={err:.3e} rel={rel:.3e} (tol {TOL_ROLLOUT[name]})")
        if not rel <= TOL_ROLLOUT[name]:
            raise AssertionError(f"kernel path diverges from plain: {name}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from pbml_mantle_convection_tpu_torch.ops import _cuda
    from pbml_mantle_convection_tpu_torch.ops.branch_kernel import layer_stack
    from pbml_mantle_convection_tpu_torch.ops.epilogue_kernel import (
        curl_advect_epilogue)
    from pbml_mantle_convection_tpu_torch.ops.merge_kernel import trunk

    card = card_line()
    print(f"card: {card}")
    _, secs, report = _cuda.build()
    _cuda.library()
    print(f"kernels built in {secs:.1f} s")
    for line in report.splitlines():
        if re.search(r"Function properties|registers|spill", line):
            print("  ptxas:", line.strip())

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)

    t0 = time.perf_counter()
    rec = check_kernels(128, 506)
    print(f"kernel checks: {time.perf_counter() - t0:.1f} s")
    counters = {"layer_stack": layer_stack, "trunk": trunk,
                "curl_advect_epilogue": curl_advect_epilogue}
    launch = run_main_path(counters)
    compare_paths(128, 506)

    kernels = [dict(name=k, route="cuda", source=SOURCES[k],
                    replaces=REPLACES[k], launches=launch[k], **rec[k])
               for k in counters]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
