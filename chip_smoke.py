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
4. drives the other engine modes at 128×506 in float32 — GAIA (converged
   PT Stokes solve, ``make_stokes_fn`` defaults), GAIA-skip3, ML_PRE with
   the flagship (pre_iter=200) and ML_STOKES with core cooling, Di=0.5 and
   radioactive decay — checks their launch counts per step, T and its
   boundary rows, prints ms/step and PT iterations, and holds each of a
   few steps against a plain reference step composed here from the plain
   functions;
5. prints one JSON line of per-kernel numbers, the card line again, and
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
    "advect_diffuse_step_fused":
        "pbml_mantle_convection_tpu/ops/pallas_kernels.py:46",
}
SOURCES = {
    "layer_stack": "pbml_mantle_convection_tpu_torch/csrc/layer_stack.cu",
    "trunk": "pbml_mantle_convection_tpu_torch/csrc/trunk.cu",
    "curl_advect_epilogue":
        "pbml_mantle_convection_tpu_torch/csrc/epilogue.cu",
    "advect_diffuse_step_fused":
        "pbml_mantle_convection_tpu_torch/csrc/advect.cu",
}
# kernel vs plain version, max |diff| / max |plain|: both are float32 with
# sums in another order (25·c_in-term conv dots, double vs float GroupNorm
# statistics, the epilogue's analytic mean cancellation); the energy step
# differs only by FMA contraction (1e-12 in float64)
TOL = {"layer_stack": 1e-4, "trunk": 1e-4, "curl_advect_epilogue": 1e-5,
       "advect_diffuse_step_fused": 1e-5}
TOL_ADVECT_F64 = 1e-12
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


def queued_ms(fn, n: int = 200) -> float:
    """Device time per call: the host queues the n calls while the card
    spins (~50 ms), so the events time the kernels back to back and not
    the host's enqueue."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
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
    consts, s, src = eng._epi, eng.stepper.scaler, eng.stepper._raq
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
    rec["advect_diffuse_step_fused"] = check_advect(eng, T)
    return rec


def check_advect(eng, T):
    """The energy-step kernel against its plain version at 128×506, B=1:
    float32 with the scalar source (GAIA, ML_PRE) and with the field
    source (Di > 0) under core cooling, and float64. Times the float32
    scalar-source call."""
    import torch
    from pbml_mantle_convection_tpu_torch.ops.advect_kernel import (
        advect_diffuse_step_fused, advect_diffuse_step_plain)
    from pbml_mantle_convection_tpu_torch.physics.advection import (
        grid_metrics)
    dev = T.device
    g = torch.Generator(device=dev).manual_seed(5)
    _, H, W = T.shape
    u, v = (float(eng.stepper.scaler) * torch.randn(
        1, H, W, generator=g, device=dev) for _ in range(2))
    met, src = eng.stepper._metrics, eng.stepper._raq
    field = src + 0.1 * torch.randn(1, H - 2, W - 2, generator=g,
                                    device=dev)
    met64 = grid_metrics(*eng.grid.coords(dev, torch.float64),
                         aspect=eng.grid.aspect)
    tol = TOL["advect_diffuse_step_fused"]
    cases = [("f32 scalar src", (u, v, T, src, met), {}, tol),
             ("f32 field src, core_cool", (u, v, T, field, met),
              dict(core_cool=True), tol),
             ("f64 scalar src", (u.double(), v.double(), T.double(),
                                 src.double(), met64), {}, TOL_ADVECT_F64)]
    err0 = None
    for name, args, kw, tol in cases:
        out, dt = advect_diffuse_step_fused(*args, cn_max=0.99, **kw)
        ref, dt_ref = advect_diffuse_step_plain(*args, cn_max=0.99, **kw)
        err, rel = rel_err(out, ref)
        dt_rel = abs(float(dt) - float(dt_ref)) / float(dt_ref)
        print(f"advect {name} {H}x{W}: max_abs_err={err:.3e} rel={rel:.3e} "
              f"(tol {tol}) dt rel {dt_rel:.1e}")
        if not (rel <= tol and dt_rel <= 1e-6):
            raise AssertionError(f"advect {name} disagrees: {rel}, {dt_rel}")
        if err0 is None:
            err0 = err
    ms = cuda_ms(lambda: advect_diffuse_step_fused(u, v, T, src, met,
                                                   cn_max=0.99), n=200)
    pms = cuda_ms(lambda: advect_diffuse_step_plain(u, v, T, src, met,
                                                    cn_max=0.99), n=50)
    dms = queued_ms(lambda: advect_diffuse_step_fused(u, v, T, src, met,
                                                      cn_max=0.99))
    # u, v, T and 4 interior metric arrays read, T written, 2 scalars
    nb = 4 * (4 * H * W + 4 * (H - 2) * (W - 2) + 2)
    bms, by = bound_ms(nb, 35 * H * W)
    print(f"advect_diffuse_step_fused {H}x{W} f32: ms={ms:.4f} "
          f"(device only, launches queued: {dms:.4f}) plain_ms={pms:.4f} "
          f"bound_ms={bms:.5f} ({by}); library_ms: none (no one PyTorch "
          f"call computes an upwind step)")
    return dict(max_abs_err=err0, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, library_ms=None)


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
                "curl_advect_epilogue": steps,
                "advect_diffuse_step_fused": 0}
        if got != want:
            raise AssertionError(f"{H}x{W}: launches {got}, want {want}")
        if not bool(torch.isfinite(state.T).all()):
            raise AssertionError(f"{H}x{W}: T is not finite")
        mean_T = trace.mean_T.cpu().numpy()
        print(f"main path {H}x{W}: {best:.1f} steps/s (best of {reps} x "
              f"{n} steps), launches {got} = 8+1+1+0 per step, "
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


def mode_engines(H, W, device="cuda"):
    """The engine modes of phase 4 on the flagship's grid, float32:
    name → (engine, plain module or None, steps timed, steps compared)."""
    from pbml_mantle_convection_tpu_torch.physics.stokes import (
        make_stokes_fn)
    from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine
    from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper
    model, fast, engine, T0 = flagship(H, W, device)
    base = engine(fast)
    grid, params = base.grid, base.params

    def stepper(apply_fn, **kw):
        return TimeStepper(grid, params, apply_fn, cn_max=0.99,
                           device=device, **kw)

    def gaia():
        return make_stokes_fn(grid, params.raq)     # n_iter 2000, ptol 1e-5

    return T0, {
        "GAIA": (SimEngine(stepper(None), mode="GAIA", stokes_fn=gaia()),
                 None, 3, 2),
        "GAIA-skip3": (SimEngine(stepper(None), mode="GAIA", intervene_ts=3,
                                 stokes_fn=gaia()), None, 6, 4),
        "ML_PRE": (SimEngine(stepper(fast), mode="ML_PRE",
                             stokes_fn=make_stokes_fn(grid, params.raq,
                                                      pre_iter=200)),
                   model, 10, 3),
        "ML_STOKES-core_cool-Di0.5-decay": (
            SimEngine(stepper(fast), core_cool=True, Di=0.5,
                      radioactive_decay=True), model, 50, 10),
    }


def plain_step(eng, state, n_step, model):
    """One step of ``eng``'s mode composed from the plain functions: the
    NewFluidNet module for the surrogate, the plain energy step; the PT
    solve and the sources are torch ops in both."""
    import torch
    from pbml_mantle_convection_tpu_torch.constants import COORD_SCALE
    from pbml_mantle_convection_tpu_torch.ops.advect_kernel import (
        advect_diffuse_step_plain)
    from pbml_mantle_convection_tpu_torch.ops.stencils import (
        stamp_temperature_bc)
    from pbml_mantle_convection_tpu_torch.physics.advection import (
        viscous_dissipation)
    from pbml_mantle_convection_tpu_torch.physics.viscosity import (
        fk_viscosity)
    from pbml_mantle_convection_tpu_torch.sim.engine import (
        CORE_RHOCP_VAR, decay_heating)
    from pbml_mantle_convection_tpu_torch.sim.stepper import (
        assemble_fluidnet_input)
    st, prm, T = eng.stepper, eng.params, state.T
    if eng.mode == "GAIA":
        V = fk_viscosity(prm.fkt, prm.fkp,
                         1.0 - st._static.yc_feat * COORD_SCALE, T)
        if n_step % eng.intervene_ts == 0:
            u, v, p = eng.stokes_fn(T, V)
        else:
            u, v, p = state.u, state.v, state.p
    else:
        x, V = assemble_fluidnet_input(T, st._static, prm)
        u, v, p = model(x)
        u, v = u * st.scaler, v * st.scaler
        if p is None:
            p = state.p
        if eng.mode == "ML_PRE":
            u, v, p = eng.stokes_fn(T, V, (u, v, p))
    src = decay_heating(prm.raq, state.t, eng.radioactive_decay)
    if eng.Di > 0:
        src = (src - eng.Di * v[..., 1:-1, 1:-1] * T[..., 1:-1, 1:-1]
               + eng.Di * viscous_dissipation(u, v, V, st._metrics))
    T_new, dt = advect_diffuse_step_plain(u, v, T, src, st._metrics,
                                          cn_max=st.cn_max,
                                          core_cool=eng.core_cool)
    T_core = state.T_core
    if eng.core_cool:
        q_cmb = torch.mean((state.T_core - T_new[..., 1, :])
                           / (0.5 * eng.grid.dy))
        T_core = T_core - dt * CORE_RHOCP_VAR * q_cmb
        T_new[..., 0, :] = T_core
    T_new = torch.clamp(stamp_temperature_bc(T_new, core_cool=eng.core_cool),
                        0.0, 2.0)
    return state._replace(T=T_new, u=u, v=v, p=p, V=V, t=state.t + dt,
                          dt=dt, n_step=state.n_step + 1, T_core=T_core)


def check_bc_rows(name, state, core_cool):
    import torch
    T = state.T
    if not bool(torch.isfinite(T).all()):
        raise AssertionError(f"{name}: T is not finite")
    bottom = state.T_core if core_cool else torch.ones((), device=T.device)
    ok = (bool((T[:, -1] == 0).all())
          and bool((T[:, 0] == torch.clamp(bottom, 0, 2)).all())
          and bool((T[..., 0] == T[..., 1]).all())
          and bool((T[..., -1] == T[..., -2]).all()))
    if not ok:
        raise AssertionError(f"{name}: boundary rows are wrong")


def run_modes(counters, H=128, W=506):
    """Phase 4: each engine mode through its kernels, launch counts per
    step asserted, then a few steps against the plain reference. Returns
    the launch counts of the timed runs."""
    import torch
    launch = {n: 0 for n in counters}
    T0, modes = mode_engines(H, W)
    for name, (eng, model, n, K) in modes.items():
        state = eng.multi_step(eng.init_state(T0), 1)[0]      # warm-up
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        state, trace = eng.multi_step(state, n)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n * 1e3
        got = {k: fn.launches for k, fn in counters.items()}
        net = eng.mode != "GAIA"
        want = {"layer_stack": 8 * n * net, "trunk": n * net,
                "curl_advect_epilogue": 0, "advect_diffuse_step_fused": n}
        if got != want:
            raise AssertionError(f"{name}: launches {got}, want {want}")
        check_bc_rows(name, state, eng.core_cool)
        pt = ("" if eng.stokes_fn is None else
              f", PT iterations of the last solve "
              f"{eng.stokes_fn.n_done.tolist()}")
        print(f"mode {name} {H}x{W} f32: {ms:.3f} ms/step ({n} steps), "
              f"launches {got} per run{pt}, mean T "
              f"{float(trace.mean_T[-1]):.6f}, T_core "
              f"{float(state.T_core):.6f}")
        for k in launch:
            launch[k] += got[k]

        # each of K steps from the same state, the kernel path's: the EBA
        # dissipation source (Di·Φ·dt ~ 1e5 with these velocities) turns
        # the surrogates' 1e-6 velocity differences into 1e-4 in T per
        # step, which a free-running comparison would compound
        sk = eng.init_state(T0)
        worst = {f: (0.0, 0.0) for f in ("T", "u", "v")}
        with torch.no_grad():
            for i in range(K):
                sp = plain_step(eng, sk, i, model)
                sk = eng.step(sk)
                check_bc_rows(name + " plain", sp, eng.core_cool)
                for f in worst:
                    worst[f] = max(worst[f],
                                   rel_err(getattr(sk, f), getattr(sp, f)),
                                   key=lambda e: e[1])
        for f, (err, rel) in worst.items():
            print(f"  {K} steps, each kernel vs plain: {f} max_abs_err="
                  f"{err:.3e} rel={rel:.3e} (tol {TOL_ROLLOUT[f]})")
            if not rel <= TOL_ROLLOUT[f]:
                raise AssertionError(f"{name}: kernel step disagrees with "
                                     f"plain: {f}")
    return launch


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from pbml_mantle_convection_tpu_torch.ops import _cuda
    from pbml_mantle_convection_tpu_torch.ops.advect_kernel import (
        advect_diffuse_step_fused)
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
                "curl_advect_epilogue": curl_advect_epilogue,
                "advect_diffuse_step_fused": advect_diffuse_step_fused}
    launch = run_main_path(counters)
    compare_paths(128, 506)
    t0 = time.perf_counter()
    for k, n in run_modes(counters).items():
        launch[k] += n
    print(f"engine modes: {time.perf_counter() - t0:.1f} s")

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
