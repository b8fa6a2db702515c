#!/usr/bin/env python3
"""Precision and cost of train-step gradients on the card, by the route
each conv's weight gradient takes.

A network takes one train step at 128×506 in float32 and the same step on
a float64 copy (``chip_smoke.py::train_gradients``); the reading is
max |diff| / max |f64| over all parameters, beside the parameters whose
own error (max |diff| / their own max |f64|) passes 1e-5. Networks
(``--net``): ``flagship``, the NewFluidNet of ``bench.py`` (levels 5,
c_h 16, repeats 6, k 5, learned padding, curl); ``unet``, the U-Net of
``train/experiments.py::unet_roll1`` (levels 4, c_h 32, repeats 2, k 5,
replicate padding, curl); the networks of ``chip_smoke.py`` phase 11
(``OTHER_GRAD_NETS``): ``symm`` (the flagship with symmetric convs),
``fluidnet`` (levels 5, repeats 4), ``multiscale`` (levels 4, repeats
4), ``spectral`` (levels 3, repeats 2, zero padding), ``vit``
(ModelConfig's defaults). Routes of the float32 step (``--routes``):

* ``parent``: every conv's weight gradient on cuDNN (the package before
  the repairs of ROADMAP §3 faults 7 and 8);
* ``default``: the package as it is;
* ``native``: every conv's weight gradient with cuDNN off (PyTorch's
  own CUDA convolution; ``models/layers.py::conv2d_routed``), its
  forward and input gradient on cuDNN; for a learned-boundary conv, its
  8 boundary slabs;
* ``native_inner``: ``native`` and the interior conv of every
  learned-boundary conv;
* ``native@a+b``: the same for the modules ``a``, ``b`` only (a
  ``Conv2dTorch``'s, or a learned-boundary conv's slabs);
* ``no_cudnn``: the whole step with cuDNN off.

``--readings``: each route at each ``--batches`` B and weight ``--seeds``
(one JSON line each), on the ``--data`` of the tool or of phase 11.
``--locate``: where the default route's error enters, at each B and
seed: the loss gradient with respect to the last conv's output (the
U-Net's ``conv_m1``, a FluidNet's ``conv_3``, before the mean
subtraction and the head) in float32 against float64, the pixels where
the two differ by more than 1e-3 of its max (``clamp(T, 0, 1.5)`` and
the L1 terms' ``abs`` have kinks that float32's rounding can cross), and
the float64 network's parameter gradients when float32's output gradient
is fed back through it: if those match the float32 step's, all of the
error came in with that output gradient.
``--algorithms``: the device kernels of each of the flagship's conv
shapes (the interior conv and the band slabs of every
layer) forward and backward, by name, at each ``--batches`` B
(``torch.profiler``), and of the weight gradient alone, so each conv's
cuDNN algorithm can be read. ``--timing``: ms per train step of
``cli/benchmark.py --what train`` at 128×506, B = 8 for each of
``--routes`` in order, then in the reverse order. Needs the card::

    python3 tools/torch_port_grad_precision.py --net unet --readings \\
        --timing --routes parent,default,native
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

ROUTES = ("parent", "default", "native", "no_cudnn")
# the networks: their benchmark CLI flags (None: the CLI does not build
# it) and their input channels
NETS = {"flagship": (["-l", "5", "-f", "16", "-r", "6", "-k", "5", "-pad",
                      "learned"], 7),
        "unet": (["-net", "unet", "-l", "4", "-f", "32", "-r", "2", "-k",
                  "5", "-pad", "replicate"], 10),
        "symm": (None, 7),
        "fluidnet": (["-net", "fluidnet", "-l", "5", "-r", "4"], 7),
        "multiscale": (["-net", "multiscalenewfluidnet", "-l", "4", "-r",
                        "4"], 7),
        "spectral": (None, 7),
        "vit": (["-net", "vit", "--batch", "4"], 7)}
# the phase-11 networks by their OTHER_GRAD_NETS entries
_PHASE11 = {"symm": 0, "fluidnet": 1, "multiscale": 2, "spectral": 3,
            "vit": 4}


def set_route(model, name):
    """Set the weight-gradient route of ``model``'s convs for the route
    ``name`` (module doc); returns the model."""
    from pbml_mantle_convection_tpu_torch.models.layers import (
        BoundaryLearnedConvolution2D, Conv2dTorch, SymmetricConv2d)
    if name in ("default", "no_cudnn"):
        return model
    route, _, only = name.partition("@")
    only = set(only.split("+")) if only else None
    for path, mod in model.named_modules():
        if isinstance(mod, (BoundaryLearnedConvolution2D, Conv2dTorch,
                            SymmetricConv2d)):
            on = route.startswith("native") and (only is None
                                                 or path in only)
            mod.wgrad_off_cudnn = on
            if (on and route == "native_inner"
                    and isinstance(mod, BoundaryLearnedConvolution2D)):
                mod.forward = functools.partial(_inner_routed, mod)
    return model


def _inner_routed(mod, x):
    """The learned-boundary conv ``mod`` with its interior conv's weight
    gradient off cuDNN as well as its slabs'."""
    from pbml_mantle_convection_tpu_torch.models.layers import (
        blc_conv2d, conv2d_routed)
    return blc_conv2d(x, mod.kernels(), mod.learnable_bias, mod.bc_x,
                      mod.bc_y, mod._band_conv,
                      lambda xi, w: conv2d_routed(xi, w, None, True))


@contextlib.contextmanager
def route(name):
    """Every model the benchmark CLI builds inside takes route ``name``;
    ``no_cudnn`` turns cuDNN off for the block."""
    import torch
    from pbml_mantle_convection_tpu_torch.cli import benchmark
    build = benchmark.build_model
    benchmark.build_model = lambda *a, **k: set_route(build(*a, **k), name)
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = name != "no_cudnn"
    try:
        yield
    finally:
        benchmark.build_model = build
        torch.backends.cudnn.enabled = enabled


def build(net, seed, H, W, device="cuda"):
    from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet
    from pbml_mantle_convection_tpu_torch.models.registry import (
        ModelConfig, build_model)
    if net in _PHASE11:
        from chip_smoke import OTHER_GRAD_NETS, other_model
        return other_model(OTHER_GRAD_NETS[_PHASE11[net]][1], device, seed,
                           H, W)
    if net == "flagship":
        return NewFluidNet(levels=5, c_i=7, c_h=16, c_o=1, act_fn="gelu",
                           r_p="learned", loss_type="curl", repeats=6, f=5,
                           p_pred=False, seed=seed, device=device)
    return build_model(ModelConfig(network="unet", levels=4, c_h=32,
                                   repeats=2, kernel=5, r_p="replicate",
                                   loss_type="curl", p_pred=False, H=H,
                                   W=W), seed=seed, device=device)


def readings(net, batches, seeds, routes, H=128, W=506, data="tool"):
    import torch
    from chip_smoke import train_gradients
    out = []
    for B in batches:
        x, y, extra = _batch(net, B, H, W, data)
        name = {"flagship": "newfluidnet", "unet": "unet"}.get(
            net, "newfluidnet")
        for seed in seeds:
            for r in routes:
                t0 = time.perf_counter()
                leg = "no_cudnn" if r == "no_cudnn" else "step"
                rel, want, got = train_gradients(
                    set_route(build(net, seed, H, W), r), x, y, name, leg,
                    extra)
                top = max(float(w.abs().max()) for w in want.values())
                per = {n: (float((got[n].double() - w).abs().max()),
                           float(w.abs().max())) for n, w in want.items()}
                own = {n: e / t for n, (e, t) in per.items() if t > 0}
                srt = sorted(own.values())
                rec = {"net": net, "B": B, "seed": seed, "route": r,
                       "data": data,
                       "rel": rel,
                       "worst": [{"param": n, "rel": per[n][0] / top,
                                  "own": own.get(n)} for n in sorted(
                                      per, key=lambda n: -per[n][0])[:6]],
                       "own_above_1e-5": {n: v for n, v in sorted(
                           own.items(), key=lambda kv: -kv[1]) if v > 1e-5},
                       "median_own": srt[len(srt) // 2],
                       "s": round(time.perf_counter() - t0, 1)}
                print(json.dumps(rec), flush=True)
                out.append(rec)
                torch.cuda.empty_cache()
    return out


def _batch(net, B, H, W, data, device="cuda"):
    """x, y and the U-Net's extra entries of the readings' data: "tool"
    (a generator seeded 13: x then y) or "phase11" (``chip_smoke.py``
    phase 11's: seeded 21, its spectral leg's (1, H, W, 7) draw first)."""
    import torch
    from pbml_mantle_convection_tpu_torch.sim.grid import Grid
    c_i = NETS[net][1]
    g = torch.Generator().manual_seed(13 if data == "tool" else 21)
    if data == "phase11":
        torch.rand(1, H, W, c_i, generator=g)
    x = torch.rand(B, H, W, c_i, generator=g).to(device)
    y = torch.randn(B, 3 if net == "unet" else 2, H, W,
                    generator=g).to(device)
    extra = None
    if net == "unet":
        extra = {"paras": torch.tensor([[3.0, 1e8, 10.0]] * B).to(device),
                 "yc": torch.as_tensor(Grid(H=H, W=W).yc,
                                       dtype=torch.float32).to(device)
                 .expand(B, H, W)}
    return x, y, extra


def locate(net_name, batches, seeds, H=128, W=506, device="cuda",
           data="tool"):
    """Where the default route's error enters (module doc,
    ``chip_smoke.py::locate_kink``), for the U-Net (its last conv
    ``conv_m1``) or a FluidNet-family network (``conv_3``; the ensemble's
    ``nets_0.conv_3``)."""
    import torch
    from chip_smoke import locate_kink
    last = {"unet": "conv_m1", "multiscale": "nets_0.conv_3",
            "vit": "vit.Dense_1"}.get(net_name, "conv_3")
    torch.backends.cudnn.allow_tf32 = True       # PyTorch's default
    for B in batches:
        x, y, extra = _batch(net_name, B, H, W, data, device)
        for seed in seeds:
            t0 = time.perf_counter()
            rec = {"net": net_name, "B": B, "seed": seed, "data": data,
                   **locate_kink(build(net_name, seed, H, W, device), x, y,
                                 "unet" if net_name == "unet"
                                 else "newfluidnet", last, extra),
                   "s": round(time.perf_counter() - t0, 1)}
            print(json.dumps(rec), flush=True)
            torch.cuda.empty_cache()


def conv_kernels(B, c_in, c_out, h, w, wgrad_only=False):
    """Device kernels (name → µs) of one float32 conv's forward and its
    input and weight gradients at (B, c_in, h, w) with a 5×5 kernel, or
    of its weight gradient alone."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(B, c_in, h, w, device="cuda", generator=g,
                    requires_grad=True)
    k = torch.randn(c_out, c_in, 5, 5, device="cuda", generator=g,
                    requires_grad=True)
    y = F.conv2d(x, k)
    gy = torch.randn_like(y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if wgrad_only:
            torch.nn.grad.conv2d_weight(x, k.shape, gy)
        else:
            y = F.conv2d(x, k)
            y.backward(gy)
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names[e.name[:100]] = names.get(e.name[:100], 0.0) + \
                e.device_time_total
    return names


def algorithms(B, H=128, W=506):
    """The flagship's conv shapes: per layer (c_in → c_out at h × w) the
    interior conv and the row-band, column-band and corner slabs."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    layers = [("stem", 7, 16, H, W), ("conv_1", 87, 16, H, W),
              ("conv_2", 16, 16, H, W), ("conv_3", 16, 1, H, W)]
    layers += [(f"branch level {l}", 16, 16, H >> l, W >> l)
               for l in range(5)]
    for name, ci, co, h, w in layers:
        for piece, (hh, ww) in (("interior", (h, w)), ("row band", (6, w)),
                                ("column band", (h, 6)),
                                ("corner", (6, 6))):
            rec = {"layer": name, "piece": piece, "x": [B, ci, hh, ww],
                   "w": [co, ci, 5, 5]}
            for key, only in (("kernels_us", False), ("wgrad_us", True)):
                rec[key] = {k: round(v, 1) for k, v in conv_kernels(
                    B, ci, co, hh, ww, only).items()}
            print(json.dumps(rec), flush=True)


def loop_timing(net, r, iters, B=8, H=128, W=506):
    """ms per train step at B of ``net`` on route ``r``, the CLI's step
    (curl loss, scaling and derivative terms, Adam 1e-3) in a loop: for
    the networks the benchmark CLI does not build."""
    import torch
    from pbml_mantle_convection_tpu_torch.train.train_step import (
        TrainStepConfig, make_train_step)
    from pbml_mantle_convection_tpu_torch.train.trainer import adam_l2
    m = set_route(build(net, 0, H, W), r)
    step = make_train_step(m, adam_l2(m.parameters(), 1e-3), TrainStepConfig(
        net="newfluidnet", loss_scale=True, loss_derivative=True,
        loss_type="curl"))
    g = torch.Generator().manual_seed(0)
    batch = {"x": torch.randn(B, H, W, 7, generator=g).cuda(),
             "y": torch.randn(B, 2, H, W, generator=g).cuda()}
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = r != "no_cudnn"
    try:
        step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            step(batch)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.enabled = enabled
    return {"metric": f"train_step_{net}_{H}x{W}_B{B}", "value": round(
        (time.perf_counter() - t0) / iters * 1e3, 3), "unit": "ms"}


def timing(net, routes, iters=20):
    import torch
    from pbml_mantle_convection_tpu_torch.cli.benchmark import main as bench
    out = []
    for r in routes + routes[::-1]:
        if NETS[net][0] is None:
            rec = loop_timing(net, r, iters)
        else:
            buf = io.StringIO()
            with route(r), contextlib.redirect_stdout(buf):
                bench(["--what", "train", *NETS[net][0], "--iters",
                       str(iters)])
            rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        rec["route"] = r
        print(json.dumps(rec), flush=True)
        out.append(rec)
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--net", default="flagship", choices=sorted(NETS))
    ap.add_argument("--readings", action="store_true")
    ap.add_argument("--locate", action="store_true")
    ap.add_argument("--algorithms", action="store_true")
    ap.add_argument("--timing", action="store_true")
    ap.add_argument("--batches", default="2,8")
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--routes", default=",".join(ROUTES))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--data", default="tool", choices=["tool", "phase11"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_grad_precision: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import card_line
    print(card_line(), flush=True)
    if args.readings:
        readings(args.net, [int(b) for b in args.batches.split(",")],
                 [int(s) for s in args.seeds.split(",")],
                 args.routes.split(","), data=args.data)
    if args.locate:
        locate(args.net, [int(b) for b in args.batches.split(",")],
               [int(s) for s in args.seeds.split(",")], data=args.data)
    if args.algorithms:
        for b in args.batches.split(","):
            algorithms(int(b))
    if args.timing:
        timing(args.net, args.routes.split(","), args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
