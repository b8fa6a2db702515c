"""Closed-loop coupled rollouts: one simulation run back to back.

Traffic parameters (``benchmarks/traffic/<name>.json``): ``mode``
(ML_STOKES or ML_PRE), ``snapshot_every`` (steps between the copies of
the fields to the host, the rollout CLI's cadence), ``chunk_steps``
(steps per ``SimEngine.rollout`` call, a multiple of it), ``warm_chunks``,
``pt_iters`` and ``pre_iter`` (ML_PRE's PT solve), ``keep_share`` (the
share of snapshot intervals kept for the check), ``check_pairs`` (how
many of them the reference follows), ``trace_steps`` (the profiled
stretch) and ``enqueue_runs``. It runs one simulation: a traffic file
with any other key (a ``batch``, say) is refused, not run at B=1.

The entry is the program's ``SimEngine.rollout(state, n, snapshot_every)``
on the flagship's fused executor, called until the window has passed.
The initial temperature is the benchmark CLI's field with a phase drawn
from the seed. The check: the reference follows ``check_pairs``
snapshot intervals drawn from the seed, each from the program's state at
its start (the snapshot the rollout copied to the host), and the first
interval from the initial field, which the benchmark made; it compares
T, u, v at the interval's end and the summed dt of its steps.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from ..harness.common import TraceView, Window, max_abs, now, sync, tf32
from ..harness.trace import Trace, span_calls
from ..harness.weights import CHECK, INPUTS, sub_seed
from ..models import newfluidnet as family
from ..reference import fluidnet as ref_net
from ..reference import physics as ref

FIELDS = ("T", "u", "v", "p")
KEYS = ("mode", "snapshot_every", "chunk_steps", "warm_chunks", "pt_iters",
        "pre_iter", "keep_share", "check_pairs", "trace_steps",
        "enqueue_runs")


def initial_temperature(H, W, aspect, phase):
    """clip(1 − y + 0.05·sin(6.28·x + phase), 0, 1) (bench.py's field)."""
    xc, yc = ref.grid_coords(H, W, aspect)
    return np.clip(1.0 - yc + 0.05 * np.sin(6.28 * xc + phase), 0.0, 1.0)


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.H, self.W = cfg["grid"]["H"], cfg["grid"]["W"]
        self.aspect = (self.W - 2) / (self.H - 2)
        self.m = family.dims(cfg)
        self.every = traffic["snapshot_every"]
        self.pairs = []          # kept (start, end) snapshot intervals

    # -- set-up -------------------------------------------------------
    def setup(self) -> None:
        from pbml_mantle_convection_tpu_torch.constants import SimParams
        from pbml_mantle_convection_tpu_torch.models.fast_path import \
            FastNewFluidNet
        from pbml_mantle_convection_tpu_torch.physics.stokes import \
            make_stokes_fn
        from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine
        from pbml_mantle_convection_tpu_torch.sim.grid import Grid
        from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper

        s = self.cfg["sim"]
        self.model, self.weights = family.build(self.cfg, self.seed,
                                                self.device)
        self.fast = FastNewFluidNet(self.model, self.H, self.W)
        grid = Grid(H=self.H, W=self.W, aspect=self.aspect)
        stepper = TimeStepper(grid, SimParams(s["raq"], s["fkt"], s["fkp"]),
                              self.fast, cn_max=s["cn_max"],
                              device=self.device)
        mode = self.tr["mode"]
        self.stokes_fn = None
        if mode == "ML_PRE":
            self.stokes_fn = make_stokes_fn(grid, s["raq"],
                                            n_iter=self.tr["pt_iters"],
                                            pre_iter=self.tr["pre_iter"])
        self.engine = SimEngine(stepper, mode, stokes_fn=self.stokes_fn)
        rng = np.random.default_rng(sub_seed(self.seed, INPUTS))
        T0 = initial_temperature(self.H, self.W, self.aspect,
                                 rng.uniform(0.0, 2.0 * math.pi))
        state = self.engine.init_state(T0)
        # the first interval, from the benchmark's own field, is checked
        start = {"T": T0[None], "p": np.zeros_like(T0)[None]}
        state, trace, snaps = self._rollout(state, self.every)
        self.first = (start, self._end(snaps[0], trace.dt))
        for _ in range(self.tr["warm_chunks"]):
            state, _, _ = self._rollout(state, self.tr["chunk_steps"])
        sync(self.device)
        self.state = state
        self._check_rng = np.random.default_rng(sub_seed(self.seed, CHECK))

    def _rollout(self, state, n):
        return self.engine.rollout(state, n, self.every)

    @staticmethod
    def _end(snap, dts):
        out = {k: snap[k] for k in FIELDS}
        out["dt_sum"] = float(dts.double().sum())
        return out

    # -- the measured window -----------------------------------------
    def window(self, seconds: float) -> Window:
        n, failed, prev = self.tr["chunk_steps"], 0, None
        keep = self.tr["keep_share"]
        steps, state = 0, self.state
        t0 = now()
        while True:
            state, trace, snaps = self._rollout(state, n)
            steps += n
            dts = trace.dt.view(len(snaps), self.every)
            for k, snap in enumerate(snaps):
                if not np.isfinite(snap["T"]).all():
                    failed += self.every
                if prev is not None and self._check_rng.random() < keep:
                    self.pairs.append(({f: prev[f] for f in FIELDS},
                                       self._end(snap, dts[k])))
                prev = snap
            if now() - t0 >= seconds:
                break
        sync(self.device)
        elapsed = now() - t0
        self.state = state
        return Window(units=steps, failed=failed, seconds=elapsed)

    def end_to_end(self, w: Window) -> dict:
        return {"sim_steps_per_s": w.units / w.seconds}

    # -- the traced run -----------------------------------------------
    def traced(self, seconds: float, trace_path) -> TraceView:
        from torch.profiler import ProfilerActivity, profile
        from pbml_mantle_convection_tpu_torch.models import fast_path

        n = self.tr["trace_steps"]
        state = self.state
        # unprofiled: the host-clock time of a step of the same work
        runs, t0 = 0, now()
        while now() - t0 < min(seconds, 5.0) or runs == 0:
            state, _, _ = self._rollout(state, self.tr["chunk_steps"])
            runs += 1
        sync(self.device)
        unit_wall = (now() - t0) / (runs * self.tr["chunk_steps"])
        counters = {}
        # the host's time to enqueue one step, on an idle device
        enq = []
        for _ in range(self.tr["enqueue_runs"]):
            sync(self.device)
            t1 = now()
            state, _ = self.engine.multi_step(state, 2)
            enq.append((now() - t1) / 2)
        sync(self.device)
        counters["host_enqueue_ms"] = 1e3 * float(np.median(enq))
        spans = [(fast_path, "layer_stack", "bench.layer_stack"),
                 (fast_path, "layer_stacks", "bench.layer_stack"),
                 (fast_path, "trunk", "bench.trunk"),
                 (self.fast, "psi", "bench.executor")]
        if self.stokes_fn is not None:
            spans.append((self.engine, "stokes_fn", "bench.pt_solve"))
        pt_iters = []
        with contextlib.ExitStack() as stack:
            for owner, attr, name in spans:
                stack.enter_context(span_calls(owner, attr, name))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t1, done = now(), 0
                while done < n:
                    state, _, _ = self._rollout(state, self.every)
                    done += self.every
                    if self.stokes_fn is not None:
                        pt_iters.append(int(self.stokes_fn.n_done.sum()))
                sync(self.device)
                wall = now() - t1
        if pt_iters:
            counters["pt_iterations_per_step"] = float(np.mean(pt_iters))
        self.state = state
        return TraceView(Trace.from_profiler(prof, trace_path), done, wall,
                         unit_wall, counters, self.cfg, self.m,
                         self.cfg["peaks"])

    # -- the check ----------------------------------------------------
    def release(self) -> None:
        """Free the program's state; the kept snapshots and the
        benchmark's weights stay."""
        del self.engine, self.fast, self.model, self.state
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def _intervals(self):
        n = min(self.tr["check_pairs"], len(self.pairs))
        rng = np.random.default_rng(sub_seed(self.seed, CHECK) + 1)
        pick = sorted(rng.choice(len(self.pairs), size=n, replace=False))
        return [self.first] + [self.pairs[i] for i in pick]

    def reference(self, start: dict, dtype, use_tf32: bool = False) -> dict:
        """The reference over one interval from ``start`` (T, p)."""
        s, dev = self.cfg["sim"], self.device
        xc, yc = (torch.as_tensor(a, dtype=dtype, device=dev)
                  for a in ref.grid_coords(self.H, self.W, self.aspect))
        met = ref.metrics(xc, yc, self.aspect)
        w = {k: v.to(dtype) for k, v in self.weights.items()}
        scaler = ref.velocity_scaler(s["raq"], s["fkt"], s["fkp"])
        T = torch.as_tensor(start["T"], dtype=dtype, device=dev)
        p = torch.as_tensor(start["p"], dtype=dtype, device=dev)
        dt_sum = 0.0
        with torch.no_grad(), tf32(use_tf32):
            for _ in range(self.every):
                x, V = ref.fluidnet_input(T, xc, yc, s["raq"], s["fkt"],
                                          s["fkp"])
                u, v = ref_net.forward(x, w, self.m)
                u, v = u * scaler, v * scaler
                if self.tr["mode"] == "ML_PRE":
                    u, v, p = ref.pt_stokes(
                        T, V, u, v, p, s["raq"], 1.0 / (self.H - 2),
                        self.aspect / (self.W - 2), self.tr["pre_iter"])
                T, dt = ref.energy_step(u, v, T, s["raq"], met, s["cn_max"])
                dt_sum += float(dt)
        return {"T": T, "u": u, "v": v, "p": p, "dt_sum": dt_sum}

    @staticmethod
    def readings(got: dict, want: dict) -> dict:
        """The numbers compared for one interval."""
        def t(a):
            return torch.as_tensor(a, device=want["T"].device)

        scale = max(float(want["u"].abs().max()),
                    float(want["v"].abs().max()))
        uv = max(max_abs(t(got["u"]), want["u"]),
                 max_abs(t(got["v"]), want["v"])) / scale
        return {"T_max_abs": max_abs(t(got["T"]), want["T"]),
                "uv_rel_max": uv,
                "dt_rel": abs(got["dt_sum"] - want["dt_sum"])
                / want["dt_sum"]}

    def check(self, control: bool = False) -> dict:
        """Worst readings over the checked intervals: of the program, or
        with ``control`` of the reference in float32 with TF32 on, each
        against the float64 reference."""
        worst = {}
        for start, end in self._intervals():
            want = self.reference(start, torch.float64)
            got = (self.reference(start, torch.float32, use_tf32=True)
                   if control else end)
            if control:
                got = {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                       for k, v in got.items()}
            for k, v in self.readings(got, want).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst

