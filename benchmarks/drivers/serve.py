"""One caller that waits for each reply (closed loop) of a field
surrogate's forward.

Traffic parameters (``benchmarks/traffic/<name>.json``): ``batch``, ``pool``
(inputs made before the window and cycled through), ``warm_forwards``,
``check_forwards`` (forwards sampled for the check, uniformly over the
window, by a reservoir drawn from the seed) and ``trace_forwards`` (the
profiled stretch).

The entry is the program's module forward under ``torch.no_grad()`` on a
(batch, H·W, 7) input: 2 coordinates (x/4, y/4) and 5 function channels
(log10 of the clipped FK viscosity / 8, raq, fkt, fkp non-dimensional, and
T). Each input is a temperature field of its own (a hot-bottom profile
with two seeded modes and seeded noise) and its own (raq, fkt, fkp) from
the training ranges. Each forward is timed from its call to its
synchronised completion. The check: the reference forward in float64 of
the sampled inputs against the program's u, v.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from ..harness.common import TraceView, Window, now, sync, tf32
from ..harness.trace import Trace, span_calls
from ..harness.weights import CHECK, INPUTS, generator, sub_seed
from ..models import transolver as family
from ..reference import physics as ref
from ..reference import transolver as ref_net

KEYS = ("batch", "pool", "warm_forwards", "check_forwards", "trace_forwards")


def make_inputs(n, H, W, seed, device, batch=1):
    """(n, batch, H·W, 7) seeded inputs, made on the device."""
    g = generator(seed, INPUTS, device)
    xc, yc = (torch.as_tensor(a, dtype=torch.float32, device=device)
              for a in ref.grid_coords(H, W, (W - 2) / (H - 2)))

    def u(*shape):
        return torch.rand(*shape, generator=g, device=device)

    k = n * batch
    ph = 2 * math.pi * u(k, 2, 1, 1)
    amp = 0.02 + 0.08 * u(k, 2, 1, 1)
    T = (1.0 - yc + amp[:, 0] * torch.sin(6.28 * xc / 4.0 * 2 + ph[:, 0])
         * torch.sin(math.pi * yc)
         + amp[:, 1] * torch.sin(6.28 * xc / 4.0 * 5 + ph[:, 1])
         * torch.sin(2 * math.pi * yc)
         + 0.01 * (u(k, H, W) - 0.5))
    T = torch.clamp(T, 0.0, 1.0)
    p = u(k, 3)
    raq = ref.RAQ_RANGE[0] + p[:, 0] * (ref.RAQ_RANGE[1] - ref.RAQ_RANGE[0])
    lft = ref.LOG10_FKT_RANGE[0] + p[:, 1] * (ref.LOG10_FKT_RANGE[1]
                                             - ref.LOG10_FKT_RANGE[0])
    lfp = ref.LOG10_FKP_RANGE[0] + p[:, 2] * (ref.LOG10_FKP_RANGE[1]
                                             - ref.LOG10_FKP_RANGE[0])
    ln10 = math.log(10.0)
    V = torch.clamp(torch.exp(-lft[:, None, None] * ln10 * T
                              + lfp[:, None, None] * ln10 * (1.0 - yc)),
                    1e-8, 1.0)
    one = torch.ones_like(T)
    chans = [one * xc / 4.0, one * yc / 4.0, ref.visc_feature(V),
             one * p[:, 0, None, None], one * p[:, 1, None, None],
             one * p[:, 2, None, None], T]
    x = torch.stack(chans, dim=-1).reshape(n, batch, H * W, 7)
    return x.contiguous()


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.H, self.W = cfg["grid"]["H"], cfg["grid"]["W"]
        self.m = family.dims(cfg)
        self.kept = []           # (forward index, input index, u, v)

    def setup(self) -> None:
        self.model, self.weights = family.build(self.cfg, self.seed,
                                                self.device)
        self.x = make_inputs(self.tr["pool"], self.H, self.W, self.seed,
                             self.device, self.tr["batch"])
        with torch.no_grad():
            for i in range(self.tr["warm_forwards"]):
                self.model(self.x[i % len(self.x)])
        sync(self.device)
        self._rng = np.random.default_rng(sub_seed(self.seed, CHECK))

    def _keep(self, i, j, out):
        """Reservoir of ``check_forwards`` forwards, uniform over the
        window's forwards."""
        n = self.tr["check_forwards"]
        if i < n:
            self.kept.append((i, j, out[0], out[1]))
        else:
            r = int(self._rng.integers(0, i + 1))
            if r < n:
                self.kept[r] = (i, j, out[0], out[1])

    def window(self, seconds: float) -> Window:
        lat, n, pool = [], 0, len(self.x)
        t0 = now()
        with torch.no_grad():
            while now() - t0 < seconds:
                j = n % pool
                t1 = now()
                out = self.model(self.x[j])
                sync(self.device)
                lat.append(now() - t1)
                self._keep(n, j, out)
                n += 1
        elapsed = now() - t0
        failed = sum(1 for _, _, u, v in self.kept
                     if not (torch.isfinite(u).all()
                             and torch.isfinite(v).all()))
        return Window(units=n, failed=failed, seconds=elapsed,
                      latencies_s=lat)

    def end_to_end(self, w: Window) -> dict:
        """The rate, and the tail of every forward of the window."""
        q = np.percentile(np.asarray(w.latencies_s), 95)
        return {"forwards_per_s": w.units / w.seconds,
                "forward_ms_p95": 1e3 * float(q)}

    def traced(self, seconds: float, trace_path) -> TraceView:
        from torch.profiler import ProfilerActivity, profile
        from pbml_mantle_convection_tpu_torch.ops import slice_attention

        n, pool = self.tr["trace_forwards"], len(self.x)
        w = self.window(min(seconds, 5.0))
        unit_wall = w.seconds / w.units
        counters = {}
        spans = [(slice_attention, "slice_pool", "bench.slice_pool"),
                 (slice_attention, "slice_deslice", "bench.slice_deslice")]
        for i in range(self.m["n_layers"]):
            attn = getattr(self.model, f"blocks_{i}").Attn
            spans.append((attn, "project", "bench.projection"))
        with contextlib.ExitStack() as stack:
            for owner, attr, name in spans:
                stack.enter_context(span_calls(owner, attr, name))
            with torch.no_grad(), profile(
                    activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
                t1 = now()
                for k in range(n):
                    out = self.model(self.x[k % pool])
                    sync(self.device)
                    self._keep(w.units + k, k % pool, out)
                wall = now() - t1
        return TraceView(Trace.from_profiler(prof, trace_path), n, wall,
                         unit_wall, counters, self.cfg, self.m,
                         self.cfg["peaks"])

    def release(self) -> None:
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        """Worst max|Δ| / max|reference| of u and v over the sampled
        forwards: of the program, or with ``control`` of the reference in
        float32 with TF32 on, against the float64 reference."""
        w64 = {k: v.double() for k, v in self.weights.items()}
        w32 = {k: v.float() for k, v in self.weights.items()}
        worst, l2, where = 0.0, 0.0, []
        with torch.no_grad():
            for _, j, u, v in self.kept:
                ur, vr = ref_net.forward(self.x[j].double(), w64, self.m)
                if control:
                    with tf32(True):
                        u, v = ref_net.forward(self.x[j].float(), w32,
                                               self.m)
                scale = max(float(ur.abs().max()), float(vr.abs().max()))
                du, dv = u.double() - ur, v.double() - vr
                worst = max(worst, max(float(du.abs().max()),
                                       float(dv.abs().max())) / scale)
                l2 = max(l2, float(torch.sqrt(
                    (du ** 2 + dv ** 2).sum() / (ur ** 2 + vr ** 2).sum())))
                k = int(du.abs().argmax())
                where.append([k // du.shape[-1], k % du.shape[-1],
                              float(du.abs().max()) / scale])
        self.look = {"uv_rel_l2": l2, "where_u": where}
        return {"uv_rel_max": worst}
