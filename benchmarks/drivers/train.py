"""The trainer's inner loop: train steps back to back over batches of a
device-resident snapshot store.

Traffic parameters (``benchmarks/traffic/<name>.json``): ``batch``,
``sims`` and ``snapshots`` (the store: simulations of their own
(raq, fkt, fkp) from the training ranges, snapshots each), ``lr``,
``max_in_flight`` (steps queued ahead of the host, as the trainer keeps
them), ``warm_steps`` (steps after the three checked ones, before the
window), ``phase_steps`` and ``trace_steps`` (the traced run's CUDA-event
and profiled stretches).

The store's rows are made from the seed (the synthetic convection cells
of the program's ``data/synthetic.py``, drawn in bulk) and handed to the
program's ``SnapshotDataset`` (device-resident), whose shuffled epochs
feed ``make_train_step`` with the training CLI's ``TrainStepConfig``
(curl loss, loss scaling, the derivative term) and ``adam_l2``. Set-up
builds that one step object and drives it through its first three steps,
on rows that all differ; the window continues with the same object. The
check: the reference assembles those three batches again from the raw
rows and follows the three steps in float64; it compares the first
step's loss, the first gradient as Adam holds it after one step (the
worst leaf and the median one) and the worst leaf's change over the
three steps.
"""

from __future__ import annotations

import collections
import copy

import numpy as np
import torch

from ..harness.common import TraceView, Window, now, sync, tf32
from ..harness.trace import Trace
from ..harness.weights import INPUTS, TRAFFIC, sub_seed
from ..models import newfluidnet as family
from ..reference import physics as ref
from ..reference import train as ref_train

CHECKED_STEPS = 3
KEYS = ("batch", "sims", "snapshots", "lr", "max_in_flight", "warm_steps",
        "phase_steps", "trace_steps")


def make_store_rows(sims, snaps, H, W, seed):
    """Raw rows {T, u, v (N, H, W) float32; paras (N, 3); steps (N,);
    times (N,)} of evolving convection cells, in bulk from the seed."""
    rng = np.random.default_rng(sub_seed(seed, INPUTS))
    aspect = (W - 2) / (H - 2)
    xc, yc = ref.grid_coords(H, W, aspect)
    raq = rng.uniform(*ref.RAQ_RANGE, sims)
    fkt = 10.0 ** rng.uniform(*ref.LOG10_FKT_RANGE, sims)
    fkp = 10.0 ** rng.uniform(*ref.LOG10_FKP_RANGE, sims)
    phase = rng.uniform(0, 2 * np.pi, sims)[:, None, None, None]
    k = rng.integers(1, 4, sims)[:, None, None, None]
    t = 1e-4 * np.cumsum(1.0 + 0.1 * rng.random((sims, snaps)), axis=1)
    tc = t[:, :, None, None]
    amp = 1.0 - np.exp(-5.0 * tc / 1e-3)
    scale = np.array([ref.velocity_scaler(*p) for p in zip(raq, fkt, fkp)])
    arg = k * np.pi * xc / aspect + phase
    a = np.sin(np.pi * yc) * np.sin(arg + 0.5 * tc / 1e-4)
    s = scale[:, None, None, None]
    u = np.pi * np.cos(np.pi * yc) * np.sin(arg) * amp * s
    v = -(k * np.pi / aspect) * np.sin(np.pi * yc) * np.cos(arg) * amp * s
    T = np.clip(1.0 - yc + 0.1 * amp * a
                + 0.01 * rng.standard_normal((sims, snaps, H, W)), 0.0, 1.0)
    T[..., 0, :], T[..., -1, :] = 1.0, 0.0
    n = sims * snaps
    shape = (n, H, W)
    return {"T": T.reshape(shape).astype(np.float32),
            "u": np.broadcast_to(u, T.shape).reshape(shape).astype(
                np.float32),
            "v": np.broadcast_to(v, T.shape).reshape(shape).astype(
                np.float32),
            "paras": np.repeat(np.stack([raq, fkt, fkp], 1), snaps, 0),
            "steps": np.tile(np.arange(1, snaps + 1), sims),
            "times": t.reshape(-1), "sims": np.repeat(np.arange(sims), snaps),
            "xc": xc, "yc": yc}


def param_norms(d: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in d.items()}


def gaps(got: dict, want: dict, leaves=None) -> dict:
    """Each leaf's |‖got‖ − ‖want‖| / ‖want‖ (the reference's norm of
    that leaf)."""
    keys = list(want) if leaves is None else leaves
    return {k: abs(got[k] - want[k]) / want[k] for k in keys}


def _top(got, want, leaves=None, n=3):
    """The ``n`` leaves with the widest gaps, for a look at the cause."""
    return dict(sorted(gaps(got, want, leaves).items(),
                       key=lambda kv: -kv[1])[:n])


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.H, self.W = cfg["grid"]["H"], cfg["grid"]["W"]
        self.m = family.dims(cfg)
        self.B = traffic["batch"]

    def setup(self) -> None:
        from pbml_mantle_convection_tpu_torch.data.dataset import (
            SnapshotDataset, SnapshotStore)
        from pbml_mantle_convection_tpu_torch.train.train_step import (
            TrainStepConfig, make_train_step)
        from pbml_mantle_convection_tpu_torch.train.trainer import adam_l2

        self.model, self.weights = family.build(self.cfg, self.seed,
                                                self.device)
        r = make_store_rows(self.tr["sims"], self.tr["snapshots"], self.H,
                            self.W, self.seed)
        self.rows = r
        store = SnapshotStore(T=r["T"], u=r["u"], v=r["v"], p=None,
                              paras=r["paras"], step_index=r["steps"],
                              sim_id=r["sims"], times=r["times"],
                              xc=r["xc"], yc=r["yc"])
        self.ds = SnapshotDataset(store, device=self.device,
                                  host_resident=False)
        self.step_cfg = TrainStepConfig(
            net="newfluidnet", p_pred=False, loss_scale=True,
            loss_derivative=True, loss_type="curl")
        self.opt = adam_l2(self.model.parameters(), self.tr["lr"])
        self.step = make_train_step(self.model, self.opt, self.step_cfg)
        self.feed = self._feed(np.random.default_rng(
            sub_seed(self.seed, TRAFFIC)))
        self.checked_rows, losses = [], []
        for k in range(CHECKED_STEPS):
            idx, batch = next(self.feed)
            self.checked_rows.append(idx)
            losses.append(self.step(batch).total)
            if k == 0:
                # the first gradient as Adam holds it: m₁ = (1 − β₁)·g
                b1 = self.opt.param_groups[0]["betas"][0]
                self.grad1 = {
                    k: (self.opt.state[p]["exp_avg"] / (1 - b1)).clone()
                    if "exp_avg" in self.opt.state.get(p, {})
                    else torch.zeros_like(p)
                    for k, p in self.model.named_parameters()}
        self.after = {k: p.detach().clone()
                      for k, p in self.model.named_parameters()}
        self.losses = [float(x) for x in losses]
        for _ in range(self.tr["warm_steps"]):
            self.step(next(self.feed)[1])
        sync(self.device)

    def _feed(self, rng):
        """(rows, batch) of the dataset's shuffled epochs, one after
        another; the rows are the permutation that the epoch draws."""
        n = len(self.ds)
        while True:
            perm = copy.deepcopy(rng).permutation(n)
            for i, batch in enumerate(self.ds.epoch_batches(rng, self.B)):
                yield perm[i * self.B:(i + 1) * self.B], batch

    def _steps(self, until):
        """Train steps until ``until()`` says stop; at most
        ``max_in_flight`` queued ahead of the host. (steps, loss sum)."""
        window = collections.deque()
        acc, n = None, 0
        while not until(n):
            br = self.step(next(self.feed)[1])
            acc = br.total if acc is None else acc + br.total
            n += 1
            if self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
                window.append(ev)
                if len(window) > self.tr["max_in_flight"]:
                    window.popleft().synchronize()
        return n, acc

    def window(self, seconds: float) -> Window:
        t0 = now()
        n, acc = self._steps(lambda n: now() - t0 >= seconds)
        sync(self.device)
        elapsed = now() - t0
        failed = 0 if bool(torch.isfinite(acc)) else n * self.B
        return Window(units=n * self.B, failed=failed, seconds=elapsed)

    def end_to_end(self, w: Window) -> dict:
        return {"train_samples_per_s": w.units / w.seconds}

    def traced(self, seconds: float, trace_path) -> TraceView:
        from torch.profiler import ProfilerActivity, profile
        from pbml_mantle_convection_tpu_torch.models.layers import \
            float32_convs
        from pbml_mantle_convection_tpu_torch.train.train_step import \
            make_loss_fn

        w = self.window(min(seconds, 5.0))
        unit_wall = w.seconds / (w.units / self.B)
        # forward + loss, backward and Adam by CUDA events, each step's
        # calls in the order of the program's step
        loss_fn = make_loss_fn(self.model, self.step_cfg)
        params = [p for p in self.model.parameters() if p.requires_grad]
        phases = np.zeros(3)
        n_ph = self.tr["phase_steps"]
        for _ in range(n_ph):
            batch = next(self.feed)[1]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            with float32_convs(batch["x"]):
                self.opt.zero_grad(set_to_none=False)
                ev[0].record()
                loss = loss_fn(batch).total
                ev[1].record()
                loss.backward()
                for q in params:
                    if q.grad is None:
                        q.grad = torch.zeros_like(q)
                ev[2].record()
                self.opt.step()
                ev[3].record()
            sync(self.device)
            phases += [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
        phases /= n_ph
        counters = {"forward_loss_ms": phases[0], "backward_ms": phases[1],
                    "adam_ms": phases[2], "batch": self.B}
        n = self.tr["trace_steps"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = now()
            self._steps(lambda k: k >= n)
            sync(self.device)
            wall = now() - t1
        return TraceView(Trace.from_profiler(prof, trace_path), n, wall,
                         unit_wall, counters, self.cfg, self.m,
                         self.cfg["peaks"])

    def release(self) -> None:
        del self.model, self.opt, self.step, self.ds, self.feed
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_steps(self, dtype, use_tf32: bool = False):
        """The reference's three steps on the checked rows."""
        dev = self.device
        xc, yc = (torch.as_tensor(self.rows[k], dtype=dtype, device=dev)
                  for k in ("xc", "yc"))
        batches = []
        for idx in self.checked_rows:
            rows = {k: torch.as_tensor(self.rows[k][idx], dtype=dtype,
                                       device=dev)
                    for k in ("T", "u", "v")}
            rows["paras"] = self.rows["paras"][idx]
            batches.append(ref_train.batch(rows, xc, yc))
        with tf32(use_tf32):
            return ref_train.train(self.weights, batches, self.m,
                                   self.tr["lr"], dtype)

    def check(self, control: bool = False) -> dict:
        """The numbers compared, of the program or with ``control`` of the
        reference in float32 with TF32 on, against the float64 reference:
        the first step's loss, the worst and the median leaf's gap of
        first-gradient norms, and the worst leaf's gap of change norms
        over the three steps, each gap relative to the reference's norm
        of that leaf (``self.look`` keeps the later steps' losses and the
        worst leaves, for a look at the cause)."""
        losses, g1, after = self.reference_steps(torch.float64)
        if control:
            c_losses, c_g1, c_after = self.reference_steps(torch.float32,
                                                           use_tf32=True)
        else:
            c_losses, c_g1, c_after = self.losses, self.grad1, self.after
        g_ref, g_got = param_norms(g1), param_norms(c_g1)
        med_g = float(np.median(list(g_ref.values())))
        # leaves whose gradient is nought to rounding (a key's bias under a
        # mean subtraction) move under Adam by round-off alone: left out,
        # by the reference's gradient under a thousandth of the median
        # leaf's
        moving = [k for k, g in g_ref.items() if g >= 1e-3 * med_g]
        d_ref = param_norms({k: after[k] - self.weights[k].double()
                             for k in after})
        d_got = param_norms({k: c_after[k].double()
                             - self.weights[k].double() for k in after})
        grad = gaps(g_got, g_ref, moving)
        change = gaps(d_got, d_ref, moving)
        self.look = {
            "loss_rel": [abs(a - b) / abs(b)
                         for a, b in zip(c_losses, losses)],
            "grad_gap_worst": _top(g_got, g_ref, moving),
            "change_gap_worst": _top(d_got, d_ref, moving),
            "change_gap_median": float(np.median(list(change.values()))),
            "left_out": sorted(set(g_ref) - set(moving))}
        return {
            "loss_step1_rel": abs(c_losses[0] - losses[0]) / abs(losses[0]),
            "grad_norm_gap_worst": max(grad.values()),
            "grad_norm_gap_median": float(np.median(list(grad.values()))),
            "change_norm_gap": max(change.values())}
