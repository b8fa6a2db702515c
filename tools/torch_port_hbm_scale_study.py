"""HBM-scale training rehearsal on the port: one epoch of the flagship
over a reference-scale snapshot store that does not fit the card, timed
end to end, input pipeline included.

The port's counterpart of ``tools/hbm_scale_study.py``, with its flags,
defaults and phases. It generates (once) a synthetic snapshot store on
disk (``data/synthetic.py::synthetic_store_memmap``): by default 96 sims
× 700 snapshots of 128×506, ~52 GB of float32 fields, the footprint of
the reference's training split (datasetio.py:33,96) and more than the
device-store limit of ``data/dataset.py`` (32 GiB by default, on an 80 GB
card), so the dataset stays host-resident (``SnapshotDataset(...,
host_resident=True)``: a worker thread gathers each batch from the memmap
and copies it to the card). Then it trains the flagship NewFluidNet
(levels 5, c_h 16, repeats 6, k 5, learned padding, curl head) through
``Trainer.run_epoch``/``save`` and reports:

* the store's generation or reopening time and its size;
* the input pipeline alone (``epoch_batches``, waiting for each batch on
  the card): ms per batch and GB/s;
* the epoch's wall time end to end and ms per train step, the second
  epoch restarted from the first one's checkpoint;
* the card's peak allocated memory in each epoch (the store never
  enters it).

Each phase (``probe``, ``epoch0``, ``epoch1``) runs in its own
subprocess, so that the second epoch measures the warm page cache of the
store with a fresh process (``--phase all``); ``--phase inline`` runs
them in one process. ``--steps_cap N`` limits each measured epoch to its
first N batches and extrapolates linearly to the full epoch (the rate is
flat); 0 runs the whole epoch.

The store lives at ``--path`` (default ``build/hbm_store``), the
Trainer's checkpoints and loss log under ``--run-dir`` (default
``build/studies/hbm_run``); the JSON result is printed and, for ``all``
and ``inline``, written to ``torch_port_hbm.json`` under ``--out-dir``
(default ``build/studies/``), with the card's name and power limit::

    python3 tools/torch_port_hbm_scale_study.py --sims 96 --snaps 700 \\
        --steps_cap 200
    python3 tools/torch_port_hbm_scale_study.py --device cpu --sims 2 \\
        --snaps 6 --batch 2 --phase inline --pipeline_steps 2

It runs on the card; ``--device cpu`` runs it on the CPU.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_port_study_util import (  # noqa: E402
    OUT_DIR, REPO, study_device, sync)
from pbml_mantle_convection_tpu_torch.utils.card import card_info  # noqa: E402


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", default=os.path.join(REPO, "build",
                                                   "hbm_store"))
    ap.add_argument("--sims", type=int, default=96)
    ap.add_argument("--snaps", type=int, default=700)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps_cap", type=int, default=0)
    ap.add_argument("--pipeline_steps", type=int, default=120,
                    help="batches for the input-pipeline-only probe")
    ap.add_argument("--phase", default="all",
                    choices=["all", "probe", "epoch0", "epoch1", "inline"])
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--run-dir", default=os.path.join(OUT_DIR, "hbm_run"))
    ap.add_argument("--out-dir", default=OUT_DIR)
    return ap


def open_store(args):
    import numpy as np
    from pbml_mantle_convection_tpu_torch.constants import SimParams
    from pbml_mantle_convection_tpu_torch.data.synthetic import (
        synthetic_store_memmap)
    from pbml_mantle_convection_tpu_torch.sim.grid import Grid

    rng = np.random.default_rng(0)
    paras = [SimParams(float(r), float(10.0 ** e), float(p))
             for r, e, p in zip(rng.uniform(1.0, 9.0, args.sims),
                                rng.uniform(6.0, 9.0, args.sims),
                                rng.uniform(1.0, 100.0, args.sims))]
    t0 = time.perf_counter()
    store = synthetic_store_memmap(
        args.path, grid=Grid(), params_list=paras,
        n_snapshots_per_sim=args.snaps)
    return store, paras, time.perf_counter() - t0


class CappedDS:
    """View of a dataset truncated to ``cap`` batches of ``batch`` per
    epoch (0: the whole epoch)."""

    def __init__(self, inner, cap, batch):
        self.inner, self.cap, self.batch = inner, cap, batch

    def __len__(self):
        if not self.cap:
            return len(self.inner)
        return min(len(self.inner), self.cap * self.batch)

    def epoch_batches(self, rng, bs, **kw):
        for i, b in enumerate(self.inner.epoch_batches(rng, bs, **kw)):
            if self.cap and i >= self.cap:
                break
            yield b


def make_trainer(args, store, paras, restart, device, init_weights=None):
    from pbml_mantle_convection_tpu_torch.data.dataset import (
        SnapshotDataset, _device_store_limit)
    from pbml_mantle_convection_tpu_torch.data.synthetic import (
        synthetic_store)
    from pbml_mantle_convection_tpu_torch.models.registry import ModelConfig
    from pbml_mantle_convection_tpu_torch.sim.grid import Grid
    from pbml_mantle_convection_tpu_torch.train.trainer import (TrainConfig,
                                                                Trainer)

    ds = SnapshotDataset(store, noise=1e-5, host_resident=True,
                         device=device)
    # at reference scale the automatic choice must be the host
    if args.sims >= 48 and not store.field_nbytes(4) > _device_store_limit():
        raise RuntimeError(f"a {store.field_nbytes(4) / 1e9:.1f} GB store "
                           f"fits the device-store limit "
                           f"{_device_store_limit() / 1e9:.1f} GB")

    # a small device-resident cv set, so that the measurement isolates
    # the train stream
    cv_store = synthetic_store(grid=Grid(), params_list=paras[:2],
                               n_snapshots=4)
    cv = SnapshotDataset(cv_store, host_resident=False, device=device)

    mc = ModelConfig(network="newfluidnet", levels=5, c_h=16, repeats=6,
                     kernel=5, r_p="learned", loss_type="curl")
    cfg = TrainConfig(model=mc, epochs=2, batch_size=args.batch,
                      milestones=(20,), debug=False, device=str(device))
    train_ds = (CappedDS(ds, args.steps_cap, args.batch) if args.steps_cap
                else ds)
    trainer = Trainer(cfg, train_ds, cv, nn_dir=args.run_dir,
                      restart=restart)
    if init_weights is not None and not restart:
        trainer.model.load_state_dict(init_weights)
    n_steps_full = len(ds) // args.batch
    n_steps = args.steps_cap or n_steps_full
    return trainer, n_steps, n_steps_full


def phase_probe(args, device):
    import numpy as np
    from pbml_mantle_convection_tpu_torch.data.dataset import (
        SnapshotDataset, _device_store_limit)

    store, _, open_s = open_store(args)
    out = {"backend": device.type, "store_open_s": round(open_s, 2),
           "store_snapshots": len(store),
           "store_gb": round(store.field_nbytes(4) / 1e9, 2),
           "store_bytes": store.field_nbytes(4),
           "auto_would_pick_host": bool(
               store.field_nbytes(4) > _device_store_limit())}
    print(f"store: {len(store)} snapshots, {out['store_gb']} GB, "
          f"open/gen {out['store_open_s']}s", flush=True)

    ds = SnapshotDataset(store, noise=1e-5, host_resident=True,
                         device=device)
    it = ds.epoch_batches(np.random.default_rng(1), args.batch)
    next(it)
    sync(device)
    t0 = time.perf_counter()
    n = 0
    for b in it:
        sync(device)
        n += 1
        if n >= args.pipeline_steps:
            break
    it.close()
    dt = (time.perf_counter() - t0) / max(n, 1)
    out["pipeline_batches"] = n
    out["pipeline_ms_per_batch"] = round(dt * 1e3, 3)
    batch_mb = args.batch * 128 * 506 * 4 * 3 / 1e6
    out["pipeline_gbps"] = round(batch_mb / 1e3 / dt, 3)
    print(f"input pipeline alone: {dt * 1e3:.2f} ms/batch "
          f"({out['pipeline_gbps']} GB/s effective)", flush=True)
    return out


def phase_epoch(args, k: int, device, init_weights=None):
    import torch

    store, paras, _ = open_store(args)
    trainer, n_steps, n_steps_full = make_trainer(
        args, store, paras, restart=(k > 0), device=device,
        init_weights=init_weights)
    out = {"steps_per_epoch_full": n_steps_full, "steps_measured": n_steps,
           f"start_epoch{k}": trainer.start_epoch}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    losses, losses_cv = trainer.run_epoch(k)
    sync(device)
    e = time.perf_counter() - t0
    trainer.save(k, losses, losses_cv)
    out[f"epoch{k}_s"] = round(e, 2)
    out[f"loss_epoch{k}"] = round(losses[0], 6)
    out[f"losses_epoch{k}"] = losses
    out[f"losses_cv_epoch{k}"] = losses_cv
    if device.type == "cuda":
        out[f"peak_device_gb_epoch{k}"] = round(
            torch.cuda.max_memory_allocated(device) / 1e9, 3)
    if k > 0:
        out["e2e_ms_per_step"] = round(e / n_steps * 1e3, 3)
        out["epoch_extrapolated_s"] = round(e / n_steps * n_steps_full, 1)
    print(f"epoch {k}: {e:.1f}s "
          f"({e / n_steps * 1e3:.1f} ms/step end-to-end), "
          f"loss {losses[0]:.5f}", flush=True)
    return out


def run_child(args, phase):
    """Run one phase in a subprocess; return its JSON result line."""
    cmd = [sys.executable, os.path.abspath(__file__), "--phase", phase,
           "--path", args.path, "--sims", str(args.sims),
           "--snaps", str(args.snaps), "--batch", str(args.batch),
           "--steps_cap", str(args.steps_cap),
           "--pipeline_steps", str(args.pipeline_steps),
           "--device", args.device, "--run-dir", args.run_dir,
           "--out-dir", args.out_dir]
    r = subprocess.run(cmd, capture_output=True, text=True)
    sys.stderr.write(r.stderr[-2000:] if r.stderr else "")
    lines = [l for l in r.stdout.splitlines() if l.startswith("{")]
    for l in r.stdout.splitlines():
        if not l.startswith("{"):
            print(l, flush=True)
    if r.returncode != 0 or not lines:
        raise RuntimeError(f"phase {phase} failed (rc={r.returncode}):\n"
                           f"{r.stdout[-2000:]}")
    return json.loads(lines[-1])


def write(args, out):
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "torch_port_hbm.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


def main(argv=None, init_weights=None):
    """Runs ``--phase``; returns its JSON record. ``init_weights``: the
    flagship's initial state dict for epoch 0 (default: the Trainer's
    seeded torch init)."""
    args = build_argparser().parse_args(argv)
    device = study_device("torch_port_hbm_scale_study", args.device)

    if args.phase == "probe":
        out = phase_probe(args, device)
        print(json.dumps(out))
        return out
    if args.phase in ("epoch0", "epoch1"):
        out = phase_epoch(args, int(args.phase[-1]), device, init_weights)
        print(json.dumps(out))
        return out

    out = {"sims": args.sims, "snaps": args.snaps, "batch": args.batch,
           "steps_cap": args.steps_cap, **card_info(device)}
    if args.phase == "inline":
        out["isolation"] = "inline"
        out.update(phase_probe(args, device))
        out.update(phase_epoch(args, 0, device, init_weights))
        out.update(phase_epoch(args, 1, device))
        write(args, out)
        return out

    # --phase all: one subprocess per phase, from a fresh run directory
    shutil.rmtree(args.run_dir, ignore_errors=True)
    out["isolation"] = "subprocess-per-epoch"
    out.update(run_child(args, "probe"))
    out.update(run_child(args, "epoch0"))
    out.update(run_child(args, "epoch1"))
    write(args, out)
    return out


if __name__ == "__main__":
    main()
