"""Trainer: epoch loops, init-batch mixing, LR schedule, loss log, restart.

Counterpart of the JAX package's ``train/trainer.py`` (reference: the DDP
``Trainer``, multigpu.py:37-450, and its ``load_train_objs``/``main``
plumbing, multigpu.py:453-908):

* each batch is one train step of train/train_step.py (autograd,
  ``torch.optim.Adam``), data-parallel over ``torch.distributed`` when
  ``n_devices`` > 1: every rank draws the same batch and takes its shard;
* each main batch is mixed with a small batch from the "init" dataset and
  shuffled (multigpu.py:866-884, 351-361; ``small_batch`` = 2, or 1 when
  data-parallel), with the numpy draws in the JAX Trainer's order;
* MultiStepLR(γ=0.5) is an epoch-indexed LR set in the optimizer's
  ``param_groups`` (multigpu.py:765-767);
* the per-step losses are summed on the device and read once per epoch,
  and at most ``max_in_flight`` steps are queued ahead of the host;
* the append-only ``fluidnet_uvpT.txt`` loss log keeps the reference's
  format, so restart (multigpu.py:621-670) and rollout-time model
  selection (advect_wi_gaia.py:389-416) parse it as they parse the
  reference's; epoch wall times go to ``epoch_metrics.txt`` beside it;
* checkpoints hold the optimizer state (utils/checkpoint.py), and a
  restart restores it.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.registry import ModelConfig, build_model
from ..utils.checkpoint import restore_checkpoint, save_checkpoint
from .train_step import TrainStepConfig, make_eval_step, make_train_step

LOG_HEADER = "Epoch, train loss, val loss, learning rate \n"


@dataclasses.dataclass
class TrainConfig:
    """Typed run config replacing the argparse soup (multigpu.py:911-1087)."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    epochs: int = 150
    batch_size: int = 16
    save_every: int = 1
    start_lr: float = 1e-3
    gamma: float = 0.5
    milestones: Tuple[int, ...] = (20, 40, 60, 80, 180, 120)
    l2_reg: float = 0.0
    loss_scale: bool = True
    loss_derivative: bool = False
    roll_forward: int = 1
    debug: bool = False
    # None or 1: one process; N > 1: N processes of an initialised
    # torch.distributed world of size N, one device each
    n_devices: Optional[int] = None
    seed: int = 0
    # train steps queued on the device before the epoch loop waits for
    # the oldest: the host runs ahead of the card without holding every
    # pending batch alive
    max_in_flight: int = 8
    device: str = "cuda"

    @classmethod
    def schedule_for(cls, network: str,
                     debug: bool) -> Tuple[int, Tuple[int, ...]]:
        """Epoch + milestone derivation, incl. the reference's ifluidnet
        special case (multigpu.py:1059-1070). cli/train.py reads it."""
        if network == "ifluidnet":
            return ((80, (4, 14, 24, 34, 50)) if debug
                    else (40, (2, 7, 12, 17, 25)))
        if debug:
            return 1500, (20, 200, 400, 600, 800, 1000)
        return 150, (20, 40, 60, 80, 180, 120)

    def lr_at_epoch(self, epoch: int) -> float:
        """MultiStepLR(γ) by epoch (multigpu.py:765-767)."""
        n_passed = sum(1 for m in self.milestones if epoch >= m)
        return self.start_lr * (self.gamma ** n_passed)


def parse_loss_log(path: str) -> List[dict]:
    """Parse the reference-format loss log (multigpu.py:634-658,
    advect_wi_gaia.py:401-416). Returns one dict per epoch line."""
    with open(path) as f:
        lines = f.readlines()
    out = []
    for l in lines[1:]:
        ll = l[l.index("[") + 1: l.index("],[")].split(",")
        l_r = l[l.index("],[") + 3:]
        ll_cv = l_r[: l_r.index("],")].split(",")
        out.append({
            "epoch": int(l.split(",")[0]),
            "train": [float(v) for v in ll],
            "cv": [float(v) for v in ll_cv],
            "lr": float(l.split(",")[-1]),
        })
    return out


def best_epoch_from_log(path: str, column: int = 0) -> int:
    """Rollout-time model selection: the reference appends
    ``len(loss_u) - 1`` per run dir and loads ``last_epochs[-1] - 1``
    (advect_wi_gaia.py:416, 426), the second-to-last logged epoch when no
    epoch is given."""
    entries = parse_loss_log(path)
    return max(0, len(entries) - 2)


def adam_l2(params, lr: float, l2_reg: float = 0.0) -> torch.optim.Adam:
    """Adam with torch-style L2 (the decay added to the gradient,
    multigpu.py:761-763), the hyperparameters of the JAX package's
    ``optax.adam`` (+ ``add_decayed_weights``)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=l2_reg)


class Trainer:
    """See the module docstring. Drives datasets with an
    ``.epoch_batches(rng, batch_size)`` iterator and optional ``*_init``
    datasets for batch mixing."""

    def __init__(self, cfg: TrainConfig, train_data, cv_data,
                 train_data_init=None, cv_data_init=None,
                 nn_dir: str = "./runs", restart: bool = False):
        self.cfg = cfg
        self.train_data = train_data
        self.cv_data = cv_data
        self.train_data_init = train_data_init
        self.cv_data_init = cv_data_init
        self.nn_dir = os.path.join(nn_dir, cfg.model.run_name)
        self.log_path = os.path.join(self.nn_dir, "fluidnet_uvpT.txt")
        self.device = torch.device(cfg.device)

        self.group = None
        if (cfg.n_devices or 1) > 1:
            if not (dist.is_initialized()
                    and dist.get_world_size() == cfg.n_devices):
                raise RuntimeError(
                    f"n_devices={cfg.n_devices} needs an initialised "
                    f"torch.distributed world of that size, one process "
                    f"per device")
            self.group = dist.group.WORLD
        self.rank = dist.get_rank() if self.group is not None else 0
        self.model = build_model(cfg.model, seed=cfg.seed,
                                 device=self.device)
        if self.rank == 0:
            os.makedirs(self.nn_dir, exist_ok=True)
        self.rng = np.random.default_rng(cfg.seed)

        # small-batch init mixing (multigpu.py:866-868); clamped so the
        # main stream keeps >= 1 example per batch at tiny batch sizes
        # (the reference crashes there with a 0-size DataLoader)
        self.small_batch = 0
        if train_data_init is not None:
            self.small_batch = min(1 if (cfg.n_devices or 1) > 1 else 2,
                                   max(0, cfg.batch_size - 1))

        self.optimizer = adam_l2(self.model.parameters(), cfg.start_lr,
                                 cfg.l2_reg)
        step_cfg = TrainStepConfig(
            net=cfg.model.network, p_pred=cfg.model.p_pred,
            loss_scale=cfg.loss_scale, loss_derivative=cfg.loss_derivative,
            loss_type=cfg.model.loss_type, roll_forward=cfg.roll_forward,
            drop_rate=cfg.model.drop_rate)
        # dropout masks from a generator on the device, seeded from seed + 1
        # as JAX seeds its dropout key (trainer.py:162-166); each rank its
        # own stream (JAX folds in the device index)
        self.dropout_generator = None
        if step_cfg.drop_rate > 0.0:
            self.dropout_generator = torch.Generator(
                device=self.device).manual_seed(
                    cfg.seed + 1 + (self.rank << 32))
        self._train_step = make_train_step(self.model, self.optimizer,
                                           step_cfg, self.group,
                                           self.dropout_generator)
        self._eval_step = make_eval_step(self.model, step_cfg, self.group)

        self.start_epoch = 0
        if restart:
            self._restart()

    # ------------------------------------------------------------------

    def _restart(self):
        """Re-derive the epoch from the loss log and reload the checkpoint,
        optimizer state included (the reference drops it,
        multigpu.py:621-670)."""
        entries = parse_loss_log(self.log_path)
        if not entries:
            return
        epoch = entries[-1]["epoch"]
        raw = restore_checkpoint(self._ckpt_path(epoch))
        self.model.load_state_dict(raw["model"])
        self.optimizer.load_state_dict(raw["optimizer"])
        self.start_epoch = epoch + 1
        print(f"Restarting from epoch {self.start_epoch}, "
              f"lr {self.cfg.lr_at_epoch(self.start_epoch)}")

    def _ckpt_path(self, epoch: int) -> str:
        return os.path.join(self.nn_dir, f"{epoch}_fluidnet_uvp.ckpt")

    def _shard(self, batch):
        """This rank's equal share of the batch (JAX: ``shard_batch``)."""
        if self.group is None:
            return batch
        n = dist.get_world_size(self.group)
        B = batch["x"].shape[0]
        if B % n:
            raise ValueError(f"batch of {B} does not split over {n} ranks")
        b = B // n
        return {k: v[self.rank * b:(self.rank + 1) * b]
                for k, v in batch.items()}

    def _mix_init(self, batch, init_source):
        """Concatenate a small init batch and shuffle
        (multigpu.py:351-361). The init stream cycles: the reference
        re-creates its loader iterator every batch (multigpu.py:354) and
        never exhausts it."""
        if init_source is None:
            return batch
        dataset, it = init_source
        try:
            init_batch = next(it[0])
        except StopIteration:
            it[0] = dataset.epoch_batches(self.rng, self.small_batch)
            init_batch = next(it[0])
        keys = set(batch) & set(init_batch)
        merged = {k: torch.cat((batch[k], init_batch[k]), dim=0)
                  for k in keys}
        perm = torch.as_tensor(self.rng.permutation(merged["x"].shape[0]),
                               device=merged["x"].device)
        return {k: v[perm] for k, v in merged.items()}

    def _set_lr(self, epoch: int) -> float:
        lr = self.cfg.lr_at_epoch(epoch)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        return lr

    def _loop(self, data, init_data, step, bs) -> Tuple[List[float], int]:
        """One pass of ``step`` over ``data``: the mean 6-column loss and
        the number of batches. The losses are summed on the device and
        read once; a window of CUDA events keeps at most
        ``max_in_flight`` steps queued."""
        acc, n = None, 0
        window = deque()
        init_src = None
        if init_data is not None:
            init_src = (init_data,
                        [init_data.epoch_batches(self.rng, self.small_batch)])
        for batch in data.epoch_batches(self.rng, bs):
            batch = self._shard(self._mix_init(batch, init_src))
            vec = step(batch).stack()
            acc = vec if acc is None else acc + vec
            n += 1
            if self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
                window.append(ev)
                if len(window) > self.cfg.max_in_flight:
                    window.popleft().synchronize()
        if acc is None:
            return [0.0] * 6, 0
        return (acc.to("cpu", torch.float64).numpy() / n).tolist(), n

    # ------------------------------------------------------------------

    def run_epoch(self, epoch: int) -> Tuple[List[float], List[float]]:
        """One train + cv epoch; returns the 6-column loss vectors
        (multigpu.py:340-410)."""
        bs = self.cfg.batch_size - self.small_batch
        losses, n = self._loop(self.train_data, self.train_data_init,
                               self._train_step, bs)
        if n == 0:
            raise RuntimeError(
                "epoch produced no training batches (dataset smaller than "
                "the batch size?): nothing was trained")
        losses_cv, _ = self._loop(self.cv_data, self.cv_data_init,
                                  self._eval_step, bs)
        return losses, losses_cv

    def save(self, epoch: int, losses, losses_cv):
        """Checkpoint + append the reference-format log line
        (multigpu.py:412-436). Rank 0 only."""
        if self.rank != 0:
            return
        save_checkpoint(self._ckpt_path(epoch),
                        {"model": self.model.state_dict(),
                         "optimizer": self.optimizer.state_dict(),
                         "epoch": epoch})
        if not os.path.exists(self.log_path):
            with open(self.log_path, "w") as f:
                f.write(LOG_HEADER)
        with open(self.log_path, "a") as f:
            f.write(f"{epoch},{losses[1:]},{losses_cv[1:]},"
                    f"{self.cfg.lr_at_epoch(epoch)}\n")

    def train(self, epochs: Optional[int] = None):
        epochs = epochs or self.cfg.epochs
        metrics_path = os.path.join(self.nn_dir, "epoch_metrics.txt")
        for epoch in range(self.start_epoch, epochs):
            t0 = time.time()
            self._set_lr(epoch)
            losses, losses_cv = self.run_epoch(epoch)
            wall = time.time() - t0
            if self.rank == 0:
                # a sidecar, so that fluidnet_uvpT.txt stays
                # byte-compatible with the reference's parsers
                with open(metrics_path, "a") as f:
                    f.write(f"{epoch},{wall:.3f}\n")
            if epoch % self.cfg.save_every == 0:
                self.save(epoch, losses, losses_cv)
                if self.rank == 0:
                    print(f"epoch {epoch}: train {losses[0]:.5f} "
                          f"cv {losses_cv[0]:.5f} ({wall:.1f}s)")
        return self.model
