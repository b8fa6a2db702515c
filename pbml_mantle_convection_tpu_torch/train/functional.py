"""Functional single-epoch loop.

Counterpart of the JAX package's ``train/functional.py`` (reference:
``one_epoch_AD``, pycold-checkpoint.py:85-233, of the ViT/Transolver
notebooks): one epoch over a dataset with a prebuilt train or eval step;
no Trainer object, no checkpoint. The steps of train/train_step.py close
over the model and its optimizer, so the parameters are updated in place.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def one_epoch(dataset, rng: np.random.Generator, batch_size: int,
              train_step=None, eval_step=None) -> List[float]:
    """Run one epoch. With ``train_step`` the parameters are updated; with
    only ``eval_step`` the loop only evaluates (the reference's
    ``is_train`` switch). Returns the mean 6-column loss. The per-batch
    losses are summed on their device and read once, at the end."""
    step = train_step if train_step is not None else eval_step
    acc, n = None, 0
    for batch in dataset.epoch_batches(rng, batch_size):
        vec = step(batch).stack()
        acc = vec if acc is None else acc + vec
        n += 1
    if acc is None:
        return [0.0] * 6
    return (acc.to("cpu", torch.float64).numpy() / n).tolist()
