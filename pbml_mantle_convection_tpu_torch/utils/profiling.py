"""Profiling helpers: per-step wall times and a device trace.

Counterpart of the JAX package's ``utils/profiling.py``, which upgrades
the reference's ad-hoc ``time.time()`` deltas (multigpu.py:352-380,
advect_wi_gaia.py:585-652): :class:`StepTimer` keeps per-step wall times
(the reference's ``TS_vec``) and :func:`trace` records a
``torch.profiler`` trace (host and, on the card, device activities) as a
Chrome trace file.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import torch


class StepTimer:
    """Collects per-step wall times; drop-in for the reference's TS_vec
    pickles. With a CUDA ``device`` it synchronizes the card before each
    reading of the clock, so a step's queued kernels count in its time."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None
        return False

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    @property
    def steps_per_s(self) -> float:
        return 1.0 / self.mean if self.times else 0.0


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` over the block (CPU activities, and CUDA ones
    when a card is present), exported as a Chrome trace
    ``trace_<pid>_<time>.json`` into ``log_dir``; a no-op when
    ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
