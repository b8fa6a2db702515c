"""What the drivers share: the host clock, the device's synchronisation,
the comparison numbers and the view that per-layer metrics read."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import torch

from .trace import Trace


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()


@contextlib.contextmanager
def tf32(on: bool):
    """cuDNN convolutions and matrix products in TF32 (``on``) or in full
    float32 inside the block; the flags are put back."""
    b = torch.backends
    old = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = old


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


@dataclasses.dataclass
class Window:
    """What a measured window did: the units of work it completed
    (steps, forwards, samples), those that failed, its length on the host
    clock, and per-unit latencies where the traffic has them."""

    units: int
    failed: int
    seconds: float
    latencies_s: Optional[list] = None


@dataclasses.dataclass
class TraceView:
    """What a per-layer metric reads after a traced run.

    ``trace``: the profiled stretch's device and host events;
    ``units``: the units of work in it; ``wall_s``: its length;
    ``unit_wall_s``: the host-clock time of one unit in an unprofiled
    stretch of the same work just before (the profiler's own host work
    would lengthen a profiled one); ``counters``: what the driver counted
    or timed (CUDA events, the program's counters); ``config`` and
    ``dims``: the configuration file and the model's dimensions;
    ``peaks``: the chip's published peaks."""

    trace: Trace
    units: int
    wall_s: float
    unit_wall_s: float
    counters: dict
    config: dict
    dims: dict
    peaks: dict

    def per_unit_ms(self, span: str):
        """Device milliseconds per unit of the operations launched inside
        the benchmark's span ``span``; None where none was read."""
        s = self.trace.span_device_s(span)
        return None if s is None else 1e3 * s / self.units

    def idle_share(self) -> float:
        """1 − device time per unit / host time per unit (unprofiled), %."""
        return 100.0 * (1.0 - self.trace.device_s() / self.units
                        / self.unit_wall_s)

    def roofline(self, span: str, flops: float, nbytes: float):
        """Least time (the larger of operations over the peak rate and
        bytes over the peak bandwidth) over the measured device time per
        unit, %; None where the span's device time was not read."""
        ms = self.per_unit_ms(span)
        if not ms:
            return None
        least = max(flops / self.peaks["flops_per_s"],
                    nbytes / self.peaks["hbm_bytes_per_s"])
        return 100.0 * least / (ms / 1e3)

    def mfu(self, flops_per_unit: float) -> float:
        """The model's operations per unit over the host-clock time per
        unit (unprofiled), as a share of the peak rate, %."""
        return (100.0 * flops_per_unit / self.unit_wall_s
                / self.peaks["flops_per_s"])
