"""What the port's four study tools share (``tools/torch_port_speedup_study.py``,
``torch_port_reference_scale_study.py``, ``torch_port_interleave_fidelity.py``,
``torch_port_hbm_scale_study.py``): the device they run on, their output
directory and the launches of the kernel wrappers.

Every tool runs on the card unless ``--device cpu`` is given; with no CUDA
device and no such flag it exits with an error. A tool writes its tables
under ``--out-dir`` (default ``build/studies/``, which git ignores), never
at the repository root.
"""

from __future__ import annotations

import os
import sys

import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from bench_torch import counters  # noqa: E402

OUT_DIR = os.path.join(REPO, "build", "studies")


def study_device(name: str, device: str) -> torch.device:
    """``--device`` as a torch device; exits when it names the card and
    there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{name}: no CUDA device (pass --device cpu to run "
                         f"on the CPU)")
    return dev


def sync(device: torch.device) -> None:
    """Wait for the card (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launches() -> dict:
    """Each kernel wrapper's launch count so far, by name (they count on
    the card only: on the CPU every wrapper runs its plain version)."""
    return {k: fn.launches for k, fn in counters().items()}


def launches_per_step(before: dict, n_steps: int) -> dict:
    """Launches of each kernel wrapper since ``before``, per step."""
    now = launches()
    return {k: (now[k] - before[k]) / max(n_steps, 1) for k in now}
