"""Profiling helpers: the program's spans and a device trace.

Counterpart of the JAX package's ``utils/profiling.py``, which upgrades
the reference's ad-hoc ``time.time()`` deltas (multigpu.py:352-380,
advect_wi_gaia.py:585-652). :func:`span` marks one layer of the program
in a ``torch.profiler`` trace and costs one flag check when no profiler
runs; :func:`trace` records a ``torch.profiler`` trace (host and, on the
card, device activities) as a Chrome trace file, the program's spans in
it as ``user_annotation`` events on the device operations' clock.

The spans, ``pmc.<layer>[.<part>]``:

* ``pmc.engine.step`` (``sim/engine.py``: one coupled step and its
  records), inside it ``pmc.engine.input`` (viscosity and the network
  input), ``pmc.executor`` (``FastNewFluidNet.psi``), ``pmc.engine.energy``
  (the energy step, BCs, clip and the time update) and
  ``pmc.engine.record`` (the per-step mean T, t and dt; also the stacks
  after the steps); ``pmc.engine.snapshot`` (the fields' copy to the host
  in ``SimEngine.rollout``);
* ``pmc.kernel.layer_stack``, ``.trunk``, ``.epilogue``, ``.advect``,
  ``.slice_pool``, ``.slice_deslice``, ``.dense_attention`` (the kernel
  wrappers in ``ops/``; the last inside ``pmc.vit.attn.core``);
* ``pmc.transolver.forward``, ``pmc.transolver.norm`` (each LayerNorm of
  a block), ``pmc.transolver.mlp`` (the MLPs and the last Dense),
  ``pmc.attn.project``, ``pmc.attn.slice``, ``pmc.attn.out`` (the
  Physics-Attention's projections, core and output Dense);
* ``pmc.vit.forward``, ``pmc.vit.embed``, ``pmc.vit.norm``,
  ``pmc.vit.qkv``, ``pmc.vit.attn.core``, ``pmc.vit.attn.out``,
  ``pmc.vit.mlp``, ``pmc.vit.head`` (``models/vit.py``: the patch
  embedding, the LayerNorms, the attention's parts, the MLPs and the
  head);
* ``pmc.samvit.forward``, ``pmc.samvit.embed``, ``pmc.samvit.norm``,
  ``pmc.samvit.partition``, ``pmc.samvit.qkv``,
  ``pmc.samvit.attn.window``, ``pmc.samvit.attn.global`` (each with
  ``pmc.samvit.relpos`` inside), ``pmc.samvit.out``, ``pmc.samvit.mlp``,
  ``pmc.samvit.neck``, ``pmc.samvit.head`` (``models/samvit.py``: the
  patch embedding, the LayerNorms, the windows' pad and partition and
  their inverse, the attention's parts with the relative-position bias,
  the MLPs, the neck and the head);
* ``pmc.pt.solve`` (``StokesFn.__call__``), ``pmc.pt.check`` (the PT
  loop's residual check and its host read);
* ``pmc.train.loss``, ``pmc.train.backward``, ``pmc.train.optimizer``
  (``make_train_step``'s step).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

_profiling = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def profiling() -> bool:
    """Whether a ``torch.profiler`` is collecting: :func:`span` opens its
    ranges then, and ``SimEngine.multi_step`` runs its steps eagerly, so
    that the ranges and the calls they wrap are in the trace."""
    return _profiling()


def span(name: str):
    """A ``record_function(name)`` range while a profiler is collecting;
    else one shared no-op context (0.6 µs a ``with`` on an H100
    machine's host, against 10 µs for an idle ``record_function``)."""
    return torch.profiler.record_function(name) if _profiling() else _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` over the block (CPU activities, and CUDA ones
    when a card is present), exported as a Chrome trace
    ``trace_<pid>_<time>.json`` into ``log_dir``; a no-op when
    ``log_dir`` is None. The program's :func:`span` ranges are in it."""
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
