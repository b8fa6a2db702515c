"""Depth-k thread prefetcher for host-resident input pipelines.

Counterpart of the JAX package's ``data/prefetch.py``. The host-resident
dataset mode (data/dataset.py) gathers each batch's rows from a
NumPy/memmap store and copies them to the card; both are host work the
card would otherwise wait on. Wrapping the per-batch constructor in
:func:`prefetch_iter` runs it on one worker thread up to ``depth``
batches ahead, so the gather and copy of batch k+1 overlap the train
step of batch k (the reference's ``__getitem__`` + DataLoader workers,
datasetio.py:595-654, multigpu.py:772-779).

One worker thread keeps the batches in order; the copy to the card is
synchronous in that thread (data/dataset.py), so no host buffer is
reused while a copy from it is in flight.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, TypeVar

T = TypeVar("T")


def prefetch_iter(make: Callable[[int], T], n: int,
                  depth: int = 2) -> Iterator[T]:
    """Yield ``make(0), …, make(n-1)`` with up to ``depth`` results
    computed ahead on a worker thread.

    ``make`` runs on the worker only: it must not mutate state the
    consumer reads concurrently (the datasets draw every permutation and
    seed of an epoch up front for this reason). ``depth <= 0`` is a
    plain synchronous loop.
    """
    if n <= 0:
        return
    if depth <= 0:
        for i in range(n):
            yield make(i)
        return
    with ThreadPoolExecutor(max_workers=1) as ex:
        futs = deque(ex.submit(make, i) for i in range(min(depth, n)))
        nxt = len(futs)
        while futs:
            out = futs.popleft().result()
            if nxt < n:
                futs.append(ex.submit(make, nxt))
                nxt += 1
            yield out
