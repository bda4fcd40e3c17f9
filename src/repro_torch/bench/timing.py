"""Times on the card in turns, for comparisons made inside one process
(``bench/parity.py``, ``bench/spec_accel.py``, ``bench/miniqmc.py``):
CUDA events around each call, the L2 flushed before each, and the order
of the functions alternating from one turn to the next, so that neither
side always launches first."""
from __future__ import annotations

import statistics
from typing import Callable, List, Sequence

import torch

from repro_torch.core.context import target

ITERS = 20


def under(arch: str, fn: Callable) -> Callable:
    """``fn`` called inside ``target(arch)``."""
    def call():
        with target(arch):
            return fn()
    return call


def turn_order(n: int, turn: int) -> List[int]:
    """The order of ``n`` functions in ``turn``: as given in even
    turns, reversed in odd ones."""
    order = list(range(n))
    return order if turn % 2 == 0 else order[::-1]


def times_in_turns(fns: Sequence[Callable], flush: torch.Tensor,
                   iters: int = ITERS) -> List[List[float]]:
    """Every ms of each of ``fns`` over ``iters`` turns, each call after
    an L2 flush (``flush.zero_()``), the order alternating by
    :func:`turn_order`; one warm-up call each first."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    events = [[] for _ in fns]
    for turn in range(iters):
        for i in turn_order(len(fns), turn):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fns[i]()
            b.record()
            events[i].append((a, b))
    torch.cuda.synchronize()
    return [[a.elapsed_time(b) for a, b in ev] for ev in events]


def time_in_turns(fns: Sequence[Callable], flush: torch.Tensor,
                  iters: int = ITERS) -> List[float]:
    """The median ms of each of ``fns`` by :func:`times_in_turns`."""
    return [statistics.median(ms)
            for ms in times_in_turns(fns, flush, iters)]
