"""Times on the card in turns, for comparisons made inside one process
(``bench/parity.py``, ``bench/spec_accel.py``, ``bench/miniqmc.py``):
CUDA events around each call, the L2 flushed before each and the card
left to spin a while after the flush (:func:`flush_and_settle`), and the
order of the functions alternating from one turn to the next, so that
neither side always launches first."""
from __future__ import annotations

import statistics
from typing import Callable, List, Sequence

import torch

from repro_torch.core.context import target

ITERS = 20
#: clock cycles the card spins after each flush, about 0.5 ms at the
#: H100's 1.98 GHz boost clock: longer than a wrapper's host work, so
#: the host has queued the timed call before the card reaches its start
#: event, and the events time the card, not the host
SETTLE_CYCLES = 1_000_000


def flush_and_settle(flush: torch.Tensor) -> None:
    """Evict the L2 (``flush.zero_()``), then keep the card busy for
    SETTLE_CYCLES while the host queues what comes next."""
    flush.zero_()
    torch.cuda._sleep(SETTLE_CYCLES)


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
    :func:`flush_and_settle`, the order alternating by :func:`turn_order`;
    one warm-up call each first."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    events = [[] for _ in fns]
    for turn in range(iters):
        for i in turn_order(len(fns), turn):
            flush_and_settle(flush)
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
