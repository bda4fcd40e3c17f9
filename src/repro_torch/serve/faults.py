"""Deterministic fault injection for the serving engine
(``repro.serve.faults``): a seeded per-step :class:`FaultPlan`, the
NaN write of a ``kv_corrupt`` fault (:func:`corrupt_page`) and the page
scan that tells it from a transient one (:func:`nonfinite_pages`).

Fault classes (:data:`FAULT_KINDS`):

  kv_corrupt   NaN over one of the target slot's live pool pages: the V
               pool, or the V scale pool of a quantized one (an int8
               pool cannot hold NaN).  The step's NaN/Inf logits
               sentinel sees it; the engine scans the slot's pages,
               quarantines the bad ones and requeues the request.
  nan_logits   The step overwrites the target slot's logits row with
               NaN.  The sentinel sees it, the scan comes back clean,
               and the slot requeues.
  alloc_fail   The next page allocation of the decode loop fails as if
               the pool were dry with nothing to preempt (sticky until
               a slot asks for a page, so a scheduled one always bites).
  stall        The step's host side sleeps ``stall_s`` between dispatch
               and its copy, so the engine's watchdog sees the step
               blow its deadline and discards it.

Why V and not K: the decode kernels take the row maximum with a
NaN-propagating max, so a NaN score makes m NaN, every p and l 0, and
the row 0 under the ``l == 0`` guard: silent, and no sentinel could see
it.  NaN in V (or a V scale) flows through ``p @ v`` into exactly the
owning slot's logits.

The plan draws with ``np.random.default_rng(seed)`` in the reference's
order, so one seed gives one schedule in both packages.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serve.paging import raw_bytes

#: The injectable fault classes, in the order the recovery counters
#: report them.
FAULT_KINDS = ("kv_corrupt", "nan_logits", "alloc_fail", "stall")


class FaultPlan:
    """A seeded, deterministic per-step fault schedule.

    ``rate``: each step draws at most one random fault with this
    probability (kind uniform over FAULT_KINDS, slot uniform over the
    step's active slots), memoized per step.  :meth:`at`: explicit
    ``(step, kind, slot)`` entries.  The engine queries
    :meth:`faults_for` once per step and applies the result."""

    def __init__(self, rate: float = 0.0, seed: int = 0,
                 stall_s: float = 0.05):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"fault rate must be in [0, 1], got {rate}")
        self.rate = float(rate)
        self.seed = int(seed)
        self.stall_s = float(stall_s)
        self._rng = np.random.default_rng(seed)
        self._at: Dict[int, List[Tuple[str, Optional[int]]]] = {}
        self._memo: Dict[int, List[Tuple[str, Optional[int]]]] = {}
        #: per-kind count of faults handed to the engine
        self.injected = {k: 0 for k in FAULT_KINDS}
        #: bounded (step, kind, slot) history of resolved injections
        self.injection_log: "collections.deque[Tuple[int, str, Optional[int]]]" \
            = collections.deque(maxlen=4096)

    def at(self, step: int, kind: str, slot: Optional[int] = None
           ) -> "FaultPlan":
        """Schedule ``kind`` at engine step ``step`` (chainable);
        ``slot=None`` targets the lowest active slot at fire time."""
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; valid: "
                             f"{FAULT_KINDS}")
        self._at.setdefault(int(step), []).append((kind, slot))
        return self

    def faults_for(self, step: int, active_slots: Sequence[int]
                   ) -> List[Tuple[str, Optional[int]]]:
        """The faults to apply at ``step`` given the active slots.

        The random draw for a step happens once, in the order the engine
        advances.  A slot-targeted kind resolves a missing or inactive
        slot to the first active one (a rate draw picks one itself), and
        is dropped with no active slot."""
        step = int(step)
        if step in self._memo:
            return self._memo[step]
        raw = list(self._at.get(step, ()))
        if self.rate > 0.0 and self._rng.random() < self.rate:
            kind = FAULT_KINDS[int(self._rng.integers(len(FAULT_KINDS)))]
            slot = None
            if kind in ("kv_corrupt", "nan_logits") and active_slots:
                slot = int(active_slots[
                    int(self._rng.integers(len(active_slots)))])
            raw.append((kind, slot))
        resolved: List[Tuple[str, Optional[int]]] = []
        for kind, slot in raw:
            if kind in ("kv_corrupt", "nan_logits"):
                if slot is None or slot not in active_slots:
                    if not active_slots:
                        continue
                    slot = int(active_slots[0])
            self.injected[kind] += 1
            self.injection_log.append((step, kind, slot))
            resolved.append((kind, slot))
        self._memo[step] = resolved
        return resolved


def _value_leaf_name(c: Dict[str, torch.Tensor]) -> Optional[str]:
    """The leaf of a global-pool layer that a NaN page reaches the
    logits through: the V scale pool when quantized, else a float V
    pool; None for a layer with no global pool (window and recurrent
    layers)."""
    if "vp" not in c:
        return None
    if "vs" in c:
        return "vs"
    return "vp" if c["vp"].dtype.is_floating_point else None


def corrupt_page(caches: List[Dict[str, torch.Tensor]], page: int) -> None:
    """Write NaN over pool page ``page`` of the first global-pool layer's
    V pool (or V scale pool), in place.  One layer is enough: NaN in the
    residual stream reaches the logits.  Raises when no layer has such a
    leaf (kv_corrupt needs a paged engine)."""
    for c in caches:
        name = _value_leaf_name(c)
        if name is not None:
            c[name][:, page].fill_(float("nan"))    # no host copy: no sync
            return
    raise ValueError("corrupt_page: no paged float pool leaf in the cache "
                     "tree (kv_corrupt needs paged=True)")


def _host_copy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def nonfinite_pages(caches: List[Dict[str, torch.Tensor]],
                    pages: Sequence[int],
                    device_get: Callable[[torch.Tensor], np.ndarray]
                    = _host_copy) -> List[int]:
    """The ``pages`` of the global pool holding a non-finite value in a
    float leaf (``kp``, ``vp`` and their ``ks``/``vs`` scale pools), in
    the order given.  The scan runs on the device and ends in one copy
    of the per-page flags through ``device_get`` (the engine passes its
    own, so the fault path's sync is counted like the step's).  Window
    and recurrent layers hold no global page and are not scanned."""
    pages = [int(p) for p in pages]
    if not pages:
        return []
    flags = idx = None
    for c in caches:
        if "kp" not in c:
            continue
        for name in ("kp", "vp", "ks", "vs"):
            leaf = c.get(name)
            if leaf is None or not leaf.dtype.is_floating_point:
                continue
            if idx is None:        # uploaded without waiting on the card
                idx = torch.from_numpy(np.asarray(pages, np.int64)).to(
                    leaf.device, non_blocking=True)
            # gathered as bytes: indexing needs nothing of the fp8 type
            sub = raw_bytes(leaf).index_select(1, idx).view(
                leaf.dtype).float()
            bad = ~torch.isfinite(sub.transpose(0, 1).reshape(
                len(pages), -1)).all(dim=1)
            flags = bad if flags is None else flags | bad
    if flags is None:
        return []
    hit = device_get(flags)
    return [p for p, h in zip(pages, hit) if h]
