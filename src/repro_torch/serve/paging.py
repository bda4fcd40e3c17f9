"""Paged KV cache: page pool, free-list allocator, block tables
(``repro.serve.paging``: the global group and the window group).

Allocation is host-side bookkeeping; the pools are device tensors, one
``kp``/``vp`` pair of shape (Hkv, P, ps, D) per global-attention layer
(an MLA layer's V pool narrower than its K pool),
in the model's dtype or, with a quantizing ``KVQuantSpec``, in int8/fp8
beside a ``ks``/``vs`` pair of (Hkv, P) f32 scale pools.  Page 0 is
reserved as the null/trash page: unallocated table entries point at it
and a freed slot's whole row is reset to it, so the stale ``cur_tok`` a
dead slot keeps feeding through the batched decode writes its K/V into
trash instead of a live sequence.  ``truncate_suffix`` is the
speculative step's rollback.

Sliding-window layers whose window is shorter than the cache form the
*window group*: ``kw``/``vw`` pools (with ``ks``/``vs`` when quantized)
over their own page pool, addressed through ring block tables of width
``window_table_width`` (global page ``g`` at column ``g % T_w``), from
which ``free_prefix`` eagerly returns the pages the window slid past.
Recurrent layers (mamba, mLSTM, sLSTM) keep their state dense and
slot-major beside the pools; a model of recurrent layers alone has no
pool, yet its block tables and allocator are kept as for any other.
A page found corrupted (``serve/faults.py``) is quarantined: it leaves
circulation for good and the pool's usable capacity shrinks.
"""
from __future__ import annotations

from typing import Collection, Dict, List, Mapping, Optional, Sequence, Set

import torch

from repro_torch.quant.spec import KVQuantSpec, spec_for_storage

NULL_PAGE = 0


class PageAllocator:
    """Free-list allocator over ``total_pages`` pages (page 0 reserved).

    O(1) alloc/free, LIFO reuse.  ``free`` is strict: double-freeing a
    page, or freeing the null page, would hand one physical page to two
    live sequences, so it raises and leaves the allocator unchanged.
    Free, allocated and quarantined pages partition the non-null pages.
    """

    def __init__(self, total_pages: int):
        if total_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.total_pages = int(total_pages)
        self._free: List[int] = list(range(total_pages - 1, 0, -1))
        self._allocated: Set[int] = set()
        # corrupted pages, out of circulation for good: recycled to a new
        # sequence, one would poison it again
        self._quarantined: Set[int] = set()
        self.alloc_count = 0
        self.free_count = 0
        self.quarantine_count = 0
        self.peak_in_use = 0

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._allocated)

    @property
    def quarantined(self) -> int:
        return len(self._quarantined)

    @property
    def usable(self) -> int:
        """Pages a sequence can ever hold: all but the null page and
        the quarantined ones (admission and checkpoint fits read this)."""
        return self.total_pages - 1 - len(self._quarantined)

    def pressure(self) -> dict:
        return {"total_pages": self.total_pages,
                "available": self.available,
                "in_use": self.in_use,
                "quarantined": self.quarantined,
                "peak_in_use": self.peak_in_use,
                "allocs": self.alloc_count,
                "frees": self.free_count}

    def brief(self) -> dict:
        """The per-step sample telemetry records: two ``len()`` reads."""
        return {"in_use": self.in_use, "quarantined": self.quarantined}

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError(
                "KV page pool exhausted; raise ServeConfig.total_pages "
                "(or lower slots/cache_len) — the default sizing "
                "(1 + slots * pages_per_slot) never exhausts")
        p = self._free.pop()
        self._allocated.add(p)
        self.alloc_count += 1
        self.peak_in_use = max(self.peak_in_use, len(self._allocated))
        return p

    def alloc_many(self, n: int) -> List[int]:
        # all n or nothing: a partial exhaustion never leaks pages
        if n > len(self._free):
            raise RuntimeError(f"KV page pool exhausted: need {n} pages, "
                               f"{len(self._free)} free")
        return [self.alloc() for _ in range(n)]

    def free(self, pages: Sequence[int]) -> None:
        # validate the whole batch (duplicates inside it included) first
        pages = [int(p) for p in pages]
        seen: Set[int] = set()
        for p in pages:
            if p == NULL_PAGE:
                raise ValueError(
                    "cannot free the reserved null page 0 (filter "
                    "NULL_PAGE entries out of the block-table row first)")
            if p not in self._allocated or p in seen:
                raise ValueError(
                    f"double free of KV page {p} (not currently "
                    f"allocated); a page freed twice would be handed to "
                    f"two live sequences")
            seen.add(p)
        for p in pages:
            self._allocated.discard(p)
            self._free.append(p)
        self.free_count += len(pages)

    def quarantine(self, pages: Sequence[int]) -> None:
        """Take ``pages`` (allocated or free) out of circulation for
        good; ``usable`` shrinks.  Validates the whole batch first, like
        ``free``.  The caller resets a quarantined page's table entries
        to NULL_PAGE before the row is reclaimed."""
        pages = [int(p) for p in pages]
        seen: Set[int] = set()
        for p in pages:
            if p == NULL_PAGE or not 0 < p < self.total_pages:
                raise ValueError(f"cannot quarantine page {p}: not a real "
                                 f"pool page (1..{self.total_pages - 1})")
            if p in self._quarantined or p in seen:
                raise ValueError(f"page {p} is already quarantined")
            seen.add(p)
        for p in pages:
            if p in self._allocated:
                self._allocated.discard(p)
            else:
                self._free.remove(p)
            self._quarantined.add(p)
        self.quarantine_count += len(pages)

    def reclaim(self, table_row: Sequence[int]) -> int:
        """Free every real page of a block-table row (NULL_PAGE entries
        are skipped; ``free`` stays strict).  Returns the count."""
        real = [int(p) for p in table_row if int(p) != NULL_PAGE]
        if real:
            self.free(real)
        return len(real)


def pages_per_slot(cache_len: int, page_size: int) -> int:
    return -(-cache_len // page_size)


# ------------------------------------------------ windowed block tables ----

def window_table_width(window: int, page_size: int) -> int:
    """Ring block-table width of a sliding-window layer: ``window``
    positions touch at most ``(window - 1) // ps + 1`` pages, and one
    more column lets the next write page coexist with a first page not
    yet freed, so the live span never wraps onto itself."""
    return (window - 1) // page_size + 2


def first_live_page(length: int, window: int, page_size: int) -> int:
    """First global page holding an in-window token of a sequence of
    ``length`` tokens (the window is ``[length - window, length)``);
    the pages before it are dead and freed eagerly."""
    return max(0, length - window) // page_size


def live_window_pages(length: int, window: int, page_size: int) -> range:
    """Global pages a windowed slot of ``length`` tokens has mapped (none
    for length <= 0); at most ``window_table_width`` of them."""
    if length <= 0:
        return range(0)
    return range(first_live_page(length, window, page_size),
                 (length - 1) // page_size + 1)


def free_prefix(allocator: PageAllocator, table_row, old_first: int,
                new_first: int) -> int:
    """Free a windowed slot's pages ``[old_first, new_first)``, the ones
    the window just slid past, and reset their ring columns ``g % T``
    to ``NULL_PAGE``, in place; returns the count.  It runs before each
    step's page ensure, so a write page's column is vacant by then.

    Strict like ``truncate_suffix``: the window start may not move
    backwards, the range may not exceed the ring's width (it would lap
    live columns), and every column in it must hold a real page (a
    NULL there means the prefix was already freed)."""
    if new_first < old_first:
        raise ValueError(
            f"free_prefix: window start moved backwards "
            f"({old_first} -> {new_first})")
    t = len(table_row)
    if new_first - old_first > t:
        raise ValueError(
            f"free_prefix: freeing {new_first - old_first} pages would "
            f"lap the ring (width {t}) — window start was not advanced "
            f"every step")
    cols = [g % t for g in range(old_first, new_first)]
    pages = [int(table_row[c]) for c in cols]
    if any(p == NULL_PAGE for p in pages):
        raise ValueError(
            f"free_prefix: pages [{old_first}:{new_first}) contain "
            f"NULL_PAGE entries — prefix already freed or never "
            f"allocated (row={list(int(p) for p in table_row)})")
    if pages:
        allocator.free(pages)           # validates the batch atomically
        for c in cols:
            table_row[c] = NULL_PAGE
    return len(pages)


def truncate_suffix(allocator: PageAllocator, table_row, keep: int,
                    upto: Optional[int] = None) -> int:
    """Free a block-table row's page suffix ``[keep, upto)`` back to the
    pool and reset those entries to ``NULL_PAGE``, in place.

    The speculative rollback: after a verify step accepts part of the
    window, the pages ensured for the rejected tail are ``row[keep:
    upto]`` with ``keep = pages_per_slot(new_length)``; rejected rows
    inside kept pages sit past the length and every read masks them.
    Strict like ``PageAllocator.free``: a ``NULL_PAGE`` inside the
    suffix means it was already truncated or never ensured, so it
    raises.  Returns the number of pages freed."""
    tail = table_row[keep:upto]
    if len(tail) == 0:
        return 0
    if any(int(p) == NULL_PAGE for p in tail):
        raise ValueError(
            f"truncate_suffix: pages [{keep}:{upto}) contain NULL_PAGE "
            f"entries — suffix already truncated or never allocated "
            f"(row={list(int(p) for p in table_row)})")
    allocator.free([int(p) for p in tail])
    table_row[keep:upto] = NULL_PAGE
    return len(tail)


def audit(allocator: PageAllocator, block_tables, lengths, active,
          page_size: int, window: Optional[int] = None) -> List[str]:
    """Allocator and block-table invariants at a step boundary; returns
    the problems found (empty = consistent):

    * free, allocated and quarantined partition the non-null pages
      exactly (disjoint, no duplicates, in range);
    * an active slot's live prefix ``row[:pages_per_slot(len)]`` holds
      only allocated pages, no NULL_PAGE hole;
    * nothing past a live prefix, or in an inactive row, holds a page;
    * no page is leased to two rows;
    * ``in_use`` equals the sum of live-prefix page counts.

    With ``window`` the rows are ring tables (the window group): the
    live set is the columns ``g % T`` of ``live_window_pages``, so the
    same walk holds the live window fully mapped, nothing mapped behind
    it, and ``in_use`` equal to the sum of live window pages.
    """
    problems: List[str] = []
    total = allocator.total_pages
    free_list = [int(p) for p in allocator._free]
    sets = {"free": set(free_list), "allocated": set(allocator._allocated),
            "quarantined": set(allocator._quarantined)}
    free, alloc, quar = sets.values()
    if len(free_list) != len(free):
        dups = sorted(p for p in free if free_list.count(p) > 1)
        problems.append(f"free list holds duplicate pages {dups}")
    for name, s in sets.items():
        if NULL_PAGE in s:
            problems.append(f"reserved null page in the {name} set")
        bad = sorted(p for p in s if not 0 < p < total)
        if bad:
            problems.append(f"{name} set holds out-of-range pages {bad}")
    for a, b in (("free", "allocated"), ("free", "quarantined"),
                 ("allocated", "quarantined")):
        both = sorted(sets[a] & sets[b])
        if both:
            problems.append(f"pages {both} are both {a} and {b}")
    if not problems and len(free | alloc | quar) != total - 1:
        missing = sorted(set(range(1, total)) - free - alloc - quar)
        problems.append(f"pages {missing} vanished from the allocator "
                        f"(not free, allocated, or quarantined)")

    leased: Dict[int, int] = {}
    need_total = 0
    for slot, row in enumerate(block_tables):
        length = int(lengths[slot]) if active[slot] else 0
        if window is None:
            live_at = {j: j for j in range(
                pages_per_slot(length, page_size) if length > 0 else 0)}
        else:
            live_at = {g % len(row): g for g in
                       live_window_pages(length, window, page_size)}
        need_total += len(live_at)
        for j, p in enumerate(row):
            p = int(p)
            if j in live_at:
                if p == NULL_PAGE:
                    where = ("live prefix at index" if window is None else
                             f"live window (page {live_at[j]}) at column")
                    problems.append(f"slot {slot}: NULL_PAGE inside the "
                                    f"{where} {j} (length {length})")
                elif p not in alloc:
                    where = ("quarantine" if p in quar else "free list"
                             if p in free else "limbo")
                    problems.append(f"slot {slot}: live page {p} is not "
                                    f"allocated (in {where})")
            elif p != NULL_PAGE:
                where = ("past the live prefix at index" if window is None
                         else "mapped behind the live window at column")
                problems.append(f"slot {slot}: page {p} {where} {j} "
                                f"(would leak)")
            if p != NULL_PAGE:
                if p in leased:
                    problems.append(f"page {p} leased to both slot "
                                    f"{leased[p]} and slot {slot}")
                leased[p] = slot
    if need_total != allocator.in_use:
        what = "live-prefix" if window is None else "live window"
        problems.append(f"in_use {allocator.in_use} != sum of {what} "
                        f"pages {need_total}")
    return problems


def init_paged_caches(num_layers: int, num_kv_heads: int, head_dim: int,
                      total_pages: int, page_size: int, *, device,
                      dtype: torch.dtype,
                      kv_spec: Optional[KVQuantSpec] = None,
                      window_layers: Collection[int] = (),
                      total_pages_window: Optional[int] = None,
                      v_head_dim: Optional[int] = None,
                      recurrent: Optional[Mapping[
                          int, Dict[str, torch.Tensor]]] = None
                      ) -> List[Dict[str, torch.Tensor]]:
    """One zeroed pool pair (Hkv, P, ps, D) per attention layer (the V
    pool ``v_head_dim`` wide where it is given: MLA), in ``dtype`` or
    the spec's storage dtype: ``kp``/``vp`` over ``total_pages`` pages,
    or, for the layers in ``window_layers`` (the window group),
    ``kw``/``vw`` over ``total_pages_window``.  A quantizing spec adds
    ``ks``/``vs`` (Hkv, P) f32 scale pools of the layer's group,
    ones-initialized: a zero pool dequantizes to zeros under any scale,
    and a unit scale keeps dequantization total before the first
    write.  The layers in ``recurrent`` (index -> empty state leaves:
    ``transformer.recurrent_cache``) are not paged: their leaves are
    taken as they are, dense and slot-major (``repro`` paging.py:464)."""
    if window_layers and total_pages_window is None:
        raise ValueError("window-group layers need total_pages_window")
    pool_dtype = kv_spec.storage if kv_spec is not None else dtype
    quantized = kv_spec is not None and kv_spec.quantized
    dv = head_dim if v_head_dim is None else v_head_dim
    recurrent = recurrent or {}
    caches = []
    for i in range(num_layers):
        if i in recurrent:
            caches.append(dict(recurrent[i]))
            continue
        win = i in window_layers
        shape = (num_kv_heads, total_pages_window if win else total_pages,
                 page_size)
        kname, vname = ("kw", "vw") if win else ("kp", "vp")
        c = {kname: torch.zeros(shape + (head_dim,), device=device,
                                dtype=pool_dtype),
             vname: torch.zeros(shape + (dv,), device=device,
                                dtype=pool_dtype)}
        if quantized:
            for name in ("ks", "vs"):
                c[name] = torch.ones(shape[:2], device=device,
                                     dtype=kv_spec.scale_dtype)
        caches.append(c)
    return caches


def raw_bytes(pool: torch.Tensor) -> torch.Tensor:
    """An fp8 pool viewed as uint8 (other pools unchanged), for indexed
    reads and writes: the bytes are the values, and byte indexing needs
    nothing of the fp8 type on any device."""
    return pool.view(torch.uint8) if pool.dtype == torch.float8_e4m3fn \
        else pool


def _page_blocks(one: torch.Tensor, t: int, ps: int) -> torch.Tensor:
    """Batch-k prefill leaf (k, H, S, D) -> page blocks (H, k, T, ps, D)."""
    k, h, s, d = one.shape
    pad = t * ps - s
    if pad < 0:
        raise ValueError(f"prefill of {s} rows exceeds {t} pages of {ps}")
    if pad:
        one = torch.nn.functional.pad(one, (0, 0, 0, pad))
    return one.reshape(k, h, t, ps, d).transpose(0, 1)


def _unring_window(one: torch.Tensor, t: int, ps: int, window: int,
                   plens: torch.Tensor) -> torch.Tensor:
    """Batch-k *ring* prefill leaf (k, H, W, D), token ``p`` at slot
    ``p % W``, -> page blocks (H, k, T, ps, D) at true token positions
    (``repro`` paging.py:551).  Positions outside ``[plen - window,
    plen)`` are zeroed: behind the window their pages' rows are NULL
    (the zeros land in trash), past the prompt they are masked by
    length, and as zeros they never inflate a quantized page's
    absmax."""
    k, h, w, d = one.shape
    pos = torch.arange(t * ps, device=one.device)
    full = one.index_select(2, pos % w)              # (k, H, T*ps, D)
    valid = ((pos[None, :] >= plens[:, None] - window)
             & (pos[None, :] < plens[:, None]))
    full = torch.where(valid[:, None, :, None], full, torch.zeros_like(full))
    return full.reshape(k, h, t, ps, d).transpose(0, 1)


def _scatter_blocks(pool: torch.Tensor, scale_pool: Optional[torch.Tensor],
                    blocks: torch.Tensor, page_rows: torch.Tensor) -> None:
    """Write page blocks (H, k, T, ps, D) into ``pool[:, page_rows]`` in
    place; with a scale pool, quantized per (head, page) block at
    absmax first (int8/fp8 values into the pool, f32 scales beside
    them).  Rows past a prompt are zero padding, so they never inflate
    a page's absmax (``repro`` paging.py:532)."""
    rows = page_rows.long()
    if scale_pool is None:
        pool[:, rows] = blocks.to(pool.dtype)
        return
    q, scales = spec_for_storage(pool.dtype).quantize_pages(blocks)
    raw_bytes(pool)[:, rows] = raw_bytes(q)
    scale_pool[:, rows] = scales.to(scale_pool.dtype)


def scatter_prefill(caches: List[Dict[str, torch.Tensor]],
                    cache1: List[Dict[str, torch.Tensor]],
                    slot_idx: torch.Tensor,
                    page_rows: Optional[torch.Tensor] = None,
                    page_rows_w: Optional[torch.Tensor] = None,
                    plens: Optional[torch.Tensor] = None,
                    window: Optional[int] = None) -> None:
    """Admit a prefilled group into the engine's caches, in place.

    ``cache1`` is ``prefill``'s per-layer dense K/V at batch k; the
    global group takes it through ``page_rows`` (k, T) destination
    pages (NULL entries past the prompt land in trash, masked by length
    at decode); the window group takes its ring leaves, un-rung,
    through ``page_rows_w`` (k, T), global-page-indexed and NULL but
    for each prompt's live window pages, so only the window's tail
    reaches real pages (``plens`` (k,) the prompt lengths, ``window``
    the model's).  Quantized pools are quantized per (head, page);
    dense leaves of any name (K/V caches and rings, a recurrent layer's
    state) take rows ``slot_idx`` (k,), so an admitted slot
    holds only its own request's state.
    """
    for c, one in zip(caches, cache1):
        for name, leaf in one.items():
            scales = c.get(f"{name}s")
            if f"{name}p" in c:
                pool = c[f"{name}p"]
                _scatter_blocks(pool, scales, _page_blocks(
                    leaf, page_rows.shape[1], pool.shape[2]), page_rows)
            elif f"{name}w" in c:
                pool = c[f"{name}w"]
                _scatter_blocks(pool, scales, _unring_window(
                    leaf, page_rows_w.shape[1], pool.shape[2], window,
                    plens), page_rows_w)
            else:
                c[name][slot_idx] = leaf.to(c[name].dtype)


def paged_bytes_per_slot(caches: List[Dict[str, torch.Tensor]],
                         total_pages: int, n_pages_per_slot: int) -> int:
    """Device bytes of the global group's pools (K/V and scales) that
    one slot's pages take: at a fixed pool budget, ``budget // this``
    slots fit."""
    per_page = 0
    for c in caches:
        if "kp" not in c:
            continue
        for name, leaf in c.items():
            if name in ("kp", "vp", "ks", "vs"):
                per_page += leaf.numel() * leaf.element_size() // total_pages
    return per_page * n_pages_per_slot
