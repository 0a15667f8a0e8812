"""Paged KV cache: preallocated device pools + a host-side page allocator.

Ported from ``mxnet_tpu/serving/kvcache.py``. KV lives in ONE pool of
fixed-size pages per layer, allocated once on the device; a sequence owns
whatever pages it needs through a page table, and the paged-attention
kernel (:func:`mxnet_tpu_torch.ops.paged_attention.paged_attention`)
reads through the table — so allocation is a host-side free-list
operation that never touches a device shape.

Split of responsibilities:

* **host side (this class)** — the free list, per-page refcounts, the
  per-slot page tables and lengths (numpy, static shapes), admission
  accounting, the prefix index, and the ``mxnet_kvcache_*`` gauges —
  ported as they are;
* **device side** — :func:`write_kv` writes one step's new K/V rows into
  the pools IN PLACE at host-computed (page, offset) slots (where the JAX
  package threads donated arrays through its jits, the port updates the
  preallocated tensors with ``index_put_``).

Page 0 is reserved as the *null page*: page-table padding and inactive
decode slots point at it, and masked reads/garbage writes land there
harmlessly. The allocator never hands it out.

Prefix caching (``prefix_cache=True``; the engine knob is
``MXNET_DECODE_PREFIX_CACHE``): pages are REFCOUNTED — a page may be
mapped into several slots' tables at once, and it returns to the free
list only when its last reference drops AND it is not held by the prefix
index. The index keys each *full* page of a prompt by the rolling hash
of its whole token prefix (``key_i = sha1(key_{i-1} || tokens_i)``), so
a lookup that walks the chain and token-verifies every chunk can map a
shared system prompt's pages directly into a new slot. The first
*divergent or partial* page is shared **copy-on-write**: the matching
page is copied into a fresh page owned by the new sequence (the engine
runs the device copy), and only then written. Pages whose last slot
reference drops but that remain indexed move to a **cached LRU**,
reclaimed oldest-first the moment a reservation needs them.

Knobs: ``MXNET_KVCACHE_PAGE_SIZE`` (default 16 tokens/page),
``MXNET_KVCACHE_PAGES`` (0 = auto-size to the slot count x max sequence
length, + the null page), ``MXNET_KVCACHE_AUDIT``.
"""
from __future__ import annotations

import collections
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import telemetry
from ..base import MXNetError, get_env, resolve_device

__all__ = ["PagedKVCache", "OutOfPagesError", "PrefixMatch", "write_kv"]

_DEFAULT_PAGE_SIZE = 16

_T_PAGES = telemetry.gauge(
    "mxnet_kvcache_pages_in_use",
    "KV cache pages currently allocated to live sequences",
    labels=("cache",))
_T_CAPACITY = telemetry.gauge(
    "mxnet_kvcache_pages_capacity",
    "allocatable KV cache pages in the pool (excludes the null page)",
    labels=("cache",))
_T_SHARED = telemetry.gauge(
    "mxnet_kvcache_shared_pages",
    "KV pages currently mapped by more than one live sequence "
    "(refcount > 1: the prefix-sharing win, charged to no single tenant)",
    labels=("cache",))
_T_CACHED = telemetry.gauge(
    "mxnet_kvcache_cached_pages",
    "KV pages held only by the prefix index (refcount 0, reclaimable "
    "on demand — warm capacity, not live usage)",
    labels=("cache",))
_T_PREFIX_HITS = telemetry.counter(
    "mxnet_kvcache_prefix_hits_total",
    "admissions that mapped at least one cached prefix page/token",
    labels=("cache",))
_T_PREFIX_MISSES = telemetry.counter(
    "mxnet_kvcache_prefix_misses_total",
    "admissions that found no cached prefix",
    labels=("cache",))
_T_PRESSURE_SHEDS = telemetry.counter(
    "mxnet_kvcache_pressure_sheds_total",
    "cached-LRU (refcount-0) prefix pages proactively returned to the "
    "free list by shed_cached() — warm capacity traded for headroom",
    labels=("cache",))


class OutOfPagesError(MXNetError):
    """The free list (plus every reclaimable cached page) cannot cover
    the requested reservation; the caller (the decode engine's admission
    loop) defers the sequence instead of growing the pool — static
    shapes are the contract."""


def write_kv(k_pool, v_pool, layer: int, k_new, v_new, pages,
             offsets) -> None:
    """Write one batch of new K/V rows into the layer's pool pages, in
    place.

    k_pool/v_pool: (L, P, page_size, KH, D) device pools; k_new/v_new:
    (N, KH, D) rows; pages/offsets: (N,) integer destinations
    (host-computed by :meth:`PagedKVCache.write_slots`), cast to ``long``
    before indexing. Rows whose destination is the null page (inactive
    slots, prompt padding) overwrite garbage with garbage by design.
    """
    idx = (pages.long(), offsets.long())
    k_pool[layer].index_put_(idx, k_new.to(k_pool.dtype))
    v_pool[layer].index_put_(idx, v_new.to(v_pool.dtype))


class _PrefixEntry:
    """One indexed page: the chain key it answers to, its parent key,
    the page id, and the VALID token run stored in it (``page_size``
    tokens for a full page, fewer for a partial — positions beyond
    ``len(tokens)`` hold other sequences' writes and are masked by
    ``seq_lens``, never trusted)."""

    __slots__ = ("key", "parent", "page", "tokens", "full")

    def __init__(self, key: Optional[bytes], parent: bytes, page: int,
                 tokens: np.ndarray, full: bool):
        self.key = key
        self.parent = parent
        self.page = int(page)
        self.tokens = tokens
        self.full = full


class PrefixMatch:
    """Result of :meth:`PagedKVCache.match_prefix`: the run of full
    pages whose whole token prefix matched, plus (optionally) the first
    divergent/partial page and how many of its leading tokens match —
    that page is shared copy-on-write."""

    __slots__ = ("full", "partial", "partial_len", "matched")

    def __init__(self, full: List[_PrefixEntry],
                 partial: Optional[_PrefixEntry], partial_len: int,
                 matched: int):
        self.full = full
        self.partial = partial
        self.partial_len = int(partial_len)
        self.matched = int(matched)


def _chain_key(parent: bytes, chunk: np.ndarray) -> bytes:
    return hashlib.sha1(parent + chunk.astype("<i4").tobytes()).digest()


def _common_prefix_len(a: np.ndarray, b: np.ndarray) -> int:
    n = min(a.size, b.size)
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if neq.size else n


class PagedKVCache:
    """Fixed-size paged KV pools for ``num_slots`` concurrent sequences.

    Device state: ``k_pool``/``v_pool`` of shape ``(num_layers,
    num_pages, page_size, num_kv_heads, head_dim)`` — allocated once on
    ``device`` (the card unless ``device="cpu"``), shape-stable for the
    cache's lifetime and updated in place.

    Host state per slot: a fixed-width page-table row (``max_pages``
    entries, unused entries = the null page 0) and a token count. The
    free list is LIFO — a page freed by one sequence is the next page
    another acquires, which the reuse regression test pins. With
    ``prefix_cache=True`` pages carry refcounts, slots may map shared
    read-only pages (charged to no single slot's *exclusive* count), and
    freed-but-indexed pages park in a reclaimable cached-LRU instead of
    the free list.
    """

    def __init__(self, num_slots: int, max_seq_len: int, num_layers: int,
                 num_kv_heads: int, head_dim: int, page_size: Optional[int]
                 = None, num_pages: Optional[int] = None, dtype="float32",
                 name: str = "decode", prefix_cache: bool = False,
                 device=None):
        if page_size is None:
            page_size = get_env("MXNET_KVCACHE_PAGE_SIZE",
                                _DEFAULT_PAGE_SIZE, int, cache=False)
        if num_pages is None:
            num_pages = get_env("MXNET_KVCACHE_PAGES", 0, int, cache=False)
        self.page_size = max(1, int(page_size))
        self.num_slots = int(num_slots)
        self.max_seq_len = int(max_seq_len)
        self.max_pages = -(-self.max_seq_len // self.page_size)
        if not num_pages:
            # worst case: every slot holds a max-length sequence; +1 null
            num_pages = self.num_slots * self.max_pages + 1
        if num_pages < 2:
            raise MXNetError("kvcache needs >= 2 pages (null + 1), got %d"
                             % num_pages)
        self.num_pages = int(num_pages)
        self.name = name
        shape = (int(num_layers), self.num_pages, self.page_size,
                 int(num_kv_heads), int(head_dim))
        self.device = resolve_device(device)
        tdtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        if not isinstance(tdtype, torch.dtype):
            raise MXNetError("unknown kvcache dtype %r" % (dtype,))
        self.k_pool = torch.zeros(shape, dtype=tdtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=tdtype, device=self.device)
        # LIFO free list over pages 1..P-1; page 0 is the null page
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self.page_table = np.zeros((self.num_slots, self.max_pages),
                                   np.int32)
        self.seq_lens = np.zeros((self.num_slots,), np.int32)
        self._owned = [0] * self.num_slots      # pages mapped per slot
        self._exclusive = [0] * self.num_slots  # un-shared pages per slot
        # per-page slot-mapping refcount; a page is live while > 0
        self._ref = np.zeros((self.num_pages,), np.int32)
        # prefix index: chain-key -> full-page entry, parent-key -> the
        # child entries hanging off it (full AND partial — the divergent-
        # page CoW candidates), page -> its entry, and the cached-LRU of
        # refcount-0 indexed pages (reclaim oldest-first)
        self.prefix_cache = bool(prefix_cache)
        self._index: Dict[bytes, _PrefixEntry] = {}
        self._children: Dict[bytes, List[_PrefixEntry]] = {}
        self._page_entry: Dict[int, _PrefixEntry] = {}
        self._cached: "collections.OrderedDict[int, _PrefixEntry]" = \
            collections.OrderedDict()
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_tokens_matched = 0
        self.pressure_sheds = 0
        # bumped on every table mutation (reserve/free): the decode
        # engine keys its cached DEVICE copy of the page table on it, so
        # steady decode ticks skip the host->device copy entirely
        self.version = 0
        # MXNET_KVCACHE_AUDIT=1: every mutation (and every engine tick)
        # re-proves the refcount invariant
        self.audit = bool(get_env("MXNET_KVCACHE_AUDIT", 0, int,
                                  cache=False))
        _T_CAPACITY.set(self.num_pages - 1, cache=self.name)
        self._publish()

    # -- accounting --------------------------------------------------------
    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_cached(self) -> int:
        """Refcount-0 pages parked in the prefix index — reclaimable."""
        return len(self._cached)

    @property
    def pages_available(self) -> int:
        """Pages a reservation can draw on right now: the free list plus
        every reclaimable cached page."""
        return len(self._free) + len(self._cached)

    @property
    def pages_in_use(self) -> int:
        """Pages mapped by at least one live sequence (cached-LRU pages
        are warm capacity, not usage — they reclaim on demand)."""
        return self.num_pages - 1 - len(self._free) - len(self._cached)

    @property
    def shared_pages(self) -> int:
        """Pages currently mapped by more than one live sequence — the
        refcount>1 set the ``shared`` pseudo-tenant answers for."""
        return int(np.count_nonzero(self._ref > 1))

    def pages_for(self, n_tokens: int) -> int:
        """Pages a sequence of ``n_tokens`` occupies."""
        return -(-int(n_tokens) // self.page_size)

    def pages_owned(self, slot: int) -> int:
        """Pages currently mapped by ``slot`` (0 after :meth:`free`),
        shared mappings included."""
        return self._owned[int(slot)]

    def exclusive_pages(self, slot: int) -> int:
        """Pages ``slot`` owns EXCLUSIVELY (fresh reservations + its CoW
        copies) — the count charged to the owning tenant's page budget;
        shared prefix pages belong to the ``shared`` pseudo-tenant and
        charge nobody twice."""
        return self._exclusive[int(slot)]

    def reserved_tokens(self, slot: int) -> int:
        """Token capacity of ``slot``'s reserved page run — the hard
        ceiling :meth:`write_slots` enforces. The speculative decode
        step clamps its per-tick draft depth so that all k+1 verify
        rows land below this bound: admission reserved the worst case
        (prompt + max_new) up front, so a speculating sequence can
        never grow pages mid-tick and never exceeds the tenant page
        budget it was charged at admission."""
        return self._owned[int(slot)] * self.page_size

    def can_admit(self, n_tokens: int) -> bool:
        """Whether a full reservation for ``n_tokens`` fits right now."""
        return self.pages_for(n_tokens) <= self.pages_available

    def can_admit_prefix(self, n_tokens: int,
                         match: Optional[PrefixMatch]) -> bool:
        """Whether ``n_tokens`` fits given a prefix ``match``: matched
        full pages are mapped (not allocated), the CoW page and the tail
        come from the free list / reclaimable cached pages — minus the
        match's own pages, which must not be reclaimed out from under
        the mapping."""
        need = self.pages_for(n_tokens)
        pinned = 0
        if match is not None:
            need -= len(match.full)
            for e in match.full:
                if e.page in self._cached:
                    pinned += 1
            if match.partial is not None and \
                    match.partial.page in self._cached:
                pinned += 1
        return need <= self.pages_available - pinned

    # -- allocation --------------------------------------------------------
    def _take_page(self, pin=()) -> int:
        """One page off the free list, or — when it's dry — reclaimed
        from the oldest cached (refcount-0, indexed) page not in
        ``pin``. Raises :class:`OutOfPagesError` when neither has one."""
        if self._free:
            return self._free.pop()
        for page in self._cached:
            if page in pin:
                continue
            entry = self._cached.pop(page)
            self._index_remove(entry)
            return page
        raise OutOfPagesError(
            "kvcache %r: pool exhausted (%d pages, 0 free, %d cached all "
            "pinned)" % (self.name, self.num_pages - 1, len(self._cached)))

    def reserve(self, slot: int, n_tokens: int, _pin=()) -> None:
        """Grow ``slot``'s page run to cover ``n_tokens`` total tokens.

        The decode engine reserves a sequence's WORST CASE (prompt +
        max_new_tokens) at admission, so a sequence admitted can always
        finish — no mid-flight eviction for lack of pages. Shared pages
        already mapped by :meth:`admit_prefix` count toward the cover,
        so only the non-shared tail is allocated. Raises
        :class:`OutOfPagesError` (leaving the slot unchanged) when the
        free list plus reclaimable cached pages can't cover it.
        """
        if n_tokens > self.max_seq_len:
            raise MXNetError(
                "sequence of %d tokens exceeds max_seq_len %d"
                % (n_tokens, self.max_seq_len))
        need = self.pages_for(n_tokens) - self._owned[slot]
        if need <= 0:
            return
        usable = self.pages_available - sum(1 for p in _pin
                                            if p in self._cached)
        if need > usable:
            raise OutOfPagesError(
                "kvcache %r: need %d pages, %d free + %d cached (pool %d)"
                % (self.name, need, len(self._free), len(self._cached),
                   self.num_pages - 1))
        for _ in range(need):
            page = self._take_page(pin=_pin)
            self.page_table[slot, self._owned[slot]] = page
            self._owned[slot] += 1
            self._exclusive[slot] += 1
            self._ref[page] = 1
        self.version += 1
        self._publish()

    def free(self, slot: int) -> None:
        """Drop every page mapping ``slot`` holds and reset its table
        row to the null page. A page returns to the free list only when
        its LAST reference drops — other sequences sharing it are
        untouched; an indexed page with no references parks in the
        cached-LRU instead (warm for the next prefix hit, reclaimed on
        demand). Idempotent."""
        for i in range(self._owned[slot]):
            page = int(self.page_table[slot, i])
            if page == 0 or self._ref[page] <= 0:
                # double-free: this mapping's page already dropped its
                # last reference. Decref once only — decrementing past
                # zero used to clamp AND re-append the page, planting a
                # duplicate free-list entry that hands one page to two
                # slots (silent KV corruption). Audit mode makes the
                # re-entrant release loud instead of absorbing it.
                if self.audit:
                    raise MXNetError(
                        "kvcache %r audit: double-free of page %d via "
                        "slot %d (refcount already 0) — a release path "
                        "ran twice over one mapping" % (self.name, page,
                                                        slot))
                continue
            self._ref[page] -= 1
            if self._ref[page] == 0:
                entry = self._page_entry.get(page)
                if entry is not None:
                    self._cached[page] = entry
                else:
                    self._free.append(page)
        self.page_table[slot, :] = 0
        self.seq_lens[slot] = 0
        self._owned[slot] = 0
        self._exclusive[slot] = 0
        self.version += 1
        self._publish()

    # -- prefix index ------------------------------------------------------
    def match_prefix(self, prompt) -> Optional[PrefixMatch]:
        """Walk the index for ``prompt``: the longest run of full pages
        whose rolling-hash chain matches (every chunk token-verified, so
        a hit is exact by construction, not by hash luck), then the best
        divergent/partial child of the last matched key — the CoW page.
        Read-only; returns None when nothing matched (or the index is
        disabled)."""
        if not self.prefix_cache:
            return None
        prompt = np.asarray(prompt, np.int32).ravel()
        ps = self.page_size
        p = int(prompt.size)
        full: List[_PrefixEntry] = []
        parent = b""
        for i in range(p // ps):
            chunk = prompt[i * ps:(i + 1) * ps]
            key = _chain_key(parent, chunk)
            e = self._index.get(key)
            if e is None or not np.array_equal(e.tokens, chunk):
                break
            full.append(e)
            parent = key
        matched = len(full) * ps
        nxt = prompt[matched:matched + ps]
        best, best_n = None, 0
        if nxt.size:
            for e in self._children.get(parent, ()):
                n = _common_prefix_len(e.tokens, nxt)
                if n > best_n:
                    best, best_n = e, n
        matched += best_n
        if matched == 0:
            return None
        return PrefixMatch(full, best, best_n, matched)

    def admit_prefix(self, slot: int, total_tokens: int,
                     match: Optional[PrefixMatch]):
        """Admission in one atomic host step: map the match's full pages
        into ``slot`` (refcount++, read-only sharing), allocate a fresh
        page for the divergent/partial page (the engine device-copies
        the source into it — copy-on-write, charged to the writer), then
        :meth:`reserve` the remaining worst-case tail. Returns
        ``(matched_tokens, cow_src_page_or_None, cow_dst_page_or_None)``.
        Counts the hit/miss. Every failure raises BEFORE any mutation —
        :class:`OutOfPagesError` when the tail cannot be covered,
        :class:`~mxnet_tpu_torch.base.MXNetError` past ``max_seq_len`` — so
        the slot is never left half-mapped."""
        if total_tokens > self.max_seq_len:
            raise MXNetError(
                "sequence of %d tokens exceeds max_seq_len %d"
                % (total_tokens, self.max_seq_len))
        if not self.can_admit_prefix(total_tokens, match):
            raise OutOfPagesError(
                "kvcache %r: prefix admission needs more pages than the "
                "%d free + %d cached available"
                % (self.name, len(self._free), len(self._cached)))
        if match is None or match.matched == 0:
            self.prefix_misses += 1
            _T_PREFIX_MISSES.inc(cache=self.name)
            self.reserve(slot, total_tokens)
            return 0, None, None
        pin = set()
        for e in match.full:
            self._cached.pop(e.page, None)  # adopted: no longer idle
            self.page_table[slot, self._owned[slot]] = e.page
            self._owned[slot] += 1
            self._ref[e.page] += 1
        cow_src = cow_dst = None
        if match.partial is not None:
            # the divergent/partial page is never mapped read-only: the
            # sequence WILL write into it (its remaining tail and/or its
            # first generated tokens), so it gets a private copy now —
            # pinned so the tail reservation can't reclaim the source
            # before the device copy runs
            cow_src = match.partial.page
            pin.add(cow_src)
            cow_dst = self._take_page(pin=pin)
            self.page_table[slot, self._owned[slot]] = cow_dst
            self._owned[slot] += 1
            self._exclusive[slot] += 1
            self._ref[cow_dst] = 1
        self.version += 1
        self.reserve(slot, total_tokens, _pin=pin)
        self.prefix_hits += 1
        self.prefix_tokens_matched += match.matched
        _T_PREFIX_HITS.inc(cache=self.name)
        self._publish()
        return match.matched, cow_src, cow_dst

    def insert_prefix(self, slot: int, prompt) -> None:
        """Index ``slot``'s freshly-prefilled prompt pages: one full
        entry per page-aligned chunk (chain-keyed), plus a partial entry
        for the tail — the future divergent-page CoW donor. Pages that
        are already indexed (mapped FROM the index, or a concurrent
        duplicate) are skipped; generated tokens are never indexed (the
        partial entry's ``tokens`` stop at the prompt)."""
        if not self.prefix_cache:
            return
        prompt = np.asarray(prompt, np.int32).ravel()
        ps = self.page_size
        p = int(prompt.size)
        parent = b""
        for i in range(p // ps):
            chunk = prompt[i * ps:(i + 1) * ps]
            key = _chain_key(parent, chunk)
            page = int(self.page_table[slot, i])
            # page 0 = the slot was freed under us (a close() racing the
            # last chunk): never index the null page
            if page and key not in self._index \
                    and page not in self._page_entry:
                e = _PrefixEntry(key, parent, page, chunk.copy(), True)
                self._index[key] = e
                self._children.setdefault(parent, []).append(e)
                self._page_entry[page] = e
            parent = key
        tail = prompt[(p // ps) * ps:]
        if tail.size:
            page = int(self.page_table[slot, p // ps])
            covered = any(
                e.tokens.size >= tail.size
                and np.array_equal(e.tokens[:tail.size], tail)
                for e in self._children.get(parent, ()))
            if page and page not in self._page_entry and not covered:
                e = _PrefixEntry(None, parent, page, tail.copy(), False)
                self._children.setdefault(parent, []).append(e)
                self._page_entry[page] = e

    def _index_remove(self, entry: _PrefixEntry) -> None:
        if entry.key is not None:
            self._index.pop(entry.key, None)
        kids = self._children.get(entry.parent)
        if kids is not None:
            try:
                kids.remove(entry)
            except ValueError:
                pass
            if not kids:
                del self._children[entry.parent]
        self._page_entry.pop(entry.page, None)

    def shed_cached(self, n: Optional[int] = None) -> int:
        """Proactively reclaim up to ``n`` (``None`` = all) cached-LRU
        refcount-0 pages to the free list, oldest-first (the decode
        engine calls this at admission once the HBM pressure governor
        leaves green). Distinct from demand reclaim inside
        ``_take_page`` (which takes cached pages only when a reservation
        needs them): shedding trades warm prefix capacity for free-list
        headroom *before* anything asks, so an admission under pressure
        never has to choose between deferring and evicting. Touches only
        pages no live sequence references — sequences in flight are
        unaffected. Returns the number of pages shed and counts them in
        ``mxnet_kvcache_pressure_sheds_total{cache=}``."""
        shed = 0
        while self._cached and (n is None or shed < n):
            page, entry = self._cached.popitem(last=False)
            self._index_remove(entry)
            self._free.append(page)
            shed += 1
        if shed:
            self.pressure_sheds += shed
            _T_PRESSURE_SHEDS.inc(shed, cache=self.name)
            self._publish()
        return shed

    def clear_prefix_index(self) -> None:
        """Drop EVERY index entry and return cached (refcount-0) pages
        to the free list. Called when pool *content* stops being
        trustworthy — a weight swap (KV computed under old params must
        not match new-params prompts) or a pool re-zero after eviction.
        Pages still mapped by live slots keep their refcounts and free
        normally later."""
        for page in self._cached:
            self._free.append(page)
        self._cached.clear()
        self._index.clear()
        self._children.clear()
        self._page_entry.clear()
        self._publish()

    # -- write-slot computation (host) -------------------------------------
    def write_slots(self, slot: int, start: int,
                    n_tokens: int) -> Tuple[np.ndarray, np.ndarray]:
        """(pages, offsets) int32 arrays addressing token positions
        ``start .. start+n_tokens`` of ``slot`` — the destinations
        :func:`write_kv` scatters into. Positions must be covered by a
        prior :meth:`reserve`."""
        pos = np.arange(start, start + n_tokens)
        if n_tokens and pos[-1] >= self._owned[slot] * self.page_size:
            raise MXNetError(
                "write past slot %d's reservation (pos %d, %d pages)"
                % (slot, int(pos[-1]), self._owned[slot]))
        pages = self.page_table[slot, pos // self.page_size]
        offsets = (pos % self.page_size).astype(np.int32)
        return pages.astype(np.int32), offsets

    def null_write_slots(self, n_tokens: int) -> Tuple[np.ndarray,
                                                       np.ndarray]:
        """Destinations for rows that must go NOWHERE (inactive decode
        slots, prompt padding, already-cached positions a chunk only
        recomputes): the null page, offset cycling through the page so
        scatter indices stay in range."""
        pos = np.arange(n_tokens)
        return (np.zeros(n_tokens, np.int32),
                (pos % self.page_size).astype(np.int32))

    def swap_pools(self, k_pool, v_pool) -> None:
        """Store ``k_pool``/``v_pool`` as the pools' contents. The JAX
        cache rebinds to the arrays a jitted step returned; here the
        captured graphs hold the pools' addresses, so the contents are
        copied in place (same shapes and dtype, or :class:`MXNetError`)
        and the tensors never change."""
        for dst, src in ((self.k_pool, k_pool), (self.v_pool, v_pool)):
            if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
                raise MXNetError(
                    "swap_pools: pool %s %s does not match the cache's "
                    "%s %s" % (tuple(src.shape), src.dtype,
                               tuple(dst.shape), dst.dtype))
        if k_pool is not self.k_pool:
            self.k_pool.copy_(k_pool)
        if v_pool is not self.v_pool:
            self.v_pool.copy_(v_pool)

    def release_pools(self) -> None:
        """Drop the pools' device memory (a closed engine's cache, whose
        graphs are gone too): afterwards the host allocator and the
        counters still answer, the pools are empty tensors."""
        self.k_pool = self.k_pool.new_empty(0)
        self.v_pool = self.v_pool.new_empty(0)

    def reset_pools(self) -> None:
        """Zero both pools in place (same tensors, same shapes). The
        eviction path calls this after a failed step: every future
        sequence rewrites its pages through prefill before reading them,
        and the prefix index dies with the content it described."""
        self.k_pool.zero_()
        self.v_pool.zero_()
        self.clear_prefix_index()

    def _publish(self) -> None:
        _T_PAGES.set(self.pages_in_use, cache=self.name)
        _T_CACHED.set(self.pages_cached, cache=self.name)
        _T_SHARED.set(self.shared_pages, cache=self.name)
        if self.audit:
            self.audit_check()

    def audit_check(self) -> None:
        """``MXNET_KVCACHE_AUDIT=1``: re-prove the refcount invariant.
        Runs after every mutation (via :meth:`_publish`) and once per
        decode tick from the engine. Raises :class:`MXNetError` on the
        first violated invariant:

        - ``pages_in_use`` equals the number of pages with a live ref;
        - ``sum(ref)`` equals the number of live page-table mappings
          (the first ``owned`` entries of every slot row);
        - the free list holds no duplicates, no null page, no referenced
          page, and is disjoint from the cached-LRU;
        - cached pages all carry refcount 0.
        """
        live_refs = int(np.count_nonzero(self._ref > 0))
        if self.pages_in_use != live_refs:
            raise MXNetError(
                "kvcache %r audit: pages_in_use %d != pages with live "
                "refs %d (free=%d cached=%d) — a release path leaked or "
                "double-counted" % (self.name, self.pages_in_use,
                                    live_refs, len(self._free),
                                    len(self._cached)))
        mappings = sum(self._owned)
        total_ref = int(self._ref.sum())
        if total_ref != mappings:
            raise MXNetError(
                "kvcache %r audit: sum of page refcounts %d != live "
                "page-table mappings %d — refcounts and table rows "
                "disagree" % (self.name, total_ref, mappings))
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            raise MXNetError(
                "kvcache %r audit: duplicate entries on the free list — "
                "one page would be handed to two slots"
                % (self.name,))
        if 0 in free_set:
            raise MXNetError(
                "kvcache %r audit: null page 0 on the free list"
                % (self.name,))
        if free_set & set(self._cached):
            raise MXNetError(
                "kvcache %r audit: page(s) %s on the free list AND in "
                "the cached-LRU" % (self.name,
                                    sorted(free_set & set(self._cached))))
        bad = [p for p in self._free if self._ref[p] > 0]
        if bad:
            raise MXNetError(
                "kvcache %r audit: referenced page(s) %s on the free "
                "list" % (self.name, bad))
        bad = [p for p in self._cached if self._ref[p] != 0]
        if bad:
            raise MXNetError(
                "kvcache %r audit: cached-LRU page(s) %s carry a live "
                "refcount" % (self.name, bad))
        for s in range(self.num_slots):
            if self._exclusive[s] > self._owned[s]:
                raise MXNetError(
                    "kvcache %r audit: slot %d exclusive count %d > "
                    "owned %d" % (self.name, s, self._exclusive[s],
                                  self._owned[s]))

    def stats(self) -> dict:
        out = {
            "pages_in_use": self.pages_in_use,
            "pages_free": self.pages_free,
            "pages_capacity": self.num_pages - 1,
            "page_size": self.page_size,
            "max_pages_per_seq": self.max_pages,
        }
        if self.prefix_cache:
            total = self.prefix_hits + self.prefix_misses
            out.update({
                "prefix_cache": True,
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_hit_ratio": (self.prefix_hits / total
                                     if total else 0.0),
                "prefix_tokens_matched": self.prefix_tokens_matched,
                "pages_cached": self.pages_cached,
                "shared_pages": self.shared_pages,
                "index_entries": len(self._page_entry),
            })
        return out
