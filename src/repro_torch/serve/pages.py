"""Device-resident paged cache pool: host-side allocator, block tables,
copy-on-write prefix sharing, and the Pliant-reclaimable page budget.

A verbatim copy of the JAX package's ``serve/pages.py`` (numpy only): the
port keeps its own copy so that it imports nothing of that package. "Jitted
step" below reads as the port's decode / admission step.

The pool replaces the dense per-slot rings of the serving engine: KV entries
live in a shared physical page pool (``models.attention.PagedKVCache``) and
each slot maps logical pages (position // page_size) to physical pages
through a block table. This module owns everything HOST-side about that
mapping — allocation never happens inside a jitted step:

* **Free-list allocator.** Physical page 0 is the reserved null/trash page
  (unmapped block-table entries point at it and are masked out of attention;
  inactive decode rows scatter into it harmlessly). Pages are refcounted:
  a page is owned by every slot whose block table maps it PLUS the prefix
  index entries that pin it, and returns to the free list at refcount 0.

* **Prefix index (copy-on-write sharing).** Admission registers the longest
  full-page prompt prefix under a key of (knobs, token tuple); a later
  request with the same prefix maps those pages directly into its block
  table (refcount bump — no copy, no recompute) and skips the corresponding
  prefill chunks entirely. Shared pages are immutable by construction: only
  FULL prompt pages are ever shared, lookups cap at ``len(prompt) - 1``
  tokens so at least one token always re-prefills into a private tail page,
  and decode writes only ever land in private pages — so "copy-on-write"
  never needs a write fault, the tail is simply never shared. For archs with
  Mamba layers the entry also carries the host snapshot of the per-slot SSM
  state at the prefix boundary, restored on a hit.

* **Grouped / speculative allocation.** ``admit(..., reserve_tokens=n)``
  allocates the prompt's pages AND the request's projected decode pages in
  ONE all-or-nothing free-list transaction, so the continuous-batching hot
  loop never touches the allocator between decode steps (``_push_blocks``
  churn drops to admission boundaries). When the full group does not fit
  the pool falls back to prompt-only (``ensure_decode_page`` then grows
  lazily, as before). ``replenish`` is the watermark-based background
  reservation: called by the engine BETWEEN steps, it evicts LRU prefix
  entries whenever allocatable headroom drops below the low watermark —
  moving eviction churn off the admission path.

* **Slot-affinity sharding (multi-device pools).** With ``n_shards`` > 1 the
  physical page range splits into contiguous per-device shards (shard ``s``
  owns pages ``[s * shard_pages, (s+1) * shard_pages)``, whose first page is
  that shard's reserved null page) and every slot is pinned to the shard
  ``slot * n_shards // batch_slots`` — the SAME contiguous split GSPMD uses
  when the pool's page dim and the block table's slot dim are sharded over
  the batch mesh axes. All of a slot's pages (private, prefix-shared, and
  speculative alike) come from its own shard, so inside ``shard_map`` each
  device resolves its slots' block tables entirely against local pages: the
  fused decode kernel runs per-shard with zero collectives, and the
  dynamic-index cache write becomes legal under the mesh. The prefix index
  is shard-local too (keys are shard-tagged): sharing never migrates a page
  across devices. ``n_shards=1`` reduces exactly to the layout above.

* **Reclaimable budget (the ``pool_pages`` Pliant knob).** ``set_reclaimed``
  shrinks the allocatable-page limit in quanta; shrinking evicts prefix
  index entries (LRU) — the approximation-tolerant pages, in Pliant terms —
  and blocks NEW admissions while over budget, but never touches pages owned
  by live requests (growth for an in-flight decode is always honored), so a
  shrink/regrow round-trip cannot corrupt an in-flight request. The serve
  engine wires this to ``PliantRuntime`` RECLAIM/RETURN actions.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class PageSpec:
    """Static shape of a paged cache pool (the engine's cache-spec)."""
    page_size: int       # tokens per page
    n_pages: int         # physical pages, INCLUDING the reserved null pages
    max_pages: int       # logical pages per slot (ceil(max_len / page_size))
    n_shards: int = 1    # slot-affinity device shards (1 = unsharded pool)

    @property
    def usable(self) -> int:
        return self.n_pages - self.n_shards

    @property
    def shard_pages(self) -> int:
        """Physical pages per shard (the first one is that shard's null)."""
        return self.n_pages // self.n_shards


def spec_for(batch_slots: int, max_len: int, page_size: int = 8,
             n_pages: int = 0, n_shards: int = 1) -> PageSpec:
    """Default pool sizing: every slot can hold a full ``max_len`` sequence,
    plus one sequence's worth of slack per shard for the prefix cache.
    ``n_pages`` is rounded up to a multiple of lcm(8, n_shards) so the
    physical page dim stays shardable (``dist.sharding.cache_shardings``)
    AND splits evenly into the slot-affinity shards."""
    import math
    max_pages = -(-max_len // page_size)
    if n_pages <= 0:
        n_pages = n_shards + (batch_slots + n_shards) * max_pages
    mult = 8 * n_shards // math.gcd(8, n_shards)
    n_pages = -(-n_pages // mult) * mult
    return PageSpec(page_size, n_pages, max_pages, n_shards)


class CacheStore:
    """Minimal per-slot cache-residency protocol the engine drives.

    ``PagePool`` implements it for paged attention state; ``MambaSlotStore``
    for the dense per-slot SSM state (which has nothing to allocate — one
    row per slot, always resident — but sits behind the same surface so the
    engine frees/queries every cache kind uniformly)."""

    def free_slot(self, slot: int) -> bool:
        """Release slot-owned residency. Returns True if device-visible
        mapping state changed (the engine must re-push block tables)."""
        raise NotImplementedError

    def occupancy(self) -> float:
        raise NotImplementedError


class MambaSlotStore(CacheStore):
    """Per-slot dense state store: state travels with the slot row, so
    freeing is a no-op (the next admission overwrites it)."""

    def free_slot(self, slot: int) -> bool:
        return False

    def occupancy(self) -> float:
        return 1.0


@dataclass
class PrefixEntry:
    pages: Tuple[int, ...]       # physical pages of the shared prefix
    n_tokens: int                # page-aligned prefix length
    mamba: Any = None            # host SSM-state snapshot at the boundary
    last_use: int = 0
    hits: int = 0


@dataclass
class AdmitPlan:
    shared_tokens: int           # prompt tokens whose prefill is skipped
    entry: Optional[PrefixEntry]
    register: List[int]          # page boundaries to snapshot+register
    reserved_pages: int = 0      # speculative decode pages mapped up front


class PagePool(CacheStore):
    def __init__(self, spec: PageSpec, batch_slots: int,
                 reclaim_quantum: int = 0, max_register_pages: int = 64):
        self.spec = spec
        self.batch_slots = batch_slots
        # bound on registered boundaries per prompt: caps index growth, the
        # per-entry pages tuples, and (hybrid archs) the per-boundary SSM
        # snapshots an admission pauses for — prompts share at most this
        # many leading pages (stats["register_capped"] counts the overflow)
        self.max_register_pages = max_register_pages
        assert spec.n_pages % spec.n_shards == 0, spec
        assert batch_slots % spec.n_shards == 0, \
            (batch_slots, spec.n_shards, "slot affinity needs an even split")
        # per-shard free lists: page s*shard_pages is shard s's reserved null
        self._free: List[collections.deque] = [
            collections.deque(range(s * spec.shard_pages + 1,
                                    (s + 1) * spec.shard_pages))
            for s in range(spec.n_shards)]
        self.ref = np.zeros(spec.n_pages, np.int32)
        self.blocks = np.zeros((batch_slots, spec.max_pages), np.int32)
        self.slot_pages: List[List[int]] = [[] for _ in range(batch_slots)]
        self.index: Dict[tuple, PrefixEntry] = {}
        self.quantum = reclaim_quantum or spec.max_pages
        self.reclaimed = 0
        # capacity cut (CapacityEvent QUOTA_CUT quanta): an EXTERNAL floor on
        # the budget, deliberately separate from ``reclaimed`` — the Pliant
        # arbiter's ledger must track only its own actuations, or a quota
        # grab would desync it from the quanta it believes it can return
        self.capacity_cut = 0
        self.scrub_pending: List[int] = []   # fully-freed pages: stale device
        self._clock = 0                      # ppos must be cleared before reuse
        self.stats: Dict[str, Any] = dict(
            allocs=0, frees=0, prefix_hits=0, prefix_misses=0,
            prefix_registered=0, prefix_evicted=0, tokens_skipped=0,
            blocked_admissions=0, reclaim_events=0, over_limit_allocs=0,
            register_capped=0, peak_used=0, window_freed=0,
            grouped_admissions=0, grouped_pages=0, grouped_fallbacks=0,
            replenish_evictions=0, capacity_cut_events=0,
            elastic_migrations=0, elastic_prefix_evicted=0)

    # --------------------------------------------------------- accounting --

    @property
    def free(self) -> List[int]:
        """Flattened free list across shards (read-only audit view)."""
        return [p for dq in self._free for p in dq]

    def slot_shard(self, slot: int) -> int:
        """The device shard that owns ``slot``'s pages: the contiguous split
        GSPMD applies when the block table's slot dim is batch-sharded."""
        return slot * self.spec.n_shards // self.batch_slots

    def page_shard(self, pid: int) -> int:
        return pid // self.spec.shard_pages

    @property
    def used(self) -> int:
        return self.spec.usable - sum(len(dq) for dq in self._free)

    @property
    def limit(self) -> int:
        return max(self.spec.usable
                   - (self.reclaimed + self.capacity_cut) * self.quantum, 0)

    @property
    def max_quanta(self) -> int:
        """Reclaim budget exposed to the controller: the slack above one
        live sequence per slot, in quanta (>= 1 so the knob always exists)."""
        slack = self.spec.usable - self.batch_slots * self.spec.max_pages
        return max(1, slack // self.quantum)

    def occupancy(self) -> float:
        return self.used / max(self.spec.usable, 1)

    def live_slot_pages(self) -> int:
        return sum(len(p) for p in self.slot_pages)

    # --------------------------------------------------------- allocation --

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _alloc(self, shard: int = 0, *, for_live: bool = False
               ) -> Optional[int]:
        """Pop a free physical page of ``shard`` (refcount 1). Evicts LRU
        prefix entries under pressure — any shard's entries relieve the
        global reclaim budget, but only ``shard``'s entries can refill its
        free list (pages never migrate). ``for_live`` allocations (decode
        growth of an in-flight request) may exceed the reclaim limit —
        reclamation must never corrupt a live request."""
        if not for_live:
            while self.used >= self.limit and self.index:
                self._evict_lru()
            if self.used >= self.limit:
                return None
        while not self._free[shard]:
            if not self._evict_lru(shard):
                break
        if not self._free[shard]:
            return None
        if self.used >= self.limit:
            self.stats["over_limit_allocs"] += 1
        pid = self._free[shard].popleft()
        self.ref[pid] = 1
        self.stats["allocs"] += 1
        self.stats["peak_used"] = max(self.stats["peak_used"], self.used)
        return pid

    def _alloc_n(self, n: int, shard: int = 0, *, for_live: bool = False
                 ) -> Optional[List[int]]:
        """Allocate ``n`` pages of ``shard`` as ONE all-or-nothing free-list
        transaction: either all ``n`` come back (each refcount 1) or the free
        list and refcounts are left exactly as found — partially-grabbed
        pages were never written, so the rollback is an exact undo (no
        deref/scrub bookkeeping). The grouped-allocation primitive ``admit``
        builds on."""
        got: List[int] = []
        for _ in range(n):
            pid = self._alloc(shard, for_live=for_live)
            if pid is None:
                for p in reversed(got):
                    self.ref[p] = 0
                    self._free[shard].appendleft(p)
                self.stats["allocs"] -= len(got)
                return None
            got.append(pid)
        return got

    def _deref(self, pid: int) -> None:
        self.ref[pid] -= 1
        assert self.ref[pid] >= 0, pid
        if self.ref[pid] == 0:
            self._free[self.page_shard(pid)].append(pid)
            self.scrub_pending.append(pid)
            self.stats["frees"] += 1

    def drain_scrub(self) -> List[int]:
        """Pages freed since the last drain. Their device-side ``ppos`` rows
        still hold the previous tenant's positions, which would alias as
        valid entries for a new tenant at a different logical page — the
        engine sets them to -1 before the next jitted step."""
        out, self.scrub_pending = self.scrub_pending, []
        return out

    # ------------------------------------------------------- prefix index --

    def _chain_keys(self, prompt: Sequence[int], tag,
                    n_pages: int, shard: int = 0) -> List[int]:
        """Chained per-page index keys: ``key_i = hash((key_{i-1}, page_i
        tokens))`` — O(1) index storage per boundary instead of the full
        token tuple (which made a 32k prompt cost O(S^2/P) key memory), the
        vLLM block-hash scheme. 64-bit collisions are accepted as
        negligible. Keys are shard-tagged: a prefix registered on one shard
        must never be mapped into a slot on another (its pages would not be
        device-local there), so each shard keeps its own index namespace."""
        P = self.spec.page_size
        keys, prev = [], hash((id(type(self)), tag, shard))
        for i in range(n_pages):
            prev = hash((prev,
                         tuple(int(t) for t in prompt[i * P:(i + 1) * P])))
            keys.append(prev)
        return keys

    def lookup_prefix(self, prompt: Sequence[int], tag, shard: int = 0
                      ) -> Tuple[int, Optional[PrefixEntry]]:
        """Deepest registered full-page prefix of ``prompt`` under ``tag``
        on ``shard``, capped at ``len(prompt) - 1`` tokens so admission
        always re-prefills at least the last token (its logits seed
        sampling). Pure lookup: hit/LRU bookkeeping happens in ``admit``
        only when the admission commits, so a blocked request retried every
        engine step does not inflate the hit-rate metrics or refresh the
        entry's LRU clock."""
        P = self.spec.page_size
        n = min((len(prompt) - 1) // P, self.max_register_pages)
        best: Tuple[int, Optional[PrefixEntry]] = (0, None)
        for i, key in enumerate(self._chain_keys(prompt, tag, n, shard)):
            e = self.index.get(key)
            if e is not None:          # chains may have gaps (eviction/cap):
                best = ((i + 1) * P, e)  # deepest present boundary wins
        return best

    def register_prefix(self, slot: int, prompt: Sequence[int], tag,
                        n_tokens: int, mamba=None) -> None:
        """Pin the slot's first ``n_tokens // page_size`` pages as a shared
        prefix (idempotent per key; boundaries past ``max_register_pages``
        are not indexed)."""
        P = self.spec.page_size
        assert n_tokens % P == 0 and n_tokens > 0, n_tokens
        if n_tokens // P > self.max_register_pages:
            self.stats["register_capped"] += 1
            return
        key = self._chain_keys(prompt, tag, n_tokens // P,
                               self.slot_shard(slot))[-1]
        if key in self.index:
            return
        pages = tuple(int(p) for p in self.blocks[slot, : n_tokens // P])
        assert all(p != 0 for p in pages), (slot, pages)
        for p in pages:
            self.ref[p] += 1
        self.index[key] = PrefixEntry(pages, n_tokens, mamba,
                                      last_use=self._tick())
        self.stats["prefix_registered"] += 1

    def _evict_lru(self, shard: Optional[int] = None) -> bool:
        """Evict the LRU prefix entry (``shard`` filters to entries whose
        pages live on that shard — an entry's pages are always
        shard-homogeneous by construction). Returns False when no candidate
        exists, so shard-local pressure loops terminate even while other
        shards' entries populate the index."""
        keys = [k for k, e in self.index.items()
                if shard is None or self.page_shard(e.pages[0]) == shard]
        if not keys:
            return False
        key = min(keys, key=lambda k: self.index[k].last_use)
        for p in self.index.pop(key).pages:
            self._deref(p)
        self.stats["prefix_evicted"] += 1
        return True

    def flush_prefixes(self) -> None:
        """Drop every prefix entry (variant hot-swaps re-encode the pool in
        place, so cached prefixes no longer match any knob tag)."""
        while self.index:
            self._evict_lru()

    # ----------------------------------------------------------- slot ops --

    def admit(self, slot: int, prompt: Sequence[int], tag, *,
              reserve_tokens: int = 0) -> Optional[AdmitPlan]:
        """Build the slot's block table for ``prompt``: map shared prefix
        pages (refcount bump) and allocate private pages for the remainder.
        Returns None — with no state changed — when the pool is over budget
        (the request stays pending).

        ``reserve_tokens`` > 0 is the grouped/speculative path: the pool
        additionally maps the pages covering that many decode tokens past
        the prompt in the SAME free-list transaction, so the decode loop's
        ``ensure_decode_page`` finds them already mapped and the block table
        is pushed once per admission instead of once per page crossing.
        Reserved pages carry no valid entries yet (their ``ppos`` rows are
        scrubbed to -1, masking them out of attention) and are freed with
        the slot like any other private page. When the full group does not
        fit, admission falls back to prompt-only rather than blocking."""
        P = self.spec.page_size
        assert not self.slot_pages[slot], f"slot {slot} not freed"
        assert len(prompt) <= self.spec.max_pages * P, (len(prompt), self.spec)
        shard = self.slot_shard(slot)
        prompt_pages = -(-len(prompt) // P)
        if prompt_pages > self.spec.shard_pages - 1:
            # structurally impossible — retrying every step would spin the
            # engine through max_steps with the request silently unserved
            raise RuntimeError(
                f"prompt needs {prompt_pages} pages but the pool has "
                f"{self.spec.shard_pages - 1} usable on the slot's shard; "
                "size n_pages up")
        shared, entry = self.lookup_prefix(prompt, tag, shard)
        # feasibility gate BEFORE touching allocator state: a doomed attempt
        # must not evict prefix entries it cannot use. The engine's
        # page-aware packing retries several candidates per step while the
        # pool is blocked — without this gate every failed retry would run
        # _alloc's pressure loop and progressively drain the prefix cache.
        # ``evictable`` counts index pages only the index pins (ref 1):
        # evicting those both lowers ``used`` and refills the free list, so
        # the gate passing guarantees the allocation below succeeds.
        hit_pages = set(entry.pages) if entry is not None else set()
        evict_all = evict_shard = 0
        for e in self.index.values():
            for p in e.pages:
                if self.ref[p] == 1 and p not in hit_pages:
                    evict_all += 1
                    if self.page_shard(p) == shard:
                        evict_shard += 1
        # budget headroom can be relieved by evicting ANY shard's entries;
        # supply headroom only by this shard's free list + evictable pages
        head = min(max(self.limit - self.used, 0) + evict_all,
                   len(self._free[shard]) + evict_shard)
        want_full = min(max(-(-(len(prompt) + reserve_tokens) // P),
                            prompt_pages), self.spec.max_pages)
        n_total = next((c for c in dict.fromkeys([want_full, prompt_pages])
                        if c - shared // P <= head), None)
        if n_total is None:
            self.stats["blocked_admissions"] += 1
            return None
        if n_total < want_full:
            self.stats["grouped_fallbacks"] += 1
        n_new = n_total - shared // P
        if shared:
            # pin the hit pages BEFORE allocating fresh ones: under pressure
            # _alloc's LRU eviction may drop the hit entry itself, and
            # without the slot's ref its pages would be freed (and scrubbed)
            # while this admission is about to map them
            for p in entry.pages:
                self.ref[p] += 1
        fresh = self._alloc_n(n_new, shard)
        if fresh is None:              # unreachable after the gate, kept as
            if shared:                 # a safety net for future drift
                for p in entry.pages:
                    self._deref(p)
            self.stats["blocked_admissions"] += 1
            return None
        if shared:
            entry.hits += 1
            entry.last_use = self._tick()
            self.stats["prefix_hits"] += 1
        else:
            self.stats["prefix_misses"] += 1
        row = self.blocks[slot]
        row[:] = 0
        if shared:
            row[: shared // P] = entry.pages
        row[shared // P: shared // P + n_new] = fresh
        self.slot_pages[slot] = [int(p) for p in row[: shared // P + n_new]]
        self.stats["tokens_skipped"] += shared
        # register every unregistered full-page boundary beyond the shared
        # prefix (bounded by max_register_pages) — a future prompt sharing
        # only the first k pages must still hit (the target workload is
        # shared prefix + divergent tails)
        top = min(len(prompt) // P, self.max_register_pages) * P
        keys = self._chain_keys(prompt, tag, top // P, shard)
        reg = [b for b in range(shared + P, top + 1, P)
               if keys[b // P - 1] not in self.index]
        if len(prompt) // P > self.max_register_pages:
            self.stats["register_capped"] += 1
        reserved = n_total - prompt_pages
        if reserved:
            self.stats["grouped_admissions"] += 1
            self.stats["grouped_pages"] += reserved
        return AdmitPlan(shared, entry, reg, reserved)

    def ensure_decode_page(self, slot: int, position: int) -> bool:
        """Map the page holding ``position`` before a decode write lands
        there. Returns True when the block table changed (engine re-pushes).
        Live-request growth bypasses the reclaim limit by design."""
        P = self.spec.page_size
        lp = position // P
        if lp >= self.spec.max_pages:
            raise RuntimeError(
                f"slot {slot}: position {position} overflows the block table "
                f"({self.spec.max_pages} pages x {P}); paged serving does not "
                f"ring-wrap — size max_len >= prompt + max_new")
        if self.blocks[slot, lp] != 0:
            return False
        pid = self._alloc(self.slot_shard(slot), for_live=True)
        if pid is None:
            raise RuntimeError("page pool exhausted mid-decode "
                               f"(used={self.used}/{self.spec.usable})")
        self.blocks[slot, lp] = pid
        self.slot_pages[slot].append(pid)
        return True

    def ensure_decode_range(self, slot: int, start_pos: int,
                            end_pos: int) -> bool:
        """Host mirror of the megastep's in-scan cursor growth: map every
        page touched by decode writes at positions ``[start_pos, end_pos)``
        BEFORE the fused K-step executable is dispatched — the scan advances
        the cursor on device, so no per-token host round-trip exists to
        fault pages in lazily. Same live-growth semantics as
        ``ensure_decode_page`` (bypasses the reclaim limit, raises on
        exhaustion). Returns True when the block table changed (engine
        re-pushes before dispatch)."""
        if end_pos <= start_pos:
            return False
        P = self.spec.page_size
        changed = False
        for lp in range(start_pos // P, (end_pos - 1) // P + 1):
            changed |= self.ensure_decode_page(slot, lp * P)
        return changed

    def release_window_pages(self, slot: int, min_pos: int) -> bool:
        """Free the slot's leading pages that fell out of the attention
        window: every entry at position <= ``min_pos`` is masked by EVERY
        layer (the caller guarantees the arch is banded-only), so pages
        wholly at-or-below that boundary are dead weight. Deref + unmap
        them; prefix-index pins keep shared pages alive for future hits.
        Returns True when the block table changed (engine re-pushes)."""
        P = self.spec.page_size
        changed = False
        for lp in range(self.spec.max_pages):
            if (lp + 1) * P - 1 > min_pos:
                break                        # first page still in the band
            pid = int(self.blocks[slot, lp])
            if pid == 0:
                continue                     # already freed earlier
            self.blocks[slot, lp] = 0
            self.slot_pages[slot].remove(pid)
            self._deref(pid)
            self.stats["window_freed"] += 1
            changed = True
        return changed

    def free_slot(self, slot: int) -> bool:
        if not self.slot_pages[slot]:
            return False
        for p in self.slot_pages[slot]:
            self._deref(p)
        self.slot_pages[slot] = []
        self.blocks[slot] = 0
        return True

    # --------------------------------------------------------- background --

    def replenish(self, *, low: Optional[int] = None,
                  high: Optional[int] = None) -> int:
        """Watermark-based background reservation: keep immediately
        allocatable headroom (free pages under the reclaim limit) above a
        low watermark by evicting LRU prefix entries, topping back up to the
        high watermark. The engine calls this BETWEEN steps, so the eviction
        churn that ``_alloc`` would otherwise run inside an admission
        happens off the hot path. Returns the number of entries evicted."""
        if low is None:
            low = max(1, self.spec.usable // 8)
        if high is None:
            high = min(2 * low, self.spec.usable)
        # per-shard watermarks: headroom on one shard cannot serve another's
        # admissions, so each shard keeps its own share of the reservation
        # (ceil split keeps n_shards=1 behavior identical)
        ns = self.spec.n_shards
        lo, hi = -(-low // ns), -(-high // ns)

        def headroom(s: int) -> int:
            return min(len(self._free[s]), max(self.limit - self.used, 0))

        evicted = 0
        for s in range(ns):
            if headroom(s) >= lo:
                continue
            while headroom(s) < hi and self._evict_lru(s):
                evicted += 1
        self.stats["replenish_evictions"] += evicted
        return evicted

    def assert_consistent(self) -> None:
        """Audit the allocator invariants (test hook): every physical page
        is either free (refcount 0, unmapped, unpinned) or accounted for
        EXACTLY by slot mappings + prefix-index pins — so no sequence of
        grouped/speculative admissions, watermark evictions, completions,
        and reclaims can strand a page."""
        want: collections.Counter = collections.Counter()
        for pages in self.slot_pages:
            want.update(pages)
        for e in self.index.values():
            want.update(e.pages)
        flat = self.free
        free = set(flat)
        nulls = {s * self.spec.shard_pages for s in range(self.spec.n_shards)}
        assert len(free) == len(flat), "free list holds duplicates"
        assert not (nulls & free), "null page on a free list"
        for s, dq in enumerate(self._free):
            for p in dq:
                assert self.page_shard(p) == s, \
                    (p, s, "free page on the wrong shard's list")
        for pid in range(self.spec.n_pages):
            if pid in nulls:
                assert self.ref[pid] == 0 and want[pid] == 0, \
                    (pid, "null page allocated or mapped")
                continue
            if pid in free:
                assert self.ref[pid] == 0 and want[pid] == 0, \
                    (pid, int(self.ref[pid]), want[pid])
            else:
                assert int(self.ref[pid]) == want[pid] > 0, \
                    (pid, int(self.ref[pid]), want[pid])
        for slot in range(self.batch_slots):
            mapped = sorted(int(p) for p in self.blocks[slot] if p != 0)
            assert mapped == sorted(self.slot_pages[slot]), \
                (slot, mapped, self.slot_pages[slot])
            # slot affinity: every page a slot maps lives on its own shard,
            # so inside shard_map the block row resolves device-locally
            for p in self.slot_pages[slot]:
                assert self.page_shard(p) == self.slot_shard(slot), \
                    (slot, p, "page mapped across shards")
        for e in self.index.values():
            shards = {self.page_shard(p) for p in e.pages}
            assert len(shards) == 1, (e.pages, "prefix entry spans shards")

    # ------------------------------------------------------------ reclaim --

    def set_reclaimed(self, k: int) -> None:
        """Actuate the ``pool_pages`` knob: budget = usable - k * quantum.
        Shrinking evicts prefix entries until under budget (live pages are
        untouchable); both directions are recorded as reclaim events."""
        k = max(0, min(int(k), self.max_quanta))
        if k == self.reclaimed:
            return
        grow = k < self.reclaimed
        self.reclaimed = k
        evicted = 0
        while self.used > self.limit and self.index:
            self._evict_lru()
            evicted += 1
        self.stats["reclaim_events"] += 1
        self.stats.setdefault("reclaim_log", []).append(dict(
            action="grow" if grow else "shrink", reclaimed=k,
            limit=self.limit, used=self.used, evicted=evicted))

    def set_capacity_cut(self, k: int) -> None:
        """Actuate a QUOTA_CUT/QUOTA_RESTORE capacity event: ``k`` quanta of
        the pool are externally gone (a co-tenant's emergency grab), on top
        of whatever the arbiter has reclaimed. Same semantics as
        ``set_reclaimed`` — prefix entries evicted until under the new
        budget, live pages untouchable — but tracked separately so the
        Pliant ledger never has to account for quanta it did not take."""
        k = max(0, int(k))
        if k == self.capacity_cut:
            return
        self.capacity_cut = k
        evicted = 0
        while self.used > self.limit and self.index:
            self._evict_lru()
            evicted += 1
        self.stats["capacity_cut_events"] += 1
        self.stats.setdefault("capacity_log", []).append(dict(
            capacity_cut=k, limit=self.limit, used=self.used,
            evicted=evicted))

    # ------------------------------------------------------------- elastic --

    def migrate(self, spec: PageSpec) -> Tuple["PagePool", np.ndarray]:
        """Re-home every live slot's pages into a FRESH pool laid out by
        ``spec`` — the shard-count / pool-size change after a capacity event
        re-derives the slot-affinity decode plan. Returns ``(new_pool,
        perm)`` where ``perm[new_pid] = old_pid`` names the physical page
        whose contents must be copied there (-1 = no source, the page starts
        empty); the engine applies ``perm`` to the device-side page arrays.

        Live slots keep their logical block layout bit-for-bit; only the
        physical homes change, every page re-allocated on its slot's NEW
        affinity shard. A page shared by several slots (prefix hit) is
        duplicated — copy-on-write collapses to copies. Prefix-index entries
        are EVICTED, never migrated: keys are shard-tagged chained hashes
        and entries do not retain their tokens, so a re-homed entry could
        not be re-keyed for its new shard — the loss is cold misses
        (``stats["elastic_prefix_evicted"]``), never corruption. Allocation
        runs ``for_live`` (capacity floors must not block the move) and
        raises only when a slot's pages physically cannot fit its new
        shard — callers size pools so one full sequence per slot always
        fits (``spec_for`` guarantees it)."""
        assert spec.page_size == self.spec.page_size \
            and spec.max_pages == self.spec.max_pages, (spec, self.spec)
        new = PagePool(spec, self.batch_slots, reclaim_quantum=self.quantum,
                       max_register_pages=self.max_register_pages)
        carried = {k: v for k, v in self.stats.items()}
        carried["elastic_migrations"] = \
            self.stats["elastic_migrations"] + 1
        carried["elastic_prefix_evicted"] = \
            self.stats["elastic_prefix_evicted"] + len(self.index)
        new.stats.update(carried)
        new.reclaimed = min(self.reclaimed, new.max_quanta)
        new.capacity_cut = self.capacity_cut
        perm = np.full(spec.n_pages, -1, np.int64)
        for slot in range(self.batch_slots):
            shard = new.slot_shard(slot)
            for lp in range(self.spec.max_pages):
                old_pid = int(self.blocks[slot, lp])
                if old_pid == 0:
                    continue
                new_pid = new._alloc(shard, for_live=True)
                if new_pid is None:
                    raise RuntimeError(
                        f"migrate: slot {slot}'s pages do not fit shard "
                        f"{shard} of {spec} — pool sized too small for the "
                        "live set")
                new.blocks[slot, lp] = new_pid
                new.slot_pages[slot].append(new_pid)
                perm[new_pid] = old_pid
        return new, perm
