"""Batched serving engine: continuous-batching slots over the decode step,
run under Pliant control. Counterpart of the single-device path of the JAX
package's ``serve/engine.py``, with its two cache data models, selected by
``paged``:

* **dense** (the default, as in the JAX package): per-slot rings,
  ``max_len`` wide (a local layer's ``min(window, max_len)``), written at
  one cursor shared by every slot. Admission is synchronous: the prompt
  streams through fixed-size chunks (``serve.prefill.prefill_chunk``) into
  a fresh single-request cache, which ``serve.slots.insert_request``
  rotates by the cursors' difference into the slot's row, and the first
  token is sampled; then every slot decodes in one ``lm.decode_step``
  (free slots too, at stale positions, their output unread), and the host
  samples from the (B, V) logits. A ``kv_quant`` swap converts the rings.
  There is no page pool (``pool`` is None) and no megastep.
* **paged**: the rest of this docstring.

KV entries live in a shared physical page pool with per-slot block tables
(``serve.pages.PagePool`` owns allocation host-side). Admission is chunked
prefill straight into the pool, stall-free: every free slot opens its own
in-flight admission each step, and the step advances them round-robin under
a QoS-aware chunk budget (one chunk per step while any decoder is live,
unless the attached runtime's monitor reports p99 inside the ``qos_guard``
band). Shared prompt prefixes map copy-on-write and skip their chunks;
admission reserves the request's decode pages up front. Each step decodes
every live slot in one batched ``lm.decode_step`` (admitting slots ride
along inactive, their cache writes parked on the null page) with greedy
argmax fused on the device, so only (B,) token ids cross to the host.

Serving variants come from a ``VariantTable`` (the explorer's serving
ladder); the active one is swapped at a step boundary, converting the pool
when the swap crosses the ``kv_quant`` boundary. With a ``PliantRuntime``
attached, the engine feeds per-token latency to its monitor, ticks it at
step boundaries and receives its decisions through the ``ServeTenant``
protocol (``request_variant``, deferred while an admission is in flight);
RECLAIM/RETURN shrink and regrow the pool's page budget.

The engine runs on ``device`` (CUDA unless the caller asks for the CPU);
on the card the paged decode attention and the int8 matmuls are the
hand-written kernels, on the CPU their plain versions. Dense decode
attention is ``_sdpa`` over the ring in plain PyTorch on both, as the JAX
package computes it outside any Pallas kernel. Caches update in place.

Mamba layers (mamba2, zamba2's hybrid) keep one ``MambaCache`` row a slot
(conv histories and the fp32 SSD state) beside the rings or the pool.
Admission runs each chunk's scan through the ``ssd_scan`` kernel with the
state in and out; decode updates the rows in plain PyTorch (the JAX
package's ``mamba_decode`` is outside any Pallas kernel), where-masked for
inactive rows. On the paged engine a fresh
admission zeroes the slot's rows, or seeds them from the prefix entry's
snapshot on a hit, and prefill pauses at every boundary it registers so
that the boundary's snapshot matches the prefix it is registered under. A
snapshot is a host copy of the slot's rows (on the card into pinned memory
without blocking: taking one makes no host sync and holds no device
memory); the prefix index evicts LRU entries past ``SNAPSHOT_BUDGET``
bytes of them (60 MB a boundary at zamba2-2.7b width).

With ``megastep_k`` > 0 the paged engine decodes in megasteps, the twin
of the JAX package's megastep pipeline: one dispatch fuses up to K decode
steps with on-device sampling (greedy, or threefry keyed by (seed, uid,
draw)) and EOS/budget stop masking, the carry (cur, pos, alive, uids,
draws, budget) chains on the device between dispatches in static tensors,
and the host loop is double-buffered: dispatch N+1 is issued before
megastep N is drained. On the card a megastep of K is K back-to-back
replays of one CUDA graph of the decode step per variant, each writing its
token into column j of a (B, megastep_k) buffer, and the tokens reach the
host through a pinned buffer and an event; on the CPU the same step runs K
times eagerly. Graphs hold raw addresses, so a variant swap (the only
place the caches are rebuilt) flushes the pipeline and drops every graph,
and a graph whose cached int8 weights were dropped is recaptured before it
could replay over freed memory.

With a ``mesh`` (``launch.mesh.Mesh``, every position on ``device``),
admission chunks (dense or paged) run their attention as a sequence ring
when ``dist.sharding.prefill_plan`` finds a layout for the chunk length
(``ring_chunk_attention``, the ``ring_hop`` kernel on the card): the plan is
derived once for ``prefill_chunk`` and again by the chunk cell for each
chunk length, so a ragged tail re-plans and a tail shorter than the shard
count takes the loud single-device path. Decode stays single-device.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, List, NamedTuple, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.approx.knobs import PRECISE, ApproxKnobs
from repro_torch.configs.base import LOCAL_ATTN, MAMBA, ModelConfig
from repro_torch.core import tenant as tenant_mod
from repro_torch.core.controller import headroom_burst
from repro_torch.core.runtime import PliantRuntime
from repro_torch.core.variants import VariantTable
from repro_torch.dist.sharding import prefill_plan
from repro_torch.kernels import int8_matmul, paged_attention, quantize_rows
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_mod
from repro_torch.models import lm
from repro_torch.models.common import resolve_device
from repro_torch.models.mamba2 import MambaCache
from repro_torch.serve import pages as pages_mod
from repro_torch.serve import prefill as prefill_mod
from repro_torch.serve import slots as slots_mod
from repro_torch.train import step as step_mod

# the kernels a decode step can launch: a graph's capture counts their
# launches once, and each replay launches them again
_DECODE_KERNELS = {"paged_attention": paged_attention,
                   "int8_matmul": int8_matmul, "quantize_rows": quantize_rows}


def _decode_launches() -> Dict[str, int]:
    return {name: mod.launches for name, mod in _DECODE_KERNELS.items()}


# bytes of SSM snapshots (host memory) the paged engine's prefix index
# holds: ~140 boundaries at zamba2-2.7b width, two prompts' worth
SNAPSHOT_BUDGET = 8 << 30


@dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False
    t_arrival: float = 0.0    # driver-set (open-loop client)
    t_enqueue: float = 0.0    # stamped by submit(): admission-timeout clock
    t_admit_start: float = 0.0  # first prefill chunk issued (queue-wait ends)
    t_admit: float = 0.0      # admission COMPLETION (prefill done, slot live)
    admit_compute_s: float = 0.0  # prefill compute time of the admission
    token_times: List[float] = field(default_factory=list)
    rejected: bool = False    # structured rejection (never silently dropped)
    rejection: Optional["AdmissionTimeout"] = None


@dataclass(frozen=True)
class AdmissionTimeout:
    """Structured admission rejection: the request waited in the queue past
    ``admission_timeout_s`` without ever fitting the pool."""
    uid: int
    waited_s: float
    queue_depth: int       # pending queue length at rejection time
    step: int              # engine step at which the timeout fired


@dataclass
class _Admission:
    """One in-flight background admission: the prompt's prefill progress,
    advanced chunk by chunk under the per-step QoS budget."""
    req: Request
    slot: int
    next: int                    # next prompt index to prefill
    stops: List[int]             # ascending pause points; last == len(prompt)
    mamba_register: List[int]    # boundaries registered WITH an SSM snapshot
    tail_register: List[int]     # prefix boundaries registered on completion
    logits: object = None
    compute_s: float = 0.0
    started: bool = False        # first chunk issued (queue-wait ends then)


class _Carry(NamedTuple):
    """The megastep's device carry, in ``make_paged_megastep``'s argument
    order: (B,) int32 but ``alive`` (bool)."""
    cur: torch.Tensor
    pos: torch.Tensor
    alive: torch.Tensor
    uids: torch.Tensor
    draws: torch.Tensor
    budget: torch.Tensor


@dataclass
class _MegastepGraph:
    """One variant's captured megastep body (one decode step, its token
    written into column ``_col`` of the token buffer)."""
    graph: object                 # torch.cuda.CUDAGraph
    drops: int                    # ops.weight_cache_drops at capture
    stats: dict                   # variant, capture_s, launches, replays


@dataclass
class ServeEngine:
    cfg: ModelConfig
    batch_slots: int
    max_len: int
    knobs: ApproxKnobs = PRECISE       # single-variant mode (no table)
    temperature: float = 0.0           # 0.0 = greedy
    params: object = None              # models.lm ParamTree
    table: Optional[VariantTable] = None
    runtime: Optional[PliantRuntime] = None
    prefill_chunk: int = 16
    seed: int = 0
    cache_dtype: object = torch.float32
    paged: bool = False                # paged pool instead of dense rings
    page_size: int = 8
    n_pages: int = 0                   # 0 = auto (serve.pages.spec_for)
    pack_window: int = 4               # pending requests scanned per slot
    max_head_skips: int = 64           # then admit strict FIFO
    max_admission_chunks: int = 4      # chunk burst when no decoder needs
                                       # protecting (or QoS headroom)
    qos_guard: float = 0.25            # burst only while p99 <= (1-guard)*QoS
    admission_timeout_s: float = 0.0   # 0 = wait forever
    backoff_base: int = 1              # steps before retrying a pool-blocked
    backoff_cap: int = 8               # request; doubles per failure, capped
    eos_id: int = -1                   # stop-token id (-1 = none): a row
                                       # emitting it finishes early, on the
                                       # device mid-megastep or on the host
                                       # in the per-step path
    megastep_k: int = 0                # > 0: fuse up to K decode steps per
                                       # dispatch (on-device sampling, EOS/
                                       # budget stop masking, async double-
                                       # buffered host loop; a replayed CUDA
                                       # graph on the card); paged engines
                                       # only. 0 = per-step
    sync_timing: bool = False          # drain each megastep before
                                       # dispatching the next: no pipeline
                                       # overlap, but per-token stamps
                                       # measure compute, not enqueue
    device: object = "cuda"
    mesh: object = None                # launch.mesh.Mesh: ring admission

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.mesh is not None and self.mesh.device.type != \
                self.device.type:
            raise ValueError(f"mesh on {self.mesh.device}, engine on "
                             f"{self.device}")
        self._derive_plans()
        assert self.params is not None, "ServeEngine needs params"
        self.params = self.params.to(self.device)
        if self.runtime is not None:
            self.table = self.runtime.table
        self._variant_knobs = ([v.knobs for v in self.table.variants]
                               if self.table is not None else [self.knobs])
        self._active = 0
        if self.megastep_k:
            assert self.paged, "megastep decode requires the paged engine"
        self.pool: Optional[pages_mod.PagePool] = None
        self._page_spec = None
        if self.paged:
            self._page_spec = pages_mod.spec_for(
                self.batch_slots, self.max_len, self.page_size, self.n_pages)
            self.pool = pages_mod.PagePool(
                self._page_spec, self.batch_slots,
                snapshot_budget=SNAPSHOT_BUDGET)
        # greedy paged engines take argmax on the device: the step returns
        # (B,) token ids, so the host never pulls (B, V) logits
        self._fused_sample = self.paged and self.temperature <= 0.0
        self.caches = self._init_caches(self.active_knobs.kv_quant)
        self.positions = np.zeros(self.batch_slots, np.int32)
        self.slots: List[Optional[Request]] = [None] * self.batch_slots
        self.pending: Deque[Request] = collections.deque()
        # in-flight admissions keyed by slot (insertion = admission order)
        self._admissions: Dict[int, _Admission] = {}
        # admissions whose last chunk ran but whose first token is not yet
        # sampled: that happens at the step's single drain point
        self._await_admit: Dict[int, _Admission] = {}
        self._head_skips = 0           # consecutive pool-blocked head skips
        # window-exit page freeing is sound only when EVERY attention layer
        # is banded (Mamba layers hold no pages)
        self._window_free = (self.cfg.window if self.paged and self.cfg.window
                             and set(self.cfg.pattern) <= {LOCAL_ATTN, MAMBA}
                             else 0)
        self.cur_tokens = np.zeros(self.batch_slots, np.int32)
        # ---- megastep pipeline state (megastep_k > 0) ----
        self._megasteps: Dict[Tuple[int, int], object] = {}  # (variant, k)
        self._graph: Optional[_MegastepGraph] = None  # the active
                                       # variant's, on the card
        self.graph_log: List[dict] = []   # every capture's stats
        self._inflight: Optional[dict] = None  # dispatched, undrained
        self._carry: Optional[_Carry] = None   # the device carry while it
                                       # holds the rows; None = cold-start
                                       # from the host mirrors
        self._inject_slots: Set[int] = set()   # slots (re)activated since
                                       # the last dispatch: their carry rows
                                       # merge from the host
        self._uids = np.zeros(self.batch_slots, np.int32)  # sampler stream
        self._pos_ub = np.zeros(self.batch_slots, np.int32)  # exclusive ub
                                       # on positions in-flight megasteps
                                       # may write (page pre-map horizon)
        self.decode_dispatches = 0     # decode steps / megasteps dispatched
        self.row_dispatches = 0        # a row drained with n >= 1 tokens
        self.row_tokens = 0            # adds (1, n): dispatches/token is
                                       # 1.0 per-step, ~1/K under megasteps
        self.drain_block_s = 0.0       # wall spent blocked at drain points
        if self.megastep_k:
            self._init_megastep_buffers()
        self.step_latencies: List[float] = []
        self.admit_latencies: List[float] = []  # dense admissions' walls
        self.swaps: List[Tuple[int, int]] = []   # (step index, variant index)
        self.step_admission_chunks: List[Tuple[int, int]] = []  # (used, budget)
        self._token_lat: List[float] = []        # unflushed monitor samples
        # per-request PRNG streams keyed (engine seed, uid): sampling does
        # not depend on slot assignment or admission interleaving
        self._rngs: Dict[int, np.random.Generator] = {}
        self._pending_variant: Optional[int] = None
        self.step_count = 0
        self._backoff: Dict[int, Tuple[int, int]] = {}  # uid -> (retry, dly)
        self.rejected: List[Request] = []
        self.stats: Dict[str, int] = dict(admission_timeouts=0,
                                          backoff_skips=0)
        self._tenant = None
        self._bound = False
        if (self.runtime is not None and self.runtime.auto_tenant
                and self.runtime.reshard_fn is None):
            # bind this engine as the runtime's tenant: variant hot-swaps
            # arrive via ``request_variant`` and pool pages are its quanta
            self._tenant = tenant_mod.ServeTenant(engine=self)
            self.runtime.bind(self._tenant)
            self._bound = True

    def _derive_plans(self) -> None:
        """The ring-prefill sequence plan for full-size chunks, from (cfg,
        mesh, prefill_chunk) by the pure plan function the chunk cell
        re-derives for each chunk length."""
        self._prefill_plan, self._prefill_reason = None, "single device"
        if self.mesh is not None:
            self._prefill_plan, self._prefill_reason = prefill_plan(
                self.cfg, self.mesh, self.prefill_chunk)

    @property
    def sharded_prefill(self) -> bool:
        """True when full-size admission chunks run the sequence ring
        (ragged tails re-plan)."""
        return self._prefill_plan is not None

    def explain_dispatch(self) -> str:
        """One-line decode dispatch description (startup banner);
        ``megastep_k`` > 0 notes that the decode step runs inside a fused
        K-token megastep (the attention dispatch is the same each step)."""
        where = (f"{self.device}, single device (decode is not sharded "
                 "over the mesh)" if self.mesh is not None
                 else f"{self.device}")
        if MAMBA in self.cfg.pattern:
            where += (", Mamba rows updated in plain PyTorch (admission "
                      "scans through ssd_scan"
                      + ("" if self.device.type == "cuda"
                         else "'s plain version") + ")")
        if not self.paged:
            mm = ("int8_matmul on int8 rungs" if self.device.type == "cuda"
                  else "int8_matmul's plain version on int8 rungs")
            return ("dense decode: ring caches (no paged dispatch), _sdpa "
                    f"over the ring in plain PyTorch, {mm}, {where}")
        mega = ""
        if self.megastep_k > 0:
            mega = (f", inside a fused {self.megastep_k}-token megastep "
                    + ("replayed as a CUDA graph" if self.device.type ==
                       "cuda" else "run eagerly"))
        if self.device.type == "cuda":
            return ("paged decode: fused CUDA paged_attention kernel, "
                    f"int8_matmul on int8 rungs, {where}{mega}")
        return ("paged decode: plain PyTorch versions of the kernels, "
                f"{where}{mega}")

    def explain_megastep(self) -> str:
        """One-line megastep/pipeline description (startup banner)."""
        if self.megastep_k <= 0:
            return "megastep: off (one decode dispatch per token)"
        samp = ("greedy argmax" if self.temperature <= 0.0 else
                "temperature categorical, (seed,uid,draw) threefry fold-in "
                f"seed={self.seed}")
        how = ("one CUDA graph of the decode step per variant, replayed K "
               "times" if self.device.type == "cuda" else
               "the decode step run K times eagerly")
        return (f"megastep: up to {self.megastep_k} tokens fused per "
                f"dispatch ({how}), on-device {samp} + EOS/budget stop "
                "masking, caches updated in place, "
                + ("sync-timing drain (no overlap)" if self.sync_timing
                   else "async double-buffered host pipeline"))

    def explain_prefill_dispatch(self) -> str:
        """One-line chunked-prefill dispatch description (startup banner)."""
        return attn_mod.explain_prefill_dispatch(
            self.cfg, self.mesh, chunk_len=self.prefill_chunk)

    # ------------------------------------------------------------ variants --

    @property
    def active_variant(self) -> int:
        return self._active

    @property
    def active_knobs(self) -> ApproxKnobs:
        return self._variant_knobs[self._active]

    def set_variant(self, idx: int) -> None:
        """Hot-swap the active variant at a step boundary, converting the
        rings or the page pool when the swap crosses the ``kv_quant``
        boundary and dropping the cached int8 weights when it leaves the
        int8 matmuls."""
        if idx == self._active:
            return
        # the graphs hold the addresses of the caches and of the cached
        # int8 weights that a swap may free: land the in-flight megastep
        # first, then drop them all (the next dispatch recaptures)
        self._drain_pipeline()
        self._graph = None
        old, new = self.active_knobs, self._variant_knobs[idx]
        if old.kv_quant != new.kv_quant:
            self.caches = slots_mod.convert_caches(
                self.caches, new.kv_quant, self.cache_dtype)
        if old != new and self.paged:
            # prefix entries are tagged by the knobs that computed them; a
            # swap re-encodes the pool in place, so drop the stale index
            self.pool.flush_prefixes()
        if old.matmul_precision == "int8" and new.matmul_precision != "int8":
            # the int8 weights live only while an int8 rung is active
            kops.clear_weight_cache()
        self._active = idx
        self.swaps.append((len(self.step_latencies), idx))

    def request_variant(self, idx: int) -> None:
        """Tenant-protocol actuation: hot-swap at the next SAFE step
        boundary (deferred while an admission is in flight)."""
        self._pending_variant = idx
        self._apply_pending_variant()

    def _apply_pending_variant(self) -> None:
        if (self._pending_variant is None or self._admissions
                or self._await_admit):
            return
        idx, self._pending_variant = self._pending_variant, None
        if idx != self._active:
            self.set_variant(idx)

    def attach_runtime(self, runtime: PliantRuntime, tenant=None) -> None:
        """Attach a pre-built (multi-tenant) runtime after construction; it
        must contain this engine's ``ServeTenant`` unless single-tenant."""
        if tenant is None:
            tenant = next((t for t in runtime.tenants
                           if isinstance(t, tenant_mod.ServeTenant)
                           and t.engine is self), None)
        assert tenant is not None or len(runtime.tenants) == 1, \
            "multi-tenant runtime has no ServeTenant for this engine"
        self.runtime = runtime
        self._tenant = tenant
        self._bound = tenant is not None

    # ------------------------------------------------------------- helpers --

    def _init_caches(self, quantized: bool):
        if not self.paged:
            return lm.init_caches(self.cfg, self.batch_slots, self.max_len,
                                  dtype=self.cache_dtype,
                                  quantized=quantized, device=self.device)
        sp = self._page_spec
        return lm.init_paged_caches(
            self.cfg, self.batch_slots, sp.n_pages, sp.page_size,
            sp.max_pages, dtype=self.cache_dtype, quantized=quantized,
            device=self.device)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. On the card the copy goes
        through pinned memory without blocking the host (a pageable copy
        would wait for the stream, stalling the megastep pipeline); the
        pinned block is not reused before the copy has run."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _rng_for(self, req: Request) -> np.random.Generator:
        g = self._rngs.get(req.uid)
        if g is None:
            g = np.random.default_rng((self.seed, req.uid))
            self._rngs[req.uid] = g
        return g

    def _sample_rows(self, logits: np.ndarray,
                     reqs: List[Request]) -> np.ndarray:
        """ONE batched sampling call for every emitting row. logits: (R, V);
        ``reqs`` the emitting requests, row-aligned. Greedy is an argmax;
        temperature sampling draws one uniform per request from its PRIVATE
        stream and inverts the softmax CDF."""
        if self.temperature <= 0.0:
            return np.argmax(logits, axis=-1)
        z = logits.astype(np.float64) / self.temperature
        z -= z.max(axis=-1, keepdims=True)
        p = np.exp(z)
        cdf = np.cumsum(p, axis=-1)
        u = np.asarray([self._rng_for(r).random() for r in reqs])
        idx = (cdf < u[:, None] * cdf[:, -1:]).sum(axis=-1)
        return np.minimum(idx, logits.shape[-1] - 1)

    def submit(self, req: Request) -> None:
        req.t_enqueue = req.t_enqueue or time.perf_counter()
        self.pending.append(req)

    def _expire_pending(self) -> None:
        """Admission-timeout sweep: reject every queued request that waited
        past ``admission_timeout_s`` without being admitted."""
        if self.admission_timeout_s <= 0 or not self.pending:
            return
        now = time.perf_counter()
        keep: Deque[Request] = collections.deque()
        for req in self.pending:
            t0 = req.t_enqueue or req.t_arrival
            if t0 and now - t0 > self.admission_timeout_s:
                req.rejected = True
                req.rejection = AdmissionTimeout(
                    uid=req.uid, waited_s=now - t0,
                    queue_depth=len(self.pending), step=self.step_count)
                self.rejected.append(req)
                self.stats["admission_timeouts"] += 1
                self._backoff.pop(req.uid, None)
                self._rngs.pop(req.uid, None)
            else:
                keep.append(req)
        self.pending = keep

    # ------------------------------------------------------ paged plumbing --

    def _free_slot(self, slot: int) -> bool:
        """Release a finished request's pages (its Mamba rows stay: the
        next admission overwrites them). Returns True when the block
        tables changed."""
        return self.pool.free_slot(slot)

    def _push_blocks(self) -> None:
        """Mirror the host block tables into the device caches and scrub
        freed pages' stale positions before they can be reused."""
        bt = self._to_device(self.pool.blocks)
        scrub = self.pool.drain_scrub()
        pids = (self._to_device(np.asarray(scrub, np.int64)) if scrub
                else None)
        for c in self.caches:
            if isinstance(c, MambaCache):
                continue
            if pids is not None:
                c.ppos[:, pids] = -1
            c.block.copy_(bt.expand_as(c.block))

    def _mamba_snapshot(self, slot: int):
        """The slot's SSM rows at a prefix boundary, carried by the prefix
        index entry: ({cache index: MambaCache of (n_groups, ...) host
        copies}, their bytes); (None, 0) for an attention-only arch. On
        the card the copies land in pinned memory without blocking: the
        stream orders them before any later write to the rows and before
        a restore (``_set_mamba_rows``), so taking one makes no host
        sync."""
        pin = self.device.type == "cuda"
        snap, nbytes = {}, 0
        for ci, c in enumerate(self.caches):
            if not isinstance(c, MambaCache):
                continue
            rows = []
            for x in c:
                h = torch.empty(x[:, slot].shape, dtype=x.dtype,
                                pin_memory=pin)
                h.copy_(x[:, slot], non_blocking=pin)
                rows.append(h)
                nbytes += h.nbytes
            snap[ci] = MambaCache(*rows)
        return snap or None, nbytes

    def _set_mamba_rows(self, slot: int, snap) -> None:
        """Seed the slot's SSM rows for a fresh admission in place: the
        prefix entry's snapshot on a hit, zeros otherwise (the previous
        tenant's state must never leak into a new request)."""
        for ci, c in enumerate(self.caches):
            if not isinstance(c, MambaCache):
                continue
            row = snap.get(ci) if snap else None
            for j, x in enumerate(c):
                if row is None:
                    x[:, slot].zero_()
                else:
                    x[:, slot].copy_(row[j], non_blocking=True)

    # ----------------------------------------------------------- admission --

    def _chunked_prefill(self, prompt: List[int]):
        """Dense path: stream the prompt through fixed-size chunks into a
        fresh single-request cache. Returns (last-token logits, caches)."""
        knobs = self.active_knobs
        caches = lm.init_caches(self.cfg, 1, self.max_len,
                                dtype=self.cache_dtype,
                                quantized=knobs.kv_quant, device=self.device)
        toks = torch.tensor([prompt], dtype=torch.long, device=self.device)
        S, start, logits = len(prompt), 0, None
        while start < S:
            C = min(self.prefill_chunk, S - start)
            logits, caches = prefill_mod.prefill_chunk(
                self.params, toks[:, start:start + C], start, caches,
                self.cfg, knobs, mesh=self.mesh)
            start += C
        return logits, caches

    def _admit(self) -> None:
        """Dense path: synchronous admission (the whole chunked prefill into
        a fresh cache, the slot insert and the first token inside one
        step), every free slot in turn."""
        for i in range(self.batch_slots):
            while self.slots[i] is None and self.pending:
                req = self.pending[0]
                assert len(req.prompt) <= self.max_len, \
                    (len(req.prompt), self.max_len)
                t0 = time.perf_counter()
                req.t_admit_start = t0
                logits, rcaches = self._chunked_prefill(req.prompt)
                self.caches = slots_mod.insert_request(self.caches, rcaches,
                                                       i)
                self.pending.popleft()
                tok = int(self._sample_rows(logits.cpu().numpy(), [req])[0])
                now = time.perf_counter()
                self.admit_latencies.append(now - t0)
                self._token_lat.append(now - t0)   # TTFT sample
                req.t_admit = now                  # admission COMPLETION
                req.admit_compute_s = now - t0     # sync: compute == wall
                req.out.append(tok)
                req.token_times.append(now)
                if len(req.out) >= req.max_new or (
                        self.eos_id >= 0 and tok == self.eos_id):
                    req.done = True                # 1-token request: no slot
                    continue
                self.positions[i] = len(req.prompt)
                self.cur_tokens[i] = tok
                self.slots[i] = req

    def _prefix_dedup_wait(self, req: Request, shard: int = 0) -> bool:
        """Cold-start prefix dedup: True when an in-flight admission is
        prefilling a page-aligned prefix this prompt shares and the index
        does not cover it yet; the request waits for that registration."""
        P = self.page_size
        cap = min((len(req.prompt) - 1) // P, self.pool.max_register_pages)
        if cap <= 0 or not self._admissions:
            return False
        best = 0
        for adm in self._admissions.values():
            if self.pool.slot_shard(adm.slot) != shard:
                continue
            other = adm.req.prompt
            lim = min(len(req.prompt), len(other), cap * P)
            k = 0
            while k < lim and req.prompt[k] == other[k]:
                k += 1
            best = max(best, (k // P) * P)
        if not best:
            return False
        return self.pool.lookup_prefix(req.prompt, self.active_knobs,
                                       shard)[0] < best

    def _start_admissions(self, count_skips: bool = True) -> None:
        """Open a background admission on EVERY free slot. Per slot, pick the
        first of the leading ``pack_window`` pending requests whose pages fit
        the pool budget and whose shared prefix is not mid-prefill in a
        sibling admission; pool-blocked requests back off exponentially, and
        after ``max_head_skips`` head skips admission is strict FIFO. The
        block table maps prompt pages plus projected decode pages in one
        transaction; prefix hits skip those chunks."""
        started_any = False
        while self.pending:
            slot = next((i for i in range(self.batch_slots)
                         if self.slots[i] is None
                         and i not in self._admissions
                         and i not in self._await_admit), None)
            if slot is None:
                break
            strict = self._head_skips >= self.max_head_skips
            window = 1 if strict else min(len(self.pending), self.pack_window)
            started = False
            for qi in range(window):
                req = self.pending[qi]
                assert len(req.prompt) <= self.max_len, \
                    (len(req.prompt), self.max_len)
                assert len(req.prompt) + req.max_new <= \
                    self._page_spec.max_pages * self.page_size, \
                    "paged serving does not ring-wrap: need " \
                    "max_len >= prompt + max_new"
                if self._prefix_dedup_wait(req, self.pool.slot_shard(slot)):
                    continue       # sibling is mid-prefill of our prefix
                bo = self._backoff.get(req.uid)
                if bo is not None and self.step_count < bo[0]:
                    self.stats["backoff_skips"] += 1
                    continue
                # grouped allocation: reserve the decode pages up front
                # (banded archs skip it: they free window-dead pages)
                reserve = 0 if self._window_free else max(req.max_new - 1, 0)
                plan = self.pool.admit(slot, req.prompt, self.active_knobs,
                                       reserve_tokens=reserve)
                if plan is None:
                    delay = (min(bo[1] * 2, self.backoff_cap) if bo
                             else max(self.backoff_base, 1))
                    self._backoff[req.uid] = (self.step_count + delay, delay)
                    if qi == 0 and count_skips:
                        self._head_skips += 1
                    continue                 # over budget: try the next one
                self._backoff.pop(req.uid, None)
                if qi == 0:
                    self._head_skips = 0
                del self.pending[qi]
                self._set_mamba_rows(slot, plan.entry.mamba if (
                    plan.shared_tokens and plan.entry) else None)
                S = len(req.prompt)
                if MAMBA in self.cfg.pattern:
                    # prefill pauses at each boundary so that its SSM
                    # snapshot matches the prefix it is registered under
                    stops = sorted(set(plan.register) | {S})
                    mamba_reg, tail_reg = list(plan.register), []
                else:
                    # attention only: pages are position-addressed, and
                    # registering is bookkeeping after the last chunk
                    stops, mamba_reg, tail_reg = [S], [], list(plan.register)
                self._admissions[slot] = _Admission(
                    req, slot, plan.shared_tokens, stops, mamba_reg,
                    tail_reg)
                started = started_any = True
                break
            if not started:
                break       # nothing in the window fits this step
        if started_any:
            self._push_blocks()

    def _chunk_budget(self) -> int:
        """Prefill chunks this step may spend across all admissions: burst
        with no live decoder or with measured QoS headroom, else one."""
        cap = max(1, self.max_admission_chunks)
        if not any(s is not None for s in self.slots):
            return cap
        if headroom_burst(self.runtime, self.qos_guard):
            return cap
        return 1

    def _advance_admissions(self) -> None:
        """Open admissions on free slots, then advance the in-flight set
        round-robin one chunk at a time until the budget is spent."""
        budget = self._chunk_budget()
        used = 0
        self._start_admissions()
        while used < budget:
            ran = False
            for slot in list(self._admissions):
                if used >= budget:
                    break
                self._advance_one(self._admissions[slot])
                used += 1
                ran = True
            if not ran:
                break
            self._start_admissions(count_skips=False)
        if used or self._admissions:
            self.step_admission_chunks.append((used, budget))

    def _advance_one(self, adm: _Admission) -> None:
        """Run ONE bounded prefill chunk of ``adm``; after the final chunk
        park it for first-token sampling at the drain point."""
        req = adm.req
        if not adm.started:
            adm.started = True
            req.t_admit_start = time.perf_counter()
        S = len(req.prompt)
        end = next(b for b in adm.stops if b > adm.next)
        C = min(self.prefill_chunk, end - adm.next)
        toks = torch.tensor([req.prompt[adm.next:adm.next + C]],
                            dtype=torch.long, device=self.device)
        t0 = time.perf_counter()
        adm.logits, self.caches = prefill_mod.paged_prefill_chunk(
            self.params, toks, adm.next, self.caches, adm.slot, self.cfg,
            self.active_knobs, mesh=self.mesh)
        adm.next += C
        adm.compute_s += time.perf_counter() - t0
        if adm.next in adm.mamba_register:
            snap, nbytes = self._mamba_snapshot(adm.slot)
            self.pool.register_prefix(adm.slot, req.prompt,
                                      self.active_knobs, adm.next,
                                      mamba=snap, mamba_bytes=nbytes)
        if adm.next < S:
            return
        for b in adm.tail_register:
            self.pool.register_prefix(adm.slot, req.prompt,
                                      self.active_knobs, b)
        del self._admissions[adm.slot]
        self._await_admit[adm.slot] = adm

    def _drain_admissions(self) -> None:
        """Sample each completed admission's first token and hand its slot
        to the decode batch (it joins the NEXT decode)."""
        if not self._await_admit:
            return
        freed = False
        for slot, adm in list(self._await_admit.items()):
            req = adm.req
            t0 = time.perf_counter()
            logits = adm.logits.cpu().numpy()        # <- the drain
            dt = time.perf_counter() - t0
            adm.compute_s += dt
            self.drain_block_s += dt
            del self._await_admit[slot]
            tok = int(self._sample_rows(logits, [req])[0])
            now = time.perf_counter()
            self._token_lat.append(now - req.t_admit_start)  # TTFT (wall)
            req.t_admit = now
            req.admit_compute_s = adm.compute_s
            req.out.append(tok)
            req.token_times.append(now)
            if len(req.out) >= req.max_new \
                    or (self.eos_id >= 0 and tok == self.eos_id):
                req.done = True                # 1-token request: no slot
                self._rngs.pop(req.uid, None)
                freed |= self._free_slot(slot)
                continue
            self.positions[slot] = len(req.prompt)
            self.cur_tokens[slot] = tok
            self._uids[slot] = req.uid
            self._pos_ub[slot] = len(req.prompt)
            self.slots[slot] = req
            if self.megastep_k:
                self._inject_slots.add(slot)
        if freed:
            self._push_blocks()

    # --------------------------------------------------------------- steps --

    def _decode(self, rows_active: Optional[np.ndarray]):
        """The decode step over every slot: (B,) greedy token ids (argmax on
        the device) or (B, V) logits for host sampling. ``rows_active``
        masks the paged pool's writes; dense rings take None."""
        toks = torch.tensor(self.cur_tokens, dtype=torch.long,
                            device=self.device)[:, None]
        pos = torch.tensor(self.positions, device=self.device)
        act = (None if rows_active is None
               else torch.tensor(rows_active, device=self.device))
        logits, self.caches = lm.decode_step(
            self.params, toks, pos, self.caches, self.cfg, self.active_knobs,
            active=act)
        if self._fused_sample:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return logits

    # ------------------------------------------------------------ megastep --

    def _megastep_budget(self) -> int:
        """Decode tokens the next megastep may fuse: K as a Pliant-visible
        knob, bounded by the same guard band as ``_chunk_budget`` but
        pulling the other way: a large K amortises dispatch (throughput), a
        small K keeps admission interleaving fine-grained and lets a variant
        swap or reclaim take effect within one token instead of K. With
        admission work pending the megastep shrinks to 1 unless the monitor
        shows measured headroom; with nothing to interleave, full K. Queued
        work that cannot start (every slot taken, nothing in flight) is not
        admission work."""
        cap = max(1, self.megastep_k)
        admitting = bool(self._admissions or self._await_admit)
        can_start = bool(self.pending) and any(
            self.slots[i] is None and i not in self._admissions
            and i not in self._await_admit
            for i in range(self.batch_slots))
        if not (admitting or can_start):
            return cap
        if headroom_burst(self.runtime, self.qos_guard):
            return cap
        return 1

    def _init_megastep_buffers(self) -> None:
        """The static tensors the megastep reads and writes: the carry, and
        on the card the (B, megastep_k) token buffer with its column
        counter, two pinned host buffers and their events (megastep N's
        tokens are copied into buffer N % 2 and drained before N + 2)."""
        B, dev = self.batch_slots, self.device

        def zeros(dtype):
            return torch.zeros(B, dtype=dtype, device=dev)
        self._state = _Carry(zeros(torch.int32), zeros(torch.int32),
                             zeros(torch.bool), zeros(torch.int32),
                             zeros(torch.int32), zeros(torch.int32))
        if dev.type == "cuda":
            self._toks = torch.zeros((B, self.megastep_k), dtype=torch.int32,
                                     device=dev)
            self._col = torch.zeros(1, dtype=torch.int64, device=dev)
            self._host_toks = [torch.zeros((B, self.megastep_k),
                                           dtype=torch.int32,
                                           pin_memory=True)
                               for _ in range(2)]
            self._events = [torch.cuda.Event() for _ in range(2)]

    def _megastep_fn(self, k: int):
        """The K-step megastep of the ACTIVE variant, made once per
        (variant, K)."""
        key = (self._active, k)
        fn = self._megasteps.get(key)
        if fn is None:
            fn = step_mod.make_paged_megastep(
                self.cfg, self.active_knobs, k=k,
                temperature=self.temperature, seed=self.seed,
                eos_id=self.eos_id)
            self._megasteps[key] = fn
        return fn

    def _megastep_graph(self) -> _MegastepGraph:
        """The active variant's graph, captured at first use and again when
        a cached int8 weight was dropped since the capture (by a swap of
        any engine sharing the weights): the graph holds its address."""
        if self._graph is None or \
                self._graph.drops != kops.weight_cache_drops:
            self._graph = self._capture_megastep()
        return self._graph

    def _capture_megastep(self) -> _MegastepGraph:
        """Capture one megastep body (``make_paged_megastep(k=1)`` on the
        static carry, its token written into column ``_col``). A warm-up
        on a side stream first runs the body with every row dead (their
        cache writes land on the never-read null page): it builds and
        loads the kernels, quantises the int8 weights into the weight
        cache and grants the kernels' shared memory, so nothing is
        allocated for a weight or set up during the capture. A capture
        that fails raises; nothing falls back."""
        dev = self.device
        step = self._megastep_fn(1)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step(self.params, *(torch.zeros_like(t) for t in self._state),
                 self.caches)
        torch.cuda.current_stream(dev).wait_stream(side)
        misses, before = kops.weight_cache_misses, _decode_launches()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            toks = step(self.params, *self._state, self.caches)[0]
            self._toks.index_copy_(1, self._col, toks)
            self._col.add_(1)
        if kops.weight_cache_misses != misses:
            raise RuntimeError(
                "megastep capture quantised an int8 weight: the warm-up "
                "left the weight cache incomplete")
        after = _decode_launches()
        stats = dict(variant=self._active,
                     capture_s=time.perf_counter() - t0, replays=0,
                     launches={n: after[n] - before[n] for n in after})
        self.graph_log.append(stats)
        return _MegastepGraph(graph, kops.weight_cache_drops, stats)

    def replayed_launches(self) -> Dict[str, int]:
        """Kernel launches of the replayed megasteps: each graph's launches
        counted at its capture times its replays (the wrappers' counters
        see only the capture)."""
        out = dict.fromkeys(_DECODE_KERNELS, 0)
        for g in self.graph_log:
            for name, n in g["launches"].items():
                out[name] += n * g["replays"]
        return out

    def _merge_carry(self, alive_host: np.ndarray) -> None:
        """Write the host mirrors into the static carry: every row on a cold
        start, else the slots (re)activated since the last dispatch (rows
        die on the device, so only activations need merging)."""
        cold = self._carry is None
        rows = range(self.batch_slots) if cold else self._inject_slots
        if not rows:
            return
        h = np.zeros((7, self.batch_slots), np.int32)
        for i in rows:
            h[:3, i] = (1, self.cur_tokens[i], self.positions[i])
            h[4, i] = self._uids[i]
            if alive_host[i]:
                req = self.slots[i]
                h[3, i] = 1
                h[5:, i] = (len(req.out), req.max_new - len(req.out))
        d = self._to_device(h)
        m = d[0].bool()
        for t, v in zip(self._state, d[1:]):
            t.copy_(torch.where(m, v.to(t.dtype), t))
        self._carry = self._state

    def _launch_megastep(self, k: int):
        """Run K decode steps on the carry. CPU: the K-step megastep, its
        (B, K) tokens. Card: K replays of the variant's graph, then an
        asynchronous copy of the token buffer into pinned host buffer
        N % 2 and an event; returns (host buffer, event, graph), the graph
        kept alive until the drain."""
        if self.device.type != "cuda":
            return self._megastep_fn(k)(self.params, *self._state,
                                        self.caches)[0]
        g = self._megastep_graph()
        self._col.zero_()
        for _ in range(k):
            g.graph.replay()
        g.stats["replays"] += k
        n = self.decode_dispatches % 2
        self._host_toks[n].copy_(self._toks, non_blocking=True)
        self._events[n].record()
        return self._host_toks[n], self._events[n], g

    def _dispatch_megastep(self) -> Optional[dict]:
        """Dispatch ONE fused K-step decode over the live slots without
        waiting for it: pre-map every page the cursors can reach, merge
        newly activated slots into the device carry, and return the flight
        record the drain consumes (None when no slot is decoding)."""
        rows = [i for i in range(self.batch_slots)
                if self.slots[i] is not None]
        if not rows:
            # nothing alive: the device carry is stale; the next activation
            # cold-starts from the host mirrors
            self._carry = None
            return None
        k = self._megastep_budget()
        # never run past the longest remaining budget
        k = max(1, min(k, max(self.slots[i].max_new - len(self.slots[i].out)
                              for i in rows)))
        dirty = False
        for i in rows:
            req = self.slots[i]
            # exclusive bound on the positions this row can ever write
            # (decode writes KV at S .. S+max_new-2): _pos_ub ratchets by k a
            # dispatch, the host's mirror of the device cursor, conservative
            # while an earlier megastep is in flight
            cap = len(req.prompt) + req.max_new - 1
            ub = min(int(self._pos_ub[i]) + k, cap)
            dirty |= self.pool.ensure_decode_range(
                i, int(self.positions[i]), ub)
            self._pos_ub[i] = ub
        if dirty:
            self._push_blocks()
        t0 = time.perf_counter()
        self._merge_carry(np.array([s is not None for s in self.slots]))
        toks = self._launch_megastep(k)
        self._inject_slots.clear()
        self.decode_dispatches += 1
        return dict(toks=toks, rows=[(i, self.slots[i]) for i in rows],
                    k=k, t0=t0)

    def _drain_megastep(self, flight: dict) -> None:
        """THE decode drain point: one transfer surfaces up to K tokens a
        row and the stop flags (the -1 sentinel). Per-token times
        interpolate across the megastep wall, as the QoS monitor attributes
        it (``LatencyMonitor.record_megastep``). Finished rows free their
        slot and pages here."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            host, event, _ = flight["toks"]
            event.synchronize()
            toks = host[:, :flight["k"]].numpy()
        else:
            toks = flight["toks"].numpy()
        now = time.perf_counter()
        self.drain_block_s += now - t0
        wall = now - flight["t0"]
        self.step_latencies.append(wall)
        freed = False
        emitted: List[int] = []
        for i, req in flight["rows"]:
            if req.done:
                continue   # died in an earlier flight; this row is all -1
            n = 0
            for t in toks[i]:
                if t < 0:
                    break  # the row died in the megastep: EOS or budget
                n += 1
                req.out.append(int(t))
                self.cur_tokens[i] = int(t)
                self.positions[i] += 1
            if n:
                emitted.append(n)
                self.row_dispatches += 1
                self.row_tokens += n
                for j in range(n):
                    req.token_times.append(
                        flight["t0"] + wall * (j + 1) / n)
            if len(req.out) >= req.max_new or (
                    self.eos_id >= 0 and req.out
                    and req.out[-1] == self.eos_id):
                req.done = True
                self.slots[i] = None        # slot freed: continuous batch
                self._rngs.pop(req.uid, None)
                freed |= self._free_slot(i)
            elif self._window_free:
                freed |= self.pool.release_window_pages(
                    i, int(self.positions[i]) - self._window_free)
        if freed:
            self._push_blocks()
        if self.runtime is not None and emitted:
            self.runtime.monitor.record_megastep(wall, emitted)

    def _drain_pipeline(self) -> None:
        """Flush the double buffer before state surgery (a variant swap):
        drain the in-flight megastep so its tokens land, and invalidate the
        device carry; the next dispatch cold-starts from the host
        mirrors."""
        if self._inflight is not None:
            self._drain_megastep(self._inflight)
            self._inflight = None
        self._carry = None

    def _megastep_round(self) -> None:
        """One engine step in megastep mode, the async double-buffered host
        pipeline: advance admissions, dispatch megastep N+1, THEN drain
        megastep N (the card works on N+1 while the host handles N's
        tokens), drain completed admissions, tick control.
        ``sync_timing`` drains each dispatch in its own round instead."""
        prev, self._inflight = self._inflight, None
        self._advance_admissions()
        flight = self._dispatch_megastep()
        if prev is not None:
            self._drain_megastep(prev)    # dispatch order == drain order
        if flight is not None and self.sync_timing:
            self._drain_megastep(flight)
            flight = None
        self._inflight = flight
        self._drain_admissions()
        self.pool.replenish()
        self._control_tick()

    def step(self) -> None:
        """One engine step. Megastep (``megastep_k`` > 0): one round of the
        async double-buffered pipeline (``_megastep_round``). Paged
        per-step: the admission phase (open admissions on every free slot,
        advance them under the QoS chunk budget), one decode for every live
        slot (admitting slots ride along inactive), then the single drain
        point. Dense: synchronous admission, then one decode of every slot.
        All tick the Pliant control loop at the step boundary."""
        self.step_count += 1
        self._expire_pending()
        if self.megastep_k > 0:
            self._megastep_round()
            return
        if self.paged:
            self._advance_admissions()
        else:
            self._admit()
        # the decode row set is FIXED here: slots activated at this step's
        # admission drain join the next step's decode
        rows = [i for i, req in enumerate(self.slots) if req is not None]
        if not rows:
            if self.paged:
                self._drain_admissions()
                self.pool.replenish()
            self._control_tick()       # flush TTFT samples of 1-token admits
            return
        if self.paged:
            dirty = False
            for i in rows:
                dirty |= self.pool.ensure_decode_page(
                    i, int(self.positions[i]))
            if dirty:
                self._push_blocks()
        t0 = time.perf_counter()
        out = self._decode(np.array([s is not None for s in self.slots])
                           if self.paged else None)
        self.decode_dispatches += 1
        if self.paged:
            self._drain_admissions()
        tb = time.perf_counter()
        out = out.cpu().numpy()
        self.drain_block_s += time.perf_counter() - tb
        dt = time.perf_counter() - t0
        self.step_latencies.append(dt)
        now = time.perf_counter()
        if self._fused_sample:
            nxt_tokens = out[rows]
        else:
            nxt_tokens = self._sample_rows(
                out[rows], [self.slots[i] for i in rows])
        freed = False
        for i, nxt in zip(rows, nxt_tokens):
            req = self.slots[i]
            nxt = int(nxt)
            self.positions[i] += 1
            req.out.append(nxt)
            req.token_times.append(now)
            self.cur_tokens[i] = nxt
            self.row_dispatches += 1
            self.row_tokens += 1
            if len(req.out) >= req.max_new or (
                    self.eos_id >= 0 and nxt == self.eos_id):
                req.done = True
                self.slots[i] = None            # slot freed: continuous batch
                self._rngs.pop(req.uid, None)
                if self.paged:
                    freed |= self._free_slot(i)
            elif self._window_free:
                freed |= self.pool.release_window_pages(
                    i, int(self.positions[i]) - self._window_free)
        if freed:
            self._push_blocks()
        if self.paged:
            self.pool.replenish()
        self._token_lat.extend([dt] * len(rows))
        self._control_tick()

    def _control_tick(self) -> None:
        """Monitor -> controller -> actuator at the step boundary."""
        if self.runtime is None:
            self._token_lat.clear()
            return
        if self._token_lat:
            self.runtime.monitor.record_many(self._token_lat)
            self._token_lat.clear()
        self.runtime.maybe_decide()
        if self._bound:
            self._apply_pending_variant()
        elif (self.runtime.active_variant != self._active
                and not self._admissions and not self._await_admit):
            self.set_variant(self.runtime.active_variant)

    @property
    def idle(self) -> bool:
        """Nothing to do: empty queue, no in-flight admissions, no active
        slots."""
        return (not self.pending and not self._admissions
                and not self._await_admit and self._inflight is None
                and all(s is None for s in self.slots))

    def run(self, max_steps: int = 0) -> None:
        """Step until idle. ``max_steps`` (0 = auto, sized to the queued
        work) is a runaway backstop; hitting it non-idle raises."""
        if not max_steps:
            chunks = sum(-(-len(r.prompt) // max(self.prefill_chunk, 1)) + 2
                         for r in self.pending)
            decodes = sum(r.max_new for r in self.pending)
            max_steps = 10_000 + 2 * (chunks + decodes)
        steps = 0
        while not self.idle and steps < max_steps:
            self.step()
            steps += 1
        if not self.idle:
            raise RuntimeError(
                f"engine not idle after {steps} steps: "
                f"{len(self.pending)} pending, "
                f"{len(self._admissions)} admissions in flight, "
                f"{sum(s is not None for s in self.slots)} active slots")
