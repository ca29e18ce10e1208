"""Port of ``repro.serve.scheduler``: the continuous-batching engine, with
a per-request lifecycle over a shared slot batch and the paged KV pool.

``DecodeEngine`` decodes a fixed batch in lockstep.
``ContinuousBatchingEngine`` runs a fixed ``num_slots``-wide decode batch
in which every slot has its own lifecycle:

* **admission** — one-shot: a batch-1 prefill (prompts right-padded to a
  power-of-two bucket where that cannot change a stream), whose KV prefix
  is installed into the slot's pages (``kv_pool.write_span``) or dense
  row; chunked (``prefill_chunk``, Sarathi-style): the request only
  occupies a slot and its prompt streams into the shared caches as
  fixed-size ``forward_chunk`` slices, at most one slice per engine step.
* **decode** — one chunk of ``chunk`` steps advances every slot; per-slot
  positions, stop tokens and ``max_new_tokens`` budgets are device-side
  masks, and finished slots write nothing to the caches (which is what
  makes reclaiming their blocks safe).
* **eviction** — at the chunk boundary finished requests leave their slot,
  their blocks return to the allocator, and the next queued request is
  admitted; if the pool runs dry the youngest request is preempted back to
  the queue and restarts from scratch (deterministically: same stream).
* **prefix caching** (``prefix_cache=True``, paged layout) — every full
  block of a stream carries a content identity (a chain hash of
  ``(parent_hash, block_tokens)`` over the host token stream), registered
  in the allocator once its pages are written.  Admission walks the
  prompt's chain through the hash index, takes a reference on every
  leading hit and prefills only the suffix: one padded ``forward_chunk``
  slice at the cached boundary on the one-shot path, or chunked-prefill
  slices starting there.  A released registered block parks on the
  allocator's LRU, still hittable, until ``alloc`` reclaims it.  A
  block-aligned, fully cached prompt copies its final shared page to a
  private one (``kv_pool.copy_block`` in every paged layer) before the
  last position is recomputed, so a shared page is never written.  On
  release the chain extends over generated tokens, so a multi-turn
  follow-up hits the whole previous conversation.  Only pure global
  attention without routing is safe (:func:`_prefix_cache_safe`); other
  configs decline with one log and run cold.

Upstream compiles the decode chunk and the prefill slice into ``lax.scan``
programs; here they are Python loops of eagerly launched kernels (the
port's ``DecodeEngine`` works the same way).  Every token and mask stays
on the device inside a chunk: one fetch of the packed ``(B, chunk + 2)``
matrix per decode chunk (tokens, the device's post-chunk active mask, the
per-slot quarantine step) and one packed ``[tok0, ok]`` fetch per
admission; ``host_transfers`` counts them.

Determinism contract: a request's token stream equals
``DecodeEngine.generate(prompt[None], scfg, seed=seed)`` up to stop-token
truncation.  Greedy streams therefore also equal the JAX engine's.  A
sampled request owns a ``torch.Generator`` seeded with its ``seed`` and
draws a (1, V) row per token in ``DecodeEngine``'s order (upstream splits a
threefry key per slot, whose bits torch cannot reproduce).  A cache-hit
admission draws its first token from the suffix slice's row with a fresh
generator, as the cold admission does.

Robustness, as upstream: the ``finish_reason`` lifecycle
(:data:`FINISH_REASONS`, every request finishes exactly once), deadlines
and TTFT budgets at chunk boundaries, a bounded queue with
``overload_policy``, NaN/Inf quarantine riding the chunk fetch, a
watchdog that raises :class:`SchedulerStall`, and fault injection
(``faults``, a :class:`repro_torch.serve.faults.FaultInjector`): allocator
failures through the allocator's ``fail_hook``, forced preemptions at
step starts, delayed arrivals at ``submit`` and poisoned logits in the one
decode chunk a poison lands in (every other chunk runs the fault-free
loop).  ``tracer`` (a :class:`repro_torch.serve.tracing.RequestTracer`)
gets one event a lifecycle edge on the engine clock.  Both are host-side:
with an empty injector or a tracer attached the engine launches the same
kernels and makes the same fetches.

Not ported yet: mesh serving (``mesh``; ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.transformer import build_segments
from repro_torch.serve import kv_pool
from repro_torch.serve.engine import (
    SamplerConfig,
    _hit_stop,
    _make_bucketed_prefill_fn,
    _make_checked_prefill_fn,
    sample_token,
)
from repro_torch.serve.faults import FaultInjector
from repro_torch.telemetry.metrics import MetricsRegistry, resolve_clock
from repro_torch.telemetry.tracing import RequestTracer, annotate

Tensor = torch.Tensor

_log = logging.getLogger(__name__)

#: The finish-reason taxonomy.  ``stop`` — stop token; ``length`` — token
#: budget exhausted; ``deadline`` — deadline / TTFT budget expired (queued
#: or live); ``shed`` — dropped by the bounded-queue overload policy;
#: ``rejected`` — dead on arrival at submit; ``error`` — NaN/Inf quarantine.
FINISH_REASONS = frozenset({"stop", "length", "deadline", "shed", "rejected", "error"})


class InadmissibleRequest(ValueError):
    """A request that can never be served: prompt + budget exceed the slot
    capacity, or its blocks exceed the whole pool.  Raised by ``submit``."""


class SchedulerStall(RuntimeError):
    """The engine stopped making progress while work was ready (or the
    pool was exhausted with nothing to preempt); the message carries the
    queue depth, live slots and allocator state."""


# ---------------------------------------------------------------------------
# Request lifecycle records
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request.  ``arrival``, ``deadline`` (absolute) and
    ``ttft_budget`` (relative to arrival) are in the engine's clock units
    (chunk ticks under the default virtual clock)."""

    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    seed: int = 0
    arrival: float = 0.0
    deadline: Optional[float] = None
    ttft_budget: Optional[float] = None


@dataclasses.dataclass
class RequestState:
    """Host mirror of an admitted request.  Under chunked prefill
    ``prefilled`` counts prompt tokens already in the cache and
    ``n_generated == 0`` marks the slot as still admitting (inactive in
    decode chunks).  ``gen`` is the request's sampling generator (None when
    greedy).  With prefix caching, ``block_hashes`` holds the chain hashes
    of the stream's full blocks (the prompt's at admission, extended over
    generated tokens at release) and ``registered`` counts the leading
    blocks already in the allocator's hash index."""

    request: Request
    slot: int
    blocks: list[int]
    tokens: list[int]
    n_generated: int
    admitted_at: float
    prefilled: int = 0
    first_token_at: float = 0.0
    done: bool = False
    finish_reason: str = ""
    gen: Optional[torch.Generator] = None
    block_hashes: list[int] = dataclasses.field(default_factory=list)
    registered: int = 0

    @property
    def pos(self) -> int:
        """Next write position = prompt_len + generated so far."""
        return len(self.request.prompt) + self.n_generated


@dataclasses.dataclass(frozen=True)
class FinishedRequest:
    uid: int
    tokens: np.ndarray  # (n,) int32, n <= max_new_tokens
    finish_reason: str  # one of FINISH_REASONS
    prompt_len: int
    arrival: float
    admitted_at: float
    # when the first token was sampled; for zero-token finishes it equals
    # finished_at
    first_token_at: float
    finished_at: float


# ---------------------------------------------------------------------------
# Safety gates
# ---------------------------------------------------------------------------


def _chunked_prefill_safe(cfg: ModelConfig) -> bool:
    """Whether admission prefill may be split into fixed-budget slices
    without changing any stream: attention mixers only (ring-cache
    sliding-window layers too: their in-chunk path is already sequential
    a token, so slice boundaries change nothing), no MoE / routed
    branches / VLM prefix (whose tokens couple across a slice)."""
    if cfg.moe or cfg.quant.num_experts > 1 or cfg.n_image_tokens > 0:
        return False
    return all(spec.mixer in ("attn", "mla") for seg in build_segments(cfg)
               for spec in seg.blocks)


# configs whose chunked-prefill decline was already logged: the fallback is
# a property of the config, logged once per config, not once per engine
_CHUNK_DECLINE_LOGGED: set[tuple] = set()


def _log_chunked_prefill_decline(cfg: ModelConfig) -> None:
    key = (cfg.name, cfg.family, bool(cfg.moe), cfg.quant.num_experts, cfg.n_image_tokens,
           tuple(spec.mixer for seg in build_segments(cfg) for spec in seg.blocks))
    if key in _CHUNK_DECLINE_LOGGED:
        return
    _CHUNK_DECLINE_LOGGED.add(key)
    _log.warning("config %r: chunked admission prefill declined (recurrent mixer / MoE / "
                 "routed branches / VLM prefix would change streams across slice "
                 "boundaries); falling back to one-shot admission prefill", cfg.name)


def _prefix_cache_safe(cfg: ModelConfig) -> bool:
    """Whether shared prompt blocks may be reused across requests without
    changing any stream: only when the paged pool holds a prefix's whole
    state, i.e. every mixer is global attention (``window == 0``).
    Unsafe: sliding-window rings and MLA latents (per-slot caches outside
    the pool: a reused block would leave them empty for the hitting slot),
    MoE / routed branches / VLM prefixes (tokens couple across a slice)."""
    if cfg.moe or cfg.quant.num_experts > 1 or cfg.n_image_tokens > 0:
        return False
    return all(spec.mixer == "attn" and spec.window == 0
               for seg in build_segments(cfg) for spec in seg.blocks)


# configs whose prefix-cache decline was already logged: the decline is a
# property of the config, logged once per config, not once per engine
_PREFIX_DECLINE_LOGGED: set[tuple] = set()


def _log_prefix_cache_decline(cfg: ModelConfig) -> None:
    key = (cfg.name, cfg.family, bool(cfg.moe), cfg.quant.num_experts, cfg.n_image_tokens,
           tuple((spec.mixer, spec.window) for seg in build_segments(cfg)
                 for spec in seg.blocks))
    if key in _PREFIX_DECLINE_LOGGED:
        return
    _PREFIX_DECLINE_LOGGED.add(key)
    _log.warning("config %r: prefix caching declined (a mixer keeps per-slot state "
                 "outside the paged pool, or routing couples tokens); admissions run cold",
                 cfg.name)


def _bucketed_prefill_safe(cfg: ModelConfig, max_len: int) -> bool:
    """Whether admission prefill may right-pad prompts to a bucket length
    without changing any stream: causal attention confines pad tokens to
    positions the decode mask gates until real tokens overwrite them.
    Unsafe: ring caches shorter than ``max_len`` (a prefill keeps the last
    W positions of the padded sequence, evicting real tokens), recurrent
    mixers, MoE / routed branches, VLM prefixes."""
    if cfg.moe or cfg.quant.num_experts > 1 or cfg.n_image_tokens > 0:
        return False
    for seg in build_segments(cfg):
        for spec in seg.blocks:
            if spec.mixer not in ("attn", "mla"):
                return False
            if 0 < spec.window < max_len:
                return False
    return True


# ---------------------------------------------------------------------------
# Cache-tree plumbing
# ---------------------------------------------------------------------------


def _cache_dicts(cfg: ModelConfig, caches):
    """(layer-stacked?, cache dict) of every block in the cache tree."""
    for si, seg in enumerate(build_segments(cfg)):
        for bi in range(len(seg.blocks)):
            yield seg.repeats > 1, caches[si][f"b{bi}"]


def _install(cfg: ModelConfig, big, small, slot: int, table_row: Tensor, nb: int) -> None:
    """Install a batch-1 prefill cache ``small`` into slot ``slot`` of the
    big cache tree, in place: a paged layer span-writes the ``nb``
    prompt-covering pages of its dense prefill rows into the slot's blocks
    (``kv_pool.write_span``, the one pool write path) and takes the slot's
    table row; a dense layer (a sliding-window ring too, in either layout)
    copies the whole row."""
    for (stacked, bigc), (_, smallc) in zip(_cache_dicts(cfg, big), _cache_dicts(cfg, small)):
        if "table" in bigc:
            bs = bigc["kpool"].shape[-3]
            start = torch.zeros((1,), dtype=torch.int32, device=table_row.device)
            layers = bigc["kpool"].shape[0] if stacked else 1
            for name, dense in (("kpool", smallc["k"]), ("vpool", smallc["v"])):
                for r in range(layers):
                    pool = bigc[name][r] if stacked else bigc[name]
                    rows = dense[r] if stacked else dense
                    kv_pool.write_span(pool, table_row[None], start, rows[:, : nb * bs])
            bigc["table"][..., slot, :] = table_row
        else:
            for name in bigc:
                if stacked:
                    bigc[name][:, slot] = smallc[name][:, 0]
                else:
                    bigc[name][slot] = smallc[name][0]


def _set_tables(cfg: ModelConfig, big, slot: int, table_row: Tensor) -> None:
    """Rewrite one slot's block-table row in every paged layer."""
    for _, c in _cache_dicts(cfg, big):
        if "table" in c:
            c["table"][..., slot, :] = table_row


def _copy_block(cfg: ModelConfig, big, src: int, dst: int) -> None:
    """Copy one pool page ``src`` -> ``dst`` in every paged layer's K and V
    pools (``kv_pool.copy_block``): the engine's copy-on-write, so a slot
    about to write inside a shared block writes a private copy."""
    for stacked, c in _cache_dicts(cfg, big):
        if "table" not in c:
            continue
        for name in ("kpool", "vpool"):
            for pool in (c[name] if stacked else (c[name],)):
                kv_pool.copy_block(pool, src, dst)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class ContinuousBatchingEngine:
    """Request queue + slot admission/eviction over one fixed-width decode
    batch (see the module docstring).

    Parameters
    ----------
    num_slots : the decode batch width — concurrent in-flight requests.
    max_len : per-slot sequence capacity (prompt + generated).
    scfg : engine-level sampling signature (temperature / top_k /
        stop_tokens); per-request knobs are ``max_new_tokens`` and ``seed``.
    layout : "paged" (KV in a shared block pool) or "dense" (per-slot
        buffers); interchangeable — same token streams.
    num_blocks : pool size per paged layer; default full occupancy
        (``num_slots * max_len / block_size``).  When blocks run out
        mid-flight the youngest request is preempted back to the queue.
    chunk : decode steps per engine step (one host fetch per chunk).
    prefill_chunk : token budget per engine step for admission prefill;
        ``None`` admits with one-shot prefill.  Configs where slicing would
        change streams (:func:`_chunked_prefill_safe`) fall back to one-shot.
    prefix_cache : automatic prefix caching (paged layout only; with
        ``layout="dense"`` it raises): admission reuses every leading
        cached block of the prompt and prefills only the suffix; a fully
        cached prompt copies its final shared page on write.  Configs that
        fail :func:`_prefix_cache_safe` decline with one log and run cold.
        Hits, misses, reused tokens and copies land on the
        ``prefix_cache_*_total`` counters and the trace.
    clock : optional clock — a callable returning seconds, or an object
        with ``now()`` and optionally ``sleep(dt)`` (``ManualClock``).  By
        default a virtual clock advances one tick per decode chunk and
        ``Request.arrival`` is in ticks.
    max_queue, overload_policy : bound on the admission queue; a submit
        into a full queue sheds the new request (``"reject"``) or the
        oldest queued one (``"shed_oldest"``) with reason ``"shed"``.
    watchdog_steps : consecutive no-progress steps (while work is ready)
        tolerated before ``step`` raises :class:`SchedulerStall`.
    faults : optional :class:`~repro_torch.serve.faults.FaultInjector`;
        ``None`` runs exactly the fault-free engine.
    metrics : optional :class:`MetricsRegistry` to record into; by default
        the engine owns a private one.
    tracer : optional :class:`~repro_torch.serve.tracing.RequestTracer`:
        one event a lifecycle edge (submitted, block_alloc, admitted,
        prefill_chunk, first_token, decode_chunk, finished, block_free,
        preempted, stall, prefix_hit, block_cow, fault_*), stamped with the
        engine clock; may be attached later (``eng.tracer = ...``).
    device : the device the params live on (default: the CUDA device).
    """

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        num_slots: int,
        max_len: int,
        scfg: Optional[SamplerConfig] = None,
        *,
        layout: str = "paged",
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        chunk: int = 8,
        prefill_chunk: Optional[int] = None,
        prefix_cache: bool = False,
        clock: Optional[Callable[[], float]] = None,
        max_queue: Optional[int] = None,
        overload_policy: str = "reject",
        watchdog_steps: int = 256,
        faults: Optional[FaultInjector] = None,
        metrics: Optional[MetricsRegistry] = None,
        tracer: Optional[RequestTracer] = None,
        device=None,
    ):
        if cfg.family == "encdec":
            raise NotImplementedError("continuous batching is decoder-only")
        if layout not in ("dense", "paged"):
            raise ValueError(f"unknown cache layout {layout!r}")
        if layout == "paged" and max_len % block_size:
            raise ValueError("max_len must be a multiple of block_size")
        if overload_policy not in ("reject", "shed_oldest"):
            raise ValueError(f"unknown overload policy {overload_policy!r}")
        if prefix_cache and layout != "paged":
            raise ValueError("prefix_cache requires the paged layout (content-hash identity "
                             "lives on pool blocks)")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.params, self.cfg = params, cfg
        self.device = resolve_device(device)
        self.num_slots, self.max_len = num_slots, max_len
        self.scfg = scfg or SamplerConfig()
        self.layout, self.block_size, self.chunk = layout, block_size, chunk
        self.max_blocks = kv_pool.blocks_for(max_len, block_size)
        self.num_blocks = num_blocks or num_slots * self.max_blocks
        self.faults, self.tracer = faults, tracer
        # every engine owns a registry; all instrumentation is host-side
        # Python at chunk boundaries over data already fetched
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._m_submitted = m.counter("requests_submitted_total")
        self._m_finished = {
            r: m.counter("requests_finished_total", reason=r) for r in sorted(FINISH_REASONS)
        }
        self._m_shed = m.counter("shed_requests_total")
        self._m_rejected = m.counter("rejected_requests_total")
        self._m_deadline = m.counter("deadline_misses_total")
        self._m_quarantined = m.counter("quarantined_total")
        self._m_preempt = m.counter("preemptions_total")
        self._m_restarts = m.counter("restarts_total")
        self._m_admissions = m.counter("admissions_total")
        self._m_tokens = m.counter("tokens_generated_total")
        self._m_prefill_tokens = m.counter("prefill_tokens_total")
        self._m_transfers = m.counter("host_transfers_total")
        self._m_steps = m.counter("engine_steps_total")
        self._m_queue_depth = m.gauge("admission_queue_depth")
        self._m_queue_peak = m.gauge("admission_queue_peak")
        self._m_occupancy = m.gauge("batch_occupancy")
        self._m_ttft = m.histogram("ttft_seconds")
        self._m_itl = m.histogram("itl_seconds")
        self._m_latency = m.histogram("request_latency_seconds")
        # registered whether or not caching is on, so every snapshot has them
        self._m_pc_hits = m.counter("prefix_cache_hits_total")
        self._m_pc_misses = m.counter("prefix_cache_misses_total")
        self._m_pc_hit_tokens = m.counter("prefix_cache_hit_tokens_total")
        self._m_pc_cow = m.counter("prefix_cache_cow_total")
        self.allocator = (
            kv_pool.BlockAllocator(self.num_blocks,
                                   fail_hook=faults.on_alloc if faults is not None else None,
                                   metrics=m)
            if layout == "paged" else None
        )
        self._clock, self._sleep = resolve_clock(clock)
        self._now = 0.0  # virtual clock (chunk ticks) when clock is None
        if faults is not None:
            # fired faults land on the trace (checked at fire time, so a
            # tracer attached later still sees them)
            faults.on_fire = self._on_fault
        self.max_queue, self.overload_policy = max_queue, overload_policy
        self.watchdog_steps = watchdog_steps
        self._admitted_uids: set[int] = set()  # restart detection
        self._stall_steps = 0
        self._step_idx = 0

        self._queue: collections.deque[Request] = collections.deque()
        # zero-token finishes produced outside step() (shed / rejected at
        # submit), drained into the next step's return value
        self._pending_finished: list[FinishedRequest] = []
        self._slots: list[Optional[RequestState]] = [None] * num_slots
        self._uid_counter = 0  # monotonic: uids never recycle
        self._stop_set = set(int(t) for t in self.scfg.stop_tokens)
        # the stop tokens on the device, made once: a host-to-device copy
        # inside the decode loop would stall it
        self._stop = (
            torch.tensor(self.scfg.stop_tokens, dtype=torch.int32).to(self.device)
            if self.scfg.stop_tokens else None
        )

        self._caches = self._init_big_caches()
        b, dev = num_slots, self.device
        self._state = {
            "tok": torch.zeros((b,), dtype=torch.int32, device=dev),
            "pos": torch.zeros((b,), dtype=torch.int32, device=dev),
            "active": torch.zeros((b,), dtype=torch.bool, device=dev),
            "ngen": torch.zeros((b,), dtype=torch.int32, device=dev),
            "budget": torch.zeros((b,), dtype=torch.int32, device=dev),
        }

        self.prefill_chunk = (
            prefill_chunk if (prefill_chunk is not None and _chunked_prefill_safe(cfg)) else None
        )
        if prefill_chunk is not None and self.prefill_chunk is None:
            _log_chunked_prefill_decline(cfg)
        self.prefix_cache = bool(prefix_cache) and _prefix_cache_safe(cfg)
        if prefix_cache and not self.prefix_cache:
            _log_prefix_cache_decline(cfg)
        self._prefill = _make_checked_prefill_fn(cfg, max_len, self.scfg)
        self._prefill_bucketed = (
            _make_bucketed_prefill_fn(cfg, max_len, self.scfg)
            if _bucketed_prefill_safe(cfg, max_len) else None
        )

    # -- observability ------------------------------------------------------
    #
    # Counter attributes as properties over registry metrics (with setters,
    # so a caller can reset them).

    def _alias(metric):  # noqa: N805 — descriptor factory, not a method
        def get(self):
            return int(getattr(self, metric).value)

        def set_(self, v):
            getattr(self, metric).value = v

        return property(get, set_)

    shed_requests = _alias("_m_shed")
    rejected_requests = _alias("_m_rejected")
    deadline_misses = _alias("_m_deadline")
    quarantined = _alias("_m_quarantined")
    preemptions = _alias("_m_preempt")
    admissions = _alias("_m_admissions")
    tokens_generated = _alias("_m_tokens")
    prefill_tokens = _alias("_m_prefill_tokens")
    host_transfers = _alias("_m_transfers")
    queue_peak = _alias("_m_queue_peak")
    del _alias

    @property
    def finished_by_reason(self) -> dict[str, int]:
        """Cumulative finished-request totals per ``finish_reason``."""
        return {r: int(c.value) for r, c in self._m_finished.items()}

    def snapshot(self) -> dict:
        """The engine's metrics snapshot (``MetricsRegistry.snapshot``)."""
        return self.metrics.snapshot()

    def _on_fault(self, kind: str, info: dict) -> None:
        if self.tracer is not None:
            self.tracer.emit(f"fault_{kind}", t=self.now(), **info)

    def _emit_finished(self, fr: FinishedRequest) -> FinishedRequest:
        """The single finish chokepoint: every FinishedRequest passes here
        exactly once, so per-reason totals conserve requests and the
        latency histograms see every finish."""
        self._m_finished[fr.finish_reason].inc()
        n = len(fr.tokens)
        if n > 0:
            self._m_ttft.observe(max(0.0, fr.first_token_at - fr.arrival))
            self._m_itl.observe(max(0.0, fr.finished_at - fr.first_token_at) / max(1, n - 1))
        self._m_latency.observe(max(0.0, fr.finished_at - fr.arrival))
        if self.tracer is not None:
            self.tracer.emit("finished", t=fr.finished_at, uid=fr.uid,
                             reason=fr.finish_reason, n_tokens=n)
        return fr

    def _trace(self, event: str, uid: Optional[int] = None, **fields) -> None:
        if self.tracer is not None:
            self.tracer.emit(event, t=self.now(), uid=uid, **fields)

    def _release_blocks(self, blocks: list[int], uid: int) -> None:
        """Drop a request's references on its blocks (the one release
        path).  With prefix caching a registered block whose last
        reference drops parks on the allocator's LRU, still hittable."""
        if blocks:
            self.allocator.unref(blocks)
            self._trace("block_free", uid=uid, n_blocks=len(blocks))

    # -- construction -------------------------------------------------------

    def _init_big_caches(self):
        """The num_slots-wide cache tree, in the type prefill produces (the
        embedding's), so installing a prefilled row never casts."""
        dtype = self.params["embed"]["table"].dtype
        return api.init_cache(self.cfg, self.num_slots, self.max_len, dtype, self.device,
                              layout=self.layout, block_size=self.block_size,
                              num_blocks=self.num_blocks)

    # -- host boundary ------------------------------------------------------

    def _fetch(self, x: Tensor) -> np.ndarray:
        self.host_transfers += 1
        return x.cpu().numpy()

    def _to_device(self, a: np.ndarray) -> Tensor:
        return torch.from_numpy(a).to(self.device)

    def _generator(self, seed: int) -> Optional[torch.Generator]:
        """A request's sampling generator (None when greedy), seeded as
        ``DecodeEngine.generate(..., seed=seed)`` seeds its own."""
        if self.scfg.temperature == 0.0:
            return None
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def now(self) -> float:
        return self._clock() if self._clock is not None else self._now

    # -- public API ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens: Optional[int] = None, seed: int = 0,
               uid: Optional[int] = None, arrival: float = 0.0,
               deadline: Optional[float] = None, ttft_budget: Optional[float] = None) -> int:
        """Queue a request; returns its uid.

        Requests that can never be served (prompt + budget beyond a slot,
        or beyond the whole pool) raise :class:`InadmissibleRequest`.  A
        deadline already unmeetable at submit finishes with reason
        ``"rejected"``; a full bounded queue sheds per ``overload_policy``
        (reason ``"shed"``); both surface on the next ``step``/``run``."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        budget = self.scfg.max_new_tokens if max_new_tokens is None else max_new_tokens
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if budget < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {budget}")
        total = len(prompt) + budget
        if total > self.max_len:
            raise InadmissibleRequest(
                f"prompt ({len(prompt)}) + budget ({budget}) exceeds the "
                f"slot capacity max_len={self.max_len}"
            )
        if self.allocator is not None:
            need = kv_pool.blocks_for(total, self.block_size)
            if need > self.num_blocks:
                raise InadmissibleRequest(
                    f"request needs {need} blocks but the pool has only {self.num_blocks}"
                )
        if uid is None:
            uid = self._uid_counter
        self._uid_counter = max(self._uid_counter, uid + 1)
        if self.faults is not None:
            arrival += self.faults.arrival_delay(uid)
        req = Request(uid, prompt, budget, seed=seed, arrival=arrival, deadline=deadline,
                      ttft_budget=ttft_budget)
        # counted only once validation passed, so submitted == finished
        self._m_submitted.inc()
        self._trace("submitted", uid=uid, arrival=req.arrival, prompt_len=len(prompt))
        if (deadline is not None and deadline <= arrival) or (
            ttft_budget is not None and ttft_budget <= 0
        ):
            self.rejected_requests += 1
            self._pending_finished.append(self._finish_unstarted(req, "rejected"))
            return uid
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            if self.overload_policy == "reject":
                self.shed_requests += 1
                self._pending_finished.append(self._finish_unstarted(req, "shed"))
                return uid
            victim = self._queue.popleft()  # shed_oldest
            self.shed_requests += 1
            self._pending_finished.append(self._finish_unstarted(victim, "shed"))
        self._queue.append(req)
        self.queue_peak = max(self.queue_peak, len(self._queue))
        self._m_queue_depth.set(len(self._queue))
        return uid

    def _finish_unstarted(self, req: Request, reason: str) -> FinishedRequest:
        """A zero-token finish for a request that never got a first token."""
        assert reason in FINISH_REASONS, reason
        now = self.now()
        return self._emit_finished(FinishedRequest(
            req.uid, np.zeros((0,), np.int32), reason, len(req.prompt),
            req.arrival, now, now, now,
        ))

    def run(self) -> list[FinishedRequest]:
        """Process the queue to completion; FinishedRequests in completion
        order."""
        finished: list[FinishedRequest] = []
        while self._queue or self._live() or self._pending_finished:
            finished.extend(self.step())
        return finished

    def step(self) -> list[FinishedRequest]:
        """One scheduling tick: surface pending zero-token finishes, enforce
        deadlines, admit arrived requests, advance at most one admitting
        prompt by one prefill slice, ensure pool blocks for the coming
        chunk, run one decode chunk, evict finished requests.  Returns the
        requests that finished this tick.  A tick that makes no progress
        while work is ready counts toward ``watchdog_steps``."""
        before = (self.tokens_generated, self.prefill_tokens)
        finished = self._step_body()
        self._step_idx += 1
        self._m_steps.inc()
        self._m_queue_depth.set(len(self._queue))
        self._m_occupancy.set(len(self._live()))
        progressed = bool(finished) or (self.tokens_generated, self.prefill_tokens) != before
        now = self.now()
        work_ready = bool(self._live()) or any(r.arrival <= now for r in self._queue)
        if progressed or not work_ready:
            self._stall_steps = 0
        else:
            self._stall_steps += 1
            if self._stall_steps >= self.watchdog_steps:
                report = self._stall_report()
                self._trace("stall", steps=self._stall_steps, report=report)
                raise SchedulerStall(report)
        return finished

    def _step_body(self) -> list[FinishedRequest]:
        finished = self._drain_pending()
        finished.extend(self._expire_deadlines())
        self._injected_preemptions()
        finished.extend(self._admit_arrived())
        finished.extend(self._prefill_tick())
        if not any(rs.n_generated > 0 for rs in self._live()):
            if self._live():
                # every occupied slot is still admitting: the slice above
                # was this tick's work
                if self._clock is None:
                    self._now += 1.0
            elif self._queue:
                self._advance_clock()
            return finished
        if self.allocator is not None:
            self._ensure_blocks()
        with annotate("serve/decode_chunk"):
            packed = self._fetch(self._run_chunk())
        if self._clock is None:
            self._now += 1.0
        self._trace("decode_chunk", step=self._step_idx,
                    n_decoding=sum(1 for rs in self._live() if rs.n_generated > 0))
        finished.extend(self._process_chunk(packed))
        return finished

    def _drain_pending(self) -> list[FinishedRequest]:
        out, self._pending_finished = self._pending_finished, []
        return out

    def _stall_report(self) -> str:
        live = [
            f"(uid={rs.request.uid} slot={rs.slot} ngen={rs.n_generated} "
            f"prefilled={rs.prefilled}/{len(rs.request.prompt)} blocks={len(rs.blocks)})"
            for rs in self._live()
        ]
        alloc = (
            f"{self.allocator.free_count}/{self.num_blocks} blocks free"
            if self.allocator is not None else "dense layout (no allocator)"
        )
        return (
            f"scheduler made no progress for {self._stall_steps} steps "
            f"(step {self._step_idx}, t={self.now():.3f}): queue depth "
            f"{len(self._queue)}, live slots [{', '.join(live) or 'none'}], "
            f"{alloc}, preemptions={self.preemptions}"
        )

    def _injected_preemptions(self) -> None:
        """Apply the injector's preemptions for this step (a chunk
        boundary), through the path pool pressure takes."""
        if self.faults is None:
            return
        for uid in self.faults.preempt_uids(self._step_idx):
            live = self._live()
            if not live:
                return
            rs = (max(live, key=lambda r: r.admitted_at) if uid is None
                  else next((r for r in live if r.request.uid == uid), None))
            if rs is not None:
                self.faults.fire("force_preempt", uid=rs.request.uid, step=self._step_idx)
                self._preempt(rs)

    def _deadline_missed(self, req: Request, now: float, has_first: bool) -> bool:
        if req.deadline is not None and now > req.deadline:
            return True
        return (not has_first and req.ttft_budget is not None
                and now > req.arrival + req.ttft_budget)

    def _expire_deadlines(self) -> list[FinishedRequest]:
        """Chunk-boundary deadline enforcement: expired queued requests
        finish with zero tokens; expired live ones are evicted with their
        partial stream and their blocks reclaimed, mid-chunked-prefill
        too."""
        now = self.now()
        finished: list[FinishedRequest] = []
        if any(r.deadline is not None or r.ttft_budget is not None for r in self._queue):
            keep: collections.deque[Request] = collections.deque()
            for r in self._queue:
                if self._deadline_missed(r, now, has_first=False):
                    self.deadline_misses += 1
                    finished.append(self._finish_unstarted(r, "deadline"))
                else:
                    keep.append(r)
            self._queue = keep
        for rs in list(self._live()):
            req = rs.request
            if not self._deadline_missed(req, now, rs.n_generated > 0):
                continue
            self.deadline_misses += 1
            if rs.n_generated > 0:  # admitting slots were never activated
                self._state["active"][rs.slot] = False
            self._register_blocks(rs)
            self._release_blocks(rs.blocks, req.uid)
            self._slots[rs.slot] = None
            finished.append(self._emit_finished(FinishedRequest(
                req.uid, np.asarray(rs.tokens, np.int32), "deadline", len(req.prompt),
                req.arrival, rs.admitted_at,
                rs.first_token_at if rs.n_generated > 0 else now, now,
            )))
        return finished

    # -- scheduling internals ----------------------------------------------

    def _live(self) -> list[RequestState]:
        return [rs for rs in self._slots if rs is not None]

    def _advance_clock(self) -> None:
        """Nothing in flight: jump (virtual) or wait (real) to the next
        arrival."""
        nxt = min(r.arrival for r in self._queue)
        if self._clock is None:
            self._now = max(self._now, float(nxt))
        else:
            self._sleep(max(0.0, min(nxt - self.now(), 0.05)))

    def _admit_arrived(self) -> list[FinishedRequest]:
        """FIFO-admit every arrived request that fits a free slot (and, if
        paged, whose prompt blocks are available).  With chunked prefill
        the slot is only occupied here; on the one-shot path a request
        whose first token already finishes it never occupies a slot."""
        finished = []
        while True:
            free = [i for i, rs in enumerate(self._slots) if rs is None]
            if not free:
                break
            req = self._pop_ready()
            if req is None:
                break
            blocks: list[int] = []
            prefilled0, hashes, n_hit = 0, [], 0
            if self.allocator is not None:
                res = self._alloc_prompt_blocks(req)
                if res is None:
                    # pool full: requeue at the head, wait for evictions
                    self._queue.appendleft(req)
                    break
                blocks, prefilled0, hashes, n_hit = res
                self._trace("block_alloc", uid=req.uid, n_blocks=len(blocks))
            self.admissions += 1
            if req.uid in self._admitted_uids:
                self._m_restarts.inc()  # re-admission after preemption
            self._admitted_uids.add(req.uid)
            self._trace("admitted", uid=req.uid, slot=free[0], n_blocks=len(blocks))
            if self.prefill_chunk is not None:
                self._admit_chunked(req, free[0], blocks, prefilled0, hashes, n_hit)
                continue
            if prefilled0 > 0:
                done = self._admit_cached(req, free[0], blocks, prefilled0, hashes, n_hit)
            else:
                done = self._admit(req, free[0], blocks, hashes)
            if done is not None:
                finished.append(done)
        return finished

    def _alloc_prompt_blocks(self, req: Request):
        """The blocks covering an admitting prompt, or None if the pool
        cannot give them now (nothing changes then beyond LRU recency).

        With prefix caching this is the admission hit walk: every leading
        block of the prompt's chain found in the hash index is referenced
        (before the tail is allocated, so the tail's alloc cannot evict a
        hit) and only the rest is allocated.  A block-aligned, fully cached
        prompt still recomputes its last position, inside the final shared
        block: that block is copied to a private page first.

        Returns ``(blocks, prefilled0, hashes, n_hit)``: the slot's blocks,
        how many leading prompt tokens are already resident, the prompt's
        full-block chain hashes and how many leading blocks were hits."""
        s = len(req.prompt)
        nb = kv_pool.blocks_for(s, self.block_size)
        if not self.prefix_cache:
            got = self.allocator.alloc(nb)
            return (got, 0, [], 0) if got is not None else None
        hashes = kv_pool.prompt_block_hashes(req.prompt, self.block_size)
        hits: list[int] = []
        for h in hashes:
            b = self.allocator.lookup(h)
            if b is None:
                break
            hits.append(b)
        for b in hits:
            self.allocator.ref(b)
        cached = len(hits) * self.block_size
        cow = cached == s  # fully cached: the last position lies in a hit block
        got = self.allocator.alloc(nb - len(hits) + (1 if cow else 0))
        if got is None:
            self.allocator.unref(hits)
            return None
        self._m_pc_hits.inc(len(hits))
        self._m_pc_misses.inc(len(hashes) - len(hits))
        blocks = hits + got
        prefilled0 = min(cached, s - 1)
        self._m_pc_hit_tokens.inc(prefilled0)
        if cow:
            src, dst = blocks[len(hits) - 1], blocks.pop()
            with annotate("serve/prefix_cow"):
                _copy_block(self.cfg, self._caches, src, dst)
            blocks[len(hits) - 1] = dst
            self.allocator.unref([src])
            self._m_pc_cow.inc()
            self._trace("block_cow", uid=req.uid, src=src, dst=dst)
        if hits:
            self._trace("prefix_hit", uid=req.uid, n_blocks=len(hits), n_tokens=prefilled0)
        return blocks, prefilled0, hashes, len(hits)

    def _register_blocks(self, rs: RequestState) -> None:
        """Register every full block whose pages are written (and take no
        more writes) in the allocator's hash index, so later admissions hit
        them.  On release the chain extends over generated tokens; the last
        sampled token's KV is written only when it is fed, so decode
        coverage stops one short of ``n_generated``."""
        if not self.prefix_cache:
            return
        bs = self.block_size
        req = rs.request
        s = len(req.prompt)
        covered = s + rs.n_generated - 1 if rs.n_generated > 0 else rs.prefilled
        n_full = min(covered // bs, len(rs.blocks))
        if rs.registered >= n_full:
            return
        h = rs.block_hashes
        if len(h) < n_full:  # extend the chain over generated tokens
            stream = np.concatenate([req.prompt, np.asarray(rs.tokens, np.int32)])
            while len(h) < n_full:
                i = len(h)
                h.append(kv_pool.hash_block_tokens(h[i - 1] if i else None,
                                                   stream[i * bs : (i + 1) * bs]))
        while rs.registered < n_full:
            self.allocator.register(rs.blocks[rs.registered], h[rs.registered])
            rs.registered += 1

    def _pop_ready(self) -> Optional[Request]:
        """Pop the first queued request that has arrived."""
        now = self.now()
        for i, r in enumerate(self._queue):
            if r.arrival <= now:
                if i == 0:
                    return self._queue.popleft()
                del self._queue[i]
                return r
        return None

    def _admit_chunked(self, req: Request, slot: int, blocks: list[int], prefilled0: int = 0,
                       hashes=(), n_hit: int = 0) -> None:
        """Occupy a slot without running prefill: install its block table
        (paged) and let :meth:`_prefill_tick` stream the prompt in.  A
        prefix-cache hit starts the slice cursor at the cached boundary
        ``prefilled0``."""
        if blocks:
            _set_tables(self.cfg, self._caches, slot, self._table_row(blocks))
        self._slots[slot] = RequestState(
            request=req, slot=slot, blocks=blocks, tokens=[], n_generated=0,
            admitted_at=self.now(), prefilled=prefilled0, block_hashes=list(hashes),
            registered=n_hit,
        )

    def _prefill_slice(self, slot: int, tokens: np.ndarray, start: int, t: int) -> Tensor:
        """One ``t``-token ``forward_chunk`` slice of one slot's prompt
        tokens at position ``start``, straight into the big caches (every
        other slot masked out, a ragged slice right-padded and gated by
        ``lengths``).  Returns the slot's (1, V) logits at its last token."""
        n, b = len(tokens), self.num_slots
        toks = np.zeros((b, t), np.int64)
        toks[slot, :n] = tokens
        pos = np.zeros((b,), np.int32)
        pos[slot] = start
        active = np.zeros((b,), bool)
        active[slot] = True
        lengths = np.zeros((b,), np.int32)
        lengths[slot] = n
        lengths_d = self._to_device(lengths)
        logits, _ = api.forward_chunk(
            self.params, self._to_device(toks), self._caches, self._to_device(pos),
            self.cfg, active=self._to_device(active), lengths=lengths_d,
            logits_at=torch.clamp(lengths_d - 1, min=0),
        )
        return logits[slot : slot + 1]

    def _first_token(self, row: Tensor, gen) -> tuple[Tensor, int, bool]:
        """Sample the first token from a prompt's last logits row and fetch
        it with its finite bit: the admission's one packed ``[tok0, ok]``
        fetch.  Returns (the token on the device, tok0, ok)."""
        tok0 = sample_token(gen, row, self.scfg)
        ok = torch.isfinite(row).all(dim=-1)
        tok_d = torch.stack([tok0[0], ok[0].to(torch.int32)])
        arr = self._fetch(tok_d)
        return tok_d[0], int(arr[0]), bool(arr[1])

    def _prefill_tick(self) -> list[FinishedRequest]:
        """Advance at most ONE admitting request's prompt by one
        ``prefill_chunk``-token slice.  The slice that completes the prompt
        samples the first token with the request's fresh generator — the
        one-shot path's draw."""
        if self.prefill_chunk is None:
            return []
        pending = [rs for rs in self._live() if rs.prefilled < len(rs.request.prompt)]
        if not pending:
            return []
        rs = min(pending, key=lambda r: (r.admitted_at, r.slot))
        req = rs.request
        s = len(req.prompt)
        n = min(self.prefill_chunk, s - rs.prefilled)
        with annotate("serve/chunked_prefill"):
            row = self._prefill_slice(rs.slot, req.prompt[rs.prefilled : rs.prefilled + n],
                                      rs.prefilled, self.prefill_chunk)
        rs.prefilled += n
        self.prefill_tokens += n
        # blocks this slice finished filling become hittable (their writes
        # are issued; stream order makes every later reader safe)
        self._register_blocks(rs)
        self._trace("prefill_chunk", uid=req.uid, prefilled=rs.prefilled, total=s)
        if rs.prefilled < s:
            return []
        rs.gen = self._generator(req.seed)
        tok_d, tok0, ok = self._first_token(row, rs.gen)
        now = self.now()
        if not ok:
            self.quarantined += 1
            self._release_blocks(rs.blocks, req.uid)
            self._slots[rs.slot] = None
            return [self._emit_finished(FinishedRequest(
                req.uid, np.zeros((0,), np.int32), "error", s, req.arrival, rs.admitted_at,
                now, now,
            ))]
        self.tokens_generated += 1
        self._trace("first_token", uid=req.uid)
        done = self._finish_at_admission(req, tok0, rs.blocks, rs.admitted_at)
        if done is not None:
            self._slots[rs.slot] = None
            return [done]
        self._admit_state(rs.slot, tok_d, s, req.max_new_tokens)
        rs.tokens = [tok0]
        rs.n_generated = 1
        rs.first_token_at = now
        return []

    def _finish_at_admission(self, req: Request, tok0: int, blocks: list[int],
                             admitted_at: float) -> Optional[FinishedRequest]:
        """The first sampled token already finishes the request (stop hit
        or budget 1): free its blocks and emit the FinishedRequest.
        Returns None if the request lives on."""
        if tok0 not in self._stop_set and req.max_new_tokens != 1:
            return None
        reason = "stop" if tok0 in self._stop_set else "length"
        self._release_blocks(blocks, req.uid)
        now = self.now()
        return self._emit_finished(FinishedRequest(
            req.uid, np.asarray([tok0], np.int32), reason, len(req.prompt), req.arrival,
            admitted_at, now, now,
        ))

    def _bucket_len(self, s: int) -> int:
        """Smallest power of two >= s, capped at the slot capacity."""
        b = 1
        while b < s:
            b <<= 1
        return min(b, self.max_len)

    def _admission_prefill(self, req: Request, gen):
        """Batch-1 prefill for admission: bucketed where parity-safe,
        exact-length otherwise."""
        if self._prefill_bucketed is not None:
            s = len(req.prompt)
            padded = np.zeros((1, self._bucket_len(s)), np.int64)
            padded[0, :s] = req.prompt
            return self._prefill_bucketed(self.params, self._to_device(padded), s, gen)
        return self._prefill(self.params, self._to_device(req.prompt[None].astype(np.int64)), gen)

    def _admit_cached(self, req: Request, slot: int, blocks: list[int], prefilled0: int,
                      hashes: list[int], n_hit: int) -> Optional[FinishedRequest]:
        """One-shot admission on a prefix-cache hit: the first
        ``prefilled0`` prompt tokens are resident in the reused blocks, so
        only the suffix runs, as ONE ``forward_chunk`` slice padded to a
        power-of-two bucket, the chunked-prefill machinery.  The first
        token is drawn from the slice's row with a fresh generator, as the
        cold admission draws it."""
        s = len(req.prompt)
        _set_tables(self.cfg, self._caches, slot, self._table_row(blocks))
        n = s - prefilled0
        with annotate("serve/admission_prefill"):
            row = self._prefill_slice(slot, req.prompt[prefilled0:], prefilled0,
                                      self._bucket_len(n))
        self.prefill_tokens += n
        gen = self._generator(req.seed)
        tok_d, tok0, ok = self._first_token(row, gen)
        now = self.now()
        if not ok:
            self.quarantined += 1
            self._release_blocks(blocks, req.uid)
            return self._emit_finished(FinishedRequest(
                req.uid, np.zeros((0,), np.int32), "error", s, req.arrival, now, now, now,
            ))
        # the slice wrote every miss block; registered only after the finite
        # check, so a poisoned page is never indexed
        for i in range(n_hit, len(hashes)):
            self.allocator.register(blocks[i], hashes[i])
        self.tokens_generated += 1
        self._trace("first_token", uid=req.uid)
        done = self._finish_at_admission(req, tok0, blocks, now)
        if done is not None:
            return done
        self._admit_state(slot, tok_d, s, req.max_new_tokens)
        self._slots[slot] = RequestState(
            request=req, slot=slot, blocks=blocks, tokens=[tok0], n_generated=1,
            admitted_at=now, prefilled=s, first_token_at=now, gen=gen,
            block_hashes=list(hashes), registered=len(hashes),
        )
        return None

    def _admit(self, req: Request, slot: int, blocks: list[int],
               hashes=()) -> Optional[FinishedRequest]:
        gen = self._generator(req.seed)
        with annotate("serve/admission_prefill"):
            tok0_d, small, pos0 = self._admission_prefill(req, gen)
        # one packed [tok0, finite] fetch per admission
        arr = self._fetch(tok0_d)
        tok0, ok = int(arr[0]), bool(arr[1])
        now = self.now()
        if not ok:
            self.quarantined += 1
            self._release_blocks(blocks, req.uid)
            return self._emit_finished(FinishedRequest(
                req.uid, np.zeros((0,), np.int32), "error", len(req.prompt), req.arrival,
                now, now, now,
            ))
        self.tokens_generated += 1
        self._trace("first_token", uid=req.uid)
        done = self._finish_at_admission(req, tok0, blocks, now)
        if done is not None:
            # nothing was installed into the blocks, so nothing registers
            return done
        table_row = self._table_row(blocks) if blocks else None
        _install(self.cfg, self._caches, small, slot, table_row, len(blocks))
        self._admit_state(slot, tok0_d[0], pos0, req.max_new_tokens)
        # the install span-wrote every prompt page: full blocks are hittable
        for i, h in enumerate(hashes):
            self.allocator.register(blocks[i], h)
        self._slots[slot] = RequestState(
            request=req, slot=slot, blocks=blocks, tokens=[tok0], n_generated=1,
            admitted_at=now, prefilled=len(req.prompt), first_token_at=now, gen=gen,
            block_hashes=list(hashes), registered=len(hashes),
        )
        return None

    def _admit_state(self, slot: int, tok0: Tensor, pos0: int, budget: int) -> None:
        """Write one slot's device-side lifecycle state (ngen starts at 1:
        the prefill-sampled first token is emitted at admission)."""
        st = self._state
        st["tok"][slot] = tok0
        st["pos"][slot] = pos0
        st["active"][slot] = True
        st["ngen"][slot] = 1
        st["budget"][slot] = budget

    def _table_row(self, blocks: list[int]) -> Tensor:
        """A slot's table row, built on the host and copied once."""
        row = np.zeros((self.max_blocks,), np.int32)
        row[: len(blocks)] = blocks
        return self._to_device(row)

    def _ensure_blocks(self) -> None:
        """Grow each live slot's block list to cover the coming chunk,
        preempting the youngest request if the pool runs dry."""
        for rs in sorted(self._live(), key=lambda r: r.admitted_at):
            if self._slots[rs.slot] is not rs:
                continue  # preempted by an earlier iteration of this loop
            if rs.n_generated == 0:
                continue  # still admitting: blocks already cover the prompt
            total_cap = len(rs.request.prompt) + rs.request.max_new_tokens
            need = kv_pool.blocks_for(min(rs.pos + self.chunk, total_cap), self.block_size)
            while need > len(rs.blocks):
                got = self.allocator.alloc(need - len(rs.blocks))
                if got is None:
                    victim = self._pick_victim()
                    if victim is None:
                        raise SchedulerStall(
                            "KV pool exhausted and nothing to preempt — pool too small "
                            "for the admitted working set: " + self._stall_report()
                        )
                    self._preempt(victim)
                    if victim is rs:
                        break  # the requester itself was youngest: requeued
                    continue
                rs.blocks.extend(got)
                self._trace("block_alloc", uid=rs.request.uid, n_blocks=len(got))
                _set_tables(self.cfg, self._caches, rs.slot, self._table_row(rs.blocks))

    def _pick_victim(self) -> Optional[RequestState]:
        """Youngest live request — including the one asking for blocks —
        so the oldest always advances (no livelock)."""
        live = self._live()
        return max(live, key=lambda r: r.admitted_at) if live else None

    def _preempt(self, rs: RequestState) -> None:
        """Return a request to the queue head; its blocks are reclaimed and
        it restarts from scratch on re-admission (same seed, same stream)."""
        self.preemptions += 1
        self._trace("preempted", uid=rs.request.uid, n_generated=rs.n_generated)
        self._state["active"][rs.slot] = False
        # a preempted stream's blocks stay hittable: its restart walks the
        # same chain and resumes from the cached prefix
        self._register_blocks(rs)
        self._release_blocks(rs.blocks, rs.request.uid)
        self._slots[rs.slot] = None
        self._queue.appendleft(rs.request)

    def _sample(self, logits: Tensor, decoding: list[RequestState]) -> Tensor:
        """(B,) next tokens: greedy argmax per row, or each decoding slot's
        (1, V) draw from its own generator (rows of other slots are masked
        out by the caller)."""
        if self.scfg.temperature == 0.0:
            return sample_token(None, logits, self.scfg)
        nxt = torch.zeros((logits.shape[0],), dtype=torch.int32, device=logits.device)
        for rs in decoding:
            nxt[rs.slot] = sample_token(rs.gen, logits[rs.slot : rs.slot + 1], self.scfg)[0]
        return nxt

    def _poison_steps(self, decoding: list[RequestState]) -> Optional[Tensor]:
        """The (B,) step inside the coming chunk at which each slot's logits
        are made NaN (-1: never), on the device, or None when the injector
        lands no poison in this chunk (the fault-free chunk)."""
        if self.faults is None or not self.faults.has_poison:
            return None
        spec = np.full((self.num_slots,), -1, np.int32)
        hit = False
        for rs in decoding:
            g = self.faults.poison_rel_step(rs.request.uid, rs.n_generated, self.chunk)
            if g is not None:
                spec[rs.slot], hit = g, True
        return self._to_device(spec) if hit else None

    def _run_chunk(self) -> Tensor:
        """``chunk`` decode steps over the slot batch, all on the device:
        per-slot positions, budgets, stop masks and the NaN/Inf quarantine
        column (``chunk`` = untouched, else the step whose logits went
        non-finite).  Returns the packed (B, chunk + 2) int32 matrix
        ``[tokens | active | quarantine]`` for the chunk's one fetch.  Only
        a chunk a scheduled poison lands in overwrites that slot's logits
        with NaN at its step."""
        length = self.chunk
        decoding = [rs for rs in self._live() if not rs.done and rs.n_generated > 0]
        poison = self._poison_steps(decoding)
        st = self._state
        tok, pos, active, ngen = st["tok"], st["pos"], st["active"], st["ngen"]
        quar = torch.full(tok.shape, length, dtype=torch.int32, device=tok.device)
        out = []
        for i in range(length):
            with annotate("serve/decode_step"):
                logits, _ = api.decode_step(self.params, tok[:, None].long(), self._caches, pos,
                                            self.cfg, active=active)
            logits = logits[:, -1]
            if poison is not None:
                logits = torch.where((poison == i)[:, None], float("nan"), logits)
            finite = torch.isfinite(logits).all(dim=-1)
            ok = active & finite
            with annotate("serve/sample"):
                nxt = torch.where(ok, self._sample(logits, decoding), tok)
            act = ok.to(torch.int32)
            ngen = ngen + act
            alive = ok & ~_hit_stop(nxt, self._stop) & (ngen < st["budget"])
            quar = torch.where(active & ~finite & (quar == length), i, quar)
            tok, pos, active = nxt, pos + act, alive
            out.append(nxt)
        st.update(tok=tok, pos=pos, active=active, ngen=ngen)
        return torch.cat([torch.stack(out, dim=1), active[:, None].to(torch.int32),
                          quar[:, None]], dim=1)

    def _process_chunk(self, packed: np.ndarray) -> list[FinishedRequest]:
        """Mirror the device's per-step lifecycle over the fetched matrix,
        then evict finished slots and reclaim their blocks.  A quarantine
        entry < chunk marks the step whose logits went non-finite: that
        slot finishes with reason ``"error"`` there."""
        steps = packed.shape[1] - 2
        quar_col = packed[:, -1]
        for step in range(steps):
            for rs in self._live():
                if rs.done or rs.n_generated == 0:
                    continue  # finished, or still admitting (no decode)
                if int(quar_col[rs.slot]) == step:
                    rs.done, rs.finish_reason = True, "error"
                    self.quarantined += 1
                    continue
                tok = int(packed[rs.slot, step])
                rs.tokens.append(tok)
                rs.n_generated += 1
                self.tokens_generated += 1
                if tok in self._stop_set:
                    rs.done, rs.finish_reason = True, "stop"
                elif rs.n_generated >= rs.request.max_new_tokens:
                    rs.done, rs.finish_reason = True, "length"
        device_active = packed[:, -2].astype(bool)
        finished = []
        now = self.now()
        for rs in self._live():
            expect_active = (not rs.done) and rs.n_generated > 0
            if bool(device_active[rs.slot]) != expect_active:
                raise AssertionError(
                    f"slot {rs.slot}: device active mask disagrees with the host mirror"
                )
            if not rs.done:
                continue
            if rs.finish_reason != "error":
                # extend the chain over the generated tokens so a multi-turn
                # follow-up hits; a quarantined stream's pages are suspect
                self._register_blocks(rs)
            self._release_blocks(rs.blocks, rs.request.uid)
            self._slots[rs.slot] = None
            req = rs.request
            finished.append(self._emit_finished(FinishedRequest(
                req.uid, np.asarray(rs.tokens, np.int32), rs.finish_reason, len(req.prompt),
                req.arrival, rs.admitted_at, rs.first_token_at, now,
            )))
        return finished
