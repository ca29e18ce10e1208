"""Serving tiers of the port: the lockstep ``DecodeEngine``
(``serve.engine``; ``repro_torch.train.serve.BatchedServer`` wraps it with
the per-token Python-loop baseline), the ``ContinuousBatchingEngine`` on
the paged KV pool with prefix caching (``serve.scheduler``,
``serve.kv_pool``), fault injection (``serve.faults``), the request
tracer (``serve.tracing``) and the metrics registry the engines record
into (``serve.metrics``)."""

from repro_torch.serve.engine import DecodeEngine, SamplerConfig, decode_logits, sample_token
from repro_torch.serve.faults import (
    AllocFailure,
    DelayArrival,
    FaultInjector,
    ForcePreempt,
    PoisonLogits,
)
from repro_torch.serve.kv_pool import BlockAllocator
from repro_torch.serve.metrics import (
    Counter,
    Gauge,
    Histogram,
    ManualClock,
    MetricsRegistry,
    MonotonicClock,
    resolve_clock,
    validate_snapshot,
)
from repro_torch.serve.scheduler import (
    FINISH_REASONS,
    ContinuousBatchingEngine,
    FinishedRequest,
    InadmissibleRequest,
    Request,
    RequestState,
    SchedulerStall,
)
from repro_torch.serve.tracing import (
    JsonlSink,
    ListSink,
    RequestTracer,
    annotate,
    fault_hook,
    maybe_profile,
)

__all__ = [
    "AllocFailure",
    "BlockAllocator",
    "ContinuousBatchingEngine",
    "Counter",
    "DecodeEngine",
    "DelayArrival",
    "FINISH_REASONS",
    "FaultInjector",
    "FinishedRequest",
    "ForcePreempt",
    "Gauge",
    "Histogram",
    "InadmissibleRequest",
    "JsonlSink",
    "ListSink",
    "ManualClock",
    "MetricsRegistry",
    "MonotonicClock",
    "PoisonLogits",
    "Request",
    "RequestState",
    "RequestTracer",
    "SamplerConfig",
    "SchedulerStall",
    "annotate",
    "decode_logits",
    "fault_hook",
    "maybe_profile",
    "resolve_clock",
    "sample_token",
    "validate_snapshot",
]
