"""Serving tiers of the port: the lockstep ``DecodeEngine``
(``serve.engine``), the ``ContinuousBatchingEngine`` on the paged KV pool
(``serve.scheduler``, ``serve.kv_pool``) and the metrics registry it
records into (``serve.metrics``)."""

from repro_torch.serve.engine import DecodeEngine, SamplerConfig
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
    SchedulerStall,
)

__all__ = [
    "BlockAllocator",
    "ContinuousBatchingEngine",
    "Counter",
    "DecodeEngine",
    "FINISH_REASONS",
    "FinishedRequest",
    "Gauge",
    "Histogram",
    "InadmissibleRequest",
    "ManualClock",
    "MetricsRegistry",
    "MonotonicClock",
    "Request",
    "SamplerConfig",
    "SchedulerStall",
    "resolve_clock",
    "validate_snapshot",
]
