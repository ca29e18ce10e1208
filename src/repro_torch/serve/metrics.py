"""Re-export of ``repro_torch.telemetry.metrics`` under the serving
package, as upstream's ``repro.serve.metrics`` shim."""

from repro_torch.telemetry.metrics import (  # noqa: F401
    DEFAULT_TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    ManualClock,
    MetricsRegistry,
    MonotonicClock,
    _fmt_labels,
    resolve_clock,
    validate_snapshot,
)
