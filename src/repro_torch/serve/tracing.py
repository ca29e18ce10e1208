"""Re-export of ``repro_torch.telemetry.tracing`` for the serving side, as
upstream's ``repro.serve.tracing`` re-exports its telemetry module."""

from repro_torch.telemetry.tracing import (  # noqa: F401
    PROFILE_DIR_ENV,
    JsonlSink,
    ListSink,
    RequestTracer,
    TrainTracer,
    annotate,
    fault_hook,
    maybe_profile,
)
