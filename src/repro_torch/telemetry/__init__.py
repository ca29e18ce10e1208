"""Observability of the port: profiler spans (``tracing.annotate``, part
of ``repro.telemetry.tracing``) and the metrics registry and clocks
(``metrics``, ``repro.telemetry.metrics``)."""
