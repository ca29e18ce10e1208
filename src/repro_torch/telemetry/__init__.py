"""Profiler spans (port of part of ``repro.telemetry.tracing``)."""
