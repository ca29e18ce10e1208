"""The decoder model (port of ``repro.models``, plain decoder family)."""
