"""The lockstep decode engine (port of ``repro.serve.engine``)."""
