"""Profiler spans for the port (the ``annotate`` part of
``repro.telemetry.tracing``; the rest of telemetry is not ported yet).

``annotate(name)`` is a ``torch.profiler.record_function`` span while a
profiler is recording and a no-op otherwise, so an unprofiled run pays
one flag check per span.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _autograd_profiler


def annotate(name: str):
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()
