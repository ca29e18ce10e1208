"""Port of ``repro.telemetry.tracing``: profiler spans, trace capture and
the training run's lifecycle trace.

1. **Profiler spans** — ``annotate(name)`` is a
   ``torch.profiler.record_function`` span while a profiler is recording
   and a no-op otherwise, so an unprofiled run pays one flag check a span.
2. **Trace capture** — :func:`maybe_profile` brackets a region with
   ``torch.profiler`` (CPU and, where present, CUDA activity) when the
   opt-in ``REPRO_PROFILE_DIR`` environment variable is set, and writes a
   Chrome trace there; a no-op otherwise.  Re-entrant (inner brackets do
   nothing) and best-effort: a broken profiler never breaks the run.
3. **Sinks** — :class:`JsonlSink` (one compact JSON object a line,
   flushed a record) and :class:`ListSink` (in memory, for tests).
4. **Training lifecycle tracing** — :class:`TrainTracer`: per-step
   records plus checkpoint / restore / recovery / heartbeat events through
   a sink, stamped with run-relative seconds by its own clock.  The event
   vocabulary and a reader are in ``repro_torch.telemetry``.

Everything here but the spans runs on the host.  Not ported yet:
``RequestTracer`` and ``fault_hook`` (the serving lifecycle).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import IO, Optional, Union

import torch
from torch.autograd import profiler as _autograd_profiler

_log = logging.getLogger(__name__)

#: Opt-in profiler environment variable: a directory to write traces to.
PROFILE_DIR_ENV = "REPRO_PROFILE_DIR"


def annotate(name: str):
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


# the outermost bracket wins; inner ones (a run inside a run) do nothing
_PROFILING = False


@contextlib.contextmanager
def maybe_profile(tag: str = "serve"):
    """Profile the enclosed region into ``$REPRO_PROFILE_DIR`` as
    ``<tag>-<pid>-<time>.json`` (a Chrome trace) when that variable is set;
    otherwise, or inside another bracket, a no-op.  Profiler failures are
    logged and swallowed."""
    global _PROFILING
    out = os.environ.get(PROFILE_DIR_ENV)
    if not out or _PROFILING:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = None
    try:
        os.makedirs(out, exist_ok=True)
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception as e:  # noqa: BLE001 — profiling must not break the run
        _log.warning("profiler start (%s) failed for %s: %s", out, tag, e)
        prof = None
    _PROFILING = prof is not None
    try:
        with annotate(f"repro/{tag}"):
            yield
    finally:
        if prof is not None:
            _PROFILING = False
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(
                    os.path.join(out, f"{tag}-{os.getpid()}-{time.time_ns()}.json"))
            except Exception as e:  # noqa: BLE001
                _log.warning("profiler stop failed for %s: %s", tag, e)


class ListSink:
    """In-memory sink: ``records`` is the list of emitted event dicts."""

    def __init__(self):
        self.records: list[dict] = []

    def write(self, record: dict) -> None:
        self.records.append(record)

    def close(self) -> None:
        pass


class JsonlSink:
    """One compact JSON object a line, flushed a record, so a crashed run
    leaves a replayable prefix."""

    def __init__(self, path_or_file: Union[str, os.PathLike, IO[str]]):
        if hasattr(path_or_file, "write"):
            self._f: IO[str] = path_or_file
            self._owns = False
        else:
            self._f = open(path_or_file, "w", encoding="utf-8")
            self._owns = True

    def write(self, record: dict) -> None:
        self._f.write(json.dumps(record, sort_keys=True, default=str) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._owns:
            self._f.close()


class TrainTracer:
    """Training-run lifecycle tracer: every event is ``{"t": run-relative
    seconds, "event": ..., "step": ..., **fields}`` (fields that are None
    are dropped), written through a sink.  Self-clocked (``clock`` with
    ``now()``; a ``ManualClock`` gives deterministic stamps); it keeps no
    state beyond an event count."""

    def __init__(self, sink, clock=None):
        from repro_torch.telemetry.metrics import MonotonicClock

        self.sink = sink
        self.clock = clock if clock is not None else MonotonicClock()
        self.events = 0

    def emit(self, event: str, *, step: Optional[int] = None, **fields) -> None:
        record = {"t": float(self.clock.now()), "event": str(event)}
        if step is not None:
            record["step"] = int(step)
        for k, v in fields.items():
            if v is not None:
                record[k] = v
        self.events += 1
        self.sink.write(record)

    def close(self) -> None:
        self.sink.close()
