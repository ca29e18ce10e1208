"""Port of ``repro.telemetry.metrics``: the typed metrics registry of the
serving engine.  Plain host-side Python, kept as upstream has it.

* :class:`Counter` — monotonically increasing total (resettable).
* :class:`Gauge` — point-in-time level (queue depth, pool-block use,
  batch occupancy).
* :class:`Histogram` — fixed log-spaced buckets: ``observe`` is a bisect
  and two adds, memory is O(buckets), quantiles are interpolated from the
  bucket counts and :meth:`Histogram.quantile_bounds` returns the
  containing bucket's edges.
* :class:`MetricsRegistry` — get-or-create factory keyed by (name,
  labels), a :meth:`~MetricsRegistry.snapshot` dict (the schema
  :func:`validate_snapshot` checks) and a Prometheus text exporter.

Everything here runs on the host over data the engine already holds at
chunk boundaries, so a registry never adds a device operation or a sync.

Clocks: the engine's deadline math and latency histograms read one clock.
:class:`ManualClock` is the test clock (``sleep`` advances virtual time),
:class:`MonotonicClock` wraps ``time.monotonic``; :func:`resolve_clock`
normalizes the engine's ``clock`` argument.
"""

from __future__ import annotations

import bisect
import math
import time
from typing import Callable, Optional

# Log-spaced (factor 2) latency buckets: 100us .. ~860ks upper edges.  One
# fixed ladder serves both real-second clocks and the engine's virtual
# tick clock (ticks are order 1..100) — quantile error is bounded by the
# 2x bucket ratio, which quantile_bounds exposes honestly.
DEFAULT_TIME_BUCKETS: tuple[float, ...] = tuple(
    1e-4 * (2.0 ** i) for i in range(34)
)


def _fmt_labels(labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class Counter:
    """Cumulative total.  ``value`` is a plain attribute, so the engine's
    alias properties (``engine.shed_requests = 0``) can reset it."""

    kind = "counter"

    def __init__(self, name: str, labels=()):
        self.name, self.labels = name, tuple(labels)
        self.value: float = 0

    def inc(self, n: float = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Point-in-time level."""

    kind = "gauge"

    def __init__(self, name: str, labels=()):
        self.name, self.labels = name, tuple(labels)
        self.value: float = 0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1) -> None:
        self.value += n

    def dec(self, n: float = 1) -> None:
        self.value -= n

    def reset(self) -> None:
        self.value = 0


class Histogram:
    """Fixed-bucket histogram: ``buckets`` are ascending upper edges, with
    an implicit overflow bucket above the last edge.  ``counts`` has
    ``len(buckets) + 1`` entries; bucket ``i`` covers
    ``(edge[i-1], edge[i]]`` (the first covers ``[0 or -inf, edge[0]]``).
    """

    kind = "histogram"

    def __init__(self, name: str, buckets=DEFAULT_TIME_BUCKETS, labels=()):
        edges = tuple(float(b) for b in buckets)
        if not edges or any(a >= b for a, b in zip(edges, edges[1:])):
            raise ValueError("buckets must be non-empty and ascending")
        self.name, self.labels = name, tuple(labels)
        self.buckets = edges
        self.counts = [0] * (len(edges) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, x: float) -> None:
        x = float(x)
        self.counts[bisect.bisect_left(self.buckets, x)] += 1
        self.sum += x
        self.count += 1

    def reset(self) -> None:
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def _quantile_bucket(self, q: float) -> tuple[int, int, int]:
        """(bucket index, cumulative count below it, its count) for the
        bucket containing the q-quantile."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            raise ValueError("quantile of an empty histogram")
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if cum + c >= target and c > 0:
                return i, cum, c
            cum += c
        i = len(self.counts) - 1  # q == 0 with leading empties, etc.
        return i, self.count - self.counts[i], self.counts[i]

    def quantile_bounds(self, q: float) -> tuple[float, float]:
        """(lo, hi) edges of the bucket holding the q-quantile — the
        resolution limit any cross-check against an exact percentile must
        allow for.  The overflow bucket reports ``(last_edge, inf)``."""
        i, _, _ = self._quantile_bucket(q)
        lo = self.buckets[i - 1] if i > 0 else 0.0
        hi = self.buckets[i] if i < len(self.buckets) else math.inf
        return lo, hi

    def quantile(self, q: float) -> float:
        """Interpolated q-quantile from the bucket counts (exact only up
        to bucket resolution — see :meth:`quantile_bounds`)."""
        i, cum, c = self._quantile_bucket(q)
        lo, hi = self.quantile_bounds(q)
        if math.isinf(hi):
            return lo
        frac = (q * self.count - cum) / c
        return lo + (hi - lo) * min(max(frac, 0.0), 1.0)

    def to_dict(self) -> dict:
        return {
            "buckets": list(self.buckets),
            "counts": list(self.counts),
            "sum": self.sum,
            "count": self.count,
            "p50": self.quantile(0.5) if self.count else None,
            "p95": self.quantile(0.95) if self.count else None,
            "p99": self.quantile(0.99) if self.count else None,
        }


class MetricsRegistry:
    """Get-or-create registry over (name, labels)-keyed metrics.

    ``register_collector(fn)`` attaches a zero-argument callable returning
    ``{name: number}`` evaluated at snapshot time — the hook for
    process-wide stats that live outside the engine.
    """

    def __init__(self):
        self._metrics: dict[tuple, object] = {}
        self._collectors: list[Callable[[], dict]] = []

    # -- factories ----------------------------------------------------------

    def _get(self, cls, name: str, labels: dict, **kw):
        key = (name, tuple(sorted(labels.items())))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, labels=key[1], **kw)
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}"
            )
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(
        self, name: str, buckets=DEFAULT_TIME_BUCKETS, **labels
    ) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    def register_collector(self, fn: Callable[[], dict]) -> None:
        self._collectors.append(fn)

    def family(self, name: str) -> dict[tuple, object]:
        """All metrics registered under ``name`` keyed by their label
        tuples — e.g. the per-``finish_reason`` counter family."""
        return {
            key[1]: m for key, m in self._metrics.items() if key[0] == name
        }

    # -- output -------------------------------------------------------------

    def reset(self) -> None:
        """Zero every metric (warm up, reset, then measure)."""
        for m in self._metrics.values():
            m.reset()

    def snapshot(self) -> dict:
        """Stable JSON-serialisable view: ``{"counters": {...},
        "gauges": {...}, "histograms": {...}, "collected": {...}}`` with
        labeled metrics keyed ``name{label="value"}``: the schema
        :func:`validate_snapshot` checks."""
        out = {"counters": {}, "gauges": {}, "histograms": {}, "collected": {}}
        for (name, labels), m in sorted(self._metrics.items()):
            key = name + _fmt_labels(labels)
            if isinstance(m, Counter):
                out["counters"][key] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][key] = m.value
            else:
                out["histograms"][key] = m.to_dict()
        for fn in self._collectors:
            for k, v in fn().items():
                out["collected"][str(k)] = v
        return out

    def prometheus_text(self) -> str:
        """Prometheus exposition format (text/plain version 0.0.4)."""
        lines: list[str] = []
        seen_type: set[str] = set()
        for (name, labels), m in sorted(self._metrics.items()):
            if name not in seen_type:
                seen_type.add(name)
                lines.append(f"# TYPE {name} {m.kind}")
            lab = _fmt_labels(labels)
            if isinstance(m, Histogram):
                cum = 0
                for edge, c in zip(m.buckets, m.counts):
                    cum += c
                    le = tuple(labels) + (("le", repr(edge)),)
                    lines.append(f"{name}_bucket{_fmt_labels(le)} {cum}")
                le = tuple(labels) + (("le", "+Inf"),)
                lines.append(f"{name}_bucket{_fmt_labels(le)} {m.count}")
                lines.append(f"{name}_sum{lab} {m.sum}")
                lines.append(f"{name}_count{lab} {m.count}")
            else:
                lines.append(f"{name}{lab} {m.value}")
        return "\n".join(lines) + "\n"


def validate_snapshot(snap: dict) -> None:
    """Assert ``snap`` matches the :meth:`MetricsRegistry.snapshot` schema
    (keys + types).  Raises ``AssertionError`` with the offending key."""
    assert isinstance(snap, dict), "snapshot must be a dict"
    for section in ("counters", "gauges", "histograms", "collected"):
        assert section in snap, f"missing section {section!r}"
        assert isinstance(snap[section], dict), f"{section} must be a dict"
    num = (int, float)
    for section in ("counters", "gauges", "collected"):
        for k, v in snap[section].items():
            assert isinstance(k, str), f"non-string key {k!r} in {section}"
            assert isinstance(v, num) and not isinstance(v, bool), (
                f"{section}[{k!r}] must be a number, got {type(v).__name__}"
            )
    for k, h in snap["histograms"].items():
        assert isinstance(k, str), f"non-string histogram key {k!r}"
        assert isinstance(h, dict), f"histograms[{k!r}] must be a dict"
        for field in ("buckets", "counts", "sum", "count"):
            assert field in h, f"histograms[{k!r}] missing {field!r}"
        assert isinstance(h["buckets"], list) and isinstance(h["counts"], list)
        assert len(h["counts"]) == len(h["buckets"]) + 1, (
            f"histograms[{k!r}]: counts must be len(buckets) + 1"
        )
        assert all(isinstance(x, num) for x in h["buckets"])
        assert all(isinstance(x, int) for x in h["counts"])
        assert isinstance(h["sum"], num) and isinstance(h["count"], int)
        for q in ("p50", "p95", "p99"):
            assert q in h and (h[q] is None or isinstance(h[q], num))


# ---------------------------------------------------------------------------
# Clocks
# ---------------------------------------------------------------------------


class ManualClock:
    """A fake clock for tests: ``now()`` returns virtual time, ``sleep``
    and ``advance`` move it forward instantly.  An engine driven by one
    runs arrival waits, deadlines, TTFT/ITL histograms and trace
    timestamps on the same virtual timeline with zero real sleeping."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)
        self.sleeps: list[float] = []

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)

    def sleep(self, dt: float) -> None:
        self.sleeps.append(float(dt))
        self.t += max(0.0, float(dt))


class MonotonicClock:
    """``time.monotonic``-based real clock (zeroed at construction so
    timestamps read as run-relative seconds).  Monotonic by contract —
    deadline math must never see wall-clock steps, hence no ``time.time``
    anywhere in the serving stack."""

    def __init__(self):
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def sleep(self, dt: float) -> None:
        time.sleep(max(0.0, dt))


def resolve_clock(
    clock,
) -> tuple[Optional[Callable[[], float]], Callable[[float], None]]:
    """Normalize the engine's ``clock`` argument to ``(now, sleep)``.

    ``None`` -> ``(None, no-op)`` (the engine's virtual tick clock — it
    never sleeps, it jumps).  A bare callable (the legacy form) ->
    ``(clock, time.sleep)``.  An object with ``now()`` (and optionally
    ``sleep(dt)``) -> its own pair, so a :class:`ManualClock` test drives
    waiting without real sleeps and deadline math, traces and histograms
    all share one timeline.
    """
    if clock is None:
        return None, lambda dt: None
    now = getattr(clock, "now", None)
    if callable(now):
        return now, getattr(clock, "sleep", time.sleep)
    if callable(clock):
        return clock, time.sleep
    raise TypeError(f"clock must be callable or have .now(), got {clock!r}")
