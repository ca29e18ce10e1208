"""The port's metrics registry and clocks against
``repro.telemetry.metrics``: the same operations give equal snapshots and
Prometheus text, each package's ``validate_snapshot`` accepts the other's
snapshot, histogram quantiles agree, and the clocks behave the same."""

import json

import numpy as np
import pytest

from repro.telemetry import metrics as jm
from repro_torch.serve import metrics as sm
from repro_torch.telemetry import metrics as tm


def _drive(mod):
    reg = mod.MetricsRegistry()
    reg.counter("requests_submitted_total").inc(3)
    for r in ("length", "stop", "shed"):
        reg.counter("requests_finished_total", reason=r).inc(2 if r == "length" else 1)
    g = reg.gauge("admission_queue_depth")
    g.set(5)
    g.dec(2)
    g.inc(0.5)
    h = reg.histogram("ttft_seconds")
    for x in np.random.default_rng(0).lognormal(-3, 2, 500):
        h.observe(float(x))
    reg.histogram("custom", buckets=(1.0, 2.0, 4.0)).observe(3.0)
    reg.register_collector(lambda: {"extra_total": 7})
    return reg


def test_same_operations_give_equal_snapshots_and_prometheus_text():
    j, t = _drive(jm), _drive(tm)
    assert t.snapshot() == j.snapshot()
    assert t.prometheus_text() == j.prometheus_text()
    assert json.loads(json.dumps(t.snapshot())) == t.snapshot()
    tm.validate_snapshot(j.snapshot())
    jm.validate_snapshot(t.snapshot())
    assert set(t.family("requests_finished_total")) == set(j.family("requests_finished_total"))
    t.reset()
    j.reset()
    assert t.snapshot() == j.snapshot()


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.95, 0.99, 1.0])
def test_histogram_quantiles_match(q):
    hj, ht = jm.Histogram("x"), tm.Histogram("x")
    for x in np.random.default_rng(1).exponential(0.05, 300):
        hj.observe(float(x))
        ht.observe(float(x))
    assert ht.quantile(q) == hj.quantile(q)
    assert ht.quantile_bounds(q) == hj.quantile_bounds(q)


def test_errors_match():
    for mod in (jm, tm):
        reg = mod.MetricsRegistry()
        reg.counter("a")
        with pytest.raises(TypeError):
            reg.gauge("a")
        with pytest.raises(ValueError):
            mod.Histogram("h", buckets=(2.0, 1.0))
        with pytest.raises(ValueError):
            mod.Histogram("h").quantile(0.5)
        with pytest.raises(AssertionError):
            mod.validate_snapshot({"counters": {}})


def test_clocks_behave_the_same():
    for mod in (jm, tm):
        now, sleep = mod.resolve_clock(None)
        assert now is None
        sleep(1.0)  # the virtual clock's no-op
        clock = mod.ManualClock(2.0)
        now, sleep = mod.resolve_clock(clock)
        sleep(0.5)
        clock.advance(1.0)
        assert now() == 3.5 and clock.sleeps == [0.5]
        now, _ = mod.resolve_clock(lambda: 42.0)
        assert now() == 42.0
        with pytest.raises(TypeError):
            mod.resolve_clock(3)
        mono = mod.MonotonicClock()
        a = mono.now()
        assert mono.now() >= a >= 0.0


def test_serve_shim_reexports_the_registry():
    assert sm.MetricsRegistry is tm.MetricsRegistry
    assert sm.ManualClock is tm.ManualClock
    assert sm.DEFAULT_TIME_BUCKETS == jm.DEFAULT_TIME_BUCKETS
