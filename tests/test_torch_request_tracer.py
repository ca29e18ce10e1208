"""The port's ``RequestTracer`` and ``fault_hook`` against the JAX package.

On a ``ManualClock``, one trace (shared prefixes, a fully cached
block-aligned prompt, every fault kind, one-shot and chunked admission)
goes through JAX's ``ContinuousBatchingEngine`` and the port's, each with
a ``RequestTracer(ListSink())``: the sequence of (event, uid, fields other
than ``t``) must be JAX's.  The ``JsonlSink`` must round-trip the records;
an attached tracer (and an empty ``FaultInjector``) must change neither
the streams, nor ``host_transfers``, nor the torch ops the engine runs.
"""

import json

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import ModelConfig as JaxConfig
from repro.core.quantization import QuantConfig as JaxQuant
from repro.models import api as japi
from repro.serve import faults as jfaults
from repro.serve.engine import SamplerConfig as JaxSampler
from repro.serve.metrics import ManualClock as JaxClock
from repro.serve.scheduler import ContinuousBatchingEngine as JaxCB
from repro.serve.tracing import ListSink as JaxListSink
from repro.serve.tracing import RequestTracer as JaxTracer
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.quantization import QuantConfig
from repro_torch.serve import (
    ContinuousBatchingEngine,
    FaultInjector,
    JsonlSink,
    ListSink,
    ManualClock,
    RequestTracer,
    SamplerConfig,
    fault_hook,
)
from repro_torch.serve import faults as pfaults
from test_torch_train import _torch_one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
_KW = dict(name="t", family="decoder", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
           d_ff=48, vocab_size=64)
MAX_LEN = 32
PREFIX = np.random.default_rng(77).integers(0, 64, 17).astype(np.int32)
PROMPTS = {uid: np.concatenate([PREFIX, np.random.default_rng(300 + uid).integers(
    0, 64, 1 + uid % 4).astype(np.int32)]) for uid in range(4)}
PROMPTS[4] = PREFIX[:16]  # block-aligned and cached after uid 0: copy-on-write
BUDGET = {0: 8, 1: 6, 2: 4, 3: 8, 4: 5}


def _faults(m):
    return m.FaultInjector([m.AllocFailure(3), m.ForcePreempt(step=3, uid=None),
                            m.PoisonLogits(uid=3, gen_index=2), m.DelayArrival(uid=1, delay=1.5)])


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig(quant=JaxQuant(mode="pquant", r=16, num_experts=1), **_KW)
    cfg = ModelConfig(quant=QuantConfig(mode="pquant", r=16, num_experts=1), **_KW)
    jparams, _ = japi.init_model(jax.random.PRNGKey(1), jcfg)
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)


def _engine(model, faults=None, tracer=None, clock=None, prefill_chunk=None):
    _, _, cfg, tparams = model
    return ContinuousBatchingEngine(
        tparams, cfg, 2, MAX_LEN, SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=8,
                                                stop_tokens=(5,)),
        block_size=8, num_blocks=6, chunk=4, prefill_chunk=prefill_chunk, prefix_cache=True,
        clock=clock, faults=faults, tracer=tracer, watchdog_steps=96, device=CPU)


def _serve(eng):
    for uid, p in PROMPTS.items():
        eng.submit(p, max_new_tokens=BUDGET[uid], seed=uid, uid=uid)
    return {f.uid: f.tokens for f in eng.run()}


def _shape(records):
    return [(r["event"], r.get("uid"),
             {k: v for k, v in r.items() if k not in ("t", "event", "uid")}) for r in records]


@pytest.mark.parametrize("prefill_chunk", [None, 3])
def test_event_sequence_equals_jax(model, prefill_chunk):
    jcfg, jparams, _, _ = model
    jsink = JaxListSink()
    jeng = JaxCB(jparams, jcfg, num_slots=2, max_len=MAX_LEN, layout="paged", block_size=8,
                 num_blocks=6, chunk=4, prefill_chunk=prefill_chunk, prefix_cache=True,
                 scfg=JaxSampler(temperature=0.0, top_k=0, max_new_tokens=8, stop_tokens=(5,)),
                 clock=JaxClock(), faults=_faults(jfaults), tracer=JaxTracer(jsink),
                 watchdog_steps=96)
    _serve(jeng)
    sink = ListSink()
    eng = _engine(model, _faults(pfaults), RequestTracer(sink), ManualClock(), prefill_chunk)
    _serve(eng)
    got, want = _shape(sink.records), _shape(jsink.records)
    assert got == want
    events = {e for e, _, _ in got}
    for e in ("submitted", "block_alloc", "admitted", "first_token", "decode_chunk",
              "finished", "block_free", "preempted", "prefix_hit", "block_cow",
              "fault_alloc_failure", "fault_force_preempt", "fault_poison_logits",
              "fault_delay_arrival"):
        assert e in events, e
    if prefill_chunk:
        assert "prefill_chunk" in events
    assert eng.tracer.events == len(sink.records)
    assert [r["t"] for r in sink.records] == sorted(r["t"] for r in sink.records)


def test_fault_hook_lands_faults_on_the_timeline():
    sink, clock = ListSink(), ManualClock()
    clock.advance(2.5)
    inj = FaultInjector([pfaults.AllocFailure(0), pfaults.DelayArrival(uid=7, delay=1.0)])
    inj.on_fire = fault_hook(RequestTracer(sink), clock.now)
    assert inj.on_alloc() and inj.arrival_delay(7) == 1.0
    assert sink.records == [{"t": 2.5, "event": "fault_alloc_failure", "index": 0},
                            {"t": 2.5, "event": "fault_delay_arrival", "uid": 7, "delay": 1.0}]


def test_jsonl_sink_round_trips(model, tmp_path):
    path = tmp_path / "trace.jsonl"
    eng = _engine(model, tracer=RequestTracer(JsonlSink(str(path))), clock=ManualClock())
    _serve(eng)
    eng.tracer.close()
    listed = _engine(model, tracer=RequestTracer(ListSink()), clock=ManualClock())
    _serve(listed)
    read = [json.loads(line) for line in path.read_text().splitlines()]
    assert read == listed.tracer.sink.records
    assert len(read) == eng.tracer.events > 0


class _Ops(TorchDispatchMode):
    """Records every aten op dispatched while active."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("prefill_chunk", [None, 3])
def test_tracer_and_empty_injector_change_nothing(model, prefill_chunk):
    """With a tracer and an empty injector attached the engine serves the
    same streams with the same fetches and dispatches the same torch ops,
    in order: they are host-side only."""
    runs = []
    for attach in (False, True):
        eng = _engine(model, FaultInjector() if attach else None,
                      RequestTracer(ListSink()) if attach else None, prefill_chunk=prefill_chunk)
        with _Ops() as ops:
            streams = _serve(eng)
        runs.append((streams, eng.host_transfers, ops.ops, eng.snapshot()["counters"]))
    (s0, h0, o0, c0), (s1, h1, o1, c1) = runs
    assert sorted(s0) == sorted(s1)
    for uid in s0:
        np.testing.assert_array_equal(s0[uid], s1[uid])
    assert h0 == h1 and o0 == o1 and len(o0) > 0
    assert c0 == c1
