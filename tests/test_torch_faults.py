"""Fault injection in the port against the JAX package.

``repro_torch.serve.faults`` is the port's own copy of the numpy-only
upstream module: ``FaultInjector.random`` must draw upstream's schedule
for the same arguments.  On the same schedules (seeded chaos with random
arrivals, deadlines and a bounded queue, a hand-built schedule where every
kind fires, and allocation failures and preemptions over shared
prefix-cache blocks), the port's ``ContinuousBatchingEngine`` must end
every request with JAX's finish reason and JAX's greedy stream, fire the
same faults, and drain its pool, as ``tests/test_chaos.py`` holds JAX's
engine to its oracle.  Poisoned logits at admission and in decode
quarantine exactly one stream.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxConfig
from repro.core.quantization import QuantConfig as JaxQuant
from repro.models import api as japi
from repro.serve import faults as jfaults
from repro.serve.engine import SamplerConfig as JaxSampler
from repro.serve.scheduler import ContinuousBatchingEngine as JaxCB
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.quantization import QuantConfig
from repro_torch.models import api
from repro_torch.serve import faults as pfaults
from repro_torch.serve import (
    FINISH_REASONS,
    ContinuousBatchingEngine,
    DecodeEngine,
    FaultInjector,
    PoisonLogits,
    SamplerConfig,
)
from test_torch_train import _torch_one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
_KW = dict(name="t", family="decoder", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
           d_ff=48, vocab_size=64)
MAX_LEN = 32
STOP = (5,)
# uid -> (prompt length, token budget)
REQS = {0: (5, 8), 1: (3, 6), 2: (7, 4), 3: (4, 8), 4: (6, 5), 5: (9, 7)}
CHAOS = dict(n_faults=8, max_step=10, max_alloc=24, max_gen=6, max_delay=3.0)


def _prompt(uid):
    return np.random.default_rng(uid + 10).integers(0, 64, REQS[uid][0]).astype(np.int32)


_PREFIX = np.random.default_rng(77).integers(0, 64, 17).astype(np.int32)


def _shared_prompt(uid):
    tail = np.random.default_rng(300 + uid).integers(0, 64, 1 + uid % 4).astype(np.int32)
    return np.concatenate([_PREFIX, tail])


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig(quant=JaxQuant(mode="pquant", r=16, num_experts=1), **_KW)
    cfg = ModelConfig(quant=QuantConfig(mode="pquant", r=16, num_experts=1), **_KW)
    jparams, _ = japi.init_model(jax.random.PRNGKey(1), jcfg)
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)


def _serve(eng, prompt_of, seed=None):
    """Submit REQS (with seeded arrivals, deadlines and TTFT budgets when
    ``seed`` is given, as the chaos suite draws them) and run."""
    rng = np.random.default_rng(seed + 1000) if seed is not None else None
    for uid, (_, budget) in REQS.items():
        kw = {}
        if rng is not None:
            kw = dict(arrival=float(rng.uniform(0.0, 4.0)),
                      deadline=float(rng.uniform(6.0, 40.0)) if rng.integers(0, 3) == 0
                      else None,
                      ttft_budget=float(rng.uniform(2.0, 10.0)) if rng.integers(0, 4) == 0
                      else None)
        eng.submit(prompt_of(uid), max_new_tokens=budget, seed=uid, uid=uid, **kw)
    return {f.uid: f for f in eng.run()}


def _both(model, faults_of, prompt_of=_prompt, seed=None, **kw):
    """The same schedule (``faults_of(module)``, built once from each
    package's faults module) through JAX's engine and the port's: (JAX's
    finished, port's finished, JAX's injector, port's injector, port
    engine)."""
    jcfg, jparams, cfg, tparams = model
    jinj, inj = faults_of(jfaults), faults_of(pfaults)
    common = dict(num_slots=2, max_len=MAX_LEN, block_size=8, chunk=4, watchdog_steps=96, **kw)
    jeng = JaxCB(jparams, jcfg, scfg=JaxSampler(temperature=0.0, top_k=0, max_new_tokens=8,
                                                stop_tokens=STOP), faults=jinj, **common)
    eng = ContinuousBatchingEngine(
        tparams, cfg, scfg=SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=8,
                                         stop_tokens=STOP),
        faults=inj, device=CPU, **common)
    return _serve(jeng, prompt_of, seed), _serve(eng, prompt_of, seed), jinj, inj, eng


def _assert_parity(jf, pf, jinj, inj, eng):
    assert sorted(pf) == sorted(jf) == sorted(REQS)
    for uid, f in pf.items():
        assert f.finish_reason in FINISH_REASONS
        assert f.finish_reason == jf[uid].finish_reason, uid
        np.testing.assert_array_equal(f.tokens, np.asarray(jf[uid].tokens))
    assert dict(inj.injected) == dict(jinj.injected)
    assert sum(eng.finished_by_reason.values()) == len(REQS)
    if eng.allocator is not None:
        assert eng.allocator.free_count == eng.num_blocks and eng.allocator.used_count == 0
        assert eng.snapshot()["gauges"]["pool_blocks_used"] == 0
    assert eng._live() == [] and not eng._queue


@pytest.mark.parametrize("seed", [0, 3, 7, 11, 123456])
@pytest.mark.parametrize("kinds", [None, ("alloc", "preempt"), ("poison", "delay", "poison")])
def test_random_schedules_equal_upstream(seed, kinds):
    uids = [0, 1, 2, 3]
    kw = dict(n_faults=12) if kinds is None else dict(n_faults=12, kinds=kinds)
    ours = FaultInjector.random(seed, uids, **kw)
    theirs = jfaults.FaultInjector.random(seed, uids, **kw)
    assert [(type(f).__name__, *f.__dict__.values()) for f in ours.faults] == \
        [(type(f).__name__, *f.__dict__.values()) for f in theirs.faults]
    # the hooks replay the same way
    assert [ours.on_alloc() for _ in range(48)] == [theirs.on_alloc() for _ in range(48)]
    assert [ours.preempt_uids(s) for s in range(24)] == [theirs.preempt_uids(s)
                                                         for s in range(24)]
    assert [ours.arrival_delay(u) for u in uids] == [theirs.arrival_delay(u) for u in uids]
    assert [ours.poison_rel_step(u, g, 4) for u in uids for g in range(1, 9)] == \
        [theirs.poison_rel_step(u, g, 4) for u in uids for g in range(1, 9)]
    assert dict(ours.injected) == dict(theirs.injected)


def test_injector_validation():
    with pytest.raises(ValueError, match="gen_index >= 1"):
        FaultInjector([PoisonLogits(uid=0, gen_index=0)])
    with pytest.raises(ValueError, match="unknown fault kinds"):
        FaultInjector.random(0, [0], kinds=("alloc", "meteor"))
    with pytest.raises(ValueError, match="at least one"):
        FaultInjector.random(0, [0], kinds=())


@pytest.mark.parametrize("layout,prefill_chunk,seed", [("dense", None, 0), ("paged", 3, 2)])
def test_chaos_schedules_finish_as_jax(model, layout, prefill_chunk, seed):
    jf, pf, jinj, inj, eng = _both(
        model, lambda m: m.FaultInjector.random(seed, list(REQS), **CHAOS), seed=seed,
        layout=layout, num_blocks=5, prefill_chunk=prefill_chunk, max_queue=4, overload_policy="reject" if seed % 2 else "shed_oldest")
    _assert_parity(jf, pf, jinj, inj, eng)


def _every_kind(m):
    return m.FaultInjector([m.AllocFailure(2), m.ForcePreempt(step=2, uid=None),
                            m.PoisonLogits(uid=3, gen_index=2), m.DelayArrival(uid=1, delay=2.5)])


def test_every_kind_fires_and_isolates_streams(model):
    jf, pf, jinj, inj, eng = _both(model, _every_kind, layout="paged", num_blocks=5)
    _assert_parity(jf, pf, jinj, inj, eng)
    assert pf[3].finish_reason == "error" and len(pf[3].tokens) == 2
    assert all(inj.injected[k] == 1 for k in
               ("alloc_failure", "force_preempt", "poison_logits", "delay_arrival"))


@pytest.mark.parametrize("prefill_chunk,seed", [(None, 0)])
def test_alloc_and_preempt_over_shared_blocks_as_jax(model, prefill_chunk, seed):
    def faults_of(m):
        return m.FaultInjector.random(seed + 50, list(REQS), n_faults=8, max_step=10,
                                      max_alloc=24, kinds=("alloc", "preempt"))

    jf, pf, jinj, inj, eng = _both(model, faults_of, prompt_of=_shared_prompt,
                                   layout="paged", num_blocks=6, prefill_chunk=prefill_chunk,
                                   prefix_cache=True)
    _assert_parity(jf, pf, jinj, inj, eng)
    assert eng.snapshot()["counters"]["prefix_cache_hits_total"] > 0


def test_decode_poison_quarantines_one_stream(model):
    _, _, cfg, tparams = model
    scfg = SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=6)
    inj = FaultInjector([PoisonLogits(uid=0, gen_index=3)])
    eng = ContinuousBatchingEngine(tparams, cfg, 2, MAX_LEN, scfg, block_size=8, chunk=4,
                                   faults=inj, device=CPU)
    ref = DecodeEngine(tparams, cfg, MAX_LEN, device=CPU)
    for uid in (0, 1):
        eng.submit(_prompt(uid), max_new_tokens=6, seed=uid, uid=uid)
    by = {f.uid: f for f in eng.run()}
    full = {uid: ref.generate(_prompt(uid)[None], scfg)[0] for uid in (0, 1)}
    assert by[0].finish_reason == "error"
    np.testing.assert_array_equal(by[0].tokens, full[0][:3])
    assert by[1].finish_reason == "length"
    np.testing.assert_array_equal(by[1].tokens, full[1])
    assert eng.quarantined == 1 and inj.injected["poison_logits"] == 1
    assert eng.allocator.free_count == eng.num_blocks


@pytest.mark.parametrize("prefill_chunk,prefix_cache", [(None, False), (3, False),
                                                        (None, True)])
def test_admission_poison_quarantines_at_admission(model, monkeypatch, prefill_chunk,
                                                   prefix_cache):
    """Non-finite prompt logits (a forward over the marked token) end the
    request "error" with no token on the bucketed one-shot, the chunked and
    the cache-hit admission paths; its blocks come back and, on a hit, its
    miss block is not registered; the clean request before it is
    unchanged."""
    _, _, cfg, tparams = model
    bad = 63
    orig_prefill, orig_chunk = api.prefill, api.forward_chunk

    def nan_if_bad(tokens, logits):
        return torch.full_like(logits, float("nan")) if (tokens == bad).any() else logits

    def prefill(params, batch, cfg_, cache_len, last_pos=None):
        logits, caches = orig_prefill(params, batch, cfg_, cache_len, last_pos)
        return nan_if_bad(batch["tokens"], logits), caches

    def forward_chunk(params, tokens, caches, pos, cfg_, **kw):
        logits, caches = orig_chunk(params, tokens, caches, pos, cfg_, **kw)
        return nan_if_bad(tokens, logits), caches

    monkeypatch.setattr(api, "prefill", prefill)
    monkeypatch.setattr(api, "forward_chunk", forward_chunk)
    scfg = SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=4)
    eng = ContinuousBatchingEngine(tparams, cfg, 1, MAX_LEN, scfg, block_size=8, chunk=4,
                                   prefill_chunk=prefill_chunk, prefix_cache=prefix_cache,
                                   device=CPU)
    clean = np.arange(1, 17, dtype=np.int32)  # two full blocks
    eng.submit(clean, max_new_tokens=4, seed=0, uid=0)
    # a third full block whose last token is the marked one (so the slice
    # that completes the prompt carries it on every admission path)
    eng.submit(np.concatenate([clean, np.arange(7), [bad]]).astype(np.int32),
               max_new_tokens=4, seed=1, uid=1)
    by = {f.uid: f for f in eng.run()}
    assert by[1].finish_reason == "error" and len(by[1].tokens) == 0
    want = DecodeEngine(tparams, cfg, MAX_LEN, device=CPU).generate(clean[None], scfg)[0]
    np.testing.assert_array_equal(by[0].tokens, want)
    assert eng.quarantined == 1
    assert eng.allocator.free_count == eng.num_blocks and eng._live() == []
    if prefix_cache:
        assert eng.snapshot()["counters"]["prefix_cache_hits_total"] == 2
        assert eng.allocator.cached_count == 2  # the clean prompt's blocks only
