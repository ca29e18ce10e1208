"""Prefix caching in the port's ``ContinuousBatchingEngine`` against the
JAX package.

The same JAX-made weights and the same traces go through JAX's
``ContinuousBatchingEngine(prefix_cache=True)`` and the port's.  Greedy
(sampled streams cannot match JAX's threefry): every warm stream equals
JAX's warm engine and JAX's ``DecodeEngine`` batch-1 stream, for one-shot
and chunked admission and with ``REPRO_PAGED_ATTN`` 0 (gather) and 1 (the
kernel route's plain version on the CPU); the hit, miss, hit-token,
copy-on-write and eviction counters equal JAX's; a multi-turn follow-up
hits the blocks the previous turn decoded into; a tiny pool evicts and
keeps parity; a dense layout raises; every family the port runs that
keeps state outside the pool or couples tokens declines with one log.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxConfig
from repro.core.quantization import QuantConfig as JaxQuant
from repro.models import api as japi
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import SamplerConfig as JaxSampler
from repro.serve.scheduler import ContinuousBatchingEngine as JaxCB
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.quantization import QuantConfig
from repro_torch.models import api
from repro_torch.serve import ContinuousBatchingEngine, SamplerConfig
from repro_torch.serve import scheduler
from test_torch_train import _torch_one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
_KW = dict(name="t", family="decoder", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
           d_ff=48, vocab_size=64)
MAX_LEN = 48
BS = 8
NEW = 6
COUNTERS = ("prefix_cache_hits_total", "prefix_cache_misses_total",
            "prefix_cache_hit_tokens_total", "prefix_cache_cow_total",
            "prefix_cache_evictions_total")


def _toks(seed, n):
    return np.random.default_rng(seed).integers(0, 64, n).astype(np.int32)


# a 17-token shared prefix (two full blocks + 1) and ragged suffixes, then a
# block-aligned 24-token prompt (3 full blocks) three times: its repeats are
# fully cached and copy their last shared page on write
PREFIX = _toks(99, 17)
SUFFIXES = {0: 4, 1: 1, 2: 6, 3: 3}
TRACE = {uid: np.concatenate([PREFIX, _toks(200 + uid, n)]) for uid, n in SUFFIXES.items()}
TRACE.update({uid: _toks(7, 3 * BS) for uid in (4, 5, 6)})


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig(quant=JaxQuant(mode="pquant", r=16, num_experts=1), **_KW)
    cfg = ModelConfig(quant=QuantConfig(mode="pquant", r=16, num_experts=1), **_KW)
    jparams, _ = japi.init_model(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    return jcfg, jparams, cfg, tparams


def _submit(eng, prompts, new=NEW):
    for uid, p in prompts.items():
        eng.submit(p, max_new_tokens=new, seed=uid, uid=uid)


def _counters(eng):
    c = eng.snapshot()["counters"]
    return {k: int(c[k]) for k in COUNTERS}


def _drained(eng):
    return (eng.allocator.free_count == eng.num_blocks and eng.allocator.used_count == 0
            and all(eng.allocator.refcount(i) == 0 for i in range(eng.num_blocks))
            and eng.snapshot()["gauges"]["pool_blocks_used"] == 0)


def _jax_run(model, prompts, new=NEW, **kw):
    jcfg, jparams, _, _ = model
    kw.setdefault("num_slots", 2)
    kw.setdefault("chunk", 4)
    eng = JaxCB(jparams, jcfg, max_len=MAX_LEN, layout="paged", block_size=BS,
                scfg=JaxSampler(temperature=0.0, top_k=0, max_new_tokens=new), **kw)
    _submit(eng, prompts, new)
    return {f.uid: np.asarray(f.tokens) for f in eng.run()}, _counters(eng)


def _port_engine(model, new=NEW, **kw):
    _, _, cfg, tparams = model
    kw.setdefault("num_slots", 2)
    kw.setdefault("chunk", 4)
    kw.setdefault("layout", "paged")
    return ContinuousBatchingEngine(
        tparams, cfg, max_len=MAX_LEN, block_size=BS, device=CPU,
        scfg=SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=new), **kw)


def _port_run(model, prompts, new=NEW, **kw):
    eng = _port_engine(model, new, **kw)
    _submit(eng, prompts, new)
    return {f.uid: f.tokens for f in eng.run()}, _counters(eng), eng


@pytest.fixture(scope="module")
def batch1(model):
    """JAX ``DecodeEngine`` batch-1 greedy streams of the trace's prompts."""
    jcfg, jparams, _, _ = model
    eng = JaxEngine(jparams, jcfg, MAX_LEN)
    scfg = JaxSampler(temperature=0.0, top_k=0, max_new_tokens=NEW)
    return {uid: np.asarray(eng.generate(jnp.asarray(p[None]), scfg, seed=uid))[0]
            for uid, p in TRACE.items()}


@pytest.fixture(scope="module")
def jax_warm(model):
    """JAX's warm engine on the trace, one-shot and chunked: (streams,
    counters)."""
    return {pc: _jax_run(model, TRACE, prefix_cache=True, prefill_chunk=pc) for pc in (None, 3)}


@pytest.mark.parametrize("env", ["0", "1"])
@pytest.mark.parametrize("prefill_chunk", [None, 3])
def test_warm_streams_and_counters_equal_jax(model, batch1, jax_warm, monkeypatch,
                                             prefill_chunk, env):
    """Hits on the shared prefix and copies on write of the fully cached
    repeats: every stream equals JAX's warm engine and batch-1, every
    counter JAX's."""
    monkeypatch.setenv("REPRO_PAGED_ATTN", env)
    streams, counters, eng = _port_run(model, TRACE, prefix_cache=True,
                                       prefill_chunk=prefill_chunk)
    want, want_counters = jax_warm[prefill_chunk]
    assert sorted(streams) == sorted(TRACE)
    for uid in TRACE:
        np.testing.assert_array_equal(streams[uid], want[uid])
        np.testing.assert_array_equal(streams[uid], batch1[uid])
    assert counters == want_counters
    assert counters["prefix_cache_hits_total"] >= 2
    assert counters["prefix_cache_hit_tokens_total"] >= 2 * BS
    assert counters["prefix_cache_cow_total"] >= 1
    assert _drained(eng)


def test_cow_leaves_the_shared_page_untouched(model):
    """The copy-on-write admission writes only its private page: the
    registered pages of the first request keep their bytes."""
    eng = _port_engine(model, num_slots=1, prefix_cache=True)
    eng.submit(TRACE[4], max_new_tokens=NEW, seed=0, uid=0)
    eng.run()
    blocks = [eng.allocator.lookup(h) for h in
              scheduler.kv_pool.prompt_block_hashes(TRACE[4], BS)]
    assert None not in blocks
    pools = [c[n] for _, c in scheduler._cache_dicts(eng.cfg, eng._caches) if "table" in c
             for n in ("kpool", "vpool")]
    before = [p[..., blocks, :, :, :].clone() for p in pools]
    eng.submit(TRACE[5], max_new_tokens=NEW, seed=1, uid=1)
    eng.run()
    assert _counters(eng)["prefix_cache_cow_total"] == 1
    for p, b in zip(pools, before):
        assert torch.equal(p[..., blocks, :, :, :], b)


def _multi_turn(run, model):
    """Turn 1, then turn 2 = turn 1's prompt + reply + 3 new tokens, on one
    warm engine: (turn-2 stream, hits of turn 2)."""
    prompt = _toks(3, 2 * BS - 2)
    eng = run(model)
    eng.submit(prompt, max_new_tokens=12, seed=0, uid=0)
    (turn1,) = eng.run()
    history = np.concatenate([prompt, np.asarray(turn1.tokens)]).astype(np.int32)
    assert len(history) >= 3 * BS  # decode filled a block past the prompt
    before = _counters(eng)["prefix_cache_hits_total"]
    eng.submit(np.concatenate([history, _toks(5, 3)]), max_new_tokens=4, seed=1, uid=1)
    (turn2,) = eng.run()
    return np.asarray(turn2.tokens), _counters(eng)["prefix_cache_hits_total"] - before, eng


def test_multi_turn_chain_extends_over_generated_tokens(model):
    def port(m):
        return _port_engine(m, num_slots=1, prefix_cache=True)

    def jax_(m):
        jcfg, jparams, _, _ = m
        return JaxCB(jparams, jcfg, num_slots=1, max_len=MAX_LEN, layout="paged",
                     block_size=BS, chunk=4, prefix_cache=True,
                     scfg=JaxSampler(temperature=0.0, top_k=0, max_new_tokens=NEW))

    got, hits, eng = _multi_turn(port, model)
    want, want_hits, _ = _multi_turn(jax_, model)
    assert hits >= 3 and hits == want_hits  # includes blocks decode wrote
    np.testing.assert_array_equal(got, want)
    assert _drained(eng)


def test_tiny_pool_evicts_and_keeps_parity(model):
    prompts = {uid: _toks(uid + 40, 11 + 3 * uid) for uid in range(5)}
    want, want_counters = _jax_run(model, prompts, new=5, num_slots=1, num_blocks=4,
                                   prefix_cache=True)
    cold, _, _ = _port_run(model, prompts, new=5, num_slots=1, num_blocks=4)
    streams, counters, eng = _port_run(model, prompts, new=5, num_slots=1, num_blocks=4,
                                       prefix_cache=True)
    assert counters == want_counters and counters["prefix_cache_evictions_total"] > 0
    for uid in prompts:
        np.testing.assert_array_equal(streams[uid], want[uid])
        np.testing.assert_array_equal(streams[uid], cold[uid])
    assert _drained(eng)


def test_dense_layout_raises(model):
    with pytest.raises(ValueError, match="paged layout"):
        _port_engine(model, layout="dense", prefix_cache=True)


UNSAFE = {
    "gemma3": lambda: registry.get_config("gemma3-27b"),
    "danube": lambda: registry.get_config("h2o-danube-1.8b"),
    "mla": lambda: registry.get_config("deepseek-v2-236b"),
    "deepseek-moe": lambda: registry.get_config("deepseek-moe-16b"),
    "experts-8": lambda: registry.get_config("pquant-100m", n_experts=8),
}


@pytest.mark.parametrize("family", sorted(UNSAFE))
def test_unsafe_family_declines_with_one_log(family, caplog):
    """Every family the port runs whose state lies outside the paged pool
    (windowed rings, MLA latents) or whose routing couples tokens declines
    the cache, logs once for two engines, and serves cold."""
    cfg = registry.reduced(UNSAFE[family]())
    assert not scheduler._prefix_cache_safe(cfg)
    scheduler._PREFIX_DECLINE_LOGGED.clear()
    params = api.init_model(0, cfg, device=CPU)
    scfg = SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=2)
    with caplog.at_level(logging.WARNING, logger=scheduler.__name__):
        engines = [ContinuousBatchingEngine(params, cfg, 2, 32, scfg, block_size=8, chunk=2,
                                            prefix_cache=True, device=CPU) for _ in range(2)]
    assert len([r for r in caplog.records if "prefix caching declined" in r.getMessage()]) == 1
    eng = engines[0]
    assert not eng.prefix_cache
    for uid in (0, 1):  # the same prompt twice: nothing hits
        eng.submit(_toks(11, 16) % cfg.vocab_size, max_new_tokens=2, seed=uid, uid=uid)
    finished = eng.run()
    assert [f.finish_reason for f in finished] == ["length", "length"]
    np.testing.assert_array_equal(finished[0].tokens, finished[1].tokens)
    assert not any(_counters(eng)[k] for k in COUNTERS[:4])


def test_the_paper_decoder_is_safe():
    assert scheduler._prefix_cache_safe(registry.reduced(registry.get_config("pquant-1.3b")))
