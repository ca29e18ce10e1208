"""The port's ``ContinuousBatchingEngine`` against the JAX package.

Acceptance: every request's greedy stream equals the JAX ``DecodeEngine``'s
batch-1 stream for its prompt, with ragged prompts and fewer slots than
requests, for both cache layouts, one-shot and chunked admission, the
paged-attention kernel route on (``REPRO_PAGED_ATTN=1``: its plain version
on the CPU) and off (``auto``: the gather path on the CPU), on fake-quant
weights and on the packed export of a reduced pquant config.  The JAX
references are built once per module.

Sampled streams cannot match JAX's threefry bits; each request's sampled
stream is held to the port's own ``DecodeEngine.generate(prompt[None],
scfg, seed=seed)`` instead.  The rest mirrors the passing cases of
``tests/test_continuous_batching.py``: paged equals dense bit for bit,
stop tokens, block reclamation, preemption mid-chunked-prefill, budget
one, submit validation, deadlines and shedding on a ``ManualClock``,
bucketed admission, the paged ``init_cache`` adapter, the watchdog and
the NaN/Inf quarantine (upstream's ``tests/test_robustness.py`` cases that
need no fault injector).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import ModelConfig as JaxConfig
from repro.core.quantization import QuantConfig as JaxQuant
from repro.models import api as japi
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import SamplerConfig as JaxSampler
from repro.train.quantized_serving import quantize_params_for_serving as jquantize
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.quantization import QuantConfig
from repro_torch.kernels import _cuda
from repro_torch.models import api
from repro_torch.serve import (
    ContinuousBatchingEngine,
    DecodeEngine,
    InadmissibleRequest,
    ManualClock,
    SamplerConfig,
    validate_snapshot,
)
from repro_torch.serve import scheduler
from test_torch_train import _torch_one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
_KW = dict(name="t", family="decoder", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
           d_ff=48, vocab_size=64)
MAX_LEN = 32
PROMPTS = {0: 5, 1: 3, 2: 7, 3: 4}  # uid -> ragged prompt length
NEW = 6


def _prompt(seed, n, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def _greedy(n=NEW, **kw):
    return SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=n, **kw)


def _jax_streams(jparams, jcfg, prompts, new, vocab):
    eng = JaxEngine(jparams, jcfg, MAX_LEN)
    scfg = JaxSampler(temperature=0.0, top_k=0, max_new_tokens=new)
    return {uid: np.asarray(eng.generate(jnp.asarray(_prompt(uid + 10, n, vocab)[None]), scfg,
                                         seed=uid))[0]
            for uid, n in prompts.items()}


@pytest.fixture(scope="module")
def tiny():
    """Fake-quant pQuant weights made in JAX, converted, and the JAX
    engine's batch-1 greedy streams."""
    jcfg = JaxConfig(quant=JaxQuant(mode="pquant", r=16, num_experts=1), **_KW)
    cfg = ModelConfig(quant=QuantConfig(mode="pquant", r=16, num_experts=1), **_KW)
    jparams, _ = japi.init_model(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    return cfg, tparams, _jax_streams(jparams, jcfg, PROMPTS, NEW, 64)


@pytest.fixture(scope="module")
def packed():
    """The packed serving export of reduced pquant-100m (the kernel tiers
    on every projection) and the JAX engine's streams on it."""
    jcfg = jregistry.reduced(jregistry.get_config("pquant-100m"))
    cfg = registry.reduced(registry.get_config("pquant-100m"))
    params, axes = japi.init_model(jax.random.PRNGKey(11), jcfg)
    # one compiled export: op by op, each leaf's shapes compile anew (seconds an export)
    qparams = jax.jit(lambda p: jquantize(p, axes, jcfg, packed=True)[0])(params)
    tq = params_from_numpy(jax.tree.map(np.asarray, qparams), CPU)
    prompts = {0: 5, 1: 3, 2: 7}
    return cfg, tq, prompts, _jax_streams(qparams, jcfg, prompts, NEW, cfg.vocab_size)


def _engine(cfg, params, **kw):
    kw.setdefault("scfg", _greedy())
    kw.setdefault("block_size", 8)
    kw.setdefault("chunk", 4)
    return ContinuousBatchingEngine(params, cfg, max_len=kw.pop("max_len", MAX_LEN),
                                    device=CPU, **kw)


def _serve(eng, prompts, vocab=64, new=NEW, **submit):
    for uid, n in prompts.items():
        eng.submit(_prompt(uid + 10, n, vocab), max_new_tokens=new, seed=uid, uid=uid, **submit)
    return eng.run()


@pytest.mark.parametrize("env", ["auto", "1"])
@pytest.mark.parametrize("prefill_chunk", [None, 3])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_greedy_streams_equal_jax_engine(tiny, monkeypatch, layout, prefill_chunk, env):
    cfg, tparams, want = tiny
    monkeypatch.setenv("REPRO_PAGED_ATTN", env)
    eng = _engine(cfg, tparams, num_slots=2, layout=layout, prefill_chunk=prefill_chunk)
    assert eng.prefill_chunk == prefill_chunk
    _cuda.reset_launches()
    finished = _serve(eng, PROMPTS)
    assert sum(_cuda.LAUNCHES.values()) == 0  # CPU tensors: plain versions only
    assert sorted(f.uid for f in finished) == sorted(PROMPTS)
    for f in finished:
        np.testing.assert_array_equal(f.tokens, want[f.uid])
        assert f.finish_reason == "length"
        assert f.first_token_at >= f.admitted_at
    if layout == "paged":
        assert eng.allocator.free_count == eng.num_blocks


@pytest.mark.parametrize("env", ["auto", "1"])
@pytest.mark.parametrize("prefill_chunk", [None, 3])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_packed_greedy_streams_equal_jax_engine(packed, monkeypatch, layout, prefill_chunk,
                                                env):
    cfg, tq, prompts, want = packed
    monkeypatch.setenv("REPRO_PAGED_ATTN", env)
    eng = _engine(cfg, tq, num_slots=2, layout=layout, prefill_chunk=prefill_chunk)
    finished = _serve(eng, prompts, cfg.vocab_size)
    assert sorted(f.uid for f in finished) == sorted(prompts)
    for f in finished:
        np.testing.assert_array_equal(f.tokens, want[f.uid])


def test_paged_matches_dense_bit_for_bit(tiny):
    cfg, tparams, _ = tiny
    scfg = SamplerConfig(temperature=0.7, top_k=10, max_new_tokens=NEW)
    outs = {}
    for layout in ("dense", "paged"):
        eng = _engine(cfg, tparams, num_slots=3, layout=layout, scfg=scfg)
        outs[layout] = {f.uid: f.tokens for f in _serve(eng, PROMPTS)}
    for uid in PROMPTS:
        np.testing.assert_array_equal(outs["dense"][uid], outs["paged"][uid])


@pytest.mark.parametrize("prefill_chunk", [None, 3])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_sampled_streams_equal_port_decode_engine(tiny, layout, prefill_chunk):
    """Each request's generator draws a (1, V) row per token in the order
    of the port's ``DecodeEngine.generate(prompt[None], scfg, seed=seed)``,
    so the sampled stream is that call's."""
    cfg, tparams, _ = tiny
    scfg = SamplerConfig(temperature=0.9, top_k=20, max_new_tokens=NEW)
    ref = DecodeEngine(tparams, cfg, MAX_LEN, device=CPU)
    eng = _engine(cfg, tparams, num_slots=2, layout=layout, scfg=scfg,
                  prefill_chunk=prefill_chunk)
    finished = _serve(eng, PROMPTS)
    assert len(finished) == len(PROMPTS)
    for f in finished:
        want = ref.generate(_prompt(f.uid + 10, PROMPTS[f.uid])[None], scfg, seed=f.uid)[0]
        np.testing.assert_array_equal(f.tokens, want)


def test_admission_eviction_under_arrival_trace(tiny):
    cfg, tparams, want = tiny
    eng = _engine(cfg, tparams, num_slots=2, chunk=2)
    arrivals = {0: 0.0, 1: 0.0, 2: 1.0, 3: 5.0}
    for uid, n in PROMPTS.items():
        eng.submit(_prompt(uid + 10, n), max_new_tokens=NEW, seed=uid, uid=uid,
                   arrival=arrivals[uid])
    order, finished = [], []
    while eng._queue or eng._live():
        done = eng.step()
        finished.extend(done)
        order.extend(f.uid for f in done)
    assert sorted(order) == sorted(PROMPTS)
    assert order.index(3) > order.index(0) and order.index(3) > order.index(1)
    for f in finished:
        np.testing.assert_array_equal(f.tokens, want[f.uid])
        assert f.admitted_at >= arrivals[f.uid]


def test_stop_token_truncation(tiny):
    cfg, tparams, _ = tiny
    prompt = _prompt(99, 5)
    full = DecodeEngine(tparams, cfg, MAX_LEN, device=CPU).generate(prompt[None], _greedy(10))[0]
    stop = int(full[2])
    eng = _engine(cfg, tparams, num_slots=1, scfg=_greedy(10, stop_tokens=(stop,)))
    eng.submit(prompt, max_new_tokens=10, seed=0, uid=0)
    (f,) = eng.run()
    cut = int(np.where(full == stop)[0][0])
    np.testing.assert_array_equal(f.tokens, full[: cut + 1])
    assert f.finish_reason == "stop"
    assert eng.allocator.free_count == eng.num_blocks


@pytest.mark.parametrize("prefill_chunk", [None, 3])
def test_no_leaked_blocks_after_full_trace(tiny, prefill_chunk):
    """A 4-block pool forces waiting and preemption; preempted requests
    restart to the same streams and every block comes back."""
    cfg, tparams, _ = tiny
    scfg = SamplerConfig(temperature=0.7, top_k=10, max_new_tokens=12)
    eng = _engine(cfg, tparams, num_slots=2, num_blocks=4, scfg=scfg,
                  prefill_chunk=prefill_chunk)
    ref = DecodeEngine(tparams, cfg, MAX_LEN, device=CPU)
    lens = {0: 7, 1: 3, 2: 5}
    for uid, n in lens.items():
        eng.submit(_prompt(uid + 50, n), max_new_tokens=12, seed=uid, uid=uid)
    finished = eng.run()
    assert sorted(f.uid for f in finished) == sorted(lens)
    assert eng.preemptions > 0
    for f in finished:
        want = ref.generate(_prompt(f.uid + 50, lens[f.uid])[None], scfg, seed=f.uid)[0]
        np.testing.assert_array_equal(f.tokens, want)
    assert eng.allocator.free_count == eng.num_blocks
    assert eng.snapshot()["gauges"]["pool_blocks_used"] == 0


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_chunked_preemption_mid_prefill_restarts_deterministically(tiny, layout):
    cfg, tparams, want = tiny
    eng = _engine(cfg, tparams, num_slots=2, layout=layout, prefill_chunk=3)
    for uid in (2, 0):  # uid 2's 7-token prompt needs three 3-token slices
        eng.submit(_prompt(uid + 10, PROMPTS[uid]), max_new_tokens=NEW, seed=uid, uid=uid)
    eng.step()  # admits both; exactly one slice of uid 2 has landed
    victim = next(rs for rs in eng._live() if 0 < rs.prefilled < len(rs.request.prompt))
    assert victim.request.uid == 2 and victim.n_generated == 0
    eng._preempt(victim)
    finished = eng.run()
    assert eng.preemptions == 1
    assert sorted(f.uid for f in finished) == [0, 2]
    for f in finished:
        np.testing.assert_array_equal(f.tokens, want[f.uid])
    if layout == "paged":
        assert eng.allocator.free_count == eng.num_blocks


@pytest.mark.parametrize("prefill_chunk", [None, 2])
def test_budget_one_finishes_at_admission(tiny, prefill_chunk):
    cfg, tparams, _ = tiny
    eng = _engine(cfg, tparams, num_slots=1, scfg=_greedy(1), prefill_chunk=prefill_chunk)
    prompt = _prompt(7, 5)
    eng.submit(prompt, max_new_tokens=1, seed=0, uid=0)
    (f,) = eng.run()
    want = DecodeEngine(tparams, cfg, MAX_LEN, device=CPU).generate(prompt[None], _greedy(1))[0]
    np.testing.assert_array_equal(f.tokens, want)
    assert f.finish_reason == "length"
    assert eng.allocator.free_count == eng.num_blocks
    assert all(rs is None for rs in eng._slots)


def test_submit_validation(tiny):
    cfg, tparams, _ = tiny
    eng = _engine(cfg, tparams, num_slots=1, max_len=16)
    with pytest.raises(InadmissibleRequest, match="slot capacity"):
        eng.submit(_prompt(0, 10), max_new_tokens=10)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(np.asarray([], np.int32), max_new_tokens=2)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(_prompt(0, 4), max_new_tokens=0)
    small = _engine(cfg, tparams, num_slots=1, max_len=16, num_blocks=1)
    with pytest.raises(InadmissibleRequest, match="pool has only"):
        small.submit(_prompt(0, 6), max_new_tokens=4)  # 10 tokens need 2 blocks
    with pytest.raises(ValueError):
        _engine(cfg, tparams, num_slots=1, layout="ring")
    with pytest.raises(ValueError):
        _engine(cfg, tparams, num_slots=1, overload_policy="drop")
    assert eng.snapshot()["counters"]["requests_submitted_total"] == 0


def test_deadlines_and_shedding_on_a_manual_clock(tiny):
    """A queued request past its deadline finishes with zero tokens, a
    dead-on-arrival one is rejected, a full queue sheds per policy, and
    every request finishes exactly once."""
    cfg, tparams, want = tiny
    clock = ManualClock()
    eng = _engine(cfg, tparams, num_slots=1, clock=clock, max_queue=2,
                  overload_policy="shed_oldest")
    eng.submit(_prompt(10, 5), max_new_tokens=NEW, seed=0, uid=0)
    eng.submit(_prompt(11, 3), max_new_tokens=NEW, seed=1, uid=1, deadline=0.5)
    eng.submit(_prompt(12, 7), max_new_tokens=NEW, seed=2, uid=2)  # sheds uid 0
    eng.submit(_prompt(13, 4), max_new_tokens=NEW, seed=3, uid=3, deadline=0.0)  # rejected
    clock.advance(1.0)  # uid 1's deadline passes while it waits
    finished = {f.uid: f for f in eng.run()}
    assert finished[0].finish_reason == "shed" and len(finished[0].tokens) == 0
    assert finished[1].finish_reason == "deadline" and len(finished[1].tokens) == 0
    assert finished[3].finish_reason == "rejected"
    assert finished[2].finish_reason == "length"
    np.testing.assert_array_equal(finished[2].tokens, want[2])
    assert sum(eng.finished_by_reason.values()) == 4
    assert eng.shed_requests == 1 and eng.rejected_requests == 1 and eng.deadline_misses == 1
    snap = eng.snapshot()
    validate_snapshot(snap)
    assert snap["counters"]["requests_submitted_total"] == 4
    assert snap["histograms"]["ttft_seconds"]["count"] == 1
    assert eng.allocator.free_count == eng.num_blocks


def test_reject_policy_and_live_deadline(tiny):
    cfg, tparams, _ = tiny
    clock = ManualClock()
    eng = _engine(cfg, tparams, num_slots=1, clock=clock, max_queue=1, chunk=1)
    eng.submit(_prompt(10, 5), max_new_tokens=20, seed=0, uid=0, deadline=2.5)
    eng.submit(_prompt(11, 3), max_new_tokens=4, seed=1, uid=1)  # queue full: rejected
    done = []
    while eng._queue or eng._live() or eng._pending_finished:
        done.extend(eng.step())
        clock.advance(1.0)
    by = {f.uid: f for f in done}
    assert by[1].finish_reason == "shed"
    assert by[0].finish_reason == "deadline" and 0 < len(by[0].tokens) < 20
    assert eng.allocator.free_count == eng.num_blocks


def test_one_fetch_per_chunk_and_per_admission(tiny):
    cfg, tparams, _ = tiny
    eng = _engine(cfg, tparams, num_slots=1, chunk=3)
    eng.submit(_prompt(10, 5), max_new_tokens=7, seed=0, uid=0)
    (f,) = eng.run()
    # one admission fetch, then ceil(6 / 3) decode chunks
    assert len(f.tokens) == 7 and eng.host_transfers == 1 + 2


def test_bucketed_admission(tiny):
    """Ragged prompts right-padded to power-of-two buckets give the
    exact-length streams."""
    cfg, tparams, want = tiny
    assert scheduler._bucketed_prefill_safe(cfg, MAX_LEN)
    eng = _engine(cfg, tparams, num_slots=2)
    assert eng._prefill_bucketed is not None
    lens = []
    orig = eng._prefill_bucketed

    def spy(params, tokens, plen, gen):
        lens.append((tokens.shape[1], plen))
        return orig(params, tokens, plen, gen)

    eng._prefill_bucketed = spy
    for f in _serve(eng, PROMPTS):
        np.testing.assert_array_equal(f.tokens, want[f.uid])
    assert sorted(lens) == [(4, 3), (4, 4), (8, 5), (8, 7)]
    assert scheduler._chunked_prefill_safe(cfg)


def test_api_paged_init_cache_is_a_drop_in_adapter(tiny):
    """Decoding over ``api.init_cache(layout="paged")`` is bit for bit the
    dense-layout decode, and its tree has the engine's structure."""
    cfg, tparams, _ = tiny
    b, max_len, bs = 2, 16, 8
    dense = api.init_cache(cfg, b, max_len, torch.float32, CPU)
    paged = api.init_cache(cfg, b, max_len, torch.float32, CPU, layout="paged", block_size=bs)
    for seg in paged:
        for c in seg.values():
            c["table"][...] = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    active = torch.tensor([True, True])
    rng = np.random.default_rng(0)
    for t in range(4):
        tok = torch.from_numpy(rng.integers(0, 64, (b, 1)))
        pos = torch.full((b,), t, dtype=torch.int32)
        ld, _ = api.decode_step(tparams, tok, dense, pos, cfg, active)
        lp, _ = api.decode_step(tparams, tok, paged, pos, cfg, active)
        assert torch.equal(ld, lp)
    eng = _engine(cfg, tparams, num_slots=b, max_len=max_len, block_size=bs)
    ref = api.init_cache(cfg, b, max_len, torch.float32, CPU, layout="paged", block_size=bs,
                         num_blocks=eng.num_blocks)
    assert [{k: {n: tuple(x.shape) for n, x in c.items()} for k, c in seg.items()}
            for seg in ref] == \
        [{k: {n: tuple(x.shape) for n, x in c.items()} for k, c in seg.items()}
         for seg in eng._caches]
    with pytest.raises(ValueError):
        api.init_cache(cfg, b, max_len, torch.float32, CPU, layout="ring")


def test_auto_uids_never_recycle(tiny):
    cfg, tparams, _ = tiny
    eng = _engine(cfg, tparams, num_slots=1, layout="dense", scfg=_greedy(2), chunk=2)
    a = eng.submit(_prompt(1, 3))
    eng.run()
    b = eng.submit(_prompt(2, 3))
    eng.run()
    assert a != b


def test_watchdog_raises_diagnosable_stall(tiny):
    """An admission that can never proceed (every alloc failing) raises
    SchedulerStall with the queue depth and allocator state, not a spin."""
    cfg, tparams, _ = tiny
    eng = _engine(cfg, tparams, num_slots=1, watchdog_steps=4)
    eng.allocator.fail_hook = lambda: True
    eng.submit(_prompt(10, 4), max_new_tokens=4, seed=0, uid=0)
    with pytest.raises(scheduler.SchedulerStall, match="queue depth 1"):
        eng.run()
    assert eng.snapshot()["counters"]["block_alloc_failures_total"] >= 4


def test_watchdog_tolerates_idle_waiting(tiny):
    cfg, tparams, _ = tiny
    eng = _engine(cfg, tparams, num_slots=1, layout="dense", watchdog_steps=2)
    eng.submit(_prompt(10, 4), max_new_tokens=4, seed=0, uid=0, arrival=100.0)
    assert [f.finish_reason for f in eng.run()] == ["length"]


def test_nan_logits_quarantine_only_their_stream(tiny, monkeypatch):
    """Non-finite decode logits of one slot finish that request with reason
    ``error`` at that step (its earlier tokens kept); every other stream
    is unchanged.  Non-finite prefill logits finish a request at
    admission with no tokens."""
    cfg, tparams, want = tiny
    orig_step, orig_prefill = api.decode_step, api.prefill
    calls = {"n": 0}

    def poisoned_step(params, tokens, caches, pos, cfg_, active=None):
        logits, caches = orig_step(params, tokens, caches, pos, cfg_, active)
        calls["n"] += 1
        if calls["n"] == 3:
            logits = logits.clone()
            logits[1] = float("nan")  # slot 1 at the third decode step
        return logits, caches

    def poisoned_prefill(params, batch, cfg_, cache_len, last_pos=None):
        logits, caches = orig_prefill(params, batch, cfg_, cache_len, last_pos)
        if last_pos == PROMPTS[3]:
            logits = torch.full_like(logits, float("inf"))
        return logits, caches

    monkeypatch.setattr(api, "decode_step", poisoned_step)
    monkeypatch.setattr(api, "prefill", poisoned_prefill)
    eng = _engine(cfg, tparams, num_slots=2)
    finished = {f.uid: f for f in _serve(eng, PROMPTS)}
    assert eng.quarantined == 2
    assert finished[3].finish_reason == "error" and len(finished[3].tokens) == 0
    bad = [u for u, f in finished.items() if f.finish_reason == "error" and u != 3]
    assert len(bad) == 1
    np.testing.assert_array_equal(finished[bad[0]].tokens, want[bad[0]][:3])
    for uid, f in finished.items():
        if f.finish_reason == "length":
            np.testing.assert_array_equal(f.tokens, want[uid])
    assert sum(eng.finished_by_reason.values()) == len(PROMPTS)
    assert eng.allocator.free_count == eng.num_blocks


def test_exact_length_admission(tiny):
    """The exact-length admission prefill (taken where bucketing could
    change a stream) gives the same streams as the bucketed one."""
    cfg, tparams, want = tiny
    eng = _engine(cfg, tparams, num_slots=2)
    eng._prefill_bucketed = None
    for f in _serve(eng, PROMPTS):
        np.testing.assert_array_equal(f.tokens, want[f.uid])
