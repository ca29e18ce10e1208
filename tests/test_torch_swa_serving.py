"""Sliding-window and local/global attention served by the port, against
the JAX package on the CPU: the packed exports of ``registry.reduced``
gemma3-27b (window 16, every 2nd layer global: its global layers on the
paged pool, its local layers on dense rings) and h2o-danube-1.8b (every
layer windowed: no layer on the pool), made in JAX and converted leaf for
leaf; prompts longer than the window, so that the rings wrap during
prefill, and others that wrap them while decoding.

Exports exact (integers) or within rtol 1e-6 (scales); logits within ATOL
on the tokens that met no differing act-quant code, ATOL_FLIP where one
was decided two ways; greedy streams token for token against JAX's
batch-1 ``DecodeEngine``, in both cache layouts, one-shot and chunked
admission, the paged-attention kernel route on (its plain version on the
CPU) and off.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as japi
from repro.serve import scheduler as jscheduler
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import SamplerConfig as JaxSampler
from repro.train.quantized_serving import quantize_params_for_serving as jquantize
from repro_torch.convert import params_to_numpy
from repro_torch.kernels import _cuda
from repro_torch.kernels.paged_attention import _MAX_SMEM, paged_attention_plan, smem_bytes
from repro_torch.models import api
from repro_torch.serve import ContinuousBatchingEngine, DecodeEngine, SamplerConfig, scheduler
from repro_torch.train.quantized_serving import quantize_params_for_serving
from test_torch_experts import ATOL, ATOL_FLIP, CPU, _leaves, _t
from test_torch_swa import ARCHS, _cfgs
from test_torch_train import _torch_one_thread  # noqa: F401  (autouse)

MAX_LEN, NEW = 32, 8
# uid -> prompt length: 20 wraps the reduced window of 16 in the prefill,
# 9 + 8 new wraps it while decoding; two lengths, so that JAX's engine
# compiles two prefills
PROMPTS = {0: 20, 1: 9, 2: 20, 3: 9}


def _prompt(uid, n, vocab):
    return np.random.default_rng(uid + 10).integers(0, vocab, n).astype(np.int32)


@functools.cache
def _export(arch: str):
    jcfg, cfg = _cfgs(arch)
    params, axes = japi.init_model(jax.random.PRNGKey(11), jcfg)
    # one compiled export: op by op, each leaf's shapes compile anew (seconds an export)
    qparams = jax.jit(lambda p: jquantize(p, axes, jcfg, packed=True)[0])(params)
    return jcfg, cfg, params, qparams, _t(qparams)


@functools.cache
def _jax_streams(arch: str) -> dict:
    """JAX's batch-1 greedy streams of every prompt of PROMPTS."""
    jcfg, cfg, _, qparams, _ = _export(arch)
    eng = JaxEngine(qparams, jcfg, MAX_LEN)
    scfg = JaxSampler(temperature=0.0, top_k=0, max_new_tokens=NEW)
    return {uid: np.asarray(eng.generate(jnp.asarray(_prompt(uid, n, cfg.vocab_size)[None]),
                                         scfg))[0]
            for uid, n in PROMPTS.items()}


def _greedy():
    return SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=NEW)


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_export_equals_jax_leaf_for_leaf(arch):
    """Integers and scales exactly JAX's, leaf for leaf over the segment
    plan (gemma: ``segments[0]`` b0 (local) and b1 (global) stacked over 2
    repeats)."""
    _, cfg, params, qparams, _ = _export(arch)
    mine = params_to_numpy(quantize_params_for_serving(_t(params), cfg, packed=True))
    theirs = jax.tree.map(np.asarray, qparams)
    for (pa, a), (pb, b) in zip(_leaves(mine), _leaves(theirs), strict=True):
        name = jax.tree_util.keystr(pa)
        assert name == jax.tree_util.keystr(pb)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=name)
    seg = mine["segments"][0]
    assert sorted(seg) == (["b0", "b1"] if arch == "gemma3-27b" else ["b0"])
    assert seg["b0"]["mixer"]["wq"]["w"]["packed"].shape[0] == (2 if arch == "gemma3-27b" else 4)
    assert ("lm_head" in mine) == (arch != "gemma3-27b")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_chunk_continues_from_a_wrapped_ring(arch):
    """``prefill`` of 20 tokens (the rings wrap), then ``forward_chunk`` of
    8 more from that cache: logits against JAX's same two calls (JAX's
    own chunk equals its teacher-forced ``forward``, upstream's
    ``tests/test_serving.py``); the rings after the chunk JAX's;
    ``logits_at`` the chunk's row."""
    jcfg, cfg, _, qparams, tq = _export(arch)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 28)).astype(np.int32)

    def jax_both(q, head, tail):  # one compile for the two calls
        _, c = japi.prefill(q, {"tokens": head}, jcfg, MAX_LEN)
        return japi.forward_chunk(q, tail, c, jnp.asarray(20, jnp.int32), jcfg)

    jl, jc = jax.jit(jax_both)(qparams, jnp.asarray(toks[:, :20]), jnp.asarray(toks[:, 20:]))
    tt = torch.from_numpy(toks).long()
    _, c = api.prefill(tq, {"tokens": tt[:, :20]}, cfg, MAX_LEN)
    assert c[0]["b0"]["k"].shape[-3] == 16  # the ring: the window, not MAX_LEN
    tl, c = api.forward_chunk(tq, tt[:, 20:], c, 20, cfg)
    err = np.abs(tl.numpy() - np.asarray(jl))
    assert err.max() <= ATOL_FLIP and np.median(err) <= ATOL, err.max()
    for (path, a), (_, b) in zip(_leaves(c), _leaves(jc), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    _, c2 = api.prefill(tq, {"tokens": tt[:, :20]}, cfg, MAX_LEN)
    at, _ = api.forward_chunk(tq, tt[:, 20:], c2, 20, cfg, logits_at=torch.tensor([7, 3]))
    np.testing.assert_allclose(at.numpy(), tl[torch.arange(2), torch.tensor([7, 3])].numpy(),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_engine_greedy_streams_equal_jax(arch):
    """Batch 1 per prompt, and the two 20-token prompts as one batch, token
    for token JAX's batch-1 streams; one transfer a generate, no kernel
    launched on the CPU."""
    _, cfg, _, _, tq = _export(arch)
    want = _jax_streams(arch)
    eng = DecodeEngine(tq, cfg, max_len=MAX_LEN, device=CPU)
    _cuda.reset_launches()
    for uid, n in PROMPTS.items():
        got = eng.generate(_prompt(uid, n, cfg.vocab_size)[None], _greedy())
        np.testing.assert_array_equal(got[0], want[uid], err_msg=str(uid))
    assert eng.host_transfers == len(PROMPTS) and sum(_cuda.LAUNCHES.values()) == 0
    pair = np.stack([_prompt(uid, 20, cfg.vocab_size) for uid in (0, 2)])
    got = eng.generate(pair, _greedy())
    np.testing.assert_array_equal(got, np.stack([want[0], want[2]]))


CB_CASES = [("gemma3-27b", "paged", pc, env) for pc in (None, 4) for env in ("auto", "1")]
CB_CASES += [("gemma3-27b", "dense", pc, "auto") for pc in (None, 4)]
CB_CASES += [("h2o-danube-1.8b", layout, pc, "auto") for layout in ("paged", "dense")
             for pc in (None, 4)]


@pytest.mark.parametrize("arch, layout, prefill_chunk, env", CB_CASES)
def test_continuous_batching_streams_equal_jax(arch, layout, prefill_chunk, env, monkeypatch):
    """Greedy streams of the port's continuous batcher (2 slots, so that
    requests queue and a slot's ring is reused) token for token JAX's
    batch-1 ``DecodeEngine``: both layouts (danube's paged layout has no
    layer on the pool), one-shot admission (at exact length: a ring
    shorter than MAX_LEN declines the buckets) and chunked in slices of 4
    (the ring path is sequential a token, so the slicing changes
    nothing), the paged-attention kernel route on and off."""
    _, cfg, _, _, tq = _export(arch)
    want = _jax_streams(arch)
    monkeypatch.setenv("REPRO_PAGED_ATTN", env)
    eng = ContinuousBatchingEngine(tq, cfg, 2, MAX_LEN, _greedy(), layout=layout, block_size=8,
                                   chunk=4, prefill_chunk=prefill_chunk, device=CPU)
    assert eng.prefill_chunk == prefill_chunk and eng._prefill_bucketed is None
    on_pool = sum(c["table"].shape[0] if stacked else 1
                  for stacked, c in scheduler._cache_dicts(cfg, eng._caches) if "table" in c)
    assert on_pool == (cfg.n_layers // cfg.global_every if cfg.global_every and
                       layout == "paged" else 0)
    for uid, n in PROMPTS.items():
        eng.submit(_prompt(uid, n, cfg.vocab_size), max_new_tokens=NEW, seed=uid, uid=uid)
    finished = eng.run()
    assert sorted(f.uid for f in finished) == sorted(PROMPTS)
    for f in finished:
        np.testing.assert_array_equal(f.tokens, want[f.uid], err_msg=str(f.uid))
        assert f.finish_reason == "length"
    if eng.allocator is not None:
        assert eng.allocator.free_count == eng.num_blocks


@pytest.mark.parametrize("arch", ARCHS + ("swa",))
def test_bucket_gate_declines_rings_and_chunk_gate_accepts(arch):
    """As upstream's gates: a ring shorter than max_len declines bucketed
    admission (the prefill would keep the padded tail); a ring as long as
    max_len is no ring to a prefill and is accepted; chunked admission
    takes ring configs at every max_len."""
    jcfg, cfg = _cfgs(arch)
    for max_len in (cfg.window_size, cfg.window_size + 1, 64):
        ok = scheduler._bucketed_prefill_safe(cfg, max_len)
        assert ok == jscheduler._bucketed_prefill_safe(jcfg, max_len)
        assert ok == (max_len <= cfg.window_size)
    assert scheduler._chunked_prefill_safe(cfg) and jscheduler._chunked_prefill_safe(jcfg)


@pytest.mark.parametrize("t", [1, 64, 1100])
def test_paged_attention_plans_fit_at_gemmas_shapes(t):
    """gemma3-27b's paged shapes (32 query heads over 16 KV heads of 128, a
    group of 2; 1280 positions a slot, 80 pages a table): the decode plan
    takes the split route, a slice of 64 or a whole 1100-token prompt the
    tile route, and every layout fits a block's shared memory in f32 and
    bf16 pools."""
    for b in (4, 1):
        plan = paged_attention_plan(b, t, 32, 16, 128, 80)
        assert plan.route == ("split" if t == 1 else "tile") and 1 <= plan.splits <= 8
        for elem in (4, 2):
            assert smem_bytes(plan, 128, 16, elem, 80) <= _MAX_SMEM, (b, t, plan, elem)
