"""pQuant's routed 8-bit experts (N > 1, paper §3.3) served by the port,
against the JAX package on the CPU: the packed export of
``registry.reduced`` pquant-100m with N in {2, 4} experts (made in JAX,
converted leaf for leaf) leaf for leaf, ``forward_chunk`` logits, and the
greedy streams of ``DecodeEngine`` and ``ContinuousBatchingEngine``.

On the export, the routed FFN takes upstream's route: the packed 1-bit
trunk through the W1A8 entry point (its plain version on CPU tensors),
the experts dequantized to float.  Logits within ATOL, or ATOL_FLIP where
an act-quant code is decided two ways (``tests/test_torch_decoder.py``);
streams token for token.  Capacity couples the rows routed together (a
prefill's B x T rows, every slot of a continuous-batching chunk), so the
continuous batcher is held to JAX's own continuous batcher.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as japi
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import SamplerConfig as JaxSampler
from repro.serve.scheduler import ContinuousBatchingEngine as JaxCB
from repro.train.quantized_serving import quantize_params_for_serving as jquantize
from repro_torch.convert import params_to_numpy
from repro_torch.core import decoupled
from repro_torch.kernels import _cuda
from repro_torch.models import api
from repro_torch.models.layers import apply_ffn
from repro_torch.serve import ContinuousBatchingEngine, DecodeEngine, SamplerConfig
from repro_torch.train.quantized_serving import quantize_params_for_serving
from test_torch_experts import ATOL, ATOL_FLIP, CPU, MAX_LEN, NEW, _cfgs, _count_drops, _leaves, _t


@pytest.fixture(scope="module", params=[2, 4])
def served(request):
    jcfg, cfg = _cfgs(request.param)
    params, axes = japi.init_model(jax.random.PRNGKey(11), jcfg)
    qparams, _ = jquantize(params, axes, jcfg, packed=True)
    return request.param, jcfg, cfg, params, qparams, _t(qparams)


def test_packed_export_equals_jax_leaf_for_leaf(served):
    """Integers and scales exactly JAX's; the experts one int8 scale a
    (layer, expert) slice; the router stays float; the trunk packed."""
    n, jcfg, cfg, params, qparams, _ = served
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
    ffn = mine["segments"][0]["b0"]["ffn"]
    L, d, r = cfg.n_layers, cfg.d_model, cfg.quant.r
    assert ffn["w8_up"]["q"].shape == (L, n, d, r) and ffn["w8_up"]["q"].dtype == np.int8
    assert ffn["w8_up"]["scale"].shape == (L, n, 1, 1)
    assert ffn["w8_down"]["q"].shape == (L, n, r, d)
    assert ffn["router"]["w"].dtype == np.float32 and ffn["router"]["w"].shape == (L, d, n)
    assert ffn["w1_up"]["packed"].dtype == np.uint8


def test_packed_forward_chunk_matches_jax(served):
    """forward_chunk logits on the packed export (the routed FFN's serving
    route: trunk on the W1A8 kernels' plain versions, experts dequantized
    to float), at the decode tier (2 x 8 rows) and the prefill tier
    (3 x 12 = 36 rows)."""
    n, jcfg, cfg, _, qparams, tq = served
    drops = []
    for b, s, seed in ((2, 8, 2), (3, 12, 21)):
        toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        jcache, _ = japi.init_cache(jcfg, b, 16, jnp.float32)
        jl, _ = japi.forward_chunk(qparams, jnp.asarray(toks), jcache,
                                   jnp.asarray(0, jnp.int32), jcfg)
        with _count_drops(drops):
            tl, _ = api.forward_chunk(tq, torch.from_numpy(toks).long(),
                                      api.init_cache(cfg, b, 16, torch.float32, device=CPU), 0,
                                      cfg)
        err = np.abs(tl.numpy() - np.asarray(jl))
        assert err.max() <= ATOL_FLIP and np.median(err) <= ATOL, (b, s, err.max())
    assert sum(drops) > 0, drops  # some layer's batch overflowed an expert


def test_packed_ffn_takes_upstreams_route(served, monkeypatch):
    """On the packed routed export the FFN calls ``bit_linear_infer`` three
    times (the trunk) and no fused or int8 entry point."""
    from repro_torch.kernels import ops

    _, _, cfg, _, _, tq = served
    calls = []
    for name in ("bit_linear_infer", "decoupled_first_gemm", "int8_linear_infer"):
        orig = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _o=orig, _n=name, **k: (calls.append(_n),
                                                                          _o(*a, **k))[1])
    layer = tq["segments"][0]["b0"]["ffn"]  # the first layer's view of the stack
    one = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict) else v[0])
           for k, v in layer.items()}
    assert not decoupled._serving_ffn_layout(one, True)
    x = torch.randn(5, cfg.d_model, generator=torch.Generator().manual_seed(0))
    y, aux = apply_ffn(one, x, cfg)
    assert calls == ["bit_linear_infer"] * 3 and torch.isfinite(y).all() and aux > 0


def test_decode_engine_greedy_streams_equal_jax(served):
    n, jcfg, cfg, _, qparams, tq = served
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 6)).astype(np.int32)
    want = JaxEngine(qparams, jcfg, max_len=MAX_LEN).generate(
        jnp.asarray(prompts), JaxSampler(temperature=0.0, top_k=0, max_new_tokens=NEW))
    eng = DecodeEngine(tq, cfg, max_len=MAX_LEN, device=CPU)
    _cuda.reset_launches()
    got = eng.generate(prompts, SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=NEW))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert eng.host_transfers == 1 and sum(_cuda.LAUNCHES.values()) == 0


CB_PROMPTS = {0: 5, 1: 3, 2: 7, 3: 4, 4: 6}  # uid -> ragged prompt length


def _cb_streams(engine, prompts, vocab, to_prompt):
    for uid, n in prompts.items():
        engine.submit(to_prompt(np.random.default_rng(uid + 10).integers(0, vocab, n)
                                .astype(np.int32)), max_new_tokens=NEW, seed=uid, uid=uid)
    return {f.uid: np.asarray(f.tokens) for f in engine.run()}


@pytest.fixture(scope="module")
def jax_cb(served):
    """The JAX ContinuousBatchingEngine's streams on the routed export (3
    slots, so that requests queue and slots go idle), paged (upstream's
    dense layout serves the same streams): capacity couples the rows
    routed together, so the reference is JAX's own continuous batcher, not
    its batch-1 engine."""
    n, jcfg, cfg, _, qparams, _ = served
    eng = JaxCB(qparams, jcfg, 3, MAX_LEN, JaxSampler(temperature=0.0, top_k=0, max_new_tokens=NEW),
                layout="paged", block_size=8, chunk=4)
    return _cb_streams(eng, CB_PROMPTS, cfg.vocab_size, jnp.asarray)


@pytest.mark.parametrize("env", ["auto", "1"])
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_continuous_batching_streams_equal_jax(served, jax_cb, monkeypatch, layout, env):
    """Greedy streams of the port's continuous batcher against JAX's, both
    layouts, the paged kernel route on and off; a chunked prefill is
    declined for a routed config (one-shot admission, exact length)."""
    n, _, cfg, _, _, tq = served
    monkeypatch.setenv("REPRO_PAGED_ATTN", env)
    eng = ContinuousBatchingEngine(tq, cfg, 3, MAX_LEN,
                                   SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=NEW),
                                   layout=layout, block_size=8, chunk=4, prefill_chunk=4,
                                   device=CPU)
    assert eng.prefill_chunk is None and eng._prefill_bucketed is None
    got = _cb_streams(eng, CB_PROMPTS, cfg.vocab_size, lambda p: p)
    assert sorted(got) == sorted(jax_cb)
    for uid, toks in got.items():
        np.testing.assert_array_equal(toks, jax_cb[uid], err_msg=str(uid))
