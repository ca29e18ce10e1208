"""DeepSeek-MoE served by the port, against the JAX package on the CPU: the
packed export of ``registry.reduced`` deepseek-moe-16b (made in JAX,
converted leaf for leaf) leaf for leaf, ``forward_chunk`` logits in both
dispatch arms, and the greedy streams of ``DecodeEngine`` and
``ContinuousBatchingEngine``.

On the export every expert slice runs the W1A8 entry point (its plain
version on CPU tensors) once per linear, as upstream's
``_experts_apply_packed``; the shared experts are an N = 1 decoupled FFN
on the fused entry points.  Logits within ATOL, or ATOL_FLIP where an
act-quant code is decided two ways; streams token for token.  Capacity
couples the rows routed together, so the continuous batcher is held to
JAX's own continuous batcher (``tests/test_torch_experts_serving.py``).
"""

import functools

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
from repro_torch.kernels import _cuda, ops
from repro_torch.kernels.paged_attention import _MAX_SMEM, paged_attention_plan, smem_bytes
from repro_torch.models import api, moe
from repro_torch.serve import ContinuousBatchingEngine, DecodeEngine, SamplerConfig
from repro_torch.train.quantized_serving import quantize_params_for_serving
from test_torch_experts import ATOL, ATOL_FLIP, CPU, MAX_LEN, NEW, _leaves, _t
from test_torch_experts_serving import _cb_streams
from test_torch_moe import _cfgs

GROUP = 16  # the einsum arm's group: every row count below is a multiple
# uid -> prompt length: ragged, but two lengths, so that JAX's engine
# (exact-length admission for an MoE config) compiles two prefills
CB_PROMPTS = {0: 5, 1: 3, 2: 5, 3: 3, 4: 5}


@functools.cache
def _export(arm: str):
    jcfg, cfg = _cfgs(moe_dispatch=arm, moe_group_size=GROUP)
    params, axes = japi.init_model(jax.random.PRNGKey(11), jcfg)
    qparams, _ = jquantize(params, axes, jcfg, packed=True)
    return arm, jcfg, cfg, params, qparams, _t(qparams)


@pytest.fixture(scope="module", params=["sort", "einsum"])
def served(request):
    return _export(request.param)


def test_packed_export_equals_jax_leaf_for_leaf(served):
    """Integers and scales exactly JAX's: the expert stacks packed per
    (layer, expert) slice, the router float, the shared FFN as an N = 1
    decoupled FFN (packed trunk, int8 branch)."""
    _, _, cfg, params, qparams, _ = served
    mine = params_to_numpy(quantize_params_for_serving(_t(params), cfg, packed=True))
    for (pa, a), (pb, b) in zip(_leaves(mine), _leaves(jax.tree.map(np.asarray, qparams)),
                                strict=True):
        name = jax.tree_util.keystr(pa)
        assert name == jax.tree_util.keystr(pb)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=name)
    ffn = mine["segments"][1]["b0"]["ffn"]
    n_moe, e, d = cfg.n_layers - cfg.first_k_dense, cfg.n_routed_experts, cfg.d_model
    de, r = cfg.d_ff_expert, cfg.quant.r
    assert ffn["we_up"]["packed"].shape == (n_moe, e, d // 8, de)
    assert ffn["we_down"]["packed"].shape == (n_moe, e, de // 8, d)
    assert ffn["we_gate"]["scale"].shape == (n_moe, e, 1, 1)
    assert ffn["router"]["w"].dtype == np.float32 and ffn["router"]["w"].shape == (n_moe, d, e)
    assert ffn["shared"]["w1_up"]["packed"].shape == (n_moe, d // 8, cfg.n_shared_experts * de)
    assert ffn["shared"]["w8_up"]["q"].shape == (n_moe, 1, d, r)
    assert mine["segments"][0]["b0"]["ffn"]["w1_down"]["packed"].shape == (cfg.d_ff // 8, d)


def test_packed_forward_chunk_matches_jax(served):
    """forward_chunk logits on the packed export at 3 x 16 = 48 rows: the
    attention and shared linears at the prefill tier, the experts' buffers
    (at most 24 rows a slice) at the decode tier; the einsum arm in three
    groups of 16."""
    _, jcfg, cfg, _, qparams, tq = served
    b, s = 3, GROUP
    toks = np.random.default_rng(21).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jcache, _ = japi.init_cache(jcfg, b, s, jnp.float32)
    fwd = jax.jit(lambda p, t, c: japi.forward_chunk(p, t, c, jnp.asarray(0, jnp.int32), jcfg))
    jl, _ = fwd(qparams, jnp.asarray(toks), jcache)
    tl, _ = api.forward_chunk(tq, torch.from_numpy(toks).long(),
                              api.init_cache(cfg, b, s, torch.float32, device=CPU), 0, cfg)
    err = np.abs(tl.numpy() - np.asarray(jl))
    assert err.max() <= ATOL_FLIP and np.median(err) <= ATOL, err.max()


def test_packed_moe_takes_upstreams_route(served, monkeypatch):
    """One MoE layer on the packed export: ``bit_linear_infer`` once per
    expert slice and linear (3 E), then the shared experts' fused pair
    twice, their int8 down projection and 1-bit down projection once."""
    arm, _, cfg, _, _, tq = served
    calls = []
    for name in ("bit_linear_infer", "decoupled_first_gemm", "int8_linear_infer"):
        orig = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _o=orig, _n=name, **k: (calls.append(_n),
                                                                          _o(*a, **k))[1])
    layer = tq["segments"][1]["b0"]["ffn"]
    one = jax.tree.map(lambda t: t[0], layer)
    assert moe._experts_packed(one, True)
    x = torch.randn(GROUP, cfg.d_model, generator=torch.Generator().manual_seed(0))
    y, aux = moe.moe_ffn(one, x, cfg)
    e = cfg.n_routed_experts
    assert calls == ["bit_linear_infer"] * (3 * e) + ["decoupled_first_gemm"] * 2 + [
        "int8_linear_infer", "bit_linear_infer"]
    assert torch.isfinite(y).all() and aux > 0


def test_decode_engine_greedy_streams_equal_jax():
    """The sort arm (the engines call the same forward in either arm),
    prompts of 2 x 8."""
    _, jcfg, cfg, _, qparams, tq = _export("sort")
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    want = JaxEngine(qparams, jcfg, max_len=MAX_LEN).generate(
        jnp.asarray(prompts), JaxSampler(temperature=0.0, top_k=0, max_new_tokens=NEW))
    eng = DecodeEngine(tq, cfg, max_len=MAX_LEN, device=CPU)
    _cuda.reset_launches()
    got = eng.generate(prompts, SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=NEW))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert eng.host_transfers == 1 and sum(_cuda.LAUNCHES.values()) == 0


@pytest.fixture(scope="module")
def jax_cb():
    """The JAX ContinuousBatchingEngine's streams on the export (3 slots,
    so that requests queue and slots go idle), paged: capacity couples the
    rows routed together, so the reference is JAX's own continuous
    batcher.  The sort arm (the einsum arm's engine is held by the
    DecodeEngine test)."""
    _, jcfg, cfg, _, qparams, _ = _export("sort")
    eng = JaxCB(qparams, jcfg, 3, MAX_LEN, JaxSampler(temperature=0.0, top_k=0, max_new_tokens=NEW),
                layout="paged", block_size=8, chunk=4)
    return _cb_streams(eng, CB_PROMPTS, cfg.vocab_size, jnp.asarray)



@pytest.mark.parametrize("env", ["auto", "1"])
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_continuous_batching_streams_equal_jax(jax_cb, monkeypatch, layout, env):
    """Greedy streams of the port's continuous batcher against JAX's, both
    layouts, the paged kernel route on and off; chunked and bucketed
    admission prefill are declined for an MoE config (one-shot admission
    at exact length)."""
    _, _, cfg, _, _, tq = _export("sort")
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


@pytest.mark.parametrize("t", [1, 64, 128])
def test_paged_attention_plans_fit_at_head_dim_128(t):
    """deepseek-moe-16b's paged shapes (16 heads of 128): every plan's
    layout fits a block's shared memory in f32 and bf16 pools; the tile
    route (32+ query rows) halves its splits until it does (8 merge slots
    of 64 x 130 floats would need 340 KB)."""
    for b, mb in ((4, 10), (16, 32), (1, 128)):
        plan = paged_attention_plan(b, t, 16, 16, 128, mb)
        assert plan.route == ("tile" if t >= 32 else "split") and 1 <= plan.splits <= 8
        for elem in (4, 2):
            assert smem_bytes(plan, 128, 16, elem, mb) <= _MAX_SMEM, (b, t, mb, plan, elem)
    # [13] (d)'s pool (4 slots of 10 blocks): the grid rule asks 8 splits
    # of a 64-row slice, the layout takes 4
    plan = paged_attention_plan(4, 64, 16, 16, 128, 10)
    assert plan == ("tile", 64, 4)
    assert smem_bytes(plan._replace(splits=8), 128, 16, 4, 10) > _MAX_SMEM
