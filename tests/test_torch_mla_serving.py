"""MLA served by the port, against the JAX package on the CPU: the packed
export of ``registry.reduced`` deepseek-v2-236b (MLA over a MoE; made in
JAX, converted leaf for leaf) and of ``tests/test_serving.py``'s non-MoE
MLA config (``_mla_cfg``: 3 layers, d_model 32, q_lora 16, kv_lora 8).

Exports exact (integers) or within rtol 1e-6 (scales), the norms of MLA
(``q_norm``, ``kv_norm``, ``subln``) float; logits within ATOL_FLIP and in
the median within ATOL; greedy streams token for token.  The latent cache
``{"ckv", "krope"}`` stays dense in both layouts: in the paged layout no
layer is on the pool (only the allocator's bookkeeping runs), so the
paged-attention route has nothing to walk.  Capacity couples the rows
routed together, so deepseek-v2's continuous batcher is held to JAX's
continuous batcher (as ``tests/test_torch_moe_serving.py``); the non-MoE
config takes chunked and bucketed admission in both packages, and its
chunked streams equal its one-shot streams.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core.quantization import QuantConfig as JQuantConfig
from repro.models import api as japi
from repro.serve import scheduler as jscheduler
from repro.serve.engine import DecodeEngine as JaxEngine
from repro.serve.engine import SamplerConfig as JaxSampler
from repro.serve.scheduler import ContinuousBatchingEngine as JaxCB
from repro.train.quantized_serving import quantize_params_for_serving as jquantize
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_to_numpy
from repro_torch.core.quantization import QuantConfig
from repro_torch.kernels import _cuda
from repro_torch.models import api
from repro_torch.serve import ContinuousBatchingEngine, DecodeEngine, SamplerConfig, scheduler
from repro_torch.train.quantized_serving import quantize_params_for_serving
from test_torch_experts import ATOL, ATOL_FLIP, CPU, MAX_LEN, NEW, _leaves, _t
from test_torch_experts_serving import _cb_streams
from test_torch_mla import _cfgs
from test_torch_train import _torch_one_thread  # noqa: F401  (autouse)

# uid -> prompt length: ragged, but two lengths, so that JAX's engine
# (exact-length admission for an MoE config) compiles two prefills
CB_PROMPTS = {0: 5, 1: 3, 2: 5, 3: 3, 4: 5}
MLA_PROMPTS = {0: 7, 1: 3, 2: 9, 3: 5, 4: 6}  # the non-MoE config's, ragged


def _mla_cfg(cls, qcls):
    """``tests/test_serving.py``'s non-MoE MLA config in either package."""
    return cls(name="t3", family="decoder", n_layers=3, d_model=32, n_heads=4, n_kv_heads=4,
               d_ff=48, vocab_size=64, quant=qcls(mode="pquant", r=16, num_experts=1),
               attn_type="mla", q_lora_rank=16, kv_lora_rank=8, qk_nope_dim=8,
               qk_rope_dim=4, v_head_dim=8)


@functools.cache
def _export(arch: str):
    """JAX's latent params and packed export, each one compiled call (op
    by op they took most of this module's time)."""
    if arch == "mla":
        jcfg = _mla_cfg(JModelConfig, JQuantConfig)
        cfg = _mla_cfg(ModelConfig, QuantConfig)
    else:
        jcfg, cfg = _cfgs()
    axes = {}

    def init(key):
        params, axes["tree"] = japi.init_model(key, jcfg)
        return params

    params = jax.jit(init)(jax.random.PRNGKey(11))
    qparams = jax.jit(lambda p: jquantize(p, axes["tree"], jcfg, packed=True)[0])(params)
    return jcfg, cfg, params, qparams, _t(qparams)


def _greedy(cls=SamplerConfig):
    return cls(temperature=0.0, top_k=0, max_new_tokens=NEW)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "mla"])
def test_packed_export_equals_jax_leaf_for_leaf(arch):
    """Integers and scales exactly JAX's; every MLA projection packed
    (deepseek-v2's stacked over its MoE layers), its norms float."""
    _, cfg, params, qparams, _ = _export(arch)
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
    mixer = mine["segments"][-1]["b0"]["mixer"]
    lead = mixer["wq_down"]["w"]["packed"].shape[:-2]
    assert lead == ((cfg.n_layers - 1,) if cfg.moe else (cfg.n_layers,))
    nh = cfg.n_heads
    for name, k, n in (("wq_down", cfg.d_model, cfg.q_lora_rank),
                       ("wq_up", cfg.q_lora_rank, nh * (cfg.qk_nope_dim + cfg.qk_rope_dim)),
                       ("wkv_down", cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_dim),
                       ("wkv_up", cfg.kv_lora_rank, nh * (cfg.qk_nope_dim + cfg.v_head_dim)),
                       ("wo", nh * cfg.v_head_dim, cfg.d_model)):
        assert mixer[name]["w"]["packed"].shape == lead + (k // 8, n), name
    for name in ("q_norm", "kv_norm", "subln"):
        assert mixer[name]["scale"].dtype == np.float32, name


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "mla"])
def test_packed_forward_chunk_matches_jax(arch):
    """A 10-token prefill, then a 6-token ``forward_chunk`` from its
    latent cache: logits against JAX's same two calls; the latent caches
    after them JAX's; ``logits_at`` the chunk's row."""
    jcfg, cfg, _, qparams, tq = _export(arch)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 16)).astype(np.int32)

    def jax_both(q, head, tail):  # one compile for the two calls
        _, c = japi.prefill(q, {"tokens": head}, jcfg, MAX_LEN)
        return japi.forward_chunk(q, tail, c, jnp.asarray(10, jnp.int32), jcfg)

    jl, jc = jax.jit(jax_both)(qparams, jnp.asarray(toks[:, :10]), jnp.asarray(toks[:, 10:]))
    tt = torch.from_numpy(toks).long()
    _, c = api.prefill(tq, {"tokens": tt[:, :10]}, cfg, MAX_LEN)
    tl, c = api.forward_chunk(tq, tt[:, 10:], c, 10, cfg)
    err = np.abs(tl.numpy() - np.asarray(jl))
    assert err.max() <= ATOL_FLIP and np.median(err) <= ATOL, err.max()
    for (path, a), (_, b) in zip(_leaves(c), _leaves(jc), strict=True):
        assert jax.tree_util.keystr(path).endswith(("'ckv']", "'krope']"))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    _, c2 = api.prefill(tq, {"tokens": tt[:, :10]}, cfg, MAX_LEN)
    at, _ = api.forward_chunk(tq, tt[:, 10:], c2, 10, cfg, logits_at=torch.tensor([5, 0, 3]))
    np.testing.assert_allclose(at.numpy(), tl[torch.arange(3), torch.tensor([5, 0, 3])].numpy(),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "mla"])
def test_decode_engine_greedy_streams_equal_jax(arch):
    """Prompts of 3 x 8, token for token JAX's streams; one transfer a
    generate, no kernel launched on the CPU."""
    jcfg, cfg, _, qparams, tq = _export(arch)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)
    want = JaxEngine(qparams, jcfg, max_len=MAX_LEN).generate(jnp.asarray(prompts),
                                                              _greedy(JaxSampler))
    eng = DecodeEngine(tq, cfg, max_len=MAX_LEN, device=CPU)
    _cuda.reset_launches()
    got = eng.generate(prompts, _greedy())
    np.testing.assert_array_equal(got, np.asarray(want))
    assert eng.host_transfers == 1 and sum(_cuda.LAUNCHES.values()) == 0


def _on_pool(cfg, eng) -> int:
    return sum(1 for _, c in scheduler._cache_dicts(cfg, eng._caches) if "table" in c)


@pytest.fixture(scope="module")
def jax_cb():
    """JAX's continuous batcher on deepseek-v2's export (3 slots, so that
    requests queue and slots go idle), paged."""
    jcfg, cfg, _, qparams, _ = _export("deepseek-v2-236b")
    eng = JaxCB(qparams, jcfg, 3, MAX_LEN, _greedy(JaxSampler), layout="paged", block_size=8,
                chunk=4)
    return _cb_streams(eng, CB_PROMPTS, cfg.vocab_size, jnp.asarray)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_continuous_batching_streams_equal_jax(jax_cb, layout):
    """deepseek-v2's greedy streams through the port's continuous batcher
    against JAX's, both layouts (the paged one with no layer on the pool:
    the allocator's blocks come back); chunked and bucketed admission are
    declined for an MoE config."""
    _, cfg, _, _, tq = _export("deepseek-v2-236b")
    eng = ContinuousBatchingEngine(tq, cfg, 3, MAX_LEN, _greedy(), layout=layout, block_size=8,
                                   chunk=4, prefill_chunk=4, device=CPU)
    assert eng.prefill_chunk is None and eng._prefill_bucketed is None
    assert _on_pool(cfg, eng) == 0 and (eng.allocator is not None) == (layout == "paged")
    _cuda.reset_launches()
    got = _cb_streams(eng, CB_PROMPTS, cfg.vocab_size, lambda p: p)
    assert sorted(got) == sorted(jax_cb)
    for uid, toks in got.items():
        np.testing.assert_array_equal(toks, jax_cb[uid], err_msg=str(uid))
    assert sum(_cuda.LAUNCHES.values()) == 0
    if eng.allocator is not None:
        assert eng.allocator.free_count == eng.num_blocks


@functools.cache
def _mla_jax_streams(prefill_chunk) -> dict:
    jcfg, cfg, _, qparams, _ = _export("mla")
    eng = JaxCB(qparams, jcfg, 2, MAX_LEN, _greedy(JaxSampler), layout="paged", block_size=8,
                chunk=4, prefill_chunk=prefill_chunk)
    return _cb_streams(eng, MLA_PROMPTS, cfg.vocab_size, jnp.asarray)


def test_mla_chunked_admission_equals_one_shot_in_jax():
    """The JAX package's claim (its ``_chunked_prefill_safe`` lists MLA),
    held: slices of 4 give its one-shot streams; both gates take MLA."""
    jcfg, _, _, _, _ = _export("mla")
    assert jscheduler._chunked_prefill_safe(jcfg)
    assert jscheduler._bucketed_prefill_safe(jcfg, MAX_LEN)
    one = _mla_jax_streams(None)
    chunked = _mla_jax_streams(4)
    assert sorted(one) == sorted(chunked) == sorted(MLA_PROMPTS)
    for uid in one:
        np.testing.assert_array_equal(chunked[uid], one[uid], err_msg=str(uid))


@pytest.mark.parametrize("prefill_chunk", [None, 4])
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_mla_continuous_batching_chunked_equals_one_shot(layout, prefill_chunk):
    """The non-MoE MLA config through the port's continuous batcher (2
    slots): one-shot admission (bucketed: MLA takes the buckets) and
    chunked in slices of 4, both layouts, every stream token for token
    JAX's one-shot stream; no layer on the pool; the pool drains."""
    _, cfg, _, _, tq = _export("mla")
    assert scheduler._chunked_prefill_safe(cfg) and scheduler._bucketed_prefill_safe(cfg, MAX_LEN)
    eng = ContinuousBatchingEngine(tq, cfg, 2, MAX_LEN, _greedy(), layout=layout, block_size=8,
                                   chunk=4, prefill_chunk=prefill_chunk, device=CPU)
    assert eng.prefill_chunk == prefill_chunk and eng._prefill_bucketed is not None
    assert _on_pool(cfg, eng) == 0
    got = _cb_streams(eng, MLA_PROMPTS, cfg.vocab_size, lambda p: p)
    want = _mla_jax_streams(None)
    assert sorted(got) == sorted(want)
    for uid, toks in got.items():
        np.testing.assert_array_equal(toks, want[uid], err_msg=str(uid))
    if eng.allocator is not None:
        assert eng.allocator.free_count == eng.num_blocks


def test_install_copies_the_latent_rows():
    """``scheduler._install`` puts a batch-1 prefill's latent cache into
    one slot of the engine's paged-layout cache as it is (``ckv`` and
    ``krope`` of the unstacked dense layer and of every layer of the
    stacked MoE segment) and touches no other slot."""
    _, cfg = _cfgs(dtype="float32")
    big = api.init_cache(cfg, 3, 16, torch.float32, device=CPU, layout="paged", block_size=8)
    small = api.init_cache(cfg, 1, 16, torch.float32, device=CPU)
    gen = torch.Generator().manual_seed(0)
    for _, c in scheduler._cache_dicts(cfg, small):
        for t in c.values():
            t.copy_(torch.randn(t.shape, generator=gen))
    scheduler._install(cfg, big, small, 1, None, 0)
    kinds = []
    for (stacked, bc), (_, sc) in zip(scheduler._cache_dicts(cfg, big),
                                      scheduler._cache_dicts(cfg, small), strict=True):
        assert sorted(bc) == ["ckv", "krope"]
        kinds.append(stacked)
        for name in bc:
            row, others = ((bc[name][:, 1], bc[name][:, [0, 2]]) if stacked
                           else (bc[name][1], bc[name][[0, 2]]))
            assert torch.equal(row, sc[name][:, 0] if stacked else sc[name][0]), name
            assert not others.any(), name
    assert kinds == [False, True]
