"""Mamba-2 served by the port, against the JAX package on the CPU: the
packed export of ``registry.reduced`` mamba2-780m (made in JAX, converted
leaf for leaf), ``forward_chunk`` from a prefill whose prompt ends in a
padded chunk tail, and the greedy streams of ``DecodeEngine`` and
``ContinuousBatchingEngine``.

Exports exact (integers) or within rtol 1e-6 (scales); the conv, SSD and
gate parameters float.  Logits within ATOL_FLIP and in the median within
ATOL (an act-quant code can round either way between two frameworks);
the recurrent caches within 1e-4; streams token for token.  The SSM cache
{"conv", "state"} stays dense in both layouts: in the paged layout no
layer is on the pool (only the allocator's bookkeeping runs).  Chunked
admission and the prefix cache are declined for a recurrent config, each
with one log line a config, as upstream's; admission is one-shot and
exact-length in both packages.
"""

import dataclasses
import functools
import logging

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
from repro_torch.kernels import _cuda
from repro_torch.models import api, ssm, transformer
from repro_torch.serve import ContinuousBatchingEngine, DecodeEngine, SamplerConfig, scheduler
from repro_torch.train.quantized_serving import quantize_params_for_serving
from test_torch_experts import ATOL, ATOL_FLIP, CPU, NEW, _leaves, _t
from test_torch_experts_serving import _cb_streams
from test_torch_ssm import _cfgs, _x
from test_torch_train import _torch_one_thread  # noqa: F401  (autouse)

MAX_LEN = 40
PROMPT = 21  # past one chunk of 16: a padded tail
# uid -> prompt length: two lengths, so that JAX's engine (exact-length
# admission for a recurrent config) compiles two prefills
CB_PROMPTS = {0: 21, 1: 5, 2: 21, 3: 5, 4: 21}


@functools.cache
def _export():
    """JAX's latent params and packed export, each one compiled call."""
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


def test_packed_export_equals_jax_leaf_for_leaf():
    """Integers and scales JAX's; both projections' trunks packed and
    their bottlenecks int8 (one expert), stacked over the layers; the conv,
    SSD and gate parameters float."""
    _, cfg, params, qparams, _ = _export()
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
    mixer = mine["segments"][0]["b0"]["mixer"]
    d_in, _, _, proj_out = ssm._dims(cfg)
    L, r = cfg.n_layers, cfg.quant.r
    for name, k, n in (("in_proj", cfg.d_model, proj_out), ("out_proj", d_in, cfg.d_model)):
        assert mixer[name]["w1"]["packed"].shape == (L, k // 8, n), name
        assert mixer[name]["w8_a"]["q"].shape == (L, 1, k, r), name
        assert mixer[name]["w8_b"]["q"].shape == (L, 1, r, n), name
    for name in ("conv_w", "conv_b", "A_log", "D", "dt_bias"):
        assert mixer[name].dtype == np.float32, name
    assert mixer["gate_norm"]["scale"].dtype == np.float32


def test_packed_forward_chunk_matches_jax():
    """A 21-token prefill (16 + a padded 5), then a 6-token chunk from its
    cache: logits against JAX's same two calls; the caches after them
    JAX's within 1e-4; ``logits_at`` the chunk's row.  (One-token steps
    from the cache: the ``DecodeEngine`` streams below.)"""
    jcfg, cfg, _, qparams, tq = _export()
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 27)).astype(np.int32)

    def jax_calls(q, head, tail):  # one compile for the two calls
        l1, c = japi.prefill(q, {"tokens": head}, jcfg, MAX_LEN)
        l2, c = japi.forward_chunk(q, tail, c, jnp.asarray(PROMPT, jnp.int32), jcfg)
        return (l1, l2), c

    (j1, j2), jc = jax.jit(jax_calls)(qparams, jnp.asarray(toks[:, :PROMPT]),
                                      jnp.asarray(toks[:, PROMPT:]))
    tt = torch.from_numpy(toks).long()
    t1, c = api.prefill(tq, {"tokens": tt[:, :PROMPT]}, cfg, MAX_LEN)
    t2, c = api.forward_chunk(tq, tt[:, PROMPT:], c, PROMPT, cfg)
    for got, want in ((t1, j1), (t2, j2)):
        err = np.abs(got.numpy() - np.asarray(want))
        assert err.max() <= ATOL_FLIP and np.median(err) <= ATOL, err.max()
    for (path, a), (_, b) in zip(_leaves(c), _leaves(jc), strict=True):
        assert jax.tree_util.keystr(path).endswith(("'conv']", "'state']"))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    _, c2 = api.prefill(tq, {"tokens": tt[:, :PROMPT]}, cfg, MAX_LEN)
    at, _ = api.forward_chunk(tq, tt[:, PROMPT:], c2, PROMPT, cfg,
                              logits_at=torch.tensor([5, 0, 3]))
    np.testing.assert_array_equal(at.numpy(),
                                  t2[torch.arange(3), torch.tensor([5, 0, 3])].numpy())


def test_decode_engine_greedy_streams_equal_jax():
    """Prompts of 3 x 21, token for token JAX's streams; one transfer a
    generate, no kernel launched on the CPU."""
    jcfg, cfg, _, qparams, tq = _export()
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                                (3, PROMPT)).astype(np.int32)
    want = JaxEngine(qparams, jcfg, max_len=MAX_LEN).generate(jnp.asarray(prompts),
                                                              _greedy(JaxSampler))
    eng = DecodeEngine(tq, cfg, max_len=MAX_LEN, device=CPU)
    _cuda.reset_launches()
    got = eng.generate(prompts, _greedy())
    np.testing.assert_array_equal(got, np.asarray(want))
    assert eng.host_transfers == 1 and sum(_cuda.LAUNCHES.values()) == 0


@pytest.fixture(scope="module")
def jax_cb():
    """JAX's continuous batcher on the export (3 slots, so that requests
    queue and slots go idle), paged."""
    jcfg, cfg, _, qparams, _ = _export()
    eng = JaxCB(qparams, jcfg, 3, MAX_LEN, _greedy(JaxSampler), layout="paged", block_size=8,
                chunk=4)
    return _cb_streams(eng, CB_PROMPTS, cfg.vocab_size, jnp.asarray)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_continuous_batching_streams_equal_jax(jax_cb, layout, caplog):
    """The port's continuous batcher against JAX's, both layouts (no layer
    on the pool: the allocator's blocks come back): chunked admission and
    (paged) the prefix cache requested and declined, each logged once for
    the config however many engines are built; streams token for token."""
    _, cfg, _, _, tq = _export()
    scheduler._CHUNK_DECLINE_LOGGED.clear()
    scheduler._PREFIX_DECLINE_LOGGED.clear()
    with caplog.at_level(logging.WARNING, logger="repro_torch.serve.scheduler"):
        for _ in range(2):
            eng = ContinuousBatchingEngine(tq, cfg, 3, MAX_LEN, _greedy(), layout=layout,
                                           block_size=8, chunk=4, prefill_chunk=4,
                                           prefix_cache=layout == "paged", device=CPU)
    lines = [r.getMessage() for r in caplog.records]
    assert len([m for m in lines if "chunked admission prefill declined" in m]) == 1
    assert len([m for m in lines if "prefix caching declined" in m]) == (layout == "paged")
    assert eng.prefill_chunk is None and eng._prefill_bucketed is None and not eng.prefix_cache
    assert not any("table" in c for _, c in scheduler._cache_dicts(cfg, eng._caches))
    _cuda.reset_launches()
    got = _cb_streams(eng, CB_PROMPTS, cfg.vocab_size, lambda p: p)
    assert sorted(got) == sorted(jax_cb)
    for uid, toks in got.items():
        np.testing.assert_array_equal(toks, jax_cb[uid], err_msg=str(uid))
    assert sum(_cuda.LAUNCHES.values()) == 0
    if eng.allocator is not None:
        assert eng.allocator.free_count == eng.num_blocks


def test_chunk_equals_decode_steps():
    """In the port, the first layer's packed mixer: one 6-token chunk from a
    cache of noise against 6 decode steps from the same cache: the conv
    tails bit for bit, the states and outputs within ATOL (the same
    recurrence in another float association)."""
    _, cfg, _, _, tq = _export()
    cfg = dataclasses.replace(cfg, dtype="float32")
    mp = transformer._seg_layers(transformer.build_segments(cfg)[0],
                                 tq["segments"][0])[0]["b0"]["mixer"]
    x = torch.from_numpy(_x((3, 6, cfg.d_model), 30))
    chunked = ssm.init_mamba_cache(cfg, 3, torch.float32)
    for i, t in enumerate(chunked.values()):
        t.copy_(torch.from_numpy(_x(tuple(t.shape), 31 + i)))
    stepped = {k: v.clone() for k, v in chunked.items()}
    y, _ = transformer._recurrent_chunk(mp, x, chunked, cfg)
    for i in range(6):
        yi, _ = transformer._recurrent_chunk(mp, x[:, i:i + 1], stepped, cfg)
        np.testing.assert_allclose(yi[:, 0].numpy(), y[:, i].numpy(), rtol=0, atol=ATOL)
    assert torch.equal(chunked["conv"], stepped["conv"])
    np.testing.assert_allclose(chunked["state"].numpy(), stepped["state"].numpy(), rtol=0,
                               atol=ATOL)


def test_install_copies_the_recurrent_state():
    """``scheduler._install`` puts a batch-1 prefill's conv tail and state
    into one slot of the engine's paged-layout cache (every layer of the
    stacked segment) and touches no other slot."""
    _, cfg = _cfgs(dtype="float32")
    big = api.init_cache(cfg, 3, 16, torch.float32, device=CPU, layout="paged", block_size=8)
    small = api.init_cache(cfg, 1, 16, torch.float32, device=CPU)
    gen = torch.Generator().manual_seed(0)
    for _, c in scheduler._cache_dicts(cfg, small):
        for t in c.values():
            t.copy_(torch.randn(t.shape, generator=gen))
    scheduler._install(cfg, big, small, 1, None, 0)
    for (stacked, bc), (_, sc) in zip(scheduler._cache_dicts(cfg, big),
                                      scheduler._cache_dicts(cfg, small), strict=True):
        assert stacked and sorted(bc) == ["conv", "state"]
        for name in bc:
            assert torch.equal(bc[name][:, 1], sc[name][:, 0]), name
            assert not bc[name][:, [0, 2]].any(), name
