"""The RG-LRU hybrid served by the port, against the JAX package on the
CPU: the packed export of ``registry.reduced`` recurrentgemma-2b (made in
JAX, converted leaf for leaf), ``forward_chunk`` from a prefill past the
window, and the greedy streams of ``DecodeEngine`` and
``ContinuousBatchingEngine``.

Exports exact (integers) or within rtol 1e-6 (scales); the RG-LRU gates,
Lambda and conv float.  Logits within ATOL_FLIP and in the median within
ATOL (an act-quant code can round either way between two frameworks);
the caches (RG-LRU state and conv tail, attention rings) within 1e-4;
streams token for token.  From a random init the reduced model's greedy
streams mostly repeat one token, so every stream test also holds the
logits each step of the stream computes: a prefill of the prompt and one
decode step for each streamed token, in both packages, within the
logits' tolerances (``_teacher_forced``).  The hybrid keeps only dense
caches in both layouts (every attention layer is windowed: a ring);
chunked admission and the prefix cache are declined, each with one log
line a config, as upstream's; admission is one-shot and exact-length in
both packages.
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
from repro_torch.models import api, rglru, transformer
from repro_torch.serve import ContinuousBatchingEngine, DecodeEngine, SamplerConfig, scheduler
from repro_torch.train.quantized_serving import quantize_params_for_serving
from test_torch_experts import ATOL, ATOL_FLIP, CPU, NEW, _leaves, _t
from test_torch_experts_serving import _cb_streams
from test_torch_rglru import _cfgs, _x
from test_torch_train import _torch_one_thread  # noqa: F401  (autouse)

MAX_LEN = 40
PROMPT = 21  # past the reduced window of 16: every ring wraps in the prefill
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


@functools.cache
def _jax_steps():
    """JAX's prefill and decode step on the export, jitted once each."""
    jcfg, _, _, qparams, _ = _export()
    prefill = jax.jit(lambda t: japi.prefill(qparams, {"tokens": t}, jcfg, MAX_LEN))
    step = jax.jit(lambda t, c, p: japi.decode_step(qparams, t, c, p, jcfg))
    return prefill, step


def _greedy(cls=SamplerConfig):
    return cls(temperature=0.0, top_k=0, max_new_tokens=NEW)


def _logits_close(got, want):
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert err.max() <= ATOL_FLIP and np.median(err) <= ATOL, err.max()


def _teacher_forced(prompts, streams):
    """The logits a greedy stream was sampled from, in both packages: a
    prefill of ``prompts`` (B, S) and a decode step for each of the
    streamed tokens but the last, fed the stream.  Each step's logits are
    held across the packages; each package's argmax is the stream's next
    token.  Returns the steps checked."""
    _, cfg, _, _, tq = _export()
    jprefill, jstep = _jax_steps()
    s = prompts.shape[1]
    jl, jc = jprefill(jnp.asarray(prompts))
    tl, tc = api.prefill(tq, {"tokens": torch.from_numpy(prompts).long()}, cfg, MAX_LEN)
    for i in range(streams.shape[1]):
        _logits_close(tl.numpy(), jl)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), streams[:, i])
        np.testing.assert_array_equal(np.asarray(jl).argmax(-1), streams[:, i])
        if i == streams.shape[1] - 1:
            break
        tok = streams[:, i:i + 1].astype(np.int32)
        jl, jc = jstep(jnp.asarray(tok), jc, jnp.asarray(s + i, jnp.int32))
        jl = jl[:, 0]
        tl, tc = api.decode_step(tq, torch.from_numpy(tok).long(), tc, s + i, cfg)
        tl = tl[:, 0]
    return streams.shape[1]


def test_packed_export_equals_jax_leaf_for_leaf():
    """Integers and scales JAX's; ``wx``, ``wy`` and ``wout`` packed (the
    attention's q/k/v/o and the FFN's trunk too), the RG-LRU gates ``wa``,
    ``wi``, ``lam`` and ``conv_*`` f32 as the latents are, bit for bit."""
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
    d, w = cfg.d_model, cfg.lru_width
    latent = jax.tree.map(np.asarray, params)
    for si, bi in ((0, "b0"), (0, "b1"), (1, "b0")):
        mixer = mine["segments"][si][bi]["mixer"]
        for name, k, n in (("wx", d, w), ("wy", d, w), ("wout", w, d)):
            assert mixer[name]["w"]["packed"].shape == (k // 8, n), name
            assert mixer[name]["w"]["packed"].dtype == np.uint8, name
        for name in ("wa", "wi"):
            assert mixer[name]["w"].dtype == np.float32, name
            np.testing.assert_array_equal(
                mixer[name]["w"], latent["segments"][si][bi]["mixer"][name]["w"])
        for name in ("lam", "conv_w", "conv_b"):
            assert mixer[name].dtype == np.float32, name
            np.testing.assert_array_equal(mixer[name],
                                          latent["segments"][si][bi]["mixer"][name])
    attn = mine["segments"][0]["b2"]["mixer"]
    assert attn["wk"]["w"]["packed"].shape == (d // 8, cfg.head_dim)


def test_packed_forward_chunk_matches_jax():
    """A 21-token prefill (every ring wraps), then a 6-token chunk from its
    cache: logits against JAX's same two calls; the caches after them
    (RG-LRU state and conv tail, the rings) JAX's within 1e-4;
    ``logits_at`` the chunk's row."""
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
        _logits_close(got.numpy(), want)
    names = []
    for (path, a), (_, b) in zip(_leaves(c), _leaves(jc), strict=True):
        names.append(jax.tree_util.keystr(path).split("'")[-2])
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    assert sorted(set(names)) == ["conv", "h", "k", "v"]
    assert c[0]["b2"]["k"].shape[1] == cfg.window_size
    _, c2 = api.prefill(tq, {"tokens": tt[:, :PROMPT]}, cfg, MAX_LEN)
    at, _ = api.forward_chunk(tq, tt[:, PROMPT:], c2, PROMPT, cfg,
                              logits_at=torch.tensor([5, 0, 3]))
    np.testing.assert_array_equal(at.numpy(),
                                  t2[torch.arange(3), torch.tensor([5, 0, 3])].numpy())


def test_decode_engine_greedy_streams_equal_jax():
    """Prompts of 3 x 21, token for token JAX's streams, each step's
    logits held to JAX's (``_teacher_forced``); one transfer a generate,
    no kernel launched on the CPU."""
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
    assert _teacher_forced(prompts, np.asarray(got)) == NEW


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
    the config however many engines are built; streams token for token;
    each request's logits held along its stream (``_teacher_forced``, at
    batch 1: the rows of a dense config do not couple)."""
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
    if layout == "paged":  # the logits once: the dense layout's streams are the same
        for uid in (0, 1):
            prompt = np.random.default_rng(uid + 10).integers(
                0, cfg.vocab_size, CB_PROMPTS[uid]).astype(np.int32)
            assert _teacher_forced(prompt[None], got[uid][None]) == NEW


def test_chunk_equals_decode_steps():
    """In the port, the first layer's packed RG-LRU mixer: one 6-token
    chunk from a cache of noise against 6 decode steps from the same
    cache: the conv tails bit for bit, the states and outputs within ATOL
    (the same recurrence in another float association)."""
    _, cfg, _, _, tq = _export()
    cfg = dataclasses.replace(cfg, dtype="float32")
    mp = tq["segments"][0]["b0"]["mixer"]
    x = torch.from_numpy(_x((3, 6, cfg.d_model), 30))
    chunked = rglru.init_rglru_cache(cfg, 3, torch.float32)
    for i, t in enumerate(chunked.values()):
        t.copy_(torch.from_numpy(_x(tuple(t.shape), 31 + i)))
    stepped = {k: v.clone() for k, v in chunked.items()}
    y, _ = transformer._recurrent_chunk(mp, x, chunked, cfg, mixer="rec")
    for i in range(6):
        yi, _ = transformer._recurrent_chunk(mp, x[:, i:i + 1], stepped, cfg, mixer="rec")
        np.testing.assert_allclose(yi[:, 0].numpy(), y[:, i].numpy(), rtol=0, atol=ATOL)
    assert torch.equal(chunked["conv"], stepped["conv"])
    np.testing.assert_allclose(chunked["h"].numpy(), stepped["h"].numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("layers", [4, 7])
def test_install_copies_the_recurrent_state_and_the_rings(layers):
    """``scheduler._install`` puts a batch-1 prefill's RG-LRU state, conv
    tails and rings into one slot of the engine's paged-layout cache
    (every block of both segments: the reduced plan's one repeat, and at
    7 layers a stacked segment of two) and touches no other slot."""
    _, cfg = _cfgs(dtype="float32", n_layers=layers)
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
        kinds.append((stacked,) + tuple(sorted(bc)))
        for name in bc:
            got, other = ((bc[name][:, 1], bc[name][:, [0, 2]]) if stacked
                          else (bc[name][1], bc[name][[0, 2]]))
            assert torch.equal(got, sc[name][:, 0] if stacked else sc[name][0]), name
            assert not other.any(), name
    stacked = layers > 4
    assert kinds == [(stacked, "conv", "h"), (stacked, "conv", "h"), (stacked, "k", "v"),
                     (False, "conv", "h")]
