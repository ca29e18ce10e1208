"""The encoder-decoder served by the port, against the JAX package on the
CPU: the packed export of ``registry.reduced`` whisper-large-v3 (made in
JAX, converted leaf for leaf), ``prefill`` and ``decode_step`` with the
self cache and the cross K/V, and the greedy streams of ``DecodeEngine``
with ``extra_inputs={"frames": ...}``, on packed and fake-quant weights.

Exports exact (integers) or within rtol 1e-6 (scales); ``dec_pos`` and the
tied embedding stay the latents bit for bit.  Logits within ATOL_FLIP and
in the median within ATOL (an act-quant code can round either way between
two frameworks, and the packed path's codes are not replayed); the caches
within CACHE_TOL.  From a random init the reduced model's greedy streams
mostly repeat one token, so the packed stream test also holds the logits
each step of the stream computes, in both packages (``_teacher_forced``).
Continuous batching, ``forward_chunk`` and the paged cache layout are
decoder-family only in both packages and raise.
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
from repro_torch.kernels import _cuda
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.serve import ContinuousBatchingEngine, DecodeEngine, SamplerConfig
from repro_torch.train.quantized_serving import quantize_params_for_serving
from repro_torch.train.serve import BatchedServer
from test_torch_encdec import _cfgs, _x
from test_torch_experts import ATOL, ATOL_FLIP, CPU, _leaves, _t
from test_torch_train import _torch_one_thread  # noqa: F401  (autouse)

MAX_LEN = 24
PROMPT, NEW = 4, 6
CACHE_TOL = 1e-4


@functools.cache
def _export():
    """JAX's latent params (f32) and packed export, each one compiled call,
    and the numpy-seeded prompts and frames of three requests."""
    jcfg, cfg = _cfgs(dtype="float32")
    axes = {}

    def init(key):
        params, axes["tree"] = japi.init_model(key, jcfg)
        return params

    params = jax.jit(init)(jax.random.PRNGKey(11))
    qparams = jax.jit(lambda p: jquantize(p, axes["tree"], jcfg, packed=True)[0])(params)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, PROMPT)).astype(np.int32)
    frames = _x((3, cfg.n_frontend_tokens, cfg.d_model), 6)
    return jcfg, cfg, params, qparams, _t(qparams), prompts, frames


@functools.cache
def _jax_steps():
    """JAX's prefill and decode step on the export, jitted once each."""
    jcfg, _, _, qparams, _, _, _ = _export()
    prefill = jax.jit(lambda b: japi.prefill(qparams, b, jcfg, MAX_LEN))
    step = jax.jit(lambda t, c, p: japi.decode_step(qparams, t, c, p, jcfg))
    return prefill, step


def _greedy(cls=SamplerConfig, new=NEW):
    return cls(temperature=0.0, top_k=0, max_new_tokens=new)


def _logits_close(got, want):
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert err.max() <= ATOL_FLIP and np.median(err) <= ATOL, err.max()


def _caches_close(got, want):
    names = []
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want), strict=True):
        name = jax.tree_util.keystr(path)
        names.append(name)
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=CACHE_TOL,
                                   err_msg=name)
    return names


def _tbatch(prompts, frames):
    return {"tokens": torch.from_numpy(prompts).long(), "frames": torch.from_numpy(frames)}


def _teacher_forced(prompts, frames, streams):
    """The logits a greedy stream was sampled from, in both packages: a
    prefill of ``prompts`` with ``frames`` and a decode step for each of
    the streamed tokens but the last, fed the stream.  Each step's logits
    are held across the packages; each package's argmax is the stream's
    next token.  Returns the steps checked."""
    _, cfg, _, _, tq, _, _ = _export()
    jprefill, jstep = _jax_steps()
    jl, jc = jprefill({"tokens": jnp.asarray(prompts), "frames": jnp.asarray(frames)})
    tl, tc = api.prefill(tq, _tbatch(prompts, frames), cfg, MAX_LEN)
    for i in range(streams.shape[1]):
        _logits_close(tl.numpy(), jl)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), streams[:, i])
        np.testing.assert_array_equal(np.asarray(jl).argmax(-1), streams[:, i])
        if i == streams.shape[1] - 1:
            break
        tok = streams[:, i:i + 1].astype(np.int32)
        jl, jc = jstep(jnp.asarray(tok), jc, jnp.asarray(PROMPT + i, jnp.int32))
        jl = jl[:, 0]
        tl, tc = api.decode_step(tq, torch.from_numpy(tok).long(), tc, PROMPT + i, cfg)
        tl = tl[:, 0]
    return streams.shape[1]


def test_packed_export_equals_jax_leaf_for_leaf():
    """Integers and scales JAX's; every attention projection (the encoder's,
    the decoder's self and cross) and the FFN's non-GLU ``w1_up`` /
    ``w1_down`` packed, stacked on the layer axis; ``dec_pos`` and the tied
    embedding the latents bit for bit."""
    _, cfg, params, qparams, _, _, _ = _export()
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
    d, f, r = cfg.d_model, cfg.d_ff, cfg.quant.r
    for stack, n, attns in (("encoder", cfg.n_enc_layers, ("attn",)),
                            ("decoder", cfg.n_layers, ("self_attn", "cross_attn"))):
        for a in attns:
            for w in ("wq", "wk", "wv", "wo"):
                assert mine[stack][a][w]["w"]["packed"].shape == (n, d // 8, d), (stack, a, w)
        ffn = mine[stack]["ffn"]
        assert "w1_gate" not in ffn and "w8_gate" not in ffn
        assert ffn["w1_up"]["packed"].shape == (n, d // 8, f)
        assert ffn["w1_down"]["packed"].shape == (n, f // 8, d)
        assert ffn["w8_up"]["q"].shape == (n, 1, d, r) and ffn["w8_up"]["q"].dtype == np.int8
    latent = jax.tree.map(np.asarray, params)
    for k in ("dec_pos", "embed"):
        for (_, a), (_, b) in zip(_leaves(mine[k]), _leaves(latent[k]), strict=True):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_prefill_logits_and_caches_match_jax():
    """The packed prefill of three requests (12 frames, 4 tokens) into a
    24-position cache: last-position logits and the four cache leaves
    (self ``k`` / ``v`` zero past the prompt, ``cross_k`` / ``cross_v``
    over the frames, all stacked over the 4 layers) against JAX's; with
    ``last_pos`` the logits of position ``last_pos - 1``."""
    jcfg, cfg, _, qparams, tq, prompts, frames = _export()
    jprefill, _ = _jax_steps()
    jbatch = {"tokens": jnp.asarray(prompts), "frames": jnp.asarray(frames)}
    jl, jc = jprefill(jbatch)
    tl, tc = api.prefill(tq, _tbatch(prompts, frames), cfg, MAX_LEN)
    _logits_close(tl.numpy(), jl)
    names = _caches_close(tc, jc)
    assert names == ["['cross_k']", "['cross_v']", "['self']['k']", "['self']['v']"]
    assert tuple(tc["cross_k"].shape) == (cfg.n_layers, 3, cfg.n_frontend_tokens,
                                          cfg.n_kv_heads, cfg.head_dim)
    assert tuple(tc["self"]["k"].shape)[:3] == (cfg.n_layers, 3, MAX_LEN)
    assert not tc["self"]["v"][:, :, PROMPT:].any()
    at, _ = api.prefill(tq, _tbatch(prompts, frames), cfg, MAX_LEN, last_pos=2)
    j2, _ = jax.jit(lambda b: japi.prefill(qparams, b, jcfg, MAX_LEN, last_pos=2))(jbatch)
    _logits_close(at.numpy(), j2)


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_step_matches_jax(per_slot):
    """One packed decode step after the prefill: at the scalar position 4,
    and at per-slot positions (4, 6, 5) with slot 1 inactive: logits and
    the caches against JAX's; the cross K/V carried bit for bit; the
    inactive slot's self cache unchanged; each active slot's self cache
    written at its own position (the learned position of each slot's
    own)."""
    jcfg, cfg, _, qparams, tq, prompts, frames = _export()
    jprefill, jstep = _jax_steps()
    _, jc = jprefill({"tokens": jnp.asarray(prompts), "frames": jnp.asarray(frames)})
    _, tc = api.prefill(tq, _tbatch(prompts, frames), cfg, MAX_LEN)
    before = adamw.tree_map(torch.clone, tc)
    tok = np.array([[7], [9], [11]], np.int32)
    if per_slot:
        pos, active = np.array([4, 6, 5], np.int32), np.array([True, False, True])
        jl, jc = jax.jit(lambda t, c, p, a: japi.decode_step(qparams, t, c, p, jcfg, a))(
            jnp.asarray(tok), jc, jnp.asarray(pos), jnp.asarray(active))
        tl, tc = api.decode_step(tq, torch.from_numpy(tok).long(), tc,
                                 torch.from_numpy(pos), cfg, torch.from_numpy(active))
    else:
        jl, jc = jstep(jnp.asarray(tok), jc, jnp.asarray(PROMPT, jnp.int32))
        tl, tc = api.decode_step(tq, torch.from_numpy(tok).long(), tc, PROMPT, cfg)
    assert tuple(tl.shape) == (3, 1, cfg.vocab_size)
    _logits_close(tl.numpy(), jl)
    _caches_close(tc, jc)
    for k in ("cross_k", "cross_v"):
        assert torch.equal(tc[k], before[k])
    k, k0 = tc["self"]["k"], before["self"]["k"]
    if per_slot:
        assert torch.equal(k[:, 1], k0[:, 1])
        for slot, p in ((0, 4), (2, 5)):
            assert k[:, slot, p].any() and torch.equal(k[:, slot, :p], k0[:, slot, :p])
    else:
        assert k[:, :, PROMPT].any() and torch.equal(k[:, :, :PROMPT], k0[:, :, :PROMPT])


@pytest.mark.parametrize("packed", [True, False])
def test_decode_engine_greedy_streams_equal_jax(packed):
    """``DecodeEngine.generate(prompts, scfg, extra_inputs={"frames": ...})``
    gives JAX's engine's streams token for token, on the packed export and
    on the fake-quant latents; one transfer a generate, no kernel launched
    on the CPU; on the export each step's logits are held to JAX's
    (``_teacher_forced``)."""
    jcfg, cfg, params, qparams, tq, prompts, frames = _export()
    jp, tp = (qparams, tq) if packed else (params, _t(params))
    want = JaxEngine(jp, jcfg, max_len=MAX_LEN).generate(
        jnp.asarray(prompts), _greedy(JaxSampler), extra_inputs={"frames": jnp.asarray(frames)})
    eng = DecodeEngine(tp, cfg, max_len=MAX_LEN, device=CPU)
    _cuda.reset_launches()
    got = eng.generate(prompts, _greedy(), extra_inputs={"frames": frames})
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.shape == (3, NEW)
    assert eng.host_transfers == 1 and sum(_cuda.LAUNCHES.values()) == 0
    if packed:
        assert _teacher_forced(prompts, frames, got) == NEW


def test_generate_stream_and_python_loop_equal_generate():
    """On the export: ``generate_stream`` (chunks of 2: one transfer a
    chunk) and ``BatchedServer.generate`` and ``generate_python_loop``
    (one transfer a token), all with the frames, each equal to
    ``DecodeEngine.generate``; without the frames the model cannot run."""
    _, cfg, _, _, tq, prompts, frames = _export()
    extra = {"frames": frames}
    eng = DecodeEngine(tq, cfg, max_len=MAX_LEN, device=CPU)
    full = eng.generate(prompts, _greedy(), extra_inputs=extra)
    parts = list(eng.generate_stream(prompts, _greedy(), extra_inputs=extra, chunk=2))
    np.testing.assert_array_equal(np.concatenate(parts, axis=1), full)
    assert eng.host_transfers == 1 + -(-(NEW - 1) // 2)
    server = BatchedServer(tq, cfg, MAX_LEN, device=CPU)
    np.testing.assert_array_equal(server.generate(prompts, _greedy(), extra), full)
    np.testing.assert_array_equal(server.generate_python_loop(prompts, _greedy(), extra), full)
    assert server.host_transfers == NEW
    with pytest.raises(KeyError, match="frames"):
        eng.generate(prompts, _greedy())


def test_decoder_only_paths_raise():
    """As in the JAX package: the continuous batcher, ``forward_chunk`` and
    the paged cache layout raise ``NotImplementedError`` for encdec; the
    dense cache builds, stacked over the decoder's layers, its cross K/V
    ``n_frontend_tokens`` long."""
    jcfg, cfg, _, qparams, tq, prompts, _ = _export()
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ContinuousBatchingEngine(tq, cfg, 2, MAX_LEN, _greedy(), device=CPU)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        JaxCB(qparams, jcfg, 2, MAX_LEN, _greedy(JaxSampler))
    cache = api.init_cache(cfg, 2, MAX_LEN, torch.float32, device=CPU)
    assert tuple(cache["cross_v"].shape) == (cfg.n_layers, 2, cfg.n_frontend_tokens,
                                             cfg.n_kv_heads, cfg.head_dim)
    assert tuple(cache["self"]["k"].shape) == (cfg.n_layers, 2, MAX_LEN, cfg.n_kv_heads,
                                               cfg.head_dim)
    for fn in (lambda: api.forward_chunk(tq, torch.from_numpy(prompts).long(), cache, 0, cfg),
               lambda: api.init_cache(cfg, 2, MAX_LEN, torch.float32, device=CPU,
                                      layout="paged")):
        with pytest.raises(NotImplementedError, match="decoder-family only"):
            fn()
    for fn in (lambda: japi.forward_chunk(qparams, jnp.asarray(prompts), None, 0, jcfg),
               lambda: japi.init_cache(jcfg, 2, MAX_LEN, jnp.float32, layout="paged")):
        with pytest.raises(NotImplementedError, match="decoder-family only"):
            fn()
