"""The VLM prefix served by the port, against the JAX package on the CPU:
the packed export of ``registry.reduced`` phi-3-vision-4.2b (made in JAX,
converted leaf for leaf), ``DecodeEngine`` and ``BatchedServer`` with
``extra_inputs={"image_embeds": ...}``, and the continuous batcher on
text-only requests (upstream's ``submit`` takes no images).

The image rows take the first cache positions: the prefill writes 8 + S
rows and the first decode step runs at position 8 + S, the offset of
``tests/test_arch_smoke.py``'s decode test.  Upstream's ``DecodeEngine``
sizes nothing for the caller: an engine whose ``max_len`` is shorter than
the image rows, the prompt and the new tokens raises nothing in JAX (its
cache writes clamp to the last position), and the port gives JAX's streams
there too; the continuous batcher refuses a request whose prompt and
budget exceed ``max_len`` in both packages.  For a VLM config chunked
admission, the prefix cache and bucketed admission are declined (the first
two logged once a config), as upstream's.

Exports exact (integers) or within rtol 1e-6 (scales); streams token for
token; logits within ATOL_FLIP and in the median within ATOL (the packed
path's act-quant codes are not replayed).
"""

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
from repro.serve.scheduler import InadmissibleRequest as JaxInadmissible
from repro.train.quantized_serving import quantize_params_for_serving as jquantize
from repro_torch.convert import params_to_numpy
from repro_torch.kernels import _cuda
from repro_torch.models import api
from repro_torch.serve import ContinuousBatchingEngine, DecodeEngine, SamplerConfig, scheduler
from repro_torch.train.quantized_serving import quantize_params_for_serving
from repro_torch.train.serve import BatchedServer
from test_torch_experts import ATOL, ATOL_FLIP, CPU, _leaves, _t
from test_torch_experts_serving import _cb_streams
from test_torch_train import _torch_one_thread  # noqa: F401  (autouse)
from test_torch_vlm import _cfgs, _x

PROMPT, NEW = 5, 6
MAX_LEN = 24  # 8 image rows + 5 tokens + 6 new fit
# uid -> prompt length of the text-only continuous-batching requests
CB_PROMPTS = {0: 7, 1: 3, 2: 7, 3: 3, 4: 7}
CB_MAX_LEN = 16


@functools.cache
def _export():
    """JAX's latent params (f32) and packed export, each one compiled call,
    and the numpy-seeded prompts and image rows of three requests."""
    jcfg, cfg = _cfgs(dtype="float32")
    axes = {}

    def init(key):
        params, axes["tree"] = japi.init_model(key, jcfg)
        return params

    params = jax.jit(init)(jax.random.PRNGKey(11))
    qparams = jax.jit(lambda p: jquantize(p, axes["tree"], jcfg, packed=True)[0])(params)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, PROMPT)).astype(np.int32)
    images = _x((3, cfg.n_image_tokens, cfg.d_model), 6)
    return jcfg, cfg, params, qparams, _t(qparams), prompts, images


def _greedy(cls=SamplerConfig, new=NEW):
    return cls(temperature=0.0, top_k=0, max_new_tokens=new)


def test_packed_export_equals_jax_leaf_for_leaf():
    """Integers and scales JAX's; q/k/v/o and the GLU's ``w1_gate`` /
    ``w1_up`` / ``w1_down`` packed, its three 8-bit branches int8, stacked
    on the layer axis; the embedding and the untied head the latents bit
    for bit (no leaf for the image rows)."""
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
    blk = mine["segments"][0]["b0"]
    n, d, f, r = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.quant.r
    for w in ("wq", "wk", "wv", "wo"):
        assert blk["mixer"][w]["w"]["packed"].shape == (n, d // 8, d), w
    for w in ("w1_gate", "w1_up"):
        assert blk["ffn"][w]["packed"].shape == (n, d // 8, f), w
    assert blk["ffn"]["w1_down"]["packed"].shape == (n, f // 8, d)
    for w in ("w8_gate", "w8_up"):
        assert blk["ffn"][w]["q"].shape == (n, 1, d, r) and blk["ffn"][w]["q"].dtype == np.int8
    latent = jax.tree.map(np.asarray, params)
    for k in ("embed", "lm_head"):
        for (_, a), (_, b) in zip(_leaves(mine[k]), _leaves(latent[k]), strict=True):
            np.testing.assert_array_equal(a, b)


def test_prefill_and_first_decode_step_match_jax():
    """The packed prefill of three requests (8 image rows, 5 tokens) into a
    24-position cache, then one decode step at position 8 + 5: logits
    against JAX's same calls; the cache written over the first 13 positions
    and not past them."""
    jcfg, cfg, _, qparams, tq, prompts, images = _export()
    pos = cfg.n_image_tokens + PROMPT
    tok = np.array([[7], [9], [11]], np.int32)

    def jax_calls(q, b, t):
        l1, c = japi.prefill(q, b, jcfg, MAX_LEN)
        l2, _ = japi.decode_step(q, t, c, jnp.asarray(pos, jnp.int32), jcfg)
        return l1, l2, c

    j1, j2, jc = jax.jit(jax_calls)(
        qparams, {"tokens": jnp.asarray(prompts), "image_embeds": jnp.asarray(images)},
        jnp.asarray(tok))
    batch = {"tokens": torch.from_numpy(prompts).long(), "image_embeds": torch.from_numpy(images)}
    t1, c = api.prefill(tq, batch, cfg, MAX_LEN)
    leaves = [t for _, t in _leaves(c)]
    assert leaves and all(t.shape[-3] == MAX_LEN for t in leaves)
    for t in leaves:  # (L, B, T, H, D): written through the prompt's last row only
        assert t[:, :, pos - 1].any() and not t[:, :, pos:].any()
    t2, _ = api.decode_step(tq, torch.from_numpy(tok).long(), c, pos, cfg)
    for got, want in ((t1, j1), (t2, j2)):
        err = np.abs(got.numpy() - np.asarray(want))
        assert err.max() <= ATOL_FLIP and np.median(err) <= ATOL, err.max()


def test_decode_engine_greedy_streams_equal_jax():
    """``DecodeEngine.generate(prompts, scfg, extra_inputs={"image_embeds":
    ...})`` on the packed export gives JAX's engine's streams token for
    token; the first decode step at position 8 + 5; one transfer a
    generate, no kernel launched on the CPU."""
    jcfg, cfg, _, qparams, tq, prompts, images = _export()
    want = JaxEngine(qparams, jcfg, max_len=MAX_LEN).generate(
        jnp.asarray(prompts), _greedy(JaxSampler),
        extra_inputs={"image_embeds": jnp.asarray(images)})
    eng = DecodeEngine(tq, cfg, max_len=MAX_LEN, device=CPU)
    starts, decode = [], eng._decode
    eng._decode = lambda tok, caches, pos, *a: (starts.append(pos), decode(tok, caches, pos,
                                                                          *a))[1]
    _cuda.reset_launches()
    got = eng.generate(prompts, _greedy(), extra_inputs={"image_embeds": images})
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.shape == (3, NEW) and starts == [cfg.n_image_tokens + PROMPT]
    assert eng.host_transfers == 1 and sum(_cuda.LAUNCHES.values()) == 0


def test_batched_server_and_stream_with_images_equal_generate():
    """On the export: ``generate_stream`` (chunks of 2: one transfer a
    chunk) and ``BatchedServer.generate``, ``generate_stream`` and
    ``generate_python_loop`` (one transfer a token), all with the image
    rows, each equal to ``DecodeEngine.generate``."""
    _, cfg, _, _, tq, prompts, images = _export()
    extra = {"image_embeds": images}
    eng = DecodeEngine(tq, cfg, max_len=MAX_LEN, device=CPU)
    full = eng.generate(prompts, _greedy(), extra_inputs=extra)
    parts = list(eng.generate_stream(prompts, _greedy(), extra_inputs=extra, chunk=2))
    np.testing.assert_array_equal(np.concatenate(parts, axis=1), full)
    assert eng.host_transfers == 1 + -(-(NEW - 1) // 2)
    server = BatchedServer(tq, cfg, MAX_LEN, device=CPU)
    np.testing.assert_array_equal(server.generate(prompts, _greedy(), extra), full)
    np.testing.assert_array_equal(
        np.concatenate(list(server.generate_stream(prompts, _greedy(), extra, chunk=3)), axis=1),
        full)
    np.testing.assert_array_equal(server.generate_python_loop(prompts, _greedy(), extra), full)
    assert server.host_transfers == NEW  # the python loop: one a token


@pytest.mark.parametrize("max_len", [10, 16])
def test_short_max_len_gives_upstreams_streams(max_len):
    """Upstream's engine takes a ``max_len`` too short for the image rows,
    the prompt and the new tokens (10: not even the 13-row prefill; 16:
    the last decode steps) without raising: its cache writes clamp to the
    last position.  The port raises nothing either and gives JAX's streams
    token for token."""
    jcfg, cfg, _, qparams, tq, prompts, images = _export()
    want = JaxEngine(qparams, jcfg, max_len=max_len).generate(
        jnp.asarray(prompts), _greedy(JaxSampler),
        extra_inputs={"image_embeds": jnp.asarray(images)})
    got = DecodeEngine(tq, cfg, max_len=max_len, device=CPU).generate(
        prompts, _greedy(), extra_inputs={"image_embeds": images})
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.fixture(scope="module")
def jax_cb():
    """JAX's continuous batcher on the export, text-only requests (3 slots,
    so that requests queue and slots go idle), paged."""
    jcfg, cfg, _, qparams, _, _, _ = _export()
    eng = JaxCB(qparams, jcfg, 3, CB_MAX_LEN, _greedy(JaxSampler), layout="paged", block_size=8,
                chunk=4)
    with pytest.raises(JaxInadmissible):
        eng.submit(jnp.zeros((CB_MAX_LEN - NEW + 1,), jnp.int32), max_new_tokens=NEW)
    return _cb_streams(eng, CB_PROMPTS, cfg.vocab_size, jnp.asarray)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_continuous_batching_text_only_equals_jax(jax_cb, layout, caplog):
    """The port's continuous batcher on text-only requests against JAX's,
    both layouts (paged: the text's K/V on the pool, the gather route on
    the CPU): chunked admission and (paged) the prefix cache requested and
    declined, each logged once for the config however many engines are
    built, and bucketed admission declined (exact-length prefills); a
    request past ``max_len`` refused as upstream's; streams token for
    token."""
    _, cfg, _, _, tq, _, _ = _export()
    scheduler._CHUNK_DECLINE_LOGGED.clear()
    scheduler._PREFIX_DECLINE_LOGGED.clear()
    with caplog.at_level(logging.WARNING, logger="repro_torch.serve.scheduler"):
        for _ in range(2):
            eng = ContinuousBatchingEngine(tq, cfg, 3, CB_MAX_LEN, _greedy(), layout=layout,
                                           block_size=8, chunk=4, prefill_chunk=4,
                                           prefix_cache=layout == "paged", device=CPU)
    lines = [r.getMessage() for r in caplog.records]
    assert len([m for m in lines if "chunked admission prefill declined" in m]) == 1
    assert len([m for m in lines if "prefix caching declined" in m]) == (layout == "paged")
    assert eng.prefill_chunk is None and eng._prefill_bucketed is None and not eng.prefix_cache
    with pytest.raises(scheduler.InadmissibleRequest):
        eng.submit(np.zeros((CB_MAX_LEN - NEW + 1,), np.int32), max_new_tokens=NEW)
    got = _cb_streams(eng, CB_PROMPTS, cfg.vocab_size, lambda p: p)
    assert sorted(got) == sorted(jax_cb)
    for uid, toks in got.items():
        np.testing.assert_array_equal(toks, jax_cb[uid], err_msg=str(uid))
    if eng.allocator is not None:
        assert eng.allocator.free_count == eng.num_blocks
