"""The dense code LMs granite-20b (MQA: one KV head; a non-GLU GELU FFN,
tied embedding) and deepseek-coder-33b (GQA 56 over 8; SiLU-GLU, untied
head, rope theta 100k) in the port against the JAX package, on the CPU,
at ``registry.reduced`` (4 layers, d_model 64, 4 heads of 16 over 1 and 4
KV heads, d_ff 96, r 16, vocab 512), JAX's weights converted leaf for
leaf.  Neither brings a module of its own: the decoder family at new
shapes.

The logits, loss and nll within TOL of JAX's with JAX's act-quant
decisions replayed; one training step's metrics and every leaf after it
as ``tests/test_torch_vlm.py``'s; the continuous batcher's greedy streams
on the packed export in both layouts, with chunked prefill (and, paged,
the prefix cache over requests that share a prompt's first blocks), token
for token JAX's continuous batcher's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import param_count as jparam_count
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.serve.engine import SamplerConfig as JaxSampler
from repro.serve.scheduler import ContinuousBatchingEngine as JaxCB
from repro.train import trainer as jtrainer
from repro.train.quantized_serving import quantize_params_for_serving as jquantize
from repro_torch.configs import registry
from repro_torch.configs.base import param_count
from repro_torch.kernels import _cuda
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.serve import ContinuousBatchingEngine, SamplerConfig
from test_torch_experts import GRAD_RTOL, CPU, _t, _tbatch
from test_torch_probes import _port_replay
from test_torch_train import _jax_recording, _port_recording
from test_torch_train import _torch_one_thread  # noqa: F401  (autouse)
from repro_torch.train import trainer

ARCHS = ("granite-20b", "deepseek-coder-33b")
TOL = 1e-5
B, S = 2, 9
TOTAL = 40
NEW, MAX_LEN, BLOCK, CHUNK = 6, 40, 8, 4
# uid -> prompt: lengths past two blocks, one admission bucket (32) in
# JAX's engine, so that it compiles one prefill; requests 3 and 4 share
# request 0's first two blocks (16 tokens), which the prefix cache reuses
CB_LENS = {0: 21, 1: 18, 2: 25, 3: 19, 4: 23}


def _cfgs(arch, **kw):
    jcfg = jregistry.reduced(jregistry.get_config(arch))
    cfg = registry.reduced(registry.get_config(arch))
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)


def _batch(cfg, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax_and_param_count(arch):
    """Field for field JAX's config, full and reduced, in pquant and
    ``none``; ``param_count`` equal; the shapes that make each one."""
    for mode in ("pquant", "none"):
        j = jregistry.get_config(arch, quant_mode=mode)
        t = registry.get_config(arch, quant_mode=mode)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert dataclasses.asdict(registry.reduced(t)) == dataclasses.asdict(
            jregistry.reduced(j))
        assert param_count(t) == jparam_count(j)
    cfg = registry.get_config(arch)
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
           cfg.glu, cfg.activation, cfg.vocab_size, cfg.tie_embeddings, cfg.rope_theta,
           cfg.quant.r)
    assert got == {"granite-20b": (52, 6144, 48, 1, 128, 24576, False, "gelu", 49152, True,
                                   10000.0, 1280),
                   "deepseek-coder-33b": (62, 7168, 56, 8, 128, 19200, True, "silu", 32256,
                                          False, 100_000.0, 1024)}[arch]


@functools.cache
def _model(arch):
    """JAX's latent params of the reduced model (f32, remat off), one
    compiled init."""
    jcfg, cfg = _cfgs(arch, dtype="float32", remat=False)
    return jcfg, cfg, jax.jit(lambda k: japi.init_model(k, jcfg)[0])(jax.random.PRNGKey(7))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    """``forward``'s logits and ``lm_loss``'s loss and nll within TOL of
    JAX's, one jitted call of both, its act-quant decisions replayed; the
    tree JAX's leaf for leaf (granite's tied embedding: no ``lm_head``)."""
    jcfg, cfg, params = _model(arch)
    batch = _batch(cfg, 0)

    def jfn(p, b):
        logits, _ = japi.forward(p, b, jcfg)
        loss, m = japi.loss_fn(p, b, jcfg)
        return logits, loss, m

    rec = []
    with _jax_recording(rec):
        jlogits, jloss, jm = jax.jit(jfn)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    tp, tb = _t(params), _tbatch(batch)
    assert ("lm_head" in tp) == (not cfg.tie_embeddings)
    with torch.no_grad(), _port_recording([], rec):
        logits, _ = api.forward(tp, tb, cfg)
        loss, m = api.loss_fn(tp, tb, cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=TOL, atol=TOL)
    assert abs(loss.item() - float(jloss)) <= TOL
    assert abs(m["nll"].item() - float(jm["nll"])) <= TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One ``make_train_step`` step (lr > 0: the schedule's step 1, the
    step at which ``tests/test_torch_vlm.py``'s first moves) against
    JAX's jitted step, JAX's act-quant decisions replayed: loss, nll and
    gradient norm, and every leaf after the step within 1e-6."""
    jcfg, cfg, params = _model(arch)
    batch = _batch(cfg, 1)
    jstate = jtrainer.TrainState(params=params, opt=jadamw.init_adamw(params))
    jstate = jstate._replace(opt=jstate.opt._replace(step=jnp.asarray(1, jnp.int32)))
    acts = []
    with _jax_recording(acts):
        jstate, jm = jax.jit(jtrainer.make_train_step(jcfg, TOTAL))(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = _t(params)
    p = adamw.tree_map(torch.clone, tparams)
    state = trainer.TrainState(params=p, opt=adamw.init_adamw(p))
    state.opt.step.fill_(1)
    with _port_replay(acts):
        state, m = trainer.make_train_step(cfg, TOTAL)(state, _tbatch(batch))
    for k in ("loss", "nll"):
        assert abs(m[k].item() - float(jm[k])) <= TOL, k
    assert m["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]), rel=GRAD_RTOL)
    assert m["lr"].item() > 0
    for (path, _), after, j in zip(adamw.tree_paths(tparams), adamw.tree_leaves(state.params),
                                   jax.tree.leaves(jstate.params), strict=True):
        np.testing.assert_allclose(after.numpy(), np.asarray(j), rtol=0, atol=1e-6,
                                   err_msg="/".join(map(str, path)))


@functools.cache
def _export(arch):
    """The packed export (JAX's, converted) and JAX's continuous batcher's
    streams on it: 3 slots, paged, chunks of CHUNK, prefill slices of
    CHUNK."""
    jcfg, cfg = _cfgs(arch, dtype="float32")
    axes = {}

    def init(key):
        params, axes["tree"] = japi.init_model(key, jcfg)
        return params

    params = jax.jit(init)(jax.random.PRNGKey(11))
    qparams = jax.jit(lambda p: jquantize(p, axes["tree"], jcfg, packed=True)[0])(params)
    eng = JaxCB(qparams, jcfg, 3, MAX_LEN, JaxSampler(temperature=0.0, top_k=0,
                                                      max_new_tokens=NEW),
                layout="paged", block_size=BLOCK, chunk=CHUNK)
    return cfg, _t(qparams), _submit(eng, cfg, jnp.asarray)


def _submit(eng, cfg, to_prompt):
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab_size, 2 * BLOCK)
    for uid, n in CB_LENS.items():
        p = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        if uid in (0, 3, 4):
            p[:2 * BLOCK] = shared
        eng.submit(to_prompt(p), max_new_tokens=NEW, seed=uid, uid=uid)
    return {f.uid: np.asarray(f.tokens) for f in eng.run()}


@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_batching_chunked_streams_equal_jax(arch, layout):
    """The port's continuous batcher with ``prefill_chunk`` CHUNK (paged:
    the prefix cache on too, and hit by requests 3 and 4) against JAX's
    one-shot paged engine: neither declined for these configs, every
    stream token for token, every block back in the pool, no kernel
    launched on the CPU."""
    cfg, tq, want = _export(arch)
    eng = ContinuousBatchingEngine(tq, cfg, 3, MAX_LEN,
                                   SamplerConfig(temperature=0.0, top_k=0, max_new_tokens=NEW),
                                   layout=layout, block_size=BLOCK, chunk=CHUNK,
                                   prefill_chunk=CHUNK, prefix_cache=layout == "paged",
                                   device=CPU)
    assert eng.prefill_chunk == CHUNK and eng.prefix_cache == (layout == "paged")
    _cuda.reset_launches()
    got = _submit(eng, cfg, lambda p: p)
    assert sorted(got) == sorted(want)
    for uid, toks in got.items():
        np.testing.assert_array_equal(toks, want[uid], err_msg=str(uid))
    assert sum(_cuda.LAUNCHES.values()) == 0
    if layout == "paged":
        assert eng.allocator.free_count == eng.num_blocks
        assert eng.snapshot()["counters"]["prefix_cache_hits_total"] >= 2
