"""The encoder-decoder (``models/encdec.py``, Whisper) in the port against
the JAX package, on the CPU: ``registry.reduced`` of whisper-large-v3 (2
encoder + 4 decoder layers, d_model 64, 4 heads of 16, d_ff 96 GELU
non-GLU, r 16, vocab 512, 12 frames), JAX's weights converted leaf for
leaf, numpy-seeded frames and tokens.

Tolerances: the sinusoid table within SIN_UNITS units 2^-24 of each
element's angle p w (at least 1).  The port computes it in f64 and
rounds once to f32, so that every device has the same table; JAX
computes it in f32 (XLA folds it as a constant), where the exponent
-ln(10000) i / (half - 1) rounds by half an ulp, which ``exp`` turns
into up to ln(10000) = 9.2 units of w, and the product p w and sin/cos
round once more each.  At Whisper's 1500 frames that is a few ulps of
an angle up to 1499 rad (1.2e-4 at most).  Attention, cross-attention,
an encoder and the model's logits and loss within TOL of JAX's with JAX's
act-quant decisions replayed (a code can round either way between two
frameworks), in mode "none" as computed; gradients within GRAD_RTOL of
each leaf's largest element; two training steps as
``tests/test_torch_rglru.py``'s.  GELU is the tanh approximation on both
sides.
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
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.optim import adamw as jadamw
from repro.train import trainer as jtrainer
from repro_torch.configs import registry
from repro_torch.configs.base import param_count
from repro_torch.models import api, attention, encdec
from repro_torch.optim import adamw
from repro_torch.train import trainer
from test_torch_experts import CPU, GRAD_RTOL, _leaves, _t, _tbatch
from test_torch_probes import _port_replay
from test_torch_train import (
    _assert_grads_close,
    _jax_loss_grads,
    _jax_recording,
    _port_loss_grads,
    _port_recording,
)
from test_torch_train import _torch_one_thread  # noqa: F401  (autouse)

ARCH = "whisper-large-v3"
TOL = 1e-5
SIN_UNITS = 16
B, S = 2, 9  # decoder tokens a sequence
TOTAL = 40
MODES = ("none", "bitnet", "bitnet158", "pquant")
# the three archs of the JAX registry the port ported last
OTHERS = ("granite-20b", "deepseek-coder-33b", "phi-3-vision-4.2b")


def _cfgs(**kw):
    mode = kw.pop("quant_mode", "pquant")
    jcfg = jregistry.reduced(jregistry.get_config(ARCH, quant_mode=mode))
    cfg = registry.reduced(registry.get_config(ARCH, quant_mode=mode))
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _batch(cfg, seed=0, b=B, s=S):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"frames": _x((b, cfg.n_frontend_tokens, cfg.d_model), seed + 100),
            "tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _unhoist(rec, cfg):
    """JAX's act-quant record of a gradient, in the port's site order.

    Under ``jax.grad`` the decoder's layer scan hoists the act-quant of the
    encoder's memory (the input of every layer's cross ``wk`` and ``wv``:
    the same tensor in each layer) out of the loop, so JAX records those
    two sites once, after the encoder; the port quantizes the memory in
    every layer, between the self-attention's four sites and the cross
    query's.  Each layer gets the two hoisted records (the same decisions
    the port's own would be)."""
    n_enc, n_dec = cfg.n_enc_layers, cfg.n_layers
    ffn = (len(rec) - 2 - 4 * n_enc - 6 * n_dec) // (n_enc + n_dec)
    enc = (4 + ffn) * n_enc
    assert len(rec) == enc + 2 + (6 + ffn) * n_dec, len(rec)
    mem, dec = rec[enc:enc + 2], rec[enc + 2:]
    assert all(v.shape[-2] == cfg.n_frontend_tokens for v, _ in mem)
    out = list(rec[:enc])
    for i in range(n_dec):
        layer = dec[i * (6 + ffn):(i + 1) * (6 + ffn)]
        out += layer[:4] + mem + layer[4:]
    return out


# ---------------------------------------------------------------------------
# the config, the sinusoid table, the trees
# ---------------------------------------------------------------------------


def test_config_equals_jax_and_param_count():
    """Field for field JAX's config in the four modes, full and reduced
    (``n_enc_layers`` 2 and 12 frames reduced); ``param_count`` equal (its
    encoder and cross-attention arms); ``get_config`` builds it, and the
    three last archs build, equal to JAX's."""
    for mode in MODES:
        j = jregistry.get_config(ARCH, quant_mode=mode)
        t = registry.get_config(ARCH, quant_mode=mode)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert dataclasses.asdict(registry.reduced(t)) == dataclasses.asdict(
            jregistry.reduced(j))
        assert param_count(t) == jparam_count(j)
        assert param_count(registry.reduced(t)) == jparam_count(jregistry.reduced(j))
    cfg = registry.get_config(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.n_enc_layers, cfg.d_model, cfg.glu,
            cfg.activation, cfg.pos_embedding, cfg.n_frontend_tokens) == (
        "encdec", 32, 32, 1280, False, "gelu", "learned", 1500)
    assert param_count(cfg)["n_1bit"] == 1468006400
    red = registry.reduced(cfg)
    assert (red.n_enc_layers, red.n_frontend_tokens) == (2, 12)
    assert registry.NOT_PORTED == ()
    for arch in OTHERS:  # built now, field for field JAX's
        assert dataclasses.asdict(registry.get_config(arch)) == dataclasses.asdict(
            jregistry.get_config(arch))


@pytest.mark.parametrize("length,d", [(12, 64), (1500, 1280)])
def test_sinusoid_table_matches_jax(length, d):
    """Within SIN_UNITS units 2^-24 of max(angle, 1) of JAX's jitted table,
    element by element (see the module's docstring); position 0's sines
    are 0 and its cosines 1 exactly."""
    want = np.asarray(jax.jit(jencdec.sinusoid_table, static_argnums=(0, 1))(length, d))
    got = encdec.sinusoid_table(length, d).numpy()
    assert got.shape == want.shape == (length, d) and got.dtype == np.float32
    half = d // 2
    w = np.exp(-np.log(10000.0) * np.arange(half) / (half - 1))
    angle = np.arange(length)[:, None] * w[None, :]
    bound = SIN_UNITS * 2.0**-24 * np.maximum(np.concatenate([angle, angle], 1), 1.0)
    assert (np.abs(got - want) <= bound).all()
    np.testing.assert_array_equal(got[0, :half], np.zeros(half, np.float32))
    np.testing.assert_array_equal(got[0, half:], np.ones(half, np.float32))


@pytest.mark.parametrize("mode", ["pquant", "none"])
def test_init_tree_matches_jax(mode):
    """The params tree JAX's leaf for leaf (paths, shapes, dtypes): the
    stacked ``encoder`` and ``decoder``, ``dec_pos/pos`` (max_seq_len, D),
    the tied ``embed``, both final norms; the non-GLU FFN has no gate."""
    jcfg, cfg = _cfgs(quant_mode=mode)
    jparams = jax.eval_shape(lambda: japi.init_model(jax.random.PRNGKey(0), jcfg)[0])
    tparams = api.init_model(0, cfg, device=CPU)
    got = [("/".join(map(str, p)), tuple(t.shape), str(t.dtype)[6:])
           for p, t in adamw.tree_paths(tparams)]
    want = [(jax.tree_util.keystr(p, simple=True, separator="/"), v.shape, str(v.dtype))
            for p, v in _leaves(jparams)]
    assert got == want
    assert sorted(tparams) == ["dec_pos", "decoder", "embed", "enc_final_norm", "encoder",
                               "final_norm"]
    assert sorted(tparams["decoder"]) == ["cross_attn", "cross_norm", "ffn", "ffn_norm",
                                          "pre_norm", "self_attn"]
    assert tparams["dec_pos"]["pos"].shape == (cfg.max_seq_len, cfg.d_model)
    assert tparams["encoder"]["attn"]["wq"]["w"].shape[0] == cfg.n_enc_layers
    assert "w1_gate" not in tparams["encoder"]["ffn"]
    assert abs(tparams["dec_pos"]["pos"].std().item() - 0.02) < 2e-3


# ---------------------------------------------------------------------------
# attention: bidirectional, the cache_len branches, cross-attention
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layer():
    """One decoder layer of the reduced config (f32, pquant), JAX's and the
    port's."""
    jcfg, cfg = _cfgs(dtype="float32")
    jp = jax.jit(lambda k: jencdec._init_dec_layer(k, jcfg)[0])(jax.random.PRNGKey(3))
    return jcfg, cfg, jp, _t(jp)


@pytest.mark.parametrize("causal,cache_len", [(False, None), (True, None), (True, 16),
                                              (True, 4)])
def test_attention_causal_and_cache_len_match_jax(layer, causal, cache_len):
    """``attention`` with ``causal`` False (no mask: the encoder's) and
    True, and with ``cache_len`` past S (K/V padded with zeros) and below
    it (the ring: the last cache_len positions rolled by S % cache_len):
    outputs and caches within TOL of JAX's, its act-quant decisions
    replayed; in the ring, slot p % cache_len holds position p's key."""
    jcfg, cfg, jp, tp = layer
    x = _x((3, 10, cfg.d_model), 1)
    dummy = jnp.zeros((10, cfg.head_dim // 2), jnp.float32)
    rec = []
    with _jax_recording(rec):
        jout = jax.jit(lambda p, x: jattn.attention(p, x, jcfg, dummy, dummy, causal=causal,
                                                    cache_len=cache_len))(
            jp["self_attn"], jnp.asarray(x))
    with torch.no_grad(), _port_recording([], rec):
        out = attention.attention(tp["self_attn"], torch.from_numpy(x), cfg, None, None,
                                  causal=causal, cache_len=cache_len)
    if cache_len is None:
        _close(out.numpy(), jout)
        return
    (y, cache), (jy, jcache) = out, jout
    _close(y.numpy(), jy)
    for k in ("k", "v"):
        assert tuple(cache[k].shape) == jcache[k].shape == (3, cache_len, cfg.n_kv_heads,
                                                            cfg.head_dim)
        _close(cache[k].numpy(), jcache[k])
    with torch.no_grad(), _port_recording([], rec):
        _, full = attention.attention(tp["self_attn"], torch.from_numpy(x), cfg, None, None,
                                      cache_len=10)
    if cache_len > 10:
        assert not cache["k"][:, 10:].any()
        np.testing.assert_array_equal(cache["k"][:, :10].numpy(), full["k"].numpy())
    else:
        for p in range(10 - cache_len, 10):
            np.testing.assert_array_equal(cache["v"][:, p % cache_len].numpy(),
                                          full["v"][:, p].numpy())


def test_cross_kv_and_cross_attention_match_jax(layer):
    """``cross_kv`` over a 12-frame memory and ``cross_attention`` of 5
    queries against it (1-bit ``wq``, no mask, SubLN and ``wo``) within
    TOL of JAX's, its act-quant decisions replayed."""
    jcfg, cfg, jp, tp = layer
    mem, x = _x((3, 12, cfg.d_model), 2), _x((3, 5, cfg.d_model), 3)

    def jfn(p, mem, x):
        k, v = jattn.cross_kv(p, mem, jcfg)
        return k, v, jattn.cross_attention(p, x, k, v, jcfg)

    rec = []
    with _jax_recording(rec):
        jk, jv, jy = jax.jit(jfn)(jp["cross_attn"], jnp.asarray(mem), jnp.asarray(x))
    with torch.no_grad(), _port_recording([], rec):
        k, v = attention.cross_kv(tp["cross_attn"], torch.from_numpy(mem), cfg)
        y = attention.cross_attention(tp["cross_attn"], torch.from_numpy(x), k, v, cfg)
    assert tuple(k.shape) == (3, 12, cfg.n_kv_heads, cfg.head_dim)
    for got, want in ((k, jk), (v, jv), (y, jy)):
        _close(got.numpy(), want)


# ---------------------------------------------------------------------------
# the model: encode, forward, loss, gradients, training
# ---------------------------------------------------------------------------


@functools.cache
def _model(mode: str):
    """JAX's latent params of the reduced model in ``mode`` (f32, remat
    off), one compiled init."""
    jcfg, cfg = _cfgs(quant_mode=mode, dtype="float32", remat=False)
    return jcfg, cfg, jax.jit(lambda k: japi.init_model(k, jcfg)[0])(jax.random.PRNGKey(7))


@pytest.mark.parametrize("mode", MODES)
def test_encode_forward_and_loss_match_jax(mode):
    """``encode``'s memory, the logits of ``forward`` and the loss and nll
    of ``lm_loss`` (2 x 12 frames, 2 x 9 tokens, f32) within TOL of JAX's,
    one jitted call of the three, its act-quant decisions replayed (mode
    "none" has none); aux 0 (no routed expert)."""
    jcfg, cfg, params = _model(mode)
    batch = _batch(cfg)

    def jfn(p, b):
        mem = jencdec.encode(p, b["frames"], jcfg)
        logits, _ = japi.forward(p, b, jcfg)
        loss, m = japi.loss_fn(p, b, jcfg)
        return mem, logits, loss, m

    rec = []
    with _jax_recording(rec):
        jmem, jlogits, jloss, jm = jax.jit(jfn)(params, {k: jnp.asarray(v)
                                                         for k, v in batch.items()})
    tp, tb = _t(params), _tbatch(batch)
    with torch.no_grad(), _port_recording([], rec):
        mem = encdec.encode(tp, tb["frames"], cfg)
        logits, aux = api.forward(tp, tb, cfg)
        loss, m = api.loss_fn(tp, tb, cfg)
    assert (len(rec) > 0) == (mode != "none")
    assert tuple(mem.shape) == (B, cfg.n_frontend_tokens, cfg.d_model)
    _close(mem.numpy(), jmem)
    _close(logits.numpy(), jlogits)
    assert abs(loss.item() - float(jloss)) <= TOL
    assert abs(m["nll"].item() - float(jm["nll"])) <= TOL
    assert aux.item() == m["aux"].item() == float(jm["aux"]) == 0.0


def test_lm_loss_gradients_match_jax():
    """Every leaf of ``jax.grad(api.loss_fn)`` within GRAD_RTOL of its
    largest element, JAX's act-quant decisions replayed in the port (in
    the port's site order, ``_unhoist``); the
    encoder's leaves, ``dec_pos`` (its first S rows only) and the tied
    embedding get gradients."""
    jcfg, cfg, params = _model("pquant")
    batch = _batch(cfg, seed=1)
    jloss, _, jgrads, rec = _jax_loss_grads(jcfg, params, batch)
    tparams = _t(params)
    loss, _, grads, _ = _port_loss_grads(cfg, tparams, batch, replay=_unhoist(rec, cfg))
    assert abs(loss - jloss) <= TOL
    paths = [p for p, _ in adamw.tree_paths(tparams)]
    _assert_grads_close(grads, jgrads, paths)
    g = dict(zip(("/".join(map(str, p)) for p in paths), grads))
    assert all(bool(torch.isfinite(v).all()) for v in grads)
    assert all(g[k].abs().sum() > 0 for k in ("encoder/attn/wq/w", "encoder/ffn/w1_up",
                                              "decoder/cross_attn/wk/w", "embed/table"))
    pos = g["dec_pos/pos"]
    assert pos[:S].abs().sum() > 0 and not pos[S:].any()


def test_two_train_steps_match_jax():
    """``make_train_step`` with ``probes=True`` against JAX's jitted step
    with the same: both force the probes off for encdec (no ``qat_*``
    metric); losses and gradient norms, and every leaf after the steps,
    JAX's decisions replayed (``_unhoist``); step 1 (lr > 0) moves the encoder, the
    cross-attention and the positions."""
    jcfg, cfg, params = _model("pquant")
    tparams = _t(params)
    batches = [_batch(cfg, seed=10 + i) for i in range(2)]
    jstate = jtrainer.TrainState(params=params, opt=jadamw.init_adamw(params))
    jstep = jax.jit(jtrainer.make_train_step(jcfg, TOTAL, probes=True))
    jm, acts = [], []
    with _jax_recording(acts):
        for b in batches:
            jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
            jm.append({k: float(v) for k, v in m.items()})
    na = len(acts) // 2
    p = adamw.tree_map(torch.clone, tparams)
    state = trainer.TrainState(params=p, opt=adamw.init_adamw(p))
    step = trainer.make_train_step(cfg, TOTAL, probes=True)
    tm = []
    for i, b in enumerate(batches):
        with _port_replay(_unhoist(acts[i * na:(i + 1) * na], cfg)):
            state, m = step(state, _tbatch(b))
        tm.append({k: v.item() for k, v in m.items()})
    for a, b in zip(tm, jm):
        assert set(a) == set(b) == {"loss", "nll", "grad_norm", "lr", "wd"}
        for k in ("loss", "nll"):
            assert abs(a[k] - b[k]) <= TOL, (k, a[k], b[k])
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=GRAD_RTOL)
    paths = ["/".join(map(str, p)) for p, _ in adamw.tree_paths(tparams)]
    for path, before, after, j in zip(paths, adamw.tree_leaves(tparams),
                                      adamw.tree_leaves(state.params),
                                      jax.tree.leaves(jstate.params), strict=True):
        np.testing.assert_allclose(after.numpy(), np.asarray(j), rtol=0, atol=1e-6,
                                   err_msg=path)
        if path in ("encoder/attn/wq/w", "encoder/ffn/w8_up", "decoder/cross_attn/wv/w",
                    "dec_pos/pos"):
            assert not torch.equal(before, after), path
