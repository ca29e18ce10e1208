"""The VLM prefix (phi-3-vision-4.2b) in the port against the JAX package,
on the CPU: ``registry.reduced`` of phi-3-vision-4.2b (4 layers, d_model
64, 4 heads of 16, d_ff 96 SiLU-GLU, r 16, vocab 512, untied head, 8 image
rows), JAX's weights converted leaf for leaf, numpy-seeded tokens and
image embeddings.  The CLIP tower is a stub in both packages: a batch
carries "image_embeds" (B, 8, 64), put before the tokens.

Tolerances as ``tests/test_torch_encdec.py``'s: the logits, the loss and
the nll within TOL of JAX's with JAX's act-quant decisions replayed (a code
can round either way between two frameworks); gradients within GRAD_RTOL
of each leaf's largest element; two training steps with every leaf after
them within 1e-6.
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
from repro.train import trainer as jtrainer
from repro_torch.configs import registry
from repro_torch.configs.base import param_count
from repro_torch.convert import params_to_numpy
from repro_torch.models import api
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

ARCH = "phi-3-vision-4.2b"
TOL = 1e-5
B, S = 2, 9  # text tokens a sequence
TOTAL = 40
MODES = ("none", "bitnet", "bitnet158", "pquant")


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
    return {"image_embeds": _x((b, cfg.n_image_tokens, cfg.d_model), seed + 100),
            "tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_config_equals_jax_and_param_count():
    """Field for field JAX's config in the four modes, full and reduced (8
    image rows reduced); ``param_count`` equal; the VLM fields themselves."""
    for mode in MODES:
        j = jregistry.get_config(ARCH, quant_mode=mode)
        t = registry.get_config(ARCH, quant_mode=mode)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert dataclasses.asdict(registry.reduced(t)) == dataclasses.asdict(
            jregistry.reduced(j))
        assert param_count(t) == jparam_count(j)
    cfg = registry.get_config(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.frontend, cfg.n_image_tokens, cfg.tie_embeddings, cfg.quant.r) == (
        "decoder", 32, 3072, 96, 8192, 32064, "vision", 576, False, 384)
    assert registry.reduced(cfg).n_image_tokens == 8


@functools.cache
def _model(mode: str = "pquant"):
    """JAX's latent params of the reduced model in ``mode`` (f32, remat
    off), one compiled init."""
    jcfg, cfg = _cfgs(quant_mode=mode, dtype="float32", remat=False)
    return jcfg, cfg, jax.jit(lambda k: japi.init_model(k, jcfg)[0])(jax.random.PRNGKey(7))


def test_init_tree_matches_jax():
    """The port's own init has JAX's tree, leaf for leaf: paths, shapes and
    dtypes, the untied ``lm_head`` among them; no leaf for the image rows
    (the CLIP tower is a stub)."""
    jcfg, cfg, params = _model()
    mine = params_to_numpy(api.init_model(3, cfg, device=CPU))
    theirs = jax.tree.map(np.asarray, params)
    for (pa, a), (pb, b) in zip(_leaves(mine), _leaves(theirs), strict=True):
        assert jax.tree_util.keystr(pa) == jax.tree_util.keystr(pb)
        assert a.shape == b.shape and a.dtype == b.dtype, jax.tree_util.keystr(pa)
    assert mine["lm_head"]["table"].shape == (cfg.vocab_size, cfg.d_model)


def test_forward_and_loss_match_jax():
    """The logits of ``forward`` over the 8 image rows and the 9 tokens
    ((B, 8 + S, V)) and the loss and nll of ``lm_loss`` within TOL of
    JAX's, one jitted call of both, its act-quant decisions replayed; aux
    0.  The loss is the cross entropy of the text rows alone: the port's
    own logits past the image rows against the labels give it, and a
    batch without the images gives another loss over S rows."""
    jcfg, cfg, params = _model()
    batch = _batch(cfg)

    def jfn(p, b):
        logits, _ = japi.forward(p, b, jcfg)
        loss, m = japi.loss_fn(p, b, jcfg)
        return logits, loss, m

    rec = []
    with _jax_recording(rec):
        jlogits, jloss, jm = jax.jit(jfn)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    tp, tb = _t(params), _tbatch(batch)
    with torch.no_grad(), _port_recording([], rec):
        logits, aux = api.forward(tp, tb, cfg)
        loss, m = api.loss_fn(tp, tb, cfg)
    n_img = cfg.n_image_tokens
    assert tuple(logits.shape) == (B, n_img + S, cfg.vocab_size) == jlogits.shape
    _close(logits.numpy(), jlogits)
    assert abs(loss.item() - float(jloss)) <= TOL
    assert abs(m["nll"].item() - float(jm["nll"])) <= TOL
    assert aux.item() == m["aux"].item() == float(jm["aux"]) == 0.0
    text = torch.nn.functional.cross_entropy(
        logits[:, n_img:].reshape(-1, cfg.vocab_size), tb["labels"].reshape(-1).long())
    assert abs(text.item() - m["nll"].item()) <= TOL
    with torch.no_grad():
        no_img, _ = api.forward(tp, {"tokens": tb["tokens"]}, cfg)
        loss_t, _ = api.loss_fn(tp, {k: tb[k] for k in ("tokens", "labels")}, cfg)
    assert tuple(no_img.shape) == (B, S, cfg.vocab_size)
    assert abs(loss_t.item() - loss.item()) > TOL


def test_lm_loss_gradients_match_jax():
    """Every leaf of ``jax.grad(api.loss_fn)`` with the image rows within
    GRAD_RTOL of its largest element, JAX's act-quant decisions replayed;
    the embedding's gradient only on the rows of the tokens seen, the
    head's on every row."""
    jcfg, cfg, params = _model()
    batch = _batch(cfg, seed=1)
    jloss, _, jgrads, rec = _jax_loss_grads(jcfg, params, batch)
    tparams = _t(params)
    loss, _, grads, _ = _port_loss_grads(cfg, tparams, batch, replay=rec)
    assert abs(loss - jloss) <= TOL
    paths = [p for p, _ in adamw.tree_paths(tparams)]
    _assert_grads_close(grads, jgrads, paths)
    g = dict(zip(("/".join(map(str, p)) for p in paths), grads))
    assert all(bool(torch.isfinite(v).all()) for v in grads)
    seen = np.zeros(cfg.vocab_size, bool)
    seen[np.unique(batch["tokens"])] = True
    rows = g["embed/table"].abs().sum(dim=1).numpy() > 0
    np.testing.assert_array_equal(rows, seen)
    assert (g["lm_head/table"].abs().sum(dim=1) > 0).all()


def test_two_train_steps_match_jax():
    """``make_train_step`` with the probes on, on two batches with image
    rows, against JAX's jitted step: losses, nll and gradient norms, and
    every leaf after the steps (JAX's decisions replayed); the probes'
    metrics JAX's keys; step 1 (lr > 0) moves the layers and the head."""
    jcfg, cfg, params = _model()
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
        with _port_replay(acts[i * na:(i + 1) * na]):
            state, m = step(state, _tbatch(b))
        tm.append({k: v.item() for k, v in m.items()})
    for a, b in zip(tm, jm):
        assert set(a) == set(b)
        for k in ("loss", "nll"):
            assert abs(a[k] - b[k]) <= TOL, (k, a[k], b[k])
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=GRAD_RTOL)
    paths = ["/".join(map(str, p)) for p, _ in adamw.tree_paths(tparams)]
    for path, before, after, j in zip(paths, adamw.tree_leaves(tparams),
                                      adamw.tree_leaves(state.params),
                                      jax.tree.leaves(jstate.params), strict=True):
        np.testing.assert_allclose(after.numpy(), np.asarray(j), rtol=0, atol=1e-6,
                                   err_msg=path)
        if path in ("segments/0/b0/mixer/wq/w", "segments/0/b0/ffn/w8_up", "lm_head/table"):
            assert not torch.equal(before, after), path


def test_accumulated_step_slices_the_image_rows():
    """``make_train_step(accum=2)`` on a batch of 2 with image rows: each
    microbatch takes its own sequence's images (a microbatch fed the other
    one's would see other rows), so its loss and gradient norm equal the
    one-shot step's (per-token act-quant: the same codes; equal token
    counts: the mean of the two means) and every leaf after it agrees."""
    _, cfg, params = _model()
    batch = _tbatch(_batch(cfg, seed=20))
    out = {}
    for accum in (1, 2):
        p = adamw.tree_map(torch.clone, _t(params))
        state = trainer.TrainState(params=p, opt=adamw.init_adamw(p))
        state.opt.step.fill_(1)
        out[accum] = trainer.make_train_step(cfg, TOTAL, accum=accum)(state, batch)
    (s1, m1), (s2, m2) = out[1], out[2]
    assert abs(m1["loss"].item() - m2["loss"].item()) <= 1e-6
    assert m2["grad_norm"].item() == pytest.approx(m1["grad_norm"].item(), rel=GRAD_RTOL)
    for a, b in zip(adamw.tree_leaves(s1.params), adamw.tree_leaves(s2.params), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    swapped = dict(batch, image_embeds=batch["image_embeds"].flip(0))
    p = adamw.tree_map(torch.clone, _t(params))
    _, m3 = trainer.make_train_step(cfg, TOTAL, accum=2)(
        trainer.TrainState(params=p, opt=adamw.init_adamw(p)), swapped)
    assert abs(m3["loss"].item() - m2["loss"].item()) > 1e-6
