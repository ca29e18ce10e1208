"""Mamba-2 (``models/ssm.py``) and the decoupled projection
(``core/decoupled.py``'s ``decoupled_proj``) in the port against the JAX
package, on the CPU: ``registry.reduced`` of mamba2-780m (4 layers,
d_model 64, d_inner 128, 8 SSD heads of 16, state 16, 1 group, chunk 16,
r 16, vocab 512), JAX's weights converted leaf for leaf, numpy-seeded
inputs, sequences of 37 tokens (two chunks and a padded tail of 5).

Tolerances: the SSD, the conv, a decode step and the projections within
rtol and atol TOL (f32 sums in another order: upstream's einsums pick
their own contraction order); the projections' gradients within GRAD_TOL
of each leaf's largest element; the model's logits and loss within
MODEL_TOL with JAX's act-quant decisions replayed (a code can round either
way between two frameworks) and in mode "none" as computed; two training
steps with the decisions replayed, as ``tests/test_torch_mla.py``.  The
routed projection (N = 4) replays JAX's router choices too.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import param_count as jparam_count
from repro.core import decoupled as jdecoupled
from repro.core.quantization import QuantConfig as JQuantConfig
from repro.core.routing import RouterConfig as JRouterConfig
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.telemetry import probes as jprobes
from repro.train import trainer as jtrainer
from repro_torch.configs import registry
from repro_torch.configs.base import param_count
from repro_torch.convert import params_to_numpy
from repro_torch.core import decoupled
from repro_torch.core.quantization import QuantConfig
from repro_torch.core.routing import RouterConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import api, ssm, transformer
from repro_torch.optim import adamw
from repro_torch.telemetry import probes
from repro_torch.train import trainer
from repro_torch.train.quantized_serving import quantize_params_for_serving
from test_torch_experts import (
    CPU,
    GRAD_RTOL,
    _batch,
    _jax_choices,
    _leaves,
    _port_choices,
    _t,
    _tbatch,
)
from test_torch_probes import _port_replay
from test_torch_train import _jax_recording, _port_recording
from test_torch_train import _torch_one_thread  # noqa: F401  (autouse)

ARCH = "mamba2-780m"
TOL = 1e-5
GRAD_TOL = 1e-4
MODEL_TOL = 1e-4
S = 37  # not a multiple of the reduced chunk (16)
TOTAL = 40
# the three archs of the JAX registry the port ported last
OTHERS = ("granite-20b", "deepseek-coder-33b", "phi-3-vision-4.2b")
MODES = ("none", "bitnet", "bitnet158", "pquant")


def _cfgs(**kw):
    mode = kw.pop("quant_mode", "pquant")
    n = kw.pop("n_experts", 1)
    jcfg = jregistry.reduced(jregistry.get_config(ARCH, quant_mode=mode, n_experts=n))
    cfg = registry.reduced(registry.get_config(ARCH, quant_mode=mode, n_experts=n))
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the config and the segment plan
# ---------------------------------------------------------------------------


def test_config_equals_jax_and_counts_780e6():
    for mode in MODES:
        j = jregistry.get_config(ARCH, quant_mode=mode)
        t = registry.get_config(ARCH, quant_mode=mode)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert dataclasses.asdict(registry.reduced(t)) == dataclasses.asdict(
            jregistry.reduced(j))
        assert param_count(t) == jparam_count(j)
    assert abs(param_count(registry.get_config(ARCH))["total"] / 1e9 - 0.78) / 0.78 < 0.15
    assert registry.NOT_PORTED == ()
    for arch in OTHERS:  # built now, field for field JAX's
        assert dataclasses.asdict(registry.get_config(arch)) == dataclasses.asdict(
            jregistry.get_config(arch))
    assert registry.get_config("whisper-large-v3").family == "encdec"


def test_segment_plan_params_and_caches_keep_upstreams_layout():
    """One segment of SSD blocks with no FFN (no ``ffn_norm`` leaf); the
    params tree JAX's leaf for leaf in every mode and with N = 4 experts;
    the cache {"conv" in the serving dtype, "state" f32} in both layouts,
    none on the paged pool."""
    for kw in ({}, {"quant_mode": "none"}, {"n_experts": 4}):
        jcfg, cfg = _cfgs(**kw)
        assert [(s.repeats, s.blocks, s.first_layer)
                for s in transformer.build_segments(cfg)] == [
            (s.repeats, tuple(transformer.BlockSpec(b.mixer, b.ffn, b.window)
                              for b in s.blocks), s.first_layer)
            for s in jtransformer.build_segments(jcfg)] == [
            (cfg.n_layers, (transformer.BlockSpec("ssm", None),), 0)]
        jparams = jax.eval_shape(lambda c=jcfg: japi.init_model(jax.random.PRNGKey(0), c)[0])
        tparams = api.init_model(0, cfg, device=CPU)
        got = [("/".join(map(str, p)), tuple(t.shape), str(t.dtype)[6:])
               for p, t in adamw.tree_paths(tparams)]
        want = [(jax.tree_util.keystr(p, simple=True, separator="/"), v.shape, str(v.dtype))
                for p, v in _leaves(jparams)]
        assert got == want, kw
        assert not any("ffn" in g[0] for g in got)
    jc = jax.eval_shape(lambda: japi.init_cache(jcfg, 2, 16, jnp.bfloat16)[0])
    for layout in ("dense", "paged"):
        c = api.init_cache(cfg, 2, 16, torch.bfloat16, device=CPU, layout=layout, block_size=8)
        assert [("/".join(map(str, p)), tuple(t.shape), str(t.dtype)[6:])
                for p, t in adamw.tree_paths(c)] == [
            (jax.tree_util.keystr(p, simple=True, separator="/"), v.shape, str(v.dtype))
            for p, v in _leaves(jc)]
        assert c[0]["b0"]["state"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the SSD, the conv, a decode step
# ---------------------------------------------------------------------------


def _ssd_inputs(seed=0, b=2, length=S, h=8, p=16, g=2, n=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, length, h, p)).astype(np.float32)
    dta = -np.abs(rng.standard_normal((b, length, h))).astype(np.float32) * 0.3
    bm = rng.standard_normal((b, length, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, length, g, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dta, bm, cm, s0


def _recurrence(x, dta, bm, cm, s0):
    """The SSD as its plain recurrence, in f64: h_t = exp(dta_t) h_{t-1} +
    x_t B_t^T, y_t = h_t C_t (groups broadcast to heads)."""
    b, length, h, p = x.shape
    rep = h // bm.shape[2]
    bh, ch = np.repeat(bm, rep, axis=2), np.repeat(cm, rep, axis=2)
    st = np.zeros((b, h, p, bm.shape[-1])) if s0 is None else s0.astype(np.float64)
    ys = []
    for t in range(length):
        st = st * np.exp(dta[:, t])[..., None, None] + x[:, t, :, :, None] * bh[:, t, :, None]
        ys.append(np.einsum("bhpn,bhn->bhp", st, ch[:, t]))
    return np.stack(ys, 1), st


def test_segsum_matches_jax_with_exact_zeros_above():
    a = _x((3, 8, 16), 1)
    got = ssm._segsum(torch.from_numpy(a))
    want = np.asarray(jssm._segsum(jnp.asarray(a)))
    assert np.isneginf(want).sum() == np.isneginf(got.numpy()).sum() == 3 * 8 * 120
    _close(got.numpy(), want)
    assert (torch.exp(got)[..., ~torch.ones(16, 16, dtype=torch.bool).tril()] == 0).all()


@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunked_matches_jax_and_the_recurrence(init):
    """y and the final state against JAX's ``ssd_chunked`` (TOL) and against
    the plain recurrence in f64 (1e-4): two groups over 8 heads, 37 steps
    in chunks of 16 (the tail padded with identity steps, so the padded
    state is the unpadded one), with and without ``initial_state``."""
    x, dta, bm, cm, s0 = _ssd_inputs()
    s0 = s0 if init else None
    jy, jf = jax.jit(jssm.ssd_chunked, static_argnums=4)(
        *map(jnp.asarray, (x, dta, bm, cm)), 16, None if s0 is None else jnp.asarray(s0))
    ty, tf = ssm.ssd_chunked(*map(torch.from_numpy, (x, dta, bm, cm)), 16,
                             None if s0 is None else torch.from_numpy(s0))
    assert ty.shape == (2, S, 8, 16) and tf.shape == (2, 8, 16, 16)
    _close(ty.numpy(), jy)
    _close(tf.numpy(), jf)
    ry, rf = _recurrence(x, dta, bm, cm, s0)
    np.testing.assert_allclose(ty.numpy(), ry, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tf.numpy(), rf, rtol=1e-4, atol=1e-4)


def test_ssd_backward_is_finite_and_matches_jax():
    """The -inf above the diagonal leaves no NaN in the gradients, which
    agree with ``jax.grad`` of the same sum."""
    x, dta, bm, cm, s0 = _ssd_inputs(3, length=20)

    def jloss(*a):
        y, f = jssm.ssd_chunked(*a[:4], 16, a[4])
        return jnp.sum(y * y) + jnp.sum(f)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, (x, dta, bm, cm, s0)))
    ins = [torch.from_numpy(v).requires_grad_() for v in (x, dta, bm, cm, s0)]
    y, f = ssm.ssd_chunked(*ins[:4], 16, ins[4])
    tg = torch.autograd.grad((y * y).sum() + f.sum(), ins)
    for a, b in zip(tg, jg, strict=True):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=GRAD_TOL * np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("prev", [None, "zeros", "noise"])
def test_causal_conv_matches_jax(prev):
    """Bit for bit JAX's (the same unrolled adds); a zero tail gives the
    zero-padded result bit for bit."""
    x, w, bias = _x((2, 9, 24), 4), _x((4, 24), 5), _x((24,), 6)
    p = None if prev is None else (np.zeros((2, 3, 24), np.float32) if prev == "zeros"
                                   else _x((2, 3, 24), 7))
    want = jssm._causal_conv(*map(jnp.asarray, (x, w, bias)),
                             prev=None if p is None else jnp.asarray(p))
    got = ssm._causal_conv(*map(torch.from_numpy, (x, w, bias)),
                           prev=None if p is None else torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if prev == "zeros":
        none = ssm._causal_conv(*map(torch.from_numpy, (x, w, bias)))
        assert torch.equal(got, none)


def test_softplus_is_upstreams_without_a_threshold():
    v = np.array([-30.0, -1.0, 0.0, 0.5, 19.0, 21.0, 40.0], np.float32)
    got = ssm.softplus(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.nn.softplus(jnp.asarray(v))))
    assert got[-2] != np.float32(21.0) or np.asarray(jax.nn.softplus(jnp.asarray(v)))[-2] == 21.0


@pytest.fixture(scope="module")
def block():
    """One Mamba-2 block of the reduced config (f32, pquant), JAX's and
    the port's, and a cache of noise."""
    jcfg, cfg = _cfgs(dtype="float32")
    jp = jax.jit(lambda k: jssm.init_mamba_block(k, jcfg)[0])(jax.random.PRNGKey(3))
    d_in, nheads, conv_dim, _ = ssm._dims(cfg)
    cache = {"conv": _x((3, cfg.conv_kernel - 1, conv_dim), 8),
             "state": _x((3, nheads, cfg.ssm_headdim, cfg.ssm_state), 9)}
    return jcfg, cfg, jp, _t(jp), cache


def test_mamba_decode_matches_jax(block):
    """One step from a cache of noise: outputs and the new cache within TOL
    of JAX's, JAX's act-quant decisions replayed."""
    jcfg, cfg, jp, tp, cache = block
    x = _x((3, 1, cfg.d_model), 10)
    rec = []
    with _jax_recording(rec):
        jy, jc = jax.jit(lambda p, x, c: jssm.mamba_decode(p, x, c, jcfg))(
            jp, jnp.asarray(x), jax.tree.map(jnp.asarray, cache))
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    with _port_recording([], rec):
        y, c = ssm.mamba_decode(tp, torch.from_numpy(x), tc, cfg)
    _close(y.numpy(), jy)
    for k in cache:
        _close(c[k].numpy(), jc[k])
        np.testing.assert_array_equal(tc[k].numpy(), cache[k])  # the input is not written
    np.testing.assert_array_equal(c["conv"][:, :-1].numpy(), cache["conv"][:, 1:])


@pytest.mark.parametrize("from_cache", [False, True])
def test_mamba_block_matches_jax(block, from_cache):
    """A 21-token chunk (a padded tail), from scratch and from the cache:
    outputs, conv tail and state within TOL of JAX's (decisions replayed);
    a 2-token chunk keeps part of the old conv tail, as upstream's."""
    jcfg, cfg, jp, tp, cache = block
    xs = {t: _x((3, t, cfg.d_model), 11 + t) for t in (21, 2)}
    jcache = jax.tree.map(jnp.asarray, cache) if from_cache else None
    recs = {t: [] for t in xs}

    def jblocks(p, xs, c):  # both chunk lengths in one compile
        out = {}
        for t in sorted(xs):  # the recording's order
            with _jax_recording(recs[t]):
                out[t] = jssm.mamba_block(p, xs[t], jcfg, return_cache=True, cache=c)
        return out

    jout = jax.jit(jblocks)(jp, {t: jnp.asarray(x) for t, x in xs.items()}, jcache)
    jax.effects_barrier()
    for t, x in xs.items():
        jy, _, jc = jout[t]
        rec = recs[t]
        tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()} if from_cache \
            else None
        with _port_recording([], rec):
            y, aux, c = ssm.mamba_block(tp, torch.from_numpy(x), cfg, return_cache=True,
                                        cache=tcache)
        _close(y.numpy(), jy)
        assert aux.item() == 0.0
        for k in ("conv", "state"):
            assert tuple(c[k].shape) == jc[k].shape
            _close(c[k].numpy(), jc[k])
        if from_cache and t == 2:
            np.testing.assert_array_equal(c["conv"][:, 0].numpy(), cache["conv"][:, -1])


# ---------------------------------------------------------------------------
# the decoupled projection
# ---------------------------------------------------------------------------


def _proj(n, mode="pquant"):
    """A decoupled (32 -> 48, r 8) projection with N experts in both
    packages (and JAX's axes), and x (2, 8, 32)."""
    jp, axes = jdecoupled.init_decoupled_proj(jax.random.PRNGKey(n), 32, 48, 8, num_experts=n)
    jq = JQuantConfig(mode=mode, r=8, num_experts=n)
    q = QuantConfig(mode=mode, r=8, num_experts=n)
    jr = JRouterConfig(num_experts=n, top_k=1) if n > 1 else None
    r = RouterConfig(num_experts=n, top_k=1) if n > 1 else None
    return jp, _t(jp), jq, q, jr, r, _x((2, 8, 32), 20 + n), axes


def test_init_decoupled_proj_tree_matches_jax():
    for n in (1, 4):
        jp = jax.eval_shape(lambda: jdecoupled.init_decoupled_proj(
            jax.random.PRNGKey(0), 32, 48, 8, num_experts=n)[0])
        tp = decoupled.init_decoupled_proj(torch.Generator().manual_seed(0), 32, 48, 8,
                                           num_experts=n, lead=(3,))
        assert [("/".join(map(str, p)), tuple(t.shape)) for p, t in adamw.tree_paths(tp)] == [
            (jax.tree_util.keystr(p, simple=True, separator="/"), (3,) + v.shape)
            for p, v in _leaves(jp)]


@pytest.mark.parametrize("n", [1, 4])
def test_decoupled_proj_training_arm_matches_jax(n):
    """The fake-quant arm at N = 1 and routed top-1 at N = 4 (router
    choices and act-quant decisions replayed): y and aux within TOL, every
    gradient leaf and x's within GRAD_TOL of its largest element."""
    jp, tp, jq, q, jr, r, x, _ = _proj(n)

    def jloss(p, x):
        y, aux = jdecoupled.decoupled_proj(p, x, jq, jr)
        return jnp.sum(y * y) / y.size + aux, (y, aux)

    acts, choices = [], []
    with _jax_recording(acts), _jax_choices(choices):
        (_, (jy, jaux)), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
            jp, jnp.asarray(x))
    leaves = adamw.tree_map(lambda t: t.clone().requires_grad_(), tp)
    xt = torch.from_numpy(x).requires_grad_()
    with _port_recording([], acts), _port_choices([], choices):
        y, aux = decoupled.decoupled_proj(leaves, xt, q, r)
        loss = (y * y).sum() / y.numel() + aux
    grads = torch.autograd.grad(loss, adamw.tree_leaves(leaves) + [xt])
    assert y.shape == (2, 8, 48) and (aux.item() > 0) == (n > 1)
    _close(y.detach().numpy(), jy)
    _close(aux.item(), float(jaux))
    for g, (path, want) in zip(grads, _leaves(jg[0]) + [((), jg[1])], strict=True):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max() + 1e-12, err_msg=str(path))
    paths = ["/".join(map(str, p)) for p, _ in adamw.tree_paths(leaves)]
    assert grads[paths.index("w8_a")].abs().sum() > 0


@pytest.mark.parametrize("n", [1, 4])
def test_decoupled_proj_serving_arms_match_jax(n):
    """The packed export of the projection (the port's, equal to JAX's
    leaf for leaf: integers exact, scales within 1e-6) through both
    packages' serving arms: N = 1 the fused
    first GEMM then ``int8_linear_infer`` (alpha and beta applied after
    both, upstream's order), N = 4 the packed trunk with the routed float
    branch; within TOL of JAX's (decisions replayed); against the
    fake-quant forward within the export's rounding."""
    from repro.train.quantized_serving import quantize_params_for_serving as jexport

    jp, tp, jq, q, jr, r, x, axes = _proj(n)
    cfg = dataclasses.replace(_cfgs()[1], quant=q)
    exported = quantize_params_for_serving({"p": tp}, cfg, packed=True)["p"]
    jexported = jax.jit(lambda p: jexport({"p": p}, {"p": axes}, dataclasses.replace(
        _cfgs()[0], quant=jq), packed=True)[0]["p"])(jp)
    for (pa, a), (pb, b) in zip(_leaves(jax.tree.map(np.asarray, jexported)),
                                _leaves(params_to_numpy(exported)), strict=True):
        assert jax.tree_util.keystr(pa) == jax.tree_util.keystr(pb) and a.dtype == b.dtype
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(pa))
        else:  # the port sums a slice's means in f64 and rounds once
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=jax.tree_util.keystr(pa))
    assert "packed" in exported["w1"] and exported["w8_a"]["q"].shape[0] == n
    acts, choices = [], []
    with _jax_recording(acts), _jax_choices(choices):
        jy, _ = jax.jit(lambda p, x: jdecoupled.decoupled_proj(p, x, jq, jr))(
            jexported, jnp.asarray(x))
    with _port_recording([], acts), _port_choices([], choices):
        y, _ = decoupled.decoupled_proj(exported, torch.from_numpy(x), q, r)
    _close(y.numpy(), jy)
    latent, _ = decoupled.decoupled_proj(tp, torch.from_numpy(x), q, r)
    assert np.abs(y.numpy() - latent.numpy()).max() < 1e-3 * max(1.0, np.abs(y.numpy()).max())


# ---------------------------------------------------------------------------
# the model: forward, loss, the chunk path's errors and freezes
# ---------------------------------------------------------------------------


@functools.cache
def _model(mode: str):
    """JAX's latent params of the reduced model in ``mode`` (f32, remat
    off), one compiled init."""
    jcfg, cfg = _cfgs(quant_mode=mode, dtype="float32", remat=False)
    return jcfg, cfg, jax.jit(lambda k: japi.init_model(k, jcfg)[0])(jax.random.PRNGKey(7))


@pytest.mark.parametrize("mode", ["pquant", "none"])
def test_forward_logits_and_loss_match_jax(mode):
    """Logits of the reduced model (4 layers, f32, 2 x 37 tokens) and the
    loss ``lm_loss`` takes from them within MODEL_TOL of JAX's, its
    act-quant decisions replayed."""
    jcfg, cfg, params = _model(mode)
    batch = _batch(2, S, cfg.vocab_size)
    rec = []
    with _jax_recording(rec):
        jlogits, _ = jax.jit(lambda p, t: japi.forward(p, {"tokens": t}, jcfg))(
            params, jnp.asarray(batch["tokens"]))
    jloss, _ = jlayers.cross_entropy_loss(jlogits, jnp.asarray(batch["labels"]))
    with torch.no_grad(), _port_recording([], rec):
        logits, _ = api.forward(_t(params), _tbatch(batch), cfg)
    with torch.no_grad(), _port_recording([], rec):
        loss, metrics = api.loss_fn(_t(params), _tbatch(batch), cfg)
    assert (len(rec) > 0) == (mode == "pquant")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    assert abs(loss.item() - float(jloss)) <= MODEL_TOL and metrics["aux"].item() == 0.0


def test_two_train_steps_match_jax():
    """``make_train_step`` (probes on) against JAX's jitted step, JAX's
    decisions replayed: losses, gradient norm and QAT metrics; every leaf
    after the steps; step 1 (lr > 0) moves every mixer leaf."""
    jcfg, cfg, params = _model("pquant")
    tparams = _t(params)
    batches = [_batch(2, S, cfg.vocab_size, seed=10 + i) for i in range(2)]
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
        assert set(a) == set(b) and "qat_branch_share8" in a
        for k in ("loss", "nll"):
            assert abs(a[k] - b[k]) <= MODEL_TOL, (k, a[k], b[k])
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=GRAD_RTOL)
        for k in b:
            if k.startswith("qat_"):
                assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-7), k
    paths = ["/".join(map(str, p)) for p, _ in adamw.tree_paths(tparams)]
    for path, before, after, j in zip(paths, adamw.tree_leaves(tparams),
                                      adamw.tree_leaves(state.params),
                                      jax.tree.leaves(jstate.params), strict=True):
        np.testing.assert_allclose(after.numpy(), np.asarray(j), rtol=0, atol=1e-6,
                                   err_msg=path)
        if "/mixer/" in path:
            assert not torch.equal(before, after), path


def test_ragged_lengths_raise_and_inactive_slots_keep_their_state():
    """A ragged chunk raises ``NotImplementedError`` (upstream's message);
    a decode step and a chunk with one slot inactive leave that slot's conv
    tail and state bit for bit, and move the others."""
    _, cfg = _cfgs(dtype="float32")
    params = api.init_model(0, cfg, device=CPU)
    caches = api.init_cache(cfg, 3, 32, torch.float32, device=CPU)
    toks = torch.randint(0, cfg.vocab_size, (3, 5), generator=torch.Generator().manual_seed(1))
    with pytest.raises(NotImplementedError, match="ragged chunk lengths"):
        api.forward_chunk(params, toks, caches, 0, cfg, lengths=torch.tensor([5, 3, 5]))
    api.forward_chunk(params, toks, caches, 0, cfg)
    active = torch.tensor([True, False, True])
    for t in (toks[:, :1], toks[:, 1:4]):
        before = {k: v.clone() for k, v in caches[0]["b0"].items()}
        api.forward_chunk(params, t, caches, 5, cfg, active=active)
        for k, v in caches[0]["b0"].items():
            assert torch.equal(v[:, 1], before[k][:, 1]), k
            assert not torch.equal(v[:, 0], before[k][:, 0]), k


def test_trainer_probe_families_and_cli(tmp_path):
    """The projections' 1-bit trunk probes as ``ffn1`` and its 8-bit
    bottleneck as ``ffn8``, as JAX's ``family_of``; the CLI trains the
    reduced model for 2 steps with probes on."""
    _, cfg = _cfgs()
    for path, _ in adamw.tree_paths(api.init_model(0, cfg, device=CPU)):
        key = "/".join(map(str, path))
        assert probes.family_of(key) == jprobes.family_of(key), key
        if key.endswith(("/w1", "/w8_a", "/w8_b")):
            assert probes.family_of(key) == ("ffn1" if key.endswith("/w1") else "ffn8")
    out = tmp_path / "h.json"
    hist = launch_train.main(["--arch", ARCH, "--reduced", "--steps", "2", "--seq-len", "8",
                              "--global-batch", "2", "--device", "cpu", "--probes",
                              "--log-every", "1", "--history-out", str(out)])
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert json.loads(out.read_text())[-1]["step"] == 1
