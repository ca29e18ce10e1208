"""The RG-LRU hybrid (``models/rglru.py``, RecurrentGemma) in the port
against the JAX package, on the CPU: ``registry.reduced`` of
recurrentgemma-2b (4 layers: one (rec, rec, attn) repeat and the
remainder (rec), d_model 64, lru_width 64, 4 heads over 1 KV head of 16,
window 16, d_ff 96, r 16, vocab 512), JAX's weights converted leaf for
leaf, numpy-seeded inputs, sequences of 37 tokens (past the window).

Tolerances: the gates, the scan, a block and a decode step within rtol
and atol TOL (f32 sums in another order: the scan doubles where XLA's
``associative_scan`` recurses on odd and even elements); the scan against
its plain recurrence in f64 within SCAN_TOL, its gradients within
GRAD_TOL of each leaf's largest element; the model's logits and loss
within MODEL_TOL with JAX's act-quant decisions replayed (a code can
round either way between two frameworks) and in mode "none" as computed;
two training steps with the decisions replayed, as
``tests/test_torch_ssm.py``.
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
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.telemetry import probes as jprobes
from repro.train import trainer as jtrainer
from repro_torch.configs import registry
from repro_torch.configs.base import param_count
from repro_torch.launch import train as launch_train
from repro_torch.models import api, rglru, transformer
from repro_torch.optim import adamw
from repro_torch.telemetry import probes
from repro_torch.train import trainer
from test_torch_experts import CPU, GRAD_RTOL, _batch, _leaves, _t, _tbatch
from test_torch_probes import _port_replay
from test_torch_train import _jax_recording, _port_recording
from test_torch_train import _torch_one_thread  # noqa: F401  (autouse)

ARCH = "recurrentgemma-2b"
TOL = 1e-5
SCAN_TOL = 1e-5
CANCEL_ULPS = 4  # f32 units of a^2 that reach the gate's 1 - a^2 (see the gates' test)
GRAD_TOL = 1e-4
MODEL_TOL = 1e-4
S = 37  # past the reduced window (16): every ring wraps
TOTAL = 40
# the three archs of the JAX registry the port ported last
OTHERS = ("granite-20b", "deepseek-coder-33b", "phi-3-vision-4.2b")
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


def _plan(segs, spec_cls):
    return [(s.repeats, tuple(spec_cls(b.mixer, b.ffn, b.window) for b in s.blocks),
             s.first_layer) for s in segs]


# ---------------------------------------------------------------------------
# the config and the segment plan
# ---------------------------------------------------------------------------


def test_config_equals_jax_and_param_count():
    """Field for field JAX's config in the four modes, full and reduced;
    ``param_count`` equal (its "rec" arm: 1-bit projections, FP gates and
    Lambda); the three last archs and whisper-large-v3 build."""
    for mode in MODES:
        j = jregistry.get_config(ARCH, quant_mode=mode)
        t = registry.get_config(ARCH, quant_mode=mode)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert dataclasses.asdict(registry.reduced(t)) == dataclasses.asdict(
            jregistry.reduced(j))
        assert param_count(t) == jparam_count(j)
        assert param_count(registry.reduced(t)) == jparam_count(jregistry.reduced(j))
    assert abs(param_count(registry.get_config(ARCH))["total"] / 1e9 - 2.7) / 2.7 < 0.15
    assert registry.NOT_PORTED == ()
    for arch in OTHERS:  # built now, field for field JAX's
        assert dataclasses.asdict(registry.get_config(arch)) == dataclasses.asdict(
            jregistry.get_config(arch))
    assert registry.get_config("whisper-large-v3").family == "encdec"


@pytest.mark.parametrize("full", [False, True])
def test_segment_plan_equals_jax(full):
    """JAX's segments and ``BlockSpec``s: at full size 8 repeats of (rec,
    rec, attn) and the remainder (rec, rec) from layer 24, reduced one
    repeat and the remainder (rec) from layer 3; every block, rec too,
    with the window ``layer_window`` gives."""
    j = jregistry.get_config(ARCH)
    t = registry.get_config(ARCH)
    if not full:
        j, t = jregistry.reduced(j), registry.reduced(t)
    want = _plan(jtransformer.build_segments(j), transformer.BlockSpec)
    got = _plan(transformer.build_segments(t), transformer.BlockSpec)
    assert got == want
    w = t.window_size
    rec, attn = (transformer.BlockSpec("rec", "dense", w),
                 transformer.BlockSpec("attn", "dense", w))
    assert got == ([(8, (rec, rec, attn), 0), (1, (rec, rec), 24)] if full
                   else [(1, (rec, rec, attn), 0), (1, (rec,), 3)])
    for layer in range(t.n_layers):
        assert transformer.layer_window(t, layer) == jtransformer.layer_window(j, layer) == w


@pytest.mark.parametrize("mode", ["pquant", "none"])
def test_init_and_cache_trees_match_jax(mode):
    """The params tree JAX's leaf for leaf (paths, shapes, dtypes: ``wx``,
    ``wy``, ``wout``, ``wa``, ``wi`` as {"w"}, ``lam``, ``conv_w``,
    ``conv_b``, each rec block with its FFN); the cache tree too in both
    layouts: {"h" f32, "conv"} for a rec block, the dense ring of the
    window for the attention block, nothing on the paged pool."""
    jcfg, cfg = _cfgs(quant_mode=mode)
    jparams = jax.eval_shape(lambda: japi.init_model(jax.random.PRNGKey(0), jcfg)[0])
    tparams = api.init_model(0, cfg, device=CPU)
    got = [("/".join(map(str, p)), tuple(t.shape), str(t.dtype)[6:])
           for p, t in adamw.tree_paths(tparams)]
    want = [(jax.tree_util.keystr(p, simple=True, separator="/"), v.shape, str(v.dtype))
            for p, v in _leaves(jparams)]
    assert got == want
    mixer = tparams["segments"][1]["b0"]["mixer"]
    assert sorted(mixer) == ["conv_b", "conv_w", "lam", "wa", "wi", "wout", "wx", "wy"]
    assert "ffn" in tparams["segments"][1]["b0"]
    a = torch.sigmoid(mixer["lam"]) ** cfg.rglru_c
    assert bool(((a > 0.9 - 1e-5) & (a < 0.999 + 1e-5)).all())
    jc = jax.eval_shape(lambda: japi.init_cache(jcfg, 2, 24, jnp.bfloat16)[0])
    for layout in ("dense", "paged"):
        c = api.init_cache(cfg, 2, 24, torch.bfloat16, device=CPU, layout=layout, block_size=8)
        assert [("/".join(map(str, p)), tuple(t.shape), str(t.dtype)[6:])
                for p, t in adamw.tree_paths(c)] == [
            (jax.tree_util.keystr(p, simple=True, separator="/"), v.shape, str(v.dtype))
            for p, v in _leaves(jc)]
        assert c[0]["b0"]["h"].dtype == torch.float32
        assert c[0]["b2"]["k"].shape[1] == cfg.window_size  # the ring: min(window, max_len)


# ---------------------------------------------------------------------------
# the gates, the scan
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def block():
    """One RG-LRU block of the reduced config (f32, pquant), JAX's and
    the port's, and a cache of noise."""
    jcfg, cfg = _cfgs(dtype="float32")
    jp = jax.jit(lambda k: jrglru.init_rglru_block(k, jcfg)[0])(jax.random.PRNGKey(3))
    w = cfg.lru_width
    cache = {"h": _x((3, w), 8), "conv": _x((3, cfg.conv_kernel - 1, w), 9)}
    return jcfg, cfg, jp, _t(jp), cache


def test_rglru_gates_match_jax(block):
    """log_a within TOL of JAX's.  The gated input sqrt(1 - a^2) (i x)
    cancels in 1 - a^2 where a is near 1 (a^c >= 0.9 at init): a few ulps
    of a^2 become a relative error of ulps / (1 - a^2) there, on each
    framework's own ``exp``.  So each element is held within TOL plus
    CANCEL_ULPS f32 units of |i x| / sqrt(1 - a^2) (a from the f64
    evaluation of the same formula), and so is JAX's against that f64
    evaluation: the allowance is the formula's, not the port's."""
    jcfg, cfg, jp, tp, _ = block
    x = _x((3, 9, cfg.lru_width), 1) * 3
    jla, jg = jax.jit(lambda p, x: jrglru._rglru_gates(p, x, jcfg))(jp, jnp.asarray(x))
    la, g = rglru._rglru_gates(tp, torch.from_numpy(x), cfg)
    assert la.dtype == g.dtype == torch.float32
    _close(la.numpy(), jla)
    assert bool((la < 0).all())
    p64 = {k: (v.double() if torch.is_tensor(v) else {"w": v["w"].double()})
           for k, v in tp.items()}
    la64, g64 = rglru._rglru_gates(p64, torch.from_numpy(x).double(), cfg)
    ix = torch.abs(g64) / torch.sqrt(torch.clamp_min(1 - torch.exp(2 * la64), 1e-12))
    allow = (TOL * (1 + g64.abs()) + CANCEL_ULPS * 2.0**-24 * ix / torch.sqrt(
        torch.clamp_min(1 - torch.exp(2 * la64), 1e-12))).numpy()
    for got in (g.numpy(), np.asarray(jg)):
        assert (np.abs(got - g64.numpy()) <= allow).all()
    assert (np.abs(g.numpy() - np.asarray(jg)) <= 2 * allow).all()


def _scan_inputs(seed=0, b=2, length=S, w=24):
    rng = np.random.default_rng(seed)
    log_a = -np.abs(rng.standard_normal((b, length, w))).astype(np.float32) * 0.3
    x = rng.standard_normal((b, length, w)).astype(np.float32)
    return log_a, x


def _recurrence(log_a, x):
    """h_t = exp(log_a_t) h_{t-1} + x_t, h_0 = 0, in f64."""
    h = np.zeros(log_a[:, 0].shape)
    out = []
    for t in range(log_a.shape[1]):
        h = np.exp(log_a[:, t].astype(np.float64)) * h + x[:, t]
        out.append(h)
    return np.stack(out, 1)


@pytest.mark.parametrize("length", [1, 2, 16, S, 64])
def test_assoc_scan_matches_jax_and_the_recurrence(length):
    """Against JAX's ``associative_scan`` (TOL) and the plain recurrence
    in f64 (SCAN_TOL), at lengths 1, powers of two and between."""
    la, x = _scan_inputs(length=length)
    got = rglru._assoc_scan(torch.from_numpy(la), torch.from_numpy(x)).numpy()
    _close(got, jax.jit(jrglru._assoc_scan)(jnp.asarray(la), jnp.asarray(x)))
    np.testing.assert_allclose(got, _recurrence(la, x), rtol=SCAN_TOL, atol=SCAN_TOL)


def test_assoc_scan_backward_matches_jax():
    """The gradients of a sum of the scan's squares against ``jax.grad``
    of the same, each within GRAD_TOL of its largest element."""
    la, x = _scan_inputs(3)

    def jloss(la, x):
        h = jrglru._assoc_scan(la, x)
        return jnp.sum(h * h)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(la), jnp.asarray(x))
    ins = [torch.from_numpy(v).requires_grad_() for v in (la, x)]
    h = rglru._assoc_scan(*ins)
    tg = torch.autograd.grad((h * h).sum(), ins)
    for a, b in zip(tg, jg, strict=True):
        b = np.asarray(b)
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=GRAD_TOL * np.abs(b).max())


# ---------------------------------------------------------------------------
# a block, a decode step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("from_cache", [False, True])
def test_rglru_block_matches_jax(block, from_cache):
    """A 21-token and a 2-token chunk, from scratch and from the cache:
    outputs, state and conv tail within TOL of JAX's (its act-quant
    decisions replayed); a 2-token chunk from the cache keeps part of the
    old conv tail, as upstream's; the cache passed in is not written."""
    jcfg, cfg, jp, tp, cache = block
    xs = {t: _x((3, t, cfg.d_model), 11 + t) for t in (21, 2)}
    jcache = jax.tree.map(jnp.asarray, cache) if from_cache else None
    recs = {t: [] for t in xs}

    def jblocks(p, xs, c):  # both chunk lengths in one compile
        out = {}
        for t in sorted(xs):  # the recording's order
            with _jax_recording(recs[t]):
                out[t] = jrglru.rglru_block(p, xs[t], jcfg, return_cache=True, cache=c)
        return out

    jout = jax.jit(jblocks)(jp, {t: jnp.asarray(x) for t, x in xs.items()}, jcache)
    jax.effects_barrier()
    for t, x in xs.items():
        jy, jc = jout[t]
        tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()} if from_cache \
            else None
        with _port_recording([], recs[t]):
            y, c = rglru.rglru_block(tp, torch.from_numpy(x), cfg, return_cache=True,
                                     cache=tcache)
        _close(y.numpy(), jy)
        for k in ("h", "conv"):
            assert tuple(c[k].shape) == jc[k].shape
            _close(c[k].numpy(), jc[k])
        if from_cache:
            for k, v in cache.items():
                np.testing.assert_array_equal(tcache[k].numpy(), v)
            if t == 2:
                np.testing.assert_array_equal(c["conv"][:, 0].numpy(), cache["conv"][:, -1])
        with torch.no_grad(), _port_recording([], recs[t]):
            alone = rglru.rglru_block(tp, torch.from_numpy(x), cfg, cache=tcache)
        np.testing.assert_array_equal(alone.numpy(), y.numpy())


def test_rglru_decode_matches_jax(block):
    """One step from a cache of noise: output and the new cache within TOL
    of JAX's, its act-quant decisions replayed; the conv window rolls by
    one; the input cache is not written."""
    jcfg, cfg, jp, tp, cache = block
    x = _x((3, 1, cfg.d_model), 10)
    rec = []
    with _jax_recording(rec):
        jy, jc = jax.jit(lambda p, x, c: jrglru.rglru_decode(p, x, c, jcfg))(
            jp, jnp.asarray(x), jax.tree.map(jnp.asarray, cache))
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    with _port_recording([], rec):
        y, c = rglru.rglru_decode(tp, torch.from_numpy(x), tc, cfg)
    _close(y.numpy(), jy)
    for k in cache:
        _close(c[k].numpy(), jc[k])
        np.testing.assert_array_equal(tc[k].numpy(), cache[k])
    np.testing.assert_array_equal(c["conv"][:, :-1].numpy(), cache["conv"][:, 1:])


def test_init_rglru_cache_matches_jax():
    jcfg, cfg = _cfgs()
    jc, _ = jrglru.init_rglru_cache(jcfg, 3, jnp.bfloat16)
    tc = rglru.init_rglru_cache(cfg, 3, torch.bfloat16, lead=(2,), device=CPU)
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in tc.items()} == {
        k: ((2,) + v.shape, str(v.dtype)) for k, v in jc.items()}
    assert not any(v.any() for v in tc.values())


# ---------------------------------------------------------------------------
# the model: forward, loss, training, the chunk path's errors and freezes
# ---------------------------------------------------------------------------


@functools.cache
def _model(mode: str):
    """JAX's latent params of the reduced model in ``mode`` (f32, remat
    off), one compiled init."""
    jcfg, cfg = _cfgs(quant_mode=mode, dtype="float32", remat=False)
    return jcfg, cfg, jax.jit(lambda k: japi.init_model(k, jcfg)[0])(jax.random.PRNGKey(7))


@pytest.mark.parametrize("mode", MODES)
def test_forward_logits_and_loss_match_jax(mode):
    """Logits of the reduced model (4 layers, f32, 2 x 37 tokens: past the
    window) and the loss ``lm_loss`` takes from them within MODEL_TOL of
    JAX's, its act-quant decisions replayed (mode "none" has none)."""
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
    assert (len(rec) > 0) == (mode != "none")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    assert abs(loss.item() - float(jloss)) <= MODEL_TOL and metrics["aux"].item() == 0.0


def test_two_train_steps_match_jax():
    """``make_train_step`` (probes on) against JAX's jitted step, JAX's
    decisions replayed: losses, gradient norm and QAT metrics; every leaf
    after the steps; step 1 (lr > 0) moves every RG-LRU leaf (the gates,
    Lambda and the conv too)."""
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
    moved = []
    for path, before, after, j in zip(paths, adamw.tree_leaves(tparams),
                                      adamw.tree_leaves(state.params),
                                      jax.tree.leaves(jstate.params), strict=True):
        np.testing.assert_allclose(after.numpy(), np.asarray(j), rtol=0, atol=1e-6,
                                   err_msg=path)
        if "/b0/mixer/" in path:
            assert not torch.equal(before, after), path
            moved.append(path.split("/mixer/")[1])
    assert {"lam", "conv_w", "wa/w", "wi/w", "wx/w"} <= set(moved)


def test_ragged_lengths_raise_and_inactive_slots_keep_their_state():
    """A ragged chunk raises ``NotImplementedError`` (upstream's message);
    a decode step and a chunk with one slot inactive leave that slot's
    RG-LRU state, conv tail and ring bit for bit, and move the others."""
    _, cfg = _cfgs(dtype="float32")
    params = api.init_model(0, cfg, device=CPU)
    caches = api.init_cache(cfg, 3, 32, torch.float32, device=CPU)
    toks = torch.randint(0, cfg.vocab_size, (3, 5), generator=torch.Generator().manual_seed(1))
    with pytest.raises(NotImplementedError, match="ragged chunk lengths"):
        api.forward_chunk(params, toks, caches, 0, cfg, lengths=torch.tensor([5, 3, 5]))
    api.forward_chunk(params, toks, caches, 0, cfg)
    active = torch.tensor([True, False, True])
    for t in (toks[:, :1], toks[:, 1:4]):
        before = [{k: v.clone() for k, v in c.items()} for c in
                  (caches[0]["b0"], caches[0]["b2"], caches[1]["b0"])]
        api.forward_chunk(params, t, caches, 5, cfg, active=active)
        for old, new in zip(before, (caches[0]["b0"], caches[0]["b2"], caches[1]["b0"])):
            for k, v in new.items():
                assert torch.equal(v[1], old[k][1]), k
                assert not torch.equal(v[0], old[k][0]), k


def test_trainer_probe_families_and_cli(tmp_path):
    """Every leaf's probe family JAX's (an RG-LRU mixer's leaves, as an
    attention mixer's, are "attn"); the CLI trains the reduced hybrid for 2
    steps with probes on."""
    _, cfg = _cfgs()
    for path, _ in adamw.tree_paths(api.init_model(0, cfg, device=CPU)):
        key = "/".join(map(str, path))
        assert probes.family_of(key) == jprobes.family_of(key), key
        if "/mixer/w" in key:  # the projections and gates
            assert probes.family_of(key) == "attn", key
    out = tmp_path / "h.json"
    hist = launch_train.main(["--arch", ARCH, "--reduced", "--steps", "2", "--seq-len", "8",
                              "--global-batch", "2", "--device", "cpu", "--probes",
                              "--log-every", "1", "--history-out", str(out)])
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert json.loads(out.read_text())[-1]["step"] == 1
