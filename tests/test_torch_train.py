"""The port's QAT training step against the JAX package, on the CPU, on
``registry.reduced`` of pquant-100m in f32 in all four modes: the same
weights (made in JAX, converted leaf for leaf) and numpy-seeded batches go
through both.

Tolerances:

* quantizer gradients (the STE, the clip's half gradient at a rail, |x|'s
  gradient of 1 at 0): within QGRAD_TOL of the largest gradient of the
  slice that shares a scale, AbsMax elements (a sum over the slice)
  within AMAX_TOL; forwards bit for bit the pre-STE formulas (frozen
  below as ``_before_*``);
* the loss: the frameworks sum in other orders, ~1e-6 apart, but a
  last-ulp difference ahead of a per-token int8 activation quantization
  can round one code the other way (a "flip"), which moves its token's
  logits by up to ATOL_FLIP (``test_torch_decoder.py``).  Flips are found,
  not guessed: both forwards record every act-quant site's inputs x *
  gamma and the elements holding max |x| (the port by wrapping
  ``quantize_activations_int8``, JAX by an ordered ``jax.debug.callback``
  in the jitted program that computes its gradients).  A primary flip is
  a code, or a row's choice of AbsMax elements among equal maxima, that
  differs where both inputs agree within TIE_NOISE; at most FLIP_RATE of
  the codes (a wrong rounding or scale decides far more).  The loss is
  held within ATOL plus 2 * ATOL_FLIP times the share of tokens that met a
  differing code;
* the model's gradients: every leaf within GRAD_RTOL of its largest
  element, with JAX's act-quant decisions replayed in the port's forward
  (a flip moves a gradient by far more than rounding: a tie among AbsMax
  elements splits gamma's gradient between them, or not), and as the port
  computes them wherever no primary flip occurred;
* AdamW given JAX's gradients: rtol OPT_RTOL; the global norm, and every
  value behind an active clip, GNORM_RTOL (f32 sums in another order);
  the schedules: rtol OPT_RTOL;
* ``make_train_step`` over 3 steps, JAX's act-quant decisions replayed:
  losses within ATOL, the gradient norm and the moments within GRAD_RTOL,
  each parameter's total update within STEP_RTOL of its leaf's largest
  update, but for at most STEP_SIGN_SHARE of the elements, which stay
  within 2 * STEP_MAX_RATIO * the summed lr (Adam's early updates are
  about lr * sign(g): an element whose gradient is within float noise of
  0 may move either way).
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import quantization as jq
from repro.models import api as japi
from repro.models.layers import cross_entropy_loss as jcross_entropy_loss
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.train import trainer as jtrainer
from repro_torch.configs import registry
from repro_torch.convert import params_from_numpy
from repro_torch.core import quantization as q
from repro_torch.models import api
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.optim import adamw, schedule
from repro_torch.train import trainer

MODES = ["pquant", "bitnet", "bitnet158", "none"]
CPU = torch.device("cpu")
QGRAD_TOL = 1e-6
AMAX_TOL = 1e-4
ATOL = 1e-5
ATOL_FLIP = 5e-2
FLIP_RATE = 1e-4
TIE_NOISE = 1e-3
GRAD_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """Runs a module's torch ops on one intra-op thread, then restores the
    count.  Once JAX has run in a process, XLA's worker threads and torch's
    intra-op pool contend, and a port step at the reduced sizes runs many
    times slower on many threads than on one.  Other modules import this
    fixture to take it too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
OPT_RTOL = 1e-6
GNORM_RTOL = 1e-5
STEP_RTOL = 1e-3
STEP_SIGN_SHARE = 1e-3
STEP_MAX_RATIO = 1.5
BATCH, SEQ = 2, 16


def _cfgs(mode, **kw):
    jcfg = jregistry.reduced(jregistry.get_config("pquant-100m", quant_mode=mode))
    cfg = registry.reduced(registry.get_config("pquant-100m", quant_mode=mode))
    return (dataclasses.replace(jcfg, dtype="float32", **kw),
            dataclasses.replace(cfg, dtype="float32", **kw))


def _batch(b, s, vocab, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# (a), (b): the quantizers
# ---------------------------------------------------------------------------


def _weights(seed=0, shape=(64, 48)):
    """Normal weights with zeros in them, one element on the int8 rail
    twice (two tied maxima) and a zero row."""
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[0, :6] = 0.0
    w[3, 5] = w[7, 9] = -np.abs(w).max()
    w[5] = 0.0
    return w


# name -> (port fn, JAX fn, the gradient's slices that share one scale, as
# rows; True where an AbsMax picks that scale); each fn returns (values, scale)
QUANTIZERS = {
    "binarize": (q.binarize_weights, jq.binarize_weights, lambda a: a.reshape(1, -1), False),
    "binarize_grouped": (lambda w: q.binarize_weights_grouped(w, 16),
                         lambda w: jq.binarize_weights_grouped(w, 16),
                         lambda a: a.reshape(-1, 16), False),
    "binarize_channelwise": (q.binarize_weights_channelwise, jq.binarize_weights_channelwise,
                             lambda a: a.T, False),
    "ternarize": (q.ternarize_weights, jq.ternarize_weights, lambda a: a.reshape(1, -1), False),
    "int8": (q.quantize_weights_int8, jq.quantize_weights_int8, lambda a: a.reshape(1, -1),
             True),
    "int8_axis0": (lambda w: q.quantize_weights_int8(w, axis=0),
                   lambda w: jq.quantize_weights_int8(w, axis=0), lambda a: a.T, True),
    "int8_stacked": (lambda w: q.quantize_weights_int8_stacked(w.reshape(4, 16, 48)),
                     lambda w: jq.quantize_weights_int8_stacked(w.reshape(4, 16, 48)),
                     lambda a: a.reshape(4, -1), True),
    "act_int8": (q.quantize_activations_int8, jq.quantize_activations_int8, lambda a: a, True),
}


def _objective(out, cot, cot_s, lib):
    """A scalar of both outputs with fixed cotangents."""
    vals, scale = out
    return lib.sum(vals.reshape(cot.shape) * cot) + lib.sum(scale * cot_s)


@pytest.mark.parametrize("name", list(QUANTIZERS))
def test_quantizer_gradient_matches_jax(name):
    """Within QGRAD_TOL of the largest gradient of the slice that shares a
    scale; an AbsMax element, whose gradient sums the whole slice in f32
    (each framework in its own order), within AMAX_TOL of it."""
    port, ref, slices, absmax = QUANTIZERS[name]
    grad_ref = jax.jit(jax.grad(lambda x, c, cs: _objective(ref(x), c, cs, jnp)))
    for seed in range(3):
        w = _weights(seed)
        rng = np.random.default_rng(seed + 1)
        cot = rng.standard_normal(w.shape).astype(np.float32)
        cot_s = rng.standard_normal(np.shape(ref(jnp.asarray(w))[1])).astype(np.float32)
        want = np.asarray(grad_ref(jnp.asarray(w), jnp.asarray(cot), jnp.asarray(cot_s)))
        wt = torch.from_numpy(w).requires_grad_()
        _objective(port(wt), torch.from_numpy(cot), torch.from_numpy(cot_s), torch).backward()
        err = slices(np.abs(wt.grad.numpy() - want))
        scale = slices(np.abs(want)).max(-1, keepdims=True)
        tol = np.full(err.shape, QGRAD_TOL) * scale
        if absmax:
            a = slices(np.abs(w))
            tol[a == a.max(-1, keepdims=True)] = (AMAX_TOL * scale.repeat(a.shape[-1], -1))[
                a == a.max(-1, keepdims=True)]
        assert (err <= tol).all(), (name, seed, (err / scale).max())


def test_ternary_rail_gradient_is_half_as_in_jax():
    """Every weight that rounds to +-1 sits on the clip's rail: JAX passes
    half the gradient there, ``torch.clamp`` all of it.  The clamp form
    misses JAX's gradient by far; the port's clip holds it."""
    w = _weights()
    cot = np.random.default_rng(1).standard_normal(w.shape).astype(np.float32)
    want = np.asarray(jax.grad(lambda x: jnp.sum(jq.ternarize_weights(x)[0] * cot))(jnp.asarray(w)))

    def clamp_form(x):  # the port's ternarize but for the clip
        lam = torch.mean(torch.where(x >= 0, x, -x)) + q.EPS
        return torch.clamp(q.ste_round(x / lam), -1.0, 1.0) * lam

    wt = torch.from_numpy(w).requires_grad_()
    torch.sum(clamp_form(wt) * torch.from_numpy(cot)).backward()
    assert np.abs(wt.grad.numpy() - want).max() > 1.0
    wt.grad = None
    torch.sum(q.ternarize_weights(wt)[0] * torch.from_numpy(cot)).backward()
    np.testing.assert_allclose(wt.grad.numpy(), want, rtol=QGRAD_TOL, atol=QGRAD_TOL)


def test_ste_sign_round_and_clip_gradients():
    x = torch.tensor([0.0, -0.0, 1.5, -2.5, 127.0, -127.0, 126.0, 128.0], requires_grad=True)
    s = q.ste_sign(x)
    assert s.tolist() == [1.0, 1.0, 1.0, -1.0, 1.0, -1.0, 1.0, 1.0]
    assert q.ste_round(x).tolist() == [0.0, 0.0, 2.0, -2.0, 127.0, -127.0, 126.0, 128.0]
    (g,) = torch.autograd.grad(s.sum() + q.ste_round(x).sum(), x)
    assert g.tolist() == [2.0] * 8
    (g,) = torch.autograd.grad(q.clip(x, -127.0, 127.0).sum(), x)
    want = jax.grad(lambda v: jnp.sum(jnp.clip(v, -127.0, 127.0)))(jnp.asarray(x.detach().numpy()))
    assert g.tolist() == np.asarray(want).tolist() == [1, 1, 1, 1, 0.5, 0.5, 1, 0]


# the quantizers as they were before the straight-through estimator: the
# forward values must not move


def _before_sign(x):
    one = torch.ones((), dtype=x.dtype)
    return torch.where(x >= 0, one, -one)


def _before_binarize(w):
    mu, lam = torch.mean(w), torch.mean(torch.abs(w)) + q.EPS
    return _before_sign(w - mu) * lam, lam


def _before_binarize_grouped(w, g):
    wg = w.reshape(w.shape[0], -1, g)
    mu = torch.mean(wg, dim=-1, keepdim=True)
    lam = torch.mean(torch.abs(wg), dim=-1, keepdim=True) + q.EPS
    return (_before_sign(wg - mu) * lam).reshape(w.shape), lam.squeeze(-1)


def _before_binarize_channelwise(w):
    mu = torch.mean(w, dim=0, keepdim=True)
    lam = torch.mean(torch.abs(w), dim=0, keepdim=True) + q.EPS
    return _before_sign(w - mu) * lam, lam.squeeze(0)


def _before_ternarize(w):
    lam = torch.mean(torch.abs(w)) + q.EPS
    return torch.clamp(torch.round(w / lam), -1.0, 1.0) * lam, lam


def _before_int8(w, axis=None, red=None):
    if red is not None:
        amax = torch.amax(torch.abs(w), dim=red, keepdim=True)
    elif axis is None:
        amax = torch.amax(torch.abs(w))
    else:
        amax = torch.amax(torch.abs(w), dim=axis, keepdim=True)
    scale = q.fdiv(q.INT8_QMAX, amax + q.EPS)
    qq = torch.clamp(torch.round(w * scale), -q.INT8_QMAX, q.INT8_QMAX)
    return qq / scale, scale


def _before_act(x):
    gamma = q.act_scale_int8(x)
    qq = torch.clamp(torch.round(x.float() * gamma), -q.INT8_QMAX, q.INT8_QMAX)
    return (qq / gamma).to(x.dtype), gamma


BEFORE = {
    "binarize": _before_binarize,
    "binarize_grouped": lambda w: _before_binarize_grouped(w, 16),
    "binarize_channelwise": _before_binarize_channelwise,
    "ternarize": _before_ternarize,
    "int8": _before_int8,
    "int8_axis0": lambda w: _before_int8(w, axis=0),
    "int8_stacked": lambda w: _before_int8(w.reshape(4, 16, 48), red=(1, 2)),
    "act_int8": _before_act,
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(QUANTIZERS))
def test_quantizer_forward_unchanged(name, dtype):
    for seed in range(3):
        w = torch.from_numpy(_weights(seed)).to(dtype)
        got, want = QUANTIZERS[name][0](w), BEFORE[name](w)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        # and with grad on: the STE returns the quantized values themselves
        got = QUANTIZERS[name][0](w.clone().requires_grad_())
        assert torch.equal(got[0].detach(), want[0]), name


# ---------------------------------------------------------------------------
# (c), (d): the loss and the whole model's gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = jcross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                               None if mask is None else jnp.asarray(mask))
    tmask = None if mask is None else torch.from_numpy(mask)
    for dt in (torch.float32, torch.bfloat16):  # f32 whatever the logits' dtype
        x = torch.from_numpy(logits)
        got = cross_entropy_loss(x.to(dt), torch.from_numpy(labels), tmask)
        ref = want if dt == torch.float32 else jcross_entropy_loss(
            jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask))
        for a, b in zip(got, ref):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.item(), float(b), rtol=1e-6)
    if masked:  # an empty mask divides by 1, not by 0
        zero = np.zeros_like(mask)
        got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                 torch.from_numpy(zero))
        assert [a.item() for a in got] == [0.0, 0.0]


def _decisions(v, x):
    """What one act-quant site decides: the scaled inputs v = x * gamma
    (their rounding gives the codes) and, per row, the elements that hold
    max |x| (the AbsMax that sets gamma; its gradient splits evenly over a
    tie)."""
    a = np.abs(x)
    return v, a == a.max(-1, keepdims=True)


@contextlib.contextmanager
def _jax_recording(record: list):
    """While open, every act-quant site of the JAX package's forward appends
    its decisions to ``record``, by an ordered callback inside the jitted
    program itself (run it with remat off: each site runs once)."""
    orig = jq.quantize_activations_int8

    def tapped(x):
        xf = x.astype(jnp.float32)
        jax.debug.callback(
            lambda v, x: record.append(_decisions(np.asarray(v), np.asarray(x))),
            xf * jq.act_scale_int8(x), xf, ordered=True)
        return orig(x)

    jq.quantize_activations_int8 = tapped
    try:
        yield
        jax.effects_barrier()
    finally:
        jq.quantize_activations_int8 = orig


def _replaying(decisions):
    """``quantize_activations_int8`` that takes its codes and its AbsMax
    elements from ``decisions`` (another forward's, site by site) and
    computes the rest as the port does: the STE, the clip, and gamma from
    the mean of the chosen maxima (their gradient split evenly)."""
    it = iter(decisions)

    def quantize(x):
        v, ties = next(it)
        xf = x.float()
        mask = torch.from_numpy(ties.reshape(x.shape))
        a = torch.where(xf >= 0, xf, -xf)  # |x| with JAX's gradient at 0
        amax = torch.sum(a * mask, -1, keepdim=True) / torch.sum(mask, -1, keepdim=True)
        gamma = q.fdiv(q.INT8_QMAX, amax + q.EPS)
        codes = torch.from_numpy(np.round(v).reshape(x.shape))
        qq = q.clip(q.ste(xf * gamma, codes), -q.INT8_QMAX, q.INT8_QMAX)
        return (qq / gamma).to(x.dtype), gamma

    return quantize


@contextlib.contextmanager
def _port_recording(record: list, replay=None):
    """While open, every act-quant site of the port appends its decisions
    to ``record``; with ``replay``, each site then takes its decisions from
    that record instead (run it with remat off: each site runs once)."""
    orig = q.quantize_activations_int8
    inner = orig if replay is None else _replaying(replay)

    def tapped(x):
        xf = x.detach().float()
        record.append(_decisions((xf * q.act_scale_int8(xf)).numpy(), xf.numpy()))
        return inner(x)

    q.quantize_activations_int8 = tapped
    try:
        yield
    finally:
        q.quantize_activations_int8 = orig


def _jax_loss_grads(jcfg, params, batch):
    """JAX's (loss, metrics, grads) of ``api.loss_fn`` from one jitted
    ``value_and_grad``, and the act-quant decisions of its forward."""
    record = []
    with _jax_recording(record):
        fn = jax.jit(jax.value_and_grad(lambda p, b: japi.loss_fn(p, b, jcfg), has_aux=True))
        (loss, metrics), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads, record


def _port_loss_grads(cfg, tparams, batch, replay=None):
    """The port's (loss, metrics, grads) of ``api.loss_fn`` and the
    act-quant decisions of its forward (``replay``: see _port_recording)."""
    record = []
    with _port_recording(record, replay):
        leaves = adamw.tree_map(lambda p: p.detach().clone().requires_grad_(), tparams)
        loss, metrics = api.loss_fn(leaves, _tbatch(batch), cfg)
        forward = list(record)  # remat runs each layer again in the backward
        flat = torch.autograd.grad(loss, adamw.tree_leaves(leaves), materialize_grads=True)
    return loss.item(), {k: v.item() for k, v in metrics.items()}, flat, forward


def _flips(rec_a, rec_b) -> dict:
    """Two forwards' records compared site by site.  A primary flip is a
    rounding tie decided two ways: a code that differs where both inputs x
    * gamma agree within TIE_NOISE, or a row whose AbsMax elements differ
    where its inputs agree so; the other differing codes follow from a
    primary flip upstream.  A site has one row a token (the first site
    sets the token count), or is a routed experts' (N, C, D) buffer with
    more rows than tokens, each row one token or a sentinel of zeros; a
    differing buffer row counts as one token met."""
    assert len(rec_a) == len(rec_b)
    primary = differ = codes = buffer_rows = 0
    touched = None
    for (va, ta), (vb, tb) in zip(rec_a, rec_b):
        va, ta = va.reshape(vb.shape), ta.reshape(tb.shape)
        near = np.abs(va - vb) <= TIE_NOISE
        code = np.clip(np.round(va), -127, 127) != np.clip(np.round(vb), -127, 127)
        codes += code.size
        differ += int(code.sum())
        primary += int((code & near).sum()) + int(((ta != tb).any(-1) & near.all(-1)).sum())
        rows = code.reshape(-1, code.shape[-1]).any(-1)
        if touched is not None and rows.size != touched.size:
            buffer_rows += int(rows.sum())
            continue
        touched = rows if touched is None else touched | rows
    if touched is None:  # no act-quant site (mode "none")
        touched = np.zeros(1, bool)
    return {"primary": primary, "differ": differ, "codes": codes,
            "tokens": min(touched.size, int(touched.sum()) + buffer_rows), "of": touched.size}


def _loss_tol(f) -> float:
    """ATOL, plus 2 * ATOL_FLIP (the most one token's nll moves when its
    logits move by ATOL_FLIP) over the share of tokens that met a
    differing code."""
    return ATOL + 2 * ATOL_FLIP * f["tokens"] / f["of"]


@pytest.fixture(scope="module", params=MODES)
def model(request):
    jcfg, cfg = _cfgs(request.param, remat=False)
    params, _ = japi.init_model(jax.random.PRNGKey(7), jcfg)
    return request.param, jcfg, cfg, params, _to_torch(params)


@pytest.fixture(scope="module")
def grads(model):
    """JAX's loss and gradients, the port's as it trains (remat on), and
    the port's replaying JAX's act-quant decisions."""
    mode, jcfg, cfg, params, tparams = model
    batch = _batch(BATCH, SEQ, cfg.vocab_size)
    ref = _jax_loss_grads(jcfg, params, batch)
    got = _port_loss_grads(dataclasses.replace(cfg, remat=True), tparams, batch)
    replayed = _port_loss_grads(cfg, tparams, batch, replay=ref[3])
    return ref, got, replayed


def test_lm_loss_matches_jax(model, grads):
    ref, got, _ = grads
    f = _flips(ref[3], got[3])
    assert f["primary"] <= FLIP_RATE * f["codes"], f
    tol = _loss_tol(f)
    assert abs(got[0] - ref[0]) <= tol, (got[0], ref[0])
    for k in ("nll", "aux"):
        assert abs(got[1][k] - ref[1][k]) <= tol, k
    assert got[1]["aux"] == 0.0


def test_lm_loss_with_mask_matches_jax(model):
    mode, jcfg, cfg, params, tparams = model
    batch = _batch(BATCH, SEQ, cfg.vocab_size, seed=1)
    batch["mask"] = (np.arange(SEQ)[None] < np.array([[SEQ], [5]])).astype(np.float32)
    jloss, jm = jax.jit(lambda p, b: japi.loss_fn(p, b, jcfg))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        loss, m = api.loss_fn(tparams, _tbatch(batch), cfg)
    # within ATOL, or within the reach of one flip on the masked tokens
    tol = ATOL + 2 * ATOL_FLIP / int(batch["mask"].sum())
    assert abs(loss.item() - float(jloss)) <= tol
    assert abs(m["nll"].item() - float(jm["nll"])) <= tol


def _assert_grads_close(got, jgrads, paths):
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(paths) == len(got)
    for (jpath, jg), path, g in zip(jflat, paths, got):
        assert "/".join(str(getattr(e, "key", getattr(e, "idx", ""))) for e in jpath) == \
            "/".join(map(str, path))
        assert tuple(g.shape) == jg.shape and g.dtype == torch.float32
        err = np.abs(_np(g) - np.asarray(jg))
        tol = GRAD_RTOL * np.abs(np.asarray(jg)).max() + 1e-12
        assert err.max() <= tol, (path, err.max(), tol)


def test_model_gradients_match_jax(model, grads):
    """Every leaf of ``jax.grad(api.loss_fn)``, within GRAD_RTOL of its
    largest element: as the port computes it where both forwards decide
    every act-quant tie alike, and else with JAX's decisions replayed."""
    mode, jcfg, cfg, params, tparams = model
    ref, got, replayed = grads
    paths = [p for p, _ in adamw.tree_paths(tparams)]
    f = _flips(ref[3], got[3])
    assert f["primary"] <= FLIP_RATE * f["codes"], f
    assert abs(replayed[0] - ref[0]) <= ATOL  # the same decisions give the same loss
    _assert_grads_close(replayed[2], ref[2], paths)
    if f["primary"] == 0:
        _assert_grads_close(got[2], ref[2], paths)


def test_remat_gives_the_same_gradients_bit_for_bit(model):
    """On each mode's weights of the ``model`` fixture (shared: no JAX init
    of its own)."""
    _, _, cfg, _, tparams = model
    batch = _batch(BATCH, SEQ, cfg.vocab_size, seed=2)
    on = _port_loss_grads(dataclasses.replace(cfg, remat=True), tparams, batch)
    off = _port_loss_grads(dataclasses.replace(cfg, remat=False), tparams, batch)
    assert on[0] == off[0]
    for a, b in zip(on[2], off[2]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (e), (f): AdamW and the schedules
# ---------------------------------------------------------------------------


def test_decay_mask_and_global_norm_match_jax(model, grads):
    mode, jcfg, cfg, params, tparams = model
    ref = grads[0]
    want = jax.tree.leaves(jadamw._decay_mask(params, jadamw.AdamWConfig()))
    assert adamw.tree_leaves(adamw._decay_mask(tparams, adamw.AdamWConfig())) == want
    assert any(want) and not all(want)
    np.testing.assert_allclose(adamw.global_norm(_to_torch(ref[2])).item(),
                               float(jadamw.global_norm(ref[2])), rtol=GNORM_RTOL)


_jax_adamw_update = jax.jit(jadamw.adamw_update)


@pytest.mark.parametrize("clipped", [False, True])
def test_adamw_update_matches_jax_over_two_steps(model, grads, clipped):
    """Two updates given JAX's gradients (then a second set drawn from
    numpy), from a state past warm-up, so that lr and the decay are not 0.
    Unclipped (the gradients scaled to norm 0.5, so that the clip scale is
    exactly 1 on both sides): rtol OPT_RTOL.  Clipped (norm 5-8): the clip
    scale carries the global norm's GNORM_RTOL into every moment and
    parameter, so GNORM_RTOL."""
    mode, jcfg, cfg, params, tparams = model
    g1 = grads[0][2]
    rng = np.random.default_rng(5)
    g2 = jax.tree.map(lambda g: jnp.asarray(rng.standard_normal(g.shape).astype(np.float32)), g1)
    if not clipped:
        g1, g2 = (jax.tree.map(lambda x, n=jadamw.global_norm(g): x * (0.5 / n), g)
                  for g in (g1, g2))
    rtol = GNORM_RTOL if clipped else OPT_RTOL
    sched = jschedule.schedule_for_mode(mode, 1000)
    jstate = jadamw.init_adamw(params)._replace(step=jnp.asarray(600, jnp.int32))
    jp = params
    # the port's update works in place: give it copies
    tp = adamw.tree_map(torch.clone, tparams)
    tstate = adamw.init_adamw(tp)._replace(step=torch.tensor(600, dtype=torch.int32))
    tsched = schedule.schedule_for_mode(mode, 1000)
    for g in (g1, g2):
        lr, wd = sched.lr(jstate.step), sched.wd(jstate.step)
        jp, jstate, jmet = _jax_adamw_update(g, jstate, jp, lr, wd)
        tlr, twd = tsched.lr(tstate.step), tsched.wd(tstate.step)
        assert tlr.item() == float(lr) > 0 and twd.item() == float(wd)
        tp, tstate, tmet = adamw.adamw_update(_to_torch(g), tstate, tp, tlr, twd)
        np.testing.assert_allclose(tmet["grad_norm"].item(), float(jmet["grad_norm"]),
                                   rtol=GNORM_RTOL)
        assert (float(jmet["grad_norm"]) > 1.0) == clipped
    assert int(tstate.step) == int(jstate.step) == 602 and tstate.step.dtype == torch.int32
    for name, a, b in (("params", tp, jp), ("mu", tstate.mu, jstate.mu),
                       ("nu", tstate.nu, jstate.nu)):
        for x, y in zip(adamw.tree_leaves(a), jax.tree.leaves(b)):
            y = np.asarray(y)
            assert x.dtype == torch.float32, name
            # atol: an element that cancels to near 0 (b1 * m against (1 - b1) * g)
            # keeps the f32 rounding of its terms, a few ulps of the leaf's scale
            np.testing.assert_allclose(x.numpy(), y, rtol=rtol, atol=rtol * np.abs(y).max(),
                                       err_msg=name)


def test_adamw_update_is_in_place_and_leaves_the_step_count():
    p = {"w": torch.ones(3, 4), "norm": torch.ones(4)}
    state = adamw.init_adamw(p)
    ids = [id(t) for t in adamw.tree_leaves(p) + adamw.tree_leaves(state.mu)]
    g = {"w": torch.full((3, 4), 0.5), "norm": torch.full((4,), -0.5)}
    p2, s2, _ = adamw.adamw_update(g, state, p, torch.tensor(0.1), torch.tensor(0.1))
    assert [id(t) for t in adamw.tree_leaves(p2) + adamw.tree_leaves(s2.mu)] == ids
    assert state.step.item() == 0 and s2.step.item() == 1
    assert (p["w"] < 1).all() and (p["norm"] > 1).all()


SWEEP = (0, 1, 5, 9, 10, 11, 37, 99, 100, 101, 150, 199, 200, 201, 260)


@pytest.mark.parametrize("name,kw", [
    ("two_phase", dict(total_steps=200, warmup_steps=10)),
    ("two_phase", dict(total_steps=201, warmup_steps=0, midpoint_frac=0.3)),
    ("two_phase", dict()),
    ("cosine", dict(total_steps=200, warmup_steps=10)),
    ("cosine", dict(total_steps=5, warmup_steps=10)),
    ("cosine", dict()),
])
def test_schedules_match_jax(name, kw):
    jcls = {"two_phase": jschedule.TwoPhaseSchedule, "cosine": jschedule.CosineSchedule}[name]
    tcls = {"two_phase": schedule.TwoPhaseSchedule, "cosine": schedule.CosineSchedule}[name]
    js, ts = jcls(**kw), tcls(**kw)
    steps = SWEEP + ((js.mid - 1, js.mid, js.mid + 1) if name == "two_phase" else ())
    for s in steps:
        for fn in ("lr", "wd"):
            want = float(getattr(js, fn)(jnp.asarray(s, jnp.int32)))
            got = getattr(ts, fn)(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.ndim == 0
            np.testing.assert_allclose(got.item(), want, rtol=OPT_RTOL, atol=1e-12,
                                       err_msg=f"{name} {fn}({s})")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("total", [7, 100, 20000])
def test_schedule_for_mode_matches_jax(mode, total):
    want = jschedule.schedule_for_mode(mode, total)
    got = schedule.schedule_for_mode(mode, total, None)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    got = schedule.schedule_for_mode(mode, total, 2e-3)
    assert got.peak_lr == jschedule.schedule_for_mode(mode, total, 2e-3).peak_lr


# ---------------------------------------------------------------------------
# (g)-(j): the training step
# ---------------------------------------------------------------------------

STEPS = 3
TOTAL = 40  # warm-up of 10 steps: lr 0, then 1.5e-4, 3e-4 (3e-5, 6e-5 for "none")


def _run_jax(jcfg, params, batches, accum):
    """JAX's jitted step over ``batches`` from a fresh AdamW state: the
    state, each step's metrics and each step's act-quant decisions."""
    state = jtrainer.TrainState(params=params, opt=jadamw.init_adamw(params))
    step = jax.jit(jtrainer.make_train_step(jcfg, TOTAL, accum=accum))
    mets, record = [], []
    with _jax_recording(record):  # the program traced once records every step's sites
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            mets.append({k: float(v) for k, v in m.items()})
    n = len(record) // len(batches)
    return state, mets, [record[i * n:(i + 1) * n] for i in range(len(batches))]


def _run_port(cfg, tparams, batches, accum, replays):
    """The port's step over ``batches``, each step replaying JAX's
    act-quant decisions of that step."""
    params = adamw.tree_map(torch.clone, tparams)  # the step updates in place
    state = trainer.TrainState(params=params, opt=adamw.init_adamw(params))
    step = trainer.make_train_step(cfg, TOTAL, accum=accum)
    mets = []
    for b, replay in zip(batches, replays):
        with _port_recording([], replay):
            state, m = step(state, _tbatch(b))
        assert set(m) == {"loss", "nll", "grad_norm", "lr", "wd"}
        assert all(v.dtype == torch.float32 and v.ndim == 0 for v in m.values())
        mets.append({k: v.item() for k, v in m.items()})
    return state, mets


def _assert_update_close(got, want, before, lr_sum, path):
    """Each leaf's total update within STEP_RTOL of its largest element,
    but for at most STEP_SIGN_SHARE of its elements, which stay within
    2 * lr_sum * STEP_MAX_RATIO (Adam's update is about lr * sign(g): a
    gradient element within float noise of 0 can take either sign)."""
    got, want, before = _np(got), np.asarray(want), np.asarray(before)
    err = np.abs((got - before) - (want - before))
    off = err > STEP_RTOL * np.abs(want - before).max() + 1e-12
    assert off.mean() <= STEP_SIGN_SHARE, (path, off.mean())
    assert err.max() <= 2 * lr_sum * STEP_MAX_RATIO, (path, err.max())


@functools.cache
def _step_params(mode):
    """JAX's weights of the step tests, one init a mode (both accumulations
    of "pquant" share it)."""
    return japi.init_model(jax.random.PRNGKey(11), _cfgs(mode, remat=False)[0])[0]


# the paper's mode at both accumulations and the FP baseline on its cosine
# schedule (every mode's gradients: (d) above; every mode's update: (e))
@pytest.mark.parametrize("mode,accum", [("pquant", 1), ("pquant", 4), ("none", 1)])
def test_train_step_matches_jax(mode, accum):
    """Three steps of ``make_train_step`` against JAX's jitted step, the
    port replaying JAX's act-quant decisions (remat off on both sides)."""
    jcfg, cfg = _cfgs(mode, remat=False)
    params = _step_params(mode)
    tparams = _to_torch(params)
    batches = [_batch(8, SEQ, cfg.vocab_size, seed=10 + i) for i in range(STEPS)]
    jstate, jm, records = _run_jax(jcfg, params, batches, accum)
    tstate, tm = _run_port(cfg, tparams, batches, accum, records)
    assert int(tstate.opt.step) == int(jstate.opt.step) == STEPS
    for a, b in zip(tm, jm):
        assert a["lr"] == pytest.approx(b["lr"], rel=OPT_RTOL)
        assert a["wd"] == pytest.approx(b["wd"], rel=OPT_RTOL)
        for k in ("loss", "nll"):
            assert abs(a[k] - b[k]) <= ATOL, (k, a, b)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=GRAD_RTOL)
    assert tm[0]["lr"] == 0.0 and tm[1]["lr"] > 0
    lr_sum = sum(m["lr"] for m in jm)
    paths = [p for p, _ in adamw.tree_paths(tparams)]
    for path, t, j, before in zip(paths, adamw.tree_leaves(tstate.params),
                                  jax.tree.leaves(jstate.params), jax.tree.leaves(params)):
        _assert_update_close(t, j, before, lr_sum, path)
    for name, tt, jt in (("mu", tstate.opt.mu, jstate.opt.mu), ("nu", tstate.opt.nu, jstate.opt.nu)):
        for path, t, j in zip(paths, adamw.tree_leaves(tt), jax.tree.leaves(jt)):
            err = np.abs(t.numpy() - np.asarray(j))
            assert err.max() <= GRAD_RTOL * np.abs(np.asarray(j)).max() + 1e-20, (name, path)


def test_train_step_accum_matches_full_batch():
    """Upstream's ``TestGradAccum`` on the port (bf16, as there): 4
    microbatches against the whole batch, with its tolerances, over two
    steps (the first at lr 0, so the second moves the weights)."""
    _, cfg = _cfgs("pquant")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    tparams = trainer.init_train_state(0, cfg, device="cpu").params
    batches = [_tbatch(_batch(8, SEQ, cfg.vocab_size, seed=i)) for i in range(2)]
    runs = []
    for accum in (1, 4):
        state = trainer.TrainState(*_clone_state(tparams))
        step = trainer.make_train_step(cfg, 10, accum=accum)
        for b in batches:
            state, m = step(state, b)
        runs.append((state, m))
    (s1, m1), (s2, m2) = runs
    np.testing.assert_allclose(m1["loss"].item(), m2["loss"].item(), rtol=2e-3)
    w0, w1, w2 = (adamw.tree_leaves(p)[0] for p in (tparams, s1.params, s2.params))
    assert not torch.equal(w1, w0)
    np.testing.assert_allclose(w1.numpy(), w2.numpy(), rtol=2e-2, atol=1e-5)


def _clone_state(params):
    p = adamw.tree_map(torch.clone, params)
    return p, adamw.init_adamw(p)


def test_train_step_bf16_moves_the_f32_master():
    _, cfg = _cfgs("pquant")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    state = trainer.init_train_state(0, cfg, device="cpu")
    before = adamw.tree_map(torch.clone, state.params)
    step = trainer.make_train_step(cfg, 40)
    for i in range(2):
        state, m = step(state, _tbatch(_batch(2, SEQ, cfg.vocab_size, seed=i)))
        assert all(torch.isfinite(v) for v in m.values())
    leaves = adamw.tree_leaves(state.params)
    assert all(p.dtype == torch.float32 for p in leaves)
    assert all(m.dtype == torch.float32 for m in adamw.tree_leaves(state.opt.mu))
    moved = [not torch.equal(a, b) for a, b in zip(leaves, adamw.tree_leaves(before))]
    assert all(moved)  # lr > 0 on the second step moves every leaf


def test_cast_for_forward_casts_the_leaves_jax_casts():
    tree = {"a": np.ones((2, 3), np.float32), "b": [np.ones(4, np.int32),
                                                      np.ones(2, np.uint8)],
            "c": {"d": np.ones((), np.float32)}}
    want = jtrainer.cast_for_forward(jax.tree.map(jnp.asarray, tree), jnp.bfloat16)
    got = trainer.cast_for_forward(params_from_numpy(tree, CPU), torch.bfloat16)
    names = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int32": torch.int32,
             "uint8": torch.uint8}
    assert [names[str(x.dtype)] for x in jax.tree.leaves(want)] == \
        [x.dtype for x in adamw.tree_leaves(got)]
    assert trainer.cast_for_forward(got, torch.float32) is got
    # differentiable: the gradient of a cast leaf lands on the f32 master in f32
    w = torch.ones(3, requires_grad=True)
    (g,) = torch.autograd.grad(trainer.cast_for_forward({"w": w}, torch.bfloat16)["w"].sum(), w)
    assert g.dtype == torch.float32


def test_init_train_state_needs_a_device_or_cuda(monkeypatch):
    _, cfg = _cfgs("pquant")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.init_train_state(0, cfg)
    state = trainer.init_train_state(0, cfg, device="cpu")
    assert state.opt.step.dtype == torch.int32 and state.opt.step.item() == 0
    for p, m, v in zip(*(adamw.tree_leaves(t) for t in (state.params, state.opt.mu,
                                                          state.opt.nu))):
        assert p.dtype == m.dtype == v.dtype == torch.float32
        assert m.shape == p.shape and not m.any() and not v.any()
