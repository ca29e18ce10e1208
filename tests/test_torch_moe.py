"""DeepSeek-MoE (``models/moe.py``, deepseek-moe-16b) in the port against
the JAX package, on the CPU, on ``registry.reduced`` of deepseek-moe-16b
(4 layers: one dense, three MoE; 8 routed experts top-2, one shared):
JAX's weights converted leaf for leaf, numpy-seeded inputs.

Tolerances, as ``tests/test_torch_train.py`` and
``tests/test_torch_experts.py`` set them: the stacked quantizers' values
within float rounding (their signs exact) and gradients within QGRAD_TOL
of the largest of the slice that shares a scale; the one-hot dispatch's
integers (ranks, positions of the combine tensor, dispatch) exact and its
gates allclose; forwards within ATOL; gradients, steps and histories with
JAX's act-quant AND router decisions replayed in the port (a top-k over
near-equal probs can go either way between two frameworks), each gradient
leaf within GRAD_RTOL of its largest element.  The router choices that
differ as computed are counted and must be 0 here.
"""

import contextlib
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jckpt
from repro.configs import registry as jregistry
from repro.configs.base import param_count as jparam_count
from repro.core import quantization as jq
from repro.core import routing as jrouting
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw
from repro.telemetry import probes as jprobes
from repro.train import trainer as jtrainer
from repro_torch.configs import registry
from repro_torch.configs.base import param_count
from repro_torch.core import quantization as q
from repro_torch.core import routing
from repro_torch.launch import train as launch_train
from repro_torch.models import api, moe
from repro_torch.optim import adamw
from repro_torch.telemetry import probes
from repro_torch.train import trainer
from test_torch_experts import (
    ATOL,
    ATOL_FLIP,
    CPU,
    FLIP_RATE,
    GRAD_RTOL,
    _batch,
    _choice_flips,
    _leaves,
    _port_choices,
    _t,
    _tbatch,
)
from test_torch_probes import _port_replay
from test_torch_train import (  # noqa: F401  (_torch_one_thread: an autouse fixture)
    QGRAD_TOL,
    _flips,
    _jax_recording,
    _objective,
    _port_recording,
    _weights,
    _torch_one_thread,
)
from test_torch_trainer import _data_iter

ARCH = "deepseek-moe-16b"
TOTAL = 40
# the three archs of the JAX registry the port ported last
OTHERS = ("granite-20b", "deepseek-coder-33b", "phi-3-vision-4.2b")


def _cfgs(**kw):
    mode = kw.pop("quant_mode", "pquant")
    jcfg = jregistry.reduced(jregistry.get_config(ARCH, quant_mode=mode))
    cfg = registry.reduced(registry.get_config(ARCH, quant_mode=mode))
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)


@contextlib.contextmanager
def _jax_choices(record: list):
    """While open, every router of the JAX package's MoE forward appends its
    top-k choice to ``record`` (an ordered callback in the jitted program),
    in either dispatch arm: the sort arm's ``expert_index`` (T, k), the
    einsum arm's top-k over its (G, S, E) groups."""
    sort, einsum = jrouting.topk_dispatch, jrouting.einsum_dispatch_combine

    def tap(idx):
        jax.debug.callback(lambda e: record.append(np.asarray(e)), idx, ordered=True)

    def tapped_sort(probs, cfg):
        d = sort(probs, cfg)
        tap(d["expert_index"])
        return d

    def tapped_einsum(probs, cfg, group_size):
        t, e = probs.shape
        tap(jax.lax.top_k(probs.reshape(t // group_size, group_size, e), cfg.top_k)[1])
        return einsum(probs, cfg, group_size)

    jrouting.topk_dispatch, jrouting.einsum_dispatch_combine = tapped_sort, tapped_einsum
    try:
        yield
        jax.effects_barrier()
    finally:
        jrouting.topk_dispatch, jrouting.einsum_dispatch_combine = sort, einsum


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------


def test_config_equals_jax_and_counts_16_4e9():
    for mode in ("pquant", "bitnet", "bitnet158", "none"):
        j = jregistry.get_config(ARCH, quant_mode=mode)
        t = registry.get_config(ARCH, quant_mode=mode)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert dataclasses.asdict(registry.reduced(t)) == dataclasses.asdict(
            jregistry.reduced(j))
        assert param_count(t) == jparam_count(j)
    pc = param_count(registry.get_config(ARCH))
    assert abs(pc["total"] / 1e9 - 16.4) / 16.4 < 0.08  # tests/test_arch_smoke.py's pin
    assert round(pc["total"] / 1e9, 2) == 16.40
    assert registry.NOT_PORTED == ()
    for arch in OTHERS:  # built now, field for field JAX's
        assert dataclasses.asdict(registry.get_config(arch)) == dataclasses.asdict(
            jregistry.get_config(arch))
    assert registry.get_config("whisper-large-v3").family == "encdec"
    # the reduced tree holds the counted populations
    cfg = registry.reduced(registry.get_config(ARCH))
    tree = api.init_model(0, cfg, device=CPU)
    paths = [("/".join(map(str, p)), t) for p, t in adamw.tree_paths(tree)]
    assert sum(t.numel() for p, t in paths if "/w8" in p) == param_count(cfg)["n_8bit"]


# ---------------------------------------------------------------------------
# the stacked quantizers
# ---------------------------------------------------------------------------

# name -> (port fn, JAX fn, the slices that share a scale, as rows);
# each fn returns (values, scale)
STACKED = {
    "binarize": (lambda w: q.binarize_weights_stacked(w.reshape(4, 16, 48)),
                 lambda w: jq.binarize_weights_stacked(w.reshape(4, 16, 48)),
                 lambda a: a.reshape(4, -1)),
    "binarize_2_axes": (lambda w: q.binarize_weights_stacked(w.reshape(2, 2, 16, 48), 2),
                        lambda w: jq.binarize_weights_stacked(w.reshape(2, 2, 16, 48), 2),
                        lambda a: a.reshape(4, -1)),
    "ternarize": (lambda w: q.ternarize_weights_stacked(w.reshape(4, 16, 48)),
                  lambda w: jq.ternarize_weights_stacked(w.reshape(4, 16, 48)),
                  lambda a: a.reshape(4, -1)),
}


@pytest.mark.parametrize("name", list(STACKED))
def test_stacked_quantizer_values_and_gradients_match_jax(name):
    """Per-slice scales within float rounding of JAX's, the grid values
    with them (the signs and ternary codes exactly); the gradient within
    QGRAD_TOL of the largest of its slice."""
    port, ref, slices = STACKED[name]
    grad_ref = jax.jit(jax.grad(lambda x, c, cs: _objective(ref(x), c, cs, jnp)))
    for seed in range(2):
        w = _weights(seed)
        jv, js = (np.asarray(a) for a in ref(jnp.asarray(w)))
        tv, ts = port(torch.from_numpy(w))
        assert ts.shape == js.shape == (4, 1, 1) or ts.shape == js.shape == (2, 2, 1, 1)
        np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6, atol=0)
        np.testing.assert_array_equal(np.sign(tv.numpy()), np.sign(jv))
        np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-6, atol=0)
        rng = np.random.default_rng(seed + 1)
        cot = rng.standard_normal(w.shape).astype(np.float32)
        cot_s = rng.standard_normal(js.shape).astype(np.float32)
        want = np.asarray(grad_ref(jnp.asarray(w), jnp.asarray(cot), jnp.asarray(cot_s)))
        wt = torch.from_numpy(w).requires_grad_()
        _objective(port(wt), torch.from_numpy(cot), torch.from_numpy(cot_s), torch).backward()
        err = slices(np.abs(wt.grad.numpy() - want))
        scale = slices(np.abs(want)).max(-1, keepdims=True)
        assert (err <= QGRAD_TOL * scale).all(), (name, seed, (err / scale).max())


@pytest.mark.parametrize("mode", ["none", "bitnet", "bitnet158", "pquant", "stored"])
def test_fake_quant_stacked_matches_jax(mode):
    """The mode's stacked quantizer per expert slice; the dict arm
    dequantizes a stored leaf (int8 or packed)."""
    w = _weights(3).reshape(4, 16, 48)
    if mode == "stored":
        codes = np.random.default_rng(0).integers(-127, 128, w.shape).astype(np.int8)
        scale = np.random.default_rng(1).random((4, 1, 1)).astype(np.float32)
        packed = np.random.default_rng(2).integers(0, 256, (4, 2, 48)).astype(np.uint8)
        for leaf in ({"q": codes, "scale": scale}, {"packed": packed, "scale": scale}):
            want = jq.fake_quant_stacked(jax.tree.map(jnp.asarray, leaf), jq.QuantConfig())
            got = q.fake_quant_stacked(_t(leaf), q.QuantConfig())
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    want = np.asarray(jq.fake_quant_stacked(jnp.asarray(w), jq.QuantConfig(mode=mode)))
    got = q.fake_quant_stacked(torch.from_numpy(w), q.QuantConfig(mode=mode)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(np.sign(got), np.sign(want))


# ---------------------------------------------------------------------------
# the one-hot dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_einsum_dispatch_combine_matches_jax(cf):
    """Ranks, combine positions and dispatch exactly JAX's, the gates and
    the aux loss allclose, the gradient of the gates into the probs
    JAX's; at capacity factor 0.25 slots are dropped (they add 0 at rank
    0) and no element of either tensor is set twice."""
    t, e, k, gs = 64, 8, 2, 16
    logits = np.random.default_rng(int(cf * 8)).standard_normal((t, e)).astype(np.float32)
    jrc = jrouting.RouterConfig(num_experts=e, top_k=k, capacity_factor=cf)
    rc = routing.RouterConfig(num_experts=e, top_k=k, capacity_factor=cf)
    cot = np.random.default_rng(9).standard_normal((t // gs, gs, e, 8)).astype(np.float32)

    def jfn(lg):
        c, d, aux = jrouting.einsum_dispatch_combine(jax.nn.softmax(lg, -1), jrc, gs)
        return jnp.sum(c * cot[..., :c.shape[-1]]) + aux, (c, d, aux)

    (_, (jc, jd, jaux)), jgrad = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    c, d, aux = routing.einsum_dispatch_combine(torch.softmax(lt, -1), rc, gs)
    (torch.sum(c * torch.from_numpy(cot)[..., :c.shape[-1]]) + aux).backward()
    c, aux = c.detach(), aux.detach()
    jc, jd = np.asarray(jc), np.asarray(jd)
    assert c.shape == jc.shape == (t // gs, gs, e, routing.expert_capacity(gs, rc))
    np.testing.assert_array_equal(c.numpy() > 0, jc > 0)
    np.testing.assert_array_equal(d.numpy(), jd)
    np.testing.assert_allclose(c.numpy(), jc, rtol=1e-6, atol=0)
    assert abs(aux.item() - float(jaux)) <= 1e-7
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-6)
    kept = int(d.sum())
    assert kept <= t * k and (kept < t * k) == (cf < 1), kept
    # every group and expert fills its ranks from 0 without a gap
    fill = d.numpy().sum(1)  # (G, E, C)
    assert ((fill == 0) | (fill == 1)).all() and (np.diff(fill, axis=-1) <= 0).all()


# ---------------------------------------------------------------------------
# moe_ffn, one layer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layer():
    jcfg, cfg = _cfgs(dtype="float32", remat=False)
    jp, _ = jmoe.init_moe_ffn(jax.random.PRNGKey(3), jcfg)
    x = np.random.default_rng(3).standard_normal((4, 16, jcfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, x


@pytest.mark.parametrize("arm", ["sort", "einsum"])
def test_moe_ffn_forward_and_gradients_match_jax(layer, arm):
    """One MoE layer in f32 in both dispatch arms: y and aux within ATOL /
    1e-6 of JAX's, the router choices equal as computed, every gradient
    leaf within GRAD_RTOL of its largest with JAX's decisions replayed.
    At capacity factor 0.1 (capacity 8 an expert) slots are dropped and
    some tokens lose every slot: their gates are 0 / 1e-9 = 0, not NaN,
    so the shared experts alone give their output.  (The model tests and
    the serving tests run the default factor, 1.25.)"""
    jcfg, cfg, jp, x = layer
    cf = 0.1
    kw = dict(moe_dispatch=arm, moe_capacity_factor=cf, moe_group_size=32)
    jcfg, cfg = dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)
    cot = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(p, x, jcfg)
        return jnp.sum(y * cot) + aux, (y, aux)

    acts, choices = [], []
    with _jax_recording(acts), _jax_choices(choices):
        (_, (jy, jaux)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            jp, jnp.asarray(x))
    tp = _t(jp)
    for replay in (False, True):
        got_acts, got_choices = [], []
        with _port_recording(got_acts, acts if replay else None), \
                _port_choices(got_choices, choices if replay else None):
            leaves = adamw.tree_map(lambda t: t.clone().requires_grad_(), tp)
            y, aux = moe.moe_ffn(leaves, torch.from_numpy(x), cfg)
            flat = torch.autograd.grad(torch.sum(y * torch.from_numpy(cot)) + aux,
                                       adamw.tree_leaves(leaves))
        if not replay:
            assert _choice_flips(choices, got_choices) == 0
            f = _flips(acts, got_acts)
            assert f["primary"] == 0, f
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0, atol=ATOL)
        assert abs(aux.item() - float(jaux)) <= 1e-6 and aux.item() > 0
        for (path, jg), g in zip(_leaves(jgrads), flat, strict=True):
            jg = np.asarray(jg)
            err = np.abs(g.numpy() - jg).max()
            assert err <= GRAD_RTOL * np.abs(jg).max() + 1e-12, (jax.tree_util.keystr(path), err)
    # drops: count the (token, slot) pairs routed past capacity
    probs, _ = routing.router_probs(tp["router"], torch.from_numpy(x).reshape(-1, cfg.d_model))
    rc = routing.RouterConfig(num_experts=cfg.n_routed_experts, top_k=cfg.moe_top_k,
                              capacity_factor=cf)
    if arm == "sort":
        kept = routing.topk_dispatch(probs, rc)["combine_weight"] > 0
    else:
        comb, _, _ = routing.einsum_dispatch_combine(probs, rc, 32)
        kept = (comb > 0).any(-1).sum(-1).reshape(-1, 1) > torch.arange(cfg.moe_top_k)
    lost = ~kept.any(-1)
    assert not kept.all() and lost.any(), int(kept.sum())
    ys, _ = jax.jit(lambda p, x: jmoe.apply_ffn(p["shared"], x, jcfg))(
        jp, jnp.asarray(x.reshape(-1, cfg.d_model)))
    yf = y.detach().reshape(-1, cfg.d_model)
    assert torch.isfinite(yf).all()
    np.testing.assert_allclose(yf[lost].numpy(), np.asarray(ys)[lost.numpy()], rtol=0, atol=ATOL)


def test_qgather_arm_is_not_ported():
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        moe._expert_wq(q.QuantConfig(qgather=True), torch.float32)


# ---------------------------------------------------------------------------
# the model: loss and gradients in every mode
# ---------------------------------------------------------------------------


def _jax_loss_grads(jcfg, params, batch):
    acts, choices = [], []
    with _jax_recording(acts), _jax_choices(choices):
        fn = jax.jit(jax.value_and_grad(lambda p, b: japi.loss_fn(p, b, jcfg), has_aux=True))
        (loss, metrics), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads, (acts, choices)


def _port_loss_grads(cfg, tparams, batch, replay=None):
    acts, choices = [], []
    with _port_recording(acts, None if replay is None else replay[0]), \
            _port_choices(choices, None if replay is None else replay[1]):
        leaves = adamw.tree_map(lambda p: p.detach().clone().requires_grad_(), tparams)
        loss, metrics = api.loss_fn(leaves, _tbatch(batch), cfg)
        forward = (list(acts), list(choices))  # remat runs each layer again in the backward
        flat = torch.autograd.grad(loss, adamw.tree_leaves(leaves), materialize_grads=True)
    return loss.item(), {k: v.item() for k, v in metrics.items()}, flat, forward


@pytest.fixture(scope="module", params=["pquant", "bitnet", "bitnet158", "none"])
def grads(request):
    """The model in each mode, the default sort dispatch (the einsum arm's
    gradients: test_moe_ffn_forward_and_gradients_match_jax).  pquant runs
    the reduced config's 4 layers (its 3 MoE layers stacked, as at full
    depth); the other modes a dense and one MoE layer, which JAX compiles
    in half the time (no scan over the stack)."""
    depth = {} if request.param == "pquant" else {"n_layers": 2}
    jcfg, cfg = _cfgs(quant_mode=request.param, dtype="float32", remat=False, **depth)
    params, _ = japi.init_model(jax.random.PRNGKey(7), jcfg)
    tparams = _t(params)
    batch = _batch(2, 16, cfg.vocab_size)
    ref = _jax_loss_grads(jcfg, params, batch)
    got = _port_loss_grads(dataclasses.replace(cfg, remat=True), tparams, batch)
    replayed = _port_loss_grads(cfg, tparams, batch, replay=ref[3])
    return cfg, tparams, ref, got, replayed


def test_lm_loss_and_aux_match_jax(grads):
    cfg, _, ref, got, replayed = grads
    f = _flips(ref[3][0], got[3][0])
    assert f["primary"] <= FLIP_RATE * f["codes"], f
    assert _choice_flips(ref[3][1], got[3][1]) == 0
    assert len(got[3][1]) == len(ref[3][1]) == cfg.n_layers - cfg.first_k_dense
    tol = ATOL + 2 * ATOL_FLIP * f["tokens"] / f["of"]
    for run in (got, replayed):
        assert abs(run[0] - ref[0]) <= tol
        assert abs(run[1]["nll"] - ref[1]["nll"]) <= tol
        # three MoE layers' Switch losses and z-losses
        assert abs(run[1]["aux"] - ref[1]["aux"]) <= 1e-6 and run[1]["aux"] > 0


def test_model_gradients_match_jax(grads):
    """Every leaf (experts, router, shared FFN, the untied head) within
    GRAD_RTOL of its largest element, JAX's decisions replayed; and as the
    port computes them (remat on) where no decision differs."""
    _, tparams, ref, got, replayed = grads
    paths = ["/".join(map(str, p)) for p, _ in adamw.tree_paths(tparams)]
    assert any("we_down" in p for p in paths) and "lm_head/table" in paths
    f = _flips(ref[3][0], got[3][0])
    runs = [replayed[2]] + ([got[2]] if f["primary"] == 0 else [])
    for flat in runs:
        for (_, jg), path, g in zip(_leaves(ref[2]), paths, flat, strict=True):
            jg = np.asarray(jg)
            err = np.abs(g.numpy() - jg).max()
            assert err <= GRAD_RTOL * np.abs(jg).max() + 1e-12, (path, err)
    router = [g for p, g in zip(paths, replayed[2]) if "router" in p][0]
    assert router.abs().max() > 0


# ---------------------------------------------------------------------------
# the step, the Trainer, the CLI
# ---------------------------------------------------------------------------


def test_two_train_steps_match_jax():
    """``make_train_step`` (probes on) against JAX's jitted step, JAX's
    decisions replayed: losses, gradient norm, QAT metrics and the AdamW
    moments; the decay mask leaf for leaf JAX's; step 1 (lr > 0) moves
    the router, the shared FFN and every expert that took a token."""
    jcfg, cfg = _cfgs(dtype="float32", remat=False)
    params, _ = japi.init_model(jax.random.PRNGKey(11), jcfg)
    tparams = _t(params)
    batches = [_batch(4, 16, cfg.vocab_size, seed=10 + i) for i in range(2)]
    jstate = jtrainer.TrainState(params=params, opt=jadamw.init_adamw(params))
    jstep = jax.jit(jtrainer.make_train_step(jcfg, TOTAL, probes=True))
    jm, acts, choices = [], [], []
    with _jax_recording(acts), _jax_choices(choices):
        for b in batches:
            jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
            jm.append({k: float(v) for k, v in m.items()})
    na, nc = len(acts) // 2, len(choices) // 2
    p = adamw.tree_map(torch.clone, tparams)
    state = trainer.TrainState(params=p, opt=adamw.init_adamw(p))
    step = trainer.make_train_step(cfg, TOTAL, probes=True)
    tm, used = [], []
    for i, b in enumerate(batches):
        with _port_replay(acts[i * na:(i + 1) * na]), \
                _port_choices(used, choices[i * nc:(i + 1) * nc]):
            state, m = step(state, _tbatch(b))
        tm.append({k: v.item() for k, v in m.items()})
    assert adamw.tree_leaves(adamw._decay_mask(tparams, adamw.AdamWConfig())) == \
        jax.tree.leaves(jadamw._decay_mask(params, jadamw.AdamWConfig()))
    for a, b in zip(tm, jm):
        assert set(a) == set(b) and "qat_router_entropy" in a and "qat_clip_act" in a
        for k in ("loss", "nll"):
            assert abs(a[k] - b[k]) <= ATOL, (k, a[k], b[k])
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=GRAD_RTOL)
        for k in b:
            if k.startswith("qat_"):
                assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-7), k
    paths = ["/".join(map(str, p)) for p, _ in adamw.tree_paths(tparams)]
    for name, tt, jt in (("mu", state.opt.mu, jstate.opt.mu), ("nu", state.opt.nu, jstate.opt.nu)):
        for path, t, j in zip(paths, adamw.tree_leaves(tt), jax.tree.leaves(jt)):
            err = np.abs(t.numpy() - np.asarray(j))
            assert err.max() <= GRAD_RTOL * np.abs(np.asarray(j)).max() + 1e-20, (name, path)
    before = dict(zip(paths, adamw.tree_leaves(tparams)))
    after = dict(zip(paths, adamw.tree_leaves(state.params)))
    for key in ("segments/1/b0/ffn/router/w", "segments/1/b0/ffn/shared/w1_up",
                "segments/1/b0/ffn/shared/w8_down"):
        assert not torch.equal(before[key], after[key]), key
    # the experts of MoE layer 0 that took a token in step 1's forward moved
    took = set(np.unique(used[len(used) // 2]))
    for e in range(cfg.n_routed_experts):
        moved = not torch.equal(before["segments/1/b0/ffn/we_up"][0, e],
                                after["segments/1/b0/ffn/we_up"][0, e])
        assert moved == (e in took), e


def test_trainer_checkpoint_keys_and_probe_families_match_jax(tmp_path):
    """One ``Trainer`` run (bf16 forward, remat, probes and the
    democratization snapshot on, a checkpoint at the end): finite history
    with the router-entropy probe; the checkpoint's keys JAX's
    ``Checkpointer`` layout, which restores it bit for bit; the probe
    family of every leaf JAX's (the routed experts unprobed, the shared
    FFN's 1-bit and 8-bit branches probed)."""
    jcfg, cfg = _cfgs()
    assert cfg.dtype == "bfloat16" and cfg.remat
    ck = str(tmp_path / "ck")
    tkw = dict(total_steps=3, log_every=1000, probes=True, sensitivity_every=2,
               ckpt_dir=ck, ckpt_every=3, heartbeat_path=None)
    tr = trainer.Trainer(cfg, trainer.TrainerConfig(**tkw), _data_iter(cfg, 3), device=CPU)
    hist = tr.run()
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert "demo_score_ffn8" in hist[0] and "qat_router_entropy" in hist[0]
    assert all(np.isfinite(v) for h in hist for k, v in h.items() if k != "step")
    jstate = jax.eval_shape(lambda: jtrainer.init_train_state(jax.random.PRNGKey(0), jcfg)[0])
    jkeys = [k for k, _ in jckpt._flatten(jstate._asdict())[0] if k.startswith("params/")]
    step_dir = sorted((tmp_path / "ck").glob("step_*"))[-1]
    keys = json.loads((step_dir / "manifest.json").read_text())["keys"]
    assert [k for k in keys if k.startswith("params/")] == jkeys
    assert any("we_gate" in k for k in jkeys) and "opt/nu/" + jkeys[-1][len("params/"):] in keys
    like = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), jstate.params)
    out = jckpt.Checkpointer(ck).restore({"params": like})["params"]
    for (path, t), a in zip(adamw.tree_paths(tr.state.params), jax.tree.leaves(out)):
        np.testing.assert_array_equal(np.asarray(a), t.numpy(), err_msg=str(path))
    fams = {}
    for path, _ in adamw.tree_paths(tr.state.params):
        key = "/".join(map(str, path))
        fams[key] = probes.family_of(key)
        assert fams[key] == jprobes.family_of(key), key
    assert all(fams[k] is None for k in fams if "/we_" in k)
    assert fams["segments/1/b0/ffn/shared/w1_up"] == "ffn1"
    assert fams["segments/1/b0/ffn/shared/w8_up"] == "ffn8"


def test_launch_train_cli_deepseek_moe(tmp_path):
    out = tmp_path / "h.json"
    hist = launch_train.main(["--arch", ARCH, "--reduced", "--steps", "2", "--seq-len", "8",
                              "--global-batch", "2", "--device", "cpu", "--probes",
                              "--log-every", "1", "--history-out", str(out)])
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) and 0 <= h["qat_router_entropy"] <= 1 for h in hist)
    assert json.loads(out.read_text())[-1]["step"] == 1
