"""pQuant's routed 8-bit experts (N > 1, paper §3.3) in the port against
the JAX package, on the CPU, on ``registry.reduced`` of pquant-100m with
N experts: JAX's weights converted leaf for leaf, numpy-seeded inputs.

Tolerances, as ``tests/test_torch_train.py`` sets them and for the same
reasons: forwards within ATOL (f32 sums in another order), and where an
act-quant code is decided two ways, logits within ATOL_FLIP; gradients,
steps and the Trainer's history with JAX's decisions replayed in the port,
each gradient leaf within GRAD_RTOL of its largest element.  The replay
takes both kinds of decision: every act-quant site's codes and AbsMax
elements (``test_torch_train._port_recording`` / ``test_torch_probes.
_port_replay``) and every router's choice of
expert (a top-1 on near-equal logits can go either way between two
frameworks, and it moves a whole token to another expert).  The number of
choices that differ as computed is counted and must be 0 here.
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
from repro.core import decoupled as jdecoupled
from repro.core import routing as jrouting
from repro.data import pipeline as jpipeline
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.telemetry import probes as jprobes
from repro.train import trainer as jtrainer
from repro_torch.configs import registry
from repro_torch.configs.base import param_count
from repro_torch.convert import params_from_numpy
from repro_torch.core import decoupled, routing
from repro_torch.core import quantization as q
from repro_torch.data.pipeline import DataConfig, SyntheticSource, host_batch
from repro_torch.launch import train as launch_train
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.telemetry import probes
from repro_torch.train import trainer
from test_torch_probes import _port_replay
from test_torch_train import _flips, _jax_recording, _port_recording
from test_torch_train import _torch_one_thread  # noqa: F401  (autouse)
from test_torch_trainer import _data_iter, _state_arrays, _trainer

CPU = torch.device("cpu")
ATOL = 1e-5
ATOL_FLIP = 5e-2
FLIP_RATE = 1e-4
GRAD_RTOL = 1e-5
HIST_TOL = 1e-5
STEPS, TOTAL = 3, 40
MAX_LEN, NEW = 24, 8  # the serving tests' (test_torch_experts_serving.py)


def _cfgs(n, **kw):
    jcfg = jregistry.reduced(jregistry.get_config("pquant-100m", n_experts=n))
    cfg = registry.reduced(registry.get_config("pquant-100m", n_experts=n))
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)


def _t(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


def _batch(b, s, vocab, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


# ---------------------------------------------------------------------------
# recording and replaying the router's choices
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _jax_choices(record: list):
    """While open, every router of the JAX package's forward appends its
    ``expert_index`` to ``record`` (an ordered callback in the jitted
    program; remat off, so each router runs once)."""
    orig = jrouting.topk_dispatch

    def tapped(probs, cfg):
        d = orig(probs, cfg)
        jax.debug.callback(lambda e: record.append(np.asarray(e)), d["expert_index"],
                           ordered=True)
        return d

    jrouting.topk_dispatch = tapped
    try:
        yield
        jax.effects_barrier()
    finally:
        jrouting.topk_dispatch = orig


@contextlib.contextmanager
def _port_choices(record: list, replay=None):
    """While open, every router of the port appends its choice to
    ``record``; with ``replay`` (another run's record), each router takes
    its choice from it instead, the gate prob read at that expert."""
    orig = routing._top_k
    it = iter(replay or ())

    def top_k(probs, k):
        vals, idx = orig(probs, k)
        record.append(idx.numpy().copy())
        if replay is None:
            return vals, idx
        idx = torch.from_numpy(np.array(next(it))).long()
        return torch.gather(probs, -1, idx), idx

    routing._top_k = top_k
    try:
        yield
    finally:
        routing._top_k = orig


@contextlib.contextmanager
def _count_drops(drops: list):
    """While open, every router of the port appends the number of tokens
    its dispatch dropped past capacity to ``drops``."""
    orig = routing.topk_dispatch

    def dispatch(probs, cfg):
        d = orig(probs, cfg)
        drops.append(int((d["buffer_slot"] == d["capacity"]).sum()))
        return d

    routing.topk_dispatch = dispatch
    try:
        yield
    finally:
        routing.topk_dispatch = orig


def _choice_flips(a, b) -> int:
    assert len(a) == len(b)
    return sum(int((x != y).sum()) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


def test_init_tree_matches_jax():
    jcfg, cfg = _cfgs(4)
    jparams = jax.eval_shape(lambda: japi.init_model(jax.random.PRNGKey(0), jcfg)[0])
    tparams = api.init_model(0, cfg, device=CPU)
    got = [("/".join(map(str, p)), tuple(t.shape)) for p, t in adamw.tree_paths(tparams)]
    want = [("/".join(str(getattr(e, "key", getattr(e, "idx", ""))) for e in p), v.shape)
            for p, v in _leaves(jparams)]
    assert got == want
    ffn = tparams["segments"][0]["b0"]["ffn"]
    assert ffn["router"]["w"].shape == (cfg.n_layers, cfg.d_model, 4)
    assert ffn["w8_up"].shape == (cfg.n_layers, 4, cfg.d_model, cfg.quant.r)
    # N = 1 keeps its tree: no router
    assert "router" not in api.init_model(0, _cfgs(1)[1], device=CPU)["segments"][0]["b0"]["ffn"]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_decoupled_ffn_forward_matches_jax(n, cf):
    """One layer in f32, the same router choices on both sides (counted);
    at capacity factor 0.5 tokens are dropped."""
    d, dff, r, t = 64, 96, 16, 80
    jp, _ = jdecoupled.init_decoupled_ffn(jax.random.PRNGKey(n), d, dff, r, num_experts=n)
    x = np.random.default_rng(n).standard_normal((2, t // 2, d)).astype(np.float32)
    jrc = jrouting.RouterConfig(num_experts=n, top_k=1, capacity_factor=cf)
    rc = routing.RouterConfig(num_experts=n, top_k=1, capacity_factor=cf)
    qc = q.QuantConfig(mode="pquant", r=r, num_experts=n)
    jchoices, choices = [], []
    with _jax_choices(jchoices):
        jy, jaux = jax.jit(lambda p, x: jdecoupled.decoupled_ffn(
            p, x, jdecoupled.QuantConfig(mode="pquant", r=r, num_experts=n),
            router_cfg=jrc))(jp, jnp.asarray(x))
    with _port_choices(choices):
        y, aux = decoupled.decoupled_ffn(_t(jp), torch.from_numpy(x), qc, router_cfg=rc)
    assert _choice_flips(jchoices, choices) == 0
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
    assert abs(aux.item() - float(jaux)) <= 1e-6 and aux.item() > 0
    probs, _ = routing.router_probs(_t(jp)["router"], torch.from_numpy(x).reshape(t, d))
    dropped = int((routing.topk_dispatch(probs, rc)["buffer_slot"] == routing.expert_capacity(
        t, rc)).sum())
    assert (dropped > 0) == (cf < 1), dropped
    with pytest.raises(ValueError, match="RouterConfig"):
        decoupled.decoupled_ffn(_t(jp), torch.from_numpy(x), qc)


@pytest.mark.parametrize("n", [1, 8])
def test_param_counts_match_jax(n):
    for size in ("100m", "1.3b"):
        jcfg = jregistry.get_config(f"pquant-{size}", n_experts=n)
        cfg = registry.get_config(f"pquant-{size}", n_experts=n)
        assert param_count(cfg) == jparam_count(jcfg)
        for mode in ("bitnet", "none"):
            assert param_count(registry.get_config(f"{mode}-{size}")) == jparam_count(
                jregistry.get_config(f"pquant-{size}", quant_mode=mode))
    args = (2048, 5024, 384, n, True)
    assert decoupled.decoupled_param_counts(*args) == jdecoupled.decoupled_param_counts(*args)
    assert decoupled.decoupled_ffn_flops(2048, 5024, 384, True, 77) == \
        jdecoupled.decoupled_ffn_flops(2048, 5024, 384, True, 77)
    # the model's latent tree holds the counted populations (router and
    # norms among n_fp16, scalars aside)
    cfg = registry.reduced(registry.get_config("pquant-100m", n_experts=n))
    pc = param_count(cfg)
    tree = api.init_model(0, cfg, device=CPU)
    n8 = sum(t.numel() for p, t in adamw.tree_paths(tree) if str(p[-1]).startswith("w8"))
    assert n8 == pc["n_8bit"]


# ---------------------------------------------------------------------------
# the loss, its gradients, the step and the Trainer
# ---------------------------------------------------------------------------


def _jax_loss_grads(jcfg, params, batch):
    acts, choices = [], []
    with _jax_recording(acts), _jax_choices(choices):
        fn = jax.jit(jax.value_and_grad(lambda p, b: japi.loss_fn(p, b, jcfg), has_aux=True))
        (loss, metrics), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads, (acts, choices)


def _port_loss_grads(cfg, tparams, batch, replay=None, drops=None):
    acts, choices = [], []
    with _port_recording(acts, None if replay is None else replay[0]), \
            _port_choices(choices, None if replay is None else replay[1]), \
            _count_drops([] if drops is None else drops):
        leaves = adamw.tree_map(lambda p: p.detach().clone().requires_grad_(), tparams)
        loss, metrics = api.loss_fn(leaves, _tbatch(batch), cfg)
        forward = (list(acts), list(choices))  # remat runs each layer again in the backward
        flat = torch.autograd.grad(loss, adamw.tree_leaves(leaves), materialize_grads=True)
    return loss.item(), {k: v.item() for k, v in metrics.items()}, flat, forward


@pytest.fixture(scope="module", params=[2, 4])
def grads(request):
    jcfg, cfg = _cfgs(request.param, dtype="float32", remat=False)
    params, _ = japi.init_model(jax.random.PRNGKey(7), jcfg)
    tparams = _t(params)
    batch = _batch(2, 16, cfg.vocab_size)
    ref = _jax_loss_grads(jcfg, params, batch)
    drops = []
    got = _port_loss_grads(dataclasses.replace(cfg, remat=True), tparams, batch, drops=drops)
    replayed = _port_loss_grads(cfg, tparams, batch, replay=ref[3])
    # the batch overflows some expert's capacity in some layer: the drop
    # path runs forward and backward (the forward's four routers; remat's
    # second forward repeats them)
    assert sum(drops[:cfg.n_layers]) > 0, drops
    return tparams, ref, got, replayed


def test_lm_loss_and_aux_match_jax(grads):
    _, ref, got, replayed = grads
    f = _flips(ref[3][0], got[3][0])
    assert f["primary"] <= FLIP_RATE * f["codes"], f
    assert _choice_flips(ref[3][1], got[3][1]) == 0
    assert len(got[3][1]) == len(ref[3][1]) == 4  # one router a layer
    tol = ATOL + 2 * ATOL_FLIP * f["tokens"] / f["of"]
    for run in (got, replayed):
        assert abs(run[0] - ref[0]) <= tol
        assert abs(run[1]["nll"] - ref[1]["nll"]) <= tol
        # the aux sums four layers' Switch losses and z-losses
        assert abs(run[1]["aux"] - ref[1]["aux"]) <= 1e-6 and run[1]["aux"] > 0


def test_model_gradients_match_jax(grads):
    """Every leaf (the router's among them) within GRAD_RTOL of its largest
    element, JAX's act-quant and routing decisions replayed; and as the
    port computes them (remat on) where no decision differs."""
    tparams, ref, got, replayed = grads
    jflat = _leaves(ref[2])
    paths = [p for p, _ in adamw.tree_paths(tparams)]
    assert any("router" in map(str, p) for p in paths)
    f = _flips(ref[3][0], got[3][0])
    runs = [replayed[2]] + ([got[2]] if f["primary"] == 0 else [])
    for flat in runs:
        for (jpath, jg), path, g in zip(jflat, paths, flat, strict=True):
            jg = np.asarray(jg)
            err = np.abs(g.numpy() - jg).max()
            assert err <= GRAD_RTOL * np.abs(jg).max() + 1e-12, (path, err)
    router = [g for p, g in zip(paths, replayed[2]) if "router" in map(str, p)][0]
    assert router.abs().max() > 0


def _run_jax_steps(jcfg, params, batches, probes_on=False):
    state = jtrainer.TrainState(params=params, opt=jadamw.init_adamw(params))
    step = jax.jit(jtrainer.make_train_step(jcfg, TOTAL, probes=probes_on))
    mets, acts, choices = [], [], []
    with _jax_recording(acts), _jax_choices(choices):
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            mets.append({k: float(v) for k, v in m.items()})
    na, nc = len(acts) // len(batches), len(choices) // len(batches)
    return state, mets, [(acts[i * na:(i + 1) * na], choices[i * nc:(i + 1) * nc])
                         for i in range(len(batches))]


def test_three_train_steps_match_jax():
    """``make_train_step`` (probes on) against JAX's jitted step, JAX's
    decisions replayed: AdamW sees the router leaf (decayed, as upstream's
    mask says) and the expert-stacked 8-bit leaves."""
    jcfg, cfg = _cfgs(4, dtype="float32", remat=False)
    params, _ = japi.init_model(jax.random.PRNGKey(11), jcfg)
    tparams = _t(params)
    batches = [_batch(4, 16, cfg.vocab_size, seed=10 + i) for i in range(STEPS)]
    jstate, jm, records = _run_jax_steps(jcfg, params, batches, probes_on=True)
    p = adamw.tree_map(torch.clone, tparams)
    state = trainer.TrainState(params=p, opt=adamw.init_adamw(p))
    step = trainer.make_train_step(cfg, TOTAL, probes=True)
    tm = []
    for b, replay in zip(batches, records):
        with _port_replay(replay[0]), _port_choices([], replay[1]):
            state, m = step(state, _tbatch(b))
        tm.append({k: v.item() for k, v in m.items()})
    assert adamw.tree_leaves(adamw._decay_mask(tparams, adamw.AdamWConfig())) == \
        jax.tree.leaves(jadamw._decay_mask(params, jadamw.AdamWConfig()))
    for a, b in zip(tm, jm):
        assert set(a) == set(b) and "qat_router_entropy" in a
        for k in ("loss", "nll"):
            assert abs(a[k] - b[k]) <= ATOL, (k, a[k], b[k])
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=GRAD_RTOL)
        assert 0.0 <= a["qat_router_entropy"] <= 1.0
        assert a["qat_router_entropy"] == pytest.approx(b["qat_router_entropy"], rel=1e-6)
    paths = [p for p, _ in adamw.tree_paths(tparams)]
    for name, tt, jt in (("mu", state.opt.mu, jstate.opt.mu), ("nu", state.opt.nu, jstate.opt.nu)):
        for path, t, j in zip(paths, adamw.tree_leaves(tt), jax.tree.leaves(jt)):
            err = np.abs(t.numpy() - np.asarray(j))
            assert err.max() <= GRAD_RTOL * np.abs(np.asarray(j)).max() + 1e-20, (name, path)
    # step 1 (lr > 0) moved the router and every expert that received tokens
    router = [t for p, t in adamw.tree_paths(state.params) if "router" in map(str, p)][0]
    assert not torch.equal(router, [t for p, t in adamw.tree_paths(tparams)
                                    if "router" in map(str, p)][0])


def test_trainer_history_matches_jax():
    """Three steps of the port's Trainer (probes on, the democratization
    snapshot after step 0) against JAX's Trainer from the same weights and
    pipeline batches, JAX's decisions replayed."""
    jcfg, cfg = _cfgs(4, dtype="float32", remat=False)
    tkw = dict(total_steps=STEPS, log_every=1000, probes=True, sensitivity_every=3,
               heartbeat_path=None)
    src = jpipeline.SyntheticSource(jcfg.vocab_size, seed=0)
    dcfg = jpipeline.DataConfig(seq_len=16, global_batch=4)
    jbatches = [(s, jpipeline.host_batch(src, dcfg, s)) for s in range(STEPS)]
    jtr = jtrainer.Trainer(jcfg, jtrainer.TrainerConfig(**tkw), iter(jbatches))
    params = jax.tree.map(np.asarray, jtr.state.params)
    acts, choices = [], []
    with _jax_recording(acts), _jax_choices(choices):
        jhist = jtr.run()
    na, nc = len(acts) // STEPS, len(choices) // STEPS
    records = iter([(acts[i * na:(i + 1) * na], choices[i * nc:(i + 1) * nc])
                    for i in range(STEPS)])

    tsrc, tdcfg = SyntheticSource(cfg.vocab_size, seed=0), DataConfig(seq_len=16, global_batch=4)
    data = ((s, host_batch(tsrc, tdcfg, s)) for s in range(STEPS))
    tr = trainer.Trainer(cfg, trainer.TrainerConfig(**tkw), data, device=CPU)
    with torch.no_grad():
        for t, a in zip(adamw.tree_leaves(tr.state.params), jax.tree.leaves(params)):
            t.copy_(torch.from_numpy(a.copy()))
    orig = tr.step_fn

    def replayed(state, batch):
        acts, choices = next(records)
        with _port_replay(acts), _port_choices([], choices):
            return orig(state, batch)

    tr.step_fn = replayed
    hist = tr.run()
    assert len(hist) == len(jhist) == STEPS
    assert "qat_router_entropy" in hist[0] and "demo_score_ffn8" in hist[0]
    for got, want in zip(hist, jhist):
        assert set(got) == set(want) and got["step"] == want["step"]
        for k, w in want.items():
            if k in ("step", "step_time_s"):
                continue
            assert abs(got[k] - w) <= HIST_TOL * max(1.0, abs(w)), (got["step"], k, got[k], w)


def test_router_entropy_tap_matches_jax_summaries():
    jcfg, cfg = _cfgs(4, dtype="float32", remat=False)
    params, _ = japi.init_model(jax.random.PRNGKey(5), jcfg)
    batch = _batch(2, 16, cfg.vocab_size, seed=3)
    with jprobes.collect():
        _, jm = jax.jit(lambda p, b: japi.loss_fn(p, b, jcfg))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    with probes.collect():
        _, tm = api.loss_fn(_t(params), _tbatch(batch), cfg)
    ent = tm["qat_router_entropy"].item()
    assert 0.0 <= ent <= 1.0
    np.testing.assert_allclose(ent, float(jm["qat_router_entropy"]), rtol=1e-6)


def test_bf16_remat_step_moves_router_and_experts():
    """The training configuration (bf16 forward, remat on): finite metrics,
    aux above 0, and after a step at lr > 0 the router and every expert
    that received a token moved."""
    _, cfg = _cfgs(4)
    assert cfg.dtype == "bfloat16" and cfg.remat
    state = trainer.init_train_state(0, cfg, device=CPU)
    ffn = state.params["segments"][0]["b0"]["ffn"]
    batches = [_tbatch(_batch(4, 16, cfg.vocab_size, seed=i)) for i in range(2)]
    with torch.no_grad():
        _, m = api.loss_fn(trainer.cast_for_forward(state.params, torch.bfloat16), batches[1],
                           cfg)
    assert torch.isfinite(m["aux"]) and m["aux"] > 0
    step = trainer.make_train_step(cfg, TOTAL)
    state, _ = step(state, batches[0])  # lr 0
    router0, w8_0 = ffn["router"]["w"].clone(), ffn["w8_up"].clone()
    choices = []
    with _port_choices(choices):
        state, met = step(state, batches[1])
    assert all(torch.isfinite(v) for v in met.values())
    assert not torch.equal(router0, ffn["router"]["w"])
    # choices of the step's forward (before remat's rerun): a layer each
    used = [set(np.unique(c)) for c in choices[:cfg.n_layers]]
    for layer in range(cfg.n_layers):
        for e in range(4):
            moved = not torch.equal(w8_0[layer, e], ffn["w8_up"][layer, e])
            if e in used[layer]:
                assert moved, (layer, e)


def test_checkpoint_keys_jax_restore_and_resume_with_experts(tmp_path):
    """N = 4 adds the router leaf: the checkpoint keys its params as JAX
    does, JAX's Checkpointer restores them bit for bit, and a Trainer that
    resumes from the checkpoint of step 2 ends where 4 uninterrupted steps
    do, bit for bit (bf16 forward, remat, probes on)."""
    jcfg, cfg = _cfgs(4)
    ck = str(tmp_path / "ck")
    whole = _trainer(cfg, 4, probes=True)
    whole.run()
    tkw = dict(total_steps=4, probes=True, ckpt_dir=ck, heartbeat_path=None)
    first = trainer.Trainer(cfg, trainer.TrainerConfig(**tkw), _data_iter(cfg, 2), device=CPU)
    first.run()
    jstate = jax.eval_shape(lambda: jtrainer.init_train_state(jax.random.PRNGKey(0), jcfg)[0])
    jkeys = [k for k, _ in jckpt._flatten(jstate._asdict())[0] if k.startswith("params/")]
    keys = json.loads((tmp_path / "ck" / "step_2" / "manifest.json").read_text())["keys"]
    assert [k for k in keys if k.startswith("params/")] == jkeys
    assert any("router" in k for k in jkeys) and "opt/mu/" + jkeys[-1][len("params/"):] in keys
    like = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), jstate.params)
    out = jckpt.Checkpointer(ck).restore({"params": like})["params"]
    for (path, t), a in zip(adamw.tree_paths(first.state.params), jax.tree.leaves(out)):
        np.testing.assert_array_equal(np.asarray(a), t.numpy(), err_msg=str(path))
    second = trainer.Trainer(cfg, trainer.TrainerConfig(**tkw), _data_iter(cfg, 4), device=CPU)
    assert second.start_step == 2
    second.run()
    want, got = _state_arrays(whole.state), _state_arrays(second.state)
    assert set(want) == set(got) and int(got["step"]) == 4
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_launch_train_cli_with_experts(tmp_path):
    out = tmp_path / "h.json"
    hist = launch_train.main(["--arch", "pquant-100m", "--reduced", "--n-experts", "4",
                              "--steps", "3", "--seq-len", "16", "--global-batch", "2",
                              "--device", "cpu", "--probes", "--log-every", "1",
                              "--history-out", str(out)])
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and 0 <= h["qat_router_entropy"] <= 1 for h in hist)
