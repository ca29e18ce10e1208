"""Multi-head Latent Attention (MLA, DeepSeek-V2) and deepseek-v2-236b in the
port against the JAX package, on the CPU: ``registry.reduced`` of
deepseek-v2-236b (4 layers: one dense, three MoE; 4 heads, q_lora 32,
kv_lora 16, qk 16 + 8 rope, v 16; 8 routed experts top-2, one shared):
JAX's weights converted leaf for leaf, numpy-seeded inputs.

Tolerances, as ``tests/test_torch_moe.py`` sets them: trees and integers
exact; the MLA functions' outputs and the latent rows they write within
ATOL with JAX's act-quant decisions replayed in the port (a code can round
either way between two frameworks); the model's logits and loss within
ATOL on the tokens that met no differing code; gradients, steps and
histories with JAX's act-quant AND router decisions replayed, each
gradient leaf within GRAD_RTOL of its largest element.  In the port a
T-token ``mla_chunk`` writes the latent cache bit for bit as T
``mla_decode`` steps; its outputs agree with theirs within ATOL (the
attention and output matmuls run at T rows against one, and the CPU's
BLAS rounds a row apart by the row count).
"""

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
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.optim import adamw as jadamw
from repro.train import trainer as jtrainer
from repro_torch.configs import registry
from repro_torch.configs.base import param_count
from repro_torch.launch import train as launch_train
from repro_torch.models import api, attention, layers, transformer
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
from test_torch_moe import _jax_choices
from test_torch_probes import _port_replay
from test_torch_train import _flips, _jax_recording, _port_recording
from test_torch_trainer import _data_iter

ARCH = "deepseek-v2-236b"
TOTAL = 40
# the six archs of the JAX registry the port has still not ported
OTHERS = ("granite-20b", "deepseek-coder-33b", "whisper-large-v3", "phi-3-vision-4.2b",
          "mamba2-780m", "recurrentgemma-2b")
MODES = ("none", "bitnet", "bitnet158", "pquant")


def _cfgs(**kw):
    mode = kw.pop("quant_mode", "pquant")
    jcfg = jregistry.reduced(jregistry.get_config(ARCH, quant_mode=mode))
    cfg = registry.reduced(registry.get_config(ARCH, quant_mode=mode))
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _mla_params(jcfg, seed=3):
    jp, _ = jattn.init_mla(jax.random.PRNGKey(seed), jcfg)
    return jp, _t(jp)


# ---------------------------------------------------------------------------
# the config and the segment plan
# ---------------------------------------------------------------------------


def test_config_equals_jax_and_counts_236e9():
    for mode in MODES:
        j = jregistry.get_config(ARCH, quant_mode=mode)
        t = registry.get_config(ARCH, quant_mode=mode)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert dataclasses.asdict(registry.reduced(t)) == dataclasses.asdict(
            jregistry.reduced(j))
        assert param_count(t) == jparam_count(j)
    pc = param_count(registry.get_config(ARCH))
    assert abs(pc["total"] / 1e9 - 236) / 236 < 0.08  # tests/test_arch_smoke.py's pin
    assert set(registry.NOT_PORTED) == set(OTHERS)
    for arch in OTHERS:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            registry.get_config(arch)


def test_segment_plan_and_caches_keep_upstreams_layout():
    """The MoE plan with ``mixer="mla"``; the params tree JAX's leaf for
    leaf (paths and shapes); the latent cache in both layouts: no layer on
    the paged pool."""
    from repro.models import transformer as jtransformer

    jcfg, cfg = _cfgs()
    assert [(s.repeats, s.blocks, s.first_layer) for s in transformer.build_segments(cfg)] == [
        (s.repeats, tuple(transformer.BlockSpec(b.mixer, b.ffn, b.window) for b in s.blocks),
         s.first_layer) for s in jtransformer.build_segments(jcfg)]
    assert {b.mixer for s in transformer.build_segments(cfg) for b in s.blocks} == {"mla"}
    jparams = jax.eval_shape(lambda: japi.init_model(jax.random.PRNGKey(0), jcfg)[0])
    tparams = api.init_model(0, cfg, device=CPU)
    got = [("/".join(map(str, p)), tuple(t.shape), str(t.dtype)[6:])
           for p, t in adamw.tree_paths(tparams)]
    want = [("/".join(str(getattr(e, "key", getattr(e, "idx", ""))) for e in p), v.shape,
             str(v.dtype)) for p, v in _leaves(jparams)]
    assert got == want
    jc = jax.eval_shape(lambda: japi.init_cache(jcfg, 2, 16, jnp.float32)[0])
    for layout in ("dense", "paged"):
        c = api.init_cache(cfg, 2, 16, torch.float32, device=CPU, layout=layout, block_size=8)
        assert [("/".join(map(str, p)), tuple(t.shape)) for p, t in adamw.tree_paths(c)] == [
            ("/".join(str(getattr(e, "key", getattr(e, "idx", ""))) for e in p), v.shape)
            for p, v in _leaves(jc)]
        assert c[1]["b0"]["ckv"].shape == (cfg.n_layers - 1, 2, 16, cfg.kv_lora_rank)


# ---------------------------------------------------------------------------
# the MLA functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q_lora", [32, 0])
@pytest.mark.parametrize("mode", MODES)
def test_init_mla_tree_matches_jax(q_lora, mode):
    """Leaf names, shapes and dtypes JAX's: the q LoRA pair and ``q_norm``
    or one ``wq``; ``subln`` only in the quantized modes."""
    jcfg, cfg = _cfgs(quant_mode=mode, q_lora_rank=q_lora)
    jp, _ = jattn.init_mla(jax.random.PRNGKey(0), jcfg)
    tp = attention.init_mla(torch.Generator().manual_seed(0), cfg, (), CPU)
    got = [("/".join(map(str, p)), tuple(t.shape), str(t.dtype)[6:])
           for p, t in adamw.tree_paths(tp)]
    want = [("/".join(str(e.key) for e in p), v.shape, str(v.dtype)) for p, v in _leaves(jp)]
    assert got == want
    assert ("wq" in tp) == (q_lora == 0) and ("subln" in tp) == (mode != "none")


@pytest.mark.parametrize("q_lora", [32, 0])
@pytest.mark.parametrize("mode", MODES)
def test_mla_attention_matches_jax(q_lora, mode):
    """Full-sequence MLA over 12 tokens in every quant mode and both q arms
    (``_mla_q``'s q LoRA pair and its plain ``wq``): within ATOL of JAX's
    with JAX's act-quant decisions replayed; the q projection alone too."""
    jcfg, cfg = _cfgs(quant_mode=mode, q_lora_rank=q_lora, dtype="float32")
    jp, tp = _mla_params(jcfg)
    x = _x((2, 12, cfg.d_model), 4)
    rec = []
    with _jax_recording(rec):
        jy = jax.jit(lambda p, x: jattn.mla_attention(p, x, jcfg, jnp.arange(12)))(
            jp, jnp.asarray(x))
        jq = jax.jit(lambda p, x: jattn._mla_q(p, x, jcfg))(jp, jnp.asarray(x))
    sin, cos = layers.rope_table(torch.arange(12), cfg.qk_rope_dim, cfg.rope_theta)
    with _port_recording([], rec):
        y = attention.mla_attention(tp, torch.from_numpy(x), cfg, sin, cos)
        q = attention._mla_q(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
    for a, b in zip(q, jq, strict=True):
        assert a.shape == b.shape == (2, 12, cfg.n_heads, a.shape[-1])
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL)


L, T = 16, 4  # the latent cache's length and the chunk's


def _cache(cfg, seed=5):
    """A latent cache of L positions holding noise (B 3)."""
    return {"ckv": _x((3, L, cfg.kv_lora_rank), seed),
            "krope": _x((3, L, cfg.qk_rope_dim), seed + 1)}


CHUNKS = {  # name -> (pos, lengths, active, read_to)
    "lockstep": (6, None, None, None),
    "ragged": ([3, 0, 9], [4, 2, 3], None, 13),
    "inactive": ([3, 0, 9], [4, 2, 3], [True, False, True], 14),
}


@pytest.mark.parametrize("case", list(CHUNKS))
def test_mla_chunk_matches_jax(case):
    """A T-token chunk over a latent cache of noise: per-slot positions,
    ragged ``lengths``, an inactive slot and the static ``read_to`` bound;
    outputs within ATOL of JAX's (decisions replayed), the latent cache
    after the chunk within ATOL of JAX's with every row JAX leaves alone
    untouched, bit for bit."""
    jcfg, cfg = _cfgs(dtype="float32")
    jp, tp = _mla_params(jcfg)
    pos, lengths, active, read_to = CHUNKS[case]
    x = _x((3, T, cfg.d_model), 6)
    cache = _cache(cfg)
    jpos = jnp.asarray(pos, jnp.int32)
    jlen = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    jact = None if active is None else jnp.asarray(active)
    rec = []
    with _jax_recording(rec):
        jy, jc = jax.jit(lambda p, x, c: jattn.mla_chunk(p, x, c, jpos, jcfg, active=jact,
                                                          lengths=jlen, read_to=read_to))(
            jp, jnp.asarray(x), jax.tree.map(jnp.asarray, cache))
    tpos = pos if isinstance(pos, int) else torch.tensor(pos, dtype=torch.int32)
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    with _port_recording([], rec):
        y, c = attention.mla_chunk(
            tp, torch.from_numpy(x), tc, tpos, cfg,
            attention.rope_at(tpos, T, cfg.qk_rope_dim, cfg.rope_theta),
            active=None if active is None else torch.tensor(active),
            lengths=None if lengths is None else torch.tensor(lengths), read_to=read_to)
    assert c is tc  # in place
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
    for k in cache:
        want = np.asarray(jc[k])
        np.testing.assert_allclose(c[k].numpy(), want, rtol=0, atol=ATOL)
        same = want == cache[k]
        np.testing.assert_array_equal(c[k].numpy()[same], cache[k][same])
    if active is not None:  # the inactive slot's rows: all as they were
        for k in cache:
            np.testing.assert_array_equal(c[k][1].numpy(), cache[k][1])


@pytest.mark.parametrize("pos", [7, "0-d", "per-slot"])
def test_mla_decode_matches_jax(pos):
    """One decode step at a shared Python-int position, a 0-d position
    and per-slot positions with an inactive slot: outputs and the cache
    within ATOL of JAX's (decisions replayed)."""
    jcfg, cfg = _cfgs(dtype="float32")
    jp, tp = _mla_params(jcfg)
    x = _x((3, 1, cfg.d_model), 7)
    cache = _cache(cfg, 8)
    active = None
    if pos == "per-slot":
        jpos, tpos, active = jnp.asarray([2, 15, 9], jnp.int32), torch.tensor([2, 15, 9]), \
            [True, True, False]
    elif pos == "0-d":
        jpos, tpos = jnp.asarray(11, jnp.int32), torch.tensor(11)
    else:
        jpos, tpos = jnp.asarray(pos, jnp.int32), pos
    jact = None if active is None else jnp.asarray(active)
    rec = []
    with _jax_recording(rec):
        jy, jc = jax.jit(lambda p, x, c: jattn.mla_decode(p, x, c, jpos, jcfg, active=jact))(
            jp, jnp.asarray(x), jax.tree.map(jnp.asarray, cache))
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    with _port_recording([], rec):
        y, c = attention.mla_decode(tp, torch.from_numpy(x), tc, tpos, cfg,
                                    attention.rope_at(tpos, 1, cfg.qk_rope_dim, cfg.rope_theta),
                                    active=None if active is None else torch.tensor(active))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
    for k in cache:
        np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k]), rtol=0, atol=ATOL)
    if active is not None:
        for k in cache:
            np.testing.assert_array_equal(c[k][2].numpy(), cache[k][2])


@pytest.mark.parametrize("packed", [False, True])
def test_mla_chunk_equals_decode_steps(packed):
    """In the port, one T-token chunk (per-slot positions, every token
    valid) against T decode steps from the same cache: the latent cache
    bit for bit, each token's output within ATOL (see the module
    docstring), on the fake-quant params and on the packed export."""
    from repro_torch.train.quantized_serving import quantize_params_for_serving

    _, cfg = _cfgs(dtype="float32")
    params = api.init_model(0, cfg, device=CPU)
    if packed:
        params = quantize_params_for_serving(params, cfg, packed=True)
    mp = params["segments"][0]["b0"]["mixer"]
    x = torch.from_numpy(_x((3, T, cfg.d_model), 9))
    cache = {k: torch.from_numpy(v) for k, v in _cache(cfg, 10).items()}
    steps = {k: v.clone() for k, v in cache.items()}
    pos = torch.tensor([2, 5, 11])
    y, _ = attention.mla_chunk(mp, x, cache, pos, cfg,
                               attention.rope_at(pos, T, cfg.qk_rope_dim, cfg.rope_theta),
                               lengths=torch.full((3,), T))
    for i in range(T):
        yi, _ = attention.mla_decode(mp, x[:, i:i + 1], steps, pos + i, cfg,
                                     attention.rope_at(pos + i, 1, cfg.qk_rope_dim,
                                                       cfg.rope_theta))
        np.testing.assert_allclose(yi[:, 0].numpy(), y[:, i].numpy(), rtol=0, atol=ATOL)
    for k in cache:
        assert torch.equal(cache[k], steps[k]), k


# ---------------------------------------------------------------------------
# the model: forward, loss and gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def grads():
    """The 2-layer cut (the dense layer and one MoE layer): JAX's logits,
    loss and gradients (remat off) with its act-quant and router
    decisions; the port's as it trains (remat on); the port's replaying
    JAX's decisions."""
    jcfg, cfg = _cfgs(dtype="float32", remat=False, n_layers=2)
    params, _ = japi.init_model(jax.random.PRNGKey(7), jcfg)
    tparams = _t(params)
    batch = _batch(2, 16, cfg.vocab_size)

    def jloss(p, b):  # upstream's lm_loss, with its logits out: one compile
        logits, aux = japi.forward(p, b, jcfg)
        loss, nll = jlayers.cross_entropy_loss(logits, b["labels"])
        return loss + aux, ({"nll": nll, "aux": aux}, logits)

    acts, choices = [], []
    with _jax_recording(acts), _jax_choices(choices):
        (loss, (metrics, jlogits)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    ref = (float(loss), {k: float(v) for k, v in metrics.items()}, jgrads, (acts, choices))
    got = _port_loss_grads(dataclasses.replace(cfg, remat=True), tparams, batch)
    replayed = _port_loss_grads(cfg, tparams, batch, replay=ref[3])
    return cfg, tparams, batch, np.asarray(jlogits), ref, got, replayed


def _port_loss_grads(cfg, tparams, batch, replay=None):
    acts, choices = [], []
    with _port_recording(acts, None if replay is None else replay[0]), \
            _port_choices(choices, None if replay is None else replay[1]):
        leaves = adamw.tree_map(lambda p: p.detach().clone().requires_grad_(), tparams)
        loss, metrics = api.loss_fn(leaves, _tbatch(batch), cfg)
        forward = (list(acts), list(choices))  # remat runs each layer again in the backward
        flat = torch.autograd.grad(loss, adamw.tree_leaves(leaves), materialize_grads=True)
    return loss.item(), {k: v.item() for k, v in metrics.items()}, flat, forward


def test_forward_logits_and_loss_match_jax(grads):
    """Logits within ATOL with JAX's decisions replayed, and as the port
    computes them on every token that met no differing code; the loss
    within ATOL plus the reach of the tokens that did; the router choices
    equal as computed."""
    cfg, tparams, batch, jlogits, ref, got, replayed = grads
    acts, choices = [], []
    with torch.no_grad(), _port_recording(acts), _port_choices(choices):
        logits, _ = api.forward(tparams, _tbatch(batch), cfg)
    with torch.no_grad(), _port_recording([], ref[3][0]), _port_choices([], ref[3][1]):
        rep, _ = api.forward(tparams, _tbatch(batch), cfg)
    np.testing.assert_allclose(rep.numpy(), jlogits, rtol=0, atol=ATOL)
    f = _flips(ref[3][0], acts)
    assert f["primary"] <= FLIP_RATE * f["codes"], f
    assert _choice_flips(ref[3][1], choices) == 0 and len(choices) == 1
    met = np.zeros(f["of"], bool)
    for (va, _), (vb, _) in zip(ref[3][0], acts):
        met |= (np.round(va).clip(-127, 127) != np.round(vb.reshape(va.shape)).clip(-127, 127)
                ).reshape(f["of"], -1).any(-1)
    err = np.abs(logits.numpy() - jlogits).reshape(f["of"], -1)
    assert err[~met].max() <= ATOL and np.median(err) <= ATOL, (err.max(), met.sum())
    tol = ATOL + 2 * ATOL_FLIP * f["tokens"] / f["of"]
    for run in (got, replayed):
        assert abs(run[0] - ref[0]) <= tol and abs(run[1]["nll"] - ref[1]["nll"]) <= tol
        assert abs(run[1]["aux"] - ref[1]["aux"]) <= 1e-6 and run[1]["aux"] > 0


def test_model_gradients_match_jax(grads):
    """Every leaf (the MLA projections, ``q_norm``, ``kv_norm``, ``subln``,
    the experts, the router, the untied head) within GRAD_RTOL of its
    largest element, JAX's decisions replayed; and as the port computes
    them (remat on) where no decision differs."""
    _, tparams, _, _, ref, got, replayed = grads
    paths = ["/".join(map(str, p)) for p, _ in adamw.tree_paths(tparams)]
    for name in ("wq_down", "wq_up", "q_norm", "wkv_down", "wkv_up", "kv_norm", "subln", "wo"):
        assert f"segments/0/b0/mixer/{name}" in "|".join(paths), name
    f = _flips(ref[3][0], got[3][0])
    runs = [replayed[2]] + ([got[2]] if f["primary"] == 0 else [])
    for flat in runs:
        for (_, jg), path, g in zip(_leaves(ref[2]), paths, flat, strict=True):
            jg = np.asarray(jg)
            err = np.abs(g.numpy() - jg).max()
            assert err <= GRAD_RTOL * np.abs(jg).max() + 1e-12, (path, err)
    for path, g in zip(paths, replayed[2]):
        if "/mixer/" in path:
            assert g.abs().max() > 0, path


# ---------------------------------------------------------------------------
# the step, the Trainer, the CLI
# ---------------------------------------------------------------------------


def test_two_train_steps_match_jax():
    """``make_train_step`` (probes on) against JAX's jitted step on the
    2-layer cut, JAX's decisions replayed: losses, gradient norm and QAT
    metrics; step 1 (lr > 0) moves every MLA leaf and the router."""
    jcfg, cfg = _cfgs(dtype="float32", remat=False, n_layers=2)
    params, _ = japi.init_model(jax.random.PRNGKey(11), jcfg)
    tparams = _t(params)
    batches = [_batch(2, 16, cfg.vocab_size, seed=10 + i) for i in range(2)]
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
    tm = []
    for i, b in enumerate(batches):
        with _port_replay(acts[i * na:(i + 1) * na]), \
                _port_choices([], choices[i * nc:(i + 1) * nc]):
            state, m = step(state, _tbatch(b))
        tm.append({k: v.item() for k, v in m.items()})
    for a, b in zip(tm, jm):
        assert set(a) == set(b) and "qat_router_entropy" in a
        for k in ("loss", "nll"):
            assert abs(a[k] - b[k]) <= ATOL, (k, a[k], b[k])
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=GRAD_RTOL)
        for k in b:
            if k.startswith("qat_"):
                assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-7), k
    paths = ["/".join(map(str, p)) for p, _ in adamw.tree_paths(tparams)]
    for path, before, after, j in zip(paths, adamw.tree_leaves(tparams),
                                      adamw.tree_leaves(state.params),
                                      jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(after.numpy(), np.asarray(j), rtol=0, atol=1e-6,
                                   err_msg=path)
        if "/mixer/" in path or "router" in path:
            assert not torch.equal(before, after), path


def test_trainer_checkpoint_keys_and_probe_families_match_jax(tmp_path):
    """A ``Trainer`` run on reduced deepseek-v2-236b (bf16 forward, remat,
    probes on, a checkpoint at the end): finite history; the checkpoint's
    keys JAX's ``Checkpointer`` layout; every leaf's probe family JAX's
    (the MLA projections probed as attention)."""
    from repro.telemetry import probes as jprobes

    jcfg, cfg = _cfgs()
    assert cfg.dtype == "bfloat16" and cfg.remat
    ck = str(tmp_path / "ck")
    tkw = dict(total_steps=2, log_every=1000, probes=True, ckpt_dir=ck, ckpt_every=2,
               heartbeat_path=None)
    tr = trainer.Trainer(cfg, trainer.TrainerConfig(**tkw), _data_iter(cfg, 2), device=CPU)
    hist = tr.run()
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(v) for h in hist for k, v in h.items() if k != "step")
    jstate = jax.eval_shape(lambda: jtrainer.init_train_state(jax.random.PRNGKey(0), jcfg)[0])
    jkeys = [k for k, _ in jckpt._flatten(jstate._asdict())[0] if k.startswith("params/")]
    keys = json.loads(next((tmp_path / "ck").glob("step_*/manifest.json")).read_text())["keys"]
    assert [k for k in keys if k.startswith("params/")] == jkeys
    assert "params/segments/0/b0/mixer/wkv_up/w" in jkeys
    for path, _ in adamw.tree_paths(tr.state.params):
        key = "/".join(map(str, path))
        assert probes.family_of(key) == jprobes.family_of(key), key


def test_launch_train_cli_deepseek_v2(tmp_path):
    out = tmp_path / "h.json"
    hist = launch_train.main(["--arch", ARCH, "--reduced", "--steps", "2", "--seq-len", "8",
                              "--global-batch", "2", "--device", "cpu", "--probes",
                              "--log-every", "1", "--history-out", str(out)])
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) and 0 <= h["qat_router_entropy"] <= 1 for h in hist)
    assert json.loads(out.read_text())[-1]["step"] == 1
