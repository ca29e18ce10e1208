"""Sliding-window and local/global attention in the port against the JAX
package, on the CPU: ``registry.reduced`` of gemma3-27b (5 local : 1 global
at full size; reduced: window 16, every 2nd layer global, theta 1e6 global
and 1e4 local) and of h2o-danube-1.8b (every layer windowed), and
``tests/test_continuous_batching.py``'s SWA_CFG (window 4, every 3rd layer
global, local theta 1e3): JAX's weights converted leaf for leaf,
numpy-seeded inputs, sequences longer than the window.

Tolerances, as ``tests/test_torch_train.py`` sets them: masks, segment
plans and the ring caches' bytes exact; the ring chunk's outputs within
ATOL of JAX's and bit for bit what T decode steps of the port give;
activations within ACT_RTOL and ACT_ATOL, their gradients within GRAD_RTOL
of the largest; logits within ATOL, or ATOL_FLIP where an
act-quant code is decided two ways (at most FLIP_RATE of the codes are
primary flips); the loss within ATOL plus the reach of the tokens that
met a differing code; every gradient leaf within GRAD_RTOL of its largest
element with JAX's act-quant decisions replayed in the port.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import param_count as jparam_count
from repro.core import decoupled as jdecoupled
from repro.core.quantization import QuantConfig as JQuantConfig
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig, param_count
from repro_torch.core import decoupled
from repro_torch.core.quantization import QuantConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import api, attention, layers, transformer
from repro_torch.optim import adamw
from repro_torch.train import trainer
from test_torch_experts import ATOL, ATOL_FLIP, CPU, FLIP_RATE, GRAD_RTOL, _leaves, _t, _tbatch
from test_torch_train import (  # noqa: F401  (_torch_one_thread: an autouse fixture)
    _batch,
    _flips,
    _jax_recording,
    _port_loss_grads,
    _port_recording,
    _torch_one_thread,
)
from test_torch_trainer import _data_iter

ACT_RTOL, ACT_ATOL = 1e-6, 1e-6  # the two tanh-GeLU formulas round apart in f32
ARCHS = ("gemma3-27b", "h2o-danube-1.8b")


def _swa_cfg(cls, qcls, mode="pquant"):
    """``tests/test_continuous_batching.py``'s SWA_CFG in either package."""
    return cls(name="t2", family="decoder", n_layers=6, d_model=32, n_heads=4, n_kv_heads=2,
               d_ff=48, vocab_size=64, quant=qcls(mode=mode, r=16, num_experts=1),
               attn_type="swa", window_size=4, global_every=3, rope_theta_local=1e3)


def _cfgs(arch, mode="pquant", **kw):
    """(JAX cfg, port cfg): ``registry.reduced`` of ``arch``, or SWA_CFG."""
    if arch == "swa":
        jcfg, cfg = _swa_cfg(JModelConfig, JQuantConfig, mode), _swa_cfg(ModelConfig, QuantConfig,
                                                                           mode)
    else:
        jcfg = jregistry.reduced(jregistry.get_config(arch, quant_mode=mode))
        cfg = registry.reduced(registry.get_config(arch, quant_mode=mode))
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# the configs and the segment plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_jax_and_param_counts(arch):
    for mode in ("pquant", "bitnet", "bitnet158", "none"):
        j = jregistry.get_config(arch, quant_mode=mode)
        t = registry.get_config(arch, quant_mode=mode)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert dataclasses.asdict(registry.reduced(t)) == dataclasses.asdict(
            jregistry.reduced(j))
        assert param_count(t) == jparam_count(j)
    pc = {k: round(v / 1e9, 2) for k, v in param_count(registry.get_config(arch)).items()}
    want = ({"n_1bit": 25.60, "n_8bit": 1.02, "n_fp16": 1.41, "total": 28.03}
            if arch == "gemma3-27b" else {"total": 1.90})
    assert {k: pc[k] for k in want} == want


def test_full_segment_plans_and_layer_metadata_match_jax():
    """gemma3-27b: 10 repeats of (5 local + 1 global), then 2 local; every
    layer's window and local-theta flag JAX's; h2o-danube-1.8b: one
    segment of 24 windowed layers."""
    for arch in ARCHS:
        jcfg, cfg = jregistry.get_config(arch), registry.get_config(arch)
        jsegs, segs = jtransformer.build_segments(jcfg), transformer.build_segments(cfg)
        assert [(s.repeats, s.first_layer, [(b.mixer, b.ffn, b.window) for b in s.blocks])
                for s in segs] == [(s.repeats, s.first_layer,
                                    [(b.mixer, b.ffn, b.window) for b in s.blocks])
                                   for s in jsegs]
        for layer in range(cfg.n_layers):
            assert transformer.layer_window(cfg, layer) == jtransformer.layer_window(jcfg, layer)
            assert transformer.layer_uses_local_rope(cfg, layer) == \
                jtransformer.layer_uses_local_rope(jcfg, layer)
    g = transformer.build_segments(registry.get_config("gemma3-27b"))
    assert [(s.repeats, len(s.blocks), s.first_layer) for s in g] == [(10, 6, 0), (1, 2, 60)]
    assert [b.window for b in g[0].blocks] == [1024] * 5 + [0]
    for arch in ARCHS:  # each block's static window and theta are its layers' over the repeats
        cfg = registry.get_config(arch)
        metas = [(s.first_layer + r * len(s.blocks) + bi, b) for s in
                 transformer.build_segments(cfg) for r in range(s.repeats)
                 for bi, b in enumerate(s.blocks)]
        assert [layer for layer, _ in metas] == list(range(cfg.n_layers))
        for layer, b in metas:
            assert b.window == transformer.layer_window(cfg, layer)
            assert transformer._local_rope(cfg, b) == transformer.layer_uses_local_rope(cfg, layer)
    gcfg = registry.get_config("gemma3-27b")
    assert [layer for layer in range(62) if not transformer.layer_uses_local_rope(gcfg, layer)] \
        == list(range(5, 62, 6))
    d = transformer.build_segments(registry.get_config("h2o-danube-1.8b"))
    assert [(s.repeats, [b.window for b in s.blocks]) for s in d] == [(24, [4096])]


def test_params_tree_and_caches_keep_upstreams_layout():
    """A 5-layer cut of reduced gemma (global_every 2: 2 repeats of (local,
    global), then 1 local): params leaf for leaf JAX's paths, shapes and
    types; caches in both layouts JAX's, the local layers' dense rings of
    min(window, max_len) in the paged layout too."""
    jcfg, cfg = _cfgs("gemma3-27b", n_layers=5)
    jp = jax.eval_shape(lambda: japi.init_model(jax.random.PRNGKey(0), jcfg)[0])
    mine = api.init_model(0, cfg, device=CPU)
    flat = {"/".join(map(str, p)): tuple(t.shape) for p, t in adamw.tree_paths(mine)}
    theirs = {"/".join(str(getattr(e, "key", getattr(e, "idx", ""))) for e in p): a.shape
              for p, a in _leaves(jp)}
    assert flat == theirs
    assert flat["segments/0/b1/mixer/wq/w"] == (2, 64, 128) and "segments/1/b0/ffn/w1_up" in flat
    for layout in ("dense", "paged"):
        jc = jax.eval_shape(lambda: japi.init_cache(jcfg, 3, 40, jnp.float32, layout=layout,
                                                    block_size=8)[0])
        c = api.init_cache(cfg, 3, 40, torch.float32, device=CPU, layout=layout, block_size=8)
        assert [(jax.tree_util.keystr(p), a.shape) for p, a in _leaves(jc)] == \
            [(jax.tree_util.keystr(p), tuple(t.shape)) for p, t in _leaves(c)]
        assert c[0]["b0"]["k"].shape == (2, 3, 16, 4, 32)
        assert ("table" in c[0]["b1"]) == (layout == "paged") and "k" in c[1]["b0"]


# ---------------------------------------------------------------------------
# masks, activations, embeddings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq, skv, window", [(8, 8, 0), (8, 8, 3), (5, 12, 4), (12, 12, 16)])
def test_causal_mask_with_a_window_matches_jax(sq, skv, window):
    got = attention.causal_mask(sq, skv, window).numpy()
    want = np.asarray(jattn.causal_mask(sq, skv, window))
    np.testing.assert_array_equal(got, want)
    if window:  # each query sees at most `window` positions, itself included
        assert got.sum(-1).max() == min(window, skv)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu", "relu2"])
def test_activations_and_gradients_match_jax(name):
    """upstream's whole ACTIVATIONS; gelu is tanh-approximate."""
    assert set(decoupled.ACTIVATIONS) == set(jdecoupled.ACTIVATIONS)
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 4
    x[:3] = (0.0, -0.0, 1e-3)
    jfn = jdecoupled.ACTIVATIONS[name]
    want = np.asarray(jfn(jnp.asarray(x)))
    cot = np.cos(x)
    jgrad = np.asarray(jax.grad(lambda v: jnp.sum(jfn(v) * cot))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    y = decoupled.ACTIVATIONS[name](xt)
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=ACT_RTOL, atol=ACT_ATOL)
    assert np.abs(xt.grad.numpy() - jgrad).max() <= GRAD_RTOL * np.abs(jgrad).max()
    if name == "gelu":  # not the erf form
        erf = torch.nn.functional.gelu(torch.from_numpy(x))
        assert (erf - y.detach()).abs().max() > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma_embedding_scale_and_softcap_match_jax(dtype):
    """gemma scales its embeddings by sqrt(d_model) in the table's type (in
    bf16 the scale rounds first), exactly as JAX; a config that sets
    ``logit_softcap`` takes the ``c * tanh(logits / c)`` arm (held in
    f32); other names scale nothing."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((50, 24)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 7)).astype(np.int32)
    x = rng.standard_normal((2, 7, 24)).astype(np.float32) * 3
    for name, cap in (("gemma3-27b", 0.0), ("gemma-softcap", 5.0), ("t2", 0.0)):
        jcfg, cfg = _cfgs("swa", name=name, d_model=24, logit_softcap=cap)
        jt = jnp.asarray(table).astype(dtype)
        tt = torch.from_numpy(table).to(getattr(torch, dtype))
        je = np.asarray(jlayers.embed({"table": jt}, jnp.asarray(toks), jcfg).astype(jnp.float32))
        te = layers.embed({"table": tt}, torch.from_numpy(toks).long(), cfg).float().numpy()
        np.testing.assert_array_equal(te, je)
        plain = table[toks] if dtype == "float32" else tt[torch.from_numpy(toks).long()].float()
        assert np.array_equal(te, np.asarray(plain)) == ("gemma" not in name)
        if dtype != "float32":
            continue
        jl = np.asarray(jlayers.unembed({"table": jt}, jnp.asarray(x).astype(dtype), jcfg)
                        .astype(jnp.float32))
        tl = layers.unembed({"table": tt}, torch.from_numpy(x).to(tt.dtype), cfg).float().numpy()
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
        if cap:
            assert np.abs(tl).max() <= cap and np.abs(jl).max() > 0.9 * cap


# ---------------------------------------------------------------------------
# the ring chunk
# ---------------------------------------------------------------------------


def _ring_case(ragged: bool):
    """A wrapped ring (L 8; every slot already past position 8), a chunk of
    T 6 over it; per-slot positions, an inactive slot and ragged lengths
    when ``ragged``, else lockstep at position 13."""
    rng = np.random.default_rng(5)
    b, t, l, hq, hkv, d = 3, 6, 8, 4, 2, 16
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for h in (hq, hkv, hkv))
    cache = {n: rng.standard_normal((b, l, hkv, d)).astype(np.float32) for n in "kv"}
    if ragged:
        posmat = np.array([9, 14, 21], np.int32)[:, None] + np.arange(t, dtype=np.int32)
        valid = (np.arange(t)[None] < np.array([6, 4, 1])[:, None]) & \
            np.array([True, True, False])[:, None]
    else:
        posmat, valid = (13 + np.arange(t, dtype=np.int32))[None], None
    return q, k, v, cache, posmat, valid


@pytest.mark.parametrize("ragged", [False, True])
def test_ring_chunk_matches_jax_and_decode_steps(ragged):
    """``_ring_chunk`` on a wrapped ring: outputs within ATOL of JAX's, the
    ring's bytes after the chunk exactly JAX's (writes are placements); and
    bit for bit what T of the port's decode steps give (its dense decode
    branch: ``_slot_write`` at ``pos % L``, the ring's decode mask,
    ``_sdpa``)."""
    q, k, v, cache, posmat, valid = _ring_case(ragged)
    jout, jc = jattn._ring_chunk(*(jnp.asarray(a) for a in (q, k, v)),
                                 jax.tree.map(jnp.asarray, cache), jnp.asarray(posmat),
                                 None if valid is None else jnp.asarray(valid))
    tc = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tvalid = None if valid is None else torch.from_numpy(valid)
    out, c = attention._ring_chunk(tq, tk, tv, tc, torch.from_numpy(posmat), tvalid)
    assert c is tc  # in place
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=ATOL)
    for n in "kv":
        np.testing.assert_array_equal(c[n].numpy(), np.asarray(jc[n]))
    # T decode steps of the port on a fresh copy of the ring
    dc = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    b, t = q.shape[:2]
    pos = torch.from_numpy(np.broadcast_to(posmat, (b, t)).copy())
    l = cache["k"].shape[1]
    for i in range(t):
        ok = None if tvalid is None else tvalid[:, i]
        attention._slot_write(dc["k"], tk[:, i:i + 1], pos[:, i] % l, ok)
        attention._slot_write(dc["v"], tv[:, i:i + 1], pos[:, i] % l, ok)
        step = attention._sdpa(tq[:, i:i + 1], dc["k"], dc["v"],
                               attention._decode_mask(pos[:, i], l))
        assert torch.equal(step[:, 0], out[:, i]), i
    for n in "kv":
        assert torch.equal(dc[n], c[n])
    if ragged:  # the inactive slot's ring is untouched
        np.testing.assert_array_equal(c["k"][2].numpy(), cache["k"][2])


# ---------------------------------------------------------------------------
# the model: forward, loss and gradients
# ---------------------------------------------------------------------------

SEQ = 24  # past the reduced window of 16, and SWA_CFG's 4


@pytest.fixture(scope="module", params=[(a, m) for a in ARCHS + ("swa",)
                                        for m in ("pquant", "bitnet")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def grads(request):
    """JAX's logits, loss and gradients (remat off) with its act-quant
    decisions, the port's as it trains (remat on) and the port's replaying
    JAX's decisions.  pquant runs each config's whole depth; bitnet half
    of it (gemma: a local and a global layer; SWA_CFG: one period of two
    local layers and a global one), which JAX compiles in half the time."""
    arch, mode = request.param
    depth = {} if mode == "pquant" else {"n_layers": {"swa": 3}.get(arch, 2)}
    jcfg, cfg = _cfgs(arch, mode, dtype="float32", remat=False, **depth)
    params, _ = japi.init_model(jax.random.PRNGKey(7), jcfg)
    tparams = _t(params)
    batch = _batch(2, SEQ, cfg.vocab_size)

    def jloss(p, b):  # upstream's lm_loss, with its logits out: one compile
        logits, aux = jtransformer.forward(p, b, jcfg)
        loss, nll = jlayers.cross_entropy_loss(logits, b["labels"])
        return loss + aux, ({"nll": nll, "aux": aux}, logits)

    record = []
    with _jax_recording(record):
        (loss, (metrics, jlogits)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    ref = (float(loss), {k: float(v) for k, v in metrics.items()}, jgrads, record)
    got = _port_loss_grads(dataclasses.replace(cfg, remat=True), tparams, batch)
    replayed = _port_loss_grads(cfg, tparams, batch, replay=record)
    return cfg, tparams, batch, np.asarray(jlogits), ref, got, replayed


def test_forward_logits_match_jax(grads):
    """Logits as the port computes them within ATOL on every token that met
    no differing act-quant code (and in the median), within ATOL on every
    token with JAX's decisions replayed; the same forward with the local
    and global thetas swapped is far off (the per-layer pick is live)."""
    cfg, tparams, batch, jlogits, (_, _, _, jrec), *_ = grads
    rec, rep = [], []
    with torch.no_grad(), _port_recording(rec):
        logits, aux = api.forward(tparams, _tbatch(batch), cfg)
    with torch.no_grad(), _port_recording(rep, jrec):
        replayed, _ = api.forward(tparams, _tbatch(batch), cfg)
    f = _flips(jrec, rec)
    assert f["primary"] <= FLIP_RATE * f["codes"], f
    met = np.zeros(f["of"], bool)  # the tokens that met a differing code
    for (va, _), (vb, _) in zip(jrec, rec):
        met |= (np.round(va).clip(-127, 127) != np.round(vb.reshape(va.shape)).clip(-127, 127)
                ).reshape(f["of"], -1).any(-1)
    err = np.abs(logits.numpy() - jlogits).reshape(f["of"], -1)
    assert err[~met].max() <= ATOL and np.median(err) <= ATOL, (err.max(), met.sum())
    np.testing.assert_allclose(replayed.numpy(), jlogits, rtol=0, atol=ATOL)
    assert aux.item() == 0.0
    if cfg.global_every:
        swapped = dataclasses.replace(cfg, rope_theta=cfg.rope_theta_local,
                                      rope_theta_local=cfg.rope_theta)
        with torch.no_grad():
            other, _ = api.forward(tparams, _tbatch(batch), swapped)
        assert np.median(np.abs(other.numpy() - jlogits)) > 100 * ATOL


def test_lm_loss_matches_jax(grads):
    _, _, _, _, ref, got, replayed = grads
    f = _flips(ref[3], got[3])
    tol = ATOL + 2 * ATOL_FLIP * f["tokens"] / f["of"]
    assert abs(got[0] - ref[0]) <= tol and abs(got[1]["nll"] - ref[1]["nll"]) <= tol
    assert abs(replayed[0] - ref[0]) <= ATOL


def test_model_gradients_match_jax(grads):
    """Every leaf within GRAD_RTOL of its largest element, JAX's decisions
    replayed; and as the port computes them (remat on) where no primary
    flip occurred."""
    _, tparams, _, _, ref, got, replayed = grads
    paths = ["/".join(map(str, p)) for p, _ in adamw.tree_paths(tparams)]
    f = _flips(ref[3], got[3])
    runs = [replayed[2]] + ([got[2]] if f["primary"] == 0 else [])
    for flat in runs:
        for (_, jg), path, g in zip(_leaves(ref[2]), paths, flat, strict=True):
            jg = np.asarray(jg)
            err = np.abs(g.numpy() - jg).max()
            assert err <= GRAD_RTOL * np.abs(jg).max() + 1e-12, (path, err)


# ---------------------------------------------------------------------------
# the Trainer and the CLI
# ---------------------------------------------------------------------------


def test_trainer_run_on_danube(tmp_path):
    """A ``Trainer`` run on reduced h2o-danube-1.8b (bf16 forward, remat,
    probes on) over sequences past the window: finite history, the
    parameters moved, the checkpoint's keys the params tree's."""
    cfg = registry.reduced(registry.get_config("h2o-danube-1.8b"))
    assert cfg.dtype == "bfloat16" and cfg.remat and cfg.window_size == 16
    tkw = dict(total_steps=3, log_every=1000, probes=True, ckpt_dir=str(tmp_path / "ck"),
               ckpt_every=3, heartbeat_path=None)
    tr = trainer.Trainer(cfg, trainer.TrainerConfig(**tkw), _data_iter(cfg, 3, seq=24), device=CPU)
    first = [t.clone() for t in adamw.tree_leaves(tr.state.params)]
    hist = tr.run()
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(v) for h in hist for k, v in h.items() if k != "step")
    assert any(not torch.equal(a, b) for a, b in zip(first, adamw.tree_leaves(tr.state.params)))
    manifest = json.loads(next((tmp_path / "ck").glob("step_*/manifest.json")).read_text())
    assert [k for k in manifest["keys"] if k.startswith("params/")] == [
        "params/" + "/".join(map(str, p)) for p, _ in adamw.tree_paths(tr.state.params)]


def test_launch_train_cli_gemma(tmp_path):
    out = tmp_path / "h.json"
    hist = launch_train.main(["--arch", "gemma3-27b", "--reduced", "--steps", "2", "--seq-len",
                              "24", "--global-batch", "2", "--device", "cpu", "--log-every", "1",
                              "--history-out", str(out)])
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert json.loads(out.read_text())[-1]["step"] == 1
