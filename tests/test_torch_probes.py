"""The port's QAT probes and sensitivity metrics against the JAX package,
on the CPU: ``core.sensitivity``, the ambient collector and the forward
taps, ``train_step_probes`` (upstream's three-tree call, and the in-place
design the port's step uses), and ``sensitivity_snapshot``.  Inputs are
numpy-seeded; model weights are made in JAX on ``registry.reduced``
pquant-100m and converted leaf for leaf.

Tolerances:

* sensitivity metrics: within SENS_RTOL relative, an element of a map
  (the Hessian, the OBS map) within SENS_RTOL of the map's largest (f32
  sums in another order);
* probes: flip counts and the INT8 clip count exact; the rest within
  PROBE_RTOL, but ``qat_scale_drift_absmean`` within DRIFT_ATOL absolute:
  it is a mean over slices of |lam_new - lam_old| / lam_old, and each
  AbsMean lam is an f32 sum of thousands of |w| that the two frameworks
  add in other orders (JAX's lam measured up to 4.6e-7 relative from the
  exact mean at these shapes), so the difference of two lams near each
  other keeps only that much of its value;
* forward taps: within TAP_RTOL of JAX's, and bit for bit between the
  port's two remat settings.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import sensitivity as jsens
from repro.models import api as japi
from repro.telemetry import probes as jprobes
from repro.train import trainer as jtrainer
from repro_torch.configs import registry
from repro_torch.convert import params_from_numpy
from repro_torch.core import quantization as q
from repro_torch.core import sensitivity as sens
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.telemetry import probes
from repro_torch.train import trainer
from test_torch_train import _jax_recording, _replaying

SENS_RTOL = 1e-5
PROBE_RTOL = 1e-6
DRIFT_ATOL = 1e-6
TAP_RTOL = 1e-5
CPU = torch.device("cpu")


def _t(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


def _cfgs(mode="pquant", **kw):
    jcfg = jregistry.reduced(jregistry.get_config("pquant-100m", quant_mode=mode))
    cfg = registry.reduced(registry.get_config("pquant-100m", quant_mode=mode))
    return (dataclasses.replace(jcfg, dtype="float32", **kw),
            dataclasses.replace(cfg, dtype="float32", **kw))


def _batch(b, s, vocab, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------------------
# core.sensitivity
# ---------------------------------------------------------------------------


def _heavy(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * np.exp(rng.standard_normal(shape))).astype(np.float32)


SENS_CASES = {
    "input_hessian": lambda m, x, w: m.input_hessian(x),
    "obs_sensitivity": lambda m, x, w: m.obs_sensitivity(w, x),
    "democratization_score": lambda m, x, w: m.democratization_score(m.obs_sensitivity(w, x)),
    "sensitivity_kurtosis": lambda m, x, w: m.sensitivity_kurtosis(m.obs_sensitivity(w, x)),
    "top_fraction_mass": lambda m, x, w: m.top_fraction_mass(m.obs_sensitivity(w, x)),
    "top_fraction_mass_10pct": lambda m, x, w: m.top_fraction_mass(w * w, 0.1),
    "max_pool_2d": lambda m, x, w: m.max_pool_2d(m.obs_sensitivity(w, x), (8, 4)),
}


@pytest.mark.parametrize("name", sorted(SENS_CASES))
def test_sensitivity_matches_jax(name):
    x = np.random.default_rng(1).standard_normal((512, 64)).astype(np.float32)
    w = _heavy(2, (64, 32))
    fn = SENS_CASES[name]
    want = np.asarray(fn(jsens, jnp.asarray(x), jnp.asarray(w)))
    got = fn(sens, torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=SENS_RTOL,
                               atol=SENS_RTOL * np.abs(want).max())


def test_sensitivity_scores_order_as_the_paper_says():
    """Uniform sensitivity scores ~1 and a peaked map far less; binarized
    weights are more democratized than their heavy-tailed latents."""
    uniform = torch.ones(64, 64)
    peaked = torch.ones(64, 64)
    peaked[0, 0] = 1e6
    assert sens.democratization_score(uniform).item() > 0.999
    assert sens.democratization_score(peaked).item() < 0.5
    w = torch.from_numpy(_heavy(3, (64, 32)))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((512, 64)).astype(np.float32))
    s_fp = sens.democratization_score(sens.obs_sensitivity(w, x))
    s_1b = sens.democratization_score(sens.obs_sensitivity(q.binarize_weights(w)[0], x))
    assert s_1b.item() > s_fp.item()


# ---------------------------------------------------------------------------
# the ambient collector and the forward taps
# ---------------------------------------------------------------------------


def test_activation_clip_tap():
    # per-token AbsMax: amax = 4, so the three 4.0s sit on the 127 rail
    x = torch.tensor([[4.0, 4.0, 4.0, 1.0]])
    with probes.collect():
        q.quantize_activations_int8(x)
        out = probes.summaries()
    np.testing.assert_allclose(out["qat_clip_act"].item(), 0.75, rtol=1e-6)


def test_taps_are_silent_outside_collect():
    q.quantize_activations_int8(torch.tensor([[4.0, 4.0]]))
    assert not probes.active()
    assert probes.summaries() == {}


def test_collector_ratios_merge_and_nesting():
    with probes.collect() as outer:
        probes.add("branch1_sq", 3.0)
        probes.add("branch8_sq", 1.0)
        with probes.collect() as inner:  # the inner scope shadows the outer one
            probes.add_mean("clip_act", 1.0, 1.0)
            probes.add_mean("clip_act", torch.tensor(0.0), 3.0)
            drained = inner.drain()
        assert probes._COLLECTOR is outer and "clip_act_sum" not in outer.sums
        probes.merge(drained)
        probes.merge(None)
        out = probes.summaries()
    np.testing.assert_allclose(out["qat_branch_share8"].item(), 0.25)
    np.testing.assert_allclose(out["qat_clip_act"].item(), 0.25)
    assert not probes.active()


def test_tap_values_equal_jax_on_one_forward():
    """``api.loss_fn`` inside ``collect()``: the clip rate and the branch
    share of the port's forward against JAX's on the same weights."""
    jcfg, cfg = _cfgs(remat=False)
    params, _ = japi.init_model(jax.random.PRNGKey(5), jcfg)
    batch = _batch(2, 16, cfg.vocab_size)
    with jprobes.collect():
        _, jm = japi.loss_fn(params, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    with probes.collect():
        _, tm = api.loss_fn(_t(params), {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    for k in ("qat_clip_act", "qat_branch_share8"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=TAP_RTOL)
    _, plain = api.loss_fn(_t(params), {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    assert set(plain) == {"nll", "aux"}


def _step_metrics(cfg, tparams, batches, probes_on, replays=None):
    """The port's step over ``batches`` from ``tparams``; each step replays
    ``replays[i]`` (JAX's act-quant decisions) when given."""
    params = adamw.tree_map(torch.clone, tparams)
    state = trainer.TrainState(params, adamw.init_adamw(params))
    step = trainer.make_train_step(cfg, 40, probes=probes_on)
    out = []
    for i, b in enumerate(batches):
        with _port_replay(replays[i]) if replays else contextlib.nullcontext():
            state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        out.append({k: v.item() for k, v in m.items()})
    return out, state


@contextlib.contextmanager
def _port_replay(decisions):
    """The port's act-quant sites take their codes and AbsMax elements from
    ``decisions`` (JAX's, site by site: ``test_torch_train._replaying``),
    and the clip-rate tap counts those codes.  Remat off: each site runs
    once."""
    inner = _replaying(decisions)
    codes = iter([np.clip(np.round(v), -127, 127) for v, _ in decisions])

    def quantize(x):
        c = next(codes)
        if probes.active():
            q.tap_clip_act(torch.from_numpy(c.reshape(x.shape)))
        return inner(x)

    orig = q.quantize_activations_int8
    q.quantize_activations_int8 = quantize
    try:
        yield
    finally:
        q.quantize_activations_int8 = orig


def _run_jax(jcfg, params, batches, probes_on=True):
    """JAX's jitted step over ``batches``: each step's metrics and
    act-quant decisions."""
    state, _ = jtrainer.init_train_state(jax.random.PRNGKey(0), jcfg)
    state = state._replace(params=params)
    step = jax.jit(jtrainer.make_train_step(jcfg, 40, probes=probes_on))
    mets, record = [], []
    with _jax_recording(record):
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            mets.append({k: float(v) for k, v in m.items()})
    n = len(record) // len(batches)
    return mets, [record[i * n:(i + 1) * n] for i in range(len(batches))]


class _TapCount:
    """Counts the values recorded into an ambient collector."""

    def __init__(self, monkeypatch):
        self.n = 0
        orig = probes.ProbeCollector.add

        def add(coll, name, value):
            self.n += 1
            orig(coll, name, value)

        monkeypatch.setattr(probes.ProbeCollector, "add", add)


@pytest.fixture(scope="module")
def step_runs():
    """Two steps with probes from the same JAX weights: JAX's, the port's
    replaying JAX's act-quant decisions (remat off), and the port's as it
    computes, remat off and on."""
    jcfg, cfg = _cfgs(remat=False)
    params, _ = japi.init_model(jax.random.PRNGKey(9), jcfg)
    tparams = _t(params)
    batches = [_batch(4, 16, cfg.vocab_size, seed=20 + i) for i in range(2)]
    jm, records = _run_jax(jcfg, params, batches)
    replayed = _step_metrics(cfg, tparams, batches, True, replays=records)[0]
    runs = {remat: _step_metrics(dataclasses.replace(cfg, remat=remat), tparams, batches, True)[0]
            for remat in (False, True)}
    return jm, replayed, runs, (cfg, tparams, batches)


def test_step_taps_match_jax(step_runs):
    jm, replayed, _, _ = step_runs
    for got, want in zip(replayed, jm):
        assert {k for k in got if k.startswith("qat_")} == {k for k in want if k.startswith("qat_")}
        np.testing.assert_allclose(got["qat_clip_act"], want["qat_clip_act"], rtol=PROBE_RTOL)
        np.testing.assert_allclose(got["qat_branch_share8"], want["qat_branch_share8"],
                                   rtol=TAP_RTOL)


@pytest.mark.parametrize("remat", [False, True])
def test_taps_record_once_a_forward_under_both_remat_settings(step_runs, remat, monkeypatch):
    """Remat's second forward runs after ``collect()`` has closed: a step
    records as many values with remat on as off (a ratio alone would not
    show a double count), and every metric is bit for bit the same; the
    checkpointed layers' recomputation does not trip on the taps."""
    _, _, runs, (cfg, tparams, batches) = step_runs
    assert runs[remat] == runs[False]
    count = _TapCount(monkeypatch)
    counts = []
    for r in (False, remat):
        count.n = 0
        _step_metrics(dataclasses.replace(cfg, remat=r), tparams, batches[:1], True)
        counts.append(count.n)
    # two values a clip site (sum, weight), one a branch norm, 2 norms a layer
    assert counts[0] == counts[1] and counts[0] > 2 * cfg.n_layers, counts


def test_probes_off_adds_no_metric_and_no_tap(monkeypatch):
    _, cfg = _cfgs()
    calls = []
    monkeypatch.setattr(probes, "add", lambda *a: calls.append(a))
    tparams = trainer.init_train_state(0, cfg, device="cpu").params
    mets, _ = _step_metrics(cfg, tparams, [_batch(2, 16, cfg.vocab_size)], False)
    assert set(mets[0]) == {"loss", "nll", "grad_norm", "lr", "wd"} and calls == []


# ---------------------------------------------------------------------------
# param-side probes
# ---------------------------------------------------------------------------


def _np_trees(seed=0, scale=1e-3):
    """(old, new, grads) numpy trees: reduced pquant-100m weights from JAX,
    the same perturbed, and seeded gradients."""
    jcfg, _ = _cfgs()
    params, _ = japi.init_model(jax.random.PRNGKey(3), jcfg)
    old = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    new = jax.tree.map(lambda a: (a + scale * rng.standard_normal(a.shape)).astype(a.dtype), old)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(a.dtype), old)
    return old, new, grads


def _jax_probes(old, new, grads):
    out = jprobes.train_step_probes(*(jax.tree.map(jnp.asarray, t) for t in (old, new, grads)))
    return {k: float(v) for k, v in out.items()}


def _family_sizes(tree) -> dict:
    sizes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        fam = jprobes.family_of(jprobes.leaf_path(path))
        if fam is not None and leaf.ndim >= 2:
            sizes[fam] = sizes.get(fam, 0) + leaf.size
    return sizes


def _assert_probes_close(got: dict, want: dict, sizes: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].item() if torch.is_tensor(got[k]) else got[k]
        if k.startswith("qat_flip_"):  # counts, exactly
            n = sizes[k[len("qat_flip_"):]]
            assert round(g * n) == round(w * n) and abs(g * n - round(g * n)) < 1e-3, (k, g, w)
        elif k == "qat_clip_w8":
            n = sizes["ffn8"]
            assert round(g * n) == round(w * n), (k, g, w)
        elif k == "qat_scale_drift_absmean":
            assert abs(g - w) <= DRIFT_ATOL, (k, g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=PROBE_RTOL, err_msg=k)


@pytest.mark.parametrize("scale", [1e-3, 3e-2])
def test_train_step_probes_match_jax(scale):
    old, new, grads = _np_trees(scale=scale)
    want = _jax_probes(old, new, grads)
    got = probes.train_step_probes(*(params_from_numpy(t, CPU) for t in (old, new, grads)))
    assert got["qat_flip_ffn1"].item() > 0 and got["qat_scale_drift_absmax"].item() > 0
    _assert_probes_close(got, want, _family_sizes(old))


def test_in_place_probes_match_the_three_tree_call():
    """``ParamProbes`` as the step drives it: each leaf watched, then
    overwritten in place with its new value, then compared."""
    old, new, grads = _np_trees(seed=1)
    want = _jax_probes(old, new, grads)
    live = params_from_numpy(old, CPU)
    tnew, tgrads = params_from_numpy(new, CPU), params_from_numpy(grads, CPU)
    pp = probes.ParamProbes()
    for (path, w), w_new, g in zip(adamw.tree_paths(live), adamw.tree_leaves(tnew),
                                   adamw.tree_leaves(tgrads)):
        after = pp.watch(path, w, g)
        w.copy_(w_new)
        if after is not None:
            after(w)
    _assert_probes_close(pp.result(), want, _family_sizes(old))


def test_step_probes_match_jax_on_the_steps_own_trees(monkeypatch):
    """The port's step with probes updates the master in place; its probe
    metrics equal JAX's ``train_step_probes`` on that step's (old, new,
    grads), captured around the update."""
    jcfg, cfg = _cfgs()
    params, _ = japi.init_model(jax.random.PRNGKey(13), jcfg)
    tparams = _t(params)
    seen = {}
    orig = trainer.adamw_update

    def capture(grads, state, params, *a, **kw):
        seen["old"] = adamw.tree_map(lambda t: t.clone().numpy(), params)
        seen["grads"] = adamw.tree_map(lambda t: t.clone().numpy(), grads)
        return orig(grads, state, params, *a, **kw)

    monkeypatch.setattr(trainer, "adamw_update", capture)
    batches = [_batch(4, 16, cfg.vocab_size, seed=30 + i) for i in range(2)]
    mets, state = _step_metrics(cfg, tparams, batches, True)
    assert mets[1]["lr"] > 0 and mets[1]["qat_flip_ffn1"] > 0
    new = adamw.tree_map(lambda t: t.numpy(), state.params)
    want = _jax_probes(seen["old"], new, seen["grads"])
    got = {k: v for k, v in mets[1].items() if k in want}
    _assert_probes_close(got, want, _family_sizes(params))


def test_hand_built_probe_values():
    """Upstream's hand-built cases: flip counts, drift, the branch split,
    the INT8 clip rate, and skipped leaves."""
    t = torch.tensor
    w_old = t([[1.0, -1.0], [1.0, -1.0]])
    out = probes.train_step_probes({"mixer": {"w": w_old}}, {"mixer": {"w": -w_old}},
                                   {"mixer": {"w": torch.zeros(2, 2)}})
    assert out["qat_flip_attn"].item() == 1.0 and out["qat_scale_drift_absmean"].item() == 0.0
    w8_old = t([[2.0, 1.0], [0.5, 2.0]])
    old = {"ffn": {"w1_up": w_old, "w8_up": w8_old}}
    new = {"ffn": {"w1_up": t([[1.0, -1.0], [-1.0, 1.0]]), "w8_up": w8_old / 2.0}}
    grads = {"ffn": {"w1_up": t([[3.0, 4.0], [0.0, 0.0]]), "w8_up": torch.full((2, 2), 2.0)}}
    out = probes.train_step_probes(old, new, grads)
    assert out["qat_flip_ffn1"].item() == 0.5 and out["qat_flip_ffn8"].item() == 0.0
    np.testing.assert_allclose(out["qat_scale_drift_absmax"].item(), 1.0 / (2.0 + q.EPS),
                               rtol=1e-6)
    np.testing.assert_allclose(out["qat_gnorm_ffn1"].item(), 5.0)
    np.testing.assert_allclose(out["qat_gnorm_ffn8"].item(), 4.0)
    np.testing.assert_allclose(out["qat_gnorm_share8"].item(), 16.0 / 41.0, rtol=1e-6)
    w8 = {"ffn": {"w8_up": t([[1.0, 0.5], [0.25, 1.0]])}}
    out = probes.train_step_probes(w8, w8, {"ffn": {"w8_up": torch.zeros(2, 2)}})
    assert out["qat_clip_w8"].item() == 0.5
    skipped = {"ffn_norm": {"scale": torch.ones(4, 4)},
               "ffn": {"subln": {"scale": torch.ones(4, 4)}, "router": {"w": torch.ones(4, 4)}}}
    assert probes.train_step_probes(skipped, skipped, skipped) == {}


def test_family_classification_and_paths_match_jax():
    old, _, _ = _np_trees()
    jkeys = [jprobes.leaf_path(p) for p, _ in jax.tree_util.tree_flatten_with_path(old)[0]]
    tkeys = [probes.leaf_path(p) for p, _ in adamw.tree_paths(params_from_numpy(old, CPU))]
    assert tkeys == jkeys
    extra = ["segments/0/b0/ffn/router/w", "final_norm/scale", "lm_head/w", "x/w8_a", "y/w1"]
    assert [probes.family_of(k) for k in jkeys + extra] == \
        [jprobes.family_of(k) for k in jkeys + extra]


@pytest.mark.parametrize("max_elems", [1 << 20, 5000, 997])
def test_sensitivity_snapshot_matches_jax(max_elems):
    """Leaf by leaf from global offsets, the same strided elements as
    upstream's concatenation (997: a stride that leaves every leaf at
    another phase)."""
    old, _, _ = _np_trees()
    want = jprobes.sensitivity_snapshot(jax.tree.map(jnp.asarray, old), max_elems=max_elems)
    got = probes.sensitivity_snapshot(params_from_numpy(old, CPU), max_elems=max_elems)
    assert set(got) == set(want) and len(got) == 9
    for k in want:
        assert isinstance(got[k], float)
        np.testing.assert_allclose(got[k], want[k], rtol=SENS_RTOL, err_msg=k)


def test_sensitivity_snapshot_picks_upstreams_elements():
    """The selection itself, on leaves whose values are their offsets in
    the family's concatenation."""
    sizes = [(3, 7), (2, 5, 4), (11, 2)]
    tree, off = {}, 0
    for i, shp in enumerate(sizes):
        n = int(np.prod(shp))
        tree[f"l{i}"] = {"w1_up": torch.arange(off, off + n, dtype=torch.float32).reshape(shp)}
        off += n
    seen = {}
    orig = sens.democratization_score

    def spy(s):
        seen["s"] = s
        return orig(s)

    try:
        sens.democratization_score = spy
        probes.sensitivity_snapshot(tree, max_elems=10)
    finally:
        sens.democratization_score = orig
    k = -(-off // 10)
    np.testing.assert_array_equal(seen["s"].numpy(), np.arange(0, off, k, dtype=np.float32) ** 2)
