"""The port's decoder against the JAX package on the reduced configs of the
paper's family (pquant, bitnet, bitnet158, none): the same weights (made
in JAX, converted leaf for leaf) and tokens go through both.

Tolerance (|logits| ~ 4): the float ops (matmuls, norms, softmax) sum in
another order in each framework, which leaves the logits ~1e-6 apart.  But
a last-ulp difference ahead of a per-token int8 activation quantization
can move one code by one step, and that moves the logits of its token and
of the later tokens that attend to it by up to ~2e-2.  So the logits must
agree within ATOL_FLIP everywhere and within ATOL at the median element:
a real fault moves most of them.  The integer parts (codes, accumulators,
export bytes) are held exactly in ``test_torch_quant.py`` and
``test_torch_kernels.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import api as japi
from repro.train.quantized_serving import quantize_params_for_serving as jquantize
from repro_torch.configs import registry
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import api
from repro_torch.train.quantized_serving import quantize_params_for_serving
from test_torch_train import _torch_one_thread  # noqa: F401  (autouse)

ATOL = 1e-5
ATOL_FLIP = 5e-2
MODES = ["pquant", "bitnet", "bitnet158", "none"]
CPU = torch.device("cpu")


def _cfgs(mode):
    return (jregistry.reduced(jregistry.get_config("pquant-100m", quant_mode=mode)),
            registry.reduced(registry.get_config("pquant-100m", quant_mode=mode)))


@pytest.fixture(scope="module", params=MODES)
def model(request):
    jcfg, cfg = _cfgs(request.param)
    params, axes = japi.init_model(jax.random.PRNGKey(7), jcfg)
    qparams, _ = jquantize(params, axes, jcfg, packed=True)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), CPU)
    return jcfg, cfg, params, qparams, tparams


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _assert_logits_close(got, want):
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert err.max() <= ATOL_FLIP, err.max()
    assert np.median(err) <= ATOL, np.median(err)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.mark.parametrize("size", ["100m", "1.3b"])
@pytest.mark.parametrize("mode", MODES)
def test_configs_equal_jax_field_for_field(size, mode):
    j = jregistry.get_config(f"pquant-{size}", quant_mode=mode)
    t = registry.get_config(f"pquant-{size}", quant_mode=mode)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(registry.reduced(t)) == dataclasses.asdict(jregistry.reduced(j))
    if mode != "pquant":
        assert registry.get_config(f"{mode}-{size}") == t


def test_unported_architectures_raise():
    """No arch of the JAX registry is left unported: each builds, field for
    field JAX's; an unknown arch still raises ``KeyError``."""
    assert registry.NOT_PORTED == ()
    for arch in jregistry.ARCHS:
        assert dataclasses.asdict(registry.get_config(arch)) == dataclasses.asdict(
            jregistry.get_config(arch))
    with pytest.raises(KeyError):
        registry.get_config("no-such-arch")


def test_init_matches_jax_tree_structure(model):
    jcfg, cfg, params, _, _ = model
    mine = params_to_numpy(api.init_model(3, cfg, device=CPU))
    theirs = jax.tree.map(np.asarray, params)
    for (pa, a), (pb, b) in zip(_leaves(mine), _leaves(theirs), strict=True):
        assert jax.tree_util.keystr(pa) == jax.tree_util.keystr(pb)
        assert a.shape == b.shape and a.dtype == b.dtype, jax.tree_util.keystr(pa)


def test_convert_round_trip_keeps_leaves(model):
    _, _, params, qparams, _ = model
    for tree in (params, qparams):
        np_tree = jax.tree.map(np.asarray, tree)
        back = params_to_numpy(params_from_numpy(np_tree, CPU))
        for (pa, a), (_, b) in zip(_leaves(np_tree), _leaves(back), strict=True):
            assert a.dtype == b.dtype, jax.tree_util.keystr(pa)
            np.testing.assert_array_equal(a, b)


def test_packed_export_equals_jax(model):
    jcfg, cfg, _, qparams, tparams = model
    mine = params_to_numpy(quantize_params_for_serving(tparams, cfg, packed=True))
    theirs = jax.tree.map(np.asarray, qparams)
    for (pa, a), (pb, b) in zip(_leaves(mine), _leaves(theirs), strict=True):
        name = jax.tree_util.keystr(pa)
        assert name == jax.tree_util.keystr(pb)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=name)


def test_latent_forward_matches_jax(model):
    jcfg, cfg, params, _, tparams = model
    toks = _tokens(2, 12, cfg.vocab_size, seed=1)
    jl, jaux = japi.forward(params, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, aux = api.forward(tparams, {"tokens": torch.from_numpy(toks).long()}, cfg)
    assert tl.shape == jl.shape
    _assert_logits_close(tl.numpy(), jl)
    assert float(aux) == float(jaux) == 0.0


def test_packed_forward_chunk_matches_jax(model):
    jcfg, cfg, _, qparams, _ = model
    tq = params_from_numpy(jax.tree.map(np.asarray, qparams), CPU)
    toks = _tokens(2, 8, cfg.vocab_size, seed=2)
    jcache, _ = japi.init_cache(jcfg, 2, 16, jnp.float32)
    jl, _ = japi.forward_chunk(qparams, jnp.asarray(toks), jcache, jnp.asarray(0, jnp.int32), jcfg)
    cache = api.init_cache(cfg, 2, 16, torch.float32, device=CPU)
    tl, _ = api.forward_chunk(tq, torch.from_numpy(toks).long(), cache, 0, cfg)
    _assert_logits_close(tl.numpy(), jl)


@pytest.mark.parametrize("packed", [False, True])
def test_prefill_then_decode_reproduces_forward(model, packed):
    jcfg, cfg, _, qparams, tparams = model
    tree = params_from_numpy(jax.tree.map(np.asarray, qparams), CPU) if packed else tparams
    toks = torch.from_numpy(_tokens(2, 10, cfg.vocab_size, seed=3)).long()
    full, _ = api.forward(tree, {"tokens": toks}, cfg)
    p = 6
    logits, caches = api.prefill(tree, {"tokens": toks[:, :p]}, cfg, cache_len=16)
    steps = [logits]
    for i in range(p, toks.shape[1] - 1):
        step, caches = api.decode_step(tree, toks[:, i:i + 1], caches, i, cfg)
        steps.append(step[:, -1])
    got = torch.stack(steps, dim=1)
    _assert_logits_close(got.numpy(), full[:, p - 1:-1].numpy())


def test_chunked_cache_paths_agree(model):
    """Lockstep (int position), per-slot (tensor positions) and masked
    (``active``/``lengths``) cache writes give the same logits."""
    _, cfg, _, _, tparams = model
    toks = torch.from_numpy(_tokens(2, 6, cfg.vocab_size, seed=4)).long()
    base = api.init_cache(cfg, 2, 12, torch.float32, device=CPU)
    ref, ref_cache = api.forward_chunk(tparams, toks, base, 0, cfg)
    pos = torch.zeros(2, dtype=torch.int32)
    got, got_cache = api.forward_chunk(
        tparams, toks, api.init_cache(cfg, 2, 12, torch.float32, device=CPU), pos, cfg,
        active=torch.ones(2, dtype=torch.bool), lengths=torch.full((2,), 6),
    )
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
    for a, b in zip(jax.tree.leaves(params_to_numpy(ref_cache)),
                    jax.tree.leaves(params_to_numpy(got_cache))):
        np.testing.assert_array_equal(a, b)
    # a slot outside ``active`` writes nothing
    _, masked = api.forward_chunk(
        tparams, toks, api.init_cache(cfg, 2, 12, torch.float32, device=CPU), pos, cfg,
        active=torch.tensor([True, False]),
    )
    assert not masked[0]["b0"]["k"][:, 1].any() and masked[0]["b0"]["k"][:, 0].any()


def test_entry_points_need_a_device_without_cuda():
    _, cfg = _cfgs("pquant")
    if torch.cuda.is_available():
        assert api.init_cache(cfg, 1, 4)[0]["b0"]["k"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            api.init_model(0, cfg)
