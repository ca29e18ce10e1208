"""The port's paged attention against the JAX package: the plain version
(what ``ops.paged_attention`` runs on CPU tensors) against JAX's
``ref.paged_attention_ref`` and its Pallas kernel run with
``interpret=True`` (as ``tests/test_paged_attention.py`` runs it), the
port's own ``ref.paged_attention_ref``, the dispatch gates, and the model
stack's paged branches against JAX's.

Tolerances: f32 to atol 2e-6 (the kernel's online softmax reassociates
the reduction; upstream holds its kernel to the same); bf16 pools to
atol / rtol 0.02 against the f32 oracle (bf16 input rounding); the model
stack's logits to atol 3e-5, as upstream holds its kernel route to its
gather route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxConfig
from repro.core.quantization import QuantConfig as JaxQuant
from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention as pallas_paged_attention
from repro.models import api as japi
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.quantization import QuantConfig
from repro_torch.kernels import _cuda, ops, ref
from repro_torch.kernels.paged_attention import (
    check_shapes,
    paged_attention,
    paged_attention_plain,
)
from repro_torch.models import api

CPU = torch.device("cpu")
ATOL = 2e-6


def _setup(b, hkv, d, bs, mb, seed=0):
    """Random pools and a scattered per-slot disjoint block table."""
    rng = np.random.default_rng(seed)
    nb = b * mb + 3
    kpool = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    vpool = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    table = rng.permutation(nb)[: b * mb].reshape(b, mb).astype(np.int32)
    return kpool, vpool, table


def _q(b, t, hq, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, t, hq, d)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port(q, kpool, vpool, table, start, lens):
    return ops.paged_attention(_t(q), _t(kpool), _t(vpool), _t(table), _t(start),
                               _t(lens)).numpy()


def _jax(q, kpool, vpool, table, start, lens, dtype=jnp.float32):
    args = (jnp.asarray(q, dtype), jnp.asarray(kpool, dtype), jnp.asarray(vpool, dtype),
            jnp.asarray(table), jnp.asarray(start), jnp.asarray(lens))
    want = jref.paged_attention_ref(*(a.astype(jnp.float32) if a.dtype == dtype else a
                                      for a in args))
    kern = pallas_paged_attention(*args, interpret=True)
    return np.asarray(want), np.asarray(kern, np.float32)


@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 1), (2, 2)])  # GQA / MQA / MHA
@pytest.mark.parametrize("bs", [8, 16])
def test_decode_matches_jax(hq, hkv, bs):
    b, d, mb = 3, 16, 4
    kpool, vpool, table = _setup(b, hkv, d, bs, mb)
    q = _q(b, 1, hq, d)
    start = np.asarray([0, bs + 3, mb * bs - 1], np.int32)
    got = _port(q, kpool, vpool, table, start, start + 1)
    want, kern = _jax(q, kpool, vpool, table, start, start + 1)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, kern, atol=ATOL)


@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 1)])
@pytest.mark.parametrize("bs", [8, 16])
def test_chunk_matches_jax(hq, hkv, bs):
    """T > 1 against a resident prefix: the in-chunk causal mask and the
    prefix mask, one slot straddling a page."""
    b, t, d, mb = 2, 5, 8, 4
    kpool, vpool, table = _setup(b, hkv, d, bs, mb)
    q = _q(b, t, hq, d)
    start = np.asarray([3, bs - 2], np.int32)
    got = _port(q, kpool, vpool, table, start, start + t)
    want, kern = _jax(q, kpool, vpool, table, start, start + t)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, kern, atol=ATOL)


def test_one_shot_prefill_from_empty_cache():
    b, t, hq, hkv, d, bs, mb = 2, 12, 4, 2, 16, 8, 2
    kpool, vpool, table = _setup(b, hkv, d, bs, mb)
    q = _q(b, t, hq, d)
    start = np.zeros((b,), np.int32)
    got = _port(q, kpool, vpool, table, start, start + t)
    want, kern = _jax(q, kpool, vpool, table, start, start + t)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, kern, atol=ATOL)


def test_kv_lens_bounds_the_page_walk():
    """Pages past a slot's resident length are never read: NaN there stays
    invisible, and the result equals JAX's on the clean pools."""
    b, t, hq, hkv, d, bs, mb = 2, 1, 4, 2, 8, 8, 4
    kpool, vpool, table = _setup(b, hkv, d, bs, mb)
    start = np.asarray([2, bs + 1], np.int32)
    lens = start + t
    kp, vp = kpool.copy(), vpool.copy()
    for s in range(b):
        for pg in range(-(-int(lens[s]) // bs), mb):
            kp[table[s, pg]] = np.nan
            vp[table[s, pg]] = np.nan
    q = _q(b, t, hq, d)
    got = _port(q, kp, vp, table, start, lens)
    want, _ = _jax(q, kpool, vpool, table, start, lens)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_kv_lens_masks_within_a_page():
    """A row whose causal limit runs past ``kv_lens`` (the pad rows of a
    ragged slice) attends only the resident columns: garbage past the
    length, NaN here, never enters the softmax."""
    b, t, hq, hkv, d, bs, mb = 2, 4, 4, 2, 8, 8, 2
    kpool, vpool, table = _setup(b, hkv, d, bs, mb)
    start = np.asarray([3, 0], np.int32)
    lens = np.asarray([5, 1], np.int32)  # slot 0: 2 real tokens of 4; slot 1: 1 of 4
    kp, vp = kpool.copy(), vpool.copy()
    for s in range(b):
        for j in range(int(lens[s]), mb * bs):
            kp[table[s, j // bs], j % bs] = np.nan
            vp[table[s, j // bs], j % bs] = np.nan
    q = _q(b, t, hq, d)
    got = _port(q, kp, vp, table, start, lens)
    assert np.isfinite(got).all()
    want, _ = _jax(q, kpool, vpool, table, start, start + t)
    for s in range(b):  # the real rows are JAX's
        n = int(lens[s] - start[s])
        np.testing.assert_allclose(got[s, :n], want[s, :n], atol=ATOL)


def test_bf16_pools_accumulate_in_f32():
    b, t, hq, hkv, d, bs, mb = 2, 3, 4, 2, 16, 8, 3
    kpool, vpool, table = _setup(b, hkv, d, bs, mb)
    q = _q(b, t, hq, d)
    start = np.asarray([1, 7], np.int32)
    bf = torch.bfloat16
    got = ops.paged_attention(_t(q).to(bf), _t(kpool).to(bf), _t(vpool).to(bf), _t(table),
                              _t(start), _t(start + t))
    assert got.dtype == bf
    want, kern = _jax(q, kpool, vpool, table, start, start + t, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.02, rtol=0.02)
    np.testing.assert_allclose(got.float().numpy(), kern, atol=0.02, rtol=0.02)


def test_port_ref_matches_jax_ref():
    b, t, hq, hkv, d, bs, mb = 2, 3, 4, 2, 16, 8, 3
    kpool, vpool, table = _setup(b, hkv, d, bs, mb)
    q = _q(b, t, hq, d)
    start = np.asarray([2, 9], np.int32)
    got = ref.paged_attention_ref(_t(q), _t(kpool), _t(vpool), _t(table), _t(start),
                                  _t(start + t)).numpy()
    want, _ = _jax(q, kpool, vpool, table, start, start + t)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_gates_and_dispatch(monkeypatch):
    assert ops.paged_attention_supported(8, 16, 4, 2)
    assert not ops.paged_attention_supported(4, 16, 4, 2)  # block % 8
    assert not ops.paged_attention_supported(8, 12, 4, 2)  # head_dim % 8
    assert not ops.paged_attention_supported(8, 16, 4, 3)  # Hq % Hkv
    monkeypatch.setenv("REPRO_PAGED_ATTN", "1")
    assert ops.paged_attention_enabled(CPU) and ops.paged_attention_enabled("cuda")
    monkeypatch.setenv("REPRO_PAGED_ATTN", "0")
    assert not ops.paged_attention_enabled(CPU) and not ops.paged_attention_enabled("cuda")
    monkeypatch.delenv("REPRO_PAGED_ATTN")
    # auto: the kernel for CUDA tensors; the gather path (upstream's off-TPU
    # default) for CPU tensors
    assert ops.paged_attention_enabled("cuda") and not ops.paged_attention_enabled(CPU)
    # CPU tensors run the plain version: no launch
    b, hkv, d, bs, mb = 2, 2, 8, 8, 2
    kpool, vpool, table = _setup(b, hkv, d, bs, mb)
    q = _q(b, 1, 4, d)
    start = np.asarray([0, 5], np.int32)
    _cuda.reset_launches()
    got = _port(q, kpool, vpool, table, start, start + 1)
    assert sum(_cuda.LAUNCHES.values()) == 0
    np.testing.assert_array_equal(
        got, paged_attention_plain(_t(q), _t(kpool), _t(vpool), _t(table), _t(start),
                                   _t(start + 1)).numpy())


def test_shape_checks_raise():
    q = torch.zeros((2, 1, 4, 8))
    pool = torch.zeros((4, 8, 2, 8))
    table = torch.zeros((2, 2), dtype=torch.int32)
    check_shapes(q, pool, pool, table)
    with pytest.raises(ValueError):
        check_shapes(torch.zeros((2, 1, 3, 8)), pool, pool, table)  # Hq % Hkv
    with pytest.raises(ValueError):
        check_shapes(q, pool, pool, torch.zeros((3, 2), dtype=torch.int32))  # batch
    big = torch.zeros((1, 8, 1, 264))
    with pytest.raises(ValueError, match="head_dim"):
        check_shapes(torch.zeros((1, 1, 1, 264)), big, big, torch.zeros((1, 1)))


# ---------------------------------------------------------------------------
# The model stack's paged branches against JAX's
# ---------------------------------------------------------------------------

_KW = dict(name="pa", family="decoder", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
           d_ff=48, vocab_size=64)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxConfig(quant=JaxQuant(mode="pquant", r=16, num_experts=1), **_KW)
    cfg = ModelConfig(quant=QuantConfig(mode="pquant", r=16, num_experts=1), **_KW)
    jparams, _ = japi.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    return jcfg, cfg, jparams, tparams


def _drive(run_api, params, cfg, caches, to, b):
    """A full chunked-prefill slice, a ragged one, then three decode steps
    at ragged per-slot positions; returns every call's logits as numpy."""
    rng = np.random.default_rng(4)
    active = to(np.asarray([True, True]))
    out = []
    l, caches = run_api.forward_chunk(params, to(rng.integers(0, 64, (b, 4))), caches,
                                      to(np.zeros((b,), np.int32)), cfg, active=active)
    out.append(l)
    l, caches = run_api.forward_chunk(
        params, to(rng.integers(0, 64, (b, 4))), caches, to(np.full((b,), 4, np.int32)), cfg,
        active=active, lengths=to(np.asarray([4, 2], np.int32)),
        logits_at=to(np.asarray([3, 1], np.int32)))
    out.append(l)
    pos = np.asarray([8, 6], np.int32)
    for t in range(3):
        l, caches = run_api.decode_step(params, to(rng.integers(0, 64, (b, 1))), caches,
                                        to(pos + t), cfg, active)
        out.append(l)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("env", ["0", "1"])
def test_model_paged_branches_match_jax(tiny, monkeypatch, env):
    """forward_chunk (full and ragged slices) and decode_step on paged
    caches: the port's gather route (=0) and kernel route (=1, the plain
    version on the CPU) against JAX's same route."""
    jcfg, cfg, jparams, tparams = tiny
    monkeypatch.setenv("REPRO_PAGED_ATTN", env)
    b, max_len, bs = 2, 16, 8
    mb = max_len // bs
    table = np.arange(b * mb, dtype=np.int32).reshape(b, mb)
    jc, _ = japi.init_cache(jcfg, b, max_len, jnp.float32, layout="paged", block_size=bs)
    jc = [{k: dict(c, table=jnp.broadcast_to(jnp.asarray(table), c["table"].shape))
           for k, c in seg.items()} for seg in jc]
    tc = api.init_cache(cfg, b, max_len, torch.float32, CPU, layout="paged", block_size=bs)
    for seg in tc:
        for c in seg.values():
            c["table"][...] = _t(table)
    want = _drive(japi, jparams, jcfg, jc, jnp.asarray, b)
    got = _drive(api, tparams, cfg, tc, lambda a: torch.from_numpy(np.asarray(a)), b)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=3e-5)


def test_unsupported_block_size_takes_the_gather_path(tiny, monkeypatch):
    """Block size 4 fails the static gate: forcing the kernel route on
    keeps the gather path, bit for bit."""
    _, cfg, _, tparams = tiny
    b, max_len, bs = 2, 16, 4
    outs = {}
    for env in ("0", "1"):
        monkeypatch.setenv("REPRO_PAGED_ATTN", env)
        caches = api.init_cache(cfg, b, max_len, torch.float32, CPU, layout="paged",
                                block_size=bs)
        for seg in caches:
            for c in seg.values():
                c["table"][...] = torch.arange(b * 4, dtype=torch.int32).reshape(b, 4)
        tok = torch.tensor([[3], [7]])
        outs[env], _ = api.decode_step(tparams, tok, caches, torch.zeros((b,), dtype=torch.int32),
                                       cfg, torch.tensor([True, True]))
    assert torch.equal(outs["0"], outs["1"])


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: the kernel against its plain version at decode, chunk,
    GQA and bf16-pool shapes, max |err| <= 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    for hq, hkv, t, dt in ((4, 2, 1, torch.float32), (4, 1, 5, torch.float32),
                           (2, 2, 7, torch.bfloat16), (32, 32, 64, torch.float32)):
        b, d, bs, mb = 3, 64, 16, 8
        kpool, vpool, table = _setup(b, hkv, d, bs, mb)
        q = _t(_q(b, t, hq, d)).to(dev)
        kp, vp = _t(kpool).to(dev, dt), _t(vpool).to(dev, dt)
        tb = _t(table).to(dev)
        start = torch.tensor([0, 17, mb * bs - t], dtype=torch.int32, device=dev)
        lens = start + t
        _cuda.reset_launches()
        got = paged_attention(q, kp, vp, tb, start, lens)
        assert _cuda.LAUNCHES["paged_attention"] == 1
        want = paged_attention_plain(q, kp, vp, tb, start, lens)
        assert (got - want).abs().max().item() <= 1e-5
