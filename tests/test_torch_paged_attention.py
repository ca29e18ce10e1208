"""The port's paged attention against the JAX package: the plain version
(what ``ops.paged_attention`` runs on CPU tensors) against JAX's
``ref.paged_attention_ref`` and its Pallas kernel run with
``interpret=True`` (as ``tests/test_paged_attention.py`` runs it), the
port's own ``ref.paged_attention_ref``, the dispatch gates, and the model
stack's paged branches against JAX's.  A plain emulation of the CUDA
kernel's context partition and merge order (the split rule, empty
splits, the warps' and the cluster's merges, both routes) is held to
JAX at f32 within 1e-6, and the rule itself is tested.

Tolerances: f32 to atol 2e-6 (the kernel's online softmax reassociates
the reduction; upstream holds its kernel to the same); bf16 pools to
atol / rtol 0.02 against the f32 oracle (bf16 input rounding); the model
stack's logits to atol 3e-5, as upstream holds its kernel route to its
gather route.
"""

import functools
import inspect

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
    paged_attention_plan,
    paged_attention_route,
    split_columns,
    split_ranges,
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
    wide = torch.zeros((1, 8, 1, 136))  # past the kernel's 128
    with pytest.raises(ValueError, match="head_dim"):
        check_shapes(torch.zeros((1, 1, 1, 136)), wide, wide, torch.zeros((1, 1)))


# ---------------------------------------------------------------------------
# The CUDA kernel's split and merge, emulated in plain f32 NumPy
# ---------------------------------------------------------------------------

_NEG = np.float32(-1e30)
_WARPS = 4  # csrc kWarps
_TILE_COLS = 32  # csrc kTileCols


def _empty(n, d):
    return (np.full((n,), _NEG, np.float32), np.zeros((n,), np.float32),
            np.zeros((n, d), np.float32))


def _update(state, qr, k, v, cols, lim, c_hi, scale):
    """One online-softmax step of the rows ``qr`` over the staged columns
    ``cols`` (absolute), as the kernel takes it: masked scores -1e30, their
    probability forced to 0."""
    m, l, acc = state
    valid = (cols[None, :] <= lim[:, None]) & (cols[None, :] < c_hi)
    sc = np.where(valid, (qr @ k.T) * np.float32(scale), _NEG).astype(np.float32)
    mn = np.maximum(m, sc.max(axis=1))
    p = np.where(valid, np.exp(sc - mn[:, None]), np.float32(0)).astype(np.float32)
    alpha = np.exp(m - mn)
    return mn, l * alpha + p.sum(axis=1), acc * alpha[:, None] + p @ v


def _merge(states):
    """States merged in order: M = max m, each weighed by exp(m - M)."""
    mx = functools.reduce(np.maximum, [s[0] for s in states])
    w = [np.exp(s[0] - mx) for s in states]
    return (mx, sum(wi * s[1] for wi, s in zip(w, states)),
            sum(wi[:, None] * s[2] for wi, s in zip(w, states)))


def _emulate(q, kpool, vpool, table, start, kv_lens, splits=None):
    """The kernel's function by its own partition: the plan's row groups
    and splits (``splits`` forces another count), the pages up to the
    block's last attended column cut into ranges; on the split route the
    warps take the range's pages in turn and each (warp, column lane)
    keeps its own online softmax over the c-th column of every pass, the
    block merging those states warp by warp, lane by lane; on the tile
    route 32-column steps; then rank 0's merge of the ranks in order."""
    b, t, hq, d = q.shape
    _, bs, hkv, _ = kpool.shape
    mb = table.shape[1]
    g, scale = hq // hkv, d**-0.5
    tg = t * g
    plan = paged_attention_plan(b, t, hq, hkv, d, mb)
    if splits is not None:
        plan = plan._replace(splits=splits)
    cg = split_columns(plan.rows, bs)
    out = np.zeros_like(q)
    for bi, h in np.ndindex(b, hkv):
        keys = kpool[table[bi], :, h].reshape(mb * bs, d)
        vals = vpool[table[bi], :, h].reshape(mb * bs, d)
        st, ln = int(start[bi]), min(max(int(kv_lens[bi]), 1), mb * bs)
        for row0 in range(0, tg, plan.rows):
            rows = np.arange(row0, min(row0 + plan.rows, tg))
            qr = q[bi, rows // g, h * g + rows % g]
            lim = np.minimum(st + rows // g, ln - 1)
            ncols = int(lim.max()) + 1
            npages = -(-ncols // bs)
            states = []
            for lo, hi in split_ranges(plan.splits, npages):
                c_lo, c_hi = lo * bs, min(hi * bs, ncols)
                if plan.route == "split":
                    warps = []
                    for w in range(_WARPS):
                        lanes = []
                        for cl in range(cg):
                            state = _empty(len(rows), d)
                            for p in range(lo + w, hi, _WARPS):
                                for col in range(p * bs + cl, min((p + 1) * bs, c_hi), cg):
                                    cols = np.arange(col, col + 1)
                                    state = _update(state, qr, keys[cols], vals[cols], cols,
                                                    lim, c_hi, scale)
                            lanes.append(state)
                        while len(lanes) > 1:  # the shuffle tree: pairs, then pairs of pairs
                            lanes = [_merge(lanes[i:i + 2]) for i in range(0, len(lanes), 2)]
                        warps.append(lanes[0])
                    states.append(_merge(warps))
                else:
                    state = _empty(len(rows), d)
                    for c0 in range(c_lo, c_hi, _TILE_COLS):
                        cols = np.arange(c0, min(c0 + _TILE_COLS, c_hi))
                        state = _update(state, qr, keys[cols], vals[cols], cols, lim, c_hi,
                                        scale)
                    states.append(state)
            _, l, acc = _merge(states)
            out[bi, rows // g, h * g + rows % g] = acc / l[:, None]
    return out


# (T, G, D): decode, a 5-token slice, GQA and both with D 16, and a
# 16-token slice with D 32 (the split route); GQA slices of 8 and 16
# tokens with D 32 (32 and 64 query rows a KV head: the tile route)
_EMU_CASES = [(1, 1, 16), (5, 1, 16), (1, 4, 16), (5, 4, 16), (16, 1, 32), (8, 4, 32),
              (16, 4, 32)]


@functools.lru_cache(maxsize=None)
def _emu_inputs(t, g, d):
    """Four slots over 8 pages of 8: resident lengths of T (1 at decode),
    one page (or T), three and a bit, and the whole table, so that at 2-8
    splits whole ranges lie past a slot's length; each slot's queries end
    at its length."""
    b, hkv, bs, mb = 4, 2, 8, 8
    kpool, vpool, table = _setup(b, hkv, d, bs, mb, seed=5)
    q = _q(b, t, hkv * g, d, seed=6)
    lens = np.asarray([t, max(bs, t), 3 * bs + 2, mb * bs], np.int32)
    start = (lens - t).astype(np.int32)
    want, kern = _jax(q, kpool, vpool, table, start, lens)
    return q, kpool, vpool, table, start, lens, want, kern


@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("t,g,d", _EMU_CASES)
def test_emulated_split_and_merge_match_jax(t, g, d, splits):
    q, kpool, vpool, table, start, lens, want, kern = _emu_inputs(t, g, d)
    route = paged_attention_plan(q.shape[0], t, q.shape[2], kpool.shape[2], d, table.shape[1])
    assert route.route == ("tile" if t * g >= 32 and d % 32 == 0 else "split")
    got = _emulate(q, kpool, vpool, table, start, lens, splits)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, kern, atol=1e-6, rtol=0)


@pytest.mark.parametrize("t,g,d", _EMU_CASES)
def test_emulated_plan_matches_plain_version(t, g, d):
    """At the plan's own splits, the emulation and the plain version agree."""
    q, kpool, vpool, table, start, lens, want, _ = _emu_inputs(t, g, d)
    got = _emulate(q, kpool, vpool, table, start, lens)
    np.testing.assert_allclose(got, _port(q, kpool, vpool, table, start, lens), atol=1e-6,
                               rtol=0)


def test_empty_split_has_weight_zero():
    """A rank whose whole range lies past the length sends m = -1e30, l = 0,
    acc = 0: merged with a real state it changes nothing and gives no NaN;
    merged with another empty one it stays empty."""
    rng = np.random.default_rng(0)
    real = (rng.standard_normal(3).astype(np.float32), rng.random(3).astype(np.float32) + 1,
            rng.standard_normal((3, 8)).astype(np.float32))
    for states in ([real, _empty(3, 8)], [_empty(3, 8), real, _empty(3, 8)]):
        m, l, acc = _merge(states)
        np.testing.assert_array_equal(m, real[0])
        np.testing.assert_array_equal(l, real[1])
        np.testing.assert_array_equal(acc, real[2])
    m, l, acc = _merge([_empty(3, 8), _empty(3, 8)])
    assert (m == _NEG).all() and (l == 0).all() and (acc == 0).all()


_PLAN_SHAPES = [(b, t, hq, hkv, d, mb) for b in (1, 3, 16) for t in (1, 5, 64)
                for hq, hkv in ((32, 32), (32, 8), (4, 1)) for d in (16, 64, 256)
                for mb in (1, 2, 5, 8, 32, 33, 128)]


@pytest.mark.parametrize("shape", _PLAN_SHAPES[::7])
def test_split_rule_partitions_the_table(shape):
    """At every length a slot may have, each of its attended pages falls
    in exactly one split, in rank order, and no split reaches past them
    or past the table; the splits are a power of two up to 8, and more
    than one only where each split of the whole table keeps 2 pages."""
    b, t, hq, hkv, d, mb = shape
    plan = paged_attention_plan(*shape)
    assert 1 <= plan.splits <= 8 and plan.splits & (plan.splits - 1) == 0
    assert plan.splits == 1 or -(-mb // plan.splits) >= 2
    for npages in range(1, mb + 1):
        ranges = split_ranges(plan.splits, npages)
        assert len(ranges) == plan.splits
        owners = [k for k, (lo, hi) in enumerate(ranges) for _ in range(lo, hi)]
        assert owners == sorted(owners) and len(owners) == npages  # contiguous, each once
        assert all(0 <= lo <= hi <= npages <= mb for lo, hi in ranges)


def test_split_rule_reads_only_static_shapes():
    """The rule is a function of integer shapes alone (no tensor, so no
    kv_lens), and the plans at phase 8's shapes of the serving path."""
    assert list(inspect.signature(paged_attention_plan).parameters) == [
        "b", "t", "hq", "hkv", "d", "mb"]
    assert paged_attention_plan(16, 1, 32, 32, 64, 32) == ("split", 1, 1)  # decode
    assert paged_attention_plan(16, 1, 32, 8, 64, 32) == ("split", 4, 2)  # GQA decode
    assert paged_attention_plan(16, 64, 32, 32, 64, 32) == ("tile", 64, 2)  # 64-token slice
    assert paged_attention_plan(16, 64, 32, 32, 64, 32) == paged_attention_plan(
        np.int64(16), 64, 32, 32, 64, 32)


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
    GQA and bf16-pool shapes and at phase 8's decode shape (16 slots,
    ragged lengths up to 512, one at 512 and some at 1), max |err| <=
    1e-5, one launch a call; each case's route is the plan's; and one call
    under sync-debug "error" mode (the wrapper never synchronises)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cases = [(4, 2, 1, torch.float32, 3, 8, None), (4, 1, 5, torch.float32, 3, 8, None),
             (2, 2, 7, torch.bfloat16, 3, 8, None), (32, 32, 64, torch.float32, 3, 8, None)]
    lens16 = np.random.default_rng(0).integers(1, 513, 16).astype(np.int32)
    lens16[0], lens16[1:4] = 512, 1
    for dt in (torch.float32, torch.bfloat16):
        cases.append((32, 32, 1, dt, 16, 32, lens16))
    cases.append((32, 8, 1, torch.float32, 16, 32, lens16))
    for hq, hkv, t, dt, b, mb, lens in cases:
        d, bs = 64, 16
        kpool, vpool, table = _setup(b, hkv, d, bs, mb)
        q = _t(_q(b, t, hq, d)).to(dev)
        kp, vp = _t(kpool).to(dev, dt), _t(vpool).to(dev, dt)
        tb = _t(table).to(dev)
        if lens is None:
            start = torch.tensor([0, 17, mb * bs - t][:b], dtype=torch.int32, device=dev)
            kv = start + t
        else:
            kv = _t(lens).to(dev)
            start = kv - t
        plan = paged_attention_plan(b, t, hq, hkv, d, mb)
        assert paged_attention_route(b, t, hq, hkv, d, bs, mb, dt) == plan
        assert plan.route == ("tile" if t * hq // hkv >= 32 else "split")
        _cuda.reset_launches()
        got = paged_attention(q, kp, vp, tb, start, kv)
        assert _cuda.LAUNCHES["paged_attention"] == 1
        want = paged_attention_plain(q, kp, vp, tb, start, kv)
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= 1e-5, (hq, hkv, t, dt, b)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = paged_attention(q, kp, vp, tb, start, kv)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (got - want).abs().max().item() <= 1e-5
