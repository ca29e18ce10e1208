"""The port's paged KV pool against ``repro.serve.kv_pool``: ``write``,
``write_span`` and ``read`` bit for bit (masked entries write nothing, also
where they name a block another slot writes), the dense span write of the
model stack against JAX's, the block hashes, ``copy_block``, and
``BlockAllocator`` driven by one scripted sequence beside the JAX
allocator (every return value, count and metric equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattention
from repro.serve import kv_pool as jkv
from repro.serve.metrics import MetricsRegistry as JaxRegistry
from repro_torch.models import attention
from repro_torch.serve import kv_pool
from repro_torch.serve.metrics import MetricsRegistry
from test_torch_train import _torch_one_thread  # noqa: F401  (autouse)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pool(nb=10, bs=4, h=2, d=3, seed=0):
    return np.random.default_rng(seed).standard_normal((nb, bs, h, d)).astype(np.float32)


def test_write_matches_jax_with_inactive_slots():
    pool = _pool()
    table = np.asarray([[3, 1, 7], [2, 5, 0], [4, 6, 8]], np.int32)
    pos = np.asarray([5, 0, 11], np.int32)
    val = np.random.default_rng(1).standard_normal((3, 2, 3)).astype(np.float32)
    active = np.asarray([True, False, True])
    want = np.asarray(jkv.write(jnp.asarray(pool), jnp.asarray(table), jnp.asarray(pos),
                                jnp.asarray(val), jnp.asarray(active)))
    got = _t(pool)
    out = kv_pool.write(got, _t(table), _t(pos), _t(val), _t(active))
    assert out is got  # in place
    np.testing.assert_array_equal(got.numpy(), want)


def test_masked_entry_on_a_written_block_writes_nothing():
    """An inactive slot whose stale table row names a block another slot
    now owns must not clobber that slot's write (upstream drops it out of
    bounds; the port's scatter gives the index the written value)."""
    pool = _pool()
    table = np.asarray([[3, 1], [3, 1]], np.int32)  # slot 1's row is stale
    pos = np.asarray([2, 2], np.int32)
    val = np.stack([np.full((2, 3), 7.0), np.full((2, 3), -9.0)]).astype(np.float32)
    for active in ([True, False], [False, True]):
        want = np.asarray(jkv.write(jnp.asarray(pool), jnp.asarray(table), jnp.asarray(pos),
                                    jnp.asarray(val), jnp.asarray(active)))
        got = _t(pool)
        kv_pool.write(got, _t(table), _t(pos), _t(val), _t(np.asarray(active)))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("masks", ["none", "active", "lengths", "both"])
def test_write_span_matches_jax(masks):
    """Ragged lengths, inactive slots and positions past the table."""
    pool = _pool(nb=12)
    table = np.asarray([[3, 1, 7], [2, 5, 0], [4, 6, 8]], np.int32)
    pos = np.asarray([2, 9, 6], np.int32)  # slot 1 runs past the 12-position table
    val = np.random.default_rng(2).standard_normal((3, 5, 2, 3)).astype(np.float32)
    active = np.asarray([True, False, True]) if masks in ("active", "both") else None
    lengths = np.asarray([5, 2, 3], np.int32) if masks in ("lengths", "both") else None
    want = np.asarray(jkv.write_span(
        jnp.asarray(pool), jnp.asarray(table), jnp.asarray(pos), jnp.asarray(val),
        None if active is None else jnp.asarray(active),
        None if lengths is None else jnp.asarray(lengths)))
    got = _t(pool)
    kv_pool.write_span(got, _t(table), _t(pos), _t(val),
                       None if active is None else _t(active),
                       None if lengths is None else _t(lengths))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("blocks", [None, 1, 2, 5])
def test_read_matches_jax(blocks):
    pool = _pool()
    table = np.asarray([[3, 1, 7], [2, 5, 0]], np.int32)
    want = np.asarray(jkv.read(jnp.asarray(pool), jnp.asarray(table), blocks))
    got = kv_pool.read(_t(pool), _t(table), blocks).numpy()
    np.testing.assert_array_equal(got, want)


def test_copy_block_and_hashes_match_jax():
    pool = _pool()
    want = np.asarray(jkv.copy_block(jnp.asarray(pool), 2, 6))
    got = _t(pool)
    kv_pool.copy_block(got, 2, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    toks = np.random.default_rng(3).integers(0, 50, 37)
    assert kv_pool.prompt_block_hashes(toks, 8) == jkv.prompt_block_hashes(toks, 8)
    assert kv_pool.hash_block_tokens(None, toks[:4]) == jkv.hash_block_tokens(None, toks[:4])
    assert kv_pool.blocks_for(17, 8) == jkv.blocks_for(17, 8) == 3


def test_init_paged_cache_matches_jax():
    got = kv_pool.init_paged_attention_cache(3, 16, 2, 8, 7, 4, torch.float32)
    want, _ = jkv.init_paged_attention_cache(3, 16, 2, 8, 7, 4, jnp.float32)
    for k in ("kpool", "vpool", "table"):
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
    with pytest.raises(ValueError, match="multiple of block_size"):
        kv_pool.init_paged_attention_cache(1, 10, 2, 8, 4, 4, torch.float32)


@pytest.mark.parametrize("masks", ["active", "lengths", "both"])
def test_dense_span_write_matches_jax(masks):
    """The model stack's dense span write (one masked scatter) against
    JAX's ``_span_write``: inactive slots, ragged lengths and rows past the
    cache end write nothing."""
    rng = np.random.default_rng(5)
    cache = rng.standard_normal((3, 8, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 5, 2, 4)).astype(np.float32)
    rows = np.asarray([0, 4, 6], np.int32)[:, None] + np.arange(5, dtype=np.int32)[None]
    ok = np.ones((3, 5), bool)
    if masks in ("active", "both"):
        ok &= np.asarray([True, False, True])[:, None]
    if masks in ("lengths", "both"):
        ok &= np.arange(5)[None, :] < np.asarray([5, 3, 2])[:, None]
    want = np.asarray(jattention._span_write(jnp.asarray(cache), jnp.asarray(new),
                                             jnp.asarray(rows), jnp.asarray(ok)))
    got = _t(cache)
    attention._span_write(got, _t(new), _t(rows), _t(ok))
    np.testing.assert_array_equal(got.numpy(), want)


def _snap(reg):
    s = reg.snapshot()
    return s["counters"], s["gauges"]


def test_allocator_scripted_sequence_matches_jax():
    """alloc / unref / ref / register / lookup / LRU eviction / double free
    / fail_hook, step for step beside the JAX allocator."""
    fail = {"now": False}
    regs = (JaxRegistry(), MetricsRegistry())
    allocs = (jkv.BlockAllocator(6, fail_hook=lambda: fail["now"], metrics=regs[0]),
              kv_pool.BlockAllocator(6, fail_hook=lambda: fail["now"], metrics=regs[1]))

    def both(method, *args):
        out = []
        for a in allocs:
            try:
                out.append(("ok", getattr(a, method)(*args)))
            except ValueError as e:
                out.append(("raise", str(e)))
        assert out[0] == out[1], (method, args, out)
        assert [(a.free_count, a.used_count, a.cached_count) for a in allocs][0] == \
            (allocs[1].free_count, allocs[1].used_count, allocs[1].cached_count)
        assert [allocs[0].refcount(i) for i in range(6)] == \
            [allocs[1].refcount(i) for i in range(6)]
        return out[1][1]

    a = both("alloc", 2)
    b = both("alloc", 3)
    assert both("alloc", 2) is None  # exhaustion: no state change
    both("register", a[0], 111)
    both("register", a[1], 222)
    both("register", b[0], 111)  # first writer wins
    both("register", a[0], 333)  # another hash for a registered block raises
    both("lookup", 111)
    both("ref", a[0])
    both("unref", a)
    both("unref", [a[0]])  # registered block parks on the LRU
    both("unref", [a[0]])  # double free raises
    both("lookup", 111)
    both("ref", a[0])  # revive off the LRU
    both("unref", [a[0]])
    both("ref", b[2] + 0)  # a live block takes a second reference
    both("unref", [b[2]])
    fail["now"] = True
    assert both("alloc", 1) is None  # injected failure
    fail["now"] = False
    c = both("alloc", 3)  # one blank, then the LRU's least recently released
    both("lookup", 111)
    both("lookup", 222)
    both("ref", 99)  # out of range
    both("unref", b + c)
    assert allocs[1].free_count == 6
    assert _snap(regs[0]) == _snap(regs[1])
