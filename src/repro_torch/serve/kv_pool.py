"""Port of ``repro.serve.kv_pool``: block-paged KV storage for the serving
engine.

Dense decode caches are ``(B, max_len, n_kv_heads, head_dim)`` buffers:
every slot owns ``max_len`` positions whether it uses them or not.  The
paged layout replaces the per-slot buffer with a shared pool

    kpool / vpool : (num_blocks, block_size, n_kv_heads, head_dim)
    table         : (B, max_blocks) int32  — per-slot block ids

where position ``p`` of slot ``b`` lives at ``(table[b, p // bs], p % bs)``.
Blocks are handed out by the host-side :class:`BlockAllocator` at admission
and chunk boundaries and reclaimed on eviction, so KV memory scales with
the live token count.  A cache dict with a ``"table"`` key *is* the paged
layout: the model stack dispatches on that key.

Unlike upstream's pure functions, :func:`write`, :func:`write_span` and
:func:`copy_block` update the pool in place (and return it).  Masked
entries (an inactive slot, a ragged slice's pad tokens, positions past the
table) write nothing, as upstream's out-of-bounds ``mode="drop"`` does;
:func:`put_rows` does that with one scatter and no device-to-host sync.

:func:`read` gathers a slot's blocks in table order, so the gathered view
is element for element the dense cache (up to trailing positions the mask
excludes): attention over it is bit for bit the dense computation.

``cache_sharding`` (mesh placement) is not ported.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def blocks_for(length: int, block_size: int) -> int:
    """Number of blocks needed to hold ``length`` positions."""
    return -(-int(length) // int(block_size))


def init_paged_attention_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
                               num_blocks: int, block_size: int, dtype, device=None,
                               lead: tuple = ()):
    """The cache dict of one paged attention layer (``lead`` prepends a
    layer-stack axis to every leaf, as upstream's stacked segments).
    ``max_len`` bounds one slot's sequence (it sizes the table);
    ``num_blocks`` sizes the shared pool."""
    if max_len % block_size:
        raise ValueError(
            f"max_len ({max_len}) must be a multiple of block_size "
            f"({block_size}) so prefill pages tile exactly"
        )
    max_blocks = blocks_for(max_len, block_size)
    pool_shape = lead + (num_blocks, block_size, n_kv_heads, head_dim)
    return {
        "kpool": torch.zeros(pool_shape, dtype=dtype, device=device),
        "vpool": torch.zeros(pool_shape, dtype=dtype, device=device),
        "table": torch.zeros(lead + (batch, max_blocks), dtype=torch.int32, device=device),
    }


def put_rows(dst: Tensor, idx: Tensor, src: Tensor, ok: Tensor) -> Tensor:
    """In place: ``dst[idx[e]] = src[e]`` for every entry with ``ok[e]``;
    the other entries write nothing.  dst: (P, ...); idx: (E,) in [0, P);
    src: (E, ...); ok: (E,) bool.

    A masked entry may share its index with a written one (an inactive
    slot's stale table row can name a block another slot now owns), so
    each entry writes the value its index ends with — the written entry's
    (the last one, if several), else the current contents — and every
    duplicate index gets one value: one scatter, no host sync."""
    n = idx.shape[0]
    idx = idx.long()
    ids = torch.arange(n, device=idx.device)
    win = torch.full((dst.shape[0],), -1, dtype=torch.long, device=idx.device)
    win.scatter_reduce_(0, idx, torch.where(ok, ids, -1), reduce="amax")
    w = win[idx]
    keep = (w < 0).reshape((n,) + (1,) * (dst.ndim - 1))
    vals = torch.where(keep, dst[idx], src[w.clamp(min=0)].to(dst.dtype))
    return dst.index_put_((idx,), vals)


def _flat(pool: Tensor) -> Tensor:
    """(NB, BS, ...) pool as a (NB * BS, ...) view (never a copy)."""
    return pool.view((pool.shape[0] * pool.shape[1],) + tuple(pool.shape[2:]))


def write(pool: Tensor, table: Tensor, pos: Tensor, val: Tensor,
          active: Tensor | None = None) -> Tensor:
    """In place: one token per slot into its block.  pool (NB, BS, H, D);
    table (B, MB) int32; pos (B,) the write position; val (B, H, D);
    inactive slots write nothing, so a finished request can never scribble
    into a block that was reclaimed and reassigned."""
    return write_span(pool, table, pos, val[:, None], active)


def write_span(pool: Tensor, table: Tensor, pos: Tensor, val: Tensor,
               active: Tensor | None = None, lengths: Tensor | None = None) -> Tensor:
    """In place: a span of T tokens per slot into its pages — position
    ``pos[b] + t`` lands at ``(table[b, (pos[b]+t) // BS], (pos[b]+t) % BS)``.
    val (B, T, H, D).  Entries of inactive slots, tokens ``t >= lengths[b]``
    and positions past the table write nothing.  Chunked prefill slices and
    the one-shot admission install both write through here."""
    bs, mb = pool.shape[1], table.shape[1]
    b, t = val.shape[:2]
    p = pos.long()[:, None] + torch.arange(t, device=pool.device)[None, :]  # (B, T)
    blk = torch.gather(table.long(), 1, torch.clamp(p // bs, 0, mb - 1))
    ok = p < mb * bs
    if lengths is not None:
        ok = ok & (torch.arange(t, device=pool.device)[None, :] < lengths[:, None])
    if active is not None:
        ok = ok & active[:, None]
    put_rows(_flat(pool), (blk * bs + p % bs).reshape(-1),
             val.reshape((b * t,) + tuple(val.shape[2:])), ok.reshape(-1))
    return pool


def read(pool: Tensor, table: Tensor, blocks: int | None = None) -> Tensor:
    """Gather a dense per-slot view (B, nb * BS, H, D) in position order,
    where ``nb`` is ``blocks`` (a static used-prefix bound) or the full
    table width.  Unallocated table entries point at block 0; the
    positions they cover sit past the slot's position and the attention
    mask excludes them."""
    if blocks is not None:
        table = table[:, : max(1, min(int(blocks), table.shape[1]))]
    g = pool[table.long()]  # (B, nb, BS, H, D)
    b, nb, bs = g.shape[:3]
    return g.reshape((b, nb * bs) + tuple(g.shape[3:]))


def hash_block_tokens(parent: int | None, tokens) -> int:
    """Content identity of one FULL block: a chain hash of
    ``(parent_hash, block_tokens)`` over the host token stream."""
    return hash((parent, tuple(int(t) for t in tokens)))


def prompt_block_hashes(tokens, block_size: int) -> list[int]:
    """Chain hashes for every *full* block of a token stream."""
    bs = int(block_size)
    out: list[int] = []
    parent: int | None = None
    for i in range(len(tokens) // bs):
        parent = hash_block_tokens(parent, tokens[i * bs : (i + 1) * bs])
        out.append(parent)
    return out


def copy_block(pool: Tensor, src: int, dst: int) -> Tensor:
    """In place: ``pool[dst] = pool[src]`` — one page copied inside the
    pool (the copy-on-write primitive)."""
    pool[dst] = pool[src]
    return pool


class BlockAllocator:
    """Host-side ref-counted free list over the pool's block ids, with
    content-hash identity and an LRU of reusable (cached) blocks — upstream's
    allocator line for line (it runs on the host).

    Blocks carry a refcount and, optionally, a registered content hash.  A
    block whose refcount drops to zero parks on the LRU if it has a hash
    (still found by :meth:`lookup`) until :meth:`alloc` reclaims it, else
    returns to the blank list; ``free_count`` counts blank + cached blocks,
    so ``free_count == num_blocks`` after a drain.

    ``fail_hook`` is consulted once per ``alloc``; ``True`` makes that call
    fail with exhaustion semantics (None, no state change).  ``metrics`` is
    an optional registry: the allocator keeps ``pool_blocks_used`` exact
    and counts ``block_allocs_total``, ``block_alloc_failures_total`` and
    ``prefix_cache_evictions_total``.
    """

    def __init__(self, num_blocks: int, fail_hook=None, metrics=None):
        self.num_blocks = num_blocks
        self.fail_hook = fail_hook
        self._ref = [0] * num_blocks  # refcount per block id
        self._blank = list(range(num_blocks - 1, -1, -1))  # pop() -> low ids
        # refcount-0 blocks that still hold registered content, in release
        # order: front = least recently released = first evicted
        self._lru: dict[int, None] = {}
        self._hash_of: dict[int, int] = {}  # block id -> content hash
        self._block_of: dict[int, int] = {}  # content hash -> block id
        self._g_used = metrics.gauge("pool_blocks_used") if metrics else None
        self._c_allocs = metrics.counter("block_allocs_total") if metrics else None
        self._c_fail = metrics.counter("block_alloc_failures_total") if metrics else None
        self._c_evict = metrics.counter("prefix_cache_evictions_total") if metrics else None

    @property
    def free_count(self) -> int:
        """Allocatable blocks: blank + cached (refcount-0, evictable)."""
        return len(self._blank) + len(self._lru)

    @property
    def used_count(self) -> int:
        """Blocks with refcount > 0 (owned by at least one slot)."""
        return self.num_blocks - self.free_count

    @property
    def cached_count(self) -> int:
        """Blocks with a registered content hash (live or parked)."""
        return len(self._block_of)

    def refcount(self, i: int) -> int:
        return self._ref[i]

    def _mark_fail(self) -> None:
        if self._c_fail is not None:
            self._c_fail.inc()

    def _set_used_gauge(self) -> None:
        if self._g_used is not None:
            self._g_used.set(self.used_count)

    def alloc(self, n: int) -> list[int] | None:
        """n block ids at refcount 1, or None (no ownership change) if the
        pool is exhausted or the fail hook says so.  Blank blocks go first;
        then the least recently released cached block is evicted, its hash
        entries with it."""
        if self.fail_hook is not None and self.fail_hook():
            self._mark_fail()
            return None
        if n > self.free_count:
            self._mark_fail()
            return None
        got = []
        for _ in range(n):
            if self._blank:
                i = self._blank.pop()
            else:
                i = next(iter(self._lru))  # least recently released
                del self._lru[i]
                del self._block_of[self._hash_of.pop(i)]
                if self._c_evict is not None:
                    self._c_evict.inc()
            self._ref[i] = 1
            got.append(i)
        self._set_used_gauge()
        if self._c_allocs is not None:
            self._c_allocs.inc(n)
        return got

    def unref(self, ids) -> None:
        """Drop one reference per id; a block reaching refcount 0 parks on
        the LRU if registered, else goes blank.  Double-unref raises."""
        pending: dict[int, int] = {}
        for i in ids:  # validate everything before mutating anything
            if not 0 <= i < self.num_blocks:
                raise ValueError(f"block id {i} out of range")
            pending[i] = pending.get(i, 0) + 1
            if pending[i] > self._ref[i]:
                raise ValueError(f"double free of block {i}")
        for i in ids:
            self._ref[i] -= 1
            if self._ref[i] == 0:
                if i in self._hash_of:
                    self._lru[i] = None  # most recently released -> back
                else:
                    self._blank.append(i)
        self._set_used_gauge()

    free = unref

    def ref(self, i: int) -> None:
        """Take one reference on a live or cached block (reviving a cached
        block pulls it off the LRU)."""
        if not 0 <= i < self.num_blocks:
            raise ValueError(f"block id {i} out of range")
        if self._ref[i] == 0:
            if i not in self._lru:
                raise ValueError(f"block {i} is blank — nothing to share")
            del self._lru[i]
        self._ref[i] += 1
        self._set_used_gauge()

    def lookup(self, h: int) -> int | None:
        """Block id currently holding content ``h``, or None (takes no
        reference)."""
        return self._block_of.get(h)

    def register(self, i: int, h: int) -> bool:
        """Record that live block ``i`` now holds content ``h``.  First
        writer wins (returns False if ``h`` is mapped elsewhere); the same
        (block, hash) again is a no-op; another hash for a registered block
        raises."""
        if not 0 <= i < self.num_blocks:
            raise ValueError(f"block id {i} out of range")
        if self._ref[i] <= 0:
            raise ValueError(f"register of unreferenced block {i}")
        cur = self._hash_of.get(i)
        if cur is not None:
            if cur != h:
                raise ValueError(f"block {i} re-registered under a different hash")
            return True
        if h in self._block_of:
            return False
        self._hash_of[i] = h
        self._block_of[h] = i
        return True
