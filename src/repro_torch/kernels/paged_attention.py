"""Block-table attention over the paged KV pool: the port of
``repro.kernels.paged_attention``.

    q       : (B, T, Hq, D)          queries (f32 or bf16)
    kpool   : (NB, BS, Hkv, D)       the shared K pool (f32 or bf16)
    vpool   : (NB, BS, Hkv, D)       the shared V pool
    table   : (B, MB) int32          per-slot block ids
    start   : (B,) int32             absolute position of q[:, 0]
    kv_lens : (B,) int32             resident tokens per slot (>= 1)

Query token t of slot b attends the columns ``j <= start[b] + t`` of its
slot (the ``forward_chunk`` contract; T = 1 is decode), and never a column
at or past ``kv_lens[b]``: the walk stops there, so a table entry past the
used prefix (block 0, holding another slot's data) is never read.  GQA
groups G = Hq // Hkv query heads onto each KV head.

``paged_attention`` launches the hand-written CUDA kernel of
``csrc/paged_attention.cu`` for a CUDA tensor (one launch, no host read,
no fallback: a shape or alignment it cannot take raises ``ValueError``)
and runs its plain PyTorch version for a CPU tensor.  It replaces the
Pallas kernel ``repro.kernels.paged_attention`` (``_paged_attention_kernel``).

What bounds it on an H100 is the bytes of the live K/V pages (half a flop
per byte at f32 decode), and in practice each block's fixed latency (its
context, its first data, its merges).  The kernel splits each (slot, KV
head)'s attended pages across the blocks of a thread-block cluster:
``paged_attention_plan`` gives the splits S from the static shapes alone
(table width, B, Hkv and T * G), never from ``kv_lens``; on the device the
block of rank k walks the k-th of S ranges of the pages its rows attend
(``split_ranges``) with its own online-softmax state and a ring of pages
in flight (``cp.async``), and rank 0 merges the S states (sent over DSMEM)
in rank order.  Two routes by shape: "split" (T * G < 32, or D not a
multiple of 32: up to 8 query rows a block, its 4 warps taking the range's
pages in turn, each lane an online softmax of its own columns, merged over
shuffles and then across warps) and "tile" (64 query rows a block, 32
columns a step, register micro-tiles of 4 x 4 scores);
``paged_attention_route`` asks the CUDA source which plan a shape takes.
Upstream's ``pages`` (pages per grid step) and its 8-row padding are TPU
tiling; the port has no ``paged_tiles`` table.

Numerics: scores, the online-softmax state and the accumulator are f32
whatever the pool's type; the kernel reassociates the softmax reduction,
so it matches the plain version to f32 rounding (max |err| <= 1e-5 at
unit-normal inputs), not bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _cuda

Tensor = torch.Tensor

NEG_INF = -1e30
MAX_HEAD_DIM = 128  # csrc kMaxD
# the plan and shared-memory layout of csrc/paged_attention.cu (make_plan,
# make_layout)
_WARPS = 4
_MAX_SPLITS = 8  # a portable cluster
_TARGET_BLOCKS = 256  # split route: blocks the splits aim at
_TILE_TARGET_BLOCKS = 1024  # tile route
_MIN_PAGES = 2  # pages a split keeps at least
_SPLIT_ROWS = 8  # most query rows of a split-route block
_SPLIT_STAGES = 2  # pages of a warp's ring
_TILE_ROWS = 64
_TILE_COLS = 32
_TILE_STAGES = 2
_P_LD = _TILE_COLS + 4
_MAX_SMEM = 232448

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # q, kpool, vpool, table, start, kv_lens, out, q_code, kv_code,
    # b, t, hq, hkv, d, bs, mb, scale, device, stream
    "paged_attention_launch": [_P] * 7 + [_I] * 9 + [ctypes.c_float, _I, _P],
    # b, t, hq, hkv, d, bs, mb, kv_code
    "paged_attention_route": [_I] * 8,
}


class PagedPlan(NamedTuple):
    route: str  # "split" or "tile"
    rows: int  # query rows a block takes
    splits: int  # blocks of a cluster, one page range each (split_ranges)


def paged_attention_plan(b: int, t: int, hq: int, hkv: int, d: int, mb: int) -> PagedPlan:
    """The kernel's plan for these static shapes (``make_plan`` of
    ``csrc/paged_attention.cu``): the route, the query rows of a block, and
    the splits of each (slot, KV head)'s table, doubled from 1 while the
    grid has fewer than 256 blocks (tile route: 1024), a cluster fewer
    than 8 and each split of the whole table keeps at least 2 pages; on
    the tile route then halved until a block's layout with f32 pools fits
    its shared memory (at head_dim 128, 4 splits)."""
    tg = t * (hq // hkv)
    tile = tg >= _TILE_ROWS // 2 and d % 32 == 0 and d <= MAX_HEAD_DIM
    if tile:
        rows = _TILE_ROWS
    else:
        rows = 1
        while rows < tg and rows < _SPLIT_ROWS:
            rows *= 2
    groups = b * hkv * -(-tg // rows)
    target = _TILE_TARGET_BLOCKS if tile else _TARGET_BLOCKS
    splits = 1
    while (splits < _MAX_SPLITS and groups * splits < target
           and -(-mb // (2 * splits)) >= _MIN_PAGES):
        splits *= 2
    # the tile route's merge slots (64 x (D + 2) floats a split past the
    # first) must fit a block with f32 pools: halve the splits until they do
    while tile and splits > 1 and smem_bytes(PagedPlan("tile", rows, splits), d, 1, 4,
                                             mb) > _MAX_SMEM:
        splits //= 2
    return PagedPlan("tile" if tile else "split", rows, splits)


def split_ranges(splits: int, npages: int) -> list[tuple[int, int]]:
    """The page range ``[lo, hi)`` of each rank of a cluster of ``splits``
    blocks over the ``npages`` pages its rows attend: ``ceil(npages /
    splits)`` pages each, in order (a range past the last page is empty).
    The kernel cuts them on the device, from kv_lens."""
    per = -(-npages // splits)
    return [(min(npages, k * per), min(npages, (k + 1) * per)) for k in range(splits)]


def column_group(bs: int) -> int:
    """The largest power of two up to 32 that divides the block size."""
    cg = 1
    while cg < 32 and bs % (2 * cg) == 0:
        cg *= 2
    return cg


def split_columns(rows: int, bs: int) -> int:
    """Columns of a split-route pass (``split_cg``): a warp's 32 lanes take
    ``rows`` query rows of that many columns; the rest split D."""
    return min(column_group(bs), 32 // rows)


def smem_bytes(plan: PagedPlan, d: int, bs: int, elem: int, mb: int) -> int:
    """A block's dynamic shared memory (``make_layout``)."""
    def a128(v):
        return -(-v // 128) * 128

    row_bytes = d * elem
    state = 4 * ((plan.rows * (d + 2) + 3) // 4 * 4)
    if plan.route == "tile":
        ring, fin_in_ring = _TILE_STAGES * 2 * _TILE_COLS * row_bytes, 0
    else:
        ring = _WARPS * _SPLIT_STAGES * 2 * bs * row_bytes
        fin_in_ring = _WARPS * plan.rows * (d + 2) * 4
    used = fin_in_ring + state + plan.rows * (plan.splits + 1) * 4
    ring_off = a128(plan.rows * d * 4)
    p_off = a128(ring_off + max(ring, used))
    recv_off = a128(p_off + (_TILE_ROWS * _P_LD * 4 if plan.route == "tile" else 0))
    return a128(recv_off + (plan.splits - 1) * state) + 8 + 4 * mb


def paged_attention_route(b: int, t: int, hq: int, hkv: int, d: int, bs: int, mb: int,
                          kv_dtype=torch.float32) -> PagedPlan:
    """The plan ``paged_attention_launch`` takes for these shapes on the
    card, as the CUDA source computes it (builds the kernel on first use;
    reads no tensor)."""
    lib = _cuda.load("paged_attention", _SIGNATURES)
    v = lib.paged_attention_route(b, t, hq, hkv, d, bs, mb, _cuda.float_code(kv_dtype, "kv"))
    if v < 0:
        raise ValueError(f"paged_attention takes no (b, t, hq, hkv, d, bs, mb) = "
                         f"{(b, t, hq, hkv, d, bs, mb)}")
    return PagedPlan("tile" if v & 1 else "split", v >> 8, (v >> 1) & 127)


def paged_attention_plain(q: Tensor, kpool: Tensor, vpool: Tensor, table: Tensor,
                          start: Tensor, kv_lens: Tensor, scale: float | None = None) -> Tensor:
    """The kernel's function in plain PyTorch: gather every table page,
    zero the columns at or past ``kv_lens``, and take the prefix-masked
    softmax at f32 (one pass, not online)."""
    b, t, hq, d = q.shape
    bs, hkv = kpool.shape[1], kpool.shape[2]
    g = hq // hkv
    scale = d**-0.5 if scale is None else scale
    idx = table.long()
    keys = kpool[idx].reshape(b, -1, hkv, d).float()
    vals = vpool[idx].reshape(b, -1, hkv, d).float()
    cols = torch.arange(keys.shape[1], device=q.device)
    live = cols[None, :] < kv_lens.clamp(min=1).long()[:, None]  # (B, S)
    keys = torch.where(live[:, :, None, None], keys, 0.0)
    vals = torch.where(live[:, :, None, None], vals, 0.0)
    qg = q.reshape(b, t, hkv, g, d).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, keys) * scale
    rowpos = start.long()[:, None] + torch.arange(t, device=q.device)[None]  # (B, T)
    mask = (cols[None, None, :] <= rowpos[:, :, None]) & live[:, None, :]  # (B, T, S)
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, vals)
    return out.reshape(b, t, hq, d).to(q.dtype)


def check_shapes(q: Tensor, kpool: Tensor, vpool: Tensor, table: Tensor) -> None:
    """Raise unless the kernel takes these shapes (any device)."""
    if q.ndim != 4 or kpool.ndim != 4 or vpool.shape != kpool.shape or table.ndim != 2:
        raise ValueError(f"paged_attention shapes: q {tuple(q.shape)}, pools "
                         f"{tuple(kpool.shape)} / {tuple(vpool.shape)}, table {tuple(table.shape)}")
    b, t, hq, d = q.shape
    _, bs, hkv, dk = kpool.shape
    if dk != d or hkv < 1 or hq % hkv or table.shape[0] != b or t < 1:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} against pools {tuple(kpool.shape)}"
                         f" and table {tuple(table.shape)} (Hq must be a multiple of Hkv)")
    plan = paged_attention_plan(b, t, hq, hkv, d, table.shape[1])
    smem = smem_bytes(plan, d, bs, kpool.element_size(), table.shape[1])
    if d > MAX_HEAD_DIM or d % 8 or smem > _MAX_SMEM:
        raise ValueError(f"paged_attention: head_dim {d} (a multiple of 8, at most "
                         f"{MAX_HEAD_DIM}) and block size {bs} need {smem} bytes of shared "
                         f"memory (at most {_MAX_SMEM})")


def paged_attention(q: Tensor, kpool: Tensor, vpool: Tensor, table: Tensor, start: Tensor,
                    kv_lens: Tensor, scale: float | None = None) -> Tensor:
    """(B, T, Hq, D) attention output in q's type; see the module doc."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, kpool, vpool, table, start, kv_lens, scale)
    dev = _cuda.device_index(q)
    check_shapes(q, kpool, vpool, table)
    b, t, hq, d = q.shape
    _, bs, hkv, _ = kpool.shape
    q_code = _cuda.float_code(q.dtype, "q")
    kv_code = _cuda.float_code(kpool.dtype, "kpool")
    _cuda.on_device(q, q.dtype, dev, "q")
    _cuda.on_device(kpool, kpool.dtype, dev, "kpool")
    _cuda.on_device(vpool, kpool.dtype, dev, "vpool")
    _cuda.on_device(table, torch.int32, dev, "table")
    for v, name in ((start, "start"), (kv_lens, "kv_lens")):
        _cuda.on_device(v, torch.int32, dev, name)
        if v.shape != (b,):
            raise ValueError(f"{name} must be ({b},), got {tuple(v.shape)}")
    if q.data_ptr() % 16 or kpool.data_ptr() % 16 or vpool.data_ptr() % 16:
        raise ValueError("paged_attention: q and the pools must be 16-byte aligned (the "
                         "kernel stages them in 16-byte copies)")
    scale = d**-0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    lib = _cuda.load("paged_attention", _SIGNATURES)
    err = lib.paged_attention_launch(
        q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(), table.data_ptr(), start.data_ptr(),
        kv_lens.data_ptr(), out.data_ptr(), q_code, kv_code, b, t, hq, hkv, d, bs,
        table.shape[1], scale, dev, _cuda.stream_ptr(dev),
    )
    _cuda.check(err, "paged_attention")
    _cuda.LAUNCHES["paged_attention"] += 1
    return out
