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
``csrc/paged_attention.cu`` for a CUDA tensor and runs its plain PyTorch
version for a CPU tensor.  Upstream's ``pages`` (pages per grid step) and
its 8-row padding are TPU tiling; the CUDA kernel walks one page at a time
and takes no tile size, so the port has no ``paged_tiles`` table.

Numerics: scores, the online-softmax state and the accumulator are f32
whatever the pool's type; the kernel reassociates the softmax reduction,
so it matches the plain version to f32 rounding (max |err| <= 1e-5 at
unit-normal inputs), not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda

Tensor = torch.Tensor

NEG_INF = -1e30
MAX_HEAD_DIM = 256  # D / 32 accumulator values a lane, at most 8
_ROW_TILE = 16  # query rows per block (csrc kRowTile)
_MAX_SMEM = 232448

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # q, kpool, vpool, table, start, kv_lens, out, q_code, kv_code,
    # b, t, hq, hkv, d, bs, mb, scale, device, stream
    "paged_attention_launch": [_P] * 7 + [_I] * 9 + [ctypes.c_float, _I, _P],
}


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
    smem = 4 * (_ROW_TILE * d + bs * (d + 1) + bs * d)
    if d > MAX_HEAD_DIM or smem > _MAX_SMEM:
        raise ValueError(f"paged_attention: head_dim {d} (at most {MAX_HEAD_DIM}) and block size "
                         f"{bs} need {smem} bytes of shared memory (at most {_MAX_SMEM})")


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
