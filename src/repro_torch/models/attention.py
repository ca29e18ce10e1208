"""Port of ``repro.models.attention``: full/GQA and sliding-window
attention with the dense, ring and paged KV-cache adapters, and
DeepSeek-V2's Multi-head Latent Attention (MLA) over a dense latent cache
``{"ckv", "krope"}`` in both layouts.

All projections are BitLinear; on packed serving weights every projection
runs the W1A8 kernel tier (``repro_torch.core.bitlinear``).  Two cache
layouts ride the same call sites:

* dense — ``{"k", "v"}`` of shape (B, L, Hkv, D); a sliding-window
  layer keeps a RING of L = window positions, position p at slot p % L
  (in both layouts: the window is small), whose chunks run token by token
  (:func:`_ring_chunk`);
* paged — ``{"kpool", "vpool", "table"}`` from ``repro_torch.serve.kv_pool``:
  a shared block pool plus per-slot block tables (the ``"table"`` key is
  the layout discriminator).  Paged scoring runs the paged-attention
  kernel route when ``kernels.ops.paged_attention_enabled()``, else the
  ``kv_pool.read`` gather + SDPA (see :func:`_paged_scores`).

Unlike upstream's pure functions, the cache-writing entry points update
the cache tensors in place (and return them): a decode step then writes
one row per slot instead of copying every layer's cache.

``pos`` is the absolute position of the chunk's first token: a Python
int or 0-d tensor (lockstep: every slot at the same position) or a (B,)
tensor (per-slot positions).  The serving loop passes Python ints, which
never cost a host-to-device copy.  ``active`` (B,) bool masks whole slots'
cache writes and ``lengths`` (B,) right-pads a ragged chunk.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.bitlinear import bitlinear, init_linear, init_rmsnorm, rmsnorm
from repro_torch.models.layers import apply_rope, rope_table, rotate

Tensor = torch.Tensor

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Standard GQA attention
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig, lead: tuple = (), device=None):
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    params = {}
    for name, di, do in (("wq", d, nq * hd), ("wk", d, nkv * hd),
                         ("wv", d, nkv * hd), ("wo", nq * hd, d)):
        params[name] = init_linear(gen, di, do, lead, device)
    if cfg.quant.mode != "none":
        # SubLN ahead of the output projection (BitNet placement)
        params["subln"] = init_rmsnorm(nq * hd, lead, device)
    return params


def _project_qkv(params, x: Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    hd, nq, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = bitlinear(params["wq"], x, cfg.quant).reshape(b, s, nq, hd)
    k = bitlinear(params["wk"], x, cfg.quant).reshape(b, s, nkv, hd)
    v = bitlinear(params["wv"], x, cfg.quant).reshape(b, s, nkv, hd)
    return q, k, v


def _out_proj(params, attn_out: Tensor, cfg: ModelConfig) -> Tensor:
    b, s = attn_out.shape[:2]
    flat = attn_out.reshape(b, s, -1)
    return bitlinear(params["wo"], flat, cfg.quant, sublayer_norm=params.get("subln"))


def _sdpa(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor],
          scale: Optional[float] = None) -> Tensor:
    """Grouped scaled-dot-product attention, as explicit matmul, softmax and
    matmul with f32 logits.  q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D);
    mask broadcastable to (B, 1, Sq, Skv), True = attend."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    scale = scale if scale is not None else d**-0.5
    qg = q.reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
    if mask is not None:
        logits = torch.where(mask[:, :, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return out.reshape(b, sq, hq, dv)


def causal_mask(sq: int, skv: int, window: int = 0, device=None) -> Tensor:
    """(1, 1, Sq, Skv) boolean causal mask; a ``window`` > 0 also limits
    each query to the ``window`` latest positions, itself included (0 is
    unlimited: a global layer)."""
    i = torch.arange(sq, device=device)[:, None] + (skv - sq)  # absolute query positions
    j = torch.arange(skv, device=device)[None, :]
    m = j <= i
    if window > 0:
        m = m & ((i - j) < window)
    return m[None, None]


def attention(params, x: Tensor, cfg: ModelConfig, sin: Tensor, cos: Tensor, window: int = 0):
    """Full-sequence causal attention (train / eval, no cache), over the
    ``window`` latest positions where it is > 0."""
    q, k, v = _project_qkv(params, x, cfg)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    s = x.shape[1]
    return _out_proj(params, _sdpa(q, k, v, causal_mask(s, s, window, x.device)), cfg)


# ---------------------------------------------------------------------------
# Dense KV cache
# ---------------------------------------------------------------------------


def init_attention_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, lead: tuple = (),
                         device=None):
    shape = lead + (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def rope_at(pos, t: int, head_dim: int, theta, device=None) -> tuple[Tensor, Tensor]:
    """sin/cos tables of a T-token chunk at absolute positions ``pos``..,
    shaped (B|1, T, 1, D/2) to broadcast over (B, T, H, D/2).  Every layer
    rotates at the same positions, so a forward builds them once and hands
    them to each layer (upstream's ``_rope_decode`` / ``_rope_at`` build them
    per call; the angles, and so the products, are elementwise the same)."""
    posmat = _pos_matrix(pos, t, device)
    sin, cos = rope_table(posmat.reshape(-1), head_dim, theta)
    shape = tuple(posmat.shape) + (1, -1)
    return sin.reshape(shape), cos.reshape(shape)


def _slot_write(cache: Tensor, new: Tensor, slot: Tensor, active: Tensor | None) -> Tensor:
    """In place: one token per slot at per-slot positions ``slot`` (B,);
    inactive rows write nothing.  cache: (B, L, ...); new: (B, 1, ...)."""
    return _span_write(cache, new, slot[:, None], None if active is None else active[:, None])


def _decode_mask(pos, skv: int, device=None) -> Tensor:
    """Validity mask of a decode read, broadcastable to (B, 1, 1, Skv):
    slots 0..min(pos, Skv - 1) (upstream's ring rule; on a cache at least
    as long as the sequence it is the plain prefix)."""
    j = torch.arange(skv, device=device)
    if not torch.is_tensor(pos):
        return (j <= min(pos, skv - 1))[None, None, None].expand(1, 1, 1, skv)
    lim = torch.clamp(pos, max=skv - 1)
    if pos.ndim == 0:
        return (j <= lim)[None, None, None].expand(1, 1, 1, skv)
    return (j[None, :] <= lim[:, None])[:, None, None, :]


def _pos_matrix(pos, t: int, device=None) -> Tensor:
    """Absolute positions of a T-token chunk: (B|1, T).  A Python int
    ``pos`` never leaves the host (no host-to-device copy, so no stall)."""
    if not torch.is_tensor(pos):
        return torch.arange(pos, pos + t, dtype=torch.int32, device=device)[None]
    offs = torch.arange(t, dtype=torch.int32, device=pos.device)
    if pos.ndim == 0:
        return (pos + offs)[None]
    return pos[:, None] + offs[None]


def _chunk_valid(b: int, t: int, active: Tensor | None, lengths: Tensor | None,
                 device=None) -> Tensor | None:
    """(B, T) bool — which chunk entries really carry a token."""
    if active is None and lengths is None:
        return None
    ok = torch.ones((b, t), dtype=torch.bool, device=device)
    if lengths is not None:
        ok = ok & (torch.arange(t, device=device)[None, :] < lengths[:, None])
    if active is not None:
        ok = ok & active[:, None]
    return ok


def _span_write(cache: Tensor, new: Tensor, rows: Tensor, valid: Tensor | None) -> Tensor:
    """In place: T tokens per slot at per-(slot, token) rows (B, T), as one
    masked scatter of B * T rows (``kv_pool.put_rows``).  Invalid entries
    and rows past the cache end are dropped (upstream's out-of-bounds
    ``mode="drop"``)."""
    from repro_torch.serve.kv_pool import put_rows  # deferred: serve imports models

    b, t = rows.shape
    l = cache.shape[1]
    rows = rows.long()
    ok = rows < l
    if valid is not None:
        ok = ok & valid
    flat = torch.arange(b, device=cache.device)[:, None] * l + rows.clamp(max=l - 1)
    put_rows(cache.view((b * l,) + tuple(cache.shape[2:])), flat.reshape(-1),
             new.reshape((b * t,) + tuple(new.shape[2:])), ok.reshape(-1))
    return cache


def _span_mask(posmat: Tensor, skv: int) -> Tensor:
    """Causal validity of a chunk read, (B|1, 1, T, Skv): query at absolute
    position q attends cache columns j <= q."""
    j = torch.arange(skv, device=posmat.device)
    return (j[None, None, :] <= posmat[..., None])[:, None]


def _ring_write(flat: Tensor, rows: Tensor, new: Tensor, ok: Tensor | None) -> None:
    """In place: one token per slot into a ring viewed as (B * L, ...), at
    per-slot flat rows (B,) (each slot its own row, so no two entries
    meet); a slot with ``ok`` False writes nothing."""
    new = new.to(flat.dtype)
    if ok is not None:
        new = torch.where(ok.reshape((-1,) + (1,) * (new.ndim - 1)), new, flat[rows])
    flat.index_put_((rows,), new)


def _ring_chunk(q: Tensor, k: Tensor, v: Tensor, cache: dict, posmat: Tensor,
                valid: Tensor | None):
    """Sequential per-token chunk over a RING cache (sliding-window layer),
    in place.  A parallel span write is wrong here: writing token p evicts
    the resident key at p - L, which earlier queries of the same chunk
    still attend.  Each token writes its slot p % L, then reads the ring
    under the decode mask, so the chunk is, token for token, what T decode
    steps compute (upstream's ``lax.scan`` becomes a loop over T; the
    projections around it stay chunk-parallel).  q/k/v: (B, T, H, D);
    posmat: (B|1, T).  Returns (out (B, T, Hq, D), cache)."""
    b, t = q.shape[:2]
    kc, vc = cache["k"], cache["v"]
    l = kc.shape[1]
    posmat = posmat.expand(b, t)
    rows = torch.arange(b, device=q.device)[:, None] * l + (posmat % l).long()
    # the decode mask of every step at once: slots 0..min(p, L - 1)
    masks = torch.arange(l, device=q.device) <= torch.clamp(posmat, max=l - 1)[..., None]
    kf = kc.view((b * l,) + tuple(kc.shape[2:]))
    vf = vc.view((b * l,) + tuple(vc.shape[2:]))
    outs = []
    for i in range(t):
        ok = None if valid is None else valid[:, i]
        _ring_write(kf, rows[:, i], k[:, i], ok)
        _ring_write(vf, rows[:, i], v[:, i], ok)
        outs.append(_sdpa(q[:, i:i + 1], kc.to(q.dtype), vc.to(q.dtype),
                          masks[:, i][:, None, None, :]))
    return torch.cat(outs, dim=1), cache


def _pos_vector(pos, b: int, device=None) -> Tensor:
    """(B,) int32 absolute position of each slot's first chunk token."""
    if not torch.is_tensor(pos):
        return torch.full((b,), pos, dtype=torch.int32, device=device)
    return pos.to(torch.int32).expand(b) if pos.ndim == 0 else pos.to(torch.int32)


def _paged_scores(q: Tensor, kpool: Tensor, vpool: Tensor, table: Tensor, posv: Tensor,
                  posmat: Tensor, n_valid, read_to: int | None) -> Tensor:
    """Score rotated queries q (B, T, Hq, D) against the paged pool: the
    paged-attention kernel route when enabled and supported (it walks each
    slot's pages in place, bounded by the resident length ``posv +
    n_valid``), else the ``kv_pool.read`` gather + prefix-masked SDPA, the
    parity oracle, which reads ``ceil(read_to / BS)`` blocks when the caller
    bounds the read.  ``posmat`` (B|1, T) holds the chunk's absolute
    positions; ``n_valid`` is a ragged slice's (B,) lengths or the static
    T; decode is T = 1 with ``posmat = posv[:, None]``."""
    from repro_torch.kernels import ops  # deferred, as upstream
    from repro_torch.serve import kv_pool  # deferred: serve imports models

    b, t = q.shape[:2]
    bs, mb = kpool.shape[1], table.shape[1]
    if ops.paged_attention_enabled(q.device) and ops.paged_attention_supported(
        bs, q.shape[-1], q.shape[2], kpool.shape[2]
    ):
        kv_lens = torch.clamp(posv + n_valid, 1, mb * bs).to(torch.int32)
        return ops.paged_attention(q, kpool, vpool, table, posv, kv_lens).to(q.dtype)
    nb = mb if read_to is None else max(1, min(mb, -(-read_to // bs)))
    keys = kv_pool.read(kpool, table, blocks=nb)
    vals = kv_pool.read(vpool, table, blocks=nb)
    mask = _span_mask(posmat.expand(b, t), keys.shape[1])
    return _sdpa(q, keys.to(q.dtype), vals.to(q.dtype), mask)


def attention_chunk(params, x: Tensor, cache: dict, pos, cfg: ModelConfig,
                    rope: tuple[Tensor, Tensor] | None, active: Tensor | None = None,
                    lengths: Tensor | None = None, read_to: int | None = None,
                    ring: bool = False):
    """Cache-resident multi-token attention on the dense or paged cache:
    process T tokens per slot, write their K/V into the cache (in place —
    dense rows or pool pages) and let each
    query attend the resident prefix plus the in-chunk causal keys.  T = 1
    without ``lengths`` is :func:`attention_decode`.  ``read_to`` bounds
    the read when no position >= read_to can be attended.  ``rope`` is
    :func:`rope_at` of this chunk at the layer's theta (None when
    ``cfg.pos_embedding`` is not rope).  ``ring`` marks a sliding-window
    layer, whose dense ring takes the sequential in-chunk path
    (:func:`_ring_chunk`): the window is carried by the ring's length.

    Returns (y (B, T, D), cache)."""
    b, t = x.shape[:2]
    if t == 1 and lengths is None:
        return attention_decode(params, x, cache, pos, cfg, rope, active=active)
    q, k, v = _project_qkv(params, x, cfg)
    posmat = _pos_matrix(pos, t, x.device)
    if cfg.pos_embedding == "rope":
        q, k = rotate(q, *rope), rotate(k, *rope)

    if "table" in cache:  # paged adapter: span-scatter straight into pages
        from repro_torch.serve import kv_pool  # deferred: serve imports models

        posv = _pos_vector(pos, b, x.device)
        kv_pool.write_span(cache["kpool"], cache["table"], posv, k, active, lengths)
        kv_pool.write_span(cache["vpool"], cache["table"], posv, v, active, lengths)
        out = _paged_scores(q, cache["kpool"], cache["vpool"], cache["table"], posv, posmat,
                            lengths if lengths is not None else t, read_to)
        return _out_proj(params, out, cfg), cache

    valid = _chunk_valid(b, t, active, lengths, x.device)
    if ring:  # ahead of the lockstep slice write, which drops rows past L
        out, cache = _ring_chunk(q, k, v, cache, posmat, valid)
        return _out_proj(params, out, cfg), cache
    skv = cache["k"].shape[1]
    lim = skv if read_to is None else min(read_to, skv)
    if valid is None and isinstance(pos, int):
        # lockstep chunk: one slice write (rows past the end are dropped)
        end = min(pos + t, skv)
        cache["k"][:, pos:end] = k[:, : end - pos].to(cache["k"].dtype)
        cache["v"][:, pos:end] = v[:, : end - pos].to(cache["v"].dtype)
    else:
        rows = posmat.expand(b, t)
        _span_write(cache["k"], k, rows, valid)
        _span_write(cache["v"], v, rows, valid)
    mask = _span_mask(posmat, lim)
    out = _sdpa(q, cache["k"][:, :lim].to(q.dtype), cache["v"][:, :lim].to(q.dtype), mask)
    return _out_proj(params, out, cfg), cache


def attention_decode(params, x: Tensor, cache: dict, pos, cfg: ModelConfig,
                     rope: tuple[Tensor, Tensor] | None, active: Tensor | None = None):
    """One-token decode step (in place).  x: (B, 1, D); ``rope`` is
    :func:`rope_at` of the step.  On the dense cache the write slot is
    ``pos % L`` and the mask covers min(pos+1, L) slots: a ring of length
    W is the W-token sliding window, so no other window mask is needed; a
    paged cache takes the token into its slot's page and scores via
    :func:`_paged_scores`."""
    b = x.shape[0]
    q, k, v = _project_qkv(params, x, cfg)
    if cfg.pos_embedding == "rope":
        q, k = rotate(q, *rope), rotate(k, *rope)

    if "table" in cache:  # paged adapter
        from repro_torch.serve import kv_pool  # deferred: serve imports models

        posv = _pos_vector(pos, b, x.device)
        kv_pool.write(cache["kpool"], cache["table"], posv, k[:, 0], active)
        kv_pool.write(cache["vpool"], cache["table"], posv, v[:, 0], active)
        out = _paged_scores(q, cache["kpool"], cache["vpool"], cache["table"], posv,
                            posv[:, None], 1, None)
        return _out_proj(params, out, cfg), cache

    skv = cache["k"].shape[1]
    if isinstance(pos, int) and active is None:
        # lockstep fast path: every slot writes the same ring position
        slot = pos % skv
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    else:
        slots = _pos_matrix(pos, 1, x.device)[:, 0].expand(b) % skv
        _slot_write(cache["k"], k, slots, active)
        _slot_write(cache["v"], v, slots, active)
    mask = _decode_mask(pos, skv, device=x.device)
    out = _sdpa(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), mask)
    return _out_proj(params, out, cfg), cache


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (DeepSeek-V2)
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg: ModelConfig, lead: tuple = (), device=None):
    d, nh = cfg.d_model, cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    params = {}
    if cfg.q_lora_rank > 0:
        params["wq_down"] = init_linear(gen, d, cfg.q_lora_rank, lead, device)
        params["wq_up"] = init_linear(gen, cfg.q_lora_rank, nh * qk, lead, device)
        params["q_norm"] = init_rmsnorm(cfg.q_lora_rank, lead, device)
    else:
        params["wq"] = init_linear(gen, d, nh * qk, lead, device)
    # joint KV down-projection: [c_kv ; k_rope]
    params["wkv_down"] = init_linear(gen, d, cfg.kv_lora_rank + cfg.qk_rope_dim, lead, device)
    params["wkv_up"] = init_linear(gen, cfg.kv_lora_rank, nh * (cfg.qk_nope_dim + cfg.v_head_dim),
                                   lead, device)
    params["kv_norm"] = init_rmsnorm(cfg.kv_lora_rank, lead, device)
    params["wo"] = init_linear(gen, nh * cfg.v_head_dim, d, lead, device)
    if cfg.quant.mode != "none":
        params["subln"] = init_rmsnorm(nh * cfg.v_head_dim, lead, device)
    return params


def _mla_q(params, x: Tensor, cfg: ModelConfig):
    """(q_nope, q_rope), each (B, S, H, ·): through the q LoRA pair
    (down, RMSNorm, up) where ``q_lora_rank`` > 0, else one ``wq``."""
    b, s, _ = x.shape
    if cfg.q_lora_rank > 0:
        cq = rmsnorm(params["q_norm"], bitlinear(params["wq_down"], x, cfg.quant))
        q = bitlinear(params["wq_up"], cq, cfg.quant)
    else:
        q = bitlinear(params["wq"], x, cfg.quant)
    q = q.reshape(b, s, cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)
    return q[..., : cfg.qk_nope_dim], q[..., cfg.qk_nope_dim :]


def _mla_project(params, x: Tensor, cfg: ModelConfig, rope: tuple[Tensor, Tensor]):
    """The queries and the new latents of x (B, S, D), rotated by ``rope``
    (sin/cos broadcastable to (B, S, 1, qk_rope / 2)): (q_nope, q_rope,
    the normed latent c_kv (B, S, kv_lora), the shared rope key (B, S,
    qk_rope)), from the joint KV down-projection [c_kv ; k_rope]."""
    q_nope, q_rope = _mla_q(params, x, cfg)
    down = bitlinear(params["wkv_down"], x, cfg.quant)
    ckv = rmsnorm(params["kv_norm"], down[..., : cfg.kv_lora_rank])
    krope = rotate(down[..., cfg.kv_lora_rank :][:, :, None, :], *rope)[:, :, 0]
    return q_nope, rotate(q_rope, *rope), ckv, krope


def _mla_expand_kv(params, ckv: Tensor, cfg: ModelConfig):
    """Expand the latents (B, L, kv_lora) into per-head K_nope and V."""
    b, s, _ = ckv.shape
    kv = bitlinear(params["wkv_up"], ckv, cfg.quant)
    kv = kv.reshape(b, s, cfg.n_heads, cfg.qk_nope_dim + cfg.v_head_dim)
    return kv[..., : cfg.qk_nope_dim], kv[..., cfg.qk_nope_dim :]


def _mla_attend(params, q_nope: Tensor, q_rope: Tensor, ckv: Tensor, krope: Tensor,
                mask: Optional[Tensor], cfg: ModelConfig) -> Tensor:
    """Score rotated queries against L latents: expand ckv (B, L, kv_lora)
    to K_nope / V, broadcast the rotated shared rope key krope (B, L,
    qk_rope) over the heads, attend at scale (qk_nope + qk_rope)^-1/2, then
    SubLN and ``wo``.  Returns y (B, Sq, D)."""
    b, sq = q_nope.shape[:2]
    l = ckv.shape[1]
    k_nope, v = _mla_expand_kv(params, ckv, cfg)
    k = torch.cat([k_nope, krope[:, :, None, :].expand(b, l, cfg.n_heads, cfg.qk_rope_dim)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = _sdpa(q, k, v, mask, scale=(cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5)
    return bitlinear(params["wo"], out.reshape(b, sq, -1), cfg.quant,
                     sublayer_norm=params.get("subln"))


def mla_attention(params, x: Tensor, cfg: ModelConfig, sin: Tensor, cos: Tensor) -> Tensor:
    """Full-sequence causal MLA (train / eval; serving runs
    :func:`mla_chunk`).  sin/cos: (S, qk_rope / 2) tables of positions
    0..S-1; the rope key is one head shared by all."""
    q_nope, q_rope, ckv, krope = _mla_project(params, x, cfg,
                                              (sin[None, :, None], cos[None, :, None]))
    s = x.shape[1]
    return _mla_attend(params, q_nope, q_rope, ckv, krope, causal_mask(s, s, 0, x.device), cfg)


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, lead: tuple = (),
                   device=None):
    """MLA caches only the compressed latent and the shared rope key — the
    architecture's memory win, kept (never expanded K/V), dense per slot
    in both serving layouts."""
    shape = lead + (batch, max_len)
    return {"ckv": torch.zeros(shape + (cfg.kv_lora_rank,), dtype=dtype, device=device),
            "krope": torch.zeros(shape + (cfg.qk_rope_dim,), dtype=dtype, device=device)}


def mla_chunk(params, x: Tensor, cache: dict, pos, cfg: ModelConfig,
              rope: tuple[Tensor, Tensor], active: Tensor | None = None,
              lengths: Tensor | None = None, read_to: int | None = None):
    """Cache-resident multi-token MLA (in place): span-write T latents,
    expand the latent cache up to the static ``read_to`` bound (see
    :func:`attention_chunk`) and score each query against its causal
    prefix.  T = 1 without ``lengths`` is :func:`mla_decode`, bit for bit
    the decode stream.  The latent cache stays dense in both layouts:
    with no paged K/V to walk, the paged-attention kernel does not apply.
    Returns (y (B, T, D), cache)."""
    b, t = x.shape[:2]
    if t == 1 and lengths is None:
        return mla_decode(params, x, cache, pos, cfg, rope, active=active)
    q_nope, q_rope, ckv, krope = _mla_project(params, x, cfg, rope)
    posmat = _pos_matrix(pos, t, x.device)
    valid = _chunk_valid(b, t, active, lengths, x.device)
    skv = cache["ckv"].shape[1]
    lim = skv if read_to is None else min(read_to, skv)
    if valid is None and isinstance(pos, int):
        # lockstep chunk: one slice write (rows past the end are dropped)
        end = min(pos + t, skv)
        cache["ckv"][:, pos:end] = ckv[:, : end - pos].to(cache["ckv"].dtype)
        cache["krope"][:, pos:end] = krope[:, : end - pos].to(cache["krope"].dtype)
    else:
        rows = posmat.expand(b, t)
        _span_write(cache["ckv"], ckv, rows, valid)
        _span_write(cache["krope"], krope, rows, valid)
    y = _mla_attend(params, q_nope, q_rope, cache["ckv"][:, :lim].to(x.dtype),
                    cache["krope"][:, :lim].to(x.dtype), _span_mask(posmat, lim), cfg)
    return y, cache


def mla_decode(params, x: Tensor, cache: dict, pos, cfg: ModelConfig,
               rope: tuple[Tensor, Tensor], active: Tensor | None = None):
    """One-token MLA decode step (in place), on the dense latent cache in
    both serving layouts: writes the token's latent at ``pos`` (per slot
    where ``pos`` is (B,); ``active`` masks slots) and expands the whole
    latent cache for scoring, as upstream (no weight absorption)."""
    b = x.shape[0]
    q_nope, q_rope, ckv, krope = _mla_project(params, x, cfg, rope)
    skv = cache["ckv"].shape[1]
    if isinstance(pos, int) and active is None:
        # lockstep: every slot writes one row (upstream's dynamic_update_slice
        # clamps the index into the cache)
        row = min(pos, skv - 1)
        cache["ckv"][:, row] = ckv[:, 0].to(cache["ckv"].dtype)
        cache["krope"][:, row] = krope[:, 0].to(cache["krope"].dtype)
    else:
        slots = _pos_matrix(pos, 1, x.device)[:, 0].expand(b)
        _slot_write(cache["ckv"], ckv, slots, active)
        _slot_write(cache["krope"], krope, slots, active)
    y = _mla_attend(params, q_nope, q_rope, cache["ckv"].to(x.dtype), cache["krope"].to(x.dtype),
                    _decode_mask(pos, skv, device=x.device), cfg)
    return y, cache
