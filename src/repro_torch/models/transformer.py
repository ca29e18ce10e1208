"""Port of ``repro.models.transformer`` for the attention decoder family.

API (as upstream, with a generator or seed where upstream takes a key):
  init_model(seed, cfg, device)                    -> params
  forward(params, batch, cfg)                      -> (logits, aux_loss)
  lm_loss(params, batch, cfg)                      -> (loss, {"nll", "aux"})
  init_cache(cfg, batch, max_len, dtype, device, layout=, block_size=, num_blocks=)
                                                   -> caches (dense or paged)
  forward_chunk(params, toks, caches, pos, cfg, logits_at=None)
                                                   -> (logits (B,T,V) or (B,V), caches)
  prefill(params, batch, cfg, cache_len, last_pos=None) -> (logits_last, caches)
  decode_step(params, token, caches, pos, cfg)     -> (logits, caches)

Layer stacks keep upstream's layout: a segment of R > 1 repeated blocks
stores every leaf with a leading (R,) axis, so params convert leaf for
leaf.  Upstream's ``lax.scan`` over the stack becomes a Python loop over
per-layer views of the same stacked tensors; with ``cfg.remat`` and grad
enabled, each layer runs under ``torch.utils.checkpoint`` (upstream's
``jax.checkpoint`` with ``nothing_saveable``).  Serving runs one forward:
``prefill`` is ``forward_chunk`` from an empty cache and ``decode_step``
is ``forward_chunk`` with T=1; caches are updated in place.

Ported segment plans: the full-attention decoder; the MoE plan
(DeepSeek-MoE: ``first_k_dense`` dense blocks, then MoE blocks,
``models/moe.py``); sliding-window attention (``attn_type="swa"``: every
layer windowed) and gemma3's local/global interleave (``global_every``:
period segments of ``global_every - 1`` local blocks and one global,
then a remainder segment); and MLA (``attn_type="mla"``, DeepSeek-V2:
the same plans with ``mixer="mla"``, ``models/attention.py``'s
``mla_*``); Mamba-2 (``family="ssm"``: one segment of ``n_layers``
SSD blocks without an FFN, ``models/ssm.py``); and the RG-LRU hybrid
(``family="hybrid"``, RecurrentGemma: ``n_layers // len(block_pattern)``
repeats of the pattern, then one repeat of its first ``n_layers %
len(block_pattern)`` blocks; an RG-LRU block, ``models/rglru.py``, keeps
its FFN, and every block's window is ``layer_window``'s).  A windowed layer keeps a
dense RING cache of ``min(window, max_len)`` positions in both cache
layouts, and rotates at
``rope_theta_local`` under ``global_every``; an MLA layer keeps its dense
latent cache ``{"ckv", "krope"}`` in both layouts (no MLA layer goes on
the paged pool) and rotates its ``qk_rope_dim`` slice.  Upstream scans a
stacked segment with per-layer metadata as scanned arrays; the port's
loop reads each layer's window and theta as Python values.  An SSM
layer keeps a dense cache {"conv" (serving dtype), "state" (f32)} and an
RG-LRU layer {"h" (f32), "conv" (serving dtype)} in both layouts,
rewritten in place after each chunk; inactive slots keep theirs bit for
bit (upstream's ``_freeze_inactive``).  The encoder-decoder family is
``models/encdec.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    apply_ffn,
    cross_entropy_loss,
    embed,
    init_embedding,
    init_ffn,
    init_rmsnorm,
    rmsnorm,
    rope_table,
    unembed,
)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Segment plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: str  # attn | mla | ssm | rec
    ffn: str | None  # dense | moe | None (an SSM block has no FFN)
    # static sliding window of this block (0 = full attention); a windowed
    # layer keeps a RING cache of exactly min(window, max_len) positions
    window: int = 0


@dataclasses.dataclass(frozen=True)
class Segment:
    repeats: int
    blocks: tuple[BlockSpec, ...]
    first_layer: int  # absolute layer index of the first block (window / theta)


def build_segments(cfg: ModelConfig) -> list[Segment]:
    """The model's segments: for the SSM family one segment of
    ``n_layers`` Mamba-2 blocks without an FFN; for the hybrid family
    ``n_layers // g`` repeats of ``block_pattern`` (g blocks, each with a
    dense FFN and ``layer_window``'s window), then one repeat of the
    pattern's first ``n_layers % g`` blocks; for the decoder one segment
    of ``n_layers`` attention + dense-FFN blocks (windowed under
    ``attn_type="swa"``); with
    ``cfg.moe``, one segment of ``first_k_dense`` dense blocks (one repeat),
    then ``n_layers - first_k_dense`` repeats of an MoE block; with
    ``global_every`` g, ``n_layers // g`` repeats of (g - 1 local blocks,
    one global), then one repeat of the remaining local blocks.  Every
    block's mixer is ``"mla"`` under ``attn_type="mla"``."""
    if cfg.family == "ssm":
        return [Segment(cfg.n_layers, (BlockSpec("ssm", None),), 0)]
    if cfg.family == "hybrid":
        pat = cfg.block_pattern
        g = len(pat)
        reps, rem = divmod(cfg.n_layers, g)

        def pattern(first, n):
            return tuple(BlockSpec(m, "dense", layer_window(cfg, first + i))
                         for i, m in enumerate(pat[:n]))

        segs = [Segment(reps, pattern(0, g), 0)]
        if rem:
            segs.append(Segment(1, pattern(reps * g, rem), reps * g))
        return segs
    if cfg.family != "decoder" or cfg.attn_type not in ("full", "swa", "mla"):
        raise NotImplementedError(
            f"{cfg.name}: only the full-attention, sliding-window and MLA decoder (dense or "
            "MoE), the SSM and the RG-LRU hybrid are ported"
        )
    mixer = "mla" if cfg.attn_type == "mla" else "attn"
    if cfg.moe:
        k = cfg.first_k_dense
        segs = [Segment(1, tuple(BlockSpec(mixer, "dense") for _ in range(k)), 0)] if k else []
        return segs + [Segment(cfg.n_layers - k, (BlockSpec(mixer, "moe"),), k)]
    if cfg.global_every > 0:
        # group by the local:global period so that each block's cache length
        # is the same over the repeats (local blocks get ring caches)
        g = cfg.global_every
        reps, rem = divmod(cfg.n_layers, g)

        def blocks(first, n):
            return tuple(BlockSpec(mixer, "dense", layer_window(cfg, first + i))
                         for i in range(n))

        segs = [Segment(reps, blocks(0, g), 0)]
        if rem:
            segs.append(Segment(1, blocks(reps * g, rem), reps * g))
        return segs
    win = cfg.window_size if cfg.attn_type == "swa" else 0
    return [Segment(cfg.n_layers, (BlockSpec(mixer, "dense", win),), 0)]


def layer_window(cfg: ModelConfig, layer: int) -> int:
    """Static per-layer sliding window (0 = global/full)."""
    if cfg.global_every > 0:
        return 0 if (layer + 1) % cfg.global_every == 0 else cfg.window_size
    if cfg.attn_type == "swa":
        return cfg.window_size
    return 0


def layer_uses_local_rope(cfg: ModelConfig, layer: int) -> bool:
    return cfg.global_every > 0 and (layer + 1) % cfg.global_every != 0


def _local_rope(cfg: ModelConfig, spec: BlockSpec) -> bool:
    """Whether a block takes the local RoPE theta: its window is static over
    its segment's repeats, so this is ``layer_uses_local_rope`` of each of
    its layers."""
    return cfg.global_every > 0 and spec.window > 0


def _uses_rope(cfg: ModelConfig) -> bool:
    """Whether any layer rotates: an SSM has no attention to rotate."""
    return cfg.pos_embedding == "rope" and cfg.family != "ssm"


def _rope_dim(cfg: ModelConfig) -> int:
    """The rotated width: MLA rotates its ``qk_rope_dim`` slice, other
    attention the whole head."""
    return cfg.qk_rope_dim if cfg.attn_type == "mla" else cfg.head_dim


# ---------------------------------------------------------------------------
# Layer stacks
# ---------------------------------------------------------------------------


def _unstack(tree, n: int) -> list:
    """Per-layer views of a stacked tree: n trees whose leaves are t[r]."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(n)]
    return list(tree.unbind(0))


def _seg_layers(seg: Segment, tree) -> list:
    """The per-repeat trees of a segment's params or caches (a segment of
    one repeat stores its block unstacked, as upstream)."""
    return [tree] if seg.repeats == 1 else _unstack(tree, seg.repeats)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _generator(seed, device) -> tuple[torch.Generator, torch.device]:
    if isinstance(seed, torch.Generator):
        return seed, seed.device
    dev = resolve_device(device)
    return torch.Generator(device=dev).manual_seed(int(seed)), dev


def _init_block(gen, spec: BlockSpec, cfg: ModelConfig, lead: tuple, device):
    params: dict[str, Any] = {"pre_norm": init_rmsnorm(cfg.d_model, lead, device)}
    if spec.mixer == "mla":
        params["mixer"] = attn_mod.init_mla(gen, cfg, lead, device)
    elif spec.mixer == "ssm":
        params["mixer"] = ssm_mod.init_mamba_block(gen, cfg, lead, device)
    elif spec.mixer == "rec":
        params["mixer"] = rglru_mod.init_rglru_block(gen, cfg, lead, device)
    else:
        params["mixer"] = attn_mod.init_attention(gen, cfg, lead, device)
    if spec.ffn is None:
        return params
    params["ffn_norm"] = init_rmsnorm(cfg.d_model, lead, device)
    if spec.ffn == "moe":
        params["ffn"] = moe_mod.init_moe_ffn(gen, cfg, lead, device)
    else:
        params["ffn"] = init_ffn(gen, cfg, lead, device)
    return params


def init_model(seed, cfg: ModelConfig, device=None):
    """Latent f32 parameters from ``seed`` (an int, or a torch.Generator
    whose device is used), on ``device`` (default: the CUDA device)."""
    gen, dev = _generator(seed, device)
    params: dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dev)
    }
    segs = []
    for seg in build_segments(cfg):
        lead = () if seg.repeats == 1 else (seg.repeats,)
        segs.append({f"b{bi}": _init_block(gen, spec, cfg, lead, dev)
                     for bi, spec in enumerate(seg.blocks)})
    params["segments"] = segs
    params["final_norm"] = init_rmsnorm(cfg.d_model, (), dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(gen, cfg.vocab_size, cfg.d_model, dev)
    return params


# ---------------------------------------------------------------------------
# Forward (train / eval, full sequence)
# ---------------------------------------------------------------------------


def _ffn(bparams, spec: BlockSpec, h: Tensor, cfg: ModelConfig):
    """The block's FFN: (y, aux)."""
    if spec.ffn == "moe":
        return moe_mod.moe_ffn(bparams["ffn"], h, cfg)
    return apply_ffn(bparams["ffn"], h, cfg)


def _apply_block(bparams, spec: BlockSpec, x: Tensor, cfg: ModelConfig, sin, cos):
    """Pre-norm residual block.  Returns (x, aux): an SSM block's aux is its
    projections' (routed ones'), an attention block's its FFN's."""
    h = rmsnorm(bparams["pre_norm"], x)
    if spec.mixer == "ssm":  # no FFN
        y, aux = ssm_mod.mamba_block(bparams["mixer"], h, cfg)
        return x + y, aux
    if spec.mixer == "mla":
        x = x + attn_mod.mla_attention(bparams["mixer"], h, cfg, sin, cos)
    elif spec.mixer == "rec":
        x = x + rglru_mod.rglru_block(bparams["mixer"], h, cfg)
    else:
        x = x + attn_mod.attention(bparams["mixer"], h, cfg, sin, cos, window=spec.window)
    h = rmsnorm(bparams["ffn_norm"], x)
    y, aux = _ffn(bparams, spec, h, cfg)
    return x + y, aux


def _apply_layer(layer, x: Tensor, cfg: ModelConfig, tabs: dict, specs: tuple[BlockSpec, ...]):
    aux_layer = torch.zeros((), dtype=torch.float32, device=x.device)
    for bi, spec in enumerate(specs):
        x, aux = _apply_block(layer[f"b{bi}"], spec, x, cfg, *tabs[_local_rope(cfg, spec)])
        aux_layer = aux_layer + aux
    return x, aux_layer


def _rope_tabs(cfg: ModelConfig, rope) -> dict:
    """{local?: tables}: the global theta's, and under ``global_every`` the
    local layers' (``rope(theta)`` builds one pair)."""
    tabs = {False: rope(cfg.rope_theta)}
    if cfg.global_every > 0:
        tabs[True] = rope(cfg.rope_theta_local)
    return tabs


def _embed_inputs(params, batch: dict, cfg: ModelConfig) -> Tensor:
    """The token embeddings, with a VLM batch's "image_embeds" (B, n_img, D)
    cast to their dtype and put before them on the sequence axis."""
    x = embed(params["embed"], batch["tokens"], cfg)
    if cfg.n_image_tokens > 0 and "image_embeds" in batch:
        x = torch.cat([batch["image_embeds"].to(x.dtype), x], dim=1)
    return x


def forward(params, batch: dict, cfg: ModelConfig):
    """batch: {"tokens": (B, S)} (+ "image_embeds" for a VLM).  Returns
    (logits (B, S_total, V), aux_loss); the image rows come first.

    Under grad with ``cfg.remat``, a layer keeps only its input for the
    backward pass and runs again there; the values are the same."""
    x = _embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    tabs = {False: (None, None)}
    if _uses_rope(cfg):
        tabs = _rope_tabs(cfg, lambda theta: rope_table(positions, _rope_dim(cfg), theta))
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for si, seg in enumerate(build_segments(cfg)):
        for layer in _seg_layers(seg, params["segments"][si]):
            if remat:  # the layer draws no random numbers: no RNG state to keep
                x, aux = checkpoint(_apply_layer, layer, x, cfg, tabs, seg.blocks,
                                    use_reentrant=False, preserve_rng_state=False)
            else:
                x, aux = _apply_layer(layer, x, cfg, tabs, seg.blocks)
            aux_total = aux_total + aux
    x = rmsnorm(params["final_norm"], x)
    head = params.get("lm_head", params["embed"])
    return unembed(head, x, cfg), aux_total


def lm_loss(params, batch: dict, cfg: ModelConfig):
    """Next-token CE over the text positions.  batch needs "tokens" and
    "labels" (both (B, S)) and may hold a "mask"; image positions (if any)
    are excluded.  Returns (loss + aux, {"nll", "aux"})."""
    logits, aux = forward(params, batch, cfg)
    n_img = cfg.n_image_tokens if "image_embeds" in batch else 0
    logits = logits[:, n_img:]
    loss, nll = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    return loss + aux.to(loss.dtype), {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# KV cache / prefill / decode
# ---------------------------------------------------------------------------


def _init_block_cache(spec: BlockSpec, cfg: ModelConfig, batch: int, max_len: int, dtype,
                      lead: tuple, device, layout: str, block_size: int,
                      num_blocks: int | None):
    if spec.mixer == "ssm":  # constant-size recurrent state, dense in both layouts
        return ssm_mod.init_mamba_cache(cfg, batch, dtype, lead, device)
    if spec.mixer == "rec":  # likewise (its spec's window is the config's, unused here)
        return rglru_mod.init_rglru_cache(cfg, batch, dtype, lead, device)
    if spec.mixer == "mla":  # the dense latent cache in both layouts
        return attn_mod.init_mla_cache(cfg, batch, max_len, dtype, lead, device)
    if spec.window > 0:
        # a sliding-window layer keeps the dense RING in both layouts: a
        # W-position ring is the window, and W is small
        length = min(spec.window, max_len)
        return attn_mod.init_attention_cache(cfg, batch, length, dtype, lead, device)
    if layout == "paged":
        from repro_torch.serve import kv_pool  # deferred: serve imports models

        nb = num_blocks or batch * kv_pool.blocks_for(max_len, block_size)
        return kv_pool.init_paged_attention_cache(
            batch, max_len, cfg.n_kv_heads, cfg.head_dim, nb, block_size, dtype, device, lead
        )
    return attn_mod.init_attention_cache(cfg, batch, max_len, dtype, lead, device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None, layout: str = "dense", block_size: int = 16,
               num_blocks: int | None = None):
    """KV caches structured like upstream's (a leading (R,) axis on a
    segment of R > 1 repeats).  ``layout="dense"`` gives per-slot buffers;
    ``layout="paged"`` swaps the attention layers to the shared block pool
    of ``num_blocks`` blocks (default: full occupancy) with per-slot
    tables (``repro_torch.serve.kv_pool``) — interchangeable at every call
    site.  A sliding-window layer keeps its dense ring, an MLA layer its
    dense latent cache, an SSM layer its conv tail and state and an RG-LRU
    layer its hidden state and conv tail, in both layouts."""
    if layout not in ("dense", "paged"):
        raise ValueError(f"unknown cache layout {layout!r}")
    dev = resolve_device(device)
    caches = []
    for seg in build_segments(cfg):
        lead = () if seg.repeats == 1 else (seg.repeats,)
        caches.append({
            f"b{bi}": _init_block_cache(spec, cfg, batch, max_len, dtype, lead, dev, layout,
                                        block_size, num_blocks)
            for bi, spec in enumerate(seg.blocks)
        })
    return caches


def _recurrent_chunk(mparams, x: Tensor, cache: dict, cfg: ModelConfig, active=None,
                     lengths=None, mixer: str = "ssm"):
    """A recurrent layer's T-token chunk from its cached state: the step
    form at T = 1 (``mamba_decode``, ``rglru_decode``), the block form for
    T > 1 (``mamba_block``, ``rglru_block``); they are the same recurrence
    in different float associations.  ``mixer`` is "ssm" or "rec".  The
    new state and conv tail are written into the cache's tensors; an
    inactive slot's rows keep their bits (upstream's
    ``_freeze_inactive``)."""
    if lengths is not None:
        raise NotImplementedError(
            "ragged chunk lengths are attention-family only (recurrent state would "
            "integrate the pad tail); chunked admission prefill gates on "
            "_chunked_prefill_safe accordingly")
    if mixer == "rec":
        if x.shape[1] == 1:
            y, new = rglru_mod.rglru_decode(mparams, x, cache, cfg)
        else:
            y, new = rglru_mod.rglru_block(mparams, x, cfg, return_cache=True, cache=cache)
    elif x.shape[1] == 1:
        y, new = ssm_mod.mamba_decode(mparams, x, cache, cfg)
    else:
        y, _, new = ssm_mod.mamba_block(mparams, x, cfg, return_cache=True, cache=cache)
    for name, t in new.items():
        old = cache[name]
        if active is not None:
            t = torch.where(active.reshape(active.shape + (1,) * (t.ndim - 1)), t,
                            old.to(t.dtype))
        old.copy_(t)
    return y, cache


def _chunk_block(bparams, spec, x, cache, pos, cfg, rope, active=None, lengths=None,
                 read_to=None):
    h = rmsnorm(bparams["pre_norm"], x)
    if spec.mixer in ("ssm", "rec"):
        y, cache = _recurrent_chunk(bparams["mixer"], h, cache, cfg, active, lengths,
                                    spec.mixer)
    elif spec.mixer == "mla":
        y, cache = attn_mod.mla_chunk(bparams["mixer"], h, cache, pos, cfg, rope,
                                      active=active, lengths=lengths, read_to=read_to)
    else:
        y, cache = attn_mod.attention_chunk(
            bparams["mixer"], h, cache, pos, cfg, rope,
            active=active, lengths=lengths, read_to=read_to, ring=spec.window > 0,
        )
    x = x + y
    if spec.ffn is None:  # an SSM block
        return x, cache
    h = rmsnorm(bparams["ffn_norm"], x)
    y, _ = _ffn(bparams, spec, h, cfg)  # serving drops the aux loss, as upstream
    return x + y, cache


def _forward_chunk_x(params, x: Tensor, caches, pos, cfg: ModelConfig,
                     active=None, lengths=None, read_to: int | None = None):
    """Walk the layers over embedded inputs x (B, T, D), extending the caches
    in place.  Returns (hidden (B, T, D), caches)."""
    tabs = {False: None, True: None}
    if _uses_rope(cfg):  # one pair of tables a theta, for every layer
        tabs = _rope_tabs(cfg, lambda theta: attn_mod.rope_at(pos, x.shape[1], _rope_dim(cfg),
                                                              theta, x.device))
    for si, seg in enumerate(build_segments(cfg)):
        layers_c = _seg_layers(seg, caches[si])
        for r, layer in enumerate(_seg_layers(seg, params["segments"][si])):
            for bi, spec in enumerate(seg.blocks):
                x, _ = _chunk_block(
                    layer[f"b{bi}"], spec, x, layers_c[r][f"b{bi}"], pos, cfg,
                    tabs[_local_rope(cfg, spec)],
                    active, lengths, read_to,
                )
    return x, caches


def forward_chunk(params, tokens: Tensor, caches, pos, cfg: ModelConfig,
                  active: Tensor | None = None, lengths: Tensor | None = None,
                  logits_at: Tensor | None = None):
    """Cache-resident multi-token forward, the single serving code path:
    tokens (B, T) at absolute positions pos.. (int, 0-d or (B,) tensor)
    extend the caches; each token attends the resident prefix plus its
    in-chunk causal predecessors.  Returns (logits (B, T, V), caches); with
    ``logits_at`` — a per-slot (B,) chunk-relative index — only that
    position's logits (B, V), without unembedding the whole chunk (what
    admission prefill reads: each slot's last real prompt token)."""
    x = embed(params["embed"], tokens, cfg)
    x, caches = _forward_chunk_x(params, x, caches, pos, cfg, active, lengths)
    head = params.get("lm_head", params["embed"])
    if logits_at is not None:
        idx = torch.as_tensor(logits_at, device=x.device).long()
        xl = torch.take_along_dim(x, idx.reshape(-1, 1, 1), dim=1)
        return unembed(head, rmsnorm(params["final_norm"], xl), cfg)[:, 0], caches
    x = rmsnorm(params["final_norm"], x)
    return unembed(head, x, cfg), caches


def prefill(params, batch: dict, cfg: ModelConfig, cache_len: int, last_pos=None):
    """The whole prompt as one :func:`forward_chunk` from an empty cache of
    length ``cache_len``: last-position logits (B, V) and the caches.

    ``last_pos`` (int or 0-d tensor) reads the logits at position
    ``last_pos - 1`` instead of the final one: the hook for a prompt
    right-padded to a shared length.  Causal masking keeps every position
    before ``last_pos`` as an exact-length prefill computes it; as
    upstream's ``dynamic_slice``, an index outside the prompt is clamped
    into it.  A VLM batch's "image_embeds" take the first positions."""
    x = _embed_inputs(params, batch, cfg)
    caches = init_cache(cfg, x.shape[0], cache_len, dtype=x.dtype, device=x.device)
    x, caches = _forward_chunk_x(params, x, caches, 0, cfg, read_to=x.shape[1])
    if last_pos is None:
        xl = x[:, -1:]
    else:
        idx = torch.as_tensor(last_pos, device=x.device).long().reshape(1) - 1
        xl = x.index_select(1, idx.clamp(0, x.shape[1] - 1))
    x = rmsnorm(params["final_norm"], xl)
    head = params.get("lm_head", params["embed"])
    return unembed(head, x, cfg)[:, 0], caches


def decode_step(params, tokens: Tensor, caches, pos, cfg: ModelConfig,
                active: Tensor | None = None):
    """One decode step — :func:`forward_chunk` with T=1.  tokens: (B, 1)."""
    return forward_chunk(params, tokens, caches, pos, cfg, active=active)
