"""Port of ``repro.models.encdec``: the Whisper-style encoder-decoder.

The conv/mel frontend is a stub, as upstream: the model takes precomputed
frame embeddings ``batch["frames"]`` (B, F, D).  Downstream of it
everything is real and pQuant-quantized: fixed sinusoidal encoder
positions, a bidirectional encoder, a causal decoder with cross-attention
and learned positions; self- and cross-attention projections are 1-bit,
the FFNs decoupled.

API (as upstream, with a seed or generator where upstream takes a key):
  init_model(seed, cfg, device)                    -> params
  encode(params, frames, cfg)                      -> memory (B, F, D)
  forward(params, batch, cfg)                      -> (logits, aux_loss)
  lm_loss(params, batch, cfg)                      -> (loss, {"nll", "aux"})
  prefill(params, batch, cfg, cache_len, last_pos=None) -> (logits_last, caches)
  decode_step(params, tokens, caches, pos, cfg, active=None) -> (logits, caches)
  init_cache(cfg, batch, max_len, dtype, device)   -> caches

``params["encoder"]`` and ``params["decoder"]`` keep every leaf stacked
on a leading layer axis, so params convert leaf for leaf; upstream's
``lax.scan`` becomes a Python loop over per-layer views, each layer under
``torch.utils.checkpoint`` with ``cfg.remat`` and grad enabled.  The
caches ``{"self": {"k", "v"}, "cross_k", "cross_v"}`` are stacked over
the decoder's layers; a decode step writes the self cache in place (the
dense adapter of ``attention_decode``) and leaves the cross K/V, computed
once by the prefill, as they are.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (
    apply_ffn,
    cross_entropy_loss,
    embed,
    init_embedding,
    init_ffn,
    init_learned_pos,
    init_rmsnorm,
    rmsnorm,
    unembed,
)
from repro_torch.models.transformer import _generator, _unstack

Tensor = torch.Tensor


@functools.lru_cache(maxsize=8)
def _sinusoid(length: int, d_model: int, device: torch.device) -> Tensor:
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float64) / (half - 1))
    angles = torch.arange(length, dtype=torch.float64)[:, None] * freqs[None, :]
    table = torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)
    return table.to(device=device, dtype=torch.float32)


def sinusoid_table(length: int, d_model: int, device=None) -> Tensor:
    """Whisper's fixed sinusoidal positions (length, d_model) in f32:
    ``[sin(p w), cos(p w)]`` at ``w_i = exp(-ln(10000) i / (half - 1))``.

    Computed in f64 on the host and rounded once to f32, then kept on
    ``device`` (default the CPU): the same bits on every device.  Upstream
    computes it in f32, whose ``exp`` and ``sin`` round differently on
    each backend, by a few ulps of angles up to the frame count (1499
    rad at Whisper's 1500 frames).  Callers must not write into it."""
    return _sinusoid(length, d_model, torch.device(device or "cpu"))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_enc_layer(gen, cfg: ModelConfig, lead: tuple = (), device=None):
    return {
        "pre_norm": init_rmsnorm(cfg.d_model, lead, device),
        "attn": attn_mod.init_attention(gen, cfg, lead, device),
        "ffn_norm": init_rmsnorm(cfg.d_model, lead, device),
        "ffn": init_ffn(gen, cfg, lead, device),
    }


def _init_dec_layer(gen, cfg: ModelConfig, lead: tuple = (), device=None):
    return {
        "pre_norm": init_rmsnorm(cfg.d_model, lead, device),
        "self_attn": attn_mod.init_attention(gen, cfg, lead, device),
        "cross_norm": init_rmsnorm(cfg.d_model, lead, device),
        "cross_attn": attn_mod.init_attention(gen, cfg, lead, device),
        "ffn_norm": init_rmsnorm(cfg.d_model, lead, device),
        "ffn": init_ffn(gen, cfg, lead, device),
    }


def init_model(seed, cfg: ModelConfig, device=None):
    """Latent f32 parameters from ``seed`` (an int, or a torch.Generator
    whose device is used), on ``device`` (default: the CUDA device)."""
    gen, dev = _generator(seed, device)
    params: dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dev),
        "dec_pos": init_learned_pos(gen, cfg.max_seq_len, cfg.d_model, dev),
        "encoder": _init_enc_layer(gen, cfg, (cfg.n_enc_layers,), dev),
        "decoder": _init_dec_layer(gen, cfg, (cfg.n_layers,), dev),
        "enc_final_norm": init_rmsnorm(cfg.d_model, (), dev),
        "final_norm": init_rmsnorm(cfg.d_model, (), dev),
    }
    return params


# ---------------------------------------------------------------------------
# Forward (train / eval)
# ---------------------------------------------------------------------------


def _run_layers(layer_fn, carry, stack, n: int, cfg: ModelConfig):
    """``carry = layer_fn(layer, *carry)`` over the ``n`` per-layer views
    of a stacked tree, each under ``checkpoint`` with ``cfg.remat`` and
    grad enabled (the layers draw no random numbers)."""
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in _unstack(stack, n):
        if remat:
            carry = checkpoint(layer_fn, layer, *carry, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            carry = layer_fn(layer, *carry)
    return carry


def encode(params, frames: Tensor, cfg: ModelConfig) -> Tensor:
    """frames: precomputed (stub) frame embeddings (B, F, D) -> memory."""
    x = frames + sinusoid_table(frames.shape[1], cfg.d_model, frames.device).to(frames.dtype)[None]

    def layer_fn(lp, x):
        h = rmsnorm(lp["pre_norm"], x)
        x = x + attn_mod.attention(lp["attn"], h, cfg, None, None, causal=False)
        h = rmsnorm(lp["ffn_norm"], x)
        y, _ = apply_ffn(lp["ffn"], h, cfg)
        return (x + y,)

    (x,) = _run_layers(layer_fn, (x,), params["encoder"], cfg.n_enc_layers, cfg)
    return rmsnorm(params["enc_final_norm"], x)


def _dec_layer_apply(lp, x: Tensor, memory: Tensor, cfg: ModelConfig, cache_len=None):
    """One decoder layer over the whole prompt: causal self-attention,
    cross-attention over ``memory``, the FFN.  Returns (x, aux, cache):
    with ``cache_len`` the layer's {"self": {"k", "v"}, "cross_k",
    "cross_v"}, else None."""
    h = rmsnorm(lp["pre_norm"], x)
    out = attn_mod.attention(lp["self_attn"], h, cfg, None, None, causal=True,
                             cache_len=cache_len)
    y, self_cache = out if cache_len else (out, None)
    x = x + y
    h = rmsnorm(lp["cross_norm"], x)
    ck, cv = attn_mod.cross_kv(lp["cross_attn"], memory, cfg)
    x = x + attn_mod.cross_attention(lp["cross_attn"], h, ck, cv, cfg)
    h = rmsnorm(lp["ffn_norm"], x)
    y, aux = apply_ffn(lp["ffn"], h, cfg)
    cache = {"self": self_cache, "cross_k": ck, "cross_v": cv} if cache_len else None
    return x + y, aux, cache


def _decoder_input(params, batch: dict, cfg: ModelConfig):
    """(the embedded prompt plus its learned positions, the encoder's
    memory cast to the decoder carry's dtype: frames may arrive f32)."""
    memory = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens, cfg)
    x = x + params["dec_pos"]["pos"][: tokens.shape[1]].to(x.dtype)[None]
    return x, memory.to(x.dtype)


def forward(params, batch: dict, cfg: ModelConfig):
    """batch: {"frames": (B, F, D), "tokens": (B, S)}.  Returns (logits
    (B, S, V), aux)."""
    x, memory = _decoder_input(params, batch, cfg)

    def layer_fn(lp, x, aux_acc):
        x, aux, _ = _dec_layer_apply(lp, x, memory, cfg)
        return x, aux_acc + aux

    aux0 = torch.zeros((), dtype=torch.float32, device=x.device)
    x, aux = _run_layers(layer_fn, (x, aux0), params["decoder"], cfg.n_layers, cfg)
    x = rmsnorm(params["final_norm"], x)
    return unembed(params["embed"], x, cfg), aux


def lm_loss(params, batch: dict, cfg: ModelConfig):
    """Next-token CE of the decoder.  batch needs "frames", "tokens" and
    "labels" and may hold a "mask".  Returns (loss + aux, {"nll", "aux"})."""
    logits, aux = forward(params, batch, cfg)
    loss, nll = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    return loss + aux.to(loss.dtype), {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + decode with the self-attention KV cache and cached
# cross K/V
# ---------------------------------------------------------------------------


def _alloc_cache(cfg: ModelConfig, batch: int, max_len: int, frames: int, dtype, device):
    """Zero caches stacked over the decoder's layers: the self K/V of
    ``max_len`` positions, the cross K/V of ``frames``."""
    self_shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cross_shape = (cfg.n_layers, batch, frames, cfg.n_kv_heads, cfg.head_dim)
    return {"self": {"k": torch.zeros(self_shape, dtype=dtype, device=device),
                     "v": torch.zeros(self_shape, dtype=dtype, device=device)},
            "cross_k": torch.zeros(cross_shape, dtype=dtype, device=device),
            "cross_v": torch.zeros(cross_shape, dtype=dtype, device=device)}


def prefill(params, batch: dict, cfg: ModelConfig, cache_len: int, last_pos=None):
    """Encode the frames, run the decoder prompt, fill the caches: the
    self cache of ``cache_len`` positions (``attention(cache_len=)``) and
    the cross K/V of the memory.  Returns (logits (B, V) at the last
    position, or at ``last_pos - 1`` (an int or 0-d tensor, clamped into
    the prompt) for a right-padded prompt; the caches)."""
    x, memory = _decoder_input(params, batch, cfg)
    caches = _alloc_cache(cfg, x.shape[0], cache_len, memory.shape[1], x.dtype, x.device)
    for i, lp in enumerate(_unstack(params["decoder"], cfg.n_layers)):
        x, _, c = _dec_layer_apply(lp, x, memory, cfg, cache_len=cache_len)
        for name in ("k", "v"):
            caches["self"][name][i].copy_(c["self"][name])
        for name in ("cross_k", "cross_v"):
            caches[name][i].copy_(c[name])
    if last_pos is None:
        xl = x[:, -1:]
    else:
        idx = torch.as_tensor(last_pos, device=x.device).long().reshape(1) - 1
        xl = x.index_select(1, idx.clamp(0, x.shape[1] - 1))
    x = rmsnorm(params["final_norm"], xl)
    return unembed(params["embed"], x, cfg)[:, 0], caches


def _pos_embedding(table: Tensor, pos) -> Tensor:
    """The learned positions of one decode token: (1, 1, D) at a scalar
    ``pos`` (clamped into the table, as upstream's ``dynamic_slice``),
    (B, 1, D) at per-slot (B,) positions."""
    if not torch.is_tensor(pos):
        p = min(max(int(pos), 0), table.shape[0] - 1)
        return table[p:p + 1][None]
    if pos.ndim == 0:
        return table.index_select(0, pos.long().clamp(0, table.shape[0] - 1).reshape(1))[None]
    return table.index_select(0, pos.long())[:, None]


def decode_step(params, tokens: Tensor, caches, pos, cfg: ModelConfig,
                active: Tensor | None = None):
    """tokens (B, 1) at ``pos`` (an int, 0-d or (B,) tensor); ``active``
    (B,) masks per-slot self-cache writes.  The caches from :func:`prefill`
    are updated in place.  Returns (logits (B, 1, V), caches)."""
    x = embed(params["embed"], tokens, cfg)
    x = x + _pos_embedding(params["dec_pos"]["pos"], pos).to(x.dtype)
    layers = _unstack(params["decoder"], cfg.n_layers)
    for i, lp in enumerate(layers):
        self_cache = {"k": caches["self"]["k"][i], "v": caches["self"]["v"][i]}
        h = rmsnorm(lp["pre_norm"], x)
        y, _ = attn_mod.attention_decode(lp["self_attn"], h, self_cache, pos, cfg, None,
                                         active=active)
        x = x + y
        h = rmsnorm(lp["cross_norm"], x)
        x = x + attn_mod.cross_attention(lp["cross_attn"], h, caches["cross_k"][i],
                                         caches["cross_v"][i], cfg)
        h = rmsnorm(lp["ffn_norm"], x)
        y, _ = apply_ffn(lp["ffn"], h, cfg)
        x = x + y
    x = rmsnorm(params["final_norm"], x)
    return unembed(params["embed"], x, cfg), caches


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    """The decoder's caches, zeros, stacked over its layers: the self cache
    of ``max_len`` positions and the cross K/V of ``n_frontend_tokens``."""
    return _alloc_cache(cfg, batch, max_len, cfg.n_frontend_tokens, dtype,
                        resolve_device(device))
