"""Port of ``repro.models.api`` for the decoder family: the entry points
the server calls.  Other families raise ``NotImplementedError``.

    init_model(seed, cfg, device)                 -> params
    loss_fn(params, batch, cfg)                   -> (loss, {"nll", "aux"})
    forward(params, batch, cfg)                   -> (logits, aux)
    forward_chunk(params, toks, caches, pos, cfg, logits_at=None)
                                                  -> (logits (B,T,V) or (B,V), caches)
    prefill(params, batch, cfg, cache_len, last_pos=None) -> (logits_last, caches)
    decode_step(params, tokens, caches, pos, cfg) -> (logits, caches)
    init_cache(cfg, batch, max_len, dtype, device, layout=, block_size=, num_blocks=)
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.telemetry import probes


def _mod(cfg: ModelConfig):
    if cfg.family != "decoder":
        raise NotImplementedError(f"the {cfg.family} family is not yet ported")
    return transformer


def init_model(seed, cfg: ModelConfig, device=None):
    return _mod(cfg).init_model(seed, cfg, device)


def loss_fn(params, batch, cfg: ModelConfig):
    """The training loss.  Inside a ``probes.collect()`` scope the QAT
    probes recorded during the forward (clip rates, branch norms) join the
    metrics."""
    loss, metrics = _mod(cfg).lm_loss(params, batch, cfg)
    if probes.active():
        metrics = dict(metrics)
        metrics.update(probes.summaries())
    return loss, metrics


def forward(params, batch, cfg: ModelConfig):
    return _mod(cfg).forward(params, batch, cfg)


def prefill(params, batch, cfg: ModelConfig, cache_len: int, last_pos=None):
    """``last_pos`` selects the logits position of a right-padded prompt."""
    return _mod(cfg).prefill(params, batch, cfg, cache_len, last_pos)


def decode_step(params, tokens, caches, pos, cfg: ModelConfig, active=None):
    return _mod(cfg).decode_step(params, tokens, caches, pos, cfg, active)


def forward_chunk(params, tokens, caches, pos, cfg: ModelConfig, active=None, lengths=None,
                  logits_at=None):
    """``logits_at`` (B,) returns only each slot's logits at that chunk index."""
    return _mod(cfg).forward_chunk(params, tokens, caches, pos, cfg, active=active,
                                   lengths=lengths, logits_at=logits_at)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None, layout: str = "dense", block_size: int = 16,
               num_blocks: int | None = None):
    """``layout="paged"`` builds the block-pool caches (``num_blocks`` per
    layer, default full occupancy) the continuous-batching engine serves."""
    return _mod(cfg).init_cache(cfg, batch, max_len, dtype, device, layout, block_size,
                                num_blocks)
