"""Port of ``repro.train.serve``: the decode and prefill steps, and
``BatchedServer``, a fixed-batch server over the port's ``DecodeEngine``.

``BatchedServer.generate`` and ``generate_stream`` delegate to the engine
(prefill, then the decode loop with every token on the device, one
transfer a call or a chunk).  ``generate_python_loop`` is the per-token
baseline: the same prefill and decode steps, but each sampled token is
fetched to the host before the next step, so it makes one transfer a
token.  It draws from its ``torch.Generator`` in the engine's order, so
both give the same tokens for a seed, greedy or sampled.  All three take
``extra_inputs`` as the engine does (an encoder-decoder's "frames", a
VLM's "image_embeds", whose rows put the first decode position past them).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.serve.engine import (  # noqa: F401  (re-exported, as upstream)
    DecodeEngine,
    SamplerConfig,
    decode_logits,
    sample_token,
)


def make_serve_step(cfg: ModelConfig):
    """``serve_step(params, tokens (B, 1), caches, pos) -> ((B, V) logits,
    caches)``: one new token against the KV cache, under the (B, V)
    next-token contract that prefill also keeps."""

    def serve_step(params, tokens, caches, pos):
        return decode_logits(params, tokens[:, 0], caches, pos, cfg)

    return serve_step


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    def prefill_step(params, batch):
        return api.prefill(params, batch, cfg, cache_len)

    return prefill_step


class BatchedServer:
    """Prefill a batch of equal-length prompts, then decode them in
    lockstep.  ``device`` defaults to the CUDA device; the params must
    already live there."""

    def __init__(self, params, cfg: ModelConfig, max_len: int, device=None):
        self.params, self.cfg, self.max_len = params, cfg, max_len
        self.engine = DecodeEngine(params, cfg, max_len, device=device)
        self.device = self.engine.device
        self._prefill = make_prefill_step(cfg, max_len)
        self._decode = make_serve_step(cfg)
        # device->host transfers of generate_python_loop (one a token)
        self.host_transfers = 0

    def generate(self, prompts, scfg: Optional[SamplerConfig] = None,
                 extra_inputs: Optional[dict] = None, seed: int = 0) -> np.ndarray:
        return self.engine.generate(prompts, scfg, extra_inputs, seed)

    def generate_stream(self, prompts, scfg: Optional[SamplerConfig] = None,
                        extra_inputs: Optional[dict] = None, seed: int = 0, chunk: int = 8):
        return self.engine.generate_stream(prompts, scfg, extra_inputs, seed, chunk)

    def generate_python_loop(self, prompts, scfg: Optional[SamplerConfig] = None,
                             extra_inputs: Optional[dict] = None,
                             seed: int = 0) -> np.ndarray:
        """(B, max_new_tokens) int32, fetching every token to the host
        before the next decode step: the baseline the engine is measured
        against.  Same tokens as :meth:`generate` for a seed."""
        scfg = SamplerConfig() if scfg is None else scfg
        if scfg.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {scfg.max_new_tokens}")
        batch, off, _, gen = self.engine._setup(prompts, scfg, seed, extra_inputs)
        s = batch["tokens"].shape[1] + off
        logits, caches = self._prefill(self.params, batch)
        out = []
        for i in range(scfg.max_new_tokens):
            tok = sample_token(gen, logits, scfg)
            self.host_transfers += 1
            out.append(tok.cpu().numpy())  # the per-token host sync
            if i + 1 == scfg.max_new_tokens:
                break
            logits, caches = self._decode(self.params, tok[:, None], caches, s + i)
        return np.stack(out, axis=1)
