"""Port of ``repro.serve.engine``: the lockstep decode engine, and the
batch-1 admission prefills of the continuous-batching engine
(``repro_torch.serve.scheduler``).

``DecodeEngine.generate`` runs prefill, then the decode loop, with every
token kept on the device: sampling runs on the card, the KV caches stay
resident (updated in place) and positions are host integers known in
advance, so nothing inside the loop waits for the device.  Exactly one
device->host transfer happens per ``generate`` call (``host_transfers``
counts them).  ``generate_stream`` is the chunked variant: one transfer per
chunk.  Upstream compiles the loop into one XLA program; here it is a
Python loop of eagerly launched kernels (CUDA graphs come later).

Greedy decoding (temperature 0) reproduces the JAX engine token for
token.  Sampled decoding draws from a ``torch.Generator`` seeded per call;
its bits differ from JAX's threefry, so sampled streams agree with the
JAX engine only in distribution.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.telemetry.tracing import annotate

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.8
    top_k: int = 40
    max_new_tokens: int = 32
    # tokens that end a sequence: ``generate`` still runs the full budget;
    # ``generate_stream`` exits its chunk loop once every sequence stopped
    stop_tokens: tuple[int, ...] = ()


def _hit_stop(tok: Tensor, stop: Optional[Tensor]) -> Tensor:
    """(B,) bool — did this step's token end its sequence?  ``stop`` is the
    device tensor of stop tokens (made once per call, before any work is
    queued: a host-to-device copy inside the loop would stall it)."""
    if stop is None:
        return torch.zeros(tok.shape, dtype=torch.bool, device=tok.device)
    return (tok[:, None] == stop[None, :]).any(dim=-1)


def sample_token(gen: Optional[torch.Generator], logits: Tensor, scfg: SamplerConfig) -> Tensor:
    """logits (B, V) -> (B,) int32, on the device.  Greedy at temperature 0;
    otherwise top-k then a Gumbel-max draw from ``gen`` (the categorical
    sampler upstream's ``jax.random.categorical`` also is)."""
    if scfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / scfg.temperature
    if 0 < scfg.top_k < logits.shape[-1]:
        kth = torch.topk(logits, scfg.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, -1e30, logits)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = u.clamp_(torch.finfo(torch.float32).tiny, 1.0)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1).to(torch.int32)


def decode_logits(params, tok: Tensor, caches, pos, cfg: ModelConfig):
    """One decode step under the (B, V) logits contract: tok (B,) int ->
    ((B, V) logits, caches)."""
    logits, caches = api.decode_step(params, tok[:, None], caches, pos, cfg)
    return logits[:, -1], caches


def _pack_first(logits: Tensor, gen: Optional[torch.Generator], scfg: SamplerConfig) -> Tensor:
    """Sample the first token of a batch-1 prefill and pack it with the
    quarantine bit (are the logits finite): ``[tok0, ok]`` (2,) int32, so one
    device-to-host fetch per admission carries both."""
    tok0 = sample_token(gen, logits, scfg)
    ok = torch.isfinite(logits).all(dim=-1)
    return torch.stack([tok0[0], ok[0].to(torch.int32)])


def _make_checked_prefill_fn(cfg: ModelConfig, cache_len: int, scfg: SamplerConfig):
    """Batch-1 admission prefill of the continuous-batching engine:
    ``fn(params, tokens (1, S), gen) -> ([tok0, ok], caches, pos0)``, the
    prefill and first sample of :meth:`DecodeEngine.generate` (same
    forward, same draw from ``gen``), so a request's stream is that
    call's."""

    def prefill(params, tokens: Tensor, gen):
        with annotate("serve/prefill_forward"):
            logits, caches = api.prefill(params, {"tokens": tokens}, cfg, cache_len)
        return _pack_first(logits, gen, scfg), caches, tokens.shape[1]

    return prefill


def _make_bucketed_prefill_fn(cfg: ModelConfig, cache_len: int, scfg: SamplerConfig):
    """Admission prefill of a prompt right-padded to a bucket length:
    ``fn(params, tokens (1, S_bucket), plen, gen) -> ([tok0, ok], caches,
    plen)`` reads the logits at position ``plen - 1`` (causal masking keeps
    every real position as an exact-length prefill computes it).  Upstream
    pads so that one compiled trace serves a whole bucket; the port keeps
    upstream's padding, and with it upstream's shapes."""

    def prefill(params, tokens: Tensor, plen: int, gen):
        with annotate("serve/prefill_forward"):
            logits, caches = api.prefill(params, {"tokens": tokens}, cfg, cache_len,
                                         last_pos=plen)
        return _pack_first(logits, gen, scfg), caches, plen

    return prefill


class DecodeEngine:
    """Fixed-batch generation engine over one parameter tree.

    ``device`` defaults to the CUDA device; the params must already live
    there (``repro_torch.convert`` / ``init_model(device=...)``)."""

    def __init__(self, params, cfg: ModelConfig, max_len: int, device=None):
        self.cfg, self.max_len = cfg, max_len
        self.device = resolve_device(device)
        self.params = params
        # device->host transfers performed (one per generate() call)
        self.host_transfers = 0

    def _fetch(self, x: Tensor) -> np.ndarray:
        self.host_transfers += 1
        return x.cpu().numpy()

    def _prefill(self, prompts: Tensor, scfg: SamplerConfig, gen):
        with annotate("serve/prefill_forward"):
            logits, caches = api.prefill(
                self.params, {"tokens": prompts}, self.cfg, self.max_len
            )
        return sample_token(gen, logits, scfg), caches, prompts.shape[1]

    def _decode(self, tok: Tensor, caches, pos: int, gen, length: int,
                scfg: SamplerConfig, stop, done: Tensor):
        """``length`` decode steps from tok at position pos: returns
        (tokens (B, length), tok, pos, done), all on the device."""
        out = []
        for _ in range(length):
            with annotate("serve/decode_step"):
                logits, caches = decode_logits(self.params, tok, caches, pos, self.cfg)
            with annotate("serve/sample"):
                tok = sample_token(gen, logits, scfg)
            done = done | _hit_stop(tok, stop)
            out.append(tok)
            pos += 1
        toks = torch.stack(out, dim=1) if out else tok.new_empty((tok.shape[0], 0))
        return toks, tok, pos, done

    def _setup(self, prompts, scfg: SamplerConfig, seed: int):
        """Everything a call sends to the device, before any work is queued:
        the prompts, the stop tokens and the sampling generator."""
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int64).to(self.device)
        stop = None
        if scfg.stop_tokens:
            stop = torch.tensor(scfg.stop_tokens, dtype=torch.int32).to(self.device)
        gen = None
        if scfg.temperature != 0.0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        return prompts, stop, gen

    @staticmethod
    def _check_budget(scfg: SamplerConfig) -> None:
        if scfg.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {scfg.max_new_tokens}")

    def generate(self, prompts, scfg: Optional[SamplerConfig] = None,
                 seed: int = 0) -> np.ndarray:
        """(B, max_new_tokens) int32 for (B, S) equal-length prompts — one
        device->host transfer in total."""
        scfg = SamplerConfig() if scfg is None else scfg
        self._check_budget(scfg)
        prompts, stop, gen = self._setup(prompts, scfg, seed)
        tok, caches, pos = self._prefill(prompts, scfg, gen)
        done = _hit_stop(tok, stop)
        rest, _, _, _ = self._decode(
            tok, caches, pos, gen, scfg.max_new_tokens - 1, scfg, stop, done
        )
        return self._fetch(torch.cat([tok[:, None], rest], dim=1))

    def generate_stream(self, prompts, scfg: Optional[SamplerConfig] = None,
                        seed: int = 0, chunk: int = 8) -> Iterator[np.ndarray]:
        """Chunked streaming: yields arrays whose concatenation equals
        ``generate``'s output, one host transfer per chunk.  The first yield
        carries the prefill-sampled token with the first decode chunk.  With
        ``scfg.stop_tokens`` the loop exits once every sequence has stopped;
        the done mask rides each chunk's transfer as one extra column."""
        scfg = SamplerConfig() if scfg is None else scfg
        if chunk <= 0:
            raise ValueError(f"chunk must be positive, got {chunk}")
        self._check_budget(scfg)
        prompts, stop, gen = self._setup(prompts, scfg, seed)
        tok, caches, pos = self._prefill(prompts, scfg, gen)
        done = _hit_stop(tok, stop)
        pending = tok[:, None]
        remaining = scfg.max_new_tokens - 1
        while remaining > 0:
            step = min(chunk, remaining)
            toks, tok, pos, done = self._decode(tok, caches, pos, gen, step, scfg, stop, done)
            packed = torch.cat([toks, done[:, None].to(toks.dtype)], dim=1)
            if pending is not None:  # device-side concat: one fetch per chunk
                packed = torch.cat([pending, packed], dim=1)
                pending = None
            fetched = self._fetch(packed)
            yield fetched[:, :-1]
            remaining -= step
            if scfg.stop_tokens and fetched[:, -1].all():
                return
        if pending is not None:  # max_new_tokens == 1: prefill sample only
            yield self._fetch(pending)
