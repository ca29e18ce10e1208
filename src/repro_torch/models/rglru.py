"""Port of ``repro.models.rglru``: the RG-LRU recurrent block
(RecurrentGemma / Griffin).

Temporal mixing block: two input linears (gate branch with GELU,
recurrence branch with a short depthwise conv), the Real-Gated LRU
diagonal recurrence, and an output linear.  Training and multi-token
chunks run the recurrence as a log-depth scan over the sequence
(:func:`_assoc_scan`: upstream's ``jax.lax.associative_scan`` of the same
combine, here by doubling steps); decode keeps a constant-size hidden
state.  The scan sums in another order than XLA's: outputs agree with
upstream's within f32 rounding, not bit for bit.

Quantization: the three projections are BitLinear in quantized modes;
the RG-LRU gates (``wa``, ``wi``) and Lambda stay FP (plain f32 products:
they parameterize a recurrence decay where sign-binarization is
degenerate).  Upstream's ``shard_hint`` calls have no counterpart: the
port serves one device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.bitlinear import bitlinear, init_linear
from repro_torch.models.ssm import _causal_conv, _f32, softplus

Tensor = torch.Tensor


def init_rglru_block(gen: torch.Generator, cfg: ModelConfig, lead: tuple = (), device=None):
    """One block's parameters, leaf for leaf upstream's (``lead`` prepends
    the layer stack): ``wx``, ``wy`` (d -> W), ``wout`` (W -> d), the
    gates ``wa``, ``wi`` (W -> W), each ``{"w"}``; ``lam`` (W,) with
    sigmoid(lam)^c in [0.9, 0.999]; ``conv_w`` (k, W) and ``conv_b``
    (W,)."""
    d = cfg.d_model
    w = cfg.lru_width or d
    params = {
        "wx": init_linear(gen, d, w, lead, device),
        "wy": init_linear(gen, d, w, lead, device),
        "wout": init_linear(gen, w, d, lead, device),
        "wa": init_linear(gen, w, w, lead, device),
        "wi": init_linear(gen, w, w, lead, device),
    }
    u = 0.9 + torch.rand(lead + (w,), generator=gen, device=device) * (0.999 - 0.9)
    a_target = u ** (1.0 / cfg.rglru_c)
    params["lam"] = torch.log(a_target) - torch.log1p(-a_target)  # logit
    params["conv_w"] = torch.randn(lead + (cfg.conv_kernel, w), generator=gen,
                                   device=device) * 0.02
    params["conv_b"] = torch.zeros(lead + (w,), device=device)
    return params


def _rglru_gates(params, x: Tensor, cfg: ModelConfig):
    """log_a (B, S, W) and the gated input, in f32 (f64 stays f64)."""
    x32 = _f32(x)
    r = torch.sigmoid(x32 @ params["wa"]["w"].to(x32.dtype))
    i = torch.sigmoid(x32 @ params["wi"]["w"].to(x32.dtype))
    # log a_t = -c * softplus(-Lambda) * r_t   (a = sigmoid(Lambda))
    log_a = -cfg.rglru_c * softplus(-params["lam"].to(x32.dtype))[None, None] * r
    a_sq = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a_sq, 1e-12)) * (i * x32)
    return log_a, gated


def _assoc_scan(log_a: Tensor, b: Tensor) -> Tensor:
    """h_t = exp(log_a_t) * h_{t-1} + b_t along axis 1, h_0 = 0: the
    inclusive scan of upstream's combine ((la_l, b_l), (la_r, b_r)) ->
    (la_l + la_r, exp(la_r) * b_l + b_r) by doubling steps, log2(S) of
    them, each over the whole sequence (no Python loop over S)."""
    s, d = log_a.shape[1], 1
    while d < s:
        la_r = log_a[:, d:]
        b = torch.cat([b[:, :d], torch.exp(la_r) * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < s:  # the last step needs no decays
            log_a = torch.cat([log_a[:, :d], log_a[:, :-d] + la_r], dim=1)
        d *= 2
    return b


def _gate(params, x: Tensor, cfg: ModelConfig) -> Tensor:
    return F.gelu(bitlinear(params["wy"], x, cfg.quant), approximate="tanh")


def rglru_block(params, x: Tensor, cfg: ModelConfig, return_cache: bool = False,
                cache: dict | None = None):
    """Multi-token recurrent mixing chunk.  x: (B, S, D) -> (B, S, D).

    ``cache`` (hidden state + conv tail from :func:`init_rglru_cache` or an
    earlier chunk) resumes the recurrence mid-stream: the initial state
    enters as ``exp(cumsum log_a) * h0`` on top of the zero-state scan,
    the closed form of carrying ``h0`` through the gated recurrence.
    ``cache=None`` is the from-scratch training / prefill path.  Returns
    y, or (y, {"h": last state, "conv": tail}) with ``return_cache``; the
    cache passed in is not written."""
    gate = _gate(params, x, cfg)
    u = bitlinear(params["wx"], x, cfg.quant)
    k = params["conv_w"].shape[-2]
    conv = _causal_conv(u, params["conv_w"].to(u.dtype), params["conv_b"].to(u.dtype),
                        prev=None if cache is None else cache["conv"])
    log_a, gated = _rglru_gates(params, conv, cfg)
    h = _assoc_scan(log_a, gated)
    if cache is not None:
        h = h + torch.exp(torch.cumsum(log_a, dim=1)) * cache["h"][:, None, :]
    y = bitlinear(params["wout"], h.to(x.dtype) * gate, cfg.quant)
    if not return_cache:
        return y
    if cache is None:
        tail = u[:, u.shape[1] - (k - 1):, :]
    else:  # a short chunk keeps part of the previous tail
        tail = torch.cat([cache["conv"], u.to(cache["conv"].dtype)], dim=1)[:, -(k - 1):]
    return y, {"h": h[:, -1], "conv": tail}


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, lead: tuple = (), device=None):
    """{"h": (..., B, W) f32, "conv": (..., B, k-1, W) in ``dtype``},
    zeros; ``lead`` prepends the layer stack."""
    w = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros(lead + (batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.conv_kernel - 1, w), dtype=dtype,
                            device=device),
    }


def rglru_decode(params, x: Tensor, cache: dict, cfg: ModelConfig):
    """One-step recurrent mixing.  x: (B, 1, D).  Returns (y, new_cache);
    the cache passed in is not written."""
    gate = _gate(params, x, cfg)
    u = bitlinear(params["wx"], x, cfg.quant)  # (B, 1, W)
    win = torch.cat([cache["conv"], u.to(cache["conv"].dtype)], dim=1)
    # the conv over the rolling window, in the chunk path's order of adds
    w, winx = params["conv_w"].to(x.dtype), win.to(x.dtype)
    conv = torch.zeros_like(winx[:, 0])
    for i in range(w.shape[0]):
        conv = conv + winx[:, i] * w[i][None]
    conv = (conv + params["conv_b"].to(x.dtype)[None])[:, None]
    log_a, gated = _rglru_gates(params, conv, cfg)
    h = torch.exp(log_a[:, 0]) * cache["h"] + gated[:, 0]
    y = bitlinear(params["wout"], h[:, None].to(x.dtype) * gate, cfg.quant)
    return y, {"h": h, "conv": win[:, 1:]}
