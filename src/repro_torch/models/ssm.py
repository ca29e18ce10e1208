"""Port of ``repro.models.ssm``: the Mamba-2 (SSD, state-space duality)
block of the attention-free architecture.

Chunked SSD as in the Mamba-2 paper's minimal reference: within-chunk
terms are dense matmuls ("attention-like"), cross-chunk terms a short
recurrence over chunk states (upstream's ``lax.scan``, here a loop over
the chunks).  The contraction order is chosen here rather than left to
``einsum``: C·Bᵀ per group first, so no (B, nc, cs, cs, H, N) tensor is
built.  Sums run in another order than XLA's: outputs agree with
upstream's within f32 rounding, not bit for bit.

pQuant adaptation: Mamba-2 has no FFN, so the paper's decoupled layer
applies to the in/out projections through ``core.decoupled.
decoupled_proj`` (1-bit dominant + r-wide 8-bit bottleneck branch).
Conv/SSD/gate parameters (<2% of the total) stay FP.  Upstream's
``shard_hint`` calls have no counterpart: the port serves one device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.bitlinear import bitlinear, init_linear, init_rmsnorm, rmsnorm
from repro_torch.core.decoupled import decoupled_proj, init_decoupled_proj
from repro_torch.core.routing import RouterConfig

Tensor = torch.Tensor


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_headdim
    conv_dim = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
    proj_out = 2 * d_in + 2 * cfg.ssm_groups * cfg.ssm_state + nheads
    return d_in, nheads, conv_dim, proj_out


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig, lead: tuple = (), device=None):
    """One block's parameters, leaf for leaf upstream's (``lead`` prepends
    the layer stack): the in/out projections (decoupled under pQuant, else
    BitLinear), the depthwise conv over [x, B, C], the per-head SSD
    parameters ``A_log``, ``D``, ``dt_bias`` and the gated RMSNorm."""
    d = cfg.d_model
    d_in, nheads, conv_dim, proj_out = _dims(cfg)
    q = cfg.quant
    params = {}
    if q.mode == "pquant":
        kw = dict(num_experts=q.num_experts, lead=lead, device=device,
                  alpha_init=q.alpha_init, beta_init=q.beta_init)
        params["in_proj"] = init_decoupled_proj(gen, d, proj_out, q.r, **kw)
        params["out_proj"] = init_decoupled_proj(gen, d_in, d, q.r, **kw)
    else:
        params["in_proj"] = init_linear(gen, d, proj_out, lead, device)
        params["out_proj"] = init_linear(gen, d_in, d, lead, device)

    def uniform(lo, hi):
        u = torch.rand(lead + (nheads,), generator=gen, device=device)
        return lo + u * (hi - lo)

    params["conv_w"] = torch.randn(lead + (cfg.conv_kernel, conv_dim), generator=gen,
                                   device=device) * 0.02
    params["conv_b"] = torch.zeros(lead + (conv_dim,), device=device)
    params["A_log"] = torch.log(uniform(1.0, 16.0))
    params["D"] = torch.ones(lead + (nheads,), device=device)
    # dt bias: softplus^-1 of dt in [1e-3, 1e-1]
    dt = torch.exp(uniform(math.log(1e-3), math.log(0.1)))
    params["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
    params["gate_norm"] = init_rmsnorm(d_in, lead, device)
    return params


def _f32(x: Tensor) -> Tensor:
    """Upstream's ``astype(float32)`` for the SSD's inputs, except that f64
    stays f64 (an f64 run of the model is a reference for f32 noise)."""
    return x if x.dtype == torch.float64 else x.float()


def softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    with no threshold (``F.softplus`` returns x above 20)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def _segsum(a: Tensor) -> Tensor:
    """a: (..., cs).  Returns (..., cs, cs) with S[i, j] = sum_{k=j+1..i} a_k
    on the lower triangle (i >= j), -inf above (``exp`` gives exact zeros)."""
    cs = a.shape[-1]
    ac = torch.cumsum(a, dim=-1)
    diff = ac[..., :, None] - ac[..., None, :]
    lower = torch.ones((cs, cs), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~lower, -math.inf)


def ssd_chunked(x: Tensor, dta: Tensor, b_mat: Tensor, c_mat: Tensor, chunk: int,
                initial_state: Tensor | None = None):
    """Chunked SSD.  x (B, L, H, P) already multiplied by dt; dta (B, L, H)
    = dt * A (negative log-decays); b_mat, c_mat (B, L, G, N);
    initial_state (B, H, P, N).  Returns (y (B, L, H, P), final_state
    (B, H, P, N))."""
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    l_orig = l
    if l % chunk:
        # pad with identity steps: x = 0 contributes nothing, dta = 0 -> decay 1
        pad = chunk - l % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dta = F.pad(dta, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
        l += pad
    nc, rep = l // chunk, h // g

    # heads as a batch axis: (B, nc, H, cs, .); groups (B, nc, G, cs, N)
    xc = x.reshape(bsz, nc, chunk, h, p).permute(0, 1, 3, 2, 4)
    ac = dta.reshape(bsz, nc, chunk, h).permute(0, 1, 3, 2)  # (B, nc, H, cs)
    bc = b_mat.reshape(bsz, nc, chunk, g, n).permute(0, 1, 3, 2, 4)
    cc = c_mat.reshape(bsz, nc, chunk, g, n).permute(0, 1, 3, 2, 4)

    def heads(t):  # group -> its rep heads (upstream's jnp.repeat; a copy when rep > 1)
        t = t[:, :, :, None].expand(-1, -1, -1, rep, *t.shape[3:])
        return t.reshape(t.shape[:2] + (h,) + t.shape[4:])

    a_cum = torch.cumsum(ac, dim=-1)  # (B, nc, H, cs)

    # 1. within-chunk (diagonal blocks): (C Bᵀ ∘ L) x
    scores = heads(cc @ bc.transpose(-1, -2)) * torch.exp(_segsum(ac))
    y_diag = scores @ xc  # (B, nc, H, cs, P)

    # 2. chunk states (decayed contribution of each chunk to its last step)
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (B, nc, H, cs)
    states = (xc * decay_states[..., None]).transpose(-1, -2) @ heads(bc)  # (B, nc, H, P, N)

    # 3. inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(a_cum[..., -1])  # (B, nc, H)
    carry = (initial_state if initial_state is not None
             else torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device))
    entering = []  # the state entering each chunk
    for c in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(entering, dim=1)  # (B, nc, H, P, N)

    # 4. cross-chunk output
    y_off = (heads(cc) @ prev_states.transpose(-1, -2)) * torch.exp(a_cum)[..., None]

    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(bsz, l, h, p)[:, :l_orig]
    return y, carry


def _causal_conv(x: Tensor, w: Tensor, b: Tensor, prev: Tensor | None = None) -> Tensor:
    """Depthwise causal conv: x (B, L, C), w (K, C).  ``prev`` (B, K-1, C)
    seeds the window with the cached tail of the preceding tokens;
    ``None`` zero-pads, bitwise the same as a zero tail."""
    k, t = w.shape[0], x.shape[1]
    if prev is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([prev.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    for i in range(k):  # K is 4: unrolled adds, upstream's order
        out = out + xp[:, i:i + t, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _split_proj(zxbcdt: Tensor, cfg: ModelConfig):
    d_in, _, conv_dim, _ = _dims(cfg)
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + conv_dim],
            zxbcdt[..., d_in + conv_dim:])


def _apply_proj(params, x: Tensor, cfg: ModelConfig):
    """A projection of the block: the decoupled one under pQuant (routed,
    top-1, with N > 1 experts), else BitLinear.  Returns (y, aux)."""
    if cfg.quant.mode == "pquant":
        n = cfg.quant.num_experts
        rcfg = RouterConfig(num_experts=n, top_k=1) if n > 1 else None
        return decoupled_proj(params, x, cfg.quant, rcfg)
    return (bitlinear(params, x, cfg.quant),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _apply_in_proj(params, x: Tensor, cfg: ModelConfig):
    return _apply_proj(params["in_proj"], x, cfg)


def _apply_out_proj(params, y: Tensor, cfg: ModelConfig):
    return _apply_proj(params["out_proj"], y, cfg)


def mamba_block(params, x: Tensor, cfg: ModelConfig, return_cache: bool = False,
                cache: dict | None = None):
    """Multi-token Mamba-2 mixing chunk.  x: (B, S, D).

    ``cache`` (conv tail + SSD state from :func:`init_mamba_cache` or an
    earlier chunk) resumes the recurrence mid-stream; ``None`` is the
    from-scratch prefill (bitwise a zero cache).  Returns (y, aux), or
    (y, aux, {"conv": tail, "state": final state}) with ``return_cache``;
    the cache passed in is not written."""
    bsz, s, _ = x.shape
    d_in, nheads, _, _ = _dims(cfg)
    gn = cfg.ssm_groups * cfg.ssm_state

    zxbcdt, aux_in = _apply_in_proj(params, x, cfg)
    z, xbc_raw, dt = _split_proj(zxbcdt, cfg)
    xbc = F.silu(_causal_conv(xbc_raw, params["conv_w"].to(x.dtype),
                              params["conv_b"].to(x.dtype),
                              prev=None if cache is None else cache["conv"]))
    xs = xbc[..., :d_in]
    b_mat = xbc[..., d_in:d_in + gn].reshape(bsz, s, cfg.ssm_groups, cfg.ssm_state)
    c_mat = xbc[..., d_in + gn:].reshape(bsz, s, cfg.ssm_groups, cfg.ssm_state)

    dt = softplus(_f32(dt) + params["dt_bias"][None, None])
    a = -torch.exp(params["A_log"])[None, None]  # (1, 1, H)
    xh = xs.reshape(bsz, s, nheads, cfg.ssm_headdim)

    y, final_state = ssd_chunked(
        _f32(xh) * dt[..., None], dt * a, _f32(b_mat), _f32(c_mat), cfg.ssm_chunk,
        initial_state=None if cache is None else cache["state"],
    )
    y = y + params["D"][None, None, :, None] * _f32(xh)
    y = y.reshape(bsz, s, d_in).to(x.dtype)
    y = rmsnorm(params["gate_norm"], y * F.silu(z))
    out, aux_out = _apply_out_proj(params, y, cfg)
    if not return_cache:
        return out, aux_in + aux_out
    k = cfg.conv_kernel
    if cache is None:
        tail = xbc_raw[:, s - (k - 1):, :]
    else:  # a short chunk keeps part of the previous tail
        tail = torch.cat([cache["conv"], xbc_raw.to(cache["conv"].dtype)], dim=1)[:, -(k - 1):]
    return out, aux_in + aux_out, {"conv": tail, "state": final_state}


# ---------------------------------------------------------------------------
# Decode (single step, constant-size state)
# ---------------------------------------------------------------------------


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, lead: tuple = (), device=None):
    """{"conv": (..., B, K-1, conv_dim) in ``dtype``, "state": (..., B, H,
    P, N) f32}, zeros; ``lead`` prepends the layer stack."""
    _, nheads, conv_dim, _ = _dims(cfg)
    return {
        "conv": torch.zeros(lead + (batch, cfg.conv_kernel - 1, conv_dim), dtype=dtype,
                            device=device),
        "state": torch.zeros(lead + (batch, nheads, cfg.ssm_headdim, cfg.ssm_state),
                             dtype=torch.float32, device=device),
    }


def mamba_decode(params, x: Tensor, cache: dict, cfg: ModelConfig):
    """x: (B, 1, D).  Returns (y, new_cache); the cache passed in is not
    written."""
    bsz = x.shape[0]
    d_in, nheads, _, _ = _dims(cfg)
    gn = cfg.ssm_groups * cfg.ssm_state

    zxbcdt, _ = _apply_in_proj(params, x, cfg)
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    xbc = xbc[:, 0]  # (B, conv_dim)

    # conv over the rolling window, the chunk path's order of adds
    win = torch.cat([cache["conv"], xbc[:, None, :].to(cache["conv"].dtype)], dim=1)
    w, winx = params["conv_w"].to(x.dtype), win.to(x.dtype)
    conv_out = torch.zeros_like(xbc)
    for i in range(w.shape[0]):
        conv_out = conv_out + winx[:, i] * w[i][None]
    xbc_t = F.silu(conv_out + params["conv_b"].to(x.dtype))
    new_conv = win[:, 1:]

    xs = xbc_t[..., :d_in].reshape(bsz, nheads, cfg.ssm_headdim)
    b_vec = xbc_t[..., d_in:d_in + gn].reshape(bsz, cfg.ssm_groups, cfg.ssm_state)
    c_vec = xbc_t[..., d_in + gn:].reshape(bsz, cfg.ssm_groups, cfg.ssm_state)
    rep = nheads // cfg.ssm_groups
    b_h = _f32(torch.repeat_interleave(b_vec, rep, dim=1))  # (B, H, N)
    c_h = _f32(torch.repeat_interleave(c_vec, rep, dim=1))

    dt = softplus(_f32(dt[:, 0]) + params["dt_bias"][None])  # (B, H)
    a = -torch.exp(params["A_log"])[None]  # (1, H)
    da = torch.exp(dt * a)  # (B, H)

    xs32 = _f32(xs)
    new_state = (cache["state"] * da[..., None, None]
                 + (xs32 * dt[..., None])[..., None] * b_h[:, :, None, :])
    y = (new_state @ c_h[..., None])[..., 0]  # (B, H, P)
    y = y + params["D"][None, :, None] * xs32
    y = y.reshape(bsz, 1, d_in).to(x.dtype)
    y = rmsnorm(params["gate_norm"], y * F.silu(z))
    out, _ = _apply_out_proj(params, y, cfg)
    return out, {"conv": new_conv, "state": new_state}
