"""Port of ``repro.models.layers``: embeddings, rotary tables, the FFN
block dispatch and the training loss."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.bitlinear import init_rmsnorm, rmsnorm  # noqa: F401  (re-export)
from repro_torch.core.decoupled import decoupled_ffn, init_decoupled_ffn
from repro_torch.core.quantization import fdiv
from repro_torch.core.routing import RouterConfig

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, vocab: int, d_model: int, device=None):
    e = torch.randn((vocab, d_model), generator=gen, device=device) * (d_model**-0.5)
    return {"table": e}


def embed(params, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    """Token embeddings; the gemma family scales them by sqrt(d_model),
    rounded to the table's type first, as upstream."""
    x = params["table"][tokens]
    if "gemma" in cfg.name:
        x = x * torch.full((), cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    return x


def unembed(params, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Logits against the (tied or untied) table, soft-capped as
    ``c * tanh(logits / c)`` where ``cfg.logit_softcap`` is set."""
    logits = x @ params["table"].T.to(x.dtype)
    if cfg.logit_softcap > 0:
        c = torch.full((), cfg.logit_softcap, dtype=logits.dtype, device=logits.device)
        logits = c * torch.tanh(fdiv(logits, c))
    return logits


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rope_table(positions: Tensor, head_dim: int, theta: float) -> tuple[Tensor, Tensor]:
    """sin/cos tables for integer positions: (len(positions), head_dim/2)."""
    half = head_dim // 2
    exps = fdiv(torch.arange(half, dtype=torch.float32, device=positions.device), float(half))
    freqs = fdiv(1.0, torch.pow(theta, exps))
    angles = positions.float()[:, None] * freqs[None, :]
    return torch.sin(angles), torch.cos(angles)


def rotate(x: Tensor, sin: Tensor, cos: Tensor) -> Tensor:
    """Rotate-half RoPE of x (..., D) with sin/cos broadcastable to (..., D/2)."""
    sin, cos = sin.to(x.dtype), cos.to(x.dtype)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: Tensor, sin: Tensor, cos: Tensor) -> Tensor:
    """x: (B, S, H, D). sin/cos: (S, D/2). Rotate-half convention."""
    return rotate(x, sin[None, :, None, :], cos[None, :, None, :])


# ---------------------------------------------------------------------------
# FFN block (dense / fully quantized / pQuant-decoupled)
# ---------------------------------------------------------------------------


def init_ffn(gen: torch.Generator, cfg: ModelConfig, lead: tuple = (), device=None,
             d_ff: int | None = None):
    """FFN parameters of one layer (``lead`` prepends the layer stack):
    pquant mode builds the 1-bit branch of width ``d_ff`` (default
    ``cfg.d_ff``) and the r-wide 8-bit branch, other modes a single branch
    (r = 0)."""
    q = cfg.quant
    width = cfg.d_ff if d_ff is None else d_ff
    r = q.r if q.mode == "pquant" else 0
    n = q.num_experts if q.mode == "pquant" else 1
    return init_decoupled_ffn(
        gen, cfg.d_model, width, r, num_experts=n, glu=cfg.glu, lead=lead,
        device=device, alpha_init=q.alpha_init, beta_init=q.beta_init,
    )


def apply_ffn(params, x: Tensor, cfg: ModelConfig):
    """Returns (y, aux_loss); pquant with N > 1 routes its 8-bit branch
    top-1."""
    q = cfg.quant
    rcfg = None
    if q.mode == "pquant" and q.num_experts > 1:
        rcfg = RouterConfig(num_experts=q.num_experts, top_k=1)
    return decoupled_ffn(params, x, q, glu=cfg.glu, activation=cfg.activation,
                         router_cfg=rcfg)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy_loss(logits: Tensor, labels: Tensor, mask: Tensor | None = None,
                       z_weight: float = 1e-4):
    """Token-level CE with z-loss, in f32 whatever the logits' dtype.

    logits (B, S, V), labels (B, S) integer; mask (B, S) in {0, 1}.
    Returns (loss, nll): the (masked) means of nll + z_weight * lse**2 and
    of nll, over max(sum(mask), 1) tokens under a mask."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - true_logit
    z = z_weight * torch.square(lse)
    per_tok = nll + z
    if mask is None:
        return torch.mean(per_tok), torch.mean(nll)
    mask = mask.float()
    denom = torch.maximum(torch.sum(mask), torch.ones((), device=mask.device))
    return torch.sum(per_tok * mask) / denom, torch.sum(nll * mask) / denom
