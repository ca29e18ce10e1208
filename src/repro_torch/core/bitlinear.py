"""Port of ``repro.core.bitlinear``: the 1-bit linear layer used for all
MHA projections (paper §3.1), plus RMSNorm and the init helpers.

Training / latent weights run fake-quant ``quant_act(X) @ binarize(W)``;
packed serving weights ({"packed", "scale"}) run the true-integer W1A8
kernel tier through ``repro_torch.kernels.ops``.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import (
    QuantConfig,
    fake_quant_linear_weights,
    is_packed_1bit,
    maybe_quant_acts,
)

Tensor = torch.Tensor

_SQRT2 = 2.0**0.5


def truncated_normal(
    gen: torch.Generator, shape, lo: float = -3.0, hi: float = 3.0, device=None,
) -> Tensor:
    """Standard normal f32 samples truncated to [lo, hi], by inverting the
    CDF of uniforms drawn from ``gen`` (which must live on ``device``)."""
    cdf = lambda v: 0.5 * (1.0 + torch.erf(torch.tensor(v / _SQRT2)))  # noqa: E731
    a, b = float(cdf(lo)), float(cdf(hi))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    x = torch.erfinv(2.0 * (a + u * (b - a)) - 1.0) * _SQRT2
    return x.clamp_(lo, hi)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, lead: tuple = (), device=None):
    """Dense kernel init (truncated-normal fan-in, LLaMA-style); ``lead``
    prepends stack axes (layers)."""
    w = truncated_normal(gen, lead + (d_in, d_out), device=device) * d_in**-0.5
    return {"w": w}


def init_rmsnorm(d: int, lead: tuple = (), device=None):
    return {"scale": torch.ones(lead + (d,), dtype=torch.float32, device=device)}


def rmsnorm(params, x: Tensor, eps: float = 1e-6) -> Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dt)


def bitlinear(params, x: Tensor, cfg: QuantConfig, sublayer_norm=None) -> Tensor:
    """Apply a (possibly quantized) linear layer.

    sublayer_norm: optional RMSNorm params applied to the input before
    activation quantization (BitNet SubLN placement, paper Appendix B).
    """
    if sublayer_norm is not None:
        x = rmsnorm(sublayer_norm, x)
    w = params["w"]
    if is_packed_1bit(w):
        from repro_torch.kernels import ops  # deferred: kernels are serving-only

        return ops.bit_linear_infer(x, w["packed"], w["scale"], out_dtype=x.dtype)
    if cfg.mode == "none" and not isinstance(w, dict):
        return x @ w.to(x.dtype)
    xq = maybe_quant_acts(x, cfg)
    wq = fake_quant_linear_weights(w, cfg).to(x.dtype)
    return xq @ wq
