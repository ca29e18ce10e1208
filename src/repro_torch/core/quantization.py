"""Port of ``repro.core.quantization``: the quantization primitives of
pQuant (paper §3.1, Eq. 3-10).

The fake-quant quantizers return values in the input's float dtype,
restricted to the quantization grid, and carry a straight-through
estimator (:func:`ste`) so that gradients reach the latent weights: the
training forward of ``repro_torch.train.trainer``.  Their clips go through
:func:`clip`, whose gradient at a rail is JAX's (half of it passes), and
their scales take |x| with JAX's gradient at 0 (:func:`_abs`).  The
runtime integer path (:func:`quantize_act_int8`, ``repro_torch.core.packing``
and ``repro_torch.kernels``) takes no gradient.

Rounding is half to even everywhere (``torch.round`` shares it with
``jnp.round``), and every activation scale is computed in float32, so the
integer codes equal the JAX package's for equal inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import torch

from repro_torch.telemetry import probes

Tensor = torch.Tensor

# folded into the scale denominators, as upstream
EPS = 1e-5

INT8_QMAX = 127.0


def fdiv(a, b) -> Tensor:
    """``a / b`` rounded once, as IEEE division and ``jnp`` round it.  A
    Python float on either side becomes a tensor first: in PyTorch
    ``float / tensor`` is ``reciprocal(tensor) * float`` (two roundings),
    and ``tensor / float`` on CUDA multiplies by the float's reciprocal,
    while a tensor divided by a tensor divides.  Every scale that meets an
    int8 rounding or a kernel epilogue goes through here."""
    if not torch.is_tensor(a):
        a = torch.full_like(b, a)
    elif not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return a / b


# ---------------------------------------------------------------------------
# Straight-through estimator
# ---------------------------------------------------------------------------


class _STE(torch.autograd.Function):
    """Forward: ``x_quant`` itself.  Backward: the gradient goes to ``x``
    unchanged and none to ``x_quant`` (upstream's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x, x_quant):
        return x_quant

    @staticmethod
    def backward(ctx, g):
        return g, None


def ste(x: Tensor, x_quant: Tensor) -> Tensor:
    """``x_quant`` in the forward pass, d/dx = identity in the backward
    (paper Appendix B.1).  The forward value is ``x_quant`` bit for bit,
    which ``x + (x_quant - x).detach()`` is not."""
    return _STE.apply(x, x_quant)


def ste_round(x: Tensor) -> Tensor:
    """round() (half to even) with identity gradient."""
    return ste(x, torch.round(x))


def ste_sign(x: Tensor) -> Tensor:
    """sign() on {-1, +1} with identity gradient: 0 maps to +1 (the paper's
    Eq. 4 defines only +-1)."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return ste(x, torch.where(x >= 0, one, -one))


class _Abs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _abs(x: Tensor) -> Tensor:
    """``torch.abs`` with ``jnp.abs``'s gradient, +1 at 0 (``torch.abs``
    gives 0 there, which drops a zero weight's share of an AbsMean scale
    and a zero row's share of its AbsMax)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Abs.apply(x)
    return torch.abs(x)


def clip(x: Tensor, lo: float, hi: float) -> Tensor:
    """``jnp.clip(x, lo, hi)`` with its gradient: where x equals a bound,
    half the gradient passes (``torch.clamp`` passes all of it, which moves
    every +-1 code of a ternary weight)."""
    lo_t = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi_t = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


# ---------------------------------------------------------------------------
# Weight quantizers
# ---------------------------------------------------------------------------


def binarize_weights(w: Tensor) -> tuple[Tensor, Tensor]:
    """1-bit weight fake-quant (paper Eq. 3-6): ``(sign(W - mean W) * lam,
    lam)`` with the per-tensor AbsMean ``lam = mean|W| + eps``."""
    mu = torch.mean(w)
    lam = torch.mean(_abs(w)) + EPS
    return ste_sign(w - mu) * lam, lam


def binarize_weights_grouped(w: Tensor, group_size: int) -> tuple[Tensor, Tensor]:
    """Group-wise 1-bit quantization along the last axis (paper §4.6)."""
    *lead, k = w.shape
    if k % group_size:
        raise ValueError(f"{k=} not divisible by {group_size=}")
    wg = w.reshape(*lead, k // group_size, group_size)
    mu = torch.mean(wg, dim=-1, keepdim=True)
    lam = torch.mean(_abs(wg), dim=-1, keepdim=True) + EPS
    return (ste_sign(wg - mu) * lam).reshape(w.shape), lam.squeeze(-1)


def binarize_weights_channelwise(w: Tensor) -> tuple[Tensor, Tensor]:
    """Channel-wise (per output column) 1-bit quantization (paper §4.6)."""
    mu = torch.mean(w, dim=0, keepdim=True)
    lam = torch.mean(_abs(w), dim=0, keepdim=True) + EPS
    return ste_sign(w - mu) * lam, lam.squeeze(0)


def ternarize_weights(w: Tensor) -> tuple[Tensor, Tensor]:
    """BitNet-1.58 ternary AbsMean quantization (baseline)."""
    lam = torch.mean(_abs(w)) + EPS
    q = clip(ste_round(w / lam), -1.0, 1.0)
    return q * lam, lam


def quantize_weights_int8(w: Tensor, axis: Optional[int] = None) -> tuple[Tensor, Tensor]:
    """INT8 AbsMax weight fake-quant (per tensor, or per ``axis``)."""
    if axis is None:
        amax = torch.amax(_abs(w))
    else:
        amax = torch.amax(_abs(w), dim=axis, keepdim=True)
    scale = fdiv(INT8_QMAX, amax + EPS)
    q = clip(ste_round(w * scale), -INT8_QMAX, INT8_QMAX)
    return q / scale, scale


def binarize_weights_stacked(w: Tensor, n_batch_axes: int = 1) -> tuple[Tensor, Tensor]:
    """Per-slice 1-bit quantization of stacked (e.g. per-expert) weights
    (N..., d_in, d_out) with ``n_batch_axes`` leading stack axes: mu and
    lambda over every later axis, so each slice keeps its own scale."""
    red = tuple(range(n_batch_axes, w.ndim))
    mu = torch.mean(w, dim=red, keepdim=True)
    lam = torch.mean(_abs(w), dim=red, keepdim=True) + EPS
    return ste_sign(w - mu) * lam, lam


def ternarize_weights_stacked(w: Tensor, n_batch_axes: int = 1) -> tuple[Tensor, Tensor]:
    """Per-slice ternary AbsMean quantization of stacked weights."""
    red = tuple(range(n_batch_axes, w.ndim))
    lam = torch.mean(_abs(w), dim=red, keepdim=True) + EPS
    q = clip(ste_round(w / lam), -1.0, 1.0)
    return q * lam, lam


def quantize_weights_int8_stacked(w, n_batch_axes: int = 1) -> tuple[Tensor, Tensor]:
    """Per-slice INT8 AbsMax for stacked weights.  Accepts the serving dict
    layout ({"q": int8, "scale"}), which it dequantizes directly."""
    if isinstance(w, dict):
        return _dequant_stored(w), w["scale"]
    red = tuple(range(n_batch_axes, w.ndim))
    amax = torch.amax(_abs(w), dim=red, keepdim=True)
    scale = fdiv(INT8_QMAX, amax + EPS)
    q = clip(ste_round(w * scale), -INT8_QMAX, INT8_QMAX)
    return q / scale, scale


# ---------------------------------------------------------------------------
# Activation quantizer
# ---------------------------------------------------------------------------


def act_scale_int8(x: Tensor) -> Tensor:
    """Per-token AbsMax INT8 scale ``127 / (max|x| + eps)`` along the last
    axis, in float32 — the one formula shared by the fake-quant path, the
    runtime integer path and the kernels' prologues."""
    amax = torch.amax(_abs(x.float()), dim=-1, keepdim=True)
    return fdiv(INT8_QMAX, amax + EPS)


def quantize_activations_int8(x: Tensor) -> tuple[Tensor, Tensor]:
    """Per-token AbsMax INT8 activation fake-quant (paper Eq. 7-9):
    ``(RoundClip(x * gamma) / gamma, gamma)`` in the input dtype."""
    gamma = act_scale_int8(x)
    q = clip(ste_round(x.float() * gamma), -INT8_QMAX, INT8_QMAX)
    if probes.active():
        tap_clip_act(q)
    return (q / gamma).to(x.dtype), gamma


def tap_clip_act(q: Tensor) -> None:
    """QAT probe: the share of the codes ``q`` on the INT8 rails, weighted
    by their count so that ``probes.summaries`` gives the rate over every
    act-quant site (``qat_clip_act``)."""
    q = q.detach()
    probes.add_mean("clip_act", torch.mean((torch.abs(q) >= INT8_QMAX).float()),
                    float(q.numel()))


def quantize_act_int8(x: Tensor) -> tuple[Tensor, Tensor]:
    """Per-token AbsMax INT8 on the runtime integer path: the int8 tensor
    and a flat per-row gamma for the kernel epilogues (no gradient: the
    kernels' plain versions call it)."""
    gamma = act_scale_int8(x)
    q = torch.clamp(torch.round(x.float() * gamma), -INT8_QMAX, INT8_QMAX)
    return q.to(torch.int8), gamma[..., 0]


# ---------------------------------------------------------------------------
# Quantization mode config
# ---------------------------------------------------------------------------

QuantMode = Literal["none", "bitnet", "bitnet158", "pquant"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Selects the quantization scheme for a whole model (field for field
    upstream's ``QuantConfig``; see its docstring for each field)."""

    mode: QuantMode = "pquant"
    r: int = 128
    num_experts: int = 1
    alpha_init: float = 2.0
    beta_init: float = 0.2
    act_bits: int = 8
    weight_scheme: Literal["tensor", "channel", "group"] = "tensor"
    group_size: int = 64
    native_mix_frac: float = 0.0
    qgather: bool = False

    @property
    def quantize_acts(self) -> bool:
        return self.mode != "none"

    def binarize(self, w: Tensor) -> tuple[Tensor, Tensor]:
        if self.weight_scheme == "channel":
            return binarize_weights_channelwise(w)
        if self.weight_scheme == "group":
            return binarize_weights_grouped(w, self.group_size)
        return binarize_weights(w)


def _dequant_stored(w: dict) -> Tensor:
    """Dequantize a serving-format weight: {"q": int8, "scale"} or
    {"packed": uint8 (..., K//8, N), "scale"}.  Only paths without a packed
    kernel take this float fallback."""
    if "packed" in w:
        from repro_torch.core.packing import unpack_signs

        signs = unpack_signs(w["packed"], torch.int8)
        return signs.to(w["scale"].dtype) * w["scale"]
    return w["q"].to(w["scale"].dtype) * w["scale"]


def is_packed_1bit(w) -> bool:
    """True for the bit-packed 1-bit serving layout {"packed", "scale"}."""
    return isinstance(w, dict) and "packed" in w


def is_stored_int8(w) -> bool:
    """True for the INT8 serving layout {"q", "scale"}."""
    return isinstance(w, dict) and "q" in w


def fake_quant_linear_weights(w, cfg: QuantConfig) -> Tensor:
    """The configured backbone weight quantizer (1-bit or ternary), for a
    latent float tensor or the serving dict layout."""
    if isinstance(w, dict):
        return _dequant_stored(w)
    if cfg.mode == "none":
        return w
    if cfg.mode == "bitnet158":
        return ternarize_weights(w)[0]
    return cfg.binarize(w)[0]


def fake_quant_stacked(w, cfg: QuantConfig, n_batch_axes: int = 1) -> Tensor:
    """The backbone quantizer of stacked (per-expert) weights, per slice;
    a serving dict layout is dequantized."""
    if isinstance(w, dict):
        return _dequant_stored(w)
    if cfg.mode == "none":
        return w
    if cfg.mode == "bitnet158":
        return ternarize_weights_stacked(w, n_batch_axes)[0]
    return binarize_weights_stacked(w, n_batch_axes)[0]


def maybe_quant_acts(x: Tensor, cfg: QuantConfig) -> Tensor:
    if not cfg.quantize_acts:
        return x
    return quantize_activations_int8(x)[0]
