"""Port of ``repro.core.packing``: bit-packing of 1-bit weights (paper
Appendix A).

Signs {-1, +1} are stored 8 per uint8 along the input-feature (K) axis.
Bit convention: bit b of byte k along K is the sign of weight 8k+b,
bit 1 -> +1, bit 0 -> -1 (little-endian within the byte).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quantization import fdiv

Tensor = torch.Tensor


def _bit_shifts(device) -> Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)


def pack_signs(signs: Tensor) -> Tensor:
    """Pack +-1 (or bool) signs along the K (second-to-last) axis:
    (..., K, N) -> (..., K//8, N) uint8.  K must be a multiple of 8."""
    *lead, k, n = signs.shape
    if k % 8:
        raise ValueError(f"K={k} must be a multiple of 8")
    bits = (signs > 0).to(torch.uint8).reshape(*lead, k // 8, 8, n)
    weights = torch.bitwise_left_shift(
        torch.ones((), dtype=torch.uint8, device=signs.device),
        _bit_shifts(signs.device),
    )[:, None]
    # distinct powers of two sum to at most 255: exact in uint8, and no
    # int64 copy of the bits (8x their bytes) as an integer sum would make
    return torch.sum(bits * weights, dim=-2, dtype=torch.uint8)


def unpack_signs(packed: Tensor, dtype=torch.int8) -> Tensor:
    """Inverse of :func:`pack_signs`: (..., K//8, N) uint8 -> (..., K, N) +-1."""
    *lead, kb, n = packed.shape
    shifts = _bit_shifts(packed.device)[:, None]
    bits = torch.bitwise_right_shift(packed[..., :, None, :], shifts) & 1
    signs = bits.to(torch.int8) * 2 - 1
    return signs.reshape(*lead, kb * 8, n).to(dtype)


@dataclasses.dataclass
class PackedBitWeight:
    """Inference export of one 1-bit linear layer: (K//8, N) uint8 sign bits,
    the per-tensor AbsMean scale and the original (K, N)."""

    packed: Tensor
    lam: Tensor
    shape: tuple[int, int]

    @property
    def nbytes(self) -> int:
        return self.packed.numel() + 4

    def dequantize(self, dtype=torch.float32) -> Tensor:
        return unpack_signs(self.packed, torch.int8).to(dtype) * self.lam.to(dtype)


def export_bit_weight(w: Tensor) -> PackedBitWeight:
    """Offline-quantize a latent weight to its packed inference form.
    ``lam`` is mean|w| here (no eps), as upstream; the serving export
    ``train.quantized_serving._binarize_export`` adds 1e-5."""
    mu = torch.mean(w)
    lam = torch.mean(torch.abs(w))
    signs = torch.where(w - mu >= 0, 1, -1).to(torch.int8)
    return PackedBitWeight(
        packed=pack_signs(signs), lam=lam.float(), shape=tuple(w.shape)
    )


@dataclasses.dataclass
class PackedInt8Weight:
    """Inference export of one INT8 (high-precision branch) weight."""

    q: Tensor  # int8, same shape as the latent weight
    scale: Tensor  # float32 scalar (per-tensor AbsMax quant multiplier)

    @property
    def nbytes(self) -> int:
        return self.q.numel() + 4

    def dequantize(self, dtype=torch.float32) -> Tensor:
        return self.q.to(dtype) / self.scale.to(dtype)


def export_int8_weight(w: Tensor) -> PackedInt8Weight:
    amax = torch.amax(torch.abs(w))
    scale = fdiv(127.0, amax + 1e-5)
    q = torch.clamp(torch.round(w * scale), -127, 127).to(torch.int8)
    return PackedInt8Weight(q=q, scale=scale.float())
