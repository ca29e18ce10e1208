"""Fused RMSNorm and per-token AbsMax INT8 quantization: the port of
``repro.kernels.rmsnorm_quant``.

``rmsnorm_quant`` launches the hand-written CUDA kernel of
``csrc/rmsnorm_quant.cu`` for a CUDA tensor and runs its plain PyTorch
version for a CPU tensor.  The two are not bit-exact: the kernel sums the
squares in another order than torch and its ``rsqrtf`` is not correctly
rounded, so gamma agrees to f32 rounding and a value that lands on a
rounding boundary may take the neighbouring int8 code.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantization import fdiv
from repro_torch.kernels import _cuda

Tensor = torch.Tensor

EPS = 1e-6

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, scale, q, gamma, in_dtype, m, d, eps, device, stream
    "rmsnorm_quant_launch": [_P] * 4 + [_I] * 3 + [ctypes.c_float, _I, _P],
}


def rmsnorm_quant_plain(x: Tensor, scale: Tensor, eps: float = EPS):
    """x (M, D) float, scale (D,) -> (q (M, D) int8, gamma (M,) f32):
    normed = x * rsqrt(mean(x^2) + eps) * scale in f32, then
    gamma = 127 / (max|normed| + 1e-5) and q = clip(round(normed * gamma))."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps) * scale.float()[None, :]
    amax = torch.amax(torch.abs(normed), dim=-1)
    gamma = fdiv(127.0, amax + 1e-5)
    q = torch.clamp(torch.round(normed * gamma[:, None]), -127, 127).to(torch.int8)
    return q, gamma


def rmsnorm_quant(x: Tensor, scale: Tensor, eps: float = EPS):
    """x: (M, D) float32 or bfloat16; scale: (D,) norm weight.
    Returns (q (M, D) int8, gamma (M,) f32)."""
    if x.device.type == "cpu":
        return rmsnorm_quant_plain(x, scale, eps)
    dev = _cuda.device_index(x)
    code = _cuda.float_code(x.dtype, "x")
    _cuda.on_device(x, x.dtype, dev, "x")
    _cuda.on_device(scale, torch.float32, dev, "scale")
    if x.ndim != 2 or x.shape[0] < 1 or scale.shape != (x.shape[1],):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, scale {tuple(scale.shape)}")
    m, d = x.shape
    q = torch.empty((m, d), dtype=torch.int8, device=x.device)
    gamma = torch.empty((m,), dtype=torch.float32, device=x.device)
    lib = _cuda.load("rmsnorm_quant", _SIGNATURES)
    err = lib.rmsnorm_quant_launch(
        x.data_ptr(), scale.data_ptr(), q.data_ptr(), gamma.data_ptr(), code, m, d, eps, dev,
        _cuda.stream_ptr(dev),
    )
    _cuda.check(err, "rmsnorm_quant")
    _cuda.LAUNCHES["rmsnorm_quant"] += 1
    return q, gamma
