"""Fused RMSNorm and per-token AbsMax INT8 quantization: the port of
``repro.kernels.rmsnorm_quant``.

``rmsnorm_quant`` launches the hand-written CUDA kernel of
``csrc/rmsnorm_quant.cu`` for a CUDA tensor and runs its plain PyTorch
version for a CPU tensor.  The two are not bit-exact: the kernel sums the
squares in another order than torch and its ``rsqrtf`` is not correctly
rounded, so gamma agrees to f32 rounding and a value that lands on a
rounding boundary may take the neighbouring int8 code.

The launch takes one of two routes by static facts, never on failure
(``rmsnorm_quant_route``): "warp" (the row in the registers of 1-8 warps,
chunks of 8 values a thread; ``row_warps``) for rows of a multiple of 8
values up to ``MAX_WARP_D`` with x 16-byte aligned, else "block" (one
block a row through shared memory).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantization import fdiv
from repro_torch.kernels import _cuda

Tensor = torch.Tensor

EPS = 1e-6

# the warp route: chunks of 8 values, at most 4 a thread of up to 8 warps
# a row (kMaxWarpD); up to 2 a thread below WIDE_ROWS rows (kWideRows)
CHUNK = 8
MAX_ROW_WARPS = 8
MAX_LANE_CHUNKS = 4
MAX_WARP_D = MAX_LANE_CHUNKS * MAX_ROW_WARPS * 32 * CHUNK
WIDE_ROWS = 2048
# the block route: a row of floats in a block's shared memory (kMaxSmem)
MAX_BLOCK_D = 232448 // 4

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, scale, q, gamma, in_dtype, m, d, eps, device, stream
    "rmsnorm_quant_launch": [_P] * 4 + [_I] * 3 + [ctypes.c_float, _I, _P],
    # m, d, in_dtype, x
    "rmsnorm_quant_route": [_I] * 3 + [_P],
}


def rmsnorm_quant_route(m: int, d: int, dtype, x_ptr: int) -> str:
    """The route the kernel takes for m rows of d values of ``dtype`` at
    device address ``x_ptr``, as ``route_of`` in the CUDA source decides it:
    "warp" where d is a multiple of 8 up to ``MAX_WARP_D`` and x is 16-byte
    aligned, else "block".  Raises ``ValueError`` for what neither takes."""
    _cuda.float_code(dtype, "x")
    if m < 1 or d < 1 or d > MAX_BLOCK_D:
        raise ValueError(f"rmsnorm_quant takes no (m, d) = {(m, d)} (d at most {MAX_BLOCK_D})")
    return "warp" if d % CHUNK == 0 and d <= MAX_WARP_D and x_ptr % 16 == 0 else "block"


def row_warps(m: int, d: int) -> int:
    """Warps a row on the warp route (``row_warps`` in the CUDA source): the
    fewest, a power of two up to 8, that leave each thread at most 2 chunks
    below ``WIDE_ROWS`` rows and at most 4 from there up."""
    target, chunks = (MAX_LANE_CHUNKS if m >= WIDE_ROWS else 2), d // CHUNK
    r = 1
    while r < MAX_ROW_WARPS and -(-chunks // (32 * r)) > target:
        r *= 2
    return r


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
    """x: (M, D) float32 or bfloat16; scale: (D,) norm weight of any float
    type (read as f32, as upstream casts it).
    Returns (q (M, D) int8, gamma (M,) f32)."""
    if x.device.type == "cpu":
        return rmsnorm_quant_plain(x, scale, eps)
    dev = _cuda.device_index(x)
    code = _cuda.float_code(x.dtype, "x")
    _cuda.on_device(x, x.dtype, dev, "x")
    if x.ndim != 2 or x.shape[0] < 1 or scale.shape != (x.shape[1],):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, scale {tuple(scale.shape)}")
    scale = scale.to(torch.float32).contiguous()
    if scale.data_ptr() % 16:  # the warp route reads it 16 bytes at a time
        scale = scale.clone()
    _cuda.on_device(scale, torch.float32, dev, "scale")
    m, d = x.shape
    rmsnorm_quant_route(m, d, x.dtype, x.data_ptr())  # raises for what no route takes
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
