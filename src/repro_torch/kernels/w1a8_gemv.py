"""Decode-tier W1A8 GEMV with fused activation quantization: the port of
``repro.kernels.w1a8_gemv`` (``w1a8_gemv`` and ``decoupled_gemv``).

Each wrapper launches the hand-written CUDA kernel of
``csrc/w1a8_gemv.cu`` for a CUDA tensor and runs its plain PyTorch version
(same arithmetic, same order of operations, so the outputs agree bit for
bit) for a CPU tensor.  As upstream, x is read in its own type (float32 or
bfloat16) and the outputs are written in ``out_dtype`` (float32 or
bfloat16, rounded from the f32 epilogue), so callers cast on neither side.
The kernels take any 1 <= M <= 32 directly: pad rows are a
kernel-internal detail (zero codes, unit scale), so callers never pad.
The kernel rejects an M x K whose int8 rows overflow one block's shared
memory (32 x 5024 fits).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.ref import int_matmul, quantize_act_ref, unpack_ref

Tensor = torch.Tensor

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, x_dtype, wp, lam, out, out_dtype, m, k, n, device, stream
    "w1a8_gemv_launch": [_P, _I, _P, _P, _P] + [_I] * 5 + [_P],
    # x, x_dtype, wp, w8, lam, w8scale, alpha, beta, y1, y8, out_dtype, m, k, n, r, device,
    # stream
    "decoupled_gemv_launch": [_P, _I] + [_P] * 8 + [_I] * 6 + [_P],
}

# the decode tier: at most this many token rows per launch (ops.DECODE_M_MAX)
MAX_ROWS = 32

# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the card's yardstick)
# ---------------------------------------------------------------------------


def w1a8_gemv_plain(x: Tensor, w_packed: Tensor, lam: Tensor,
                    out_dtype=torch.float32) -> Tensor:
    """Y (M, N) = float(quantize(X) @ unpack(W)) * (lam / gamma), cast to
    out_dtype."""
    xq, gamma = quantize_act_ref(x)
    acc = int_matmul(xq, unpack_ref(w_packed))
    return (acc.float() * (lam.float().reshape(()) / gamma)[:, None]).to(out_dtype)


def decoupled_gemv_plain(x, w1_packed, w8_i8, lam, w8scale, alpha, beta,
                         out_dtype=torch.float32):
    """(y1 (M, N), y8 (M, R)) in out_dtype from one act-quant:
    y1 = float(acc1) * ((beta * lam) / gamma),
    y8 = float(acc8) * (alpha / (gamma * w8scale))."""
    xq, gamma = quantize_act_ref(x)
    lam, w8s, alpha, beta = (t.float().reshape(()) for t in (lam, w8scale, alpha, beta))
    y1 = int_matmul(xq, unpack_ref(w1_packed)).float() * ((beta * lam) / gamma)[:, None]
    y8 = int_matmul(xq, w8_i8).float() * (alpha / (gamma * w8s))[:, None]
    return y1.to(out_dtype), y8.to(out_dtype)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(x: Tensor, w_packed: Tensor) -> tuple[int, int, int, int]:
    """(device, M, K, N) of a launch; raises on what the kernels do not take."""
    dev = _cuda.device_index(x)
    _cuda.float_code(x.dtype, "x")
    _cuda.on_device(x, x.dtype, dev, "x")
    _cuda.on_device(w_packed, torch.uint8, dev, "w_packed")
    if x.ndim != 2 or w_packed.ndim != 2:
        raise ValueError("x and w_packed must be 2-D")
    m, k = x.shape
    kb, n = w_packed.shape
    if kb * 8 != k or not 1 <= m <= MAX_ROWS or n < 1:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} (1 <= M <= {MAX_ROWS}), "
                         f"packed {tuple(w_packed.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the kernels load four values at a time)")
    return dev, m, k, n


def w1a8_gemv(x: Tensor, w_packed: Tensor, lam: Tensor, out_dtype=torch.float32) -> Tensor:
    """Y (M, N) = dequant(quantize(X) @ unpack(W_packed)) in out_dtype,
    act-quant fused.  x: (M, K) float32 or bfloat16; w_packed: (K//8, N)
    uint8; lam: AbsMean scale."""
    if x.device.type == "cpu":
        return w1a8_gemv_plain(x, w_packed, lam, out_dtype)
    dev, m, k, n = _check(x, w_packed)
    code = _cuda.float_code(out_dtype, "out_dtype")
    lam_p = _cuda.scalar_ptr(lam, dev, "lam")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    lib = _cuda.load("w1a8_gemv", _SIGNATURES)
    err = lib.w1a8_gemv_launch(
        x.data_ptr(), _cuda.FLOAT_CODES[x.dtype], w_packed.data_ptr(), lam_p, out.data_ptr(),
        code, m, k, n, dev, _cuda.stream_ptr(dev),
    )
    _cuda.check(err, "w1a8_gemv")
    _cuda.LAUNCHES["w1a8_gemv"] += 1
    return out


def decoupled_gemv(x: Tensor, w1_packed: Tensor, w8_i8: Tensor, lam: Tensor,
                   w8scale: Tensor, alpha: Tensor, beta: Tensor, out_dtype=torch.float32):
    """Dual-branch decode GEMV: (y1 (M, N), y8 (M, R)) in out_dtype,
    pre-scaled by beta / alpha, from one act-quant of x (M, K) float32 or
    bfloat16.  w1_packed: (K//8, N) uint8; w8_i8: (K, R) int8; w8scale:
    the int8 quant multiplier."""
    if x.device.type == "cpu":
        return decoupled_gemv_plain(x, w1_packed, w8_i8, lam, w8scale, alpha, beta, out_dtype)
    dev, m, k, n = _check(x, w1_packed)
    _cuda.on_device(w8_i8, torch.int8, dev, "w8")
    if w8_i8.ndim != 2 or w8_i8.shape[0] != k or w8_i8.shape[1] < 1:
        raise ValueError(f"w8 must be (K={k}, R), got {tuple(w8_i8.shape)}")
    r = w8_i8.shape[1]
    code = _cuda.float_code(out_dtype, "out_dtype")
    scalars = [_cuda.scalar_ptr(t, dev, name) for t, name in
               ((lam, "lam"), (w8scale, "w8scale"), (alpha, "alpha"), (beta, "beta"))]
    y1 = torch.empty((m, n), dtype=out_dtype, device=x.device)
    y8 = torch.empty((m, r), dtype=out_dtype, device=x.device)
    lib = _cuda.load("w1a8_gemv", _SIGNATURES)
    err = lib.decoupled_gemv_launch(
        x.data_ptr(), _cuda.FLOAT_CODES[x.dtype], w1_packed.data_ptr(), w8_i8.data_ptr(),
        *scalars, y1.data_ptr(), y8.data_ptr(), code, m, k, n, r, dev, _cuda.stream_ptr(dev),
    )
    _cuda.check(err, "decoupled_gemv")
    _cuda.LAUNCHES["decoupled_gemv"] += 1
    return y1, y8
