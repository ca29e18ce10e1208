"""W8A8 matmul on pre-quantized activations: the port of
``repro.kernels.int8_matmul`` (the decoupled FFN's 8-bit branch).

``int8_matmul`` launches the hand-written CUDA kernel of
``csrc/int8_matmul.cu`` for a CUDA tensor (any M and N; K a multiple of
4) and runs its plain PyTorch version, with the same order of operations,
for a CPU tensor.  Both write ``out_dtype`` (float32 or bfloat16) from the
f32 epilogue ``float(acc) * (1 / (gamma * wscale))``, so the kernel equals
the plain version bit for bit.

The launch picks one of two routes by shape, never on failure: M <= 32
rows, or K not a multiple of 16 or above 1024, or N not a multiple of 4,
run the dp4a GEMV; every other shape runs the tensor-core tile (all of K
and the weight columns resident in shared memory, row tiles walked by
each block).  ``int8_matmul_route`` asks the CUDA source which one a
shape takes.  The tile needs x 16-byte and w 4-byte aligned; the GEMV
reads bytes and takes any view.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantization import fdiv
from repro_torch.kernels import _cuda
from repro_torch.kernels.ref import int_matmul

Tensor = torch.Tensor

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, w, gamma, wscale, out, out_dtype, m, k, n, device, stream
    "int8_matmul_launch": [_P] * 5 + [_I] * 5 + [_P],
    # m, k, n
    "int8_matmul_route": [_I] * 3,
}


def int8_matmul_route(m: int, k: int, n: int) -> str:
    """The route the kernel takes for an (m, k) x (k, n) product on the
    card: "tile" or "gemv" (builds the kernel on first use)."""
    lib = _cuda.load("int8_matmul", _SIGNATURES)
    return "tile" if lib.int8_matmul_route(m, k, n) else "gemv"


def int8_matmul_plain(x_i8: Tensor, w_i8: Tensor, gamma: Tensor, wscale: Tensor,
                      out_dtype=torch.float32) -> Tensor:
    """Y (M, N) = float(X_int8 @ W_int8) * (1 / (gamma * wscale)), cast to
    out_dtype."""
    acc = int_matmul(x_i8, w_i8)
    inv = fdiv(1.0, gamma.float() * wscale.float().reshape(()))
    return (acc.float() * inv[:, None]).to(out_dtype)


def int8_matmul(x_i8: Tensor, w_i8: Tensor, gamma: Tensor, wscale: Tensor,
                out_dtype=torch.float32) -> Tensor:
    """x_i8: (M, K) int8 per-token quantized rows with scales gamma (M,)
    f32; w_i8: (K, N) int8 with quant multiplier wscale (q = w * wscale).
    Returns (M, N) in out_dtype (float32 or bfloat16)."""
    if x_i8.device.type == "cpu":
        return int8_matmul_plain(x_i8, w_i8, gamma, wscale, out_dtype)
    dev = _cuda.device_index(x_i8)
    for t, name, dt in ((x_i8, "x", torch.int8), (w_i8, "w", torch.int8),
                        (gamma, "gamma", torch.float32)):
        _cuda.on_device(t, dt, dev, name)
    if x_i8.ndim != 2 or w_i8.ndim != 2:
        raise ValueError("x and w must be 2-D")
    m, k = x_i8.shape
    k2, n = w_i8.shape
    if k2 != k or gamma.shape != (m,) or m < 1 or n < 1 or k % 4:
        raise ValueError(f"shape mismatch: x {tuple(x_i8.shape)}, w {tuple(w_i8.shape)}, "
                         f"gamma {tuple(gamma.shape)} (K must be a multiple of 4)")
    if (x_i8.data_ptr() % 16 or w_i8.data_ptr() % 4) and int8_matmul_route(m, k, n) == "tile":
        raise ValueError("the tile route needs x 16-byte and w 4-byte aligned (it copies "
                         "16-byte rows of x and 4-byte words of w)")
    code = _cuda.float_code(out_dtype, "out_dtype")
    wscale_p = _cuda.scalar_ptr(wscale, dev, "wscale")
    out = torch.empty((m, n), dtype=out_dtype, device=x_i8.device)
    lib = _cuda.load("int8_matmul", _SIGNATURES)
    err = lib.int8_matmul_launch(
        x_i8.data_ptr(), w_i8.data_ptr(), gamma.data_ptr(), wscale_p,
        out.data_ptr(), code, m, k, n, dev, _cuda.stream_ptr(dev),
    )
    _cuda.check(err, "int8_matmul")
    _cuda.LAUNCHES["int8_matmul"] += 1
    return out
