"""Prefill-tier W1A8 matmul on pre-quantized activations: the port of
``repro.kernels.w1a8_matmul``.

``w1a8_matmul`` launches the hand-written CUDA kernel of
``csrc/w1a8_matmul.cu`` for a CUDA tensor (any M and N; K a multiple of
16) and runs its plain PyTorch version, with the same order of
operations, for a CPU tensor.  Both write ``out_dtype`` from the f32
epilogue ``acc * (lam * (1 / gamma))``, so the kernel equals the plain
version bit for bit.

The launch picks one of two routes by shape, never on failure: "wgmma"
(K and N multiples of 16: the warp-specialised TMA + wgmma kernel, which
needs x and w_packed 16-byte aligned) or "mma" (any other N: the
mma.sync tile of ``csrc/tile_gemm.cuh``, which needs x 16-byte
aligned).  ``w1a8_matmul_route`` asks the CUDA source which one a shape
takes.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantization import fdiv
from repro_torch.kernels import _cuda
from repro_torch.kernels.ref import int_matmul, unpack_ref

Tensor = torch.Tensor

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, wp, gamma, lam, out, out_dtype, m, k, n, device, stream
    "w1a8_matmul_launch": [_P] * 5 + [_I] * 5 + [_P],
    # m, k, n
    "w1a8_matmul_route": [_I] * 3,
}


def w1a8_matmul_route(m: int, k: int, n: int) -> str:
    """The route the kernel takes for an (m, k) x (k, n) product on the
    card: "wgmma" or "mma" (builds the kernel on first use)."""
    lib = _cuda.load("w1a8_matmul", _SIGNATURES)
    return "wgmma" if lib.w1a8_matmul_route(m, k, n) else "mma"


def w1a8_matmul_plain(x_i8: Tensor, w_packed: Tensor, gamma: Tensor, lam: Tensor,
                      out_dtype=torch.float32) -> Tensor:
    """Y (M, N) = float(X_int8 @ unpack(W)) * (lam * (1 / gamma)), cast to
    out_dtype — the Pallas kernel's epilogue, step for step."""
    acc = int_matmul(x_i8, unpack_ref(w_packed))
    inv = fdiv(1.0, gamma.float())
    return (acc.float() * (lam.float().reshape(()) * inv)[:, None]).to(out_dtype)


def check_rows(x_i8: Tensor, k_of_w: int, gamma: Tensor) -> tuple[int, int, int]:
    """(device, M, K) of a prefill-tier launch on int8 rows x (M, K) with
    per-row scales gamma (M,); raises on what the kernels do not take."""
    dev = _cuda.device_index(x_i8)
    _cuda.on_device(x_i8, torch.int8, dev, "x")
    _cuda.on_device(gamma, torch.float32, dev, "gamma")
    if x_i8.ndim != 2:
        raise ValueError(f"x must be 2-D, got {tuple(x_i8.shape)}")
    m, k = x_i8.shape
    if k != k_of_w or m < 1 or k % 16 or gamma.shape != (m,):
        raise ValueError(f"shape mismatch: x {tuple(x_i8.shape)} (K a multiple of 16), weight "
                         f"K {k_of_w}, gamma {tuple(gamma.shape)}")
    if x_i8.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the kernels copy 16 bytes at a time)")
    return dev, m, k


def w1a8_matmul(x_i8: Tensor, w_packed: Tensor, gamma: Tensor, lam: Tensor,
                out_dtype=torch.float32) -> Tensor:
    """x_i8: (M, K) int8 per-token quantized rows with scales gamma (M,)
    f32; w_packed: (K//8, N) uint8 signs; lam: the AbsMean weight scale.
    Returns (M, N) in out_dtype (float32 or bfloat16)."""
    if x_i8.device.type == "cpu":
        return w1a8_matmul_plain(x_i8, w_packed, gamma, lam, out_dtype)
    dev = _cuda.device_index(x_i8)
    _cuda.on_device(w_packed, torch.uint8, dev, "w_packed")
    if w_packed.ndim != 2 or w_packed.shape[1] < 1:
        raise ValueError(f"w_packed must be (K//8, N), got {tuple(w_packed.shape)}")
    kb, n = w_packed.shape
    dev, m, k = check_rows(x_i8, kb * 8, gamma)
    if w_packed.data_ptr() % 16 and w1a8_matmul_route(m, k, n) == "wgmma":
        raise ValueError("the wgmma route needs w_packed 16-byte aligned (its TMA descriptor "
                         "copies 16-byte rows)")
    code = _cuda.float_code(out_dtype, "out_dtype")
    lam_p = _cuda.scalar_ptr(lam, dev, "lam")
    out = torch.empty((m, n), dtype=out_dtype, device=x_i8.device)
    lib = _cuda.load("w1a8_matmul", _SIGNATURES)
    err = lib.w1a8_matmul_launch(
        x_i8.data_ptr(), w_packed.data_ptr(), gamma.data_ptr(), lam_p, out.data_ptr(),
        code, m, k, n, dev, _cuda.stream_ptr(dev),
    )
    _cuda.check(err, "w1a8_matmul")
    _cuda.LAUNCHES["w1a8_matmul"] += 1
    return out
