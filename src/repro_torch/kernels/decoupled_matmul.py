"""Prefill-tier fused first GEMM of the decoupled FFN: the port of
``repro.kernels.decoupled_matmul``.

``decoupled_matmul`` launches the hand-written CUDA kernel of
``csrc/decoupled_matmul.cu`` for a CUDA tensor (any M, N and r; K a
multiple of 16, r a multiple of 4) and runs its plain PyTorch version,
with the Pallas kernel's two epilogues, for a CPU tensor.  Both write
``out_dtype``; the kernel equals the plain version bit for bit.

The launch picks one of two routes by shape, never on failure: "wgmma"
(K, N and r multiples of 16: the warp-specialised TMA + wgmma kernel,
both branches in one persistent launch, which needs x, w1_packed and w8
16-byte aligned) or "mma" (any other N or r: the mma.sync tile of
``csrc/tile_gemm.cuh``, which needs x 16-byte and w8 4-byte aligned).
``decoupled_matmul_route`` asks the CUDA source which one a shape takes.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantization import fdiv
from repro_torch.kernels import _cuda
from repro_torch.kernels.ref import int_matmul, unpack_ref
from repro_torch.kernels.w1a8_matmul import check_rows

Tensor = torch.Tensor

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, wp, w8, gamma, lam, w8scale, alpha, beta, y1, y8, out_dtype, m, k, n, r, device, stream
    "decoupled_matmul_launch": [_P] * 10 + [_I] * 6 + [_P],
    # m, k, n, r
    "decoupled_matmul_route": [_I] * 4,
}


def decoupled_matmul_route(m: int, k: int, n: int, r: int) -> str:
    """The route the kernel takes for an (m, k) x [(k, n) packed, (k, r)
    int8] product on the card: "wgmma" or "mma" (builds the kernel on first
    use)."""
    lib = _cuda.load("decoupled_matmul", _SIGNATURES)
    return "wgmma" if lib.decoupled_matmul_route(m, k, n, r) else "mma"


def decoupled_matmul_plain(x_i8: Tensor, w1_packed: Tensor, w8_i8: Tensor, gamma: Tensor,
                           lam: Tensor, w8scale: Tensor, alpha: Tensor, beta: Tensor,
                           out_dtype=torch.float32):
    """(y1 (M, N), y8 (M, R)) in out_dtype:
    y1 = float(acc1) * ((beta * lam) * (1 / gamma)),
    y8 = float(acc8) * (alpha / (gamma * w8scale))."""
    lam, w8s, alpha, beta = (t.float().reshape(()) for t in (lam, w8scale, alpha, beta))
    gamma = gamma.float()
    inv = fdiv(1.0, gamma)
    y1 = int_matmul(x_i8, unpack_ref(w1_packed)).float() * ((beta * lam) * inv)[:, None]
    y8 = int_matmul(x_i8, w8_i8).float() * fdiv(alpha, gamma * w8s)[:, None]
    return y1.to(out_dtype), y8.to(out_dtype)


def decoupled_matmul(x_i8: Tensor, w1_packed: Tensor, w8_i8: Tensor, gamma: Tensor,
                     lam: Tensor, w8scale: Tensor, alpha: Tensor, beta: Tensor,
                     out_dtype=torch.float32):
    """Both decoupled up-projections of int8 rows x (M, K) with scales
    gamma (M,): w1_packed (K//8, N) uint8 signs with AbsMean lam, w8_i8
    (K, R) int8 with quant multiplier w8scale; outputs pre-scaled by beta
    and alpha."""
    if x_i8.device.type == "cpu":
        return decoupled_matmul_plain(x_i8, w1_packed, w8_i8, gamma, lam, w8scale, alpha, beta,
                                      out_dtype)
    dev = _cuda.device_index(x_i8)
    _cuda.on_device(w1_packed, torch.uint8, dev, "w1_packed")
    _cuda.on_device(w8_i8, torch.int8, dev, "w8")
    if w1_packed.ndim != 2 or w1_packed.shape[1] < 1:
        raise ValueError(f"w1_packed must be (K//8, N), got {tuple(w1_packed.shape)}")
    kb, n = w1_packed.shape
    dev, m, k = check_rows(x_i8, kb * 8, gamma)
    if w8_i8.ndim != 2 or w8_i8.shape[0] != k or w8_i8.shape[1] < 1 or w8_i8.shape[1] % 4:
        raise ValueError(f"w8 must be (K={k}, R) with R a multiple of 4, "
                         f"got {tuple(w8_i8.shape)}")
    if w8_i8.data_ptr() % 4:
        raise ValueError("w8 must be 4-byte aligned (the kernel reads it a word at a time)")
    r = w8_i8.shape[1]
    if ((w1_packed.data_ptr() % 16 or w8_i8.data_ptr() % 16)
            and decoupled_matmul_route(m, k, n, r) == "wgmma"):
        raise ValueError("the wgmma route needs w1_packed and w8 16-byte aligned (its TMA "
                         "descriptors copy 16-byte rows)")
    code = _cuda.float_code(out_dtype, "out_dtype")
    scalars = [_cuda.scalar_ptr(t, dev, name) for t, name in
               ((lam, "lam"), (w8scale, "w8scale"), (alpha, "alpha"), (beta, "beta"))]
    y1 = torch.empty((m, n), dtype=out_dtype, device=x_i8.device)
    y8 = torch.empty((m, r), dtype=out_dtype, device=x_i8.device)
    lib = _cuda.load("decoupled_matmul", _SIGNATURES)
    err = lib.decoupled_matmul_launch(
        x_i8.data_ptr(), w1_packed.data_ptr(), w8_i8.data_ptr(), gamma.data_ptr(), *scalars,
        y1.data_ptr(), y8.data_ptr(), code, m, k, n, r, dev, _cuda.stream_ptr(dev),
    )
    _cuda.check(err, "decoupled_matmul")
    _cuda.LAUNCHES["decoupled_matmul"] += 1
    return y1, y8
