"""Port of ``repro.kernels.ops``: the inference linears of the packed
serving path, shape-dispatched onto the kernels.

Dispatch:

* a CPU tensor runs the kernels' plain PyTorch versions (at every M);
* a CUDA tensor launches the hand-written kernels — there is no fallback;
* a CUDA tensor with more than ``DECODE_M_MAX`` flattened rows raises
  ``NotImplementedError``: upstream sends those to the prefill-tier
  kernels ``w1a8_matmul`` / ``decoupled_matmul``, which are not ported yet.

``int8_matmul`` serves every M, as upstream.  The CUDA kernels take any
row count directly (their pad rows are internal: zero codes, unit scale,
as upstream's ``_pad_rows`` / ``_pad_gamma`` give them), and they take no
tile sizes, so the port has no ``decode_tiles`` table.

Upstream's prefill tier computes the W1A8 epilogue as ``acc * (lam *
(1/gamma))`` where the decode tier computes ``acc * (lam / gamma)``; the
CPU path here uses the decode-tier arithmetic at every M, so above
``DECODE_M_MAX`` it agrees with the JAX package to f32 rounding, not bit
for bit.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import quantize_act_int8
from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.kernels.w1a8_gemv import decoupled_gemv, w1a8_gemv
from repro_torch.telemetry.tracing import annotate

Tensor = torch.Tensor

# Largest flattened row count routed to the decode GEMV tier (upstream
# ``ops.DECODE_M_MAX``): decode serves one token per request, so M = batch.
DECODE_M_MAX = 32


def _rows(x: Tensor) -> Tensor:
    """(..., K) -> contiguous, 16-byte aligned (M, K) float32: the kernels'
    activation layout (a view that starts mid-allocation is copied)."""
    xf = x.reshape(-1, x.shape[-1]).float().contiguous()
    return xf.clone() if xf.data_ptr() % 16 else xf


def _decode_tier_only(xf: Tensor, kernel: str) -> None:
    if xf.is_cuda and xf.shape[0] > DECODE_M_MAX:
        raise NotImplementedError(
            f"{xf.shape[0]} rows > DECODE_M_MAX={DECODE_M_MAX} on CUDA needs the "
            f"prefill-tier kernel {kernel}, which is not yet ported"
        )


def bit_linear_infer(x: Tensor, w_packed: Tensor, lam: Tensor,
                     out_dtype=torch.bfloat16) -> Tensor:
    """Full W1A8 inference linear: fused act-quant + packed 1-bit GEMV.
    x: (..., K) float; w_packed: (K//8, N) uint8; lam: AbsMean scale."""
    lead = x.shape[:-1]
    xf = _rows(x)
    _decode_tier_only(xf, "w1a8_matmul")
    with annotate("kernels/w1a8_gemv"):
        y = w1a8_gemv(xf, w_packed, lam)
    return y.to(out_dtype).reshape(*lead, -1)


def int8_linear_infer(x: Tensor, w_q: Tensor, wscale: Tensor,
                      out_dtype=torch.bfloat16) -> Tensor:
    """Full W8A8 inference linear (8-bit branch): a plain per-token act-quant
    pass (upstream leaves it to XLA) and the int8 matmul kernel."""
    lead = x.shape[:-1]
    xq, gamma = quantize_act_int8(x.reshape(-1, x.shape[-1]))
    with annotate("kernels/int8_matmul"):
        y = int8_matmul(xq.contiguous(), w_q.contiguous(), gamma.contiguous(), wscale)
    return y.to(out_dtype).reshape(*lead, -1)


def decoupled_first_gemm(x: Tensor, w1_packed: Tensor, w8_q: Tensor, lam: Tensor,
                         w8scale: Tensor, alpha: Tensor, beta: Tensor,
                         out_dtype=torch.bfloat16):
    """Fused dual-branch up-projection for serving: reads the activations
    once.  Returns (y1 (..., N), y8 (..., R)), pre-scaled by beta / alpha."""
    lead = x.shape[:-1]
    xf = _rows(x)
    _decode_tier_only(xf, "decoupled_matmul")
    with annotate("kernels/decoupled_gemv"):
        y1, y8 = decoupled_gemv(xf, w1_packed, w8_q.contiguous(), lam, w8scale, alpha, beta)
    return y1.to(out_dtype).reshape(*lead, -1), y8.to(out_dtype).reshape(*lead, -1)
