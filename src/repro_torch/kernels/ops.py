"""Port of ``repro.kernels.ops``: the inference linears of the packed
serving path, shape-dispatched onto the kernels.

Tiers, as upstream:

* at most ``DECODE_M_MAX`` flattened rows: the decode GEMVs
  ``w1a8_gemv`` / ``decoupled_gemv``, which quantize the activations in
  their prologue;
* above it: the prefill tier — a plain per-token act-quant pass
  (``quantize_act_int8``, which upstream leaves to XLA), then the tiled
  GEMMs ``w1a8_matmul`` / ``decoupled_matmul`` on the int8 rows, writing
  ``out_dtype`` directly;
* ``int8_matmul`` serves every M.

Paged attention (block-table attention over the serving KV pool):
``paged_attention_enabled`` / ``paged_attention_supported`` gate the model
stack's paged branches onto ``paged_attention``; otherwise they gather the
pool and run the dense SDPA (``models.attention._paged_scores``).  The
CUDA kernel takes no pages-per-step tile, so ``paged_tiles`` /
``sweep_paged_tiles`` (upstream's autotune) are not ported.

A CPU tensor runs the kernels' plain PyTorch versions, in each Pallas
kernel's order of operations; a CUDA tensor launches the hand-written
kernels, and a shape a kernel cannot take raises ``ValueError`` — there
is no fallback.  The kernels take any row count directly (pad rows are
internal, with zero codes and unit scale, as upstream's ``_pad_rows`` /
``_pad_gamma`` give them) and take no tile sizes, so the port has no
``decode_tiles`` table.
"""

from __future__ import annotations

import os

import torch

from repro_torch.core.quantization import quantize_act_int8
from repro_torch.kernels.decoupled_matmul import decoupled_matmul
from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.kernels.paged_attention import paged_attention as _paged_attention
from repro_torch.kernels.rmsnorm_quant import rmsnorm_quant
from repro_torch.kernels.w1a8_gemv import decoupled_gemv, w1a8_gemv
from repro_torch.kernels.w1a8_matmul import w1a8_matmul
from repro_torch.telemetry.tracing import annotate

Tensor = torch.Tensor

# Largest flattened row count routed to the decode GEMV tier (upstream
# ``ops.DECODE_M_MAX``): decode serves one token per request, so M = batch.
DECODE_M_MAX = 32


def _rows(x: Tensor) -> Tensor:
    """(..., K) -> contiguous, 16-byte aligned (M, K) rows in a type the
    decode GEMVs read: bfloat16 stays bfloat16, any other float becomes
    float32 (a view that starts mid-allocation is copied)."""
    xf = x.reshape(-1, x.shape[-1])
    xf = (xf if xf.dtype == torch.bfloat16 else xf.float()).contiguous()
    return xf.clone() if xf.data_ptr() % 16 else xf


def _bit_linear_prefill(xf: Tensor, w_packed: Tensor, lam: Tensor, out_dtype) -> Tensor:
    """Prefill tier: plain act-quant pass + tiled W1A8 GEMM."""
    xq, gamma = quantize_act_int8(xf)
    with annotate("kernels/w1a8_matmul"):
        return w1a8_matmul(xq, w_packed, gamma, lam, out_dtype)


def _bit_linear_decode(xf: Tensor, w_packed: Tensor, lam: Tensor, out_dtype) -> Tensor:
    """Decode tier: act-quant fused into the GEMV's prologue."""
    with annotate("kernels/w1a8_gemv"):
        return w1a8_gemv(_rows(xf), w_packed, lam, out_dtype)


def bit_linear_infer(x: Tensor, w_packed: Tensor, lam: Tensor,
                     out_dtype=torch.bfloat16) -> Tensor:
    """Full W1A8 inference linear: quantize acts -> packed 1-bit matmul.
    x: (..., K) float; w_packed: (K//8, N) uint8; lam: AbsMean scale."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    tier = _bit_linear_decode if xf.shape[0] <= DECODE_M_MAX else _bit_linear_prefill
    return tier(xf, w_packed, lam, out_dtype).reshape(*lead, -1)


def int8_linear_infer(x: Tensor, w_q: Tensor, wscale: Tensor,
                      out_dtype=torch.bfloat16) -> Tensor:
    """Full W8A8 inference linear (8-bit branch): a plain per-token act-quant
    pass (upstream leaves it to XLA) and the int8 matmul kernel."""
    lead = x.shape[:-1]
    xq, gamma = quantize_act_int8(x.reshape(-1, x.shape[-1]))
    with annotate("kernels/int8_matmul"):
        y = int8_matmul(xq.contiguous(), w_q.contiguous(), gamma.contiguous(), wscale,
                        out_dtype)
    return y.reshape(*lead, -1)


def fused_rmsnorm_quant(x: Tensor, scale: Tensor):
    """(..., D) -> (int8 (..., D), gamma (...)): RMSNorm (eps 1e-6) times
    scale, then per-token AbsMax INT8, in one kernel."""
    lead = x.shape[:-1]
    q, gamma = rmsnorm_quant(x.reshape(-1, x.shape[-1]).contiguous(), scale.contiguous())
    return q.reshape(*lead, -1), gamma.reshape(lead)


def _decoupled_prefill(xf, w1_packed, w8_q, lam, w8scale, alpha, beta, out_dtype):
    """Prefill tier: plain act-quant pass + both up-projections in one GEMM."""
    xq, gamma = quantize_act_int8(xf)
    with annotate("kernels/decoupled_matmul"):
        return decoupled_matmul(xq, w1_packed, w8_q.contiguous(), gamma, lam, w8scale,
                                alpha, beta, out_dtype)


def _decoupled_decode(xf, w1_packed, w8_q, lam, w8scale, alpha, beta, out_dtype):
    """Decode tier: one act-quant prologue feeds both branches."""
    with annotate("kernels/decoupled_gemv"):
        return decoupled_gemv(_rows(xf), w1_packed, w8_q.contiguous(), lam, w8scale, alpha,
                              beta, out_dtype)


def decoupled_first_gemm(x: Tensor, w1_packed: Tensor, w8_q: Tensor, lam: Tensor,
                         w8scale: Tensor, alpha: Tensor, beta: Tensor,
                         out_dtype=torch.bfloat16):
    """Fused dual-branch up-projection for serving: reads the activations
    once.  Returns (y1 (..., N), y8 (..., R)), pre-scaled by beta / alpha."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    tier = _decoupled_decode if xf.shape[0] <= DECODE_M_MAX else _decoupled_prefill
    y1, y8 = tier(xf, w1_packed, w8_q, lam, w8scale, alpha, beta, out_dtype)
    return y1.reshape(*lead, -1), y8.reshape(*lead, -1)


# ---------------------------------------------------------------------------
# Paged attention (block-table attention over the serving KV pool)
# ---------------------------------------------------------------------------


def paged_attention_enabled(device=None) -> bool:
    """Whether the model stack's paged branches run the paged-attention
    kernel route for tensors on ``device``.

    ``REPRO_PAGED_ATTN=0`` forces the gather + SDPA path, ``=1`` the kernel
    route (on CPU tensors that is the kernel's plain version), and the
    default (``auto``) takes the kernel for CUDA tensors and, as upstream
    off the TPU, the gather path for CPU tensors: the CPU serving suites
    rely on its bitwise-dense numerics."""
    v = os.environ.get("REPRO_PAGED_ATTN", "auto")
    if v == "0":
        return False
    if v == "1":
        return True
    return device is not None and torch.device(device).type == "cuda"


def paged_attention_supported(block_size: int, head_dim: int, n_q_heads: int,
                              n_kv_heads: int) -> bool:
    """Upstream's static shape gate (callers take the gather path on
    False): GQA grouping divides evenly and page/head tiles are multiples
    of 8."""
    return n_q_heads % n_kv_heads == 0 and block_size % 8 == 0 and head_dim % 8 == 0


def paged_attention(q: Tensor, kpool: Tensor, vpool: Tensor, table: Tensor, start: Tensor,
                    kv_lens: Tensor, scale: float | None = None) -> Tensor:
    """Block-table attention over the paged KV pool (online softmax in f32,
    GQA/MQA grouping; T = 1 decode, T > 1 chunk): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (a shape it cannot take
    raises ``ValueError``)."""
    with annotate("kernels/paged_attention"):
        return _paged_attention(q.contiguous(), kpool, vpool, table, start, kv_lens, scale)
