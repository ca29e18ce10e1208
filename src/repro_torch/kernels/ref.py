"""Port of ``repro.kernels.ref``: plain PyTorch oracles for the packed
linears' kernels (and the matmul oracles they are built from) and for
paged attention; the ``rmsnorm_quant`` oracle is
``kernels.rmsnorm_quant.rmsnorm_quant_plain``.

The order of operations is upstream ``ref.py``'s, which is not always the
kernels' (``w1a8_matmul_ref`` computes ``acc * lam / gamma`` where the
W1A8 GEMV kernel computes ``acc * (lam / gamma)``): compare a kernel with
these at f32 tolerance, and with its plain version beside it in
``repro_torch.kernels`` bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import fdiv

Tensor = torch.Tensor


def unpack_ref(packed: Tensor) -> Tensor:
    """(K//8, N) uint8 -> (K, N) int8 in {-1, +1} (little-endian bits)."""
    kb, n = packed.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)[None, :, None]
    bits = torch.bitwise_right_shift(packed[:, None, :], shifts) & 1
    return (bits.to(torch.int8) * 2 - 1).reshape(kb * 8, n)


def int_matmul(a: Tensor, b: Tensor) -> Tensor:
    """Exact integer product of int8 matrices as int32.  Runs in float64,
    which holds every partial sum of int8 products exactly (|sum| <
    2**53) on any device and in any summation order."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def w1a8_matmul_ref(x_i8: Tensor, w_packed: Tensor, gamma: Tensor, lam: Tensor,
                    out_dtype=torch.float32) -> Tensor:
    """Y = (X_int8 @ unpack(W)) * lam / gamma   (paper Eq. 10)."""
    acc = int_matmul(x_i8, unpack_ref(w_packed))
    y = acc.float() * lam.float() / gamma[:, None].float()
    return y.to(out_dtype)


def int8_matmul_ref(x_i8: Tensor, w_i8: Tensor, gamma: Tensor, wscale: Tensor,
                    out_dtype=torch.float32) -> Tensor:
    """Y = (X_int8 @ W_int8) / (gamma * wscale)   (W8A8 branch)."""
    acc = int_matmul(x_i8, w_i8)
    y = acc.float() / (gamma[:, None].float() * wscale.float())
    return y.to(out_dtype)


def quantize_act_ref(x: Tensor):
    """Per-token AbsMax INT8: (M, K) float -> (q (M, K) int8, gamma (M,) f32)."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    gamma = fdiv(127.0, amax + 1e-5)
    q = torch.clamp(torch.round(xf * gamma[:, None]), -127, 127).to(torch.int8)
    return q, gamma


def w1a8_gemv_ref(x: Tensor, w_packed: Tensor, lam: Tensor, out_dtype=torch.float32) -> Tensor:
    """Decode GEMV with fused act-quant: quantize_act_ref + w1a8_matmul_ref."""
    xq, gamma = quantize_act_ref(x)
    return w1a8_matmul_ref(xq, w_packed, gamma, lam, out_dtype=out_dtype)


def decoupled_matmul_ref(x_i8, w1_packed, w8_i8, gamma, lam, w8scale, alpha, beta,
                         out_dtype=torch.float32):
    """Fused first GEMM of the decoupled FFN: (beta * W1A8, alpha * W8A8)."""
    y1 = w1a8_matmul_ref(x_i8, w1_packed, gamma, lam) * beta
    y8 = int8_matmul_ref(x_i8, w8_i8, gamma, w8scale) * alpha
    return y1.to(out_dtype), y8.to(out_dtype)


def decoupled_gemv_ref(x, w1_packed, w8_i8, lam, w8scale, alpha, beta,
                       out_dtype=torch.float32):
    """Dual-branch decode GEMV reference (act-quant + decoupled_matmul_ref)."""
    xq, gamma = quantize_act_ref(x)
    return decoupled_matmul_ref(
        xq, w1_packed, w8_i8, gamma, lam, w8scale, alpha, beta, out_dtype=out_dtype
    )


def paged_attention_ref(q: Tensor, kpool: Tensor, vpool: Tensor, table: Tensor,
                        start: Tensor, kv_lens: Tensor, scale=None, out_dtype=None) -> Tensor:
    """Gather + prefix-masked SDPA at f32 — the dense read path the paged
    kernel replaces, with query token t of slot b attending absolute
    columns ``j <= start[b] + t``.  ``kv_lens`` is unused (the causal mask
    bounds every valid row), kept so oracle and kernel share a signature."""
    del kv_lens
    b, t, hq, d = q.shape
    hkv = kpool.shape[2]
    g = hq // hkv
    scale = d**-0.5 if scale is None else scale
    idx = table.long()
    keys = kpool[idx].reshape(b, -1, hkv, d)
    vals = vpool[idx].reshape(b, -1, hkv, d)
    skv = keys.shape[1]
    qg = q.reshape(b, t, hkv, g, d).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, keys.float()) * scale
    rowpos = start.long()[:, None] + torch.arange(t, device=q.device)[None]
    mask = torch.arange(skv, device=q.device)[None, None, :] <= rowpos[:, :, None]  # (B,T,S)
    logits = torch.where(mask[:, None, None], logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, vals.float()).reshape(b, t, hq, d)
    return out.to(out_dtype if out_dtype is not None else q.dtype)
