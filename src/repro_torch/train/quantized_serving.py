"""Port of ``repro.train.quantized_serving``: export latent float weights to
the integer layout that lives in device memory at serving time (paper
Appendix A).

The 1-bit backbone becomes int8 signs (or, with ``packed=True``, uint8 sign
bits 8 per byte along K, ``(..., K//8, N)``) with one AbsMean scale; the
8-bit branch becomes int8 ``(..., K, N)`` with an AbsMax scale.  Scales
are per slice of a stacked weight and keep their dims (keepdims), as
upstream.  Weights are classified by parameter-path name.
"""

from __future__ import annotations

import warnings

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packing import pack_signs
from repro_torch.core.quantization import fdiv

Tensor = torch.Tensor

# parent-key names of 1-bit backbone linears ({"w": tensor} wrappers)
INT1_WRAPPED = {
    "wq", "wk", "wv", "wo", "wq_down", "wq_up", "wkv_down", "wkv_up",
    "wx", "wy", "wout",
}
# direct-tensor leaf names
INT1_DIRECT = {"w1_gate", "w1_up", "w1_down", "we_up", "we_gate", "we_down", "w1"}
INT8_DIRECT = {"w8_gate", "w8_up", "w8_down", "w8_a", "w8_b"}


def _slice_means(w: Tensor) -> tuple[Tensor, Tensor]:
    """mean(w) and mean(|w|) of each trailing (K, N) slice, keepdims, in
    w's dtype.  Each slice is summed on its own in f64 and rounded once:
    an f32 reduction sums in an order that follows the shape of the tensor
    it runs over (and the device), so a layer's scale would depend on how
    many layers were stacked with it when it was exported."""
    flat = w.reshape((-1,) + tuple(w.shape[-2:]))
    keep = tuple(w.shape[:-2]) + (1, 1)
    mu = torch.stack([torch.mean(s, dtype=torch.float64) for s in flat])
    mag = torch.stack([torch.mean(torch.abs(s), dtype=torch.float64) for s in flat])
    return mu.to(w.dtype).reshape(keep), mag.to(w.dtype).reshape(keep)


def _binarize_export(w: Tensor, packed: bool, name: str = ""):
    """Latent -> {"q" | "packed", "scale"} per trailing 2-D slice:
    ``scale = mean|w| + 1e-5`` and signs ``w - mean(w) >= 0``.  A K that
    isn't a multiple of 8 cannot pack and stays int8 signs, with a warning."""
    mu, mag = _slice_means(w)
    lam = (mag + 1e-5).float()
    signs = (w - mu >= 0).to(torch.int8) * 2 - 1  # int8 throughout: no wide temporary
    if packed:
        if w.shape[-2] % 8 == 0:
            return {"packed": pack_signs(signs), "scale": lam}
        warnings.warn(
            f"packed export of {name or 'a 1-bit weight'} {tuple(w.shape)}: "
            f"K={w.shape[-2]} is not a multiple of 8; storing unpacked INT8 signs",
            stacklevel=2,
        )
    return {"q": signs, "scale": lam}


def _int8_export(w: Tensor):
    """Latent -> {"q": int8, "scale"}: ``scale = (max|w| + 1e-5) / 127`` is
    the dequant multiplier, ``q = clip(round(w / scale))``."""
    red = tuple(range(max(0, w.ndim - 2), w.ndim))
    amax = torch.amax(torch.abs(w), dim=red, keepdim=True) + 1e-5
    scale = fdiv(amax, 127.0).float()
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def quantize_params_for_serving(params, cfg: ModelConfig, packed: bool = False):
    """The integer serving layout of a latent param tree (same structure,
    1-bit and 8-bit weights replaced by their export dicts).  ``mode='none'``
    returns the tree unchanged."""
    if cfg.quant.mode == "none":
        return params

    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + [str(k)]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, keys + [str(i)]) for i, v in enumerate(node))
        name = keys[-1]
        parent = keys[-2] if len(keys) >= 2 else ""
        is_int1 = name in INT1_DIRECT or (name == "w" and parent in INT1_WRAPPED)
        if is_int1 and node.ndim >= 2:
            return _binarize_export(node, packed, name="/".join(keys))
        if name in INT8_DIRECT and node.ndim >= 2:
            return _int8_export(node)
        return node

    return walk(params, [])
