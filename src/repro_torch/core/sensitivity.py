"""Port of ``repro.core.sensitivity``: perturbation-based weight
sensitivity (paper §2.3, Eq. 1-2) and the *parameter democratization*
score behind Figures 2 and 5a.

For weight w_ij of W (d_in, d_out) under calibration inputs X (T, d_in),

    s_ij = w_ij^2 / ( 2 * [(X^T X)^{-1}]_jj )      (generalized OBS)

with quant(w_ij) = 0 as the perturbation.  The Hessian of ||XW - XW'||^2
with respect to a column of W is H = X^T X (X is (tokens, features)).
Every function is plain torch in float32, on the device of its input.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def input_hessian(x: Tensor, damp_frac: float = 1e-2) -> Tensor:
    """H = X^T X over a flat calibration batch, with GPTQ-style dampening."""
    xf = x.reshape(-1, x.shape[-1]).float()
    h = xf.T @ xf
    damp = damp_frac * torch.mean(torch.diagonal(h)) + 1e-8
    return h + damp * torch.eye(h.shape[0], dtype=h.dtype, device=h.device)


def obs_sensitivity(w: Tensor, x: Tensor, damp_frac: float = 1e-2) -> Tensor:
    """Per-weight OBS sensitivity map, the shape of ``w`` (d_in, d_out)."""
    h_inv_diag = torch.diagonal(torch.linalg.inv(input_hessian(x, damp_frac)))
    return w.float() ** 2 / (2.0 * h_inv_diag[:, None] + 1e-12)


def democratization_score(sens: Tensor, eps: float = 1e-12) -> Tensor:
    """Scalar in (0, 1]: the normalised entropy of the sensitivity
    distribution.  1.0 is perfectly democratized (every weight equally
    sensitive, the BitNet pathology); small values are a differentiated
    landscape (FP16 / pQuant)."""
    s = sens.reshape(-1).float()
    p = s / (torch.sum(s) + eps)
    ent = -torch.sum(torch.where(p > 0, p * torch.log(p + eps), torch.zeros_like(p)))
    # log of the count in f32, as upstream, made on the device (no host copy)
    return ent / torch.log(torch.full((), float(s.numel()), device=s.device))


def sensitivity_kurtosis(sens: Tensor) -> Tensor:
    """Excess kurtosis of log-sensitivity: heavy tails mean a
    differentiated landscape (the complement of the entropy score)."""
    ls = torch.log(sens.reshape(-1).float() + 1e-20)
    mu = torch.mean(ls)
    sd = torch.std(ls, correction=0) + 1e-12
    return torch.mean(((ls - mu) / sd) ** 4) - 3.0


def top_fraction_mass(sens: Tensor, frac: float = 0.01) -> Tensor:
    """Share of the total sensitivity held by the top ``frac`` of weights."""
    s = torch.sort(sens.reshape(-1).float(), descending=True).values
    k = max(1, int(s.numel() * frac))
    return torch.sum(s[:k]) / (torch.sum(s) + 1e-12)


def max_pool_2d(sens: Tensor, out_shape: tuple[int, int]) -> Tensor:
    """Down-sample a sensitivity map by max-pooling, as the paper does for
    Figure 2."""
    m, n = sens.shape
    om, on = out_shape
    pm, pn = m // om, n // on
    trimmed = sens[: om * pm, : on * pn]
    return trimmed.reshape(om, pm, on, pn).amax(dim=(1, 3))
