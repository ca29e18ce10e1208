"""Port of ``repro.core.decoupled``: the decoupled FFN, pQuant's core
contribution (paper §3.2, Eq. 11).

    Y = alpha * FFN^{INT8}_{[:r]}(LN(x)) + beta * FFN^{INT1}_{[r:]}(LN(x))

§3.3 scaling: the 8-bit branch is replicated ``N`` times and a top-1
softmax router (``repro_torch.core.routing``) picks one branch per token;
the 1-bit branch acts as the always-active shared expert.  Active
parameter count is constant in N.  ``decoupled_proj`` (the SSM family's
projection) is not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core import routing
from repro_torch.core.bitlinear import init_rmsnorm, rmsnorm, truncated_normal
from repro_torch.core.quantization import (
    QuantConfig,
    fake_quant_linear_weights,
    fdiv,
    is_packed_1bit,
    is_stored_int8,
    maybe_quant_acts,
    quantize_weights_int8_stacked,
)
from repro_torch.core.routing import RouterConfig
from repro_torch.telemetry import probes

Tensor = torch.Tensor

ACTIVATIONS: dict[str, Callable[[Tensor], Tensor]] = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),
}


def init_decoupled_ffn(
    gen: torch.Generator,
    d_model: int,
    d_ff_1bit: int,
    r: int,
    num_experts: int = 1,
    glu: bool = True,
    lead: tuple = (),
    device=None,
    alpha_init: float = 2.0,
    beta_init: float = 0.2,
):
    """Parameters of a decoupled (GLU-)FFN, leaf for leaf upstream's:
    1-bit gate/up (d_model, d_ff_1bit) and down (d_ff_1bit, d_model);
    8-bit gate/up (N, d_model, r) and down (N, r, d_model); alpha, beta;
    SubLN; with N > 1 the router {"w": (d_model, N)}.  ``lead`` prepends
    stack axes (layers)."""
    params: dict = {}

    def tn(shape, scale):
        return truncated_normal(gen, lead + shape, device=device) * scale

    s_in = d_model**-0.5
    if d_ff_1bit > 0:
        if glu:
            params["w1_gate"] = tn((d_model, d_ff_1bit), s_in)
        params["w1_up"] = tn((d_model, d_ff_1bit), s_in)
        params["w1_down"] = tn((d_ff_1bit, d_model), d_ff_1bit**-0.5)
    if r > 0:
        n = num_experts
        if glu:
            params["w8_gate"] = tn((n, d_model, r), s_in)
        params["w8_up"] = tn((n, d_model, r), s_in)
        params["w8_down"] = tn((n, r, d_model), r**-0.5)
        # feature scaling (paper §3.2): learnable scalars, alpha >> beta
        params["alpha"] = torch.full(lead, alpha_init, device=device)
        params["beta"] = torch.full(lead, beta_init, device=device)
        if n > 1:
            params["router"] = routing.init_router(
                gen, d_model, RouterConfig(num_experts=n, top_k=1), lead, device)
    # SubLN before the down-projection (BitNet placement, Appendix B)
    params["subln"] = init_rmsnorm(
        d_ff_1bit if d_ff_1bit > 0 else r, lead, device
    )
    return params


# ---------------------------------------------------------------------------
# Packed serving path (true-integer kernel tier)
# ---------------------------------------------------------------------------


def _int8_kernel_view(w: dict):
    """Serving {"q", "scale"} (1-stacked over experts) -> (q 2-D int8,
    kernel wscale).  ``scale`` is stored as the dequant multiplier; the
    int8 kernels fold the quant multiplier into their epilogue, so this
    passes 1/scale."""
    q, s = w["q"], w["scale"]
    if q.ndim == 3:
        q, s = q[0], s[0]
    return q, fdiv(1.0, s.reshape(()))


def _serving_ffn_layout(params, glu: bool) -> bool:
    """True when the FFN has a single-expert INT8 serving branch and (if a
    1-bit trunk exists) a fully packed trunk — what
    :func:`_ffn_packed_apply` fuses.  Routed (N > 1) 8-bit branches take
    upstream's route instead: the packed trunk through
    :func:`_branch1_apply`'s kernel arm, the experts dequantized to float
    in :func:`_branch8_apply`."""
    if "w8_up" not in params:
        return False
    names = ("w8_gate", "w8_up", "w8_down") if glu else ("w8_up", "w8_down")
    if not all(
        is_stored_int8(params[n]) and params[n]["q"].shape[0] == 1
        for n in names
    ):
        return False
    if "w1_up" in params:
        names = ("w1_gate", "w1_up", "w1_down") if glu else ("w1_up", "w1_down")
        if not all(is_packed_1bit(params[n]) for n in names):
            return False
    return True


def _ffn_packed_apply(params, xf: Tensor, glu: bool, act_fn) -> Tensor:
    """Decoupled FFN on serving-layout weights: every linear runs through
    the kernel tier (``decoupled_first_gemm`` fuses each 1-bit/8-bit
    up-projection pair so the activations are read once).  alpha/beta scale
    the branch outputs, where the fake-quant path applies them."""
    from repro_torch.kernels import ops  # deferred: kernels are serving-only

    has_1bit = "w1_up" in params
    dt = xf.dtype
    one = torch.ones((), dtype=torch.float32, device=xf.device)

    def bit_lin(name, h):
        w = params[name]
        return ops.bit_linear_infer(h, w["packed"], w["scale"], out_dtype=dt)

    def int8_lin(name, h):
        q, s = _int8_kernel_view(params[name])
        return ops.int8_linear_infer(h, q, s, out_dtype=dt)

    h1 = None
    if has_1bit:
        def pair(name1, name8):
            w1 = params[name1]
            q8, s8 = _int8_kernel_view(params[name8])
            return ops.decoupled_first_gemm(
                xf, w1["packed"], q8, w1["scale"], s8, one, one, out_dtype=dt
            )

        up1, up8 = pair("w1_up", "w8_up")
        if glu:
            g1, g8 = pair("w1_gate", "w8_gate")
            h1, h8 = act_fn(g1) * up1, act_fn(g8) * up8
        else:
            h1, h8 = act_fn(up1), act_fn(up8)
    else:
        up8 = int8_lin("w8_up", xf)
        h8 = act_fn(int8_lin("w8_gate", xf)) * up8 if glu else act_fn(up8)

    y = params["alpha"].to(dt) * int8_lin("w8_down", h8)
    if h1 is not None:
        h1 = rmsnorm(params["subln"], h1)
        y = y + params["beta"].to(dt) * bit_lin("w1_down", h1)
    return y


def _branch8_apply(params, x: Tensor, glu: bool, act_fn, qcfg: QuantConfig) -> Tensor:
    """Batched-over-experts 8-bit FFN: x (N, C, D) -> (N, C, D)."""
    def wq(w):
        w = w if qcfg.mode == "none" else quantize_weights_int8_stacked(w)[0]
        return w.to(x.dtype)

    xq = maybe_quant_acts(x, qcfg)
    up = torch.einsum("ncd,ndr->ncr", xq, wq(params["w8_up"]))
    if glu:
        gate = torch.einsum("ncd,ndr->ncr", xq, wq(params["w8_gate"]))
        h = act_fn(gate) * up
    else:
        h = act_fn(up)
    hq = maybe_quant_acts(h, qcfg)
    return torch.einsum("ncr,nrd->ncd", hq, wq(params["w8_down"]))


def _branch1_apply(params, x: Tensor, glu: bool, act_fn, qcfg: QuantConfig) -> Tensor:
    """1-bit FFN branch: x (T, D) -> (T, D).  Packed serving weights run the
    W1A8 kernel tier."""
    if all(
        is_packed_1bit(params[n])
        for n in (("w1_gate", "w1_up", "w1_down") if glu else ("w1_up", "w1_down"))
    ):
        from repro_torch.kernels import ops

        def lin(name, h):
            w = params[name]
            return ops.bit_linear_infer(h, w["packed"], w["scale"], out_dtype=x.dtype)

        up = lin("w1_up", x)
        h = act_fn(lin("w1_gate", x)) * up if glu else act_fn(up)
        h = rmsnorm(params["subln"], h)
        return lin("w1_down", h)

    def wq(w):
        return fake_quant_linear_weights(w, qcfg).to(x.dtype)

    xq = maybe_quant_acts(x, qcfg)
    up = xq @ wq(params["w1_up"])
    if glu:
        h = act_fn(xq @ wq(params["w1_gate"])) * up
    else:
        h = act_fn(up)
    if qcfg.mode != "none":
        # SubLN (BitNet placement); the FP baseline has no such norm
        h = rmsnorm(params["subln"], h)
    hq = maybe_quant_acts(h, qcfg)
    return hq @ wq(params["w1_down"])


def decoupled_ffn(params, x: Tensor, qcfg: QuantConfig, glu: bool = True,
                  activation: str = "silu", router_cfg: RouterConfig | None = None):
    """Apply the decoupled FFN.  x: (..., D).  Returns (y, aux_loss); aux is
    zero unless the 8-bit branch is routed (N > 1, ``router_cfg`` given)."""
    act_fn = ACTIVATIONS[activation]
    lead = x.shape[:-1]
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if _serving_ffn_layout(params, glu):
        return _ffn_packed_apply(params, xf, glu, act_fn).reshape(*lead, d), aux

    y = torch.zeros_like(xf)
    has_1bit = "w1_up" in params
    has_8bit = "w8_up" in params

    y1s = None
    if has_1bit:
        y1 = _branch1_apply(params, xf, glu, act_fn, qcfg)
        if has_8bit:
            beta = params["beta"].to(x.dtype)
        else:
            beta = torch.ones((), dtype=x.dtype, device=x.device)
        y1s = beta * y1
        y = y + y1s

    if has_8bit:
        w8 = params["w8_up"]
        n = (w8["q"] if isinstance(w8, dict) else w8).shape[0]
        if n == 1:
            y8 = _branch8_apply(params, xf[None], glu, act_fn, qcfg)[0]
        else:
            if router_cfg is None or router_cfg.num_experts != n:
                raise ValueError(f"{n} experts need a RouterConfig with num_experts={n}, "
                                 f"got {router_cfg}")
            y8, aux = routing.route_and_apply(
                params["router"], xf, router_cfg,
                lambda xe: _branch8_apply(params, xe, glu, act_fn, qcfg))
        y8s = params["alpha"].to(x.dtype) * y8
        y = y + y8s
        if probes.active() and has_1bit:
            _tap_branch_norms(y1s, y8s)

    return y.reshape(*lead, d), aux


def _tap_branch_norms(y1_scaled: Tensor, y8_scaled: Tensor) -> None:
    """QAT probe: both decoupled branches' squared output norms
    (``qat_branch_share8``, paper §3.2's allocation claim, live)."""
    probes.add("branch1_sq", torch.sum(torch.square(y1_scaled.detach().float())))
    probes.add("branch8_sq", torch.sum(torch.square(y8_scaled.detach().float())))


def decoupled_ffn_flops(d_model: int, d_ff_1bit: int, r: int, glu: bool, tokens: int) -> int:
    """Active-path MACs * 2 over ``tokens`` tokens (top-1: one 8-bit branch)."""
    mats = 3 if glu else 2
    return mats * d_model * (d_ff_1bit + r) * 2 * tokens


def decoupled_param_counts(d_model: int, d_ff_1bit: int, r: int, num_experts: int,
                           glu: bool) -> tuple[int, int]:
    """(n_1bit_params, n_8bit_params), for effective-bits accounting."""
    mats = 3 if glu else 2
    return mats * d_model * d_ff_1bit, mats * d_model * r * num_experts
