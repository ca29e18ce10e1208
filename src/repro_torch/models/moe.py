"""Port of ``repro.models.moe``: the DeepSeekMoE-style mixture-of-experts
FFN (shared + routed experts).

Composition with pQuant, as upstream: in ``pquant`` mode the routed
experts' FFNs are 1-bit (the capacity pool) while the *shared* experts,
always active, carry the decoupled 8-bit branch that keeps the sensitive
parameters.  The expert weights are stacked ``(E, D, F)`` / ``(E, F, D)``
and quantized per slice (``fake_quant_stacked``); on the packed serving
export each expert slice runs one W1A8 kernel call per linear, unrolled
over E as upstream.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import routing
from repro_torch.core.bitlinear import truncated_normal
from repro_torch.core.decoupled import ACTIVATIONS
from repro_torch.core.quantization import (
    QuantConfig,
    fake_quant_stacked,
    is_packed_1bit,
    maybe_quant_acts,
)
from repro_torch.core.routing import RouterConfig
from repro_torch.models.layers import apply_ffn, init_ffn

Tensor = torch.Tensor


def init_moe_ffn(gen: torch.Generator, cfg: ModelConfig, lead: tuple = (), device=None):
    """Parameters of one MoE FFN layer (``lead`` prepends the layer stack):
    the expert stacks ``we_up`` / ``we_gate`` (E, D, F) and ``we_down``
    (E, F, D), the router, and the shared experts fused into one FFN of
    width ``n_shared_experts * d_ff_expert``."""
    d, e, de = cfg.d_model, cfg.n_routed_experts, cfg.d_ff_expert
    params = {}
    shapes = [("we_up", (e, d, de))]
    if cfg.glu:
        shapes.append(("we_gate", (e, d, de)))
    shapes.append(("we_down", (e, de, d)))
    for name, shp in shapes:
        scale = d**-0.5 if shp[1] == d else de**-0.5
        params[name] = truncated_normal(gen, lead + shp, device=device) * scale
    params["router"] = routing.init_router(
        gen, d, RouterConfig(num_experts=e, top_k=cfg.moe_top_k), lead, device)
    if cfg.n_shared_experts > 0:
        params["shared"] = init_ffn(gen, cfg, lead, device, d_ff=cfg.n_shared_experts * de)
    return params


def _expert_wq(qcfg: QuantConfig, dtype):
    """Per-expert weight quantizer.  Upstream's ``qgather`` arm (the FSDP
    gather moving int8 signs) needs ``distributed/qgather.py``, which is
    not ported (ROADMAP queue 1 item 7)."""
    if qcfg.qgather and qcfg.mode in ("bitnet", "pquant"):
        raise NotImplementedError(
            "QuantConfig.qgather needs distributed/qgather.py, not yet ported "
            "(ROADMAP queue 1 item 7)")
    return lambda w: fake_quant_stacked(w, qcfg).to(dtype)


def _experts_packed(params, glu: bool) -> bool:
    """True when every expert weight is the bit-packed serving layout
    {"packed": (E, D//8, F) uint8, "scale": (E, 1, 1)}."""
    names = ("we_gate", "we_up", "we_down") if glu else ("we_up", "we_down")
    return all(is_packed_1bit(params[n]) for n in names)


def _experts_apply_packed(params, xe: Tensor, cfg: ModelConfig) -> Tensor:
    """Packed-serving expert FFN: one W1A8 kernel call per expert slice and
    linear (each expert keeps its own AbsMean scale).  xe: (..., E, C, D),
    the expert axis third from last."""
    from repro_torch.kernels import ops  # deferred: kernels are serving-only

    act = ACTIVATIONS[cfg.activation]
    e_ax = xe.ndim - 3

    def lin(name, h, e):
        w = params[name]
        return ops.bit_linear_infer(h, w["packed"][e], w["scale"][e], out_dtype=xe.dtype)

    outs = []
    for e in range(xe.shape[e_ax]):
        x_e = xe.select(e_ax, e)
        up = lin("we_up", x_e, e)
        h = act(lin("we_gate", x_e, e)) * up if cfg.glu else act(up)
        outs.append(lin("we_down", h, e))
    return torch.stack(outs, dim=e_ax)


def _experts_apply(params, xe: Tensor, cfg: ModelConfig, qcfg: QuantConfig,
                   eq: str = "ecd,edf->ecf") -> Tensor:
    """Batched expert FFN, per-expert quantized: xe (E, C, D) -> (E, C, D),
    or with ``eq`` over (G, E, C, D) for the einsum dispatch."""
    if _experts_packed(params, cfg.glu):
        return _experts_apply_packed(params, xe, cfg)
    act = ACTIVATIONS[cfg.activation]
    wq = _expert_wq(qcfg, xe.dtype)
    xq = maybe_quant_acts(xe, qcfg)
    up = torch.einsum(eq, xq, wq(params["we_up"]))
    h = act(torch.einsum(eq, xq, wq(params["we_gate"]))) * up if cfg.glu else act(up)
    hq = maybe_quant_acts(h, qcfg)
    return torch.einsum(eq, hq, wq(params["we_down"]))


def _experts_apply_grouped(params, xe: Tensor, cfg: ModelConfig, qcfg: QuantConfig) -> Tensor:
    """Batched expert FFN for the einsum dispatch: (G, E, C, D) -> (G, E, C, D)."""
    return _experts_apply(params, xe, cfg, qcfg, eq="gecd,edf->gecf")


def moe_ffn(params, x: Tensor, cfg: ModelConfig):
    """The MoE FFN over x (..., D).  Returns (y, aux_loss): the routed
    experts' top-k gates normalized to sum to 1 (DeepSeek), the Switch
    aux loss and the router z-loss, plus the shared experts' output and
    aux."""
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, d)
    rcfg = RouterConfig(num_experts=cfg.n_routed_experts, top_k=cfg.moe_top_k,
                        capacity_factor=cfg.moe_capacity_factor)
    probs, logits = routing.router_probs(params["router"], xf)

    if cfg.moe_dispatch == "einsum":
        gs = min(cfg.moe_group_size, xf.shape[0])
        combine, dispatch, aux = routing.einsum_dispatch_combine(probs, rcfg, gs)
        # DeepSeek-style top-k gate normalization, over a token's (E, C)
        combine = combine / (torch.sum(combine, dim=(-1, -2), keepdim=True) + 1e-9)
        xg = xf.reshape(xf.shape[0] // gs, gs, d)
        xe = torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xg)
        ye = _experts_apply_grouped(params, xe, cfg, cfg.quant)
        y = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), ye).reshape(-1, d)
    else:
        dispatch = routing.topk_dispatch(probs, rcfg)
        # DeepSeek normalizes the kept top-k gates to sum to 1 (0 / 1e-9
        # for a token whose every slot was dropped)
        cw = dispatch["combine_weight"]
        dispatch["combine_weight"] = cw / (torch.sum(cw, dim=-1, keepdim=True) + 1e-9)
        ye = _experts_apply(params, routing.dispatch_gather(xf, dispatch), cfg, cfg.quant)
        y = routing.combine_scatter(ye, dispatch, xf.shape[0])
        aux = dispatch["aux_loss"]
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1))) * rcfg.router_z_weight
    aux = aux + z.to(aux.dtype)

    if "shared" in params:
        ys, aux_s = apply_ffn(params["shared"], xf, cfg)
        y = y + ys
        aux = aux + aux_s
    return y.reshape(*lead, d), aux
