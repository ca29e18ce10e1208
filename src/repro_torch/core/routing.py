"""Port of ``repro.core.routing``: the sort-based top-k token->expert
dispatch of pQuant's routed 8-bit branches (top-1, paper §3.3).

Shapes stay static, as upstream: expert ``i`` holds at most
``C = expert_capacity(T)`` tokens, and a token past its expert's capacity
is dropped (its combine weight is 0; the 1-bit trunk, the always-active
shared expert, still carries it).  Every step runs on the device without
a host sync: where upstream's scatter drops out-of-capacity writes
(``mode="drop"``), the port writes them to a spare column C of an
``(N, C + 1)`` buffer and slices it off; gathers and scatters use
``index_select`` / ``scatter``, never a boolean mask.

Ties: ``jax.lax.top_k`` takes the lowest index among equal values, and so
does :func:`_top_k` (``argmax`` promises the first maximal index on every
device).  The one-hot dispatch (:func:`einsum_dispatch_combine`) serves
the DeepSeek-MoE family's ``moe_dispatch="einsum"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.bitlinear import truncated_normal
from repro_torch.core.quantization import fdiv
from repro_torch.telemetry import probes

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    num_experts: int
    top_k: int = 1
    capacity_factor: float = 1.25
    # z-loss / aux load-balancing loss weights (Shazeer-style)
    aux_loss_weight: float = 0.01
    router_z_weight: float = 1e-3
    dtype: str = "float32"


def init_router(gen: torch.Generator, d_model: int, cfg: RouterConfig, lead: tuple = (),
                device=None):
    """{"w": (..., d_model, N)}, truncated-normal fan-in; ``lead`` prepends
    stack axes (layers)."""
    w = truncated_normal(gen, lead + (d_model, cfg.num_experts), device=device)
    return {"w": w * d_model**-0.5}


def router_probs(params, x: Tensor) -> tuple[Tensor, Tensor]:
    """Softmax router (probs, logits), in f32 whatever x's dtype."""
    logits = x.float() @ params["w"].float()
    return torch.softmax(logits, dim=-1), logits


def expert_capacity(num_tokens: int, cfg: RouterConfig) -> int:
    """Tokens an expert takes: ``T k cf / N`` rounded up to a multiple of 8,
    at least 8 (upstream's integer arithmetic)."""
    cap = int(num_tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-cap // 8) * 8)


def _top_k(probs: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """(values, indices) of the k largest probs per row, in descending order,
    the lowest index first among equal values (``jax.lax.top_k``'s rule)."""
    idx = []
    rest = probs.detach()
    for _ in range(k):
        i = torch.argmax(rest, dim=-1, keepdim=True)
        idx.append(i)
        if k > 1:  # probs are >= 0: -1 takes a chosen expert out of the running
            rest = rest.scatter(-1, i, -1.0)
    index = torch.cat(idx, dim=-1)
    return torch.gather(probs, -1, index), index


def topk_dispatch(probs: Tensor, cfg: RouterConfig) -> dict:
    """Dispatch metadata of a flat token batch, as upstream: probs (T, N) ->

    * ``expert_index`` (T, k): the chosen expert per token per slot;
    * ``combine_weight`` (T, k): its gate prob, 0 for a dropped token;
    * ``buffer_token`` (N, C): the token feeding each expert slot (T, the
      sentinel, where none does);
    * ``buffer_slot`` (T, k): the (token, slot)'s position in its expert's
      buffer, C when dropped;
    * ``capacity`` C and ``aux_loss``, the Switch load-balancing loss
      ``N sum_i mean(p_i) frac_i * aux_loss_weight`` (frac from the top-1
      choice, without gradient).
    """
    t, n = probs.shape
    k = cfg.top_k
    c = expert_capacity(t, cfg)
    dev = probs.device

    gate_vals, expert_index = _top_k(probs, k)

    # position of each (token, slot) within its expert, via a stable sort
    flat_expert = expert_index.reshape(-1)
    sorted_expert, order = torch.sort(flat_expert, stable=True)
    ar = torch.arange(t * k, device=dev)
    seg_start = torch.searchsorted(sorted_expert, torch.arange(n, device=dev), side="left")
    rank_sorted = ar - seg_start.index_select(0, sorted_expert)
    rank = torch.zeros(t * k, dtype=torch.long, device=dev).scatter(0, order, rank_sorted)
    rank = rank.reshape(t, k)

    kept = rank < c
    combine_weight = torch.where(kept, gate_vals, torch.zeros((), dtype=probs.dtype, device=dev))
    buffer_slot = torch.where(kept, rank, torch.full((), c, dtype=torch.long, device=dev))

    # expert buffers, sentinel t; a dropped (token, slot) writes the sentinel
    # to the spare column c, sliced off below
    tok_ids = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    flat_slot = flat_expert * (c + 1) + buffer_slot.reshape(-1)
    buffer_token = torch.full((n * (c + 1),), t, dtype=torch.long, device=dev).scatter(
        0, flat_slot, torch.where(kept.reshape(-1), tok_ids, t))
    buffer_token = buffer_token.reshape(n, c + 1)[:, :c]

    # means as sum / T, the division rounded once on every device
    me = fdiv(torch.sum(probs, dim=0), float(t))  # mean prob per expert
    top1 = torch.zeros(n, dtype=probs.dtype, device=dev).scatter_add(
        0, expert_index[:, 0], torch.ones(t, dtype=probs.dtype, device=dev))
    ce = fdiv(top1, float(t))  # fraction routed (top-1 slot), no gradient
    aux_loss = torch.sum(me * ce) * n * cfg.aux_loss_weight

    if probes.active() and n > 1:
        # normalized load entropy of the top-1 fractions (1 balanced, 0
        # collapsed): the QAT probe qat_router_entropy
        cf = ce.detach().float()
        ent = -torch.sum(cf * torch.log(cf + 1e-12)) / torch.log(
            torch.full((), float(n), device=dev))
        probes.add_mean("router_entropy", ent, 1.0)

    return {
        "expert_index": expert_index,
        "combine_weight": combine_weight.to(probs.dtype),
        "buffer_token": buffer_token,
        "buffer_slot": buffer_slot,
        "capacity": c,
        "aux_loss": aux_loss,
    }


def dispatch_gather(x: Tensor, dispatch: dict) -> Tensor:
    """Token rows into expert buffers: x (T, D) -> (N, C, D); sentinel slots
    read zeros."""
    d = x.shape[1]
    xz = torch.cat([x, x.new_zeros((1, d))], dim=0)
    bt = dispatch["buffer_token"]
    return xz.index_select(0, bt.reshape(-1)).reshape(*bt.shape, d)


def combine_scatter(y_experts: Tensor, dispatch: dict, num_tokens: int) -> Tensor:
    """Expert outputs back to token order, weighted by the gate prob:
    (N, C, D) -> (T, D).  A dropped (token, slot) reads a zero row."""
    n, c, d = y_experts.shape
    k = dispatch["expert_index"].shape[1]
    flat = dispatch["expert_index"].reshape(-1) * (c + 1) + dispatch["buffer_slot"].reshape(-1)
    yz = torch.cat([y_experts, y_experts.new_zeros((n, 1, d))], dim=1)
    rows = yz.reshape(n * (c + 1), d).index_select(0, flat)
    w = dispatch["combine_weight"].reshape(-1, 1).to(rows.dtype)
    return torch.sum((rows * w).reshape(num_tokens, k, d), dim=1)


def einsum_dispatch_combine(probs: Tensor, cfg: RouterConfig, group_size: int):
    """Grouped one-hot dispatch (Switch / Mesh-TF style), as upstream:
    probs (T, E) with T a multiple of ``group_size`` S ->
    (combine (G, S, E, C), dispatch (G, S, E, C), aux_loss), C the
    capacity of a group of S tokens.

    A (token, slot)'s rank within its expert is the count of earlier
    (token, slot) pairs of its group, in (s, k) order, that chose it (the
    one-hot's cumsum less itself).  The kept gates are scattered into
    ``combine``; a dropped slot adds 0 at rank 0, as upstream's
    ``.at[...].add``.  A token's k experts differ, so no two slots add to
    one element.  ``dispatch`` is ``combine > 0``; the aux loss is the
    sort path's (:func:`topk_dispatch`)."""
    t, e = probs.shape
    k, s = cfg.top_k, group_size
    if t % s:
        raise ValueError(f"{t} tokens do not divide into groups of {s}")
    g = t // s
    dev = probs.device
    gate, idx = _top_k(probs.reshape(g, s, e), k)  # (g, s, k)

    oh = torch.nn.functional.one_hot(idx, e).float().reshape(g, s * k, e)
    pos_before = torch.cumsum(oh, dim=1) - oh
    rank = torch.sum(pos_before * oh, dim=-1).long().reshape(g, s, k)
    c = expert_capacity(s, cfg)
    kept = rank < c

    zero = torch.zeros((), dtype=probs.dtype, device=dev)
    gs = torch.arange(g * s, device=dev).reshape(g, s, 1)
    flat = (gs * e + idx) * c + torch.where(kept, rank, 0)
    combine = torch.zeros(g * s * e * c, dtype=probs.dtype, device=dev).scatter_add(
        0, flat.reshape(-1), torch.where(kept, gate, zero).reshape(-1)).reshape(g, s, e, c)
    dispatch = (combine > 0).to(probs.dtype)

    me = fdiv(torch.sum(probs, dim=0), float(t))
    top1 = torch.zeros(e, dtype=probs.dtype, device=dev).scatter_add(
        0, idx.reshape(-1, k)[:, 0], torch.ones(t, dtype=probs.dtype, device=dev))
    ce = fdiv(top1, float(t))
    aux = torch.sum(me * ce) * e * cfg.aux_loss_weight
    return combine, dispatch, aux


def route_and_apply(router_params, x: Tensor, cfg: RouterConfig,
                    expert_fn: Callable[[Tensor], Tensor]) -> tuple[Tensor, Tensor]:
    """Routed application over a flat token batch x (T, D_in);
    ``expert_fn``: (N, C, D_in) -> (N, C, D_out), batched over experts.
    Returns (y (T, D_out), aux_loss + the router z-loss)."""
    t = x.shape[0]
    probs, logits = router_probs(router_params, x)
    dispatch = topk_dispatch(probs, cfg)
    ye = expert_fn(dispatch_gather(x, dispatch))
    y = combine_scatter(ye, dispatch, t)
    # router z-loss discourages logit blow-up
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1))) * cfg.router_z_weight
    return y, dispatch["aux_loss"] + z.to(dispatch["aux_loss"].dtype)

