"""Port of ``repro.optim.adamw``: AdamW with f32 moments and master
weights, global-norm gradient clipping and schedule-driven decoupled
weight decay (paper Appendix B.2).

Parameter trees are nested dicts and lists of tensors, walked as JAX walks
a pytree (dict keys sorted, list items in order), so the leaf order, the
decay mask and the sum of the global norm follow upstream's.  The update
writes the new parameters and moments into the tensors it is given.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core.quantization import fdiv

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    clip_norm: float = 1.0
    # parameters whose path contains one of these fragments skip weight
    # decay (norms, scalars, biases, and the feature-scaling alpha/beta)
    no_decay_fragments: tuple = ("norm", "alpha", "beta", "lam", "dt_bias", "A_log", "D")


class AdamWState(NamedTuple):
    step: Tensor  # int32, 0-d, on the parameters' device
    mu: Any
    nu: Any


def tree_paths(tree, prefix: tuple = ()):
    """(path, leaf) pairs in JAX's pytree order: dict keys sorted, list and
    tuple items in order; a path is the tuple of keys and indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(tree, flat) -> Any:
    """A tree shaped like ``tree`` whose leaves are ``flat``'s, taken in
    :func:`tree_paths` order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def _zeros_f32(tree):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), tree)


def init_adamw(params) -> AdamWState:
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=_zeros_f32(params), nu=_zeros_f32(params))


def global_norm(tree) -> Tensor:
    """sqrt of the sum over leaves (in tree order) of each leaf's sum of
    squares, in f32."""
    total = 0
    for leaf in tree_leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(total)


def _decay_mask(params, cfg: AdamWConfig):
    """True where a leaf takes weight decay: its path (keys and indices
    joined by "/") holds none of ``cfg.no_decay_fragments`` and it has more
    than one axis.  Upstream's substring rule, kept as it is so that the
    masks agree leaf for leaf: any path with a capital "D" skips decay, and
    a stacked SubLN scale (``.../subln/scale``, 2 axes, no "norm" in its
    path) takes it."""
    def rule(path, leaf):
        keys = "/".join(str(e) for e in path)
        return not (any(f in keys for f in cfg.no_decay_fragments) or leaf.ndim <= 1)

    return tree_unflatten(params, [rule(p, l) for p, l in tree_paths(params)])


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, lr: Tensor, wd: Tensor,
                 cfg: AdamWConfig = AdamWConfig(), watch=None):
    """One AdamW step.  Returns (params, state, metrics) with metrics
    ``grad_norm``, ``lr`` and ``wd`` (device tensors).

    ``watch(path, param, grad)``, when given, is called for each leaf just
    before its update; what it returns, unless None, is called with the
    leaf just after it (the QAT probes compare each leaf's old and new
    values that way, without a copy of the master).

    In place: the new parameters are written into ``params``' tensors and
    the new moments into ``state.mu`` / ``state.nu`` (the returned trees
    hold the same tensors); ``state.step`` is left as it was.  Clone
    first to keep the old values.  The arithmetic is upstream's, in its
    order: clip scale min(1, clip_norm / (gnorm + 1e-9)); bias corrections
    1 - b ** step; decay added to the step before lr multiplies it."""
    gnorm = global_norm(grads)
    scale = torch.clamp(fdiv(cfg.clip_norm, gnorm + 1e-9), max=1.0)
    step = state.step + 1
    b1, b2 = cfg.b1, cfg.b2
    step_f = step.float()
    bc1 = 1.0 - torch.pow(b1, step_f)
    bc2 = 1.0 - torch.pow(b2, step_f)
    mask = tree_leaves(_decay_mask(params, cfg))
    flat = zip(tree_paths(params), tree_leaves(grads), tree_leaves(state.mu),
               tree_leaves(state.nu), mask)
    for (path, p), g, m, v, do_decay in flat:
        after = watch(path, p, g) if watch is not None else None
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.float()
        if do_decay:
            delta = delta + wd * pf
        p.copy_(pf - lr * delta)
        if after is not None:
            after(p)
    metrics = {"grad_norm": gnorm, "lr": lr, "wd": wd}
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), metrics
