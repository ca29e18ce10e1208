"""Port of ``repro.train.trainer``'s training step: the QAT ``train_step``
with gradient accumulation (the ``Trainer`` loop, checkpoints and probes
are not ported yet).

Semantics (paper §3.1 / Appendix B): the latent master weights are f32;
the forward casts them to the model dtype (``cfg.dtype``, bf16 by default)
and fake-quantizes (weights 1-bit / ternary / INT8, activations INT8) with
straight-through gradients, which land on the f32 master; AdamW with the
two-phase LR / WD schedule updates the master in place.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    adamw_update,
    init_adamw,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.optim.schedule import schedule_for_mode
from repro_torch.telemetry.tracing import annotate

Tensor = torch.Tensor


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def init_train_state(seed, cfg: ModelConfig, device=None) -> TrainState:
    """f32 latent parameters from ``seed`` and a fresh AdamW state, on
    ``device`` (default: the CUDA device; raises without one)."""
    params = api.init_model(seed, cfg, device=resolve_device(device))
    return TrainState(params=params, opt=init_adamw(params))


def cast_for_forward(params, dtype):
    """Latent f32 master -> the model dtype for the quantized forward; other
    leaves stay as they are.  Differentiable: the gradients of the cast
    leaves come back to the master in f32."""
    if dtype == torch.float32:
        return params
    return tree_map(lambda p: p.to(dtype) if p.dtype == torch.float32 else p, params)


def make_train_step(
    cfg: ModelConfig,
    total_steps: int,
    accum: int = 1,
    adamw_cfg: AdamWConfig = AdamWConfig(),
    peak_lr: Optional[float] = None,
) -> Callable:
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` holds "tokens" and "labels" (B, S) and may hold a "mask".
    ``accum`` > 1 splits the batch's leading axis into that many
    microbatches, run one after another on the same parameters, with the
    gradients accumulated in f32 as g / accum and the loss as loss / accum;
    the other metrics are the last microbatch's.  Metrics ``loss``,
    ``nll``, ``grad_norm``, ``lr`` and ``wd`` are f32 device tensors, and
    the step makes no host sync.

    In place: the step writes the new master weights and moments into
    ``state``'s tensors (a second copy of the master would cost its size
    again); the returned state holds the same tensors and a new step count.
    """
    sched = schedule_for_mode(cfg.quant.mode, total_steps, peak_lr)
    model_dtype = getattr(torch, cfg.dtype)

    def grads_one(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss, metrics = api.loss_fn(cast_for_forward(leaves, model_dtype), batch, cfg)
            # a leaf the mode leaves unused (the FFN SubLN of "none") gets zeros, as in JAX
            flat = torch.autograd.grad(loss, tree_leaves(leaves), materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, tree_unflatten(params, flat)

    def compute_grads(params, batch):
        if accum == 1:
            return grads_one(params, batch)
        b = batch["tokens"].shape[0]
        if b % accum:
            raise ValueError(f"batch {b} does not split into {accum} microbatches")
        mb = b // accum
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                         params)
        loss_acc = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        with annotate("train/accum"):
            for i in range(accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, metrics, g = grads_one(params, micro)
                for a, gi in zip(tree_leaves(g_acc), tree_leaves(g)):
                    a.add_(gi.float() / accum)
                loss_acc = loss_acc + loss / accum
        return loss_acc, metrics, g_acc

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        with annotate("train/grads"):
            loss, metrics, grads = compute_grads(state.params, batch)
        step = state.opt.step
        lr = sched.lr(step)
        wd = sched.wd(step)
        with annotate("train/update"):
            params, opt, opt_metrics = adamw_update(
                grads, state.opt, state.params, lr, wd, adamw_cfg)
        out = {"loss": loss.float(), "nll": metrics["nll"].float(), **opt_metrics}
        return TrainState(params=params, opt=opt), out

    return train_step

