"""Port of ``repro.optim.schedule``: the two-phase LR / weight-decay
schedule of the paper (Appendix B.2, Figure 9) and the cosine schedule of
the FP16 baselines.

``lr(step)`` and ``wd(step)`` take the step as a tensor (or a number) and
return f32 tensors on its device, so a training step reads its schedule
without a host sync.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.quantization import fdiv

Tensor = torch.Tensor


def _f32(step) -> Tensor:
    return torch.as_tensor(step).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class TwoPhaseSchedule:
    """Phase 1 [0, mid): warmup, then linear decay from peak_lr to
    phase2_lr, weight decay 0.1.  Phase 2 [mid, end): linear from
    phase2_lr to final_lr, no weight decay."""

    peak_lr: float = 1.5e-3
    phase2_lr: float = 1e-4
    final_lr: float = 1e-5
    warmup_steps: int = 500
    total_steps: int = 10000
    midpoint_frac: float = 0.5
    wd_phase1: float = 0.1
    wd_phase2: float = 0.0

    @property
    def mid(self) -> int:
        return int(self.total_steps * self.midpoint_frac)

    def lr(self, step) -> Tensor:
        s = _f32(step)
        warm = fdiv(self.peak_lr * s, float(max(self.warmup_steps, 1)))
        mid = float(self.mid)
        p1 = self.peak_lr + (self.phase2_lr - self.peak_lr) * fdiv(
            s - self.warmup_steps, max(mid - self.warmup_steps, 1.0))
        p2 = self.phase2_lr + (self.final_lr - self.phase2_lr) * fdiv(
            s - mid, max(self.total_steps - mid, 1.0))
        out = torch.where(s < self.warmup_steps, warm, torch.where(s < mid, p1, p2))
        return torch.clamp(out, min=0.0)

    def wd(self, step) -> Tensor:
        s = _f32(step)
        return torch.where(s < self.mid, self.wd_phase1, self.wd_phase2).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class CosineSchedule:
    """Baseline (FP16) schedule: warmup, cosine decay, constant WD."""

    peak_lr: float = 3e-4
    final_lr: float = 3e-5
    warmup_steps: int = 500
    total_steps: int = 10000
    weight_decay: float = 0.1

    def lr(self, step) -> Tensor:
        s = _f32(step)
        warm = fdiv(self.peak_lr * s, float(max(self.warmup_steps, 1)))
        t = fdiv(s - self.warmup_steps, max(self.total_steps - self.warmup_steps, 1.0))
        t = torch.clamp(t, 0.0, 1.0)
        cos = self.final_lr + 0.5 * (self.peak_lr - self.final_lr) * (
            1.0 + torch.cos(math.pi * t))
        return torch.where(s < self.warmup_steps, warm, cos)

    def wd(self, step) -> Tensor:
        return torch.full_like(_f32(step), self.weight_decay)


def schedule_for_mode(quant_mode: str, total_steps: int, peak_lr: float | None = None):
    warmup = min(500, max(10, total_steps // 20))
    if quant_mode == "none":
        return CosineSchedule(total_steps=total_steps, peak_lr=peak_lr or 3e-4,
                              warmup_steps=warmup)
    return TwoPhaseSchedule(total_steps=total_steps, peak_lr=peak_lr or 1.5e-3,
                            warmup_steps=warmup)
