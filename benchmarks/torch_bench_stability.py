"""Figure 10 on the PyTorch port: training stability at aggressive
hyperparameters.

The paper observes BitNet training spike or diverge at large batch and LR
and need checkpoint rollbacks, while pQuant stays stable.  This trains
both at a deliberately hot LR through ``repro_torch.train.trainer.Trainer``
and counts instability events (non-finite or > 2x loss spikes).

    PYTHONPATH=src python benchmarks/torch_bench_stability.py [--smoke] [--device cpu]

Runs on the CUDA device unless ``--device`` says otherwise.  With
``smoke`` the pQuant leg runs with the QAT probes on and writes the
trainer's telemetry artifacts (``metrics_out``: the ``validate_snapshot``
metrics snapshot; ``trace_out``: the JSONL lifecycle trace).  Prints
``name,us_per_call,derived`` CSV rows, as ``benchmarks/bench_stability.py``
does; its helpers (``benchmarks/common.py``) import the JAX package, so
this file keeps its own.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig
from repro_torch.data.pipeline import DataConfig, SyntheticSource, host_batch
from repro_torch.train.trainer import Trainer, TrainerConfig


def row(name: str, us_per_call: float, derived: str = "") -> str:
    line = f"{name},{us_per_call:.2f},{derived}"
    print(line)
    return line


def tiny_config(quant_mode: str = "pquant", d_model: int = 64, d_ff: int = 128, r: int = 16,
                n_layers: int = 2, vocab: int = 256) -> ModelConfig:
    """The small decoder of ``benchmarks.common.tiny_config`` (one 8-bit
    branch)."""
    qc = QuantConfig(mode=quant_mode, r=r if quant_mode == "pquant" else 0, num_experts=1)
    return ModelConfig(name=f"bench-{quant_mode}-n1", family="decoder", n_layers=n_layers,
                       d_model=d_model, n_heads=4, n_kv_heads=4, d_ff=d_ff, vocab_size=vocab,
                       max_seq_len=64, quant=qc)


def quick_train(cfg: ModelConfig, steps: int = 80, seq: int = 32, batch: int = 8, seed: int = 0,
                peak_lr: float | None = None, device=None, **tcfg_kw):
    """Train on the synthetic corpus; returns (history, trainer).  Extra
    keyword arguments go to :class:`TrainerConfig`."""
    src = SyntheticSource(cfg.vocab_size, seed=seed)
    dcfg = DataConfig(seq_len=seq, global_batch=batch, seed=seed)

    def it():
        for s in range(steps + 1):
            yield s, host_batch(src, dcfg, s)

    tcfg = TrainerConfig(total_steps=steps, log_every=10**9, ckpt_every=10**9,
                         peak_lr=peak_lr, **tcfg_kw)
    tr = Trainer(cfg, tcfg, it(), device=device)
    return tr.run(), tr


def _steps_only(hist):
    # the history interleaves step records with lifecycle events (recovery)
    return [h for h in hist if "loss" in h and "event" not in h]


def _spikes(hist) -> int:
    losses = [h["loss"] for h in _steps_only(hist)]
    return sum(1 for a, b in zip(losses, losses[1:]) if not np.isfinite(b) or b > a * 2.0)


def run(steps: int = 100, smoke: bool = False, metrics_out: str | None = None,
        trace_out: str | None = None, device=None) -> dict:
    if smoke:
        steps = min(steps, 12)
    out = {}
    for mode in ("bitnet", "pquant"):
        tcfg_kw = {}
        if mode == "pquant" and (smoke or metrics_out or trace_out):
            tcfg_kw = {"probes": True, "sensitivity_every": max(steps // 2, 1),
                       "trace_path": trace_out}
        t0 = time.perf_counter()
        hist, tr = quick_train(tiny_config(mode), steps=steps, peak_lr=2e-2, device=device,
                               **tcfg_kw)
        us = (time.perf_counter() - t0) * 1e6 / max(len(hist), 1)
        step_hist = _steps_only(hist)
        out[mode] = {"spikes": _spikes(hist), "recoveries": tr.recoveries,
                     "final": step_hist[-1]["loss"] if step_hist else float("nan")}
        row(f"fig10/stability/{mode}", us,
            f"spikes={out[mode]['spikes']};final={out[mode]['final']:.3f}")
        if mode == "pquant" and metrics_out:
            with open(metrics_out, "w") as f:
                json.dump(tr.snapshot(), f, indent=2)
    row("fig10/pquant_no_less_stable", 0.0,
        f"ok={out['pquant']['spikes'] <= out['bitnet']['spikes']}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--trace-out", default=None)
    a = ap.parse_args()
    run(a.steps, a.smoke, a.metrics_out, a.trace_out, a.device)
