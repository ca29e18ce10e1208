"""Port of ``repro.train.trainer``: the QAT ``train_step`` with gradient
accumulation and the on-device QAT probes, and the single-host
:class:`Trainer` loop around it (checkpoints, resume, auto-recovery,
heartbeat, history, trace, metrics registry).

Semantics (paper §3.1 / Appendix B): the latent master weights are f32;
the forward casts them to the model dtype (``cfg.dtype``, bf16 by default)
and fake-quantizes (weights 1-bit / ternary / INT8, activations INT8) with
straight-through gradients, which land on the f32 master; AdamW with the
two-phase LR / WD schedule updates the master in place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import os
import tempfile
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
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
from repro_torch.telemetry import probes as qprobes
from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.telemetry.tracing import JsonlSink, TrainTracer, annotate, maybe_profile

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
    probes: bool = False,
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

    ``probes=True`` adds the QAT health probes (name registry in
    ``repro_torch.telemetry``) to the metrics, all device scalars: the
    forward's taps (collected while the loss is computed, before the
    gradients are asked for, so remat's second forward records nothing)
    and the param/grad-side probes, taken leaf by leaf around the in-place
    update (``telemetry.probes.ParamProbes``).  With ``probes=False`` the
    step runs no probe op.  The encdec family runs with the probes off
    whatever ``probes`` says, as upstream (whose encoder-decoder layer scan
    has no probe drain points).
    """
    probes = bool(probes) and cfg.family != "encdec"
    sched = schedule_for_mode(cfg.quant.mode, total_steps, peak_lr)
    model_dtype = getattr(torch, cfg.dtype)

    def grads_one(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            with qprobes.collect() if probes else contextlib.nullcontext():
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
        param_probes = qprobes.ParamProbes() if probes else None
        with annotate("train/update"):
            params, opt, opt_metrics = adamw_update(
                grads, state.opt, state.params, lr, wd, adamw_cfg,
                watch=param_probes.watch if param_probes else None)
        out = {"loss": loss.float(), "nll": metrics["nll"].float(), **opt_metrics}
        if probes:
            out.update({k: v.float() for k, v in metrics.items() if k.startswith("qat_")})
            with annotate("train/probes"):
                out.update(param_probes.result())
        return TrainState(params=params, opt=opt), out

    return train_step


# ---------------------------------------------------------------------------
# Single-host Trainer (examples, benchmarks, launch/train.py)
# ---------------------------------------------------------------------------

_log = logging.getLogger("repro.train")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 200
    log_every: int = 10
    ckpt_every: int = 100
    ckpt_dir: Optional[str] = None
    accum: int = 1
    seed: int = 0
    peak_lr: Optional[float] = None
    # fault tolerance: reload the last checkpoint if the loss goes
    # non-finite (paper Fig. 10: BitNet needs this; pQuant shouldn't)
    auto_recover: bool = True
    # heartbeat file for an orchestrator's straggler / hang detection
    heartbeat_path: Optional[str] = os.environ.get("REPRO_HEARTBEAT")
    # --- telemetry (name registry and trace format: repro_torch.telemetry) ---
    # QAT health probes in the per-step metrics
    probes: bool = False
    # cadence (steps) of the democratization snapshot; 0 = off
    sensitivity_every: int = 0
    # JSONL run-lifecycle trace (TrainTracer); None = no trace
    trace_path: Optional[str] = None
    # stream history records to this JSONL path instead of holding them in
    # a host list (run() then returns an empty list)
    history_path: Optional[str] = None


def _write_atomic(path: str, text: str) -> None:
    """Crash-atomic small-file write: a temporary file in the same
    directory, fsync, ``os.replace``; a reader or a crash sees the old or
    the new content, never a torn write (a torn heartbeat would look like a
    hang to an orchestrator)."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    ok = False
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        ok = True
    finally:
        if not ok:
            try:
                os.unlink(tmp)
            except OSError:
                pass


class Trainer:
    """Single-host training loop with the shared observability tier:

    * ``metrics``: a :class:`~repro_torch.telemetry.metrics.MetricsRegistry`
      (its own by default, or injected) updated every step; :meth:`snapshot`
      exports the ``validate_snapshot`` schema.  Counters
      ``train_steps_total``, ``train_restores_total``,
      ``train_recoveries_total``, ``train_checkpoints_total``; histogram
      ``train_step_seconds``; gauges ``train_loss``, ``train_nll``,
      ``train_lr``, ``train_wd``, ``train_grad_norm``, ``train_step`` and
      every ``qat_*`` / ``demo_*`` value.
    * ``tracer``: a :class:`~repro_torch.telemetry.tracing.TrainTracer` on
      ``tcfg.trace_path`` (or injected), streaming the run lifecycle as
      JSONL: ``run_start``, step records, ``checkpoint``, ``restore``,
      ``recovery``, ``heartbeat``, ``run_end``.
    * logging through the ``repro.train`` logger: a one-line summary at
      ``log_every`` on INFO, a JSON record a step on DEBUG.
    * ``REPRO_PROFILE_DIR`` captures a profiler trace of :meth:`run`.

    The state lives on ``device`` (default: the CUDA device; the port never
    drops to the CPU on its own) and the step updates it in place.  A step
    makes one host sync: its metrics, stacked into one tensor, come to the
    host in one copy.  Batches (numpy, from ``data_iter``'s ``(step,
    batch)`` pairs) go to the card from pinned memory without blocking.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainerConfig,
        data_iter,
        metrics: Optional[MetricsRegistry] = None,
        tracer: Optional[TrainTracer] = None,
        device=None,
    ):
        self.cfg, self.tcfg = cfg, tcfg
        self.data = data_iter
        self.device = resolve_device(device)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._owns_tracer = tracer is None and tcfg.trace_path is not None
        if tracer is not None:
            self.tracer = tracer
        elif tcfg.trace_path:
            self.tracer = TrainTracer(JsonlSink(tcfg.trace_path))
        else:
            self.tracer = None
        self.state = init_train_state(tcfg.seed, cfg, device=self.device)
        self.step_fn = make_train_step(cfg, tcfg.total_steps, tcfg.accum,
                                       peak_lr=tcfg.peak_lr, probes=tcfg.probes)
        self.ckpt = Checkpointer(tcfg.ckpt_dir) if tcfg.ckpt_dir else None
        self.history: list[dict] = []
        self.recoveries = 0
        self.start_step = 0
        if self.ckpt and self.ckpt.latest_step() is not None:
            self._restore()

    def _tree(self) -> dict:
        """The checkpointed tree: ``{"params", "opt"}``."""
        return {"params": self.state.params, "opt": self.state.opt}

    def _restore(self, step: Optional[int] = None):
        """Every leaf of the state, the step count included, from checkpoint
        ``step`` (default: the latest), in place."""
        self.ckpt.restore(self._tree(), step=step)
        self.start_step = int(self.state.opt.step)
        self.metrics.counter("train_restores_total").inc()
        if self.tracer:
            self.tracer.emit("restore", step=self.start_step, from_step=self.start_step)

    def snapshot(self) -> dict:
        """The run's metrics in the ``validate_snapshot`` schema."""
        return self.metrics.snapshot()

    def _batch(self, batch: dict) -> dict:
        cuda = self.device.type == "cuda"
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = (t.pin_memory().to(self.device, non_blocking=True) if cuda
                      else t.to(self.device))
        return out

    def _record(self, rec: dict, hist_f) -> None:
        """History record: streamed as JSONL (``history_path``) or appended
        to the in-memory list; mirrored to the tracer and to the DEBUG log."""
        if hist_f is not None:
            hist_f.write(json.dumps(rec, sort_keys=True) + "\n")
            hist_f.flush()
        else:
            self.history.append(rec)
        if self.tracer:
            event = rec.get("event", "step")
            fields = {k: v for k, v in rec.items() if k not in ("step", "event")}
            self.tracer.emit(event, step=rec["step"], **fields)
        if _log.isEnabledFor(logging.DEBUG):
            _log.debug("%s", json.dumps(rec, sort_keys=True))

    def _gauges(self, rec: dict) -> None:
        g = self.metrics.gauge
        for k, v in rec.items():
            if k == "step":
                g("train_step").set(v)
            elif k in ("loss", "nll", "lr", "wd", "grad_norm"):
                g("train_" + k).set(v)
            elif k.startswith(("qat_", "demo_")):
                g(k).set(v)

    def run(self) -> list[dict]:
        tcfg = self.tcfg
        hist_f = open(tcfg.history_path, "a") if tcfg.history_path else None
        steps_total = self.metrics.counter("train_steps_total")
        step_seconds = self.metrics.histogram("train_step_seconds")
        if self.tracer:
            self.tracer.emit(
                "run_start", step=self.start_step, arch=self.cfg.name,
                quant=self.cfg.quant.mode, total_steps=tcfg.total_steps,
            )
        t_last = time.time()
        try:
            with maybe_profile("train"):
                for step, batch in self.data:
                    if step < self.start_step:
                        continue
                    if step >= tcfg.total_steps:
                        break
                    tb = self._batch(batch)
                    t0 = time.time()
                    self.state, metrics = self.step_fn(self.state, tb)
                    names = list(metrics)
                    # the one host sync of a step: every metric in one copy
                    rec = dict(zip(names, torch.stack([metrics[k] for k in names]).tolist()))
                    loss = rec["loss"]
                    dt_step = time.time() - t0
                    if not math.isfinite(loss) and tcfg.auto_recover and self.ckpt:
                        # fault path: reload the last good checkpoint (paper
                        # Fig. 10), recorded in the history and the trace
                        self.recoveries += 1
                        self._restore()
                        self.metrics.counter("train_recoveries_total").inc()
                        rec = {
                            "step": step, "event": "recovery", "loss": loss,
                            "from_step": self.start_step, "recoveries": self.recoveries,
                        }
                        self._record(rec, hist_f)
                        _log.warning("step %d: non-finite loss, restored from step %d "
                                     "(recovery #%d)", step, self.start_step, self.recoveries)
                        continue
                    rec["step"] = step
                    rec["step_time_s"] = dt_step
                    if tcfg.sensitivity_every > 0 and step % tcfg.sensitivity_every == 0:
                        rec.update(qprobes.sensitivity_snapshot(self.state.params))
                    self._record(rec, hist_f)
                    steps_total.inc()
                    step_seconds.observe(dt_step)
                    self._gauges(rec)
                    if tcfg.heartbeat_path:
                        _write_atomic(tcfg.heartbeat_path, str(step))
                    if step % tcfg.log_every == 0:
                        dt = time.time() - t_last
                        t_last = time.time()
                        _log.info("step %5d loss %.4f nll %.4f lr %.2e gnorm %.2f (%.1fs)",
                                  step, rec["loss"], rec["nll"], rec["lr"], rec["grad_norm"], dt)
                        if self.tracer:
                            self.tracer.emit("heartbeat", step=step)
                    if self.ckpt and step > 0 and step % tcfg.ckpt_every == 0:
                        self.ckpt.save(step, self._tree())
                        self.metrics.counter("train_checkpoints_total").inc()
                        if self.tracer:
                            self.tracer.emit("checkpoint", step=step)
            if self.ckpt:
                final = int(self.state.opt.step)
                self.ckpt.save(final, self._tree())
                self.ckpt.wait()
                self.metrics.counter("train_checkpoints_total").inc()
                if self.tracer:
                    self.tracer.emit("checkpoint", step=final)
            if self.tracer:
                self.tracer.emit("run_end", step=int(self.state.opt.step),
                                 recoveries=self.recoveries)
        finally:
            if hist_f is not None:
                hist_f.close()
            if self._owns_tracer and self.tracer:
                self.tracer.close()
        return self.history
