"""Port of ``repro.launch.train``: the training launcher, one process on
one device.

  python -m repro_torch.launch.train --arch pquant-300m --steps 200 \
      --seq-len 512 --global-batch 8 --ckpt-dir ckpt

runs on the CUDA device; ``--device cpu`` runs on the CPU (the port never
drops to it on its own).  Fault tolerance: checkpoints are atomic and
asynchronous, and a restart with the same flags resumes from the latest
one.  Multi-process training (``--coordinator``, ``--num-processes`` > 1)
is not ported yet: it waits for ``torch.distributed`` (ROADMAP queue 1
item 7) and raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
from typing import Optional

from repro_torch.configs.registry import get_config, reduced
from repro_torch.data.pipeline import DataConfig, PrefetchIterator, SyntheticSource, TextFileSource
from repro_torch.train.trainer import Trainer, TrainerConfig


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--quant-mode", default="pquant",
                    choices=["pquant", "bitnet", "bitnet158", "none"])
    ap.add_argument("--n-experts", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (CPU-scale) variant of the arch")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--peak-lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", default=None, help="text file path (default: synthetic)")
    ap.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                    help="model compute dtype override (f32 is faster on the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--history-out", default=None)
    # telemetry (name registry and trace format: repro_torch.telemetry)
    ap.add_argument("--probes", action="store_true",
                    help="QAT health probes in the step metrics")
    ap.add_argument("--sensitivity-every", type=int, default=0,
                    help="democratization snapshot cadence in steps (0=off)")
    ap.add_argument("--trace-jsonl", default=None,
                    help="stream the run lifecycle trace (JSONL) here")
    ap.add_argument("--history-jsonl", default=None,
                    help="stream history records as JSONL instead of holding them in host memory")
    ap.add_argument("--metrics-out", default=None,
                    help="write the trainer's metrics snapshot (validate_snapshot schema) as "
                         "JSON on exit")
    # multi-process: not ported yet
    ap.add_argument("--coordinator", default=None, help="not ported yet")
    ap.add_argument("--num-processes", type=int, default=1, help="not ported yet (1 only)")
    ap.add_argument("--process-id", type=int, default=0)
    return ap


def main(argv: Optional[list[str]] = None):
    args = build_argparser().parse_args(argv)
    if args.coordinator or args.num_processes > 1:
        raise NotImplementedError(
            "multi-process training is not ported yet: it waits for torch.distributed "
            "(ROADMAP queue 1 item 7)")

    cfg = get_config(args.arch, quant_mode=args.quant_mode, n_experts=args.n_experts)
    if args.reduced:
        cfg = reduced(cfg)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)

    dcfg = DataConfig(seq_len=args.seq_len, global_batch=args.global_batch, seed=args.seed)
    if args.data:
        source = TextFileSource([args.data])
        if source.vocab > cfg.vocab_size:
            raise ValueError(f"tokenizer vocab {source.vocab} exceeds the model's "
                             f"{cfg.vocab_size}")
    else:
        source = SyntheticSource(cfg.vocab_size, seed=args.seed)

    tcfg = TrainerConfig(
        total_steps=args.steps,
        log_every=args.log_every,
        ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        accum=args.accum,
        seed=args.seed,
        peak_lr=args.peak_lr,
        probes=args.probes,
        sensitivity_every=args.sensitivity_every,
        trace_path=args.trace_jsonl,
        history_path=args.history_jsonl,
    )
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    data = PrefetchIterator(source, dcfg)
    try:
        trainer = Trainer(cfg, tcfg, data, device=args.device)
        history = trainer.run()
    finally:
        data.close()
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(history, f)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(trainer.snapshot(), f, indent=2)
    final = [h for h in history if "loss" in h and "event" not in h]
    if final:
        logging.getLogger(__name__).info("final loss: %.4f (recoveries: %d)",
                                         final[-1]["loss"], trainer.recoveries)
    return history


if __name__ == "__main__":
    main()
