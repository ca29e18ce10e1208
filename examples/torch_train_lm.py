"""End-to-end training from the PyTorch port: pre-train a ~100M-parameter
pQuant LM from scratch (QAT-Scratch, paper §4) for a few hundred steps.

    PYTHONPATH=src python examples/torch_train_lm.py                # on the CUDA device
    PYTHONPATH=src python examples/torch_train_lm.py --smoke --device cpu   # 20 steps, reduced

A thin wrapper over the port's launcher (``repro_torch.launch.train``):
the same config system, checkpointing, resume, two-phase schedule and QAT
telemetry as ``examples/train_lm.py`` on the JAX package.  Compare the
baselines with ``--quant-mode {bitnet,bitnet158,none}``.  Artifacts go
under ``--out``: the checkpoints, the history, the lifecycle trace and the
metrics snapshot.
"""

import argparse
import pathlib
import sys

from repro_torch.launch.train import main as train_main


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="20-step reduced variant")
    ap.add_argument("--quant-mode", default="pquant")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    ap.add_argument("--out", default="results/torch_train100m_example")
    args = ap.parse_args()

    pathlib.Path(args.out).mkdir(parents=True, exist_ok=True)
    argv = [
        "--arch", "pquant-100m",
        "--quant-mode", args.quant_mode,
        "--seq-len", "128",
        "--global-batch", "4",
        "--ckpt-dir", f"{args.out}/ckpt",
        "--history-out", f"{args.out}/history.json",
        "--log-every", "10",
        "--probes",
        "--sensitivity-every", "50",
        "--trace-jsonl", f"{args.out}/train_trace.jsonl",
        "--metrics-out", f"{args.out}/train_metrics.json",
    ]
    if args.device:
        argv += ["--device", args.device]
        if args.device == "cpu":
            argv += ["--dtype", "float32"]  # f32 is faster on the CPU
    if args.smoke:
        argv += ["--steps", "20", "--reduced"]
    else:
        argv += ["--steps", str(args.steps)]
    history = train_main(argv)
    steps = [h for h in history if "nll" in h and "event" not in h]
    if steps and steps[-1]["nll"] < steps[0]["nll"]:
        print("OK: loss decreased")
        return 0
    print("WARNING: loss did not decrease")
    return 1


if __name__ == "__main__":
    sys.exit(main())
