#!/usr/bin/env python3
"""The ``rmsnorm_quant`` kernel's warp route in its measured variants, on one CUDA card.

    python3 tools/rmsnorm_variants.py [--also NAME=FILE ...] [SRC]

Compiles ``SRC/repro_torch/csrc/rmsnorm_quant.cu`` (SRC defaults to this
checkout's ``src``) as the wrapper builds it ("default") and with the
warps a row forced to 1, 2, 4 and 8 (``-DRQ_SPLIT``), and each ``--also``
source as it is (say the parent commit's ``rmsnorm_quant.cu``, from a
``git archive`` unpacked under ``_checkouts/``; its C entry point must
take the same arguments), all ``nvcc`` at once with ``-Xptxas -v``.  It
checks the ``row_warps`` rule: the default should time as the fastest
forced width at every row count, within a few percent.

Holds every variant against the plain version within ``chip_smoke.py``'s
stated tolerance (``RMSNORM_*``) at 33-8192 rows (``ROWS``: phase 3's row
counts and the ones between, where the rule switches) at d_model 2048 in
bf16 and f32, then times them there by turns (the variants in order, in
reverse, in order, in reverse; CUDA events over back-to-back launches
with the rows rotated past the 50 MB L2, ``chip_smoke._time``) and
reports each one's median.  Prints the card, each variant's register and
spill lines, one line per row count and type, and, last, one JSON line
of every time with the byte bound of each row.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VARIANTS = (
    ("default", []),
    ("split_1", ["-DRQ_SPLIT=1"]),
    ("split_2", ["-DRQ_SPLIT=2"]),
    ("split_4", ["-DRQ_SPLIT=4"]),
    ("split_8", ["-DRQ_SPLIT=8"]),
)
ROWS = (33, 64, 128, 256, 512, 1024, 2048, 8192)
TURNS = 4  # the variants in order, in reverse, in order, in reverse


def build(src: Path, also: dict[str, Path], out_dir: Path) -> tuple[dict, str]:
    """Every variant's library, compiled in parallel, and the compiler's
    resource lines of each."""
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _cuda

    cu = src / "repro_torch" / "csrc" / "rmsnorm_quant.cu"
    jobs = [(name, flags, cu) for name, flags in VARIANTS]
    jobs += [(name, [], path) for name, path in also.items()]
    procs = {}
    for name, flags, path in jobs:
        so = out_dir / f"rmsnorm_{name}.so"
        cmd = [_cuda.nvcc(), *_cuda.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-I", str(path.parent),
               "-o", str(so), str(path)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs, report = {}, []
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        f = lib.rmsnorm_quant_launch
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                                                   ctypes.c_void_p]
        f.restype = ctypes.c_int
        libs[name] = lib
        report += [f"{name}: {line.strip()}" for line in log.splitlines()
                   if any(w in line for w in ("entry function", "registers", "spill"))]
    return libs, "\n".join(report)


def main() -> int:
    import torch

    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", nargs="?", default=str(ROOT / "src"))
    ap.add_argument("--also", action="append", default=[], metavar="NAME=FILE",
                    help="another rmsnorm_quant.cu to build and time beside, as NAME")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rmsnorm_variants: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    also = {n: Path(f).resolve() for n, f in (a.split("=", 1) for a in args.also)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    bw = 3.35e12
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    d = cs.D_MODEL
    scale = torch.rand((d,), generator=gen, device=dev) + 0.5
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        libs, report = build(src, also, Path(tmp))
        print(report, flush=True)
        from repro_torch.kernels.rmsnorm_quant import rmsnorm_quant_plain

        for dt in (torch.bfloat16, torch.float32):
            code = 0 if dt == torch.float32 else 1
            for m in ROWS:
                xs = [(torch.randn((m, d), generator=gen, device=dev) * 3).to(dt)
                      for _ in range(cs._copies(m * d * dt.itemsize))]
                q = torch.empty((m, d), dtype=torch.int8, device=dev)
                g = torch.empty((m,), dtype=torch.float32, device=dev)

                def launch(lib, i):
                    err = lib.rmsnorm_quant_launch(
                        xs[i % len(xs)].data_ptr(), scale.data_ptr(), q.data_ptr(),
                        g.data_ptr(), code, m, d, 1e-6, dev.index or 0, stream)
                    if err:
                        raise RuntimeError(f"rmsnorm_quant_launch: CUDA error {err}")

                q_ref, g_ref = rmsnorm_quant_plain(xs[0], scale)
                for name, lib in libs.items():
                    launch(lib, 0)
                    torch.cuda.synchronize()
                    try:
                        cs._codes_close(q, q_ref, g, g_ref)
                    except AssertionError as e:
                        raise AssertionError(f"{name} at M {m} {dt}: {e}") from None
                iters = 200 if m * d < 2**24 else 50
                row = {name: [] for name in libs}
                for turn in range(TURNS):
                    for name in list(libs)[::-1] if turn % 2 else list(libs):
                        row[name].append(cs._time(torch, lambda i: launch(libs[name], i),
                                                  iters) * 1e3)
                bound_us = (m * d * dt.itemsize + d * 4 + m * d + m * 4) / bw * 1e6
                key = f"{m}x{d} {str(dt)[6:]}"
                times[key] = {"bound_us": bound_us, **row}
                print(f"{key} (bound {bound_us:.2f} us), median of {TURNS} turns: " + ", ".join(
                    f"{name} {statistics.median(t):.2f} us ({' / '.join(f'{u:.2f}' for u in t)})"
                    for name, t in row.items()), flush=True)
    print(json.dumps({"card": smi, "held": True, "us": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
