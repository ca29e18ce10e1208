#!/usr/bin/env python3
"""The ``decoupled_matmul`` kernel's wgmma route at both trunk widths, on one CUDA card.

    python3 tools/decoupled_variants.py [SRC]

Compiles ``SRC/repro_torch/csrc/decoupled_matmul.cu`` (SRC defaults to this
checkout's ``src``) as the wrapper builds it ("default") and with the
trunk's tiles forced to 128 / 256 columns at every M (``slices_1`` /
``slices_2``, ``-DDM_SLICES``), all ``nvcc`` at once with ``-Xptxas -v``.
It checks ``wide_trunk``'s rule, whose 1.8 ratio (the time of a 256-column
trunk tile over a 128-column one in a long walk) was fitted on an H100 at
pquant-1.3b's shape: the default should time as the faster forced width
at every M.

Holds every variant bit for bit against the plain version, in f32 and
bf16, at each of ``chip_smoke.py``'s phase-3 row counts at pquant-1.3b's
shape (K 2048, N 5024, r 384), then times the variants there in f32, by
turns (the variants in order, then in reverse; CUDA events over back-to-back
launches with the weights rotated past the 50 MB L2, ``chip_smoke._time``).
Prints the card, the compiler's register, spill and wgmma serialization
lines of each variant, one line per row count and, last, one JSON line of
every time.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VARIANTS = (("default", []), ("slices_1", ["-DDM_SLICES=1"]), ("slices_2", ["-DDM_SLICES=2"]))


def build(src: Path, out_dir: Path) -> tuple[dict, str]:
    """Every variant's library, compiled in parallel, and the compiler's
    resource lines of each."""
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _cuda

    csrc = src / "repro_torch" / "csrc"
    procs = {}
    for name, flags in VARIANTS:
        so = out_dir / f"decoupled_{name}.so"
        cmd = [_cuda.nvcc(), *_cuda.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-I", str(csrc), "-o",
               str(so), str(csrc / "decoupled_matmul.cu")]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs, report = {}, []
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.decoupled_matmul_launch.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                                                + [ctypes.c_void_p])
        lib.decoupled_matmul_launch.restype = ctypes.c_int
        libs[name] = lib
        report += [f"{name}: {line.strip()}" for line in log.splitlines()
                   if any(w in line for w in ("entry function", "registers", "spill", "wgmma"))]
    return libs, "\n".join(report)


def main() -> int:
    import torch

    import chip_smoke as cs

    if len(sys.argv) > 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("decoupled_variants: no CUDA device", file=sys.stderr)
        return 2
    src = Path(sys.argv[1]).resolve() if len(sys.argv) == 2 else ROOT / "src"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    k, n, r = cs.DECOUPLED_SHAPE
    copies = cs._copies(k // 8 * n + k * r)
    w1s = [torch.randint(0, 256, (k // 8, n), generator=gen, device=dev, dtype=torch.uint8)
           for _ in range(copies)]
    w8s = [torch.randint(-127, 128, (k, r), generator=gen, device=dev, dtype=torch.int8)
           for _ in range(copies)]
    sc = [torch.full((), v, dtype=torch.float32, device=dev)
          for v in (0.027, 1 / 0.0021, 1.0, 1.0)]
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        libs, report = build(src, Path(tmp))
        print(report, flush=True)
        from repro_torch.kernels.decoupled_matmul import decoupled_matmul_plain

        for m in cs.DECOUPLED_MATMUL_ROWS:
            x = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
            gamma = torch.rand((m,), generator=gen, device=dev) * 50 + 10
            outs = {dt: (torch.empty((m, n), dtype=dt, device=dev),
                         torch.empty((m, r), dtype=dt, device=dev))
                    for dt in (torch.float32, torch.bfloat16)}

            def launch(lib, i, dt=torch.float32):
                y1, y8 = outs[dt]
                err = lib.decoupled_matmul_launch(
                    x.data_ptr(), w1s[i % copies].data_ptr(), w8s[i % copies].data_ptr(),
                    gamma.data_ptr(), *(t.data_ptr() for t in sc), y1.data_ptr(),
                    y8.data_ptr(), 0 if dt == torch.float32 else 1, m, k, n, r, dev.index or 0,
                    stream)
                if err:
                    raise RuntimeError(f"decoupled_matmul_launch: CUDA error {err}")

            for name, lib in libs.items():
                for dt in outs:
                    launch(lib, 0, dt)
                    torch.cuda.synchronize()
                    for got, want in zip(outs[dt], decoupled_matmul_plain(
                            x, w1s[0], w8s[0], gamma, *sc, out_dtype=dt)):
                        if not torch.equal(got, want):
                            err = (got.float() - want.float()).abs().max().item()
                            raise AssertionError(f"{name} at M {m} {dt}: {err} off the plain "
                                                 "version")
            iters = 200 if m * k < 2**24 else 50
            row = {name: [] for name in libs}
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    row[name].append(cs._time(torch, lambda i: launch(libs[name], i), iters) * 1e3)
            times[m] = row
            print(f"M={m}: " + ", ".join(f"{name} {sum(t) / 2:.2f} us ({t[0]:.2f} / {t[1]:.2f})"
                                         for name, t in row.items()), flush=True)
    print(json.dumps({"card": smi, "shape": [k, n, r], "exact": True, "us": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
