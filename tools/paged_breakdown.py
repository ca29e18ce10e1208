#!/usr/bin/env python3
"""Where the time of the ``paged_attention`` kernel goes, on one CUDA card.

    python3 tools/paged_breakdown.py [SRC]

Compiles variants of ``SRC/repro_torch/csrc/paged_attention.cu`` (SRC
defaults to this checkout's ``src``) with the kernel's measurement
switches, all ``nvcc`` at once, and times each at ``chip_smoke.py``'s
phase-3 rows (pquant-1.3b: 16 slots, 32 query heads of 64, blocks of 16,
512 positions a slot; decode over ragged lengths in f32 and bf16 pools and
with 8 KV heads, and a 64-token slice in f32 and bf16), so that the
differences between rows are what each step adds:

* ``context``: the launch, each block's start, kv_lens and table entries,
  and the cluster barrier (``PA_CUT=0``);
* ``copies``: + the cp.async copies of q and the pages (``PA_CUT=1``);
* ``scores``: + the scores, P.V and the block's merge (``PA_CUT=2``);
* ``whole``: the kernel as it runs (the cluster's merge, the output);
* ``splits_S``: the whole kernel with S splits forced (``PA_SPLITS``);
* ``marks``: one launch of the whole kernel built with ``PA_MARKS``, each
  block's %globaltimer at its entry, after its context, at its first
  data, after its walk, after its block merge and at its end, and within
  its first tile after the scores, the softmax and P.V (split route: its
  first warp's first page whole, as "scores"): the span from the first
  entry to the last end, the spread of the entries, the median and the
  slowest block's steps.

Times are CUDA events over back-to-back launches with the pools rotated
past the 50 MB L2 (``chip_smoke._time``).  Prints the card, the
compiler's register and spill count of the whole variant, one line per
row and, last, one JSON line of all rows.
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

VARIANTS = (("context", ["-DPA_CUT=0"]), ("copies", ["-DPA_CUT=1"]), ("scores", ["-DPA_CUT=2"]),
            ("whole", []), ("splits_1", ["-DPA_SPLITS=1"]), ("splits_2", ["-DPA_SPLITS=2"]),
            ("splits_4", ["-DPA_SPLITS=4"]), ("splits_8", ["-DPA_SPLITS=8"]),
            ("marks", ["-DPA_MARKS=1"]))
STEPS = ("context", "first_data", "walk", "block_merge", "finish")
FIRST = ("scores", "softmax", "pv")  # within the first tile (the split route: its first page)


def build(src: Path, out_dir: Path) -> tuple[dict, str]:
    """Every variant's library, compiled in parallel, and the compiler's
    resource report of the whole one."""
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _cuda

    csrc = src / "repro_torch" / "csrc"
    procs = {}
    for name, flags in VARIANTS:
        so = out_dir / f"paged_{name}.so"
        cmd = [_cuda.nvcc(), *_cuda.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-I", str(csrc), "-o",
               str(so), str(csrc / "paged_attention.cu")]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs, report = {}, ""
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.paged_attention_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.paged_attention_launch.restype = ctypes.c_int
        lib.paged_attention_route.argtypes = [ctypes.c_int] * 8
        lib.paged_attention_route.restype = ctypes.c_int
        libs[name] = lib
        if name == "whole":
            report = "\n".join(line for line in log.splitlines()
                               if "registers" in line or "spill" in line)
    return libs, report


def marks(torch, lib, launch, plan_code, b, t, hq, hkv) -> dict:
    """One marking launch; each block's steps from its %globaltimer marks."""
    import statistics

    splits, rows = (plan_code >> 1) & 127, plan_code >> 8
    blocks = splits * hkv * -(-t * (hq // hkv) // rows) * b
    ts = torch.zeros((blocks, 9), dtype=torch.int64, device="cuda")
    lib.paged_attention_set_marks.argtypes = [ctypes.c_void_p]
    if lib.paged_attention_set_marks(ts.data_ptr()):
        raise RuntimeError("paged_attention_set_marks failed")
    launch(lib, 1)
    torch.cuda.synchronize()
    raw = ts.cpu()
    seen = raw > 0  # a mark the block wrote
    m = raw - raw[:, 0].min()
    life = m[:, 5] - m[:, 0]
    res = {"blocks": blocks, "splits": splits, "rows": rows,
           "span_ns": int(m[:, 5].max()), "entry_spread_ns": int(m[:, 0].max())}

    def step(a, b):  # per block: mark b - mark a where both were written
        return m[:, b] - m[:, a], seen[:, a] & seen[:, b]

    def median(d, ok):
        return statistics.median(d[ok].tolist()) if ok.any() else None

    for k, name in enumerate(STEPS):
        res[name + "_median_ns"] = median(*step(k, k + 1))
    res["life_median_ns"] = statistics.median(life.tolist())
    firsts = [step(2, 6), step(6, 7), step(7, 8)]  # the first tile's (or page's) steps
    for name, (d, ok) in zip(FIRST, firsts):
        res["first_" + name + "_median_ns"] = median(d, ok)
    slow = int(life.argmax())
    res["slowest"] = {"block": slow, "entry_ns": int(m[slow, 0])}
    for k, name in enumerate(STEPS):
        d, ok = step(k, k + 1)
        res["slowest"][name + "_ns"] = int(d[slow]) if ok[slow] else None
    for name, (d, ok) in zip(FIRST, firsts):
        res["slowest"]["first_" + name + "_ns"] = int(d[slow]) if ok[slow] else None
    return res


def cases(torch, dev):
    """chip_smoke.py's phase-3 paged rows: (tag, q, pool copies, table,
    start, kv_lens), inputs made as that phase makes them."""
    import chip_smoke as cs

    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    b, bs, d = cs.PA_SLOTS, cs.PA_BLOCK, cs.PA_HEAD_DIM
    mb = cs.PA_MAX_LEN // bs
    nb = b * mb
    lens_decode = torch.randint(1, cs.PA_MAX_LEN + 1, (b,),
                                generator=torch.Generator().manual_seed(cs.SEED))
    lens_decode[0] = cs.PA_MAX_LEN
    rows = (("decode", 1, cs.PA_HEADS, cs.PA_HEADS, torch.float32),
            ("decode", 1, cs.PA_HEADS, cs.PA_HEADS, torch.bfloat16),
            ("decode", 1, cs.PA_HEADS, cs.PA_GQA_KV_HEADS, torch.float32),
            ("chunk", cs.PA_CHUNK, cs.PA_HEADS, cs.PA_HEADS, torch.float32),
            ("chunk", cs.PA_CHUNK, cs.PA_HEADS, cs.PA_HEADS, torch.bfloat16))
    for kind, t, hq, hkv, kv_dtype in rows:
        if kind == "decode":
            kv_lens = lens_decode.clone()
            start = kv_lens - 1
        else:
            start = torch.zeros((b,), dtype=torch.int64)
            start[0] = 256
            kv_lens = torch.ones((b,), dtype=torch.int64)
            kv_lens[0] = 256 + t
        q = torch.randn((b, t, hq, d), generator=gen, device=dev)
        pool_bytes = nb * bs * hkv * d * (4 if kv_dtype == torch.float32 else 2)
        n_copies = max(2, -(-120 * 2**20 // (2 * pool_bytes)))
        pools = [tuple(torch.randn((nb, bs, hkv, d), generator=gen, device=dev).to(kv_dtype)
                       for _ in range(2)) for _ in range(n_copies)]
        table = torch.stack([torch.randperm(nb, generator=gen, device=dev)[:mb]
                             for _ in range(b)]).to(torch.int32)
        tag = f"{kind} T={t} Hq={hq} Hkv={hkv} {str(kv_dtype).split('.')[-1]}"
        yield (tag, q, pools, table, start.to(torch.int32).to(dev),
               kv_lens.to(torch.int32).to(dev))


def main() -> int:
    import torch

    import chip_smoke

    if len(sys.argv) > 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("paged_breakdown: no CUDA device", file=sys.stderr)
        return 2
    src = Path(sys.argv[1]).resolve() if len(sys.argv) == 2 else ROOT / "src"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    out_rows = []
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        libs, report = build(src, Path(tmp))
        print(report, flush=True)
        from repro_torch.kernels.paged_attention import paged_attention_plain

        for tag, q, pools, table, start, lens in cases(torch, dev):
            b, t, hq, d = q.shape
            _, bs, hkv, _ = pools[0][0].shape
            kv_code = 0 if pools[0][0].dtype == torch.float32 else 1
            out = torch.empty_like(q)
            row = {"row": tag}

            def launch(lib, i):
                kp, vp = pools[i % len(pools)]
                err = lib.paged_attention_launch(
                    q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
                    start.data_ptr(), lens.data_ptr(), out.data_ptr(), 0, kv_code, b, t, hq,
                    hkv, d, bs, table.shape[1], d**-0.5, dev.index or 0, stream)
                if err:
                    raise RuntimeError(f"{tag}: CUDA error {err}")

            for name, lib in libs.items():
                if name == "marks":
                    code = lib.paged_attention_route(b, t, hq, hkv, d, bs, table.shape[1],
                                                     kv_code)
                    row["marks"] = marks(torch, lib, launch, code, b, t, hq, hkv)
                    continue

                def call(i, lib=lib):
                    launch(lib, i)

                if name == "whole" or name.startswith("splits"):
                    call(0)
                    want = paged_attention_plain(q, *pools[0], table, start, lens)
                    err = (out - want).abs().max().item()
                    if err > chip_smoke.PA_ATOL:
                        raise AssertionError(f"{name} {tag}: max |err| {err}")
                row[f"{name}_us"] = chip_smoke._time(torch, call, 50) * 1e3
            torch.cuda.synchronize()
            out_rows.append(row)
            print(f"{tag}: " + ", ".join(f"{k[:-3]} {v:.2f} us" for k, v in row.items()
                                         if k.endswith("_us")), flush=True)
            print(f"  marks: {json.dumps(row['marks'])}", flush=True)
            del pools
    print(json.dumps({"card": smi, "src": str(src), "rows": out_rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
