#!/usr/bin/env python3
"""Where the time of a decode GEMV design goes, on one CUDA card.

    python3 tools/gemv_breakdown.py dp4a SRC
    python3 tools/gemv_breakdown.py mma [SRC]

Each form compiles variants of one design's ``w1a8_gemv`` kernel (f32 in,
f32 out) against the headers of ``SRC/repro_torch/csrc`` and times each
at the pquant-1.3b shapes (K 2048 and 5024, N 2048) and M in {1, 8, 16,
32}.

``dp4a``: the design whose ``gemv_common.cuh`` still holds
``quantize_rows`` and ``packed_column`` (SRC is then the ``src/`` tree of
such a commit, say a ``git archive`` unpacked under ``_checkouts/``):

* ``whole``: the kernel as it is (act-quant of all M x K activations in
  every block, then one pass over the weight slice per 8 token rows);
* ``quant``: the act-quant alone (the product skipped);
* ``product``: the product and the reduction alone (the shared-memory
  codes are left as they are: no activation is read).

``mma``: the tensor-core design of ``gemv_mma.cuh`` (SRC defaults to this
checkout's ``src``), cut after each of its steps, so that the differences
between rows are what each step adds:

* ``launch``: the cluster launch alone (each block writes one value);
* ``stage``: + the weight slice's cp.async staging;
* ``quant``: + the act-quant with its DSMEM exchange (and one more
  cluster barrier, so that no block leaves while another reads it);
* ``mma``: + the MMAs over the slice (and that barrier);
* ``whole``: the kernel as ``w1a8_gemv`` runs it.

Times are CUDA events over back-to-back launches with the weights rotated
past the 50 MB L2 (``chip_smoke._time``, ``chip_smoke._copies``).  Prints
the card, the compiler's register and spill count of each variant, one
line per row and, last, one JSON line of all rows.
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

SHAPES = ((2048, 2048), (5024, 2048))
ROWS = (1, 8, 16, 32)
DP4A_MODES = ("whole", "quant", "product")
MMA_MODES = ("launch", "stage", "quant", "mma", "whole")

DP4A_SOURCE = r"""
#include "gemv_common.cuh"
#include "tile_gemm.cuh"

using namespace repro;
namespace rt = repro_tile;

// kMode 0: the whole kernel; 1: the act-quant alone; 2: the product alone.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
variant(const float* __restrict__ x, const uint8_t* __restrict__ wp,
        const float* __restrict__ lam_p, float* __restrict__ out, int m, int k, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SmemPlan p = smem_plan(m, k);
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  float* gamma = reinterpret_cast<float*>(smem + p.gamma_off);
  int* part = reinterpret_cast<int*>(smem + p.part_off);

  if (kMode != 2) {
    quantize_rows(x, m, k, p.mpad, xq, gamma);
  } else {
    for (int i = threadIdx.x; i < p.mpad; i += kThreads) gamma[i] = 1.0f;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.x * kCols + lane;
  if (kMode == 1) {  // keep the codes live: each column reads one of them
    if (warp == 0 && col < n) out[col] = (float)xq[(size_t)lane * k / 32] * gamma[0];
    return;
  }
  int lo, hi;
  warp_slice(k / 8, warp, lo, hi);
  const float lam = *lam_p;
  for (int row0 = 0; row0 < p.mpad; row0 += kRowGroup) {
    int acc[kRowGroup] = {};
    if (col < n) packed_column(wp, n, col, lo, hi, xq, k, row0, acc);
    const int sum = reduce_warps(acc, part);
    const int row = row0 + warp;
    if (row < m && col < n) {
      const float s = lam / gamma[row];
      rt::store_out(out + (size_t)row * n + col, (float)sum * s);
    }
  }
}

template <int kMode>
cudaError_t launch(const float* x, const uint8_t* wp, const float* lam, float* out, int m, int k,
                   int n, cudaStream_t s) {
  const SmemPlan p = smem_plan(m, k);
  cudaError_t e = allow_smem(variant<kMode>, p.total);
  if (e != cudaSuccess) return e;
  variant<kMode><<<dim3((n + kCols - 1) / kCols), kThreads, p.total, s>>>(x, wp, lam, out, m, k,
                                                                          n);
  return cudaGetLastError();
}

extern "C" int breakdown_launch(int mode, const float* x, const uint8_t* wp, const float* lam,
                                float* out, int m, int k, int n, void* stream, void*) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaErrorInvalidValue;
  if (mode == 0) e = launch<0>(x, wp, lam, out, m, k, n, s);
  if (mode == 1) e = launch<1>(x, wp, lam, out, m, k, n, s);
  if (mode == 2) e = launch<2>(x, wp, lam, out, m, k, n, s);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}
"""


MMA_SOURCE = r"""
#include "gemv_mma.cuh"

using namespace repro_gemv;

constexpr int kMarks = 10;

// Thread 0's clocks at a step boundary: %globaltimer (ns, comparable across
// SMs) and clock64 (cycles of this SM).
__device__ __forceinline__ void mark(unsigned long long* ts, int point) {
  if (ts == nullptr || threadIdx.x != 0) return;
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  ts[(blockIdx.x * kMarks + point) * 2] = ns;
  ts[(blockIdx.x * kMarks + point) * 2 + 1] = clock64();
}
// the act-quant's inner boundaries (its points 0-3) as marks 6-9
struct QuantMark {
  unsigned long long* ts;
  __device__ __forceinline__ void operator()(int point) const { mark(ts, 6 + point); }
};

// w1a8_gemv_kernel's body (f32 in and out), returning after step kStop:
// 0 launch, 1 stage, 2 act-quant, 3 MMAs, 4 the whole kernel (which marks
// its step boundaries in ts when ts is not null).
template <int NT, int kStop>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, Config<false>::kMinBlocks)
variant(const float* __restrict__ x, const uint8_t* __restrict__ wp,
        const float* __restrict__ lam_p, float* __restrict__ out, int m, int k, int n,
        unsigned long long* ts) {
  extern __shared__ __align__(128) uint8_t smem[];
  mark(ts, 0);
  const int rank = (int)cg::this_cluster().block_rank();
  const Plan p = make_plan<false>(m, k);
  const int col0 = blockIdx.x / kCluster * kCols;
  int lo, hi;
  step_slice(k, p.steps, rank, lo, hi);
  const int steps = hi - lo, len = max(0, min(k, 32 * hi) - 32 * lo);
  if (kStop == 0) {
    if (threadIdx.x == 0) out[blockIdx.x] = (float)steps;
    return;
  }
  const bool narrow = narrow_sums(p, false);
  exchange_init(p, smem, m, rank, narrow ? 2 : 4);
  XSlice<float, Config<false>::kBatch> xs;
  load_x(xs, x, m, k, 32 * lo, len);
  stage(smem, kPackedLd, wp + (size_t)4 * lo * n + col0, n, 4 * steps, kCols,
        min(4 * steps, k / 8 - 4 * lo), min(kCols, n - col0), true, NoSwizzle{});
  if (kStop == 1) {
    cluster_wait();
    rt::cp_async_wait_all();
    __syncthreads();
    if (threadIdx.x == 0) out[blockIdx.x] = (float)smem[0] + __uint_as_float(xs.v[0].x);
    return;
  }
  quantize_slice(xs, p, smem, m, rank, 8 * steps, QuantMark{ts});
  mark(ts, 1);
  rt::cp_async_wait_all();
  __syncthreads();
  mark(ts, 2);
  if (kStop == 2) {
    if (threadIdx.x == 0) out[blockIdx.x] = (float)(smem[0] + smem[p.xq_off]);
    return;
  }
  Acc<NT> acc = {};
  packed_steps<NT>(smem, smem + p.xq_off, p.xq_ld, steps, acc);
  mark(ts, 3);
  if (kStop == 3) {
    if (acc.c[0][0][0] == 0x7fffffff) out[threadIdx.x] = 1.0f;
    return;
  }
  send_sums<NT>(acc, p, smem, m, rank, narrow);
  const float lam = *lam_p;
  const float* gamma = reinterpret_cast<const float*>(smem + p.gamma_off);
  reduce_store<NT>(p, smem, m, rank, col0, n, narrow, out,
                   [&](int row) { return lam / gamma[row]; }, [&](int) { mark(ts, 4); });
  mark(ts, 5);
}

template <int NT, int kStop>
cudaError_t launch(const float* x, const uint8_t* wp, const float* lam, float* out, int m, int k,
                   int n, unsigned long long* ts, cudaStream_t s) {
  const Plan p = make_plan<false>(m, k);
  cudaError_t e = cudaFuncSetAttribute(variant<NT, kStop>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (e != cudaSuccess) return e;
  variant<NT, kStop><<<dim3(kCluster * ((n + kCols - 1) / kCols)), kThreads, p.total, s>>>(
      x, wp, lam, out, m, k, n, ts);
  return cudaGetLastError();
}

template <int kStop>
cudaError_t launch_rows(const float* x, const uint8_t* wp, const float* lam, float* out, int m,
                        int k, int n, unsigned long long* ts, cudaStream_t s) {
  switch ((m + 7) / 8) {
    case 1: return launch<1, kStop>(x, wp, lam, out, m, k, n, ts, s);
    case 2: return launch<2, kStop>(x, wp, lam, out, m, k, n, ts, s);
    case 3: return launch<3, kStop>(x, wp, lam, out, m, k, n, ts, s);
    default: return launch<4, kStop>(x, wp, lam, out, m, k, n, ts, s);
  }
}

// How many clusters of the whole kernel the card holds at once at (m, k, n).
extern "C" int max_active_clusters(int m, int k, int n, int* clusters) {
  cudaError_t e = cudaFuncSetAttribute(variant<4, 4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kMaxSmem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * ((n + kCols - 1) / kCols));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = make_plan<false>(m, k).total;
  return (int)cudaOccupancyMaxActiveClusters(clusters, (void*)variant<4, 4>, &cfg);
}

// mode 0-4: the variants above (no marks); 5: the whole kernel, marking.
extern "C" int breakdown_launch(int mode, const float* x, const uint8_t* wp, const float* lam,
                                float* out, int m, int k, int n, void* stream, void* ts) {
  const cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* t = static_cast<unsigned long long*>(ts);
  cudaError_t e = cudaErrorInvalidValue;
  if (mode == 0) e = launch_rows<0>(x, wp, lam, out, m, k, n, nullptr, s);
  if (mode == 1) e = launch_rows<1>(x, wp, lam, out, m, k, n, nullptr, s);
  if (mode == 2) e = launch_rows<2>(x, wp, lam, out, m, k, n, nullptr, s);
  if (mode == 3) e = launch_rows<3>(x, wp, lam, out, m, k, n, nullptr, s);
  if (mode == 4) e = launch_rows<4>(x, wp, lam, out, m, k, n, nullptr, s);
  if (mode == 5) e = launch_rows<4>(x, wp, lam, out, m, k, n, t, s);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}
"""

# the step boundaries that mode 5 marks, in time order: (mark, name)
MMA_MARKS = ((0, "entry"), (6, "x maxima"), (7, "blocks started"), (8, "maxima exchanged"),
             (9, "codes written"), (2, "weights in"), (3, "mma"), (4, "sums in"), (5, "end"))


def build(source: str, src: Path, out_dir: Path) -> tuple[ctypes.CDLL, str]:
    """Compile the variants of ``source`` against SRC's headers; returns the
    library and the compiler's resource report."""
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _cuda

    csrc = src / "repro_torch" / "csrc"
    cu = out_dir / "gemv_breakdown.cu"
    cu.write_text(source)
    so = out_dir / "gemv_breakdown.so"
    cmd = [_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(csrc), "-o", str(so),
           str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.breakdown_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 2
    lib.breakdown_launch.restype = ctypes.c_int
    report = "\n".join(line for line in (proc.stdout + proc.stderr).splitlines()
                       if "registers" in line or "spill" in line or "Compiling" in line)
    return lib, report


def marks(torch, lib, x, ws, lam, out, m, k, n, stream) -> dict:
    """One marking launch of the whole kernel, after the timed ones (each
    block's weights then in L2 or not, as in the timing: the next copy).
    Returns, over the blocks, the median time of each step (ns by
    %globaltimer, and SM cycles by clock64), the spread of the blocks'
    entries and the kernel's span from the first entry to the last end."""
    import statistics

    blocks = 8 * -(-n // 256)  # kCols
    ts = torch.zeros((blocks, 10, 2), dtype=torch.int64, device=x.device)
    err = lib.breakdown_launch(5, x.data_ptr(), ws[1].data_ptr(), lam.data_ptr(),
                               out.data_ptr(), m, k, n, stream, ts.data_ptr())
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    t = ts.cpu()
    res = {}
    for (a, name_a), (b, name_b) in zip(MMA_MARKS, MMA_MARKS[1:]):
        name = f"{name_a}->{name_b}"
        res[name + "_ns"] = statistics.median((t[:, b, 0] - t[:, a, 0]).tolist())
        res[name + "_cycles"] = statistics.median((t[:, b, 1] - t[:, a, 1]).tolist())
    res["entry_spread_ns"] = int(t[:, 0, 0].max() - t[:, 0, 0].min())
    res["span_ns"] = int(t[:, 5, 0].max() - t[:, 0, 0].min())
    return res


def main() -> int:
    import torch

    import chip_smoke

    if len(sys.argv) not in (2, 3) or sys.argv[1] not in ("dp4a", "mma") or \
            (sys.argv[1] == "dp4a" and len(sys.argv) != 3):
        print(__doc__, file=sys.stderr)
        return 2
    design = sys.argv[1]
    source, modes = (DP4A_SOURCE, DP4A_MODES) if design == "dp4a" else (MMA_SOURCE, MMA_MODES)
    if not torch.cuda.is_available():
        print("gemv_breakdown: no CUDA device", file=sys.stderr)
        return 2
    src = Path(sys.argv[2]).resolve() if len(sys.argv) == 3 else ROOT / "src"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        lib, report = build(source, src, Path(tmp))
        print(report, flush=True)
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        lam = torch.full((), 0.031, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        rows = []
        for k, n in SHAPES:
            ws = [torch.randint(0, 256, (k // 8, n), generator=gen, device=dev,
                                dtype=torch.uint8) for _ in range(chip_smoke._copies(k // 8 * n))]
            for m in ROWS:
                x = torch.randn((m, k), generator=gen, dtype=torch.float32, device=dev)
                out = torch.empty((m, n), dtype=torch.float32, device=dev)
                row = {"m": m, "k": k, "n": n}
                for mode, name in enumerate(modes):
                    def call(i, mode=mode):
                        err = lib.breakdown_launch(mode, x.data_ptr(), ws[i % len(ws)].data_ptr(),
                                                   lam.data_ptr(), out.data_ptr(), m, k, n,
                                                   stream, None)
                        if err:
                            raise RuntimeError(f"launch failed: CUDA error {err}")
                    row[f"{name}_us"] = chip_smoke._time(torch, call, 200) * 1e3
                if design == "mma":
                    row["marks"] = marks(torch, lib, x, ws, lam, out, m, k, n, stream)
                    held = ctypes.c_int(0)
                    if lib.max_active_clusters(m, k, n, ctypes.byref(held)) == 0:
                        row["marks"]["max_active_clusters"] = held.value
                torch.cuda.synchronize()
                rows.append(row)
                print(f"M {m} K {k} N {n}: " + ", ".join(
                    f"{name} {row[f'{name}_us']:.2f} us" for name in modes), flush=True)
                if design == "mma":
                    print(f"  marks: {json.dumps(row['marks'])}", flush=True)
    print(json.dumps({"card": smi, "design": design, "src": str(src), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
