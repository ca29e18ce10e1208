// Decode-tier W1A8 GEMV kernels with fused activation quantization, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/w1a8_gemv.py:
//   w1a8_gemv       (pl.pallas_call in w1a8_gemv, _w1a8_gemv_kernel)
//   decoupled_gemv  (pl.pallas_call in decoupled_gemv, _decoupled_gemv_kernel)
//
// What bounds them on an H100: the weight bytes.  A decode step multiplies
// M <= 32 token rows by the whole packed sign matrix (K/8 x N bytes) and,
// for decoupled_gemv, by the int8 branch (K x r bytes); at M = 4 there are
// 64 int8 operations per weight byte, far below the card's ~590 operations
// per byte of device memory, so time is bytes over bandwidth at best, and
// at these sizes (0.5-2 MB) the latency of one trip to memory and the
// launch itself.
//
// Design (the pieces are in gemv_mma.cuh).  The TPU kernel quantizes the
// activations once, at grid step (0, 0), and keeps the int8 rows in VMEM
// for its sequential grid.  Here a thread-block cluster of 8 blocks owns
// 256 output columns and all of K, each block one eighth of the k32 steps:
// every block loads its own slice of x into registers and stages its
// weight slice into shared memory with cp.async; the blocks agree on each
// row's abs-max over DSMEM and quantize only their own slice (so x is
// read once per cluster), and
// the products run on the tensor cores as Y^T = W^T X^T
// (mma.sync m16n8k32 s8, the token rows the MMA's 8-wide side), one read
// of the weight serving all M <= 32 rows.  The int32 sums of the 8 blocks
// meet over DSMEM, each block sending every other block the rows it
// stores.  decoupled_gemv puts the clusters of its r int8 columns
// after those of its N packed columns in one grid: one act-quant of x per
// cluster, each weight byte read once.
//
// As upstream, x is read in its own type (f32 or bf16, cast to f32 as it
// is used, which is exact) and the outputs are written in out_dtype (f32,
// or bf16 rounded to nearest even from the f32 epilogue), so a bf16 model
// pays no cast on either side.  Epilogues keep the Pallas kernels' order
// of operations, so the outputs equal the plain versions bit for bit (no
// fast math: IEEE division and round-half-even throughout):
//   w1a8_gemv       y  = float(acc)  * (lam / gamma)
//   decoupled_gemv  y1 = float(acc1) * ((beta * lam) / gamma)
//                   y8 = float(acc8) * (alpha / (gamma * w8scale))

#include <atomic>

#include "gemv_mma.cuh"

using namespace repro_gemv;

namespace {

struct Args {
  const void* x;
  const uint8_t* wp;
  const int8_t* w8;
  const float *lam, *w8scale, *alpha, *beta;
  void *y1, *y8;
  int m, k, n, r;
  int packed_aligned, int8_aligned;  // 16-byte copies of the weight rows are possible
};

// One block of the cluster grid: clusters [0, ceil(n / 256)) own packed
// columns, the rest (decoupled_gemv only) the int8 branch's columns.
template <class In, class Out, int NT, bool kDecoupled>
__device__ __forceinline__ void gemv_block(const Args& a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int m = a.m, k = a.k, n = a.n, rank = (int)cg::this_cluster().block_rank();
  const Plan p = make_plan<kDecoupled>(m, k);
  const int clu = blockIdx.x / kCluster, groups1 = (n + kCols - 1) / kCols;
  const bool int8_branch = kDecoupled && clu >= groups1;
  const int col0 = (int8_branch ? clu - groups1 : clu) * kCols;
  int lo, hi;
  step_slice(k, p.steps, rank, lo, hi);
  const int steps = hi - lo, len = max(0, min(k, 32 * hi) - 32 * lo);
  const bool narrow = narrow_sums(p, int8_branch);
  exchange_init(p, smem, m, rank, narrow ? 2 : 4);

  // 1. the first x loads, then the staging of the weight slice's first
  // pass (stage_pass(s0, ns): the block's k32 steps [s0, s0 + ns))
  XSlice<In, Config<kDecoupled>::kBatch> xs;
  load_x(xs, static_cast<const In*>(a.x), m, k, 32 * lo, len);
  const auto stage_pass = [&](int s0, int ns) {
    const int first = lo + s0;
    if (int8_branch) {
      const uint8_t* w8 =
          reinterpret_cast<const uint8_t*>(a.w8) + (size_t)32 * first * a.r + col0;
      stage(smem, kCols, w8, a.r, 32 * ns, kCols, min(32 * ns, k - 32 * first),
            min(kCols, a.r - col0), a.int8_aligned, Int8Swizzle{});
    } else {
      stage(smem, kPackedLd, a.wp + (size_t)4 * first * n + col0, n, 4 * ns, kCols,
            min(4 * ns, k / 8 - 4 * first), min(kCols, n - col0), a.packed_aligned,
            NoSwizzle{});
    }
  };
  stage_pass(0, min(p.w_steps, steps));

  // 2. act-quant of this block's slice, the row maxima shared over the cluster
  quantize_slice(xs, p, smem, m, rank, 8 * steps);
  rt::cp_async_wait_all();
  __syncthreads();

  // 3. the MMAs over the slice, pass by pass (the next pass staged once
  // every warp is done with the last)
  Acc<NT> acc = {};
  for (int s0 = 0; s0 < steps; s0 += p.w_steps) {
    const int ns = min(p.w_steps, steps - s0);
    if (s0) {
      __syncthreads();
      stage_pass(s0, ns);
      rt::cp_async_wait_all();
      __syncthreads();
    }
    if (int8_branch)
      int8_steps<NT>(smem, smem + p.xq_off + 32 * s0, p.xq_ld, ns, acc);
    else
      packed_steps<NT>(smem, smem + p.xq_off + 32 * s0, p.xq_ld, ns, acc);
  }

  // 4. the sums over the cluster, and the epilogue
  send_sums<NT>(acc, p, smem, m, rank, narrow);
  const float* gamma = reinterpret_cast<const float*>(smem + p.gamma_off);
  if (!kDecoupled) {
    const float lam = *a.lam;
    reduce_store<NT>(p, smem, m, rank, col0, n, narrow, static_cast<Out*>(a.y1),
                     [&](int row) { return lam / gamma[row]; });
  } else if (!int8_branch) {
    const float bl = *a.beta * *a.lam;
    reduce_store<NT>(p, smem, m, rank, col0, n, narrow, static_cast<Out*>(a.y1),
                     [&](int row) { return bl / gamma[row]; });
  } else {
    const float alpha = *a.alpha, w8s = *a.w8scale;
    reduce_store<NT>(p, smem, m, rank, col0, a.r, narrow, static_cast<Out*>(a.y8),
                     [&](int row) { return alpha / (gamma[row] * w8s); });
  }
}

template <class In, class Out, int NT>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, Config<false>::kMinBlocks) w1a8_gemv_kernel(const Args a) {
  gemv_block<In, Out, NT, false>(a);
}

template <class In, class Out, int NT>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, Config<true>::kMinBlocks) decoupled_gemv_kernel(const Args a) {
  gemv_block<In, Out, NT, true>(a);
}

template <class In, class Out, int NT, bool kDecoupled>
cudaError_t launch(const Args& a, int device, cudaStream_t s) {
  const auto kernel =
      kDecoupled ? decoupled_gemv_kernel<In, Out, NT> : w1a8_gemv_kernel<In, Out, NT>;
  static std::atomic<bool> smem_allowed[repro_sm90::kMaxDevices];
  cudaError_t e = repro_sm90::allow_smem(kernel, (int)kMaxSmem, device, smem_allowed);
  if (e != cudaSuccess) return e;
  const int clusters = (a.n + kCols - 1) / kCols + (kDecoupled ? (a.r + kCols - 1) / kCols : 0);
  kernel<<<dim3(kCluster * clusters), kThreads, make_plan<kDecoupled>(a.m, a.k).total, s>>>(a);
  return cudaGetLastError();
}

template <class In, class Out, bool kDecoupled>
cudaError_t launch_rows(const Args& a, int device, cudaStream_t s) {
  switch ((a.m + 7) / 8) {
    case 1: return launch<In, Out, 1, kDecoupled>(a, device, s);
    case 2: return launch<In, Out, 2, kDecoupled>(a, device, s);
    case 3: return launch<In, Out, 3, kDecoupled>(a, device, s);
    case 4: return launch<In, Out, 4, kDecoupled>(a, device, s);
    default: return cudaErrorInvalidValue;
  }
}

using bf16 = __nv_bfloat16;

// Checks a launch's shape and types, then launches the instantiation for
// its (x, output) type pair (dtype codes 0 f32, 1 bf16, as rt::OutCode).
template <bool kDecoupled>
int launch_checked(Args a, int x_dtype, int out_dtype, int device, void* stream) {
  const auto ok = [](int c) { return c == rt::kF32 || c == rt::kBF16; };
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess &&
      (!ok(x_dtype) || !ok(out_dtype) || a.m < 1 || a.m > kMaxRows || a.k < 8 || a.k % 8 ||
       a.n < 1 || (kDecoupled && a.r < 1) ||
       make_plan<kDecoupled>(a.m, a.k).total > kMaxSmem))
    e = cudaErrorInvalidValue;
  if (e == cudaSuccess) {
    a.packed_aligned = a.n % 16 == 0 && reinterpret_cast<uintptr_t>(a.wp) % 16 == 0;
    a.int8_aligned = a.r % 16 == 0 && reinterpret_cast<uintptr_t>(a.w8) % 16 == 0;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (2 * x_dtype + out_dtype) {
      case 0: e = launch_rows<float, float, kDecoupled>(a, device, s); break;
      case 1: e = launch_rows<float, bf16, kDecoupled>(a, device, s); break;
      case 2: e = launch_rows<bf16, float, kDecoupled>(a, device, s); break;
      default: e = launch_rows<bf16, bf16, kDecoupled>(a, device, s); break;
    }
  }
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Pointers are device pointers;
// `stream` is a cudaStream_t.  Each returns the cudaError_t of its launch
// (0 on success) and never synchronizes.  Shapes: x (m, k) of x_dtype, 16-
// byte aligned, 1 <= m <= 32, k a multiple of 8; wp (k/8, n) u8, w8 (k, r)
// i8 (any alignment: rows that 16-byte copies cannot take are staged byte
// by byte); scalars one f32 each; outputs (m, n) and (m, r) of out_dtype
// (dtype codes: 0 f32, 1 bf16).

extern "C" int w1a8_gemv_launch(const void* x, int x_dtype, const uint8_t* wp, const float* lam,
                                void* out, int out_dtype, int m, int k, int n, int device,
                                void* stream) {
  const Args a{x, wp, nullptr, lam, nullptr, nullptr, nullptr, out, nullptr, m, k, n, 0, 0, 0};
  return launch_checked<false>(a, x_dtype, out_dtype, device, stream);
}

extern "C" int decoupled_gemv_launch(const void* x, int x_dtype, const uint8_t* wp,
                                     const int8_t* w8, const float* lam, const float* w8scale,
                                     const float* alpha, const float* beta, void* y1, void* y8,
                                     int out_dtype, int m, int k, int n, int r, int device,
                                     void* stream) {
  const Args a{x, wp, w8, lam, w8scale, alpha, beta, y1, y8, m, k, n, r, 0, 0};
  return launch_checked<true>(a, x_dtype, out_dtype, device, stream);
}
