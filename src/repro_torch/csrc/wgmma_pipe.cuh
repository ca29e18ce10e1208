// Hopper (sm_90a) building blocks for the prefill-tier GEMMs on 1-bit
// packed weights: a ring of shared-memory stages filled by TMA behind
// mbarriers, int8 warpgroup MMAs (wgmma) with the weight operand expanded
// from its packed sign bits straight into registers, and the host-side
// tensor maps.  w1a8_matmul.cu and decoupled_matmul.cu (the fused 1-bit +
// 8-bit GEMM, whose 8-bit tiles build A from an int8 box with
// int8_fragment) build their kernels from these.
//
// The operand roles.  int8 wgmma reads both operands K-major, B always
// from shared memory (through a 64-bit matrix descriptor) and A from
// shared memory or from registers.  A kernel here computes the transposed
// product, Y^T = W^T X^T, so that:
//
//   * B is a tile of activation rows x (M, K), row-major: K-major as it
//     lies in device memory.  TMA copies a 128-row x 128-byte box into a
//     1024-byte-aligned stage with the 128-byte swizzle (16-byte chunk c of
//     row r at chunk c ^ (r & 7)), which is wgmma's canonical K-major
//     layout; a k32 step is the descriptor's start address advanced by 32
//     bytes inside the swizzled row.
//   * A is the weight, expanded in registers: bit b of packed byte k of
//     column n is weight row 8k + b (bit 1 -> +1), so one nibble of a
//     packed byte is exactly one 32-bit word of A's fragment (four
//     consecutive K values of one row of W^T).  No expanded weight is ever
//     written to shared memory, so the only shared-memory traffic of the
//     weight is the packed stage itself (BK/8 bytes a column), and no
//     generic-proxy store needs a fence before the tensor cores read it.
//
// A's fragment for m64nNk32 (per warp w of the warpgroup, lane = 4 g + t):
// register 0 holds A row 16 w + g at K 4t..4t+3 of the k32 step, register
// 1 row 16 w + g + 8 at the same K, registers 2 and 3 the same rows at K
// 16 + 4t..; the accumulator d[4 j + 2 h + e] is A row 16 w + g + 8 h at B
// row (N index) 8 j + 2 t + e.  The kernels map A row 16 w + g + 8 h to
// weight column 16 w + 2 g + h, so a lane's two A rows are two adjacent
// weight columns: one 16-bit load of a packed row gives both, and the
// accumulators of one B row are two adjacent outputs (one 8-byte f32 or
// 4-byte bf16 store).
#pragma once

#include <atomic>
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// Makes the initialised barriers visible to the async proxy (TMA) and to
// the other threads (with the __syncthreads that follows).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// One arrival that also expects `bytes` of copies to complete on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---- TMA ----

// The box of `map` at (c0 innermost, c1) into shared memory at `dst`,
// completing `bytes` of `bar`'s expected transactions (out-of-bounds
// elements arrive as zeros and count).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---- warpgroups ----

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
// A barrier among `threads` threads (a warpgroup's 128) on named barrier `id` (1-15).
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma ----

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Matrix descriptor of a K-major operand with the 128-byte swizzle whose
// 8-row groups lie 1024 bytes apart, starting at shared address `saddr`
// (the stage 1024-byte aligned; a k32 step adds 32 bytes, i.e. 2, to it).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4)  // start address
         | (uint64_t)1 << 16                  // leading byte offset (unused when swizzled)
         | (uint64_t)(1024 >> 4) << 32        // stride byte offset: next 8 rows
         | (uint64_t)1 << 62;                 // layout: 128-byte swizzle
}

// d (64 x 128 int32, the accumulator fragment) (+)= A (64 x 32 int8, the
// register fragment a) x B (32 x 128 int8, K-major at desc_b); accumulate
// 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// ---- the 1-bit weight operand ----

// Four sign bits (nib < 16; bit j -> K value j) as one word of four int8
// lanes: +1 where the bit is set, -1 where not.  `ones` spreads bit j to
// byte j (the four partial products of the multiply do not overlap), and
// ones * -254 - 1 = ~(254 * ones) flips each byte to 0x01 or 0xFF with no
// carry between bytes.  Three integer instructions a word.
__device__ __forceinline__ uint32_t sign_word(uint32_t nib) {
  const uint32_t ones = (nib * 0x00204081u) & 0x01010101u;
  return ones * 0xFFFFFF02u + 0xFFFFFFFFu;
}

// A's register fragment for one k32 step from the two 16-bit packed words
// a lane loaded for it: lo from packed row 4 s + (t >> 1) (K 0-15 of the
// step), hi from row 4 s + 2 + (t >> 1) (K 16-31), each holding the bytes
// of weight columns 2 g (low byte) and 2 g + 1 (high byte); `shift` = 4 (t
// & 1) picks the nibble of K 4t..4t+3.
__device__ __forceinline__ void sign_fragment(uint32_t lo, uint32_t hi, int shift,
                                              uint32_t (&a)[4]) {
  lo >>= shift;
  hi >>= shift;
  a[0] = sign_word(lo & 0xFu);         // A row g     = column 2 g,     K 4t..
  a[1] = sign_word((lo >> 8) & 0xFu);  // A row g + 8 = column 2 g + 1, K 4t..
  a[2] = sign_word(hi & 0xFu);         // column 2 g,     K 16 + 4t..
  a[3] = sign_word((hi >> 8) & 0xFu);  // column 2 g + 1, K 16 + 4t..
}

// ---- the 8-bit weight operand ----

// A's register fragment for one k32 step from an int8 weight that lies
// N-major (K rows of columns) in shared memory: lo[i] and hi[i] are the
// 16-bit loads of a lane's two adjacent columns (low byte column 2 g, high
// byte 2 g + 1) from K rows 4 t + i and 16 + 4 t + i of the step, taken in
// the order that `sel` undoes: 0x5140 for rows i = 0, 1, 2, 3, 0x1504 for
// rows 1, 0, 3, 2.  Each pair of loads is first interleaved by column
// (bytes: column 2 g at two K, then column 2 g + 1 at the same two), then
// two pairs are joined into one column's four K values.
__device__ __forceinline__ void int8_fragment(const uint32_t (&lo)[4], const uint32_t (&hi)[4],
                                              uint32_t sel, uint32_t (&a)[4]) {
  const uint32_t l01 = __byte_perm(lo[0], lo[1], sel), l23 = __byte_perm(lo[2], lo[3], sel);
  const uint32_t h01 = __byte_perm(hi[0], hi[1], sel), h23 = __byte_perm(hi[2], hi[3], sel);
  a[0] = __byte_perm(l01, l23, 0x5410);  // A row g     = column 2 g,     K 4t..
  a[1] = __byte_perm(l01, l23, 0x7632);  // A row g + 8 = column 2 g + 1, K 4t..
  a[2] = __byte_perm(h01, h23, 0x5410);  // column 2 g,     K 16 + 4t..
  a[3] = __byte_perm(h01, h23, 0x7632);  // column 2 g + 1, K 16 + 4t..
}

// ---- epilogue ----

// Two adjacent outputs in one store (8 bytes of f32, 4 of bf16).
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---- host: tensor maps ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda entry point), looked up once through
// the runtime so that the library links no libcuda; null where missing.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A 2-D byte matrix (outer rows of `inner` bytes, `row_bytes` apart, base
// 16-byte aligned, row_bytes a multiple of 16) as a TMA tensor map with
// boxes of box_outer x box_inner bytes; out-of-bounds elements read as 0.
inline cudaError_t encode_2d(CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer,
                             uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer,
                             CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- host: what a launch asks of the runtime once ----

// Devices whose answers are kept; a higher ordinal asks every time.
constexpr int kMaxDevices = 64;

// The SM count of `device`, asked of the runtime once per device.
inline cudaError_t sm_count(int device, int* sms) {
  static std::atomic<int> known[kMaxDevices];
  if (device < 0 || device >= kMaxDevices)
    return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  int c = known[device].load(std::memory_order_relaxed);
  if (c == 0) {
    const cudaError_t e = cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    known[device].store(c, std::memory_order_relaxed);
  }
  *sms = c;
  return cudaSuccess;
}

// Lets `kernel` take `bytes` of dynamic shared memory on `device` (the
// current device), asking the runtime once per device: `done` is the
// caller's own array of flags for this kernel (a function-local static of
// the launcher, one per kernel instantiation).
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, int device,
                              std::atomic<bool> (&done)[kMaxDevices]) {
  const bool kept = device >= 0 && device < kMaxDevices;
  if (kept && done[device].load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && kept) done[device].store(true, std::memory_order_relaxed);
  return e;
}

}  // namespace repro_sm90
