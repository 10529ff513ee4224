// Hopper (sm_90a) building blocks shared by the tensor-core flash-attention
// kernels, flash_attn_fwd_sm90.cu and flash_attn_bwd_sm90.cu: bf16x2/f16x2
// packing, mbarriers with a trapping wait, 4-D TMA loads, shared-memory
// matrix descriptors for the 128B swizzle, the wgmma instructions the two
// kernels issue, and the tensor maps over [B, H, S, D] inputs read through
// their strides.  _build.py hashes this header into every kernel's build.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int kChunk = 64;                // columns per 128-byte swizzle row
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Bf16 {};
struct F16 {};
template <typename T> struct Tag;
template <> struct Tag<__nv_bfloat16> { using type = Bf16; };
template <> struct Tag<__half> { using type = F16; };

__device__ __forceinline__ uint32_t pack2(float lo, float hi, Bf16) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi, F16) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// -- mbarrier and TMA ---------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done;
}
// Waits for the phase of `bar` with this parity to complete.  A wait of
// more than about 4 s at the H100's clock is a fault of the kernel: it
// traps, so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 33)) __trap();
}
// One box of a 4-D tensor map at coordinates (d, s, h, b) into shared memory;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// -- wgmma ----------------------------------------------------------------------
// Shared-memory matrix descriptor, 128B swizzle: start address, leading and
// stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// A K-major operand (rows of 64 columns, 128 bytes, in 128B-swizzled chunks
// of `chunk_bytes`): the 16 columns kk of D starting at `tile`.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk,
                                                 uint32_t chunk_bytes) {
  return smem_desc(tile + (kk / 4) * chunk_bytes + (kk % 4) * 32, 16, 1024);
}
// An MN-major B operand (rows are the reduction axis): 16 rows from row
// 16 kk, the 64 columns of chunk c.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk, int c,
                                                  uint32_t chunk_bytes) {
  return smem_desc(tile + c * chunk_bytes + kk * 16 * 128, chunk_bytes, 1024);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until every committed group of this warpgroup is done.
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// 2^x by the SFU (ex2.approx, a relative error near 2^-22); 2^(-1e30) is 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Accumulator operand lists of 16, 32 and 64 fp32 registers.
#define SM90_R16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define SM90_R32 SM90_R16 ", " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define SM90_R64 SM90_R32 ", " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define SM90_D16(d)                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),       \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define SM90_D32(d)                                                             \
  SM90_D16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),              \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),          \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),          \
      "+f"(d[30]), "+f"(d[31])
#define SM90_D64(d)                                                             \
  SM90_D32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),              \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),          \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),          \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),          \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),          \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),          \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// wgmma_ss: D (64 x N, fp32) += A (64 x 16) B^T (16 x N), N = 2 * (number of
// registers), A and B from shared memory, both K-major; scale_d = 0
// overwrites D.
#define SM90_WGMMA_SS(NREG, N, RLIST, DLIST, DA, DB, PRED, TAG, TY)            \
  __device__ __forceinline__ void wgmma_ss(float (&d)[NREG], uint64_t da,       \
                                           uint64_t db, int scale_d, TAG) {     \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #PRED ", 0;\n"             \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY     \
                 " {" RLIST "}, %" #DA ", %" #DB ", p, 1, 1, 0, 0;\n}\n"         \
                 : DLIST(d)                                                     \
                 : "l"(da), "l"(db), "r"(scale_d));                             \
  }
SM90_WGMMA_SS(16, 32, SM90_R16, SM90_D16, 16, 17, 18, Bf16, "bf16")
SM90_WGMMA_SS(16, 32, SM90_R16, SM90_D16, 16, 17, 18, F16, "f16")
SM90_WGMMA_SS(32, 64, SM90_R32, SM90_D32, 32, 33, 34, Bf16, "bf16")
SM90_WGMMA_SS(32, 64, SM90_R32, SM90_D32, 32, 33, 34, F16, "f16")
SM90_WGMMA_SS(64, 128, SM90_R64, SM90_D64, 64, 65, 66, Bf16, "bf16")
SM90_WGMMA_SS(64, 128, SM90_R64, SM90_D64, 64, 65, 66, F16, "f16")
#undef SM90_WGMMA_SS

// wgmma_rs: D (64 x 64, fp32) += A (64 x 16, registers) B (16 x 64), B from
// shared memory, MN-major (the transpose bit).  The A fragment is an fp32
// accumulator's 8 registers 8 kk .. 8 kk + 7 packed pairwise (pack2): the
// accumulator layout of columns 16 kk .. 16 kk + 15 is the A layout.
#define SM90_WGMMA_RS(TAG, TY)                                                  \
  __device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], \
                                           uint64_t db, TAG) {                  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                   \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY        \
                 " {" SM90_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
                 : SM90_D32(d)                                                  \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)); \
  }
SM90_WGMMA_RS(Bf16, "bf16")
SM90_WGMMA_RS(F16, "f16")
#undef SM90_WGMMA_RS

// -- tensor maps ----------------------------------------------------------------
using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

// cuTensorMapEncodeTiled through the runtime's entry-point query, without
// linking libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map (d, s, h, b) over one input, from its own sizes and element
// strides st = (b, h, s), boxes of 64 columns x `rows` rows, 128B swizzle,
// zeros outside the tensor.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                            int batch, int heads, int seq_len, int d,
                            const long long* st, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(seq_len),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  // byte strides of s, h, b; a dimension of size 1 is never stepped, so it
  // gets the stride a contiguous tensor would have
  cuuint64_t strides[3];
  cuuint64_t natural = static_cast<cuuint64_t>(d) * 2;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? natural
                                  : static_cast<cuuint64_t>(st[2 - i]) * 2;
    natural = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kChunk),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                          elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor-map element type of the launchers' dtype code (1 = bf16,
// 2 = fp16); false for any other code.
inline bool map_type(int dtype, CUtensorMapDataType* type) {
  switch (dtype) {
    case 1: *type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16; return true;
    case 2: *type = CU_TENSOR_MAP_DATA_TYPE_FLOAT16; return true;
    default: return false;
  }
}

}  // namespace sm90
