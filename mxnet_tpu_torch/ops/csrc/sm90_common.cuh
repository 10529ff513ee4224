// Hopper (sm_90a) building blocks shared by the tensor-core flash-attention
// kernels, flash_attn_{fwd,bwd}_sm90.cu (bf16/fp16) and
// flash_attn_{fwd,bwd}_f32_sm90.cu (fp32): bf16x2/f16x2 packing, mbarriers
// with a trapping wait, 4-D TMA loads, shared-memory matrix descriptors for
// the 128B, 64B and 32B swizzles, the wgmma instructions the kernels issue,
// the tensor maps over [B, H, S, D] inputs read through their strides, and
// the split of fp32 values into three bf16 parts with the loader that
// stores them in the swizzled layout.  _build.py hashes this header into
// every kernel's build.
//
// Tiles in shared memory.  A tile of `rows` rows of D 16-bit values is kept
// as D / chunk_cols(D) chunks of rows x row_bytes(D) bytes: chunks of 64
// columns (128-byte rows) at D >= 64, one chunk of the whole row (64 bytes
// at D = 32, 32 bytes at D = 16) below.  Each chunk is in the swizzle of
// its row width, the layout TMA writes with SWIZZLE_128B / _64B / _32B:
// the 16-byte unit u of row r sits at unit u ^ ((r * row_bytes / 128) %
// (row_bytes / 16)), i.e. u ^ (r % 8), u ^ ((r / 2) % 4), u ^ ((r / 4) % 2)
// (CUTLASS's Swizzle<3,4,3>, <2,4,3>, <1,4,3> on byte addresses).  The
// swizzle repeats every 8 rows (1024, 512 or 256 bytes); every tile starts
// on a 1024-byte boundary.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// Columns per swizzled row and bytes per row of a tile of head dim D.
__host__ __device__ constexpr int chunk_cols(int d) { return d < 64 ? d : 64; }
__host__ __device__ constexpr uint32_t row_bytes(int d) { return 2 * chunk_cols(d); }
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
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (all in 16-byte units) and the layout type of the swizzle of rows
// of `rb` bytes: 1 = 128B, 2 = 64B, 3 = 32B (bits 62-63).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t rb) {
  const uint64_t layout = rb == 128 ? 1 : (rb == 64 ? 2 : 3);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}
// A K-major operand (rows of `rb` bytes in chunks of `chunk_bytes`): the 16
// columns kk of D (32 bytes) starting at `tile`.  Groups of 8 rows lie
// 8 rb bytes apart (the stride offset); a swizzled K-major operand has no
// leading offset.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk, uint32_t chunk_bytes,
                                                 uint32_t rb) {
  const int per_row = rb / 32;
  return smem_desc(tile + (kk / per_row) * chunk_bytes + (kk % per_row) * 32, 16, 8 * rb, rb);
}
// An MN-major B operand (rows are the reduction axis): 16 rows from row
// 16 kk, the chunk_cols columns of chunk c.  The leading offset steps from
// one chunk to the next along N (never taken when N is one chunk), the
// stride offset from 8 rows to the next 8.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk, int c,
                                                  uint32_t chunk_bytes, uint32_t rb) {
  return smem_desc(tile + c * chunk_bytes + kk * 16 * rb, chunk_bytes, 8 * rb, rb);
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

// Accumulator operand lists of 8, 16, 32 and 64 fp32 registers.
#define SM90_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define SM90_R16 SM90_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define SM90_R32 SM90_R16 ", " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define SM90_R64 SM90_R32 ", " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define SM90_D8(d)                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),       \
      "+f"(d[6]), "+f"(d[7])
#define SM90_D16(d)                                                             \
  SM90_D8(d), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),    \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
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

// wgmma_rs: D (64 x N, fp32) += A (64 x 16, registers) B (16 x N), N = 2 *
// (number of registers), B from shared memory, MN-major (the transpose
// bit).  The A fragment is an fp32 accumulator's 8 registers 8 kk .. 8 kk + 7
// packed pairwise (pack2): the accumulator layout of columns 16 kk .. 16 kk +
// 15 is the A layout.
#define SM90_WGMMA_RS(NREG, N, RLIST, DLIST, A0, A1, A2, A3, DB, PRED, TAG, TY) \
  __device__ __forceinline__ void wgmma_rs(float (&d)[NREG], const uint32_t (&a)[4], \
                                           uint64_t db, TAG) {                  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #PRED ", 0;\n"           \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY     \
                 " {" RLIST "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #DB  \
                 ", p, 1, 1, 1;\n}\n"                                            \
                 : DLIST(d)                                                     \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)); \
  }
SM90_WGMMA_RS(8, 16, SM90_R8, SM90_D8, 8, 9, 10, 11, 12, 13, Bf16, "bf16")
SM90_WGMMA_RS(8, 16, SM90_R8, SM90_D8, 8, 9, 10, 11, 12, 13, F16, "f16")
SM90_WGMMA_RS(16, 32, SM90_R16, SM90_D16, 16, 17, 18, 19, 20, 21, Bf16, "bf16")
SM90_WGMMA_RS(16, 32, SM90_R16, SM90_D16, 16, 17, 18, 19, 20, 21, F16, "f16")
SM90_WGMMA_RS(32, 64, SM90_R32, SM90_D32, 32, 33, 34, 35, 36, 37, Bf16, "bf16")
SM90_WGMMA_RS(32, 64, SM90_R32, SM90_D32, 32, 33, 34, 35, 36, 37, F16, "f16")
#undef SM90_WGMMA_RS

// -- fp32 as three bf16 parts ---------------------------------------------------
// The fp32 kernels (flash_attn_*_f32_sm90.cu) write each fp32 operand as
// x = x0 + x1 + x2, each part a bf16: x0 = bf16(x), x1 = bf16(x - x0),
// x2 = bf16(x - x0 - x1), every rounding to nearest even.  Both differences
// are exact in fp32, and x2 needs at most 8 bits, so the split is exact for
// 0 and for every x with 2^-110 <= |x| < 2^128 - 2^119 (below, x2 would
// need bits finer than bf16's smallest subnormal; above, x0 rounds to
// infinity).  A product a b is then sum_{i+j<=2} a_i b_j: six bf16 products,
// each exact in fp32, leaving out a_1 b_2 + a_2 b_1 + a_2 b_2, below
// 2^-23 |a b|.  The six in the order they are issued into one fp32
// accumulator, smallest first: (2,0) (1,1) (0,2) (1,0) (0,1) (0,0).
__host__ __device__ constexpr int split_a(int o) { return o < 3 ? 2 - o : (o < 5 ? 4 - o : 0); }
__host__ __device__ constexpr int split_b(int o) { return o < 3 ? o : (o < 5 ? o - 3 : 0); }
constexpr int kSplitProducts = 6;

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// The three parts of the pair (lo, hi), each packed as bf16x2 with lo in
// the low half (pack2's order, the A-fragment and shared-tile order).
__device__ __forceinline__ void split3(float lo, float hi, uint32_t& w0, uint32_t& w1,
                                       uint32_t& w2) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(lo, hi);
  const float2 af = __bfloat1622float2(a);
  const float rlo = __fsub_rn(lo, af.x), rhi = __fsub_rn(hi, af.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(rlo, rhi);
  const float2 bf = __bfloat1622float2(b);
  w0 = bf16x2_bits(a);
  w1 = bf16x2_bits(b);
  w2 = bf16x2_bits(__floats2bfloat162_rn(__fsub_rn(rlo, bf.x), __fsub_rn(rhi, bf.y)));
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, const uint32_t (&w)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]) : "memory");
}
// Makes this thread's ordinary shared-memory stores visible to the async
// proxy (wgmma's operand reads); issued before the arrival that publishes them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of the 16-byte unit u (bf16 columns 8u .. 8u + 7) of row r in
// a tile of `rows` rows of head dim D, in the swizzled chunks described at
// the top of this file: the layout TMA writes and desc_k_major and
// desc_mn_major read.
template <int D>
__host__ __device__ constexpr uint32_t swizzled(int r, int u, int rows) {
  constexpr int kRB = row_bytes(D), kUnits = kRB / 16;
  return (u / kUnits) * rows * kRB + r * kRB +
         (((u % kUnits) ^ ((r * kRB / 128) % kUnits)) << 4);
}

// Rows [r0, r0 + ROWS) of one (b, h) slice of an fp32 [B, H, S, D] tensor
// (`src` at its row 0, rows `row_stride` elements apart, the last stride
// 1), each value times `mul`, zeros past S, split into three bf16 tiles
// at dst + p * ROWS * D * 2 (p = 0, 1, 2) in the swizzled layout.  NT
// threads share the work, this one is `tid`; each loads 8 columns (two
// 16-byte loads) per group, up to four groups in flight, then splits and
// stores them, and fences for the async proxy at the end.  Where a tile
// has fewer groups than NT (D = 16 on 32 rows), the last threads idle.
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_split(const float* __restrict__ src, long long row_stride,
                                           int r0, int seq_len, float mul, uint32_t dst,
                                           int tid) {
  constexpr int kUnits = D / 8;
  constexpr int kTotal = ROWS * kUnits;
  constexpr int kGroups = (kTotal + NT - 1) / NT;  // per thread
  constexpr int kBatch = kGroups < 4 ? kGroups : 4;
  static_assert((kTotal % NT == 0 || kGroups == 1) && kGroups % kBatch == 0,
                "uneven tile split");
  constexpr uint32_t kPart = ROWS * D * 2;
  if (kTotal % NT != 0 && tid >= kTotal) {
    fence_proxy_async();
    return;
  }
#pragma unroll
  for (int b0 = 0; b0 < kGroups; b0 += kBatch) {
    float4 x[kBatch][2];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int g = tid + (b0 + i) * NT;
      const int r = g / kUnits, u = g % kUnits;
      if (r0 + r < seq_len) {
        const float4* at = reinterpret_cast<const float4*>(
            src + static_cast<long long>(r0 + r) * row_stride + u * 8);
        x[i][0] = __ldg(at);
        x[i][1] = __ldg(at + 1);
      } else {
        x[i][0] = x[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int g = tid + (b0 + i) * NT;
      const int r = g / kUnits, u = g % kUnits;
      const float v[8] = {x[i][0].x, x[i][0].y, x[i][0].z, x[i][0].w,
                          x[i][1].x, x[i][1].y, x[i][1].z, x[i][1].w};
      uint32_t w[3][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split3(__fmul_rn(v[2 * j], mul), __fmul_rn(v[2 * j + 1], mul), w[0][j], w[1][j],
               w[2][j]);
      const uint32_t off = dst + swizzled<D>(r, u, ROWS);
#pragma unroll
      for (int p = 0; p < 3; ++p) st_shared_v4(off + p * kPart, w[p]);
    }
  }
  fence_proxy_async();
}

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

// A 4-D map (d, s, h, b) over one 16-bit input, from its own sizes and
// element strides st = (b, h, s), boxes of chunk_cols(d) columns x `rows`
// rows in the swizzle of their row width (128B at d >= 64, 64B at d = 32,
// 32B at d = 16), zeros outside the tensor.
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
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(chunk_cols(d)),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const uint32_t rb = row_bytes(d);
  const CUtensorMapSwizzle swizzle = rb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : rb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                          elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
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
