// Flash-attention forward for Hopper tensor cores (sm_90a), bf16 and fp16.
//
// Replaces the Pallas TPU kernel mxnet_tpu/ops/pallas_kernels.py
// (_attn_kernel:41, launched by _flash_fwd_impl:95, public flash_attention:178)
// for 16-bit inputs at head dims 64 and 128.  It computes the same function:
//   o = softmax(mask(q @ k^T * sm_scale)) @ v   per (batch, head),
// with the product, sm_scale, running max m, running sum l and output sum
// all in fp32, masked scores set to -1e30, causal masking by absolute
// position, key tiles wholly in the future of a query tile never visited,
// and a final division by max(l, 1e-30) rounded once to the input type.
// The probabilities are rounded to the input type before P @ V, as the
// tensor cores take them; the sum l is taken before that rounding.
// fp32, and 16-bit inputs at D in {16, 32}, go to the SIMT kernel in
// flash_attn_fwd.cu.
//
// Design.  One block per (b*h, 128-row query tile), 288 threads: two
// consumer warpgroups of 64 query rows each and one producer warp.  The
// TPU's sequential k grid axis becomes a loop over K/V tiles of 128 keys
// (64 at D = 128).
//   - Copies: the producer's lane 0 brings the query tile and then each
//     K and V tile in by TMA (cp.async.bulk.tensor, 4-D, from each
//     tensor's own sizes and strides, so strided views need no copy) into
//     a ring of two stages.  Each stage has a "full" mbarrier (TMA bytes)
//     and an "empty" one (one arrival per consumer warp), so the next
//     tile's copy runs while this tile's products do.  Rows past S come in
//     as zeros (TMA's out-of-bounds fill) and their keys are masked.
//   - Products on the tensor cores by wgmma.mma_async: S = Q K^T as
//     m64n128k16 (m64n64k16 at D = 128) with Q and K from shared memory
//     (both K-major, the 128B swizzle that TMA writes); O += P V as m64n64k16 per 64 columns of D
//     with P from registers (the fp32 accumulator of S, rounded pairwise
//     to bf16x2/f16x2, is laid out as the A fragment) and V from shared
//     memory, MN-major (transpose bit set).
//   - Softmax in registers: each thread owns 2 rows of its warp's 16; a
//     row's max and sum reduce over the 4 lanes that share it.  m, l and
//     the output accumulator never leave registers.
//   - The two warpgroups interleave: one's softmax runs while the other's
//     products hold the tensor cores.
//   - Each warpgroup visits only the key tiles its own 64 rows see (at
//     D = 128 the block's last causal tile is wholly in warpgroup 0's
//     future); only the diagonal tile (causal) and the tile holding key S-1
//     are masked; heavier (later) query tiles are scheduled first.
//
// What bounds it on the H100 (3.35 TB/s; 989 TFLOP/s bf16/fp16 dense).
// Causal, B=8, H=12, S=1024, D=64: q/k/v/o 50.3 MB -> 15.0 us; 4*D*S(S+1)/2
// *B*H = 12.9 GFLOP -> 13.0 us: bound by bytes at ~15 us, with operations
// close behind.  Measured on the H100 (PERF.md), a third stage and a software
// pipeline that starts S of tile j with P V of tile j - 1 were both slower
// than this serial loop.  What this design leaves on the table: no explicit
// ping-pong schedule between the two warpgroups, no register rebalancing
// (setmaxnreg) between producer and consumers, one block per SM, the output
// stored from registers in 4-byte pieces rather than by TMA, and no
// persistent grid, so the tail of the causal schedule is not balanced.
#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kBlockQ = 128;              // two warpgroups of 64 rows
// Keys per K/V tile: 128 at D = 64; 64 at D = 128, where S, O and P of a
// 128-key tile spill from the 168 registers a thread of 288 may hold.
template <int D>
__host__ __device__ constexpr int block_k() { return D == 64 ? 128 : 64; }
constexpr int kStages = 2;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * (kConsumerWarps + 1);

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           T* __restrict__ o, int heads, int seq_len,
                           float scale_log2, int causal) {
  using Tg = typename Tag<T>::type;
  constexpr int kBlockK = block_k<D>();
  constexpr int kChunks = D / kChunk;
  constexpr uint32_t kQChunkBytes = kBlockQ * 128;  // rows of 64 columns
  constexpr uint32_t kKChunkBytes = kBlockK * 128;
  constexpr uint32_t kQBytes = kChunks * kQChunkBytes;
  constexpr uint32_t kTileBytes = kChunks * kKChunkBytes;  // one K or V tile

  // The 128B swizzle repeats every 1024 bytes; the descriptors assume each
  // tile starts on that boundary.
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = sq + kQBytes;                 // kStages K tiles
  const uint32_t sv = sk + kStages * kTileBytes;    // kStages V tiles
  const uint32_t bar_full = sv + kStages * kTileBytes;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_q = bar_empty + 8 * kStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int bi = bh / heads, hi = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // heaviest first
  int n_k = (seq_len + kBlockK - 1) / kBlockK;
  if (causal) n_k = min(n_k, (q0 + kBlockQ - 1) / kBlockK + 1);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kConsumerWarps);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer: TMA only
    if (lane == 0) {
      mbar_expect_tx(bar_q, kQBytes);
      for (int c = 0; c < kChunks; ++c)
        tma_load(sq + c * kQChunkBytes, &tq, bar_q, c * kChunk, q0, hi, bi);
      for (int kt = 0; kt < n_k; ++kt) {
        const int st = kt % kStages;
        if (kt >= kStages) mbar_wait(bar_empty + 8 * st, ((kt / kStages) - 1) & 1);
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * kTileBytes);
        for (int c = 0; c < kChunks; ++c) {
          const uint32_t off = st * kTileBytes + c * kKChunkBytes;
          tma_load(sk + off, &tk, full, c * kChunk, kt * kBlockK, hi, bi);
          tma_load(sv + off, &tv, full, c * kChunk, kt * kBlockK, hi, bi);
        }
      }
    }
    return;
  }

  // Consumers.  Accumulator layout of m64nN: thread (warp w of the
  // warpgroup, lane) holds rows 16w + lane/4 and that + 8, columns
  // 8j + 2(lane%4) + {0, 1}; register i is row half (i/2)%2, column group i/4.
  const int wg = warp / 4;
  const int t = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const uint32_t q_wg = sq + wg * 64 * 128;

  float s_acc[kBlockK / 2];
  float o_acc[kChunks][kChunk / 2];
#pragma unroll
  for (int i = 0; i < kBlockK / 2; ++i) s_acc[i] = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i) o_acc[c][i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  // The tiles this warpgroup's own 64 rows see: at D = 128 (64-key tiles)
  // the block's last causal tile lies wholly in warpgroup 0's future.
  const int n_k_wg = causal ? min(n_k, (q0 + 64 * wg + 63) / kBlockK + 1) : n_k;

  mbar_wait(bar_q, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt % kStages;
    const int k0 = kt * kBlockK;
    const uint32_t k_st = sk + st * kTileBytes, v_st = sv + st * kTileBytes;
    mbar_wait(bar_full + 8 * st, (kt / kStages) & 1);
    if (kt >= n_k_wg) {
      // skipped, but released like a visited tile, so the producer's ring
      // stays in step; waiting for "full" first keeps this arrival out of
      // the stage's previous phase
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
      continue;
    }

    // S = Q K^T, 16 columns of D per instruction
    fence_regs(s_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes in the row
      wgmma_ss(s_acc, smem_desc(q_wg + (kk / 4) * kQChunkBytes + off, 16, 1024),
               smem_desc(k_st + (kk / 4) * kKChunkBytes + off, 16, 1024), kk > 0,
               Tg());
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s_acc);

    // scale to log2 units, mask (only the diagonal and the tail tile),
    // online softmax; P rounded pairwise into the A fragments of P V
    const bool masked =
        k0 + kBlockK > seq_len || (causal && k0 + kBlockK - 1 > q0 + 64 * wg);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) {
      float x = s_acc[i] * scale_log2;
      if (masked) {
        const int kp = k0 + 8 * (i / 4) + 2 * t + (i % 2);
        const int qp = row0 + 8 * ((i / 2) % 2);
        if (kp >= seq_len || (causal && kp > qp)) x = kNeg;
      }
      s_acc[i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
    uint32_t p[kBlockK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * kk + 2 * j;  // registers i, i+1: row half j % 2
        const float p0 = fast_exp2(s_acc[i] - m[j % 2]);
        const float p1 = fast_exp2(s_acc[i + 1] - m[j % 2]);
        l[j % 2] += p0 + p1;
        p[kk][j] = pack2(p0, p1, Tg());
      }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int i = 0; i < kChunk / 2; ++i) o_acc[c][i] *= corr[(i / 2) % 2];
      fence_regs(o_acc[c]);
    }

    // O += P V, 16 keys per instruction, 64 columns of D each
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        wgmma_rs(o_acc[c], p[kk],
                 smem_desc(v_st + c * kKChunkBytes + kk * 16 * 128, kKChunkBytes, 1024),
                 Tg());
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < kChunks; ++c) fence_regs(o_acc[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);  // this warp is done with the stage
  }

  // o = acc / max(l, 1e-30), one rounding; rows past S are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= seq_len) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + (static_cast<size_t>(bh) * seq_len + row) * D;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<uint32_t*>(orow + c * kChunk + 8 * j + 2 * t) =
            pack2(o_acc[c][i] / denom, o_acc[c][i + 1] / denom, Tg());
      }
  }
}

template <typename T, int D>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   void* o, int bh, int heads, int seq_len, float scale_log2,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem =
      1024 + 2 * D * (kBlockQ + 2 * kStages * block_k<D>()) + 8 * (2 * kStages + 1);
  auto kernel = flash_attn_fwd_sm90_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq_len + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, static_cast<T*>(o), heads,
                                           seq_len, scale_log2, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const CUtensorMap* maps, void* o, int bh, int heads,
                       int seq_len, int d, float scale_log2, int causal,
                       cudaStream_t s) {
  switch (d) {
    case 64:
      return launch<T, 64>(maps[0], maps[1], maps[2], o, bh, heads, seq_len, scale_log2,
                           causal, s);
    case 128:
      return launch<T, 128>(maps[0], maps[1], maps[2], o, bh, heads, seq_len, scale_log2,
                            causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v [batch, heads, seq_len, d] with d in {64, 128}; strides: 9 element
// strides, (batch, head, sequence) of q, then k, then v, each times 2 bytes a
// multiple of 16, the last stride 1 and every pointer 16-byte aligned.  o is
// a contiguous [batch, heads, seq_len, d].  dtype: 1 = bf16, 2 = fp16.
// Returns a cudaError_t; 0 is success.
extern "C" int flash_attn_fwd_sm90(const void* q, const void* k, const void* v,
                                   void* o, int batch, int heads, int seq_len, int d,
                                   const long long* strides, int dtype, int causal,
                                   float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || seq_len <= 0 ||
      (seq_len + kBlockQ - 1) / kBlockQ > 65535 || (d != 64 && d != 128))
    return cudaErrorInvalidValue;
  CUtensorMapDataType type;
  if (!map_type(dtype, &type)) return cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const int rows_k = d == 64 ? block_k<64>() : block_k<128>();
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = make_map(&maps[i], ptrs[i], type, batch, heads, seq_len, d,
                                     strides + 3 * i, i == 0 ? kBlockQ : rows_k);
    if (err != cudaSuccess) return err;
  }
  const float scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? dispatch_d<__nv_bfloat16>(maps, o, batch * heads, heads, seq_len, d,
                                         scale_log2, causal, s)
             : dispatch_d<__half>(maps, o, batch * heads, heads, seq_len, d,
                                  scale_log2, causal, s);
}
