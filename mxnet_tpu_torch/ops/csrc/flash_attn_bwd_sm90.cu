// Flash-attention backward for Hopper tensor cores (sm_90a), bf16 and fp16.
//
// Replaces the gradient of the Pallas TPU kernel in
// mxnet_tpu/ops/pallas_kernels.py: the custom_vjp backward _bwd:198, which
// calls the jnp recompute _chunked_attn_grads:132 (flash_attention:178), for
// 16-bit inputs at head dims 64 and 128.  It computes the same function per
// (batch, head), in fp32 from the loaded q, k, v and output gradient do:
//   s  = q k^T * scale, masked to -1e30 (keys past S; causal: key > query)
//   p  = softmax(s) over the keys
//   dv = p^T do          dp = do v^T          delta_i = sum_j p_ij dp_ij
//   ds = p (dp - delta), zero where masked
//   dq = ds k * scale    dk = ds^T q * scale
// The products run on the tensor cores, so p and ds are rounded to the
// input type where they enter one (as A operands from registers); s, dp,
// p, delta, ds and the three sums stay fp32, and dq, dk, dv are rounded
// once, when stored.  fp32, and D in {16, 32}, go to the SIMT kernel in
// flash_attn_bwd.cu, which takes the same arguments.
//
// Numerics.  ds = p (dp - delta) cancels in rows where one key takes
// nearly all the probability, and there dq's row is small against the
// terms it sums: the row's result rests on delta's last bits.  So delta is
// summed from the fp32 p and dp (not taken as rowsum(do * o) from the 16-bit
// output o, as FlashAttention-2/3 do: o's 8 bits in bf16 leave dq wrong by
// O(1) of its row), and p comes from the row's own max and sum, found
// online in the first sweep as the forward finds them: the dominant key's
// 2^(x - max) is exactly 1, so its p dp is exact.  Measured on the H100, a
// p taken from a saved log-sum-exp instead, 2^(x - lse), left such a row
// 0.048 of its maximum from the plain version (bf16, (2, 4, 200, 64)
// causal, sm_scale 0.5), four times the check's limit; the online
// statistics match the SIMT kernel's arithmetic.  x = s scale log2e is
// rounded once by __fmul_rn, never fused, so both sweeps see its bits.
//
// Design: two launches on one stream, deterministic, no atomics, no memset.
// Both use the forward's shape: one producer warp bringing tiles by TMA
// (4-D, through each tensor's own strides) into a two-stage ring of
// mbarriers, and consumer warpgroups of 64 rows issuing wgmma.
//   A. "statistics + dq": one block per (b*h, tile of 64 * kWG query rows),
//      kWG consumer warpgroups (2 at D = 64, 1 at D = 128).  Q and dO come
//      in once; the K and V tiles (64 keys) twice, in two sweeps.
//        sweep 1: S = Q K^T and dP = dO V^T; per row the running max m of
//                 x, l = sum 2^(x - m) and t = sum 2^(x - m) dp, rescaled
//                 when m grows; reduced over the 4 lanes of a row; then
//                 m, 1/l and delta = t / l to fp32 scratch [3, B*H, S].
//        sweep 2: S and dP again; p = 2^(x - m) / l; dS = P (dP - delta)
//                 rounded to the input type as the A fragment; dQ += dS K
//                 (K MN-major).
//      dq * scale is stored once.
//   B. "dk + dv": one block per (b*h, 64 keys), one consumer warpgroup with
//      the keys as its M rows.  K and V come in once; Q and dO tiles (64
//      queries, 32 at D = 128) stream through the ring over the query tiles
//      that see these keys (causal: from the diagonal on), and the producer
//      warp stages each tile's m, 1/l and delta in shared memory beside them.
//        S^T = K Q^T, dP^T = V dO^T; P^T and dS^T in fp32, rounded as A
//        fragments; dV += P^T dO and dK += dS^T Q (dO and Q MN-major).
//      dk * scale and dv are stored once.  B follows A in stream order,
//      which is what makes the statistics ready.
// Every operand form is one the forward uses: A and B K-major from shared
// memory (Q, dO, K, V as [rows, D] tiles), A from registers in the
// accumulator's layout (pack2), and B MN-major with the transpose bit.
// Only the diagonal (causal) and ragged tiles are masked.  Each output
// element is written by one thread after sums in a fixed order, so two
// calls on the same inputs give the same bits, as the JAX scan does.
// Atomic adds into dq from launch B would save 2 of the 9 products (7
// against 9), but the result would change from run to run.
//
// Registers (ptxas -v, sm_90a, CUDA 12.8): launch A 144 at D = 64 (two
// warpgroups, 288 threads, under their cap of 168: S, dP and dQ, 3 x 32
// fp32, and dS's fragments) and 168 at D = 128 (dQ doubles, so one
// warpgroup, 160 threads, cap 255); launch B 182 at D = 64 and 202 at
// D = 128 (one warpgroup: S^T, dP^T, dK and dV, 4 x 32 fp32 at D = 64 on
// 64-query tiles; dK and dV double at D = 128, on 32-query tiles); no
// spills in any of them.
//
// What bounds it on the H100 (3.35 TB/s; 989 TFLOP/s bf16/fp16 dense).
// Causal, B=8, H=12, S=1024, D=64: the gradient's five products take
// 10*D FLOPs per kept (query, key) pair, 10*64*S(S+1)/2*B*H = 32.2 GFLOP,
// 0.0326 ms, against 7 * 8*12*1024*64 * 2 B = 88 MB of q, k, v, do, dq, dk,
// dv, 0.026 ms: bound by operations.  This design does nine products (two
// in sweep 1, three in sweep 2, four in B), 58.0 GFLOP, 0.0587 ms at peak.
// What it leaves on the table: no ping-pong between warpgroups, no
// setmaxnreg, one warpgroup in launch B, no persistent grid.
#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kStages = 2;
constexpr int kTile = 64;   // keys per K/V tile (A) and per block (B)

// Launch A's consumer warpgroups (64 query rows each) per block.
template <int D>
__host__ __device__ constexpr int dq_warpgroups() { return D == 64 ? 2 : 1; }
template <int D>
__host__ __device__ constexpr int dq_threads() { return 32 * (4 * dq_warpgroups<D>() + 1); }
// Launch B's queries per Q/dO tile.
template <int D>
__host__ __device__ constexpr int dkdv_block_q() { return D == 64 ? 64 : 32; }
constexpr int kDkdvThreads = 32 * 5;

// Bytes of shared memory: one 1024-aligned region of tiles, then the
// staged statistics (B) and the mbarriers.
template <int D>
__host__ __device__ constexpr size_t dq_smem() {
  return 1024 + 2 * (2 * D * 64 * dq_warpgroups<D>()) + 2 * kStages * (2 * D * kTile) +
         8 * (2 * kStages + 1);
}
template <int D>
__host__ __device__ constexpr size_t dkdv_smem() {
  return 1024 + 2 * (2 * D * kTile) + 2 * kStages * (2 * D * dkdv_block_q<D>()) +
         kStages * 3 * dkdv_block_q<D>() * 4 + 8 * (2 * kStages + 1);
}

struct Params {
  // [3, B*H, S], written by A, read by B: per query row the max of its
  // scaled scores in log2 units, 1 / sum_j 2^(x_j - max), and delta
  float* stats;
  void* dq;
  void* dk;
  void* dv;
  int heads, seq_len, causal;
  float scale, scale_log2;
};

// a = A1 B1^T and b = A2 B2^T over D, each 64 x N (N = 2 * NREG), all four
// operands K-major in shared memory; both chains in one commit group.
template <typename Tg, int D, int NREG>
__device__ __forceinline__ void two_products(float (&a)[NREG], float (&b)[NREG],
                                             uint32_t a1, uint32_t b1, uint32_t a2,
                                             uint32_t b2, uint32_t a_chunk,
                                             uint32_t b_chunk) {
  fence_regs(a);
  fence_regs(b);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(a, desc_k_major(a1, kk, a_chunk), desc_k_major(b1, kk, b_chunk), kk > 0,
             Tg());
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(b, desc_k_major(a2, kk, a_chunk), desc_k_major(b2, kk, b_chunk), kk > 0,
             Tg());
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(a);
  fence_regs(b);
}

// Stores a 64-row fp32 accumulator (kChunks x 32 registers a thread, the
// m64n64 layout) times `mul`, rounded to T, into rows row0 and row0 + 8 of a
// contiguous [B*H, S, D] tensor; rows past S are not stored.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[D / kChunk][32],
                                           int bh, int row0, int t, int seq_len,
                                           float mul) {
  using Tg = typename Tag<T>::type;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= seq_len) continue;
    T* orow = out + (static_cast<size_t>(bh) * seq_len + row) * D;
#pragma unroll
    for (int c = 0; c < D / kChunk; ++c)
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<uint32_t*>(orow + c * kChunk + 8 * j + 2 * t) =
            pack2(acc[c][i] * mul, acc[c][i + 1] * mul, Tg());
      }
  }
}

// -- A: statistics and dq ---------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(dq_threads<D>(), 1)
flash_attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo, const Params p) {
  using Tg = typename Tag<T>::type;
  constexpr int kWG = dq_warpgroups<D>();
  constexpr int kRows = 64 * kWG;
  constexpr int kChunks = D / kChunk;
  constexpr uint32_t kQChunkBytes = kRows * 128;
  constexpr uint32_t kQBytes = kChunks * kQChunkBytes;     // Q, or dO
  constexpr uint32_t kKChunkBytes = kTile * 128;
  constexpr uint32_t kTileBytes = kChunks * kKChunkBytes;  // one K or V tile

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sdo = sq + kQBytes;
  const uint32_t sk = sdo + kQBytes;                // kStages K tiles
  const uint32_t sv = sk + kStages * kTileBytes;    // kStages V tiles
  const uint32_t bar_full = sv + kStages * kTileBytes;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_q = bar_empty + 8 * kStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int bi = bh / p.heads, hi = bh % p.heads;
  const int seq_len = p.seq_len;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest first
  int n_k = (seq_len + kTile - 1) / kTile;
  if (p.causal) n_k = min(n_k, (q0 + kRows - 1) / kTile + 1);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 4 * kWG);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kWG) {  // the producer: TMA only
    if (lane == 0) {
      mbar_expect_tx(bar_q, 2 * kQBytes);
      for (int c = 0; c < kChunks; ++c)
        for (int w = 0; w < kWG; ++w) {
          const uint32_t off = c * kQChunkBytes + w * 64 * 128;
          tma_load(sq + off, &tq, bar_q, c * kChunk, q0 + 64 * w, hi, bi);
          tma_load(sdo + off, &tdo, bar_q, c * kChunk, q0 + 64 * w, hi, bi);
        }
      // the K/V tiles twice: sweep 1, then sweep 2
      for (int it = 0; it < 2 * n_k; ++it) {
        const int kt = it < n_k ? it : it - n_k;
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(bar_empty + 8 * st, ((it / kStages) - 1) & 1);
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * kTileBytes);
        for (int c = 0; c < kChunks; ++c) {
          const uint32_t off = st * kTileBytes + c * kKChunkBytes;
          tma_load(sk + off, &tk, full, c * kChunk, kt * kTile, hi, bi);
          tma_load(sv + off, &tv, full, c * kChunk, kt * kTile, hi, bi);
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
  const uint32_t q_wg = sq + wg * 64 * 128, do_wg = sdo + wg * 64 * 128;
  // the key tiles this warpgroup's own 64 rows see
  const int n_k_wg = p.causal ? min(n_k, (q0 + 64 * wg + 63) / kTile + 1) : n_k;

  float s_acc[kTile / 2], dp_acc[kTile / 2];
  // per row half: the running max m of x = s scale log2e, l = sum 2^(x - m)
  // and t = sum 2^(x - m) dp, each over this thread's columns
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, tsum[2] = {0.f, 0.f};

  // x of accumulator register i of the key tile at k0, -1e30 where masked;
  // rounded once (__fmul_rn is never fused), so both sweeps get its bits
  auto score = [&](int i, int k0, bool masked) {
    float x = __fmul_rn(s_acc[i], p.scale_log2);
    if (masked) {
      const int kp = k0 + 8 * (i / 4) + 2 * t + (i % 2);
      const int qp = row0 + 8 * ((i / 2) % 2);
      if (kp >= seq_len || (p.causal && kp > qp)) x = kNeg;
    }
    return x;
  };

  mbar_wait(bar_q, 0);
  // sweep 1: the row statistics and delta, online as the forward does
  for (int it = 0; it < n_k; ++it) {
    const int st = it % kStages;
    mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
    if (it < n_k_wg)
      two_products<Tg, D>(s_acc, dp_acc, q_wg, sk + st * kTileBytes, do_wg,
                          sv + st * kTileBytes, kQChunkBytes, kKChunkBytes);
    // the products are done with the stage; the rest is in registers
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);
    if (it >= n_k_wg) continue;
    const int k0 = it * kTile;
    const bool masked =
        k0 + kTile > seq_len || (p.causal && k0 + kTile - 1 > q0 + 64 * wg);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) {
      s_acc[i] = score(i, k0, masked);
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s_acc[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      const float corr = fast_exp2(m[r] - m_new);
      l[r] *= corr;
      tsum[r] *= corr;
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) {
      const int r = (i / 2) % 2;
      const float e = fast_exp2(s_acc[i] - m[r]);
      l[r] += e;
      tsum[r] += e * dp_acc[i];
    }
  }
  // a key that takes a whole row (causal row 0) has e = 2^0 = 1 exactly, so
  // its p is 1 and its ds = dp - delta is exactly 0, as in the plain version
  float inv_l[2], delta[2];
  const size_t n_rows = static_cast<size_t>(gridDim.x) * seq_len;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    tsum[r] += __shfl_xor_sync(0xffffffffu, tsum[r], 1);
    tsum[r] += __shfl_xor_sync(0xffffffffu, tsum[r], 2);
    inv_l[r] = 1.f / l[r];
    delta[r] = tsum[r] * inv_l[r];
    const int row = row0 + 8 * r;
    if (t == 0 && row < seq_len) {
      float* at = p.stats + static_cast<size_t>(bh) * seq_len + row;
      at[0] = m[r];
      at[n_rows] = inv_l[r];
      at[2 * n_rows] = delta[r];
    }
  }

  // sweep 2: dq
  float dq_acc[kChunks][32];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[c][i] = 0.f;
  for (int it = n_k; it < 2 * n_k; ++it) {
    const int kt = it - n_k;
    const int st = it % kStages;
    const uint32_t k_st = sk + st * kTileBytes;
    mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
    if (kt >= n_k_wg) {
      // skipped, but released like a visited tile, so the producer's ring
      // stays in step
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
      continue;
    }
    two_products<Tg, D>(s_acc, dp_acc, q_wg, k_st, do_wg, sv + st * kTileBytes,
                        kQChunkBytes, kKChunkBytes);
    const int k0 = kt * kTile;
    const bool masked =
        k0 + kTile > seq_len || (p.causal && k0 + kTile - 1 > q0 + 64 * wg);
    uint32_t ds[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * kk + 2 * j;  // registers i, i+1: row half j % 2
        const int r = j % 2;
        const float p0 = fast_exp2(score(i, k0, masked) - m[r]) * inv_l[r];
        const float p1 = fast_exp2(score(i + 1, k0, masked) - m[r]) * inv_l[r];
        const float d0 = p0 * (dp_acc[i] - delta[r]);
        const float d1 = p1 * (dp_acc[i + 1] - delta[r]);
        ds[kk][j] = pack2(d0, d1, Tg());
      }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) fence_regs(dq_acc[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        wgmma_rs(dq_acc[c], ds[kk], desc_mn_major(k_st, kk, c, kKChunkBytes), Tg());
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < kChunks; ++c) fence_regs(dq_acc[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);
  }
  store_rows<T, D>(static_cast<T*>(p.dq), dq_acc, bh, row0, t, seq_len, p.scale);
}

// -- B: dk and dv ----------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kDkdvThreads, 1)
flash_attn_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo, const Params p) {
  using Tg = typename Tag<T>::type;
  constexpr int kBQ = dkdv_block_q<D>();
  constexpr int kChunks = D / kChunk;
  constexpr uint32_t kKChunkBytes = kTile * 128;
  constexpr uint32_t kKBytes = kChunks * kKChunkBytes;     // K, or V
  constexpr uint32_t kQChunkBytes = kBQ * 128;
  constexpr uint32_t kQTileBytes = kChunks * kQChunkBytes;  // one Q or dO tile

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sk = base;
  const uint32_t sv = sk + kKBytes;
  const uint32_t sq = sv + kKBytes;                  // kStages Q tiles
  const uint32_t sdo = sq + kStages * kQTileBytes;   // kStages dO tiles
  const uint32_t sstat = sdo + kStages * kQTileBytes;
  // per stage: m, 1/l and delta of the tile's kBQ queries
  float* stat = reinterpret_cast<float*>(smem_raw + (sstat - raw));
  const uint32_t bar_full = sstat + kStages * 3 * kBQ * 4;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_kv = bar_empty + 8 * kStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int bi = bh / p.heads, hi = bh % p.heads;
  const int seq_len = p.seq_len;
  const int k0 = blockIdx.y * kTile;  // the first key tiles see the most queries
  const int n_q = (seq_len + kBQ - 1) / kBQ;
  const int qt0 = p.causal ? k0 / kBQ : 0;
  const int n_it = n_q - qt0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 32);  // every producer lane stages statistics
      mbar_init(bar_empty + 8 * st, 4);
    }
    mbar_init(bar_kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // the producer: TMA, and the statistics of each query tile
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * kKBytes);
      for (int c = 0; c < kChunks; ++c) {
        tma_load(sk + c * kKChunkBytes, &tk, bar_kv, c * kChunk, k0, hi, bi);
        tma_load(sv + c * kKChunkBytes, &tv, bar_kv, c * kChunk, k0, hi, bi);
      }
    }
    for (int it = 0; it < n_it; ++it) {
      const int q0 = (qt0 + it) * kBQ;
      const int st = it % kStages;
      if (it >= kStages) mbar_wait(bar_empty + 8 * st, ((it / kStages) - 1) & 1);
      float* st_stat = stat + st * 3 * kBQ;
      const size_t n_rows = static_cast<size_t>(gridDim.x) * seq_len;
      for (int j = lane; j < kBQ; j += 32) {
        const int q = q0 + j;
        const float* at = p.stats + static_cast<size_t>(bh) * seq_len + q;
        for (int a = 0; a < 3; ++a) st_stat[a * kBQ + j] = q < seq_len ? at[a * n_rows] : 0.f;
      }
      const uint32_t full = bar_full + 8 * st;
      if (lane == 0) {
        mbar_expect_tx(full, 2 * kQTileBytes);
        for (int c = 0; c < kChunks; ++c) {
          const uint32_t off = st * kQTileBytes + c * kQChunkBytes;
          tma_load(sq + off, &tq, full, c * kChunk, q0, hi, bi);
          tma_load(sdo + off, &tdo, full, c * kChunk, q0, hi, bi);
        }
      } else {
        mbar_arrive(full);
      }
    }
    return;
  }

  // Consumers: one warpgroup, the block's 64 keys as rows; columns are the
  // tile's queries.
  const int t = lane % 4;
  const int krow0 = k0 + 16 * warp + lane / 4;
  float dk_acc[kChunks][32], dv_acc[kChunks][32];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[c][i] = dv_acc[c][i] = 0.f;
  float s_acc[kBQ / 2], dp_acc[kBQ / 2];

  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_it; ++it) {
    const int q0 = (qt0 + it) * kBQ;
    const int st = it % kStages;
    const uint32_t q_st = sq + st * kQTileBytes, do_st = sdo + st * kQTileBytes;
    mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
    two_products<Tg, D>(s_acc, dp_acc, sk, q_st, sv, do_st, kKChunkBytes, kQChunkBytes);
    const bool masked = q0 + kBQ > seq_len || k0 + kTile > seq_len ||
                        (p.causal && q0 < k0 + kTile - 1);
    const float* mst = stat + st * 3 * kBQ;
    const float* inv = mst + kBQ;
    const float* dlt = inv + kBQ;
    uint32_t pf[kBQ / 16][4], df[kBQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * kk + 2 * j;  // registers i, i+1: key row half j % 2
        const int col = 8 * (i / 4) + 2 * t;
        const float2 mq = *reinterpret_cast<const float2*>(mst + col);
        const float2 il = *reinterpret_cast<const float2*>(inv + col);
        const float2 dl = *reinterpret_cast<const float2*>(dlt + col);
        float p0 = fast_exp2(__fmul_rn(s_acc[i], p.scale_log2) - mq.x) * il.x;
        float p1 = fast_exp2(__fmul_rn(s_acc[i + 1], p.scale_log2) - mq.y) * il.y;
        if (masked) {
          const int kp = krow0 + 8 * (j % 2), qp = q0 + col;
          const bool key_out = kp >= seq_len;
          if (key_out || qp >= seq_len || (p.causal && kp > qp)) p0 = 0.f;
          if (key_out || qp + 1 >= seq_len || (p.causal && kp > qp + 1)) p1 = 0.f;
        }
        pf[kk][j] = pack2(p0, p1, Tg());
        df[kk][j] = pack2(p0 * (dp_acc[i] - dl.x), p1 * (dp_acc[i + 1] - dl.y), Tg());
      }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      fence_regs(dk_acc[c]);
      fence_regs(dv_acc[c]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        wgmma_rs(dv_acc[c], pf[kk], desc_mn_major(do_st, kk, c, kQChunkBytes), Tg());
        wgmma_rs(dk_acc[c], df[kk], desc_mn_major(q_st, kk, c, kQChunkBytes), Tg());
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      fence_regs(dk_acc[c]);
      fence_regs(dv_acc[c]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);
  }
  store_rows<T, D>(static_cast<T*>(p.dk), dk_acc, bh, krow0, t, seq_len, p.scale);
  store_rows<T, D>(static_cast<T*>(p.dv), dv_acc, bh, krow0, t, seq_len, 1.f);
}

// maps: q, k, v, dO with 64-row boxes (A; K and V also B), then q and dO
// with dkdv_block_q<D>()-row boxes (B)
template <typename T, int D>
cudaError_t launch(const CUtensorMap* maps, const Params& p, int bh, cudaStream_t stream) {
  const int s = p.seq_len;
  auto ka = flash_attn_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(ka, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dq_smem<D>()));
  if (err != cudaSuccess) return err;
  const int rows_a = 64 * dq_warpgroups<D>();
  ka<<<dim3(bh, (s + rows_a - 1) / rows_a), dq_threads<D>(), dq_smem<D>(), stream>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kb = flash_attn_bwd_dkdv_kernel<T, D>;
  err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkdv_smem<D>()));
  if (err != cudaSuccess) return err;
  kb<<<dim3(bh, (s + kTile - 1) / kTile), kDkdvThreads, dkdv_smem<D>(), stream>>>(
      maps[4], maps[1], maps[2], maps[5], p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const CUtensorMap* maps, const Params& p, int bh, int d,
                       cudaStream_t s) {
  switch (d) {
    case 64: return launch<T, 64>(maps, p, bh, s);
    case 128: return launch<T, 128>(maps, p, bh, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, dout [batch, heads, seq_len, d] with d in {64, 128}, read through
// their strides: 12 element strides, (batch, head, sequence) of q, k, v, then
// dout, each times 2 bytes a multiple of 16, the last stride 1 and every
// pointer 16-byte aligned.  dq, dk, dv: new contiguous [batch, heads,
// seq_len, d] of the input type.  stats: fp32 scratch of 3 * batch * heads *
// seq_len.  dtype: 1 = bf16, 2 = fp16.  The arguments are flash_attn_bwd's.
// Returns a cudaError_t; 0 is success.
extern "C" int flash_attn_bwd_sm90(const void* q, const void* k, const void* v,
                                   const void* dout, void* dq, void* dk, void* dv,
                                   void* stats, int batch, int heads, int seq_len, int d,
                                   const long long* strides, int dtype, int causal,
                                   float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || seq_len <= 0 || (seq_len + kTile - 1) / kTile > 65535 ||
      (d != 64 && d != 128))
    return cudaErrorInvalidValue;
  CUtensorMapDataType type;
  if (!map_type(dtype, &type)) return cudaErrorInvalidValue;
  const int rows_b = d == 64 ? dkdv_block_q<64>() : dkdv_block_q<128>();
  const void* ptrs[6] = {q, k, v, dout, q, dout};
  const int which[6] = {0, 1, 2, 3, 0, 3};  // whose strides
  CUtensorMap maps[6];
  for (int i = 0; i < 6; ++i) {
    const cudaError_t err = make_map(&maps[i], ptrs[i], type, batch, heads, seq_len, d,
                                     strides + 3 * which[i], i < 4 ? kTile : rows_b);
    if (err != cudaSuccess) return err;
  }
  Params p;
  p.stats = static_cast<float*>(stats);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.heads = heads;
  p.seq_len = seq_len;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? dispatch_d<__nv_bfloat16>(maps, p, batch * heads, d, s)
                    : dispatch_d<__half>(maps, p, batch * heads, d, s);
}
