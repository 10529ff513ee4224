// Flash-attention backward for Hopper tensor cores (sm_90a), fp32, through a
// three-way bf16 split of every operand.
//
// Replaces the gradient of the Pallas TPU kernel in
// mxnet_tpu/ops/pallas_kernels.py: the custom_vjp backward _bwd:198, which
// calls the jnp recompute _chunked_attn_grads:132 (flash_attention:178), for
// fp32 inputs at head dims 16, 32, 64 and 128, in place of the SIMT kernel
// flash_attn_bwd.cu (three passes of fp32 FMAs), which it replaced at D 64
// and 128 first and then at D 16 and 32.  It computes the same
// function per (batch, head), in fp32 from q, k, v and the output gradient do:
//   s  = q k^T * scale, masked to -1e30 (keys past S; causal: key > query)
//   p  = softmax(s) over the keys
//   dv = p^T do          dp = do v^T          delta_i = sum_j p_ij dp_ij
//   ds = p (dp - delta), zero where masked
//   dq = ds k * scale    dk = ds^T q * scale
//
// fp32 on the tensor cores: every operand is split into three bf16 parts,
// x = x0 + x1 + x2 (sm90_common.cuh: split3), and every product of the
// function is the six products a_i b_j with i + j <= 2, issued smallest
// first into one fp32 accumulator (the terms left out are below 2^-23 of
// the product).  q, do, k and v are split by the producer as they are
// loaded; p and ds, the A operands from registers, one 16-key slice into
// three A fragments each.  Everything else is the arithmetic that the fp32
// check holds in sharp-softmax rows: q is scaled before its
// products (dk then needs no scale), the scores stay in natural units,
// e = expf(s - m) with the row's own max m and sum l found online in the
// first sweep (the dominant key's e is exactly 1, so its p dp is exact; no
// log-sum-exp from the forward), and delta = sum_j e dp / l in fp32, not
// rowsum(do o).
//
// Design: the two launches on one stream of flash_attn_bwd_sm90.cu,
// deterministic, no atomics, each with a producer warpgroup that loads fp32
// rows through each tensor's own strides, splits them and stores the three
// bf16 tiles in the swizzle TMA would write (sm90_common.cuh: 128B in
// 64-column chunks at D >= 64, 64B at D = 32, 32B at D = 16), into a
// two-stage mbarrier
// ring ("full": one arrival per producer thread after a proxy fence;
// "empty": one per consumer warp), and one consumer warpgroup issuing wgmma.
//   A. "statistics + dq": one block per (b*h, 64 query rows).  Q (scaled) and
//      dO are split once; the K and V tiles (64 keys, 32 at D = 128) twice,
//      once per sweep.
//        sweep 1: S = Qs K^T and dP = dO V^T; per row the running max m,
//                 l = sum e^(s - m) and t = sum e^(s - m) dp, rescaled when
//                 m grows; then m, 1/l and delta = t / l to fp32 scratch
//                 [3, B*H, S].
//        sweep 2: S and dP again; p = e^(s - m) / l; dS = P (dP - delta),
//                 split into A fragments; dQ += dS K (K MN-major).
//      dq * scale is stored once.
//   B. "dk + dv": one block per (b*h, 64 keys), the keys as the M rows.  K
//      and V are split once; Q (scaled) and dO tiles of 32 queries stream
//      through the ring over the query tiles that see these keys (causal:
//      from the diagonal on), with each tile's m, 1/l and delta staged
//      beside them.  S^T = K Qs^T, dP^T = V dO^T; P^T and dS^T split into A
//      fragments; dV += P^T dO and dK += dS^T Qs (dO and Qs MN-major).
// Each tile's dQ, dK and dV sums go into fresh accumulators that are then
// added to the running sums in fp32 registers (see split_rs_chunk).  Each
// output element is written by one thread after sums in a fixed order, so
// two calls on the same inputs give the same bits.  One consumer warpgroup
// per block (cap 255 registers a thread): launch A holds S, dP, dQ, a
// tile's dQ and dS's 3 x 4 fragments of each 16 keys; launch B S^T, dP^T,
// dK, dV, a tile's sums and the fragments of P^T and dS^T, at D = 128 one
// 64-column chunk of dV or dK at a time.  Registers (ptxas -v, CUDA 12.8):
// A 168 / 184 at D = 64 / 128, B 204 / 255; no spills at D = 64, 124 bytes
// in B at D = 128.
// Shared memory: A 3 x 2 x 64 x D x 2 bytes for Q and dO, 2 stages x 6 x 64
// x D x 2 for K and V (32 keys at D = 128): 144 / 192 KB at D = 64 / 128; B
// 6 x 64 x D x 2 for K and V, 2 stages x 6 x 32 x D x 2 for Q and dO: 96 /
// 192 KB.
//
// At D 16 and 32 (causal, B=8, H=12, S=1024, D=32) the nine products take
// 174 GFLOP of bf16 products, 0.176 ms at peak, and the exponentials, three
// per kept pair (two sweeps of A and B's one), 0.039 ms at the SFUs' 3.9
// T/s; the function's floor is the six split products of its five, 0.098
// ms.  The tiles keep D = 64's shapes (64-key tiles in A, 32-query tiles in
// B, one consumer warpgroup), so no sweep is added; the registers a narrow
// D frees buy a second block on each SM in both launches (launch bounds:
// 128 registers a thread), whose warps hide the first's latency.
// Measured (PERF.md): 0.489 ms at D = 32, 0.612 with one block a SM;
// SDPA's backward 1.05.
//
// What bounds it on the H100 (3.35 TB/s; 989 TFLOP/s bf16 dense, 67 TFLOP/s
// fp32 outside the tensor cores).  Causal, B=8, H=12, S=1024, D=64: the
// gradient's five products take 10*D FLOPs per kept (query, key) pair,
// 32.2 GFLOP: 0.481 ms at the fp32 peak, 0.196 ms as six bf16 products each
// at 989 TFLOP/s; q, k, v, do, dq, dk, dv are 176 MB, 0.053 ms.  This design
// does nine products (two in sweep 1, three in sweep 2, four in B), six
// bf16 products each: 348 GFLOP, 0.352 ms at peak.  Measured 0.954 ms
// (PERF.md; launch A 0.51, B 0.45), 37% of the bf16 peak on those 348
// GFLOP.  What it leaves on the table: one consumer warpgroup per block,
// so the softmax and the splits stall the tensor cores; the producer's
// splitting is ordinary loads and stores; K and V split twice in launch A;
// no setmaxnreg, no persistent grid.
#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kStages = 2;
constexpr int kThreads = 256;     // one consumer warpgroup, one producer warpgroup
constexpr int kRows = 64;         // launch A's query rows, launch B's keys, per block
constexpr int kBQ = 32;           // launch B's queries per Q/dO tile
// Launch A's keys per K/V tile.
template <int D>
__host__ __device__ constexpr int tile_k() { return D <= 64 ? 64 : 32; }

template <int D>
__host__ __device__ constexpr size_t dq_smem() {
  return 1024 + 6 * size_t(kRows) * D * 2 + kStages * 6 * size_t(tile_k<D>()) * D * 2 +
         8 * (2 * kStages + 1);
}
template <int D>
__host__ __device__ constexpr size_t dkdv_smem() {
  return 1024 + 6 * size_t(kRows) * D * 2 + kStages * 6 * size_t(kBQ) * D * 2 +
         kStages * 3 * kBQ * 4 + 8 * (2 * kStages + 1);
}

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  // [3, B*H, S], written by A, read by B: per query row the max of its
  // scaled scores, 1 / sum_j e^(s_j - max), and delta
  float* stats;
  long long st[4][3];  // element strides of q, k, v, do: batch, head, sequence
  int heads, seq_len, causal;
  float scale;
};

__device__ __forceinline__ const float* head(const float* base, const long long (&st)[3],
                                             int bi, int hi) {
  return base + bi * st[0] + hi * st[1];
}

// a = A1 B1^T and b = A2 B2^T over D, each 64 x N (N = 2 * NREG), all four
// operands K-major three-part tiles in shared memory (parts a_part and
// b_part bytes apart); six split products each, both in one commit group.
template <int D, int NREG>
__device__ __forceinline__ void two_split_products(float (&a)[NREG], float (&b)[NREG],
                                                   uint32_t a1, uint32_t b1, uint32_t a2,
                                                   uint32_t b2, uint32_t a_chunk,
                                                   uint32_t b_chunk, uint32_t a_part,
                                                   uint32_t b_part) {
  fence_regs(a);
  fence_regs(b);
  wgmma_fence();
#pragma unroll
  for (int o = 0; o < kSplitProducts; ++o)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(a, desc_k_major(a1 + split_a(o) * a_part, kk, a_chunk, row_bytes(D)),
               desc_k_major(b1 + split_b(o) * b_part, kk, b_chunk, row_bytes(D)), o + kk > 0,
               Bf16());
#pragma unroll
  for (int o = 0; o < kSplitProducts; ++o)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(b, desc_k_major(a2 + split_a(o) * a_part, kk, a_chunk, row_bytes(D)),
               desc_k_major(b2 + split_b(o) * b_part, kk, b_chunk, row_bytes(D)), o + kk > 0,
               Bf16());
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(a);
  fence_regs(b);
}

// acc = A B over NK keys for the 64 columns of chunk c, in a fresh (zeroed)
// accumulator: A the three-part fragments a[3][NK/16][4] from registers, B
// a three-part MN-major tile of head dim D (parts `part` bytes apart,
// chunks of `chunk` bytes); six split products, issued but not committed.  A tile's sum is
// taken apart from the running one and added to it in fp32 (add_sum): the
// tensor cores' accumulation into a large running sum, hundreds of times
// over a long sequence, drifted 1.5e-5 row-relative on the H100.
template <int NK, int D, int NREG>
__device__ __forceinline__ void split_rs_chunk(float (&acc)[NREG],
                                               const uint32_t (&a)[3][NK / 16][4],
                                               uint32_t b, int c, uint32_t chunk,
                                               uint32_t part) {
#pragma unroll
  for (int i = 0; i < NREG; ++i) acc[i] = 0.f;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int o = 0; o < kSplitProducts; ++o)
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
      wgmma_rs(acc, a[split_a(o)][kk],
               desc_mn_major(b + split_b(o) * part, kk, c, chunk, row_bytes(D)), Bf16());
}

// sum += tile, after the tile's products are waited for.
template <int NREG>
__device__ __forceinline__ void add_sum(float (&sum)[NREG], float (&tile)[NREG]) {
  fence_regs(tile);
#pragma unroll
  for (int i = 0; i < NREG; ++i) sum[i] += tile[i];
}

// Stores a 64-row fp32 accumulator (D / N chunks of N / 2 registers a
// thread, the m64nN layout, N = chunk_cols(D)) times `mul` into rows row0
// and row0 + 8 of a contiguous [B*H, S, D] tensor; rows past S are not
// stored.
template <int D>
__device__ __forceinline__ void store_rows(
    float* out, const float (&acc)[D / chunk_cols(D)][chunk_cols(D) / 2], int bh, int row0,
    int t, int seq_len, float mul) {
  constexpr int kCols = chunk_cols(D);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= seq_len) continue;
    float* orow = out + (static_cast<size_t>(bh) * seq_len + row) * D;
#pragma unroll
    for (int c = 0; c < D / kCols; ++c)
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<float2*>(orow + c * kCols + 8 * j + 2 * t) =
            make_float2(acc[c][i] * mul, acc[c][i + 1] * mul);
      }
  }
}

// -- A: statistics and dq ---------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 32 ? 2 : 1)
flash_attn_bwd_f32_dq_kernel(const Params p) {
  constexpr int kTile = tile_k<D>();
  constexpr int kCols = chunk_cols(D);
  constexpr int kChunks = D / kCols;
  constexpr uint32_t kQChunk = kRows * row_bytes(D);
  constexpr uint32_t kQPart = kChunks * kQChunk;   // one part of Q or dO
  constexpr uint32_t kKChunk = kTile * row_bytes(D);
  constexpr uint32_t kKPart = kChunks * kKChunk;   // one part of a K or V tile
  constexpr uint32_t kStage = 6 * kKPart;          // K's three parts, then V's

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sdo = sq + 3 * kQPart;
  const uint32_t sk = sdo + 3 * kQPart;            // kStages stages
  const uint32_t bar_full = sk + kStages * kStage;
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
      mbar_init(bar_full + 8 * st, 128);
      mbar_init(bar_empty + 8 * st, 4);
    }
    mbar_init(bar_q, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4) {  // the producer: load, split, store
    const int pt = threadIdx.x - 128;
    load_split<kRows, D, 128>(head(p.q, p.st[0], bi, hi), p.st[0][2], q0, seq_len, p.scale,
                              sq, pt);
    load_split<kRows, D, 128>(head(p.dout, p.st[3], bi, hi), p.st[3][2], q0, seq_len, 1.f,
                              sdo, pt);
    mbar_arrive(bar_q);
    const float* kh = head(p.k, p.st[1], bi, hi);
    const float* vh = head(p.v, p.st[2], bi, hi);
    // the K/V tiles twice: sweep 1, then sweep 2
    for (int it = 0; it < 2 * n_k; ++it) {
      const int kt = it < n_k ? it : it - n_k;
      const int st = it % kStages;
      if (it >= kStages) mbar_wait(bar_empty + 8 * st, ((it / kStages) - 1) & 1);
      const uint32_t stage = sk + st * kStage;
      load_split<kTile, D, 128>(kh, p.st[1][2], kt * kTile, seq_len, 1.f, stage, pt);
      load_split<kTile, D, 128>(vh, p.st[2][2], kt * kTile, seq_len, 1.f, stage + 3 * kKPart,
                                pt);
      mbar_arrive(bar_full + 8 * st);
    }
    return;
  }

  // The consumer warpgroup.  Accumulator layout of m64nN: thread (warp w,
  // lane) holds rows 16w + lane/4 and that + 8, columns 8j + 2(lane%4) +
  // {0, 1}; register i is row half (i/2)%2, column group i/4.
  const int t = lane % 4;
  const int row0 = q0 + 16 * warp + lane / 4;
  float s_acc[kTile / 2], dp_acc[kTile / 2];
  // per row half: the running max m of s, l = sum e^(s - m) and
  // t = sum e^(s - m) dp, each over this thread's columns
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, tsum[2] = {0.f, 0.f};

  // s of accumulator register i of the key tile at k0, -1e30 where masked
  auto score = [&](int i, int k0, bool masked) {
    float x = s_acc[i];
    if (masked) {
      const int kp = k0 + 8 * (i / 4) + 2 * t + (i % 2);
      const int qp = row0 + 8 * ((i / 2) % 2);
      if (kp >= seq_len || (p.causal && kp > qp)) x = kNeg;
    }
    return x;
  };

  mbar_wait(bar_q, 0);
  // sweep 1: the row statistics and delta, online
  for (int it = 0; it < n_k; ++it) {
    const int st = it % kStages;
    const uint32_t k_st = sk + st * kStage;
    mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
    two_split_products<D>(s_acc, dp_acc, sq, k_st, sdo, k_st + 3 * kKPart, kQChunk, kKChunk,
                          kQPart, kKPart);
    // the products are done with the stage; the rest is in registers
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);
    const int k0 = it * kTile;
    const bool masked = k0 + kTile > seq_len || (p.causal && k0 + kTile - 1 > q0);
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
      const float corr = expf(m[r] - m_new);
      l[r] *= corr;
      tsum[r] *= corr;
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) {
      const int r = (i / 2) % 2;
      // a masked score is -1e30: its e^(s - m) is 0 once any key is live
      const float e = expf(s_acc[i] - m[r]);
      l[r] += e;
      tsum[r] = fmaf(e, dp_acc[i], tsum[r]);
    }
  }
  // a live row has l >= 1: its largest score contributes e^0 = 1 exactly
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
  float dq_acc[kChunks][kCols / 2];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) dq_acc[c][i] = 0.f;
  for (int it = n_k; it < 2 * n_k; ++it) {
    const int kt = it - n_k;
    const int st = it % kStages;
    const uint32_t k_st = sk + st * kStage;
    mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
    two_split_products<D>(s_acc, dp_acc, sq, k_st, sdo, k_st + 3 * kKPart, kQChunk, kKChunk,
                          kQPart, kKPart);
    const int k0 = kt * kTile;
    const bool masked = k0 + kTile > seq_len || (p.causal && k0 + kTile - 1 > q0);
    uint32_t dsa[3][kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * kk + 2 * j;  // registers i, i+1: row half j % 2
        const int r = j % 2;
        const float p0 = expf(score(i, k0, masked) - m[r]) * inv_l[r];
        const float p1 = expf(score(i + 1, k0, masked) - m[r]) * inv_l[r];
        split3(p0 * (dp_acc[i] - delta[r]), p1 * (dp_acc[i + 1] - delta[r]), dsa[0][kk][j],
               dsa[1][kk][j], dsa[2][kk][j]);
      }
    float dq_tile[kChunks][kCols / 2];
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      split_rs_chunk<kTile, D>(dq_tile[c], dsa, k_st, c, kKChunk, kKPart);
    wgmma_commit();
    wgmma_wait_all();
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) add_sum(dq_acc[c], dq_tile[c]);
  }
  store_rows<D>(p.dq, dq_acc, bh, row0, t, seq_len, p.scale);
}

// -- B: dk and dv ----------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 32 ? 2 : 1)
flash_attn_bwd_f32_dkdv_kernel(const Params p) {
  constexpr int kCols = chunk_cols(D);
  constexpr int kChunks = D / kCols;
  constexpr uint32_t kKChunk = kRows * row_bytes(D);
  constexpr uint32_t kKPart = kChunks * kKChunk;   // one part of K or V
  constexpr uint32_t kQChunk = kBQ * row_bytes(D);
  constexpr uint32_t kQPart = kChunks * kQChunk;   // one part of a Q or dO tile
  constexpr uint32_t kStage = 6 * kQPart;          // Q's three parts, then dO's

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sk = base;
  const uint32_t sv = sk + 3 * kKPart;
  const uint32_t sq = sv + 3 * kKPart;             // kStages stages
  const uint32_t sstat = sq + kStages * kStage;
  // per stage: m, 1/l and delta of the tile's kBQ queries
  float* stat = reinterpret_cast<float*>(smem_raw + (sstat - raw));
  const uint32_t bar_full = sstat + kStages * 3 * kBQ * 4;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_kv = bar_empty + 8 * kStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int bi = bh / p.heads, hi = bh % p.heads;
  const int seq_len = p.seq_len;
  const int k0 = blockIdx.y * kRows;  // the first key tiles see the most queries
  const int n_q = (seq_len + kBQ - 1) / kBQ;
  const int qt0 = p.causal ? k0 / kBQ : 0;
  const int n_it = n_q - qt0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 128);
      mbar_init(bar_empty + 8 * st, 4);
    }
    mbar_init(bar_kv, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4) {  // the producer: K and V once, then Q, dO and statistics
    const int pt = threadIdx.x - 128;
    load_split<kRows, D, 128>(head(p.k, p.st[1], bi, hi), p.st[1][2], k0, seq_len, 1.f, sk,
                              pt);
    load_split<kRows, D, 128>(head(p.v, p.st[2], bi, hi), p.st[2][2], k0, seq_len, 1.f, sv,
                              pt);
    mbar_arrive(bar_kv);
    const float* qh = head(p.q, p.st[0], bi, hi);
    const float* doh = head(p.dout, p.st[3], bi, hi);
    const size_t n_rows = static_cast<size_t>(gridDim.x) * seq_len;
    for (int it = 0; it < n_it; ++it) {
      const int q0 = (qt0 + it) * kBQ;
      const int st = it % kStages;
      if (it >= kStages) mbar_wait(bar_empty + 8 * st, ((it / kStages) - 1) & 1);
      const uint32_t stage = sq + st * kStage;
      load_split<kBQ, D, 128>(qh, p.st[0][2], q0, seq_len, p.scale, stage, pt);
      load_split<kBQ, D, 128>(doh, p.st[3][2], q0, seq_len, 1.f, stage + 3 * kQPart, pt);
      if (pt < 3 * kBQ) {
        const int a = pt / kBQ, j = pt % kBQ, q = q0 + j;
        stat[st * 3 * kBQ + pt] =
            q < seq_len ? p.stats[a * n_rows + static_cast<size_t>(bh) * seq_len + q] : 0.f;
      }
      mbar_arrive(bar_full + 8 * st);
    }
    return;
  }

  // The consumer warpgroup: the block's 64 keys as rows; columns are the
  // tile's queries.
  const int t = lane % 4;
  const int krow0 = k0 + 16 * warp + lane / 4;
  float dk_acc[kChunks][kCols / 2], dv_acc[kChunks][kCols / 2];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) dk_acc[c][i] = dv_acc[c][i] = 0.f;
  float s_acc[kBQ / 2], dp_acc[kBQ / 2];

  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_it; ++it) {
    const int q0 = (qt0 + it) * kBQ;
    const int st = it % kStages;
    const uint32_t q_st = sq + st * kStage, do_st = q_st + 3 * kQPart;
    mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
    two_split_products<D>(s_acc, dp_acc, sk, q_st, sv, do_st, kKChunk, kQChunk, kKPart, kQPart);
    const bool masked = q0 + kBQ > seq_len || k0 + kRows > seq_len ||
                        (p.causal && q0 < k0 + kRows - 1);
    const float* mst = stat + st * 3 * kBQ;
    const float* inv = mst + kBQ;
    const float* dlt = inv + kBQ;
    uint32_t pf[3][kBQ / 16][4], df[3][kBQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * kk + 2 * j;  // registers i, i+1: key row half j % 2
        const int col = 8 * (i / 4) + 2 * t;
        const float2 mq = *reinterpret_cast<const float2*>(mst + col);
        const float2 il = *reinterpret_cast<const float2*>(inv + col);
        const float2 dl = *reinterpret_cast<const float2*>(dlt + col);
        float p0 = expf(s_acc[i] - mq.x) * il.x;
        float p1 = expf(s_acc[i + 1] - mq.y) * il.y;
        if (masked) {
          const int kp = krow0 + 8 * (j % 2), qp = q0 + col;
          const bool key_out = kp >= seq_len;
          if (key_out || qp >= seq_len || (p.causal && kp > qp)) p0 = 0.f;
          if (key_out || qp + 1 >= seq_len || (p.causal && kp > qp + 1)) p1 = 0.f;
        }
        split3(p0, p1, pf[0][kk][j], pf[1][kk][j], pf[2][kk][j]);
        split3(p0 * (dp_acc[i] - dl.x), p1 * (dp_acc[i + 1] - dl.y), df[0][kk][j],
               df[1][kk][j], df[2][kk][j]);
      }
    // the tile's P^T dO and dS^T Qs: at D <= 64 both in one commit group; at
    // D = 128 one 64-column chunk of one at a time, for registers
    if constexpr (kChunks == 1) {
      float dv_tile[kCols / 2], dk_tile[kCols / 2];
      split_rs_chunk<kBQ, D>(dv_tile, pf, do_st, 0, kQChunk, kQPart);
      split_rs_chunk<kBQ, D>(dk_tile, df, q_st, 0, kQChunk, kQPart);
      wgmma_commit();
      wgmma_wait_all();
      add_sum(dv_acc[0], dv_tile);
      add_sum(dk_acc[0], dk_tile);
    } else {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        float tile[kCols / 2];
        split_rs_chunk<kBQ, D>(tile, pf, do_st, c, kQChunk, kQPart);
        wgmma_commit();
        wgmma_wait_all();
        add_sum(dv_acc[c], tile);
        split_rs_chunk<kBQ, D>(tile, df, q_st, c, kQChunk, kQPart);
        wgmma_commit();
        wgmma_wait_all();
        add_sum(dk_acc[c], tile);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);
  }
  // q was split scaled: dk needs no further scale
  store_rows<D>(p.dk, dk_acc, bh, krow0, t, seq_len, 1.f);
  store_rows<D>(p.dv, dv_acc, bh, krow0, t, seq_len, 1.f);
}

template <int D>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  const int s = p.seq_len;
  auto ka = flash_attn_bwd_f32_dq_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(ka, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dq_smem<D>()));
  if (err != cudaSuccess) return err;
  ka<<<dim3(bh, (s + kRows - 1) / kRows), kThreads, dq_smem<D>(), stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kb = flash_attn_bwd_f32_dkdv_kernel<D>;
  err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkdv_smem<D>()));
  if (err != cudaSuccess) return err;
  kb<<<dim3(bh, (s + kRows - 1) / kRows), kThreads, dkdv_smem<D>(), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout [batch, heads, seq_len, d], fp32, d in {16, 32, 64, 128}, read
// through their strides: 12 element strides, (batch, head, sequence) of q,
// k, v, then dout, each times 4 bytes a multiple of 16, the last stride 1
// and every pointer 16-byte aligned.  dq, dk, dv: new contiguous fp32
// [batch, heads, seq_len, d].  stats: fp32 scratch of 3 * batch * heads *
// seq_len.  dtype must be 0 (fp32).  The arguments are flash_attn_bwd's.
// Returns a cudaError_t; 0 is success.
extern "C" int flash_attn_bwd_f32_sm90(const void* q, const void* k, const void* v,
                                       const void* dout, void* dq, void* dk, void* dv,
                                       void* stats, int batch, int heads, int seq_len, int d,
                                       const long long* strides, int dtype, int causal,
                                       float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || seq_len <= 0 || dtype != 0 ||
      (seq_len + kRows - 1) / kRows > 65535 || (d != 16 && d != 32 && d != 64 && d != 128))
    return cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.dout = static_cast<const float*>(dout);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.stats = static_cast<float*>(stats);
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  p.heads = heads;
  p.seq_len = seq_len;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(p, batch * heads, s);
    case 32: return launch<32>(p, batch * heads, s);
    case 64: return launch<64>(p, batch * heads, s);
    default: return launch<128>(p, batch * heads, s);
  }
}
