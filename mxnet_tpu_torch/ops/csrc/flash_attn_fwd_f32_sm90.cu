// Flash-attention forward for Hopper tensor cores (sm_90a), fp32, through a
// three-way bf16 split of every operand.
//
// Replaces the Pallas TPU kernel mxnet_tpu/ops/pallas_kernels.py
// (_attn_kernel:41, launched by _flash_fwd_impl:95, public flash_attention:178)
// for fp32 inputs at head dims 16, 32, 64 and 128, in place of the SIMT
// kernel flash_attn_fwd.cu (fp32 FMAs on the CUDA cores), which it replaced
// at D 64 and 128 first and then at D 16 and 32.  It computes the same
// function:
//   o = softmax(mask(q @ k^T * sm_scale)) @ v   per (batch, head),
// masked scores set to -1e30, causal masking by absolute position, key tiles
// wholly in the future of a query tile never visited, and a final division
// by max(l, 1e-30); the running max m, the sum l and the output sum are fp32.
//
// fp32 on the tensor cores.  wgmma takes fp32 only as TF32 (10 bits), far
// from the 1e-4 fp32 check.  So each operand is split into three bf16 parts,
// x = x0 + x1 + x2 (sm90_common.cuh: split3, exact over the normal range),
// and each product of the function is the six products a_i b_j with
// i + j <= 2, issued smallest first into one fp32 accumulator; the terms
// left out are below 2^-23 of the product.  A CPU model of this arithmetic
// (tools/torch_flash_bwd_cpu_model.py) lies 0.5-1.9e-6 row-relative from
// an fp64 reference, where plain fp32 lies 1.0-3.5e-6.  bf16 parts, not
// TF32 parts: wgmma sets the transpose bit only for 16-bit types, and V in
// P V is read MN-major; at peak six bf16 products (989 TFLOP/s) cost what
// three TF32 products (495) do.  Each key tile's P V goes into a fresh
// accumulator that is then added to O in fp32 registers: accumulated by
// the tensor cores straight into the running O, hundreds of times over
// 1024 keys, the output drifted to 1.54e-5 of its row (the check's limit
// is 2^-16 = 1.53e-5); the fresh sums measured 2.7e-6 on the same inputs.
//
// Design.  One block per (b*h, tile of 64 * W query rows): W consumer
// warpgroups of 64 rows (W = 2 at D <= 64; 1 at D = 128, where O and a
// tile's sum take 128 registers a thread, more than the 168 a thread of
// 384 may hold) and one producer warpgroup.  The TPU's sequential k grid
// axis is a loop over K/V tiles of 64 keys (32 at D = 128).  Tiles are kept
// in the swizzle of their row width (sm90_common.cuh): 128B in 64-column
// chunks at D >= 64, 64B at D = 32, 32B at D = 16.
//   - Operands: TMA cannot split, so the producer warpgroup loads fp32 rows
//     through each tensor's own strides (16-byte loads, coalesced along D;
//     zeros past S), splits them and stores the three bf16 tiles in the
//     swizzle that TMA would write, so the descriptors of the 16-bit
//     kernels read them unchanged.  First the query tile (once), then each
//     K and V tile into a ring of two stages; each stage has a "full"
//     mbarrier (one arrival per producer thread, after a proxy fence) and
//     an "empty" one (one arrival per consumer warp), so the next tile is
//     loaded and split while this one's products run.
//   - Products: S = Q K^T as m64n64k16 (m64n32k16 at D = 128), Q and K from
//     shared memory, K-major, six products per 16 columns of D; P V as
//     m64nNk16 per N = min(D, 64) columns of D, P from registers (the fp32
//     probabilities of each 16 keys split into three A fragments) and V
//     from shared memory, MN-major.
//   - Softmax in registers, in log2 units (x = s scale log2e, ex2.approx),
//     as in flash_attn_fwd_sm90.cu; l sums the fp32 probabilities.
//   - Each warpgroup visits only the key tiles its own 64 rows see; only
//     the diagonal (causal) and ragged tiles are masked; heavier (later)
//     query tiles are scheduled first.
// Shared memory: Q 3 x 64W x D x 2 bytes, K and V 2 stages x 2 x 3 x 64 x D
// x 2 bytes (32 keys at D = 128): 144 KB at both D.  Registers (ptxas -v,
// CUDA 12.8): 168 at D = 64 (the cap of 384 threads), 209 at D = 128; no
// spills.
//
// What bounds it on the H100 (3.35 TB/s; 989 TFLOP/s bf16 dense, 67 TFLOP/s
// fp32 outside the tensor cores).  Causal, B=8, H=12, S=1024, D=64:
// q/k/v/o 100.7 MB -> 0.030 ms; the function's 4*D*S(S+1)/2*B*H = 12.9
// GFLOP at the fp32 peak -> 0.193 ms; the split design's six bf16 products
// per product, 77.4 GFLOP at 989 TFLOP/s -> 0.078 ms.  Measured 0.186 ms
// (PERF.md), 42% of the bf16 peak.  What it leaves on the table: the
// producer's splitting is ordinary loads and stores (about 8 instructions
// per value), no ping-pong between the consumer warpgroups, no
// setmaxnreg, one block per SM, no persistent grid.
//
// At D 16 and 32 the six split products per product are cheap (causal,
// B=8, H=12, S=1024, D=32: 38.7 GFLOP, 0.039 ms at 989 TFLOP/s) and the
// exponentials come level: one ex2 per kept pair, 50.4 M at the SFUs' 3.9
// T/s, 0.0129 ms, beside the producer's splitting of every loaded value.
// The tiles keep D = 64's shapes (two consumer warpgroups, so one's softmax
// overlaps the other's products, 64-key tiles); each pair's p is computed
// once.  Measured (PERF.md): 0.125 ms at D = 32, 31% of the split
// products' floor; SDPA 0.426.
#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kStages = 2;
// Consumer warpgroups of 64 query rows: two at D <= 64; one at D = 128, where
// the output sum and its per-tile sum take 128 registers a thread, more than
// the 168 a thread of 384 may hold.
template <int D>
__host__ __device__ constexpr int warpgroups() { return D <= 64 ? 2 : 1; }
template <int D>
__host__ __device__ constexpr int block_q() { return 64 * warpgroups<D>(); }
template <int D>
__host__ __device__ constexpr int threads() { return 128 * warpgroups<D>() + 128; }
// Keys per K/V tile: 64 at D <= 64, 32 at D = 128 (the three parts of K and
// V over two stages have to fit beside Q's).
template <int D>
__host__ __device__ constexpr int block_k() { return D <= 64 ? 64 : 32; }
template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + 3 * size_t(block_q<D>()) * D * 2 +
         kStages * 6 * size_t(block_k<D>()) * D * 2 + 8 * (2 * kStages + 1);
}

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long qs[3], ks[3], vs[3];  // element strides: batch, head, sequence
  int heads, seq_len, causal;
  float scale_log2;
};

template <int D>
__global__ void __launch_bounds__(threads<D>(), 1)
flash_attn_fwd_f32_sm90_kernel(const Params p) {
  constexpr int kBlockQ = block_q<D>();
  constexpr int kConsumerThreads = 128 * warpgroups<D>();
  constexpr int kBlockK = block_k<D>();
  constexpr int kCols = chunk_cols(D);        // columns per swizzled row
  constexpr uint32_t kRB = row_bytes(D);
  constexpr int kChunks = D / kCols;
  constexpr uint32_t kQChunk = kBlockQ * kRB;
  constexpr uint32_t kQPart = kChunks * kQChunk;
  constexpr uint32_t kKChunk = kBlockK * kRB;
  constexpr uint32_t kKPart = kChunks * kKChunk;  // one part of a K or V tile
  constexpr uint32_t kStage = 6 * kKPart;         // K's three parts, then V's

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = sq + 3 * kQPart;            // kStages stages
  const uint32_t bar_full = sk + kStages * kStage;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_q = bar_empty + 8 * kStages;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int bi = bh / p.heads, hi = bh % p.heads;
  const int seq_len = p.seq_len;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // heaviest first
  int n_k = (seq_len + kBlockK - 1) / kBlockK;
  if (p.causal) n_k = min(n_k, (q0 + kBlockQ - 1) / kBlockK + 1);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 128);
      mbar_init(bar_empty + 8 * st, kConsumerThreads / 32);
    }
    mbar_init(bar_q, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {  // the producer: load, split, store
    const int pt = threadIdx.x - kConsumerThreads;
    const float* qh = p.q + bi * p.qs[0] + hi * p.qs[1];
    const float* kh = p.k + bi * p.ks[0] + hi * p.ks[1];
    const float* vh = p.v + bi * p.vs[0] + hi * p.vs[1];
    load_split<kBlockQ, D, 128>(qh, p.qs[2], q0, seq_len, 1.f, sq, pt);
    mbar_arrive(bar_q);
    for (int kt = 0; kt < n_k; ++kt) {
      const int st = kt % kStages;
      if (kt >= kStages) mbar_wait(bar_empty + 8 * st, ((kt / kStages) - 1) & 1);
      const uint32_t stage = sk + st * kStage;
      load_split<kBlockK, D, 128>(kh, p.ks[2], kt * kBlockK, seq_len, 1.f, stage, pt);
      load_split<kBlockK, D, 128>(vh, p.vs[2], kt * kBlockK, seq_len, 1.f,
                                  stage + 3 * kKPart, pt);
      mbar_arrive(bar_full + 8 * st);
    }
    return;
  }

  // Consumers.  Accumulator layout of m64nN: thread (warp w of the
  // warpgroup, lane) holds rows 16w + lane/4 and that + 8, columns
  // 8j + 2(lane%4) + {0, 1}; register i is row half (i/2)%2, column group i/4.
  const int wg = warp / 4;
  const int t = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const uint32_t q_wg = sq + wg * 64 * kRB;

  float s_acc[kBlockK / 2];
  float o_acc[kChunks][kCols / 2];
#pragma unroll
  for (int i = 0; i < kBlockK / 2; ++i) s_acc[i] = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) o_acc[c][i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  // the tiles this warpgroup's own 64 rows see
  const int n_k_wg = p.causal ? min(n_k, (q0 + 64 * wg + 63) / kBlockK + 1) : n_k;

  mbar_wait(bar_q, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt % kStages;
    const int k0 = kt * kBlockK;
    const uint32_t k_st = sk + st * kStage, v_st = k_st + 3 * kKPart;
    mbar_wait(bar_full + 8 * st, (kt / kStages) & 1);
    if (kt >= n_k_wg) {
      // skipped, but released like a visited tile, so the producer's ring
      // stays in step
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
      continue;
    }

    // S = Q K^T: six split products, 16 columns of D per instruction
    fence_regs(s_acc);
    wgmma_fence();
#pragma unroll
    for (int o = 0; o < kSplitProducts; ++o)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(s_acc, desc_k_major(q_wg + split_a(o) * kQPart, kk, kQChunk, kRB),
                 desc_k_major(k_st + split_b(o) * kKPart, kk, kKChunk, kRB), o + kk > 0,
                 Bf16());
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s_acc);

    // scale to log2 units, mask (only the diagonal and the tail tile),
    // online softmax; P split into three A fragments per 16 keys
    const bool masked =
        k0 + kBlockK > seq_len || (p.causal && k0 + kBlockK - 1 > q0 + 64 * wg);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) {
      float x = __fmul_rn(s_acc[i], p.scale_log2);
      if (masked) {
        const int kp = k0 + 8 * (i / 4) + 2 * t + (i % 2);
        const int qp = row0 + 8 * ((i / 2) % 2);
        if (kp >= seq_len || (p.causal && kp > qp)) x = kNeg;
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
    uint32_t pa[3][kBlockK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * kk + 2 * j;  // registers i, i+1: row half j % 2
        const float p0 = fast_exp2(s_acc[i] - m[j % 2]);
        const float p1 = fast_exp2(s_acc[i + 1] - m[j % 2]);
        l[j % 2] += p0 + p1;
        split3(p0, p1, pa[0][kk][j], pa[1][kk][j], pa[2][kk][j]);
      }

    // P V of this tile: six split products, 16 keys per instruction, kCols
    // columns of D each, into a fresh sum that is then added to O in fp32
    float pv[kChunks][kCols / 2];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int i = 0; i < kCols / 2; ++i) pv[c][i] = 0.f;
      fence_regs(pv[c]);
    }
    wgmma_fence();
#pragma unroll
    for (int o = 0; o < kSplitProducts; ++o)
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk)
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          wgmma_rs(pv[c], pa[split_a(o)][kk],
                   desc_mn_major(v_st + split_b(o) * kKPart, kk, c, kKChunk, kRB), Bf16());
    wgmma_commit();
    wgmma_wait_all();
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);  // this warp is done with the stage
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      fence_regs(pv[c]);
#pragma unroll
      for (int i = 0; i < kCols / 2; ++i)
        o_acc[c][i] = fmaf(o_acc[c][i], corr[(i / 2) % 2], pv[c][i]);
    }
  }

  // o = acc / max(l, 1e-30); rows past S are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= seq_len) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* orow = p.o + (static_cast<size_t>(bh) * seq_len + row) * D;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<float2*>(orow + c * kCols + 8 * j + 2 * t) =
            make_float2(o_acc[c][i] / denom, o_acc[c][i + 1] / denom);
      }
  }
}

template <int D>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_attn_fwd_f32_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.seq_len + block_q<D>() - 1) / block_q<D>());
  kernel<<<grid, threads<D>(), smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q, k, v [batch, heads, seq_len, d], fp32, d in {16, 32, 64, 128}; strides: 9
// element strides, (batch, head, sequence) of q, then k, then v, each times
// 4 bytes a multiple of 16, the last stride 1 and every pointer 16-byte
// aligned.  o is a contiguous fp32 [batch, heads, seq_len, d].  dtype must
// be 0 (fp32).  The arguments are flash_attn_fwd's.  Returns a cudaError_t;
// 0 is success.
extern "C" int flash_attn_fwd_f32_sm90(const void* q, const void* k, const void* v,
                                       void* o, int batch, int heads, int seq_len, int d,
                                       const long long* strides, int dtype, int causal,
                                       float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || seq_len <= 0 || dtype != 0 ||
      (seq_len + 63) / 64 > 65535 || (d != 16 && d != 32 && d != 64 && d != 128))
    return cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
  }
  p.heads = heads;
  p.seq_len = seq_len;
  p.causal = causal;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(p, batch * heads, s);
    case 32: return launch<32>(p, batch * heads, s);
    case 64: return launch<64>(p, batch * heads, s);
    default: return launch<128>(p, batch * heads, s);
  }
}
