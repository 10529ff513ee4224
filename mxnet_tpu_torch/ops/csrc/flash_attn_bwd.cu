// Flash-attention backward for Hopper (sm_90a), CUDA C++, on the CUDA cores.
//
// Replaces the gradient of the Pallas TPU kernel in
// mxnet_tpu/ops/pallas_kernels.py: the custom_vjp backward _bwd:198, which
// calls the jnp recompute _chunked_attn_grads:132 (flash_attention:178).
// It computes the same function, not a block-by-block copy.  Per (batch,
// head), from q, k, v and the output gradient do, all [B, H, S, D]:
//   s  = q k^T * scale, masked to -1e30 (keys past S; causal: key > query)
//   p  = softmax(s) over the keys
//   dv = p^T do          dp = do v^T          delta_i = sum_j p_ij dp_ij
//   ds = p (dp - delta), zero where masked
//   dq = ds k * scale    dk = ds^T q * scale
// Everything is fp32 from the loaded values (widening bf16/fp16 is exact);
// dq, dk and dv are written once, rounded to the input type, as new
// contiguous [B, H, S, D] tensors.  q, k, v and do are read through their
// own strides (the last is 1).
//
// Which inputs come here: every dtype at D in {16, 32}.  At D in {64, 128}
// the tensor cores take them: bf16/fp16 in flash_attn_bwd_sm90.cu, fp32 in
// flash_attn_bwd_f32_sm90.cu (three bf16 parts per value); both take the
// same arguments as this kernel.
//
// Design: three passes, deterministic, no atomics, no [S, S] tensor in
// device memory.  Blocks of 256 threads form a 16 x 16 grid over a 64 x 64
// tile of (row, column) pairs; thread (ty, tx) owns rows ty + 16 i and
// columns tx + 16 j (i, j < 4), so a row belongs to one half-warp and its
// reductions are shuffles, as in flash_attn_fwd.cu.  Tiles are staged in
// shared memory as fp32, rows padded to D + 1 floats so that column reads
// across tx hit distinct banks.
//   1. stats, one block per (b*h, 64 query rows): sweep the key tiles once
//      with q k^T and do v^T side by side, keeping the online max m, the
//      rescaled sum l of e^(s-m) and the rescaled sum t of e^(s-m) dp.  It
//      writes m, 1/l and delta = t / l per row to fp32 scratch [3, B*H, S].
//   2. dq, one block per (b*h, 64 query rows): sweep the key tiles again,
//      recompute s, dp, p = e^(s-m) / l and ds, stage ds in shared memory
//      and accumulate ds k in registers.
//   3. dk and dv, one block per (b*h, 64 keys): sweep the query tiles that
//      see these keys (causal: from the diagonal on), recompute s^T and
//      dp^T with the keys as rows, stage p^T and ds^T in shared memory and
//      accumulate p^T do and ds^T q in registers.
// Pass 3 takes each key tile's sums over every query in one block, and
// pass 2 each query tile's over every key, so no block adds into another's
// output.  Causal tiles wholly masked are skipped; the heaviest tiles are
// scheduled first.
//
// What bounds it on the H100 (3.35 TB/s; 67 TFLOP/s fp32 outside the
// tensor cores).  Causal, B=8, H=12, S=1024, D=32: the five products of
// the gradient need 10*D*S(S+1)/2*B*H = 16.1 GFLOP, 0.240 ms at 67 TFLOP/s,
// against 7 * 8*12*1024*32 * 4 B = 88 MB of q, k, v, do, dq, dk, dv
// traffic, 0.026 ms: bound by operations.  This design does nine products,
// not five (two in pass 1, three in pass 2, four in pass 3), all on the
// CUDA cores in fp32, about one shared-memory load per two FMAs, with the
// tile loads not overlapped with the products: it is the simple, correct
// first version.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlock = 64;                 // rows and columns of a tile
constexpr int kThreads = 256;              // 16 x 16
constexpr int kPer = kBlock / 16;          // rows (and columns) per thread
constexpr int kPStride = kBlock + 16;      // the two half-warps' rows hit other banks
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// Element strides of one input: batch, head, sequence (the last is 1).
struct Strides {
  long long b, h, s;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* stats;   // [3][bh][seq_len]: m, 1/l, delta
  int bh, heads, seq_len;
  Strides qs, ks, vs, ds;
  float scale;
  int causal;
};

// Rows [r0, r0 + 64) of one (b, h) slice of a [B, H, S, D] input into
// shared memory as fp32 rows of kDS floats, times mul; rows past S are 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride,
                                          int r0, int seq_len, float mul) {
  constexpr int kDS = D + 1;
  constexpr int kRowStep = kThreads / D;
  static_assert(kThreads % D == 0, "a tile row must split evenly over threads");
  const int lc = threadIdx.x % D, lr = threadIdx.x / D;
#pragma unroll 4
  for (int r = lr; r < kBlock; r += kRowStep) {
    const int row = r0 + r;
    dst[r * kDS + lc] = row < seq_len ? to_f32(src[row * row_stride + lc]) * mul : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base, const Strides& st, int bhi,
                                          int heads) {
  const long long bi = bhi / heads, hi = bhi % heads;
  return static_cast<const T*>(base) + bi * st.b + hi * st.h;
}

// Two 64 x 64 products of one tile pair side by side, both over D:
// a[i][j] = sum_d A[row i][d] * B[col j][d] and c[i][j] = C[row i] . E[col j],
// rows ty + 16 i of A and C, columns tx + 16 j of B and E.
template <int D>
__device__ __forceinline__ void two_products(const float* A, const float* B, const float* C,
                                             const float* E, float (&a)[kPer][kPer],
                                             float (&c)[kPer][kPer], int ty, int tx) {
  constexpr int kDS = D + 1;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) a[i][j] = c[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float ar[kPer], br[kPer], cr[kPer], er[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      ar[i] = A[(ty + 16 * i) * kDS + d];
      cr[i] = C[(ty + 16 * i) * kDS + d];
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      br[j] = B[(tx + 16 * j) * kDS + d];
      er[j] = E[(tx + 16 * j) * kDS + d];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        a[i][j] = fmaf(ar[i], br[j], a[i][j]);
        c[i][j] = fmaf(cr[i], er[j], c[i][j]);
      }
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ bool live(int qp, int kp, int seq_len, int causal) {
  return qp < seq_len && kp < seq_len && (!causal || qp >= kp);
}

// Pass 1: per query row, m = max_j s_ij, 1/l with l = sum_j e^(s_ij - m),
// and delta = sum_j p_ij dp_ij.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 3)
flash_attn_bwd_stats(Args a) {
  constexpr int kDS = D + 1;
  extern __shared__ float smem[];
  float* qs = smem;                  // [kBlock][kDS], scaled
  float* dos = qs + kBlock * kDS;
  float* ks = dos + kBlock * kDS;
  float* vs = ks + kBlock * kDS;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bhi = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;
  const T* q = head_ptr<T>(a.q, a.qs, bhi, a.heads);
  const T* k = head_ptr<T>(a.k, a.ks, bhi, a.heads);
  const T* v = head_ptr<T>(a.v, a.vs, bhi, a.heads);
  const T* dout = head_ptr<T>(a.dout, a.ds, bhi, a.heads);
  load_tile<T, D>(qs, q, a.qs.s, q0, a.seq_len, a.scale);
  load_tile<T, D>(dos, dout, a.ds.s, q0, a.seq_len, 1.f);

  float m[kPer], l[kPer], t[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = kNeg;
    l[i] = t[i] = 0.f;
  }
  int n_k = (a.seq_len + kBlock - 1) / kBlock;
  if (a.causal) n_k = min(n_k, (q0 + kBlock - 1) / kBlock + 1);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the previous tile's reads are done
    load_tile<T, D>(ks, k, a.ks.s, k0, a.seq_len, 1.f);
    load_tile<T, D>(vs, v, a.vs.s, k0, a.seq_len, 1.f);
    __syncthreads();
    float s[kPer][kPer], dp[kPer][kPer];
    two_products<D>(qs, ks, dos, vs, s, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        s[i][j] = live(qp, k0 + tx + 16 * j, a.seq_len, a.causal) ? s[i][j] : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float sl = 0.f, st = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        // a masked score is -1e30: its e^(s - m) is 0 once any key is live
        const float e = expf(s[i][j] - m_new);
        sl += e;
        st = fmaf(e, dp[i][j], st);
      }
      l[i] = l[i] * corr + half_warp_sum(sl);
      t[i] = t[i] * corr + half_warp_sum(st);
      m[i] = m_new;
    }
  }
  if (tx == 0) {
    const size_t plane = static_cast<size_t>(a.bh) * a.seq_len;
    float* st = a.stats + static_cast<size_t>(bhi) * a.seq_len;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int row = q0 + ty + 16 * i;
      if (row >= a.seq_len) continue;
      // a live row has l >= 1: its largest score contributes e^0
      const float inv_l = 1.f / l[i];
      st[row] = m[i];
      st[plane + row] = inv_l;
      st[2 * plane + row] = t[i] * inv_l;
    }
  }
}

// Pass 2: dq = scale * sum_j ds_ij k_j for 64 query rows.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attn_bwd_dq(Args a) {
  constexpr int kDS = D + 1;
  constexpr int kColsO = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                  // [kBlock][kDS], scaled
  float* dos = qs + kBlock * kDS;
  float* ks = dos + kBlock * kDS;
  float* vs = ks + kBlock * kDS;
  float* dss = vs + kBlock * kDS;    // [kBlock][kPStride]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bhi = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;
  const T* q = head_ptr<T>(a.q, a.qs, bhi, a.heads);
  const T* k = head_ptr<T>(a.k, a.ks, bhi, a.heads);
  const T* v = head_ptr<T>(a.v, a.vs, bhi, a.heads);
  const T* dout = head_ptr<T>(a.dout, a.ds, bhi, a.heads);
  load_tile<T, D>(qs, q, a.qs.s, q0, a.seq_len, a.scale);
  load_tile<T, D>(dos, dout, a.ds.s, q0, a.seq_len, 1.f);

  const size_t plane = static_cast<size_t>(a.bh) * a.seq_len;
  const float* st = a.stats + static_cast<size_t>(bhi) * a.seq_len;
  float m[kPer], inv_l[kPer], delta[kPer];
  float acc[kPer][kColsO];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool ok = row < a.seq_len;
    m[i] = ok ? st[row] : 0.f;
    inv_l[i] = ok ? st[plane + row] : 0.f;
    delta[i] = ok ? st[2 * plane + row] : 0.f;
#pragma unroll
    for (int c = 0; c < kColsO; ++c) acc[i][c] = 0.f;
  }
  int n_k = (a.seq_len + kBlock - 1) / kBlock;
  if (a.causal) n_k = min(n_k, (q0 + kBlock - 1) / kBlock + 1);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the previous tile's reads of ks, vs and dss are done
    load_tile<T, D>(ks, k, a.ks.s, k0, a.seq_len, 1.f);
    load_tile<T, D>(vs, v, a.vs.s, k0, a.seq_len, 1.f);
    __syncthreads();
    float s[kPer][kPer], dp[kPer][kPer];
    two_products<D>(qs, ks, dos, vs, s, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p = expf(s[i][j] - m[i]) * inv_l[i];
        const bool ok = live(q0 + r, k0 + tx + 16 * j, a.seq_len, a.causal);
        dss[r * kPStride + tx + 16 * j] = ok ? p * (dp[i][j] - delta[i]) : 0.f;
      }
    }
    __syncwarp();  // a row of dss is written and read by the same half-warp
#pragma unroll 4
    for (int j = 0; j < kBlock; ++j) {
      float dv_[kPer], kv[kColsO];
#pragma unroll
      for (int i = 0; i < kPer; ++i) dv_[i] = dss[(ty + 16 * i) * kPStride + j];
#pragma unroll
      for (int c = 0; c < kColsO; ++c) kv[c] = ks[j * kDS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < kColsO; ++c) acc[i][c] = fmaf(dv_[i], kv[c], acc[i][c]);
    }
  }
  T* dq = static_cast<T*>(a.dq) + static_cast<size_t>(bhi) * a.seq_len * D;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.seq_len) continue;
#pragma unroll
    for (int c = 0; c < kColsO; ++c)
      dq[static_cast<size_t>(row) * D + tx + 16 * c] = from_f32<T>(acc[i][c] * a.scale);
  }
}

// Pass 3: dv = sum_i p_ij do_i and dk = scale * sum_i ds_ij q_i for 64 keys.
// Here the keys are the tile's rows (ty) and the queries its columns (tx).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attn_bwd_dkdv(Args a) {
  constexpr int kDS = D + 1;
  constexpr int kColsO = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;                  // [kBlock][kDS]
  float* vs = ks + kBlock * kDS;
  float* qs = vs + kBlock * kDS;     // scaled
  float* dos = qs + kBlock * kDS;
  float* ps = dos + kBlock * kDS;    // [kBlock keys][kPStride]
  float* dss = ps + kBlock * kPStride;
  float* rs = dss + kBlock * kPStride;  // [3][kBlock]: m, 1/l, delta per query
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bhi = blockIdx.x;
  const int k0 = blockIdx.y * kBlock;  // causal: early keys see the most queries
  const T* q = head_ptr<T>(a.q, a.qs, bhi, a.heads);
  const T* k = head_ptr<T>(a.k, a.ks, bhi, a.heads);
  const T* v = head_ptr<T>(a.v, a.vs, bhi, a.heads);
  const T* dout = head_ptr<T>(a.dout, a.ds, bhi, a.heads);
  load_tile<T, D>(ks, k, a.ks.s, k0, a.seq_len, 1.f);
  load_tile<T, D>(vs, v, a.vs.s, k0, a.seq_len, 1.f);

  const size_t plane = static_cast<size_t>(a.bh) * a.seq_len;
  const float* st = a.stats + static_cast<size_t>(bhi) * a.seq_len;
  float dk[kPer][kColsO], dv[kPer][kColsO];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < kColsO; ++c) dk[i][c] = dv[i][c] = 0.f;
  const int n_q = (a.seq_len + kBlock - 1) / kBlock;
  // causal: query tiles before this key tile see none of its keys
  for (int qt = a.causal ? k0 / kBlock : 0; qt < n_q; ++qt) {
    const int q0 = qt * kBlock;
    __syncthreads();  // the previous tile's reads of qs, dos, ps, dss, rs are done
    load_tile<T, D>(qs, q, a.qs.s, q0, a.seq_len, a.scale);
    load_tile<T, D>(dos, dout, a.ds.s, q0, a.seq_len, 1.f);
    if (threadIdx.x < kBlock) {
      const int row = q0 + threadIdx.x;
      const bool ok = row < a.seq_len;
      rs[threadIdx.x] = ok ? st[row] : 0.f;
      rs[kBlock + threadIdx.x] = ok ? st[plane + row] : 0.f;
      rs[2 * kBlock + threadIdx.x] = ok ? st[2 * plane + row] : 0.f;
    }
    __syncthreads();
    // sT[i][j] = k_i . (scale q_j), dpT[i][j] = v_i . do_j
    float sT[kPer][kPer], dpT[kPer][kPer];
    two_products<D>(ks, qs, vs, dos, sT, dpT, ty, tx);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = tx + 16 * j;
      const float mj = rs[c], inv_lj = rs[kBlock + c], dj = rs[2 * kBlock + c];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int r = ty + 16 * i;
        const bool ok = live(q0 + c, k0 + r, a.seq_len, a.causal);
        const float p = ok ? expf(sT[i][j] - mj) * inv_lj : 0.f;
        ps[r * kPStride + c] = p;
        dss[r * kPStride + c] = ok ? p * (dpT[i][j] - dj) : 0.f;
      }
    }
    __syncwarp();  // a key row of ps and dss is written and read by one half-warp
#pragma unroll 4
    for (int j = 0; j < kBlock; ++j) {
      float pv[kPer], dsv[kPer], dov[kColsO], qv[kColsO];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        pv[i] = ps[(ty + 16 * i) * kPStride + j];
        dsv[i] = dss[(ty + 16 * i) * kPStride + j];
      }
#pragma unroll
      for (int c = 0; c < kColsO; ++c) {
        dov[c] = dos[j * kDS + tx + 16 * c];
        qv[c] = qs[j * kDS + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < kColsO; ++c) {
          dv[i][c] = fmaf(pv[i], dov[c], dv[i][c]);
          dk[i][c] = fmaf(dsv[i], qv[c], dk[i][c]);
        }
    }
  }
  const size_t base = static_cast<size_t>(bhi) * a.seq_len * D;
  T* dkp = static_cast<T*>(a.dk) + base;
  T* dvp = static_cast<T*>(a.dv) + base;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= a.seq_len) continue;
#pragma unroll
    for (int c = 0; c < kColsO; ++c) {
      const size_t o = static_cast<size_t>(row) * D + tx + 16 * c;
      dkp[o] = from_f32<T>(dk[i][c]);  // q was staged scaled
      dvp[o] = from_f32<T>(dv[i][c]);
    }
  }
}

template <typename Kernel>
cudaError_t launch_one(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                       const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t tile = sizeof(float) * kBlock * (D + 1);
  constexpr size_t pst = sizeof(float) * kBlock * kPStride;
  const int n = (a.seq_len + kBlock - 1) / kBlock;
  const dim3 grid(a.bh, n);
  cudaError_t err = launch_one(flash_attn_bwd_stats<T, D>, grid, 4 * tile, stream, a);
  if (err != cudaSuccess) return err;
  err = launch_one(flash_attn_bwd_dq<T, D>, grid, 4 * tile + pst, stream, a);
  if (err != cudaSuccess) return err;
  return launch_one(flash_attn_bwd_dkdv<T, D>, grid,
                    4 * tile + 2 * pst + sizeof(float) * 3 * kBlock, stream, a);
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
  }
  // D 64 and 128 go to the tensor-core kernels
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, dout [batch, heads, seq_len, d] read through strides: 12 element
// strides, (batch, head, sequence) of q, k, v, then dout.  dq, dk, dv: new
// contiguous [batch, heads, seq_len, d] of the same type.  stats: fp32
// scratch of 3 * batch * heads * seq_len.  dtype: 0 = fp32, 1 = bf16,
// 2 = fp16.  Returns a cudaError_t; 0 is success.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v, const void* dout,
                              void* dq, void* dk, void* dv, void* stats, int batch,
                              int heads, int seq_len, int d, const long long* strides,
                              int dtype, int causal, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || seq_len <= 0 ||
      (seq_len + kBlock - 1) / kBlock > 65535)
    return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.stats = static_cast<float*>(stats);
  a.bh = batch * heads;
  a.heads = heads;
  a.seq_len = seq_len;
  a.qs = {strides[0], strides[1], strides[2]};
  a.ks = {strides[3], strides[4], strides[5]};
  a.vs = {strides[6], strides[7], strides[8]};
  a.ds = {strides[9], strides[10], strides[11]};
  a.scale = scale;
  a.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(a, d, s);
    case 1: return dispatch_d<__nv_bfloat16>(a, d, s);
    case 2: return dispatch_d<__half>(a, d, s);
    default: return cudaErrorInvalidValue;
  }
}
