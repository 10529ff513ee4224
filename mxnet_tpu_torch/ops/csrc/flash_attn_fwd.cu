// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel mxnet_tpu/ops/pallas_kernels.py
// (_attn_kernel:41, launched by _flash_fwd_impl:95, public flash_attention:178).
// It computes the same function, not a block-by-block copy:
//   o = softmax(mask(q * sm_scale @ k^T)) @ v   per (batch, head),
// with fp32 scores, running max, denominator and accumulator, masked scores
// set to -1e30, causal masking by absolute position, key tiles wholly in the
// future of a query tile skipped, and a final division by max(l, 1e-30).
// q, k and v are [B, H, S, D] with any strides whose last is 1 (each tensor
// its own); the output is a new contiguous [B, H, S, D] in the input's type.
//
// Which inputs come here: every dtype at D in {16, 32}.  At D in {64, 128}
// the tensor cores take them: bf16/fp16 in flash_attn_fwd_sm90.cu, fp32 in
// flash_attn_fwd_f32_sm90.cu (three bf16 parts per value, six bf16 products
// per product, which keeps fp32's accuracy where a TF32 product would not).
//
// Design.  One thread block per (b*h, 64-row query tile); the TPU's
// sequential k grid axis becomes a loop over 64-row K/V tiles inside the
// block.  The scaled query tile and each K/V tile are staged in shared memory
// as fp32.  256 threads form a 16x16 grid: thread (ty, tx) owns query rows
// ty + 16*i (i < 4), score columns tx + 16*j and output columns tx + 16*c.
// The 16 lanes that own a row are one half-warp, so the row max and row sum
// are warp shuffles and the probabilities pass to P@V through a shared tile
// that only that half-warp reads.  The ragged tail is bounds-checked: rows
// past S load as zeros and their scores are masked, so no tensor is padded in
// device memory.  Heavier (later) query tiles are scheduled first.
//
// What bounds it on the H100 (3.35 TB/s; 67 TFLOP/s fp32 outside the tensor
// cores).  fp32, causal, B=8, H=12, S=1024, D=32: q/k/v/o traffic
// 4 * 8*12*1024*32 * 4 B = 50.3 MB -> 15.0 us; 4*D*S(S+1)/2*B*H = 6.4 GFLOP
// at 67 TFLOP/s -> 96 us: bound by operations.  What this design leaves on
// the table: the inner loops issue about one shared-memory load per two
// FMAs, global loads are scalar and overlap only the end of the previous
// tile's products, and the exponentials and shuffles of the softmax sit
// between the two products.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;              // 16 x 16
constexpr int kRows = kBlockQ / 16;        // query rows per thread
constexpr int kCols = kBlockK / 16;        // score columns per thread
constexpr int kPStride = kBlockK + 16;     // the two half-warps' rows hit other banks
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // q and k rows padded to D + 1 floats: column reads across tx hit distinct banks
  return sizeof(float) *
         (kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D + kBlockQ * kPStride);
}

// Element strides of one input: batch, head, sequence (the last is 1).
struct Strides {
  long long b, h, s;
};

// The second bound, 3 blocks an SM, lets ptxas use up to 85 registers a
// thread, where left to itself it stopped at 64 and spilled (20 bytes at
// D = 64, when this kernel still took D 64) once the row strides took
// registers.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 3)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int heads,
                      int seq_len, Strides qs_, Strides ks_, Strides vs_,
                      float scale, int causal) {
  constexpr int kDS = D + 1;
  constexpr int kColsO = D / 16;
  // Tile loads: thread tid copies column lc of the rows lr + kRowStep * i,
  // the same count kLoads in every K/V tile, so the loads unroll.
  constexpr int kRowStep = kThreads / D;
  constexpr int kLoads = kBlockK / kRowStep;  // rows of a K/V tile per thread
  static_assert(kThreads % D == 0, "a tile row must split evenly over threads");
  extern __shared__ float smem[];
  float* qs = smem;                    // [kBlockQ][kDS], already scaled
  float* ks = qs + kBlockQ * kDS;      // [kBlockK][kDS]
  float* vs = ks + kBlockK * kDS;      // [kBlockK][D]
  float* ps = vs + kBlockK * D;        // [kBlockQ][kPStride]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lc = tid % D, lr = tid / D;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const long long bi = blockIdx.x / heads, hi = blockIdx.x % heads;
  q += bi * qs_.b + hi * qs_.h;
  k += bi * ks_.b + hi * ks_.h;
  v += bi * vs_.b + hi * vs_.h;
  o += static_cast<size_t>(blockIdx.x) * seq_len * D;

  for (int r = lr; r < kBlockQ; r += kRowStep) {
    const int row = q0 + r;
    qs[r * kDS + lc] = row < seq_len ? to_f32(q[row * qs_.s + lc]) * scale : 0.f;
  }

  float acc[kRows][kColsO];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kColsO; ++c) acc[i][c] = 0.f;
  }

  int n_k = (seq_len + kBlockK - 1) / kBlockK;
  if (causal) n_k = min(n_k, (q0 + kBlockQ - 1) / kBlockK + 1);

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBlockK;
    // every global load of the tile is issued before the barrier that waits
    // for the previous tile's products, and before any shared store
    float kr[kLoads], vr[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int row = k0 + lr + i * kRowStep;
      const bool ok = row < seq_len;
      kr[i] = ok ? to_f32(k[row * ks_.s + lc]) : 0.f;
      // zeros, so 0 * v stays 0 in the tail
      vr[i] = ok ? to_f32(v[row * vs_.s + lc]) : 0.f;
    }
    __syncthreads();  // the previous tile's reads of ks/vs are done (and qs is written)
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      ks[(lr + i * kRowStep) * kDS + lc] = kr[i];
      vs[(lr + i * kRowStep) * D + lc] = vr[i];
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + 16 * i) * kDS + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + 16 * j) * kDS + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < seq_len && (!causal || qp >= kp);
        s[i][j] = ok ? s[i][j] : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[r * kPStride + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kColsO; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // a row of ps is written and read by the same half-warp

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float pv[kRows], vv[kColsO];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + 16 * i) * kPStride + j];
#pragma unroll
      for (int c = 0; c < kColsO; ++c) vv[c] = vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kColsO; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kColsO; ++c)
      o[static_cast<size_t>(row) * D + tx + 16 * c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh,
                   int heads, int seq_len, const Strides* st, float scale,
                   int causal, cudaStream_t stream) {
  auto kernel = flash_attn_fwd_kernel<T, D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq_len + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), heads, seq_len, st[0], st[1], st[2], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, int bh,
                       int heads, int seq_len, int d, const Strides* st,
                       float scale, int causal, cudaStream_t stream) {
  // D 64 and 128 go to the tensor-core kernels
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, bh, heads, seq_len, st, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, bh, heads, seq_len, st, scale, causal, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v [batch, heads, seq_len, d]; strides: 9 element strides, (batch,
// head, sequence) of q, then k, then v.  dtype: 0 = fp32, 1 = bf16,
// 2 = fp16.  Returns a cudaError_t; 0 is success.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                              int batch, int heads, int seq_len, int d,
                              const long long* strides, int dtype, int causal,
                              float scale, void* stream) {
  const int bh = batch * heads;
  if (batch <= 0 || heads <= 0 || seq_len <= 0 ||
      (seq_len + kBlockQ - 1) / kBlockQ > 65535)
    return cudaErrorInvalidValue;
  const Strides st[3] = {{strides[0], strides[1], strides[2]},
                         {strides[3], strides[4], strides[5]},
                         {strides[6], strides[7], strides[8]}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, o, bh, heads, seq_len, d, st, scale, causal, s);
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, o, bh, heads, seq_len, d, st, scale, causal, s);
    case 2: return dispatch_d<__half>(q, k, v, o, bh, heads, seq_len, d, st, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}
