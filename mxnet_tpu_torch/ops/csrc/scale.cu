// Elementwise scale o = x * alpha for the H100 (sm_90a).
//
// Replaces the Pallas kernel `pl_scale` / `_scale_body`
// (tests/test_pallas_register.py:32-36, :25), the user kernel that
// mxnet_tpu/pallas.py::register installs as an operator.  The wrapper is
// mxnet_tpu_torch/ops/scale.py::scale.
//
// Bound: bytes.  Each element is read once and written once and costs one
// multiply, so the least time is 2 * numel * sizeof(T) / 3.35 TB/s.  Each
// thread moves one 16-byte vector (4 fp32 or 8 bf16/fp16 values),
// neighbouring threads neighbouring vectors, in one pass over the tensor:
// block b covers vectors [b * kThreads, (b + 1) * kThreads).  Measured on
// the H100 at 8192 x 8192, this grid beat blocks of 256 threads with one
// vector each, and blocks of 256 with four vectors a thread loaded before
// any store with the streaming hints __ldcs/__stcs (PERF.md, PR 3).  A tail
// shorter than one vector, and any input or output not aligned to 16 bytes,
// goes element by element.
//
// Arithmetic: each value is widened to fp32, multiplied by the fp32 alpha
// and rounded once, to nearest even, to the input type -- the same single
// multiply and rounding as the plain version (x.float() * alpha).to(T),
// so the two agree bit for bit.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T>
__device__ __forceinline__ uint4 scale_vec(uint4 in, float alpha) {
  constexpr int kVec = 16 / sizeof(T);
  uint4 out;
  const T* a = reinterpret_cast<const T*>(&in);
  T* b = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int k = 0; k < kVec; ++k) b[k] = from_f32<T>(to_f32(a[k]) * alpha);
  return out;
}

constexpr int kThreads = 1024;

// n_vec = n / kVec 16-byte vectors, one per thread, then the n - n_vec * kVec
// tail (fewer elements than block 0 has threads).
template <typename T>
__global__ void __launch_bounds__(kThreads)
scale_kernel(const T* __restrict__ x, T* __restrict__ y, long long n, float alpha) {
  constexpr int kVec = 16 / sizeof(T);
  const long long n_vec = n / kVec;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n_vec)
    reinterpret_cast<uint4*>(y)[i] =
        scale_vec<T>(reinterpret_cast<const uint4*>(x)[i], alpha);
  const long long tail = n_vec * kVec + threadIdx.x;
  if (blockIdx.x == 0 && tail < n) y[tail] = from_f32<T>(to_f32(x[tail]) * alpha);
}

// Inputs or outputs not aligned to 16 bytes: element by element.
template <typename T>
__global__ void __launch_bounds__(256)
scale_unaligned_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                       float alpha) {
  const long long stride = (long long)gridDim.x * 256;
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < n; i += stride)
    y[i] = from_f32<T>(to_f32(x[i]) * alpha);
}

template <typename T>
cudaError_t launch(const void* xp, void* yp, long long n, float alpha,
                   cudaStream_t stream) {
  const T* x = static_cast<const T*>(xp);
  T* y = static_cast<T*>(yp);
  if ((uintptr_t)x % 16 != 0 || (uintptr_t)y % 16 != 0) {
    long long blocks = (n + 255) / 256;
    if (blocks > 132 * 16) blocks = 132 * 16;
    scale_unaligned_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(x, y, n, alpha);
    return cudaGetLastError();
  }
  constexpr int kVec = 16 / sizeof(T);
  long long blocks = (n / kVec + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;  // the tail alone
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  scale_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(x, y, n, alpha);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16.  n > 0.  Returns the launch's cudaError_t.
extern "C" int scale_fwd(const void* x, void* y, long long n, int dtype, float alpha,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(x, y, n, alpha, s);
    case 1: return (int)launch<__nv_bfloat16>(x, y, n, alpha, s);
    case 2: return (int)launch<__half>(x, y, n, alpha, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
