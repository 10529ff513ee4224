// Elementwise scale o = x * alpha for the H100 (sm_90a).
//
// Replaces the Pallas kernel `pl_scale` / `_scale_body`
// (tests/test_pallas_register.py:32-36, :25), the user kernel that
// mxnet_tpu/pallas.py::register installs as an operator.  The wrapper is
// mxnet_tpu_torch/ops/scale.py::scale.
//
// Bound: bytes.  Each element is read once and written once and costs one
// multiply, so the least time is 2 * numel * sizeof(T) / 3.35 TB/s.  The
// design moves those bytes in 16-byte accesses (4 fp32 or 8 bf16/fp16
// values a thread) in a grid-stride loop over enough blocks to fill the
// 132 SMs; a tail shorter than one vector, and any input or output not
// aligned to 16 bytes, goes element by element.
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

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

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

// n_vec 16-byte vectors from x to y, then the n - n_vec * kVec tail.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
scale_kernel(const T* __restrict__ x, T* __restrict__ y, long long n, float alpha) {
  constexpr int kVec = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;
  if (kVector) {
    const long long n_vec = n / kVec;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* yv = reinterpret_cast<uint4*>(y);
    for (long long i = tid; i < n_vec; i += stride) {
      uint4 in = __ldg(xv + i);
      uint4 out;
      const T* a = reinterpret_cast<const T*>(&in);
      T* b = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int k = 0; k < kVec; ++k) b[k] = from_f32<T>(to_f32(a[k]) * alpha);
      yv[i] = out;
    }
    done = n_vec * kVec;
  }
  for (long long i = done + tid; i < n; i += stride)
    y[i] = from_f32<T>(to_f32(x[i]) * alpha);
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long n, float alpha, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  const long long work = aligned ? (n + kVec - 1) / kVec : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (aligned)
    scale_kernel<T, true><<<(int)blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), n, alpha);
  else
    scale_kernel<T, false><<<(int)blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), n, alpha);
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
