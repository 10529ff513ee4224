// Greedy non-maximum suppression for the H100 (sm_90a).
//
// Replaces no Pallas kernel: it replaces the lax.fori_loop of greedy NMS in
// mxnet_tpu/ops/ssd.py:237 (_nms_one, under _contrib_MultiBoxDetection) and
// mxnet_tpu/ops/rcnn.py:91-99 (under _contrib_Proposal and
// _contrib_MultiProposal).  Written out in PyTorch that loop costs about ten
// launches a step, and it takes min(topk, n) steps: tens of thousands of
// launches a call at SSD-300's 8,732 anchors.  The wrapper is
// mxnet_tpu_torch/ops/nms.py::nms; its plain version, nms_reference, is the
// loop itself.
//
// What it computes, per image: the boxes come sorted by score.  For i in
// [0, trip), if box i is still alive, every later box j that is alive, of
// the same class (or any class with force), and whose IoU with box i is
// above the threshold, dies.  The output is the alive mask afterwards.
//
// Bound: the walk over i is sequential, as in the JAX loop: box i's fate is
// known only once every earlier kept box has swept.  So the least time is
// set by the walk's length (the kept boxes) rather than by the bytes (the
// sorted boxes, read once) or by the IoUs (one per pair a kept box sweeps).
// Design: one block an image, 1024 threads.  The boxes, class ids and alive
// flags sit in shared memory where they fit (21 bytes a box in float32, up
// to 11,068 boxes: SSD-300's 8,732 anchors and Proposal's 6,000; 41 in
// float64, up to 5,669), else they are read
// from device memory (the flags then live in the output).  Each kept box's
// sweep over the later boxes is spread over the block's threads, one
// __syncthreads a kept box; a box found dead is skipped by every thread at
// once, with no barrier, since all read the same flag.  Making it fast (a
// bitmask of IoUs over tiles, warp-level sweeps) is later work.
//
// Arithmetic: the IoU takes the plain version's roundings one by one, in
// _iou_matrix's order (ssd.py:84-96): max/min of the corners, the clamped
// extents, the products, (area_a + area_g) - inter, then inter / union where
// union > 0.  Every add, subtract, multiply and divide is an _rn intrinsic,
// which nvcc never contracts into a fused multiply-add, and max/min propagate
// NaN as torch.maximum does, so the kill decision iou > threshold is the
// plain version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
// dynamic shared memory a block may ask for (H100: 227 KB)
constexpr int kMaxShared = 232448;

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// torch.maximum / torch.minimum: NaN if either is NaN
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
// torch.clamp(x, min=0): NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp0(T x) { return x < T(0) ? T(0) : x; }

template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads)
nms_kernel(const T* __restrict__ boxes, const T* __restrict__ classes,
           const uint8_t* __restrict__ alive_in, uint8_t* __restrict__ alive_out,
           int n, int trip, T threshold, int force) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const size_t img = blockIdx.x;
  const T* gbox = boxes + img * (size_t)n * 4;
  const T* gcls = classes + img * (size_t)n;
  uint8_t* out = alive_out + img * (size_t)n;
  const T* box;
  const T* cls;
  uint8_t* alive;
  if (kShared) {
    T* sbox = reinterpret_cast<T*>(smem);
    T* scls = sbox + 4 * (size_t)n;
    uint8_t* salive = reinterpret_cast<uint8_t*>(scls + n);
    for (int j = tid; j < 4 * n; j += kThreads) sbox[j] = gbox[j];
    for (int j = tid; j < n; j += kThreads) {
      scls[j] = gcls[j];
      salive[j] = alive_in[img * (size_t)n + j];
    }
    box = sbox;
    cls = scls;
    alive = salive;
  } else {
    for (int j = tid; j < n; j += kThreads) out[j] = alive_in[img * (size_t)n + j];
    box = gbox;
    cls = gcls;
    alive = out;
  }
  __syncthreads();
  for (int i = 0; i < trip; ++i) {
    // every thread reads the same flag: its last writer passed a barrier
    if (!alive[i]) continue;
    const T ax0 = box[4 * i], ay0 = box[4 * i + 1];
    const T ax1 = box[4 * i + 2], ay1 = box[4 * i + 3];
    const T ci = cls[i];
    const T area_a = mul_rn(clamp0(sub_rn(ax1, ax0)), clamp0(sub_rn(ay1, ay0)));
    for (int j = i + 1 + tid; j < n; j += kThreads) {
      if (!alive[j] || (!force && cls[j] != ci)) continue;
      const T gx0 = box[4 * j], gy0 = box[4 * j + 1];
      const T gx1 = box[4 * j + 2], gy1 = box[4 * j + 3];
      const T ix0 = max_nan(ax0, gx0), iy0 = max_nan(ay0, gy0);
      const T ix1 = min_nan(ax1, gx1), iy1 = min_nan(ay1, gy1);
      const T inter = mul_rn(clamp0(sub_rn(ix1, ix0)), clamp0(sub_rn(iy1, iy0)));
      const T area_g = mul_rn(clamp0(sub_rn(gx1, gx0)), clamp0(sub_rn(gy1, gy0)));
      const T uni = sub_rn(add_rn(area_a, area_g), inter);
      const T iou = uni > T(0) ? div_rn(inter, uni) : T(0);
      if (iou > threshold) alive[j] = 0;
    }
    __syncthreads();
  }
  if (kShared)
    for (int j = tid; j < n; j += kThreads) out[j] = alive[j];
}

template <typename T>
cudaError_t launch(const void* boxes, const void* classes, const void* alive_in,
                   void* alive_out, int batch, int n, int trip, double threshold,
                   int force, cudaStream_t stream) {
  const size_t shared = (size_t)n * (5 * sizeof(T) + 1);
  const T* b = static_cast<const T*>(boxes);
  const T* c = static_cast<const T*>(classes);
  const uint8_t* ai = static_cast<const uint8_t*>(alive_in);
  uint8_t* ao = static_cast<uint8_t*>(alive_out);
  if (shared <= (size_t)kMaxShared) {
    static bool attr_set = false;
    if (!attr_set) {
      cudaError_t e = cudaFuncSetAttribute(
          nms_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
      if (e != cudaSuccess) return e;
      attr_set = true;
    }
    nms_kernel<T, true><<<batch, kThreads, shared, stream>>>(
        b, c, ai, ao, n, trip, (T)threshold, force);
  } else {
    nms_kernel<T, false><<<batch, kThreads, 0, stream>>>(
        b, c, ai, ao, n, trip, (T)threshold, force);
  }
  return cudaGetLastError();
}

}  // namespace

// boxes (batch, n, 4) and classes (batch, n) contiguous, of dtype 0 fp32 or
// 1 fp64; alive_in / alive_out (batch, n) bytes of 0 or 1.  batch and n > 0,
// 0 <= trip <= n.  Returns the launch's cudaError_t.
extern "C" int nms_fwd(const void* boxes, const void* classes, const void* alive_in,
                       void* alive_out, int batch, int n, int trip, double threshold,
                       int force, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(boxes, classes, alive_in, alive_out, batch, n,
                                      trip, threshold, force, s);
    case 1: return (int)launch<double>(boxes, classes, alive_in, alive_out, batch, n,
                                       trip, threshold, force, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
