// Greedy non-maximum suppression for the H100 (sm_90a): suppression bits
// over 64-box tiles across the whole card, then a walk of one barrier a
// tile.
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
// [0, trip), if box i is still alive, every later box j of the same class
// (or any class with force) whose IoU with box i is above the threshold
// dies.  The output is the alive mask afterwards.
//
// Bound: the IoUs are few (one for each pair of kept boxes of a class) and
// the bytes fewer, so the least time is microseconds; what costs is the
// walk's order, since box i's fate is known only once every earlier kept
// box has swept, and a walk of one block barrier for each kept box is
// thousands of barriers in series.  Design, two launches:
//   1. mask_kernel, over the whole card: word (u, i) of the scratch, a
//      uint64, has bit r set iff box j = 64u + r is after box i, of its
//      class (or force), and iou(i, j) > threshold: exactly the loop's
//      kill decision, for the rows i < trip and the column tiles u at or
//      after i's own.  The scratch is (batch, ceil(n / 64), trip), column
//      tile major, so a tile's 64 rows of one column tile are 512
//      contiguous bytes.  A block of 64 threads takes one row tile (a row
//      a thread) against kGroup column tiles staged in shared memory, the
//      upper triangle only.  Class-aware, each staged tile also sorts its
//      columns into 65 buckets by class (an integral class c below 2^31
//      in magnitude goes to c & 63, any other to 64), so a row visits only
//      the columns of its bucket (about one in 20 at SSD-300), and every
//      column where force is set.
//   2. walk_kernel, one block of 1024 an image, the removed bits in shared
//      memory (8 bytes a tile), a step of one __syncthreads for each tile
//      up to trip and one more where a tile follows (137 at SSD-300's
//      8,732 boxes, against 6,188 kept boxes in the longest image).  At
//      step t warp 0 ORs tile t-1's kept boxes' words of tile t into
//      removed word t, then resolves tile t from its 64 diagonal words in
//      rounds (the open boxes no open box suppresses are kept, the first
//      always; those the kept suppress are removed).  Meanwhile warps
//      1-31 OR tile t-1's kept boxes' words of tiles t+1 on into those
//      tiles' removed words, one warp a column tile, from words each
//      loaded a step ahead (all 64 rows of the tile, before the kept ones
//      are known), and warp 1 loads what warp 0 reads two steps ahead.
//      So no step waits on a device-memory load for its own tile.
//
// Arithmetic: a pair needs its IoU only when both boxes have positive
// extents and overlap strictly in x and in y (four compares, false on a
// NaN corner); otherwise the intersection is 0 or NaN, the loop's IoU is 0,
// and the decision is 0 > threshold.  Where it is needed the IoU takes the
// plain version's roundings one by one, in _iou_matrix's order
// (ssd.py:84-96): max/min of the corners (no corner is NaN there, so a
// compare and a select are torch.maximum's and torch.minimum's), the
// clamped extents, the products, (area_a + area_g) - inter, then inter /
// union where union > 0.  Every add, subtract, multiply and divide is an
// _rn intrinsic, which nvcc never contracts into a fused multiply-add, so
// every bit is the plain version's kill decision.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;            // boxes a word
constexpr int kWalkThreads = 1024;
constexpr int kWalkWarps = kWalkThreads / 32;
constexpr int kHelpers = kWalkWarps - 1;   // warps 1-31
constexpr int kBulkBatch = 5;        // column tiles a helper warp loads ahead
constexpr int kGroup = 2;            // column tiles a mask block

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// torch.maximum / torch.minimum where neither is NaN (the IoU is computed
// only for boxes whose extents compare positive, so no corner is NaN)
template <typename T>
__device__ __forceinline__ T max_of(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T min_of(T a, T b) { return a < b ? a : b; }
// torch.clamp(x, min=0): NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp0(T x) { return x < T(0) ? T(0) : x; }

template <typename T>
__device__ __forceinline__ T area_of(T x0, T y0, T x1, T y1) {
  return mul_rn(clamp0(sub_rn(x1, x0)), clamp0(sub_rn(y1, y0)));
}

// bits [lo, hi) of a word, either end clipped to [0, 64]
__device__ __forceinline__ uint64_t bit_range(int lo, int hi) {
  lo = lo < 0 ? 0 : lo;
  if (hi <= lo) return 0;
  const uint64_t below_hi = hi >= 64 ? ~0ull : ((1ull << hi) - 1);
  const uint64_t below_lo = lo >= 64 ? ~0ull : ((1ull << lo) - 1);
  return below_hi & ~below_lo;
}

// four corners, loaded from shared memory as one or two 16-byte vectors
template <typename T>
struct alignas(4 * sizeof(T)) Corners {
  T x0, y0, x1, y1;
};

__device__ __forceinline__ uint64_t warp_or(uint64_t v) {
  const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)v);
  const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(v >> 32));
  return ((uint64_t)hi << 32) | lo;
}

// The mask's blocks of an image: row tile rt takes the groups of kGroup
// column tiles from the one holding tile rt on.  The first block of row
// tile rt, of groups column groups in all.
__device__ __forceinline__ long long group_offset(long long rt, long long groups) {
  const long long q = rt / kGroup, rem = rt % kGroup;
  return rt * groups - (kGroup * q * (q - 1) / 2 + rem * q);
}

// a class's bucket: an integral class below 2^31 in magnitude falls in
// bucket (int)c & 63, any other in 64 (whose rows test every column)
template <typename T>
__device__ __forceinline__ int class_key(T c) {
  if (!(c < T(2147483648.0) && c > T(-2147483648.0))) return 64;
  const int v = (int)c;
  return (T)v == c ? (v & 63) : 64;
}

// Row tile rt against kGroup column tiles: a word for each box i < trip of
// the row tile and each column tile at or after rt.
template <typename T, bool kForce>
__global__ void __launch_bounds__(kTile)
mask_kernel(const T* __restrict__ boxes, const T* __restrict__ classes,
            uint64_t* __restrict__ mask, int n, int trip, int words, int tiles,
            T threshold) {
  // the filter's corners (a box without positive extents overlaps none),
  // the true corners, area and class of each column, and each column
  // tile's columns by class bucket
  __shared__ Corners<T> fbox[kGroup][kTile], gbox[kGroup][kTile];
  __shared__ T garea[kGroup][kTile], gcls[kGroup][kTile];
  __shared__ uint64_t bucket[kGroup][65];
  const T inf = (T)INFINITY;
  const long long q = blockIdx.x;
  const size_t img = blockIdx.y;
  const int groups = (words + kGroup - 1) / kGroup;
  int rt = 0;
  for (int hi = tiles - 1; rt < hi;) {
    const int mid = (rt + hi + 1) / 2;
    if (group_offset(mid, groups) <= q) rt = mid; else hi = mid - 1;
  }
  const int cg = rt / kGroup + (int)(q - group_offset(rt, groups));
  const int ct0 = cg * kGroup;
  const int r = threadIdx.x;
  const T* bimg = boxes + img * (size_t)n * 4;
  const T* cimg = classes + img * (size_t)n;
  const int i = rt * kTile + r;
  T ax0 = 0, ay0 = 0, ax1 = 0, ay1 = 0, ci = 0;
  if (i < trip) {
    ax0 = bimg[4 * (size_t)i];
    ay0 = bimg[4 * (size_t)i + 1];
    ax1 = bimg[4 * (size_t)i + 2];
    ay1 = bimg[4 * (size_t)i + 3];
    ci = cimg[i];
  }
  if (!kForce) {
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      bucket[g][r] = 0;
      if (r == 0) bucket[g][64] = 0;
    }
    __syncthreads();
  }
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const int j = (ct0 + g) * kTile + r;
    T x0 = inf, y0 = inf, x1 = -inf, y1 = -inf, c = (T)NAN;
    if (j < n) {
      x0 = bimg[4 * (size_t)j];
      y0 = bimg[4 * (size_t)j + 1];
      x1 = bimg[4 * (size_t)j + 2];
      y1 = bimg[4 * (size_t)j + 3];
      c = cimg[j];
    }
    const bool pos = x1 > x0 && y1 > y0;
    fbox[g][r] = pos ? Corners<T>{x0, y0, x1, y1} : Corners<T>{inf, inf, -inf, -inf};
    gbox[g][r] = Corners<T>{x0, y0, x1, y1};
    garea[g][r] = area_of(x0, y0, x1, y1);
    gcls[g][r] = c;
    if (!kForce)
      atomicOr(reinterpret_cast<unsigned*>(&bucket[g][class_key(c)]) + (r >> 5),
               1u << (r & 31));
  }
  __syncthreads();
  if (i >= trip) return;
  const bool pos_a = ax1 > ax0 && ay1 > ay0;
  const T fax0 = pos_a ? ax0 : inf, fay0 = pos_a ? ay0 : inf;
  const T fax1 = pos_a ? ax1 : -inf, fay1 = pos_a ? ay1 : -inf;
  const T area_a = area_of(ax0, ay0, ax1, ay1);
  const int key = class_key(ci);
  // no overlap: the IoU is 0, and 0 > threshold decides
  const bool zero_kills = T(0) > threshold;
#pragma unroll 1
  for (int g = 0; g < kGroup; ++g) {
    const int ct = ct0 + g;
    if (ct < rt) continue;
    if (ct >= words) break;
    // the columns after i and before n
    const uint64_t valid = bit_range(i + 1 - ct * kTile, n - ct * kTile);
    auto overlaps = [&](int c) {
      const Corners<T> f = fbox[g][c];
      return fax1 > f.x0 && f.x1 > fax0 && fay1 > f.y0 && f.y1 > fay0;
    };
    auto kills = [&](int c) {
      const Corners<T> b = gbox[g][c];
      const T ix0 = max_of(ax0, b.x0), iy0 = max_of(ay0, b.y0);
      const T ix1 = min_of(ax1, b.x1), iy1 = min_of(ay1, b.y1);
      const T inter = mul_rn(clamp0(sub_rn(ix1, ix0)), clamp0(sub_rn(iy1, iy0)));
      const T uni = sub_rn(add_rn(area_a, garea[g][c]), inter);
      const T iou = uni > T(0) ? div_rn(inter, uni) : T(0);
      return iou > threshold;
    };
    uint64_t bits = 0;
    if constexpr (kForce) {
      // every column is of the class: the overlap test over all 64 at
      // once, then the IoUs
      uint64_t maybe = 0;
#pragma unroll
      for (int c = 0; c < kTile; ++c)
        if (overlaps(c)) maybe |= 1ull << c;
      maybe &= valid;
      if (zero_kills) bits = valid & ~maybe;
      while (maybe) {
        const int c = __ffsll((long long)maybe) - 1;
        maybe &= maybe - 1;
        if (kills(c)) bits |= 1ull << c;
      }
    } else {
      // the columns of the row's class bucket (about one in 20 at
      // SSD-300), then for those of its class the overlap and the IoU
      uint64_t cand = (key < 64 ? bucket[g][key] : ~0ull) & valid;
      while (cand) {
        const int c = __ffsll((long long)cand) - 1;
        cand &= cand - 1;
        if (gcls[g][c] == ci && (overlaps(c) ? kills(c) : zero_kills))
          bits |= 1ull << c;
      }
    }
    mask[(img * (size_t)words + ct) * (size_t)trip + i] = bits;
  }
}

// One block an image walks its tiles in order; see the header.
__global__ void __launch_bounds__(kWalkThreads)
walk_kernel(const uint64_t* __restrict__ mask, const uint8_t* __restrict__ alive_in,
            uint8_t* __restrict__ alive_out, int n, int trip, int words) {
  extern __shared__ uint64_t removed[];   // one word a tile
  __shared__ uint64_t diag[2][kTile];     // [k & 1]: tile k's words of tile k
  __shared__ uint64_t ahead[2][kTile];    // [k & 1]: tile k's words of tile k+1
  __shared__ uint64_t alive_w[2], kept[2];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int helper = warp - 1;
  const size_t img = blockIdx.x;
  const uint64_t* m = mask + img * (size_t)words * trip;
  const uint8_t* ain = alive_in + img * (size_t)n;
  const int tiles = (trip + kTile - 1) / kTile;

  // what warp 0 reads at step u: tile u's alive bytes and column tile u's
  // words of row tiles u-1 and u; helper 0 loads them at step u-2 and
  // stores them at step u-1 into alive_w[u & 1], ahead[(u - 1) & 1] and
  // diag[u & 1]
  struct Next {
    bool a0, a1;
    uint64_t w[4];
  };
  auto load_next = [&](int u) {
    Next x;
    const int j0 = u * kTile + lane, j1 = j0 + 32;
    x.a0 = j0 < n && ain[j0];
    x.a1 = j1 < n && ain[j1];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int row = (u - 1) * kTile + lane + 32 * k;
      x.w[k] = (row >= 0 && row < trip) ? m[(size_t)u * trip + row] : 0;
    }
    return x;
  };
  auto store_next = [&](int u, const Next& x) {
    const unsigned lo = __ballot_sync(0xffffffffu, x.a0);
    const unsigned hi = __ballot_sync(0xffffffffu, x.a1);
    if (lane == 0) alive_w[u & 1] = ((uint64_t)hi << 32) | lo;
    if (u >= 1) {
      ahead[(u - 1) & 1][lane] = x.w[0];
      ahead[(u - 1) & 1][lane + 32] = x.w[1];
    }
    diag[u & 1][lane] = x.w[2];
    diag[u & 1][lane + 32] = x.w[3];
  };
  // Helper h ORs tile t-1's kept rows into column tiles t+1+h, t+1+h+31,
  // ...: the first kBulkBatch of them from the words it loaded at step
  // t-1, before the kept rows were known (rows lane and lane+32 of the
  // tile), the rest, where there are more tiles, loaded at step t.
  uint64_t first0[kBulkBatch], first1[kBulkBatch];
  auto load_first = [&](int k) {   // tile k's rows, for step k+1
    const int r0 = k * kTile + lane, r1 = r0 + 32;
#pragma unroll
    for (int b = 0; b < kBulkBatch; ++b) {
      const int u = k + 2 + helper + b * kHelpers;
      const uint64_t* col = m + (size_t)u * trip;
      first0[b] = (u < words && r0 < trip) ? col[r0] : 0;
      first1[b] = (u < words && r1 < trip) ? col[r1] : 0;
    }
  };
  // few words are not 0 (a kept box suppresses few others), so the lanes
  // OR theirs in with shared-memory atomics rather than a warp reduction
  auto or_into = [&](int u, uint64_t v) {
    if (v && u < words) atomicOr(reinterpret_cast<unsigned long long*>(&removed[u]), v);
  };

  for (int u = tid; u < words; u += kWalkThreads) removed[u] = 0;
  Next loaded;   // helper 0: for the step after next
  if (warp == 0) {
    if (lane == 0) kept[1] = 0;
  } else {
    if (helper == 0) {
      store_next(0, load_next(0));
      if (1 < words) loaded = load_next(1);
    }
#pragma unroll
    for (int b = 0; b < kBulkBatch; ++b) first0[b] = first1[b] = 0;
  }
  __syncthreads();
  const int steps = min(tiles + 1, words);
  for (int t = 0; t < steps; ++t) {
    const int p = t & 1;
    const uint64_t kprev = kept[p ^ 1];   // tile t-1's kept boxes
    if (warp == 0) {
      uint64_t s = 0;
      if ((kprev >> lane) & 1) s |= ahead[p ^ 1][lane];
      if ((kprev >> (lane + 32)) & 1) s |= ahead[p ^ 1][lane + 32];
      uint64_t rem = removed[t] | warp_or(s);
      uint64_t keep = 0;
      // the tile's candidates, in rounds: those no undecided candidate
      // suppresses are kept (the first always is), and those the kept
      // suppress are removed; lane l holds the words of boxes l and l+32
      const int left = trip - t * kTile;
      const uint64_t before_trip =
          left >= kTile ? ~0ull : (left > 0 ? (1ull << left) - 1 : 0);
      uint64_t open = alive_w[p] & ~rem & before_trip;
      if (open) {
        const uint64_t d0 = diag[p][lane], d1 = diag[p][lane + 32];
        while (open) {
          s = 0;
          if ((open >> lane) & 1) s |= d0;
          if ((open >> (lane + 32)) & 1) s |= d1;
          const uint64_t kept_now = open & ~warp_or(s);
          s = 0;
          if ((kept_now >> lane) & 1) s |= d0;
          if ((kept_now >> (lane + 32)) & 1) s |= d1;
          const uint64_t removed_now = warp_or(s);
          keep |= kept_now;
          rem |= removed_now;
          open &= ~kept_now & ~removed_now;
        }
      }
      if (lane == 0) {
        removed[t] = rem;
        kept[p] = keep;
      }
    } else {
      if (helper == 0) {
        if (t + 1 < words) store_next(t + 1, loaded);
        if (t + 2 < words) loaded = load_next(t + 2);
      }
      const bool k0 = (kprev >> lane) & 1, k1 = (kprev >> (lane + 32)) & 1;
      if (kprev) {
#pragma unroll
        for (int b = 0; b < kBulkBatch; ++b)
          or_into(t + 1 + helper + b * kHelpers,
                  (k0 ? first0[b] : 0) | (k1 ? first1[b] : 0));
      }
      load_first(t);
      if (kprev) {
        const uint64_t* rows = m + (size_t)(t - 1) * kTile;
        for (int u = t + 1 + helper + kBulkBatch * kHelpers; u < words; u += kHelpers) {
          const uint64_t* col = rows + (size_t)u * trip;
          or_into(u, (k0 ? col[lane] : 0) | (k1 ? col[lane + 32] : 0));
        }
      }
    }
    __syncthreads();
  }
  uint8_t* out = alive_out + img * (size_t)n;
  for (int j = tid; j < n; j += kWalkThreads)
    out[j] = ain[j] && !((removed[j / kTile] >> (j % kTile)) & 1);
}

template <typename T>
cudaError_t launch(const void* boxes, const void* classes, const void* alive_in,
                   void* alive_out, void* scratch, int batch, int n, int trip,
                   double threshold, int force, cudaStream_t stream) {
  const int words = (n + kTile - 1) / kTile;
  const int tiles = (trip + kTile - 1) / kTile;
  uint64_t* mask = static_cast<uint64_t*>(scratch);
  if (tiles > 0) {
    const int groups = (words + kGroup - 1) / kGroup;
    long long blocks = 0;   // group_offset(tiles, groups), on the host
    for (int rt = 0; rt < tiles; ++rt) blocks += groups - rt / kGroup;
    const dim3 grid((unsigned)blocks, (unsigned)batch);
    const T* b = static_cast<const T*>(boxes);
    const T* c = static_cast<const T*>(classes);
    if (force)
      mask_kernel<T, true><<<grid, kTile, 0, stream>>>(b, c, mask, n, trip, words,
                                                       tiles, (T)threshold);
    else
      mask_kernel<T, false><<<grid, kTile, 0, stream>>>(b, c, mask, n, trip, words,
                                                        tiles, (T)threshold);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  walk_kernel<<<batch, kWalkThreads, (size_t)words * sizeof(uint64_t), stream>>>(
      mask, static_cast<const uint8_t*>(alive_in), static_cast<uint8_t*>(alive_out),
      n, trip, words);
  return cudaGetLastError();
}

}  // namespace

// boxes (batch, n, 4) and classes (batch, n) contiguous, of dtype 0 fp32 or
// 1 fp64; alive_in / alive_out (batch, n) bytes of 0 or 1; scratch
// (batch, ceil(n / 64), trip) uint64 words.  0 < batch <= 65535, 0 < n <=
// 360,448 (walk_kernel's removed words within the 48 KB of shared memory
// a block has without opting in), 0 <= trip <= n.  Launches mask_kernel
// (when trip > 0), then walk_kernel, and returns the first cudaError_t.
extern "C" int nms_fwd(const void* boxes, const void* classes, const void* alive_in,
                       void* alive_out, void* scratch, int batch, int n, int trip,
                       double threshold, int force, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(boxes, classes, alive_in, alive_out, scratch,
                                      batch, n, trip, threshold, force, s);
    case 1: return (int)launch<double>(boxes, classes, alive_in, alive_out, scratch,
                                       batch, n, trip, threshold, force, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
