// The product of a CSR matrix and a dense one, and the product with its
// transpose, for the H100 (sm_90a).
//
// Replaces no Pallas kernel: it replaces jnp.tensordot on the dense backing
// store of a CSR (mxnet_tpu/ops/matrix.py:189-197, dot/_sparse_dot), which
// the JAX package keeps because XLA wants static shapes
// (mxnet_tpu/ndarray/sparse.py:6-14).  At avazu-app's 1,000,001 features a
// dense batch of 8192 rows is 32.8 GB; its CSR parts are a few MB.  The
// wrapper is mxnet_tpu_torch/ops/sparse_dot.py (csr_dot, csr_t_dot,
// transpose_parts); its plain versions gather, multiply and index_add_ over
// the parts in stored order.
//
// Kernels:
//   csr_dot_kernel     out (M, N) = A (M x K, CSR) . B (K, N), N <= 4
//   csr_dot_wide_kernel  the same at N > 4
//   the transposition (launch_transpose): csr_transpose_kernel,
//                      then a stable LSD radix sort of the column ids
//                      (radix_hist_kernel, radix_prefix_kernel,
//                      radix_scatter_kernel a pass): A's entries by
//                      column, rows in order within a column
//   csr_t_dot_kernel + csr_t_dot_combine_kernel
//                      out (K, N) = A^T . G (M, N), every row of out;
//                      mx_csr_t_dot launches the transposition and these
//                      in one call
//
// Bound: bytes.  Each product reads the parts, the rows of the dense
// operand that the entries name (N values each, a gather) and writes the
// output; the arithmetic is 2 N operations an entry.  csr_dot's time is
// not bytes but round trips: each entry is an index load and then a
// dependent gather of B.  So at N <= 4 (the linear classifier's 2, the
// FM's 1) a group of 16 lanes takes a row and a lane an entry: every
// index, value and gathered element of the row is requested at once (one
// launch plus two dependent round trips for a row of at most 16 entries,
// 2 rows a warp), and the products are then added in stored order across
// the lanes by shuffles.  A longer row goes in chunks of 16, in order,
// with the carry.  At N > 4 (the FM's dot(x, v) at 8) a group of G lanes
// (the power of two at or above N, at most 32) takes a row, lane l owning
// columns l, l + G, ..., and loads the row's entries 8 at a time (indices
// and values, then their elements of B), so 8 gathers are in flight a
// lane.  csr_t_dot: the columns are skewed (the path's data draws ids from
// a Zipf law, so a few columns hold an entry in nearly every row), so no
// thread owns a column: a warp
// takes a tile of 32 consecutive sorted entries, a lane an entry, and sums
// each run of equal columns within the tile; a run that crosses tiles
// leaves one partial sum a tile, and csr_t_dot_combine_kernel adds those
// in tile order, a warp a run and output column (128 tiles' partials
// loaded a round), so a column of 8,192 entries is 256 partial sums, not
// 8,192 loads in series.  The output is zeroed first (cudaMemsetAsync),
// then each column that holds entries is written once.
//
// nnz on the card: a CSR may sit in buffers of a fixed capacity (a
// captured step's static input), its values past nnz zero.  Every kernel
// reads the row pointers on the card, and nnz as indptr[M]; grids,
// workspace and scratch are sized by M and the capacity, and a block, a
// tile or a sort slot past nnz does nothing, so the slots past nnz never
// enter the sort, a tile or a run, and one launch serves any nnz up to the
// capacity (a CUDA graph replays it).
//
// Determinism: each output is summed in a fixed order from 0, each product
// rounded and then added (__fmul_rn/__fadd_rn and the double forms, which
// nvcc never contracts into a fused multiply-add).  csr_dot adds in the
// entries' stored order, the plain version's roundings in its order on the
// CPU.  csr_t_dot adds a column's entries in row order within a tile, then
// the tiles' partial sums in tile order: the stored order itself for a
// column whose entries lie in one tile.  The same bits on every call.  The
// sort: a block takes 2048 consecutive entries in 8 chunks of 256;
// radix_hist_kernel counts its digits (up to 10 bits, so 1,000,001 columns
// take two passes; the lanes of a warp that share a digit count it once),
// radix_prefix_kernel (a lane a digit) sums each digit's counts over the
// earlier blocks, radix_scatter_kernel adds the earlier digits' totals to
// give each (digit, block) its first slot in digit-major order, and
// places each entry there plus the entries of its digit in earlier
// chunks, earlier warps (a count a warp and digit in shared memory) and
// earlier lanes (__match_any_sync), so equal digits keep their order.
// Integer atomics only, on the counts in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // csr_dot / csr_t_dot / transpose blocks
constexpr int kSortThreads = 256;    // the sort blocks
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortChunks = 8;       // 2048 entries a sort block
constexpr int kMaxRadix = 1024;      // digits of up to 10 bits
constexpr int kPrefixItems = 16;     // loads in flight a radix_prefix lane
constexpr int kCombineSteps = 4;     // 32-tile steps a combine round
constexpr int kEntryLanes = 16;      // csr_dot at N <= kEntryMaxN: lanes a row
constexpr int kEntryMaxN = 4;
constexpr int kBatch = 8;            // csr_dot at wider N: gathers in flight
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// Narrow N (up to kEntryMaxN, the linear model's 2 and the FM's 1): a group
// of kEntryLanes lanes a row, a lane an entry of each chunk of kEntryLanes
// entries, so that a row's indices, values and gathered elements of B are
// all requested at once.  Every lane of the group then adds the chunk's
// products in stored order, one __shfl_sync after another, from the carry
// of the chunk before; lane c writes column c.  The loop bounds are the
// warp's longest row (__reduce_max_sync), so every shuffle is warp-uniform.
template <typename T, int N>
__global__ void csr_dot_kernel(const int64_t* __restrict__ indptr,
                                     const int64_t* __restrict__ indices,
                                     const T* __restrict__ values,
                                     const T* __restrict__ b,
                                     T* __restrict__ out, int m) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t / kEntryLanes;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (kEntryLanes - 1);
  const int base = lane & ~(kEntryLanes - 1);
  int64_t lo = 0, hi = 0;
  if (row < m) {
    lo = indptr[row];
    hi = indptr[row + 1];
  }
  const int len = (int)(hi - lo);
  const int longest = __reduce_max_sync(kFull, (unsigned)len);
  T acc[N];
#pragma unroll
  for (int c = 0; c < N; ++c) acc[c] = T(0);
  for (int start = 0; start < longest; start += kEntryLanes) {
    T p[N];
    if (start + sub < len) {
      const int64_t e = lo + start + sub;
      const int64_t col = indices[e];
      const T v = values[e];
#pragma unroll
      for (int c = 0; c < N; ++c) p[c] = mul_rn(v, b[col * N + c]);
    } else {
#pragma unroll
      for (int c = 0; c < N; ++c) p[c] = T(0);
    }
    const int count = min(kEntryLanes, longest - start);   // warp-uniform
    const int mine = len - start;                          // the group's
#pragma unroll 1
    for (int l = 0; l < count; ++l) {
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const T x = __shfl_sync(kFull, p[c], base + l);
        if (l < mine) acc[c] = add_rn(acc[c], x);
      }
    }
  }
  T mine_out = acc[0];
#pragma unroll
  for (int c = 1; c < N; ++c)
    if (sub == c) mine_out = acc[c];
  if (row < m && sub < N) out[row * (int64_t)N + sub] = mine_out;
}

// Wider N: a group of G lanes a row (the power of two at or above N, at
// most 32), lane l owning output columns l, l + G, ...; each lane takes
// the row's entries kBatch at a time, their indices and values first and
// then their elements of B, so kBatch gathers of B are in flight a lane,
// and adds the batch's products in stored order.
template <typename T>
__global__ void csr_dot_wide_kernel(const int64_t* __restrict__ indptr,
                                      const int64_t* __restrict__ indices,
                                      const T* __restrict__ values,
                                      const T* __restrict__ b,
                                      T* __restrict__ out, int m, int n,
                                      int group_log2) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t >> group_log2;
  const int lane = (int)(t & ((1 << group_log2) - 1));
  if (row >= m) return;
  const int64_t lo = indptr[row], hi = indptr[row + 1];
  for (int c = lane; c < n; c += 1 << group_log2) {
    T acc = T(0);
    for (int64_t e0 = lo; e0 < hi; e0 += kBatch) {
      int64_t col[kBatch];
      T v[kBatch], x[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const bool in = e0 + k < hi;
        col[k] = in ? indices[e0 + k] : 0;
        v[k] = in ? values[e0 + k] : T(0);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        x[k] = e0 + k < hi ? b[col[k] * n + c] : T(0);
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (e0 + k < hi) acc = add_rn(acc, mul_rn(v[k], x[k]));
    }
    out[row * (int64_t)n + c] = acc;
  }
}

// A warp a tile of 32 sorted entries (keys: their columns; perm: their
// places in the CSR; rows: the row of each CSR entry), a lane an entry.
// Each lane that ends a run of equal columns in the tile sums the run's
// products in row order from 0 and writes the sum: to out where the run
// lies in this tile; to head[t] where it began in an earlier tile; to
// tail[t] where it begins here and goes on into the next tile.
template <typename T>
__global__ void csr_t_dot_kernel(const int* __restrict__ keys,
                                 const int* __restrict__ perm,
                                 const int* __restrict__ rows,
                                 const T* __restrict__ values,
                                 const T* __restrict__ g, T* __restrict__ out,
                                 T* __restrict__ head, T* __restrict__ tail,
                                 int n, const int64_t* __restrict__ nnz_at) {
  const int t = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x)
                      >> 5);
  const int lane = threadIdx.x & 31;
  const int nnz = (int)*nnz_at;
  if (t * 32 >= nnz) return;               // warp-uniform
  const int j = t * 32 + lane;
  const bool valid = j < nnz;              // lane 0 always is
  const int key = valid ? keys[j] : -1;
  int prev = __shfl_up_sync(kFull, key, 1);
  if (lane == 0) prev = j > 0 ? keys[j - 1] : -1;
  int next = __shfl_down_sync(kFull, key, 1);
  if (lane == 31) next = j + 1 < nnz ? keys[j + 1] : -1;
  const unsigned starts = __ballot_sync(kFull, lane == 0 || key != prev);
  const int first = 31 - __clz(starts & (kFull >> (31 - lane)));
  const int lane0_from_prev = __shfl_sync(kFull, (int)(key == prev), 0);
  const bool from_prev = first == 0 && lane0_from_prev;
  const bool ends = valid && (lane == 31 || key != next);
  T v = T(0);
  int r = 0;
  if (valid) {
    const int e = perm[j];
    r = rows[e];
    v = values[e];
  }
  for (int c = 0; c < n; ++c) {
    const T p = valid ? mul_rn(v, g[(int64_t)r * n + c]) : T(0);
    T acc = T(0);
    for (int l = 0; l < 32; ++l) {
      const T x = __shfl_sync(kFull, p, l);
      if (l >= first && l <= lane) acc = add_rn(acc, x);
    }
    if (ends) {
      if (from_prev)
        head[(int64_t)t * n + c] = acc;
      else if (key == next)
        tail[(int64_t)t * n + c] = acc;
      else
        out[(int64_t)key * n + c] = acc;
    }
  }
}

// A warp a (tile, output column) where the tile's last run begins and
// goes on: that run's sum is its tail partial plus the head partials of
// the tiles it reaches, added in tile order; 128 tiles' partials loaded a
// round, so a run of 256 tiles waits on two rounds of loads.
template <typename T>
__global__ void csr_t_dot_combine_kernel(const int* __restrict__ keys,
                                         const T* __restrict__ head,
                                         const T* __restrict__ tail,
                                         T* __restrict__ out, int n,
                                         const int64_t* __restrict__ nnz_at) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
                      >> 5;
  const int lane = threadIdx.x & 31;
  const int tiles = (int)((*nnz_at + 31) / 32);
  if (w >= (long long)(tiles - 1) * n) return;   // the last tile: no next
  const int t = (int)(w / n), c = (int)(w % n);
  const int key = keys[t * 32 + 31];       // a tile before the last is full
  if (keys[t * 32 + 32] != key) return;    // the run ends in this tile
  if (t > 0 && keys[t * 32 - 1] == key) return;   // it began before
  T total = tail[(int64_t)t * n + c];
  for (int u0 = t + 1; u0 < tiles; u0 += 32 * kCombineSteps) {
    // the tiles of the run among the next 32 x kCombineSteps (the keys are
    // sorted, so they come first) and their partials; a load past the last
    // tile reads the last one's, which no count takes
    int count[kCombineSteps];
    T part[kCombineSteps];
#pragma unroll
    for (int q = 0; q < kCombineSteps; ++q) {
      const int u = u0 + 32 * q + lane, uc = min(u, tiles - 1);
      count[q] = __popc(__ballot_sync(kFull,
                                      u < tiles && keys[uc * 32] == key));
      part[q] = head[(int64_t)uc * n + c];
    }
#pragma unroll
    for (int q = 0; q < kCombineSteps; ++q)
      for (int l = 0; l < count[q]; ++l)    // warp-uniform bound
        total = add_rn(total, __shfl_sync(kFull, part[q], l));
    if (count[kCombineSteps - 1] < 32) break;
  }
  if (lane == 0) out[(int64_t)key * n + c] = total;
}

// a warp a row: each entry's row, its column as the sort key and its own
// index as the sort's payload
__global__ void csr_transpose_kernel(const int64_t* __restrict__ indptr,
                                     const int64_t* __restrict__ indices,
                                     int m, int* __restrict__ rows,
                                     int* __restrict__ keys,
                                     int* __restrict__ perm) {
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x)
                      >> 5;
  if (r >= m) return;
  const int64_t hi = indptr[r + 1];
  for (int64_t e = indptr[r] + (threadIdx.x & 31); e < hi; e += 32) {
    rows[e] = (int)r;
    keys[e] = (int)indices[e];
    perm[e] = (int)e;
  }
}

// hist[block * radix + d]: the entries of this block whose digit is d;
// the lanes of a warp that share a digit add once (the path's columns are
// skewed, so one digit may hold most of a block)
__global__ void radix_hist_kernel(const int* __restrict__ keys,
                                  const int64_t* __restrict__ nnz_at,
                                  int shift, int radix,
                                  int* __restrict__ hist) {
  __shared__ int h[kMaxRadix];
  const int lane = threadIdx.x & 31;
  const int n = (int)*nnz_at;
  for (int d = threadIdx.x; d < radix; d += kSortThreads) h[d] = 0;
  __syncthreads();
  const int base = blockIdx.x * kSortThreads * kSortChunks;
  for (int chunk = 0; chunk < kSortChunks; ++chunk) {
    const int i = base + chunk * kSortThreads + threadIdx.x;
    const int digit = i < n ? (keys[i] >> shift) & (radix - 1) : radix;
    const unsigned same = __match_any_sync(kFull, digit);
    if (digit < radix && (same & ((1u << lane) - 1u)) == 0)
      atomicAdd(&h[digit], __popc(same));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += kSortThreads)
    hist[blockIdx.x * radix + d] = h[d];
}

// a lane a digit, a warp (block) 32 digits: hist[b * radix + d] becomes
// the entries of digit d in blocks before b (16 loads in flight, coalesced
// across the digits), and totals[d] those of every block
__global__ void radix_prefix_kernel(int* __restrict__ hist,
                                    int* __restrict__ totals, int radix,
                                    int blocks) {
  const int d = blockIdx.x * 32 + threadIdx.x;
  if (d >= radix) return;
  int run = 0;
  for (int b = 0; b < blocks; b += kPrefixItems) {
    int v[kPrefixItems];
#pragma unroll
    for (int k = 0; k < kPrefixItems; ++k)
      v[k] = b + k < blocks ? hist[(b + k) * radix + d] : 0;
#pragma unroll
    for (int k = 0; k < kPrefixItems; ++k)
      if (b + k < blocks) {
        hist[(b + k) * radix + d] = run;
        run += v[k];
      }
  }
  totals[d] = run;
}

// each entry to base[d] + offsets[block * radix + d] plus the entries of
// digit d
// before it in this block: in earlier chunks (running), earlier warps of
// its chunk (warp_count) and earlier lanes of its warp (the match mask).
// base[d], the entries of the digits before d, is each block's own scan of
// the digits' totals (up to 4 a thread, then warp shuffles).  After a
// chunk the first lane of each (warp, digit) adds its count to running (an
// integer sum, the same in any order) and clears its slot.
__global__ void radix_scatter_kernel(const int* __restrict__ keys_in,
                                     const int* __restrict__ vals_in,
                                     int* __restrict__ keys_out,
                                     int* __restrict__ vals_out,
                                     const int64_t* __restrict__ nnz_at,
                                     int shift, int radix,
                                     const int* __restrict__ offsets,
                                     const int* __restrict__ totals) {
  __shared__ int running[kMaxRadix];
  __shared__ int warp_count[kSortWarps][kMaxRadix];
  __shared__ int warp_sums[kSortWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = (int)*nnz_at;
  const int base = blockIdx.x * kSortThreads * kSortChunks;
  if (base >= n) return;                   // a block past nnz: block-uniform
  // base: thread tid's digits are [tid * per, tid * per + per)
  const int per = (radix + kSortThreads - 1) / kSortThreads;
  int own = 0;
  for (int k = 0; k < per; ++k) {
    const int d = tid * per + k;
    own += d < radix ? totals[d] : 0;
  }
  int incl = own;                          // inclusive within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += x;
  }
  if (lane == 31) warp_sums[warp] = incl;
  for (int d = tid; d < radix; d += kSortThreads)
    for (int w = 0; w < kSortWarps; ++w) warp_count[w][d] = 0;
  __syncthreads();
  int run = incl - own;
  for (int w = 0; w < warp; ++w) run += warp_sums[w];
  for (int k = 0; k < per; ++k) {
    const int d = tid * per + k;
    if (d < radix) {
      running[d] = run + offsets[blockIdx.x * radix + d];
      run += totals[d];
    }
  }
  int key[kSortChunks], val[kSortChunks];   // key -1: past nnz
#pragma unroll
  for (int chunk = 0; chunk < kSortChunks; ++chunk) {
    const int i = base + chunk * kSortThreads + tid;
    key[chunk] = i < n ? keys_in[i] : -1;
    val[chunk] = i < n ? vals_in[i] : 0;
  }
  __syncthreads();
  for (int chunk = 0; chunk < kSortChunks; ++chunk) {
    const bool valid = key[chunk] >= 0;
    const int digit = valid ? (key[chunk] >> shift) & (radix - 1) : radix;
    const unsigned same = __match_any_sync(kFull, digit);
    const int rank = __popc(same & ((1u << lane) - 1u));
    const bool leader = valid && rank == 0;
    if (leader) warp_count[warp][digit] = __popc(same);
    __syncthreads();
    if (valid) {
      int pos = running[digit] + rank;
      for (int w = 0; w < warp; ++w) pos += warp_count[w][digit];
      keys_out[pos] = key[chunk];
      vals_out[pos] = val[chunk];
    }
    __syncthreads();
    if (leader) {
      atomicAdd(&running[digit], __popc(same));
      warp_count[warp][digit] = 0;
    }
    __syncthreads();
  }
}

inline unsigned grid_for(long long threads, int block) {
  return (unsigned)((threads + block - 1) / block);
}

}  // namespace

template <typename T, int N>
static void launch_dot_narrow(const int64_t* indptr, const int64_t* indices,
                              const T* values, const T* b, T* out, int m,
                              cudaStream_t s) {
  csr_dot_kernel<T, N><<<grid_for((long long)m * kEntryLanes, kThreads),
                         kThreads, 0, s>>>(indptr, indices, values, b, out,
                                           m);
}

template <typename T>
static void launch_dot(const int64_t* indptr, const int64_t* indices,
                       const T* values, const T* b, T* out, int m, int n,
                       cudaStream_t s) {
  switch (n) {
    case 1: launch_dot_narrow<T, 1>(indptr, indices, values, b, out, m, s);
      return;
    case 2: launch_dot_narrow<T, 2>(indptr, indices, values, b, out, m, s);
      return;
    case 3: launch_dot_narrow<T, 3>(indptr, indices, values, b, out, m, s);
      return;
    case 4: launch_dot_narrow<T, 4>(indptr, indices, values, b, out, m, s);
      return;
  }
  int group_log2 = 0;
  while ((1 << group_log2) < n && group_log2 < 5) ++group_log2;
  csr_dot_wide_kernel<T><<<grid_for((long long)m << group_log2, kThreads),
                           kThreads, 0, s>>>(indptr, indices, values, b, out,
                                             m, n, group_log2);
}

// dtype: 0 float32, 1 float64.  Each returns cudaGetLastError() after its
// launches.  The grids are sized by m and the capacity, never by nnz, which
// every kernel reads from indptr[m] on the card.
extern "C" int mx_csr_dot(const void* indptr, const void* indices,
                          const void* values, const void* b, void* out, int m,
                          int n, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    launch_dot<float>((const int64_t*)indptr, (const int64_t*)indices,
                      (const float*)values, (const float*)b, (float*)out, m,
                      n, s);
  else
    launch_dot<double>((const int64_t*)indptr, (const int64_t*)indices,
                       (const double*)values, (const double*)b, (double*)out,
                       m, n, s);
  return (int)cudaGetLastError();
}

// The transposition into ws (int32): rows, then two (keys, perm) pairs,
// then the histograms (blocks x radix), then the digits' totals (radix),
// each pair and the row words cap long; the sorted pair is the first after
// an even number of passes, the second after an odd one.  m and cap are
// positive; the slots past nnz (indptr[m]) enter no pass.
static void launch_transpose(const int64_t* indptr, const int64_t* indices,
                             int m, int cap, int* ws, int passes,
                             int digit_bits, cudaStream_t s) {
  int* rows = ws;
  int* keys[2] = {rows + cap, rows + 3 * (size_t)cap};
  int* perm[2] = {rows + 2 * (size_t)cap, rows + 4 * (size_t)cap};
  int* hist = rows + 5 * (size_t)cap;
  const int64_t* nnz_at = indptr + m;
  const int radix = 1 << digit_bits;
  const int blocks = (cap + kSortThreads * kSortChunks - 1)
                     / (kSortThreads * kSortChunks);
  int* totals = hist + (size_t)blocks * radix;
  csr_transpose_kernel<<<grid_for((long long)m * 32, kThreads), kThreads, 0,
                         s>>>(indptr, indices, m, rows, keys[0], perm[0]);
  for (int p = 0; p < passes; ++p) {
    const int src = p & 1, dst = src ^ 1, shift = p * digit_bits;
    radix_hist_kernel<<<blocks, kSortThreads, 0, s>>>(keys[src], nnz_at,
                                                      shift, radix, hist);
    radix_prefix_kernel<<<(radix + 31) / 32, 32, 0, s>>>(hist, totals, radix,
                                                         blocks);
    radix_scatter_kernel<<<blocks, kSortThreads, 0, s>>>(
        keys[src], perm[src], keys[dst], perm[dst], nnz_at, shift, radix,
        hist, totals);
  }
}

// out (k, n) zeroed, then (where there is room for entries) the
// transposition into ws, the tiles and the runs that cross them; scratch
// holds the head then the tail partials, (ceil(cap / 32), n) each
template <typename T>
static void launch_t_dot(const int64_t* indptr, const int64_t* indices,
                         const T* values, const T* g, T* out, int* ws,
                         T* scratch, int m, int k, int n, int cap,
                         int passes, int digit_bits, cudaStream_t s) {
  cudaMemsetAsync(out, 0, (size_t)k * n * sizeof(T), s);
  if (m == 0 || cap == 0 || n == 0) return;
  launch_transpose(indptr, indices, m, cap, ws, passes, digit_bits, s);
  const int pair = 1 + 2 * (passes & 1);
  const int* rows = ws;
  const int* keys = ws + pair * (size_t)cap;
  const int* perm = ws + (pair + 1) * (size_t)cap;
  const int tiles = (cap + 31) / 32;
  T* head = scratch;
  T* tail = scratch + (size_t)tiles * n;
  const int64_t* nnz_at = indptr + m;
  csr_t_dot_kernel<T><<<grid_for((long long)tiles * 32, kThreads), kThreads,
                        0, s>>>(keys, perm, rows, values, g, out, head, tail,
                                n, nnz_at);
  if (tiles > 1)
    csr_t_dot_combine_kernel<T>
        <<<grid_for((long long)(tiles - 1) * n * 32, kThreads), kThreads, 0,
           s>>>(keys, head, tail, out, n, nnz_at);
}

extern "C" int mx_csr_t_dot(const void* indptr, const void* indices,
                            const void* values, const void* g, void* out,
                            void* ws, void* scratch, int m, int k, int n,
                            int cap, int passes, int digit_bits, int dtype,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    launch_t_dot<float>((const int64_t*)indptr, (const int64_t*)indices,
                        (const float*)values, (const float*)g, (float*)out,
                        (int*)ws, (float*)scratch, m, k, n, cap, passes,
                        digit_bits, s);
  else
    launch_t_dot<double>((const int64_t*)indptr, (const int64_t*)indices,
                         (const double*)values, (const double*)g,
                         (double*)out, (int*)ws, (double*)scratch, m, k, n,
                         cap, passes, digit_bits, s);
  return (int)cudaGetLastError();
}

// the transposition alone (launch_transpose), for its check
extern "C" int mx_csr_transpose(const void* indptr, const void* indices,
                                int m, int cap, void* ws, int passes,
                                int digit_bits, void* stream) {
  launch_transpose((const int64_t*)indptr, (const int64_t*)indices, m, cap,
                   (int*)ws, passes, digit_bits, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
