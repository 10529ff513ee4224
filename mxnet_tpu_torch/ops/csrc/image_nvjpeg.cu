// Image-record loader that decodes on the card: the nvJPEG counterpart of
// the host loader in _native/csrc/image_loader.cc, for machines whose host
// has no libjpeg.  Same record index, shuffle, mirror draws, prefetch and
// decode-failure contract; what differs is where a batch is made:
//
//   host threads: pread each record of a round, parse the IRHeader, and
//     hand the JPEG bytes to nvjpegDecode (its Huffman stage runs on that
//     thread, the rest on the thread's stream) into the RGB buffer of the
//     record's slot on the card; an event marks each decode's end;
//   resize_round (below), one launch a round over every image the round
//     decoded: bilinear resize to the batch geometry with the optional
//     mirror, divided by 255, less the per-channel mean and times the scale
//     where the iterator has them, written as float32 CHW into the batch on
//     the card, with image_loader.cc's arithmetic and numpy's mean and
//     scale operation by operation (no fused multiply-add), so that from
//     the same RGB pixels both give the same bits.  Records that failed to
//     decode leave no hole: a table maps the k-th decoded record of a round
//     to the batch's next free slot, and at the end of the data the last
//     round's launch writes the tail slots as blank images (pixel 0, so
//     the host loader's zeros less the mean, times the scale);
//
// then the ready batch goes from the card straight into the caller's
// pinned buffer, one copy.  Two device batches alternate, so the prefetch
// never writes the batch being copied.
//
// Replaces no Pallas kernel: the host C++ resize_to_chw of the JAX
// package's loader (native/image_loader.cc:86).  Bound: a round reads each
// source once and writes each output once (at 256 x 341 -> 3 x 224 x 224,
// 261,888 + 602,112 bytes an image: 8.3 us for 32 images at 3.35 TB/s).  A
// launch of one 224 x 224 image is about a wave of blocks on 132 SMs, most
// of it launch and tail, which is why a round is one launch: blockIdx.y
// picks the image, each thread writes 2 consecutive pixels of one row in
// every channel (an 8-byte store a channel where the row width is even),
// the row's weights computed once a thread and the image's scale factors
// once an image (on the host).  What holds it on the card is the gather of
// the sources' bytes (4 byte loads a pixel and channel) and the latency
// behind it: so blocks of 128 threads held to 40 registers (12 blocks an
// SM), and the division by 255 as one multiply and a correction (div255).
//
// C ABI (ctypes, mxnet_tpu_torch/ops/image_nvjpeg.py):
//   mx_nvjpeg_create(rec, batch, h, w, c, threads, shuffle, seed, mirror,
//                    mean (c floats or null), scale, has_scale, device,
//                    err, err_len) -> handle or null (err says why)
//   mx_nvjpeg_num_samples(h), mx_nvjpeg_next(h, float* data, float* labels)
//     -> n valid (0 = epoch end, -1 = a CUDA or nvJPEG fault: mx_nvjpeg_error)
//   mx_nvjpeg_last_failed(h), mx_nvjpeg_failures(h), mx_nvjpeg_launches(h),
//   mx_nvjpeg_rounds(h) (both as of the last next: the batches it waited
//   for), mx_nvjpeg_reset(h), mx_nvjpeg_destroy(h), mx_nvjpeg_error(h)
//   mx_resize_rgb_chw(table, n, out, dw, dh, c, mean, scale, has_scale,
//                     stream) -> cudaError_t of one launch of resize_round
//     over n rows of a descriptor table already on the card
//   mx_div255_mismatches(lo, hi, count, stream) -> cudaError_t: adds to
//     *count the floats with bits in [lo, hi] where div255 is not
//     __fdiv_rn(x, 255)
//
// One image (image.imdecode, recordio.decode_image on a card): nvJPEG's
// library handle is made once a device and shared with the loaders (it is
// thread-safe); each calling thread holds a decoder of its own, with its
// nvJPEG state, stream and output buffer on the card.
//   mx_nvjpeg_decoder_create(device, err, err_len) -> decoder or null
//   mx_nvjpeg_image_info(dec, jpg, len, flag, &w, &h, &c) -> 0, or 1 when
//     nvJPEG refuses the bytes (flag 1: 3 channels RGB, 0: 1 channel
//     grey, -1: as stored, 1 or 3)
//   mx_nvjpeg_decode_image(dec, jpg, len, flag, out) -> 0 with out (h x w
//     x c uint8, host) written by one copy from the card, 1 refused, -1 a
//     CUDA or nvJPEG fault (mx_nvjpeg_decoder_error)
//   mx_nvjpeg_decoder_error(dec), mx_nvjpeg_decoder_destroy(dec)
#include <cuda_runtime.h>
#include <fcntl.h>
#include <nvjpeg.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <future>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xced7230a;
constexpr int kThreads = 128;
constexpr int kBlocksPerSM = 12;     // 40 registers a thread at most
constexpr int kPix = 2;              // output pixels of one row a thread
constexpr int kMaxRound = 65535;     // images a launch (gridDim.y)
constexpr size_t kSlotSlack = 1 << 20;

// One image of a round: ops/image_nvjpeg.py's DESC has the same layout.
struct Desc {
  const unsigned char* src;   // interleaved RGB on the card; null: blank
  float sx, sy;               // sw / dw and sh / dh, rounded to fp32 once
  int sw, sh;
  int flip;
  int slot;                   // the image of `out` it writes
};
static_assert(sizeof(Desc) == 32, "Desc must match DESC in image_nvjpeg.py");

// x / 255 rounded to nearest, the bits of __fdiv_rn(x, 255.0f), in a
// multiply and one correction (Markstein's: q = x * RN(1/255), then q
// plus the exact remainder x - 255 q times RN(1/255)) instead of the
// full division and its range checks.  div255_check compares the two on
// every float in [0, 256], which holds every value the kernel divides
// (a bilinear blend of bytes, at most 255 plus a few roundings).
__device__ __forceinline__ float div255(float x) {
  const float r = 1.0f / 255.0f;
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, 255.0f, x), r, q);
}

__global__ void div255_check(uint32_t lo, uint32_t hi,
                             unsigned long long* mismatches) {
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t b = lo + blockIdx.x * static_cast<uint64_t>(blockDim.x)
       + threadIdx.x; b <= hi; b += stride) {
    const float x = __uint_as_float(static_cast<uint32_t>(b));
    if (__float_as_uint(div255(x)) != __float_as_uint(__fdiv_rn(x, 255.0f)))
      atomicAdd(mismatches, 1ull);
  }
}

// The expressions follow image_loader.cc's resize_to_chw, each rounding
// made explicit, then native_iter.py's `x -= mean; x *= scale`.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
resize_round(const Desc* __restrict__ table, float* __restrict__ out,
             int dw, int dh, int channels, const float* __restrict__ mean,
             float scale, int has_scale, int vec) {
  const Desc d = table[blockIdx.y];
  const int groups = (dw + kPix - 1) / kPix;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= groups * dh) return;
  const int y = g / groups;
  const int x_first = (g - y * groups) * kPix;
  const int n = min(kPix, dw - x_first);
  float fy = __fadd_rn(__fmul_rn(__fadd_rn(static_cast<float>(y), 0.5f),
                                 d.sy), -0.5f);
  int y0 = fy < 0 ? 0 : static_cast<int>(fy);
  if (y0 > d.sh - 1) y0 = d.sh - 1;
  const int y1 = y0 + 1 > d.sh - 1 ? d.sh - 1 : y0 + 1;
  float wy = __fsub_rn(fy, static_cast<float>(y0));
  if (wy < 0) wy = 0;
  const float uy = __fsub_rn(1.0f, wy);
  int x0[kPix], x1[kPix];
  float wx[kPix], ux[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int x = x_first + (j < n ? j : 0);
    const int xe = d.flip ? (dw - 1 - x) : x;
    float fx = __fadd_rn(__fmul_rn(__fadd_rn(static_cast<float>(xe), 0.5f),
                                   d.sx), -0.5f);
    int a = fx < 0 ? 0 : static_cast<int>(fx);
    if (a > d.sw - 1) a = d.sw - 1;
    x0[j] = a * 3;
    x1[j] = (a + 1 > d.sw - 1 ? d.sw - 1 : a + 1) * 3;
    float w = __fsub_rn(fx, static_cast<float>(a));
    wx[j] = w < 0 ? 0 : w;
    ux[j] = __fsub_rn(1.0f, wx[j]);
  }
  const unsigned char* row0 = d.src + static_cast<size_t>(y0) * d.sw * 3;
  const unsigned char* row1 = d.src + static_cast<size_t>(y1) * d.sw * 3;
  const size_t plane = static_cast<size_t>(dh) * dw;
  float* dst = out + static_cast<size_t>(d.slot) * channels * plane
      + static_cast<size_t>(y) * dw + x_first;
  for (int ch = 0; ch < channels; ++ch, dst += plane) {
    const int c3 = ch < 3 ? ch : 2;
    float v[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      float val = 0.0f;
      if (d.src) {
        const float v00 = __ldg(row0 + x0[j] + c3);
        const float v01 = __ldg(row0 + x1[j] + c3);
        const float v10 = __ldg(row1 + x0[j] + c3);
        const float v11 = __ldg(row1 + x1[j] + c3);
        const float top = __fadd_rn(__fmul_rn(ux[j], v00),
                                    __fmul_rn(wx[j], v01));
        const float bot = __fadd_rn(__fmul_rn(ux[j], v10),
                                    __fmul_rn(wx[j], v11));
        val = __fadd_rn(__fmul_rn(uy, top), __fmul_rn(wy, bot));
      }
      val = div255(val);
      if (mean) val = __fsub_rn(val, mean[ch]);
      if (has_scale) val = __fmul_rn(val, scale);
      v[j] = val;
    }
    if (vec && n == kPix) {
      *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
    } else {
      for (int j = 0; j < n; ++j) dst[j] = v[j];
    }
  }
}

cudaError_t launch_round(const Desc* table, int n, float* out, int dw,
                         int dh, int c, const float* mean, float scale,
                         int has_scale, cudaStream_t stream) {
  if (n <= 0 || n > kMaxRound || dw <= 0 || dh <= 0 || c <= 0)
    return cudaErrorInvalidValue;
  const int groups = (dw + kPix - 1) / kPix;
  const int vec = dw % kPix == 0
      && reinterpret_cast<uintptr_t>(out) % sizeof(float2) == 0;
  dim3 grid((groups * dh + kThreads - 1) / kThreads, n);
  resize_round<<<grid, kThreads, 0, stream>>>(table, out, dw, dh, c, mean,
                                              scale, has_scale, vec);
  return cudaGetLastError();
}

// Sets the calling thread's device for the scope of a C entry point and
// gives the caller's back (PyTorch keeps its own device on that thread).
struct DeviceGuard {
  int prev = -1;
  explicit DeviceGuard(int device) {
    if (cudaGetDevice(&prev) != cudaSuccess) prev = -1;
    cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// nvJPEG's library handle of `device`, made at the first call and kept
// for the process; null with *err set when it cannot be made.
nvjpegHandle_t shared_handle(int device, std::string* err) {
  static std::mutex mu;
  static std::vector<nvjpegHandle_t> handles;
  std::lock_guard<std::mutex> lock(mu);
  if (device < 0) {
    *err = "no such device " + std::to_string(device);
    return nullptr;
  }
  if (handles.size() <= static_cast<size_t>(device))
    handles.resize(device + 1, nullptr);
  if (!handles[device]) {
    nvjpegStatus_t st = nvjpegCreateSimple(&handles[device]);
    if (st != NVJPEG_STATUS_SUCCESS) {
      handles[device] = nullptr;
      *err = "nvjpegCreateSimple failed with status " + std::to_string(st);
    }
  }
  return handles[device];
}

struct Rec {
  int64_t off;
  uint32_t len;
};

struct Batch {
  float* dev = nullptr;          // on the card, batch x plane
  cudaEvent_t ready = nullptr;   // recorded after the fill's last launch
  std::vector<float> labels;
  int n = 0;
  int failed = 0;                // records of THIS batch that failed
};

struct Worker {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  bool decoding = false;         // its stream may still run a decode
};

// The RGB buffer of one slot of a round, on the card.
struct Slot {
  unsigned char* rgb = nullptr;
  size_t cap = 0;
  cudaEvent_t decoded = nullptr;
};

enum Outcome { kOk, kCorrupt, kFault };

struct Loader {
  int fd = -1;
  int device = 0;
  int batch, h, w, c, threads, shuffle, mirror;
  std::vector<float> mean;         // c values, or empty
  float scale = 1.0f;
  int has_scale = 0;
  nvjpegHandle_t handle = nullptr;   // the device's shared handle
  std::vector<Worker> workers;
  std::vector<Slot> slots;         // one a slot of a round
  cudaStream_t stream = nullptr;   // the rounds' launches
  cudaStream_t copy = nullptr;     // the batch's copy to the caller
  cudaEvent_t round_done = nullptr;
  cudaEvent_t staged = nullptr;    // the table's copy out of `staging`
  Desc* staging = nullptr;         // pinned, batch rows
  Desc* table = nullptr;           // on the card, batch rows
  float* mean_dev = nullptr;
  std::atomic<long> failures{0};
  long launches = 0, rounds = 0;   // written by the fill alone
  long seen_launches = 0, seen_rounds = 0;   // as of the last next
  int last_failed = 0;
  std::mutex err_mu;
  std::string error;               // the first CUDA or nvJPEG fault
  std::mt19937 rng;
  std::vector<Rec> recs;
  std::vector<uint32_t> order;
  size_t cursor = 0;
  Batch bufs[2];
  int cur = 0;
  std::future<void> pending;

  ~Loader() {
    if (pending.valid()) pending.wait();
    cudaSetDevice(device);
    if (stream) cudaStreamSynchronize(stream);
    if (copy) cudaStreamSynchronize(copy);
    for (auto& wk : workers) {
      if (wk.stream) cudaStreamSynchronize(wk.stream);
      if (wk.state) nvjpegJpegStateDestroy(wk.state);
      if (wk.stream) cudaStreamDestroy(wk.stream);
    }
    for (auto& s : slots) {
      if (s.rgb) cudaFree(s.rgb);
      if (s.decoded) cudaEventDestroy(s.decoded);
    }
    for (auto& b : bufs) {
      if (b.dev) cudaFree(b.dev);
      if (b.ready) cudaEventDestroy(b.ready);
    }
    for (cudaEvent_t e : {round_done, staged})
      if (e) cudaEventDestroy(e);
    for (cudaStream_t s : {stream, copy})
      if (s) cudaStreamDestroy(s);
    if (staging) cudaFreeHost(staging);
    if (table) cudaFree(table);
    if (mean_dev) cudaFree(mean_dev);
    if (fd >= 0) close(fd);
  }

  void fault(const std::string& what) {
    std::lock_guard<std::mutex> lock(err_mu);
    if (error.empty()) error = what;
  }

  bool faulted() {
    std::lock_guard<std::mutex> lock(err_mu);
    return !error.empty();
  }

  bool cuda_ok(cudaError_t e, const char* what) {
    if (e == cudaSuccess) return true;
    fault(std::string(what) + ": " + cudaGetErrorString(e));
    return false;
  }

  bool event(cudaEvent_t* e) {
    return cuda_ok(cudaEventCreateWithFlags(e, cudaEventDisableTiming),
                   "cudaEventCreate");
  }

  bool new_stream(cudaStream_t* s) {
    // the legacy default stream would wait for the caller's work there
    return cuda_ok(cudaStreamCreateWithFlags(s, cudaStreamNonBlocking),
                   "cudaStreamCreate");
  }

  // Everything the decode needs on the card; false (with `error`) if not.
  bool init() {
    if (batch > kMaxRound) {
      fault("batch_size " + std::to_string(batch) + " is above " +
            std::to_string(kMaxRound) + " images a launch");
      return false;
    }
    if (!cuda_ok(cudaSetDevice(device), "cudaSetDevice")) return false;
    std::string why;
    handle = shared_handle(device, &why);
    if (!handle) {
      fault(why);
      return false;
    }
    workers.resize(std::max(1, threads));
    for (auto& wk : workers) {
      nvjpegStatus_t st = nvjpegJpegStateCreate(handle, &wk.state);
      if (st != NVJPEG_STATUS_SUCCESS) {
        fault("nvjpegJpegStateCreate failed with status " +
              std::to_string(st));
        return false;
      }
      if (!new_stream(&wk.stream)) return false;
    }
    slots.resize(batch);
    for (auto& s : slots)
      if (!event(&s.decoded)) return false;
    if (!new_stream(&stream) || !new_stream(&copy) || !event(&round_done)
        || !event(&staged))
      return false;
    size_t bytes = static_cast<size_t>(batch) * c * h * w * sizeof(float);
    for (auto& b : bufs) {
      if (!cuda_ok(cudaMalloc(&b.dev, bytes), "cudaMalloc") ||
          !event(&b.ready))
        return false;
    }
    if (!cuda_ok(cudaHostAlloc(&staging, batch * sizeof(Desc),
                               cudaHostAllocDefault), "cudaHostAlloc") ||
        !cuda_ok(cudaMalloc(&table, batch * sizeof(Desc)), "cudaMalloc"))
      return false;
    if (!mean.empty()) {
      if (!cuda_ok(cudaMalloc(&mean_dev, c * sizeof(float)), "cudaMalloc") ||
          !cuda_ok(cudaMemcpy(mean_dev, mean.data(), c * sizeof(float),
                              cudaMemcpyHostToDevice), "cudaMemcpy"))
        return false;
    }
    return true;
  }

  void index_records() {
    FILE* f = fdopen(dup(fd), "rb");
    if (!f) return;
    setvbuf(f, nullptr, _IOFBF, 1 << 20);
    int64_t pos = 0;
    uint32_t head[2];
    while (fread(head, sizeof(uint32_t), 2, f) == 2) {
      if (head[0] != kMagic) break;
      uint32_t len = head[1] & ((1u << 29) - 1);
      recs.push_back({pos + 8, len});
      uint32_t pad = (4 - (len % 4)) % 4;
      pos += 8 + len + pad;
      if (fseek(f, pos, SEEK_SET) != 0) break;
    }
    fclose(f);
    order.resize(recs.size());
    for (uint32_t i = 0; i < order.size(); ++i) order[i] = i;
  }

  // Decode record rec_idx into slot s's buffer on wk's stream; on kOk,
  // *d holds the image's row of the round's table (but flip and slot) and
  // *label its label.
  Outcome decode_one(uint32_t rec_idx, Slot& s, Worker& wk, Desc* d,
                     float* label) {
    const Rec& r = recs[rec_idx];
    std::vector<unsigned char> raw(r.len);
    if (pread(fd, raw.data(), r.len, r.off) != static_cast<ssize_t>(r.len))
      return kCorrupt;
    if (r.len < 24) return kCorrupt;
    uint32_t flag;
    std::memcpy(&flag, raw.data(), 4);
    std::memcpy(label, raw.data() + 4, 4);
    size_t skip = 24 + static_cast<size_t>(flag > 0 ? flag : 0) * 4;
    if (flag > 0 && r.len >= skip)
      std::memcpy(label, raw.data() + 24, 4);   // first extended label
    if (r.len <= skip) return kCorrupt;
    const unsigned char* jpg = raw.data() + skip;
    size_t jlen = r.len - skip;
    int ncomp = 0;
    nvjpegChromaSubsampling_t sub;
    int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
    if (nvjpegGetImageInfo(handle, jpg, jlen, &ncomp, &sub, widths,
                           heights) != NVJPEG_STATUS_SUCCESS)
      return kCorrupt;   // not a JPEG nvJPEG can read
    int sw = widths[0], sh = heights[0];
    if (sw <= 0 || sh <= 0) return kCorrupt;
    // the state's last image must be through before it takes this one:
    // nvJPEG's simple API keeps an image's intermediate buffers in the
    // state while its stream works on them
    if (wk.decoding &&
        !cuda_ok(cudaStreamSynchronize(wk.stream), "nvjpegDecode"))
      return kFault;
    wk.decoding = false;
    size_t need = static_cast<size_t>(sw) * sh * 3;
    if (need > s.cap) {
      // with slack, so that cudaFree, which waits for the whole card, is
      // rare; the last launch must be through with the old buffer
      size_t cap = (need + need / 4 + kSlotSlack - 1) / kSlotSlack
          * kSlotSlack;
      if (s.rgb && (!cuda_ok(cudaEventSynchronize(round_done),
                             "resize_round") ||
                    !cuda_ok(cudaFree(s.rgb), "cudaFree")))
        return kFault;
      s.rgb = nullptr;
      s.cap = 0;
      if (!cuda_ok(cudaMalloc(&s.rgb, cap), "cudaMalloc")) return kFault;
      s.cap = cap;
    }
    nvjpegImage_t img;
    std::memset(&img, 0, sizeof(img));
    img.channel[0] = s.rgb;
    img.pitch[0] = static_cast<size_t>(sw) * 3;
    wk.decoding = true;
    nvjpegStatus_t st = nvjpegDecode(handle, wk.state, jpg, jlen,
                                     NVJPEG_OUTPUT_RGBI, &img, wk.stream);
    if (st == NVJPEG_STATUS_BAD_JPEG || st == NVJPEG_STATUS_JPEG_NOT_SUPPORTED
        || st == NVJPEG_STATUS_INVALID_PARAMETER)
      return kCorrupt;
    if (st != NVJPEG_STATUS_SUCCESS) {
      fault("nvjpegDecode failed with status " + std::to_string(st));
      return kFault;
    }
    if (!cuda_ok(cudaEventRecord(s.decoded, wk.stream), "cudaEventRecord"))
      return kFault;
    d->src = s.rgb;
    d->sw = sw;
    d->sh = sh;
    d->sx = static_cast<float>(sw) / static_cast<float>(w);
    d->sy = static_cast<float>(sh) / static_cast<float>(h);
    return kOk;
  }

  // One batch into *out, in rounds: decode what the order holds next into
  // the slots' buffers, then one launch writes the decoded images to the
  // batch's next free slots (a failed record leaves no hole), and the
  // records that follow top up (out->n is short only at the end of the
  // data, where the last launch also writes the tail as blank images).
  void fill(Batch* out) {
    out->labels.assign(batch, 0.0f);
    out->failed = 0;
    out->n = 0;
    if (faulted() || !cuda_ok(cudaSetDevice(device), "cudaSetDevice"))
      return;
    size_t filled = 0;
    std::bernoulli_distribution coin(0.5);
    while (filled < static_cast<size_t>(batch) && cursor < recs.size()) {
      size_t take = std::min<size_t>(batch - filled, recs.size() - cursor);
      std::vector<uint32_t> picked(order.begin() + cursor,
                                   order.begin() + cursor + take);
      std::vector<char> flips(take, 0);
      if (mirror)
        for (auto& fl : flips) fl = coin(rng) ? 1 : 0;
      cursor += take;
      ++rounds;
      std::vector<char> ok(take, 0);
      std::vector<Desc> rows(take);
      std::vector<float> labels(take, 0.0f);
      std::atomic<size_t> next_slot{0};
      auto work = [&](int wid) {
        Worker& wk = workers[wid];
        if (wid > 0 && !cuda_ok(cudaSetDevice(device), "cudaSetDevice"))
          return;
        // the last launch reads the slots' buffers this round rewrites
        if (!cuda_ok(cudaStreamWaitEvent(wk.stream, round_done, 0),
                     "cudaStreamWaitEvent"))
          return;
        for (;;) {
          size_t s = next_slot.fetch_add(1);
          if (s >= take || faulted()) return;
          ok[s] = decode_one(picked[s], slots[s], wk, &rows[s],
                             &labels[s]) == kOk;
        }
      };
      int nthreads = static_cast<int>(workers.size());
      std::vector<std::thread> pool;
      for (int i = 1; i < nthreads; ++i) pool.emplace_back(work, i);
      work(0);
      for (auto& t : pool) t.join();
      if (faulted()) return;
      // the staging rows of the last round must be on the card
      if (!cuda_ok(cudaEventSynchronize(staged), "cudaMemcpyAsync")) return;
      int n_rows = 0;
      for (size_t s = 0; s < take; ++s) {
        if (!ok[s]) continue;
        Desc d = rows[s];
        d.flip = flips[s];
        d.slot = static_cast<int>(filled);
        out->labels[filled++] = labels[s];
        staging[n_rows++] = d;
        if (!cuda_ok(cudaStreamWaitEvent(stream, slots[s].decoded, 0),
                     "cudaStreamWaitEvent"))
          return;
      }
      out->failed += static_cast<int>(take) - n_rows;
      if (cursor == recs.size() && filled > 0)
        for (size_t s = filled; s < static_cast<size_t>(batch); ++s)
          staging[n_rows++] = Desc{nullptr, 1.0f, 1.0f, 1, 1, 0,
                                   static_cast<int>(s)};
      if (n_rows == 0) continue;
      if (!cuda_ok(cudaMemcpyAsync(table, staging, n_rows * sizeof(Desc),
                                   cudaMemcpyHostToDevice, stream),
                   "cudaMemcpyAsync") ||
          !cuda_ok(cudaEventRecord(staged, stream), "cudaEventRecord") ||
          !cuda_ok(launch_round(table, n_rows, out->dev, w, h, c, mean_dev,
                                scale, has_scale, stream),
                   "resize_round launch") ||
          !cuda_ok(cudaEventRecord(round_done, stream), "cudaEventRecord"))
        return;
      ++launches;
    }
    out->n = static_cast<int>(filled);
    failures.fetch_add(out->failed);
    cuda_ok(cudaEventRecord(out->ready, stream), "cudaEventRecord");
  }

  void start_prefetch() {
    Batch* target = &bufs[1 - cur];
    pending = std::async(std::launch::async,
                         [this, target]() { fill(target); });
  }

  void reset() {
    if (pending.valid()) pending.wait();
    cursor = 0;
    if (shuffle) std::shuffle(order.begin(), order.end(), rng);
    cur = 0;
    fill(&bufs[cur]);
    start_prefetch();
  }
};

// One thread's decoder of single images.
struct Decoder {
  int device = 0;
  nvjpegHandle_t handle = nullptr;   // the device's shared handle
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* buf = nullptr;      // the decoded image on the card
  size_t cap = 0;
  std::string error;

  ~Decoder() {
    cudaSetDevice(device);
    if (stream) cudaStreamSynchronize(stream);
    if (buf) cudaFree(buf);
    if (state) nvjpegJpegStateDestroy(state);
    if (stream) cudaStreamDestroy(stream);
  }

  bool cuda_ok(cudaError_t e, const char* what) {
    if (e == cudaSuccess) return true;
    if (error.empty()) error = std::string(what) + ": " +
        cudaGetErrorString(e);
    return false;
  }

  // The output's size and channels, as libjpeg's mx_jpeg_decode gives
  // them: one channel for flag 0, or -1 and a one-component image; else
  // three.  False where nvJPEG cannot read the header or the image has
  // other than 1 or 3 components (libjpeg converts neither to RGB).
  bool info(const unsigned char* jpg, size_t len, int flag, int* w, int* h,
            int* c, int* ncomp) {
    nvjpegChromaSubsampling_t sub;
    int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
    if (nvjpegGetImageInfo(handle, jpg, len, ncomp, &sub, widths,
                           heights) != NVJPEG_STATUS_SUCCESS)
      return false;
    if (*ncomp != 1 && *ncomp != 3) return false;
    *w = widths[0];
    *h = heights[0];
    *c = flag == 0 || (flag < 0 && *ncomp == 1) ? 1 : 3;
    return *w > 0 && *h > 0;
  }

  // 0, 1 (refused) or -1 (fault).  A one-component image decodes as Y
  // and, where three channels are asked, is repeated into them on the
  // host after its one copy, as libjpeg repeats grey into RGB.
  int decode(const unsigned char* jpg, size_t len, int flag,
             unsigned char* out) {
    int w, h, c, ncomp;
    if (!info(jpg, len, flag, &w, &h, &c, &ncomp)) return 1;
    const bool luma = c == 1 || ncomp == 1;
    const size_t pixels = static_cast<size_t>(w) * h;
    const size_t need = pixels * (luma ? 1 : 3);
    if (need > cap) {
      if (!cuda_ok(cudaStreamSynchronize(stream), "cudaStreamSynchronize"))
        return -1;
      if (buf && !cuda_ok(cudaFree(buf), "cudaFree")) return -1;
      buf = nullptr;
      cap = 0;
      size_t grown = (need + need / 4 + kSlotSlack - 1) / kSlotSlack *
          kSlotSlack;
      if (!cuda_ok(cudaMalloc(&buf, grown), "cudaMalloc")) return -1;
      cap = grown;
    }
    nvjpegImage_t img;
    std::memset(&img, 0, sizeof(img));
    img.channel[0] = buf;
    img.pitch[0] = static_cast<size_t>(w) * (luma ? 1 : 3);
    nvjpegStatus_t st = nvjpegDecode(
        handle, state, jpg, len, luma ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI,
        &img, stream);
    if (st == NVJPEG_STATUS_BAD_JPEG || st == NVJPEG_STATUS_JPEG_NOT_SUPPORTED
        || st == NVJPEG_STATUS_INVALID_PARAMETER) {
      cudaStreamSynchronize(stream);
      return 1;
    }
    if (st != NVJPEG_STATUS_SUCCESS) {
      if (error.empty())
        error = "nvjpegDecode failed with status " + std::to_string(st);
      return -1;
    }
    if (!cuda_ok(cudaMemcpyAsync(out, buf, need, cudaMemcpyDeviceToHost,
                                 stream), "cudaMemcpyAsync") ||
        !cuda_ok(cudaStreamSynchronize(stream), "nvjpegDecode"))
      return -1;
    if (luma && c == 3)
      for (size_t i = pixels; i-- > 0;)
        out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = out[i];
    return 0;
  }
};

}  // namespace

extern "C" {

void* mx_nvjpeg_create(const char* rec_path, int batch, int h, int w, int c,
                       int threads, int shuffle, unsigned seed, int mirror,
                       const float* mean, float scale, int has_scale,
                       int device, char* err, int err_len) {
  auto say = [&](const std::string& what) {
    if (err && err_len > 0) {
      std::strncpy(err, what.c_str(), err_len - 1);
      err[err_len - 1] = 0;
    }
  };
  int fd = open(rec_path, O_RDONLY);
  if (fd < 0) {
    say(std::string("cannot open record file ") + rec_path);
    return nullptr;
  }
  DeviceGuard guard(device);
  auto* L = new Loader();
  L->fd = fd;
  L->device = device;
  L->batch = batch;
  L->h = h;
  L->w = w;
  L->c = c;
  L->threads = threads;
  L->shuffle = shuffle;
  L->mirror = mirror;
  if (mean) L->mean.assign(mean, mean + c);
  L->scale = scale;
  L->has_scale = has_scale;
  L->rng.seed(seed);
  L->index_records();
  if (L->recs.empty()) {
    say(std::string("no records in ") + rec_path);
    delete L;
    return nullptr;
  }
  if (!L->init()) {
    say(L->error);
    delete L;
    return nullptr;
  }
  L->reset();
  return L;
}

int64_t mx_nvjpeg_num_samples(void* handle) {
  return static_cast<Loader*>(handle)->recs.size();
}

int mx_nvjpeg_next(void* handle, float* data, float* labels) {
  auto* L = static_cast<Loader*>(handle);
  DeviceGuard guard(L->device);
  L->last_failed = 0;
  for (;;) {
    if (L->faulted()) return -1;
    Batch& b = L->bufs[L->cur];
    L->last_failed += b.failed;
    if (b.n > 0) {
      size_t bytes = static_cast<size_t>(L->batch) * L->c * L->h * L->w *
          sizeof(float);
      if (!L->cuda_ok(cudaStreamWaitEvent(L->copy, b.ready, 0),
                      "cudaStreamWaitEvent") ||
          !L->cuda_ok(cudaMemcpyAsync(data, b.dev, bytes,
                                      cudaMemcpyDeviceToHost, L->copy),
                      "cudaMemcpyAsync") ||
          !L->cuda_ok(cudaStreamSynchronize(L->copy), "cudaMemcpyAsync"))
        return -1;
      std::memcpy(labels, b.labels.data(), b.labels.size() * sizeof(float));
    }
    if (L->pending.valid()) L->pending.wait();
    L->seen_launches = L->launches;
    L->seen_rounds = L->rounds;
    if (b.n == 0 && b.failed == 0) return 0;
    int n = b.n;
    L->cur = 1 - L->cur;
    L->start_prefetch();
    if (n > 0) return n;
  }
}

void mx_nvjpeg_reset(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  DeviceGuard guard(L->device);
  L->reset();
}

long mx_nvjpeg_failures(void* handle) {
  return static_cast<Loader*>(handle)->failures.load();
}

int mx_nvjpeg_last_failed(void* handle) {
  return static_cast<Loader*>(handle)->last_failed;
}

long mx_nvjpeg_launches(void* handle) {
  return static_cast<Loader*>(handle)->seen_launches;
}

long mx_nvjpeg_rounds(void* handle) {
  return static_cast<Loader*>(handle)->seen_rounds;
}

const char* mx_nvjpeg_error(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  std::lock_guard<std::mutex> lock(L->err_mu);
  return L->error.c_str();
}

void mx_nvjpeg_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  DeviceGuard guard(L->device);
  delete L;
}

int mx_resize_rgb_chw(const void* table, int n, float* out, int dw, int dh,
                      int c, const float* mean, float scale, int has_scale,
                      void* stream) {
  return static_cast<int>(launch_round(
      static_cast<const Desc*>(table), n, out, dw, dh, c, mean, scale,
      has_scale, static_cast<cudaStream_t>(stream)));
}

int mx_div255_mismatches(uint32_t lo, uint32_t hi,
                         unsigned long long* mismatches, void* stream) {
  div255_check<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      lo, hi, mismatches);
  return static_cast<int>(cudaGetLastError());
}

void* mx_nvjpeg_decoder_create(int device, char* err, int err_len) {
  auto say = [&](const std::string& what) {
    if (err && err_len > 0) {
      std::strncpy(err, what.c_str(), err_len - 1);
      err[err_len - 1] = 0;
    }
  };
  DeviceGuard guard(device);
  std::string why;
  nvjpegHandle_t handle = shared_handle(device, &why);
  if (!handle) {
    say(why);
    return nullptr;
  }
  auto* D = new Decoder();
  D->device = device;
  D->handle = handle;
  nvjpegStatus_t st = nvjpegJpegStateCreate(handle, &D->state);
  if (st != NVJPEG_STATUS_SUCCESS) {
    say("nvjpegJpegStateCreate failed with status " + std::to_string(st));
    delete D;
    return nullptr;
  }
  if (!D->cuda_ok(cudaStreamCreateWithFlags(&D->stream,
                                            cudaStreamNonBlocking),
                  "cudaStreamCreate")) {
    say(D->error);
    delete D;
    return nullptr;
  }
  return D;
}

int mx_nvjpeg_image_info(void* dec, const unsigned char* jpg, uint64_t len,
                         int flag, int* w, int* h, int* c) {
  auto* D = static_cast<Decoder*>(dec);
  int ncomp;
  return D->info(jpg, len, flag, w, h, c, &ncomp) ? 0 : 1;
}

int mx_nvjpeg_decode_image(void* dec, const unsigned char* jpg, uint64_t len,
                           int flag, unsigned char* out) {
  auto* D = static_cast<Decoder*>(dec);
  DeviceGuard guard(D->device);
  return D->decode(jpg, len, flag, out);
}

const char* mx_nvjpeg_decoder_error(void* dec) {
  return static_cast<Decoder*>(dec)->error.c_str();
}

void mx_nvjpeg_decoder_destroy(void* dec) {
  auto* D = static_cast<Decoder*>(dec);
  DeviceGuard guard(D->device);
  delete D;
}

}  // extern "C"
