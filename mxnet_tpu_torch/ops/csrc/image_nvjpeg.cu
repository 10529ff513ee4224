// Image-record loader that decodes on the card: the nvJPEG counterpart of
// the host loader in _native/csrc/image_loader.cc, for machines whose host
// has no libjpeg.  Same record index, shuffle, mirror draws, prefetch and
// decode-failure contract; what differs is each record's decode:
//
//   host thread: pread the record, parse the IRHeader, and hand the JPEG
//     bytes to nvjpegDecode (its Huffman stage runs on that thread, the
//     rest on the thread's stream) into an interleaved RGB buffer on the
//     card;
//   resize_rgb_chw (below): bilinear resize to the batch geometry with the
//     optional mirror, written as float32 CHW in [0, 1] into the batch's
//     slot on the card, with image_loader.cc's arithmetic operation by
//     operation (no fused multiply-add), so that from the same RGB pixels
//     both give the same bits;
//
// then each round of a batch comes back to pinned host memory (on the
// loader's own streams, so the decode overlaps the caller's work on the
// card), where failed records are compacted out as the host loader does.
// The iterator's contract is a host batch, so the caller copies it to the
// card again.
//
// C ABI (ctypes, mxnet_tpu_torch/image/native_iter.py):
//   mx_nvjpeg_create(rec, batch, h, w, c, threads, shuffle, seed, mirror,
//                    device, err, err_len) -> handle or null (err says why)
//   mx_nvjpeg_num_samples(h), mx_nvjpeg_next(h, float* data, float* labels)
//     -> n valid (0 = epoch end, -1 = a CUDA or nvJPEG fault: mx_nvjpeg_error)
//   mx_nvjpeg_last_failed(h), mx_nvjpeg_failures(h), mx_nvjpeg_launches(h),
//   mx_nvjpeg_reset(h), mx_nvjpeg_destroy(h), mx_nvjpeg_error(h)
//   mx_resize_rgb_chw(src, sw, sh, dst, dw, dh, c, mirror, stream)
//     -> cudaError_t of one launch of the kernel alone
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
constexpr int kThreads = 256;

// One thread an output pixel, every channel.  The expressions follow
// image_loader.cc's resize_to_chw, each rounding made explicit.
__global__ void resize_rgb_chw(const unsigned char* __restrict__ src, int sw,
                               int sh, float* __restrict__ dst, int dw,
                               int dh, int channels, int mirror) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= dw * dh) return;
  int y = i / dw, x = i - (i / dw) * dw;
  const float sx = __fdiv_rn(static_cast<float>(sw), static_cast<float>(dw));
  const float sy = __fdiv_rn(static_cast<float>(sh), static_cast<float>(dh));
  float fy = __fadd_rn(__fmul_rn(__fadd_rn(static_cast<float>(y), 0.5f), sy),
                       -0.5f);
  int y0 = fy < 0 ? 0 : static_cast<int>(fy);
  if (y0 > sh - 1) y0 = sh - 1;
  int y1 = y0 + 1 > sh - 1 ? sh - 1 : y0 + 1;
  float wy = __fsub_rn(fy, static_cast<float>(y0));
  if (wy < 0) wy = 0;
  int xe = mirror ? (dw - 1 - x) : x;
  float fx = __fadd_rn(__fmul_rn(__fadd_rn(static_cast<float>(xe), 0.5f), sx),
                       -0.5f);
  int x0 = fx < 0 ? 0 : static_cast<int>(fx);
  if (x0 > sw - 1) x0 = sw - 1;
  int x1 = x0 + 1 > sw - 1 ? sw - 1 : x0 + 1;
  float wx = __fsub_rn(fx, static_cast<float>(x0));
  if (wx < 0) wx = 0;
  const float ux = __fsub_rn(1.0f, wx), uy = __fsub_rn(1.0f, wy);
  for (int ch = 0; ch < channels; ++ch) {
    int c3 = ch < 3 ? ch : 2;
    float v00 = src[(static_cast<size_t>(y0) * sw + x0) * 3 + c3];
    float v01 = src[(static_cast<size_t>(y0) * sw + x1) * 3 + c3];
    float v10 = src[(static_cast<size_t>(y1) * sw + x0) * 3 + c3];
    float v11 = src[(static_cast<size_t>(y1) * sw + x1) * 3 + c3];
    float top = __fadd_rn(__fmul_rn(ux, v00), __fmul_rn(wx, v01));
    float bot = __fadd_rn(__fmul_rn(ux, v10), __fmul_rn(wx, v11));
    float v = __fadd_rn(__fmul_rn(uy, top), __fmul_rn(wy, bot));
    dst[(static_cast<size_t>(ch) * dh + y) * dw + x] = __fdiv_rn(v, 255.0f);
  }
}

cudaError_t launch_resize(const unsigned char* src, int sw, int sh,
                          float* dst, int dw, int dh, int c, int mirror,
                          cudaStream_t stream) {
  int n = dw * dh;
  resize_rgb_chw<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      src, sw, sh, dst, dw, dh, c, mirror);
  return cudaGetLastError();
}

struct Rec {
  int64_t off;
  uint32_t len;
};

struct Batch {
  float* host = nullptr;   // pinned, batch x plane
  float* dev = nullptr;    // on the card, batch x plane
  std::vector<float> labels;
  int n = 0;
  int failed = 0;          // records of THIS batch that failed to decode
};

struct Worker {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* rgb = nullptr;   // decoded RGB on the card
  size_t cap = 0;
};

enum Outcome { kOk, kCorrupt, kFault };

struct Loader {
  int fd = -1;
  int device = 0;
  int batch, h, w, c, threads, shuffle, mirror;
  nvjpegHandle_t handle = nullptr;
  std::vector<Worker> workers;
  std::atomic<long> failures{0};
  std::atomic<long> launches{0};
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
    for (auto& wk : workers) {
      if (wk.state) nvjpegJpegStateDestroy(wk.state);
      if (wk.stream) cudaStreamDestroy(wk.stream);
      if (wk.rgb) cudaFree(wk.rgb);
    }
    for (auto& b : bufs) {
      if (b.host) cudaFreeHost(b.host);
      if (b.dev) cudaFree(b.dev);
    }
    if (handle) nvjpegDestroy(handle);
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

  // Everything the decode needs on the card; false (with `error`) if not.
  bool init() {
    if (!cuda_ok(cudaSetDevice(device), "cudaSetDevice")) return false;
    nvjpegStatus_t st = nvjpegCreateSimple(&handle);
    if (st != NVJPEG_STATUS_SUCCESS) {
      fault("nvjpegCreateSimple failed with status " + std::to_string(st));
      return false;
    }
    workers.resize(std::max(1, threads));
    for (auto& wk : workers) {
      st = nvjpegJpegStateCreate(handle, &wk.state);
      if (st != NVJPEG_STATUS_SUCCESS) {
        fault("nvjpegJpegStateCreate failed with status " +
              std::to_string(st));
        return false;
      }
      if (!cuda_ok(cudaStreamCreateWithFlags(&wk.stream,
                                             cudaStreamNonBlocking),
                   "cudaStreamCreate"))
        return false;
    }
    size_t bytes = static_cast<size_t>(batch) * c * h * w * sizeof(float);
    for (auto& b : bufs) {
      if (!cuda_ok(cudaHostAlloc(&b.host, bytes, cudaHostAllocDefault),
                   "cudaHostAlloc") ||
          !cuda_ok(cudaMalloc(&b.dev, bytes), "cudaMalloc"))
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

  Outcome decode_one(uint32_t rec_idx, Batch* out, int slot, bool flip,
                     Worker& wk) {
    const Rec& r = recs[rec_idx];
    std::vector<unsigned char> raw(r.len);
    if (pread(fd, raw.data(), r.len, r.off) != static_cast<ssize_t>(r.len))
      return kCorrupt;
    if (r.len < 24) return kCorrupt;
    uint32_t flag;
    float label;
    std::memcpy(&flag, raw.data(), 4);
    std::memcpy(&label, raw.data() + 4, 4);
    size_t skip = 24 + static_cast<size_t>(flag > 0 ? flag : 0) * 4;
    if (flag > 0 && r.len >= skip)
      std::memcpy(&label, raw.data() + 24, 4);   // first extended label
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
    size_t need = static_cast<size_t>(sw) * sh * 3;
    if (need > wk.cap) {
      if (wk.rgb) cudaFree(wk.rgb);
      wk.rgb = nullptr;
      wk.cap = 0;
      if (!cuda_ok(cudaMalloc(&wk.rgb, need), "cudaMalloc")) return kFault;
      wk.cap = need;
    }
    nvjpegImage_t img;
    std::memset(&img, 0, sizeof(img));
    img.channel[0] = wk.rgb;
    img.pitch[0] = static_cast<size_t>(sw) * 3;
    nvjpegStatus_t st = nvjpegDecode(handle, wk.state, jpg, jlen,
                                     NVJPEG_OUTPUT_RGBI, &img, wk.stream);
    if (st == NVJPEG_STATUS_BAD_JPEG || st == NVJPEG_STATUS_JPEG_NOT_SUPPORTED
        || st == NVJPEG_STATUS_INVALID_PARAMETER) {
      cudaStreamSynchronize(wk.stream);
      return kCorrupt;
    }
    if (st != NVJPEG_STATUS_SUCCESS) {
      fault("nvjpegDecode failed with status " + std::to_string(st));
      return kFault;
    }
    float* dst = out->dev + static_cast<size_t>(slot) * c * h * w;
    if (!cuda_ok(launch_resize(wk.rgb, sw, sh, dst, w, h, c, flip ? 1 : 0,
                               wk.stream), "resize_rgb_chw launch"))
      return kFault;
    launches.fetch_add(1);
    if (!cuda_ok(cudaStreamSynchronize(wk.stream), "resize_rgb_chw"))
      return kFault;
    out->labels[slot] = label;
    return kOk;
  }

  // One batch into *out, in rounds: decode what the order holds next, bring
  // the round back to the host, compact its failures out, and top up from
  // the records that follow (out->n is short only at the end of the data).
  void fill(Batch* out) {
    size_t plane = static_cast<size_t>(c) * h * w;
    std::memset(out->host, 0, static_cast<size_t>(batch) * plane *
                sizeof(float));
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
      std::vector<char> ok(take, 0);
      std::atomic<size_t> next_slot{0};
      auto work = [&](int wid) {
        if (wid > 0 && !cuda_ok(cudaSetDevice(device), "cudaSetDevice"))
          return;
        for (;;) {
          size_t slot = next_slot.fetch_add(1);
          if (slot >= take || faulted()) return;
          ok[slot] = decode_one(picked[slot], out,
                                static_cast<int>(filled + slot),
                                flips[slot] != 0, workers[wid]) == kOk;
        }
      };
      int nthreads = static_cast<int>(workers.size());
      std::vector<std::thread> pool;
      for (int i = 1; i < nthreads; ++i) pool.emplace_back(work, i);
      work(0);
      for (auto& t : pool) t.join();
      if (faulted()) return;
      // on a stream of the loader's own: the legacy default stream would
      // wait for the training step the caller has queued there
      cudaStream_t copy = workers[0].stream;
      if (!cuda_ok(cudaMemcpyAsync(out->host + filled * plane,
                                   out->dev + filled * plane,
                                   take * plane * sizeof(float),
                                   cudaMemcpyDeviceToHost, copy),
                   "cudaMemcpyAsync") ||
          !cuda_ok(cudaStreamSynchronize(copy), "cudaMemcpyAsync"))
        return;
      size_t dst = filled;
      for (size_t src = 0; src < take; ++src) {
        if (!ok[src]) continue;
        size_t s = filled + src;
        if (dst != s) {
          std::memcpy(out->host + dst * plane, out->host + s * plane,
                      plane * sizeof(float));
          out->labels[dst] = out->labels[s];
        }
        ++dst;
      }
      out->failed += static_cast<int>(filled + take - dst);
      filled = dst;
    }
    out->n = static_cast<int>(filled);
    failures.fetch_add(out->failed);
    for (size_t s = filled; s < static_cast<size_t>(batch); ++s) {
      std::memset(out->host + s * plane, 0, plane * sizeof(float));
      out->labels[s] = 0.0f;
    }
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

}  // namespace

extern "C" {

void* mx_nvjpeg_create(const char* rec_path, int batch, int h, int w, int c,
                       int threads, int shuffle, unsigned seed, int mirror,
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
  L->last_failed = 0;
  for (;;) {
    if (L->faulted()) return -1;
    Batch& b = L->bufs[L->cur];
    L->last_failed += b.failed;
    if (b.n == 0 && b.failed > 0) {
      if (L->pending.valid()) L->pending.wait();
      L->cur = 1 - L->cur;
      L->start_prefetch();
      continue;
    }
    if (b.n == 0) return 0;
    size_t plane = static_cast<size_t>(L->c) * L->h * L->w;
    std::memcpy(data, b.host, L->batch * plane * sizeof(float));
    std::memcpy(labels, b.labels.data(), b.labels.size() * sizeof(float));
    int n = b.n;
    if (L->pending.valid()) L->pending.wait();
    L->cur = 1 - L->cur;
    L->start_prefetch();
    return n;
  }
}

void mx_nvjpeg_reset(void* handle) { static_cast<Loader*>(handle)->reset(); }

long mx_nvjpeg_failures(void* handle) {
  return static_cast<Loader*>(handle)->failures.load();
}

int mx_nvjpeg_last_failed(void* handle) {
  return static_cast<Loader*>(handle)->last_failed;
}

long mx_nvjpeg_launches(void* handle) {
  return static_cast<Loader*>(handle)->launches.load();
}

const char* mx_nvjpeg_error(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  std::lock_guard<std::mutex> lock(L->err_mu);
  return L->error.c_str();
}

void mx_nvjpeg_destroy(void* handle) { delete static_cast<Loader*>(handle); }

int mx_resize_rgb_chw(const unsigned char* src, int sw, int sh, float* dst,
                      int dw, int dh, int c, int mirror, void* stream) {
  return static_cast<int>(launch_resize(src, sw, sh, dst, dw, dh, c, mirror,
                                        static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
