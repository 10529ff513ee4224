// Threaded image-record loader and JPEG codec of the PyTorch package: its
// own copy of the JAX package's loader (native/image_loader.cc), the
// counterpart of the reference's multithreaded decode pipeline
// (src/io/iter_image_recordio_2.cc: M decoder threads + prefetcher).
//
// One pass at create() indexes the .rec file (record offsets/lengths).
// next() hands back the batch assembled in the background and immediately
// starts decoding the following batch: N worker threads each pread() their
// records, parse the IRHeader (recordio.py layout: <I flag><f label>
// <Q id><Q id2>[flag * float extra labels]<jpeg bytes>), JPEG-decode via
// libjpeg, bilinear-resize to the target geometry, optionally mirror, and
// write float32 CHW rows scaled to [0, 1].
//
// C ABI of the loader (the JAX package's, consumed through ctypes by
// mxnet_tpu_torch/image/native_iter.py):
//   mx_imgloader_create(rec, batch, h, w, c, threads, shuffle, seed, mirror)
//   mx_imgloader_num_samples(h)
//   mx_imgloader_next(h, float* data, float* labels) -> n valid (0 = epoch end)
//   mx_imgloader_last_failed(h) -> decode failures behind the last next()
//   mx_imgloader_failures(h)    -> cumulative decode failures
//   mx_imgloader_reset(h)
//   mx_imgloader_destroy(h)
// and of the one-image codec behind image.imdecode and recordio.pack_img:
//   mx_jpeg_decode(buf, len, mode, &pixels, &w, &h, &c) -> 0, or -1 corrupt
//     (mode 1 RGB, 0 grayscale, -1 as stored: 1 or 3 channels; HWC uint8)
//   mx_jpeg_encode(pixels, w, h, c, quality, &bytes, &len) -> 0, or -1
//   mx_jpeg_free(p)   frees what either returned
//
// Built at first use by mxnet_tpu_torch/ops/_build.py (g++ -ljpeg).
#include <fcntl.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <future>
#include <random>
#include <thread>
#include <vector>

#include <csetjmp>
#include <jpeglib.h>

namespace {

constexpr uint32_t kMagic = 0xced7230a;

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_bail(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jump, 1);
}

// Decode JPEG bytes to packed RGB; returns false on corrupt input.
bool decode_jpeg(const unsigned char* buf, size_t len,
                 std::vector<unsigned char>* rgb, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_bail;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  rgb->resize(static_cast<size_t>(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = rgb->data() +
        static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Bilinear src(RGB, sh x sw) → dst float CHW (c x dh x dw), scaled 1/255.
void resize_to_chw(const unsigned char* src, int sw, int sh, float* dst,
                   int dw, int dh, int channels, bool mirror) {
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = fy < 0 ? 0 : static_cast<int>(fy);
    if (y0 > sh - 1) y0 = sh - 1;
    int y1 = y0 + 1 > sh - 1 ? sh - 1 : y0 + 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < dw; ++x) {
      int xe = mirror ? (dw - 1 - x) : x;
      float fx = (xe + 0.5f) * sx - 0.5f;
      int x0 = fx < 0 ? 0 : static_cast<int>(fx);
      if (x0 > sw - 1) x0 = sw - 1;
      int x1 = x0 + 1 > sw - 1 ? sw - 1 : x0 + 1;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int ch = 0; ch < channels; ++ch) {
        int c3 = ch < 3 ? ch : 2;
        float v00 = src[(static_cast<size_t>(y0) * sw + x0) * 3 + c3];
        float v01 = src[(static_cast<size_t>(y0) * sw + x1) * 3 + c3];
        float v10 = src[(static_cast<size_t>(y1) * sw + x0) * 3 + c3];
        float v11 = src[(static_cast<size_t>(y1) * sw + x1) * 3 + c3];
        float v = (1 - wy) * ((1 - wx) * v00 + wx * v01) +
                  wy * ((1 - wx) * v10 + wx * v11);
        dst[(static_cast<size_t>(ch) * dh + y) * dw + x] = v / 255.0f;
      }
    }
  }
}

struct Rec {
  int64_t off;
  uint32_t len;
};

struct Batch {
  std::vector<float> data;
  std::vector<float> labels;
  int n = 0;
  int failed = 0;   // records of THIS batch that failed to decode
};

struct Loader {
  int fd = -1;
  int batch, h, w, c, threads, shuffle, mirror;
  std::atomic<long> failures{0};   // cumulative decode failures
  int last_failed = 0;             // failures of the batch last returned
  std::mt19937 rng;
  std::vector<Rec> recs;
  std::vector<uint32_t> order;
  size_t cursor = 0;
  Batch bufs[2];
  int cur = 0;
  std::future<void> pending;

  ~Loader() {
    if (pending.valid()) pending.wait();
    if (fd >= 0) close(fd);
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

  // Returns true on success; failures leave the slot zeroed (the
  // caller compacts them out of the batch).
  bool decode_one(uint32_t rec_idx, Batch* out, int slot, bool flip) {
    const Rec& r = recs[rec_idx];
    std::vector<unsigned char> raw(r.len);
    if (pread(fd, raw.data(), r.len, r.off) !=
        static_cast<ssize_t>(r.len))
      return false;
    if (r.len < 24) return false;
    uint32_t flag;
    float label;
    std::memcpy(&flag, raw.data(), 4);
    std::memcpy(&label, raw.data() + 4, 4);
    size_t skip = 24 + static_cast<size_t>(flag > 0 ? flag : 0) * 4;
    if (flag > 0 && r.len >= skip)
      std::memcpy(&label, raw.data() + 24, 4);   // first extended label
    if (r.len <= skip) return false;
    std::vector<unsigned char> rgb;
    int sw = 0, sh = 0;
    if (!decode_jpeg(raw.data() + skip, r.len - skip, &rgb, &sw, &sh))
      return false;   // corrupt or non-JPEG payload
    float* dst = out->data.data() +
        static_cast<size_t>(slot) * c * h * w;
    resize_to_chw(rgb.data(), sw, sh, dst, w, h, c, flip);
    out->labels[slot] = label;
    return true;
  }

  // Assemble one batch into *out (parallel across `threads` workers).
  // Corrupt records are dropped and the batch is TOPPED UP from the
  // records that follow (the reference iterator's read-ahead-past-
  // corrupt behavior): out->n is short only at true end-of-data.
  void fill(Batch* out) {
    out->data.assign(static_cast<size_t>(batch) * c * h * w, 0.0f);
    out->labels.assign(batch, 0.0f);
    out->failed = 0;
    size_t plane = static_cast<size_t>(c) * h * w;
    size_t filled = 0;
    std::bernoulli_distribution coin(0.5);
    while (filled < static_cast<size_t>(batch) && cursor < recs.size()) {
      size_t take = std::min<size_t>(batch - filled,
                                     recs.size() - cursor);
      std::vector<uint32_t> picked(order.begin() + cursor,
                                   order.begin() + cursor + take);
      std::vector<char> flips(take, 0);
      if (mirror)
        for (auto& fl : flips) fl = coin(rng) ? 1 : 0;
      cursor += take;
      std::vector<char> ok(take, 0);
      std::atomic<size_t> next_slot{0};
      auto work = [&]() {
        for (;;) {
          size_t slot = next_slot.fetch_add(1);
          if (slot >= take) return;
          ok[slot] = decode_one(picked[slot], out,
                                static_cast<int>(filled + slot),
                                flips[slot] != 0) ? 1 : 0;
        }
      };
      int nthreads = std::max(1, threads);
      std::vector<std::thread> pool;
      for (int i = 1; i < nthreads; ++i) pool.emplace_back(work);
      work();
      for (auto& t : pool) t.join();
      // compact this round's failed slots, then loop to top up
      size_t dst = filled;
      for (size_t src = 0; src < take; ++src) {
        if (!ok[src]) continue;
        size_t s = filled + src;
        if (dst != s) {
          std::memcpy(out->data.data() + dst * plane,
                      out->data.data() + s * plane,
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
    // zero any tail so padded slots are deterministic
    for (size_t s = filled; s < static_cast<size_t>(batch); ++s) {
      std::memset(out->data.data() + s * plane, 0, plane * sizeof(float));
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

void* mx_imgloader_create(const char* rec_path, int batch, int h, int w,
                          int c, int threads, int shuffle, unsigned seed,
                          int mirror) {
  int fd = open(rec_path, O_RDONLY);
  if (fd < 0) return nullptr;
  auto* L = new Loader();
  L->fd = fd;
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
    delete L;
    return nullptr;
  }
  L->reset();
  return L;
}

int64_t mx_imgloader_num_samples(void* handle) {
  return static_cast<Loader*>(handle)->recs.size();
}

int mx_imgloader_next(void* handle, float* data, float* labels) {
  auto* L = static_cast<Loader*>(handle);
  L->last_failed = 0;
  for (;;) {
    Batch& b = L->bufs[L->cur];
    L->last_failed += b.failed;
    if (b.n == 0 && b.failed > 0) {
      // every record of this batch was corrupt: advance rather than
      // reporting a spurious epoch end
      if (L->pending.valid()) L->pending.wait();
      L->cur = 1 - L->cur;
      L->start_prefetch();
      continue;
    }
    if (b.n == 0) return 0;        // true epoch end
    std::memcpy(data, b.data.data(), b.data.size() * sizeof(float));
    std::memcpy(labels, b.labels.data(),
                b.labels.size() * sizeof(float));
    int n = b.n;
    // rotate: the prefetched batch becomes current, refill the other
    if (L->pending.valid()) L->pending.wait();
    L->cur = 1 - L->cur;
    L->start_prefetch();
    return n;
  }
}

void mx_imgloader_reset(void* handle) {
  static_cast<Loader*>(handle)->reset();
}

long mx_imgloader_failures(void* handle) {
  return static_cast<Loader*>(handle)->failures.load();
}

// Failures attributable to the batch most recently returned by
// mx_imgloader_next (race-free, unlike polling the cumulative count
// while prefetch runs).
int mx_imgloader_last_failed(void* handle) {
  return static_cast<Loader*>(handle)->last_failed;
}

void mx_imgloader_destroy(void* handle) {
  delete static_cast<Loader*>(handle);
}

}  // extern "C"

// -- one-image codec ---------------------------------------------------------

extern "C" {

int mx_jpeg_decode(const unsigned char* buf, uint64_t len, int mode,
                   unsigned char** out, int* w, int* h, int* c) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  unsigned char* volatile pixels = nullptr;  // survives the longjmp
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_bail;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::free(pixels);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  bool gray = mode == 0 || (mode < 0 && cinfo.num_components == 1);
  cinfo.out_color_space = gray ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  *c = cinfo.output_components;
  size_t row_bytes = static_cast<size_t>(*w) * *c;
  pixels = static_cast<unsigned char*>(std::malloc(row_bytes * *h));
  if (!pixels) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = pixels +
        static_cast<size_t>(cinfo.output_scanline) * row_bytes;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out = pixels;
  return 0;
}

int mx_jpeg_encode(const unsigned char* pixels, int w, int h, int c,
                   int quality, unsigned char** out, uint64_t* len) {
  if (c != 1 && c != 3) return -1;
  jpeg_compress_struct cinfo;
  JpegErr err;
  unsigned char* mem = nullptr;
  unsigned long mem_len = 0;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_bail;
  if (setjmp(err.jump)) {
    jpeg_destroy_compress(&cinfo);
    std::free(mem);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &mem, &mem_len);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = c;
  cinfo.in_color_space = c == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  size_t row_bytes = static_cast<size_t>(w) * c;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<unsigned char*>(
        pixels + static_cast<size_t>(cinfo.next_scanline) * row_bytes);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  *out = mem;
  *len = mem_len;
  return 0;
}

void mx_jpeg_free(void* p) { std::free(p); }

}  // extern "C"
