// Native RecordIO codec: buffered reader/writer of the dmlc recordio wire
// format ([kMagic:u32][lrec:u32][payload][pad4], lrec = cflag<<29 | len).
//
// The PyTorch package's own copy of the JAX package's codec, with the same
// C ABI (MXRIOWriterCreate/Write/Tell/Free, MXRIOReaderCreate/Read/Tell/
// Seek/Free).  mxnet_tpu_torch/recordio.py binds it through ctypes for
// local paths; URIs with a scheme go through the pure-Python codec there.
//
// Built at first use by mxnet_tpu_torch/ops/_build.py (g++, into
// mxnet_tpu_torch/_build/).
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xced7230a;
constexpr size_t kBufSize = 4 << 20;  // 4 MB buffered IO

struct Writer {
  FILE* f;
  std::vector<char> buf;
  explicit Writer(FILE* fp) : f(fp) { buf.reserve(kBufSize); }
  void flush() {
    if (!buf.empty()) {
      fwrite(buf.data(), 1, buf.size(), f);
      buf.clear();
    }
  }
  void append(const void* p, size_t n) {
    if (buf.size() + n > kBufSize) flush();
    if (n > kBufSize) {
      fwrite(p, 1, n, f);
    } else {
      const char* c = static_cast<const char*>(p);
      buf.insert(buf.end(), c, c + n);
    }
  }
};

struct Reader {
  FILE* f;
  std::vector<char> record;  // last read payload (owned)
};

}  // namespace

extern "C" {

void* MXRIOWriterCreate(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  return new Writer(f);
}

int MXRIOWrite(void* handle, const char* data, uint64_t len) {
  auto* w = static_cast<Writer*>(handle);
  if (!w || len >= (1ull << 29)) return -1;
  uint32_t head[2] = {kMagic, static_cast<uint32_t>(len)};  // cflag 0
  w->append(head, sizeof(head));
  w->append(data, len);
  static const char zeros[4] = {0, 0, 0, 0};
  size_t pad = (4 - (len % 4)) % 4;
  if (pad) w->append(zeros, pad);
  return 0;
}

int64_t MXRIOWriterTell(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  return static_cast<int64_t>(ftell(w->f)) +
         static_cast<int64_t>(w->buf.size());
}

void MXRIOWriterFree(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  if (!w) return;
  w->flush();
  fclose(w->f);
  delete w;
}

void* MXRIOReaderCreate(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new Reader();
  r->f = f;
  // large stdio buffer: sequential scan of sharded .rec files is the
  // data-pipeline hot path
  setvbuf(f, nullptr, _IOFBF, kBufSize);
  return r;
}

// Returns 1 on success (payload in *out / *len), 0 on EOF, -1 on corrupt
// stream. *out points at memory owned by the reader, valid until the next
// call. Length goes via *len so zero-length records are distinct from EOF.
int MXRIORead(void* handle, const char** out, uint64_t* len_out) {
  auto* r = static_cast<Reader*>(handle);
  uint32_t head[2];
  if (fread(head, sizeof(uint32_t), 2, r->f) != 2) return 0;  // EOF
  if (head[0] != kMagic) return -1;
  uint32_t len = head[1] & ((1u << 29) - 1);
  uint32_t cflag = head[1] >> 29;
  if (cflag != 0) return -1;  // python writer emits complete records only
  r->record.resize(len ? len : 1);
  if (len && fread(r->record.data(), 1, len, r->f) != len) return -1;
  size_t pad = (4 - (len % 4)) % 4;
  if (pad) fseek(r->f, static_cast<long>(pad), SEEK_CUR);
  *out = r->record.data();
  *len_out = len;
  return 1;
}

int64_t MXRIOReaderTell(void* handle) {
  return ftell(static_cast<Reader*>(handle)->f);
}

int MXRIOReaderSeek(void* handle, int64_t pos) {
  return fseek(static_cast<Reader*>(handle)->f, static_cast<long>(pos),
               SEEK_SET);
}

void MXRIOReaderFree(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (!r) return;
  fclose(r->f);
  delete r;
}

}  // extern "C"
