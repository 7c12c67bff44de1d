// Native streaming TFRecord reader + fused CTR Example decoder.
//
// This is the framework's equivalent of the reference's native data plane:
// the C++ tf.data runtime (TFRecordDataset, reference ps:147) and the
// sagemaker_tensorflow PipeModeDataset C++ dataset op (reference ps:150,
// hvd:136) — see SURVEY.md §2b.  One handle streams records from an ordered
// list of sources (regular files or FIFOs), verifies the masked-CRC32C
// framing, applies round-robin record sharding (dataset.shard semantics:
// record i belongs to shard i % n), and decodes the fixed CTR schema
// (label f32[1], ids i64[F], values f32[F] — reference
// tools/libsvm_to_tfrecord.py:41-53) straight into caller-owned buffers,
// so Python sees whole numpy batches with zero per-record overhead.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
//
// Wire formats implemented:
//   TFRecord framing: u64le length | u32le masked_crc32c(length bytes)
//                     | payload | u32le masked_crc32c(payload)
//   tf.train.Example proto subset: Example.features(1) -> map entry(1)
//     -> key(1)/Feature(2); Feature: float_list(2)|int64_list(3);
//     *List.value(1) packed (wire 2) or unpacked (wire 5 / wire 0).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

#if defined(__x86_64__)
#include <cpuid.h>
#include <nmmintrin.h>
#endif

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli): slice-by-8 software path + SSE4.2 hardware path.
// ---------------------------------------------------------------------------

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;  // reflected 0x1EDC6F41
constexpr uint32_t kMaskDelta = 0xA282EAD8u;

uint32_t g_tables[8][256];
bool g_tables_init = false;
bool g_have_sse42 = false;

void init_crc_tables() {
  for (int n = 0; n < 256; ++n) {
    uint32_t c = static_cast<uint32_t>(n);
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ kPoly : c >> 1;
    g_tables[0][n] = c;
  }
  for (int k = 1; k < 8; ++k)
    for (int n = 0; n < 256; ++n)
      g_tables[k][n] = g_tables[0][g_tables[k - 1][n] & 0xFF] ^
                       (g_tables[k - 1][n] >> 8);
#if defined(__x86_64__)
  unsigned int eax, ebx, ecx, edx;
  if (__get_cpuid(1, &eax, &ebx, &ecx, &edx)) g_have_sse42 = (ecx >> 20) & 1;
#endif
  g_tables_init = true;
}

uint32_t crc32c_sw(const uint8_t* p, size_t n, uint32_t crc) {
  crc = ~crc;
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    crc ^= lo;
    crc = g_tables[7][crc & 0xFF] ^ g_tables[6][(crc >> 8) & 0xFF] ^
          g_tables[5][(crc >> 16) & 0xFF] ^ g_tables[4][crc >> 24] ^
          g_tables[3][hi & 0xFF] ^ g_tables[2][(hi >> 8) & 0xFF] ^
          g_tables[1][(hi >> 16) & 0xFF] ^ g_tables[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = g_tables[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2")))
uint32_t crc32c_hw(const uint8_t* p, size_t n, uint32_t crc) {
  uint64_t c = ~crc;
  while (n >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    c = _mm_crc32_u64(c, v);
    p += 8;
    n -= 8;
  }
  uint32_t c32 = static_cast<uint32_t>(c);
  while (n--) c32 = _mm_crc32_u8(c32, *p++);
  return ~c32;
}
#endif

uint32_t crc32c(const uint8_t* p, size_t n) {
#if defined(__x86_64__)
  if (g_have_sse42) return crc32c_hw(p, n, 0);
#endif
  return crc32c_sw(p, n, 0);
}

inline uint32_t masked_crc32c(const uint8_t* p, size_t n) {
  uint32_t crc = crc32c(p, n);
  return ((crc >> 15) | (crc << 17)) + kMaskDelta;
}

// ---------------------------------------------------------------------------
// Reader handle
// ---------------------------------------------------------------------------

struct Reader {
  std::vector<std::string> paths;
  size_t path_idx = 0;
  FILE* f = nullptr;
  std::vector<char> iobuf;       // stdio buffer (setvbuf)
  std::vector<uint8_t> record;   // current record payload
  bool verify = true;
  // round-robin record sharding across the whole stream (dataset.shard)
  int64_t shard_n = 1;
  int64_t shard_i = 0;
  int64_t record_idx = 0;        // global (pre-shard) record counter
  std::string error;
  bool eof = false;

  bool fail(const std::string& msg) {
    error = msg;
    return false;
  }

  bool open_next_file() {
    if (f) {
      std::fclose(f);
      f = nullptr;
    }
    if (path_idx >= paths.size()) {
      eof = true;
      return false;
    }
    const std::string& p = paths[path_idx++];
    f = std::fopen(p.c_str(), "rb");
    if (!f) return fail("cannot open " + p);
    std::setvbuf(f, iobuf.data(), _IOFBF, iobuf.size());
    return true;
  }

  // Read exactly n bytes.  fread blocks until n bytes or EOF, which is the
  // right semantics for both regular files and FIFOs (short reads loop
  // inside stdio).  Returns bytes read.
  size_t read_exactly(uint8_t* dst, size_t n) {
    return std::fread(dst, 1, n, f);
  }

  // Advance to the next raw record (any shard).  Returns:
  //   1 record ready, 0 clean end-of-stream, -1 error (see .error)
  int next_raw() {
    for (;;) {
      if (!f && !open_next_file()) return error.empty() ? 0 : -1;
      uint8_t header[12];
      size_t got = read_exactly(header, 12);
      if (got == 0) {
        // 0 bytes is only a clean EOF if no stream error is pending; an I/O
        // error at a record boundary must not silently truncate the dataset
        if (std::ferror(f)) return fail("read error at record boundary"), -1;
        if (!open_next_file()) return error.empty() ? 0 : -1;
        continue;
      }
      if (got < 12) return fail("truncated record header"), -1;
      uint64_t len;
      uint32_t len_crc;
      std::memcpy(&len, header, 8);
      std::memcpy(&len_crc, header + 8, 4);
      if (verify && masked_crc32c(header, 8) != len_crc)
        return fail("length CRC mismatch"), -1;
      if (len > (1ull << 31)) return fail("record too large"), -1;
      record.resize(len + 4);
      if (read_exactly(record.data(), len + 4) < len + 4)
        return fail("truncated record body"), -1;
      uint32_t data_crc;
      std::memcpy(&data_crc, record.data() + len, 4);
      if (verify && masked_crc32c(record.data(), len) != data_crc)
        return fail("data CRC mismatch"), -1;
      record.resize(len);
      return 1;
    }
  }

  // Next record belonging to this shard.
  int next() {
    for (;;) {
      int rc = next_raw();
      if (rc != 1) return rc;
      bool mine = (record_idx % shard_n) == shard_i;
      ++record_idx;
      if (mine) return 1;
    }
  }
};

// ---------------------------------------------------------------------------
// tf.train.Example subset parser (fixed CTR schema)
// ---------------------------------------------------------------------------

struct Span {
  const uint8_t* p;
  size_t n;
};

bool read_varint(const uint8_t*& p, const uint8_t* end, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (p < end) {
    uint8_t b = *p++;
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

// Skip a field of the given wire type; p points just past the tag.
bool skip_field(const uint8_t*& p, const uint8_t* end, uint32_t wire) {
  uint64_t tmp;
  switch (wire) {
    case 0:
      return read_varint(p, end, &tmp);
    case 1:
      if (end - p < 8) return false;
      p += 8;
      return true;
    case 2:
      if (!read_varint(p, end, &tmp) || static_cast<uint64_t>(end - p) < tmp)
        return false;
      p += tmp;
      return true;
    case 5:
      if (end - p < 4) return false;
      p += 4;
      return true;
    default:
      return false;
  }
}

// Parse FloatList bytes -> up to cap floats into out; returns count or -1.
int64_t parse_float_list(Span s, float* out, int64_t cap) {
  const uint8_t* p = s.p;
  const uint8_t* end = s.p + s.n;
  int64_t count = 0;
  while (p < end) {
    uint64_t tag;
    if (!read_varint(p, end, &tag)) return -1;
    uint32_t fn = tag >> 3, wire = tag & 7;
    if (fn == 1 && wire == 2) {  // packed
      uint64_t ln;
      if (!read_varint(p, end, &ln) || static_cast<uint64_t>(end - p) < ln ||
          ln % 4)
        return -1;
      int64_t k = ln / 4;
      if (count + k > cap) return -1;
      std::memcpy(out + count, p, ln);
      count += k;
      p += ln;
    } else if (fn == 1 && wire == 5) {  // unpacked
      if (end - p < 4 || count + 1 > cap) return -1;
      std::memcpy(out + count, p, 4);
      ++count;
      p += 4;
    } else if (!skip_field(p, end, wire)) {
      return -1;
    }
  }
  return count;
}

int64_t parse_int64_list(Span s, int64_t* out, int64_t cap) {
  const uint8_t* p = s.p;
  const uint8_t* end = s.p + s.n;
  int64_t count = 0;
  while (p < end) {
    uint64_t tag;
    if (!read_varint(p, end, &tag)) return -1;
    uint32_t fn = tag >> 3, wire = tag & 7;
    if (fn == 1 && wire == 2) {  // packed varints
      uint64_t ln;
      if (!read_varint(p, end, &ln) || static_cast<uint64_t>(end - p) < ln)
        return -1;
      const uint8_t* pe = p + ln;
      while (p < pe) {
        uint64_t v;
        if (!read_varint(p, pe, &v) || count + 1 > cap) return -1;
        out[count++] = static_cast<int64_t>(v);
      }
    } else if (fn == 1 && wire == 0) {
      uint64_t v;
      if (!read_varint(p, end, &v) || count + 1 > cap) return -1;
      out[count++] = static_cast<int64_t>(v);
    } else if (!skip_field(p, end, wire)) {
      return -1;
    }
  }
  return count;
}

// Walk one Example, locating the Feature payloads for label/ids/values.
// Returns false on malformed proto.
bool find_ctr_features(Span ex, Span* label, Span* ids, Span* values) {
  label->p = ids->p = values->p = nullptr;
  const uint8_t* p = ex.p;
  const uint8_t* end = ex.p + ex.n;
  while (p < end) {
    uint64_t tag;
    if (!read_varint(p, end, &tag)) return false;
    uint32_t fn = tag >> 3, wire = tag & 7;
    if (fn != 1 || wire != 2) {  // not Example.features
      if (!skip_field(p, end, wire)) return false;
      continue;
    }
    uint64_t flen;
    if (!read_varint(p, end, &flen) || static_cast<uint64_t>(end - p) < flen)
      return false;
    const uint8_t* fp = p;
    const uint8_t* fend = p + flen;
    p += flen;
    // Features: repeated map entry (field 1)
    while (fp < fend) {
      uint64_t etag;
      if (!read_varint(fp, fend, &etag)) return false;
      if ((etag >> 3) != 1 || (etag & 7) != 2) {
        if (!skip_field(fp, fend, etag & 7)) return false;
        continue;
      }
      uint64_t elen;
      if (!read_varint(fp, fend, &elen) ||
          static_cast<uint64_t>(fend - fp) < elen)
        return false;
      const uint8_t* ep = fp;
      const uint8_t* eend = fp + elen;
      fp += elen;
      // map entry: key=1 (string), value=2 (Feature)
      Span key{nullptr, 0}, feat{nullptr, 0};
      while (ep < eend) {
        uint64_t mtag;
        if (!read_varint(ep, eend, &mtag)) return false;
        uint32_t mfn = mtag >> 3, mwire = mtag & 7;
        if (mwire == 2) {
          uint64_t mlen;
          if (!read_varint(ep, eend, &mlen) ||
              static_cast<uint64_t>(eend - ep) < mlen)
            return false;
          if (mfn == 1) key = {ep, mlen};
          else if (mfn == 2) feat = {ep, mlen};
          ep += mlen;
        } else if (!skip_field(ep, eend, mwire)) {
          return false;
        }
      }
      if (!key.p || !feat.p) continue;
      // Feature oneof: float_list=2 | int64_list=3 (bytes_list=1 unused).
      // We hand back the *List payload span.
      const uint8_t* vp = feat.p;
      const uint8_t* vend = feat.p + feat.n;
      while (vp < vend) {
        uint64_t vtag;
        if (!read_varint(vp, vend, &vtag)) return false;
        uint32_t vfn = vtag >> 3, vwire = vtag & 7;
        if (vwire != 2) {
          if (!skip_field(vp, vend, vwire)) return false;
          continue;
        }
        uint64_t vlen;
        if (!read_varint(vp, vend, &vlen) ||
            static_cast<uint64_t>(vend - vp) < vlen)
          return false;
        Span list{vp, vlen};
        vp += vlen;
        if (key.n == 5 && !std::memcmp(key.p, "label", 5) && vfn == 2)
          *label = list;
        else if (key.n == 3 && !std::memcmp(key.p, "ids", 3) && vfn == 3)
          *ids = list;
        else if (key.n == 6 && !std::memcmp(key.p, "values", 6) && vfn == 2)
          *values = list;
      }
    }
  }
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// paths: NUL-separated, double-NUL terminated list of source paths.
void* dfm_reader_open(const char* paths, int verify_crc, int64_t shard_n,
                      int64_t shard_i) {
  if (!g_tables_init) init_crc_tables();
  auto* r = new Reader();
  const char* p = paths;
  while (*p) {
    r->paths.emplace_back(p);
    p += r->paths.back().size() + 1;
  }
  r->iobuf.resize(1 << 20);
  r->verify = verify_crc != 0;
  r->shard_n = shard_n > 0 ? shard_n : 1;
  r->shard_i = shard_i;
  return r;
}

void dfm_reader_close(void* h) {
  auto* r = static_cast<Reader*>(h);
  if (r->f) std::fclose(r->f);
  delete r;
}

const char* dfm_reader_error(void* h) {
  return static_cast<Reader*>(h)->error.c_str();
}

// Next raw record (this shard).  On success returns length and sets *data to
// an internal buffer valid until the next call.  Returns -1 on clean EOF,
// -2 on error.
int64_t dfm_reader_next_record(void* h, const uint8_t** data) {
  auto* r = static_cast<Reader*>(h);
  int rc = r->next();
  if (rc == 0) return -1;
  if (rc < 0) return -2;
  *data = r->record.data();
  return static_cast<int64_t>(r->record.size());
}

// Fused: read up to `batch` records of this shard and decode the CTR schema
// into ids_out [batch*field_size] i64, vals_out [batch*field_size] f32,
// labels_out [batch] f32.  Returns number of records decoded (< batch only
// at end-of-stream), or -2 on error.
int64_t dfm_reader_next_ctr_batch(void* h, int64_t batch, int64_t field_size,
                                  int64_t* ids_out, float* vals_out,
                                  float* labels_out) {
  auto* r = static_cast<Reader*>(h);
  for (int64_t i = 0; i < batch; ++i) {
    int rc = r->next();
    if (rc == 0) return i;
    if (rc < 0) return -2;
    Span ex{r->record.data(), r->record.size()};
    Span label, ids, values;
    if (!find_ctr_features(ex, &label, &ids, &values)) {
      r->fail("malformed Example proto");
      return -2;
    }
    if (!label.p || !ids.p || !values.p) {
      r->fail("Example missing label/ids/values feature");
      return -2;
    }
    float lab[2];
    if (parse_float_list(label, lab, 1) != 1) {
      r->fail("label must be FloatList[1]");
      return -2;
    }
    labels_out[i] = lab[0];
    if (parse_int64_list(ids, ids_out + i * field_size, field_size) !=
        field_size) {
      r->fail("ids count != field_size");
      return -2;
    }
    if (parse_float_list(values, vals_out + i * field_size, field_size) !=
        field_size) {
      r->fail("values count != field_size");
      return -2;
    }
  }
  return batch;
}

// Standalone CRC for tests/tools.
uint32_t dfm_masked_crc32c(const uint8_t* data, uint64_t n) {
  if (!g_tables_init) init_crc_tables();
  return masked_crc32c(data, n);
}

int dfm_have_hw_crc(void) {
  if (!g_tables_init) init_crc_tables();
  return g_have_sse42 ? 1 : 0;
}

}  // extern "C"
