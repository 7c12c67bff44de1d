// Native Criteo raw-TSV -> TFRecord hash encoder (the 1TB-path prep).
//
// Byte-identical to the Python pipeline it accelerates:
//   data/criteo.py CriteoHashEncoder.encode  (blake2b-8 of "field:token",
//     little-endian, mod (feature_size - 14), +14; log1p numerics)
//   data/example_proto.serialize_ctr_example (label FloatList[1],
//     ids Int64List[39] packed varint, values FloatList[39] packed,
//     map entries in label/ids/values order)
//   data/tfrecord.frame_record               (u64 length LE + masked CRC32C
//     of header + payload + masked CRC32C of payload — CRC from
//     tfrecord_reader.cc, same shared library)
//   data/criteo.convert_criteo_to_tfrecords  (blank lines skipped, shards
//     "{prefix}-%05d.tfrecords" of records_per_shard each)
//
// Python measured ~5k lines/s on one core; this path exists so the
// Criteo-1TB (4.4B-line) prep is not interpreter-bound.  Exposed via
// ctypes as dfm_criteo_hash_encode; dfm_blake2b64 is exported separately
// so tests can pin hash equality against hashlib.
//
// BLAKE2b per RFC 7693, unkeyed, digest_length=8 — matching
// hashlib.blake2b(data, digest_size=8).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" uint32_t dfm_masked_crc32c(const char* data, uint64_t len);

// ---------------------------------------------------------------------------
// BLAKE2b (compact, unkeyed, variable digest)
// ---------------------------------------------------------------------------

static const uint64_t B2B_IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

static const uint8_t B2B_SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
};

static inline uint64_t rotr64(uint64_t x, int n) {
    return (x >> n) | (x << (64 - n));
}

static void b2b_compress(uint64_t h[8], const uint8_t block[128],
                         uint64_t t0, uint64_t t1, bool last) {
    uint64_t m[16], v[16];
    std::memcpy(m, block, 128);  // little-endian host assumed (x86/arm64)
    for (int i = 0; i < 8; i++) v[i] = h[i];
    for (int i = 0; i < 8; i++) v[i + 8] = B2B_IV[i];
    v[12] ^= t0;
    v[13] ^= t1;
    if (last) v[14] = ~v[14];
#define B2B_G(a, b, c, d, x, y)                  \
    do {                                         \
        v[a] = v[a] + v[b] + (x);                \
        v[d] = rotr64(v[d] ^ v[a], 32);          \
        v[c] = v[c] + v[d];                      \
        v[b] = rotr64(v[b] ^ v[c], 24);          \
        v[a] = v[a] + v[b] + (y);                \
        v[d] = rotr64(v[d] ^ v[a], 16);          \
        v[c] = v[c] + v[d];                      \
        v[b] = rotr64(v[b] ^ v[c], 63);          \
    } while (0)
    for (int r = 0; r < 12; r++) {
        const uint8_t* s = B2B_SIGMA[r];
        B2B_G(0, 4, 8, 12, m[s[0]], m[s[1]]);
        B2B_G(1, 5, 9, 13, m[s[2]], m[s[3]]);
        B2B_G(2, 6, 10, 14, m[s[4]], m[s[5]]);
        B2B_G(3, 7, 11, 15, m[s[6]], m[s[7]]);
        B2B_G(0, 5, 10, 15, m[s[8]], m[s[9]]);
        B2B_G(1, 6, 11, 12, m[s[10]], m[s[11]]);
        B2B_G(2, 7, 8, 13, m[s[12]], m[s[13]]);
        B2B_G(3, 4, 9, 14, m[s[14]], m[s[15]]);
    }
#undef B2B_G
    for (int i = 0; i < 8; i++) h[i] ^= v[i] ^ v[i + 8];
}

// 8-byte unkeyed BLAKE2b of data, returned as the little-endian uint64 the
// Python side builds with int.from_bytes(digest, "little")
extern "C" uint64_t dfm_blake2b64(const uint8_t* data, uint64_t len) {
    uint64_t h[8];
    for (int i = 0; i < 8; i++) h[i] = B2B_IV[i];
    h[0] ^= 0x01010000ULL ^ 8ULL;  // digest_length=8, fanout=1, depth=1
    uint64_t t = 0;
    uint8_t block[128];
    while (len > 128) {
        std::memcpy(block, data, 128);
        t += 128;
        b2b_compress(h, block, t, 0, false);
        data += 128;
        len -= 128;
    }
    std::memset(block, 0, 128);
    if (len) std::memcpy(block, data, len);
    t += len;
    b2b_compress(h, block, t, 0, true);
    return h[0];  // first 8 digest bytes == h[0] little-endian
}

// ---------------------------------------------------------------------------
// proto + framing writers (buffered)
// ---------------------------------------------------------------------------

static inline void put_varint(std::string& out, uint64_t n) {
    while (n >= 0x80) {
        out.push_back(static_cast<char>((n & 0x7f) | 0x80));
        n >>= 7;
    }
    out.push_back(static_cast<char>(n));
}

static inline void put_len_delimited(std::string& out, int field,
                                     const std::string& payload) {
    put_varint(out, (static_cast<uint64_t>(field) << 3) | 2);
    put_varint(out, payload.size());
    out.append(payload);
}

static constexpr int kNumNumeric = 13;
static constexpr int kNumCat = 26;
static constexpr int kFields = kNumNumeric + kNumCat;
static constexpr int kFirstCatId = kNumNumeric + 1;

struct EncodeState {
    int64_t feature_size;
    uint64_t buckets;
    // reused buffers
    std::string ex, tmp, inner, framed;
};

// serialize_ctr_example parity: Example{Features{label, ids, values}}
static void serialize_example(EncodeState& st, float label,
                              const int64_t ids[kFields],
                              const float vals[kFields]) {
    std::string& features = st.tmp;
    features.clear();

    auto map_entry = [&](const char* name, int kind,
                         const std::string& list_payload) {
        // entry = { key=1 string, value=2 Feature{kind: List} }
        std::string& entry = st.inner;
        entry.clear();
        size_t nk = std::strlen(name);
        put_varint(entry, (1ULL << 3) | 2);
        put_varint(entry, nk);
        entry.append(name, nk);
        std::string feature;
        std::string list;
        put_len_delimited(list, 1, list_payload);  // List.value (packed)
        put_len_delimited(feature, kind, list);    // Feature.<kind>_list
        put_len_delimited(entry, 2, feature);
        put_len_delimited(features, 1, entry);     // Features.feature
    };

    std::string payload;
    payload.resize(sizeof(float));
    std::memcpy(payload.data(), &label, sizeof(float));
    map_entry("label", 2, payload);  // FloatList = Feature field 2

    payload.clear();
    for (int i = 0; i < kFields; i++)
        put_varint(payload, static_cast<uint64_t>(ids[i]));
    map_entry("ids", 3, payload);    // Int64List = Feature field 3

    payload.resize(kFields * sizeof(float));
    std::memcpy(payload.data(), vals, kFields * sizeof(float));
    map_entry("values", 2, payload);

    st.ex.clear();
    put_len_delimited(st.ex, 1, features);  // Example.features
}

static void frame_record(EncodeState& st) {
    std::string& out = st.framed;
    out.clear();
    uint64_t n = st.ex.size();
    char header[8];
    std::memcpy(header, &n, 8);  // little-endian
    uint32_t hcrc = dfm_masked_crc32c(header, 8);
    uint32_t dcrc = dfm_masked_crc32c(st.ex.data(), st.ex.size());
    out.append(header, 8);
    out.append(reinterpret_cast<char*>(&hcrc), 4);
    out.append(st.ex);
    out.append(reinterpret_cast<char*>(&dcrc), 4);
}

// Python float() parity: strtod over the WHOLE field (leading/trailing
// whitespace tolerated, anything else rejects), arbitrary field length.
// strtod's grammar is wider than Python's in two silent ways, both closed
// here: hex floats ("0x1p3") are rejected, and an embedded NUL (which
// would truncate the C-string parse and ACCEPT a field Python rejects)
// is rejected up front.  The reverse direction — Python-only spellings
// like underscore grouping ("1_0") or non-ASCII digits — is already a
// rejection on this path, matching the documented contract that the
// native encoder accepts a SUBSET of float() inputs byte-identically
// (tests/test_criteo.py parity suite).
static bool parse_full_double(EncodeState& st, const char* s, size_t n,
                              double* out) {
    if (memchr(s, '\0', n) != nullptr) return false;
    // strtod's NAN(char-seq) extension — Python float() rejects any
    // parenthesized payload, so '(' anywhere in the field is a reject
    if (memchr(s, '(', n) != nullptr) return false;
    st.inner.assign(s, n);
    const char* c = st.inner.c_str();
    // reject strtod's hex-float extension: optional sign, then 0x/0X
    const char* h = c;
    while (*h == ' ' || *h == '\t' || *h == '\r' || *h == '\f' ||
           *h == '\v') {
        h++;
    }
    if (*h == '+' || *h == '-') h++;
    if (h[0] == '0' && (h[1] == 'x' || h[1] == 'X')) return false;
    char* endp = nullptr;
    double x = std::strtod(c, &endp);
    if (endp == c) return false;
    while (*endp == ' ' || *endp == '\t' || *endp == '\r' ||
           *endp == '\f' || *endp == '\v') {
        endp++;
    }
    if (*endp != '\0') return false;
    *out = x;
    return true;
}

// parse + encode one TSV line; returns false on anything the Python path
// (parse_criteo_line + float()) would raise on: field count != 40, or a
// non-numeric label/I-field
static bool encode_line(EncodeState& st, const char* line, size_t len,
                        float* label, int64_t ids[kFields],
                        float vals[kFields]) {
    const char* p = line;
    const char* end = line + len;
    const char* field_start[1 + kFields];
    size_t field_len[1 + kFields];
    int nf = 0;
    const char* s = p;
    for (const char* q = p;; q++) {
        if (q == end || *q == '\t') {
            if (nf < 1 + kFields) {
                field_start[nf] = s;
                field_len[nf] = static_cast<size_t>(q - s);
            }
            nf++;
            if (q == end) break;
            s = q + 1;
        }
    }
    if (nf != 1 + kFields) return false;  // parse_criteo_line raises

    {  // label: float(field) — empty/invalid rejects the line
        double x;
        if (field_len[0] == 0 ||
            !parse_full_double(st, field_start[0], field_len[0], &x)) {
            return false;
        }
        *label = static_cast<float>(x);
    }
    for (int i = 0; i < kNumNumeric; i++) {
        ids[i] = i + 1;
        size_t n = field_len[1 + i];
        if (n == 0) {
            vals[i] = 0.0f;  // missing numeric -> 0.0
            continue;
        }
        double x;
        if (!parse_full_double(st, field_start[1 + i], n, &x)) return false;
        vals[i] = static_cast<float>(x >= 0 ? std::log1p(x) : x);
    }
    for (int j = 0; j < kNumCat; j++) {
        // hash input "j:token" — '' hashes like any token (stable missing id)
        std::string& key = st.inner;
        key.clear();
        char jb[8];
        int jn = std::snprintf(jb, sizeof(jb), "%d:", j);
        key.append(jb, static_cast<size_t>(jn));
        key.append(field_start[1 + kNumNumeric + j],
                   field_len[1 + kNumNumeric + j]);
        uint64_t h = dfm_blake2b64(
            reinterpret_cast<const uint8_t*>(key.data()), key.size());
        ids[kNumNumeric + j] =
            kFirstCatId + static_cast<int64_t>(h % st.buckets);
        vals[kNumNumeric + j] = 1.0f;
    }
    return true;
}

static void set_err(char* err, int64_t cap, const char* msg) {
    if (err && cap > 0) {
        std::snprintf(err, static_cast<size_t>(cap), "%s", msg);
    }
}

// Streams input_path (TSV) into {prefix}-NNNNN.tfrecords shards under
// output_dir.  Returns records written, or -1 with err filled.
extern "C" int64_t dfm_criteo_hash_encode(
    const char* input_path, const char* output_dir, const char* prefix,
    int64_t feature_size, int64_t records_per_shard,
    char* err, int64_t err_cap) {
    if (feature_size <= kFirstCatId + kNumCat) {
        set_err(err, err_cap, "feature_size leaves no categorical hash space");
        return -1;
    }
    if (records_per_shard <= 0) {
        set_err(err, err_cap, "records_per_shard must be positive");
        return -1;
    }
    FILE* in = std::fopen(input_path, "rb");
    if (!in) {
        set_err(err, err_cap, "cannot open input");
        return -1;
    }
    EncodeState st;
    st.feature_size = feature_size;
    st.buckets = static_cast<uint64_t>(feature_size - kFirstCatId);

    FILE* out = nullptr;
    int shard = 0;
    int64_t in_shard = 0, total = 0;
    char* line = nullptr;
    size_t cap = 0;
    ssize_t n;
    int64_t bad = 0;
    float label;
    int64_t ids[kFields];
    float vals[kFields];
    std::string outbuf;
    outbuf.reserve(1 << 20);
    char path[4096];

    auto flush = [&]() {
        if (out && !outbuf.empty()) {
            std::fwrite(outbuf.data(), 1, outbuf.size(), out);
            outbuf.clear();
        }
    };

    while ((n = getline(&line, &cap, in)) != -1) {
        size_t len = static_cast<size_t>(n);
        // Python parity: the Python path reads in TEXT mode (universal
        // newlines), so "\r\n" arrives as "\n" and rstrip('\n') removes
        // it — strip the '\n' then ONE '\r' here.  (Classic-Mac lone-\r
        // line endings are not supported on this path; Python text mode
        // would split them, getline would not.)
        while (len && line[len - 1] == '\n') len--;
        if (len && line[len - 1] == '\r') len--;
        // blank check == `not line.strip()` (all str.strip() whitespace)
        bool blank = true;
        for (size_t i = 0; i < len; i++) {
            char c = line[i];
            if (c != ' ' && c != '\t' && c != '\r' && c != '\f' &&
                c != '\v') {
                blank = false;
                break;
            }
        }
        if (blank) continue;
        if (!encode_line(st, line, len, &label, ids, vals)) {
            bad++;
            continue;
        }
        if (!out || in_shard >= records_per_shard) {
            flush();
            if (out) std::fclose(out);
            std::snprintf(path, sizeof(path), "%s/%s-%05d.tfrecords",
                          output_dir, prefix, shard);
            out = std::fopen(path, "wb");
            if (!out) {
                set_err(err, err_cap, "cannot open output shard");
                std::free(line);
                std::fclose(in);
                return -1;
            }
            shard++;
            in_shard = 0;
        }
        serialize_example(st, label, ids, vals);
        frame_record(st);
        outbuf.append(st.framed);
        if (outbuf.size() >= (1 << 20)) flush();
        in_shard++;
        total++;
    }
    flush();
    if (out) std::fclose(out);
    std::fclose(in);
    std::free(line);
    if (bad) {
        // malformed lines are a data bug the caller must see, not silence
        char msg[128];
        std::snprintf(msg, sizeof(msg),
                      "%lld malformed line(s) skipped",
                      static_cast<long long>(bad));
        set_err(err, err_cap, msg);
    }
    return total;
}
