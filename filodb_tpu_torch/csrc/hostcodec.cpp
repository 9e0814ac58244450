// Host codec of the write path: NibblePack, the chunk vectors, the
// record-container scan, and the device-page block encoders. Plain C
// interface, loaded with ctypes.
//
// The byte formats are those of the JAX package's pure-Python codecs
// (filodb_tpu/memory/nibblepack.py, memory/codecs.py, memory/chunk.py,
// core/record.py, and the page layout of memory/device_pages.py), which
// filodb_tpu_torch/memory/nibblepack.py, codecs.py and device_pages.py
// copy as the twins the tests hold this file against. Every encoder writes
// the bytes those write, and every decoder reads them.
//
// Batched entries (fh_encode_chunks, fh_decode_vectors, the container scan)
// take offset arrays and one byte buffer, so that a flush of a million
// series is a few calls, not a few million. They run on the calling thread
// and touch no global state: the caller splits a batch over threads (ctypes
// releases the interpreter lock for the call).
//
// fh_summarize folds each chunk's values into the chunk summary of
// filodb_tpu/memory/chunk.py::summarize_values: every sum is accumulated
// left to right (np.cumsum's order), so the stats are bitwise the numpy
// function's; the library builds with -ffp-contract=off, so no sum or
// square is fused.
//
// fh_crc32c computes CRC32C (Castagnoli, reflected
// polynomial 0x82F63B78), the object store's segment and chunk checksums
// (filodb_tpu/core/store/objectstore.py::crc32c): SSE4.2's crc32
// instruction where the CPU has it, else a slice-by-8 table.
//
// Signed arithmetic that the numpy twins let wrap (predictions, residuals,
// bucket deltas) is done in uint64_t here, where wrapping is defined.

#include <cmath>
#include <cstdint>
#include <cstring>
#if defined(__x86_64__)
#include <nmmintrin.h>
#endif

namespace {

struct Crc32cTables {
    uint32_t t[8][256];
    Crc32cTables() {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i;
            for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
            t[0][i] = c;
        }
        for (int k = 1; k < 8; k++)
            for (int i = 0; i < 256; i++)
                t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
    }
};

const Crc32cTables crc_tables;

// crc is the running value before the final inversion
uint32_t crc32c_table(uint32_t crc, const uint8_t* p, int64_t n) {
    const auto& t = crc_tables.t;
    int64_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint32_t lo;
        std::memcpy(&lo, p + i, 4);
        crc ^= lo;
        crc = t[7][crc & 0xFF] ^ t[6][(crc >> 8) & 0xFF] ^ t[5][(crc >> 16) & 0xFF]
            ^ t[4][crc >> 24] ^ t[3][p[i + 4]] ^ t[2][p[i + 5]] ^ t[1][p[i + 6]]
            ^ t[0][p[i + 7]];
    }
    for (; i < n; i++) crc = t[0][(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
    return crc;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2")))
uint32_t crc32c_hw(uint32_t crc, const uint8_t* p, int64_t n) {
    uint64_t c = crc;
    int64_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t w;
        std::memcpy(&w, p + i, 8);
        c = _mm_crc32_u64(c, w);
    }
    uint32_t c32 = static_cast<uint32_t>(c);
    for (; i < n; i++) c32 = _mm_crc32_u8(c32, p[i]);
    return c32;
}

const bool have_sse42 = __builtin_cpu_supports("sse4.2");
#endif

uint32_t crc32c(uint32_t crc, const uint8_t* p, int64_t n) {
    crc ^= 0xFFFFFFFFu;
#if defined(__x86_64__)
    crc = have_sse42 ? crc32c_hw(crc, p, n) : crc32c_table(crc, p, n);
#else
    crc = crc32c_table(crc, p, n);
#endif
    return crc ^ 0xFFFFFFFFu;
}

inline uint64_t zigzag(int64_t v) {
    return (static_cast<uint64_t>(v) << 1) ^ static_cast<uint64_t>(v >> 63);
}

inline int64_t unzigzag(uint64_t u) {
    return static_cast<int64_t>(u >> 1) ^ -static_cast<int64_t>(u & 1);
}

inline int nibble_width(uint64_t x) {
    return x == 0 ? 1 : (64 - __builtin_clzll(x) + 3) / 4;
}

inline int trailing_zero_nibbles(uint64_t x) {
    return x == 0 ? 16 : __builtin_ctzll(x) / 4;
}

// Python's floor division of int64 values (the dd slope).
inline int64_t floor_div(int64_t a, int64_t b) {
    int64_t q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
    return q;
}

// NibblePack of n values from a value source get(i); returns bytes written.
template <typename Get>
int64_t pack(Get get, int64_t n, uint8_t* out) {
    uint8_t* p = out;
    for (int64_t g = 0; g < n; g += 8) {
        uint64_t group[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        int64_t cnt = (n - g) < 8 ? (n - g) : 8;
        for (int64_t i = 0; i < cnt; i++) group[i] = get(g + i);
        uint8_t bitmap = 0;
        for (int i = 0; i < 8; i++)
            if (group[i]) bitmap |= static_cast<uint8_t>(1u << i);
        *p++ = bitmap;
        if (!bitmap) continue;
        int tz = 16, lead = 1;
        for (int i = 0; i < 8; i++) {
            if (!group[i]) continue;
            int t = trailing_zero_nibbles(group[i]);
            if (t < tz) tz = t;
            int w = nibble_width(group[i]);
            if (w > lead) lead = w;
        }
        int nn = lead - tz;
        *p++ = static_cast<uint8_t>(((nn - 1) << 4) | tz);
        unsigned __int128 acc = 0;
        int bits = 0;
        uint64_t mask = nn >= 16 ? ~0ULL : ((1ULL << (4 * nn)) - 1);
        for (int i = 0; i < 8; i++) {
            if (!group[i]) continue;
            acc |= static_cast<unsigned __int128>((group[i] >> (4 * tz)) & mask)
                   << bits;
            bits += 4 * nn;
            while (bits >= 8) {
                *p++ = static_cast<uint8_t>(acc & 0xFF);
                acc >>= 8;
                bits -= 8;
            }
        }
        if (bits > 0) *p++ = static_cast<uint8_t>(acc & 0xFF);
    }
    return p - out;
}

// Unpack count values into put(i, v); returns bytes consumed, -1 if the
// input ends early.
template <typename Put>
int64_t unpack(const uint8_t* in, int64_t len, int64_t count, Put put) {
    const uint8_t* p = in;
    const uint8_t* end = in + len;
    int64_t idx = 0;
    while (idx < count) {
        if (p >= end) return -1;
        uint8_t bitmap = *p++;
        if (!bitmap) {
            for (int i = 0; i < 8 && idx + i < count; i++) put(idx + i, 0);
            idx += 8;
            continue;
        }
        if (p >= end) return -1;
        uint8_t desc = *p++;
        int nn = (desc >> 4) + 1;
        int tz = desc & 0xF;
        int64_t nbytes = (static_cast<int64_t>(__builtin_popcount(bitmap)) * nn
                          + 1) / 2;
        if (p + nbytes > end) return -1;
        uint64_t mask = nn >= 16 ? ~0ULL : ((1ULL << (4 * nn)) - 1);
        unsigned __int128 acc = 0;
        int bits = 0;
        const uint8_t* q = p;
        for (int i = 0; i < 8; i++) {
            uint64_t v = 0;
            if (bitmap & (1u << i)) {
                while (bits < 4 * nn && q < p + nbytes) {
                    acc |= static_cast<unsigned __int128>(*q++) << bits;
                    bits += 8;
                }
                v = (static_cast<uint64_t>(acc) & mask) << (4 * tz);
                acc >>= 4 * nn;
                bits -= 4 * nn;
            }
            if (idx + i < count) put(idx + i, v);
        }
        p += nbytes;
        idx += 8;
    }
    return p - in;
}

template <typename T>
inline uint8_t* put_le(uint8_t* p, T v) {
    std::memcpy(p, &v, sizeof(T));
    return p + sizeof(T);
}

template <typename T>
inline T get_le(const uint8_t* p) {
    T v;
    std::memcpy(&v, p, sizeof(T));
    return v;
}

constexpr uint8_t kDeltaDelta = 1, kDeltaDeltaConst = 2, kXorDouble = 3,
                  kHist2D = 4, kRawDouble = 6, kConstDouble = 8;
constexpr int64_t kDDHead = 1 + 4 + 8 + 8;  // <BIqq
constexpr int64_t kChunkHead = 8 + 4 + 8 + 8 + 4;  // <qIqqI

// codecs.encode_delta_delta of v[0..n), n >= 1
uint8_t* encode_dd(const int64_t* v, int64_t n, uint8_t* p) {
    int64_t base = v[0];
    int64_t slope = n > 1 ? floor_div(v[n - 1] - base, n - 1) : 0;
    auto resid = [&](int64_t i) {
        uint64_t pred = static_cast<uint64_t>(base)
                        + static_cast<uint64_t>(slope) * static_cast<uint64_t>(i);
        return static_cast<int64_t>(static_cast<uint64_t>(v[i]) - pred);
    };
    bool any = false;
    for (int64_t i = 0; i < n && !any; i++) any = resid(i) != 0;
    p = put_le<uint8_t>(p, any ? kDeltaDelta : kDeltaDeltaConst);
    p = put_le<uint32_t>(p, static_cast<uint32_t>(n));
    p = put_le<int64_t>(p, base);
    p = put_le<int64_t>(p, slope);
    if (any) p += pack([&](int64_t i) { return zigzag(resid(i)); }, n, p);
    return p;
}

// codecs.encode_double of v[0..n): const when every bit pattern is equal
uint8_t* encode_double(const double* v, int64_t n, uint8_t* p) {
    auto bits = [&](int64_t i) { return get_le<uint64_t>(
        reinterpret_cast<const uint8_t*>(v + i)); };
    bool same = true;
    for (int64_t i = 1; i < n && same; i++) same = bits(i) == bits(0);
    if (n > 0 && same) {
        p = put_le<uint8_t>(p, kConstDouble);
        p = put_le<uint32_t>(p, static_cast<uint32_t>(n));
        return put_le<uint64_t>(p, bits(0));
    }
    p = put_le<uint8_t>(p, kXorDouble);
    p = put_le<uint32_t>(p, static_cast<uint32_t>(n));
    return p + pack([&](int64_t i) {
        return bits(i) ^ (i ? bits(i - 1) : 0ULL); }, n, p);
}

// codecs.encode_hist_2d_delta of rows r [n, nb] (row stride rs) and les
uint8_t* encode_hist(const int64_t* r, int64_t rs, int64_t n, int64_t nb,
                     const double* les, uint8_t* p) {
    p = put_le<uint8_t>(p, kHist2D);
    p = put_le<uint32_t>(p, static_cast<uint32_t>(n));
    p = put_le<uint32_t>(p, static_cast<uint32_t>(nb));
    std::memcpy(p, les, 8 * nb);
    p += 8 * nb;
    if (n == 0) return p;
    auto at = [&](int64_t i, int64_t j) {
        return static_cast<uint64_t>(r[i * rs + j]); };
    auto bucket = [&](int64_t i, int64_t j) {
        return j ? at(i, j) - at(i, j - 1) : at(i, 0); };
    return p + pack([&](int64_t k) {
        int64_t i = k / nb, j = k % nb;
        uint64_t d = i ? bucket(i, j) - bucket(i - 1, j) : bucket(0, j);
        return zigzag(static_cast<int64_t>(d));
    }, n * nb, p);
}

// Lane i's w-bit field at bits [i*w, i*w + w) of 128 u32 words (the words
// past 4*w stay 0).
inline void pack_block(const uint32_t* f, int w, uint32_t* out) {
    std::memset(out, 0, 128 * sizeof(uint32_t));
    if (w == 0) return;
    for (int64_t i = 0; i < 128; i++) {
        const uint64_t field = static_cast<uint64_t>(f[i])
                               << ((i * w) & 31);
        const int64_t word = (i * w) >> 5;
        out[word] |= static_cast<uint32_t>(field);
        if ((field >> 32) && word + 1 < 128)
            out[word + 1] |= static_cast<uint32_t>(field >> 32);
    }
}

}  // namespace

extern "C" {

int64_t fh_nibble_pack(const uint64_t* vals, int64_t n, uint8_t* out) {
    return pack([&](int64_t i) { return vals[i]; }, n, out);
}

int64_t fh_nibble_unpack(const uint8_t* in, int64_t len, uint64_t* out,
                         int64_t count) {
    return unpack(in, len, count, [&](int64_t i, uint64_t v) { out[i] = v; });
}

// Serialized chunks (Chunk.serialize, no summary section) of C chunks:
// timestamps ts [C, M], K double columns dcols [C, K, M], and with B > 0 a
// histogram column hist [C, M, hs] (buckets in the first B of hs slots)
// under bounds les [C, B]; chunk c holds rows[c] samples and has id ids[c].
// Chunk c is written at out + offs[c], offs[c + 1] its end; vbytes[c] is
// the sum of its vectors' lengths (Chunk.nbytes). Returns 0, or -1 when a
// chunk would pass cap.
int64_t fh_encode_chunks(const int64_t* ts, const double* dcols, int64_t K,
                         const int64_t* hist, int64_t hs, const double* les,
                         int64_t B, const int64_t* rows, const int64_t* ids,
                         int64_t C, int64_t M, uint8_t* out, int64_t cap,
                         int64_t* offs, int64_t* vbytes) {
    const int64_t nvec = 1 + K + (B > 0 ? 1 : 0);
    uint8_t* p = out;
    offs[0] = 0;
    for (int64_t c = 0; c < C; c++) {
        const int64_t n = rows[c];
        const int64_t groups = (n + 8 - 1) / 8, hgroups = (n * B + 7) / 8;
        const int64_t bound = kChunkHead + 4 * nvec + kDDHead + 66 * groups
            + K * (5 + 66 * groups) + (B > 0 ? 9 + 8 * B + 66 * hgroups : 0);
        if ((p - out) + bound > cap) return -1;
        const int64_t* t = ts + c * M;
        uint8_t* head = p;
        p = put_le<int64_t>(p, ids[c]);
        p = put_le<uint32_t>(p, static_cast<uint32_t>(n));
        p = put_le<int64_t>(p, t[0]);
        p = put_le<int64_t>(p, t[n - 1]);
        p = put_le<uint32_t>(p, static_cast<uint32_t>(nvec));
        for (int64_t v = 0; v < nvec; v++) {
            uint8_t* len_at = p;
            p += 4;
            if (v == 0) {
                p = encode_dd(t, n, p);
            } else if (v <= K) {
                p = encode_double(dcols + (c * K + v - 1) * M, n, p);
            } else {
                p = encode_hist(hist + c * M * hs, hs, n, B, les + c * B, p);
            }
            put_le<uint32_t>(len_at, static_cast<uint32_t>(p - len_at - 4));
        }
        offs[c + 1] = p - out;
        vbytes[c] = (p - head) - kChunkHead - 4 * nvec;
    }
    return 0;
}

// Vector layout of C serialized chunks at buf + starts[c] .. ends[c]:
// hdr[c] = (id, rows, start, end, nvec), and the offset and length of each
// of the first maxv vectors. Returns 0, or c + 1 for a malformed chunk c.
int64_t fh_chunk_layout(const uint8_t* buf, const int64_t* starts,
                        const int64_t* ends, int64_t C, int64_t maxv,
                        int64_t* hdr, int64_t* voff, int64_t* vlen) {
    for (int64_t c = 0; c < C; c++) {
        const uint8_t* p = buf + starts[c];
        const uint8_t* end = buf + ends[c];
        if (end - p < kChunkHead) return c + 1;
        hdr[5 * c] = get_le<int64_t>(p);
        hdr[5 * c + 1] = get_le<uint32_t>(p + 8);
        hdr[5 * c + 2] = get_le<int64_t>(p + 12);
        hdr[5 * c + 3] = get_le<int64_t>(p + 20);
        int64_t nvec = get_le<uint32_t>(p + 28);
        hdr[5 * c + 4] = nvec;
        p += kChunkHead;
        for (int64_t v = 0; v < nvec; v++) {
            if (end - p < 4) return c + 1;
            int64_t len = get_le<uint32_t>(p);
            p += 4;
            if (end - p < len) return c + 1;
            if (v < maxv) {
                voff[c * maxv + v] = p - buf;
                vlen[c * maxv + v] = len;
            }
            p += len;
        }
    }
    return 0;
}

// Decode one vector of each of C chunks (at buf + voff[c], vlen[c] bytes)
// into out + c * stride (8-byte elements): timestamps and longs (codecs 1,
// 2) as int64, doubles (3, 6, 8) as float64, histograms (4) as int64 rows
// [n, nb] with nb given. n[c] gets the vector's row count. Returns 0, or
// c + 1 for a vector that is malformed, of another codec family than the
// first, longer than stride allows, or of another bucket count.
int64_t fh_decode_vectors(const uint8_t* buf, const int64_t* voff,
                          const int64_t* vlen, int64_t C, uint8_t* out,
                          int64_t stride, int64_t nb, int64_t* n_out) {
    for (int64_t c = 0; c < C; c++) {
        const uint8_t* d = buf + voff[c];
        const int64_t len = vlen[c];
        if (len < 5) return c + 1;
        const uint8_t codec = d[0];
        const int64_t n = get_le<uint32_t>(d + 1);
        n_out[c] = n;
        uint64_t* o = reinterpret_cast<uint64_t*>(out) + c * stride;
        if (codec == kDeltaDelta || codec == kDeltaDeltaConst) {
            if (len < kDDHead || n > stride) return c + 1;
            uint64_t base = get_le<uint64_t>(d + 5);
            uint64_t slope = get_le<uint64_t>(d + 13);
            for (int64_t i = 0; i < n; i++)
                o[i] = base + slope * static_cast<uint64_t>(i);
            if (codec == kDeltaDelta
                && unpack(d + kDDHead, len - kDDHead, n,
                          [&](int64_t i, uint64_t v) {
                              o[i] += static_cast<uint64_t>(unzigzag(v)); })
                   < 0)
                return c + 1;
        } else if (codec == kXorDouble) {
            if (n > stride) return c + 1;
            uint64_t acc = 0;
            if (unpack(d + 5, len - 5, n, [&](int64_t i, uint64_t v) {
                    acc ^= v;
                    o[i] = acc; }) < 0)
                return c + 1;
        } else if (codec == kConstDouble) {
            if (len < 13 || n > stride) return c + 1;
            uint64_t v = get_le<uint64_t>(d + 5);
            for (int64_t i = 0; i < n; i++) o[i] = v;
        } else if (codec == kRawDouble) {
            if (len < 5 + 8 * n || n > stride) return c + 1;
            std::memcpy(o, d + 5, 8 * n);
        } else if (codec == kHist2D) {
            if (len < 9) return c + 1;
            int64_t hb = get_le<uint32_t>(d + 5);
            if (hb != nb || n * nb > stride || len < 9 + 8 * nb) return c + 1;
            const uint8_t* q = d + 9 + 8 * nb;
            if (n && unpack(q, d + len - q, n * nb,
                            [&](int64_t k, uint64_t v) {
                                o[k] = static_cast<uint64_t>(unzigzag(v)); })
                         < 0)
                return c + 1;
            // time deltas -> bucket deltas (down the rows) -> cumulative
            for (int64_t i = 1; i < n; i++)
                for (int64_t j = 0; j < nb; j++) o[i * nb + j] += o[(i - 1) * nb + j];
            for (int64_t i = 0; i < n; i++)
                for (int64_t j = 1; j < nb; j++) o[i * nb + j] += o[i * nb + j - 1];
        } else {
            return c + 1;
        }
    }
    return 0;
}

// Scan a version-2 record container (core/record.py's layout) of len
// bytes holding n records: per record its part hash, timestamp, schema id,
// label section (offset, length: from its u16 count), and values (offset
// of the u8 count, the count). Returns 0, or -1 if malformed.
int64_t fh_container_scan(const uint8_t* raw, int64_t len, int64_t n,
                          uint32_t* hash, int64_t* ts, int32_t* sid,
                          int64_t* lab_off, int64_t* lab_len, int64_t* val_off,
                          int32_t* nvals) {
    int64_t off = 5;
    for (int64_t r = 0; r < n; r++) {
        if (len - off < 4) return -1;
        int64_t rec_len = get_le<uint32_t>(raw + off);
        off += 4;
        const int64_t end = off + rec_len;
        if (end > len || rec_len < 14 + 2 + 1) return -1;
        hash[r] = get_le<uint32_t>(raw + off);
        ts[r] = get_le<int64_t>(raw + off + 4);
        sid[r] = get_le<uint16_t>(raw + off + 12);
        int64_t p = off + 14;
        lab_off[r] = p;
        int64_t nl = get_le<uint16_t>(raw + p);
        p += 2;
        for (int64_t l = 0; l < 2 * nl; l++) {
            if (end - p < 2) return -1;
            p += 2 + get_le<uint16_t>(raw + p);
        }
        if (end - p < 1) return -1;
        lab_len[r] = p - lab_off[r];
        val_off[r] = p;
        nvals[r] = raw[p];
        p += 1;
        for (int64_t v = 0; v < nvals[r]; v++) {
            if (end - p < 1) return -1;
            int64_t size = raw[p] == 0 ? 9 : -1;
            if (raw[p] == 1 && end - p >= 3)
                size = 3 + 16 * static_cast<int64_t>(get_le<uint16_t>(raw + p + 1));
            if (size < 0 || end - p < size) return -1;
            p += size;
        }
        if (p != end) return -1;
        off = end;
    }
    return off == len ? 0 : -1;
}

// The values of n scanned records: the first nd double values (tag 0) of
// each into dvals [n, nd] in order (NaN where a record has fewer), and the
// offset of its first histogram value's bucket count (tag 1: u16 nb, then
// les f64 * nb and counts i64 * nb) into hist_off (-1: none).
void fh_container_values(const uint8_t* raw, const int64_t* val_off,
                         const int32_t* nvals, int64_t n, double* dvals,
                         int64_t nd, int64_t* hist_off) {
    const uint64_t nan_bits = 0x7FF8000000000000ULL;
    for (int64_t r = 0; r < n; r++) {
        int64_t p = val_off[r] + 1, k = 0;
        hist_off[r] = -1;
        for (int64_t j = 0; j < nd; j++)
            std::memcpy(dvals + r * nd + j, &nan_bits, 8);
        for (int64_t v = 0; v < nvals[r]; v++) {
            if (raw[p] == 0) {
                if (k < nd) std::memcpy(dvals + r * nd + k++, raw + p + 1, 8);
                p += 9;
            } else {
                if (hist_off[r] < 0) hist_off[r] = p + 1;
                p += 3 + 16 * static_cast<int64_t>(get_le<uint16_t>(raw + p + 1));
            }
        }
    }
}

// Part-key blobs (PartKey.serialized: schema, then "\0k\1v" a label) of n
// scanned records, the schema name of record r being names[name_off[s] ..
// name_off[s + 1]) for s = name_idx[r]. Blob r is out[out_off[r] ..
// out_off[r + 1]). Returns 0, or -1 when out would pass cap.
int64_t fh_container_keys(const uint8_t* raw, const int64_t* lab_off,
                          const int32_t* name_idx, int64_t n,
                          const uint8_t* names, const int64_t* name_off,
                          uint8_t* out, int64_t cap, int64_t* out_off) {
    int64_t o = 0;
    out_off[0] = 0;
    for (int64_t r = 0; r < n; r++) {
        const int64_t s = name_idx[r];
        const int64_t nlen = name_off[s + 1] - name_off[s];
        int64_t p = lab_off[r];
        const int64_t nl = get_le<uint16_t>(raw + p);
        p += 2;
        if (o + nlen > cap) return -1;
        std::memcpy(out + o, names + name_off[s], nlen);
        o += nlen;
        for (int64_t l = 0; l < nl; l++) {
            int64_t kl = get_le<uint16_t>(raw + p);
            int64_t vl = get_le<uint16_t>(raw + p + 2 + kl);
            if (o + 2 + kl + vl > cap) return -1;
            out[o++] = 0;
            std::memcpy(out + o, raw + p + 2, kl);
            o += kl;
            out[o++] = 1;
            std::memcpy(out + o, raw + p + 4 + kl, vl);
            o += vl;
            p += 4 + kl + vl;
        }
        out_off[r + 1] = o;
    }
    return 0;
}

// Device-page blocks (memory/device_pages.py::encode_ts_blocks): 128-lane
// blocks of int64 ts [nb, 128], n[b] valid lanes each. A block's base is
// its first value, its slope (last - base) // (n - 1) (floor), stored as
// int32 with wrap-around; lane i's zigzag residual against base + slope*i
// (in int64) is packed at bits [i*w, i*w + w) of the block's 128 u32
// words, w the bit length of the block's largest residual. Returns 0, or
// b + 1 for a block whose residual needs more than 32 bits.
int64_t fh_encode_ts_blocks(const int64_t* ts, const int64_t* n, int64_t nb,
                            int64_t* base, int32_t* slope, int32_t* width,
                            uint32_t* words) {
    for (int64_t b = 0; b < nb; b++) {
        const int64_t* t = ts + b * 128;
        const int64_t m = n[b];
        int64_t b0 = m > 0 ? t[0] : 0;
        int64_t last = t[m > 0 ? m - 1 : 0];
        int64_t sl = m > 0 ? floor_div(static_cast<int64_t>(
            static_cast<uint64_t>(last) - static_cast<uint64_t>(b0)),
            m > 1 ? m - 1 : 1) : 0;
        uint32_t zz[128];
        uint32_t mx = 0;
        for (int64_t i = 0; i < 128; i++) {
            uint64_t z = 0;
            if (i < m) {
                uint64_t pred = static_cast<uint64_t>(b0)
                    + static_cast<uint64_t>(sl) * static_cast<uint64_t>(i);
                z = zigzag(static_cast<int64_t>(
                    static_cast<uint64_t>(t[i]) - pred));
                if (z >> 32) return b + 1;
            }
            zz[i] = static_cast<uint32_t>(z);
            mx |= zz[i];
        }
        base[b] = b0;
        slope[b] = static_cast<int32_t>(static_cast<uint32_t>(sl));
        width[b] = mx ? 32 - __builtin_clz(mx) : 0;
        pack_block(zz, width[b], words + b * 128);
    }
    return 0;
}

// memory/device_pages.py::encode_f32_blocks: float32 bit patterns [nb,
// 128], n[b] valid lanes. A block keeps its first value's bits; lane i's
// bits XOR the first, shifted right by the least trailing-zero count of
// the block's nonzero fields (32 when all are 0; 0 for an empty block), is
// packed as encode_ts_blocks packs.
void fh_encode_f32_blocks(const uint32_t* bits, const int64_t* n, int64_t nb,
                          uint32_t* first, int32_t* shift, int32_t* width,
                          uint32_t* words) {
    for (int64_t b = 0; b < nb; b++) {
        const uint32_t* v = bits + b * 128;
        const int64_t m = n[b];
        uint32_t f = m > 0 ? v[0] : 0, x[128], any = 0;
        for (int64_t i = 0; i < 128; i++) {
            x[i] = i < m ? v[i] ^ f : 0;
            any |= x[i];
        }
        int tz = any ? __builtin_ctz(any) : 32;
        uint32_t mx = 0;
        for (int64_t i = 0; i < 128; i++) {
            x[i] = tz < 32 ? x[i] >> tz : x[i];
            mx |= x[i];
        }
        first[b] = f;
        shift[b] = m > 0 ? tz : 0;
        width[b] = mx ? 32 - __builtin_clz(mx) : 0;
        pack_block(x, width[b], words + b * 128);
    }
}

// Chunk summaries (memory/chunk.py's twelve slots and log2 sketch) of C
// chunks: chunk c's samples are ts[c * ts_row + i] and
// vals[c * v_row + i * v_step] for i < rows[c]. NaN samples are left out.
// flags[c] is 1 where the chunk's kept values hold both +0.0 and -0.0, so
// that its min or max may be either zero: the caller takes those from
// numpy, whose choice among equal values depends on its reduction order.
int64_t fh_summarize(const int64_t* ts, int64_t ts_row, const double* vals,
                     int64_t v_row, int64_t v_step, const int64_t* rows,
                     int64_t C, double* stats, uint16_t* sketch,
                     int64_t* flags) {
    for (int64_t c = 0; c < C; c++) {
        const int64_t* t = ts + c * ts_row;
        const double* v = vals + c * v_row;
        double* st = stats + c * 12;
        uint16_t* sk = sketch + c * 64;
        std::memset(sk, 0, 64 * sizeof(uint16_t));
        for (int k = 0; k < 12; k++) st[k] = 0.0;
        int64_t n = 0, resets = 0, changes = 0;
        double sum = 0, sumsq = 0, mn = 0, mx = 0, corr = 0, prev = 0;
        bool pz = false, nz = false;
        for (int64_t i = 0; i < rows[c]; i++) {
            double x = v[i * v_step];
            if (std::isnan(x)) continue;
            if (n == 0) {
                sum = x;
                sumsq = x * x;
                mn = mx = x;
                st[5] = static_cast<double>(t[i]);
                st[6] = x;
            } else {
                sum = sum + x;
                sumsq = sumsq + x * x;
                if (x < mn) mn = x;
                if (x > mx) mx = x;
                bool drop = x < prev;
                double w = drop ? prev : 0.0;
                corr = n == 1 ? w : corr + w;
                resets += drop;
                changes += x != prev;
            }
            if (x == 0) {
                if (std::signbit(x)) nz = true; else pz = true;
            }
            st[7] = static_cast<double>(t[i]);
            st[8] = x;
            prev = x;
            n++;
            // frexp's exponent, read from the bits where x is normal
            uint64_t bits;
            std::memcpy(&bits, &x, 8);
            int ex = static_cast<int>((bits >> 52) & 0x7FF);
            int e = 0;
            if (ex == 0) std::frexp(x, &e);
            else if (ex != 0x7FF) e = ex - 1022;
            int mag = e - 1 + 16;
            mag = mag < 0 ? 0 : (mag > 30 ? 30 : mag);
            sk[x == 0 ? 32 : (x > 0 ? 33 + mag : 31 - mag)]++;
        }
        flags[c] = pz && nz;
        if (n == 0) {
            for (int k = 3; k <= 8; k++) st[k] = NAN;
            continue;
        }
        st[0] = static_cast<double>(n);
        st[1] = sum;
        st[2] = sumsq;
        st[3] = mn;
        st[4] = mx;
        st[9] = static_cast<double>(resets);
        st[10] = corr;
        st[11] = static_cast<double>(changes);
    }
    return 0;
}

// CRC32C of n bytes, continuing from crc (0 to start).
int64_t fh_crc32c(const uint8_t* data, int64_t n, int64_t crc) {
    return crc32c(static_cast<uint32_t>(crc), data, n);
}

}  // extern "C"
