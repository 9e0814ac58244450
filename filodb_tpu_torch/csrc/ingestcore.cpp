// The ingest core of a shard's write path, on the host: the part-key map,
// the container pass that routes, deduplicates and appends scalar records
// one sample at a time into the write buffers, the buffers' append of
// whole rows of samples, and the sidecar lane's write-buffer window fold.
// Plain C interface, loaded with ctypes.
//
// Port of the shard core of native/filodb_native.cpp (shard_core_ingest,
// the part-key map of shard_core_lookup / shard_core_create_part /
// shard_core_bootstrap, part_append, shard_buf_fold) onto the port's
// columnar write path. The write buffers are rows of [rows, M] arrays that
// the caller owns (filodb_tpu_torch/core/memstore/partition.py's
// WriteBuffers) and reserves before each call: nothing here grows an
// array. The per-partition state is the shard's per-pid arrays. New
// partitions, tenant quotas, sealing and histogram records stay with the
// caller: the container pass stops and says why, the caller acts, and the
// pass resumes at the same record.
//
// The map takes a part key's blob (PartKey.serialized: the schema name,
// then "\0k\1v" a label) to its pid. It hashes by murmur3-32 of the blob,
// which is the record's part hash (core/partkey.py), and compares bytes.
// The container pass probes with the record's part hash and, on a miss,
// with the blob's own hash, so a record whose hash field is wrong still
// finds its key.
//
// Every entry runs on the calling thread; the map is the caller's to lock
// (the shard's lock). The fold touches no shared state, so the caller may
// split it over threads (ctypes releases the interpreter lock).

#include <cstdint>
#include <cstring>
#include <limits>
#include <string>
#include <unordered_set>
#include <vector>

namespace {

template <typename T>
inline T get_le(const uint8_t* p) {
    T v;
    std::memcpy(&v, p, sizeof(T));
    return v;
}

inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// murmur3-32 (x86), seed 0: core/partkey.py's murmur3_32.
uint32_t murmur3_32(const uint8_t* d, int64_t n) {
    const uint32_t c1 = 0xCC9E2D51u, c2 = 0x1B873593u;
    uint32_t h = 0;
    const int64_t rounded = n - (n & 3);
    for (int64_t i = 0; i < rounded; i += 4) {
        uint32_t k = get_le<uint32_t>(d + i);
        k *= c1;
        k = rotl32(k, 15);
        k *= c2;
        h ^= k;
        h = rotl32(h, 13);
        h = h * 5 + 0xE6546B64u;
    }
    uint32_t k = 0;
    switch (n & 3) {
        case 3: k ^= static_cast<uint32_t>(d[rounded + 2]) << 16; [[fallthrough]];
        case 2: k ^= static_cast<uint32_t>(d[rounded + 1]) << 8; [[fallthrough]];
        case 1:
            k ^= d[rounded];
            k *= c1;
            k = rotl32(k, 15);
            k *= c2;
            h ^= k;
    }
    h ^= static_cast<uint32_t>(n);
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

constexpr int32_t EMPTY = -1;
constexpr int32_t TOMB = -2;

struct Slot {
    uint32_t hash;
    int32_t pid;   // EMPTY, TOMB, or the key's pid
    int64_t off;   // the key in the arena: u32 length, then its bytes
};

// Open addressing with linear probing, at most half full (tombstones
// included). Keys live in an append-only arena, compacted at each rehash.
struct KeyMap {
    std::vector<Slot> slots;
    std::vector<uint8_t> arena;
    int64_t live = 0, used = 0;

    bool same(const Slot& s, const uint8_t* k, uint32_t len) const {
        return get_le<uint32_t>(arena.data() + s.off) == len
            && std::memcmp(arena.data() + s.off + 4, k, len) == 0;
    }

    // the slot holding key k, or -1
    int64_t find(uint32_t h, const uint8_t* k, uint32_t len) const {
        if (slots.empty()) return -1;
        const size_t mask = slots.size() - 1;
        for (size_t i = h & mask;; i = (i + 1) & mask) {
            const Slot& s = slots[i];
            if (s.pid == EMPTY) return -1;
            if (s.pid != TOMB && s.hash == h && same(s, k, len))
                return static_cast<int64_t>(i);
        }
    }

    void rehash(size_t cap) {
        std::vector<Slot> old;
        old.swap(slots);
        std::vector<uint8_t> old_arena;
        old_arena.swap(arena);
        slots.assign(cap, Slot{0, EMPTY, 0});
        used = live = 0;
        for (const Slot& s : old)
            if (s.pid >= 0)
                place(s.hash, old_arena.data() + s.off + 4,
                      get_le<uint32_t>(old_arena.data() + s.off), s.pid);
    }

    // a key known to be absent
    void place(uint32_t h, const uint8_t* k, uint32_t len, int32_t pid) {
        const size_t mask = slots.size() - 1;
        size_t i = h & mask;
        while (slots[i].pid >= 0) i = (i + 1) & mask;
        if (slots[i].pid == EMPTY) used++;
        live++;
        const int64_t off = static_cast<int64_t>(arena.size());
        arena.resize(arena.size() + 4 + len);
        std::memcpy(arena.data() + off, &len, 4);
        std::memcpy(arena.data() + off + 4, k, len);
        slots[i] = Slot{h, pid, off};
    }

    void put(uint32_t h, const uint8_t* k, uint32_t len, int32_t pid) {
        const int64_t at = find(h, k, len);
        if (at >= 0) {
            slots[at].pid = pid;
            return;
        }
        if (2 * (used + 1) > static_cast<int64_t>(slots.size())) {
            size_t cap = 1024;
            while (cap < static_cast<size_t>(4 * (live + 1))) cap *= 2;
            rehash(cap);
        }
        place(h, k, len, pid);
    }

    void clear() {
        slots.clear();
        arena.clear();
        live = used = 0;
    }
};

struct Core {
    KeyMap map;
    std::vector<uint8_t> blob;  // the key of the record at hand
};

// pid of a key, or -1; h is tried first, then the blob's own hash
int64_t lookup(const KeyMap& m, uint32_t h, const uint8_t* k, uint32_t len) {
    int64_t at = m.find(h, k, len);
    if (at < 0) {
        const uint32_t own = murmur3_32(k, len);
        if (own != h) at = m.find(own, k, len);
    }
    return at < 0 ? -1 : m.slots[at].pid;
}

}  // namespace

// The state of one container's pass, shared with the caller: every field
// is 8 bytes (a pointer or an int64), in this order
// (core/memstore/native_shard.py's IngestCtl).
struct IngestCtl {
    // the container (core/record.py's version-2 layout) and its log offset
    const uint8_t* raw;
    int64_t len;
    int64_t nrec;
    int64_t offset;
    // a schema id's index in SCHEMA_NAMES (-1: unknown) [65536], and the
    // names, name s being names[name_off[s] .. name_off[s + 1])
    const int32_t* schema_index;
    const uint8_t* names;
    const int64_t* name_off;
    // the flush groups' watermarks: a record at or below its group's
    // (part hash % groups) is skipped
    const int64_t* watermarks;
    int64_t groups;
    // per partition: latest timestamp (the out-of-order floor), histogram
    int64_t* latest;
    const uint8_t* hist;
    // the scalar write buffers: ts, vals [cap, M], n [cap], slot [n_slot]
    // (a pid's row, -1 none), pid_of [cap], and the rows free to hand out:
    // free_rows[free_taken ..], then used .. cap - 1
    int64_t* buf_ts;
    double* buf_vals;
    int32_t* buf_n;
    int64_t* slot;
    int64_t n_slot;
    int64_t* pid_of;
    int64_t M;
    int64_t cap;
    int64_t used;
    const int64_t* free_rows;
    int64_t n_free;
    int64_t free_taken;
    // where the pass is: the next record and its byte offset; a record at
    // or past drop_from whose key the map lacks is dropped (its key was
    // refused a partition)
    int64_t rec;
    int64_t pos;
    int64_t drop_from;
    // out: rows that filled (to seal), histogram records and their pids,
    // dropped records, each [nrec]; and the counts
    int64_t* full_rows;
    int64_t n_full;
    int64_t* hist_rec;
    int64_t* hist_pid;
    int64_t n_hist;
    int64_t* drop_rec;
    int64_t n_drop;
    int64_t kept;      // samples appended
    int64_t skipped;   // records at or below their watermark
    int64_t scalars;   // scalar records of known partitions
    int64_t max_ts;    // largest timestamp appended (-1: none)
};

namespace {

enum Status : int64_t { DONE = 0, MISS = 1, FULL = 2, NO_ROW = 3 };

// One record's fields, from its byte offset (the container validated).
struct Rec {
    int64_t end;
    uint32_t hash;
    int64_t ts;
    int64_t sid;
    int64_t labels;  // offset of the u16 label count
    int64_t values;  // offset of the u8 value count
};

inline Rec read_rec(const uint8_t* d, int64_t pos) {
    Rec r;
    const int64_t body = pos + 4;
    r.end = body + get_le<uint32_t>(d + pos);
    r.hash = get_le<uint32_t>(d + body);
    r.ts = get_le<int64_t>(d + body + 4);
    r.sid = get_le<uint16_t>(d + body + 12);
    r.labels = body + 14;
    int64_t p = r.labels + 2;
    const int64_t nl = get_le<uint16_t>(d + r.labels);
    for (int64_t l = 0; l < 2 * nl; l++) p += 2 + get_le<uint16_t>(d + p);
    r.values = p;
    return r;
}

// the record's key blob into out; returns its length
uint32_t make_blob(const IngestCtl* c, const Rec& r, int64_t s,
                   std::vector<uint8_t>& out) {
    const uint8_t* d = c->raw;
    const int64_t nlen = c->name_off[s + 1] - c->name_off[s];
    out.resize(static_cast<size_t>(nlen + (r.values - r.labels)));
    uint8_t* o = out.data();
    std::memcpy(o, c->names + c->name_off[s], nlen);
    o += nlen;
    int64_t p = r.labels + 2;
    const int64_t nl = get_le<uint16_t>(d + r.labels);
    for (int64_t l = 0; l < nl; l++) {
        const int64_t kl = get_le<uint16_t>(d + p);
        const int64_t vl = get_le<uint16_t>(d + p + 2 + kl);
        *o++ = 0;
        std::memcpy(o, d + p + 2, kl);
        o += kl;
        *o++ = 1;
        std::memcpy(o, d + p + 4 + kl, vl);
        o += vl;
        p += 4 + kl + vl;
    }
    return static_cast<uint32_t>(o - out.data());
}

// the record's first double value (tag 0), NaN where it has none
inline double first_double(const uint8_t* d, const Rec& r) {
    int64_t p = r.values + 1;
    const int64_t nv = d[r.values];
    for (int64_t v = 0; v < nv; v++) {
        if (d[p] == 0) return get_le<double>(d + p + 1);
        p += 3 + 16 * static_cast<int64_t>(get_le<uint16_t>(d + p + 1));
    }
    return std::numeric_limits<double>::quiet_NaN();
}

// a record of a known schema above its watermark: its schema index, else -1
// (counting a skip)
inline int64_t admitted(IngestCtl* c, const Rec& r, bool count) {
    const int64_t g = static_cast<int64_t>(r.hash % static_cast<uint32_t>(c->groups));
    if (c->offset <= c->watermarks[g]) {
        if (count) c->skipped++;
        return -1;
    }
    return c->schema_index[r.sid];
}

}  // namespace

extern "C" {

void* ic_new() { return new Core(); }

void ic_free(void* h) { delete static_cast<Core*>(h); }

int64_t ic_size(void* h) { return static_cast<Core*>(h)->map.live; }

void ic_clear(void* h) { static_cast<Core*>(h)->map.clear(); }

// pids of n keys, key i being buf[off[i] .. off[i + 1]); -1 where absent
void ic_lookup(void* h, const uint8_t* buf, const int64_t* off, int64_t n,
               int64_t* pids) {
    const KeyMap& m = static_cast<Core*>(h)->map;
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* k = buf + off[i];
        const uint32_t len = static_cast<uint32_t>(off[i + 1] - off[i]);
        const int64_t at = m.find(murmur3_32(k, len), k, len);
        pids[i] = at < 0 ? -1 : m.slots[at].pid;
    }
}

// key i now maps to pids[i]; keys with live[i] == 0 are passed over (live
// may be null: every key). One call loads a restored registry.
void ic_insert(void* h, const uint8_t* buf, const int64_t* off, int64_t n,
               const int64_t* pids, const uint8_t* live) {
    KeyMap& m = static_cast<Core*>(h)->map;
    for (int64_t i = 0; i < n; i++) {
        if (live != nullptr && !live[i]) continue;
        const uint8_t* k = buf + off[i];
        const uint32_t len = static_cast<uint32_t>(off[i + 1] - off[i]);
        m.put(murmur3_32(k, len), k, len, static_cast<int32_t>(pids[i]));
    }
}

// forget key i where it maps to pids[i] (a series that came back holds its
// key under a new pid); returns the keys forgotten
int64_t ic_erase(void* h, const uint8_t* buf, const int64_t* off, int64_t n,
                 const int64_t* pids) {
    KeyMap& m = static_cast<Core*>(h)->map;
    int64_t gone = 0;
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* k = buf + off[i];
        const uint32_t len = static_cast<uint32_t>(off[i + 1] - off[i]);
        const int64_t at = m.find(murmur3_32(k, len), k, len);
        if (at >= 0 && m.slots[at].pid == pids[i]) {
            m.slots[at].pid = TOMB;
            m.live--;
            gone++;
        }
    }
    return gone;
}

// Check a version-2 container of len bytes and nrec records: every record
// within bounds, its labels and values well formed, tags 0 and 1 only.
// Returns 0, or -1 if malformed (nothing is then ingested).
int64_t ic_validate(const uint8_t* d, int64_t len, int64_t nrec) {
    int64_t off = 5;
    for (int64_t r = 0; r < nrec; r++) {
        if (len - off < 4) return -1;
        const int64_t end = off + 4 + get_le<uint32_t>(d + off);
        off += 4;
        if (end > len || end - off < 14 + 2 + 1) return -1;
        int64_t p = off + 14;
        const int64_t nl = get_le<uint16_t>(d + p);
        p += 2;
        for (int64_t l = 0; l < 2 * nl; l++) {
            if (end - p < 2) return -1;
            p += 2 + get_le<uint16_t>(d + p);
        }
        if (end - p < 1) return -1;
        const int64_t nv = d[p];
        p += 1;
        for (int64_t v = 0; v < nv; v++) {
            if (end - p < 1) return -1;
            int64_t size = d[p] == 0 ? 9 : -1;
            if (d[p] == 1 && end - p >= 3)
                size = 3 + 16 * static_cast<int64_t>(get_le<uint16_t>(d + p + 1));
            if (size < 0 || end - p < size) return -1;
            p += size;
        }
        if (p != end) return -1;
        off = end;
    }
    return off == len ? 0 : -1;
}

// The container pass, from record c->rec (at byte c->pos) on, in container
// order. A record at or below its group's watermark is skipped and
// counted; one of an unknown schema is dropped; its key is looked up (a
// key the map lacks stops the pass with MISS, or before drop_from, or is
// dropped and listed in drop_rec at or past it); a histogram partition's
// record is listed for the caller; a scalar record at or below its
// partition's latest timestamp is dropped; else its sample is appended at
// (slot[pid], n[row]), a row handed out where the partition has none
// (NO_ROW when none is free), and latest, max_ts and kept move. A row that
// fills is listed in full_rows; a record whose row is full stops the pass
// with FULL (the caller seals the listed rows and resumes).
int64_t ic_ingest(void* h, IngestCtl* c) {
    Core* core = static_cast<Core*>(h);
    const uint8_t* d = c->raw;
    const int64_t M = c->M;
    for (; c->rec < c->nrec; c->rec++) {
        const Rec r = read_rec(d, c->pos);
        const int64_t s = admitted(c, r, true);
        if (s < 0) {
            c->pos = r.end;
            continue;
        }
        const uint32_t len = make_blob(c, r, s, core->blob);
        const int64_t pid = lookup(core->map, r.hash, core->blob.data(), len);
        if (pid < 0) {
            if (c->rec < c->drop_from) return MISS;
            c->drop_rec[c->n_drop++] = c->rec;
            c->pos = r.end;
            continue;
        }
        if (c->hist[pid]) {
            c->hist_rec[c->n_hist] = c->rec;
            c->hist_pid[c->n_hist++] = pid;
            c->pos = r.end;
            continue;
        }
        c->scalars++;
        if (r.ts <= c->latest[pid]) {
            c->pos = r.end;
            continue;
        }
        int64_t row = c->slot[pid];
        if (row < 0) {
            if (c->free_taken < c->n_free) {
                row = c->free_rows[c->free_taken++];
            } else if (c->used < c->cap) {
                row = c->used++;
            } else {
                c->scalars--;
                return NO_ROW;
            }
            c->slot[pid] = row;
            c->pid_of[row] = pid;
        }
        const int64_t n = c->buf_n[row];
        if (n >= M) {
            c->scalars--;
            return FULL;
        }
        c->buf_ts[row * M + n] = r.ts;
        c->buf_vals[row * M + n] = first_double(d, r);
        c->buf_n[row] = static_cast<int32_t>(n + 1);
        if (n + 1 == M) c->full_rows[c->n_full++] = row;
        c->latest[pid] = r.ts;
        if (r.ts > c->max_ts) c->max_ts = r.ts;
        c->kept++;
        c->pos = r.end;
    }
    return DONE;
}

// The keys the map lacks among the records from c->rec on that the pass
// admits (known schema, above their watermark), each once, in the order of
// its first record: that record's index and timestamp, and the key's blob
// (blob k is blobs[blob_off[k] .. blob_off[k + 1]); the caller gives room
// for len + nrec * the longest schema name bytes). Returns their number.
int64_t ic_misses(void* h, IngestCtl* c, int64_t* rec_out, int64_t* ts_out,
                  uint8_t* blobs, int64_t* blob_off) {
    Core* core = static_cast<Core*>(h);
    std::unordered_set<std::string> seen;
    int64_t k = 0, pos = c->pos;
    blob_off[0] = 0;
    for (int64_t i = c->rec; i < c->nrec; i++) {
        const Rec r = read_rec(c->raw, pos);
        pos = r.end;
        const int64_t s = admitted(c, r, false);
        if (s < 0) continue;
        const uint32_t len = make_blob(c, r, s, core->blob);
        if (lookup(core->map, r.hash, core->blob.data(), len) >= 0) continue;
        std::string key(reinterpret_cast<const char*>(core->blob.data()), len);
        if (!seen.insert(key).second) continue;
        rec_out[k] = i;
        ts_out[k] = r.ts;
        std::memcpy(blobs + blob_off[k], key.data(), len);
        blob_off[k + 1] = blob_off[k] + len;
        k++;
    }
    return k;
}

// One round of WriteBuffers.append: each row i with samples left
// (taken[i] < lens[i]) takes as many as its buffer row rows[i] has room
// for, appended at its n; rows that fill are listed in full_out in input
// order. A sample is width bytes of vals (8 for a float64 value, 8 * (B +
// 2) for histogram slots); ts and vals are [N, T] (and [N, T, .]), the
// buffers [cap, M] (and [cap, M, .]). Returns the rows that filled.
int64_t ic_append_round(int64_t* buf_ts, uint8_t* buf_vals, int32_t* buf_n,
                        int64_t M, int64_t width, const int64_t* rows,
                        int64_t* taken, const int64_t* lens, int64_t N,
                        const int64_t* ts, const uint8_t* vals, int64_t T,
                        int64_t* full_out) {
    int64_t nf = 0;
    for (int64_t i = 0; i < N; i++) {
        const int64_t rem = lens[i] - taken[i];
        if (rem <= 0) continue;
        const int64_t r = rows[i];
        const int64_t n0 = buf_n[r];
        const int64_t take = rem < M - n0 ? rem : M - n0;
        std::memcpy(buf_ts + r * M + n0, ts + i * T + taken[i], 8 * take);
        std::memcpy(buf_vals + (r * M + n0) * width,
                    vals + (i * T + taken[i]) * width, width * take);
        buf_n[r] = static_cast<int32_t>(n0 + take);
        taken[i] += take;
        if (n0 + take == M) full_out[nf++] = r;
    }
    return nf;
}

// Bit 1 of the fold's flags: for each pid with row_of[pid] >= 0 (the
// caller's index of it), whether a live sealed chunk (t0, t1 of C chunks)
// overlaps (min t0s, max t1s], as shard_buf_fold decides it.
void ic_sealed_overlap(const int64_t* ch_pid, const int64_t* ch_t0,
                       const int64_t* ch_t1, const uint8_t* ch_dead,
                       int64_t C, const int64_t* t0s, const int64_t* t1s,
                       int64_t W, const int64_t* row_of, int64_t n_row_of,
                       int32_t* flags) {
    int64_t g0 = std::numeric_limits<int64_t>::max();
    int64_t g1 = std::numeric_limits<int64_t>::min();
    for (int64_t w = 0; w < W; w++) {
        if (t0s[w] < g0) g0 = t0s[w];
        if (t1s[w] > g1) g1 = t1s[w];
    }
    for (int64_t c = 0; c < C; c++) {
        if (ch_dead[c] || ch_pid[c] >= n_row_of) continue;
        const int64_t i = row_of[ch_pid[c]];
        if (i >= 0 && ch_t1[c] > g0 && ch_t0[c] <= g1) flags[i] |= 2;
    }
}

// The write-buffer window fold of shard_buf_fold, over the port's rows:
// for each of P pids and each window (t0s[w], t1s[w]], the buffer's
// samples folded into a 12-double stats row
//   [count, sum, sumsq, min, max, first_ts, first_val, last_ts, last_val,
//    resets, corr, changes]
// into out [P, W, 12]. NaN samples are skipped; the sums accumulate
// strictly in order (memory/chunk.py::summarize_values' order), with no
// fused multiply-add (-ffp-contract=off). flags[i] bit 0: the buffer's
// timestamps are not monotone (its rows are left unwritten: the caller
// bypasses). A pid without a buffer row folds as an empty buffer.
void ic_buf_fold(const int64_t* buf_ts, const double* buf_vals,
                 const int32_t* buf_n, const int64_t* slot, int64_t n_slot,
                 int64_t M, const int64_t* pids, int64_t P,
                 const int64_t* t0s, const int64_t* t1s, int64_t W,
                 double* out, int32_t* flags) {
    const double qnan = std::numeric_limits<double>::quiet_NaN();
    for (int64_t i = 0; i < P; i++) {
        const int64_t row = pids[i] < n_slot ? slot[pids[i]] : -1;
        const int64_t n = row < 0 ? 0 : buf_n[row];
        const int64_t* ts = row < 0 ? nullptr : buf_ts + row * M;
        const double* vals = row < 0 ? nullptr : buf_vals + row * M;
        int32_t back = 0;  // no early exit: the loop vectorizes
        for (int64_t k = 1; k < n; k++) back |= ts[k] < ts[k - 1];
        flags[i] |= back;
        if (back) continue;
        double* rows = out + i * W * 12;
        for (int64_t w = 0; w < W; w++) {
            double* r = rows + w * 12;
            // upper_bound of t0s[w] and t1s[w] over ts[0 .. n)
            int64_t lo = 0, hi = n;
            while (lo < hi) {
                const int64_t mid = (lo + hi) / 2;
                if (ts[mid] <= t0s[w]) lo = mid + 1; else hi = mid;
            }
            const int64_t a = lo;
            hi = n;
            while (lo < hi) {
                const int64_t mid = (lo + hi) / 2;
                if (ts[mid] <= t1s[w]) lo = mid + 1; else hi = mid;
            }
            const int64_t b = lo;
            double cnt = 0, sum = 0, sumsq = 0, mn = qnan, mx = qnan;
            double fts = qnan, fv = qnan, lts = qnan, lv = qnan;
            double resets = 0, corr = 0, changes = 0;
            bool have_prev = false;
            double prev = 0;
            for (int64_t k = a; k < b; k++) {
                const double v = vals[k];
                if (v != v) continue;
                cnt += 1;
                sum += v;
                sumsq += v * v;
                if (!have_prev) {
                    mn = mx = v;
                    fts = static_cast<double>(ts[k]);
                    fv = v;
                } else {
                    if (v < mn) mn = v;
                    if (v > mx) mx = v;
                    if (v < prev) {
                        resets += 1;
                        corr += prev;
                    }
                    if (v != prev) changes += 1;
                }
                lts = static_cast<double>(ts[k]);
                lv = v;
                prev = v;
                have_prev = true;
            }
            r[0] = cnt; r[1] = sum; r[2] = sumsq; r[3] = mn; r[4] = mx;
            r[5] = fts; r[6] = fv; r[7] = lts; r[8] = lv;
            r[9] = resets; r[10] = corr; r[11] = changes;
        }
    }
}

}  // extern "C"
