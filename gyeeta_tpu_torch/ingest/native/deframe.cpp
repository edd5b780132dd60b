// Native wire deframer: the hot L1 byte path in C++.
//
// Counterpart of gyeeta_tpu/ingest/native/deframe.cpp, kept as the
// port's own copy. It scans a byte stream, validates every frame, and
// compacts all records of one subtype into a single contiguous output
// buffer, so Python does one np.frombuffer per subtype per drain and no
// per-frame interpreter work.
//
// The subtype table (subtype, itemsize, cap) is NOT compiled in: the
// Python loader pushes it via gyt_set_table() from wire.DTYPE_OF_SUBTYPE
// at load time, so the native path can never drift from wire.py — the
// single-source-of-truth discipline the reference gets from sharing one
// gy_comm_proto.h between all components.
//
// Validation rules are identical to wire.decode_frames: magic check,
// total_sz bounds, per-subtype batch caps, nevents-fits-frame.
//
// Build: ingest/native/build.py (g++ -O3 -shared, into build/native/ at
// first use). Loaded via ctypes (ingest/native/__init__.py); a failed
// build raises, there is no silent fallback.
//
// The conn and resp decoders come in two widths of their id columns:
// uint32 (the reference's batch columns) and int64 (the port's staging
// slabs keep each u32 column in an int64 carrier, so a decode writes
// the column the device fold consumes).

#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t MAGIC_PM = 0x47590001u;
constexpr uint32_t MAGIC_MS = 0x47590002u;
constexpr uint32_t MAGIC_NQ = 0x47590003u;
constexpr uint32_t MAX_COMM_DATA_SZ = 16u * 1024u * 1024u;
constexpr uint32_t COMM_EVENT_NOTIFY = 1u;

constexpr int64_t HDR_SZ = 16;   // HEADER_DT
constexpr int64_t EV_SZ = 8;     // EVENT_NOTIFY_DT
constexpr int32_t MAX_TYPES = 64;

struct Header {
  uint32_t magic;
  uint32_t total_sz;
  uint32_t data_type;
  uint32_t padding_sz;
};

struct EventNotify {
  uint32_t subtype;
  uint32_t nevents;
};

struct SubtypeInfo {
  uint32_t subtype;
  int64_t itemsize;
  uint32_t cap;
};

SubtypeInfo g_table[MAX_TYPES];
int32_t g_ntypes = 0;

int32_t index_of(uint32_t subtype) {
  for (int32_t i = 0; i < g_ntypes; i++)
    if (g_table[i].subtype == subtype) return i;
  return -1;
}

const SubtypeInfo* info_of(uint32_t subtype) {
  const int32_t i = index_of(subtype);
  return i >= 0 ? &g_table[i] : nullptr;
}

enum GytErr : int32_t {
  GYT_OK = 0,
  GYT_BAD_MAGIC = 1,
  GYT_BAD_TOTAL = 2,
  GYT_CAP_EXCEEDED = 3,
  GYT_NEV_OVERFLOW = 4,
  GYT_OUT_FULL = 5,
  GYT_BAD_TABLE = 6,
  GYT_BAD_DTYPE = 7,   // non-EVENT frame on the event stream (the feed
                       // path carries EVENT_NOTIFY only — anything else
                       // is a corrupted data_type byte, and skipping it
                       // would be silent record loss)
  GYT_BAD_CHECKSUM = 8,  // flagged frame's XOR payload fold mismatched
};

// padding_sz bit 31 flags a payload checksum in bits 8..15 (wire.py
// CHK_FLAG): XOR fold of every byte after the 16B header. Verified in
// the sizing scan (one extra read pass; the extract pass trusts it).
constexpr uint32_t CHK_FLAG = 0x80000000u;

inline uint8_t xor_fold(const uint8_t* p, int64_t n) {
  uint8_t x = 0;
  for (int64_t i = 0; i < n; i++) x ^= p[i];  // -O3 vectorizes this
  return x;
}

}  // namespace

extern "C" {

// Install the subtype table: n triples of (subtype, itemsize, cap).
// Called once by the Python loader before any scan/extract; itemsizes
// must be 8-aligned (wire.py asserts the same on its side).
int32_t gyt_set_table(const int64_t* triples, int32_t n) {
  if (n < 1 || n > MAX_TYPES) return GYT_BAD_TABLE;
  for (int32_t i = 0; i < n; i++) {
    const int64_t itemsize = triples[i * 3 + 1];
    if (itemsize <= 0 || itemsize % 8 != 0) return GYT_BAD_TABLE;
    g_table[i].subtype = static_cast<uint32_t>(triples[i * 3 + 0]);
    g_table[i].itemsize = itemsize;
    g_table[i].cap = static_cast<uint32_t>(triples[i * 3 + 2]);
  }
  g_ntypes = n;
  return GYT_OK;
}

// Echo the installed table back (layout handshake round-trip).
int32_t gyt_layout(int64_t* out, int64_t max_triples) {
  int32_t n = 0;
  for (int32_t i = 0; i < g_ntypes; i++) {
    if (n >= max_triples) break;
    out[n * 3 + 0] = g_table[i].subtype;
    out[n * 3 + 1] = g_table[i].itemsize;
    out[n * 3 + 2] = g_table[i].cap;
    n++;
  }
  return n;
}

// Scan [buf, buf+len): validate frames; copy records of `subtype` into
// out (capacity out_cap bytes). A trailing partial frame is left for
// resume. Returns GYT_OK or first error; *consumed = bytes fully parsed,
// *out_nrec = records written, *total_nrec = records of this subtype seen
// (== written unless GYT_OUT_FULL).
int32_t gyt_extract(const uint8_t* buf, int64_t len, uint32_t subtype,
                    uint8_t* out, int64_t out_cap, int64_t* consumed,
                    int64_t* out_nrec, int64_t* total_nrec) {
  const SubtypeInfo* want = info_of(subtype);
  int64_t off = 0, written = 0, seen = 0;
  *consumed = 0;
  *out_nrec = 0;
  *total_nrec = 0;
  if (want == nullptr) return GYT_BAD_TABLE;

  while (off + HDR_SZ <= len) {
    Header h;
    std::memcpy(&h, buf + off, sizeof(h));
    if (h.magic != MAGIC_PM && h.magic != MAGIC_MS && h.magic != MAGIC_NQ)
      return GYT_BAD_MAGIC;
    const int64_t total = static_cast<int64_t>(h.total_sz);
    if (total < HDR_SZ + EV_SZ || total >= MAX_COMM_DATA_SZ)
      return GYT_BAD_TOTAL;
    if (off + total > len) break;  // partial frame: resume later

    if (h.data_type == COMM_EVENT_NOTIFY) {
      EventNotify ev;
      std::memcpy(&ev, buf + off + HDR_SZ, sizeof(ev));
      const SubtypeInfo* si = info_of(ev.subtype);
      if (si != nullptr) {
        if (ev.nevents > si->cap) return GYT_CAP_EXCEEDED;
        // EXACT sizing: producers frame records tightly, so any slack
        // or overflow means a corrupted nevents — reject it (counted)
        // instead of silently decoding fewer records than were sent
        const int64_t need =
            HDR_SZ + EV_SZ + static_cast<int64_t>(ev.nevents) * si->itemsize;
        if (need != total) return GYT_NEV_OVERFLOW;
        if (ev.subtype == subtype && ev.nevents > 0) {
          const int64_t nbytes =
              static_cast<int64_t>(ev.nevents) * si->itemsize;
          seen += ev.nevents;
          if (written + nbytes <= out_cap) {
            std::memcpy(out + written, buf + off + HDR_SZ + EV_SZ,
                        static_cast<size_t>(nbytes));
            written += nbytes;
          } else {
            *consumed = off;
            *out_nrec = written / want->itemsize;
            *total_nrec = seen;
            return GYT_OUT_FULL;
          }
        }
      }
      // unknown subtypes skipped (forward compat)
    } else {
      return GYT_BAD_DTYPE;  // event stream carries EVENT_NOTIFY only
    }
    off += total;
  }
  *consumed = off;
  *out_nrec = written / want->itemsize;
  *total_nrec = seen;
  return GYT_OK;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Columnar TCP_CONN decode: raw records → the ConnBatch column arrays.
// The hashing (murmur3 finalizer chains, xor-folded IPv6 words, the
// 5-tuple flow key) is bit-identical to utils/hashing.py's numpy path —
// a parity test diffs the two on random records. Field offsets are NOT
// compiled in: the Python loader pushes them from wire.TCP_CONN_DT
// (gyt_set_conn_layout), same discipline as the subtype table.

namespace {

inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

inline uint32_t mix64(uint32_t hi, uint32_t lo, uint32_t salt) {
  const uint32_t s = (salt + 1u) * 0x9E3779B9u;
  uint32_t h = fmix32(lo ^ s);
  return fmix32(hi ^ h ^ salt);
}

// offsets into one TCP_CONN record, pushed from Python
struct ConnLayout {
  int64_t itemsize;
  int64_t cli, ser, nat_cli, nat_ser;  // IP_PORT offsets (16B ip first)
  int64_t tusec_start, tusec_close;
  int64_t cli_task, cli_rel, ser_glob;
  int64_t bytes_sent, bytes_rcvd;
  int64_t host_id, flags;
  int64_t port_off;  // offset of port WITHIN an IP_PORT sub-record
};

ConnLayout g_conn{};
bool g_conn_set = false;

inline void fold_ip(const uint8_t* p, uint32_t* hi, uint32_t* lo) {
  uint32_t w[4];
  std::memcpy(w, p, 16);
  *hi = w[0] ^ w[2];
  *lo = w[1] ^ w[3];
}

inline bool ip_nonzero(const uint8_t* p) {
  uint64_t a, b;
  std::memcpy(&a, p, 8);
  std::memcpy(&b, p + 8, 8);
  return (a | b) != 0;
}

}  // namespace

extern "C" {

// fields: itemsize then the 14 offsets in ConnLayout order.
int32_t gyt_set_conn_layout(const int64_t* fields, int32_t n) {
  if (n != 15) return GYT_BAD_TABLE;
  int64_t* dst = &g_conn.itemsize;
  for (int32_t i = 0; i < 15; i++) dst[i] = fields[i];
  if (g_conn.itemsize <= 0 || g_conn.itemsize % 8 != 0)
    return GYT_BAD_TABLE;
  g_conn_set = true;
  return GYT_OK;
}

// Decode n records at `recs` into pre-allocated column arrays (each of
// length >= n). Semantics identical to decode.conn_batch's per-record
// math; Python pads/validates lanes.
}  // extern "C"

namespace {

template <typename U>
int32_t decode_conn(
    const uint8_t* recs, int64_t n, U* svc_hi, U* svc_lo,
    U* flow_hi, U* flow_lo, U* cli_hi,
    U* cli_lo, U* task_hi, U* task_lo,
    U* rel_hi, U* rel_lo, float* bytes_sent,
    float* bytes_rcvd, float* duration_us, int32_t* host_id,
    uint8_t* is_close, uint8_t* is_accept) {
  if (!g_conn_set) return GYT_BAD_TABLE;
  const ConnLayout& L = g_conn;
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* r = recs + i * L.itemsize;
    uint64_t u64;

    std::memcpy(&u64, r + L.ser_glob, 8);
    svc_hi[i] = static_cast<uint32_t>(u64 >> 32);
    svc_lo[i] = static_cast<uint32_t>(u64);
    std::memcpy(&u64, r + L.cli_task, 8);
    task_hi[i] = static_cast<uint32_t>(u64 >> 32);
    task_lo[i] = static_cast<uint32_t>(u64);
    std::memcpy(&u64, r + L.cli_rel, 8);
    rel_hi[i] = static_cast<uint32_t>(u64 >> 32);
    rel_lo[i] = static_cast<uint32_t>(u64);

    // NAT-aware effective tuple (post-NAT view when conntrack resolved)
    const uint8_t* cli = r + L.cli;
    const uint8_t* ser = r + L.ser;
    const uint8_t* ncli = r + L.nat_cli;
    const uint8_t* nser = r + L.nat_ser;
    const bool nat_c = ip_nonzero(ncli);
    const bool nat_s = ip_nonzero(nser);
    const uint8_t* eff_cli = nat_c ? ncli : cli;
    const uint8_t* eff_ser = nat_s ? nser : ser;
    uint16_t cport, sport;
    std::memcpy(&cport, (nat_c ? ncli : cli) + L.port_off, 2);
    std::memcpy(&sport, (nat_s ? nser : ser) + L.port_off, 2);

    uint32_t cip_hi, cip_lo, sip_hi, sip_lo;
    fold_ip(eff_cli, &cip_hi, &cip_lo);
    fold_ip(eff_ser, &sip_hi, &sip_lo);

    // flow_key (utils/hashing.py): ports word, two mix64 streams, chain
    const uint32_t ports =
        (static_cast<uint32_t>(cport) << 16) | sport;
    const uint32_t a = mix64(cip_hi, cip_lo, 1);
    const uint32_t b = mix64(sip_hi, sip_lo, 2);
    const uint32_t f_lo = fmix32(a ^ (ports * 0x85EBCA6Bu));
    const uint32_t f_hi = fmix32(b ^ (6u * 0xC2B2AE35u) ^ f_lo);
    flow_hi[i] = f_hi;
    flow_lo[i] = f_lo;

    // client endpoint identity: address-only hash
    const uint32_t c_hi = fmix32(cip_hi ^ 0xC11E57u);
    cli_hi[i] = c_hi;
    cli_lo[i] = fmix32(cip_lo ^ c_hi);

    uint64_t bs, br, t0, t1;
    std::memcpy(&bs, r + L.bytes_sent, 8);
    std::memcpy(&br, r + L.bytes_rcvd, 8);
    std::memcpy(&t0, r + L.tusec_start, 8);
    std::memcpy(&t1, r + L.tusec_close, 8);
    bytes_sent[i] = static_cast<float>(bs);
    bytes_rcvd[i] = static_cast<float>(br);
    const bool closed = t1 > 0;
    duration_us[i] = closed ? static_cast<float>(t1 - t0) : 0.0f;
    is_close[i] = closed ? 1 : 0;

    uint32_t hid, flags;
    std::memcpy(&hid, r + L.host_id, 4);
    std::memcpy(&flags, r + L.flags, 4);
    host_id[i] = static_cast<int32_t>(hid);
    is_accept[i] = (flags & 2u) ? 1 : 0;
  }
  return GYT_OK;
}

}  // namespace

extern "C" {

#define GYT_CONN_ARGS(U)                                                  \
    const uint8_t* recs, int64_t n, U* svc_hi, U* svc_lo, U* flow_hi,     \
    U* flow_lo, U* cli_hi, U* cli_lo, U* task_hi, U* task_lo, U* rel_hi,  \
    U* rel_lo, float* bytes_sent, float* bytes_rcvd, float* duration_us,  \
    int32_t* host_id, uint8_t* is_close, uint8_t* is_accept
#define GYT_CONN_CALL                                                     \
    decode_conn(recs, n, svc_hi, svc_lo, flow_hi, flow_lo, cli_hi, cli_lo, \
                task_hi, task_lo, rel_hi, rel_lo, bytes_sent, bytes_rcvd, \
                duration_us, host_id, is_close, is_accept)

// uint32 id columns (the reference's ConnBatch)
int32_t gyt_decode_conn(GYT_CONN_ARGS(uint32_t)) { return GYT_CONN_CALL; }

// int64 id columns (the port's staging slabs)
int32_t gyt_decode_conn_i64(GYT_CONN_ARGS(int64_t)) { return GYT_CONN_CALL; }

}  // extern "C"

extern "C" {

// One-pass multi-subtype extract: walk the frame stream ONCE and append
// every known subtype's records into its own caller-provided buffer
// (outs/out_caps indexed in gyt_set_table order; outs[i] may be null
// when the scan counted zero records). This replaces the per-subtype
// gyt_extract walk in drain(): scan + one extract pass total, instead
// of scan + one walk per present subtype.
int32_t gyt_extract_multi(const uint8_t* buf, int64_t len,
                          uint8_t* const* outs, const int64_t* out_caps,
                          int64_t* out_nrec, int64_t* consumed) {
  int64_t off = 0;
  int64_t written[MAX_TYPES];  // bytes appended per table slot
  for (int32_t i = 0; i < g_ntypes; i++) {
    written[i] = 0;
    out_nrec[i] = 0;
  }
  *consumed = 0;
  while (off + HDR_SZ <= len) {
    Header h;
    std::memcpy(&h, buf + off, sizeof(h));
    if (h.magic != MAGIC_PM && h.magic != MAGIC_MS && h.magic != MAGIC_NQ)
      return GYT_BAD_MAGIC;
    const int64_t total = static_cast<int64_t>(h.total_sz);
    if (total < HDR_SZ + EV_SZ || total >= MAX_COMM_DATA_SZ)
      return GYT_BAD_TOTAL;
    if (off + total > len) break;  // partial frame: resume later
    if (h.data_type == COMM_EVENT_NOTIFY) {
      EventNotify ev;
      std::memcpy(&ev, buf + off + HDR_SZ, sizeof(ev));
      const int32_t idx = index_of(ev.subtype);
      if (idx >= 0) {
        const SubtypeInfo& si = g_table[idx];
        if (ev.nevents > si.cap) return GYT_CAP_EXCEEDED;
        const int64_t nbytes =
            static_cast<int64_t>(ev.nevents) * si.itemsize;
        if (HDR_SZ + EV_SZ + nbytes != total) return GYT_NEV_OVERFLOW;
        if (ev.nevents > 0) {
          if (outs[idx] == nullptr ||
              written[idx] + nbytes > out_caps[idx]) {
            *consumed = off;
            return GYT_OUT_FULL;
          }
          std::memcpy(outs[idx] + written[idx], buf + off + HDR_SZ + EV_SZ,
                      static_cast<size_t>(nbytes));
          written[idx] += nbytes;
          out_nrec[idx] += ev.nevents;
        }
      }
      // unknown subtypes skipped (forward compat)
    } else {
      return GYT_BAD_DTYPE;  // event stream carries EVENT_NOTIFY only
    }
    off += total;
  }
  *consumed = off;
  return GYT_OK;
}

// Count frames + records per subtype without copying (sizing pass).
// counts: array of g_ntypes int64, in gyt_set_table order.
// *unknown_records counts records claimed by EVENT frames of UNKNOWN
// subtype (forward compat / corrupted subtype byte): they are skipped,
// but the skip must be COUNTABLE — silent loss breaks the chaos tier's
// delivery accounting.
int32_t gyt_scan2(const uint8_t* buf, int64_t len, int64_t* counts,
                  int64_t* consumed, int64_t* unknown_records) {
  int64_t off = 0;
  for (int32_t i = 0; i < g_ntypes; i++) counts[i] = 0;
  *consumed = 0;
  *unknown_records = 0;
  while (off + HDR_SZ <= len) {
    Header h;
    std::memcpy(&h, buf + off, sizeof(h));
    if (h.magic != MAGIC_PM && h.magic != MAGIC_MS && h.magic != MAGIC_NQ)
      return GYT_BAD_MAGIC;
    const int64_t total = static_cast<int64_t>(h.total_sz);
    if (total < HDR_SZ + EV_SZ || total >= MAX_COMM_DATA_SZ)
      return GYT_BAD_TOTAL;
    if (off + total > len) break;
    if ((h.padding_sz & CHK_FLAG) &&
        xor_fold(buf + off + HDR_SZ, total - HDR_SZ) !=
            static_cast<uint8_t>(h.padding_sz >> 8))
      return GYT_BAD_CHECKSUM;
    if (h.data_type == COMM_EVENT_NOTIFY) {
      EventNotify ev;
      std::memcpy(&ev, buf + off + HDR_SZ, sizeof(ev));
      const int32_t idx = index_of(ev.subtype);
      if (idx >= 0) {
        if (ev.nevents > g_table[idx].cap) return GYT_CAP_EXCEEDED;
        const int64_t need = HDR_SZ + EV_SZ +
            static_cast<int64_t>(ev.nevents) * g_table[idx].itemsize;
        if (need != total) return GYT_NEV_OVERFLOW;
        counts[idx] += ev.nevents;
      } else {
        *unknown_records += ev.nevents;
      }
    } else {
      return GYT_BAD_DTYPE;  // event stream carries EVENT_NOTIFY only
    }
    off += total;
  }
  *consumed = off;
  return GYT_OK;
}

int32_t gyt_scan(const uint8_t* buf, int64_t len, int64_t* counts,
                 int64_t* consumed) {
  int64_t unknown = 0;
  return gyt_scan2(buf, len, counts, consumed, &unknown);
}

}  // extern "C"

// ---------------------------------------------------------------------
// Generic record→column pack kernels: the executor half of the
// wire→columnar compiler. Python compiles a column plan from the
// numpy structured dtype (field offset + scalar kind per output
// column — ingest/native/__init__.py builds it from wire.py, the same
// single-source-of-truth discipline as the subtype table) and these
// kernels execute it in one pass over the raw records, writing
// straight into caller-provided preallocated column buffers. Casts
// are the exact C equivalents of numpy's .astype() on the same
// scalars, so the output is bit-identical to ingest/decode.py's
// reference builders (the parity fuzz test diffs both).

namespace {

enum PackKind : int64_t {
  PK_U1 = 1, PK_U2 = 2, PK_U4 = 3, PK_U8 = 4, PK_I4 = 5, PK_F4 = 6,
};

inline bool kind_ok(int64_t k) { return k >= PK_U1 && k <= PK_F4; }

inline int64_t kind_size(int64_t k) {
  switch (k) {
    case PK_U1: return 1;
    case PK_U2: return 2;
    case PK_U4: case PK_I4: case PK_F4: return 4;
    default: return 8;
  }
}

inline float load_f32(const uint8_t* p, int64_t kind) {
  switch (kind) {
    case PK_U1: return static_cast<float>(*p);
    case PK_U2: { uint16_t v; std::memcpy(&v, p, 2);
                  return static_cast<float>(v); }
    case PK_U4: { uint32_t v; std::memcpy(&v, p, 4);
                  return static_cast<float>(v); }
    case PK_U8: { uint64_t v; std::memcpy(&v, p, 8);
                  return static_cast<float>(v); }
    case PK_I4: { int32_t v; std::memcpy(&v, p, 4);
                  return static_cast<float>(v); }
    default:    { float v; std::memcpy(&v, p, 4); return v; }
  }
}

inline int32_t load_i32(const uint8_t* p, int64_t kind) {
  switch (kind) {
    case PK_U1: return static_cast<int32_t>(*p);
    case PK_U2: { uint16_t v; std::memcpy(&v, p, 2);
                  return static_cast<int32_t>(v); }
    case PK_U4: { uint32_t v; std::memcpy(&v, p, 4);
                  return static_cast<int32_t>(v); }
    case PK_U8: { uint64_t v; std::memcpy(&v, p, 8);
                  return static_cast<int32_t>(v); }
    case PK_I4: { int32_t v; std::memcpy(&v, p, 4); return v; }
    default:    { float v; std::memcpy(&v, p, 4);
                  return static_cast<int32_t>(v); }
  }
}

}  // namespace

extern "C" {

// n records → (n, ncols) float32 row-major. ops = ncols pairs of
// (src_offset, kind). The stat/panel/vals matrix builder for
// LISTENER/HOST/TASK/CPU_MEM sweeps (replaces decode.py's per-field
// python loops).
int32_t gyt_pack_f32(const uint8_t* recs, int64_t n, int64_t itemsize,
                     const int64_t* ops, int32_t ncols, float* out) {
  if (itemsize <= 0 || ncols <= 0) return GYT_BAD_TABLE;
  for (int32_t c = 0; c < ncols; c++) {
    const int64_t off = ops[2 * c], kind = ops[2 * c + 1];
    if (!kind_ok(kind) || off < 0 || off + kind_size(kind) > itemsize)
      return GYT_BAD_TABLE;
  }
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* r = recs + i * itemsize;
    float* o = out + i * ncols;
    for (int32_t c = 0; c < ncols; c++)
      o[c] = load_f32(r + ops[2 * c], ops[2 * c + 1]);
  }
  return GYT_OK;
}

// One u64 field per record → (hi, lo) uint32 column pair (the
// 64-bit id split of decode.split_u64).
int32_t gyt_split_u64(const uint8_t* recs, int64_t n, int64_t itemsize,
                      int64_t off, uint32_t* hi, uint32_t* lo) {
  if (itemsize <= 0 || off < 0 || off + 8 > itemsize)
    return GYT_BAD_TABLE;
  for (int64_t i = 0; i < n; i++) {
    uint64_t v;
    std::memcpy(&v, recs + i * itemsize + off, 8);
    hi[i] = static_cast<uint32_t>(v >> 32);
    lo[i] = static_cast<uint32_t>(v);
  }
  return GYT_OK;
}

// One scalar field per record → int32 column (host_id / state / issue).
int32_t gyt_pack_i32(const uint8_t* recs, int64_t n, int64_t itemsize,
                     int64_t off, int64_t kind, int32_t* out) {
  if (itemsize <= 0 || !kind_ok(kind) || off < 0
      || off + kind_size(kind) > itemsize)
    return GYT_BAD_TABLE;
  for (int64_t i = 0; i < n; i++)
    out[i] = load_i32(recs + i * itemsize + off, kind);
  return GYT_OK;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Specialized RESP_SAMPLE decode: the highest-rate subtype (4096/batch
// vs 2048 conns) gets a fused single-pass kernel instead of three
// generic ones. Layout pushed from wire.RESP_SAMPLE_DT like the conn
// layout.

namespace {

struct RespLayout {
  int64_t itemsize, glob_id, resp_usec, host_id;
};

RespLayout g_resp{};
bool g_resp_set = false;

}  // namespace

extern "C" {

int32_t gyt_set_resp_layout(const int64_t* fields, int32_t n) {
  if (n != 4) return GYT_BAD_TABLE;
  g_resp.itemsize = fields[0];
  g_resp.glob_id = fields[1];
  g_resp.resp_usec = fields[2];
  g_resp.host_id = fields[3];
  if (g_resp.itemsize <= 0 || g_resp.itemsize % 8 != 0)
    return GYT_BAD_TABLE;
  g_resp_set = true;
  return GYT_OK;
}

// Decode n RESP_SAMPLE records into pre-allocated columns: glob_id
// split, resp_usec → float32, host_id → int32 — bit-identical to
// decode.resp_batch's numpy math.
}  // extern "C"

namespace {

template <typename U>
int32_t decode_resp(const uint8_t* recs, int64_t n, U* svc_hi, U* svc_lo,
                    float* resp_us, int32_t* host_id) {
  if (!g_resp_set) return GYT_BAD_TABLE;
  const RespLayout& L = g_resp;
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* r = recs + i * L.itemsize;
    uint64_t gid;
    uint32_t ru, hid;
    std::memcpy(&gid, r + L.glob_id, 8);
    std::memcpy(&ru, r + L.resp_usec, 4);
    std::memcpy(&hid, r + L.host_id, 4);
    svc_hi[i] = static_cast<uint32_t>(gid >> 32);
    svc_lo[i] = static_cast<uint32_t>(gid);
    resp_us[i] = static_cast<float>(ru);
    host_id[i] = static_cast<int32_t>(hid);
  }
  return GYT_OK;
}

}  // namespace

extern "C" {

int32_t gyt_decode_resp(const uint8_t* recs, int64_t n, uint32_t* svc_hi,
                        uint32_t* svc_lo, float* resp_us,
                        int32_t* host_id) {
  return decode_resp(recs, n, svc_hi, svc_lo, resp_us, host_id);
}

int32_t gyt_decode_resp_i64(const uint8_t* recs, int64_t n, int64_t* svc_hi,
                            int64_t* svc_lo, float* resp_us,
                            int32_t* host_id) {
  return decode_resp(recs, n, svc_hi, svc_lo, resp_us, host_id);
}

}  // extern "C"
