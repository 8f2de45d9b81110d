// windflow_tpu_torch native host runtime (the port's own copy of
// windflow_tpu/native/wf_host.cpp).
//
// The native data plane of the reference (recycling.hpp /
// recycling_gpu.hpp free-list pools, ff::MPMC_Ptr_Queue lock-free queues,
// forward_emitter_gpu.hpp pinned staging, keyby_emitter.hpp hash routing):
// the pieces of the runtime that sit AROUND the device compute path and
// want to be native — bulk ingest parsing, key partitioning, and the
// watermark fold.  Exposed as a plain C ABI consumed via ctypes
// (windflow_tpu_torch/native/__init__.py); no Python.h dependency so the
// library builds with any g++ and loads in any CPython.
//
// Build: built at first use by windflow_tpu_torch/native/__init__.py
// (`make -C <build dir>`) into a git-ignored directory.

#include <atomic>
#include <cstdint>
#if defined(__SSE2__)
#include <immintrin.h>
#endif
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Hashing + keyby partitioning (reference keyby_emitter.hpp:216 hash%ndest).
// splitmix64: deterministic across processes, well-mixed for dense int keys.
// ---------------------------------------------------------------------------

static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

uint64_t wf_hash64(int64_t key) { return splitmix64((uint64_t)key); }

// dest_out[i] = hash(keys[i]) % ndest; counts_out[d] = #tuples for dest d.
void wf_keyby_partition(const int64_t* keys, int64_t n, int32_t ndest,
                        int32_t* dest_out, int64_t* counts_out) {
  memset(counts_out, 0, sizeof(int64_t) * (size_t)ndest);
  for (int64_t i = 0; i < n; ++i) {
    int32_t d = (int32_t)(splitmix64((uint64_t)keys[i]) % (uint64_t)ndest);
    dest_out[i] = d;
    counts_out[d]++;
  }
}


// ---------------------------------------------------------------------------
// Bulk ingest: parse binary frames / CSV into columns (the native
// data-loader; feeds the staging emitter with zero per-tuple Python work).
// Binary record layout: int64 key, int64 ts, nv x float64 values (LE).
// ---------------------------------------------------------------------------

int64_t wf_frame_record_bytes(int32_t nv) { return 16 + 8 * (int64_t)nv; }

// Returns #records parsed (caps at max_records; ignores trailing partial
// record — the caller carries the remainder into the next chunk).
int64_t wf_parse_frames(const uint8_t* buf, int64_t nbytes, int32_t nv,
                        int64_t* keys, int64_t* tss, double* vals,
                        int64_t max_records) {
  const int64_t rec = wf_frame_record_bytes(nv);
  int64_t n = nbytes / rec;
  if (n > max_records) n = max_records;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = buf + i * rec;
    memcpy(&keys[i], p, 8);
    memcpy(&tss[i], p + 8, 8);
    memcpy(&vals[i * nv], p + 16, 8 * (size_t)nv);
  }
  return n;
}

// ---------------------------------------------------------------------------
// Frames straight into a packed staging buffer (the layout of
// staging.PackedBatchBuilder: each lane's rows at the lane's own word
// offset, a 4-byte lane one uint32 word a row, an 8-byte lane two), with no
// intermediate columns: the staging route of a frame source.
// ---------------------------------------------------------------------------

// Over nrec >= 1 whole records: out = {key_min, key_max, ts_max}.  The
// caller picks the key lane's width from the range before it packs.
void wf_scan_frames(const uint8_t* buf, int64_t nrec, int32_t nv,
                    int64_t* out) {
  const int64_t rec = wf_frame_record_bytes(nv);
  int64_t kmin, kmax, tmax;
  memcpy(&kmin, buf, 8);
  memcpy(&tmax, buf + 8, 8);
  kmax = kmin;
  for (int64_t i = 1; i < nrec; ++i) {
    // a chunk comes cold from the producer: ask for lines ahead
    __builtin_prefetch(buf + (i + 32) * rec);
    int64_t k, t;
    memcpy(&k, buf + i * rec, 8);
    memcpy(&t, buf + i * rec + 8, 8);
    kmin = k < kmin ? k : kmin;
    kmax = k > kmax ? k : kmax;
    tmax = t > tmax ? t : tmax;
  }
  out[0] = kmin;
  out[1] = kmax;
  out[2] = tmax;
}

// take rows with plain stores: the key narrowed to int32 (kw 1) or kept
// int64 (kw 2), each value cast to float32 (round to nearest, as numpy's
// astype), the ts as int64.  kw is a constant at every call, so each width
// compiles to its own loop.
static inline void pack_rows(const uint8_t* buf, int64_t rec, int32_t nv,
                             int64_t take, uint32_t* key, uint32_t** vals,
                             uint32_t* ts, const int kw, int64_t* tmin_io,
                             int64_t* tmax_io) {
  int64_t tmin = *tmin_io, tmax = *tmax_io;
  for (int64_t i = 0; i < take; ++i) {
    const uint8_t* p = buf + i * rec;
    int64_t k, t;
    memcpy(&k, p, 8);
    memcpy(&t, p + 8, 8);
    if (kw == 1) {
      int32_t k32 = (int32_t)k;
      memcpy(key + i, &k32, 4);
    } else {
      memcpy(key + 2 * i, &k, 8);
    }
    for (int32_t v = 0; v < nv; ++v) {
      double d;
      memcpy(&d, p + 16 + 8 * v, 8);
      float f = (float)d;
      memcpy(vals[v] + i, &f, 4);
    }
    memcpy(ts + 2 * i, &t, 8);
    tmin = t < tmin ? t : tmin;
    tmax = t > tmax ? t : tmax;
  }
  *tmin_io = tmin;
  *tmax_io = tmax;
}

#if defined(__SSE2__)
// The int32-key case (the common one) in 16-row blocks:
// each block's lanes are staged on the stack and written out a whole
// 64-byte line at a time with non-temporal stores, so the 8 bytes a row
// of writes do not first read the staging buffer's lines from memory.
// Needs every lane at a line start on one common row (true whenever the
// buffer and its lane offsets are 64-byte aligned); returns false, having
// written nothing, when they are not.  Plain stores cover the rows before
// that row and after the last whole block.
static void stream_line(uint32_t* dst, const void* src) {
  const __m128i* s = (const __m128i*)src;
  __m128i* d = (__m128i*)dst;
  _mm_stream_si128(d, _mm_load_si128(s));
  _mm_stream_si128(d + 1, _mm_load_si128(s + 1));
  _mm_stream_si128(d + 2, _mm_load_si128(s + 2));
  _mm_stream_si128(d + 3, _mm_load_si128(s + 3));
}

static bool pack_rows_streamed(const uint8_t* buf, int64_t rec, int32_t nv,
                               int64_t take, uint32_t* key, uint32_t** vals,
                               uint32_t* ts, int64_t* tmin, int64_t* tmax) {
  // rows until the key lane starts a line; every lane must agree
  const int64_t head = (int64_t)((64 - ((uintptr_t)key & 63)) & 63) / 4;
  if (((uintptr_t)key & 3) || ((uintptr_t)(ts + 2 * head) & 63)) return false;
  for (int32_t v = 0; v < nv; ++v)
    if ((uintptr_t)(vals[v] + head) & 63) return false;
  const int64_t h = head < take ? head : take;
  pack_rows(buf, rec, nv, h, key, vals, ts, 1, tmin, tmax);
  alignas(64) int32_t kb[16];
  alignas(64) float vb[16];
  alignas(64) int64_t tb[16];
  int64_t lo = *tmin, hi = *tmax, i0 = h;
  for (; i0 + 16 <= take; i0 += 16) {
    const uint8_t* p = buf + i0 * rec;
    for (int j = 0; j < 16; ++j) {
      int64_t k, t;
      memcpy(&k, p + j * rec, 8);
      memcpy(&t, p + j * rec + 8, 8);
      kb[j] = (int32_t)k;
      tb[j] = t;
      lo = t < lo ? t : lo;
      hi = t > hi ? t : hi;
    }
    stream_line(key + i0, kb);
    stream_line(ts + 2 * i0, tb);
    stream_line(ts + 2 * i0 + 16, tb + 8);
    for (int32_t v = 0; v < nv; ++v) {
      for (int j = 0; j < 16; ++j) {
        double d;
        memcpy(&d, p + j * rec + 16 + 8 * v, 8);
        vb[j] = (float)d;
      }
      stream_line(vals[v] + i0, vb);
    }
  }
  _mm_sfence();  // the streamed lines reach memory before any later read
  *tmin = lo;
  *tmax = hi;
  std::vector<uint32_t*> tail((size_t)nv);
  for (int32_t v = 0; v < nv; ++v) tail[(size_t)v] = vals[v] + i0;
  pack_rows(buf + i0 * rec, rec, nv, take - i0, key + i0, tail.data(),
            ts + 2 * i0, 1, tmin, tmax);
  return true;
}
#endif

// Rows [rec0, rec0 + take) (take >= 1) of the records at buf into dst:
// lane_off[0] is the word offset of the slice's first key (int32 when
// key_words is 1, else int64), lane_off[1 + v] that of value v (float32),
// lane_off[1 + nv] that of the first ts.  run_max is the running ts
// maximum before the slice.  out = {ts_min, ts_max, the running ts maximum
// at the slice's last row}.
void wf_pack_frames(const uint8_t* buf, int32_t nv, int64_t rec0,
                    int64_t take, uint32_t* dst, const int64_t* lane_off,
                    int32_t key_words, int64_t run_max, int64_t* out) {
  const int64_t rec = wf_frame_record_bytes(nv);
  const uint8_t* src = buf + rec0 * rec;
  std::vector<uint32_t*> vals((size_t)nv);
  for (int32_t v = 0; v < nv; ++v) vals[(size_t)v] = dst + lane_off[1 + v];
  uint32_t* key = dst + lane_off[0];
  uint32_t* ts = dst + lane_off[1 + nv];
  int64_t tmin, tmax;
  memcpy(&tmin, src + 8, 8);
  tmax = tmin;
  if (key_words == 2)
    pack_rows(src, rec, nv, take, key, vals.data(), ts, 2, &tmin, &tmax);
#if defined(__SSE2__)
  else if (!pack_rows_streamed(src, rec, nv, take, key, vals.data(), ts,
                               &tmin, &tmax))
#else
  else
#endif
    pack_rows(src, rec, nv, take, key, vals.data(), ts, 1, &tmin, &tmax);
  out[0] = tmin;
  out[1] = tmax;
  out[2] = tmax > run_max ? tmax : run_max;
}

// CSV lines "key,ts,v0[,v1...]\n".  Returns #records; stops at max_records
// or at the last complete line; *consumed_out = bytes consumed.
int64_t wf_parse_csv(const char* buf, int64_t nbytes, int32_t nv,
                     int64_t* keys, int64_t* tss, double* vals,
                     int64_t max_records, int64_t* consumed_out) {
  int64_t n = 0, pos = 0;
  std::vector<char> scratch(512);
  while (n < max_records) {
    // find end of line
    int64_t eol = pos;
    while (eol < nbytes && buf[eol] != '\n') eol++;
    if (eol >= nbytes) break;  // partial line: leave for next chunk
    // copy the line into a NUL-terminated scratch so strto* cannot scan
    // past the newline (a field like "5,50,\n6" must not steal digits from
    // the next line) or past the end of the buffer
    int64_t len = eol - pos;
    if (len + 1 > (int64_t)scratch.size()) scratch.resize((size_t)len + 1);
    char* line = scratch.data();
    memcpy(line, buf + pos, (size_t)len);
    line[len] = '\0';
    char* end;
    int64_t key = strtoll(line, &end, 10);
    // malformed (empty key or no separator): skip line
    if (end == line || *end != ',') { pos = eol + 1; continue; }
    const char* ts_start = end + 1;
    int64_t ts = strtoll(ts_start, &end, 10);
    bool ok = (end != ts_start);
    for (int32_t v = 0; ok && v < nv; ++v) {
      if (*end != ',') { ok = false; break; }
      const char* start = end + 1;
      vals[n * nv + v] = strtod(start, &end);
      if (end == start) { ok = false; break; }  // empty field
    }
    if (ok) {
      keys[n] = key;
      tss[n] = ts;
      n++;
    }
    pos = eol + 1;
  }
  *consumed_out = pos;
  return n;
}

// ---------------------------------------------------------------------------
// Watermark fold: min over per-channel maxima, ignoring unset channels
// (reference watermark_collector.hpp:63-76 inner loop).
// ---------------------------------------------------------------------------

int64_t wf_min_watermark(const int64_t* channel_wms, int32_t n,
                         int64_t wm_none) {
  int64_t m = wm_none;
  for (int32_t i = 0; i < n; ++i) {
    int64_t w = channel_wms[i];
    if (w == wm_none) return wm_none;  // some channel has no watermark yet
    if (m == wm_none || w < m) m = w;
  }
  return m;
}

}  // extern "C"
