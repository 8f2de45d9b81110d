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
