// wf_kv: embedded log-structured key/value store for persistent operators.
//
// The port's copy of windflow_tpu/native/wf_kv.cpp: the stand-in for the
// RocksDB dependency of the reference's persistent operator suite
// (persistent/db_handle.hpp:53-140):
// keyed operator state and spilled window fragments live here, surviving
// process restarts when the DB path is kept.  Design: single append-only data
// log per store + an in-memory hash index (key -> value offset/len), rebuilt
// by a sequential scan on open; deletes are tombstones; compaction rewrites
// the log keeping only live entries.  This favors the streaming write path
// (state write-back per input is the hot loop, p_map.hpp:178-211) over range
// scans, which the persistent operators never do by key order.
//
// Record layout (little-endian, no alignment):
//   [u32 klen][i64 vlen][key bytes][value bytes]     vlen == -1 => tombstone
//
// Thread-safety: a coarse mutex per store.  Replicas run on the host driver's
// cooperative scheduler, so contention is nil; the lock guards shared-DB use
// from auxiliary threads (monitoring, loaders).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Entry {
    int64_t val_off;   // file offset of the value bytes
    int64_t val_len;
};

struct WfKv {
    int fd = -1;
    std::string path;
    int64_t end = 0;         // append offset (log size)
    int64_t live = 0;        // bytes occupied by live records
    std::unordered_map<std::string, Entry> index;
    std::mutex mu;
};

constexpr int64_t kHeader = 12;  // u32 klen + i64 vlen
constexpr uint32_t kMaxKey = 1u << 20;  // writer cap == scanner sanity bound

int64_t record_size(int64_t klen, int64_t vlen) {
    return kHeader + klen + (vlen > 0 ? vlen : 0);
}

bool read_exact(int fd, void* buf, int64_t n, int64_t off) {
    int64_t got = 0;
    auto* p = static_cast<uint8_t*>(buf);
    while (got < n) {
        ssize_t r = pread(fd, p + got, (size_t)(n - got), (off_t)(off + got));
        if (r <= 0) return false;
        got += r;
    }
    return true;
}

bool write_exact(int fd, const void* buf, int64_t n, int64_t off) {
    int64_t put = 0;
    auto* p = static_cast<const uint8_t*>(buf);
    while (put < n) {
        ssize_t r = pwrite(fd, p + put, (size_t)(n - put), (off_t)(off + put));
        if (r < 0) return false;
        put += r;
    }
    return true;
}

// Scan the log rebuilding the index; returns the offset of the first
// malformed/truncated record (the recovery point).
int64_t scan(WfKv* kv) {
    struct stat st;
    if (fstat(kv->fd, &st) != 0) return 0;
    const int64_t size = st.st_size;
    int64_t off = 0;
    std::vector<char> key;
    while (off + kHeader <= size) {
        uint8_t hdr[kHeader];
        if (!read_exact(kv->fd, hdr, kHeader, off)) break;
        uint32_t klen;
        int64_t vlen;
        std::memcpy(&klen, hdr, 4);
        std::memcpy(&vlen, hdr + 4, 8);
        if (vlen < -1 || klen > kMaxKey) break;  // corrupt header
        const int64_t rec = record_size(klen, vlen);
        if (off + rec > size) break;  // truncated tail
        key.resize(klen);
        if (klen && !read_exact(kv->fd, key.data(), klen, off + kHeader)) break;
        std::string k(key.data(), klen);
        auto it = kv->index.find(k);
        if (it != kv->index.end()) {  // superseded: old record is now dead
            kv->live -= record_size(klen, it->second.val_len);
            kv->index.erase(it);
        }
        if (vlen >= 0) {
            kv->index.emplace(std::move(k), Entry{off + kHeader + klen, vlen});
            kv->live += rec;
        }
        off += rec;
    }
    return off;
}

bool append(WfKv* kv, const uint8_t* k, uint32_t klen, const uint8_t* v,
            int64_t vlen) {
    uint8_t hdr[kHeader];
    std::memcpy(hdr, &klen, 4);
    std::memcpy(hdr + 4, &vlen, 8);
    int64_t off = kv->end;
    if (!write_exact(kv->fd, hdr, kHeader, off)) return false;
    if (klen && !write_exact(kv->fd, k, klen, off + kHeader)) return false;
    if (vlen > 0 && !write_exact(kv->fd, v, vlen, off + kHeader + klen))
        return false;
    kv->end = off + record_size(klen, vlen);
    return true;
}

}  // namespace

extern "C" {

void* wf_kv_open(const char* path, int32_t create) {
    int flags = O_RDWR | (create ? O_CREAT : 0);
    int fd = open(path, flags, 0644);
    if (fd < 0) return nullptr;
    auto* kv = new WfKv;
    kv->fd = fd;
    kv->path = path;
    int64_t good = scan(kv);
    struct stat st;
    if (fstat(fd, &st) == 0 && good < st.st_size) {
        // Torn tail from a crash mid-append: drop it so new appends are clean.
        if (ftruncate(fd, (off_t)good) != 0) { /* keep going; appends rewrite */ }
    }
    kv->end = good;
    return kv;
}

int32_t wf_kv_put(void* h, const uint8_t* k, int32_t klen, const uint8_t* v,
                  int64_t vlen) {
    auto* kv = static_cast<WfKv*>(h);
    if ((uint32_t)klen > kMaxKey) return -1;  // scan() rejects larger keys
    std::lock_guard<std::mutex> g(kv->mu);
    int64_t off = kv->end;
    if (!append(kv, k, (uint32_t)klen, v, vlen)) return -1;
    std::string key(reinterpret_cast<const char*>(k), (size_t)klen);
    auto it = kv->index.find(key);
    if (it != kv->index.end()) {
        kv->live -= record_size(klen, it->second.val_len);
        it->second = Entry{off + kHeader + klen, vlen};
    } else {
        kv->index.emplace(std::move(key), Entry{off + kHeader + klen, vlen});
    }
    kv->live += record_size(klen, vlen);
    return 0;
}

// Returns the value length (copying min(vlen, cap) bytes into out), or -1 if
// the key is absent.  A result > cap means the caller's buffer was too small:
// retry with a buffer of the returned size.
int64_t wf_kv_get(void* h, const uint8_t* k, int32_t klen, uint8_t* out,
                  int64_t cap) {
    auto* kv = static_cast<WfKv*>(h);
    std::lock_guard<std::mutex> g(kv->mu);
    auto it = kv->index.find(
        std::string(reinterpret_cast<const char*>(k), (size_t)klen));
    if (it == kv->index.end()) return -1;
    const Entry& e = it->second;
    int64_t n = e.val_len < cap ? e.val_len : cap;
    if (n > 0 && !read_exact(kv->fd, out, n, e.val_off)) return -1;
    return e.val_len;
}

int32_t wf_kv_del(void* h, const uint8_t* k, int32_t klen) {
    auto* kv = static_cast<WfKv*>(h);
    std::lock_guard<std::mutex> g(kv->mu);
    std::string key(reinterpret_cast<const char*>(k), (size_t)klen);
    auto it = kv->index.find(key);
    if (it == kv->index.end()) return 0;
    if (!append(kv, k, (uint32_t)klen, nullptr, -1)) {
        // Tombstone write failed (e.g. ENOSPC): without it, the old record
        // would resurrect on reopen — keep the index entry consistent with
        // the log and report the failure instead.
        return -1;
    }
    kv->live -= record_size(klen, it->second.val_len);
    kv->index.erase(it);
    return 1;
}

int64_t wf_kv_count(void* h) {
    auto* kv = static_cast<WfKv*>(h);
    std::lock_guard<std::mutex> g(kv->mu);
    return (int64_t)kv->index.size();
}

int64_t wf_kv_log_bytes(void* h) {
    auto* kv = static_cast<WfKv*>(h);
    std::lock_guard<std::mutex> g(kv->mu);
    return kv->end;
}

int64_t wf_kv_live_bytes(void* h) {
    auto* kv = static_cast<WfKv*>(h);
    std::lock_guard<std::mutex> g(kv->mu);
    return kv->live;
}

// Rewrite the log keeping only live records; shrinks the file and refreshes
// the index offsets.  Safe against crashes: the new log is built beside the
// old one and renamed over it only once fully written and synced.
int32_t wf_kv_compact(void* h) {
    auto* kv = static_cast<WfKv*>(h);
    std::lock_guard<std::mutex> g(kv->mu);
    std::string tmp = kv->path + ".compact";
    int nfd = open(tmp.c_str(), O_RDWR | O_CREAT | O_TRUNC, 0644);
    if (nfd < 0) return -1;
    int64_t off = 0;
    std::vector<uint8_t> val;
    std::unordered_map<std::string, Entry> nindex;
    nindex.reserve(kv->index.size());
    for (const auto& [key, e] : kv->index) {
        val.resize((size_t)e.val_len);
        if (e.val_len &&
            !read_exact(kv->fd, val.data(), e.val_len, e.val_off)) {
            close(nfd);
            unlink(tmp.c_str());
            return -1;
        }
        uint32_t klen = (uint32_t)key.size();
        uint8_t hdr[kHeader];
        std::memcpy(hdr, &klen, 4);
        std::memcpy(hdr + 4, &e.val_len, 8);
        bool ok = write_exact(nfd, hdr, kHeader, off) &&
                  write_exact(nfd, key.data(), klen, off + kHeader) &&
                  (e.val_len == 0 ||
                   write_exact(nfd, val.data(), e.val_len,
                               off + kHeader + klen));
        if (!ok) {
            close(nfd);
            unlink(tmp.c_str());
            return -1;
        }
        nindex.emplace(key, Entry{off + kHeader + klen, e.val_len});
        off += record_size(klen, e.val_len);
    }
    if (fsync(nfd) != 0 || rename(tmp.c_str(), kv->path.c_str()) != 0) {
        close(nfd);
        unlink(tmp.c_str());
        return -1;
    }
    close(kv->fd);
    kv->fd = nfd;
    kv->end = off;
    kv->live = off;
    kv->index = std::move(nindex);
    return 0;
}

int32_t wf_kv_flush(void* h) {
    auto* kv = static_cast<WfKv*>(h);
    std::lock_guard<std::mutex> g(kv->mu);
    return fsync(kv->fd) == 0 ? 0 : -1;
}

void wf_kv_close(void* h, int32_t delete_db) {
    auto* kv = static_cast<WfKv*>(h);
    {
        std::lock_guard<std::mutex> g(kv->mu);
        close(kv->fd);
        if (delete_db) unlink(kv->path.c_str());
    }
    delete kv;
}

// -- key iteration (snapshot of current keys; used for EOS window flush) -----

struct WfKvIter {
    std::vector<std::string> keys;
    size_t pos = 0;
};

void* wf_kv_iter_new(void* h) {
    auto* kv = static_cast<WfKv*>(h);
    std::lock_guard<std::mutex> g(kv->mu);
    auto* it = new WfKvIter;
    it->keys.reserve(kv->index.size());
    for (const auto& [key, e] : kv->index) {
        (void)e;
        it->keys.push_back(key);
    }
    return it;
}

// Returns the key length (advancing only when it fits in kcap), or -1 when
// exhausted.  A result > kcap means retry with a larger buffer.
int32_t wf_kv_iter_next(void* hi, uint8_t* kout, int32_t kcap) {
    auto* it = static_cast<WfKvIter*>(hi);
    if (it->pos >= it->keys.size()) return -1;
    const std::string& k = it->keys[it->pos];
    if ((int64_t)k.size() > kcap) return (int32_t)k.size();
    std::memcpy(kout, k.data(), k.size());
    it->pos++;
    return (int32_t)k.size();
}

void wf_kv_iter_destroy(void* hi) { delete static_cast<WfKvIter*>(hi); }

}  // extern "C"
