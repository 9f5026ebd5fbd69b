// Native asynchronous checkpoint packer: multi-array .npz (zip) writes.
//
// The ADMM loop's checkpoint payload (node state + edge state + the full
// NaN-padded history) is tens-to-hundreds of MB at 256^2+; the numpy path
// (np.savez_compressed) deflates it on the Python thread, blocking the
// solve for seconds per checkpoint. This packer copies the buffers at
// submit time and builds an uncompressed (stored) zip on a background
// thread — np.load reads it back unchanged, and float image/state data
// barely compresses anyway. Files land atomically (tmp + rename) so an
// interrupted run never leaves a truncated checkpoint behind.
//
// Capability anchor: the reference's chunked checkpoint/resume orchestrator
// (block_6_admm_loop_ver2.py:269-281 snapshot writes, SURVEY.md section 5
// checkpoint/resume row); this is the host runtime half, in C++ like
// the rest of native/.
//
// C API (ctypes-friendly):
//   cp_init(n_threads)                 start the worker pool (idempotent)
//   cp_begin() -> handle               open a new pack
//   cp_add(handle, name, dtype, data, shape, ndim)   copy one array in
//   cp_commit(handle, path)            queue the async zip write
//   cp_abort(handle)                   drop an unfinished pack
//   cp_flush() -> n_failed             block until queued writes hit disk;
//                                      returns #writes that FAILED since the
//                                      last flush (previous file kept)
//   cp_set_zip64_threshold(t)          test hook: lower the zip64 cut-over
// dtype codes: 0='<f4' 1='<f8' 2='<i4' 3='<i8' 4='|b1' 5='|u1'.
// All submit calls copy their buffers; callers may free immediately.

#include <unistd.h>
#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <functional>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Pool {
  std::deque<std::function<void()>> q;
  std::mutex mu;
  std::condition_variable cv;
  std::condition_variable cv_done;
  std::vector<std::thread> workers;
  int active = 0;
  bool stop = false;

  void run() {
    for (;;) {
      std::function<void()> job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop || !q.empty(); });
        if (stop && q.empty()) return;
        job = std::move(q.front());
        q.pop_front();
        ++active;
      }
      job();
      {
        std::lock_guard<std::mutex> lk(mu);
        --active;
        if (q.empty() && active == 0) cv_done.notify_all();
      }
    }
  }

  void start(int n) {
    std::lock_guard<std::mutex> lk(mu);
    while ((int)workers.size() < n) {
      workers.emplace_back([this] { run(); });
      // Detached: the pool lives for the process; callers synchronize via
      // cp_flush(), and detaching avoids std::terminate at static
      // destruction of joinable threads.
      workers.back().detach();
    }
  }

  void submit(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> lk(mu);
      q.push_back(std::move(job));
    }
    cv.notify_one();
  }

  void flush() {
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [&] { return q.empty() && active == 0; });
  }
};

Pool& pool() {
  // Intentionally leaked (see artifact_writer.cpp): detached workers must
  // outlive static destruction; the threads die with the process.
  static Pool* p = new Pool();
  return *p;
}

struct DtypeInfo {
  const char* descr;
  size_t size;
};

bool dtype_info(int code, DtypeInfo* out) {
  switch (code) {
    case 0: *out = {"<f4", 4}; return true;
    case 1: *out = {"<f8", 8}; return true;
    case 2: *out = {"<i4", 4}; return true;
    case 3: *out = {"<i8", 8}; return true;
    case 4: *out = {"|b1", 1}; return true;
    case 5: *out = {"|u1", 1}; return true;
    default: return false;
  }
}

std::vector<uint8_t> encode_npy(const uint8_t* data, const DtypeInfo& dt,
                                const long* shape, int ndim) {
  std::string hdr = "{'descr': '";
  hdr += dt.descr;
  hdr += "', 'fortran_order': False, 'shape': (";
  size_t count = 1;
  for (int i = 0; i < ndim; ++i) {
    char buf[32];
    std::snprintf(buf, sizeof buf, "%ld", shape[i]);
    hdr += buf;
    if (ndim == 1 || i + 1 < ndim) hdr += ",";
    if (i + 1 < ndim) hdr += " ";
    count *= (size_t)shape[i];
  }
  hdr += "), }";
  size_t total = 10 + hdr.size() + 1;  // magic+ver+len + header + '\n'
  size_t pad = (64 - (total % 64)) % 64;
  hdr.append(pad, ' ');
  hdr += '\n';

  std::vector<uint8_t> out;
  out.reserve(10 + hdr.size() + count * dt.size);
  const char magic[] = "\x93NUMPY";
  out.insert(out.end(), magic, magic + 6);
  out.push_back(1);
  out.push_back(0);
  out.push_back((uint8_t)(hdr.size() & 0xff));
  out.push_back((uint8_t)(hdr.size() >> 8));
  out.insert(out.end(), hdr.begin(), hdr.end());
  out.insert(out.end(), data, data + count * dt.size);
  return out;
}

struct Member {
  std::string name;  // zip member name, e.g. "x.npy"
  std::vector<uint8_t> bytes;
};

struct Packs {
  std::mutex mu;
  std::map<long long, std::vector<Member>> open;
  long long next_id = 1;
};

Packs& packs() {
  static Packs* p = new Packs();
  return *p;
}

void put_le16(std::vector<uint8_t>& v, uint16_t x) {
  v.push_back(x & 0xff);
  v.push_back((x >> 8) & 0xff);
}

void put_le32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(x & 0xff);
  v.push_back((x >> 8) & 0xff);
  v.push_back((x >> 16) & 0xff);
  v.push_back((x >> 24) & 0xff);
}

// Failed background writes since the last cp_flush. A checkpoint write that
// fails (ENOSPC, permission, ...) must never silently replace or masquerade
// as a good one: write_zip leaves the previous file in place on any error
// and bumps this counter, which cp_flush returns (and clears) so the caller
// can raise or fall back to the synchronous writer.
std::atomic<int> g_write_errors{0};

void put_le64(std::vector<uint8_t>& v, uint64_t x) {
  for (int i = 0; i < 8; ++i) v.push_back((x >> (8 * i)) & 0xff);
}

// Any size/offset at or above this switches the record to zip64. The spec
// value is 0xFFFFFFFF; tests lower it via cp_set_zip64_threshold so the
// zip64 paths are exercised without multi-GiB payloads.
std::atomic<uint64_t> g_zip64_threshold{0xFFFFFFFFull};

// zlib's crc32 takes a uInt (32-bit) length, so a single call silently
// truncates members >= 4 GiB to size mod 2^32 — exactly the members the
// zip64 path exists for. Feed it in bounded chunks instead. The chunk size
// is a test hook (cp_set_crc_chunk) so the loop is exercised by the test
// suite with small members; np.load verifies the CRC on read, which makes
// the round-trip test a check of this field.
std::atomic<uint64_t> g_crc_chunk{1ull << 30};

uint32_t crc32_full(const std::vector<uint8_t>& bytes) {
  const uint64_t chunk = g_crc_chunk.load();
  uLong crc = crc32(0L, Z_NULL, 0);
  size_t off = 0;
  while (off < bytes.size()) {
    size_t n = bytes.size() - off;
    if (n > chunk) n = (size_t)chunk;
    crc = crc32(crc, bytes.data() + off, (uInt)n);
    off += n;
  }
  return (uint32_t)crc;
}

bool wr(FILE* f, const void* p, size_t n) {
  return std::fwrite(p, 1, n, f) == n;
}

bool wr(FILE* f, const std::vector<uint8_t>& v) {
  return v.empty() || wr(f, v.data(), v.size());
}

// Minimal stored-method zip with zip64 records (np.load / python zipfile
// compatible), so >4 GiB checkpoint states (512^2/64-node Z/Y) stay on the
// async path instead of falling back to the blocking numpy writer.
//
// Streams each member to the file as it goes (headers buffered, payload
// bytes written straight from the Member copy) — the archive is never
// assembled in memory, so a multi-GiB checkpoint costs one copy (the
// submit-time Member), not two.
void write_zip(const std::string& path, const std::vector<Member>& members) {
  const uint64_t lim = g_zip64_threshold.load();
  struct DirEnt {
    std::string name;
    uint32_t crc;
    uint64_t size, offset;
  };
  std::vector<DirEnt> dir;
  bool any64 = false;

  std::string tmp = path + ".tmp";
  FILE* f = std::fopen(tmp.c_str(), "wb");
  if (!f) {
    ++g_write_errors;
    return;
  }
  bool ok = true;
  uint64_t offset = 0;
  for (const auto& m : members) {
    uint32_t crc = crc32_full(m.bytes);
    uint64_t sz = m.bytes.size();
    bool f64 = sz >= lim;                // sizes overflow the 32-bit fields
    any64 = any64 || f64;
    std::vector<uint8_t> hdr;
    put_le32(hdr, 0x04034b50);           // local file header
    put_le16(hdr, f64 ? 45 : 20);        // version needed
    put_le16(hdr, 0);                    // flags
    put_le16(hdr, 0);                    // method: stored
    put_le16(hdr, 0);                    // mod time
    put_le16(hdr, 0);                    // mod date
    put_le32(hdr, crc);
    if (f64) {                           // sizes live in the zip64 extra
      put_le32(hdr, 0xFFFFFFFFu);        // compressed size
      put_le32(hdr, 0xFFFFFFFFu);        // uncompressed size
    } else {
      put_le32(hdr, (uint32_t)sz);
      put_le32(hdr, (uint32_t)sz);
    }
    put_le16(hdr, (uint16_t)m.name.size());
    put_le16(hdr, f64 ? 20 : 0);         // extra len
    hdr.insert(hdr.end(), m.name.begin(), m.name.end());
    if (f64) {
      put_le16(hdr, 0x0001);             // zip64 extra field tag
      put_le16(hdr, 16);                 // original + compressed, 8 B each
      put_le64(hdr, sz);                 // original (uncompressed) size
      put_le64(hdr, sz);                 // compressed size
    }
    ok = wr(f, hdr) && wr(f, m.bytes);
    if (!ok) break;
    dir.push_back({m.name, crc, sz, offset});
    offset += hdr.size() + sz;
  }
  uint64_t dir_start = offset;
  std::vector<uint8_t> out;  // central directory + end records (small)
  for (const auto& d : dir) {
    bool sz64 = d.size >= lim;
    bool off64 = d.offset >= lim;
    any64 = any64 || sz64 || off64;
    uint16_t extra_len = (sz64 ? 16 : 0) + (off64 ? 8 : 0) +
                         ((sz64 || off64) ? 4 : 0);
    put_le32(out, 0x02014b50);           // central directory header
    put_le16(out, 45);                   // version made by
    put_le16(out, (sz64 || off64) ? 45 : 20);  // version needed
    put_le16(out, 0);                    // flags
    put_le16(out, 0);                    // method
    put_le16(out, 0);                    // time
    put_le16(out, 0);                    // date
    put_le32(out, d.crc);
    put_le32(out, sz64 ? 0xFFFFFFFFu : (uint32_t)d.size);
    put_le32(out, sz64 ? 0xFFFFFFFFu : (uint32_t)d.size);
    put_le16(out, (uint16_t)d.name.size());
    put_le16(out, extra_len);            // extra
    put_le16(out, 0);                    // comment
    put_le16(out, 0);                    // disk number
    put_le16(out, 0);                    // internal attrs
    put_le32(out, 0);                    // external attrs
    put_le32(out, off64 ? 0xFFFFFFFFu : (uint32_t)d.offset);
    out.insert(out.end(), d.name.begin(), d.name.end());
    if (sz64 || off64) {
      // zip64 extra: only the overflowed fields, in spec order
      // (uncompressed, compressed, offset).
      put_le16(out, 0x0001);
      put_le16(out, extra_len - 4);
      if (sz64) {
        put_le64(out, d.size);
        put_le64(out, d.size);
      }
      if (off64) put_le64(out, d.offset);
    }
  }
  uint64_t dir_size = out.size();
  bool eocd64 = any64 || dir.size() >= 0xFFFF || dir_size >= lim ||
                dir_start >= lim;
  if (eocd64) {
    uint64_t eocd64_start = dir_start + out.size();
    put_le32(out, 0x06064b50);           // zip64 end of central directory
    put_le64(out, 44);                   // record size (fixed fields)
    put_le16(out, 45);                   // version made by
    put_le16(out, 45);                   // version needed
    put_le32(out, 0);                    // disk
    put_le32(out, 0);                    // dir disk
    put_le64(out, dir.size());
    put_le64(out, dir.size());
    put_le64(out, dir_size);
    put_le64(out, dir_start);
    put_le32(out, 0x07064b50);           // zip64 EOCD locator
    put_le32(out, 0);                    // disk with the zip64 EOCD
    put_le64(out, eocd64_start);
    put_le32(out, 1);                    // total disks
  }
  put_le32(out, 0x06054b50);             // end of central directory
  put_le16(out, 0);                      // disk
  put_le16(out, 0);                      // dir disk
  uint16_t n16 = dir.size() >= 0xFFFF ? 0xFFFF : (uint16_t)dir.size();
  put_le16(out, n16);
  put_le16(out, n16);
  put_le32(out, dir_size >= lim ? 0xFFFFFFFFu : (uint32_t)dir_size);
  put_le32(out, dir_start >= lim ? 0xFFFFFFFFu : (uint32_t)dir_start);
  put_le16(out, 0);                      // comment len

  // Atomic + checked: any failure (open, short write, fsync, close, rename)
  // unlinks the tmp file and keeps the previous checkpoint intact.
  ok = ok && wr(f, out);
  if (ok) ok = std::fflush(f) == 0 && fsync(fileno(f)) == 0;
  ok = (std::fclose(f) == 0) && ok;
  if (ok) ok = std::rename(tmp.c_str(), path.c_str()) == 0;
  if (!ok) {
    std::remove(tmp.c_str());
    ++g_write_errors;
  }
}

}  // namespace

extern "C" {

int cp_init(int n_threads) {
  pool().start(n_threads > 0 ? n_threads : 1);
  return 0;
}

long long cp_begin() {
  auto& ps = packs();
  std::lock_guard<std::mutex> lk(ps.mu);
  long long id = ps.next_id++;
  ps.open[id];  // create empty
  return id;
}

int cp_add(long long handle, const char* name, int dtype,
           const uint8_t* data, const long* shape, int ndim) {
  if (ndim < 0 || ndim > 8) return 1;
  DtypeInfo dt;
  if (!dtype_info(dtype, &dt)) return 1;
  // try/catch: a bad_alloc on a multi-GiB copy must come back as an error
  // code, not a C++ exception unwinding through the ctypes FFI boundary.
  try {
    std::vector<uint8_t> npy = encode_npy(data, dt, shape, ndim);
    auto& ps = packs();
    std::lock_guard<std::mutex> lk(ps.mu);
    auto it = ps.open.find(handle);
    if (it == ps.open.end()) return 2;
    it->second.push_back({std::string(name) + ".npy", std::move(npy)});
    return 0;
  } catch (...) {
    return 3;
  }
}

int cp_commit(long long handle, const char* path) {
  std::vector<Member> members;
  {
    auto& ps = packs();
    std::lock_guard<std::mutex> lk(ps.mu);
    auto it = ps.open.find(handle);
    if (it == ps.open.end()) return 2;
    members = std::move(it->second);
    ps.open.erase(it);
  }
  // No size guard: write_zip emits zip64 records past the 4 GiB / 65535-
  // member zip32 limits, so arbitrarily large states stay on the async path.
  std::string p(path);
  pool().submit([p, members = std::move(members)] {
    // A throw (e.g. bad_alloc building the header tail) in a detached pool
    // thread would terminate the process; count it as a failed write so
    // cp_flush() surfaces it instead.
    try {
      write_zip(p, members);
    } catch (...) {
      ++g_write_errors;
    }
  });
  return 0;
}

int cp_abort(long long handle) {
  auto& ps = packs();
  std::lock_guard<std::mutex> lk(ps.mu);
  ps.open.erase(handle);
  return 0;
}

// Blocks until every queued write finished; returns the number of writes
// that FAILED since the previous flush (0 = all checkpoints on disk).
int cp_flush() {
  pool().flush();
  return g_write_errors.exchange(0);
}

// Test hook: lower the zip64 switch-over so the zip64 record paths are
// exercised without multi-GiB payloads. 0 restores the spec threshold.
void cp_set_zip64_threshold(unsigned long long t) {
  g_zip64_threshold.store(t ? t : 0xFFFFFFFFull);
}

// Test hook: shrink the per-call crc32 chunk so the chunked-CRC loop (the
// >4 GiB correctness path) runs over small members too. 0 restores 1 GiB.
// Clamped below 2^32: a larger chunk would reintroduce the (uInt) length
// truncation this mechanism exists to prevent.
void cp_set_crc_chunk(unsigned long long n) {
  if (n == 0 || n > (1ull << 30)) n = 1ull << 30;
  g_crc_chunk.store(n);
}

}  // extern "C"
