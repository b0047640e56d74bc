// nwio — native IO engine for the fvec/ivec vector formats (host C++).
//
// The host side of the GPU pipeline: bulk header-stripped reads spread over
// threads, interleaved writes, and a streaming reader whose producer thread
// reads batch b+1 from disk while the consumer works on batch b.
//
// File layout (little-endian), the same bytes as the numpy codec in
// io/fvec.py:
//     per vector: int32 dim | dim * 4-byte payload (f32 for fvec, i32 for ivec)
//
// A plain C ABI, bound with ctypes (native/nwio.py). Every function returns
// 0 or a row count on success and a negative code on error:
//   -1 open/stat failed, -2 bad header, -3 heterogeneous dims (size not a
//   whole number of rows), -4 short read or write, -5 a row header differs,
//   -6 rows out of range, -7 the file's dim differs from the caller's.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr int64_t kChunkRows = 8192;  // rows a thread's span starts at
constexpr int64_t kScratchBytes = 4 << 20;  // one pread's raw rows

struct FileInfo {
  int64_t n_rows;
  int32_t dim;
  int64_t row_bytes;  // 4 * (dim + 1)
};

int probe_file(const char* path, FileInfo* info) {
  struct stat st;
  if (::stat(path, &st) != 0) return -1;
  if (st.st_size == 0) {
    info->n_rows = 0;
    info->dim = 0;
    info->row_bytes = 0;
    return 0;
  }
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  int32_t dim = 0;
  ssize_t got = ::pread(fd, &dim, 4, 0);
  ::close(fd);
  if (got != 4 || dim <= 0) return -2;
  int64_t row_bytes = 4LL * (dim + 1);
  if (st.st_size % row_bytes != 0) return -3;
  info->n_rows = st.st_size / row_bytes;
  info->dim = dim;
  info->row_bytes = row_bytes;
  return 0;
}

// Read rows [row_start, row_start + n_rows) of an open fd, stripping the
// per-row dim headers into the dense payload buffer `out`. Returns rows
// read, or -4 / -5.
int64_t read_span(int fd, const FileInfo& fi, int64_t row_start,
                  int64_t n_rows, char* out) {
  // a few MB of scratch, reused for every pread of the span: it stays in
  // cache and the allocator does not hand back fresh pages per call
  const int64_t chunk = std::max<int64_t>(1, kScratchBytes / fi.row_bytes);
  std::vector<char> scratch(
      static_cast<size_t>(std::min(n_rows, chunk) * fi.row_bytes));
  const int64_t payload = 4LL * fi.dim;
  int64_t done = 0;
  while (done < n_rows) {
    int64_t take = std::min(chunk, n_rows - done);
    int64_t off = (row_start + done) * fi.row_bytes;
    int64_t want = take * fi.row_bytes;
    int64_t got = 0;
    while (got < want) {
      ssize_t r = ::pread(fd, scratch.data() + got, want - got, off + got);
      if (r <= 0) return -4;
      got += r;
    }
    for (int64_t i = 0; i < take; ++i) {
      const char* row = scratch.data() + i * fi.row_bytes;
      int32_t dim;
      std::memcpy(&dim, row, 4);
      if (dim != fi.dim) return -5;
      std::memcpy(out + (done + i) * payload, row + 4, payload);
    }
    done += take;
  }
  return done;
}

// Rows [start, start + n) into `out`, split into contiguous spans over
// up to n_threads threads. Returns rows read or the first span's error.
int64_t read_parallel(int fd, const FileInfo& fi, int64_t start, int64_t n,
                      char* out, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  int64_t span = (n + n_threads - 1) / n_threads;
  std::vector<std::thread> workers;
  std::vector<int64_t> results(static_cast<size_t>(n_threads), 0);
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * span;
    if (lo >= n) break;
    int64_t take = std::min(span, n - lo);
    workers.emplace_back([&, t, lo, take] {
      results[static_cast<size_t>(t)] =
          read_span(fd, fi, start + lo, take, out + lo * 4LL * fi.dim);
    });
  }
  for (auto& w : workers) w.join();
  int64_t total = 0;
  for (int64_t r : results) {
    if (r < 0) return r;
    total += r;
  }
  return total;
}

// memcpy of `bytes` split into contiguous spans over n_threads threads.
void copy_parallel(char* dst, const char* src, int64_t bytes,
                   int n_threads) {
  if (n_threads <= 1) {
    std::memcpy(dst, src, static_cast<size_t>(bytes));
    return;
  }
  int64_t span = (bytes + n_threads - 1) / n_threads;
  std::vector<std::thread> workers;
  for (int64_t lo = 0; lo < bytes; lo += span) {
    int64_t n = std::min(span, bytes - lo);
    workers.emplace_back([=] {
      std::memcpy(dst + lo, src + lo, static_cast<size_t>(n));
    });
  }
  for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

// n_out <- row count, dim_out <- per-row dimension. 0 on success.
int nwio_fvec_probe(const char* path, int64_t* n_out, int32_t* dim_out) {
  FileInfo fi;
  int rc = probe_file(path, &fi);
  if (rc != 0) return rc;
  *n_out = fi.n_rows;
  *dim_out = fi.dim;
  return 0;
}

// Bulk read rows [row_start, row_start + n_rows) into `out`
// (n_rows * expected_dim * 4 bytes, dense, no headers), spread over
// n_threads threads. The file is probed again here, so expected_dim (the
// width of the caller's buffer) must equal the file's dim: a file rewritten
// wider since the caller's probe would overrun the buffer, a narrower one
// would leave its tail columns unwritten. -7 on mismatch.
int64_t nwio_fvec_read_rows(const char* path, int64_t row_start,
                            int64_t n_rows, void* out, int n_threads,
                            int32_t expected_dim) {
  FileInfo fi;
  int rc = probe_file(path, &fi);
  if (rc != 0) return rc;
  if (fi.dim != expected_dim) return -7;
  if (row_start < 0 || n_rows < 0 || row_start + n_rows > fi.n_rows) {
    return -6;
  }
  if (n_rows == 0) return 0;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  int64_t got = read_parallel(fd, fi, row_start, n_rows,
                              static_cast<char*>(out), n_threads);
  ::close(fd);
  return got;
}

// Write (or append) n dense rows of `dim` 4-byte words, interleaving the
// per-row int32 dim headers. Returns rows written or a negative error.
int64_t nwio_fvec_write_rows(const char* path, int append, const void* data,
                             int64_t n, int32_t dim) {
  FILE* f = std::fopen(path, append ? "ab" : "wb");
  if (!f) return -1;
  const int64_t payload = 4LL * dim;
  const int64_t row_bytes = payload + 4;
  std::vector<char> buf(
      static_cast<size_t>(std::min(n > 0 ? n : 1, kChunkRows) * row_bytes));
  int64_t done = 0;
  while (done < n) {
    int64_t take = std::min(kChunkRows, n - done);
    for (int64_t i = 0; i < take; ++i) {
      char* row = buf.data() + i * row_bytes;
      std::memcpy(row, &dim, 4);
      std::memcpy(row + 4,
                  static_cast<const char*>(data) + (done + i) * payload,
                  payload);
    }
    if (std::fwrite(buf.data(), 1, take * row_bytes, f) !=
        static_cast<size_t>(take * row_bytes)) {
      std::fclose(f);
      return -4;
    }
    done += take;
  }
  if (std::fclose(f) != 0) return -4;
  return done;
}

// ---------------------------------------------------------------------------
// Streaming reader: a producer thread fills two slots in turn, reading the
// next batch while the consumer copies out the current one.
// ---------------------------------------------------------------------------

struct NwioStream {
  FileInfo fi;
  int fd = -1;
  int64_t batch_rows = 0;
  int64_t next_row = 0;  // producer cursor
  int n_threads = 1;

  std::unique_ptr<char[]> buf[2];
  int64_t rows_in[2] = {0, 0};
  int64_t err = 0;
  bool ready[2] = {false, false};
  bool eof_produced = false;
  int prod_slot = 0;
  int cons_slot = 0;

  std::mutex mu;
  std::condition_variable cv;
  std::thread producer;
  std::atomic<bool> stop{false};

  void produce() {
    for (;;) {
      int64_t start, take;
      int slot;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop.load() || !ready[prod_slot]; });
        if (stop.load()) return;
        slot = prod_slot;
        start = next_row;
        take = std::min(batch_rows, fi.n_rows - start);
        if (take <= 0) {
          eof_produced = true;
          cv.notify_all();
          return;
        }
        next_row += take;
        prod_slot ^= 1;
      }
      // the slot is the producer's until it is marked ready; batches
      // below one chunk per thread skip the thread spawns
      int64_t got = take < kChunkRows
          ? read_span(fd, fi, start, take, buf[slot].get())
          : read_parallel(fd, fi, start, take, buf[slot].get(), n_threads);
      {
        std::unique_lock<std::mutex> lk(mu);
        if (got < 0) err = got;
        rows_in[slot] = got < 0 ? 0 : got;
        ready[slot] = true;
        cv.notify_all();
      }
    }
  }
};

// A stream over a non-empty file whose dim equals expected_dim (the
// consumer sizes its buffers from an earlier probe, so a file rewritten at
// another width in between is refused here); nullptr otherwise.
void* nwio_stream_open(const char* path, int64_t batch_rows, int n_threads,
                       int32_t expected_dim) {
  if (batch_rows < 1) return nullptr;
  auto* s = new (std::nothrow) NwioStream;
  if (!s) return nullptr;
  if (probe_file(path, &s->fi) != 0 || s->fi.n_rows == 0 ||
      s->fi.dim != expected_dim) {
    delete s;
    return nullptr;
  }
  s->fd = ::open(path, O_RDONLY);
  if (s->fd < 0) {
    delete s;
    return nullptr;
  }
  s->batch_rows = batch_rows;
  s->n_threads = n_threads < 1 ? 1 : n_threads;
  // a slot holds one batch, never more rows than the file; left
  // uninitialized (the producer writes every byte it hands out)
  size_t cap = static_cast<size_t>(std::min(batch_rows, s->fi.n_rows) *
                                   4LL * s->fi.dim);
  s->buf[0].reset(new (std::nothrow) char[cap]);
  s->buf[1].reset(new (std::nothrow) char[cap]);
  if (!s->buf[0] || !s->buf[1]) {
    ::close(s->fd);
    delete s;
    return nullptr;
  }
  s->producer = std::thread([s] { s->produce(); });
  return s;
}

// Copies the next batch into `out` (capacity batch_rows * dim * 4 bytes).
// Returns rows copied, 0 at EOF, negative on error.
int64_t nwio_stream_next(void* handle, void* out) {
  auto* s = static_cast<NwioStream*>(handle);
  int slot;
  int64_t rows;
  {
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv.wait(lk, [&] {
      return s->err != 0 || s->ready[s->cons_slot] || s->eof_produced;
    });
    if (s->err != 0) return s->err;
    if (!s->ready[s->cons_slot]) return 0;  // EOF
    slot = s->cons_slot;
    rows = s->rows_in[slot];
  }
  // the copy into the caller's fresh buffer faults its pages in: spread
  // it over the stream's threads as the reads are
  copy_parallel(static_cast<char*>(out), s->buf[slot].get(),
                rows * 4LL * s->fi.dim,
                rows < kChunkRows ? 1 : s->n_threads);
  {
    std::unique_lock<std::mutex> lk(s->mu);
    s->ready[slot] = false;
    s->cons_slot ^= 1;
    s->cv.notify_all();
  }
  return rows;
}

void nwio_stream_close(void* handle) {
  auto* s = static_cast<NwioStream*>(handle);
  {
    std::unique_lock<std::mutex> lk(s->mu);
    s->stop.store(true);
    s->cv.notify_all();
  }
  if (s->producer.joinable()) s->producer.join();
  if (s->fd >= 0) ::close(s->fd);
  delete s;
}

}  // extern "C"
