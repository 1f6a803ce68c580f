// Native IQ stream loader: a reusable buffer pool fed by a reader thread.
//
// This is the framework's native runtime equivalent of the reference's
// Datastore buffer pool + producer read loop (datastore.{h,cxx},
// acquisition.cxx:276-332) — re-designed as a standalone C++ component
// so the byte-moving path (file descriptors, sockets, pipes) never touches
// Python: the Python/JAX side only acquires filled buffers (zero-copy via
// numpy frombuffer on the returned pointer) and releases them after the
// device DMA has consumed them.
//
// Parity features:
//  * bounded pool with backpressure (reader blocks when no buffer is free);
//  * queue-depth histogram sampled at every reader grab — the reference's
//    "first number nonzero => consumer too slow" diagnostic
//    (acquisition.cxx:279, doc/rtl_power_fftw.1.md:136-148);
//  * optional byte-rate pacing to emulate a real-time SDR source;
//  * optional looping over a finite stream (recorded-file benchmarking).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC loader.cpp -o librpf_loader.so -lpthread

#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

using Clock = std::chrono::steady_clock;

struct Slot {
  std::vector<uint8_t> data;
  size_t filled = 0;
  // mmap mode: non-null points straight into the file mapping (zero-copy
  // slot view); null means the slot's own buffer holds the bytes (pread
  // mode, or an mmap loop-wrap chunk assembled from two pieces).
  const uint8_t* ext = nullptr;
};

struct Loader {
  std::vector<Slot> slots;
  std::deque<int> free_q;     // slots available for the reader
  std::deque<int> filled_q;   // slots ready for the consumer
  std::vector<long> histogram;  // histogram[n_free] counts, size n_slots+1

  std::mutex mu;
  std::condition_variable cv;
  std::thread reader;
  std::atomic<bool> stop_flag{false};
  bool eof = false;           // reader finished (end of stream or error)
  long bytes_read = 0;

  int fd = -1;
  bool loop = false;
  bool started = false;   // a Loader streams once; create a new one to restart
  off_t file_start = 0;
  double pace_bytes_per_s = 0.0;

  // mmap mode (round-5 copy-free ingest): the whole file is mapped once
  // and in-bounds chunks are delivered as VIEWS of the mapping — the
  // kernel page-cache copy that bounds a read()/pread() chain (~3.6 GB/s
  // measured on this host, BENCHMARKS "Host-chain attribution") drops
  // out entirely; reader threads only FAULT the pages in ahead of the
  // consumer. Loop-wrap chunks (stream position crossing the file end)
  // are assembled into the slot's own buffer, so delivery stays
  // byte-identical to the sequential reader in every mode.
  uint8_t* map_base = nullptr;
  size_t map_len = 0;
  bool mmap_mode = false;

  // Multi-reader state (seekable files only): readers claim chunk
  // indices under mu (only ever together with a won slot), pread in
  // parallel, and deliver IN ORDER through a reorder map — the consumer
  // sees the exact byte stream the sequential reader would produce.
  std::vector<std::thread> readers_mt;
  off_t span = 0;            // stream bytes from file_start
  long chunks_total = -1;    // !loop: number of chunks; -1 = unbounded
  long next_chunk = 0;  // guarded by mu
  long next_deliver = 0;
  std::map<long, int> pending_mt;  // chunk -> filled slot awaiting order

  ~Loader() {
    join();
    if (map_base) ::munmap(map_base, map_len);
  }

  void join() {
    stop_flag.store(true);
    cv.notify_all();
    if (reader.joinable()) reader.join();
    for (auto& t : readers_mt)
      if (t.joinable()) t.join();
    readers_mt.clear();
  }

  // Called with mu held: release consecutive pending chunks to the
  // consumer; at the stream end, recycle any overshoot chunks.
  void deliver_ready_locked() {
    if (eof) {  // stream already ended: late chunks are recycled, not leaked
      for (auto& kv : pending_mt) free_q.push_back(kv.second);
      pending_mt.clear();
      cv.notify_all();
      return;
    }
    while (!pending_mt.empty() && pending_mt.begin()->first == next_deliver) {
      int idx = pending_mt.begin()->second;
      pending_mt.erase(pending_mt.begin());
      if (slots[static_cast<size_t>(idx)].filled > 0) {
        filled_q.push_back(idx);
      } else {
        free_q.push_back(idx);
      }
      next_deliver++;
      if (chunks_total >= 0 && next_deliver >= chunks_total) {
        eof = true;
        // Chunks past the (possibly error-shortened) end are dead weight.
        for (auto& kv : pending_mt) free_q.push_back(kv.second);
        pending_mt.clear();
        break;
      }
    }
    cv.notify_all();
  }

  void reader_main_mt() {
    const size_t B = slots[0].data.size();
    for (;;) {
      int slot_idx;
      long k;
      {
        // Claim the chunk index only AFTER winning a slot, under one
        // lock: a claimed chunk therefore always owns a slot, so ordered
        // delivery can never starve (claiming first deadlocks — cv
        // wakeup order is arbitrary, and readers holding high chunks can
        // drain the pool while the lowest-chunk reader waits slotless).
        std::unique_lock<std::mutex> lk(mu);
        size_t free_n = free_q.size();
        if (free_n >= histogram.size()) free_n = histogram.size() - 1;
        histogram[free_n]++;
        cv.wait(lk, [&] { return stop_flag.load() || !free_q.empty(); });
        if (stop_flag.load()) return;
        if (chunks_total >= 0 && next_chunk >= chunks_total) return;
        slot_idx = free_q.front();
        free_q.pop_front();
        k = next_chunk++;
      }

      Slot& slot = slots[static_cast<size_t>(slot_idx)];
      slot.ext = nullptr;
      size_t want = B;
      if (!loop) {
        long long remain = static_cast<long long>(span)
            - static_cast<long long>(k) * static_cast<long long>(B);
        if (remain < static_cast<long long>(want))
          want = remain > 0 ? static_cast<size_t>(remain) : 0;
      }
      size_t got = 0;
      bool err = false;
      if (mmap_mode) {
        long long stream_pos = static_cast<long long>(k)
            * static_cast<long long>(B);
        off_t pos = loop ? static_cast<off_t>(stream_pos % span)
                         : static_cast<off_t>(stream_pos);
        if (want > 0 &&
            static_cast<long long>(want) <= static_cast<long long>(span - pos)) {
          // In-bounds chunk (every !loop chunk, since `want` is tail-
          // clamped above): ZERO-COPY view of the mapping. Touch one
          // byte per page so the faults land on this reader thread, not
          // on the consumer mid-dispatch.
          const uint8_t* p = map_base + file_start + pos;
          volatile uint8_t sink = 0;
          for (size_t off = 0; off < want; off += 4096) sink += p[off];
          sink += p[want - 1];
          (void)sink;
          slot.ext = p;
          got = want;
        } else {
          // Loop-wrap chunk: assemble the two mapped pieces into the
          // slot's own buffer (delivery stays sequential-exact).
          while (got < want) {
            off_t p2 = static_cast<off_t>(
                (stream_pos + static_cast<long long>(got)) % span);
            size_t len = want - got;
            if (static_cast<long long>(len) >
                static_cast<long long>(span - p2))
              len = static_cast<size_t>(span - p2);
            std::memcpy(slot.data.data() + got, map_base + file_start + p2,
                        len);
            got += len;
            if (stop_flag.load()) break;
          }
        }
      } else {
        while (got < want) {
          long long stream_pos = static_cast<long long>(k)
              * static_cast<long long>(B) + static_cast<long long>(got);
          off_t pos = loop ? static_cast<off_t>(stream_pos % span)
                           : static_cast<off_t>(stream_pos);
          size_t len = want - got;
          if (static_cast<long long>(len) > static_cast<long long>(span - pos))
            len = static_cast<size_t>(span - pos);
          ssize_t n = ::pread(fd, slot.data.data() + got, len,
                              file_start + pos);
          if (n < 0 && errno == EINTR) continue;  // signal (e.g. Ctrl+C
          // delivered to a reader thread) must not truncate the stream
          if (n <= 0) { err = true; break; }
          got += static_cast<size_t>(n);
          if (stop_flag.load()) break;
        }
      }

      {
        std::lock_guard<std::mutex> lk(mu);
        slot.filled = got;
        bytes_read += static_cast<long>(got);
        pending_mt[k] = slot_idx;
        if (err || (got < want)) {
          // A short/failed chunk ends the stream exactly where a
          // sequential reader would have stopped.
          if (chunks_total < 0 || chunks_total > k + 1)
            chunks_total = k + 1;
        }
        deliver_ready_locked();
      }
      if (stop_flag.load()) return;
    }
  }

  void reader_main() {
    const auto t0 = Clock::now();
    long paced_bytes = 0;
    for (;;) {
      int slot_idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        size_t free_n = free_q.size();
        if (free_n >= histogram.size()) free_n = histogram.size() - 1;
        histogram[free_n]++;
        cv.wait(lk, [&] { return stop_flag.load() || !free_q.empty(); });
        if (stop_flag.load()) return;
        slot_idx = free_q.front();
        free_q.pop_front();
      }

      Slot& slot = slots[slot_idx];
      slot.ext = nullptr;
      size_t want = slot.data.size();
      size_t got = 0;
      bool ended = false;
      while (got < want) {
        ssize_t n = ::read(fd, slot.data.data() + got, want - got);
        if (n < 0 && errno == EINTR) continue;  // interrupted, not ended
        if (n > 0) {
          got += static_cast<size_t>(n);
        } else if (n == 0) {
          if (loop) {
            if (::lseek(fd, file_start, SEEK_SET) < 0) { ended = true; break; }
          } else {
            ended = true;
            break;
          }
        } else {
          ended = true;  // read error: treat as end of stream
          break;
        }
        if (stop_flag.load()) { ended = true; break; }
      }

      if (pace_bytes_per_s > 0.0 && got > 0) {
        // Sleep so cumulative delivery tracks the requested byte rate.
        paced_bytes += static_cast<long>(got);
        auto due = t0 + std::chrono::duration_cast<Clock::duration>(
            std::chrono::duration<double>(paced_bytes / pace_bytes_per_s));
        std::this_thread::sleep_until(due);
      }

      {
        std::lock_guard<std::mutex> lk(mu);
        slot.filled = got;
        bytes_read += static_cast<long>(got);
        if (got > 0) {
          filled_q.push_back(slot_idx);
        } else {
          free_q.push_back(slot_idx);
        }
        if (ended) eof = true;
        cv.notify_all();
      }
      if (ended) return;
    }
  }
};

}  // namespace

extern "C" {

Loader* rpf_loader_create(size_t buf_bytes, int n_buffers) {
  if (buf_bytes == 0 || n_buffers <= 0) return nullptr;
  auto* L = new Loader();
  L->slots.resize(static_cast<size_t>(n_buffers));
  for (int i = 0; i < n_buffers; i++) {
    L->slots[static_cast<size_t>(i)].data.resize(buf_bytes);
    L->free_q.push_back(i);
  }
  L->histogram.assign(static_cast<size_t>(n_buffers) + 1, 0);
  return L;
}

// Start streaming from a file descriptor. `loop` restarts at the current
// offset on EOF; `pace_bytes_per_s` throttles delivery (0 = full speed).
// `n_readers` > 1 enables parallel pread readers with ordered delivery —
// byte-identical to the sequential reader, several times the throughput
// on page-cache/NVMe-backed recordings (a single read() thread is
// kernel-memcpy-bound around 3-4 GB/s). Requires a seekable fd of known
// nonzero size and no pacing; anything else falls back to one reader.
// `use_mmap`: -1 auto (on for unpaced seekable files of known size),
// 0 off, 1 on-where-possible. In mmap mode slots become zero-copy VIEWS
// of the file mapping (see Loader::mmap_mode) and the same chunked
// ordered-delivery machinery runs with >= 1 page-fault prefetch threads.
// Deadlock-freedom: the pool must satisfy n_buffers >= consumer_pins +
// n_readers, else readers and a stalled consumer can starve each other.
int rpf_loader_start_fd2(Loader* L, int fd, int loop, double pace_bytes_per_s,
                         int n_readers, int use_mmap) {
  if (!L || fd < 0 || L->started) return -1;
  L->started = true;
  L->fd = fd;
  L->loop = loop != 0;
  L->file_start = ::lseek(fd, 0, SEEK_CUR);
  bool seekable = L->file_start >= 0;
  if (!seekable) L->file_start = 0;  // non-seekable: loop disabled
  L->pace_bytes_per_s = pace_bytes_per_s;
  L->stop_flag.store(false);
  L->eof = false;

  if ((n_readers > 1 || use_mmap != 0) && seekable
      && pace_bytes_per_s <= 0.0) {
    struct stat st;
    if (::fstat(fd, &st) == 0 && st.st_size > L->file_start) {
      L->span = st.st_size - L->file_start;
      const long B = static_cast<long>(L->slots[0].data.size());
      L->chunks_total = L->loop ? -1
          : static_cast<long>((static_cast<long long>(L->span) + B - 1) / B);
      L->next_chunk = 0;
      L->next_deliver = 0;
      if (use_mmap != 0) {
        void* m = ::mmap(nullptr, static_cast<size_t>(st.st_size),
                         PROT_READ, MAP_SHARED, fd, 0);
        if (m != MAP_FAILED) {
          L->map_base = static_cast<uint8_t*>(m);
          L->map_len = static_cast<size_t>(st.st_size);
          L->mmap_mode = true;
#ifdef MADV_SEQUENTIAL
          ::madvise(m, L->map_len,
                    L->loop ? MADV_WILLNEED : MADV_SEQUENTIAL);
#endif
        }
        // mmap refusal (e.g. an exotic fs) falls through to pread.
      }
      if (n_readers > static_cast<int>(L->slots.size()) / 2)
        n_readers = static_cast<int>(L->slots.size()) / 2;
      if (L->mmap_mode && n_readers < 1) n_readers = 1;
      if (n_readers > 1 || L->mmap_mode) {
        for (int i = 0; i < n_readers; i++)
          L->readers_mt.emplace_back(&Loader::reader_main_mt, L);
        return 0;
      }
    }
  }
  L->reader = std::thread(&Loader::reader_main, L);
  return 0;
}

// Back-compat entry point: mmap in auto mode.
int rpf_loader_start_fd(Loader* L, int fd, int loop, double pace_bytes_per_s,
                        int n_readers) {
  return rpf_loader_start_fd2(L, fd, loop, pace_bytes_per_s, n_readers, -1);
}

// Acquire the next filled buffer. Returns the slot index (>= 0), -1 on
// timeout, or -2 on end-of-stream with nothing left to deliver.
int rpf_loader_acquire(Loader* L, uint8_t** data, size_t* len, int timeout_ms) {
  if (!L) return -1;
  std::unique_lock<std::mutex> lk(L->mu);
  auto pred = [&] { return !L->filled_q.empty() || L->eof || L->stop_flag.load(); };
  if (timeout_ms < 0) {
    L->cv.wait(lk, pred);
  } else if (!L->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), pred)) {
    return -1;
  }
  if (L->filled_q.empty()) return L->eof ? -2 : -1;
  int idx = L->filled_q.front();
  L->filled_q.pop_front();
  Slot& s = L->slots[static_cast<size_t>(idx)];
  if (data) *data = s.ext ? const_cast<uint8_t*>(s.ext) : s.data.data();
  if (len) *len = s.filled;
  return idx;
}

void rpf_loader_release(Loader* L, int slot) {
  if (!L || slot < 0 || static_cast<size_t>(slot) >= L->slots.size()) return;
  std::lock_guard<std::mutex> lk(L->mu);
  L->free_q.push_back(slot);
  L->cv.notify_all();
}

void rpf_loader_histogram(Loader* L, long* out, int n) {
  if (!L || !out) return;
  std::lock_guard<std::mutex> lk(L->mu);
  for (int i = 0; i < n && static_cast<size_t>(i) < L->histogram.size(); i++)
    out[i] = L->histogram[static_cast<size_t>(i)];
}

long rpf_loader_bytes_read(Loader* L) {
  if (!L) return 0;
  std::lock_guard<std::mutex> lk(L->mu);
  return L->bytes_read;
}

int rpf_loader_at_eof(Loader* L) {
  if (!L) return 1;
  std::lock_guard<std::mutex> lk(L->mu);
  return (L->eof && L->filled_q.empty()) ? 1 : 0;
}

void rpf_loader_stop(Loader* L) {
  if (L) L->join();
}

void rpf_loader_destroy(Loader* L) {
  delete L;
}
}  // extern "C"
