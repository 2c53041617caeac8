// fastio: asynchronous double-buffered record writer for optimiser
// checkpoints and trajectory snapshots.
//
// Native-runtime counterpart of the reference's blocking rank-0 h5py
// writes (`Sphere_Grad_Descent.py:821-829`, Dedalus file handlers): the
// optimiser enqueues named binary records (numpy buffers) and a writer
// thread drains them to disk, so per-iteration checkpointing never
// stalls the device-side compute loop. Records carry a CRC32 so partial
// writes after a crash are detected on load.
//
// Durability/robustness contract:
//   * fwrite/fflush results are CHECKED; the first I/O failure (disk
//     full, EIO) latches a sticky error, after which fio_enqueue and
//     fio_flush return nonzero — the Python side must not report
//     durability that never happened.
//   * the queue is BOUNDED (kQueueCapBytes of payload); fio_enqueue
//     blocks until space frees rather than growing RSS without limit
//     when the producer outruns the disk. The wait also wakes on
//     shutdown/IO-error (returns -3/-2) so a parked producer can never
//     sleep through fio_close.
//   * fio_close must not race in-flight fio_enqueue/fio_flush calls
//     (same contract as fclose vs fwrite): producers must have returned
//     before close() frees the writer. The Python wrapper serialises
//     all calls on one thread, satisfying this by construction.
//
// Container format "SMO1":
//   [8B magic "SMO1\0\0\0\1"]
//   repeated records:
//     [u32 name_len][name bytes][u64 payload_len][u32 crc32][payload]
//
// C ABI (ctypes-friendly); see spheremanopt_torch/io/native_io.py.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// Backpressure cap on queued-but-unwritten payload bytes (1 GiB): large
// enough for bursts of trajectory snapshots, small enough that a stalled
// disk cannot OOM the optimisation process.
constexpr int64_t kQueueCapBytes = int64_t(1) << 30;

uint32_t crc32_table[256];
std::once_flag crc_once;

void init_crc() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc32_table[i] = c;
  }
}

uint32_t crc32(const uint8_t* data, size_t n) {
  std::call_once(crc_once, init_crc);
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = crc32_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Record {
  std::string name;
  std::vector<uint8_t> payload;
};

struct Writer {
  FILE* fp = nullptr;
  std::thread thread;
  std::deque<Record> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop{false};
  std::atomic<bool> io_error{false};  // sticky: first failed write latches
  std::atomic<int64_t> pending{0};
  std::atomic<int64_t> queued_bytes{0};
  std::atomic<int64_t> written_records{0};
  std::atomic<int64_t> written_bytes{0};

  bool write_all(const void* data, size_t n) {
    if (n == 0) return true;
    return fwrite(data, 1, n, fp) == n;
  }

  void run() {
    for (;;) {
      Record rec;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop.load() || !queue.empty(); });
        if (queue.empty()) {
          if (stop.load()) break;
          continue;
        }
        rec = std::move(queue.front());
        queue.pop_front();
      }
      uint32_t name_len = static_cast<uint32_t>(rec.name.size());
      uint64_t payload_len = rec.payload.size();
      uint32_t crc = crc32(rec.payload.data(), rec.payload.size());
      bool ok = !io_error.load();
      ok = ok && write_all(&name_len, sizeof(name_len));
      ok = ok && write_all(rec.name.data(), name_len);
      ok = ok && write_all(&payload_len, sizeof(payload_len));
      ok = ok && write_all(&crc, sizeof(crc));
      ok = ok && write_all(rec.payload.data(), payload_len);
      if (ok) {
        written_records.fetch_add(1);
        written_bytes.fetch_add(static_cast<int64_t>(payload_len));
      } else {
        // disk full / EIO: a partial record is on disk (the CRC'd reader
        // treats it as a torn tail); make the failure visible instead of
        // silently counting it as durable
        io_error.store(true);
      }
      {
        // Decrement under the mutex: a flush waiter that checked the
        // predicate just before an unlocked decrement could sleep
        // through the notify (lost wakeup) until the next enqueue.
        std::lock_guard<std::mutex> lk(mu);
        pending.fetch_sub(1);
        queued_bytes.fetch_sub(static_cast<int64_t>(payload_len));
      }
      cv.notify_all();
    }
    if (fflush(fp) != 0) io_error.store(true);
  }
};

}  // namespace

extern "C" {

void* fio_open(const char* path) {
  FILE* fp = fopen(path, "wb");
  if (!fp) return nullptr;
  static const uint8_t magic[8] = {'S', 'M', 'O', '1', 0, 0, 0, 1};
  if (fwrite(magic, 1, 8, fp) != 8) {
    fclose(fp);
    return nullptr;
  }
  auto* w = new Writer();
  w->fp = fp;
  w->thread = std::thread([w] { w->run(); });
  return w;
}

int fio_enqueue(void* handle, const char* name, const void* data,
                int64_t nbytes) {
  if (!handle || nbytes < 0) return -1;
  auto* w = static_cast<Writer*>(handle);
  if (w->io_error.load()) return -2;  // writer already failed
  Record rec;
  rec.name = name;
  rec.payload.assign(static_cast<const uint8_t*>(data),
                     static_cast<const uint8_t*>(data) + nbytes);
  {
    // bounded queue: block until the writer drains below the cap (or an
    // I/O error / shutdown makes waiting pointless) rather than growing
    // unbounded. `stop` must be part of the predicate: a producer parked
    // here while another thread calls fio_close would otherwise wake
    // AFTER the writer thread exits and push a record nobody drains (or
    // touch a Writer close() is about to delete).
    std::unique_lock<std::mutex> lk(w->mu);
    w->cv.wait(lk, [&] {
      return w->stop.load() || w->io_error.load() || w->queue.empty() ||
             w->queued_bytes.load() + nbytes <= kQueueCapBytes;
    });
    if (w->stop.load()) return -3;  // closing: record would never be written
    if (w->io_error.load()) return -2;
    w->queue.push_back(std::move(rec));
    w->pending.fetch_add(1);
    w->queued_bytes.fetch_add(nbytes);
  }
  w->cv.notify_all();
  return 0;
}

// Block until every enqueued record reached the OS (then fflush).
// Returns nonzero if any write failed — durability must not be reported
// for records the disk never took.
int fio_flush(void* handle) {
  if (!handle) return -1;
  auto* w = static_cast<Writer*>(handle);
  {
    std::unique_lock<std::mutex> lk(w->mu);
    w->cv.wait(lk, [&] { return w->pending.load() == 0; });
    if (fflush(w->fp) != 0) w->io_error.store(true);
  }
  return w->io_error.load() ? -2 : 0;
}

int64_t fio_stats_records(void* handle) {
  return handle ? static_cast<Writer*>(handle)->written_records.load() : -1;
}

int64_t fio_stats_bytes(void* handle) {
  return handle ? static_cast<Writer*>(handle)->written_bytes.load() : -1;
}

int fio_error(void* handle) {
  return handle ? (static_cast<Writer*>(handle)->io_error.load() ? 1 : 0) : -1;
}

int fio_close(void* handle) {
  if (!handle) return -1;
  auto* w = static_cast<Writer*>(handle);
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->stop.store(true);
  }
  w->cv.notify_all();
  w->thread.join();
  int rc = w->io_error.load() ? -2 : 0;
  if (fclose(w->fp) != 0) rc = -2;
  delete w;
  return rc;
}

uint32_t fio_crc32(const void* data, int64_t nbytes) {
  return crc32(static_cast<const uint8_t*>(data),
               static_cast<size_t>(nbytes));
}

}  // extern "C"
