// Native batch loader: memory-mapped fixed-record gather with a thread
// pool + async prefetch.
//
// Role in the framework: the fine-tune input pipeline's hot path.  The
// reference reads image batches through h5py fancy indexing on one
// thread (utils/batch_gen.py:286-288); at 150k uint8 224x224x3 records
// a 32-image gather is ~4.8 MB of scattered reads that Python+h5py
// serialize.  This library mmaps the packed record file once and
// gathers rows with N worker threads while madvise(WILLNEED) warms the
// next batch, so the device never waits on host IO.  The PyTorch port's
// copy of native/batchloader.cpp, built by its data/native_loader.py.
//
// No external dependencies: POSIX mmap + pthreads via std::thread.
// Exposed as a C ABI for ctypes (see
// vae_captioning_torch/data/native_loader.py).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Loader {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t file_size = 0;
  size_t record_size = 0;
  int64_t num_records = 0;

  // simple dedicated thread pool
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  bool shutdown = false;

  // current job
  const int64_t* job_indices = nullptr;
  int64_t job_count = 0;
  uint8_t* job_out = nullptr;
  std::atomic<int64_t> next_item{0};
  std::atomic<int64_t> done_items{0};
  std::atomic<int> in_flight{0};   // workers inside the claim loop
  int64_t job_generation = 0;

  void worker_loop() {
    int64_t seen_generation = 0;
    for (;;) {
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_work.wait(lock, [&] {
          return shutdown || job_generation > seen_generation;
        });
        if (shutdown) return;
        seen_generation = job_generation;
        // entering the claim loop is announced under the lock, so
        // bl_gather's quiescence wait (in_flight == 0 under the same
        // lock) cannot miss a late-starting worker of a previous job
        in_flight.fetch_add(1);
      }
      for (;;) {
        int64_t i = next_item.fetch_add(1);
        if (i >= job_count) break;
        const int64_t row = job_indices[i];
        std::memcpy(job_out + size_t(i) * record_size,
                    base + size_t(row) * record_size, record_size);
        done_items.fetch_add(1);
      }
      {
        std::lock_guard<std::mutex> lock(mu);
        in_flight.fetch_sub(1);
        cv_done.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

// Open a packed record file.  Returns an opaque handle or null.
void* bl_open(const char* path, int64_t num_records, int64_t record_size,
              int num_threads) {
  auto* l = new Loader();
  l->fd = open(path, O_RDONLY);
  if (l->fd < 0) {
    delete l;
    return nullptr;
  }
  struct stat st;
  if (fstat(l->fd, &st) != 0 ||
      st.st_size < int64_t(num_records) * record_size) {
    close(l->fd);
    delete l;
    return nullptr;
  }
  l->file_size = size_t(st.st_size);
  l->base = static_cast<const uint8_t*>(
      mmap(nullptr, l->file_size, PROT_READ, MAP_SHARED, l->fd, 0));
  if (l->base == MAP_FAILED) {
    close(l->fd);
    delete l;
    return nullptr;
  }
  madvise(const_cast<uint8_t*>(l->base), l->file_size, MADV_RANDOM);
  l->record_size = size_t(record_size);
  l->num_records = num_records;
  if (num_threads < 1) num_threads = 1;
  for (int i = 0; i < num_threads; ++i) {
    l->workers.emplace_back([l] { l->worker_loop(); });
  }
  return l;
}

// Gather rows[0..n) into out (n * record_size bytes). Blocks until done.
int bl_gather(void* handle, const int64_t* rows, int64_t n, uint8_t* out) {
  auto* l = static_cast<Loader*>(handle);
  if (!l || !l->base) return -1;
  for (int64_t i = 0; i < n; ++i) {
    if (rows[i] < 0 || rows[i] >= l->num_records) return -2;
  }
  {
    std::unique_lock<std::mutex> lock(l->mu);
    // quiesce: no worker may still be inside a previous job's claim
    // loop when the job fields and counters are rewritten, or it could
    // steal item 0 of the new job / lose a done_items increment
    l->cv_done.wait(lock, [&] { return l->in_flight.load() == 0; });
    l->job_indices = rows;
    l->job_count = n;
    l->job_out = out;
    l->next_item.store(0);
    l->done_items.store(0);
    ++l->job_generation;
    l->cv_work.notify_all();
  }
  std::unique_lock<std::mutex> lock(l->mu);
  l->cv_done.wait(lock, [&] {
    return l->done_items.load() >= n && l->in_flight.load() == 0;
  });
  return 0;
}

// Hint the kernel to fault-in the pages for the given rows (next batch).
int bl_prefetch(void* handle, const int64_t* rows, int64_t n) {
  auto* l = static_cast<Loader*>(handle);
  if (!l || !l->base) return -1;
  const size_t page = size_t(sysconf(_SC_PAGESIZE));
  for (int64_t i = 0; i < n; ++i) {
    if (rows[i] < 0 || rows[i] >= l->num_records) continue;
    size_t begin = size_t(rows[i]) * l->record_size;
    size_t aligned = begin & ~(page - 1);
    size_t len = l->record_size + (begin - aligned);
    madvise(const_cast<uint8_t*>(l->base) + aligned, len, MADV_WILLNEED);
  }
  return 0;
}

int64_t bl_num_records(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  return l ? l->num_records : -1;
}

void bl_close(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  if (!l) return;
  {
    std::lock_guard<std::mutex> lock(l->mu);
    l->shutdown = true;
    l->cv_work.notify_all();
  }
  for (auto& t : l->workers) t.join();
  if (l->base && l->base != MAP_FAILED) {
    munmap(const_cast<uint8_t*>(l->base), l->file_size);
  }
  if (l->fd >= 0) close(l->fd);
  delete l;
}

}  // extern "C"
