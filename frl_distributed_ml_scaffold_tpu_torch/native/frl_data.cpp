// Native data-loader core (SURVEY C16; §7 hard part 5 "input pipeline
// throughput").
//
// The reference's loader tier does its heavy lifting in native code (the
// torch DataLoader worker pool: C++ decode/collate under a Python
// orchestrator). This is the TPU-side equivalent: the per-sample hot ops —
// shard gather, train-time augmentation (random crop + flip + normalize),
// synthetic batch synthesis — as a multithreaded C++ library. Python
// orchestrates (data/native.py via ctypes), C++ moves the bytes.
//
// Threading model: a fixed worker pool sized to the hardware, work split by
// sample — batches are embarrassingly parallel and each sample's work is
// tens of µs, so per-batch thread spawn would dominate; the pool is spawned
// once at first use and parks on a condition variable between calls.
//
// Build: g++ -O3 -march=native -shared -fPIC (driven by data/native.py,
// cached next to this file).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// ----------------------------------------------------------- worker pool

// Each parallel_for publishes a heap-owned Task (function copied in, not
// pointed at) that workers pin via shared_ptr. Per-task atomic counters
// mean a straggler from a finished call can at worst fetch an exhausted
// index from the OLD task and immediately park — it can never steal work
// from, or run the function of, a later call (the back-to-back
// gather-then-augment pattern in imagenet.batch()).
struct Task {
  std::function<void(int64_t)> fn;
  int64_t total = 0;
  std::atomic<int64_t> next{0}, done{0};
};

class Pool {
 public:
  static Pool& instance() {
    static Pool pool;
    return pool;
  }

  // Run fn(i) for i in [0, n) across the pool; blocks until done.
  void parallel_for(int64_t n, std::function<void(int64_t)> fn) {
    if (n <= 0) return;
    if (n == 1) {
      fn(0);
      return;
    }
    auto task = std::make_shared<Task>();
    task->fn = std::move(fn);
    task->total = n;
    {
      std::lock_guard<std::mutex> lk(m_);
      current_ = task;
      epoch_++;
    }
    cv_.notify_all();
    run(*task);  // the caller participates too — no idle producer
    std::unique_lock<std::mutex> lk(m_);
    finished_cv_.wait(lk, [&] { return task->done.load() >= task->total; });
    // Another caller (prefetch worker vs. eval path) may have published its
    // own task meanwhile — only clear the slot if it is still ours, or its
    // batch would silently run single-threaded.
    if (current_ == task) current_.reset();
  }

 private:
  Pool() {
    int n = static_cast<int>(std::thread::hardware_concurrency());
    n_threads_ = n > 2 ? n - 1 : 1;  // leave a core for the dispatcher
    for (int t = 0; t < n_threads_; ++t) {
      threads_.emplace_back([this] { worker_loop(); });
    }
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(m_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }

  void worker_loop() {
    uint64_t seen = 0;
    for (;;) {
      std::shared_ptr<Task> task;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait(lk, [&] { return stop_ || epoch_ != seen; });
        if (stop_) return;
        seen = epoch_;
        task = current_;  // pin: stays alive even after the call returns
      }
      if (task) run(*task);
    }
  }

  void run(Task& task) {
    for (;;) {
      int64_t i = task.next.fetch_add(1, std::memory_order_relaxed);
      if (i >= task.total) break;
      task.fn(i);
      if (task.done.fetch_add(1, std::memory_order_acq_rel) + 1 >=
          task.total) {
        // Lock around the notify: the dispatcher re-checks its predicate
        // under m_, so holding m_ here means it is either already blocked
        // (and receives this notify) or will observe done==total on its
        // first predicate check — no lost-wakeup window.
        std::lock_guard<std::mutex> lk(m_);
        finished_cv_.notify_all();
      }
    }
  }

  std::vector<std::thread> threads_;
  int n_threads_;
  std::mutex m_;
  std::condition_variable cv_, finished_cv_;
  std::shared_ptr<Task> current_;
  uint64_t epoch_ = 0;
  bool stop_ = false;
};

// ------------------------------------------------------------------ rng

// splitmix64: tiny, high-quality, seedable per (seed, stream) — matches the
// Python side's contract that batches are pure functions of (seed, step).
inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

inline float uniform01(uint64_t& s) {
  return (splitmix64(s) >> 40) * (1.0f / 16777216.0f);  // 24-bit mantissa
}

}  // namespace

extern "C" {

// Threaded row gather: dst[i] = src[idx[i]] (row = row_elems floats).
// The mmap'd-shard read path — page faults happen here, in parallel.
void frl_gather_rows(const float* src, const int64_t* idx, float* dst,
                     int64_t n, int64_t row_elems) {
  Pool::instance().parallel_for(n, [&](int64_t i) {
    std::memcpy(dst + i * row_elems, src + idx[i] * row_elems,
                sizeof(float) * row_elems);
  });
}

// uint8 variant with on-the-fly f32 conversion and 1/255 scaling — uint8
// is the natural 4x-smaller storage for pre-decoded image shards.
void frl_gather_rows_u8(const uint8_t* src, const int64_t* idx, float* dst,
                        int64_t n, int64_t row_elems) {
  Pool::instance().parallel_for(n, [&](int64_t i) {
    const uint8_t* s = src + idx[i] * row_elems;
    float* d = dst + i * row_elems;
    for (int64_t e = 0; e < row_elems; ++e) {
      d[e] = s[e] * (1.0f / 255.0f);
    }
  });
}

// Windowed gather from a flat token stream (the LM corpus path): each
// output row is window tokens starting at starts[i], widened to int32.
// Arbitrary (unaligned) starts — this is the piece plain row-gather can't
// express; the per-window copy is where the token-bin mmap page faults
// happen, across the pool.
void frl_gather_windows_u16(const uint16_t* src, const int64_t* starts,
                            int32_t* dst, int64_t n, int64_t window) {
  Pool::instance().parallel_for(n, [&](int64_t i) {
    const uint16_t* s = src + starts[i];
    int32_t* d = dst + i * window;
    for (int64_t e = 0; e < window; ++e) d[e] = (int32_t)s[e];
  });
}

void frl_gather_windows_u32(const uint32_t* src, const int64_t* starts,
                            int32_t* dst, int64_t n, int64_t window) {
  Pool::instance().parallel_for(n, [&](int64_t i) {
    const uint32_t* s = src + starts[i];
    int32_t* d = dst + i * window;
    for (int64_t e = 0; e < window; ++e) d[e] = (int32_t)s[e];
  });
}

// Train-time augmentation on NHWC float32: per-sample random crop from
// (h, w) to (crop, crop) + horizontal flip (p=0.5) + per-channel
// normalize. Eval: center crop, no flip. One pass over the bytes.
void frl_augment_batch(const float* in, float* out, int64_t n, int64_t h,
                       int64_t w, int64_t c, int64_t crop, uint64_t seed,
                       int train, const float* mean, const float* stddev) {
  Pool::instance().parallel_for(n, [&](int64_t i) {
    uint64_t s = seed ^ (0x243f6a8885a308d3ULL * (uint64_t)(i + 1));
    int64_t max_y = h - crop, max_x = w - crop;
    int64_t y0, x0;
    bool flip;
    if (train) {
      y0 = max_y > 0 ? (int64_t)(uniform01(s) * (max_y + 1)) : 0;
      x0 = max_x > 0 ? (int64_t)(uniform01(s) * (max_x + 1)) : 0;
      if (y0 > max_y) y0 = max_y;
      if (x0 > max_x) x0 = max_x;
      flip = uniform01(s) < 0.5f;
    } else {
      y0 = max_y / 2;
      x0 = max_x / 2;
      flip = false;
    }
    const float* src = in + i * h * w * c;
    float* dst = out + i * crop * crop * c;
    for (int64_t y = 0; y < crop; ++y) {
      const float* row = src + ((y0 + y) * w + x0) * c;
      float* orow = dst + y * crop * c;
      for (int64_t x = 0; x < crop; ++x) {
        int64_t sx = flip ? (crop - 1 - x) : x;
        const float* px = row + sx * c;
        float* opx = orow + x * c;
        for (int64_t ch = 0; ch < c; ++ch) {
          opx[ch] = (px[ch] - mean[ch]) / stddev[ch];
        }
      }
    }
  });
}

int frl_version() { return 3; }

}  // extern "C"
