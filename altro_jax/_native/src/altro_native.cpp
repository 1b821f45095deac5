// Native host-side runtime for altro_jax.
//
// The reference's runtime infrastructure is C++: a spinning thread pool over
// a two-lock work queue (altro/common/threadpool.hpp:45,
// threadsafe_queue.hpp:19) and a hierarchical RAII wall-clock profiler
// (altro/common/timer.hpp:41, timer.cpp:10-134).  Here the *compute*
// parallelism moved into XLA, but the host side still wants native speed for
// (a) low-overhead hierarchical timing around dispatch loops (the Python
// profiler costs ~µs per scope; this one ~40ns) and (b) generating large
// randomized scenario batches (initial states, obstacle layouts) that feed
// the device without holding the GIL — the framework's "data loader".
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
//
// Build: altro_jax/_native/build.py  (g++ -O3 -shared -fPIC -pthread)

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <map>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- profiler

using Clock = std::chrono::steady_clock;

struct ProfEntry {
  double total_us = 0.0;
  std::int64_t count = 0;
};

struct Profiler {
  bool active = false;
  std::vector<std::string> stack;
  std::vector<Clock::time_point> starts;
  std::map<std::string, ProfEntry> entries;
  std::mutex mu;

  std::string key() const {
    std::string k;
    for (std::size_t i = 0; i < stack.size(); ++i) {
      if (i) k += '/';
      k += stack[i];
    }
    return k;
  }
};

// --------------------------------------------------------------- threadpool

// Minimal blocking-queue thread pool: the native analog of the reference's
// ThreadPool (altro/common/threadpool.cpp:12-80), used here to fan scenario
// generation across cores.
class ThreadPool {
 public:
  explicit ThreadPool(int nthreads) {
    if (nthreads <= 0) nthreads = (int)std::thread::hardware_concurrency();
    for (int i = 0; i < nthreads; ++i) {
      workers_.emplace_back([this] { Worker(); });
    }
  }
  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }
  void Add(std::function<void()> task) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      tasks_.push(std::move(task));
      ++pending_;
    }
    cv_.notify_one();
  }
  void Wait() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return pending_ == 0; });
  }
  int NumThreads() const { return (int)workers_.size(); }

 private:
  void Worker() {
    for (;;) {
      std::function<void()> task;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !tasks_.empty(); });
        if (stop_ && tasks_.empty()) return;
        task = std::move(tasks_.front());
        tasks_.pop();
      }
      task();
      {
        std::lock_guard<std::mutex> lk(mu_);
        if (--pending_ == 0) done_cv_.notify_all();
      }
    }
  }
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> tasks_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable done_cv_;
  int pending_ = 0;
  bool stop_ = false;
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------- profiler

void* altro_profiler_new() { return new Profiler(); }

void altro_profiler_free(void* p) { delete static_cast<Profiler*>(p); }

void altro_profiler_set_active(void* p, int active) {
  static_cast<Profiler*>(p)->active = active != 0;
}

void altro_profiler_start(void* p, const char* name) {
  auto* prof = static_cast<Profiler*>(p);
  if (!prof->active) return;
  prof->stack.emplace_back(name);
  prof->starts.push_back(Clock::now());
}

void altro_profiler_stop(void* p) {
  auto* prof = static_cast<Profiler*>(p);
  if (!prof->active || prof->stack.empty()) return;
  auto t1 = Clock::now();
  double us =
      std::chrono::duration<double, std::micro>(t1 - prof->starts.back())
          .count();
  std::string key = prof->key();
  auto& e = prof->entries[key];
  e.total_us += us;
  e.count += 1;
  prof->stack.pop_back();
  prof->starts.pop_back();
}

void altro_profiler_reset(void* p) {
  auto* prof = static_cast<Profiler*>(p);
  prof->entries.clear();
  prof->stack.clear();
  prof->starts.clear();
}

// Serialize entries as "key\ttotal_us\tcount\n" lines into buf (utf-8).
// Returns the number of bytes that would be written (call twice to size).
std::int64_t altro_profiler_dump(void* p, char* buf, std::int64_t cap) {
  auto* prof = static_cast<Profiler*>(p);
  std::string out;
  for (const auto& kv : prof->entries) {
    out += kv.first;
    out += '\t';
    out += std::to_string(kv.second.total_us);
    out += '\t';
    out += std::to_string(kv.second.count);
    out += '\n';
  }
  if (buf != nullptr && cap > 0) {
    std::int64_t ncopy =
        std::min<std::int64_t>(cap - 1, (std::int64_t)out.size());
    std::memcpy(buf, out.data(), (size_t)ncopy);
    buf[ncopy] = '\0';
  }
  return (std::int64_t)out.size();
}

// --------------------------------------------------------------- threadpool

void* altro_pool_new(int nthreads) { return new ThreadPool(nthreads); }
void altro_pool_free(void* p) { delete static_cast<ThreadPool*>(p); }
int altro_pool_nthreads(void* p) {
  return static_cast<ThreadPool*>(p)->NumThreads();
}

// ------------------------------------------------------- scenario generator

// Fill `out` [batch, dim] (row-major float32) with uniform samples in
// [lo[d], hi[d]] per dimension, deterministically from `seed`, fanned over
// the pool.  This is the batch analog of KnotPoint::Random (knotpoint.hpp:96)
// turned into a production scenario generator.
void altro_generate_uniform(void* pool_ptr, float* out, std::int64_t batch,
                            std::int64_t dim, const float* lo, const float* hi,
                            std::uint64_t seed) {
  auto* pool = static_cast<ThreadPool*>(pool_ptr);
  int nt = pool ? pool->NumThreads() : 1;
  std::int64_t chunk = (batch + nt - 1) / nt;
  auto work = [=](std::int64_t start, std::int64_t stop, std::uint64_t s) {
    std::mt19937_64 rng(s);
    for (std::int64_t b = start; b < stop; ++b) {
      for (std::int64_t d = 0; d < dim; ++d) {
        double u = (double)(rng() >> 11) * (1.0 / 9007199254740992.0);
        out[b * dim + d] = (float)(lo[d] + u * (hi[d] - lo[d]));
      }
    }
  };
  if (pool == nullptr || nt <= 1) {
    work(0, batch, seed);
    return;
  }
  for (int i = 0; i < nt; ++i) {
    std::int64_t start = i * chunk;
    std::int64_t stop = std::min<std::int64_t>(batch, start + chunk);
    if (start >= stop) break;
    pool->Add([=] { work(start, stop, seed + 0x9e3779b97f4a7c15ULL * (i + 1)); });
  }
  pool->Wait();
}

}  // extern "C"
