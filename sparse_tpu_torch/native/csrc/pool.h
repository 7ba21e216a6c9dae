// Persistent worker-thread pool for the host kernels (the port's copy of
// sparse_tpu's pool.h, in namespace sttpool).
//
// Every native kernel used to spawn fresh std::threads per call
// (~100 us per spawn) — for sub-millisecond kernels (CSR SpMV at a few
// hundred k nnz, fused merges, counting scatters) the spawn cost was a
// large, *variable* fraction of the call and the dominant residual vs
// scipy on small boxes.  This pool keeps hw-1 detached
// workers parked on a generation counter: dispatch is an atomic bump +
// condvar notify (workers spin briefly before sleeping), completion is a
// caller spin on an atomic counter — both microseconds.
//
// Concurrency contract: run() serializes concurrent callers (they would
// oversubscribe the cores anyway); fn(i) is called for i in [0, t) with
// the caller executing i == 0.  Fork-safe via pthread_atfork (the child
// reinitializes primitives and respawns workers lazily).  The singleton
// is leaked so workers never race static destruction at exit.

#pragma once

#include <pthread.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <functional>
#include <mutex>
#include <new>
#include <thread>

namespace sttpool {

inline void cpu_pause() {
#if defined(__x86_64__) || defined(__i386__)
  __builtin_ia32_pause();
#else
  std::this_thread::yield();
#endif
}

class ThreadPool {
 public:
  static int max_threads() {
    unsigned hw = std::thread::hardware_concurrency();
    return hw ? (int)hw : 1;
  }

  static ThreadPool& get() {
    static ThreadPool* p = [] {
      auto* q = new ThreadPool();
      pthread_atfork(nullptr, nullptr, [] { ThreadPool::get().reset_after_fork(); });
      return q;
    }();
    return *p;
  }

  // Run fn(i) for i in [0, t); blocks until all t calls return.  t above
  // the core count oversubscribes (slow) but still executes EVERY slot —
  // silently clamping would drop work and corrupt results.
  //
  // The dispatch word packs (generation << 16) | slot_count into ONE
  // atomic: a worker's decision to execute is made from the same atomic
  // read that observes the generation, so a straggler parked between
  // "which generation is this" and "am I in it" can never pair a stale
  // generation with the next dispatch's slot count (that tear let a
  // worker run a dispatch twice and release run() early — corrupting
  // results or reading freed caller buffers).
  void run(int t, const std::function<void(int)>& fn) {
    if (t <= 1) {
      fn(0);
      return;
    }
    if ((uint64_t)(t - 1) > ((1u << kSlotBits) - 1)) {
      // beyond the packed slot field: execute every slot serially rather
      // than clamp (dropping slots would corrupt results)
      for (int i = 0; i < t; ++i) fn(i);
      return;
    }
    std::lock_guard<std::mutex> outer(run_mutex_);
    ensure(t - 1);
    fn_ = &fn;
    const uint64_t nslots = (uint64_t)(t - 1);
    done_.store(0, std::memory_order_release);
    {
      // publish under the mutex so a worker checking the predicate inside
      // cv_.wait cannot miss the notify
      std::lock_guard<std::mutex> lk(m_);
      uint64_t g = (word_.load(std::memory_order_relaxed) >> kSlotBits) + 1;
      word_.store((g << kSlotBits) | nslots, std::memory_order_release);
    }
    cv_.notify_all();
    fn(0);
    // Every worker with idx <= nslots increments done_ exactly once, and
    // none can still be pre-increment when we return (we wait for all of
    // them here) — so the next dispatch's done_=0 store cannot race a
    // straggler's increment.
    int spins = 0;
    while (done_.load(std::memory_order_acquire) != (int)nslots) {
      if (++spins < (1 << 14))
        cpu_pause();
      else
        std::this_thread::yield();
    }
  }

  void reset_after_fork() {
    // pool threads do not exist in the child; reinitialize primitives and
    // let ensure() respawn lazily.  (Leaks the parent's bookkeeping, which
    // is the only safe option post-fork.)
    new (&m_) std::mutex();
    new (&run_mutex_) std::mutex();
    new (&cv_) std::condition_variable();
    n_workers_ = 0;
    done_.store(0, std::memory_order_release);
  }

 private:
  ThreadPool() = default;

  static constexpr int kSlotBits = 16;  // <= 65535 slots per dispatch

  void ensure(int k) {
    // capture the CURRENT dispatch word before spawning: a worker must
    // start with seen == pre-dispatch word or it would skip its first task
    uint64_t cur = word_.load(std::memory_order_acquire);
    while (n_workers_ < k) {
      int idx = ++n_workers_;
      std::thread([this, idx, cur] { loop(idx, cur); }).detach();
    }
  }

  void loop(int idx, uint64_t seen) {
    for (;;) {
      int spins = 0;
      uint64_t w;
      while ((w = word_.load(std::memory_order_acquire)) == seen) {
        if (++spins > 20000) {
          std::unique_lock<std::mutex> lk(m_);
          cv_.wait(lk, [&] {
            return word_.load(std::memory_order_acquire) != seen;
          });
          w = word_.load(std::memory_order_acquire);
          break;
        }
        cpu_pause();
      }
      seen = w;
      // generation and slot count come from the SAME atomic read — no
      // stale-generation / fresh-count pairing is possible.
      if ((uint64_t)idx <= (w & ((1u << kSlotBits) - 1))) {
        (*fn_)(idx);
        done_.fetch_add(1, std::memory_order_acq_rel);
      }
    }
  }

  std::mutex run_mutex_;  // serializes concurrent run() callers
  std::mutex m_;
  std::condition_variable cv_;
  // (generation << kSlotBits) | slot_count — see run()
  std::atomic<uint64_t> word_{0};
  std::atomic<int> done_{0};
  const std::function<void(int)>* fn_ = nullptr;
  int n_workers_ = 0;
};

// Convenience: run body(i) across t slots (caller participates).
template <typename F>
inline void parallel_for_slots(int t, F&& body) {
  if (t <= 1) {
    body(0);
    return;
  }
  const std::function<void(int)> fn = std::forward<F>(body);
  ThreadPool::get().run(t, fn);
}

}  // namespace sttpool
