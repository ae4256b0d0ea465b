// Round 23: multi-lane hashing + the drain-scoped digest table.
//
// HashPool: a small persistent worker pool that fans independent
// SHA-256 jobs (frame verifies, body digests, reply finalizes) across
// TB_HASH_THREADS lanes *inside* one Python→C crossing — ctypes has
// already released the GIL, so lanes are real parallelism even while
// the drain thread owns the Python side.  0 lanes (the default,
// right for a 1-core host) runs every job inline on the calling thread;
// batches from concurrent callers (two in-process servers) serialize
// on a submit mutex while jobs within a batch run in parallel.
//
// DigestTable: a (ptr,len)→digest cache scoped to ONE drain crossing:
// tb_fp_verify_frames populates it with every verified frame's body
// digest and bumps the epoch (invalidating the previous crossing's
// entries — arena memory is reused across drains, so a stale pointer
// key must never survive into the next drain).  Consumers
// (tb_pl_build_prepares under TB_HASH_REUSE=1) treat it as a
// secondary tier: the primary digest-reuse tier is the verified
// header itself, whose checksum_body field IS the body digest the
// verify pass just proved.
#pragma once
#include "sha256.h"

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace tb {

constexpr int HASH_THREADS_MAX = 16;  // envcheck names this bound

inline std::atomic<int>& hash_threads_cfg() {
    static std::atomic<int> cfg{0};  // 0 = inline (no lanes)
    return cfg;
}

inline std::atomic<uint64_t>& hash_lane_jobs() {
    static std::atomic<uint64_t> jobs{0};  // jobs run ON POOL LANES
    return jobs;
}

inline std::atomic<uint64_t>& hash_table_hits() {
    static std::atomic<uint64_t> hits{0};  // digest-table lookups served
    return hits;
}

struct HashPool {
    std::mutex submit_mu;  // one batch in flight at a time
    std::mutex mu;
    std::condition_variable cv;
    std::condition_variable done_cv;
    std::vector<std::thread> workers;
    bool stop = false;
    uint64_t epoch = 0;
    uint32_t idle = 0;  // workers parked on cv (all, between batches)
    // Current batch: workers and the caller pull indices from `next`.
    const std::function<void(uint32_t)>* fn = nullptr;
    uint32_t total = 0;
    std::atomic<uint32_t> next{0};
    std::atomic<uint32_t> inflight{0};  // lanes still inside run_jobs

    ~HashPool() { shutdown(); }

    void shutdown() {
        {
            std::unique_lock<std::mutex> lk(mu);
            stop = true;
        }
        cv.notify_all();
        for (std::thread& t : workers)
            if (t.joinable()) t.join();
        workers.clear();
        std::unique_lock<std::mutex> lk(mu);
        stop = false;
        idle = 0;
    }

    void worker_loop() {
        uint64_t seen = 0;
        for (;;) {
            {
                std::unique_lock<std::mutex> lk(mu);
                idle++;
                // resize_locked waits for every lane to park before a
                // batch can be posted; done_cv doubles as that signal.
                done_cv.notify_all();
                // `fn != nullptr` guards two races: a fresh lane
                // spawning with seen=0 against a pool whose epoch
                // already advanced (it must park, not chase a dead
                // batch), and a lane waking AFTER the submitter
                // observed completion and cleared the batch under mu.
                cv.wait(lk, [&] {
                    return stop || (epoch != seen && fn != nullptr);
                });
                idle--;
                if (stop) return;
                seen = epoch;
                // Registered under mu: the submitter's completion
                // wait holds mu too, so it can never observe
                // inflight==0 and retire the batch between this
                // lane's wake-up and its first job claim (the
                // lost-lane race a plain post-unlock increment had).
                inflight.fetch_add(1, std::memory_order_acq_rel);
            }
            run_jobs(true);
            if (inflight.fetch_sub(1, std::memory_order_acq_rel) == 1) {
                std::unique_lock<std::mutex> lk(mu);
                done_cv.notify_all();
            }
        }
    }

    void run_jobs(bool on_lane) {
        for (;;) {
            uint32_t i = next.fetch_add(1, std::memory_order_relaxed);
            if (i >= total) return;
            (*fn)(i);
            if (on_lane)
                hash_lane_jobs().fetch_add(1, std::memory_order_relaxed);
        }
    }

    // Respawn to the configured lane count (rare: env/bench-driven).
    // Runs WITH submit_mu held — workers never touch submit_mu, so
    // joining them here cannot deadlock, and releasing submit_mu
    // mid-resize is exactly what must never happen: two submitters
    // resizing concurrently would both run shutdown() and join the
    // same std::thread objects (a fuzz run found that hang).
    void resize_locked(int lanes) {
        if (int(workers.size()) == lanes) return;
        shutdown();
        for (int i = 0; i < lanes; i++)
            workers.emplace_back([this] { worker_loop(); });
        // Wait until every lane is parked: a batch posted before a
        // lane reaches the cv would otherwise be missed by it (the
        // caller still completes the batch inline, but lanes_busy
        // would under-report the very first crossing).  Bounded: a
        // lane between unpark and re-park re-checks the predicate.
        std::unique_lock<std::mutex> lk(mu);
        done_cv.wait_for(lk, std::chrono::milliseconds(100), [&] {
            return idle == workers.size();
        });
    }

    // Run fn(i) for i in [0, n): on the caller plus every lane.  The
    // caller always participates, so TB_HASH_THREADS=N gives N+1-way
    // parallelism and N=0 degrades to the plain inline loop.
    void run(uint32_t n, const std::function<void(uint32_t)>& f) {
        int lanes = hash_threads_cfg().load(std::memory_order_relaxed);
        if (lanes <= 0 || n < 2) {
            for (uint32_t i = 0; i < n; i++) f(i);
            return;
        }
        std::lock_guard<std::mutex> batch(submit_mu);
        resize_locked(lanes);
        {
            std::unique_lock<std::mutex> lk(mu);
            fn = &f;
            total = n;
            next.store(0, std::memory_order_relaxed);
            epoch++;
        }
        cv.notify_all();
        run_jobs(false);
        std::unique_lock<std::mutex> lk(mu);
        done_cv.wait(lk, [&] {
            return inflight.load(std::memory_order_acquire) == 0;
        });
        fn = nullptr;
        total = 0;
    }
};

inline HashPool& hash_pool() {
    static HashPool pool;
    return pool;
}

template <class F>
inline void hash_parallel_for(uint32_t n, F&& f) {
    std::function<void(uint32_t)> fn(std::forward<F>(f));
    hash_pool().run(n, fn);
}

// ---------------------------------------------------------------------
// Drain-scoped digest table.

struct DigestTable {
    struct Entry {
        const void* ptr = nullptr;
        uint64_t len = 0;
        uint64_t d0 = 0, d1 = 0;
        uint64_t epoch = 0;
    };
    static constexpr size_t SLOTS = 4096;  // one drain's frames fit
    std::vector<Entry> slots{SLOTS};
    std::mutex mu;
    std::atomic<uint64_t> epoch{1};

    static size_t slot_of(const void* p, uint64_t n) {
        uint64_t h = (uint64_t(reinterpret_cast<uintptr_t>(p)) >> 4) *
                         0x9E3779B97F4A7C15ULL ^
                     n;
        return size_t(h % SLOTS);
    }

    // New crossing: every previous entry dies (arena reuse would
    // otherwise alias a stale digest onto fresh bytes at the same
    // address).  O(1): entries carry the epoch they were written in.
    void invalidate() { epoch.fetch_add(1, std::memory_order_acq_rel); }

    void put(const void* p, uint64_t n, uint64_t d0, uint64_t d1) {
        uint64_t e = epoch.load(std::memory_order_acquire);
        std::lock_guard<std::mutex> lk(mu);
        Entry& s = slots[slot_of(p, n)];
        s.ptr = p;
        s.len = n;
        s.d0 = d0;
        s.d1 = d1;
        s.epoch = e;
    }

    bool get(const void* p, uint64_t n, uint64_t out[2]) {
        uint64_t e = epoch.load(std::memory_order_acquire);
        std::lock_guard<std::mutex> lk(mu);
        const Entry& s = slots[slot_of(p, n)];
        if (s.epoch != e || s.ptr != p || s.len != n) return false;
        out[0] = s.d0;
        out[1] = s.d1;
        hash_table_hits().fetch_add(1, std::memory_order_relaxed);
        return true;
    }
};

inline DigestTable& digest_table() {
    static DigestTable table;
    return table;
}

}  // namespace tb
