// SPSC shared-memory ring operations for ray_tpu_torch.dag.channel.
//
// Native counterpart of the Python ShmRingChannel (same segment layout:
// 128-byte header with write_seq at offset 0 and read_seq at offset 64,
// then nslots * (8-byte slot header [u32 len | u8 kind | 3B pad] +
// slot_bytes payload)). The reference implements its channel/plasma hot
// paths in C++ for the same reasons this exists
// (src/ray/object_manager/plasma/*, experimental channels):
//   - real atomics with acquire/release ordering (the Python impl
//     documents an x86-TSO assumption; this is portable),
//   - FUTEX-backed blocking waits: consumers/producers sleep in the
//     kernel and are woken by the peer's store — no polling loop at
//     all, which beats sleep-poll at every core count (critically on
//     small hosts where a spinner starves the peer off the CPU),
//   - memcpy at C speed for the copy path.
//
// Exposed as a plain C ABI for ctypes — no pybind11 dependency. ctypes
// releases the GIL around calls, so blocked waiters don't stall their
// process's other Python threads.

#include <atomic>
#include <chrono>
#include <climits>
#include <cstdint>
#include <cstring>
#include <thread>

#if defined(__linux__)
#include <linux/futex.h>
#include <sys/syscall.h>
#include <sys/time.h>
#include <unistd.h>
#endif

namespace {

constexpr uint64_t HDR = 128;
constexpr uint64_t SLOT_HDR = 8;

inline std::atomic<uint64_t>* wseq(uint8_t* base) {
    return reinterpret_cast<std::atomic<uint64_t>*>(base);
}
inline std::atomic<uint64_t>* rseq(uint8_t* base) {
    return reinterpret_cast<std::atomic<uint64_t>*>(base + 64);
}

inline uint8_t* slot_ptr(uint8_t* base, uint64_t seq, uint64_t nslots,
                         uint64_t slot_bytes) {
    return base + HDR + (seq % nslots) * (SLOT_HDR + slot_bytes);
}

#if defined(__linux__)
// Wait until *word != seen (32-bit view of the peer's sequence counter;
// increments always change the low word except at the 2^32 wrap, which
// the re-check loop survives as a spurious wake).
inline void futex_wait_u32(void* word, uint32_t seen, double timeout_s) {
    timespec ts;
    timespec* tsp = nullptr;
    if (timeout_s >= 0) {
        ts.tv_sec = static_cast<time_t>(timeout_s);
        ts.tv_nsec = static_cast<long>((timeout_s - ts.tv_sec) * 1e9);
        tsp = &ts;
    }
    syscall(SYS_futex, word, FUTEX_WAIT, seen, tsp, nullptr, 0);
}

inline void futex_wake_all(void* word) {
    syscall(SYS_futex, word, FUTEX_WAKE, INT_MAX, nullptr, nullptr, 0);
}
#endif

// Wait for cond(); `watch` is the atomic whose change signals progress.
template <typename Cond>
bool wait_on(std::atomic<uint64_t>* watch, Cond cond, double timeout_s) {
    // Short PAUSE-spin first: the no-contention fast path never enters
    // the kernel.
    for (int i = 0; i < 128; i++) {
        if (cond()) return true;
#if defined(__x86_64__) || defined(__i386__)
        __builtin_ia32_pause();
#endif
    }
    using clock = std::chrono::steady_clock;
    auto deadline = clock::now();
    if (timeout_s >= 0)
        deadline += std::chrono::duration_cast<clock::duration>(
            std::chrono::duration<double>(timeout_s));
    for (;;) {
        if (cond()) return true;
        double remaining = -1.0;
        if (timeout_s >= 0) {
            auto left = std::chrono::duration<double>(
                deadline - clock::now()).count();
            if (left <= 0) return false;
            remaining = left;
        }
#if defined(__linux__)
        uint32_t seen = static_cast<uint32_t>(
            watch->load(std::memory_order_acquire));
        if (cond()) return true;
        // Cap each kernel wait: a NON-native peer (pure-Python fallback
        // in the other process) publishes without a futex wake, so we
        // must re-check periodically — 50ms of kernel sleep costs ~0 CPU.
        futex_wait_u32(watch, seen,
                       remaining < 0 ? 0.05
                                     : (remaining < 0.05 ? remaining
                                                         : 0.05));
#else
        std::this_thread::sleep_for(std::chrono::microseconds(50));
#endif
    }
}

inline void publish(std::atomic<uint64_t>* seq_word, uint64_t next) {
    seq_word->store(next, std::memory_order_release);
#if defined(__linux__)
    futex_wake_all(seq_word);
#endif
}

inline void futex_wake_hint(std::atomic<uint64_t>* seq_word) {
#if defined(__linux__)
    futex_wake_all(seq_word);
#else
    (void)seq_word;
#endif
}

}  // namespace

extern "C" {

// returns 0 ok, -1 timeout, -2 payload too large
int rb_write(uint8_t* base, uint64_t nslots, uint64_t slot_bytes,
             const uint8_t* payload, uint64_t n, uint8_t kind,
             double timeout_s) {
    if (n > slot_bytes) return -2;
    uint64_t seq = wseq(base)->load(std::memory_order_relaxed);
    if (!wait_on(
            rseq(base),
            [&] {
                return seq - rseq(base)->load(std::memory_order_acquire)
                    < nslots;
            },
            timeout_s))
        return -1;
    uint8_t* s = slot_ptr(base, seq, nslots, slot_bytes);
    uint32_t len = static_cast<uint32_t>(n);
    std::memcpy(s, &len, 4);
    s[4] = kind;
    if (n) std::memcpy(s + SLOT_HDR, payload, n);
    publish(wseq(base), seq + 1);
    return 0;
}

// returns payload length >= 0 on success (kind in *kind_out),
// -1 timeout, -3 output buffer too small (*n_needed holds the required
// size; the frame is NOT consumed).
int64_t rb_read(uint8_t* base, uint64_t nslots, uint64_t slot_bytes,
                uint8_t* out, uint64_t out_cap, uint8_t* kind_out,
                uint64_t* n_needed, double timeout_s) {
    uint64_t seq = rseq(base)->load(std::memory_order_relaxed);
    if (!wait_on(
            wseq(base),
            [&] {
                return wseq(base)->load(std::memory_order_acquire) > seq;
            },
            timeout_s))
        return -1;
    uint8_t* s = slot_ptr(base, seq, nslots, slot_bytes);
    uint32_t len;
    std::memcpy(&len, s, 4);
    if (len > out_cap) {
        *n_needed = len;
        return -3;
    }
    *kind_out = s[4];
    if (len) std::memcpy(out, s + SLOT_HDR, len);
    publish(rseq(base), seq + 1);
    return static_cast<int64_t>(len);
}

// Wait until data is available WITHOUT consuming it; returns the byte
// offset of the slot header within the segment, or -1 on timeout. The
// caller reads the frame in place and then calls rb_release. (Backs the
// zero-copy path: the wait happens GIL-free in native code, the view
// stays in Python.)
int64_t rb_wait_readable(uint8_t* base, uint64_t nslots,
                         uint64_t slot_bytes, double timeout_s) {
    uint64_t seq = rseq(base)->load(std::memory_order_relaxed);
    if (!wait_on(
            wseq(base),
            [&] {
                return wseq(base)->load(std::memory_order_acquire) > seq;
            },
            timeout_s))
        return -1;
    return static_cast<int64_t>(
        HDR + (seq % nslots) * (SLOT_HDR + slot_bytes));
}

void rb_release(uint8_t* base) {
    uint64_t seq = rseq(base)->load(std::memory_order_relaxed);
    publish(rseq(base), seq + 1);
}

int rb_has_space(uint8_t* base, uint64_t nslots) {
    return wseq(base)->load(std::memory_order_relaxed) -
               rseq(base)->load(std::memory_order_acquire) < nslots
           ? 1 : 0;
}

// Blocking wait for a free slot WITHOUT writing (the zero-copy producer
// serializes straight into the slot from Python, then calls
// rb_publish_write). 0 ok, -1 timeout.
int rb_wait_space(uint8_t* base, uint64_t nslots, double timeout_s) {
    uint64_t seq = wseq(base)->load(std::memory_order_relaxed);
    return wait_on(
               rseq(base),
               [&] {
                   return seq - rseq(base)->load(
                              std::memory_order_acquire) < nslots;
               },
               timeout_s)
           ? 0 : -1;
}

// Publish + futex-wake after a Python-side slot fill. Mixed-path rings
// (native reader, Python zero-copy writer) need these so sleeping
// native waiters wake immediately instead of at the futex re-check cap.
void rb_publish_write(uint8_t* base) {
    uint64_t seq = wseq(base)->load(std::memory_order_relaxed);
    publish(wseq(base), seq + 1);
}

void rb_wake_readers(uint8_t* base) { futex_wake_hint(wseq(base)); }
void rb_wake_writers(uint8_t* base) { futex_wake_hint(rseq(base)); }

}  // extern "C"
