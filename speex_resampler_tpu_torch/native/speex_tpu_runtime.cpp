// speex_tpu_runtime — native host runtime for the TPU resampler fleet.
//
// Role: the host-side counterpart of the reference's C runtime plumbing.
// Where the reference stages one stream's bytes across the wasm heap
// (src/index.ts:71-115) and re-aligns stream chunks in JS
// (src/index.ts:139-161), this runtime manages a *fleet*: per-stream FIFO
// ring buffers accept ragged pushes (bytes or frames), and full launch
// quanta are gathered/transposed into the time-major [n_in, B] int16 slab
// the device step consumes (lane l = stream*channels + channel; see
// speex_resampler_tpu/parallel/batch.py).  Output slabs [n_out, B] are
// scattered back to per-stream interleaved PCM.
//
// Pure C ABI for ctypes; no dependencies beyond libc++.  All hot loops are
// time-blocked to keep the strided slab writes cache-resident.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread -o libspeex_tpu_runtime.so \
//            speex_tpu_runtime.cpp

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <new>
#include <shared_mutex>
#include <thread>
#include <vector>

namespace {

// Fork-join pool over index ranges.  The caller's thread participates, so
// a pool of size n uses n-1 workers; size <= 1 (or tiny jobs) runs inline
// with zero overhead — important on single-vCPU hosts where the serial
// path IS the fast path.  Work is distributed by an atomic chunk counter
// so uneven per-range cost (e.g. ragged per-stream flush) load-balances.
class Pool {
 public:
  explicit Pool(int n_threads) {
    const int extra = n_threads - 1;
    for (int i = 0; i < extra; ++i)
      workers_.emplace_back([this] { WorkerLoop(); });
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(m_);
      stop_ = true;
      ++gen_;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  int size() const { return static_cast<int>(workers_.size()) + 1; }

  // Run fn over [0, total) split into grain-sized chunks across the pool.
  void Run(long total, long grain,
           const std::function<void(long, long)>& fn) {
    if (total <= 0) return;
    if (workers_.empty() || total <= grain) {
      fn(0, total);
      return;
    }
    {
      std::lock_guard<std::mutex> lk(m_);
      fn_ = &fn;
      total_ = total;
      grain_ = grain;
      next_.store(0, std::memory_order_relaxed);
      remaining_ = static_cast<int>(workers_.size()) + 1;
      ++gen_;
    }
    cv_.notify_all();
    Participate();
    std::unique_lock<std::mutex> lk(m_);
    done_cv_.wait(lk, [this] { return remaining_ == 0; });
    fn_ = nullptr;
  }

 private:
  void Participate() {
    const std::function<void(long, long)>& fn = *fn_;
    const long total = total_, grain = grain_;
    long i;
    while ((i = next_.fetch_add(grain, std::memory_order_relaxed)) < total) {
      const long hi = (i + grain < total) ? i + grain : total;
      fn(i, hi);
    }
    std::lock_guard<std::mutex> lk(m_);
    if (--remaining_ == 0) done_cv_.notify_all();
  }

  void WorkerLoop() {
    uint64_t seen = 0;
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait(lk, [&] { return stop_ || gen_ != seen; });
        if (stop_) return;
        seen = gen_;
        if (!fn_) continue;  // stop-gen bump or already-finished job
      }
      Participate();
    }
  }

  std::vector<std::thread> workers_;
  std::mutex m_;
  std::condition_variable cv_, done_cv_;
  const std::function<void(long, long)>* fn_ = nullptr;
  long total_ = 0, grain_ = 0;
  std::atomic<long> next_{0};
  int remaining_ = 0;
  uint64_t gen_ = 0;
  bool stop_ = false;
};

// Contiguous FIFO: amortized O(1) push/consume with front compaction.
struct Fifo {
  std::vector<int16_t> data;
  size_t head = 0;

  size_t size() const { return data.size() - head; }
  const int16_t* front() const { return data.data() + head; }

  void push(const int16_t* src, size_t n) {
    if (head > 0 && head >= data.size() / 2) {
      data.erase(data.begin(), data.begin() + static_cast<long>(head));
      head = 0;
    }
    data.insert(data.end(), src, src + n);
  }

  void consume(size_t n) {
    head += n;
    if (head >= data.size()) {
      data.clear();
      head = 0;
    }
  }
};

struct Runtime {
  int n_streams;
  int channels;
  long n_in;  // frames per lane per launch (the launch quantum)
  long B;     // n_streams * channels
  std::vector<Fifo> fifo;                 // per stream, interleaved frames
  std::vector<std::vector<uint8_t>> carry;  // per stream, byte-alignment
  std::vector<uint8_t> active;            // slots excluded from lockstep
  std::unique_ptr<Pool> pool;             // gather/scatter parallelism
  // srt_set_threads swaps the pool while fill/unpack may be running on
  // other engine threads (MultiFleet buckets are served concurrently):
  // writers (the swap) take this exclusively, pool users share it.
  std::shared_mutex pool_mu;
};

// Rows per cache-blocked transpose tile in the scatter (slab -> per-stream
// PCM).  64 measured 1.6x over 16 at -O3 (1.9x with -march=native) on the
// flagship geometry (S=1024, C=2, n_out=10240): the longer per-stream
// inner run amortizes pointer setup while the tile's source lines
// (64 rows x 64 B) still fit L1; 128 regresses (tile exceeds L1).
constexpr long kTimeTile = 64;

// Gather one [t0, t1) row range of the time-major slab from per-stream
// sources.  Stream-inner loops make the slab writes sequential (one
// contiguous row at a time) while each stream's source line stays hot in
// L2 across the whole tile (S cache lines ~= 64 KB).  C==1/C==2 specialize
// to single 16/32-bit stores — the generic per-frame memcpy of 2*C bytes
// is ~50x slower at C==2.
template <typename Fn>
static void gather_rows(int n_streams, int C, long B, long t0, long t1,
                        int16_t* out, Fn src_of) {
  if (C == 2) {
    for (long t = t0; t < t1; ++t) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(out + t * B);
      for (int s = 0; s < n_streams; ++s) {
        const int16_t* src = src_of(s);
        if (src)
          dst[s] = reinterpret_cast<const uint32_t*>(src)[t];
      }
    }
  } else if (C == 1) {
    for (long t = t0; t < t1; ++t) {
      int16_t* dst = out + t * B;
      for (int s = 0; s < n_streams; ++s) {
        const int16_t* src = src_of(s);
        if (src)
          dst[s] = src[t];
      }
    }
  } else {
    for (long t = t0; t < t1; ++t) {
      int16_t* dst = out + t * B;
      for (int s = 0; s < n_streams; ++s) {
        const int16_t* src = src_of(s);
        if (src)
          std::memcpy(dst + static_cast<long>(s) * C, src + t * C,
                      static_cast<size_t>(C) * 2);
      }
    }
  }
}

}  // namespace

extern "C" {

void* srt_create(int n_streams, int channels, long n_in_per_launch) {
  if (n_streams <= 0 || channels <= 0 || n_in_per_launch <= 0) return nullptr;
  auto* rt = new (std::nothrow) Runtime;
  if (!rt) return nullptr;
  rt->n_streams = n_streams;
  rt->channels = channels;
  rt->n_in = n_in_per_launch;
  rt->B = static_cast<long>(n_streams) * channels;
  rt->fifo.resize(static_cast<size_t>(n_streams));
  rt->carry.resize(static_cast<size_t>(n_streams));
  rt->active.assign(static_cast<size_t>(n_streams), 1);
  unsigned hw = std::thread::hardware_concurrency();
  rt->pool.reset(new Pool(hw > 1 ? static_cast<int>(hw) : 1));
  return rt;
}

// Resize the gather/scatter thread pool (default: hardware concurrency).
// Returns the effective size.  Safe concurrently with fill/unpack: the
// swap excludes in-flight pool users via Runtime::pool_mu.
int srt_set_threads(void* h, int n) {
  auto* rt = static_cast<Runtime*>(h);
  if (!rt || n < 1) return -1;
  std::unique_lock<std::shared_mutex> lk(rt->pool_mu);
  rt->pool.reset(new Pool(n));
  return rt->pool->size();
}

void srt_destroy(void* h) { delete static_cast<Runtime*>(h); }

// Push n_frames interleaved frames ([n, C] int16) for one stream.
int srt_push(void* h, int stream, const int16_t* frames, long n_frames) {
  auto* rt = static_cast<Runtime*>(h);
  if (!rt || stream < 0 || stream >= rt->n_streams || n_frames < 0) return -1;
  rt->fifo[static_cast<size_t>(stream)].push(
      frames, static_cast<size_t>(n_frames) * rt->channels);
  return 0;
}

// Push raw bytes with the reference Transform-stream alignment-carry
// semantics (src/index.ts:139-161): bytes that do not complete a frame are
// held until the next push.  Returns frames accepted, or -1.
long srt_push_bytes(void* h, int stream, const uint8_t* bytes, long n) {
  auto* rt = static_cast<Runtime*>(h);
  if (!rt || stream < 0 || stream >= rt->n_streams || n < 0) return -1;
  auto& carry = rt->carry[static_cast<size_t>(stream)];
  const long frame_bytes = rt->channels * 2;

  std::vector<uint8_t> buf;
  const uint8_t* p = bytes;
  long total = n;
  if (!carry.empty()) {
    buf.reserve(carry.size() + static_cast<size_t>(n));
    buf.insert(buf.end(), carry.begin(), carry.end());
    buf.insert(buf.end(), bytes, bytes + n);
    p = buf.data();
    total = static_cast<long>(buf.size());
    carry.clear();
  }
  const long frames = total / frame_bytes;
  const long used = frames * frame_bytes;
  if (frames > 0) {
    // int16 little-endian on all supported hosts; frames may be unaligned
    std::vector<int16_t> tmp(static_cast<size_t>(used) / 2);
    std::memcpy(tmp.data(), p, static_cast<size_t>(used));
    rt->fifo[static_cast<size_t>(stream)].push(tmp.data(), tmp.size());
  }
  if (total - used > 0)
    carry.assign(p + used, p + total);
  return frames;
}

// Staged whole frames for ONE stream (O(1); the array form below is O(S)
// and too heavy for a per-push backpressure check).  Returns -1 on a bad
// stream index.
long srt_staged_one(void* h, int stream) {
  auto* rt = static_cast<Runtime*>(h);
  if (!rt || stream < 0 || stream >= rt->n_streams) return -1;
  return static_cast<long>(rt->fifo[static_cast<size_t>(stream)].size()) /
         rt->channels;
}

// Staged whole frames per stream (out: long[n_streams]).
void srt_staged(void* h, long* out) {
  auto* rt = static_cast<Runtime*>(h);
  for (int s = 0; s < rt->n_streams; ++s)
    out[s] = static_cast<long>(rt->fifo[static_cast<size_t>(s)].size()) /
             rt->channels;
}

// Mark a slot (in)active: inactive slots are excluded from the lockstep
// readiness test and zero-filled in launch slabs (dynamic fleet occupancy).
// Deactivating clears the slot's buffers.
int srt_set_active(void* h, int stream, int is_active) {
  auto* rt = static_cast<Runtime*>(h);
  if (!rt || stream < 0 || stream >= rt->n_streams) return -1;
  rt->active[static_cast<size_t>(stream)] = is_active ? 1 : 0;
  if (!is_active) {
    rt->fifo[static_cast<size_t>(stream)] = Fifo();
    rt->carry[static_cast<size_t>(stream)].clear();
  }
  return 0;
}

// Number of full launch quanta available across all ACTIVE streams.
long srt_ready_launches(void* h) {
  auto* rt = static_cast<Runtime*>(h);
  long m = -1;
  for (int s = 0; s < rt->n_streams; ++s) {
    if (!rt->active[static_cast<size_t>(s)]) continue;
    long f = static_cast<long>(rt->fifo[static_cast<size_t>(s)].size()) /
             rt->channels;
    m = (m < 0 || f < m) ? f : m;
  }
  return m <= 0 ? 0 : m / rt->n_in;
}

// Gather one launch quantum into the time-major slab out[n_in][B] and
// consume the frames.  Requires srt_ready_launches() >= 1; returns -1 if
// any stream is short.
int srt_fill_launch(void* h, int16_t* out) {
  auto* rt = static_cast<Runtime*>(h);
  const int C = rt->channels;
  const long B = rt->B, n_in = rt->n_in;
  bool any_inactive = false, any_active = false;
  for (int s = 0; s < rt->n_streams; ++s) {
    if (!rt->active[static_cast<size_t>(s)]) { any_inactive = true; continue; }
    any_active = true;
    if (static_cast<long>(rt->fifo[static_cast<size_t>(s)].size()) <
        n_in * C)
      return -1;
  }
  if (!any_active) return -1;  // no launch is "ready" with zero streams
  if (any_inactive)
    std::memset(out, 0, static_cast<size_t>(n_in) * B * 2);
  std::vector<const int16_t*> srcs(static_cast<size_t>(rt->n_streams));
  for (int s = 0; s < rt->n_streams; ++s)
    srcs[static_cast<size_t>(s)] = rt->active[static_cast<size_t>(s)]
        ? rt->fifo[static_cast<size_t>(s)].front() : nullptr;
  // parallel over time-row ranges: each range's slab writes are disjoint
  std::shared_lock<std::shared_mutex> pool_lk(rt->pool_mu);
  rt->pool->Run(n_in, /*grain=*/256, [&](long t0, long t1) {
    gather_rows(rt->n_streams, C, B, t0, t1, out,
                [&](int s) { return srcs[static_cast<size_t>(s)]; });
  });
  for (int s = 0; s < rt->n_streams; ++s)
    if (rt->active[static_cast<size_t>(s)])
      rt->fifo[static_cast<size_t>(s)].consume(
          static_cast<size_t>(n_in) * C);
  return 0;
}

// Drain: zero-pad every stream to one launch quantum, consume everything.
// Writes the pre-drain staged frame count per stream to staged_out
// (long[n_streams]) so the caller can trim per-stream valid output.
// Returns the max staged count (0 = nothing to flush, slab untouched).
long srt_fill_flush(void* h, int16_t* out, long* staged_out) {
  auto* rt = static_cast<Runtime*>(h);
  const int C = rt->channels;
  const long B = rt->B, n_in = rt->n_in;
  long mx = 0;
  for (int s = 0; s < rt->n_streams; ++s) {
    long f = rt->active[static_cast<size_t>(s)]
        ? static_cast<long>(rt->fifo[static_cast<size_t>(s)].size()) / C
        : 0;
    if (f > n_in) f = n_in;
    staged_out[s] = f;
    if (f > mx) mx = f;
  }
  if (mx == 0) return 0;
  std::memset(out, 0, static_cast<size_t>(n_in) * B * 2);
  // parallel over streams (column ranges are disjoint; ragged per-stream
  // lengths load-balance through the pool's chunked work queue)
  std::shared_lock<std::shared_mutex> pool_lk(rt->pool_mu);
  rt->pool->Run(rt->n_streams, /*grain=*/8, [&](long s0, long s1) {
    for (long s = s0; s < s1; ++s) {
      const long f = staged_out[s];
      const int16_t* src = rt->fifo[static_cast<size_t>(s)].front();
      int16_t* dst = out + s * C;
      for (long t = 0; t < f; ++t, src += C, dst += B)
        std::memcpy(dst, src, static_cast<size_t>(C) * 2);
    }
  });
  for (int s = 0; s < rt->n_streams; ++s)
    rt->fifo[static_cast<size_t>(s)].consume(
        static_cast<size_t>(staged_out[s]) * C);
  return mx;
}

// Checkpoint support: copy (without consuming) one stream's staged frames
// into dst[staged][C].  Caller sizes dst from srt_staged().
// Returns -1 on an out-of-range stream (the PyStager reference raises).
int srt_peek(void* h, int stream, int16_t* dst) {
  auto* rt = static_cast<Runtime*>(h);
  if (!rt || stream < 0 || stream >= rt->n_streams) return -1;
  const auto& f = rt->fifo[static_cast<size_t>(stream)];
  std::memcpy(dst, f.front(), f.size() * 2);
  return 0;
}

// Checkpoint support: alignment-carry bytes for one stream (-1 = bad index).
long srt_carry_size(void* h, int stream) {
  auto* rt = static_cast<Runtime*>(h);
  if (!rt || stream < 0 || stream >= rt->n_streams) return -1;
  return static_cast<long>(rt->carry[static_cast<size_t>(stream)].size());
}

int srt_get_carry(void* h, int stream, uint8_t* dst) {
  auto* rt = static_cast<Runtime*>(h);
  if (!rt || stream < 0 || stream >= rt->n_streams) return -1;
  const auto& c = rt->carry[static_cast<size_t>(stream)];
  std::memcpy(dst, c.data(), c.size());
  return 0;
}

// Scatter a device result slab y[n_out][B] back to one stream's
// interleaved PCM dst[n_out][C].  Returns -1 on an out-of-range stream.
int srt_unpack(void* h, const int16_t* y, long n_out, int stream,
               int16_t* dst) {
  auto* rt = static_cast<Runtime*>(h);
  if (!rt || stream < 0 || stream >= rt->n_streams) return -1;
  const int C = rt->channels;
  const long B = rt->B;
  const int16_t* src = y + static_cast<long>(stream) * C;
  for (long t = 0; t < n_out; ++t, src += B, dst += C)
    std::memcpy(dst, src, static_cast<size_t>(C) * 2);
  return 0;
}

// Scatter the whole slab y[n_out][B] to [S, n_out, C] (stream-major).
// Time-tiled with per-stream inner runs: bounds the TLB working set to one
// page per stream per tile while keeping word-sized stores.
void srt_unpack_all(void* h, const int16_t* y, long n_out, int16_t* dst) {
  auto* rt = static_cast<Runtime*>(h);
  const int C = rt->channels;
  const long B = rt->B;
  // parallel over time-row tiles; each worker range walks whole tiles so
  // per-stream destination runs stay contiguous
  std::shared_lock<std::shared_mutex> pool_lk(rt->pool_mu);
  rt->pool->Run((n_out + kTimeTile - 1) / kTimeTile, /*grain=*/16,
                [&](long k0, long k1) {
  for (long t0 = k0 * kTimeTile; t0 < k1 * kTimeTile && t0 < n_out;
       t0 += kTimeTile) {
    const long t1 = (t0 + kTimeTile < n_out) ? t0 + kTimeTile : n_out;
    if (C == 2) {
      for (int s = 0; s < rt->n_streams; ++s) {
        const uint32_t* src =
            reinterpret_cast<const uint32_t*>(y + t0 * B) + s;
        uint32_t* d = reinterpret_cast<uint32_t*>(
            dst + (static_cast<long>(s) * n_out + t0) * 2);
        for (long t = t0; t < t1; ++t, src += B / 2)
          *d++ = *src;
      }
    } else if (C == 1) {
      for (int s = 0; s < rt->n_streams; ++s) {
        const int16_t* src = y + t0 * B + s;
        int16_t* d = dst + static_cast<long>(s) * n_out + t0;
        for (long t = t0; t < t1; ++t, src += B)
          *d++ = *src;
      }
    } else {
      for (int s = 0; s < rt->n_streams; ++s) {
        const int16_t* src = y + t0 * B + static_cast<long>(s) * C;
        int16_t* d = dst + (static_cast<long>(s) * n_out + t0) * C;
        for (long t = t0; t < t1; ++t, src += B, d += C)
          std::memcpy(d, src, static_cast<size_t>(C) * 2);
      }
    }
  }
  });
}

// ---- Lane-major fast path -------------------------------------------------
//
// The time-major slab layout above matches the device kernels' input, but
// both host transforms then walk one axis with a B-element stride (1 KB at
// the 256-stream flagship) — a cache-hostile transpose the reference never
// pays because its wasm heap serves ONE stream (src/index.ts:92,111-115).
// The lane-major pair below keeps every host access CONTIGUOUS per stream
// (the transpose rides the TPU inside the jitted step, where it is
// HBM-bandwidth trivial): measured 23x on the gather and 3.3x on the
// scatter at S=256, q=9408 on the serving host — both within ~30% of a
// bare memcpy of the same bytes.

// Gather one launch quantum into the LANE-MAJOR slab out[B][stride]
// (stride >= n_in; columns [n_in, stride) are never touched, so a
// persistent slab's zero tail survives).  Per stream this DEINTERLEAVES
// [n_in, C] frames into C contiguous rows.  Same readiness contract and
// consumption as srt_fill_launch.
int srt_fill_launch_lm(void* h, int16_t* out, long stride) {
  auto* rt = static_cast<Runtime*>(h);
  const int C = rt->channels;
  const long n_in = rt->n_in;
  if (stride < n_in) return -1;
  bool any_active = false;
  for (int s = 0; s < rt->n_streams; ++s) {
    if (!rt->active[static_cast<size_t>(s)]) continue;
    any_active = true;
    if (static_cast<long>(rt->fifo[static_cast<size_t>(s)].size()) <
        n_in * C)
      return -1;
  }
  if (!any_active) return -1;
  std::shared_lock<std::shared_mutex> pool_lk(rt->pool_mu);
  rt->pool->Run(rt->n_streams, /*grain=*/8, [&](long s0, long s1) {
    for (long s = s0; s < s1; ++s) {
      int16_t* lane0 = out + s * C * stride;
      if (!rt->active[static_cast<size_t>(s)]) {
        for (int c = 0; c < C; ++c)
          std::memset(lane0 + static_cast<long>(c) * stride, 0,
                      static_cast<size_t>(n_in) * 2);
        continue;
      }
      const int16_t* src = rt->fifo[static_cast<size_t>(s)].front();
      if (C == 2) {
        // one 32-bit load per frame, split into the two lane rows
        const uint32_t* sp = reinterpret_cast<const uint32_t*>(src);
        int16_t* r0 = lane0;
        int16_t* r1 = lane0 + stride;
        for (long t = 0; t < n_in; ++t) {
          const uint32_t v = sp[t];  // little-endian, as srt_push_bytes
          r0[t] = static_cast<int16_t>(v & 0xffffu);
          r1[t] = static_cast<int16_t>(v >> 16);
        }
      } else if (C == 1) {
        std::memcpy(lane0, src, static_cast<size_t>(n_in) * 2);
      } else {
        for (int c = 0; c < C; ++c) {
          int16_t* r = lane0 + static_cast<long>(c) * stride;
          for (long t = 0; t < n_in; ++t) r[t] = src[t * C + c];
        }
      }
    }
  });
  for (int s = 0; s < rt->n_streams; ++s)
    if (rt->active[static_cast<size_t>(s)])
      rt->fifo[static_cast<size_t>(s)].consume(
          static_cast<size_t>(n_in) * C);
  return 0;
}

// Scatter a LANE-MAJOR result slab y[B][n_out] to [S, n_out, C]: per
// stream this INTERLEAVES C contiguous rows — a streaming zip the
// compiler vectorizes, vs. the B-strided walk of srt_unpack_all.
void srt_unpack_all_lm(void* h, const int16_t* y, long n_out,
                       int16_t* dst) {
  auto* rt = static_cast<Runtime*>(h);
  const int C = rt->channels;
  std::shared_lock<std::shared_mutex> pool_lk(rt->pool_mu);
  rt->pool->Run(rt->n_streams, /*grain=*/8, [&](long s0, long s1) {
    for (long s = s0; s < s1; ++s) {
      const int16_t* lane0 = y + s * C * n_out;
      if (C == 2) {
        const int16_t* a = lane0;
        const int16_t* b = lane0 + n_out;
        uint32_t* d = reinterpret_cast<uint32_t*>(dst + s * n_out * 2);
        for (long t = 0; t < n_out; ++t)
          d[t] = static_cast<uint16_t>(a[t]) |
                 (static_cast<uint32_t>(static_cast<uint16_t>(b[t])) << 16);
      } else if (C == 1) {
        std::memcpy(dst + s * n_out, lane0,
                    static_cast<size_t>(n_out) * 2);
      } else {
        int16_t* d = dst + s * n_out * C;
        for (int c = 0; c < C; ++c) {
          const int16_t* r = lane0 + static_cast<long>(c) * n_out;
          for (long t = 0; t < n_out; ++t) d[t * C + c] = r[t];
        }
      }
    }
  });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Single-stream FIR hot loops — the native twins of ops/fir_fixed.py and
// ops/fir_exact.py, serving ResamplerCore (SpeexResampler, MultiFleet
// transitions) at reference-C speed on the host.  The reference's own hot
// loops are resample.c:331-559; these are fresh implementations of the
// same DOCUMENTED arithmetic contracts (see the two Python modules, which
// remain the semantics references and differential-test oracles).
//
// FIXED universe (Q15): all accumulation is int32 with two's-complement
// wraparound — wrapping addition is associative and commutative, so ANY
// vectorization order is bit-identical to the serial C loop.  Compile with
// -fwrapv so signed overflow is defined wraparound.
//
// FLOAT universe: accumulation ORDER is part of the contract (f32 serial /
// 4-way f64, matching resample.c:331-436 and :438-559).  The loops below
// preserve those orders exactly; the build must use -ffp-contract=off so
// mul+add never contracts to FMA (the reference oracle is built without
// FMA).  Outputs are the raw f32 sums; WORD2INT stays in Python
// (ops/convert.word2int_np), identical either way.

extern "C" {

static inline int16_t sat32pshr15_i16(int32_t s) {
  const int32_t hi = 32767 << 15;
  if (s >= hi) return 32767;
  if (s <= -hi) return -32767;
  return static_cast<int16_t>((s + (1 << 14)) >> 15);
}

// MULT16_32_Q15 (fixed_generic.h:90): a*(b>>15) + ((a*(b&0x7fff))>>15),
// all int32 with wraparound (-fwrapv).
static inline int32_t mult16_32_q15_i(int32_t a, int32_t b) {
  return a * (b >> 15) + ((a * (b & 0x7fff)) >> 15);
}

// Direct path (resample.c:331-384 FIXED branch): per output, a Q15 dot
// over filt_len taps; epilogue (int16)SATURATE32PSHR(sum, 15, 32767).
// x: int16 [B, T]; taps: int16 [n_rows, N]; starts/phases: int64 [n_out]
// (phase indexes taps rows); out: int16 [B, n_out].
void srt_fir_q15_direct(const int16_t* x, long B, long T,
                        const int16_t* taps, long N,
                        const int64_t* starts, const int64_t* phases,
                        long n_out, int16_t* out) {
  for (long b = 0; b < B; ++b) {
    const int16_t* xb = x + b * T;
    int16_t* ob = out + b * n_out;
    for (long k = 0; k < n_out; ++k) {
      const int16_t* tp = taps + phases[k] * N;
      const int16_t* xs = xb + starts[k];
      int32_t acc = 0;
      for (long j = 0; j < N; ++j)
        acc += static_cast<int32_t>(tp[j]) * xs[j];
      ob[k] = sat32pshr15_i16(acc);
    }
  }
}

// Interpolated path (resample.c:438-496 FIXED branch) over PRE-COLLAPSED
// per-phase tensors (filter_design.fixed_interp_tensors): 4 Q15 tap rows
// + 4 Q15 cubic coefficients per phase; epilogue resample.c:474-479.
// taps4: int16 [n_rows, 4, N]; coef4: int16 [n_rows, 4].
void srt_fir_q15_interp(const int16_t* x, long B, long T,
                        const int16_t* taps4, const int16_t* coef4, long N,
                        const int64_t* starts, const int64_t* phases,
                        long n_out, int16_t* out) {
  for (long b = 0; b < B; ++b) {
    const int16_t* xb = x + b * T;
    int16_t* ob = out + b * n_out;
    for (long k = 0; k < n_out; ++k) {
      const int16_t* tp = taps4 + phases[k] * 4 * N;
      const int16_t* cf = coef4 + phases[k] * 4;
      const int16_t* xs = xb + starts[k];
      int32_t sum = 0;
      for (int c = 0; c < 4; ++c) {
        const int16_t* t = tp + c * N;
        int32_t acc = 0;
        for (long j = 0; j < N; ++j)
          acc += static_cast<int32_t>(t[j]) * xs[j];
        sum += mult16_32_q15_i(static_cast<int32_t>(cf[c]), acc >> 1);
      }
      ob[k] = sat32pshr15_i16(sum);
    }
  }
}

// Float direct path, BOTH variants (resample.c:331-436 float macros).
// dbl=0: serial f32 accumulator (resampler_basic_direct_single).
// dbl=1: four f64 accumulators filled j%4-interleaved with f32 products,
// combined ((a0+a1)+a2)+a3, narrowed to f32 (quality > 8 variant).
// x: f32 [B, T]; taps: f32 [n_rows, N]; out: f32 sums [B, n_out].
static inline double fir_f32_direct_dbl_one(const float* tp,
                                            const float* xs, long N) {
  double a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  long j = 0;
  for (; j + 3 < N; j += 4) {
    a0 += static_cast<double>(tp[j] * xs[j]);
    a1 += static_cast<double>(tp[j + 1] * xs[j + 1]);
    a2 += static_cast<double>(tp[j + 2] * xs[j + 2]);
    a3 += static_cast<double>(tp[j + 3] * xs[j + 3]);
  }
  for (; j < N; ++j) {  // filt_len is always a multiple of 4 in practice
    // (x8 rounding, resample.c:625), but stay total
    if (j % 4 == 0) a0 += static_cast<double>(tp[j] * xs[j]);
    else if (j % 4 == 1) a1 += static_cast<double>(tp[j] * xs[j]);
    else if (j % 4 == 2) a2 += static_cast<double>(tp[j] * xs[j]);
    else a3 += static_cast<double>(tp[j] * xs[j]);
  }
  return ((a0 + a1) + a2) + a3;
}

// Phase-grouped direct single variant: outputs k ≡ g (mod den) share the
// tap row phases[g] and their windows slide by exactly num samples
// (phases[k] = (f0+k*num) mod den; starts[k+den] = starts[k]+num), so a
// group is a plain correlation.  Vectorizing across OUTPUTS (16 lanes)
// keeps each output's own serial f32 j-order — the bit-exactness
// contract — while the adds become one packed op per tap instead of a
// latency-bound scalar chain.  This is the host mirror of the batched
// device formulation (ops/fir_matmul: phase-grouped strided matmul).
static void fir_f32_direct_grouped(const float* xb, float* ob,
                                   const float* taps, long N,
                                   const int64_t* starts,
                                   const int64_t* phases, long n_out,
                                   long num, long den) {
  constexpr int L = 16;
  for (long g = 0; g < den; ++g) {
    if (g >= n_out) break;
    const float* tp = taps + phases[g] * N;
    const float* xg = xb + starts[g];
    const long m = (n_out - g + den - 1) / den;
    long i = 0;
    for (; i + L <= m; i += L) {
      float acc[L] = {0};
      const float* xr0 = xg + i * num;
      for (long j = 0; j < N; ++j) {
        const float t = tp[j];
        const float* xr = xr0 + j;
        for (int l = 0; l < L; ++l) acc[l] += t * xr[l * num];
      }
      for (int l = 0; l < L; ++l) ob[g + (i + l) * den] = acc[l];
    }
    for (; i < m; ++i) {  // tail, same serial order
      const float* xs = xg + i * num;
      float s = 0.0f;
      for (long j = 0; j < N; ++j) s += tp[j] * xs[j];
      ob[g + i * den] = s;
    }
  }
}

// num/den: the canonical phase recurrence of starts/phases when > 0
// (enables the grouped path); pass 0 when the arrays are not known to
// follow it (e.g. identity phases over gathered rows).
void srt_fir_f32_direct(const float* x, long B, long T,
                        const float* taps, long N,
                        const int64_t* starts, const int64_t* phases,
                        long n_out, int dbl, long num, long den,
                        float* out) {
  for (long b = 0; b < B; ++b) {
    const float* xb = x + b * T;
    float* ob = out + b * n_out;
    if (dbl) {
      // already 4 chains of ILP per output (the j%4-interleaved f64
      // accumulators) — no cross-output interleave needed
      for (long k = 0; k < n_out; ++k)
        ob[k] = static_cast<float>(fir_f32_direct_dbl_one(
            taps + phases[k] * N, xb + starts[k], N));
      continue;
    }
    if (num > 0 && den > 0 && n_out >= 2 * den) {
      fir_f32_direct_grouped(xb, ob, taps, N, starts, phases, n_out,
                             num, den);
      continue;
    }
    // Single variant, 4 outputs at a time: each output keeps its OWN
    // serial f32 add order (the bit-exactness contract) — the four
    // chains are independent, so they interleave for ~4x ILP on the
    // latency-bound serial adds.
    long k = 0;
    for (; k + 3 < n_out; k += 4) {
      const float* t0 = taps + phases[k] * N;
      const float* t1 = taps + phases[k + 1] * N;
      const float* t2 = taps + phases[k + 2] * N;
      const float* t3 = taps + phases[k + 3] * N;
      const float* x0 = xb + starts[k];
      const float* x1 = xb + starts[k + 1];
      const float* x2 = xb + starts[k + 2];
      const float* x3 = xb + starts[k + 3];
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
      for (long j = 0; j < N; ++j) {
        s0 += t0[j] * x0[j];
        s1 += t1[j] * x1[j];
        s2 += t2[j] * x2[j];
        s3 += t3[j] * x3[j];
      }
      ob[k] = s0;
      ob[k + 1] = s1;
      ob[k + 2] = s2;
      ob[k + 3] = s3;
    }
    for (; k < n_out; ++k) {  // tail, same serial order
      const float* tp = taps + phases[k] * N;
      const float* xs = xb + starts[k];
      float s = 0.0f;
      for (long j = 0; j < N; ++j) s += tp[j] * xs[j];
      ob[k] = s;
    }
  }
}

// Float cubic_coef (resample.c:318-329): f32 expressions left-to-right;
// interp[2] = 1.0(double) - others, narrowed to f32 at the store.
static inline void cubic_coef_f32(float frac, float* interp) {
  interp[0] = -0.16667f * frac + 0.16667f * frac * frac * frac;
  interp[1] = frac + 0.5f * frac * frac - 0.5f * frac * frac * frac;
  interp[3] = -0.33333f * frac + 0.5f * frac * frac
              - 0.16667f * frac * frac * frac;
  interp[2] = static_cast<float>(1. - interp[0] - interp[1] - interp[3]);
}

// Float interpolated path, BOTH variants (resample.c:438-559 float
// macros): per output, offset/frac from the uint32-wrapped phase*ov,
// four accumulators over f32 products (f32 accs when dbl=0, f64 when
// dbl=1), mixed ((i0*a0 + i1*a1) + i2*a2) + i3*a3 in the accumulator
// dtype, narrowed to f32.  sinc: the raw interp-layout table
// (oversample*filt_len + 8 entries, offset 4 — resample.c:689-691).
void srt_fir_f32_interp(const float* x, long B, long T,
                        const float* sinc, long ov, long den, long N,
                        const int64_t* starts, const int64_t* phases,
                        long n_out, int dbl, float* out) {
  for (long b = 0; b < B; ++b) {
    const float* xb = x + b * T;
    float* ob = out + b * n_out;
    for (long k = 0; k < n_out; ++k) {
      const uint32_t prod = static_cast<uint32_t>(
          static_cast<uint64_t>(phases[k]) * static_cast<uint64_t>(ov));
      const long offset = static_cast<long>(prod / den);
      const float frac = static_cast<float>(prod % den)
                         / static_cast<float>(den);
      float interp[4];
      cubic_coef_f32(frac, interp);
      const float* tb = sinc + 2 + ov - offset;  // base(j,c) = tb[j*ov+c]
      const float* xs = xb + starts[k];
      if (dbl) {
        double a0 = 0, a1 = 0, a2 = 0, a3 = 0;
        for (long j = 0; j < N; ++j) {
          const float cj = xs[j];
          const float* t = tb + j * ov;
          a0 += static_cast<double>(cj * t[0]);
          a1 += static_cast<double>(cj * t[1]);
          a2 += static_cast<double>(cj * t[2]);
          a3 += static_cast<double>(cj * t[3]);
        }
        ob[k] = static_cast<float>(
            ((static_cast<double>(interp[0]) * a0
              + static_cast<double>(interp[1]) * a1)
             + static_cast<double>(interp[2]) * a2)
            + static_cast<double>(interp[3]) * a3);
      } else if (k + 1 < n_out) {
        // pair two outputs: each keeps its own four serial f32 chains
        // (the contract), eight independent chains total for ILP
        const uint32_t prod2 = static_cast<uint32_t>(
            static_cast<uint64_t>(phases[k + 1])
            * static_cast<uint64_t>(ov));
        const long offset2 = static_cast<long>(prod2 / den);
        const float frac2 = static_cast<float>(prod2 % den)
                            / static_cast<float>(den);
        float interp2[4];
        cubic_coef_f32(frac2, interp2);
        const float* ub = sinc + 2 + ov - offset2;
        const float* ys = xb + starts[k + 1];
        float a0 = 0, a1 = 0, a2 = 0, a3 = 0;
        float c0 = 0, c1 = 0, c2 = 0, c3 = 0;
        for (long j = 0; j < N; ++j) {
          const float cj = xs[j];
          const float dj = ys[j];
          const float* t = tb + j * ov;
          const float* u = ub + j * ov;
          a0 += cj * t[0];
          a1 += cj * t[1];
          a2 += cj * t[2];
          a3 += cj * t[3];
          c0 += dj * u[0];
          c1 += dj * u[1];
          c2 += dj * u[2];
          c3 += dj * u[3];
        }
        ob[k] = ((interp[0] * a0 + interp[1] * a1) + interp[2] * a2)
                + interp[3] * a3;
        ob[k + 1] = ((interp2[0] * c0 + interp2[1] * c1)
                     + interp2[2] * c2) + interp2[3] * c3;
        ++k;  // consumed two outputs
      } else {
        float a0 = 0, a1 = 0, a2 = 0, a3 = 0;
        for (long j = 0; j < N; ++j) {
          const float cj = xs[j];
          const float* t = tb + j * ov;
          a0 += cj * t[0];
          a1 += cj * t[1];
          a2 += cj * t[2];
          a3 += cj * t[3];
        }
        ob[k] = ((interp[0] * a0 + interp[1] * a1) + interp[2] * a2)
                + interp[3] * a3;
      }
    }
  }
}

}  // extern "C"
