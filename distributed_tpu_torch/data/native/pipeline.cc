// Native input pipeline: threaded shuffle + gather + normalize + prefetch.
//
// The port's copy of the JAX package's data/native/pipeline.cc, the code
// unchanged. Host-side batch preparation (permuting indices, gathering
// rows, uint8->float32 /255 normalization) is the part of the hot loop no
// kernel does, and in Python it stalls the card between steps at ImageNet
// scale. Here it runs in C++ worker threads that keep a bounded queue of
// ready batches ahead of the consumer, so the host overlaps batch prep
// with device execution.
//
// Exposed as a plain C ABI and driven from Python via ctypes; see
// ../pipeline.py, which builds it with g++ at first use and also carries
// a Python path with the same semantics.
//
// Determinism: batch b of pass p depends only on (seed, p, b), so two
// pipelines constructed with the same arguments emit identical streams
// regardless of thread count or timing. With external_perms (the default
// from Python since the shuffle unification) the per-pass permutation is
// SUPPLIED by the driver via dtpu_pipeline_supply_perm — one numpy
// computation shared with the Python fallback, so native and Python emit
// bit-identical streams; workers block until the pass they need has been
// supplied (the driver hands over every reachable pass before each next()
// call, so they never wait in steady state). Without it (legacy mode,
// DTPU_NATIVE_LEGACY_SHUFFLE=1), a splitmix64-seeded Fisher-Yates
// permutation is generated here, as before the unification.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// splitmix64: tiny, seedable, high-quality enough for shuffling.
struct SplitMix64 {
  uint64_t s;
  explicit SplitMix64(uint64_t seed) : s(seed) {}
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // Unbiased bounded draw (rejection sampling).
  uint64_t below(uint64_t bound) {
    uint64_t threshold = (~bound + 1) % bound;  // 2^64 mod bound
    for (;;) {
      uint64_t r = next();
      if (r >= threshold) return r % bound;
    }
  }
};

struct Slot {
  std::vector<float> x;
  std::vector<int32_t> y;
  int64_t step = -1;  // which global step this slot holds; -1 = empty
  bool filled = false;
};

}  // namespace

struct DtpuPipeline {
  // Row storage as spans: one span for an in-memory array, several for a
  // file-backed source (each span is one memory-mapped shard file). Rows
  // are resolved span-first via binary search on cumulative starts, so the
  // gather path is identical for both; the OS pages mapped shards in and
  // out on demand, which is what makes larger-than-RAM datasets feedable.
  std::vector<const uint8_t*> xs;
  std::vector<int64_t> span_starts;  // size == xs.size() + 1; last == n
  const int32_t* y;
  int64_t n, row, batch, steps_per_pass;
  // Per-host sharding: this producer prepares only rows
  // [shard_index * shard_rows, (shard_index + 1) * shard_rows) of each
  // global batch; the step/pass/permutation sequence is identical on every
  // host (same seed), so the host slices assemble into the exact global
  // batch an unsharded pipeline would emit.
  int64_t shard_index, shard_count, shard_rows;
  bool shuffle;
  uint64_t seed;
  float scale;
  int depth;

  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::vector<Slot> slots;
  std::atomic<int64_t> next_step{0};  // claimed by producers
  std::atomic<int64_t> consumed{0};   // next step the consumer will take
  bool stop = false;

  // Per-pass permutations (guarded by perm_mu): generated lazily here
  // (legacy mode) or supplied by the driver (external_perms). Only passes
  // that can still be in a producer's fill window are retained; older ones
  // are pruned so memory stays bounded over arbitrarily long runs (each
  // pass's permutation is n * 8 bytes — ~10MB at ImageNet scale).
  // shared_ptr keeps a pruned-but-in-use permutation alive for its reader.
  std::mutex perm_mu;
  std::condition_variable cv_perm;
  std::map<int64_t, std::shared_ptr<std::vector<int64_t>>> perms;
  bool external_perms = false;
  bool perm_stop = false;  // guarded by perm_mu; set at destroy

  std::vector<std::thread> workers;

  std::shared_ptr<std::vector<int64_t>> perm_for(int64_t pass) {
    std::unique_lock<std::mutex> lock(perm_mu);
    auto it = perms.find(pass);
    if (it == perms.end()) {
      if (external_perms) {
        // The driver supplies every reachable pass before each next()
        // call; a wait here only happens at startup or right after a
        // seek, and destroy() unblocks it via perm_stop.
        cv_perm.wait(lock, [&] { return perm_stop || perms.count(pass); });
        if (perm_stop) return nullptr;
        it = perms.find(pass);
      } else {
        auto order = std::make_shared<std::vector<int64_t>>(n);
        for (int64_t i = 0; i < n; ++i) (*order)[i] = i;
        if (shuffle) {
          // Seed mixes (seed, pass) so each pass reshuffles
          // deterministically.
          SplitMix64 rng(seed * 0x9e3779b97f4a7c15ULL + (uint64_t)pass + 1);
          for (int64_t i = n - 1; i > 0; --i) {
            int64_t j = (int64_t)rng.below((uint64_t)i + 1);
            std::swap((*order)[i], (*order)[j]);
          }
        }
        it = perms.emplace(pass, std::move(order)).first;
      }
    }
    std::shared_ptr<std::vector<int64_t>> result = it->second;
    // Any step still fillable is >= consumed, so passes below
    // consumed / steps_per_pass can no longer be requested.
    const int64_t min_pass = consumed.load() / steps_per_pass;
    perms.erase(perms.begin(), perms.lower_bound(min_pass));
    return result;
  }

  void supply_perm(int64_t pass, const int64_t* perm) {
    auto order = std::make_shared<std::vector<int64_t>>(perm, perm + n);
    {
      std::lock_guard<std::mutex> lock(perm_mu);
      perms.emplace(pass, std::move(order));
    }
    cv_perm.notify_all();
  }

  bool fill(Slot& slot, int64_t step) {
    int64_t pass = step / steps_per_pass;
    int64_t within = step % steps_per_pass;
    // Hold the shared_ptr for the whole fill: pruning may drop the map entry.
    std::shared_ptr<std::vector<int64_t>> order_sp = perm_for(pass);
    if (!order_sp) return false;  // stopped while waiting for the pass
    const std::vector<int64_t>& order = *order_sp;
    const int64_t start = within * batch + shard_index * shard_rows;
    slot.x.resize((size_t)(shard_rows * row));
    slot.y.resize((size_t)shard_rows);
    for (int64_t b = 0; b < shard_rows; ++b) {
      const int64_t src = order[start + b];
      // Span holding row `src`: last start <= src.
      const size_t span =
          (size_t)(std::upper_bound(span_starts.begin(), span_starts.end(),
                                    src) -
                   span_starts.begin()) -
          1;
      const uint8_t* in = xs[span] + (src - span_starts[span]) * row;
      float* out = slot.x.data() + b * row;
      for (int64_t e = 0; e < row; ++e) out[e] = (float)in[e] * scale;
      slot.y[(size_t)b] = y ? y[src] : 0;
    }
    // slot.step is published under mu in worker(): the consumer's wait
    // predicate reads it, and an unlocked write here would race.
    return true;
  }

  void worker() {
    for (;;) {
      const int64_t step = next_step.fetch_add(1);
      const int idx = (int)(step % depth);
      Slot& slot = slots[(size_t)idx];
      // Wait until the consumer has drained the previous occupant of this
      // ring slot (step - depth), then fill and publish.
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_produce.wait(lock, [&] { return stop || consumed + depth > step; });
        if (stop) return;
      }
      if (!fill(slot, step)) return;  // destroyed mid-wait for a perm
      {
        std::lock_guard<std::mutex> lock(mu);
        slot.step = step;
        slot.filled = true;
      }
      cv_consume.notify_all();
    }
  }
};

extern "C" {

// Spans form: `xs` is `n_spans` base pointers, `span_rows` their row
// counts (summing to n). The single-array entry point below wraps this
// with one span; a file-backed source passes one span per mapped shard.
DtpuPipeline* dtpu_pipeline_create_spans(
    const uint8_t* const* xs, const int64_t* span_rows, int64_t n_spans,
    const int32_t* y, int64_t n, int64_t row_elems, int64_t batch,
    int shuffle, uint64_t seed, int depth, int threads, float scale,
    int64_t start_step, int64_t shard_index, int64_t shard_count,
    int external_perms) {
  if (n <= 0 || batch <= 0 || batch > n || row_elems <= 0) return nullptr;
  if (n_spans < 1) return nullptr;
  if (shard_count < 1 || shard_index < 0 || shard_index >= shard_count ||
      batch % shard_count != 0) {
    return nullptr;
  }
  int64_t total = 0;
  for (int64_t i = 0; i < n_spans; ++i) {
    if (span_rows[i] <= 0 || xs[i] == nullptr) return nullptr;
    total += span_rows[i];
  }
  if (total != n) return nullptr;
  auto* p = new DtpuPipeline();
  p->xs.assign(xs, xs + n_spans);
  p->span_starts.resize((size_t)n_spans + 1);
  p->span_starts[0] = 0;
  for (int64_t i = 0; i < n_spans; ++i) {
    p->span_starts[(size_t)i + 1] = p->span_starts[(size_t)i] + span_rows[i];
  }
  p->y = y;
  p->n = n;
  p->row = row_elems;
  p->batch = batch;
  p->shard_index = shard_index;
  p->shard_count = shard_count;
  p->shard_rows = batch / shard_count;
  p->steps_per_pass = n / batch;
  p->shuffle = shuffle != 0;
  p->seed = seed;
  p->scale = scale;
  p->external_perms = external_perms != 0;
  p->depth = depth < 1 ? 1 : depth;
  // Resume support: start emitting at an arbitrary global step (O(1) seek —
  // step order depends only on (seed, pass, within), not on history).
  if (start_step < 0) start_step = 0;
  p->next_step.store(start_step);
  p->consumed.store(start_step);
  p->slots.resize((size_t)p->depth);
  int nthreads = threads < 1 ? 1 : threads;
  if (nthreads > p->depth) nthreads = p->depth;
  for (int i = 0; i < nthreads; ++i) {
    p->workers.emplace_back([p] { p->worker(); });
  }
  return p;
}

DtpuPipeline* dtpu_pipeline_create(const uint8_t* x, const int32_t* y,
                                   int64_t n, int64_t row_elems,
                                   int64_t batch, int shuffle, uint64_t seed,
                                   int depth, int threads, float scale,
                                   int64_t start_step, int64_t shard_index,
                                   int64_t shard_count) {
  const uint8_t* xs[1] = {x};
  const int64_t rows[1] = {n};
  return dtpu_pipeline_create_spans(xs, rows, 1, y, n, row_elems, batch,
                                    shuffle, seed, depth, threads, scale,
                                    start_step, shard_index, shard_count,
                                    /*external_perms=*/0);
}

// Hand the pipeline the permutation for one pass (n int64 row indices,
// copied). Only meaningful with external_perms; producers needing a pass
// not yet supplied block until it arrives.
void dtpu_pipeline_supply_perm(DtpuPipeline* p, int64_t pass,
                               const int64_t* perm) {
  if (!p || !perm) return;
  p->supply_perm(pass, perm);
}

// Copies the next batch (in deterministic step order) into caller buffers of
// shape [batch / shard_count, row_elems] float32 and [batch / shard_count]
// int32. Returns the 0-based step index, or -1 if the pipeline is stopped.
int64_t dtpu_pipeline_next(DtpuPipeline* p, float* x_out, int32_t* y_out) {
  Slot* slot;
  int64_t step;
  {
    std::unique_lock<std::mutex> lock(p->mu);
    step = p->consumed;
    slot = &p->slots[(size_t)(step % p->depth)];
    p->cv_consume.wait(lock, [&] {
      return p->stop || (slot->filled && slot->step == step);
    });
    if (p->stop) return -1;
  }
  std::memcpy(x_out, slot->x.data(),
              sizeof(float) * (size_t)(p->shard_rows * p->row));
  if (y_out) {
    std::memcpy(y_out, slot->y.data(),
                sizeof(int32_t) * (size_t)p->shard_rows);
  }
  {
    std::lock_guard<std::mutex> lock(p->mu);
    slot->filled = false;
    slot->step = -1;
    p->consumed = step + 1;
  }
  p->cv_produce.notify_all();
  return step;
}

int64_t dtpu_pipeline_steps_per_pass(DtpuPipeline* p) {
  return p->steps_per_pass;
}

void dtpu_pipeline_destroy(DtpuPipeline* p) {
  if (!p) return;
  {
    std::lock_guard<std::mutex> lock(p->mu);
    p->stop = true;
  }
  {
    // Unblock workers parked in perm_for waiting for an external pass.
    std::lock_guard<std::mutex> lock(p->perm_mu);
    p->perm_stop = true;
  }
  p->cv_produce.notify_all();
  p->cv_consume.notify_all();
  p->cv_perm.notify_all();
  for (std::thread& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
