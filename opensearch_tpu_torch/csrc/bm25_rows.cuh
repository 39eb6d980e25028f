// Row machinery shared by the fused BM25 top-k kernels (bm25_tfdl.cu,
// bm25_impact.cu, bm25_bool.cu, bm25_norms.cu), for Hopper (sm_90a).
//
// Semantics per kernel row q (one query, one doc-range chunk of one, or
// its impact-head form): slot t covers positions [skip, skip + len) of the
// window at element rowstart * 128 of its buffer, cut to [0, nrows * 128),
// [0, L) and the buffer's length; a posting there whose doc lies in
// [dlo, dhi) is valid. Each valid posting contributes `contrib(posting,
// w[q, t])` in f32, round-to-nearest, no fused multiply-add, and a count
// weight cw[q, t] (1 for every slot when the kernel has none). A doc's
// score and its count are the sums of its contributions and count weights
// in slot order t = 0..T-1; docs whose count reaches the row's msm (its
// threshold) pass; the row returns the exact count of passing docs and its
// top K by (score desc, doc asc), lanes K..127 as -inf / -1. The
// contribution is a functor: `Contrib::vals` is the payload word beside
// each doc id, `Contrib::row(q)` returns the row's evaluator, called as
// `r(payload word, weight)`.
//
// A row may carry a filter slot (bm25_bool.cu, list form): slot TS then
// reads its doc list from a separate buffer `filt` of its own length,
// contributes 0.0 and is never decoded, and the term weights are [QB, TS].
// Or it may probe the filter instead (bm25_bool.cu, probe form): the row
// has only its term slots, and a bitmap of the filter's docs (bit d & 31 of
// word d >> 5) with the filter's count weight cw_f stands for slot T, the
// last in slot order: a doc whose bit is set adds cw_f to its count and
// 0.0 to its score. That equals the list form for every doc with a term
// posting; docs of the filter alone never pass, so the two forms agree
// when cw_f is below the threshold, which the planner ensures.
//
// Fixed windows (bm25_norms.cu): a row's slot t may instead be the first
// lens[q, t] elements from element starts[q, t], cut to [0, L), with no
// doc range: a sentinel doc (INT_MAX) is no doc, as in the plain version.
//
// Design. The TPU kernels merge the T doc-sorted windows with a bitonic
// network over T*L <= 131072 elements held in VMEM; 227 KB of shared
// memory cannot hold that. Here a block walks one row's T windows with a
// cursor per slot, a tile of at most kTile postings at a time:
//  - Tile cut. Slot t has a budget B_t (kMinBudget plus its share of the
//    rest of kTile by its posting count; sum B_t <= kTile). The tile ends
//    at one doc: the least, over the slots with at least B_t postings
//    left, of the doc at cursor + B_t - 1. Each slot takes its postings up
//    to that doc: at most B_t, exactly B_t for the slot that set the cut,
//    so every tile advances, and every doc's postings from every slot fall
//    in one tile.
//  - Rings. Slot t keeps the B_t postings after its cursor (doc id and
//    payload word) in a ring of 2 B_t entries in shared memory (B_t even,
//    so every ring starts and ends at a multiple of 4 entries), filled by
//    cp.async from device memory: each valid posting is read from device
//    memory once. A posting's ring entry is congruent to its element
//    index mod 4, so a refill copies 16 bytes at a time over its aligned
//    interior and 4 bytes at its head and tail. The refill for the next
//    tile starts before this tile's merge and lands in ring entries the
//    merge does not read.
//  - Table tile. When the tile's docs span fewer than kSpan ids (dense
//    rows: a doc-range chunk of stopword-class terms), each doc has an
//    entry in a table in shared memory. The slots go in order, one block
//    pass each: a slot's postings (distinct docs) add their contribution
//    and count weight to their docs' entries with __fadd_rn, so each sum
//    is taken in slot order; the first slot to reach an entry is the
//    doc's leader, and its posting then reads the doc's sums.
//  - Merge tile. Otherwise the tile's postings, copied out slot after slot
//    as (doc, ring entry), are merged in log2(T) rounds of pairwise
//    merge-path merges (kItems outputs per thread, ties to the lower
//    slot), so each doc's postings end adjacent and in slot order, and
//    the first of a run, the leader, sums them in slot order. Either way
//    the filter slot adds 0.0 and is never decoded, and the sums are the
//    plain version's, bit for bit.
//  - Top K. A passing leader that beats the running K-th entry (by
//    `better`: score desc, doc asc) goes to a candidate buffer; when the
//    buffer reaches kCand, and at the row's end, a block-wide bitonic sort
//    of the running top K and the candidates keeps the best K and renews
//    the threshold. The exact count of passing docs is a warp-reduced
//    counter. Nothing goes through device-memory scratch.
//  - Split. A launch of few rows splits each row into S doc sub-ranges
//    (S a power of two, rows * S within the resident grid), cut at docs
//    of the row's longest slot, so no doc straddles two blocks. Each block
//    serves one (row, sub-range) with the steps above and writes a partial
//    top K and count to [QB, S, K] / [QB, S] buffers; the last block of a
//    row to arrive (a per-row counter) merges the S partials with the same
//    candidate buffer and writes the row. Totals add exactly; ties at the
//    K-th score across sub-ranges resolve by doc, as `better` does.
// A persistent grid of kBlocksPerSm blocks per SM takes the (row,
// sub-range) items in order from a counter, so rows of uneven length
// spread over the blocks. The counters are zero when a launch starts and
// the launch leaves them zero: a row's last block resets its arrival
// count, the last block to leave the grid the item counter, so the
// wrapper keeps one workspace per stream and sets nothing before a launch.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

namespace bm25rows {

constexpr int kLanes = 128;
constexpr int kMaxT = 16;        // 2 x 8 term slots with a filter slot
constexpr int kThreads = 256;
constexpr int kTile = 2048;      // postings merged per tile, all slots
constexpr int kItems = kTile / kThreads;
constexpr int kMinBudget = 16;   // least per-slot budget of a tile
constexpr int kCand = 256;       // candidates that trigger a top-K merge
constexpr int kCandCap = kCand + kThreads;
constexpr int kBlocksPerSm = 3;
constexpr int kSpan = 2048;      // widest doc span of a table tile
constexpr int kIntMax = 0x7fffffff;

struct Entry {
  float s;  // score (-inf = none)
  int d;    // doc id
};

// Merge-buffer index of element k: one pad entry after every kItems, so
// that a warp's threads, each at its own run of kItems outputs, hit
// distinct banks.
__device__ __forceinline__ int pad(int k) { return k + k / kItems; }
constexpr int kMergeEntries = kTile + kTile / kItems;

// rings (doc, payload) of 2 x kTile entries, two merge buffers of kTile
// (doc, ring entry) pairs (padded), the candidate buffer and the running
// top K
// a table tile (acc, count, leader per doc of kSpan) and the 1024-entry
// sort scratch fit in the two merge buffers
static_assert(3 * 4 * kSpan + 8 * 1024 <= 2 * 8 * kMergeEntries,
              "table tile does not fit the merge buffers");

constexpr size_t kSmemBytes = sizeof(int) * 4 * kTile +
                              sizeof(int2) * 2 * kMergeEntries +
                              sizeof(Entry) * (kCandCap + kLanes);

__device__ __forceinline__ bool better(float as, int ad, float bs, int bd) {
  return as > bs || (as == bs && ad < bd);
}

// first position in docs[0, n) with docs[i] >= key
__device__ __forceinline__ int lower_bound(const int* __restrict__ docs,
                                           int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(docs + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// dst and src 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Rows {
  const int* docs;
  long long P;
  const int* rowstarts;
  const int* nrows;
  const int* lens;
  const int* skips;
  const float* weights;  // [QB, T], or [QB, TS] with a filter slot
  const float* msm;      // [QB] minimum count weight to pass
  const int* dlo;
  const int* dhi;
  int QB, T, L, K;
  int split;             // S doc sub-ranges per row (a power of two)
  float* part_s;         // [QB, S, K] partial top K (S > 1 only)
  int* part_d;
  int* part_tot;         // [QB, S] partial counts
  int* counters;         // [QB + 2], zero at the start and at the end:
                         // blocks of each row done so far (S > 1), the
                         // next work item, blocks that left the grid
  float* out_s;          // [QB, 128]
  int* out_d;
  int* out_tot;
  // bm25_bool.cu only; the other kernels leave the defaults
  const float* cw = nullptr;  // [QB, T] count weights (null: 1 per slot);
                              // [QB, T + 1] with a probe, cw_f last
  const int* filt = nullptr;  // filter doc list read by slot TS (null: none)
  long long Pf = 0;
  int TS = 0;
  const int* fbits = nullptr;  // probe form: the filter's bitmap (null: none)
  long long nwords = 0;
  // bm25_norms.cu only: fixed windows at element starts [QB, T] (null:
  // rowstarts, nrows, skips, dlo and dhi name the windows)
  const int* starts = nullptr;
  bool vec = false;  // 16-byte copies: every buffer a slot reads is aligned
};

// per-slot cursors and the row's scalars, in static shared memory
struct State {
  const int* src[kMaxT];     // buffer the slot reads its docs from
  long long base[kMaxT];     // element of the slot's first valid posting
  int n[kMaxT];              // valid postings of the slot (this sub-range)
  int B[kMaxT];              // tile budget; the ring holds 2 B entries
  int rb[kMaxT];             // ring base entry
  int cur[kMaxT], cmod[kMaxT];  // consumed postings, and their ring offset
  int ld[kMaxT], lmod[kMaxT];   // loaded postings, and their ring offset
  int rf_from[kMaxT], rf_mod[kMaxT];  // next refill: first posting, ring
  int rf_h[kMaxT], rf_c[kMaxT];      // 4-byte head copies, 16-byte copies
  int rf_off[kMaxT + 1];     // slot offsets in the refill's copies
  int take[kMaxT], tmod[kMaxT];  // this tile's postings and ring offset
  int off[kMaxT + 1];        // slot offsets in the tile
  int dense, base_doc;       // table tile: its docs in [base_doc, + kSpan)
  float w[kMaxT], cw[kMaxT];
  float cwf;                 // the probed filter's count weight
  bool term[kMaxT];          // false for the filter slot
  Entry thr;                 // running K-th entry (none until K are kept)
  int item, more, total, ntop, ncand, last;
};

// Sort buf[0, n2) (n2 a power of two) best first by `better`.
__device__ __forceinline__ void bitonic_sort(Entry* buf, int n2, int tid) {
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < n2; i += kThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const Entry x = buf[i], y = buf[ixj];
          const bool best_first = (i & k) == 0;
          if (best_first ? better(y.s, y.d, x.s, x.d)
                         : better(x.s, x.d, y.s, y.d)) {
            buf[i] = y;
            buf[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Merge the candidate buffer into the running top K (block-wide; every
// thread calls it after a barrier). `buf` is scratch of >= 1024 entries.
__device__ __forceinline__ void merge_top(State& st, Entry* top, Entry* cand,
                                          Entry* buf, int K, int tid) {
  const int nt = st.ntop, nc = st.ncand;
  const int n = nt + nc;
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  const Entry none = {-CUDART_INF_F, kIntMax};
  for (int i = tid; i < n2; i += kThreads)
    buf[i] = i < nt ? top[i] : i < n ? cand[i - nt] : none;
  __syncthreads();
  bitonic_sort(buf, n2, tid);
  const int keep = min(n, K);
  for (int i = tid; i < keep; i += kThreads) top[i] = buf[i];
  if (tid == 0) {
    st.ntop = keep;
    st.ncand = 0;
    st.thr = keep == K ? buf[K - 1] : none;
  }
  __syncthreads();
}

// The copies of a refill of cnt postings from element g: h 4-byte copies
// up to a 16-byte boundary, c 16-byte copies, then 4-byte copies of the
// rest (all 4-byte without `vec`). Returns the number of copies.
__device__ __forceinline__ int refill_copies(long long g, int cnt, bool vec,
                                             int& h, int& c) {
  if (!vec) {
    h = cnt;
    c = 0;
    return cnt;
  }
  h = min(cnt, static_cast<int>((4 - (g & 3)) & 3));
  c = (cnt - h) >> 2;
  return cnt - 3 * c;
}

// Start the cp.async copies the refill plan names (slot t: positions from
// rf_from to ring offsets from rf_mod, as rf_h head copies and rf_c
// 16-byte copies, then single ones), the slots' copies laid end to end
// over the block's threads. A 16-byte copy starts at a ring entry that is
// a multiple of 4 (the entry is congruent to the element index mod 4) and
// never wraps (rings end at a multiple of 4).
__device__ __forceinline__ void start_refill(const State& st, int T,
                                             const int* __restrict__ vals,
                                             int* ring_doc, int* ring_val,
                                             int tid) {
  const int total = st.rf_off[T];
  int t = -1, end = 0, from = 0, cap = 0, m0 = 0, rb = 0, h = 0, c = 0;
  const int* sd = nullptr;
  const int* sv = nullptr;
  bool term = false;
  for (int i = tid; i < total; i += kThreads) {
    if (i >= end) {
      do ++t; while (i >= st.rf_off[t + 1]);
      from = st.rf_off[t];
      end = st.rf_off[t + 1];
      cap = 2 * st.B[t];
      m0 = st.rf_mod[t];
      rb = st.rb[t];
      h = st.rf_h[t];
      c = st.rf_c[t];
      const long long g = st.base[t] + st.rf_from[t];
      sd = st.src[t] + g;
      sv = vals + g;
      term = st.term[t];
    }
    const int u = i - from;
    const bool wide = u >= h && u < h + c;
    const int j = u < h ? u : wide ? h + 4 * (u - h) : u + 3 * c;
    int r = m0 + j;
    if (r >= cap) r -= cap;
    if (wide) {
      cp_async16(ring_doc + rb + r, sd + j);
      if (term) cp_async16(ring_val + rb + r, sv + j);
    } else {
      cp_async4(ring_doc + rb + r, sd + j);
      if (term) cp_async4(ring_val + rb + r, sv + j);
    }
  }
  cp_async_commit();
}

// The probe form's filter, as the last slot of a leader's sums: on a hit
// the count takes cw_f and the score adds 0.0 (a -0.0 sum becomes +0.0),
// as the list form's filter slot does. The bit is read only when it can
// decide whether the doc passes.
__device__ __forceinline__ void probe_filter(const int* __restrict__ bits,
                                             long long nwords, int d,
                                             float cwf, float msm,
                                             float& acc, float& cnt) {
  const float with = __fadd_rn(cnt, cwf);
  if (!(with >= msm) && !(cnt >= msm)) return;
  const long long wd = d >> 5;
  if (d >= 0 && wd < nwords && ((__ldg(bits + wd) >> (d & 31)) & 1)) {
    cnt = with;
    acc = __fadd_rn(acc, 0.0f);
  }
}

// Inclusive sum of v over lanes 0..lane of a full warp.
__device__ __forceinline__ int warp_scan(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Ring entry of the tile's i-th posting (the slots' takes end to end),
// and its slot in `t` (advanced from its last value: i only grows).
__device__ __forceinline__ int tile_entry(const State& st, int i, int& t) {
  while (i >= st.off[t + 1]) ++t;
  const int cap = 2 * st.B[t];
  int r = st.tmod[t] + (i - st.off[t]);
  if (r >= cap) r -= cap;
  return st.rb[t] + r;
}

template <class Contrib>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
rows_tile_kernel(const Rows a, const Contrib contrib) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* ring_doc = reinterpret_cast<int*>(smem);
  int* ring_val = ring_doc + 2 * kTile;
  int2* mb0 = reinterpret_cast<int2*>(ring_val + 2 * kTile);
  int2* mb1 = mb0 + kMergeEntries;
  Entry* cand = reinterpret_cast<Entry*>(mb1 + kMergeEntries);
  Entry* top = cand + kCandCap;
  // a table tile's per-doc sums share the merge buffers; the sort scratch
  // of the top-K merges (1024 entries) lies beyond the table
  float* tacc = reinterpret_cast<float*>(mb0);
  float* tcnt = tacc + kSpan;
  int* tlead = reinterpret_cast<int*>(tcnt + kSpan);
  Entry* tscratch = reinterpret_cast<Entry*>(tlead + kSpan);
  bool table_clean = false;  // every tlead is -1 (the same in every thread)
  __shared__ State st;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int T = a.T;
  const int S = a.split;
  const int K = a.K;
  const int fslot = a.filt != nullptr ? a.TS : -1;
  const int wT = a.filt != nullptr ? a.TS : T;  // weights per row
  const bool probe = a.fbits != nullptr;
  const int cwT = probe ? T + 1 : T;            // count weights per row
  const Entry none = {-CUDART_INF_F, kIntMax};
  const unsigned full = 0xffffffffu;
  const int* vals = contrib.vals;
  const int nwork = a.QB * S;

  for (;;) {
    if (tid == 0) st.item = atomicAdd(a.counters + a.QB, 1);
    __syncthreads();
    const int item = st.item;
    if (item >= nwork) break;
    const int q = item / S;
    const int sub = item - q * S;
    const float row_msm = a.msm[q];
    const auto eval = contrib.row(q);

    // ---- setup (warp 0, lane t = slot t): windows, [dlo, dhi), the
    // sub-range, budgets, rings, the first refill ----
    if (warp == 0) {
      const int t = lane;
      const bool on = t < T;
      const int* w = nullptr;
      long long win = 0;
      int lo = 0, e = 0;
      if (on) {
        const int i = q * T + t;
        const bool is_filter = t == fslot;
        const int* src = is_filter ? a.filt : a.docs;
        if (a.starts != nullptr) {
          // a fixed window: no skip and no doc range
          win = a.starts[i];
          const long long hi = min(min(static_cast<long long>(a.lens[i]),
                                       static_cast<long long>(a.L)),
                                   a.P - win);
          const int n = hi > 0 ? static_cast<int>(hi) : 0;
          w = src + win;
          e = (n == 0 || __ldg(w + n - 1) != kIntMax)
                  ? n
                  : lower_bound(w, n, kIntMax);
        } else {
          const long long start =
              static_cast<long long>(a.rowstarts[i]) * kLanes;
          const int sk = a.skips[i];
          long long hi = min(static_cast<long long>(sk) + a.lens[i],
                             static_cast<long long>(a.nrows[i]) * kLanes);
          hi = min(hi, static_cast<long long>(a.L));
          hi = min(hi, (is_filter ? a.Pf : a.P) - start);
          const int n = hi > sk ? static_cast<int>(hi - sk) : 0;
          // the window is doc-ascending: [dlo, dhi) is a contiguous
          // sub-range
          const int lo_doc = a.dlo[q];
          const int hi_doc = a.dhi[q];
          win = start + sk;
          w = src + win;
          lo = (n == 0 || __ldg(w) >= lo_doc) ? 0
                                               : lower_bound(w, n, lo_doc);
          e = (n == 0 || __ldg(w + n - 1) < hi_doc)
                  ? n
                  : lo + lower_bound(w + lo, n - lo, hi_doc);
        }
        st.src[t] = src;
        st.w[t] = t < wT ? a.weights[q * wT + t] : 0.0f;
        st.cw[t] = a.cw != nullptr ? a.cw[q * cwT + t] : 1.0f;
        st.term[t] = !is_filter;
      }
      if (S > 1) {
        // cut docs from the longest slot (the lowest such slot on a tie)
        const int key = on ? (e - lo) * 32 + (31 - t) : -1;
        const int kmax = __reduce_max_sync(full, key);
        const int m = 31 - (kmax & 31);
        const int n_long = kmax >> 5;
        int c_lo = 0, c_hi = 0;
        if (t == m && n_long > 0) {
          if (sub > 0)
            c_lo = __ldg(w + lo + static_cast<int>(
                static_cast<long long>(sub) * n_long / S));
          if (sub < S - 1)
            c_hi = __ldg(w + lo + static_cast<int>(
                static_cast<long long>(sub + 1) * n_long / S));
        }
        c_lo = __shfl_sync(full, c_lo, m);
        c_hi = __shfl_sync(full, c_hi, m);
        if (on && n_long > 0) {
          const int e2 = sub < S - 1 ? lo + lower_bound(w + lo, e - lo, c_hi)
                                     : e;
          const int lo2 = sub > 0 ? lo + lower_bound(w + lo, e - lo, c_lo)
                                  : lo;
          lo = lo2;
          e = e2;
        }
      }
      const int n = on ? e - lo : 0;
      const int tot = __reduce_add_sync(full, n);
      int B = 0;
      if (n > 0)
        B = (kMinBudget + static_cast<int>(
            static_cast<long long>(kTile - T * kMinBudget) * n / tot)) & ~1;
      // ring bases: exclusive scan of 2 B over the slots (multiples of 4)
      const int inc = warp_scan(2 * B, lane);
      const int first = min(B, n);
      const long long base = win + lo;
      // the first posting's ring entry: its element index mod 4
      const int s0 = n > 0 ? static_cast<int>(base & 3) : 0;
      int h = 0, c = 0;
      const int copies = refill_copies(base, first, a.vec, h, c);
      const int rf = warp_scan(copies, lane);
      if (on) {
        st.rf_off[t] = rf - copies;
        st.base[t] = base;
        st.n[t] = n;
        st.B[t] = B;
        st.rb[t] = inc - 2 * B;
        st.cur[t] = 0;
        st.cmod[t] = s0;
        st.ld[t] = first;
        st.lmod[t] = s0 + first;
        st.rf_from[t] = 0;
        st.rf_mod[t] = s0;
        st.rf_h[t] = h;
        st.rf_c[t] = c;
      }
      const int rf_total = __shfl_sync(full, rf, 31);
      if (lane == 0) {
        st.rf_off[T] = rf_total;
        st.cwf = probe ? a.cw[q * cwT + T] : 0.0f;
        st.more = tot > 0;
        st.total = 0;
        st.ntop = 0;
        st.ncand = 0;
        st.thr = none;
      }
    }
    __syncthreads();
    start_refill(st, T, vals, ring_doc, ring_val, tid);

    int passed = 0;
    while (st.more) {
      cp_async_wait_all();
      __syncthreads();

      // ---- tile cut, takes, offsets, table or merge, and the next
      // refill (warp 0) ----
      if (warp == 0) {
        const int t = lane;
        const bool on = t < T;
        const int n = on ? st.n[t] : 0;
        const int B = on ? st.B[t] : 0;
        const int cap = 2 * B;
        const int rb = on ? st.rb[t] : 0;
        const int cur = on ? st.cur[t] : 0;
        const int cmod = on ? st.cmod[t] : 0;
        const int ld = on ? st.ld[t] : 0;
        const int lmod = on ? st.lmod[t] : 0;
        int mine = kIntMax;
        if (on && B > 0 && n - cur >= B) {
          int r = cmod + B - 1;
          if (r >= cap) r -= cap;
          mine = ring_doc[rb + r];
        }
        const int cut = __reduce_min_sync(full, mine);
        // every doc <= cut that a slot holds is in its ring: take them
        int lo = 0, hi = ld - cur;
        if (cut == kIntMax) {
          lo = hi;
        } else {
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            int r = cmod + mid;
            if (r >= cap) r -= cap;
            if (ring_doc[rb + r] <= cut) lo = mid + 1; else hi = mid;
          }
        }
        const int take = lo;
        // the tile's doc span: a table tile when it fits kSpan
        int last = cmod + take - 1;
        if (last >= cap) last -= cap;
        const int dmin = __reduce_min_sync(
            full, take > 0 ? ring_doc[rb + cmod] : kIntMax);
        const int dmax = __reduce_max_sync(
            full, take > 0 ? ring_doc[rb + last] : -1);
        const int inc = warp_scan(take, lane);
        const int m = __shfl_sync(full, inc, 31);
        const int ncur = cur + take;
        const int to = min(ncur + B, n);
        const int cnt = to - ld;
        int h = 0, c = 0;
        const int copies =
            refill_copies(on ? st.base[t] + ld : 0, cnt, a.vec, h, c);
        const int rf = warp_scan(copies, lane);
        const int rf_total = __shfl_sync(full, rf, 31);
        const int left = __reduce_add_sync(full, n - ncur);
        if (on) {
          int nc = cmod + take;
          if (nc >= cap) nc -= cap;
          int nl = lmod + cnt;
          if (nl >= cap) nl -= cap;
          st.off[t] = inc - take;
          st.take[t] = take;
          st.tmod[t] = cmod;
          st.cur[t] = ncur;
          st.cmod[t] = nc;
          st.rf_from[t] = ld;
          st.rf_mod[t] = lmod;
          st.rf_h[t] = h;
          st.rf_c[t] = c;
          st.rf_off[t] = rf - copies;
          st.ld[t] = to;
          st.lmod[t] = nl;
        }
        if (lane == 0) {
          st.off[T] = m;
          st.rf_off[T] = rf_total;
          st.more = left > 0;
          st.dense = static_cast<long long>(dmax) - dmin < kSpan;
          st.base_doc = dmin;
        }
      }
      __syncthreads();
      const int m = st.off[T];
      const bool dense = st.dense;

      // ---- the next refill, and (merge tiles) this tile out of the
      // rings ----
      start_refill(st, T, vals, ring_doc, ring_val, tid);
      if (!dense) {
        int t = 0;
        for (int i = tid; i < m; i += kThreads) {
          const int r = tile_entry(st, i, t);
          mb0[pad(i)] = make_int2(ring_doc[r], (t << 16) | r);
        }
        table_clean = false;
      } else if (!table_clean) {
        for (int i = tid; i < kSpan; i += kThreads) tlead[i] = -1;
        table_clean = true;
      }
      __syncthreads();

      if (dense) {
        // ---- table tile: slot after slot, each doc's sums in slot
        // order at its table entry; the lowest slot holding the doc
        // leads ----
        const int base_doc = st.base_doc;
        for (int t = 0; t < T; ++t) {
          const int take = st.take[t];
          if (take == 0) continue;
          const int cap = 2 * st.B[t];
          const int m0 = st.tmod[t];
          const int rb = st.rb[t];
          const bool term = st.term[t];
          const float w = st.w[t];
          const float cwt = st.cw[t];
          for (int j = tid; j < take; j += kThreads) {
            int r = m0 + j;
            if (r >= cap) r -= cap;
            const int x = ring_doc[rb + r] - base_doc;
            const float c = term ? eval(ring_val[rb + r], w) : 0.0f;
            if (tlead[x] < 0) {
              tlead[x] = t;
              tacc[x] = c;
              tcnt[x] = cwt;
            } else {
              tacc[x] = __fadd_rn(tacc[x], c);
              tcnt[x] = __fadd_rn(tcnt[x], cwt);
            }
          }
          __syncthreads();
        }
        int t = 0;
        for (int base = 0; base < m; base += kThreads) {
          const int i = base + tid;
          bool full_now = false;
          if (i < m) {
            const int d = ring_doc[tile_entry(st, i, t)];
            const int x = d - base_doc;
            if (tlead[x] == t) {
              float acc = tacc[x], cnt = tcnt[x];
              if (probe)
                probe_filter(a.fbits, a.nwords, d, st.cwf, row_msm, acc, cnt);
              if (cnt >= row_msm) {
                ++passed;
                if (better(acc, d, st.thr.s, st.thr.d)) {
                  const int k = atomicAdd(&st.ncand, 1);
                  cand[k] = Entry{acc, d};
                  full_now = k + 1 >= kCand;
                }
              }
            }
          }
          if (__syncthreads_or(full_now))
            merge_top(st, top, cand, tscratch, K, tid);
        }
        t = 0;
        for (int i = tid; i < m; i += kThreads)
          tlead[ring_doc[tile_entry(st, i, t)] - base_doc] = -1;
        continue;
      }

      // ---- merge tile: pairs of slot groups, merge path, ties to the
      // lower slot group ----
      int2* X = mb0;
      int2* Y = mb1;
      for (int gw = 1; gw < T; gw <<= 1) {
        int k = tid * kItems;
        const int k1 = min(k + kItems, m);
        while (k < k1) {
          int g = 0;
          while (st.off[(g + 1) * 2 * gw] <= k) ++g;
          const int a0 = st.off[g * 2 * gw];
          const int a1 = st.off[g * 2 * gw + gw];
          const int a2 = st.off[(g + 1) * 2 * gw];
          const int na = a1 - a0, nb = a2 - a1;
          const int d = k - a0;
          int lo = max(0, d - nb), hi = min(d, na);
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (X[pad(a0 + mid)].x <= X[pad(a1 + d - 1 - mid)].x) lo = mid + 1;
            else hi = mid;
          }
          int i = lo, j = d - lo;
          int2 va = i < na ? X[pad(a0 + i)] : make_int2(0, 0);
          int2 vb = j < nb ? X[pad(a1 + j)] : make_int2(0, 0);
          const int kend = min(k1, a2);
          for (; k < kend; ++k) {
            if (j >= nb || (i < na && va.x <= vb.x)) {
              Y[pad(k)] = va;
              if (++i < na) va = X[pad(a0 + i)];
            } else {
              Y[pad(k)] = vb;
              if (++j < nb) vb = X[pad(a1 + j)];
            }
          }
        }
        __syncthreads();
        int2* sw = X;
        X = Y;
        Y = sw;
      }
      const int2* F = X;
      Entry* spare = reinterpret_cast<Entry*>(Y);

      // ---- leaders: the first of each doc's run sums it in slot order ----
      for (int base = 0; base < m; base += kThreads) {
        const int i = base + tid;
        bool full_now = false;
        if (i < m) {
          const int2 e = F[pad(i)];
          if (i == 0 || F[pad(i - 1)].x != e.x) {
            int t = e.y >> 16;
            float acc = st.term[t] ? eval(ring_val[e.y & 0xffff], st.w[t])
                                   : 0.0f;
            float cnt = st.cw[t];
            for (int j = i + 1; j < m; ++j) {
              const int2 f = F[pad(j)];
              if (f.x != e.x) break;
              t = f.y >> 16;
              acc = __fadd_rn(acc, st.term[t]
                                       ? eval(ring_val[f.y & 0xffff], st.w[t])
                                       : 0.0f);
              cnt = __fadd_rn(cnt, st.cw[t]);
            }
            if (probe)
              probe_filter(a.fbits, a.nwords, e.x, st.cwf, row_msm, acc, cnt);
            if (cnt >= row_msm) {
              ++passed;
              if (better(acc, e.x, st.thr.s, st.thr.d)) {
                const int k = atomicAdd(&st.ncand, 1);
                cand[k] = Entry{acc, e.x};
                full_now = k + 1 >= kCand;
              }
            }
          }
        }
        if (__syncthreads_or(full_now))
          merge_top(st, top, cand, spare, K, tid);
      }
    }
    cp_async_wait_all();

    // ---- the row's (or sub-range's) count and top K ----
    for (int off = 16; off > 0; off >>= 1)
      passed += __shfl_xor_sync(full, passed, off);
    if (lane == 0 && passed) atomicAdd(&st.total, passed);
    __syncthreads();
    Entry* scratch = tscratch;
    if (st.ncand > 0) merge_top(st, top, cand, scratch, K, tid);
    bool write = true;
    if (S > 1) {
      const long long p = static_cast<long long>(q) * S + sub;
      for (int i = tid; i < K; i += kThreads) {
        const Entry x = i < st.ntop ? top[i] : none;
        a.part_s[p * K + i] = x.s;
        a.part_d[p * K + i] = x.d;
      }
      if (tid == 0) a.part_tot[p] = st.total;
      __threadfence();
      __syncthreads();
      if (tid == 0) st.last = atomicAdd(a.counters + q, 1) == S - 1;
      __syncthreads();
      write = st.last;
      if (write) {
        // the last block of the row merges the S partials, and resets
        // the row's arrival count for the next launch
        __threadfence();
        if (tid == 0) {
          a.counters[q] = 0;
          int total = 0;
          for (int s = 0; s < S; ++s)
            total += __ldcg(a.part_tot + static_cast<long long>(q) * S + s);
          st.total = total;
          st.ntop = 0;
          st.ncand = 0;
          st.thr = none;
        }
        __syncthreads();
        const long long p0 = static_cast<long long>(q) * S * K;
        for (int base = 0; base < S * K; base += kThreads) {
          const int f = base + tid;
          bool full_now = false;
          if (f < S * K) {
            const float s = __ldcg(a.part_s + p0 + f);
            const int d = __ldcg(a.part_d + p0 + f);
            if (s > -CUDART_INF_F && better(s, d, st.thr.s, st.thr.d)) {
              const int k = atomicAdd(&st.ncand, 1);
              cand[k] = Entry{s, d};
              full_now = k + 1 >= kCand;
            }
          }
          if (__syncthreads_or(full_now))
            merge_top(st, top, cand, scratch, K, tid);
        }
        if (st.ncand > 0) merge_top(st, top, cand, scratch, K, tid);
      }
    }
    if (write && tid < kLanes) {
      const bool have = tid < st.ntop;
      a.out_s[q * kLanes + tid] = have ? top[tid].s : -CUDART_INF_F;
      a.out_d[q * kLanes + tid] = have ? top[tid].d : -1;
      a.out_tot[q * kLanes + tid] = st.total;
    }
    __syncthreads();
  }
  // every block has taken its last item: the last one to leave resets
  // the item counter for the next launch
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(a.counters + a.QB + 1, 1) ==
        static_cast<int>(gridDim.x) - 1) {
      a.counters[a.QB] = 0;
      a.counters[a.QB + 1] = 0;
    }
  }
}

// Devices whose kernel of this library may use kSmemBytes (bit d). Each
// library is one translation unit, and the flag has internal linkage: a
// static inside the template would be one object for every library that
// instantiates the same Contrib (B1 and B3), while each library registers
// its own kernel.
namespace {
std::atomic<unsigned> smem_allowed{0};
}  // namespace

// Dynamic shared memory above 48 KB must be allowed before a launch or an
// occupancy query: once per device.
template <class Contrib>
cudaError_t allow_smem() {
  std::atomic<unsigned>& done = smem_allowed;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit != 0 && (done.load() & bit) != 0) return cudaSuccess;
  err = cudaFuncSetAttribute(rows_tile_kernel<Contrib>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <class Contrib>
int launch_rows(Rows a, const Contrib& contrib, int grid, void* stream) {
  cudaError_t err = allow_smem<Contrib>();
  if (err != cudaSuccess) return static_cast<int>(err);
  a.vec = aligned16(a.docs) && aligned16(contrib.vals) &&
          (a.filt == nullptr || aligned16(a.filt));
  rows_tile_kernel<Contrib><<<grid, kThreads, kSmemBytes,
                              static_cast<cudaStream_t>(stream)>>>(a, contrib);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks (SMs x blocks per SM) and the dynamic shared memory of
// one block.
template <class Contrib>
int resident_blocks(int* out, int* smem_bytes) {
  int dev = 0, sms = 0, per_sm = 0;
  *smem_bytes = static_cast<int>(kSmemBytes);
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = allow_smem<Contrib>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rows_tile_kernel<Contrib>, kThreads, kSmemBytes);
  *out = sms * per_sm;
  return static_cast<int>(err);
}

}  // namespace bm25rows
