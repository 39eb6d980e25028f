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
// contribution is a functor: `Contrib::row(q)` returns the row's
// evaluator, called as `r(element, weight)`.
//
// A row may carry a filter slot (bm25_bool.cu): slot TS then reads its doc
// list from a separate buffer `filt` of its own length, contributes 0.0
// and is never decoded, and the term weights are [QB, TS].
//
// Design. The TPU kernels merge the T doc-sorted windows with a bitonic
// network over T*L <= 131072 elements (about 1 MB) held in VMEM; 227 KB
// of shared memory cannot hold that, and nothing here needs it to. One
// thread block serves one row at a time (a persistent grid walks the
// rows). Each valid posting, in parallel, binary-searches its doc in the
// other slots' windows (each window is doc-ascending): the posting in the
// lowest slot that holds the doc is its leader, and only the leader sums
// the doc's contributions and count weights in slot order. Leaders write
// their score (or -inf below the threshold) to a per-block scratch list;
// every other posting writes -inf. The top K are then K rounds of a
// block-wide argmax: each warp keeps the best of the candidates it owns,
// one warp reduces the warp bests, and after each pick only the warp that
// owned the pick rescans its share. The binary searches re-read postings
// that the L1/L2 caches mostly hold; a merge-path pass that reads each
// posting once is the first thing a faster version replaces them with.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace bm25rows {

constexpr int kLanes = 128;
constexpr int kMaxT = 16;   // 2 x 8 term slots with a filter slot
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kIntMax = 0x7fffffff;

struct Cand {
  float s;  // score (-inf = none)
  int d;    // doc id
  int j;    // index in the block's candidate list (-1 = none)
};

__device__ __forceinline__ bool better(const Cand& a, const Cand& b) {
  return a.s > b.s || (a.s == b.s && a.d < b.d);
}

__device__ __forceinline__ Cand warp_best(Cand c) {
  for (int off = 16; off > 0; off >>= 1) {
    Cand o;
    o.s = __shfl_xor_sync(0xffffffffu, c.s, off);
    o.d = __shfl_xor_sync(0xffffffffu, c.d, off);
    o.j = __shfl_xor_sync(0xffffffffu, c.j, off);
    if (better(o, c)) c = o;
  }
  return c;
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
  float* cand_s_all;  // [grid, T*L] per-block scratch
  int* cand_d_all;
  float* out_s;       // [QB, 128]
  int* out_d;
  int* out_tot;
  // bm25_bool.cu only; the other kernels leave the defaults
  const float* cw = nullptr;  // [QB, T] count weights (null: 1 per slot)
  const int* filt = nullptr;  // filter doc list read by slot TS (null: none)
  long long Pf = 0;
  int TS = 0;
};

template <class Contrib>
__global__ void __launch_bounds__(kThreads)
rows_topk_kernel(const Rows a, const Contrib contrib) {
  __shared__ long long s_base[kMaxT];  // element of a slot's first valid posting
  __shared__ const int* s_src[kMaxT];  // the buffer the slot reads its docs from
  __shared__ int s_n[kMaxT];           // valid postings in the slot
  __shared__ int s_off[kMaxT + 1];     // slot offsets in the candidate list
  __shared__ float s_w[kMaxT];
  __shared__ float s_cw[kMaxT];
  __shared__ bool s_term[kMaxT];       // false for the filter slot
  __shared__ Cand s_warp[kWarps];
  __shared__ int s_total;
  __shared__ int s_owner;               // warp that owned the last pick

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int T = a.T;
  const int fslot = a.filt != nullptr ? a.TS : -1;
  const int wT = a.filt != nullptr ? a.TS : T;  // weights per row
  const long long stride = static_cast<long long>(T) * a.L;
  float* cand_s = a.cand_s_all + blockIdx.x * stride;
  int* cand_d = a.cand_d_all + blockIdx.x * stride;
  const Cand none = {-CUDART_INF_F, kIntMax, -1};

  for (int q = blockIdx.x; q < a.QB; q += gridDim.x) {
    const int lo_doc = a.dlo[q];
    const int hi_doc = a.dhi[q];
    const float row_msm = a.msm[q];
    const auto eval = contrib.row(q);
    if (tid < T) {
      const int i = q * T + tid;
      const bool is_filter = tid == fslot;
      const int* src = is_filter ? a.filt : a.docs;
      const long long start = static_cast<long long>(a.rowstarts[i]) * kLanes;
      const int sk = a.skips[i];
      long long hi = min(static_cast<long long>(sk) + a.lens[i],
                         static_cast<long long>(a.nrows[i]) * kLanes);
      hi = min(hi, static_cast<long long>(a.L));
      hi = min(hi, (is_filter ? a.Pf : a.P) - start);
      const int n = hi > sk ? static_cast<int>(hi - sk) : 0;
      // the window is doc-ascending: [dlo, dhi) is a contiguous sub-range
      const int* w = src + start + sk;
      const int lo = lower_bound(w, n, lo_doc);
      const int e = lo + lower_bound(w + lo, n - lo, hi_doc);
      s_base[tid] = start + sk + lo;
      s_src[tid] = src;
      s_n[tid] = e - lo;
      s_w[tid] = tid < wT ? a.weights[q * wT + tid] : 0.0f;
      s_cw[tid] = a.cw != nullptr ? a.cw[i] : 1.0f;
      s_term[tid] = !is_filter;
    }
    if (tid < kLanes) {
      a.out_s[q * kLanes + tid] = -CUDART_INF_F;
      a.out_d[q * kLanes + tid] = -1;
    }
    if (tid == 0) s_total = 0;
    __syncthreads();
    if (tid == 0) {
      s_off[0] = 0;
      for (int t = 0; t < T; ++t) s_off[t + 1] = s_off[t] + s_n[t];
    }
    __syncthreads();
    const int n_all = s_off[T];

    // ---- leaders: one per doc, summing its postings in slot order ----
    int passed = 0;
    Cand best = none;
    for (int j = tid; j < n_all; j += kThreads) {
      int t = 0;
      while (j >= s_off[t + 1]) ++t;
      const long long at = s_base[t] + (j - s_off[t]);
      const int d = __ldg(s_src[t] + at);
      bool leader = true;
      for (int u = 0; u < t && leader; ++u) {
        const int* wu = s_src[u] + s_base[u];
        const int pu = lower_bound(wu, s_n[u], d);
        leader = !(pu < s_n[u] && __ldg(wu + pu) == d);
      }
      float score = -CUDART_INF_F;
      if (leader) {
        // the filter slot adds 0.0 and its buffer holds no payload
        float acc = s_term[t] ? eval(at, s_w[t]) : 0.0f;
        float cnt = s_cw[t];
        for (int u = t + 1; u < T; ++u) {
          const int* wu = s_src[u] + s_base[u];
          const int pu = lower_bound(wu, s_n[u], d);
          if (pu < s_n[u] && __ldg(wu + pu) == d) {
            acc = __fadd_rn(acc,
                            s_term[u] ? eval(s_base[u] + pu, s_w[u]) : 0.0f);
            cnt = __fadd_rn(cnt, s_cw[u]);
          }
        }
        if (cnt >= row_msm) {
          score = acc;
          ++passed;
        }
      }
      cand_s[j] = score;
      cand_d[j] = d;
      const Cand c = {score, d, j};
      if (better(c, best)) best = c;
    }
    for (int off = 16; off > 0; off >>= 1)
      passed += __shfl_xor_sync(0xffffffffu, passed, off);
    if (lane == 0) atomicAdd(&s_total, passed);
    best = warp_best(best);
    if (lane == 0) s_warp[warp] = best;
    __syncthreads();
    if (tid < kLanes) a.out_tot[q * kLanes + tid] = s_total;

    // ---- top K: block argmax rounds over the warps' own bests ----
    for (int r = 0; r < a.K; ++r) {
      if (warp == 0) {
        Cand c = lane < kWarps ? s_warp[lane] : none;
        c = warp_best(c);
        if (lane == 0) {
          if (c.j >= 0 && c.s > -CUDART_INF_F) {
            a.out_s[q * kLanes + r] = c.s;
            a.out_d[q * kLanes + r] = c.d;
            cand_s[c.j] = -CUDART_INF_F;
            s_owner = (c.j >> 5) % kWarps;
          } else {
            s_owner = -1;
          }
        }
      }
      __syncthreads();
      const int owner = s_owner;
      if (owner < 0) break;
      if (warp == owner) {
        Cand c = none;
        for (int j = tid; j < n_all; j += kThreads) {
          const Cand o = {cand_s[j], cand_d[j], j};
          if (better(o, c)) c = o;
        }
        c = warp_best(c);
        if (lane == 0) s_warp[warp] = c;
      }
      __syncthreads();
    }
    __syncthreads();
  }
}

template <class Contrib>
int launch_rows(const Rows& a, const Contrib& contrib, int grid,
                void* stream) {
  rows_topk_kernel<Contrib><<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(a, contrib);
  return static_cast<int>(cudaGetLastError());
}

template <class Contrib>
int resident_blocks(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rows_topk_kernel<Contrib>, kThreads, 0);
  *out = sms * per_sm;
  return static_cast<int>(err);
}

}  // namespace bm25rows
