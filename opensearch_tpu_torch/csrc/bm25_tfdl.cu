// Fused BM25 top-k over packed (tf, dl) postings, for Hopper (sm_90a).
//
// Replaces opensearch_tpu/ops/pallas_bm25.py::_bm25_tfdl_kernel (the TPU
// kernel behind fused_bm25_topk_tfdl). Semantics per kernel row q (one
// query, or one doc-range chunk of one): slot t covers positions
// [skip, skip + len) of the window at element rowstart * 128, cut to
// [0, nrows * 128) and [0, L); a posting there whose doc lies in
// [dlo, dhi) is valid. Each valid posting contributes
//     k = k1 * ((1 - b) + (b * dl) / avgdl);  c = (w * tf) / (tf + k)
// in f32, round-to-nearest, no fused multiply-add. A doc's score is the
// sum of its contributions in slot order t = 0..T-1; docs matching at
// least msm slots pass; the row returns the exact count of passing docs
// and its top K by (score desc, doc asc), lanes K..127 as -inf / -1.
//
// Bound: memory. A row reads 8 B per valid posting (doc + packed tf.dl)
// and writes 12 B x 128 of output, and does a handful of flops per
// posting, far below the card's 295 flop/byte balance point.
//
// Design. The TPU kernel merges the T doc-sorted windows with a bitonic
// network over T*L <= 131072 elements (about 1 MB) held in VMEM; 227 KB
// of shared memory cannot hold that, and nothing here needs it to. One
// thread block serves one row at a time (a persistent grid walks the
// rows). Each valid posting, in parallel, binary-searches its doc in the
// other slots' windows (each window is doc-ascending): the posting in the
// lowest slot that holds the doc is its leader, and only the leader sums
// the doc's contributions in slot order and counts them. Leaders write
// their score (or -inf below msm) to a per-block scratch list; every
// other posting writes -inf. The top K are then K rounds of a block-wide
// argmax: each warp keeps the best of the candidates it owns, one warp
// reduces the warp bests, and after each pick only the warp that owned the
// pick rescans its share. The binary searches re-read postings that the
// L1/L2 caches mostly hold; a merge-path pass that reads each posting
// once is the first thing a faster version replaces them with.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kDlBits = 21;
constexpr int kDlMask = (1 << kDlBits) - 1;
constexpr int kTfMax = 2047;
constexpr int kMaxT = 8;
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

__device__ __forceinline__ float contrib(int p, float w, float k1, float b,
                                         float omb, float avgdl) {
  // arithmetic shift, then mask: tf >= 1024 sets the sign bit
  const float tf = static_cast<float>((p >> kDlBits) & kTfMax);
  const float dl = static_cast<float>(p & kDlMask);
  const float k =
      __fmul_rn(k1, __fadd_rn(omb, __fdiv_rn(__fmul_rn(b, dl), avgdl)));
  return __fdiv_rn(__fmul_rn(w, tf), __fadd_rn(tf, k));
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

__global__ void __launch_bounds__(kThreads)
bm25_tfdl_kernel(const int* __restrict__ docs, const int* __restrict__ tfdl,
                 long long P, const int* __restrict__ rowstarts,
                 const int* __restrict__ nrows, const int* __restrict__ lens,
                 const int* __restrict__ skips,
                 const float* __restrict__ weights,
                 const float* __restrict__ msm,
                 const float* __restrict__ avgdl,
                 const int* __restrict__ dlo, const int* __restrict__ dhi,
                 int QB, int T, int L, int K, float k1, float b, float omb,
                 float* __restrict__ cand_s_all, int* __restrict__ cand_d_all,
                 float* __restrict__ out_s, int* __restrict__ out_d,
                 int* __restrict__ out_tot) {
  __shared__ long long s_base[kMaxT];  // element of a slot's first valid posting
  __shared__ int s_n[kMaxT];           // valid postings in the slot
  __shared__ int s_off[kMaxT + 1];     // slot offsets in the candidate list
  __shared__ float s_w[kMaxT];
  __shared__ Cand s_warp[kWarps];
  __shared__ int s_total;
  __shared__ int s_owner;               // warp that owned the last pick

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long stride = static_cast<long long>(T) * L;
  float* cand_s = cand_s_all + blockIdx.x * stride;
  int* cand_d = cand_d_all + blockIdx.x * stride;
  const Cand none = {-CUDART_INF_F, kIntMax, -1};

  for (int q = blockIdx.x; q < QB; q += gridDim.x) {
    const int lo_doc = dlo[q];
    const int hi_doc = dhi[q];
    const float row_msm = msm[q];
    const float row_avgdl = avgdl[q];
    if (tid < T) {
      const int i = q * T + tid;
      const long long start = static_cast<long long>(rowstarts[i]) * kLanes;
      const int sk = skips[i];
      long long hi = min(static_cast<long long>(sk) + lens[i],
                         static_cast<long long>(nrows[i]) * kLanes);
      hi = min(hi, static_cast<long long>(L));
      hi = min(hi, P - start);
      const int n = hi > sk ? static_cast<int>(hi - sk) : 0;
      // the window is doc-ascending: [dlo, dhi) is a contiguous sub-range
      const int* w = docs + start + sk;
      const int a = lower_bound(w, n, lo_doc);
      const int e = a + lower_bound(w + a, n - a, hi_doc);
      s_base[tid] = start + sk + a;
      s_n[tid] = e - a;
      s_w[tid] = weights[i];
    }
    if (tid < kLanes) {
      out_s[q * kLanes + tid] = -CUDART_INF_F;
      out_d[q * kLanes + tid] = -1;
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
      const int d = __ldg(docs + at);
      bool leader = true;
      for (int u = 0; u < t && leader; ++u) {
        const int* wu = docs + s_base[u];
        const int pu = lower_bound(wu, s_n[u], d);
        leader = !(pu < s_n[u] && __ldg(wu + pu) == d);
      }
      float score = -CUDART_INF_F;
      if (leader) {
        float acc = contrib(__ldg(tfdl + at), s_w[t], k1, b, omb, row_avgdl);
        int cnt = 1;
        for (int u = t + 1; u < T; ++u) {
          const int* wu = docs + s_base[u];
          const int pu = lower_bound(wu, s_n[u], d);
          if (pu < s_n[u] && __ldg(wu + pu) == d) {
            acc = __fadd_rn(acc, contrib(__ldg(tfdl + s_base[u] + pu), s_w[u],
                                         k1, b, omb, row_avgdl));
            ++cnt;
          }
        }
        if (static_cast<float>(cnt) >= row_msm) {
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
    if (tid < kLanes) out_tot[q * kLanes + tid] = s_total;

    // ---- top K: block argmax rounds over the warps' own bests ----
    for (int r = 0; r < K; ++r) {
      if (warp == 0) {
        Cand c = lane < kWarps ? s_warp[lane] : none;
        c = warp_best(c);
        if (lane == 0) {
          if (c.j >= 0 && c.s > -CUDART_INF_F) {
            out_s[q * kLanes + r] = c.s;
            out_d[q * kLanes + r] = c.d;
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

}  // namespace

extern "C" {

int bm25_tfdl_launch(const int* docs, const int* tfdl, long long P,
                     const int* rowstarts, const int* nrows, const int* lens,
                     const int* skips, const float* weights, const float* msm,
                     const float* avgdl, const int* dlo, const int* dhi,
                     int QB, int T, int L, int K, float k1, float b,
                     float omb, float* cand_s, int* cand_d, int grid,
                     float* out_s, int* out_d, int* out_tot, void* stream) {
  bm25_tfdl_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      docs, tfdl, P, rowstarts, nrows, lens, skips, weights, msm, avgdl, dlo,
      dhi, QB, T, L, K, k1, b, omb, cand_s, cand_d, out_s, out_d, out_tot);
  return static_cast<int>(cudaGetLastError());
}

int bm25_tfdl_resident_blocks(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bm25_tfdl_kernel, kThreads, 0);
  *out = sms * per_sm;
  return static_cast<int>(err);
}

const char* bm25_tfdl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
