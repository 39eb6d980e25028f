// Fused BM25 top-k over packed (tf, dl) postings, for Hopper (sm_90a).
//
// Replaces opensearch_tpu/ops/pallas_bm25.py::_bm25_tfdl_kernel (the TPU
// kernel behind fused_bm25_topk_tfdl). The row semantics and the design
// (per-posting leader search, slot-order sums, persistent grid, K rounds of
// block argmax) are in bm25_rows.cuh; this file supplies the contribution
// of one valid posting:
//     k = k1 * ((1 - b) + (b * dl) / avgdl);  c = (w * tf) / (tf + k)
// in f32, round-to-nearest, no fused multiply-add, with avgdl per row.
//
// Bound: memory. A row reads 8 B per valid posting (doc + packed tf.dl)
// and writes 12 B x 128 of output, and does a handful of flops per
// posting, far below the card's 295 flop/byte balance point.

#include "bm25_rows.cuh"

namespace {

constexpr int kDlBits = 21;
constexpr int kDlMask = (1 << kDlBits) - 1;
constexpr int kTfMax = 2047;

struct TfdlContrib {
  const int* tfdl;
  const float* avgdl;
  float k1, b, omb;

  struct Row {
    const int* tfdl;
    float k1, b, omb, avgdl;
    __device__ __forceinline__ float operator()(long long at, float w) const {
      const int p = __ldg(tfdl + at);
      // arithmetic shift, then mask: tf >= 1024 sets the sign bit
      const float tf = static_cast<float>((p >> kDlBits) & kTfMax);
      const float dl = static_cast<float>(p & kDlMask);
      const float k =
          __fmul_rn(k1, __fadd_rn(omb, __fdiv_rn(__fmul_rn(b, dl), avgdl)));
      return __fdiv_rn(__fmul_rn(w, tf), __fadd_rn(tf, k));
    }
  };

  __device__ __forceinline__ Row row(int q) const {
    return Row{tfdl, k1, b, omb, avgdl[q]};
  }
};

}  // namespace

extern "C" {

int bm25_tfdl_launch(const int* docs, const int* tfdl, long long P,
                     const int* rowstarts, const int* nrows, const int* lens,
                     const int* skips, const float* weights, const float* msm,
                     const float* avgdl, const int* dlo, const int* dhi,
                     int QB, int T, int L, int K, float k1, float b,
                     float omb, float* cand_s, int* cand_d, int grid,
                     float* out_s, int* out_d, int* out_tot, void* stream) {
  const bm25rows::Rows a = {docs, P, rowstarts, nrows, lens, skips, weights,
                            msm, dlo, dhi, QB, T, L, K, cand_s, cand_d,
                            out_s, out_d, out_tot};
  return bm25rows::launch_rows(a, TfdlContrib{tfdl, avgdl, k1, b, omb}, grid,
                               stream);
}

int bm25_tfdl_resident_blocks(int* out) {
  return bm25rows::resident_blocks<TfdlContrib>(out);
}

const char* bm25_tfdl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
