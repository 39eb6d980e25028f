// Fused BM25 top-k over packed (tf, dl) postings, for Hopper (sm_90a).
//
// Replaces opensearch_tpu/ops/pallas_bm25.py::_bm25_tfdl_kernel (the TPU
// kernel behind fused_bm25_topk_tfdl). The row semantics and the design
// (tiles cut at one doc through shared-memory rings filled by cp.async, a
// merge-path merge with slot-order sums, a running top K, rows split over
// blocks when a launch has few) are in bm25_rows.cuh; the contribution of
// one valid posting, exact f32 BM25 from the packed (tf, dl) word, is in
// bm25_tfdl.cuh.
//
// Bound: memory. A row reads 8 B per valid posting (doc + packed tf.dl)
// and writes 12 B x 128 of output, and does a handful of flops per
// posting, far below the card's 295 flop/byte balance point.

#include "bm25_tfdl.cuh"

extern "C" {

int bm25_tfdl_launch(const int* docs, const int* tfdl, long long P,
                     const int* rowstarts, const int* nrows, const int* lens,
                     const int* skips, const float* weights, const float* msm,
                     const float* avgdl, const int* dlo, const int* dhi,
                     int QB, int T, int L, int K, float k1, float b,
                     float omb, int split, float* part_s, int* part_d,
                     int* part_tot, int* counters, int grid, float* out_s,
                     int* out_d, int* out_tot, void* stream) {
  const bm25rows::Rows a = {docs, P, rowstarts, nrows, lens, skips, weights,
                            msm, dlo, dhi, QB, T, L, K, split, part_s,
                            part_d, part_tot, counters, out_s, out_d, out_tot};
  return bm25rows::launch_rows(
      a, bm25tfdl::TfdlContrib{tfdl, avgdl, k1, b, omb}, grid, stream);
}

int bm25_tfdl_resident_blocks(int* out, int* smem_bytes) {
  return bm25rows::resident_blocks<bm25tfdl::TfdlContrib>(out, smem_bytes);
}

const char* bm25_tfdl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
