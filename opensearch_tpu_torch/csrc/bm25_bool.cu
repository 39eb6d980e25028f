// Fused bool/filtered BM25 top-k over packed (tf, dl) postings, for Hopper
// (sm_90a).
//
// Replaces opensearch_tpu/ops/pallas_bm25.py::_bm25_bool_kernel (the TPU
// kernel behind fused_bm25_bool_topk). It is B1 (bm25_tfdl.cu) with the
// weighted-threshold rule of a bool query: each slot carries a count weight
// cw (1024 for a required clause, 1 for a member of the one counted
// family, 0 for a bonus term), and a doc passes iff the sum of the count
// weights of its matching slots, taken in slot order, reaches the row's
// threshold. A filter takes one of two forms, one per launch:
//  - list form (the TPU's design, kept for rows where every filter doc may
//    pass: bonus-only and const-score rows): slot TS is the filter's
//    sorted doc list, read from its own buffer `filt` with count weight
//    1024 and score 0; slots (TS, 2 TS) are dead.
//  - probe form (rows whose threshold the filter cannot reach alone): the
//    row has its TS term slots only, and a term leader that could pass
//    with the filter reads the doc's bit in the filter's bitmap `fbits`
//    (ndocs bits, about 1 MB at 8.8M docs, so it stays in the 50 MB L2).
//    The TPU merged the filter as a slot so that no per-doc gather was
//    needed; here a probe is one L2 sector per candidate, while a slot
//    costs 4 B per filter doc, a ring and a share of every tile, and
//    sets the row's chunk count by the filter's length.
// The row semantics and the design (tiles cut at one doc through
// shared-memory rings, a merge-path merge with slot-order sums, a running
// top K, rows split over blocks when a launch has few) are in
// bm25_rows.cuh, the contribution in bm25_tfdl.cuh.
//
// Bound: memory. A row reads 8 B per valid term posting (and, in list
// form, 4 B per valid filter posting) and writes 12 B x 128 of output,
// with a handful of flops per posting.

#include "bm25_tfdl.cuh"

extern "C" {

int bm25_bool_launch(const int* docs, const int* tfdl, long long P,
                     const int* filt, long long Pf, const int* fbits,
                     long long nwords, const int* rowstarts,
                     const int* nrows, const int* lens, const int* skips,
                     const float* weights, const float* cw,
                     const float* thresh, const float* avgdl, const int* dlo,
                     const int* dhi, int QB, int TS, int T, int L, int K,
                     float k1, float b, float omb, int split, float* part_s,
                     int* part_d, int* part_tot, int* counters, int grid,
                     float* out_s, int* out_d, int* out_tot, void* stream) {
  bm25rows::Rows a = {docs, P, rowstarts, nrows, lens, skips, weights,
                      thresh, dlo, dhi, QB, T, L, K, split, part_s, part_d,
                      part_tot, counters, out_s, out_d, out_tot};
  a.cw = cw;
  a.filt = filt;    // null: no filter slot
  a.Pf = Pf;
  a.fbits = fbits;  // null: no probe
  a.nwords = nwords;
  a.TS = TS;
  return bm25rows::launch_rows(
      a, bm25tfdl::TfdlContrib{tfdl, avgdl, k1, b, omb}, grid, stream);
}

int bm25_bool_resident_blocks(int* out, int* smem_bytes) {
  return bm25rows::resident_blocks<bm25tfdl::TfdlContrib>(out, smem_bytes);
}

const char* bm25_bool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
