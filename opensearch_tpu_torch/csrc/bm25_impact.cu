// Fused top-k over codec-v2 quantized impacts, for Hopper (sm_90a).
//
// Replaces opensearch_tpu/ops/pallas_bm25.py::_bm25_impact_kernel (the TPU
// kernel behind fused_bm25_topk_impact). The row semantics and the design
// (tiles cut at one doc through shared-memory rings filled by cp.async, a
// merge-path merge with slot-order sums, a running top K, rows split over
// blocks when a launch has few: a frontier launch holds tens of head rows
// at K = 128) are in bm25_rows.cuh; this file supplies the contribution
// of one valid posting: c = w * f32(imp), one round-to-nearest multiply,
// where `imp` is the posting's quantized impact (u8/u16 widened to i32) and
// `w` folds idf * boost * the plane's dequant scale on the host.
//
// Bound: memory. A row reads 8 B per valid posting (doc + impact) and
// writes 12 B x 128 of output, with one multiply and one add per posting.

#include "bm25_rows.cuh"

namespace {

struct ImpactContrib {
  const int* vals;  // quantized impact per posting

  struct Row {
    __device__ __forceinline__ float operator()(int imp, float w) const {
      return __fmul_rn(w, static_cast<float>(imp));
    }
  };

  __device__ __forceinline__ Row row(int) const { return Row{}; }
};

}  // namespace

extern "C" {

int bm25_impact_launch(const int* docs, const int* imp, long long P,
                       const int* rowstarts, const int* nrows,
                       const int* lens, const int* skips,
                       const float* weights, const float* msm,
                       const int* dlo, const int* dhi, int QB, int T, int L,
                       int K, int split, float* part_s, int* part_d,
                       int* part_tot, int* counters, int grid, float* out_s,
                       int* out_d, int* out_tot, void* stream) {
  const bm25rows::Rows a = {docs, P, rowstarts, nrows, lens, skips, weights,
                            msm, dlo, dhi, QB, T, L, K, split, part_s,
                            part_d, part_tot, counters, out_s, out_d, out_tot};
  return bm25rows::launch_rows(a, ImpactContrib{imp}, grid, stream);
}

int bm25_impact_resident_blocks(int* out, int* smem_bytes) {
  return bm25rows::resident_blocks<ImpactContrib>(out, smem_bytes);
}

const char* bm25_impact_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
