// Fused top-k over precomputed f32 posting norms, for Hopper (sm_90a).
//
// Replaces opensearch_tpu/ops/pallas_bm25.py::_bm25_kernel (the TPU kernel
// behind fused_bm25_topk, the first fused kernel of the reference, which
// no search path of either package calls). Its fixed-L windows (the first
// lens postings at a 128-aligned element start, no skip, no doc range) are
// read by the row machinery of bm25_rows.cuh as they are: the launch
// passes starts and lens, and the machinery's fixed-window entry needs no
// row arrays and no doc-range search. This file supplies the contribution
// of one valid posting: c = w * norm, one round-to-nearest multiply, where
// `norm` is the posting's eager impact tf / (tf + K_d).
//
// Bound: memory. A row reads 8 B per valid posting (doc + norm) and writes
// 12 B x 128 of output, with one multiply and one add per posting. Each
// window starts 512 B aligned, so its rings fill by 16-byte copies.

#include "bm25_rows.cuh"

namespace {

struct NormsContrib {
  const int* vals;  // the f32 norm per posting, as its bits

  struct Row {
    __device__ __forceinline__ float operator()(int norm, float w) const {
      return __fmul_rn(w, __int_as_float(norm));
    }
  };

  __device__ __forceinline__ Row row(int) const { return Row{}; }
};

}  // namespace

extern "C" {

int bm25_norms_launch(const int* docs, const float* norms, long long P,
                      const int* starts, const int* lens,
                      const float* weights, const float* msm, int QB, int T,
                      int L, int K, int split, float* part_s, int* part_d,
                      int* part_tot, int* counters, int grid, float* out_s,
                      int* out_d, int* out_tot, void* stream) {
  bm25rows::Rows a = {docs, P, nullptr, nullptr, lens, nullptr, weights,
                      msm, nullptr, nullptr, QB, T, L, K, split, part_s,
                      part_d, part_tot, counters, out_s, out_d, out_tot};
  a.starts = starts;
  return bm25rows::launch_rows(
      a, NormsContrib{reinterpret_cast<const int*>(norms)}, grid, stream);
}

int bm25_norms_resident_blocks(int* out, int* smem_bytes) {
  return bm25rows::resident_blocks<NormsContrib>(out, smem_bytes);
}

const char* bm25_norms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
