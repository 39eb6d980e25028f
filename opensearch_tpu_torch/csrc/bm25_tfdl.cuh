// The exact tf.dl BM25 contribution shared by bm25_tfdl.cu (B1) and
// bm25_bool.cu (B3): of one valid posting,
//     k = k1 * ((1 - b) + (b * dl) / avgdl);  c = (w * tf) / (tf + k)
// in f32, round-to-nearest, no fused multiply-add, with avgdl per row and
// (tf, dl) decoded from the packed word tf << 21 | dl.

#pragma once

#include "bm25_rows.cuh"

namespace bm25tfdl {

constexpr int kDlBits = 21;
constexpr int kDlMask = (1 << kDlBits) - 1;
constexpr int kTfMax = 2047;

struct TfdlContrib {
  const int* vals;  // packed tf << 21 | dl per posting
  const float* avgdl;
  float k1, b, omb;

  struct Row {
    float k1, b, omb, avgdl;
    __device__ __forceinline__ float operator()(int p, float w) const {
      // arithmetic shift, then mask: tf >= 1024 sets the sign bit
      const float tf = static_cast<float>((p >> kDlBits) & kTfMax);
      const float dl = static_cast<float>(p & kDlMask);
      const float k =
          __fmul_rn(k1, __fadd_rn(omb, __fdiv_rn(__fmul_rn(b, dl), avgdl)));
      return __fdiv_rn(__fmul_rn(w, tf), __fadd_rn(tf, k));
    }
  };

  __device__ __forceinline__ Row row(int q) const {
    return Row{k1, b, omb, avgdl[q]};
  }
};

}  // namespace bm25tfdl
