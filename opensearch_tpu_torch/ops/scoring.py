"""BM25 scoring primitives (the BM25 subset of opensearch_tpu/ops/scoring.py).

`posting_contrib` is THE per-posting f32 expression every scorer in the
port evaluates, in this exact operation order (no fused multiply-add):

    k = k1 * ((1 - b) + (b * dl) / avgdl)
    contrib = (w * tf) / (tf + k)

`score_term_group` is the dense plain scorer: the gather -> contribution ->
per-doc sum pass over CSR postings, as plain tensor code on any device. No
path of this slice calls it (the fastpath scores through
`ops/bm25.fused_bm25_topk_tfdl`); the general query path, a later slice
(the counterpart of the reference's XLA emit, which scores term groups
with `score_term_group`), is its caller.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SIM_BM25 = 0


def f32_scalars(k1: float, b: float, device) -> tuple:
    """(k1, 1 - b, b) as f32 scalars. `1 - b` is taken in double and
    rounded once, as the reference evaluates `1.0 - b` on Python floats
    before the f32 array arithmetic."""
    return tuple(torch.tensor(v, dtype=torch.float32, device=device)
                 for v in (k1, 1.0 - b, b))


def posting_contrib(tf: torch.Tensor, dl: torch.Tensor, weight: torch.Tensor,
                    k1: float, b: float, avgdl: torch.Tensor) -> torch.Tensor:
    """Per-posting BM25 contribution (modern Lucene BM25Similarity, no
    (k1+1) factor). All tensors f32; `avgdl` broadcasts."""
    k1_t, omb_t, b_t = f32_scalars(k1, b, tf.device)
    k = k1_t * (omb_t + (b_t * dl) / avgdl)
    return (weight * tf) / (tf + k)


def score_term_group(starts: torch.Tensor, doc_ids: torch.Tensor,
                     tfs: torch.Tensor, dl: torch.Tensor, rows,
                     weights: torch.Tensor, ndocs: int, k1: float, b: float,
                     avgdl: torch.Tensor) -> tuple:
    """Dense (scores f32[ndocs], match counts f32[ndocs]) of one weighted
    term group: postings of `rows` (-1 = absent term) scored and summed per
    doc in term order (term 0's contribution first)."""
    scores = torch.zeros(ndocs, dtype=torch.float32, device=doc_ids.device)
    counts = torch.zeros(ndocs, dtype=torch.float32, device=doc_ids.device)
    for i, r in enumerate(int(x) for x in rows):
        if r < 0:
            continue
        a, e = int(starts[r]), int(starts[r + 1])
        d = doc_ids[a:e].long()
        tf = tfs[a:e]
        c = posting_contrib(tf, dl[d].to(torch.float32), weights[i], k1, b,
                            avgdl)
        # docs are unique within a row, so index_put_ is a plain
        # elementwise add per doc: terms accumulate in term order
        scores.index_put_((d,), c, accumulate=True)
        counts.index_put_((d,), (tf > 0).to(torch.float32),
                          accumulate=True)
    return scores, counts


def bm25_idf(n_docs: int, df: int) -> float:
    """Lucene BM25Similarity.idfExplain: ln(1 + (N - df + 0.5)/(df + 0.5))."""
    return math.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))


def dequant_impact_np(q, scale):
    """Host dequantizer of a codec-v2 impact plane: q * f32(scale) in f32
    (planning bounds, head selection, the quality tier)."""
    return np.asarray(q).astype(np.float32) * np.float32(scale)
