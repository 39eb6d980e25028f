"""Phase-2 exact rescore on the device (opensearch_tpu/ops/rescore.py as
PyTorch ops): the escalation ladder's middle rung re-walks each candidate
doc against the FULL posting rows of its query's terms.

Per (query, term, candidate), a branchless lower-bound bisection over the
term's window in the already-resident aligned buffers (the same
`AlignedPostings.d_docs/d_tfdl` the kernels read), then a gather of the
packed (tf, dl), and exact f32 BM25 plus per-term match counts. The
reference writes this with `jnp` ops, not a Pallas kernel, and its port is
torch ops: log2(P) batched gathers over [QB, T, C].

BIT-PARITY CONTRACT: the accumulation mirrors `fastpath._exact_rescore`
operation for operation in f32 (same expression shapes, same term order,
each scalar rounded to f32 where numpy rounds its weak scalars), so
`_tie_serves` / theta comparisons made on device scores are bit-identical
to the host oracle's. Every scalar is a 0-d tensor on the device (a
host scalar divisor may be turned into a reciprocal multiply), and no
fused multiply-add op is used.
"""

from __future__ import annotations

import numpy as np
import torch

from .bm25 import DL_BITS, DL_MASK, INT_SENTINEL, TF_MAX


def exact_rescore_batch(docs: torch.Tensor, tfdl: torch.Tensor,
                        starts: torch.Tensor, lens: torch.Tensor,
                        weights: torch.Tensor, avgdl: torch.Tensor,
                        cand: torch.Tensor, T: int, C: int, k1: float,
                        b: float):
    """Exact BM25 scores + match counts of candidate docs vs full rows.

    docs      i32[P] - aligned CSR doc ids (each row doc-ascending)
    tfdl      i32[P] - packed tf << DL_BITS | dl per posting
    starts    i32[QB, T] - ELEMENT offset of each term's full-row window
    lens      i32[QB, T] - true posting count per window (0 = absent term)
    weights   f32[QB, T] - query-time idf * boost
    avgdl     f32[QB, 1]
    cand      i32[QB, C] - candidate doc ids, INT_SENTINEL padded
    k1, b     similarity params (b pre-zeroed when norms are off)
    Returns (exact f32[QB, C], counts i32[QB, C]); 0 on padding slots.
    """
    dev = docs.device
    P = docs.shape[0]
    QB = cand.shape[0]

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    lo = starts.long()[:, :, None].expand(QB, T, C)
    hi = lo + lens.long()[:, :, None]
    end = hi
    c = cand[:, None, :]
    for _ in range(max(int(P).bit_length(), 1)):
        mid = lo + (hi - lo) // 2
        go = docs[mid.clamp(0, P - 1)] < c
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(go, hi, mid)
    # mirror the host's clamped probe: pos_c = min(pos, row_end - 1)
    pos_c = torch.minimum(lo, end - 1).clamp(0, P - 1)
    found = ((docs[pos_c] == c) & (lens[:, :, None] > 0)
             & (c < int(INT_SENTINEL)))
    p = tfdl[pos_c]
    zero = torch.zeros_like(p)
    tf = torch.where(found, (p >> DL_BITS) & TF_MAX, zero).to(torch.float32)
    # the candidate's doc length, from any matched posting (all postings
    # of one doc in one field carry the same dl)
    dl_c = torch.where(found, p & DL_MASK, zero).amax(dim=1).to(
        torch.float32)
    avg = torch.maximum(avgdl, f32(1e-9))                  # [QB, 1]
    kfac = f32(k1) * (f32(1.0 - b) + f32(b) * dl_c / avg)   # [QB, C]
    exact = torch.zeros_like(kfac)
    counts = torch.zeros(kfac.shape, dtype=torch.int32, device=dev)
    fzero = torch.zeros_like(kfac)
    # term-order f32 accumulation: adding a masked 0.0f is an exact
    # identity on the non-negative partial sums
    for t in range(T):
        tft = tf[:, t, :]
        foundt = found[:, t, :]
        exact = exact + torch.where(
            foundt, weights[:, t:t + 1] * tft / (tft + kfac), fzero)
        counts = counts + foundt.to(torch.int32)
    return exact, counts


def rescore_elem_budget(T: int, C: int, max_elems: int = 1 << 24) -> int:
    """Max queries per launch so the [QB, T, C] probe intermediates stay
    bounded, as a power of two (the caller pads QB to one)."""
    n = max(1, max_elems // max(T * C, 1))
    return 1 << (n.bit_length() - 1)


def host_exact_rescore_batch(docs: np.ndarray, tfdl: np.ndarray,
                             starts: np.ndarray, lens: np.ndarray,
                             weights: np.ndarray, avgdl: np.ndarray,
                             cand: np.ndarray, k1: float, b: float):
    """Numpy mirror of `exact_rescore_batch` over the SAME padded operands
    (the parity oracle; the per-query host path is
    `fastpath._exact_rescore`)."""
    QB, C = cand.shape
    T = starts.shape[1]
    exact = np.zeros((QB, C), np.float32)
    counts = np.zeros((QB, C), np.int32)
    for q in range(QB):
        valid = cand[q] < INT_SENTINEL
        dl_c = np.zeros(C, np.float32)
        tf_q = np.zeros((T, C), np.float32)
        found_q = np.zeros((T, C), bool)
        for t in range(T):
            a = int(starts[q, t])
            ln = int(lens[q, t])
            if ln <= 0:
                continue
            rowdocs = docs[a: a + ln]
            pos = np.searchsorted(rowdocs, cand[q])
            pos_c = np.minimum(pos, ln - 1)
            found = (rowdocs[pos_c] == cand[q]) & valid
            packed = tfdl[a + pos_c]
            tf_q[t] = np.where(found, (packed >> DL_BITS) & TF_MAX,
                               0.0).astype(np.float32)
            dl_c = np.maximum(dl_c, np.where(found, packed & DL_MASK,
                                             0).astype(np.float32))
            found_q[t] = found
        kfac = k1 * (1.0 - b + b * dl_c / max(float(avgdl[q, 0]), 1e-9))
        for t in range(T):
            tft = tf_q[t]
            contrib = np.where(found_q[t],
                               np.float32(weights[q, t]) * tft
                               / (tft + kfac), 0.0).astype(np.float32)
            exact[q] += contrib
            counts[q] += found_q[t]
    return exact, counts
