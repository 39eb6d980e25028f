"""Scoring primitives of the general query path (the BM25, feature,
rank_feature and geo subset of opensearch_tpu/ops/scoring.py), as plain
tensor code on any device.

`posting_contrib` is THE per-posting f32 expression every scorer in the
port evaluates, in this exact operation order (no fused multiply-add):

    k = k1 * ((1 - b) + (b * dl) / avgdl)
    contrib = (w * tf) / (tf + k)

The general path reads one field's postings through `FieldPostings`:
per-row element windows into flat device arrays, either the fastpath's
resident aligned layout (doc ids, packed tf << DL_BITS | dl, impacts) or a
plain CSR copy (doc ids, f32 tfs, doc lengths) for a field the aligned
layout cannot pack. Every dense per-doc array spans the segment's `ndocs`
docs.

Summation order is the reference's: XLA on the CPU applies a
scatter-add's updates in posting order, so each doc's sum runs in term
(or block) order. A CUDA `index_add_` with repeated indices adds in no
fixed order, so the scorers here add one term's postings at a time (docs
are unique within a row, and within a term's blocks): the sums are equal
on every device and run to run. Match counts are small integers in f32,
exact in any order, so they take one scatter.

Top-k breaks score ties by ascending doc id, as `jax.lax.top_k` does: it
ranks one i64 key per doc, the score's order-preserving bits above the
complemented doc id, so keys are unique and the order is fixed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .bm25 import DL_BITS, DL_MASK, INT_SENTINEL, TF_MAX

SIM_BM25 = 0
NEG_INF = float("-inf")


class ScoredMask(NamedTuple):
    """Dense per-doc (scores, match count) of one plan node; `count` is
    the number of matching leaf terms (msm and must semantics)."""

    scores: torch.Tensor      # f32[ndocs]
    count: torch.Tensor       # f32[ndocs]

    @property
    def matched(self) -> torch.Tensor:
        return self.count > 0


@dataclass
class FieldPostings:
    """One field's postings on one device, as row windows into flat
    arrays: row r is `d_docs[row_start[r]: row_start[r] + row_len[r]]`,
    docs ascending. Exactly one of `d_tfdl` (packed tf << DL_BITS | dl,
    the aligned layout) and `d_tfs` + `d_dl` (f32 tfs and per-doc
    lengths, a CSR copy) is set. `d_imp` holds the codec-v2 quantized
    impacts in the same windows (None on codec v1). `csr_off[r]` is row
    r's start in the host CSR (`PostingsBlock.starts`), which block
    offsets of the impact sidecar are counted from."""

    row_start: np.ndarray                 # i64[nterms]
    row_len: np.ndarray                   # i64[nterms]
    csr_off: np.ndarray                   # i64[nterms]
    d_docs: torch.Tensor                  # i32[*]
    d_tfdl: Optional[torch.Tensor] = None  # i32[*]
    d_tfs: Optional[torch.Tensor] = None   # f32[*]
    d_dl: Optional[torch.Tensor] = None    # f32[ndocs]
    d_imp: Optional[torch.Tensor] = None   # i32[*]

    @property
    def device(self) -> torch.device:
        return self.d_docs.device

    def windows(self, rows: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """(starts, lens) i64 of the rows' windows; a row < 0 (absent
        term) is an empty window."""
        rows = np.asarray(rows, np.int64)
        ok = rows >= 0
        r = np.where(ok, rows, 0)
        return (np.where(ok, self.row_start[r], 0),
                np.where(ok, self.row_len[r], 0))


def f32_scalars(k1: float, b: float, device) -> tuple:
    """(k1, 1 - b, b) as f32 scalars. `1 - b` is taken in double and
    rounded once, as the reference evaluates `1.0 - b` on Python floats
    before the f32 array arithmetic."""
    return tuple(torch.tensor(v, dtype=torch.float32, device=device)
                 for v in (k1, 1.0 - b, b))


def posting_contrib(tf: torch.Tensor, dl: torch.Tensor, weight: torch.Tensor,
                    k1: float, b: float, avgdl: torch.Tensor) -> torch.Tensor:
    """Per-posting BM25 contribution (modern Lucene BM25Similarity, no
    (k1+1) factor). All tensors f32; `weight` and `avgdl` broadcast."""
    k1_t, omb_t, b_t = f32_scalars(k1, b, tf.device)
    k = k1_t * (omb_t + (b_t * dl) / avgdl)
    return (weight * tf) / (tf + k)


def gather_windows(starts: np.ndarray, lens: np.ndarray,
                   device: torch.device) -> tuple:
    """The windows [starts_i, starts_i + lens_i) laid end to end in window
    order (the flat iota + searchsorted of the reference's gathers), built
    on `device` from one small upload: (element index i64[B], window of
    each position i64[B])."""
    lens = np.asarray(lens, np.int64)
    ends = np.cumsum(lens)
    total = int(ends[-1]) if len(ends) else 0
    host = torch.from_numpy(np.stack([
        np.asarray(starts, np.int64) - (ends - lens), ends]))
    shift_t, ends_t = host.to(device).unbind(0)
    pos = torch.arange(total, dtype=torch.int64, device=device)
    win = torch.searchsorted(ends_t, pos, right=True)
    return pos + shift_t[win], win


def per_window(vals: np.ndarray, win: torch.Tensor) -> torch.Tensor:
    """f32 `vals[w]` at each position of window w (a per-posting weight
    from per-term or per-block values)."""
    return torch.from_numpy(np.asarray(vals, np.float32)).to(
        win.device)[win]


def gather_postings(post: FieldPostings, rows: Sequence[int]) -> tuple:
    """Postings of `rows` (-1 = absent term) flattened term by term:
    (docs i64[B], tf f32[B], dl f32[B], term of each posting i64[B],
    bounds i64[T+1] on the host: term i's postings at [bounds[i],
    bounds[i+1]))."""
    starts, lens = post.windows(rows)
    src, win = gather_windows(starts, lens, post.device)
    docs = post.d_docs[src].long()
    if post.d_tfdl is not None:
        p = post.d_tfdl[src]
        tf = ((p >> DL_BITS) & TF_MAX).to(torch.float32)
        dl = (p & DL_MASK).to(torch.float32)
    else:
        tf = post.d_tfs[src]
        dl = post.d_dl[docs]
    bounds = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=bounds[1:])
    return docs, tf, dl, win, bounds


def gather_docs_only(post: FieldPostings, rows: Sequence[int]
                     ) -> torch.Tensor:
    """`gather_postings` without the tf plane: docs i64[B] of `rows`
    (a real posting always has tf > 0, so masks need no tf)."""
    starts, lens = post.windows(rows)
    return post.d_docs[gather_windows(starts, lens, post.device)[0]].long()


def _add_by_segment(out: torch.Tensor, docs: torch.Tensor,
                    vals: torch.Tensor, bounds: np.ndarray) -> None:
    """out[docs] += vals, one segment [bounds[i], bounds[i+1]) at a time
    (docs unique within a segment): segments accumulate in order."""
    for a, e in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        if e > a:
            out.index_add_(0, docs[a:e], vals[a:e])


def score_term_group(post: FieldPostings, rows: Sequence[int],
                     weights: np.ndarray, live: torch.Tensor, ndocs: int,
                     k1: float, b: float, avgdl: float) -> ScoredMask:
    """Dense (scores, match counts) of one weighted term group: the
    gather -> contribution -> per-doc sum pass, terms summed in term
    order, zero outside `live`."""
    dev = post.device
    docs, tf, dl, win, bounds = gather_postings(post, rows)
    w = per_window(weights, win)
    contrib = posting_contrib(tf, dl, w, k1, b,
                              torch.tensor(np.float32(avgdl), device=dev))
    scores = torch.zeros(ndocs, dtype=torch.float32, device=dev)
    _add_by_segment(scores, docs, contrib, bounds)
    counts = torch.zeros(ndocs, dtype=torch.float32, device=dev)
    counts.index_add_(0, docs, torch.ones_like(contrib))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return ScoredMask(torch.where(live, scores, zero),
                      torch.where(live, counts, zero))


def gather_tf_dense(post: FieldPostings, rows: Sequence[int], ndocs: int,
                    t_pad: int) -> torch.Tensor:
    """f32[t_pad, ndocs]: the raw tf of each of `rows` (-1 = absent term)
    in each doc, by one flat scatter (combined_fields' BM25F needs tf
    before saturation). Every (term, doc) index is written once."""
    docs, tf, _dl, win, _bounds = gather_postings(post, rows)
    out = torch.zeros(t_pad * ndocs, dtype=torch.float32,
                      device=post.device)
    out[win * ndocs + docs] = tf
    return out.view(t_pad, ndocs)


def bm25f(tfc: torch.Tensor, dlc: torch.Tensor, idf: np.ndarray,
          k1: float, b: float, avgdl: float) -> tuple:
    """combined_fields' BM25F over the weighted tf [T, ndocs] and doc
    lengths [ndocs] (LUCENE-8563's form, no (k1 + 1) factor): (scores,
    the number of terms each doc holds), both f32[ndocs], the terms
    summed in order."""
    dev = tfc.device
    k1_t, omb_t, b_t = f32_scalars(k1, b, dev)
    norm = k1_t * (omb_t + (b_t * dlc) / torch.tensor(np.float32(avgdl),
                                                      device=dev))
    sat = tfc / (tfc + norm[None, :])
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    scores = torch.zeros_like(dlc)
    counts = torch.zeros_like(dlc)
    for t in range(len(tfc)):
        hit = tfc[t] > 0
        scores = scores + torch.where(hit, float(np.float32(idf[t]))
                                      * sat[t], zero)
        counts = counts + hit.to(torch.float32)
    return scores, counts


def dismax(sms: Sequence[ScoredMask], tie: float, boost: float,
           zeros: torch.Tensor) -> ScoredMask:
    """dis_max over its children's (scores, counts): the best child's
    score plus tie x the others' (their total, summed in child order,
    less the best), x boost where any child matched."""
    best = total = zeros
    matched = torch.zeros(zeros.shape, dtype=torch.bool,
                          device=zeros.device)
    for sm in sms:
        best = torch.maximum(best, sm.scores)
        total = total + sm.scores
        matched = matched | sm.matched
    scores = best + tie * (total - best)
    return ScoredMask(torch.where(matched, scores * boost, zeros),
                      matched.to(torch.float32))


def feature_score(post: FieldPostings, live: torch.Tensor,
                  rows: Sequence[int], ndocs: int,
                  contrib_fn: Callable) -> ScoredMask:
    """Score a feature-postings row group (rank_feature, the sparse dot):
    gather each row's (doc, f32 weight) postings, `contrib_fn(weight,
    row index of each posting)`, per-doc sums row by row in row order,
    match counts; zero outside `live`. A row < 0 (absent feature) adds
    nothing."""
    dev = post.device
    starts, lens = post.windows(rows)
    src, win = gather_windows(starts, lens, dev)
    docs = post.d_docs[src].long()
    contrib = contrib_fn(post.d_tfs[src], win)
    bounds = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=bounds[1:])
    scores = torch.zeros(ndocs, dtype=torch.float32, device=dev)
    _add_by_segment(scores, docs, contrib, bounds)
    counts = torch.zeros(ndocs, dtype=torch.float32, device=dev)
    counts.index_add_(0, docs, torch.ones_like(contrib))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return ScoredMask(torch.where(live, scores, zero),
                      torch.where(live, counts, zero))


def rank_feature_value(w: torch.Tensor, fn: str, p1: float, p2: float,
                       positive: bool) -> torch.Tensor:
    """The four rank_feature functions in f32 (the reference's
    RankFeatureQuery): saturation w / (w + pivot), log ln(scaling + w),
    sigmoid w^e / (w^e + pivot^e), linear w; `positive=False`
    (positive_score_impact false) flips saturation and sigmoid to
    pivot / (pivot + w) and pivot^e / (pivot^e + w^e). `p1` / `p2` are
    taken as f32 scalars."""
    a = torch.tensor(np.float32(p1), device=w.device)
    if fn == "linear":
        return w
    if fn == "saturation":
        return a / (a + w) if not positive else w / (w + a)
    if fn == "log":
        return torch.log(a + w)
    if fn == "sigmoid":
        e = torch.tensor(np.float32(p2), device=w.device)
        we = torch.pow(torch.clamp(w, min=0.0), e)
        pe = torch.pow(a, e)
        return pe / (pe + we) if not positive else we / (we + pe)
    raise ValueError(f"unknown rank_feature function [{fn}]")


def term_match_mask(post: FieldPostings, live: torch.Tensor,
                    rows: Sequence[int], ndocs: int) -> torch.Tensor:
    """Non-scoring terms filter: bool[ndocs], live docs with a posting in
    any of `rows` (the reference's term_match_mask / term_filter_mask:
    every real posting has tf > 0)."""
    hits = torch.zeros(ndocs, dtype=torch.bool, device=post.device)
    hits[gather_docs_only(post, rows)] = True
    return hits & live


# ---------------- codec v2: quantized-impact domain ----------------

def dequant_impact(q: torch.Tensor, scale) -> torch.Tensor:
    """THE device-side dequantizer: quantized impacts -> f32 score
    contributions; `scale` may fold per-block weights."""
    return q.to(torch.float32) * scale


def dequant_impact_np(q, scale):
    """Host dequantizer of a codec-v2 impact plane: q * f32(scale) in f32
    (planning bounds, head selection, the quality tier)."""
    return np.asarray(q).astype(np.float32) * np.float32(scale)


def gather_impact_blocks(post: FieldPostings, bstart: np.ndarray,
                         blen: np.ndarray) -> tuple:
    """Flatten posting-block windows (element offsets in `post`'s arrays)
    into (docs i64[B], iq i32[B], block of each posting i64[B]); iq stays
    in the quantized domain."""
    src, win = gather_windows(bstart, blen, post.device)
    return post.d_docs[src].long(), post.d_imp[src], win


def impact_score_blocks(post: FieldPostings, live: torch.Tensor,
                        bstart: np.ndarray, blen: np.ndarray,
                        bweight: np.ndarray, term_bounds: np.ndarray,
                        ndocs: int) -> ScoredMask:
    """The codec-v2 eager pass: gather quantized impacts over the kept
    blocks, one dequant multiply (weight * scale folded per block on the
    host), per-doc sums term by term (`term_bounds` cuts the block list
    into each term's run). Counts are exact for the gathered blocks."""
    dev = post.device
    docs, iq, win = gather_impact_blocks(post, bstart, blen)
    blen = np.asarray(blen, np.int64)
    contrib = dequant_impact(iq, per_window(bweight, win))
    pcum = np.zeros(len(blen) + 1, np.int64)
    np.cumsum(blen, out=pcum[1:])
    scores = torch.zeros(ndocs, dtype=torch.float32, device=dev)
    _add_by_segment(scores, docs, contrib, pcum[term_bounds])
    counts = torch.zeros(ndocs, dtype=torch.float32, device=dev)
    counts.index_add_(0, docs, torch.ones_like(contrib))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return ScoredMask(torch.where(live, scores, zero),
                      torch.where(live, counts, zero))


# ---------------- dense column predicates ----------------

def int64_range_mask(values: torch.Tensor, present: torch.Tensor,
                     lo: int, hi: int, include_lo: bool,
                     include_hi: bool) -> torch.Tensor:
    """Exact 64-bit range predicate over an i64 column (the reference
    splits it into i32 halves; i64 compares are native here)."""
    lower = values >= lo if include_lo else values > lo
    upper = values <= hi if include_hi else values < hi
    return lower & upper & present


def exists_mask(present: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    return present & live


def docs_mask(docs: Sequence[int], ndocs: int,
              device: torch.device) -> torch.Tensor:
    """ids query: bool[ndocs] of the listed local docs."""
    m = torch.zeros(ndocs, dtype=torch.bool, device=device)
    if len(docs):
        m[torch.as_tensor(np.asarray(docs, np.int64), device=device)] = True
    return m


# ---------------- geo (jnp in the reference, not Pallas) ----------------

EARTH_R = 6371008.8


def f32_on(v, device) -> torch.Tensor:
    """An f32 scalar on `device` (the reference's `_scalar_f32` param):
    a divisor or an operand the card's kernels must not fold into a
    reciprocal of a host scalar."""
    return torch.tensor(np.float32(v), device=device)


def deg2rad(x: torch.Tensor) -> torch.Tensor:
    """x * f32(pi / 180), as `jnp.deg2rad` computes it."""
    return x * f32_on(math.pi / 180.0, x.device)


def haversine(p1: torch.Tensor, p2: torch.Tensor, dphi: torch.Tensor,
              dlmb: torch.Tensor) -> torch.Tensor:
    """Meters (f32) from radians: 2r asin(sqrt(clip(sin(dphi/2)^2 +
    cos(p1) cos(p2) sin(dlmb/2)^2, 0, 1))), in the reference's order of
    operations; each op rounds on its own (no fused multiply-add)."""
    s1 = torch.sin(dphi / 2.0)
    s2 = torch.sin(dlmb / 2.0)
    a = s1 * s1 + torch.cos(p1) * torch.cos(p2) * (s2 * s2)
    two_r = f32_on(2.0 * EARTH_R, a.device)
    return two_r * torch.asin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def geo_distance_vec(geo: dict, lat, lon) -> torch.Tensor:
    """f32[ndocs]: the haversine meters of each doc's point to (lat,
    lon), the origin rounded to f32 (the reference's `geo_distance_vec`)."""
    dev = geo["lat"].device
    p1 = deg2rad(geo["lat"])
    p2 = deg2rad(f32_on(lat, dev))
    return haversine(p1, p2, p2 - p1, deg2rad(f32_on(lon, dev) - geo["lon"]))


def geo_distance_mask(geo: dict, lat, lon, radius_m,
                      inclusive: bool = True) -> torch.Tensor:
    """bool[ndocs]: docs with a point within `radius_m` (f32) of (lat,
    lon); strictly inside where not `inclusive`."""
    d = geo_distance_vec(geo, lat, lon)
    r = f32_on(radius_m, d.device)
    return ((d <= r) if inclusive else (d < r)) & geo["present"]


def point_in_polygon_mask(geo: dict, plat: np.ndarray,
                          plon: np.ndarray) -> torch.Tensor:
    """bool[ndocs]: the ray-cast of each doc's point against the closed
    ring `plat` / `plon` (f32 vertices, the first repeated after the
    last, so the edge from the last vertex closes it): a doc is inside
    where an odd number of edges span its latitude with the crossing's
    longitude east of it. A flat edge takes the denominator 1e-30. The
    crossing `x1 + (y - y1) / denom * (x2 - x1)` rounds each op on its
    own, where the reference's CPU build may contract an FMA."""
    dev = geo["lat"].device
    vlat = torch.from_numpy(np.asarray(plat, np.float32)).to(dev)
    vlon = torch.from_numpy(np.asarray(plon, np.float32)).to(dev)
    x = geo["lon"][:, None]
    y = geo["lat"][:, None]
    x1, y1 = vlon[None, :-1], vlat[None, :-1]
    x2, y2 = vlon[None, 1:], vlat[None, 1:]
    spans = ((y1 <= y) & (y < y2)) | ((y2 <= y) & (y < y1))
    denom = torch.where(y2 == y1, f32_on(1e-30, dev), y2 - y1)
    xin = x1 + (y - y1) / denom * (x2 - x1)
    crossings = (spans & (x < xin)).sum(dim=1)
    return (crossings % 2 == 1) & geo["present"]


# ---------------- top-k ----------------

def rank_keys(masked: torch.Tensor) -> torch.Tensor:
    """i64 per doc, larger = ranked first: the f32 score's
    order-preserving bits above 0xFFFFFFFF - doc, so equal scores rank by
    ascending doc id. The order is `jax.lax.top_k`'s: total, so +0.0
    ranks before -0.0."""
    s = masked.view(torch.int32)
    ordered = torch.where(s < 0, s ^ 0x7FFFFFFF, s).to(torch.int64)
    doc = torch.arange(masked.shape[0], dtype=torch.int64,
                       device=masked.device)
    return (ordered << 32) + (0xFFFFFFFF - doc)


def topk_docs(scores: torch.Tensor, matched: torch.Tensor,
              live: torch.Tensor, k: int) -> tuple:
    """Masked top-k: (vals f32[k], idx i64[k]) by score desc, ties by
    ascending doc id (Lucene's TopScoreDocCollector, `jax.lax.top_k`);
    unmatched docs score -inf."""
    masked = torch.where(matched & live, scores,
                         torch.full((), NEG_INF, device=scores.device))
    k = min(int(k), scores.shape[0])
    _, idx = torch.topk(rank_keys(masked), k)
    return masked[idx], idx


def collapse_topk(key: torch.Tensor, matched: torch.Tensor,
                  live: torch.Tensor, ords: torch.Tensor, n_ord_pad: int,
                  k: int) -> tuple:
    """Field-collapsed top-k (the reference's `collapse_topk`): one best
    doc per group ordinal, (vals f32[k], idx i64[k]). A scatter-max of
    the key into group space, a scatter-min of the doc ids that equal
    their group's best (ties: the lowest doc), then the top k groups
    (ties: the lowest group). Docs with ord < 0 share the null group,
    the last slot; an empty group's value is -inf."""
    nd = key.shape[0]
    dev = key.device
    neg = torch.full((), NEG_INF, device=dev)
    masked = torch.where(matched & live, key, neg)
    g = torch.where(ords >= 0, ords.to(torch.int64),
                    n_ord_pad - 1).clamp_(0, n_ord_pad - 1)
    gbest = torch.full((n_ord_pad,), NEG_INF, dtype=torch.float32,
                       device=dev).scatter_reduce_(0, g, masked, "amax")
    doc = torch.arange(nd, dtype=torch.int64, device=dev)
    best = (masked > NEG_INF) & (masked == gbest[g])
    none = int(INT_SENTINEL)
    cand = torch.where(best, doc, torch.full((), none, device=dev))
    gdoc = torch.full((n_ord_pad,), none, dtype=torch.int64,
                      device=dev).scatter_reduce_(0, g, cand, "amin")
    _, gsel = torch.topk(rank_keys(gbest), min(int(k), n_ord_pad))
    return gbest[gsel], torch.clamp(gdoc[gsel], max=nd - 1)


def total_hits(matched: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    return (matched & live).sum()


# ---------------- host-side helpers ----------------

def bm25_idf(n_docs: int, df: int) -> float:
    """Lucene BM25Similarity.idfExplain: ln(1 + (N - df + 0.5)/(df + 0.5))."""
    return math.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
