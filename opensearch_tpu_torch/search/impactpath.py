"""The codec-v2 impact rung: a pure BM25 term group over the quantized
impact plane with host block-max pruning, certified exact against the f32
host oracle (the BM25 kind of opensearch_tpu/search/impactpath.py).

Between the fused kernels and the general path, as in the reference's
executor: a pure term-group search the fastpath declines on a segment (a
group of more than MAX_T terms, a field past the packing bounds, a
segment with deletes, rows past MAX_CHUNKS) lands here first. Per query:

1. Plan (host). The per-row block-max sidecar prices every
   IMPACT_BLOCK-posting block at w_t * scale * block_max; a sound lower
   bound theta_hat on the window boundary (a term's window-th impact, the
   probe docs' summed impacts) prunes the blocks that cannot matter, per
   term or by 128-doc ranges, whichever keeps fewer postings. What the
   pruned blocks could add is one scalar, `rem`.
2. First pass (device, `impact_program`). The kept blocks' impacts are
   gathered, dequantized with one multiply (weight * scale folded per
   block), summed per doc term by term, counted, masked by the live docs
   and msm, and the top C taken.
3. Certify (host). The candidates are exact-rescored in f32 (term-ordered
   numpy, the domain the fastpath's host oracle serves); the page is
   served when no other doc can displace it: max(approx_C + E + rem,
   rem + E) < theta.
4. Escalate. A failed certificate widens to every doc a kept block
   mentions (phase 2: the bound is rem + E alone), then returns None: the
   caller runs the general program.

Totals are exact ("eq") on unpruned passes and a lower bound ("gte")
under pruning; bodies with an explicit track_total_hits, or msm > 1, plan
unpruned. Served scores live in the host-oracle f32 domain, bit-equal to
the reference's. `_error_bound` is also the serve margin of the
fastpath's impact frontier pass. The learned-sparse kind waits for
feature planes, which are not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..index.segment import CODEC_V1, CODEC_V2, IMPACT_BLOCK, next_pow2
from ..ops import scoring as ops
from ..ops.scoring import dequant_impact_np
from . import compiler as C
from .fastpath import MAX_K, _ok_group

# candidate window floor for the first pass; the block prune keeps at
# least KEEP_FACTOR * C postings so the candidate pool stays deep enough
# to certify without an escalation on well-behaved corpora
CAND_FLOOR = 32
KEEP_FACTOR = 8
KEEP_MIN = 512

STATS = {"served": 0, "pruned_served": 0, "phase2_served": 0,
         "escalated": 0, "blocks_total": 0, "blocks_skipped": 0,
         "postings_total": 0, "postings_skipped": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


class ImpactSpec:
    """A search the impact rung can serve: one plain BM25 term group,
    score order, a window in 1..MAX_K."""

    __slots__ = ("lt", "window", "prune_ok")

    def __init__(self, lt, window: int, prune_ok: bool):
        self.lt = lt
        self.window = window
        self.prune_ok = prune_ok


def make_spec(lroot, window: int, body: dict) -> Optional[ImpactSpec]:
    if window > MAX_K or window < 1 or not _ok_group(lroot):
        return None
    # pruning changes total-hit semantics (lower bound, "gte") and
    # relaxed-msm counting is unsound: explicit total tracking or msm > 1
    # ride the unpruned impact pass
    prune_ok = "track_total_hits" not in body and int(lroot.msm) <= 1
    return ImpactSpec(lroot, int(window), prune_ok)


# pruned-remainder budget as a fraction of theta_hat: the per-term cut
# keeps sum_t max(pruned_t) <= PRUNE_MARGIN * theta_hat < theta, so a
# pruned plan certifies by construction up to live/tie edge cases
PRUNE_MARGIN = 0.5

# doc-range (live-block) pruning: partition doc ids into 2^DOC_RANGE_SHIFT
# doc ranges, bound every range at sum_t w_t * scale * max_q(t, range),
# prune ranges that cannot reach RANGE_MARGIN * theta_hat; a block is
# kept iff its doc span meets a kept range
DOC_RANGE_SHIFT = 7
RANGE_MARGIN = 0.99
PROBE_TOP = 32               # top postings per row feeding the probe-doc
#                              witness


def _probe_witness(pb, plane, act_rows, act_w, window: int,
                   eps_sum: float) -> float:
    """Sharper sound theta_hat for multi-term queries: each row's top
    PROBE_TOP postings by quantized impact (real docs), each probe doc's
    approx score summed across all queried rows, the window-th highest
    minus the summed error."""
    if window > PROBE_TOP:
        return 0.0
    docs_l = []
    for row in act_rows:
        cache = plane.__dict__.setdefault("_probe_top", {})
        got = cache.get(row)
        if got is None:
            a, b = pb.row_slice(row)
            qs = plane.q[a:b]
            m = min(PROBE_TOP, b - a)
            sel = np.argpartition(qs, b - a - m)[b - a - m:] if b - a > m \
                else np.arange(b - a)
            got = pb.doc_ids[a:b][sel].astype(np.int64)
            if len(cache) >= (1 << 15):
                cache.clear()
            cache[row] = got
        docs_l.append(got)
    probe = np.unique(np.concatenate(docs_l))
    if len(probe) < window:
        return 0.0
    approx = np.zeros(len(probe), np.float64)
    scale = float(plane.scale)
    for row, w in zip(act_rows, act_w):
        a, b = pb.row_slice(row)
        rowdocs = pb.doc_ids[a:b]
        pos = np.searchsorted(rowdocs, probe)
        pos_c = np.minimum(pos, b - a - 1)
        found = rowdocs[pos_c] == probe
        approx += np.where(found,
                           w * scale * plane.q[a:b][pos_c].astype(
                               np.float64), 0.0)
    kth = float(np.partition(approx, len(approx) - window)
                [len(approx) - window])
    return kth - eps_sum


_RANGE_MAX_CACHE_BYTES = 1 << 25    # 32MB per plane, then start over


def _row_range_max(pb, plane, row: int, shift: int):
    """(range_ids i64[R], max_q[R]) of one row: the max quantized impact
    per touched doc range; cached per plane, byte-capped."""
    cache = plane.__dict__.setdefault("_range_max", {})
    got = cache.get(row)
    if got is None:
        a, b = pb.row_slice(row)
        docs = pb.doc_ids[a:b]
        buck = (docs >> shift).astype(np.int64)
        head = np.flatnonzero(np.diff(buck)) + 1
        idx = np.concatenate(([np.int64(0)], head))
        maxq = np.maximum.reduceat(plane.q[a:b], idx) if b > a \
            else np.zeros(0, plane.q.dtype)
        got = (buck[idx] if b > a else np.zeros(0, np.int64), maxq)
        nb = int(got[0].nbytes) + int(got[1].nbytes)
        used = plane.__dict__.get("_range_max_bytes", 0)
        if used + nb > _RANGE_MAX_CACHE_BYTES:
            cache.clear()
            used = 0
        plane.__dict__["_range_max_bytes"] = used + nb
        cache[row] = got
    return got


def _range_plan(pb, plane, act_rows, act_w, offs, lens,
                theta_hat: float, eps: float, ndocs: int):
    """Doc-range plan over the active rows' blocks: (keep_mask
    bool[nblocks], rem), or None when the cut keeps everything."""
    if ndocs <= 0 or theta_hat <= 0.0:
        return None
    shift = DOC_RANGE_SHIFT
    nb = ((ndocs - 1) >> shift) + 1
    bound = np.zeros(nb, np.float64)
    scale = float(plane.scale)
    eps_sum = 0.0
    for row, w in zip(act_rows, act_w):
        bids, maxq = _row_range_max(pb, plane, row, shift)
        bound[bids] += w * scale * maxq.astype(np.float64)
        eps_sum += w * eps
    tau_r = RANGE_MARGIN * theta_hat - eps_sum
    if tau_r <= 0.0:
        return None
    kept_r = bound >= tau_r
    if kept_r.all():
        return None
    cum = np.zeros(nb + 1, np.int64)
    np.cumsum(kept_r, out=cum[1:])
    first = pb.doc_ids[offs].astype(np.int64) >> shift
    last = pb.doc_ids[offs + lens.astype(np.int64) - 1].astype(
        np.int64) >> shift
    keep_b = (cum[last + 1] - cum[first]) > 0
    pruned_b = bound[~kept_r]
    rem = float(pruned_b.max() + eps_sum) if len(pruned_b) else 0.0
    return keep_b, rem


def _plan_blocks(pb, plane, rows: np.ndarray, weights: np.ndarray,
                 C: int, prune: bool, window: int, eps: float,
                 ndocs: int = 0):
    """Select the gathered block set: (bstart i64[NB] CSR offsets, blen
    i32[NB], bweight f32[NB] = w_t * scale, bterm i32[NB] (the query term
    of each block, blocks in term order), kept_postings, rem_bound,
    n_total_blocks, total_postings). The prune threshold derives from a
    sound lower bound theta_hat on the window boundary; only blocks priced
    below PRUNE_MARGIN * theta_hat / T are skipped, and `eps` (quantization
    + param drift) prices the abstention."""
    offs_l, lens_l, w_l, term_l, val_l, act_w = [], [], [], [], [], []
    act_rows = []
    scale = np.float32(plane.scale)
    row_ends = pb.starts[1:]
    for i, r in enumerate(rows):
        if r < 0:
            continue
        a, b = plane.row_block_range(int(r))
        if b <= a:
            continue
        act_rows.append(int(r))
        off = plane.block_off[a:b]
        ln = np.minimum(np.int64(IMPACT_BLOCK),
                        int(row_ends[int(r)]) - off).astype(np.int32)
        bm = plane.block_max[a:b]
        offs_l.append(off)
        lens_l.append(ln)
        w_l.append(np.full(b - a, np.float32(weights[i]) * scale,
                           np.float32))
        term_l.append(np.full(b - a, i, np.int32))
        val_l.append(dequant_impact_np(bm, float(weights[i])
                                       * float(plane.scale)))
        act_w.append(abs(float(weights[i])))
    if not offs_l:
        z = np.zeros(0, np.int64)
        return (z, np.zeros(0, np.int32), np.zeros(0, np.float32),
                np.zeros(0, np.int32), 0, 0.0, 0, 0)
    offs = np.concatenate(offs_l)
    lens = np.concatenate(lens_l)
    bw = np.concatenate(w_l)
    terms = np.concatenate(term_l)
    vals = np.concatenate(val_l)
    total_post = int(lens.sum())
    nblocks = len(offs)
    keep_min = max(KEEP_FACTOR * C, KEEP_MIN)
    if not prune or total_post <= keep_min:
        return offs, lens, bw, terms, total_post, 0.0, nblocks, total_post
    # theta_hat: the best single-term witness on the window-th highest
    # impact, error-deducted (postings of one row are distinct docs);
    # rows past the partition budget fall back to the block-max witness
    theta_hat = 0.0
    n_active = len(val_l)
    kcache = plane.__dict__.setdefault("_kth_cache", {})
    for r, bm_v, w_i in zip(act_rows, val_l, act_w):
        a, b = int(pb.starts[r]), int(pb.starts[r + 1])
        if b - a >= window and b - a <= (1 << 17):
            kth_q = kcache.get((r, window))
            if kth_q is None:
                kth_q = float(np.partition(plane.q[a:b], b - a - window)
                              [b - a - window])
                if len(kcache) >= (1 << 16):
                    kcache.clear()
                kcache[(r, window)] = kth_q
            wit = float(dequant_impact_np(
                np.float32(kth_q), w_i * float(plane.scale)))
            theta_hat = max(theta_hat, wit - w_i * eps)
        elif len(bm_v) >= window:
            kth = float(np.partition(bm_v, len(bm_v) - window)
                        [len(bm_v) - window])
            theta_hat = max(theta_hat, kth - w_i * eps)
    eps_sum = float(sum(act_w)) * eps
    theta_hat = max(theta_hat,
                    _probe_witness(pb, plane, act_rows, act_w, window,
                                   eps_sum))
    if theta_hat <= 0.0:
        return offs, lens, bw, terms, total_post, 0.0, nblocks, total_post
    tau = PRUNE_MARGIN * theta_hat / max(n_active, 1)
    prune_mask = vals < tau
    kept_post = int(lens[~prune_mask].sum())
    if kept_post < keep_min:
        # un-prune the priciest pruned blocks back to the posting floor
        pruned_idx = np.nonzero(prune_mask)[0]
        order = pruned_idx[np.argsort(-vals[pruned_idx], kind="stable")]
        cum = kept_post + np.cumsum(lens[order])
        back = int(np.searchsorted(cum, keep_min, side="left")) + 1
        prune_mask[order[:back]] = False
        kept_post = int(lens[~prune_mask].sum())
    rem = 0.0
    if prune_mask.any():
        # per-term max pruned block value, summed: the sound bound on any
        # doc's never-gathered contribution
        T = int(rows.shape[0])
        pruned_idx = np.nonzero(prune_mask)[0]
        per_term = np.zeros(T, np.float64)
        np.maximum.at(per_term, terms[pruned_idx],
                      vals[pruned_idx].astype(np.float64))
        rem = float(per_term.sum())
    # the doc-range plan competes: whichever ships fewer postings
    if n_active >= 1:
        rp = _range_plan(pb, plane, act_rows, act_w, offs, lens,
                         theta_hat, eps, ndocs)
        if rp is not None:
            keep_b, rem_r = rp
            kept_post_r = int(lens[keep_b].sum())
            if kept_post_r >= keep_min and kept_post_r < kept_post:
                kept = np.nonzero(keep_b)[0]
                return (offs[kept], lens[kept], bw[kept], terms[kept],
                        kept_post_r, rem_r, nblocks, total_post)
    kept = np.nonzero(~prune_mask)[0]
    return (offs[kept], lens[kept], bw[kept], terms[kept], kept_post,
            rem, nblocks, total_post)


def _exact_scores(seg, field: str, rows: np.ndarray, weights: np.ndarray,
                  k1: float, b_eff: float, avgdl: float, cand: np.ndarray):
    """Exact f32 scores and per-term match counts of `cand` against the
    FULL rows: term-ordered accumulation, the host oracle's domain."""
    pb = seg.postings.get(field)
    dl = seg.doc_lens.get(field)
    dl_c = (dl[cand].astype(np.float32) if dl is not None
            else np.zeros(len(cand), np.float32))
    kfac = float(k1) * (1.0 - b_eff + b_eff * dl_c
                        / max(float(avgdl), 1e-9))
    exact = np.zeros(len(cand), np.float32)
    counts = np.zeros(len(cand), np.int64)
    for i, r in enumerate(rows):
        if r < 0:
            continue
        a, b = pb.row_slice(int(r))
        if b <= a:
            continue
        rowdocs = pb.doc_ids[a:b]
        pos = np.searchsorted(rowdocs, cand)
        pos_c = np.minimum(pos, b - a - 1)
        found = rowdocs[pos_c] == cand
        tf = np.where(found, pb.tfs[a + pos_c], 0.0).astype(np.float32)
        contrib = np.float32(weights[i]) * tf / (tf + kfac)
        exact += np.where(found, contrib, 0.0).astype(np.float32)
        counts += found
    return exact, counts


def _error_bound(plane, weights: np.ndarray, rows: np.ndarray,
                 k1q: float, bq: float, avgdlq: float,
                 drift: Optional[float] = None) -> float:
    """Sound |exact - approx| per-doc bound: per-term quantization
    half-step + build->query param drift, plus f32 accumulation slack on
    both sums (<= T adds each against the max representable score)."""
    quant = plane.quant_err()
    if drift is None:
        drift = plane.drift_bound(k1q, bq, avgdlq)
    wsum = float(np.abs(weights[rows >= 0]).sum())
    e = wsum * (quant + drift)
    t = int((rows >= 0).sum())
    umax = max(wsum * float(plane.scale) * plane.qmax, 1e-30)
    e += 4.0 * (t + 2) * float(np.spacing(np.float32(umax)))
    return e


def _result(exact_m: np.ndarray, cand: np.ndarray, order: np.ndarray,
            window: int, total: int, rel: str) -> dict:
    keep = order[:window]
    sc = exact_m[keep]
    dc = cand[keep].astype(np.int32)
    finite = np.isfinite(sc)
    sc = np.where(finite, sc, -np.inf).astype(np.float32)
    dc = np.where(finite, dc, -1)
    ms = float(sc[0]) if len(sc) and np.isfinite(sc[0]) else -np.inf
    return {"topk_idx": dc, "topk_scores": sc, "total": int(total),
            "max_score": ms, "total_rel": rel}


def _empty(window: int) -> dict:
    return {"topk_idx": np.full(window, -1, np.int32),
            "topk_scores": np.full(window, -np.inf, np.float32),
            "total": 0, "max_score": -np.inf, "total_rel": "eq"}


def impact_program(post: ops.FieldPostings, live: torch.Tensor,
                   bstart: np.ndarray, blen: np.ndarray,
                   bweight: np.ndarray, term_bounds: np.ndarray,
                   msm: float, C: int, ndocs: int) -> tuple:
    """The first pass on the device (the reference's
    `compiler.build_impact_program`): the kept blocks' dequantized
    impacts summed per doc, docs under `msm` matched blocks or dead
    dropped, the top C (score desc, doc asc) and the count of the rest,
    fetched in one copy -> (vals f32[k], idx i64[k], total)."""
    sm = ops.impact_score_blocks(post, live, bstart, blen, bweight,
                                 term_bounds, ndocs)
    ok = (sm.count >= float(np.float32(msm))) & live
    vals, idx = ops.topk_docs(sm.scores, ok, live, C)
    host = torch.cat([vals.double(), idx.double(),
                      ok.sum().double().reshape(1)]).cpu().numpy()
    k = len(idx)
    return (host[:k].astype(np.float32), host[k:2 * k].astype(np.int64),
            int(host[-1]))


def segment_search(seg, ctx, spec: ImpactSpec, k: int,
                   device: torch.device) -> Optional[dict]:
    """Serve one spec over one codec-v2 segment, or None: the general
    program runs instead (codec v1, no plane, negative weights, or a
    certificate that fails through phase 2)."""
    lt = spec.lt
    if getattr(seg, "codec_version", CODEC_V1) < CODEC_V2:
        return None
    pb = seg.postings.get(lt.field)
    if pb is None or pb.impact is None or pb.size == 0:
        return None
    plane = pb.impact
    window = max(int(spec.window or k), 1)
    Ccand = min(next_pow2(max(2 * window, CAND_FLOOR)), seg.ndocs_pad)
    nt = len(lt.terms)
    rows = np.full(nt, -1, np.int64)
    for i, t in enumerate(lt.terms):
        rows[i] = pb.row(t)
    weights = np.asarray(lt.weights, np.float32)[:nt]
    sim = lt.sim
    k1q = float(sim.k1)
    b_eff = float(sim.b) if lt.has_norms else 0.0
    avgdlq = float(ctx.avgdl(lt.field))
    msm = float(lt.msm)
    if np.any(weights < 0):
        return None              # negative boosts void the prune bounds

    eps_imp = plane.quant_err() + plane.drift_bound(k1q, b_eff, avgdlq)
    offs, lens, bw, bterm, kept_post, rem, nblocks, total_post = \
        _plan_blocks(pb, plane, rows, weights, Ccand, spec.prune_ok,
                     window, eps_imp, ndocs=seg.ndocs)
    pruned = rem > 0.0 or kept_post < total_post
    STATS["blocks_total"] += nblocks
    STATS["blocks_skipped"] += nblocks - len(offs)
    STATS["postings_total"] += total_post
    STATS["postings_skipped"] += total_post - kept_post
    if kept_post == 0:
        # no queried term has postings here: an exact empty page
        STATS["served"] += 1
        return _empty(window)

    post = C.field_postings(seg, lt.field, device)
    brow = rows[bterm]
    bstart = post.row_start[brow] + (offs - post.csr_off[brow])
    tb = np.zeros(nt + 1, np.int64)
    np.cumsum(np.bincount(bterm, minlength=nt), out=tb[1:])
    vals, idx, total = impact_program(
        post, seg.live_on(device), bstart, lens, bw, tb,
        1.0 if pruned else msm, Ccand, seg.ndocs)
    nvalid = int((vals > -np.inf).sum())
    rel = "gte" if pruned else "eq"

    if nvalid == 0:
        if pruned:
            # matches may hide entirely in pruned blocks
            STATS["escalated"] += 1
            return None
        STATS["served"] += 1
        return _empty(window)

    cand = idx[:nvalid]
    exact, counts = _exact_scores(seg, lt.field, rows, weights, k1q, b_eff,
                                  avgdlq, cand)
    pass_msm = counts >= msm
    exact_m = np.where(pass_msm, exact, -np.inf).astype(np.float32)
    n_pass = int(pass_msm.sum())
    # score ties break by doc id (the port has no doc-id reorder)
    order = np.lexsort((cand, -exact_m))
    theta = (float(exact_m[order[window - 1]]) if n_pass >= window
             else -np.inf)
    E = _error_bound(plane, weights, rows, k1q, b_eff, avgdlq)

    # displacement bound for every non-candidate doc: seen-but-lost docs
    # (only when the window filled) carry approx <= the C-th approx + E +
    # rem; never-seen docs are bounded by rem + E
    bound = (rem + E) if pruned else -np.inf
    if nvalid == Ccand:
        bound = max(bound, float(vals[nvalid - 1]) + E + rem)
    if theta > -np.inf and bound < theta:
        STATS["served"] += 1
        if pruned:
            STATS["pruned_served"] += 1
        tot = total if not pruned or msm <= 1 else n_pass
        return _result(exact_m, cand, order, window, tot, rel)
    if not pruned and nvalid < Ccand:
        # the candidate set IS every matching doc: exact by construction
        STATS["served"] += 1
        return _result(exact_m, cand, order, window, total, "eq")

    # phase 2: every doc any kept block mentions; unseen docs are then
    # bounded by the pruned remainder alone
    if pruned:
        ids = [pb.doc_ids[int(o): int(o) + int(n)]
               for o, n in zip(offs, lens)]
        union = np.unique(np.concatenate(ids)).astype(np.int64)
        if len(union) and seg.live_count != seg.ndocs:
            union = union[seg.live[union]]
        exact2, counts2 = _exact_scores(seg, lt.field, rows, weights, k1q,
                                        b_eff, avgdlq, union)
        pass2 = counts2 >= msm
        exact2_m = np.where(pass2, exact2, -np.inf).astype(np.float32)
        n2 = int(pass2.sum())
        order2 = np.lexsort((union, -exact2_m))
        theta2 = (float(exact2_m[order2[window - 1]]) if n2 >= window
                  else -np.inf)
        if theta2 > -np.inf and rem + E < theta2:
            STATS["served"] += 1
            STATS["pruned_served"] += 1
            STATS["phase2_served"] += 1
            return _result(exact2_m, union, order2, window, n2, "gte")

    STATS["escalated"] += 1
    return None
