"""The term-group fast path: term / terms / match queries through the fused
kernels `ops/bm25.fused_bm25_topk_impact` and `fused_bm25_topk_tfdl`, with
the reference's impact-head pruning and its certify-or-escalate ladder (the
pure term-group part of opensearch_tpu/search/fastpath.py).

Per (segment, field, device) the postings are laid out once as aligned CSR
rows of (doc_id i32, tf<<21|dl i32) resident on the device; a term with
more than L_HEAD postings also keeps its L_HEAD highest-impact postings
(doc-ascending) as an extra "head" row in the same buffers, plus the
frontier of the postings left out. On codec-v2 segments the quantized
impact plane rides the same layout (u8/u16 widened to i32).

A score-mode BM25 query without `track_total_hits` is prune-eligible: its
frontier pass streams heads only, on the impact kernel (codec v2,
non-negative weights) or the exact tf.dl kernel (codec v1, negative
boosts, shard views). The host then certifies the page or escalates it:
verify (exact rescore of the kernel's candidates against an unseen-doc
bound) -> candidate-union rescore (every head doc, then 4x deeper heads)
-> quality tier (a dense launch over the 1/8 of docs with the best
impacts) -> dense (the query's full rows, chunked by doc range when
oversized). Certified pruned pages report totals as a lower bound
(relation "gte"). Other queries go straight to the dense kernel rows.

Bool and filtered queries (`bool`, `constant_score`, filtered `match`)
flatten onto the weighted-threshold slot model of the reference: required
slots, one counted family and bonus terms, with the filter clauses ANDed
into one sorted doc list per segment (`FilterList`, from the masks of
`search/filters.py`). They ride the bool kernel `fused_bm25_bool_topk`,
with the filter as one more slot ("b3_filter_slot") or, for a dense
filter on its second use, over filter-specialized postings
("b3_filtered_postings"); a family-only spec over a dense hot filter
rides the pure pruned pipeline over the filtered postings instead
("filtered_pure"). On the filter-slot route a row that needs a term match
probes the filter's bitmap instead of merging its doc list (the probe
form: term slots only, chunked by their own lengths); rows that every
filter doc may pass (bonus-only, constant score) merge the list.

A search or a segment the fast path cannot serve is declined, at the
reference's conditions: `make_spec` returns None for a shape outside the
slot model, a window past MAX_K or a group of more than MAX_T terms;
`launch_batch` returns None for a segment with deleted docs; a query
whose field exceeds the (tf, dl) packing bounds, or whose rows need more
than MAX_CHUNKS doc-range chunks, gets None among the results. The
executor then runs the impact rung (`search/impactpath.py`) and the
general path (`compiler.run_segment`) for it. A kernel that fails to
build or launch raises.
"""

from __future__ import annotations

import collections
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..index.segment import (CODEC_V1, CODEC_V2, PostingsBlock, Segment,
                             next_pow2)
from ..ops.bm25 import (DL_BITS, DL_MAX, HBM_ALIGN, INT_SENTINEL, LANES,
                        REQ_W, TF_MAX, align_csr_rows, fused_bm25_bool_topk,
                        fused_bm25_topk_impact, fused_bm25_topk_tfdl,
                        pack_bits)
from ..ops.scoring import SIM_BM25, dequant_impact_np
from . import compiler as C
from . import filters
from .body import rungs_eligible

MAX_T = 8            # pow2-padded term slots per query group
MAX_L = 1 << 16      # per-term window cap (elements)
MAX_TL = 1 << 17     # T_pad * L cap per kernel row
MAX_K = 128          # top-k lanes the kernel returns
MAX_CHUNKS = 4096    # doc-range split bound
DECLINED = "declined"  # a query's rows where the fast path declines it
INT_MAX = np.int32(2**31 - 1)

# impact-ordered heads: a term with more than L_HEAD postings keeps an
# extra copy of its L_HEAD highest-impact postings, doc-ascending
L_HEAD = 1 << 12

QUALITY_SHARE = 8             # quality tier keeps ~ndocs/QUALITY_SHARE docs
QUALITY_MIN_NDOCS = 1 << 16   # below this, dense is already cheap

# rung counters since the last reset_stats(): which rung served each
# prune-eligible query (the reference's fastpath STATS subset)
STATS = {"pruned_served": 0, "pruned_rescued": 0, "pruned_rescued2": 0,
         "pruned_dview": 0, "pruned_escalated": 0, "impact_frontier": 0,
         "shard_view_served": 0, "pure_served": 0, "bool_served": 0,
         "fallback": 0,
         # the route of each bool spec over each segment (port only)
         "b3_filter_slot": 0, "b3_filtered_postings": 0, "b3_unfiltered": 0,
         "filtered_pure": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


# ---------------------------------------------------------------------
# frontiers, heads and the aligned layout
# ---------------------------------------------------------------------

def _frontier(tfs: np.ndarray, dls: np.ndarray, ids: np.ndarray = None
              ) -> tuple:
    """(tf -> min dl over docs with that tf) of a posting set: its Pareto
    frontier under the BM25 contribution tf/(tf+k(dl)), which is
    increasing in tf and decreasing in dl, so the max contribution of the
    set under ANY (k1, b, avgdl) is attained on it. With `ids`, also per
    frontier point the MIN doc id attaining it exactly (tf, min dl) and the
    MIN doc id over the whole tf class (boundary-tie witnesses)."""
    if len(tfs) == 0:
        z = np.zeros(0, np.float32)
        zi = np.zeros(0, np.int64)
        return (z, z) if ids is None else (z, z, zi, zi)
    tf = tfs.astype(np.int64)
    dl_s32 = dls.astype(np.float32)
    if ids is not None:
        # per tf class, in tf order: the min dl, the min id at that dl
        # and the min id of the class (what a lexsort by (tf, dl, id)
        # puts first), from one stable sort by tf and segment reductions
        order = np.argsort(tf, kind="stable")
        tf_s = tf[order]
        dl_s = dl_s32[order]
        id_s = ids[order].astype(np.int64)
        first = np.flatnonzero(
            np.concatenate(([True], tf_s[1:] != tf_s[:-1])))
        dl_min = np.minimum.reduceat(dl_s, first)
        cls = np.cumsum(np.concatenate(([False], tf_s[1:] != tf_s[:-1])))
        at_min = np.where(dl_s == dl_min[cls], id_s,
                          np.iinfo(np.int64).max)
        return (tf_s[first].astype(np.float32), dl_min,
                np.minimum.reduceat(at_min, first),
                np.minimum.reduceat(id_s, first))
    order = np.argsort(tf, kind="stable")
    tf_s = tf[order]
    dl_s = dl_s32[order]
    heads = np.flatnonzero(np.concatenate(([True], tf_s[1:] != tf_s[:-1])))
    return (tf_s[heads].astype(np.float32),
            np.minimum.reduceat(dl_s, heads).astype(np.float32))


def _frontier_bound(fr: Tuple[np.ndarray, np.ndarray], k1: float,
                    b_eff: float, avgdl: float) -> float:
    """Max contribution tf/(tf+k1(1-b+b dl/avgdl)) over a frontier."""
    tf, dl = fr[0], fr[1]
    if len(tf) == 0:
        return 0.0
    k = k1 * (1.0 - b_eff + b_eff * dl / max(avgdl, 1e-9))
    return float(np.max(tf / (tf + np.maximum(k, 1e-9))))


class AlignedPostings:
    """Device-resident aligned (doc, tf.dl[, impact]) postings of one
    segment field, plus the impact-selected heads of oversized rows
    (appended to the same buffers) and the remainder frontiers that make
    pruned results provable."""

    __slots__ = ("starts_rows", "lens", "d_docs", "d_tfdl", "nbytes",
                 "head_starts_rows", "head_lens", "rem_frontiers",
                 "head_ids", "_full_frontiers", "_head2", "d_imp")

    def __init__(self, starts_rows: np.ndarray, lens: np.ndarray,
                 d_docs: torch.Tensor, d_tfdl: torch.Tensor,
                 head_starts_rows: Optional[np.ndarray] = None,
                 head_lens: Optional[np.ndarray] = None,
                 rem_frontiers: Optional[dict] = None,
                 head_ids: Optional[dict] = None,
                 d_imp: Optional[torch.Tensor] = None):
        self.starts_rows = starts_rows    # i64[nterms] aligned start / LANES
        self.lens = lens                  # i64[nterms] true posting counts
        self.d_docs = d_docs
        self.d_tfdl = d_tfdl
        # head view: == (starts_rows, lens) for rows with <= L_HEAD
        # postings; the appended head region for clamped rows
        self.head_starts_rows = (head_starts_rows if head_starts_rows
                                 is not None else starts_rows)
        self.head_lens = (head_lens if head_lens is not None
                          else np.minimum(lens, L_HEAD))
        # row -> frontier of the postings OUTSIDE the head (clamped rows)
        self.rem_frontiers = rem_frontiers or {}
        # row -> doc ids of the head postings (clamped rows)
        self.head_ids = head_ids or {}
        self._full_frontiers: dict = {}
        # row -> (ids, remainder frontier) of the 4x deeper tier-2 head
        self._head2: dict = {}
        # codec v2: the quantized plane in the same layout, widened to i32
        self.d_imp = d_imp
        self.nbytes = sum(t.numel() * 4 for t in (d_docs, d_tfdl, d_imp)
                          if t is not None)

    def head2(self, pb, dl_col, row: int) -> tuple:
        """Lazy 4x-deeper head for the second escalation rung: ids of the
        top 4*L_HEAD postings by nominal impact plus the frontier of what
        remains, cached per row."""
        got = self._head2.get(row)
        if got is None:
            a, b = pb.row_slice(row)
            dls = (dl_col[pb.doc_ids[a:b]] if dl_col is not None
                   else np.zeros(b - a, np.int64))
            plane = pb.impact
            keep, fr = _head_select(pb.doc_ids[a:b], pb.tfs[a:b],
                                    np.asarray(dls, np.int64),
                                    l_head=4 * L_HEAD,
                                    imp=(_plane_impacts_slice(plane, a, b)
                                         if plane is not None else None))
            got = (pb.doc_ids[a:b][keep], fr)
            self._head2[row] = got
        return got

    def clamped(self, row: int) -> bool:
        return row in self.rem_frontiers

    def rem_bound(self, row: int, k1: float, b_eff: float,
                  avgdl: float) -> float:
        """Upper bound of one remaining (non-head) posting's contribution
        for this row under query-time similarity params."""
        fr = self.rem_frontiers.get(row)
        return 0.0 if fr is None else _frontier_bound(fr, k1, b_eff, avgdl)

    def full_bound(self, pb, row: int, k1: float, b_eff: float,
                   avgdl: float, dl_col) -> float:
        """Upper bound of ANY single posting's contribution in this row
        (lazy per-row frontier, cached)."""
        fr = self._full_frontiers.get(row)
        if fr is None:
            a, b = pb.row_slice(row)
            dls = (dl_col[pb.doc_ids[a:b]] if dl_col is not None
                   else np.zeros(b - a, np.float32))
            fr = _frontier(pb.tfs[a:b], dls)
            self._full_frontiers[row] = fr
        return _frontier_bound(fr, k1, b_eff, avgdl)


def packable(seg, field: str) -> bool:
    """False when a posting of `field` exceeds the packing bounds (tf
    above TF_MAX or a doc length above DL_MAX) or `field` is a feature
    field (its tf slot an f32 weight): the fast path declines the field
    on this segment. Cached on the segment."""
    key = ("packable", field, "")
    got = seg.aligned.get(key)
    if got is None:
        pb = seg.postings.get(field)
        dl = seg.doc_lens.get(field)
        # a doc's length counts its tokens in the field, each of which
        # is in one of its postings: the longest doc bounds every posting
        got = pb is None or pb.size == 0 or (
            not pb.feature and float(pb.tfs.max()) <= TF_MAX
            and (dl is None or len(dl) == 0 or int(dl.max()) <= DL_MAX))
        seg.aligned[key] = got
    return got


def get_aligned(seg, field: str,
                device: torch.device) -> Optional[AlignedPostings]:
    """Build (or fetch cached) aligned postings; None when the segment has
    no postings for the field. The field must be `packable`."""
    key = (field, str(device))
    if key not in seg.aligned:
        # the host side of a layout (rows, heads, frontiers) does not
        # depend on the device: a second device copies the buffers
        other = next((al for k, al in seg.aligned.items()
                      if len(k) == 2 and k[0] == field), False)
        seg.aligned[key] = (_build_aligned(seg, field, device)
                            if other is False else
                            None if other is None else
                            _copy_aligned(other, device))
    return seg.aligned[key]


def _copy_aligned(al: AlignedPostings,
                  device: torch.device) -> AlignedPostings:
    """`al` with its device buffers copied to `device`; the host-side
    metadata and its lazy caches are shared."""
    out = AlignedPostings(
        al.starts_rows, al.lens, al.d_docs.to(device), al.d_tfdl.to(device),
        al.head_starts_rows, al.head_lens, al.rem_frontiers, al.head_ids,
        d_imp=None if al.d_imp is None else al.d_imp.to(device))
    out._full_frontiers = al._full_frontiers
    out._head2 = al._head2
    return out


def _nominal_impact(tfs: np.ndarray, dls: np.ndarray,
                    avg: float) -> np.ndarray:
    """The ONE nominal-similarity impact (k1=1.2, b=0.75) head selection
    and the quality tier order by on codec-v1 layouts."""
    return tfs / (tfs + 1.2 * (0.25 + 0.75 * dls / avg))


def _plane_impacts(pb) -> Optional[np.ndarray]:
    """Codec-v2 source of the nominal impact order: the dequantized plane
    (built under the same nominal params); None without a plane."""
    plane = pb.impact
    if plane is None:
        return None
    return dequant_impact_np(plane.q, plane.scale)


def _plane_impacts_slice(plane, a: int, b: int) -> np.ndarray:
    """Dequantized impacts of ONE row slice."""
    return dequant_impact_np(plane.q[a:b], plane.scale)


def _head_select(doc_ids: np.ndarray, tfs: np.ndarray, dl_of: np.ndarray,
                 l_head: int = None, imp: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, tuple]:
    """Pick the L_HEAD highest-impact postings of one oversized row.
    Returns (kept positions ascending, i.e. doc-ascending, remainder
    frontier with tie witnesses). The order only steers which postings are
    kept; correctness rides on the remainder frontier."""
    tf = tfs.astype(np.float32)
    dlf = dl_of.astype(np.float32)
    if imp is not None:
        c = imp
    else:
        avg = max(float(dlf.mean()), 1.0)
        c = _nominal_impact(tf, dlf, avg)
    # the lh highest impacts, ties kept in doc-ascending order (what a
    # stable sort by descending impact puts first); the frontier of the
    # rest does not depend on the rest's order
    lh = L_HEAD if l_head is None else l_head
    n = len(c)
    if n <= lh:
        keep = np.arange(n)
    else:
        kth = np.partition(c, n - lh)[n - lh]
        above = np.flatnonzero(c > kth)
        ties = np.flatnonzero(c == kth)[:lh - len(above)]
        keep = np.sort(np.concatenate([above, ties]))
    rest = np.ones(n, bool)
    rest[keep] = False
    return keep, _frontier(tf[rest], dlf[rest], doc_ids[rest])


def _pack_tfdl(seg, field: str, doc_ids: np.ndarray,
               tfs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(doc lengths i64, packed tf << DL_BITS | dl i32) of postings of a
    `packable` field."""
    dl = seg.doc_lens.get(field)
    dl_of = (dl[doc_ids].astype(np.int64) if dl is not None
             else np.zeros(len(doc_ids), np.int64))
    return dl_of, ((tfs.astype(np.int64) << DL_BITS) | dl_of).astype(
        np.int32)


def _build_aligned(seg, field: str,
                   device: torch.device) -> Optional[AlignedPostings]:
    pb = seg.postings.get(field)
    if pb is None or pb.size == 0:
        return None
    tfs = pb.tfs
    dl_of, packed = _pack_tfdl(seg, field, pb.doc_ids, tfs)
    lens = np.diff(pb.starts).astype(np.int64)
    nterms = len(lens)

    # impact heads for oversized rows, appended as EXTRA CSR rows so one
    # aligned buffer serves the dense rows (offsets unchanged) and the
    # pruned path (the head region for big rows)
    big = np.nonzero(lens > L_HEAD)[0]
    rem_frontiers: dict = {}
    head_ids: dict = {}
    cat_starts = pb.starts
    cat_docs = pb.doc_ids
    cat_packed = packed
    # codec v2: carry the quantized plane through the same aligned layout
    plane = (pb.impact
             if getattr(seg, "codec_version", CODEC_V1) >= CODEC_V2
             else None)
    cat_imp = (plane.q.astype(np.int32) if plane is not None else None)
    if len(big):
        plane_imp = _plane_impacts(pb)
        h_docs, h_packed, h_lens, h_imp = [], [], [], []
        for r in big:
            a, b = int(pb.starts[r]), int(pb.starts[r + 1])
            keep, rem_fr = _head_select(pb.doc_ids[a:b], tfs[a:b],
                                        dl_of[a:b],
                                        imp=(plane_imp[a:b]
                                             if plane_imp is not None
                                             else None))
            h_docs.append(pb.doc_ids[a:b][keep])
            h_packed.append(packed[a:b][keep])
            h_lens.append(len(keep))
            if cat_imp is not None:
                h_imp.append(plane.q[a:b][keep].astype(np.int32))
            rem_frontiers[int(r)] = rem_fr
            head_ids[int(r)] = h_docs[-1]
        cat_docs = np.concatenate([pb.doc_ids] + h_docs)
        cat_packed = np.concatenate([packed] + h_packed)
        if cat_imp is not None:
            cat_imp = np.concatenate([cat_imp] + h_imp)
        cat_starts = np.concatenate([
            pb.starts,
            pb.starts[-1] + np.cumsum(np.asarray(h_lens, np.int64))])

    # rows align to 128 lanes only; windows align DOWN to the 1024 tile
    # and the kernel masks the spilled prefix positionally (skip)
    extra = (cat_imp,) if cat_imp is not None else ()
    aligned = align_csr_rows(cat_starts, cat_docs, cat_packed, *extra,
                             margin=MAX_L, alignment=LANES)
    a_starts, a_docs, a_packed = aligned[0], aligned[1], aligned[2]
    starts_rows = (a_starts[:-1] // LANES).astype(np.int64)
    head_starts_rows = starts_rows[:nterms].copy()
    head_lens = np.minimum(lens, L_HEAD)
    if len(big):
        head_starts_rows[big] = starts_rows[nterms:]
    return AlignedPostings(
        starts_rows[:nterms], lens, torch.from_numpy(a_docs).to(device),
        torch.from_numpy(a_packed).to(device), head_starts_rows, head_lens,
        rem_frontiers, head_ids,
        d_imp=(torch.from_numpy(aligned[3]).to(device)
               if cat_imp is not None else None))


# ---------------------------------------------------------------------
# specs and kernel rows
# ---------------------------------------------------------------------

class FastSpec:
    """A search the fast path serves. kind "pure": one BM25 term group
    (`lt`); kind "bool": the weighted-threshold shape of a bool/filtered
    query (reference BooleanQuery semantics): `slots` [(term, weight,
    cw)] with cw REQ_W for a required term, 1 for a member of the one
    count-constrained family (`fam_msm` of them must match) and 0 for a
    bonus term, `filter_clauses` [(node, negated)] ANDed, a `boost`, and
    `const_score` (every hit's score, for a spec without slots).
    `prune_ok`: the body allows impact-head pruning (no explicit
    track_total_hits)."""

    __slots__ = ("kind", "lt", "slots", "fam_msm", "filter_clauses",
                 "field", "sim", "has_norms", "boost", "const_score",
                 "window", "prune_ok")

    def __init__(self, kind: str, **kw):
        self.kind = kind
        self.lt = None
        self.slots = []
        self.fam_msm = 0
        self.filter_clauses = []
        self.field = None
        self.sim = None
        self.has_norms = True
        self.boost = 1.0
        self.const_score = None
        self.window = None
        self.prune_ok = False
        for k, v in kw.items():
            setattr(self, k, v)

    @property
    def n_required(self) -> int:
        return sum(1 for _, _, cw in self.slots if cw == REQ_W)


def _ok_group(lt) -> bool:
    """LTerms usable as a prunable scoring clause (plain BM25 group)."""
    if not isinstance(lt, C.LTerms):
        return False
    if lt.mode != "score" or lt.sim is None or lt.sim.sim_id != SIM_BM25:
        return False
    return len(lt.terms) >= 1


def _flatten_bool(lroot) -> Optional[FastSpec]:
    """Map an LBool/LConstScore tree onto the weighted-threshold slot
    model (the reference's `_flatten_bool`); None where the shape is not
    expressible (the general path serves it)."""
    if isinstance(lroot, C.LConstScore):
        if lroot.child is None or lroot.boost < 0:
            return None
        return FastSpec("bool", filter_clauses=[(lroot.child, False)],
                        const_score=float(lroot.boost), boost=1.0)
    if not isinstance(lroot, C.LBool):
        return None
    b = lroot
    if b.boost <= 0:
        # boost 0 zeroes every score BEFORE top-k on the general path
        # (ties then break by doc id); the kernel ranks pre-boost
        return None
    if not all(_ok_group(g) for g in b.musts + b.shoulds):
        return None
    groups = b.musts + b.shoulds
    field = sim = None
    has_norms = True
    if groups:
        field, sim, has_norms = (groups[0].field, groups[0].sim,
                                 groups[0].has_norms)
        for g in groups:
            if (g.field != field or g.sim.k1 != sim.k1 or g.sim.b != sim.b
                    or g.has_norms != has_norms):
                return None

    req: List[Tuple[str, float]] = []
    fam: List[Tuple[str, float]] = []
    bonus: List[Tuple[str, float]] = []
    fam_msm = 0

    def slot_weights(g):
        return [(t, float(np.asarray(g.weights)[i]))
                for i, t in enumerate(g.terms)]

    for m in b.musts:
        if len(m.terms) == 1 or m.msm >= len(m.terms):
            req.extend(slot_weights(m))        # AND semantics: all required
        elif not fam:
            fam.extend(slot_weights(m))        # the one constrained family
            fam_msm = max(int(m.msm), 1)
        else:
            return None                        # two constrained families
    if b.shoulds:
        outer = int(b.msm)
        if outer == 0:
            # pure score bonus: cw 0, so a bonus match never stands in for
            # a missing required or family slot
            for g in b.shoulds:
                if len(g.terms) > 1 and g.msm > 1:
                    return None
                bonus.extend(slot_weights(g))
        else:
            if fam:
                return None                    # two constrained families
            if all(len(g.terms) == 1 for g in b.shoulds):
                for g in b.shoulds:
                    fam.extend(slot_weights(g))
                fam_msm = outer
            elif len(b.shoulds) == 1 and outer == 1:
                g = b.shoulds[0]
                fam.extend(slot_weights(g))
                fam_msm = max(int(g.msm), 1)
            else:
                return None

    filter_clauses = ([(f, False) for f in b.filters]
                      + [(n, True) for n in b.must_nots])
    slots = ([(t, w, REQ_W) for t, w in req]
             + [(t, w, 1.0) for t, w in fam]
             + [(t, w, 0.0) for t, w in bonus])
    if not slots and not filter_clauses:
        return None                            # empty bool = match_all
    if len(slots) > MAX_T:
        return None
    return FastSpec("bool", slots=slots, fam_msm=fam_msm,
                    filter_clauses=filter_clauses, field=field, sim=sim,
                    has_norms=has_norms, boost=float(b.boost),
                    const_score=0.0 if not slots else None)


def make_spec(lroot: C.LNode, window: int,
              body: dict) -> Optional[FastSpec]:
    """-> FastSpec for a term-group or bool plan the kernels serve, else
    None (the reference's `_body_eligible` and `_flatten_bool`)."""
    if window > MAX_K or window < 1 or not rungs_eligible(body):
        return None
    # pruning changes total-hit semantics on clamped terms (lower bound,
    # relation "gte"); an explicit track_total_hits demands exact counts,
    # so those bodies ride the dense kernel
    prune_ok = "track_total_hits" not in body
    if isinstance(lroot, C.LTerms):
        if next_pow2(len(lroot.terms), floor=1) > MAX_T:
            return None
        return FastSpec("pure", lt=lroot, field=lroot.field, window=window,
                        prune_ok=prune_ok and _ok_group(lroot))
    spec = _flatten_bool(lroot)
    if spec is not None:
        spec.window = window
        spec.prune_ok = prune_ok
    return spec


class _VQuery:
    """The kernel rows of one query over one segment: 1 row, one row per
    doc-range chunk, or its impact-head pruned form (`head=True`, 1 row).
    Row arrays are [n, T_pad]; dlo/dhi are [n]; weights f32[T_pad]."""

    __slots__ = ("T_pad", "L", "rowstarts", "nrows", "lens", "skips",
                 "weights", "msm", "avgdl", "dlo", "dhi", "k1", "b_eff",
                 "field", "head", "clamped", "miss", "msm_true", "rows",
                 "impact_pass", "eps")

    def __init__(self, **kw):
        self.head = False       # streams impact heads instead of full rows
        self.clamped = False    # at least one term's head excludes postings
        self.miss = None        # f32[T_pad]: w_t * remainder bound per term
        self.msm_true = 1.0     # real msm (the kernel gets 1 when clamped)
        self.rows = None        # i64[T_pad] term-dict rows (for rescore)
        self.impact_pass = False  # frontier pass rides the impact kernel
        self.eps = 0.0          # per-doc |exact - kernel| bound (impact
        #                         kernel only; 0.0 = exact f32 kernel)
        for k, v in kw.items():
            setattr(self, k, v)

    @property
    def n(self) -> int:
        return self.rowstarts.shape[0]


def _pow2_rows(n: np.ndarray, floor: int) -> np.ndarray:
    """Vectorized next_pow2 over row counts."""
    n = np.maximum(n, floor)
    return np.left_shift(1, np.ceil(np.log2(n)).astype(np.int64))


def _chunk_slots(slots: List[Optional[Tuple[np.ndarray, int]]], ndocs: int,
                 T_total: int, nchunk: int = 2) -> Optional[tuple]:
    """Split a query whose slot windows exceed the per-slot budget into
    doc-range chunks: uniform doc-id edges, verified against the exact
    per-(slot, chunk) posting counts, doubling the chunk count until every
    chunk fits. `slots[i]` = (sorted_docs, aligned_start_elem) or None for
    an absent slot. Returns (edges i64[nchunk+1], rowstarts, nrows, lens,
    skips each i32[nchunk, T_total], max_nr i64[nchunk]); None when no
    split within MAX_CHUNKS fits."""
    budget = MAX_TL // T_total        # elements per slot
    min_rows = HBM_ALIGN // LANES
    # start at the provably-needed chunk count instead of doubling up from
    # the caller's floor: a slot of L postings needs >= L/budget chunks
    max_len = max((len(s[0]) for s in slots if s is not None), default=0)
    if max_len > budget:
        nchunk = max(nchunk, next_pow2(-(-max_len // budget), floor=2))
    while nchunk <= MAX_CHUNKS:
        edges = np.linspace(0, ndocs, nchunk + 1).astype(np.int64)
        edges[-1] = np.int64(2**31 - 1)
        arrs = [np.zeros((nchunk, T_total), np.int32) for _ in range(4)]
        rowstarts, nrows, lens, skips = arrs
        max_nr = np.full(nchunk, min_rows, np.int64)
        ok = True
        for i, slot in enumerate(slots):
            if slot is None:
                continue
            seg_docs, start_el = slot
            # edges in the docs' own dtype: a mixed-dtype searchsorted
            # would first copy the whole posting row
            offs = np.searchsorted(seg_docs, edges.astype(seg_docs.dtype),
                                   "left").astype(np.int64)
            ln = offs[1:] - offs[:-1]
            here = ln > 0
            # a window starts at the 1024 tile below it; the spilled prefix
            # (which may belong to the previous row) is masked by `skip`
            abs_el = start_el + offs[:-1]
            dma_el = (abs_el // HBM_ALIGN) * HBM_ALIGN
            skip = abs_el - dma_el
            if np.any(here & (skip + ln > budget)):
                ok = False
                break
            nr = _pow2_rows((skip + ln + LANES - 1) // LANES, min_rows)
            rowstarts[here, i] = dma_el[here] // LANES
            nrows[here, i] = nr[here]
            lens[here, i] = ln[here]
            skips[here, i] = skip[here]
            max_nr = np.maximum(max_nr, np.where(here, nr, min_rows))
        if ok and not np.any(T_total * max_nr * LANES > MAX_TL):
            return edges, rowstarts, nrows, lens, skips, max_nr
        nchunk *= 2
    return None


def _impact_eps(plane, weights: np.ndarray, rows: np.ndarray, k1: float,
                b_eff: float, avgdl: float) -> float:
    """Sound per-doc |exact f32 score - impact-kernel score| bound: THE
    impactpath._error_bound serve margin."""
    from .impactpath import _error_bound
    return _error_bound(plane, weights, rows, k1, b_eff, avgdl)


def _prepare_vqueries(seg, ctx: C.ShardContext, lts: Sequence[C.LTerms],
                      avgdl_cache: dict, device: torch.device,
                      prune: Optional[Sequence[bool]] = None
                      ) -> List[Optional[_VQuery]]:
    """-> per input query, its kernel rows over `seg`; None = the segment
    holds no postings of the query's field (no hits there), DECLINED = the
    field is not `packable` or the rows need more than MAX_CHUNKS chunks.
    When `prune[qi]` is true the query streams impact heads and carries
    the verify metadata; otherwise the full rows, chunked when
    oversized."""
    out: list = []
    min_rows = HBM_ALIGN // LANES
    for qi, lt in enumerate(lts):
        if not packable(seg, lt.field):
            out.append(DECLINED)
            continue
        al = get_aligned(seg, lt.field, device)
        pb = seg.postings.get(lt.field)
        if al is None:
            out.append(None)
            continue
        nt = len(lt.terms)
        T_pad = next_pow2(nt, floor=1)
        rows = np.full(T_pad, -1, np.int64)
        for i, t in enumerate(lt.terms):
            rows[i] = pb.row(t)
        weights = np.zeros(T_pad, np.float32)
        if lt.mode == "score":
            weights[:nt] = np.asarray(lt.weights, np.float32)[:nt]
        # filter mode: zero weights, every match scores 0 in the kernel
        # and the constant boost is applied at assembly
        if lt.field not in avgdl_cache:
            avgdl_cache[lt.field] = np.float32(ctx.avgdl(lt.field))
        sim = lt.sim
        b_eff = float(sim.b) if lt.has_norms else 0.0
        common = dict(T_pad=T_pad, weights=weights, msm=float(lt.msm),
                      avgdl=avgdl_cache[lt.field], k1=float(sim.k1),
                      b_eff=b_eff, field=lt.field)
        use_head = bool(prune[qi]) if prune is not None else False
        src_starts = al.head_starts_rows if use_head else al.starts_rows
        src_lens = al.head_lens if use_head else al.lens

        # single-row case: every term's window fits the per-term bucket
        # (always true for heads: L_HEAD <= MAX_L)
        rowstarts = np.zeros(T_pad, np.int32)
        nrows = np.zeros(T_pad, np.int32)
        lens = np.zeros(T_pad, np.int32)
        skips = np.zeros(T_pad, np.int32)
        max_nr = min_rows
        fits = True
        clamped = False
        miss = np.zeros(T_pad, np.float32)
        for i, r in enumerate(rows):
            if r < 0:
                continue
            ln = int(src_lens[r])
            if use_head and al.clamped(int(r)):
                clamped = True
                miss[i] = float(weights[i]) * al.rem_bound(
                    int(r), float(sim.k1), b_eff, float(common["avgdl"]))
            if ln == 0:
                continue
            abs_el = int(src_starts[r]) * LANES
            dma_el = (abs_el // HBM_ALIGN) * HBM_ALIGN
            skip = abs_el - dma_el
            if skip + ln > MAX_L:
                fits = False
                break
            rowstarts[i] = dma_el // LANES
            nr = next_pow2((skip + ln + LANES - 1) // LANES, floor=min_rows)
            nrows[i] = nr
            lens[i] = ln
            skips[i] = skip
            max_nr = max(max_nr, nr)
        if fits and T_pad * max_nr * LANES <= MAX_TL:
            vq = _VQuery(L=max_nr * LANES, rowstarts=rowstarts[None],
                         nrows=nrows[None], lens=lens[None],
                         skips=skips[None], dlo=np.zeros(1, np.int32),
                         dhi=np.full(1, INT_MAX, np.int32), **common)
            if use_head:
                vq.head = True
                vq.clamped = clamped
                vq.miss = miss
                vq.msm_true = float(lt.msm)
                vq.rows = rows
                # codec-v2 frontier kernel: the head pass scores from the
                # aligned quantized plane and the verify rungs absorb the
                # kernel epsilon. Negative boosts void the one-sided error
                # bound; those stay on the exact tf.dl kernel
                plane = pb.impact
                if (plane is not None and al.d_imp is not None
                        and not np.any(weights[:nt] < 0)):
                    vq.impact_pass = True
                    vq.eps = _impact_eps(plane, weights, rows,
                                         float(sim.k1), b_eff,
                                         float(common["avgdl"]))
                if clamped and vq.msm_true > 1.0:
                    # the kernel collects by raw sum; the true msm filter
                    # runs in the exact rescore
                    vq.msm = 1.0
            out.append(vq)
            continue

        # oversized: doc-range chunk decomposition (every doc's postings
        # live in exactly one chunk, so sums, msm counts and totals stay
        # exact)
        slots = []
        for r in rows:
            if r < 0:
                slots.append(None)
                continue
            a, e = pb.row_slice(int(r))
            slots.append((pb.doc_ids[a:e], int(al.starts_rows[r]) * LANES))
        chunks = _chunk_slots(slots, seg.ndocs, T_pad)
        if chunks is None:
            out.append(DECLINED)
            continue
        edges, rowstarts, nrows, lens, skips, max_nr = chunks
        out.append(_VQuery(L=int(max_nr.max()) * LANES, rowstarts=rowstarts,
                           nrows=nrows, lens=lens, skips=skips,
                           dlo=edges[:-1].astype(np.int32),
                           dhi=edges[1:].astype(np.int32), **common))
    return out


# ---------------------------------------------------------------------
# launch and fetch
# ---------------------------------------------------------------------

def _keeps_lanes(vq: _VQuery) -> bool:
    """Clamped and impact-frontier rows keep all 128 output lanes: the
    verifier's unseen-doc bound uses the deepest kernel partial."""
    return vq.head and (vq.clamped or vq.impact_pass)


def _launch_groups(seg, vqs: List[Optional[_VQuery]], K: int,
                   device: torch.device) -> list:
    """LAUNCH stage: group kernel rows by shape, enqueue one kernel per
    group, and return the pending launches without any device sync:
    [(gvqs, K_launch, (scores, docs, totals)), ...]."""
    groups: dict = {}
    for vq in vqs:
        if vq is not None and vq is not DECLINED:
            # impact rows take no similarity params, so (k1, b) does not
            # split their groups
            key = ((vq.field, vq.T_pad, None, None, True) if vq.impact_pass
                   else (vq.field, vq.T_pad, vq.k1, vq.b_eff, False))
            groups.setdefault(key, []).append(vq)
    pending = []
    for (field, T_pad, k1, b_eff, impact), gvqs in groups.items():
        al = get_aligned(seg, field, device)
        # ONE launch per group: every row rides the group's largest L
        L = max(v.L for v in gvqs)
        K_launch = LANES if any(_keeps_lanes(v) for v in gvqs) else K
        if impact:
            # frontier pass on the quantized plane: weights fold
            # idf * boost * scale on the host in f32, so the kernel is ONE
            # multiply per posting
            assert getattr(seg, "codec_version", CODEC_V1) >= CODEC_V2
            scale = seg.postings[field].impact.scale
            STATS["impact_frontier"] += len(gvqs)
            pending.append((gvqs, K_launch, fused_bm25_topk_impact(
                al.d_docs, al.d_imp, *_launch_inputs(gvqs, device, scale),
                T=T_pad, L=L, K=K_launch)))
            continue
        pending.append((gvqs, K_launch, fused_bm25_topk_tfdl(
            al.d_docs, al.d_tfdl, *_launch_inputs(gvqs, device),
            T=T_pad, L=L, K=K_launch, k1=k1, b=b_eff)))
    return pending


def _upload(arrays: Sequence[np.ndarray], device: torch.device) -> list:
    """i32 / f32 host arrays on `device` in ONE host-to-device copy: views
    of one buffer, each in its own shape."""
    buf = torch.from_numpy(np.concatenate([
        np.ascontiguousarray(a).view(np.int32).ravel() for a in arrays])
    ).to(device)
    out, at = [], 0
    for a in arrays:
        t = buf[at:at + a.size]
        if a.dtype == np.float32:
            t = t.view(torch.float32)
        out.append(t.view(a.shape))
        at += a.size
    return out


def _cat(gvqs: Sequence, name: str, dtype) -> np.ndarray:
    """The row arrays `name` of a group's queries, concatenated."""
    return np.concatenate([getattr(v, name) for v in gvqs]).astype(dtype)


def _rep(gvqs: Sequence, name: str, width: int, dtype) -> np.ndarray:
    """A per-query vector (or scalar, width 1) `name` repeated over each
    query's rows: [rows, width]."""
    return np.concatenate([np.broadcast_to(getattr(v, name), (v.n, width))
                           for v in gvqs]).astype(dtype)


def _launch_inputs(gvqs: List[_VQuery], device: torch.device,
                   scale: Optional[float] = None) -> list:
    """The kernel inputs of a group's rows, in ONE host-to-device copy:
    rowstarts, nrows, lens, skips, weights, msm, avgdl, dlo, dhi for the
    tf.dl kernel; with the impact plane's `scale`, weights folded as
    f32(weights * f32(scale)) and no avgdl, for the impact kernel."""
    weights = _rep(gvqs, "weights", gvqs[0].T_pad, np.float32)
    if scale is not None:
        weights = (weights * np.float32(scale)).astype(np.float32)
    return _upload(
        [_cat(gvqs, a, np.int32)
         for a in ("rowstarts", "nrows", "lens", "skips")]
        + [weights]
        + [_rep(gvqs, a, 1, np.float32)
           for a in ("msm",) + (("avgdl",) if scale is None else ())]
        + [_cat(gvqs, a, np.int32).reshape(-1, 1) for a in ("dlo", "dhi")],
        device)


def _fetch_groups(pending: list, K: int) -> dict:
    """FETCH stage: id(vq) -> (scores, docs, total, "eq"), all groups'
    outputs in ONE device-to-host copy. A chunked query's rows merge their
    top-Ks here (score desc, doc asc, as the kernel)."""
    if not pending:
        return {}
    flat = []
    for _gvqs, kl, (scores, docs, totals) in pending:
        flat += [scores[:, :kl].reshape(-1).view(torch.int32),
                 docs[:, :kl].reshape(-1), totals[:, 0]]
    host = torch.cat(flat).cpu().numpy()
    results = {}
    at = 0
    for gvqs, kl, (scores, _d, _t) in pending:
        QB = scores.shape[0]
        sc = host[at:at + QB * kl].view(np.float32).reshape(QB, kl)
        at += QB * kl
        dc = host[at:at + QB * kl].reshape(QB, kl)
        at += QB * kl
        tot = host[at:at + QB].astype(np.int64)
        at += QB
        row = 0
        for vq in gvqs:
            s, d = sc[row:row + vq.n], dc[row:row + vq.n]
            total = int(tot[row:row + vq.n].sum())
            row += vq.n
            if vq.n == 1:
                keep = kl if _keeps_lanes(vq) else K
                results[id(vq)] = (s[0, :keep], d[0, :keep], total, "eq")
                continue
            s_all, d_all = s[:, :K].ravel(), d[:, :K].ravel()
            key = np.where(d_all >= 0, d_all.astype(np.int64),
                           np.int64(np.iinfo(np.int64).max))
            order = np.lexsort((key, -s_all))[:K]
            results[id(vq)] = (s_all[order], d_all[order], total, "eq")
    return results


def _launch_pure_groups(seg, vqs: List[Optional[_VQuery]], K: int,
                        device: torch.device) -> dict:
    """Synchronous launch + fetch (the escalation rungs)."""
    return _fetch_groups(_launch_groups(seg, vqs, K, device), K)


# ---------------------------------------------------------------------
# verify: the unseen-doc bounds
# ---------------------------------------------------------------------

def _unseen_bound(al: AlignedPostings, pb, dl_col, vq: _VQuery,
                  partial_k: float) -> float:
    """Max possible TRUE score of any doc OUTSIDE the kernel's candidate
    set. An unseen doc misses some subset S of the clamped terms' heads;
    its score is at most min(partial_k, sum of full bounds of the terms
    not in S) plus the remainder bounds of S, maximized over nonempty S.
    S = {} is no threat when msm == 1 on the exact kernel (the kernel
    already ranked the loser); with msm > 1, or on the impact kernel (its
    partials live in the quantized domain, and callers pass partial_k
    already inflated by eps), it stays in."""
    T = len(vq.rows)
    cl = [i for i in range(T) if vq.miss is not None and vq.miss[i] > 0.0]
    fb = np.zeros(T, np.float32)
    for i, r in enumerate(vq.rows):
        if r >= 0:
            fb[i] = vq.weights[i] * al.full_bound(
                pb, int(r), vq.k1, vq.b_eff, float(vq.avgdl), dl_col)
    best = partial_k if (vq.msm_true > 1.0 or vq.eps > 0.0) else -np.inf
    for mask in range(1, 1 << len(cl)):
        in_s = [cl[j] for j in range(len(cl)) if mask >> j & 1]
        rem_part = float(sum(vq.miss[i] for i in in_s))
        inhead = float(sum(fb[i] for i in range(T) if i not in in_s))
        best = max(best, min(partial_k + rem_part, inhead + rem_part))
    return best


def _tie_serves(al: AlignedPostings, vq: _VQuery, theta: float,
                cand: np.ndarray, order: np.ndarray, window: int) -> bool:
    """Boundary-tie witness for SINGLE-term pruned queries: when the
    unseen bound exactly ties theta, only remainder postings on the
    frontier points whose contribution equals theta can attain it; they
    displace the window only if one sorts before the window's worst member
    by doc id, so min attaining id > id(window[-1]) proves the page."""
    if len(vq.rows) != 1 or theta == -np.inf:
        return False
    fr = al.rem_frontiers.get(int(vq.rows[0]))
    if fr is None or len(fr) != 4:
        return False
    tfv, dlv, id_dlmin, id_any = fr
    if len(tfv) == 0:
        return False
    # mirror `_exact_rescore`'s arithmetic (same dtypes, same op order) so
    # the tie test is bit-exact in the f32 domain theta lives in
    avg = max(float(vq.avgdl), 1e-9)
    kfac = vq.k1 * (1.0 - vq.b_eff + vq.b_eff * dlv / avg)
    contrib = (vq.weights[0] * tfv / (tfv + kfac)).astype(np.float32)
    theta32 = np.float32(theta)
    if np.any(contrib > theta32):
        return False                      # genuinely above: real displacer
    att = contrib == theta32
    if not att.any():
        return True                       # no remainder doc reaches theta
    # the dl_min witness covers a point only when one dl step strictly
    # lowers the f32 contribution; otherwise the whole-tf-class min id
    kfac2 = vq.k1 * (1.0 - vq.b_eff
                     + vq.b_eff * (dlv + np.float32(1.0)) / avg)
    contrib2 = (vq.weights[0] * tfv / (tfv + kfac2)).astype(np.float32)
    ids = np.where(contrib2 < contrib, id_dlmin, id_any)
    return int(ids[att].min()) > int(cand[order[window - 1]])


def _tie_key(seg, cand: np.ndarray) -> np.ndarray:
    """Tie-break key for host (score, tie) sorts: the doc id itself (the
    port has no doc-id reorder, so doc order IS arrival order). Returns
    `cand` itself: `_verify_pruned` tests the identity."""
    return cand


def _exact_rescore(seg, vq: _VQuery, cand: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact scores + per-term match counts of `cand` against the FULL
    rows (vectorized searchsorted per term): the host oracle."""
    pb = seg.postings.get(vq.field)
    dl = seg.doc_lens.get(vq.field)
    dl_c = (dl[cand].astype(np.float32) if dl is not None
            else np.zeros(len(cand), np.float32))
    kfac = vq.k1 * (1.0 - vq.b_eff
                    + vq.b_eff * dl_c / max(float(vq.avgdl), 1e-9))
    exact = np.zeros(len(cand), np.float32)
    counts = np.zeros(len(cand), np.int64)
    for i, r in enumerate(vq.rows):
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
        exact += np.where(found, vq.weights[i] * tf / (tf + kfac),
                          0.0).astype(np.float32)
        counts += found
    return exact, counts


def _noheads_bound(al: AlignedPostings, vq: _VQuery,
                   frontier_of=None, rows_all: bool = False) -> float:
    """Max TRUE score of any doc outside EVERY queried head: all of its
    contributions come from clamped remainders and share ONE doc length
    d, so bound = max_d sum_t w_t * max{tf/(tf+k(d)) : (tf, dlmin) in the
    remainder frontier of t, dlmin <= d}, with d over the frontier dl
    minima; grid points with fewer than msm feasible terms are skipped.
    `frontier_of` overrides the per-row remainder frontier (tier-2 heads,
    the quality view); `rows_all` makes every valid row participate."""
    if rows_all:
        cl = [i for i, r in enumerate(vq.rows) if r >= 0]
    else:
        cl = [i for i, r in enumerate(vq.rows)
              if r >= 0 and al.clamped(int(r))]
    if not cl:
        return -np.inf
    fronts = []
    ds = []
    for i in cl:
        row = int(vq.rows[i])
        fr = (frontier_of(row) if frontier_of is not None
              else al.rem_frontiers.get(row))
        if fr is None:
            continue
        tfv = np.asarray(fr[0], np.float64)
        dlv = np.asarray(fr[1], np.float64)
        if len(tfv):
            fronts.append((i, tfv, dlv))
            ds.append(dlv)
    if not fronts:
        return -np.inf
    avg = max(float(vq.avgdl), 1e-9)
    best = -np.inf
    for d in np.unique(np.concatenate(ds)):
        k = max(vq.k1 * (1.0 - vq.b_eff + vq.b_eff * float(d) / avg),
                1e-9)
        total = 0.0
        nfeas = 0
        for i, tfv, dlv in fronts:
            feas = dlv <= d
            if not feas.any():
                continue
            nfeas += 1
            total += float(vq.weights[i]) * float(
                np.max(tfv[feas] / (tfv[feas] + k)))
        if nfeas and nfeas >= vq.msm_true:
            best = max(best, total)
    return best


def _verify_pruned(seg, vq: _VQuery, sc: np.ndarray, dc: np.ndarray,
                   total: int, window: int, K: int,
                   device: torch.device) -> Optional[tuple]:
    """Prove a clamped pruned result exact, or None -> escalate. The
    candidates are exact-rescored on the host, and the page is accepted
    iff the `_unseen_bound` subset analysis proves no unseen doc can
    displace it. Totals become a lower bound (relation "gte")."""
    pb = seg.postings.get(vq.field)
    dl = seg.doc_lens.get(vq.field)
    al = get_aligned(seg, vq.field, device)
    valid = np.isfinite(sc) & (dc >= 0)
    cand = dc[valid].astype(np.int64)
    if len(cand) == 0:
        # heads matched nothing; matches could still exist past the heads
        if any(vq.miss[i] > 0 for i in range(len(vq.rows))):
            return None
        return (sc[:K], dc[:K], total, "eq")
    exact, counts = _exact_rescore(seg, vq, cand)
    pass_msm = counts >= vq.msm_true
    n_pass = int(pass_msm.sum())
    exact_m = np.where(pass_msm, exact, -np.inf).astype(np.float32)
    # the unseen-doc in-head bound: the DEEPEST kernel partial (zero when
    # the window wasn't full); impact partials + eps lift it to a sound
    # exact-domain bound (eps == 0.0 on the tf.dl kernel)
    partial_k = (float(sc[valid][-1]) + vq.eps
                 if len(cand) == len(sc) else 0.0)
    bound = _unseen_bound(al, pb, dl, vq, partial_k)
    tie = _tie_key(seg, cand)
    order = np.lexsort((tie, -exact_m))
    theta = (float(exact_m[order[window - 1]]) if n_pass >= window
             else -np.inf)
    # >= not >: frontier bounds are ATTAINED, so an unseen doc can tie
    # theta; equality escalates unless the tie witness proves every
    # attaining doc sorts after the window (exact kernel only)
    if bound >= theta:
        if (vq.eps > 0.0 or tie is not cand
                or not _tie_serves(al, vq, theta, cand, order, window)):
            return None
    keep = order[pass_msm[order]][:K]
    sc2 = np.full(K, -np.inf, np.float32)
    dc2 = np.full(K, -1, np.int32)
    sc2[: len(keep)] = exact_m[keep]
    dc2[: len(keep)] = cand[keep]
    total_out = n_pass if vq.msm_true > 1 else total
    return (sc2, dc2, total_out, "gte")


def _verify_impact_exact(seg, vq: _VQuery, sc: np.ndarray, dc: np.ndarray,
                         total: int, window: int, K: int) -> Optional[tuple]:
    """Certify an UNCLAMPED impact-kernel frontier pass (the heads were
    the full rows, but the partials are quantized-domain): the candidates
    are exact-rescored; when the kernel window wasn't full they are every
    matching doc, else a seen-but-lost doc's exact score is <= the
    deepest extracted partial + eps and must sit under theta. Totals are
    exact either way."""
    valid = np.isfinite(sc) & (dc >= 0)
    cand = dc[valid].astype(np.int64)
    if len(cand) == 0:
        return (sc[:K], dc[:K], total, "eq")    # truly empty result set
    exact, counts = _exact_rescore(seg, vq, cand)
    pass_msm = counts >= vq.msm_true
    n_pass = int(pass_msm.sum())
    exact_m = np.where(pass_msm, exact, -np.inf).astype(np.float32)
    order = np.lexsort((_tie_key(seg, cand), -exact_m))
    if len(cand) == len(sc):
        theta = (float(exact_m[order[window - 1]]) if n_pass >= window
                 else -np.inf)
        bound = float(sc[valid][-1]) + vq.eps
        # equality escalates: a lost doc's exact score can tie theta
        if bound >= theta:
            return None
    keep = order[pass_msm[order]][:K]
    sc2 = np.full(K, -np.inf, np.float32)
    dc2 = np.full(K, -1, np.int32)
    sc2[: len(keep)] = exact_m[keep]
    dc2[: len(keep)] = cand[keep]
    return (sc2, dc2, total, "eq")


# ---------------------------------------------------------------------
# phase 2: the candidate-union rescore
# ---------------------------------------------------------------------

def _p2_candidates(vq: _VQuery, pb, ids_of) -> Optional[np.ndarray]:
    """The candidate union of one query: every doc any queried head
    mentions (`ids_of(row)`; None = the head is the full row)."""
    ids = []
    for r in vq.rows:
        if r < 0:
            continue
        r = int(r)
        hid = ids_of(r)
        if hid is None:
            a, b = pb.row_slice(r)
            hid = pb.doc_ids[a:b]
        ids.append(np.asarray(hid, np.int64))
    if not ids:
        return None
    cand = np.unique(np.concatenate(ids))
    return cand if len(cand) else None


def _p2_decide(al: AlignedPostings, vq: _VQuery, cand: np.ndarray,
               exact: np.ndarray, counts: np.ndarray, window: int, K: int,
               frontier_of, tie: Optional[np.ndarray] = None
               ) -> Optional[tuple]:
    """Serve-or-escalate decision on exact-rescored candidates: certify the
    window against the dl-consistent `_noheads_bound` or return None."""
    pass_msm = counts >= vq.msm_true
    n_pass = int(pass_msm.sum())
    exact_m = np.where(pass_msm, exact, -np.inf).astype(np.float32)
    order = np.lexsort((cand if tie is None else tie, -exact_m))
    theta = (float(exact_m[order[window - 1]]) if n_pass >= window
             else -np.inf)
    bound = _noheads_bound(al, vq, frontier_of)
    # equality escalates (frontier bounds are attained), as in phase 1
    if bound >= theta:
        return None
    keep = order[pass_msm[order]][:K]
    sc2 = np.full(K, -np.inf, np.float32)
    dc2 = np.full(K, -1, np.int32)
    sc2[: len(keep)] = exact_m[keep]
    dc2[: len(keep)] = cand[keep].astype(np.int32)
    return (sc2, dc2, n_pass, "gte")


def _rescore_many(seg, jobs: List[tuple],
                  device: torch.device) -> List[tuple]:
    """Exact scores + match counts for a batch of (vq, cand) rescore jobs:
    on the card, batched device launches over the resident aligned
    buffers (`_rescore_many_device`); on the CPU, the host oracle
    `_exact_rescore` per job."""
    if not jobs:
        return []
    if device.type != "cuda":
        return [_exact_rescore(seg, vq, cand) for vq, cand in jobs]
    return _rescore_many_device(seg, jobs, device)


def _rescore_many_device(seg, jobs: List[tuple],
                         device: torch.device) -> List[tuple]:
    """One `ops/rescore.exact_rescore_batch` launch per (field, T,
    candidate bucket, similarity) group and budget step; a job whose union
    exceeds every bucket, or whose offsets pass i32, takes the host pass."""
    from ..ops.rescore import exact_rescore_batch, rescore_elem_budget

    out: List[Optional[tuple]] = [None] * len(jobs)
    groups: dict = {}
    for j, (vq, cand) in enumerate(jobs):
        cb = C.rescore_cand_bucket(len(cand))
        al = get_aligned(seg, vq.field, device)
        if (cb is None or al is None
                or int(al.starts_rows[-1] + 1) * LANES + int(al.lens[-1])
                > 2**31 - 1):
            out[j] = _exact_rescore(seg, vq, cand)
            continue
        key = (vq.field, len(vq.rows), cb, vq.k1, vq.b_eff)
        groups.setdefault(key, []).append(j)
    for (field, T, cb, k1, b_eff), idxs in groups.items():
        al = get_aligned(seg, field, device)
        step = rescore_elem_budget(T, cb)
        for lo in range(0, len(idxs), step):
            part = idxs[lo: lo + step]
            QB = next_pow2(len(part), floor=1)
            starts = np.zeros((QB, T), np.int32)
            lens = np.zeros((QB, T), np.int32)
            weights = np.zeros((QB, T), np.float32)
            avgdl = np.ones((QB, 1), np.float32)
            cands = np.full((QB, cb), INT_MAX, np.int32)
            for qj, j in enumerate(part):
                vq, cand = jobs[j]
                for i, r in enumerate(vq.rows):
                    if r < 0:
                        continue
                    starts[qj, i] = int(al.starts_rows[int(r)]) * LANES
                    lens[qj, i] = int(al.lens[int(r)])
                weights[qj] = vq.weights
                avgdl[qj, 0] = vq.avgdl
                cands[qj, : len(cand)] = cand.astype(np.int32)
            ops = [torch.from_numpy(a).to(device)
                   for a in (starts, lens, weights, avgdl, cands)]
            exact, counts = exact_rescore_batch(al.d_docs, al.d_tfdl, *ops,
                                                T=T, C=cb, k1=k1, b=b_eff)
            exact, counts = exact.cpu().numpy(), counts.cpu().numpy()
            for qj, j in enumerate(part):
                n = len(jobs[j][1])
                out[j] = (exact[qj, :n], counts[qj, :n].astype(np.int64))
    return out


def _phase2_batch(seg, vq_lists, specs: Sequence, results: dict,
                  redo: List[int], K: int,
                  device: torch.device) -> List[int]:
    """Candidate-union escalation, batched across every query the phase-1
    verify failed: rescore each query's head union (every doc any head
    mentions) exactly and certify it against `_noheads_bound`; the tail
    retries on lazily built 4x deeper tier-2 heads. Returns the queries
    still unproven (-> quality tier, then dense). Totals stay "gte"."""
    jobs: List[tuple] = []
    meta: List[tuple] = []          # (qi, vq, cand)
    still: List[int] = []
    for qi in redo:
        vq = vq_lists[qi]
        pb = seg.postings.get(vq.field)
        al = get_aligned(seg, vq.field, device)
        cand = _p2_candidates(vq, pb, al.head_ids.get)
        if cand is None:
            still.append(qi)
            continue
        jobs.append((vq, cand))
        meta.append((qi, vq, cand))
    tier2: List[tuple] = []
    for (qi, vq, cand), (exact, counts) in zip(
            meta, _rescore_many(seg, jobs, device)):
        al = get_aligned(seg, vq.field, device)
        ver = _p2_decide(al, vq, cand, exact, counts,
                         int(specs[qi].window or K), K, None,
                         tie=_tie_key(seg, cand))
        if ver is not None:
            results[id(vq)] = ver
            STATS["pruned_rescued"] += 1
        else:
            tier2.append((qi, vq))
    jobs2: List[tuple] = []
    meta2: List[tuple] = []
    for qi, vq in tier2:
        pb = seg.postings.get(vq.field)
        al = get_aligned(seg, vq.field, device)
        dl_col = seg.doc_lens.get(vq.field)
        h2 = {int(r): al.head2(pb, dl_col, int(r))
              for r in vq.rows if r >= 0 and al.clamped(int(r))}
        cand = _p2_candidates(
            vq, pb, lambda row: h2[row][0] if row in h2 else None)
        if cand is None:
            still.append(qi)
            continue
        jobs2.append((vq, cand))
        meta2.append((qi, vq, cand, h2))
    for (qi, vq, cand, h2), (exact, counts) in zip(
            meta2, _rescore_many(seg, jobs2, device)):
        al = get_aligned(seg, vq.field, device)
        ver = _p2_decide(al, vq, cand, exact, counts,
                         int(specs[qi].window or K), K,
                         lambda row, _h2=h2, _al=al:
                         _h2[row][1] if row in _h2
                         else _al.rem_frontiers.get(row),
                         tie=_tie_key(seg, cand))
        if ver is not None:
            results[id(vq)] = ver
            STATS["pruned_rescued"] += 1
            STATS["pruned_rescued2"] += 1
        else:
            still.append(qi)
    return still


# ---------------------------------------------------------------------
# the quality-tier rung: a dense launch over a filtered view
# ---------------------------------------------------------------------

class FilterList:
    """The ANDed filter clauses of a bool spec over one segment: the
    sorted doc list (`host_docs`, and per device a sentinel-padded buffer
    with MAX_L slack that the bool kernel's filter slot reads), its bitmap
    (`pack_bits`, what the kernel's probe form reads), the dense mask when
    the filter is dense enough to ever take filter-specialized postings,
    and how often a query has used it (`hits`). The quality tier uses the
    mask part alone."""

    __slots__ = ("host_docs", "n", "nbytes", "mask", "bits", "key", "hits",
                 "_dev")

    def __init__(self, host_docs: Optional[np.ndarray], n: int, nbytes: int,
                 mask: Optional[np.ndarray], key,
                 bits: Optional[torch.Tensor] = None):
        self.host_docs = host_docs    # i32 sorted doc ids
        self.n = n
        self.nbytes = nbytes          # device list + kept mask, as the
        #                               reference charges them, + bitmap
        self.mask = mask              # dense bool[ndocs], or None
        self.bits = bits              # pack_bits of the filter, on the
        #                               device that built it
        self.key = key
        self.hits = 0
        self._dev: dict = {}

    def d_docs(self, device: torch.device) -> torch.Tensor:
        """The padded doc list on `device` (copied on first use)."""
        key = str(device)
        if key not in self._dev:
            total = ((self.n + LANES - 1) // LANES) * LANES + MAX_L
            buf = np.full(total, INT_SENTINEL, np.int32)
            buf[:self.n] = self.host_docs
            self._dev[key] = torch.from_numpy(buf).to(device)
        return self._dev[key]

    def d_bits(self, device: torch.device) -> torch.Tensor:
        """The bitmap on `device` (copied on first use)."""
        key = ("bits", str(device))
        if key not in self._dev:
            self._dev[key] = self.bits.to(device)
        return self._dev[key]


MAX_FILTER_LISTS = 32          # per segment, least recently used first out
MATERIALIZE_MIN_DOCS = 1 << 18  # a filter list this long or shorter...
MATERIALIZE_DENSITY = 8         # ...or under 1/8 of the docs is never dense


def _filter_list(seg, ctx, clauses,
                 device: torch.device) -> Optional[FilterList]:
    """The FilterList of [(node, negated), ...] over `seg`, cached per
    segment (LRU of MAX_FILTER_LISTS) under the clauses' mask keys; None
    (the body is declined) where a clause's phrase pairs are too large
    for the reference to hash, as its fastpath declines them."""
    if any(C.reference_param_bytes(node, seg) > C.FILTER_HASH_BYTE_CAP
           for node, _neg in clauses):
        return None
    cache = seg.__dict__.setdefault("filter_lists",
                                    collections.OrderedDict())
    key = tuple((filters.mask_key(node, seg, ctx), neg)
                for node, neg in clauses)
    fl = cache.get(key)
    if fl is not None:
        cache.move_to_end(key)
        return fl
    combined = torch.ones(seg.ndocs, dtype=torch.bool, device=device)
    for node, neg in clauses:
        m = filters.filter_mask(node, seg, ctx, device)
        combined &= ~m if neg else m
    docs = torch.nonzero(combined).flatten().to(torch.int32).cpu().numpy()
    n = len(docs)
    bits = pack_bits(combined)
    # keep the dense mask only when this filter could ever take the
    # filter-specialized postings
    dense_capable = (n > MATERIALIZE_MIN_DOCS
                     and n * MATERIALIZE_DENSITY > seg.ndocs)
    mask = combined.cpu().numpy() if dense_capable else None
    nbytes = 4 * (((n + LANES - 1) // LANES) * LANES + MAX_L) + (
        mask.nbytes if mask is not None else 0) + 4 * bits.numel()
    fl = FilterList(docs, n, nbytes, mask, key, bits)
    while len(cache) >= MAX_FILTER_LISTS:
        cache.popitem(last=False)
    cache[key] = fl
    return fl


def _dense_hot(seg, fl: FilterList, nslots: int) -> bool:
    """Filter-specialized postings when the filter is dense (mask kept)
    AND either repeated (hits are counted after this check, so >= 1 means
    a second use) or too long for the filter slot's chunks at all."""
    if fl.mask is None:
        return False
    ts = next_pow2(max(nslots, 1), floor=1)
    list_cap = MAX_CHUNKS * (MAX_TL // (2 * ts))
    return fl.hits >= 1 or fl.n > list_cap // 2


class FilteredPostings:
    """Filter-specialized postings of one (segment, field, filter): the
    term rows of `field` restricted to filter-passing docs, on the host.
    Their aligned rows without heads (what the bool kernel reads, the
    reference's `fp.al`) and their segment view (what the pruned pipeline
    reads) are built on first use, each on its own, and copied to each
    device that asks."""

    __slots__ = ("starts", "host_docs", "host_tfs", "view", "_al")

    def __init__(self, starts: np.ndarray, host_docs: np.ndarray,
                 host_tfs: np.ndarray):
        self.starts = starts        # i64[nterms+1] filtered CSR row bounds
        self.host_docs = host_docs  # i32 filtered doc ids
        self.host_tfs = host_tfs    # f32 filtered tfs
        self.view = None            # lazy FilteredSegView
        self._al: dict = {}         # device -> AlignedPostings


def _filtered_postings(seg, field: str,
                       fl: FilterList) -> Optional[FilteredPostings]:
    """Cached per (field, filter) on the segment; None when the segment
    holds no postings of the field."""
    key = ("filtered", field, fl.key)
    if key in seg.aligned:
        return seg.aligned[key]
    fp = None
    pb = seg.postings.get(field)
    if pb is not None and pb.size > 0:
        keep = fl.mask[pb.doc_ids]
        kc = np.zeros(len(pb.doc_ids) + 1, np.int64)
        np.cumsum(keep, out=kc[1:])
        fp = FilteredPostings(kc[pb.starts], pb.doc_ids[keep],
                              pb.tfs[keep])
    seg.aligned[key] = fp
    return fp


def _filtered_rows(seg, field: str, fp: FilteredPostings,
                   device: torch.device) -> AlignedPostings:
    """The aligned rows of filter-specialized postings on `device` (a
    second device copies the first one's)."""
    key = str(device)
    if key not in fp._al:
        other = next(iter(fp._al.values()), None)
        if other is not None:
            fp._al[key] = _copy_aligned(other, device)
        else:
            _dl, packed = _pack_tfdl(seg, field, fp.host_docs, fp.host_tfs)
            a_starts, a_docs, a_packed = align_csr_rows(
                fp.starts, fp.host_docs, packed, margin=MAX_L,
                alignment=LANES)
            fp._al[key] = AlignedPostings(
                (a_starts[:-1] // LANES).astype(np.int64),
                np.diff(fp.starts).astype(np.int64),
                torch.from_numpy(a_docs).to(device),
                torch.from_numpy(a_packed).to(device))
    return fp._al[key]


class FilteredSegView:
    """Segment facade over filter-specialized postings: the filtered CSR
    (ORIGINAL doc ids) as a one-field segment, so the dense pipeline runs
    unchanged on it. Doc lengths come from the real segment; docs outside
    the filter appear in no row."""

    def __init__(self, seg, field: str, fp: FilteredPostings):
        pb = seg.postings[field]
        self.name = f"{seg.name}|filtered"
        self.ndocs = seg.ndocs
        self.live_count = seg.live_count
        self.postings = {field: PostingsBlock(
            field=field, vocab=pb.vocab, terms=pb.terms,
            starts=fp.starts.astype(np.int64), doc_ids=fp.host_docs,
            tfs=fp.host_tfs)}
        self.doc_lens = seg.doc_lens
        self.aligned: dict = {}


def _filtered_view(seg, field: str, fp: FilteredPostings,
                   device: torch.device) -> FilteredSegView:
    """The segment view of filter-specialized postings, with its aligned
    layout on `device` (a second device copies the first one's)."""
    if fp.view is None:
        fp.view = FilteredSegView(seg, field, fp)
    get_aligned(fp.view, field, device)
    return fp.view


def _quality_tier(seg, field: str, device: torch.device):
    """Query-independent static pruning: keep the ~1/QUALITY_SHARE docs
    whose BEST per-posting nominal impact is highest. Scores on the view
    are EXACT for view docs (the view restricts DOCS), and every posting
    of an outside doc has nominal impact < tau, so the per-row
    out-of-view frontiers certify a served window. One vectorized pass
    per (segment, field), cached. Returns (FilterList, frontier_of) or
    None (segment too small, or a facade without a `uid`)."""
    key = ("quality", field, str(device))
    if key in seg.aligned:
        return seg.aligned[key]
    out = None
    pb = seg.postings.get(field)
    dl = seg.doc_lens.get(field)
    if (pb is not None and pb.size > 0 and seg.ndocs >= QUALITY_MIN_NDOCS
            and getattr(seg, "uid", None) is not None
            and get_aligned(seg, field, device) is not None):
        imp = _plane_impacts(pb)
        if imp is None:
            dl_of = (dl[pb.doc_ids].astype(np.float32) if dl is not None
                     else np.zeros(len(pb.doc_ids), np.float32))
            avg = max(float(dl_of.mean()), 1.0)
            imp = _nominal_impact(pb.tfs, dl_of, avg)
        docmax = np.zeros(seg.ndocs, np.float32)
        np.maximum.at(docmax, pb.doc_ids, imp)
        target = max(seg.ndocs // QUALITY_SHARE, QUALITY_MIN_NDOCS // 4)
        tau = np.float32(np.partition(docmax, seg.ndocs - target)
                         [seg.ndocs - target])
        mask = docmax >= tau
        # impact ties at tau can inflate the kept set far past the
        # target: decline rather than launch a near-dense-sized view
        n = int(mask.sum())
        if 0 < n <= 2 * target:
            fl = FilterList(None, n, mask.nbytes + 4 * n, mask,
                            ("_quality", field, QUALITY_SHARE))
            frontiers: dict = {}

            def frontier_of(row: int, _f=frontiers, _pb=pb, _dl=dl,
                            _mask=mask):
                fr = _f.get(row)
                if fr is None:
                    a, b = _pb.row_slice(row)
                    rd = _pb.doc_ids[a:b]
                    sel = ~_mask[rd]
                    dls = (_dl[rd[sel]].astype(np.float32)
                           if _dl is not None
                           else np.zeros(int(sel.sum()), np.float32))
                    fr = _frontier(_pb.tfs[a:b][sel], dls)
                    _f[row] = fr
                return fr

            out = (fl, frontier_of)
    seg.aligned[key] = out
    return out


def _dview_rescue(seg, ctx, lts: Sequence, specs: Sequence, vq_lists,
                  results: dict, redo: List[int], K: int,
                  device: torch.device) -> List[int]:
    """Quality-tier escalation rung: ALL still-unproven queries as one
    batched dense launch per field over the quality view, each certified
    against the out-of-view frontiers. Returns the queries that still
    need the full dense pass."""
    by_field: dict = {}
    for qi in redo:
        by_field.setdefault(vq_lists[qi].field, []).append(qi)
    still: List[int] = []
    for field, qis in by_field.items():
        still.extend(_dview_rescue_field(seg, ctx, lts, specs, vq_lists,
                                         results, qis, K, field, device))
    STATS["pruned_dview"] += len(redo) - len(still)
    return still


def _dview_rescue_field(seg, ctx, lts: Sequence, specs: Sequence, vq_lists,
                        results: dict, redo: List[int], K: int, field: str,
                        device: torch.device) -> List[int]:
    qt = _quality_tier(seg, field, device)
    if qt is None:
        return redo
    fl, frontier_of = qt
    fp = _filtered_postings(seg, field, fl)
    if fp is None:
        return redo
    view = _filtered_view(seg, field, fp, device)
    al = get_aligned(seg, field, device)
    dvqs = _prepare_vqueries(view, ctx, [lts[qi] for qi in redo], {},
                             device)
    vres = _launch_pure_groups(view, dvqs, K, device)
    still = []
    for qi, dvq in zip(redo, dvqs):
        served = False
        if dvq is not None and dvq is not DECLINED:
            sc, dc, total, _ = vres[id(dvq)]
            valid = np.isfinite(sc) & (dc >= 0)
            window = int(specs[qi].window or K)
            theta = (float(sc[valid][window - 1])
                     if int(valid.sum()) >= window else -np.inf)
            # the ORIGINAL (pruned) vq carries .rows/.weights: the same
            # term rows as the view launch
            ovq = vq_lists[qi]
            bound = _noheads_bound(al, ovq, frontier_of, rows_all=True)
            if bound < theta:
                results[id(ovq)] = (sc[:K], dc[:K], int(total), "gte")
                served = True
        if not served:
            still.append(qi)
    return still


# ---------------------------------------------------------------------
# the pure term-group path
# ---------------------------------------------------------------------

def _launch_pure(seg, ctx, lts: Sequence, specs: Sequence[FastSpec], K: int,
                 device: torch.device) -> tuple:
    """LAUNCH stage: kernel rows (heads for prune-eligible specs) and the
    frontier pass, enqueued but unfetched."""
    prune = [bool(s.prune_ok) for s in specs]
    vq_lists = _prepare_vqueries(seg, ctx, lts, {}, device, prune=prune)
    return vq_lists, _launch_groups(seg, vq_lists, K, device)


def _finish_pure(seg, ctx, lts: Sequence, specs: Sequence[FastSpec], K: int,
                 state: tuple, device: torch.device) -> List[dict]:
    """FETCH stage: one device sync for the frontier pass, then the host
    verify and the escalation ladder (whose rungs launch and sync their
    own device work), and final assembly."""
    vq_lists, pending = state
    results = _fetch_groups(pending, K)
    redo = []
    for qi, vq in enumerate(vq_lists):
        if vq is None or vq is DECLINED or not vq.head:
            continue
        if not vq.clamped and not vq.impact_pass:
            continue                # heads were the full rows: exact
        sc, dc, total, _ = results[id(vq)]
        window = int(specs[qi].window or K)
        if vq.clamped:
            ver = _verify_pruned(seg, vq, sc, dc, total, window, K, device)
        else:
            ver = _verify_impact_exact(seg, vq, sc, dc, total, window, K)
        if ver is None:
            redo.append(qi)
        else:
            results[id(vq)] = ver
    before = redo
    if redo:
        redo = _phase2_batch(seg, vq_lists, specs, results, redo, K,
                             device)
    if redo:
        redo = _dview_rescue(seg, ctx, lts, specs, vq_lists, results, redo,
                             K, device)
    # rescued CLAMPED queries only: `pruned_served` counts clamped heads
    rescued_clamped = sum(1 for qi in set(before) - set(redo)
                          if vq_lists[qi].clamped)
    if redo:
        STATS["pruned_escalated"] += len(redo)
        dense = _prepare_vqueries(seg, ctx, [lts[qi] for qi in redo], {},
                                  device)
        for qi, dvq in zip(redo, dense):
            vq_lists[qi] = dvq
        results.update(_launch_pure_groups(seg, dense, K, device))
    STATS["pruned_served"] += sum(
        1 for vq in vq_lists
        if vq is not None and vq is not DECLINED and vq.head
        and vq.clamped) - rescued_clamped
    return _assemble(vq_lists, results, _filter_mode_boost(lts))


def _assemble(vq_lists: Sequence, results: dict,
              transform=None) -> List[Optional[dict]]:
    """Per-query outputs (None for a DECLINED query); `transform(qi,
    scores)` maps a query's kernel scores to its final ones (a boost, a
    constant score)."""
    out: List[Optional[dict]] = []
    for qi, vq in enumerate(vq_lists):
        if vq is DECLINED:
            out.append(None)
            continue
        if vq is None:
            sc = np.full(0, -np.inf, np.float32)
            dc = np.full(0, -1, np.int32)
            total, rel = 0, "eq"
        else:
            sc, dc, total, rel = results[id(vq)]
        if transform is not None:
            sc = transform(qi, sc)
        total = int(total)
        ms = (float(sc[0]) if total > 0 and len(sc) and np.isfinite(sc[0])
              else -np.inf)
        out.append({"topk_idx": dc, "topk_scores": sc, "total": total,
                    "max_score": ms, "total_rel": rel})
    return out


def _filter_mode_boost(lts: Sequence):
    """The pure path's transform: a filter-mode (terms) query scores every
    match with its constant boost."""
    def transform(qi, sc):
        lt = lts[qi]
        if lt.mode != "filter":
            return sc
        return np.where(np.isfinite(sc), np.float32(lt.boost),
                        sc).astype(np.float32)
    return transform


# ---------------------------------------------------------------------
# the bool/filtered path: filter lists + weighted-threshold kernel rows
# ---------------------------------------------------------------------

class _PseudoLT:
    """LTerms-shaped adapter for a family-only bool spec, so that it rides
    the pure pruned pipeline over a FilteredSegView."""

    def __init__(self, spec: FastSpec):
        self.field = spec.field
        self.terms = [t for t, _w, _c in spec.slots]
        self.weights = np.asarray([w for _t, w, _c in spec.slots],
                                  np.float32)
        # all-required slots (operator and) == msm over every term
        self.msm = (len(spec.slots) if spec.n_required == len(spec.slots)
                    else max(int(spec.fam_msm), 1))
        self.sim = spec.sim
        self.has_norms = spec.has_norms
        self.mode = "score"
        self.boost = 1.0


def _family_only(spec: FastSpec) -> bool:
    """A bool spec that is one term group plus filters, whose pass rule is
    a plain minimum-match count: one counted family, or every slot
    required (operator and: msm = nterms)."""
    if not (spec.kind == "bool" and spec.filter_clauses
            and spec.const_score is None and spec.field is not None
            and len(spec.slots) > 0
            and spec.sim is not None and spec.sim.sim_id == SIM_BM25):
        return False
    counted_family = (spec.fam_msm >= 1
                      and all(cw == 1 for _t, _w, cw in spec.slots))
    all_required = (spec.n_required == len(spec.slots)
                    and spec.fam_msm == 0)
    return counted_family or all_required


_DUMMY: dict = {}


def _dummy_buffer(device: torch.device) -> torch.Tensor:
    """A sentinel buffer for kernel operands no slot reads."""
    key = str(device)
    if key not in _DUMMY:
        _DUMMY[key] = torch.full((HBM_ALIGN,), int(INT_SENTINEL),
                                 dtype=torch.int32, device=device)
    return _DUMMY[key]


class _BVQuery:
    """The bool-kernel rows of one query over one segment: one row, or one
    per doc-range chunk. Row arrays are [n, T]; weights f32[TS]; cw
    f32[T] (f32[TS + 1] with a probe, the filter's last); dlo/dhi [n]."""

    __slots__ = ("TS", "T", "L", "filtered", "probe", "rowstarts", "nrows",
                 "lens", "skips", "weights", "cw", "thresh", "avgdl", "dlo",
                 "dhi", "field", "k1", "b_eff", "fl", "al", "head")

    def __init__(self, **kw):
        self.head = False
        for k, v in kw.items():
            setattr(self, k, v)

    @property
    def n(self) -> int:
        return self.rowstarts.shape[0]


def _needs_term(spec: FastSpec) -> bool:
    """Passing needs a term match: a required slot or a counted family.
    Then the filter alone never reaches the threshold."""
    return spec.n_required > 0 or spec.fam_msm >= 1


def _probe_form(spec: FastSpec) -> bool:
    """A filter-slot row whose threshold the filter cannot reach alone
    probes the filter's bitmap; a bonus-only or const-score row, which
    every filter doc may pass, merges the filter's doc list."""
    return _needs_term(spec)


def _prepare_bool_vqueries(seg, ctx, specs: Sequence[FastSpec],
                           avgdl_cache: dict,
                           device: torch.device) -> List[_BVQuery]:
    """-> per bool spec its kernel rows over `seg`: the filter slot (as a
    probe or a doc list) or the filter-specialized postings
    (`_dense_hot`), the count weights and the threshold, chunked by doc
    range when a window exceeds its budget."""
    out: list = []
    for spec in specs:
        fl = fp = None
        nslots = len(spec.slots)
        ok = not nslots or packable(seg, spec.field)
        if spec.filter_clauses:
            fl = _filter_list(seg, ctx, spec.filter_clauses, device)
            if fl is None:
                out.append(DECLINED)
                continue
            # specialized postings only hold docs that match SOME term, so
            # the route is sound only when passing needs a term match; a
            # bonus-only bool's hits are the whole filter
            if (ok and nslots and _needs_term(spec)
                    and spec.field is not None
                    and _dense_hot(seg, fl, nslots)):
                fp = _filtered_postings(seg, spec.field, fl)
            fl.hits += 1
        if not ok:
            out.append(DECLINED)
            continue
        TS = next_pow2(max(nslots, 1), floor=1)
        filtered = fl is not None and fp is None
        probe = filtered and _probe_form(spec)
        T = 2 * TS if filtered and not probe else TS
        STATS["b3_filter_slot" if filtered else "b3_filtered_postings"
              if fp is not None else "b3_unfiltered"] += 1
        al = pb = None
        if nslots:
            al = (_filtered_rows(seg, spec.field, fp, device)
                  if fp is not None else get_aligned(seg, spec.field, device))
            pb = seg.postings.get(spec.field)
        weights = np.zeros(TS, np.float32)
        cw = np.zeros(T + probe, np.float32)
        slot_descs: List[Optional[Tuple[np.ndarray, int]]] = [None] * T
        for i, (term, w, cwv) in enumerate(spec.slots):
            weights[i] = w
            cw[i] = cwv
            # a segment without the field holds no posting of any slot:
            # its term slots stay dead
            r = pb.row(term) if al is not None else -1
            if r < 0:
                continue
            if fp is not None:
                a, b = int(fp.starts[r]), int(fp.starts[r + 1])
                docs = fp.host_docs[a:b]
            else:
                a, b = pb.row_slice(r)
                docs = pb.doc_ids[a:b]
            if b > a:
                slot_descs[i] = (docs, int(al.starts_rows[r]) * LANES)
        if filtered:
            # the filter's count weight: slot TS, or the probe's (last)
            cw[TS] = REQ_W
            if not probe:
                slot_descs[TS] = (fl.host_docs, 0)
        thresh = REQ_W * (spec.n_required + (1 if filtered else 0)) \
            + spec.fam_msm
        if spec.field is not None and spec.field not in avgdl_cache:
            avgdl_cache[spec.field] = np.float32(ctx.avgdl(spec.field))
        avgdl = avgdl_cache.get(spec.field, np.float32(1.0))
        k1 = float(spec.sim.k1) if spec.sim is not None else 1.2
        b_eff = (float(spec.sim.b)
                 if spec.sim is not None and spec.has_norms else 0.0)
        chunks = _chunk_slots(slot_descs, seg.ndocs, T, nchunk=1)
        if chunks is None:
            out.append(DECLINED)
            continue
        edges, rowstarts, nrows, lens, skips, max_nr = chunks
        out.append(_BVQuery(
            TS=TS, T=T, L=int(max_nr.max()) * LANES, filtered=filtered,
            probe=probe, rowstarts=rowstarts, nrows=nrows, lens=lens,
            skips=skips,
            weights=weights, cw=cw, thresh=np.float32(thresh), avgdl=avgdl,
            dlo=edges[:-1].astype(np.int32), dhi=edges[1:].astype(np.int32),
            field=spec.field, k1=k1, b_eff=b_eff,
            fl=fl if filtered else None, al=al))
    return out


def _bool_launch_inputs(gvqs: List[_BVQuery],
                        device: torch.device) -> list:
    """The bool kernel inputs of a group's rows in ONE host-to-device
    copy: rowstarts, nrows, lens, skips, weights, cw, thresh, avgdl, dlo,
    dhi."""
    TS, ncw = gvqs[0].TS, len(gvqs[0].cw)
    return _upload(
        [_cat(gvqs, a, np.int32)
         for a in ("rowstarts", "nrows", "lens", "skips")]
        + [_rep(gvqs, "weights", TS, np.float32),
           _rep(gvqs, "cw", ncw, np.float32),
           _rep(gvqs, "thresh", 1, np.float32),
           _rep(gvqs, "avgdl", 1, np.float32)]
        + [_cat(gvqs, a, np.int32).reshape(-1, 1) for a in ("dlo", "dhi")],
        device)


def bool_groups(vqs: List[_BVQuery]) -> List[List[_BVQuery]]:
    """Kernel rows grouped into launches: one per (buffers, TS, filter and
    its form, similarity)."""
    groups: dict = {}
    for vq in vqs:
        if vq is DECLINED:
            continue
        gk = (id(vq.al), vq.TS, vq.filtered, vq.probe,
              id(vq.fl) if vq.fl is not None else None, vq.k1, vq.b_eff)
        groups.setdefault(gk, []).append(vq)
    return list(groups.values())


def bool_group_call(gvqs: List[_BVQuery], K: int,
                    device: torch.device) -> Tuple[list, dict]:
    """The (positional, keyword) arguments of the bool kernel for one
    group, its inputs on `device`."""
    v0 = gvqs[0]
    if v0.al is not None:
        d_docs, d_tfdl = v0.al.d_docs, v0.al.d_tfdl
    else:
        d_docs = d_tfdl = _dummy_buffer(device)
    filt = (v0.fl.d_bits(device) if v0.probe else v0.fl.d_docs(device)
            if v0.filtered else _dummy_buffer(device))
    return ([d_docs, d_tfdl, filt, *_bool_launch_inputs(gvqs, device)],
            dict(TS=v0.TS, L=max(v.L for v in gvqs), K=K, k1=v0.k1,
                 b=v0.b_eff, filtered=v0.filtered, probe=v0.probe))


def _launch_bool(seg, ctx, specs: Sequence[FastSpec], K: int,
                 device: torch.device) -> tuple:
    """LAUNCH stage of the bool/filtered path: one kernel launch per
    group, no device sync; state for `_finish_bool`."""
    vqs = _prepare_bool_vqueries(seg, ctx, specs, {}, device)
    pending = []
    for gvqs in bool_groups(vqs):
        args, kw = bool_group_call(gvqs, K, device)
        pending.append((gvqs, K, fused_bm25_bool_topk(*args, **kw)))
    return vqs, pending


def _bool_transform(specs: Sequence[FastSpec]):
    """The bool path's score transform: a constant score, or the boost,
    applied to the kernel's pre-boost ranking."""
    def transform(qi, sc):
        spec = specs[qi]
        finite = np.isfinite(sc)
        if spec.const_score is not None:
            return np.where(finite, np.float32(spec.const_score),
                            -np.inf).astype(np.float32)
        if spec.boost != 1.0:
            return np.where(finite, sc * np.float32(spec.boost),
                            -np.inf).astype(np.float32)
        return sc
    return transform


def _finish_bool(specs: Sequence[FastSpec], K: int,
                 state: tuple) -> List[dict]:
    """FETCH stage of the bool/filtered path: one transfer for all groups,
    then the boost / const-score transform and assembly."""
    vqs, pending = state
    return _assemble(vqs, _fetch_groups(pending, K), _bool_transform(specs))


def _run_bool(seg, ctx, specs: Sequence[FastSpec], K: int,
              device: torch.device) -> List[dict]:
    return _finish_bool(specs, K, _launch_bool(seg, ctx, specs, K, device))


def _launch_filtered_pure_batch(seg, ctx, idx_specs, K: int,
                                device: torch.device) -> list:
    """LAUNCH stage of the filtered-pure rung: family-only bool specs over
    a dense hot filter ride the pure pruned pipeline over their
    FilteredSegView, ONE frontier launch per (field, filter) group."""
    groups: dict = {}
    for i, spec in idx_specs:
        if not _family_only(spec):
            continue
        fl = _filter_list(seg, ctx, spec.filter_clauses, device)
        if fl is None or not packable(seg, spec.field) \
                or not _dense_hot(seg, fl, len(spec.slots)):
            continue
        fp = _filtered_postings(seg, spec.field, fl)
        if fp is None:
            continue
        groups.setdefault((spec.field, fl.key),
                          (spec.field, fl, fp, []))[3].append((i, spec))
    launched = []
    for field, fl, fp, items in groups.values():
        view = _filtered_view(seg, field, fp, device)
        lts = [_PseudoLT(s) for _, s in items]
        sspecs = [s for _, s in items]
        state = _launch_pure(view, ctx, lts, sspecs, K, device)
        launched.append((view, fl, items, lts, sspecs, state))
    return launched


def _finish_filtered_pure_batch(ctx, K: int, launched: list,
                                device: torch.device) -> dict:
    """FETCH stage of the filtered-pure rung: {spec index: result}."""
    out: dict = {}
    for view, fl, items, lts, sspecs, state in launched:
        res = _finish_pure(view, ctx, lts, sspecs, K, state, device)
        for (i, spec), r in zip(items, res):
            if r is None:
                continue    # the bool path takes it (and counts its use)
            fl.hits += 1
            STATS["filtered_pure"] += 1
            if spec.boost != 1.0:
                sc = r["topk_scores"]
                sc = np.where(np.isfinite(sc), sc * np.float32(spec.boost),
                              sc).astype(np.float32)
                r = dict(r, topk_scores=sc,
                         max_score=(float(sc[0]) if r["total"] > 0
                                    and np.isfinite(sc[0]) else -np.inf))
            out[i] = r
    return out


def count_served(specs: Sequence[FastSpec],
                 outs: Sequence[Optional[dict]]) -> None:
    for spec, r in zip(specs, outs):
        STATS["fallback" if r is None else "pure_served"
              if spec.kind == "pure" else "bool_served"] += 1


class LaunchHandle:
    """Launched frontier pass of a batch over one segment; `fetch()` syncs
    it, runs the ladder and returns the per-spec result dicts."""

    def __init__(self, finish):
        self._finish = finish

    def fetch(self) -> List[dict]:
        return self._finish()


def launch_batch(seg, ctx: C.ShardContext, specs: Sequence[FastSpec],
                 k: int, device: torch.device,
                 count_stats: bool = True) -> Optional[LaunchHandle]:
    """LAUNCH stage of the batched kernel path: many FastSpecs over ONE
    segment in as few kernel launches as possible. Pure term groups and
    the filtered-pure rung enqueue their frontier launches here; `fetch()`
    syncs them, runs the ladder, then launches and fetches the remaining
    bool specs (whose routes read the filter lists' use counts as the
    rung left them), as the reference orders them. A result is None where
    the fast path declines its query; the handle is None for a segment
    with deleted docs (the kernels read no live mask)."""
    if seg.live_count != seg.ndocs:
        return None
    K = min(next_pow2(max(k, 16)), MAX_K)
    pure_idx = [i for i, s in enumerate(specs) if s.kind == "pure"]
    bool_idx = [i for i, s in enumerate(specs) if s.kind == "bool"]
    lts = [specs[i].lt for i in pure_idx]
    pure_specs = [specs[i] for i in pure_idx]
    pure_state = (_launch_pure(seg, ctx, lts, pure_specs, K, device)
                  if pure_idx else None)
    filtered = (_launch_filtered_pure_batch(
        seg, ctx, [(i, specs[i]) for i in bool_idx], K, device)
        if bool_idx else [])

    def finish() -> List[dict]:
        out: List[Optional[dict]] = [None] * len(specs)
        if pure_state is not None:
            for i, r in zip(pure_idx, _finish_pure(seg, ctx, lts, pure_specs,
                                                   K, pure_state, device)):
                out[i] = r
        served = (_finish_filtered_pure_batch(ctx, K, filtered, device)
                  if filtered else {})
        for i, r in served.items():
            out[i] = r
        rem = [i for i in bool_idx if i not in served]
        if rem:
            for i, r in zip(rem, _run_bool(seg, ctx, [specs[i] for i in rem],
                                           K, device)):
                out[i] = r
        if count_stats:
            count_served(specs, out)
        return out

    return LaunchHandle(finish)


def batch_search(seg, ctx: C.ShardContext, specs: Sequence[FastSpec],
                 k: int, device: torch.device
                 ) -> Optional[List[Optional[dict]]]:
    """Synchronous batched kernel path: `launch_batch(...).fetch()`."""
    handle = launch_batch(seg, ctx, specs, k, device)
    return None if handle is None else handle.fetch()


# ---------------------------------------------------------------------
# one launch per shard: the concatenated shard view
# ---------------------------------------------------------------------

def _concat_shard(segs: List[Segment], field: str) -> dict:
    """A shard's segments -> one host CSR: union term dict, per-term
    postings concatenated segment by segment with doc offsets (the CSR
    part of opensearch_tpu/parallel/spmd.py:_concat_shard)."""
    ndocs = sum(s.ndocs for s in segs)
    dl = np.zeros(ndocs, np.float32)
    off = 0
    for s in segs:
        sdl = s.doc_lens.get(field)
        if sdl is not None:
            dl[off: off + s.ndocs] = sdl
        off += s.ndocs
    pbs = [s.postings.get(field) for s in segs]
    vocab: dict = {}
    for pb in pbs:
        if pb is None:
            continue
        for t in pb.vocab:
            vocab.setdefault(t, len(vocab))
    nterms = len(vocab)
    # vectorized merge: per-posting (target row, offset doc) keys, one
    # stable sort
    trows_parts, docs_parts, tfs_parts = [], [], []
    off = 0
    for s, pb in zip(segs, pbs):
        if pb is not None and pb.size:
            rows = np.array([vocab[t] for t in pb.vocab], np.int64)
            trows_parts.append(np.repeat(rows, np.diff(pb.starts)))
            docs_parts.append(pb.doc_ids.astype(np.int64) + off)
            tfs_parts.append(pb.tfs)
        off += s.ndocs
    if trows_parts:
        trows = np.concatenate(trows_parts)
        docs_all = np.concatenate(docs_parts)
        tfs_all = np.concatenate(tfs_parts)
        order = np.lexsort((docs_all, trows))
        doc_ids = docs_all[order].astype(np.int32)
        tfs = tfs_all[order]
        lens = np.bincount(trows, minlength=nterms)
    else:
        doc_ids = np.zeros(0, np.int32)
        tfs = np.zeros(0, np.float32)
        lens = np.zeros(nterms, np.int64)
    starts = np.zeros(nterms + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    return {"terms": vocab, "starts": starts, "doc_ids": doc_ids, "tfs": tfs,
            "dl": dl}


class ShardView:
    """Segment-shaped facade over a shard's concatenated postings: the
    attribute surface the pure fast path touches. It carries no impact
    plane and no `uid`, so its frontier pass rides the exact tf.dl kernel
    and its ladder skips the quality tier, as the reference's does."""

    def __init__(self, name: str, segments: List[Segment],
                 seg_ords: List[int]):
        self.name = name
        self.segments = segments
        # original positions in the engine's segment list
        self.seg_ords = seg_ords
        self.seg_bases = np.cumsum([0] + [s.ndocs for s in segments])
        self.ndocs = int(self.seg_bases[-1])
        self.live_count = sum(s.live_count for s in segments)
        self.postings: dict = {}
        self.doc_lens: dict = {}
        self.aligned: dict = {}
        self._built: set = set()

    def ensure_field(self, field: str) -> bool:
        if field in self._built:
            return field in self.postings
        self._built.add(field)
        if not any(field in s.postings for s in self.segments):
            return False
        m = _concat_shard(self.segments, field)
        self.postings[field] = PostingsBlock(
            field=field, vocab=list(m["terms"]), terms=m["terms"],
            starts=np.asarray(m["starts"], np.int64),
            doc_ids=m["doc_ids"], tfs=m["tfs"])
        if any(s.doc_lens.get(field) is not None for s in self.segments):
            self.doc_lens[field] = m["dl"]
        return True

    def locate(self, view_doc: int):
        """view-space doc -> (engine seg_ord, segment, local doc)."""
        vi = int(np.searchsorted(self.seg_bases, view_doc, "right") - 1)
        return (self.seg_ords[vi], self.segments[vi],
                int(view_doc - self.seg_bases[vi]))


def shard_view(engine) -> Optional[ShardView]:
    """Cached per engine and identity of its segment list: rebuilt
    whenever refresh changes the segment set. None below two live
    segments or with deletes."""
    pairs = [(i, s) for i, s in enumerate(engine.segments)
             if s.live_count > 0]
    if len(pairs) < 2:
        return None
    if any(s.live_count != s.ndocs for _, s in pairs):
        return None
    key = tuple(id(s) for _, s in pairs)
    cached = engine.__dict__.get("_shard_view")
    if cached is not None and cached[0] == key:
        return cached[1]
    view = ShardView(f"view:{id(engine):x}", [s for _, s in pairs],
                     [i for i, _ in pairs])
    engine.__dict__["_shard_view"] = (key, view)
    return view


def shard_search(engine, ctx, spec: FastSpec, k: int,
                 device: torch.device) -> Optional[Tuple[ShardView, dict]]:
    """One frontier launch over ALL the shard's segments for a pure spec;
    None -> the per-segment loop (bool specs always: their filters live
    per segment)."""
    if spec.kind != "pure":
        return None
    view = shard_view(engine)
    if view is None or not view.ensure_field(spec.lt.field):
        return None
    out = batch_search(view, ctx, [spec], k, device)
    if out is None or out[0] is None:
        return None
    STATS["shard_view_served"] += 1
    return view, out[0]
