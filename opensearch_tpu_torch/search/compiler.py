"""Rewrite: DSL tree -> logical plan with index-wide statistics, and the
general query path that serves any plan over one segment (the
ShardContext, the rewrite, `can_match` and the prepare / emit / executor
programs of opensearch_tpu/search/compiler.py for the node kinds the port
serves).

A term, terms or match query on a text or keyword field becomes one
weighted term group (`LTerms`) with the reference's per-term weights (idf
x boost, f32) and minimum should match; on an integer/long field it
becomes an exact `LRange` (terms: a bool of them). A match whose terms
analyze away, a range on an unmapped field, or `match_none` becomes
`LMatchNone`; `match_all` `LMatchAll`, `exists` `LExists`, `ids` `LIds`.
`bool` becomes `LBool` and `constant_score` `LConstScore`, their filter
and must_not clauses rewritten in filter context (`scoring=False`: a
term there is a non-scoring match), as in the reference. Any other query
or field kind raises `NotPortedError`.

The general path (`emit`, `run_segment`) evaluates a plan as torch ops on
the engine's device: every node becomes dense per-doc (scores, match
count) arrays (`ops/scoring.ScoredMask`), filter and must_not clauses
come from the cached masks of `search/filters.py`, and a masked top-k
closes it. It serves every shape the fused kernels and the impact rung
decline.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..errors import NotPortedError
from ..index.mappings import INT_TYPES, KEYWORD_TYPES, Mappings, coerce_value
from ..index.segment import Segment, next_pow2
from ..models.similarity import Similarity, resolve_similarity
from ..ops import scoring as ops
from ..ops.bm25 import LANES
from . import query_dsl as dsl


class ShardContext:
    """Index-wide view used during rewrite (reference QueryShardContext)."""

    def __init__(self, mappings: Mappings, segments: List[Segment],
                 similarity=None):
        self.mappings = mappings
        self.segments = segments
        self.default_sim = resolve_similarity(similarity)

    def sim_for(self, field: str) -> Similarity:
        return self.default_sim

    @property
    def num_docs(self) -> int:
        # incl. deleted, like Lucene maxDoc
        return sum(s.ndocs for s in self.segments)

    def doc_freq(self, field: str, term: str) -> int:
        return sum(s.postings[field].doc_freq(term)
                   for s in self.segments if field in s.postings)

    def field_stats(self, field: str) -> Tuple[int, int]:
        doc_count, sum_dl = 0, 0
        for s in self.segments:
            st = s.text_stats.get(field)
            if st:
                doc_count += st.doc_count
                sum_dl += st.sum_dl
        return doc_count, sum_dl

    def avgdl(self, field: str) -> float:
        dc, sdl = self.field_stats(field)
        return (sdl / dc) if dc > 0 else 1.0


@dataclass
class LNode:
    name: Optional[str] = None


@dataclass
class LTerms(LNode):
    """One weighted term group over a field: the fused scoring leaf.
    mode "filter" scores every match with the constant `boost`."""

    field: str = ""
    terms: List[str] = dc_field(default_factory=list)
    weights: Optional[np.ndarray] = None   # f32[T] idf*boost
    msm: int = 1
    mode: str = "score"                    # score | filter
    sim: Optional[Similarity] = None
    has_norms: bool = True
    boost: float = 1.0


@dataclass
class LMatchAll(LNode):
    boost: float = 1.0


@dataclass
class LMatchNone(LNode):
    pass


@dataclass
class LExists(LNode):
    field: str = ""
    boost: float = 1.0


@dataclass
class LIds(LNode):
    ids: List[str] = dc_field(default_factory=list)
    boost: float = 1.0


@dataclass
class LRange(LNode):
    """Exact i64 range over an integer/long column; a bound of None is
    open."""

    field: str = ""
    kind: str = "int"
    lo: Any = None
    hi: Any = None
    include_lo: bool = True
    include_hi: bool = True
    boost: float = 1.0


@dataclass
class LBool(LNode):
    musts: List[LNode] = dc_field(default_factory=list)
    shoulds: List[LNode] = dc_field(default_factory=list)
    must_nots: List[LNode] = dc_field(default_factory=list)
    filters: List[LNode] = dc_field(default_factory=list)
    msm: int = 0
    boost: float = 1.0


@dataclass
class LConstScore(LNode):
    child: Optional[LNode] = None
    boost: float = 1.0


def _numeric_eq_node(ft, value: Any, boost: float) -> LRange:
    cv = coerce_value(ft, value)
    return LRange(field=ft.name, kind="int", lo=cv, hi=cv, include_lo=True,
                  include_hi=True, boost=boost)


def rewrite(q: dsl.Query, ctx: ShardContext, scoring: bool = True) -> LNode:
    if isinstance(q, dsl.MatchAllQuery):
        return LMatchAll(boost=q.boost)
    if isinstance(q, dsl.MatchNoneQuery):
        return LMatchNone()

    if isinstance(q, dsl.TermQuery):
        ft = ctx.mappings.resolve_field(q.field)
        if ft is not None and ft.type in INT_TYPES:
            return _numeric_eq_node(ft, q.value, q.boost)
        field = ft.name if ft else q.field
        term = _index_term(q.field, q.value, ctx)
        if q.case_insensitive:
            term = term.lower()
        mode = "score" if scoring else "filter"
        return _weighted_terms(field, [term], [1.0], ctx, 1, mode, q.boost)

    if isinstance(q, dsl.TermsQuery):
        ft = ctx.mappings.resolve_field(q.field)
        if ft is not None and ft.type in INT_TYPES:
            return LBool(shoulds=[_numeric_eq_node(ft, v, 1.0)
                                  for v in q.values], msm=1, boost=q.boost)
        field = ft.name if ft else q.field
        terms = [_index_term(q.field, v, ctx) for v in q.values]
        # terms query is constant-score (reference TermInSetQuery)
        return _weighted_terms(field, terms, [1.0] * len(terms), ctx, 1,
                               "filter", q.boost)

    if isinstance(q, dsl.MatchQuery):
        ft = ctx.mappings.resolve_field(q.field)
        if ft is not None and ft.type in INT_TYPES:
            return _numeric_eq_node(ft, q.query, q.boost)
        field = ft.name if ft else q.field
        terms = _analyze_query_text(field, q.query, ctx, q.analyzer)
        if not terms:
            return LMatchNone()
        if q.fuzziness is not None:
            raise NotPortedError("match [fuzziness] (a bool plan of "
                                 "expanded terms)")
        msm = len(terms) if q.operator == "and" else \
            dsl.parse_minimum_should_match(q.minimum_should_match,
                                           len(terms)) or 1
        # a match keeps score mode in filter context: its scores drive the
        # msm count
        return _weighted_terms(field, terms, [1.0] * len(terms), ctx, msm,
                               "score", q.boost)

    if isinstance(q, dsl.BoolQuery):
        musts = [rewrite(c, ctx, scoring) for c in q.must]
        shoulds = [rewrite(c, ctx, scoring) for c in q.should]
        must_nots = [rewrite(c, ctx, False) for c in q.must_not]
        filters = [rewrite(c, ctx, False) for c in q.filter]
        n_should = len(shoulds)
        if q.minimum_should_match is not None:
            msm = dsl.parse_minimum_should_match(q.minimum_should_match,
                                                 n_should)
        else:
            msm = 1 if (n_should and not musts and not filters) else 0
        return LBool(musts=musts, shoulds=shoulds, must_nots=must_nots,
                     filters=filters, msm=msm, boost=q.boost)

    if isinstance(q, dsl.RangeQuery):
        ft = ctx.mappings.resolve_field(q.field)
        if ft is None:
            return LMatchNone()
        if ft.type not in INT_TYPES:
            raise NotPortedError(f"[range] on field [{ft.name}] of type "
                                 f"[{ft.type}]")
        lo = hi = None
        inc_lo = inc_hi = True
        if q.gte is not None:
            lo, inc_lo = coerce_value(ft, q.gte), True
        if q.gt is not None:
            lo, inc_lo = coerce_value(ft, q.gt), False
        if q.lte is not None:
            hi, inc_hi = coerce_value(ft, q.lte), True
        if q.lt is not None:
            hi, inc_hi = coerce_value(ft, q.lt), False
        return LRange(field=ft.name, kind="int", lo=lo, hi=hi,
                      include_lo=inc_lo, include_hi=inc_hi, boost=q.boost)

    if isinstance(q, dsl.ExistsQuery):
        ft = ctx.mappings.resolve_field(q.field)
        return LExists(field=ft.name if ft else q.field, boost=q.boost)

    if isinstance(q, dsl.IdsQuery):
        return LIds(ids=list(q.values), boost=q.boost)

    if isinstance(q, dsl.ConstantScoreQuery):
        return LConstScore(child=rewrite(q.filter, ctx, False), boost=q.boost)

    raise NotPortedError(f"query [{type(q).__name__}]")


def can_match(node: LNode, seg: Segment) -> bool:
    """Segment pre-filter (reference CanMatchPreFilterSearchPhase): False
    only when the segment provably holds no hit of `node`."""
    if isinstance(node, LTerms):
        pb = seg.postings.get(node.field)
        if pb is None:
            return False
        if node.msm >= len(node.terms):
            return all(pb.row(t) >= 0 for t in node.terms)
        return any(pb.row(t) >= 0 for t in node.terms)
    if isinstance(node, LRange):
        col = seg.numeric_cols.get(node.field)
        if col is None:
            return False
        mn, mx = col.min_max
        if node.lo is not None and float(node.lo) > mx:
            return False
        if node.hi is not None and float(node.hi) < mn:
            return False
        return True
    if isinstance(node, LBool):
        for c in node.musts + node.filters:
            if not can_match(c, seg):
                return False
        if node.shoulds and not node.musts and not node.filters:
            return any(can_match(c, seg) for c in node.shoulds)
        return True
    if isinstance(node, LConstScore):
        return can_match(node.child, seg)
    if isinstance(node, LMatchNone):
        return False
    if isinstance(node, LExists):
        f = node.field
        return (f in seg.postings or f in seg.numeric_cols
                or f in seg.doc_lens)
    if isinstance(node, LIds):
        return any(seg.local_doc(i) >= 0 for i in node.ids)
    return True


def _weighted_terms(field: str, terms: List[str], boosts: List[float],
                    ctx: ShardContext, msm: int, mode: str,
                    boost: float) -> LTerms:
    ft = ctx.mappings.resolve_field(field)
    sim = ctx.sim_for(field)
    has_norms = bool(ft is not None and ft.has_norms and sim.uses_norms)
    n = ctx.num_docs
    weights = np.zeros(len(terms), dtype=np.float32)
    for i, t in enumerate(terms):
        df = ctx.doc_freq(field, t)
        weights[i] = (sim.term_weight(boosts[i] * boost, n, max(df, 0))
                      if df > 0 else 0.0)
    return LTerms(field=field, terms=terms, weights=weights, msm=msm,
                  mode=mode, sim=sim, has_norms=has_norms, boost=boost)


def _analyze_query_text(field: str, text: Any, ctx: ShardContext,
                        analyzer_override: Optional[str] = None) -> List[str]:
    ft = ctx.mappings.resolve_field(field)
    if ft is None:
        return [str(text)]
    if analyzer_override:
        return ctx.mappings.analysis.get(analyzer_override).terms(str(text))
    return ctx.mappings.search_analyzer_for(ft).terms(str(text))


def _index_term(field: str, value: Any, ctx: ShardContext) -> str:
    """Single exact term for term/terms queries: the keyword normalizer
    applies, text fields match the raw token (reference TermQueryBuilder)."""
    ft = ctx.mappings.resolve_field(field)
    if ft is not None and ft.type in KEYWORD_TYPES:
        norm = ctx.mappings.index_analyzer(ft).terms(str(value))
        return norm[0] if norm else str(value)
    return str(value)


# ---------------------------------------------------------------------
# phase-2 rescore shapes (search/fastpath.py escalation rung)
# ---------------------------------------------------------------------

RESCORE_C_MIN = 1 << 8          # pad floor: tiny unions share one shape
RESCORE_C_MAX = 1 << 17         # == MAX_T * 4 * L_HEAD (deepest tier-2
                                # union); beyond -> the host pass


def rescore_cand_bucket(n: int) -> Optional[int]:
    """Candidate-axis pow2 bucket for a union of `n` ids; None when the
    union exceeds every bucket (host pass instead)."""
    if n <= 0 or n > RESCORE_C_MAX:
        return None
    return min(max(next_pow2(n), RESCORE_C_MIN), RESCORE_C_MAX)


# ---------------------------------------------------------------------
# the general path: one plan over one segment, as torch ops
# ---------------------------------------------------------------------

STATS = {"general_served": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def field_postings(seg: Segment, field: str,
                   device: torch.device) -> Optional[ops.FieldPostings]:
    """The postings of `field` over `seg` on `device`, cached: windows
    into the fastpath's resident aligned layout (no bytes added), or a CSR
    copy where that layout cannot pack the field. None without
    postings."""
    pb = seg.postings.get(field)
    if pb is None or pb.size == 0:
        return None
    from . import fastpath      # fastpath imports this module

    def make():
        csr_off = pb.starts[:-1].astype(np.int64)
        if fastpath.packable(seg, field):
            al = fastpath.get_aligned(seg, field, device)
            return ops.FieldPostings(al.starts_rows * LANES, al.lens,
                                     csr_off, al.d_docs, d_tfdl=al.d_tfdl,
                                     d_imp=al.d_imp)
        docs, tfs, imp = seg.csr_on(field, device)
        return ops.FieldPostings(csr_off, np.diff(pb.starts), csr_off, docs,
                                 d_tfs=tfs,
                                 d_dl=seg.doc_lens_on(field, device),
                                 d_imp=imp)
    return seg.device_cached(("postings", field), device, make)


def _term_rows(node: LTerms, seg: Segment) -> list:
    """The group's term-dict rows over `seg`, pow2-padded with -1."""
    pb = seg.postings.get(node.field)
    rows = [-1] * next_pow2(len(node.terms), floor=1)
    for i, t in enumerate(node.terms):
        rows[i] = pb.row(t)
    return rows


def _f32(v) -> float:
    return float(np.float32(v))


def _flag(mask: torch.Tensor, boost: float) -> ops.ScoredMask:
    """A non-scoring match as a node: scores `boost` where it matches."""
    m = mask.to(torch.float32)
    return ops.ScoredMask(m * _f32(boost), m)


def emit(node: LNode, seg: Segment, ctx: ShardContext,
         device: torch.device) -> ops.ScoredMask:
    """Dense (scores, match count) of `node` over `seg`: the reference's
    `prepare` (host parameters) and `emit` (device program) in one pass,
    node by node, with the reference's arithmetic and order."""
    from . import filters       # filters imports this module

    nd = seg.ndocs
    live = seg.live_on(device)
    zeros = torch.zeros(nd, dtype=torch.float32, device=device)
    if isinstance(node, LTerms):
        post = field_postings(seg, node.field, device)
        if post is None:
            return ops.ScoredMask(zeros, zeros)
        rows = _term_rows(node, seg)
        if node.mode == "filter":
            return _flag(ops.term_match_mask(post, live, rows, nd),
                         node.boost)
        w = np.zeros(len(rows), np.float32)
        w[:len(node.terms)] = node.weights
        b_eff = node.sim.b if node.has_norms else 0.0
        sm = ops.score_term_group(post, rows, w, live, nd,
                                  float(node.sim.k1), float(b_eff),
                                  ctx.avgdl(node.field))
        ok = sm.count >= _f32(node.msm)
        return ops.ScoredMask(torch.where(ok, sm.scores, zeros),
                              torch.where(ok, sm.count, zeros))
    if isinstance(node, LMatchAll):
        return _flag(live, node.boost)
    if isinstance(node, LMatchNone):
        return ops.ScoredMask(zeros, zeros)
    if isinstance(node, LRange):
        col = seg.numeric_on(node.field, device)
        if col is None:
            return ops.ScoredMask(zeros, zeros)
        lo = filters.I64_MIN if node.lo is None else int(node.lo)
        hi = filters.I64_MAX if node.hi is None else int(node.hi)
        return _flag(ops.int64_range_mask(*col, lo, hi, node.include_lo,
                                          node.include_hi) & live,
                     node.boost)
    if isinstance(node, LExists):
        return _flag(ops.exists_mask(filters.present_mask(
            node.field, seg, device), live), node.boost)
    if isinstance(node, LIds):
        docs = [d for d in (seg.local_doc(i) for i in node.ids) if d >= 0]
        return _flag(ops.docs_mask(docs, nd, device) & live, node.boost)
    if isinstance(node, LBool):
        m_sms = [emit(c, seg, ctx, device) for c in node.musts]
        s_sms = [emit(c, seg, ctx, device) for c in node.shoulds]
        scores = zeros
        for sm in m_sms + s_sms:
            scores = scores + sm.scores
        matched = live
        for sm in m_sms:
            matched = matched & sm.matched
        for c in node.filters:
            matched = matched & filters.filter_mask(c, seg, ctx, device)
        for c in node.must_nots:
            matched = matched & ~filters.filter_mask(c, seg, ctx, device)
        if s_sms:
            s_count = zeros
            for sm in s_sms:
                s_count = s_count + sm.matched.to(torch.float32)
            matched = matched & (s_count >= _f32(node.msm))
        scores = torch.where(matched, scores * _f32(node.boost), zeros)
        return ops.ScoredMask(scores, matched.to(torch.float32))
    if isinstance(node, LConstScore):
        return _flag(filters.filter_mask(node.child, seg, ctx, device)
                     & live, node.boost)
    raise NotPortedError(f"plan [{type(node).__name__}] on the general path")


def run_segment(lroot: LNode, seg: Segment, ctx: ShardContext, k_pad: int,
                device: torch.device) -> dict:
    """The executor body: `lroot` over `seg`, its masked top `k_pad` (score
    desc, doc asc), the total and the max score, fetched in one copy."""
    sm = emit(lroot, seg, ctx, device)
    live = seg.live_on(device)
    vals, idx = ops.topk_docs(sm.scores, sm.matched, live, k_pad)
    total = ops.total_hits(sm.matched, live)
    host = torch.cat([vals.double(), idx.double(),
                      total.double().reshape(1)]).cpu().numpy()
    k = len(idx)
    sc = host[:k].astype(np.float32)
    STATS["general_served"] += 1
    return {"topk_idx": host[k:2 * k].astype(np.int64), "topk_scores": sc,
            "total": int(host[-1]), "total_rel": "eq",
            "max_score": float(sc[0]) if k else float("-inf")}
