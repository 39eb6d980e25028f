"""The percolator: stored queries matched against candidate documents (a
copy of opensearch_tpu/search/percolate.py).

At index time a stored query is parsed, rewritten in filter context and
reduced to a set of (field, term) pairs one of which any matching doc must
hold (`extract_index_terms`), kept in the hidden keyword column
`<field>#terms` as "field\\0term" strings; a query without such a set is
flagged "any" in `<field>#flags`. At search time the candidate documents
become an in-memory segment (`build_mini`, the MemoryIndex), the stored
queries whose terms meet the candidates' (and the flagged ones) are the
pre-filter (`candidate_docs`), and each is rewritten over the mini segment
and evaluated by a host numpy evaluator (`host_eval`); a node kind the
evaluator does not model runs the general path's `emit` on the
context's device. `segment_mask` is a segment's match mask,
`document_slots` the candidates one stored query matched.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Set, Tuple

import numpy as np

from ..index.mappings import Mappings
from ..index.segment import Segment, build_segment
from . import compiler as C
from . import query_dsl as dsl

# the candidates pre-filtered and evaluated by the last `segment_mask`
# (read by chip_smoke's phase 22)
LAST_CANDIDATES = [0]


def _extract(n) -> Optional[Set[Tuple[str, str]]]:
    """(field, term) pairs one of which a doc must hold to match `n`, or
    None where no such set exists (the query always runs)."""
    if isinstance(n, C.LTerms):
        if not n.terms:
            return None
        if n.msm >= len(n.terms):
            # a conjunction: every term is necessary, one suffices
            return {(n.field, n.terms[0])}
        return {(n.field, t) for t in n.terms}
    if isinstance(n, C.LPhrase):
        terms = n.terms[:-1] if n.prefix_last and len(n.terms) > 1 else n.terms
        if not terms or (n.prefix_last and len(n.terms) == 1):
            return None
        return {(n.field, terms[0])}
    if isinstance(n, C.LBool):
        best: Optional[Set] = None
        for c in n.musts + n.filters:
            got = _extract(c)
            if got is not None and (best is None or len(got) < len(best)):
                best = got
        if best is not None:
            return best
        if n.shoulds and n.msm >= 1 and not n.musts and not n.filters:
            union: Set = set()
            for c in n.shoulds:
                got = _extract(c)
                if got is None:
                    return None
                union |= got
            return union
        return None
    if isinstance(n, C.LConstScore):
        return _extract(n.child)
    if isinstance(n, C.LBoosting):
        return _extract(n.positive)
    if isinstance(n, C.LDisMax):
        union = set()
        for c in n.children:
            got = _extract(c)
            if got is None:
                return None
            union |= got
        return union
    if isinstance(n, (C.LFuncScore, C.LNested)):
        return _extract(n.child)
    if isinstance(n, C.LMatchNone):
        return set()        # never matches: an empty set keeps it skipped
    return None


def extract_index_terms(qdict: dict, mappings: Mappings
                        ) -> Tuple[List[str], bool]:
    """Parse and validate a stored query: (["field\\0term", ...], whether
    it always runs)."""
    q = dsl.parse_query(qdict)
    lroot = C.rewrite(q, C.ShardContext(mappings, []), scoring=False)
    got = _extract(lroot)
    if got is None:
        return [], True
    return sorted({f"{f}\x00{t}" for f, t in got}), False


def _clone_mappings(m: Mappings) -> Mappings:
    """A shallow clone, so that the candidates' dynamic fields never
    reach the index's mappings."""
    m2 = copy.copy(m)
    m2.fields = dict(m.fields)
    m2.aliases = dict(m.aliases)
    m2.nested_paths = set(m.nested_paths)
    m2.dynamic_templates = list(m.dynamic_templates)
    return m2


def build_mini(mappings: Mappings, documents: List[dict], device=None):
    """The candidate documents as (segment, statistics context): the
    MemoryIndex."""
    m2 = _clone_mappings(mappings)
    parsed = [m2.parse(str(i), doc) for i, doc in enumerate(documents)]
    seg = build_segment("_percolate", parsed, m2)
    return seg, C.ShardContext(m2, [seg], device=device)


def candidate_terms(seg: Segment) -> Set[str]:
    out: Set[str] = set()
    for f, pb in seg.postings.items():
        out.update(f"{f}\x00{t}" for t in pb.vocab)
    for blk in seg.nested.values():
        out |= candidate_terms(blk.child)
    return out


def host_eval(n, seg: Segment, ctx: C.ShardContext) -> np.ndarray:
    """bool[ndocs]: the docs of a host segment that plan node `n` matches
    (the device emit's matched semantics)."""
    nd = seg.ndocs
    live = seg.live[:nd]
    none = np.zeros(nd, bool)
    if isinstance(n, C.LMatchAll):
        return live.copy()
    if isinstance(n, C.LMatchNone):
        return none
    if isinstance(n, C.LTerms):
        pb = seg.postings.get(n.field)
        if pb is None:
            return none
        count = np.zeros(nd, np.int32)
        for t in n.terms:
            r = pb.row(t)
            if r >= 0:
                a, b = pb.row_slice(r)
                count[pb.doc_ids[a:b]] += 1
        return (count >= max(n.msm, 1)) & live
    if isinstance(n, C.LExpandTerms):
        pb = seg.postings.get(n.field)
        mask = np.zeros(nd, bool)
        if pb is not None:
            for r in np.asarray(n.rows(seg)).tolist():
                a, b = pb.row_slice(int(r))
                mask[pb.doc_ids[a:b]] = True
        return mask & live
    if isinstance(n, C.LPhrase):
        from .explain import host_phrase_freq
        return np.array([bool(live[d]) and host_phrase_freq(n, seg, d) > 0
                         for d in range(nd)], bool)
    if isinstance(n, C.LRange):
        col = seg.numeric_cols.get(n.field)
        if col is None:
            return none
        v = col.values[:nd]
        mask = col.present[:nd].copy()
        if n.lo is not None:
            mask &= (v >= n.lo) if n.include_lo else (v > n.lo)
        if n.hi is not None:
            mask &= (v <= n.hi) if n.include_hi else (v < n.hi)
        return mask & live
    if isinstance(n, C.LExists):
        f = n.field
        if f in seg.numeric_cols:
            present = seg.numeric_cols[f].present[:nd]
        elif f in seg.keyword_cols:
            present = seg.keyword_cols[f].min_ord[:nd] >= 0
        elif f in seg.geo_cols:
            present = seg.geo_cols[f].present[:nd]
        elif f in seg.doc_lens:
            present = seg.doc_lens[f][:nd] > 0
        else:
            return none
        return np.asarray(present, bool) & live
    if isinstance(n, C.LIds):
        mask = np.zeros(nd, bool)
        for i in n.ids:
            d = seg.local_doc(i)
            if d >= 0:
                mask[d] = True
        return mask & live
    if isinstance(n, C.LBool):
        mask = live.copy()
        for c in n.musts + n.filters:
            mask &= host_eval(c, seg, ctx)
        for c in n.must_nots:
            mask &= ~host_eval(c, seg, ctx)
        if n.shoulds:
            cnt = np.zeros(nd, np.int32)
            for c in n.shoulds:
                cnt += host_eval(c, seg, ctx)
            mask &= cnt >= n.msm
        return mask
    if isinstance(n, C.LConstScore):
        return host_eval(n.child, seg, ctx)
    if isinstance(n, C.LBoosting):
        return host_eval(n.positive, seg, ctx)
    if isinstance(n, C.LDisMax):
        mask = np.zeros(nd, bool)
        for c in n.children:
            mask |= host_eval(c, seg, ctx)
        return mask
    if isinstance(n, C.LFuncScore) and n.min_score is None:
        return host_eval(n.child, seg, ctx)
    if isinstance(n, C.LNested):
        blk = seg.nested.get(n.path)
        if blk is None or blk.child.ndocs == 0:
            return none
        cm = host_eval(n.child, blk.child, n.child_ctx)
        mask = np.zeros(nd, bool)
        np.logical_or.at(mask, blk.parent_of[cm], True)
        return mask & live
    if isinstance(n, C.LGeoDist):
        col = seg.geo_cols.get(n.field)
        if col is None:
            return none
        p1 = np.deg2rad(col.lat[:nd].astype(np.float64))
        p2 = np.deg2rad(n.lat)
        dlmb = np.deg2rad(n.lon - col.lon[:nd].astype(np.float64))
        a = (np.sin((p2 - p1) / 2) ** 2
             + np.cos(p1) * np.cos(p2) * np.sin(dlmb / 2) ** 2)
        d = 2 * 6371008.8 * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))
        return (d <= n.radius_m) & col.present[:nd] & live
    if isinstance(n, C.LGeoBox):
        col = seg.geo_cols.get(n.field)
        if col is None:
            return none
        lat, lon = col.lat[:nd], col.lon[:nd]
        return ((lat <= n.top) & (lat >= n.bottom) & (lon >= n.left)
                & (lon <= n.right) & col.present[:nd] & live)
    # the rest (scripts, kNN, joins, a min_score): the general path
    return C.emit(n, seg, ctx, ctx.device).matched.cpu().numpy()[:nd]


def _stored_query(seg: Segment, doc: int, field: str) -> Optional[dsl.Query]:
    """The parsed stored query of one percolator doc, cached on the
    segment (None where it no longer parses)."""
    cache = seg.__dict__.setdefault("percolator_queries", {})
    key = (field, doc)
    if key not in cache:
        node = seg.sources[doc]
        for part in field.split("."):
            node = node.get(part) if isinstance(node, dict) else None
            if node is None:
                break
        try:
            cache[key] = (dsl.parse_query(node) if isinstance(node, dict)
                          else None)
        except dsl.QueryParseError:
            cache[key] = None
    return cache[key]


def candidate_docs(seg: Segment, field: str, cand: Set[str]) -> np.ndarray:
    """The pre-filter: stored queries whose terms meet the candidates',
    and those that always run, among the live docs."""
    run = np.zeros(seg.ndocs, bool)
    kcol = seg.keyword_cols.get(f"{field}#terms")
    if kcol is not None and kcol.vocab:
        member = np.fromiter((v in cand for v in kcol.vocab), bool,
                             count=len(kcol.vocab))
        np.logical_or.at(run, kcol.doc_of_value[member[kcol.ords]], True)
    fcol = seg.keyword_cols.get(f"{field}#flags")
    if fcol is not None:
        run |= fcol.min_ord[:seg.ndocs] >= 0
    return run & seg.live[:seg.ndocs]


def segment_mask(field: str, mini_seg: Segment, mini_ctx: C.ShardContext,
                 seg: Segment) -> np.ndarray:
    """bool[ndocs]: the stored queries of `seg` that match at least one
    candidate document."""
    mask = np.zeros(seg.ndocs, bool)
    cand = candidate_terms(mini_seg)
    docs = np.nonzero(candidate_docs(seg, field, cand))[0]
    LAST_CANDIDATES[0] = len(docs)
    for doc in docs:
        q = _stored_query(seg, int(doc), field)
        if q is None:
            continue
        lq = C.rewrite(q, mini_ctx, scoring=False)
        if host_eval(lq, mini_seg, mini_ctx).any():
            mask[doc] = True
    return mask


def document_slots(field: str, mini_seg: Segment, mini_ctx: C.ShardContext,
                   seg: Segment, doc: int) -> List[int]:
    """The candidate documents one stored query matched (the fetch's
    `_percolator_document_slot`)."""
    q = _stored_query(seg, doc, field)
    if q is None:
        return []
    lq = C.rewrite(q, mini_ctx, scoring=False)
    return [int(i) for i in np.nonzero(host_eval(lq, mini_seg, mini_ctx))[0]]
