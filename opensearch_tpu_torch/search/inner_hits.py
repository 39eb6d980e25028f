"""inner_hits and the percolator's matched slots at the fetch (the
reference's `_add_inner_hits`, `_add_join_inner_hits` and
`_add_percolate_slots`, opensearch_tpu/search/executor.py).

A nested query's inner_hits score its child plan over the whole child
segment once per (query, segment) (`compiler.emit`, one copy to the
host), then each parent hit slices its block: its matching children by
score descending, `from` / `size` (3), each with `_nested.field` /
`offset` and its `_source` unless `_source` is false, under the query's
`name` or its path. has_child lists a parent hit's matching children
(through the join index's reverse lookup), has_parent the one matched
parent of a child hit. A percolate body of several documents gives each
hit `fields._percolator_document_slot` (`_<name>` after it for a named
clause): the candidates its stored query matched.
"""

from __future__ import annotations

from ..index.segment import Segment
from . import compiler as C
from . import query_dsl as dsl


def _dense_scores(key, lnode, seg: Segment, ctx, ih_cache: dict,
                  device) -> tuple:
    """(scores, matched) of `lnode` over every doc of `seg` as numpy,
    cached under `key` for the fetch."""
    if key not in ih_cache:
        sm = C.emit(lnode, seg, ctx, device)
        ih_cache[key] = (sm.scores.cpu().numpy(), sm.matched.cpu().numpy())
    return ih_cache[key]


def _page(kids, ih: dict, make) -> dict:
    kids.sort(key=lambda t: -t[0])
    frm, size = int(ih.get("from", 0)), int(ih.get("size", 3))
    return {"hits": {"total": {"value": len(kids), "relation": "eq"},
                     "max_score": kids[0][0] if kids else None,
                     "hits": [make(*k) for k in kids[frm:frm + size]]}}


def add_nested_inner_hits(hit: dict, nq: dsl.NestedQuery, seg: Segment,
                          doc: int, ctx, ih_cache: dict, device) -> None:
    blk = seg.nested.get(nq.path)
    if blk is None or blk.child.ndocs == 0:
        return
    ih = nq.inner_hits or {}
    lkey = ("nested_plan", id(nq))
    if lkey not in ih_cache:
        child_ctx = C.nested_context(ctx, nq.path)
        ih_cache[lkey] = (C.rewrite(nq.query, child_ctx, scoring=True),
                          child_ctx)
    inner, child_ctx = ih_cache[lkey]
    scores, matched = _dense_scores(("nested", id(nq), seg.uid), inner,
                                    blk.child, child_ctx, ih_cache, device)
    a, b = blk.children_of(doc)
    kids = [(float(scores[i]), i) for i in range(a, b) if matched[i]]

    def make(sc, i):
        ch = {"_index": hit.get("_index", ""), "_id": hit["_id"],
              "_nested": {"field": nq.path, "offset": i - a}, "_score": sc}
        if ih.get("_source", True) is not False:
            ch["_source"] = blk.child.sources[i]
        return ch
    hit.setdefault("inner_hits", {})[ih.get("name", nq.path)] = _page(
        kids, ih, make)


def add_join_inner_hits(hit: dict, jq, seg: Segment, doc: int, ctx,
                        ih_cache: dict, device) -> None:
    from .join import get_join_index

    jf = ctx.mappings.join_field
    if jf is None:
        return
    ji = get_join_index(ctx.segments, jf)
    ih = jq.inner_hits or {}
    has_child = isinstance(jq, dsl.HasChildQuery)
    rel = jq.type if has_child else jq.parent_type
    lkey = ("join_plan", id(jq))
    if lkey not in ih_cache:
        ih_cache[lkey] = C.rewrite(dsl.BoolQuery(
            must=[jq.query or dsl.MatchAllQuery()],
            filter=[dsl.TermQuery(field=jf, value=rel)]), ctx, scoring=True)
    lnode = ih_cache[lkey]
    if has_child:
        kids = []
        for cseg, cd in ji.children_of(ji.seg_base(seg) + doc):
            sc, cm = _dense_scores(("join", id(jq), cseg.uid), lnode, cseg,
                                   ctx, ih_cache, device)
            if cm[cd] and cseg.live[cd]:
                kids.append((float(sc[cd]), cseg, cd))

        def make(sc, cseg, cd):
            ch = {"_index": hit.get("_index", ""), "_id": cseg.ids[cd],
                  "_score": sc, "_routing": seg.ids[doc]}
            if ih.get("_source", True) is not False:
                ch["_source"] = cseg.sources[cd]
            return ch
        hit.setdefault("inner_hits", {})[ih.get("name", jq.type)] = _page(
            kids, ih, make)
        return
    slot = int(ji.pslot(seg)[doc])
    loc = ji.slot_to_doc(slot) if slot >= 0 else None
    parents = []
    if loc is not None:
        pseg, pd = loc
        sc, cm = _dense_scores(("join", id(jq), pseg.uid), lnode, pseg, ctx,
                               ih_cache, device)
        if cm[pd] and pseg.live[pd]:
            ph = {"_index": hit.get("_index", ""), "_id": pseg.ids[pd],
                  "_score": float(sc[pd])}
            if ih.get("_source", True) is not False:
                ph["_source"] = pseg.sources[pd]
            parents.append(ph)
    hit.setdefault("inner_hits", {})[ih.get("name", jq.parent_type)] = {
        "hits": {"total": {"value": len(parents), "relation": "eq"},
                 "max_score": parents[0]["_score"] if parents else None,
                 "hits": parents}}


def add_percolate_slots(hit: dict, pq: dsl.PercolateQuery, seg: Segment,
                        doc: int, ctx, ih_cache: dict) -> None:
    from . import percolate as P

    key = ("perc", id(pq))
    if key not in ih_cache:
        ih_cache[key] = P.build_mini(ctx.mappings, pq.documents, ctx.device)
    mini_seg, mini_ctx = ih_cache[key]
    field = ctx.mappings.resolve_field(pq.field)
    slots = P.document_slots(field.name if field else pq.field, mini_seg,
                             mini_ctx, seg, doc)
    name = (f"_percolator_document_slot_{pq.name}" if pq.name
            else "_percolator_document_slot")
    hit.setdefault("fields", {})[name] = slots
