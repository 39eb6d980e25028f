"""Per-shard search execution and the coordinator reduce (the query-phase,
fetch, aggregation and batched-msearch subset of
opensearch_tpu/search/executor.py).

Query-then-fetch: the query phase serves each segment through three
rungs in the reference's order: the fused kernels (`search/fastpath.py`;
for a single term-group search over a shard of several segments, once
over the concatenated shard view), then, for a pure term group they
decline, the codec-v2 impact rung (`search/impactpath.py`), then the
general program (`compiler.run_segment`), which serves any plan. It
returns light candidate descriptors; the coordinator merges them, and the
fetch phase materializes `_id`, `_score` and `_source` for the winners.
A single search skips the segments that `can_match` rules out. A pruned
segment result that certified its page but counted a lower bound marks
the shard total "gte". A batched msearch runs the bodies the kernels
serve on every segment as one launch per shape group; the others run as
single searches.

A body with `aggs` (or `aggregations`) leaves the kernels and the impact
rung, as the reference's does: the general program serves each segment
and evaluates the agg tree over its live-masked match in the same pass
(`compiler.emit_agg`). A segment `can_match` rules out is still read
when an agg sees docs outside the match (`global`, `filter`, `filters`,
`missing`). Each segment's outputs become host partials keyed by value
(terms by string, histograms by bucket key), the coordinator merges and
finalizes them (`search/aggregations.py`), and a bucket sub-agg outside
the stats family under `terms`, `histogram` or `date_histogram` is then
served by one size-0 sub-search per bucket (`refine_complex_subs`), as
the reference does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..errors import NotPortedError
from ..index.engine import Engine
from ..index.segment import Segment, next_pow2
from . import aggregations as A
from . import compiler as C
from . import fastpath, impactpath
from . import query_dsl as dsl

# body keys this slice serves; any other key raises NotPortedError
BODY_KEYS = {"query", "size", "from", "track_total_hits", "_source", "aggs",
             "aggregations"}


@dataclass
class Candidate:
    """One query-phase hit descriptor (Lucene ScoreDoc + shard ref)."""

    shard: int
    seg_ord: int
    local_doc: int
    score: float
    sort_values: Tuple


@dataclass
class Plan:
    """One body's plan over a shard: the rewritten root, the specs of the
    rungs that may serve it (None where a rung declines the body), and
    the window (from + size)."""

    lroot: C.LNode
    fast: Optional[fastpath.FastSpec]
    impact: Optional[impactpath.ImpactSpec]
    window: int
    aggs: List[A.AggNode] = dc_field(default_factory=list)


@dataclass
class ShardQueryResult:
    shard: int
    candidates: List[Candidate] = dc_field(default_factory=list)
    total: int = 0
    total_rel: str = "eq"   # "gte" when a pruned segment undercounted
    max_score: float = float("-inf")
    segments: List[Segment] = dc_field(default_factory=list)
    # agg name -> one host partial per segment served
    agg_partials: Dict[str, list] = dc_field(default_factory=dict)


def check_body(body: dict) -> int:
    """Validate a search body against this slice; returns from + size."""
    for key in body:
        if key not in BODY_KEYS:
            raise NotPortedError(f"search body option [{key}]")
    src = body.get("_source", True)
    if not isinstance(src, bool):
        raise NotPortedError("[_source] filtering")
    track = body.get("track_total_hits", True)
    if not isinstance(track, (bool, int)):
        raise dsl.QueryParseError(
            f"[track_total_hits] must be a boolean or an integer, got "
            f"[{track}]")
    size = int(body.get("size", 10))
    frm = int(body.get("from", 0))
    if size < 0 or frm < 0:
        raise dsl.QueryParseError("[from] and [size] must be >= 0")
    return frm + size


class ShardSearcher:
    """Executes searches over one shard's engine on one device."""

    def __init__(self, engine: Engine, device: torch.device,
                 shard_id: int = 0, similarity=None):
        self.engine = engine
        self.device = device
        self.shard_id = shard_id
        self.similarity = similarity

    def context(self) -> C.ShardContext:
        return C.ShardContext(self.engine.mappings, self.engine.segments,
                              self.similarity)

    def plan(self, body: dict, ctx: C.ShardContext) -> Optional[Plan]:
        """-> the Plan of a body, or None for a plan with no hits and no
        aggs. A body with aggs has no fast or impact spec (the
        reference's `_body_eligible`)."""
        window = check_body(body)
        aggs = A.parse_aggs(body.get("aggs", body.get("aggregations")))
        A.check_ported(aggs)
        lroot = C.rewrite(dsl.parse_query(body.get("query")), ctx)
        if aggs:
            return Plan(lroot, None, None, window, aggs)
        if isinstance(lroot, C.LMatchNone):
            return None
        return Plan(lroot, fastpath.make_spec(lroot, window, body),
                    impactpath.make_spec(lroot, window, body), window)

    def query_phase(self, body: dict) -> ShardQueryResult:
        segments = list(self.engine.segments)
        ctx = C.ShardContext(self.engine.mappings, segments, self.similarity)
        plan = self.plan(body, ctx)
        result = ShardQueryResult(shard=self.shard_id, segments=segments)
        if plan is None:
            return result
        if plan.fast is not None and len(segments) > 1:
            # a many-segment shard runs a term group as ONE frontier launch
            # over the concatenated shard view
            sv = fastpath.shard_search(self.engine, ctx, plan.fast,
                                       plan.window, self.device)
            if sv is not None:
                view, out = sv
                self.collect_view_topk(result, view, out)
                finish_candidates(result, plan.window)
                return result
        need_all = aggs_need_all_segments(plan.aggs)
        for seg_ord, seg in enumerate(segments):
            if seg.live_count == 0 or (not need_all and
                                       not C.can_match(plan.lroot, seg)):
                continue
            out = self.segment_query(plan, ctx, seg)
            self.collect_topk(result, out, seg, seg_ord)
            for node in plan.aggs:
                spec, dev = out["aggs"][node.name]
                result.agg_partials.setdefault(node.name, []).append(
                    device_agg_to_partial(node, spec, dev, seg))
        finish_candidates(result, plan.window)
        return result

    def segment_query(self, plan: Plan, ctx: C.ShardContext,
                      seg: Segment) -> dict:
        """One segment's top-k: the fused kernels, else the impact rung,
        else the general program."""
        if plan.fast is not None:
            outs = fastpath.batch_search(seg, ctx, [plan.fast], plan.window,
                                         self.device)
            if outs is not None and outs[0] is not None:
                return outs[0]
        if plan.impact is not None:
            out = impactpath.segment_search(seg, ctx, plan.impact,
                                            plan.window, self.device)
            if out is not None:
                return out
        # the reference's window (oversample 1: score order only)
        k_pad = min(next_pow2(max(plan.window, 16)), seg.ndocs_pad)
        return C.run_segment(plan.lroot, seg, ctx, k_pad, self.device,
                             plan.aggs)

    def collect_view_topk(self, result: ShardQueryResult, view,
                          out: dict) -> None:
        """Fold the shard-view launch's top-k (view-space doc ids) into
        the shard result, translating to (segment, local doc)."""
        self._fold_totals(result, out)
        for d, sc in zip(out["topk_idx"], out["topk_scores"]):
            d = int(d)
            if sc == float("-inf") or d < 0 or d >= view.ndocs:
                continue
            seg_ord, _seg, local = view.locate(d)
            result.candidates.append(Candidate(self.shard_id, seg_ord, local,
                                               float(sc), (-float(sc),)))

    @staticmethod
    def _fold_totals(result: ShardQueryResult, out: dict) -> None:
        result.total += int(out["total"])
        if out.get("total_rel") == "gte":
            result.total_rel = "gte"
        ms = float(out["max_score"])
        if ms > result.max_score:
            result.max_score = ms

    def collect_topk(self, result: ShardQueryResult, out: dict,
                     seg: Segment, seg_ord: int) -> None:
        """Fold one segment's top-k output into the shard result."""
        idx = out["topk_idx"]
        scores = out["topk_scores"]
        self._fold_totals(result, out)
        for j in range(len(scores)):
            d = int(idx[j])
            if scores[j] == float("-inf") or d < 0 or d >= seg.ndocs:
                continue
            sc = float(scores[j])
            # score ties break by (shard, segment, local doc) through the
            # stable sorts over candidates appended in that order
            result.candidates.append(
                Candidate(self.shard_id, seg_ord, d, sc, (-sc,)))

    def fetch_phase(self, result: ShardQueryResult,
                    selected: List[Candidate], body: dict,
                    index_name: str) -> List[dict]:
        hits = []
        for c in selected:
            seg = result.segments[c.seg_ord]
            hit = {"_index": index_name, "_id": seg.ids[c.local_doc],
                   "_score": c.score}
            if body.get("_source", True) is not False:
                hit["_source"] = seg.sources[c.local_doc]
            hits.append(hit)
        return hits


def finish_candidates(result: ShardQueryResult, window: int) -> None:
    """Keep only the best window of a shard."""
    result.candidates.sort(key=lambda c: c.sort_values)
    result.candidates = result.candidates[:window]


def aggs_need_all_segments(agg_nodes: List[A.AggNode]) -> bool:
    """True if an agg of the tree sees docs outside the query's match
    (global, filter, filters, missing), so that `can_match` may not skip
    a segment."""
    return any(n.kind in ("global", "filter", "filters", "missing")
               or aggs_need_all_segments(n.subs) for n in agg_nodes)


def _bucket_metric(t, j: int) -> dict:
    """A stats-family partial from the per-bucket (sums, counts, mins,
    maxs, sums of squares) arrays at bucket j."""
    sums, cnts, mins, maxs, sumsq = t
    return {"count": int(cnts[j]), "sum": float(sums[j]),
            "min": float(mins[j]), "max": float(maxs[j]),
            "sumsq": float(sumsq[j])}


def _bucket_subs(node: A.AggNode, sub_flags, out: dict, j: int) -> dict:
    return {sub.name: _bucket_metric(out[f"sub{i}"], j)
            for i, sub in enumerate(node.subs) if sub_flags[i]}


def _sub_partials(node: A.AggNode, sub_specs, out: dict, seg: Segment,
                  prefix: str = "") -> dict:
    """The partials of a container bucket's sub-aggs."""
    subs = {}
    for i, sub in enumerate(node.subs):
        r = out.get(f"{prefix}sub{i}")
        if r is not None:
            subs[sub.name] = device_agg_to_partial(sub, sub_specs[i], r, seg)
    return subs


def _hist_partial(node: A.AggNode, out: dict, min_b: int, interval: float,
                  offset: float, sub_flags) -> dict:
    buckets = {}
    for j in np.nonzero(out["counts"] > 0)[0]:
        buckets[min_b + int(j)] = {
            "doc_count": int(out["counts"][j]),
            "subs": _bucket_subs(node, sub_flags, out, int(j))}
    return {"buckets": buckets, "interval": interval, "offset": offset}


def device_agg_to_partial(node: A.AggNode, spec: tuple, out: Optional[dict],
                          seg: Segment) -> Optional[dict]:
    """One segment's `emit_agg` outputs (numpy) -> the host partial
    `aggregations.merge_partials` takes (the reference's
    `_device_agg_to_partial`), or None where the segment contributes
    nothing."""
    if out is None:
        return None
    kind = spec[0]
    if kind == "terms":
        _, field, sub_flags = spec
        vocab = seg.keyword_cols[field].vocab
        counts = out["counts"]
        buckets = {}
        for o in np.nonzero(counts > 0)[0]:
            rec: dict = {"doc_count": int(counts[o])}
            subs = _bucket_subs(node, sub_flags, out, int(o))
            if subs:
                rec["subs"] = subs
            buckets[vocab[o]] = rec
        return {"buckets": buckets}
    if kind == "hist":
        _, min_b, interval, offset, sub_flags = spec
        return _hist_partial(node, out, min_b, interval, offset, sub_flags)
    if kind == "date_hist":
        _, min_b, interval_ms, offset_ms, calendar, sub_flags = spec
        if calendar is None:
            return _hist_partial(node, out, min_b, float(interval_ms),
                                 float(offset_ms), sub_flags)
        # calendar bucket ids become epoch-ms keys on the host
        part = _hist_partial(node, out, 0, 1, 0.0, sub_flags)
        part["buckets"] = {
            C.calendar_bucket_to_epoch_ms(min_b + j, calendar): rec
            for j, rec in part["buckets"].items()}
        return part
    if kind == "range":
        _, keys, bounds, sub_specs = spec
        buckets = {}
        for ri, key in enumerate(keys):
            lo, hi = bounds[ri]
            meta = {}
            if np.isfinite(lo):
                meta["from"] = lo
            if np.isfinite(hi):
                meta["to"] = hi
            buckets[key] = {"doc_count": int(out["counts"][ri]),
                            "meta": meta,
                            "subs": _sub_partials(node, sub_specs, out, seg,
                                                  f"r{ri}_")}
        return {"buckets": buckets}
    if kind in ("filter", "filters"):
        _, keys, sub_specs = spec
        recs = [{"doc_count": int(out[f"k{ki}"]["count"]),
                 "subs": _sub_partials(node, sub_specs, out[f"k{ki}"], seg)}
                for ki in range(len(keys))]
        return recs[0] if kind == "filter" else {"buckets": dict(zip(keys,
                                                                     recs))}
    if kind in ("global", "missing"):
        return {"doc_count": int(out["count"]),
                "subs": _sub_partials(node, spec[1], out, seg)}
    if kind == "stats_missing":
        return {"count": 0, "sum": 0.0, "min": float("inf"),
                "max": float("-inf"), "sumsq": 0.0}
    if kind == "stats":
        return {"count": int(out["count"]), "sum": float(out["sum"]),
                "min": float(out["min"]), "max": float(out["max"]),
                "sumsq": float(out["sumsq"])}
    if kind == "vc_keyword":
        return {"count": int(out["count"]), "sum": 0.0, "min": 0.0,
                "max": 0.0, "sumsq": 0.0}
    if kind == "card":
        return {"registers": out["registers"]}
    # percentiles carry the queried percents, percentile_ranks the values
    key = "percents" if kind == "percentiles" else "values"
    return {"hist": out["hist"], key: list(spec[1])}


def reduce_shard_results(shard_results: List[ShardQueryResult],
                         body: dict,
                         agg_nodes: Optional[List[A.AggNode]] = None) -> dict:
    size = int(body.get("size", 10))
    frm = int(body.get("from", 0))
    all_cands: List[Candidate] = []
    total = 0
    total_rel = "eq"
    max_score = float("-inf")
    for r in shard_results:
        all_cands.extend(r.candidates)
        total += r.total
        if r.total_rel == "gte":
            total_rel = "gte"
        max_score = max(max_score, r.max_score)
    all_cands.sort(key=lambda c: c.sort_values)
    aggs_out = {}
    for node in agg_nodes or ():
        partials = [p for r in shard_results
                    for p in r.agg_partials.get(node.name, [])]
        aggs_out[node.name] = A.finalize(
            node, A.merge_partials(node, partials) if partials else {})
    return {"selected": all_cands[frm: frm + size], "total": total,
            "total_rel": total_rel,
            "max_score": None if max_score == float("-inf") else max_score,
            "aggs": aggs_out}


def finish_search(searchers: List[ShardSearcher],
                  results: List[ShardQueryResult], body: dict,
                  index_name: str, t0: float) -> dict:
    """Coordinator reduce + fetch + response assembly (shared by search
    and batched msearch), then the refinement of complex bucket subs."""
    agg_nodes = A.parse_aggs(body.get("aggs", body.get("aggregations")))
    reduced = reduce_shard_results(results, body, agg_nodes)
    hits = []
    for s, r in zip(searchers, results):
        sel = [c for c in reduced["selected"] if c.shard == r.shard]
        if sel:
            hits += s.fetch_phase(r, sel, body, index_name)
    for node in agg_nodes:
        refine_complex_subs(searchers, index_name, node,
                            reduced["aggs"][node.name], body.get("query"),
                            [])
    track = body.get("track_total_hits", True)
    relation = reduced["total_rel"]
    total = reduced["total"]
    if track is not True and track is not False:
        track_n = int(track)
        if total > track_n:
            total, relation = track_n, "gte"
    resp = {
        "took": int((time.monotonic() - t0) * 1000.0),
        "timed_out": False,
        "_shards": {"total": len(searchers), "successful": len(searchers),
                    "skipped": 0, "failed": 0},
        "hits": {"total": {"value": total, "relation": relation},
                 "max_score": reduced["max_score"],
                 "hits": hits},
    }
    if reduced["aggs"]:
        resp["aggregations"] = reduced["aggs"]
    return resp


_ORDINAL_KINDS = ("terms", "histogram", "date_histogram")


def _bucket_filter(node: A.AggNode, bucket: dict) -> dict:
    """The DSL filter of exactly one finalized bucket's docs."""
    field = node.body.get("field")
    if node.kind == "terms":
        return {"term": {field: bucket["key"]}}
    if node.kind == "histogram":
        return {"range": {field: {
            "gte": bucket["key"],
            "lt": bucket["key"] + float(node.body["interval"])}}}
    key = int(bucket["key"])
    cal = node.body.get("calendar_interval")
    if cal:
        end = C.calendar_bucket_to_epoch_ms(
            int(C.calendar_bucket_ids(np.array([key]), cal)[0]) + 1, cal)
    else:
        end = key + C.parse_interval_ms(node.body.get(
            "fixed_interval", node.body.get("interval", "1d")))
    return {"range": {field: {"gte": key, "lt": end}}}


def refine_complex_subs(searchers: List[ShardSearcher], index_name: str,
                        node: A.AggNode, result: Optional[dict],
                        query: Optional[dict], filters: List[dict]) -> None:
    """Bucket refinement (the reference's `_refine_complex_subs`): walk
    the finalized tree through the containers (filter, filters, range,
    date_range, global, missing), collecting each bucket's filter; for
    each bucket of a terms / histogram / date_histogram node with subs
    outside the stats family, run one size-0 sub-search of the query
    and those filters whose own aggs are those subs, and put its
    results in the bucket."""
    if result is None:
        return
    kind = node.kind

    def walk(sub_result_of, flt, q=query):
        for s in node.subs:
            refine_complex_subs(searchers, index_name, s, sub_result_of(s.name),
                                q, flt)

    if kind in _ORDINAL_KINDS:
        complex_subs = [s for s in node.subs if s.kind not in A.STATS_FAMILY]
        if not complex_subs:
            return
        for b in result["buckets"]:
            sub_body = {"size": 0,
                        "query": {"bool": {
                            "must": [query] if query else [],
                            "filter": filters + [_bucket_filter(node, b)]}},
                        "aggs": {s.name: _agg_to_dsl(s)
                                 for s in complex_subs}}
            resp = search_shards(searchers, sub_body, index_name)
            for s in complex_subs:
                b[s.name] = resp["aggregations"][s.name]
    elif kind == "filter":
        walk(result.get, filters + [node.body])
    elif kind == "filters":
        fmap = dict(C.filters_agg_items(node.body))
        for key, bucket in result["buckets"].items():
            walk(bucket.get, filters + [fmap[key]])
    elif kind in ("range", "date_range"):
        for bucket in result["buckets"]:
            rng = {}
            if bucket.get("from") is not None:
                rng["gte"] = bucket["from"]
            if bucket.get("to") is not None:
                rng["lt"] = bucket["to"]
            walk(bucket.get, filters + [{"range": {
                node.body.get("field"): rng}}])
    elif kind == "global":
        walk(result.get, [], None)
    elif kind == "missing":
        walk(result.get, filters + [{"bool": {"must_not": [
            {"exists": {"field": node.body.get("field")}}]}}])


def _agg_to_dsl(node: A.AggNode) -> dict:
    spec: dict = {node.kind: node.body}
    if node.subs:
        spec["aggs"] = {s.name: _agg_to_dsl(s) for s in node.subs}
    return spec


def search_shards(searchers: List[ShardSearcher], body: dict,
                  index_name: str = "") -> dict:
    """Full query-then-fetch across shards -> OpenSearch-shaped response."""
    t0 = time.monotonic()
    results = [s.query_phase(body) for s in searchers]
    return finish_search(searchers, results, body, index_name, t0)


def msearch_batched(searchers: List[ShardSearcher], bodies: List[dict],
                    index_name: str = "") -> List[dict]:
    """Batched msearch: the bodies the fused kernels serve, term group or
    bool, run over each segment in ONE kernel launch per shape group (grid
    over queries), all segments' launches enqueued before the first fetch.
    A body the kernels decline on any segment (at planning, or where a
    segment has deleted docs, or in the fetched results) runs as a single
    search instead, through every rung, as the reference's caller does. A
    body that fails to parse gets an error entry; any other failure
    raises."""
    t0 = time.monotonic()
    nb = len(bodies)
    responses: List[Optional[dict]] = [None] * nb
    results = [[ShardQueryResult(shard=s.shard_id,
                                 segments=list(s.engine.segments))
                for s in searchers] for _ in range(nb)]
    ok = [True] * nb
    specs: dict = {}
    launches = []
    for si, s in enumerate(searchers):
        ctx = s.context()
        for bi, body in enumerate(bodies):
            if responses[bi] is not None or not ok[bi]:
                continue
            try:
                plan = s.plan(body, ctx)
            except dsl.QueryParseError as e:
                responses[bi] = {"error": {"type": "ApiError",
                                           "reason": str(e)}}
                continue
            if plan is None:
                continue                 # no hits: the empty response
            if plan.fast is None:
                ok[bi] = False
            else:
                specs[bi] = plan.fast
        bis = [bi for bi in specs if ok[bi] and responses[bi] is None]
        if not bis:
            continue
        k = max(specs[bi].window for bi in bis)
        for seg_ord, seg in enumerate(results[0][si].segments):
            if seg.live_count == 0:
                continue
            handle = fastpath.launch_batch(seg, ctx, [specs[bi] for bi in bis],
                                           k, s.device, count_stats=False)
            if handle is None:
                for bi in bis:
                    ok[bi] = False
                break
            launches.append((si, seg, seg_ord, bis, handle))
    served = []
    for si, seg, seg_ord, bis, handle in launches:
        live = [bi for bi in bis if ok[bi]]
        if not live:
            continue
        outs = dict(zip(bis, handle.fetch()))
        for bi in live:
            if outs[bi] is None:
                ok[bi] = False
                continue
            served.append((bi, outs[bi]))
            searchers[si].collect_topk(results[bi][si], outs[bi], seg,
                                       seg_ord)
    # served counts only for bodies the kernels served on every segment
    for bi, out in served:
        if ok[bi]:
            fastpath.count_served([specs[bi]], [out])
    for bi, body in enumerate(bodies):
        if responses[bi] is not None:
            continue
        if not ok[bi]:
            responses[bi] = search_shards(searchers, body, index_name)
            continue
        window = check_body(body)
        for r in results[bi]:
            finish_candidates(r, window)
        responses[bi] = finish_search(searchers, results[bi], body,
                                      index_name, t0)
    return responses
