"""Per-shard search execution and the coordinator reduce (the query-phase,
fetch and batched-msearch subset of opensearch_tpu/search/executor.py).

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
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field as dc_field
from typing import List, Optional, Tuple

import torch

from ..errors import NotPortedError
from ..index.engine import Engine
from ..index.segment import Segment, next_pow2
from . import compiler as C
from . import fastpath, impactpath
from . import query_dsl as dsl

# body keys this slice serves; any other key raises NotPortedError
BODY_KEYS = {"query", "size", "from", "track_total_hits", "_source"}


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


@dataclass
class ShardQueryResult:
    shard: int
    candidates: List[Candidate] = dc_field(default_factory=list)
    total: int = 0
    total_rel: str = "eq"   # "gte" when a pruned segment undercounted
    max_score: float = float("-inf")
    segments: List[Segment] = dc_field(default_factory=list)


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
        """-> the Plan of a body, or None for a plan with no hits."""
        window = check_body(body)
        lroot = C.rewrite(dsl.parse_query(body.get("query")), ctx)
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
        for seg_ord, seg in enumerate(segments):
            if seg.live_count == 0 or not C.can_match(plan.lroot, seg):
                continue
            self.collect_topk(result, self.segment_query(plan, ctx, seg),
                              seg, seg_ord)
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
        return C.run_segment(plan.lroot, seg, ctx, k_pad, self.device)

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


def reduce_shard_results(shard_results: List[ShardQueryResult],
                         body: dict) -> dict:
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
    return {"selected": all_cands[frm: frm + size], "total": total,
            "total_rel": total_rel,
            "max_score": None if max_score == float("-inf") else max_score}


def finish_search(searchers: List[ShardSearcher],
                  results: List[ShardQueryResult], body: dict,
                  index_name: str, t0: float) -> dict:
    """Coordinator reduce + fetch + response assembly (shared by search
    and batched msearch)."""
    reduced = reduce_shard_results(results, body)
    hits = []
    for s, r in zip(searchers, results):
        sel = [c for c in reduced["selected"] if c.shard == r.shard]
        if sel:
            hits += s.fetch_phase(r, sel, body, index_name)
    track = body.get("track_total_hits", True)
    relation = reduced["total_rel"]
    total = reduced["total"]
    if track is not True and track is not False:
        track_n = int(track)
        if total > track_n:
            total, relation = track_n, "gte"
    return {
        "took": int((time.monotonic() - t0) * 1000.0),
        "timed_out": False,
        "_shards": {"total": len(searchers), "successful": len(searchers),
                    "skipped": 0, "failed": 0},
        "hits": {"total": {"value": total, "relation": relation},
                 "max_score": reduced["max_score"],
                 "hits": hits},
    }


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
