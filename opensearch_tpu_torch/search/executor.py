"""Per-shard search execution and the coordinator reduce (the query-phase,
fetch and batched-msearch subset of opensearch_tpu/search/executor.py).

Query-then-fetch: the query phase runs the fused kernels per segment (or,
for a single term-group search over a shard of several segments, once over
the concatenated shard view) and returns light candidate descriptors; the
coordinator merges them, and the fetch phase materializes `_id`, `_score`
and `_source` for the winners. A single search skips the segments that
`can_match` rules out. A pruned segment result that certified its page
but counted a lower bound marks the shard total "gte".
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field as dc_field
from typing import List, Optional, Tuple

import torch

from ..errors import NotPortedError
from ..index.engine import Engine
from ..index.segment import Segment
from . import compiler as C
from . import fastpath
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

    def plan(self, body: dict, ctx: C.ShardContext
             ) -> Optional[Tuple[C.LNode, fastpath.FastSpec]]:
        """-> (plan, FastSpec) of a body, or None for a plan with no
        hits."""
        window = check_body(body)
        lroot = C.rewrite(dsl.parse_query(body.get("query")), ctx)
        if isinstance(lroot, C.LMatchNone):
            return None
        return lroot, fastpath.make_spec(lroot, window, body)

    def query_phase(self, body: dict) -> ShardQueryResult:
        segments = list(self.engine.segments)
        ctx = C.ShardContext(self.engine.mappings, segments, self.similarity)
        planned = self.plan(body, ctx)
        result = ShardQueryResult(shard=self.shard_id, segments=segments)
        if planned is None:
            return result
        lroot, spec = planned
        if len(segments) > 1:
            # a many-segment shard runs a term group as ONE frontier launch
            # over the concatenated shard view
            sv = fastpath.shard_search(self.engine, ctx, spec, spec.window,
                                       self.device)
            if sv is not None:
                view, out = sv
                self.collect_view_topk(result, view, out)
                finish_candidates(result, spec.window)
                return result
        for seg_ord, seg in enumerate(segments):
            if seg.live_count == 0 or not C.can_match(lroot, seg):
                continue
            out = fastpath.batch_search(seg, ctx, [spec], spec.window,
                                        self.device)[0]
            self.collect_topk(result, out, seg, seg_ord)
        finish_candidates(result, spec.window)
        return result

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
    """Batched msearch: every body's query, term group or bool, over each
    segment runs in ONE kernel launch per shape group (grid over queries);
    all segments' launches are enqueued before the first fetch. A body
    that fails to parse gets an error entry; any other failure raises."""
    t0 = time.monotonic()
    nb = len(bodies)
    responses: List[Optional[dict]] = [None] * nb
    results = [[ShardQueryResult(shard=s.shard_id,
                                 segments=list(s.engine.segments))
                for s in searchers] for _ in range(nb)]
    launches = []
    for si, s in enumerate(searchers):
        ctx = s.context()
        specs = {}
        for bi, body in enumerate(bodies):
            if responses[bi] is not None:
                continue
            try:
                planned = s.plan(body, ctx)
            except dsl.QueryParseError as e:
                responses[bi] = {"error": {"type": "ApiError",
                                           "reason": str(e)}}
                continue
            if planned is not None:
                specs[bi] = planned[1]
        if not specs:
            continue
        bis = list(specs)
        k = max(specs[bi].window for bi in bis)
        for seg_ord, seg in enumerate(results[0][si].segments):
            if seg.live_count == 0:
                continue
            handle = fastpath.launch_batch(seg, ctx, [specs[bi] for bi in bis],
                                           k, s.device)
            launches.append((si, seg, seg_ord, bis, handle))
    for si, seg, seg_ord, bis, handle in launches:
        for bi, out in zip(bis, handle.fetch()):
            searchers[si].collect_topk(results[bi][si], out, seg, seg_ord)
    for bi, body in enumerate(bodies):
        if responses[bi] is not None:
            continue
        window = check_body(body)
        for r in results[bi]:
            finish_candidates(r, window)
        responses[bi] = finish_search(searchers, results[bi], body,
                                      index_name, t0)
    return responses
