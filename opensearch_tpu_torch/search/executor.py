"""Per-shard search execution and the coordinator reduce (the query-phase,
fetch, aggregation, sort, collapse and batched-msearch subset of
opensearch_tpu/search/executor.py).

Query-then-fetch: the query phase serves each segment through three
rungs in the reference's order: the fused kernels (`search/fastpath.py`;
for a single term-group search over a shard of several segments, once
over the concatenated shard view), then, for a pure term group they
decline or a root `neural_sparse` over a FEATURE plane, the codec-v2
impact rung (`search/impactpath.py`), then the
general program (`compiler.run_segment`), which serves any plan. It
returns light candidate descriptors; the coordinator merges them, and the
fetch phase materializes each winner's hit: `_id`, `_score`, `sort`,
`_source` (filtered), `fields` (doc values, source values), `highlight`.
A single search skips the segments that `can_match` rules out. A pruned
segment result that certified its page but counted a lower bound marks
the shard total "gte". A batched msearch runs the bodies the kernels
serve on every segment as one launch per shape group; the others run as
single searches.

Sort, `search_after`, `collapse` and `min_score` (`body.Order`) leave the
kernels and the impact rung unless the body ranks by the score alone
(`body.rungs_eligible`). The general program ranks each segment by the
primary sort key and keeps its best `need` docs (twice the window under
a field sort or several keys); the host then orders every candidate by
the full sort tuple (`host_sort_values`, the `_id` last), as the
reference does. Where the primary key ties past a segment's window the
page is the window's best, not the exact best (the reference's
approximation). A `_script` sort key is a painless-lite script the host
runs per doc; as the primary key, each segment hands the host every
match (its device key is missing everywhere), as the reference does. A
hit's `script_fields` run on the host at the fetch. A device script's
evaluation fault in the general program is the reference's 400. A
`search_after` cursor serves every hit strictly after
the cursor's full tuple: under several keys the device also keeps the
docs tied with the cursor's primary value and the host drops those not
after it. Collapse keeps one candidate per group per segment on the
device and per group across segments at the reduce; each group's
`inner_hits` run as one sub-search.

A body with a named clause (`_name`) leaves the kernels and the impact
rung, as the reference's does (in msearch it runs as a single search):
the general program evaluates each named node at the segment's top-k
window, and a hit lists the names of those it matches, sorted, as
`matched_queries`.

A body with `aggs` (or `aggregations`) leaves the kernels and the impact
rung, as the reference's does: the general program serves each segment
and evaluates the agg tree over its live-masked match in the same pass
(`compiler.emit_agg`). A segment `can_match` rules out is still read
when an agg sees docs outside the match (`global`, `filter`, `filters`,
`missing`, `significant_terms`' background). Each segment's outputs
become host partials keyed by value (terms by string, histograms by
bucket key), the coordinator merges and finalizes them
(`search/aggregations.py`), and a bucket sub-agg outside the stats
family under an ordinal bucket kind (`ORDINAL_KINDS`) is then served by
one size-0 sub-search per bucket (`refine_complex_subs`), as the
reference does; the pipelines that read such a sub run after it
(`mark_deferred_pipelines`). A root `top_hits` reads the shard's
candidates (the window of the body's rung, 16 docs a segment for a
size-0 body, as in the reference), and a root `sampler` over several
segments takes its second pass at one shard-wide score threshold
(`resample_samplers`). A `scripted_metric` runs its init, map and
combine scripts per segment on the host over the segment's match
(`scripted_metric_partial`), its reduce script at the coordinator.
"""

from __future__ import annotations

import fnmatch
import time
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..errors import NotPortedError
from ..index.engine import Engine
from ..index.segment import Segment, next_pow2
from ..script import painless_lite as pl
from ..utils import deadline as DL
from . import aggregations as A
from . import body as B
from . import compiler as C
from . import explain as X
from . import fastpath, impactpath
from . import highlight as H
from . import query_dsl as dsl

INT32_SENTINEL = np.int32(2**31 - 1)

@dataclass
class Candidate:
    """One query-phase hit descriptor (Lucene ScoreDoc + shard ref)."""

    shard: int
    seg_ord: int
    local_doc: int
    score: float
    sort_values: Tuple            # host-comparable, direction-adjusted
    raw_sort_values: Tuple = ()   # the hit's `sort` array
    collapse_key: Any = None      # the collapse group (None: null group)
    matched_queries: List[str] = dc_field(default_factory=list)


@dataclass
class Plan:
    """One body's plan over a shard: the rewritten root, the specs of the
    rungs that may serve it (None where a rung declines the body), the
    window (from + size) and the body's ranking."""

    lroot: C.LNode
    fast: Optional[fastpath.FastSpec]
    impact: Optional[impactpath.ImpactSpec]
    window: int
    order: B.Order
    aggs: List[A.AggNode] = dc_field(default_factory=list)
    named: List[Tuple[str, C.LNode]] = dc_field(default_factory=list)
    # (rescorer, its rewritten query) in the body's order
    rescores: List[Tuple[B.Rescorer, C.LNode]] = dc_field(
        default_factory=list)


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
    took_ms: float = 0.0
    # the time budget ran out / the terminate_after budget was reached
    # between segments
    timed_out: bool = False
    terminated_early: bool = False


class ShardSearcher:
    """Executes searches over one shard's engine on one device."""

    def __init__(self, engine: Engine, device: torch.device,
                 shard_id: int = 0, similarity=None, index_name: str = ""):
        self.engine = engine
        self.device = device
        self.shard_id = shard_id
        self.similarity = similarity
        self.index_name = index_name

    def context(self, segments: Optional[List[Segment]] = None
                ) -> C.ShardContext:
        return C.ShardContext(self.engine.mappings,
                              self.engine.segments if segments is None
                              else segments, self.similarity, self.device)

    def plan(self, body: dict, ctx: C.ShardContext) -> Optional[Plan]:
        """-> the Plan of a body, or None for a plan with no hits and no
        aggs. A body with aggs or a named clause has no fast or impact
        spec (the reference's `_body_eligible`). A rescored body keeps
        the kernels, whose pruned ladder then certifies every lane the
        rescore reads, but not the impact rung, which returns the page's
        `window` lanes alone where the kernels and the general path
        return K: a rescore window past the page would see fewer docs
        there (the reference's client, whose mesh turns its impact rung
        off, serves such a segment on the general path)."""
        window = B.check_body(body)
        order = B.Order.of(body, window)
        aggs = A.parse_aggs(body.get("aggs", body.get("aggregations")))
        A.check_ported(aggs)
        lroot = C.rewrite(compose_knn_query(body), ctx)
        named = collect_named(lroot)
        rescores = []
        for r in B.rescorers(body):
            try:
                rescores.append((r, C.rewrite(r.query, ctx)))
            except NotPortedError as e:
                raise NotPortedError(f"rescore query: {e.what}")
        if aggs or named:
            return Plan(lroot, None, None, window, order, aggs, named,
                        rescores)
        if isinstance(lroot, C.LMatchNone):
            return None
        fast = fastpath.make_spec(lroot, window, body)
        if fast is not None and rescores:
            # the rescore reads the first min(window_size, K) lanes: the
            # pruned ladder certifies that many, not the page alone
            k_lanes = min(next_pow2(max(window, 16)), fastpath.MAX_K)
            fast.window = max(window, min(
                max(r.window for r, _ in rescores), k_lanes))
        return Plan(lroot, fast, None if rescores else
                    impactpath.make_spec(lroot, window, body), window,
                    order, rescores=rescores)

    def query_phase(self, body: dict,
                    segments: Optional[List[Segment]] = None
                    ) -> ShardQueryResult:
        """One shard's query phase over `segments` (the engine's current
        list by default; a scroll or point in time passes its snapshot)
        with those segments' collection statistics (an index is one
        shard, so they are the reference's `stats_ctx` of a snapshot).
        `terminate_after` and the ambient deadline
        (`utils/deadline.py`) stop it between segments, as the
        reference's: a stop with live segments left makes the total a
        lower bound."""
        t0 = time.monotonic()
        snapshot = segments is not None
        segments = list(self.engine.segments if segments is None
                        else segments)
        ctx = self.context(segments)
        plan = self.plan(body, ctx)
        result = ShardQueryResult(shard=self.shard_id, segments=segments)
        ta = int(body.get("terminate_after") or 0)
        deadline = DL.current()
        if (plan is not None and plan.fast is not None and len(segments) > 1
                and not snapshot and not plan.rescores and not ta):
            # a many-segment shard runs a term group as ONE frontier launch
            # over the concatenated shard view (built over the engine's
            # current segments, so a snapshot takes the per-segment loop);
            # a rescore and terminate_after need that loop, as in the
            # reference
            sv = fastpath.shard_search(self.engine, ctx, plan.fast,
                                       plan.window, self.device)
            if sv is not None:
                view, out = sv
                self.collect_view_topk(result, view, out, plan.order)
                finish_candidates(result, plan.order.need)
                result.took_ms = (time.monotonic() - t0) * 1000.0
                return result
        need_all = plan is not None and aggs_need_all_segments(plan.aggs)
        ran = []
        for seg_ord, seg in enumerate(segments):
            if ta and result.total >= ta:
                result.terminated_early = True
                if any(s.live_count for s in segments[seg_ord:]):
                    result.total_rel = "gte"
                break
            if deadline is not None and deadline.exhausted():
                result.timed_out = True
                if any(s.live_count for s in segments[seg_ord:]):
                    result.total_rel = "gte"
                break
            if plan is None or seg.live_count == 0 or (
                    not need_all and not C.can_match(plan.lroot, seg)):
                continue
            out = self.segment_query(plan, ctx, seg)
            ran.append(seg)
            self.collect_topk(result, out, seg, seg_ord, plan.order,
                              plan.rescores, ctx)
            for node in plan.aggs:
                if node.kind == "top_hits":
                    continue
                spec, dev = out["aggs"][node.name]
                result.agg_partials.setdefault(node.name, []).append(
                    device_agg_to_partial(node, spec, dev, seg, ctx))
        if ta and result.total >= ta:
            # the budget was reached, on the last segment too
            result.terminated_early = True
        if plan is not None:
            self.resample_samplers(plan, result, ran, ctx)
            self.root_top_hits(plan, result)
            finish_candidates(result, plan.order.need)
        result.took_ms = (time.monotonic() - t0) * 1000.0
        return result

    def resample_samplers(self, plan: Plan, result: ShardQueryResult,
                          ran: List[Segment], ctx: C.ShardContext) -> None:
        """A root sampler's second pass (the reference's
        `_resample_samplers`): the first pass sampled each segment's
        best shard_size docs; over several segments, the merged top
        scores give one shard-wide threshold (the shard_size-th best),
        and the agg tree alone reruns on each segment at it. A sampler
        under another bucket keeps the per-segment pass."""
        for node in plan.aggs:
            if node.kind != "sampler":
                continue
            parts = [p for p in result.agg_partials.get(node.name, []) if p]
            tops = [p.pop("topscores") for p in parts if "topscores" in p]
            if len(parts) <= 1 or not tops:
                continue
            shard_size = max(int(node.body.get("shard_size", 100)), 1)
            scores = np.concatenate(tops)
            scores = scores[np.isfinite(scores)]
            if len(scores) <= shard_size:
                continue        # fewer matches than shard_size: exact
            node.global_thr = float(np.sort(scores)[-shard_size])
            try:
                result.agg_partials[node.name] = [
                    device_agg_to_partial(node, *C.run_agg_only(
                        plan.lroot, node, seg, ctx, self.device), seg, ctx)
                    for seg in ran]
            finally:
                node.global_thr = None

    def root_top_hits(self, plan: Plan, result: ShardQueryResult) -> None:
        """A root top_hits' partial: the shard's candidates (every
        segment's top-k window, before the cut to the page) by score
        descending, stably, its first `size` fetched with the agg's own
        body (`_source`, `sort`), as the reference's query phase does;
        its `from` and `sort` do not reorder them there either."""
        for node in plan.aggs:
            if node.kind != "top_hits":
                continue
            top = sorted(result.candidates, key=lambda c: -(c.score or 0.0))
            size = int(node.body.get("size", 3))
            suppress = B.suppress_score(node.body)
            hits = [self.fetch_one(result.segments[c.seg_ord], c, node.body,
                                   self.index_name, {}, suppress)
                    for c in top[:size]]
            result.agg_partials[node.name] = [
                {"hits": hits, "total": result.total, "size": size}]

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
        if plan.order.script_sort:
            if plan.order.after is not None:
                raise dsl.QueryParseError("search_after is not supported "
                                          "with a primary _script sort")
            # the script's order is the host's: every match of the
            # segment is a candidate
            k_pad = seg.ndocs_pad
        else:
            # the reference's window: the body's need, at least 16, a
            # power of two
            k_pad = min(next_pow2(max(plan.order.need, 16)), seg.ndocs_pad)
        try:
            return C.run_segment(plan.lroot, seg, ctx, k_pad, self.device,
                                 plan.aggs, plan.order, plan.named)
        except pl.ScriptError as e:
            # a device script's evaluation fault is the client's (400)
            raise dsl.QueryParseError(f"script compile error: {e}")

    def collect_view_topk(self, result: ShardQueryResult, view,
                          out: dict, order: B.Order) -> None:
        """Fold the shard-view launch's top-k (view-space doc ids) into
        the shard result, translating to (segment, local doc)."""
        self._fold_totals(result, out)
        for d, sc in zip(out["topk_idx"], out["topk_scores"]):
            d = int(d)
            if sc == float("-inf") or d < 0 or d >= view.ndocs:
                continue
            seg_ord, seg, local = view.locate(d)
            result.candidates.append(self._candidate(
                seg, seg_ord, local, float(sc), order))

    @staticmethod
    def _fold_totals(result: ShardQueryResult, out: dict) -> None:
        result.total += int(out["total"])
        if out.get("total_rel") == "gte":
            result.total_rel = "gte"
        ms = float(out["max_score"])
        if ms > result.max_score:
            result.max_score = ms

    def _candidate(self, seg: Segment, seg_ord: int, d: int, sc: float,
                   order: B.Order) -> Candidate:
        sort_vals, raw = host_sort_values(order.specs, seg, d, sc)
        c = Candidate(self.shard_id, seg_ord, d, sc, sort_vals, raw)
        if order.collapse is not None:
            c.collapse_key = collapse_key_value(seg, order.collapse, d)
        return c

    def collect_topk(self, result: ShardQueryResult, out: dict,
                     seg: Segment, seg_ord: int, order: B.Order,
                     rescores=(), ctx: Optional[C.ShardContext] = None
                     ) -> None:
        """Fold one segment's top-k output into the shard result: every
        valid candidate with its host sort tuple and the names of the
        named clauses it matches (`out["named"]`: name -> matched at each
        top-k doc, from the general program), less those under
        `min_score` (score order only) and, under several sort keys,
        those not strictly after the cursor; the device counted the docs
        after the cursor's primary key, and the host adds those tied
        with it that are after its full tuple (the segment's window holds
        all of them, `compiler.run_segment`). The body's rescorers apply
        to the lanes first (`apply_rescores`); the max score stays the
        first phase's."""
        idx = out["topk_idx"]
        scores = out["topk_scores"]
        keys = out.get("topk_key", scores)
        named = out.get("named")
        self._fold_totals(result, out)
        if rescores:
            scores = apply_rescores(rescores, ctx, seg, idx,
                                    keys > -np.inf, scores, self.device)
        cursor = (cursor_tuple(order)
                  if order.after is not None and order.multi else None)
        for j in range(len(scores)):
            d = int(idx[j])
            if keys[j] == float("-inf") or d < 0 or d >= seg.ndocs:
                continue
            sc = float(scores[j])
            # ties of the full tuple break by (shard, segment, local doc)
            # through the stable sorts over candidates appended in that
            # order
            c = self._candidate(seg, seg_ord, d, sc, order)
            if cursor is not None:
                if not cursor < c.sort_values[:len(cursor)]:
                    continue
                if c.sort_values[0] == cursor[0] and order.collapse is None:
                    result.total += 1
                    result.max_score = max(result.max_score, sc)
            if order.min_score is not None and not order.field_sort \
                    and sc < order.min_score:
                continue
            if named:
                c.matched_queries = [nm for nm, hit in named.items()
                                     if hit[j]]
            result.candidates.append(c)

    def fetch_phase(self, result: ShardQueryResult,
                    selected: List[Candidate], body: dict,
                    index_name: str) -> List[dict]:
        """The selected hits; with `explain`, each one's `_explanation`
        under the statistics the query phase scored with (those of the
        result's segments)."""
        hl_terms = {}
        explain = bool(body.get("explain"))
        lroot = None
        if body.get("highlight") or explain:
            ctx = self.context(result.segments)
            lroot = C.rewrite(dsl.parse_query(body.get("query")), ctx)
        if body.get("highlight"):
            hl_terms = H.collect_query_terms(lroot)
        suppress = B.suppress_score(body)
        hits = []
        for c in selected:
            seg = result.segments[c.seg_ord]
            hit = self.fetch_one(seg, c, body, index_name, hl_terms,
                                 suppress)
            if explain:
                hit["_explanation"] = X.explain_doc(lroot, seg, c.local_doc,
                                                    ctx)
            hits.append(hit)
        return hits

    def fetch_one(self, seg: Segment, c: Candidate, body: dict,
                  index_name: str, hl_terms: dict,
                  suppress: bool) -> dict:
        """One hit (the reference's `_fetch_one`)."""
        doc = c.local_doc
        hit = {"_index": index_name, "_id": seg.ids[doc], "_score": c.score}
        if body.get("sort"):
            hit["sort"] = list(c.raw_sort_values)
            if suppress:
                hit["_score"] = None
        stored_opt = body.get("stored_fields")
        # asking for stored_fields suppresses _source unless the body
        # opts back in
        src_opt = body.get("_source", True if stored_opt is None else False)
        if src_opt is not False:
            hit["_source"] = filter_source(seg.sources[doc], src_opt)
        if stored_opt and stored_opt != "_none_":
            stored = (seg.stored_vals[doc] if seg.stored_vals else None) or {}
            flds = hit.setdefault("fields", {})
            for f in (stored_opt if isinstance(stored_opt, list)
                      else [stored_opt]):
                if f in stored:
                    flds[f] = list(stored[f])
        if body.get("docvalue_fields"):
            hit.setdefault("fields", {}).update(
                docvalue_fields(seg, doc, body["docvalue_fields"]))
        if body.get("fields"):
            flds = hit.setdefault("fields", {})
            for f in body["fields"]:
                fname = f if isinstance(f, str) else f.get("field")
                vals = extract_source_values(seg.sources[doc], fname)
                if vals:
                    flds[fname] = vals
        if body.get("script_fields"):
            flds = hit.setdefault("fields", {})
            for fname, fspec in body["script_fields"].items():
                src_str, prm = dsl.parse_script_spec(fspec.get("script"))
                try:
                    v = pl.run_field_script(src_str, prm, seg, doc,
                                            score=c.score)
                except pl.ScriptError as e:
                    raise dsl.QueryParseError(
                        f"[script_fields.{fname}]: {e}")
                flds[fname] = v if isinstance(v, list) else [v]
        if body.get("highlight"):
            hl = self.highlight(seg.sources[doc], body["highlight"],
                                hl_terms)
            if hl:
                hit["highlight"] = hl
        if c.matched_queries:
            hit["matched_queries"] = c.matched_queries
        return hit

    def highlight(self, source: dict, hl_body: dict, hl_terms: dict) -> dict:
        """field -> fragments of the body's `highlight` (plain or
        unified; `fvh` is unified here, as the reference runs it without
        stored term vectors)."""
        mappings = self.engine.mappings
        hl = {}
        for fname, fopts in hl_body.get("fields", {}).items():
            ft = mappings.resolve_field(fname)
            if ft is None:
                continue
            fopts = fopts or {}
            kw = dict(
                pre_tag=(hl_body.get("pre_tags") or ["<em>"])[0],
                post_tag=(hl_body.get("post_tags") or ["</em>"])[0],
                fragment_size=int(fopts.get(
                    "fragment_size", hl_body.get("fragment_size", 100))),
                number_of_fragments=int(fopts.get(
                    "number_of_fragments",
                    hl_body.get("number_of_fragments", 5))))
            kind = fopts.get("type", hl_body.get("type", "plain"))
            fn = (H.highlight_unified if kind in ("unified", "fvh")
                  else H.highlight_field)
            analyzer = mappings.index_analyzer(ft)
            terms = hl_terms.get(fname, set())
            frags = []
            for v in extract_source_values(source, fname):
                frags.extend(fn(str(v), terms, analyzer, **kw))
            if frags:
                hl[fname] = frags
        return hl


def collect_named(lroot: C.LNode) -> List[Tuple[str, C.LNode]]:
    """(name, node) of every named node of a plan, as the reference's
    `_collect_named` walks it: a bool's clauses, a dis_max's children, a
    constant_score's or terms_set's child, a boosting's both sides; not
    a pinned query's organic clause."""
    out = []

    def walk(n):
        # a rank_feature node's `positive` is a flag, not a clause
        if not isinstance(n, C.LNode):
            return
        if n.name:
            out.append((n.name, n))
        for attr in ("musts", "shoulds", "must_nots", "filters", "children"):
            for c in getattr(n, attr, ()):
                walk(c)
        for attr in ("child", "positive", "negative"):
            walk(getattr(n, attr, None))

    walk(lroot)
    return out


def apply_rescores(rescores, ctx: C.ShardContext, seg: Segment,
                   idx: np.ndarray, valid: np.ndarray, scores: np.ndarray,
                   device) -> np.ndarray:
    """A segment's first-phase lanes after each rescorer in turn (the
    reference's `_apply_rescores`): the valid lanes before `window_size`
    take `combine_rescore(qw * score, rw * rescore)` where the rescore
    query matches, else `qw * score`; the others keep their score. The
    rescore query's scores and matches at the lanes' docs come from one
    `compiler.gather_scores`, the invalid lanes' docs clamped as the
    reference clamps them."""
    pad = seg.ndocs_pad
    docs = np.minimum(np.where(valid, idx, INT32_SENTINEL % pad),
                      pad - 1).astype(np.int32)
    for r, lr in rescores:
        rscores, rmatched = C.gather_scores(lr, seg, ctx, docs, device)
        in_window = np.arange(len(scores)) < r.window
        qs = r.query_weight * scores
        # an invalid lane's -inf times 0 is a NaN that np.where drops
        with np.errstate(invalid="ignore"):
            combined = np.where(rmatched, B.combine_rescore(
                r.mode, qs, r.rescore_weight * rscores), qs)
        scores = np.where(valid & in_window, combined, scores)
    return scores


def finish_candidates(result: ShardQueryResult, need: int) -> None:
    """Keep only a shard's best `need` candidates."""
    result.candidates.sort(key=lambda c: c.sort_values)
    result.candidates = result.candidates[:need]


# ---------------------------------------------------------------------
# host sort tuples, the cursor, collapse keys and the fetch's fields
# ---------------------------------------------------------------------

class StrKey:
    """A string sort key that can order descending inside a tuple."""

    __slots__ = ("s", "desc")

    def __init__(self, s: str, desc: bool):
        self.s = s
        self.desc = desc

    def __lt__(self, other):
        return (self.s > other.s) if self.desc else (self.s < other.s)

    def __eq__(self, other):
        return self.s == other.s


def render_numeric(col, doc: int):
    """A numeric column's value of `doc` as JSON shows it (the
    reference's `_render_numeric`): an unsigned_long unbiased, an ip as
    its integer."""
    v = col.values[doc]
    if col.kind == "float":
        return float(v)
    if col.kind == "uint":
        return int(v) + (1 << 63)
    return int(v)


def _field_order(spec: dict) -> Tuple[bool, bool]:
    """(descending, missing last) of a sort spec."""
    f = spec["field"]
    desc = spec.get("order", "desc" if f == "_score" else "asc") == "desc"
    return desc, spec.get("missing", "_last") == "_last"


def host_sort_values(specs: List[dict], seg: Segment, doc: int,
                     score: float) -> Tuple[Tuple, Tuple]:
    """(comparison tuple, ascending; the hit's raw sort values) of one
    doc (the reference's `_host_sort_values`): per key the score
    (negated descending), the local doc, or for a field (0, value) with
    a missing value at (1, 0) last or (-1, 0) first; then the `_id`.
    Without a sort: (-score,), ties left to the stable sorts."""
    if not specs:
        return (-score,), (score,)
    comp: list = []
    raw: list = []
    for spec in specs:
        f = spec["field"]
        desc, missing_last = _field_order(spec)
        if f == "_score":
            comp.append(-score if desc else score)
            raw.append(score)
            continue
        if f == "_doc":
            comp.append(doc)
            raw.append(doc)
            continue
        if f == "_script":
            src_str, prm = dsl.parse_script_spec(spec.get("script"))
            try:
                v = pl.run_field_script(src_str, prm, seg, doc, score=score)
            except pl.ScriptError as e:
                raise dsl.QueryParseError(f"[_script sort]: {e}")
            if spec.get("type") == "string":
                comp.append((0, StrKey(str(v), desc)))
            else:
                v = float(v)
                comp.append((0, -v if desc else v))
            raw.append(v)
            continue
        col = seg.numeric_cols.get(f)
        if col is not None and col.present[doc]:
            v = render_numeric(col, doc)
            comp.append((0, -v if desc else v))
            raw.append(v)
            continue
        kcol = seg.keyword_cols.get(f)
        if kcol is not None and kcol.min_ord[doc] >= 0:
            sv = kcol.vocab[kcol.min_ord[doc]]
            comp.append((0, StrKey(sv, desc)))
            raw.append(sv)
            continue
        comp.append((1 if missing_last else -1, 0))
        raw.append(None)
    comp.append(seg.ids[doc])
    return tuple(comp), tuple(raw)


def cursor_tuple(order: B.Order) -> Tuple:
    """The `search_after` cursor as `host_sort_values` compares (without
    the `_id`): a candidate is after it when its tuple is greater."""
    comp: list = []
    specs = order.specs or [{"field": "_score", "order": "desc"}]
    for spec, v in zip(specs, order.after):
        f = spec["field"]
        desc, missing_last = _field_order(spec)
        if f == "_score":
            comp.append(-float(v) if desc else float(v))
        elif f == "_doc":
            comp.append(int(v))
        elif v is None:
            comp.append((1 if missing_last else -1, 0))
        elif isinstance(v, str):
            comp.append((0, StrKey(v, desc)))
        else:
            comp.append((0, -v if desc else v))
    return tuple(comp)


def collapse_key_value(seg: Segment, field: str, doc: int):
    """The collapse group of one doc: a keyword's smallest value, a
    numeric value, or None (the null group)."""
    kcol = seg.keyword_cols.get(field)
    if kcol is not None:
        o = int(kcol.min_ord[doc])
        return kcol.vocab[o] if o >= 0 else None
    ncol = seg.numeric_cols.get(field)
    if ncol is not None and ncol.present[doc]:
        return render_numeric(ncol, doc)
    return None


def filter_source(src: dict, opt) -> dict:
    """`_source` filtering (the reference's `_filter_source`): paths of
    the flattened source kept by `includes` (a glob, or a prefix of the
    path) and not dropped by `excludes`."""
    if opt is True:
        return src
    if isinstance(opt, str):
        opt = {"includes": [opt]}
    if isinstance(opt, list):
        opt = {"includes": opt}
    includes = opt.get("includes", [])
    excludes = opt.get("excludes", [])

    def flatten(d, prefix=""):
        for k, v in d.items():
            path = f"{prefix}{k}"
            if isinstance(v, dict):
                yield from flatten(v, f"{path}.")
            else:
                yield path, v

    def keep(path):
        if includes and not any(fnmatch.fnmatch(path, p)
                                or path.startswith(p + ".")
                                for p in includes):
            return False
        return not any(fnmatch.fnmatch(path, p) for p in excludes)

    out: dict = {}
    for path, v in flatten(src):
        if keep(path):
            node = out
            parts = path.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return out


def docvalue_fields(seg: Segment, doc: int, specs: List) -> dict:
    """field -> the doc's values from its numeric or keyword column."""
    out = {}
    for spec in specs:
        f = spec if isinstance(spec, str) else spec.get("field")
        col = seg.numeric_cols.get(f)
        if col is not None and col.present[doc]:
            out[f] = [render_numeric(col, doc)]
            continue
        kcol = seg.keyword_cols.get(f)
        if kcol is not None:
            a, b = int(kcol.starts[doc]), int(kcol.starts[doc + 1])
            if b > a:
                out[f] = [kcol.vocab[o] for o in kcol.ords[a:b]]
    return out


def extract_source_values(src: dict, path: str) -> List:
    """The values at a dotted path of a source, as a list."""
    node: Any = src
    for part in path.split("."):
        if isinstance(node, dict):
            node = node.get(part)
        elif isinstance(node, list):
            node = [n.get(part) for n in node if isinstance(n, dict)]
        else:
            return []
        if node is None:
            return []
    return node if isinstance(node, list) else [node]


def aggs_need_all_segments(agg_nodes: List[A.AggNode]) -> bool:
    """True if an agg of the tree sees docs outside the query's match
    (global, filter, filters, missing, significant_terms' background),
    so that `can_match` may not skip a segment."""
    return any(n.kind in ("global", "filter", "filters", "missing",
                          "significant_terms")
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
                  ctx, prefix: str = "") -> dict:
    """The partials of a container bucket's sub-aggs."""
    subs = {}
    for i, sub in enumerate(node.subs):
        r = out.get(f"{prefix}sub{i}")
        if r is not None:
            subs[sub.name] = device_agg_to_partial(sub, sub_specs[i], r, seg,
                                                   ctx)
    return subs


def _keyed_buckets(node: A.AggNode, out: dict, keys, sub_flags) -> dict:
    """Nonzero counts keyed by `keys[ordinal]`, with their stats subs."""
    buckets = {}
    for o in np.nonzero(out["counts"] > 0)[0]:
        rec: dict = {"doc_count": int(out["counts"][o])}
        subs = _bucket_subs(node, sub_flags, out, int(o))
        if subs:
            rec["subs"] = subs
        buckets[keys[o]] = rec
    return buckets


def _hist_partial(node: A.AggNode, out: dict, min_b: int, interval: float,
                  offset: float, sub_flags) -> dict:
    buckets = {}
    for j in np.nonzero(out["counts"] > 0)[0]:
        buckets[min_b + int(j)] = {
            "doc_count": int(out["counts"][j]),
            "subs": _bucket_subs(node, sub_flags, out, int(j))}
    return {"buckets": buckets, "interval": interval, "offset": offset}


def device_agg_to_partial(node: A.AggNode, spec: tuple, out: Optional[dict],
                          seg: Segment, ctx: C.ShardContext
                          ) -> Optional[dict]:
    """One segment's `emit_agg` outputs (numpy) -> the host partial
    `aggregations.merge_partials` takes (the reference's
    `_device_agg_to_partial`), or None where the segment contributes
    nothing."""
    if out is None:
        return None
    kind = spec[0]
    if kind == "scripted":
        return scripted_metric_partial(node, out["match_mask"], seg)
    if kind in ("terms", "sig_terms"):
        _, field, sub_flags = spec
        part = {"buckets": _keyed_buckets(
            node, out, seg.keyword_cols[field].vocab, sub_flags)}
        if kind == "sig_terms":
            part.update(fg_total=int(out["fg_total"]),
                        bg=C.kw_doc_counts(seg, field),
                        bg_total=seg.live_count)
        return part
    if kind == "sig_missing":
        return {"buckets": {}, "fg_total": 0, "bg": {},
                "bg_total": seg.live_count}
    if kind == "multi_terms":
        _, fields, sub_flags = spec
        vocab, _ords = C.multi_terms_host(seg, ctx, fields)
        return {"buckets": _keyed_buckets(node, out, vocab, sub_flags)}
    if kind == "composite_mv":
        _, field, sub_flags = spec
        return {"buckets": _keyed_buckets(
            node, out, [(v,) for v in seg.keyword_cols[field].vocab],
            sub_flags)}
    if kind == "composite":
        return _composite_partial(node, spec, out, seg)
    if kind == "auto_date":
        _, min_b, interval_ms, sub_flags = spec
        part = _hist_partial(node, out, min_b, float(interval_ms), 0.0,
                             sub_flags)
        return {"buckets": {int(b * interval_ms): rec
                            for b, rec in part["buckets"].items()},
                "interval_ms": int(interval_ms)}
    if kind == "adjacency":
        _, keys, sep, sub_specs = spec
        labels = list(keys) + [f"{keys[a]}{sep}{keys[b]}"
                               for a in range(len(keys))
                               for b in range(a + 1, len(keys))]
        return {"buckets": {label: {
            "doc_count": int(out[f"c{ci}"]),
            "subs": _sub_partials(node, sub_specs, out, seg, ctx,
                                  f"c{ci}_")}
            for ci, label in enumerate(labels)}}
    if kind == "sampler":
        part = {"doc_count": int(out["doc_count"]),
                "subs": _sub_partials(node, spec[1], out, seg, ctx)}
        if "topscores" in out:
            part["topscores"] = out["topscores"]
        return part
    if kind == "sig_text":
        return _significant_text_partial(spec[1], out, seg, ctx)
    if kind == "top_hits":
        raise ValueError("cannot build partial for agg spec [top_hits]")
    if kind == "wavg":
        return {"vwsum": float(out["vwsum"]), "wsum": float(out["wsum"]),
                "count": int(out["count"])}
    if kind == "mad":
        return {"hist": out["hist"]}
    if kind == "matrix_stats":
        fields = list(spec[1])
        k = len(fields)
        if len(spec) < 3:
            return {"count": 0, "fields": fields, "shift": np.zeros(k),
                    "s1": np.zeros(k), "s2": np.zeros(k), "s3": np.zeros(k),
                    "s4": np.zeros(k), "xy": np.zeros((k, k))}
        return {"count": int(out["count"]), "fields": fields,
                "shift": np.asarray(spec[2], np.float64),
                **{key: np.asarray(out[key], np.float64)
                   for key in ("s1", "s2", "s3", "s4", "xy")}}
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
                                                  ctx, f"r{ri}_")}
        return {"buckets": buckets}
    if kind == "ip_range":
        _, keys, bounds, sub_specs = spec
        counts = out["counts"]
        buckets = {}
        for ri, key in enumerate(keys):
            frm, to = bounds[ri]
            meta = {}
            if frm is not None:
                meta["from"] = frm
            if to is not None:
                meta["to"] = to
            buckets[key] = {"doc_count": int(counts[ri]), "meta": meta,
                            "subs": _sub_partials(node, sub_specs, out, seg,
                                                  ctx, f"r{ri}_")}
        return {"buckets": buckets}
    if kind in ("filter", "filters"):
        _, keys, sub_specs = spec
        recs = [{"doc_count": int(out[f"k{ki}"]["count"]),
                 "subs": _sub_partials(node, sub_specs, out[f"k{ki}"], seg,
                                       ctx)}
                for ki in range(len(keys))]
        return recs[0] if kind == "filter" else {"buckets": dict(zip(keys,
                                                                     recs))}
    if kind in ("global", "missing"):
        return {"doc_count": int(out["count"]),
                "subs": _sub_partials(node, spec[1], out, seg, ctx)}
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


def _composite_partial(node: A.AggNode, spec: tuple, out: dict,
                       seg: Segment) -> dict:
    """A composite's buckets keyed by the tuple of its sources' values,
    decoded from each nonzero combined ordinal: a keyword, a histogram
    key (bucket x interval), a date bucket's epoch ms."""
    _, infos, _total, sub_flags = spec
    keys = {}
    for comb in np.nonzero(out["counts"] > 0)[0].tolist():
        vals = []
        rem = comb
        for stype, field, n, min_b, interval, cal in reversed(infos):
            rem, o = divmod(rem, n)
            if stype == "terms":
                vals.append(seg.keyword_cols[field].vocab[o])
            elif stype == "hist":
                vals.append((min_b + o) * interval)
            elif cal:
                vals.append(C.calendar_bucket_to_epoch_ms(min_b + o, cal))
            else:
                vals.append(int((min_b + o) * interval))
        keys[comb] = tuple(reversed(vals))
    return {"buckets": _keyed_buckets(node, out, keys, sub_flags)}


def _significant_text_partial(field: str, out: dict, seg: Segment,
                              ctx: C.ShardContext) -> dict:
    """significant_text (the reference's `_significant_text_partial`):
    the sampled docs' `field` text from `_source`, re-analyzed with the
    field's search analyzer, each token counted once a doc; its
    background is the token's doc frequency in the segment's
    postings."""
    docs = out["idx"][:int(out["n"])]
    fg: Dict[str, int] = {}
    for d in docs.tolist():
        src = seg.sources[d]
        v = src.get(field) if isinstance(src, dict) else None
        if v is None:
            continue
        seen = set()
        for text in (v if isinstance(v, list) else [v]):
            seen.update(C._analyze_query_text(field, str(text), ctx))
        for tok in seen:
            fg[tok] = fg.get(tok, 0) + 1
    pb = seg.postings.get(field)
    return {"buckets": {tok: {"doc_count": c, "subs": {}}
                        for tok, c in fg.items()},
            "bg": {tok: pb.doc_freq(tok) if pb is not None else 0
                   for tok in fg},
            "fg_total": len(docs), "bg_total": seg.live_count}


def scripted_metric_partial(node: A.AggNode, mask: np.ndarray,
                            seg: Segment) -> dict:
    """One segment's scripted_metric state (the reference's
    `_scripted_metric_partial`): the init script, the map script over
    each matched doc in doc order (`doc['f']` read from the segment's
    columns), the combine script; the agg's `params` under each
    script's own."""
    body = node.body
    sparams = body.get("params", {})
    state: Dict[str, Any] = {}
    if body.get("init_script"):
        src, prm = A.script_spec(body["init_script"], sparams)
        pl.execute(src, {"state": state, "params": prm})
    map_src, map_prm = A.script_spec(body.get("map_script", ""), sparams)

    class _Doc(dict):
        def __init__(self, d):
            self._d = d
            super().__init__()

        def __getitem__(self, f):
            return pl.doc_view_for(seg, self._d, f)

        def get(self, f, default=None):
            return pl.doc_view_for(seg, self._d, f)

        def containsKey(self, f):  # noqa: N802 (painless API)
            return not pl.doc_view_for(seg, self._d, f).empty

    for d in np.nonzero(np.asarray(mask)[:seg.ndocs])[0]:
        pl.execute(map_src, {"state": state, "params": map_prm,
                             "doc": _Doc(int(d))})
    if body.get("combine_script"):
        src, prm = A.script_spec(body["combine_script"], sparams)
        combined = pl.execute(src, {"state": state, "params": prm})
    else:
        combined = state
    return {"states": [combined]}


def reduce_shard_results(shard_results: List[ShardQueryResult],
                         body: dict,
                         agg_nodes: Optional[List[A.AggNode]] = None,
                         defer_pipelines: bool = False) -> dict:
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
    if body.get("collapse"):
        # the best candidate of each group across segments and shards
        seen = set()
        kept = []
        for c in all_cands:
            gk = ("null",) if c.collapse_key is None else ("v",
                                                          c.collapse_key)
            if gk not in seen:
                seen.add(gk)
                kept.append(c)
        all_cands = kept
    aggs_out = {}
    for node in agg_nodes or ():
        partials = [p for r in shard_results
                    for p in r.agg_partials.get(node.name, [])]
        aggs_out[node.name] = A.finalize(
            node, A.merge_partials(node, partials) if partials else {},
            pipelines=not defer_pipelines)
    return {"selected": all_cands[frm: frm + size], "total": total,
            "total_rel": total_rel,
            "max_score": None if max_score == float("-inf") else max_score,
            "aggs": aggs_out}


def reduce_and_fetch(searchers: List[ShardSearcher],
                     results: List[ShardQueryResult], body: dict,
                     index_name: str, agg_nodes: List[A.AggNode],
                     defer_pipelines: bool = False) -> tuple:
    """The coordinator reduce and each shard's fetch of its selected
    candidates: -> (reduced, hits in page order, {(shard, segment,
    doc): hit})."""
    reduced = reduce_shard_results(results, body, agg_nodes,
                                   defer_pipelines)
    hits_by_key: Dict[Tuple, dict] = {}
    for s, r in zip(searchers, results):
        sel = [c for c in reduced["selected"] if c.shard == r.shard]
        if sel:
            for c, h in zip(sel, s.fetch_phase(r, sel, body, index_name)):
                hits_by_key[(c.shard, c.seg_ord, c.local_doc)] = h
    hits = [hits_by_key[(c.shard, c.seg_ord, c.local_doc)]
            for c in reduced["selected"]]
    return reduced, hits, hits_by_key


def finish_search(searchers: List[ShardSearcher],
                  results: List[ShardQueryResult], body: dict,
                  index_name: str, t0: float) -> dict:
    """Coordinator reduce + fetch + response assembly (shared by search
    and batched msearch), then collapse's inner hits, the refinement of
    complex bucket subs and the pipelines deferred until after it."""
    agg_nodes = A.parse_aggs(body.get("aggs", body.get("aggregations")))
    for node in agg_nodes:
        mark_deferred_pipelines(node)
    reduced, hits, hits_by_key = reduce_and_fetch(
        searchers, results, body, index_name, agg_nodes,
        defer_pipelines=bool(agg_nodes))
    if body.get("collapse"):
        collapse_inner_hits(searchers, body, index_name, body["collapse"],
                            reduced["selected"], hits_by_key)
    for node in agg_nodes:
        refine_complex_subs(searchers, index_name, node,
                            reduced["aggs"][node.name], body.get("query"),
                            [])
    for node in agg_nodes:
        apply_deferred_tree(node, reduced["aggs"][node.name])
    track = body.get("track_total_hits", True)
    relation = reduced["total_rel"]
    total = reduced["total"]
    if track is not True and track is not False:
        track_n = int(track)
        if total > track_n:
            total, relation = track_n, "gte"
    timed_out = any(r.timed_out for r in results)
    if body.get("allow_partial_search_results", True) is False \
            and timed_out:
        raise DL.PartialResultsUnacceptable(
            "request timed out with allow_partial_search_results=false")
    # a sorted body shows max_score only with track_scores
    show_max = not body.get("sort") or bool(body.get("track_scores"))
    resp = {
        "took": int((time.monotonic() - t0) * 1000.0),
        "timed_out": timed_out,
        "_shards": {"total": len(searchers), "successful": len(searchers),
                    "skipped": 0, "failed": 0},
        "hits": {"total": {"value": total, "relation": relation},
                 "max_score": reduced["max_score"] if show_max else None,
                 "hits": hits},
    }
    if any(r.terminated_early for r in results):
        resp["terminated_early"] = True
    if reduced["aggs"]:
        resp["aggregations"] = reduced["aggs"]
    if body.get("profile"):
        resp["profile"] = profile_block(searchers, results, body)
    return resp


def profile_block(searchers: List[ShardSearcher],
                  results: List[ShardQueryResult], body: dict) -> dict:
    """The response's `profile` (the reference's shape): per shard its
    id, its query phase's wall ms, the plan tree (`describe_plan`, the
    measured time on its root) and the top-k collector. `device` names
    where the ladder's candidate-union rescore runs (the card's torch
    ops, or the host oracle on the CPU). The reference's `device.jit`
    (JAX program-cache traffic) and its `cost` block (the query-cost
    accounting, not ported) are left out."""
    plan_tree = C.describe_plan(C.rewrite(
        dsl.parse_query(body.get("query")),
        searchers[0].context(results[0].segments)))
    device_attr = {"rescore_path": "device"
                   if searchers[0].device.type == "cuda" else "host"}
    shards = []
    for r in results:
        ns = int(r.took_ms * 1e6)
        root = dict(plan_tree, time_in_nanos=ns, device=device_attr)
        shards.append({"id": f"[shard][{r.shard}]", "query_ms": r.took_ms,
                       "device": device_attr,
                       "searches": [{"query": [root], "rewrite_time": 0,
                                     "collector": [{
                                         "name": "SimpleTopKCollector",
                                         "reason": "search_top_hits",
                                         "time_in_nanos": ns}]}]})
    return {"shards": shards}


def collapse_inner_hits(searchers: List[ShardSearcher], body: dict,
                        index_name: str, collapse: dict,
                        selected: List[Candidate],
                        hits_by_key: Dict[Tuple, dict]) -> None:
    """Each collapsed hit's `fields` get its group value, and each
    `inner_hits` spec one sub-search of the query within the group (the
    reference's `_apply_collapse_inner_hits`)."""
    field = collapse["field"]
    ih_specs = collapse.get("inner_hits") or []
    if isinstance(ih_specs, dict):
        ih_specs = [ih_specs]
    for c in selected:
        h = hits_by_key[(c.shard, c.seg_ord, c.local_doc)]
        h.setdefault("fields", {})[field] = [c.collapse_key]
        for ih in ih_specs:
            if c.collapse_key is None:
                group = {"bool": {"must_not": [{"exists": {"field": field}}]}}
            else:
                group = {"term": {field: c.collapse_key}}
            sub = {"query": {"bool": {
                "must": [body.get("query") or {"match_all": {}}],
                "filter": [group]}},
                "size": int(ih.get("size", 3)),
                "from": int(ih.get("from", 0))}
            if ih.get("sort"):
                sub["sort"] = ih["sort"]
            resp = search_shards(searchers, sub, index_name)
            h.setdefault("inner_hits", {})[ih.get("name", field)] = {
                "hits": resp["hits"]}


ORDINAL_KINDS = {"terms", "significant_terms", "histogram", "date_histogram",
                 "composite", "rare_terms", "multi_terms",
                 "auto_date_histogram", "significant_text"}
_WALK_CONTAINERS = {"filter", "filters", "range", "date_range", "global",
                    "missing"}


def _date_bucket_end(key: int, cal: Optional[str], body: dict) -> int:
    """The epoch ms where the date bucket starting at `key` ends."""
    if cal:
        return C.calendar_bucket_to_epoch_ms(
            int(C.calendar_bucket_ids(np.array([key]), cal)[0]) + 1, cal)
    return key + C.parse_interval_ms(body.get(
        "fixed_interval", body.get("interval", "1d")))


def _bucket_filter(node: A.AggNode, bucket: dict) -> Optional[dict]:
    """The DSL filter of exactly one finalized bucket's docs."""
    body = node.body
    field = body.get("field")
    kind = node.kind
    if kind in ("terms", "significant_terms", "rare_terms",
                "significant_text"):
        # significant_text's keys are tokens of the text field: a term
        # query on it matches the docs holding the token
        return {"term": {field: bucket["key"]}}
    if kind == "multi_terms":
        return {"bool": {"filter": [
            {"term": {src["field"]: v}}
            for src, v in zip(body.get("terms", []), bucket["key"])]}}
    if kind == "histogram":
        return {"range": {field: {
            "gte": bucket["key"],
            "lt": bucket["key"] + float(body["interval"])}}}
    if kind == "auto_date_histogram":
        key = int(bucket["key"])
        return {"range": {field: {"gte": key,
                                  "lt": key + bucket["_interval_ms"]}}}
    if kind == "date_histogram":
        key = int(bucket["key"])
        return {"range": {field: {"gte": key, "lt": _date_bucket_end(
            key, body.get("calendar_interval"), body)}}}
    if kind == "composite":
        flt = []
        for nm, stype, scfg, _ in A.composite_sources(node):
            v = bucket["key"][nm]
            f = scfg.get("field")
            if stype == "terms":
                flt.append({"term": {f: v}})
            elif stype == "histogram":
                flt.append({"range": {f: {
                    "gte": v, "lt": v + float(scfg["interval"])}}})
            else:
                flt.append({"range": {f: {"gte": int(v), "lt": _date_bucket_end(
                    int(v), scfg.get("calendar_interval"), scfg)}}})
        return {"bool": {"filter": flt}} if len(flt) != 1 else flt[0]
    return None


def refine_complex_subs(searchers: List[ShardSearcher], index_name: str,
                        node: A.AggNode, result: Optional[dict],
                        query: Optional[dict], filters: List[dict]) -> None:
    """Bucket refinement (the reference's `_refine_complex_subs`): walk
    the finalized tree through the containers (filter, filters, range,
    date_range, global, missing), collecting each bucket's filter; for
    each bucket of an ordinal bucket node (`ORDINAL_KINDS`) with subs
    outside the stats family, run one size-0 sub-search of the query
    and those filters whose own aggs are those subs (their pipelines
    with them), and put its results in the bucket. The samplers and
    adjacency_matrix stop the walk, as in the reference."""
    if result is None:
        return
    kind = node.kind

    def walk(sub_result_of, flt, q=query):
        for s in node.subs:
            refine_complex_subs(searchers, index_name, s, sub_result_of(s.name),
                                q, flt)

    if kind in ORDINAL_KINDS:
        complex_subs = [s for s in node.subs if s.kind not in A.STATS_FAMILY]
        buckets = result.get("buckets")
        if not isinstance(buckets, list) or not complex_subs:
            return
        interval_ms = {n: ms for ms, n in A.AUTO_LADDER}.get(
            result.get("interval"), 1000)
        for b in buckets:
            if kind == "auto_date_histogram":
                b["_interval_ms"] = interval_ms
            bf = _bucket_filter(node, b)
            b.pop("_interval_ms", None)
            sub_body = {"size": 0,
                        "query": {"bool": {
                            "must": [query] if query else [],
                            "filter": filters + [bf]}},
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
    subs = {s.name: _agg_to_dsl(s) for s in node.subs + node.pipelines}
    if subs:
        spec["aggs"] = subs
    return spec


def _pipeline_inputs(p: A.AggNode) -> set:
    """The first names of every buckets_path (and bucket_sort sort key)
    a pipeline reads."""
    raw = p.body.get("buckets_path", "_count")
    paths = list(raw.values()) if isinstance(raw, dict) else [raw]
    if p.kind == "bucket_sort":
        for s in p.body.get("sort", []):
            if isinstance(s, dict):
                paths.extend(s.keys())
            elif isinstance(s, str):
                paths.append(s)
    return {str(pth).replace(">", ".").split(".")[0] for pth in paths if pth}


def mark_deferred_pipelines(node: A.AggNode) -> None:
    """Defer the pipelines that read a sub the refinement resolves (a
    complex sub of an ordinal bucket node), and those that read a
    deferred pipeline's output (the reference's
    `_mark_deferred_pipelines`)."""
    deferred = ({s.name for s in node.subs if s.kind not in A.STATS_FAMILY}
                if node.kind in ORDINAL_KINDS else set())
    for p in node.pipelines:
        p.deferred = False
    changed = True
    while changed:
        changed = False
        for p in node.pipelines:
            if not p.deferred and _pipeline_inputs(p) & deferred:
                p.deferred = True
                deferred.add(p.name)
                changed = True
    for s in node.subs:
        mark_deferred_pipelines(s)


def apply_deferred_tree(node: A.AggNode, result) -> None:
    """The deferred pipelines after the refinement, along its walk (the
    reference's `_apply_deferred_tree`): a refined bucket's complex subs
    came back from their sub-search with every pipeline applied, so the
    walk does not enter them; a subtree it never reached gets the plain
    post-order pass."""
    if not isinstance(result, dict):
        return
    if node.kind in ORDINAL_KINDS:
        A.apply_bucket_pipelines(node, result, "deferred")
        return
    if node.kind in _WALK_CONTAINERS:
        buckets = result.get("buckets")
        if isinstance(buckets, list):
            subs = [(s, b.get(s.name)) for b in buckets for s in node.subs]
        elif isinstance(buckets, dict):
            subs = [(s, b.get(s.name)) for b in buckets.values()
                    for s in node.subs]
        else:
            subs = [(s, result.get(s.name)) for s in node.subs]
        for s, r in subs:
            apply_deferred_tree(s, r)
        A.apply_bucket_pipelines(node, result, "deferred")
        return
    A.apply_pipelines_tree(node, result)


def compose_knn_query(body: dict) -> dsl.Query:
    """The body's query with its top-level `knn` section ({"field",
    "query_vector" (or "vector"), "k", "filter", "boost", "nprobe" or
    "method_parameters.nprobe", "exact"}) folded in: the kNN query alone,
    or a bool `should` of the query and it (msm 1), as the reference's
    `compose_knn_query`."""
    query = (dsl.parse_query(body.get("query"))
             if body.get("query") or "knn" not in body else None)
    spec = body.get("knn")
    if spec is not None:
        nprobe = spec.get("method_parameters", {}).get(
            "nprobe", spec.get("nprobe"))
        kq = dsl.KnnQuery(field=spec["field"],
                          vector=list(spec.get("query_vector",
                                               spec.get("vector", []))),
                          k=int(spec.get("k", 10)),
                          filter=(dsl.parse_query(spec["filter"])
                                  if spec.get("filter") else None),
                          boost=float(spec.get("boost", 1.0)),
                          nprobe=int(nprobe) if nprobe is not None else None,
                          exact=bool(spec.get("exact", False)))
        query = (dsl.BoolQuery(should=[query, kq], minimum_should_match="1")
                 if query is not None else kq)
    return query


def search_shards(searchers: List[ShardSearcher], body: dict,
                  index_name: str = "") -> dict:
    """Full query-then-fetch across shards -> OpenSearch-shaped response.
    Without an ambient deadline (the REST call installs one at accept),
    the body's `timeout` starts one here, for this search alone. A
    `hybrid` body runs each sub-query as a search of its own through this
    same entry and fuses their pages (`search/fusion.py`)."""
    from . import fusion
    if fusion.is_hybrid_body(body):
        return fusion.run_hybrid(
            body, lambda sub: search_shards(searchers, sub, index_name))
    t0 = time.monotonic()
    dl_token = None
    if DL.current() is None:
        try:
            deadline = DL.Deadline.from_body(body)
        except ValueError as e:
            raise dsl.QueryParseError(str(e))
        if deadline is not None:
            dl_token = DL.set_current(deadline)
    try:
        results = [s.query_phase(body) for s in searchers]
        return finish_search(searchers, results, body, index_name, t0)
    finally:
        if dl_token is not None:
            DL.reset_current(dl_token)


def search_snapshot(searchers: List[ShardSearcher],
                    snapshots: List[List[Segment]], body: dict,
                    index_name: str) -> dict:
    """A search over frozen segment lists, one per searcher (a scroll or
    point-in-time page; the reference's `_search_snapshot`): the query
    phase over the snapshot with its own statistics, the reduce and the
    fetch, and the reference's plain response: `timed_out` false, no
    `terminated_early`, the max score always shown, no track_total_hits
    cap, no collapse inner hits, no profile."""
    results = [s.query_phase(body, segments=segs)
               for s, segs in zip(searchers, snapshots)]
    reduced, hits, _ = reduce_and_fetch(
        searchers, results, body, index_name,
        A.parse_aggs(body.get("aggs", body.get("aggregations"))))
    resp = {"took": 0, "timed_out": False,
            "_shards": {"total": len(searchers),
                        "successful": len(searchers), "skipped": 0,
                        "failed": 0},
            "hits": {"total": {"value": reduced["total"],
                               "relation": reduced["total_rel"]},
                     "max_score": reduced["max_score"], "hits": hits}}
    if reduced["aggs"]:
        resp["aggregations"] = reduced["aggs"]
    return resp


def batch_eligible(body: dict) -> bool:
    """Bodies an msearch batch may serve (the reference's gate): not a
    rescore, a profile, an explain or a hybrid body, which its single
    search serves; and, as its batched knn route, not a `terminate_after`
    or a live `timeout`, which need the per-segment loop and its
    deadline."""
    from . import fusion
    if body.get("rescore") or body.get("profile") or body.get("explain") \
            or body.get("terminate_after") or fusion.is_hybrid_body(body):
        return False
    try:
        return DL.parse_timeout_s(body.get("timeout")) is None
    except ValueError:
        return False


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
    orders: dict = {}
    launches = []
    for si, s in enumerate(searchers):
        ctx = s.context()
        for bi, body in enumerate(bodies):
            if responses[bi] is not None or not ok[bi]:
                continue
            if not batch_eligible(body):
                ok[bi] = False
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
                specs[bi], orders[bi] = plan.fast, plan.order
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
                                       seg_ord, orders[bi])
    # served counts only for bodies the kernels served on every segment
    for bi, out in served:
        if ok[bi]:
            fastpath.count_served([specs[bi]], [out])
    for bi, body in enumerate(bodies):
        if responses[bi] is not None:
            continue
        if not ok[bi]:
            try:
                responses[bi] = search_shards(searchers, body, index_name)
            except (dsl.QueryParseError, DL.PartialResultsUnacceptable) as e:
                responses[bi] = {"error": {"type": "ApiError",
                                           "reason": str(e)}}
            continue
        for r in results[bi]:
            # a body without hits (its plan None) has no order
            finish_candidates(r, orders[bi].need if bi in orders else 0)
        responses[bi] = finish_search(searchers, results[bi], body,
                                      index_name, t0)
    return responses
