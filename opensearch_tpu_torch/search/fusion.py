"""Hybrid retrieval: N sub-queries, each served as a complete search of
its own, fused at the coordinator (the port of
opensearch_tpu/search/fusion.py; the neural-search plugin's
normalization processor over a hybrid query).

- Each sub-query runs with a fixed rank window (`window_size`, `from` 0)
  and the parent's hydration options, through the port's own search:
  a `match` sub-query still takes the fused kernels and their ladder, a
  `knn` one the scan or the probe. They run one after another (the
  reference's serial arm, whose fused bytes equal its parallel arm's).
- Fusion is a pure function of the ranked sub-pages, keyed by
  `(_index, _id)`. RRF: the sum over lists of weight / (rank_constant +
  rank), ranks from 1. Linear: each list's scores normalized (`min_max`:
  (s - min) / (max - min), a constant list 1.0; `l2`: s / ||s||, an
  all-zero list 0), then the weighted sum.
- Order: fused score descending, then the best (list, rank) a doc holds,
  then its key. The page is `from` / `size` into the fused list, which
  must fit the window (a 400 otherwise); its scores round to 7 places.
- The total is the largest sub-total, `gte` with more than one
  sub-query (or when a sub-total is a lower bound).
- Aggregations run once over the fused candidates: an `ids` sub-search
  of size 0. `profile` adds a `hybrid` block of the fusion spec and each
  sub-query's took, total, max score, candidates and profile.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import query_dsl as dsl

# body keys a hybrid search refuses: they change per-shard collection in
# ways N independent retrievals cannot honour, or re-rank outside fusion
_FORBIDDEN_BODY_KEYS = ("sort", "collapse", "suggest", "rescore",
                        "search_after", "min_score", "knn",
                        "terminate_after", "scroll", "pit")

# body keys that ride along to every sub-search, so that the winners come
# back hydrated (the fused page reuses the sub-pages' hits)
_PASSTHROUGH_KEYS = ("_source", "stored_fields", "docvalue_fields",
                     "fields", "script_fields", "highlight", "explain",
                     "derived", "track_scores", "track_total_hits",
                     "timeout", "allow_partial_search_results", "profile",
                     "preference")


def is_hybrid_body(body) -> bool:
    """True iff the body's query is `hybrid`."""
    if not isinstance(body, dict):
        return False
    q = body.get("query")
    return isinstance(q, dict) and "hybrid" in q


def parse_hybrid(body: dict) -> Optional[dsl.HybridQuery]:
    """The validated HybridQuery of a hybrid body, or None; a forbidden
    body key or a page past the window is a QueryParseError (400)."""
    if not is_hybrid_body(body):
        return None
    q = dsl.parse_query(body.get("query"))
    if not isinstance(q, dsl.HybridQuery):
        return None
    for k in _FORBIDDEN_BODY_KEYS:
        if body.get(k):
            raise dsl.QueryParseError(
                f"[hybrid] does not support [{k}] — each sub-query is an "
                f"independent retrieval; fused pages re-rank at the "
                f"coordinator only")
    frm = int(body.get("from", 0))
    size = int(body.get("size", 10))
    window = int(q.fusion["window_size"])
    if frm + size > window:
        raise dsl.QueryParseError(
            f"[hybrid] from + size ({frm + size}) exceeds the fusion "
            f"window_size ({window}); raise fusion.window_size — pages "
            f"fuse over a FIXED rank window so pagination stays stable")
    return q


def sub_bodies(body: dict, q: dsl.HybridQuery) -> List[dict]:
    """One search body per sub-query: its window-deep page with the
    parent's hydration options."""
    window = int(q.fusion["window_size"])
    out = []
    for sub in q.queries:
        sb = {"query": sub, "from": 0, "size": window}
        for k in _PASSTHROUGH_KEYS:
            if k in body:
                sb[k] = body[k]
        out.append(sb)
    return out


def minmax_normalize(scores: List[float]) -> List[float]:
    """(s - min) / (max - min); a constant list maps every doc to 1.0."""
    if not scores:
        return []
    lo, hi = min(scores), max(scores)
    if hi <= lo:
        return [1.0] * len(scores)
    rng = hi - lo
    return [(s - lo) / rng for s in scores]


def l2_normalize(scores: List[float]) -> List[float]:
    """s / ||s||_2; an all-zero list stays zero."""
    nrm = sum(s * s for s in scores) ** 0.5
    if nrm <= 0.0:
        return [0.0] * len(scores)
    return [s / nrm for s in scores]


def normalize_scores(scores: List[float], how: str) -> List[float]:
    if how == "l2":
        return l2_normalize(scores)
    if how == "min_max":
        return minmax_normalize(scores)
    raise ValueError(f"unknown normalization [{how}]")


def fuse_ranked_lists(lists: List[List[Tuple[Any, float]]],
                      fusion: Dict[str, Any]) -> List[Tuple[Any, float]]:
    """N ranked (key, score) lists -> one ranked (key, fused) list:
    fused desc, best (list, rank) asc, key asc."""
    fused: Dict[Any, float] = {}
    best: Dict[Any, Tuple[int, int]] = {}
    for li, lst in enumerate(lists):
        w = float(fusion["weights"][li])
        if fusion["method"] == "rrf":
            k = float(fusion["rank_constant"])
            contribs = [w / (k + rank) for rank in range(1, len(lst) + 1)]
        else:
            contribs = [w * n for n in normalize_scores(
                [s for _, s in lst], fusion["normalization"])]
        for rank0, ((key, _s), c) in enumerate(zip(lst, contribs)):
            fused[key] = fused.get(key, 0.0) + c
            if key not in best or (li, rank0) < best[key]:
                best[key] = (li, rank0)
    order = sorted(fused, key=lambda key: (-fused[key], best[key], key))
    return [(key, fused[key]) for key in order]


def _hit_key(hit: dict) -> Tuple[str, str]:
    return (str(hit.get("_index", "")), str(hit.get("_id", "")))


def _total(sub_resps: List[dict]) -> dict:
    """The largest sub-total; `gte` with several sub-queries, or where a
    sub-total is a lower bound."""
    totals = [r.get("hits", {}).get("total", {}) for r in sub_resps]
    tvals = [int(t.get("value", 0)) for t in totals if isinstance(t, dict)]
    total = max(tvals) if tvals else 0
    if len(sub_resps) == 1:
        rel = totals[0].get("relation", "eq") if totals else "eq"
    else:
        rel = "gte" if total else "eq"
    if any(isinstance(t, dict) and t.get("relation") == "gte"
           for t in totals):
        rel = "gte" if total else rel
    return {"value": total, "relation": rel}


def run_hybrid(body: dict, run_sub: Callable[[dict], dict]) -> dict:
    """One hybrid search: each sub-body through `run_sub` (a search),
    in sub-query order, then the fused response. A winner's hit is the
    first sub-page's (by sub-query order) that holds it, its `_score`
    the fused score."""
    q = parse_hybrid(body)
    t0 = time.monotonic()
    fusion = q.fusion
    frm = int(body.get("from", 0))
    size = int(body.get("size", 10))
    sub_resps = [run_sub(sb) for sb in sub_bodies(body, q)]

    lists = []
    by_key: Dict[Tuple[str, str], dict] = {}
    for resp in sub_resps:
        lst = []
        for h in resp.get("hits", {}).get("hits", []):
            key = _hit_key(h)
            sc = h.get("_score")
            lst.append((key, float(sc) if sc is not None else 0.0))
            by_key.setdefault(key, h)
        lists.append(lst)
    fused = fuse_ranked_lists(lists, fusion)

    # aggregations over the fused candidates: one size-0 ids sub-search
    # (the ids sorted, as the reference sends them)
    agg_spec = body.get("aggs") or body.get("aggregations")
    agg_resp = None
    if agg_spec:
        agg_body = {"query": {"ids": {"values":
                                      sorted({key[1] for key, _ in fused})}},
                    "from": 0, "size": 0, "aggs": agg_spec}
        for k in ("timeout", "preference", "allow_partial_search_results"):
            if k in body:
                agg_body[k] = body[k]
        agg_resp = run_sub(agg_body)

    page = []
    for key, score in fused[frm: frm + size]:
        h = dict(by_key[key])
        h["_score"] = round(float(score), 7)
        page.append(h)

    # the shard set every sub-query saw, with the worst failure any saw
    shards = dict(sub_resps[0].get("_shards",
                                   {"total": 0, "successful": 0,
                                    "skipped": 0, "failed": 0}))
    for r in sub_resps[1:]:
        s = r.get("_shards", {})
        if int(s.get("failed", 0)) > int(shards.get("failed", 0)):
            shards = dict(s)
    resp = {
        "took": int((time.monotonic() - t0) * 1000.0),
        "timed_out": any(r.get("timed_out") for r in sub_resps),
        "_shards": shards,
        "hits": {"total": _total(sub_resps),
                 "max_score": (round(float(fused[0][1]), 7) if fused
                               else None),
                 "hits": page},
    }
    if agg_resp is not None:
        resp["aggregations"] = agg_resp.get("aggregations", {})
        if agg_resp.get("timed_out"):
            resp["timed_out"] = True
        s = agg_resp.get("_shards", {})
        if int(s.get("failed", 0)) > int(resp["_shards"].get("failed", 0)):
            resp["_shards"] = dict(s)
    if any(r.get("terminated_early") for r in sub_resps):
        resp["terminated_early"] = True
    if body.get("profile"):
        resp["profile"] = {"hybrid": {
            "fusion": {k: fusion[k] for k in
                       ("method", "rank_constant", "weights",
                        "normalization", "window_size")},
            "sub_queries": [
                {"query": q.queries[i], "took": r.get("took"),
                 "total": r.get("hits", {}).get("total"),
                 "max_score": r.get("hits", {}).get("max_score"),
                 "candidates": len(lists[i]), "profile": r.get("profile")}
                for i, r in enumerate(sub_resps)]}}
    return resp
