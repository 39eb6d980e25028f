"""Aggregations on the host: the agg tree, the merge of per-segment
partials, the response and the pipeline aggregations (the served kinds
of opensearch_tpu/search/aggregations.py).

The device half lives in `compiler.emit_agg` (torch ops over the general
path's match mask) and `executor` turns its outputs into the partials
merged here. Served kinds:

- bucket: `terms` (keyword doc values), `histogram`, `date_histogram`
  (fixed and calendar intervals, `offset`), `range`, `date_range`,
  `filter`, `filters`, `global`, `missing`, `composite` (terms,
  histogram and date_histogram sources, paged by `after`),
  `multi_terms`, `rare_terms`, `significant_terms`, `significant_text`,
  `sampler`, `diversified_sampler`, `adjacency_matrix`,
  `auto_date_histogram`, `ip_range` (exact i64 bounds over an ip
  column: `from` inclusive, `to` exclusive, a `mask` its network),
  `geo_distance` (rings [from, to) of f32 haversine meters from an
  origin, in its `unit`), `geohash_grid` and `geotile_grid` (cells
  computed on the host, ordered by count then key, cut at `size`;
  `shard_size` is not read, as in the reference);
- metric: `min`, `max`, `sum`, `avg`, `stats`, `extended_stats`,
  `value_count`, `cardinality` (HyperLogLog registers, log2m 14),
  `percentiles` and `percentile_ranks` (a mergeable log-binned sketch),
  `top_hits`, `weighted_avg`, `median_absolute_deviation` (over the
  same sketch), `matrix_stats`, `geo_bounds` (no longitude wrap; an
  empty one is `{}`), `geo_centroid` (f32 sums over the count);
- pipeline (host work on finalized buckets): `derivative`,
  `cumulative_sum`, `serial_diff`, `moving_avg`, `moving_fn` (the
  `MovingFunctions.*` helpers, else a painless-lite script over
  `values`), `bucket_script`, `bucket_selector`, `bucket_sort`,
  `avg_bucket`,
  `sum_bucket`, `min_bucket`, `max_bucket`, `stats_bucket`,
  `percentiles_bucket`. A pipeline that reads a sub-agg the bucket
  refinement resolves is `deferred` until after it (the executor's
  `mark_deferred_pipelines` / `apply_deferred_tree`).

Terms buckets are exact per shard and keyed by value, so segments and
merged segments agree. Every other kind the reference knows raises
`NotPortedError` naming it; an invalid tree raises the reference's
ValueError.
"""

from __future__ import annotations

import datetime as _dt
import math
import re
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional

import numpy as np

from ..errors import NotPortedError
from ..ops.aggs import ddsketch_bin, ddsketch_value
from ..script import painless_lite as pl
from . import query_dsl as dsl

BUCKET_KINDS = {"terms", "histogram", "date_histogram", "range", "date_range",
                "geo_distance",
                "filter", "filters", "global", "missing", "significant_terms",
                "sampler", "geohash_grid", "geotile_grid", "nested",
                "reverse_nested", "children", "parent", "composite",
                "ip_range", "rare_terms", "multi_terms", "adjacency_matrix",
                "auto_date_histogram", "significant_text",
                "diversified_sampler"}
METRIC_KINDS = {"min", "max", "sum", "avg", "stats", "extended_stats",
                "value_count", "cardinality", "percentiles",
                "percentile_ranks", "top_hits",
                "matrix_stats", "weighted_avg", "median_absolute_deviation",
                "geo_bounds", "geo_centroid", "scripted_metric"}
PIPELINE_KINDS = {"avg_bucket", "sum_bucket", "min_bucket", "max_bucket",
                  "stats_bucket", "cumulative_sum", "derivative",
                  "bucket_script", "bucket_selector", "moving_avg",
                  "moving_fn", "serial_diff", "percentiles_bucket",
                  "bucket_sort"}

STATS_FAMILY = {"min", "max", "sum", "avg", "stats", "extended_stats",
                "value_count"}
PORTED_KINDS = STATS_FAMILY | {
    "terms", "histogram", "date_histogram", "range", "date_range", "filter",
    "filters", "global", "missing", "cardinality", "percentiles",
    "percentile_ranks", "composite", "multi_terms", "rare_terms",
    "significant_terms", "significant_text", "sampler",
    "diversified_sampler", "adjacency_matrix", "auto_date_histogram",
    "top_hits", "weighted_avg", "median_absolute_deviation",
    "matrix_stats", "ip_range", "scripted_metric", "geo_distance",
    "geohash_grid", "geotile_grid", "geo_bounds", "geo_centroid",
    "nested", "reverse_nested", "children", "parent"}
SERVED_PIPELINES = PIPELINE_KINDS
# bucket kinds whose response is one doc_count + subs
_SINGLE_BUCKET = ("filter", "global", "missing", "sampler",
                  "diversified_sampler", "nested", "reverse_nested",
                  "children", "parent")
# bucket kinds keyed by value, merged by adding their buckets
_KEYED = ("terms", "rare_terms", "multi_terms", "composite",
          "geohash_grid", "geotile_grid")

# auto_date_histogram's rounding ladder: the reference's fixed-interval
# approximation of OpenSearch's calendar ladder (a month is 30 days, a
# year 365)
AUTO_LADDER = [
    (1_000, "1s"), (5_000, "5s"), (10_000, "10s"), (30_000, "30s"),
    (60_000, "1m"), (300_000, "5m"), (600_000, "10m"), (1_800_000, "30m"),
    (3_600_000, "1h"), (10_800_000, "3h"), (43_200_000, "12h"),
    (86_400_000, "1d"), (604_800_000, "7d"), (2_592_000_000, "1M"),
    (7_776_000_000, "3M"), (31_536_000_000, "1y"), (157_680_000_000, "5y"),
    (315_360_000_000, "10y"), (3_153_600_000_000, "100y"),
]


def auto_interval_name(interval_ms: int) -> str:
    for ms, name in AUTO_LADDER:
        if ms == interval_ms:
            return name
    return f"{interval_ms}ms"


@dataclass
class AggNode:
    name: str
    kind: str
    body: dict
    subs: List["AggNode"] = dc_field(default_factory=list)
    pipelines: List["AggNode"] = dc_field(default_factory=list)
    # a pipeline whose buckets_path reads a sub-agg the bucket refinement
    # resolves runs after the refinement (executor.mark_deferred_pipelines)
    deferred: bool = False


def parse_aggs(aggs: Optional[dict]) -> List[AggNode]:
    out: List[AggNode] = []
    if not aggs:
        return out
    for name, spec in aggs.items():
        sub_specs = spec.get("aggs", spec.get("aggregations"))
        kinds = [k for k in spec if k not in ("aggs", "aggregations", "meta")]
        if len(kinds) != 1:
            raise ValueError(f"aggregation [{name}] must define exactly one "
                             f"type")
        kind = kinds[0]
        if kind not in BUCKET_KINDS | METRIC_KINDS | PIPELINE_KINDS:
            raise ValueError(f"unknown aggregation type [{kind}]")
        node = AggNode(name, kind, spec[kind])
        children = parse_aggs(sub_specs)
        node.subs = [c for c in children if c.kind not in PIPELINE_KINDS]
        node.pipelines = [c for c in children if c.kind in PIPELINE_KINDS]
        if kind in METRIC_KINDS and node.subs:
            raise ValueError(f"metric aggregation [{name}] cannot have "
                             f"sub-aggregations")
        out.append(node)
    return out


_MOVING_FN = re.compile(
    r"\s*MovingFunctions\.(\w+)\(values(?:,\s*[\w.()]+)?\)\s*$")
_MOVING_FNS = ("max", "min", "sum", "unweightedAvg", "stdDev",
               "linearWeightedAvg")


def check_ported(nodes: List[AggNode]) -> None:
    """Raise NotPortedError naming the first kind of the tree that this
    port does not serve (a kind outside PORTED_KINDS). A pipeline at the
    root is left to `compiler.emit_agg`, which raises the reference's
    error."""
    for n in nodes:
        if n.kind not in PORTED_KINDS and n.kind not in SERVED_PIPELINES:
            raise NotPortedError(f"aggs: aggregation kind [{n.kind}]")
        check_ported(n.subs)


# ---------------- merge (reduce) ----------------

def merge_partials(node: AggNode, partials: List[Optional[dict]]) -> dict:
    """Merge the per-segment partials of one agg node (the reference's
    InternalAggregation#reduce)."""
    parts = [p for p in partials if p is not None]
    if not parts:
        return {}
    kind = node.kind
    if kind == "scripted_metric":
        return {"states": [st for p in parts for st in p["states"]]}
    if kind in _KEYED:
        return {"buckets": _acc_buckets(node.subs, parts)}
    if kind in ("histogram", "date_histogram"):
        return {"buckets": _acc_buckets(node.subs, parts),
                "interval": parts[0]["interval"],
                "offset": parts[0].get("offset", 0.0)}
    if kind in ("range", "date_range", "ip_range", "geo_distance",
                "filters", "adjacency_matrix"):
        acc: Dict[Any, dict] = {}
        for p in parts:
            for key, rec in p["buckets"].items():
                slot = acc.setdefault(key, {"doc_count": 0, "subs": [],
                                            "meta": rec.get("meta")})
                slot["doc_count"] += rec["doc_count"]
                slot["subs"].append(rec.get("subs"))
        for slot in acc.values():
            slot["subs"] = _merge_subs(node.subs, slot["subs"])
        return {"buckets": acc}
    if kind in _SINGLE_BUCKET:
        return {"doc_count": sum(p["doc_count"] for p in parts),
                "subs": _merge_subs(node.subs, [p.get("subs")
                                                for p in parts])}
    if kind in ("significant_terms", "significant_text"):
        bg: Dict[Any, int] = {}
        for p in parts:
            for key, c in p["bg"].items():
                bg[key] = bg.get(key, 0) + c
        return {"buckets": _acc_buckets(node.subs, parts), "bg": bg,
                "fg_total": sum(p["fg_total"] for p in parts),
                "bg_total": sum(p["bg_total"] for p in parts)}
    if kind == "auto_date_histogram":
        # segments may have rounded at different intervals: coarsen all
        # to the widest before adding (InternalAutoDateHistogram#reduce)
        interval = max(p["interval_ms"] for p in parts)
        return {"buckets": _coarsen(node.subs, [
            (k, rec) for p in parts for k, rec in p["buckets"].items()],
            interval), "interval_ms": interval}
    if kind == "weighted_avg":
        return {k: sum(p[k] for p in parts)
                for k in ("vwsum", "wsum", "count")}
    if kind == "geo_bounds":
        live = [p for p in parts if p["count"] > 0]
        if not live:
            return {"count": 0}
        return {"count": sum(p["count"] for p in live),
                "top": max(p["top"] for p in live),
                "bottom": min(p["bottom"] for p in live),
                "left": min(p["left"] for p in live),
                "right": max(p["right"] for p in live)}
    if kind == "geo_centroid":
        return {"count": sum(p["count"] for p in parts),
                "slat": sum(p.get("slat", 0.0) for p in parts),
                "slon": sum(p.get("slon", 0.0) for p in parts)}
    if kind == "matrix_stats":
        # the shift is index-wide and the same in every non-empty
        # partial; an empty one (no column) carries zeros
        out = {"count": sum(p["count"] for p in parts),
               "fields": parts[0]["fields"],
               "shift": next((p["shift"] for p in parts
                              if p["count"] > 0
                              and p.get("shift") is not None), None)}
        for key in ("s1", "s2", "s3", "s4", "xy"):
            out[key] = np.sum([p[key] for p in parts], axis=0)
        return out
    if kind == "top_hits":
        rows = [r for p in parts for r in p["hits"]]
        rows.sort(key=lambda r: -r["_score"] if r["_score"] is not None
                  else 0)
        return {"hits": rows[:parts[0]["size"]],
                "total": sum(p["total"] for p in parts)}
    if kind in STATS_FAMILY:
        return _merge_stats(parts)
    if kind == "cardinality":
        regs = parts[0]["registers"]
        for p in parts[1:]:
            regs = np.maximum(regs, p["registers"])
        return {"registers": regs}
    # percentiles / percentile_ranks / median_absolute_deviation: the
    # sketch's bins are global, so adding histograms is the reduce
    hist = parts[0]["hist"].copy()
    for p in parts[1:]:
        hist += p["hist"]
    if kind == "median_absolute_deviation":
        return {"hist": hist}
    key = "percents" if kind == "percentiles" else "values"
    return {"hist": hist, key: parts[0][key]}


def _acc_buckets(subs: List[AggNode], parts: List[dict]) -> Dict[Any, dict]:
    """Keyed buckets and their sub partials added across segments."""
    acc: Dict[Any, dict] = {}
    for p in parts:
        for key, rec in p["buckets"].items():
            slot = acc.setdefault(key, {"doc_count": 0, "subs": []})
            slot["doc_count"] += rec["doc_count"]
            slot["subs"].append(rec.get("subs"))
    for slot in acc.values():
        slot["subs"] = _merge_subs(subs, slot["subs"])
    return acc


def _coarsen(subs: List[AggNode], items, interval: int) -> Dict[int, dict]:
    """Date buckets (epoch-ms key, record with unmerged or merged subs)
    rounded down to `interval` and added."""
    acc: Dict[int, dict] = {}
    for key, rec in items:
        slot = acc.setdefault((int(key) // interval) * interval,
                              {"doc_count": 0, "subs": []})
        slot["doc_count"] += rec["doc_count"]
        slot["subs"].append(rec.get("subs"))
    for slot in acc.values():
        slot["subs"] = _merge_subs(subs, slot["subs"])
    return acc


def _merge_stats(parts: List[dict]) -> dict:
    return {"count": sum(p["count"] for p in parts),
            "sum": sum(p["sum"] for p in parts),
            "min": min((p["min"] for p in parts if p["count"] > 0),
                       default=float("inf")),
            "max": max((p["max"] for p in parts if p["count"] > 0),
                       default=float("-inf")),
            "sumsq": sum(p.get("sumsq", 0.0) for p in parts)}


def _merge_subs(subs: List[AggNode],
                partial_lists: List[Optional[dict]]) -> dict:
    return {sub.name: merge_partials(sub, [pl.get(sub.name)
                                           for pl in partial_lists if pl])
            for sub in subs}


# ---------------- finalize (response shaping) ----------------

def _finalize_subs(node: AggNode, entry: dict, subs: dict,
                   pipelines: bool) -> dict:
    for sub in node.subs:
        entry[sub.name] = finalize(sub, subs.get(sub.name, {}), pipelines)
    return entry


def _with_pipelines(node: AggNode, result: dict, pipelines: bool) -> dict:
    apply_bucket_pipelines(node, result, "all" if pipelines else "early")
    return result


def finalize(node: AggNode, merged: dict, pipelines: bool = True) -> dict:
    """The response of one agg node from its merged partial. With
    `pipelines` false only the pipelines not `deferred` run; the
    executor runs the deferred ones after the bucket refinement."""
    kind = node.kind
    if not merged:
        return _empty_result(node)
    body = node.body
    if kind == "scripted_metric":
        # the reduce script over every segment's combined state
        states = merged.get("states", [])
        reduce_src = body.get("reduce_script")
        if reduce_src:
            src, prm = script_spec(reduce_src, {})
            return {"value": pl.execute(src, {"states": states,
                                              "params": prm})}
        return {"value": states}
    if kind == "terms":
        size = int(body.get("size", 10))
        order = body.get("order", {"_count": "desc"})
        (okey, odir), = (order.items() if isinstance(order, dict)
                         else [("_count", "desc")])
        min_doc_count = int(body.get("min_doc_count", 1))
        items = [(k, v) for k, v in merged["buckets"].items()
                 if v["doc_count"] > 0 and v["doc_count"] >= min_doc_count]
        if okey == "_key":
            items.sort(key=lambda kv: kv[0], reverse=(odir == "desc"))
        else:
            items.sort(key=lambda kv: (-kv[1]["doc_count"], kv[0])
                       if odir == "desc" else (kv[1]["doc_count"], kv[0]))
        total_count = sum(v["doc_count"] for _, v in items)
        buckets = [_finalize_subs(node, {"key": k,
                                         "doc_count": int(v["doc_count"])},
                                  v["subs"], pipelines)
                   for k, v in items[:size]]
        shown = sum(b["doc_count"] for b in buckets)
        return _with_pipelines(node, {
            "doc_count_error_upper_bound": 0,
            "sum_other_doc_count": int(total_count - shown),
            "buckets": buckets}, pipelines)
    if kind in ("histogram", "date_histogram"):
        buckets = []
        for b in sorted(merged["buckets"]):
            rec = merged["buckets"][b]
            if rec["doc_count"] <= 0 and int(body.get("min_doc_count",
                                                      0)) > 0:
                continue
            key = b * merged["interval"] + merged.get("offset", 0.0)
            entry = {"key": key, "doc_count": int(rec["doc_count"])}
            if kind == "date_histogram":
                entry["key"] = int(key)
                entry["key_as_string"] = format_epoch_ms(int(key))
            buckets.append(_finalize_subs(node, entry, rec["subs"],
                                          pipelines))
        return _with_pipelines(node, {"buckets": buckets}, pipelines)
    if kind in ("range", "date_range", "ip_range", "geo_distance"):
        buckets = []
        for key, rec in merged["buckets"].items():
            entry = {"key": key, "doc_count": int(rec["doc_count"])}
            if rec.get("meta"):
                entry.update(rec["meta"])
            buckets.append(_finalize_subs(node, entry, rec["subs"],
                                          pipelines))
        return _with_pipelines(node, {"buckets": buckets}, pipelines)
    if kind == "filters":
        return {"buckets": {
            key: _finalize_subs(node, {"doc_count": int(rec["doc_count"])},
                                rec["subs"], pipelines)
            for key, rec in merged["buckets"].items()}}
    if kind in _SINGLE_BUCKET:
        return _finalize_subs(node, {"doc_count": int(merged["doc_count"])},
                              merged["subs"], pipelines)
    if kind in ("significant_terms", "significant_text"):
        return _finalize_significant(node, merged, pipelines)
    if kind == "composite":
        return _finalize_composite(node, merged, pipelines)
    if kind in ("geohash_grid", "geotile_grid"):
        items = sorted(((k, v) for k, v in merged["buckets"].items()
                        if v["doc_count"] > 0),
                       key=lambda kv: (-kv[1]["doc_count"], kv[0]))
        return _with_pipelines(node, {"buckets": [
            _finalize_subs(node, {"key": k, "doc_count": int(v["doc_count"])},
                           v["subs"], pipelines)
            for k, v in items[:int(body.get("size", 10000))]]}, pipelines)
    if kind == "geo_bounds":
        if merged.get("count", 0) == 0:
            return {}
        return {"bounds": {
            "top_left": {"lat": float(merged["top"]),
                         "lon": float(merged["left"])},
            "bottom_right": {"lat": float(merged["bottom"]),
                             "lon": float(merged["right"])}}}
    if kind == "geo_centroid":
        c = merged.get("count", 0)
        if not c:
            return {"count": 0}
        return {"location": {"lat": float(merged["slat"] / c),
                             "lon": float(merged["slon"] / c)},
                "count": int(c)}
    if kind == "rare_terms":
        max_dc = int(body.get("max_doc_count", 1))
        items = sorted(((k, v) for k, v in merged["buckets"].items()
                        if 0 < v["doc_count"] <= max_dc),
                       key=lambda kv: (kv[1]["doc_count"], kv[0]))
        return _with_pipelines(node, {"buckets": [
            _finalize_subs(node, {"key": k, "doc_count": int(v["doc_count"])},
                           v["subs"], pipelines) for k, v in items]},
            pipelines)
    if kind == "multi_terms":
        size = int(body.get("size", 10))
        items = sorted(((k, v) for k, v in merged["buckets"].items()
                        if v["doc_count"] > 0),
                       key=lambda kv: (-kv[1]["doc_count"], kv[0]))
        buckets = [_finalize_subs(node, {
            "key": list(k), "key_as_string": "|".join(str(x) for x in k),
            "doc_count": int(v["doc_count"])}, v["subs"], pipelines)
            for k, v in items[:size]]
        total = sum(v["doc_count"] for _, v in items)
        shown = sum(b["doc_count"] for b in buckets)
        return _with_pipelines(node, {
            "buckets": buckets, "sum_other_doc_count": int(total - shown)},
            pipelines)
    if kind == "adjacency_matrix":
        buckets = []
        for key in sorted(merged["buckets"]):
            rec = merged["buckets"][key]
            if rec["doc_count"] <= 0:
                continue
            buckets.append(_finalize_subs(node, {
                "key": key, "doc_count": int(rec["doc_count"])},
                rec["subs"], pipelines))
        return _with_pipelines(node, {"buckets": buckets}, pipelines)
    if kind == "auto_date_histogram":
        return _finalize_auto_date(node, merged, pipelines)
    if kind == "top_hits":
        hits = merged["hits"]
        return {"hits": {"total": {"value": int(merged["total"]),
                                   "relation": "eq"},
                         "max_score": hits[0]["_score"] if hits else None,
                         "hits": hits}}
    if kind == "weighted_avg":
        w = merged.get("wsum", 0.0)
        return {"value": None if not w else merged["vwsum"] / w}
    if kind == "median_absolute_deviation":
        return {"value": mad_from_hist(merged["hist"])}
    if kind == "matrix_stats":
        return _finalize_matrix_stats(merged)
    c = merged.get("count", 0)
    if kind == "value_count":
        return {"value": int(c)}
    if kind in ("min", "max"):
        return {"value": None if c == 0 else merged[kind]}
    if kind == "sum":
        return {"value": merged["sum"]}
    if kind == "avg":
        return {"value": None if c == 0 else merged["sum"] / c}
    if kind == "stats":
        return {"count": int(c), "min": None if c == 0 else merged["min"],
                "max": None if c == 0 else merged["max"],
                "sum": merged["sum"],
                "avg": None if c == 0 else merged["sum"] / c}
    if kind == "extended_stats":
        if c == 0:
            return {"count": 0, "min": None, "max": None, "sum": 0.0,
                    "avg": None, "sum_of_squares": 0.0, "variance": None,
                    "std_deviation": None}
        var = max(merged["sumsq"] / c - (merged["sum"] / c) ** 2, 0.0)
        return {"count": int(c), "min": merged["min"], "max": merged["max"],
                "sum": merged["sum"], "avg": merged["sum"] / c,
                "sum_of_squares": merged["sumsq"], "variance": var,
                "std_deviation": math.sqrt(var)}
    if kind == "cardinality":
        return {"value": int(round(hll_estimate(merged["registers"])))}
    if kind == "percentiles":
        return {"values": hist_percentiles(merged)}
    return {"values": hist_percentile_ranks(merged)}


def _finalize_auto_date(node: AggNode, merged: dict, pipelines: bool
                        ) -> dict:
    """Coarsen along the ladder until the buckets fit the target (the
    reference's coordinator rounding), then shape as a date histogram
    with the chosen `interval`'s name."""
    target = max(int(node.body.get("buckets", 10)), 1)
    interval = merged.get("interval_ms", 1000)
    buckets = dict(merged.get("buckets", {}))
    ladder = [ms for ms, _ in AUTO_LADDER]
    li = next((i for i, ms in enumerate(ladder) if ms >= interval), 0)
    while buckets and len(buckets) > target and li + 1 < len(ladder):
        li += 1
        interval = ladder[li]
        buckets = _coarsen(node.subs, buckets.items(), interval)
    out = [_finalize_subs(node, {
        "key": int(key), "key_as_string": format_epoch_ms(int(key)),
        "doc_count": int(buckets[key]["doc_count"])},
        buckets[key]["subs"], pipelines) for key in sorted(buckets)]
    return _with_pipelines(node, {"buckets": out,
                                  "interval": auto_interval_name(interval)},
                           pipelines)


def mad_from_hist(hist: np.ndarray) -> Optional[float]:
    """Median absolute deviation over the sketch (the reference's
    `_mad_from_hist`): the weighted median of |bin value - median|, the
    median itself weighted over the bins' representative values."""
    total = float(hist.sum())
    if total == 0:
        return None
    nz = np.nonzero(hist)[0]
    centers = np.array([ddsketch_value(int(b)) for b in nz])
    weights = hist[nz].astype(np.float64)

    def weighted_median(vals, ws):
        order = np.argsort(vals)
        v, w = vals[order], ws[order]
        cum = np.cumsum(w)
        half = cum[-1] / 2.0
        i = int(np.searchsorted(cum, half))
        if cum[i] == half and i + 1 < len(v):
            return float((v[i] + v[i + 1]) / 2.0)
        return float(v[i])

    med = weighted_median(centers, weights)
    return weighted_median(np.abs(centers - med), weights)


def composite_sources(node: AggNode) -> List[tuple]:
    """[(name, source type, config, order)] of a composite body."""
    out = []
    for s in node.body.get("sources", []):
        ((nm, spec),) = s.items()
        ((stype, scfg),) = spec.items()
        out.append((nm, stype, scfg, scfg.get("order", "asc")))
    return out


class CompVal:
    """One source's value of a composite key, ordered by its direction."""

    __slots__ = ("v", "desc")

    def __init__(self, v, desc: bool):
        self.v = v
        self.desc = desc

    def __lt__(self, other):
        return (self.v > other.v) if self.desc else (self.v < other.v)

    def __eq__(self, other):
        return self.v == other.v


def _finalize_composite(node: AggNode, merged: dict, pipelines: bool
                        ) -> dict:
    """One page of composite buckets: every merged bucket in the
    sources' order, those after `after`, the first `size`, and the last
    key shown as `after_key`."""
    sources = composite_sources(node)
    size = int(node.body.get("size", 10))
    after = node.body.get("after")

    def comp(key_tuple):
        return tuple(CompVal(v, o == "desc")
                     for v, (_, _, _, o) in zip(key_tuple, sources))

    items = [(k, v) for k, v in merged["buckets"].items()
             if v["doc_count"] > 0]
    items.sort(key=lambda kv: comp(kv[0]))
    if after is not None:
        ac = comp(tuple(after[nm] for nm, _, _, _ in sources))
        items = [kv for kv in items if comp(kv[0]) > ac]
    buckets = [_finalize_subs(node, {
        "key": {nm: v for (nm, _, _, _), v in zip(sources, key)},
        "doc_count": int(rec["doc_count"])}, rec["subs"], pipelines)
        for key, rec in items[:size]]
    out = {"buckets": buckets}
    if buckets:
        out["after_key"] = buckets[-1]["key"]
    return _with_pipelines(node, out, pipelines)


def significance_score(fg: float, fg_total: float, bg: float,
                       bg_total: float, heuristic: str) -> float:
    """The reference's own significance heuristics over the foreground
    and background frequencies: JLH (the default), chi_square,
    percentage."""
    if fg_total == 0 or bg_total == 0 or bg == 0:
        return 0.0
    fgp = fg / fg_total
    bgp = bg / bg_total
    if heuristic == "percentage":
        return fg / bg
    if heuristic == "chi_square":
        num = (fgp - bgp) ** 2
        den = bgp * (1 - bgp)
        return (num / den) * bg_total if den > 0 else 0.0
    return (fgp - bgp) * (fgp / bgp) if fgp > bgp else 0.0


def _finalize_significant(node: AggNode, merged: dict, pipelines: bool
                          ) -> dict:
    body = node.body
    heuristic = next((h for h in ("jlh", "chi_square", "percentage")
                      if h in body), "jlh")
    size = int(body.get("size", 10))
    min_doc_count = int(body.get("min_doc_count", 3))
    fg_total, bg_total = merged["fg_total"], merged["bg_total"]
    scored = []
    for key, rec in merged["buckets"].items():
        fg = rec["doc_count"]
        bg = merged["bg"].get(key, fg)
        if fg < min_doc_count:
            continue
        score = significance_score(fg, fg_total, bg, bg_total, heuristic)
        if score > 0:
            scored.append((score, key, fg, bg, rec))
    scored.sort(key=lambda t: (-t[0], t[1]))
    buckets = [_finalize_subs(node, {"key": key, "doc_count": int(fg),
                                     "score": score, "bg_count": int(bg)},
                              rec["subs"], pipelines)
               for score, key, fg, bg, rec in scored[:size]]
    return _with_pipelines(node, {"doc_count": int(fg_total),
                                  "bg_count": int(bg_total),
                                  "buckets": buckets}, pipelines)


def _finalize_matrix_stats(merged: dict) -> dict:
    """Moments, covariances and correlations from the power sums, which
    are centred about the index-wide `shift` (so `mean` below is the
    small residual)."""
    n = float(merged["count"])
    fields = merged["fields"]
    if n == 0:
        return {"doc_count": 0, "fields": []}
    s1, s2, s3, s4 = (np.asarray(merged[k], np.float64)
                      for k in ("s1", "s2", "s3", "s4"))
    xy = np.asarray(merged["xy"], np.float64)
    shift = np.asarray(merged.get("shift", np.zeros(len(fields))),
                       np.float64)
    mean = s1 / n
    m2 = s2 / n - mean ** 2
    var = m2 * n / max(n - 1, 1)
    out_fields = []
    for i, f in enumerate(fields):
        m2i = max(m2[i], 0.0)
        m3 = s3[i] / n - 3 * mean[i] * s2[i] / n + 2 * mean[i] ** 3
        m4 = (s4[i] / n - 4 * mean[i] * s3[i] / n
              + 6 * mean[i] ** 2 * s2[i] / n - 3 * mean[i] ** 4)
        cov, corr = {}, {}
        for j, g in enumerate(fields):
            c = (xy[i, j] - s1[i] * s1[j] / n) / max(n - 1, 1)
            cov[g] = c
            denom = math.sqrt(var[i] * var[j])
            corr[g] = c / denom if denom > 0 else 0.0
        out_fields.append({"name": f, "count": int(n),
                           "mean": shift[i] + mean[i], "variance": var[i],
                           "skewness": m3 / m2i ** 1.5 if m2i > 0 else 0.0,
                           "kurtosis": m4 / m2i ** 2 if m2i > 0 else 0.0,
                           "covariance": cov, "correlation": corr})
    return {"doc_count": int(n), "fields": out_fields}


def _empty_result(node: AggNode) -> dict:
    kind = node.kind
    if kind == "filters":
        return {"buckets": {}}
    if kind in ("terms", "histogram", "date_histogram", "range",
                "date_range", "ip_range", "composite", "rare_terms", "multi_terms",
                "adjacency_matrix", "auto_date_histogram", "geohash_grid",
                "geotile_grid"):
        return {"buckets": []}
    if kind == "geo_centroid":
        return {"count": 0}
    if kind in ("significant_terms", "significant_text"):
        return {"doc_count": 0, "bg_count": 0, "buckets": []}
    if kind in _SINGLE_BUCKET:
        return {"doc_count": 0}
    if kind == "matrix_stats":
        return {"doc_count": 0, "fields": []}
    if kind in ("min", "max", "avg", "weighted_avg",
                "median_absolute_deviation", "scripted_metric"):
        return {"value": None}
    if kind in ("sum", "value_count", "cardinality"):
        return {"value": 0}
    if kind == "stats":
        return {"count": 0, "min": None, "max": None, "sum": 0.0,
                "avg": None}
    if kind in ("percentiles", "percentile_ranks"):
        return {"values": {}}
    return {}


def hll_estimate(regs: np.ndarray) -> float:
    m = len(regs)
    z = float(np.sum(np.exp2(-regs.astype(np.float64))))
    alpha = 0.7213 / (1.0 + 1.079 / m)
    est = alpha * m * m / z
    zeros = int(np.sum(regs == 0))
    if est <= 2.5 * m and zeros > 0:
        return m * math.log(m / zeros)
    return est


def hist_percentiles(merged: dict) -> Dict[str, Optional[float]]:
    hist = merged["hist"].astype(np.float64)
    total = hist.sum()
    if total == 0:
        return {f"{p:.1f}": None for p in merged["percents"]}
    cum = np.cumsum(hist)
    out: Dict[str, Optional[float]] = {}
    for p in merged["percents"]:
        target = max(p / 100.0 * total, 1e-9)
        b = int(np.searchsorted(cum, target, side="left"))
        out[f"{p:.1f}"] = ddsketch_value(min(b, len(hist) - 1))
    return out


def hist_percentile_ranks(merged: dict) -> Dict[str, Optional[float]]:
    """For each queried value, the percentage of observations in bins up
    to its own (the inverse of `hist_percentiles` over the same sketch);
    keys are the values' full-precision strings."""
    hist = merged["hist"].astype(np.float64)
    total = hist.sum()
    if total == 0:
        return {str(float(v)): None for v in merged["values"]}
    cum = np.cumsum(hist)
    return {str(float(v)): float(cum[ddsketch_bin(float(v))] / total
                                 * 100.0)
            for v in merged["values"]}


def format_epoch_ms(ms: int) -> str:
    return _dt.datetime.fromtimestamp(ms / 1000.0, _dt.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z"


# ---------------- pipeline aggregations (host) ----------------

def apply_pipelines_tree(node: AggNode, result) -> None:
    """The deferred pipelines of a finalized subtree, post-order (for a
    subtree the refinement did not reach: its early pipelines ran in
    `finalize`)."""
    if not isinstance(result, dict):
        return
    buckets = result.get("buckets")
    if isinstance(buckets, list):
        for b in buckets:
            for s in node.subs:
                apply_pipelines_tree(s, b.get(s.name))
    elif isinstance(buckets, dict):
        for bd in buckets.values():
            for s in node.subs:
                apply_pipelines_tree(s, bd.get(s.name))
    else:
        for s in node.subs:
            apply_pipelines_tree(s, result.get(s.name))
    apply_bucket_pipelines(node, result, "deferred")


def bucket_path_value(b: dict, path: str):
    """One `buckets_path` against a finalized bucket (the reference's
    `_bucket_path_value`): `_count`, or `>` / `.` separated names walked
    down the bucket, a dict at the end read at its "value". Any other
    form (`_key`, `name[99.0]`) finds nothing there and reads None."""
    if path == "_count":
        return float(b["doc_count"])
    node: Any = b
    for part in path.replace(">", ".").split("."):
        if not isinstance(node, dict):
            return None
        node = node.get(part)
    if isinstance(node, dict):
        node = node.get("value")
    return node


def moving_fn_eval(script: str, values: List[float], params: dict):
    """A `moving_fn` over one window (the reference's `_moving_fn_eval`):
    the `MovingFunctions` helper the script names, else the script run
    by painless-lite over `values` and `params`."""
    m = _MOVING_FN.match(script)
    if not m or m.group(1) not in _MOVING_FNS:
        return pl.execute(script, {"values": list(values),
                                   "params": params})
    name = m.group(1)
    if not values:
        return 0 if name == "sum" else None
    if name == "max":
        return max(values)
    if name == "min":
        return min(values)
    if name == "sum":
        return sum(values)
    if name == "unweightedAvg":
        return sum(values) / len(values)
    if name == "stdDev":
        avg = sum(values) / len(values)
        return math.sqrt(sum((x - avg) ** 2 for x in values) / len(values))
    return (sum((i + 1) * x for i, x in enumerate(values))
            / sum(range(1, len(values) + 1)))


def script_spec(spec, defaults: dict) -> tuple:
    """(source, params) of a scripted_metric script: a string keeps the
    agg's params, a dict adds its own over them (the reference's
    `_script_spec`)."""
    if isinstance(spec, str):
        return spec, dict(defaults)
    prm = dict(defaults)
    prm.update(spec.get("params", {}))
    return spec.get("source", ""), prm


def _bucket_script(p: AggNode, buckets: list, raw_path) -> list:
    """bucket_script sets each bucket's value, bucket_selector keeps the
    buckets whose script is truthy (the reference's loop): each
    buckets_path variable lands in params and in the script's scope; a
    bucket missing one is kept unevaluated (gap_policy skip)."""
    src, sparams = dsl.parse_script_spec(p.body.get("script"))
    paths = raw_path if isinstance(raw_path, dict) else {"_value": raw_path}
    keep = []
    for b in buckets:
        variables = {"params": dict(sparams)}
        missing = False
        for var, pth in paths.items():
            v = bucket_path_value(b, pth)
            if v is None:
                missing = True
            variables["params"][var] = v
            variables[var] = v
        if missing:
            if p.kind == "bucket_script":
                b[p.name] = {"value": None}
            keep.append(b)
            continue
        try:
            val = pl.execute(src, variables)
        except pl.ScriptError as e:
            raise ValueError(f"[{p.name}] script error: {e}")
        if p.kind == "bucket_script":
            b[p.name] = {"value": float(val) if val is not None else None}
            keep.append(b)
        elif val:
            keep.append(b)
    return keep


def apply_bucket_pipelines(node: AggNode, result: dict,
                           which: str = "all") -> None:
    """The pipelines of a bucket agg over its finalized buckets, in the
    body's order (the reference's `_apply_bucket_pipelines`):
    cumulative_sum, derivative, serial_diff, moving_avg and moving_fn
    set a value in each bucket, bucket_sort reorders and cuts the list,
    the *_bucket siblings set a value beside the buckets. `which`
    picks "all", "early" (not deferred) or "deferred"."""
    buckets = result.get("buckets")
    if not isinstance(buckets, list):
        return
    for p in node.pipelines:
        if (which == "early" and p.deferred) or (
                which == "deferred" and not p.deferred):
            continue
        raw_path = p.body.get("buckets_path", "_count")
        if p.kind in ("bucket_script", "bucket_selector"):
            keep = _bucket_script(p, buckets, raw_path)
            if p.kind == "bucket_selector":
                result["buckets"] = buckets = keep
            continue
        if p.kind == "bucket_sort":
            sorts = p.body.get("sort", [])
            frm = int(p.body.get("from", 0))
            size = p.body.get("size")

            def sort_key(b, sorts=sorts):
                key = []
                for s in sorts:
                    ((pth, spec),) = (s.items() if isinstance(s, dict)
                                      else [(s, "asc")])
                    order = (spec.get("order", "asc")
                             if isinstance(spec, dict) else spec)
                    v = bucket_path_value(b, pth)
                    v = float("-inf") if v is None else v
                    key.append(-v if order == "desc" else v)
                return tuple(key)

            if sorts:
                buckets.sort(key=sort_key)
            end = frm + int(size) if size is not None else None
            result["buckets"] = buckets = buckets[frm:end]
            continue
        series = [bucket_path_value(b, raw_path) for b in buckets]
        vals = [v for v in series if v is not None]
        if p.kind == "cumulative_sum":
            run = 0.0
            for b, v in zip(buckets, series):
                run += (v or 0.0)
                b[p.name] = {"value": run}
        elif p.kind == "derivative":
            prev = None
            for b, v in zip(buckets, series):
                b[p.name] = {"value": None if prev is None or v is None
                             else v - prev}
                prev = v
        elif p.kind == "serial_diff":
            lag = int(p.body.get("lag", 1))
            for i, cur in enumerate(series):
                ref = series[i - lag] if i >= lag else None
                buckets[i][p.name] = {"value": None if cur is None
                                      or ref is None else cur - ref}
        elif p.kind in ("moving_avg", "moving_fn"):
            window = int(p.body.get("window", 5))
            shift = int(p.body.get("shift", 0))
            # moving_avg's window holds the current bucket; moving_fn's
            # (shift 0) ends before it
            if p.kind == "moving_avg":
                shift += 1
            for i, b in enumerate(buckets):
                win = [v for v in series[max(0, i - window + shift):
                                         max(0, i + shift)]
                       if v is not None]
                if p.kind == "moving_fn":
                    src, sparams = dsl.parse_script_spec(
                        p.body.get("script"))
                    out = moving_fn_eval(src, win, sparams)
                elif not win:
                    out = None
                elif p.body.get("model", "simple") == "linear":
                    out = (sum((j + 1) * x for j, x in enumerate(win))
                           / sum(range(1, len(win) + 1)))
                else:
                    out = sum(win) / len(win)
                b[p.name] = {"value": out}
        elif p.kind == "percentiles_bucket":
            percents = p.body.get("percents",
                                  [1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0])
            svals = sorted(vals)
            out = {}
            for pc in percents:
                if not svals:
                    out[f"{pc:.1f}"] = None
                else:
                    idx = min(int(round(pc / 100.0 * len(svals) + 0.5)) - 1,
                              len(svals) - 1)
                    out[f"{pc:.1f}"] = svals[max(idx, 0)]
            result[p.name] = {"values": out}
        elif p.kind == "avg_bucket":
            result[p.name] = {"value": sum(vals) / len(vals) if vals
                              else None}
        elif p.kind == "sum_bucket":
            result[p.name] = {"value": sum(vals)}
        elif p.kind == "min_bucket":
            result[p.name] = {"value": min(vals) if vals else None}
        elif p.kind == "max_bucket":
            result[p.name] = {"value": max(vals) if vals else None}
        else:   # stats_bucket
            result[p.name] = {"count": len(vals), "sum": sum(vals),
                              "min": min(vals) if vals else None,
                              "max": max(vals) if vals else None,
                              "avg": sum(vals) / len(vals) if vals
                              else None}
