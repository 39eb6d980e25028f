"""Aggregations on the host: the agg tree, the merge of per-segment
partials and the response (the ported kinds of
opensearch_tpu/search/aggregations.py).

The device half lives in `compiler.emit_agg` (torch ops over the general
path's match mask) and `executor` turns its outputs into the partials
merged here. Ported kinds: `terms` (keyword doc values), `histogram`,
`date_histogram` (fixed and calendar intervals, `offset`), `range`,
`date_range`, `filter`, `filters`, `global`, `missing`, `min`, `max`,
`sum`, `avg`, `stats`, `extended_stats`, `value_count`, `cardinality`
(HyperLogLog registers, log2m 14), `percentiles` and `percentile_ranks`
(a mergeable log-binned sketch). Terms buckets are exact per shard and
keyed by value, so segments and merged segments agree. Every other kind
the reference knows, pipeline aggregations included, raises
`NotPortedError` naming it; an invalid tree raises the reference's
ValueError.
"""

from __future__ import annotations

import datetime as _dt
import math
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional

import numpy as np

from ..errors import NotPortedError
from ..ops.aggs import ddsketch_bin, ddsketch_value

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
    "percentile_ranks"}
# bucket kinds whose buckets share one keyed doc_count + subs layout
_SINGLE_BUCKET = ("filter", "global", "missing")


@dataclass
class AggNode:
    name: str
    kind: str
    body: dict
    subs: List["AggNode"] = dc_field(default_factory=list)
    pipelines: List["AggNode"] = dc_field(default_factory=list)


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


def check_ported(nodes: List[AggNode]) -> None:
    """Raise NotPortedError naming the first kind of the tree that this
    slice does not serve (pipelines included)."""
    for n in nodes:
        if n.kind not in PORTED_KINDS:
            raise NotPortedError(f"aggs: aggregation kind [{n.kind}]")
        for p in n.pipelines:
            raise NotPortedError(f"aggs: pipeline aggregation [{p.kind}]")
        check_ported(n.subs)


# ---------------- merge (reduce) ----------------

def merge_partials(node: AggNode, partials: List[Optional[dict]]) -> dict:
    """Merge the per-segment partials of one agg node (the reference's
    InternalAggregation#reduce)."""
    parts = [p for p in partials if p is not None]
    if not parts:
        return {}
    kind = node.kind
    if kind in ("terms", "histogram", "date_histogram"):
        acc: Dict[Any, dict] = {}
        for p in parts:
            for key, rec in p["buckets"].items():
                slot = acc.setdefault(key, {"doc_count": 0, "subs": []})
                slot["doc_count"] += rec["doc_count"]
                slot["subs"].append(rec.get("subs"))
        for slot in acc.values():
            slot["subs"] = _merge_subs(node.subs, slot["subs"])
        if kind == "terms":
            return {"buckets": acc}
        return {"buckets": acc, "interval": parts[0]["interval"],
                "offset": parts[0].get("offset", 0.0)}
    if kind in ("range", "date_range", "filters"):
        acc = {}
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
    if kind in STATS_FAMILY:
        return _merge_stats(parts)
    if kind == "cardinality":
        regs = parts[0]["registers"]
        for p in parts[1:]:
            regs = np.maximum(regs, p["registers"])
        return {"registers": regs}
    # percentiles / percentile_ranks: the sketch's bins are global, so
    # adding histograms is the reduce
    hist = parts[0]["hist"].copy()
    for p in parts[1:]:
        hist += p["hist"]
    key = "percents" if kind == "percentiles" else "values"
    return {"hist": hist, key: parts[0][key]}


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

def _finalize_subs(node: AggNode, entry: dict, subs: dict) -> dict:
    for sub in node.subs:
        entry[sub.name] = finalize(sub, subs.get(sub.name, {}))
    return entry


def finalize(node: AggNode, merged: dict) -> dict:
    """The response of one agg node from its merged partial."""
    kind = node.kind
    if not merged:
        return _empty_result(node)
    body = node.body
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
                                  v["subs"])
                   for k, v in items[:size]]
        shown = sum(b["doc_count"] for b in buckets)
        return {"doc_count_error_upper_bound": 0,
                "sum_other_doc_count": int(total_count - shown),
                "buckets": buckets}
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
            buckets.append(_finalize_subs(node, entry, rec["subs"]))
        return {"buckets": buckets}
    if kind in ("range", "date_range"):
        buckets = []
        for key, rec in merged["buckets"].items():
            entry = {"key": key, "doc_count": int(rec["doc_count"])}
            if rec.get("meta"):
                entry.update(rec["meta"])
            buckets.append(_finalize_subs(node, entry, rec["subs"]))
        return {"buckets": buckets}
    if kind == "filters":
        return {"buckets": {
            key: _finalize_subs(node, {"doc_count": int(rec["doc_count"])},
                                rec["subs"])
            for key, rec in merged["buckets"].items()}}
    if kind in _SINGLE_BUCKET:
        return _finalize_subs(node, {"doc_count": int(merged["doc_count"])},
                              merged["subs"])
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


def _empty_result(node: AggNode) -> dict:
    kind = node.kind
    if kind == "filters":
        return {"buckets": {}}
    if kind in ("terms", "histogram", "date_histogram", "range",
                "date_range"):
        return {"buckets": []}
    if kind in _SINGLE_BUCKET:
        return {"doc_count": 0}
    if kind in ("min", "max", "avg"):
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
