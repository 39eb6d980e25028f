"""Search body options beside the query (the body checks of
opensearch_tpu/search/executor.py and fastpath.py): which keys the port
serves, the sort specs, the score suppression of a field sort, and which
bodies the fused kernels and the impact rung may serve.

Served: `query`, `size`, `from`, `track_total_hits`, `aggs`, `sort`
(`_score`, `_doc`, numeric and keyword fields, `order`, `missing`, several
keys), `search_after`, `track_scores`, `min_score`, `collapse` (with
`inner_hits`), `_source` (a bool, a pattern, a list or includes /
excludes), `docvalue_fields`, `fields`, `stored_fields`, `highlight`,
`rescore` (a rescorer or a list of them), `explain` (true: a per-hit
`_explanation`), `terminate_after`, `timeout`,
`allow_partial_search_results`, `profile`, `knn` (the top-level kNN
section, `executor.compose_knn_query`) and `script_fields` (a host
painless-lite script per hit). A `_script` sort key is a host script per
doc (`executor.host_sort_values`); as the primary key, each segment
hands the host every match, and `collapse` or `search_after` with it is
the reference's 400. `explain: "device_plan"`, any other key, and a
`_geo_distance` or `nested` sort, raises `NotPortedError` naming it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..errors import NotPortedError
from . import query_dsl as dsl

BODY_KEYS = {"query", "size", "from", "track_total_hits", "_source", "aggs",
             "aggregations", "sort", "search_after", "track_scores",
             "min_score", "collapse", "highlight", "docvalue_fields",
             "fields", "stored_fields", "rescore", "explain",
             "terminate_after", "timeout", "allow_partial_search_results",
             "profile", "knn", "script_fields"}


def norm_sort_specs(body: dict) -> List[dict]:
    """The body's sort as [{"field", "order"?, "missing"?}] (the
    reference's `_norm_sort_specs`): a string sorts `_score` descending
    and anything else ascending."""
    sort = body.get("sort", [])
    if isinstance(sort, (str, dict)):
        sort = [sort]
    out = []
    for s in sort:
        if isinstance(s, str):
            out.append({"field": s,
                        "order": "desc" if s == "_score" else "asc"})
            continue
        if not isinstance(s, dict) or len(s) != 1:
            raise dsl.QueryParseError(f"malformed sort [{s}]")
        ((f, spec),) = s.items()
        if f == "_geo_distance":
            raise NotPortedError(f"[{f}] sort")
        if isinstance(spec, str):
            out.append({"field": f, "order": spec})
        elif isinstance(spec, dict):
            if spec.get("nested") is not None:
                raise NotPortedError("[nested] sort")
            out.append({"field": f, **spec})
        else:
            raise dsl.QueryParseError(f"malformed sort [{s}]")
    return out


def is_script_sort(specs: List[dict]) -> bool:
    """The sort's first key is a `_script`: its order is computed on the
    host, over every matching doc of a segment."""
    return bool(specs) and specs[0]["field"] == "_script"


def is_field_sort(specs: List[dict]) -> bool:
    return bool(specs) and specs[0]["field"] != "_score"


def suppress_score(body: dict) -> bool:
    """An explicit `track_scores: false` under a field sort nulls each
    hit's `_score` (the reference's `_suppress_score`; absent, scores are
    kept)."""
    if body.get("track_scores") is not False or not body.get("sort"):
        return False
    return is_field_sort(norm_sort_specs(body))


def _check_source(src) -> None:
    if isinstance(src, (bool, str)):
        return
    if isinstance(src, list) and all(isinstance(p, str) for p in src):
        return
    if isinstance(src, dict) and set(src) <= {"includes", "excludes"}:
        return
    raise dsl.QueryParseError(f"[_source] malformed: [{src}]")


def check_body(body: dict) -> int:
    """Validate a search body against the served options; -> from +
    size."""
    for key in body:
        if key not in BODY_KEYS:
            raise NotPortedError(f"search body option [{key}]")
    _check_source(body.get("_source", True))
    track = body.get("track_total_hits", True)
    if not isinstance(track, (bool, int)):
        raise dsl.QueryParseError(
            f"[track_total_hits] must be a boolean or an integer, got "
            f"[{track}]")
    # a negative size or from is served as the reference serves it (its
    # window and page slices run with the negative bound)
    size = int(body.get("size", 10))
    frm = int(body.get("from", 0))
    norm_sort_specs(body)
    collapse = body.get("collapse")
    if collapse is not None and (not isinstance(collapse, dict)
                                 or not collapse.get("field")):
        raise dsl.QueryParseError("[collapse] requires [field]")
    if collapse and is_script_sort(norm_sort_specs(body)):
        raise dsl.QueryParseError(
            "cannot use [collapse] with a primary _script sort")
    after = body.get("search_after")
    if after is not None and not isinstance(after, list):
        raise dsl.QueryParseError("[search_after] must be an array")
    hl = body.get("highlight")
    if hl is not None and not isinstance(hl.get("fields", {}), dict):
        raise dsl.QueryParseError("[highlight] [fields] must be an object")
    if body.get("explain") == "device_plan":
        raise NotPortedError("explain [device_plan]")
    return frm + size


@dataclass
class Rescorer:
    """One rescorer of a body's `rescore` (the reference's
    `_apply_rescores` reading): the `window_size` first-phase lanes of
    each segment it rescores, its query, the two weights and the score
    mode."""

    window: int
    query: dsl.Query
    query_weight: float
    rescore_weight: float
    mode: str


def rescorers(body: dict) -> List[Rescorer]:
    """The body's rescorers in list order; `window_size` defaults to 10,
    both weights to 1, `score_mode` to total. An unknown score mode is
    the reference's ValueError, raised where the scores combine
    (`combine_rescore`)."""
    rs_list = body.get("rescore")
    if rs_list is None:
        return []
    if not isinstance(rs_list, list):
        rs_list = [rs_list]
    out = []
    for rs in rs_list:
        spec = rs.get("query", rs)
        try:
            q = dsl.parse_query(spec.get("rescore_query"))
        except NotPortedError as e:
            raise NotPortedError(f"rescore query: {e.what}")
        out.append(Rescorer(int(rs.get("window_size", 10)), q,
                            float(spec.get("query_weight", 1.0)),
                            float(spec.get("rescore_query_weight", 1.0)),
                            spec.get("score_mode", "total")))
    return out


def combine_rescore(mode: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The reference's `_combine_rescore` of the weighted first-phase
    scores `a` and rescore scores `b`."""
    if mode == "total":
        return a + b
    if mode == "multiply":
        return a * b
    if mode == "avg":
        return (a + b) / 2
    if mode == "max":
        return np.maximum(a, b)
    if mode == "min":
        return np.minimum(a, b)
    raise ValueError(f"unknown rescore score_mode [{mode}]")


def rungs_eligible(body: dict) -> bool:
    """The body options the fused kernels and the impact rung serve (the
    reference's `_body_eligible` beside its window check): no sort or a
    lone `_score` descending one, no cursor, no collapse, no top-level
    `knn` section; and, in the port, no `min_score` either, which the
    general path applies."""
    specs = norm_sort_specs(body)
    if specs and not (len(specs) == 1 and specs[0]["field"] == "_score"
                      and specs[0].get("order", "desc") == "desc"):
        return False
    return (body.get("search_after") is None and not body.get("collapse")
            and body.get("min_score") is None and not body.get("knn"))


@dataclass
class Order:
    """A body's ranking beside its query: the sort specs, the
    `search_after` cursor, the collapse field, `min_score` and the
    window (from + size)."""

    specs: List[dict]
    after: Optional[list]
    collapse: Optional[str]
    min_score: Optional[float]
    window: int

    @classmethod
    def of(cls, body: dict, window: int) -> "Order":
        specs = norm_sort_specs(body)
        after = body.get("search_after")
        if after is not None and len(after) < max(len(specs), 1):
            raise dsl.QueryParseError(
                f"[search_after] has {len(after)} value(s), the sort "
                f"{max(len(specs), 1)}")
        collapse = body.get("collapse")
        ms = body.get("min_score")
        return cls(specs, after, collapse["field"] if collapse else None,
                   None if ms is None else float(ms), window)

    @property
    def field_sort(self) -> bool:
        return is_field_sort(self.specs)

    @property
    def script_sort(self) -> bool:
        return is_script_sort(self.specs)

    @property
    def multi(self) -> bool:
        return len(self.specs) > 1

    @property
    def need(self) -> int:
        """Candidates a segment and a shard keep: the window, twice over
        under a field sort or several keys, for the host's re-sort by
        the full tuple (the reference's oversample)."""
        return self.window * (2 if self.field_sort or self.multi else 1)

    @property
    def on_device(self) -> bool:
        """True when the general program ranks by a sort key, a cursor or
        groups, not by the score alone."""
        score_only = not self.specs or (
            len(self.specs) == 1 and self.specs[0]["field"] == "_score"
            and self.specs[0].get("order", "desc") == "desc")
        return (not score_only or self.after is not None
                or self.collapse is not None)
