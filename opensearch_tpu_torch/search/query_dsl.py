"""Query DSL parsing for the query kinds the port serves (the term, terms,
match, bool, constant_score and range subset of
opensearch_tpu/search/query_dsl.py).

Any other query kind raises `NotPortedError` naming it; malformed bodies
raise `QueryParseError` (HTTP 400), as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, List, Optional, Tuple

from ..errors import NotPortedError


class QueryParseError(ValueError):
    """Analog of reference ParsingException (HTTP 400)."""


@dataclass
class Query:
    boost: float = 1.0
    name: Optional[str] = None  # _name for matched_queries


@dataclass
class TermQuery(Query):
    field: str = ""
    value: Any = None
    case_insensitive: bool = False


@dataclass
class TermsQuery(Query):
    field: str = ""
    values: List[Any] = dc_field(default_factory=list)


@dataclass
class MatchQuery(Query):
    field: str = ""
    query: Any = None
    operator: str = "or"
    minimum_should_match: Optional[str] = None
    analyzer: Optional[str] = None
    fuzziness: Optional[Any] = None


@dataclass
class BoolQuery(Query):
    must: List[Query] = dc_field(default_factory=list)
    should: List[Query] = dc_field(default_factory=list)
    must_not: List[Query] = dc_field(default_factory=list)
    filter: List[Query] = dc_field(default_factory=list)
    minimum_should_match: Optional[str] = None


@dataclass
class RangeQuery(Query):
    field: str = ""
    gte: Any = None
    gt: Any = None
    lte: Any = None
    lt: Any = None


@dataclass
class ConstantScoreQuery(Query):
    filter: Optional[Query] = None


def _one_entry(d: dict, what: str) -> Tuple[str, Any]:
    if not isinstance(d, dict) or len(d) != 1:
        raise QueryParseError(
            f"[{what}] malformed query, expected a single field object")
    return next(iter(d.items()))


def _common(q: Query, body: Any) -> None:
    if isinstance(body, dict):
        q.boost = float(body.get("boost", 1.0))
        q.name = body.get("_name")
        if q.name is not None:
            raise NotPortedError("named queries ([_name])")


def parse_query(dsl: Optional[dict]) -> Query:
    """DSL dict -> Query tree."""
    if dsl is None:
        raise NotPortedError("query [match_all]")
    kind, body = _one_entry(dsl, "query")

    if kind == "term":
        f, spec = _one_entry(body, "term")
        if isinstance(spec, dict):
            q = TermQuery(field=f, value=spec.get("value"),
                          case_insensitive=spec.get("case_insensitive",
                                                    False))
            _common(q, spec)
        else:
            q = TermQuery(field=f, value=spec)
        return q

    if kind == "terms":
        opts = {k: v for k, v in body.items() if k in ("boost", "_name")}
        fields = [(k, v) for k, v in body.items()
                  if k not in ("boost", "_name")]
        if len(fields) != 1:
            raise QueryParseError("[terms] query requires exactly one field")
        f, vals = fields[0]
        if isinstance(vals, dict):
            raise NotPortedError("terms lookup")
        q = TermsQuery(field=f, values=list(vals))
        _common(q, opts)
        return q

    if kind == "match":
        f, spec = _one_entry(body, "match")
        if isinstance(spec, dict):
            q = MatchQuery(field=f, query=spec.get("query"),
                           operator=str(spec.get("operator", "or")).lower(),
                           minimum_should_match=spec.get(
                               "minimum_should_match"),
                           analyzer=spec.get("analyzer"),
                           fuzziness=spec.get("fuzziness"))
            _common(q, spec)
        else:
            q = MatchQuery(field=f, query=spec)
        return q

    if kind == "bool":
        def many(key):
            v = body.get(key, [])
            v = v if isinstance(v, list) else [v]
            return [parse_query(x) for x in v]
        q = BoolQuery(must=many("must"), should=many("should"),
                      must_not=many("must_not"), filter=many("filter"),
                      minimum_should_match=body.get("minimum_should_match"))
        _common(q, body)
        return q

    if kind == "range":
        f, spec = _one_entry(body, "range")
        for key in ("format", "relation", "time_zone"):
            if key in spec:
                raise NotPortedError(f"[range] option [{key}]")
        q = RangeQuery(field=f, gte=spec.get("gte", spec.get("from")),
                       gt=spec.get("gt"), lte=spec.get("lte", spec.get("to")),
                       lt=spec.get("lt"))
        _common(q, spec)
        return q

    if kind == "constant_score":
        q = ConstantScoreQuery(filter=parse_query(body["filter"]))
        _common(q, body)
        return q

    raise NotPortedError(f"query [{kind}]")


def parse_minimum_should_match(spec: Optional[str], n_optional: int) -> int:
    """'2', '-1', '75%', '-25%', and conditional '3<90%' / multi
    '2<-25% 9<-3' semantics (reference Queries.calculateMinShouldMatch)."""
    if spec is None or n_optional == 0:
        return 0
    s = str(spec).strip()
    if "<" in s:
        # each "n<rule": when n_optional > n, apply rule; pick the clause
        # with the LARGEST matching n
        result = n_optional  # fewer than every threshold -> all required
        best_n = -1
        for part in s.split():
            if "<" not in part:
                raise QueryParseError(
                    f"invalid minimum_should_match [{spec}]")
            left, right = part.split("<", 1)
            try:
                thr = int(left)
            except ValueError:
                raise QueryParseError(
                    f"invalid minimum_should_match [{spec}]")
            if n_optional > thr and thr > best_n:
                best_n = thr
                result = parse_minimum_should_match(right, n_optional)
        return result
    try:
        if s.endswith("%"):
            pct = float(s[:-1])
            if pct < 0:
                return max(n_optional - int(-pct / 100.0 * n_optional), 0)
            return int(pct / 100.0 * n_optional)
        v = int(s)
        if v < 0:
            return max(n_optional + v, 0)
        return min(v, n_optional)
    except ValueError:
        raise QueryParseError(f"invalid minimum_should_match [{spec}]")
