"""Query DSL parsing for the query kinds the port serves (the match_all,
match_none, term, terms, terms_set, match, multi_match, combined_fields,
match_bool_prefix, match_phrase, match_phrase_prefix, span_term,
span_near, intervals, bool, constant_score, boosting, dis_max, pinned,
wrapper, range, exists, ids, prefix, wildcard, regexp, fuzzy, knn,
rank_feature, distance_feature, neural_sparse (raw `query_tokens` only),
hybrid, query_string, simple_query_string, function_score, script,
script_score, geo_distance, geo_bounding_box, geo_polygon, geo_shape,
nested, has_child, has_parent, parent_id, more_like_this and percolate
subset of opensearch_tpu/search/query_dsl.py). A distance parses with its
unit (`parse_distance`), a point from every form the reference accepts
(`index.mappings.parse_geo`); a `geo_shape` body's `indexed_shape` is
resolved by the client before the parse. A body without a query is
`match_all`. A script is painless-lite source with
its params (`parse_script_spec`); the strings' grammars live in
`search/querystring.py`. A clause's `_name` is kept for `matched_queries`; a
`wrapper` is its base64 JSON query, parsed again (its own `boost` and
`_name` unread, as in the reference). A `hybrid` query keeps its
sub-queries as raw dicts (each is parsed here to surface a malformed one
as a 400, then served as its own search, `search/fusion.py`), with its
fusion spec validated by `parse_fusion_spec`.

Another kind the reference parses raises `NotPortedError` naming it; a
kind it does not know, and malformed bodies, raise `QueryParseError`
(HTTP 400), as in the reference.
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Tuple

from ..errors import NotPortedError
from ..index.mappings import parse_geo


class QueryParseError(ValueError):
    """Analog of reference ParsingException (HTTP 400)."""


@dataclass
class Query:
    boost: float = 1.0
    name: Optional[str] = None  # _name for matched_queries


@dataclass
class MatchAllQuery(Query):
    pass


@dataclass
class MatchNoneQuery(Query):
    pass


@dataclass
class ExistsQuery(Query):
    field: str = ""


@dataclass
class IdsQuery(Query):
    values: List[str] = dc_field(default_factory=list)


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
class MultiMatchQuery(Query):
    fields: List[str] = dc_field(default_factory=list)
    query: Any = None
    type: str = "best_fields"
    operator: str = "or"
    tie_breaker: float = 0.0
    minimum_should_match: Optional[str] = None


@dataclass
class TermsSetQuery(Query):
    """terms_set: a per-doc minimum should match from a numeric field (a
    script form is parsed and raises at the rewrite)."""

    field: str = ""
    terms: List[Any] = dc_field(default_factory=list)
    minimum_should_match_field: Optional[str] = None
    minimum_should_match_script: Optional[Any] = None


@dataclass
class CombinedFieldsQuery(Query):
    """combined_fields: BM25F over weighted fields."""

    query: Any = None
    fields: List[str] = dc_field(default_factory=list)
    operator: str = "or"
    minimum_should_match: Optional[str] = None


@dataclass
class PinnedQuery(Query):
    ids: List[str] = dc_field(default_factory=list)
    organic: Optional[Query] = None


@dataclass
class BoostingQuery(Query):
    positive: Optional[Query] = None
    negative: Optional[Query] = None
    negative_boost: float = 0.5


@dataclass
class DisMaxQuery(Query):
    queries: List[Query] = dc_field(default_factory=list)
    tie_breaker: float = 0.0


@dataclass
class MatchPhraseQuery(Query):
    field: str = ""
    query: Any = None
    slop: int = 0
    analyzer: Optional[str] = None
    prefix: bool = False               # match_phrase_prefix
    max_expansions: int = 50


@dataclass
class SpanTermQuery(Query):
    field: str = ""
    value: str = ""


@dataclass
class SpanNearQuery(Query):
    clauses: List[Query] = dc_field(default_factory=list)
    slop: int = 0
    in_order: bool = True


@dataclass
class IntervalRule:
    """One node of an intervals source tree (the reference's
    IntervalsSourceProvider): match/prefix/wildcard/fuzzy/all_of/any_of
    with an optional filter. Only a lone `match` rule without a filter is
    served."""

    kind: str
    query: str = ""
    max_gaps: int = -1
    ordered: bool = False
    analyzer: Optional[str] = None
    rules: List["IntervalRule"] = dc_field(default_factory=list)
    filter_kind: Optional[str] = None


@dataclass
class IntervalsQuery(Query):
    field: str = ""
    rule: Optional[IntervalRule] = None


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
    date_format: Optional[str] = None  # parsed; the rewrite does not read it
    relation: str = "intersects"       # range-field targets only


@dataclass
class PrefixQuery(Query):
    field: str = ""
    value: str = ""
    case_insensitive: bool = False


@dataclass
class WildcardQuery(Query):
    field: str = ""
    value: str = ""
    case_insensitive: bool = False


@dataclass
class RegexpQuery(Query):
    field: str = ""
    value: str = ""


@dataclass
class FuzzyQuery(Query):
    field: str = ""
    value: str = ""
    fuzziness: Any = "AUTO"
    prefix_length: int = 0


@dataclass
class MatchBoolPrefixQuery(Query):
    field: str = ""
    query: Any = None
    operator: str = "or"
    analyzer: Optional[str] = None


@dataclass
class ConstantScoreQuery(Query):
    filter: Optional[Query] = None


@dataclass
class KnnQuery(Query):
    field: str = ""
    vector: List[float] = dc_field(default_factory=list)
    k: int = 10           # parsed; no search reads it (as in the reference)
    filter: Optional[Query] = None
    # IVF overrides (the k-NN query's `method_parameters`): nprobe widens
    # or narrows the probe; exact=True forces the scan
    nprobe: Optional[int] = None
    exact: bool = False


@dataclass
class RankFeatureQuery(Query):
    """A rank_feature(s) value through one of four monotone functions."""

    field: str = ""
    function: str = "saturation"   # saturation | log | sigmoid | linear
    pivot: Optional[float] = None  # saturation / sigmoid
    scaling_factor: Optional[float] = None  # log
    exponent: Optional[float] = None        # sigmoid


@dataclass
class GeoDistanceQuery(Query):
    field: str = ""
    lat: float = 0.0
    lon: float = 0.0
    distance_m: float = 0.0
    # `_inclusive` false: a strict < at the radius
    inclusive: bool = True


@dataclass
class GeoBoundingBoxQuery(Query):
    field: str = ""
    top: float = 0.0
    left: float = 0.0
    bottom: float = 0.0
    right: float = 0.0


@dataclass
class GeoPolygonQuery(Query):
    field: str = ""
    # vertex lists, parallel (lat[i], lon[i])
    lats: List[float] = dc_field(default_factory=list)
    lons: List[float] = dc_field(default_factory=list)


@dataclass
class GeoShapeQuery(Query):
    field: str = ""
    shape: Any = None              # GeoJSON dict or WKT string
    relation: str = "intersects"   # intersects | disjoint | within | contains
    ignore_unmapped: bool = False


@dataclass
class DistanceFeatureQuery(Query):
    """boost * pivot / (pivot + distance) on a date or geo_point field."""

    field: str = ""
    origin: Any = None
    pivot: Any = None


@dataclass
class NeuralSparseQuery(Query):
    """Learned-sparse dot product over a rank_features / sparse_vector
    field, from raw `query_tokens` (model inference is not the engine's)."""

    field: str = ""
    tokens: Dict[str, float] = dc_field(default_factory=dict)


@dataclass
class HybridQuery(Query):
    """Top-level hybrid retrieval: N sub-queries (raw dicts), each served
    as its own search, fused at the coordinator (`search/fusion.py`)."""

    queries: List[dict] = dc_field(default_factory=list)
    fusion: Dict[str, Any] = dc_field(default_factory=dict)


@dataclass
class QueryStringQuery(Query):
    query: str = ""
    default_field: Optional[str] = None
    fields: List[str] = dc_field(default_factory=list)
    default_operator: str = "or"
    phrase_slop: int = 0


@dataclass
class SimpleQueryStringQuery(Query):
    query: str = ""
    fields: List[str] = dc_field(default_factory=list)
    default_operator: str = "or"


@dataclass
class ScoreFunction:
    """One function of a function_score: kind weight | field_value_factor
    | random_score | script_score | decay (gauss, exp or linear over one
    field: origin, scale, offset, decay)."""

    kind: str
    weight: float = 1.0
    filter: Optional[Query] = None
    field: Optional[str] = None
    factor: float = 1.0
    modifier: str = "none"
    missing: Optional[float] = None
    seed: int = 0
    script: Optional[str] = None   # painless-lite source
    script_params: Optional[dict] = None
    decay_shape: Optional[str] = None   # gauss | exp | linear
    origin: Any = None
    scale: Any = None
    offset: Any = None
    decay: float = 0.5


@dataclass
class FunctionScoreQuery(Query):
    query: Optional[Query] = None
    functions: List[ScoreFunction] = dc_field(default_factory=list)
    score_mode: str = "multiply"   # multiply | sum | avg | max | min | first
    boost_mode: str = "multiply"   # multiply | sum | replace | avg | max | min
    max_boost: float = 3.4e38
    min_score: Optional[float] = None


@dataclass
class ScriptQuery(Query):
    """`script` query: the docs where the expression is truthy."""

    source: str = ""
    params: Optional[dict] = None


@dataclass
class ScriptScoreQuery(Query):
    """`script_score` query: the script replaces the child's score."""

    query: Optional[Query] = None
    source: str = ""
    params: Optional[dict] = None
    min_score: Optional[float] = None


@dataclass
class MoreLikeThisQuery(Query):
    """Select the liked texts' or docs' interesting terms by tf x idf and
    search them as a weighted OR (Lucene MoreLikeThis)."""

    fields: List[str] = dc_field(default_factory=list)
    like: List[Any] = dc_field(default_factory=list)   # str | {"_id"|"doc"}
    unlike: List[Any] = dc_field(default_factory=list)
    max_query_terms: int = 25
    min_term_freq: int = 2
    min_doc_freq: int = 5
    max_doc_freq: int = 2**31 - 1
    min_word_length: int = 0
    max_word_length: int = 0          # 0: unbounded
    stop_words: List[str] = dc_field(default_factory=list)
    minimum_should_match: Optional[str] = "30%"
    boost_terms: float = 0.0
    include: bool = False


@dataclass
class NestedQuery(Query):
    path: str = ""
    query: Optional[Query] = None
    score_mode: str = "avg"   # avg | sum | max | min | none
    ignore_unmapped: bool = False
    inner_hits: Optional[dict] = None


@dataclass
class HasChildQuery(Query):
    """Parents with matching children."""

    type: str = ""
    query: Optional[Query] = None
    score_mode: str = "none"  # none | min | max | sum | avg
    min_children: int = 1
    max_children: int = 2**31 - 1
    ignore_unmapped: bool = False
    inner_hits: Optional[dict] = None


@dataclass
class HasParentQuery(Query):
    """Children whose parent matches."""

    parent_type: str = ""
    query: Optional[Query] = None
    score: bool = False
    ignore_unmapped: bool = False
    inner_hits: Optional[dict] = None


@dataclass
class ParentIdQuery(Query):
    """Children of one parent id."""

    type: str = ""
    id: str = ""
    ignore_unmapped: bool = False


@dataclass
class PercolateQuery(Query):
    """Stored percolator queries matched against candidate documents;
    an `index` / `id` reference is resolved by the client before the
    parse."""

    field: str = ""
    documents: List[dict] = dc_field(default_factory=list)
    index: Optional[str] = None
    id: Optional[str] = None
    routing: Optional[str] = None


def _one_entry(d: dict, what: str) -> Tuple[str, Any]:
    if not isinstance(d, dict) or len(d) != 1:
        raise QueryParseError(
            f"[{what}] malformed query, expected a single field object")
    return next(iter(d.items()))


def _common(q: Query, body: Any) -> None:
    if isinstance(body, dict):
        q.boost = float(body.get("boost", 1.0))
        q.name = body.get("_name")


def parse_query(dsl: Optional[dict]) -> Query:
    """DSL dict -> Query tree."""
    if dsl is None:
        return MatchAllQuery()
    kind, body = _one_entry(dsl, "query")

    if kind == "match_all":
        q = MatchAllQuery()
        _common(q, body)
        return q

    if kind == "match_none":
        q = MatchNoneQuery()
        _common(q, body)
        return q

    if kind == "exists":
        q = ExistsQuery(field=body["field"])
        _common(q, body)
        return q

    if kind == "ids":
        q = IdsQuery(values=list(body.get("values", [])))
        _common(q, body)
        return q

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
            # a terms lookup: the reference reads the lookup object's keys
            # as the terms (no hit), where OpenSearch fetches the terms
            raise NotPortedError("terms lookup")
        q = TermsQuery(field=f, values=list(vals))
        _common(q, opts)
        return q

    if kind == "terms_set":
        f, spec = _one_entry(body, "terms_set")
        if not isinstance(spec, dict) or "terms" not in spec:
            raise QueryParseError("[terms_set] requires [terms]")
        msf = spec.get("minimum_should_match_field")
        mss = spec.get("minimum_should_match_script")
        if msf is None and mss is None:
            raise QueryParseError(
                "[terms_set] requires [minimum_should_match_field] or "
                "[minimum_should_match_script]")
        q = TermsSetQuery(field=f, terms=list(spec["terms"]),
                          minimum_should_match_field=msf,
                          minimum_should_match_script=mss)
        _common(q, spec)
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

    if kind == "multi_match":
        q = MultiMatchQuery(fields=list(body.get("fields", [])),
                            query=body.get("query"),
                            type=body.get("type", "best_fields"),
                            operator=str(body.get("operator", "or")).lower(),
                            tie_breaker=float(body.get("tie_breaker", 0.0)),
                            minimum_should_match=body.get(
                                "minimum_should_match"))
        _common(q, body)
        return q

    if kind == "combined_fields":
        q = CombinedFieldsQuery(query=body.get("query"),
                                fields=list(body.get("fields", [])),
                                operator=str(body.get("operator",
                                                      "or")).lower(),
                                minimum_should_match=body.get(
                                    "minimum_should_match"))
        if not q.fields:
            raise QueryParseError("[combined_fields] requires [fields]")
        _common(q, body)
        return q

    if kind == "wrapper":
        try:
            inner = json.loads(base64.b64decode(body["query"]))
        except Exception as e:
            raise QueryParseError(f"[wrapper] cannot decode query: {e}")
        return parse_query(inner)

    if kind == "pinned":
        organic = body.get("organic")
        q = PinnedQuery(ids=[str(i) for i in body.get("ids", [])],
                        organic=parse_query(organic) if organic else None)
        _common(q, body)
        return q

    if kind in ("match_phrase", "match_phrase_prefix"):
        f, spec = _one_entry(body, kind)
        prefix = kind == "match_phrase_prefix"
        if isinstance(spec, dict):
            q = MatchPhraseQuery(field=f, query=spec.get("query"),
                                 slop=int(spec.get("slop", 0)),
                                 analyzer=spec.get("analyzer"),
                                 prefix=prefix,
                                 max_expansions=int(spec.get(
                                     "max_expansions", 50)))
            _common(q, spec)
        else:
            q = MatchPhraseQuery(field=f, query=spec, prefix=prefix)
        return q

    if kind == "span_term":
        f, spec = _one_entry(body, "span_term")
        if isinstance(spec, dict):
            q = SpanTermQuery(field=f, value=str(spec.get("value")))
            _common(q, spec)
        else:
            q = SpanTermQuery(field=f, value=str(spec))
        return q

    if kind == "span_near":
        q = SpanNearQuery(clauses=[parse_query(c)
                                   for c in body.get("clauses", [])],
                          slop=int(body.get("slop", 0)),
                          in_order=bool(body.get("in_order", True)))
        _common(q, body)
        return q

    if kind == "intervals":
        f, spec = _one_entry(body, "intervals")
        if not isinstance(spec, dict):
            raise QueryParseError("[intervals] needs a rule object")
        q = IntervalsQuery(field=f, rule=parse_interval_rule(spec))
        _common(q, spec)
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
        q = RangeQuery(field=f, gte=spec.get("gte", spec.get("from")),
                       gt=spec.get("gt"), lte=spec.get("lte", spec.get("to")),
                       lt=spec.get("lt"), date_format=spec.get("format"),
                       relation=str(spec.get("relation",
                                             "intersects")).lower())
        _common(q, spec)
        return q

    if kind == "constant_score":
        q = ConstantScoreQuery(filter=parse_query(body["filter"]))
        _common(q, body)
        return q

    if kind == "boosting":
        q = BoostingQuery(positive=parse_query(body["positive"]),
                          negative=parse_query(body["negative"]),
                          negative_boost=float(body.get("negative_boost",
                                                        0.5)))
        _common(q, body)
        return q

    if kind == "dis_max":
        q = DisMaxQuery(queries=[parse_query(x)
                                 for x in body.get("queries", [])],
                        tie_breaker=float(body.get("tie_breaker", 0.0)))
        _common(q, body)
        return q

    if kind == "match_bool_prefix":
        f, spec = _one_entry(body, "match_bool_prefix")
        if isinstance(spec, dict):
            q = MatchBoolPrefixQuery(field=f, query=spec.get("query"),
                                     operator=str(spec.get("operator",
                                                           "or")).lower(),
                                     analyzer=spec.get("analyzer"))
            _common(q, spec)
        else:
            q = MatchBoolPrefixQuery(field=f, query=spec)
        return q

    if kind in ("prefix", "wildcard", "regexp", "fuzzy"):
        f, spec = _one_entry(body, kind)
        if isinstance(spec, dict):
            value = spec.get("value", spec.get(kind))
            ci = spec.get("case_insensitive", False)
        else:
            value, ci, spec = spec, False, {}
        if kind == "prefix":
            q = PrefixQuery(field=f, value=str(value), case_insensitive=ci)
        elif kind == "wildcard":
            q = WildcardQuery(field=f, value=str(value), case_insensitive=ci)
        elif kind == "regexp":
            q = RegexpQuery(field=f, value=str(value))
        else:
            q = FuzzyQuery(field=f, value=str(value),
                           fuzziness=spec.get("fuzziness", "AUTO"),
                           prefix_length=int(spec.get("prefix_length", 0)))
        _common(q, spec)
        return q

    if kind == "knn":
        # the k-NN plugin's form: {"knn": {"field": {"vector": [...],
        # "k": 10, "filter": {...}}}}
        f, spec = _one_entry(body, "knn")
        mp = spec.get("method_parameters", {})
        nprobe = mp.get("nprobe", spec.get("nprobe"))
        q = KnnQuery(field=f, vector=list(spec["vector"]),
                     k=int(spec.get("k", 10)),
                     filter=(parse_query(spec["filter"])
                             if spec.get("filter") else None),
                     nprobe=int(nprobe) if nprobe is not None else None,
                     exact=bool(spec.get("exact", False)))
        _common(q, spec)
        return q

    if kind == "rank_feature":
        fns = [k for k in ("saturation", "log", "sigmoid", "linear")
               if k in body]
        if len(fns) > 1:
            raise QueryParseError(
                "[rank_feature] accepts at most one function")
        fn = fns[0] if fns else "saturation"
        spec = body.get(fn) or {}
        if fn == "log" and "scaling_factor" not in spec:
            raise QueryParseError(
                "[rank_feature] [log] requires scaling_factor")
        if fn == "sigmoid" and ("pivot" not in spec
                                or "exponent" not in spec):
            raise QueryParseError(
                "[rank_feature] [sigmoid] requires pivot and exponent")
        q = RankFeatureQuery(field=body["field"], function=fn,
                             pivot=spec.get("pivot"),
                             scaling_factor=spec.get("scaling_factor"),
                             exponent=spec.get("exponent"))
        _common(q, body)
        return q

    if kind == "distance_feature":
        if body.get("origin") is None or body.get("pivot") is None:
            raise QueryParseError(
                "[distance_feature] requires origin and pivot")
        q = DistanceFeatureQuery(field=body["field"], origin=body["origin"],
                                 pivot=body["pivot"])
        _common(q, body)
        return q

    if kind == "neural_sparse":
        f, spec = _one_entry(body, "neural_sparse")
        tokens = spec.get("query_tokens")
        if not isinstance(tokens, dict) or not tokens:
            raise QueryParseError(
                "[neural_sparse] requires query_tokens (raw token weights; "
                "model inference is out of engine scope)")
        q = NeuralSparseQuery(field=f, tokens={str(t): float(w)
                                               for t, w in tokens.items()})
        _common(q, spec)
        return q

    if kind == "hybrid":
        subs = body.get("queries")
        if not isinstance(subs, list) or not subs:
            raise QueryParseError("[hybrid] requires a non-empty [queries] "
                                  "list")
        if len(subs) > MAX_HYBRID_SUB_QUERIES:
            raise QueryParseError(
                f"[hybrid] supports at most {MAX_HYBRID_SUB_QUERIES} "
                f"sub-queries, got {len(subs)}")
        for sub in subs:
            if not isinstance(sub, dict):
                raise QueryParseError("[hybrid] sub-queries must be query "
                                      "objects")
            if isinstance(parse_query(sub), HybridQuery):
                raise QueryParseError("[hybrid] queries cannot nest")
        q = HybridQuery(queries=[dict(s) for s in subs],
                        fusion=parse_fusion_spec(body.get("fusion"),
                                                 len(subs)))
        _common(q, body)
        return q

    if kind == "query_string":
        q = QueryStringQuery(query=body["query"],
                             default_field=body.get("default_field"),
                             fields=list(body.get("fields", [])),
                             default_operator=str(body.get(
                                 "default_operator", "or")).lower(),
                             phrase_slop=int(body.get("phrase_slop", 0)))
        _common(q, body)
        return q

    if kind == "simple_query_string":
        q = SimpleQueryStringQuery(query=body["query"],
                                   fields=list(body.get("fields", [])),
                                   default_operator=str(body.get(
                                       "default_operator", "or")).lower())
        _common(q, body)
        return q

    if kind == "function_score":
        inner = (parse_query(body.get("query")) if body.get("query")
                 else MatchAllQuery())
        functions = []
        raw_fns = body.get("functions", [])
        if not raw_fns:  # single-function shorthand
            raw_fns = [{k: v for k, v in body.items()
                        if k in ("weight", "field_value_factor",
                                 "random_score", "script_score", "gauss",
                                 "exp", "linear")}]
        for fn in raw_fns:
            filt = parse_query(fn["filter"]) if "filter" in fn else None
            shape = next((s for s in ("gauss", "exp", "linear") if s in fn),
                         None)
            if shape is not None:
                spec = dict(fn[shape])
                spec.pop("multi_value_mode", None)
                if len(spec) != 1:
                    raise QueryParseError(
                        f"[{shape}] decay needs exactly one field")
                dfield, dspec = next(iter(spec.items()))
                if "scale" not in dspec:
                    raise QueryParseError(f"[{shape}] requires [scale]")
                functions.append(ScoreFunction(
                    "decay", fn.get("weight", 1.0), filt, dfield,
                    decay_shape=shape, origin=dspec.get("origin"),
                    scale=dspec["scale"], offset=dspec.get("offset", 0),
                    decay=float(dspec.get("decay", 0.5))))
            elif "field_value_factor" in fn:
                fv = fn["field_value_factor"]
                functions.append(ScoreFunction(
                    "field_value_factor", fn.get("weight", 1.0), filt,
                    fv["field"], fv.get("factor", 1.0),
                    fv.get("modifier", "none"), fv.get("missing")))
            elif "random_score" in fn:
                functions.append(ScoreFunction(
                    "random_score", fn.get("weight", 1.0), filt,
                    seed=int(fn["random_score"].get("seed", 0))))
            elif "script_score" in fn:
                src, prm = parse_script_spec(
                    fn["script_score"].get("script"))
                functions.append(ScoreFunction(
                    "script_score", fn.get("weight", 1.0), filt, script=src,
                    script_params=prm))
            elif "weight" in fn:
                functions.append(ScoreFunction("weight", float(fn["weight"]),
                                               filt))
        q = FunctionScoreQuery(query=inner, functions=functions,
                               score_mode=body.get("score_mode", "multiply"),
                               boost_mode=body.get("boost_mode", "multiply"),
                               min_score=body.get("min_score"))
        _common(q, body)
        return q

    if kind == "script":
        src, prm = parse_script_spec(body.get("script"))
        q = ScriptQuery(source=src, params=prm)
        _common(q, body)
        return q

    if kind == "script_score":
        src, prm = parse_script_spec(body.get("script"))
        q = ScriptScoreQuery(query=parse_query(body.get("query")),
                             source=src, params=prm,
                             min_score=body.get("min_score"))
        _common(q, body)
        return q

    if kind == "geo_distance":
        dist = parse_distance(body["distance"])
        fields = [(k, v) for k, v in body.items()
                  if k not in ("distance", "boost", "_name",
                               "validation_method", "_inclusive")]
        f, point = fields[0]
        lat, lon = parse_geo(point)
        q = GeoDistanceQuery(field=f, lat=lat, lon=lon, distance_m=dist,
                             inclusive=bool(body.get("_inclusive", True)))
        _common(q, body)
        return q

    if kind == "geo_bounding_box":
        fields = [(k, v) for k, v in body.items()
                  if k not in ("boost", "_name", "validation_method")]
        f, box = fields[0]
        tl = box.get("top_left")
        if tl is not None:
            tlat, tlon = parse_geo(tl)
            blat, blon = parse_geo(box.get("bottom_right"))
        else:
            tlat, tlon, blat, blon = (box["top"], box["left"],
                                      box["bottom"], box["right"])
        q = GeoBoundingBoxQuery(field=f, top=tlat, left=tlon, bottom=blat,
                                right=blon)
        _common(q, body)
        return q

    if kind == "geo_polygon":
        fields = [(k, v) for k, v in body.items()
                  if k not in ("boost", "_name", "validation_method")]
        if not fields or not isinstance(fields[0][1], dict):
            raise QueryParseError("[geo_polygon] requires a field with "
                                  "a [points] object")
        f, spec = fields[0]
        pts = [parse_geo(p) for p in spec.get("points", [])]
        if len(pts) < 3:
            raise QueryParseError(
                "[geo_polygon] requires at least 3 points")
        q = GeoPolygonQuery(field=f, lats=[p[0] for p in pts],
                            lons=[p[1] for p in pts])
        _common(q, body)
        return q

    if kind == "geo_shape":
        fields = [(k, v) for k, v in body.items()
                  if k not in ("boost", "_name", "ignore_unmapped")]
        if not fields:
            raise QueryParseError("[geo_shape] requires a field")
        f, spec = fields[0]
        shape = spec.get("shape", spec.get("indexed_shape"))
        if shape is None:
            raise QueryParseError(
                "[geo_shape] requires [shape] (or a resolved [indexed_shape])")
        rel = str(spec.get("relation", "intersects")).lower()
        if rel not in ("intersects", "disjoint", "within", "contains"):
            raise QueryParseError(f"[geo_shape] unknown relation [{rel}]")
        q = GeoShapeQuery(field=f, shape=shape, relation=rel,
                          ignore_unmapped=bool(body.get("ignore_unmapped",
                                                        False)))
        _common(q, body)
        return q

    if kind == "more_like_this":
        like = body.get("like", [])
        like = like if isinstance(like, list) else [like]
        unlike = body.get("unlike", [])
        unlike = unlike if isinstance(unlike, list) else [unlike]
        if not like:
            raise QueryParseError("[more_like_this] requires [like]")
        q = MoreLikeThisQuery(
            fields=list(body.get("fields", [])), like=like, unlike=unlike,
            max_query_terms=int(body.get("max_query_terms", 25)),
            min_term_freq=int(body.get("min_term_freq", 2)),
            min_doc_freq=int(body.get("min_doc_freq", 5)),
            max_doc_freq=int(body.get("max_doc_freq", 2**31 - 1)),
            min_word_length=int(body.get("min_word_length", 0)),
            max_word_length=int(body.get("max_word_length", 0)),
            stop_words=list(body.get("stop_words", [])),
            minimum_should_match=body.get("minimum_should_match", "30%"),
            boost_terms=float(body.get("boost_terms", 0.0)),
            include=bool(body.get("include", False)))
        _common(q, body)
        return q

    if kind == "nested":
        q = NestedQuery(path=body["path"], query=parse_query(body["query"]),
                        score_mode=body.get("score_mode", "avg"),
                        ignore_unmapped=bool(body.get("ignore_unmapped",
                                                      False)),
                        inner_hits=body.get("inner_hits"))
        _common(q, body)
        return q

    if kind == "has_child":
        if body.get("score_mode", "none") not in ("none", "min", "max",
                                                  "sum", "avg"):
            raise QueryParseError(
                f"[has_child] unknown score_mode [{body['score_mode']}]")
        q = HasChildQuery(type=body["type"], query=parse_query(body["query"]),
                          score_mode=body.get("score_mode", "none"),
                          min_children=int(body.get("min_children", 1)),
                          max_children=int(body.get("max_children",
                                                    2**31 - 1)),
                          ignore_unmapped=bool(body.get("ignore_unmapped",
                                                        False)),
                          inner_hits=body.get("inner_hits"))
        _common(q, body)
        return q

    if kind == "has_parent":
        q = HasParentQuery(parent_type=body["parent_type"],
                           query=parse_query(body["query"]),
                           score=bool(body.get("score", False)),
                           ignore_unmapped=bool(body.get("ignore_unmapped",
                                                         False)),
                           inner_hits=body.get("inner_hits"))
        _common(q, body)
        return q

    if kind == "parent_id":
        q = ParentIdQuery(type=body["type"], id=str(body["id"]),
                          ignore_unmapped=bool(body.get("ignore_unmapped",
                                                        False)))
        _common(q, body)
        return q

    if kind == "percolate":
        docs = body.get("documents")
        if docs is None and body.get("document") is not None:
            docs = [body["document"]]
        if docs is None and body.get("index") is None:
            raise QueryParseError(
                "[percolate] requires `document`, `documents`, or "
                "`index`+`id`")
        q = PercolateQuery(field=body["field"], documents=list(docs or []),
                           index=body.get("index"), id=body.get("id"),
                           routing=body.get("routing"))
        _common(q, body)
        return q

    if kind in REFERENCE_KINDS:
        raise NotPortedError(f"query [{kind}]")
    raise QueryParseError(f"unknown query [{kind}]")


# the neural-search plugin's HybridQueryBuilder takes at most 5
MAX_HYBRID_SUB_QUERIES = 5
_FUSION_METHODS = ("rrf", "linear")
_FUSION_NORMS = ("min_max", "l2")
# pages fuse over fixed-depth rank windows, so `from` / `size` page into
# one list instead of re-fusing another window per page
DEFAULT_FUSION_WINDOW = 100


def parse_fusion_spec(spec, n_sub: int) -> Dict[str, Any]:
    """The [hybrid] fusion parameters, validated as the reference's:
    method `rrf` (default) or `linear`, rank_constant (60, at least 1),
    weights (1.0 each, one per sub-query, finite and non-negative),
    normalization `min_max` (default) or `l2`, window_size (100, at
    least 1); anything else is a 400."""
    spec = dict(spec or {})
    method = str(spec.get("method", "rrf")).lower()
    if method not in _FUSION_METHODS:
        raise QueryParseError(
            f"[hybrid] unknown fusion method [{method}] "
            f"(supported: {', '.join(_FUSION_METHODS)})")
    norm = str(spec.get("normalization", "min_max")).lower()
    if norm not in _FUSION_NORMS:
        raise QueryParseError(
            f"[hybrid] unknown normalization [{norm}] "
            f"(supported: {', '.join(_FUSION_NORMS)})")
    try:
        rank_constant = float(spec.get("rank_constant", 60))
        window = int(spec.get("window_size", DEFAULT_FUSION_WINDOW))
        weights = [float(w) for w in spec.get("weights", [1.0] * n_sub)]
    except (TypeError, ValueError) as e:
        raise QueryParseError(f"[hybrid] malformed fusion spec: {e}")
    if rank_constant < 1:
        raise QueryParseError("[hybrid] rank_constant must be >= 1")
    if window < 1:
        raise QueryParseError("[hybrid] window_size must be >= 1")
    if len(weights) != n_sub:
        raise QueryParseError(
            f"[hybrid] weights length [{len(weights)}] must match the "
            f"sub-query count [{n_sub}]")
    if any(w < 0 or w != w for w in weights):
        raise QueryParseError("[hybrid] weights must be finite and "
                              "non-negative")
    return {"method": method, "rank_constant": rank_constant,
            "weights": weights, "normalization": norm,
            "window_size": window}


# the other kinds the reference parses (opensearch_tpu/search/query_dsl.py
# `parse_query`); any kind outside them and the port's is unknown there too
REFERENCE_KINDS = frozenset((
    "span_or", "span_not", "span_first", "span_containing", "span_within",
    "span_multi", "field_masking_span"))


_INTERVAL_RULES = ("match", "prefix", "wildcard", "fuzzy", "all_of",
                   "any_of")
_INTERVAL_FILTERS = ("containing", "contained_by", "not_containing",
                     "not_contained_by", "not_overlapping", "before",
                     "after")


def parse_interval_rule(spec: dict) -> IntervalRule:
    """One intervals source node, validated as the reference validates
    it; the rules and filters the port does not serve are kept by kind
    (the rewrite raises NotPortedError naming them)."""
    kinds = [k for k in spec if k in _INTERVAL_RULES]
    if len(kinds) != 1:
        raise QueryParseError(
            "[intervals] rule must define exactly one of "
            "[match|prefix|wildcard|fuzzy|all_of|any_of]")
    kind = kinds[0]
    body = spec[kind]
    if not isinstance(body, dict):
        body = {"query": body}
    rule = IntervalRule(kind=kind,
                        max_gaps=int(body.get("max_gaps", -1)),
                        ordered=bool(body.get("ordered", False)))
    if kind in ("match", "prefix", "wildcard", "fuzzy"):
        rule.query = str(body.get("query", body.get(kind, body.get(
            "prefix" if kind == "prefix" else "pattern", ""))))
        rule.analyzer = body.get("analyzer")
    else:
        rule.rules = [parse_interval_rule(r)
                      for r in body.get("intervals", [])]
        if not rule.rules:
            raise QueryParseError(f"[intervals] [{kind}] needs [intervals]")
    filt = body.get("filter")
    if filt:
        fk = [k for k in filt if k in _INTERVAL_FILTERS]
        if len(fk) != 1:
            raise QueryParseError(
                f"[intervals] filter must be one of {_INTERVAL_FILTERS}")
        rule.filter_kind = fk[0]
        parse_interval_rule(filt[fk[0]])
    return rule


# meters per distance unit (the reference's DistanceUnit), longest
# suffix first
DISTANCE_UNITS = {"nauticalmiles": 1852.0, "kilometers": 1000.0,
                  "meters": 1.0, "miles": 1609.344, "nmi": 1852.0,
                  "km": 1000.0, "mi": 1609.344, "yd": 0.9144, "ft": 0.3048,
                  "in": 0.0254, "mm": 0.001, "cm": 0.01, "m": 1.0}


def parse_distance(d) -> float:
    """'5km', '100m', '2mi' -> meters (the reference's DistanceUnit). The
    longest suffix wins ('5nmi' is nautical miles, not '5n' miles)."""
    if isinstance(d, (int, float)):
        return float(d)
    s = str(d).strip().lower()
    for suf, mult in DISTANCE_UNITS.items():
        if s.endswith(suf):
            return float(s[: -len(suf)]) * mult
    return float(s)


def parse_script_spec(spec) -> Tuple[str, dict]:
    """{"source": ..., "params": ...} | "inline src" -> (source, params)
    (OpenSearch's Script.parse; `lang` is accepted and ignored:
    painless-lite is the only engine)."""
    if spec is None:
        raise QueryParseError("missing required [script]")
    if isinstance(spec, str):
        return spec, {}
    if isinstance(spec, dict):
        src = spec.get("source", spec.get("inline"))
        if not isinstance(src, str):
            raise QueryParseError("script requires a [source] string")
        return src, dict(spec.get("params") or {})
    raise QueryParseError("malformed [script]")


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
