"""Rewrite: DSL tree -> logical plan with index-wide statistics, and the
general query path that serves any plan over one segment (the
ShardContext, the rewrite, `can_match` and the prepare / emit / executor
programs of opensearch_tpu/search/compiler.py for the node kinds the port
serves).

A term, terms or match query on a text or keyword field becomes one
weighted term group (`LTerms`) with the reference's per-term weights (idf
x boost, f32) and minimum should match; on a numeric field it becomes an
`LRange` (terms: a bool of them): exact i64 on the long family
(integer, long, short, byte, date, boolean, token_count, unsigned_long),
f32 on the float family (a `match` on a date field
analyzes its text, as in the reference). A date bound parses as the
field's dates do (`index/mappings._parse_date`); a `range` on any other
field type raises the reference's `ValueError`. On an `ip` field a term
is its address string's row and a CIDR (a term, or a member of terms)
the exact i64 range of its mapped integers, a `range` its integers; an
unsigned_long compares its biased i64. A phrase on a `match_only_text`
field becomes `LSourcePhrase`: the terms' conjunction re-verified from
`_source`, scored at the constant phrase weight. A match whose terms
analyze away, a range on an unmapped field, or `match_none` becomes
`LMatchNone`; `match_all` `LMatchAll`, `exists` `LExists`, `ids` `LIds`.
`prefix`, `wildcard`, `regexp`, `fuzzy` and a `range` on a keyword field
become `LExpandTerms` over the reference's host expanders (the regexp DFA
and the fuzzy edit distance run as torch ops over the dictionary's
codepoint matrix, `search/regexp.py`); a `match` with `fuzziness` an
`LBool` of one fuzzy `LExpandTerms` per term, and `match_bool_prefix` an
`LBool` of term groups and a prefix expansion of the last term.
A `match_phrase`, a `match_phrase_prefix`, a `span_near` of `span_term`s
on one field and an `intervals` lone `match` rule of two terms or more
become `LPhrase` (one term: a term group, or for a prefix an
`LExpandTerms` over the prefix's rows); any other span or intervals form
raises `NotPortedError` (the reference serves them on its host span
engine).
`bool` becomes `LBool` and `constant_score` `LConstScore`, their filter
and must_not clauses rewritten in filter context (`scoring=False`: a
term there is a non-scoring match), as in the reference. `dis_max`
becomes `LDisMax`, `boosting` `LBoosting` (its negative side in filter
context), `terms_set` with a minimum field `LTermsSet`, `pinned`
`LPinned`, `combined_fields` `LCombined` (its union-df idf computed
here), and a `multi_match` one child per field: an `LDisMax` of them for
`best_fields`, `phrase` and `phrase_prefix`, else an `LBool` of shoulds
(so `cross_fields` and `bool_prefix` serve `most_fields`' page, as in
the reference). A `knn` query becomes `LKnn` (its vector unit-normed in
f32 numpy for a cosine field, its filter rewritten in filter context);
its `k` is not read, so it matches every live doc with a vector (a probe:
every such doc in the probed lists), as in the reference. A
`rank_feature` becomes `LRankFeature` over a rank_feature column or
over the feature of the longest mapped prefix of a `rank_features` /
`sparse_vector` field (the default saturation pivot the reference's
arithmetic mean), a `neural_sparse` with raw `query_tokens`
`LSparseDot` (tokens sorted, f32 weights), a `distance_feature` on a
date or geo_point field `LDistanceFeature` (any other type is the
reference's 400). A `range` on a range field becomes the constant-score
bool of two `LRange`s over its `#lo` / `#hi` columns that its
`relation` asks (`_range_field_node`), a `term` on one the containment
of the value, `exists` the `#lo` column's; a term on a flat_object leaf
path is its `path=value` term on `<root>#paths`, `exists` there a
prefix expansion. `geo_distance`, `geo_bounding_box`, `geo_polygon` and
`geo_shape` become `LGeoDist`, `LGeoBox`, `LGeoPolygon` and
`LGeoShape`.
A `hybrid` query reaching the rewrite is nested inside another query:
the reference's 400. A `query_string` or `simple_query_string` becomes
the DSL tree of `search/querystring.py` (no field or `*`: the text
fields in mapping order) and is rewritten as that tree; `function_score`
becomes `LFuncScore` (its functions' filters in filter context),
`script` `LScriptFilter` and `script_score` `LScriptScore` (their source
checked by `validate_device_script`: a compile error is the reference's
400), a terms_set's `minimum_should_match_script` an `LTermsSet` whose
minimum the host runs per doc. A `nested` query becomes `LNested`
(its child plan rewritten over the path's child segments' statistics,
`nested_context`; a deeper path asked from an outer level through the
chain of enclosing paths; an unmapped path the reference's 400),
`has_child` / `has_parent` `LHasChild` / `LHasParent` over the index's
`JoinIndex` (`search/join.py`) and `parent_id` a constant-score filter
on `<join>#parent`; `more_like_this` the reference's term selection
(`_rewrite_mlt`) as one weighted term group (one field) or a bool of
single-term groups; `percolate` `LPercolate` over the candidates' mini
segment (`search/percolate.py`). A clause's `_name` goes onto its node.
Any other query or field kind raises `NotPortedError`.

The general path (`emit`, `run_segment`) evaluates a plan as torch ops on
the engine's device: every node becomes dense per-doc (scores, match
count) arrays (`ops/scoring.ScoredMask`), filter and must_not clauses
come from the cached masks of `search/filters.py`, a phrase is the pair
join of `ops/positions.py` over pair keys cached per segment and device,
a kNN node the exact scan or the IVF probe of `ops/knn.py` over the
segment's vector matrix (`Segment.vector_on`, `Segment.ivf_on`), a
feature node a gather of its rows' (doc, weight) postings, the
function or the query weight times the weight, and a scatter row by
row (`ops/scoring.feature_score`), a distance_feature the reference's
f32 distance over the date column's (hi, lo) words, a function_score
the reference's factors (field_value_factor and its modifiers, the
random_score hash, a script, gauss / exp / linear decays over a
numeric or date column's f32 view or a geo_point's f32 haversine,
weights) combined by score and boost mode, a script or script_score
painless-lite's `eval_device` over the columns' f32 views, a geo node
the haversine radius, the box or the ray-cast over `Segment.geo_on`
(`ops/scoring.py`) or a geo_shape's exact host mask (`geo_shape_mask`),
a nested node its child plan over the child segment (a child live
where its parent is), its matches counted and its scores reduced into
the parents by `index_add` / `scatter_reduce` (sum, avg, max, min,
none), a join node its slot vectors' window (`join.emit_join`), a
percolate node the host's match mask, and a masked top-k closes it.
A `nested` sort ranks each parent by its children's values reduced by
the sort's mode (`nested_sort_values`); the `nested` /
`reverse_nested` aggs move the match into a path's child segment and
back up `ShardContext.nest_stack`, `children` / `parent` join the query's
root plan (`ShardContext.current_lroot`) through the slot pre-pass
(`join_agg_match`). The geo aggregations count a haversine's
rings, bound and average the points, or count the cells of
`geo_grid_cells` (f64 numpy on the host, once per segment). It serves
every shape the fused kernels and the impact rung decline.
"""

from __future__ import annotations

import copy
import datetime as _dt
import fnmatch
import ipaddress
import math
import re
import time
import zlib
from bisect import bisect_left, bisect_right
from dataclasses import dataclass, field as dc_field
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..errors import NotPortedError
from ..index.mappings import (FEATURE_TYPES, FLOAT_TYPES, KEYWORD_TYPES,
                              NUMERIC_TYPES, RANGE_MEMBER, RANGE_TYPES,
                              TEXT_TYPES, Mappings, _parse_date,
                              coerce_value, ip_to_int, parse_geo,
                              parse_range_value, range_member_coerce)
from ..index.segment import Segment, next_pow2
from ..models.similarity import Similarity, resolve_similarity
from ..ops import aggs as agg_ops
from ..ops import knn as knn_ops
from ..ops import positions as pos_ops
from ..ops import scoring as ops
from .aggregations import AUTO_LADDER, PIPELINE_KINDS, STATS_FAMILY
from ..ops.bm25 import LANES
from ..script import painless_lite as pl
from . import query_dsl as dsl
from . import regexp as rx


class ShardContext:
    """Index-wide view used during rewrite (reference QueryShardContext)."""

    def __init__(self, mappings: Mappings, segments: List[Segment],
                 similarity=None, device=None):
        self.mappings = mappings
        self.segments = segments
        self.default_sim = resolve_similarity(similarity)
        # where the expanders' device passes run: the engine's device
        self.device = torch.device("cpu") if device is None else device
        # the query's root plan, which children / parent aggs join
        # against (set by the executor's plan)
        self.current_lroot: Optional["LNode"] = None
        # the nested aggs' levels down to the segment an agg reads, root
        # first: (path, segment, parent map, live) each; empty at the root
        self.nest_stack: tuple = ()

    def sim_for(self, field: str) -> Similarity:
        return self.default_sim

    @property
    def num_docs(self) -> int:
        # incl. deleted, like Lucene maxDoc
        return sum(s.ndocs for s in self.segments)

    def doc_freq(self, field: str, term: str) -> int:
        return sum(s.postings[field].doc_freq(term)
                   for s in self.segments if field in s.postings)

    def field_stats(self, field: str) -> Tuple[int, int]:
        doc_count, sum_dl = 0, 0
        for s in self.segments:
            st = s.text_stats.get(field)
            if st:
                doc_count += st.doc_count
                sum_dl += st.sum_dl
        return doc_count, sum_dl

    def avgdl(self, field: str) -> float:
        dc, sdl = self.field_stats(field)
        return (sdl / dc) if dc > 0 else 1.0


@dataclass
class LNode:
    name: Optional[str] = None


@dataclass
class LTerms(LNode):
    """One weighted term group over a field: the fused scoring leaf.
    mode "filter" scores every match with the constant `boost`."""

    field: str = ""
    terms: List[str] = dc_field(default_factory=list)
    weights: Optional[np.ndarray] = None   # f32[T] idf*boost
    msm: int = 1
    mode: str = "score"                    # score | filter
    sim: Optional[Similarity] = None
    has_norms: bool = True
    boost: float = 1.0


@dataclass
class LExpandTerms(LNode):
    """A multi-term expansion (prefix, wildcard, regexp, fuzzy, a keyword
    range, a phrase's lone prefix term): the dictionary rows of its terms
    over a segment, from `expander(segment) -> i32 rows`, resolved once
    per segment (`rows`) whoever asks (the emit, the filter mask and its
    key); constant score, as Lucene's MultiTermQuery CONSTANT_SCORE
    rewrite."""

    field: str = ""
    expander: Optional[Callable[[Segment], np.ndarray]] = None
    boost: float = 1.0
    _rows: dict = dc_field(default_factory=dict, repr=False, compare=False)

    def rows(self, seg: Segment) -> np.ndarray:
        got = self._rows.get(seg.uid)
        if got is None:
            got = self._rows[seg.uid] = self.expander(seg)
        return got


@dataclass
class LPhrase(LNode):
    """Positional phrase / span near: the pair join of `ops/positions.py`
    over the segment's positions. `weight` is the terms' summed idf x
    boost (Lucene's PhraseWeight); the last term may expand by prefix
    (match_phrase_prefix)."""

    field: str = ""
    terms: List[str] = dc_field(default_factory=list)
    slop: int = 0
    weight: float = 0.0
    sim: Optional[Similarity] = None
    has_norms: bool = True
    prefix_last: bool = False
    max_expansions: int = 50
    ordered: bool = False              # span_near in_order, intervals ordered
    gap_cost: bool = False             # span / intervals gaps, not moves


@dataclass
class LSourcePhrase(LNode):
    """A phrase over a positions-less `match_only_text` field: candidates
    from the terms' postings conjunction, the phrase verified by
    re-analyzing `_source` (OpenSearch's SourceConfirmedTextQuery); a hit
    scores the constant phrase weight, as in the reference (no freqs are
    indexed)."""

    field: str = ""
    terms: List[str] = dc_field(default_factory=list)
    slop: int = 0
    weight: float = 1.0

    def docs(self, seg: Segment, mappings: Mappings) -> List[int]:
        """The segment's docs (deleted ones too) where the phrase holds,
        ascending, cached per segment."""
        cache = seg.__dict__.setdefault("_source_phrase_docs", {})
        key = (self.field, tuple(self.terms), self.slop)
        got = cache.get(key)
        if got is None:
            got = _source_phrase_docs(self, seg, mappings)
            cache[key] = got
        return got


@dataclass
class LMatchAll(LNode):
    boost: float = 1.0


@dataclass
class LMatchNone(LNode):
    pass


@dataclass
class LExists(LNode):
    field: str = ""
    boost: float = 1.0


@dataclass
class LIds(LNode):
    ids: List[str] = dc_field(default_factory=list)
    boost: float = 1.0


@dataclass
class LRange(LNode):
    """Range over a numeric column: exact i64 (kind "int"), or the f32
    view against f32 bounds (kind "float"); a bound of None is open."""

    field: str = ""
    kind: str = "int"
    lo: Any = None
    hi: Any = None
    include_lo: bool = True
    include_hi: bool = True
    boost: float = 1.0


@dataclass
class LBool(LNode):
    musts: List[LNode] = dc_field(default_factory=list)
    shoulds: List[LNode] = dc_field(default_factory=list)
    must_nots: List[LNode] = dc_field(default_factory=list)
    filters: List[LNode] = dc_field(default_factory=list)
    msm: int = 0
    boost: float = 1.0


@dataclass
class LConstScore(LNode):
    child: Optional[LNode] = None
    boost: float = 1.0


@dataclass
class LDisMax(LNode):
    children: List[LNode] = dc_field(default_factory=list)
    tie_breaker: float = 0.0
    boost: float = 1.0


@dataclass
class LBoosting(LNode):
    """`positive` scores, times `negative_boost` where the filter-context
    `negative` also matches."""

    positive: Optional[LNode] = None
    negative: Optional[LNode] = None
    negative_boost: float = 0.5
    boost: float = 1.0


@dataclass
class LTermsSet(LNode):
    """terms_set: the child term group (msm 0) counts the matching terms
    of each doc; a doc matches where the count reaches its own minimum,
    the f32 value of `msm_field` (a doc without one never matches) or of
    `script` ((source, params), run per doc on the host with
    `params.num_terms`)."""

    field: str = ""
    child: Optional[LTerms] = None
    msm_field: Optional[str] = None
    script: Optional[tuple] = None
    num_terms: int = 0


@dataclass
class LPinned(LNode):
    """pinned: the listed ids score 1e6 - rank, above any organic score,
    in list order; the organic matches follow, scores times `boost`."""

    ids: Tuple[str, ...] = ()
    organic: Optional[LNode] = None
    boost: float = 1.0


@dataclass
class LCombined(LNode):
    """combined_fields: BM25F. Each term's tf is summed over the weighted
    fields before saturation, against the weighted doc lengths; `idf`
    is each term's idf from the union of the fields' docs, x boost."""

    fields: Tuple[Tuple[str, float], ...] = ()
    terms: Tuple[str, ...] = ()
    msm: int = 1
    idf: Optional[np.ndarray] = None


@dataclass
class LKnn(LNode):
    """kNN over a vector field: `vector` is f32 (unit-normed for cosine);
    `nprobe` None takes the IVF index's default, `exact` forces the scan
    on a field with an IVF method."""

    field: str = ""
    vector: Optional[np.ndarray] = None
    k: int = 10
    filter: Optional[LNode] = None
    similarity: str = "cosine"
    boost: float = 1.0
    nprobe: Optional[int] = None
    exact: bool = False


@dataclass
class LRankFeature(LNode):
    """rank_feature: one feature row of a feature field (gather -> f ->
    scatter), or a rank_feature numeric column (`feature` None)."""

    field: str = ""
    feature: Optional[str] = None
    fn: str = "saturation"
    p1: float = 1.0
    p2: float = 1.0
    positive: bool = True
    boost: float = 1.0


@dataclass
class LSparseDot(LNode):
    """Learned-sparse dot product: the sum over the query's tokens (sorted)
    of query weight x stored weight, over a feature field."""

    field: str = ""
    tokens: List[str] = dc_field(default_factory=list)
    weights: Optional[np.ndarray] = None     # f32, one per token
    boost: float = 1.0


@dataclass
class LDistanceFeature(LNode):
    """distance_feature: boost * pivot / (pivot + distance). On a date
    field (kind "date") the origin is epoch millis and the pivot millis;
    on a geo_point field (kind "geo") the origin is (lat, lon) and the
    pivot meters."""

    field: str = ""
    kind: str = "date"
    origin: Any = 0
    pivot: float = 0.0
    boost: float = 1.0


@dataclass
class LGeoDist(LNode):
    """geo_distance: docs whose point lies within `radius_m` of (lat,
    lon) (strictly inside where not `inclusive`)."""

    field: str = ""
    lat: float = 0.0
    lon: float = 0.0
    radius_m: float = 0.0
    boost: float = 1.0
    inclusive: bool = True


@dataclass
class LGeoBox(LNode):
    """geo_bounding_box over a geo_point column (edges inclusive)."""

    field: str = ""
    top: float = 0.0
    left: float = 0.0
    bottom: float = 0.0
    right: float = 0.0
    boost: float = 1.0


@dataclass
class LGeoPolygon(LNode):
    """geo_polygon over a geo_point column: the ray-cast against the
    ring's vertices."""

    field: str = ""
    lats: Tuple[float, ...] = ()
    lons: Tuple[float, ...] = ()
    boost: float = 1.0


@dataclass
class LGeoShape(LNode):
    """geo_shape: a relation against a parsed `geo.Shape`, computed
    exactly on the host per segment (`geo_shape_mask`) and uploaded as
    a mask, as the reference does."""

    field: str = ""
    shape: Any = None
    relation: str = "intersects"
    boost: float = 1.0


@dataclass
class LNested(LNode):
    """Block-join to the parent: the child plan runs over the nested
    path's child segment, its scores reduce into the parents by the
    child -> parent map (sum, avg, max, min, none)."""

    path: str = ""
    child: Optional[LNode] = None
    child_ctx: Optional["ShardContext"] = None
    score_mode: str = "avg"
    boost: float = 1.0


@dataclass
class LHasChild(LNode):
    """Parents with matching children: the child plan's scores scattered
    into the shard's join slot space over every segment (`search/join.py`),
    then each segment's window sliced out."""

    join_field: str = ""
    child_rel: str = ""
    child: Optional[LNode] = None          # inner query AND join==child
    parent_filter: Optional[LNode] = None  # join==parent
    score_mode: str = "none"
    min_children: int = 1
    max_children: int = 2**31 - 1
    boost: float = 1.0
    join_index: Any = None
    pre: Any = None                        # the slot vectors, once


@dataclass
class LHasParent(LNode):
    """Children whose parent matches: the parent plan's match and scores
    at the parents' own slots, gathered through each child's slot."""

    join_field: str = ""
    parent_rel: str = ""
    child: Optional[LNode] = None          # inner query AND join==parent
    child_filter: Optional[LNode] = None   # join in the child relations
    use_score: bool = False
    boost: float = 1.0
    join_index: Any = None
    pre: Any = None


@dataclass
class LPercolate(LNode):
    """Stored queries matching candidate documents: a host mask per
    segment (`search/percolate.py`) the device plan reads."""

    field: str = ""
    mini_seg: Any = None
    mini_ctx: Any = None
    boost: float = 1.0
    _masks: dict = dc_field(default_factory=dict, repr=False, compare=False)


@dataclass
class LFuncScore(LNode):
    """function_score: the child's score combined with its functions'
    factors (each masked by its filter, in filter context)."""

    child: Optional[LNode] = None
    functions: List[dsl.ScoreFunction] = dc_field(default_factory=list)
    fn_filters: List[Optional[LNode]] = dc_field(default_factory=list)
    score_mode: str = "multiply"
    boost_mode: str = "multiply"
    min_score: Optional[float] = None
    boost: float = 1.0


@dataclass
class LScriptFilter(LNode):
    """`script` query: the docs where the script's value is nonzero. The
    AST is a hashable tuple; numeric params are f32 scalars."""

    ast: tuple = ()
    params: dict = dc_field(default_factory=dict)
    boost: float = 1.0


@dataclass
class LScriptScore(LNode):
    """`script_score` query: the script replaces the child's score;
    `_score` binds to the child's score vector."""

    child: Optional[LNode] = None
    ast: tuple = ()
    params: dict = dc_field(default_factory=dict)
    min_score: Optional[float] = None
    boost: float = 1.0


def _ip_cidr_node(field: str, mask: str, boost: float) -> LNode:
    """A CIDR as the exact i64 range of its mapped integers (the
    reference's `_ip_cidr_node`); a network past the i64 column (IPv6
    outside ::ffff:0:0/96, which no document holds) matches nothing."""
    try:
        net = ipaddress.ip_network(mask, strict=False)
    except ValueError as e:
        raise dsl.QueryParseError(f"invalid IP mask [{mask}]: {e}")
    lo = ip_to_int(str(net.network_address))
    hi = ip_to_int(str(net.broadcast_address))
    if lo >= 1 << 63:
        return LMatchNone()
    return LRange(field=field, kind="int", lo=lo, hi=min(hi, (1 << 63) - 1),
                  include_lo=True, include_hi=True, boost=boost)


def _numeric_eq_node(ft, value: Any, boost: float) -> LRange:
    cv = coerce_value(ft, value)
    return LRange(field=ft.name, kind=_range_kind(ft), lo=cv, hi=cv,
                  include_lo=True, include_hi=True, boost=boost)


def _range_kind(ft) -> str:
    return "float" if ft.type in FLOAT_TYPES else "int"


def _range_field_node(ft, q: dsl.RangeQuery) -> LNode:
    """A range query on a range field (the reference's
    `_range_field_node`): its bounds as the closed [a, b] an indexed
    value would be, against the `#lo` / `#hi` columns by relation --
    intersects: lo <= b and hi >= a; within: lo >= a and hi <= b;
    contains: lo <= a and hi >= b. Constant score."""
    kind = "float" if RANGE_MEMBER[ft.type] in ("float", "double") else "int"
    bounds = {k: v for k, v in (("gte", q.gte), ("gt", q.gt),
                                ("lte", q.lte), ("lt", q.lt))
              if v is not None}
    a, b = parse_range_value(ft, bounds)
    lo_f, hi_f = f"{ft.name}#lo", f"{ft.name}#hi"
    if q.relation == "within":
        parts = [LRange(field=lo_f, kind=kind, lo=a),
                 LRange(field=hi_f, kind=kind, hi=b)]
    elif q.relation == "contains":
        parts = [LRange(field=lo_f, kind=kind, hi=a),
                 LRange(field=hi_f, kind=kind, lo=b)]
    else:
        parts = [LRange(field=lo_f, kind=kind, hi=b),
                 LRange(field=hi_f, kind=kind, lo=a)]
    return LConstScore(child=LBool(filters=parts), boost=q.boost)


def rewrite(q: dsl.Query, ctx: ShardContext, scoring: bool = True) -> LNode:
    """DSL tree -> plan; a clause's `_name` goes onto its node."""
    out = _rewrite(q, ctx, scoring)
    out.name = q.name or out.name
    return out


def _field_boost(spec: str) -> Tuple[str, float]:
    """`field^boost` -> (field, boost)."""
    return (spec.split("^")[0],
            float(spec.split("^")[1]) if "^" in spec else 1.0)


def _rewrite(q: dsl.Query, ctx: ShardContext, scoring: bool) -> LNode:
    if isinstance(q, dsl.HybridQuery):
        raise dsl.QueryParseError(
            "[hybrid] must be the top-level query — sub-queries fuse at "
            "the coordinator merge and cannot nest inside other queries")
    if isinstance(q, dsl.MatchAllQuery):
        return LMatchAll(boost=q.boost)
    if isinstance(q, dsl.MatchNoneQuery):
        return LMatchNone()

    if isinstance(q, dsl.TermQuery):
        ft = ctx.mappings.resolve_field(q.field)
        if ft is not None and ft.type in RANGE_TYPES:
            # containment: the stored [lo, hi] covers the value
            member = RANGE_MEMBER[ft.type]
            cv = range_member_coerce(member, q.value, ft)
            kind = "float" if member in ("float", "double") else "int"
            return LConstScore(child=LBool(filters=[
                LRange(field=f"{ft.name}#lo", kind=kind, hi=cv),
                LRange(field=f"{ft.name}#hi", kind=kind, lo=cv)]),
                boost=q.boost)
        if (ft is not None and ft.type == "ip" and isinstance(q.value, str)
                and "/" in q.value):
            return _ip_cidr_node(ft.name, q.value, q.boost)
        if ft is not None and ft.type in NUMERIC_TYPES:
            return _numeric_eq_node(ft, q.value, q.boost)
        field = ft.name if ft else q.field
        term = _index_term(q.field, q.value, ctx)
        if q.case_insensitive:
            term = term.lower()
        mode = "score" if scoring else "filter"
        return _weighted_terms(field, [term], [1.0], ctx, 1, mode, q.boost)

    if isinstance(q, dsl.TermsQuery):
        ft = ctx.mappings.resolve_field(q.field)
        if ft is not None and ft.type == "ip" and any(
                isinstance(v, str) and "/" in v for v in q.values):
            # CIDR members expand to ranges; exact ips stay term matches
            return LBool(shoulds=[
                _ip_cidr_node(ft.name, v, 1.0)
                if isinstance(v, str) and "/" in v else
                _weighted_terms(ft.name, [_index_term(ft.name, v, ctx)],
                                [1.0], ctx, 1, "filter", 1.0)
                for v in q.values], msm=1, boost=q.boost)
        if ft is not None and ft.type in NUMERIC_TYPES:
            return LBool(shoulds=[_numeric_eq_node(ft, v, 1.0)
                                  for v in q.values], msm=1, boost=q.boost)
        field = ft.name if ft else q.field
        terms = [_index_term(q.field, v, ctx) for v in q.values]
        # terms query is constant-score (reference TermInSetQuery)
        return _weighted_terms(field, terms, [1.0] * len(terms), ctx, 1,
                               "filter", q.boost)

    if isinstance(q, dsl.MatchQuery):
        ft = ctx.mappings.resolve_field(q.field)
        if ft is not None and ft.type in NUMERIC_TYPES - {"date"}:
            return _numeric_eq_node(ft, q.query, q.boost)
        field = ft.name if ft else q.field
        terms = _analyze_query_text(field, q.query, ctx, q.analyzer)
        if not terms:
            return LMatchNone()
        if q.fuzziness is not None:
            # one constant-score expansion per term (the reference's)
            expanded: List[LNode] = [
                LExpandTerms(field=field,
                             expander=_fuzzy_expander(field, t, q.fuzziness,
                                                      0, ctx.device),
                             boost=q.boost) for t in terms]
            msm = len(expanded) if q.operator == "and" else \
                dsl.parse_minimum_should_match(q.minimum_should_match,
                                               len(expanded)) or 1
            return LBool(shoulds=expanded, msm=msm, boost=1.0)
        msm = len(terms) if q.operator == "and" else \
            dsl.parse_minimum_should_match(q.minimum_should_match,
                                           len(terms)) or 1
        # a match keeps score mode in filter context: its scores drive the
        # msm count
        return _weighted_terms(field, terms, [1.0] * len(terms), ctx, msm,
                               "score", q.boost)

    if isinstance(q, dsl.MatchBoolPrefixQuery):
        ft = ctx.mappings.resolve_field(q.field)
        field = ft.name if ft else q.field
        terms = _analyze_query_text(field, q.query, ctx, q.analyzer)
        if not terms:
            return LMatchNone()
        children: List[LNode] = [
            _weighted_terms(field, [t], [1.0], ctx, 1, "score", q.boost)
            for t in terms[:-1]]
        children.append(LExpandTerms(
            field=field, expander=_prefix_expander(field, terms[-1], False,
                                                   cap=50),
            boost=q.boost))
        msm = len(children) if q.operator == "and" else 1
        return LBool(shoulds=children, msm=msm, boost=1.0)

    if isinstance(q, dsl.MatchPhraseQuery):
        ft = ctx.mappings.resolve_field(q.field)
        field = ft.name if ft else q.field
        terms = _analyze_query_text(field, q.query, ctx, q.analyzer)
        if not terms:
            return LMatchNone()
        if len(terms) == 1 and not q.prefix:
            # Lucene rewrites a single-term phrase to a term query
            return _weighted_terms(field, terms, [1.0], ctx, 1, "score",
                                   q.boost)
        if len(terms) == 1:
            return LExpandTerms(field=field,
                                expander=_prefix_expander(
                                    field, terms[0], False,
                                    cap=q.max_expansions),
                                boost=q.boost)
        return _phrase_node(field, terms, q.slop, ctx, q.boost,
                            prefix_last=q.prefix,
                            max_expansions=q.max_expansions)

    if isinstance(q, dsl.SpanTermQuery):
        term = _index_term(q.field, q.value, ctx)
        return _weighted_terms(q.field, [term], [1.0], ctx, 1, "score",
                               q.boost)

    if isinstance(q, dsl.SpanNearQuery):
        for c in q.clauses:
            if not isinstance(c, (dsl.SpanTermQuery, dsl.SpanNearQuery)):
                raise dsl.QueryParseError(
                    f"[{type(c).__name__}] is not a span query")
        if not all(isinstance(c, dsl.SpanTermQuery) for c in q.clauses):
            raise NotPortedError("span_near over span queries other than "
                                 "span_term (the host span engine)")
        if len({c.field for c in q.clauses}) > 1:
            raise dsl.QueryParseError("[span_near] clauses must share a "
                                      "field")
        if not q.clauses:
            return LMatchNone()
        field = q.clauses[0].field
        terms = [_index_term(c.field, c.value, ctx) for c in q.clauses]
        if len(terms) == 1:
            return _weighted_terms(field, terms, [1.0], ctx, 1, "score",
                                   q.boost)
        # span slop counts the gaps, not the moves
        return _phrase_node(field, terms, q.slop, ctx, q.boost,
                            ordered=q.in_order, gap_cost=True)

    if isinstance(q, dsl.IntervalsQuery):
        r = q.rule
        if r.kind != "match":
            raise NotPortedError(f"intervals rule [{r.kind}] (the host "
                                 f"span engine)")
        if r.filter_kind is not None:
            raise NotPortedError(f"intervals [filter] [{r.filter_kind}] "
                                 f"(the host span engine)")
        ft = ctx.mappings.resolve_field(q.field)
        field = ft.name if ft else q.field
        terms = _analyze_query_text(field, r.query, ctx, r.analyzer)
        if not terms:
            return LMatchNone()
        if len(terms) == 1:
            return _weighted_terms(field, terms, [1.0], ctx, 1, "score",
                                   q.boost)
        # max_gaps -1 is unbounded: a window no span reaches
        slop = r.max_gaps if r.max_gaps >= 0 else 1 << 20
        return _phrase_node(field, terms, slop, ctx, q.boost,
                            ordered=r.ordered, gap_cost=True)

    if isinstance(q, dsl.BoolQuery):
        musts = [rewrite(c, ctx, scoring) for c in q.must]
        shoulds = [rewrite(c, ctx, scoring) for c in q.should]
        must_nots = [rewrite(c, ctx, False) for c in q.must_not]
        filters = [rewrite(c, ctx, False) for c in q.filter]
        n_should = len(shoulds)
        if q.minimum_should_match is not None:
            msm = dsl.parse_minimum_should_match(q.minimum_should_match,
                                                 n_should)
        else:
            msm = 1 if (n_should and not musts and not filters) else 0
        return LBool(musts=musts, shoulds=shoulds, must_nots=must_nots,
                     filters=filters, msm=msm, boost=q.boost)

    if isinstance(q, dsl.RangeQuery):
        ft = ctx.mappings.resolve_field(q.field)
        if ft is None:
            return LMatchNone()
        if ft.type in RANGE_TYPES:
            return _range_field_node(ft, q)
        if ft.type in KEYWORD_TYPES and ft.type != "ip":
            return LExpandTerms(field=ft.name,
                                expander=_keyword_range_expander(ft.name, q),
                                boost=q.boost)
        # any other type goes the numeric way: a bound on a text field
        # raises the reference's ValueError in `coerce_value`
        lo = hi = None
        inc_lo = inc_hi = True
        if q.gte is not None:
            lo, inc_lo = coerce_value(ft, q.gte), True
        if q.gt is not None:
            lo, inc_lo = coerce_value(ft, q.gt), False
        if q.lte is not None:
            hi, inc_hi = coerce_value(ft, q.lte), True
        if q.lt is not None:
            hi, inc_hi = coerce_value(ft, q.lt), False
        return LRange(field=ft.name, kind=_range_kind(ft), lo=lo, hi=hi,
                      include_lo=inc_lo, include_hi=inc_hi, boost=q.boost)

    if isinstance(q, dsl.ExistsQuery):
        ft = ctx.mappings.resolve_field(q.field)
        if ft is not None and ft.type in RANGE_TYPES:
            return LExists(field=f"{ft.name}#lo", boost=q.boost)
        if ft is not None and ft.flat_prefix:
            # a flat_object leaf exists where any "path=..." term does
            return LExpandTerms(
                field=ft.name,
                expander=_prefix_expander(ft.name, f"{ft.flat_prefix}=",
                                          False),
                boost=q.boost)
        return LExists(field=ft.name if ft else q.field, boost=q.boost)

    if isinstance(q, dsl.GeoDistanceQuery):
        return LGeoDist(field=q.field, lat=q.lat, lon=q.lon,
                        radius_m=q.distance_m, boost=q.boost,
                        inclusive=q.inclusive)
    if isinstance(q, dsl.GeoBoundingBoxQuery):
        return LGeoBox(field=q.field, top=q.top, left=q.left,
                       bottom=q.bottom, right=q.right, boost=q.boost)
    if isinstance(q, dsl.GeoPolygonQuery):
        return LGeoPolygon(field=q.field, lats=tuple(q.lats),
                           lons=tuple(q.lons), boost=q.boost)
    if isinstance(q, dsl.GeoShapeQuery):
        return _geo_shape_node(q, ctx)

    if isinstance(q, dsl.IdsQuery):
        return LIds(ids=list(q.values), boost=q.boost)

    if isinstance(q, dsl.ConstantScoreQuery):
        return LConstScore(child=rewrite(q.filter, ctx, False), boost=q.boost)

    if isinstance(q, dsl.BoostingQuery):
        return LBoosting(positive=rewrite(q.positive, ctx, scoring),
                         negative=rewrite(q.negative, ctx, False),
                         negative_boost=q.negative_boost, boost=q.boost)

    if isinstance(q, dsl.DisMaxQuery):
        return LDisMax(children=[rewrite(c, ctx, scoring) for c in q.queries],
                       tie_breaker=q.tie_breaker, boost=q.boost)

    if isinstance(q, dsl.MultiMatchQuery):
        # one child per field (`field^boost`); best_fields and the phrase
        # types take the best field, every other type (most_fields,
        # cross_fields, bool_prefix) sums the fields, as the reference does
        if q.type in ("phrase", "phrase_prefix"):
            children = [rewrite(dsl.MatchPhraseQuery(
                field=f, query=q.query, prefix=q.type == "phrase_prefix",
                boost=b), ctx, scoring)
                for f, b in map(_field_boost, q.fields)]
        else:
            children = [rewrite(dsl.MatchQuery(
                field=f, query=q.query, operator=q.operator,
                minimum_should_match=q.minimum_should_match, boost=b),
                ctx, scoring) for f, b in map(_field_boost, q.fields)]
        if q.type in ("best_fields", "phrase", "phrase_prefix"):
            return LDisMax(children=children, tie_breaker=q.tie_breaker,
                           boost=q.boost)
        return LBool(shoulds=children, msm=1, boost=q.boost)

    if isinstance(q, dsl.TermsSetQuery):
        ft = ctx.mappings.resolve_field(q.field)
        field = ft.name if ft else q.field
        terms = [str(t) for t in q.terms]
        if not terms:
            return LMatchNone()
        child = _weighted_terms(field, terms, [1.0] * len(terms), ctx, 0,
                                "score", q.boost)
        script = None
        if q.minimum_should_match_script is not None:
            src, prm = dsl.parse_script_spec(q.minimum_should_match_script)
            try:
                pl.parse(src)
            except pl.ScriptError as e:
                raise dsl.QueryParseError(f"[terms_set] bad script: {e}")
            script = (src, prm or {})
        return LTermsSet(field=field, child=child,
                         msm_field=q.minimum_should_match_field,
                         script=script, num_terms=len(terms))

    if isinstance(q, dsl.CombinedFieldsQuery):
        return _combined_node(q, ctx)

    if isinstance(q, dsl.PinnedQuery):
        return LPinned(ids=tuple(q.ids),
                       organic=(rewrite(q.organic, ctx, scoring)
                                if q.organic else None), boost=q.boost)

    if isinstance(q, dsl.PrefixQuery):
        return LExpandTerms(field=q.field,
                            expander=_prefix_expander(q.field, q.value,
                                                      q.case_insensitive),
                            boost=q.boost)
    if isinstance(q, dsl.WildcardQuery):
        return LExpandTerms(field=q.field,
                            expander=_wildcard_expander(q.field, q.value,
                                                        q.case_insensitive),
                            boost=q.boost)
    if isinstance(q, dsl.RegexpQuery):
        return LExpandTerms(field=q.field,
                            expander=_regexp_expander(q.field, q.value,
                                                      ctx.device),
                            boost=q.boost)
    if isinstance(q, dsl.FuzzyQuery):
        return LExpandTerms(field=q.field,
                            expander=_fuzzy_expander(q.field, q.value,
                                                     q.fuzziness,
                                                     q.prefix_length,
                                                     ctx.device),
                            boost=q.boost)

    if isinstance(q, dsl.KnnQuery):
        ft = ctx.mappings.resolve_field(q.field)
        sim = ft.vector_similarity if ft is not None else "cosine"
        vec = np.asarray(q.vector, np.float32)
        if sim == "cosine":
            vec = vec / max(float(np.linalg.norm(vec)), 1e-12)
        return LKnn(field=q.field, vector=vec, k=q.k,
                    filter=rewrite(q.filter, ctx, False) if q.filter
                    else None,
                    similarity=sim, boost=q.boost, nprobe=q.nprobe,
                    exact=q.exact)

    if isinstance(q, dsl.RankFeatureQuery):
        return _rewrite_rank_feature(q, ctx)

    if isinstance(q, dsl.NeuralSparseQuery):
        ft = ctx.mappings.resolve_field(q.field)
        if ft is None or ft.type not in FEATURE_TYPES:
            raise dsl.QueryParseError(
                f"[neural_sparse] field [{q.field}] is not a rank_features/"
                f"sparse_vector field")
        toks = sorted(q.tokens)
        return LSparseDot(field=ft.name, tokens=toks,
                          weights=np.asarray([q.tokens[t] for t in toks],
                                             np.float32),
                          boost=q.boost)

    if isinstance(q, dsl.DistanceFeatureQuery):
        ft = ctx.mappings.resolve_field(q.field)
        if ft is None:
            raise dsl.QueryParseError(
                f"[distance_feature] unknown field [{q.field}]")
        if ft.type == "date":
            return LDistanceFeature(
                field=ft.name, origin=_parse_date(q.origin, ft.date_format),
                pivot=float(parse_interval_ms(q.pivot)), boost=q.boost)
        if ft.type == "geo_point":
            return LDistanceFeature(
                field=ft.name, kind="geo", origin=parse_geo(q.origin),
                pivot=dsl.parse_distance(q.pivot), boost=q.boost)
        raise dsl.QueryParseError(
            f"[distance_feature] field [{q.field}] must be a date or "
            f"geo_point field")

    if isinstance(q, (dsl.QueryStringQuery, dsl.SimpleQueryStringQuery)):
        return _rewrite_query_string(q, ctx, scoring)

    if isinstance(q, dsl.ScriptQuery):
        try:
            ast = pl.validate_device_script(q.source)
        except pl.ScriptError as e:
            raise dsl.QueryParseError(f"[script] compile error: {e}")
        return LScriptFilter(ast=ast, params=q.params or {}, boost=q.boost)

    if isinstance(q, dsl.ScriptScoreQuery):
        try:
            ast = pl.validate_device_script(q.source)
        except pl.ScriptError as e:
            raise dsl.QueryParseError(f"[script_score] compile error: {e}")
        return LScriptScore(child=rewrite(q.query or dsl.MatchAllQuery(),
                                          ctx, scoring),
                            ast=ast, params=q.params or {},
                            min_score=q.min_score, boost=q.boost)

    if isinstance(q, dsl.FunctionScoreQuery):
        child = rewrite(q.query or dsl.MatchAllQuery(), ctx, scoring)
        fn_filters = [rewrite(f.filter, ctx, False) if f.filter else None
                      for f in q.functions]
        for f in q.functions:
            if f.kind == "script_score":
                try:
                    pl.validate_device_script(f.script or "")
                except pl.ScriptError as e:
                    raise dsl.QueryParseError(
                        f"[script_score] compile error: {e}")
        return LFuncScore(child=child, functions=q.functions,
                          fn_filters=fn_filters, score_mode=q.score_mode,
                          boost_mode=q.boost_mode, min_score=q.min_score,
                          boost=q.boost)

    if isinstance(q, dsl.MoreLikeThisQuery):
        return _rewrite_mlt(q, ctx, scoring)

    if isinstance(q, dsl.NestedQuery):
        return _rewrite_nested(q, ctx, scoring)

    if isinstance(q, (dsl.HasChildQuery, dsl.HasParentQuery,
                      dsl.ParentIdQuery)):
        return _rewrite_join(q, ctx, scoring)

    if isinstance(q, dsl.PercolateQuery):
        from .percolate import build_mini
        ft = ctx.mappings.resolve_field(q.field)
        if ft is None or ft.type != "percolator":
            raise dsl.QueryParseError(
                f"[percolate] field [{q.field}] is not a percolator field")
        if not q.documents:
            raise dsl.QueryParseError(
                "[percolate] document reference was not resolved "
                "(use the REST layer, or inline `document`)")
        try:
            mini_seg, mini_ctx = build_mini(ctx.mappings, q.documents,
                                            ctx.device)
        except ValueError as e:
            raise dsl.QueryParseError(
                f"[percolate] cannot parse document: {e}")
        return LPercolate(field=ft.name, mini_seg=mini_seg,
                          mini_ctx=mini_ctx, boost=q.boost)

    raise NotPortedError(f"query [{type(q).__name__}]")


def _rewrite_nested(q: dsl.NestedQuery, ctx: ShardContext,
                    scoring: bool) -> LNode:
    """`nested`: an unmapped path is the reference's 400 (match_none
    with `ignore_unmapped`); a deeper path asked from an outer level
    goes through the chain of enclosing nested paths whose blocks the
    segments hold; the child plan is rewritten with the child space's
    statistics (`nested_context`)."""
    m = ctx.mappings
    if q.path not in m.nested_paths:
        if q.ignore_unmapped:
            return LMatchNone()
        raise dsl.QueryParseError(
            f"[nested] failed to find nested object under path [{q.path}]")
    if not any(q.path in s.nested for s in ctx.segments):
        parts = q.path.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            pfx = ".".join(parts[:cut])
            if pfx in m.nested_paths and any(pfx in s.nested
                                             for s in ctx.segments):
                inner_q = dsl.NestedQuery(path=q.path, query=q.query,
                                          score_mode=q.score_mode,
                                          ignore_unmapped=q.ignore_unmapped)
                outer = dsl.NestedQuery(path=pfx, query=inner_q,
                                        score_mode=q.score_mode,
                                        boost=q.boost)
                return _rewrite(outer, ctx, scoring)
    child_ctx = nested_context(ctx, q.path)
    return LNested(path=q.path, child=rewrite(q.query, child_ctx, scoring),
                   child_ctx=child_ctx, score_mode=q.score_mode,
                   boost=q.boost)


def nested_context(ctx: ShardContext, path: str) -> ShardContext:
    """The child space's statistics context: BM25 idf and avgdl over the
    nested path's child docs, as Lucene's over its child docs."""
    return ShardContext(ctx.mappings,
                        [s.nested[path].child for s in ctx.segments
                         if path in s.nested],
                        similarity=ctx.default_sim, device=ctx.device)


def _rewrite_mlt(q: dsl.MoreLikeThisQuery, ctx: ShardContext,
                 scoring: bool) -> LNode:
    """more_like_this (Lucene MoreLikeThis, the reference's rewrite): the
    like items' term frequencies (a text, an `_id`'s live `_source` or a
    `doc`), less the unlike items' terms, the stop words, terms under
    `min_term_freq`, outside the word lengths or the doc frequencies;
    ranked by tf x idf, the best `max_query_terms` searched as one
    weighted term group (one field; `boost_terms` scales each term's
    boost by its score over the best) or a bool of single-term groups
    (several fields), `minimum_should_match` over the selected terms.
    A liked `_id` is excluded unless `include`."""
    fields = list(q.fields) or [name for name, ft in ctx.mappings.fields.items()
                                if ft.type == "text"]
    if not fields:
        return LMatchNone()
    stop = set(q.stop_words)

    def texts_of(item, liked_ids):
        if isinstance(item, str):
            return {f: [item] for f in fields}
        if not isinstance(item, dict):
            raise dsl.QueryParseError("[more_like_this] invalid like item")
        if "doc" in item:
            src = item["doc"]
        else:
            did = item.get("_id")
            if did is None:
                raise dsl.QueryParseError(
                    "[more_like_this] like item needs text, [_id] or [doc]")
            liked_ids.append(str(did))
            src = None
            for seg in ctx.segments:
                d = seg.local_doc(str(did))
                if d >= 0 and seg.live[d]:
                    src = seg.sources[d]
                    break
            if src is None:
                return {}
        out = {}
        for f in fields:
            v = src.get(f)
            if isinstance(v, str):
                out[f] = [v]
            elif isinstance(v, list):
                out[f] = [str(x) for x in v]
        return out

    liked_ids: List[str] = []
    tf_counts: dict = {}
    for item in q.like:
        for f, texts in texts_of(item, liked_ids).items():
            for text in texts:
                for t in _analyze_query_text(f, text, ctx):
                    tf_counts[(f, t)] = tf_counts.get((f, t), 0) + 1
    skip: set = set()
    for item in q.unlike:
        for f, texts in texts_of(item, []).items():
            for text in texts:
                skip.update((f, t) for t in _analyze_query_text(f, text, ctx))
    n = max(ctx.num_docs, 1)
    scored = []
    for (f, t), tf in tf_counts.items():
        if (f, t) in skip or t in stop or tf < q.min_term_freq:
            continue
        if len(t) < q.min_word_length or (
                q.max_word_length and len(t) > q.max_word_length):
            continue
        df = ctx.doc_freq(f, t)
        if df < q.min_doc_freq or df > q.max_doc_freq or df <= 0:
            continue
        scored.append((tf * ops.bm25_idf(n, df), f, t))
    scored.sort(key=lambda x: (-x[0], x[1], x[2]))
    scored = scored[:q.max_query_terms]
    if not scored:
        return LMatchNone()
    best = scored[0][0]
    by_field: dict = {}
    for sc, f, t in scored:
        boost = (q.boost_terms * sc / best) if q.boost_terms > 0 else 1.0
        by_field.setdefault(f, []).append((t, boost))
    msm = max(dsl.parse_minimum_should_match(q.minimum_should_match,
                                             len(scored)), 1)
    mode = "score" if scoring else "filter"
    if len(by_field) == 1:
        ((f, pairs),) = by_field.items()
        node: LNode = _weighted_terms(f, [t for t, _ in pairs],
                                      [b for _, b in pairs], ctx, msm, mode,
                                      q.boost)
    else:
        # one single-term group a clause: msm counts terms across fields
        node = LBool(shoulds=[_weighted_terms(f, [t], [b], ctx, 1, mode, 1.0)
                              for f, pairs in by_field.items()
                              for t, b in pairs],
                     msm=msm, boost=q.boost)
    if liked_ids and not q.include:
        return LBool(musts=[node], must_nots=[LIds(ids=liked_ids)])
    return node


def _rewrite_join(q, ctx: ShardContext, scoring: bool) -> LNode:
    """has_child, has_parent and parent_id over the index's join field:
    an unknown relation (or no join field) is the reference's 400, or
    match_none with `ignore_unmapped`; parent_id is a constant-score
    filter on `<join>#parent` and the child relation."""
    from .join import get_join_index

    m = ctx.mappings
    jf = m.join_field
    kind = {dsl.HasChildQuery: "has_child", dsl.HasParentQuery: "has_parent",
            dsl.ParentIdQuery: "parent_id"}[type(q)]
    relations = m.fields[jf].relations if jf else {}
    child_rels_all = {c for cs in relations.values() for c in cs}

    def unmapped(msg: str) -> LNode:
        if q.ignore_unmapped:
            return LMatchNone()
        raise dsl.QueryParseError(f"[{kind}] {msg}")

    def rel_filter(field: str, rels: List[str]) -> LTerms:
        return _weighted_terms(field, rels, [1.0] * len(rels), ctx, 1,
                               "filter", 1.0)

    if jf is None:
        return unmapped("no [join] field is mapped on this index")
    if kind == "parent_id":
        if q.type not in child_rels_all:
            return unmapped(f"[{q.type}] is not a child relation")
        return LConstScore(child=LBool(filters=[
            rel_filter(f"{jf}#parent", [q.id]), rel_filter(jf, [q.type])]),
            boost=q.boost)
    ji = get_join_index(ctx.segments, jf)
    if kind == "has_child":
        parent_rel = next((p for p, cs in relations.items()
                           if q.type in cs), None)
        if parent_rel is None:
            return unmapped(
                f"[{q.type}] is not a child relation of the join field")
        inner = rewrite(q.query or dsl.MatchAllQuery(), ctx, scoring)
        return LHasChild(join_field=jf, child_rel=q.type,
                         child=LBool(musts=[inner],
                                     filters=[rel_filter(jf, [q.type])]),
                         parent_filter=rel_filter(jf, [parent_rel]),
                         score_mode=q.score_mode,
                         min_children=q.min_children,
                         max_children=q.max_children, boost=q.boost,
                         join_index=ji)
    if q.parent_type not in relations:
        return unmapped(f"[{q.parent_type}] is not a parent relation")
    inner = rewrite(q.query or dsl.MatchAllQuery(), ctx, scoring)
    return LHasParent(join_field=jf, parent_rel=q.parent_type,
                      child=LBool(musts=[inner],
                                  filters=[rel_filter(jf, [q.parent_type])]),
                      child_filter=rel_filter(
                          jf, sorted(relations[q.parent_type])),
                      use_score=q.score, boost=q.boost, join_index=ji)


def _geo_shape_node(q: dsl.GeoShapeQuery, ctx: ShardContext) -> LNode:
    """geo_shape on a geo_shape or geo_point field: its shape parsed (a
    malformed one is the reference's 400); an unmapped field matches
    nothing under `ignore_unmapped`, else is a 400."""
    from .geo import ShapeParseError, parse_shape
    ft = ctx.mappings.resolve_field(q.field)
    if ft is None:
        if q.ignore_unmapped:
            return LMatchNone()
        raise dsl.QueryParseError(
            f"[geo_shape] failed to find geo field [{q.field}]")
    if ft.type not in ("geo_shape", "geo_point"):
        raise dsl.QueryParseError(
            f"[geo_shape] field [{q.field}] is of type [{ft.type}], "
            f"not geo_shape/geo_point")
    try:
        shape = parse_shape(q.shape)
    except ShapeParseError as e:
        raise dsl.QueryParseError(f"[geo_shape] {e}")
    return LGeoShape(field=q.field, shape=shape, relation=q.relation,
                     boost=q.boost)


def _rewrite_query_string(q, ctx: ShardContext, scoring: bool) -> LNode:
    """query_string / simple_query_string: the string's DSL tree
    (`search/querystring.py`) through this rewrite, so a string serves
    the plan of the JSON DSL it stands for. `*` (or no field) reads every
    text field in mapping order."""
    from . import querystring as qsmod
    default_fields = q.fields or ([q.default_field]
                                  if getattr(q, "default_field", None)
                                  else ["*"])
    if list(default_fields) == ["*"]:
        default_fields = [f for f, ft in ctx.mappings.fields.items()
                          if ft.type in TEXT_TYPES]
        if not default_fields:
            default_fields = list(ctx.mappings.fields)[:1] or ["_all"]
    if isinstance(q, dsl.SimpleQueryStringQuery):
        tree = qsmod.parse_simple_query_string(q.query, list(default_fields),
                                               q.default_operator)
    else:
        tree = qsmod.parse_query_string(
            q.query, list(default_fields), q.default_operator,
            phrase_slop=int(getattr(q, "phrase_slop", 0) or 0))
    tree.boost = tree.boost * q.boost
    return rewrite(tree, ctx, scoring)


def _rewrite_rank_feature(q: dsl.RankFeatureQuery,
                          ctx: ShardContext) -> LNode:
    """A rank_feature column, or `field.feature` read as the feature of
    the longest mapped prefix of a feature field; the function's
    parameters (the default saturation pivot from `_default_pivot`)."""
    m = ctx.mappings
    ft = m.resolve_field(q.field)
    if ft is not None and ft.type == "rank_feature":
        field, feature, positive = ft.name, None, ft.positive_score_impact
    else:
        parts = q.field.split(".")
        field = feature = None
        for cut in range(len(parts) - 1, 0, -1):
            pft = m.resolve_field(".".join(parts[:cut]))
            if pft is not None and pft.type in FEATURE_TYPES:
                field, feature = pft.name, ".".join(parts[cut:])
                positive = pft.positive_score_impact
                break
        if field is None:
            raise dsl.QueryParseError(
                f"[rank_feature] field [{q.field}] is not a rank_feature or "
                f"rank_features feature")
    fn, p1, p2 = q.function, 1.0, 1.0
    if not positive and fn in ("log", "linear"):
        raise dsl.QueryParseError(
            f"[rank_feature] [{fn}] is incompatible with "
            f"positive_score_impact=false fields")
    if fn == "saturation":
        p1 = (q.pivot if q.pivot is not None
              else _default_pivot(ctx, field, feature))
    elif fn == "log":
        p1 = float(q.scaling_factor)
    elif fn == "sigmoid":
        p1, p2 = float(q.pivot), float(q.exponent)
    return LRankFeature(field=field, feature=feature, fn=fn, p1=float(p1),
                        p2=float(p2), positive=positive, boost=q.boost)


def _default_pivot(ctx: ShardContext, field: str,
                   feature: Optional[str]) -> float:
    """The default saturation pivot as the reference computes it: the
    arithmetic mean of the feature's values over every segment, deleted
    docs included (OpenSearch reads an approximate geometric mean from
    the index statistics)."""
    total, count = 0.0, 0
    for s in ctx.segments:
        if feature is None:
            col = s.numeric_cols.get(field)
            if col is not None and col.present.any():
                total += float(col.values[col.present].sum())
                count += int(col.present.sum())
        else:
            pb = s.postings.get(field)
            if pb is not None:
                r = pb.row(feature)
                if r >= 0:
                    a, b = pb.row_slice(r)
                    total += float(pb.tfs[a:b].sum())
                    count += b - a
    return (total / count) if count else 1.0


def can_match(node: LNode, seg: Segment) -> bool:
    """Segment pre-filter (reference CanMatchPreFilterSearchPhase): False
    only when the segment provably holds no hit of `node`."""
    if isinstance(node, LTerms):
        pb = seg.postings.get(node.field)
        if pb is None:
            return False
        if node.msm >= len(node.terms):
            return all(pb.row(t) >= 0 for t in node.terms)
        return any(pb.row(t) >= 0 for t in node.terms)
    if isinstance(node, LPhrase):
        pb = seg.postings.get(node.field)
        if pb is None or pb.pos_starts is None:
            return False
        return all(_phrase_rows(node, pb, i)
                   for i in range(len(node.terms)))
    if isinstance(node, LRange):
        col = seg.numeric_cols.get(node.field)
        if col is None:
            return False
        mn, mx = col.min_max
        if node.lo is not None and float(node.lo) > mx:
            return False
        if node.hi is not None and float(node.hi) < mn:
            return False
        return True
    if isinstance(node, LBool):
        for c in node.musts + node.filters:
            if not can_match(c, seg):
                return False
        if node.shoulds and not node.musts and not node.filters:
            return any(can_match(c, seg) for c in node.shoulds)
        return True
    if isinstance(node, LConstScore):
        return can_match(node.child, seg)
    if isinstance(node, LMatchNone):
        return False
    if isinstance(node, LExists):
        f = node.field
        return (f in seg.postings or f in seg.numeric_cols
                or f in seg.keyword_cols or f in seg.geo_cols
                or f in seg.vector_cols or f in seg.shape_cols
                or f in seg.doc_lens)
    if isinstance(node, (LGeoDist, LGeoBox, LGeoPolygon)):
        return node.field in seg.geo_cols
    if isinstance(node, LGeoShape):
        return node.field in seg.shape_cols or node.field in seg.geo_cols
    if isinstance(node, LIds):
        return any(seg.local_doc(i) >= 0 for i in node.ids)
    if isinstance(node, LSourcePhrase):
        pb = seg.postings.get(node.field)
        return pb is not None and all(pb.row(t) >= 0 for t in node.terms)
    if isinstance(node, LKnn):
        return node.field in seg.vector_cols
    if isinstance(node, (LRankFeature, LSparseDot)):
        # a feature field's CSR lives in postings, a rank_feature column
        # in the numeric columns
        return node.field in seg.postings or node.field in seg.numeric_cols
    if isinstance(node, LFuncScore):
        return node.child is None or can_match(node.child, seg)
    if isinstance(node, LNested):
        blk = seg.nested.get(node.path)
        return (blk is not None and blk.child.ndocs > 0
                and can_match(node.child, blk.child))
    if isinstance(node, LPercolate):
        return (f"{node.field}#terms" in seg.keyword_cols
                or f"{node.field}#flags" in seg.keyword_cols)
    if isinstance(node, LHasChild):
        # the slot pre-pass spans every segment; this one holds parents
        return can_match(node.parent_filter, seg)
    if isinstance(node, LHasParent):
        return can_match(node.child_filter, seg)
    return True


def _combined_node(q: dsl.CombinedFieldsQuery, ctx: ShardContext) -> LNode:
    """The terms analyzed by the first field's analyzer, msm, and each
    term's idf from the union df, computed once here in f64 and stored
    as f32 (the reference's rewrite). Segments have disjoint doc spaces:
    the union is taken within each segment and the sizes summed."""
    fspecs = []
    for f in q.fields:
        name, w = f.rsplit("^", 1) if "^" in f else (f, "1")
        ft = ctx.mappings.resolve_field(name)
        try:
            wf = float(w)
        except ValueError:
            raise dsl.QueryParseError(
                f"[combined_fields] bad field boost [{f}]")
        fspecs.append((ft.name if ft else name, wf))
    terms = _analyze_query_text(fspecs[0][0], q.query, ctx, None)
    if not terms:
        return LMatchNone()
    msm = len(terms) if q.operator == "and" else \
        dsl.parse_minimum_should_match(q.minimum_should_match,
                                       len(terms)) or 1
    n = max(ctx.num_docs, 1)
    idf = np.zeros(len(terms), np.float32)
    for i, t in enumerate(terms):
        df = 0
        for seg in ctx.segments:
            lists = []
            for fname, _w in fspecs:
                pb = seg.postings.get(fname)
                r = pb.row(t) if pb is not None else -1
                if r >= 0:
                    a, b = pb.row_slice(r)
                    lists.append(pb.doc_ids[a:b])
            if len(lists) == 1:
                df += len(lists[0])
            elif lists:
                df += len(np.unique(np.concatenate(lists)))
        if df > 0:
            idf[i] = q.boost * float(
                np.log(1.0 + (n - df + 0.5) / (df + 0.5)))
    return LCombined(fields=tuple(fspecs), terms=tuple(terms), msm=msm,
                     idf=idf)


def _weighted_terms(field: str, terms: List[str], boosts: List[float],
                    ctx: ShardContext, msm: int, mode: str,
                    boost: float) -> LTerms:
    ft = ctx.mappings.resolve_field(field)
    sim = ctx.sim_for(field)
    has_norms = bool(ft is not None and ft.has_norms and sim.uses_norms)
    n = ctx.num_docs
    weights = np.zeros(len(terms), dtype=np.float32)
    for i, t in enumerate(terms):
        df = ctx.doc_freq(field, t)
        weights[i] = (sim.term_weight(boosts[i] * boost, n, max(df, 0))
                      if df > 0 else 0.0)
    return LTerms(field=field, terms=terms, weights=weights, msm=msm,
                  mode=mode, sim=sim, has_norms=has_norms, boost=boost)


def _prefix_rows(pb, term: str, cap: Optional[int] = None) -> range:
    """Vocab rows whose terms start with `term`, at most `cap` of them
    (Lucene's maxExpansions)."""
    lo = bisect_left(pb.vocab, term)
    hi = bisect_left(pb.vocab, term + "\uffff")
    if cap is not None:
        hi = min(hi, lo + cap)
    return range(lo, hi)


# ---------------------------------------------------------------------
# multi-term expanders: a segment's dictionary rows (the reference's
# host expanders; the regexp DFA and the fuzzy edit distance as torch
# ops over the dictionary's codepoint matrix)
# ---------------------------------------------------------------------

def _prefix_expander(field: str, prefix: str, ci: bool,
                     cap: Optional[int] = None):
    def expand(seg: Segment) -> np.ndarray:
        pb = seg.postings.get(field)
        if pb is None:
            return np.empty(0, np.int32)
        if ci:
            low = prefix.lower()
            rows = [i for i, t in enumerate(pb.vocab)
                    if t.lower().startswith(low)]
            return np.asarray(rows[:cap] if cap is not None else rows,
                              np.int32)
        r = _prefix_rows(pb, prefix, cap)
        return np.arange(r.start, r.stop, dtype=np.int32)
    return expand


def _wildcard_expander(field: str, pattern: str, ci: bool):
    """`fnmatch` over the dictionary, as the reference has it: `[...]` is
    a character class there (Lucene reads `[` literally)."""
    def expand(seg: Segment) -> np.ndarray:
        pb = seg.postings.get(field)
        if pb is None:
            return np.empty(0, np.int32)
        pat = pattern.lower() if ci else pattern
        rows = [i for i, t in enumerate(pb.vocab)
                if fnmatch.fnmatchcase(t.lower() if ci else t, pat)]
        return np.asarray(rows, np.int32)
    return expand


def vocab_matrix_on(seg: Segment, field: str, device) -> tuple:
    """The codepoint matrix of `field`'s dictionary on `device`
    (`regexp.vocab_matrix`), cached per segment and field with the
    general path's device arrays: a merge drops it with the segment."""
    pb = seg.postings[field]
    return seg.device_cached(("vocab_cp", field), device,
                             lambda: rx.vocab_matrix(pb.vocab, device))


def _regexp_expander(field: str, pattern: str, device):
    """Full Lucene regexp syntax; a bad pattern raises the parse error
    once, here, not per segment."""
    try:
        rx.compile_regexp(pattern)
    except rx.RegexpError as e:
        raise dsl.QueryParseError(f"[regexp] {e}")

    def expand(seg: Segment) -> np.ndarray:
        pb = seg.postings.get(field)
        if pb is None or not pb.vocab:
            return np.empty(0, np.int32)
        hits = rx.match_vocab(pattern, pb.vocab,
                              vocab_matrix_on(seg, field, device))
        return np.flatnonzero(hits).astype(np.int32)
    return expand


def _auto_fuzz(term: str, fuzziness) -> int:
    if fuzziness in ("AUTO", "auto", None):
        # Fuzziness.AUTO: 0 for < 3 chars, 1 for 3-5, 2 for more
        return 0 if len(term) < 3 else (1 if len(term) <= 5 else 2)
    return int(fuzziness)


def _fuzzy_expander(field: str, term: str, fuzziness, prefix_length: int,
                    device):
    """The rows within `fuzziness` edits of `term` (optimal string
    alignment, the reference's `_edit_distance_le`) that start with its
    first `prefix_length` chars: one DP over the dictionary's codepoint
    matrix (`regexp.osa_within`), no per-term loop."""
    k = None

    def expand(seg: Segment) -> np.ndarray:
        nonlocal k
        if k is None:
            k = _auto_fuzz(term, fuzziness)
        pb = seg.postings.get(field)
        if pb is None or not pb.vocab:
            return np.empty(0, np.int32)
        mat, lens = vocab_matrix_on(seg, field, device)
        hits = rx.osa_within(mat, lens, term, k, term[:prefix_length])
        return torch.nonzero(hits).flatten().to(torch.int32).cpu().numpy()
    return expand


def _keyword_range_expander(field: str, q: dsl.RangeQuery):
    def expand(seg: Segment) -> np.ndarray:
        pb = seg.postings.get(field)
        if pb is None:
            return np.empty(0, np.int32)
        lo = 0
        hi = len(pb.vocab)
        if q.gte is not None:
            lo = bisect_left(pb.vocab, str(q.gte))
        if q.gt is not None:
            lo = bisect_right(pb.vocab, str(q.gt))
        if q.lte is not None:
            hi = bisect_right(pb.vocab, str(q.lte))
        if q.lt is not None:
            hi = bisect_left(pb.vocab, str(q.lt))
        return np.arange(lo, max(hi, lo), dtype=np.int32)
    return expand


def _phrase_node(field: str, terms: List[str], slop: int, ctx: ShardContext,
                 boost: float, prefix_last: bool = False,
                 max_expansions: int = 50, ordered: bool = False,
                 gap_cost: bool = False) -> LPhrase:
    """The phrase scores as one pseudo-term whose idf is the terms' idf
    sum (Lucene's PhraseWeight); a prefix last term stands in with the df
    of its expansions' union, capped at N."""
    ft = ctx.mappings.resolve_field(field)
    if ft is not None and ft.type == "match_only_text":
        n = ctx.num_docs
        sim = ctx.sim_for(field)
        w = sum(sim.term_weight(1.0, n, min(ctx.doc_freq(field, t), n))
                for t in terms if ctx.doc_freq(field, t) > 0)
        return LSourcePhrase(field=field, terms=terms, slop=slop,
                             weight=(w or 1.0) * boost)
    sim = ctx.sim_for(field)
    has_norms = bool(ft is not None and ft.has_norms and sim.uses_norms)
    n = ctx.num_docs
    w = 0.0
    last = len(terms) - 1
    for i, t in enumerate(terms):
        if prefix_last and i == last:
            df = 0
            for s in ctx.segments:
                pb = s.postings.get(field)
                if pb is None:
                    continue
                for r in _prefix_rows(pb, t, max_expansions):
                    df += int(pb.starts[r + 1] - pb.starts[r])
        else:
            df = ctx.doc_freq(field, t)
        if df > 0:
            w += sim.term_weight(1.0, n, min(df, n))
    return LPhrase(field=field, terms=terms, slop=slop, weight=w * boost,
                   sim=sim, has_norms=has_norms, prefix_last=prefix_last,
                   max_expansions=max_expansions, ordered=ordered,
                   gap_cost=gap_cost)


def _source_phrase_docs(node: LSourcePhrase, seg: Segment,
                        mappings: Mappings) -> List[int]:
    """The docs holding every term of `node` whose `_source` passes the
    phrase test (the reference's LSourcePhrase emit)."""
    pb = seg.postings.get(node.field)
    if pb is None:
        return []
    rows = [pb.row(t) for t in node.terms]
    if any(r < 0 for r in rows):
        return []
    cand = None
    for r in rows:
        a, b = pb.row_slice(r)
        d = pb.doc_ids[a:b]
        cand = d if cand is None else np.intersect1d(cand, d,
                                                     assume_unique=True)
        if len(cand) == 0:
            break
    ft = mappings.resolve_field(node.field)
    analyzer = mappings.index_analyzer(ft) if ft is not None else None
    return [int(d) for d in (cand if cand is not None else ())
            if _source_phrase_match(seg, int(d), node.field, node.terms,
                                    node.slop, analyzer)]


def _source_phrase_match(seg: Segment, doc: int, field: str,
                         terms: List[str], slop: int, analyzer) -> bool:
    """Re-analyze one doc's `_source` value(s) of `field` and test the
    phrase with the median-offset total-movement slop cost (a copy of
    the reference's)."""
    if analyzer is None:
        return False
    node = seg.sources[doc]
    for part in field.split("."):
        if not isinstance(node, dict) or part not in node:
            return False
        node = node[part]
    values = node if isinstance(node, list) else [node]
    base = 0
    positions: dict = {}
    for v in values:
        toks = analyzer.analyze(str(v))
        last = 0
        for t in toks:
            positions.setdefault(t.text, []).append(base + t.position)
            last = t.position
        base += last + 100          # the value gap, as at index time
    per_term = [positions.get(t) for t in terms]
    if any(p is None for p in per_term):
        return False
    for p0 in per_term[0]:
        deltas = [0.0]
        for i, plist in enumerate(per_term[1:], start=1):
            # the nearest adjusted position to the anchor
            deltas.append(float(min((p - i - p0 for p in plist), key=abs)))
        med = sorted(deltas)[len(deltas) // 2]
        if sum(abs(d - med) for d in deltas) <= slop:
            return True
    return False


def _analyze_query_text(field: str, text: Any, ctx: ShardContext,
                        analyzer_override: Optional[str] = None) -> List[str]:
    ft = ctx.mappings.resolve_field(field)
    if ft is None:
        return [str(text)]
    if analyzer_override:
        return ctx.mappings.analysis.get(analyzer_override).terms(str(text))
    return ctx.mappings.search_analyzer_for(ft).terms(str(text))


def _index_term(field: str, value: Any, ctx: ShardContext) -> str:
    """Single exact term for term/terms queries: the keyword normalizer
    applies, text fields match the raw token (reference TermQueryBuilder);
    a flat_object leaf path its "path=value" term."""
    ft = ctx.mappings.resolve_field(field)
    if ft is not None and ft.flat_prefix:
        return f"{ft.flat_prefix}={value}"
    if ft is not None and ft.type in KEYWORD_TYPES:
        norm = ctx.mappings.index_analyzer(ft).terms(str(value))
        return norm[0] if norm else str(value)
    return str(value)


# ---------------------------------------------------------------------
# phase-2 rescore shapes (search/fastpath.py escalation rung)
# ---------------------------------------------------------------------

RESCORE_C_MIN = 1 << 8          # pad floor: tiny unions share one shape
RESCORE_C_MAX = 1 << 17         # == MAX_T * 4 * L_HEAD (deepest tier-2
                                # union); beyond -> the host pass


def rescore_cand_bucket(n: int) -> Optional[int]:
    """Candidate-axis pow2 bucket for a union of `n` ids; None when the
    union exceeds every bucket (host pass instead)."""
    if n <= 0 or n > RESCORE_C_MAX:
        return None
    return min(max(next_pow2(n), RESCORE_C_MIN), RESCORE_C_MAX)


# ---------------------------------------------------------------------
# the general path: one plan over one segment, as torch ops
# ---------------------------------------------------------------------

# general_served: bodies the general path served; geo_grid_cells_s: the
# host seconds of the geo grids' cell caches built (their first uses)
STATS = {"general_served": 0, "geo_grid_cells_s": 0.0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def field_postings(seg: Segment, field: str,
                   device: torch.device) -> Optional[ops.FieldPostings]:
    """The postings of `field` over `seg` on `device`, cached: windows
    into the fastpath's resident aligned layout (no bytes added), or a CSR
    copy where that layout cannot pack the field. None without
    postings (a feature field among them: its tf slot is an f32
    weight)."""
    pb = seg.postings.get(field)
    if pb is None or pb.size == 0:
        return None
    from . import fastpath      # fastpath imports this module

    def make():
        csr_off = pb.starts[:-1].astype(np.int64)
        if fastpath.packable(seg, field):
            al = fastpath.get_aligned(seg, field, device)
            return ops.FieldPostings(al.starts_rows * LANES, al.lens,
                                     csr_off, al.d_docs, d_tfdl=al.d_tfdl,
                                     d_imp=al.d_imp)
        docs, tfs, imp = seg.csr_on(field, device)
        return ops.FieldPostings(csr_off, np.diff(pb.starts), csr_off, docs,
                                 d_tfs=tfs,
                                 d_dl=seg.doc_lens_on(field, device),
                                 d_imp=imp)
    return seg.device_cached(("postings", field), device, make)


def _term_rows(node: LTerms, seg: Segment) -> list:
    """The group's term-dict rows over `seg`, pow2-padded with -1."""
    pb = seg.postings.get(node.field)
    rows = [-1] * next_pow2(len(node.terms), floor=1)
    for i, t in enumerate(node.terms):
        rows[i] = pb.row(t)
    return rows


def _f32(v) -> float:
    return float(np.float32(v))


# ---------------------------------------------------------------------
# phrase pairs: host arrays and device keys, cached per segment
# ---------------------------------------------------------------------

MAX_PAIR_KEYS = 1024           # device pair arrays per segment, oldest out


def _phrase_rows(node: LPhrase, pb, i: int) -> Tuple[int, ...]:
    """Term i's rows over `pb`: its row, or the prefix expansion of a
    prefix last term; () when it has none."""
    t = node.terms[i]
    if node.prefix_last and i == len(node.terms) - 1:
        return tuple(_prefix_rows(pb, t, node.max_expansions))
    r = pb.row(t)
    return (r,) if r >= 0 else ()


def phrase_pairs(seg: Segment, pb, rows: Tuple[int, ...]) -> tuple:
    """(docs i32, positions i32) of the postings of `rows` (a union for a
    prefix expansion), lex-sorted; cached per segment on the host (a
    merge drops the replaced segments' caches)."""
    cache = seg.__dict__.setdefault("phrase_pairs", {})
    key = (pb.field, rows)
    got = cache.get(key)
    if got is not None:
        return got
    d_parts, p_parts = [], []
    for r in rows:
        a, b = pb.row_slice(r)
        counts = np.diff(pb.pos_starts[a: b + 1])
        d_parts.append(np.repeat(pb.doc_ids[a:b], counts))
        p_parts.append(pb.positions[pb.pos_starts[a]: pb.pos_starts[b]])
    d = np.concatenate(d_parts) if d_parts else np.empty(0, np.int32)
    p = np.concatenate(p_parts) if p_parts else np.empty(0, np.int32)
    if len(rows) > 1 and len(d):
        order = np.lexsort((p, d))
        d, p = d[order], p[order]
    got = (d.astype(np.int32, copy=False), p.astype(np.int32, copy=False))
    cache[key] = got
    return got


def pair_keys_on(seg: Segment, pb, rows: Tuple[int, ...],
                 device: torch.device) -> torch.Tensor:
    """The pair keys of `rows` (`ops/positions.pair_keys`) on `device`,
    cached with the general path's device arrays (at most MAX_PAIR_KEYS
    per segment and device), unpadded: queries of any df share them."""
    key = ("pairs", pb.field, rows, str(device))
    got = seg.device_arrays.get(key)
    if got is None:
        d, p = phrase_pairs(seg, pb, rows)
        old = [k for k in seg.device_arrays
               if k[0] == "pairs" and k[-1] == str(device)]
        for k in old[:max(0, len(old) + 1 - MAX_PAIR_KEYS)]:
            del seg.device_arrays[k]
        got = pos_ops.pair_keys(torch.from_numpy(d).to(device),
                                torch.from_numpy(p).to(device))
        seg.device_arrays[key] = got
    return got


def phrase_freq(node: LPhrase, seg: Segment,
                device: torch.device) -> Optional[torch.Tensor]:
    """f32[ndocs] phrase frequency of `node` over `seg` (deleted docs
    included), or None where the segment holds no occurrence of some
    term or no positions of the field."""
    pb = seg.postings.get(node.field)
    if pb is None or pb.pos_starts is None:
        return None
    rows = [_phrase_rows(node, pb, i) for i in range(len(node.terms))]
    if not all(rows):
        return None            # a phrase needs every term
    keys = [pair_keys_on(seg, pb, r, device) for r in rows]
    # term i's query offset rides as a shift on its raw pairs
    return pos_ops.phrase_freqs(
        pos_ops.key_docs(keys[0]), pos_ops.key_positions(keys[0]),
        keys[1:], float(np.float32(node.slop)), seg.ndocs,
        ordered=node.ordered, gap_cost=node.gap_cost,
        shifts=list(range(1, len(keys))))


def reference_param_bytes(node: LNode, seg: Segment) -> int:
    """Bytes of the arrays the reference ships for the phrases and
    expansions of a filter clause over `seg`; its fastpath declines a
    filter whose parameters exceed FILTER_HASH_BYTE_CAP. A phrase ships
    its pairs padded to the reference's pow4 buckets (8 bytes a pair) and
    its scalars; an expansion its rows padded to a power of two (4 bytes
    a row) and its boost; a terms_set its f32 minimum per doc and its
    term group; a pinned query its i32 docs and f32 ranks padded to a
    power of two (at least 8) and its boost; a combined_fields query its
    rows per field, idf and scalars; a dis_max and a boosting their two
    scalars. The clause's scoring children count (a dis_max's, a
    boosting's both sides, a pinned's organic); a geo_shape its bool
    mask per padded doc, a geo_polygon its padded ring; a term group's
    rows and weights, a range's bounds and a geo node's scalars are a
    few bytes each and are not counted."""
    if isinstance(node, LPhrase):
        pb = seg.postings.get(node.field)
        if pb is None or pb.pos_starts is None:
            return 0
        rows = [_phrase_rows(node, pb, i) for i in range(len(node.terms))]
        if not all(rows):
            return 0
        total = 4 * len(rows) + 12
        for rr in rows:
            n = sum(int(pb.pos_starts[pb.starts[r + 1]]
                        - pb.pos_starts[pb.starts[r]]) for r in rr)
            bucket = next_pow2(max(n, 1), floor=64)
            if bucket.bit_length() % 2 == 0:
                bucket <<= 1
            total += 8 * bucket
        return total
    if isinstance(node, LExpandTerms):
        return 4 * next_pow2(max(len(node.rows(seg)), 1), floor=1) + 4
    if isinstance(node, LBool):
        return sum(reference_param_bytes(c, seg)
                   for c in node.musts + node.shoulds)
    if isinstance(node, LConstScore):
        return reference_param_bytes(node.child, seg)
    if isinstance(node, LDisMax):
        # tie and boost, then the children
        return 8 + sum(reference_param_bytes(c, seg) for c in node.children)
    if isinstance(node, LBoosting):
        # negative_boost and boost, then both sides
        return (8 + reference_param_bytes(node.positive, seg)
                + reference_param_bytes(node.negative, seg))
    if isinstance(node, LTermsSet):
        # the f32 minimum over ndocs_pad is the cap itself at 262,144
        # docs, so its term group's rows, weights, aux and scalars count
        t_pad = next_pow2(len(node.child.terms), floor=1)
        return 4 * seg.ndocs_pad + 12 * t_pad + 12
    if isinstance(node, LPinned):
        n = len(pinned_docs(node, seg)[0])
        return (8 * next_pow2(max(n, 1), floor=8) + 4
                + (reference_param_bytes(node.organic, seg)
                   if node.organic is not None else 0))
    if isinstance(node, LCombined):
        # rows and a weight per field, the idf, avgdl and msm
        t_pad = next_pow2(len(node.terms), floor=1)
        nf = len(node.fields)
        return 4 * t_pad * (nf + 1) + 4 * nf + 8
    if isinstance(node, LScriptScore):
        return reference_param_bytes(node.child, seg)
    if isinstance(node, LGeoShape):
        # the host mask as a bool per padded doc, and the boost
        return seg.ndocs_pad + 4
    if isinstance(node, LGeoPolygon):
        # the ring's f32 lats and lons padded to a power of two (at least
        # 8), and the boost
        return 8 * next_pow2(max(len(node.lats) + 1, 2), floor=8) + 4
    if isinstance(node, LFuncScore):
        return reference_param_bytes(node.child, seg) + sum(
            reference_param_bytes(f, seg) for f in node.fn_filters
            if f is not None)
    return 0


FILTER_HASH_BYTE_CAP = 1 << 20


def _flag(mask: torch.Tensor, boost: float) -> ops.ScoredMask:
    """A non-scoring match as a node: scores `boost` where it matches."""
    m = mask.to(torch.float32)
    return ops.ScoredMask(m * _f32(boost), m)


def emit(node: LNode, seg: Segment, ctx: ShardContext,
         device: torch.device) -> ops.ScoredMask:
    """Dense (scores, match count) of `node` over `seg`: the reference's
    `prepare` (host parameters) and `emit` (device program) in one pass,
    node by node, with the reference's arithmetic and order."""
    from . import filters       # filters imports this module

    nd = seg.ndocs
    live = seg.live_on(device)
    zeros = torch.zeros(nd, dtype=torch.float32, device=device)
    if isinstance(node, LTerms):
        post = field_postings(seg, node.field, device)
        if post is None:
            return ops.ScoredMask(zeros, zeros)
        rows = _term_rows(node, seg)
        if node.mode == "filter":
            return _flag(ops.term_match_mask(post, live, rows, nd),
                         node.boost)
        w = np.zeros(len(rows), np.float32)
        w[:len(node.terms)] = node.weights
        b_eff = node.sim.b if node.has_norms else 0.0
        sm = ops.score_term_group(post, rows, w, live, nd,
                                  float(node.sim.k1), float(b_eff),
                                  ctx.avgdl(node.field))
        ok = sm.count >= _f32(node.msm)
        return ops.ScoredMask(torch.where(ok, sm.scores, zeros),
                              torch.where(ok, sm.count, zeros))
    if isinstance(node, LPhrase):
        freq = phrase_freq(node, seg, device)
        if freq is None:
            return ops.ScoredMask(zeros, zeros)
        b_eff = node.sim.b if node.has_norms else 0.0
        scores, matched = pos_ops.phrase_score(
            freq, seg.doc_lens_on(node.field, device), live,
            _f32(node.weight), float(node.sim.k1), float(b_eff),
            _f32(ctx.avgdl(node.field)))
        return ops.ScoredMask(scores, matched.to(torch.float32))
    if isinstance(node, LExpandTerms):
        post = field_postings(seg, node.field, device)
        if post is None:
            return ops.ScoredMask(zeros, zeros)
        rows = node.rows(seg).tolist() or [-1]
        return _flag(ops.term_match_mask(post, live, rows, nd), node.boost)
    if isinstance(node, LMatchAll):
        return _flag(live, node.boost)
    if isinstance(node, LMatchNone):
        return ops.ScoredMask(zeros, zeros)
    if isinstance(node, LRange):
        mask = filters.range_mask(node, seg, device)
        if mask is None:
            return ops.ScoredMask(zeros, zeros)
        return _flag(mask & live, node.boost)
    if isinstance(node, LExists):
        return _flag(ops.exists_mask(filters.present_mask(
            node.field, seg, device), live), node.boost)
    if isinstance(node, LIds):
        docs = [d for d in (seg.local_doc(i) for i in node.ids) if d >= 0]
        return _flag(ops.docs_mask(docs, nd, device) & live, node.boost)
    if isinstance(node, LSourcePhrase):
        docs = node.docs(seg, ctx.mappings)
        return _flag(ops.docs_mask(docs, nd, device) & live, node.weight)
    if isinstance(node, LBool):
        m_sms = [emit(c, seg, ctx, device) for c in node.musts]
        s_sms = [emit(c, seg, ctx, device) for c in node.shoulds]
        scores = zeros
        for sm in m_sms + s_sms:
            scores = scores + sm.scores
        matched = live
        for sm in m_sms:
            matched = matched & sm.matched
        for c in node.filters:
            matched = matched & filters.filter_mask(c, seg, ctx, device)
        for c in node.must_nots:
            matched = matched & ~filters.filter_mask(c, seg, ctx, device)
        if s_sms:
            s_count = zeros
            for sm in s_sms:
                s_count = s_count + sm.matched.to(torch.float32)
            matched = matched & (s_count >= _f32(node.msm))
        scores = torch.where(matched, scores * _f32(node.boost), zeros)
        return ops.ScoredMask(scores, matched.to(torch.float32))
    if isinstance(node, LConstScore):
        return _flag(filters.filter_mask(node.child, seg, ctx, device)
                     & live, node.boost)
    if isinstance(node, LDisMax):
        return ops.dismax([emit(c, seg, ctx, device) for c in node.children],
                          _f32(node.tie_breaker), _f32(node.boost), zeros)
    if isinstance(node, LBoosting):
        pos = emit(node.positive, seg, ctx, device)
        neg = filters.filter_mask(node.negative, seg, ctx, device) & live
        factor = torch.where(neg, _f32(node.negative_boost), 1.0)
        scores = pos.scores * factor * _f32(node.boost)
        return ops.ScoredMask(torch.where(pos.matched, scores, zeros),
                              pos.count)
    if isinstance(node, LTermsSet):
        sm = emit(node.child, seg, ctx, device)     # msm 0: raw counts
        ok = (sm.count >= terms_set_need(node, seg, device)) & live
        return ops.ScoredMask(torch.where(ok, sm.scores, zeros),
                              ok.to(torch.float32))
    if isinstance(node, LPinned):
        org = (emit(node.organic, seg, ctx, device)
               if node.organic is not None else ops.ScoredMask(zeros, zeros))
        pins = pin_scores(node, seg, device)
        pinned = (pins > 0) & live
        score = torch.where(pinned, pins, org.scores * _f32(node.boost))
        matched = pinned | org.matched
        return ops.ScoredMask(torch.where(matched, score, zeros),
                              matched.to(torch.float32))
    if isinstance(node, LCombined):
        tfc, dlc, any_field = combined_tf(node, seg, device)
        if not any_field:
            return ops.ScoredMask(zeros, zeros)
        sim = ctx.sim_for(node.fields[0][0])
        avgdl = max(sum(w * ctx.avgdl(f) for f, w in node.fields), 1e-6)
        idf = np.zeros(len(tfc), np.float32)
        idf[:len(node.terms)] = node.idf
        scores, counts = ops.bm25f(tfc, dlc, idf, float(sim.k1),
                                   float(sim.b), avgdl)
        ok = (counts >= _f32(node.msm)) & live
        return ops.ScoredMask(torch.where(ok, scores, zeros),
                              ok.to(torch.float32))
    if isinstance(node, LKnn):
        score, matched = knn_scores(node, seg, device)
        matched = matched & live
        if node.filter is not None:
            matched = matched & filters.filter_mask(node.filter, seg, ctx,
                                                    device)
        score = torch.where(matched, score * _f32(node.boost), zeros)
        return ops.ScoredMask(score, matched.to(torch.float32))
    if isinstance(node, LRankFeature):
        return rank_feature_scores(node, seg, device, live, zeros)
    if isinstance(node, LSparseDot):
        post = field_postings(seg, node.field, device)
        if post is None:
            return ops.ScoredMask(zeros, zeros)
        pb = seg.postings[node.field]
        rows = [-1] * next_pow2(len(node.tokens), floor=8)
        rows[:len(node.tokens)] = [pb.row(t) for t in node.tokens]
        qw = np.zeros(len(rows), np.float32)
        qw[:len(node.tokens)] = node.weights
        sm = ops.feature_score(post, live, rows, nd, lambda w, ti:
                               ops.per_window(qw, ti) * w)
        return ops.ScoredMask(sm.scores * _f32(node.boost), sm.count)
    if isinstance(node, LDistanceFeature) and node.kind == "geo":
        geo = seg.geo_on(node.field, device)
        if geo is None:
            return ops.ScoredMask(zeros, zeros)
        # the reference's order: the doc's latitude first
        p1 = ops.deg2rad(geo["lat"])
        p2 = ops.deg2rad(ops.f32_on(node.origin[0], device))
        dist = ops.haversine(p1, p2, p2 - p1, ops.deg2rad(
            ops.f32_on(node.origin[1], device) - geo["lon"]))
        pivot = ops.f32_on(node.pivot, device)
        mask = geo["present"] & live
        return ops.ScoredMask(
            torch.where(mask, ops.f32_on(node.boost, device) * pivot
                        / (pivot + dist), zeros), mask.to(torch.float32))
    if isinstance(node, LDistanceFeature):
        split = date_split_on(seg, node.field, device)
        if split is None:
            return ops.ScoredMask(zeros, zeros)
        hi, lo, present = split
        ohi, olo = split_i64(node.origin)
        # the reference's f32 distance from the biased (hi, lo) words:
        # the low word's f32 rounds an epoch-ms difference to a multiple
        # of 128 ms or coarser
        dist = torch.abs((hi - ohi).to(torch.float32) * 4294967296.0
                         + (lo.to(torch.float32) - float(np.float32(olo))))
        pivot = torch.tensor(np.float32(node.pivot), device=device)
        boost = torch.tensor(np.float32(node.boost), device=device)
        mask = present & live
        return ops.ScoredMask(
            torch.where(mask, boost * pivot / (pivot + dist), zeros),
            mask.to(torch.float32))
    if isinstance(node, LFuncScore):
        return _emit_fnscore(node, seg, ctx, device)
    if isinstance(node, LScriptFilter):
        mask = script_filter_mask(node, seg, device) & live
        return _flag(mask, node.boost)
    if isinstance(node, LScriptScore):
        child = emit(node.child, seg, ctx, device)
        env = script_env(node.ast, node.params, seg, device, child.scores)
        scores = pl.eval_device(node.ast, env) * ops.f32_on(node.boost, device)
        min_score = (node.min_score if node.min_score is not None
                     else F32_MIN)
        matched = child.matched & (scores >= ops.f32_on(min_score, device))
        return ops.ScoredMask(torch.where(matched, scores, zeros),
                              matched.to(torch.float32))
    if isinstance(node, (LGeoDist, LGeoBox, LGeoPolygon, LGeoShape)):
        mask = geo_mask(node, seg, device)
        return _flag(mask & live, node.boost)
    if isinstance(node, LNested):
        return _emit_nested(node, seg, live, zeros, device)
    if isinstance(node, (LHasChild, LHasParent)):
        from . import join
        return join.emit_join(node, seg, ctx, live, zeros, device)
    if isinstance(node, LPercolate):
        from .percolate import segment_mask
        mask = node._masks.get(seg.uid)
        if mask is None:
            mask = node._masks[seg.uid] = torch.from_numpy(segment_mask(
                node.field, node.mini_seg, node.mini_ctx, seg)).to(device)
        return _flag(mask & live, node.boost)
    raise NotPortedError(f"plan [{type(node).__name__}] on the general path")


def nested_child_match(node: LNested, seg: Segment, live: torch.Tensor,
                       device) -> Optional[tuple]:
    """(child ScoredMask, child match, parent map) of a nested node over
    `seg`'s block, or None where the segment has no child of its path.
    A child is live where its parent is."""
    blk = seg.nested.get(node.path)
    if blk is None or blk.child.ndocs == 0:
        return None
    parent = blk.parent_on(device)
    sm = emit(node.child, blk.child, node.child_ctx, device)
    return sm, sm.matched & live[parent], parent


def _emit_nested(node: LNested, seg: Segment, live: torch.Tensor,
                 zeros: torch.Tensor, device) -> ops.ScoredMask:
    """The parents' (scores, match) of a nested node: the matching
    children counted into their parents, the scores reduced by the score
    mode (sum and avg f32 scatter-adds, max and min scatter-reduces), as
    the reference's emit."""
    got = nested_child_match(node, seg, live, device)
    if got is None:
        return ops.ScoredMask(zeros, zeros)
    sm, cmatch, parent = got
    cnt = zeros.index_add(0, parent, cmatch.to(torch.float32))
    pmatch = cnt > 0
    mode = node.score_mode
    if mode == "none":
        pscores = pmatch.to(torch.float32)
    elif mode in ("max", "min"):
        fill = float("-inf") if mode == "max" else float("inf")
        red = torch.full_like(zeros, fill).scatter_reduce(
            0, parent, torch.where(cmatch, sm.scores, fill),
            "amax" if mode == "max" else "amin")
        pscores = torch.where(pmatch, red, zeros)
    else:
        total = zeros.index_add(0, parent, torch.where(cmatch, sm.scores,
                                                       0.0))
        pscores = (total / torch.clamp(cnt, min=1.0) if mode == "avg"
                   else total)
    pmatch = pmatch & live
    return ops.ScoredMask(torch.where(pmatch, pscores * _f32(node.boost),
                                      zeros), pmatch.to(torch.float32))


def geo_mask(node: LNode, seg: Segment, device) -> torch.Tensor:
    """bool[ndocs] of a geo node over `seg` (deletes ignored): the
    haversine radius, the box (edges inclusive), the ray-cast over the
    polygon's ring closed by its first vertex, or the host mask of a
    geo_shape; no doc without the column."""
    if isinstance(node, LGeoShape):
        return torch.from_numpy(geo_shape_mask(node, seg)).to(device)
    geo = seg.geo_on(node.field, device)
    if geo is None:
        return torch.zeros(seg.ndocs, dtype=torch.bool, device=device)
    if isinstance(node, LGeoDist):
        return ops.geo_distance_mask(geo, node.lat, node.lon, node.radius_m,
                                     inclusive=node.inclusive)
    if isinstance(node, LGeoBox):
        lat, lon = geo["lat"], geo["lon"]
        return ((lat <= ops.f32_on(node.top, device))
                & (lat >= ops.f32_on(node.bottom, device))
                & (lon >= ops.f32_on(node.left, device))
                & (lon <= ops.f32_on(node.right, device)) & geo["present"])
    lats = np.asarray(node.lats + node.lats[:1], np.float32)
    lons = np.asarray(node.lons + node.lons[:1], np.float32)
    return ops.point_in_polygon_mask(geo, lats, lons)


def geo_shape_mask(node: LGeoShape, seg: Segment) -> np.ndarray:
    """bool[ndocs] of a geo_shape relation, exact, on the host (the
    reference's prepare): on a geo_shape field the bbox prefilter, then
    the relation per candidate (disjoint: every present doc but those
    that intersect); on a geo_point field the vectorized f64 point test
    (in or on the shape for intersects / within, neither for disjoint, a
    point query at the same f32 point for contains), run only over the
    points inside the shape's box widened by `_edge_margin` (no point
    outside it is in or on the shape). Built per request, as the
    reference's prepare builds it; in filter context `filters.filter_mask`
    caches its device copy."""
    from . import geo as G
    mask = np.zeros(seg.ndocs, bool)
    col = seg.shape_cols.get(node.field)
    gc = seg.geo_cols.get(node.field)
    if col is not None:
        cands = np.nonzero(col.bbox_candidates(node.shape.bbox))[0]
        if node.relation == "disjoint":
            mask[col.present] = True
            for d in cands:
                if G.intersects(col.shape(int(d)), node.shape):
                    mask[d] = False
        else:
            for d in cands:
                if G.relation_matches(col.shape(int(d)), node.shape,
                                      node.relation):
                    mask[d] = True
    elif gc is not None:
        if node.relation in ("intersects", "within", "disjoint"):
            x0, y0, x1, y1 = node.shape.bbox
            w = _edge_margin(node.shape)
            lon, lat = gc.lon.astype(np.float64), gc.lat.astype(np.float64)
            cand = np.flatnonzero(gc.present & (lon >= x0 - w)
                                  & (lon <= x1 + w) & (lat >= y0 - w)
                                  & (lat <= y1 + w))
            pts = np.stack([lon[cand], lat[cand]], axis=1)
            m = np.zeros(seg.ndocs, bool)
            m[cand] = (G.points_in_shape(pts, node.shape)
                       | G._points_on_edges(pts, node.shape))
            mask = (~m if node.relation == "disjoint" else m) & gc.present
        elif (len(node.shape.points) == 1 and not node.shape.polys
              and not node.shape.lines):
            qx, qy = node.shape.points[0]
            mask = ((gc.lon == np.float32(qx)) & (gc.lat == np.float32(qy))
                    & gc.present)
    return mask


def _edge_margin(shape, eps: float = 1e-9) -> float:
    """Degrees around a shape's box beyond which no point is on one of
    its edges under `geo._points_on_segments`' tolerance (eps scaled by
    the edge's length, eps past its ends), with room to spare."""
    from . import geo as G
    a, b = G._shape_edges(shape)
    ln = np.sqrt(((b - a) ** 2).sum(-1)) if len(a) else np.zeros(0)
    ln = ln[ln > eps]
    return 4 * eps * max(1.0, 1.0 / float(ln.min())) if len(ln) else 4 * eps


def shape_key(shape) -> tuple:
    """A hashable key of a parsed Shape: its points, lines and rings."""
    return (shape.points.tobytes(),
            tuple(ln.tobytes() for ln in shape.lines),
            tuple((o.tobytes(), tuple(h.tobytes() for h in hs))
                  for o, hs in shape.polys))


# ---------------------------------------------------------------------
# function_score, script and script_score (the reference computes them in
# jnp inside its general program: torch ops here)
# ---------------------------------------------------------------------

F32_MIN = -3.4e38




def script_param_values(params: dict) -> dict:
    """The numeric params of a score / filter script as f32 values, in
    key order (a bool is 0 or 1); any other param is the reference's
    400."""
    out = {}
    for k in sorted(params):
        v = params[k]
        if isinstance(v, bool):
            v = float(v)
        if not isinstance(v, (int, float)):
            raise dsl.QueryParseError(
                f"script param [{k}] must be numeric in score/filter "
                f"scripts")
        out[k] = np.float32(v)
    return out


def script_params_on(params: dict, device) -> dict:
    """`script_param_values` as f32 scalars on `device`."""
    return {k: torch.tensor(v, device=device)
            for k, v in script_param_values(params).items()}


def script_env(ast: tuple, params: dict, seg: Segment, device,
               score: Optional[torch.Tensor]) -> pl.DeviceEnv:
    """A device script bound to one segment (the reference's
    `_prepare_script` and `_script_env`): each doc['f'] it reads is the
    f32 view of the column (`Segment.f32_on`; an epoch-ms date rounds to
    a multiple of 2^17 ms near 2026), absent where the segment lacks it;
    its params f32 scalars."""
    cols, present = {}, {}
    for f in pl.referenced_doc_fields(ast):
        col = seg.f32_on(f, device)
        if col is not None:
            cols[f], present[f] = col
    return pl.DeviceEnv(device, cols, present, score,
                        script_params_on(params, device), seg.ndocs)


def script_filter_mask(node: LScriptFilter, seg: Segment,
                       device) -> torch.Tensor:
    """bool[ndocs]: where the script's value is nonzero (deletes
    ignored)."""
    env = script_env(node.ast, node.params, seg, device, None)
    return pl.eval_device(node.ast, env) != 0


def _parse_time_ms(s) -> float:
    """'10d' / '3h' / a number (ms) -> milliseconds (a decay's scale and
    offset on a date field): fractional amounts and weeks."""
    if isinstance(s, (int, float)):
        return float(s)
    mm = re.fullmatch(r"\s*([\d.]+)\s*(ms|s|m|h|d|w)\s*", str(s))
    if not mm:
        raise dsl.QueryParseError(f"invalid time value [{s}]")
    mult = {"ms": 1, "w": 7 * 86_400_000}.get(mm.group(2)) or \
        _FIXED_MS[mm.group(2)]
    return float(mm.group(1)) * mult


def parse_distance_m(s) -> float:
    """A distance ('10km', '500m', a number of meters) in meters; a
    malformed one is the reference's 400."""
    try:
        return dsl.parse_distance(s)
    except (ValueError, TypeError):
        raise dsl.QueryParseError(f"invalid distance [{s}]")


def decay_params(fn: dsl.ScoreFunction, seg: Segment,
                 ctx: ShardContext) -> tuple:
    """(field, origin, a, offset, column exists, kind) of a gauss / exp /
    linear decay (the reference's `_prepare_decay`): origin, scale and
    offset parsed per field family (kind "geo": a geo_point's origin
    (lat, lon), its scale and offset distances in meters; kind "num": a
    date's origin in epoch ms, "now" or none the current time, its scale
    and offset time values, or a number's), and the shape constant `a`
    (gauss exp(a d^2), exp exp(a d), linear max(0, (a - d) / a))
    computed in f64. A malformed value is the reference's 400."""
    field = ctx.mappings.aliases.get(fn.field, fn.field)
    ft = ctx.mappings.resolve_field(field)
    ftype = ft.type if ft is not None else "float"
    shape = fn.decay_shape
    kind = "num"
    try:
        if field in seg.geo_cols or ftype == "geo_point":
            kind = "geo"
            if fn.origin is None:
                raise dsl.QueryParseError("[decay] geo requires [origin]")
            origin = parse_geo(fn.origin)
            scale = parse_distance_m(fn.scale)
            offset = parse_distance_m(fn.offset or 0)
        elif ftype == "date":
            origin = (float(time.time() * 1000)
                      if fn.origin in (None, "now")
                      else float(_parse_date(fn.origin, ft.date_format
                                             if ft is not None else None)))
            scale = _parse_time_ms(fn.scale)
            offset = _parse_time_ms(fn.offset or 0)
        else:
            if fn.origin is None:
                raise dsl.QueryParseError("[decay] numeric requires [origin]")
            scale = float(fn.scale)
            offset = float(fn.offset or 0)
            origin = float(fn.origin)
    except (ValueError, TypeError, KeyError) as e:
        raise dsl.QueryParseError(f"[{shape}] decay on [{field}]: {e}")
    if scale <= 0:
        raise dsl.QueryParseError("[decay] scale must be > 0")
    decay = min(max(float(fn.decay), 1e-12), 1.0 - 1e-12)
    if shape == "gauss":
        a = math.log(decay) / (scale * scale)
    elif shape == "exp":
        a = math.log(decay) / scale
    else:
        a = scale / (1.0 - decay)
    cols = seg.geo_cols if kind == "geo" else seg.numeric_cols
    return field, origin, a, offset, field in cols, kind


def random_score_values(seed: int, nd: int, device) -> torch.Tensor:
    """f32[nd]: the reference's uint32 hash of each doc index with the
    seed, over [0, 1): the same steps in i64, each product masked to 32
    bits (the seed as the reference's int32, then its uint32 bits)."""
    m32 = 0xFFFFFFFF
    s32 = int(np.int32(seed)) & m32
    h = torch.arange(nd, dtype=torch.int64, device=device)
    h = ((h * 2654435761) & m32) ^ s32
    h = h ^ (h >> 16)
    h = (h * 0x45D9F3B) & m32
    h = h ^ (h >> 16)
    return h.to(torch.float32) / ops.f32_on(2.0 ** 32, device)


def _emit_fnscore(node: LFuncScore, seg: Segment, ctx: ShardContext,
                  device) -> ops.ScoredMask:
    """function_score over one segment, in the reference's order: the
    child, each function's factor times its weight (where its filter
    does not match, the score mode's neutral), the factors combined by
    `score_mode`, then with the child's score by `boost_mode`, times the
    boost; a doc matches where the child does and its score reaches
    `min_score`."""
    nd = seg.ndocs
    child = emit(node.child, seg, ctx, device)
    factors = []
    for fn, filt in zip(node.functions, node.fn_filters):
        w = ops.f32_on(fn.weight, device)
        if fn.kind == "field_value_factor":
            factor = ops.f32_on(fn.factor, device)
            missing = ops.f32_on(fn.missing if fn.missing is not None else 1.0,
                              device)
            col = seg.f32_on(fn.field, device)
            if col is not None:
                v = torch.where(col[1], col[0] * factor, missing)
            else:
                v = missing.expand(nd)
            v = apply_modifier(v, fn.modifier, device)
        elif fn.kind == "random_score":
            v = random_score_values(fn.seed, nd, device)
        elif fn.kind == "script_score":
            ast = pl.parse(fn.script or "")
            env = script_env(ast, fn.script_params or {}, seg, device,
                             child.scores)
            v = pl.eval_device(ast, env)
        elif fn.kind == "decay":
            field, origin, a, offset, exists, dkind = decay_params(fn, seg,
                                                                   ctx)
            a_t = ops.f32_on(a, device)
            if exists:
                if dkind == "geo":
                    geo = seg.geo_on(field, device)
                    # the reference's order: the origin's latitude first
                    p1 = ops.deg2rad(ops.f32_on(origin[0], device))
                    p2 = ops.deg2rad(geo["lat"])
                    d = ops.haversine(p1, p2, p2 - p1, ops.deg2rad(
                        geo["lon"] - ops.f32_on(origin[1], device)))
                    present = geo["present"]
                else:
                    vals, present = seg.f32_on(field, device)
                    d = torch.abs(vals - ops.f32_on(origin, device))
                d = torch.clamp_min(d - ops.f32_on(offset, device), 0.0)
                if fn.decay_shape == "gauss":
                    v = torch.exp(a_t * d * d)
                elif fn.decay_shape == "exp":
                    v = torch.exp(a_t * d)
                else:
                    v = torch.clamp_min((a_t - d) / a_t, 0.0)
                # docs without a value don't decay (factor 1)
                v = torch.where(present, v, 1.0)
            else:
                v = torch.ones(nd, dtype=torch.float32, device=device)
        else:  # weight
            v = torch.ones(nd, dtype=torch.float32, device=device)
        v = v * w
        if filt is not None:
            fmask = emit(filt, seg, ctx, device).matched
            v = torch.where(fmask, v, _score_mode_neutral(node.score_mode))
        factors.append(v)
    if factors:
        fac = _combine_factors(factors, node.score_mode, device)
    else:
        fac = torch.ones(nd, dtype=torch.float32, device=device)
    scores = _combine_boost(child.scores, fac, node.boost_mode, device)
    scores = scores * ops.f32_on(node.boost, device)
    min_score = node.min_score if node.min_score is not None else F32_MIN
    matched = child.matched & (scores >= ops.f32_on(min_score, device))
    scores = torch.where(matched, scores, 0.0)
    return ops.ScoredMask(scores, matched.to(torch.float32))


def apply_modifier(v: torch.Tensor, modifier: str, device) -> torch.Tensor:
    """field_value_factor's modifier (the reference's `_apply_modifier`)."""
    if modifier == "none":
        return v
    if modifier == "log":
        return torch.log10(torch.clamp_min(v, 1e-9))
    if modifier == "log1p":
        return torch.log10(v + 1.0)
    if modifier == "log2p":
        return torch.log10(v + 2.0)
    if modifier == "ln":
        return torch.log(torch.clamp_min(v, 1e-9))
    if modifier == "ln1p":
        return torch.log1p(v)
    if modifier == "ln2p":
        return torch.log(v + 2.0)
    if modifier == "square":
        return v * v
    if modifier == "sqrt":
        return torch.sqrt(torch.clamp_min(v, 0.0))
    if modifier == "reciprocal":
        return ops.f32_on(1.0, device) / torch.clamp_min(v, 1e-9)
    raise ValueError(f"unknown modifier [{modifier}]")


def _score_mode_neutral(mode: str) -> float:
    return 1.0 if mode == "multiply" else 0.0


def _combine_factors(factors: List[torch.Tensor], mode: str,
                     device) -> torch.Tensor:
    if mode == "multiply":
        out = factors[0]
        for f in factors[1:]:
            out = out * f
        return out
    if mode in ("sum", "avg"):
        out = factors[0]
        for f in factors[1:]:
            out = out + f
        return out / ops.f32_on(len(factors), device) if mode == "avg" else out
    if mode == "max":
        out = factors[0]
        for f in factors[1:]:
            out = torch.maximum(out, f)
        return out
    if mode == "min":
        out = factors[0]
        for f in factors[1:]:
            out = torch.minimum(out, f)
        return out
    if mode == "first":
        return factors[0]
    raise ValueError(f"unknown score_mode [{mode}]")


def _combine_boost(score: torch.Tensor, factor: torch.Tensor, mode: str,
                   device) -> torch.Tensor:
    if mode == "multiply":
        return score * factor
    if mode == "sum":
        return score + factor
    if mode == "replace":
        return factor
    if mode == "avg":
        return (score + factor) / ops.f32_on(2.0, device)
    if mode == "max":
        return torch.maximum(score, factor)
    if mode == "min":
        return torch.minimum(score, factor)
    raise ValueError(f"unknown boost_mode [{mode}]")


def rank_feature_scores(node: LRankFeature, seg: Segment, device, live,
                        zeros) -> ops.ScoredMask:
    """(scores, counts) of a rank_feature node: the function over its
    feature row's postings (a doc without the feature does not match),
    or over the f32 view of its column where a value is present."""
    if node.feature is None:
        col = seg.f32_on(node.field, device)
        if col is None:
            return ops.ScoredMask(zeros, zeros)
        v = ops.rank_feature_value(col[0], node.fn, node.p1, node.p2,
                                   node.positive)
        mask = col[1] & live
        return ops.ScoredMask(torch.where(mask, v * _f32(node.boost), zeros),
                              mask.to(torch.float32))
    post = field_postings(seg, node.field, device)
    if post is None:
        return ops.ScoredMask(zeros, zeros)
    sm = ops.feature_score(
        post, live, [seg.postings[node.field].row(node.feature)], seg.ndocs,
        lambda w, _ti: ops.rank_feature_value(w, node.fn, node.p1, node.p2,
                                              node.positive))
    return ops.ScoredMask(sm.scores * _f32(node.boost), sm.count)


def split_i64(v: int) -> Tuple[int, int]:
    """An i64 as the reference's (hi i32, lo i32 biased by 2^31) words."""
    v = int(v)
    return v >> 32, (v & 0xFFFFFFFF) - (1 << 31)


def date_split_on(seg: Segment, field: str, device) -> Optional[tuple]:
    """(hi i32[ndocs], lo i32[ndocs] biased by 2^31, present) of an
    integer column on `device` (the reference's split of an i64 column),
    or None without the column; cached per segment."""
    col = seg.numeric_on(field, device)
    if col is None:
        return None

    def make():
        v, present = col
        return ((v >> 32).to(torch.int32),
                ((v & 0xFFFFFFFF) - (1 << 31)).to(torch.int32), present)
    return seg.device_cached(("split", field), device, make)


def knn_nprobe(node: LKnn, seg: Segment, device) -> Optional[tuple]:
    """(device IVF arrays, nprobe) where the node takes the probe: the
    mapping asked for IVF, the query did not force the scan and the
    segment has an index (built here on first use); its nprobe clamped
    to the segment's nlist. None: the exact scan."""
    if node.exact:
        return None
    got = seg.ivf_on(node.field, device)
    if got is None:
        return None
    ivf = got[0]
    return got, int(min(node.nprobe or ivf.default_nprobe, ivf.nlist))


def knn_scores(node: LKnn, seg: Segment, device) -> tuple:
    """(scores f32[ndocs], matched bool[ndocs]) of a kNN node before the
    live mask, its filter and its boost: every present row on the scan,
    the probed lists' rows on the IVF route; zeros without the column.
    A query vector longer than the field's dims is cut, as the
    reference slices it, and a shorter one is numpy's broadcast
    ValueError, as there; |q|^2 is the whole vector's."""
    arr = seg.vector_on(node.field, device)
    if arr is None:
        z = torch.zeros(seg.ndocs, dtype=torch.float32, device=device)
        return z, z > 0
    dims = seg.vector_cols[node.field].dims
    qv = np.zeros(dims, np.float32)
    qv[:dims] = node.vector[:dims]
    q = torch.from_numpy(qv).to(device)
    qsq = float(np.float32(np.dot(node.vector, node.vector)))
    probe = knn_nprobe(node, seg, device)
    if probe is None:
        return knn_ops.exact_scan(arr, q, qsq, node.similarity)
    (_ivf, cents, lists), nprobe = probe
    score, hit = knn_ops.ivf_probe(arr, cents, lists, q, qsq,
                                   node.similarity, nprobe)
    return score, hit & arr["present"]


def terms_set_need(node: LTermsSet, seg: Segment,
                   device: torch.device) -> torch.Tensor:
    """f32[ndocs]: each doc's minimum count, max(f32 value of the
    minimum field, 1), inf without a value, or max(the script's value,
    1): the script runs once when it reads no doc field, else once a doc
    (deleted docs too) on the host, with `params.num_terms`, as the
    reference's prepare runs it; cached per segment."""
    def make():
        need = np.full(seg.ndocs, np.inf, np.float32)
        if node.msm_field is not None:
            col = seg.numeric_cols.get(node.msm_field)
            if col is not None:
                need[col.present] = col.values[col.present].astype(
                    np.float32)
        else:
            src, prm = node.script
            ast = pl.parse(src)
            variables = {"params": {**prm, "num_terms": node.num_terms}}
            flds = pl.referenced_doc_fields(ast)
            if not flds:
                need[:] = float(pl.execute(ast, variables))
            else:
                for d in range(seg.ndocs):
                    dv = {f: pl.doc_view_for(seg, d, f) for f in flds}
                    need[d] = float(pl.execute(ast, {**variables,
                                                     "doc": dv}))
        return torch.from_numpy(np.maximum(need, np.float32(1.0))).to(device)
    return seg.device_cached(("terms_set_need", terms_set_key(node)),
                             device, make)


def terms_set_key(node: LTermsSet) -> tuple:
    """What a terms_set's minimums read: the minimum field, or the
    script's source, params and term count."""
    if node.script is None:
        return (node.msm_field,)
    src, prm = node.script
    return (src, repr(sorted(prm.items())), node.num_terms)


def pinned_docs(node: LPinned, seg: Segment) -> Tuple[list, list]:
    """(local docs, list ranks) of the pinned ids the segment holds."""
    docs, ranks = [], []
    for rank, i in enumerate(node.ids):
        d = seg.local_doc(i)
        if d >= 0:
            docs.append(d)
            ranks.append(rank)
    return docs, ranks


def pin_scores(node: LPinned, seg: Segment,
               device: torch.device) -> torch.Tensor:
    """f32[ndocs]: 1e6 - rank at each pinned doc, 0 elsewhere; a repeated
    id keeps its first rank (a max). The 1e6 base keeps a rank step
    exact in f32 (ulp(1e6) = 0.0625)."""
    out = torch.zeros(seg.ndocs, dtype=torch.float32, device=device)
    docs, ranks = pinned_docs(node, seg)
    if docs:
        score = np.float32(1e6) - np.asarray(ranks, np.float32)
        out.scatter_reduce_(0, torch.as_tensor(docs, device=device),
                            torch.from_numpy(score).to(device), "amax")
    return out


def combined_tf(node: LCombined, seg: Segment,
                device: torch.device) -> tuple:
    """(tf f32[T_pad, ndocs], doc lengths f32[ndocs], any field): each
    term's tf and the doc lengths summed over the fields the segment
    holds, each times its weight, in field order."""
    nd = seg.ndocs
    t_pad = next_pow2(len(node.terms), floor=1)
    tfc = torch.zeros((t_pad, nd), dtype=torch.float32, device=device)
    dlc = torch.zeros(nd, dtype=torch.float32, device=device)
    any_field = False
    for fname, w in node.fields:
        pb = seg.postings.get(fname)
        if pb is None:
            continue
        any_field = True
        post = field_postings(seg, fname, device)
        if post is not None:
            rows = [pb.row(t) for t in node.terms]
            rows += [-1] * (t_pad - len(rows))
            tfc = tfc + _f32(w) * ops.gather_tf_dense(post, rows, nd, t_pad)
        dlc = dlc + _f32(w) * seg.doc_lens_on(fname, device)
    return tfc, dlc, any_field


def combined_counts(node: LCombined, seg: Segment,
                    device: torch.device) -> torch.Tensor:
    """f32[ndocs]: the number of terms each doc holds (its weighted tf
    above 0), deletes ignored."""
    tfc = combined_tf(node, seg, device)[0]
    return (tfc > 0).to(torch.float32).sum(0)


def run_segment(lroot: LNode, seg: Segment, ctx: ShardContext, k_pad: int,
                device: torch.device, agg_nodes=(), order=None,
                named=()) -> dict:
    """The executor body: `lroot` over `seg`, its masked top `k_pad` (score
    desc, doc asc), the total, the max score, under "aggs" each agg
    node's (spec, outputs) over the live-masked match (`emit_agg`, its
    tensors as numpy arrays) and under "named", for each (name, node) of
    `named`, whether the node matches each top-k doc, all fetched in one
    copy. The names come sorted, one entry a name (the last node of a
    repeated name): the reference's jitted program returns them as a
    dict, whose keys JAX sorts.

    With an `order` (`body.Order`) that ranks by more than the score, the
    top-k runs over its sort key (`sort_key`; ties by ascending doc), a
    `search_after` cursor keeps the docs strictly after it on that key
    (`after_key`), `collapse` keeps one doc per group (`collapse_ords`,
    `ops.collapse_topk`), and "topk_key" holds the keys beside the
    candidates' scores. The total, the max score and the aggs count the
    docs after the cursor's primary key. Under several sort keys (and no
    collapse) a cursor whose primary value the segment holds also keeps
    the docs tied with it, whose order the host's full tuple decides, and
    the top-k grows by their count, so that it holds all of them."""
    sm = emit(lroot, seg, ctx, device)
    live = seg.live_on(device)
    match = sm.matched & live
    ordered = order is not None and order.on_device
    if ordered:
        key = sort_key(order.specs, seg, sm.scores, device)
        keep = match
        if order.after is not None:
            ak, ties = after_key(order.after, order.specs, seg)
            match = match & (key < ak)
            keep = match
            if ties and order.multi and order.collapse is None:
                keep = keep | (sm.matched & live & (key == ak))
                n_tied = int((keep & ~match).sum())
                k_pad = min(next_pow2(max(order.need + n_tied, 16)),
                            seg.ndocs_pad)
        if order.collapse is not None:
            ords, n_ord_pad = collapse_ords(order.collapse, seg, device)
            vals, idx = ops.collapse_topk(key, keep, live, ords, n_ord_pad,
                                          k_pad)
        else:
            vals, idx = ops.topk_docs(key, keep, live, k_pad)
        top = torch.where(match, sm.scores,
                          torch.full((), float("-inf"), device=device)).max()
        leaves: List[torch.Tensor] = [vals, idx, match.sum(),
                                      sm.scores[idx], top.reshape(1)]
    else:
        vals, idx = ops.topk_docs(sm.scores, sm.matched, live, k_pad)
        leaves = [vals, idx, ops.total_hits(sm.matched, live)]
    # a root top_hits is served from the shard's candidates (executor)
    aggs = {n.name: emit_agg(n, seg, ctx, match, device, sm.scores)
            for n in agg_nodes if n.kind != "top_hits"}
    by_name = dict(named)
    named_at = {nm: emit(by_name[nm], seg, ctx, device).matched[idx]
                for nm in sorted(by_name)}
    host, (aggs_np, named_np) = fetch_tree((aggs, named_at), leaves)
    k = len(idx)
    sc = host[:k].astype(np.float32)
    STATS["general_served"] += 1
    out = {"topk_idx": host[k:2 * k].astype(np.int64), "topk_scores": sc,
           "total": int(host[2 * k]), "total_rel": "eq",
           "max_score": float(sc[0]) if k else float("-inf"),
           "aggs": aggs_np, "named": named_np}
    if ordered:
        out["topk_key"] = sc
        out["topk_scores"] = host[2 * k + 1:3 * k + 1].astype(np.float32)
        out["max_score"] = float(host[3 * k + 1])
    return out


def gather_scores(lroot: LNode, seg: Segment, ctx: ShardContext,
                  docs: np.ndarray, device: torch.device) -> tuple:
    """(scores f32[n], matched bool[n]) of `lroot` at the segment docs
    `docs` (the reference's `run_gather_scores`, the rescore's second
    pass): one dense `emit`, then a gather. The caller clamps `docs` to
    the padded doc axis as the reference does; a doc past `ndocs` (the
    reference's padding) scores 0 and does not match."""
    sm = emit(lroot, seg, ctx, device)
    d = torch.from_numpy(np.asarray(docs, np.int64)).to(device)
    inside = d < seg.ndocs
    d = torch.where(inside, d, torch.zeros_like(d))
    out = torch.cat([torch.where(inside, sm.scores[d], 0.0),
                     (sm.matched[d] & inside).to(torch.float32)])
    host = out.cpu().numpy()
    n = len(docs)
    return host[:n], host[n:] > 0


def describe_plan(node: Optional[LNode]) -> dict:
    """The plan tree of the profile and validate_query calls (the
    reference's `describe_plan`): each node's type (its class name less
    the leading L), a description and its children; times live on the
    root only."""
    if node is None:
        return {"type": "MatchAll", "description": "*:*"}
    t = type(node).__name__.lstrip("L")
    desc = ""
    if isinstance(node, LTerms):
        desc = f"{node.field}:{list(node.terms)[:8]}"
    elif isinstance(node, LPhrase):
        desc = f"{node.field}:\"{' '.join(node.terms)}\""
    elif isinstance(node, LRange):
        desc = f"{node.field}:[{node.lo} TO {node.hi}]"
    elif getattr(node, "field", ""):
        desc = str(node.field)
    children = []
    for attr in ("musts", "shoulds", "must_nots", "filters", "children"):
        for c in getattr(node, attr, ()) or ():
            children.append(describe_plan(c))
    for attr in ("child", "positive", "negative", "filter", "organic"):
        c = getattr(node, attr, None)
        if isinstance(c, LNode):
            children.append(describe_plan(c))
    out = {"type": t, "description": desc, "time_in_nanos": 0,
           "fused": True}
    if children:
        out["children"] = children
    return out


# ---------------------------------------------------------------------
# sort keys, the search_after cursor and field collapsing
# ---------------------------------------------------------------------

MISSING_KEY = 2.0 ** 30   # a missing value's key: below or above any rank


def sort_key(specs: List[dict], seg: Segment, scores: torch.Tensor,
             device: torch.device) -> torch.Tensor:
    """f32[ndocs] ranking key of the primary sort (the reference's
    `prepare_sort` and `emit_sort_key`): larger ranks first. The score
    (or its negation ascending), the negated doc for `_doc`, and for a
    field its exact rank among the segment's distinct values (a numeric
    field's `sort_ords`, a keyword field's smallest ordinal), negated
    ascending, with a missing value at -2^30 (`_last`) or 2^30
    (`_first`); a field the segment lacks is missing everywhere."""
    if not specs:
        return scores
    primary = specs[0]
    field = primary["field"]
    if field == "_score":
        desc = primary.get("order", "desc") == "desc"
        return scores if desc else -scores
    nd = seg.ndocs
    if field == "_doc":
        return -torch.arange(nd, dtype=torch.float32, device=device)
    desc = primary.get("order", "asc") == "desc"
    missing_last = primary.get("missing", "_last") == "_last"
    miss = torch.full((), -MISSING_KEY if missing_last else MISSING_KEY,
                      dtype=torch.float32, device=device)
    if field == "_geo_distance":
        # f32 haversine meters from the f32 origin; the host orders the
        # window exactly
        geo = seg.geo_on(primary["geo_field"], device)
        if geo is None:
            return miss.expand(nd)
        dist = ops.geo_distance_vec(geo, *primary["origin"])
        return torch.where(geo["present"], dist if desc else -dist, miss)
    nspec = primary.get("nested")
    if nspec and nspec.get("path"):
        mode = primary.get("mode", "max" if desc else "min")
        vals, present = nested_sort_values(seg, field, nspec["path"], mode)
        if vals is None:
            return miss.expand(nd)

        def make():
            ords = np.full(nd, -1, np.int32)
            if present.any():
                ords[present] = np.searchsorted(np.unique(vals[present]),
                                                vals[present])
            return torch.from_numpy(ords).to(device)
        o = seg.device_cached(("nested_sort", field, nspec["path"], mode),
                              device, make)
    elif field in seg.numeric_cols:
        o = seg.sort_ords_on(field, device)
    elif field in seg.keyword_cols:
        o = seg.keyword_on(field, device)[2]
    else:
        o = torch.full((nd,), -1, dtype=torch.int32, device=device)
    ords = o.to(torch.float32)
    return torch.where(o >= 0, ords if desc else -ords, miss)


def nested_sort_values(seg: Segment, field: str, path: str, mode: str):
    """(f64[ndocs] values, present) of each parent's nested children's
    `field` reduced by `mode` (min, max, sum, avg), or (None, None)
    where the path's children lack the column (the reference's
    `_nested_sort_values`); cached on the segment."""
    cache = seg.__dict__.setdefault("nested_sort_cache", {})
    key = (field, path, mode)
    got = cache.get(key)
    if got is not None:
        return got
    blk = seg.nested.get(path)
    col = blk.child.numeric_cols.get(field) if blk is not None else None
    if col is None:
        got = cache[key] = (None, None)
        return got
    n, nc = seg.ndocs, blk.child.ndocs
    keep = col.present[:nc] & blk.child.live[:nc]
    p = blk.parent_of[:nc][keep]
    v = col.values[:nc][keep].astype(np.float64)
    out = np.full(n, np.inf if mode == "min" else
                  (-np.inf if mode == "max" else 0.0), np.float64)
    if mode == "min":
        np.minimum.at(out, p, v)
    elif mode == "max":
        np.maximum.at(out, p, v)
    else:
        np.add.at(out, p, v)
    present = np.zeros(n, bool)
    present[np.unique(p)] = True
    if mode == "avg":
        cnt = np.zeros(n, np.float64)
        np.add.at(cnt, p, 1.0)
        out = out / np.maximum(cnt, 1.0)
    got = cache[key] = (np.where(present, out, 0.0), present)
    return got


def after_key(after: list, specs: List[dict],
              seg: Segment) -> Tuple[float, bool]:
    """The cursor on this segment's primary key: (k, ties) where the
    docs after the cursor are exactly those with key < k, and `ties` is
    True when docs may hold the cursor's own primary value (key == k).
    A value the segment lacks takes the ordinal on the side its order
    needs: descending the count of smaller values, ascending one minus
    the count of values up to it."""
    v = after[0]
    primary = specs[0] if specs else {"field": "_score"}
    field = primary["field"]
    if field == "_score":
        k = _f32(v)
        desc = primary.get("order", "desc") == "desc"
        return (k if desc else -k), True
    if field == "_doc":
        d = int(v)
        return -float(d), 0 <= d < seg.ndocs
    desc = primary.get("order", "asc") == "desc"
    missing_last = primary.get("missing", "_last") == "_last"
    if v is None:
        return (-MISSING_KEY if missing_last else MISSING_KEY), True
    col = seg.numeric_cols.get(field)
    kcol = seg.keyword_cols.get(field)
    if col is not None:
        if isinstance(v, (bool, str)) or not isinstance(v, (int, float)):
            raise dsl.QueryParseError(
                f"[search_after] value [{v}] of numeric field [{field}]")
        vocab = col.distinct
        lo = int(np.searchsorted(vocab, v, side="left"))
        hi = int(np.searchsorted(vocab, v, side="right"))
    elif kcol is not None:
        vocab = kcol.vocab
        lo = bisect_left(vocab, str(v))
        hi = bisect_right(vocab, str(v))
    else:
        # missing everywhere here: after any value when missing sorts last
        return (float("inf") if missing_last else float("-inf")), False
    return (float(lo) if desc else float(1 - hi)), hi > lo


def collapse_ords(field: str, seg: Segment,
                  device: torch.device) -> Tuple[torch.Tensor, int]:
    """(group ordinal per doc, -1 in the null group; group slots) of a
    collapse field (the reference's `prepare_collapse`): a keyword
    field's smallest ordinal, a numeric field's `sort_ords`, and for a
    field the segment lacks every doc in the null group."""
    if field in seg.keyword_cols:
        return (seg.keyword_on(field, device)[2],
                next_pow2(len(seg.keyword_cols[field].vocab) + 1))
    if field in seg.numeric_cols:
        return seg.sort_ords_on(field, device), next_pow2(seg.ndocs + 1)
    return torch.full((seg.ndocs,), -1, dtype=torch.int32,
                      device=device), 2


def _leaves_to_slots(tree, leaves: List[torch.Tensor]):
    """`tree` with each tensor appended to `leaves` and replaced by its
    slot; dicts and tuples are walked, anything else kept."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _Slot(len(leaves) - 1)
    if isinstance(tree, dict):
        return {k: _leaves_to_slots(v, leaves) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_leaves_to_slots(v, leaves) for v in tree)
    return tree


@dataclass(frozen=True)
class _Slot:
    i: int


def fetch_tree(tree, leaves: List[torch.Tensor]) -> tuple:
    """(the f64 host copy of `leaves` and then of the tensors of `tree`,
    `tree` with each tensor as a numpy array): one device-to-host copy."""
    tree = _leaves_to_slots(tree, leaves)
    host = torch.cat([t.double().reshape(-1) for t in leaves]).cpu().numpy() \
        if leaves else np.zeros(0)
    return host, _slots_to_arrays(tree, host, leaves, np.cumsum(
        [0] + [t.numel() for t in leaves]))


def _slots_to_arrays(tree, host: np.ndarray, leaves: List[torch.Tensor],
                     offs: np.ndarray):
    """The inverse of `_leaves_to_slots` over the fetched f64 copy (leaf
    i at `offs[i]`): each slot back as a numpy array of its tensor's
    dtype and shape."""
    if isinstance(tree, _Slot):
        off = int(offs[tree.i])
        t = leaves[tree.i]
        dtype = {torch.float32: np.float32, torch.int32: np.int32}.get(
            t.dtype, np.int64)
        return host[off: off + t.numel()].astype(dtype).reshape(t.shape)
    if isinstance(tree, dict):
        return {k: _slots_to_arrays(v, host, leaves, offs)
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_slots_to_arrays(v, host, leaves, offs) for v in tree)
    return tree


# ---------------------------------------------------------------------
# aggregations: the reference's prepare_agg + emit_agg in one pass
# ---------------------------------------------------------------------

HLL_LOG2M = 14
DEFAULT_PERCENTS = (1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0)
_DAY_MS = 86400000
_FIXED_MS = {"ms": 1, "s": 1000, "m": 60000, "h": 3600000, "d": 86400000}


def parse_interval_ms(s, allow_negative: bool = False) -> int:
    """A fixed interval ("30d", "6h", ...) in millis; a sign only where the
    caller allows it (a date_histogram `offset`)."""
    if isinstance(s, (int, float)):
        return int(s)
    sign_re = r"([+-]?)" if allow_negative else r"()"
    mm = re.fullmatch(sign_re + r"(\d+)(ms|s|m|h|d)", str(s))
    if not mm:
        raise ValueError(f"invalid fixed_interval [{s}]")
    v = int(mm.group(2)) * _FIXED_MS[mm.group(3)]
    return -v if mm.group(1) == "-" else v


def calendar_bucket_ids(ms: np.ndarray, calendar: str) -> np.ndarray:
    """i64 calendar bucket of each epoch-ms value: the reference's
    per-value `datetime` loop (months, quarters and years since 1970-01,
    weeks from epoch day 0, a Thursday, shifted to Mondays; days, hours,
    minutes), vectorised with floor division (so negative epochs floor)
    and numpy's civil calendar."""
    ms = np.asarray(ms, np.int64)
    if calendar in ("day", "1d"):
        return ms // _DAY_MS
    if calendar in ("hour", "1h"):
        return ms // 3600000
    if calendar in ("minute", "1m"):
        return ms // 60000
    if calendar in ("week", "1w"):
        return (ms // _DAY_MS + 3) // 7
    if calendar in ("month", "1M", "quarter", "1q", "year", "1y"):
        months = (ms // _DAY_MS).astype("datetime64[D]").astype(
            "datetime64[M]").astype(np.int64)
        if calendar in ("month", "1M"):
            return months
        return months // 3 if calendar in ("quarter", "1q") else months // 12
    raise ValueError(f"unknown calendar_interval [{calendar}]")


def calendar_bucket_to_epoch_ms(b: int, calendar: str) -> int:
    """The epoch ms where calendar bucket `b` starts."""
    if calendar in ("month", "1M"):
        return _epoch_ms(1970 + b // 12, b % 12 + 1)
    if calendar in ("year", "1y"):
        return _epoch_ms(1970 + b, 1)
    if calendar in ("quarter", "1q"):
        return _epoch_ms(1970 + b // 4, (b % 4) * 3 + 1)
    if calendar in ("week", "1w"):
        return (b * 7 - 3) * _DAY_MS
    if calendar in ("day", "1d"):
        return b * _DAY_MS
    if calendar in ("hour", "1h"):
        return b * 3600000
    if calendar in ("minute", "1m"):
        return b * 60000
    raise ValueError(calendar)


def _epoch_ms(year: int, month: int) -> int:
    return int(_dt.datetime(year, month, 1, tzinfo=_dt.timezone.utc)
               .timestamp() * 1000)


def host_date_buckets(seg: Segment, field: str, interval_ms: int,
                      offset_ms: int, calendar: Optional[str]) -> tuple:
    """(bucket id i32[ndocs] (-1 without a value), min bucket, bucket
    count) of a date column: floor((v - offset) / interval) on i64, or the
    calendar's buckets; cached per segment (a merge drops the cache)."""
    cache = seg.__dict__.setdefault("date_buckets", {})
    key = (field, interval_ms, offset_ms, calendar)
    got = cache.get(key)
    if got is not None:
        return got
    col = seg.numeric_cols.get(field)
    if col is None or not col.present.any():
        got = (np.full(seg.ndocs, -1, np.int32), 0, 1)
    else:
        vals = col.values.astype(np.int64)
        b = (np.floor_divide(vals - offset_ms, interval_ms)
             if calendar is None else calendar_bucket_ids(vals, calendar))
        bp = b[col.present]
        mn, mx = int(bp.min()), int(bp.max())
        got = (np.where(col.present, b - mn, -1).astype(np.int32), mn,
               mx - mn + 1)
    cache[key] = got
    return got


GEOHASH_B32 = "0123456789bcdefghjkmnpqrstuvwxyz"


def geohash_strings(codes: np.ndarray, precision: int) -> List[str]:
    """The base-32 geohash strings of interleaved cell codes."""
    out = []
    for c in codes.tolist():
        out.append("".join(
            GEOHASH_B32[(c >> (5 * (precision - 1 - i))) & 31]
            for i in range(precision)))
    return out


def geohash_codes(col, precision: int, device) -> tuple:
    """(distinct geohash codes ascending, each doc's index into them) of
    a GeoColumn's points (absent ones too, at (0, 0)), on `device`."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    lat = torch.from_numpy(col.lat).to(dev).to(torch.float64)
    lon = torch.from_numpy(col.lon).to(dev).to(torch.float64)
    nbits = 5 * precision
    lonb, latb = (nbits + 1) // 2, nbits // 2
    li = torch.clamp(torch.floor((lon + 180.0) / 360.0 * (1 << lonb)),
                     0, (1 << lonb) - 1).to(torch.int64)
    la = torch.clamp(torch.floor((lat + 90.0) / 180.0 * (1 << latb)),
                     0, (1 << latb) - 1).to(torch.int64)
    codes = torch.zeros_like(li)
    for b in range(nbits):
        src, idx = ((li, lonb - 1 - b // 2) if b % 2 == 0
                    else (la, latb - 1 - b // 2))
        codes = (codes << 1) | ((src >> idx) & 1)
    uniq, inv = torch.unique(codes, sorted=True, return_inverse=True)
    return uniq.cpu().numpy(), inv.cpu().numpy()


def geo_grid_cells(seg: Segment, field: str, kind: str, precision: int,
                   device=None) -> tuple:
    """(cell keys, i32[ndocs] each doc's cell ordinal, -1 without a
    point) of a geohash_grid / geotile_grid over a geo_point column (the
    reference's `_geo_grid_cache`), once per (segment, field, kind,
    precision); the device then counts ordinals. Geohash interleaves the
    lon / lat bits, lon first, its cells computed on `device` (the CPU
    when None) in f64 and i64: adds, a divide, a multiply by a power of
    two and a floor, each exact or correctly rounded as numpy's, so the
    codes are the reference's bit for bit. A tile is "z/x/y" of the Web
    Mercator grid (latitude clipped to +-85.05112878), f64 numpy on the
    host as in the reference."""
    cache = seg.__dict__.setdefault("geo_grid_cells", {})
    key = (field, kind, precision)
    got = cache.get(key)
    if got is not None:
        return got
    t0 = time.perf_counter()
    col = seg.geo_cols.get(field)
    ords = np.full(seg.ndocs, -1, np.int32)
    vocab: List[str] = []
    if col is not None and col.present.any():
        lat = col.lat.astype(np.float64)
        lon = col.lon.astype(np.float64)
        if kind == "geotile_grid":
            n = 1 << precision
            x = np.clip(np.floor((lon + 180.0) / 360.0 * n), 0, n - 1)
            latr = np.deg2rad(np.clip(lat, -85.05112878, 85.05112878))
            y = np.clip(np.floor(
                (1.0 - np.log(np.tan(latr) + 1.0 / np.cos(latr)) / np.pi)
                / 2.0 * n), 0, n - 1)
            codes = x.astype(np.int64) * n + y.astype(np.int64)
            uniq, inv = np.unique(codes, return_inverse=True)
            vocab = [f"{precision}/{int(c) // n}/{int(c) % n}" for c in uniq]
        else:
            uniq, inv = geohash_codes(col, precision, device)
            vocab = geohash_strings(uniq, precision)
        ords = np.where(col.present, inv.reshape(-1).astype(np.int32), -1)
    cache[key] = (vocab, ords)
    STATS["geo_grid_cells_s"] += time.perf_counter() - t0
    return cache[key]


def crc32_vocab_hashes(vocab) -> np.ndarray:
    """i64 crc32 of each vocab string: the keyword cardinality's value
    hashes."""
    return np.fromiter((zlib.crc32(v.encode()) for v in vocab), np.int64,
                       count=len(vocab))


def _kw_hashes_on(seg: Segment, field: str, device) -> torch.Tensor:
    def make():
        cache = seg.__dict__.setdefault("kw_hashes", {})
        if field not in cache:
            cache[field] = crc32_vocab_hashes(seg.keyword_cols[field].vocab)
        return torch.from_numpy(cache[field]).to(device)
    return seg.device_cached(("kw_hashes", field), device, make)


def coerce_agg_ranges(kind: str, body: dict, field: str,
                      mappings: Mappings) -> list:
    """A range agg's ranges; a date_range's from/to parse as the field's
    values do (epoch ms)."""
    ranges = body.get("ranges", [])
    if kind != "date_range":
        return ranges
    ft = mappings.resolve_field(field)
    coerced = []
    for r in ranges:
        r2 = dict(r)
        for end in ("from", "to"):
            if r.get(end) is not None:
                r2[end] = coerce_value(ft, r[end])
        coerced.append(r2)
    return coerced


def ip_range_spec(body: dict) -> tuple:
    """(keys, (from, to) strings, (lo, hi) integers) of an ip_range agg,
    as the reference reads them: a `mask` covers its network (hi one
    past the broadcast address), `from` is inclusive, `to` exclusive."""
    keys, bounds, ints = [], [], []
    for r in body.get("ranges", []):
        if "mask" in r:
            net = ipaddress.ip_network(r["mask"], strict=False)
            keys.append(r.get("key", r["mask"]))
            bounds.append((str(net.network_address),
                           str(net.broadcast_address)))
            ints.append((ip_to_int(str(net.network_address)),
                         ip_to_int(str(net.broadcast_address)) + 1))
        else:
            keys.append(r.get("key",
                              f"{r.get('from', '*')}-{r.get('to', '*')}"))
            bounds.append((r.get("from"), r.get("to")))
            ints.append((ip_to_int(r["from"]) if r.get("from") else None,
                         ip_to_int(r["to"]) if r.get("to") else None))
    return keys, bounds, ints


def range_agg_spec(ranges: List[dict]) -> tuple:
    """(f32 lows, f32 highs, bucket keys, from/to metas) of a range agg."""
    nr = len(ranges)
    lows = np.full(nr, -np.inf, dtype=np.float32)
    highs = np.full(nr, np.inf, dtype=np.float32)
    keys, metas = [], []
    for i, r in enumerate(ranges):
        frm, to = r.get("from"), r.get("to")
        if frm is not None:
            lows[i] = float(frm)
        if to is not None:
            highs[i] = float(to)
        keys.append(r.get("key", f"{frm if frm is not None else '*'}-"
                                 f"{to if to is not None else '*'}"))
        meta = {}
        if frm is not None:
            meta["from"] = float(np.float32(frm))
        if to is not None:
            meta["to"] = float(np.float32(to))
        metas.append(meta)
    return lows, highs, keys, metas


def filters_agg_items(body: dict) -> list:
    """(key, clause) pairs of a `filters` agg: its dict's items, or "0",
    "1", ... for the anonymous list form."""
    raw = body.get("filters", {})
    return (list(raw.items()) if isinstance(raw, dict)
            else [(str(i), f) for i, f in enumerate(raw)])


def agg_field(node, ctx: ShardContext) -> str:
    return _resolve(node.body.get("field", ""), ctx)


def _resolve(field: str, ctx: ShardContext) -> str:
    """A field name as mapped (an alias resolved), else as given."""
    ft = ctx.mappings.resolve_field(field)
    return ft.name if ft else field


def emit_agg(node, seg: Segment, ctx: ShardContext, match: torch.Tensor,
             device: torch.device, scores: Optional[torch.Tensor] = None
             ) -> tuple:
    """-> (spec, out): the host spec of one agg node over `seg` (what the
    partial needs: fields, bucket windows, keys, sub specs) and its
    device outputs (a dict of tensors, None where the reference emits
    nothing). `match` is the query's live-masked bool[ndocs] match.
    Ordinal bucket kinds (terms, histogram, date_histogram) fuse only
    their stats-family subs into per-bucket scatters, as the reference's
    device pass does; the executor's refinement serves the other subs.
    The container kinds (range, filter, filters, global, missing,
    adjacency_matrix, the samplers) run every sub over their bucket's
    match. `scores` (f32[ndocs], the query's) rank the samplers' and
    significant_text's docs."""
    from . import filters

    kind = node.kind
    body = node.body

    def stats_col(sub):
        """The f32 view a stats-family sub fuses into its parent's
        buckets, or None (another kind, a keyword value_count, no
        column)."""
        f = agg_field(sub, ctx)
        if sub.kind not in STATS_FAMILY or (
                sub.kind == "value_count" and f in seg.keyword_cols):
            return None
        return seg.f32_on(f, device)

    def bucketed_subs(b: torch.Tensor, nb: int) -> tuple:
        """Stats-family subs per bucket (`_emit_bucketed_sub`)."""
        specs, out = [], {}
        for i, sub in enumerate(node.subs):
            col = stats_col(sub)
            specs.append(col is not None)
            if col is not None:
                vals, present = col
                sb = torch.where(present, b, torch.full_like(b, nb))
                out[f"sub{i}"] = agg_ops.bucket_metrics(sb, nb, vals)
        return tuple(specs), out

    def container_subs(bucket_match: torch.Tensor, out: dict,
                       prefix: str = "") -> tuple:
        specs = []
        for i, sub in enumerate(node.subs):
            sspec, sout = emit_agg(sub, seg, ctx, bucket_match, device,
                                   scores)
            specs.append(sspec)
            if sout:
                out[f"{prefix}sub{i}"] = sout
        return tuple(specs)

    if kind in ("terms", "rare_terms", "significant_terms"):
        field = agg_field(node, ctx)
        col = seg.keyword_cols.get(field)
        if col is None:
            # a significant_terms segment without the field still adds its
            # live docs to the background total
            return (("sig_missing",), {}) if kind == "significant_terms" \
                else (("terms_missing",), None)
        kw = seg.keyword_on(field, device)
        nv = len(col.vocab)
        out = {"counts": agg_ops.terms_counts(kw, match, nv)}
        specs = []
        for i, sub in enumerate(node.subs):
            scol = stats_col(sub)
            specs.append(scol is not None)
            if scol is not None:
                out[f"sub{i}"] = agg_ops.terms_sub_metric(kw, match, *scol,
                                                          nv)
        if kind == "significant_terms":
            out["fg_total"] = match.sum()
            return ("sig_terms", field, tuple(specs)), out
        return ("terms", field, tuple(specs)), out

    if kind == "histogram":
        field = agg_field(node, ctx)
        interval = float(body["interval"])
        offset = float(body.get("offset", 0.0))
        col = seg.numeric_cols.get(field)
        if col is None or not col.present.any():
            return ("hist_missing",), None
        mn, mx = col.min_max
        min_b = int(np.floor((mn - offset) / interval))
        nb = int(np.floor((mx - offset) / interval)) - min_b + 1
        vals, present = seg.f32_on(field, device)
        b = agg_ops.histogram_buckets(vals, present, match, interval, offset,
                                      min_b, nb)
        specs, out = bucketed_subs(b, nb)
        out["counts"] = agg_ops.bucket_counts(b, nb)
        return ("hist", min_b, interval, offset, specs), out

    if kind == "date_histogram":
        field = agg_field(node, ctx)
        calendar = body.get("calendar_interval")
        interval_ms = 0 if calendar is not None else parse_interval_ms(
            body.get("fixed_interval", body.get("interval", "1d")))
        offset_ms = (parse_interval_ms(body.get("offset", 0),
                                       allow_negative=True)
                     if body.get("offset") else 0)
        key = (field, max(interval_ms, 1), offset_ms, calendar)
        ids, min_b, nb = host_date_buckets(seg, *key)
        d_ids = seg.device_cached(("dbuckets",) + key, device,
                                  lambda: torch.from_numpy(ids).to(device))
        b = agg_ops.doc_buckets(d_ids, match, nb)
        specs, out = bucketed_subs(b, nb)
        out["counts"] = agg_ops.bucket_counts(b, nb)
        return ("date_hist", min_b, interval_ms, offset_ms, calendar,
                specs), out

    if kind in ("range", "date_range"):
        field = agg_field(node, ctx)
        ranges = coerce_agg_ranges(kind, body, field, ctx.mappings)
        lows, highs, keys, _metas = range_agg_spec(ranges)
        bounds = tuple((float(lo), float(hi)) for lo, hi in zip(lows, highs))
        col = seg.f32_on(field, device)
        if col is None:
            return ("range", tuple(keys), bounds, ()), None
        vals, present = col
        out = {"counts": agg_ops.range_counts(vals, present, match, lows,
                                              highs)}
        specs = ()       # the same for every bucket
        for ri, (lo, hi) in enumerate(bounds):
            bm = match & present & (vals >= lo) & (vals < hi)
            specs = container_subs(bm, out, prefix=f"r{ri}_")
        return ("range", tuple(keys), bounds, specs), out

    if kind == "geo_distance":
        # rings from an origin: the haversine vector, then the range
        # agg's [from, to) counts in meters
        field = agg_field(node, ctx)
        if "origin" not in body:
            raise dsl.QueryParseError(
                "[geo_distance] aggregation requires [origin]")
        try:
            olat, olon = parse_geo(body["origin"])
            unit_m = dsl.parse_distance(f"1{body.get('unit', 'm')}")
        except (ValueError, TypeError, KeyError) as e:
            raise dsl.QueryParseError(f"[geo_distance] {e}")
        ranges = body.get("ranges", [])
        lows = np.full(len(ranges), -np.inf, dtype=np.float32)
        highs = np.full(len(ranges), np.inf, dtype=np.float32)
        keys, disp = [], []
        for i, rg in enumerate(ranges):
            frm, to = rg.get("from"), rg.get("to")
            if frm is not None:
                lows[i] = float(frm) * unit_m
            if to is not None:
                highs[i] = float(to) * unit_m
            keys.append(rg.get("key", f"{frm if frm is not None else '*'}-"
                                      f"{to if to is not None else '*'}"))
            disp.append((float(frm) if frm is not None else float("-inf"),
                         float(to) if to is not None else float("inf")))
        geo = seg.geo_on(field, device)
        if geo is None:
            return ("geo_range", tuple(keys), tuple(disp), ()), None
        dist = ops.geo_distance_vec(geo, olat, olon)
        out = {"counts": agg_ops.range_counts(dist, geo["present"], match,
                                              lows, highs)}
        specs = ()       # the same for every bucket
        for ri in range(len(ranges)):
            bm = (match & geo["present"] & (dist >= float(lows[ri]))
                  & (dist < float(highs[ri])))
            specs = container_subs(bm, out, prefix=f"r{ri}_")
        return ("geo_range", tuple(keys), tuple(disp), specs), out

    if kind in ("geohash_grid", "geotile_grid"):
        field = agg_field(node, ctx)
        precision = int(body.get("precision",
                                 5 if kind == "geohash_grid" else 7))
        vocab, ords = geo_grid_cells(seg, field, kind, precision, device)
        nv = max(len(vocab), 1)
        d_ords = seg.device_cached(("gords", field, kind, precision), device,
                                   lambda: torch.from_numpy(ords).to(device))
        b = agg_ops.ord_buckets(d_ords, match, nv)
        specs, out = bucketed_subs(b, nv)
        out["counts"] = agg_ops.bucket_counts(b, nv)
        return ("geo_grid", field, kind, precision, specs), out

    if kind in ("geo_bounds", "geo_centroid"):
        geo = seg.geo_on(agg_field(node, ctx), device)
        if geo is None:
            return ("geo_stat",), {"count": torch.zeros((), device=device)}
        args = (geo["lat"], geo["lon"], geo["present"], match)
        if kind == "geo_bounds":
            names = ("top", "bottom", "left", "right", "count")
            return ("geo_stat",), dict(zip(names,
                                           agg_ops.geo_bounds_agg(*args)))
        return ("geo_stat",), dict(zip(("slat", "slon", "count"),
                                       agg_ops.geo_centroid_agg(*args)))

    if kind == "ip_range":
        field = agg_field(node, ctx)
        keys, bounds, ints = ip_range_spec(body)
        col = seg.numeric_on(field, device)
        if col is None:     # every bucket counts 0, as in the reference
            return (("ip_range", tuple(keys), tuple(bounds), ()),
                    {"counts": torch.zeros(len(keys), dtype=torch.int64)})
        vals, present = col
        masks = []
        for lo, hi in ints:
            m = match & present
            if lo is not None:
                m = m & (vals >= min(lo, (1 << 63) - 1))
            if hi is not None:
                m = m & (vals < min(hi, (1 << 63) - 1))
            masks.append(m)
        out = {"counts": torch.stack([m.sum() for m in masks])}
        specs = ()       # the same for every bucket
        for ri, bm in enumerate(masks):
            specs = container_subs(bm, out, prefix=f"r{ri}_")
        return ("ip_range", tuple(keys), tuple(bounds), specs), out

    if kind in ("filter", "filters"):
        items = ([(None, body)] if kind == "filter"
                 else filters_agg_items(body))
        out, specs = {}, ()      # specs: the same for every bucket
        for ki, (_key, clause) in enumerate(items):
            fnode = rewrite(dsl.parse_query(clause), ctx, scoring=False)
            bm = match & filters.filter_mask(fnode, seg, ctx, device)
            entry = {"count": bm.sum()}
            specs = container_subs(bm, entry)
            out[f"k{ki}"] = entry
        return (kind, tuple(k for k, _ in items), specs), out

    if kind in ("nested", "reverse_nested"):
        return _emit_nested_agg(node, seg, ctx, match, device)

    if kind in ("children", "parent"):
        bm = join_agg_match(node, seg, ctx, device)
        if bm is None:
            return ("terms_missing",), None
        out = {"doc_count": bm.sum()}
        return ("join_agg", seg, container_subs(bm, out)), out

    if kind in ("global", "missing"):
        if kind == "global":
            bm = seg.live_on(device)
        else:
            field = agg_field(node, ctx)
            col = seg.f32_on(field, device)
            kw = seg.keyword_on(field, device)
            bm = (match & ~col[1] if col is not None else
                  match & (kw[2] < 0) if kw is not None else match)
        out = {"count": bm.sum()}
        return (kind, container_subs(bm, out)), out

    if kind in STATS_FAMILY:
        field = agg_field(node, ctx)
        if kind == "value_count" and field in seg.keyword_cols:
            return ("vc_keyword",), {"count": agg_ops.value_count_keyword(
                seg.keyword_on(field, device), match)}
        col = seg.f32_on(field, device)
        if col is None:      # an empty partial, not none
            return ("stats_missing",), {"empty": None}
        return ("stats",), dict(zip(
            ("count", "sum", "min", "max", "sumsq"),
            agg_ops.stats_agg(*col, match)))

    if kind == "cardinality":
        field = agg_field(node, ctx)
        if field in seg.keyword_cols:
            regs = agg_ops.cardinality_keyword_registers(
                seg.keyword_on(field, device), match,
                len(seg.keyword_cols[field].vocab),
                _kw_hashes_on(seg, field, device), HLL_LOG2M)
        else:
            col = seg.f32_on(field, device)
            regs = (torch.zeros(1 << HLL_LOG2M, dtype=torch.int32,
                                device=device) if col is None else
                    agg_ops.cardinality_numeric_registers(*col, match,
                                                          HLL_LOG2M))
        return ("card",), {"registers": regs}

    if kind in ("percentiles", "percentile_ranks"):
        field = agg_field(node, ctx)
        col = seg.f32_on(field, device)
        hist = (torch.zeros(agg_ops.DD_NBINS, dtype=torch.int64,
                            device=device) if col is None
                else agg_ops.ddsketch_hist(*col, match))
        if kind == "percentiles":
            pv = tuple(body.get("percents", DEFAULT_PERCENTS))
        else:
            pv = tuple(float(v) for v in body.get("values", ()))
        return (kind, pv), {"hist": hist}

    if kind == "composite":
        return _emit_composite(node, seg, ctx, match, device, stats_col)

    if kind == "multi_terms":
        sources = body.get("terms", [])
        if len(sources) < 2:
            raise dsl.QueryParseError(
                "[multi_terms] requires at least two [terms] sources")
        fields = tuple(s["field"] for s in sources)
        vocab, ords = multi_terms_on(seg, ctx, fields, device)
        nv = max(len(vocab), 1)
        b = agg_ops.ord_buckets(ords, match, nv)
        specs, out = bucketed_subs(b, nv)
        out["counts"] = agg_ops.bucket_counts(b, nv)
        return ("multi_terms", fields, specs), out

    if kind == "auto_date_histogram":
        field = agg_field(node, ctx)
        interval_ms = auto_interval(seg.numeric_cols.get(field),
                                    max(int(body.get("buckets", 10)), 1))
        key = (field, interval_ms, 0, None)
        ids, min_b, nb = host_date_buckets(seg, *key)
        d_ids = seg.device_cached(("dbuckets",) + key, device,
                                  lambda: torch.from_numpy(ids).to(device))
        b = agg_ops.doc_buckets(d_ids, match, nb)
        specs, out = bucketed_subs(b, nb)
        out["counts"] = agg_ops.bucket_counts(b, nb)
        return ("auto_date", min_b, interval_ms, specs), out

    if kind == "adjacency_matrix":
        raw = body.get("filters", {})
        keys = sorted(raw)
        masks = [filters.filter_mask(rewrite(dsl.parse_query(raw[k]), ctx,
                                             scoring=False), seg, ctx, device)
                 for k in keys]
        cells = [(a,) for a in range(len(keys))] + [
            (a, b) for a in range(len(keys))
            for b in range(a + 1, len(keys))]
        out, specs = {}, ()
        for ci, cell in enumerate(cells):
            bm = match
            for a in cell:
                bm = bm & masks[a]
            out[f"c{ci}"] = bm.sum()
            specs = container_subs(bm, out, prefix=f"c{ci}_")
        return ("adjacency", tuple(keys), body.get("separator", "&"),
                specs), out

    if kind in ("sampler", "diversified_sampler"):
        shard_size = max(int(body.get("shard_size", 100)), 1)
        thr = getattr(node, "global_thr", None)
        sel, tops = agg_ops.sampler_select(match, scores, shard_size, thr)
        if kind == "diversified_sampler":
            tops = None            # no shard-wide second pass
            sel = agg_ops.diversify(
                sel, diversity_ords(body.get("field", ""), seg, ctx, device),
                scores, max(int(body.get("max_docs_per_value", 1)), 1))
        out = {"doc_count": sel.sum()}
        if tops is not None:
            out["topscores"] = tops
        return ("sampler", container_subs(sel, out)), out

    if kind == "significant_text":
        shard_size = int(body.get("shard_size", 200))
        _vals, idx = ops.topk_docs(scores, match, match,
                                   max(min(shard_size, seg.ndocs), 1))
        return ("sig_text", body.get("field", "")), {
            "idx": idx, "n": torch.clamp(match.sum(), max=len(idx))}

    if kind == "top_hits":
        # the root's is served from the shard's candidates (the
        # executor), a bucket's by the refinement; elsewhere the
        # reference has no partial for it
        return ("top_hits",), {"size": torch.zeros((), device=device)}

    if kind == "weighted_avg":
        vspec, wspec = body.get("value", {}), body.get("weight", {})
        vcol = seg.f32_on(_resolve(vspec.get("field", ""), ctx), device)
        wcol = seg.f32_on(_resolve(wspec.get("field", ""), ctx), device)
        has_vm = vspec.get("missing") is not None
        has_wm = wspec.get("missing") is not None
        if (vcol is None and not has_vm) or (wcol is None and not has_wm):
            return ("wavg",), {"vwsum": torch.zeros((), device=device),
                               "wsum": torch.zeros((), device=device),
                               "count": torch.zeros((), dtype=torch.int64,
                                                    device=device)}
        none = (torch.zeros(seg.ndocs, dtype=torch.float32, device=device),
                torch.zeros(seg.ndocs, dtype=torch.bool, device=device))
        vw, ws, cnt = agg_ops.weighted_avg_agg(
            *(vcol or none), *(wcol or none), match,
            float(vspec.get("missing", 0.0) or 0.0),
            float(wspec.get("missing", 0.0) or 0.0), has_vm, has_wm)
        return ("wavg",), {"vwsum": vw, "wsum": ws, "count": cnt}

    if kind == "median_absolute_deviation":
        col = seg.f32_on(agg_field(node, ctx), device)
        return ("mad",), {"hist": torch.zeros(
            agg_ops.DD_NBINS, dtype=torch.int64, device=device)
            if col is None else agg_ops.ddsketch_hist(*col, match)}

    if kind == "matrix_stats":
        fields = tuple(body.get("fields", []))
        cols = [seg.f32_on(f, device) for f in fields]
        if not fields or any(c is None for c in cols):
            return ("matrix_stats", fields), {"count": torch.zeros(
                (), dtype=torch.int64, device=device)}
        shift = matrix_stats_shift(node, fields, ctx)
        out = agg_ops.matrix_stats_sums(cols, shift, match)
        return ("matrix_stats", fields, tuple(float(np.float32(x))
                                              for x in shift)), out

    if kind == "scripted_metric":
        # its map script runs per matched doc on the host (executor)
        return ("scripted",), {"match_mask": match}
    if kind in PIPELINE_KINDS:
        # a pipeline at the root: the reference's prepare refuses it
        raise ValueError(f"cannot prepare aggregation [{kind}]")
    raise NotPortedError(f"aggs: aggregation kind [{kind}]")


def _emit_nested_agg(node, seg: Segment, ctx: ShardContext,
                     match: torch.Tensor, device) -> tuple:
    """`nested`: the match moves into the path's child segment (a child
    counts where its parent matches) and the subs run there, with the
    level pushed on `ctx.nest_stack`; `reverse_nested` climbs the stack to
    its `path` (the root without one), a doc counting where any of its
    children does, and runs its subs at that level. The reference's 400s:
    a reverse_nested outside a nested agg, or to a path that is not an
    enclosing level above the current one."""
    body = node.body
    stack = ctx.nest_stack
    if node.kind == "nested":
        blk = seg.nested.get(body.get("path"))
        if blk is None or blk.child.ndocs == 0:
            return ("terms_missing",), None
        stack = stack or ((None, seg, None, seg.live_on(device)),)
        parent = blk.parent_on(device)
        live = blk.child.live_on(device) & stack[-1][3][parent]
        target, bm = blk.child, match[parent] & live
        stack = stack + ((body.get("path"), blk.child, parent, live),)
        kind = "nested_agg"
    else:
        if len(stack) < 2:
            raise dsl.QueryParseError("[reverse_nested] must be nested "
                                      "inside a [nested] aggregation")
        rpath = body.get("path")
        ti = 0 if rpath is None else next(
            (i for i, lvl in enumerate(stack) if lvl[0] == rpath), None)
        if ti is None:
            raise dsl.QueryParseError(
                f"[reverse_nested] path [{rpath}] is not an enclosing "
                f"nested level")
        if len(stack) - 1 - ti <= 0:
            raise dsl.QueryParseError("[reverse_nested] path must point "
                                      "above the current level")
        bm = match
        for lvl in range(len(stack) - 1, ti, -1):
            up = stack[lvl - 1]
            bm = (torch.zeros(up[1].ndocs, device=device).index_add(
                0, stack[lvl][2], bm.to(torch.float32)) > 0) & up[3]
        target = stack[ti][1]
        stack = stack[:ti + 1] if ti > 0 else ()
        kind = "reverse_nested"
    sctx = copy.copy(ctx)
    sctx.nest_stack = stack
    out = {"doc_count": bm.sum()}
    specs = []
    for i, sub in enumerate(node.subs):
        sspec, sout = emit_agg(sub, target, sctx, bm, device, None)
        specs.append(sspec)
        if sout:
            out[f"sub{i}"] = sout
    return (kind, target, tuple(specs)), out


def join_agg_match(node, seg: Segment, ctx: ShardContext,
                   device) -> Optional[torch.Tensor]:
    """bool[ndocs] of the docs a `children` / `parent` agg buckets over
    `seg`: the children of the parents the query matched, or the parents
    of the children it matched, over the whole shard through the join's
    slot pre-pass (run once per agg node); None without a join field. A
    relation that is no child relation is the reference's 400."""
    from . import join

    jf = ctx.mappings.join_field
    if jf is None:
        return None
    kind = node.kind
    relations = ctx.mappings.fields[jf].relations
    child_rel = node.body.get("type")
    parent_rel = next((p for p, cs in relations.items() if child_rel in cs),
                      None)
    if parent_rel is None:
        raise dsl.QueryParseError(
            f"[{kind}] [{child_rel}] is not a child relation of the join "
            f"field")
    ji = join.get_join_index(ctx.segments, jf)
    got = node.__dict__.get("join_pre")
    if got is None:
        rel = {r: _weighted_terms(jf, [name], [1.0], ctx, 1, "filter", 1.0)
               for r, name in (("child", child_rel), ("parent", parent_rel))}
        plan = LBool(musts=[ctx.current_lroot or LMatchAll()],
                     filters=[rel["parent" if kind == "children"
                                  else "child"]])
        got = node.__dict__["join_pre"] = (join.join_prepass(
            plan, ji, ("cnt",), ctx, device,
            self_slots=kind == "children")["cnt"], rel)
    g, rel = got
    live = seg.live_on(device)
    if kind == "children":
        pslot = ji.pslot_on(seg, device)
        return ((pslot >= 0) & (g[torch.clamp(pslot, 0, ji.gsize - 1)] > 0)
                & emit(rel["child"], seg, ctx, device).matched & live)
    base = ji.seg_base(seg)
    return ((g[base:base + seg.ndocs] > 0)
            & emit(rel["parent"], seg, ctx, device).matched & live)


def _emit_composite(node, seg: Segment, ctx: ShardContext,
                    match: torch.Tensor, device: torch.device,
                    stats_col) -> tuple:
    """A composite's combined ordinal of each matched doc over the
    product of its sources' value spaces (the reference's
    `_prepare_composite` with its emit): one bucket count over every
    composite bucket of the segment; the coordinator pages them. A
    terms source is the keyword's smallest ordinal (a multi-valued one
    alone is counted value by value), a histogram source floor(f32 /
    interval), a date_histogram source the date buckets; a doc lacking
    a source is in no bucket, with or without `missing_bucket` (which
    the reference does not read)."""
    from .aggregations import composite_sources

    sources = composite_sources(node)
    infos, ords = [], []
    for nm, stype, scfg, _order in sources:
        field = _resolve(scfg.get("field", ""), ctx)
        if stype == "terms":
            col = seg.keyword_cols.get(field)
            if col is None:
                return ("terms_missing",), None
            kw = seg.keyword_on(field, device)
            if keyword_multi_valued(seg, field):
                if len(sources) > 1:
                    raise dsl.QueryParseError(
                        "[composite] a multi-valued terms source cannot be "
                        "combined with other sources")
                nv = len(col.vocab)
                out = {"counts": agg_ops.terms_counts(kw, match, nv)}
                specs = []
                for i, sub in enumerate(node.subs):
                    scol = stats_col(sub)
                    specs.append(scol is not None)
                    if scol is not None:
                        out[f"sub{i}"] = agg_ops.terms_sub_metric(
                            kw, match, *scol, nv)
                return ("composite_mv", field, tuple(specs)), out
            infos.append(("terms", field, len(col.vocab), 0, 0.0, ""))
            ords.append(kw[2])
        elif stype == "histogram":
            interval = float(scfg["interval"])
            col = seg.numeric_cols.get(field)
            if col is None or not col.present.any():
                return ("terms_missing",), None
            mn, mx = col.min_max
            min_b = int(np.floor(mn / interval))
            nb = int(np.floor(mx / interval)) - min_b + 1
            infos.append(("hist", field, nb, min_b, interval, ""))
            ords.append(agg_ops.histogram_source_ords(
                *seg.f32_on(field, device), interval, min_b, nb))
        elif stype == "date_histogram":
            calendar = scfg.get("calendar_interval")
            interval_ms = 0 if calendar else parse_interval_ms(scfg.get(
                "fixed_interval", scfg.get("interval", "1d")))
            key = (field, max(interval_ms, 1), 0, calendar)
            ids, min_b, nb = host_date_buckets(seg, *key)
            if nb <= 0:
                return ("terms_missing",), None
            infos.append(("date", field, nb, min_b,
                          float(max(interval_ms, 1)), calendar or ""))
            ords.append(seg.device_cached(
                ("dbuckets",) + key, device,
                lambda ids=ids: torch.from_numpy(ids).to(device)))
        else:
            raise dsl.QueryParseError(
                f"[composite] unsupported source type [{stype}]")
    total = int(np.prod([max(i[2], 1) for i in infos], dtype=np.int64))
    if total > COMPOSITE_MAX_BUCKETS:
        raise dsl.QueryParseError(
            f"[composite] too many composite buckets [{total}] "
            f"(limit {COMPOSITE_MAX_BUCKETS})")
    b, total = agg_ops.composite_buckets(ords, [i[2] for i in infos], match)
    out = {"counts": agg_ops.bucket_counts(b, total)}
    specs = []
    for i, sub in enumerate(node.subs):
        scol = stats_col(sub)
        specs.append(scol is not None)
        if scol is not None:
            vals, present = scol
            sb = torch.where(present, b, torch.full_like(b, total))
            out[f"sub{i}"] = agg_ops.bucket_metrics(sb, total, vals)
    return ("composite", tuple(infos), total, tuple(specs)), out


# the reference's composite limit; below it its i32 combined ordinal
# cannot overflow
COMPOSITE_MAX_BUCKETS = 1 << 22


def keyword_multi_valued(seg: Segment, field: str) -> bool:
    """Whether a doc of the segment holds two values of a keyword field;
    cached per segment."""
    cache = seg.__dict__.setdefault("kw_multi", {})
    if field not in cache:
        col = seg.keyword_cols[field]
        cache[field] = bool(len(col.ords)) and int(
            np.max(np.diff(col.starts))) > 1
    return cache[field]


def auto_interval(col, target: int) -> int:
    """The smallest ladder interval that gives at most `target` buckets
    over a date column's span in the segment (the reference's
    `_auto_interval`)."""
    if col is None or not col.present.any():
        return AUTO_LADDER[0][0]
    mn, mx = col.min_max
    span = max(mx - mn, 1.0)
    for ms, _name in AUTO_LADDER:
        if span / ms <= target:
            return ms
    return AUTO_LADDER[-1][0]


def multi_terms_host(seg: Segment, ctx: ShardContext,
                     fields: Tuple[str, ...]) -> tuple:
    """(vocab of key tuples, combined ordinal i32[ndocs], -1 where a doc
    lacks a source) of a multi_terms source list over a segment (the
    reference's `_multi_terms_cache`): a keyword source's smallest
    ordinal, a numeric source's rank among its distinct values, mixed
    into one i64 and made dense by one host np.unique; cached per
    segment."""
    cache = seg.__dict__.setdefault("multi_terms", {})
    got = cache.get(fields)
    if got is not None:
        return got
    per_field = []
    for f in fields:
        f = _resolve(f, ctx)
        kcol = seg.keyword_cols.get(f)
        ncol = seg.numeric_cols.get(f)
        if kcol is not None:
            per_field.append((kcol.min_ord, list(kcol.vocab)))
        elif ncol is not None:
            cast = float if ncol.kind == "float" else int
            per_field.append((ncol.sort_ords(),
                              [cast(v) for v in ncol.distinct]))
        else:
            per_field.append((np.full(seg.ndocs, -1, np.int32), []))
    combined = np.zeros(seg.ndocs, np.int64)
    valid = np.ones(seg.ndocs, bool)
    mults = []
    mult = 1
    for ords, vocab in reversed(per_field):
        valid &= ords >= 0
        combined += np.maximum(ords, 0).astype(np.int64) * mult
        mults.append(mult)
        mult *= max(len(vocab), 1)
    mults.reverse()
    uniq, inv = np.unique(combined[valid], return_inverse=True)
    ords_out = np.full(seg.ndocs, -1, np.int32)
    ords_out[valid] = inv.reshape(-1).astype(np.int32)
    vocab_out = []
    for code in uniq.tolist():
        key = []
        for (_o, vocab), mm in zip(per_field, mults):
            idx, code = divmod(code, mm)
            key.append(vocab[idx] if idx < len(vocab) else None)
        vocab_out.append(tuple(key))
    cache[fields] = got = (vocab_out, ords_out)
    return got


def multi_terms_on(seg: Segment, ctx: ShardContext, fields: Tuple[str, ...],
                   device) -> tuple:
    vocab, ords = multi_terms_host(seg, ctx, fields)
    return vocab, seg.device_cached(("mterms", fields), device,
                                    lambda: torch.from_numpy(ords).to(device))


def diversity_ords(field: str, seg: Segment, ctx: ShardContext,
                   device) -> torch.Tensor:
    """i32[ndocs] a diversified_sampler's key: a keyword's smallest
    ordinal, a numeric field's rank, -1 (no key) without the field."""
    field = _resolve(field, ctx)
    if field in seg.keyword_cols:
        return seg.keyword_on(field, device)[2]
    if field in seg.numeric_cols:
        return seg.sort_ords_on(field, device)
    return torch.full((seg.ndocs,), -1, dtype=torch.int32, device=device)


def col_sum(seg: Segment, field: str) -> Tuple[float, int]:
    """(f64 sum, count) of a numeric column's present values, deleted
    docs included (the reference's `_col_sum`); cached per segment."""
    cache = seg.__dict__.setdefault("col_sums", {})
    if field not in cache:
        col = seg.numeric_cols.get(field)
        cache[field] = ((0.0, 0) if col is None or not col.present.any()
                        else (float(col.values[col.present].astype(
                            np.float64).sum()), int(col.present.sum())))
    return cache[field]


def matrix_stats_shift(node, fields: Tuple[str, ...],
                       ctx: ShardContext) -> np.ndarray:
    """f64[k] the index-wide mean of each field, the centre of the
    matrix_stats power sums (the reference's `_ms_shift`), once per
    agg node."""
    shift = getattr(node, "ms_shift", None)
    if shift is None:
        shift = np.zeros(len(fields), np.float64)
        for i, f in enumerate(fields):
            sums = [col_sum(s, f) for s in ctx.segments]
            cnt = sum(c for _, c in sums)
            shift[i] = sum(t for t, _ in sums) / cnt if cnt else 0.0
        node.ms_shift = shift
    return shift


def kw_doc_counts(seg: Segment, field: str) -> dict:
    """value -> live docs holding it (significant_terms' background),
    cached per segment and live generation."""
    cache = seg.__dict__.get("kw_doc_counts")
    if cache is None or cache.get("__gen") != seg.live_gen:
        cache = seg.__dict__["kw_doc_counts"] = {"__gen": seg.live_gen}
    if field not in cache:
        col = seg.keyword_cols.get(field)
        out: dict = {}
        if col is not None and len(col.vocab):
            counts = np.bincount(col.ords[seg.live[col.doc_of_value]],
                                 minlength=len(col.vocab))
            out = {col.vocab[i]: int(c) for i, c in enumerate(counts)
                   if c > 0}
        cache[field] = out
    return cache[field]


def run_agg_only(lroot: LNode, node, seg: Segment, ctx: ShardContext,
                 device: torch.device) -> tuple:
    """(spec, outputs as numpy) of one agg node over `lroot`'s live
    match in `seg`, without a top-k (the reference's `run_agg_only`:
    the sampler's shard-wide second pass)."""
    sm = emit(lroot, seg, ctx, device)
    spec, out = emit_agg(node, seg, ctx, sm.matched & seg.live_on(device),
                         device, sm.scores)
    return spec, fetch_tree(out, [])[1]
