"""Field mappings and document parsing (a copy of
opensearch_tpu/index/mappings.py without the derived and star_tree
fields, which raise `NotPortedError`).

Documents are parsed on the host into per-field term lists (text and
keyword), the token positions of text fields, keyword doc values (the
normalized values of keyword fields and subfields), numeric doc
values, stored values (`store: true`: the raw JSON values), feature
weights, dense vectors, geo points and geo shapes. The device only ever
sees term rows, positions, keyword ordinals, numeric columns, feature
postings, vector matrices and geo columns.

- Text: `text`, `match_only_text` (each distinct term once: no tf, no
  norms, no positions; phrases verify against `_source`) and
  `search_as_you_type` (its `_2gram` ... `_{max_shingle_size}gram`
  shingle subfields and an `_index_prefix` edge-ngram subfield) and
  `annotated_text` (`[text](value&value)` markup: the plain text is
  analyzed, each URL-decoded annotation value is an exact term at the
  position of the first token it covers, `parse_annotated_text`).
- Keyword: `keyword`, `ip` (a numeric column of the IPv4-mapped integer
  plus a term of its string), `constant_keyword` (one value, fixed by
  the mapping or by the first document, applied to every document) and
  `icu_collation_keyword` (collation sort keys, strength primary,
  secondary or tertiary), `flat_object` (every leaf value a term and a
  doc value of the field, each `path=value` one of `<field>#paths`; a
  dotted query path resolves to a synthetic keyword field with
  `flat_prefix`).
- Numeric, exact i64: integer, long, short, byte (range-checked),
  date (epoch millis), boolean (0/1), token_count (the analyzer's token
  count) and unsigned_long (`v - U64_BIAS`: order-exact biased i64);
  f64: double, float, half_float (no f16 rounding, as the reference),
  scaled_float (`round(v * scaling_factor) / scaling_factor`; the
  factor is required), rank_feature (positive).
- The range family (`integer_range`, `long_range`, `float_range`,
  `double_range`, `date_range`, `ip_range`): a `{gte|gt|lte|lt}` object
  as the closed [lo, hi] of the member type's column form, in the
  numeric columns `<field>#lo` and `<field>#hi` (an open bound one step
  or one f64 ulp inward, a missing bound the member's extreme).
- `geo_point` ({lat, lon}, "lat,lon" or GeoJSON [lon, lat]; the first
  point of a doc is its column value) and `geo_shape` (GeoJSON or WKT,
  parsed at index time by `search/geo.parse_shape`: a bad shape is a
  400; the specs and their bounding boxes are kept).
- `rank_features` / `sparse_vector` (feature -> positive weight),
  `dense_vector` / `knn_vector` (a list is ONE vector of `dims`), `binary`
  (kept in `_source` only) and `alias` (`path`: resolved by
  `resolve_field`).

Field parameters `store`, `copy_to`, `null_value` and `boost` are read as
the reference reads them. Dynamic fields follow the reference's rules:
the first `dynamic_templates` entry whose `match` (fnmatch on the last
path segment; its other conditions are not read, as in the reference)
fits gives the mapping, else strings map to text + a `.keyword` subfield
with ignore_above 256, ISO-date strings to `date`, JSON integers to
`long`, floats to `double` and booleans to `boolean`.

Document structure: a `nested` path's objects parse into child
documents of the enclosing one (`ParsedDocument.nested`: a deeper nested
path hangs off its child; `include_in_parent` / `include_in_root`, which
the reference does not read, raise NotPortedError); a `join` field (one
an index) indexes its relation as a term and a child's parent id on
`<field>#parent`, and a child without a routing is a 400; a
`percolator` field validates its stored query at index time and keeps
its pre-filter terms in the hidden keyword column `<field>#terms`
(`search/percolate.extract_index_terms`).

An IPv6 address outside ::ffff:0:0/96 has an integer past i64: the
reference accepts the document and then fails its refresh with an
OverflowError; the port refuses the document with a ValueError (400).
"""

from __future__ import annotations

import datetime as _dt
import fnmatch
import ipaddress
import math
import numbers
import re
import urllib.parse
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Tuple

from ..analysis import AnalysisRegistry, Analyzer
from ..errors import NotPortedError

TEXT_TYPES = {"text", "match_only_text", "search_as_you_type",
              "annotated_text"}
KEYWORD_TYPES = {"keyword", "ip", "constant_keyword", "flat_object",
                 "icu_collation_keyword"}
INT_TYPES = {"long", "integer", "short", "byte", "date", "boolean",
             "unsigned_long", "token_count"}
FLOAT_TYPES = {"double", "float", "half_float", "rank_feature",
               "scaled_float"}
NUMERIC_TYPES = INT_TYPES | FLOAT_TYPES
# range family: closed [lo, hi] interval columns `field#lo` / `field#hi`
# in the member type's column form, queried by relation
RANGE_TYPES = {"integer_range", "long_range", "float_range", "double_range",
               "date_range", "ip_range"}
RANGE_MEMBER = {"integer_range": "integer", "long_range": "long",
                "float_range": "float", "double_range": "double",
                "date_range": "date", "ip_range": "ip"}
GEO_TYPES = {"geo_point"}
SHAPE_TYPES = {"geo_shape"}
VECTOR_TYPES = {"dense_vector", "knn_vector"}
# feature-weight CSR fields: rows are features, the tf slot the weight
FEATURE_TYPES = {"rank_features", "sparse_vector"}
# kept in _source only
SOURCE_ONLY_TYPES = {"binary"}
# unsigned_long stores order-preserving BIASED i64 (v - 2^63) so 64-bit
# compares and sorts stay exact; the f32 view and the fetch unbias
U64_BIAS = 1 << 63
_INT_BITS = {"long": 63, "integer": 31, "short": 15, "byte": 7}
_FIELD_OPTIONS = {"type", "analyzer", "search_analyzer", "normalizer",
                  "index", "doc_values", "ignore_above", "norms", "fields",
                  "format", "positive_score_impact", "index_impacts",
                  "store", "copy_to", "null_value", "boost"}
# a vector field's own parameters (dims, similarity, ANN method)
_VECTOR_OPTIONS = {"dims", "dimension", "similarity", "space_type",
                   "method", "index_options"}
# a type's own parameters
_TYPE_OPTIONS = {
    "dense_vector": _VECTOR_OPTIONS, "knn_vector": _VECTOR_OPTIONS,
    "scaled_float": {"scaling_factor"},
    "constant_keyword": {"value"},
    "icu_collation_keyword": {"strength", "language", "country"},
    "search_as_you_type": {"max_shingle_size"},
    "geo_point": {"ignore_malformed", "ignore_z_value"},
    "geo_shape": {"ignore_malformed", "ignore_z_value", "orientation",
                  "coerce"},
    "flat_object": {"depth_limit"},
    **{t: {"coerce"} for t in RANGE_TYPES},
    "join": {"relations"},
}
# the document-structure types besides objects
STRUCTURE_TYPES = {"join", "percolator"}
# a nested object's options that the reference reads no further (it
# indexes children alone, where OpenSearch copies them into the parent)
_NESTED_UNREAD = ("include_in_parent", "include_in_root")
# types a JSON object (or an array of objects) is one value of
_OBJECT_VALUE_TYPES = GEO_TYPES | SHAPE_TYPES | RANGE_TYPES | {"flat_object"}
_MAPPING_KEYS = {"properties", "dynamic", "_meta", "dynamic_templates"}


@dataclass
class FieldType:
    name: str
    type: str
    analyzer: str = "standard"
    search_analyzer: Optional[str] = None
    normalizer: Optional[str] = None
    index: bool = True
    ignore_above: Optional[int] = None
    norms: bool = True
    doc_values: bool = True
    store: bool = False
    null_value: Any = None
    copy_to: List[str] = dc_field(default_factory=list)
    boost: float = 1.0
    date_format: Optional[str] = None
    subfields: Dict[str, "FieldType"] = dc_field(default_factory=dict)
    dims: int = 0                       # dense_vector dimension
    vector_similarity: str = "cosine"   # cosine | dot_product | l2_norm
    # ANN method: {"name": "ivf", "nlist": int|None, "nprobe": int|None},
    # or None for the exact scan (the default)
    vector_method: Optional[dict] = None
    # rank_feature(s): False flips the scoring functions
    positive_score_impact: bool = True
    # rank_features / sparse_vector: build a FEATURE impact plane
    index_impacts: bool = False
    # scaled_float: values quantize to round(v * f) / f
    scaling_factor: Optional[float] = None
    # constant_keyword: the index-wide value (from the mapping, or the
    # first document that sets it)
    const_value: Optional[str] = None
    # the synthetic keyword field of a flat_object leaf path: its query
    # terms are "<flat_prefix>=<value>" on `<root>#paths`
    flat_prefix: Optional[str] = None
    # join: {"parent_relation": ["child_relation", ...]}
    relations: Dict[str, List[str]] = dc_field(default_factory=dict)

    @property
    def has_norms(self) -> bool:
        return self.type in TEXT_TYPES and self.norms and \
            self.type != "match_only_text"


@dataclass
class ParsedDocument:
    """Index-ready view of one document: field -> analyzed terms (text:
    tokens incl. duplicates for tf; keyword: normalized exact values)."""

    doc_id: str
    source: dict
    routing: Optional[str]
    terms: Dict[str, List[str]] = dc_field(default_factory=dict)
    # field -> numeric values (the segment's column keeps the first)
    numerics: Dict[str, List[Any]] = dc_field(default_factory=dict)
    # keyword field -> its doc values (terms aggs read them)
    keywords: Dict[str, List[str]] = dc_field(default_factory=dict)
    # text field -> (term, position) per token, in token order; the
    # values of an array field are 100 positions apart
    positions: Dict[str, List[Tuple[str, int]]] = dc_field(
        default_factory=dict)
    # vector field -> its one vector
    vectors: Dict[str, List[float]] = dc_field(default_factory=dict)
    # feature field -> {feature: weight}
    features: Dict[str, Dict[str, float]] = dc_field(default_factory=dict)
    # store: true field -> its raw JSON values
    stored: Dict[str, list] = dc_field(default_factory=dict)
    # geo_point field -> (lat, lon) per value
    geos: Dict[str, List[Tuple[float, float]]] = dc_field(
        default_factory=dict)
    # geo_shape field -> (spec, bbox) per value
    shapes: Dict[str, List[Any]] = dc_field(default_factory=dict)
    # nested path -> its objects, each a child document (its fields keep
    # their full dotted paths; a deeper nested path hangs off its child)
    nested: Dict[str, List["ParsedDocument"]] = dc_field(
        default_factory=dict)


_ANNOT_RE = re.compile(r"\[([^\]]*)\]\(([^)]+)\)")


def parse_annotated_text(raw: str):
    """-> (plain text, [(char start, char end, [annotation values])]):
    `[text](value1&value2)` markup, the covered text kept in the plain
    stream, each `&`-separated value URL-decoded."""
    plain_parts = []
    spans = []
    pos = 0
    last = 0
    for m in _ANNOT_RE.finditer(raw):
        plain_parts.append(raw[last:m.start()])
        pos += m.start() - last
        text = m.group(1)
        anns = [urllib.parse.unquote(a) for a in m.group(2).split("&") if a]
        spans.append((pos, pos + len(text), anns))
        plain_parts.append(text)
        pos += len(text)
        last = m.end()
    plain_parts.append(raw[last:])
    return "".join(plain_parts), spans


def _parse_date(value: Any, fmt: Optional[str]) -> int:
    """A date as epoch millis (the reference's DateFieldMapper parse;
    default format `strict_date_optional_time||epoch_millis`)."""
    if isinstance(value, bool):
        raise ValueError(f"cannot parse date from boolean [{value}]")
    if isinstance(value, numbers.Number):
        return int(value)
    s = str(value).strip()
    if fmt == "epoch_second":
        return int(float(s) * 1000)
    if s.isdigit() or (s[:1] == "-" and s[1:].isdigit()):
        return int(s)
    try:
        dt = _dt.datetime.fromisoformat(s.replace("Z", "+00:00"))
    except ValueError:
        for f in ("%Y/%m/%d", "%Y/%m/%d %H:%M:%S", "%d-%m-%Y", "%m/%d/%Y"):
            try:
                dt = _dt.datetime.strptime(s, f)
                break
            except ValueError:
                continue
        else:
            raise ValueError(f"failed to parse date field [{s}]")
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return int(dt.timestamp() * 1000)


def ip_to_int(value: str) -> int:
    """An IP as an integer, v4 mapped into v6 space (Lucene
    InetAddressPoint), as the reference's `_ip_to_int`."""
    ip = ipaddress.ip_address(value)
    if isinstance(ip, ipaddress.IPv4Address):
        ip = ipaddress.IPv6Address(f"::ffff:{value}")
    return int(ip)


def int_to_ip(v: int) -> str:
    """The address of an `ip` column value: dotted IPv4 inside
    ::ffff:0:0/96, else the IPv6 form."""
    ip = ipaddress.IPv6Address(int(v))
    return str(ip.ipv4_mapped) if ip.ipv4_mapped is not None else str(ip)


def coerce_value(ft: "FieldType", value: Any):
    """A raw JSON value as its column value, as the reference's
    coerce_value: epoch millis for a date, 0/1 for a boolean, the
    IPv4-mapped integer for an ip, v - 2^63 for an unsigned_long, a
    range-checked int for the rest of the long family, a float for the
    float family (scaled_float rounded to its factor)."""
    t = ft.type
    if t == "date":
        return _parse_date(value, ft.date_format)
    if t == "boolean":
        if isinstance(value, str):
            if value in ("true", "True"):
                return 1
            if value in ("false", "False", ""):
                return 0
            raise ValueError(f"cannot parse boolean [{value}]")
        return 1 if bool(value) else 0
    if t == "ip":
        return ip_to_int(str(value))
    if t == "unsigned_long":
        iv = int(value)
        if not 0 <= iv < (1 << 64):
            raise ValueError(
                f"value [{value}] out of range for field type [unsigned_long]")
        return iv - U64_BIAS
    if t in INT_TYPES:
        iv = int(value)
        bits = _INT_BITS.get(t, 63)
        if not (-(1 << bits)) <= iv < (1 << bits):
            raise ValueError(f"value [{value}] out of range for field type "
                             f"[{t}]")
        return iv
    if t == "scaled_float":
        sf = ft.scaling_factor or 1.0
        return round(float(value) * sf) / sf
    if t in FLOAT_TYPES:
        fv = float(value)
        if t == "rank_feature" and fv <= 0:
            raise ValueError(
                f"[rank_feature] fields must hold positive values, got [{fv}]")
        return fv
    raise ValueError(f"cannot coerce for type [{t}]")


def _vector_method(path: str, cfg: dict) -> Optional[dict]:
    """A vector field's `method` / `index_options` as the reference
    normalizes it: {"name": "ivf", "nlist", "nprobe"} (from `parameters`
    or the method itself), None for `flat` / `exact` or no method; any
    other name is its ValueError."""
    method = cfg.get("method") or cfg.get("index_options")
    if not method:
        return None
    name = method.get("name", method.get("type", "ivf"))
    if name not in ("ivf", "flat", "exact"):
        raise ValueError(f"unknown ANN method [{name}] for field [{path}] "
                         f"(supported: ivf, flat)")
    if name != "ivf":
        return None
    p = method.get("parameters", method)
    return {"name": "ivf",
            "nlist": int(p["nlist"]) if p.get("nlist") else None,
            "nprobe": int(p["nprobe"]) if p.get("nprobe") else None}


class Mappings:
    """Per-index mappings with dynamic mapping for strings."""

    def __init__(self, mapping: dict | None = None,
                 analysis: AnalysisRegistry | None = None,
                 dynamic: bool | str = True):
        self.analysis = analysis or AnalysisRegistry()
        self.fields: Dict[str, FieldType] = {}
        self.aliases: Dict[str, str] = {}
        self.dynamic = dynamic
        self.dynamic_templates: List[dict] = []
        self._meta: dict = {}
        self.nested_paths: set = set()
        self.join_field: Optional[str] = None    # at most one an index
        if mapping:
            self.merge(mapping)

    def merge(self, mapping: dict) -> None:
        for key in mapping:
            if key not in _MAPPING_KEYS:
                raise NotPortedError(f"mapping parameter [{key}]")
        if "dynamic" in mapping:
            self.dynamic = mapping["dynamic"]
        self._meta.update(mapping.get("_meta", {}))
        self.dynamic_templates.extend(mapping.get("dynamic_templates", []))
        self._merge_props(mapping.get("properties", {}), prefix="")

    def _merge_props(self, props: dict, prefix: str) -> None:
        for name, cfg in props.items():
            path = f"{prefix}{name}"
            ftype = cfg.get("type", "object" if "properties" in cfg else "text")
            if ftype == "alias":
                self.aliases[path] = cfg["path"]
                continue
            if ftype in ("object", "nested"):
                if ftype == "nested":
                    for key in _NESTED_UNREAD:
                        if cfg.get(key):
                            raise NotPortedError(
                                f"field parameter [{key}] (field [{path}])")
                    self.nested_paths.add(path)
                self._merge_props(cfg.get("properties", {}), prefix=f"{path}.")
                continue
            self.fields[path] = self._build_field(path, ftype, cfg)
            if ftype == "join":
                if self.join_field is not None and self.join_field != path:
                    raise ValueError(
                        f"only one [join] field can be defined per index, "
                        f"found [{self.join_field}] and [{path}]")
                self.join_field = path

    def _build_field(self, path: str, ftype: str, cfg: dict) -> FieldType:
        if ftype not in TEXT_TYPES | KEYWORD_TYPES | NUMERIC_TYPES \
                | VECTOR_TYPES | FEATURE_TYPES | SOURCE_ONLY_TYPES \
                | RANGE_TYPES | GEO_TYPES | SHAPE_TYPES | STRUCTURE_TYPES:
            raise NotPortedError(f"field type [{ftype}] (field [{path}])")
        allowed = _FIELD_OPTIONS | _TYPE_OPTIONS.get(ftype, set())
        for key in cfg:
            if key not in allowed:
                raise NotPortedError(f"field parameter [{key}] (field [{path}])")
        normalizer = cfg.get("normalizer")
        if ftype == "icu_collation_keyword":
            # values index and doc-value as collation sort keys
            strength = cfg.get("strength", "tertiary")
            if strength not in ("primary", "secondary", "tertiary"):
                raise ValueError(
                    f"[icu_collation_keyword] field [{path}]: unsupported "
                    f"strength [{strength}] (supported: primary, "
                    f"secondary, tertiary)")
            normalizer = f"_icu_collation:{strength}"
        copy_to = cfg.get("copy_to", [])
        ft = FieldType(
            name=path, type=ftype,
            analyzer=cfg.get("analyzer", "standard"),
            search_analyzer=cfg.get("search_analyzer"),
            normalizer=normalizer,
            index=cfg.get("index", True),
            ignore_above=cfg.get("ignore_above"),
            norms=cfg.get("norms", True),
            doc_values=cfg.get("doc_values", True),
            store=cfg.get("store", False),
            null_value=cfg.get("null_value"),
            copy_to=list(copy_to if isinstance(copy_to, list)
                         else [copy_to]),
            boost=cfg.get("boost", 1.0),
            date_format=cfg.get("format"),
            dims=int(cfg.get("dims", cfg.get("dimension", 0))),
            vector_similarity=cfg.get("similarity",
                                      cfg.get("space_type", "cosine")))
        if ftype in VECTOR_TYPES:
            ft.vector_method = _vector_method(path, cfg)
        if ftype == "join":
            ft.relations = {p: (c if isinstance(c, list) else [c])
                            for p, c in cfg.get("relations", {}).items()}
        ft.positive_score_impact = bool(cfg.get("positive_score_impact",
                                                True))
        if "index_impacts" in cfg:
            if ftype not in FEATURE_TYPES:
                raise ValueError(
                    f"Field [{path}]: [index_impacts] only applies to "
                    f"rank_features/sparse_vector fields")
            ft.index_impacts = bool(cfg["index_impacts"])
        if ftype == "scaled_float":
            if "scaling_factor" not in cfg:
                raise ValueError(
                    f"Field [{path}] misses required parameter "
                    f"[scaling_factor]")
            ft.scaling_factor = float(cfg["scaling_factor"])
        if ftype == "constant_keyword" and cfg.get("value") is not None:
            ft.const_value = str(cfg["value"])
        if ftype == "search_as_you_type":
            # the main field, shingle subfields and an edge-ngram prefix
            # field for bool_prefix (OpenSearch SearchAsYouTypeFieldMapper)
            shingles = int(cfg.get("max_shingle_size", 3))
            self.analysis.ensure_sayt_chains(shingles)
            for n in range(2, shingles + 1):
                ft.subfields[f"_{n}gram"] = FieldType(
                    name=f"{path}._{n}gram", type="text",
                    analyzer=f"__sayt_{n}gram")
            ft.subfields["_index_prefix"] = FieldType(
                name=f"{path}._index_prefix", type="text",
                analyzer="__sayt_prefix",
                search_analyzer=cfg.get("analyzer", "standard"))
        for sub, subcfg in cfg.get("fields", {}).items():
            if ftype == "search_as_you_type" and sub in ft.subfields:
                # the mapping `to_dict` persists names the generated
                # subfields by type alone: a recovery keeps the chains
                continue
            ft.subfields[sub] = self._build_field(
                f"{path}.{sub}", subcfg.get("type", "keyword"), subcfg)
        return ft

    def to_dict(self) -> dict:
        """The mapping as the reference's `Mappings.to_dict` renders it
        (get_mapping, indices.get): each field's type, a text field's
        analyzer other than standard, an icu_collation_keyword's
        strength, a normalizer, `index: false`, the subfields' types,
        object paths as nested properties, `_meta`."""
        props: dict = {}
        for path, ft in self.fields.items():
            node = props
            parts = path.split(".")
            skip = False
            for p in parts[:-1]:
                if ".".join(parts[:parts.index(p) + 1]) in self.fields:
                    skip = True   # a dotted subfield of a mapped field
                    break
                node = node.setdefault(p, {}).setdefault("properties", {})
            if skip:
                continue
            d: dict = {"type": ft.type}
            if ft.relations:
                d["relations"] = ft.relations
            if ft.type == "text" and ft.analyzer != "standard":
                d["analyzer"] = ft.analyzer
            if ft.type == "icu_collation_keyword":
                d["strength"] = (ft.normalizer or "_icu_collation:tertiary"
                                 ).split(":", 1)[1]
            elif ft.normalizer:
                d["normalizer"] = ft.normalizer
            if not ft.index:
                d["index"] = False
            if ft.subfields:
                d["fields"] = {s: {"type": sf.type}
                               for s, sf in ft.subfields.items()}
            node[parts[-1]] = d
        for npath in sorted(self.nested_paths):
            parts = npath.split(".")
            node = props
            for p in parts[:-1]:
                node = node.setdefault(p, {}).setdefault("properties", {})
            node.setdefault(parts[-1], {})["type"] = "nested"
        out: dict = {"properties": props}
        if self._meta:
            out["_meta"] = self._meta
        return out

    # ---------------- field resolution ----------------

    def resolve_field(self, name: str) -> Optional[FieldType]:
        name = self.aliases.get(name, name)
        ft = self.fields.get(name)
        if ft is not None:
            return ft
        if "." in name:   # multi-field lookup: "title.keyword"
            parent, sub = name.rsplit(".", 1)
            parent = self.aliases.get(parent, parent)
            pft = self.fields.get(parent)
            if pft and sub in pft.subfields:
                return pft.subfields[sub]
            # a flat_object leaf: "f.a.b" is the term "a.b=<v>" on
            # "f#paths"
            parts = name.split(".")
            for i in range(1, len(parts)):
                rft = self.fields.get(".".join(parts[:i]))
                if rft is not None and rft.type == "flat_object":
                    return FieldType(name=f"{'.'.join(parts[:i])}#paths",
                                     type="keyword",
                                     flat_prefix=".".join(parts[i:]))
        return None

    def index_analyzer(self, ft: FieldType) -> Analyzer:
        if ft.type in KEYWORD_TYPES:
            return self.analysis.normalizer(ft.normalizer)
        return self.analysis.get(ft.analyzer)

    def search_analyzer_for(self, ft: FieldType) -> Analyzer:
        if ft.type in KEYWORD_TYPES:
            return self.analysis.normalizer(ft.normalizer)
        return self.analysis.get(ft.search_analyzer or ft.analyzer)

    # ---------------- dynamic mapping ----------------

    def _dynamic_type(self, path: str, value: Any) -> FieldType:
        for tmpl in self.dynamic_templates:
            rule = next(iter(tmpl.values()))
            if fnmatch.fnmatch(path.split(".")[-1], rule.get("match", "*")):
                cfg = dict(rule.get("mapping", {}))
                return self._build_field(path, cfg.get("type", "text"), cfg)
        if isinstance(value, bool):
            return self._build_field(path, "boolean", {})
        if isinstance(value, int):
            return self._build_field(path, "long", {})
        if isinstance(value, float):
            return self._build_field(path, "double", {})
        if isinstance(value, str):
            try:   # the reference's ISO date detection
                _dt.datetime.fromisoformat(value.replace("Z", "+00:00"))
            except ValueError:
                return self._build_field(
                    path, "text", {"fields": {"keyword": {
                        "type": "keyword", "ignore_above": 256}}})
            return self._build_field(path, "date", {})
        raise NotPortedError(
            f"dynamic value of type [{type(value).__name__}] (field [{path}])")

    # ---------------- document parsing ----------------

    def parse(self, doc_id: str, source: dict,
              routing: Optional[str] = None) -> ParsedDocument:
        parsed = ParsedDocument(doc_id=doc_id, source=source, routing=routing)
        self._parse_obj(source, "", parsed)
        # a constant_keyword applies to every document once its value is
        # known
        for ft in self.fields.values():
            if ft.type == "constant_keyword" and ft.const_value is not None:
                parsed.terms.setdefault(ft.name, []).append(ft.const_value)
                parsed.keywords.setdefault(ft.name, []).append(
                    ft.const_value)
        return parsed

    def _parse_obj(self, obj: dict, prefix: str, parsed: ParsedDocument) -> None:
        for key, value in obj.items():
            path = f"{prefix}{key}"
            if path in self.nested_paths:
                self._parse_nested(path, value, parsed)
                continue
            if isinstance(value, dict):
                ft = self.resolve_field(path)
                if ft is not None and (ft.type in FEATURE_TYPES
                                       or ft.type in _OBJECT_VALUE_TYPES
                                       or ft.type in STRUCTURE_TYPES):
                    self._index_value(ft, value, parsed)
                else:
                    self._parse_obj(value, f"{path}.", parsed)
                continue
            values = value if isinstance(value, list) else [value]
            if values and all(isinstance(v, dict) for v in values):
                lft = self.resolve_field(path)
                if lft is not None and lft.type in FEATURE_TYPES:
                    raise ValueError(
                        f"[{lft.type}] field [{path}] does not support "
                        f"arrays of feature objects")
                if lft is not None and lft.type in _OBJECT_VALUE_TYPES:
                    for v in values:
                        self._index_value(lft, v, parsed)
                    continue
                for v in values:
                    self._parse_obj(v, f"{path}.", parsed)
                continue
            ft = self.resolve_field(path)
            if ft is None:
                if self.dynamic in (False, "false"):
                    continue
                if self.dynamic == "strict":
                    raise ValueError(
                        f"strict_dynamic_mapping_exception: [{path}] not allowed")
                sample = next((v for v in values if v is not None), None)
                if sample is None:
                    continue
                ft = self._dynamic_type(path, sample)
                self.fields[path] = ft
            self._index_value(ft, value, parsed)

    def _parse_nested(self, path: str, value: Any,
                      parsed: ParsedDocument) -> None:
        """Each object of a nested path is a child document of the
        nearest enclosing document (a null is missing); a non-object
        value is the reference's 400."""
        if value is None:
            return
        bucket = parsed.nested.setdefault(path, [])
        for child_obj in (value if isinstance(value, list) else [value]):
            if child_obj is None:
                continue
            if not isinstance(child_obj, dict):
                raise ValueError(f"object mapping for [{path}] tried to "
                                 f"parse a non-object value")
            child = ParsedDocument(
                doc_id=f"{parsed.doc_id}#{path}#{len(bucket)}",
                source=child_obj, routing=None)
            bucket.append(child)
            self._parse_obj(child_obj, f"{path}.", child)

    def _index_value(self, ft: FieldType, value: Any,
                     parsed: ParsedDocument) -> None:
        if (ft.type in GEO_TYPES and isinstance(value, list) and value
                and isinstance(value[0], numbers.Number)):
            value = [value]     # GeoJSON [lon, lat] is one point
        if ft.type in VECTOR_TYPES and isinstance(value, list):
            value = [value]     # the whole list is ONE vector value
        values = value if isinstance(value, list) else [value]
        for v in values:
            if v is None:
                v = ft.null_value
                if v is None:
                    continue
            self._index_single(ft, v, parsed)
        for sub in ft.subfields.values():
            self._index_value(sub, value, parsed)
        for target in ft.copy_to:
            tft = self.resolve_field(target)
            if tft is None:
                tft = self._dynamic_type(target, values[0] if values else "")
                self.fields[target] = tft
            self._index_value(tft, value, parsed)

    def _index_single(self, ft: FieldType, v: Any,
                      parsed: ParsedDocument) -> None:
        name = ft.name
        if ft.store:
            parsed.stored.setdefault(name, []).append(v)
        if ft.type == "percolator":
            self._index_percolator(ft, v, parsed)
            return
        if ft.type == "join":
            self._index_join(ft, v, parsed)
            return
        if ft.type in TEXT_TYPES:
            if not ft.index:
                return
            raw_text, annot_spans = str(v), []
            if ft.type == "annotated_text":
                raw_text, annot_spans = parse_annotated_text(raw_text)
            tokens = self.index_analyzer(ft).analyze(raw_text)
            tl = parsed.terms.setdefault(name, [])
            if ft.type == "match_only_text":
                # no freqs, no norms, no positions: each term once
                seen = set(tl)
                for t in tokens:
                    if t.text not in seen:
                        tl.append(t.text)
                        seen.add(t.text)
                return
            tl.extend(t.text for t in tokens)
            pl = parsed.positions.setdefault(name, [])
            # the position gap between the values of an array field (an
            # annotation term may sit below the value's last position)
            base = max(p for _, p in pl) + 100 if pl else 0
            pl.extend((t.text, base + t.position) for t in tokens)
            for cs, ce, anns in annot_spans:
                # each value an exact term at the first covered token
                tok = next((t for t in tokens
                            if cs <= t.start_offset < ce), None)
                at_pos = base + (tok.position if tok else 0)
                for a in anns:
                    tl.append(a)
                    pl.append((a, at_pos))
            return
        if ft.type in SOURCE_ONLY_TYPES:
            return
        if ft.type == "token_count":
            tokens = self.analysis.get(ft.analyzer).analyze(str(v))
            parsed.numerics.setdefault(name, []).append(len(tokens))
            return
        if ft.type == "constant_keyword":
            s = str(v)
            if ft.const_value is None:
                ft.const_value = s      # the first value fixes it
            elif s != ft.const_value:
                raise ValueError(
                    f"[constant_keyword] field [{name}] only accepts value "
                    f"[{ft.const_value}], got [{s}]")
            return                      # indexed for every doc in parse()
        if ft.type == "ip":
            iv = coerce_value(ft, v)
            if iv >= 1 << 63:
                raise ValueError(
                    f"ip field [{name}]: [{v}] lies outside ::ffff:0:0/96 "
                    f"and does not fit the i64 column")
            parsed.numerics.setdefault(name, []).append(iv)
            if ft.index:
                parsed.terms.setdefault(name, []).append(str(v))
            return
        if ft.type in NUMERIC_TYPES:
            parsed.numerics.setdefault(name, []).append(coerce_value(ft, v))
            return
        if ft.type == "flat_object":
            # every leaf a term and doc value of the field, and its
            # "path=value" a term and doc value of `name#paths`
            if not isinstance(v, dict):
                raise ValueError(
                    f"[flat_object] field [{name}] must hold an object")
            for sub_path, leaf in _flat_leaves(v, ""):
                s = str(leaf)
                parsed.terms.setdefault(name, []).append(s)
                parsed.keywords.setdefault(name, []).append(s)
                parsed.terms.setdefault(f"{name}#paths", []).append(
                    f"{sub_path}={s}")
                parsed.keywords.setdefault(f"{name}#paths", []).append(
                    f"{sub_path}={s}")
            return
        if ft.type in RANGE_TYPES:
            lo, hi = parse_range_value(ft, v)
            if lo > hi:
                raise ValueError(
                    f"[{ft.type}] field [{name}]: lower bound [{lo}] > "
                    f"upper bound [{hi}]")
            parsed.numerics.setdefault(f"{name}#lo", []).append(lo)
            parsed.numerics.setdefault(f"{name}#hi", []).append(hi)
            return
        if ft.type in GEO_TYPES:
            parsed.geos.setdefault(name, []).append(parse_geo(v))
            return
        if ft.type in SHAPE_TYPES:
            from ..search.geo import parse_shape
            sh = parse_shape(v)     # a bad shape is an index-time 400
            parsed.shapes.setdefault(name, []).append((v, sh.bbox))
            return
        if ft.type in FEATURE_TYPES:
            if not isinstance(v, dict):
                raise ValueError(
                    f"[{ft.type}] field [{name}] must hold an object of "
                    f"feature weights")
            bucket = parsed.features.setdefault(name, {})
            for feat, w in v.items():
                w = float(w)
                if w <= 0:
                    raise ValueError(
                        f"[{ft.type}] weights must be positive, got "
                        f"[{feat}]={w}")
                bucket[str(feat)] = w
            return
        if ft.type in VECTOR_TYPES:
            vec = [float(x) for x in (v if isinstance(v, list) else [v])]
            if ft.dims and len(vec) != ft.dims:
                raise ValueError(
                    f"vector length [{len(vec)}] differs from mapped dims "
                    f"[{ft.dims}] for field [{name}]")
            parsed.vectors[name] = vec
            return
        s = str(v)      # keyword, icu_collation_keyword
        if ft.ignore_above is not None and len(s) > ft.ignore_above:
            return
        norm = self.index_analyzer(ft).terms(s)
        s = norm[0] if norm else s
        if ft.index:
            parsed.terms.setdefault(name, []).append(s)
        if ft.doc_values:
            parsed.keywords.setdefault(name, []).append(s)

    def _index_percolator(self, ft: FieldType, v: Any,
                          parsed: ParsedDocument) -> None:
        """A stored query, validated now (a bad one is the reference's
        400) and kept in `_source`; its pre-filter terms ("field\0term")
        become the hidden keyword column `<field>#terms`, and a query
        without a necessary term the `<field>#flags` value "any"."""
        if not isinstance(v, dict):
            raise ValueError(
                f"percolator field [{ft.name}] must hold a query object")
        from ..search.percolate import extract_index_terms
        from ..search.query_dsl import QueryParseError
        try:
            terms, always = extract_index_terms(v, self)
        except QueryParseError as e:
            raise ValueError(f"percolator query is invalid: {e}")
        if terms:
            parsed.keywords.setdefault(f"{ft.name}#terms", []).extend(terms)
        if always:
            parsed.keywords.setdefault(f"{ft.name}#flags", []).append("any")

    def _index_join(self, ft: FieldType, v: Any,
                    parsed: ParsedDocument) -> None:
        """A join value: the relation's name, or {"name", "parent"} for
        a child, which must carry a routing. The relation is a term and
        a doc value of the field, a child's parent id one of
        `<field>#parent`."""
        name = ft.name
        if isinstance(v, str):
            rel, parent = v, None
        elif isinstance(v, dict):
            rel, parent = v.get("name"), v.get("parent")
        else:
            raise ValueError(f"cannot parse join field value [{v}]")
        child_rels = {c for cs in ft.relations.values() for c in cs}
        if rel not in set(ft.relations) | child_rels:
            raise ValueError(f"unknown join name [{rel}] for field [{name}]")
        if rel in child_rels:
            if parent is None:
                raise ValueError(
                    f"[parent] is missing for join field [{name}] "
                    f"child relation [{rel}]")
            if parsed.routing is None:
                raise ValueError(
                    "[routing] is missing for a doc with a child join "
                    f"relation [{rel}]")
            parsed.terms.setdefault(f"{name}#parent", []).append(str(parent))
            parsed.keywords.setdefault(f"{name}#parent", []).append(
                str(parent))
        parsed.terms.setdefault(name, []).append(rel)
        parsed.keywords.setdefault(name, []).append(rel)


def _flat_leaves(obj: dict, prefix: str):
    """Depth-first (path, scalar) leaves of a flat_object value."""
    for k, v in obj.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flat_leaves(v, f"{path}.")
        elif isinstance(v, list):
            for item in v:
                if isinstance(item, dict):
                    yield from _flat_leaves(item, f"{path}.")
                elif item is not None:
                    yield path, item
        elif v is not None:
            yield path, v


_RANGE_INT_BOUNDS = {
    "integer": (-(1 << 31), (1 << 31) - 1),
    "long": (-(1 << 63), (1 << 63) - 1),
    "date": (-(1 << 63), (1 << 63) - 1),
    "ip": (0, (1 << 63) - 1),
}


def range_member_coerce(member: str, value: Any, ft: FieldType):
    """One bound of a range value in the member type's column form: a
    date in epoch ms (the field's format), an ip as its i64 integer
    (IPv4-mapped only), an integer or long as int, else a float."""
    if member == "date":
        return _parse_date(value, ft.date_format)
    if member == "ip":
        iv = ip_to_int(str(value))
        if iv >= (1 << 63):
            raise ValueError(
                "ip_range supports IPv4(-mapped) addresses only in this "
                "engine (value exceeds the exact i64 column range)")
        return iv
    if member in ("integer", "long"):
        return int(value)
    return float(value)


def parse_range_value(ft: FieldType, v: Any) -> Tuple[Any, Any]:
    """{gte|gt|lte|lt} -> the closed [lo, hi] in column form: an open
    bound moves one step (integers) or one f64 ulp (floats) inward, a
    missing one is the member's extreme (+-inf for floats)."""
    if not isinstance(v, dict):
        raise ValueError(
            f"[{ft.type}] field [{ft.name}] must hold a range object")
    member = RANGE_MEMBER[ft.type]
    is_int = member in _RANGE_INT_BOUNDS
    lo, hi = (_RANGE_INT_BOUNDS[member] if is_int
              else (-math.inf, math.inf))
    for key, val in v.items():
        if val is None:
            continue
        cv = range_member_coerce(member, val, ft)
        if key == "gte":
            lo = cv
        elif key == "gt":
            lo = cv + 1 if is_int else math.nextafter(cv, math.inf)
        elif key == "lte":
            hi = cv
        elif key == "lt":
            hi = cv - 1 if is_int else math.nextafter(cv, -math.inf)
        else:
            raise ValueError(f"unknown range bound [{key}]")
    return lo, hi


def parse_geo(v: Any) -> Tuple[float, float]:
    """(lat, lon) of a geo_point value: {"lat", "lon"}, "lat,lon" or
    GeoJSON [lon, lat]."""
    if isinstance(v, dict):
        return float(v["lat"]), float(v["lon"])
    if isinstance(v, str):
        lat, lon = v.split(",")
        return float(lat), float(lon)
    if isinstance(v, (list, tuple)):
        return float(v[1]), float(v[0])
    raise ValueError(f"cannot parse geo_point [{v}]")
