"""Field mappings and document parsing (the text, keyword, integer,
long, date, boolean, double, float, rank_feature, rank_features /
sparse_vector and dense vector subset of
opensearch_tpu/index/mappings.py).

Documents are parsed on the host into per-field term lists (text and
keyword), the token positions of text fields, keyword doc values (the
normalized values of keyword fields and subfields), numeric doc
values (integer, long, date (epoch millis) and boolean (0/1) as exact
i64, double, float and rank_feature as f64; a rank_feature value must
be positive), feature weights (`rank_features` / `sparse_vector`: an
object of feature -> positive weight, kept per doc in
`ParsedDocument.features`; `positive_score_impact` flips the
rank_feature functions, `index_impacts` asks for a codec-v2 FEATURE
impact plane and is a ValueError on any other type) and dense vectors
(`dense_vector` /
`knn_vector`: a list is ONE vector, whose length must equal the mapped
`dims`). The device only ever sees term rows, positions, keyword
ordinals, numeric columns, feature postings and vector matrices. A vector field's
`similarity` / `space_type` is kept as given (`cosine`, `dot_product` /
`innerproduct`; any other name scores as L2, as in the reference), and
its `method` / `index_options` normalize to the reference's
{"name": "ivf", "nlist", "nprobe"} or None (`flat`, `exact`: the scan). Explicit and dynamic
fields are served with the reference's dynamic rules: strings map to text
+ a `.keyword` subfield with ignore_above 256, ISO-date strings to
`date`, JSON integers to `long`, floats to `double` and booleans to
`boolean`. Every other field type, mapping option, dynamic template or
dynamic value type raises `NotPortedError`.
"""

from __future__ import annotations

import datetime as _dt
import numbers
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Tuple

from ..analysis import AnalysisRegistry, Analyzer
from ..errors import NotPortedError

TEXT_TYPES = {"text"}
KEYWORD_TYPES = {"keyword"}
# the ported subset of the reference's long family (exact i64 doc values:
# dates as epoch millis, booleans as 0/1) and of its float family (f64)
INT_TYPES = {"integer", "long", "date", "boolean"}
FLOAT_TYPES = {"double", "float", "rank_feature"}
NUMERIC_TYPES = INT_TYPES | FLOAT_TYPES
VECTOR_TYPES = {"dense_vector", "knn_vector"}
# feature-weight CSR fields: rows are features, the tf slot the weight
FEATURE_TYPES = {"rank_features", "sparse_vector"}
_INT_BITS = {"integer": 31, "long": 63}
_FIELD_OPTIONS = {"type", "analyzer", "search_analyzer", "normalizer",
                  "index", "doc_values", "ignore_above", "norms", "fields",
                  "format", "positive_score_impact", "index_impacts"}
# a vector field's own parameters (dims, similarity, ANN method)
_VECTOR_OPTIONS = {"dims", "dimension", "similarity", "space_type",
                   "method", "index_options"}
_MAPPING_KEYS = {"properties", "dynamic", "_meta"}


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

    @property
    def has_norms(self) -> bool:
        return self.type in TEXT_TYPES and self.norms


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


def coerce_value(ft: "FieldType", value: Any):
    """A raw JSON value as its column value, as the reference's
    coerce_value: epoch millis for a date, 0/1 for a boolean, a
    range-checked int for integer/long, a float for double/float."""
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
    if t in FLOAT_TYPES:
        fv = float(value)
        if t == "rank_feature" and fv <= 0:
            raise ValueError(
                f"[rank_feature] fields must hold positive values, got [{fv}]")
        return fv
    if t not in _INT_BITS:
        raise ValueError(f"cannot coerce for type [{t}]")
    iv = int(value)
    bits = _INT_BITS[t]
    if not (-(1 << bits)) <= iv < (1 << bits):
        raise ValueError(f"value [{value}] out of range for field type "
                         f"[{t}]")
    return iv


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
        self.dynamic = dynamic
        self._meta: dict = {}
        if mapping:
            self.merge(mapping)

    def merge(self, mapping: dict) -> None:
        for key in mapping:
            if key not in _MAPPING_KEYS:
                raise NotPortedError(f"mapping parameter [{key}]")
        if "dynamic" in mapping:
            self.dynamic = mapping["dynamic"]
        self._meta.update(mapping.get("_meta", {}))
        self._merge_props(mapping.get("properties", {}), prefix="")

    def _merge_props(self, props: dict, prefix: str) -> None:
        for name, cfg in props.items():
            path = f"{prefix}{name}"
            ftype = cfg.get("type", "object" if "properties" in cfg else "text")
            if ftype == "object":
                self._merge_props(cfg.get("properties", {}), prefix=f"{path}.")
                continue
            self.fields[path] = self._build_field(path, ftype, cfg)

    def _build_field(self, path: str, ftype: str, cfg: dict) -> FieldType:
        if ftype not in TEXT_TYPES | KEYWORD_TYPES | NUMERIC_TYPES \
                | VECTOR_TYPES | FEATURE_TYPES:
            raise NotPortedError(f"field type [{ftype}] (field [{path}])")
        allowed = _FIELD_OPTIONS | (_VECTOR_OPTIONS if ftype in VECTOR_TYPES
                                    else set())
        for key in cfg:
            if key not in allowed:
                raise NotPortedError(f"field parameter [{key}] (field [{path}])")
        ft = FieldType(
            name=path, type=ftype,
            analyzer=cfg.get("analyzer", "standard"),
            search_analyzer=cfg.get("search_analyzer"),
            normalizer=cfg.get("normalizer"),
            index=cfg.get("index", True),
            ignore_above=cfg.get("ignore_above"),
            norms=cfg.get("norms", True),
            doc_values=cfg.get("doc_values", True),
            date_format=cfg.get("format"),
            dims=int(cfg.get("dims", cfg.get("dimension", 0))),
            vector_similarity=cfg.get("similarity",
                                      cfg.get("space_type", "cosine")))
        if ftype in VECTOR_TYPES:
            ft.vector_method = _vector_method(path, cfg)
        ft.positive_score_impact = bool(cfg.get("positive_score_impact",
                                                True))
        if "index_impacts" in cfg:
            if ftype not in FEATURE_TYPES:
                raise ValueError(
                    f"Field [{path}]: [index_impacts] only applies to "
                    f"rank_features/sparse_vector fields")
            ft.index_impacts = bool(cfg["index_impacts"])
        for sub, subcfg in cfg.get("fields", {}).items():
            ft.subfields[sub] = self._build_field(
                f"{path}.{sub}", subcfg.get("type", "keyword"), subcfg)
        return ft

    def to_dict(self) -> dict:
        """The mapping as the reference's `Mappings.to_dict` renders it
        (get_mapping, indices.get): each field's type, a text field's
        analyzer other than standard, a normalizer, `index: false`, the
        subfields' types, object paths as nested properties, `_meta`."""
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
            if ft.type == "text" and ft.analyzer != "standard":
                d["analyzer"] = ft.analyzer
            if ft.normalizer:
                d["normalizer"] = ft.normalizer
            if not ft.index:
                d["index"] = False
            if ft.subfields:
                d["fields"] = {s: {"type": sf.type}
                               for s, sf in ft.subfields.items()}
            node[parts[-1]] = d
        out: dict = {"properties": props}
        if self._meta:
            out["_meta"] = self._meta
        return out

    # ---------------- field resolution ----------------

    def resolve_field(self, name: str) -> Optional[FieldType]:
        ft = self.fields.get(name)
        if ft is not None:
            return ft
        if "." in name:   # multi-field lookup: "title.keyword"
            parent, sub = name.rsplit(".", 1)
            pft = self.fields.get(parent)
            if pft and sub in pft.subfields:
                return pft.subfields[sub]
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
        return parsed

    def _parse_obj(self, obj: dict, prefix: str, parsed: ParsedDocument) -> None:
        for key, value in obj.items():
            path = f"{prefix}{key}"
            if isinstance(value, dict):
                ft = self.resolve_field(path)
                if ft is not None and ft.type in FEATURE_TYPES:
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

    def _index_value(self, ft: FieldType, value: Any,
                     parsed: ParsedDocument) -> None:
        if ft.type in VECTOR_TYPES and isinstance(value, list):
            value = [value]     # the whole list is ONE vector value
        values = value if isinstance(value, list) else [value]
        for v in values:
            if v is not None:
                self._index_single(ft, v, parsed)
        for sub in ft.subfields.values():
            self._index_value(sub, value, parsed)

    def _index_single(self, ft: FieldType, v: Any,
                      parsed: ParsedDocument) -> None:
        name = ft.name
        if ft.type in TEXT_TYPES:
            if ft.index:
                tokens = self.index_analyzer(ft).analyze(str(v))
                parsed.terms.setdefault(name, []).extend(t.text for t in tokens)
                pl = parsed.positions.setdefault(name, [])
                # the position gap between the values of an array field
                base = max(p for _, p in pl) + 100 if pl else 0
                pl.extend((t.text, base + t.position) for t in tokens)
            return
        if ft.type in NUMERIC_TYPES:
            parsed.numerics.setdefault(name, []).append(coerce_value(ft, v))
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
        s = str(v)      # keyword
        if ft.ignore_above is not None and len(s) > ft.ignore_above:
            return
        norm = self.index_analyzer(ft).terms(s)
        s = norm[0] if norm else s
        if ft.index:
            parsed.terms.setdefault(name, []).append(s)
        if ft.doc_values:
            parsed.keywords.setdefault(name, []).append(s)
