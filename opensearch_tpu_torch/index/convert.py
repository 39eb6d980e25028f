"""Build a port Segment from plain numpy arrays and Python lists.

The arguments are exactly what an opensearch_tpu Segment holds for its
inverted fields (CSR postings with their positions, doc lengths, text
stats and, on codec v2, each field's ImpactPlane arrays, a feature
field's FEATURE plane among them) and its doc
values (each NumericColumn's kind, values and present mask, each
KeywordColumn's vocab and ordinal arrays), its dense vectors (each
VectorColumn's values, present mask, similarity and method) and its geo
fields (each GeoColumn's lat, lon and present mask, each ShapeColumn's
specs, bounding boxes and present mask) and its nested blocks (each
path's child segment, built here the same way, and its parent map), so a
segment built there (or a CSR corpus made from a seed, as
`bench_corpus.py` does) carries across without re-indexing.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..errors import NotPortedError
from .segment import (CODEC_V2, GeoColumn, ImpactPlane, KeywordColumn,
                      NestedBlock, NumericColumn, PostingsBlock, Segment, ShapeColumn,
                      TextFieldStats, VectorColumn, default_codec_version)

IMPACT_FIELDS = ("q", "scale", "bits", "k1", "b", "avgdl", "dl_max",
                 "block_starts", "block_off", "block_max")


def _getter(col):
    """Field access for a column given as a dict or as an object."""
    return col.get if isinstance(col, dict) else col.__getattribute__


def segment_from_arrays(name: str, ndocs: int,
                        postings: Dict[str, dict],
                        doc_lens: Dict[str, np.ndarray],
                        text_stats: Dict[str, Tuple[int, int]],
                        ids: Sequence[str], sources: Sequence[dict],
                        live: Optional[np.ndarray] = None,
                        impacts: Optional[Dict[str, dict]] = None,
                        numeric_cols: Optional[Dict[str, object]] = None,
                        keyword_cols: Optional[Dict[str, object]] = None,
                        vector_cols: Optional[Dict[str, object]] = None,
                        stored_vals: Optional[list] = None,
                        geo_cols: Optional[Dict[str, object]] = None,
                        shape_cols: Optional[Dict[str, object]] = None,
                        nested: Optional[Dict[str, tuple]] = None,
                        device=None) -> Segment:
    """`postings[field]` = dict(vocab, starts, doc_ids, tfs) in CSR form
    (vocab sorted, docs ascending per row), with `pos_starts` and
    `positions` for a positional field and `feature` True for a
    rank_features / sparse_vector field (the tfs its weights);
    `text_stats[field]` =
    (doc_count, sum_dl); `live` None means no deletes. `ids`/`sources` may
    be any indexable sequences (a lazy view serves a synthetic corpus).

    `impacts[field]` = dict of IMPACT_FIELDS (a reference segment's
    ImpactPlane, and its `kind`, "feature" for a FEATURE plane) attaches
    those planes as they are and stamps the segment codec v2. Without it
    the segment is codec v2 with planes built here (quantized on
    `device`; a FEATURE plane for each feature field whose `postings`
    entry sets `index_impacts`), unless OPENSEARCH_TPU_CODEC=1 pins v1,
    as a refresh does.

    `numeric_cols[field]` = a reference segment's NumericColumn, or a dict
    of its `kind`, `values` and `present`, taken as it is: kind "int"
    (exact i64), "uint" (an unsigned_long's biased i64) or "float" (f64).
    `keyword_cols[field]` = a reference segment's KeywordColumn, or a dict
    of its `vocab`, `starts`, `ords`, `doc_of_value` and `min_ord`.
    `stored_vals` = per doc its `store: true` values, or None. `vector_cols[field]` = a reference
    segment's VectorColumn, or a dict of its `values` (f32 [ndocs,
    dims], taken without a copy where it is f32 already), `present`,
    `similarity` and `method`; its IVF index is built on first use.
    `geo_cols[field]` = a reference segment's GeoColumn, or a dict of its
    `lat`, `lon` (f32) and `present`; `shape_cols[field]` = a reference
    segment's ShapeColumn, or a dict of its `specs` (per doc a list of
    GeoJSON / WKT specs, or None), `minx`, `miny`, `maxx`, `maxy` (f64)
    and `present`. A range field's [lo, hi] are numeric columns named
    `<field>#lo` / `<field>#hi`. `nested[path]` = (the children's
    Segment, from this function too, i32 parent doc of each child,
    nondecreasing)."""
    blocks = {}
    for field, p in postings.items():
        vocab = list(p["vocab"])
        starts = np.asarray(p["starts"], np.int64)
        doc_ids = np.asarray(p["doc_ids"], np.int32)
        tfs = np.asarray(p["tfs"], np.float32)
        if len(starts) != len(vocab) + 1 or int(starts[-1]) != len(doc_ids) \
                or len(tfs) != len(doc_ids):
            raise ValueError(f"inconsistent CSR arrays for field [{field}]")
        pb = PostingsBlock(field, vocab, {t: i for i, t in enumerate(vocab)},
                           starts, doc_ids, tfs,
                           feature=bool(p.get("feature", False)))
        if p.get("pos_starts") is not None:
            pb.pos_starts = np.asarray(p["pos_starts"], np.int64)
            pb.positions = np.asarray(p["positions"], np.int32)
            if len(pb.pos_starts) != len(doc_ids) + 1 \
                    or int(pb.pos_starts[-1]) != len(pb.positions):
                raise ValueError(f"inconsistent position arrays for field "
                                 f"[{field}]")
        blocks[field] = pb
    cols = {}
    for field, col in (numeric_cols or {}).items():
        get = _getter(col)
        kind = get("kind")
        if kind not in ("int", "uint", "float"):
            raise NotPortedError(f"numeric column [{field}] of kind "
                                 f"[{kind}]")
        cols[field] = NumericColumn(
            field, kind, np.asarray(get("values"), np.float64
                                    if kind == "float" else np.int64),
            np.asarray(get("present"), bool))
    kcols = {}
    for field, col in (keyword_cols or {}).items():
        get = _getter(col)
        kcols[field] = KeywordColumn(
            field, list(get("vocab")), np.asarray(get("starts"), np.int64),
            np.asarray(get("ords"), np.int32),
            np.asarray(get("doc_of_value"), np.int32),
            np.asarray(get("min_ord"), np.int32))
    vcols = {}
    for field, col in (vector_cols or {}).items():
        get = _getter(col)
        vcols[field] = VectorColumn(
            field, np.asarray(get("values"), np.float32),
            np.asarray(get("present"), bool),
            get("similarity") or "cosine", method=get("method"))
    gcols = {}
    for field, col in (geo_cols or {}).items():
        get = _getter(col)
        gcols[field] = GeoColumn(field, np.asarray(get("lat"), np.float32),
                                 np.asarray(get("lon"), np.float32),
                                 np.asarray(get("present"), bool))
    scols = {}
    for field, col in (shape_cols or {}).items():
        get = _getter(col)
        scols[field] = ShapeColumn(
            field, list(get("specs")),
            *(np.asarray(get(k), np.float64)
              for k in ("minx", "miny", "maxx", "maxy")),
            np.asarray(get("present"), bool))
    seg = Segment(name, int(ndocs), blocks,
                  {f: np.asarray(v, np.int64) for f, v in doc_lens.items()},
                  {f: TextFieldStats(int(dc), int(sdl))
                   for f, (dc, sdl) in text_stats.items()},
                  [], [], numeric_cols=cols, keyword_cols=kcols,
                  vector_cols=vcols,
                  stored_vals=(list(stored_vals) if stored_vals is not None
                               else None),
                  geo_cols=gcols, shape_cols=scols,
                  nested={path: NestedBlock(child, np.asarray(parent_of,
                                                              np.int32))
                          for path, (child, parent_of)
                          in (nested or {}).items()})
    seg.ids = ids
    seg.sources = sources
    # a lazy id view is not enumerated: nothing in this slice looks ids up
    seg.id2doc = ({d: i for i, d in enumerate(ids)} if isinstance(ids, list)
                  else {})
    if live is not None:
        seg.live = np.asarray(live, bool).copy()
        seg.live_gen += 1
    if impacts is not None:
        for field, fields in impacts.items():
            blocks[field].impact = ImpactPlane(
                **{k: fields[k] for k in IMPACT_FIELDS},
                kind=str(fields.get("kind") or "bm25"))
            if blocks[field].impact.kind == "feature":
                blocks[field].feature = True
        seg.codec_version = CODEC_V2
    elif default_codec_version() >= CODEC_V2:
        seg.build_impacts(feature_fields=[
            f for f, p in postings.items()
            if p.get("feature") and p.get("index_impacts")], device=device)
    return seg
