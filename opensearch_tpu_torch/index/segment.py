"""Immutable index segments, codecs v1 and v2 (the CSR-postings and
impact-plane subset of opensearch_tpu/index/segment.py).

Postings for one field are a CSR matrix over (term row -> doc postings):
`starts[t]..starts[t+1]` index flat `doc_ids` / `tfs` arrays, rows in
sorted-vocab order, docs ascending within a row; a text field's postings
also carry token positions (`pos_starts` / `positions`), which phrase
queries read. `doc_lens` holds each text
field's per-doc token count and `text_stats` its (doc_count, sum_dl), the
collection statistics BM25 reads. `numeric_cols` holds each numeric
field's doc values (the first value of each doc and a `present` mask):
exact i64 for the long family (kind "int"), unsigned_long as the
order-exact biased i64 v - 2^63 (kind "uint"; its f32 view unbiases), f64
for the float family (kind "float"); range filters and
aggregations read them. `keyword_cols` holds each keyword field's doc
values as segment-local ordinals into a sorted vocab (a doc-major CSR of
the doc's distinct values, and the doc's least ordinal), which terms
aggregations read. `stored_vals` holds each doc's `store: true` values
(written to and read from stored.jsonl as the reference's `_stored`). The host arrays are numpy. The
search layer builds the device-resident aligned layout it needs
(`search/fastpath.py`); the general query path and the aggregations
read, per device and cached on the segment, the live mask, doc lengths,
numeric columns, their f32 aggregation view, keyword ordinals and, for a
field the aligned layout cannot pack, a CSR copy of its postings
(`live_on`, `doc_lens_on`, `numeric_on`, `f32_on`, `keyword_on`,
`csr_on`).

Codec v2 (the default for new segments, as in the reference) adds a
per-field impact plane: the BM25 tf-saturation tf/(tf + k1(1-b+b dl/avgdl))
evaluated at build time under nominal similarity parameters, quantized to
u8/u16 with one global per-field scale, plus a per-128-posting block-max
sidecar. The quantizer runs as torch ops on the engine's device for large
planes (`ops/device_merge.py`) and in numpy below DEVICE_IMPACT_MIN
postings, as the reference does.

Feature fields (`rank_features` / `sparse_vector`) are CSR postings too:
rows are the sorted feature vocabulary and the tf slot carries each
doc's f32 weight (`PostingsBlock.feature`; no positions, no doc
lengths). A field whose mapping sets `index_impacts` gets a FEATURE
impact plane (`ImpactPlane.kind == "feature"`): the weights quantized
directly with one global scale, max weight / qmax, and the same block
sidecar, so `neural_sparse` serves on the impact rung; its device
arrays keep the f32 weights beside the plane (`csr_on`), which
`rank_feature` and the general path's sparse dot read.

`vector_cols` holds each dense vector field's `VectorColumn`: f32
[ndocs, dims] values, a `present` mask, the similarity and the ANN
method, built at refresh. Its device arrays (`vector_on`) are the
scored matrix (unit-normed on the device for cosine, unpadded: zero
columns add nothing to a dot product), `present` and, for L2, each
row's squared norm; its balanced IVF index is built lazily from that
matrix on first use (`ivf_on`, `ops/ann.py`) and kept on the column's
host side, so a twin of the segment on another device reuses it.

`geo_cols` holds each geo_point field's `GeoColumn` (f32 lat / lon of a
doc's first point and a `present` mask; `geo_on` puts them on a
device), `shape_cols` each geo_shape field's `ShapeColumn`: the host
specs of each doc and its f64 bounding box columns, the prefilter of
the exact host relation tests (`bbox_candidates`, `shape`). A range
field's [lo, hi] are the numeric columns `<field>#lo` / `<field>#hi` in
its member type's kind.

`nested` holds a `NestedBlock` for each nested path: the children's own
segment (built recursively at refresh, so a deeper path hangs off its
child segment) and the i32 child -> parent map; impact planes, device
release, save and load recurse into it. A child's liveness is its
parent's, gathered through the map at query time.
"""

from __future__ import annotations

import functools
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .mappings import FLOAT_TYPES, RANGE_MEMBER, Mappings

CODEC_V1 = 1
CODEC_V2 = 2
IMPACT_BLOCK = 128        # postings per block-max sidecar entry
IMPACT_K1 = 1.2           # nominal build-time similarity params; query-time
IMPACT_B = 0.75           # drift is bounded by ImpactPlane.drift_bound


def default_codec_version() -> int:
    """Codec for NEW segments (refresh). OPENSEARCH_TPU_CODEC=1 pins the
    tf-only format, as in the reference."""
    return CODEC_V1 if os.environ.get("OPENSEARCH_TPU_CODEC") == "1" \
        else CODEC_V2


def default_impact_bits() -> int:
    """Impact quantization width: 16 (default) or 8 via
    OPENSEARCH_TPU_IMPACT_BITS=8, as in the reference."""
    return 8 if os.environ.get("OPENSEARCH_TPU_IMPACT_BITS") == "8" else 16


@dataclass
class ImpactPlane:
    """Quantized eager BM25 impacts for one field's CSR postings (codec
    v2). `q[i] * scale` ~= tf_i/(tf_i + k1(1-b+b dl_i/avgdl)) at the
    BUILD-time nominal (k1, b, avgdl); dequantize through
    `ops/scoring.dequant_impact_np`. The block sidecar stores, per
    IMPACT_BLOCK-posting run of each row, the max quantized impact."""

    q: np.ndarray             # u8/u16[P] quantized impacts, CSR-flat
    scale: float              # dequant scale: impact ~= q * scale
    bits: int                 # 8 | 16
    k1: float                 # build-time nominal similarity params
    b: float
    avgdl: float
    dl_max: int               # max doc length seen (drift bound input)
    block_starts: np.ndarray  # i64[nterms+1] block-CSR row pointers
    block_off: np.ndarray     # i64[nblocks] flat element start per block
    block_max: np.ndarray     # u8/u16[nblocks] max q per block
    # "bm25": q dequantizes to the tf saturation at the build params;
    # "feature": q dequantizes to the stored feature weight itself, so
    # quantization is the only error (drift_bound never applies)
    kind: str = "bm25"

    @property
    def qmax(self) -> int:
        return (1 << self.bits) - 1

    @property
    def nbytes(self) -> int:
        return int(self.q.nbytes + self.block_max.nbytes
                   + self.block_off.nbytes + self.block_starts.nbytes)

    def quant_err(self) -> float:
        """Sound per-posting |exact f32 impact - q*scale| bound at the
        BUILD params: half a quantization step plus f32 slack for the
        dequant multiply."""
        top = np.float32(self.scale) * np.float32(self.qmax)
        return float(self.scale) * 0.5 + 2.0 * float(np.spacing(top))

    def drift_bound(self, k1q: float, bq: float, avgdlq: float) -> float:
        """Sound bound on |f_query - f_build| per posting when query-time
        (k1, b, avgdl) differ from the baked build params: with
        k(dl) = k1(1-b+b dl/avgdl) linear in dl, dk is maximized at a dl
        endpoint, and tf/((tf+ka)(tf+kb)) <= 1/(sqrt(ka)+sqrt(kb))^2 (or
        its tf=1 value when the unconstrained max lies below tf=1)."""
        if (float(k1q) == float(self.k1) and float(bq) == float(self.b)
                and float(avgdlq) == float(self.avgdl)):
            return 0.0

        def k_of(dl, k1, b, avg):
            return k1 * (1.0 - b + b * dl / max(avg, 1e-9))

        dk = max(abs(k_of(0.0, k1q, bq, avgdlq)
                     - k_of(0.0, self.k1, self.b, self.avgdl)),
                 abs(k_of(float(self.dl_max), k1q, bq, avgdlq)
                     - k_of(float(self.dl_max), self.k1, self.b,
                            self.avgdl)))
        ka = max(k_of(0.0, k1q, bq, avgdlq), 0.0)
        kb = max(k_of(0.0, self.k1, self.b, self.avgdl), 0.0)
        if ka * kb >= 1.0:
            g = 1.0 / (math.sqrt(ka) + math.sqrt(kb)) ** 2
        else:
            g = 1.0 / ((1.0 + ka) * (1.0 + kb))
        return min(dk * g, 1.0)

    def row_block_range(self, row: int) -> Tuple[int, int]:
        return int(self.block_starts[row]), int(self.block_starts[row + 1])


def build_impact_plane(pb: "PostingsBlock", dl: Optional[np.ndarray],
                       avgdl: Optional[float] = None,
                       bits: Optional[int] = None,
                       device=None) -> Optional[ImpactPlane]:
    """Quantize one field's eager impacts + block-max sidecar (the codec
    v2 build step of refresh and of direct corpus wrappers). Planes of at
    least DEVICE_IMPACT_MIN postings quantize as torch ops on `device`
    (the CPU when None), smaller ones in numpy, as the reference splits
    them."""
    if pb.size == 0:
        return None
    bits = default_impact_bits() if bits is None else int(bits)
    tfs = pb.tfs.astype(np.float32)
    if dl is not None:
        dl_of = dl[pb.doc_ids].astype(np.float32)
        dl_max = int(dl.max()) if len(dl) else 0
    else:
        dl_of = np.zeros(pb.size, np.float32)
        dl_max = 0
    if avgdl is None:
        pos = dl_of[dl_of > 0]
        avgdl = float(pos.mean()) if len(pos) else 1.0
    avgdl = max(float(avgdl), 1e-9)
    from ..ops.device_merge import quantize_impacts, use_device_impacts
    qmax = (1 << bits) - 1
    if use_device_impacts(pb.size):
        q32, scale = quantize_impacts(tfs, dl_of, IMPACT_K1, IMPACT_B,
                                      avgdl, qmax, device)
        q = q32.astype(np.uint8 if bits == 8 else np.uint16)
    else:
        kfac = IMPACT_K1 * (1.0 - IMPACT_B + IMPACT_B * dl_of / avgdl)
        imp = tfs / (tfs + kfac)
        m = float(imp.max()) if len(imp) else 0.0
        scale = (m / qmax) if m > 0 else 1.0
        q = np.minimum(np.round(imp / np.float32(scale)), qmax).astype(
            np.uint8 if bits == 8 else np.uint16)
    block_starts, block_off, block_max = _impact_sidecar(pb, q)
    return ImpactPlane(q=q, scale=float(scale), bits=bits,
                       k1=IMPACT_K1, b=IMPACT_B, avgdl=float(avgdl),
                       dl_max=dl_max, block_starts=block_starts,
                       block_off=block_off, block_max=block_max)


def build_feature_impact_plane(pb: "PostingsBlock",
                               bits: Optional[int] = None,
                               device=None) -> Optional[ImpactPlane]:
    """Quantize one feature field's weights into a FEATURE plane: scale
    = max weight / qmax (in double), q = round(w / f32(scale)) in f32,
    half to even, clipped to qmax, plus the block sidecar; None for an
    empty or all-zero field. Planes of at least DEVICE_IMPACT_MIN
    postings quantize as torch ops on `device` (the CPU when None),
    equal to the numpy form bit for bit."""
    if pb.size == 0:
        return None
    bits = default_impact_bits() if bits is None else int(bits)
    qmax = (1 << bits) - 1
    dtype = np.uint8 if bits == 8 else np.uint16
    from ..ops.device_merge import quantize_features, use_device_impacts
    if use_device_impacts(pb.size):
        got = quantize_features(pb.tfs, qmax, device)
        if got is None:
            return None
        q, scale = got
    else:
        w = pb.tfs.astype(np.float32)
        m = float(w.max())
        if m <= 0.0:
            return None
        scale = m / qmax
        q = np.minimum(np.round(w / np.float32(scale)), qmax).astype(dtype)
    block_starts, block_off, block_max = _impact_sidecar(pb, q)
    return ImpactPlane(q=q, scale=float(scale), bits=bits,
                       k1=0.0, b=0.0, avgdl=1.0, dl_max=0,
                       block_starts=block_starts, block_off=block_off,
                       block_max=block_max, kind="feature")


def _impact_sidecar(pb: "PostingsBlock", q: np.ndarray):
    """Per-IMPACT_BLOCK-posting block-max sidecar over one quantized
    plane: (block_starts i64[nterms+1], block_off i64[nblocks],
    block_max u8/u16[nblocks])."""
    lens = np.diff(pb.starts)
    nblk = -(-lens // IMPACT_BLOCK)           # ceil; empty rows -> 0 blocks
    block_starts = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(nblk, out=block_starts[1:])
    nblocks = int(block_starts[-1])
    if nblocks:
        # flat element offset of each block: row start + j*IMPACT_BLOCK
        row_of_blk = np.repeat(np.arange(len(lens), dtype=np.int64), nblk)
        j = np.arange(nblocks, dtype=np.int64) - block_starts[row_of_blk]
        block_off = pb.starts[row_of_blk].astype(np.int64) \
            + j * IMPACT_BLOCK
        block_max = np.maximum.reduceat(q, block_off)
    else:
        block_off = np.zeros(0, np.int64)
        block_max = np.zeros(0, q.dtype)
    return block_starts, block_off, block_max


# rows of a vector matrix moved to a device (or merged) per step
VECTOR_CHUNK_ROWS = 1 << 20
# the similarities whose score reads the raw dot product alone
COSINE_DOT = ("cosine", "dot_product", "innerproduct")


def next_pow2(n: int, floor: int = 16) -> int:
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


@dataclass
class PostingsBlock:
    """CSR postings for one indexed field."""

    field: str
    vocab: List[str]                    # row -> term (sorted)
    terms: Dict[str, int]               # term -> row
    starts: np.ndarray                  # i64[nterms+1] row pointers
    doc_ids: np.ndarray                 # i32[P]
    tfs: np.ndarray                     # f32[P]
    # positions (text fields): posting i's positions, ascending, are
    # positions[pos_starts[i]:pos_starts[i + 1]] (None: not positional)
    pos_starts: Optional[np.ndarray] = None   # i64[P+1]
    positions: Optional[np.ndarray] = None    # i32[total positions]
    # codec v2: quantized eager impacts + block-max sidecar (None on v1)
    impact: Optional[ImpactPlane] = None
    # a rank_features / sparse_vector field: the tf slot is an f32 weight
    feature: bool = False

    @property
    def nterms(self) -> int:
        return len(self.vocab)

    @property
    def size(self) -> int:
        return int(self.starts[-1])

    def row(self, term: str) -> int:
        """Row for term, or -1 when absent."""
        return self.terms.get(term, -1)

    def doc_freq(self, term: str) -> int:
        r = self.terms.get(term)
        if r is None:
            return 0
        return int(self.starts[r + 1] - self.starts[r])

    def row_slice(self, row: int) -> Tuple[int, int]:
        return int(self.starts[row]), int(self.starts[row + 1])


@dataclass
class NumericColumn:
    """Doc values of one numeric field: `values[d]` is the first value of
    doc d (0 where `present[d]` is false)."""

    field: str
    kind: str                 # "int" (exact i64) | "uint" (unsigned_long
                              # as v - 2^63, i64) | "float" (f64)
    values: np.ndarray        # i64[ndocs] | f64[ndocs]
    present: np.ndarray       # bool[ndocs]

    @functools.cached_property
    def min_max(self) -> Tuple[float, float]:
        if not self.present.any():
            return (0.0, 0.0)
        vals = self.values[self.present]
        return (float(vals.min()), float(vals.max()))

    @functools.cached_property
    def _ranks(self) -> Tuple[np.ndarray, np.ndarray]:
        distinct, inv = np.unique(self.values[self.present],
                                  return_inverse=True)
        ords = np.full(len(self.values), -1, dtype=np.int32)
        ords[self.present] = inv.reshape(-1)
        return distinct, ords

    @property
    def distinct(self) -> np.ndarray:
        """The segment's distinct present values, ascending."""
        return self._ranks[0]

    def sort_ords(self) -> np.ndarray:
        """i32[ndocs]: each doc's rank among the segment's distinct
        values, -1 where missing: exact sort and collapse keys even for
        values that need 64 bits."""
        return self._ranks[1]


@dataclass
class KeywordColumn:
    """Doc values of one keyword field: the distinct values of doc d are
    `vocab[ords[starts[d]:starts[d + 1]]]`, ordinals ascending."""

    field: str
    vocab: List[str]          # sorted distinct values
    starts: np.ndarray        # i64[ndocs+1] doc-major CSR
    ords: np.ndarray          # i32[total_values]
    doc_of_value: np.ndarray  # i32[total_values] (doc id per flat value)
    min_ord: np.ndarray       # i32[ndocs], -1 = missing


@dataclass
class VectorColumn:
    """Dense vectors of one field for kNN search: `values[d]` is doc d's
    vector (zeros where `present[d]` is false). `method` is the mapping's
    ANN method ({"name": "ivf", "nlist", "nprobe"}) or None (the exact
    scan only); `ivf` is its IvfIndex once built, None before."""

    field: str
    values: np.ndarray        # f32[ndocs, dims]
    present: np.ndarray       # bool[ndocs]
    similarity: str = "cosine"
    method: Optional[dict] = None
    ivf: object = None

    @property
    def dims(self) -> int:
        return int(self.values.shape[1])


@dataclass
class GeoColumn:
    """Doc values of one geo_point field: the f32 lat / lon of each doc's
    first point (0 where `present[d]` is false)."""

    field: str
    lat: np.ndarray           # f32[ndocs]
    lon: np.ndarray           # f32[ndocs]
    present: np.ndarray       # bool[ndocs]


@dataclass
class ShapeColumn:
    """One geo_shape field: per doc its specs (GeoJSON / WKT, or None)
    and the bounding box of all of them in f64 columns (+-inf where
    absent). The exact relations run on the host over the docs whose box
    overlaps the query's (`bbox_candidates`), as in the reference."""

    field: str
    specs: list               # per doc: a list of specs, or None
    minx: np.ndarray          # f64[ndocs]
    miny: np.ndarray
    maxx: np.ndarray
    maxy: np.ndarray
    present: np.ndarray       # bool[ndocs]
    _parsed: Optional[list] = None     # lazily parsed Shape per doc

    def shape(self, doc: int):
        """The doc's Shape (several values merge into one collection)."""
        from ..search.geo import Shape, parse_shape
        if self._parsed is None:
            self._parsed = [None] * len(self.specs)
        s = self._parsed[doc]
        if s is None and self.specs[doc]:
            parts = [parse_shape(sp) for sp in self.specs[doc]]
            if len(parts) == 1:
                s = parts[0]
            else:
                s = Shape()
                s.points = np.concatenate([p.points for p in parts])
                for p in parts:
                    s.lines += p.lines
                    s.polys += p.polys
                s.finish()
            self._parsed[doc] = s
        return s

    def bbox_candidates(self, qbbox) -> np.ndarray:
        """bool[ndocs]: the docs whose box overlaps the query box."""
        qminx, qminy, qmaxx, qmaxy = qbbox
        return (self.present & (self.minx <= qmaxx) & (self.maxx >= qminx)
                & (self.miny <= qmaxy) & (self.maxy >= qminy))


@dataclass
class TextFieldStats:
    doc_count: int = 0        # docs containing this field
    sum_dl: int = 0           # total tokens across docs


@dataclass
class NestedBlock:
    """The children of one nested path: a full child-space segment (its
    docs are the nested objects, fields keyed by dotted path) and the
    child -> parent doc map, nondecreasing (the reference's NestedBlock;
    Lucene keeps a parent's children as adjacent docs of its block)."""

    child: "Segment"
    parent_of: np.ndarray      # i32[child.ndocs]

    def children_of(self, parent_doc: int) -> Tuple[int, int]:
        a = int(np.searchsorted(self.parent_of, parent_doc, side="left"))
        b = int(np.searchsorted(self.parent_of, parent_doc, side="right"))
        return a, b

    def parent_on(self, device):
        """i64[child.ndocs] parent docs on `device`, cached on the
        child segment."""
        return self.child.device_cached(
            ("parent_of",), device,
            lambda: torch.from_numpy(self.parent_of.astype(np.int64)).to(
                device))


class Segment:
    """One immutable searchable unit."""

    _seq = 0

    def __init__(self, name: str, ndocs: int,
                 postings: Dict[str, PostingsBlock],
                 doc_lens: Dict[str, np.ndarray],
                 text_stats: Dict[str, TextFieldStats],
                 ids, sources, seq_nos: Optional[np.ndarray] = None,
                 codec_version: int = CODEC_V1,
                 numeric_cols: Optional[Dict[str, NumericColumn]] = None,
                 keyword_cols: Optional[Dict[str, KeywordColumn]] = None,
                 vector_cols: Optional[Dict[str, VectorColumn]] = None,
                 stored_vals: Optional[list] = None,
                 geo_cols: Optional[Dict[str, GeoColumn]] = None,
                 shape_cols: Optional[Dict[str, ShapeColumn]] = None,
                 nested: Optional[Dict[str, NestedBlock]] = None):
        Segment._seq += 1
        self.uid = Segment._seq
        self.name = name
        self.ndocs = ndocs
        self.postings = postings
        self.doc_lens = doc_lens
        self.text_stats = text_stats
        self.numeric_cols = numeric_cols or {}
        self.keyword_cols = keyword_cols or {}
        self.vector_cols = vector_cols or {}
        self.geo_cols = geo_cols or {}
        self.shape_cols = shape_cols or {}
        # nested path -> its children's block
        self.nested: Dict[str, NestedBlock] = nested or {}
        # per doc: {field: [raw values]} of its `store: true` fields, or
        # None; None for the whole segment when no doc stores a field
        self.stored_vals = stored_vals
        self.ids = ids
        self.sources = sources
        self.seq_nos = (seq_nos if seq_nos is not None
                        else np.zeros(ndocs, dtype=np.int64))
        self.live = np.ones(ndocs, dtype=bool)
        self.live_gen = 0         # bumped by every delete
        # a lazy id view is not enumerated: it answers through `find`
        self.id2doc: Dict[str, int] = (
            {d: i for i, d in enumerate(ids)} if isinstance(ids, list)
            else {})
        # segment codec (CODEC_V1 | CODEC_V2): consumers branching on the
        # posting layout consult this attribute
        self.codec_version = int(codec_version)
        # search-layer caches keyed by (field, device): AlignedPostings,
        # quality tiers and filtered views, built by search/fastpath.py
        self.aligned: dict = {}
        # the general path's device arrays (see `device_cached`)
        self.device_arrays: dict = {}
        # scrolls and points in time reading this segment, and whether a
        # merge has replaced it (see `hold` and `retire`)
        self.holders = 0
        self.retired = False

    # ---------------- codec v2: impact planes ----------------

    def build_impacts(self, bits: Optional[int] = None,
                      feature_fields: Sequence[str] = (),
                      device=None) -> None:
        """Build quantized impact planes for every text-scored field
        (fields with a doc-length column) and a FEATURE plane for each of
        `feature_fields` (feature fields whose mapping set
        `index_impacts`), and stamp the segment codec v2. Idempotent."""
        feature_fields = set(feature_fields)
        for f, pb in self.postings.items():
            if pb.impact is not None:
                continue
            if f in feature_fields and f not in self.doc_lens:
                pb.impact = build_feature_impact_plane(pb, bits=bits,
                                                       device=device)
                continue
            if f not in self.doc_lens:
                continue
            st = self.text_stats.get(f)
            avgdl = (st.sum_dl / st.doc_count
                     if st is not None and st.doc_count > 0 else None)
            pb.impact = build_impact_plane(pb, self.doc_lens.get(f),
                                           avgdl=avgdl, bits=bits,
                                           device=device)
        for blk in self.nested.values():
            blk.child.build_impacts(bits=bits, device=device)
        self.codec_version = CODEC_V2
        self.aligned = {}
        self.device_arrays = {}

    def drop_impacts(self) -> None:
        """Demote to codec v1: planes dropped, the search layer's device
        layouts rebuilt without them on next use."""
        for pb in self.postings.values():
            pb.impact = None
        for blk in self.nested.values():
            blk.child.drop_impacts()
        self.codec_version = CODEC_V1
        self.aligned = {}
        self.device_arrays = {}

    def delete_doc(self, local_doc: int) -> None:
        self.live[local_doc] = False
        self.live_gen += 1

    @property
    def live_count(self) -> int:
        """Live docs, counted once per `live_gen` (every search asks)."""
        got = self.__dict__.get("_live_count")
        if got is None or got[0] != self.live_gen:
            got = (self.live_gen, int(self.live.sum()))
            self.__dict__["_live_count"] = got
        return got[1]

    @property
    def ndocs_pad(self) -> int:
        """The reference's pow2 doc-axis padding; the port's arrays are
        unpadded, but window sizes are computed from it as there."""
        return next_pow2(self.ndocs)

    def local_doc(self, doc_id: str) -> int:
        """Local doc of an `_id`, or -1. A lazy id view answers through
        its own `find`."""
        d = self.id2doc.get(doc_id)
        if d is None:
            find = getattr(self.ids, "find", None)
            d = find(doc_id) if find is not None else -1
        return int(d)

    # ---------------- the general path's device arrays ----------------

    def device_cached(self, key: tuple, device, make):
        """The device array(s) `make()` builds, cached per (key,
        device)."""
        k = key + (str(device),)
        got = self.device_arrays.get(k)
        if got is None:
            got = make()
            self.device_arrays[k] = got
        return got

    def live_on(self, device):
        """bool[ndocs] live mask on `device`, rebuilt after a delete."""
        for k in [k for k in self.device_arrays
                  if k[0] == "live" and k[1] != self.live_gen]:
            del self.device_arrays[k]
        return self.device_cached(
            ("live", self.live_gen), device,
            lambda: torch.from_numpy(self.live).to(device))

    def doc_lens_on(self, field: str, device):
        """f32[ndocs] doc lengths of `field` (zeros without norms)."""

        def make():
            dl = self.doc_lens.get(field)
            host = (np.zeros(self.ndocs, np.float32) if dl is None
                    else dl.astype(np.float32))
            return torch.from_numpy(host).to(device)
        return self.device_cached(("dl", field), device, make)

    def numeric_on(self, field: str, device):
        """(values i64[ndocs], present bool[ndocs]) of a numeric column,
        or None when the segment has no such column."""
        col = self.numeric_cols.get(field)
        if col is None:
            return None
        return self.device_cached(("numeric", field), device, lambda: (
            torch.from_numpy(col.values).to(device),
            torch.from_numpy(col.present).to(device)))

    def f32_on(self, field: str, device):
        """(values f32[ndocs], present bool[ndocs]): the f32 view of a
        numeric column that aggregations read, cast on the host as the
        reference's `_num_field_arrays` casts it (a long or date column
        rounds to f32 there too; an unsigned_long column unbiases in f64
        first), or None without the column."""
        col = self.numeric_cols.get(field)
        if col is None:
            return None
        return self.device_cached(("f32", field), device, lambda: (
            torch.from_numpy(f32_view(col)).to(device),
            torch.from_numpy(col.present).to(device)))

    def sort_ords_on(self, field: str, device):
        """i32[ndocs] `NumericColumn.sort_ords()` of a numeric column on
        `device`, or None without the column."""
        col = self.numeric_cols.get(field)
        if col is None:
            return None
        return self.device_cached(("sort_ords", field), device, lambda:
                                  torch.from_numpy(col.sort_ords()).to(
                                      device))

    def keyword_on(self, field: str, device):
        """(ords i64[V], doc_of_value i64[V], min_ord i32[ndocs]) of a
        keyword column on `device`, or None without the column."""
        col = self.keyword_cols.get(field)
        if col is None:
            return None
        return self.device_cached(("keyword", field), device, lambda: (
            torch.from_numpy(col.ords.astype(np.int64)).to(device),
            torch.from_numpy(col.doc_of_value.astype(np.int64)).to(device),
            torch.from_numpy(col.min_ord).to(device)))

    def csr_on(self, field: str, device):
        """(doc ids i32[P], tfs f32[P], impacts i32[P] or None) of a
        field's CSR postings: the general path's copy of a field that the
        aligned layout cannot pack."""
        pb = self.postings[field]

        def make():
            imp = None
            if pb.impact is not None:
                q = pb.impact.q
                # uploaded at its own width, widened on the device
                if q.dtype == np.uint16:
                    imp = torch.from_numpy(q.view(np.int16)).to(device).to(
                        torch.int32) & 0xFFFF
                else:
                    imp = torch.from_numpy(q).to(device).to(torch.int32)
            return (torch.from_numpy(pb.doc_ids).to(device),
                    torch.from_numpy(pb.tfs).to(device), imp)
        return self.device_cached(("csr", field), device, make)

    def geo_on(self, field: str, device) -> Optional[dict]:
        """{"lat", "lon": f32[ndocs], "present": bool[ndocs]} of a
        geo_point column on `device` (the reference's
        `_geo_field_arrays`), or None without the column."""
        col = self.geo_cols.get(field)
        if col is None:
            return None
        return self.device_cached(("geo", field), device, lambda: {
            "lat": torch.from_numpy(col.lat).to(device),
            "lon": torch.from_numpy(col.lon).to(device),
            "present": torch.from_numpy(col.present).to(device)})

    def vector_on(self, field: str, device) -> Optional[dict]:
        """{"mat": f32[ndocs, dims], "present": bool[ndocs], "sq":
        f32[ndocs] or None} of a vector column on `device`, or None
        without the column: the scored matrix (each row divided by
        max(its norm, 1e-12) for cosine, the values as they are
        otherwise) and, for L2, each row's squared norm. The matrix is
        filled chunk by chunk, so a copy of the values never stands
        beside it on the device (on the CPU, a non-cosine matrix is the
        host array itself)."""
        col = self.vector_cols.get(field)
        if col is None:
            return None

        def make():
            vals = col.values
            dev = torch.device(device)
            if col.similarity != "cosine" and dev.type == "cpu":
                mat = torch.from_numpy(vals)
            else:
                mat = torch.empty(vals.shape, dtype=torch.float32,
                                  device=dev)
                step = VECTOR_CHUNK_ROWS
                for a in range(0, len(vals), step):
                    part = torch.from_numpy(vals[a:a + step]).to(dev)
                    if col.similarity == "cosine":
                        torch.div(part, torch.linalg.vector_norm(
                            part, dim=1, keepdim=True).clamp_min(1e-12),
                            out=mat[a:a + step])
                    else:
                        mat[a:a + step] = part
            sq = None
            if col.similarity not in COSINE_DOT:
                sq = torch.cat([(mat[a:a + VECTOR_CHUNK_ROWS] ** 2).sum(1)
                                for a in range(0, len(vals),
                                               VECTOR_CHUNK_ROWS)])
            return {"mat": mat, "sq": sq,
                    "present": torch.from_numpy(col.present).to(dev)}
        return self.device_cached(("vector", field), device, make)

    def ivf_on(self, field: str, device):
        """The balanced IVF index of a vector column whose mapping asked
        for one, as (IvfIndex, centroids f32[nlist, dims], lists
        i64[nlist, cap]) on `device`; None without one (no column, no
        IVF method, no present vector). Built on first use from the
        scored matrix on `device` and kept on the column."""
        col = self.vector_cols.get(field)
        if col is None or not col.method or col.method.get("name") != "ivf":
            return None
        if col.ivf is None:
            from ..ops.ann import build_ivf
            arr = self.vector_on(field, device)
            col.ivf = build_ivf(arr["mat"], col.present,
                                nlist=col.method.get("nlist"),
                                nprobe=col.method.get("nprobe"))
            if col.ivf is None:
                return None
        ivf = col.ivf
        return self.device_cached(("ivf", field), device, lambda: (
            ivf, torch.from_numpy(ivf.centroids).to(device),
            torch.from_numpy(ivf.lists.astype(np.int64)).to(device)))

    def device_nbytes(self, device) -> int:
        """Bytes of the general path's device arrays on `device`, the
        nested children's included."""
        n = sum(blk.child.device_nbytes(device)
                for blk in self.nested.values())
        for k, v in self.device_arrays.items():
            if k[-1] == str(device):
                if isinstance(v, dict):
                    v = tuple(v.values())
                for t in (v if isinstance(v, tuple) else (v,)):
                    if isinstance(t, torch.Tensor):
                        n += t.numel() * t.element_size()
        return n

    def release_device(self) -> None:
        """Drop the search layer's state now (aligned postings, heads,
        filtered views, quality tiers, filter masks and lists, the general
        path's arrays, the phrase pairs on the host and the device, the
        aggregations' date buckets and keyword hashes, the vector
        matrices and IVF lists), not at garbage collection: a merge calls
        it on the segments it replaces."""
        self.aligned = {}
        self.device_arrays = {}
        for k in ("filter_lists", "filter_mask_owner", "phrase_pairs",
                  "date_buckets", "kw_hashes", "geo_grid_cells",
                  "nested_sort_cache", "percolator_queries"):
            self.__dict__.pop(k, None)
        for blk in self.nested.values():
            blk.child.release_device()

    def hold(self) -> None:
        """A scroll or point in time reads this segment: a merge that
        replaces it defers releasing its device state until the last
        holder lets go, as Lucene's reader reference counts do."""
        self.holders += 1

    def unhold(self) -> None:
        self.holders -= 1
        if self.holders == 0 and self.retired:
            self.release_device()

    def retire(self) -> None:
        """A merge replaced this segment: release its device state now,
        or when the last holder lets go."""
        self.retired = True
        if self.holders == 0:
            self.release_device()

    # ---------------- persistence (flush / recovery) ----------------

    def save(self, path: str) -> None:
        """Write the segment under `path` in the reference's layout
        (arrays.npz, meta.json, vocab files, stored.jsonl): live mask,
        seq_nos, codec, postings, impact planes and their sidecars,
        numeric and keyword columns, vector columns (values, present,
        similarity and method; the IVF index is rebuilt on first use, as
        the reference's), geo columns, shape columns (bbox and present
        arrays, the specs in a JSON file), doc lengths and text stats, so
        that `load` serves bit-equal pages without re-quantizing."""
        os.makedirs(path, exist_ok=True)
        arrays: Dict[str, np.ndarray] = {"live": self.live,
                                         "seq_nos": self.seq_nos}
        meta: dict = {"name": self.name, "ndocs": self.ndocs,
                      "codec": self.codec_version, "postings": {},
                      "numeric": {}, "keyword": {},
                      "impacts": {},
                      "text_stats": {f: [st.doc_count, st.sum_dl]
                                     for f, st in self.text_stats.items()}}
        for f, pb in self.postings.items():
            key = f"post__{f}"
            arrays[f"{key}__starts"] = pb.starts
            arrays[f"{key}__doc_ids"] = pb.doc_ids
            arrays[f"{key}__tfs"] = pb.tfs
            if pb.pos_starts is not None:
                arrays[f"{key}__pos_starts"] = pb.pos_starts
                arrays[f"{key}__positions"] = pb.positions
            ip = pb.impact
            if ip is not None:
                arrays[f"imp__{f}__q"] = ip.q
                arrays[f"imp__{f}__bstarts"] = ip.block_starts
                arrays[f"imp__{f}__boff"] = ip.block_off
                arrays[f"imp__{f}__bmax"] = ip.block_max
                meta["impacts"][f] = {"scale": ip.scale, "bits": ip.bits,
                                      "k1": ip.k1, "b": ip.b,
                                      "avgdl": ip.avgdl,
                                      "dl_max": ip.dl_max, "kind": ip.kind}
            meta["postings"][f] = {"vocab_file": True,
                                   "positional": pb.pos_starts is not None,
                                   "feature": pb.feature}
            with open(os.path.join(path, f"vocab__{_fname(f)}.txt"),
                      "w") as fh:
                fh.write("\n".join(pb.vocab))
        for f, col in self.numeric_cols.items():
            arrays[f"num__{f}__values"] = col.values
            arrays[f"num__{f}__present"] = col.present
            meta["numeric"][f] = {"kind": col.kind}
        for f, col in self.keyword_cols.items():
            arrays[f"kw__{f}__starts"] = col.starts
            arrays[f"kw__{f}__ords"] = col.ords
            arrays[f"kw__{f}__docs"] = col.doc_of_value
            arrays[f"kw__{f}__min_ord"] = col.min_ord
            meta["keyword"][f] = {"vocab_file": True}
            with open(os.path.join(path, f"kwvocab__{_fname(f)}.txt"),
                      "w") as fh:
                fh.write("\n".join(col.vocab))
        for f, col in self.vector_cols.items():
            arrays[f"vec__{f}__values"] = col.values
            arrays[f"vec__{f}__present"] = col.present
            meta.setdefault("vector", {})[f] = {
                "similarity": col.similarity, "method": col.method}
        for f, col in self.geo_cols.items():
            arrays[f"geo__{f}__lat"] = col.lat
            arrays[f"geo__{f}__lon"] = col.lon
            arrays[f"geo__{f}__present"] = col.present
        meta["geo"] = sorted(self.geo_cols)
        meta["shape"] = sorted(self.shape_cols)
        for f, col in self.shape_cols.items():
            arrays[f"shape__{f}__bbox"] = np.stack(
                [col.minx, col.miny, col.maxx, col.maxy])
            arrays[f"shape__{f}__present"] = col.present
            with open(os.path.join(path, f"shapes__{_fname(f)}.json"),
                      "w") as fh:
                json.dump(col.specs, fh)
        for f, dl in self.doc_lens.items():
            arrays[f"dl__{f}"] = dl
        meta["nested"] = sorted(self.nested)
        for npath, blk in self.nested.items():
            blk.child.save(os.path.join(path, f"nested__{_fname(npath)}"))
            arrays[f"nested__{npath}__parent"] = blk.parent_of
        np.savez(os.path.join(path, "arrays.npz"), **arrays)
        with open(os.path.join(path, "meta.json"), "w") as fh:
            json.dump(meta, fh)
        with open(os.path.join(path, "stored.jsonl"), "w") as fh:
            for i in range(self.ndocs):
                rec = {"_id": self.ids[i], "_source": self.sources[i]}
                if self.stored_vals and self.stored_vals[i]:
                    rec["_stored"] = self.stored_vals[i]
                fh.write(json.dumps(rec) + "\n")

    @classmethod
    def load(cls, path: str) -> "Segment":
        """A segment written by `save` (or by the reference's), its
        nested children's segments with it."""
        with open(os.path.join(path, "meta.json")) as fh:
            meta = json.load(fh)
        arrays = np.load(os.path.join(path, "arrays.npz"),
                         allow_pickle=False)
        ids, sources, stored_vals = [], [], []
        with open(os.path.join(path, "stored.jsonl")) as fh:
            for line in fh:
                rec = json.loads(line)
                ids.append(rec["_id"])
                sources.append(rec["_source"])
                stored_vals.append(rec.get("_stored"))
        postings = {}
        for f in meta["postings"]:
            with open(os.path.join(path, f"vocab__{_fname(f)}.txt")) as fh:
                content = fh.read()
            vocab = content.split("\n") if content else []
            key = f"post__{f}"
            pb = PostingsBlock(f, vocab, {t: i for i, t in enumerate(vocab)},
                               arrays[f"{key}__starts"],
                               arrays[f"{key}__doc_ids"],
                               arrays[f"{key}__tfs"])
            if f"{key}__pos_starts" in arrays.files:
                pb.pos_starts = arrays[f"{key}__pos_starts"]
                pb.positions = arrays[f"{key}__positions"]
            im = meta["impacts"].get(f)
            if im is not None:
                pb.impact = ImpactPlane(
                    q=arrays[f"imp__{f}__q"], scale=float(im["scale"]),
                    bits=int(im["bits"]), k1=float(im["k1"]),
                    b=float(im["b"]), avgdl=float(im["avgdl"]),
                    dl_max=int(im["dl_max"]),
                    block_starts=arrays[f"imp__{f}__bstarts"],
                    block_off=arrays[f"imp__{f}__boff"],
                    block_max=arrays[f"imp__{f}__bmax"],
                    kind=str(im.get("kind", "bm25")))
            # a reference segment marks a feature field by its plane alone
            pb.feature = bool(meta["postings"][f].get("feature")) or (
                pb.impact is not None and pb.impact.kind == "feature")
            postings[f] = pb
        numeric = {f: NumericColumn(f, m["kind"],
                                    arrays[f"num__{f}__values"],
                                    arrays[f"num__{f}__present"])
                   for f, m in meta["numeric"].items()}
        keyword = {}
        for f in meta["keyword"]:
            with open(os.path.join(path, f"kwvocab__{_fname(f)}.txt")) as fh:
                content = fh.read()
            keyword[f] = KeywordColumn(
                f, content.split("\n") if content else [],
                arrays[f"kw__{f}__starts"], arrays[f"kw__{f}__ords"],
                arrays[f"kw__{f}__docs"], arrays[f"kw__{f}__min_ord"])
        vectors = {f: VectorColumn(f, arrays[f"vec__{f}__values"],
                                   arrays[f"vec__{f}__present"],
                                   m.get("similarity", "cosine"),
                                   method=m.get("method"))
                   for f, m in meta.get("vector", {}).items()}
        geo = {f: GeoColumn(f, arrays[f"geo__{f}__lat"],
                            arrays[f"geo__{f}__lon"],
                            arrays[f"geo__{f}__present"])
               for f in meta.get("geo") or ()}
        shapes = {}
        for f in meta.get("shape") or ():
            with open(os.path.join(path, f"shapes__{_fname(f)}.json")) as fh:
                specs = json.load(fh)
            bbox = arrays[f"shape__{f}__bbox"]
            shapes[f] = ShapeColumn(f, specs, bbox[0], bbox[1], bbox[2],
                                    bbox[3], arrays[f"shape__{f}__present"])
        doc_lens = {k[len("dl__"):]: arrays[k] for k in arrays.files
                    if k.startswith("dl__")}
        seg = cls(meta["name"], meta["ndocs"], postings, doc_lens,
                  {f: TextFieldStats(dc, sd)
                   for f, (dc, sd) in meta["text_stats"].items()},
                  ids, sources, seq_nos=arrays["seq_nos"],
                  codec_version=int(meta.get("codec", CODEC_V1)),
                  numeric_cols=numeric, keyword_cols=keyword,
                  vector_cols=vectors,
                  stored_vals=(stored_vals if any(stored_vals) else None),
                  geo_cols=geo, shape_cols=shapes,
                  nested={npath: NestedBlock(
                      cls.load(os.path.join(path,
                                            f"nested__{_fname(npath)}")),
                      arrays[f"nested__{npath}__parent"])
                      for npath in meta.get("nested") or ()})
        seg.live = arrays["live"].copy()
        seg.id2doc = {d: i for i, d in enumerate(ids) if seg.live[i]}
        return seg


def f32_view(col: NumericColumn) -> np.ndarray:
    """f32[ndocs]: the values aggregations and scripts read, as the
    reference's `_num_field_arrays` casts them; an unsigned_long column
    unbiases back to its magnitude in f64 before the cast."""
    if col.kind == "uint":
        return (col.values.astype(np.float64) + float(1 << 63)).astype(
            np.float32)
    return col.values.astype(np.float32)


def numeric_kind(mappings: Mappings, fname: str) -> str:
    """The column kind of a numeric field (the reference's
    `_numeric_kind`): a range field's `#lo` / `#hi` column takes its
    member type's."""
    ft = mappings.resolve_field(fname)
    if ft is None and fname.endswith(("#lo", "#hi")):
        rft = mappings.resolve_field(fname[:-3])
        member = RANGE_MEMBER.get(rft.type) if rft is not None else None
        return "float" if member in ("float", "double") else "int"
    if ft is not None and ft.type == "unsigned_long":
        return "uint"
    return "float" if ft is not None and ft.type in FLOAT_TYPES else "int"


def stored_values(parsed_docs: list) -> Optional[list]:
    """Per doc its `store: true` values, or None when no doc has one."""
    if not any(d.stored for d in parsed_docs):
        return None
    return [dict(d.stored) if d.stored else None for d in parsed_docs]


def _fname(field: str) -> str:
    return field.replace("/", "_")


def pack_postings(parsed_docs: list) -> Dict[str, PostingsBlock]:
    """Pack per-doc term lists into CSR PostingsBlocks: one posting per
    (term, doc) with its tf, vocab sorted, docs ascending per term. A
    field whose term lists are all empty still gets an (empty) block.
    Every field gets its token positions (none for a keyword field: an
    all-empty positions CSR, as in the reference), flattened in posting
    order, ascending within a posting. The tokens of a field are
    flattened, interned and sorted as (term, doc) keys in numpy (the
    reference's native packer's scheme)."""
    field_tokens: Dict[str, list] = {}
    field_docs: Dict[str, list] = {}
    field_pos: Dict[str, list] = {}
    for doc_i, pd in enumerate(parsed_docs):
        for fname, terms in pd.terms.items():
            field_tokens.setdefault(fname, []).extend(terms)
            field_docs.setdefault(fname, []).append((doc_i, len(terms)))
        for fname, tps in pd.positions.items():
            field_pos.setdefault(fname, []).append((doc_i, tps))
    ndocs = max(len(parsed_docs), 1)
    out: Dict[str, PostingsBlock] = {}
    for fname, tokens in field_tokens.items():
        vocab = sorted(set(tokens))
        tid = {t: i for i, t in enumerate(vocab)}
        pairs = field_docs[fname]
        doc_of = np.repeat(
            np.fromiter((d for d, _ in pairs), np.int64, count=len(pairs)),
            np.fromiter((c for _, c in pairs), np.int64, count=len(pairs)))
        key = np.fromiter((tid[t] for t in tokens), np.int64,
                          count=len(tokens)) * ndocs + doc_of
        ukey, tf = np.unique(key, return_counts=True)
        starts = np.zeros(len(vocab) + 1, dtype=np.int64)
        np.cumsum(np.bincount(ukey // ndocs, minlength=len(vocab)),
                  out=starts[1:])
        doc_ids = (ukey % ndocs).astype(np.int32)
        tfs = tf.astype(np.float32)
        # positions: (posting key, position) pairs sorted, kept where the
        # posting exists
        pterms, pvals, pdocs = [], [], []
        for doc_i, tps in field_pos.get(fname, ()):
            if tps:
                ts, ps = zip(*tps)
                pterms.extend(ts)
                pvals.extend(ps)
                pdocs.append((doc_i, len(tps)))
        prow = np.fromiter((tid.get(t, -1) for t in pterms), np.int64,
                           count=len(pterms))
        pdoc = np.repeat(
            np.fromiter((d for d, _ in pdocs), np.int64, count=len(pdocs)),
            np.fromiter((c for _, c in pdocs), np.int64, count=len(pdocs)))
        known = prow >= 0
        pk = prow[known] * ndocs + pdoc[known]
        pv = np.asarray(pvals, np.int64)[known]
        order = np.lexsort((pv, pk))
        pk, pv = pk[order], pv[order]
        at = np.searchsorted(ukey, pk)
        keep = (at < len(ukey)) & (ukey[np.minimum(at, len(ukey) - 1)]
                                   == pk) if len(ukey) else pk < 0
        pk, pv = pk[keep], pv[keep]
        plens = (np.searchsorted(pk, ukey, side="right")
                 - np.searchsorted(pk, ukey, side="left"))
        pos_starts = np.zeros(len(ukey) + 1, np.int64)
        np.cumsum(plens, out=pos_starts[1:])
        out[fname] = PostingsBlock(fname, vocab, tid, starts, doc_ids, tfs,
                                   pos_starts, pv.astype(np.int32))
    return out


def _keyword_column(fname: str, parsed_docs: list) -> KeywordColumn:
    """One keyword field's doc values: sorted vocab, each doc's distinct
    ordinals ascending, its least ordinal (-1 without a value)."""
    vocab = sorted({v for pd in parsed_docs
                    for v in pd.keywords.get(fname, ())})
    ord_of = {v: i for i, v in enumerate(vocab)}
    ndocs = len(parsed_docs)
    starts = np.zeros(ndocs + 1, dtype=np.int64)
    flat_ords: List[int] = []
    flat_docs: List[int] = []
    min_ord = np.full(ndocs, -1, dtype=np.int32)
    for doc_i, pd in enumerate(parsed_docs):
        ords = sorted(ord_of[v] for v in set(pd.keywords.get(fname, ())))
        flat_ords.extend(ords)
        flat_docs.extend([doc_i] * len(ords))
        if ords:
            min_ord[doc_i] = ords[0]
        starts[doc_i + 1] = len(flat_ords)
    return KeywordColumn(fname, vocab, starts,
                         np.asarray(flat_ords, dtype=np.int32),
                         np.asarray(flat_docs, dtype=np.int32), min_ord)


def feature_postings(fname: str, parsed_docs: list) -> PostingsBlock:
    """One feature field's CSR postings: rows are the sorted features,
    docs ascending within a row, the tf slot each doc's f32 weight."""
    feat_docs: Dict[str, List[Tuple[int, float]]] = {}
    for doc_i, pd in enumerate(parsed_docs):
        for feat, w in pd.features.get(fname, {}).items():
            feat_docs.setdefault(feat, []).append((doc_i, w))
    vocab = sorted(feat_docs)
    starts = np.zeros(len(vocab) + 1, dtype=np.int64)
    np.cumsum([len(feat_docs[t]) for t in vocab], out=starts[1:])
    flat = [p for t in vocab for p in feat_docs[t]]
    return PostingsBlock(
        fname, vocab, {t: i for i, t in enumerate(vocab)}, starts,
        np.fromiter((d for d, _ in flat), np.int32, count=len(flat)),
        np.fromiter((w for _, w in flat), np.float32, count=len(flat)),
        feature=True)


def feature_impact_fields(mappings: Mappings, fields) -> List[str]:
    """The feature fields among `fields` whose mapping set
    `index_impacts`: those get a FEATURE plane at a refresh."""
    return [f for f in sorted(fields)
            if getattr(mappings.resolve_field(f), "index_impacts", False)]


def build_segment(name: str, parsed_docs: list, mappings: Mappings,
                  seq_nos: Optional[List[int]] = None,
                  device=None) -> Segment:
    """Build an immutable segment from buffered parsed docs (the refresh
    path): positional postings, feature postings, codec v2 unless
    OPENSEARCH_TPU_CODEC=1, with large impact planes (FEATURE planes for
    the feature fields whose mapping set `index_impacts`) quantized on
    `device`."""
    ndocs = len(parsed_docs)
    doc_lens: Dict[str, np.ndarray] = {}
    text_stats: Dict[str, TextFieldStats] = {}
    for doc_i, pd in enumerate(parsed_docs):
        for fname, terms in pd.terms.items():
            ft = mappings.resolve_field(fname)
            if ft is not None and ft.type == "text":
                stats = text_stats.setdefault(fname, TextFieldStats())
                stats.doc_count += 1
                stats.sum_dl += len(terms)
                dl = doc_lens.setdefault(fname, np.zeros(ndocs, dtype=np.int64))
                dl[doc_i] = len(terms)
    numeric_cols: Dict[str, NumericColumn] = {}
    for fname in sorted({f for pd in parsed_docs for f in pd.numerics}):
        kind = numeric_kind(mappings, fname)
        values = np.zeros(ndocs, dtype=np.float64 if kind == "float"
                          else np.int64)
        present = np.zeros(ndocs, dtype=bool)
        for doc_i, pd in enumerate(parsed_docs):
            vals = pd.numerics.get(fname)
            if vals:
                values[doc_i] = vals[0]
                present[doc_i] = True
        numeric_cols[fname] = NumericColumn(fname, kind, values, present)
    keyword_cols = {f: _keyword_column(f, parsed_docs)
                    for f in sorted({f for pd in parsed_docs
                                     for f in pd.keywords})}
    vector_cols: Dict[str, VectorColumn] = {}
    for fname in sorted({f for pd in parsed_docs for f in pd.vectors}):
        ft = mappings.resolve_field(fname)
        dims = next(len(pd.vectors[fname]) for pd in parsed_docs
                    if fname in pd.vectors)
        values = np.zeros((ndocs, dims), np.float32)
        present = np.zeros(ndocs, bool)
        for doc_i, pd in enumerate(parsed_docs):
            vec = pd.vectors.get(fname)
            if vec is not None:
                values[doc_i] = vec
                present[doc_i] = True
        vector_cols[fname] = VectorColumn(
            fname, values, present,
            ft.vector_similarity if ft is not None else "cosine",
            method=ft.vector_method if ft is not None else None)
    geo_cols: Dict[str, GeoColumn] = {}
    for fname in sorted({f for pd in parsed_docs for f in pd.geos}):
        lat = np.zeros(ndocs, dtype=np.float32)
        lon = np.zeros(ndocs, dtype=np.float32)
        present = np.zeros(ndocs, dtype=bool)
        for doc_i, pd in enumerate(parsed_docs):
            vals = pd.geos.get(fname)
            if vals:
                lat[doc_i], lon[doc_i] = vals[0]
                present[doc_i] = True
        geo_cols[fname] = GeoColumn(fname, lat, lon, present)
    shape_cols: Dict[str, ShapeColumn] = {}
    for fname in sorted({f for pd in parsed_docs for f in pd.shapes}):
        specs: list = [None] * ndocs
        box = np.empty((4, ndocs))
        box[:2], box[2:] = np.inf, -np.inf
        present = np.zeros(ndocs, bool)
        for doc_i, pd in enumerate(parsed_docs):
            vals = pd.shapes.get(fname)     # [(spec, bbox)]
            if not vals:
                continue
            specs[doc_i] = [sp for sp, _bx in vals]
            present[doc_i] = True
            for _sp, bx in vals:
                box[:2, doc_i] = np.minimum(box[:2, doc_i], bx[:2])
                box[2:, doc_i] = np.maximum(box[2:, doc_i], bx[2:])
        shape_cols[fname] = ShapeColumn(fname, specs, *box, present)
    # each nested path's children: a segment of their own
    nested: Dict[str, NestedBlock] = {}
    for npath in sorted({p for pd in parsed_docs for p in pd.nested}):
        child_docs, parent_of = [], []
        for doc_i, pd in enumerate(parsed_docs):
            for child in pd.nested.get(npath, ()):
                child_docs.append(child)
                parent_of.append(doc_i)
        nested[npath] = NestedBlock(
            build_segment(f"{name}/{npath}", child_docs, mappings,
                          device=device),
            np.asarray(parent_of, dtype=np.int32))
    postings = pack_postings(parsed_docs)
    feat_fields = {f for pd in parsed_docs for f in pd.features}
    for fname in sorted(feat_fields):
        postings[fname] = feature_postings(fname, parsed_docs)
    seq = np.asarray(seq_nos, dtype=np.int64) if seq_nos is not None else None
    seg = Segment(name, ndocs, postings,
                  doc_lens, text_stats, [d.doc_id for d in parsed_docs],
                  [d.source for d in parsed_docs], seq_nos=seq,
                  numeric_cols=numeric_cols, keyword_cols=keyword_cols,
                  vector_cols=vector_cols,
                  stored_vals=stored_values(parsed_docs),
                  geo_cols=geo_cols, shape_cols=shape_cols, nested=nested)
    if default_codec_version() >= CODEC_V2:
        seg.build_impacts(feature_fields=feature_impact_fields(
            mappings, feat_fields), device=device)
    return seg
