"""Immutable index segments, codecs v1 and v2 (the CSR-postings and
impact-plane subset of opensearch_tpu/index/segment.py).

Postings for one field are a CSR matrix over (term row -> doc postings):
`starts[t]..starts[t+1]` index flat `doc_ids` / `tfs` arrays, rows in
sorted-vocab order, docs ascending within a row. `doc_lens` holds each text
field's per-doc token count and `text_stats` its (doc_count, sum_dl), the
collection statistics BM25 reads. `numeric_cols` holds each integer/long
field's doc values (the first value of each doc, exact i64, and a
`present` mask), which range filters read. The host arrays are numpy. The
search layer builds the device-resident aligned layout it needs
(`search/fastpath.py`); the general query path reads, per device and
cached on the segment, the live mask, doc lengths, numeric columns and,
for a field the aligned layout cannot pack, a CSR copy of its postings
(`live_on`, `doc_lens_on`, `numeric_on`, `csr_on`).

Codec v2 (the default for new segments, as in the reference) adds a
per-field impact plane: the BM25 tf-saturation tf/(tf + k1(1-b+b dl/avgdl))
evaluated at build time under nominal similarity parameters, quantized to
u8/u16 with one global per-field scale, plus a per-128-posting block-max
sidecar. The quantizer runs as torch ops on the engine's device for large
planes (`ops/device_merge.py`) and in numpy below DEVICE_IMPACT_MIN
postings, as the reference does. Feature planes (rank_features) are not
ported.
"""

from __future__ import annotations

import functools
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..errors import NotPortedError
from .mappings import Mappings

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
    # codec v2: quantized eager impacts + block-max sidecar (None on v1)
    impact: Optional[ImpactPlane] = None

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
    """Doc values of one integer/long field: `values[d]` is the first
    value of doc d (0 where `present[d]` is false)."""

    field: str
    kind: str                 # "int" (integer/long, exact i64)
    values: np.ndarray        # i64[ndocs]
    present: np.ndarray       # bool[ndocs]

    @functools.cached_property
    def min_max(self) -> Tuple[float, float]:
        if not self.present.any():
            return (0.0, 0.0)
        vals = self.values[self.present]
        return (float(vals.min()), float(vals.max()))


@dataclass
class TextFieldStats:
    doc_count: int = 0        # docs containing this field
    sum_dl: int = 0           # total tokens across docs


class Segment:
    """One immutable searchable unit."""

    _seq = 0

    def __init__(self, name: str, ndocs: int,
                 postings: Dict[str, PostingsBlock],
                 doc_lens: Dict[str, np.ndarray],
                 text_stats: Dict[str, TextFieldStats],
                 ids, sources, seq_nos: Optional[np.ndarray] = None,
                 codec_version: int = CODEC_V1,
                 numeric_cols: Optional[Dict[str, NumericColumn]] = None):
        Segment._seq += 1
        self.uid = Segment._seq
        self.name = name
        self.ndocs = ndocs
        self.postings = postings
        self.doc_lens = doc_lens
        self.text_stats = text_stats
        self.numeric_cols = numeric_cols or {}
        self.ids = ids
        self.sources = sources
        self.seq_nos = (seq_nos if seq_nos is not None
                        else np.zeros(ndocs, dtype=np.int64))
        self.live = np.ones(ndocs, dtype=bool)
        self.live_gen = 0         # bumped by every delete
        self.id2doc: Dict[str, int] = {d: i for i, d in enumerate(ids)}
        # segment codec (CODEC_V1 | CODEC_V2): consumers branching on the
        # posting layout consult this attribute
        self.codec_version = int(codec_version)
        # search-layer caches keyed by (field, device): AlignedPostings,
        # quality tiers and filtered views, built by search/fastpath.py,
        # and filter masks, built by search/filters.py
        self.aligned: dict = {}
        # the general path's device arrays (see `device_cached`)
        self.device_arrays: dict = {}

    # ---------------- codec v2: impact planes ----------------

    def build_impacts(self, bits: Optional[int] = None,
                      feature_fields: Sequence[str] = (),
                      device=None) -> None:
        """Build quantized impact planes for every text-scored field
        (fields with a doc-length column) and stamp the segment codec v2.
        Idempotent. Feature planes (rank_features fields that opted into
        `index_impacts`) are not ported and raise."""
        if feature_fields:
            raise NotPortedError("feature impact planes (rank_features "
                                 "fields with index_impacts)")
        for f, pb in self.postings.items():
            if pb.impact is not None or f not in self.doc_lens:
                continue
            st = self.text_stats.get(f)
            avgdl = (st.sum_dl / st.doc_count
                     if st is not None and st.doc_count > 0 else None)
            pb.impact = build_impact_plane(pb, self.doc_lens.get(f),
                                           avgdl=avgdl, bits=bits,
                                           device=device)
        self.codec_version = CODEC_V2
        self.aligned = {}
        self.device_arrays = {}

    def drop_impacts(self) -> None:
        """Demote to codec v1: planes dropped, the search layer's device
        layouts rebuilt without them on next use."""
        for pb in self.postings.values():
            pb.impact = None
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

    def csr_on(self, field: str, device):
        """(doc ids i32[P], tfs f32[P], impacts i32[P] or None) of a
        field's CSR postings: the general path's copy of a field that the
        aligned layout cannot pack."""
        pb = self.postings[field]

        def make():
            imp = (None if pb.impact is None else
                   torch.from_numpy(pb.impact.q.astype(np.int32)).to(device))
            return (torch.from_numpy(pb.doc_ids).to(device),
                    torch.from_numpy(pb.tfs).to(device), imp)
        return self.device_cached(("csr", field), device, make)

    def device_nbytes(self, device) -> int:
        """Bytes of the general path's device arrays on `device`."""
        n = 0
        for k, v in self.device_arrays.items():
            if k[-1] == str(device):
                for t in (v if isinstance(v, tuple) else (v,)):
                    if isinstance(t, torch.Tensor):
                        n += t.numel() * t.element_size()
        return n


def pack_postings(parsed_docs: list) -> Dict[str, PostingsBlock]:
    """Pack per-doc term lists into CSR PostingsBlocks: one posting per
    (term, doc) with its tf, vocab sorted, docs ascending per term. A
    field whose term lists are all empty still gets an (empty) block."""
    field_term_docs: Dict[str, Dict[str, dict]] = {}
    for doc_i, pd in enumerate(parsed_docs):
        for fname, terms in pd.terms.items():
            td = field_term_docs.setdefault(fname, {})
            for t in terms:
                postings = td.setdefault(t, {})
                postings[doc_i] = postings.get(doc_i, 0) + 1
    out: Dict[str, PostingsBlock] = {}
    for fname, term_docs in field_term_docs.items():
        vocab = sorted(term_docs)
        lens = np.fromiter((len(term_docs[t]) for t in vocab), np.int64,
                           count=len(vocab))
        starts = np.zeros(len(vocab) + 1, dtype=np.int64)
        np.cumsum(lens, out=starts[1:])
        doc_ids = np.empty(int(starts[-1]), dtype=np.int32)
        tfs = np.empty(int(starts[-1]), dtype=np.float32)
        k = 0
        for t in vocab:
            d = term_docs[t]
            for doc_i in sorted(d):
                doc_ids[k] = doc_i
                tfs[k] = d[doc_i]
                k += 1
        out[fname] = PostingsBlock(fname, vocab,
                                   {t: i for i, t in enumerate(vocab)},
                                   starts, doc_ids, tfs)
    return out


def build_segment(name: str, parsed_docs: list, mappings: Mappings,
                  seq_nos: Optional[List[int]] = None,
                  device=None) -> Segment:
    """Build an immutable segment from buffered parsed docs (the refresh
    path); codec v2 unless OPENSEARCH_TPU_CODEC=1, with large impact
    planes quantized on `device`."""
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
        values = np.zeros(ndocs, dtype=np.int64)
        present = np.zeros(ndocs, dtype=bool)
        for doc_i, pd in enumerate(parsed_docs):
            vals = pd.numerics.get(fname)
            if vals:
                values[doc_i] = vals[0]
                present[doc_i] = True
        numeric_cols[fname] = NumericColumn(fname, "int", values, present)
    seq = np.asarray(seq_nos, dtype=np.int64) if seq_nos is not None else None
    seg = Segment(name, ndocs, pack_postings(parsed_docs), doc_lens,
                  text_stats, [d.doc_id for d in parsed_docs],
                  [d.source for d in parsed_docs], seq_nos=seq,
                  numeric_cols=numeric_cols)
    if default_codec_version() >= CODEC_V2:
        seg.build_impacts(device=device)
    return seg
