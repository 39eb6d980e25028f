"""Immutable index segments, codec v1 (the CSR-postings subset of
opensearch_tpu/index/segment.py).

Postings for one field are a CSR matrix over (term row -> doc postings):
`starts[t]..starts[t+1]` index flat `doc_ids` / `tfs` arrays, rows in
sorted-vocab order, docs ascending within a row. `doc_lens` holds each text
field's per-doc token count and `text_stats` its (doc_count, sum_dl), the
collection statistics BM25 reads. Everything here is host numpy: the
search layer builds the device-resident aligned layout it needs
(`search/fastpath.py`). No impact plane (codec v2) in this slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .mappings import Mappings

CODEC_V1 = 1


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
                 ids, sources, seq_nos: Optional[np.ndarray] = None):
        Segment._seq += 1
        self.uid = Segment._seq
        self.name = name
        self.ndocs = ndocs
        self.postings = postings
        self.doc_lens = doc_lens
        self.text_stats = text_stats
        self.ids = ids
        self.sources = sources
        self.seq_nos = (seq_nos if seq_nos is not None
                        else np.zeros(ndocs, dtype=np.int64))
        self.live = np.ones(ndocs, dtype=bool)
        self.id2doc: Dict[str, int] = {d: i for i, d in enumerate(ids)}
        self.codec_version = CODEC_V1
        # (field, device) -> AlignedPostings, built by search/fastpath.py
        self.aligned: dict = {}

    def delete_doc(self, local_doc: int) -> None:
        self.live[local_doc] = False

    @property
    def live_count(self) -> int:
        return int(self.live.sum())


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
                  seq_nos: Optional[List[int]] = None) -> Segment:
    """Build an immutable segment from buffered parsed docs (the refresh
    path)."""
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
    seq = np.asarray(seq_nos, dtype=np.int64) if seq_nos is not None else None
    return Segment(name, ndocs, pack_postings(parsed_docs), doc_lens,
                   text_stats, [d.doc_id for d in parsed_docs],
                   [d.source for d in parsed_docs], seq_nos=seq)
