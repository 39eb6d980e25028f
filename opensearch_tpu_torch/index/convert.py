"""Build a port Segment from plain numpy arrays and Python lists.

The arguments are exactly what an opensearch_tpu Segment holds for its
inverted fields (CSR postings, doc lengths, text stats and, on codec v2,
each field's ImpactPlane arrays) and its integer/long doc values (each
NumericColumn's kind, values and present mask), so a segment built there
(or a CSR corpus made from a seed, as `bench_corpus.py` does) carries
across without re-indexing.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..errors import NotPortedError
from .segment import (CODEC_V2, ImpactPlane, NumericColumn, PostingsBlock,
                      Segment, TextFieldStats, default_codec_version)

IMPACT_FIELDS = ("q", "scale", "bits", "k1", "b", "avgdl", "dl_max",
                 "block_starts", "block_off", "block_max")


def segment_from_arrays(name: str, ndocs: int,
                        postings: Dict[str, dict],
                        doc_lens: Dict[str, np.ndarray],
                        text_stats: Dict[str, Tuple[int, int]],
                        ids: Sequence[str], sources: Sequence[dict],
                        live: Optional[np.ndarray] = None,
                        impacts: Optional[Dict[str, dict]] = None,
                        numeric_cols: Optional[Dict[str, object]] = None,
                        device=None) -> Segment:
    """`postings[field]` = dict(vocab, starts, doc_ids, tfs) in CSR form
    (vocab sorted, docs ascending per row); `text_stats[field]` =
    (doc_count, sum_dl); `live` None means no deletes. `ids`/`sources` may
    be any indexable sequences (a lazy view serves a synthetic corpus).

    `impacts[field]` = dict of IMPACT_FIELDS (a reference segment's
    ImpactPlane) attaches those planes as they are and stamps the segment
    codec v2. Without it the segment is codec v2 with planes built here
    (quantized on `device`), unless OPENSEARCH_TPU_CODEC=1 pins v1, as a
    refresh does.

    `numeric_cols[field]` = a reference segment's NumericColumn, or a dict
    of its `kind`, `values` and `present`, taken as it is; only the "int"
    kind (integer/long fields) is ported."""
    blocks = {}
    for field, p in postings.items():
        vocab = list(p["vocab"])
        starts = np.asarray(p["starts"], np.int64)
        doc_ids = np.asarray(p["doc_ids"], np.int32)
        tfs = np.asarray(p["tfs"], np.float32)
        if len(starts) != len(vocab) + 1 or int(starts[-1]) != len(doc_ids) \
                or len(tfs) != len(doc_ids):
            raise ValueError(f"inconsistent CSR arrays for field [{field}]")
        blocks[field] = PostingsBlock(field, vocab,
                                      {t: i for i, t in enumerate(vocab)},
                                      starts, doc_ids, tfs)
    cols = {}
    for field, col in (numeric_cols or {}).items():
        get = col.get if isinstance(col, dict) else col.__getattribute__
        if get("kind") != "int":
            raise NotPortedError(f"numeric column [{field}] of kind "
                                 f"[{get('kind')}]")
        cols[field] = NumericColumn(field, "int",
                                    np.asarray(get("values"), np.int64),
                                    np.asarray(get("present"), bool))
    seg = Segment(name, int(ndocs), blocks,
                  {f: np.asarray(v, np.int64) for f, v in doc_lens.items()},
                  {f: TextFieldStats(int(dc), int(sdl))
                   for f, (dc, sdl) in text_stats.items()},
                  [], [], numeric_cols=cols)
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
                **{k: fields[k] for k in IMPACT_FIELDS})
        seg.codec_version = CODEC_V2
    elif default_codec_version() >= CODEC_V2:
        seg.build_impacts(device=device)
    return seg
