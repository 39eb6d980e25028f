"""Build a port Segment from plain numpy arrays and Python lists.

The arguments are exactly what a codec-v1 opensearch_tpu Segment holds for
its inverted fields, so a segment built there (or a CSR corpus made from a
seed, as `bench_corpus.py` does) carries across without re-indexing.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .segment import PostingsBlock, Segment, TextFieldStats


def segment_from_arrays(name: str, ndocs: int,
                        postings: Dict[str, dict],
                        doc_lens: Dict[str, np.ndarray],
                        text_stats: Dict[str, Tuple[int, int]],
                        ids: Sequence[str], sources: Sequence[dict],
                        live: Optional[np.ndarray] = None) -> Segment:
    """`postings[field]` = dict(vocab, starts, doc_ids, tfs) in CSR form
    (vocab sorted, docs ascending per row); `text_stats[field]` =
    (doc_count, sum_dl); `live` None means no deletes. `ids`/`sources` may
    be any indexable sequences (a lazy view serves a synthetic corpus)."""
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
    seg = Segment(name, int(ndocs), blocks,
                  {f: np.asarray(v, np.int64) for f, v in doc_lens.items()},
                  {f: TextFieldStats(int(dc), int(sdl))
                   for f, (dc, sdl) in text_stats.items()},
                  [], [])
    seg.ids = ids
    seg.sources = sources
    # a lazy id view is not enumerated: nothing in this slice looks ids up
    seg.id2doc = ({d: i for i, d in enumerate(ids)} if isinstance(ids, list)
                  else {})
    if live is not None:
        seg.live = np.asarray(live, bool).copy()
    return seg
