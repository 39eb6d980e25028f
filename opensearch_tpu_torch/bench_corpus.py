"""MS-MARCO-passage-shaped synthetic corpus and query pickers (copies of
the corpus builder, index attach and query pickers of the repo's bench.py),
attached to a port index as one segment, codec v2 (impact planes built on
the client's device) unless OPENSEARCH_TPU_CODEC=1, as bench.py attaches
it.

The corpus is made from a seed: lognormal doc lengths around 56 tokens
(8..256), Zipf(1.15) terms over a 200k vocabulary, one posting per
(term, doc) with its tf.
"""

from __future__ import annotations

import numpy as np

from .index.convert import segment_from_arrays


def build_corpus(ndocs: int, vocab: int = 200_000, avg_dl: int = 56,
                 seed: int = 0):
    """-> (starts i64[vocab+1], doc_ids i32[P], tfs f32[P], dl i64[ndocs],
    df i64[vocab]) of a CSR body field."""
    rng = np.random.default_rng(seed)
    dl = np.clip(rng.lognormal(np.log(avg_dl), 0.4, ndocs), 8,
                 256).astype(np.int64)
    total = int(dl.sum())
    doc_of_tok = np.repeat(np.arange(ndocs, dtype=np.int64), dl)
    terms = rng.zipf(1.15, total).astype(np.int64)
    terms = np.where(terms > vocab, rng.integers(1, vocab, total), terms) - 1
    keys = terms * ndocs + doc_of_tok
    del terms, doc_of_tok
    uniq, counts = np.unique(keys, return_counts=True)
    del keys
    term_arr = (uniq // ndocs).astype(np.int64)
    doc_ids = (uniq % ndocs).astype(np.int32)
    del uniq
    tfs = counts.astype(np.float32)
    df_per_term = np.bincount(term_arr, minlength=vocab)
    starts = np.zeros(vocab + 1, dtype=np.int64)
    np.cumsum(df_per_term, out=starts[1:])
    # every token of a doc lands in exactly one of its postings
    true_dl = np.bincount(doc_ids, weights=counts,
                          minlength=ndocs).astype(np.int64)
    return starts, doc_ids, tfs, true_dl, df_per_term


def vocab_strings(n: int) -> list:
    return [f"t{i:07d}" for i in range(n)]


class LazyIds:
    """Doc-id strings materialized on demand (fetch touches ~10 a query)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return str(i)


class LazySources:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"doc": int(i)}


def make_index(client, corpus, name: str = "bench"):
    """Create index `name` with a text field `body` and attach the CSR
    corpus as its one segment. Returns the segment."""
    starts, doc_ids, tfs, dl, _df = corpus
    ndocs = len(dl)
    seg = segment_from_arrays(
        "bench0", ndocs,
        {"body": {"vocab": vocab_strings(len(starts) - 1), "starts": starts,
                  "doc_ids": doc_ids, "tfs": tfs}},
        {"body": dl}, {"body": (ndocs, int(dl.sum()))},
        LazyIds(ndocs), LazySources(ndocs), device=client.device)
    client.indices.create(name, {"mappings": {"properties": {
        "body": {"type": "text"}}}})
    client._indices[name].engine.segments = [seg]
    return seg


def pick_queries(df_per_term, nq: int, seed: int = 1):
    """Queries of mid-frequency terms (selective, MS-MARCO-like); the
    bench's match bodies use the first two of each row."""
    rng = np.random.default_rng(seed)
    order = np.argsort(-df_per_term)
    lo, hi = 100, 20_000
    pool = order[lo:hi]
    pool = pool[df_per_term[pool] > 0]
    return rng.choice(pool, size=(nq, 3), replace=True).astype(np.int32)


def pick_queries_real(df_per_term, nq: int, nterms: int = 6, seed: int = 9):
    """Realistic-shape queries: ~6 terms sampled proportional to corpus
    token mass, with NO df-rank floor, so stopword-class terms appear with
    their natural frequency."""
    rng = np.random.default_rng(seed)
    vocab = len(df_per_term)
    out = np.zeros((nq, nterms), np.int32)
    for qi in range(nq):
        terms = rng.zipf(1.15, nterms * 3).astype(np.int64)
        terms = np.where(terms > vocab,
                         rng.integers(1, vocab, nterms * 3), terms) - 1
        terms = terms[df_per_term[terms] > 0]
        uniq = list(dict.fromkeys(terms.tolist()))[:nterms]
        while len(uniq) < nterms:      # top up with any in-corpus term
            t = int(rng.integers(0, vocab))
            if df_per_term[t] > 0 and t not in uniq:
                uniq.append(t)
        out[qi] = uniq
    return out
