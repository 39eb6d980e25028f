"""MS-MARCO-passage-shaped synthetic corpus and query pickers (copies of
the corpus builder, index attach, guardrail columns, query pickers and
bool bodies of the repo's bench.py), attached to a port index as one
segment, codec v2 (impact planes built on the client's device) unless
OPENSEARCH_TPU_CODEC=1, as bench.py attaches it.

The corpus is made from a seed: lognormal doc lengths around 56 tokens
(8..256), Zipf(1.15) terms over a 200k vocabulary, one posting per
(term, doc) with its tf. Its guardrail columns, as bench.py's second
configuration has them: a `status` keyword (archived / draft /
published, uniform) as one postings row per value, and an `integer`
`price` uniform over 0..999.
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

    def find(self, doc_id: str) -> int:
        """Local doc of an id string, or -1."""
        ok = doc_id.isdigit() and str(int(doc_id)) == doc_id
        return int(doc_id) if ok and int(doc_id) < self.n else -1


class LazySources:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"doc": int(i)}


STATUS_VALUES = ["archived", "draft", "published"]


def guardrail_columns(ndocs: int, seed: int = 3) -> tuple:
    """(status ordinals i32[ndocs] into STATUS_VALUES, price i64[ndocs]),
    drawn as bench.py draws them."""
    rng = np.random.default_rng(seed)
    status_ord = rng.integers(0, 3, ndocs).astype(np.int32)
    price = rng.integers(0, 1000, ndocs).astype(np.int64)
    return status_ord, price


def make_index(client, corpus, name: str = "bench", columns=None):
    """Create index `name` with a text field `body` and attach the CSR
    corpus as its one segment; with `columns` (guardrail_columns), also
    the `status` keyword postings and the `price` integer column, as
    bench.py's make_index builds them. Returns the segment."""
    starts, doc_ids, tfs, dl, _df = corpus
    ndocs = len(dl)
    postings = {"body": {"vocab": vocab_strings(len(starts) - 1),
                         "starts": starts, "doc_ids": doc_ids, "tfs": tfs}}
    props = {"body": {"type": "text"}}
    numeric = None
    if columns is not None:
        status_ord, price = columns
        # keyword term queries run against postings: one row per value
        scounts = np.bincount(status_ord, minlength=3)
        sstarts = np.zeros(4, np.int64)
        np.cumsum(scounts, out=sstarts[1:])
        postings["status"] = {
            "vocab": STATUS_VALUES, "starts": sstarts,
            "doc_ids": np.argsort(status_ord, kind="stable").astype(np.int32),
            "tfs": np.ones(ndocs, np.float32)}
        numeric = {"price": {"kind": "int", "values": price.astype(np.int64),
                             "present": np.ones(ndocs, bool)}}
        props.update({"status": {"type": "keyword"},
                      "price": {"type": "integer"}})
    seg = segment_from_arrays(
        "bench0", ndocs, postings, {"body": dl},
        {"body": (ndocs, int(dl.sum()))}, LazyIds(ndocs), LazySources(ndocs),
        numeric_cols=numeric, device=client.device)
    client.indices.create(name, {"mappings": {"properties": props}})
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


# ---------------------------------------------------------------------
# bool traffic: bench.py's guardrail filters and config-2 bodies, and the
# mix that keeps every query on the bool kernel
# ---------------------------------------------------------------------

FILTERS_DSL = {
    "pub": [{"term": {"status": "published"}}],
    "pubprice": [{"term": {"status": "published"}},
                 {"range": {"price": {"gte": 250, "lt": 750}}}],
    "draft": [{"term": {"status": "draft"}}],
}


def guardrail_masks(status_ord: np.ndarray, price: np.ndarray) -> dict:
    """The docs each FILTERS_DSL entry keeps, from the columns."""
    pub = status_ord == 2
    return {"pub": pub, "pubprice": pub & (price >= 250) & (price < 750),
            "draft": status_ord == 1}


def bool_shape(i: int, q) -> tuple:
    """bench.py's config 2: i%3 == 0 a 2-term OR match under
    status:published, 1 a 2-term AND under published and a price range, 2
    a 3-term match with minimum_should_match 2 under status:draft."""
    if i % 3 == 0:
        return q[:2], 1, "pub"
    if i % 3 == 1:
        return q[:2], 2, "pubprice"
    return q[:3], 2, "draft"


def bool_body(i: int, queries, vs, size: int = 10) -> dict:
    """bench.py's config-2 body for query row i."""
    qt, msm, fk = bool_shape(i, queries[i])
    terms = " ".join(vs[t] for t in qt)
    if msm == len(qt):
        must = {"match": {"body": {"query": terms, "operator": "and"}}}
    elif msm > 1:
        must = {"match": {"body": {"query": terms,
                                   "minimum_should_match": msm}}}
    else:
        must = {"match": {"body": terms}}
    return {"query": {"bool": {"must": [must], "filter": FILTERS_DSL[fk]}},
            "size": size}


def b3_body(i: int, queries, vs, size: int = 10) -> dict:
    """Bool shapes that no pure rung serves, so every one rides the bool
    kernel: i%4 == 0 a 2-term match, a bonus should term and
    status:published; 1 a required term, two should terms (one must
    match) and must_not status:archived; 2 a 2-term match under a ~1%
    price range; 3 a constant_score (boost 2) of status:draft and a
    price range."""
    q = queries[i]
    a, b, c = (vs[t] for t in q[:3])
    kind = i % 4
    if kind == 0:
        query = {"bool": {"must": [{"match": {"body": f"{a} {b}"}}],
                          "should": [{"term": {"body": c}}],
                          "filter": FILTERS_DSL["pub"]}}
    elif kind == 1:
        query = {"bool": {"must": [{"term": {"body": a}}],
                          "should": [{"term": {"body": b}},
                                     {"term": {"body": c}}],
                          "minimum_should_match": 1,
                          "must_not": [{"term": {"status": "archived"}}]}}
    elif kind == 2:
        query = {"bool": {"must": [{"match": {"body": f"{a} {b}"}}],
                          "filter": [{"range": {"price": {"gte": 250,
                                                          "lt": 260}}}]}}
    else:
        query = {"constant_score": {"filter": {"bool": {"filter": [
            {"term": {"status": "draft"}},
            {"range": {"price": {"gte": 500, "lt": 510}}}]}},
            "boost": 2.0}}
    return {"query": query, "size": size}
