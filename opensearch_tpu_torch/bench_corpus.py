"""MS-MARCO-passage-shaped synthetic corpus and query pickers (copies of
the corpus builder, index attach, guardrail columns, query pickers and
bool bodies of the repo's bench.py), attached to a port index as one
segment, codec v2 (impact planes built on the client's device) unless
OPENSEARCH_TPU_CODEC=1, as bench.py attaches it.

The corpus is made from a seed: lognormal doc lengths around 56 tokens
(8..256), Zipf(1.15) terms over a 200k vocabulary, one posting per
(term, doc) with its tf. Its guardrail columns, as bench.py's second
configuration has them: a `status` keyword (archived / draft /
published, uniform) as one postings row per value and its keyword doc
values, and an `integer` `price` uniform over 0..999. Its aggregation
columns (`agg_columns`): a `date` `ts` over 2024 and a `double`
`rating` that about 5% of docs lack. Its positional `title` field, as bench.py's
third configuration has it: 8 tokens a passage, 4 bigrams from a
2,000-pair Zipf(1.3) pool over 1,000 terms; the phrase and mixed bodies
are bench.py's.

The Q&A corpus (`qa_draws`) follows OpenSearch Benchmark's `nested`
workload's schema: questions with a title, tags, a user and a
creationDate, and nested answers with a user and a date;
`qa_segment` attaches it as one segment with its answers' NestedBlock,
`qa_join_segment` as questions and answers joined by a `join` field.
"""

from __future__ import annotations

import numpy as np

from .index.convert import segment_from_arrays


def corpus_draws(ndocs: int, vocab: int = 200_000, avg_dl: int = 56,
                 seed: int = 0) -> tuple:
    """The body field's random draws from `seed`, in bench.py's order:
    (doc lengths i64[ndocs], Zipf(1.15) ranks i64[tokens], the uniform
    ranks that replace those past `vocab`) -- the host half of
    `build_corpus`, nothing but numpy's generator (whose draws release
    the interpreter lock, so a caller may run it on a thread)."""
    rng = np.random.default_rng(seed)
    dl = np.clip(rng.lognormal(np.log(avg_dl), 0.4, ndocs), 8,
                 256).astype(np.int64)
    total = int(dl.sum())
    terms = rng.zipf(1.15, total).astype(np.int64, copy=False)
    return dl, terms, rng.integers(1, vocab, total)


def corpus_keys(draws: tuple, vocab: int = 200_000, device=None):
    """The (term * ndocs + doc) keys of `corpus_draws`, i64 in token
    order, on `device` (the CPU when None): integer steps, the same on
    any device."""
    import torch
    dl, terms, repl = (torch.from_numpy(a).to(device or "cpu")
                       for a in draws)
    terms = torch.where(terms > vocab, repl, terms) - 1
    del repl
    ndocs = len(dl)
    return terms * ndocs + torch.repeat_interleave(
        torch.arange(ndocs, dtype=torch.int64, device=terms.device), dl)


def build_corpus(ndocs: int, vocab: int = 200_000, avg_dl: int = 56,
                 seed: int = 0, device=None, draws=None):
    """-> (starts i64[vocab+1], doc_ids i32[P], tfs f32[P], dl i64[ndocs],
    df i64[vocab]) of a CSR body field. The (term, doc) keys of
    `corpus_draws` (or of `draws` drawn by it already) are made and
    counted on `device` (the CPU when None): the same sorted keys and
    counts as bench.py's np.unique."""
    import torch
    if draws is None:
        draws = corpus_draws(ndocs, vocab, avg_dl, seed)
    keys = corpus_keys(draws, vocab, device)
    del draws
    u, c = torch.unique(keys, sorted=True, return_counts=True)
    del keys
    uniq, counts = u.cpu().numpy(), c.cpu().numpy()
    del u, c
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


def build_title_corpus(ndocs: int, npairs: int = 2000, tvocab: int = 1000,
                       seed: int = 2):
    """bench.py's positional short field: 8 tokens a passage, 4 bigrams
    drawn Zipf(1.3) from a pool of `npairs` (first, second) term pairs
    over `tvocab` terms, so phrase queries on pool bigrams match. -> (starts
    i64[tvocab+1], doc_ids i32[P], tfs f32[P], pos_starts i64[P+1],
    positions i32, first i64[npairs], second i64[npairs], pair_counts
    i64[npairs], the draw u16[ndocs, 4]: each passage's pairs, doc-major,
    from which `LazySources` renders the text)."""
    assert tvocab <= 1 << 15
    rng = np.random.default_rng(seed)
    first = rng.integers(0, tvocab, npairs).astype(np.int64)
    second = rng.integers(0, tvocab, npairs).astype(np.int64)
    pr = rng.zipf(1.3, (ndocs, 4)).astype(np.int64)
    pr = np.where(pr > npairs, rng.integers(1, npairs, (ndocs, 4)), pr) - 1
    tok = np.empty((ndocs, 8), np.int64)
    tok[:, 0::2] = first[pr]
    tok[:, 1::2] = second[pr]
    t = tok.ravel()
    doc = np.repeat(np.arange(ndocs, dtype=np.int64), 8)
    pos = np.tile(np.arange(8, dtype=np.int64), ndocs)
    # tokens lie in (doc, pos) order: a stable sort by term alone (a
    # radix sort of 16-bit terms) is bench.py's sort by (term, doc, pos)
    order = np.argsort(t.astype(np.int16), kind="stable")
    t, doc, pos = t[order], doc[order], pos[order]
    td = t * ndocs + doc
    head = np.empty(len(td), bool)
    head[0] = True
    head[1:] = td[1:] != td[:-1]
    idx = np.flatnonzero(head)
    doc_ids = doc[idx].astype(np.int32)
    term_arr = t[idx]
    counts = np.diff(np.append(idx, len(td)))
    tfs = counts.astype(np.float32)
    df = np.bincount(term_arr, minlength=tvocab)
    starts = np.zeros(tvocab + 1, np.int64)
    np.cumsum(df, out=starts[1:])
    pos_starts = np.zeros(len(doc_ids) + 1, np.int64)
    np.cumsum(counts, out=pos_starts[1:])
    pair_counts = np.bincount(pr.ravel(), minlength=npairs)
    assert npairs <= 1 << 16
    return (starts, doc_ids, tfs, pos_starts, pos.astype(np.int32), first,
            second, pair_counts, pr.astype(np.uint16))


def title_vocab_strings(n: int) -> list:
    return [f"p{i:04d}" for i in range(n)]


TITLE_DL = 8                   # tokens of every title


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
    """Sources materialized on demand: {"doc": i}, and with a title
    corpus (`build_title_corpus`) the passage's `title` text too, its 8
    tokens rendered from the pair draw."""

    def __init__(self, n, title=None):
        self.n = n
        self.title = None
        if title is not None:
            self.title = (title[8], title[5], title[6],
                          title_vocab_strings(len(title[0]) - 1))

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        src = {"doc": int(i)}
        if self.title is not None:
            draw, first, second, tvs = self.title
            pr = draw[i].astype(np.int64)
            src["title"] = " ".join(
                f"{tvs[first[p]]} {tvs[second[p]]}" for p in pr)
        return src


STATUS_VALUES = ["archived", "draft", "published"]


def guardrail_columns(ndocs: int, seed: int = 3) -> tuple:
    """(status ordinals i32[ndocs] into STATUS_VALUES, price i64[ndocs]),
    drawn as bench.py draws them."""
    rng = np.random.default_rng(seed)
    status_ord = rng.integers(0, 3, ndocs).astype(np.int32)
    price = rng.integers(0, 1000, ndocs).astype(np.int64)
    return status_ord, price


# epoch ms of 2024-01-01 and 2025-01-01, UTC
TS_LO, TS_HI = 1_704_067_200_000, 1_735_689_600_000


def agg_columns(ndocs: int, seed: int = 4) -> tuple:
    """(ts i64[ndocs], rating f64[ndocs], rating present bool[ndocs]):
    epoch ms uniform over 2024 UTC, and a positive lognormal rating
    around 2.7 that about 5% of docs lack (0.0 there)."""
    rng = np.random.default_rng(seed)
    ts = rng.integers(TS_LO, TS_HI, ndocs, dtype=np.int64)
    rating = rng.lognormal(1.0, 0.5, ndocs)
    present = rng.random(ndocs) >= 0.05
    return ts, np.where(present, rating, 0.0), present


def make_index(client, corpus, name: str = "bench", columns=None,
               title=None, aggs=None, title_source: bool = False):
    """Create index `name` with a text field `body` and attach the CSR
    corpus as its one segment; with `columns` (guardrail_columns), also
    the `status` keyword postings and doc values and the `price` integer
    column, with `title` (build_title_corpus) the positional `title`
    text field, as bench.py's make_index builds them, and with `aggs`
    (agg_columns) the `ts` date and `rating` double columns, and with
    `title_source` the title text in each `_source` (bench.py's sources
    are {"doc": i}). Returns the segment."""
    starts, doc_ids, tfs, dl, _df = corpus
    ndocs = len(dl)
    postings = {"body": {"vocab": vocab_strings(len(starts) - 1),
                         "starts": starts, "doc_ids": doc_ids, "tfs": tfs}}
    props = {"body": {"type": "text"}}
    doc_lens = {"body": dl}
    text_stats = {"body": (ndocs, int(dl.sum()))}
    if title is not None:
        tstarts, tdocs, ttfs, tpos_starts, tpositions = title[:5]
        postings["title"] = {"vocab": title_vocab_strings(len(tstarts) - 1),
                             "starts": tstarts, "doc_ids": tdocs,
                             "tfs": ttfs, "pos_starts": tpos_starts,
                             "positions": tpositions}
        props["title"] = {"type": "text"}
        doc_lens["title"] = np.full(ndocs, TITLE_DL, np.int64)
        text_stats["title"] = (ndocs, TITLE_DL * ndocs)
    numeric, keyword = {}, None
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
        keyword = {"status": {
            "vocab": STATUS_VALUES,
            "starts": np.arange(ndocs + 1, dtype=np.int64),
            "ords": status_ord, "doc_of_value": np.arange(ndocs,
                                                          dtype=np.int32),
            "min_ord": status_ord}}
        numeric["price"] = {"kind": "int", "values": price.astype(np.int64),
                            "present": np.ones(ndocs, bool)}
        props.update({"status": {"type": "keyword"},
                      "price": {"type": "integer"}})
    if aggs is not None:
        ts, rating, present = aggs
        numeric["ts"] = {"kind": "int", "values": ts,
                         "present": np.ones(ndocs, bool)}
        numeric["rating"] = {"kind": "float", "values": rating,
                             "present": present}
        props.update({"ts": {"type": "date"}, "rating": {"type": "double"}})
    seg = segment_from_arrays(
        "bench0", ndocs, postings, doc_lens, text_stats, LazyIds(ndocs),
        LazySources(ndocs, title if title_source else None), numeric_cols=numeric, keyword_cols=keyword,
        device=client.device)
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


# ---------------------------------------------------------------------
# phrase traffic: bench.py's config 3 and its mixed stream
# ---------------------------------------------------------------------

def pick_phrase_pairs(pair_counts, nq: int, seed: int = 5) -> np.ndarray:
    """bench.py's phrase picks: pool pairs ranked 200-1,200 by count
    (selective phrases), drawn with replacement."""
    rng = np.random.default_rng(seed)
    pool = np.argsort(-pair_counts)[200:1200]
    return rng.choice(pool, size=nq, replace=True)


def phrase_body(i: int, pairs, title, size: int = 10) -> dict:
    """bench.py's config-3 body: the i-th picked pair as a match_phrase
    over `title`."""
    first, second = title[5], title[6]
    tvs = title_vocab_strings(len(title[0]) - 1)
    pi = pairs[i]
    return {"query": {"match_phrase": {
        "title": f"{tvs[first[pi]]} {tvs[second[pi]]}"}}, "size": size}


def match_body(i: int, queries, vs, size: int = 10) -> dict:
    """bench.py's config-1 body: a 2-term match over `body`."""
    q = queries[i]
    return {"query": {"match": {"body": f"{vs[q[0]]} {vs[q[1]]}"}},
            "size": size}


def mixed_body(i: int, queries, vs, pairs, title, size: int = 10) -> dict:
    """bench.py's mixed stream: of every 10 bodies, 5 config-2 bools, 3
    config-1 matches and 2 config-3 phrases."""
    r = i % 10
    if r < 5:
        return bool_body(i, queries, vs, size)
    if r < 8:
        return match_body(i, queries, vs, size)
    return phrase_body(i, pairs, title, size)


# ---------------------------------------------------------------------
# the title's English surface forms and the scalar field types' columns
# ---------------------------------------------------------------------

EN_INFLECTIONS = ("", "s", "ing", "ed", "er", "ly")
_EN_ONSETS = ("b", "br", "c", "ch", "cl", "d", "dr", "f", "fl", "g", "gr",
              "h", "j", "k", "l", "m", "n", "p", "pl", "qu", "r", "s",
              "sh", "sl", "st", "t", "th", "tr", "v", "w")
_EN_VOWELS = ("a", "e", "i", "o", "u", "ai", "ea", "oo")
_EN_CODAS = ("b", "ck", "d", "ft", "g", "k", "l", "lt", "m", "mp", "n",
             "nd", "nk", "p", "rt", "sk", "st", "t", "x")


def english_title_forms(first: np.ndarray, second: np.ndarray,
                        pair_counts: np.ndarray, tvocab: int = 1000,
                        n_stop: int = 30, seed: int = 11) -> list:
    """An English surface form for each of the title's `tvocab` terms
    (build_title_corpus), from `seed`: the `n_stop` terms the title pool
    draws most often become the first `n_stop` of Lucene's English
    stopwords (sorted), every other term a stem x inflection (EN_INFLECTIONS:
    a stem's forms stem alike under the english analyzer's Porter
    stemmer, so their postings merge), the stems made of one or two
    syllables. The forms are distinct lowercase words."""
    from .analysis.filters import ENGLISH_STOPWORDS
    freq = (np.bincount(first, weights=pair_counts, minlength=tvocab)
            + np.bincount(second, weights=pair_counts, minlength=tvocab))
    order = np.argsort(-freq, kind="stable")
    stops = sorted(ENGLISH_STOPWORDS)[:n_stop]
    rng = np.random.default_rng(seed)
    n_rest = tvocab - n_stop
    n_stems = -(-n_rest // len(EN_INFLECTIONS))
    stems: list = []
    seen = set(ENGLISH_STOPWORDS)
    while len(stems) < n_stems:
        w = "".join(str(rng.choice(part)) for part in (
            _EN_ONSETS, _EN_VOWELS, _EN_CODAS))
        if rng.random() < 0.5:
            w += "".join(str(rng.choice(part)) for part in (
                _EN_VOWELS, _EN_CODAS))
        if w not in seen:
            seen.add(w)
            stems.append(w)
    forms = [s + inf for s in stems for inf in EN_INFLECTIONS][:n_rest]
    forms = [forms[i] for i in rng.permutation(n_rest)]
    out = [""] * tvocab
    for rank, t in enumerate(order):
        out[int(t)] = stops[rank] if rank < n_stop else forms[rank - n_stop]
    return out


# the client addresses: 16 /16 subnets (172.16.0.0/12), 4,096 hosts each
IP_POOL = 1 << 16
IP_BASE = (0xFFFF << 32) | (172 << 24) | (16 << 16)


def ip_pool_int(i: np.ndarray) -> np.ndarray:
    """The IPv4-mapped integer of pool address `i`: subnet i >> 12 of
    172.16.0.0/12, host i & 4095 within it."""
    i = np.asarray(i, np.int64)
    return IP_BASE + ((i >> 12) << 16) + (i & 4095)


def ip_pool_str(i: int) -> str:
    i = int(i)
    return f"172.{16 + (i >> 12)}.{(i & 4095) >> 8}.{i & 255}"


def field_type_columns(ndocs: int, price: np.ndarray, seed: int = 12
                       ) -> dict:
    """The scalar field types' columns, drawn from `seed`: `client_ip`
    pool indices (u16[ndocs]: Zipf(1.1) ranks over IP_POOL addresses,
    the ranks spread over the subnets by a permutation), `stock`
    (short, 0..500), `grade` (byte, -100..100), `price_scaled`
    (scaled_float, factor 100: the price over 100) and `views`
    (unsigned_long: a third of the values at or past 2^63)."""
    rng = np.random.default_rng(seed)
    rank = rng.zipf(1.1, ndocs)
    rank = np.where(rank > IP_POOL, rng.integers(1, IP_POOL, ndocs),
                    rank) - 1
    ip = rng.permutation(IP_POOL)[rank].astype(np.uint16)
    stock = rng.integers(0, 501, ndocs).astype(np.int64)
    grade = rng.integers(-100, 101, ndocs).astype(np.int64)
    views = rng.integers(0, 1 << 62, ndocs, dtype=np.int64)
    high = rng.random(ndocs) < 1 / 3
    return {"client_ip": ip, "stock": stock, "grade": grade,
            "price_scaled": np.round(price.astype(np.float64)) / 100.0,
            "views_biased": np.where(high, views, views - (1 << 62)
                                     - (1 << 62))}


GEO_CITIES = 1000
GEO_SIGMA_DEG = 0.2
GEO_MISSING = 0.02
VALID_MISSING = 0.05
YEAR_2025_MS = (1_735_689_600_000, 1_767_225_600_000)
DAY_MS = 86_400_000


def geo_columns(ndocs: int, seed: int = 20) -> dict:
    """A `location` geo_point and a `valid` date_range per passage, drawn
    from `seed`: GEO_CITIES city centres uniform over lat [-60, 70] and
    lon [-180, 180), each passage at a city picked by Zipf(1.1) over the
    ranks (the skew of geonames' city populations) plus a Gaussian
    offset of GEO_SIGMA_DEG degrees, GEO_MISSING of the passages without
    one; `valid` starts uniformly over 2025 (epoch ms) and lasts a
    lognormal 1-90 days, VALID_MISSING without one. -> {"city_lat",
    "city_lon" f64[GEO_CITIES] in rank order, "lat", "lon"
    f32[ndocs], "present" bool[ndocs], "valid_lo", "valid_hi"
    i64[ndocs], "valid_present" bool[ndocs]}."""
    rng = np.random.default_rng(seed)
    city_lat = rng.uniform(-60.0, 70.0, GEO_CITIES)
    city_lon = rng.uniform(-180.0, 180.0, GEO_CITIES)
    p = np.arange(1, GEO_CITIES + 1, dtype=np.float64) ** -1.1
    city = rng.choice(GEO_CITIES, ndocs, p=p / p.sum())
    lat = np.clip(city_lat[city] + rng.normal(0.0, GEO_SIGMA_DEG, ndocs),
                  -90.0, 90.0)
    lon = city_lon[city] + rng.normal(0.0, GEO_SIGMA_DEG, ndocs)
    lon = (lon + 180.0) % 360.0 - 180.0
    present = rng.random(ndocs) >= GEO_MISSING
    start = rng.integers(*YEAR_2025_MS, ndocs, dtype=np.int64)
    days = np.clip(rng.lognormal(np.log(10.0), 1.0, ndocs), 1.0, 90.0)
    vpresent = rng.random(ndocs) >= VALID_MISSING
    return {"city_lat": city_lat, "city_lon": city_lon,
            "lat": np.where(present, lat, 0.0).astype(np.float32),
            "lon": np.where(present, lon, 0.0).astype(np.float32),
            "present": present,
            "valid_lo": np.where(vpresent, start, 0),
            "valid_hi": np.where(vpresent, start
                                 + np.round(days * DAY_MS).astype(np.int64),
                                 0),
            "valid_present": vpresent}


# ---------------------------------------------------------------------
# the Q&A corpus: OpenSearch Benchmark's `nested` workload's schema
# (StackOverflow questions with nested answers), drawn from a seed
# ---------------------------------------------------------------------

QA_TITLE_VOCAB = 30_000
QA_TAGS = 20_000
QA_USERS = 1_000_000
QA_DATES = (1_199_145_600_000, 1_514_764_800_000)   # 2008-01-01, 2018-01-01
QA_ANSWER_MEAN = 1.6
QA_ANSWER_LAG_DAYS = 90.0
QA_MAPPING = {"properties": {
    "qid": {"type": "keyword"}, "title": {"type": "text"},
    "tag": {"type": "keyword"}, "user": {"type": "keyword"},
    "creationDate": {"type": "date"},
    "answers": {"type": "nested", "properties": {
        "user": {"type": "keyword"}, "date": {"type": "date"}}}}}
QA_JOIN_MAPPING = {"properties": {
    "rel": {"type": "join", "relations": {"question": "answer"}},
    "tag": {"type": "keyword"}, "creationDate": {"type": "date"},
    "user": {"type": "keyword"}, "date": {"type": "date"}}}


def _zipf_choice(rng, n: int, size: int, a: float = 1.1) -> np.ndarray:
    p = np.arange(1, n + 1, dtype=np.float64) ** -a
    return rng.choice(n, size, p=p / p.sum())


def qa_draws(n: int, seed: int = 22) -> dict:
    """n questions drawn from `seed`: a title of 8-12 tokens (Zipf(1.1)
    over QA_TITLE_VOCAB words), 1-5 distinct tags (Zipf(1.1) over
    QA_TAGS), a user (Zipf(1.1) over QA_USERS), a creationDate uniform
    over 2008-2017 (epoch ms) and a geometric count of answers of mean
    QA_ANSWER_MEAN, each with a user and a date on or after the
    question's (an exponential lag of QA_ANSWER_LAG_DAYS days). -> {
    "title_starts", "title_tok", "tag_starts", "tag" (sorted within a
    question), "user", "date", "ans_starts", "ans_user", "ans_date"}."""
    rng = np.random.default_rng(seed)
    tlen = rng.integers(8, 13, n)
    title_starts = np.zeros(n + 1, np.int64)
    np.cumsum(tlen, out=title_starts[1:])
    title_tok = _zipf_choice(rng, QA_TITLE_VOCAB, int(title_starts[-1]))
    ntag = rng.integers(1, 6, n)
    tag_doc = np.repeat(np.arange(n, dtype=np.int64), ntag)
    pairs = np.unique(tag_doc * QA_TAGS
                      + _zipf_choice(rng, QA_TAGS, len(tag_doc)))
    tag_starts = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(pairs // QA_TAGS, minlength=n), out=tag_starts[1:])
    user = _zipf_choice(rng, QA_USERS, n)
    date = rng.integers(*QA_DATES, n, dtype=np.int64)
    nans = rng.geometric(1.0 / (1.0 + QA_ANSWER_MEAN), n) - 1
    ans_starts = np.zeros(n + 1, np.int64)
    np.cumsum(nans, out=ans_starts[1:])
    na = int(ans_starts[-1])
    ans_user = _zipf_choice(rng, QA_USERS, na)
    lag = rng.exponential(QA_ANSWER_LAG_DAYS * DAY_MS, na).astype(np.int64)
    return {"n": n, "title_starts": title_starts, "title_tok": title_tok,
            "tag_starts": tag_starts, "tag": pairs % QA_TAGS, "user": user,
            "date": date, "ans_starts": ans_starts, "ans_user": ans_user,
            "ans_date": np.repeat(date, nans) + lag}


def qa_word(i: int) -> str:
    return f"w{i:05d}"


def qa_tag(i: int) -> str:
    return f"tag{i:05d}"


def qa_user(i: int) -> str:
    return f"u{i:07d}"


def qa_id(i: int) -> str:
    return f"{i:08d}"


class PaddedIds:
    """Doc ids qa_id(i), materialized on demand; their order is the
    docs' (sorted vocabularies of ids stay in doc order)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return qa_id(int(i))

    def find(self, doc_id: str) -> int:
        ok = len(doc_id) == 8 and doc_id.isdigit()
        return int(doc_id) if ok and int(doc_id) < self.n else -1


def qa_source(d: dict, i: int) -> dict:
    """Question i's `_source` as a bulk request carries it."""
    a, b = int(d["ans_starts"][i]), int(d["ans_starts"][i + 1])
    t0, t1 = int(d["title_starts"][i]), int(d["title_starts"][i + 1])
    g0, g1 = int(d["tag_starts"][i]), int(d["tag_starts"][i + 1])
    return {"qid": qa_id(i),
            "title": " ".join(qa_word(int(w)) for w in d["title_tok"][t0:t1]),
            "tag": [qa_tag(int(t)) for t in d["tag"][g0:g1]],
            "user": qa_user(int(d["user"][i])),
            "creationDate": int(d["date"][i]),
            "answers": [{"user": qa_user(int(d["ans_user"][j])),
                         "date": int(d["ans_date"][j])} for j in range(a, b)]}


class QaSources:
    """The questions' (or, with `answers`, the answers') sources,
    materialized on demand."""

    def __init__(self, d: dict, n: int, answers: bool = False):
        self.d, self.n, self.answers = d, n, answers

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        i = int(i)
        if self.answers:
            return {"user": qa_user(int(self.d["ans_user"][i])),
                    "date": int(self.d["ans_date"][i])}
        return qa_source(self.d, i)


def _field(rows: np.ndarray, docs: np.ndarray, ndocs: int, names,
           positions: np.ndarray = None, keyword: bool = True) -> tuple:
    """(CSR postings, keyword column or None) of one field from its
    (value row, doc) occurrences, given in doc order (docs nondecreasing,
    a doc's rows ascending unless `positions` is given, a doc's positions
    ascending): the postings' rows and the column's vocab are the rows
    present, `names(row)` each, in row order (which sorts the names);
    repeats are tf; without `positions` the all-empty positions of a
    keyword field."""
    rows = np.asarray(rows, np.int64)
    docs = np.asarray(docs, np.int64)
    counts = np.bincount(rows) if len(rows) else np.zeros(1, np.int64)
    present = np.flatnonzero(counts)
    remap = np.cumsum(counts > 0) - 1
    ords = remap[rows]
    vocab = [names(int(r)) for r in present]
    # row-major order, docs (and a doc's positions) kept in order: a
    # stable sort of the row ordinals (a radix sort below 2^16 rows)
    small = np.uint16 if len(present) < (1 << 16) else np.uint32
    order = np.argsort(ords.astype(small), kind="stable")
    r, dd = ords[order], docs[order]
    new = np.ones(len(r), bool)
    new[1:] = (r[1:] != r[:-1]) | (dd[1:] != dd[:-1])
    first = np.flatnonzero(new)
    tf = np.diff(np.append(first, len(r)))
    starts = np.zeros(len(present) + 1, np.int64)
    np.cumsum(np.bincount(r[first], minlength=len(present)), out=starts[1:])
    post = {"vocab": vocab, "starts": starts,
            "doc_ids": dd[first].astype(np.int32),
            "tfs": tf.astype(np.float32),
            "pos_starts": np.zeros(len(first) + 1, np.int64),
            "positions": np.zeros(0, np.int32)}
    if positions is not None:
        np.cumsum(tf, out=post["pos_starts"][1:])
        post["positions"] = np.asarray(positions)[order].astype(np.int32)
    if not keyword:
        return post, None
    kstarts = np.zeros(ndocs + 1, np.int64)
    np.cumsum(np.bincount(docs, minlength=ndocs), out=kstarts[1:])
    min_ord = np.full(ndocs, -1, np.int32)
    has = kstarts[1:] > kstarts[:-1]
    min_ord[has] = ords[kstarts[:-1][has]]
    return post, {"vocab": vocab, "starts": kstarts,
                  "ords": ords.astype(np.int32),
                  "doc_of_value": docs.astype(np.int32), "min_ord": min_ord}


def qa_segment(d: dict, n: int, device=None, name: str = "qa0"):
    """The first n questions of a draw as one attached segment of the
    `nested` mapping (QA_MAPPING) with its answers' NestedBlock: the
    arrays a bulk of qa_source(d, i) and a refresh build."""
    docs = np.arange(n, dtype=np.int64)
    tcount = np.diff(d["title_starts"][:n + 1])
    t1 = int(d["title_starts"][n])
    tdoc = np.repeat(docs, tcount)
    tpos = np.arange(t1, dtype=np.int64) - np.repeat(
        d["title_starts"][:n], tcount)
    g1 = int(d["tag_starts"][n])
    gdoc = np.repeat(docs, np.diff(d["tag_starts"][:n + 1]))
    postings, keyword = {}, {}
    postings["title"], _ = _field(d["title_tok"][:t1], tdoc, n, qa_word,
                                  tpos, keyword=False)
    for f, rows, fdocs, names in (("tag", d["tag"][:g1], gdoc, qa_tag),
                                  ("user", d["user"][:n], docs, qa_user),
                                  ("qid", docs, docs, qa_id)):
        postings[f], keyword[f] = _field(rows, fdocs, n, names)
    numeric = {"creationDate": {"kind": "int", "values": d["date"][:n],
                                "present": np.ones(n, bool)}}
    acount = np.diff(d["ans_starts"][:n + 1])
    na = int(d["ans_starts"][n])
    adocs = np.arange(na, dtype=np.int64)
    apost, akw = _field(d["ans_user"][:na], adocs, na, qa_user)
    child = segment_from_arrays(
        f"{name}/answers", na, {"answers.user": apost}, {}, {},
        ChildIds(d, n), QaSources(d, na, answers=True),
        keyword_cols={"answers.user": akw},
        numeric_cols={"answers.date": {"kind": "int",
                                       "values": d["ans_date"][:na],
                                       "present": np.ones(na, bool)}},
        device=device)
    return segment_from_arrays(
        name, n, postings, {"title": tcount}, {"title": (n, t1)},
        PaddedIds(n), QaSources(d, n), numeric_cols=numeric,
        keyword_cols=keyword,
        nested={"answers": (child, np.repeat(docs, acount))},
        device=device)


class ChildIds:
    """The answers' doc ids ("<question id>#answers#<k>"), on demand."""

    def __init__(self, d: dict, n: int):
        self.starts = d["ans_starts"][:n + 1]
        self.n = int(self.starts[-1])

    def __len__(self):
        return self.n

    def __getitem__(self, j):
        p = int(np.searchsorted(self.starts, int(j), side="right")) - 1
        return f"{qa_id(p)}#answers#{int(j) - int(self.starts[p])}"


def qa_join_segment(d: dict, m: int, device=None, name: str = "qj0"):
    """The first m questions (docs 0..m-1, relation `question`, their
    tags and creationDate) and their answers (docs m.., relation
    `answer` under their question, its user and date) as one attached
    segment of QA_JOIN_MAPPING: what a bulk of them, each answer routed
    to its question, and a refresh build."""
    na = int(d["ans_starts"][m])
    n = m + na
    qdocs = np.arange(m, dtype=np.int64)
    adocs = np.arange(m, n, dtype=np.int64)
    parent = np.repeat(qdocs, np.diff(d["ans_starts"][:m + 1]))
    rel = np.concatenate([np.ones(m, np.int64), np.zeros(na, np.int64)])
    alldocs = np.arange(n, dtype=np.int64)
    g1 = int(d["tag_starts"][m])
    gdoc = np.repeat(qdocs, np.diff(d["tag_starts"][:m + 1]))

    def rel_name(r):
        return ("answer", "question")[r]
    postings, keyword = {}, {}
    for f, rows, fdocs, names in (
            ("rel", rel, alldocs, rel_name),
            ("rel#parent", parent, adocs, qa_id),
            ("tag", d["tag"][:g1], gdoc, qa_tag),
            ("user", d["ans_user"][:na], adocs, qa_user)):
        postings[f], keyword[f] = _field(rows, fdocs, n, names)
    numeric = {f: {"kind": "int",
                   "values": np.concatenate([a, b]).astype(np.int64),
                   "present": np.concatenate([pa, pb])}
               for f, a, b, pa, pb in (
                   ("creationDate", d["date"][:m], np.zeros(na, np.int64),
                    np.ones(m, bool), np.zeros(na, bool)),
                   ("date", np.zeros(m, np.int64), d["ans_date"][:na],
                    np.zeros(m, bool), np.ones(na, bool)))}
    return segment_from_arrays(
        name, n, postings, {}, {}, PaddedIds(n), QaJoinSources(d, m),
        numeric_cols=numeric, keyword_cols=keyword, device=device)


def qa_join_source(d: dict, m: int, i: int) -> dict:
    """Doc i of qa_join_segment's order as a bulk request carries it."""
    if i < m:
        g0, g1 = int(d["tag_starts"][i]), int(d["tag_starts"][i + 1])
        return {"rel": "question",
                "tag": [qa_tag(int(t)) for t in d["tag"][g0:g1]],
                "creationDate": int(d["date"][i])}
    j = i - m
    p = int(np.searchsorted(d["ans_starts"], j, side="right")) - 1
    return {"rel": {"name": "answer", "parent": qa_id(p)},
            "user": qa_user(int(d["ans_user"][j])),
            "date": int(d["ans_date"][j])}


class QaJoinSources:
    def __init__(self, d: dict, m: int):
        self.d, self.m = d, m
        self.n = m + int(d["ans_starts"][m])

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return qa_join_source(self.d, self.m, int(i))
