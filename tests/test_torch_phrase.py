"""Positional postings and phrase queries of the port (opensearch_tpu_torch/
ops/positions.py, the phrase rewrite and program of search/compiler.py,
phrase filters in search/filters.py) against the JAX package on the CPU.

Tolerances:
- `ops.positions`: pair searches and found flags equal, displacements
  and phrase frequencies bit-equal to the reference's jnp functions in
  all three cost modes; phrase scores within 1e-6 relative (the
  reference's XLA contracts `freq + k1 * y` into a fused multiply-add,
  ROADMAP Queue 3), match flags equal;
- end to end, the same documents through both packages' RestClient:
  totals and relations equal, ids and order identical, scores within
  1e-6 relative, `took` aside, for every case of tests/test_phrase.py the
  port serves;
- every span or intervals form outside the slice raises NotPortedError
  naming it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.ops import positions as rpos
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu.search import compiler as RC
from opensearch_tpu.search import query_dsl as rdsl
from opensearch_tpu_torch import NotPortedError, RestClient
from opensearch_tpu_torch.ops import positions as pos
from opensearch_tpu_torch.search import compiler as C
from opensearch_tpu_torch.search import fastpath, impactpath
from opensearch_tpu_torch.search import query_dsl as dsl

jax.config.update("jax_platforms", "cpu")

RTOL = 1e-6
SENT = pos.INT32_SENTINEL


# ---------------------------------------------------------------------
# ops/positions.py against the reference's jnp functions
# ---------------------------------------------------------------------

def term_pairs(docs_tokens, term):
    """Lex-sorted (doc, position) pairs of `term` over tokenized docs."""
    d, p = [], []
    for i, toks in enumerate(docs_tokens):
        for j, t in enumerate(toks):
            if t == term:
                d.append(i)
                p.append(j)
    return np.asarray(d, np.int32), np.asarray(p, np.int32)


def pad(a, n):
    out = np.full(n, SENT, np.int32)
    out[:len(a)] = a
    return out


def random_docs(seed: int, ndocs: int = 60):
    """Short docs over a 6-word vocabulary, so terms repeat within a doc
    (several anchors of one doc, ties between left and right), plus the
    fixed docs the cases below need."""
    rng = np.random.default_rng(seed)
    words = ["to", "be", "or", "not", "a", "b"]
    docs = [list(rng.choice(words, int(rng.integers(1, 14))))
            for _ in range(ndocs)]
    docs += [["to", "be", "or", "not", "to", "be"],
             ["b", "a", "b", "a", "b"], ["a", "x", "x", "b", "a", "b"],
             ["be", "to"], ["to"]]
    return docs


PHRASES = [("to", "be"), ("to", "be", "or"), ("be", "to"), ("a", "b", "a"),
           ("not", "to", "be"), ("a", "a"), ("to", "be", "or", "not")]
MODES = [(False, False), (False, True), (True, True)]   # (ordered, gap)


def freqs_both(docs, terms, slop, ordered, gap, padded: bool):
    """(port freq, reference freq) of one phrase over `docs`; the port
    reads the reference's sentinel-padded arrays when `padded`."""
    nd = len(docs)
    arrays = [term_pairs(docs, t) for t in terms]
    n_pad = 1 << max(len(d) for d, _p in arrays).bit_length()
    ref_arrays = [(jnp.asarray(pad(d, n_pad)), jnp.asarray(pad(p, n_pad)))
                  for d, p in arrays]
    shifts = list(range(1, len(terms)))
    want = np.asarray(rpos.phrase_freqs(
        ref_arrays[0][0], ref_arrays[0][1], ref_arrays[1:],
        jnp.float32(slop), nd, ordered=ordered, gap_cost=gap,
        shifts=[jnp.int32(s) for s in shifts]))
    src = [(pad(d, n_pad), pad(p, n_pad)) if padded else (d, p)
           for d, p in arrays]
    keys = [pos.pair_keys(torch.from_numpy(d), torch.from_numpy(p))
            for d, p in src]
    got = pos.phrase_freqs(torch.from_numpy(src[0][0]),
                           torch.from_numpy(src[0][1]), keys[1:],
                           float(slop), nd, ordered=ordered, gap_cost=gap,
                           shifts=shifts).numpy()
    return got, want


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", MODES, ids=["moves", "gaps", "ordered"])
@pytest.mark.parametrize("padded", [False, True], ids=["exact", "sentinel"])
def test_phrase_freqs_bit_equal(seed, mode, padded):
    docs = random_docs(seed)
    ordered, gap = mode
    for terms in PHRASES:
        for slop in (0, 1, 2, 5):
            got, want = freqs_both(docs, terms, slop, ordered, gap, padded)
            assert got.dtype == want.dtype
            assert got.tobytes() == want.tobytes(), (terms, slop)


def test_several_sloppy_anchors_in_one_doc_sum_in_anchor_order():
    """A doc with many anchors whose weights 1/(1+cost) are not exact in
    f32: the sum runs in anchor order, bit-equal to the reference."""
    docs = [["a", "x", "b", "a", "x", "x", "b", "a", "b", "x", "a"] * 3,
            ["a", "b"]]
    for mode in MODES:
        got, want = freqs_both(docs, ("a", "b"), 6, *mode, padded=False)
        assert got.tobytes() == want.tobytes(), mode
        assert got[0] > 1.0


def test_pair_search_and_nearest_delta_match_reference():
    rng = np.random.default_rng(5)
    d = np.sort(rng.integers(0, 40, 300)).astype(np.int32)
    p = rng.integers(0, 50, 300).astype(np.int32)
    order = np.lexsort((p, d))
    d, p = d[order], p[order]
    dq = rng.integers(0, 42, 500).astype(np.int32)
    # negative query positions: the ordered join can ask for them
    pq = rng.integers(-60, 60, 500).astype(np.int32)
    dA, pA = pad(d, 512), pad(p, 512)
    want = np.asarray(rpos.pair_searchsorted(jnp.asarray(dA),
                                             jnp.asarray(pA),
                                             jnp.asarray(dq),
                                             jnp.asarray(pq)))
    got = pos.search_pairs(pos.pair_keys(torch.from_numpy(dA),
                                         torch.from_numpy(pA)),
                           torch.from_numpy(dq), torch.from_numpy(pq))
    np.testing.assert_array_equal(got.numpy(), want)
    # `doc << 32 | pos` without the bias gets negative positions wrong
    plain = torch.searchsorted(
        (torch.from_numpy(dA).long() << 32) | torch.from_numpy(pA).long(),
        (torch.from_numpy(dq).long() << 32) | torch.from_numpy(pq).long())
    assert (plain.numpy() != want).any()
    keys = pos.pair_keys(torch.from_numpy(d), torch.from_numpy(p))
    for shift in (0, 1, 3):
        wd, wf = rpos.nearest_delta(jnp.asarray(dA), jnp.asarray(pA),
                                    jnp.asarray(dq), jnp.asarray(pq),
                                    jnp.int32(shift))
        gd, gf = pos.nearest_delta(keys, torch.from_numpy(dq),
                                   torch.from_numpy(pq), shift)
        np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
        ok = np.asarray(wf)
        assert gd.numpy()[ok].tobytes() == np.asarray(wd)[ok].tobytes()


def test_ordered_join_after_a_miss_stays_in_order():
    """The ordered join's query position for term i+1 comes from term
    i's (possibly missed) hit; the frequencies still equal the
    reference's where a miss meets a later term at position 0."""
    docs = [["b", "c", "a", "x", "b", "c"], ["c", "a", "b"],
            ["a", "c", "b", "c"], ["b", "a", "c", "b", "c", "a"]]
    for slop in (0, 1, 3, 8):
        got, want = freqs_both(docs, ("a", "b", "c"), slop, True, True,
                               padded=False)
        assert got.tobytes() == want.tobytes(), slop


def test_phrase_score_matches_reference():
    rng = np.random.default_rng(3)
    n = 500
    freq = np.where(rng.random(n) < 0.4, 0.0,
                    rng.integers(1, 5, n) / rng.integers(1, 4, n)
                    ).astype(np.float32)
    dl = rng.integers(1, 90, n).astype(np.float32)
    live = rng.random(n) < 0.9
    ws, wm = rpos.phrase_score(jnp.asarray(freq), jnp.asarray(dl),
                               jnp.asarray(live.astype(np.float32)),
                               jnp.float32(3.7), 1.2, 0.75,
                               jnp.float32(31.4))
    gs, gm = pos.phrase_score(torch.from_numpy(freq), torch.from_numpy(dl),
                              torch.from_numpy(live), 3.7, 1.2, 0.75, 31.4)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=RTOL)


# ---------------------------------------------------------------------
# end to end: both RestClients on the same documents
# ---------------------------------------------------------------------

MAPPING = {"settings": {"number_of_replicas": 0},
           "mappings": {"properties": {"body": {"type": "text"},
                                       "tag": {"type": "keyword"}}}}
DOCS = [
    ("1", {"body": "the quick brown fox jumps over the lazy dog"}),
    ("2", {"body": "the brown quick fox is not a dog"}),
    ("3", {"body": "quick and nimble brown fox"}),
    ("4", {"body": "a fox that is brown and quick"}),
    ("5", {"body": "quick brown fox quick brown fox"}),
    ("6", {"body": "nothing relevant here"}),
]


def _writes(c, name):
    """The write script of corpus `name` (tests/test_phrase.py's corpora,
    then deletes, several segments, array fields)."""
    c.indices.create("t", MAPPING)
    if name == "fox":
        for i, d in DOCS:
            c.index("t", dict(d, tag=f"g{int(i) % 2}"), id=i)
        c.indices.refresh("t")
    elif name == "fruit":
        for i, w in enumerate(["apple", "apricot", "avocado"]):
            c.index("t", {"body": f"ripe {w}"}, id=str(i))
        c.indices.refresh("t")
    elif name == "ordered":
        c.index("t", {"body": "fox quick one two three fox"}, id="1",
                refresh=True)
    elif name == "clamp":
        for i in range(4):
            c.index("t", {"body": "ripe apple apricot avocado amber"},
                    id=str(i))
        c.indices.refresh("t")
    elif name in ("segments", "deleted", "merged"):
        c.index("t", {"body": "red green blue"}, id="a", refresh=True)
        c.index("t", {"body": "red green yellow"}, id="b")
        c.index("t", {"body": "green red blue"}, id="c", refresh=True)
        c.index("t", {"body": "blue red green red green"}, id="d",
                refresh=True)
        if name != "segments":
            c.delete("t", "b")
            c.indices.refresh("t")
        if name == "merged":
            c.indices.forcemerge("t")
    elif name == "arrays":
        c.index("t", {"body": ["alpha beta", "gamma delta"]}, id="1")
        c.index("t", {"body": ["alpha beta gamma delta"]}, id="2")
        c.index("t", {"body": ["beta", "", "alpha", "beta gamma"]}, id="3")
        c.indices.refresh("t")
    return c


_CLIENTS: dict = {}


def clients(name):
    if name not in _CLIENTS:
        _CLIENTS[name] = (_writes(RefClient(), name),
                          _writes(RestClient(device="cpu"), name))
    return _CLIENTS[name]


def mp(q, **kw):
    return {"query": {"match_phrase": {"body": dict(query=q, **kw)
                                       if kw else q}}}


def mpp(q, **kw):
    return {"query": {"match_phrase_prefix": {"body": dict(query=q, **kw)
                                              if kw else q}}}


def near(terms, slop, in_order):
    return {"query": {"span_near": {
        "clauses": [{"span_term": {"body": t}} for t in terms],
        "slop": slop, "in_order": in_order}}}


def iv(q, **kw):
    return {"query": {"intervals": {"body": {"match": dict(query=q, **kw)}}}}


CASES = [
    # exact phrase, swapped and gapped docs, frequency scoring
    ("fox", "exact", mp("quick brown fox")),
    ("fox", "brown fox", mp("brown fox")),
    ("fox", "quick fox", mp("quick fox")),
    ("fox", "fox brown", mp("fox brown")),
    ("fox", "slop 2", mp("quick brown fox", slop=2)),
    ("fox", "slop 1", mp("quick brown fox", slop=1)),
    ("fox", "slop 2 pair", mp("quick brown", slop=2)),
    ("fox", "boost", mp("quick brown fox", boost=2.5)),
    ("fox", "size and from", dict(mp("brown fox", slop=3), size=2,
                                  **{"from": 1})),
    ("fox", "exact totals", dict(mp("brown fox"), track_total_hits=True)),
    # single-term rewrite, prefix, max_expansions
    ("fox", "single term", mp("nimble")),
    ("fox", "prefix", mpp("quick bro")),
    ("fox", "prefix last", mpp("lazy d")),
    ("fox", "prefix single", mpp("qu")),
    ("fox", "prefix sloppy", mpp("quick fo", slop=2)),
    ("fox", "analyzer", mp("Quick BROWN", analyzer="standard")),
    ("fruit", "prefix expansions", mpp("ap")),
    ("fruit", "max_expansions 1", mpp("ap", max_expansions=1)),
    ("fruit", "phrase max_expansions 1", mpp("ripe ap", max_expansions=1)),
    ("clamp", "prefix df clamped", mpp("ripe a")),
    # phrase in a bool and in filter context
    ("fox", "bool must_not", {"query": {"bool": {
        "must": [{"match_phrase": {"body": "brown fox"}}],
        "must_not": [{"match": {"body": "nimble"}}]}}}),
    ("fox", "bool should", {"query": {"bool": {"should": [
        {"match_phrase": {"body": "brown fox"}},
        {"match": {"body": "dog"}}]}}}),
    ("fox", "bool filter", {"query": {"bool": {
        "must": [{"match": {"body": "fox"}}],
        "filter": [{"match_phrase": {"body": "brown fox"}}]}}}),
    ("fox", "bool must_not phrase", {"query": {"bool": {
        "must": [{"match": {"body": "quick"}}],
        "must_not": [{"match_phrase": {"body": "quick brown"}}]}}}),
    ("fox", "constant_score", {"query": {"constant_score": {
        "filter": {"match_phrase": {"body": "quick brown"}},
        "boost": 3.0}}}),
    ("fox", "filter prefix", {"query": {"bool": {
        "must": [{"match": {"body": "fox"}}],
        "filter": [{"match_phrase_prefix": {"body": "bro"}}]}}}),
    ("fox", "keyword filter", {"query": {"bool": {
        "must": [{"match_phrase": {"body": "brown fox"}}],
        "filter": [{"term": {"tag": "g1"}}]}}}),
    # span_near in and out of order, intervals gaps
    ("fox", "span_near", near(["quick", "fox"], 1, True)),
    ("fox", "span_near unordered", near(["quick", "brown"], 2, False)),
    ("fox", "span_near ordered", near(["quick", "brown"], 2, True)),
    ("fox", "span_near one term", near(["fox"], 0, True)),
    ("fox", "span_term", {"query": {"span_term": {"body": "fox"}}}),
    ("fox", "intervals", iv("quick fox", max_gaps=1)),
    ("fox", "intervals gaps 0", iv("quick brown", max_gaps=0)),
    ("fox", "intervals ordered 0", iv("quick brown", max_gaps=0,
                                      ordered=True)),
    ("fox", "intervals ordered 1", iv("quick brown fox", max_gaps=1,
                                      ordered=True)),
    ("fox", "intervals ordered 2", iv("quick brown fox", max_gaps=2,
                                      ordered=True)),
    ("fox", "intervals unbounded", iv("fox quick")),
    ("fox", "intervals shorthand", {"query": {"intervals": {"body": {
        "match": "brown fox"}}}}),
    ("ordered", "ordered skips", near(["quick", "fox"], 4, True)),
    ("ordered", "ordered gaps", near(["quick", "fox"], 2, True)),
    # across segments, deletes and a merge
    ("segments", "segments", mp("red green")),
    ("deleted", "deletes", mp("red green")),
    ("deleted", "deletes sloppy", mp("green red", slop=2)),
    ("merged", "merged", mp("red green")),
    ("merged", "merged span", near(["red", "blue"], 1, False)),
    # array fields: values 100 positions apart
    ("arrays", "within a value", mp("alpha beta")),
    ("arrays", "across values", mp("beta gamma")),
    ("arrays", "across values sloppy", mp("beta gamma", slop=100)),
    ("arrays", "across values ordered", near(["beta", "gamma"], 200, True)),
]


def assert_phrase_response(got, want, name):
    """Totals and relations equal, ids and order identical, scores
    within RTOL, sources equal."""
    assert got["hits"]["total"] == want["hits"]["total"], name
    gm, wm = got["hits"]["max_score"], want["hits"]["max_score"]
    assert (gm is None) == (wm is None), name
    if wm is not None:
        np.testing.assert_allclose(gm, wm, rtol=RTOL, err_msg=name)
    gh, wh = got["hits"]["hits"], want["hits"]["hits"]
    assert [h["_id"] for h in gh] == [h["_id"] for h in wh], name
    for g, w in zip(gh, wh):
        np.testing.assert_allclose(g["_score"], w["_score"], rtol=RTOL,
                                   err_msg=name)
        assert g["_source"] == w["_source"], name


@pytest.mark.parametrize("corpus,name,body", CASES,
                         ids=[c[1] for c in CASES])
def test_phrase_matches_reference(corpus, name, body):
    ref, port = clients(corpus)
    want = ref.search("t", body)
    fastpath.reset_stats()
    got = port.search("t", body)
    assert_phrase_response(got, want, name)


def test_phrase_cases_match_the_reference_test_expectations():
    """The port's pages on tests/test_phrase.py's assertions, as ids."""
    _ref, port = clients("fox")

    def ids(body):
        return [h["_id"] for h in port.search("t", body)["hits"]["hits"]]
    assert set(ids(mp("quick brown fox"))) == {"1", "5"}
    assert ids(mp("quick fox")) == ["2"] and ids(mp("fox brown")) == []
    assert set(ids(mp("quick brown fox", slop=2))) == {"1", "2", "3", "5"}
    assert "2" in ids(iv("quick brown", max_gaps=0))
    assert "2" not in ids(iv("quick brown", max_gaps=0, ordered=True))
    assert "3" not in ids(iv("quick brown fox", max_gaps=1, ordered=True))
    assert set(ids(near(["quick", "fox"], 1, True))) == {"1", "2", "5"}
    _ref, fruit = clients("fruit")
    assert [h["_id"] for h in fruit.search(
        "t", mpp("ap", max_expansions=1))["hits"]["hits"]] == ["0"]
    _ref, arrays = clients("arrays")
    assert [h["_id"] for h in arrays.search(
        "t", mp("beta gamma"))["hits"]["hits"]] == ["2", "3"]


def test_phrase_bodies_ride_the_general_path():
    """The fused kernels and the impact rung decline phrases (the
    reference's conditions); a single-term phrase stays a term group."""
    _ref, port = clients("fox")
    C.reset_stats()
    impactpath.reset_stats()
    port.search("t", mp("quick brown fox"))
    assert C.STATS["general_served"] == 1
    assert impactpath.STATS["served"] == 0
    ctx = port._indices["t"].searcher.context()
    lroot = C.rewrite(dsl.parse_query(mp("quick brown fox")["query"]), ctx)
    assert isinstance(lroot, C.LPhrase)
    assert fastpath.make_spec(lroot, 10, {}) is None
    assert impactpath.make_spec(lroot, 10, {}) is None
    single = C.rewrite(dsl.parse_query(mp("nimble")["query"]), ctx)
    assert isinstance(single, C.LTerms)
    assert fastpath.make_spec(single, 10, {}) is not None


def test_msearch_reruns_phrase_bodies_and_keeps_the_rest():
    ref, port = clients("fox")
    bodies = [mp("quick brown fox"), {"query": {"match": {"body": "fox"}}},
              mpp("quick bro"), {"query": {"bool": {
                  "must": [{"match": {"body": "quick"}}],
                  "filter": [{"match_phrase": {"body": "brown fox"}}]}}},
              near(["quick", "fox"], 1, True)]
    lines = sum([[{}, b] for b in bodies], [])
    got = port.msearch(lines, index="t")["responses"]
    want = ref.msearch(lines, index="t")["responses"]
    for i, (g, w) in enumerate(zip(got, want)):
        assert_phrase_response(g, w, f"body {i}")
        assert_phrase_response(g, port.search("t", bodies[i]),
                               f"single {i}")


def test_phrase_param_bytes_equal_the_reference_prepare():
    """The bytes the port counts for the reference's filter-hash cap are
    the bytes of the reference's prepared parameters for the phrase."""
    ref, port = clients("fox")
    shard = ref.node.indices["t"].shards[0]
    rctx = RC.ShardContext(shard.mappings, shard.segments)
    pctx = port._indices["t"].searcher.context()
    for body in (mp("quick brown fox"), mpp("quick bro", slop=1),
                 near(["quick", "fox"], 1, True), mp("fox zzz")):
        q = body["query"]
        pnode = C.rewrite(dsl.parse_query(q), pctx)
        (pseg,) = pctx.segments
        got = C.reference_param_bytes(pnode, pseg)
        rnode = RC.rewrite(rdsl.parse_query(q), rctx)
        local: dict = {}
        RC.prepare(rnode, rctx.segments[0], rctx, local)
        want = sum(np.asarray(v).nbytes for v in local.values())
        assert got == want, body


def test_a_phrase_filter_past_the_hash_cap_is_declined(monkeypatch):
    """Where the reference's fastpath cannot hash a phrase filter's
    parameters it declines the bool; so does the port's, and the general
    path serves the same page as the kernels would under a larger cap."""
    _ref, port = clients("fox")
    body = {"query": {"bool": {
        "must": [{"match": {"body": "fox"}}],
        "filter": [{"match_phrase": {"body": "brown fox"}}]}}}
    C.reset_stats()
    served = port.search("t", body)
    assert C.STATS["general_served"] == 0
    monkeypatch.setattr(C, "FILTER_HASH_BYTE_CAP", 64)
    port._indices["t"].engine.segments[0].__dict__.pop("filter_lists",
                                                       None)
    declined = port.search("t", body)
    assert C.STATS["general_served"] == 1
    assert_phrase_response(declined, served, "declined")


# ---------------------------------------------------------------------
# persistence: a positional segment saved, loaded and recovered
# ---------------------------------------------------------------------

def test_positional_segment_survives_flush_and_recovery(tmp_path):
    bodies = [mp("red green"), mp("green red", slop=2),
              near(["red", "blue"], 1, False), mpp("red gr")]
    c = RestClient(device="cpu", data_path=str(tmp_path))
    _writes(c, "deleted")
    before = [c.search("t", b) for b in bodies]
    c.indices.flush("t")
    (seg,) = [s for s in c._indices["t"].engine.segments if s.ndocs > 1]
    c.close()
    again = RestClient(device="cpu", data_path=str(tmp_path))
    segs = again._indices["t"].engine.segments
    loaded = [s for s in segs if s.name == seg.name][0]
    pb, lb = seg.postings["body"], loaded.postings["body"]
    assert pb.pos_starts.tobytes() == lb.pos_starts.tobytes()
    assert pb.positions.tobytes() == lb.positions.tobytes()
    for b, want in zip(bodies, before):
        assert_phrase_response(again.search("t", b), want, str(b))


# ---------------------------------------------------------------------
# what the slice does not serve
# ---------------------------------------------------------------------

UNPORTED = [
    ({"span_or": {"clauses": [{"span_term": {"body": "a"}}]}}, "span_or"),
    ({"span_not": {"include": {"span_term": {"body": "a"}},
                   "exclude": {"span_term": {"body": "b"}}}}, "span_not"),
    ({"span_first": {"match": {"span_term": {"body": "a"}}, "end": 3}},
     "span_first"),
    ({"span_containing": {"big": {"span_term": {"body": "a"}},
                          "little": {"span_term": {"body": "b"}}}},
     "span_containing"),
    ({"span_within": {"big": {"span_term": {"body": "a"}},
                      "little": {"span_term": {"body": "b"}}}},
     "span_within"),
    ({"span_multi": {"match": {"prefix": {"body": "a"}}}}, "span_multi"),
    ({"field_masking_span": {"query": {"span_term": {"body": "a"}},
                             "field": "body"}}, "field_masking_span"),
    ({"span_near": {"clauses": [{"span_term": {"body": "a"}},
                                {"span_near": {"clauses": [
                                    {"span_term": {"body": "b"}}]}}]}},
     "span queries other than span_term"),
    ({"intervals": {"body": {"prefix": {"prefix": "qu"}}}},
     r"intervals rule \[prefix\]"),
    ({"intervals": {"body": {"wildcard": {"pattern": "q*"}}}},
     r"intervals rule \[wildcard\]"),
    ({"intervals": {"body": {"fuzzy": {"term": "quikc"}}}},
     r"intervals rule \[fuzzy\]"),
    ({"intervals": {"body": {"all_of": {"intervals": [
        {"match": {"query": "quick"}}]}}}}, r"intervals rule \[all_of\]"),
    ({"intervals": {"body": {"any_of": {"intervals": [
        {"match": {"query": "quick"}}]}}}}, r"intervals rule \[any_of\]"),
    ({"intervals": {"body": {"match": {
        "query": "quick fox",
        "filter": {"not_containing": {"match": {"query": "brown"}}}}}}},
     r"intervals \[filter\] \[not_containing\]"),
    ({"simple_query_string": {"query": "quick brown", "fields": ["body"]}},
     r"query \[simple_query_string\]"),
    ({"query_string": {"query": "quick", "default_field": "body"}},
     r"query \[query_string\]"),
]


@pytest.mark.parametrize("query,what", UNPORTED,
                         ids=[u[1] for u in UNPORTED])
def test_unported_span_and_interval_forms_raise(query, what):
    """The span and interval forms outside the port raise; the query
    strings serve the reference's page."""
    ref, port = clients("fox")
    want = ref.search("t", {"query": query})      # the reference serves it
    if "query_string" in what:
        assert_phrase_response(port.search("t", {"query": query}), want,
                               what)
        return
    with pytest.raises(NotPortedError, match=what):
        port.search("t", {"query": query})


@pytest.mark.parametrize("option", ["rescore", "explain"])
def test_phrase_body_options_outside_the_slice_raise(option):
    """A phrase body's rescore and explain are served (tests/
    test_torch_body_options.py); a rescore query of a kind outside the
    port and the reference's `explain: "device_plan"` still raise."""
    _ref, port = clients("fox")
    body = dict(mp("quick brown"), **{option: {"window_size": 5, "query": {
        "rescore_query": {"span_or": {"clauses": [
            {"span_term": {"body": "quick"}}]}}}}
        if option == "rescore" else "device_plan"})
    with pytest.raises(NotPortedError, match=option):
        port.search("t", body)


@pytest.mark.parametrize("query", [
    {"span_near": {"clauses": [{"span_term": {"body": "a"}},
                               {"span_term": {"tag": "b"}}]}},
    {"span_near": {"clauses": [{"span_term": {"body": "a"}},
                               {"match": {"body": "b"}}]}},
], ids=["several fields", "not a span query"])
def test_malformed_span_near_is_a_bad_request(query):
    ref, port = clients("fox")
    for c in (ref, port):
        with pytest.raises(Exception) as err:
            c.search("t", {"query": query})
        assert type(err.value).__name__ == "ApiError"
        assert err.value.status == 400


def test_interval_rule_validation_matches_reference():
    for spec in ({"frob": {"x": 1}}, {"all_of": {"intervals": []}},
                 {"match": {"query": "a", "filter": {"nope": {}}}}):
        body = {"intervals": {"body": spec}}
        with pytest.raises(rdsl.QueryParseError):
            rdsl.parse_query(body)
        with pytest.raises(dsl.QueryParseError):
            dsl.parse_query(body)
    dsl.parse_query({"intervals": {"body": {"fuzzy": {"term": "x"}}}})


# ---------------------------------------------------------------------
# chip_smoke.py phase 9's brute force on a small bench corpus
# ---------------------------------------------------------------------

BENCH_NDOCS = 3000


@pytest.fixture(scope="module")
def bench_small():
    """bench.py's corpus, guardrail columns and positional title at a
    small size, attached to both packages (the reference through
    bench.py's own make_index), and phase 9's numpy brute force over
    them."""
    import bench
    import chip_smoke
    from opensearch_tpu_torch import bench_corpus as bc
    corpus = bc.build_corpus(BENCH_NDOCS)
    columns = bc.guardrail_columns(BENCH_NDOCS)
    title = bc.build_title_corpus(BENCH_NDOCS)
    starts, docs, tfs, dl, _df = corpus
    ref = RefClient()
    bench.make_index(ref, (starts, docs, tfs,
                           bc.vocab_strings(len(starts) - 1)), dl,
                     tuple(title[:5]) + (bc.title_vocab_strings(
                         len(title[0]) - 1),), *columns)
    port = RestClient(device="cpu")
    bc.make_index(port, corpus, columns=columns, title=title)
    ix = chip_smoke.NumpyIndex(corpus, columns, title)
    return ref, port, ix, corpus, title


def test_title_corpus_and_phrase_picks_are_bench_py_s():
    import bench
    from opensearch_tpu_torch import bench_corpus as bc
    got, want = bc.build_title_corpus(700), bench.build_title_corpus(700)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    pair_counts = want[7]
    rng_p = np.random.default_rng(5)
    want_pairs = rng_p.choice(np.argsort(-pair_counts)[200:1200], size=40,
                              replace=True)
    np.testing.assert_array_equal(bc.pick_phrase_pairs(pair_counts, 40),
                                  want_pairs)


@pytest.mark.parametrize("cls", ["config3", "sloppy", "prefix"])
def test_phase9_brute_force_matches_reference_pages(bench_small, cls):
    """Phase 9's oracle pages (the numpy exact phrase and median-cost
    join) equal the reference's pages, and the port's pages equal both."""
    import chip_smoke
    ref, port, ix, _corpus, title = bench_small
    classes = chip_smoke.phrase_classes(title, BENCH_NDOCS, 24, 24)
    items = classes[cls]
    assert items
    hits = 0
    for body, oracle in items:
        want = ref.search("bench", body)
        chip_smoke.check_page(want, oracle(ix), f"reference {body}")
        assert_phrase_response(port.search("bench", body), want, str(body))
        hits += want["hits"]["total"]["value"] > 0
    assert hits >= len(items) // 2


def test_mixed_stream_matches_reference(bench_small):
    """bench.py's mixed stream over the small corpus: the port's msearch
    pages equal the reference's (bools and matches within the slice's
    tolerance, phrases on the general path)."""
    from tests.test_torch_slice import assert_same_response
    from opensearch_tpu_torch import bench_corpus as bc
    ref, port, _ix, corpus, title = bench_small
    df = corpus[4]
    vs = bc.vocab_strings(len(df))
    queries = bc.pick_queries(df, 40)
    pairs = bc.pick_phrase_pairs(title[7], 40)
    bodies = [bc.mixed_body(i, queries, vs, pairs, title) for i in range(40)]
    lines = sum([[{}, b] for b in bodies], [])
    C.reset_stats()
    got = port.msearch(lines, index="bench")["responses"]
    assert C.STATS["general_served"] >= 8      # the phrase bodies
    want = ref.msearch(lines, index="bench")["responses"]
    for g, w in zip(got, want):
        assert_same_response(g, w)
