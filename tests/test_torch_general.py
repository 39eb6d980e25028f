"""The port's general query path (opensearch_tpu_torch/ops/scoring.py,
search/compiler.py `emit` / `run_segment`, search/filters.py) and the
shapes it serves where the fused kernels decline, against the JAX package
on the CPU.

- Primitives: masks bit-equal to the reference's jnp ones; term-group
  scores within 1e-6 relative (the reference's XLA contracts
  `tf + k1 * y` into a fused multiply-add, ROADMAP Queue 3) with match
  counts equal; top-k ids and values equal, mass ties in ascending doc
  order.
- End to end through RestClient.search and msearch, the same bulk on fresh
  clients of both packages (codec v2; the reference runs its default CPU
  path: the impact rung, then its general XLA program), one body per shape
  that the fused kernels decline:
  - where the reference serves the body through its impact rung, so does
    the port, and the responses are equal apart from `took`;
  - where it serves through its general program: ids and order identical
    (two hits may swap only when their scores agree within the
    tolerance), scores within 1e-6 relative, totals equal.
- The fast path keeps what it served: those bodies ride the same route and
  touch neither new rung.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from opensearch_tpu.index.segment import split_i64
from opensearch_tpu.ops import scoring as rops
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu.search import impactpath as ref_impactpath
from opensearch_tpu_torch import RestClient
from opensearch_tpu_torch.ops import scoring
from opensearch_tpu_torch.search import compiler as C
from opensearch_tpu_torch.search import fastpath, impactpath

jax.config.update("jax_platforms", "cpu")

CPU = torch.device("cpu")
RTOL = 1e-6
NDOCS = 1600
MAPPING = {"properties": {"body": {"type": "text"},
                          "status": {"type": "keyword"},
                          "price": {"type": "integer"}}}
PUB = {"term": {"status": "published"}}


def make_bulk(seed: int = 41):
    """NDOCS docs: Zipf-ish words over `body`, a status keyword, an integer
    price on most docs and a dynamic long `n` on some; the last doc holds
    one term 2,100 times (tf above the kernels' packing bound)."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(50)]
    p = 1.0 / np.arange(1, 51) ** 0.9
    p /= p.sum()
    bulk = []
    for i in range(NDOCS):
        doc = {"body": " ".join(rng.choice(words, int(rng.integers(3, 14)),
                                           p=p)),
               "status": ("archived", "draft", "published")[
                   int(rng.integers(0, 3))]}
        if rng.random() < 0.9:
            doc["price"] = int(rng.integers(0, 1000))
        if rng.random() < 0.3:
            doc["n"] = int(rng.integers(-5, 5))
        if i == NDOCS - 1:
            doc["body"] = "zz " * 2100 + "w1"
        bulk += [{"index": {"_index": "t", "_id": f"d{i}"}}, doc]
    return bulk


def fill(client, bulk):
    client.indices.create("t", {"mappings": MAPPING})
    cut = (len(bulk) // 4) * 2
    client.bulk(bulk[:cut], refresh=True)
    client.bulk(bulk[cut:], refresh=True)
    return client


@pytest.fixture(scope="module")
def bulk():
    return make_bulk()


@pytest.fixture(scope="module")
def clients(bulk):
    return fill(RefClient(), bulk), fill(RestClient(device="cpu"), bulk)


def assert_close(got, want, name):
    """The general-path tolerance: totals equal, ids and order identical
    up to swaps of hits whose scores agree within RTOL, scores and
    max_score within RTOL."""
    assert got["hits"]["total"] == want["hits"]["total"], name
    gm, wm = got["hits"]["max_score"], want["hits"]["max_score"]
    assert (gm is None) == (wm is None), name
    if wm is not None:
        np.testing.assert_allclose(gm, wm, rtol=RTOL, err_msg=name)
    gh, wh = got["hits"]["hits"], want["hits"]["hits"]
    assert len(gh) == len(wh), name
    for g, w in zip(gh, wh):
        np.testing.assert_allclose(g["_score"], w["_score"], rtol=RTOL,
                                   err_msg=name)
        if g["_id"] != w["_id"]:
            twin = [h for h in gh if h["_id"] == w["_id"]]
            assert twin, (name, w["_id"])
            np.testing.assert_allclose(twin[0]["_score"], w["_score"],
                                       rtol=RTOL, err_msg=name)
        else:
            assert g["_source"] == w["_source"], name


def assert_reference_response(port_search, ref_search, body, name):
    """Run `body` through both packages: the same rung (impact or
    general) as the reference, equal responses through the impact rung,
    close ones through the general program."""
    r0 = ref_impactpath.stats()["served"]
    p0 = impactpath.STATS["served"]
    want = ref_search(body)
    got = port_search(body)
    ref_impact = ref_impactpath.stats()["served"] > r0
    assert (impactpath.STATS["served"] > p0) == ref_impact, name
    if ref_impact:
        assert chip_smoke.strip_took(got) == chip_smoke.strip_took(want), \
            name
    else:
        assert_close(got, want, name)


W9 = " ".join(f"w{i}" for i in range(9))
# (name, body): one of each shape the fused kernels decline
SHAPES = [
    ("tf above TF_MAX", {"query": {"match": {"body": "zz w1"}}}),
    ("top-level range", {"query": {"range": {"price": {"gte": 100,
                                                        "lt": 130}}}}),
    ("numeric term", {"query": {"term": {"price": 7}}}),
    ("numeric match", {"query": {"match": {"n": 3}}}),
    ("mixed fields", {"query": {"bool": {"must": [
        {"match": {"body": "w1 w2"}}, {"term": {"status": "draft"}}]}}}),
    ("nested bool", {"query": {"bool": {"should": [
        {"bool": {"must": [{"match": {"body": "w3"}}], "filter": [PUB]}},
        {"match": {"body": "w4"}}]}}}),
    ("range scoring clause", {"query": {"bool": {
        "must": [{"match": {"body": "w1"}}],
        "should": [{"range": {"price": {"lt": 100}}}]}}}),
    ("two families", {"query": {"bool": {"must": [
        {"match": {"body": "w1 w2"}}, {"match": {"body": "w3 w4"}}]}}}),
    ("empty bool", {"query": {"bool": {}}}),
    ("boost 0", {"query": {"bool": {"must": [{"match": {"body": "w1"}}],
                                    "boost": 0}}}),
    ("bonus should with msm", {"query": {"bool": {
        "must": [{"match": {"body": "w1"}}],
        "should": [{"match": {"body": {"query": "w2 w3 w4",
                                       "minimum_should_match": 2}}}]}}}),
    ("msm over multi-term shoulds", {"query": {"bool": {"should": [
        {"match": {"body": "w1 w2"}}, {"match": {"body": "w3 w4"}}],
        "minimum_should_match": 2}}}),
    ("more than 8 slots", {"query": {"bool": {
        "must": [{"match": {"body": "w1 w2 w3 w4 w5"}}],
        "should": [{"match": {"body": "w6 w7 w8 w9"}}]}}}),
    ("from + size > 128", {"query": {"match": {"body": "w1 w2"}},
                           "from": 120, "size": 20}),
    ("9-token match", {"query": {"match": {"body": W9}}}),
    ("9-token match, exact totals", {"query": {"match": {"body": W9}},
                                     "track_total_hits": True}),
    ("9-token match, msm 3", {"query": {"match": {"body": {
        "query": W9, "minimum_should_match": 3}}}, "size": 20}),
    ("match_all", {"query": {"match_all": {}}}),
    ("match_all from 1000", {"query": {"match_all": {"boost": 2.0}},
                             "from": 1000, "size": 10}),
    ("no query", {"size": 5}),
    ("match_none", {"query": {"match_none": {}}}),
    ("exists numeric", {"query": {"exists": {"field": "n"}}}),
    ("exists keyword", {"query": {"exists": {"field": "status"}}}),
    ("exists text", {"query": {"exists": {"field": "body"}}}),
    ("exists unmapped", {"query": {"exists": {"field": "nope"}}}),
    ("ids", {"query": {"ids": {"values": ["d5", "d900", "d4", "x"]}}}),
    ("exists filter", {"query": {"bool": {
        "must": [{"match": {"body": "w2 w5"}}, {"term": {"status": "draft"}}],
        "filter": [{"exists": {"field": "n"}}]}}}),
    ("ids and match_all filters", {"query": {"bool": {
        "should": [{"match": {"body": "w1"}}, {"range": {"price": {
            "gte": 500}}}],
        "filter": [{"ids": {"values": [f"d{i}" for i in range(0, 900, 3)]}},
                   {"match_all": {}}],
        "must_not": [{"match_none": {}}, {"exists": {"field": "n"}}]}}}),
    ("constant_score of exists", {"query": {"constant_score": {
        "filter": {"bool": {"must": [{"exists": {"field": "price"}}],
                            "must_not": [PUB]}}, "boost": 3.0}}}),
    ("terms over 8 values", {"query": {"terms": {
        "body": [f"w{i}" for i in range(10, 20)]}}}),
]


@pytest.mark.parametrize("name,body", SHAPES, ids=[n for n, _ in SHAPES])
def test_search_matches_reference(clients, name, body):
    ref, port = clients
    assert_reference_response(lambda b: port.search("t", b),
                              lambda b: ref.search("t", b), body, name)


def test_msearch_matches_reference(clients):
    """Every shape in one msearch: each response equals the port's single
    search and the reference's msearch response (the tolerance of its
    rung)."""
    ref, port = clients
    lines = sum([[{}, b] for _n, b in SHAPES], [])
    got = port.msearch(lines, index="t")["responses"]
    want = ref.msearch(lines, index="t")["responses"]
    for (name, body), g, w in zip(SHAPES, got, want):
        assert chip_smoke.strip_took(g) == chip_smoke.strip_took(
            port.search("t", body)), name
        if g["hits"]["total"]["relation"] == "gte":
            assert chip_smoke.strip_took(g) == chip_smoke.strip_took(w), name
        else:
            assert_close(g, w, name)


def _reindexed(client, bulk):
    fill(client, bulk)
    for i in (3, 700, 1200):      # both segments lose a doc
        client.index("t", {"body": "w1 w2 w3 fresh", "price": 5},
                     id=f"d{i}")
    client.indices.refresh("t")
    return client


@pytest.fixture(scope="module")
def reindexed(bulk):
    return _reindexed(RefClient(), bulk), _reindexed(RestClient(device="cpu"),
                                                     bulk)


RE_BODIES = [
    {"query": {"match": {"body": "w1 w2"}}},
    {"query": {"match": {"body": "w3 fresh"}}, "track_total_hits": True},
    {"query": {"bool": {"must": [{"match": {"body": "w1 w4"}}],
                        "filter": [PUB]}}},
    {"query": {"constant_score": {"filter": {"range": {"price": {
        "lte": 5}}}}}},
    {"query": {"ids": {"values": ["d3", "d700", "d4"]}}},
    {"query": {"match_all": {}}, "size": 3},
]


@pytest.mark.parametrize("qi", range(len(RE_BODIES)))
def test_reindexed_id_matches_reference(reindexed, qi):
    """Re-indexed `_id`s leave deleted docs in both segments: the kernels
    decline those segments and the impact rung or the general path serves
    them, as in the reference."""
    ref, port = reindexed
    segs = port._indices["t"].engine.segments
    assert len(segs) == 3 and all(s.live_count < s.ndocs for s in segs[:2])
    body = RE_BODIES[qi]
    assert_reference_response(lambda b: port.search("t", b),
                              lambda b: ref.search("t", b), body, str(qi))


def test_reindexed_msearch_matches_search(reindexed):
    _ref, port = reindexed
    lines = sum([[{}, b] for b in RE_BODIES], [])
    got = port.msearch(lines, index="t")["responses"]
    for b, g in zip(RE_BODIES, got):
        assert chip_smoke.strip_took(g) == chip_smoke.strip_took(
            port.search("t", b))
    assert got[4]["hits"]["total"]["value"] == 3


@pytest.mark.parametrize("name,body", [
    ("pure dense", {"query": {"match": {"body": "w0"}},
                    "track_total_hits": True, "size": 20}),
    ("bool", {"query": {"bool": {"must": [{"match": {"body": "w0 w9"}}],
                                 "filter": [{"range": {"price": {
                                     "gte": 100}}}]}}}),
])
def test_chunk_overflow_declines_to_the_reference_rungs(clients, monkeypatch,
                                                        name, body):
    """Rows that need more than MAX_CHUNKS doc-range chunks (the budget
    shrunk to one chunk of one tile per slot): the fast path declines, the
    other rungs serve the reference's response."""
    ref, port = clients
    monkeypatch.setattr(fastpath, "MAX_TL", 2048)
    monkeypatch.setattr(fastpath, "MAX_CHUNKS", 1)
    f0 = fastpath.STATS["fallback"]
    assert_reference_response(lambda b: port.search("t", b),
                              lambda b: ref.search("t", b), body, name)
    assert fastpath.STATS["fallback"] > f0


def test_filter_context_match_on_codec_v2(bulk, monkeypatch):
    """A `match` in filter context on codec-v2 segments, on the general
    path: the port's postings-only mask, held against the reference on
    codec v1 (whose general path reads the tf plane there; ROADMAP Queue
    3)."""
    port = fill(RestClient(device="cpu"), bulk)
    monkeypatch.setenv("OPENSEARCH_TPU_CODEC", "1")
    ref = fill(RefClient(), bulk)
    body = {"query": {"bool": {
        "must": [{"term": {"status": "draft"}}, {"match": {"body": "w2"}}],
        "filter": [{"match": {"body": {"query": "w1 w3 w5",
                                       "minimum_should_match": 2}}}]}}}
    g0 = C.STATS["general_served"]
    assert_close(port.search("t", body), ref.search("t", body), "v2 filter")
    assert C.STATS["general_served"] > g0
    assert port._indices["t"].engine.segments[0].codec_version == 2


FAST_BODIES = [
    {"query": {"match": {"body": "w1 w2"}}},
    {"query": {"match": {"body": "w0 w3 w7"}}, "track_total_hits": True},
    {"query": {"terms": {"status": ["draft"]}}},
    {"query": {"bool": {"must": [{"match": {"body": "w1 w4"}}],
                        "filter": [PUB]}}},
    {"query": {"constant_score": {"filter": PUB, "boost": 2.0}}},
]


def test_fast_path_keeps_what_it_served(bulk):
    """Bodies the fused kernels served before the general path was ported
    still ride them: each counts as served, none declines, and neither
    new rung runs (the bulk without its doc past the packing bound)."""
    port = fill(RestClient(device="cpu"), bulk[:-2])
    for body in FAST_BODIES:
        before = (dict(fastpath.STATS), impactpath.STATS["served"],
                  C.STATS["general_served"])
        port.search("t", body)
        served = sum(fastpath.STATS[k] - before[0][k]
                     for k in ("pure_served", "bool_served"))
        assert served >= 1 and fastpath.STATS["fallback"] == \
            before[0]["fallback"], body
        assert (impactpath.STATS["served"], C.STATS["general_served"]) \
            == before[1:], body


# ---------------------------------------------------------------------
# primitives against the reference's jnp ones
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def v1_segments(bulk):
    """Codec-v1 segments of both packages (the reference's term filter
    reads the tf plane, which v2 leaves off the device)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENSEARCH_TPU_CODEC", "1")
        ref, port = fill(RefClient(), bulk), fill(RestClient(device="cpu"),
                                                   bulk)
    rseg = ref.node.indices["t"].shards[0].segments[0]
    pseg = port._indices["t"].engine.segments[0]
    return rseg, pseg


def _sources(pseg):
    """The field's postings through both sources: the aligned layout and
    the CSR copy."""
    pb = pseg.postings["body"]
    csr = scoring.FieldPostings(
        pb.starts[:-1], np.diff(pb.starts), pb.starts[:-1],
        torch.from_numpy(pb.doc_ids), d_tfs=torch.from_numpy(pb.tfs),
        d_dl=pseg.doc_lens_on("body", CPU))
    return {"aligned": C.field_postings(pseg, "body", CPU), "csr": csr}


ROWSETS = [["w0"], ["w1", "w7", "nope", "w20"], ["w3", "w2", "w11", "w40",
                                                  "w41"]]


@pytest.mark.parametrize("source", ["aligned", "csr"])
def test_term_group_and_masks_match_reference(v1_segments, source):
    rseg, pseg = v1_segments
    pb = pseg.postings["body"]
    post = _sources(pseg)[source]
    live = pseg.live.copy()
    live[::7] = False
    live_t = torch.from_numpy(live)
    rlive = np.zeros(rseg.ndocs_pad, np.float32)
    rlive[:rseg.ndocs] = live
    arrs = rseg.device_arrays()
    n = pseg.ndocs
    for terms in ROWSETS:
        T = 1 << (len(terms) - 1).bit_length()
        rows = [pb.row(t) for t in terms] + [-1] * (T - len(terms))
        w = np.linspace(0.5, 2.5, T).astype(np.float32)
        total = sum(pb.doc_freq(t) for t in terms)
        bucket = rops.pick_bucket(total)
        jrows = jnp.asarray(rows, jnp.int32)
        want_s, want_c = rops.score_term_group(
            arrs["postings"]["body"], arrs["doc_lens"]["body"], rlive, jrows,
            w, np.zeros(T, np.float32), bucket, rseg.ndocs_pad,
            rops.SIM_BM25, 1.2, 0.75, np.float32(9.3))
        got = scoring.score_term_group(post, rows, w, live_t, n, 1.2, 0.75,
                                       9.3)
        np.testing.assert_array_equal(got.count.numpy(),
                                      np.asarray(want_c)[:n])
        np.testing.assert_allclose(got.scores.numpy(),
                                   np.asarray(want_s)[:n], rtol=RTOL)
        want_m = rops.term_filter_mask(arrs["postings"]["body"], rlive,
                                       jrows, bucket, rseg.ndocs_pad)
        want_m2 = rops.term_match_mask(arrs["postings"]["body"], rlive,
                                       jrows, bucket, rseg.ndocs_pad)
        got_m = scoring.term_match_mask(post, live_t, rows, n).numpy()
        np.testing.assert_array_equal(got_m, np.asarray(want_m)[:n])
        np.testing.assert_array_equal(got_m, np.asarray(want_m2)[:n])


def test_column_masks_match_reference():
    rng = np.random.default_rng(5)
    n = 4096
    vals = rng.integers(-2**62, 2**62, n).astype(np.int64)
    vals[:8] = [-2**63, 2**63 - 1, 0, -1, 1, 2**32, -2**32, 2**31]
    present = rng.random(n) < 0.8
    live = rng.random(n) < 0.9
    hi32, lo32 = split_i64(vals)
    col = {"hi": jnp.asarray(hi32), "lo": jnp.asarray(lo32),
           "present": jnp.asarray(present)}
    vt, pt, lt = (torch.from_numpy(a) for a in (vals, present, live))
    for lo, hi in ((-2**63, 2**63 - 1), (-1, 2**32), (2**31, 2**31),
                   (int(vals[20]), int(vals[30]))):
        for inc_lo in (True, False):
            for inc_hi in (True, False):
                (lh,), (ll,) = split_i64(np.asarray([lo]))
                (hh,), (hl,) = split_i64(np.asarray([hi]))
                want = rops.int64_range_mask(col, lh, ll, hh, hl, inc_lo,
                                             inc_hi)
                got = scoring.int64_range_mask(vt, pt, lo, hi, inc_lo, inc_hi)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        scoring.exists_mask(pt, lt).numpy(),
        np.asarray(rops.exists_mask(jnp.asarray(present),
                                    jnp.asarray(live, jnp.float32))))
    docs = [3, 17, 4095, 17, 0]
    pad = np.full(8, 2**31 - 1, np.int32)
    pad[:len(docs)] = docs
    np.testing.assert_array_equal(
        scoring.docs_mask(docs, n, CPU).numpy(),
        np.asarray(rops.docs_mask(jnp.asarray(pad), n)))


@pytest.mark.parametrize("case", ["random", "mass ties", "few matched"])
def test_topk_docs_matches_reference(case):
    """Top-k ids and values equal `jax.lax.top_k`'s: score desc, ties by
    ascending doc id (every doc tied, as under match_all, included)."""
    rng = np.random.default_rng(len(case))
    n = 5000
    if case == "random":
        scores = rng.standard_normal(n).astype(np.float32)
        matched = rng.random(n) < 0.7
    elif case == "mass ties":
        scores = rng.choice(np.float32([0.0, -0.0, 1.5, 2.0]), n)
        matched = np.ones(n, bool)
    else:
        scores = rng.random(n).astype(np.float32)
        matched = rng.random(n) < 0.002
    live = rng.random(n) < 0.95
    for k in (1, 16, 128, 1024):
        wv, wi = rops.topk_docs(jnp.asarray(scores), jnp.asarray(matched),
                                jnp.asarray(live, jnp.float32), k)
        gv, gi = scoring.topk_docs(torch.from_numpy(scores),
                                   torch.from_numpy(matched),
                                   torch.from_numpy(live), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        assert gv.numpy().tobytes() == np.asarray(wv).tobytes()
        want_t = rops.total_hits(jnp.asarray(matched),
                                 jnp.asarray(live, jnp.float32))
        assert int(scoring.total_hits(torch.from_numpy(matched),
                                      torch.from_numpy(live))) == int(want_t)
