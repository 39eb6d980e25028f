"""The PyTorch port's slice (opensearch_tpu_torch: analysis -> bulk ->
refresh -> term / terms / match search) against the JAX package on the CPU.

Both packages index codec-v1 segments (OPENSEARCH_TPU_CODEC=1); the JAX
package, on the CPU, serves these queries through its general XLA path,
and the port runs `RestClient(device="cpu")`, whose kernel wrappers take
their plain PyTorch versions. Same documents, same bodies. Tolerances:
- hits.total (value and relation), `_id` order, `_source` and max_score
  presence: identical;
- `_score`: relative 1e-6. Both sides sum the same f32 contributions, but
  in other orders (XLA's scatter-add against the port's slot order) and
  XLA on the CPU contracts `tf + k1 * y` into a fused multiply-add;
- `_id` order is tie-tolerant: two hits may swap places only when their
  scores agree within that tolerance.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import bench
import chip_smoke
from opensearch_tpu.analysis.analyzers import AnalysisRegistry as RefRegistry
from opensearch_tpu.ops import scoring as ref_scoring
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu_torch import NotPortedError, RestClient, bench_corpus
from opensearch_tpu_torch.analysis import AnalysisRegistry
from opensearch_tpu_torch.index.convert import segment_from_arrays
from opensearch_tpu_torch.ops import scoring
from opensearch_tpu_torch.search import compiler as C
from opensearch_tpu_torch.search import fastpath
from opensearch_tpu_torch.search import query_dsl as dsl

jax.config.update("jax_platforms", "cpu")

RTOL = 1e-6
NDOCS = 300
NQUERIES = 16
MAPPING = {"mappings": {"properties": {"body": {"type": "text"}}}}


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    docs, words = chip_smoke.make_text_corpus(rng, NDOCS)
    queries = chip_smoke.slice_queries(rng, words)[:NQUERIES]
    bulk = []
    for i, d in enumerate(docs):
        bulk += [{"index": {"_index": "t", "_id": f"d{i}"}}, d]
    return docs, queries, bulk


def _fill(client, bulk):
    client.indices.create("t", MAPPING)
    # two refreshes: two segments
    client.bulk(bulk[:NDOCS], refresh=True)
    client.bulk(bulk[NDOCS:], refresh=True)
    return client


@pytest.fixture(scope="module")
def clients(corpus):
    bulk = corpus[2]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENSEARCH_TPU_CODEC", "1")
        return _fill(RefClient(), bulk), _fill(RestClient(device="cpu"), bulk)


def _ref_segments(ref):
    return ref.node.indices["t"].shards[0].segments


def _port_segments(port):
    return port._indices["t"].engine.segments


def assert_same_response(got, want):
    assert got["hits"]["total"] == want["hits"]["total"]
    assert (got["hits"]["max_score"] is None) \
        == (want["hits"]["max_score"] is None)
    if want["hits"]["max_score"] is not None:
        np.testing.assert_allclose(got["hits"]["max_score"],
                                   want["hits"]["max_score"], rtol=RTOL)
    gh, wh = got["hits"]["hits"], want["hits"]["hits"]
    assert len(gh) == len(wh)
    for g, w in zip(gh, wh):
        np.testing.assert_allclose(g["_score"], w["_score"], rtol=RTOL)
        assert g["_index"] == w["_index"]
        if g["_id"] != w["_id"]:
            # a swap between near-tied hits: the reference's doc must sit
            # in the port's page with a score within tolerance
            twin = [h for h in gh if h["_id"] == w["_id"]]
            assert twin, f"{w['_id']} missing from the port's page"
            np.testing.assert_allclose(twin[0]["_score"], w["_score"],
                                       rtol=RTOL)
        else:
            assert g["_source"] == w["_source"]


@pytest.mark.parametrize("qi", range(NQUERIES))
def test_search_matches_reference(clients, corpus, qi):
    ref, port = clients
    body = corpus[1][qi]
    assert_same_response(port.search("t", body), ref.search("t", body))


def test_msearch_matches_reference(clients, corpus):
    ref, port = clients
    lines = []
    for body in corpus[1]:
        lines += [{}, body]
    got = port.msearch(lines, index="t")["responses"]
    want = ref.msearch(lines, index="t")["responses"]
    assert len(got) == len(want) == NQUERIES
    for g, w in zip(got, want):
        assert_same_response(g, w)


@pytest.fixture(scope="module")
def stopword_clients():
    """One segment of 2500 short docs, nearly all holding "the": enough
    postings in one row to split into doc-range chunks once the per-row
    budget is lowered."""
    rng = np.random.default_rng(5)
    words = ["the", "of", "and", "kalo", "mira", "tesu", "novi", "depo"]
    bulk = []
    for i in range(2500):
        text = " ".join(rng.choice(words, int(rng.integers(2, 9))))
        bulk += [{"index": {"_index": "t", "_id": f"s{i}"}}, {"body": text}]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENSEARCH_TPU_CODEC", "1")
        ref = RefClient()
        ref.indices.create("t", MAPPING)
        ref.bulk(bulk, refresh=True)
        port = RestClient(device="cpu")
        port.indices.create("t", MAPPING)
        port.bulk(bulk, refresh=True)
    return ref, port


@pytest.mark.parametrize("body", [
    {"query": {"match": {"body": "the"}}, "size": 50},
    {"query": {"match": {"body": "the of"}}, "from": 20, "size": 30},
])
def test_chunked_stopword_query_matches_reference(stopword_clients,
                                                  monkeypatch, body):
    ref, port = stopword_clients
    # 1024 elements per slot: the least budget a kernel row can take
    nterms = len(body["query"]["match"]["body"].split())
    monkeypatch.setattr(fastpath, "MAX_TL", 1024 * nterms)
    searcher = port._indices["t"].searcher
    ctx = searcher.context()
    lt = C.rewrite(dsl.parse_query(body["query"]), ctx)
    seg = _port_segments(port)[0]
    vq = fastpath._prepare_vqueries(seg, ctx, [lt], {}, searcher.device)[0]
    assert vq.n > 1, "the lowered budget must split the query into chunks"
    assert_same_response(port.search("t", body), ref.search("t", body))


def test_size_zero_and_track_total_hits(clients):
    ref, port = clients
    for body in ({"query": {"match": {"body": "the"}}, "size": 0},
                 {"query": {"match": {"body": "the"}},
                  "track_total_hits": 5}):
        assert_same_response(port.search("t", body), ref.search("t", body))


TEXTS = ["The Quick brown-fox jumped; over 2 lazy dogs!",
         "Ünïcödé Straße, café's naïve Zürich: ÉLAN 42nd",
         "it's   the end\tof a\nline -- and AN email@example.com",
         "", "don't stop 3.14 x_y foo_bar", "日本語 テキスト 中文"]


@pytest.mark.parametrize("name", ["standard", "simple", "whitespace",
                                  "keyword", "stop"])
def test_analyzer_tokens_match_reference(name):
    ref = RefRegistry().get(name)
    port = AnalysisRegistry().get(name)
    for text in TEXTS:
        want = [(t.text, t.position, t.start_offset, t.end_offset)
                for t in ref.analyze(text)]
        got = [(t.text, t.position, t.start_offset, t.end_offset)
               for t in port.analyze(text)]
        assert got == want, text


def test_segments_match_reference(clients):
    ref, port = clients
    rsegs, psegs = _ref_segments(ref), _port_segments(port)
    assert len(rsegs) == len(psegs) == 2
    for r, p in zip(rsegs, psegs):
        assert r.codec_version == p.codec_version == 1
        assert r.ndocs == p.ndocs and list(r.ids) == list(p.ids)
        assert set(r.postings) == set(p.postings)
        for f, rb in r.postings.items():
            pb = p.postings[f]
            assert list(rb.vocab) == list(pb.vocab), f
            for a in ("starts", "doc_ids", "tfs"):
                np.testing.assert_array_equal(getattr(pb, a),
                                              getattr(rb, a), err_msg=f)
        assert set(r.doc_lens) == set(p.doc_lens)
        for f in r.doc_lens:
            np.testing.assert_array_equal(p.doc_lens[f], r.doc_lens[f])
        assert {f: (s.doc_count, s.sum_dl) for f, s in r.text_stats.items()} \
            == {f: (s.doc_count, s.sum_dl) for f, s in p.text_stats.items()}


def test_segment_from_arrays_round_trip(clients, corpus, monkeypatch):
    ref, _ = clients
    monkeypatch.setenv("OPENSEARCH_TPU_CODEC", "1")
    port = RestClient(device="cpu")
    port.indices.create("t", MAPPING)
    segs = []
    for i, r in enumerate(_ref_segments(ref)):
        postings = {f: {"vocab": pb.vocab, "starts": pb.starts,
                        "doc_ids": pb.doc_ids, "tfs": pb.tfs}
                    for f, pb in r.postings.items()}
        stats = {f: (s.doc_count, s.sum_dl) for f, s in r.text_stats.items()}
        segs.append(segment_from_arrays(f"_{i}", r.ndocs, postings,
                                        r.doc_lens, stats, list(r.ids),
                                        list(r.sources), live=r.live))
    port._indices["t"].engine.segments = segs
    for body in corpus[1][:6]:
        assert_same_response(port.search("t", body), ref.search("t", body))


def test_score_term_group_matches_reference(clients):
    ref, port = clients
    rseg, pseg = _ref_segments(ref)[0], _port_segments(port)[0]
    pb = pseg.postings["body"]
    terms = ["the", "of", pb.vocab[len(pb.vocab) // 2]]
    rows = [pb.row(t) for t in terms] + [-1]
    weights = np.array([1.5, 0.25, 3.0, 0.0], np.float32)
    avgdl = np.float32(41.7)
    arrs = rseg.device_arrays()
    want_s, want_c = ref_scoring.score_term_group(
        arrs["postings"]["body"], arrs["doc_lens"]["body"], arrs["live"],
        jax.numpy.asarray(rows, jax.numpy.int32), weights,
        np.zeros(4, np.float32),
        ref_scoring.pick_bucket(sum(pb.doc_freq(t) for t in terms)),
        rseg.ndocs_pad, ref_scoring.SIM_BM25, 1.2, 0.75, avgdl)
    post = scoring.FieldPostings(
        pb.starts[:-1], np.diff(pb.starts), pb.starts[:-1],
        torch.from_numpy(pb.doc_ids), d_tfs=torch.from_numpy(pb.tfs),
        d_dl=torch.from_numpy(pseg.doc_lens["body"].astype(np.float32)))
    got_s, got_c = scoring.score_term_group(
        post, rows, weights, torch.ones(pseg.ndocs, dtype=torch.bool),
        pseg.ndocs, 1.2, 0.75, avgdl)
    n = pseg.ndocs
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c)[:n])
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s)[:n],
                               rtol=RTOL)


@pytest.mark.parametrize("body,names", [
    ({"query": {"bool": {"must": [{"bool": {"should": [
        {"match_phrase": {"body": "a b"}}]}}]}}}, "match_phrase"),
    ({"query": {"range": {"body": {"gte": 1}}}}, "range"),
    ({"query": {"match": {"body": "the"}},
      "aggs": {"a": {"terms": {"field": "tag.keyword"}}}}, "aggs"),
    ({"query": {"match_all": {}}, "from": 100, "size": 29,
      "search_after": [1.0]}, "search_after"),
    ({"query": {"match": {"body": "the"}}, "sort": ["_doc"]}, "sort"),
    ({"query": {"match": {"body": {"query": "the",
                                   "fuzziness": 1}}}}, "fuzziness"),
])
def test_unported_shapes_raise(clients, body, names):
    _, port = clients
    with pytest.raises(NotPortedError) as e:
        port.search("t", body)
    assert names in str(e.value)


@pytest.mark.parametrize("body", [
    {"query": {"bool": {"must": [{"bool": {"should": [
        {"match": {"body": "a"}}]}}]}}},
    {"query": {"match": {"body": "the"}}, "from": 100, "size": 29},
])
def test_formerly_unported_shapes_match_reference(clients, body):
    """A nested bool and a window past MAX_K: the fast path declines them
    (they raised before the general path was ported), the general path
    serves the reference's response."""
    ref, port = clients
    ctx = port._indices["t"].searcher.context()
    assert fastpath.make_spec(C.rewrite(dsl.parse_query(body["query"]), ctx),
                              body.get("from", 0) + body.get("size", 10),
                              body) is None
    assert_same_response(port.search("t", body), ref.search("t", body))


def _reindexed(client):
    client.index("x", {"body": "one two"}, id="1")
    client.index("x", {"body": "one four"}, id="2", refresh=True)
    client.index("x", {"body": "one three"}, id="1")
    return client


def test_unported_index_states_raise():
    with pytest.raises(NotPortedError, match="number_of_shards"):
        RestClient(device="cpu").indices.create(
            "x", {"settings": {"number_of_shards": 2}})
    port = _reindexed(RestClient(device="cpu"))
    port.index("x", {"body": "one five"}, id="2")
    with pytest.raises(NotPortedError, match="segment merge"):
        port.indices.refresh("x")


def test_deleted_docs_search_matches_reference():
    """A re-indexed `_id` leaves a deleted doc in its first segment: the
    search serves (the general path reads the live mask) and equals the
    reference's response."""
    ref, port = _reindexed(RefClient()), _reindexed(RestClient(device="cpu"))
    port.indices.refresh("x")
    ref.indices.refresh("x")
    for body in ({"query": {"match": {"body": "one"}}},
                 {"query": {"match_all": {}}},
                 {"query": {"ids": {"values": ["1", "2"]}}}):
        got, want = port.search("x", body), ref.search("x", body)
        assert chip_smoke.strip_took(got) == chip_smoke.strip_took(want)
        assert got["hits"]["total"]["value"] == 2


def test_no_card_raises_instead_of_running_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA device"):
        RestClient()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import opensearch_tpu_torch\n"
        "for m in pkgutil.walk_packages(opensearch_tpu_torch.__path__,\n"
        "                               'opensearch_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from opensearch_tpu_torch import RestClient\n"
        "c = RestClient(device='cpu')\n"
        "c.index('t', {'body': 'hello world', 'n': 3}, id='1',\n"
        "        refresh=True)\n"
        "r = c.search('t', {'query': {'bool': {\n"
        "    'must': [{'match': {'body': 'hello'}}],\n"
        "    'filter': [{'range': {'n': {'gte': 1}}}]}}})\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'opensearch_tpu' or "
        "m.startswith('opensearch_tpu.'))\n"
        "print(json.dumps({'bad': bad, 'hits': r['hits']['total']}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "hits": {"value": 1, "relation": "eq"}}


def test_bench_corpus_matches_bench_py():
    want = bench.build_corpus(20_000)
    got = bench_corpus.build_corpus(20_000)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    df = want[4]
    np.testing.assert_array_equal(bench_corpus.pick_queries(df, 64),
                                  bench.pick_queries(df, 64))
    np.testing.assert_array_equal(bench_corpus.pick_queries_real(df, 64),
                                  bench.pick_queries_real(df, 64))
