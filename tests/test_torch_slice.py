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
        {"span_or": {"clauses": [{"span_term": {"body": "a"}}]}}]}}]}}},
     "span_or"),
    ({"query": {"range": {"body": {"gte": 1}}}}, "range"),
    ({"query": {"match": {"body": "the"}},
      "aggs": {"a": {"geo_bounds": {"field": "loc"}}}}, "aggs"),
    ({"query": {"match_all": {}}, "sort": [{"_geo_distance": {
        "loc": [0.0, 0.0]}}]}, "_geo_distance"),
    ({"query": {"match": {"body": "the"}}, "rescore": {
        "window_size": 5, "query": {"rescore_query": {
            "span_or": {"clauses": [{"span_term": {"body": "the"}}]}}}}},
     "rescore"),
])
def test_unported_shapes_raise(clients, body, names):
    """Unported shapes raise NotPortedError naming them; a `range` on a
    text field (it raised NotPortedError before keyword ranges were
    ported) raises the reference's ValueError in both packages; a
    geo_bounds agg and a `_geo_distance` sort (ported with the geo slice)
    serve the reference's response over an unmapped `loc`."""
    ref, port = clients
    if names in ("aggs", "_geo_distance"):
        assert chip_smoke.strip_took(port.search("t", body)) == \
            chip_smoke.strip_took(ref.search("t", body))
        return
    if names == "range":
        for c in clients:
            with pytest.raises(ValueError,
                               match=r"cannot coerce for type \[text\]"):
                c.search("t", body)
        return
    with pytest.raises(NotPortedError) as e:
        port.search("t", body)
    assert names in str(e.value)


@pytest.mark.parametrize("body", [
    {"query": {"bool": {"must": [{"bool": {"should": [
        {"match": {"body": "a"}}]}}]}}},
    {"query": {"match": {"body": "the"}}, "from": 100, "size": 29},
    {"query": {"bool": {"must": [{"bool": {"should": [
        {"match_phrase": {"body": "a b"}}]}}]}}},
    {"query": {"match_all": {}}, "from": 100, "size": 29,
     "search_after": [1.0]},
    {"query": {"match": {"body": "the"}}, "sort": ["_doc"]},
    {"query": {"match": {"body": {"query": "the", "fuzziness": 1}}}},
])
def test_formerly_unported_shapes_match_reference(clients, body):
    """A nested bool, a window past MAX_K, a nested phrase, a
    search_after cursor, a `_doc` sort and a fuzzy match: the fast path
    declines them (they raised before the general path, the phrase
    slice, sort and the term expansions were ported), the general path
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
    """Several shards still raise. A refresh that leaves a segment with
    most of its docs deleted (it raised "segment merge" before merges
    were ported) now merges that segment away, as the reference does, and
    serves the reference's response."""
    with pytest.raises(NotPortedError, match="number_of_shards"):
        RestClient(device="cpu").indices.create(
            "x", {"settings": {"number_of_shards": 2}})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENSEARCH_TPU_REORDER", "0")
        ref = _reindexed(RefClient())
        port = _reindexed(RestClient(device="cpu"))
        for c in (ref, port):
            c.index("x", {"body": "one five"}, id="2")
            c.indices.refresh("x")
    assert [(s.name, s.ndocs) for s in port._indices["x"].engine.segments] \
        == [(s.name, s.ndocs) for s in ref.node.indices["x"].shards[0]
            .segments] == [("_1", 2), ("_m2", 0)]
    for body in ({"query": {"match": {"body": "one"}}},
                 {"query": {"match_all": {}}}):
        assert chip_smoke.strip_took(port.search("x", body)) \
            == chip_smoke.strip_took(ref.search("x", body))


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
        "import opensearch_tpu_torch.index.merge\n"
        "import opensearch_tpu_torch.index.translog\n"
        "import tempfile\n"
        "c = RestClient(device='cpu', data_path=tempfile.mkdtemp())\n"
        "c.index('t', {'body': 'hello world', 'n': 3}, id='1',\n"
        "        refresh=True)\n"
        "c.index('t', {'body': 'bye', 'n': 4}, id='2', refresh=True)\n"
        "c.update('t', '2', {'doc': {'n': 5}})\n"
        "c.delete('t', '2')\n"
        "c.indices.forcemerge('t')\n"
        "c.indices.flush('t')\n"
        "r = c.search('t', {'query': {'bool': {\n"
        "    'must': [{'match': {'body': 'hello'}}],\n"
        "    'filter': [{'range': {'n': {'gte': 1}}}]}}})\n"
        "c.indices.create('v', {'mappings': {'properties': {'e': {\n"
        "    'type': 'dense_vector', 'dims': 2, 'method': {'name': 'ivf'}}}}})\n"
        "c.bulk([{'index': {'_index': 'v', '_id': str(i)}} if j == 0 else\n"
        "        {'e': [1.0, i], 'body': 'hello'} for i in range(9)\n"
        "        for j in range(2)], refresh=True)\n"
        "c.indices.forcemerge('v')\n"
        "c.indices.flush('v')\n"
        "for q in ({'regexp': {'body': 'hel.*'}}, {'fuzzy': {'body': 'helo'}},\n"
        "          {'multi_match': {'query': 'hello', 'fields': ['body'],\n"
        "                           '_name': 'm'}},\n"
        "          {'combined_fields': {'query': 'hello', 'fields': ['body']}}):\n"
        "    assert c.search('t', {'query': q})['hits']['total']['value'] == 1\n"
        "import opensearch_tpu_torch.script.painless_lite\n"
        "import opensearch_tpu_torch.search.querystring\n"
        "for q in ({'query_string': {'query': 'body:hel* AND n:[1 TO 9]'}},\n"
        "          {'simple_query_string': {'query': 'hello -bye'}},\n"
        "          {'function_score': {'query': {'match': {'body': 'hello'}},\n"
        "              'gauss': {'n': {'origin': 3, 'scale': 2}}}},\n"
        "          {'script_score': {'query': {'match_all': {}},\n"
        "              'script': 'doc[\"n\"].value * 2'}},\n"
        "          {'bool': {'filter': [{'script': {'script': {\n"
        "              'source': 'doc[\"n\"].value > params.p',\n"
        "              'params': {'p': 1}}}}]}}):\n"
        "    assert c.search('t', {'query': q})['hits']['total']['value'] == 1\n"
        "c.update('t', '1', {'script': 'ctx._source.n += 1'})\n"
        "for q in ({'knn': {'e': {'vector': [1.0, 2.0], 'exact': True}}},\n"
        "          {'hybrid': {'queries': [{'match': {'body': 'hello'}},\n"
        "                                  {'knn': {'e': {'vector': [1.0, 0.5],\n"
        "                                                 'exact': True}}}]}}):\n"
        "    assert c.search('v', {'query': q})['hits']['total']['value'] == 9\n"
        "import opensearch_tpu_torch.search.geo\n"
        "c.indices.create('g', {'mappings': {'properties': {\n"
        "    'loc': {'type': 'geo_point'}, 'area': {'type': 'geo_shape'},\n"
        "    'r': {'type': 'date_range'}, 'f': {'type': 'flat_object'},\n"
        "    'a': {'type': 'annotated_text'}}}})\n"
        "c.index('g', {'loc': '1,2', 'area': 'POINT (2 1)', 'f': {'k': 'v'},\n"
        "              'r': {'gte': '2025-01-01'}, 'a': '[x](y)'}, id='1',\n"
        "        refresh=True)\n"
        "c.indices.forcemerge('g')\n"
        "c.indices.flush('g')\n"
        "for q in ({'geo_distance': {'distance': '1km', 'loc': '1,2'}},\n"
        "          {'geo_shape': {'area': {'shape': 'POINT (2 1)'}}},\n"
        "          {'range': {'r': {'gte': '2025-02-01'}}},\n"
        "          {'term': {'f.k': 'v'}}, {'term': {'a': 'y'}}):\n"
        "    assert c.search('g', {'query': q, 'aggs': {'b': {'geo_bounds':\n"
        "        {'field': 'loc'}}}, 'sort': [{'_geo_distance': {\n"
        "        'loc': [0, 0]}}]})['hits']['total']['value'] == 1\n"
        "import opensearch_tpu_torch.cluster.admin\n"
        "c.indices.put_index_template('tp', {'index_patterns': ['a*']})\n"
        "c.indices.create('a1', {'aliases': {'al': {}}})\n"
        "c.create('al', '1', {'body': 'hello'}, refresh=True)\n"
        "c.indices.put_settings('a1', {'index.blocks.write': True})\n"
        "c.indices.clone('a1', 'a2')\n"
        "c.indices.close('a2')\n"
        "c.indices.open('a2')\n"
        "assert c.search('a2', {'query': {'match': {'body': 'hello'}}})[\n"
        "    'hits']['total']['value'] == 1\n"
        "assert c.mtermvectors({'docs': [{'_index': 'al', '_id': '1'}]})[\n"
        "    'docs'][0]['found']\n"
        "assert c.indices.stats('a*')['_all']['total']['docs']['count'] == 2\n"
        "import opensearch_tpu_torch.search.join\n"
        "import opensearch_tpu_torch.search.percolate\n"
        "c.indices.create('qa', {'mappings': {'properties': {\n"
        "    'ans': {'type': 'nested'}, 'q': {'type': 'percolator'},\n"
        "    'j': {'type': 'join', 'relations': {'p': 'c'}}}}})\n"
        "c.index('qa', {'j': 'p', 'ans': [{'u': 'x'}], 'body': 'hello'},\n"
        "        id='p1')\n"
        "c.index('qa', {'j': {'name': 'c', 'parent': 'p1'}, 'u': 'x',\n"
        "               'q': {'match': {'body': 'hello'}}}, id='c1',\n"
        "        routing='p1', refresh=True)\n"
        "for q in ({'nested': {'path': 'ans', 'query': {'term': {'ans.u': 'x'}}}},\n"
        "          {'has_child': {'type': 'c', 'query': {'match_all': {}}}},\n"
        "          {'percolate': {'field': 'q', 'document': {'body': 'hello'}}},\n"
        "          {'more_like_this': {'like': 'hello', 'min_term_freq': 1,\n"
        "                              'min_doc_freq': 1}}):\n"
        "    assert c.search('qa', {'query': q})['hits']['total']['value'] == 1\n"
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


# ---------------------------------------------------------------------
# the reference's errors: unknown query kinds, missing and existing
# indices, a negative size
# ---------------------------------------------------------------------

def test_unknown_query_kind_is_a_400_and_an_msearch_entry(clients):
    """A kind the reference does not parse is its parse error: 400 from
    `search`, a per-body entry in msearch (the other bodies served); a
    kind it parses and the port does not still raises NotPortedError
    (a span kind; more_like_this serves the reference's page since it was
    ported)."""
    from opensearch_tpu.rest.client import ApiError as RefApiError
    from opensearch_tpu_torch import ApiError
    ref, port = clients
    body = {"query": {"bogus": {}}}
    with pytest.raises(RefApiError) as rerr:
        ref.search("t", body)
    with pytest.raises(ApiError) as perr:
        port.search("t", body)
    assert (perr.value.status, perr.value.err_type, str(perr.value)) == (
        rerr.value.status, rerr.value.err_type, str(rerr.value)) == (
        400, "parsing_exception", "unknown query [bogus]")
    lines = [{}, body, {}, {"query": {"match": {"body": "the"}}}]
    got = port.msearch(lines, index="t")["responses"]
    want = ref.msearch(lines, index="t")["responses"]
    assert got[0] == want[0] == {"error": {
        "type": "ApiError", "reason": "unknown query [bogus]"}}
    assert_same_response(got[1], want[1])
    mlt = {"query": {"more_like_this": {"fields": ["body"], "like": "the",
                                         "min_term_freq": 1}}}
    assert_same_response(port.search("t", mlt), ref.search("t", mlt))
    with pytest.raises(NotPortedError, match=r"query \[span_or\]"):
        port.search("t", {"query": {"span_or": {"clauses": [
            {"span_term": {"body": "the"}}]}}})


@pytest.mark.parametrize("call", ["search", "msearch", "get", "index",
                                  "create", "refresh", "flush", "delete",
                                  "forcemerge", "exists", "mget"])
def test_index_errors_match_the_reference(call):
    """A missing index raises IndexNotFoundError and an existing one
    ResourceAlreadyExistsError where the reference's client raises them
    (its classes' names and messages; the port's own copies); msearch
    gives the reference's per-body entry; index creates the index."""
    from opensearch_tpu.cluster import state as ref_state
    from opensearch_tpu_torch import errors
    calls = {
        "search": lambda c: c.search("nope", {}),
        "msearch": lambda c: c.msearch([{}, {}, {"index": "nope"},
                                        {"query": {"match_all": {}}}],
                                       index="nope"),
        "get": lambda c: c.get("nope", "1"),
        "index": lambda c: c.index("new", {"body": "x"}, id="1")["result"],
        "create": lambda c: c.indices.create("t"),
        "refresh": lambda c: c.indices.refresh("nope"),
        "flush": lambda c: c.indices.flush("nope"),
        "delete": lambda c: c.delete("nope", "1"),
        "forcemerge": lambda c: c.indices.forcemerge("nope"),
        "exists": lambda c: c.exists("nope", "1"),
        "mget": lambda c: c.mget({"docs": [{"_index": "nope", "_id": "1"}]}),
    }

    def run(c):
        c.index("t", {"body": "hello"}, id="1", refresh=True)
        try:
            return ("ok", calls[call](c))
        except (ref_state.ClusterStateError, errors.ClusterStateError) as e:
            return (type(e).__name__, str(e))
    got = run(RestClient(device="cpu"))
    assert got == run(RefClient())
    if call == "msearch":
        assert got[1]["responses"] == 2 * [{"error": {
            "type": "IndexNotFoundError", "reason": "no such index [nope]"}}]
    elif call == "create":
        assert got == ("ResourceAlreadyExistsError",
                       "index [t] already exists")
    elif call not in ("index", "exists", "mget"):
        assert got == ("IndexNotFoundError", "no such index [nope]")


@pytest.mark.parametrize("size,frm", [(-1, 0), (-3, 0), (-1, 2), (2, -1)])
def test_negative_size_and_from_serve_the_reference_page(clients, size, frm):
    """A negative size or from is no 400: both packages cut their
    windows and pages with the negative bound (size -1 drops the last of
    the shard's candidates), and the pages are equal."""
    ref, port = clients
    for q in ({"match": {"body": "the"}}, {"match_all": {}}):
        body = {"query": q, "size": size, "from": frm}
        assert_same_response(port.search("t", body), ref.search("t", body))
    lines = [{}, {"query": {"match": {"body": "the"}}, "size": size,
                  "from": frm}]
    (got,) = port.msearch(lines, index="t")["responses"]
    (want,) = ref.msearch(lines, index="t")["responses"]
    assert_same_response(got, want)
    assert len(got["hits"]["hits"]) == len(want["hits"]["hits"])
