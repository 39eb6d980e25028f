"""The fetch options in the port (opensearch_tpu_torch/search/executor.py
`fetch_one`, search/highlight.py): `_source` filtering, `docvalue_fields`,
`fields`, `stored_fields` and `highlight` (plain, unified, fvh), against
the JAX package on the CPU, through both RestClients over the same bulk
in two segments; and the rung such a body rides: a `_score`-sorted body
with fetch options stays on the fused kernels."""

import jax
import numpy as np
import pytest

from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu.search import highlight as RH
from opensearch_tpu_torch import RestClient
from opensearch_tpu_torch.analysis import AnalysisRegistry
from opensearch_tpu_torch.search import compiler as C
from opensearch_tpu_torch.search import fastpath, impactpath
from opensearch_tpu_torch.search import highlight as H
from tests.test_torch_sort import assert_same

jax.config.update("jax_platforms", "cpu")

NDOCS = 400
MAPPING = {"properties": {"title": {"type": "text"},
                          "body": {"type": "text"},
                          "tags": {"type": "keyword"},
                          "price": {"type": "integer"},
                          "rating": {"type": "double"},
                          "meta": {"properties": {
                              "lang": {"type": "keyword"},
                              "views": {"type": "long"}}}}}
WORDS = [f"w{i}" for i in range(30)]


def make_bulk(seed: int = 31):
    """Docs with a short title, a body of several sentences, multi-valued
    tags, numbers (some missing) and a nested object."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 31) ** 0.8
    p /= p.sum()
    bulk = []
    for i in range(NDOCS):
        def sent(n):
            return " ".join(rng.choice(WORDS, n, p=p)).capitalize() + "."
        doc = {"title": " ".join(rng.choice(WORDS, 4, p=p)),
               "body": " ".join(sent(int(rng.integers(4, 18)))
                                for _ in range(int(rng.integers(1, 6)))),
               "tags": sorted({f"t{int(x)}" for x in rng.integers(0, 6, 2)}),
               "meta": {"lang": "en" if i % 3 else "de",
                        "views": int(rng.integers(0, 10**6))}}
        if i % 5:
            doc["price"] = int(rng.integers(0, 100))
        if i % 7:
            doc["rating"] = round(float(rng.random() * 5), 2)
        bulk += [{"index": {"_index": "t", "_id": f"d{i}"}}, doc]
    return bulk


def fill(client, bulk):
    client.indices.create("t", {"mappings": MAPPING})
    half = (len(bulk) // 4) * 2
    client.bulk(bulk[:half], refresh=True)
    client.bulk(bulk[half:], refresh=True)
    return client


@pytest.fixture(scope="module")
def bulk():
    return make_bulk()


@pytest.fixture(scope="module")
def clients(bulk):
    return fill(RefClient(), bulk), fill(RestClient(device="cpu"), bulk)


Q = {"match": {"body": "w2 w5"}}
FETCH_BODIES = {
    "source_false": {"query": Q, "_source": False},
    "source_string": {"query": Q, "_source": "meta"},
    "source_list": {"query": Q, "_source": ["title", "meta.lang"]},
    "source_glob": {"query": Q, "_source": ["t*"]},
    "source_includes_excludes": {"query": Q, "_source": {
        "includes": ["meta", "price"], "excludes": ["meta.views"]}},
    "source_excludes": {"query": Q, "_source": {"excludes": ["body"]}},
    "docvalue_fields": {"query": Q, "docvalue_fields": [
        "price", "tags", "rating", "meta.views", {"field": "meta.lang"},
        "nope"], "_source": False},
    "fields": {"query": Q, "fields": ["title", "meta.lang", {"field":
                                                            "rating"},
                                      "nope"]},
    "stored_fields": {"query": Q, "stored_fields": ["title"]},
    "stored_fields_none": {"query": Q, "stored_fields": "_none_"},
    "stored_fields_source": {"query": Q, "stored_fields": ["title"],
                             "_source": ["price"]},
    "all_fetch_sorted": {"query": Q, "sort": [{"price": "desc"}],
                         "docvalue_fields": ["price", "tags"],
                         "fields": ["title"], "_source": {"excludes":
                                                          ["body"]}},
    "hl_plain": {"query": Q, "highlight": {"fields": {"body": {}}}},
    "hl_unified": {"query": Q, "highlight": {"type": "unified",
                                             "fields": {"body": {}}}},
    "hl_fvh": {"query": Q, "highlight": {"fields": {"body": {
        "type": "fvh"}}}},
    "hl_tags_sizes": {"query": Q, "highlight": {
        "pre_tags": ["<b>"], "post_tags": ["</b>"], "fragment_size": 30,
        "number_of_fragments": 2, "fields": {"body": {}, "title": {
            "number_of_fragments": 0}}}},
    "hl_unified_small": {"query": Q, "highlight": {"fields": {"body": {
        "type": "unified", "fragment_size": 20,
        "number_of_fragments": 3}}}},
    "hl_bool_two_fields": {"query": {"bool": {
        "must": [{"match": {"title": "w1"}}],
        "should": [{"match": {"body": "w3"}}],
        "filter": [{"term": {"tags": "t2"}}]}},
        "highlight": {"fields": {"title": {}, "body": {}, "tags": {},
                                 "nope": {}}}},
    "hl_phrase": {"query": {"match_phrase": {"body": "w0 w1"}},
                  "highlight": {"fields": {"body": {}}}},
    "hl_phrase_prefix": {"query": {"match_phrase_prefix": {
        "body": "w0 w1"}}, "highlight": {"fields": {"body": {
            "type": "unified"}}}},
    "hl_prefix_one_term": {"query": {"match_phrase_prefix": {
        "title": "w1"}}, "highlight": {"fields": {"title": {}}}},
    "hl_constant_score": {"query": {"constant_score": {
        "filter": {"match": {"title": "w4"}}}},
        "highlight": {"fields": {"title": {"type": "fvh"}}}},
    "hl_sorted_collapsed": {"query": Q, "sort": [{"rating": "asc"}],
                            "collapse": {"field": "tags"},
                            "highlight": {"fields": {"body": {}}},
                            "_source": ["title"]},
}


@pytest.mark.parametrize("name", sorted(FETCH_BODIES))
def test_fetch_bodies_match_reference(clients, name):
    ref, port = clients
    body = FETCH_BODIES[name]
    want = ref.search("t", body)
    assert want["hits"]["hits"], name
    assert_same(port.search("t", body), want)


TEXTS = ["The quick w1 fox. Jumps w2 over w1! And then? w3 w1 w2 ends",
         "w10 w11 w12 w1 " * 20, "", "no match here", "w1"]


@pytest.mark.parametrize("kind", ["plain", "unified"])
@pytest.mark.parametrize("terms", [{"w1"}, {"w1", "w2", "w11*"}, {"w1*"},
                                   {"*"}])
def test_highlighters_match_reference(kind, terms):
    an = AnalysisRegistry().get("standard")
    from opensearch_tpu.analysis import AnalysisRegistry as RefRegistry
    ran = RefRegistry().get("standard")
    got_fn = H.highlight_field if kind == "plain" else H.highlight_unified
    want_fn = RH.highlight_field if kind == "plain" else \
        RH.highlight_unified
    for text in TEXTS:
        for fs, nf in ((100, 5), (10, 2), (25, 0)):
            assert got_fn(text, terms, an, "<em>", "</em>", fs, nf) == \
                want_fn(text, terms, ran, "<em>", "</em>", fs, nf), \
                (text, fs, nf)


def test_collect_query_terms_matches_reference(clients):
    ref, port = clients
    from opensearch_tpu.search import compiler as RC
    from opensearch_tpu.search import query_dsl as rdsl
    from opensearch_tpu_torch.search import query_dsl as dsl
    reng = ref.node.indices["t"].shards[0]
    rctx = RC.ShardContext(reng.mappings, reng.segments)
    pctx = port._indices["t"].searcher.context()
    for name in sorted(FETCH_BODIES):
        q = FETCH_BODIES[name]["query"]
        want = RH.collect_query_terms(RC.rewrite(rdsl.parse_query(q), rctx))
        got = H.collect_query_terms(C.rewrite(dsl.parse_query(q), pctx))
        assert got == want, name


def test_score_sorted_fetch_bodies_stay_on_the_kernels(bulk):
    """A `_score`-sorted body with `_source` filtering, docvalue_fields
    and highlight rides the fused kernels (the shard-view launch over
    both segments) and no other rung; a field sort leaves them."""
    port = fill(RestClient(device="cpu"), bulk)
    for body, kernels in (
            ({"query": Q, "sort": ["_score"], "_source": ["title"],
              "docvalue_fields": ["price"],
              "highlight": {"fields": {"body": {}}}}, True),
            ({"query": Q, "highlight": {"fields": {"body": {}}},
              "track_total_hits": True}, True),
            ({"query": Q, "sort": [{"price": "asc"}],
              "highlight": {"fields": {"body": {}}}}, False)):
        before = (dict(fastpath.STATS), impactpath.STATS["served"],
                  C.STATS["general_served"])
        resp = port.search("t", body)
        served = sum(fastpath.STATS[k] - before[0][k] for k in
                     ("pure_served", "bool_served", "shard_view_served"))
        assert (served >= 1) == kernels, body
        assert impactpath.STATS["served"] == before[1], body
        assert (C.STATS["general_served"] > before[2]) == (not kernels)
        assert all("highlight" in h for h in resp["hits"]["hits"])


def test_store_mapping_still_raises():
    """A `store` mapping keeps the field's raw values beside `_source`
    (`stored_fields` returns them); a field parameter the port does not
    serve still raises."""
    from opensearch_tpu_torch.errors import NotPortedError
    c = RestClient(device="cpu")
    c.indices.create("x", {"mappings": {
        "properties": {"t": {"type": "text", "store": True}}}})
    c.index("x", {"t": "a b"}, id="1", refresh=True)
    hit = c.search("x", {"stored_fields": ["t"]})["hits"]["hits"][0]
    assert hit["fields"] == {"t": ["a b"]} and "_source" not in hit
    with pytest.raises(NotPortedError, match="term_vector"):
        RestClient(device="cpu").indices.create("y", {"mappings": {
            "properties": {"t": {"type": "text",
                                 "term_vector": "with_positions"}}}})
