"""Compound and multi-field queries of the port (multi_match of every
type, dis_max, boosting, combined_fields, terms_set, pinned, wrapper) and
named queries with `matched_queries`, against the JAX package on the CPU.

- End to end: the same seeded bulk in two segments, the first with
  deletes, on codec v1 and v2, through both packages' RestClient
  (`search` and `msearch`): responses equal apart from `took`, ids,
  order and `matched_queries` identical, scores within 1e-6 relative
  (the reference's XLA program may contract `best + tie (total - best)`,
  `tfc + w gather` and `k1 (1 - b + b dl / avgdl)` into FMAs; the port
  multiplies, then adds). The bodies are chosen so that no two
  neighbouring distinct scores of a page lie within 1e-6 of each other,
  which `same` checks, so the order cannot turn on that last ulp.
- Each kind also as a bool filter, a must_not and under constant_score
  (the filter masks of `search/filters.py`).
- Routes by `STATS` against the reference's fastpath (forced on, the
  port's plain kernels in its kernels' place): a single-field
  most_fields and a compound filter clause ride B3, a wrapper its inner
  match's route, a named body the general path, also inside an msearch.
- The bytes the port counts for the reference's filter hash cap equal the
  reference's prepared parameters, and decide the cap as its
  `_filter_cache_key` does.
- Kept reference behaviours: cross_fields and bool_prefix serve
  most_fields' page, pinned ids score 1e6 - rank, the highlighter walks
  no combined_fields, terms_set or pinned; a terms lookup raises
  NotPortedError, as does a REST call of the reference's client that the
  port lacks; a terms_set script serves the reference's page.
"""

import base64
import json

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from opensearch_tpu.ops import scoring as rops
from opensearch_tpu.rest.client import IndicesClient as RefIndicesClient
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu.search import compiler as RC
from opensearch_tpu.search import fastpath as rfp
from opensearch_tpu.search import query_dsl as rdsl
from opensearch_tpu_torch import RestClient
from opensearch_tpu_torch.errors import NotPortedError
from opensearch_tpu_torch.ops import scoring as ops
from opensearch_tpu_torch.rest import client as pclient
from opensearch_tpu_torch.search import compiler as C
from opensearch_tpu_torch.search import fastpath, impactpath
from opensearch_tpu_torch.search import query_dsl as dsl
from tests.test_torch_bool import (ROUTES, _plain_bool, _route_counts,
                                   reference_fastpath)  # noqa: F401
from tests.test_torch_ladder import _plain_impact, _plain_tfdl

jax.config.update("jax_platforms", "cpu")

RTOL = 1e-6
CPU = torch.device("cpu")
NDOCS = 64
TITLE = ["quick", "brown", "fox", "lazy", "dog", "red", "apple", "river",
         "stone", "moon"]
BODY = TITLE + ["the", "jumps", "over", "sleeps", "runs", "under", "tree",
                "house", "green", "hill"]
STATUS = ["draft", "published", "archived"]
MAPPING = {"settings": {"number_of_replicas": 0}, "mappings": {"properties": {
    "title": {"type": "text"}, "body": {"type": "text"},
    "status": {"type": "keyword"}, "price": {"type": "integer"},
    "rating": {"type": "integer"}}}}
DELETED = ("d0", "d5", "d10", "d15", "d20", "d25")


def make_docs():
    """NDOCS docs (numpy seed 41): Zipf-ish titles and bodies, a status,
    a price 0..99 and a rating 1..4, missing on every seventh doc."""
    rng = np.random.default_rng(41)

    def words(pool, lo, hi):
        p = 1.0 / np.arange(1, len(pool) + 1) ** 0.8
        return " ".join(rng.choice(pool, int(rng.integers(lo, hi)),
                                   p=p / p.sum()))
    docs = []
    for i in range(NDOCS):
        doc = {"title": words(TITLE, 2, 6), "body": words(BODY, 4, 15),
               "status": STATUS[int(rng.integers(3))],
               "price": int(rng.integers(100))}
        if i % 7:
            doc["rating"] = int(rng.integers(1, 5))
        docs.append(doc)
    return docs


def fill(c, docs):
    """Two segments of 32 docs; the first loses DELETED after its
    refresh."""
    c.indices.create("t", MAPPING)
    for lo in (0, NDOCS // 2):
        c.bulk(sum([[{"index": {"_index": "t", "_id": f"d{i}"}}, docs[i]]
                    for i in range(lo, lo + NDOCS // 2)], []), refresh=True)
    c.bulk([{"delete": {"_index": "t", "_id": d}} for d in DELETED],
           refresh=True)
    return c


@pytest.fixture(scope="module")
def docs():
    return make_docs()


@pytest.fixture(scope="module", params=["1", "2"], ids=["v1", "v2"])
def clients(request, docs):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENSEARCH_TPU_CODEC", request.param)
        ref, port = fill(RefClient(), docs), fill(RestClient(device="cpu"),
                                                 docs)
    segs = port._indices["t"].engine.segments
    assert len(segs) == 2 and segs[0].live_count == NDOCS // 2 - 6
    assert {s.codec_version for s in segs} == {int(request.param)}
    return ref, port


def mm(query, fields, **kw):
    return {"multi_match": dict(query=query, fields=fields, **kw)}


def wrap(q):
    return {"wrapper": {"query": base64.b64encode(
        json.dumps(q).encode()).decode()}}


MATCH = {"match": {"body": "fox dog"}}
PIN_IDS = ["d40", "d5", "zz", "d3", "d40", "d61", "d12", "d33", "d7", "d2"]
# (name, query)
QUERIES = [
    ("mm best", mm("quick fox", ["title^2", "body"], tie_breaker=0.3)),
    ("mm best and", mm("brown dog", ["title", "body"], operator="and",
                       boost=1.5)),
    ("mm most", mm("quick fox", ["title", "body^1.5"], type="most_fields")),
    ("mm most msm", mm("red apple moon", ["title", "body"],
                       type="most_fields", minimum_should_match="2")),
    ("mm cross", mm("quick fox", ["title", "body^1.5"], type="cross_fields")),
    ("mm phrase", mm("quick brown", ["title", "body"], type="phrase")),
    ("mm phrase prefix", mm("lazy do", ["title^3", "body"],
                            type="phrase_prefix")),
    ("mm bool prefix", mm("river sto", ["title", "body"],
                          type="bool_prefix")),
    ("mm one field", mm("stone moon", ["body"], type="most_fields")),
    ("mm nothing", mm("!!", ["title", "body"])),
    ("dis_max", {"dis_max": {"queries": [
        {"term": {"title": "fox"}}, {"match": {"body": "lazy tree"}}],
        "tie_breaker": 0.7, "boost": 2.0}}),
    ("dis_max phrase", {"dis_max": {"queries": [
        {"match_phrase": {"body": "the fox"}},
        {"prefix": {"title": "ap"}}]}}),
    ("boosting", {"boosting": {"positive": {"match": {"body": "fox tree"}},
                               "negative": {"term": {"status": "draft"}},
                               "negative_boost": 0.2}}),
    ("boosting range", {"boosting": {
        "positive": mm("red river", ["title", "body"]),
        "negative": {"range": {"price": {"lt": 40}}},
        "negative_boost": 0.5, "boost": 3.0}}),
    ("combined", {"combined_fields": {"query": "fox river",
                                      "fields": ["body", "title^2"]}}),
    ("combined and", {"combined_fields": {
        "query": "lazy dog", "fields": ["title", "body"], "operator": "and",
        "boost": 2.0}}),
    ("combined msm", {"combined_fields": {
        "query": "green hill stone moon", "fields": ["body^0.5", "title"],
        "minimum_should_match": "50%"}}),
    ("terms_set", {"terms_set": {"body": {
        "terms": ["the", "fox", "dog", "over"],
        "minimum_should_match_field": "rating"}}}),
    ("terms_set unmapped field", {"terms_set": {"body": {
        "terms": ["the", "fox"], "minimum_should_match_field": "nope"}}}),
    ("pinned", {"pinned": {"ids": PIN_IDS,
                           "organic": {"match": {"body": "river hill"}}}}),
    ("pinned boost", {"pinned": {"ids": ["d9", "d44"], "boost": 0.5,
                                 "organic": mm("quick", ["title", "body"])}}),
    ("pinned alone", {"pinned": {"ids": ["d61", "d0", "d30"]}}),
    ("wrapper", wrap({"match": {"body": "house hill"}})),
    ("wrapper bool", wrap({"bool": {"must": [MATCH], "filter": [
        {"term": {"status": "published"}}]}})),
    ("named", {"bool": {"should": [
        {"match": {"title": {"query": "fox", "_name": "t_fox"}}},
        {"match": {"body": {"query": "dog", "_name": "b_dog"}}}],
        "filter": [{"range": {"price": {"gte": 20, "_name": "price"}}}],
        "minimum_should_match": 1}}),
    ("named nested", {"dis_max": {"_name": "any", "queries": [
        {"term": {"title": {"value": "moon", "_name": "moon"}}},
        {"bool": {"_name": "apple_bool", "must": [
            {"match": {"body": "apple"}}],
            "must_not": [{"term": {"status": {"value": "draft",
                                              "_name": "no_draft"}}}]}},
        {"match": {"body": {"query": "!!", "_name": "nothing"}}}]}}),
    ("named compound", {"bool": {"should": [
        {"multi_match": {"query": "red stone", "fields": ["title", "body"],
                         "_name": "mm"}},
        {"boosting": {"positive": {"match": {"body": "tree"}},
                      "negative": {"term": {"status": "archived"}},
                      "_name": "boost"}},
        {"terms_set": {"body": {"terms": ["the", "over"],
                                "minimum_should_match_field": "rating",
                                "_name": "ts"}}},
        {"pinned": {"ids": ["d1"], "_name": "pin",
                    "organic": {"term": {"title": {
                        "value": "lazy", "_name": "hidden"}}}}}]}}),
]
# each kind in filter context: (name, query)
FILTERS = [
    ("filter dis_max", {"bool": {"must": [MATCH], "filter": [{"dis_max": {
        "queries": [{"term": {"status": "draft"}},
                    {"range": {"price": {"gte": 80}}}]}}]}}),
    ("filter mm", {"bool": {"must": [MATCH], "filter": [
        mm("quick red", ["title", "body"], type="most_fields")]}}),
    ("filter mm best", {"bool": {"must": [MATCH], "filter": [
        mm("brown", ["title", "body"])]}}),
    ("filter boosting", {"bool": {"must": [MATCH], "filter": [
        {"boosting": {"positive": {"term": {"title": "lazy"}},
                      "negative": {"term": {"status": "draft"}}}}]}}),
    ("filter terms_set", {"bool": {"must": [MATCH], "filter": [
        {"terms_set": {"body": {"terms": ["the", "over", "tree"],
                                "minimum_should_match_field": "rating"}}}]}}),
    ("filter pinned", {"bool": {"must": [MATCH], "filter": [
        {"pinned": {"ids": ["d40", "d2", "d5"],
                    "organic": {"term": {"status": "published"}}}}]}}),
    ("filter combined", {"bool": {"must": [MATCH], "filter": [
        {"combined_fields": {"query": "apple river",
                             "fields": ["title", "body"]}}]}}),
    ("filter wrapper", {"bool": {"must": [MATCH], "filter": [
        wrap({"term": {"status": "published"}})]}}),
    ("must_not boosting", {"bool": {"must": [MATCH], "must_not": [
        {"boosting": {"positive": {"match": {"title": "quick"}},
                      "negative": {"match_all": {}}}}]}}),
    ("constant_score dis_max", {"constant_score": {"boost": 2.5,
                                                   "filter": {"dis_max": {
        "queries": [{"match": {"title": "moon"}},
                    {"match": {"body": "moon"}}]}}}}),
    ("filter named", {"bool": {"must": [MATCH], "filter": [
        {"combined_fields": {"query": "stone", "fields": ["title", "body"],
                             "_name": "cf"}}]}}),
]
Q = dict(QUERIES + FILTERS)
BODIES = [(n, {"query": q}) for n, q in QUERIES + FILTERS] + [
    ("named sorted", {"query": Q["named"], "sort": [{"price": "desc"}],
                      "size": 6}),
    ("named collapse", {"query": Q["named"],
                        "collapse": {"field": "status"}}),
    ("named size 20", {"query": Q["named nested"], "size": 20}),
    ("highlight", {"query": {"bool": {"should": [
        Q["mm best"], Q["boosting"], Q["combined"], Q["terms_set"]]}},
        "highlight": {"fields": {"title": {}, "body": {}}}}),
]


def same(got, want, path="") -> None:
    """Responses equal apart from `took`, scores within RTOL; in each
    hits list, neighbouring distinct scores differ by more than RTOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        if isinstance(want.get("hits"), list):
            sc = [h["_score"] for h in want["hits"]
                  if h.get("_score") is not None]
            for a, b in zip(sc, sc[1:]):
                assert a == b or abs(a - b) >= RTOL * abs(a), (path, a, b)
        for k in want:
            if k == "took":
                continue
            if k in ("_score", "max_score") and want[k] is not None:
                assert got[k] is not None, path
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                           err_msg=path + k)
            else:
                same(got[k], want[k], f"{path}{k}.")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}{i}.")
    else:
        assert got == want, path


@pytest.mark.parametrize("name,body", BODIES, ids=[b[0] for b in BODIES])
def test_search_matches_reference(clients, name, body):
    ref, port = clients
    same(port.search("t", body), ref.search("t", body), name + ": ")


def test_msearch_matches_reference(clients):
    ref, port = clients
    lines = sum([[{}, b] for _n, b in BODIES], [])
    got = port.msearch(lines, index="t")["responses"]
    want = ref.msearch(lines, index="t")["responses"]
    for (name, _b), g, w in zip(BODIES, got, want):
        same(g, w, name + ": ")


def test_pages_are_not_empty(clients):
    """The bodies reach docs: every page but the two that match nothing
    has hits, and the named ones carry matched_queries."""
    _ref, port = clients
    for name, body in BODIES:
        hits = port.search("t", body)["hits"]["hits"]
        assert bool(hits) == (name not in ("mm nothing",
                                           "terms_set unmapped field")), name
        if name.startswith("named") or name == "filter named":
            assert all(h.get("matched_queries") for h in hits), name


def test_matched_queries(clients):
    """The names of the clauses a hit matches, sorted (the reference's
    jitted program returns them as a dict, whose keys JAX sorts), only
    where some clause matched; a pinned query's organic clause is not
    walked, a clause that analyzes to nothing never matches."""
    _ref, port = clients
    resp = port.search("t", {"query": Q["named nested"], "size": 50})
    seen = set()
    for h in resp["hits"]["hits"]:
        names = h["matched_queries"]
        assert names == sorted(names) and "any" in names
        assert "nothing" not in names
        seen.update(names)
    assert {"moon", "apple_bool", "no_draft"} <= seen
    resp = port.search("t", {"query": Q["named compound"], "size": 50})
    seen = set()
    for h in resp["hits"]["hits"]:
        seen.update(h.get("matched_queries", ()))
    assert seen == {"mm", "boost", "ts", "pin"}
    plain = port.search("t", {"query": MATCH})["hits"]["hits"]
    assert plain and all("matched_queries" not in h for h in plain)


# ---------------------------------------------------------------------
# kept reference behaviours and what raises
# ---------------------------------------------------------------------

def test_reference_behaviours_kept(clients):
    """As measured: cross_fields and bool_prefix serve most_fields' page
    (bool_prefix does not expand its last term), pinned ids score
    1e6 - rank in list order (absent, deleted and repeated ids drop
    out), and the highlighter marks the terms of a multi_match, a
    dis_max and a boosting's positive side, not those of a
    combined_fields, terms_set or pinned query."""
    ref, port = clients
    for c in (ref, port):
        def page(q, **kw):
            return chip_smoke.strip_took(c.search("t", dict(query=q, **kw)))
        most = page(mm("quick fox", ["title", "body^1.5"],
                       type="most_fields"))
        assert page(mm("quick fox", ["title", "body^1.5"],
                       type="cross_fields")) == most
        assert page(mm("river sto", ["title", "body"], type="bool_prefix")) \
            == page(mm("river sto", ["title", "body"], type="most_fields"))
        hits = page(Q["pinned alone"])["hits"]["hits"]
        assert [(h["_id"], h["_score"]) for h in hits] == [
            ("d61", 1e6), ("d30", 999998.0)]
        hits = page(Q["pinned"], size=20)["hits"]["hits"]
        pins = [(h["_id"], h["_score"]) for h in hits if h["_score"] >= 1e5]
        assert pins == [("d40", 1e6), ("d3", 999997.0), ("d61", 999995.0),
                        ("d12", 999994.0), ("d33", 999993.0),
                        ("d7", 999992.0), ("d2", 999991.0)]
        for q, marked in ((Q["mm best"], True), (Q["boosting"], True),
                          (Q["combined"], False), (Q["terms_set"], False),
                          (Q["pinned alone"], False)):
            hits = page(q, highlight={"fields": {"title": {}, "body": {}}}
                        )["hits"]["hits"]
            assert hits and any("highlight" in h for h in hits) == marked, q


@pytest.mark.parametrize("query,what", [
    ({"terms_set": {"body": {"terms": ["fox"],
                             "minimum_should_match_script": {
                                 "source": "params.num_terms"}}}},
     "terms_set [minimum_should_match_script]"),
    ({"terms": {"status": {"index": "t", "id": "d1", "path": "status"}}},
     "terms lookup"),
], ids=["terms_set script", "terms lookup"])
def test_unported_forms_raise(clients, query, what):
    """The reference serves a terms lookup as a terms query over the
    lookup object's keys (no hit), where OpenSearch fetches the terms:
    the port raises rather than serve that page. A terms_set with a
    minimum_should_match_script serves the reference's page."""
    ref, port = clients
    want = ref.search("t", {"query": query})
    if "script" in what:
        same(port.search("t", {"query": query}), want, what + ": ")
        return
    with pytest.raises(NotPortedError, match=what.replace("[", r"\[")
                       .replace("]", r"\]")):
        port.search("t", {"query": query})


def test_rest_calls_of_the_reference_client_raise_not_ported():
    """The port's list of the reference client's calls is dir() of its
    classes; a listed call the port lacks raises NotPortedError naming
    it, an unknown name AttributeError."""
    def public(cls):
        return tuple(n for n in dir(cls) if not n.startswith("_"))
    assert pclient.REFERENCE_CALLS == public(RefClient)
    assert pclient.REFERENCE_INDICES_CALLS == public(RefIndicesClient)
    c = RestClient(device="cpu")
    for name in ("rank_eval", "reindex", "update_by_query", "rollover"):
        with pytest.raises(NotPortedError, match=rf"rest call \[{name}\]"):
            getattr(c, name)
    for name in ("create_data_stream", "get_data_stream",
                 "delete_data_stream"):
        with pytest.raises(NotPortedError,
                           match=rf"rest call \[indices.{name}\]"):
            getattr(c.indices, name)
    # the reference's other namespaces (ROADMAP Queue 3, closed in the
    # slice of nested objects and joins)
    for name in ("cat", "cluster", "ingest", "snapshot"):
        assert hasattr(RefClient(), name)
        with pytest.raises(NotPortedError, match=rf"rest call \[{name}\]"):
            getattr(c, name)
    with pytest.raises(AttributeError):
        c.no_such_call
    with pytest.raises(AttributeError):
        c.indices.no_such_call
    assert not hasattr(c, "no_such_call")
    assert c.indices.analyze(body={"text": "Hi"})["tokens"][0]["token"] \
        == "hi"
    for name in ("search", "msearch", "bulk", "index", "get", "count",
                 "explain", "field_caps", "scroll", "create_pit", "create",
                 "termvectors", "mtermvectors"):
        assert callable(getattr(c, name))
    for name in ("get_mapping", "get", "delete", "put_mapping",
                 "get_settings", "put_settings", "close", "open", "shrink",
                 "split", "clone", "stats", "get_alias", "update_aliases",
                 "put_alias", "put_index_template", "put_template",
                 "delete_index_template", "exists_index_template"):
        assert callable(getattr(c.indices, name))


# ---------------------------------------------------------------------
# ops, param bytes and routes
# ---------------------------------------------------------------------

def test_gather_tf_dense_matches_reference(clients):
    """`ops.gather_tf_dense` over both postings sources equals the
    reference's jnp one on the same rows (absent terms, a repeated term,
    a pow2 pad)."""
    ref, port = clients
    rseg = ref.node.indices["t"].shards[0].segments[1]
    rseg.ensure_device_tfs("body")
    pseg = port._indices["t"].engine.segments[1]
    pb = pseg.postings["body"]
    rows = [pb.row("fox"), -1, pb.row("the"), pb.row("fox"), pb.row("hill"),
            -1, -1, -1]
    assert pb.row("fox") >= 0 and pb.row("hill") >= 0
    total = sum(int(pb.starts[r + 1] - pb.starts[r]) for r in rows if r >= 0)
    want = np.asarray(rops.gather_tf_dense(
        rseg.device_arrays()["postings"]["body"],
        jax.numpy.asarray(np.asarray(rows, np.int32)),
        rops.pick_bucket(total), rseg.ndocs_pad, 8))[:, :pseg.ndocs]
    csr = ops.FieldPostings(pb.starts[:-1], np.diff(pb.starts),
                            pb.starts[:-1], torch.from_numpy(pb.doc_ids),
                            d_tfs=torch.from_numpy(pb.tfs),
                            d_dl=pseg.doc_lens_on("body", CPU))
    for post in (C.field_postings(pseg, "body", CPU), csr):
        got = ops.gather_tf_dense(post, rows, pseg.ndocs, 8)
        np.testing.assert_array_equal(got.numpy(), want)


PARAM_QUERIES = [
    {"dis_max": {"queries": [{"prefix": {"body": "h"}},
                             {"match_phrase": {"body": "the fox"}}]}},
    {"boosting": {"positive": {"prefix": {"title": "r"}},
                  "negative": {"wildcard": {"body": "*o*"}}}},
    {"terms_set": {"body": {"terms": ["the", "fox", "dog"],
                            "minimum_should_match_field": "rating"}}},
    {"pinned": {"ids": PIN_IDS}},
    {"pinned": {"ids": ["d1", "d40"],
                "organic": {"prefix": {"body": "t"}}}},
    {"combined_fields": {"query": "fox river stone",
                         "fields": ["body", "title^2", "status"]}},
]


@pytest.mark.parametrize("query", PARAM_QUERIES,
                         ids=["dis_max", "boosting", "terms_set", "pinned",
                              "pinned organic", "combined"])
def test_param_bytes_decide_the_hash_cap_as_the_reference(
        monkeypatch, clients, query):
    """The bytes the port counts for a compound filter clause are the
    bytes of the reference's prepared parameters, so with the cap at one
    byte less the reference's `_filter_cache_key` gives None and the
    port's filter list declines, and at the count both keep it."""
    ref, port = clients
    shard = ref.node.indices["t"].shards[0]
    rctx = RC.ShardContext(shard.mappings, shard.segments)
    pctx = port._indices["t"].searcher.context()
    pnode = C.rewrite(dsl.parse_query(query), pctx, False)
    rnode = RC.rewrite(rdsl.parse_query(query), rctx, False)
    for pseg, rseg in zip(pctx.segments, rctx.segments):
        local: dict = {}
        spec = RC.prepare(rnode, rseg, rctx, local)
        got = C.reference_param_bytes(pnode, pseg)
        assert got == sum(np.asarray(v).nbytes for v in local.values())
        for cap, kept in ((got - 1, False), (got, True)):
            monkeypatch.setattr(RC, "_FILTER_HASH_BYTE_CAP", cap)
            monkeypatch.setattr(C, "FILTER_HASH_BYTE_CAP", cap)
            assert (RC._filter_cache_key(spec, local, rseg)[0]
                    is not None) == kept
            assert (fastpath._filter_list(pseg, pctx, [(pnode, False)], CPU)
                    is not None) == kept


def test_terms_set_count_passes_the_cap_above_131072_docs():
    """A terms_set ships an f32 minimum per padded doc: at 262,144 padded
    docs that is the 1 MiB cap itself, and its term group tips it over."""
    node = C.LTermsSet(child=C.LTerms(terms=["a", "b"]))

    class Seg:
        ndocs_pad = 1 << 18
    assert C.reference_param_bytes(node, Seg) == (1 << 20) + 36
    Seg.ndocs_pad = 1 << 17
    assert C.reference_param_bytes(node, Seg) < C.FILTER_HASH_BYTE_CAP


KERNEL_STATS = ("pure_served", "bool_served", "shard_view_served")
ROUTE_BODIES = [
    ("mm one field", {"query": Q["mm one field"]}, "bool"),
    ("mm two fields", {"query": Q["mm most"]}, None),
    ("filter dis_max", {"query": Q["filter dis_max"]}, "bool"),
    ("filter mm", {"query": Q["filter mm"]}, "bool"),
    ("filter terms_set", {"query": Q["filter terms_set"]}, "bool"),
    ("filter pinned", {"query": Q["filter pinned"]}, "bool"),
    ("filter combined", {"query": Q["filter combined"]}, "bool"),
    ("constant_score dis_max", {"query": Q["constant_score dis_max"]}, "bool"),
    ("wrapper", {"query": Q["wrapper"]}, "pure"),
    ("wrapper bool", {"query": Q["wrapper bool"]}, "bool"),
    ("dis_max", {"query": Q["dis_max"]}, None),
    ("named", {"query": Q["named"]}, None),
    ("filter named", {"query": Q["filter named"]}, None),
    ("named one field", {"query": {"match": {"body": {
        "query": "fox", "_name": "f"}}}}, None),
]


def test_routes_match_the_reference_fastpath(reference_fastpath, docs):
    """Each body rides the fused kernels where the reference's fastpath
    does, over the same B3 route, on the segment without deletes (the
    one with deletes takes the general path, or for a pure term group
    the impact rung); a named body never rides them."""
    ref_routes = reference_fastpath
    ref, port = fill(RefClient(), docs), fill(RestClient(device="cpu"), docs)
    for name, body, kernel in ROUTE_BODIES:
        del ref_routes[:]
        rbefore = {k: rfp.STATS[k] for k in KERNEL_STATS}
        pbefore = dict(fastpath.STATS)
        gbefore = C.STATS["general_served"]
        ibefore = impactpath.STATS["served"]
        same(port.search("t", body), ref.search("t", body), name + ": ")
        rserved = {k: rfp.STATS[k] - rbefore[k] for k in KERNEL_STATS}
        pserved = {k: fastpath.STATS[k] - pbefore[k] for k in KERNEL_STATS}
        assert pserved == rserved, name
        assert {r: fastpath.STATS[r] - pbefore[r] for r in ROUTES} \
            == _route_counts(ref_routes), name
        if kernel is None:
            assert not any(pserved.values()), name
        else:
            assert pserved[f"{kernel}_served"] == 1, name
        # the segment with deletes, or the whole body, on the general
        # path; a pure term group's on the impact rung
        rung = (impactpath.STATS["served"] - ibefore if kernel == "pure"
                else C.STATS["general_served"] - gbefore)
        assert rung > 0, name


def test_named_bodies_leave_the_msearch_batch(reference_fastpath, docs):
    """In an msearch a named body runs as a single search on the general
    path while its neighbours keep the batch's kernels; the responses
    equal the reference's msearch."""
    ref, port = fill(RefClient(), docs), fill(RestClient(device="cpu"), docs)
    for c in (ref, port):
        c.bulk([{"delete": {"_index": "t", "_id": "d1"}}], refresh=True)
        c.indices.forcemerge("t")
    bodies = [{"query": MATCH}, {"query": Q["named"]},
              {"query": Q["mm one field"]}, {"query": Q["filter named"]}]
    lines = sum([[{}, b] for b in bodies], [])
    before = dict(fastpath.STATS)
    gbefore = C.STATS["general_served"]
    got = port.msearch(lines, index="t")["responses"]
    want = ref.msearch(lines, index="t")["responses"]
    for i, (g, w) in enumerate(zip(got, want)):
        same(g, w, f"body {i}: ")
    assert C.STATS["general_served"] - gbefore == 2
    assert sum(fastpath.STATS[k] - before[k] for k in KERNEL_STATS) == 2
    assert all(h.get("matched_queries") for h in got[1]["hits"]["hits"])


def test_terms_set_filter_past_the_cap_is_declined(monkeypatch, docs):
    """With both caps below a terms_set's minimum array, both fast paths
    decline its bool and the general path serves the same page."""
    monkeypatch.setattr(rfp, "_backend_ok", True)
    monkeypatch.setattr(rfp, "fused_bm25_topk_tfdl", _plain_tfdl)
    monkeypatch.setattr(rfp, "fused_bm25_topk_impact", _plain_impact)
    monkeypatch.setattr(rfp, "fused_bm25_bool_topk", _plain_bool)
    ref, port = fill(RefClient(), docs), fill(RestClient(device="cpu"), docs)
    body = {"query": Q["filter terms_set"]}
    for cap, kernels in ((1 << 20, True), (64, False)):
        monkeypatch.setattr(RC, "_FILTER_HASH_BYTE_CAP", cap)
        monkeypatch.setattr(C, "FILTER_HASH_BYTE_CAP", cap)
        rb = rfp.STATS["bool_served"]
        pb = fastpath.STATS["bool_served"]
        same(port.search("t", body), ref.search("t", body))
        assert (rfp.STATS["bool_served"] > rb) == kernels
        assert (fastpath.STATS["bool_served"] > pb) == kernels


def test_compound_kinds_left_reference_kinds():
    for kind in ("multi_match", "dis_max", "boosting", "combined_fields",
                 "terms_set", "pinned", "wrapper"):
        assert kind not in dsl.REFERENCE_KINDS


# ---------------------------------------------------------------------
# chip_smoke phase 13's brute force on a small bench corpus
# ---------------------------------------------------------------------

BENCH_NDOCS = 3000


@pytest.fixture(scope="module")
def bench_small():
    """bench.py's corpus, guardrail columns and title at a small size,
    attached to both packages (the reference through bench.py's own
    make_index, without the aggregation columns), phase 7's numpy brute
    force over them; and a second port client with the aggregation
    columns whose 16 `_id`s are re-indexed with a ts and a rating, as
    phase 7 does, beside its own brute force."""
    import bench
    from opensearch_tpu_torch import bench_corpus as bc
    corpus = bc.build_corpus(BENCH_NDOCS)
    columns = bc.guardrail_columns(BENCH_NDOCS)
    title = bc.build_title_corpus(BENCH_NDOCS)
    aggs = bc.agg_columns(BENCH_NDOCS)
    starts, docs, tfs, dl, df = corpus
    vs = bc.vocab_strings(len(starts) - 1)
    ref = RefClient()
    bench.make_index(ref, (starts, docs, tfs, vs), dl,
                     tuple(title[:5]) + (bc.title_vocab_strings(
                         len(title[0]) - 1),), *columns)
    port, port2 = RestClient(device="cpu"), RestClient(device="cpu")
    bc.make_index(port, corpus, columns=columns, title=title)
    seg = bc.make_index(port2, corpus, columns=columns, title=title,
                        aggs=aggs)
    ix, ix2 = (chip_smoke.NumpyIndex(corpus, columns, title)
               for _ in range(2))
    q = bc.pick_queries(df, 16, seed=12)
    redo = [(7 * j + 3, [int(t) for t in q[j]] + [int(q[j][0])], j % 3, j,
             chip_smoke.reindexed_cols(j)) for j in range(16)]
    for old, terms, st, pr, cols in redo:
        r = port2.index("bench", {"body": " ".join(vs[t] for t in terms),
                                  "status": bc.STATUS_VALUES[st],
                                  "price": pr, **cols}, id=str(old))
        assert r["result"] == "updated"
    port2.indices.refresh("bench")
    ix2.reindex(redo)
    big = {"corpus": corpus, "title": title, "aggs": aggs,
           "reindexed": redo, "seg": seg}
    return ref, port, ix, port2, ix2, big


def check_oracle(resp, want, what):
    if len(want) == 2:
        want, names = want
        assert [h.get("matched_queries", [])
                for h in resp["hits"]["hits"]] == names, what
    chip_smoke.check_page(resp, want, what)


def test_phase13_brute_force_matches_pages(bench_small):
    """Phase 13's oracle pages equal the port's over the corpus segment
    with deletes and the re-indexed docs' segment (a terms_set minimum
    from the rating column, pins across both segments, matched_queries);
    on the corpus segment alone they equal the reference's pages, but
    for terms_set (the reference's bench index has no rating) and pinned
    (nor an `_id` map)."""
    ref, port, ix, port2, ix2, big = bench_small
    classes = chip_smoke.compound_classes(big, 3)
    assert set(classes) == {"mm_best", "mm_most", "mm_phrase", "dis_max",
                            "boosting", "combined", "terms_set", "pinned",
                            "named"}
    hit = 0
    for name, items in classes.items():
        for body, oracle in items:
            got = port2.search("bench", body)
            check_oracle(got, oracle(ix2), f"re-indexed {name} {body}")
            hit += got["hits"]["total"]["value"] > 0
            if name in ("terms_set", "pinned"):
                continue
            want = ref.search("bench", body)
            check_oracle(want, oracle(ix), f"reference {name} {body}")
            same(port.search("bench", body), want, name)
    assert hit >= 24


def test_phase13_merged_classes_match_reference_pages(bench_small):
    """The classes phase 13 runs on the merged segment (B3 twice, the
    pruned ladder) against the reference's pages."""
    ref, port, ix, _port2, _ix2, big = bench_small
    for name, items in chip_smoke.compound_merged_classes(big, 4).items():
        for body, oracle in items:
            want = ref.search("bench", body)
            check_oracle(want, oracle(ix), f"reference {name} {body}")
            same(port.search("bench", body), want, name)
