"""The search body's last options in the port (rescore, explain,
terminate_after, timeout, allow_partial_search_results, profile) and the
count, explain and validate_query calls, against the JAX package on the
CPU.

- The same seeded bulk in two segments, the first with deletes, on codec
  v1 and v2, through both packages' RestClient (`search`, `msearch`):
  responses equal apart from `took`, scores within 1e-6 relative (the
  reference's XLA program may contract a BM25 step into an FMA; the port
  multiplies, then adds), and, in each page, neighbouring distinct scores
  more than 1e-6 apart, so the order cannot turn on that last ulp.
  `_explanation` values are host arithmetic and compared for equality.
- The profile's times, its `device` block and the reference's `cost`
  block (its query-cost accounting, which the port leaves out) are
  masked; the plan tree and the shape are compared.
- Rescores with a window past the first phase's page run twice: on the
  reference's CPU path, and with its fastpath forced on (its kernels'
  lanes, the port's plain kernels in their place), since the lanes a
  rescore sees are the first-phase rung's own.
"""

import copy

import jax
import numpy as np
import pytest

import chip_smoke
from opensearch_tpu.rest.client import ApiError as RefApiError
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu_torch import ApiError, RestClient
from opensearch_tpu_torch.errors import NotPortedError
from opensearch_tpu_torch.search import compiler as C
from opensearch_tpu_torch.search import fastpath
from opensearch_tpu_torch.utils import deadline as DL
from tests.test_torch_bool import reference_fastpath  # noqa: F401
from tests.test_torch_compound import (MAPPING, bench_small,  # noqa: F401
                                       fill, make_docs, mm, same)

jax.config.update("jax_platforms", "cpu")

MATCH = {"match": {"body": "fox dog tree"}}
BOOL = {"bool": {"must": [{"match": {"body": "the fox"}}],
                 "filter": [{"range": {"price": {"gte": 20}}}]}}
PHRASE = {"match_phrase": {"body": "the fox"}}


@pytest.fixture(scope="module")
def docs():
    return make_docs()


@pytest.fixture(scope="module", params=["1", "2"], ids=["v1", "v2"])
def clients(request, docs):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENSEARCH_TPU_CODEC", request.param)
        ref, port = fill(RefClient(), docs), fill(RestClient(device="cpu"),
                                                 docs)
    assert len(port._indices["t"].engine.segments) == 2
    return ref, port


def rescore(query, window=10, **kw):
    return {"window_size": window,
            "query": dict(rescore_query=query, **kw)}


MODES = ["total", "multiply", "avg", "max", "min"]
RESCORE_BODIES = [
    (f"{mode}", {"query": MATCH, "rescore": rescore(
        PHRASE, 8, score_mode=mode, query_weight=0.7,
        rescore_query_weight=1.5)}) for mode in MODES] + [
    ("two rescorers", {"query": MATCH, "rescore": [
        rescore(PHRASE, 6), rescore({"match": {"title": "quick fox"}}, 12,
                                    score_mode="max")]}),
    ("window below size", {"query": MATCH, "size": 8,
                           "rescore": rescore(PHRASE, 3)}),
    # exact totals keep the first phase unpruned on every rung, so that
    # the lanes past the page are the exact ones on both sides
    ("window above size", {"query": MATCH, "size": 4,
                           "track_total_hits": True,
                           "rescore": rescore(PHRASE, 14)}),
    ("from", {"query": MATCH, "from": 3, "size": 5,
              "rescore": rescore(PHRASE, 6, score_mode="avg")}),
    ("bool first phase", {"query": BOOL, "rescore": rescore(
        {"match": {"title": "brown lazy"}}, 10, score_mode="multiply")}),
    ("rescore matches nothing", {"query": MATCH,
                                 "rescore": rescore({"term": {"status":
                                                              "nope"}})}),
    ("rescore match_all", {"query": MATCH, "rescore": {"window_size": 5}}),
    ("min_score after rescore", {"query": MATCH, "min_score": 0.5,
                                 "rescore": rescore(PHRASE, 10)}),
    ("sorted", {"query": MATCH, "sort": [{"price": "asc"}],
                "rescore": rescore(PHRASE, 10)}),
    ("phrase first phase", {"query": PHRASE, "rescore": rescore(MATCH, 5)}),
]
RESCORE_IDS = [n for n, _ in RESCORE_BODIES]


@pytest.mark.parametrize("name,body", RESCORE_BODIES, ids=RESCORE_IDS)
def test_rescore_matches_reference(clients, name, body):
    ref, port = clients
    want = ref.search("t", body)
    same(port.search("t", body), want, name + ": ")
    assert want["hits"]["hits"], name


WIDE_BODIES = [
    ("window 50", {"query": {"match": {"body": "the fox"}}, "size": 10,
                   "rescore": rescore(PHRASE, 50, score_mode="total")}),
    ("window 50 bool", {"query": BOOL, "size": 10,
                        "rescore": rescore({"match": {"title": "fox"}}, 50,
                                           score_mode="max")}),
]


@pytest.mark.parametrize("name,body", WIDE_BODIES,
                         ids=[n for n, _ in WIDE_BODIES])
def test_rescore_window_past_the_lanes_matches_reference_fastpath(
        reference_fastpath, docs, name, body):
    """A window past the kernels' K lanes rescores those lanes: the
    reference's fastpath serves the same lanes (single segment, no
    deletes, so the kernels take every segment)."""
    ref, port = RefClient(), RestClient(device="cpu")
    for c in (ref, port):
        c.indices.create("t", MAPPING)
        c.bulk(sum([[{"index": {"_index": "t", "_id": f"d{i}"}}, d]
                    for i, d in enumerate(docs)], []), refresh=True)
    before = dict(fastpath.STATS)
    same(port.search("t", body), ref.search("t", body), name + ": ")
    assert fastpath.STATS["pure_served"] + fastpath.STATS["bool_served"] \
        > before["pure_served"] + before["bool_served"], name


def test_rescore_lanes_of_the_pruned_ladder_are_exact(monkeypatch):
    """On the pruned ladder (heads of 64 postings over 2,400 docs, so
    that most rows are clamped) a rescore reads lanes past the page: the
    port certifies those lanes too, so each rescored page equals the one
    over the dense kernel's exact lanes (`track_total_hits`)."""
    from tests import test_torch_bool as tb
    monkeypatch.setattr(fastpath, "L_HEAD", 64)
    port = tb.fill(RestClient(device="cpu"), tb.make_bulk(), nseg=1)
    pruned = 0
    for i in range(24):
        terms = f"w{i % 6} w{6 + i % 11}"
        body = {"query": {"match": {"body": terms}}, "size": 3,
                "rescore": rescore({"match": {"body": f"w{20 + i}"}}, 16,
                                   score_mode="total")}
        before = sum(fastpath.STATS[k] for k in PRUNED)
        got = port.search("t", body)
        pruned += sum(fastpath.STATS[k] for k in PRUNED) - before
        want = port.search("t", dict(body, track_total_hits=True))
        assert [(h["_id"], h["_score"]) for h in got["hits"]["hits"]] == [
            (h["_id"], h["_score"]) for h in want["hits"]["hits"]], terms
    assert pruned >= 8


PRUNED = ("pruned_served", "pruned_rescued", "pruned_rescued2",
          "pruned_dview")


def test_rescore_errors_match_reference(clients):
    """An unknown score mode is the reference's ValueError where the
    scores combine; a malformed rescore query its parse error; a rescore
    query kind the port lacks raises NotPortedError naming the rescore."""
    ref, port = clients
    body = {"query": MATCH, "rescore": rescore(PHRASE, score_mode="sum")}
    for c in (ref, port):
        with pytest.raises(ValueError, match=r"score_mode \[sum\]"):
            c.search("t", body)
    body = {"query": MATCH, "rescore": rescore({"nope": {}})}
    for c, err in ((ref, RefApiError), (port, ApiError)):
        with pytest.raises(err) as e:
            c.search("t", body)
        assert e.value.status == 400
    body = {"query": MATCH, "rescore": rescore(
        {"function_score": {"query": {"match_all": {}}}})}
    ref.search("t", body)
    with pytest.raises(NotPortedError, match="rescore query"):
        port.search("t", body)


# ---------------------------------------------------------------------
# explain
# ---------------------------------------------------------------------

EXPLAIN_QUERIES = [
    ("match", MATCH),
    ("match boost", {"match": {"title": {"query": "quick fox",
                                         "boost": 2.5}}}),
    ("terms", {"terms": {"status": ["draft", "archived"]}}),
    ("bool", {"bool": {"must": [{"match": {"body": "fox"}}],
                       "should": [{"match": {"title": "lazy dog"}}],
                       "must_not": [{"term": {"status": "draft"}}],
                       "filter": [{"range": {"price": {"lt": 80}}}],
                       "boost": 1.5}}),
    ("phrase", PHRASE),
    ("phrase slop", {"match_phrase": {"body": {"query": "fox tree",
                                               "slop": 2}}}),
    ("phrase prefix", {"match_phrase_prefix": {"body": "the fo"}}),
    ("dis_max", {"dis_max": {"queries": [{"match": {"title": "fox"}},
                                         {"match": {"body": "tree"}}],
                             "tie_breaker": 0.4}}),
    ("constant_score", {"constant_score": {"filter": {"term": {
        "status": "published"}}, "boost": 3.0}}),
    ("range", {"range": {"price": {"gte": 10, "lt": 60, "boost": 2.0}}}),
    ("match_all", {"match_all": {"boost": 1.5}}),
    ("exists", {"bool": {"should": [{"exists": {"field": "rating"}},
                                    {"match": {"title": "moon"}}]}}),
    ("multi_match", mm("quick fox", ["title^2", "body"], tie_breaker=0.3)),
    # the reference's 0.0 fallback kinds
    ("prefix", {"prefix": {"title": "qu"}}),
    ("ids", {"ids": {"values": ["d1", "d40", "d9"]}}),
    ("boosting", {"boosting": {"positive": {"match": {"body": "fox"}},
                               "negative": {"term": {"status": "draft"}},
                               "negative_boost": 0.2}}),
    ("terms_set", {"terms_set": {"body": {
        "terms": ["the", "fox", "dog"],
        "minimum_should_match_field": "rating"}}}),
    ("pinned", {"pinned": {"ids": ["d40", "d2"],
                           "organic": {"match": {"body": "river"}}}}),
    ("combined_fields", {"combined_fields": {"query": "fox river",
                                             "fields": ["body", "title"]}}),
    ("fuzzy", {"fuzzy": {"title": {"value": "quikc", "fuzziness": 2}}}),
]


@pytest.mark.parametrize("name,query", EXPLAIN_QUERIES,
                         ids=[n for n, _ in EXPLAIN_QUERIES])
def test_explain_matches_reference(clients, name, query):
    ref, port = clients
    body = {"query": query, "explain": True, "size": 6}
    want = ref.search("t", body)
    got = port.search("t", body)
    same(got, want, name + ": ")
    assert got["hits"]["hits"], name
    for h in got["hits"]["hits"]:
        assert "_explanation" in h
        # the explanation is host arithmetic; the score a kernel's or a
        # torch op's, within the kernels' tolerance. Not for the fallback
        # kinds, nor for `terms`, whose filter-mode group the reference
        # explains as BM25 while it scores the boost
        if name != "terms" and h["_explanation"]["description"] not in (
                "LExpandTerms", "LIds", "LBoosting", "LTermsSet", "LPinned",
                "LCombined"):
            np.testing.assert_allclose(h["_explanation"]["value"],
                                       h["_score"], rtol=1e-5)


def test_explain_call_matches_reference(clients):
    """The explain call: index-wide statistics, `matched` from the
    value, a buffered id refreshed first, a missing id a 404."""
    ref, port = clients
    for q in (MATCH, BOOL, PHRASE, {"match": {"body": "zzz"}}):
        for doc_id in ("d1", "d7", "d40", "d63"):
            want = ref.explain("t", doc_id, {"query": q})
            got = port.explain("t", doc_id, {"query": q})
            assert got == want, (q, doc_id)
    for c, err in ((ref, RefApiError), (port, ApiError)):
        with pytest.raises(err) as e:
            c.explain("t", "d0", {"query": MATCH})     # deleted
        assert e.value.status == 404
    for c in (ref, port):
        c.index("t", {"body": "fox dog tree fox"}, id="buffered")
    want = ref.explain("t", "buffered", {"query": MATCH})
    assert port.explain("t", "buffered", {"query": MATCH}) == want
    assert want["matched"] is True


def test_explain_device_plan_is_not_ported(clients):
    _ref, port = clients
    with pytest.raises(NotPortedError, match=r"explain \[device_plan\]"):
        port.search("t", {"query": MATCH, "explain": "device_plan"})


# ---------------------------------------------------------------------
# terminate_after, timeout, allow_partial_search_results
# ---------------------------------------------------------------------

BUDGET_BODIES = [
    ("terminate_after 1", {"query": MATCH, "terminate_after": 1}),
    ("terminate_after 5 bool", {"query": BOOL, "terminate_after": 5}),
    ("terminate_after past total", {"query": MATCH,
                                    "terminate_after": 1000}),
    ("terminate_after match_none", {"query": {"match_none": {}},
                                    "terminate_after": 1}),
    ("timeout 0ms", {"query": MATCH, "timeout": "0ms"}),
    ("timeout 0", {"query": BOOL, "timeout": 0}),
    ("timeout 0ms match_none", {"query": {"match_none": {}},
                                "timeout": "0ms"}),
    ("timeout 30s", {"query": MATCH, "timeout": "30s"}),
    ("timeout -1", {"query": MATCH, "timeout": -1}),
    ("timeout 0ms aggs", {"query": MATCH, "timeout": "0ms", "size": 0,
                          "aggs": {"s": {"terms": {"field": "status"}}}}),
]


@pytest.mark.parametrize("name,body", BUDGET_BODIES,
                         ids=[n for n, _ in BUDGET_BODIES])
def test_budgets_match_reference(clients, name, body):
    ref, port = clients
    want = ref.search("t", body)
    same(port.search("t", body), want, name + ": ")
    if "terminate_after" in body and body["terminate_after"] < 100 \
            and "match_none" not in name:
        assert want["terminated_early"] is True
    if body.get("timeout") in ("0ms", 0):
        assert want["timed_out"] is True


def test_budget_flags_and_unbounded_page(clients):
    """terminate_after stops after the first segment with a `gte` total
    while a live segment is left; a 30s timeout serves the unbounded
    page."""
    _ref, port = clients
    full = port.search("t", {"query": MATCH})
    got = port.search("t", {"query": MATCH, "terminate_after": 1})
    assert got["terminated_early"] and got["hits"]["total"]["relation"] \
        == "gte" and got["hits"]["total"]["value"] < full["hits"]["total"][
            "value"]
    assert chip_smoke.strip_took(port.search(
        "t", {"query": MATCH, "timeout": "30s"})) \
        == chip_smoke.strip_took(full)
    got = port.search("t", {"query": MATCH, "timeout": "0ms"})
    assert got["timed_out"] and got["hits"]["hits"] == []


def test_timeout_errors_match_reference(clients):
    """A malformed timeout is a 400 parsing_exception; a timed-out body
    that refuses partial results a 503."""
    ref, port = clients
    for c, err in ((ref, RefApiError), (port, ApiError)):
        with pytest.raises(err) as e:
            c.search("t", {"query": MATCH, "timeout": "soon"})
        assert (e.value.status, e.value.err_type) == (400,
                                                      "parsing_exception")
        with pytest.raises(err) as e:
            c.search("t", {"query": MATCH, "timeout": "0ms",
                           "allow_partial_search_results": False})
        assert (e.value.status, e.value.err_type) == (
            503, "search_phase_execution_exception")
    same(port.search("t", {"query": MATCH, "timeout": "30s",
                           "allow_partial_search_results": False}),
         ref.search("t", {"query": MATCH, "timeout": "30s",
                          "allow_partial_search_results": False}))


def test_deadline_parse_and_scope():
    """The port's copy of the reference's timeout parse, and the scope
    that never leaks a deadline past its search."""
    from opensearch_tpu.utils import deadline as RDL
    for spec in (None, False, -1, 0, 250, "500ms", "2s", "1m", "1h",
                 "250micros", "10nanos", "3d", " 7S "):
        assert DL.parse_timeout_s(spec) == RDL.parse_timeout_s(spec), spec
    for spec in (True, "soon", "ms"):
        with pytest.raises(ValueError):
            DL.parse_timeout_s(spec)
    assert DL.current() is None
    with DL.scope(DL.Deadline(0.0)) as d:
        assert DL.current() is d and d.exhausted()
    assert DL.current() is None
    with DL.scope(None):
        assert DL.current() is None


# ---------------------------------------------------------------------
# profile
# ---------------------------------------------------------------------

def mask_profile(resp: dict) -> dict:
    """The response with the profile's times, `device` blocks and the
    reference's `cost` block taken out."""
    resp = copy.deepcopy(resp)
    prof = resp.get("profile")
    if prof is None:
        return resp
    prof.pop("cost", None)
    for sh in prof["shards"]:
        assert sh.pop("device")["rescore_path"] in ("host", "device")
        assert sh.pop("query_ms") >= 0
        for s in sh["searches"]:
            for col in s["collector"]:
                assert col.pop("time_in_nanos") >= 0
            for q in s["query"]:
                q.pop("device")
                assert q.pop("time_in_nanos") >= 0
    return resp


PROFILE_QUERIES = [("match", MATCH), ("bool", BOOL), ("phrase", PHRASE),
                   ("dis_max", EXPLAIN_QUERIES[7][1]),
                   ("boosting", dict(EXPLAIN_QUERIES)["boosting"]),
                   ("terms_set", dict(EXPLAIN_QUERIES)["terms_set"]),
                   ("pinned", dict(EXPLAIN_QUERIES)["pinned"]),
                   ("range", dict(EXPLAIN_QUERIES)["range"]),
                   ("none", None)]


@pytest.mark.parametrize("name,query", PROFILE_QUERIES,
                         ids=[n for n, _ in PROFILE_QUERIES])
def test_profile_matches_reference(clients, name, query):
    ref, port = clients
    body = {"profile": True, "size": 5}
    if query is not None:
        body["query"] = query
    want = ref.search("t", body)
    got = port.search("t", body)
    assert "cost" not in got["profile"]
    same(mask_profile(got), mask_profile(want), name + ": ")
    root = got["profile"]["shards"][0]["searches"][0]["query"][0]
    assert root["time_in_nanos"] == int(got["profile"]["shards"][0][
        "query_ms"] * 1e6)


def test_describe_plan_matches_reference(clients):
    from opensearch_tpu.search import compiler as RC
    from opensearch_tpu.search import query_dsl as rdsl
    from opensearch_tpu_torch.search import query_dsl as dsl
    ref, port = clients
    rctx = RC.ShardContext(ref.node.indices["t"].mappings,
                           [s for sh in ref.node.indices["t"].shards
                            for s in sh.segments],
                           ref.node.indices["t"].default_sim)
    pctx = port._indices["t"].searcher.context()
    for name, q in EXPLAIN_QUERIES:
        want = RC.describe_plan(RC.rewrite(rdsl.parse_query(q), rctx,
                                           scoring=True))
        assert C.describe_plan(C.rewrite(dsl.parse_query(q), pctx)) \
            == want, name
    assert C.describe_plan(None) == RC.describe_plan(None)


# ---------------------------------------------------------------------
# msearch, count, validate_query
# ---------------------------------------------------------------------

def test_msearch_with_option_bodies_matches_reference(clients):
    """Rescore, profile, explain, terminate_after and timeout bodies
    leave the batch and run alone; the batch's own bodies, one after a
    spent timeout among them, are not timed out."""
    ref, port = clients
    bodies = [{"query": MATCH}, dict(RESCORE_BODIES[0][1]),
              {"query": MATCH, "profile": True},
              {"query": BOOL, "explain": True, "size": 3},
              {"query": MATCH, "timeout": "0ms"}, {"query": BOOL},
              {"query": MATCH, "terminate_after": 1},
              {"query": MATCH, "timeout": "soon"},
              {"query": PHRASE, "size": 4}]
    lines = sum([[{}, b] for b in bodies], [])
    got = port.msearch(lines, index="t")["responses"]
    want = ref.msearch(lines, index="t")["responses"]
    for i, (g, w) in enumerate(zip(got, want)):
        same(mask_profile(g), mask_profile(w), f"{i}: ")
    assert got[4]["timed_out"] and not got[5]["timed_out"]
    assert "error" in got[7]


COUNT_QUERIES = [None, MATCH, BOOL, PHRASE, {"match_none": {}},
                 {"range": {"price": {"gte": 50}}}]


@pytest.mark.parametrize("query", COUNT_QUERIES, ids=str)
def test_count_matches_reference(clients, query):
    ref, port = clients
    body = {} if query is None else {"query": query, "sort": ["_doc"],
                                     "size": 3}
    want = ref.count("t", body)
    assert port.count("t", body) == want
    assert want["count"] == port.search("t", dict(
        body, size=0))["hits"]["total"]["value"]


VALIDATE = [
    ("match", {"query": MATCH}),
    ("bool", {"query": BOOL}),
    ("phrase", {"query": PHRASE}),
    ("empty", {}),
    ("parse error", {"query": {"nope": {}}}),
    ("rewrite error", {"query": {"range": {"body": {"gte": 1}}}}),
    ("terms_set", {"query": dict(EXPLAIN_QUERIES)["terms_set"]}),
]


@pytest.mark.parametrize("name,body", VALIDATE, ids=[n for n, _ in VALIDATE])
@pytest.mark.parametrize("flags", [{}, {"explain": True}, {"rewrite": True}],
                         ids=["plain", "explain", "rewrite"])
def test_validate_query_matches_reference(clients, name, body, flags):
    ref, port = clients
    want = ref.validate_query("t", body, **flags)
    assert port.validate_query("t", body, **flags) == want
    assert want["valid"] == (name not in ("parse error", "rewrite error"))


def test_validate_query_of_a_missing_index_is_a_404(clients):
    for c, err in zip(clients, (RefApiError, ApiError)):
        with pytest.raises(err) as e:
            c.validate_query("nope", {"query": MATCH})
        assert (e.value.status, e.value.err_type) == (
            404, "index_not_found_exception")


# ---------------------------------------------------------------------
# chip_smoke phase 14's rescore classes on a small bench corpus
# ---------------------------------------------------------------------


def test_phase14_rescore_classes_match_reference_pages(bench_small):
    """Phase 14's rescored bodies (a 2-term match rescored by a title
    pool bigram phrase over 50 lanes, the b3 bool shapes by a title term)
    on one segment: the brute force equals the reference's pages and the
    port's, and the rescore moves hits."""
    from opensearch_tpu_torch import bench_corpus as bc
    ref, port, ix, _port2, _ix2, big = bench_small
    q = bc.pick_queries(big["corpus"][4], 16, seed=3)
    run = dict(big, ix=ix, body_terms=[
        [int(t) for t in dict.fromkeys(q[i][:2].tolist())] for i in range(16)])
    classes = chip_smoke.rescore_classes(run, 6)
    moved = 0
    for name, items in classes.items():
        for body, oracle in items:
            want = ref.search("bench", body)
            chip_smoke.check_page(want, oracle(ix), f"reference {name}",
                                  rtol=4e-6)
            same(port.search("bench", body), want, name)
            plain = ref.search("bench", {k: v for k, v in body.items()
                                         if k != "rescore"})
            moved += ([h["_id"] for h in plain["hits"]["hits"]]
                      != [h["_id"] for h in want["hits"]["hits"]])
    assert moved >= 4
