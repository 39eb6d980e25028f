"""Sort, search_after, min_score and collapse in the port
(opensearch_tpu_torch/search/body.py, compiler.sort_key / after_key /
collapse_ords, ops/scoring.collapse_topk, the executor's host tuple,
cursor and reduce), against the JAX package on the CPU.

- The sort key and `collapse_topk` against the reference's jnp
  `emit_sort_key` and `collapse_topk` on the same arrays.
- End to end: the same bulk in three segments through both packages'
  RestClient; responses equal apart from `took` (scores within 1e-6
  relative, the general path's tolerance, `tests/test_torch_general.py`)
  for every sort form, `missing`, several keys, `track_scores`,
  `min_score`, collapse on a keyword, a numeric and an unmapped field
  with inner hits, and `search_after` chains where the reference is
  right (descending keys and the score).
- The reference's `search_after` faults, pinned: an ascending cursor a
  segment lacks, a tie on the primary key under several keys, a `_doc`
  cursor, an ascending `_score` cursor. The reference's page is as
  measured; the port's page is every hit strictly after the cursor's
  full tuple (a numpy brute force).
- The window approximation: a tie class on the primary key wider than a
  segment's window gives a page other than the exact one, in both
  packages alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from opensearch_tpu.ops import scoring as rops
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu.search import compiler as RC
from opensearch_tpu_torch import RestClient
from opensearch_tpu_torch.errors import NotPortedError
from opensearch_tpu_torch.ops import scoring
from opensearch_tpu_torch.search import compiler as C
from opensearch_tpu_torch.search import fastpath, impactpath

jax.config.update("jax_platforms", "cpu")

CPU = torch.device("cpu")
RTOL = 1e-6
NDOCS = 900
MAPPING = {"properties": {"body": {"type": "text"},
                          "status": {"type": "keyword"},
                          "price": {"type": "integer"},
                          "rating": {"type": "double"},
                          "ts": {"type": "date"},
                          "big": {"type": "long"},
                          "flag": {"type": "boolean"}}}
STATUS = ["archived", "draft", "published", "review"]


def make_bulk(seed: int = 23):
    """NDOCS docs: Zipf-ish words over `body`; a status keyword (10%
    missing, 10% two values), a price over 0..59 (15% missing: many
    ties), a rating with one decimal (20% missing), a date, a long near
    2^60 (exact only in 64 bits) and a boolean."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(40)]
    p = 1.0 / np.arange(1, 41) ** 0.9
    p /= p.sum()
    bulk = []
    for i in range(NDOCS):
        doc = {"body": " ".join(rng.choice(words, int(rng.integers(3, 12)),
                                           p=p))}
        r = rng.random()
        if r < 0.1:
            doc["status"] = [STATUS[int(rng.integers(0, 4))],
                             STATUS[int(rng.integers(0, 4))]]
        elif r < 0.9:
            doc["status"] = STATUS[int(rng.integers(0, 4))]
        if rng.random() < 0.85:
            doc["price"] = int(rng.integers(0, 60))
        if rng.random() < 0.8:
            doc["rating"] = round(float(rng.random() * 5), 1)
        doc["ts"] = 1_704_067_200_000 + int(rng.integers(0, 10**9))
        if rng.random() < 0.7:
            doc["big"] = (1 << 60) + int(rng.integers(0, 400))
        doc["flag"] = bool(rng.random() < 0.5)
        bulk += [{"index": {"_index": "t", "_id": f"d{i}"}}, doc]
    return bulk


def fill(client, bulk, mapping=MAPPING):
    client.indices.create("t", {"mappings": mapping})
    n = len(bulk) // 2
    for a, b in ((0, n // 3), (n // 3, 2 * n // 3), (2 * n // 3, n)):
        client.bulk(bulk[2 * a:2 * b], refresh=True)
    return client


@pytest.fixture(scope="module")
def bulk():
    return make_bulk()


@pytest.fixture(scope="module")
def clients(bulk):
    return fill(RefClient(), bulk), fill(RestClient(device="cpu"), bulk)


def assert_same(got, want, path="resp"):
    """Equal apart from `took`, floats within RTOL relative."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want) - {"took"} \
            | ({"took"} & set(got)), (path, sorted(got), sorted(want))
        for k in want:
            if k != "took":
                assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), \
            (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, float), (path, got, want)
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def both(clients, body):
    ref, port = clients
    return port.search("t", body), ref.search("t", body)


# ---------------------------------------------------------------------
# the sort key and collapse_topk against the reference's jnp ones
# ---------------------------------------------------------------------

KEY_SPECS = [
    [], [{"field": "_score", "order": "desc"}],
    [{"field": "_score", "order": "asc"}], [{"field": "_doc"}],
    [{"field": "price", "order": "asc"}],
    [{"field": "price", "order": "desc", "missing": "_first"}],
    [{"field": "rating", "order": "asc", "missing": "_first"}],
    [{"field": "big", "order": "desc"}],
    [{"field": "status", "order": "desc"}],
    [{"field": "status", "order": "asc", "missing": "_first"}],
    [{"field": "nope", "order": "asc"}],
]


@pytest.mark.parametrize("specs", KEY_SPECS, ids=str)
def test_sort_key_matches_reference(clients, specs):
    ref, port = clients
    rseg = ref.node.indices["t"].shards[0].segments[1]
    pseg = port._indices["t"].engine.segments[1]
    n = pseg.ndocs
    scores = np.random.default_rng(3).random(rseg.ndocs_pad).astype(
        np.float32)
    params: dict = {}
    spec = RC.prepare_sort(specs, rseg, params)
    want = np.asarray(RC.emit_sort_key(spec, rseg.device_arrays(), params,
                                       jnp.asarray(scores)))[:n]
    got = C.sort_key(specs, pseg, torch.from_numpy(scores[:n]), CPU)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_ord_pad,k,seed", [(16, 8, 0), (16, 32, 1),
                                              (1024, 64, 2), (2, 4, 3)])
def test_collapse_topk_matches_reference(n_ord_pad, k, seed):
    """Keys with many ties, a null group (ord -1), unmatched and deleted
    docs, more groups than k and fewer."""
    rng = np.random.default_rng(seed)
    nd = 3000
    key = rng.integers(-20, 20, nd).astype(np.float32)
    key[rng.random(nd) < 0.05] = np.float32(-2.0**30)
    matched = rng.random(nd) < 0.6
    live = rng.random(nd) < 0.9
    ords = rng.integers(-1, n_ord_pad - 1, nd).astype(np.int32)
    wv, wd = rops.collapse_topk(jnp.asarray(key), jnp.asarray(matched),
                                jnp.asarray(live.astype(np.float32)),
                                jnp.asarray(ords), n_ord_pad, k)
    gv, gd = scoring.collapse_topk(torch.from_numpy(key),
                                   torch.from_numpy(matched),
                                   torch.from_numpy(live),
                                   torch.from_numpy(ords), n_ord_pad, k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    valid = np.asarray(wv) > -np.inf
    assert valid.any()
    np.testing.assert_array_equal(gd.numpy()[valid], np.asarray(wd)[valid])


# ---------------------------------------------------------------------
# end to end through both RestClients
# ---------------------------------------------------------------------

MATCH = {"match": {"body": "w1 w3"}}
SORT_BODIES = {
    "price_asc": {"sort": [{"price": "asc"}], "size": 20},
    "price_desc_match": {"query": MATCH, "sort": [{"price": "desc"}]},
    "price_missing_first": {"sort": [{"price": {"order": "desc",
                                                "missing": "_first"}}]},
    "rating_asc_missing_first_from": {
        "sort": [{"rating": {"order": "asc", "missing": "_first"}}],
        "from": 150, "size": 10},
    "status_desc_rating": {"query": MATCH, "sort": [
        {"status": "desc"}, {"rating": {"order": "asc",
                                        "missing": "_first"}}],
        "track_scores": True},
    "status_asc_missing_first": {"sort": [{"status": {
        "order": "asc", "missing": "_first"}}, "_score"]},
    "price_ts_docvalues": {"query": MATCH, "sort": [{"price": "asc"},
                                                    {"ts": "desc"}]},
    "big_desc": {"sort": [{"big": "desc"}, {"price": "asc"}], "size": 15},
    "flag_ts": {"sort": [{"flag": "desc"}, {"ts": "asc"}]},
    "ts_string_form": {"query": MATCH, "sort": ["ts"]},
    "doc": {"sort": ["_doc"], "size": 12},
    "doc_desc": {"query": MATCH, "sort": [{"_doc": "desc"}]},
    "score_asc": {"query": MATCH, "sort": [{"_score": "asc"}]},
    "score_then_price": {"query": MATCH, "sort": ["_score",
                                                  {"price": "desc"}]},
    "unmapped_field": {"query": MATCH, "sort": [{"nope": "asc"}]},
    "track_scores_false": {"query": MATCH, "sort": [{"rating": "desc"}],
                           "track_scores": False},
    "track_scores_true": {"query": MATCH, "sort": [{"rating": "desc"}],
                          "track_scores": True},
    "min_score": {"query": MATCH, "min_score": 1.0},
    "min_score_from": {"query": {"match": {"body": "w0 w2 w5"}},
                       "min_score": 1.25, "from": 5, "size": 5},
    "min_score_field_sort": {"query": MATCH, "min_score": 1.0,
                             "sort": [{"price": "asc"}]},
    "collapse_keyword": {"query": MATCH, "collapse": {"field": "status"}},
    "collapse_numeric": {"query": MATCH, "collapse": {"field": "price"},
                         "size": 15},
    "collapse_unmapped": {"query": MATCH, "collapse": {"field": "nope"}},
    "collapse_inner_hits": {"query": MATCH, "collapse": {
        "field": "status", "inner_hits": {"name": "more", "size": 2}}},
    "collapse_inner_hits_sorted": {"query": MATCH, "collapse": {
        "field": "price", "inner_hits": [
            {"name": "cheap", "size": 2, "sort": [{"rating": "asc"}]},
            {"name": "top", "size": 1}]}, "size": 5},
    "collapse_field_sort": {"query": MATCH, "collapse": {"field": "status"},
                            "sort": [{"rating": "desc"}]},
    "collapse_match_all": {"collapse": {"field": "price"}, "size": 30},
    "sort_with_aggs": {"query": MATCH, "sort": [{"price": "desc"}],
                       "aggs": {"s": {"terms": {"field": "status"}}}},
}


@pytest.mark.parametrize("name", sorted(SORT_BODIES))
def test_sort_bodies_match_reference(clients, name):
    got, want = both(clients, SORT_BODIES[name])
    assert want["hits"]["hits"], name
    assert_same(got, want)


CHAINS = {
    "price_desc": {"query": MATCH, "sort": [{"price": "desc"}], "size": 7},
    "ts_desc_price": {"sort": [{"ts": "desc"}, {"price": "asc"}],
                      "size": 25},
    "rating_desc": {"query": MATCH, "sort": [{"rating": "desc"}],
                    "size": 40},
    "status_desc": {"sort": [{"status": "desc"}], "size": 50},
    "score": {"query": MATCH, "size": 6},
    "score_sorted": {"query": MATCH, "sort": ["_score"], "size": 6},
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_search_after_chains_match_reference(clients, name):
    """Four pages, each after the last hit of the page before, where the
    reference's cursor is right: descending keys (under several keys a
    primary without ties), and the score."""
    ref, port = clients
    body = dict(CHAINS[name])
    for page in range(4):
        got, want = port.search("t", body), ref.search("t", body)
        assert_same(got, want, f"{name} page {page}")
        hits = want["hits"]["hits"]
        if not hits:
            break
        last = hits[-1]
        body["search_after"] = (last["sort"] if "sort" in last
                                else [last["_score"]])
    assert page >= 2, name


@pytest.mark.parametrize("body,name", [
    ({"sort": [{"_geo_distance": {"loc": [0, 0]}}]}, "_geo_distance"),
    ({"sort": [{"_script": {"script": "1"}}]}, "_script"),
    ({"sort": [{"price": {"order": "asc", "nested": {"path": "x"}}}]},
     "nested"),
    ({"rescore": {"query": {"rescore_query": {"function_score": {}}}}},
     "function_score"),
    ({"explain": "device_plan"}, "device_plan"),
    ({"script_fields": {}}, "script_fields"),
    ({"post_filter": {"match_all": {}}}, "post_filter"),
    ({"indices_boost": [{"t": 2.0}]}, "indices_boost"),
    ({"slice": {"id": 0, "max": 2}}, "slice"),
    ({"suggest": {}}, "suggest"), ({"derived": {}}, "derived")], ids=str)
def test_options_outside_the_slice_raise(clients, body, name):
    """The options outside the port raise NotPortedError naming them; a
    `_script` sort, a function_score rescore, `script_fields`, a
    `_geo_distance` sort (on a field the index does not map: every doc
    missing, last) and a `nested` sort (over a path the index does not
    map: the same) serve the reference's response."""
    ref, port = clients
    if name in ("_script", "function_score", "script_fields",
                "_geo_distance", "nested"):
        assert_same(port.search("t", body), ref.search("t", body))
        return
    with pytest.raises(NotPortedError) as e:
        port.search("t", body)
    assert f"[{name}]" in str(e.value)


def test_rungs_keep_a_score_sort_and_decline_the_rest(bulk):
    """A lone `_score`-desc sort stays on the fused kernels; any other
    sort, a cursor, collapse and min_score leave them and the impact rung
    for the general path on every segment."""
    port = fill(RestClient(device="cpu"), bulk)
    nseg = len(port._indices["t"].engine.segments)
    q = {"match": {"body": "w1 w2"}}
    for extra, kernels in (({}, True), ({"sort": ["_score"]}, True),
                           ({"sort": [{"_score": "desc"}]}, True),
                           ({"sort": [{"price": "asc"}]}, False),
                           ({"sort": ["_score", {"price": "asc"}]}, False),
                           ({"search_after": [1.0]}, False),
                           ({"collapse": {"field": "status"}}, False),
                           ({"min_score": 0.5}, False)):
        before = (dict(fastpath.STATS), impactpath.STATS["served"],
                  C.STATS["general_served"])
        port.search("t", {"query": q, **extra})
        served = sum(fastpath.STATS[k] - before[0][k] for k in
                     ("pure_served", "bool_served", "shard_view_served"))
        general = C.STATS["general_served"] - before[2]
        assert (served >= 1) == kernels, extra
        assert impactpath.STATS["served"] == before[1], extra
        assert general == (0 if kernels else nseg), extra


def test_msearch_reruns_declined_bodies_as_searches(clients):
    ref, port = clients
    bodies = [{"query": MATCH, "sort": [{"price": "asc"}]},
              {"query": MATCH},
              {"query": MATCH, "search_after": [2.0]},
              {"query": MATCH, "min_score": 1.0},
              {"query": MATCH, "sort": ["_score"], "size": 3},
              {"query": MATCH, "collapse": {"field": "status"}}]
    lines = sum([[{}, b] for b in bodies], [])
    got = port.msearch(lines, index="t")["responses"]
    for g, b in zip(got, bodies):
        assert_same(g, ref.search("t", b), str(b))


# ---------------------------------------------------------------------
# the reference's search_after faults, pinned
# ---------------------------------------------------------------------

def _segments(client, segs, mapping):
    client.indices.create("t", {"mappings": {"properties": mapping}})
    n = 0
    for seg in segs:
        lines = []
        for d in seg:
            lines += [{"index": {"_index": "t", "_id": f"d{n}"}}, d]
            n += 1
        client.bulk(lines, refresh=True)
    return client


def brute_after(segs, keys, after, size=10):
    """OpenSearch's strictly-after page: the docs whose tuple of sort
    values (`keys`: (field, descending)) is after `after`, by the full
    tuple then `_id` (numpy lexsort)."""
    docs = [(f"d{i}", d) for i, d in enumerate(sum(segs, []))]

    def tup(d):
        return tuple(-d[f] if desc else d[f] for f, desc in keys)
    cur = tuple(-v if desc else v for v, (_f, desc) in zip(after, keys))
    kept = [(tup(d), i) for i, d in docs if tup(d) > cur]
    order = np.lexsort([np.array([i for _t, i in kept])]
                       + [np.array([t[j] for t, _i in kept])
                          for j in reversed(range(len(keys)))])
    return [kept[j][1] for j in order][:size]


PRICES = [[{"p": 10}, {"p": 30}], [{"p": 20}, {"p": 25}, {"p": 40}]]
FAULTS = {
    # an ascending cursor the first segment lacks drops the second
    # segment's next value there
    "asc_absent_10": (PRICES, {"p": {"type": "integer"}},
                      [("p", False)], [10], ["d3", "d1", "d4"]),
    "asc_absent_22": (PRICES, {"p": {"type": "integer"}},
                      [("p", False)], [22], ["d4"]),
    "keyword_asc_absent": ([[{"k": "a"}, {"k": "b"}, {"k": "c"},
                             {"k": "d"}]], {"k": {"type": "keyword"}},
                           [("k", False)], ["aa"], ["d2", "d3"]),
    # the device filter reads the primary key alone
    "secondary_keys": ([[{"p": 20, "q": 1}, {"p": 20, "q": 2},
                         {"p": 20, "q": 3}, {"p": 30, "q": 1}]],
                       {"p": {"type": "integer"}, "q": {"type": "integer"}},
                       [("p", False), ("q", False)], [20, 1], ["d3"]),
}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_search_after_faults_pinned(name):
    segs, mapping, keys, after, ref_page = FAULTS[name]
    body = {"sort": [{f: "desc" if d else "asc"} for f, d in keys],
            "search_after": after}
    ref = _segments(RefClient(), segs, mapping).search("t", body)
    port = _segments(RestClient(device="cpu"), segs, mapping).search("t",
                                                                    body)
    assert [h["_id"] for h in ref["hits"]["hits"]] == ref_page
    want = brute_after(segs, [(f, d) for f, d in keys], after)
    assert [h["_id"] for h in port["hits"]["hits"]] == want
    assert len(want) > len(ref_page)
    assert port["hits"]["total"]["value"] == len(want)


def test_search_after_doc_and_score_asc_pinned():
    """`_doc`: the reference's cursor is +inf, so page 2 repeats page 1;
    the port filters strictly after the doc. An ascending `_score`: the
    reference compares the negated score with the cursor unnegated."""
    segs = [[{"p": i, "b": "x " * (1 + i % 5)} for i in range(8)]]
    mapping = {"p": {"type": "integer"}, "b": {"type": "text"}}
    ref = _segments(RefClient(), segs, mapping)
    port = _segments(RestClient(device="cpu"), segs, mapping)
    body = {"sort": ["_doc"], "size": 3, "search_after": [2]}
    assert [h["_id"] for h in ref.search("t", body)["hits"]["hits"]] == \
        ["d0", "d1", "d2"]
    assert [h["_id"] for h in port.search("t", body)["hits"]["hits"]] == \
        ["d3", "d4", "d5"]
    q = {"query": {"match": {"b": "x"}}, "sort": [{"_score": "asc"}],
         "size": 20}
    page = port.search("t", q)["hits"]["hits"]
    cur = page[2]["_score"]
    after = port.search("t", dict(q, search_after=[cur]))["hits"]["hits"]
    assert after and all(h["_score"] > cur for h in after)
    assert [h["_id"] for h in after] == [h["_id"] for h in page
                                         if h["_score"] > cur]
    ref_after = ref.search("t", dict(q, search_after=[cur]))["hits"]["hits"]
    assert len(ref_after) == len(page)


def test_search_after_ties_past_the_window():
    """Under several keys, a cursor whose primary value ties with more
    docs than a segment's window: the window grows by the ties, so the
    page is still every hit strictly after the cursor, and the total
    counts them."""
    segs = [[{"p": 5, "q": (37 * i) % 101} for i in range(101)]
            + [{"p": 6, "q": i} for i in range(5)],
            [{"p": 5, "q": 200 + i} for i in range(3)]]
    mapping = {"p": {"type": "integer"}, "q": {"type": "integer"}}
    port = _segments(RestClient(device="cpu"), segs, mapping)
    after = [5, 90]
    body = {"sort": [{"p": "asc"}, {"q": "asc"}], "size": 8,
            "search_after": after}
    got = port.search("t", body)
    want = brute_after(segs, [("p", False), ("q", False)], after, size=8)
    assert [h["_id"] for h in got["hits"]["hits"]] == want
    n_after = len(brute_after(segs, [("p", False), ("q", False)], after,
                              size=1000))
    assert got["hits"]["total"]["value"] == n_after


def test_window_approximation_pinned():
    """A tie class on the primary key wider than a segment's window:
    each segment keeps its window's docs by (primary key, ascending
    doc), so the page is the best of that window by the full tuple, not
    the exact best. Both packages serve the same page."""
    segs = [[{"p": 5, "q": (53 * i) % 97} for i in range(97)]]
    mapping = {"p": {"type": "integer"}, "q": {"type": "integer"}}
    body = {"sort": [{"p": "asc"}, {"q": "asc"}], "size": 5}
    ref = _segments(RefClient(), segs, mapping).search("t", body)
    port = _segments(RestClient(device="cpu"), segs, mapping).search("t",
                                                                    body)
    assert_same(port, ref)
    exact = brute_after(segs, [("p", False), ("q", False)], [5, -1], 5)
    got = [h["_id"] for h in port["hits"]["hits"]]
    assert got != exact
    # the window: next_pow2(max(2 * 5, 16)) = 16 docs by ascending doc
    window = sorted(range(16), key=lambda i: ((53 * i) % 97, i))[:5]
    assert got == [f"d{i}" for i in window]



# ---------------------------------------------------------------------
# chip_smoke.py phase 11's brute force on a small bench corpus
# ---------------------------------------------------------------------

BENCH_NDOCS = 3000


@pytest.fixture(scope="module")
def bench_sort():
    """The bench corpus with its guardrail, aggregation and title columns
    (title text in the sources) on the CPU, chip_smoke.REINDEXED of its
    _ids re-indexed with ts and ratings as phase 7 leaves them."""
    from opensearch_tpu_torch import bench_corpus as bc
    corpus = bc.build_corpus(BENCH_NDOCS)
    columns = bc.guardrail_columns(BENCH_NDOCS)
    aggcols = bc.agg_columns(BENCH_NDOCS)
    title = bc.build_title_corpus(BENCH_NDOCS)
    port = RestClient(device="cpu")
    bc.make_index(port, corpus, columns=columns, title=title, aggs=aggcols,
                  title_source=True)
    ix = chip_smoke.NumpyIndex(corpus, columns, title)
    vs = bc.vocab_strings(len(corpus[0]) - 1)
    q2 = bc.pick_queries(corpus[4], chip_smoke.REINDEXED)
    bodies, terms = [], []
    for i in range(chip_smoke.REINDEXED):
        bodies += [bc.match_body(i, q2, vs), None]
        terms += [list(q2[i][:2]), None]
    olds = np.arange(chip_smoke.REINDEXED) * 43 + 7
    docs = [(int(old), [int(q2[j][0])] * 2 + [int(q2[j][1])], j % 3, j,
             chip_smoke.reindexed_cols(j)) for j, old in enumerate(olds)]
    for old, ts, st, pr, cols in docs:
        port.index("bench", {"body": " ".join(vs[t] for t in ts),
                             "status": bc.STATUS_VALUES[st], "price": pr,
                             **cols}, id=str(old))
    port.indices.refresh("bench")
    ix.reindex(docs)
    return {"client": port, "bodies": bodies, "body_terms": terms,
            "aggs": aggcols, "title": title, "ix": ix}


def _chain(port, body, pages):
    out = [(body, port.search("bench", body))]
    for _ in range(pages):
        hits = out[-1][1]["hits"]["hits"]
        if not hits:
            break
        b = dict(body, search_after=hits[-1]["sort"])
        out.append((b, port.search("bench", b)))
    return out


@pytest.mark.parametrize("cls", ["a_price_listing", "b_newest_first",
                                 "c_rating_ascending", "d_keyword_missing",
                                 "e_collapse"])
def test_phase11_brute_force_matches_the_port(bench_sort, cls):
    """Phase 11's bodies over the small bench state (two segments, the
    re-indexed docs' ratings absent from the big one): every response of
    the port on the CPU passes the chip run's brute force, chains
    included."""
    big = bench_sort
    oracle = chip_smoke.SortOracle(big["ix"], big["aggs"])
    want_of = chip_smoke.sort_checker(big, oracle)
    bodies = chip_smoke.sort_classes(big, 6)[cls]
    extra = chip_smoke.Counter()
    n = 0
    for body in bodies:
        for b, resp in _chain(big["client"], body,
                              chip_smoke.SORT_CHAIN if cls[0] in "bc"
                              else 0):
            extra.update(want_of(b, resp))
            n += 1
    assert n >= len(bodies)
    if cls[0] == "c":
        # the reference's ascending cursor drops the small segment's
        # next rating on these chains
        assert extra["reference_cursor_drops"] > 0


def test_phase11_snippets_brute_force_matches_the_port(bench_sort):
    big = bench_sort
    want_of = chip_smoke.snippet_checker(big)
    for body in chip_smoke.snippet_bodies(big, 6):
        want_of(body, big["client"].search("bench", body))


def test_sort_ordinals_are_cached_released_and_not_merged(bulk):
    """A field's sort ordinals sit on the device once per segment and
    field; a merge releases the replaced segments' copies and the merged
    segment builds its own on first use."""
    port = fill(RestClient(device="cpu"), bulk)
    eng = port._indices["t"].engine
    body = {"sort": [{"price": "asc"}], "size": 5}
    port.search("t", body)
    old = list(eng.segments)
    assert all(("sort_ords", "price", "cpu") in s.device_arrays
               for s in old)
    got = port.search("t", body)
    port.indices.forcemerge("t", max_num_segments=1)
    (merged,) = eng.segments
    assert all(not s.device_arrays for s in old)
    assert ("sort_ords", "price", "cpu") not in merged.device_arrays
    assert_same(port.search("t", body), got)
    assert ("sort_ords", "price", "cpu") in merged.device_arrays
