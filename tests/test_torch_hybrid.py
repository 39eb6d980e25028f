"""Hybrid search (search/fusion.py) in the port against the JAX package on
the CPU, and phase 16's brute force (chip_smoke.py) against the port.

- The documents of tests/test_torch_vectors.py (two segments, the first
  with deletes) through both packages' RestClient: RRF, linear fusion
  with min_max and l2 normalization, weights, rank_constant, pages
  inside the window, three sub-queries, aggregations over the fused
  window, the `gte` total, the profile's `hybrid` block, msearch entries
  and every hybrid 400. Responses are equal apart from `took`, scores
  within 1e-6 relative and 1.5e-7 absolute (the fused scores round to 7
  places, so two sums a few ulp apart may round one step apart).
- Phase 16's classes on a 3,000-passage bench corpus (768-dim vectors
  drawn as `make_vectors` draws them), each page of the port against
  `VecOracle` and the oracle's fusion.
"""

import jax
import numpy as np
import pytest

import chip_smoke
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu_torch import RestClient
from opensearch_tpu_torch.index.segment import VectorColumn
from opensearch_tpu_torch.search import fusion
from tests.test_torch_compound import bench_small  # noqa: F401
from tests.test_torch_vectors import (DIMS, data, fill, knn,  # noqa: F401
                                      qvec)

jax.config.update("jax_platforms", "cpu")

TOL = (1e-6, 1.5e-7, 0.0)


@pytest.fixture(scope="module")
def clients(data):
    docs, _ = data
    return fill(RefClient(), docs), fill(RestClient(device="cpu"), docs)


def hybrid(queries, **fusion_spec):
    body = {"hybrid": {"queries": queries}}
    if fusion_spec:
        body["hybrid"]["fusion"] = fusion_spec
    return body


def hybrid_bodies(vecs) -> list:
    q = qvec(vecs, "cos", 7)
    qd = qvec(vecs, "dot", 44)
    m = {"match": {"body": "fox tree"}}
    k = knn("cos", q)
    return [
        ("rrf", {"query": hybrid([m, k])}),
        ("rrf rank_constant", {"query": hybrid([m, k], rank_constant=5,
                                               weights=[2.0, 0.5])}),
        ("linear min_max", {"query": hybrid(
            [m, k], method="linear", weights=[0.3, 0.7])}),
        ("linear l2", {"query": hybrid([m, k], method="linear",
                                       normalization="l2")}),
        ("linear dot", {"query": hybrid([m, knn("dot", qd)],
                                        method="linear",
                                        normalization="l2",
                                        weights=[1.0, 0.2])}),
        ("page", {"from": 6, "size": 8, "query": hybrid(
            [m, k], window_size=20)}),
        ("window edge", {"from": 15, "size": 5, "query": hybrid(
            [m, k], method="linear", window_size=20)}),
        ("three subs", {"size": 12, "query": hybrid(
            [m, k, {"term": {"tag": "b"}}], weights=[1, 1, 0.5])}),
        ("one sub", {"query": hybrid([k])}),
        ("one lexical sub", {"query": hybrid([m])}),
        ("filtered knn", {"query": hybrid([
            {"bool": {"must": [m], "filter": [{"range": {
                "price": {"gte": 20}}}]}},
            knn("l2", qvec(vecs, "l2", 30),
                filter={"term": {"tag": "a"}})])}),
        ("aggs", {"size": 5, "query": hybrid([m, k]), "aggs": {
            "t": {"terms": {"field": "tag"}},
            "p": {"stats": {"field": "price"}}}}),
        ("size 0 aggs", {"size": 0, "query": hybrid([m, k], window_size=30),
                         "aggs": {"t": {"terms": {"field": "tag"}}}}),
        ("source and highlight", {"size": 4, "_source": ["tag", "price"],
                                  "highlight": {"fields": {"body": {}}},
                                  "query": hybrid([m, k])}),
        ("track_total_hits", {"track_total_hits": True,
                              "query": hybrid([m, k])}),
        ("no match", {"query": hybrid([{"match": {"body": "zzz"}},
                                       knn("nope", q)])}),
    ]


NAMES = [n for n, _ in hybrid_bodies({f: np.zeros((300, DIMS), np.float32)
                                      for f in ("cos", "dot", "l2")})]


@pytest.mark.parametrize("name", NAMES)
def test_hybrid_bodies_match_reference(clients, data, name):
    ref, port = clients
    _, vecs = data
    body = dict(hybrid_bodies(vecs))[name]
    want = ref.search("v", body)
    chip_smoke.same_vec(port.search("v", body), want, TOL, name + ": ")
    if name != "no match":
        assert want["hits"]["hits"] or body.get("size") == 0, name


def test_hybrid_totals(clients, data):
    """The largest sub-total, `gte` with more than one sub-query; one
    sub-query keeps its own relation."""
    ref, port = clients
    _, vecs = data
    bodies = dict(hybrid_bodies(vecs))
    got = port.search("v", bodies["rrf"])["hits"]["total"]
    assert got["relation"] == "gte"
    assert got == ref.search("v", bodies["rrf"])["hits"]["total"]
    one = port.search("v", bodies["one sub"])["hits"]["total"]
    assert one["relation"] == "eq"
    assert one == port.search("v", {"query": knn(
        "cos", qvec(vecs, "cos", 7))})["hits"]["total"]


def test_hybrid_profile_block_matches_reference(clients, data):
    ref, port = clients
    _, vecs = data
    body = {"size": 3, "profile": True,
            "query": hybrid([{"match": {"body": "fox"}},
                             knn("cos", qvec(vecs, "cos", 3))])}
    got, want = port.search("v", body), ref.search("v", body)
    gp, wp = got.pop("profile")["hybrid"], want.pop("profile")["hybrid"]
    chip_smoke.same_vec(got, want, TOL)
    assert gp["fusion"] == wp["fusion"]
    for g, w in zip(gp["sub_queries"], wp["sub_queries"]):
        for k in ("query", "total", "candidates"):
            assert g[k] == w[k], k
        assert g["took"] >= 0 and g["profile"]["shards"][0]["searches"]
        chip_smoke.same_vec(g["max_score"], w["max_score"], TOL)
        assert [s["searches"][0]["query"][0]["type"]
                for s in g["profile"]["shards"]] == [
            s["searches"][0]["query"][0]["type"]
            for s in w["profile"]["shards"]]


BAD = [
    ("sort", {"sort": ["price"]}), ("collapse", {"collapse": {"field": "tag"}}),
    ("rescore", {"rescore": {"query": {"rescore_query": {"match_all": {}}}}}),
    ("search_after", {"search_after": [1]}), ("min_score", {"min_score": 1}),
    ("knn", {"knn": {"field": "cos", "query_vector": [1.0] * DIMS}}),
    ("terminate_after", {"terminate_after": 5}),
    ("window", {"from": 95, "size": 10}),
]
BAD_FUSION = [
    ("method", {"method": "borda"}), ("normalization",
                                      {"normalization": "z_score"}),
    ("rank_constant", {"rank_constant": 0}), ("window_size",
                                              {"window_size": 0}),
    ("weights length", {"weights": [1.0]}),
    ("negative weight", {"weights": [1.0, -0.5]}),
    ("malformed", {"rank_constant": "x"}),
]
BAD_QUERIES = [
    ("empty", {"hybrid": {"queries": []}}),
    ("not a list", {"hybrid": {"queries": {"match_all": {}}}}),
    ("six subs", {"hybrid": {"queries": [{"match_all": {}}] * 6}}),
    ("nested", {"hybrid": {"queries": [{"hybrid": {"queries": [
        {"match_all": {}}]}}]}}),
    ("not an object", {"hybrid": {"queries": ["fox"]}}),
    ("inside a bool", {"bool": {"must": [{"hybrid": {"queries": [
        {"match_all": {}}]}}]}}),
    ("unknown sub", {"hybrid": {"queries": [{"nope": {}}]}}),
]


def _errors(clients, body):
    out = []
    for c in clients:
        try:
            c.search("v", body)
            out.append(None)
        except Exception as e:     # each package's own ApiError
            out.append((type(e).__name__, getattr(e, "status", None),
                        str(e)))
    return out


@pytest.mark.parametrize("name,extra", BAD, ids=[n for n, _ in BAD])
def test_hybrid_body_400s_match_reference(clients, name, extra):
    body = {"query": hybrid([{"match": {"body": "fox"}},
                             {"match_all": {}}]), **extra}
    ref, port = _errors(clients, body)
    assert ref is not None and ref[1] == 400 and port == ref, (ref, port)


@pytest.mark.parametrize("name,spec", BAD_FUSION,
                         ids=[n for n, _ in BAD_FUSION])
def test_hybrid_fusion_400s_match_reference(clients, name, spec):
    body = {"query": hybrid([{"match": {"body": "fox"}},
                             {"match_all": {}}], **spec)}
    ref, port = _errors(clients, body)
    assert ref is not None and ref[1] == 400 and port == ref, (ref, port)


@pytest.mark.parametrize("name,query", BAD_QUERIES,
                         ids=[n for n, _ in BAD_QUERIES])
def test_hybrid_query_400s_match_reference(clients, name, query):
    ref, port = _errors(clients, {"query": query})
    assert ref is not None and ref[1] == 400 and port == ref, (ref, port)


def test_msearch_with_hybrid_and_knn_bodies_matches_reference(clients,
                                                              data):
    ref, port = clients
    _, vecs = data
    items = [b for _n, b in hybrid_bodies(vecs)[:6]]
    items += [{"query": knn("cos", qvec(vecs, "cos", 11))},
              {"knn": {"field": "dot", "query_vector": qvec(vecs, "dot", 5),
                       "k": 3}, "size": 4},
              {"query": {"match": {"body": "fox"}}},
              {"query": hybrid([{"match_all": {}}], method="nope")},
              {"query": hybrid([{"match": {"body": "fox"}}]),
               "sort": ["price"]}]
    lines = sum([[{}, b] for b in items], [])
    got = port.msearch(lines, index="v")["responses"]
    want = ref.msearch(lines, index="v")["responses"]
    assert "error" in want[-1] and "error" in want[-2]
    for i, (g, w) in enumerate(zip(got, want)):
        chip_smoke.same_vec(g, w, TOL, f"{i}: ")


def test_fusion_algebra():
    assert fusion.minmax_normalize([]) == []
    assert fusion.minmax_normalize([2.0, 2.0]) == [1.0, 1.0]
    assert fusion.minmax_normalize([1.0, 3.0, 2.0]) == [0.0, 1.0, 0.5]
    assert fusion.l2_normalize([0.0, 0.0]) == [0.0, 0.0]
    assert fusion.l2_normalize([3.0, 4.0]) == [0.6, 0.8]
    with pytest.raises(ValueError):
        fusion.normalize_scores([1.0], "z")
    lists = [[("a", 3.0), ("b", 2.0)], [("b", 0.9), ("c", 0.8)]]
    rrf = fusion.fuse_ranked_lists(lists, {"method": "rrf", "weights": [1, 1],
                                           "rank_constant": 60})
    assert [k for k, _ in rrf] == ["b", "a", "c"]
    assert rrf[0][1] == 1 / 62 + 1 / 61
    # equal fused scores: the best (list, rank) first, then the key
    tie = fusion.fuse_ranked_lists([[("z", 1.0)], [("y", 1.0)]],
                                   {"method": "rrf", "weights": [1, 1],
                                    "rank_constant": 60})
    assert [k for k, _ in tie] == ["z", "y"]
    for spec in ({"method": "rrf", "weights": [1, 1], "rank_constant": 60},
                 {"method": "linear", "weights": [0.3, 0.7],
                  "normalization": "min_max"},
                 {"method": "linear", "weights": [1, 1],
                  "normalization": "l2"}):
        got = fusion.fuse_ranked_lists(lists, spec)
        want = chip_smoke.oracle_fusion(lists, spec)
        assert [k for k, _ in got] == [k for k, _ in want]
        np.testing.assert_allclose([s for _, s in got],
                                   [s for _, s in want], rtol=1e-12)


def test_hybrid_stats_and_sub_bodies():
    body = {"query": hybrid([{"match_all": {}}, {"term": {"tag": "a"}}],
                            window_size=30), "size": 5,
            "_source": False, "highlight": {"fields": {"body": {}}},
            "aggs": {"t": {"terms": {"field": "tag"}}}}
    q = fusion.parse_hybrid(body)
    subs = fusion.sub_bodies(body, q)
    assert subs == [{"query": {"match_all": {}}, "from": 0, "size": 30,
                     "_source": False, "highlight": {"fields": {"body": {}}}},
                    {"query": {"term": {"tag": "a"}}, "from": 0, "size": 30,
                     "_source": False,
                     "highlight": {"fields": {"body": {}}}}]
    assert fusion.parse_hybrid({"query": {"match_all": {}}}) is None
    assert not fusion.is_hybrid_body([])


def test_hybrid_with_unported_sub_queries_raise(clients):
    """A hybrid's neural_sparse and rank_feature sub-queries serve since
    learned sparse retrieval was ported, and a percolate sub-query since
    the percolator was: the reference's 400s on this index's fields, its
    fused pages over a feature index."""
    for sub in ({"neural_sparse": {"body": {"query_tokens": {"fox": 1.0}}}},
                {"rank_feature": {"field": "f"}},
                {"percolate": {"field": "q", "document": {}}}):
        ref, got = _errors(clients, {"query": hybrid([{"match_all": {}},
                                                      sub])})
        assert ref is not None and ref[1] == 400 and got == ref, (ref, got)
    mapping = {"mappings": {"properties": {
        "body": {"type": "text"},
        "emb": {"type": "rank_features", "index_impacts": True},
        "pr": {"type": "rank_feature"}}}}
    rng = np.random.default_rng(16)
    docs = [{"body": " ".join(rng.choice(["fox", "dog", "tree"], 3)),
             "emb": {f"t{j}": round(float(rng.exponential()) + 0.05, 3)
                     for j in rng.choice(40, 5)},
             "pr": round(float(rng.lognormal()), 3)} for _ in range(120)]
    out = []
    for c in (RefClient(), RestClient(device="cpu")):
        c.indices.create("f", mapping)
        c.bulk(sum([[{"index": {"_index": "f", "_id": str(i)}}, d]
                    for i, d in enumerate(docs)], []), refresh=True)
        out.append([c.search("f", {"query": hybrid(subs, **spec)})
                    for subs, spec in (
            ([{"match": {"body": "fox"}},
              {"neural_sparse": {"emb": {"query_tokens": {
                  "t1": 1.0, "t7": 0.4}}}}], {}),
            ([{"match": {"body": "dog"}}, {"rank_feature": {"field": "pr"}},
              {"rank_feature": {"field": "emb.t3", "linear": {}}}],
             {"method": "linear"}))])
    for w, g in zip(*out):
        chip_smoke.same_vec(g, w, TOL)


# ---------------------------------------------------------------------
# phase 16's brute force against the port on a small bench corpus
# ---------------------------------------------------------------------

def test_phase16_brute_force_matches_pages(bench_small):
    """Phase 16's bodies over the bench corpus segment with deletes and
    the re-indexed docs' segment (no vectors there): the port's pages
    against VecOracle (exact, the probe over the port's own lists, the
    filtered probe, the bools, the body section, the hybrid fusions and
    the aggregation over the fused window)."""
    import torch
    from opensearch_tpu_torch import bench_corpus as bc
    _ref, _port, _ix, port2, ix2, big = bench_small
    seg = big["seg"]
    n0 = seg.ndocs
    dev = torch.device("cpu")
    vecs, which = chip_smoke.make_vectors(n0, 5, dev)
    assert vecs.shape == (n0, chip_smoke.VEC_DIMS) and vecs.dtype == \
        np.float32 and which.max() < chip_smoke.VEC_CENTRES
    port2.indices.put_mapping("bench", chip_smoke.VEC_PUT_MAPPING)
    ft = port2._indices["bench"].engine.mappings.resolve_field("vec")
    seg.vector_cols["vec"] = VectorColumn("vec", vecs, np.ones(n0, bool),
                                          ft.vector_similarity,
                                          method=ft.vector_method)
    df = big["corpus"][4]
    q = bc.pick_queries(df, 8, seed=3)
    big = dict(big, body_terms=[t for i in range(4)
                                for t in (list(q[i][:2]), list(q[i]))])
    n = 4
    vq = chip_smoke.vec_query_vectors(vecs, ix2.live[:n0],
                                      4 * n + chip_smoke.VEC_MSEARCH, 5)
    classes = chip_smoke.vec_bodies(big, vq, n)
    items = [it for name in classes for it in classes[name]]
    resps = [port2.search("bench", b) for b, _s in items[:-60]]
    resps += port2.msearch(sum([[{}, b] for b, _s in items[-60:]], []),
                           index="bench")["responses"]
    ivf = seg.vector_cols["vec"].ivf
    assert ivf.nlist == round(n0 ** 0.5) and ivf.default_nprobe == \
        ivf.nlist // 8
    oracle = chip_smoke.VecOracle(vecs, ix2, dev)
    checks = chip_smoke.vec_checks(oracle, ix2, vq, items, ivf,
                                   ivf.default_nprobe, np.arange(n0),
                                   (ix2.status, ix2.price))
    for check, r in zip(checks, resps):
        check(r)
    e = [r for (b, s), r in zip(items, resps) if s["kind"] == "hybrid"]
    assert e[3]["aggregations"]["st"]["buckets"]
    assert all(r["hits"]["total"]["relation"] == "gte" for r in e)
