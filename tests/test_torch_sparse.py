"""Learned sparse retrieval, rank_feature and distance_feature in the port
against the JAX package on the CPU.

- The same seeded documents (numpy seed 16: 2,000 docs over a 300-feature
  vocabulary of Zipf(1.1) popularity, 12 draws a doc, weights
  expovariate(1) + 0.05 rounded to 3 places, as bench.py's hybrid corpus
  draws them) in two segments, the first with deletes, through both
  packages' RestClient (the reference's on a node without a mesh service
  and with number_of_replicas 0: its impact rung stands down behind a
  mesh or replica copies). Fields: `emb` (rank_features,
  index_impacts: a FEATURE plane), `sv` (sparse_vector, no plane), `neg`
  (rank_features, positive_score_impact false), `pr` / `prn`
  (rank_feature, the second positive_score_impact false), `ts` (date),
  `st` (keyword), `body` (text), `vec` (8-dim cosine vectors).
- Responses are equal apart from `took` (`chip_smoke.same_vec`), scores
  within 1e-6 relative: the sparse dot, saturation, linear and
  distance_feature scores are bit-equal; `log` and `sigmoid` run the
  library's ln and pow, within 1 ulp of XLA's (ROADMAP Queue 3). A root
  `neural_sparse` must reach the same impact-rung rung in both packages
  (served, pruned, phase 2, escalated), with `gte` totals when pruned.
- The FEATURE plane equals the reference's `build_feature_impact_plane`
  bit for bit, on numpy and through the device quantizer, half-step ties
  included, before and after a forcemerge, and across flush and recovery.
"""

import copy

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from opensearch_tpu.cluster.node import Node
from opensearch_tpu.index import segment as rseg_mod
from opensearch_tpu.ops import scoring as rops
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu.search import impactpath as rip
from opensearch_tpu_torch import RestClient
from opensearch_tpu_torch.index import segment as pseg_mod
from opensearch_tpu_torch.index.convert import segment_from_arrays
from opensearch_tpu_torch.ops import device_merge
from opensearch_tpu_torch.ops import scoring as ops
from opensearch_tpu_torch.search import compiler as C
from opensearch_tpu_torch.search import impactpath
from tests.test_torch_compound import bench_small  # noqa: F401
from tests.test_torch_compound import same

jax.config.update("jax_platforms", "cpu")

TOL = (1e-6, 0.0, 0.0)
HYBRID_TOL = (1e-6, 1.5e-7, 0.0)     # fused scores round to 7 places
NDOCS = 2000
SPLIT = 1400
NFEAT = 300
DIMS = 8
DELETED = ("d5", "d77", "d300", "d301", "d999", "d1200")
WORDS = ["red", "fox", "dog", "tree", "blue", "quick", "lazy", "moon"]
TS0 = 1_704_067_200_000          # 2024-01-01
FEATS = [f"t{i}" for i in range(NFEAT)]
ZIPF = np.array([1.0 / r ** 1.1 for r in range(1, NFEAT + 1)])
MAPPING = {"settings": {"number_of_replicas": 0}, "mappings": {"properties": {
    "body": {"type": "text"}, "st": {"type": "keyword"},
    "emb": {"type": "rank_features", "index_impacts": True},
    "sv": {"type": "sparse_vector"},
    "neg": {"type": "rank_features", "positive_score_impact": False},
    "pr": {"type": "rank_feature"},
    "prn": {"type": "rank_feature", "positive_score_impact": False},
    "ts": {"type": "date"},
    "vec": {"type": "dense_vector", "dims": DIMS,
            "similarity": "cosine"}}}}
RUNGS = ("served", "pruned_served", "phase2_served", "escalated")


def make_docs() -> list:
    rng = np.random.default_rng(16)
    p = ZIPF / ZIPF.sum()
    docs = []
    for i in range(NDOCS):
        toks = rng.choice(NFEAT, 12, p=p)
        doc = {"body": " ".join(rng.choice(WORDS, int(rng.integers(2, 6)))),
               "st": "abc"[i % 3],
               "emb": {FEATS[t]: round(float(rng.exponential()) + 0.05, 3)
                       for t in toks},
               "ts": int(TS0 + rng.integers(0, 300 * 86_400_000)),
               "vec": rng.normal(size=DIMS).round(4).tolist()}
        if i % 4:
            doc["sv"] = {FEATS[t]: round(float(rng.exponential()) + 0.05, 3)
                         for t in toks[:6]}
            doc["neg"] = {FEATS[t]: round(float(rng.exponential()) + 0.05,
                                          3) for t in toks[:3]}
        if i % 5:
            doc["pr"] = float(np.float32(rng.lognormal()))
            doc["prn"] = round(float(rng.lognormal()), 4)
        docs.append(doc)
    return docs


def fill(c, docs):
    """Two segments (1,400 and 600 docs); the first loses DELETED."""
    c.indices.create("s", copy.deepcopy(MAPPING))
    for a, b in ((0, SPLIT), (SPLIT, NDOCS)):
        c.bulk(sum([[{"index": {"_index": "s", "_id": f"d{i}"}}, docs[i]]
                    for i in range(a, b)], []), refresh=True)
    c.bulk([{"delete": {"_index": "s", "_id": d}} for d in DELETED],
           refresh=True)
    return c


def ref_client() -> RefClient:
    return RefClient(node=Node(mesh_service=False))


@pytest.fixture(scope="module")
def docs():
    return make_docs()


@pytest.fixture(scope="module")
def clients(docs):
    ref = fill(ref_client(), docs)
    port = fill(RestClient(device="cpu"), docs)
    assert len(port._indices["s"].engine.segments) == 2
    return ref, port


def query_tokens(seed: int) -> dict:
    """bench.py's learned-sparse query: 3 rare head tokens weighted 3/(r+1),
    up to 8 popular tail tokens from the top 100 weighted 0.25/(1+r)+0.02."""
    rng = np.random.default_rng(200 + seed)
    head = rng.choice(FEATS[120:], 3, replace=False)
    toks = {str(t): round(3.0 / (r + 1), 3) for r, t in enumerate(head)}
    tp = ZIPF[:100] / ZIPF[:100].sum()
    tail = dict.fromkeys(str(FEATS[t]) for t in rng.choice(100, 8, p=tp))
    for r, t in enumerate(tail):
        toks.setdefault(t, round(0.25 / (1 + r) + 0.02, 3))
    return toks


def ns(tokens, field="emb", **kw):
    return {"neural_sparse": {field: dict(query_tokens=tokens, **kw)}}


def rf(field, **fn):
    return {"rank_feature": dict(field=field, **fn)}


MATCH = {"match": {"body": "fox tree"}}
DF = {"distance_feature": {"field": "ts", "origin": "2024-09-01T12:34:56Z",
                           "pivot": "7d"}}


def sparse_bodies() -> list:
    """(name, body, root neural_sparse on the plane) of classes (a), (b)
    and the root forms the rung declines or the general path serves."""
    out = []
    for i in range(6):
        out.append((f"a pruned {i}", {"query": ns(query_tokens(i)),
                                      "size": (10, 3, 40)[i % 3]}, True))
        out.append((f"b exact {i}", {"query": ns(query_tokens(10 + i)),
                                     "track_total_hits": True}, True))
    out += [
        ("boosted", {"query": ns(query_tokens(30), boost=1.7)}, True),
        ("boost 0", {"query": ns(query_tokens(31), boost=0.0)}, True),
        ("negative weight", {"query": ns({"t3": 1.0, "t150": -0.5})},
         True),
        ("absent tokens", {"query": ns({"zz": 1.0, "t299": 2.0})}, True),
        ("page", {"query": ns(query_tokens(32)), "from": 5, "size": 7},
         True),
        ("sparse_vector field", {"query": ns(query_tokens(33), "sv")},
         False),
        ("no plane, exact", {"query": ns(query_tokens(34), "sv"),
                             "track_total_hits": True}, False),
    ]
    return out


def general_bodies() -> list:
    """(name, body) of classes (c)-(e) and the nodes in other places."""
    out = [
        ("c bool", {"query": {"bool": {
            "must": [MATCH], "filter": [{"term": {"st": "a"}}],
            "should": [ns(query_tokens(40))]}}}),
        ("c bool must", {"query": {"bool": {
            "must": [{"match": {"body": "dog"}}, ns(query_tokens(41))],
            "filter": [{"term": {"st": "b"}}]}}}),
        ("c sparse filter", {"query": {"bool": {
            "must": [MATCH], "filter": [ns(query_tokens(42))]}}}),
        ("c constant_score", {"query": {"constant_score": {
            "filter": ns({"t1": 1.0, "t2": 0.5})}}}),
        ("c dis_max", {"query": {"dis_max": {"queries": [
            MATCH, ns(query_tokens(43), "sv")], "tie_breaker": 0.3}}}),
        ("c sort", {"query": ns(query_tokens(44)), "sort": [{"ts": "desc"}],
                    "size": 5}),
        ("c aggs", {"query": ns(query_tokens(45)), "size": 3, "aggs": {
            "st": {"terms": {"field": "st"}}}}),
        ("e distance", {"query": {"bool": {"must": [MATCH],
                                           "should": [DF]}}}),
        ("e distance alone", {"query": {"distance_feature": {
            "field": "ts", "origin": TS0 + 123_456_789_017, "pivot": "3d",
            "boost": 2.0}}}),
        ("e distance filter", {"query": {"bool": {
            "must": [MATCH], "filter": [DF]}}}),
        ("e distance epoch", {"query": {"distance_feature": {
            "field": "ts", "origin": TS0 + 5, "pivot": 86_400_000}}}),
        ("term on a feature field", {"query": {"term": {"emb": "t1"}}}),
        ("match on a feature field", {"query": {"match": {
            "emb": "t1 t2"}}}),
        ("terms and exists on a feature field", {"query": {"bool": {
            "filter": [{"terms": {"emb": ["t1", "t5"]}}],
            "should": [{"exists": {"field": "emb"}}]}}}),
        ("rank_feature filter", {"query": {"bool": {
            "must": [MATCH], "filter": [rf("emb.t7"), rf("pr")]}}}),
        ("named", {"query": {"bool": {"should": [
            {"neural_sparse": {"emb": {"query_tokens": {"t0": 1.0},
                                       "_name": "sparse"}}},
            {"rank_feature": {"field": "pr", "_name": "rank"}},
            {"distance_feature": {"field": "ts", "origin": TS0,
                                  "pivot": "30d", "_name": "recent"}},
            {"match": {"body": {"query": "fox", "_name": "text"}}}]}}}),
    ]
    fns = [("saturation", {}), ("saturation pivot",
                                {"saturation": {"pivot": 0.9}}),
           ("log", {"log": {"scaling_factor": 2}}),
           ("sigmoid", {"sigmoid": {"pivot": 1.5, "exponent": 0.7}}),
           ("linear", {"linear": {}})]
    for fname, fn in fns:
        for field in ("emb.t3", "emb.t140", "pr"):
            out.append((f"d {fname} {field}", {"query": {"bool": {
                "must": [MATCH], "should": [rf(field, boost=1.3, **fn)]}}}))
    for fname, fn in fns[:2] + fns[3:4]:
        for field in ("neg.t2", "prn"):
            out.append((f"d {fname} {field}", {"query": {"bool": {
                "must": [{"match": {"body": "dog"}}],
                "should": [rf(field, **fn)]}}}))
    out.append(("d root", {"query": rf("emb.t0"), "size": 20}))
    return out


def hybrid(queries, **spec) -> dict:
    return {"hybrid": {"queries": queries, **({"fusion": spec} if spec
                                               else {})}}


def hybrid_bodies() -> list:
    qv = np.random.default_rng(7).normal(size=DIMS).round(4).tolist()
    knn = {"knn": {"vec": {"vector": qv, "k": 20}}}
    return [
        ("f rrf", {"query": hybrid([MATCH, ns(query_tokens(50)), knn],
                                   rank_constant=60, window_size=50)}),
        ("f linear", {"query": hybrid([MATCH, ns(query_tokens(51)), knn],
                                      method="linear", window_size=50)}),
        ("f rank_feature", {"query": hybrid(
            [MATCH, rf("emb.t4"), ns(query_tokens(52), "sv")],
            method="linear", normalization="l2", weights=[1, 0.5, 2])}),
    ]


def rung_moves(before: dict, stats: dict) -> tuple:
    return tuple(k for k in RUNGS if stats[k] > before[k])


@pytest.mark.parametrize("name,body,rooted",
                         sparse_bodies(),
                         ids=[n for n, _b, _r in sparse_bodies()])
def test_sparse_bodies_match_reference(clients, name, body, rooted):
    """Classes (a) and (b): the same page, total and relation, and the
    same impact-rung rung as the reference."""
    ref, port = clients
    r0, p0 = rip.stats(), dict(impactpath.STATS)
    s0 = impactpath.STATS["sparse_served"] + impactpath.STATS[
        "sparse_escalated"]
    want = ref.search("s", body)
    got = port.search("s", body)
    chip_smoke.same_vec(got, want, TOL, name + ": ")
    moved = rung_moves(p0, impactpath.STATS)
    assert moved == rung_moves(r0, rip.stats()), name
    engaged = impactpath.STATS["sparse_served"] + impactpath.STATS[
        "sparse_escalated"] > s0
    if rooted and name not in ("negative weight", "absent tokens"):
        assert engaged, name
        assert got["hits"]["total"]["relation"] == (
            "gte" if "pruned_served" in moved else "eq")
    if not rooted or name == "negative weight":
        assert not engaged, name


def test_sparse_rung_prunes_and_counts_gte(clients):
    """Class (a) skips blocks and serves a lower bound on some body; class
    (b) counts exactly."""
    _ref, port = clients
    impactpath.reset_stats()
    pruned = 0
    for i in range(6):
        exact = port.search("s", {"query": ns(query_tokens(i)),
                                  "track_total_hits": True, "size": 40})
        assert exact["hits"]["total"]["relation"] == "eq"
        for size in (3, 10, 40):
            r = port.search("s", {"query": ns(query_tokens(i)),
                                  "size": size})
            pruned += r["hits"]["total"]["relation"] == "gte"
            assert r["hits"]["total"]["value"] <= exact["hits"]["total"][
                "value"]
            assert r["hits"]["hits"] == exact["hits"]["hits"][:size]
    assert pruned and impactpath.STATS["sparse_blocks_skipped"] > 0
    assert impactpath.STATS["sparse_served"] >= 12


@pytest.mark.parametrize("name,body", general_bodies(),
                         ids=[n for n, _b in general_bodies()])
def test_general_bodies_match_reference(clients, name, body):
    """Classes (c)-(e) and the nodes as filters, named clauses, under a
    sort and aggs."""
    ref, port = clients
    chip_smoke.same_vec(port.search("s", body), ref.search("s", body), TOL,
                        name + ": ")


@pytest.mark.parametrize("name,body", hybrid_bodies(),
                         ids=[n for n, _b in hybrid_bodies()])
def test_hybrid_bodies_match_reference(clients, name, body):
    """Class (f): a match, a neural_sparse and a knn fused (rrf, linear),
    and rank_feature / sparse_vector sub-queries."""
    ref, port = clients
    chip_smoke.same_vec(port.search("s", body), ref.search("s", body),
                        HYBRID_TOL, name + ": ")


def test_msearch_count_explain_profile_match_reference(clients):
    ref, port = clients
    bodies = [b for _n, b, _r in sparse_bodies()[:4]] + [
        b for _n, b in general_bodies()[:3]]
    lines = sum([[{}, b] for b in bodies], [])
    for g, w in zip(port.msearch(lines, index="s")["responses"],
                    ref.msearch(lines, index="s")["responses"]):
        chip_smoke.same_vec(g, w, TOL)
    for q in (ns(query_tokens(3)), rf("pr"), DF):
        assert port.count("s", {"query": q}) == ref.count("s", {"query": q})
        body = {"query": {"bool": {"must": [MATCH], "should": [q]}},
                "explain": True, "size": 3}
        chip_smoke.same_vec(port.search("s", body), ref.search("s", body),
                            TOL)
        for doc in ("d10", "d1500"):
            got = port.explain("s", doc, {"query": q})
            want = ref.explain("s", doc, {"query": q})
            got.pop("took", None)
            want.pop("took", None)
            assert got == want
    from tests.test_torch_body_options import mask_profile
    body = {"profile": True, "size": 4, "query": {"bool": {
        "must": [ns(query_tokens(4))], "should": [rf("emb.t9"), DF]}}}
    chip_smoke.same_vec(mask_profile(port.search("s", body)),
                        mask_profile(ref.search("s", body)), TOL)


# ---------------------------------------------------------------------
# the mapping, feature postings and the FEATURE plane
# ---------------------------------------------------------------------

def _outcome(fn):
    try:
        fn()
        return None
    except Exception as e:        # each package's own error classes
        return (type(e).__name__, str(e))


BAD_MAPPINGS = [
    ("index_impacts on text", {"f": {"type": "text",
                                     "index_impacts": True}}),
    ("index_impacts on rank_feature", {"f": {"type": "rank_feature",
                                             "index_impacts": True}}),
]
BAD_DOCS = [
    ("rank_feature zero", {"pr": 0}),
    ("rank_feature negative", {"pr": -1.5}),
    ("feature not an object", {"emb": 3.0}),
    ("feature weight zero", {"emb": {"a": 0.0}}),
    ("feature weight negative", {"emb": {"a": 1.0, "b": -2}}),
    ("array of feature objects", {"emb": [{"a": 1.0}, {"b": 2.0}]}),
]


@pytest.mark.parametrize("name,props", BAD_MAPPINGS,
                         ids=[n for n, _p in BAD_MAPPINGS])
def test_mapping_errors_match_reference(name, props):
    body = {"mappings": {"properties": props}}
    want = _outcome(lambda: RefClient().indices.create("m", body))
    got = _outcome(lambda: RestClient(device="cpu").indices.create(
        "m", copy.deepcopy(body)))
    assert want is not None and got == want, (want, got)


@pytest.mark.parametrize("name,doc", BAD_DOCS, ids=[n for n, _d in BAD_DOCS])
def test_document_errors_match_reference(name, doc):
    outs = []
    for c in (RefClient(), RestClient(device="cpu")):
        c.indices.create("m", copy.deepcopy(MAPPING))
        outs.append(_outcome(lambda: c.index("m", doc, id="1",
                                             refresh=True)))
    assert outs[0] is not None and outs[1] == outs[0], outs


def test_mapping_round_trip(clients):
    ref, port = clients
    assert port.indices.get_mapping("s") == ref.indices.get_mapping("s")
    ft = port._indices["s"].mappings.resolve_field("emb")
    assert (ft.index_impacts, ft.positive_score_impact) == (True, True)
    ft = port._indices["s"].mappings.resolve_field("prn")
    assert (ft.index_impacts, ft.positive_score_impact) == (False, False)


def _pairs(ref, port, index="s"):
    rsegs = ref.node.indices[index].shards[0].segments
    psegs = port._indices[index].engine.segments
    assert len(rsegs) == len(psegs)
    return list(zip(rsegs, psegs))


def assert_same_plane(rp, pp, what=""):
    if rp is None:
        assert pp is None, what
        return
    assert pp is not None and pp.kind == rp.kind, what
    assert pp.scale == rp.scale and pp.bits == rp.bits, what
    for a in ("q", "block_starts", "block_off", "block_max"):
        got, want = getattr(pp, a), getattr(rp, a)
        assert got.dtype == want.dtype and np.array_equal(got, want), \
            (what, a)


def assert_same_features(ref, port, index="s"):
    for rs, ps in _pairs(ref, port, index):
        for f in ("emb", "sv", "neg"):
            rb, pb = rs.postings[f], ps.postings[f]
            assert pb.feature and pb.vocab == rb.vocab, f
            for a in ("starts", "doc_ids", "tfs"):
                assert np.array_equal(getattr(pb, a), getattr(rb, a)), (f, a)
            assert_same_plane(rb.impact, pb.impact, f)
        assert ps.postings["emb"].impact.kind == "feature"
        assert ps.postings["sv"].impact is None
        for f in ("pr", "prn", "ts"):
            assert np.array_equal(ps.numeric_cols[f].values,
                                  rs.numeric_cols[f].values), f


def test_feature_postings_and_planes_match_reference(clients):
    assert_same_features(*clients)


def _plane_block(weights: np.ndarray):
    """Reference and port PostingsBlocks of one row per chunk of 300."""
    n = len(weights)
    starts = np.unique(np.arange(0, n + 300, 300).clip(max=n)).astype(
        np.int64)
    vocab = [f"f{i}" for i in range(len(starts) - 1)]
    docs = np.concatenate([np.zeros(0, np.int32)] + [
        np.arange(b - a, dtype=np.int32)
        for a, b in zip(starts[:-1], starts[1:])])
    w = np.asarray(weights, np.float32)
    args = (vocab, {t: i for i, t in enumerate(vocab)}, starts, docs, w)
    return (rseg_mod.PostingsBlock("f", *args),
            pseg_mod.PostingsBlock("f", *args, feature=True))


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("on_device", [False, True])
def test_feature_plane_half_step_ties(bits, on_device, monkeypatch):
    """Weights on exact half steps of the scale round half to even; the
    device quantizer (DEVICE_IMPACT_MIN lowered) equals numpy."""
    qmax = (1 << bits) - 1
    scale = 2.0 ** -4
    ties = (np.arange(0, qmax, 7) + 0.5) * scale
    rng = np.random.default_rng(bits)
    w = np.concatenate([ties, rng.exponential(size=700) + 0.05,
                        [qmax * scale]]).astype(np.float32)
    rb, pb = _plane_block(w)
    if on_device:
        monkeypatch.setattr(device_merge, "DEVICE_IMPACT_MIN", 1)
        monkeypatch.setattr(device_merge, "FEATURE_CHUNK", 256)
    want = rseg_mod.build_feature_impact_plane(rb, bits=bits)
    got = pseg_mod.build_feature_impact_plane(pb, bits=bits,
                                              device=torch.device("cpu"))
    assert_same_plane(want, got)
    assert got.scale == float(w.max()) / qmax
    qt = got.q[:len(ties)].astype(np.int64)
    assert np.all(qt % 2 == 0)        # every tie went to the even side


def test_feature_plane_empty_and_zero():
    rb, pb = _plane_block(np.zeros(0, np.float32))
    assert pseg_mod.build_feature_impact_plane(pb) is None
    assert rseg_mod.build_feature_impact_plane(rb) is None


@pytest.mark.parametrize("fn", ["saturation", "log", "sigmoid", "linear"])
@pytest.mark.parametrize("positive", [True, False])
def test_rank_feature_value_matches_reference(fn, positive):
    """The four functions x positive_score_impact over weights across six
    decades: saturation and linear bit-equal; log and sigmoid (the
    library's ln and pow against XLA's) within 1e-6 relative."""
    rng = np.random.default_rng(5)
    w = np.concatenate([rng.lognormal(0, 2, 4000), [1e-3, 1.0, 7.5, 1e3]]
                       ).astype(np.float32)
    p1, p2 = 1.37, 0.61
    want = np.asarray(rops.rank_feature_value(
        jax.numpy.asarray(w), fn, jax.numpy.float32(p1),
        jax.numpy.float32(p2), positive))
    got = ops.rank_feature_value(torch.from_numpy(w), fn, p1, p2,
                                 positive).numpy()
    if fn in ("saturation", "linear"):
        assert got.tobytes() == want.tobytes()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------
# kept reference behaviours (ROADMAP Queue 3)
# ---------------------------------------------------------------------

def test_default_pivot_is_the_arithmetic_mean(clients):
    """The saturation pivot without `pivot`: the arithmetic mean of the
    feature's stored values over every segment, deleted docs included
    (OpenSearch reads an approximate geometric mean)."""
    ref, port = clients
    ctx = port._indices["s"].searcher.context()
    node = C.rewrite(C.dsl.parse_query(rf("emb.t3")), ctx)
    vals = np.concatenate([
        s.postings["emb"].tfs[slice(*s.postings["emb"].row_slice(
            s.postings["emb"].row("t3")))] for s in ctx.segments])
    mean = float(np.mean(vals.astype(np.float64)))
    gmean = float(np.exp(np.mean(np.log(vals.astype(np.float64)))))
    assert node.p1 == pytest.approx(mean, rel=1e-6)
    assert abs(node.p1 - gmean) > 0.05 * mean
    col = np.concatenate([s.numeric_cols["pr"].values[
        s.numeric_cols["pr"].present] for s in ctx.segments])
    node = C.rewrite(C.dsl.parse_query(rf("pr")), ctx)
    assert node.p1 == pytest.approx(float(col.mean()), rel=1e-12)
    body = {"query": {"bool": {"must": [MATCH], "should": [rf("emb.t3")]}}}
    chip_smoke.same_vec(port.search("s", body), ref.search("s", body), TOL)


NEURAL_400 = [
    ("query_text", {"neural_sparse": {"emb": {"query_text": "red fox",
                                              "model_id": "m1"}}}),
    ("empty tokens", {"neural_sparse": {"emb": {"query_tokens": {}}}}),
    ("tokens not a dict", {"neural_sparse": {"emb": {
        "query_tokens": ["a"]}}}),
    ("two fields", {"neural_sparse": {"emb": {"query_tokens": {"a": 1}},
                                      "sv": {"query_tokens": {"a": 1}}}}),
    ("not a feature field", {"neural_sparse": {"body": {
        "query_tokens": {"a": 1}}}}),
    ("rank_feature two functions", {"rank_feature": {
        "field": "pr", "log": {"scaling_factor": 1}, "linear": {}}}),
    ("rank_feature log without scaling", {"rank_feature": {
        "field": "pr", "log": {}}}),
    ("rank_feature sigmoid without exponent", {"rank_feature": {
        "field": "pr", "sigmoid": {"pivot": 1}}}),
    ("rank_feature unknown field", {"rank_feature": {"field": "nope"}}),
    ("rank_feature text field", {"rank_feature": {"field": "body"}}),
    ("rank_feature log on negative impact", {"rank_feature": {
        "field": "prn", "log": {"scaling_factor": 1}}}),
    ("rank_feature linear on negative impact", {"rank_feature": {
        "field": "neg.t1", "linear": {}}}),
    ("distance_feature without pivot", {"distance_feature": {
        "field": "ts", "origin": "now"}}),
    ("distance_feature unknown field", {"distance_feature": {
        "field": "nope", "origin": 1, "pivot": "1d"}}),
    ("distance_feature keyword", {"distance_feature": {
        "field": "st", "origin": 1, "pivot": "1d"}}),
    ("distance_feature rank_feature", {"distance_feature": {
        "field": "pr", "origin": 1, "pivot": "1d"}}),
]


@pytest.mark.parametrize("name,query", NEURAL_400,
                         ids=[n for n, _q in NEURAL_400])
def test_query_400s_match_reference(clients, name, query):
    """neural_sparse takes raw query_tokens only (a query_text / model_id
    body is the reference's 400); the parse and rewrite errors of the
    three kinds are the reference's."""
    ref, port = clients
    outs = [_outcome(lambda: c.search("s", {"query": query}))
            for c in (ref, port)]
    assert outs[0] is not None and outs[1] == outs[0], outs


def test_distance_feature_keeps_the_f32_split(clients):
    """The distance is the reference's f32 form over the biased (hi, lo)
    words, |f32(hi - ohi) 2^32 + (f32(lo) - f32(olo))|: at epoch-ms
    dates the low word rounds to 128 ms or coarser, so the scores differ
    from an exact i64 difference, equal to the reference's."""
    ref, port = clients
    origin = TS0 + 200 * 86_400_000 + 77
    body = {"query": {"distance_feature": {"field": "ts", "origin": origin,
                                           "pivot": "1h"}}, "size": 50}
    got, want = port.search("s", body), ref.search("s", body)
    assert got["hits"]["hits"] == want["hits"]["hits"]
    seg = port._indices["s"].engine.segments[0]
    ts = seg.numeric_cols["ts"].values
    hi, lo = ts >> 32, (ts & 0xFFFFFFFF) - (1 << 31)
    ohi, olo = origin >> 32, (origin & 0xFFFFFFFF) - (1 << 31)
    f32 = np.abs((hi - ohi).astype(np.float32) * np.float32(2 ** 32)
                 + (lo.astype(np.float32) - np.float32(olo)))
    exact = np.abs(ts - origin).astype(np.float64)
    assert np.any(f32.astype(np.float64) != exact)
    pv = np.float32(3_600_000)
    by_id = {h["_id"]: h["_score"] for h in got["hits"]["hits"]}
    for d in range(seg.ndocs):
        sid = seg.ids[d]
        if sid in by_id:
            assert by_id[sid] == float(pv / (pv + f32[d]))


# ---------------------------------------------------------------------
# merge, flush and recovery, convert
# ---------------------------------------------------------------------

def test_forcemerge_rebuilds_the_feature_plane(docs):
    ref, port = fill(ref_client(), docs), fill(RestClient(device="cpu"), docs)
    for c in (ref, port):
        c.indices.forcemerge("s", max_num_segments=1)
    assert len(port._indices["s"].engine.segments) == 1
    assert_same_features(ref, port)
    for name, body, _r in sparse_bodies()[:6] + [
            ("d", general_bodies()[0][1], None)]:
        chip_smoke.same_vec(port.search("s", body), ref.search("s", body),
                            TOL, name + ": ")


@pytest.mark.parametrize("deletes", [True, False])
def test_merge_of_fields_one_segment_holds(docs, deletes):
    """A field that one input holds (a feature field and a positional
    text field only the first segment has) merges without the sort:
    postings, positions and planes equal to the reference's merge; the
    body field, in both inputs, takes the sort."""
    mapping = {"settings": {"number_of_replicas": 0}, "mappings": {
        "properties": {"body": {"type": "text"}, "title": {"type": "text"},
                       "emb": {"type": "rank_features",
                               "index_impacts": True}}}}
    pair = []
    for c in (ref_client(), RestClient(device="cpu")):
        c.indices.create("o", copy.deepcopy(mapping))
        c.bulk(sum([[{"index": {"_index": "o", "_id": f"d{i}"}},
                     {"body": d["body"], "emb": d["emb"],
                      "title": d["body"] + " moon"}]
                    for i, d in enumerate(docs[:500])], []), refresh=True)
        c.bulk(sum([[{"index": {"_index": "o", "_id": f"e{i}"}},
                     {"body": d["body"]}]
                    for i, d in enumerate(docs[500:700])], []),
               refresh=True)
        if deletes:
            c.bulk([{"delete": {"_index": "o", "_id": f"d{i}"}}
                    for i in (3, 40, 41, 250)], refresh=True)
        c.indices.forcemerge("o", max_num_segments=1)
        pair.append(c)
    (rs, ps), = _pairs(*pair, index="o")
    for f in ("emb", "title", "body"):
        rb, pb = rs.postings[f], ps.postings[f]
        assert pb.vocab == rb.vocab, f
        for a in ("starts", "doc_ids", "tfs", "pos_starts", "positions"):
            want = getattr(rb, a)
            got = getattr(pb, a)
            if a.startswith("pos") and f == "emb":
                continue
            assert np.array_equal(got, want), (f, a)
        assert_same_plane(rb.impact, pb.impact, f) if f == "emb" else None
    chip_smoke.same_vec(pair[1].search("o", {"query": ns({"t0": 1.0})}),
                        pair[0].search("o", {"query": ns({"t0": 1.0})}), TOL)


def test_flush_and_recovery_keep_the_feature_plane(docs, tmp_path):
    port = fill(RestClient(device="cpu", data_path=str(tmp_path)), docs)
    port.indices.flush("s")
    before = [port.search("s", b) for _n, b, _r in sparse_bodies()[:4]]
    segs = port._indices["s"].engine.segments
    port.close()
    back = RestClient(device="cpu", data_path=str(tmp_path))
    for s0, s1 in zip(segs, back._indices["s"].engine.segments):
        for f in ("emb", "sv"):
            assert s1.postings[f].feature
            assert_same_plane(s0.postings[f].impact, s1.postings[f].impact)
    for b, (_n, body, _r) in zip(before, sparse_bodies()[:4]):
        chip_smoke.same_vec(back.search("s", body), b, (0.0, 0.0, 0.0))
    ft = back._indices["s"].mappings.resolve_field("emb")
    assert ft.index_impacts and ft.type == "rank_features"


def test_convert_carries_feature_postings_and_planes(clients):
    ref, port = clients
    segs = []
    for i, (rs, _ps) in enumerate(_pairs(ref, port)):
        postings = {f: {"vocab": pb.vocab, "starts": pb.starts,
                        "doc_ids": pb.doc_ids, "tfs": pb.tfs,
                        "feature": f in ("emb", "sv", "neg")}
                    for f, pb in rs.postings.items()}
        impacts = {f: {**{k: getattr(pb.impact, k)
                          for k in ("q", "scale", "bits", "k1", "b", "avgdl",
                                    "dl_max", "block_starts", "block_off",
                                    "block_max")}, "kind": pb.impact.kind}
                   for f, pb in rs.postings.items() if pb.impact is not None}
        seg = segment_from_arrays(
            f"_{i}", rs.ndocs, postings, rs.doc_lens,
            {f: (s.doc_count, s.sum_dl) for f, s in rs.text_stats.items()},
            list(rs.ids), list(rs.sources), live=rs.live, impacts=impacts,
            numeric_cols=rs.numeric_cols, keyword_cols=rs.keyword_cols)
        assert seg.postings["emb"].impact.kind == "feature"
        segs.append(seg)
    conv = RestClient(device="cpu")
    conv.indices.create("s", copy.deepcopy(MAPPING))
    conv._indices["s"].engine.segments = segs
    for name, body, _r in sparse_bodies()[:4]:
        chip_smoke.same_vec(conv.search("s", body), ref.search("s", body),
                            TOL, name + ": ")
    # without the planes: built here for the fields that ask for one
    pb = segs[0].postings["emb"]
    again = segment_from_arrays(
        "_x", 4, {"emb": {"vocab": pb.vocab[:0], "starts": [0],
                          "doc_ids": [], "tfs": [], "feature": True,
                          "index_impacts": True}}, {}, {}, ["a"] * 4,
        [{}] * 4)
    assert again.postings["emb"].feature


def test_still_unported_kinds_raise(clients):
    """percolate and more_like_this serve since they were ported: on this
    index (no percolator field) the reference's 400 and its page."""
    ref, port = clients
    outs = []
    for q in ({"percolate": {"field": "q", "document": {}}},
              {"more_like_this": {"like": "fox", "min_term_freq": 1}}):
        got = []
        for c in (ref, port):
            try:
                got.append(c.search("s", {"query": q}))
            except Exception as e:      # each package's own ApiError
                got.append((e.status, e.err_type, e.reason))
        if isinstance(got[0], tuple):
            assert got[0] == got[1], (q, got)
        else:
            same(got[1], got[0])
        outs.append(got[0])
    assert outs[0][0] == 400


def test_engine_refresh_builds_feature_planes_on_device_path(monkeypatch):
    """A refresh past DEVICE_IMPACT_MIN postings quantizes the FEATURE
    plane with the torch quantizer: equal to the reference's plane."""
    monkeypatch.setattr(device_merge, "DEVICE_IMPACT_MIN", 64)
    docs = make_docs()[:300]
    ref = ref_client()
    port = RestClient(device="cpu")
    for c in (ref, port):
        c.indices.create("s", copy.deepcopy(MAPPING))
        c.bulk(sum([[{"index": {"_index": "s", "_id": f"d{i}"}}, d]
                    for i, d in enumerate(docs)], []), refresh=True)
    (rs, ps), = _pairs(ref, port)
    assert_same_plane(rs.postings["emb"].impact, ps.postings["emb"].impact)


# ---------------------------------------------------------------------
# chip_smoke's phase 4 (sparse, small) and phase 17 on the CPU
# ---------------------------------------------------------------------

def test_phase4_sparse_small_on_the_cpu():
    """Phase 4's sparse index run on the CPU: its FEATURE planes (the
    first segment's through the torch quantizer) against their numpy
    form, the bodies before and after the forcemerge, the sparse rung
    served and skipping blocks."""
    rng = np.random.default_rng([0, 10])
    docs = chip_smoke.sp_small_docs(rng, 7000)
    bodies = chip_smoke.sp_small_bodies(rng)
    before, after, stats = chip_smoke.run_sparse_small("cpu", docs, bodies)
    assert len(before) == len(after) == len(bodies)
    assert stats["sparse_served"] and stats["sparse_blocks_skipped"]
    # the merge drops the deleted docs: the exact totals stay
    exact = [i for i, b in enumerate(bodies) if b.get("track_total_hits")]
    for i in exact:
        assert before[i]["hits"]["total"] == after[i]["hits"]["total"]


def test_sparse_draw_and_csr():
    """Phase 17's draw: 64 distinct tokens a passage in [0, SP_VOCAB),
    weights on the 3-place grid from 0.05 up, head tokens in most
    passages; the CSR's rows ascending by token, docs ascending in a
    row; the same seed draws the same bits."""
    dev = torch.device("cpu")
    tok, w, pr = chip_smoke.sparse_draw(3000, 5, dev)
    t = tok.long().numpy()
    assert t.shape == (3000, 64) and t.min() >= 0
    assert t.max() < chip_smoke.SP_VOCAB
    assert all(len(set(r)) == 64 for r in t)
    wn = w.numpy().astype(np.float64)
    assert wn.min() >= 0.05 and np.allclose(np.round(wn * 1000), wn * 1000,
                                            atol=1e-3)
    assert (t == 0).any(1).mean() > 0.9 and pr.min() > 0
    ids, starts, docs, weights = chip_smoke.sparse_csr(tok, w)
    assert np.all(np.diff(ids) > 0) and starts[-1] == 3000 * 64
    for r in range(0, len(ids), 97):
        d = docs[starts[r]:starts[r + 1]]
        assert np.all(np.diff(d) > 0)
        assert np.all(t[d] == ids[r], axis=None) is not None
        np.testing.assert_array_equal(
            weights[starts[r]:starts[r + 1]],
            w.numpy()[d, np.argmax(t[d] == ids[r], axis=1)])
    tok2, w2, _ = chip_smoke.sparse_draw(3000, 5, dev)
    assert torch.equal(tok, tok2) and torch.equal(w, w2)


def test_phase17_brute_force_matches_pages(bench_small):
    """Phase 17's classes over the bench corpus segment with deletes and
    the re-indexed docs' segment (no features there): `emb` and
    `pagerank` drawn and attached as phase 17 does, the 768-dim vectors
    as phase 16 does; every page of the port against SparseOracle."""
    from opensearch_tpu_torch import bench_corpus as bc
    from opensearch_tpu_torch.index.segment import VectorColumn
    _ref, _port, _ix, port2, ix2, big = bench_small
    seg = big["seg"]
    n0 = seg.ndocs
    dev = torch.device("cpu")
    vecs, _which = chip_smoke.make_vectors(n0, 5, dev)
    port2.indices.put_mapping("bench", chip_smoke.VEC_PUT_MAPPING)
    ft = port2._indices["bench"].engine.mappings.resolve_field("vec")
    seg.vector_cols["vec"] = VectorColumn("vec", vecs, np.ones(n0, bool),
                                          ft.vector_similarity,
                                          method=ft.vector_method)
    q = bc.pick_queries(big["corpus"][4], 8, seed=3)
    sbig = dict(big, client=port2, ix=ix2,
                body_terms=[t for i in range(8)
                            for t in (list(q[i][:2]), list(q[i]))])
    att = chip_smoke.sp_attach(sbig, 5)
    arrays = att.pop("arrays")
    pb = seg.postings["emb"]
    assert pb.feature and pb.impact.kind == "feature"
    chip_smoke.sp_plane_check(pb, "rehearsal")
    chip_smoke.sp_plane_check(pb, "rehearsal rows", rows=[0, 1, 77, 3000])
    q_saved = pb.impact.q.copy()
    pb.impact.q[pb.row_slice(77)[0]] += 1
    with pytest.raises(AssertionError):
        chip_smoke.sp_plane_check(pb, "a broken row", rows=[5, 77])
    pb.impact.q[:] = q_saved
    oracle = chip_smoke.sp_oracle(sbig, arrays)
    vec_oracle = chip_smoke.VecOracle(vecs, ix2, dev)
    n = 4
    vq = chip_smoke.vec_query_vectors(vecs, ix2.live[:n0], n, 6)
    classes = chip_smoke.sp_classes(sbig, n, np.random.default_rng(17), vq)
    hyb = [s for _b, s in classes["f_hybrid"]]
    for s, top in zip(hyb, vec_oracle.top([(s["q"], None, 50)
                                           for s in hyb])):
        s["knn_top"] = top
    impactpath.reset_stats()
    for name, items in classes.items():
        for j, (body, spec) in enumerate(items):
            resp = port2.search("bench", body)
            chip_smoke.sp_check(resp, chip_smoke.sp_want(
                oracle, ix2, body, spec, vec_oracle), spec, f"{name} {j}")
    assert impactpath.STATS["sparse_served"] >= 2 * n


def test_host_draws_thread_equals_the_corpus_functions():
    """chip_smoke's HostDraws (phase 5's host draws on a thread beside
    phases 1-4) yield what bench_corpus's functions yield when called in
    turn: the same corpus from its keys, title corpus and columns."""
    from opensearch_tpu_torch import bench_corpus as bc
    draws = chip_smoke.HostDraws(3000)
    keys, columns, aggcols, title, _t1, _t2 = draws.get()
    got = bc.build_corpus(3000, draws=keys)
    for g, w in zip(got, bc.build_corpus(3000)):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    for g, w in zip(columns + aggcols + title,
                    bc.guardrail_columns(3000) + bc.agg_columns(3000)
                    + bc.build_title_corpus(3000)):
        assert np.array_equal(g, w)
    broken = chip_smoke.HostDraws(-1)
    with pytest.raises(ValueError):
        broken.get()
