"""Dense vectors and kNN search in the port against the JAX package on
the CPU.

- The same seeded documents (numpy seed 15: 240 docs, 10 clustered
  centres in 16 dimensions, every eleventh doc without vectors) in two
  segments, the first with deletes, through both packages' RestClient:
  three vector fields, `cos` (cosine, IVF with the default nlist and
  nprobe), `dot` (dot_product, the exact scan) and `l2` (l2_norm, IVF
  nlist 6, nprobe 2).
- Responses are equal apart from `took` (`chip_smoke.same_vec`), with
  scores within 1e-6 relative; an `l2` score S = 1 / (1 + d2) within the
  rounding of the reference's own expansion d2 = |v|^2 + |q|^2 - 2 v.q,
  whose terms cancel: S^2 times 4 ulp of |v|^2 + |q|^2 at the largest row
  norm, plus 1e-6 relative (`chip_smoke.l2_tolerance`). Hits whose
  reference scores lie within that tolerance of each other may come in
  either order (the products sum in another order than XLA's).
- The IVF lists and centroids equal the reference's `build_ivf` on the
  same matrix (`chip_smoke.ivf_lists_agree`), but where a row's two
  nearest centroids are within 1e-6 relative of each other (none on
  these data), and where two rows of one list are as near its centroid
  within 1e-6 relative (their slots may swap: one pair here).
"""

import copy

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from opensearch_tpu.ops.ann import build_ivf as ref_build_ivf
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu_torch import RestClient
from opensearch_tpu_torch.index.convert import segment_from_arrays
from opensearch_tpu_torch.ops import ann, knn as knn_ops

jax.config.update("jax_platforms", "cpu")

RTOL = 1e-6
NDOCS = 240
DIMS = 16
FIELDS = ("cos", "dot", "l2")
MAPPING = {"settings": {"number_of_replicas": 0}, "mappings": {"properties": {
    "cos": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine",
            "method": {"name": "ivf"}},
    "dot": {"type": "knn_vector", "dimension": DIMS,
            "space_type": "dot_product", "method": {"name": "flat"}},
    "l2": {"type": "dense_vector", "dims": DIMS, "similarity": "l2_norm",
           "index_options": {"type": "ivf",
                             "parameters": {"nlist": 6, "nprobe": 2}}},
    "body": {"type": "text"}, "tag": {"type": "keyword"},
    "price": {"type": "integer"}}}}
DELETED = ("d3", "d17", "d40", "d41", "d99")
WORDS = ["red", "fox", "dog", "tree", "blue", "quick", "lazy", "moon"]


def clustered(rng, n: int, d: int, ncenters: int = 10) -> np.ndarray:
    centers = rng.normal(size=(ncenters, d)).astype(np.float32) * 2.0
    return (centers[rng.integers(0, ncenters, n)]
            + rng.normal(size=(n, d)).astype(np.float32) * 0.4
            ).astype(np.float32)


def make_docs():
    rng = np.random.default_rng(15)
    vecs = {f: clustered(rng, NDOCS, DIMS) for f in FIELDS}
    docs = []
    for i in range(NDOCS):
        doc = {"body": " ".join(rng.choice(WORDS, int(rng.integers(2, 6)))),
               "tag": "abc"[i % 3], "price": int(rng.integers(100))}
        if i % 11:
            for f in FIELDS:
                doc[f] = vecs[f][i].tolist()
        docs.append(doc)
    return docs, vecs


def fill(c, docs, lo=0, hi=NDOCS):
    """Two segments (160 and 80 docs); the first loses DELETED."""
    c.indices.create("v", copy.deepcopy(MAPPING))
    for a, b in ((lo, 160), (160, hi)):
        c.bulk(sum([[{"index": {"_index": "v", "_id": f"d{i}"}}, docs[i]]
                    for i in range(a, b)], []), refresh=True)
    c.bulk([{"delete": {"_index": "v", "_id": d}} for d in DELETED],
           refresh=True)
    return c


@pytest.fixture(scope="module")
def data():
    return make_docs()


@pytest.fixture(scope="module")
def clients(data):
    docs, _ = data
    ref, port = fill(RefClient(), docs), fill(RestClient(device="cpu"), docs)
    assert len(port._indices["v"].engine.segments) == 2
    return ref, port


def qvec(vecs, field: str, i: int, scale: float = 0.05) -> list:
    rng = np.random.default_rng(100 + i)
    return (vecs[field][i] + rng.normal(size=DIMS).astype(np.float32)
            * scale).tolist()


def tolerance(field: str, vecs, q) -> tuple:
    """A body's score tolerance (`chip_smoke.vec_close`): 1e-6 relative;
    on `l2`, the expansion's rounding at the largest row norm."""
    if field != "l2":
        return RTOL, 0.0, 0.0
    vmax = float((vecs["l2"].astype(np.float64) ** 2).sum(1).max())
    return chip_smoke.l2_tolerance(vmax, q)


def same(got, want, tol=(RTOL, 0.0, 0.0), path="") -> None:
    chip_smoke.same_vec(got, want, tol, path)


def knn(field, vector, **kw):
    return {"knn": {field: dict(vector=vector, **kw)}}


def bodies_for(field: str, vecs) -> list:
    q = qvec(vecs, field, 7)
    q2 = qvec(vecs, field, 150, 0.3)
    return [
        ("default", {"size": 10, "query": knn(field, q, k=10)}),
        ("exact", {"size": 10, "query": knn(field, q, k=10, exact=True)}),
        ("nprobe 1", {"size": 8, "query": knn(field, q2, k=8,
                                               method_parameters={
                                                   "nprobe": 1})}),
        ("filter term", {"size": 10, "query": knn(
            field, q2, k=10, filter={"term": {"tag": "b"}})}),
        ("filter range", {"size": 10, "query": knn(
            field, q, k=10, filter={"range": {"price": {"gte": 30,
                                                        "lt": 70}}})}),
        ("bool must + filter", {"size": 10, "query": {"bool": {
            "must": [knn(field, q2)],
            "filter": [{"term": {"tag": "a"}}]}}}),
        ("bool should match + knn", {"size": 10, "query": {"bool": {
            "should": [{"match": {"body": "fox"}}, knn(field, q)]}}}),
        ("knn in filter context", {"size": 10, "query": {"bool": {
            "must": [{"match": {"body": "fox tree"}}],
            "filter": [knn(field, q2, filter={"range": {
                "price": {"gte": 20}}})]}}}),
        ("constant_score knn", {"size": 10, "query": {"constant_score": {
            "filter": knn(field, q), "boost": 2.5}}}),
        ("boost and name", {"size": 10, "query": knn(
            field, q, boost=3.0, _name="near")}),
        ("from", {"from": 5, "size": 7, "query": knn(field, q2)}),
        ("sorted", {"size": 10, "sort": [{"price": "desc"}],
                    "query": knn(field, q)}),
        ("aggs", {"size": 3, "query": knn(field, q),
                  "aggs": {"t": {"terms": {"field": "tag"}},
                           "p": {"avg": {"field": "price"}}}}),
        ("long vector", {"size": 6, "query": knn(field, q + [0.5, -2.0])}),
        ("body section", {"size": 10, "knn": {"field": field,
                                              "query_vector": q, "k": 10}}),
        ("body section + query", {"size": 10, "query": {"match": {
            "body": "red moon"}}, "knn": {"field": field,
                                          "query_vector": q2, "k": 5,
                                          "boost": 2.0,
                                          "filter": {"term": {"tag": "c"}}}}),
        ("body section nprobe", {"size": 10, "knn": {
            "field": field, "query_vector": q2, "k": 10,
            "method_parameters": {"nprobe": 3}}}),
        ("source excludes", {"size": 5, "_source": {"excludes": [field]},
                             "query": knn(field, q)}),
    ]


BODY_NAMES = [n for n, _ in bodies_for("cos", {f: np.zeros((NDOCS, DIMS),
                                                           np.float32)
                                               for f in FIELDS})]


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("name", BODY_NAMES)
def test_knn_bodies_match_reference(clients, data, field, name):
    ref, port = clients
    _, vecs = data
    body = dict(bodies_for(field, vecs))[name]
    q = (body.get("query") or {}).get("knn", {}).get(field, {}).get(
        "vector") or qvec(vecs, field, 7)
    want = ref.search("v", body)
    same(port.search("v", body), want, tolerance(field, vecs, q), name)
    assert want["hits"]["hits"], name


def test_msearch_with_knn_bodies_matches_reference(clients, data):
    ref, port = clients
    _, vecs = data
    items = [b for f in FIELDS for _n, b in bodies_for(f, vecs)[:6]]
    items.append({"query": {"knn": {"cos": {"vector": [1.0] * DIMS}},
                            "bogus": 1}})
    lines = sum([[{}, b] for b in items], [])
    got = port.msearch(lines, index="v")["responses"]
    want = ref.msearch(lines, index="v")["responses"]
    for i, (g, w) in enumerate(zip(got, want)):
        same(g, w, tolerance("l2", vecs, [0.0] * DIMS), f"{i}: ")


def test_k_is_not_enforced(clients, data):
    """The reference never reads `k`: a knn query matches every live doc
    with a vector (here 240 docs less 22 without one less 5 deleted, of
    which d99 has no vector: 214), and a page of 5 follows from `size`."""
    ref, port = clients
    docs, vecs = data
    body = {"size": 5, "query": knn("dot", qvec(vecs, "dot", 2), k=3)}
    got, want = port.search("v", body), ref.search("v", body)
    n_vec = sum(1 for i, d in enumerate(docs)
                if "dot" in d and f"d{i}" not in DELETED)
    assert got["hits"]["total"] == want["hits"]["total"] == {
        "value": n_vec, "relation": "eq"}
    assert len(got["hits"]["hits"]) == 5
    same(got, want)


def test_exists_on_a_vector_field_matches_no_doc(clients):
    """The reference's `exists` reads the numeric, keyword and doc-length
    columns only: on a vector field it matches nothing, in a query and as
    a filter; the port serves the same page."""
    ref, port = clients
    for body in ({"query": {"exists": {"field": "cos"}}},
                 {"query": {"bool": {"must": [{"match": {"body": "fox"}}],
                                     "filter": [{"exists": {
                                         "field": "l2"}}]}}}):
        got, want = port.search("v", body), ref.search("v", body)
        assert want["hits"]["total"]["value"] == 0
        same(got, want)


def test_unmapped_and_missing_fields(clients, data):
    ref, port = clients
    for body in ({"query": knn("nope", [1.0] * DIMS)},
                 {"query": knn("body", [1.0] * DIMS)}):
        same(port.search("v", body), ref.search("v", body))


def test_a_short_query_vector_raises_the_reference_error(clients):
    ref, port = clients
    body = {"query": knn("dot", [1.0] * (DIMS - 3))}
    errs = []
    for c in (ref, port):
        with pytest.raises(ValueError) as e:
            c.search("v", body)
        errs.append(str(e.value))
    assert errs[0] == errs[1], errs


def test_full_probe_equals_the_scan(clients, data):
    """nprobe = nlist probes every list: the same page as exact."""
    _ref, port = clients
    _, vecs = data
    for field in ("cos", "l2"):
        for i in (5, 70, 200):
            q = qvec(vecs, field, i)
            ex = port.search("v", {"size": 20, "query": knn(
                field, q, exact=True)})
            full = port.search("v", {"size": 20, "query": knn(
                field, q, nprobe=10_000)})
            same(full, ex, tolerance(field, vecs, q))


def test_mapping_errors_match_reference():
    for mapping, doc in (
            ({"e": {"type": "dense_vector", "dims": 2,
                    "method": {"name": "hnsw"}}}, None),
            ({"e": {"type": "dense_vector", "dims": 2}}, {"e": [1, 2, 3]}),
            ({"e": {"type": "knn_vector", "dimension": 3}}, {"e": [1.0]})):
        errs = []
        for c in (RefClient(), RestClient(device="cpu")):
            try:
                c.indices.create("x", {"mappings": {"properties": mapping}})
                c.index("x", doc, id="1")
                errs.append(None)
            except Exception as e:   # the two clients' own classes
                errs.append((type(e).__name__, str(e)))
        assert errs[0] is not None and errs[0] == errs[1], errs


def test_vector_parse_and_field_caps(clients):
    ref, port = clients
    assert port.field_caps("v", "*") == ref.field_caps("v", "*")
    assert port.indices.get_mapping("v") == ref.indices.get_mapping("v")
    seg = port._indices["v"].engine.segments[0]
    col = seg.vector_cols["l2"]
    assert col.values.dtype == np.float32 and col.values.shape == (160, DIMS)
    assert col.similarity == "l2_norm"
    assert col.method == {"name": "ivf", "nlist": 6, "nprobe": 2}
    assert seg.vector_cols["dot"].method is None
    assert seg.vector_cols["cos"].method == {"name": "ivf", "nlist": None,
                                             "nprobe": None}
    assert not col.present[0] and col.present[1]


def test_explain_matches_reference(clients, data):
    ref, port = clients
    _, vecs = data
    q = qvec(vecs, "cos", 9)
    body = {"size": 4, "explain": True, "query": {"bool": {"should": [
        {"match": {"body": "fox"}}, knn("cos", q)]}}}
    same(port.search("v", body), ref.search("v", body))
    for doc_id in ("d9", "d10"):
        same(port.explain("v", doc_id, {"query": knn("cos", q)}),
             ref.explain("v", doc_id, {"query": knn("cos", q)}))


@pytest.mark.parametrize("sim", ["cosine", "dot_product", "l2_norm"])
def test_ivf_lists_match_reference_build_ivf(sim):
    """Lists and centroids against `opensearch_tpu.ops.ann.build_ivf` on
    the same scored matrix (unit-normed for cosine), with default and
    explicit nlist / nprobe and absent rows."""
    rng = np.random.default_rng(21)
    v = clustered(rng, 600, 24, 14)
    if sim == "cosine":
        v = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    pres = np.ones(600, bool)
    pres[::13] = False
    swapped = 0
    for nlist, nprobe in ((None, None), (20, 5), (40, None)):
        want = ref_build_ivf(v, pres, nlist=nlist, nprobe=nprobe)
        got = ann.build_ivf(torch.from_numpy(v), pres, nlist=nlist,
                            nprobe=nprobe)
        assert (got.nlist, got.cap, got.default_nprobe) == (
            want.nlist, want.cap, want.default_nprobe)
        np.testing.assert_allclose(got.centroids, want.centroids,
                                   rtol=1e-5, atol=1e-6)
        swapped += chip_smoke.ivf_lists_agree(got.lists, want.lists, v,
                                              want.centroids)
        flat = got.lists.reshape(-1)
        assert sorted(flat[flat >= 0].tolist()) == np.nonzero(pres)[0].tolist()
    # a slot pair of equally near rows swaps at cosine (rows 93, 118)
    assert swapped <= 4
    assert ann.build_ivf(torch.zeros((5, 8)), np.zeros(5, bool)) is None


def test_probe_ties_break_to_the_lower_list():
    cents = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.5, 0.5],
                          [1.0, 0.0]])
    q = torch.tensor([1.0, 0.0])
    got = knn_ops.probe_lists(cents, q, 4, "dot_product").tolist()
    assert got == [0, 2, 4, 3]
    got = jax.lax.top_k(jax.numpy.asarray(cents.numpy() @ q.numpy()), 4)[1]
    assert np.asarray(got).tolist() == [0, 2, 4, 3]


def test_vectors_through_merge_flush_and_recovery(data, tmp_path):
    """A forcemerge (deleted rows dropped, the IVF rebuilt on the merged
    segment), then a flush and a recovery: the same pages as the
    reference's at each step."""
    docs, vecs = data
    ref = fill(RefClient(data_path=str(tmp_path / "ref")), docs)
    port = fill(RestClient(device="cpu", data_path=str(tmp_path / "port")),
                docs)
    bodies = [b for f in FIELDS for n, b in bodies_for(f, vecs)
              if n in ("default", "filter term", "body section")]
    for c in (ref, port):
        c.indices.forcemerge("v")
    segs = port._indices["v"].engine.segments
    assert len(segs) == 1 and segs[0].vector_cols["cos"].ivf is None
    for i, b in enumerate(bodies):
        same(port.search("v", b), ref.search("v", b),
             tolerance("l2", vecs, [0.0] * DIMS), f"merged {i}: ")
    for c in (ref, port):
        c.indices.flush("v")
        c.close() if hasattr(c, "close") else None
    port2 = RestClient(device="cpu", data_path=str(tmp_path / "port"))
    col = port2._indices["v"].engine.segments[0].vector_cols["l2"]
    assert col.method == {"name": "ivf", "nlist": 6, "nprobe": 2}
    for i, b in enumerate(bodies):
        same(port2.search("v", b), port.search("v", b),
             (0.0, 0.0, 0.0), f"recovered {i}: ")


def test_tiered_merge_of_segments_with_and_without_vectors(data):
    docs, vecs = data
    mixed = [dict(d) for d in docs[:60]]
    for d in mixed[::2]:
        for f in FIELDS:
            d.pop(f, None)
    out = []
    for c in (RefClient(), RestClient(device="cpu")):
        c.indices.create("m", copy.deepcopy(MAPPING))
        for lo in range(0, 60, 20):
            c.bulk(sum([[{"index": {"_index": "m", "_id": f"d{i}"}},
                         mixed[i]] for i in range(lo, lo + 20)], []),
                   refresh=True)
        c.indices.forcemerge("m")
        out.append(c.search("m", {"size": 12, "query": knn(
            "dot", qvec(vecs, "dot", 13))}))
    same(out[1], out[0])
    assert out[0]["hits"]["total"]["value"] == sum(
        1 for d in mixed if "dot" in d)


def test_convert_carries_vector_columns(clients, data):
    """A reference segment's vector columns through
    `segment_from_arrays`: the same pages as the reference's segment."""
    ref, _port = clients
    _, vecs = data
    rseg = ref.node.get_index("v").shards[0].segments[1]
    seg = segment_from_arrays(
        "c", rseg.ndocs,
        {f: {"vocab": pb.vocab, "starts": pb.starts, "doc_ids": pb.doc_ids,
             "tfs": pb.tfs} for f, pb in rseg.postings.items()},
        rseg.doc_lens, {f: (st.doc_count, st.sum_dl)
                        for f, st in rseg.text_stats.items()},
        list(rseg.ids), list(rseg.sources), numeric_cols=rseg.numeric_cols,
        keyword_cols=rseg.keyword_cols, vector_cols=rseg.vector_cols)
    assert seg.vector_cols["l2"].method == rseg.vector_cols["l2"].method
    port = RestClient(device="cpu")
    port.indices.create("v", copy.deepcopy(MAPPING))
    port._indices["v"].engine.segments = [seg]
    solo = RefClient()
    solo.indices.create("v", copy.deepcopy(MAPPING))
    solo.node.get_index("v").shards[0].segments = [rseg]
    for f in FIELDS:
        for name, body in bodies_for(f, vecs)[:4]:
            if "filter" in name:
                continue
            same(port.search("v", body), solo.search("v", body),
                 tolerance(f, vecs, body["query"]["knn"][f]["vector"]),
                 f"{f} {name}: ")


def test_device_arrays_and_release(clients):
    _ref, port = clients
    seg = port._indices["v"].engine.segments[0]
    arr = seg.vector_on("cos", torch.device("cpu"))
    norms = torch.linalg.vector_norm(arr["mat"][torch.from_numpy(
        seg.vector_cols["cos"].present)], dim=1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-6)
    assert arr["sq"] is None and seg.vector_on("l2", "cpu")["sq"] is not None
    # a non-cosine matrix on the CPU is the host array itself
    assert seg.vector_on("dot", "cpu")["mat"].data_ptr() == \
        seg.vector_cols["dot"].values.ctypes.data
    assert seg.ivf_on("cos", "cpu") is not None
    assert seg.ivf_on("dot", "cpu") is None
    assert seg.device_nbytes("cpu") > 0
    seg2 = copy.copy(seg)
    seg2.device_arrays = dict(seg.device_arrays)
    seg2.release_device()
    assert seg2.device_arrays == {} and seg.vector_cols["cos"].ivf


def test_unported_feature_kinds_still_raise(clients):
    """The feature kinds serve since learned sparse retrieval was ported:
    on this index's fields they are the reference's 400s, and over a
    rank_features / sparse_vector index they serve the reference's
    pages; percolate and more_like_this serve since they were ported (the
    reference's 400 on this index, its page)."""
    ref, port = clients
    for body in ({"query": {"percolate": {"field": "q", "document": {}}}},
                 {"query": {"more_like_this": {"like": "fox",
                                               "min_term_freq": 1}}}):
        outs = []
        for c in (ref, port):
            try:
                outs.append(c.search("v", body))
            except Exception as e:      # each package's own ApiError
                outs.append((e.status, e.err_type, e.reason))
        if isinstance(outs[0], tuple):
            assert outs[0] == outs[1], (body, outs)
        else:
            same(outs[1], outs[0])
    for body in (
            {"query": {"neural_sparse": {"body": {
                "query_tokens": {"fox": 1.0}}}}},
            {"query": {"rank_feature": {"field": "f"}}},
            {"query": {"distance_feature": {
                "field": "price", "origin": 1, "pivot": 2}}}):
        outs = []
        for c in (ref, port):
            try:
                c.search("v", body)
                outs.append(None)
            except Exception as e:      # each package's own ApiError
                outs.append((type(e).__name__, getattr(e, "status", None),
                             str(e)))
        assert outs[0] is not None and outs[0][1] == 400 \
            and outs[1] == outs[0], outs
    docs = [{"f": {"fox": 1.5, "dog": 0.25}, "g": {"tree": 2.0},
             "r": 3.0, "t": "2024-03-0%d" % (1 + i % 9)}
            for i in range(40)]
    mapping = {"mappings": {"properties": {
        "f": {"type": "rank_features", "index_impacts": True},
        "g": {"type": "sparse_vector"}, "r": {"type": "rank_feature"},
        "t": {"type": "date"}}}}
    got = []
    for c in (RefClient(), RestClient(device="cpu")):
        c.indices.create("f", copy.deepcopy(mapping))
        c.bulk(sum([[{"index": {"_index": "f", "_id": str(i)}}, d]
                    for i, d in enumerate(docs)], []), refresh=True)
        got.append([c.search("f", {"query": q}) for q in (
            {"neural_sparse": {"f": {"query_tokens": {"fox": 2.0}}}},
            {"neural_sparse": {"g": {"query_tokens": {"tree": 1.0}}}},
            {"rank_feature": {"field": "f.dog", "log": {
                "scaling_factor": 1.5}}},
            {"rank_feature": {"field": "r"}},
            {"distance_feature": {"field": "t", "origin": "2024-03-05",
                                  "pivot": "2d"}})])
    for w, g in zip(*got):
        same(g, w)


def test_similarity_names_outside_the_three_score_as_l2():
    """The reference reads `similarity` / `space_type` as given: any name
    but cosine, dot_product and innerproduct scores as L2 (OpenSearch's
    `cosinesimil` among them), and only `cosine` normalizes the query;
    the port serves the same pages."""
    rng = np.random.default_rng(4)
    v = rng.normal(size=(40, 4)).astype(np.float32)
    out = []
    for c in (RefClient(), RestClient(device="cpu")):
        c.indices.create("s", {"mappings": {"properties": {
            "a": {"type": "knn_vector", "dimension": 4,
                  "space_type": "cosinesimil"},
            "b": {"type": "knn_vector", "dimension": 4,
                  "space_type": "innerproduct"}}}})
        c.bulk(sum([[{"index": {"_index": "s", "_id": str(i)}},
                     {"a": v[i].tolist(), "b": v[i].tolist()}]
                    for i in range(40)], []), refresh=True)
        out.append([c.search("s", {"size": 5, "query": knn(
            f, [1.0, -2.0, 0.5, 3.0])}) for f in ("a", "b")])
    q = np.asarray([1.0, -2.0, 0.5, 3.0])
    vmax = float((v.astype(np.float64) ** 2).sum(1).max())
    for g, w in zip(out[1], out[0]):
        same(g, w, chip_smoke.l2_tolerance(vmax, q))
    d2 = ((v.astype(np.float64) - q) ** 2).sum(1)
    top = out[0][0]["hits"]["hits"][0]
    assert top["_score"] == pytest.approx(1 / (1 + d2.min()), rel=1e-5)


def test_recovery_keeps_the_similarity_where_the_reference_loses_it(
        tmp_path):
    """The reference persists `Mappings.to_dict()`, which keeps a vector
    field's type alone: after a recovery a dot_product field rewrites its
    queries as cosine (its scores change). The port persists the mapping
    bodies merged over it, so its recovered pages equal its pages before
    the flush."""
    rng = np.random.default_rng(6)
    v = rng.normal(size=(30, 4)).astype(np.float32)
    body = {"size": 4, "query": knn("e", [1.0, 2.0, 0.5, -1.0])}
    pages = []
    for name, make in (("ref", RefClient), ("port", lambda **k: RestClient(
            device="cpu", **k))):
        path = str(tmp_path / name)
        c = make(data_path=path)
        c.indices.create("v", {"mappings": {"properties": {"e": {
            "type": "dense_vector", "dims": 4,
            "similarity": "dot_product"}}}})
        c.bulk(sum([[{"index": {"_index": "v", "_id": str(i)}},
                     {"e": v[i].tolist()}] for i in range(30)], []),
               refresh=True)
        before = c.search("v", body)
        c.indices.flush("v")
        if hasattr(c, "close"):
            c.close()
        pages.append((before, make(data_path=path).search("v", body)))
    (ref_before, ref_after), (port_before, port_after) = pages
    same(port_before, ref_before)
    same(port_after, port_before, (0.0, 0.0, 0.0))
    assert ref_after["hits"]["max_score"] < ref_before["hits"]["max_score"]


def test_body_section_explain_reads_the_query_alone(clients, data):
    """The reference's fetch explains (and highlights) the body's `query`
    alone, not its `knn` section: a knn-section hit explains as the
    query's match_all; the port serves the same response."""
    ref, port = clients
    _, vecs = data
    for extra in ({}, {"query": {"match": {"body": "fox"}}}):
        body = {"size": 3, "explain": True, "knn": {
            "field": "cos", "query_vector": qvec(vecs, "cos", 12)}, **extra}
        same(port.search("v", body), ref.search("v", body))
