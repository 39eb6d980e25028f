"""The port's bool / filtered BM25 queries (opensearch_tpu_torch: numeric
fields, `bool` / `constant_score` / `range` parsing and rewrite, filter
masks, `_flatten_bool`, the bool kernel route and the filtered-pure rung)
against the JAX package on the CPU.

- Specs: per body, the port's FastSpec (kind, slots with their weights and
  count weights, fam_msm, filter clauses, boost, const score) equals the
  reference's; where the reference returns None (its general XLA path),
  so does the port's `make_spec` (its general path serves the body).
- Masks: `search/filters.filter_mask` equals the reference's
  `compiler.filter_mask_for` bit for bit.
- Numeric fields: mapping types and refreshed columns equal the
  reference's `numeric_cols`.
- End to end through RestClient.search and msearch, the same bulk and the
  same body sequence on fresh clients of both packages, in two ways:
  1. the reference's fastpath forced on with the port's plain kernels
     standing in for its Pallas kernels (as tests/test_torch_ladder.py
     does): the same route per body (the bool kernel with a filter slot,
     over filter-specialized postings, unfiltered, or the filtered-pure
     rung; a route depends on how often a filter was used before, so the
     sequence is replayed whole), and responses equal apart from `took`:
     ids, totals, relation, `_source`, and scores bit for bit;
  2. the reference's general XLA path: ids and order identical (two hits
     may swap only when their scores agree within the tolerance), scores
     within 1e-6 relative (XLA sums in scatter order and contracts an
     FMA), totals equal where the port's relation is "eq", else a lower
     bound.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu.search import compiler as RC
from opensearch_tpu.search import fastpath as rfp
from opensearch_tpu.search import query_dsl as rdsl
from opensearch_tpu.search.executor import ShardSearcher as RefSearcher
from opensearch_tpu_torch import NotPortedError, RestClient
from opensearch_tpu_torch.ops import bm25
from opensearch_tpu_torch.rest.client import ApiError
from opensearch_tpu_torch.search import compiler as C
from opensearch_tpu_torch.search import fastpath, filters
from opensearch_tpu_torch.search import query_dsl as dsl

jax.config.update("jax_platforms", "cpu")

CPU = torch.device("cpu")
RTOL = 1e-6
NDOCS = 2400
MAPPING = {"properties": {"body": {"type": "text"},
                          "status": {"type": "keyword"},
                          "price": {"type": "integer"}}}
ROUTES = ("b3_filter_slot", "b3_filtered_postings", "b3_unfiltered",
          "filtered_pure")


def _t(a):
    return torch.from_numpy(np.array(a))


def _plain_tfdl(*args, **kw):
    return tuple(o.numpy() for o in bm25.fused_bm25_topk_tfdl_plain(
        *[_t(a) for a in args], **kw))


def _plain_impact(*args, **kw):
    return tuple(o.numpy() for o in bm25.fused_bm25_topk_impact_plain(
        *[_t(a) for a in args], **kw))


def _plain_bool(*args, **kw):
    return tuple(o.numpy() for o in bm25.fused_bm25_bool_topk_plain(
        *[_t(a) for a in args], **kw))


def make_bulk():
    """NDOCS docs (seed 31): Zipf-ish words over `body`, a status keyword
    (3 values), an integer price 0..999 and a dynamic long `n`."""
    rng = np.random.default_rng(31)
    words = [f"w{i}" for i in range(60)]
    p = 1.0 / np.arange(1, 61) ** 0.9
    p /= p.sum()
    bulk = []
    for i in range(NDOCS):
        toks = rng.choice(words, int(rng.integers(3, 14)), p=p)
        if rng.random() < 0.5:
            toks = np.append(toks, ["common"] * int(rng.integers(1, 4)))
        doc = {"body": " ".join(toks),
               "status": ("archived", "draft", "published")[
                   int(rng.integers(0, 3))],
               "price": int(rng.integers(0, 1000)),
               "n": int(rng.integers(-5, 5))}
        bulk += [{"index": {"_index": "t", "_id": f"d{i}"}}, doc]
    return bulk


def fill(client, bulk, nseg=2):
    client.indices.create("t", {"settings": {"number_of_replicas": 0},
                                "mappings": MAPPING})
    cut = (len(bulk) // 2 // 2) * 2 if nseg == 2 else len(bulk)
    client.bulk(bulk[:cut], refresh=True)
    if cut < len(bulk):
        client.bulk(bulk[cut:], refresh=True)
    return client


PUB = {"term": {"status": "published"}}
DRAFT = {"term": {"status": "draft"}}
PRICE = {"range": {"price": {"gte": 250, "lt": 750}}}

# (name, body); the sequence replays uses of the same filters, so routes
# move from the filter slot to filter-specialized postings / filtered-pure
BODIES = [
    ("or+pub", {"query": {"bool": {"must": [{"match": {"body": "w1 w4"}}],
                                   "filter": [PUB]}}, "size": 10}),
    ("and+pubprice", {"query": {"bool": {
        "must": [{"match": {"body": {"query": "common w2",
                                     "operator": "and"}}}],
        "filter": [PUB, PRICE]}}}),
    ("msm2+draft", {"query": {"bool": {
        "must": [{"match": {"body": {"query": "w1 w3 w7",
                                     "minimum_should_match": 2}}}],
        "filter": [DRAFT]}}, "size": 20}),
    ("or+pub again", {"query": {"bool": {
        "must": [{"match": {"body": "common w5"}}], "filter": [PUB]}}}),
    ("and+pubprice again", {"query": {"bool": {
        "must": [{"match": {"body": {"query": "w0 w3",
                                     "operator": "and"}}}],
        "filter": [PUB, PRICE]}}, "size": 5}),
    ("bonus+pub", {"query": {"bool": {
        "must": [{"match": {"body": "w2 w6"}}],
        "should": [{"term": {"body": "common"}}], "filter": [PUB]}}}),
    ("req+fam-archived", {"query": {"bool": {
        "must": [{"term": {"body": "common"}}],
        "should": [{"term": {"body": "w1"}}, {"term": {"body": "w9"}}],
        "minimum_should_match": 1,
        "must_not": [{"term": {"status": "archived"}}]}}}),
    ("req+fam-archived again", {"query": {"bool": {
        "must": [{"term": {"body": "w0"}}],
        "should": [{"term": {"body": "w3"}}, {"term": {"body": "w4"}}],
        "minimum_should_match": 1,
        "must_not": [{"term": {"status": "archived"}}]}}, "size": 30}),
    ("price narrow", {"query": {"bool": {
        "must": [{"match": {"body": "w1 common"}}],
        "filter": [{"range": {"price": {"gte": 250, "lt": 300}}}]}}}),
    ("const draft price", {"query": {"constant_score": {
        "filter": {"bool": {"filter": [
            DRAFT, {"range": {"price": {"gte": 500, "lt": 600}}}]}},
        "boost": 2.0}}, "size": 15}),
    ("boost 1.5", {"query": {"bool": {
        "must": [{"match": {"body": "w2 w5"}}],
        "should": [{"term": {"body": "w11"}}], "filter": [PUB],
        "boost": 1.5}}}),
    ("or+pub exact", {"query": {"bool": {
        "must": [{"match": {"body": "w1 w4"}}], "filter": [PUB]}},
        "track_total_hits": True}),
    ("filter only", {"query": {"bool": {"filter": [
        {"range": {"price": {"gt": 990}}}]}}}),
    ("shoulds only", {"query": {"bool": {"should": [
        {"term": {"body": "w3"}}, {"term": {"body": "w8"}},
        {"term": {"body": "w12"}}], "minimum_should_match": 2}}}),
    ("terms filter", {"query": {"bool": {
        "must": [{"match": {"body": "w6"}}],
        "filter": [{"terms": {"status": ["draft", "archived"]}}]}}}),
    ("nested filter bool", {"query": {"bool": {
        "must": [{"match": {"body": "w4 w7"}}],
        "filter": [{"bool": {"should": [DRAFT, {"range": {
            "price": {"from": 100, "to": 200}}}]}}]}}}),
    ("numeric term filter", {"query": {"bool": {
        "must": [{"match": {"body": "common"}}],
        "filter": [{"terms": {"n": [1, 3]}}],
        "must_not": [{"term": {"price": 7}}]}}}),
    ("unmapped range", {"query": {"bool": {
        "must": [{"match": {"body": "common"}}],
        "filter": [{"range": {"nope": {"gte": 1}}}]}}}),
]


@pytest.fixture()
def reference_fastpath(monkeypatch):
    """The reference's fastpath forced on, its kernels stood in for by the
    port's plain versions, and small thresholds in both packages so a few
    thousand docs reach dense filters, heads and the quality tier."""
    for mod in (rfp, fastpath):
        monkeypatch.setattr(mod, "L_HEAD", 64)
        monkeypatch.setattr(mod, "QUALITY_MIN_NDOCS", 2048)
    monkeypatch.setattr(rfp, "_MATERIALIZE_MIN_DOCS", 64)
    monkeypatch.setattr(fastpath, "MATERIALIZE_MIN_DOCS", 64)
    monkeypatch.setattr(rfp, "_backend_ok", True)
    monkeypatch.setattr(rfp, "fused_bm25_topk_tfdl", _plain_tfdl)
    monkeypatch.setattr(rfp, "fused_bm25_topk_impact", _plain_impact)
    monkeypatch.setattr(rfp, "fused_bm25_bool_topk", _plain_bool)
    routes = []
    real_prep = rfp._prepare_bool_vqueries

    def spy_prep(seg, ctx, specs, avgdl_cache):
        out = real_prep(seg, ctx, specs, avgdl_cache)
        for spec, vqs in zip(specs, out):
            assert vqs is not None, "reference fell back"
            vq = vqs[0]
            if vq.filtered:
                routes.append("b3_filter_slot")
            elif (vq.albuf is not None
                  and vq.albuf is not rfp.get_aligned(seg, spec.field)):
                routes.append("b3_filtered_postings")
            else:
                routes.append("b3_unfiltered")
        return out
    real_fin = rfp._finish_filtered_pure_batch

    def spy_fin(ctx, K, launched):
        out = real_fin(ctx, K, launched)
        routes.extend(["filtered_pure"] * len(out))
        return out
    monkeypatch.setattr(rfp, "_prepare_bool_vqueries", spy_prep)
    monkeypatch.setattr(rfp, "_finish_filtered_pure_batch", spy_fin)
    return routes


@pytest.fixture(scope="module")
def bulk():
    return make_bulk()


def _route_counts(names):
    return {r: names.count(r) for r in ROUTES}


def test_rest_matches_reference_fastpath(reference_fastpath, bulk):
    ref_routes = reference_fastpath
    ref, port = fill(RefClient(), bulk), fill(RestClient(device="cpu"), bulk)
    assert len(port._indices["t"].engine.segments) == 2
    seen = set()
    for name, body in BODIES:
        before = dict(fastpath.STATS)
        del ref_routes[:]
        want = ref.search("t", body)
        got = port.search("t", body)
        port_routes = {r: fastpath.STATS[r] - before[r] for r in ROUTES}
        assert port_routes == _route_counts(ref_routes), name
        seen |= {r for r, n in port_routes.items() if n}
        assert chip_smoke.strip_took(got) == chip_smoke.strip_took(want), \
            name
    assert seen == set(ROUTES)
    assert rfp.STATS["fallback"] == 0
    # msearch: every body in one batch, on the clients' history so far
    lines = sum([[{}, b] for _n, b in BODIES], [])
    del ref_routes[:]
    before = dict(fastpath.STATS)
    want = ref.msearch(lines, index="t")["responses"]
    got = port.msearch(lines, index="t")["responses"]
    assert {r: fastpath.STATS[r] - before[r] for r in ROUTES} \
        == _route_counts(ref_routes)
    for (name, _b), g, w in zip(BODIES, got, want):
        assert chip_smoke.strip_took(g) == chip_smoke.strip_took(w), name


def test_probe_plans_fewer_rows_than_the_list_form(reference_fastpath,
                                                   bulk, monkeypatch):
    """A body that needs a term, over a filter of 99% of the docs, with the
    per-row budget lowered so that the filter's doc list sets the chunk
    count: its probe form (the filter's bitmap, term slots only) plans
    fewer B3 rows than its list form (`_probe_form` forced off), and the
    route and the response equal the reference's either way. A
    constant-score body keeps the list form."""
    monkeypatch.setattr(fastpath, "MAX_TL", 4096)
    bodies = [
        ("needs a term", {"query": {"bool": {
            "must": [{"match": {"body": "w1 w4"}}],
            "filter": [{"range": {"price": {"gte": 10}}}]}},
            "size": 20}),
        ("const score", {"query": {"constant_score": {"filter": {"range": {
            "price": {"gte": 100}}}}}, "size": 20}),
    ]
    plans = []
    real = fastpath._prepare_bool_vqueries

    def spy(seg, ctx, specs, avgdl_cache, device):
        out = real(seg, ctx, specs, avgdl_cache, device)
        plans.extend((vq.probe, vq.T, vq.n) for vq in out)
        return out
    monkeypatch.setattr(fastpath, "_prepare_bool_vqueries", spy)
    rows = {}
    for form in ("probe", "list"):
        if form == "list":
            monkeypatch.setattr(fastpath, "_probe_form", lambda spec: False)
        ref = fill(RefClient(), bulk)
        port = fill(RestClient(device="cpu"), bulk)
        for name, body in bodies:
            del plans[:]
            del reference_fastpath[:]
            before = dict(fastpath.STATS)
            want = ref.search("t", body)
            got = port.search("t", body)
            assert {r: fastpath.STATS[r] - before[r] for r in ROUTES} \
                == _route_counts(reference_fastpath) \
                == {**dict.fromkeys(ROUTES, 0), "b3_filter_slot": 2}, name
            assert chip_smoke.strip_took(got) == chip_smoke.strip_took(want), \
                (form, name)
            rows[form, name] = list(plans)
    probe, listed = rows["probe", "needs a term"], rows["list", "needs a term"]
    assert [p for p, _t, _n in probe] == [True, True]
    assert all(T == 2 for _p, T, _n in probe)      # TS = 2, no dead slots
    assert [p for p, _t, _n in listed] == [False, False]
    assert sum(n for *_, n in probe) < sum(n for *_, n in listed), rows
    assert not any(p for p, _t, _n in rows["probe", "const score"])


def _assert_close_response(got, want, name):
    gt, wt = got["hits"]["total"], want["hits"]["total"]
    assert wt["relation"] == "eq"
    if gt["relation"] == "eq":
        assert gt == wt, name
    else:
        assert gt["value"] <= wt["value"], name
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


def test_rest_matches_reference_general_path(monkeypatch, bulk):
    monkeypatch.setattr(fastpath, "MATERIALIZE_MIN_DOCS", 64)
    ref, port = fill(RefClient(), bulk), fill(RestClient(device="cpu"), bulk)
    fastpath.reset_stats()
    for name, body in BODIES:
        _assert_close_response(port.search("t", body), ref.search("t", body),
                               name)
    assert all(fastpath.STATS[r] for r in ROUTES), fastpath.STATS


# ---------------------------------------------------------------------
# specs, masks and numeric columns
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_segment(bulk):
    """One codec-v1 segment in each package: the reference's mask program
    for a `match` in filter context reads the tf plane, which it does not
    ship for codec-v2 segments (KeyError 'tfs'; ROADMAP Queue 3), and no
    mask depends on the codec."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENSEARCH_TPU_CODEC", "1")
        ref = fill(RefClient(), bulk, 1)
        port = fill(RestClient(device="cpu"), bulk, 1)
    reng = ref.node.indices["t"].shards[0]
    psvc = port._indices["t"]
    return (ref, reng.segments[0], RefSearcher(reng).context(),
            port, psvc.engine.segments[0], psvc.searcher.context())


SPEC_BODIES = [q["query"] for _n, q in BODIES] + [
    {"bool": {"must": [{"match": {"body": "w1 w2"}},
                       {"match": {"body": "w3 w4"}}]}},          # two fams
    {"bool": {"must": [{"bool": {"should": [
        {"term": {"body": "w1"}}]}}]}},                           # nested
    {"bool": {"must": [{"match": {"body": "w1"}}], "boost": 0}},  # boost 0
    {"bool": {"filter": [], "must": []}},                         # empty
    {"bool": {"should": [{"match": {"body": "w1 w2"}},
                         {"match": {"body": "w3 w4"}}],
              "minimum_should_match": 1}},                        # multi
    {"bool": {"must": [{"match": {"body": "w1 w2 w3 w4 w5"}}],
              "should": [{"match": {"body": "w6 w7 w8 w9"}}]}},   # > MAX_T
    {"bool": {"must": [{"match": {"body": "w1"}},
                       {"match": {"status": "draft"}}]}},         # fields
    {"bool": {"must": [{"term": {"price": 5}}]}},                 # range must
    {"range": {"price": {"gte": 5}}},                             # top range
    {"constant_score": {"filter": PUB, "boost": -1.0}},
]


@pytest.mark.parametrize("qi", range(len(SPEC_BODIES)))
def test_flatten_bool_matches_reference(one_segment, qi):
    _ref, _rseg, rctx, _port, _pseg, pctx = one_segment
    query = SPEC_BODIES[qi]
    rroot = RC.rewrite(rdsl.parse_query(query), rctx, scoring=True)
    want = rfp.make_spec(rroot, [], [], [], None, 10, {})
    proot = C.rewrite(dsl.parse_query(query), pctx)
    got = fastpath.make_spec(proot, 10, {})
    if want is None:
        assert got is None
        return
    assert got.kind == want.kind
    if want.kind == "pure":
        return
    assert [(t, np.float32(w), cw) for t, w, cw in got.slots] \
        == [(t, np.float32(w), cw) for t, w, cw in want.slots]
    assert (got.fam_msm, got.n_required, got.boost, got.const_score,
            got.field, got.has_norms) == (
        want.fam_msm, want.n_required, want.boost, want.const_score,
        want.field, want.has_norms)
    assert [neg for _n, neg in got.filter_clauses] \
        == [neg for _n, neg in want.filter_clauses]
    assert fastpath._family_only(got) == rfp._family_only(want)


FILTER_CLAUSES = [
    PUB, DRAFT, PRICE,
    {"term": {"status": "nope"}},
    {"terms": {"status": ["draft", "archived"]}},
    {"match": {"body": {"query": "w1 w3 w5", "minimum_should_match": 2}}},
    {"match": {"body": "w9 common"}},
    {"bool": {"must": [{"term": {"body": "w2"}}],
              "filter": [{"match": {"body": {
                  "query": "w1 w3 w5", "minimum_should_match": 2}}}]}},
    {"range": {"price": {"gt": 250, "lte": 750}}},
    {"range": {"price": {"from": 900}}},
    {"range": {"price": {"lt": 0}}},
    {"range": {"n": {"gte": -2, "lt": 3}}},
    {"range": {"nope": {"gte": 1}}},
    {"term": {"price": 7}},
    {"terms": {"n": [1, -3, 4]}},
    {"bool": {"should": [DRAFT, PRICE, {"term": {"body": "w2"}}],
              "minimum_should_match": 2}},
    {"bool": {"must": [{"term": {"body": "common"}}],
              "must_not": [PUB], "filter": [PRICE]}},
    {"bool": {"should": [DRAFT, {"match": {"body": "w5"}}]}},
    {"constant_score": {"filter": {"bool": {"filter": [DRAFT, PRICE]}}}},
]


@pytest.mark.parametrize("fi", range(len(FILTER_CLAUSES)))
def test_filter_masks_match_reference(one_segment, fi):
    _ref, rseg, rctx, _port, pseg, pctx = one_segment
    clause = FILTER_CLAUSES[fi]
    rnode = RC.rewrite(rdsl.parse_query(clause), rctx, scoring=False)
    want = np.asarray(RC.filter_mask_for(rnode, rseg, rctx)[0])[:rseg.ndocs]
    pnode = C.rewrite(dsl.parse_query(clause), pctx, scoring=False)
    got = filters.filter_mask(pnode, pseg, pctx, CPU).numpy()
    np.testing.assert_array_equal(got, want.astype(bool))
    # cached under its structural key
    assert filters.filter_mask(pnode, pseg, pctx, CPU) is \
        filters.filter_mask(C.rewrite(dsl.parse_query(clause), pctx,
                                      scoring=False), pseg, pctx, CPU)


def test_numeric_fields_match_reference(one_segment):
    ref, rseg, _rctx, port, pseg, _pctx = one_segment
    rmap = ref.node.indices["t"].shards[0].mappings
    pmap = port._indices["t"].engine.mappings
    for f in ("price", "n"):
        assert pmap.resolve_field(f).type == rmap.resolve_field(f).type
    assert set(pseg.numeric_cols) == set(rseg.numeric_cols) == {"price", "n"}
    for f, rc in rseg.numeric_cols.items():
        pc = pseg.numeric_cols[f]
        assert pc.kind == rc.kind == "int"
        np.testing.assert_array_equal(pc.values, rc.values)
        np.testing.assert_array_equal(pc.present, rc.present)
        assert pc.min_max == rc.min_max


def test_numeric_values_out_of_range_and_unported_types_raise():
    port = RestClient(device="cpu")
    port.indices.create("x", {"mappings": {"properties": {
        "i": {"type": "integer"}}}})
    with pytest.raises(ApiError, match="out of range"):
        port.index("x", {"i": 2**31}, id="1")
    for ftype in ("double", "date", "short"):
        with pytest.raises(NotPortedError, match=ftype):
            RestClient(device="cpu").indices.create("y", {"mappings": {
                "properties": {"v": {"type": ftype}}}})
    with pytest.raises(NotPortedError, match="double"):
        RestClient(device="cpu").index("z", {"v": 1.5}, id="1")


def test_segment_from_arrays_takes_reference_numeric_columns(one_segment):
    from opensearch_tpu_torch.index.convert import segment_from_arrays
    ref, rseg, _rctx, _port, _pseg, _pctx = one_segment
    port = RestClient(device="cpu")
    port.indices.create("t", {"mappings": MAPPING})
    assert rseg.codec_version == 1
    postings = {f: {"vocab": pb.vocab, "starts": pb.starts,
                    "doc_ids": pb.doc_ids, "tfs": pb.tfs}
                for f, pb in rseg.postings.items()}
    stats = {f: (s.doc_count, s.sum_dl) for f, s in rseg.text_stats.items()}
    seg = segment_from_arrays("_0", rseg.ndocs, postings, rseg.doc_lens,
                              stats, list(rseg.ids), list(rseg.sources),
                              numeric_cols=rseg.numeric_cols)
    port._indices["t"].engine.segments = [seg]
    body = dict(BODIES[8][1])
    _assert_close_response(port.search("t", body), ref.search("t", body),
                           "segment_from_arrays")


def test_bench_guardrail_columns_match_bench_py():
    """bench_corpus attaches the status postings and the price column as
    bench.py's make_index does, and its filter masks are bench.py's."""
    import bench
    from opensearch_tpu_torch import bench_corpus as bc

    ndocs = 4000
    starts, doc_ids, tfs, dl, df = bc.build_corpus(ndocs)
    status, price = bc.guardrail_columns(ndocs)
    rng = np.random.default_rng(3)            # bench.py's own draws
    np.testing.assert_array_equal(status, rng.integers(0, 3, ndocs))
    np.testing.assert_array_equal(price, rng.integers(0, 1000, ndocs))
    title = (np.zeros(2, np.int64), np.zeros(0, np.int32),
             np.zeros(0, np.float32), np.zeros(1, np.int64),
             np.zeros(0, np.int32), ["x"])
    rseg = bench.make_index(RefClient(), (starts, doc_ids, tfs,
                                          bc.vocab_strings(len(df))),
                            dl, title, status, price)
    pseg = bc.make_index(RestClient(device="cpu"),
                         (starts, doc_ids, tfs, dl, df),
                         columns=(status, price))
    rb, pb = rseg.postings["status"], pseg.postings["status"]
    assert list(pb.vocab) == list(rb.vocab)
    for a in ("starts", "doc_ids", "tfs"):
        np.testing.assert_array_equal(getattr(pb, a), getattr(rb, a))
    rc, pc = rseg.numeric_cols["price"], pseg.numeric_cols["price"]
    np.testing.assert_array_equal(pc.values, rc.values)
    np.testing.assert_array_equal(pc.present, rc.present)
    masks = bc.guardrail_masks(status, price)
    f_pub = status == 2
    np.testing.assert_array_equal(masks["pub"], f_pub)
    np.testing.assert_array_equal(masks["pubprice"],
                                  f_pub & (price >= 250) & (price < 750))
    np.testing.assert_array_equal(masks["draft"], status == 1)
