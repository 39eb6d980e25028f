"""The port's long-tail aggregations (composite, multi_terms, rare_terms,
significant_terms, significant_text, sampler, diversified_sampler,
adjacency_matrix, auto_date_histogram, top_hits, weighted_avg,
median_absolute_deviation, matrix_stats and the pipeline aggregations)
against the JAX package on the CPU.

- Ops: each new op of opensearch_tpu_torch/ops/aggs.py against the
  reference's function on seeded inputs (its ops/aggs.py functions, and
  its emit_agg for the composite ordinal, matrix_stats' power sums, the
  sampler and the diversified rounds, which it computes inline there).
- End to end: the bodies of tests/test_aggs_longtail.py,
  test_aggs_extended.py, test_aggregations.py's pipeline and root
  top_hits tests and test_aggs_deep.py over the served kinds (their ip
  and geo fields left out: the port has neither), and a seeded set over
  three segments with deletes, through both RestClients, over one and
  two segments, after a forcemerge and in msearch; a composite paged to
  its end.
- Tolerances, as tests/test_torch_aggs.py states them: counts, keys,
  bucket order, `after_key`, hits, significance scores (Python floats
  over equal counts) and MAD are equal; sums and what derives from them
  (avg, weighted_avg, and every pipeline value over them) within 1e-5
  relative; a hit's `_score` within 1e-6 relative (the scoring's f32
  order of addition); matrix_stats' moments within MS_RTOL (below).
- The reference behaviours kept (ROADMAP Queue 3) are pinned here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.ops import aggs as R
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu.search import compiler as RC
from opensearch_tpu_torch import RestClient
from opensearch_tpu_torch.ops import aggs as P

import test_torch_aggs as TA

jax.config.update("jax_platforms", "cpu")

RTOL = 1e-5
# matrix_stats: both packages sum f32 powers of (x - shift) in another
# order (XLA's reductions and matmul against torch's), so each moment
# carries an f32 rounding error of the sums it is made from; the
# variance, covariance and correlation cancel little about the shift
# (1e-5 relative), skewness and kurtosis are ratios of third and fourth
# power sums of small residuals (1e-3 relative)
MS_RTOL = {"mean": 1e-5, "variance": 1e-5, "covariance": 1e-5,
           "correlation": 1e-5, "skewness": 1e-3, "kurtosis": 1e-3}
LOOSE_KINDS = {"sum", "avg", "stats", "extended_stats", "weighted_avg",
               "cumulative_sum", "derivative", "serial_diff", "moving_avg",
               "moving_fn", "avg_bucket", "sum_bucket", "min_bucket",
               "max_bucket", "stats_bucket", "percentiles_bucket"}
SCORE_KEYS = {"_score", "max_score"}


def t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))


# ---------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def cols():
    rng = np.random.default_rng(41)
    n = 4000
    return dict(
        n=n, v=(rng.standard_normal(n) * 50).astype(np.float32),
        vp=rng.random(n) < 0.9,
        w=rng.uniform(0, 5, n).astype(np.float32), wp=rng.random(n) < 0.8,
        match=rng.random(n) < 0.7,
        scores=np.round(rng.uniform(0, 4, n), 1).astype(np.float32),
        kw=np.where(rng.random(n) < 0.85, rng.integers(0, 9, n),
                    -1).astype(np.int32),
        hist=(rng.uniform(-300, 900, n)).astype(np.float32),
        days=np.where(rng.random(n) < 0.95, rng.integers(0, 40, n),
                      -1).astype(np.int32))


@pytest.mark.parametrize("has_vm,has_wm", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_weighted_avg_agg(cols, has_vm, has_wm):
    c = cols
    want = [np.asarray(x) for x in R.weighted_avg_agg(
        jnp.asarray(c["v"]), jnp.asarray(c["vp"]), jnp.asarray(c["w"]),
        jnp.asarray(c["wp"]), jnp.asarray(c["match"].astype(np.float32)),
        np.float32(2.5), np.float32(0.5), has_vm, has_wm)]
    got = [x.numpy() for x in P.weighted_avg_agg(
        t(c["v"]), t(c["vp"]), t(c["w"]), t(c["wp"]), t(c["match"]), 2.5,
        0.5, has_vm, has_wm)]
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL)
    assert int(got[2]) == int(want[2])


def test_ord_counts(cols):
    c = cols
    want = np.asarray(R.ord_counts(jnp.asarray(c["kw"]),
                                   jnp.asarray(c["match"].astype(np.float32)),
                                   16))
    got = P.ord_counts(t(c["kw"]), t(c["match"]), 9).numpy()
    np.testing.assert_array_equal(got, want[:9].astype(np.int64))
    assert not want[9:].any()


def _ref_seg_arrays(c, n_pad):
    def pad(a, v):
        return jnp.asarray(np.pad(a, (0, n_pad - len(a)), constant_values=v))
    live = np.ones(c["n"], np.float32)
    return {"live": pad(live, 0),
            "keyword": {"k": {"min_ord": pad(c["kw"], -1)}},
            "numeric": {"h": {"f32": pad(c["hist"], 0),
                              "present": pad(c["vp"], False)},
                        "v": {"f32": pad(c["v"], 0),
                              "present": pad(c["vp"], False)},
                        "w": {"f32": pad(c["w"], 0),
                              "present": pad(c["wp"], False)}}}, pad


@pytest.mark.parametrize("interval", [25.0, 7.0, 0.5])
def test_composite_ordinal_and_counts(cols, interval):
    """The combined ordinal over a terms, a histogram and a date source
    and its bucket counts against the reference's composite emit."""
    c = cols
    n_pad = 1 << (c["n"] - 1).bit_length()
    arrays, pad = _ref_seg_arrays(c, n_pad)
    hv = c["hist"][c["vp"]]
    min_b = int(np.floor(hv.min() / interval))
    nb = int(np.floor(hv.max() / interval)) - min_b + 1
    infos = (("terms", "k", 9, 0, 0.0, 0.0),
             ("hist", "h", nb, min_b, interval, 0.0),
             ("date", "d", 40, 0, 86400000.0, ""))
    total = 9 * nb * 40
    params = {"a0_s2": pad(c["days"], -1)}
    want = np.asarray(RC.emit_agg(("composite", "a0", infos, total, ()),
                                  arrays, params,
                                  jnp.asarray(np.pad(
                                      c["match"].astype(np.float32),
                                      (0, n_pad - c["n"]))))["counts"])
    o_h = P.histogram_source_ords(t(c["hist"]), t(c["vp"]), interval,
                                  min_b, nb)
    b, got_total = P.composite_buckets([t(c["kw"]), o_h, t(c["days"])],
                                       [9, nb, 40], t(c["match"]))
    assert got_total == total
    got = P.bucket_counts(b, total).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert got.sum() > 0.5 * c["match"].sum()


def test_matrix_stats_sums(cols):
    c = cols
    n_pad = 1 << (c["n"] - 1).bit_length()
    arrays, _pad = _ref_seg_arrays(c, n_pad)
    shift = np.array([1.5, 2.25], np.float64)
    want = RC.emit_agg(("matrix_stats", "a0", ("v", "w"), (True, True)),
                       arrays, {"a0_shift": shift.astype(np.float32)},
                       jnp.asarray(np.pad(c["match"].astype(np.float32),
                                          (0, n_pad - c["n"]))))
    got = P.matrix_stats_sums([(t(c["v"]), t(c["vp"])),
                               (t(c["w"]), t(c["wp"]))], shift,
                              t(c["match"]))
    assert int(got["count"]) == int(want["count"])
    for k in ("s1", "s2", "s3", "s4", "xy"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("shard_size", [1, 37, 500, 10000])
def test_sampler_select(cols, shard_size):
    c = cols
    n_pad = 1 << (c["n"] - 1).bit_length()
    arrays, _pad = _ref_seg_arrays(c, n_pad)
    sc = jnp.asarray(np.pad(c["scores"], (0, n_pad - c["n"])))
    match = jnp.asarray(np.pad(c["match"].astype(np.float32),
                               (0, n_pad - c["n"])))
    sub = ("stats", "a0_0", "v", True)
    want = RC.emit_agg(("sampler", "a0", shard_size, False, (sub,)), arrays,
                       {}, match, sc)
    sel, tops = P.sampler_select(t(c["match"]), t(c["scores"]), shard_size)
    assert int(sel.sum()) == int(want["doc_count"])
    wt = np.asarray(want["topscores"])
    np.testing.assert_array_equal(tops.numpy(), wt[:len(tops)])
    assert np.isneginf(wt[len(tops):]).all()
    # the second pass at a shard-wide threshold
    thr = float(np.sort(c["scores"][c["match"]])[-min(shard_size, 50)])
    want2 = RC.emit_agg(("sampler", "a0", shard_size, True, (sub,)), arrays,
                        {"a0_thr": np.float32(thr)}, match, sc)
    sel2, _ = P.sampler_select(t(c["match"]), t(c["scores"]), shard_size,
                               thr)
    assert int(sel2.sum()) == int(want2["doc_count"])


def np_diversify(sel, ords, scores, maxper):
    """The rounds in numpy: per key, the best remaining score, ties to the
    lowest doc, `maxper` times; unkeyed sampled docs stay."""
    chosen = sel & (ords < 0)
    for o in np.unique(ords[sel & (ords >= 0)]):
        docs = np.nonzero(sel & (ords == o))[0]
        order = np.lexsort((docs, -scores[docs]))
        chosen[docs[order[:maxper]]] = True
    return chosen


@pytest.mark.parametrize("maxper", [1, 2, 5])
def test_diversified_rounds(cols, maxper):
    """The diversified sampler's selection against the reference's rounds
    (doc count, and a stats sub over doc ids that fixes the set) and a
    numpy copy of them (the set itself)."""
    c = cols
    n_pad = 1 << (c["n"] - 1).bit_length()
    arrays, pad = _ref_seg_arrays(c, n_pad)
    ids = np.arange(c["n"], dtype=np.float32)
    arrays["numeric"]["id"] = {"f32": pad(ids, 0),
                               "present": pad(np.ones(c["n"], bool), False)}
    sc = jnp.asarray(np.pad(c["scores"], (0, n_pad - c["n"])))
    match = jnp.asarray(np.pad(c["match"].astype(np.float32),
                               (0, n_pad - c["n"])))
    sub = ("stats", "a0_0", "id", True)
    want = RC.emit_agg(("dsampler", "a0", 300, "k", maxper, True, 16,
                        (sub,)), arrays, {}, match, sc)
    sel, _ = P.sampler_select(t(c["match"]), t(c["scores"]), 300)
    got = P.diversify(sel, t(c["kw"]), t(c["scores"]), maxper).numpy()
    assert int(got.sum()) == int(want["doc_count"])
    ws = want["sub0"]
    assert float(ids[got].sum()) == float(ws["sum"])
    assert float(ids[got].min()) == float(ws["min"])
    assert float(ids[got].max()) == float(ws["max"])
    np.testing.assert_array_equal(got, np_diversify(
        sel.numpy(), c["kw"], c["scores"], maxper))


# ---------------------------------------------------------------------
# end to end: both RestClients
# ---------------------------------------------------------------------

def same(got, want, kinds, path="", kind=None):
    """Equal, apart from sums and what derives from them (RTOL), scores
    (1e-6) and matrix_stats' moments (MS_RTOL)."""
    assert type(got) is type(want) or {type(got), type(want)} <= {
        int, float, np.float64}, (path, got, want)
    if isinstance(want, dict):
        assert got.keys() == want.keys(), (path, got.keys(), want.keys())
        for k in want:
            same(got[k], want[k], kinds, f"{path}/{k}",
                 kinds.get(k, kind) if kind != "matrix_stats" else kind)
        return
    if isinstance(want, list):
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, kinds, f"{path}[{i}]", kind)
        return
    leaf = path.rsplit("/", 1)[-1]
    if not isinstance(want, float) or isinstance(want, bool):
        assert got == want, (path, got, want)
    elif leaf in SCORE_KEYS or (kind == "top_hits"
                                and leaf.startswith("sort[")):
        assert got == pytest.approx(want, rel=1e-6), (path, got, want)
    elif kind == "matrix_stats":
        part = next(p for p in MS_RTOL if f"/{p}" in path)
        assert got == pytest.approx(want, rel=MS_RTOL[part], abs=1e-9), \
            (path, got, want)
    elif kind in LOOSE_KINDS:
        assert got == pytest.approx(want, rel=RTOL, abs=1e-9), \
            (path, got, want)
    else:
        assert got == want, (path, got, want)


def assert_same(got, want, body):
    for r in (got, want):
        r.pop("took", None)
    kinds = TA._kinds(body.get("aggs", body.get("aggregations")))
    assert got["hits"]["total"] == want["hits"]["total"]
    assert [h["_id"] for h in got["hits"]["hits"]] \
        == [h["_id"] for h in want["hits"]["hits"]]
    assert ("aggregations" in got) == ("aggregations" in want)
    if "aggregations" in want:
        same(got["aggregations"], want["aggregations"], kinds)


def pair(mapping, rows, cut=None, deletes=(), index="t"):
    """Both clients over the same docs: one shard, `cut` docs before a
    refresh (two segments), then `deletes` by _id."""
    out = []
    for c in (RefClient(), RestClient(device="cpu")):
        c.indices.create(index, {"settings": {"number_of_shards": 1,
                                              "number_of_replicas": 0},
                                 "mappings": mapping})
        for i, (did, src) in enumerate(rows):
            c.index(index, src, id=did)
            if cut is not None and i == cut - 1:
                c.indices.refresh(index)
        c.indices.refresh(index)
        for did in deletes:
            c.delete(index, did)
        c.indices.refresh(index)
        out.append(c)
    return tuple(out)


def both(clients, body, index="t"):
    ref, port = clients
    try:
        want = ref.search(index, body)
    except Exception as e:      # the reference refuses: the port does too
        with pytest.raises(Exception) as got:
            port.search(index, body)
        assert type(got.value).__name__ == type(e).__name__
        assert str(got.value) == str(e)
        return None
    assert_same(port.search(index, body), want, body)
    return want


# tests/test_aggs_longtail.py's shop data (its ip and geo_point fields
# left out) and its bodies over the served kinds
SHOP_MAPPING = {"properties": {
    "desc": {"type": "text"}, "grade": {"type": "double"},
    "weight": {"type": "double"}, "brand": {"type": "keyword"},
    "color": {"type": "keyword"}, "ts": {"type": "date"},
    "price": {"type": "long"}}}
SHOP_ROWS = []
for _did, _g, _w, _b, _c, _ts, _p in [
        ("1", 1.0, 2.0, "acme", "red", "2026-01-01", 10),
        ("2", 2.0, 3.0, "acme", "blue", "2026-01-02", 20),
        ("3", 3.0, 1.0, "bolt", "red", "2026-01-05", 10),
        ("4", 4.0, 4.0, "bolt", "green", "2026-02-01", 30),
        ("5", 5.0, None, "cork", "blue", "2026-02-15", 20),
        ("6", 2.5, 2.0, "dune", "red", "2026-03-01", 40)]:
    _src = {"desc": "widget thing", "grade": _g, "brand": _b, "color": _c,
            "ts": _ts, "price": _p}
    if _w is not None:
        _src["weight"] = _w
    SHOP_ROWS.append((_did, _src))
WIDGET = {"match": {"desc": "widget"}}
SHOP_BODIES = [
    ({"w": {"weighted_avg": {"value": {"field": "grade"},
                             "weight": {"field": "weight"}}}}, None),
    ({"w": {"weighted_avg": {"value": {"field": "grade"},
                             "weight": {"field": "weight",
                                        "missing": 1.0}}}}, None),
    ({"w": {"weighted_avg": {"value": {"field": "nope", "missing": 4.0},
                             "weight": {"field": "weight"}}}}, None),
    ({"m": {"median_absolute_deviation": {"field": "grade"}}}, None),
    ({"rare": {"rare_terms": {"field": "brand"}}}, None),
    ({"rare": {"rare_terms": {"field": "brand", "max_doc_count": 2}}},
     None),
    ({"mt": {"multi_terms": {"terms": [{"field": "brand"},
                                       {"field": "color"}]}}}, None),
    ({"mt": {"multi_terms": {"terms": [{"field": "color"},
                                       {"field": "brand"}]},
             "aggs": {"g": {"max": {"field": "grade"}}}}}, None),
    ({"mt": {"multi_terms": {"terms": [{"field": "brand"},
                                       {"field": "price"}], "size": 3},
             "aggs": {"u": {"cardinality": {"field": "price"}}}}}, None),
    ({"adj": {"adjacency_matrix": {"filters": {
        "cheap": {"range": {"price": {"lte": 20}}},
        "red": {"term": {"color": "red"}}}}}}, None),
    ({"adj": {"adjacency_matrix": {"separator": "+", "filters": {
        "a": {"term": {"brand": "acme"}}, "r": {"term": {"color": "red"}},
        "z": {"range": {"grade": {"gt": 2}}}}},
        "aggs": {"s": {"sum": {"field": "price"}},
                 "t": {"terms": {"field": "color"}}}}}, None),
    ({"h": {"auto_date_histogram": {"field": "ts", "buckets": 3}}}, None),
    ({"h": {"auto_date_histogram": {"field": "ts", "buckets": 20}}}, None),
    ({"h": {"auto_date_histogram": {"field": "ts", "buckets": 2},
            "aggs": {"p": {"sum": {"field": "price"}}}}}, None),
    ({"h": {"auto_date_histogram": {"field": "ts", "buckets": 5},
            "aggs": {"c": {"terms": {"field": "color"}}}}}, None),
    ({"ds": {"diversified_sampler": {"field": "brand",
                                     "max_docs_per_value": 1,
                                     "shard_size": 100},
             "aggs": {"n": {"value_count": {"field": "grade"}}}}}, WIDGET),
    ({"ds": {"diversified_sampler": {"field": "brand",
                                     "max_docs_per_value": 2}}}, WIDGET),
    ({"ds": {"diversified_sampler": {"field": "price",
                                     "max_docs_per_value": 1}}}, WIDGET),
    ({"mt": {"multi_terms": {"terms": [{"field": "brand"},
                                       {"field": "color"}]},
             "aggs": {"u": {"cardinality": {"field": "price"}}}}}, None),
    ({"rare": {"rare_terms": {"field": "brand"},
               "aggs": {"t": {"terms": {"field": "color"}}}}}, None),
    ({"mt": {"multi_terms": {"terms": [{"field": "brand"}]}}}, None),
    ({"th": {"top_hits": {"size": 2}}}, {"match_all": {}}),
    ({"th": {"top_hits": {"size": 3, "_source": {"includes": ["brand"]},
                          "sort": [{"price": "desc"}], "from": 1}}},
     {"match": {"color": "red"}}),
    ({"t": {"terms": {"field": "brand"},
            "aggs": {"th": {"top_hits": {"size": 1, "_source": ["brand"]}}}}},
     None),
    ({"f": {"filter": {"term": {"color": "red"}},
            "aggs": {"th": {"top_hits": {"size": 1}}}}}, None),
    ({"h": {"terms": {"field": "brand"}},
      "x": {"avg_bucket": {"buckets_path": "h>_count"}}}, None),
]


@pytest.fixture(scope="module", params=["1seg", "2seg_deletes"])
def shop(request):
    if request.param == "1seg":
        return pair(SHOP_MAPPING, SHOP_ROWS, index="shop")
    rows = SHOP_ROWS + [("7", {"desc": "widget gone", "brand": "acme",
                               "color": "red", "price": 99, "grade": 9.0,
                               "ts": "2026-05-01"})]
    return pair(SHOP_MAPPING, rows, cut=3, deletes=("7",), index="shop")


@pytest.mark.parametrize("i", range(len(SHOP_BODIES)))
def test_longtail_bodies(shop, i):
    aggs, query = SHOP_BODIES[i]
    body = {"size": 0, "aggs": aggs}
    if query:
        body["query"] = query
    both(shop, body, "shop")


# tests/test_aggs_extended.py's logs data (its geo_point left out): the
# pipelines, significant_terms, the sampler, matrix_stats
LOGS_MAPPING = {"properties": {"msg": {"type": "text"},
                               "service": {"type": "keyword"},
                               "level": {"type": "keyword"},
                               "latency": {"type": "double"},
                               "bytes": {"type": "double"},
                               "day": {"type": "integer"}}}
LOGS_ROWS = TA.LOGS_ROWS


def _hist(pipelines, subs=None):
    return {"h": {"histogram": {"field": "day", "interval": 1},
                  "aggs": {**(subs if subs is not None else {
                      "lat": {"avg": {"field": "latency"}}}),
                      **pipelines}}}


ERROR = {"term": {"level": "error"}}
LOGS_BODIES = [
    ({"sig": {"significant_terms": {"field": "service",
                                    "min_doc_count": 2}}}, ERROR),
    ({"sig": {"significant_terms": {"field": "service", "chi_square": {},
                                    "min_doc_count": 1}}}, ERROR),
    ({"sig": {"significant_terms": {"field": "service", "percentage": {},
                                    "min_doc_count": 1}}}, ERROR),
    ({"sig": {"significant_terms": {"field": "level", "min_doc_count": 1},
              "aggs": {"l": {"avg": {"field": "latency"}},
                       "d": {"terms": {"field": "service"}}}}},
     {"match": {"msg": "timeout"}}),
    ({"s": {"sampler": {"shard_size": 2},
            "aggs": {"m": {"max": {"field": "latency"}}}}},
     {"match": {"msg": "error"}}),
    ({"s": {"sampler": {"shard_size": 3},
            "aggs": {"t": {"significant_text": {"field": "msg",
                                                "min_doc_count": 1}}}}},
     {"match": {"msg": "error"}}),
    ({"m": {"matrix_stats": {"fields": ["latency", "bytes"]}}}, None),
    ({"m": {"matrix_stats": {"fields": ["latency", "nope"]}}}, None),
    (_hist({"ma": {"moving_avg": {"buckets_path": "_count",
                                  "window": 2}}}), None),
    (_hist({"ma": {"moving_avg": {"buckets_path": "lat", "window": 3,
                                  "model": "linear"}}}), None),
    (_hist({"mf": {"moving_fn": {"buckets_path": "_count", "window": 3,
                                 "script": "MovingFunctions.max(values)"}}}),
     None),
    (_hist({f"mf_{fn}": {"moving_fn": {
        "buckets_path": "lat", "window": 2, "shift": 1,
        "script": {"source": f"MovingFunctions.{fn}(values)"}}}
        for fn in ("min", "sum", "unweightedAvg", "stdDev",
                   "linearWeightedAvg")}), None),
    (_hist({"sd": {"serial_diff": {"buckets_path": "_count", "lag": 1}},
            "sd2": {"serial_diff": {"buckets_path": "lat.value",
                                    "lag": 2}}}), None),
    (_hist({"srt": {"bucket_sort": {"sort": [{"_count": {"order": "desc"}}],
                                    "size": 2}}}, {}), None),
    (_hist({"srt": {"bucket_sort": {"sort": [{"lat": "asc"}], "from": 1}},
            "cum": {"cumulative_sum": {"buckets_path": "lat"}}}), None),
    (_hist({"pb": {"percentiles_bucket": {"buckets_path": "_count",
                                          "percents": [50.0, 100.0]}}}, {}),
     None),
    (_hist({"sb": {"stats_bucket": {"buckets_path": "lat.value"}},
            "ab": {"avg_bucket": {"buckets_path": "lat"}},
            "sm": {"sum_bucket": {"buckets_path": "lat"}},
            "mn": {"min_bucket": {"buckets_path": "lat"}},
            "mx": {"max_bucket": {"buckets_path": "lat"}},
            "pb": {"percentiles_bucket": {"buckets_path": "lat"}}}), None),
    (_hist({"d": {"derivative": {"buckets_path": "lat",
                                 "gap_policy": "insert_zeros"}},
            "dd": {"derivative": {"buckets_path": "d"}}}), None),
    ({"t": {"terms": {"field": "service"},
            "aggs": {"lat": {"avg": {"field": "latency"}},
                     "srt": {"bucket_sort": {"sort": [{"lat": "desc"}]}},
                     "cum": {"cumulative_sum": {"buckets_path": "_count"}},
                     "mx": {"max_bucket": {"buckets_path": "lat"}}}}},
     None),
]


@pytest.fixture(scope="module", params=["1seg", "2seg_deletes"])
def logs(request):
    if request.param == "1seg":
        return pair(LOGS_MAPPING, LOGS_ROWS, index="logs")
    rows = LOGS_ROWS + [("x", {"msg": "error gone", "service": "svc-z",
                               "level": "error", "latency": 5.0,
                               "bytes": 1.0, "day": 9})]
    return pair(LOGS_MAPPING, rows, cut=4, deletes=("x",), index="logs")


@pytest.mark.parametrize("i", range(len(LOGS_BODIES)))
def test_extended_bodies(logs, i):
    aggs, query = LOGS_BODIES[i]
    body = {"size": 0, "aggs": aggs}
    if query:
        body["query"] = query
    both(logs, body, "logs")


def test_sampler_takes_one_threshold_over_segments():
    """test_aggs_extended.py's sampler over two segments: the second pass
    samples shard_size docs shard-wide, not per segment."""
    rows = [(f"a{i}", {"msg": "error " + "pad " * i, "v": float(i)})
            for i in range(8)]
    clients = pair({"properties": {"msg": {"type": "text"},
                                   "v": {"type": "double"}}}, rows, cut=4)
    body = {"size": 0, "query": {"match": {"msg": "error"}},
            "aggs": {"s": {"sampler": {"shard_size": 3},
                           "aggs": {"mx": {"max": {"field": "v"}}}}}}
    want = both(clients, body)
    assert want["aggregations"]["s"] == {"doc_count": 3, "mx": {"value": 2.0}}
    assert len(clients[1]._indices["t"].engine.segments) == 2


def test_matrix_stats_large_mean_small_spread():
    """test_aggs_extended.py's precision case: 300 values about 1e4."""
    rng = np.random.default_rng(0)
    vals = 1.0e4 + rng.standard_normal(300)
    rows = [(str(i), {"a": float(v), "b": float(2 * v)})
            for i, v in enumerate(vals)]
    clients = pair({"properties": {"a": {"type": "double"},
                                   "b": {"type": "double"}}}, rows, cut=150)
    both(clients, {"size": 0, "aggs": {"m": {"matrix_stats": {
        "fields": ["a", "b"]}}}})


# tests/test_aggregations.py::test_pipeline_aggs / ::test_top_hits_root,
# and tests/test_aggs_deep.py's top_hits and deferred pipelines
AGG_BODIES = [
    {"m": {"date_histogram": {"field": "ts", "calendar_interval": "month"},
           "aggs": {"s": {"sum": {"field": "price"}},
                    "cum": {"cumulative_sum": {"buckets_path": "s.value"}},
                    "d": {"derivative": {"buckets_path": "_count"}},
                    "total": {"sum_bucket": {"buckets_path": "s.value"}}}}},
    {"th": {"top_hits": {"size": 2}}},
    {"th": {"top_hits": {"size": 40}}},
]
DEEP_BODIES = [
    {"rg": {"terms": {"field": "region"},
            "aggs": {"th": {"top_hits": {"size": 1}}}}},
    {"rg": {"terms": {"field": "region"},
            "aggs": {"th": {"top_hits": {"size": 2, "sort": [
                {"qty": {"order": "desc"}}], "_source": {
                    "includes": ["qty", "user"]}}}}}},
    {"d": {"histogram": {"field": "day", "interval": 1},
           "aggs": {"card": {"cardinality": {"field": "user"}},
                    "dv": {"derivative": {"buckets_path": "card.value"}}}}},
    {"rg": {"terms": {"field": "region"},
            "aggs": {"pd": {"terms": {"field": "product"},
                            "aggs": {"s": {"sum": {"field": "qty"}},
                                     "bs": {"bucket_sort": {"from": 1}}}}}}},
    {"rg": {"terms": {"field": "region"},
            "aggs": {"u": {"terms": {"field": "user"}},
                     "c": {"derivative": {"buckets_path": "_count"}},
                     "keep": {"bucket_sort": {"sort": [{"_count": "asc"}],
                                              "size": 1}}}}},
    {"d": {"histogram": {"field": "day", "interval": 1},
           "aggs": {"card": {"cardinality": {"field": "user"}},
                    "q": {"sum": {"field": "qty"}},
                    "dv": {"derivative": {"buckets_path": "card"}},
                    "cdv": {"cumulative_sum": {"buckets_path": "dv"}},
                    "cq": {"cumulative_sum": {"buckets_path": "q"}},
                    "bs": {"bucket_sort": {"sort": [{"cdv": "desc"}]}}}}},
    {"c": {"composite": {"sources": [{"r": {"terms": {"field": "region"}}}],
                         "size": 5},
           "aggs": {"th": {"top_hits": {"size": 1}},
                    "u": {"cardinality": {"field": "user"}}}}},
]


@pytest.fixture(scope="module", params=["1seg", "2seg"])
def agg_pair(request):
    return pair(TA.AGG_MAPPING, TA.AGG_ROWS,
                cut=None if request.param == "1seg" else 3)


@pytest.mark.parametrize("i", range(len(AGG_BODIES)))
def test_reference_pipeline_and_root_top_hits(agg_pair, i):
    body = {"size": 0, "query": {"match_all": {}}, "aggs": AGG_BODIES[i]}
    want = both(agg_pair, body)
    if "th" in AGG_BODIES[i]:
        # the root top_hits reads the shard's candidates: 16 docs a
        # segment for a size-0 body (the reference's window; 6 docs here)
        assert len(want["aggregations"]["th"]["hits"]["hits"]) == min(
            AGG_BODIES[i]["th"]["top_hits"]["size"], 6)


@pytest.fixture(scope="module")
def deep_pair():
    return pair(TA.DEEP_MAPPING, TA.DEEP_ROWS, cut=4)


@pytest.mark.parametrize("i", range(len(DEEP_BODIES)))
def test_deep_top_hits_and_deferred_pipelines(deep_pair, i):
    both(deep_pair, {"size": 0, "aggs": DEEP_BODIES[i]})


def test_bucket_sort_in_a_refined_subtree_runs_once(deep_pair):
    """test_aggs_deep.py: a refined subtree comes back pipelined; its
    bucket_sort from 1 keeps exactly one of eu's two products."""
    r = deep_pair[1].search("t", {"size": 0, "aggs": DEEP_BODIES[3]})
    eu = next(b for b in r["aggregations"]["rg"]["buckets"]
              if b["key"] == "eu")
    assert len(eu["pd"]["buckets"]) == 1


# ---------------------------------------------------------------------
# a seeded set over three segments with deletes, a forcemerge, msearch
# ---------------------------------------------------------------------

MONTH = {"field": "ts", "calendar_interval": "month"}
SEEDED_BODIES = [
    {"size": 0, "aggs": {"mt": {"multi_terms": {"terms": [
        {"field": "name.raw"}, {"field": "ok"}], "size": 6},
        "aggs": {"p": {"stats": {"field": "price"}}}},
        "mq": {"multi_terms": {"terms": [{"field": "cat"},
                                         {"field": "qty"}], "size": 4}}}},
    {"size": 0, "aggs": {"r": {"rare_terms": {"field": "cat",
                                              "max_doc_count": 40},
                               "aggs": {"n": {"terms": {"field": "ok"}},
                                        "a": {"avg": {"field": "price"}}}}}},
    {"size": 0, "query": {"match": {"name": "red"}}, "aggs": {
        "j": {"significant_terms": {"field": "cat", "min_doc_count": 1}},
        "c": {"significant_terms": {"field": "name.raw", "chi_square": {},
                                    "size": 3}},
        "p": {"significant_terms": {"field": "cat", "percentage": {}}}}},
    {"size": 0, "query": {"match": {"name": "fast tiny"}}, "aggs": {
        "t": {"significant_text": {"field": "name", "min_doc_count": 2}},
        "s": {"sampler": {"shard_size": 12}, "aggs": {
            "t": {"significant_text": {"field": "name", "shard_size": 5,
                                       "min_doc_count": 1}},
            "a": {"avg": {"field": "price"}}}}}},
    {"size": 0, "query": {"match": {"name": "blue"}}, "aggs": {
        "d": {"diversified_sampler": {"field": "cat",
                                      "max_docs_per_value": 2,
                                      "shard_size": 30},
              "aggs": {"s": {"stats": {"field": "price"}},
                       "t": {"terms": {"field": "cat"}}}},
        "q": {"diversified_sampler": {"field": "qty",
                                      "max_docs_per_value": 1}}}},
    {"size": 0, "query": {"range": {"price": {"gte": 50}}}, "aggs": {
        "a": {"adjacency_matrix": {"filters": {
            "ok": {"term": {"ok": True}}, "c1": {"term": {"cat": "c1"}},
            "big": {"range": {"qty": {"gte": 100}}}}},
            "aggs": {"c": {"cardinality": {"field": "cat"}}}},
        "h": {"auto_date_histogram": {"field": "ts", "buckets": 7},
              "aggs": {"a": {"avg": {"field": "price"}},
                       "t": {"terms": {"field": "cat", "size": 2}}}}}},
    {"size": 0, "aggs": {
        "w": {"weighted_avg": {"value": {"field": "price"},
                               "weight": {"field": "qty", "missing": 3}}},
        "m": {"median_absolute_deviation": {"field": "price"}},
        "x": {"matrix_stats": {"fields": ["price", "qty", "score"]}},
        "y": {"matrix_stats": {"fields": ["price", "ts"]}}}},
    {"size": 3, "query": {"match": {"name": "green slow"}}, "aggs": {
        "th": {"top_hits": {"size": 4, "_source": {"includes": ["cat",
                                                               "price"]}}},
        "t": {"terms": {"field": "cat", "size": 3},
              "aggs": {"th": {"top_hits": {"size": 2, "sort": [
                  {"price": {"order": "desc"}}], "_source": ["price"]}}}}}},
    {"size": 0, "aggs": {"m": {"date_histogram": MONTH, "aggs": {
        "s": {"sum": {"field": "price"}},
        "d": {"derivative": {"buckets_path": "s"}},
        "c": {"cumulative_sum": {"buckets_path": "s"}},
        "mf": {"moving_fn": {"buckets_path": "s", "window": 3, "script":
                             "MovingFunctions.unweightedAvg(values)"}},
        "sd": {"serial_diff": {"buckets_path": "s", "lag": 1}},
        "k": {"derivative": {"buckets_path": "_key"}},
        "p": {"percentiles": {"field": "price", "percents": [99.0]}},
        "pk": {"cumulative_sum": {"buckets_path": "p[99.0]"}},
        "top": {"bucket_sort": {"sort": [{"s": {"order": "desc"}}],
                                "size": 5}},
        "ab": {"avg_bucket": {"buckets_path": "s"}},
        "xb": {"max_bucket": {"buckets_path": "s"}},
        "sb": {"stats_bucket": {"buckets_path": "s"}},
        "pb": {"percentiles_bucket": {"buckets_path": "s"}}}}}},
    {"size": 0, "aggs": {"h": {"histogram": {"field": "qty",
                                             "interval": 50},
                               "aggs": {"c": {"cardinality": {
                                   "field": "cat"}},
                                   "t": {"terms": {"field": "cat"}},
                                   "d": {"derivative": {
                                       "buckets_path": "c"}},
                                   "pb": {"percentiles_bucket": {
                                       "buckets_path": "c"}}}}}},
    {"size": 0, "aggs": {"c": {"composite": {"size": 9, "sources": [
        {"n": {"terms": {"field": "name.raw", "order": "desc"}}},
        {"p": {"histogram": {"field": "price", "interval": 125}}},
        {"m": {"date_histogram": {"field": "ts",
                                  "calendar_interval": "quarter"}}}],
        "after": {"n": "red", "p": 125.0, "m": 1688169600000}},
        "aggs": {"s": {"sum": {"field": "qty"}},
                 "k": {"terms": {"field": "ok"}}}},
        "mv": {"composite": {"sources": [{"c": {"terms": {
            "field": "cat"}}}]}}}},
    {"size": 0, "aggs": {"mv": {"composite": {"sources": [
        {"c": {"terms": {"field": "cat"}}},
        {"o": {"terms": {"field": "ok"}}}]}}}},
]


@pytest.fixture(scope="module")
def seeded():
    ops = TA.seeded_bulk()
    return tuple(TA._apply(c, ops) for c in (RefClient(),
                                             RestClient(device="cpu")))


@pytest.mark.parametrize("i", range(len(SEEDED_BODIES)))
def test_seeded_bodies_over_segments_with_deletes(seeded, i):
    segs = seeded[1]._indices["s"].engine.segments
    assert len(segs) >= 3 and any(s.live_count < s.ndocs for s in segs)
    both(seeded, SEEDED_BODIES[i], "s")


def test_seeded_bodies_after_a_forcemerge_and_in_msearch():
    ops = TA.seeded_bulk(seed=29)
    ref, port = (TA._apply(c, ops) for c in (RefClient(),
                                             RestClient(device="cpu")))
    for c in (ref, port):
        c.indices.forcemerge("s", max_num_segments=1)
    assert len(port._indices["s"].engine.segments) == 1
    for body in SEEDED_BODIES:
        both((ref, port), body, "s")
    lines = sum([[{}, b] for b in SEEDED_BODIES[:8]], [])
    got = port.msearch(lines, index="s")["responses"]
    want = ref.msearch(lines, index="s")["responses"]
    for g, w, b in zip(got, want, lines[1::2]):
        assert_same(g, w, b)


def test_composite_paged_to_its_end(seeded):
    """A composite over two sources paged by after_key to its end: the
    pages are the reference's, and together they hold every bucket of
    the grouping once."""
    ref, port = seeded
    agg = {"sources": [{"c": {"terms": {"field": "name.raw"}}},
                       {"d": {"date_histogram": {"field": "ts",
                                                 "calendar_interval":
                                                     "month"}}}],
           "size": 7}
    full = port.search("s", {"size": 0, "aggs": {"c": {"composite": dict(
        agg, size=100000)}}})["aggregations"]["c"]["buckets"]
    seen, pages = [], 0
    after = None
    while True:
        body = {"size": 0, "aggs": {"c": {"composite": dict(
            agg, **({"after": after} if after else {}))}}}
        want = both((ref, port), body, "s")["aggregations"]["c"]
        pages += 1
        if not want["buckets"]:
            assert "after_key" not in want
            break
        seen += [(tuple(b["key"].values()), b["doc_count"])
                 for b in want["buckets"]]
        after = want["after_key"]
    assert pages == -(-len(full) // 7) + 1
    assert seen == [(tuple(b["key"].values()), b["doc_count"])
                    for b in full]
    assert len(set(k for k, _ in seen)) == len(seen)


# ---------------------------------------------------------------------
# the reference's behaviours kept (ROADMAP Queue 3)
# ---------------------------------------------------------------------

def test_composite_histogram_source_edges_against_the_reference():
    """A composite histogram source is floor(f32 value / f32 interval).
    The reference's served program folds the division into a multiply by
    f32(1 / interval), as its histogram agg does (Queue 3); the port
    divides, as numpy and OpenSearch's double arithmetic do. Over
    -2.0..5.9 in steps of 0.1 (f32 views of doubles) and integer prices,
    each package's buckets are its own arithmetic's: equal at intervals 7,
    3 and 0.7, and at 0.1 and 0.3 the reference moves some values at a
    bucket's upper edge one bucket up (1.3 / 0.1 = 12.999999 in f32, into
    bucket 1.2 in the port, 1.3 in the reference)."""
    rows = [(str(v), {"price": v, "f": v / 10}) for v in range(-20, 60)]
    clients = pair({"properties": {"price": {"type": "integer"},
                                   "f": {"type": "double"}}}, rows)
    moved = {}
    for field, interval in (("price", 7), ("price", 3), ("f", 0.7),
                            ("f", 0.1), ("f", 0.3)):
        vals = np.array([v if field == "price" else v / 10
                         for v in range(-20, 60)]).astype(np.float32)
        div = np.floor(vals / np.float32(interval))
        mul = np.floor(vals * np.float32(1 / np.float32(interval)))
        body = {"size": 0, "aggs": {"c": {"composite": {
            "size": 1000, "sources": [{"h": {"histogram": {
                "field": field, "interval": interval}}}]}}}}
        got = []
        for c, b in zip(clients, (mul, div)):
            r = c.search("t", body)["aggregations"]["c"]["buckets"]
            keys, counts = np.unique(b, return_counts=True)
            assert [(x["key"]["h"], x["doc_count"]) for x in r] == [
                (float(k) * interval, int(n)) for k, n in zip(keys, counts)]
            got.append(r)
        moved[(field, interval)] = int((div != mul).sum())
        if not moved[(field, interval)]:
            assert_same(*(c.search("t", body) for c in reversed(clients)),
                        body)
    assert moved == {("price", 7): 0, ("price", 3): 0, ("f", 0.7): 0,
                     ("f", 0.1): 8, ("f", 0.3): 3}


def test_composite_limit_and_missing_bucket(seeded):
    """The reference's limit of 2^22 composite buckets (so its i32
    combined ordinal cannot overflow) raises its QueryParseError in the
    port too; `missing_bucket` is not read: a doc lacking a source is in
    no bucket."""
    ref, port = seeded
    both(seeded, {"size": 0, "aggs": {"c": {"composite": {"sources": [
        {"a": {"histogram": {"field": "ts", "interval": 1000}}},
        {"b": {"histogram": {"field": "price", "interval": 0.01}}}]}}}},
        "s")
    body = {"size": 0, "aggs": {"c": {"composite": {"size": 500, "sources": [
        {"s": {"histogram": {"field": "score", "interval": 1,
                             "missing_bucket": True}}}]}}}}
    want = both(seeded, body, "s")
    n_score = port.search("s", {"size": 0, "query": {"exists": {
        "field": "score"}}})["hits"]["total"]["value"]
    assert sum(b["doc_count"] for b in want["aggregations"]["c"][
        "buckets"]) == n_score < port.search("s", {"size": 0})[
        "hits"]["total"]["value"]


def test_root_top_hits_reads_the_candidate_window():
    """A root top_hits with `size` past the shard's candidate window (16
    a segment for a size-0 body) returns the window's hits, by score,
    in the reference and in the port."""
    rows = [(str(i), {"body": "red " * (1 + i % 5)}) for i in range(40)]
    clients = pair({"properties": {"body": {"type": "text"}}}, rows)
    for size, frm in ((0, 0), (5, 0), (0, 10)):
        want = both(clients, {"size": size, "from": frm,
                              "query": {"match": {"body": "red"}},
                              "aggs": {"th": {"top_hits": {"size": 30}}}})
        got = len(want["aggregations"]["th"]["hits"]["hits"])
        assert got == max(16, 1 << (frm + size - 1).bit_length()) < 30


def test_auto_date_ladder_months_of_30_days():
    """auto_date_histogram's ladder counts a month as 30 days and a year
    as 365 (the reference's), so a "1M" bucket starts at a multiple of
    30 days since the epoch, not on the first of a month."""
    rows = [(str(i), {"ts": f"2024-{1 + i % 12:02d}-{1 + i % 27:02d}"})
            for i in range(60)]
    clients = pair({"properties": {"ts": {"type": "date"}}}, rows)
    want = both(clients, {"size": 0, "aggs": {"h": {"auto_date_histogram": {
        "field": "ts", "buckets": 13}}}})["aggregations"]["h"]
    assert want["interval"] == "1M"
    assert all(b["key"] % 2_592_000_000 == 0 for b in want["buckets"])
    assert any(not b["key_as_string"].endswith("-01T00:00:00.000Z")
               for b in want["buckets"])


def test_significance_heuristics_are_the_references(seeded):
    """The scores are the reference's own JLH, chi_square and percentage
    (`_significance_score`), over the foreground and the shard's live
    background, recomputed here from the counts."""
    from opensearch_tpu_torch.search import aggregations as A
    ref, port = seeded
    body = {"size": 0, "query": {"match": {"name": "red"}}, "aggs": {
        h: {"significant_terms": {"field": "cat", "min_doc_count": 1,
                                  **({h: {}} if h != "jlh" else {})}}
        for h in ("jlh", "chi_square", "percentage")}}
    want = both(seeded, body, "s")["aggregations"]
    for h, r in want.items():
        for b in r["buckets"]:
            assert b["score"] == A.significance_score(
                b["doc_count"], r["doc_count"], b["bg_count"],
                r["bg_count"], h)


def test_pipeline_paths_the_reference_does_not_read(seeded):
    """`_key` and `name[p]` buckets_paths read None in the reference's
    `_bucket_path_value` (it splits on `>` and `.` and walks names): a
    derivative of them is None everywhere, a cumulative_sum 0; the port
    keeps that, and `gap_policy` is not read."""
    body = SEEDED_BODIES[8]
    got = both(seeded, body, "s")["aggregations"]["m"]["buckets"]
    assert all(b["k"]["value"] is None and b["pk"]["value"] == 0.0
               for b in got)


# ---------------------------------------------------------------------
# the script pipelines
# ---------------------------------------------------------------------

@pytest.mark.parametrize("aggs,name", [
    ({"x": {"histogram": {"field": "price", "interval": 50}, "aggs": {
        "b": {"bucket_script": {"buckets_path": {"c": "_count"},
                                "script": "params.c * 2"}}}}},
     "bucket_script"),
    ({"x": {"terms": {"field": "cat"}, "aggs": {
        "b": {"bucket_selector": {"buckets_path": {"c": "_count"},
                                  "script": "params.c > 2"}}}}},
     "bucket_selector"),
    ({"x": {"date_histogram": MONTH, "aggs": {
        "m": {"moving_fn": {"buckets_path": "_count", "window": 2,
                            "script": "values.length"}}}}}, "moving_fn"),
    ({"x": {"date_histogram": MONTH, "aggs": {
        "m": {"moving_fn": {"buckets_path": "_count", "window": 2,
                            "script": "MovingFunctions.ewma(values, 0.3)"}}}}},
     "moving_fn"),
])
def test_script_pipelines_raise(seeded, aggs, name):
    """The script pipelines serve the reference's response (a script it
    cannot run, `MovingFunctions.ewma`, is its ScriptError in both)."""
    both(seeded, {"size": 0, "aggs": aggs}, "s")


# ---------------------------------------------------------------------
# chip_smoke.py phase 15's brute force on a small bench corpus
# ---------------------------------------------------------------------

BENCH_NDOCS = 3000


@pytest.fixture(scope="module")
def bench_longtail():
    """Phase 7's end state at a small size on the CPU, as phase 15 finds
    it: the bench corpus (guardrail, aggregation and title columns), its
    REINDEXED re-indexed _ids in a second segment, then a third segment
    of later docs without a ts (phase 14's)."""
    import chip_smoke as CS
    from opensearch_tpu_torch import bench_corpus as bc
    corpus = bc.build_corpus(BENCH_NDOCS)
    columns = bc.guardrail_columns(BENCH_NDOCS)
    aggcols = bc.agg_columns(BENCH_NDOCS)
    title = bc.build_title_corpus(BENCH_NDOCS)
    port = RestClient(device="cpu")
    bc.make_index(port, corpus, columns=columns, title=title, aggs=aggcols,
                  title_source=True)
    ix = CS.NumpyIndex(corpus, columns, title)
    vs = bc.vocab_strings(len(corpus[0]) - 1)
    q2 = bc.pick_queries(corpus[4], 16)
    body_terms = [t for i in range(16) for t in (list(q2[i][:2]), None)]
    olds = np.arange(CS.REINDEXED) * 41 + 7
    docs = [(int(old), list(q2[j % 16][:2]) + [int(q2[j % 16][0])], j % 3,
             j, CS.reindexed_cols(j)) for j, old in enumerate(olds)]
    for old, ts, st, pr, cols in docs:
        port.index("bench", {"body": " ".join(vs[t] for t in ts),
                             "status": bc.STATUS_VALUES[st], "price": pr,
                             **cols}, id=str(old))
    port.indices.refresh("bench")
    ix.reindex(docs)
    for j in range(6):
        terms = [int(q2[j][0]), int(q2[j][0])]
        port.index("bench", {"body": " ".join(vs[t] for t in terms),
                             "status": "published", "price": 301 + j},
                   id=f"late{j}")
        ix.add(terms, 2, 301 + j, f"late{j}")
    port.indices.refresh("bench")
    big = {"client": port, "ix": ix, "aggs": aggcols, "title": title,
           "corpus": corpus, "body_terms": body_terms}
    assert len(port._indices["bench"].engine.segments) == 3
    return big


@pytest.mark.parametrize("cls", ["a_composite_export", "b_time_series_panel",
                                 "c_top_hits", "d_groupings", "e_metrics",
                                 "f_significance_samplers"])
def test_phase15_brute_force_matches_the_port(bench_longtail, cls):
    """Phase 15's bodies over the small bench state: every response of
    the port on the CPU (a composite paged to its end) passes the chip
    run's brute force."""
    import chip_smoke as CS
    big = bench_longtail
    port = big["client"]
    oracle = CS.LongtailOracle(big["ix"], big["aggs"], big["title"])
    sums, sketch, ms_err = CS.SumCheck(), CS.Counter(), {}
    check = CS.longtail_checks(oracle, sums, sketch, ms_err)[cls]
    c = oracle.cols()
    items = CS.longtail_classes(big, 4)[cls]
    for i, (body, ts) in enumerate(items):
        pages = CS.lt_pages(port, body)
        m, score = oracle.matched(body, ts, c)
        check(pages, body, m, score, c, f"{cls} {i}")
    if cls == "a_composite_export":
        assert len(pages) > 1
    if cls == "f_significance_samplers":
        assert all(port.search("bench", b)["aggregations"]["s"]["t"][
            "doc_count"] > 0 for b, _ in items)
