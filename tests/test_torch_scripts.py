"""painless-lite, function_score, script and script_score, and the host
script contexts of the port, against the JAX package on the CPU.

- The interpreter: the host cases of the reference's tests/test_script.py
  through both packages' `execute` (equal results, or a ScriptError in
  both).
- `eval_device` over torch tensors against the reference's over jnp, on
  the same numpy columns: bit-equal where no transcendental enters,
  within 1e-5 relative where one does.
- End to end over a seeded shop corpus in two segments, the first with
  deletes, through both packages' RestClient: every function_score
  function, score_mode, boost_mode and modifier, decay on numeric and
  date fields (the date decay reads the f32 view of epoch ms, as the
  reference's: a tolerance kept and pinned here), random_score bit-equal,
  script / script_score with min_score and their 400s. Pages agree on
  totals, ids and order (except among docs whose reference scores lie
  within the tolerance of each other); scores within 1 ULP where the
  factors alone make them (a match_all child), within 1e-6 relative over
  a BM25 child (its 1 ULP FMA contract carried through the factors),
  and within 1e-5 relative where a transcendental enters.
- A `script` in a bool's filter rides B3 where the reference's fastpath
  does (its mask by `eval_device`); at the root the general path.
- The host contexts: script_fields, the `_script` sort and its 400s,
  scripted updates, upserts and ctx.op, terms_set's
  minimum_should_match_script, scripted_metric and the script pipelines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.rest.client import ApiError as RefApiError
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu.script import painless_lite as rpl
from opensearch_tpu.search import fastpath as rfp
from opensearch_tpu_torch import ApiError, RestClient
from opensearch_tpu_torch.script import painless_lite as pl
from opensearch_tpu_torch.search import compiler as C
from opensearch_tpu_torch.search import fastpath
from opensearch_tpu_torch.search import query_dsl as dsl
from tests.test_torch_bool import (ROUTES, _route_counts,  # noqa: F401
                                   reference_fastpath)

jax.config.update("jax_platforms", "cpu")

RTOL_T = 1e-5       # a transcendental enters (another libm than XLA's)
# a BM25 child: the reference's XLA program may contract the child's
# BM25 into FMAs (the 1 ULP contract), which a factor then carries
RTOL_BM25 = 1e-6
NDOCS = 96
T0 = 1_767_225_600_000          # 2026-01-01 in epoch ms
DAY = 86_400_000
WORDS = ["red", "blue", "green", "shirt", "hat", "coat", "wool", "silk",
         "warm", "light", "dress", "scarf"]
MAPPING = {"settings": {"number_of_replicas": 0}, "mappings": {"properties": {
    "name": {"type": "text"}, "status": {"type": "keyword"},
    "price": {"type": "float"}, "rating": {"type": "double"},
    "qty": {"type": "integer"}, "ts": {"type": "date"},
    "tag": {"type": "keyword"}}}}
DELETED = ("d1", "d4", "d9", "d16", "d25")


def make_docs():
    """NDOCS docs (numpy seed 57): 2-5 words, a status, a price, a rating
    in [0, 5), a qty and a ts within 60 days of 2026-01-01; every fifth
    doc lacks a rating, every seventh a ts, every eleventh a price."""
    rng = np.random.default_rng(57)
    docs = []
    for i in range(NDOCS):
        d = {"name": " ".join(rng.choice(WORDS, int(rng.integers(2, 6)))),
             "status": ["new", "sale", "old"][int(rng.integers(3))],
             "qty": int(rng.integers(0, 20)),
             "tag": f"t{int(rng.integers(4))}"}
        if i % 11:
            d["price"] = round(float(rng.uniform(1, 200)), 2)
        if i % 5:
            d["rating"] = round(float(rng.uniform(0, 5)), 3)
        if i % 7:
            d["ts"] = T0 + int(rng.integers(-60 * DAY, 60 * DAY))
        docs.append(d)
    return docs


def fill(c, docs, nseg=2):
    c.indices.create("s", MAPPING)
    step = NDOCS // nseg
    for lo in range(0, NDOCS, step):
        c.bulk(sum([[{"index": {"_index": "s", "_id": f"d{i}"}}, docs[i]]
                    for i in range(lo, lo + step)], []), refresh=True)
    if nseg > 1:
        c.bulk([{"delete": {"_index": "s", "_id": d}} for d in DELETED],
               refresh=True)
    return c


@pytest.fixture(scope="module")
def docs():
    return make_docs()


@pytest.fixture(scope="module")
def clients(docs):
    ref, port = fill(RefClient(), docs), fill(RestClient(device="cpu"), docs)
    segs = port._indices["s"].engine.segments
    assert len(segs) == 2 and segs[0].live_count < segs[0].ndocs
    return ref, port


def ulp_close(got, want) -> bool:
    g, w = np.float32(got), np.float32(want)
    return bool(abs(g - w) <= np.spacing(max(abs(g), abs(w))))


def same_page(got, want, rtol=None, what=""):
    """Totals equal; scores within 1 ULP (rtol None) or rtol relative;
    ids and order identical except among docs whose reference scores lie
    within that tolerance of each other; sources and fields equal."""
    assert got["hits"]["total"] == want["hits"]["total"], what

    def close(a, b):
        if a is None or b is None:
            return a is b
        return ulp_close(a, b) if rtol is None else \
            abs(a - b) <= rtol * max(abs(a), abs(b))

    assert close(got["hits"]["max_score"], want["hits"]["max_score"]), what
    gh, wh = got["hits"]["hits"], want["hits"]["hits"]
    assert len(gh) == len(wh), what
    wscore = {h["_id"]: h["_score"] for h in wh}
    for i, (g, w) in enumerate(zip(gh, wh)):
        if g["_id"] != w["_id"]:
            # a swap only among reference scores within the tolerance
            assert g["_id"] in wscore and close(wscore[g["_id"]],
                                                w["_score"]), (what, i)
        assert close(g["_score"], wscore.get(g["_id"], w["_score"])), \
            (what, i, g["_score"], w["_score"])
        for k in ("_source", "fields", "sort"):
            assert g.get(k) == w.get(k), (what, i, k)
    for k in ("aggregations",):
        assert got.get(k) == want.get(k), what


def both_raise(ref, port, body, index="s"):
    with pytest.raises(RefApiError) as r:
        ref.search(index, body)
    with pytest.raises(ApiError) as p:
        port.search(index, body)
    assert (p.value.status, p.value.err_type, str(p.value)) == (
        r.value.status, r.value.err_type, str(r.value))
    return p.value


# ---------------------------------------------------------------------
# the interpreter: tests/test_script.py's host cases
# ---------------------------------------------------------------------

HOST_CASES = [
    ("1 + 2 * 3", {}), ("(1 + 2) * 3", {}), ("2 * 3 % 4", {}),
    ("7 / 2", {}), ("-7 / 2", {}), ("7.0 / 2", {}), ("-7 % 3", {}),
    ("1 / 0", {}), ("'a' + 'b' + 1", {}),
    ("x > 3 ? 'big' : 'small'", {"x": 5}), ("true && false || true", {}),
    ("!false", {}), ("def a = 2; def b = a * a; b + 1", {}),
    ("if (x < 0) { return 'neg' } else if (x == 0) { return 'zero' } "
     "else { return 'pos' }", {"x": -2}),
    ("if (x < 0) { return 'neg' } else if (x == 0) { return 'zero' } "
     "else { return 'pos' }", {"x": 0}),
    ("def t = 0; for (v in vals) { t += v } return t", {"vals": [1, 2, 3]}),
    ("Math.max(Math.abs(-3), 2)", {}), ("Math.pow(2, 10)", {}),
    ("Math.log(Math.E)", {}), ("'Hello'.toLowerCase()", {}),
    ("'hello world'.contains('wor')", {}), ("'a,b,c'.split(',')", {}),
    ("'abc'.substring(1)", {}), ("def l = [1, 2]; l.add(3); l.size()", {}),
    ("def m = ['a': 1]; m.put('b', 2); m.containsKey('b')", {}),
    ("def m = [:]; m.isEmpty()", {}),
    ("params.getOrDefault('missing', 42)", {"params": {}}),
    ("def t = 0; for (v in vals) { t += v }",
     {"vals": list(range(200_001))}),
    ("def = 1", {}), ("1 +", {}), ("// note\n1 + 1 /* mid */ + 1", {}),
    (r"'a\\nb'", {}), (r"'a\nb'", {}),
    ("int total = 0; for (int i = 0; i < 10; ++i) { total += i } "
     "return total;", {}),
    ("def total = 0; for (def x : [1,2,3]) { total += x } return total;",
     {}),
    ("def i = 0; def s = 0; while (i < 5) { s += i; i += 1 } return s;", {}),
    ("def s = 0; for (int i = 0; i < 100; i++) { if (i > 4) break; "
     "s += i } return s;", {}),
    ("def s = 0; for (int i = 0; i < 6; i++) { if (i % 2 == 0) "
     "continue; s += i } return s;", {}),
    ("def s = 'a,b,c'; return s.splitOnToken(',').length;", {}),
    ("def vals = [3,1,2]; vals.sort((a,b) -> a - b); return vals[0];", {}),
    ("def vals = [3,1,2]; vals.sort((a,b) -> b - a); return vals[0];", {}),
    ("def l = [1,2,3,4]; return l.stream().filter(x -> x > 2).count();",
     {}),
    ("def l = [1,2,3,4]; return l.stream().map(x -> x * 2).sum();", {}),
    ("def l = [4,1,3]; return l.stream().sorted().toList()[0];", {}),
    ("def l = [1,2,2,3]; return l.stream().distinct().count();", {}),
    ("def l = [1,5,2]; return l.stream().anyMatch(x -> x > 4);", {}),
    ("def l = [1,5,2]; return l.stream().allMatch(x -> x > 0);", {}),
    ("def l = [1,2,3]; l.removeIf(x -> x > 1); return l.size();", {}),
    ("def i = 3; def j = i++; return i * 10 + j;", {}),
    ("def i = 3; def j = ++i; return i * 10 + j;", {}),
    ("def m = [:]; for (int i = 0; i < 3; i++) { m[i] = i * i } "
     "return m[2];", {}),
    ("def f = x -> x * x; return f(5);", {}),
    ("def i = 0; while (true) { i += 1 } return i;", {}),
    ("def x = 7; def l = [1,2]; def s = l.stream().map(v -> v + x).sum(); "
     "return s * 100 + x;", {}),
    ("def x = 1; if (x > 0) { break } return x;", {}),
    ("def f = x -> { break }; for (x in [1,2]) { f(x) }", {}),
    ("def f = x -> f(x + 1); return f(0);", {}),
    ("return 'a,b,c'.splitOnToken(',', 2).length;", {}),
    ("def p = 'a,b,c'.splitOnToken(',', 2); return p[1];", {}),
    ("return [[1,2],[1,2]].stream().distinct().count();", {}),
    ("ctx._source.n *= 3", {"ctx": {"_source": {"n": 10}}}),
]


@pytest.mark.parametrize("i", range(len(HOST_CASES)))
def test_interpreter_matches_reference(i):
    src, variables = HOST_CASES[i]

    def run(mod):
        env = {k: (dict(v) if isinstance(v, dict) else v)
               for k, v in variables.items()}
        if "ctx" in env:
            env["ctx"] = {"_source": dict(variables["ctx"]["_source"])}
        try:
            return ("ok", mod.execute(src, env), env.get("ctx"))
        except mod.ScriptError as e:
            return ("error", str(e), None)
    assert run(pl) == run(rpl)


def test_parse_helpers_match_reference():
    for src in ("doc['a'].value + doc['b'].value * doc['a'].value",
                "doc.x.value > params.p ? 1 : Math.log(2)"):
        assert pl.parse(src) == rpl.parse(src)
        assert pl.referenced_doc_fields(pl.parse(src)) == \
            rpl.referenced_doc_fields(rpl.parse(src))
    for bad in ("if (x > 1) { return 1 }", "for (x in y) { 1 }"):
        with pytest.raises(pl.ScriptError):
            pl.validate_device_script(bad)
        with pytest.raises(rpl.ScriptError):
            rpl.validate_device_script(bad)


# ---------------------------------------------------------------------
# eval_device against the reference's on the same numpy columns
# ---------------------------------------------------------------------

# (source, a transcendental enters)
DEVICE_CASES = [
    ("doc['a'].value * params.w + 2", False),
    ("doc['a'].value / 3", False),
    ("1 / 3 + doc['a'].value", False),
    ("doc['a'].value % 3", False),
    ("(doc['a'].value - 50) % params.w", False),
    ("-7 % 3 + doc['a'].value", False),
    ("doc['a'].empty ? -1 : doc['a'].value", False),
    ("doc['a'].size() + doc['b'].length", False),
    ("Math.round(doc['a'].value / 7)", False),
    ("Math.floor(doc['a'].value / 2.5) + Math.ceil(doc['b'].value)", False),
    ("Math.abs(doc['a'].value - 40) + Math.abs(-3)", False),
    ("Math.max(doc['a'].value, params.w) - Math.min(doc['b'].value, 2)",
     False),
    ("doc['a'].value > params.p && doc['b'].value < 3", False),
    ("!(doc['a'].value > params.p) || doc['b'].empty", False),
    ("def x = doc['a'].value; x += 1; x *= params.w; x - _score", False),
    ("doc.a.value * params['w'] + _score / 2", False),
    ("doc['missing'].value + 1", False),
    ("doc['a'].value == 0 ? 1 : 2", False),
    ("true ? 1 : 2", False),
    ("Math.PI * doc['a'].value", False),
    ("_score * Math.log(2 + doc['b'].value) * params.w", True),
    ("Math.log(2)", True),
    ("Math.log10(doc['a'].value + 1) + Math.sqrt(doc['b'].value)", True),
    ("Math.exp(-doc['b'].value) + Math.pow(doc['b'].value, 1.5)", True),
    ("Math.sin(doc['a'].value) + Math.cos(2) + Math.tan(doc['b'].value)",
     True),
    ("Math.pow(2, doc['b'].value) / Math.E", True),
]


def _device_inputs():
    rng = np.random.default_rng(3)
    n = 257
    a = rng.uniform(-10, 120, n).astype(np.float32)
    b = rng.uniform(0, 5, n).astype(np.float32)
    pa = rng.random(n) > 0.1
    pb = rng.random(n) > 0.2
    score = rng.uniform(0, 12, n).astype(np.float32)
    return n, {"a": (a, pa), "b": (b, pb)}, score, {"w": 1.7, "p": 40}


@pytest.mark.parametrize("src,transcendental", DEVICE_CASES,
                         ids=[c[0] for c in DEVICE_CASES])
def test_eval_device_matches_reference(src, transcendental):
    n, cols, score, params = _device_inputs()
    rast = rpl.validate_device_script(src)
    renv = rpl.DeviceEnv(jnp, {f: jnp.asarray(v) for f, (v, _) in
                               cols.items()},
                         {f: jnp.asarray(p) for f, (_, p) in cols.items()},
                         jnp.asarray(score),
                         {k: np.float32(v) for k, v in params.items()}, n)
    want = np.asarray(jax.jit(lambda: rpl.eval_device(rast, renv))())
    ast = pl.validate_device_script(src)
    env = pl.DeviceEnv(torch.device("cpu"),
                       {f: torch.from_numpy(v) for f, (v, _) in
                        cols.items()},
                       {f: torch.from_numpy(p) for f, (_, p) in
                        cols.items()},
                       torch.from_numpy(score),
                       C.script_params_on(params, "cpu"), n)
    got = pl.eval_device(ast, env).numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    if transcendental:
        np.testing.assert_allclose(got, want, rtol=RTOL_T)
    else:
        np.testing.assert_array_equal(got, want)


def test_eval_device_errors_match_reference():
    for src in ("doc['a'].values", "x + 1", "params.nope", "Math.nope(1)",
                "doc['a'].value.foo()"):
        with pytest.raises(rpl.ScriptError) as r:
            rpl.eval_device(rpl.parse(src), rpl.DeviceEnv(
                jnp, {}, {}, None, {}, 4))
        with pytest.raises(pl.ScriptError) as p:
            pl.eval_device(pl.parse(src), pl.DeviceEnv(
                torch.device("cpu"), {}, {}, None, {}, 4))
        assert str(p.value) == str(r.value), src


# ---------------------------------------------------------------------
# function_score, script, script_score end to end
# ---------------------------------------------------------------------

MATCH = {"match": {"name": "shirt hat wool"}}


def fs(functions, **kw):
    return {"function_score": dict(query=MATCH, functions=functions, **kw)}


FVF = {"field_value_factor": {"field": "rating", "factor": 1.2,
                              "modifier": "none", "missing": 1}}
GAUSS_TS = {"gauss": {"ts": {"origin": T0, "scale": "10d", "offset": "1d",
                             "decay": 0.5}}}
GAUSS_PRICE = {"gauss": {"price": {"origin": 60, "scale": 40}}}
EXP_PRICE = {"exp": {"price": {"origin": 100, "scale": 30, "decay": 0.3}}}
LIN_QTY = {"linear": {"qty": {"origin": 10, "scale": 5, "offset": 1}}}
WEIGHT_SALE = {"filter": {"term": {"status": "sale"}}, "weight": 2.5}
SCRIPT_FN = {"script_score": {"script": {
    "source": "doc['qty'].value * params.k + _score", "params": {"k": 0.5}}}}
RANDOM = {"random_score": {"seed": 12345}}

# (name, body, a transcendental enters)
FS_BODIES = [
    ("weight", fs([{"weight": 3}]), False),
    ("weight filtered", fs([WEIGHT_SALE]), False),
    ("fvf none", fs([FVF]), False),
    ("script fn", fs([SCRIPT_FN]), False),
    ("linear qty", fs([LIN_QTY], boost_mode="sum"), False),
    ("shorthand weight", {"function_score": {"query": MATCH, "weight": 4,
                                             "boost": 2}}, False),
    ("no query", {"function_score": {"functions": [FVF],
                                     "boost_mode": "replace"}}, False),
    ("random", fs([RANDOM], boost_mode="replace"), False),
    ("random filtered", fs([dict(RANDOM, filter={"term": {
        "status": "new"}})], score_mode="sum"), False),
    ("gauss ts", fs([GAUSS_TS]), True),
    ("gauss price", fs([GAUSS_PRICE], boost_mode="avg"), True),
    ("exp price", fs([EXP_PRICE], boost_mode="max"), True),
    ("shop", fs([dict(FVF, field_value_factor=dict(
        FVF["field_value_factor"], modifier="log1p")), GAUSS_TS,
        WEIGHT_SALE], score_mode="sum", boost_mode="multiply"), True),
    ("min_score", fs([FVF, GAUSS_PRICE], min_score=0.8,
                     score_mode="avg"), True),
] + [(f"score_mode {m}", fs([FVF, WEIGHT_SALE, LIN_QTY], score_mode=m),
      False) for m in ("multiply", "sum", "avg", "max", "min", "first")] + [
    (f"boost_mode {m}", fs([FVF, WEIGHT_SALE], boost_mode=m), False)
    for m in ("multiply", "sum", "replace", "avg", "max", "min")] + [
    (f"modifier {m}", fs([{"field_value_factor": {
        "field": "price", "factor": 0.1, "modifier": m}}]),
     m in ("log", "log1p", "log2p", "ln", "ln1p", "ln2p", "sqrt"))
    for m in ("none", "log", "log1p", "log2p", "ln", "ln1p", "ln2p",
              "square", "sqrt", "reciprocal")] + [
    ("script filter", {"script": {"script": {
        "source": "doc['price'].value * doc['qty'].value > params.t",
        "params": {"t": 900}}}}, False),
    ("script missing field", {"script": {"script": {
        "source": "doc['nope'].empty"}}}, False),
    ("script_score", {"script_score": {"query": MATCH, "script": {
        "source": "_score * Math.log(2 + doc['rating'].value) * params.w",
        "params": {"w": 1.5}}}}, True),
    ("script_score min_score", {"script_score": {
        "query": {"match_all": {}}, "script": {
            "source": "doc['price'].value"}, "min_score": 50.0}}, False),
    ("bool script filter", {"bool": {"must": [MATCH], "filter": [
        {"script": {"script": {"source": "doc['price'].value > params.p",
                               "params": {"p": 80}}}}]}}, False),
    ("bool script must_not", {"bool": {"must": [MATCH], "must_not": [
        {"script": {"script": "doc['qty'].value < 5"}}]}}, False),
    ("fs as filter", {"bool": {"must": [MATCH], "filter": [
        fs([FVF], min_score=3.0)]}}, False),
    ("script_score as filter", {"constant_score": {"filter": {
        "script_score": {"query": {"match_all": {}}, "script": {
            "source": "doc['qty'].value"}, "min_score": 10}}}}, False),
    ("rescore fs", {"query": MATCH, "rescore": {"window_size": 20, "query": {
        "rescore_query": fs([FVF])}}}, False),
]


@pytest.mark.parametrize("name,query,transcendental", FS_BODIES,
                         ids=[b[0] for b in FS_BODIES])
def test_scoring_bodies_match_reference(clients, name, query,
                                        transcendental):
    ref, port = clients
    body = (query if "query" in query and len(query) > 1
            else {"query": query})
    body = dict(body, size=30)
    want = ref.search("s", body)
    got = port.search("s", body)
    assert want["hits"]["total"]["value"] > 0, name
    rtol = (RTOL_T if transcendental else
            RTOL_BM25 if "name" in str(query) else None)
    same_page(got, want, rtol, name)


def test_random_score_is_bit_equal(clients):
    ref, port = clients
    for seed in (0, 7, -5, 2**31 - 1):
        body = {"query": fs([{"random_score": {"seed": seed}}],
                            boost_mode="replace"), "size": 100}
        got, want = port.search("s", body), ref.search("s", body)
        assert [(h["_id"], h["_score"]) for h in got["hits"]["hits"]] == \
            [(h["_id"], h["_score"]) for h in want["hits"]["hits"]]


def test_random_score_values_match_the_reference_hash():
    """The port's i64 steps equal the reference's uint32 hash at every
    doc index (its padding changes no real doc's value)."""
    for seed in (0, 1, -1, 99991, 2**31 - 1, -2**31):
        got = C.random_score_values(seed, 5000, "cpu").numpy()
        h = (np.arange(5000, dtype=np.uint32) * np.uint32(2654435761)
             ^ np.uint32(np.int32(seed).view(np.uint32)))
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x45D9F3B)
        h = h ^ (h >> np.uint32(16))
        want = h.astype(np.float32) / np.float32(2**32)
        np.testing.assert_array_equal(got, want)


def test_date_decay_reads_the_f32_view(clients):
    """Kept from the reference: a date decay measures |ts - origin| on
    the f32 view of epoch ms, where a step near 2026 is 2^17 ms; two docs
    under one step score alike, as in the reference."""
    ref, port = (RefClient(), RestClient(device="cpu"))
    for c in (ref, port):
        c.indices.create("d", {"settings": {"number_of_replicas": 0},
                               "mappings": {"properties": {
                                   "ts": {"type": "date"}}}})
        c.bulk(sum([[{"index": {"_index": "d", "_id": str(i)}},
                     {"ts": T0 + 5 * DAY + i * 40_000}]
                    for i in range(6)], []), refresh=True)
    body = {"query": {"function_score": {"functions": [
        {"exp": {"ts": {"origin": T0, "scale": "1d"}}}],
        "boost_mode": "replace"}}}
    got, want = port.search("d", body), ref.search("d", body)
    same_page(got, want, RTOL_T)
    scores = [h["_score"] for h in got["hits"]["hits"]]
    assert len(set(scores)) < len(scores)      # f32 steps merge docs
    assert np.spacing(np.float32(T0)) == 131072.0


def test_now_origin_is_accepted(clients):
    ref, port = clients
    body = {"query": fs([{"gauss": {"ts": {"origin": "now",
                                           "scale": "30d"}}}])}
    got, want = port.search("s", body), ref.search("s", body)
    assert got["hits"]["total"] == want["hits"]["total"]
    assert got["hits"]["hits"]


@pytest.mark.parametrize("query", [
    {"script": {"script": {"source": "1 +"}}},
    {"script": {"script": {"source": "doc['price'].value > 1",
                           "params": {"s": "x"}}}},
    {"script": {"script": {"source": "doc['price'].values"}}},
    {"script": {"script": {"source": "if (x > 1) { return 1 }"}}},
    {"script_score": {"query": MATCH, "script": {"source": "_score +"}}},
    {"script_score": {"query": MATCH, "script": {"source": "params.w",
                                                 "params": {"w": [1]}}}},
    {"function_score": {"query": MATCH, "functions": [{"script_score": {
        "script": {"source": "while (true) {}"}}}]}},
    {"function_score": {"query": MATCH, "gauss": {"price": {"scale": 3}}}},
    {"function_score": {"query": MATCH, "gauss": {"price": {
        "origin": 1, "scale": -3}}}},
    {"function_score": {"query": MATCH, "exp": {"ts": {
        "origin": "not a date", "scale": "1d"}}}},
    {"function_score": {"query": MATCH, "exp": {"ts": {
        "origin": T0, "scale": "1 fortnight"}}}},
    {"function_score": {"query": MATCH, "linear": {"price": {}}}},
    {"script": {}},
], ids=str)
def test_script_400s_match_reference(clients, query):
    ref, port = clients
    both_raise(ref, port, {"query": query})


def test_unknown_modes_raise_the_reference_value_error(clients):
    ref, port = clients
    for fn, kw in ((FVF, {"score_mode": "median"}),
                   (FVF, {"boost_mode": "median"}),
                   ({"field_value_factor": {"field": "price",
                                            "modifier": "cube"}}, {})):
        body = {"query": fs([fn, WEIGHT_SALE], **kw)}
        with pytest.raises(ValueError) as r:
            ref.search("s", body)
        with pytest.raises(ValueError) as p:
            port.search("s", body)
        assert str(p.value) == str(r.value)


def test_decay_on_a_geo_point_field_is_not_ported():
    port = RestClient(device="cpu")
    port.index("g", {"name": "x"}, id="1", refresh=True)
    port._indices["g"].engine.mappings.fields["name"].type = "geo_point"
    from opensearch_tpu_torch import NotPortedError
    with pytest.raises(NotPortedError, match="geo_point"):
        port.search("g", {"query": {"function_score": {"gauss": {
            "name": {"origin": "0,0", "scale": "1km"}}}}})


def test_script_filter_rides_b3_where_the_reference_does(
        reference_fastpath, docs):
    """A `script` in a bool's filter or must_not becomes B3's filter (its
    mask evaluated by eval_device) on the segment without deletes, as
    the reference's fastpath takes it; function_score, script_score and
    script at the root take the general path in both."""
    ref_routes = reference_fastpath
    ref = fill(RefClient(), docs, nseg=1)
    port = fill(RestClient(device="cpu"), docs, nseg=1)
    flt = {"script": {"script": {"source": "doc['price'].value > params.p",
                                 "params": {"p": 50}}}}
    cases = [
        ({"bool": {"must": [MATCH], "filter": [flt]}}, True),
        ({"bool": {"must": [MATCH], "must_not": [flt]}}, True),
        ({"bool": {"should": [MATCH], "filter": [fs([FVF])]}}, True),
        (flt, False),
        (fs([FVF]), False),
        ({"script_score": {"query": MATCH, "script": "_score * 2"}}, False),
        ({"bool": {"must": [fs([FVF])]}}, False),
    ]
    for query, b3 in cases:
        del ref_routes[:]
        pbefore = dict(fastpath.STATS)
        rbefore = rfp.STATS["bool_served"]
        gbefore = C.STATS["general_served"]
        same_page(port.search("s", {"query": query}),
                  ref.search("s", {"query": query}), RTOL_BM25, str(query))
        routes = {r: fastpath.STATS[r] - pbefore[r] for r in ROUTES}
        assert routes == _route_counts(ref_routes), query
        assert (fastpath.STATS["bool_served"] - pbefore["bool_served"]
                == rfp.STATS["bool_served"] - rbefore == int(b3)), query
        assert (C.STATS["general_served"] - gbefore > 0) == (not b3), query
        if b3:
            assert routes["b3_filter_slot"] == 1, query


# ---------------------------------------------------------------------
# host contexts
# ---------------------------------------------------------------------

HOST_BODIES = [
    ("script_fields", {"query": MATCH, "script_fields": {
        "margin": {"script": {"source": "doc['price'].value * 0.5"}},
        "label": {"script": {"source": "doc['status'].value + '!'"}},
        "q": {"script": "doc['qty'].value * 2"}}}),
    ("script sort number", {"query": {"match_all": {}}, "size": 40,
                            "sort": [{"_script": {
                                "type": "number", "order": "asc",
                                "script": {"source": "doc['qty'].value * "
                                                     "params.m",
                                           "params": {"m": -1}}}},
                                     "_doc"]}),
    ("script sort string desc", {"query": MATCH, "size": 20, "sort": [
        {"_script": {"type": "string", "order": "desc", "script":
                     "doc['status'].value + doc['tag'].value"}}]}),
    ("script sort secondary", {"query": MATCH, "size": 20, "sort": [
        {"status": "asc"}, {"_script": {"type": "number", "script":
                                        "doc['qty'].value"}}]}),
    ("terms_set script constant", {"query": {"terms_set": {"name": {
        "terms": ["red", "shirt", "wool", "hat"],
        "minimum_should_match_script": {
            "source": "params.num_terms - 2"}}}}}),
    ("terms_set script per doc", {"query": {"terms_set": {"name": {
        "terms": ["red", "shirt", "wool", "hat", "silk"],
        "minimum_should_match_script": {
            "source": "doc['qty'].value / 6"}}}}}),
    ("terms_set script filter", {"query": {"bool": {"must": [MATCH],
                                                    "filter": [{
        "terms_set": {"name": {"terms": ["red", "blue", "green"],
                               "minimum_should_match_script": {
                                   "source": "Math.min(params.num_terms, "
                                             "params.k)",
                                   "params": {"k": 1}}}}}]}}}),
    ("scripted_metric", {"size": 0, "query": MATCH, "aggs": {"m": {
        "scripted_metric": {
            "params": {"f": 2},
            "init_script": "state.t = []",
            "map_script": "if (!doc['price'].empty) "
                          "{ state.t.add(doc['price'].value * params.f) }",
            "combine_script": "double s = 0; for (t in state.t) "
                              "{ s += t } return s",
            "reduce_script": "double s = 0; for (a in states) "
                             "{ s += a } return s"}}}}),
    ("bucket_script and selector", {"size": 0, "aggs": {"h": {
        "terms": {"field": "tag"}, "aggs": {
            "p": {"sum": {"field": "qty"}},
            "r": {"bucket_script": {"buckets_path": {"n": "_count",
                                                    "q": "p"},
                                    "script": "params.q / params.n"}},
            "k": {"bucket_selector": {"buckets_path": {"n": "_count"},
                                      "script": "params.n > 20"}}}}}}),
    ("moving_fn script", {"size": 0, "aggs": {"h": {
        "histogram": {"field": "qty", "interval": 2}, "aggs": {
            "m": {"moving_fn": {"buckets_path": "_count", "window": 3,
                                "script": "def s = 0; for (v in values) "
                                          "{ s += v * v } return s"}}}}}}),
]


@pytest.mark.parametrize("name,body", HOST_BODIES,
                         ids=[b[0] for b in HOST_BODIES])
def test_host_contexts_match_reference(clients, name, body):
    ref, port = clients
    want = ref.search("s", body)
    got = port.search("s", body)
    same_page(got, want, RTOL_BM25, name)
    if "aggs" not in body:
        assert want["hits"]["hits"], name


@pytest.mark.parametrize("body", [
    {"query": MATCH, "search_after": [1.0], "sort": [{"_script": {
        "type": "number", "script": {"source": "doc['qty'].value"}}}]},
    {"query": MATCH, "collapse": {"field": "status"}, "sort": [
        {"_script": {"type": "number", "script": "doc['qty'].value"}}]},
    {"query": MATCH, "script_fields": {"x": {"script": "1 +"}}},
    {"query": MATCH, "sort": [{"_script": {"script": "doc['nope'].value"}}]},
], ids=["search_after", "collapse", "bad field script", "sort fault"])
def test_host_context_400s_match_reference(clients, body):
    ref, port = clients
    both_raise(ref, port, body)


def test_scripted_updates_match_reference(docs):
    ref, port = (fill(RefClient(), docs, nseg=1),
                 fill(RestClient(device="cpu"), docs, nseg=1))
    calls = [
        ("d0", {"script": {"source": "ctx._source.qty += params.n",
                           "params": {"n": 10}}}),
        ("d0", {"script": {"source": "ctx.op = 'none'"}}),
        ("d2", {"script": {"source": "ctx._source.name += ' updated'; "
                                     "ctx._source.remove('tag')"}}),
        ("d3", {"script": {"source": "if (ctx._source.qty < 50) "
                                     "{ ctx.op = 'delete' }"}}),
        ("counter", {"scripted_upsert": True, "upsert": {"n": 0},
                     "script": {"source": "ctx._source.n += 1"}}),
        ("counter", {"scripted_upsert": True, "upsert": {"n": 0},
                     "script": {"source": "ctx._source.n += 1"}}),
        ("fresh", {"scripted_upsert": True, "upsert": {"n": 0},
                   "script": {"source": "ctx.op = 'none'"}}),
        ("plain", {"upsert": {"n": 5}, "script": "ctx._source.n += 1"}),
        ("plain", {"upsert": {"n": 5}, "script": "ctx._source.n += 1"}),
        ("d5", {"script": {"source": "ctx._source.tags = ['x']; "
                                     "ctx._source.tags.add('y')"}}),
        ("d5", {"script": {"source": "ctx._source.tags.add('evil'); "
                                     "ctx.op = 'none'"}}),
    ]
    for doc_id, body in calls:
        r = ref.update("s", doc_id, body)
        p = port.update("s", doc_id, body)
        assert {k: p.get(k) for k in ("_id", "result")} == \
            {k: r.get(k) for k in ("_id", "result")}, (doc_id, body)
    for doc_id in ("d0", "d2", "d3", "counter", "fresh", "plain", "d5"):
        assert port.exists("s", doc_id) == ref.exists("s", doc_id), doc_id
        if ref.exists("s", doc_id):
            assert port.get("s", doc_id)["_source"] == \
                ref.get("s", doc_id)["_source"], doc_id
    for c in (ref, port):
        c.indices.refresh("s")
    assert port.search("s", {"query": {"match": {"name": "updated"}}})[
        "hits"]["total"] == ref.search("s", {"query": {"match": {
            "name": "updated"}}})["hits"]["total"]
    for body in ({"script": {"source": "ctx._source.x = 1 % 0"}},
                 {"script": {"source": "ctx.op = 'explode'"}},
                 {"script": {"source": "ctx._source.x ="}}):
        with pytest.raises(RefApiError) as r:
            ref.update("s", "d6", body)
        with pytest.raises(ApiError) as p:
            port.update("s", "d6", body)
        assert (p.value.status, str(p.value)) == (r.value.status,
                                                  str(r.value))


def test_script_kinds_left_reference_kinds():
    for kind in ("function_score", "script", "script_score"):
        assert kind not in dsl.REFERENCE_KINDS


# ---------------------------------------------------------------------
# chip_smoke phase 19's classes and brute force on a small bench corpus
# ---------------------------------------------------------------------

BENCH_NDOCS = 3000


@pytest.fixture(scope="module")
def bench_small():
    """bench.py's corpus, guardrail columns and title at a small size in
    both packages (the reference through bench.py's make_index, without
    the aggregation columns), and a second port client with them whose 16
    `_id`s are re-indexed with a ts and a rating, as phase 7 does, beside
    phase 7's brute force over it."""
    import bench
    import chip_smoke
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
    bc.make_index(port2, corpus, columns=columns, title=title, aggs=aggs)
    ix2 = chip_smoke.NumpyIndex(corpus, columns, title)
    q = bc.pick_queries(df, 16, seed=12)
    redo = [(7 * j + 3, [int(t) for t in q[j]] + [int(q[j][0])], j % 3, j,
             chip_smoke.reindexed_cols(j)) for j in range(16)]
    for old, terms, st, pr, cols in redo:
        port2.index("bench", {"body": " ".join(vs[t] for t in terms),
                              "status": bc.STATUS_VALUES[st], "price": pr,
                              **cols}, id=str(old))
    port2.indices.refresh("bench")
    ix2.reindex(redo)
    q2, q6 = bc.pick_queries(df, 8), bc.pick_queries_real(df, 8)
    big = {"corpus": corpus, "title": title, "aggs": aggs,
           "columns": columns,
           "body_terms": [t for i in range(8)
                          for t in (list(q2[i][:2]), list(q6[i]))]}
    return ref, port, port2, ix2, big


def test_phase19_classes_match_brute_force_and_reference(bench_small):
    """Phase 19's pages: (a)-(c) equal their JSON DSL pages and the
    reference's; (d)-(f) equal ScOracle over the corpus segment with
    deletes and the re-indexed docs' segment; the script filter and the
    random feed equal the reference's pages on the corpus alone (its
    bench index has no rating or ts)."""
    import chip_smoke
    ref, port, port2, ix2, big = bench_small
    classes = chip_smoke.sc_classes(big, chip_smoke.SC_QUERIES)
    oracle = chip_smoke.ScOracle(ix2, big["aggs"],
                                 port2._indices["bench"].engine)
    hit = {}
    for name, items in classes.items():
        for body, spec in items:
            got = port2.search("bench", body)
            hit[name] = hit.get(name, 0) + (got["hits"]["total"]["value"]
                                            > 0)
            if "query" in spec:
                want = port2.search("bench", {"query": spec["query"]})
                for r in (got, want):
                    r.pop("took")
                assert got == want, body
                if spec.get("plain") or "all" in spec:   # as 19 / 19m do
                    chip_smoke.check_page(got, oracle.page(body, spec),
                                          f"{name} {body}")
            else:
                chip_smoke.check_page(got, oracle.page(body, spec),
                                      f"{name} {body}",
                                      rtol=0.0 if "seed" in spec
                                      else chip_smoke.SC_RTOL)
            if name in ("d_function_score",) or spec.get("kind") == \
                    "script_score":
                continue
            same_page(port.search("bench", body), ref.search("bench", body),
                      RTOL_BM25, f"{name} {body}")
    assert all(hit.values()) and sum(hit.values()) >= 16, hit


def test_phase4_script_contexts_run_on_the_cpu():
    """chip_smoke phase 4's script contexts on the CPU: the bodies, the
    updates and the responses after them, twice, equal."""
    import chip_smoke
    docs_rng = np.random.default_rng(12)
    docs = [{"name": " ".join(docs_rng.choice(chip_smoke.SC_WORDS, 3)),
             "status": "new", "price": 5.0 + i, "qty": i % 30,
             "tag": f"t{i % 5}"} for i in range(300)]
    bodies = chip_smoke.sc_small_bodies()
    a = chip_smoke.sc_small_run("cpu", docs, bodies)
    assert a == chip_smoke.sc_small_run("cpu", docs, bodies)
    first, updates, gets, then, d3 = a
    assert [u["result"] for u in updates] == ["updated", "created",
                                              "updated", "noop", "deleted"]
    assert not d3 and gets[1]["qty"] == 2
