"""query_string and simple_query_string in the port, against the JAX
package on the CPU.

- The grammars: every string of the reference's tests/test_query_string.py
  parsed by both packages' `parse_query_string` /
  `parse_simple_query_string` into the same DSL tree (class names and
  fields), or the same QueryParseError; simple_query_string never
  throws.
- End to end: the same strings through both packages' RestClient, over
  the reference test's four documents and over a seeded corpus in two
  segments, the first with deletes (search and msearch): totals equal,
  ids and order identical, scores within 1e-6 relative (the reference's
  XLA program may contract BM25 into FMAs: the 1 ULP contract), the
  same 400s.
- A string serves the page of the JSON DSL it stands for in the port,
  over the same route: a single-field string rides the kernels where
  its DSL does (B3 for `+a +b -c`, B1 / B2 for a lone term group), a
  multi-field string is a dis_max on the general path.
"""

import dataclasses

import jax
import numpy as np
import pytest

from opensearch_tpu.rest.client import ApiError as RefApiError
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu.search import query_dsl as rdsl
from opensearch_tpu.search import querystring as rqs
from opensearch_tpu_torch import ApiError, RestClient
from opensearch_tpu_torch.search import compiler as C
from opensearch_tpu_torch.search import fastpath, impactpath
from opensearch_tpu_torch.search import query_dsl as dsl
from opensearch_tpu_torch.search import querystring as qs

jax.config.update("jax_platforms", "cpu")

RTOL = 1e-6


def tree(q):
    """A DSL tree as (class name, fields), recursively."""
    if dataclasses.is_dataclass(q):
        return (type(q).__name__, {f.name: tree(getattr(q, f.name))
                                   for f in dataclasses.fields(q)})
    if isinstance(q, (list, tuple)):
        return [tree(x) for x in q]
    return q


# (grammar, string, default fields, kwargs): the reference test's strings
GRAMMAR = [
    ("qs", "title:hello", ["body"], {}),
    ("qs", "hello", ["title^2", "body"], {}),
    ("qs", "a AND b OR c", ["f"], {}),
    ("qs", "good -bad NOT ugly", ["f"], {}),
    ("qs", "(a OR b) AND c", ["f"], {}),
    ("qs", "title:(a b)", ["body"], {}),
    ("qs", '"quick fox"~2^3', ["f"], {}),
    ("qs", "age:[10 TO 20}", ["f"], {}),
    ("qs", "age:[* TO 5]", ["f"], {}),
    ("qs", "name:/jo.+n/", ["f"], {}),
    ("qs", "roam~", ["f"], {}),
    ("qs", "roam~1", ["f"], {}),
    ("qs", "qu*ck", ["f"], {}),
    ("qs", "quick*", ["f"], {}),
    ("qs", "_exists_:title", ["f"], {}),
    ("qs", "*:*", ["f"], {}),
    ("qs", "title:*", ["f"], {}),
    ("qs", r"path:a\:b", ["f"], {}),
    ("qs", "hello^4", ["f"], {}),
    ("qs", "a b", ["f"], {"default_operator": "and"}),
    ("qs", "(unbalanced", ["f"], {}),
    ("qs", "a && b || c", ["f"], {}),
    ("qs", "well-known", ["f"], {}),
    ("qs", "C++", ["f"], {}),
    ("qs", "AT&T", ["f"], {}),
    ("qs", "good -bad-ish", ["f"], {}),
    ("qs", "a^.", ["f"], {}),
    ("qs", "a^b", ["f"], {}),
    ("qs", "x", ["f^bad"], {}),
    ("qs", r"a\*b*", ["f"], {}),
    ("qs", r"a\*b?c", ["f"], {}),
    ("qs", r"ab\*", ["f"], {}),
    ("qs", '"a b" c', ["f"], {"phrase_slop": 2}),
    ("qs", "+a +b -c", ["f"], {}),
    ("qs", "status:new AND (a OR b)", ["f"], {"default_operator": "and"}),
    ("sqs", "a b", ["f"], {}),
    ("sqs", "a | b", ["f"], {"default_operator": "and"}),
    ("sqs", "a + b | c", ["f"], {}),
    ("sqs", '-bad "exact phrase"', ["f"], {}),
    ("sqs", "(((", ["f"], {}),
    ("sqs", "a )", ["f"], {}),
    ("sqs", "~~", ["f"], {}),
    ("sqs", '"unterminated', ["f"], {}),
    ("sqs", "|||", ["f"], {}),
    ("sqs", "+", ["f"], {}),
    ("sqs", "", ["f"], {}),
    ("sqs", "well-known stuff", ["f"], {}),
    ("sqs", "-a | b", ["f"], {}),
    ("sqs", "a | b -c", ["f"], {}),
    ("sqs", "quik~1 pre*", ["f", "g^3"], {}),
]


def _parse(mod, dmod, grammar, s, fields, kw):
    fn = (mod.parse_query_string if grammar == "qs"
          else mod.parse_simple_query_string)
    try:
        return "ok", tree(fn(s, list(fields), **kw))
    except dmod.QueryParseError as e:
        return "error", str(e)


@pytest.mark.parametrize("grammar,s,fields,kw", GRAMMAR,
                         ids=[f"{g[0]}:{g[1]}" for g in GRAMMAR])
def test_grammar_matches_reference(grammar, s, fields, kw):
    got = _parse(qs, dsl, grammar, s, fields, kw)
    assert got == _parse(rqs, rdsl, grammar, s, fields, kw)
    if grammar == "sqs":
        assert got[0] == "ok"           # simple_query_string never throws


def test_field_specs_match_reference():
    for fields in (["title^5", "body"], ["a.b^0.5"], ["x"]):
        assert qs.parse_field_specs(fields) == rqs.parse_field_specs(fields)


# ---------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------

QS_MAPPING = {"settings": {"number_of_replicas": 0}, "mappings": {
    "properties": {"title": {"type": "text"}, "body": {"type": "text"},
                   "age": {"type": "integer"}, "tag": {"type": "keyword"}}}}
QS_DOCS = [
    {"title": "quick brown fox", "body": "jumps over the lazy dog",
     "age": 10, "tag": "animal"},
    {"title": "slow green turtle", "body": "crawls under the log",
     "age": 20, "tag": "animal"},
    {"title": "quick silver surfer", "body": "rides the wave",
     "age": 30, "tag": "hero"},
    {"title": "brown bread recipe", "body": "bake the quick dough",
     "age": 40, "tag": "food"},
]


def qsb(query, **kw):
    return {"query_string": dict(query=query, **kw)}


def sqsb(query, **kw):
    return {"simple_query_string": dict(query=query, **kw)}


# the reference test's end-to-end bodies, then more strings over the
# same four documents
SMALL_BODIES = [
    qsb("title:quick AND tag:animal"),
    qsb("(title:quick OR title:brown) NOT tag:food"),
    qsb("age:[20 TO 30]"),
    qsb("_exists_:tag AND age:{30 TO *]"),
    qsb('"quick fox"~1', fields=["title"]),
    qsb('"quick fox"', fields=["title"]),
    qsb("title:qu?ck"),
    qsb("title:quikc~2"),
    qsb("tag:/an.mal/"),
    qsb("quick", fields=["title^10", "body"]),
    qsb("*:*"),
    sqsb("quick + fox | turtle", fields=["title"]),
    sqsb("(((", fields=["title"]),
    qsb("quick brown"),
    qsb("quick brown", default_operator="and", boost=2.0),
    qsb("brown -fox", default_field="title"),
    qsb("the", fields=["body"], _name="n"),
    qsb("title:brown^3 body:quick"),
    qsb("quick*", default_field="title"),
    sqsb("quick -fox", fields=["title", "body"]),
    sqsb('"brown bread" | surfer', fields=["title"]),
    sqsb("qui*", fields=["title"]),
    sqsb("quick", default_operator="and"),
]


@pytest.fixture(scope="module")
def small():
    out = []
    for c in (RefClient(), RestClient(device="cpu")):
        c.indices.create("qs", QS_MAPPING)
        for i, d in enumerate(QS_DOCS):
            c.index("qs", d, id=str(i))
        c.indices.refresh("qs")
        out.append(c)
    return tuple(out)


def same(got, want, what=""):
    """Responses equal apart from `took`, scores within RTOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), what
        for k in want:
            if k == "took":
                continue
            if k in ("_score", "max_score") and want[k] is not None:
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                           err_msg=what)
            else:
                same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{what}.{i}")
    else:
        assert got == want, what


@pytest.mark.parametrize("i", range(len(SMALL_BODIES)))
def test_small_bodies_match_reference(small, i):
    ref, port = small
    body = {"query": SMALL_BODIES[i]}
    same(port.search("qs", body), ref.search("qs", body), str(body))


@pytest.mark.parametrize("query", [
    qsb("title:(oops"), qsb("a^b"), qsb("x", fields=["f^bad"]),
    qsb("title:/[a\\/"), {"query_string": {}}], ids=str)
def test_syntax_errors_are_the_reference_400(small, query):
    """A malformed string is the reference's 400; a body without
    `query` its KeyError."""
    ref, port = small
    try:
        ref.search("qs", {"query": query})
    except RefApiError as e:
        with pytest.raises(ApiError) as p:
            port.search("qs", {"query": query})
        assert (p.value.status, p.value.err_type, str(p.value)) == (
            e.status, e.err_type, str(e))
    except KeyError as e:
        with pytest.raises(KeyError) as p:
            port.search("qs", {"query": query})
        assert str(p.value) == str(e)
    else:
        raise AssertionError(f"the reference served {query}")


NDOCS = 200
WORDS = ["quick", "brown", "fox", "lazy", "dog", "red", "apple", "river",
         "stone", "moon", "the", "jumps", "over", "tree", "hill"]
MAPPING = {"settings": {"number_of_replicas": 0}, "mappings": {"properties": {
    "title": {"type": "text"}, "body": {"type": "text"},
    "status": {"type": "keyword"}, "price": {"type": "integer"}}}}


def make_docs():
    """NDOCS docs (numpy seed 61): Zipf-ish titles and bodies, a status
    and a price."""
    rng = np.random.default_rng(61)
    p = 1.0 / np.arange(1, len(WORDS) + 1) ** 0.8
    p /= p.sum()
    return [{"title": " ".join(rng.choice(WORDS, int(rng.integers(2, 6)),
                                          p=p)),
             "body": " ".join(rng.choice(WORDS, int(rng.integers(4, 14)),
                                         p=p)),
             "status": ["new", "sale", "old"][int(rng.integers(3))],
             "price": int(rng.integers(100))} for _ in range(NDOCS)]


def fill(c, docs, nseg=2):
    c.indices.create("t", MAPPING)
    step = NDOCS // nseg
    for lo in range(0, NDOCS, step):
        c.bulk(sum([[{"index": {"_index": "t", "_id": f"d{i}"}}, docs[i]]
                    for i in range(lo, lo + step)], []), refresh=True)
    if nseg > 1:
        c.bulk([{"delete": {"_index": "t", "_id": f"d{i}"}}
                for i in range(0, 40, 7)], refresh=True)
    return c


@pytest.fixture(scope="module")
def docs():
    return make_docs()


@pytest.fixture(scope="module")
def clients(docs):
    return fill(RefClient(), docs), fill(RestClient(device="cpu"), docs)


# (string body, the JSON DSL it stands for in the port)
EQUIV = [
    (qsb("fox dog moon", default_field="body", default_operator="and"),
     {"bool": {"must": [{"match": {"body": {"query": w, "operator": "and"}}}
                        for w in ("fox", "dog", "moon")]}}),
    (qsb("fox river status:new", default_field="body",
         default_operator="and"),
     {"bool": {"must": [{"match": {"body": {"query": "fox",
                                            "operator": "and"}}},
                        {"match": {"body": {"query": "river",
                                            "operator": "and"}}},
                        {"match": {"status": {"query": "new",
                                              "operator": "and"}}}]}}),
    (qsb('"quick fox" river', fields=["body", "title^2"]),
     {"bool": {"should": [
         {"dis_max": {"queries": [
             {"match_phrase": {"body": {"query": "quick fox", "slop": 0}}},
             {"match_phrase": {"title": {"query": "quick fox", "slop": 0,
                                         "boost": 2.0}}}]}},
         {"dis_max": {"queries": [
             {"match": {"body": {"query": "river", "operator": "or"}}},
             {"match": {"title": {"query": "river", "operator": "or",
                                  "boost": 2.0}}}]}}],
         "minimum_should_match": "1"}}),
    (sqsb("fox dog -moon", fields=["body"]),
     {"bool": {"should": [{"match": {"body": "fox"}},
                          {"match": {"body": "dog"}}],
               "must_not": [{"match": {"body": "moon"}}]}}),
]


@pytest.mark.parametrize("i", range(len(EQUIV)))
def test_strings_serve_their_dsl_page(clients, i):
    ref, port = clients
    body, equiv = EQUIV[i]
    got = port.search("t", {"query": body, "size": 20})
    want = ref.search("t", {"query": body, "size": 20})
    same(got, want, str(body))
    assert want["hits"]["total"]["value"] > 0
    dsl_page = port.search("t", {"query": equiv, "size": 20})
    for r in (got, dsl_page):
        r.pop("took")
    assert got == dsl_page


SEEDED = [
    qsb("quick fox", default_field="title"),
    qsb("quick AND fox OR river", default_field="body"),
    qsb("+quick +brown -lazy", default_field="body"),
    qsb("title:(quick OR moon) AND status:sale"),
    qsb("price:[10 TO 40} AND body:river"),
    qsb("body:riv* OR title:ston?"),
    qsb("body:quik~1"),
    qsb('body:"the fox"~3'),
    qsb("fox", fields=["title^3", "body"], boost=0.5),
    qsb("_exists_:price AND NOT status:old"),
    sqsb("quick + brown | moon -fox", fields=["body"]),
    sqsb('"lazy dog" | tree*', fields=["title", "body"]),
    sqsb("apple river", default_operator="and"),
    {"bool": {"must": [qsb("fox")], "filter": [
        sqsb("new", fields=["status"])]}},
]


def test_seeded_strings_match_reference_in_search_and_msearch(clients):
    ref, port = clients
    for q in SEEDED:
        body = {"query": q, "size": 15}
        same(port.search("t", body), ref.search("t", body), str(q))
    lines = sum([[{}, {"query": q}] for q in SEEDED], [])
    got = port.msearch(lines, index="t")["responses"]
    want = ref.msearch(lines, index="t")["responses"]
    for q, g, w in zip(SEEDED, got, want):
        same(g, w, str(q))


def test_string_routes_follow_their_dsl(docs):
    """On one segment without deletes: a single-field `+a +b -c` or
    `a b -c` string rides B3, a lone single-field term group B1 / B2 (the
    pruned ladder), a multi-field string, a phrase and `a | b -c` (a
    nested bool) the general path, each as its JSON DSL does."""
    port = fill(RestClient(device="cpu"), docs, nseg=1)
    cases = [
        (qsb("+quick +brown -lazy", default_field="body"), "bool"),
        (sqsb("fox dog -moon", fields=["body"]), "bool"),
        # `a | b -c` is should[a, bool(b, -c)]: a nested bool, general
        (sqsb("fox | dog -moon", fields=["body"]), None),
        (qsb("fox dog", default_field="body"), "bool"),
        (qsb("fox", default_field="body"), "pure"),
        (qsb("fox", fields=["body", "title"]), None),
        (qsb('"quick fox"', default_field="body"), None),
    ]
    for q, kernel in cases:
        before = dict(fastpath.STATS)
        gbefore = C.STATS["general_served"]
        ibefore = impactpath.STATS["served"]
        port.search("t", {"query": q})
        served = {k: fastpath.STATS[k] - before[k]
                  for k in ("pure_served", "bool_served")}
        if kernel is None:
            assert not any(served.values()), q
            assert C.STATS["general_served"] > gbefore, q
        else:
            assert served[f"{kernel}_served"] == 1, q
            assert C.STATS["general_served"] == gbefore, q
            assert impactpath.STATS["served"] == ibefore, q


def test_default_fields_are_the_text_fields_in_mapping_order(clients):
    _ref, port = clients
    ctx = port._indices["t"].searcher.context()
    node = C.rewrite(dsl.parse_query(qsb("fox")), ctx)
    assert isinstance(node, C.LDisMax)
    assert [c.field for c in node.children] == ["title", "body"]


def test_query_string_kinds_left_reference_kinds():
    for kind in ("query_string", "simple_query_string"):
        assert kind not in dsl.REFERENCE_KINDS
