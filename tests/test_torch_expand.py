"""Term-expanding queries and keyword ranges of the port (the expanders
and rewrites of opensearch_tpu_torch/search/compiler.py, its copy of the
regexp engine in search/regexp.py, the fuzzy edit distance as torch ops)
against the JAX package on the CPU.

- Expanders: the port's fuzzy rows equal the rows of the reference's
  `_edit_distance_le` (optimal string alignment) over every term of a
  seeded variable-length vocabulary (transpositions, empty and non-BMP
  terms) and of `vocab_strings(20_000)`; the regexp copy's matches equal
  the reference's `match_vocab` on its own test patterns and more.
- End to end: the same bulk in three codec-v2 segments, one with deletes,
  through both packages' RestClient, `search` and `msearch`: responses
  equal apart from `took`, constant scores bit-equal, BM25 scores (the
  leading terms of `match_bool_prefix`, a `match` must beside an
  expansion) within 1e-6 relative, as the general path's contract says.
- Routes: each body rides the fused kernels exactly where the
  reference's fastpath (forced on, the port's plain kernels in its
  kernels' place) does, over the same B3 route; a filter whose expansion
  passes the filter hash cap is declined by both.
- Where the reference differs from OpenSearch (`fnmatch` classes in a
  wildcard, a `range` on a text field, a fuzzy `match` scoring a
  constant per term, a parsed and unused `format`) the port keeps the
  reference's answer, pinned here as measured.
"""

import random

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from opensearch_tpu.rest.client import ApiError as RefApiError
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu.search import compiler as RC
from opensearch_tpu.search import fastpath as rfp
from opensearch_tpu.search import query_dsl as rdsl
from opensearch_tpu.search import regexp as rrx
from opensearch_tpu_torch import RestClient
from opensearch_tpu_torch.bench_corpus import vocab_strings
from opensearch_tpu_torch.rest.client import ApiError
from opensearch_tpu_torch.search import compiler as C
from opensearch_tpu_torch.search import fastpath, filters
from opensearch_tpu_torch.search import query_dsl as dsl
from opensearch_tpu_torch.search import regexp as rx
from tests.test_torch_bool import (ROUTES, _plain_bool, _route_counts,
                                   reference_fastpath)  # noqa: F401
from tests.test_torch_ladder import _plain_impact, _plain_tfdl

jax.config.update("jax_platforms", "cpu")

RTOL = 1e-6
CPU = torch.device("cpu")

# ---------------------------------------------------------------------
# expanders
# ---------------------------------------------------------------------


def seeded_vocab(n: int, seed: int = 7) -> list:
    """`n` distinct terms of 0-9 chars over a small alphabet with an
    accented and a non-BMP char, sorted as a dictionary is."""
    rng = random.Random(seed)
    alpha = "abcdeo" + "é𝄞"
    out = {""}
    while len(out) < n:
        out.add("".join(rng.choice(alpha)
                        for _ in range(rng.randint(1, 9))))
    return sorted(out)


def ref_fuzzy_rows(vocab, term, k, prefix_length):
    pre = term[:prefix_length]
    return [i for i, t in enumerate(vocab)
            if t.startswith(pre) and RC._edit_distance_le(t, term, k)]


def port_fuzzy_rows(vocab, term, k, prefix_length, matrix):
    got = rx.osa_within(*matrix, term, k, term[:prefix_length])
    return torch.nonzero(got).flatten().tolist()


def test_fuzzy_rows_equal_the_reference_over_a_variable_vocab():
    vocab = seeded_vocab(5000)
    matrix = rx.vocab_matrix(vocab)
    rng = random.Random(11)
    queries = rng.sample(vocab, 12) + ["", "a", "ab", "ba", "abcdeabcde",
                                       "𝄞é", "é𝄞a"]
    # transpositions and one-char edits of dictionary terms
    for t in rng.sample([t for t in vocab if len(t) >= 3], 6):
        i = rng.randrange(len(t) - 1)
        queries.append(t[:i] + t[i + 1] + t[i] + t[i + 2:])
        queries.append(t[:i] + "𝄞" + t[i + 1:])
    for q in queries:
        for k in (0, 1, 2):
            for pl in (0, 2):
                assert port_fuzzy_rows(vocab, q, k, pl, matrix) \
                    == ref_fuzzy_rows(vocab, q, k, pl), (q, k, pl)


def test_fuzzy_rows_equal_the_reference_over_bench_vocab():
    vocab = vocab_strings(20_000)
    matrix = rx.vocab_matrix(vocab)
    for q in ("t0012345", "t0001342", "t00123", "t1001934"):
        k = C._auto_fuzz(q, "AUTO")
        assert k == RC._auto_fuzz(q, "AUTO")
        got = port_fuzzy_rows(vocab, q, k, 1, matrix)
        assert got == ref_fuzzy_rows(vocab, q, k, 1), q
        assert got or q == "t1001934"


PATTERNS = [".*o.*&.*x", "q.*&~(quick)", "item<1-31>", "item@", "<1-31>",
            "slee..", "a{2,3}", "[^a-c]+", "#", "(ab|cd)*e?", "~(a.*)",
            "[a-e]{1,2}o", "é.*", ".*𝄞", "a+b*c?", "(a|b|c)(d|e)", "@&~(.*a.*)",
            "\\.", "o<5-12>", "[ab]*&.{3}"]


def test_regexp_copy_matches_the_reference():
    vocab = seeded_vocab(3000) + ["07", "7", "31", "032", "00", "item7",
                                  "item31", "item32", "other", "fox",
                                  "quick", "qux", "sleepy", "o9", "o12",
                                  "a.b", "."]
    vocab = sorted(set(vocab))
    matrix = rx.vocab_matrix(vocab)
    for p in PATTERNS:
        want = rrx.match_vocab(p, vocab)
        np.testing.assert_array_equal(rx.match_vocab(p, vocab, matrix), want,
                                      err_msg=p)
        np.testing.assert_array_equal(rx.match_vocab(p, vocab), want,
                                      err_msg=p)
    assert rx.match_vocab("<1-31>", ["07", "7", "31", "032", "00"]
                          ).tolist() == [True, True, True, False, False]
    for bad in ("(unclosed", "[a\\", "a{3,1}"):
        with pytest.raises(rrx.RegexpError):
            rrx.compile_regexp(bad)
        with pytest.raises(rx.RegexpError):
            rx.compile_regexp(bad)


# ---------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------

MAPPING = {"settings": {"number_of_replicas": 0}, "mappings": {"properties": {
    "body": {"type": "text"}, "tag": {"type": "keyword"},
    "status": {"type": "keyword"}, "n": {"type": "integer"}}}}
WORDS = ["quick", "quikc", "qiuck", "quack", "quicker", "brown", "brwn",
         "browne", "crown", "fox", "foxes", "fix", "jump", "jumps",
         "jumped", "lazy", "laze", "dog", "dogs", "dig", "the", "café",
         "cafe", "naïve", "über", "alpha", "alpah", "t0015", "t0125"]
TAGS = ["alpha", "Alpha", "beta", "beta-2", "gamma", "delta", "b", "q",
        "𝄞clef", "zeta", "éclair", "ALPHABET"]
STATUS = ["draft", "published", "archived"]
NDOCS = 180


def make_bulk():
    rng = np.random.default_rng(23)
    docs = []
    for i in range(NDOCS):
        words = rng.choice(WORDS, int(rng.integers(3, 9))).tolist()
        docs.append({"body": " ".join(words),
                     "tag": TAGS[int(rng.integers(len(TAGS)))],
                     "status": STATUS[i % 3], "n": i})
    return docs


def fill(c, docs):
    """Three segments; the first loses 12 docs after its refresh."""
    c.indices.create("t", MAPPING)
    for lo in range(0, NDOCS, 60):
        c.bulk(sum([[{"index": {"_index": "t", "_id": str(i)}}, docs[i]]
                    for i in range(lo, lo + 60)], []), refresh=True)
    c.bulk([{"delete": {"_index": "t", "_id": str(i)}}
            for i in range(0, 60, 5)], refresh=True)
    return c


@pytest.fixture(scope="module")
def bulk():
    return make_bulk()


@pytest.fixture(scope="module")
def clients(bulk):
    ref, port = fill(RefClient(), bulk), fill(RestClient(device="cpu"), bulk)
    assert len(port._indices["t"].engine.segments) == 3
    return ref, port


def q(kind, field, spec):
    return {"query": {kind: {field: spec}}}


MATCH = {"match": {"body": "quick fox"}}
# (name, body, constant: every score a boost, bit-equal)
BODIES = [
    ("prefix", q("prefix", "body", "qu"), True),
    ("prefix boost", q("prefix", "body", {"value": "br", "boost": 2.5}),
     True),
    ("prefix keyword", q("prefix", "tag", "al"), True),
    ("prefix ci", q("prefix", "tag", {"value": "AL",
                                      "case_insensitive": True}), True),
    ("prefix nothing", q("prefix", "body", "zzz"), True),
    ("prefix non-bmp", q("prefix", "tag", "𝄞"), True),
    ("wildcard", q("wildcard", "body", "qu*k"), True),
    ("wildcard ?", q("wildcard", "body", {"value": "b?own"}), True),
    ("wildcard class", q("wildcard", "body", "qu[ai]*"), True),
    ("wildcard ci", q("wildcard", "tag", {"wildcard": "*A",
                                          "case_insensitive": True}), True),
    ("regexp", q("regexp", "body", "qu.*"), True),
    ("regexp alternation", q("regexp", "body", {"value": "br(o|a)wne?",
                                                "boost": 3.0}), True),
    ("regexp ops", q("regexp", "body", ".*o.*&.*x"), True),
    ("regexp interval", q("regexp", "body", "t0<10-20>"), True),
    ("regexp keyword", q("regexp", "tag", "[a-c].*"), True),
    ("fuzzy auto", q("fuzzy", "body", "quikc"), True),
    ("fuzzy 0", q("fuzzy", "body", {"value": "quikc", "fuzziness": 0}),
     True),
    ("fuzzy 1", q("fuzzy", "body", {"value": "brwon", "fuzziness": 1}),
     True),
    ("fuzzy 2 prefix", q("fuzzy", "body", {"value": "jmup", "fuzziness": 2,
                                          "prefix_length": 1}), True),
    ("fuzzy auto prefix 2", q("fuzzy", "body", {
        "value": "quicekr", "fuzziness": "AUTO", "prefix_length": 2}), True),
    ("fuzzy short", q("fuzzy", "body", "dg"), True),
    ("fuzzy keyword", q("fuzzy", "tag", {"value": "alhpa",
                                         "fuzziness": "1"}), True),
    ("match fuzzy", q("match", "body", {"query": "quikc brwn",
                                        "fuzziness": "AUTO"}), True),
    ("match fuzzy and", q("match", "body", {"query": "quikc brwn",
                                            "fuzziness": "AUTO",
                                            "operator": "and"}), True),
    ("match fuzzy 1 msm", q("match", "body", {
        "query": "quikc brwn lazzy", "fuzziness": 1,
        "minimum_should_match": 2, "boost": 2.0}), True),
    ("match fuzzy 0", q("match", "body", {"query": "quikc dog",
                                          "fuzziness": 0}), True),
    ("bool prefix", q("match_bool_prefix", "body", "quick brown f"), False),
    ("bool prefix and", q("match_bool_prefix", "body", {
        "query": "lazy d", "operator": "and"}), False),
    ("bool prefix one", q("match_bool_prefix", "body", "ju"), True),
    ("range keyword", q("range", "tag", {"gte": "b", "lt": "g"}), True),
    ("range keyword gt lte", q("range", "tag", {"gt": "alpha",
                                                "lte": "beta-2"}), True),
    ("range keyword from to", q("range", "tag", {"from": "delta",
                                                 "to": "zeta"}), True),
    ("range keyword open", q("range", "tag", {"gte": "q", "boost": 2.0}),
     True),
    ("range keyword format", q("range", "status", {
        "gte": "b", "lt": "q", "format": "yyyy", "time_zone": "+01:00"}),
     True),
    ("range keyword empty", q("range", "tag", {"gt": "zz"}), True),
    ("filter prefix", {"query": {"bool": {"must": [MATCH], "filter": [
        {"prefix": {"body": "bro"}}]}}}, False),
    ("filter range", {"query": {"bool": {"must": [MATCH], "filter": [
        {"range": {"status": {"gte": "b", "lt": "q"}}}]}}}, False),
    ("filter fuzzy match", {"query": {"bool": {"must": [MATCH], "filter": [
        {"match": {"body": {"query": "lazzy", "fuzziness": 1}}}]}}}, False),
    ("must_not wildcard", {"query": {"bool": {"must": [MATCH], "must_not": [
        {"wildcard": {"body": "do*"}}]}}}, False),
    ("should fuzzy", {"query": {"bool": {"must": [MATCH], "should": [
        {"fuzzy": {"body": "lazzy"}}]}}}, False),
    ("constant_score regexp", {"query": {"constant_score": {
        "filter": {"regexp": {"body": "j.*"}}, "boost": 1.5}}}, True),
    ("sorted prefix", dict(q("prefix", "body", "do"),
                           sort=[{"n": "desc"}], size=5), True),
    ("exact totals", dict(q("prefix", "body", "b"), track_total_hits=True,
                          size=3), True),
]


def same(got, want, exact: bool, path="") -> None:
    """Responses equal apart from `took`; scores bit-equal when `exact`,
    else within RTOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            if k == "took":
                continue
            if k in ("_score", "max_score") and want[k] is not None \
                    and not exact:
                assert got[k] is not None, path
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                           err_msg=path + k)
            else:
                same(got[k], want[k], exact, f"{path}{k}.")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, exact, f"{path}{i}.")
    else:
        assert got == want, path


@pytest.mark.parametrize("name,body,exact", BODIES,
                         ids=[b[0] for b in BODIES])
def test_search_matches_reference(clients, name, body, exact):
    ref, port = clients
    same(port.search("t", body), ref.search("t", body), exact)


def test_msearch_matches_reference(clients):
    ref, port = clients
    lines = sum([[{}, b] for _n, b, _e in BODIES], [])
    got = port.msearch(lines, index="t")["responses"]
    want = ref.msearch(lines, index="t")["responses"]
    for (name, _b, exact), g, w in zip(BODIES, got, want):
        same(g, w, exact, name + ": ")


def test_reference_behaviours_kept(clients):
    """The reference's answers where OpenSearch would differ, as
    measured: a wildcard's `[ai]` is an fnmatch class (Lucene reads `[`
    literally and finds nothing here), a fuzzy `match` scores its boost
    once per matching term, `format` and `time_zone` leave a keyword
    range alone, and a `range` on a text field raises."""
    ref, port = clients
    for c in (ref, port):
        hits = c.search("t", q("wildcard", "body", "qu[ai]*"))["hits"]
        assert hits["total"]["value"] > 0
        hits = c.search("t", dict(q("match", "body", {
            "query": "quikc brwn", "fuzziness": "AUTO"}), size=100))["hits"]
        assert {h["_score"] for h in hits["hits"]} == {1.0, 2.0}
        plain = c.search("t", q("range", "status", {"gte": "b", "lt": "q"}))
        fmt = c.search("t", q("range", "status", {
            "gte": "b", "lt": "q", "format": "yyyy", "time_zone": "+01:00"}))
        assert chip_smoke.strip_took(plain) == chip_smoke.strip_took(fmt)
        with pytest.raises(ValueError,
                           match=r"cannot coerce for type \[text\]"):
            c.search("t", q("range", "body", {"gte": "a"}))


def test_bad_regexp_is_a_400_in_both(clients):
    ref, port = clients
    body = q("regexp", "body", "(unclosed")
    with pytest.raises(RefApiError) as rerr:
        ref.search("t", body)
    with pytest.raises(ApiError) as perr:
        port.search("t", body)
    assert rerr.value.status == perr.value.status == 400
    assert str(perr.value) == str(rerr.value)
    lines = [{}, body, {}, BODIES[0][1]]
    got = port.msearch(lines, index="t")["responses"]
    want = ref.msearch(lines, index="t")["responses"]
    assert got[0] == want[0]
    same(got[1], want[1], True)


def test_prefix_with_highlight_matches_reference(clients):
    """The reference's highlighter walks no expansion: no fragment."""
    ref, port = clients
    body = dict(q("prefix", "body", "qu"),
                highlight={"fields": {"body": {}}})
    got, want = port.search("t", body), ref.search("t", body)
    same(got, want, True)
    assert all("highlight" not in h for h in got["hits"]["hits"])
    mixed = {"query": {"bool": {"must": [MATCH], "filter": [
        {"prefix": {"body": "bro"}}]}}, "highlight": {"fields": {"body": {}}}}
    same(port.search("t", mixed), ref.search("t", mixed), False)


# ---------------------------------------------------------------------
# routes and the filter hash cap
# ---------------------------------------------------------------------

KERNEL_STATS = ("pure_served", "bool_served", "shard_view_served")


def test_routes_match_the_reference_fastpath(reference_fastpath, bulk):
    """Each body rides the fused kernels where the reference's fastpath
    does, over the same B3 route: an expansion in scoring position goes
    to the general path, an expansion in a filter or a must_not beside a
    match must, or under a constant_score, rides B3 (the segment with
    deletes takes the general path)."""
    ref_routes = reference_fastpath
    ref, port = fill(RefClient(), bulk), fill(RestClient(device="cpu"), bulk)
    ridden = []
    for name, body, exact in BODIES:
        del ref_routes[:]
        rbefore = {k: rfp.STATS[k] for k in KERNEL_STATS}
        pbefore = dict(fastpath.STATS)
        gbefore = C.STATS["general_served"]
        same(port.search("t", body), ref.search("t", body), exact, name)
        rserved = sum(rfp.STATS[k] - rbefore[k] for k in KERNEL_STATS)
        pserved = sum(fastpath.STATS[k] - pbefore[k] for k in KERNEL_STATS)
        assert (pserved > 0) == (rserved > 0), name
        assert {r: fastpath.STATS[r] - pbefore[r] for r in ROUTES} \
            == _route_counts(ref_routes), name
        if pserved:
            ridden.append(name)
        else:
            assert C.STATS["general_served"] > gbefore, name
    assert set(ridden) == {"filter prefix", "filter range",
                           "filter fuzzy match", "must_not wildcard",
                           "constant_score regexp"}


def test_expansion_past_the_hash_cap_is_declined(monkeypatch, bulk):
    """With both packages' filter hash caps set small, a filter whose
    expansion's rows pass the cap is declined by both fast paths (the
    reference's forced on); the general path serves the same page."""
    monkeypatch.setattr(rfp, "_backend_ok", True)
    monkeypatch.setattr(rfp, "fused_bm25_topk_tfdl", _plain_tfdl)
    monkeypatch.setattr(rfp, "fused_bm25_topk_impact", _plain_impact)
    monkeypatch.setattr(rfp, "fused_bm25_bool_topk", _plain_bool)
    ref, port = fill(RefClient(), bulk), fill(RestClient(device="cpu"), bulk)
    small = {"query": {"bool": {"must": [MATCH], "filter": [
        {"prefix": {"body": "fox"}}]}}}          # 2 rows: 12 bytes
    large = {"query": {"bool": {"must": [MATCH], "filter": [
        {"prefix": {"body": "q"}}]}}}            # 5 rows: 36 bytes
    monkeypatch.setattr(RC, "_FILTER_HASH_BYTE_CAP", 16)
    monkeypatch.setattr(C, "FILTER_HASH_BYTE_CAP", 16)
    for body, kernels in ((small, True), (large, False)):
        rb = rfp.STATS["bool_served"]
        pb = fastpath.STATS["bool_served"]
        same(port.search("t", body), ref.search("t", body), False)
        assert (rfp.STATS["bool_served"] > rb) == kernels
        assert (fastpath.STATS["bool_served"] > pb) == kernels


def test_expansion_param_bytes_equal_the_reference_prepare(clients):
    """The bytes the port counts for the reference's hash cap are the
    bytes of the reference's prepared parameters for the expansion."""
    ref, port = clients
    shard = ref.node.indices["t"].shards[0]
    rctx = RC.ShardContext(shard.mappings, shard.segments)
    pctx = port._indices["t"].searcher.context()
    for body in (q("prefix", "body", "q"), q("fuzzy", "body", "quikc"),
                 q("range", "tag", {"gte": "b"}), q("prefix", "body", "zz"),
                 q("regexp", "body", ".*")):
        query = body["query"]
        pnode = C.rewrite(dsl.parse_query(query), pctx)
        rnode = RC.rewrite(rdsl.parse_query(query), rctx)
        for pseg, rseg in zip(pctx.segments, rctx.segments):
            local: dict = {}
            RC.prepare(rnode, rseg, rctx, local)
            want = sum(np.asarray(v).nbytes for v in local.values())
            assert C.reference_param_bytes(pnode, pseg) == want, body


def test_a_filter_expands_once_per_segment(clients):
    """The emit, the filter mask and its cache key share one expansion
    of a node per segment."""
    _ref, port = clients
    ctx = port._indices["t"].searcher.context()
    body = {"bool": {"must": [MATCH], "filter": [
        {"fuzzy": {"body": "lazzy"}}], "should": [{"prefix": {"body": "q"}}]}}
    lroot = C.rewrite(dsl.parse_query(body), ctx)
    calls = []
    for node in (lroot.filters[0], lroot.shoulds[0]):
        real = node.expander
        node.expander = (lambda seg, real=real:
                         calls.append(seg.uid) or real(seg))
    for seg in ctx.segments:
        fastpath._filter_list(seg, ctx, [(lroot.filters[0], False)], CPU)
        filters.mask_key(lroot, seg, ctx)
        C.emit(lroot, seg, ctx, CPU)
        C.reference_param_bytes(lroot, seg)
    assert sorted(calls) == sorted(2 * [s.uid for s in ctx.segments])


def test_merge_drops_the_codepoint_matrices(bulk):
    """A merge releases the replaced segments' dictionary matrices with
    their other device arrays; the merged segment builds its own."""
    ref, port = fill(RefClient(), bulk), fill(RestClient(device="cpu"), bulk)
    body = q("regexp", "body", "qu.*")
    port.search("t", body)
    old = list(port._indices["t"].engine.segments)
    assert all(("vocab_cp", "body", "cpu") in s.device_arrays for s in old)
    for c in (ref, port):
        c.indices.forcemerge("t")
    assert all(not s.device_arrays for s in old)
    for _n, b, exact in BODIES[:24]:
        same(port.search("t", b), ref.search("t", b), exact)
    (merged,) = port._indices["t"].engine.segments
    assert ("vocab_cp", "body", "cpu") in merged.device_arrays


@pytest.mark.parametrize("kind", ["span_multi", "intervals prefix",
                                  "intervals wildcard", "intervals fuzzy"])
def test_span_and_interval_expansions_still_raise(clients, kind):
    from opensearch_tpu_torch import NotPortedError
    _ref, port = clients
    body = {"span_multi": {"match": {"prefix": {"body": "qu"}}}} \
        if kind == "span_multi" else {"intervals": {"body": {
            kind.split()[1]: {"prefix" if kind.endswith("prefix")
                              else "pattern" if kind.endswith("wildcard")
                              else "term": "qu"}}}}
    with pytest.raises(NotPortedError, match=kind.split()[-1]):
        port.search("t", {"query": body})


# ---------------------------------------------------------------------
# chip_smoke phase 12's brute force on a small bench corpus
# ---------------------------------------------------------------------

BENCH_NDOCS = 3000


@pytest.fixture(scope="module")
def bench_small():
    """bench.py's corpus, guardrail columns and title at a small size,
    attached to both packages (the reference through bench.py's own
    make_index) with phase 7's numpy brute force over them; and a second
    port client whose 16 `_id`s are re-indexed with phase 12's terms, as
    phase 7 does, beside its own brute force (the reference's bench index
    keeps no `_id` map, so a re-index there adds a doc)."""
    import bench
    from opensearch_tpu_torch import bench_corpus as bc
    corpus = bc.build_corpus(BENCH_NDOCS)
    columns = bc.guardrail_columns(BENCH_NDOCS)
    title = bc.build_title_corpus(BENCH_NDOCS)
    starts, docs, tfs, dl, df = corpus
    vs = bc.vocab_strings(len(starts) - 1)
    ref = RefClient()
    bench.make_index(ref, (starts, docs, tfs, vs), dl,
                     tuple(title[:5]) + (bc.title_vocab_strings(
                         len(title[0]) - 1),), *columns)
    port, port2 = RestClient(device="cpu"), RestClient(device="cpu")
    for c in (port, port2):
        bc.make_index(c, corpus, columns=columns, title=title)
    ix, ix2 = (chip_smoke.NumpyIndex(corpus, columns, title)
               for _ in range(2))
    q = bc.pick_queries(df, 16, seed=12)
    redo = [(7 * j + 3, [int(t) for t in q[j]] + [int(q[j][0])], j % 3, j)
            for j in range(16)]
    for old, terms, st, pr in redo:
        r = port2.index("bench", {"body": " ".join(vs[t] for t in terms),
                                  "status": bc.STATUS_VALUES[st],
                                  "price": pr}, id=str(old))
        assert r["result"] == "updated"
    port2.indices.refresh("bench")
    ix2.reindex(redo)
    return ref, port, ix, port2, ix2, {"corpus": corpus}


def test_phase12_brute_force_matches_reference_pages(bench_small):
    """Phase 12's oracle pages (expansions from the vocabulary strings,
    scores from the numpy index) equal the reference's pages and the
    port's equal both; over the corpus segment with deletes and the
    re-indexed docs' segment, the port's pages equal the oracle's."""
    ref, port, ix, port2, ix2, big = bench_small
    classes = chip_smoke.expand_classes(big, 6)
    assert set(classes) == {"prefix7", "prefix6", "wildcard", "regexp",
                            "regexp_alt", "fuzzy", "match_fuzzy",
                            "bool_prefix"}
    hit = 0
    for name, items in classes.items():
        # the reference's fuzzy expander runs its Python DP once per
        # dictionary term (about 7 s a query term at 200k terms)
        for body, oracle in items[:1] if "fuzzy" in name else items:
            want = ref.search("bench", body)
            chip_smoke.check_page(want, oracle(ix), f"reference {body}")
            same(port.search("bench", body), want,
                 name != "bool_prefix", name)
            chip_smoke.check_page(port2.search("bench", body), oracle(ix2),
                                  f"re-indexed {body}")
            hit += want["hits"]["total"]["value"] > 0
    assert hit >= 30
    # the capped prefix counts the re-indexed segment's own rows
    from opensearch_tpu_torch import bench_corpus as bc
    vs = bc.vocab_strings(len(big["corpus"][4]))
    p = vs[int(bc.pick_queries(big["corpus"][4], 16, seed=12)[0][0])][:6]
    assert chip_smoke.rows_mask(ix2, [i for i, v in enumerate(vs)
                                      if v.startswith(p)],
                                cap=50)[ix2.n0:].any()


def test_phase12_filter_class_matches_reference_pages(bench_small):
    """The expanded-filter class's oracle (a status keyword range or a
    body prefix in the filter) against the reference's pages."""
    ref, port, ix, _port2, _ix2, big = bench_small
    for body, oracle in chip_smoke.filter_classes(big, 8):
        want = ref.search("bench", body)
        chip_smoke.check_page(want, oracle(ix), f"reference {body}")
        same(port.search("bench", body), want, False)
