"""Nested objects in the port against the JAX package on the CPU.

Every case of the reference's tests/test_nested.py, tests/test_aggs_nested_join.py
and tests/test_geo_nested_sort.py runs as it is written there, with its
`RestClient` replaced by a `Twin`: each call goes to the reference's
client and to the port's (`device="cpu"`; with a `data_path`, a directory
of its own), the two responses must be equal with `took` aside (scores
within 1e-6 relative, `tests/test_torch_compound.same`), or both calls
raise the same error (an ApiError's status, type and reason; another
error's type and message), and the case's own assertions then read the
port's response. A document indexed without an id gets the same
generated id in both.

Beside them: a reference-written nested segment loaded by the port, a
merge of nested segments with deleted parents against the reference's,
a flush / recovery round trip, the five score modes over two segments
with deletes, nested sorts and aggs, the Queue 3 decisions (a complex
sub of an ordinal bucket inside `nested`, `include_in_parent`, a
`_geo_distance` sort over a nested field), and chip_smoke phase 22's
qa classes against their brute force on a small draw.
"""

import copy
import importlib.util
import inspect
import os

import jax
import numpy as np
import pytest

from opensearch_tpu.rest.client import ApiError as RefApiError
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu_torch import ApiError, NotPortedError, RestClient
from tests.test_torch_admin import admin_bench  # noqa: F401
from tests.test_torch_compound import RTOL

jax.config.update("jax_platforms", "cpu")

TIE_RTOL = 1e-5      # near-ties that may swap (f32 sums in another order)

HERE = os.path.dirname(os.path.abspath(__file__))


class Twin:
    """The reference's client and the port's behind one object."""

    auto_ids = [0]

    def __init__(self, ref, port):
        self._ref = ref
        self._port = port

    def __getattr__(self, name):
        rv = getattr(self._ref, name)
        pv = getattr(self._port, name)
        if not callable(rv):
            return Twin(rv, pv)         # a namespace: `indices`
        return lambda *a, **kw: twin_call(name, rv, pv, a, kw)


def twin_call(name, rv, pv, args, kw):
    """One call through both clients; the port's response, held to the
    reference's, or the reference's error where both raise."""
    if name == "index" and kw.get("id") is None and len(args) < 3:
        Twin.auto_ids[0] += 1
        kw = dict(kw, id=f"auto-{Twin.auto_ids[0]}")
    pargs, pkw = copy.deepcopy((args, kw))
    want = got = werr = gerr = None
    try:
        want = rv(*args, **kw)
    except Exception as e:          # noqa: BLE001 (held to the port's)
        werr = e
    try:
        got = pv(*pargs, **pkw)
    except NotPortedError:
        raise
    except Exception as e:          # noqa: BLE001
        gerr = e
    if werr is not None:
        assert gerr is not None, (name, args, werr, got)
        if isinstance(werr, RefApiError):
            assert isinstance(gerr, ApiError), (gerr, werr)
            assert (gerr.status, gerr.err_type, gerr.reason) == \
                (werr.status, werr.err_type, werr.reason)
        else:
            assert type(gerr).__name__ == type(werr).__name__, (gerr, werr)
            assert str(gerr) == str(werr)
        raise werr
    if gerr is not None:
        raise gerr
    if isinstance(want, (dict, list)):
        same(got, want, f"{name}: ")
    else:
        assert got == want, (name, got, want)
    return got


def same(got, want, path="") -> None:
    """Responses equal apart from `took`, scores within RTOL relative;
    hits whose scores lie within TIE_RTOL of each other (a near-tie) may
    come in either order, as long as the same ids make up the tie."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            if k == "took":
                continue
            if k in ("_score", "max_score") and want[k] is not None:
                assert got[k] is not None, path
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                           err_msg=path + k)
            elif k == "hits" and isinstance(want[k], list):
                same(_tie_order(got[k], want[k], path), want[k],
                     f"{path}hits.")
            else:
                same(got[k], want[k], f"{path}{k}.")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}{i}.")
    else:
        assert got == want, path


def _tie_order(got: list, want: list, path: str) -> list:
    """`got`'s hits with each near-tie group of `want` (neighbouring
    scores within TIE_RTOL) put in `want`'s order; the groups' ids must
    agree."""
    assert isinstance(got, list) and len(got) == len(want), path
    sc = [h.get("_score") if isinstance(h, dict) else None for h in want]
    out, i = list(got), 0
    while i < len(want):
        j = i + 1
        while (j < len(want) and sc[i] is not None and sc[j] is not None
               and abs(sc[j - 1] - sc[j]) <= TIE_RTOL * abs(sc[j - 1])):
            j += 1
        if j - i > 1:
            by_id = {h["_id"]: h for h in got[i:j]}
            assert set(by_id) == {h["_id"] for h in want[i:j]}, path
            out[i:j] = [by_id[h["_id"]] for h in want[i:j]]
        i = j
    return out


def twin_client(node=None, data_path=None, **kw):
    port_path = None
    if data_path is not None:
        port_path = f"{data_path}_port"
        os.makedirs(port_path, exist_ok=True)
    return Twin(RefClient(node=node, data_path=data_path, **kw),
                RestClient(device="cpu", data_path=port_path))


def reference_cases(filename: str, refused=None) -> list:
    """(id, module, class or None, test name, refusal) of each test of
    one of the reference's test files, from a private copy of the module
    whose `RestClient` is `twin_client`. `refused` maps a case id to the
    NotPortedError the port raises in it (a Queue 1 item the slice keeps
    refusing)."""
    refused = refused or {}
    name = f"_twin_{filename[:-3]}"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, filename))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.RestClient = twin_client
    cases = []
    for attr, obj in vars(mod).items():
        if attr.startswith("test_") and inspect.isfunction(obj):
            cases.append((attr, mod, None, attr, refused.get(attr)))
        elif attr.startswith("Test") and inspect.isclass(obj):
            for m in vars(obj):
                if m.startswith("test_"):
                    cid = f"{attr}::{m}"
                    cases.append((cid, mod, obj, m, refused.get(cid)))
    return cases


def _fixture(mod, cls, inst, name, tmp_path, made):
    if name in made:
        return made[name]
    if name == "tmp_data_path":
        value = str(tmp_path / "data")
    elif name == "tmp_path":
        value = tmp_path
    else:
        fx = (cls.__dict__.get(name) if cls is not None else None)
        owner = inst if fx is not None else None
        fx = fx if fx is not None else getattr(mod, name)
        fn = fx._get_wrapped_function()
        params = [p for p in inspect.signature(fn).parameters
                  if p != "self"]
        deps = {p: _fixture(mod, cls, inst, p, tmp_path, made)
                for p in params}
        value = fn(owner, **deps) if owner is not None else fn(**deps)
    made[name] = value
    return value


def run_reference_case(case, tmp_path) -> None:
    """Run one reference test with its fixtures made through the twin;
    a refused case must raise its NotPortedError."""
    _id, mod, cls, name, refusal = case
    inst = cls() if cls is not None else None
    fn = getattr(inst, name) if inst is not None else getattr(mod, name)
    made: dict = {}

    def run():
        deps = {p: _fixture(mod, cls, inst, p, tmp_path, made)
                for p in inspect.signature(fn).parameters}
        fn(**deps)
    if refusal is None:
        run()
    else:
        with pytest.raises(NotPortedError, match=refusal):
            run()


CASES = (reference_cases("test_nested.py")
         + reference_cases("test_aggs_nested_join.py")
         + reference_cases("test_geo_nested_sort.py"))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_case(case, tmp_path):
    run_reference_case(case, tmp_path)


# ---------------------------------------------------------------------
# beyond the reference's cases: a seeded two-level index over segments
# with deletes, the segment planes, the Queue 3 decisions
# ---------------------------------------------------------------------

MAPPING = {"properties": {
    "title": {"type": "text"}, "tag": {"type": "keyword"},
    "answers": {"type": "nested", "properties": {
        "user": {"type": "keyword"}, "date": {"type": "date"},
        "votes": {"type": "integer"}, "body": {"type": "text"},
        "comments": {"type": "nested", "properties": {
            "by": {"type": "keyword"}}}}}}}
USERS = ["u0", "u1", "u2", "u3", "u4", "u5"]
WORDS = ["fox", "dog", "cat", "tpu", "gpu", "kernel", "nested", "join"] + [
    f"w{i}" for i in range(40)]


def make_docs(n=60, seed=21):
    """n questions (numpy seed): a title, 1-2 tags, 0-4 answers with a
    user, a date, votes, a body and 0-2 comments."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        answers = []
        for _ in range(int(rng.integers(0, 5))):
            answers.append({
                "user": str(rng.choice(USERS)),
                "date": f"2010-{int(rng.integers(1, 7)):02d}-"
                        f"{int(rng.integers(1, 28)):02d}",
                "votes": int(rng.integers(0, 20)),
                "body": " ".join(rng.choice(WORDS, int(rng.integers(2, 9)))),
                "comments": [{"by": str(rng.choice(USERS))}
                             for _ in range(int(rng.integers(0, 3)))]})
        docs.append({"title": " ".join(rng.choice(WORDS, 4)),
                     "tag": [str(t) for t in rng.choice(
                         ["a", "b", "c", "d"], int(rng.integers(1, 3)),
                         replace=False)],
                     "answers": answers})
    return docs


def fill_seeded(c, docs, deleted=("q3", "q17", "q40")):
    c.indices.create("s", {"settings": {"number_of_shards": 1,
                                        "number_of_replicas": 0},
                           "mappings": MAPPING})
    for lo, hi in ((0, 35), (35, len(docs))):
        c.bulk(sum([[{"index": {"_index": "s", "_id": f"q{i}"}}, docs[i]]
                    for i in range(lo, hi)], []), refresh=True)
    for d in deleted:
        c.delete("s", d, refresh=True)
    return c


@pytest.fixture(scope="module")
def seeded():
    return fill_seeded(twin_client(), make_docs())


def _nested(q, mode, **kw):
    return {"nested": {"path": "answers", "query": q, "score_mode": mode,
                       **kw}}


SEEDED = [
    *({"query": _nested({"match": {"answers.body": "fox kernel"}}, mode),
       "size": 20} for mode in ("avg", "sum", "max", "min", "none")),
    {"query": {"bool": {"must": [{"match": {"title": "gpu"}}], "should": [
        _nested({"term": {"answers.user": "u2"}}, "max",
                inner_hits={"size": 2})]}}, "size": 20},
    {"query": {"bool": {"filter": [_nested({"range": {"answers.votes": {
        "gte": 10}}}, "none")]}}, "size": 30},
    {"query": _nested(_nested({"term": {"answers.comments.by": "u1"}},
                              "sum"), "avg", inner_hits={}), "size": 20},
    {"query": {"nested": {"path": "answers.comments", "query": {
        "term": {"answers.comments.by": "u3"}}}}, "size": 20},
    {"query": {"term": {"tag": "a"}}, "sort": [{"answers.votes": {
        "order": "desc", "nested": {"path": "answers"}}}], "size": 25},
    {"sort": [{"answers.date": {"order": "asc", "mode": "avg",
                                "nested": {"path": "answers"}}},
              {"_id": "asc"}], "size": 25},
    {"size": 0, "aggs": {"a": {"nested": {"path": "answers"}, "aggs": {
        "u": {"terms": {"field": "answers.user"}, "aggs": {
            "v": {"sum": {"field": "answers.votes"}}}},
        "hi": {"filter": {"range": {"answers.votes": {"gte": 10}}},
               "aggs": {"back": {"reverse_nested": {}, "aggs": {
                   "t": {"terms": {"field": "tag"}}}}}},
        "c": {"nested": {"path": "answers.comments"}, "aggs": {
            "by": {"terms": {"field": "answers.comments.by"}},
            "up": {"reverse_nested": {"path": "answers"}, "aggs": {
                "v": {"avg": {"field": "answers.votes"}}}}}}}}}},
    {"query": _nested({"match": {"answers.body": "fox"}}, "avg"),
     "explain": True, "size": 5},
]


@pytest.mark.parametrize("i", range(len(SEEDED)))
def test_seeded_bodies_over_segments_with_deletes(seeded, i):
    seeded.search("s", copy.deepcopy(SEEDED[i]))


def test_seeded_bodies_after_a_forcemerge_and_a_recovery(tmp_path):
    """A forcemerge (the children of deleted parents dropped), a flush
    and a recovery: the same pages as the reference's, and the port's
    merged nested planes equal the reference's."""
    path = str(tmp_path / "d")
    c = fill_seeded(twin_client(data_path=path), make_docs())
    c.indices.forcemerge("s")
    rs = c._ref.node.indices["s"].shards[0].segments
    ps = c._port._indices["s"].engine.segments
    assert len(rs) == len(ps) == 1
    rb, pb = rs[0].nested["answers"], ps[0].nested["answers"]
    np.testing.assert_array_equal(rb.parent_of, pb.parent_of)
    assert list(rb.child.ids) == list(pb.child.ids)
    rc, pc = (b.child.nested["answers.comments"] for b in (rb, pb))
    np.testing.assert_array_equal(rc.parent_of, pc.parent_of)
    for body in SEEDED:
        c.search("s", copy.deepcopy(body))
    c.indices.flush("s")
    back = twin_client(data_path=path)
    for body in SEEDED[:8]:
        back.search("s", copy.deepcopy(body))


def test_reference_written_nested_segment_loads(tmp_path):
    """A segment with two nested levels saved by the reference loads in
    the port with the same planes, and the port's merge of two such
    segments with deleted parents equals the reference's merge."""
    from opensearch_tpu.index.merge import merge_segments as ref_merge
    from opensearch_tpu_torch.index.merge import merge_segments
    from opensearch_tpu_torch.index.segment import Segment
    c = fill_seeded(RefClient(), make_docs())
    rsegs = c.node.indices["s"].shards[0].segments
    loaded = []
    for k, rseg in enumerate(rsegs):
        rseg.save(str(tmp_path / f"s{k}"))
        pseg = Segment.load(str(tmp_path / f"s{k}"))
        np.testing.assert_array_equal(pseg.live, rseg.live)
        blk, rblk = pseg.nested["answers"], rseg.nested["answers"]
        np.testing.assert_array_equal(blk.parent_of, rblk.parent_of)
        assert blk.child.postings["answers.body"].vocab == \
            rblk.child.postings["answers.body"].vocab
        np.testing.assert_array_equal(
            blk.child.nested["answers.comments"].parent_of,
            rblk.child.nested["answers.comments"].parent_of)
        loaded.append(pseg)
    want = ref_merge("m", list(rsegs))
    got = merge_segments("m", loaded)
    assert got.ndocs == want.ndocs and list(got.ids) == list(want.ids)
    for npath in ("answers",):
        g, w = got.nested[npath], want.nested[npath]
        np.testing.assert_array_equal(g.parent_of, w.parent_of)
        assert list(g.child.sources) == list(w.child.sources)
        np.testing.assert_array_equal(
            g.child.nested["answers.comments"].parent_of,
            w.child.nested["answers.comments"].parent_of)
        for f, rcol in w.child.numeric_cols.items():
            np.testing.assert_array_equal(g.child.numeric_cols[f].values,
                                          rcol.values)


def test_complex_subs_of_a_bucket_inside_nested_are_refined():
    """ROADMAP Queue 3: a reverse_nested (any sub outside the stats
    family) of a terms or date_histogram bucket inside `nested` — the
    reference's refinement stops at `nested` and serves doc_count 0
    without the sub's aggs; the port refines the bucket inside the nested
    level and serves OpenSearch's counts."""
    docs = [{"tag": ["x", "y"], "answers": [
                {"user": "u1", "date": "2010-01-05"},
                {"user": "u2", "date": "2010-02-05"}]},
            {"tag": ["y"], "answers": [{"user": "u1", "date": "2010-01-09"}]},
            {"tag": ["z"], "answers": []}]
    ref, port = RefClient(), RestClient(device="cpu")
    for c in (ref, port):
        c.indices.create("qa", {"mappings": MAPPING})
        for i, d in enumerate(docs):
            c.index("qa", d, id=str(i))
        c.indices.refresh("qa")
    for inner in ({"date_histogram": {"field": "answers.date",
                                      "calendar_interval": "month"}},
                  {"terms": {"field": "answers.user"}}):
        body = {"size": 0, "aggs": {"a": {"nested": {"path": "answers"},
            "aggs": {"m": {**inner, "aggs": {"r": {"reverse_nested": {},
                "aggs": {"t": {"terms": {"field": "tag"}}}}}}}}}}
        got = port.search("qa", body)["aggregations"]["a"]["m"]["buckets"]
        want = ref.search("qa", body)["aggregations"]["a"]["m"]["buckets"]
        assert [b["r"] for b in want] == [{"doc_count": 0}] * 2
        assert [(b["r"]["doc_count"], {t["key"]: t["doc_count"] for t in
                                       b["r"]["t"]["buckets"]})
                for b in got] == [(2, {"x": 1, "y": 2}), (1, {"x": 1,
                                                              "y": 1})]


def test_the_slice_keeps_refusing():
    """`include_in_parent` / `include_in_root` (the reference indexes
    the children alone), a `_geo_distance` sort over a field of its
    nested path (the reference serves it missing everywhere) and
    star_tree raise NotPortedError."""
    for key in ("include_in_parent", "include_in_root"):
        with pytest.raises(NotPortedError, match=key):
            RestClient(device="cpu").indices.create("x", {"mappings": {
                "properties": {"n": {"type": "nested", key: True}}}})
    c = RestClient(device="cpu")
    c.indices.create("g", {"mappings": {"properties": {"offices": {
        "type": "nested", "properties": {"loc": {"type": "geo_point"}}}}}})
    c.index("g", {"offices": [{"loc": [1, 2]}]}, id="1", refresh=True)
    with pytest.raises(NotPortedError, match="_geo_distance"):
        c.search("g", {"sort": [{"_geo_distance": {
            "offices.loc": [0, 0], "nested": {"path": "offices"}}}]})


def test_phase4_qa_small_on_the_cpu(monkeypatch):
    """chip_smoke phase 4's Q&A check on the CPU in place of the card
    (1,000 questions): the bulked and attached planes equal, (a)-(h)'s
    bodies equal on both and on the CPU twin."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "QA_SMALL", 1000)
    out = chip_smoke.phase_qa_small(np.random.default_rng([0, 14]), "cpu")
    assert out["bodies"] == 2 * 9


def test_phase22_on_a_small_bench_corpus(admin_bench, monkeypatch):
    """chip_smoke phase 22 whole on the CPU beside 3,000 passages (3,000
    questions, a join index of 1,500, 300 stored queries, 8 percolated
    documents): every class against its brute force and the CPU twin,
    the three indices deleted; then (i) again after a forcemerge."""
    import chip_smoke
    for k, v in (("QA_QUESTIONS", 3000), ("QA_JOIN_QUESTIONS", 1500),
                 ("ALERTS", 300), ("PERC_DOCS", 8), ("MLT_MERGED", 2)):
        monkeypatch.setattr(chip_smoke, k, v)
    big, _bools = admin_bench
    out = chip_smoke.phase_qa_msmarco(big, 3, 0, "cpu")
    assert not chip_smoke.VERIFY.todo
    port, ix = big["client"], big["ix"]
    assert not {"qa", "qa_join", "alerts"} & set(port._indices)
    hits = {k: sum(c["hits"]) for k, c in out["classes"].items()}
    assert all(hits[k] > 0 for k in ("a_nested", "b_nested_sort",
                                     "f_has_parent", "g_parent_id",
                                     "i_more_like_this", "j_percolate")), hits
    port.indices.forcemerge("bench")
    ix.compact()
    merged = chip_smoke.phase_qa_merged(big)
    assert merged["terms_8"]["bodies"] == merged["terms_25"]["bodies"] == 2
