"""Scroll and point-in-time contexts, and the index read, mapping and
delete calls of the port, against the JAX package on the CPU.

- The same seeded bulk (two segments, the first with deletes, codec v1
  and v2) through both packages' RestClient: scroll pages (offset paging
  over a frozen segment list, past the kernels' 128 lanes onto the
  general path), point-in-time pages with `search_after` under a sort,
  `clear_scroll` (one id, a list, `_all`), `delete_pit`, the 404s, and
  keep-alive expiry with the clock patched in both clients. Responses
  equal apart from `took` and the context ids, scores within 1e-6
  relative (as in `tests/test_torch_compound.py`).
- The reference's snapshot rule, kept: a document indexed and refreshed
  after the context opens is not seen, a later delete is (both flip the
  live mask of the snapshot's segment in place), and a context sees its
  pages across a forcemerge. The port holds the merged-away segments'
  device state until the last context goes, then releases it.
- field_caps, indices.get, get_mapping, get_settings, put_mapping (and
  its persistence across a restart), exists and delete.
"""

import types

import jax
import pytest

import chip_smoke
from opensearch_tpu.rest import client as rclient
from opensearch_tpu.rest.client import ApiError as RefApiError
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu_torch import ApiError, RestClient
from opensearch_tpu_torch.errors import IndexNotFoundError
from opensearch_tpu_torch.rest import client as pclient
from tests.test_torch_compound import (MAPPING, bench_small,  # noqa: F401
                                       make_docs, same)

jax.config.update("jax_platforms", "cpu")

MATCH = {"match": {"body": "the fox"}}


@pytest.fixture(scope="module")
def docs():
    # 4x the compound tests' bulk (ids d0..d255), so that a scroll's
    # window passes the kernels' 128 lanes
    base = make_docs()
    return [dict(base[i % len(base)], price=(i * 37) % 100)
            for i in range(4 * len(base))]


def fresh(docs, codec="2"):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENSEARCH_TPU_CODEC", codec)
        return (fill_big(RefClient(), docs),
                fill_big(RestClient(device="cpu"), docs))


def fill_big(c, docs):
    """Two segments of half the docs each; the first loses six."""
    c.indices.create("t", MAPPING)
    half = len(docs) // 2
    for lo in (0, half):
        c.bulk(sum([[{"index": {"_index": "t", "_id": f"d{i}"}}, docs[i]]
                    for i in range(lo, lo + half)], []), refresh=True)
    c.bulk([{"delete": {"_index": "t", "_id": f"d{i}"}}
            for i in (0, 5, 10, 15, 20, 25)], refresh=True)
    return c


def strip_ids(resp: dict) -> dict:
    return {k: v for k, v in resp.items() if k not in ("_scroll_id",
                                                        "pit_id")}


def hit_ids(resp: dict) -> list:
    return [h["_id"] for h in resp["hits"]["hits"]]


class Clock:
    """A wall clock the tests move; both clients read it."""

    def __init__(self, monkeypatch):
        import time as _time
        self.now = _time.time()
        fake = types.SimpleNamespace(
            time=lambda: self.now, monotonic=_time.monotonic,
            perf_counter=_time.perf_counter, sleep=_time.sleep)
        for mod in (rclient, pclient):
            monkeypatch.setattr(mod, "time", fake)


# ---------------------------------------------------------------------
# scroll
# ---------------------------------------------------------------------

SCROLLS = [
    ("match size 50", {"query": MATCH, "size": 50}),
    ("bool size 40", {"query": {"bool": {"must": [MATCH], "filter": [
        {"range": {"price": {"gte": 30}}}]}}, "size": 40}),
    ("sorted size 64", {"query": {"match_all": {}}, "size": 64,
                        "sort": [{"price": "desc"}]}),
    ("phrase size 3", {"query": {"match_phrase": {"body": "the fox"}},
                       "size": 3}),
    ("rescored size 30", {"query": MATCH, "size": 30, "rescore": {
        "window_size": 20, "query": {"rescore_query": {
            "match": {"title": "fox"}}}}}),
]


@pytest.mark.parametrize("codec", ["1", "2"], ids=["v1", "v2"])
@pytest.mark.parametrize("name,body", SCROLLS, ids=[n for n, _ in SCROLLS])
def test_scroll_matches_reference(docs, codec, name, body):
    """Every page equals the reference's; the pages are disjoint, but
    for a rescored body (each page rescores its own first lanes, so a
    doc can come back: the reference's offset paging, kept); a doc
    indexed and refreshed after the first page is not seen, a doc
    deleted after it is; then clear_scroll, and the next scroll is a
    404."""
    ref, port = fresh(docs, codec)
    seen = []
    sids = []
    for i, c in enumerate((ref, port)):
        first = c.search("t", body, scroll="2m")
        sids.append(first["_scroll_id"])
        c.index("t", {"body": "the fox the fox", "title": "fox"},
                id="late", refresh=True)
        c.delete("t", "d130", refresh=True)
        pages = [first]
        while pages[-1]["hits"]["hits"]:
            pages.append(c.scroll(sids[i], scroll="2m"))
        seen.append(pages)
    assert len(seen[0]) == len(seen[1]) >= 3, name
    ids = []
    for j, (w, g) in enumerate(zip(*seen)):
        same(strip_ids(g), strip_ids(w), f"{name} page {j}: ")
        ids.extend(hit_ids(g))
    assert (len(ids) == len(set(ids))) != ("rescore" in body), name
    assert "late" not in ids
    assert ("d130" in hit_ids(seen[1][0])) or "d130" not in ids
    for c, sid, err in ((ref, sids[0], RefApiError),
                        (port, sids[1], ApiError)):
        assert c.clear_scroll(scroll_id=sid) == {"succeeded": True,
                                                 "num_freed": 1}
        with pytest.raises(err) as e:
            c.scroll(sid)
        assert (e.value.status, e.value.err_type) == (
            404, "search_context_missing_exception")


def test_clear_scroll_forms_match_reference(docs):
    ref, port = fresh(docs)
    for c in (ref, port):
        a, b, d = (c.search("t", {"query": MATCH, "size": 5},
                            scroll="1m")["_scroll_id"] for _ in range(3))
        assert c.clear_scroll(body={"scroll_id": [a, "nope"]}) == {
            "succeeded": True, "num_freed": 1}
        assert c.clear_scroll(scroll_id=[b]) == {"succeeded": True,
                                                 "num_freed": 1}
        c.search("t", {"query": MATCH, "size": 5}, scroll="1m")
        assert c.clear_scroll(scroll_id="_all") == {"succeeded": True,
                                                    "num_freed": 2}
        assert c.clear_scroll(scroll_id=d) == {"succeeded": True,
                                               "num_freed": 0}
    for c, err in ((ref, RefApiError), (port, ApiError)):
        with pytest.raises(err) as e:
            c.search("t", {"query": MATCH}, scroll="soon")
        assert e.value.status == 400


def test_scroll_and_pit_expire(docs, monkeypatch):
    """Keep-alives expire lazily; a scroll call with a keep-alive and a
    point-in-time search with one extend the context."""
    ref, port = fresh(docs)
    clock = Clock(monkeypatch)
    for c, err in ((ref, RefApiError), (port, ApiError)):
        sid = c.search("t", {"query": MATCH, "size": 5},
                       scroll="30s")["_scroll_id"]
        pid = c.create_pit("t", keep_alive="30s")["pit_id"]
        clock.now += 20
        c.scroll(sid, scroll="1m")
        c.search(body={"query": MATCH, "pit": {"id": pid,
                                               "keep_alive": "1m"}})
        clock.now += 40         # past the first keep-alives, inside 1m
        c.scroll(sid)
        c.search(body={"query": MATCH, "pit": {"id": pid}})
        clock.now += 61
        with pytest.raises(err) as e:
            c.scroll(sid)
        assert e.value.status == 404
        with pytest.raises(err) as e:
            c.search(body={"query": MATCH, "pit": {"id": pid}})
        assert e.value.status == 404
    assert not port._scrolls and not port._pits


# ---------------------------------------------------------------------
# point in time
# ---------------------------------------------------------------------

PIT_SORTS = [
    ("price asc", [{"price": "asc"}]),
    ("price desc, status", [{"price": "desc"}, {"status": "asc"}]),
    ("score", None),
]


@pytest.mark.parametrize("codec", ["1", "2"], ids=["v1", "v2"])
@pytest.mark.parametrize("name,sort", PIT_SORTS,
                         ids=[n for n, _ in PIT_SORTS])
def test_pit_pages_match_reference(docs, codec, name, sort):
    """search_after pages under a point in time; re-indexed and deleted
    ids between the pages follow the reference's snapshot rule (the
    new copies unseen, the deletes seen); delete_pit, then a 404."""
    ref, port = fresh(docs, codec)
    runs = []
    for c in (ref, port):
        pid = c.create_pit("t", keep_alive="1m")["pit_id"]
        assert set(c.create_pit("t")) == {"pit_id", "creation_time"}
        body = {"query": MATCH, "size": 25, "pit": {"id": pid}}
        if sort:
            body["sort"] = sort
        pages = []
        for k in range(4):
            resp = c.search(body=dict(body))
            assert resp["pit_id"] == pid
            pages.append(resp)
            hits = resp["hits"]["hits"]
            if not hits:
                break
            last = hits[-1]
            body["search_after"] = (last["sort"] if sort
                                    else [last["_score"]])
            if k == 0:
                c.bulk(sum([[{"index": {"_index": "t", "_id": f"d{i}"}},
                             {"body": "the fox", "price": 1}]
                            for i in range(40, 48)], []) + [
                    {"delete": {"_index": "t", "_id": f"d{i}"}}
                    for i in range(60, 70)], refresh=True)
        assert c.delete_pit({"pit_id": [pid, "nope"]}) == {
            "pits": [{"pit_id": pid, "successful": True}]}
        runs.append((pid, pages))
    for j, (w, g) in enumerate(zip(runs[0][1], runs[1][1])):
        same(strip_ids(g), strip_ids(w), f"{name} page {j}: ")
    for c, (pid, _p), err in ((ref, runs[0], RefApiError),
                              (port, runs[1], ApiError)):
        with pytest.raises(err) as e:
            c.search(body={"query": MATCH, "pit": {"id": pid}})
        assert (e.value.status, e.value.err_type) == (
            404, "search_context_missing_exception")


def test_contexts_hold_segments_across_a_forcemerge(docs):
    """A scroll and a point in time that hold the segments a forcemerge
    replaces keep serving the reference's pages from them; the
    merged-away segments keep their device state until the last context
    goes, then release it, as a merge without contexts does at once."""
    ref, port = fresh(docs)
    body = {"query": MATCH, "size": 30}
    got = {}
    for c in (ref, port):
        sid = c.search("t", body, scroll="1m")["_scroll_id"]
        pid = c.create_pit("t")["pit_id"]
        old = list(port._indices["t"].engine.segments) if c is port else ()
        c.indices.forcemerge("t")
        pages = [c.scroll(sid),
                 c.search(body={**body, "pit": {"id": pid}})]
        if c is port:
            merged = port._indices["t"].engine.segments
            assert len(merged) == 1 and merged[0] not in old
            assert [(s.retired, s.holders) for s in old] == [(True, 2)] * 2
            assert all(s.device_arrays or s.aligned for s in old)
        c.clear_scroll(scroll_id=sid)
        if c is port:
            assert [s.holders for s in old] == [1, 1]
            assert all(s.device_arrays or s.aligned for s in old)
        pages.append(c.search(body={**body, "pit": {"id": pid}}))
        c.delete_pit({"pit_id": pid})
        if c is port:
            assert all(s.holders == 0 and not s.device_arrays
                       and not s.aligned for s in old)
        got[c is port] = pages
    for j, (w, g) in enumerate(zip(got[False], got[True])):
        same(strip_ids(g), strip_ids(w), f"page {j}: ")
    # no context: the merge releases at once
    seg = port._indices["t"].engine.segments[0]
    port.search("t", body)
    assert seg.aligned
    port.index("t", {"body": "the fox"}, id="x", refresh=True)
    port.indices.forcemerge("t")
    assert seg.retired and not seg.device_arrays and not seg.aligned


def test_context_over_a_deleted_index_pages_nothing(docs):
    ref, port = fresh(docs)
    for c in (ref, port):
        sid = c.search("t", {"query": MATCH, "size": 5},
                       scroll="1m")["_scroll_id"]
        pid = c.create_pit("t")["pit_id"]
        c.indices.delete("t")
        c.__dict__["_pages"] = (c.scroll(sid), c.search(
            body={"query": MATCH, "pit": {"id": pid}}))
    for w, g in zip(ref._pages, port._pages):
        same(strip_ids(g), strip_ids(w))
        assert g["hits"]["hits"] == []


# ---------------------------------------------------------------------
# field caps and the index calls
# ---------------------------------------------------------------------

@pytest.fixture()
def two_indices(tmp_path):
    """Both clients with an explicit index (analyzer settings, a text
    field with a keyword subfield, index: false, an object path) and a
    dynamic one."""
    body = {"settings": {"number_of_replicas": 0, "analysis": {
        "analyzer": {"ws": {"type": "custom", "tokenizer": "whitespace",
                            "filter": ["lowercase"]}}}},
        "mappings": {"_meta": {"owner": "x"}, "properties": {
            "title": {"type": "text", "analyzer": "ws",
                      "fields": {"raw": {"type": "keyword"}}},
            "tag": {"type": "keyword", "index": False},
            "user": {"properties": {"name": {"type": "keyword"},
                                    "age": {"type": "integer"}}},
            "ts": {"type": "date"}, "score": {"type": "double"}}}}
    out = []
    for c in (RefClient(data_path=str(tmp_path / "ref")),
              RestClient(device="cpu", data_path=str(tmp_path / "port"))):
        c.indices.create("logs", body)
        c.index("logs", {"title": "Hello World", "tag": "a",
                         "user": {"name": "bo", "age": 3},
                         "ts": "2024-01-02", "score": 1.5}, id="1",
                refresh=True)
        c.index("dyn", {"msg": "some text", "n": 4, "ok": True,
                        "when": "2024-02-03T04:05:06Z", "f": 0.5}, id="1",
                refresh=True)
        out.append(c)
    yield out
    for svc in out[0].node.indices.values():
        svc.close()
    out[1].close()


@pytest.mark.parametrize("index,fields", [
    ("_all", "*"), ("logs", "*"), ("dyn", "*"), ("logs", "title*"),
    ("*", "user.*,n"), ("logs,dyn", ["ts", "when"]), ("l*", "nope")],
    ids=str)
def test_field_caps_matches_reference(two_indices, index, fields):
    ref, port = two_indices
    assert port.field_caps(index, fields) == ref.field_caps(index, fields)


@pytest.mark.parametrize("index", ["logs", "dyn", "_all", "*", "l*",
                                   "logs,dyn"])
def test_index_reads_match_reference(two_indices, index):
    ref, port = two_indices
    assert port.indices.get(index) == ref.indices.get(index)
    assert port.indices.get_mapping(index) == ref.indices.get_mapping(index)
    assert port.indices.get_settings(index) == \
        ref.indices.get_settings(index)
    assert port.indices.exists(index) is ref.indices.exists(index) is True


def test_missing_index_calls_match_reference(two_indices):
    ref, port = two_indices
    for c, err in ((ref, RefApiError), (port, ApiError)):
        assert c.indices.exists("nope") is False
        assert c.indices.exists("n*") is False
        with pytest.raises(err) as e:
            c.indices.delete("nope")
        assert (e.value.status, e.value.err_type) == (
            404, "index_not_found_exception")
    assert port.indices.get_mapping("n*") == ref.indices.get_mapping("n*")
    assert port.field_caps("n*") == ref.field_caps("n*")
    for c in two_indices:
        with pytest.raises(Exception) as e:
            c.indices.get("nope")
        assert type(e.value).__name__ == "IndexNotFoundError"
    with pytest.raises(IndexNotFoundError):
        port.create_pit("nope")


def test_put_mapping_matches_reference_and_persists(two_indices, tmp_path):
    """put_mapping merges new fields (searchable at once) and persists
    them: a client reopened on the data path serves the same mapping."""
    ref, port = two_indices
    new = {"properties": {"city": {"type": "keyword"},
                          "title": {"type": "text", "analyzer": "ws",
                                    "fields": {"raw": {"type": "keyword"}}},
                          "geo": {"properties": {"lat": {"type": "double"}}}}}
    for c in two_indices:
        # a field mapped dynamically before the put: persisted with it
        c.index("logs", {"extra": "late text"}, id="3", refresh=True)
        assert c.indices.put_mapping("logs", new) == {"acknowledged": True}
        c.index("logs", {"city": "Oslo", "geo": {"lat": 59.9}}, id="2",
                refresh=True)
    assert port.indices.get_mapping("logs") == ref.indices.get_mapping(
        "logs")
    body = {"query": {"bool": {"should": [
        {"term": {"city": "Oslo"}}, {"match": {"extra": "text"}},
        {"match": {"title": "hello"}}]}}}
    same(port.search("logs", body), ref.search("logs", body))
    port.indices.flush("_all")
    port.close()
    back = RestClient(device="cpu", data_path=str(tmp_path / "port"))
    assert back.indices.get_mapping("logs") == ref.indices.get_mapping(
        "logs")
    assert back.indices.get_settings("_all") == \
        ref.indices.get_settings("_all")
    same(back.search("logs", body), ref.search("logs", body))


def test_delete_index_matches_reference(two_indices, tmp_path):
    """indices.delete drops the index, its device state and its files;
    the name can be created again; a wildcard deletes every match."""
    ref, port = two_indices
    segs = list(port._indices["logs"].engine.segments)
    port.search("logs", {"query": {"match": {"title": "hello"}}})
    assert any(s.device_arrays or s.aligned for s in segs)
    for c in two_indices:
        assert c.indices.delete("logs") == {"acknowledged": True}
        assert c.indices.exists("logs") is False
    assert all(not s.device_arrays and not s.aligned for s in segs)
    assert not (tmp_path / "port" / "logs").exists()
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["dyn"]
    for c in two_indices:
        c.indices.create("logs", MAPPING)
        c.index("logs", {"body": "fresh"}, id="9", refresh=True)
    same(port.search("logs", {}), ref.search("logs", {}))
    for c in two_indices:
        assert c.indices.delete("*") == {"acknowledged": True}
        assert c.indices.get_mapping("_all") == {}


# ---------------------------------------------------------------------
# chip_smoke phase 14 on a small bench corpus
# ---------------------------------------------------------------------


def test_phase14_runs_on_a_small_bench_corpus(bench_small, monkeypatch):
    """Phase 14's classes before phase 8 (count, explain, the budgets,
    profile and validate_query, the index reads, a scroll, a point in
    time with writes between its pages and a merge of a held segment)
    over phase 7's end state of a 3,000-passage bench corpus, on the
    CPU, every check of the phase in force; the brute force then still
    equals the port's pages after the phase's writes."""
    from opensearch_tpu_torch import bench_corpus as bc
    _ref, _port, _ix, port2, ix2, big = bench_small
    monkeypatch.setattr(chip_smoke, "SCROLL_SIZE", 20)
    # a 3,000-passage segment's query phase can take less than 1ms
    monkeypatch.setattr(chip_smoke, "SHORT_TIMEOUT", "0ms")
    df = big["corpus"][4]
    q = bc.pick_queries(df, 16, seed=3)
    terms = [[int(t) for t in dict.fromkeys(q[i][:2].tolist())]
             for i in range(16)]
    run = dict(big, client=port2, ix=ix2, body_terms=terms)
    out = chip_smoke.phase_options_msmarco(run, 3)
    assert out["scroll"]["pages"] == chip_smoke.SCROLL_PAGES
    assert out["pit"]["reindexed"] == chip_smoke.CONTEXT_WRITES
    assert not port2._scrolls and not port2._pits
    vs = bc.vocab_strings(len(df))
    for ts in terms[:6]:
        body = {"query": {"match": {"body": " ".join(vs[t] for t in ts)}}}
        chip_smoke.check_page(port2.search("bench", body),
                              ix2.page(*ix2.group(ts), 0, 10), str(ts))


def test_snapshot_pages_keep_the_reference_plain_response(docs):
    """A point-in-time page is the reference's `_search_snapshot`
    response: `timed_out` false and no `terminated_early` under a
    budget, `max_score` shown under a field sort, the total not capped by
    an integer `track_total_hits`, no collapse inner hits, no profile."""
    ref, port = fresh(docs)
    bodies = [
        {"query": MATCH, "terminate_after": 1, "timeout": "0ms"},
        {"query": MATCH, "sort": [{"price": "asc"}], "track_total_hits": 5},
        {"query": MATCH, "collapse": {"field": "status", "inner_hits": {
            "name": "more", "size": 2}}, "profile": True},
    ]
    for c in (ref, port):
        pid = c.create_pit("t")["pit_id"]
        c.__dict__["_pages"] = [c.search(body=dict(b, pit={"id": pid}))
                                for b in bodies]
    for w, g in zip(ref._pages, port._pages):
        same(strip_ids(g), strip_ids(w))
    got = port._pages
    assert got[0]["timed_out"] is False and "terminated_early" not in got[0]
    assert got[1]["hits"]["max_score"] is not None
    assert got[1]["hits"]["total"]["value"] > 5
    assert "profile" not in got[2] and all(
        "inner_hits" not in h for h in got[2]["hits"]["hits"])


def test_scroll_over_segments_without_deletes_ignores_a_later_segment(docs):
    """Two segments without deletes, where a search rides the
    concatenated shard view: a scroll's pages come from its snapshot,
    not from the view over the engine's current segments, so a doc
    refreshed later stays unseen."""
    ref, port = RefClient(), RestClient(device="cpu")
    for c in (ref, port):
        c.indices.create("t", MAPPING)
        half = len(docs) // 2
        for lo in (0, half):
            c.bulk(sum([[{"index": {"_index": "t", "_id": f"d{i}"}},
                         docs[i]] for i in range(lo, lo + half)], []),
                   refresh=True)
    body = {"query": MATCH, "size": 40}
    before = port._indices["t"].engine.__dict__.get("_shard_view")
    pages = {}
    for c in (ref, port):
        first = c.search("t", body, scroll="1m")
        c.index("t", {"body": "the fox the fox the fox"}, id="late",
                refresh=True)
        pages[c is port] = [first] + [c.scroll(first["_scroll_id"])
                                      for _ in range(4)]
    assert before is None and port._indices["t"].engine.__dict__.get(
        "_shard_view") is not None       # the first page rode the view
    for w, g in zip(pages[False], pages[True]):
        same(strip_ids(g), strip_ids(w))
        assert "late" not in hit_ids(g)
