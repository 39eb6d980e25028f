"""The port's document write calls (opensearch_tpu_torch/rest/client.py:
get / mget / exists, delete, update, bulk delete and update, flush,
forcemerge, `RestClient(data_path=...)`) against the JAX package's
RestClient on the CPU. Each case runs the same calls on a fresh client
of each package; every response is equal apart from `took`, and a call
that fails fails with the same status and error type. Searches after
the writes equal the reference's to the slice's tolerance
(tests/test_torch_slice.py: totals equal, scores within 1e-6 relative).
"""

import jax
import pytest

import chip_smoke
from opensearch_tpu.rest.client import ApiError as RefApiError
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu_torch import ApiError, RestClient
from tests.test_torch_slice import assert_same_response

jax.config.update("jax_platforms", "cpu")

INDEX = {"settings": {"number_of_replicas": 0},
         "mappings": {"properties": {"body": {"type": "text"},
                                     "tag": {"type": "keyword"},
                                     "n": {"type": "long"},
                                     "meta": {"properties": {
                                         "a": {"type": "long"},
                                         "b": {"type": "keyword"}}}}}}
SEARCHES = [{"query": {"match": {"body": "alpha"}}},
            {"query": {"match_all": {}}, "size": 20},
            {"query": {"term": {"tag": "red"}}},
            {"query": {"range": {"n": {"gte": 3}}}}]


def seed(c):
    c.indices.create("w", INDEX)
    lines = []
    for i in range(12):
        lines += [{"index": {"_index": "w", "_id": str(i)}},
                  {"body": f"alpha beta {'gamma ' * (i % 3)}doc{i}",
                   "tag": "red" if i % 2 else "blue", "n": i,
                   "meta": {"a": i, "b": "x"}}]
    c.bulk(lines, refresh=True)
    return c


def call(fn):
    """-> ("ok", response without took) or ("error", status, type)."""
    try:
        return ("ok", chip_smoke.strip_took(fn()))
    except (ApiError, RefApiError) as e:
        return ("error", e.status, e.err_type)


CASES = {
    "get_mget_exists": [
        lambda c: c.get("w", "3"),
        lambda c: c.get("w", "nope"),
        lambda c: c.exists("w", "4"),
        lambda c: c.exists("w", "nope"),
        lambda c: c.mget({"docs": [{"_id": "1"}, {"_id": "nope"},
                                   {"_index": "w", "_id": "2"}]},
                         index="w"),
        lambda c: c.index("w", {"body": "buffered"}, id="b1"),
        lambda c: c.get("w", "b1"),
    ],
    "delete": [
        lambda c: c.delete("w", "1"),
        lambda c: c.delete("w", "1"),
        lambda c: c.get("w", "1"),
        lambda c: c.delete("w", "2", if_seq_no=0),
        lambda c: c.delete("w", "2", if_seq_no=2, if_primary_term=1,
                           refresh=True),
        lambda c: c.index("w", {"body": "alpha again"}, id="1",
                          refresh=True),
    ],
    "update_doc_and_noop": [
        lambda c: c.update("w", "3", {"doc": {"n": 30, "meta": {"a": 7}}}),
        lambda c: c.get("w", "3"),
        lambda c: c.update("w", "3", {"doc": {"n": 30}}),
        lambda c: c.update("w", "3", {"doc": {"n": 30},
                                      "detect_noop": False},
                           refresh=True),
        lambda c: c.update("w", "4", {"doc": {"meta": {"b": "y"}}}),
        lambda c: c.update("w", "4", {}),
    ],
    "update_upserts_and_404": [
        lambda c: c.update("w", "u1", {"doc": {"body": "alpha up"},
                                       "doc_as_upsert": True}),
        lambda c: c.update("w", "u2", {"doc": {"n": 1},
                                       "upsert": {"body": "fresh", "n": 2}}),
        lambda c: c.update("w", "u3", {"doc": {"n": 1}}),
        lambda c: c.update("w", "u2", {"doc": {"n": 5},
                                       "upsert": {"n": 9}}, refresh=True),
        lambda c: c.get("w", "u2"),
        lambda c: c.index("w", {"body": "x"}, id="u1", op_type="create"),
    ],
    "bulk_delete_update": [
        lambda c: c.bulk([
            {"delete": {"_index": "w", "_id": "5"}},
            {"delete": {"_index": "w", "_id": "nope"}},
            {"update": {"_index": "w", "_id": "6"}}, {"doc": {"n": 60}},
            {"update": {"_index": "w", "_id": "new"}},
            {"doc": {"body": "alpha new"}, "doc_as_upsert": True},
            {"update": {"_index": "w", "_id": "missing"}}, {"doc": {"n": 1}},
            {"update": {"_index": "w", "_id": "7"}}, {"doc": {"n": 7}},
            {"create": {"_index": "w", "_id": "8"}}, {"body": "dup"},
            {"index": {"_index": "w", "_id": "9"}}, {"body": "alpha nine"},
        ], refresh=True),
        lambda c: c.mget({"docs": [{"_id": i} for i in
                                   ("5", "6", "new", "7", "9")]},
                         index="w"),
    ],
    "bulk_ndjson": [
        lambda c: c.bulk('{"delete": {"_index": "w", "_id": "0"}}\n'
                         '{"update": {"_index": "w", "_id": "10"}}\n'
                         '{"doc": {"tag": "red"}}\n', refresh=True),
    ],
    "forcemerge": [
        lambda c: c.bulk([{"delete": {"_index": "w", "_id": str(i)}}
                          for i in range(0, 12, 3)], refresh=True),
        lambda c: c.index("w", {"body": "alpha late", "n": 99}, id="late",
                          refresh=True),
        lambda c: c.indices.forcemerge("w", max_num_segments=1),
        lambda c: c.get("w", "late"),
        lambda c: c.delete("w", "late", refresh=True),
        lambda c: c.indices.forcemerge("w"),
    ],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_write_calls_match_reference(case, monkeypatch):
    monkeypatch.setenv("OPENSEARCH_TPU_REORDER", "0")
    ref, port = seed(RefClient()), seed(RestClient(device="cpu"))
    for step, fn in enumerate(CASES[case]):
        assert call(lambda: fn(port)) == call(lambda: fn(ref)), step
    ref.indices.refresh("w")
    port.indices.refresh("w")
    segs = [len(ref.node.indices["w"].shards[0].segments),
            len(port._indices["w"].engine.segments)]
    assert segs[0] == segs[1]
    for body in SEARCHES:
        assert_same_response(port.search("w", body), ref.search("w", body))


@pytest.mark.parametrize("body", [
    {"script": {"source": "ctx._source.n += 1"}},
    {"script": {"source": "ctx._source.n = 1"}, "upsert": {"n": 0},
     "scripted_upsert": True},
])
def test_update_scripts_are_not_ported(body):
    """Update scripts serve the reference's responses (they were not
    ported before painless-lite was): a scripted update and a scripted
    upsert, through `update` and through `bulk`."""
    ref, port = seed(RefClient()), seed(RestClient(device="cpu"))
    doc_id = "3" if "upsert" not in body else "absent"
    for c in (ref, port):
        c.update("w", doc_id, body)
    assert port.get("w", doc_id)["_source"] == \
        ref.get("w", doc_id)["_source"]
    lines = [{"update": {"_index": "w", "_id": doc_id}}, body]
    got, want = port.bulk(lines), ref.bulk(lines)
    assert [{k: it["update"].get(k) for k in ("_id", "result", "status")}
            for it in got["items"]] == [
        {k: it["update"].get(k) for k in ("_id", "result", "status")}
        for it in want["items"]]
    assert port.get("w", doc_id)["_source"] == \
        ref.get("w", doc_id)["_source"]


def test_flush_and_recovery_serve_equal_responses(tmp_path, monkeypatch):
    """Flushed segments, a translog tail of index and delete ops, then a
    second client on the same data path: the same responses as the
    reference's second node."""
    monkeypatch.setenv("OPENSEARCH_TPU_REORDER", "0")
    paths = {"ref": str(tmp_path / "ref"), "port": str(tmp_path / "port")}
    made = {"ref": lambda p: RefClient(data_path=p),
            "port": lambda p: RestClient(device="cpu", data_path=p)}
    out = {}
    for name, make in made.items():
        c = seed(make(paths[name]))
        c.delete("w", "2")
        c.indices.flush("w")
        c.index("w", {"body": "alpha tail", "n": 50}, id="tail")
        c.update("w", "4", {"doc": {"n": 40}})
        c.delete("w", "6")
        if name == "port":
            c.close()
        again = make(paths[name])
        out[name] = again
    ref, port = out["ref"], out["port"]
    assert call(lambda: port.indices.refresh("w")) \
        == call(lambda: ref.indices.refresh("w"))
    for fn in (lambda c: c.get("w", "tail"), lambda c: c.get("w", "4"),
               lambda c: c.get("w", "6"), lambda c: c.get("w", "2"),
               lambda c: c.index("w", {"body": "after"}, id="z")):
        assert call(lambda: fn(port)) == call(lambda: fn(ref))
    for body in SEARCHES:
        assert_same_response(port.search("w", body), ref.search("w", body))
    # a second flush and a third client: the recovered state persists
    ref.indices.flush("w")
    port.indices.flush("w")
    port.close()
    ref, port = RefClient(data_path=paths["ref"]), \
        RestClient(device="cpu", data_path=paths["port"])
    for body in SEARCHES:
        assert_same_response(port.search("w", body), ref.search("w", body))
    assert port.get("w", "z")["_source"] == {"body": "after"}


def test_recovered_dynamic_mappings_match_reference(tmp_path):
    """An auto-created index persists its create body only, as the
    reference's node does: after recovery a flushed segment's dynamic
    `long` field is unmapped in both packages, and a dynamic text field
    still serves."""
    out = []
    for name, make in (("ref", lambda p: RefClient(data_path=p)),
                       ("port", lambda p: RestClient(device="cpu",
                                                     data_path=p))):
        path = str(tmp_path / name)
        c = make(path)
        c.index("t", {"body": "hello world", "n": 5}, id="1", refresh=True)
        c.indices.flush("t")
        if name == "port":
            c.close()
        again = make(path)
        out.append([chip_smoke.strip_took(again.search("t", body)) for body in
                    ({"query": {"match": {"body": "hello"}}},
                     {"query": {"range": {"n": {"gte": 1}}}})])
    assert out[0] == out[1]
    assert out[1][0]["hits"]["total"]["value"] == 1
    assert out[1][1]["hits"]["total"]["value"] == 0


PHRASES = [
    {"query": {"match_phrase": {"body": "alpha beta"}}},
    {"query": {"match_phrase": {"body": {"query": "beta alpha",
                                         "slop": 2}}}},
    {"query": {"match_phrase_prefix": {"body": "beta gam"}}},
    {"query": {"span_near": {"clauses": [
        {"span_term": {"body": "alpha"}}, {"span_term": {"body": "gamma"}}],
        "slop": 1, "in_order": True}}},
]


@pytest.mark.parametrize("body", PHRASES,
                         ids=["exact", "sloppy", "prefix", "span_near"])
def test_positions_survive_flush_and_recovery(tmp_path, monkeypatch, body):
    """Positional segments flushed (positions saved with their postings),
    a translog tail, a recovery and a merge: phrase responses equal the
    reference's at each step."""
    monkeypatch.setenv("OPENSEARCH_TPU_REORDER", "0")
    made = {"ref": lambda p: RefClient(data_path=p),
            "port": lambda p: RestClient(device="cpu", data_path=p)}
    out = {}
    for name, make in made.items():
        path = str(tmp_path / name)
        c = seed(make(path))
        c.delete("w", "5")
        c.indices.flush("w")
        c.index("w", {"body": "gamma alpha beta gamma"}, id="tail")
        if name == "port":
            c.close()
        out[name] = make(path)
    ref, port = out["ref"], out["port"]
    assert_same_response(port.search("w", body), ref.search("w", body))
    ref.indices.refresh("w")
    port.indices.refresh("w")
    ref.indices.forcemerge("w")
    port.indices.forcemerge("w")
    assert_same_response(port.search("w", body), ref.search("w", body))
