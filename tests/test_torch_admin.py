"""Index administration around a search: aliases, index templates,
put_settings and write blocks, close / open, clone / shrink / split,
indices.stats, create, termvectors / mtermvectors; the port against the
JAX package on the CPU.

Every case runs the same calls, with the same documents made from a numpy
seed, through both packages' RestClient at a single shard, and requires
equal responses with `took` aside (scores within 1e-6 relative, as in
`tests/test_torch_compound.py`), and equal errors (status, type and
reason). The cases are those of the reference's tests/test_index_admin.py
(settings, close / open, resize), tests/test_rest.py (aliases and
wildcards, templates, termvectors) and tests/test_depth.py
(mtermvectors), cut to one shard. Where the reference goes beyond one
shard or replica (a split to 4, `number_of_replicas` 1, a template of 3
shards, an alias over two indices searched), the port raises
NotPortedError and the case says so.

`indices.stats` holds wall-clock values (the refresh-to-visible sketch's
sums and percentiles, a slow log entry's took and timestamp): those are
compared by presence and count, the rest exactly.

The ROADMAP's Queue 3 decisions each have a case: `post_filter` raises
where the reference serves the page unfiltered; a search through an alias
with a `filter` or a `routing` raises, while creating, reading and
writing through it match; aliases and templates are in memory only in
both packages, and a closed index recovers closed.
"""

import json
import tempfile

import jax
import numpy as np
import pytest

from opensearch_tpu.cluster.admin import IndexClosedError as RefClosed
from opensearch_tpu.cluster.state import ClusterStateError as RefStateError
from opensearch_tpu.rest.client import ApiError as RefApiError
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu_torch import ApiError, RestClient
from opensearch_tpu_torch.cluster.admin import IndexClosedError
from opensearch_tpu_torch.errors import (ClusterStateError,
                                         IndexNotFoundError, NotPortedError)
from tests.test_torch_compound import same

jax.config.update("jax_platforms", "cpu")

WORDS = ["quick", "brown", "fox", "lazy", "dog", "red", "apple", "river",
         "stone", "moon", "the", "common"]
ONE = {"number_of_shards": 1, "number_of_replicas": 0}


def idx_body():
    return {"settings": dict(ONE), "mappings": {"properties": {
        "body": {"type": "text"}, "n": {"type": "integer"},
        "tag": {"type": "keyword"}}}}


def make_docs(n=20, seed=7):
    """n docs (numpy seed): a Zipf-ish body, its number, a tag."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1) ** 0.8
    return [{"body": " ".join(rng.choice(WORDS, int(rng.integers(3, 9)),
                                         p=p / p.sum())) + f" doc{i}",
             "n": i, "tag": "ab"[i % 2]} for i in range(n)]


def fill(c, name="idx", docs=None, split=None):
    """The index with `docs` in one refresh, or two split at `split`."""
    c.indices.create(name, idx_body())
    docs = make_docs() if docs is None else docs
    cuts = [0, len(docs)] if split is None else [0, split, len(docs)]
    for lo, hi in zip(cuts, cuts[1:]):
        c.bulk(sum([[{"index": {"_index": name, "_id": str(i)}}, docs[i]]
                    for i in range(lo, hi)], []), refresh=True)
    return c


@pytest.fixture()
def pair():
    return fill(RefClient()), fill(RestClient(device="cpu"))


def both(pair, fn):
    """fn(client) through both; the port's result held to the
    reference's."""
    ref, port = pair
    want = fn(ref)
    got = fn(port)
    same(got, want)
    return got


def same_error(pair, fn, status=None):
    """fn(client) raises in both: the same status, type and reason for
    an ApiError, the same class name and message otherwise."""
    ref, port = pair
    with pytest.raises(Exception) as want:
        fn(ref)
    with pytest.raises(Exception) as got:
        fn(port)
    w, g = want.value, got.value
    if isinstance(w, RefApiError):
        assert isinstance(g, ApiError), (g, w)
        assert (g.status, g.err_type, g.reason) == \
            (w.status, w.err_type, w.reason)
        if status is not None:
            assert g.status == status
    else:
        assert type(g).__name__ == type(w).__name__, (g, w)
        assert str(g) == str(w)
    return g


MATCH = {"query": {"match": {"body": "fox common"}}, "size": 25}


# ---------------------------------------------------------------------
# put_settings (the reference's tests/test_index_admin.py:27-79)
# ---------------------------------------------------------------------

def test_dynamic_settings_apply(pair):
    both(pair, lambda c: c.indices.put_settings("idx", {"index": {
        "refresh_interval": "30s", "max_result_window": 50000}}))
    got = both(pair, lambda c: c.indices.get_settings("idx"))
    assert got["idx"]["settings"]["index"]["max_result_window"] == 50000
    both(pair, lambda c: c.indices.get("idx"))


def test_flat_keys_and_write_blocks(pair):
    both(pair, lambda c: c.indices.put_settings(
        "idx", {"index.blocks.write": True}))
    for fn in (lambda c: c.index("idx", {"body": "x"}, id="blocked"),
               lambda c: c.delete("idx", "3"),
               lambda c: c.update("idx", "3", {"doc": {"n": 99}}),
               lambda c: c.create("idx", "new", {"body": "y"})):
        same_error(pair, fn, status=403)
    got = both(pair, lambda c: c.bulk([
        {"index": {"_index": "idx", "_id": "b1"}}, {"body": "z"},
        {"delete": {"_index": "idx", "_id": "4"}}]))
    assert got["errors"] and got["items"][0]["index"]["status"] == 403
    both(pair, lambda c: c.indices.put_settings(
        "idx", {"index.blocks.write": False}))
    both(pair, lambda c: c.index("idx", {"body": "x"}, id="ok",
                                 refresh=True))
    both(pair, lambda c: c.search("idx", MATCH))


def test_read_only_blocks_writes(pair):
    both(pair, lambda c: c.indices.put_settings(
        "idx", {"index": {"blocks": {"read_only": True}}}))
    same_error(pair, lambda c: c.index("idx", {"body": "x"}, id="r"),
               status=403)
    both(pair, lambda c: c.search("idx", MATCH))


def test_number_of_replicas(pair):
    """0 is acknowledged in both; above 0 the reference builds replica
    copies, the port raises."""
    ref, port = pair
    both(pair, lambda c: c.indices.put_settings(
        "idx", {"index": {"number_of_replicas": 0}}))
    ref.indices.put_settings("idx", {"index": {"number_of_replicas": 1}})
    with pytest.raises(NotPortedError, match="number_of_replicas > 0"):
        port.indices.put_settings("idx", {"index": {
            "number_of_replicas": 1}})
    same_error(pair, lambda c: c.indices.put_settings(
        "idx", {"index": {"number_of_replicas": -1}}), status=400)
    assert port.indices.get_settings("idx")["idx"]["settings"]["index"][
        "number_of_replicas"] == 0


def test_static_rejected_on_open(pair):
    g = same_error(pair, lambda c: c.indices.put_settings("idx", {"index": {
        "analysis": {"analyzer": {"a": {"type": "standard"}}}}}), 400)
    assert "non dynamic" in g.reason


def test_final_always_rejected(pair):
    both(pair, lambda c: c.indices.close("idx"))
    g = same_error(pair, lambda c: c.indices.put_settings(
        "idx", {"index": {"number_of_shards": 4}}), 400)
    assert "final" in g.reason


def test_unknown_rejected(pair):
    same_error(pair, lambda c: c.indices.put_settings(
        "idx", {"index": {"bogus_setting": 1}}), 400)
    same_error(pair, lambda c: c.indices.put_settings(
        "nope", {"index": {"refresh_interval": "1s"}}), 404)


def test_static_allowed_when_closed(pair):
    both(pair, lambda c: c.indices.close("idx"))
    both(pair, lambda c: c.indices.put_settings("idx", {"index": {
        "analysis": {"analyzer": {"my": {
            "type": "custom", "tokenizer": "whitespace",
            "filter": ["lowercase"]}}}}}))
    both(pair, lambda c: c.indices.open("idx"))
    got = both(pair, lambda c: c.indices.analyze(
        "idx", {"analyzer": "my", "text": "Hello WORLD"}))
    assert [t["token"] for t in got["tokens"]] == ["hello", "world"]
    both(pair, lambda c: c.search("idx", MATCH))


def test_preserve_existing(pair):
    both(pair, lambda c: c.indices.put_settings(
        "idx", {"index": {"refresh_interval": "5s"}}))
    both(pair, lambda c: c.indices.put_settings(
        "idx", {"index": {"refresh_interval": "9s",
                          "max_result_window": 20}},
        preserve_existing=True))
    got = both(pair, lambda c: c.indices.get_settings("idx"))
    assert got["idx"]["settings"]["index"]["refresh_interval"] == "5s"


def _slowlog_view(stats: dict) -> dict:
    """A stats block's slow logs without wall-clock values."""
    out = {}
    for kind, blk in stats["slowlog"].items():
        out[kind] = {"thresholds": blk["thresholds"],
                     "recent": [{k: e[k] for k in ("index", "level",
                                                   "source")}
                                for e in blk["recent"]]}
    return out


def test_slowlog_threshold_update(pair):
    ref, port = pair
    both(pair, lambda c: c.indices.put_settings("idx", {"index": {"search": {
        "slowlog": {"threshold": {"query": {"warn": "0ms"}}}},
        "indexing.slowlog.threshold.index.info": "0ms"}}))
    both(pair, lambda c: c.search("idx", MATCH))
    both(pair, lambda c: c.index("idx", {"body": "slow"}, id="s"))
    assert any(e["level"] == "warn"
               for e in port._indices["idx"].search_slowlog.entries)
    want = ref.indices.stats("idx")["indices"]["idx"]["total"]
    got = port.indices.stats("idx")["indices"]["idx"]["total"]
    assert _slowlog_view(got) == _slowlog_view(want)
    assert _slowlog_view(got)["indexing"]["recent"][0]["level"] == "info"


# ---------------------------------------------------------------------
# close / open (tests/test_index_admin.py:88-129)
# ---------------------------------------------------------------------

def test_close_blocks_search_and_write(pair):
    got = both(pair, lambda c: c.indices.close("idx"))
    assert got["indices"] == {"idx": {"closed": True}}
    g = same_error(pair, lambda c: c.search("idx", MATCH), 400)
    assert g.err_type == "index_closed_exception"
    same_error(pair, lambda c: c.index("idx", {"body": "y"}, id="nope"), 400)
    same_error(pair, lambda c: c.delete("idx", "3"), 400)
    same_error(pair, lambda c: c.count("idx", {}))
    # a get, an explain and a term vector read a closed index, as the
    # reference's do
    both(pair, lambda c: c.get("idx", "3"))
    both(pair, lambda c: c.explain("idx", "3", {"query": {"match": {
        "body": "fox"}}}))
    both(pair, lambda c: c.termvectors("idx", "3", body={
        "term_statistics": True}))
    both(pair, lambda c: c.indices.close("idx"))
    both(pair, lambda c: c.indices.open("idx"))
    got = both(pair, lambda c: c.search("idx", MATCH))
    assert got["hits"]["total"]["value"] > 0
    both(pair, lambda c: c.search("idx", {"query": {"match_all": {}}}))


def test_open_keeps_the_segments(pair):
    """Open re-applies the settings and rebuilds no segment."""
    ref, port = pair
    segs = list(port._indices["idx"].engine.segments)
    both(pair, lambda c: c.indices.close("idx"))
    both(pair, lambda c: c.indices.open("idx"))
    assert all(a is b for a, b in
               zip(port._indices["idx"].engine.segments, segs))
    both(pair, lambda c: c.search("idx", MATCH))


def test_msearch_closed_index_maps_error(pair):
    both(pair, lambda c: c.indices.close("idx"))
    got = both(pair, lambda c: c.msearch(
        [{"index": "idx"}, {"query": {"match_all": {}}},
         {"index": "idx"}, MATCH]))
    assert "closed" in str(got["responses"][0]["error"]).lower()


def test_alias_of_closed_index_raises(pair):
    both(pair, lambda c: c.indices.put_alias("idx", "myalias"))
    both(pair, lambda c: c.indices.close("idx"))
    g = same_error(pair, lambda c: c.search("myalias", MATCH))
    assert g.err_type == "index_closed_exception"


def test_wildcard_skips_closed(pair):
    for c in pair:
        c.indices.create("idx2", idx_body())
        c.index("idx2", {"body": "other fox"}, id="a", refresh=True)
    both(pair, lambda c: c.indices.close("idx"))
    got = both(pair, lambda c: c.search("idx*", MATCH))
    assert got["hits"]["total"]["value"] == 1
    both(pair, lambda c: c.count("idx*", {}))


def test_closed_state_persists_and_aliases_do_not():
    """A closed index recovers closed; aliases and templates are in
    memory only (a Queue 3 decision: the reference's behaviour)."""
    paths = tempfile.mkdtemp(), tempfile.mkdtemp()
    clients = RefClient(data_path=paths[0]), RestClient(
        device="cpu", data_path=paths[1])
    for c in clients:
        c.indices.create("p", idx_body())
        c.index("p", {"body": "persisted fox"}, id="1")
        c.indices.put_alias("p", "pa")
        c.indices.put_index_template("t", {"index_patterns": ["q*"]})
        c.indices.close("p")
    again = RefClient(data_path=paths[0]), RestClient(device="cpu",
                                                      data_path=paths[1])
    assert again[0].node.indices["p"].meta.state == "close"
    assert again[1]._indices["p"].meta.state == "close"
    same_error(again, lambda c: c.search("p", MATCH), 400)
    both(again, lambda c: c.indices.get_alias())
    assert again[1].indices.get_alias() == {}
    assert not any(c.indices.exists_index_template("t") for c in again)
    same_error(again, lambda c: c.search("pa", MATCH))
    both(again, lambda c: c.indices.open("p"))
    both(again, lambda c: c.indices.refresh("p"))
    got = both(again, lambda c: c.search("p", MATCH))
    assert got["hits"]["total"]["value"] == 1
    with open(f"{paths[1]}/p/index_meta.json") as fh:
        assert json.load(fh)["state"] == "open"


# ---------------------------------------------------------------------
# resize (tests/test_index_admin.py:147-198, one shard)
# ---------------------------------------------------------------------

def _block(pair):
    both(pair, lambda c: c.indices.put_settings(
        "idx", {"index.blocks.write": True}))


def test_resize_requires_write_block(pair):
    g = same_error(pair, lambda c: c.indices.shrink("idx", "small"), 400)
    assert "read-only" in g.reason


def test_shrink(pair):
    _block(pair)
    got = both(pair, lambda c: c.indices.shrink(
        "idx", "small", {"settings": {"index": {"number_of_shards": 1}}}))
    assert got["copied_docs"] == 20
    both(pair, lambda c: c.search("small", MATCH))
    got = both(pair, lambda c: c.get("small", "7"))
    assert got["_source"]["n"] == 7
    both(pair, lambda c: c.indices.get("small"))
    both(pair, lambda c: c.indices.get_settings("small"))
    # the target is writable: the source's blocks are not carried
    both(pair, lambda c: c.index("small", {"body": "new fox"}, id="new",
                                 refresh=True))
    both(pair, lambda c: c.search("small", MATCH))


def test_shrink_factor_check(pair):
    """A one-shard source shrinks to no more shards than one."""
    _block(pair)
    same_error(pair, lambda c: c.indices.shrink(
        "idx", "bad", {"settings": {"index": {"number_of_shards": 2}}}), 400)


def test_split_and_clone(pair):
    ref, port = pair
    _block(pair)
    body = {"settings": {"index": {"number_of_shards": 4}}}
    assert ref.indices.split("idx", "wide", body)["copied_docs"] == 20
    with pytest.raises(NotPortedError, match=r"number_of_shards > 1"):
        port.indices.split("idx", "wide", body)
    assert "wide" not in port._indices
    both(pair, lambda c: c.indices.split("idx", "one"))
    both(pair, lambda c: c.search("one", MATCH))
    both(pair, lambda c: c.indices.clone("idx", "copy"))
    got = both(pair, lambda c: c.search("copy", {"query": {"match_all": {}},
                                                 "size": 30}))
    assert got["hits"]["total"]["value"] == 20
    both(pair, lambda c: c.index("copy", {"body": "new doc"}, id="new"))
    same_error(pair, lambda c: c.indices.clone(
        "idx", "copy2", {"settings": {"index": {"number_of_shards": 2}}}),
        400)


def test_resize_of_a_sayt_index_keeps_the_chains():
    """A clone of an index with a search_as_you_type field: the target
    is created from the source's `to_dict()`, which names the generated
    subfields by type; the port keeps their shingle chains (OpenSearch's
    page), the reference rebuilds them as plain text (ROADMAP Queue 3):
    "quick brown" on `ss._2gram` / `ss._3gram` totals 1 / 0 in the
    port's clone, as on its source, and 2 / 2 in the reference's."""
    ref, port = RefClient(), RestClient(device="cpu")
    for c in (ref, port):
        c.indices.create("s", {"settings": dict(ONE), "mappings": {
            "properties": {"ss": {"type": "search_as_you_type"}}}})
        for i, t in enumerate(("quick brown fox", "quick red fox")):
            c.index("s", {"ss": t}, id=str(i), refresh=True)
        c.indices.put_settings("s", {"index": {"blocks": {"write": True}}})
        c.indices.clone("s", "s2")
    totals = {}
    for name, c in (("ref", ref), ("port", port)):
        totals[name] = [[c.search(i, {"query": {"match": {
            f: "quick brown"}}})["hits"]["total"]["value"]
            for f in ("ss._2gram", "ss._3gram", "ss._index_prefix")]
            for i in ("s", "s2")]
    assert totals["port"] == [[1, 0, 2], [1, 0, 2]]
    assert totals["ref"] == [[1, 0, 2], [2, 2, 2]]


def test_resize_of_segments_with_deletes_and_aliases():
    docs = make_docs(40, seed=11)
    pair = (fill(RefClient(), docs=docs, split=25),
            fill(RestClient(device="cpu"), docs=docs, split=25))
    both(pair, lambda c: c.bulk([{"delete": {"_index": "idx", "_id": d}}
                                 for d in ("1", "5", "30")], refresh=True))
    _block(pair)
    got = both(pair, lambda c: c.indices.clone(
        "idx", "c2", {"aliases": {"cur": {}}}))
    assert got["copied_docs"] == 37
    both(pair, lambda c: c.indices.get_alias(name="cur"))
    both(pair, lambda c: c.search("cur", MATCH))
    both(pair, lambda c: c.indices.stats("c2")["_all"])


def test_target_exists_rejected(pair):
    _block(pair)
    for c in pair:
        c.indices.create("taken", idx_body())
    same_error(pair, lambda c: c.indices.clone("idx", "taken"), 400)
    same_error(pair, lambda c: c.indices.clone("nope", "t2"), 404)
    both(pair, lambda c: c.indices.close("idx"))
    same_error(pair, lambda c: c.indices.clone("idx", "t3"), 400)


# ---------------------------------------------------------------------
# aliases and wildcards (tests/test_rest.py:90)
# ---------------------------------------------------------------------

def logs_pair():
    docs = make_docs(6, seed=3)
    out = []
    for c in (RefClient(), RestClient(device="cpu")):
        fill(c, "logs-2024-01", docs=docs[:3])
        fill(c, "logs-2024-02", docs=[dict(d, n=d["n"] + 10)
                                      for d in docs[3:]])
        out.append(c)
    return tuple(out)


def test_aliases_and_wildcards():
    pair = logs_pair()
    ref, port = pair
    both(pair, lambda c: c.indices.update_aliases({"actions": [
        {"add": {"index": "logs-2024-01", "alias": "logs"}},
        {"add": {"index": "logs-2024-02", "alias": "logs"}}]}))
    assert ref.count("logs")["count"] == 6
    assert ref.count("logs-2024-*")["count"] == 6
    for expr in ("logs", "logs-2024-*", "logs-2024-01,logs-2024-02"):
        with pytest.raises(NotPortedError,
                           match="a search over several indices"):
            port.count(expr)
    got = both(pair, lambda c: c.indices.get_alias(name="logs"))
    assert set(got) == {"logs-2024-01", "logs-2024-02"}
    both(pair, lambda c: c.indices.get_alias())
    both(pair, lambda c: c.indices.exists("logs"))
    both(pair, lambda c: c.indices.get("logs"))
    both(pair, lambda c: c.indices.get_settings("logs"))
    both(pair, lambda c: c.indices.get_mapping("logs-*"))
    both(pair, lambda c: c.field_caps("logs"))
    both(pair, lambda c: c.validate_query("logs", {"query": {
        "match": {"body": "fox"}}}, explain=True))
    # a write through an alias of two indices and no write index
    same_error(pair, lambda c: c.index("logs", {"body": "x"}, id="w"))
    same_error(pair, lambda c: c.get("logs", "0"))
    both(pair, lambda c: c.indices.update_aliases({"actions": [
        {"add": {"index": "logs-2024-02", "alias": "logs",
                 "is_write_index": True}}]}))
    got = both(pair, lambda c: c.index("logs", {"body": "fox written"},
                                       id="w", refresh=True))
    assert got["_index"] == "logs-2024-02"
    both(pair, lambda c: c.get("logs", "w"))
    both(pair, lambda c: c.search("logs-2024-02", MATCH))
    both(pair, lambda c: c.indices.update_aliases({"actions": [
        {"remove": {"index": "logs-2024-01", "alias": "logs"}}]}))
    both(pair, lambda c: c.search("logs", MATCH))
    same_error(pair, lambda c: c.indices.update_aliases({"actions": [
        {"swap": {"index": "logs-2024-01", "alias": "x"}}]}))
    same_error(pair, lambda c: c.indices.update_aliases({"actions": [
        {"add": {"index": "nope", "alias": "x"}}]}))


def test_an_expression_naming_no_open_index_is_empty():
    """A search, count, msearch or point in time whose expression names
    no open index (an unmatched wildcard, every match closed) serves the
    reference's empty response: no shards, a total of 0, no hits, the
    aggregations empty; a count of 0."""
    pair = logs_pair()
    aggs = {"query": {"match": {"body": "fox"}},
            "aggs": {"t": {"terms": {"field": "tag"}}}}
    for expr in ("nope*", "nope-*,none-*"):
        got = both(pair, lambda c: c.search(expr, MATCH))
        assert got["_shards"]["total"] == 0
        assert got["hits"]["total"]["value"] == 0 and not got["hits"]["hits"]
        both(pair, lambda c: c.search(expr, aggs))
        assert both(pair, lambda c: c.count(expr))["count"] == 0
        both(pair, lambda c: c.msearch([{"index": expr}, MATCH,
                                        {"index": expr}, aggs]))

    def pit_page(c):
        pid = c.create_pit("nope*")["pit_id"]
        resp = c.search(body={"pit": {"id": pid}, **MATCH})
        assert resp.pop("pit_id") == pid
        return resp
    both(pair, pit_page)
    for c in pair:
        c.indices.close("logs-2024-01")
        c.indices.close("logs-2024-02")
    both(pair, lambda c: c.search("logs-2024-*", MATCH))
    assert both(pair, lambda c: c.count("_all"))["count"] == 0


def test_update_and_index_keyword_options():
    """ROADMAP Queue 3's three decisions: `retry_on_conflict` on an
    update is accepted (one writer: it changes nothing); `if_seq_no` /
    `if_primary_term` on an update, which the reference ignores where
    OpenSearch checks them, raise NotPortedError; `pipeline=` on an
    index raises NotPortedError("ingest pipeline")."""
    pair = (fill(RefClient()), fill(RestClient(device="cpu")))
    ref, port = pair
    both(pair, lambda c: c.update("idx", "3", {"doc": {"n": 33}},
                                  retry_on_conflict=3, refresh=True))
    both(pair, lambda c: c.update("idx", "new", {"doc": {"n": 1},
                                                 "doc_as_upsert": True},
                                  retry_on_conflict=1, refresh=True))
    both(pair, lambda c: c.get("idx", "3"))
    both(pair, lambda c: c.search("idx", {"query": {"term": {"n": 33}}}))
    for kw in ({"if_seq_no": 0}, {"if_primary_term": 1},
               {"if_seq_no": 0, "if_primary_term": 1}):
        ref.update("idx", "4", {"doc": {"n": 44}}, **kw)
        with pytest.raises(NotPortedError, match="if_seq_no"):
            port.update("idx", "4", {"doc": {"n": 44}}, **kw)
    with pytest.raises(NotPortedError, match="ingest pipeline"):
        port.index("idx", {"body": "x"}, id="p", pipeline="p1")
    assert port.get("idx", "4")["_source"]["n"] == 4
    with pytest.raises(ApiError):
        port.get("idx", "p")


def test_reads_through_a_one_index_alias():
    pair = logs_pair()
    both(pair, lambda c: c.indices.put_alias("logs-2024-01", "cur"))
    both(pair, lambda c: c.search("cur", MATCH))
    both(pair, lambda c: c.search("cu*", MATCH))
    both(pair, lambda c: c.count("cur", {"query": {"match": {
        "body": "fox"}}}))
    both(pair, lambda c: c.get("cur", "1"))
    both(pair, lambda c: c.mget({"docs": [{"_index": "cur", "_id": "1"},
                                          {"_index": "cur", "_id": "9"}]}))
    both(pair, lambda c: c.explain("cur", "1", {"query": {"match": {
        "body": "fox"}}}))
    both(pair, lambda c: c.msearch([{"index": "cur"}, MATCH,
                                    {"index": "cur"},
                                    {"query": {"term": {"tag": "a"}}}]))
    both(pair, lambda c: c.indices.analyze("cur", {"field": "body",
                                                   "text": "Red Fox"}))
    for c in pair:
        page = c.search("cur", {"query": {"match_all": {}}, "size": 1},
                        scroll="1m")
        assert len(c.scroll(page["_scroll_id"])["hits"]["hits"]) == 1
        pit = c.create_pit("cur")["pit_id"]
        assert c.search(body={"pit": {"id": pit}, "query": {
            "match_all": {}}})["hits"]["total"]["value"] == 3
    # the alias's write index takes a create through it
    got = both(pair, lambda c: c.create("cur", "c1", {"body": "created"}))
    assert got["result"] == "created"
    same_error(pair, lambda c: c.create("cur", "c1", {"body": "again"}),
               409)


def test_delete_index_drops_it_from_aliases():
    pair = logs_pair()
    both(pair, lambda c: c.indices.update_aliases({"actions": [
        {"add": {"indices": ["logs-2024-01", "logs-2024-02"],
                 "alias": "both"}},
        {"add": {"index": "logs-2024-01", "alias": "only1"}}]}))
    both(pair, lambda c: c.indices.delete("logs-2024-01"))
    got = both(pair, lambda c: c.indices.get_alias())
    assert set(got) == {"logs-2024-02"}
    both(pair, lambda c: c.search("both", MATCH))
    same_error(pair, lambda c: c.search("only1", MATCH))
    # deleting through an alias deletes its indices
    both(pair, lambda c: c.indices.delete("both"))
    both(pair, lambda c: c.indices.exists("logs-2024-02"))
    same_error(pair, lambda c: c.indices.delete("both"), 404)


def test_alias_with_filter_or_routing():
    """Queue 3: creating, reading and writing through an alias with a
    `filter` or a `routing` match the reference; a search through it
    raises, where the reference serves the page unfiltered."""
    pair = logs_pair()
    ref, port = pair
    both(pair, lambda c: c.indices.update_aliases({"actions": [
        {"add": {"index": "logs-2024-01", "alias": "only_a",
                 "filter": {"term": {"tag": "a"}}}},
        {"add": {"index": "logs-2024-02", "alias": "routed",
                 "routing": "r1", "is_write_index": True}}]}))
    both(pair, lambda c: c.indices.get_alias())
    both(pair, lambda c: c.indices.get("logs-2024-01"))
    both(pair, lambda c: c.get("only_a", "1"))
    both(pair, lambda c: c.index("routed", {"body": "routed doc"}, id="r",
                                 refresh=True))
    both(pair, lambda c: c.search("logs-2024-02", MATCH))
    unfiltered = ref.search("only_a", {"query": {"match_all": {}}})
    assert unfiltered["hits"]["total"]["value"] == 3
    for alias, opt in (("only_a", "filter"), ("routed", "routing"),
                       ("only*", "filter")):
        for call in (lambda: port.search(alias, MATCH),
                     lambda: port.count(alias),
                     lambda: port.msearch([{"index": alias}, MATCH]),
                     lambda: port.create_pit(alias)):
            with pytest.raises(NotPortedError,
                               match=rf"an alias with a \[{opt}\]"):
                call()


def test_post_filter_raises():
    """Queue 3: the reference reads no `post_filter` and serves the page
    unfiltered; the port raises (also pinned by tests/test_torch_sort)."""
    ref, port = fill(RefClient()), fill(RestClient(device="cpu"))
    body = {"query": {"match": {"body": "fox"}},
            "post_filter": {"term": {"tag": "a"}}}
    want = ref.search("idx", body)
    assert want["hits"]["total"] == ref.search("idx", {"query": body[
        "query"]})["hits"]["total"]
    with pytest.raises(NotPortedError, match=r"post_filter"):
        port.search("idx", body)


# ---------------------------------------------------------------------
# index templates and create (tests/test_rest.py:102)
# ---------------------------------------------------------------------

def test_index_templates():
    pair = RefClient(), RestClient(device="cpu")
    both(pair, lambda c: c.indices.put_index_template("tmpl", {
        "index_patterns": ["tmp-*"], "priority": 1,
        "template": {"settings": dict(ONE),
                     "mappings": {"properties": {
                         "f": {"type": "keyword"}}},
                     "aliases": {"tmp-alias": {}}}}))
    both(pair, lambda c: c.indices.put_template("older", {
        "index_patterns": ["tmp-*", "other"], "order": 0,
        "settings": {"refresh_interval": "7s"},
        "mappings": {"properties": {"f": {"type": "text"}}}}))
    assert all(c.indices.exists_index_template("tmpl") for c in pair)
    both(pair, lambda c: c.index("tmp-1", {"f": "v"}, id="1", refresh=True))
    # templates apply lowest priority first, and the first mapping and
    # the first value of a setting stay (the reference's merge order)
    got = both(pair, lambda c: c.indices.get_mapping("tmp-1"))
    assert got["tmp-1"]["mappings"]["properties"]["f"]["type"] == "text"
    got = both(pair, lambda c: c.indices.get_settings("tmp-1"))
    assert got["tmp-1"]["settings"]["index"]["refresh_interval"] == "7s"
    # the reference applies no template's aliases at create
    both(pair, lambda c: c.indices.get_alias())
    both(pair, lambda c: c.search("tmp-1", {"query": {"match": {"f": "v"}}}))
    # a create body's settings and mapping win over the templates'
    both(pair, lambda c: c.indices.create("tmp-2", {
        "settings": {"refresh_interval": "1s"},
        "mappings": {"properties": {"f": {"type": "text"}}},
        "aliases": {"t2": {"is_write_index": True}}}))
    both(pair, lambda c: c.indices.get("tmp-2"))
    both(pair, lambda c: c.indices.get("t2"))
    # a body's {"index": {...}} settings take the place of the
    # templates' top-level ones
    both(pair, lambda c: c.indices.create("tmp-3", {
        "settings": {"index": {"refresh_interval": "2s"}}}))
    got = both(pair, lambda c: c.indices.get_settings("tmp-3"))
    assert got["tmp-3"]["settings"]["index"] == {"refresh_interval": "2s"}
    both(pair, lambda c: c.indices.delete_index_template("tmpl"))
    same_error(pair, lambda c: c.indices.delete_index_template("tmpl"), 404)
    assert not any(c.indices.exists_index_template("tmpl") for c in pair)


def test_template_beyond_one_shard_raises():
    ref, port = RefClient(), RestClient(device="cpu")
    for c in (ref, port):
        c.indices.put_index_template("wide", {
            "index_patterns": ["w-*"],
            "template": {"settings": {"number_of_shards": 3}}})
    ref.index("w-1", {"f": "v"}, id="1")
    assert ref.node.indices["w-1"].meta.num_shards == 3
    with pytest.raises(NotPortedError, match="number_of_shards > 1"):
        port.index("w-1", {"f": "v"}, id="1")
    assert "w-1" not in port._indices


def test_create_and_unported_settings():
    pair = fill(RefClient()), fill(RestClient(device="cpu"))
    got = both(pair, lambda c: c.create("idx", "new", {"body": "fresh fox"},
                                        refresh=True))
    assert got["result"] == "created"
    same_error(pair, lambda c: c.create("idx", "new", {"body": "again"}), 409)
    same_error(pair, lambda c: c.create("idx", "3", {"body": "again"}), 409)
    got = both(pair, lambda c: c.bulk([
        {"create": {"_index": "idx", "_id": "new"}}, {"body": "x"},
        {"create": {"_index": "idx", "_id": "newer"}}, {"body": "y"}],
        refresh=True))
    assert [next(iter(i.values()))["status"] for i in got["items"]] \
        == [409, 201]
    both(pair, lambda c: c.search("idx", MATCH))
    port = pair[1]
    for setting in ({"default_pipeline": "p"},
                    {"search": {"default_pipeline": "p"}},
                    {"lifecycle": {"name": "pol"}}):
        with pytest.raises(NotPortedError, match="index setting"):
            port.indices.create("u", {"settings": setting})
    assert "u" not in port._indices


# ---------------------------------------------------------------------
# indices.stats
# ---------------------------------------------------------------------

def _stats_view(resp: dict) -> dict:
    """indices.stats without its wall-clock values."""
    out = json.loads(json.dumps(resp))
    for part in [out["indices"][n][k] for n in out["indices"]
                 for k in ("primaries", "total")]:
        rtv = part["refresh"].get("refresh_to_visible_ms")
        if rtv is not None:
            part["refresh"]["refresh_to_visible_ms"] = {
                "count": rtv["count"],
                "keys": sorted(rtv)}
        part["slowlog"] = _slowlog_view(part)
    return out


def test_stats():
    name = "stats-idx"
    docs = make_docs(150, seed=5)
    pair = (fill(RefClient(), name, docs=docs[:40], split=25),
            fill(RestClient(device="cpu"), name, docs=docs[:40], split=25))
    stats = lambda c: _stats_view(c.indices.stats(name))  # noqa: E731
    got = both(pair, stats)
    assert got["indices"][name]["total"]["refresh"]["total"] == 2
    both(pair, lambda c: c.bulk([{"delete": {"_index": name, "_id": "3"}}]))
    # 70 buffered docs: the first 64 folded into the byte estimate
    for c in pair:
        c.bulk(sum([[{"index": {"_index": name, "_id": f"b{i}"}}, docs[i]]
                    for i in range(40, 110)], []))
    got = both(pair, stats)
    blk = got["indices"][name]["total"]
    assert blk["indexing"]["buffer"]["docs"] == 70
    assert blk["indexing"]["buffer"]["bytes"] > 0
    both(pair, lambda c: c.indices.refresh(name))
    both(pair, lambda c: c.indices.forcemerge(name))
    got = both(pair, stats)
    assert got["indices"][name]["total"]["merges"]["total"] >= 1
    both(pair, lambda c: _stats_view(c.indices.stats()))
    port = pair[1]
    (seg,) = port._indices[name].engine.segments
    want = sum(pb.doc_ids.nbytes + pb.tfs.nbytes + pb.starts.nbytes
               for pb in seg.postings.values()) + sum(
        col.values.nbytes for col in seg.numeric_cols.values())
    assert got["indices"][name]["total"]["store"]["size_in_bytes"] == want


def test_stats_flush_with_a_data_path():
    paths = tempfile.mkdtemp(), tempfile.mkdtemp()
    pair = (fill(RefClient(data_path=paths[0]), "fl"),
            fill(RestClient(device="cpu", data_path=paths[1]), "fl"))
    both(pair, lambda c: c.indices.flush("fl"))
    both(pair, lambda c: c.indices.close("fl"))
    got = both(pair, lambda c: _stats_view(c.indices.stats("fl")))
    assert got["indices"]["fl"]["total"]["flush"]["total"] == 2


# ---------------------------------------------------------------------
# termvectors (tests/test_rest.py:214) and mtermvectors
# (tests/test_depth.py:71)
# ---------------------------------------------------------------------

TV_MAPPING = {"settings": dict(ONE), "mappings": {"properties": {
    "txt": {"type": "text"}, "kw": {"type": "keyword"},
    "ann": {"type": "annotated_text"}, "n": {"type": "integer"}}}}


@pytest.fixture(scope="module")
def tv_pair():
    """Two segments, one doc of the first deleted."""
    docs = make_docs(30, seed=13)
    out = []
    for c in (RefClient(), RestClient(device="cpu")):
        c.indices.create("d", json.loads(json.dumps(TV_MAPPING)))
        for lo, hi in ((0, 15), (15, 30)):
            c.bulk(sum([[{"index": {"_index": "d", "_id": str(i)}},
                         {"txt": docs[i]["body"] + " the fox the",
                          "kw": ["k1", "k2"][i % 2],
                          "ann": f"met [{WORDS[i % 5]}](Person&x{i % 3}) "
                                 f"in town", "n": i}]
                        for i in range(lo, hi)], []), refresh=True)
        c.delete("d", "4", refresh=True)
        out.append(c)
    return tuple(out)


TV_BODIES = [
    {},
    {"fields": ["txt"]},
    {"term_statistics": True},
    {"term_statistics": True, "field_statistics": False,
     "positions": False},
    {"fields": ["txt", "ann"], "offsets": False,
     "filter": {"max_num_terms": 2}},
    {"fields": ["txt"], "term_statistics": True,
     "filter": {"max_num_terms": 5, "min_doc_freq": 2, "max_doc_freq": 25}},
    {"fields": ["txt"], "filter": {"min_term_freq": 2}},
]


@pytest.mark.parametrize("body", TV_BODIES, ids=[json.dumps(b)
                                                 for b in TV_BODIES])
def test_termvectors(tv_pair, body):
    for doc_id in ("0", "7", "20"):
        got = both(tv_pair, lambda c: c.termvectors(
            "d", doc_id, body=json.loads(json.dumps(body))))
        assert got["found"]
    got = both(tv_pair, lambda c: c.termvectors("d", "1", fields=["txt"]))
    assert got["term_vectors"]["txt"]["terms"]["fox"]["term_freq"] >= 1


def test_termvectors_artificial_missing_and_errors(tv_pair):
    body = {"doc": {"txt": "quick quick fox zebra", "kw": "k9",
                    "ann": "[Lazy](Dog) dog"},
            "term_statistics": True, "filter": {"max_num_terms": 3}}
    got = both(tv_pair, lambda c: c.termvectors("d", body=body))
    assert got["_id"] == ""
    # the filter drops terms no segment holds (df 0 < min_doc_freq 1)
    assert "Dog" not in got["term_vectors"]["ann"]["terms"]
    got = both(tv_pair, lambda c: c.termvectors("d", body={
        "doc": body["doc"]}))
    assert got["term_vectors"]["ann"]["terms"]["Dog"]["term_freq"] == 1
    got = both(tv_pair, lambda c: c.termvectors("d", "zzz"))
    assert got["found"] is False
    same_error(tv_pair, lambda c: c.termvectors("d"), 400)
    same_error(tv_pair, lambda c: c.termvectors("nope", "1"))


def test_mtermvectors(tv_pair):
    got = both(tv_pair, lambda c: c.mtermvectors({"docs": [
        {"_index": "d", "_id": "1", "fields": ["txt"]},
        {"_index": "d", "_id": "2", "fields": ["txt"],
         "term_statistics": True},
        {"_index": "d", "doc": {"txt": "brown dog"}},
        {"_index": "d", "_id": "4"}]}))
    assert len(got["docs"]) == 4 and got["docs"][3]["found"] is False
    both(tv_pair, lambda c: c.mtermvectors(
        {"docs": [{"_id": "3", "filter": {"max_num_terms": 2}}]}, index="d"))
    same_error(tv_pair, lambda c: c.mtermvectors({"docs": [{"_id": "3"}]}),
               400)


# ---------------------------------------------------------------------
# the card stays the default; the errors are the reference's types
# ---------------------------------------------------------------------

def test_error_types_mirror_the_reference():
    assert issubclass(IndexClosedError, ClusterStateError)
    assert RefClosed.__name__ == IndexClosedError.__name__
    assert RefStateError.__name__ == ClusterStateError.__name__
    c = RestClient(device="cpu")
    with pytest.raises(IndexNotFoundError):
        c.search("missing", MATCH)
    with pytest.raises(IndexNotFoundError):
        c.termvectors("missing", "1")


# ---------------------------------------------------------------------
# chip_smoke phase 21 on a small bench corpus, and the postings packer
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def admin_bench():
    """chip_smoke's corpus index at 3,000 passages (the title in each
    `_source`, as phase 5 builds it), 16 of its `_id`s re-indexed as
    phase 7 does, phase 7's brute force beside it, and phase 5's match
    bodies."""
    import chip_smoke
    from opensearch_tpu_torch import bench_corpus as bc
    n = 3000
    corpus = bc.build_corpus(n)
    columns = bc.guardrail_columns(n)
    title = bc.build_title_corpus(n)
    df = corpus[4]
    vs = bc.vocab_strings(len(df))
    port = RestClient(device="cpu")
    bc.make_index(port, corpus, columns=columns, title=title,
                  title_source=True)
    ix = chip_smoke.NumpyIndex(corpus, columns, title)
    q = bc.pick_queries(df, 16, seed=12)
    redo = [(7 * j + 3, [int(t) for t in q[j]], j % 3, j) for j in
            range(16)]
    for old, terms, st, pr in redo:
        port.index("bench", {"body": " ".join(vs[t] for t in terms),
                             "status": bc.STATUS_VALUES[st], "price": pr},
                   id=str(old))
    port.indices.refresh("bench")
    ix.reindex(redo)
    q2, q6 = bc.pick_queries(df, 4), bc.pick_queries_real(df, 4)
    bodies, terms = [], []
    for i in range(4):
        for ts in (list(q2[i][:2]), list(q6[i])):
            bodies.append({"query": {"match": {"body": " ".join(
                vs[t] for t in ts)}}, "size": 10})
            terms.append(ts)
    big = {"client": port, "ix": ix, "corpus": corpus, "columns": columns,
           "title": title, "bodies": bodies, "body_terms": terms}
    return big, {"queries": bc.pick_queries(df, 64)}


def test_phase21_on_a_small_bench_corpus(admin_bench, monkeypatch):
    """Phase 21 whole on the CPU over 3,000 passages (the corpus segment
    with deletes, the re-indexed docs' segment): (a)'s pages through the
    alias == by name == the brute force, (b)'s term vectors == the title
    draw's brute force, (c)'s settings, blocks, close / open and stats,
    (d)'s resize of 400 passages == its brute force; then (a) again after
    a forcemerge. The phase sets OPENSEARCH_TPU_REORDER=0 for its merges;
    the test restores the variable, so that it does not reach the tests
    a worker runs after it."""
    import chip_smoke
    monkeypatch.setenv("OPENSEARCH_TPU_REORDER", "0")
    big, bools = admin_bench
    out = chip_smoke.phase_admin_msmarco(big, bools, 400, 0, "cpu")
    assert not chip_smoke.VERIFY.todo
    hits = sum(sum(c["singles"]["hits"]) for k, c in out["classes"].items()
               if k.startswith("a_"))
    assert hits > 0
    d = out["classes"]["d_resize"]["classes"]
    assert set(d["b3"]) == {"res-src", "res-clone", "res-shrink",
                            "res-split"}
    port, ix = big["client"], big["ix"]
    assert not [n for n in port._indices if n.startswith("res-")]
    port.indices.forcemerge("bench")
    ix.compact()
    merged = chip_smoke.phase_admin_merged(big)
    assert merged["b3"]["singles"]["hits"] == out["classes"]["a_b3"][
        "singles"]["hits"]


def test_pack_postings_matches_the_reference():
    """The port's packer (interned and sorted in numpy) against the
    reference's Python packer over parsed documents with text, keyword
    and empty fields."""
    from opensearch_tpu.index.segment import _pack_postings_python
    from opensearch_tpu_torch.index.segment import pack_postings
    c = RestClient(device="cpu")
    c.indices.create("p", {"mappings": {"properties": {
        "body": {"type": "text"}, "tag": {"type": "keyword"},
        "e": {"type": "text"}, "title": {"type": "text"}}}})
    m = c._indices["p"].mappings
    docs = make_docs(300, seed=17)
    parsed = [m.parse(str(i), {**d, "e": "", "title": d["body"][:7]}
                      if i % 3 else {"tag": ["x", "y", "x"]})
              for i, d in enumerate(docs)]
    got, want = pack_postings(parsed), _pack_postings_python(parsed, True)
    assert list(got) == list(want)
    for f, w in want.items():
        g = got[f]
        assert g.vocab == w.vocab and g.terms == w.terms, f
        for a in ("starts", "doc_ids", "tfs", "pos_starts", "positions"):
            x, y = getattr(g, a), getattr(w, a)
            assert x.dtype == y.dtype and np.array_equal(x, y), (f, a)
