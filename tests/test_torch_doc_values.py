"""Doc values of the port's new field types (opensearch_tpu_torch/index/
mappings.py, segment.py, merge.py, convert.py, search/compiler.py and
filters.py) against the JAX package on the CPU.

- Mappings: `date` (with its `format`), `boolean`, `double` and `float`
  fields, and the dynamic mapping of JSON booleans, floats and ISO-date
  strings, parse every document as the reference parses it (terms,
  numeric values, keyword doc values with `ignore_above` and
  `doc_values: false`, the mapping's types).
- Columns: keyword and float columns built by a refresh, written by
  `save` and read by `load` (the reference's segment files load in the
  port and the port's in the reference), carried by `convert` and by
  the tiered and forced merges equal the reference's arrays (merges plane
  by plane with OPENSEARCH_TPU_REORDER=0, in tests/test_torch_merge.py).
- Queries: `range`, `term`, `terms`, `match` and `exists` on date, double,
  float and boolean fields through both RestClients, on segments with
  deletes, then after flush and recovery: responses equal apart from
  `took`. A double range compares in f32 as the reference's does: two
  doubles that f32 merges are both in or both out.
"""

import re

import numpy as np
import pytest

from chip_smoke import strip_took
from opensearch_tpu.index.mappings import Mappings as RefMappings
from opensearch_tpu.index.segment import Segment as RefSegment
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu_torch import NotPortedError, RestClient
from opensearch_tpu_torch.index.convert import segment_from_arrays
from opensearch_tpu_torch.index.mappings import Mappings
from opensearch_tpu_torch.index.segment import Segment
from tests.test_torch_merge import assert_same_planes
from tests.test_torch_slice import assert_same_response

MAPPING = {"properties": {
    "body": {"type": "text"},
    "tag": {"type": "keyword", "ignore_above": 5},
    "nodv": {"type": "keyword", "doc_values": False},
    "when": {"type": "date"},
    "secs": {"type": "date", "format": "epoch_second"},
    "ok": {"type": "boolean"},
    "x": {"type": "double"},
    "f": {"type": "float"},
    "n": {"type": "long"}}}

DOCS = [
    {"body": "a b", "tag": "short", "nodv": "k1", "when": "2024-02-29",
     "secs": 1700000000, "ok": True, "x": 1.5, "f": 0.1, "n": 3},
    {"body": "b c", "tag": ["toolong", "ok"], "when": "2023-12-31T23:59:59Z",
     "secs": "1700000001.5", "ok": "false", "x": -2.25, "n": -7},
    {"body": "c", "when": 1704067200000, "ok": False,
     "x": 16777217.0, "f": 3.0},
    {"body": "a", "when": "2024/03/01", "ok": "true", "x": 16777216.0,
     "tag": ["b", "a", "b"]},
    {"body": "d", "when": "-1000", "x": 0.30000000000000004, "f": -0.0},
    {"body": "e", "dyn_b": True, "dyn_f": 2.75, "dyn_d": "2024-05-01",
     "dyn_s": "hello there", "dyn_i": 12},
]


def test_mappings_parse_as_the_reference():
    ref, port = RefMappings(MAPPING), Mappings(MAPPING)
    for i, doc in enumerate(DOCS):
        r, p = ref.parse(str(i), doc), port.parse(str(i), doc)
        assert p.terms == r.terms
        assert p.numerics == r.numerics
        assert p.keywords == r.keywords
        assert p.positions == r.positions
    for name, ft in ref.fields.items():
        assert port.fields[name].type == ft.type, name
        assert set(port.fields[name].subfields) == set(ft.subfields)
    assert port.fields["dyn_b"].type == "boolean"
    assert port.fields["dyn_f"].type == "double"
    assert port.fields["dyn_d"].type == "date"


@pytest.mark.parametrize("value", ["not a date", True])
def test_bad_dates_raise_as_the_reference(value):
    with pytest.raises(ValueError) as want:
        RefMappings(MAPPING).parse("1", {"when": value})
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        Mappings(MAPPING).parse("1", {"when": value})


def test_unported_mapping_options_raise():
    with pytest.raises(NotPortedError, match="_source"):
        Mappings({"_source": {"enabled": False}})
    with pytest.raises(NotPortedError, match="term_vector"):
        Mappings({"properties": {"d": {"type": "text",
                                       "term_vector": "yes"}}})


def _bulk(client, docs, index="t", start=0):
    client.bulk(sum([[{"index": {"_index": index, "_id": str(start + i)}},
                      d] for i, d in enumerate(docs)], []), refresh=True)


def _pair(tmp=None):
    out = []
    for c in (RefClient(data_path=tmp and f"{tmp}/r"),
              RestClient(device="cpu", data_path=tmp and f"{tmp}/p")):
        c.indices.create("t", {"mappings": MAPPING})
        _bulk(c, DOCS[:3])
        _bulk(c, DOCS[3:], start=3)
        c.delete("t", "1")
        c.index("t", dict(DOCS[1], x=7.0), id="1", refresh=True)
        out.append(c)
    return out


def _segs(ref, port):
    return (ref.node.indices["t"].shards[0].segments,
            port._indices["t"].engine.segments)


def test_columns_built_by_a_refresh_equal_the_reference():
    ref, port = _pair()
    rsegs, psegs = _segs(ref, port)
    assert len(rsegs) == len(psegs) == 3
    for rs, ps in zip(rsegs, psegs):
        assert_same_planes(rs, ps)
    assert psegs[0].numeric_cols["x"].kind == "float"
    assert psegs[0].numeric_cols["when"].kind == "int"
    assert psegs[0].keyword_cols["tag"].vocab == ["ok", "short"]
    assert "nodv" not in psegs[0].keyword_cols


def test_save_load_both_ways(tmp_path):
    ref, port = _pair()
    rsegs, psegs = _segs(ref, port)
    for k, (rs, ps) in enumerate(zip(rsegs, psegs)):
        rs.save(str(tmp_path / f"r{k}"))
        ps.save(str(tmp_path / f"p{k}"))
        assert_same_planes(rs, Segment.load(str(tmp_path / f"r{k}")))
        assert_same_planes(RefSegment.load(str(tmp_path / f"p{k}")), ps)


def test_convert_takes_reference_columns():
    ref, port = _pair()
    rsegs, _ = _segs(ref, port)
    for rs in rsegs:
        postings = {f: {"vocab": pb.vocab, "starts": pb.starts,
                        "doc_ids": pb.doc_ids, "tfs": pb.tfs,
                        "pos_starts": pb.pos_starts,
                        "positions": pb.positions}
                    for f, pb in rs.postings.items()}
        impacts = {f: {k: getattr(pb.impact, k) for k in (
            "q", "scale", "bits", "k1", "b", "avgdl", "dl_max",
            "block_starts", "block_off", "block_max")}
            for f, pb in rs.postings.items() if pb.impact is not None}
        seg = segment_from_arrays(
            rs.name, rs.ndocs, postings, rs.doc_lens,
            {f: (s.doc_count, s.sum_dl) for f, s in rs.text_stats.items()},
            list(rs.ids), list(rs.sources), live=rs.live, impacts=impacts,
            numeric_cols=rs.numeric_cols, keyword_cols=rs.keyword_cols)
        seg.seq_nos = rs.seq_nos
        assert_same_planes(rs, seg)


BODIES = [
    {"query": {"range": {"when": {"gte": "2024-01-01", "lt": "2024-03-01"}}}},
    {"query": {"range": {"when": {"gt": 1704067200000}}}},
    {"query": {"range": {"secs": {"gte": 1700000000.5}}}},
    {"query": {"term": {"when": "2024-02-29"}}},
    {"query": {"match": {"when": "2024"}}},
    {"query": {"terms": {"ok": [True]}}},
    {"query": {"term": {"ok": "false"}}},
    {"query": {"match": {"ok": "true"}}},
    {"query": {"range": {"x": {"gte": -2.25, "lt": 1.5}}}},
    # 16777216 and 16777217 are one f32: both in or both out
    {"query": {"range": {"x": {"gt": 16777216.0}}}},
    {"query": {"range": {"x": {"lte": 16777216.5}}}},
    {"query": {"term": {"x": 0.3}}},
    {"query": {"terms": {"f": [0.1, 3]}}},
    {"query": {"range": {"f": {"lte": 0}}}},
    {"query": {"range": {"dyn_f": {"gt": 1}}}},
    {"query": {"bool": {"filter": [{"exists": {"field": "when"}},
                                   {"exists": {"field": "tag"}}],
                        "must_not": [{"exists": {"field": "f"}}]}}},
    {"query": {"exists": {"field": "nodv"}}},
    {"query": {"bool": {"must": [{"match": {"body": "a b c"}}],
                        "filter": [{"range": {"x": {"gte": 0}}},
                                   {"term": {"ok": True}}]}}},
    {"query": {"constant_score": {"filter": {"range": {
        "when": {"lt": "2024-01-01"}}}}}},
]


def _check(ref, port):
    for body in BODIES:
        assert_same_response(port.search("t", body), ref.search("t", body))


def test_queries_on_the_new_types_match_the_reference():
    ref, port = _pair()
    _check(ref, port)


def test_queries_after_flush_recovery_and_a_forcemerge(tmp_path):
    ref, port = _pair(str(tmp_path))
    for c in (ref, port):
        c.indices.flush("t")
    port.close()
    ref = RefClient(data_path=str(tmp_path / "r"))
    port = RestClient(device="cpu", data_path=str(tmp_path / "p"))
    _check(ref, port)
    for c in (ref, port):
        c.indices.forcemerge("t", max_num_segments=1)
    (rs,), (ps,) = _segs(ref, port)
    assert_same_planes(rs, ps)
    _check(ref, port)
    body = {"size": 0, "aggs": {"w": {"date_histogram": {
        "field": "when", "calendar_interval": "year"}}, "t": {"terms": {
            "field": "tag"}}, "s": {"stats": {"field": "x"}}}}
    assert strip_took(port.search("t", body)) \
        == strip_took(ref.search("t", body))


def test_stats_read_the_f32_view_of_long_and_date_columns():
    """A long or date column's aggregations read its f32 view, as the
    reference's do: values f32 cannot hold come back rounded in both."""
    rows = [{"n": (1 << 53) + 1, "when": 1_704_067_200_001},
            {"n": (1 << 24) + 1, "when": "2024-01-01T00:00:00.003Z"}]
    body = {"size": 0, "aggs": {"n": {"stats": {"field": "n"}},
                                "w": {"max": {"field": "when"}}}}
    got = []
    for c in (RefClient(), RestClient(device="cpu")):
        c.indices.create("t", {"mappings": MAPPING})
        _bulk(c, rows)
        got.append(strip_took(c.search("t", body))["aggregations"])
    assert got[1] == got[0]
    assert got[1]["n"]["min"] == 16777216.0
    assert got[1]["n"]["max"] == float(1 << 53)
    assert got[1]["w"]["value"] == float(np.float32(1_704_067_200_003))
