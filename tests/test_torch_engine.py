"""The port's engine (opensearch_tpu_torch/index/engine.py, translog.py,
segment save/load) against the JAX package's on the CPU: the cases of
tests/test_engine.py, each run through both engines with their results
compared. Everything here is exact: results, gets, doc counts, doc
freqs, tfs, postings and impact planes equal.
"""

import os

import jax
import numpy as np
import pytest
import torch

from opensearch_tpu.index.engine import Engine as RefEngine
from opensearch_tpu.index.engine import VersionConflictError as RefConflict
from opensearch_tpu.index.mappings import Mappings as RefMappings
from opensearch_tpu.index.segment import Segment as RefSegment
from opensearch_tpu_torch.index.engine import Engine, VersionConflictError
from opensearch_tpu_torch.index.mappings import Mappings
from opensearch_tpu_torch.index.segment import Segment
from opensearch_tpu_torch.index.translog import Translog

jax.config.update("jax_platforms", "cpu")

MAPPING = {"properties": {"body": {"type": "text"}, "n": {"type": "long"},
                          "tag": {"type": "keyword"}}}
CPU = torch.device("cpu")


def engines(path=None):
    """(reference engine, port engine); with `path`, each under its own
    subdirectory."""
    return (RefEngine(RefMappings(MAPPING),
                      path=None if path is None else os.path.join(path, "r")),
            Engine(Mappings(MAPPING), device=CPU,
                   path=None if path is None else os.path.join(path, "p")))


def both(fn):
    """fn(engine) on both engines -> the two results, asserted equal."""
    r, p = fn(0), fn(1)
    assert p == r
    return p


def test_index_refresh_search_roundtrip():
    es = engines()
    for e in es:
        e.index_doc("1", {"body": "hello world", "n": 1})
        e.index_doc("2", {"body": "hello there", "n": 2})
    assert both(lambda i: es[i].num_docs) == 2
    for e in es:
        e.refresh()
    assert both(lambda i: len(es[i].segments)) == 1
    assert both(lambda i: es[i].doc_freq("body", "hello")) == 2
    assert both(lambda i: es[i].doc_freq("body", "world")) == 1


def test_realtime_get_from_buffer_and_segment():
    es = engines()
    for e in es:
        e.index_doc("1", {"body": "x", "n": 5})
    assert both(lambda i: es[i].get("1"))["_source"]["n"] == 5
    for e in es:
        e.refresh()
    assert both(lambda i: es[i].get("1"))["_source"]["n"] == 5
    assert both(lambda i: es[i].get("missing")) is None


def test_update_replaces_old_version():
    es = engines()
    for e in es:
        e.index_doc("1", {"body": "old", "n": 1})
        e.refresh()
    assert both(lambda i: es[i].index_doc("1", {"body": "new", "n": 2})
                )["result"] == "updated"
    for e in es:
        e.refresh()
    assert both(lambda i: es[i].num_docs) == 1
    assert both(lambda i: es[i].get("1"))["_source"]["body"] == "new"
    assert both(lambda i: sum(s.live_count for s in es[i].segments)) == 1


def test_delete_and_tombstone():
    es = engines()
    for e in es:
        e.index_doc("1", {"body": "a"})
        e.index_doc("2", {"body": "b"})
        e.refresh()
    assert both(lambda i: es[i].delete_doc("1"))["result"] == "deleted"
    assert both(lambda i: es[i].num_docs) == 1
    assert both(lambda i: es[i].get("1")) is None
    assert both(lambda i: es[i].delete_doc("zzz"))["result"] == "not_found"


def test_optimistic_concurrency():
    es = engines()
    seq = both(lambda i: es[i].index_doc("1", {"body": "v1"}))["_seq_no"]
    both(lambda i: es[i].index_doc("1", {"body": "v2"}, if_seq_no=seq,
                                   if_primary_term=1))
    for e, err in zip(es, (RefConflict, VersionConflictError)):
        with pytest.raises(err):
            e.index_doc("1", {"body": "v3"}, if_seq_no=seq,
                        if_primary_term=1)
        with pytest.raises(err):
            e.index_doc("1", {"body": "x"}, op_type="create")
        with pytest.raises(err, match=r"\(delete\)"):
            e.delete_doc("1", if_seq_no=seq)


def test_merge_compacts_deletes():
    es = engines()
    for e in es:
        for i in range(10):
            e.index_doc(str(i), {"body": f"doc number {i}", "n": i})
        e.refresh()
        for i in range(5):
            e.delete_doc(str(i))
    merged = [e.force_merge_group(list(e.segments)) for e in es]
    assert [m.ndocs for m in merged] == [5, 5]
    assert [m.live_count for m in merged] == [5, 5]
    assert sorted(merged[1].ids) == sorted(merged[0].ids) \
        == [str(i) for i in range(5, 10)]
    rp, pp = merged[0].postings["body"], merged[1].postings["body"]
    assert pp.doc_ids.max() < 5
    np.testing.assert_array_equal(pp.doc_ids, rp.doc_ids)
    np.testing.assert_array_equal(pp.starts, rp.starts)
    np.testing.assert_array_equal(pp.impact.q, rp.impact.q)
    # the version map follows the merge
    assert both(lambda i: es[i].get("7"))["_source"]["n"] == 7
    assert both(lambda i: es[i].delete_doc("7"))["result"] == "deleted"
    assert both(lambda i: es[i].num_docs) == 4


def test_flush_and_recover(tmp_data_path):
    es = engines(tmp_data_path)
    for e in es:
        e.index_doc("1", {"body": "persisted doc", "n": 7})
        e.flush()
        e.index_doc("2", {"body": "translog only", "n": 8})  # not flushed
        e.close()
    es = engines(tmp_data_path)
    assert both(lambda i: es[i].num_docs) == 2
    assert both(lambda i: es[i].get("1"))["_source"]["n"] == 7
    assert both(lambda i: es[i].get("2"))["_source"]["n"] == 8
    assert both(lambda i: [(s.name, s.ndocs) for s in es[i].segments]) \
        == [("_0", 1), ("_1", 1)]
    assert both(lambda i: es[i].seq_no) == 1


def test_translog_replay_of_delete(tmp_data_path):
    es = engines(tmp_data_path)
    for e in es:
        e.index_doc("1", {"body": "a"})
        e.flush()
        e.delete_doc("1")
        e.close()
    es = engines(tmp_data_path)
    assert both(lambda i: es[i].get("1")) is None
    assert both(lambda i: es[i].num_docs) == 0


def test_translog_generations(tmp_path):
    t = Translog(str(tmp_path / "tl"))
    t.add_index("1", {"a": 1}, None, 0)
    t.add_delete("1", 1)
    assert t.rollover() == 1
    t.add_index("2", {"b": 2}, "r", 2)
    assert [r["seq_no"] for r in t.replay_from(0)] == [0, 1, 2]
    t.prune_below(1)
    assert [r["_id"] for r in t.replay_from(0)] == []
    assert list(t.replay_from(1)) == [{"op": "index", "_id": "2",
                                       "_source": {"b": 2}, "routing": "r",
                                       "seq_no": 2}]
    t.close()


def test_segment_save_load_roundtrip(tmp_path):
    es = engines()
    for e in es:
        e.index_doc("1", {"body": "round trip", "n": 3, "tag": ["x", "y"]})
        e.index_doc("2", {"body": "trip round round", "n": 4, "tag": "y"})
        e.index_doc("3", {"body": "gone", "n": 5})
        e.refresh()
        e.delete_doc("3")
    rseg, pseg = es[0].segments[0], es[1].segments[0]
    rseg.save(str(tmp_path / "r"))
    pseg.save(str(tmp_path / "p"))
    rl, pl = RefSegment.load(str(tmp_path / "r")), \
        Segment.load(str(tmp_path / "p"))
    for loaded, seg in ((rl, rseg), (pl, pseg)):
        assert loaded.ndocs == 3
        assert loaded.postings["body"].vocab == seg.postings["body"].vocab
        np.testing.assert_array_equal(loaded.postings["body"].doc_ids,
                                      seg.postings["body"].doc_ids)
        assert loaded.sources[0]["body"] == "round trip"
        np.testing.assert_array_equal(loaded.live, [True, True, False])
    assert rl.keyword_cols["tag"].vocab == pl.postings["tag"].vocab \
        == ["x", "y"]
    for f, pb in pseg.postings.items():
        lp = pl.postings[f]
        for a in ("starts", "doc_ids", "tfs"):
            assert getattr(lp, a).tobytes() == getattr(pb, a).tobytes()
        assert (lp.impact is None) == (pb.impact is None)
        if pb.impact is not None:
            assert lp.impact.q.tobytes() == pb.impact.q.tobytes()
            assert lp.impact.block_max.tobytes() \
                == pb.impact.block_max.tobytes()
            assert lp.impact.scale == pb.impact.scale
            assert lp.impact.avgdl == pb.impact.avgdl
    np.testing.assert_array_equal(pl.seq_nos, pseg.seq_nos)
    np.testing.assert_array_equal(pl.numeric_cols["n"].values,
                                  pseg.numeric_cols["n"].values)
    assert pl.codec_version == pseg.codec_version == rl.codec_version
    assert pl.local_doc("3") == -1 and pl.local_doc("2") == 1


def test_tf_recorded():
    es = engines()
    for e in es:
        e.index_doc("1", {"body": "spam spam spam ham"})
        e.refresh()

    def tf(i):
        pb = es[i].segments[0].postings["body"]
        a, _b = pb.row_slice(pb.row("spam"))
        return float(pb.tfs[a])
    assert both(tf) == 3.0
