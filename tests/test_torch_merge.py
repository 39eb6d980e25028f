"""Segment merges of the port (opensearch_tpu_torch/index/merge.py,
ops/device_merge.merge_sorted_runs, the engine's tiered policy and
forcemerge) against the JAX package on the CPU.

Tolerances:
- `merge_sorted_runs`: rows, docs, tfs, order and counts equal bit for
  bit to the reference's jnp sort and to `np.lexsort`, below and above
  DEVICE_MERGE_MIN;
- merged planes (postings, impact q / scale / sidecars, numeric columns,
  doc lengths, text stats, ids, sources, seq_nos): equal, with the
  reference's BP reorder off (OPENSEARCH_TPU_REORDER=0). Impact planes
  here stay below DEVICE_IMPACT_MIN postings, where both packages
  quantize in numpy (above it the reference's XLA program contracts an
  FMA: tests/test_torch_codec.py);
- responses: the slice's tolerance (tests/test_torch_slice.py: totals
  equal, ids and order equal up to swaps of hits whose scores agree
  within 1e-6 relative, scores within 1e-6 relative), `took` aside;
- with the reference's reorder ON (engaged at 256 docs) and its fast path
  forced on with the port's plain kernels stood in (as
  tests/test_torch_ladder.py and tests/test_torch_bool.py run it), so
  both packages serve through the same rungs: the reference's pages
  differ from its unreordered and exact pages on some bodies of every
  case, so a merge the reference would reorder raises
  NotPortedError("BP reorder") in the port; with the reorder off ids,
  scores, order and totals equal bit for bit.
"""

import jax
import jax.numpy as jnp  # noqa: F401  (the reference's sort runs on it)
import numpy as np
import pytest
import torch

from opensearch_tpu.index import merge as ref_merge
from opensearch_tpu.ops import device_merge as ref_device_merge
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu.search import fastpath as rfp
from opensearch_tpu_torch import NotPortedError, RestClient, bench_corpus
from opensearch_tpu_torch.index import merge
from opensearch_tpu_torch.ops import bm25, device_merge
from opensearch_tpu_torch.search import compiler as C
from opensearch_tpu_torch.search import fastpath, impactpath
from tests.test_torch_bool import _plain_bool
from tests.test_torch_ladder import _plain_impact, _plain_tfdl
from tests.test_torch_slice import assert_same_response

jax.config.update("jax_platforms", "cpu")

CPU = torch.device("cpu")
# no replica: the reference serves every search from its primary
MAPPING = {"settings": {"number_of_replicas": 0},
           "mappings": {"properties": {"body": {"type": "text"},
                                       "tag": {"type": "keyword"},
                                       "n": {"type": "long"}}}}
WORDS = [f"w{i}" for i in range(60)]


def make_docs(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1) ** 1.1
    p /= p.sum()
    out = []
    for i in range(n):
        k = int(rng.integers(2, 24))
        doc = {"body": " ".join(rng.choice(WORDS, k, p=p)),
               "tag": f"t{int(rng.integers(0, 5))}"}
        if i % 7:
            doc["n"] = int(rng.integers(0, 1000))
        out.append(doc)
    return out


BODIES = [
    {"query": {"match": {"body": "w0 w3"}}},
    {"query": {"match": {"body": "w5 w9 w11"}}, "size": 20},
    {"query": {"match": {"body": {"query": "w1 w2 w7",
                                  "minimum_should_match": 2}}}},
    {"query": {"term": {"tag": "t2"}}},
    {"query": {"bool": {"must": [{"match": {"body": "w2"}}],
                        "filter": [{"range": {"n": {"gte": 300}}}]}}},
    {"query": {"match_all": {}}, "from": 3},
    {"query": {"match": {"body": "w4 w8"}}, "track_total_hits": True},
]


def write_script(docs, rounds: int, deletes=(), updates=()):
    """The same writes for both clients: `rounds` refreshes of
    len(docs) // rounds docs each, then deletes and partial updates,
    then a refresh."""
    per = len(docs) // rounds

    def run(c):
        c.indices.create("x", MAPPING)
        for r in range(rounds):
            c.bulk(sum([[{"index": {"_index": "x", "_id": f"d{i}"}},
                         docs[i]] for i in range(r * per, (r + 1) * per)],
                       []), refresh=True)
        lines = [{"delete": {"_index": "x", "_id": f"d{i}"}}
                 for i in deletes]
        for i in updates:
            lines += [{"update": {"_index": "x", "_id": f"d{i}"}},
                      {"doc": {"n": 5000 + i, "tag": "t9"}}]
        if lines:
            c.bulk(lines, refresh=True)
        return c
    return run


def segs(client, ref: bool):
    if ref:
        return client.node.indices["x"].shards[0].segments
    return client._indices["x"].engine.segments


def assert_same_planes(rs, ps):
    assert rs.ndocs == ps.ndocs and rs.live_count == ps.live_count
    assert list(rs.ids) == list(ps.ids)
    assert list(rs.sources) == list(ps.sources)
    np.testing.assert_array_equal(rs.seq_nos, ps.seq_nos)
    np.testing.assert_array_equal(rs.live, ps.live)
    assert rs.codec_version == ps.codec_version
    assert set(rs.postings) == set(ps.postings)
    for f, rp in rs.postings.items():
        pp = ps.postings[f]
        assert rp.vocab == pp.vocab
        for a in ("starts", "doc_ids", "tfs"):
            got, want = getattr(pp, a), getattr(rp, a)
            assert got.tobytes() == want.astype(got.dtype).tobytes(), (f, a)
        assert (rp.pos_starts is None) == (pp.pos_starts is None), f
        if rp.pos_starts is not None:
            for a in ("pos_starts", "positions"):
                got, want = getattr(pp, a), getattr(rp, a)
                assert got.dtype == want.dtype and \
                    got.tobytes() == want.tobytes(), (f, a)
        assert (rp.impact is None) == (pp.impact is None)
        if rp.impact is not None:
            for a in ("q", "block_starts", "block_off", "block_max"):
                got, want = getattr(pp.impact, a), getattr(rp.impact, a)
                assert got.dtype == want.dtype and \
                    got.tobytes() == want.tobytes(), (f, a)
            for a in ("scale", "bits", "k1", "b", "avgdl", "dl_max"):
                assert getattr(pp.impact, a) == getattr(rp.impact, a)
    assert set(rs.numeric_cols) == set(ps.numeric_cols)
    for f, rc in rs.numeric_cols.items():
        assert ps.numeric_cols[f].kind == rc.kind
        assert ps.numeric_cols[f].values.dtype == rc.values.dtype
        np.testing.assert_array_equal(ps.numeric_cols[f].values, rc.values)
        np.testing.assert_array_equal(ps.numeric_cols[f].present,
                                      rc.present)
    assert set(rs.keyword_cols) == set(ps.keyword_cols)
    for f, rc in rs.keyword_cols.items():
        pc = ps.keyword_cols[f]
        assert pc.vocab == rc.vocab
        for a in ("starts", "ords", "doc_of_value", "min_ord"):
            got, want = getattr(pc, a), getattr(rc, a)
            assert got.dtype == want.dtype and \
                got.tobytes() == want.tobytes(), (f, a)
    assert set(rs.doc_lens) == set(ps.doc_lens)
    for f, dl in rs.doc_lens.items():
        np.testing.assert_array_equal(ps.doc_lens[f], dl)
        assert (ps.text_stats[f].doc_count, ps.text_stats[f].sum_dl) \
            == (rs.text_stats[f].doc_count, rs.text_stats[f].sum_dl)


def assert_same_layout(ref, port):
    rl = [(s.name, s.ndocs, s.live_count) for s in segs(ref, True)]
    pl = [(s.name, s.ndocs, s.live_count) for s in segs(port, False)]
    assert rl == pl


def assert_same_responses(ref, port):
    for body in BODIES:
        assert_same_response(port.search("x", body), ref.search("x", body))
    lines = sum([[{}, b] for b in BODIES], [])
    for g, w in zip(port.msearch(lines, index="x")["responses"],
                    ref.msearch(lines, index="x")["responses"]):
        assert_same_response(g, w)


# ---------------------------------------------------------------------
# merge_sorted_runs
# ---------------------------------------------------------------------

@pytest.mark.parametrize("n", [3000, device_merge.DEVICE_MERGE_MIN + 777])
def test_merge_sorted_runs_matches_reference_and_lexsort(n):
    rng = np.random.default_rng(n)
    n_rows = 997
    # concatenated runs: per input, rows ascending and docs ascending
    # within a row, doc ranges disjoint across inputs, inputs in order
    parts = []
    base = 0
    for k in range(3):
        m = n // 3 + (n % 3 if k == 2 else 0)
        rows = np.sort(rng.integers(0, n_rows, m))
        docs = base + rng.integers(0, 5 * m, m)
        order = np.lexsort((docs, rows))
        parts.append((rows[order], docs[order]))
        base += 5 * m
    rows = np.concatenate([p[0] for p in parts]).astype(np.int64)
    docs = np.concatenate([p[1] for p in parts]).astype(np.int64)
    tfs = rng.integers(1, 9, n).astype(np.float32)
    assert device_merge.use_device_merge(n) \
        == ref_device_merge.use_device_merge(n)
    got = device_merge.merge_sorted_runs(rows, docs, tfs, n_rows, CPU)
    want = ref_device_merge.merge_sorted_runs(rows, docs, tfs, n_rows)
    for g, w, name in zip(got, want, ("rows", "docs", "tfs", "order",
                                      "counts")):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), name
    order = np.lexsort((docs, rows))
    np.testing.assert_array_equal(got[3], order)
    np.testing.assert_array_equal(got[0], rows[order])
    np.testing.assert_array_equal(got[1], docs[order])
    np.testing.assert_array_equal(got[2], tfs[order])
    np.testing.assert_array_equal(got[4], np.bincount(rows,
                                                      minlength=n_rows))


# ---------------------------------------------------------------------
# merged planes
# ---------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["1", "2"])
def test_merged_planes_match_reference(codec, monkeypatch):
    monkeypatch.setenv("OPENSEARCH_TPU_REORDER", "0")
    monkeypatch.setenv("OPENSEARCH_TPU_CODEC", codec)
    docs = make_docs(300, seed=1)
    run = write_script(docs, 3, deletes=range(0, 300, 11),
                       updates=range(5, 300, 37))
    ref, port = run(RefClient()), run(RestClient(device="cpu"))
    ref.indices.forcemerge("x")
    port.indices.forcemerge("x")
    assert_same_layout(ref, port)
    (rs,), (ps,) = segs(ref, True), segs(port, False)
    assert ps.ndocs == ps.live_count
    assert_same_planes(rs, ps)
    assert_same_responses(ref, port)


PHRASE_BODIES = [
    {"query": {"match_phrase": {"body": "w0 w1"}}},
    {"query": {"match_phrase": {"body": {"query": "w2 w0 w1", "slop": 3}}}},
    {"query": {"match_phrase_prefix": {"body": "w0 w1"}}, "size": 20},
    {"query": {"span_near": {"clauses": [{"span_term": {"body": "w1"}},
                                         {"span_term": {"body": "w0"}}],
                             "slop": 2, "in_order": True}}},
    {"query": {"bool": {"must": [{"match": {"body": "w3"}}],
                        "filter": [{"match_phrase": {"body": "w0 w2"}}]}}},
]


@pytest.mark.parametrize("device_sort", [False, True],
                         ids=["lexsort", "merge_sorted_runs"])
def test_merged_positions_match_reference(device_sort, monkeypatch):
    """Positions through a merge with deletes and updates: dropped with
    their docs, regathered in the sort's order (np.lexsort below
    DEVICE_MERGE_MIN, merge_sorted_runs' order at and above it), equal to
    the reference's; phrase pages on the merged segment equal too."""
    monkeypatch.setenv("OPENSEARCH_TPU_REORDER", "0")
    if device_sort:
        monkeypatch.setattr(device_merge, "DEVICE_MERGE_MIN", 64)
        monkeypatch.setattr(ref_device_merge, "DEVICE_MERGE_MIN", 64)
    docs = make_docs(240, seed=6)
    run = write_script(docs, 3, deletes=range(1, 240, 7),
                       updates=range(3, 240, 29))
    ref, port = run(RefClient()), run(RestClient(device="cpu"))
    ref.indices.forcemerge("x")
    port.indices.forcemerge("x")
    (rs,), (ps,) = segs(ref, True), segs(port, False)
    assert ps.postings["body"].pos_starts is not None
    assert ps.postings["tag"].positions.size == 0
    assert_same_planes(rs, ps)
    assert merge.LAST_MERGE["positions_s"] >= 0.0
    for body in PHRASE_BODIES:
        assert_same_response(port.search("x", body), ref.search("x", body))


def test_ranges_gather_matches_a_python_loop():
    rng = np.random.default_rng(8)
    starts = rng.integers(0, 1000, 50)
    lens = rng.integers(0, 6, 50)
    want = [s + j for s, n in zip(starts, lens) for j in range(n)]
    np.testing.assert_array_equal(merge.ranges_gather(starts, lens), want)
    assert merge.ranges_gather(starts[:0], lens[:0]).size == 0


def test_merged_segment_serves_through_the_kernels():
    """Deletes send a segment to the impact rung; once merged, the fast
    path serves it again (on the CPU the kernel wrappers count their plain
    versions' calls)."""
    docs = make_docs(240, seed=2)
    port = write_script(docs, 2, deletes=range(0, 240, 5))(
        RestClient(device="cpu"))
    body = {"query": {"match": {"body": "w0 w3"}}}
    for merged in (False, True):
        if merged:
            port.indices.forcemerge("x")
        bm25.reset_counts()
        impactpath.reset_stats()
        C.reset_stats()
        port.search("x", body)
        assert (impactpath.STATS["served"] > 0) is not merged
        assert (bm25.COUNTS["plain_calls"] > 0) is merged
        assert C.STATS["general_served"] == 0


def test_merge_releases_the_replaced_segments_device_state():
    docs = make_docs(200, seed=3)
    port = write_script(docs, 2, deletes=range(0, 200, 9))(
        RestClient(device="cpu"))
    eng = port._indices["x"].engine
    aggs = {"size": 0, "aggs": {
        "d": {"date_histogram": {"field": "n", "calendar_interval": "day"}},
        "c": {"cardinality": {"field": "tag"}}}}
    for body in BODIES + PHRASE_BODIES + [aggs]:
        port.search("x", body)
    old = list(eng.segments)
    assert any(s.aligned or s.device_arrays for s in old)
    assert any("phrase_pairs" in s.__dict__ for s in old)
    assert any(k[0] == "pairs" for s in old for k in s.device_arrays)
    assert all("date_buckets" in s.__dict__ and "kw_hashes" in s.__dict__
               for s in old)
    assert any(k[0] == "dbuckets" for s in old for k in s.device_arrays)
    port.indices.forcemerge("x")
    assert all(not s.aligned and not s.device_arrays
               and "filter_lists" not in s.__dict__
               and "phrase_pairs" not in s.__dict__
               and "date_buckets" not in s.__dict__
               and "kw_hashes" not in s.__dict__ for s in old)
    assert "_shard_view" not in eng.__dict__


def test_lazy_ids_stay_lazy_across_a_merge():
    """A segment attached with the bench corpus's lazy ids and sources
    merges with a refreshed one into views, not lists; `_id` lookups,
    gets and deletes reach the merged copies."""
    corpus = bench_corpus.build_corpus(3000)
    c = RestClient(device="cpu")
    seg = bench_corpus.make_index(c, corpus)
    eng = c._indices["bench"].engine
    c.delete("bench", "17")
    c.index("bench", {"body": "t0000001 t0000002"}, id="new", refresh=True)
    c.index("bench", {"body": "t0000003"}, id="5", refresh=True)
    c.indices.forcemerge("bench")
    (m,) = eng.segments
    assert isinstance(m.ids, merge.MergedView) and m.id2doc == {}
    assert m.ndocs == m.live_count == seg.ndocs
    # 5 and 17 compacted away; then the two refreshed docs
    assert m.ids[15] == "16" and m.ids[16] == "18"
    assert m.sources[16] == {"doc": 18}
    assert m.local_doc("18") == 16 and m.local_doc("17") == -1
    assert m.local_doc("new") == seg.ndocs - 2
    assert m.local_doc("5") == seg.ndocs - 1
    assert c.get("bench", "5")["_source"] == {"body": "t0000003"}
    assert c.get("bench", "18")["_source"] == {"doc": 18}
    assert not c.exists("bench", "17")
    assert c.delete("bench", "18")["result"] == "deleted"
    assert not m.live[16]


def test_unported_planes_raise():
    """A reference segment's term vectors, which no port segment builds,
    refuse a merge (nested blocks merge since nested objects were
    ported)."""
    docs = make_docs(40, seed=4)
    port = write_script(docs, 2)(RestClient(device="cpu"))
    s0, s1 = segs(port, False)
    s1.term_vectors = {"body": object()}
    with pytest.raises(NotPortedError, match="term_vectors"):
        merge.merge_segments("_m", [s0, s1])


# ---------------------------------------------------------------------
# the tiered policy and the engine's merges
# ---------------------------------------------------------------------

class _Seg:
    def __init__(self, ndocs, live):
        self.ndocs = ndocs
        self.live_count = live


@pytest.mark.parametrize("seed", range(4))
def test_tiered_policy_picks_the_reference_groups(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 14))
    fakes = []
    for _ in range(n):
        nd = int(rng.integers(0, 50))
        fakes.append(_Seg(nd, int(rng.integers(0, nd + 1))))
    for mx in (1 << 24, 30):
        got = merge.TieredMergePolicy(8, mx).find_merges(list(fakes))
        want = ref_merge.TieredMergePolicy(8, mx).find_merges(list(fakes))
        assert [[id(s) for s in g] for g in got] \
            == [[id(s) for s in g] for g in want]


def test_eighth_refresh_merges_as_the_reference(monkeypatch):
    monkeypatch.setenv("OPENSEARCH_TPU_REORDER", "0")
    docs = make_docs(360, seed=5)
    run = write_script(docs, 9, deletes=range(3, 360, 17))
    ref, port = run(RefClient()), run(RestClient(device="cpu"))
    assert_same_layout(ref, port)
    assert segs(port, False)[0].name == "_m8"
    for rs, ps in zip(segs(ref, True), segs(port, False)):
        assert_same_planes(rs, ps)
    assert_same_responses(ref, port)


def test_mostly_deleted_segment_merges_alone(monkeypatch):
    monkeypatch.setenv("OPENSEARCH_TPU_REORDER", "0")
    docs = make_docs(200, seed=6)
    run = write_script(docs, 2, deletes=range(0, 80),
                       updates=range(150, 160))
    ref, port = run(RefClient()), run(RestClient(device="cpu"))
    assert_same_layout(ref, port)
    assert any(s.name.startswith("_m") for s in segs(port, False))
    for rs, ps in zip(segs(ref, True), segs(port, False)):
        assert_same_planes(rs, ps)
    assert_same_responses(ref, port)


def _page(resp) -> list:
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]


# (seed, every k-th doc joins one exact-score tie, L_HEAD of both
# packages: 64, so that heads and their ties matter at this size, or the
# default)
REORDER_CASES = [(s, 4, 64) for s in range(7, 11)] \
    + [(s, 2, None) for s in range(7, 11)]
REORDER_BODIES = BODIES + [
    {"query": {"term": {"tag": f"t{j}"}}, "size": n}
    for j in range(5) for n in (10, 40)] + [
    {"query": {"match": {"body": "tie"}}, "size": 30},
    {"query": {"match": {"body": "w1 tie"}}, "from": 20, "size": 15},
    {"query": {"match": {"body": "tie"}}, "track_total_hits": True,
     "size": 50}]


@pytest.mark.parametrize("seed,every,l_head", REORDER_CASES)
def test_merge_refuses_where_the_reference_reorders(monkeypatch, seed,
                                                    every, l_head):
    """The reference's BP doc-id reorder (engaged at 256 docs here)
    changes served pages: on bodies of every case its page with the
    reorder on differs from its page with the reorder off, and from the
    exact page. The port has no reorder, so the forcemerge that the
    reference reorders raises NotPortedError("BP reorder") and leaves
    the segments as they were; with OPENSEARCH_TPU_REORDER=0 both merge
    in concatenation order and serve equal pages and totals, which are
    the exact pages."""
    if l_head is not None:
        for mod in (rfp, fastpath):
            monkeypatch.setattr(mod, "L_HEAD", l_head)
    monkeypatch.setattr(rfp, "_backend_ok", True)
    monkeypatch.setattr(rfp, "fused_bm25_topk_tfdl", _plain_tfdl)
    monkeypatch.setattr(rfp, "fused_bm25_topk_impact", _plain_impact)
    monkeypatch.setattr(rfp, "fused_bm25_bool_topk", _plain_bool)
    monkeypatch.setenv("OPENSEARCH_TPU_REORDER_MIN_DOCS", "256")
    monkeypatch.setattr(merge, "REORDER_MIN_DOCS", 256)
    docs = make_docs(900, seed=seed)
    for i in range(0, 900, every):
        docs[i]["body"] = "tie w1 w2"        # a large exact-score tie
    run = write_script(docs, 3, deletes=range(1, 900, 13),
                       updates=range(2, 900, 41))
    refs = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("OPENSEARCH_TPU_REORDER", flag)
        refs[flag] = run(RefClient())
        refs[flag].indices.forcemerge("x")
    assert any(s.__dict__.get("_reordered") for s in segs(refs["1"], True))
    monkeypatch.setenv("OPENSEARCH_TPU_REORDER", "1")
    port = run(RestClient(device="cpu"))
    before = [(s.name, s.live_count) for s in segs(port, False)]
    with pytest.raises(NotPortedError, match="BP reorder"):
        port.indices.forcemerge("x")
    assert [(s.name, s.live_count) for s in segs(port, False)] == before
    monkeypatch.setenv("OPENSEARCH_TPU_REORDER", "0")
    port.indices.forcemerge("x")
    assert len(segs(port, False)) == 1
    changed = []
    for body in REORDER_BODIES:
        got, off = port.search("x", body), refs["0"].search("x", body)
        assert _page(got) == _page(off), body
        assert got["hits"]["total"] == off["hits"]["total"], body
        exact = port.search("x", dict(body, track_total_hits=True))
        assert _page(got) == _page(exact), body
        on = refs["1"].search("x", body)
        if _page(on) != _page(off):
            assert _page(on) != _page(exact), body
            changed.append(body)
    assert changed
    lines = sum([[{}, b] for b in REORDER_BODIES], [])
    for g, w in zip(port.msearch(lines, index="x")["responses"],
                    refs["0"].msearch(lines, index="x")["responses"]):
        assert _page(g) == _page(w) and g["hits"]["total"] \
            == w["hits"]["total"]


@pytest.mark.parametrize("how", ["tiered", "lone"])
def test_reorder_sized_merges_raise_and_keep_serving(monkeypatch, how):
    """A tiered merge (the 8th refresh) or a lone segment's forcemerge
    that the reference would reorder raises NotPortedError("BP reorder");
    the published segments keep serving the reference's responses with
    its reorder off."""
    monkeypatch.setattr(merge, "REORDER_MIN_DOCS", 64)
    docs = make_docs(360, seed=11)
    rounds = 8 if how == "tiered" else 1
    per = len(docs) // rounds

    def run(c):
        c.indices.create("x", MAPPING)
        for r in range(rounds):
            c.bulk(sum([[{"index": {"_index": "x", "_id": f"d{i}"}},
                         docs[i]] for i in range(r * per, (r + 1) * per)],
                       []), refresh=True)
        return c

    monkeypatch.setenv("OPENSEARCH_TPU_REORDER", "0")
    ref = run(RefClient())
    monkeypatch.setenv("OPENSEARCH_TPU_REORDER", "1")
    port = RestClient(device="cpu")
    with pytest.raises(NotPortedError, match="BP reorder"):
        run(port)                       # the 8th refresh's merge
        port.indices.forcemerge("x")    # a lone segment
    assert [s.live_count for s in segs(port, False)] == [per] * rounds
    for body in BODIES:
        assert_same_response(port.search("x", body), ref.search("x", body))
