"""Codec-v2 state of the port (opensearch_tpu_torch/index/segment.py impact
planes, ops/device_merge.py, the fastpath's aligned layout with heads and
frontiers) against the JAX package on the CPU.

Tolerances: everything here is exact. The impact planes, their scales and
sidecars are byte-equal; the error bounds are equal as floats; with
L_HEAD = 64 in both packages the aligned buffers (docs, tf.dl, impacts,
head regions), head lengths, remainder frontiers and head ids are
byte-equal. One stated exception: above DEVICE_IMPACT_MIN postings the
reference quantizes with its jitted XLA program, and XLA on the CPU
contracts `tfs + k1 * x` into a fused multiply-add, which the source does
not write. On the 20,000-passage bench corpus (889,943 postings) that moves
57 of the q by exactly 1 (54 down, 3 up) against the port, whose torch
ops round every operation as written; the port's q equal a numpy f32
evaluation of the source's expression bit for bit, and the scales are
equal.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from opensearch_tpu.index import segment as ref_segment
from opensearch_tpu.ops import device_merge as ref_device_merge
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu.search import fastpath as ref_fastpath
from opensearch_tpu.search import impactpath as ref_impactpath
from opensearch_tpu_torch import RestClient, bench_corpus
from opensearch_tpu_torch.index import segment
from opensearch_tpu_torch.ops import device_merge
from opensearch_tpu_torch.search import fastpath, impactpath

jax.config.update("jax_platforms", "cpu")

MAPPING = {"settings": {"number_of_replicas": 0},
           "mappings": {"properties": {"body": {"type": "text"}}}}
PLANE_ARRAYS = ("q", "block_starts", "block_off", "block_max")
PLANE_SCALARS = ("scale", "bits", "k1", "b", "avgdl", "dl_max")


@pytest.fixture(scope="module")
def segments():
    """The same 400 documents refreshed into one v2 segment by each
    package."""
    rng = np.random.default_rng(3)
    docs, _words = chip_smoke.make_text_corpus(rng, 400)
    bulk = []
    for i, d in enumerate(docs):
        bulk += [{"index": {"_index": "t", "_id": f"d{i}"}}, d]
    ref, port = RefClient(), RestClient(device="cpu")
    for c in (ref, port):
        c.indices.create("t", MAPPING)
        c.bulk(bulk, refresh=True)
    rseg = ref.node.indices["t"].shards[0].segments[0]
    pseg = port._indices["t"].engine.segments[0]
    assert rseg.codec_version == pseg.codec_version == 2
    return rseg, pseg


def assert_same_plane(p, r):
    for a in PLANE_ARRAYS:
        g, w = getattr(p, a), getattr(r, a)
        assert g.dtype == w.dtype, a
        assert g.tobytes() == w.tobytes(), a
    for a in PLANE_SCALARS:
        assert getattr(p, a) == getattr(r, a), a


def test_refresh_builds_the_reference_planes(segments):
    rseg, pseg = segments
    assert set(rseg.postings) == set(pseg.postings)
    n_planes = 0
    for f, rb in rseg.postings.items():
        pb = pseg.postings[f]
        assert (rb.impact is None) == (pb.impact is None), f
        if rb.impact is not None:
            assert rb.impact.q.size < ref_device_merge.DEVICE_IMPACT_MIN
            assert rb.impact.kind == "bm25"     # the port's only kind
            assert_same_plane(pb.impact, rb.impact)
            n_planes += 1
    assert n_planes >= 1


def test_device_quantizer_matches_reference():
    """Above DEVICE_IMPACT_MIN both packages take their device quantizer:
    the reference's jitted XLA program, the port's torch ops."""
    starts, doc_ids, tfs, dl, _df = bench_corpus.build_corpus(20_000)
    assert len(doc_ids) >= device_merge.DEVICE_IMPACT_MIN
    assert device_merge.DEVICE_IMPACT_MIN == ref_device_merge.DEVICE_IMPACT_MIN
    vocab = bench_corpus.vocab_strings(len(starts) - 1)
    avgdl = float(dl.sum()) / len(dl)
    planes = []
    for mod in (ref_segment, segment):
        pb = mod.PostingsBlock("body", vocab, {}, starts, doc_ids, tfs)
        planes.append(mod.build_impact_plane(pb, dl, avgdl=avgdl))
    r, p = planes
    assert p.bits == r.bits == 16
    assert len(doc_ids) == 889_943
    diff = p.q.astype(np.int64) - r.q.astype(np.int64)
    assert int(np.count_nonzero(diff)) == 57
    assert int((diff == -1).sum()) == 54 and int((diff == 1).sum()) == 3
    # the port rounds every operation of the source's expression: numpy f32
    tf = tfs.astype(np.float32)
    x = np.float32(0.25) + np.float32(0.75) * dl[doc_ids].astype(
        np.float32) / np.float32(avgdl)
    imp = tf / (tf + np.float32(1.2) * x)
    want = np.minimum(np.round(imp / np.float32(p.scale)), 65535)
    np.testing.assert_array_equal(p.q, want.astype(np.uint16))
    assert p.scale == r.scale
    for a in PLANE_SCALARS:
        assert getattr(p, a) == getattr(r, a), a
    for a in ("block_starts", "block_off"):
        assert getattr(p, a).tobytes() == getattr(r, a).tobytes(), a


def test_eight_bit_planes_match(segments, monkeypatch):
    rseg, pseg = segments
    monkeypatch.setenv("OPENSEARCH_TPU_IMPACT_BITS", "8")
    assert ref_segment.default_impact_bits() == 8
    assert segment.default_impact_bits() == 8
    rb, pb = rseg.postings["body"], pseg.postings["body"]
    st = pseg.text_stats["body"]
    r = ref_segment.build_impact_plane(rb, rseg.doc_lens["body"],
                                       avgdl=st.sum_dl / st.doc_count)
    p = segment.build_impact_plane(pb, pseg.doc_lens["body"],
                                   avgdl=st.sum_dl / st.doc_count)
    assert p.q.dtype == np.uint8 and int(p.q.max()) == 255
    assert_same_plane(p, r)


@pytest.mark.parametrize("k1,b,avg", [(1.2, 0.75, None), (0.9, 0.4, 31.5),
                                      (2.0, 0.0, 1.0), (1.2, 0.75, 80.0)])
def test_error_bounds_match(segments, k1, b, avg):
    rseg, pseg = segments
    r, p = rseg.postings["body"].impact, pseg.postings["body"].impact
    avg = r.avgdl if avg is None else avg
    assert p.quant_err() == r.quant_err()
    assert p.drift_bound(k1, b, avg) == r.drift_bound(k1, b, avg)
    weights = np.array([1.5, 0.3, 2.25, 0.0], np.float32)
    rows = np.array([3, -1, 17, 40], np.int64)
    assert impactpath._error_bound(p, weights, rows, k1, b, avg) \
        == ref_impactpath._error_bound(r, weights, rows, k1, b, avg)


def _sorted_head_select(doc_ids, tfs, dl_of, lh, imp):
    """The head selection written as sorts: a stable sort by descending
    impact keeps the first lh, a lexsort by (tf, dl, id) of the rest
    gives each tf class's first posting."""
    tf, dlf = tfs.astype(np.float32), dl_of.astype(np.float32)
    order = np.argsort(-imp, kind="stable")
    keep, rest = np.sort(order[:lh]), order[lh:]
    if len(rest) == 0:
        return keep, fastpath._frontier(tf[rest], dlf[rest], doc_ids[rest])
    t = tf[rest].astype(np.int64)
    o = np.lexsort((doc_ids[rest], dlf[rest], t))
    t_s, id_s = t[o], doc_ids[rest][o].astype(np.int64)
    first = np.flatnonzero(np.concatenate(([True], t_s[1:] != t_s[:-1])))
    return keep, (t_s[first].astype(np.float32), dlf[rest][o][first],
                  id_s[first], np.minimum.reduceat(id_s, first))


@pytest.mark.parametrize("seed", range(6))
def test_head_select_matches_its_sort_formulation(seed):
    """_head_select and _frontier (a partition and one radix sort by tf)
    equal the sorts they stand for, byte for byte, over rows of heavy
    impact, tf and doc-length ties."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n = int(rng.integers(1, 4000))
        tfs = rng.integers(1, int(rng.integers(2, 40)), n).astype(np.float32)
        dls = rng.integers(1, int(rng.integers(2, 300)), n)
        ids = np.sort(rng.choice(1 << 20, n, replace=False)).astype(np.int32)
        imp = rng.integers(0, int(rng.integers(1, 50)), n) * 0.01
        lh = int(rng.integers(1, 300))
        got = fastpath._head_select(ids, tfs, dls, l_head=lh, imp=imp)
        want = _sorted_head_select(ids, tfs, dls, lh, imp)
        assert got[0].tobytes() == want[0].tobytes()
        for g, w in zip(got[1], want[1]):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_heads_and_frontiers_match(segments, monkeypatch):
    rseg, pseg = segments
    monkeypatch.setattr(ref_fastpath, "L_HEAD", 64)
    monkeypatch.setattr(fastpath, "L_HEAD", 64)
    rseg.__dict__.pop("_fastpath_aligned", None)
    pseg.aligned = {}
    ra = ref_fastpath.get_aligned(rseg, "body")
    pa = fastpath.get_aligned(pseg, "body", torch.device("cpu"))
    rseg.__dict__.pop("_fastpath_aligned", None)
    pseg.aligned = {}
    assert len(pa.rem_frontiers) >= 5, "L_HEAD = 64 must clamp some rows"
    for a in ("starts_rows", "lens", "head_starts_rows", "head_lens"):
        np.testing.assert_array_equal(getattr(pa, a), getattr(ra, a),
                                      err_msg=a)
    for a in ("d_docs", "d_tfdl", "d_imp"):
        assert getattr(pa, a).numpy().tobytes() \
            == np.asarray(getattr(ra, a)).tobytes(), a
    assert sorted(pa.rem_frontiers) == sorted(ra.rem_frontiers)
    for row, rfr in ra.rem_frontiers.items():
        pfr = pa.rem_frontiers[row]
        assert len(pfr) == len(rfr) == 4
        for g, w in zip(pfr, rfr):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), row
        np.testing.assert_array_equal(pa.head_ids[row], ra.head_ids[row])


def test_feature_planes_are_not_ported(segments):
    """Feature planes are ported: a field named in `feature_fields` that
    the segment lacks builds nothing (the body's plane stays), and a
    rank_features field with index_impacts gets the reference's FEATURE
    plane at a refresh."""
    _rseg, pseg = segments
    plane = pseg.postings["body"].impact
    pseg.build_impacts(feature_fields=["tags"])
    assert pseg.postings["body"].impact is plane and "tags" not in \
        pseg.postings
    rng = np.random.default_rng(4)
    mapping = {"settings": {"number_of_replicas": 0}, "mappings": {
        "properties": {"emb": {"type": "rank_features",
                               "index_impacts": True}}}}
    docs = [{"emb": {f"t{j}": round(float(rng.exponential()) + 0.05, 3)
                     for j in rng.choice(60, 6)}} for _ in range(300)]
    segs = []
    for c in (RefClient(), RestClient(device="cpu")):
        c.indices.create("f", mapping)
        c.bulk(sum([[{"index": {"_index": "f", "_id": str(i)}}, d]
                    for i, d in enumerate(docs)], []), refresh=True)
        segs.append((c.node.indices["f"].shards[0].segments[0]
                     if isinstance(c, RefClient)
                     else c._indices["f"].engine.segments[0]))
    rp, pp = (s.postings["emb"].impact for s in segs)
    assert pp.kind == rp.kind == "feature"
    assert_same_plane(pp, rp)


def test_drop_impacts_demotes_to_v1(segments):
    _rseg, pseg = segments
    plane = pseg.postings["body"].impact
    try:
        pseg.drop_impacts()
        assert pseg.codec_version == segment.CODEC_V1
        assert pseg.postings["body"].impact is None
        pseg.build_impacts()
        assert pseg.codec_version == segment.CODEC_V2
        assert_same_plane(pseg.postings["body"].impact, plane)
    finally:
        pseg.aligned = {}
