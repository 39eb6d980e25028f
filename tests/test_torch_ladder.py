"""The port's pruned match ladder (opensearch_tpu_torch/search/fastpath.py:
impact heads -> frontier pass -> verify -> candidate-union rescore ->
quality tier -> dense) against the JAX package's fastpath on the CPU, per
query and end to end through RestClient.search / msearch.

The JAX fastpath is forced on as its own tests force it
(`_backend_ok = True`, tests/test_pruned.py), with L_HEAD = 64 and
QUALITY_MIN_NDOCS = 2048 in both packages so a few thousand documents
reach every rung. Its TPU kernels are stood in for, as its own tests stand
numpy simulators in; here the stand-ins are the port's plain kernels
(`fused_bm25_topk_tfdl_plain`, `fused_bm25_topk_impact_plain`), which
tests/test_torch_bm25_kernel.py and tests/test_torch_bm25_impact.py hold
to the Pallas kernels in interpret mode. Both ladders then read the same
frontier partials, so what is compared is the host ladder itself: its
heads, frontiers, bounds, rescores and decisions. Tolerances:
- the rung each query reaches (the pruned_* counters): identical;
- ids in order, total and total relation: identical;
- scores: bit-equal on every rung (verify, rescue and quality-tier pages
  come from the host oracle and from the same plain kernel; dense pages
  from the same plain kernel);
- end-to-end responses: equal apart from `took`.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from opensearch_tpu.index.engine import Engine as RefEngine
from opensearch_tpu.index.mappings import Mappings as RefMappings
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu.search import compiler as RC
from opensearch_tpu.search import fastpath as rfp
from opensearch_tpu.search import query_dsl as rdsl
from opensearch_tpu.search.executor import ShardSearcher as RefSearcher
from opensearch_tpu_torch import RestClient
from opensearch_tpu_torch.index.engine import Engine
from opensearch_tpu_torch.index.mappings import Mappings
from opensearch_tpu_torch.ops import bm25
from opensearch_tpu_torch.search import compiler as C
from opensearch_tpu_torch.search import fastpath
from opensearch_tpu_torch.search import query_dsl as dsl
from opensearch_tpu_torch.search.executor import ShardSearcher

jax.config.update("jax_platforms", "cpu")

CPU = torch.device("cpu")
RUNGS = ("pruned_served", "pruned_rescued", "pruned_rescued2",
         "pruned_dview", "pruned_escalated")
MAPPING = {"properties": {"body": {"type": "text"}}}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _plain_tfdl(docs, tfdl, rowstarts, nrows, lens, skips, weights, msm,
                avgdl, dlo, dhi, T, L, K, k1, b):
    out = bm25.fused_bm25_topk_tfdl_plain(
        *[_t(a) for a in (docs, tfdl, rowstarts, nrows, lens, skips,
                          weights, msm, avgdl, dlo, dhi)],
        T=T, L=L, K=K, k1=k1, b=b)
    return tuple(o.numpy() for o in out)


def _plain_impact(docs, imp, rowstarts, nrows, lens, skips, weights, msm,
                  dlo, dhi, T, L, K):
    out = bm25.fused_bm25_topk_impact_plain(
        *[_t(a) for a in (docs, imp, rowstarts, nrows, lens, skips,
                          weights, msm, dlo, dhi)], T=T, L=L, K=K)
    return tuple(o.numpy() for o in out)


@pytest.fixture()
def ladder(monkeypatch):
    for mod in (rfp, fastpath):
        monkeypatch.setattr(mod, "L_HEAD", 64)
        monkeypatch.setattr(mod, "QUALITY_MIN_NDOCS", 2048)
    monkeypatch.setattr(rfp, "_backend_ok", True)
    monkeypatch.setattr(rfp, "fused_bm25_topk_tfdl", _plain_tfdl)
    monkeypatch.setattr(rfp, "fused_bm25_topk_impact", _plain_impact)
    # record every boundary-tie witness call and its answer, per package
    ties = {"ref": [], "port": []}
    for name, mod in (("ref", rfp), ("port", fastpath)):
        real = mod._tie_serves

        def spy(*a, _real=real, _log=ties[name]):
            _log.append(bool(_real(*a)))
            return _log[-1]
        monkeypatch.setattr(mod, "_tie_serves", spy)
    return ties


def _engines(texts):
    """One segment of `texts` in each package (built after the ladder
    fixture, so the heads use its L_HEAD)."""
    reng = RefEngine(RefMappings(MAPPING))
    peng = Engine(Mappings(MAPPING), device=CPU)
    for eng in (reng, peng):
        for i, t in enumerate(texts):
            eng.index_doc(str(i), {"body": t})
        eng.refresh()
    return ((reng.segments[0], RefSearcher(reng).context()),
            (peng.segments[0], ShardSearcher(peng, CPU).context()))


def pruned_corpus():
    """tests/test_pruned.py's corpus: 5,000 docs, seed 11."""
    rng = np.random.default_rng(11)
    texts = []
    for _ in range(5000):
        parts = []
        if rng.random() < 0.7:
            parts.extend(["common"] * int(rng.integers(1, 5)))
        if rng.random() < 0.5:
            parts.append("half%d" % int(rng.integers(0, 2)))
        parts.append(f"rare{int(rng.integers(0, 300))}")
        parts.extend(f"pad{int(x)}" for x in rng.integers(0, 1000, 3))
        texts.append(" ".join(parts))
    return texts


def dview_corpus():
    """tests/test_pruned.py's quality-tier corpus: 512 short high-impact
    docs among 3,584 long tf=1 docs (4,096 docs, seed 21)."""
    rng = np.random.default_rng(21)
    texts = []
    for i in range(4096):
        if i % 8 == 0:
            texts.append("common common common w1")
        else:
            texts.append("common " + " ".join(
                rng.choice([f"f{j}" for j in range(50)], 14)))
    return texts


def run_both(ref_side, port_side, query, window, body=None):
    """One query through both fastpaths: -> (rung deltas, outputs)."""
    (rseg, rctx), (pseg, pctx) = ref_side, port_side
    body = body or {}
    rspec = rfp.make_spec(RC.rewrite(rdsl.parse_query(query), rctx,
                                     scoring=True),
                          [], [], [], None, window, body)
    before = dict(rfp.STATS)
    rout = rfp.batch_search(rseg, rctx, [rspec], window)[0]
    rd = {k: rfp.STATS[k] - before[k] for k in RUNGS}
    pspec = fastpath.make_spec(C.rewrite(dsl.parse_query(query), pctx),
                               window, body)
    assert pspec.prune_ok == rspec.prune_ok
    fastpath.reset_stats()
    pout = fastpath.batch_search(pseg, pctx, [pspec], window, CPU)[0]
    pd = {k: fastpath.STATS[k] for k in RUNGS}
    return rd, pd, rout, pout


def assert_same_output(pout, rout):
    assert pout["total"] == rout["total"]
    assert pout["total_rel"] == rout["total_rel"]
    np.testing.assert_array_equal(pout["topk_idx"], rout["topk_idx"])
    assert pout["topk_scores"].tobytes() \
        == np.asarray(rout["topk_scores"], np.float32).tobytes()


PRUNED_QUERIES = [
    ({"match": {"body": "common"}}, 10, None),                # clamped 1-term
    ({"match": {"body": "common"}}, 100, None),               # deep window
    ({"match": {"body": "common rare7"}}, 10, None),          # mixed df
    ({"match": {"body": "rare3 rare9"}}, 10, None),           # unclamped
    ({"match": {"body": "common half0"}}, 20, None),
    ({"match": {"body": "common half0 half1"}}, 100, None),
    ({"match": {"body": {"query": "common half1",
                         "operator": "and"}}}, 10, None),
    ({"match": {"body": {"query": "common half0 rare2",
                         "minimum_should_match": 2}}}, 10, None),  # msm > 1
    ({"match": {"body": {"query": "common half1",
                         "boost": -1.0}}}, 10, None),     # B1 frontier
    ({"term": {"body": "half0"}}, 10, None),
    ({"match": {"body": "common half0"}}, 10,
     {"track_total_hits": True}),                            # dense
    ({"match": {"body": "pad7 pad9 common"}}, 100, None),
]


def test_ladder_matches_reference_per_query(ladder):
    ref_side, port_side = _engines(pruned_corpus())
    seen = {k: 0 for k in RUNGS}
    impact = 0
    for query, window, body in PRUNED_QUERIES:
        fastpath.reset_stats()
        rd, pd, rout, pout = run_both(ref_side, port_side, query, window,
                                      body)
        assert pd == rd, (query, window)
        assert_same_output(pout, rout)
        impact += fastpath.STATS["impact_frontier"]
        for k, v in pd.items():
            seen[k] += v
    assert impact > 0
    # every rung before the quality tier serves some query here
    for k in ("pruned_served", "pruned_rescued", "pruned_escalated"):
        assert seen[k] > 0, seen
    assert ladder["port"] == ladder["ref"]


def test_ladder_matches_reference_on_codec_v1(ladder, monkeypatch):
    """Codec v1: every frontier pass rides the exact tf.dl kernel, and a
    single clamped term reaches the boundary-tie witness."""
    monkeypatch.setenv("OPENSEARCH_TPU_CODEC", "1")
    ref_side, port_side = _engines(pruned_corpus())
    assert ref_side[0].codec_version == port_side[0].codec_version == 1
    for query, window, body in PRUNED_QUERIES[:6]:
        rd, pd, rout, pout = run_both(ref_side, port_side, query, window,
                                      body)
        assert pd == rd, (query, window)
        assert_same_output(pout, rout)
        assert fastpath.STATS["impact_frontier"] == 0
    assert ladder["ref"], "no query reached the tie witness"
    assert ladder["port"] == ladder["ref"]


def test_quality_tier_matches_reference(ladder):
    ref_side, port_side = _engines(dview_corpus())
    for query, window in (({"match": {"body": "common w1"}}, 64),
                          ({"match": {"body": "common w1"}}, 10),
                          ({"match": {"body": "w1 f3"}}, 100)):
        rd, pd, rout, pout = run_both(ref_side, port_side, query, window)
        assert pd == rd, (query, window)
        assert_same_output(pout, rout)
    rd, pd, rout, pout = run_both(ref_side, port_side,
                                  {"match": {"body": "common w1"}}, 64)
    assert pd["pruned_dview"] == 1 and rout["total_rel"] == "gte"


# ---------------------------------------------------------------------
# end to end: RestClient.search and msearch of both packages
# ---------------------------------------------------------------------

def strip_took(r):
    return chip_smoke.strip_took(r)


@pytest.fixture(scope="module")
def e2e_corpus():
    rng = np.random.default_rng(2)
    docs, words = chip_smoke.make_text_corpus(rng, 1600)
    bodies = chip_smoke.slice_queries(rng, words)[:24]
    bodies += [
        {"query": {"match": {"body": "the of and"}}, "size": 100},
        {"query": {"match": {"body": "the"}}, "size": 10},
        {"query": {"match": {"body": f"the {words[0]}"}},
         "track_total_hits": True},
        {"query": {"match": {"body": f"{words[0]} {words[1]}"}},
         "track_total_hits": 50},
        {"query": {"match": {"body": {"query": "of a",
                                      "boost": -2.0}}}},
        {"query": {"match": {"body": {"query": f"the {words[2]} a",
                                      "minimum_should_match": 2}}},
         "size": 20},
    ]
    bulk = []
    for i, d in enumerate(docs):
        bulk += [{"index": {"_index": "t", "_id": f"d{i}"}}, d]
    return bulk, bodies


@pytest.mark.parametrize("nseg", [1, 2])
def test_rest_search_and_msearch_match_reference(ladder, e2e_corpus, nseg):
    bulk, bodies = e2e_corpus
    ref, port = RefClient(), RestClient(device="cpu")
    cut = len(bulk) // 2 if nseg == 2 else len(bulk)
    for c in (ref, port):
        c.indices.create("t", {"settings": {"number_of_replicas": 0},
                               "mappings": MAPPING})
        c.bulk(bulk[:cut], refresh=True)
        if cut < len(bulk):
            c.bulk(bulk[cut:], refresh=True)
    assert len(port._indices["t"].engine.segments) == nseg
    fastpath.reset_stats()
    rels = set()
    for body in bodies:
        want = ref.search("t", body)
        got = port.search("t", body)
        assert strip_took(got) == strip_took(want), body
        rels.add(got["hits"]["total"]["relation"])
    assert rels == {"eq", "gte"}
    assert (fastpath.STATS["shard_view_served"] > 0) == (nseg == 2)
    lines = []
    for body in bodies:
        lines += [{}, body]
    want = ref.msearch(lines, index="t")["responses"]
    got = port.msearch(lines, index="t")["responses"]
    assert len(got) == len(want) == len(bodies)
    for g, w, body in zip(got, want, bodies):
        assert strip_took(g) == strip_took(w), body
