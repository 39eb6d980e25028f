"""The port's codec-v2 impact rung (opensearch_tpu_torch/search/
impactpath.py: block planning, the device first pass, the host
certificate, the phase-2 union, escalation) against the JAX package's
`impactpath` on the CPU, per query over the same segment.

Both packages refresh the same bulk into codec-v2 segments, then
re-index a few `_id`s, so the searched segment has deleted docs (the live
mask in the device pass and in the phase-2 union). Per query the two
`segment_search` calls must reach the same rung (served, pruned served,
phase 2, escalated) and return the same page: ids, scores bit for bit
(both serve the host oracle's f32 domain), total and relation. The device
pass itself (`impact_program`) must equal the reference's jitted
`build_impact_program` bit for bit: the port sums each doc's impacts term
by term, the order XLA's scatter-add applies them on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu.search import compiler as RC
from opensearch_tpu.search import impactpath as rip
from opensearch_tpu.search import query_dsl as rdsl
from opensearch_tpu.search.executor import ShardSearcher as RefSearcher
from opensearch_tpu_torch import RestClient
from opensearch_tpu_torch.search import compiler as C
from opensearch_tpu_torch.search import impactpath
from opensearch_tpu_torch.search import query_dsl as dsl

jax.config.update("jax_platforms", "cpu")

CPU = torch.device("cpu")
RUNGS = ("served", "pruned_served", "phase2_served", "escalated")
MAPPING = {"mappings": {"properties": {"body": {"type": "text"}}}}


def _fill(client, bulk):
    client.indices.create("t", MAPPING)
    client.bulk(bulk, refresh=True)
    for i in range(0, 600, 7):
        client.index("t", {"body": "the of fresh"}, id=f"d{i}")
    client.indices.refresh("t")
    return client


@pytest.fixture(scope="module")
def segments():
    rng = np.random.default_rng(3)
    docs, words = chip_smoke.make_text_corpus(rng, 6000)
    bulk = []
    for i, d in enumerate(docs):
        bulk += [{"index": {"_index": "t", "_id": f"d{i}"}}, d]
    ref, port = _fill(RefClient(), bulk), _fill(RestClient(device="cpu"),
                                                bulk)
    rsh = ref.node.indices["t"].shards[0]
    psv = port._indices["t"]
    pseg = psv.engine.segments[0]
    assert pseg.codec_version == 2 and pseg.live_count < pseg.ndocs
    return (rsh.segments[0], RefSearcher(rsh).context(), pseg,
            psv.searcher.context(), words)


def queries(words, seed: int, n: int = 40):
    """(query, window, body) triples: single stopwords, stopword mixes,
    frequent-word groups, long groups of rare words with stopwords;
    default totals, msm 2 and track_total_hits."""
    stop = chip_smoke.STOPWORDS
    rng = np.random.default_rng(seed)
    out = []
    for qi in range(n):
        kind = qi % 4
        if kind == 0:
            ts = [stop[qi % len(stop)]]
        elif kind == 1:
            ts = [str(x) for x in rng.choice(stop, 3, replace=False)] + [
                str(words[int(rng.integers(0, 30))])]
        elif kind == 2:
            ts = [str(x) for x in rng.choice(words[:40], int(rng.integers(
                2, 10)), replace=False)]
        else:
            ts = [str(x) for x in rng.choice(stop, 2, replace=False)] + [
                str(x) for x in rng.choice(words[200:1500], 8,
                                           replace=False)]
        q = {"match": {"body": " ".join(ts)}}
        if qi % 5 == 4:
            q = {"match": {"body": {"query": " ".join(ts),
                                    "minimum_should_match": 2}}}
        body = {"query": q} if qi % 3 else {"query": q,
                                            "track_total_hits": True}
        out.append((q, int(rng.choice([1, 3, 10, 40, 100])), body))
    return out


def _rungs(stats: dict, before: dict) -> tuple:
    return tuple(k for k in RUNGS if stats[k] > before[k])


def run_both(segments, seed: int) -> list:
    rseg, rctx, pseg, pctx, words = segments
    seen = []
    for q, window, body in queries(words, seed):
        rspec = rip.make_spec(RC.rewrite(rdsl.parse_query(q), rctx,
                                         scoring=True), [], [], [], None,
                              window, body)
        pspec = impactpath.make_spec(C.rewrite(dsl.parse_query(q), pctx),
                                     window, body)
        assert (rspec.prune_ok, rspec.window) == (pspec.prune_ok,
                                                   pspec.window)
        r0, p0 = rip.stats(), dict(impactpath.STATS)
        want = rip.segment_search(rseg, rctx, rspec, window)
        got = impactpath.segment_search(pseg, pctx, pspec, window, CPU)
        rung = _rungs(rip.stats(), r0)
        assert _rungs(impactpath.STATS, p0) == rung, (q, window, body)
        assert (got is None) == (want is None), (q, window)
        if want is not None:
            assert np.asarray(want["topk_scores"]).tobytes() \
                == got["topk_scores"].tobytes(), (q, window)
            np.testing.assert_array_equal(got["topk_idx"],
                                          np.asarray(want["topk_idx"]))
            assert (got["total"], got["total_rel"]) \
                == (want["total"], want["total_rel"]), (q, window)
        seen.append(rung)
    return seen


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_segment_search_matches_reference(segments, seed):
    seen = run_both(segments, seed)
    assert ("served",) in seen and ("served", "pruned_served",
                                     "phase2_served") in seen


def test_escalation_matches_reference(segments, monkeypatch):
    """A prune margin far past the sound one (in both packages) prunes
    blocks the window needs: certificates fail, and the phase-2 union
    too, so queries escalate (None) exactly where the reference's do."""
    for mod in (rip, impactpath):
        monkeypatch.setattr(mod, "PRUNE_MARGIN", 6.0)
        monkeypatch.setattr(mod, "RANGE_MARGIN", 6.0)
    seen = run_both(segments, 4)
    assert ("escalated",) in seen


def test_impact_program_matches_reference(segments):
    """The device first pass on a planned block set: values, ids and
    total equal the reference's jitted program bit for bit."""
    rseg, rctx, pseg, pctx, words = segments
    pb = pseg.postings["body"]
    plane = pb.impact
    rarrs = rseg.device_arrays()
    rpost = rarrs["postings"]["body"]
    post = C.field_postings(pseg, "body", CPU)
    for terms, prune, msm in ((["the", "of", words[3]], True, 1.0),
                              ([words[1], words[2], words[5]], False, 2.0),
                              (["and"], True, 1.0)):
        rows = np.asarray([pb.row(t) for t in terms], np.int64)
        weights = np.linspace(1.0, 2.0, len(terms)).astype(np.float32)
        offs, lens, bw, bterm, kept, rem, _nb, _tp = impactpath._plan_blocks(
            pb, plane, rows, weights, 64, prune, 10,
            plane.quant_err(), ndocs=pseg.ndocs)
        B = 1 << max(len(offs) - 1, 2).bit_length()
        bstart = np.zeros(B, np.int32)
        blen = np.zeros(B, np.int32)
        bweight = np.zeros(B, np.float32)
        bstart[:len(offs)] = offs
        blen[:len(offs)] = lens
        bweight[:len(offs)] = bw
        bucket = 1 << max(kept - 1, 255).bit_length()
        prog = RC.build_impact_program(B, bucket, 64, plane.bits)
        wv, wi, wt = jax.device_get(prog(
            rpost["doc_ids"], rpost["impacts"], rarrs["live"], bstart, blen,
            bweight, np.float32(msm)))
        brow = rows[bterm]
        tb = np.zeros(len(terms) + 1, np.int64)
        np.cumsum(np.bincount(bterm, minlength=len(terms)), out=tb[1:])
        gv, gi, gt = impactpath.impact_program(
            post, pseg.live_on(CPU), post.row_start[brow]
            + (offs - post.csr_off[brow]), lens, bw, tb, msm, 64,
            pseg.ndocs)
        assert gv.tobytes() == np.asarray(wv).tobytes(), terms
        np.testing.assert_array_equal(gi, np.asarray(wi))
        assert gt == int(wt), terms
