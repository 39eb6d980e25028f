"""The port's phase-2 exact rescore (opensearch_tpu_torch/ops/rescore.py,
torch ops) on CPU tensors against the host oracles, bit for bit: its own
numpy mirror `host_exact_rescore_batch`, the JAX package's mirror and
`exact_rescore_batch`, and the fastpath's per-query `_exact_rescore`
through the batched `_rescore_many_device` path. Exact f32 equality, not
allclose: the ladder's theta and tie comparisons read these scores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from opensearch_tpu.ops import rescore as ref_rescore
from opensearch_tpu_torch import RestClient
from opensearch_tpu_torch.ops import rescore
from opensearch_tpu_torch.ops.bm25 import (DL_BITS, INT_SENTINEL, LANES,
                                           align_csr_rows)
from opensearch_tpu_torch.search import compiler as C
from opensearch_tpu_torch.search import fastpath
from opensearch_tpu_torch.search import query_dsl as dsl

jax.config.update("jax_platforms", "cpu")

CPU = torch.device("cpu")


def _operands(seed, T=4, CC=256, QB=4, nterms=6, maxdf=800, ndocs=4000):
    rng = np.random.default_rng(seed)
    starts = [0]
    docs, tfdl = [], []
    for _ in range(nterms):
        df = int(rng.integers(1, maxdf))
        ids = np.sort(rng.choice(ndocs, size=df, replace=False))
        tf = rng.integers(1, 30, df)
        dl = rng.integers(1, 500, df)
        docs.append(ids.astype(np.int32))
        tfdl.append(((tf.astype(np.int64) << DL_BITS) | dl).astype(np.int32))
        starts.append(starts[-1] + df)
    a_starts, a_docs, a_tfdl = align_csr_rows(
        np.asarray(starts, np.int64), np.concatenate(docs),
        np.concatenate(tfdl), margin=1024, alignment=LANES)
    st = np.zeros((QB, T), np.int32)
    lens = np.zeros((QB, T), np.int32)
    weights = np.zeros((QB, T), np.float32)
    avgdl = np.zeros((QB, 1), np.float32)
    cand = np.full((QB, CC), INT_SENTINEL, np.int32)
    for q in range(QB):
        for t in range(T):
            if rng.random() < 0.2:
                continue                      # absent slot
            r = int(rng.integers(0, nterms))
            a, b = int(a_starts[r]), int(a_starts[r + 1])
            st[q, t] = a
            lens[q, t] = int(np.sum(a_docs[a:b] != INT_SENTINEL))
            weights[q, t] = np.float32(rng.uniform(0.1, 4.0))
        avgdl[q, 0] = np.float32(rng.uniform(1.0, 300.0))
        n = int(rng.integers(1, CC))
        cand[q, :n] = np.sort(rng.choice(ndocs, size=n, replace=False))
    return a_docs, a_tfdl, st, lens, weights, avgdl, cand


@pytest.mark.parametrize("seed", [3, 17])
@pytest.mark.parametrize("k1,b", [(1.2, 0.75), (0.9, 0.0)])
def test_rescore_batch_bitwise_equal(seed, k1, b):
    ops = _operands(seed)
    T, CC = ops[2].shape[1], ops[6].shape[1]
    gx, gc = rescore.exact_rescore_batch(
        *[torch.from_numpy(a) for a in ops], T=T, C=CC, k1=k1, b=b)
    hx, hc = rescore.host_exact_rescore_batch(*ops, k1=k1, b=b)
    rx, rc = ref_rescore.host_exact_rescore_batch(*ops, k1=k1, b=b)
    jx, jc = ref_rescore.exact_rescore_batch(
        jnp.asarray(ops[0]), jnp.asarray(ops[1]), *ops[2:], T=T, C=CC,
        k1=k1, b=b)
    assert gx.dtype == torch.float32 and gc.dtype == torch.int32
    assert gx.numpy().tobytes() == hx.tobytes() == rx.tobytes() \
        == np.asarray(jx).tobytes()
    assert gc.numpy().tobytes() == hc.tobytes() == rc.tobytes() \
        == np.asarray(jc).tobytes()
    assert (hc > 0).any()


def test_bucket_and_budget_match_reference():
    from opensearch_tpu.search import compiler as RC
    for n in (0, 1, 255, 256, 257, 5000, 1 << 17, (1 << 17) + 1):
        assert C.rescore_cand_bucket(n) == RC.rescore_cand_bucket(n), n
    for T, CC in ((1, 256), (4, 4096), (8, 1 << 17)):
        assert rescore.rescore_elem_budget(T, CC) \
            == ref_rescore.rescore_elem_budget(T, CC)


def test_rescore_many_device_matches_exact_rescore(monkeypatch):
    """The batched path (padding, buckets, budget splits) on CPU tensors
    against the per-query host oracle, over head unions of real queries."""
    monkeypatch.setattr(fastpath, "L_HEAD", 64)
    rng = np.random.default_rng(4)
    docs, words = chip_smoke.make_text_corpus(rng, 1500)
    c = RestClient(device="cpu")
    c.indices.create("t", {"mappings": {"properties": {
        "body": {"type": "text"}}}})
    bulk = []
    for i, d in enumerate(docs):
        bulk += [{"index": {"_index": "t", "_id": str(i)}}, d]
    c.bulk(bulk, refresh=True)
    searcher = c._indices["t"].searcher
    seg = c._indices["t"].engine.segments[0]
    ctx = searcher.context()
    texts = ["the of", "the", words[0], f"{words[1]} {words[2]} and",
             f"a to in is {words[3]}"]
    lts = [C.rewrite(dsl.parse_query({"match": {"body": t}}), ctx)
           for t in texts]
    vqs = fastpath._prepare_vqueries(seg, ctx, lts, {}, CPU,
                                     prune=[True] * len(lts))
    al = fastpath.get_aligned(seg, "body", CPU)
    pb = seg.postings["body"]
    jobs = []
    for vq in vqs:
        assert vq.head and vq.clamped
        jobs.append((vq, fastpath._p2_candidates(vq, pb, al.head_ids.get)))
    # a budget of 2 queries per launch splits one group into launches
    monkeypatch.setattr(rescore, "rescore_elem_budget",
                        lambda T, CC: 2)
    got = fastpath._rescore_many_device(seg, jobs, CPU)
    for (vq, cand), (exact, counts) in zip(jobs, got):
        want_x, want_c = fastpath._exact_rescore(seg, vq, cand)
        assert exact.tobytes() == want_x.tobytes()
        np.testing.assert_array_equal(counts, want_c)
        assert counts.max() >= 1
