"""The port's fused BM25 top-k (opensearch_tpu_torch/ops/bm25.py) against
the JAX package's Pallas kernel, run unchanged in TPU interpret mode on the
CPU, plus the port's align_csr_rows and scoring primitives against theirs.

Tolerances (same inputs, made from a numpy seed):
- totals: identical;
- scores: relative difference <= (T + 1) * 2^-23. The port evaluates
  `tf + k1 * y` as a multiply and an add, as the kernel's source writes it;
  XLA on the CPU contracts the pair into one fused multiply-add, so a
  reference contribution can differ by about 1.5 ULP, and the T >= 3
  doc sums also differ in order (the TPU kernel sums in bitonic-merge
  order, the port in slot order), adding up to 2^-24 per addition. All
  contributions are positive, so relative bounds add. Largest observed
  over these cases: 2 ULP (1.65e-7 relative).
- ids: identical, except that docs whose scores lie within that
  tolerance of each other may swap lanes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opensearch_tpu.ops import pallas_bm25 as ref
from opensearch_tpu.ops import scoring as ref_scoring
from opensearch_tpu_torch.ops import bm25, scoring

jax.config.update("jax_platforms", "cpu")

SENT = 2**31 - 1


def _csr(rng, ndocs, dfs, big_tf=False):
    starts = np.zeros(len(dfs) + 1, np.int64)
    np.cumsum(dfs, out=starts[1:])
    docs = np.concatenate([np.sort(rng.choice(ndocs, d, replace=False))
                           for d in dfs]).astype(np.int32)
    tfs = rng.integers(1, 12, len(docs)).astype(np.int64)
    if big_tf:
        tfs[::7] = rng.integers(1024, 2048, len(tfs[::7]))
    dls = rng.integers(3, 400, ndocs).astype(np.int64)
    packed = ((tfs << bm25.DL_BITS) | dls[docs]).astype(np.int32)
    return starts, docs, packed


def _case(seed, T, L, K, QB, absent=False, msm_all=False, cut=False,
          big_tf=False, ndocs=3000, dfs=None):
    """Kernel rows over 128-aligned CSR rows (windows start at the 1024
    tile below the row, so most rows spill in a prefix of the previous
    row, masked by `skip`)."""
    rng = np.random.default_rng(seed)
    dfs = dfs or [int(x) for x in rng.integers(40, 700, 9)]
    starts, docs, packed = _csr(rng, ndocs, dfs, big_tf)
    a_starts, a_docs, a_packed = bm25.align_csr_rows(
        starts, docs, packed, margin=1 << 16, alignment=128)
    shape = (QB, T)
    rowstarts, nrows, lens, skips = (np.zeros(shape, np.int32)
                                     for _ in range(4))
    for q in range(QB):
        for t in range(T):
            if absent and (q + t) % 3 == 1:
                continue
            r = int(rng.integers(0, len(dfs)))
            abs_el = int(a_starts[r])
            dma = (abs_el // 1024) * 1024
            skip = abs_el - dma
            ln = min(dfs[r], L - skip)
            nr = bm25_next_pow2(-(-(skip + ln) // 128), 8)
            rowstarts[q, t], nrows[q, t] = dma // 128, nr
            lens[q, t], skips[q, t] = ln, skip
    weights = rng.uniform(0.2, 3.0, shape).astype(np.float32)
    msm = np.full((QB, 1), float(T) if msm_all else 1.0, np.float32)
    avgdl = np.full((QB, 1), np.float32(97.3), np.float32)
    dlo = np.zeros((QB, 1), np.int32)
    dhi = np.full((QB, 1), SENT, np.int32)
    if cut:
        dlo[:, 0] = rng.integers(200, 900, QB)
        dhi[:, 0] = dlo[:, 0] + rng.integers(300, 1500, QB)
    return (a_docs, a_packed, rowstarts, nrows, lens, skips, weights, msm,
            avgdl, dlo, dhi)


def bm25_next_pow2(n, floor):
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


def _run_ref(args, T, L, K):
    with pltpu.force_tpu_interpret_mode():
        out = ref.fused_bm25_topk_tfdl(*[jnp.asarray(a) for a in args],
                                       T=T, L=L, K=K, k1=1.2, b=0.75)
    return [np.asarray(o) for o in out]


def _run_port(args, T, L, K):
    out = bm25.fused_bm25_topk_tfdl(*[torch.from_numpy(a) for a in args],
                                    T=T, L=L, K=K, k1=1.2, b=0.75)
    return [o.numpy() for o in out]


CASES = {
    "T1": dict(seed=1, T=1, L=1024, K=10, QB=3),
    "T2_skip_prefix": dict(seed=2, T=2, L=2048, K=16, QB=4),
    "T2_doc_window": dict(seed=3, T=2, L=2048, K=16, QB=3, cut=True),
    "T2_absent_slots": dict(seed=4, T=2, L=1024, K=10, QB=4, absent=True),
    "T2_msm_all_big_tf": dict(seed=5, T=2, L=1024, K=16, QB=3,
                              msm_all=True, big_tf=True),
    "T4": dict(seed=6, T=4, L=1024, K=16, QB=2, absent=True),
    "K128_few_hits": dict(seed=7, T=2, L=1024, K=128, QB=2,
                          dfs=[30, 45, 20, 60]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_interpret(name):
    c = CASES[name]
    T, L, K = c["T"], c["L"], c["K"]
    args = _case(**c)
    r_sc, r_id, r_tot = _run_ref(args, T, L, K)
    p_sc, p_id, p_tot = _run_port(args, T, L, K)
    np.testing.assert_array_equal(p_tot, r_tot)
    assert (p_tot[:, 0] > 0).all()
    rtol = (T + 1) * 2.0**-23
    fin = np.isfinite(r_sc)
    np.testing.assert_array_equal(np.isfinite(p_sc), fin)
    np.testing.assert_array_equal(p_sc[~fin], r_sc[~fin])
    np.testing.assert_allclose(p_sc[fin], r_sc[fin], rtol=rtol, atol=0)
    for q in range(p_id.shape[0]):
        moved = p_id[q] != r_id[q]
        # lanes only swap between docs whose scores tie within tolerance
        np.testing.assert_allclose(p_sc[q][moved], r_sc[q][moved],
                                   rtol=rtol, atol=0)
        if not moved[K - 1]:
            assert set(p_id[q][:K]) == set(r_id[q][:K])
    if name == "K128_few_hits":
        for q, n in enumerate(p_tot[:, 0]):
            assert n < K
            assert (p_id[q, :n] >= 0).all() and (p_id[q, n:] == -1).all()


@pytest.mark.parametrize("alignment", [128, 1024])
def test_align_csr_rows_matches_reference(alignment):
    rng = np.random.default_rng(11)
    dfs = [5, 0, 300, 129, 0, 1, 1024, 77]
    starts, docs, packed = _csr(rng, 5000, dfs)
    tfs = rng.random(len(docs)).astype(np.float32)
    want = ref.align_csr_rows(starts, docs, packed, tfs, margin=3000,
                              alignment=alignment)
    got = bm25.align_csr_rows(starts, docs, packed, tfs, margin=3000,
                              alignment=alignment)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert g.tobytes() == w.tobytes()


def test_posting_contrib_matches_reference():
    rng = np.random.default_rng(12)
    tf = rng.integers(1, 2048, 4096).astype(np.float32)
    dl = rng.integers(1, 2**21, 4096).astype(np.float32)
    w = rng.uniform(0.0, 9.0, 4096).astype(np.float32)
    avgdl = np.float32(57.123)
    for k1, b in ((1.2, 0.75), (0.9, 0.4), (2.0, 0.0)):
        want = np.asarray(ref_scoring.posting_contrib(
            ref_scoring.SIM_BM25, jnp.asarray(tf), jnp.asarray(dl),
            jnp.asarray(w), 0.0, k1, b, jnp.float32(avgdl)))
        got = scoring.posting_contrib(
            torch.from_numpy(tf), torch.from_numpy(dl), torch.from_numpy(w),
            k1, b, torch.tensor(avgdl)).numpy()
        np.testing.assert_array_equal(got, want)
