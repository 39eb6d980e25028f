"""The port's fused bool/filtered BM25 top-k (opensearch_tpu_torch/ops/bm25.py
`fused_bm25_bool_topk` on a CPU tensor, i.e. its plain version) against the
JAX package's Pallas kernel `fused_bm25_bool_topk`, run unchanged in TPU
interpret mode on the CPU.

Rows mix the count-weight patterns a bool query makes (all required,
required + a counted family, a family alone, bonus terms), thresholds at
the pass/fail edge, windows that spill in from the tile below (skips),
partial doc windows, absent (dead) slots, a filter slot whose doc list
lives in a buffer of another length than the postings, and const-score
rows with no term slot.

Tolerances (same inputs, made from a numpy seed):
- totals: identical;
- scores: relative difference <= (T + 1) * 2^-23 with T the slot count
  (2 TS when filtered), for the reasons tests/test_torch_bm25_kernel.py
  gives (XLA-CPU's fused multiply-add in the reference's contribution, and
  merge-order against slot-order sums for T >= 3);
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
from opensearch_tpu_torch.ops import bm25

jax.config.update("jax_platforms", "cpu")

SENT = 2**31 - 1
REQ_W = bm25.REQ_W


def _pow2(n, floor=8):
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


def _window(abs_el, avail, L):
    """(rowstart, nrows, len, skip) of a window over `avail` postings
    starting at element `abs_el` of an aligned buffer."""
    dma = (abs_el // 1024) * 1024
    skip = abs_el - dma
    ln = min(avail, L - skip)
    return dma // 128, _pow2(-(-(skip + ln) // 128)), ln, skip


def bool_case(seed, TS, filtered, L, K, QB, cut=False, const_rows=False,
              ndocs=4000):
    """Kernel rows of TS term slots (+ a filter slot): per row one of four
    count-weight patterns, its threshold at the pass edge, some rows one
    above it (nothing can pass)."""
    rng = np.random.default_rng(seed)
    T = 2 * TS if filtered else TS
    dfs = [int(x) for x in rng.integers(60, 900, 10)]
    starts = np.zeros(len(dfs) + 1, np.int64)
    np.cumsum(dfs, out=starts[1:])
    docs = np.concatenate([np.sort(rng.choice(ndocs, d, replace=False))
                           for d in dfs]).astype(np.int32)
    tfs = rng.integers(1, 12, len(docs)).astype(np.int64)
    tfs[::11] = rng.integers(1024, 2048, len(tfs[::11]))
    dls = rng.integers(3, 400, ndocs).astype(np.int64)
    packed = ((tfs << bm25.DL_BITS) | dls[docs]).astype(np.int32)
    a_starts, a_docs, a_packed = bm25.align_csr_rows(
        starts, docs, packed, margin=1 << 12, alignment=128)
    # the filter: a sorted doc list, sentinel padded, in its own buffer
    fdocs = np.sort(rng.choice(ndocs, ndocs // 3, replace=False)).astype(
        np.int32)
    filt = np.full(((len(fdocs) + 127) // 128) * 128 + (1 << 12), SENT,
                   np.int32)
    filt[:len(fdocs)] = fdocs
    assert filt.shape[0] != a_docs.shape[0]

    shape = (QB, T)
    rowstarts, nrows, lens, skips = (np.zeros(shape, np.int32)
                                     for _ in range(4))
    weights = rng.uniform(0.2, 3.0, (QB, TS)).astype(np.float32)
    cw = np.zeros(shape, np.float32)
    thresh = np.zeros((QB, 1), np.float32)
    for q in range(QB):
        pattern = q % 4
        nt = 0 if (const_rows and q % 2 == 1) else int(rng.integers(1, TS + 1))
        n_req = fam = 0
        for t in range(nt):
            if pattern == 0:
                kind = "req"
            elif pattern == 1:
                kind = "req" if t == 0 else "fam"
            elif pattern == 2:
                kind = "fam"
            else:
                kind = "req" if t == 0 else "bonus"
            cw[q, t] = {"req": REQ_W, "fam": 1.0, "bonus": 0.0}[kind]
            n_req += kind == "req"
            fam += kind == "fam"
            if (q + t) % 5 == 4:
                continue                          # absent term: dead slot
            r = int(rng.integers(0, len(dfs)))
            off = int(rng.integers(0, dfs[r] // 3))
            rowstarts[q, t], nrows[q, t], lens[q, t], skips[q, t] = _window(
                int(a_starts[r]) + off, dfs[r] - off, L)
        fam_msm = min(fam, 1 + q % 2) if fam else 0
        if filtered:
            cw[q, TS] = REQ_W
            off = int(rng.integers(0, len(fdocs) // 4))
            rowstarts[q, TS], nrows[q, TS], lens[q, TS], skips[q, TS] = \
                _window(off, len(fdocs) - off, L)
        thresh[q, 0] = REQ_W * (n_req + filtered) + fam_msm
        if q % 7 == 6:
            thresh[q, 0] += 1.0                   # just past the edge
    avgdl = np.full((QB, 1), np.float32(97.3), np.float32)
    dlo = np.zeros((QB, 1), np.int32)
    dhi = np.full((QB, 1), SENT, np.int32)
    if cut:
        dlo[:, 0] = rng.integers(200, 1500, QB)
        dhi[:, 0] = dlo[:, 0] + rng.integers(300, 2000, QB)
    return (a_docs, a_packed, filt, rowstarts, nrows, lens, skips, weights,
            cw, thresh, avgdl, dlo, dhi)


def run_ref(args, TS, L, K, filtered):
    with pltpu.force_tpu_interpret_mode():
        out = ref.fused_bm25_bool_topk(*[jnp.asarray(a) for a in args],
                                       TS=TS, L=L, K=K, k1=1.2, b=0.75,
                                       filtered=filtered)
    return [np.asarray(o) for o in out]


def run_port(args, TS, L, K, filtered):
    out = bm25.fused_bm25_bool_topk(*[torch.from_numpy(a) for a in args],
                                    TS=TS, L=L, K=K, k1=1.2, b=0.75,
                                    filtered=filtered)
    return [o.numpy() for o in out]


def assert_close_topk(p, r, T, K):
    p_sc, p_id, p_tot = p
    r_sc, r_id, r_tot = r
    np.testing.assert_array_equal(p_tot, r_tot)
    rtol = (T + 1) * 2.0**-23
    fin = np.isfinite(r_sc)
    np.testing.assert_array_equal(np.isfinite(p_sc), fin)
    np.testing.assert_array_equal(p_sc[~fin], r_sc[~fin])
    np.testing.assert_allclose(p_sc[fin], r_sc[fin], rtol=rtol, atol=0)
    for q in range(p_id.shape[0]):
        moved = p_id[q] != r_id[q]
        np.testing.assert_allclose(p_sc[q][moved], r_sc[q][moved],
                                   rtol=rtol, atol=0)
        if not moved[K - 1]:
            assert set(p_id[q][:K]) == set(r_id[q][:K])


CASES = {
    "TS1_unfiltered": dict(seed=1, TS=1, filtered=False, L=1024, K=16,
                           QB=8),
    "TS1_const_score_rows": dict(seed=2, TS=1, filtered=True, L=2048,
                                 K=10, QB=8, const_rows=True),
    "TS2_filtered_doc_window": dict(seed=3, TS=2, filtered=True, L=1024,
                                    K=16, QB=8, cut=True),
    "TS4_filtered": dict(seed=4, TS=4, filtered=True, L=1024, K=128,
                         QB=8),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_bool_plain_matches_pallas_interpret(name):
    c = CASES[name]
    TS, L, K, filtered = c["TS"], c["L"], c["K"], c["filtered"]
    args = bool_case(**c)
    p = run_port(args, TS, L, K, filtered)
    r = run_ref(args, TS, L, K, filtered)
    assert_close_topk(p, r, 2 * TS if filtered else TS, K)
    tot = p[2][:, 0]
    # the grid reaches both sides of the thresholds
    assert (tot > 0).any() and (tot == 0).any(), tot


def test_bool_wrapper_checks_its_own_shapes():
    args = [torch.from_numpy(a) for a in bool_case(5, 2, True, 1024, 10, 2)]
    bad = list(args)
    bad[7] = torch.zeros((2, 4), dtype=torch.float32)   # weights [QB, T]
    with pytest.raises(ValueError, match="weights"):
        bm25.fused_bm25_bool_topk(*bad, TS=2, L=1024, K=10, k1=1.2, b=0.75,
                                  filtered=True)
    bad = list(args)
    bad[2] = bad[2][:100]                                 # Pf % 128 != 0
    with pytest.raises(ValueError, match="filt"):
        bm25.fused_bm25_bool_topk(*bad, TS=2, L=1024, K=10, k1=1.2, b=0.75,
                                  filtered=True)
    with pytest.raises(ValueError, match="TS"):
        bm25.fused_bm25_bool_topk(*args, TS=3, L=1024, K=10, k1=1.2, b=0.75,
                                  filtered=True)
