"""The port's fused top-k over codec-v2 impacts
(opensearch_tpu_torch/ops/bm25.fused_bm25_topk_impact, on the CPU its plain
PyTorch version) against the JAX package's Pallas kernel, run unchanged in
TPU interpret mode on the CPU.

Tolerances (same inputs, made from a numpy seed):
- totals and ids: identical;
- scores: relative difference <= (T + 1) * 2^-23. Each contribution is one
  f32 multiply on both sides, so contributions are bit-equal; a doc's sum
  differs only in order (the TPU kernel sums in its bitonic merge's order,
  the port in slot order), up to 2^-24 relative per addition, and all
  contributions are non-negative, so relative bounds add.

The grid: T in {1, 2, 4, 8} x K in {16, 128}, each shape with rows at
msm 1 and msm T, absent slots, windows spilling in a skip prefix from the
tile below, a [dlo, dhi) doc-range row, and 16-bit (q up to 65535) and
8-bit (q up to 255) planes. One (T, L, K) shape per case: each costs one
interpret-mode compile.
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
L = 1024


def _case(seed, T, K, bits, QB=5, ndocs=3000):
    rng = np.random.default_rng(seed)
    qmax = (1 << bits) - 1
    dfs = [int(x) for x in rng.integers(40, 700, 9)]
    starts = np.zeros(len(dfs) + 1, np.int64)
    np.cumsum(dfs, out=starts[1:])
    docs = np.concatenate([np.sort(rng.choice(ndocs, d, replace=False))
                           for d in dfs]).astype(np.int32)
    imp = rng.integers(0, qmax + 1, len(docs)).astype(np.int32)
    imp[starts[:-1]] = qmax                  # every row holds the top value
    a_starts, a_docs, a_imp = bm25.align_csr_rows(
        starts, docs, imp, margin=1 << 16, alignment=128)
    rowstarts, nrows, lens, skips = (np.zeros((QB, T), np.int32)
                                     for _ in range(4))
    for q in range(QB):
        for t in range(T):
            if q == 2 and t == T - 1 and T > 1:
                continue                     # an absent slot
            r = int(rng.integers(0, len(dfs)))
            abs_el = int(a_starts[r])
            dma = (abs_el // 1024) * 1024
            skip = abs_el - dma
            ln = min(dfs[r], L - skip)
            nr = max(8, 1 << int(np.ceil(np.log2(-(-(skip + ln) // 128)))))
            rowstarts[q, t], nrows[q, t] = dma // 128, nr
            lens[q, t], skips[q, t] = ln, skip
    weights = (rng.uniform(0.2, 3.0, (QB, T)) / qmax).astype(np.float32)
    msm = np.where(np.arange(QB) % 2 == 1, float(T), 1.0).astype(
        np.float32)[:, None]
    dlo = np.zeros((QB, 1), np.int32)
    dhi = np.full((QB, 1), SENT, np.int32)
    dlo[3, 0], dhi[3, 0] = 700, 2100         # a doc-range chunk row
    return (a_docs, a_imp, rowstarts, nrows, lens, skips, weights, msm,
            dlo, dhi)


CASES = {f"T{T}_K{K}_u{bits}": dict(seed=10 * T + K, T=T, K=K, bits=bits)
         for T, K, bits in [(1, 16, 16), (1, 128, 8), (2, 16, 8),
                            (2, 128, 16), (4, 16, 16), (4, 128, 8),
                            (8, 16, 8), (8, 128, 16)]}


@pytest.mark.parametrize("name", sorted(CASES))
def test_impact_plain_matches_pallas_interpret(name):
    c = CASES[name]
    T, K = c["T"], c["K"]
    args = _case(**c)
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(o) for o in ref.fused_bm25_topk_impact(
            *[jnp.asarray(a) for a in args], T=T, L=L, K=K)]
    before = dict(bm25.COUNTS)
    got = [o.numpy() for o in bm25.fused_bm25_topk_impact(
        *[torch.from_numpy(a) for a in args], T=T, L=L, K=K)]
    assert bm25.COUNTS["plain_calls"] == before["plain_calls"] + 1
    assert bm25.COUNTS["impact_launches"] == before["impact_launches"]
    (p_sc, p_id, p_tot), (r_sc, r_id, r_tot) = got, want
    np.testing.assert_array_equal(p_tot, r_tot)
    assert (p_tot[0::2, 0] > 0).all()        # the msm = 1 rows
    np.testing.assert_array_equal(p_id, r_id)
    fin = np.isfinite(r_sc)
    np.testing.assert_array_equal(np.isfinite(p_sc), fin)
    np.testing.assert_array_equal(p_sc[~fin], r_sc[~fin])
    np.testing.assert_allclose(p_sc[fin], r_sc[fin],
                               rtol=(T + 1) * 2.0**-23, atol=0)
    # the chunk row keeps only docs in [dlo, dhi)
    ids3 = p_id[3][p_id[3] >= 0]
    assert ((ids3 >= 700) & (ids3 < 2100)).all()


def test_impact_plain_rejects_bad_inputs():
    args = [torch.from_numpy(a) for a in _case(1, 2, 16, 16)]
    with pytest.raises(ValueError, match="imp must be torch.int32"):
        bm25.fused_bm25_topk_impact(args[0], args[1].float(), *args[2:],
                                    T=2, L=L, K=16)
    with pytest.raises(ValueError, match="T must be"):
        bm25.fused_bm25_topk_impact(*args, T=3, L=L, K=16)
