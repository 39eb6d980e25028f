"""The port's `fused_bm25_topk` (opensearch_tpu_torch/ops/bm25.py, fixed-L
windows over precomputed f32 norms; on a CPU tensor its plain version)
against the JAX package's first Pallas kernel `fused_bm25_topk`, run
unchanged in TPU interpret mode on the CPU. No search path of either
package calls this kernel; it is ported so that every TPU kernel of the
repo has its Hopper counterpart.

Tolerances (same inputs, made from a numpy seed): totals identical; scores
within (T + 1) * 2^-23 relative (contributions are one f32 multiply on
both sides, but for T >= 3 the TPU kernel sums in bitonic-merge order and
the port in slot order); ids identical, except that docs whose scores lie
within that tolerance may swap lanes.
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


def norms_case(seed, T, L, QB, absent=False, msm_all=False):
    rng = np.random.default_rng(seed)
    ndocs = 3000
    dfs = [int(x) for x in rng.integers(50, L, 8)]
    starts = np.zeros(len(dfs) + 1, np.int64)
    np.cumsum(dfs, out=starts[1:])
    docs = np.concatenate([np.sort(rng.choice(ndocs, d, replace=False))
                           for d in dfs]).astype(np.int32)
    norms = rng.uniform(0.01, 0.99, len(docs)).astype(np.float32)
    a_starts, a_docs, a_norms = bm25.align_csr_rows(
        starts, docs, norms, margin=L, alignment=1024)
    shape = (QB, T)
    w_starts = np.zeros(shape, np.int32)
    w_lens = np.zeros(shape, np.int32)
    for q in range(QB):
        for t in range(T):
            if absent and (q + t) % 3 == 2:
                continue
            r = int(rng.integers(0, len(dfs)))
            w_starts[q, t] = a_starts[r]
            w_lens[q, t] = dfs[r]
    weights = rng.uniform(0.2, 3.0, shape).astype(np.float32)
    msm = np.full((QB, 1), float(T) if msm_all else 1.0, np.float32)
    return a_docs, a_norms, w_starts, w_lens, weights, msm


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
    "T1": dict(seed=1, T=1, L=1024, QB=3, K=10),
    "T2_msm_all": dict(seed=2, T=2, L=1024, QB=4, K=16, msm_all=True),
    "T4_absent": dict(seed=3, T=4, L=1024, QB=3, K=128, absent=True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_norms_plain_matches_pallas_interpret(name):
    c = dict(CASES[name])
    T, L, K = c["T"], c["L"], c.pop("K")
    args = norms_case(**c)
    with pltpu.force_tpu_interpret_mode():
        r = [np.asarray(o) for o in ref.fused_bm25_topk(
            *[jnp.asarray(a) for a in args], T=T, L=L, K=K)]
    before = bm25.COUNTS["plain_calls"]
    p = [o.numpy() for o in bm25.fused_bm25_topk(
        *[torch.from_numpy(a) for a in args], T=T, L=L, K=K)]
    assert bm25.COUNTS["plain_calls"] == before + 1
    assert_close_topk(p, r, T, K)
    assert (p[2][:, 0] > 0).all()
