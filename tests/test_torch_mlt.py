"""more_like_this in the port against the JAX package on the CPU.

Every case of the reference's tests/test_mlt.py runs as it is written there,
its `RestClient` replaced by `tests.test_torch_nested.Twin`: each call
goes to both packages' clients (the port's on `device="cpu"`), the
responses must be equal with `took` aside (scores within 1e-6 relative),
or both raise the same error, and the case's own assertions read the
port's response. chip_smoke phase 22's more_like_this brute force is
held to the reference's term selection.
"""

import jax
import pytest

from tests.test_torch_nested import reference_cases, run_reference_case

jax.config.update("jax_platforms", "cpu")

CASES = reference_cases("test_mlt.py")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_case(case, tmp_path):
    run_reference_case(case, tmp_path)


def test_phase22_mlt_brute_force_selects_as_the_reference():
    """chip_smoke's (i) brute force (`mlt_page`, its doc frequencies
    read without copying a row while every doc is counted, kept per term
    after a compaction) selects the terms the reference's rewrite does
    and pages them as the NumpyIndex's dense group, over 20,000 passages
    with re-indexed docs, before and after a compaction."""
    import math

    import numpy as np

    import chip_smoke
    from opensearch_tpu_torch import bench_corpus as bc
    n = 20_000
    corpus = bc.build_corpus(n)
    ix = chip_smoke.NumpyIndex(corpus, bc.guardrail_columns(n))
    q = bc.pick_queries(corpus[4], 16, seed=12)
    ix.reindex([(7 * j + 3, [int(t) for t in q[j]], j % 3, j)
                for j in range(16)])
    vs = bc.vocab_strings(len(corpus[4]))
    rng = np.random.default_rng(1)
    for _ in range(2):
        for g in rng.choice(np.flatnonzero(ix.live[:ix.n0]), 10,
                            replace=False):
            like = chip_smoke.passage_terms({"corpus": corpus}, [g])[int(g)]
            scored = []
            for t, tf in like.items():
                df = len(ix.row(t)[0])
                assert chip_smoke.ix_df(ix, t) == df
                if df >= 5:
                    scored.append((tf * math.log(1 + (ix.n_stats - df + .5)
                                                 / (df + .5)), vs[t], t))
            scored.sort(key=lambda x: (-x[0], x[1]))
            sel = [t for *_, t in scored[:25]]
            want = ix.page(*ix.group(sel, max(int(.3 * len(sel)), 1)), 0, 10)
            assert chip_smoke.mlt_page(ix, like, {}, vs) == want
        ix.compact()
