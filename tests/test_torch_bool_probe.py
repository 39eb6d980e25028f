"""The probe form of the port's B3 (opensearch_tpu_torch/ops/bm25.py
`fused_bm25_bool_topk(..., probe=True)` on a CPU tensor, i.e. its plain
version) against the list form on the same logical rows, and both against
the JAX package's Pallas kernel `fused_bm25_bool_topk`, run unchanged in
TPU interpret mode on the CPU.

The list form merges the filter's sorted doc list as slot TS; the probe
form keeps the TS term slots and reads each doc's bit from the filter's
bitmap (`bm25.pack_bits`), adding the filter's count weight and 0.0 last
in slot order. The rows here are the ones the planner gives the probe:
every one needs a term (required slots, a counted family, or both, with
bonus terms beside), so the filter alone never reaches the threshold. The
list form's filter window holds every filter doc of the row's [dlo, dhi).

Tolerances (same inputs, made from a numpy seed):
- probe form == list form: bit for bit (scores compared as their bits, so
  a -0.0 term sum must come out +0.0 on a filter hit in both);
- against the Pallas kernel: those of tests/test_torch_bool_kernel.py
  (totals identical; scores within (T + 1) * 2^-23 relative, T = 2 TS;
  ids identical except for docs whose scores lie within that tolerance).
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
# docs at the bitmap's word edges, in every term list; the filter holds
# 31, 33, 63 and 64 and leaves out 32 and 65
EDGE_DOCS = (31, 32, 33, 63, 64, 65)
EDGE_IN = (31, 33, 63, 64)


def _window(abs_el, avail, L):
    """(rowstart, nrows, len, skip) of a window over `avail` postings
    starting at element `abs_el` of an aligned buffer."""
    dma = (abs_el // 1024) * 1024
    skip = abs_el - dma
    ln = min(avail, L - skip)
    nr = max(8, 1 << (max(-(-(skip + ln) // 128), 1) - 1).bit_length())
    return dma // 128, nr, ln, skip


def probe_case(seed, TS, L, QB, ndocs, cut=False, signs=False):
    """(list-form args, probe-form args, filter docs, term lists) of QB
    rows. Count weights by q % 5: all required; required + a counted
    family; a family alone; required + bonus; a family + bonus; the
    threshold at the pass edge (the family's msm 1 or 2), every 7th row
    one past the most it can reach. `signs`: rows q % 6 == 4 have
    negative weights and q % 6 == 5 weights -0.0. `cut`: partial [dlo,
    dhi) windows."""
    rng = np.random.default_rng(seed)
    last = (ndocs - 1,)
    dfs = [int(x) for x in rng.integers(40, ndocs // 3, 8)]
    lists = [np.union1d(rng.choice(ndocs, d, replace=False),
                        EDGE_DOCS + last).astype(np.int32) for d in dfs]
    starts = np.zeros(len(lists) + 1, np.int64)
    np.cumsum([len(x) for x in lists], out=starts[1:])
    docs = np.concatenate(lists)
    tfs = rng.integers(1, 12, len(docs)).astype(np.int64)
    tfs[::11] = rng.integers(1024, 2048, len(tfs[::11]))
    dls = rng.integers(3, 400, ndocs).astype(np.int64)
    packed = ((tfs << bm25.DL_BITS) | dls[docs]).astype(np.int32)
    a_starts, a_docs, a_packed = bm25.align_csr_rows(
        starts, docs, packed, margin=1 << 12, alignment=128)
    # the filter: a third of the docs (some in no term list), the edge
    # docs as EDGE_IN says, and the last doc
    fset = set(rng.choice(ndocs, ndocs // 3, replace=False).tolist())
    fset -= set(EDGE_DOCS)
    fdocs = np.array(sorted(fset | set(EDGE_IN) | set(last)), np.int32)
    assert len(fdocs) <= L
    filt = np.full(((len(fdocs) + 127) // 128) * 128 + (1 << 12), SENT,
                   np.int32)
    filt[:len(fdocs)] = fdocs

    T = 2 * TS
    rowstarts, nrows, lens, skips = (np.zeros((QB, T), np.int32)
                                     for _ in range(4))
    weights = rng.uniform(0.2, 3.0, (QB, TS)).astype(np.float32)
    cw = np.zeros((QB, T), np.float32)
    thresh = np.zeros((QB, 1), np.float32)
    for q in range(QB):
        pattern = q % 5
        nt = int(rng.integers(1, TS + 1))
        if pattern in (1, 3, 4):
            nt = max(nt, 2)
        nt = min(nt, TS)
        n_req = fam = 0
        for t in range(nt):
            kind = {0: "req",
                    1: "req" if t == 0 else "fam",
                    2: "fam",
                    3: "req" if t == 0 else "bonus",
                    4: "fam" if t == 0 else "bonus"}[pattern]
            cw[q, t] = {"req": REQ_W, "fam": 1.0, "bonus": 0.0}[kind]
            n_req += kind == "req"
            fam += kind == "fam"
            r = int(rng.integers(0, len(lists)))
            off = int(rng.integers(0, 3))
            rowstarts[q, t], nrows[q, t], lens[q, t], skips[q, t] = _window(
                int(a_starts[r]) + off, len(lists[r]) - off, L)
        cw[q, TS] = REQ_W
        rowstarts[q, TS], nrows[q, TS], lens[q, TS], skips[q, TS] = \
            _window(0, len(fdocs), L)
        thresh[q, 0] = REQ_W * (n_req + 1) + (min(fam, 1 + q % 2)
                                              if fam else 0)
        if q % 7 == 6:
            # one past the most the row can reach: nothing passes
            thresh[q, 0] = REQ_W * (n_req + 1) + fam + 1.0
        if signs and q % 6 == 4:
            weights[q] = -weights[q]
        if signs and q % 6 == 5:
            weights[q] = np.float32(-0.0)
    assert (thresh[:, 0] > REQ_W).all()           # every row needs a term
    avgdl = np.full((QB, 1), np.float32(97.3), np.float32)
    dlo = np.zeros((QB, 1), np.int32)
    dhi = np.full((QB, 1), SENT, np.int32)
    if cut:
        dlo[:, 0] = rng.integers(0, ndocs // 2, QB)
        dhi[:, 0] = dlo[:, 0] + rng.integers(40, ndocs, QB)
    rows = [rowstarts, nrows, lens, skips, weights, cw, thresh, avgdl, dlo,
            dhi]
    mask = np.zeros(ndocs, bool)
    mask[fdocs] = True
    bits = bm25.pack_bits(torch.from_numpy(mask)).numpy()
    p_rows = ([x[:, :TS].copy() for x in rows[:4]] + [weights]
              + [np.concatenate([cw[:, :TS], cw[:, TS:TS + 1]], axis=1)]
              + rows[6:])
    return ([a_docs, a_packed, filt] + rows, [a_docs, a_packed, bits]
            + p_rows, fdocs, lists)


def run_port(args, TS, L, K, probe):
    out = bm25.fused_bm25_bool_topk(*[torch.from_numpy(a) for a in args],
                                    TS=TS, L=L, K=K, k1=1.2, b=0.75,
                                    filtered=True, probe=probe)
    return [o.numpy() for o in out]


def run_ref(args, TS, L, K):
    with pltpu.force_tpu_interpret_mode():
        out = ref.fused_bm25_bool_topk(*[jnp.asarray(a) for a in args],
                                       TS=TS, L=L, K=K, k1=1.2, b=0.75,
                                       filtered=True)
    return [np.asarray(o) for o in out]


def assert_bits_equal(a, b, what):
    np.testing.assert_array_equal(a[0].view(np.int32), b[0].view(np.int32),
                                  err_msg=f"{what}: scores")
    np.testing.assert_array_equal(a[1], b[1], err_msg=f"{what}: ids")
    np.testing.assert_array_equal(a[2], b[2], err_msg=f"{what}: totals")


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
    # every count-weight pattern at TS 1, 2 and 4; ndocs not a multiple
    # of 32
    "TS1": dict(seed=1, TS=1, L=2048, QB=10, ndocs=3001, K=16),
    "TS2_patterns": dict(seed=2, TS=2, L=2048, QB=10, ndocs=4001, K=128),
    "TS4_patterns": dict(seed=3, TS=4, L=2048, QB=10, ndocs=3037, K=16),
    # partial doc windows
    "TS2_doc_window": dict(seed=4, TS=2, L=2048, QB=10, ndocs=3500, K=16,
                           cut=True),
    # zero and negative weights: -0.0 sums become +0.0 on a filter hit
    "TS2_signs": dict(seed=5, TS=2, L=2048, QB=12, ndocs=2999, K=128,
                      signs=True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_probe_equals_list_and_pallas(name):
    c = dict(CASES[name])
    K = c.pop("K")
    TS, L = c["TS"], c["L"]
    list_args, probe_args, fdocs, _lists = probe_case(**c)
    p_list = run_port(list_args, TS, L, K, False)
    p_probe = run_port(probe_args, TS, L, K, True)
    assert_bits_equal(p_probe, p_list, name)
    assert_close_topk(p_list, run_ref(list_args, TS, L, K), 2 * TS, K)
    tot = p_probe[2][:, 0]
    # both sides of the thresholds, and only filter docs pass
    assert (tot > 0).any() and (tot == 0).any(), tot
    hits = p_probe[1][p_probe[1] >= 0]
    assert np.isin(hits, fdocs).all()
    if c.get("signs"):
        sc = p_probe[0]
        neg0 = (np.arange(sc.shape[0]) % 6 == 5)[:, None] & np.isfinite(sc)
        assert neg0.any()
        # every term sum of these rows is -0.0: the filter's 0.0 makes it
        # +0.0, as the list form's merged slot does
        assert (sc[neg0] == 0).all() and not np.signbit(sc[neg0]).any()
        negw = (np.arange(sc.shape[0]) % 6 == 4)[:, None] & np.isfinite(sc)
        assert (sc[negw] < 0).any()


def test_probe_reads_the_bit_at_word_edges():
    """Rows of one required term over docs around the bitmap's word edges
    and the last doc (ndocs not a multiple of 32): the passing docs are
    exactly the term's docs that the filter holds, with K above them."""
    TS, L, K = 1, 2048, 128
    ndocs = 1000
    rng = np.random.default_rng(9)
    term = np.array(EDGE_DOCS + (500, 998, 999), np.int32)
    a_starts, a_docs, a_packed = bm25.align_csr_rows(
        np.array([0, len(term)]), term,
        ((rng.integers(1, 9, len(term)) << bm25.DL_BITS) | 50).astype(
            np.int32), margin=1 << 12, alignment=128)
    fdocs = np.array(EDGE_IN + (999,), np.int32)
    mask = np.zeros(ndocs, bool)
    mask[fdocs] = True
    bits = bm25.pack_bits(torch.from_numpy(mask)).numpy()
    assert bits.shape == ((ndocs + 31) // 32,)
    filt = np.full(128 + (1 << 12), SENT, np.int32)
    filt[:len(fdocs)] = fdocs
    QB = 2
    rows = [np.zeros((QB, 2), np.int32) for _ in range(4)]
    for q in range(QB):
        (rows[0][q, 0], rows[1][q, 0], rows[2][q, 0],
         rows[3][q, 0]) = _window(int(a_starts[0]), len(term), L)
        (rows[0][q, 1], rows[1][q, 1], rows[2][q, 1],
         rows[3][q, 1]) = _window(0, len(fdocs), L)
    weights = np.array([[1.5], [0.0]], np.float32)
    cw = np.array([[REQ_W, REQ_W]] * QB, np.float32)
    thresh = np.full((QB, 1), 2 * REQ_W, np.float32)
    tail = [np.full((QB, 1), np.float32(50.0)),
            np.zeros((QB, 1), np.int32), np.full((QB, 1), SENT, np.int32)]
    list_args = [a_docs, a_packed, filt] + rows + [weights, cw, thresh] + tail
    probe_args = ([a_docs, a_packed, bits] + [x[:, :1].copy() for x in rows]
                  + [weights, cw, thresh] + tail)
    p_list = run_port(list_args, TS, L, K, False)
    p_probe = run_port(probe_args, TS, L, K, True)
    assert_bits_equal(p_probe, p_list, "word edges")
    assert_close_topk(p_list, run_ref(list_args, TS, L, K), 2, K)
    want = sorted(set(term.tolist()) & set(fdocs.tolist()))
    for q in range(QB):
        got = sorted(d for d in p_probe[1][q] if d >= 0)
        assert got == want, (q, got)
        assert p_probe[2][q, 0] == len(want)
    # zero weights: every passing score is +0.0
    assert not np.signbit(p_probe[0][1, :len(want)]).any()


def test_pack_bits_layout():
    mask = np.zeros(70, bool)
    mask[[0, 31, 32, 63, 64, 69]] = True
    bits = bm25.pack_bits(torch.from_numpy(mask)).numpy()
    assert bits.dtype == np.int32 and bits.shape == (3,)
    u = bits.view(np.uint32)
    assert u[0] == (1 | 1 << 31) and u[1] == (1 | 1 << 31)
    assert u[2] == (1 | 1 << 5)


def test_probe_wrapper_checks_its_own_shapes():
    _l, args, _f, _t = probe_case(6, 2, 2048, 4, 2000)
    t = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="probe needs filtered"):
        bm25.fused_bm25_bool_topk(*t, TS=2, L=2048, K=10, k1=1.2, b=0.75,
                                  filtered=False, probe=True)
    bad = list(t)
    bad[8] = bad[8][:, :2].contiguous()              # cw [QB, TS + 1]
    with pytest.raises(ValueError, match="cw"):
        bm25.fused_bm25_bool_topk(*bad, TS=2, L=2048, K=10, k1=1.2,
                                  b=0.75, filtered=True, probe=True)
