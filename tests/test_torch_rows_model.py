"""A CPU model of the row machinery of opensearch_tpu_torch/csrc/bm25_rows.cuh,
held bit for bit against the plain versions of ops/bm25.py.

The model follows the kernel step for step: each slot's window cut to the
row's [dlo, dhi) and to its doc sub-range (S sub-ranges cut at docs of the
longest slot); per-slot tile budgets; tiles cut at one doc (the least, over
the slots with a full budget left, of the doc at cursor + B_t - 1), each
slot taking its postings up to it; the pairwise merge rounds with ties to
the lower slot, or, when the tile's docs span less than `span`, the
table tile (each doc's sums taken slot after slot); the leader (the lowest
slot holding the doc) summing contributions and count weights in slot
order in f32; in B3's probe form, the leader's filter bit read from the
bitmap (when it can decide the doc) and, where set, the filter's count
weight and 0.0 added last; the candidate buffer against the
running K-th entry, merged when it reaches `cand` after a step of
`threads` elements and at the end; the last block's merge of the S
partials through the same buffer. It takes the tile budget and the split
as parameters, so small budgets force many tiles per row. Contributions
are the plain versions' f32 expressions; the model's own arithmetic is the
slot-order f32 sums. Model and plain must agree exactly: scores, ids and
totals.
"""

from bisect import bisect_left, bisect_right

import numpy as np
import pytest
import torch

from opensearch_tpu_torch.ops import bm25
from opensearch_tpu_torch.ops.scoring import posting_contrib

SENT = 2**31 - 1
NONE = (float("-inf"), SENT)
F32 = np.float32


class Params:
    """The kernel's constants, shrunk: `tile` postings per tile, `min_b`
    least per-slot budget, `threads` elements per step, `cand` candidates
    that trigger a merge, `split` sub-ranges per row, `span` the widest
    doc span of a table tile."""

    def __init__(self, tile, min_b, threads, cand, split, span):
        self.tile, self.min_b = tile, min_b
        self.threads, self.cand, self.split = threads, cand, split
        self.span = span


def better(a, b):
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


class TopK:
    """The running top K, its threshold and the candidate buffer."""

    def __init__(self, K, cand):
        self.K, self.cap = K, cand
        self.top, self.cand = [], []
        self.thr = NONE
        self.merges = 0

    def offer(self, e):
        if better(e, self.thr):
            self.cand.append(e)

    def step_end(self):
        if len(self.cand) >= self.cap:
            self.merge()

    def merge(self):
        if not self.cand:
            return
        self.merges += 1
        self.top = sorted(self.top + self.cand,
                          key=lambda e: (-e[0], e[1]))[:self.K]
        self.cand = []
        self.thr = self.top[-1] if len(self.top) == self.K else NONE


def merge_rounds(lists):
    """log2(T) rounds of stable pairwise merges by doc, the lower slot
    group first on a tie."""
    while len(lists) > 1:
        nxt = []
        for a, b in zip(lists[0::2], lists[1::2]):
            out, i, j = [], 0, 0
            while i < len(a) or j < len(b):
                if j >= len(b) or (i < len(a) and a[i][0] <= b[j][0]):
                    out.append(a[i])
                    i += 1
                else:
                    out.append(b[j])
                    j += 1
            nxt.append(out)
        lists = nxt
    return lists[0]


def probe_of(bits, cwf, msm):
    """The probe form's filter at a leader, as the kernel applies it: the
    bit is read only when it can decide the doc; on a hit the count takes
    cwf and the score adds 0.0."""
    def apply(d, acc, cnt):
        with_f = F32(cnt + cwf)
        if not (with_f >= msm or cnt >= msm):
            return acc, cnt
        if (int(bits[d >> 5]) >> (d & 31)) & 1:
            return F32(acc + F32(0.0)), with_f
        return acc, cnt
    return apply


def walk(slots, cws, msm, K, p, stats, probe=None):
    """One block's (row, sub-range): slots[t] = (docs, contributions) of
    its valid postings; `probe` the row's probe_of (None: no probe). ->
    (top K entries, count of passing docs). Adds to `stats`: tiles, table
    tiles, slots exhausted while another slot had postings left, the
    longest doc run (slots holding one doc), top-K merges."""
    T = len(slots)
    n = [len(d) for d, _ in slots]
    tot = sum(n)
    top = TopK(K, p.cand)
    passed = 0
    if tot == 0:
        return top.top, passed
    B = [p.min_b + (p.tile - T * p.min_b) * nt // tot if nt else 0
         for nt in n]
    cur = [0] * T
    while any(cur[t] < n[t] for t in range(T)):
        full = [slots[t][0][cur[t] + B[t] - 1] for t in range(T)
                if B[t] and n[t] - cur[t] >= B[t]]
        cut = min(full) if full else SENT
        lists = []
        for t in range(T):
            ring = slots[t][0][cur[t]:min(cur[t] + B[t], n[t])]
            take = len(ring) if cut == SENT else bisect_right(ring, cut)
            lists.append([(int(ring[i]), t, cur[t] + i)
                          for i in range(take)])
            cur[t] += take
        assert sum(map(len, lists)) <= p.tile
        stats["tiles"] += 1
        left = sum(n[t] - cur[t] for t in range(T))
        stats["exhausted_mid"] += sum(
            1 for t in range(T)
            if lists[t] and cur[t] == n[t] and left > 0)
        flat = [e for lst in lists for e in lst]
        m = len(flat)
        docs = [e[0] for e in flat]
        if max(docs) - min(docs) < p.span:
            # table tile: slot after slot, each doc's sums in slot order;
            # the lowest slot holding the doc leads
            stats["table_tiles"] += 1
            table = {}
            for d, t, j in flat:
                if d not in table:
                    table[d] = [t, slots[t][1][j], cws[t], 1]
                else:
                    e = table[d]
                    e[1] = F32(e[1] + slots[t][1][j])
                    e[2] = F32(e[2] + cws[t])
                    e[3] += 1
            stats["max_run"] = max(stats["max_run"],
                                   max(e[3] for e in table.values()))
            for base in range(0, m, p.threads):
                for d, t, _ in flat[base:base + p.threads]:
                    lead, acc, cnt, _ = table[d]
                    if lead != t:
                        continue
                    if probe is not None:
                        acc, cnt = probe(d, acc, cnt)
                    if cnt >= msm:
                        passed += 1
                        top.offer((float(acc), d))
                top.step_end()
            continue
        tile = merge_rounds(lists)
        for base in range(0, m, p.threads):
            for i in range(base, min(base + p.threads, m)):
                d, t, j = tile[i]
                if i > 0 and tile[i - 1][0] == d:
                    continue
                acc, cnt = slots[t][1][j], cws[t]
                k = i + 1
                while k < m and tile[k][0] == d:
                    u, ju = tile[k][1], tile[k][2]
                    acc = F32(acc + slots[u][1][ju])
                    cnt = F32(cnt + cws[u])
                    k += 1
                stats["max_run"] = max(stats["max_run"], k - i)
                if probe is not None:
                    acc, cnt = probe(d, acc, cnt)
                if cnt >= msm:
                    passed += 1
                    top.offer((float(acc), d))
            top.step_end()
    top.merge()
    stats["merges"] += top.merges
    return top.top, passed


def sub_ranges(docs, S):
    """Per sub-range, per slot: (lo, e) positions, cut at docs of the
    longest slot (the lowest such slot on a tie)."""
    n = [len(d) for d in docs]
    m = max(range(len(n)), key=lambda t: (n[t], -t))
    out = []
    for sub in range(S):
        if n[m] == 0:
            out.append([(0, 0)] * len(n))
            continue
        c_lo = int(docs[m][sub * n[m] // S]) if sub > 0 else None
        c_hi = int(docs[m][(sub + 1) * n[m] // S]) if sub < S - 1 else None
        out.append([(0 if c_lo is None else bisect_left(d, c_lo),
                     len(d) if c_hi is None else bisect_left(d, c_hi))
                    for d in docs])
    return out


def model(kind, bufs, rows, T, L, K, p, TS=0, stats=None, probe=False):
    """The kernel's results for `rows` of contribution `kind` ("tfdl",
    "impact", "norms", "bool"; with `probe`, B3's probe form: T = TS term
    slots, cw [QB, TS + 1] and the filter's bitmap bufs["bits"]): (scores
    f32[QB, 128], ids i32[QB, 128], totals i32[QB, 128]). `stats` collects
    walk()'s counts."""
    if stats is None:
        stats = {}
    for k in ("tiles", "table_tiles", "exhausted_mid", "max_run", "merges"):
        stats.setdefault(k, 0)
    rowstarts, nrows, lens, skips, weights, msm, avgdl, dlo, dhi, cw = rows
    docs, vals, filt = bufs["docs"], bufs[kind], bufs["filt"]
    QB = rowstarts.shape[0]
    scores = np.full((QB, 128), -np.inf, np.float32)
    ids = np.full((QB, 128), -1, np.int32)
    totals = np.zeros((QB, 128), np.int32)
    for q in range(QB):
        wins = []
        for t in range(T):
            is_f = kind == "bool" and not probe and t == TS
            src = filt if is_f else docs
            start = int(rowstarts[q, t]) * 128
            sk = int(skips[q, t])
            hi = min(sk + int(lens[q, t]), int(nrows[q, t]) * 128, L,
                     len(src) - start)
            w = src[start + sk:start + max(hi, sk)]
            lo = bisect_left(w, int(dlo[q, 0]))
            e = bisect_left(w, int(dhi[q, 0]))
            at = np.arange(start + sk + lo, start + sk + e)
            wt = float(weights[q, t]) if t < weights.shape[1] else 0.0
            if is_f:
                c = np.zeros(len(at), np.float32)
            elif kind in ("tfdl", "bool"):
                pk = torch.from_numpy(vals[at])
                tf = ((pk >> bm25.DL_BITS) & bm25.TF_MAX).to(torch.float32)
                dl = (pk & bm25.DL_MASK).to(torch.float32)
                c = posting_contrib(tf, dl, torch.tensor(wt, dtype=torch.float32),
                                    1.2, 0.75, torch.tensor(avgdl[q, 0])).numpy()
            elif kind == "impact":
                c = F32(wt) * vals[at].astype(np.float32)
            else:
                c = F32(wt) * vals[at]
            wins.append((w[lo:e], c))
        cws = [F32(cw[q, t]) if cw is not None else F32(1.0)
               for t in range(T)]
        parts = []
        for rng_t in sub_ranges([d for d, _ in wins], p.split):
            slots = [(d[lo:e], c[lo:e])
                     for (d, c), (lo, e) in zip(wins, rng_t)]
            parts.append(walk(slots, cws, F32(msm[q, 0]), K, p, stats,
                              probe_of(bufs["bits"], F32(cw[q, TS]),
                                       F32(msm[q, 0])) if probe else None))
        if p.split == 1:
            top, total = parts[0]
        else:
            # the last block: the S partials, padded to K, through the
            # candidate buffer
            merged = TopK(K, p.cand)
            flat = [e for pt, _ in parts for e in pt + [NONE] * (K - len(pt))]
            for base in range(0, len(flat), p.threads):
                for e in flat[base:base + p.threads]:
                    if e[0] > float("-inf"):
                        merged.offer(e)
                merged.step_end()
            merged.merge()
            top, total = merged.top, sum(c for _, c in parts)
        for i, (s, d) in enumerate(top):
            scores[q, i], ids[q, i] = s, d
        totals[q] = total
    return scores, ids, totals


# ---------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------

COMMON = (7, 777, 1500, 2222)      # docs in every term and in the filter


def buffers(seed, ties=False, ndocs=3000):
    """Aligned CSR postings of 16 terms (dfs from 3 to 2,600, each holding
    the COMMON docs) with all four payloads, and a filter list of other
    length. `ties`: one payload value for every posting (mass ties)."""
    rng = np.random.default_rng(seed)
    dfs = [2600, 2200, 1800, 1300, 900, 700, 500, 300, 200, 150, 90, 40,
           20, 9, 5, 3]
    lists = [np.union1d(rng.choice(ndocs, d, replace=False), COMMON)
             for d in dfs]
    starts = np.zeros(len(lists) + 1, np.int64)
    np.cumsum([len(x) for x in lists], out=starts[1:])
    docs = np.concatenate(lists).astype(np.int32)
    tfs = rng.integers(1, 12, len(docs)).astype(np.int64)
    tfs[::11] = rng.integers(1024, 2048, len(tfs[::11]))
    dls = rng.integers(3, 400, ndocs).astype(np.int64)
    packed = ((tfs << bm25.DL_BITS) | dls[docs]).astype(np.int32)
    imp = rng.integers(0, 1 << 16, len(docs)).astype(np.int32)
    norms = rng.uniform(0.01, 0.99, len(docs)).astype(np.float32)
    if ties:
        packed[:] = (3 << bm25.DL_BITS) | 100
        imp[:] = 4321
        norms[:] = np.float32(0.25)
    a_starts, a_docs, a_packed, a_imp, a_norms = bm25.align_csr_rows(
        starts, docs, packed, imp, norms, margin=1 << 12, alignment=1024)
    fdocs = np.union1d(rng.choice(ndocs, ndocs // 3, replace=False),
                       COMMON).astype(np.int32)
    filt = np.full(((len(fdocs) + 127) // 128) * 128 + (1 << 12), SENT,
                   np.int32)
    filt[:len(fdocs)] = fdocs
    mask = np.zeros(ndocs, bool)
    mask[fdocs] = True
    return {"docs": a_docs, "tfdl": a_packed, "bool": a_packed,
            "impact": a_imp, "norms": a_norms, "filt": filt,
            "bits": bm25.pack_bits(torch.from_numpy(mask)).numpy(),
            "starts": a_starts, "dfs": [len(x) for x in lists],
            "nfilt": len(fdocs)}


def _window(abs_el, avail, L):
    dma = (abs_el // 1024) * 1024
    skip = abs_el - dma
    ln = min(avail, L - skip)
    nr = max(8, 1 << (max(-(-(skip + ln) // 128), 1) - 1).bit_length())
    return dma // 128, nr, ln, skip


def case_rows(seed, bufs, kind, T, L, QB, TS=0):
    """QB rows by pattern q % 6: every slot a long term (many tiles in
    every slot); long terms with one short slot (exhausted mid-tile);
    a [dlo, dhi) cut; zero weights (every score 0); absent slots and
    short terms with msm = T (fewer passers than K); every slot the same
    term list of the COMMON docs' terms (a doc in every slot). Bool rows
    (T = 2 TS with the filter slot TS) carry count weights and thresholds
    at the pass edge, every 4th one past it."""
    rng = np.random.default_rng(seed)
    starts, dfs = bufs["starts"], bufs["dfs"]
    shape = (QB, T)
    rowstarts, nrows, lens, skips = (np.zeros(shape, np.int32)
                                     for _ in range(4))
    nw = TS if kind == "bool" else T
    weights = rng.uniform(0.2, 3.0, (QB, nw)).astype(np.float32)
    msm = np.ones((QB, 1), np.float32)
    dlo = np.zeros((QB, 1), np.int32)
    dhi = np.full((QB, 1), SENT, np.int32)
    cw = np.ones(shape, np.float32) if kind == "bool" else None
    for q in range(QB):
        pat = q % 6
        for t in range(T):
            if kind == "bool" and t == TS:
                off = int(rng.integers(0, 40)) if pat != 5 else 0
                rowstarts[q, t], nrows[q, t], lens[q, t], skips[q, t] = \
                    _window(off, bufs["nfilt"] - off, L)
                continue
            if pat == 4 and rng.random() < 0.4:
                continue                               # absent slot
            r = {0: int(rng.integers(0, 4)),
                 1: 13 if t == T - 1 else int(rng.integers(0, 3)),
                 2: int(rng.integers(0, 8)),
                 3: int(rng.integers(0, 16)),
                 4: int(rng.integers(10, 16)),
                 5: t % 16}[pat]
            off = int(rng.integers(0, 3)) if pat != 5 else 0
            rowstarts[q, t], nrows[q, t], lens[q, t], skips[q, t] = _window(
                int(starts[r]) + off, dfs[r] - off, L)
        if pat == 2:
            dlo[q, 0] = int(rng.integers(100, 1200))
            dhi[q, 0] = dlo[q, 0] + int(rng.integers(200, 1500))
        if pat == 3:
            weights[q] = 0.0
        if pat == 4:
            msm[q, 0] = float(T)
        if pat == 1 and kind != "bool":
            msm[q, 0] = 2.0
    if kind == "bool":
        # required / family / bonus count weights and the filter slot
        for q in range(QB):
            kinds = rng.choice(["req", "fam", "bonus"], T)
            n_req = fam = 0
            for t in range(T):
                k = "req" if t == TS else str(kinds[t])
                cw[q, t] = {"req": bm25.REQ_W, "fam": 1.0, "bonus": 0.0}[k]
                n_req += k == "req"
                fam += k == "fam"
            msm[q, 0] = bm25.REQ_W * n_req + min(fam, 1 + q % 2)
            if q % 4 == 3:
                msm[q, 0] += 1.0                       # just past the edge
    avgdl = np.full((QB, 1), np.float32(97.3), np.float32)
    return rowstarts, nrows, lens, skips, weights, msm, avgdl, dlo, dhi, cw


def probe_form(rows, TS):
    """B3's probe form of case_rows' bool rows: the term slots, the count
    weights [QB, TS + 1] with the filter's last, and thresholds of those
    weights (required slots and the filter, the family's msm 1 or 2,
    every 4th row one past the edge)."""
    rows = list(rows)
    cw = rows[9]
    for i in range(4):
        rows[i] = rows[i][:, :TS].copy()
    rows[9] = np.concatenate([cw[:, :TS], cw[:, TS:TS + 1]], axis=1)
    n_req = (cw[:, :TS] == bm25.REQ_W).sum(axis=1)
    fam = (cw[:, :TS] == 1.0).sum(axis=1)
    q = np.arange(cw.shape[0])
    msm = bm25.REQ_W * (n_req + 1) + np.minimum(fam, 1 + q % 2)
    rows[5] = (msm + (q % 4 == 3)).astype(np.float32)[:, None]
    return rows


def plain(kind, bufs, rows, T, L, K, TS=0, probe=False):
    rowstarts, nrows, lens, skips, weights, msm, avgdl, dlo, dhi, cw = [
        None if a is None else torch.from_numpy(a) for a in rows]
    d = torch.from_numpy(bufs["docs"])
    v = torch.from_numpy(bufs[kind])
    if kind == "tfdl":
        out = bm25.fused_bm25_topk_tfdl_plain(
            d, v, rowstarts, nrows, lens, skips, weights, msm, avgdl, dlo,
            dhi, T, L, K, 1.2, 0.75)
    elif kind == "impact":
        out = bm25.fused_bm25_topk_impact_plain(
            d, v, rowstarts, nrows, lens, skips, weights, msm, dlo, dhi, T,
            L, K)
    elif kind == "norms":
        # fused_bm25_topk's windows are rows of the same machinery (the
        # wrapper's mapping); their plain version is the same _plain
        out = bm25._plain(d, v, rowstarts, nrows, lens, skips, weights, msm,
                          dlo, dhi, T, L, K, lambda p, w, _rows: w * p)
    else:
        filt = bufs["bits" if probe else "filt"]
        out = bm25.fused_bm25_bool_topk_plain(
            d, v, torch.from_numpy(filt), rowstarts, nrows, lens, skips,
            weights, cw, msm, avgdl, dlo, dhi, TS, L, K, 1.2, 0.75, True,
            probe)
    return [o.numpy() for o in out]


# T per kernel: a one-slot, a two-slot and an eight-slot launch; bool
# launches have TS term slots plus the filter slot (T = 2 TS, up to 16)
SHAPES = {"tfdl": (1, 2, 8), "impact": (1, 2, 8), "norms": (1, 2, 8),
          "bool": (1, 2, 8)}


@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("B", [4, 8, 16])
@pytest.mark.parametrize("kind", ["tfdl", "impact", "bool", "norms"])
def test_model_equals_plain(kind, B, S):
    seed = 1000 * B + 10 * S + len(kind)
    L = 512
    for ties in (False, True):
        bufs = buffers(seed, ties=ties)
        for i, t in enumerate(SHAPES[kind]):
            TS = t if kind == "bool" else 0
            T = 2 * t if kind == "bool" else t
            QB = 6
            # per-slot budgets of about B to 2 B postings, steps of B
            # elements, a merge every B candidates
            p = Params(tile=2 * B * T, min_b=B, threads=max(B, 4), cand=B,
                       split=S, span=16 * B)
            rows = case_rows(seed + i, bufs, kind, T, L, QB, TS)
            for K in (1, 128) if i % 2 == 0 else (128, 1):
                want = plain(kind, bufs, rows, T, L, K, TS)
                got = model(kind, bufs, rows, T, L, K, p, TS)
                for g, w, name in zip(got, want, ("scores", "ids",
                                                  "totals")):
                    np.testing.assert_array_equal(
                        g, w, err_msg=f"{name} ties={ties} T={T} K={K}")


@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("B", [4, 8, 16])
def test_model_probe_equals_plain(B, S):
    """B3's probe form (term slots, the filter's bitmap read at leaders):
    model == plain bit for bit, scores compared as their bits."""
    seed = 3000 + 100 * B + S
    L = 512
    for ties in (False, True):
        bufs = buffers(seed, ties=ties)
        for i, TS in enumerate((1, 2, 8)):
            p = Params(tile=2 * B * TS, min_b=B, threads=max(B, 4), cand=B,
                       split=S, span=16 * B)
            rows = probe_form(case_rows(seed + i, bufs, "bool", 2 * TS, L, 6,
                                        TS), TS)
            for K in (1, 128) if i % 2 == 0 else (128, 1):
                want = plain("bool", bufs, rows, TS, L, K, TS, probe=True)
                got = model("bool", bufs, rows, TS, L, K, p, TS, probe=True)
                np.testing.assert_array_equal(
                    got[0].view(np.int32), want[0].view(np.int32),
                    err_msg=f"scores ties={ties} TS={TS} K={K}")
                for g, w, name in zip(got[1:], want[1:], ("ids", "totals")):
                    np.testing.assert_array_equal(
                        g, w, err_msg=f"{name} ties={ties} TS={TS} K={K}")
                assert want[2][:, 0].any()


def test_model_reaches_its_edges():
    """The cases force what the design has to get right: many tiles per
    row, slots exhausted while others go on, a doc in all 16 slots, mass
    ties at the K-th score, fewer passers than K, top-K merges."""
    bufs = buffers(5, ties=True)
    T, TS, L, QB = 16, 8, 512, 12
    rows = case_rows(6, bufs, "bool", T, L, QB, TS)
    stats = {}
    p = Params(tile=2 * 4 * T, min_b=4, threads=4, cand=4, split=4,
               span=64)
    got = model("bool", bufs, rows, T, L, 128, p, TS, stats)
    want = plain("bool", bufs, rows, T, L, 128, TS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert stats["max_run"] == 16, stats        # doc 7 in every slot
    assert stats["tiles"] > 10 * QB * 4, stats
    assert stats["exhausted_mid"] > 0 and stats["merges"] > 0, stats
    # both tile kinds: table tiles and merge tiles
    assert 0 < stats["table_tiles"] < stats["tiles"], stats
    # ties at the K-th score: rows of one payload value, equal weights
    bufs = buffers(7, ties=True)
    rows = list(case_rows(8, bufs, "impact", 2, L, 6))
    rows[4] = np.ones_like(rows[4])
    got = model("impact", bufs, rows, 2, L, 128,
                Params(tile=16, min_b=4, threads=4, cand=4, split=4,
                       span=32))
    full = got[2][:, 0] > 128
    assert full.any() and (got[0][full, 126] == got[0][full, 127]).all()
    # fewer passers than K, and rows nothing passes
    bufs = buffers(9)
    rows = case_rows(10, bufs, "tfdl", 1, L, 12)
    got = model("tfdl", bufs, rows, 1, L, 128,
                Params(tile=64, min_b=4, threads=4, cand=4, split=2,
                       span=64))
    tot = got[2][:, 0]
    assert ((tot > 0) & (tot < 128)).any(), tot


@pytest.mark.parametrize("QB,T,L,resident,want", [
    (27728, 8, 16384, 396, 1),     # a dense launch: one block per row
    (32, 8, 8192, 396, 8),         # a frontier launch of head rows
    (1, 8, 16384, 396, 32),        # one row: MAX_SPLIT
    (1, 1, 1024, 396, 1),          # less than two tiles of window
    (8, 4, 32768, 396, 32),
    (64, 2, 65536, 396, 4),
    (200, 8, 16384, 396, 1),
])
def test_split_rows(QB, T, L, resident, want):
    S = bm25.split_rows(QB, T, L, resident)
    assert S == want
    assert S & (S - 1) == 0 and S <= bm25.MAX_SPLIT
    assert QB * S <= resident or S == 1
