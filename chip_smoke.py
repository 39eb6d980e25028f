#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (opensearch_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--ndocs N] [--queries Q] [--bool-queries B]
                          [--general-queries G] [--seed S]

Phases, each of which fails the script when it fails:
  1. card: name, power limit, torch and CUDA versions;
  2. build: every CUDA source of the port, compiled with nvcc for sm_90a,
     one nvcc per library, all started together;
  3. kernel vs plain: fused_bm25_topk_tfdl, fused_bm25_topk_impact,
     fused_bm25_bool_topk and fused_bm25_topk against their plain PyTorch
     versions on the card over a grid of shapes, B3's two filter forms
     (list and probe) on the same logical rows, then over edge points of
     the row machinery (rows of many tiles in every slot, mass ties,
     zero weights, fewer passers than K, launches of 1 and 8 rows that
     split each row over blocks); results must be equal bit for bit;
  4. slice, small: the same bulk and queries, term groups, bool bodies
     and bodies the kernels decline (then a re-indexed _id), through
     RestClient on the card and on the CPU over codec-v2 segments, with a
     term whose row exceeds L_HEAD; responses must be identical apart
     from `took`, the verify and candidate-union rungs must each serve a
     query, each bool route a body, and the impact rung and the general
     path a body each;
  5. slice at MS MARCO passage scale: a synthetic corpus of --ndocs
     passages attached as one codec-v2 segment, searched with
     RestClient.msearch twice: the pruned match ladder (the default
     bodies) and the dense path (the same bodies with track_total_hits);
     kernel groups of the first batch timed and held against the plain
     versions, the device phase-2 rescore held against the host oracle,
     and sampled bodies on the card held against the CPU;
  6. bool traffic over the same segment, with bench.py's status keyword
     and price integer columns: the guardrail mix (bench.py's second
     configuration, after one warm pass over its three filters) and the
     b3 mix (shapes that keep every query on the bool kernel), each run
     with default totals and with track_total_hits; the bool kernel's
     launches of the warm pass and its groups of the first b3 batch held
     against the plain version and timed, sampled bodies on the card held
     against the CPU, default pages against exact pages, and bodies
     against a numpy brute force;
  7. the general path and the impact rung over the same segment: bodies
     the fused kernels decline, --general-queries of each class (match_all
     from 0 and from 1000, a ~1% price range, a 9-term match with
     stopword-class terms with default and with exact totals, a 2-term
     match at from 200, a mixed-field bool, a should holding a nested bool
     and a range), then re-indexed _ids and phase 5's match bodies over
     the segments with deletes; every page against a numpy brute force,
     sampled bodies on the card against the CPU, the rung counts, the
     ops' times per body and the device arrays' bytes.
Every timed kernel reports device ms (the card's time alone: calls queued
behind a sleep kernel, `device_ms`) and call ms (events around one whole
call, the wrapper's host work inside). Then a line with phase 7's
numbers, a line with the kernels' numbers and, last, the device line.
Exits non-zero without a device line when no card is visible.
`--stop-after N` ends after phase N (a quick build-and-check run); it
prints neither result line.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 peak
NDOCS_MSMARCO = 8_800_000
BATCH = 64                     # msearch bodies per request in phase 5
RUNGS = ("pruned_served", "pruned_rescued", "pruned_rescued2",
         "pruned_dview", "pruned_escalated", "impact_frontier",
         "shard_view_served")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Call ms: median milliseconds of `fn` over `reps` runs, CUDA events
    around each whole call (the host's work inside), after one warm-up
    run."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


@functools.lru_cache(maxsize=None)
def _sleep_cycles_per_ms() -> float:
    """Cycles of torch.cuda._sleep per millisecond on this card (timed
    once with events)."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    return 10_000_000 / a.elapsed_time(b)


def device_ms(fn, n: int) -> float:
    """Device ms: the card's milliseconds per call of `fn`, the host's
    work hidden. A sleep kernel holds the stream while n calls are queued
    behind it (their arguments made before, outside), so the card runs
    them back to back between two events; the span over n. The sleep is
    doubled until the card had not reached the first call when the host
    queued the last."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_ms = 2.0 * n * host_ms + 1.0
    for _ in range(6):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_ms * _sleep_cycles_per_ms()))
        a.record()
        for _ in range(n):
            fn()
        b.record()
        queued = not a.query()
        b.synchronize()
        if queued:
            return a.elapsed_time(b) / n
        sleep_ms *= 2
    raise AssertionError("device_ms: the card caught up with the host")


def kernel_ms(fn, n: int) -> tuple:
    """(device ms, call ms) of a kernel's wrapper call `fn`."""
    return device_ms(fn, n), cuda_ms(fn, n)


def group_sums(what: str, groups: list) -> dict:
    """The largest of a batch's kernel groups (by bound), with the group
    count, the rows and the sums of device, call, plain and bound ms over
    all of them; logged. `ms` is device ms."""
    out = dict(max(groups, key=lambda g: g["bound_ms"]))
    out.update(groups=len(groups), rows=sum(g["QB"] for g in groups),
               sum_ms=sum(g["ms"] for g in groups),
               sum_call_ms=sum(g["call_ms"] for g in groups),
               sum_plain_ms=sum(g["plain_ms"] for g in groups),
               sum_bound_ms=sum(g["bound_ms"] for g in groups))
    log(f"  {what}: {len(groups)} groups, {out['rows']} rows: device_ms "
        f"sum={out['sum_ms']:.4f} call_ms sum={out['sum_call_ms']:.4f} "
        f"plain_ms sum={out['sum_plain_ms']:.3f} bound_ms sum="
        f"{out['sum_bound_ms']:.4f}; largest group QB={out['QB']} "
        f"device_ms={out['ms']:.4f} call_ms={out['call_ms']:.4f} "
        f"bound_ms={out['bound_ms']:.4f}")
    return out


def valid_postings(docs, rowstarts, nrows, lens, skips, dlo, dhi, L) -> int:
    """Postings the kernel must read for these rows (host count). A slot's
    window holds one term's postings, doc-ascending, so the count in
    [dlo, dhi) is the difference of two binary searches."""
    n = 0
    for q, t in zip(*np.nonzero(nrows)):
        start = int(rowstarts[q, t]) * 128
        sk = int(skips[q, t])
        hi = min(sk + int(lens[q, t]), int(nrows[q, t]) * 128, L)
        if hi <= sk:
            continue
        w = docs[start + sk:start + hi]
        n += int(np.searchsorted(w, dhi[q, 0]) - np.searchsorted(w, dlo[q, 0]))
    return n


def bound_ms(n_valid: int, QB: int) -> tuple:
    nbytes = 8 * n_valid + 12 * 128 * QB
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


# ---------------------------------------------------------------------
# phase 3: kernel vs plain over a grid
# ---------------------------------------------------------------------

def random_csr(rng, ndocs: int, nterms: int):
    """CSR rows with dfs from 1 to ndocs/2, docs ascending, tf mostly
    small with every 97th posting at tf >= 1024 (the packed word's sign
    bit set)."""
    dfs = np.minimum(np.exp(rng.uniform(0, np.log(ndocs / 2), nterms)),
                     ndocs // 2).astype(np.int64) + 1
    starts = np.zeros(nterms + 1, np.int64)
    np.cumsum(dfs, out=starts[1:])
    docs = np.concatenate([np.sort(rng.choice(ndocs, d, replace=False))
                           for d in dfs]).astype(np.int32)
    tfs = rng.integers(1, 30, len(docs)).astype(np.int64)
    tfs[::97] = rng.integers(1024, 2048, len(tfs[::97]))
    dls = rng.integers(8, 300, ndocs).astype(np.int64)
    packed = ((tfs << 21) | dls[docs]).astype(np.int32)
    return starts, docs, packed


def window_at(abs_el: int, avail: int, L: int) -> tuple:
    """(rowstart, nrows, len, skip) of a window over `avail` postings at
    element `abs_el` of an aligned buffer, starting at the 1024 tile below
    it, as the host planner cuts it."""
    dma = (abs_el // 1024) * 1024
    skip = abs_el - dma
    ln = min(avail, L - skip)
    nr = max(8, 1 << int(np.ceil(np.log2(-(-(skip + ln) // 128)))))
    return dma // 128, nr, ln, skip


def grid_rows(rng, starts, a_starts, QB, T, L):
    """QB kernel rows of T slots: partial windows spilling from the tile
    below, absent slots, partial [dlo, dhi) ranges, msm in {1, T}."""
    nterms = len(starts) - 1
    shape = (QB, T)
    rowstarts, nrows, lens, skips = (np.zeros(shape, np.int32)
                                     for _ in range(4))
    for q in range(QB):
        for t in range(T):
            if rng.random() < 0.15:
                continue                      # absent slot
            r = int(rng.integers(0, nterms))
            df = int(starts[r + 1] - starts[r])
            off = int(rng.integers(0, max(df // 4, 1)))
            rowstarts[q, t], nrows[q, t], lens[q, t], skips[q, t] = \
                window_at(int(a_starts[r]) + off, df - off, L)
    weights = rng.uniform(0.1, 5.0, shape).astype(np.float32)
    msm = np.where(np.arange(QB) % 2 == 0, 1.0, float(T)).astype(
        np.float32)[:, None]
    avgdl = np.full((QB, 1), 57.3, np.float32)
    dlo = np.zeros((QB, 1), np.int32)
    dhi = np.full((QB, 1), 2**31 - 1, np.int32)
    part = np.arange(QB) % 3 == 1
    dlo[part, 0] = rng.integers(0, 50_000, part.sum())
    dhi[part, 0] = dlo[part, 0] + rng.integers(1, 100_000, part.sum())
    return rowstarts, nrows, lens, skips, weights, msm, avgdl, dlo, dhi


def _check_equal(got, want, what: str) -> float:
    """Raise unless kernel and plain outputs are equal bit for bit (scores
    compared as their bits: +0.0 is not -0.0); returns the largest |score
    difference| over finite lanes (0.0)."""
    import torch
    for g, w, name in zip(got, want, ("scores", "ids", "totals")):
        if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
            bad = (g != w).nonzero()[:4].tolist()
            raise AssertionError(f"kernel != plain ({name}) at {what}: "
                                 f"first differing [row, lane] {bad}")
    fin = torch.isfinite(want[0])
    return (float((got[0][fin] - want[0][fin]).abs().max())
            if fin.any() else 0.0)


def phase_kernel_grid(dev, rng) -> dict:
    import torch
    from opensearch_tpu_torch.ops import bm25

    starts, docs, packed = random_csr(rng, 200_000, 120)
    a_starts, a_docs, a_packed = bm25.align_csr_rows(
        starts, docs, packed, margin=1 << 17, alignment=128)
    d_docs = torch.from_numpy(a_docs).to(dev)
    d_tfdl = torch.from_numpy(a_packed).to(dev)
    worst = 0.0
    points = 0
    for T in (1, 2, 4, 8):
        for L in sorted({1024, 8192, (1 << 17) // T}):
            host = grid_rows(rng, starts, a_starts[:-1], 64, T, L)
            args = [torch.from_numpy(a).to(dev) for a in host]
            for K in (10, 128):
                def kern():
                    return bm25.fused_bm25_topk_tfdl(
                        d_docs, d_tfdl, *args, T=T, L=L, K=K, k1=1.2, b=0.75)

                def plain():
                    return bm25.fused_bm25_topk_tfdl_plain(
                        d_docs, d_tfdl, *args, T=T, L=L, K=K, k1=1.2,
                        b=0.75)
                before = bm25.COUNTS["launches"]
                got = kern()
                want = plain()
                torch.cuda.synchronize()
                launches = bm25.COUNTS["launches"] - before
                worst = max(worst, _check_equal(got, want,
                                                f"T={T} L={L} K={K}"))
                nv = valid_postings(a_docs, *host[:4], host[7], host[8], L)
                b_ms, nbytes = bound_ms(nv, 64)
                d_ms, c_ms = kernel_ms(kern, 20)
                p_ms = cuda_ms(plain, 3)
                points += 1
                log(f"  tfdl   T={T} L={L:6d} K={K:3d} QB=64 equal=yes "
                    f"device_ms={d_ms:.4f} call_ms={c_ms:.4f} "
                    f"plain_ms={p_ms:.4f} "
                    f"bound_ms={b_ms:.5f} bytes={nbytes} "
                    f"valid_postings={nv} launches={launches}")
    return {"points": points, "max_abs_err": worst}


def phase_impact_grid(dev, rng) -> dict:
    """fused_bm25_topk_impact == plain over T x L x K x QB: msm 1 and T,
    absent slots, skip prefixes, [dlo, dhi) rows (grid_rows), and a
    16-bit plane (q up to 65535, at K = 16) and an 8-bit one (q up to
    255, at K = 128) over the same postings."""
    import torch
    from opensearch_tpu_torch.ops import bm25

    starts, docs, packed = random_csr(rng, 200_000, 120)
    imp16 = rng.integers(0, 1 << 16, len(docs)).astype(np.int32)
    imp16[::97] = 65535
    imp8 = (imp16 >> 8).astype(np.int32)
    a_starts, a_docs, _a_packed, a16, a8 = bm25.align_csr_rows(
        starts, docs, packed, imp16, imp8, margin=1 << 17, alignment=128)
    d_docs = torch.from_numpy(a_docs).to(dev)
    planes = {16: torch.from_numpy(a16).to(dev),
              8: torch.from_numpy(a8).to(dev)}
    worst = 0.0
    points = 0
    for T in (1, 2, 4, 8):
        for L in sorted({1024, 4096, 32768 // T}):
            for QB in (64, 1024):
                host = grid_rows(rng, starts, a_starts[:-1], QB, T, L)
                host = list(host[:4]) + [
                    (host[4] / 65535.0).astype(np.float32), host[5],
                    host[7], host[8]]
                args = [torch.from_numpy(a).to(dev) for a in host]
                for K in (16, 128):
                    bits = 16 if K == 16 else 8
                    d_imp = planes[bits]

                    def kern():
                        return bm25.fused_bm25_topk_impact(
                            d_docs, d_imp, *args, T=T, L=L, K=K)

                    def plain():
                        return bm25.fused_bm25_topk_impact_plain(
                            d_docs, d_imp, *args, T=T, L=L, K=K)
                    before = bm25.COUNTS["impact_launches"]
                    got = kern()
                    want = plain()
                    torch.cuda.synchronize()
                    launches = bm25.COUNTS["impact_launches"] - before
                    worst = max(worst, _check_equal(
                        got, want, f"impact T={T} L={L} K={K} QB={QB}"))
                    nv = valid_postings(a_docs, *host[:4], host[6],
                                        host[7], L)
                    b_ms, nbytes = bound_ms(nv, QB)
                    d_ms, c_ms = kernel_ms(kern, 10)
                    p_ms = cuda_ms(plain, 3)
                    points += 1
                    log(f"  impact T={T} L={L:6d} K={K:3d} QB={QB:4d} "
                        f"u{bits} equal=yes device_ms={d_ms:.4f} "
                        f"call_ms={c_ms:.4f} "
                        f"plain_ms={p_ms:.4f} bound_ms={b_ms:.5f} "
                        f"bytes={nbytes} valid_postings={nv} "
                        f"launches={launches}")
    return {"points": points, "max_abs_err": worst}


REQ_W = 1024.0


def bool_grid_rows(rng, starts, a_starts, n_filt: int, QB: int, TS: int,
                   filtered: bool, L: int) -> list:
    """QB rows of B3: TS term slots (+ the filter slot TS over a filter
    list of n_filt docs). Per row one count-weight pattern (all required,
    required + a counted family, a family alone, required + bonus), its
    threshold at the pass edge (every 7th row one past it), absent slots,
    const-score rows without term slots (every 8th row when filtered),
    windows spilling from the tile below, partial [dlo, dhi) ranges."""
    nterms = len(starts) - 1
    T = 2 * TS if filtered else TS
    rowstarts, nrows, lens, skips = (np.zeros((QB, T), np.int32)
                                     for _ in range(4))
    weights = rng.uniform(0.1, 5.0, (QB, TS)).astype(np.float32)
    cw = np.zeros((QB, T), np.float32)
    thresh = np.zeros((QB, 1), np.float32)
    for q in range(QB):
        pattern = q % 4
        nt = (0 if filtered and q % 8 == 7
              else int(rng.integers(1, TS + 1)))
        n_req = fam = 0
        for t in range(nt):
            kind = ("req" if pattern == 0 or (pattern in (1, 3) and t == 0)
                    else "fam" if pattern in (1, 2) else "bonus")
            cw[q, t] = {"req": REQ_W, "fam": 1.0, "bonus": 0.0}[kind]
            n_req += kind == "req"
            fam += kind == "fam"
            if rng.random() < 0.15:
                continue                      # absent term: a dead slot
            r = int(rng.integers(0, nterms))
            df = int(starts[r + 1] - starts[r])
            off = int(rng.integers(0, max(df // 4, 1)))
            rowstarts[q, t], nrows[q, t], lens[q, t], skips[q, t] = \
                window_at(int(a_starts[r]) + off, df - off, L)
        if filtered:
            cw[q, TS] = REQ_W
            off = int(rng.integers(0, n_filt // 4))
            rowstarts[q, TS], nrows[q, TS], lens[q, TS], skips[q, TS] = \
                window_at(off, n_filt - off, L)
        thresh[q, 0] = (REQ_W * (n_req + filtered)
                        + (min(fam, 1 + q % 2) if fam else 0))
        if q % 7 == 6:
            thresh[q, 0] += 1.0
    avgdl = np.full((QB, 1), 57.3, np.float32)
    dlo = np.zeros((QB, 1), np.int32)
    dhi = np.full((QB, 1), 2**31 - 1, np.int32)
    part = np.arange(QB) % 3 == 1
    dlo[part, 0] = rng.integers(0, 50_000, part.sum())
    dhi[part, 0] = dlo[part, 0] + rng.integers(1, 100_000, part.sum())
    return [rowstarts, nrows, lens, skips, weights, cw, thresh, avgdl, dlo,
            dhi]


def bool_bound(a_docs, filt, host, TS: int, filtered: bool, L: int,
               probe: bool = False) -> tuple:
    """(bound ms, bytes, valid term postings, valid filter postings) of B3
    rows: 8 B per valid term posting, 4 B per valid filter posting of a
    filter slot (none for a probe: 8 B per term posting is a lower bound
    of any design), 12 B x 128 per row of output, over the card's memory
    rate."""
    rowstarts, nrows, lens, skips = host[:4]
    dlo, dhi = host[8], host[9]
    n_term = valid_postings(a_docs, rowstarts[:, :TS], nrows[:, :TS],
                            lens[:, :TS], skips[:, :TS], dlo, dhi, L)
    n_filt = (valid_postings(filt, rowstarts[:, TS:TS + 1],
                             nrows[:, TS:TS + 1], lens[:, TS:TS + 1],
                             skips[:, TS:TS + 1], dlo, dhi, L)
              if filtered and not probe else 0)
    nbytes = 8 * n_term + 4 * n_filt + 12 * 128 * rowstarts.shape[0]
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes, n_term, n_filt


def phase_bool_grid(dev, rng) -> dict:
    """fused_bm25_bool_topk == plain over TS x filtered x L x QB: the
    count-weight patterns, edge thresholds, const-score rows, dead slots,
    skips and doc windows of bool_grid_rows, the filter list in a buffer
    of another length than the postings."""
    import torch
    from opensearch_tpu_torch.ops import bm25

    starts, docs, packed = random_csr(rng, 200_000, 120)
    a_starts, a_docs, a_packed = bm25.align_csr_rows(
        starts, docs, packed, margin=1 << 17, alignment=128)
    fdocs = np.sort(rng.choice(200_000, 70_000, replace=False))
    filt = np.full(((len(fdocs) + 127) // 128) * 128 + (1 << 17),
                   2**31 - 1, np.int32)
    filt[:len(fdocs)] = fdocs
    d_docs = torch.from_numpy(a_docs).to(dev)
    d_tfdl = torch.from_numpy(a_packed).to(dev)
    d_filt = torch.from_numpy(filt).to(dev)
    worst = 0.0
    points = 0
    for TS in (1, 2, 4, 8):
        for filtered in (False, True):
            T = 2 * TS if filtered else TS
            for L in sorted({1024, (1 << 17) // T}):
                for QB in (64, 1024):
                    K = 128 if QB == 64 else 16
                    host = bool_grid_rows(rng, starts, a_starts[:-1],
                                          len(fdocs), QB, TS, filtered, L)
                    args = [torch.from_numpy(a).to(dev) for a in host]

                    def kern():
                        return bm25.fused_bm25_bool_topk(
                            d_docs, d_tfdl, d_filt, *args, TS=TS, L=L, K=K,
                            k1=1.2, b=0.75, filtered=filtered)

                    def plain():
                        return bm25.fused_bm25_bool_topk_plain(
                            d_docs, d_tfdl, d_filt, *args, TS=TS, L=L, K=K,
                            k1=1.2, b=0.75, filtered=filtered)
                    before = bm25.COUNTS["bool_launches"]
                    got = kern()
                    want = plain()
                    torch.cuda.synchronize()
                    launches = bm25.COUNTS["bool_launches"] - before
                    what = f"bool TS={TS} filtered={filtered} L={L} QB={QB}"
                    worst = max(worst, _check_equal(got, want, what))
                    passed = int((want[2][:, 0] > 0).sum())
                    b_ms, nbytes, n_t, n_f = bool_bound(
                        a_docs, filt, host, TS, filtered, L)
                    d_ms, c_ms = kernel_ms(kern, 10)
                    p_ms = cuda_ms(plain, 3)
                    points += 1
                    log(f"  bool   TS={TS} T={T:2d} L={L:6d} K={K:3d} "
                        f"QB={QB:4d} equal=yes rows_with_hits={passed} "
                        f"device_ms={d_ms:.4f} call_ms={c_ms:.4f} "
                        f"plain_ms={p_ms:.4f} "
                        f"bound_ms={b_ms:.5f} bytes={nbytes} "
                        f"term_postings={n_t} filter_postings={n_f} "
                        f"launches={launches}")
    return {"points": points, "max_abs_err": worst}


def has_probe() -> bool:
    """The package's B3 has the probe form (run against the slice before
    it, the probe points are skipped and say so)."""
    from opensearch_tpu_torch.ops import bm25
    return hasattr(bm25, "pack_bits")


def filter_window_rows(fdocs: np.ndarray, host: list, TS: int, L: int,
                       rng) -> None:
    """Set each list-form row's filter window (slot TS) to every filter
    doc of the row's [dlo, dhi), cutting dhi so that they fit the window,
    as the planner's doc-range chunks do: the probe form of the same row
    then reads the same logical filter from the bitmap. In place."""
    rowstarts, nrows, lens, skips = host[:4]
    dlo, dhi = host[8], host[9]
    for q in range(rowstarts.shape[0]):
        a = int(np.searchsorted(fdocs, dlo[q, 0]))
        cap = a + L - 1024 - int(rng.integers(0, 4096))
        if cap < len(fdocs) and fdocs[cap] < dhi[q, 0]:
            dhi[q, 0] = fdocs[cap]
        e = int(np.searchsorted(fdocs, dhi[q, 0]))
        if e > a:
            rowstarts[q, TS], nrows[q, TS], lens[q, TS], skips[q, TS] = \
                window_at(a, e - a, L)
        else:
            rowstarts[q, TS] = nrows[q, TS] = lens[q, TS] = skips[q, TS] = 0


def probe_rows(host: list, TS: int) -> list:
    """The probe form of list-form B3 rows: the term slots only, the count
    weights [QB, TS + 1] with the filter's last."""
    cw = host[5]
    return ([x[:, :TS].copy() for x in host[:4]] + [host[4]]
            + [np.concatenate([cw[:, :TS], cw[:, TS:TS + 1]], axis=1)]
            + host[6:])


def phase_probe_grid(dev, rng) -> dict:
    """B3's two filter forms on the same logical rows, in one call each:
    list-form kernel == list-form plain == probe-form plain == probe-form
    kernel, bit for bit, over TS x QB, with every term-needing count-weight
    pattern (bool_grid_rows without its const-score rows), thresholds at
    the pass edge, zero and negative weights (a -0.0 sum must come out
    +0.0 on a filter hit) and doc windows; device ms side by side."""
    import torch
    from opensearch_tpu_torch.ops import bm25

    starts, docs, packed = random_csr(rng, 200_000, 120)
    a_starts, a_docs, a_packed = bm25.align_csr_rows(
        starts, docs, packed, margin=1 << 17, alignment=128)
    fdocs = np.sort(rng.choice(200_000, 70_000, replace=False))
    filt = np.full(((len(fdocs) + 127) // 128) * 128 + (1 << 17),
                   2**31 - 1, np.int32)
    filt[:len(fdocs)] = fdocs
    mask = np.zeros(200_000, bool)
    mask[fdocs] = True
    d_docs = torch.from_numpy(a_docs).to(dev)
    d_tfdl = torch.from_numpy(a_packed).to(dev)
    d_filt = torch.from_numpy(filt).to(dev)
    d_bits = bm25.pack_bits(torch.from_numpy(mask).to(dev))
    worst, points, largest = 0.0, 0, None
    for TS in (1, 2, 4, 8):
        L = (1 << 17) // (2 * TS)
        for QB in (64, 1024):
            K = 128 if QB == 64 else 16
            host = bool_grid_rows(rng, starts, a_starts[:-1], len(fdocs),
                                  QB, TS, False, L)
            # widen to the list form (filter slot TS, dead slots after it)
            for i in range(4):
                wide = np.zeros((QB, 2 * TS), np.int32)
                wide[:, :TS] = host[i]
                host[i] = wide
            cw = np.zeros((QB, 2 * TS), np.float32)
            cw[:, :TS] = host[5]
            cw[:, TS] = REQ_W
            host[5] = cw
            host[6] = host[6] + REQ_W
            neg = np.arange(QB) % 5 == 4
            host[4][neg] = -host[4][neg]
            host[4][np.arange(QB) % 10 == 9] = np.float32(-0.0)
            filter_window_rows(fdocs, host, TS, L, rng)
            p_host = probe_rows(host, TS)
            args = [torch.from_numpy(a).to(dev) for a in host]
            p_args = [torch.from_numpy(a).to(dev) for a in p_host]
            kw = dict(TS=TS, L=L, K=K, k1=1.2, b=0.75, filtered=True)

            def kern():
                return bm25.fused_bm25_bool_topk(d_docs, d_tfdl, d_filt,
                                                 *args, **kw)

            def pkern():
                return bm25.fused_bm25_bool_topk(d_docs, d_tfdl, d_bits,
                                                 *p_args, **kw, probe=True)
            want = bm25.fused_bm25_bool_topk_plain(d_docs, d_tfdl, d_filt,
                                                   *args, **kw)
            p_want = bm25.fused_bm25_bool_topk_plain(
                d_docs, d_tfdl, d_bits, *p_args, **kw, probe=True)
            what = f"probe TS={TS} L={L} QB={QB}"
            worst = max(worst, _check_equal(kern(), want, what + " list"),
                        _check_equal(pkern(), p_want, what + " probe"))
            _check_equal(p_want, want, what + " probe plain vs list plain")
            torch.cuda.synchronize()
            zeros = int(((want[0] == 0) & ~torch.signbit(want[0])).sum())
            b_ms, nbytes, n_t, n_f = bool_bound(a_docs, filt, host, TS,
                                                True, L)
            pb_ms = bool_bound(a_docs, filt, p_host, TS, True, L, True)[0]
            d_list, c_list = kernel_ms(kern, 10)
            d_probe, c_probe = kernel_ms(pkern, 10)
            points += 1
            log(f"  probe  TS={TS} L={L:6d} K={K:3d} QB={QB:4d} "
                f"list == probe == plain, +0.0 scores={zeros} "
                f"device_ms list={d_list:.4f} probe={d_probe:.4f} "
                f"call_ms list={c_list:.4f} probe={c_probe:.4f} "
                f"bound_ms list={b_ms:.5f} probe={pb_ms:.5f} "
                f"term_postings={n_t} filter_postings={n_f}")
            if largest is None or pb_ms > largest["bound_ms"]:
                largest = {"ms": d_probe, "list_ms": d_list,
                           "bound_ms": pb_ms, "TS": TS, "QB": QB}
    return {"points": points, "max_abs_err": worst, "largest": largest}


def phase_norms_grid(dev, rng) -> dict:
    """fused_bm25_topk (B4, no caller in the package) == plain over T x L
    x K: fixed-L windows at 1024-aligned starts over f32 norms, absent
    slots, msm in {1, T}. Returns the grid's numbers and its largest
    point's times for the kernels line."""
    import torch
    from opensearch_tpu_torch.ops import bm25

    starts, docs, _packed = random_csr(rng, 200_000, 120)
    norms = rng.uniform(0.01, 0.99, len(docs)).astype(np.float32)
    a_starts, a_docs, a_norms = bm25.align_csr_rows(
        starts, docs, norms, margin=1 << 14, alignment=1024)
    d_docs = torch.from_numpy(a_docs).to(dev)
    d_norms = torch.from_numpy(a_norms).to(dev)
    nterms = len(starts) - 1
    worst = 0.0
    points = 0
    largest = None
    QB = 64
    for T in (1, 2, 4, 8):
        for L in (1024, 8192):
            w_starts = np.zeros((QB, T), np.int32)
            w_lens = np.zeros((QB, T), np.int32)
            for q in range(QB):
                for t in range(T):
                    if rng.random() < 0.15:
                        continue
                    r = int(rng.integers(0, nterms))
                    w_starts[q, t] = a_starts[r]
                    w_lens[q, t] = min(int(starts[r + 1] - starts[r]), L)
            weights = rng.uniform(0.1, 5.0, (QB, T)).astype(np.float32)
            msm = np.where(np.arange(QB) % 2 == 0, 1.0, float(T)).astype(
                np.float32)[:, None]
            host = [w_starts, w_lens, weights, msm]
            args = [torch.from_numpy(a).to(dev) for a in host]
            for K in (16, 128):
                def kern():
                    return bm25.fused_bm25_topk(d_docs, d_norms, *args,
                                                T=T, L=L, K=K)

                def plain():
                    return bm25.fused_bm25_topk_plain(d_docs, d_norms, *args,
                                                      T=T, L=L, K=K)
                got = kern()
                want = plain()
                torch.cuda.synchronize()
                worst = max(worst, _check_equal(got, want,
                                                f"norms T={T} L={L} K={K}"))
                n_valid = int(np.minimum(w_lens, L).sum())
                b_ms, nbytes = bound_ms(n_valid, QB)
                d_ms, c_ms = kernel_ms(kern, 10)
                p_ms = cuda_ms(plain, 3)
                points += 1
                log(f"  norms  T={T} L={L:5d} K={K:3d} QB={QB} equal=yes "
                    f"device_ms={d_ms:.4f} call_ms={c_ms:.4f} "
                    f"plain_ms={p_ms:.4f} "
                    f"bound_ms={b_ms:.5f} bytes={nbytes} "
                    f"valid_postings={n_valid}")
                if largest is None or b_ms > largest["bound_ms"]:
                    largest = {"ms": d_ms, "call_ms": c_ms,
                               "plain_ms": p_ms, "bound_ms": b_ms, "T": T,
                               "L": L, "K": K}
    return {"points": points, "max_abs_err": worst, "largest": largest}


def edge_rows(rng, starts, a_starts, QB: int, T: int, L: int,
              mode: str) -> list:
    """QB rows of T slots for the edge grid. "long": every slot one of the
    8 longest terms (rows of many tiles in every slot), every third row
    cut to a doc window; "ties": the same windows for a payload of one
    value and equal weights (thousands of docs share a score); "zero":
    zero weights (every score 0, as `terms` rows); "rare": terms of at
    most 60 postings and msm = T (fewer passers than K, often none).
    -> [rowstarts, nrows, lens, skips, weights, msm, dlo, dhi]."""
    dfs = np.diff(starts)
    order = np.argsort(-dfs, kind="stable")
    pool = order[:8] if mode != "rare" else np.flatnonzero(dfs <= 60)
    rowstarts, nrows, lens, skips = (np.zeros((QB, T), np.int32)
                                     for _ in range(4))
    for q in range(QB):
        for t in range(T):
            r = int(pool[rng.integers(0, len(pool))])
            off = int(rng.integers(0, 64))
            rowstarts[q, t], nrows[q, t], lens[q, t], skips[q, t] = \
                window_at(int(a_starts[r]) + off, int(dfs[r]) - off, L)
    weights = rng.uniform(0.1, 5.0, (QB, T)).astype(np.float32)
    if mode == "ties":
        weights[:] = np.float32(1.5)
    elif mode == "zero":
        weights[:] = 0.0
    msm = np.full((QB, 1), float(T) if mode == "rare" else 1.0, np.float32)
    dlo = np.zeros((QB, 1), np.int32)
    dhi = np.full((QB, 1), 2**31 - 1, np.int32)
    if mode == "long":
        part = np.arange(QB) % 3 == 1
        dlo[part, 0] = rng.integers(0, 50_000, part.sum())
        dhi[part, 0] = dlo[part, 0] + rng.integers(10_000, 100_000,
                                                   part.sum())
    return [rowstarts, nrows, lens, skips, weights, msm, dlo, dhi]


def phase_edge_grid(dev, rng) -> dict:
    """The four kernels == plain at the row machinery's edges: each of
    edge_rows' modes, T in {1, 8} (B3: TS in {1, 8} with the filter slot,
    T up to 16, and in probe form), launches of 1, 8 and 64 rows (the
    first two split each row over blocks), K = 128 (and 10 on B1). Logs
    device ms beside the byte bound; the plain versions are only
    compared."""
    import torch
    from opensearch_tpu_torch.ops import bm25

    starts, docs, packed = random_csr(rng, 200_000, 120)
    imp = rng.integers(0, 1 << 16, len(docs)).astype(np.int32)
    norms = rng.uniform(0.01, 0.99, len(docs)).astype(np.float32)
    flat = [np.full_like(packed, (3 << 21) | 100), np.full_like(imp, 4321),
            np.full_like(norms, np.float32(0.25))]
    a_starts, a_docs, *planes = bm25.align_csr_rows(
        starts, docs, packed, imp, norms, *flat, margin=1 << 17,
        alignment=1024)
    d_docs = torch.from_numpy(a_docs).to(dev)
    d = [torch.from_numpy(x).to(dev) for x in planes]
    pay = {False: {"tfdl": d[0], "impact": d[1], "norms": d[2]},
           True: {"tfdl": d[3], "impact": d[4], "norms": d[5]}}
    fdocs = np.sort(rng.choice(200_000, 70_000, replace=False))
    filt = np.full(((len(fdocs) + 127) // 128) * 128 + (1 << 17),
                   2**31 - 1, np.int32)
    filt[:len(fdocs)] = fdocs
    d_filt = torch.from_numpy(filt).to(dev)
    kinds = ("tfdl", "impact", "bool", "norms")
    if has_probe():
        mask = np.zeros(200_000, bool)
        mask[fdocs] = True
        d_filt = (d_filt, bm25.pack_bits(torch.from_numpy(mask).to(dev)))
        kinds += ("probe",)
    else:
        log("  edge probe points skipped: this package's B3 has no probe "
            "form")
        d_filt = (d_filt, None)
    worst, points = 0.0, 0
    for kind in kinds:
        for T in (1, 8):
            L = (1 << 17) // (2 * T if kind == "bool" else T)
            L = min(L, 8192) if kind == "norms" else L
            for mode in ("long", "ties", "zero", "rare"):
                for QB in (1, 8, 64):
                    for K in ((10, 128) if kind == "tfdl" else (128,)):
                        host = edge_rows(rng, starts, a_starts[:-1], QB, T,
                                         L, mode)
                        v = pay[mode == "ties"]
                        kern, plain, nbytes = _edge_call(
                            kind, host, d_docs, v, d_filt, filt, a_docs,
                            len(fdocs), a_starts, T, L, K, rng, dev)
                        what = f"edge {kind} T={T} L={L} {mode} QB={QB} K={K}"
                        got = kern()
                        want = plain()
                        torch.cuda.synchronize()
                        worst = max(worst, _check_equal(got, want, what))
                        passers = int(want[2][:, 0].max())
                        d_ms = device_ms(kern, 5)
                        S = bm25.split_rows(QB, 2 * T if kind == "bool"
                                            else T, L,
                                            bm25.resident_blocks(
                                                "bm25_" + LIBRARY.get(
                                                    kind, kind), dev))
                        points += 1
                        log(f"  {what} split={S} equal=yes "
                            f"device_ms={d_ms:.4f} bound_ms="
                            f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f} "
                            f"bytes={nbytes} max_passers={passers}")
    return {"points": points, "max_abs_err": worst}


LIBRARY = {"probe": "bool"}    # edge kinds that are not a library's name


def _edge_call(kind, host, d_docs, v, d_filt, filt, a_docs, n_filt,
               a_starts, T, L, K, rng, dev):
    """(kernel thunk, plain thunk, bound bytes) of one edge-grid point."""
    import torch
    from opensearch_tpu_torch.ops import bm25
    rowstarts, nrows, lens, skips, weights, msm, dlo, dhi = host
    QB = rowstarts.shape[0]
    if kind == "norms":
        # fixed-L windows at the terms' 1024-aligned starts
        w_starts = (rowstarts.astype(np.int64) * 128).astype(np.int32)
        w_lens = np.minimum(lens + skips, L).astype(np.int32)
        args = [torch.from_numpy(a).to(dev)
                for a in (w_starts, w_lens, weights, msm)]
        n_valid = int(w_lens.sum())
        return (lambda: bm25.fused_bm25_topk(d_docs, v["norms"], *args, T=T,
                                             L=L, K=K),
                lambda: bm25.fused_bm25_topk_plain(d_docs, v["norms"], *args,
                                                   T=T, L=L, K=K),
                8 * n_valid + 12 * 128 * QB)
    if kind in ("bool", "probe"):
        # TS = T term slots and the filter slot T: the first slot
        # required, the rest one counted family, the filter required
        # (probe: the term slots, and the bitmap for the filter)
        TS, Tb = T, 2 * T
        pad = [np.zeros((QB, Tb), np.int32) for _ in range(4)]
        for a, b in zip(pad, (rowstarts, nrows, lens, skips)):
            a[:, :TS] = b
        for q in range(QB):
            off = int(rng.integers(0, n_filt // 4))
            pad[0][q, TS], pad[1][q, TS], pad[2][q, TS], pad[3][q, TS] = \
                window_at(off, n_filt - off, L)
        cw = np.zeros((QB, Tb), np.float32)
        cw[:, 0] = REQ_W
        cw[:, 1:TS] = 1.0
        cw[:, TS] = REQ_W
        thresh = np.full((QB, 1), 2 * REQ_W + (1.0 if TS > 1 else 0.0),
                         np.float32)
        if msm[0, 0] > 1:
            thresh[:, 0] = 2 * REQ_W + (TS - 1)
        avgdl = np.full((QB, 1), 57.3, np.float32)
        b_host = pad + [weights, cw, thresh, avgdl, dlo, dhi]
        probe = kind == "probe"
        if probe:
            b_host = probe_rows(b_host, TS)
        args = [torch.from_numpy(a).to(dev) for a in b_host]
        nbytes = bool_bound(a_docs, filt, b_host, TS, True, L, probe)[1]
        kw = dict(TS=TS, L=L, K=K, k1=1.2, b=0.75, filtered=True,
                  **({"probe": True} if probe else {}))
        f = d_filt[1] if probe else d_filt[0]
        return (lambda: bm25.fused_bm25_bool_topk(d_docs, v["tfdl"], f,
                                                  *args, **kw),
                lambda: bm25.fused_bm25_bool_topk_plain(
                    d_docs, v["tfdl"], f, *args, **kw),
                nbytes)
    nv = valid_postings(a_docs, rowstarts, nrows, lens, skips, dlo, dhi, L)
    if kind == "tfdl":
        avgdl = np.full((QB, 1), 57.3, np.float32)
        args = [torch.from_numpy(a).to(dev)
                for a in host[:6] + [avgdl] + host[6:]]
        return (lambda: bm25.fused_bm25_topk_tfdl(
                    d_docs, v["tfdl"], *args, T=T, L=L, K=K, k1=1.2, b=0.75),
                lambda: bm25.fused_bm25_topk_tfdl_plain(
                    d_docs, v["tfdl"], *args, T=T, L=L, K=K, k1=1.2, b=0.75),
                bound_ms(nv, QB)[1])
    args = [torch.from_numpy(a).to(dev) for a in host]
    return (lambda: bm25.fused_bm25_topk_impact(d_docs, v["impact"], *args,
                                                T=T, L=L, K=K),
            lambda: bm25.fused_bm25_topk_impact_plain(d_docs, v["impact"],
                                                      *args, T=T, L=L, K=K),
            bound_ms(nv, QB)[1])


# ---------------------------------------------------------------------
# phase 4: the slice on the card and on the CPU, small
# ---------------------------------------------------------------------

STOPWORDS = ["the", "of", "and", "a", "to", "in", "is"]


def make_text_corpus(rng, ndocs: int):
    """Sentences of Zipf-distributed pseudo-words, stopwords, mixed case,
    punctuation and a few non-ASCII words. Each word draw is
    `rng.choice(words, p=p)` and each stopword `rng.choice(STOPWORDS)`,
    written out (one uniform against the cumulative p, one integer) so the
    weights are not re-validated per token; the stream is the same."""
    sy = ["ka", "lo", "mi", "ra", "te", "su", "no", "vi", "de", "po", "zu",
          "an", "el", "or", "ix", "qu"]
    words = sorted({"".join(rng.choice(sy, int(rng.integers(1, 4))))
                    for _ in range(1500)})
    words += ["café", "naïve", "Zürich", "straße"]
    p = 1.0 / np.arange(1, len(words) + 1) ** 1.05
    p /= p.sum()
    cdf = np.cumsum(p)
    cdf /= cdf[-1]
    docs = []
    for _ in range(ndocs):
        toks = []
        for _ in range(int(rng.integers(4, 60))):
            if rng.random() < 0.25:
                toks.append(STOPWORDS[int(rng.integers(0, len(STOPWORDS)))])
            else:
                toks.append(words[int(cdf.searchsorted(rng.random(),
                                                       side="right"))])
        toks[0] = toks[0].capitalize()
        text = " ".join(toks).replace(" qu", ", qu") + "."
        docs.append({"body": text, "tag": str(rng.choice(["x", "y", "z"]))})
    return docs, words


def slice_queries(rng, words):
    top = words[:40]
    qs = []
    for i in range(40):
        kind = i % 8
        a, b, c = (str(x) for x in rng.choice(top, 3, replace=False))
        if kind == 0:
            q = {"term": {"body": a}}
        elif kind == 1:
            q = {"match": {"body": f"{a} {b}"}}
        elif kind == 2:
            q = {"match": {"body": f"{a} {b} {c}"}}
        elif kind == 3:
            q = {"match": {"body": {"query": f"{a} {b} {c}",
                                    "minimum_should_match": 2}}}
        elif kind == 4:
            q = {"match": {"body": {"query": f"{a} {b}",
                                    "operator": "and"}}}
        elif kind == 5:
            q = {"match": {"body": " ".join(str(x) for x in rng.choice(
                words[:200], 8, replace=False))}}
        elif kind == 6:
            q = {"terms": {"tag.keyword": ["x", "z"]}}
        else:
            q = {"match": {"body": f"The {a.upper()}!"}}
        qs.append({"query": q, "size": int(rng.choice([5, 10, 20]))})
    return qs


def strip_took(resp):
    if isinstance(resp, dict):
        return {k: strip_took(v) for k, v in resp.items() if k != "took"}
    if isinstance(resp, list):
        return [strip_took(v) for v in resp]
    return resp


def small_corpus(rng, l_head: int):
    """make_text_corpus grown until "the" (the queried stopword) has more
    than `l_head` postings in the first segment: (bulk, split, df(the),
    term-group bodies, bool bodies, general-path bodies)."""
    import re
    ndocs = 8000
    while True:
        docs, words = make_text_corpus(rng, ndocs)
        split = ndocs - 500          # two segments: most docs, then 500
        df = sum(1 for d in docs[:split]
                 if "the" in re.findall(r"\w+", d["body"].lower()))
        if df > l_head:
            break
        ndocs *= 2
    # the guardrail columns of the bool bodies, from their own stream
    grng = np.random.default_rng(17)
    for d in docs:
        d["status"] = STATUS[int(grng.integers(0, 3))]
        d["price"] = int(grng.integers(0, 1000))
    bulk = []
    for i, d in enumerate(docs):
        bulk += [{"index": {"_index": "t", "_id": f"d{i}"}}, d]
    bodies = slice_queries(rng, words) + [
        {"query": {"match": {"body": "the"}}, "size": 10},
        {"query": {"match": {"body": "the of"}}, "size": 10},
        {"query": {"match": {"body": "the of and"}}, "size": 100},
        {"query": {"match": {"body": f"the {words[0]}"}}, "size": 10},
        {"query": {"match": {"body": f"the {words[1]} {words[2]}"}},
         "size": 20},
        {"query": {"match": {"body": "the a"}}, "track_total_hits": True},
    ]
    return (bulk, split, df, bodies, bool_slice_bodies(words),
            general_slice_bodies(words))


STATUS = ("archived", "draft", "published")
BOOL_ROUTES = ("b3_filter_slot", "b3_filtered_postings", "b3_unfiltered",
               "filtered_pure")


def bool_slice_bodies(words) -> list:
    """Bool bodies over the small slice, one of each shape: must / should
    / filter / must_not, constant_score, range, boost != 1, exact totals.
    A filter's first use takes the filter slot, later uses the
    filter-specialized postings or the filtered-pure rung."""
    a, b, c, d, e = words[1:6]
    pub = {"term": {"status": "published"}}
    draft = {"term": {"status": "draft"}}
    price = {"range": {"price": {"gte": 250, "lt": 750}}}
    fam = {"match": {"body": f"{a} {b}"}}
    return [
        {"query": {"bool": {"must": [fam], "filter": [pub]}}},
        {"query": {"bool": {"must": [{"match": {"body": {
            "query": f"the {c}", "operator": "and"}}}],
            "filter": [pub, price]}}, "size": 20},
        {"query": {"bool": {"must": [{"match": {"body": {
            "query": f"{a} {c} {e}", "minimum_should_match": 2}}}],
            "filter": [draft]}}},
        {"query": {"bool": {"must": [{"match": {"body": f"the {d}"}}],
                            "filter": [pub]}}},
        {"query": {"bool": {"must": [fam], "should": [{"term": {
            "body": "the"}}], "filter": [pub]}}, "size": 30},
        {"query": {"bool": {"must": [{"term": {"body": "the"}}],
                            "should": [{"term": {"body": a}},
                                       {"term": {"body": d}}],
                            "minimum_should_match": 1,
                            "must_not": [{"term": {"status": "archived"}}]}}},
        {"query": {"bool": {"must": [{"term": {"body": "of"}}],
                            "should": [{"term": {"body": b}},
                                       {"term": {"body": e}}],
                            "minimum_should_match": 1,
                            "must_not": [{"term": {"status": "archived"}}]}}},
        {"query": {"bool": {"must": [fam], "filter": [{"range": {
            "price": {"gte": 250, "lt": 300}}}]}}},
        {"query": {"constant_score": {"filter": {"bool": {"filter": [
            draft, {"range": {"price": {"gte": 500, "lt": 600}}}]}},
            "boost": 2.0}}, "size": 20},
        {"query": {"bool": {"must": [fam], "should": [{"term": {
            "body": c}}], "filter": [pub], "boost": 1.5}}},
        {"query": {"bool": {"should": [{"term": {"body": a}},
                                       {"term": {"body": b}},
                                       {"term": {"body": c}}],
                            "minimum_should_match": 2}}},
        {"query": {"bool": {"filter": [{"range": {"price": {"gt": 990}}}]}}},
        {"query": {"bool": {"must": [fam], "filter": [pub]}},
         "track_total_hits": True},
    ]


def general_slice_bodies(words) -> list:
    """Bodies the fused kernels decline, over the small slice: match_all
    (from 0 and from 1000), a top-level range, a 9-token match (default
    totals and exact), a window past MAX_K, a mixed-field bool, a should
    holding a nested bool and a range, exists and ids."""
    a, b, c = words[1:4]
    nine = " ".join(["the", "of"] + list(words[4:11]))
    pub = {"term": {"status": "published"}}
    return [
        {"query": {"match_all": {}}},
        {"query": {"match_all": {}}, "from": 1000, "size": 10},
        {"query": {"range": {"price": {"gte": 500, "lt": 510}}}},
        {"query": {"match": {"body": nine}}},
        {"query": {"match": {"body": nine}}, "track_total_hits": True},
        {"query": {"match": {"body": f"{a} {b}"}}, "from": 200, "size": 10},
        {"query": {"bool": {"must": [{"match": {"body": f"{a} {c}"}},
                                     {"term": {"status": "draft"}}]}}},
        {"query": {"bool": {"should": [
            {"bool": {"must": [{"match": {"body": a}}], "filter": [pub]}},
            {"match": {"body": b}},
            {"range": {"price": {"gte": 100, "lt": 150}}}]}}},
        {"query": {"exists": {"field": "price"}}, "size": 5},
        {"query": {"ids": {"values": ["d3", "d7600", "d42"]}}},
    ]


def run_slice_small(name: str, bulk, split: int, bodies,
                    bool_bodies, general_bodies) -> tuple:
    """Index `bulk` as two segments on a client on `name` and serve
    `bodies` and `bool_bodies` through msearch, single searches and one
    chunked search, then `general_bodies` (which the fused kernels
    decline), then re-index two `_id`s and serve a few bodies over the
    segments with deletes: -> (responses without `took`, kernel counts,
    rung and route counts). Filters of more than 256 docs count as dense
    here, so a few thousand docs reach every bool route."""
    from opensearch_tpu_torch import RestClient
    from opensearch_tpu_torch.ops import bm25
    from opensearch_tpu_torch.search import compiler as C
    from opensearch_tpu_torch.search import fastpath, impactpath

    c = RestClient(device=name)
    c.indices.create("t", {"mappings": {"properties": {
        "body": {"type": "text"}, "status": {"type": "keyword"},
        "price": {"type": "integer"}}}})
    t0 = time.perf_counter()
    c.bulk(bulk[:2 * split], refresh=True)
    c.bulk(bulk[2 * split:], refresh=True)
    t_bulk = time.perf_counter() - t0
    bm25.reset_counts()
    fastpath.reset_stats()
    impactpath.reset_stats()
    C.reset_stats()
    saved_min = fastpath.MATERIALIZE_MIN_DOCS
    fastpath.MATERIALIZE_MIN_DOCS = 256
    t0 = time.perf_counter()
    try:
        ms = c.msearch(sum([[{}, q] for q in bodies + bool_bodies], []),
                       index="t")
        singles = [c.search("t", q)
                   for q in bodies[:10] + bodies[-6:] + bool_bodies]
    finally:
        fastpath.MATERIALIZE_MIN_DOCS = saved_min
    # a stopword-class term split into doc-range chunks: the per-row
    # budget lowered for this one search
    saved = fastpath.MAX_TL
    fastpath.MAX_TL = 2048
    try:
        chunked = c.search("t", {"query": {"match": {"body": "the"}},
                                 "size": 50, "track_total_hits": True})
    finally:
        fastpath.MAX_TL = saved
    general = [c.msearch(sum([[{}, q] for q in general_bodies], []),
                         index="t"),
               [c.search("t", q) for q in general_bodies]]
    # re-indexed ids: both segments get a deleted doc
    for i in (5, len(bulk) // 2 - 3):
        c.index("t", {"body": "the of reindexed", "status": "draft",
                      "price": 7}, id=f"d{i}")
    c.indices.refresh("t")
    after = bodies[:4] + general_bodies[:4] + bool_bodies[:2]
    reindexed = [c.msearch(sum([[{}, q] for q in after], []), index="t"),
                 [c.search("t", q) for q in after]]
    t_search = time.perf_counter() - t0
    counts = dict(bm25.COUNTS)
    rungs = {**fastpath.STATS, **{f"impact_{k}": v for k, v in
                                  impactpath.STATS.items()},
             **C.STATS}
    log(f"  {name}: bulk+refresh {t_bulk:.2f}s, "
        f"{len(bodies) + 2 * len(bool_bodies) + 17} searches, "
        f"{3 * len(general_bodies)} general-path bodies, "
        f"{2 * len(after)} after re-indexing {t_search:.2f}s, "
        f"counts {counts}")
    log(f"  {name}: rungs {rungs}")
    return (strip_took([ms, singles, chunked, general, reindexed]), counts,
            rungs)


def phase_slice_small(rng) -> dict:
    from opensearch_tpu_torch.search import fastpath

    bulk, split, df, bodies, bool_bodies, general_bodies = small_corpus(
        rng, fastpath.L_HEAD)
    log(f"  corpus: {len(bulk) // 2} docs in two segments ({split} + "
        f"{len(bulk) // 2 - split}); df(the) in the first = {df} > "
        f"L_HEAD = {fastpath.L_HEAD}; {len(bool_bodies)} bool bodies, "
        f"{len(general_bodies)} general-path bodies")
    out = {name: run_slice_small(name, bulk, split, bodies, bool_bodies,
                                 general_bodies)
           for name in ("cuda", "cpu")}
    bodies = bodies + bool_bodies
    if out["cuda"][0] != out["cpu"][0]:
        for i, (a, b) in enumerate(zip(out["cuda"][0][0]["responses"],
                                       out["cpu"][0][0]["responses"])):
            if a != b:
                raise AssertionError(f"msearch response {i} differs: "
                                     f"{bodies[i]}\n{a}\n{b}")
        raise AssertionError("search responses differ between cuda and cpu")
    counts, rungs = out["cuda"][1], out["cuda"][2]
    if counts["launches"] == 0 or counts["impact_launches"] == 0 \
            or counts["bool_launches"] == 0 or counts["plain_calls"]:
        raise AssertionError(f"cuda slice did not run the three kernels "
                             f"only: {counts}")
    missing = [r for r in BOOL_ROUTES if rungs[r] == 0]
    if missing:
        raise AssertionError(f"no bool body took the routes {missing}: "
                             f"{rungs}")
    if rungs != out["cpu"][2]:
        raise AssertionError(f"rungs differ: cuda {rungs} cpu "
                             f"{out['cpu'][2]}")
    if rungs["pruned_served"] == 0 or rungs["pruned_rescued"] == 0:
        raise AssertionError(f"no query served by verify or by phase 2: "
                             f"{rungs}")
    if rungs["impact_served"] == 0 or rungs["general_served"] == 0:
        raise AssertionError(f"the impact rung or the general path served "
                             f"no body: {rungs}")
    if rungs["pruned_dview"] == 0:
        log(f"  no query reached the quality tier: its segments hold "
            f"fewer than QUALITY_MIN_NDOCS = {fastpath.QUALITY_MIN_NDOCS} "
            f"docs")
    rels = Counter(r["hits"]["total"]["relation"]
                   for r in out["cuda"][0][0]["responses"])
    log(f"  responses identical over {len(bodies)} msearch bodies, "
        f"{16 + len(bool_bodies)} searches and 1 chunked search (relations "
        f"{dict(rels)}), the general-path bodies and the bodies after "
        f"re-indexing; bool routes " + " ".join(
            f"{r}={rungs[r]}" for r in BOOL_ROUTES) + "; impact rung "
        f"served={rungs['impact_served']} "
        f"phase2={rungs['impact_phase2_served']} "
        f"escalated={rungs['impact_escalated']}, general "
        f"served={rungs['general_served']}")
    return counts


# ---------------------------------------------------------------------
# phase 5: MS MARCO passage scale
# ---------------------------------------------------------------------

def run_batches(client, bodies, warm=(), warm_launches=None) -> tuple:
    """`bodies` through RestClient.msearch in BATCH-body requests, counts
    and rungs set to 0 just before (and before the one msearch of `warm`
    bodies, when given, whose B3 launches' arguments are appended to
    `warm_launches`): -> (responses, wall s, batch ms, kernel counts, rung
    counts)."""
    from opensearch_tpu_torch.ops import bm25
    from opensearch_tpu_torch.search import fastpath

    bm25.reset_counts()
    fastpath.reset_stats()
    if warm:
        real = fastpath.fused_bm25_bool_topk

        def kept(*args, **kw):
            warm_launches.append((args, kw))
            return real(*args, **kw)
        fastpath.fused_bm25_bool_topk = kept
        t0 = time.perf_counter()
        try:
            client.msearch(sum([[{}, b] for b in warm], []), index="bench")
        finally:
            fastpath.fused_bm25_bool_topk = real
        log(f"  warm pass: {len(warm)} bodies in "
            f"{time.perf_counter() - t0:.2f}s, counts {dict(bm25.COUNTS)}")
    lat = []
    resps = []
    t0 = time.perf_counter()
    for i in range(0, len(bodies), BATCH):
        tb = time.perf_counter()
        resps += client.msearch(sum([[{}, b] for b in bodies[i:i + BATCH]],
                                    []), index="bench")["responses"]
        lat.append((time.perf_counter() - tb) * 1e3)
    wall = time.perf_counter() - t0
    counts, rungs = dict(bm25.COUNTS), dict(fastpath.STATS)
    for b, r in zip(bodies, resps):
        hits = r["hits"]["hits"]
        if r["hits"]["total"]["value"] > b.get("from", 0) and not hits:
            raise AssertionError(f"hits missing from a response: {r}")
        sc = [h["_score"] for h in hits]
        if not all(np.isfinite(sc)) or sc != sorted(sc, reverse=True):
            raise AssertionError(f"bad scores in a response: {sc}")
    return resps, wall, lat, counts, rungs


def log_run(what: str, n: int, wall: float, lat, counts, rungs, resps):
    rels = Counter(r["hits"]["total"]["relation"] for r in resps)
    log(f"  {what}: queries={n} batch={BATCH} wall_s={wall:.2f} "
        f"qps={n / wall:.1f} batch_ms_p50={np.percentile(lat, 50):.1f} "
        f"batch_ms_p99={np.percentile(lat, 99):.1f} "
        f"tfdl_launches={counts['launches']} tfdl_rows={counts['rows']} "
        f"impact_launches={counts['impact_launches']} "
        f"impact_rows={counts['impact_rows']} "
        f"plain_calls={counts['plain_calls']} relations={dict(rels)}")
    log(f"  {what}: rungs " + " ".join(f"{k}={rungs[k]}" for k in RUNGS))


def cpu_twin(seg):
    """A RestClient on the CPU over the same segment object (the bench
    index's mappings)."""
    from opensearch_tpu_torch import RestClient
    cpu = RestClient(device="cpu")
    cpu.indices.create("bench", {"mappings": {"properties": {
        "body": {"type": "text"}, "status": {"type": "keyword"},
        "price": {"type": "integer"}}}})
    cpu._indices["bench"].engine.segments = [seg]
    return cpu


def phase_msmarco(ndocs: int, nq: int) -> dict:
    import torch
    from opensearch_tpu_torch import RestClient, bench_corpus as bc
    from opensearch_tpu_torch.ops import bm25
    from opensearch_tpu_torch.search import compiler as C, fastpath
    from opensearch_tpu_torch.search import query_dsl as dsl

    t0 = time.perf_counter()
    corpus = bc.build_corpus(ndocs)
    columns = bc.guardrail_columns(ndocs)
    t_corpus = time.perf_counter() - t0
    client = RestClient(device="cuda")
    dev = client.device
    t1 = time.perf_counter()
    # the guardrail columns ride the same segment for phase 6; no query
    # of this phase reads them
    seg = bc.make_index(client, corpus, columns=columns)
    torch.cuda.synchronize()
    t_planes = time.perf_counter() - t1
    t1 = time.perf_counter()
    al = fastpath.get_aligned(seg, "body", dev)
    torch.cuda.synchronize()
    t_align = time.perf_counter() - t1
    starts, _docs, _tfs, dl, df = corpus
    pb = seg.postings["body"]
    big = al.lens > fastpath.L_HEAD
    n_head = int(al.head_lens[big].sum())
    log(f"  corpus: ndocs={ndocs} postings={pb.size} tokens={int(dl.sum())}"
        f" codec=v{seg.codec_version} impact_bits={pb.impact.bits} "
        f"host_build_s={t_corpus:.1f} planes_s={t_planes:.1f} "
        f"heads_align_upload_s={t_align:.1f} clamped_rows={int(big.sum())}"
        f" clamped_postings={int(al.lens[big].sum())}")
    log(f"  resident bytes: docs={al.d_docs.numel() * 4} "
        f"tfdl={al.d_tfdl.numel() * 4} impacts={al.d_imp.numel() * 4} "
        f"(of which heads: {12 * n_head} over {n_head} head postings) "
        f"total={al.nbytes}")
    vs = bc.vocab_strings(len(starts) - 1)
    q2 = bc.pick_queries(df, nq // 2)
    q6 = bc.pick_queries_real(df, nq // 2)
    bodies = []
    for i in range(nq // 2):
        bodies.append({"query": {"match": {"body": f"{vs[q2[i][0]]} "
                                                   f"{vs[q2[i][1]]}"}},
                       "size": 10})
        bodies.append({"query": {"match": {"body": " ".join(
            vs[t] for t in q6[i])}}, "size": 10})

    # the main path: the pruned match ladder (slice 2)
    resps, wall, lat, counts, rungs = run_batches(client, bodies)
    log_run("pruned msearch", nq, wall, lat, counts, rungs, resps)
    if counts["impact_launches"] == 0 or counts["plain_calls"] != 0:
        raise AssertionError(f"pruned path did not run the impact kernel "
                             f"only: {counts}")
    # the dense path (slice 1): exact totals demanded
    dense_bodies = [dict(b, track_total_hits=True) for b in bodies]
    d_resps, d_wall, d_lat, d_counts, d_rungs = run_batches(client,
                                                            dense_bodies)
    log_run("dense msearch (track_total_hits)", nq, d_wall, d_lat,
            d_counts, d_rungs, d_resps)
    if d_counts["launches"] == 0 or d_counts["plain_calls"] != 0 \
            or d_counts["impact_launches"] != 0:
        raise AssertionError(f"dense path did not run the tf.dl kernel "
                             f"only: {d_counts}")
    # every pruned page is the exact page: same ids and scores as the
    # dense kernel's; totals equal or, relation gte, a lower bound
    for b, r, d in zip(bodies, resps, d_resps):
        rh = [(h["_id"], h["_score"]) for h in r["hits"]["hits"]]
        dh = [(h["_id"], h["_score"]) for h in d["hits"]["hits"]]
        rt, dt = r["hits"]["total"], d["hits"]["total"]
        if rh != dh or dt["relation"] != "eq" or not (
                rt == dt if rt["relation"] == "eq"
                else rt["value"] <= dt["value"]):
            raise AssertionError(f"pruned page != dense page for {b}:\n"
                                 f"{r['hits']}\n{d['hits']}")
    log(f"  pruned pages == dense pages (ids and scores) for all {nq} "
        f"bodies; totals equal or lower bounds")
    qv = seg.aligned.get(("quality", "body", str(dev)))
    if qv is not None:
        fp = fastpath._filtered_postings(seg, "body", qv[0])
        vb = fastpath.get_aligned(fp.view, "body", dev).nbytes
        log(f"  quality view resident bytes: {vb} over {qv[0].n} docs "
            f"(mask and list {qv[0].nbytes})")

    profile_batch(client, bodies[:BATCH])

    ctx = client._indices["bench"].searcher.context()

    def lts_of(idx):
        return [C.rewrite(dsl.parse_query(bodies[i]["query"]), ctx)
                for i in idx]

    # kernel rows per query: pruned (one head row) and dense (chunks)
    rows_q = {2: [], 6: []}
    for i in range(0, nq, BATCH):
        idx = range(i, min(nq, i + BATCH))
        for j, vq in zip(idx, fastpath._prepare_vqueries(
                seg, ctx, lts_of(idx), {}, dev)):
            rows_q[2 if j % 2 == 0 else 6].append(vq.n if vq else 0)
    for nt, rs in rows_q.items():
        hist = sorted(Counter(rs).items())
        log(f"  dense rows per {nt}-term query: {len(rs)} queries, "
            f"{sum(rs)} rows, histogram (rows: queries) "
            f"{', '.join(f'{r}: {c}' for r, c in hist)}")
    first = range(BATCH)
    pruned = fastpath._prepare_vqueries(seg, ctx, lts_of(first), {}, dev,
                                        prune=[True] * BATCH)
    log(f"  pruned rows per query: 1 (first batch: {len(pruned)} head rows,"
        f" {sum(v.clamped for v in pruned)} clamped, "
        f"{sum(v.impact_pass for v in pruned)} on the impact kernel)")

    a_docs = al.d_docs.cpu().numpy()
    worst = 0.0

    def timed(gvqs, kl, impact):
        """One group of the first batch, launched whole as the main path
        launches it: kernel == plain, then both timed."""
        nonlocal worst
        T, L = gvqs[0].T_pad, max(v.L for v in gvqs)
        if impact:
            sub = fastpath._launch_inputs(gvqs, dev, pb.impact.scale)

            def kern():
                return bm25.fused_bm25_topk_impact(
                    al.d_docs, al.d_imp, *sub, T=T, L=L, K=kl)

            def plain():
                return bm25.fused_bm25_topk_impact_plain(
                    al.d_docs, al.d_imp, *sub, T=T, L=L, K=kl)
            lo_hi = (sub[6], sub[7])
        else:
            sub = fastpath._launch_inputs(gvqs, dev)
            k1, b = gvqs[0].k1, gvqs[0].b_eff

            def kern():
                return bm25.fused_bm25_topk_tfdl(
                    al.d_docs, al.d_tfdl, *sub, T=T, L=L, K=kl, k1=k1, b=b)

            def plain():
                return bm25.fused_bm25_topk_tfdl_plain(
                    al.d_docs, al.d_tfdl, *sub, T=T, L=L, K=kl, k1=k1, b=b)
            lo_hi = (sub[7], sub[8])
        what = f"first batch {'impact' if impact else 'tfdl'} T={T} L={L}"
        worst = max(worst, _check_equal(kern(), plain(), what))
        QB = sub[0].shape[0]
        d_ms, c_ms = kernel_ms(kern, 20)
        p_ms = cuda_ms(plain, 3)
        host = [x.cpu().numpy() for x in sub[:4] + list(lo_hi)]
        nv = valid_postings(a_docs, *host, L)
        b_ms, nbytes = bound_ms(nv, QB)
        log(f"  {what} QB={QB} K={kl} (whole launch): kernel == plain, "
            f"device_ms={d_ms:.4f} call_ms={c_ms:.4f} plain_ms={p_ms:.3f} "
            f"bound_ms={b_ms:.4f} bytes={nbytes} valid_postings={nv}")
        return {"QB": QB, "ms": d_ms, "call_ms": c_ms, "plain_ms": p_ms,
                "bound_ms": b_ms}

    # B1: the dense plan of the first batch (K = 16 for size 10)
    dense_plan = fastpath._prepare_vqueries(seg, ctx, lts_of(first), {},
                                            dev)
    b1 = group_sums("B1 tfdl", [timed(g, kl, False) for g, kl, _ in
                                fastpath._launch_groups(seg, dense_plan, 16,
                                                        dev)])
    # B2: the pruned plan of the first batch (K = 128 on head rows)
    b2 = group_sums("B2 impact", [timed(g, kl, True) for g, kl, _ in
                                  fastpath._launch_groups(seg, pruned, 16,
                                                          dev)
                                  if g[0].impact_pass])
    torch.cuda.synchronize()

    # phase-2 rescore of the first batch's clamped queries: device
    # batches == the host oracle, bit for bit
    jobs = [(vq, fastpath._p2_candidates(vq, pb, al.head_ids.get))
            for vq in pruned if vq.clamped]
    t2 = time.perf_counter()
    got = fastpath._rescore_many_device(seg, jobs, dev)
    t_dev = time.perf_counter() - t2
    ncand = 0
    for (vq, cand), (exact, cnt) in zip(jobs, got):
        want_x, want_c = fastpath._exact_rescore(seg, vq, cand)
        if exact.tobytes() != want_x.tobytes() \
                or not np.array_equal(cnt, want_c):
            raise AssertionError("device rescore != host _exact_rescore")
        ncand += len(cand)
    log(f"  device phase-2 rescore == host _exact_rescore over {len(jobs)}"
        f" jobs, {ncand} candidates (device {t_dev * 1e3:.1f} ms)")

    # sampled bodies through the port on the card and on the CPU, the
    # same segment object
    srng = np.random.default_rng(7)
    sample = sorted(srng.choice(nq, 64, replace=False).tolist())
    lines = sum([[{}, bodies[i]] for i in sample], [])
    cpu = cpu_twin(seg)
    t3 = time.perf_counter()
    on_cpu = strip_took(cpu.msearch(lines, index="bench"))
    t_cpu = time.perf_counter() - t3
    on_card = strip_took(client.msearch(lines, index="bench"))
    if on_card != on_cpu:
        raise AssertionError("64 sampled bodies: card and CPU responses "
                             "differ")
    log(f"  64 sampled bodies: card == CPU responses (CPU {t_cpu:.1f}s)")
    return {"tfdl_launches": d_counts["launches"],
            "impact_launches": counts["impact_launches"],
            "max_abs_err": worst, "b1": b1, "b2": b2, "client": client,
            "seg": seg, "corpus": corpus, "columns": columns,
            "a_docs": a_docs, "bodies": bodies,
            "body_terms": [t for i in range(nq // 2)
                           for t in (list(q2[i][:2]), list(q6[i]))]}


# ---------------------------------------------------------------------
# phase 6: bool traffic at MS MARCO passage scale
# ---------------------------------------------------------------------

def bool_oracle(mix: str, i: int, queries, status, price) -> tuple:
    """What body i of a phase-6 mix asks, straight from the columns: (term
    slots [(term, "req" | "fam" | "bonus")], family msm, filter mask,
    constant score or None)."""
    from opensearch_tpu_torch import bench_corpus as bc
    if mix == "guardrail":
        qt, msm, fk = bc.bool_shape(i, queries[i])
        mask = bc.guardrail_masks(status, price)[fk]
        if msm == len(qt):
            return [(int(t), "req") for t in qt], 0, mask, None
        return [(int(t), "fam") for t in qt], max(msm, 1), mask, None
    a, b, c = (int(t) for t in queries[i][:3])
    kind = i % 4
    if kind == 0:
        return [(a, "fam"), (b, "fam"), (c, "bonus")], 1, status == 2, None
    if kind == 1:
        return [(a, "req"), (b, "fam"), (c, "fam")], 1, status != 0, None
    if kind == 2:
        return ([(a, "fam"), (b, "fam")], 1,
                (price >= 250) & (price < 260), None)
    return [], 0, (status == 1) & (price >= 500) & (price < 510), 2.0


def oracle_page(corpus, slots, fam_msm, mask, const, size: int) -> tuple:
    """Independent numpy brute force of one bool body: exact f32 BM25
    (k1 1.2, b 0.75, Lucene idf) of every doc, summed in slot order,
    kept where the mask, every required slot and fam_msm family slots
    pass: -> (ids, scores, total) of the top `size` by (score desc, doc
    asc)."""
    import math
    starts, doc_ids, tfs, dl, df = corpus
    n = len(dl)
    avgdl = np.float32(float(dl.sum()) / n)
    k1, b, omb = np.float32(1.2), np.float32(0.75), np.float32(1.0 - 0.75)
    score = np.zeros(n, np.float32)
    n_req = np.zeros(n, np.int32)
    n_fam = np.zeros(n, np.int32)
    for t, kind in slots:
        lo, hi = int(starts[t]), int(starts[t + 1])
        d = doc_ids[lo:hi]
        tf = tfs[lo:hi]
        w = np.float32(math.log(1.0 + (n - int(df[t]) + 0.5)
                                / (int(df[t]) + 0.5)))
        k = k1 * (omb + (b * dl[d].astype(np.float32)) / avgdl)
        score[d] += (w * tf) / (tf + k)
        if kind == "req":
            n_req[d] += 1
        elif kind == "fam":
            n_fam[d] += 1
    want_req = sum(1 for _t, kind in slots if kind == "req")
    passed = mask & (n_req == want_req) & (n_fam >= fam_msm)
    docs = np.flatnonzero(passed)
    sc = (np.full(len(docs), np.float32(const), np.float32)
          if const is not None else score[docs])
    order = np.lexsort((docs, -sc))[:size]
    return docs[order].tolist(), sc[order].tolist(), int(len(docs))


def filter_bytes(seg, dev) -> dict:
    """Resident bytes the bool path added to the segment: filter lists
    (device doc lists and the dense masks kept on the host), filter
    masks on the device, filter-specialized rows and views."""
    from opensearch_tpu_torch.search import fastpath
    out = {"filter_lists": 0, "masks": 0, "filtered_rows": 0,
           "filtered_views": 0}
    for fl in seg.__dict__.get("filter_lists", {}).values():
        out["filter_lists"] += fl.nbytes
    for key, v in seg.aligned.items():
        if key[0] == "mask" and key[-1] == str(dev):
            out["masks"] += v.numel()
        elif key[0] == "filtered" and v is not None:
            al = v._al.get(str(dev))
            out["filtered_rows"] += al.nbytes if al is not None else 0
            if v.view is not None and ("body", str(dev)) in v.view.aligned:
                out["filtered_views"] += fastpath.get_aligned(
                    v.view, "body", dev).nbytes
    return out


def time_bool_groups(client, seg, bodies, base_docs: np.ndarray) -> dict:
    """The bool kernel's groups of a first batch, planned again after the
    mix ran (its filters are hot): time_bool_launches of them."""
    from opensearch_tpu_torch.search import compiler as C, fastpath
    from opensearch_tpu_torch.search import query_dsl as dsl

    dev = client.device
    ctx = client._indices["bench"].searcher.context()
    specs = [fastpath.make_spec(C.rewrite(dsl.parse_query(b["query"]), ctx),
                                10, b) for b in bodies]
    specs = [sp for sp in specs if sp.kind == "bool"]
    vqs = fastpath._prepare_bool_vqueries(seg, ctx, specs, {}, dev)
    return time_bool_launches(
        "first b3 batch", [fastpath.bool_group_call(gvqs, 16, dev)
                           for gvqs in fastpath.bool_groups(vqs)],
        fastpath.get_aligned(seg, "body", dev), base_docs)


def time_bool_launches(what: str, launches: list, base,
                       base_docs: np.ndarray) -> dict:
    """B3 launches given as (args, kwargs): kernel == plain bit for bit,
    then device, call and plain ms, and each held against its byte
    bound; the largest by bound and the sums."""
    import torch
    from opensearch_tpu_torch.ops import bm25

    worst, timed = 0.0, []
    for args, kw in launches:
        def kern():
            return bm25.fused_bm25_bool_topk(*args, **kw)

        def plain():
            return bm25.fused_bm25_bool_topk_plain(*args, **kw)
        probe = kw.get("probe", False)
        on_base = args[0] is base.d_docs
        route = ("filter probe" if probe else "filter slot" if kw["filtered"]
                 else "unfiltered" if on_base else "filtered postings")
        T = args[3].shape[1]
        label = f"{what} bool TS={kw['TS']} T={T} L={kw['L']} ({route})"
        worst = max(worst, _check_equal(kern(), plain(), label))
        QB = args[3].shape[0]
        d_ms, c_ms = kernel_ms(kern, 20)
        p_ms = cuda_ms(plain, 3)
        h_docs = base_docs if on_base else args[0].cpu().numpy()
        host = [x.cpu().numpy() for x in args[3:]]
        b_ms, nbytes, n_t, n_f = bool_bound(
            h_docs, None if probe else args[2].cpu().numpy(), host,
            kw["TS"], kw["filtered"], kw["L"], probe)
        log(f"  {label} QB={QB} K={kw['K']} (whole launch): kernel == "
            f"plain, device_ms={d_ms:.4f} call_ms={c_ms:.4f} plain_ms="
            f"{p_ms:.3f} bound_ms={b_ms:.4f} bytes={nbytes} term_postings="
            f"{n_t} filter_postings={n_f}")
        timed.append({"QB": QB, "ms": d_ms, "call_ms": c_ms,
                      "plain_ms": p_ms, "bound_ms": b_ms})
    torch.cuda.synchronize()
    return {"max_abs_err": worst, "largest": group_sums(f"B3 {what}",
                                                       timed)}


def phase_bool_msmarco(big: dict, nq: int) -> dict:
    """Two bool traffic mixes of nq bodies over phase 5's segment, in
    BATCH-body msearch requests: bench.py's guardrail configuration
    (after one warm pass over its three filters) and the b3 mix. Each mix
    runs twice, with default totals and with track_total_hits; then the
    checks (the bool kernel == plain on the first b3 batch, card == CPU,
    default page == exact page, the numpy brute force)."""
    from opensearch_tpu_torch import bench_corpus as bc
    from opensearch_tpu_torch.search import fastpath

    client, seg, corpus = big["client"], big["seg"], big["corpus"]
    status, price = big["columns"]
    dev = client.device
    df = corpus[4]
    vs = bc.vocab_strings(len(df))
    queries = bc.pick_queries(df, nq)
    mixes = {"guardrail": [bc.bool_body(i, queries, vs) for i in range(nq)],
             "b3": [bc.b3_body(i, queries, vs) for i in range(nq)]}
    warm = [bc.bool_body(i, queries, vs) for i in range(3)]
    warm_launches = []
    res = {}
    for name, bodies in mixes.items():
        resps, wall, lat, counts, rungs = run_batches(
            client, bodies, warm if name == "guardrail" else (),
            warm_launches)
        log_bool_run(name, nq, wall, lat, counts, rungs, resps)
        if counts["bool_launches"] == 0 or counts["plain_calls"] != 0:
            raise AssertionError(f"{name} mix did not run the bool kernel "
                                 f"only: {counts}")
        exact = [dict(b, track_total_hits=True) for b in bodies]
        e_resps, e_wall, e_lat, e_counts, e_rungs = run_batches(client,
                                                                exact)
        log_bool_run(name + " exact (track_total_hits)", nq, e_wall, e_lat,
                     e_counts, e_rungs, e_resps)
        for b, r, e in zip(bodies, resps, e_resps):
            rh = [(h["_id"], h["_score"]) for h in r["hits"]["hits"]]
            eh = [(h["_id"], h["_score"]) for h in e["hits"]["hits"]]
            rt, et = r["hits"]["total"], e["hits"]["total"]
            if rh != eh or et["relation"] != "eq" or not (
                    rt == et if rt["relation"] == "eq"
                    else rt["value"] <= et["value"]):
                raise AssertionError(f"{name}: default page != exact page "
                                     f"for {b}:\n{r['hits']}\n{e['hits']}")
        log(f"  {name}: default pages == exact pages (ids and scores) for "
            f"all {nq} bodies; totals equal or lower bounds")
        res[name] = {"resps": resps, "counts": counts}
        profile_batch(client, bodies[:BATCH])
    log("  resident bytes added by the bool path: " + " ".join(
        f"{k}={v}" for k, v in filter_bytes(seg, dev).items()))
    base = fastpath.get_aligned(seg, "body", dev)
    warm_b3 = time_bool_launches("guardrail warm pass", warm_launches, base,
                                 big["a_docs"])
    b3 = time_bool_groups(client, seg, mixes["b3"][:BATCH], big["a_docs"])

    # 64 sampled bodies per mix, on the card and on the CPU (one segment,
    # one set of filter lists: the same routes)
    cpu = cpu_twin(seg)
    srng = np.random.default_rng(11)
    for name, bodies in mixes.items():
        sample = sorted(srng.choice(nq, 64, replace=False).tolist())
        lines = sum([[{}, bodies[i]] for i in sample], [])
        on_card = strip_took(client.msearch(lines, index="bench"))
        t0 = time.perf_counter()
        on_cpu = strip_took(cpu.msearch(lines, index="bench"))
        if on_card != on_cpu:
            raise AssertionError(f"{name}: 64 sampled bodies: card and "
                                 f"CPU responses differ")
        log(f"  {name}: 64 sampled bodies, card == CPU responses (CPU "
            f"{time.perf_counter() - t0:.1f}s)")
        # 16 of them against the numpy brute force
        t0 = time.perf_counter()
        for i in sample[:16]:
            slots, fam_msm, mask, const = bool_oracle(name, i, queries,
                                                      status, price)
            ids, scores, total = oracle_page(corpus, slots, fam_msm, mask,
                                             const, 10)
            r = res[name]["resps"][i]["hits"]
            got_ids = [int(h["_id"]) for h in r["hits"]]
            got_sc = np.asarray([h["_score"] for h in r["hits"]])
            T = 2 * (1 << max(len(slots) - 1, 0).bit_length())
            rtol = (T + 1) * 2.0**-23
            t = r["total"]
            if got_ids != ids or not np.allclose(got_sc, scores, rtol=rtol,
                                                 atol=0) or not (
                    t["value"] == total if t["relation"] == "eq"
                    else t["value"] <= total):
                raise AssertionError(
                    f"{name} body {i} != numpy brute force: {got_ids} "
                    f"{got_sc.tolist()} {t} vs {ids} {scores} {total}")
        log(f"  {name}: 16 bodies == numpy brute force (ids, order, scores "
            f"within (T+1)*2^-23, totals) ({time.perf_counter() - t0:.1f}s)")
    return {"guardrail_bool_launches":
            res["guardrail"]["counts"]["bool_launches"],
            "b3_bool_launches": res["b3"]["counts"]["bool_launches"],
            "bool_launches": sum(r["counts"]["bool_launches"]
                                 for r in res.values()),
            "b3": b3["largest"], "warm": warm_b3["largest"],
            "max_abs_err": max(b3["max_abs_err"], warm_b3["max_abs_err"])}


# ---------------------------------------------------------------------
# phase 7: the general path and the impact rung at MS MARCO passage scale
# ---------------------------------------------------------------------

K1, B, OMB = np.float32(1.2), np.float32(0.75), np.float32(1.0 - 0.75)
OP_BODIES = 16     # bodies of a class timed op by op, and profiled


class NumpyIndex:
    """What phase 7's brute force reads, apart from the port: the corpus
    CSR (global doc ids 0..n0-1), the docs indexed after it (global ids
    n0..), the deleted docs and the status / price columns, with the
    collection statistics BM25 takes from them (deleted docs count, as
    Lucene's maxDoc and doc freqs do)."""

    def __init__(self, corpus, columns):
        starts, doc_ids, tfs, dl, df = corpus
        self.starts, self.doc_ids, self.tfs, self.df0 = starts, doc_ids, tfs, df
        self.n0 = len(dl)
        self.dl = dl.astype(np.float32)
        self.sum_dl = int(dl.sum())
        self.status, self.price = columns
        self.live = np.ones(self.n0, bool)
        self.extra: dict = {}          # term -> ([global docs], [tfs])
        self.new_ids: list = []
        self.contrib: dict = {}        # long row -> (docs, BM25 terms)

    @property
    def n(self) -> int:
        return len(self.live)

    def avgdl(self) -> np.float32:
        return np.float32(self.sum_dl / self.n)

    def reindex(self, docs) -> None:
        """docs: [(old local doc, term ids with repeats, status, price)],
        indexed after the corpus under the old doc's `_id`."""
        self.contrib = {}              # the statistics change
        for old, terms, st, pr in docs:
            g = self.n
            self.live[old] = False
            self.live = np.append(self.live, True)
            self.dl = np.append(self.dl, np.float32(len(terms)))
            self.sum_dl += len(terms)
            self.status = np.append(self.status, np.int32(st))
            self.price = np.append(self.price, np.int64(pr))
            for t, tf in Counter(terms).items():
                e = self.extra.setdefault(int(t), ([], []))
                e[0].append(g)
                e[1].append(np.float32(tf))
            self.new_ids.append(str(old))

    def row(self, t: int):
        lo, hi = int(self.starts[t]), int(self.starts[t + 1])
        d, tf = self.doc_ids[lo:hi].astype(np.int64), self.tfs[lo:hi]
        e = self.extra.get(int(t))
        if e is not None:
            d = np.concatenate([d, np.asarray(e[0], np.int64)])
            tf = np.concatenate([tf, np.asarray(e[1], np.float32)])
        return d, tf

    def weight(self, df: int) -> np.float32:
        import math
        return np.float32(math.log(1.0 + (self.n - df + 0.5) / (df + 0.5))
                          if df > 0 else 0.0)

    def group(self, terms, msm: int = 1):
        """BM25 of a `match` (distinct term ids, query order): (scores
        where at least msm terms match, else 0; that mask)."""
        score = np.zeros(self.n, np.float32)
        count = np.zeros(self.n, np.int32)
        avgdl = self.avgdl()
        for t in terms:
            got = self.contrib.get(int(t))
            if got is None:
                d, tf = self.row(t)
                w = self.weight(len(d))
                k = K1 * (OMB + (B * self.dl[d]) / avgdl)
                got = (d, (w * tf) / (tf + k))
                if len(d) >= 1 << 17:  # stopword-class rows recur
                    self.contrib[int(t)] = got
            d, c = got
            score[d] += c
            count[d] += 1
        ok = count >= max(msm, 1)
        return np.where(ok, score, np.float32(0.0)), ok

    def keyword(self, value: int):
        """A `term` on the status keyword in scoring context: BM25 with no
        norms (b 0, dl 0, tf 1)."""
        ok = self.status == value
        k = K1 * (np.float32(1.0) + (np.float32(0.0) * np.float32(0.0))
                  / np.float32(1.0))
        w = self.weight(int(ok.sum()))
        return np.where(ok, (w * np.float32(1.0)) / (np.float32(1.0) + k),
                        np.float32(0.0)).astype(np.float32), ok

    def id_of(self, g: int) -> str:
        return str(g) if g < self.n0 else self.new_ids[g - self.n0]

    def page(self, score, matched, frm: int, size: int) -> tuple:
        """-> (ids, scores, total) of the live matched docs ranked by
        (score desc, doc asc), positions frm..frm+size."""
        docs = np.flatnonzero(matched & self.live)
        sc = score[docs]
        need = frm + size
        if len(docs) > need:
            thr = np.partition(sc, len(sc) - need)[len(sc) - need]
            cand = np.concatenate([docs[sc > thr], docs[sc == thr][:need]])
        else:
            cand = docs
        sel = cand[np.lexsort((cand, -score[cand]))][frm:need]
        return ([self.id_of(int(g)) for g in sel],
                score[sel].astype(np.float32).tolist(), len(docs))


def general_classes(big: dict, n: int) -> dict:
    """Phase 7's traffic: `n` bodies per class, over pick_queries rows
    (mid-df terms, phase 6's seed) and 9-term rows sampled by token mass
    (stopword-class terms in): (name -> [(body, oracle)]), where
    oracle(ix) computes the page's brute force."""
    from opensearch_tpu_torch import bench_corpus as bc
    df = big["corpus"][4]
    vs = bc.vocab_strings(len(df))
    q = bc.pick_queries(df, n)
    q9 = bc.pick_queries_real(df, n, nterms=9, seed=9)
    pub = {"term": {"status": "published"}}

    def text(ts):
        return " ".join(vs[int(t)] for t in ts)

    def match_all(boost, frm):
        return lambda ix: ix.page(np.full(ix.n, np.float32(boost)),
                                  np.ones(ix.n, bool), frm, 10)

    def price(lo, hi):
        return lambda ix: (ix.price >= lo) & (ix.price < hi)

    def rng_page(lo):
        return lambda ix: ix.page(np.ones(ix.n, np.float32),
                                  price(lo, lo + 10)(ix), 0, 10)

    def group_page(ts, frm):
        return lambda ix: ix.page(*ix.group(ts), frm, 10)

    def mixed(ts, st):
        def f(ix):
            s1, ok1 = ix.group(ts)
            s2, ok2 = ix.keyword(st)
            return ix.page((np.float32(0.0) + s1) + s2, ok1 & ok2, 0, 10)
        return f

    def nested(a, b_, lo):
        def f(ix):
            sa, oka = ix.group([a])
            inner = oka & (ix.status == 2) & ix.live
            s_in = np.where(inner, (np.float32(0.0) + sa) * np.float32(1.0),
                            np.float32(0.0))
            sb, okb = ix.group([b_])
            rm = price(lo, lo + 20)(ix) & ix.live
            score = ((np.float32(0.0) + s_in) + sb) + rm.astype(np.float32)
            return ix.page(score, inner | okb | rm, 0, 10)
        return f

    classes = {
        "match_all": [({"query": {"match_all": {"boost": 1.0 + i % 4}},
                        "size": 10}, match_all(1.0 + i % 4, 0))
                      for i in range(n)],
        "match_all_from_1000": [
            ({"query": {"match_all": {"boost": 1.0 + i % 4}}, "from": 1000,
              "size": 10}, match_all(1.0 + i % 4, 1000)) for i in range(n)],
        "range_1pct": [({"query": {"range": {"price": {
            "gte": (97 * i) % 990, "lt": (97 * i) % 990 + 10}}}},
            rng_page((97 * i) % 990)) for i in range(n)],
        "match9": [({"query": {"match": {"body": text(q9[i])}}},
                    group_page(list(q9[i]), 0)) for i in range(n)],
        "match9_exact": [({"query": {"match": {"body": text(q9[i])}},
                           "track_total_hits": True},
                          group_page(list(q9[i]), 0)) for i in range(n)],
        "match2_from_200": [({"query": {"match": {"body": text(q[i][:2])}},
                              "from": 200, "size": 10},
                             group_page(list(q[i][:2]), 200))
                            for i in range(n)],
        "mixed_field_bool": [({"query": {"bool": {"must": [
            {"match": {"body": text(q[i][:2])}},
            {"term": {"status": bc.STATUS_VALUES[i % 3]}}]}}},
            mixed(list(q[i][:2]), i % 3)) for i in range(n)],
        "nested_should_range": [({"query": {"bool": {"should": [
            {"bool": {"must": [{"match": {"body": vs[int(q[i][0])]}}],
                      "filter": [pub]}},
            {"match": {"body": vs[int(q[i][1])]}},
            {"range": {"price": {"gte": (31 * i) % 980,
                                 "lt": (31 * i) % 980 + 20}}}]}}},
            nested(int(q[i][0]), int(q[i][1]), (31 * i) % 980))
            for i in range(n)],
    }
    return classes


def check_page(resp: dict, want: tuple, what: str) -> None:
    """One response against its brute force: ids and order equal (two hits
    may swap only when their scores agree within 1e-6), scores within
    1e-6 relative, the total equal where the relation is eq, else a lower
    bound."""
    ids, scores, total = want
    h = resp["hits"]
    got_ids = [x["_id"] for x in h["hits"]]
    got_sc = np.asarray([x["_score"] for x in h["hits"]], np.float64)
    t = h["total"]
    ok = len(got_ids) == len(ids) and np.allclose(got_sc, scores, rtol=1e-6,
                                                  atol=0) and (
        t["value"] == total if t["relation"] == "eq"
        else t["value"] <= total)
    for j, (g, w) in enumerate(zip(got_ids, ids)):
        if ok and g != w:
            twin = [k for k, x in enumerate(ids) if x == g]
            ok = bool(twin) and abs(scores[twin[0]] - got_sc[j]) \
                <= 1e-6 * abs(scores[twin[0]])
    if not ok:
        raise AssertionError(f"{what} != numpy brute force: {got_ids} "
                             f"{got_sc.tolist()} {t} vs {ids} {scores} "
                             f"{total}")


def op_timer():
    """Wrap the general path's largest ops (the term gather + contribution
    + scatter, the top-k, the impact program) with CUDA events around
    their launches: -> (restore(), {op: [(start, end)]})."""
    import torch
    from opensearch_tpu_torch.ops import scoring
    from opensearch_tpu_torch.search import impactpath
    spans: dict = {}
    saved = []
    for mod, name, label in ((scoring, "score_term_group", "term_scatter"),
                             (scoring, "topk_docs", "topk"),
                             (impactpath, "impact_program",
                              "impact_program")):
        real = getattr(mod, name)

        def timed(*a, _real=real, _label=label, **kw):
            s0 = torch.cuda.Event(enable_timing=True)
            s1 = torch.cuda.Event(enable_timing=True)
            s0.record()
            out = _real(*a, **kw)
            s1.record()
            spans.setdefault(_label, []).append((s0, s1))
            return out
        setattr(mod, name, timed)
        saved.append((mod, name, real))

    def restore():
        for mod, name, real in saved:
            setattr(mod, name, real)
    return restore, spans


def run_general_class(client, name: str, items, ix, sample, cpu,
                      op_ms: dict, memo: dict) -> dict:
    """One class through msearch in BATCH-body requests (counts and rungs
    set to 0 just before), every page against the brute force, the
    sampled bodies on the card against the CPU, OP_BODIES bodies again
    under the op timer: -> the class's numbers."""
    import torch
    from opensearch_tpu_torch.search import compiler as C
    from opensearch_tpu_torch.search import impactpath
    bodies = [b for b, _o in items]
    impactpath.reset_stats()
    C.reset_stats()
    resps, wall, lat, counts, _fp = run_batches(client, bodies)
    rungs = {**{k: impactpath.STATS[k] for k in
                ("served", "pruned_served", "phase2_served", "escalated")},
             "general": C.STATS["general_served"]}
    t0 = time.perf_counter()
    for (b, oracle), r in zip(items, resps):
        # exact-total twins of a body share its brute force
        key = json.dumps({k: v for k, v in b.items()
                          if k != "track_total_hits"}, sort_keys=True)
        if key not in memo:
            memo[key] = oracle(ix)
        check_page(r, memo[key], f"{name} body {b}")
    t_oracle = time.perf_counter() - t0
    lines = sum([[{}, bodies[i]] for i in sample], [])
    t0 = time.perf_counter()
    if strip_took(client.msearch(lines, index="bench")) \
            != strip_took(cpu.msearch(lines, index="bench")):
        raise AssertionError(f"{name}: sampled bodies: card and CPU "
                             f"responses differ")
    t_cpu = time.perf_counter() - t0
    nb = min(OP_BODIES, len(bodies))
    restore, spans = op_timer()
    try:
        client.msearch(sum([[{}, b] for b in bodies[:nb]], []),
                       index="bench")
        torch.cuda.synchronize()
    finally:
        restore()
    ops_ms = {k: sum(a.elapsed_time(e) for a, e in v) / nb
              for k, v in spans.items()}
    op_ms[name] = ops_ms
    rels = Counter(r["hits"]["total"]["relation"] for r in resps)
    n = len(bodies)
    log(f"  {name}: queries={n} batch={BATCH} wall_s={wall:.2f} "
        f"qps={n / wall:.1f} batch_ms_p50={np.percentile(lat, 50):.1f} "
        f"batch_ms_p99={np.percentile(lat, 99):.1f} rungs impact_served="
        f"{rungs['served']} pruned_served={rungs['pruned_served']} "
        f"phase2={rungs['phase2_served']} escalated={rungs['escalated']} "
        f"general={rungs['general']} relations={dict(rels)} kernel "
        f"launches B1={counts['launches']} B2={counts['impact_launches']} "
        f"B3={counts['bool_launches']}; {n} pages == numpy brute force "
        f"({t_oracle:.1f}s); {len(sample)} sampled card == CPU "
        f"({t_cpu:.1f}s); op ms per body " + " ".join(
            f"{k}={v:.4f}" for k, v in sorted(ops_ms.items())))
    return {"qps": n / wall, "p50": float(np.percentile(lat, 50)),
            "p99": float(np.percentile(lat, 99)), "rungs": rungs,
            "op_ms": ops_ms}


def phase_general_msmarco(big: dict, n: int) -> dict:
    """The general path and the impact rung over phase 5's segment: `n`
    bodies per class that the fused kernels decline, then `n` re-indexed
    `_id`s and `n` of phase 5's match bodies over the segments with
    deletes."""
    from opensearch_tpu_torch import RestClient
    from opensearch_tpu_torch import bench_corpus as bc
    client, seg = big["client"], big["seg"]
    dev = client.device
    ix = NumpyIndex(big["corpus"], big["columns"])
    cpu = cpu_twin(seg)
    classes = general_classes(big, n)
    srng = np.random.default_rng(13)
    out: dict = {}
    op_ms: dict = {}
    memo: dict = {}
    idle = {}
    for name, items in classes.items():
        sample = sorted(srng.choice(len(items), 2, replace=False).tolist())
        out[name] = run_general_class(client, name, items, ix, sample, cpu,
                                      op_ms, memo)
        if name in ("match9", "mixed_field_bool"):
            idle[name] = profile_batch(client,
                                       [b for b, _o in items[:OP_BODIES]])
    # re-index n existing _ids: the big segment gets n deleted docs, a new
    # segment takes their new versions
    vs = bc.vocab_strings(len(big["corpus"][4]))
    olds = sorted(srng.choice(seg.ndocs, n, replace=False).tolist())
    terms = big["body_terms"][:n]
    docs = [(old, list(terms[j]) + [terms[j][0]], j % 3, j)
            for j, old in enumerate(olds)]
    t0 = time.perf_counter()
    for old, ts, st, pr in docs:
        r = client.index("bench", {
            "body": " ".join(vs[int(t)] for t in ts),
            "status": bc.STATUS_VALUES[st], "price": pr}, id=str(old))
        if r["result"] != "updated":
            raise AssertionError(f"re-index of _id {old}: {r}")
    client.indices.refresh("bench")
    t_reindex = time.perf_counter() - t0
    ix.reindex(docs)
    segs = client._indices["bench"].engine.segments
    if len(segs) != 2 or segs[0].live_count != seg.ndocs - n:
        raise AssertionError("re-indexing did not leave n deleted docs")
    cpu2 = RestClient(device="cpu")
    cpu2.indices.create("bench", {"mappings": {"properties": {
        "body": {"type": "text"}, "status": {"type": "keyword"},
        "price": {"type": "integer"}}}})
    cpu2._indices["bench"].engine.segments = list(segs)
    items = [(big["bodies"][j], (lambda ts: lambda ix_: ix_.page(
        *ix_.group(ts), 0, 10))(list(terms[j]))) for j in range(n)]
    sample = sorted(srng.choice(n, 2, replace=False).tolist())
    log(f"  re-indexed {n} _ids in {t_reindex:.2f}s: segments "
        f"{[(s.ndocs, s.live_count) for s in segs]}")
    out["reindexed_match"] = run_general_class(
        client, "reindexed_match", items, ix, sample, cpu2, op_ms, {})
    nbytes = {s.name: s.device_nbytes(dev) for s in segs}
    log(f"  general path device arrays (live masks, numeric columns, doc "
        f"lengths, CSR copies; the postings are the aligned layout's): "
        f"{nbytes} bytes")
    return {"classes": out, "device_bytes": nbytes,
            "idle_share_one_batch": idle}


def log_bool_run(what: str, n: int, wall: float, lat, counts, rungs,
                 resps) -> None:
    from opensearch_tpu_torch.search import fastpath
    rels = Counter(r["hits"]["total"]["relation"] for r in resps)
    rest_s = wall - lat[0] / 1e3
    log(f"  {what}: queries={n} batch={BATCH} wall_s={wall:.2f} "
        f"qps={n / wall:.1f} batch_ms_p50={np.percentile(lat, 50):.1f} "
        f"batch_ms_p99={np.percentile(lat, 99):.1f} first_batch_ms="
        f"{lat[0]:.1f} qps_after_first_batch={(n - BATCH) / rest_s:.1f} "
        f"B1 launches={counts['launches']} rows={counts['rows']} "
        f"B2 launches={counts['impact_launches']} "
        f"rows={counts['impact_rows']} "
        f"B3 launches={counts['bool_launches']} rows={counts['bool_rows']} "
        f"plain_calls={counts['plain_calls']} relations={dict(rels)}")
    log(f"  {what}: routes " + " ".join(
        f"{k}={rungs[k]}" for k in BOOL_ROUTES) + " rungs " + " ".join(
        f"{k}={rungs[k]}" for k in RUNGS if k != "shard_view_served"))


def profile_batch(client, bodies) -> float:
    """Where one msearch batch's time goes: device time by kernel and the
    device idle share, then the host functions that hold the time, from
    cProfile on a second run of the same batch. torch.profiler times the
    PyTorch ops; the hand-written kernels, launched through ctypes, are
    timed with CUDA events recorded on their stream right around each C
    launch call (the profiler has been seen to drop their records)."""
    import cProfile
    import pstats
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from opensearch_tpu_torch.ops import _build, bm25

    lines = sum([[{}, b] for b in bodies], [])
    spans = []
    saved = {}
    for name in _build.SIGNATURES:
        lib = _build.load_library(name)
        fn = getattr(lib, f"{name}_launch")
        saved[name] = (lib, fn)

        def timed(*args, _fn=fn, _name=name):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            err = _fn(*args)
            b.record()
            spans.append((_name, a, b))
            return err
        setattr(lib, f"{name}_launch", timed)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            client.msearch(lines, index="bench")
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for name, (lib, fn) in saved.items():
            setattr(lib, f"{name}_launch", fn)
    dev = {}
    for e in prof.key_averages():
        if bm25.KERNEL_NAME in e.key:
            continue                  # counted from the CUDA events below
        if e.device_type == DeviceType.CPU:
            # a host op's device time is its kernels', which are entries
            # of their own
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            dev[e.key] = dev.get(e.key, 0.0) + us / 1e3
    for name, a, b in spans:
        key = f"{name} kernel (CUDA events)"
        dev[key] = dev.get(key, 0.0) + a.elapsed_time(b)
    busy = sum(dev.values())
    idle = 1 - busy / wall_ms
    log(f"  profile of one batch ({len(bodies)} bodies): wall_ms="
        f"{wall_ms:.1f} device_busy_ms={busy:.2f} device_idle_share="
        f"{idle:.4f} (hand-written kernel launches: {len(spans)})")
    for k, v in sorted(dev.items(), key=lambda kv: -kv[1])[:4]:
        log(f"    device {v:9.3f} ms  {k[:90]}")
    pr = cProfile.Profile()
    pr.enable()
    client.msearch(lines, index="bench")
    pr.disable()
    st = pstats.Stats(pr)
    rows = sorted(((v[3], v[2], f) for f, v in st.stats.items()
                   if "opensearch_tpu_torch" in f[0]), reverse=True)
    for cum, tot, (fn, line, name) in rows[:8]:
        log(f"    host cum {cum * 1e3:9.1f} ms self {tot * 1e3:8.1f} ms  "
            f"{fn.split('opensearch_tpu_torch/')[-1]}:{line} {name}")
    return idle


def times(g: dict) -> dict:
    """A kernel's numbers for the kernels line from its largest group
    (group_sums): `ms` is device ms, the card's time alone; `call_ms` has
    the wrapper's host work inside."""
    return {"ms": g["ms"], "device_ms": g["ms"], "call_ms": g["call_ms"],
            "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
            "first_batch_groups": g["groups"], "first_batch_rows": g["rows"],
            "first_batch_sum_device_ms": g["sum_ms"],
            "first_batch_sum_call_ms": g["sum_call_ms"],
            "first_batch_sum_bound_ms": g["sum_bound_ms"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ndocs", type=int, default=NDOCS_MSMARCO)
    # phase 5 ran 2,048 queries before phase 6 shared the time limit
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--bool-queries", type=int, default=1024)
    ap.add_argument("--general-queries", type=int, default=64,
                    help="phase-7 bodies per class")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stop-after", type=int, default=0,
                    help="end after this phase (3 to 6); no result line")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from opensearch_tpu_torch.ops import _build
    t_start = time.perf_counter()

    log("[1] card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)

    log("[2] build")
    t0 = time.perf_counter()
    names = sorted(_build.SIGNATURES)
    with ThreadPoolExecutor(len(names)) as pool:
        reports = dict(zip(names, pool.map(_build.build, names)))
    log(f"  built {', '.join(names)} in {time.perf_counter() - t0:.1f}s "
        f"(one nvcc each, in parallel)")
    for name in names:
        for line in reports[name].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    from opensearch_tpu_torch.ops import bm25
    log("  resident blocks (persistent grid): " + ", ".join(
        f"{n}={bm25.resident_blocks(n, dev)}" for n in names)
        + f"; dynamic shared memory per block: "
        f"{bm25.smem_bytes(names[0], dev)} bytes")

    def rng(part: int):
        # each part's data from its own stream: a part added or changed
        # leaves the others' data as it was
        return np.random.default_rng([args.seed, part])
    log("[3] kernel vs plain")
    grid = phase_kernel_grid(dev, rng(1))
    log(f"  tfdl: {grid['points']} grid points equal")
    igrid = phase_impact_grid(dev, rng(2))
    log(f"  impact: {igrid['points']} grid points equal")
    bgrid = phase_bool_grid(dev, rng(3))
    log(f"  bool: {bgrid['points']} grid points equal")
    if has_probe():
        pgrid = phase_probe_grid(dev, rng(4))
        log(f"  probe: {pgrid['points']} points, list form == probe form "
            f"== plain")
    else:
        pgrid = {"max_abs_err": 0.0}
        log("  probe points skipped: this package's B3 has no probe form")
    ngrid = phase_norms_grid(dev, rng(5))
    log(f"  norms: {ngrid['points']} grid points equal")
    egrid = phase_edge_grid(dev, rng(6))
    log(f"  edges: {egrid['points']} points equal over the four kernels")
    if args.stop_after == 3:
        return 0

    log("[4] slice, small: RestClient on cuda vs cpu")
    phase_slice_small(rng(7))
    if args.stop_after == 4:
        return 0

    log(f"[5] slice at MS MARCO passage scale (ndocs={args.ndocs})")
    if args.ndocs < NDOCS_MSMARCO:
        log(f"  cut: ndocs {args.ndocs} < {NDOCS_MSMARCO} as asked on the "
            f"command line")
    if args.queries < 2048:
        log(f"  cut: {args.queries} match queries (2048 uncut), so that "
            f"phase 6 fits the same time limit")
    big = phase_msmarco(args.ndocs, args.queries)
    if args.stop_after == 5:
        return 0

    log(f"[6] bool traffic at MS MARCO passage scale (ndocs={args.ndocs})")
    bools = phase_bool_msmarco(big, args.bool_queries)
    if args.stop_after == 6:
        return 0

    log(f"[7] the general path and the impact rung at MS MARCO passage "
        f"scale (ndocs={args.ndocs})")
    general = phase_general_msmarco(big, args.general_queries)

    kernels = [{
        "name": "fused_bm25_topk_tfdl", "route": "cuda",
        "source": "opensearch_tpu_torch/csrc/bm25_tfdl.cu",
        "replaces": "opensearch_tpu/ops/pallas_bm25.py:343",
        "launches": big["tfdl_launches"],
        "max_abs_err": max(grid["max_abs_err"], egrid["max_abs_err"],
                           big["max_abs_err"]),
        **times(big["b1"]), "bound_by": "bytes",
        "library_ms": None, "parity": "exact"}, {
        "name": "fused_bm25_topk_impact", "route": "cuda",
        "source": "opensearch_tpu_torch/csrc/bm25_impact.cu",
        "replaces": "opensearch_tpu/ops/pallas_bm25.py:820",
        "launches": big["impact_launches"],
        "max_abs_err": max(igrid["max_abs_err"], egrid["max_abs_err"],
                           big["max_abs_err"]),
        **times(big["b2"]), "bound_by": "bytes",
        "library_ms": None, "parity": "exact"}, {
        "name": "fused_bm25_bool_topk", "route": "cuda",
        "source": "opensearch_tpu_torch/csrc/bm25_bool.cu",
        "replaces": "opensearch_tpu/ops/pallas_bm25.py:570",
        "launches": bools["bool_launches"],
        "max_abs_err": max(bgrid["max_abs_err"], pgrid["max_abs_err"],
                           egrid["max_abs_err"], bools["max_abs_err"]),
        **times(bools["b3"]), "bound_by": "bytes",
        "warm_pass_groups": bools["warm"]["groups"],
        "warm_pass_rows": bools["warm"]["rows"],
        "warm_pass_sum_device_ms": bools["warm"]["sum_ms"],
        "warm_pass_sum_call_ms": bools["warm"]["sum_call_ms"],
        "warm_pass_sum_bound_ms": bools["warm"]["sum_bound_ms"],
        "library_ms": None, "parity": "exact"}, {
        "name": "fused_bm25_topk", "route": "cuda",
        "source": "opensearch_tpu_torch/csrc/bm25_norms.cu",
        "replaces": "opensearch_tpu/ops/pallas_bm25.py:175",
        "launches": 0,
        "max_abs_err": max(ngrid["max_abs_err"], egrid["max_abs_err"]),
        "ms": ngrid["largest"]["ms"], "device_ms": ngrid["largest"]["ms"],
        "call_ms": ngrid["largest"]["call_ms"],
        "plain_ms": ngrid["largest"]["plain_ms"],
        "bound_ms": ngrid["largest"]["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "parity": "exact",
        "note": "no caller in the package; times from the phase-3 grid"}]
    log(f"  total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"general_path": general}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
