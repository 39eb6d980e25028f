#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (opensearch_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--ndocs N] [--seed S]

Phases, each of which fails the script when it fails:
  1. card: name, power limit, torch and CUDA versions;
  2. build: every CUDA source of the port, compiled with nvcc for sm_90a;
  3. kernel vs plain: fused_bm25_topk_tfdl against its plain PyTorch
     version on the card over a grid of shapes; results must be equal;
  4. slice, small: the same bulk and queries through RestClient on the
     card and on the CPU; responses must be identical apart from `took`;
  5. slice at MS MARCO passage scale: a synthetic corpus of --ndocs
     passages searched with RestClient.msearch, sampled queries held
     against the plain version on the card.
Then a line with the kernels' numbers and, last, the device line.
Exits non-zero without a device line when no card is visible.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import Counter

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 peak
NDOCS_MSMARCO = 8_800_000
BATCH = 64                     # msearch bodies per request in phase 5


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of `fn` on the card over `reps` runs (CUDA
    events around each run, after one warm-up run)."""
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
            abs_el = int(a_starts[r]) + off
            dma = (abs_el // 1024) * 1024
            skip = abs_el - dma
            ln = min(df - off, L - skip)
            if ln <= 0:
                continue
            nr = max(8, 1 << int(np.ceil(np.log2(-(-(skip + ln) // 128)))))
            rowstarts[q, t] = dma // 128
            nrows[q, t] = nr
            lens[q, t] = ln
            skips[q, t] = skip
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
                for g, w, what in zip(got, want, ("scores", "ids", "totals")):
                    if not torch.equal(g, w):
                        bad = (g != w).nonzero()[:4].tolist()
                        raise AssertionError(
                            f"kernel != plain ({what}) at T={T} L={L} K={K}:"
                            f" first differing [row, lane] {bad}")
                fin = torch.isfinite(want[0])
                err = float((got[0][fin] - want[0][fin]).abs().max()) \
                    if fin.any() else 0.0
                worst = max(worst, err)
                nv = valid_postings(a_docs, *host[:4], host[7], host[8], L)
                b_ms, nbytes = bound_ms(nv, 64)
                k_ms = cuda_ms(kern, 20)
                p_ms = cuda_ms(plain, 3)
                points += 1
                log(f"  T={T} L={L:6d} K={K:3d} QB=64 equal=yes "
                    f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                    f"bound_ms={b_ms:.5f} bytes={nbytes} "
                    f"valid_postings={nv} launches={launches}")
    return {"points": points, "max_abs_err": worst}


# ---------------------------------------------------------------------
# phase 4: the slice on the card and on the CPU, small
# ---------------------------------------------------------------------

STOPWORDS = ["the", "of", "and", "a", "to", "in", "is"]


def make_text_corpus(rng, ndocs: int):
    """Sentences of Zipf-distributed pseudo-words, stopwords, mixed case,
    punctuation and a few non-ASCII words."""
    sy = ["ka", "lo", "mi", "ra", "te", "su", "no", "vi", "de", "po", "zu",
          "an", "el", "or", "ix", "qu"]
    words = sorted({"".join(rng.choice(sy, int(rng.integers(1, 4))))
                    for _ in range(1500)})
    words += ["café", "naïve", "Zürich", "straße"]
    p = 1.0 / np.arange(1, len(words) + 1) ** 1.05
    p /= p.sum()
    docs = []
    for _ in range(ndocs):
        toks = []
        for _ in range(int(rng.integers(4, 60))):
            toks.append(str(rng.choice(STOPWORDS)) if rng.random() < 0.25
                        else str(rng.choice(words, p=p)))
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


def phase_slice_small(rng) -> dict:
    from opensearch_tpu_torch import RestClient
    from opensearch_tpu_torch.ops import bm25
    from opensearch_tpu_torch.search import fastpath

    docs, words = make_text_corpus(rng, 4000)
    bulk = []
    for i, d in enumerate(docs):
        bulk += [{"index": {"_index": "t", "_id": f"d{i}"}}, d]
    queries = slice_queries(rng, words)
    out = {}
    counts = {}
    for name in ("cuda", "cpu"):
        c = RestClient(device=name)
        c.indices.create("t", {"mappings": {"properties": {
            "body": {"type": "text"}}}})
        t0 = time.perf_counter()
        c.bulk(bulk[:4000], refresh=True)    # two segments
        c.bulk(bulk[4000:], refresh=True)
        t_bulk = time.perf_counter() - t0
        bm25.reset_counts()
        t0 = time.perf_counter()
        ms = c.msearch(sum([[{}, q] for q in queries], []), index="t")
        singles = [c.search("t", q) for q in queries[:10]]
        # a stopword-class term split into doc-range chunks: the per-row
        # budget lowered for this one search
        saved = fastpath.MAX_TL
        fastpath.MAX_TL = 2048
        try:
            chunked = c.search("t", {"query": {"match": {"body": "the"}},
                                     "size": 50})
        finally:
            fastpath.MAX_TL = saved
        t_search = time.perf_counter() - t0
        counts[name] = dict(bm25.COUNTS)
        out[name] = strip_took([ms, singles, chunked])
        log(f"  {name}: bulk+refresh {t_bulk:.2f}s, 51 searches "
            f"{t_search:.2f}s, counts {counts[name]}")
    if out["cuda"] != out["cpu"]:
        for i, (a, b) in enumerate(zip(out["cuda"][0]["responses"],
                                       out["cpu"][0]["responses"])):
            if a != b:
                raise AssertionError(f"msearch response {i} differs: "
                                     f"{queries[i]}\n{a}\n{b}")
        raise AssertionError("search responses differ between cuda and cpu")
    if counts["cuda"]["launches"] == 0 or counts["cuda"]["plain_calls"]:
        raise AssertionError(f"cuda slice did not run the kernel only: "
                             f"{counts['cuda']}")
    hits = sum(r["hits"]["total"]["value"]
               for r in out["cuda"][0]["responses"])
    log(f"  responses identical over {len(queries)} msearch bodies, 10 "
        f"searches and 1 chunked search ({hits} total hits)")
    return counts["cuda"]


# ---------------------------------------------------------------------
# phase 5: MS MARCO passage scale
# ---------------------------------------------------------------------

def phase_msmarco(ndocs: int, nq: int) -> dict:
    import torch
    from opensearch_tpu_torch import RestClient, bench_corpus as bc
    from opensearch_tpu_torch.ops import bm25
    from opensearch_tpu_torch.search import compiler as C, fastpath
    from opensearch_tpu_torch.search import query_dsl as dsl

    t0 = time.perf_counter()
    corpus = bc.build_corpus(ndocs)
    t_corpus = time.perf_counter() - t0
    client = RestClient(device="cuda")
    seg = bc.make_index(client, corpus)
    t1 = time.perf_counter()
    al = fastpath.get_aligned(seg, "body", client.device)
    torch.cuda.synchronize()
    t_align = time.perf_counter() - t1
    starts, _docs, _tfs, dl, df = corpus
    P = len(corpus[1])
    log(f"  corpus: ndocs={ndocs} postings={P} tokens={int(dl.sum())} "
        f"host_build_s={t_corpus:.1f} align_upload_s={t_align:.1f} "
        f"resident_bytes={al.nbytes}")
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
    # main path: RestClient.msearch in batches, counts from 0
    bm25.reset_counts()
    lat = []
    resps = []
    t2 = time.perf_counter()
    for i in range(0, nq, BATCH):
        tb = time.perf_counter()
        resps += client.msearch(sum([[{}, b] for b in bodies[i:i + BATCH]],
                                    []), index="bench")["responses"]
        lat.append((time.perf_counter() - tb) * 1e3)
    wall = time.perf_counter() - t2
    counts = dict(bm25.COUNTS)
    for r in resps:
        hits = r["hits"]["hits"]
        if r["hits"]["total"]["value"] and not hits:
            raise AssertionError(f"hits missing from a response: {r}")
        sc = [h["_score"] for h in hits]
        if not all(np.isfinite(sc)) or sc != sorted(sc, reverse=True):
            raise AssertionError(f"bad scores in a response: {sc}")
    log(f"  msearch: queries={nq} batch={BATCH} wall_s={wall:.2f} "
        f"qps={nq / wall:.1f} batch_ms_p50={np.percentile(lat, 50):.1f} "
        f"batch_ms_p99={np.percentile(lat, 99):.1f} "
        f"kernel_launches={counts['launches']} kernel_rows={counts['rows']}"
        f" plain_calls={counts['plain_calls']}")
    if counts["launches"] == 0 or counts["plain_calls"] != 0:
        raise AssertionError(f"main path did not run the kernel only: "
                             f"{counts}")

    profile_batch(client, bodies[:BATCH])

    ctx = client._indices["bench"].searcher.context()

    def plan(idx):
        lts = [C.rewrite(dsl.parse_query(bodies[i]["query"]), ctx)
               for i in idx]
        return fastpath._prepare_vqueries(seg, ctx, lts, {}, client.device)

    # kernel rows per query, as the planner made them for the main path
    rows_q = {2: [], 6: []}
    for i in range(0, nq, BATCH):
        idx = range(i, min(nq, i + BATCH))
        for j, vq in zip(idx, plan(idx)):
            rows_q[2 if j % 2 == 0 else 6].append(vq.n if vq else 0)
    for nt, rs in rows_q.items():
        hist = sorted(Counter(rs).items())
        log(f"  rows per {nt}-term query: {len(rs)} queries, "
            f"{sum(rs)} rows, histogram (rows: queries) "
            f"{', '.join(f'{r}: {c}' for r, c in hist)}")
    per_batch = [sum(rows_q[2][i:i + BATCH // 2]) +
                 sum(rows_q[6][i:i + BATCH // 2])
                 for i in range(0, nq // 2, BATCH // 2)]
    log(f"  kernel rows per {BATCH}-body batch: min {min(per_batch)} "
        f"median {int(np.median(per_batch))} max {max(per_batch)}")

    worst = 0.0

    def check(pend, what):
        nonlocal worst
        for gvqs, got in pend:
            # rebuild the group's inputs exactly as the launch made them
            sub = fastpath._launch_inputs(gvqs, client.device)
            T, L = gvqs[0].T_pad, max(v.L for v in gvqs)
            k1, b = gvqs[0].k1, gvqs[0].b_eff
            want = bm25.fused_bm25_topk_tfdl_plain(
                al.d_docs, al.d_tfdl, *sub, T=T, L=L, K=16, k1=k1, b=b)
            for g, w, name in zip(got, want, ("scores", "ids", "totals")):
                if not torch.equal(g, w):
                    raise AssertionError(f"{what}: kernel != plain ({name}) "
                                         f"for group T={T} L={L}")
            fin = torch.isfinite(want[0])
            if fin.any():
                worst = max(worst, float((got[0][fin] - want[0][fin]).abs()
                                         .max()))
            yield T, L, k1, b, sub

    # 32 sampled queries: kernel rows against the plain version on the card
    srng = np.random.default_rng(7)
    sample = sorted(srng.choice(nq, 32, replace=False).tolist())
    vqs = plan(sample)
    rows = sum(v.n for v in vqs if v)
    for _ in check(fastpath._launch_groups(seg, vqs, 16, client.device),
                   "sampled queries"):
        pass
    log(f"  32 sampled queries ({rows} kernel rows): kernel == plain")

    # kernel time: every group of the first batch, launched whole as the
    # main path launches it (K = 16 for size 10)
    a_docs = al.d_docs.cpu().numpy()
    timed = None
    for T, L, k1, b, sub in check(fastpath._launch_groups(
            seg, plan(range(BATCH)), 16, client.device), "first batch"):
        QB = sub[0].shape[0]
        k_ms = cuda_ms(lambda: bm25.fused_bm25_topk_tfdl(
            al.d_docs, al.d_tfdl, *sub, T=T, L=L, K=16, k1=k1, b=b), 20)
        p_ms = cuda_ms(lambda: bm25.fused_bm25_topk_tfdl_plain(
            al.d_docs, al.d_tfdl, *sub, T=T, L=L, K=16, k1=k1, b=b), 3)
        host = [s.cpu().numpy() for s in sub]
        nv = valid_postings(a_docs, *host[:4], host[7], host[8], L)
        b_ms, nbytes = bound_ms(nv, QB)
        log(f"  first batch, group T={T} L={L} QB={QB} (whole launch): "
            f"kernel == plain, kernel_ms={k_ms:.3f} plain_ms={p_ms:.3f} "
            f"bound_ms={b_ms:.4f} bytes={nbytes} valid_postings={nv}")
        if timed is None or QB > timed["QB"]:
            timed = {"QB": QB, "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": b_ms}
    return {"launches": counts["launches"], "max_abs_err": worst, **timed}


def profile_batch(client, bodies) -> None:
    """Where one msearch batch's time goes: device time by kernel from
    torch.profiler, and the host functions that hold it, from cProfile
    on a second run of the same batch."""
    import cProfile
    import pstats
    import torch
    from torch.profiler import ProfilerActivity, profile

    lines = sum([[{}, b] for b in bodies], [])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        client.msearch(lines, index="bench")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            dev[e.key] = dev.get(e.key, 0.0) + us / 1e3
    busy = sum(dev.values())
    log(f"  profile of one batch ({len(bodies)} bodies): wall_ms="
        f"{wall_ms:.1f} device_busy_ms={busy:.2f} device_idle_share="
        f"{1 - busy / wall_ms:.4f}")
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ndocs", type=int, default=NDOCS_MSMARCO)
    ap.add_argument("--queries", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
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
    report = _build.build("bm25_tfdl")
    log(f"  built bm25_tfdl in {time.perf_counter() - t0:.1f}s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  bm25_tfdl: {line.strip()}")

    rng = np.random.default_rng(args.seed)
    log("[3] kernel vs plain")
    grid = phase_kernel_grid(dev, rng)
    log(f"  {grid['points']} grid points equal")

    log("[4] slice, small: RestClient on cuda vs cpu")
    phase_slice_small(rng)

    log(f"[5] slice at MS MARCO passage scale (ndocs={args.ndocs})")
    if args.ndocs < NDOCS_MSMARCO:
        log(f"  cut: ndocs {args.ndocs} < {NDOCS_MSMARCO} as asked on the "
            f"command line")
    big = phase_msmarco(args.ndocs, args.queries)

    kernels = [{
        "name": "fused_bm25_topk_tfdl", "route": "cuda",
        "source": "opensearch_tpu_torch/csrc/bm25_tfdl.cu",
        "replaces": "opensearch_tpu/ops/pallas_bm25.py:343",
        "launches": big["launches"],
        "max_abs_err": max(grid["max_abs_err"], big["max_abs_err"]),
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "parity": "exact"}]
    log(f"  total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
