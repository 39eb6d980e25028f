#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (opensearch_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--ndocs N] [--queries Q] [--bool-queries B]
                          [--general-queries G] [--phrase-queries P]
                          [--phrase-sloppy S] [--agg-queries A]
                          [--sort-queries R] [--expand-queries E]
                          [--compound-queries C] [--context-queries X]
                          [--longtail-queries L] [--vector-queries V]
                          [--sparse-queries W] [--field-queries F]
                          [--seed S] [--stop-after N]

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
     passages (with bench.py's guardrail columns, its positional `title`
     field and the aggregation columns `ts` and `rating`) attached as one
     codec-v2 segment, searched with
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
  9. (run after 6, before 7) phrase traffic over the same segment:
     bench.py's config 3 (match_phrase over the title field), 3-term
     sloppy phrases and phrase prefixes from seeded titles, and bench.py's
     mixed stream (50% guardrail bools, 30% matches, 20% phrases); every
     page against the numpy brute force (the exact phrase or the
     median-cost join; the stream's bools against phase 6's pages), 2
     bodies a class on the card against the CPU, the phrase program's
     steps timed, one batch profiled;
  7. the general path and the impact rung over the same segment: bodies
     the fused kernels decline, --general-queries of each class (match_all
     from 0 and from 1000, a ~1% price range, a 9-term match with
     stopword-class terms with default and with exact totals, a 2-term
     match at from 200, a mixed-field bool, a should holding a nested bool
     and a range), then re-indexed _ids and phase 5's match bodies over
     the segments with deletes; every page against a numpy brute force,
     sampled bodies on the card against the CPU, the rung counts, the
     ops' times per body and the device arrays' bytes;
 10. (run after 7, before 8) size-0 analytics bodies over phase 7's end
     state, --agg-queries of each class: (a) terms on status with a
     stats sub on price; (b) a one-month ts filter with a daily or
     monthly date_histogram and an avg of rating; (c) a 2-term match of
     phase 5 with a page, a price histogram and range, rating
     percentiles, price and status cardinalities; (d) filters, missing
     and global; (e) 4 bodies of a quarter's weekly date_histogram
     with a terms sub (one sub-search per bucket); every response against a numpy
     brute force (counts, keys, minima, maxima and pages exact, f32 sums
     within a probabilistic bound, HLL registers and sketch bins by a
     numpy copy of the reference's arithmetic), 2 bodies a class on the
     card against the CPU, the ops' times by step, the device bytes;
 11. (run after 10, before 8) a search results page over phase 7's end
     state (phase 7's re-indexed docs carry ts and a rating in
     [2.0, 2.1) that the big segment lacks), --sort-queries bodies a
     class, body by body through RestClient.search: (a) a 2-term match
     sorted by price asc then ts desc with docvalue_fields and _source
     includes; (b) a ~10% price range newest first, then 4 search_after
     pages each; (c) a rating range sorted ascending, 4 search_after
     pages each, crossing segments at values the other lacks; (d) a
     keyword sort descending then a rating with missing first,
     track_scores; (e) collapse on price (4 bodies with inner_hits);
     every response against a numpy brute force of the sort contract
     (each segment's window by primary key and ascending doc, then the
     full tuple and _id; the cursor strictly after), with the pages that
     differ from the exact page and the hits the reference's cursor
     would drop counted; 2 requests a class on the card against the CPU;
     the sort key, top-k and collapse ops' event ms, the host's sort
     tuples, fetch and highlight ms; and, after phase 8 on the merged
     segment (the kernels decline a segment with deletes), (f) title
     matches with highlighted titles on B2 (pruned) and B1 (exact
     totals), each highlight against the rendered title;
 12. (run after 11, before 8) term-expanding queries over phase 7's end
     state, --expand-queries bodies a class from mid-df terms, through
     RestClient.msearch: a 7- and a 6-char prefix (10 and 100 rows), a
     wildcard with one ? and one *, a regexp with a class and a bound and
     one with an alternation, a fuzzy term (AUTO: 2 edits of 8 chars), a
     fuzzy 2-term match (half with operator and), a match_bool_prefix of
     two terms and a 6-char prefix; and, after phase 8 on the merged
     segment, a 2-term match must with a status keyword range or a body
     prefix in the filter (B3, or the pruned ladder over the filtered
     view); every page against a numpy brute force whose expansion reads
     the vocabulary strings alone (startswith, fnmatch, re.fullmatch, the
     strings within two single edits and a plain OSA check), 2 bodies a
     class on the card against the CPU, the expansions' host ms by kind
     with their rows and postings, the regexp DFA's and fuzzy DP's event
     ms, the gather + mask, term scatter and top-k event ms, one batch a
     class profiled;
 13. (run after 12, before 8) compound and multi-field queries over
     phase 7's end state, --compound-queries bodies a class from mid-df
     body terms and title pool bigrams, through RestClient.msearch: a
     best_fields multi_match over title^2 and body (tie 0.3), a
     most_fields one, a phrase one over a title bigram, a dis_max of a
     body term and a title match (tie 0.7), a boosting of a 2-term
     match by a status term (0.2), a combined_fields over body and
     title^2, a terms_set of 4 high-df body terms whose minimum is each
     doc's rating, a pinned query of 10 ids (a re-indexed one, a repeated
     one, an absent one) over a 2-term match, a bool of two named
     shoulds and a named price range; and, after phase 8 on the merged
     segment, a single-field most_fields multi_match (B3), a 2-term
     match must with a dis_max of a status term and a 1% price range and
     a 10% price range in the filter (B3) and a base64 wrapper of a
     2-term match (the pruned ladder); every page against a numpy brute force of the reference's
     formulas (dis_max, the boosting product, BM25F, the terms_set
     count, pins first) and each named hit's matched_queries, 2 bodies
     a class on the card against the CPU, the event ms of the tf gather,
     the dis_max and BM25F combines, the term scatter and the top-k, the
     device's peak bytes, one batch a class profiled;
 14. (run after 13, before 8) the search body's last options and the
     calls around a search over phase 7's end state, --context-queries
     bodies a class: count of phase 5's matches and phase 6's guardrail
     bools against the brute force's totals; explain: true on matches
     and filtered bools and the explain call on 8 ids, each
     _explanation against a numpy evaluation of the same BM25 and the
     hit's score; terminate_after 1 and a 1ms timeout on the two-segment
     shard (gte totals), a 30s timeout giving the unbounded page; a
     profile tree and validate_query verdicts; field_caps and the index
     reads, and a small index deleted with its device state; then a
     scroll of 8 pages of 500 over a mid-df term (a doc indexed after
     the first page unseen, the pages disjoint and equal to the brute
     force, a 404 after clear_scroll) and a point in time paging a 10%
     price range newest first with 64 re-indexed and 64 deleted _ids
     between its pages (the snapshot rule), a merge of a segment it holds
     (its device state kept until delete_pit, then released), every
     context cleared before phase 8; and, after phase 8 on the merged
     segment, rescored bodies: a 2-term match (B2, B1) and phase 6's b3
     bool shapes (B3) rescored over 50 lanes by a title pool bigram
     phrase or a title term, the score modes cycling, one body of six
     with two rescorers, each page against a numpy brute force of the
     lanes, the rescore's event ms (emit + gather), bodies/s and p50/p99;
     2 bodies a class on the card against the CPU;
 15. (run after 14, before 8) the long-tail aggregations over phase 7's
     end state, --longtail-queries bodies a class: (a) a composite of
     status x day paged by after_key to its end, (b) a monthly
     time-series panel (sum of price with derivative, cumulative_sum,
     moving_fn, serial_diff, the *_bucket siblings and a bucket_sort),
     (c) terms(status) > top_hits (one sub-search a bucket) and a root
     top_hits under a match, (d) multi_terms(status, price), rare_terms
     under a rare term and an adjacency_matrix of three filters, (e)
     weighted_avg, median_absolute_deviation, matrix_stats and an
     auto_date_histogram > avg, (f) significant_terms, a sampler >
     significant_text(title) and a diversified_sampler > avg; every
     response against a numpy brute force (LongtailOracle), one body a
     class on the card against the CPU, bodies/s, p50/p99, event ms by
     op, host ms of partials, finalize, pipelines and refinement, the
     refinement's sub-searches, the device bytes around the phase;
 16. (run after 15, before 8) dense vectors, kNN and hybrid search over
     phase 7's end state: a cosine `vec` field of 768 dims with the
     default IVF method (nlist round(sqrt(n)), nprobe nlist // 8) on
     every corpus passage, its vectors drawn on the card from --seed (a
     mixture of 4,096 unit centres plus noise) and attached to the corpus
     segment; --vector-queries bodies a class (query vectors: passages'
     vectors plus noise; hits fetch `_source` without `vec`): (a) exact
     kNN, (b) IVF kNN at the default probe (its recall@10 against (a)),
     (c) a kNN filtered by a status term and a price range, and a bool of
     a 2-term match with a kNN should, (d) the body's kNN section alone
     and beside a match, (e) hybrid bodies of a 2-term match and a kNN:
     rrf, linear min_max [0.3, 0.7], linear l2, rrf with a terms
     aggregation over the fused window, (f) one msearch of 64 exact
     bodies; every page against a brute force apart from the port (f64
     cosine of the host's vectors, the probe over the card's own lists
     and centroids, the fusion recomputed from the oracle's sub-pages),
     one body a class card == CPU (the CPU twin reusing the card's IVF
     index), bodies/s, p50/p99, the scan's, probe's and top-k's event ms
     a body against their bounds, the k-means and fill seconds, the
     vector device bytes and the process's resident bytes; after phase
     8, one body of (a), (b) and (e) on the merged segment (its IVF
     rebuilt, timed; the hybrid body's match on B1 / B2);
 17. (run after 16, before 8) learned sparse retrieval, rank_feature and
     distance_feature over phase 16's end state: a `rank_features` field
     `emb` with index_impacts on every corpus passage (64 distinct tokens
     a passage, the first distinct of a Zipf(1.1) stream over BERT-base's
     30,522 WordPiece tokens, weights expovariate(1) + 0.05 to 3 places,
     drawn from --seed on the card and made CSR there, its FEATURE plane
     quantized there) and a log-normal `pagerank` rank_feature column,
     attached to the corpus segment; --sparse-queries bodies a class
     (bench.py's learned-sparse queries: 3 rare head tokens, up to 8
     popular tail tokens): (a) neural_sparse on the pruned sparse rung,
     (b) the same with exact totals, (c) neural_sparse in a bool with a
     match and a status filter (the general path's sparse dot), (d) a
     match with rank_feature shoulds over a feature and the column (each
     function), (e) a match with a distance_feature on `ts`, (f) hybrids
     of a match, a neural_sparse and an exact kNN on `vec` (rrf, linear
     min_max); every page against a brute force apart from the port (the
     f32 sparse dot in token order, the feature functions, the f32 hi/lo
     distance, the fusion of its sub-pages), one body a class card ==
     CPU, bodies/s, p50/p99, the rung's device pass, the feature scatter
     and the top-k in event ms a body against their byte bounds, the
     rung's planning and certificate in host ms, the rung's counts, the
     CSR's and the plane's seconds, device bytes and host RSS; after
     phase 8, one body of (a), (c) and (f) on the merged segment (its
     FEATURE plane rebuilt, against numpy on sampled rows);
 18. (run after 17, before 8) text analysis and the scalar field types
     over phase 17's end state: `title_en`, an english-analyzed text
     field made from the title's own draw (each of the 1,000 title terms
     an English surface form, bench_corpus.english_title_forms: 30
     stopwords at the most drawn ranks, the rest stems x inflections;
     each form analyzed once, the tokens remapped, stopwords dropped with
     their position gaps kept and sorted into postings on the card, its
     codec-v2 plane built there), and on every corpus passage `client_ip`
     (ip: 65,536 addresses in 16 /16 subnets, Zipf(1.1)), `stock`
     (short), `grade` (byte), `price_scaled` (scaled_float, factor 100),
     `views` (unsigned_long, a third at or past 2^63) and `shop`
     (constant_keyword); --field-queries bodies a class: (a) a pruned
     english match of inflected words and a stopword, (b) the same with
     exact totals, (c) the match in a bool with a CIDR filter and a short
     range, (d) a match sorted by views desc with docvalue_fields of
     client_ip and views, (e) size-0 ip_range, terms on client_ip and
     stats on price_scaled; every page against a numpy brute force
     (FtOracle), one body a class card == CPU, the routes each class
     took, the phase's seconds, device bytes and host RSS; after phase 8,
     one body of (a), (b), (c) and (e) on the merged segment (title_en's
     rows against the live passages');
  8. writes and a merge over the same segment: bulk deletes of 1% of its
     _ids, updates of phase 7's re-indexed _ids and as many upserts, a
     refresh, 8 of phase 5's match bodies on the segments with deletes,
     then a forcemerge into one segment with OPENSEARCH_TPU_REORDER=0
     (the reference's BP reorder is not ported; the merge's time by
     step, the device bytes and host RSS around it) and, on it, the same
     8 bodies in one batch, then pruned and with exact totals, and the b3
     mix's price-range bodies, each class on its kernel alone, 16 config-3
     phrases on the general path (positions through the merge) and 4
     class-(a)/(b) agg bodies (keyword and date columns through it);
     every page against the numpy brute force with the writes applied,
     2 bodies a class on the card against the CPU. Phase 4 runs the write
     path small on the card and the CPU (tiered and forced merges, bulk
     deletes and updates, flush and recovery). Phase 4 then runs a small
     vector index on both: three 64-dim fields (cosine, dot_product,
     l2_norm), each with an IVF method, 2,700 docs in 9 refreshes (a
     tiered merge) with deletes; exact and IVF pages, a filtered kNN, kNN
     in a bool, the body's kNN section and hybrid bodies card == CPU
     within tolerance (scores 1e-6 relative, an L2 score the rounding of
     its expansion), the IVF lists built on the card equal to the CPU's
     but where rows tie, then the pages through a flush, a recovery and a
     forcemerge. Phase 4 last runs a small sparse index on both: 7,000
     docs (rank_features with index_impacts, a rank_feature, a date) in
     two refreshes with deletes, each segment's FEATURE plane (the first
     quantized on the card) and the merged one against their numpy form,
     neural_sparse, rank_feature, distance_feature and hybrid pages card
     == CPU before and after a forcemerge. Phase 4 then runs a small
     field-type index on both (phase_fields_small): 8,000 docs with every
     language analyzer but smartcn, custom char filters, tokenizers,
     token filters and a normalizer, every scalar type of phase 18 and
     match_only_text, search_as_you_type, binary, alias, token_count,
     icu_collation_keyword, store / copy_to / null_value and a dynamic
     template; its bodies and indices.analyze calls card == CPU (agg
     sums within 1e-4 relative) before and after a forcemerge, pages
     against a numpy brute force.
Every timed kernel reports device ms (the card's time alone: calls queued
behind a sleep kernel, `device_ms`) and call ms (events around one whole
call, the wrapper's host work inside). Then a line with phase 9's
numbers, one with phase 7's, one with phase 10's, one with phase 8's,
one with phase 11's, one with phase 12's, one with phase 13's, one with
phase 14's, one with phase 15's, one with phase 16's, one with phase
17's, one with phase 18's, a line with the kernels' numbers and, last,
the device line.
Exits non-zero without a device line when no card is visible.
`--stop-after N` ends after phase N (a quick build-and-check run); it
prints neither result line.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import gc
import json
import math
import os
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 peak
NDOCS_MSMARCO = 8_800_000
BATCH = 64                     # msearch bodies per request in phase 5
PHASE5_CPU_BODIES = 8          # phase 5's bodies held card == CPU
PHASE6_CPU_BODIES = 32         # phase 6's bodies a mix held card == CPU
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
    holding a nested bool and a range, exists and ids, and phrases (a
    sloppy match_phrase, a match_phrase_prefix, an unordered span_near,
    a phrase filter)."""
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
        {"query": {"match_phrase": {"body": {"query": f"{a} {b}",
                                             "slop": 3}}}},
        {"query": {"match_phrase_prefix": {"body": f"{a} {b[:1]}"}}},
        {"query": {"span_near": {"clauses": [
            {"span_term": {"body": a}}, {"span_term": {"body": c}}],
            "slop": 4, "in_order": False}}},
        {"query": {"bool": {"must": [{"match": {"body": a}}], "filter": [
            {"match_phrase": {"body": {"query": f"{b} {c}", "slop": 2}}}]}}},
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


def run_writes_small(name: str, bulk, bodies) -> tuple:
    """The write path at phase 4's size on `name`, under a data path: 8
    refreshes of 250 docs (the 8th merges the tier), a 9th refresh, then
    a bulk that deletes most of the 9th segment's docs and updates and
    upserts others (its refresh merges that segment alone), `bodies`
    served; flush, a second RestClient on the same data path serving
    `bodies` equal; a forcemerge into one segment, whose `bodies` the
    kernels serve: -> (responses without `took`, layouts, kernel counts
    after the forcemerge)."""
    import tempfile
    from opensearch_tpu_torch import RestClient
    from opensearch_tpu_torch.ops import bm25

    docs = [dict(bulk[2 * i + 1]) for i in range(2250)]
    mapping = {"mappings": {"properties": {
        "body": {"type": "text"}, "status": {"type": "keyword"},
        "price": {"type": "integer"}}}}
    lines = sum([[{}, q] for q in bodies], [])
    with tempfile.TemporaryDirectory() as path:
        c = RestClient(device=name, data_path=path)
        c.indices.create("w", mapping)
        layouts = []
        for r in range(9):
            c.bulk(sum([[{"index": {"_index": "w", "_id": f"d{i}"}},
                         docs[i]] for i in range(250 * r, 250 * (r + 1))],
                       []), refresh=True)
            layouts.append([(s.name, s.ndocs, s.live_count)
                            for s in c._indices["w"].engine.segments])
        writes = [{"delete": {"_index": "w", "_id": f"d{i}"}}
                  for i in range(2000, 2200)]
        for i in range(0, 2000, 97):
            writes += [{"update": {"_index": "w", "_id": f"d{i}"}},
                       {"doc": {"price": 1000 + i, "status": "draft"}}]
        for i in range(20):
            writes += [{"update": {"_index": "w", "_id": f"u{i}"}},
                       {"doc": docs[i], "doc_as_upsert": True}]
        res = [strip_took(c.bulk(writes, refresh=True))]
        layouts.append([(s.name, s.ndocs, s.live_count)
                        for s in c._indices["w"].engine.segments])
        res.append(strip_took(c.msearch(lines, index="w")))
        c.indices.flush("w")
        c.close()
        c = RestClient(device=name, data_path=path)
        again = strip_took(c.msearch(lines, index="w"))
        if again != res[-1]:
            raise AssertionError(f"{name}: responses after recovery differ")
        c.indices.forcemerge("w")
        layouts.append([(s.name, s.ndocs, s.live_count)
                        for s in c._indices["w"].engine.segments])
        bm25.reset_counts()
        res.append(strip_took(c.msearch(lines, index="w")))
        counts = dict(bm25.COUNTS)
        c.close()
    log(f"  {name}: writes, small: layouts after each refresh (name, "
        f"ndocs, live) {layouts[7:]}; flush + recovery served equal "
        f"responses; after the forcemerge counts {counts}")
    return res, layouts, counts


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
    wr = {name: run_writes_small(name, bulk, bodies[:8] + bool_bodies[:3]
                                 + general_bodies[:3])
          for name in ("cuda", "cpu")}
    if wr["cuda"][:2] != wr["cpu"][:2]:
        raise AssertionError("writes, small: responses or segment layouts "
                             "differ between cuda and cpu")
    layouts, wcounts = wr["cuda"][1], wr["cuda"][2]
    if not layouts[7][0][0].startswith("_m") \
            or not any(n.startswith("_m") for n, _d, _l in layouts[9][1:]) \
            or len(layouts[10]) != 1:
        raise AssertionError(f"writes, small: the tiered merge, the "
                             f"mostly-deleted segment's merge or the "
                             f"forcemerge did not run: {layouts}")
    if wcounts["launches"] + wcounts["impact_launches"] == 0 \
            or wcounts["bool_launches"] == 0 or wcounts["plain_calls"]:
        raise AssertionError(f"writes, small: the kernels did not serve "
                             f"the merged segment: {wcounts}")
    log("  writes, small: cuda == cpu (bulk items, responses after the "
        "merges, after recovery and after the forcemerge; segment layouts)")
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


def at(t_start: float) -> str:
    """' (t=.. s)': seconds since the run started, for a phase header."""
    return f" (t={time.perf_counter() - t_start:.1f} s)"


def after_first(n: int, wall: float, lat) -> str:
    """'first_batch_ms=.. qps_after_first_batch=.. ' for a run of more
    than one batch (the first pays the lazily built per-row state), else
    ''."""
    if len(lat) < 2:
        return ""
    return (f"first_batch_ms={lat[0]:.1f} qps_after_first_batch="
            f"{(n - BATCH) / (wall - lat[0] / 1e3):.1f} ")


def log_run(what: str, n: int, wall: float, lat, counts, rungs, resps):
    rels = Counter(r["hits"]["total"]["relation"] for r in resps)
    log(f"  {what}: queries={n} batch={BATCH} wall_s={wall:.2f} "
        f"qps={n / wall:.1f} batch_ms_p50={np.percentile(lat, 50):.1f} "
        f"batch_ms_p99={np.percentile(lat, 99):.1f} "
        f"{after_first(n, wall, lat)}"
        f"tfdl_launches={counts['launches']} tfdl_rows={counts['rows']} "
        f"impact_launches={counts['impact_launches']} "
        f"impact_rows={counts['impact_rows']} "
        f"plain_calls={counts['plain_calls']} relations={dict(rels)}")
    log(f"  {what}: rungs " + " ".join(f"{k}={rungs[k]}" for k in RUNGS))


BENCH_MAPPING = {"mappings": {"properties": {
    "body": {"type": "text"}, "title": {"type": "text"},
    "status": {"type": "keyword"}, "price": {"type": "integer"},
    "ts": {"type": "date"}, "rating": {"type": "double"}}}}


def cpu_twin(seg):
    """A RestClient on the CPU over the same segment object (the bench
    index's mappings)."""
    from opensearch_tpu_torch import RestClient
    cpu = RestClient(device="cpu")
    cpu.indices.create("bench", BENCH_MAPPING)
    cpu._indices["bench"].engine.segments = [seg]
    return cpu


class HostDraws:
    """Phase 5's host draws (the body's token keys, the title corpus, the
    guardrail and aggregation columns: numpy, from their seeds) on a
    daemon thread started before phase 1, so they run beside phases 1-4
    (numpy's draws release the interpreter lock); `get()` waits for them
    and raises what the thread raised."""

    def __init__(self, ndocs: int):
        import threading
        self.ndocs = ndocs
        self.out = self.err = None
        self.t0 = time.perf_counter()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        from opensearch_tpu_torch import bench_corpus as bc
        try:
            t0 = time.perf_counter()
            keys = bc.corpus_keys(self.ndocs)
            columns = bc.guardrail_columns(self.ndocs)
            aggcols = bc.agg_columns(self.ndocs)
            t1 = time.perf_counter()
            title = bc.build_title_corpus(self.ndocs)
            self.out = (keys, columns, aggcols, title, t1 - t0,
                        time.perf_counter() - t1)
        except BaseException as e:     # re-raised by get()
            self.err = e

    def get(self) -> tuple:
        """The draws, once: this object lets go of them (the keys alone
        are 4.2 GB at 8.8M passages)."""
        t0 = time.perf_counter()
        self.thread.join()
        if self.err is not None:
            raise self.err
        self.wait_s = time.perf_counter() - t0
        out, self.out = self.out, None
        return out


def phase_msmarco(ndocs: int, nq: int, draws: HostDraws = None) -> dict:
    import torch
    from opensearch_tpu_torch import RestClient, bench_corpus as bc
    from opensearch_tpu_torch.ops import bm25
    from opensearch_tpu_torch.search import compiler as C, fastpath
    from opensearch_tpu_torch.search import query_dsl as dsl

    draws = draws or HostDraws(ndocs)
    keys, columns, aggcols, title, t_keys, t_title = draws.get()
    t0 = time.perf_counter()
    corpus = bc.build_corpus(ndocs, device="cuda", keys=keys)
    del keys
    t_corpus = t_keys + time.perf_counter() - t0
    log(f"  host draws (token keys, title, columns) {t_keys + t_title:.1f}s "
        f"on a thread beside phases 1-4; phase 5 waited {draws.wait_s:.1f}s "
        f"for them")
    client = RestClient(device="cuda")
    dev = client.device
    t1 = time.perf_counter()
    # the guardrail columns ride the same segment for phase 6, the
    # positional title field for phase 9 (its text in each _source for
    # phase 11's highlights), the aggregation columns for phases 10, 11
    # and 8; no query of this phase reads them
    seg = bc.make_index(client, corpus, columns=columns, title=title,
                        aggs=aggcols, title_source=True)
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
    tpb = seg.postings["title"]
    log(f"  title (positional, bench.py's config 3): postings={tpb.size} "
        f"positions={len(tpb.positions)} host_build_s={t_title:.1f} "
        f"(planes_s includes its impact plane)")
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
    # same segment object (16 of them since phase 12 shared the time
    # limit: the CPU took 26.5-43.0 s for 64; 8 since phase 16 did)
    srng = np.random.default_rng(7)
    sample = sorted(srng.choice(nq, PHASE5_CPU_BODIES, replace=False)
                    .tolist())
    lines = sum([[{}, bodies[i]] for i in sample], [])
    cpu = cpu_twin(seg)
    t3 = time.perf_counter()
    on_cpu = strip_took(cpu.msearch(lines, index="bench"))
    t_cpu = time.perf_counter() - t3
    on_card = strip_took(client.msearch(lines, index="bench"))
    if on_card != on_cpu:
        raise AssertionError(f"{len(sample)} sampled bodies: card and CPU "
                             f"responses differ")
    log(f"  {len(sample)} sampled bodies: card == CPU responses (CPU "
        f"{t_cpu:.1f}s)")
    return {"tfdl_launches": d_counts["launches"],
            "impact_launches": counts["impact_launches"],
            "max_abs_err": worst, "b1": b1, "b2": b2, "client": client,
            "seg": seg, "corpus": corpus, "columns": columns,
            "title": title, "aggs": aggcols, "a_docs": a_docs,
            "bodies": bodies,
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

    # PHASE6_CPU_BODIES sampled bodies per mix (64 before phase 16
    # shared the time limit), on the card and on the CPU (one segment,
    # one set of filter lists: the same routes)
    cpu = cpu_twin(seg)
    srng = np.random.default_rng(11)
    for name, bodies in mixes.items():
        sample = sorted(srng.choice(nq, PHASE6_CPU_BODIES,
                                    replace=False).tolist())
        lines = sum([[{}, bodies[i]] for i in sample], [])
        on_card = strip_took(client.msearch(lines, index="bench"))
        t0 = time.perf_counter()
        on_cpu = strip_took(cpu.msearch(lines, index="bench"))
        if on_card != on_cpu:
            raise AssertionError(f"{name}: {len(sample)} sampled bodies: "
                                 f"card and CPU responses differ")
        log(f"  {name}: {len(sample)} sampled bodies, card == CPU "
            f"responses (CPU {time.perf_counter() - t0:.1f}s)")
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
    return {"queries": queries,
            "guardrail_resps": res["guardrail"]["resps"],
            "guardrail_bool_launches":
            res["guardrail"]["counts"]["bool_launches"],
            "b3_bool_launches": res["b3"]["counts"]["bool_launches"],
            "bool_launches": sum(r["counts"]["bool_launches"]
                                 for r in res.values()),
            "b3": b3["largest"], "warm": warm_b3["largest"],
            "max_abs_err": max(b3["max_abs_err"], warm_b3["max_abs_err"])}


# ---------------------------------------------------------------------
# phase 9: phrase traffic (bench.py's config 3 and its mixed stream)
# ---------------------------------------------------------------------

def title_tokens(title, docs, ndocs: int) -> dict:
    """{doc: [title term row by position]} of the docs `docs` (of
    `ndocs`), read back from the positional CSR."""
    starts, tdocs, _tfs, pos_starts, positions = title[:5]
    want = np.zeros(ndocs, bool)
    want[np.asarray(docs, np.int64)] = True
    idx = np.flatnonzero(want[tdocs])
    rows = np.searchsorted(starts, idx, side="right") - 1
    out = {int(d): {} for d in docs}
    for j, r in zip(idx.tolist(), rows.tolist()):
        d = int(tdocs[j])
        for p in positions[pos_starts[j]:pos_starts[j + 1]].tolist():
            out[d][p] = r
    return {d: [t[p] for p in sorted(t)] for d, t in out.items()}


def phrase_classes(title, ndocs: int, nq: int, n_sp: int,
                   seed: int = 23) -> dict:
    """Phase 9's phrase bodies with their brute-force oracles: config 3
    (bench.py's phrase_body, `nq` of them) and `n_sp` bodies taken from
    seeded titles, half a 3-term match_phrase with slop 2 (the tokens as
    they stand, or with one token between the first and second), half a
    match_phrase_prefix whose last term is cut to 2 characters."""
    from opensearch_tpu_torch import bench_corpus as bc
    tvs = bc.title_vocab_strings(len(title[0]) - 1)
    first, second = title[5], title[6]
    pairs = bc.pick_phrase_pairs(title[7], nq)

    def oracle(terms, slop=0, prefix=False):
        return lambda ix: ix.phrase_page(terms, slop, prefix)

    config3 = [(bc.phrase_body(i, pairs, title),
                oracle([tvs[first[pairs[i]]], tvs[second[pairs[i]]]]))
               for i in range(nq)]
    rng = np.random.default_rng(seed)
    docs = sorted(rng.choice(ndocs, n_sp, replace=False).tolist())
    toks = title_tokens(title, docs, ndocs)
    sloppy, prefix = [], []
    for k, d in enumerate(docs):
        t = [tvs[r] for r in toks[d]]
        j = int(rng.integers(0, len(t) - 3))
        if k % 2 == 0:
            terms = ([t[j], t[j + 1], t[j + 2]] if k % 4 == 0
                     else [t[j], t[j + 2], t[j + 3]])
            sloppy.append(({"query": {"match_phrase": {"title": {
                "query": " ".join(terms), "slop": 2}}}, "size": 10},
                oracle(terms, 2)))
        else:
            terms = [t[j], t[j + 1], t[j + 2][:2]]
            prefix.append(({"query": {"match_phrase_prefix": {
                "title": " ".join(terms)}}, "size": 10},
                oracle(terms, 0, True)))
    return {"config3": config3, "sloppy": sloppy, "prefix": prefix,
            "pairs": pairs}


def phrase_op_timer():
    """Wrap the phrase program's steps: the host pair build (host
    seconds) and, with CUDA events around their launches, the pair join
    (searches and costs), the frequency accumulation, the score and the
    top-k: -> (restore(), {step: [(start, end)]}, {host step: s})."""
    import torch
    from opensearch_tpu_torch.ops import positions, scoring
    from opensearch_tpu_torch.search import compiler as C
    spans: dict = {}
    host = {"pair_build_s": 0.0}
    saved = []
    for mod, name, label in ((positions, "anchor_weights", "pair_join"),
                             (positions, "accumulate_freqs",
                              "freq_accumulate"),
                             (positions, "phrase_score", "phrase_score"),
                             (scoring, "topk_docs", "topk")):
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
    real_pairs = C.phrase_pairs

    def pairs(*a, **kw):
        t0 = time.perf_counter()
        out = real_pairs(*a, **kw)
        host["pair_build_s"] += time.perf_counter() - t0
        return out
    C.phrase_pairs = pairs
    saved.append((C, "phrase_pairs", real_pairs))

    def restore():
        for mod, name, real in saved:
            setattr(mod, name, real)
    return restore, spans, host


def pair_cache_bytes(seg, dev) -> int:
    """Device bytes of the segment's phrase pair keys on `dev`."""
    return sum(v.numel() * v.element_size()
               for k, v in seg.device_arrays.items()
               if k[0] == "pairs" and k[-1] == str(dev))


def run_phrase_class(client, name: str, bodies, check, sample, cpu,
                     seg) -> dict:
    """One phase-9 class through msearch in BATCH-body requests (counts,
    rungs and the general path's count set to 0 just before; the host
    pair build timed through the run), `check(i, response)` on every
    page, the sampled bodies on the card against the CPU, OP_BODIES
    phrase bodies again under the step timer, one batch profiled: -> the
    class's numbers."""
    import torch
    from opensearch_tpu_torch.search import compiler as C
    from opensearch_tpu_torch.search import impactpath
    dev = client.device
    impactpath.reset_stats()
    C.reset_stats()
    restore, _spans, host = phrase_op_timer()
    try:
        resps, wall, lat, counts, rungs = run_batches(client, bodies)
    finally:
        restore()
    general = C.STATS["general_served"]
    impact = impactpath.STATS["served"]
    t0 = time.perf_counter()
    for i, r in enumerate(resps):
        check(i, r)
    t_oracle = time.perf_counter() - t0
    lines = sum([[{}, bodies[i]] for i in sample], [])
    t0 = time.perf_counter()
    if strip_took(client.msearch(lines, index="bench")) \
            != strip_took(cpu.msearch(lines, index="bench")):
        raise AssertionError(f"{name}: sampled bodies: card and CPU "
                             f"responses differ")
    t_cpu = time.perf_counter() - t0
    phr = [b for b in bodies if "match_phrase" in b["query"]
           or "match_phrase_prefix" in b["query"]][:OP_BODIES]
    restore, spans, _host = phrase_op_timer()
    try:
        client.msearch(sum([[{}, b] for b in phr], []), index="bench")
        torch.cuda.synchronize()
    finally:
        restore()
    step_ms = {k: sum(a.elapsed_time(e) for a, e in v) / max(len(phr), 1)
               for k, v in spans.items()}
    idle = profile_batch(client, bodies[:BATCH])
    n = len(bodies)
    nbytes = pair_cache_bytes(seg, dev)
    log(f"  {name}: queries={n} batch={BATCH} wall_s={wall:.2f} "
        f"qps={n / wall:.1f} batch_ms_p50={np.percentile(lat, 50):.1f} "
        f"batch_ms_p99={np.percentile(lat, 99):.1f} "
        f"{after_first(n, wall, lat)}routes general={general} "
        f"impact_served={impact} kernel launches B1={counts['launches']} "
        f"B2={counts['impact_launches']} B3={counts['bool_launches']} "
        f"plain_calls={counts['plain_calls']} rungs " + " ".join(
            f"{k}={v}" for k, v in rungs.items() if v)
        + f"; host pair build {host['pair_build_s']:.2f}s; {n} pages "
        f"checked ({t_oracle:.1f}s); {len(sample)} sampled card == CPU "
        f"({t_cpu:.1f}s); event ms per phrase body "
        + " ".join(f"{k}={v:.4f}" for k, v in sorted(step_ms.items()))
        + f"; pair cache device bytes {nbytes}")
    out = {"qps": n / wall, "p50": float(np.percentile(lat, 50)),
           "p99": float(np.percentile(lat, 99)), "first_batch_ms": lat[0],
           "general": general, "impact_served": impact, "counts": counts,
           "rungs": rungs, "host_pair_build_s": host["pair_build_s"],
           "step_event_ms_per_body": step_ms, "idle_share_one_batch": idle,
           "pair_cache_bytes": nbytes}
    if len(lat) > 1:
        out["qps_after_first_batch"] = (n - BATCH) / (wall - lat[0] / 1e3)
    return out


def phase_phrase_msmarco(big: dict, bools: dict, nq: int, n_sp: int,
                         n_mixed: int) -> dict:
    """bench.py's config 3 (`nq` phrase_body bodies), sloppy and prefix
    phrases (`n_sp`, from seeded titles) and its mixed stream (`n_mixed`
    mixed_body bodies) over phase 5's segment after phase 6's filters
    were built; no state changes. Every config-3, sloppy and prefix page
    against the numpy brute force's phrase (exact or median-cost join);
    the mixed stream's bools against phase 6's responses to the same
    bodies (checked there), its matches and phrases against the brute
    force; 2 bodies a class on the card against the CPU."""
    from opensearch_tpu_torch import bench_corpus as bc
    client, seg = big["client"], big["seg"]
    ix = big.get("ix")
    if ix is None:
        ix = big["ix"] = NumpyIndex(big["corpus"], big["columns"],
                                    big["title"])
    cpu = cpu_twin(seg)
    title = big["title"]
    t0 = time.perf_counter()
    classes = phrase_classes(title, seg.ndocs, nq, n_sp)
    log(f"  bodies: {nq} config 3, {len(classes['sloppy'])} sloppy, "
        f"{len(classes['prefix'])} prefix, {n_mixed} mixed "
        f"({time.perf_counter() - t0:.1f}s to pick)")
    srng = np.random.default_rng(29)
    memo: dict = {}
    out: dict = {}

    def checker(name, items):
        def check(i, r):
            b = json.dumps(items[i][0], sort_keys=True)
            if b not in memo:
                memo[b] = items[i][1](ix)
            check_page(r, memo[b], f"{name} body {items[i][0]}")
        return check

    for name in ("config3", "sloppy", "prefix"):
        items = classes[name]
        sample = sorted(srng.choice(len(items), 2, replace=False).tolist())
        out[name] = run_phrase_class(client, name, [b for b, _o in items],
                                     checker(name, items), sample, cpu, seg)
        c = out[name]["counts"]
        if out[name]["general"] != len(items) or c["launches"] \
                or c["impact_launches"] or c["bool_launches"] \
                or c["plain_calls"]:
            raise AssertionError(f"{name}: phrases not served by the "
                                 f"general path alone: {out[name]}")
    # the mixed stream: bench.py's mixed_body over phase 6's queries
    df = big["corpus"][4]
    vs = bc.vocab_strings(len(df))
    queries = bools["queries"]
    if n_mixed > len(queries):
        raise AssertionError("the mixed stream needs phase 6's bodies")
    pairs = classes["pairs"]
    if n_mixed > len(pairs):
        pairs = bc.pick_phrase_pairs(title[7], n_mixed)
    bodies = [bc.mixed_body(i, queries, vs, pairs, title)
              for i in range(n_mixed)]
    tvs = bc.title_vocab_strings(len(title[0]) - 1)

    def check_mixed(i, r):
        r10 = i % 10
        if r10 < 5:
            if strip_took(r) != strip_took(bools["guardrail_resps"][i]):
                raise AssertionError(f"mixed body {i}: the guardrail bool's"
                                     f" page differs from phase 6's")
        elif r10 < 8:
            check_page(r, ix.group_page([int(t) for t in queries[i][:2]]),
                       f"mixed match body {bodies[i]}")
        else:
            b = json.dumps(bodies[i], sort_keys=True)
            if b not in memo:
                pi = pairs[i]
                memo[b] = ix.phrase_page([tvs[title[5][pi]],
                                          tvs[title[6][pi]]])
            check_page(r, memo[b], f"mixed phrase body {bodies[i]}")

    sample = sorted(srng.choice(n_mixed, 2, replace=False).tolist())
    out["mixed"] = run_phrase_class(client, "mixed", bodies, check_mixed,
                                    sample, cpu, seg)
    c = out["mixed"]
    kinds = Counter("bool" if i % 10 < 5 else "match" if i % 10 < 8
                    else "phrase" for i in range(n_mixed))
    launched = sum(c["counts"][k] for k in ("launches", "impact_launches",
                                            "bool_launches"))
    if c["general"] != kinds["phrase"] \
            or c["rungs"]["bool_served"] != kinds["bool"] \
            or c["rungs"]["pure_served"] != kinds["match"] or not launched \
            or c["counts"]["plain_calls"]:
        raise AssertionError(f"mixed: the bools and matches did not keep "
                             f"their kernels, or the phrases their general "
                             f"path: {c}")
    log(f"  mixed: {n_mixed} pages checked (bools == phase 6's pages, "
        f"matches and phrases == numpy brute force)")
    return out


# ---------------------------------------------------------------------
# phase 7: the general path and the impact rung at MS MARCO passage scale
# ---------------------------------------------------------------------

K1, B, OMB = np.float32(1.2), np.float32(0.75), np.float32(1.0 - 0.75)
OP_BODIES = 16     # bodies of a class timed op by op, and profiled
IMPACT_OP_BODIES = 4   # the same for the classes on the impact rung
REINDEXED = 64     # _ids phase 7 re-indexes and phase 8 updates


def reindexed_cols(j: int) -> dict:
    """The ts and rating of phase 7's j-th re-indexed doc: a day of 2024,
    and a rating in [2.0, 2.1) that no corpus doc holds (phase 11's
    ascending cursors cross segments at values the other lacks)."""
    from opensearch_tpu_torch import bench_corpus as bc
    return {"ts": bc.TS_LO + (5 * j + 2) * 86_400_000 + 12_345,
            "rating": 2.0 + (j + 0.5) / 640}


class NumpyIndex:
    """What phases 7 and 8's brute force reads, apart from the port: the
    corpus CSR (global doc ids 0..n0-1), the docs indexed after it (global
    ids n0.., in indexing order), the deleted docs and the status / price
    columns, with the collection statistics BM25 takes from them: deleted
    docs count, as Lucene's maxDoc and doc freqs do, until `compact()`
    drops them (a merge compacted their segment). Global ids keep their
    order across a merge, so they break score ties as the merged ids
    do."""

    def __init__(self, corpus, columns, title=None):
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
        self.counted = np.ones(self.n0, bool)   # docs in the statistics
        self.n_stats = self.n0                  # maxDoc
        # the positional title field of the corpus docs (bench_corpus.
        # build_title_corpus); docs indexed later have no title
        self.title = title
        self.has_title = np.full(self.n0, title is not None)
        # global id -> {"ts", "rating"} of a doc indexed later with them
        self.later: dict = {}

    @property
    def n(self) -> int:
        """Docs ever indexed: the length of every per-doc array."""
        return len(self.live)

    def avgdl(self) -> np.float32:
        return np.float32(self.sum_dl / self.n_stats)

    def add(self, terms, st: int, pr: int, doc_id: str,
            cols: dict = None) -> int:
        """Index a doc (term ids with repeats, with `cols` its ts and
        rating) after every other: -> its global id."""
        self.contrib = {}              # the statistics change
        g = self.n
        self.live = np.append(self.live, True)
        self.counted = np.append(self.counted, True)
        self.has_title = np.append(self.has_title, False)
        self.n_stats += 1
        self.dl = np.append(self.dl, np.float32(len(terms)))
        self.sum_dl += len(terms)
        self.status = np.append(self.status, np.int32(st))
        self.price = np.append(self.price, np.int64(pr))
        for t, tf in Counter(terms).items():
            e = self.extra.setdefault(int(t), ([], []))
            e[0].append(g)
            e[1].append(np.float32(tf))
        self.new_ids.append(doc_id)
        if cols:
            self.later[g] = cols
        return g

    def later_arrays(self) -> tuple:
        """(ts i64, rating f64, present bool) of the docs indexed after
        the corpus, in global-id order (0 and False without them)."""
        pad = self.n - self.n0
        ts, rating = np.zeros(pad, np.int64), np.zeros(pad)
        has = np.zeros(pad, bool)
        for g, c in self.later.items():
            j = g - self.n0
            ts[j], rating[j], has[j] = c["ts"], c["rating"], True
        return ts, rating, has

    def reindex(self, docs) -> None:
        """docs: [(old local doc, term ids with repeats, status, price[,
        {"ts", "rating"}])], indexed after the corpus under the old doc's
        `_id`."""
        for old, terms, st, pr, *cols in docs:
            self.live[old] = False
            self.add(terms, st, pr, str(old), cols[0] if cols else None)

    def compact(self, docs=slice(None)) -> None:
        """The deleted docs among global ids `docs` (all by default) leave
        the statistics: a merge dropped them."""
        drop = np.zeros(self.n, bool)
        drop[docs] = True
        drop &= self.counted & ~self.live
        self.counted &= ~drop
        self.n_stats -= int(drop.sum())
        self.sum_dl -= int(self.dl[drop].sum())
        self.contrib = {}

    def row(self, t: int):
        lo, hi = int(self.starts[t]), int(self.starts[t + 1])
        d, tf = self.doc_ids[lo:hi].astype(np.int64), self.tfs[lo:hi]
        e = self.extra.get(int(t))
        if e is not None:
            d = np.concatenate([d, np.asarray(e[0], np.int64)])
            tf = np.concatenate([tf, np.asarray(e[1], np.float32)])
        if self.n_stats != self.n:
            keep = self.counted[d]
            d, tf = d[keep], tf[keep]
        return d, tf

    def weight(self, df: int) -> np.float32:
        import math
        n = self.n_stats
        return np.float32(math.log(1.0 + (n - df + 0.5) / (df + 0.5))
                          if df > 0 else 0.0)

    def contributions(self, t: int):
        """(docs, BM25 terms) of one term row."""
        got = self.contrib.get(int(t))
        if got is None:
            d, tf = self.row(t)
            w = self.weight(len(d))
            k = K1 * (OMB + (B * self.dl[d]) / self.avgdl())
            got = (d, (w * tf) / (tf + k))
            if len(d) >= 1 << 17:  # stopword-class rows recur
                self.contrib[int(t)] = got
        return got

    def group(self, terms, msm: int = 1):
        """BM25 of a `match` (distinct term ids, query order): (scores
        where at least msm terms match, else 0; that mask)."""
        score = np.zeros(self.n, np.float32)
        count = np.zeros(self.n, np.int32)
        for t in terms:
            d, c = self.contributions(t)
            score[d] += c
            count[d] += 1
        ok = count >= max(msm, 1)
        return np.where(ok, score, np.float32(0.0)), ok

    def group_page(self, terms, frm: int = 0, size: int = 10) -> tuple:
        """page() of group(terms) from the terms' postings alone (the
        scores of the docs they hold, summed in term order)."""
        parts = [self.contributions(t) for t in terms]
        docs, inv = np.unique(np.concatenate([d for d, _c in parts]),
                              return_inverse=True)
        score = np.zeros(len(docs), np.float32)
        np.add.at(score, inv, np.concatenate([c for _d, c in parts]))
        keep = self.live[docs]
        docs, score = docs[keep], score[keep]
        sel = np.lexsort((docs, -score))[frm:frm + size]
        return ([self.id_of(int(g)) for g in docs[sel]],
                score[sel].astype(np.float32).tolist(), len(docs))

    def bool_scores(self, slots, fam_msm: int, mask, const) -> tuple:
        """A bool body as phase 6's `oracle_page` reads it (term slots
        "req" / "fam" / "bonus" summed in slot order, a filter mask, a
        constant score or None): (scores f32[n], passed bool[n])."""
        score = np.zeros(self.n, np.float32)
        n_req = np.zeros(self.n, np.int32)
        n_fam = np.zeros(self.n, np.int32)
        for t, kind in slots:
            d, c = self.contributions(t)
            score[d] += c
            if kind == "req":
                n_req[d] += 1
            elif kind == "fam":
                n_fam[d] += 1
        want_req = sum(1 for _t, kind in slots if kind == "req")
        passed = mask & (n_req == want_req) & (n_fam >= fam_msm)
        if const is not None:
            score = np.full(self.n, np.float32(const), np.float32)
        return score, passed

    def bool_page(self, slots, fam_msm: int, mask, const,
                  size: int = 10) -> tuple:
        """page() of `bool_scores` over the live docs."""
        return self.page(*self.bool_scores(slots, fam_msm, mask, const), 0,
                         size)

    # ---------------- the positional title field ----------------

    def title_rows(self, term: str, prefix: bool = False,
                   cap: int = 50) -> list:
        """Title vocab rows of `term`, or the first `cap` rows starting
        with it (`prefix`); the vocab is bench_corpus.title_vocab_strings,
        sorted."""
        from opensearch_tpu_torch import bench_corpus as bc
        vocab = bc.title_vocab_strings(len(self.title[0]) - 1)
        if prefix:
            return [r for r, v in enumerate(vocab)
                    if v.startswith(term)][:cap]
        return [vocab.index(term)] if term in vocab else []

    def title_docs(self, r: int) -> np.ndarray:
        """Counted docs of title row r (ascending)."""
        starts, docs = self.title[0], self.title[1]
        d = docs[int(starts[r]):int(starts[r + 1])].astype(np.int64)
        return d[self.counted[d]] if self.n_stats != self.n else d

    def title_pairs(self, rows, cand: np.ndarray) -> np.ndarray:
        """Lex-sorted (doc << 32 | position + 2^31) keys of the title
        rows' occurrences in the docs `cand` (sorted)."""
        starts, docs, _tfs, pos_starts, positions = self.title[:5]
        keys = []
        for r in rows:
            a, b = int(starts[r]), int(starts[r + 1])
            if b == a:
                continue
            rd = docs[a:b]
            j = np.searchsorted(rd, cand)
            j = j[(j < len(rd)) & (rd[np.minimum(j, len(rd) - 1)] == cand)]
            lens = (pos_starts[a + j + 1] - pos_starts[a + j]).astype(
                np.int64)
            idx = (np.repeat(pos_starts[a + j] - (np.cumsum(lens) - lens),
                             lens) + np.arange(int(lens.sum())))
            keys.append((np.repeat(rd[j].astype(np.int64), lens) << 32)
                        | (positions[idx].astype(np.int64) + (1 << 31)))
        out = np.concatenate(keys) if keys else np.zeros(0, np.int64)
        return np.sort(out) if len(rows) > 1 else out

    def title_stats(self):
        """(avgdl f32, maxDoc) of the title field over the counted docs:
        every title holds TITLE_DL tokens."""
        from opensearch_tpu_torch import bench_corpus as bc
        got = self.contrib.get("title_stats")     # reset by add, compact
        if got is None:
            dc = int((self.counted & self.has_title).sum())
            got = (np.float32(bc.TITLE_DL * dc / dc) if dc else
                   np.float32(1.0), self.n_stats)
            self.contrib["title_stats"] = got
        return got

    def phrase(self, terms, slop: int = 0, prefix_last: bool = False,
               max_expansions: int = 50):
        """A title match_phrase(_prefix) over the brute force, as Lucene
        defines it with the reference's total-movement slop: each
        occurrence of term 0 anchors the others at their nearest
        occurrence (the later one on a tie) shifted by their query offset;
        its cost is the moves' total distance to their median, it counts
        1/(1 + cost) where every term occurs and cost <= slop, summed per
        doc in anchor order; BM25 over that frequency with the terms' idf
        sum as weight (a prefix last term: its first `max_expansions`
        expansions, their union df capped at maxDoc). -> (docs, scores)
        of the docs the phrase occurs in, deleted ones included."""
        import math
        from opensearch_tpu_torch import bench_corpus as bc
        avgdl, n = self.title_stats()
        m = len(terms)
        rows = [tuple(self.title_rows(t, prefix_last and i == m - 1,
                                      max_expansions))
                for i, t in enumerate(terms)]
        none = (np.zeros(0, np.int64), np.zeros(0, np.float32))
        w = 0.0
        for rr in rows:
            df = sum(len(self.title_docs(r)) for r in rr)
            if df > 0:
                df = min(df, n)
                w += math.log(1.0 + (n - df + 0.5) / (df + 0.5))
        if not all(rows):
            return none
        # candidates: docs holding every term
        sets = [self.title_set(rr) for rr in rows]
        cand = min(sets, key=len)
        for other in sets:
            if len(other) == 0:
                return none
            j = np.searchsorted(other, cand)
            cand = cand[(j < len(other))
                        & (other[np.minimum(j, len(other) - 1)] == cand)]
        if len(cand) == 0:
            return none
        keys = [self.title_pairs(rr, cand) for rr in rows]
        d0 = keys[0] >> 32
        p0 = (keys[0] & 0xFFFFFFFF) - (1 << 31)
        ok = np.ones(len(d0), bool)
        deltas = [np.zeros(len(d0), np.float32)]
        for i, k in enumerate(keys[1:], start=1):
            q = (d0 << 32) | (p0 + i + (1 << 31))
            j = np.searchsorted(k, q)
            jr = np.minimum(j, len(k) - 1)
            jl = np.maximum(j - 1, 0)
            r_ok = (j < len(k)) & ((k[jr] >> 32) == d0)
            l_ok = (j > 0) & ((k[jl] >> 32) == d0)
            r_d = ((k[jr] & 0xFFFFFFFF) - (1 << 31) - i - p0)
            l_d = ((k[jl] & 0xFFFFFFFF) - (1 << 31) - i - p0)
            r_cost = np.where(r_ok, r_d, np.iinfo(np.int64).max)
            l_cost = np.where(l_ok, -l_d, np.iinfo(np.int64).max)
            deltas.append(np.where(r_cost <= l_cost, r_d, l_d).astype(
                np.float32))
            ok &= r_ok | l_ok
        med = np.sort(np.stack(deltas), axis=0)[m // 2]
        cost = np.zeros(len(d0), np.float32)
        for dl_ in deltas:
            cost = cost + np.abs(dl_ - med)
        ok &= cost <= np.float32(slop)
        docs, inv = np.unique(d0[ok], return_inverse=True)
        freq = np.zeros(len(docs), np.float32)
        # np.add.at adds in anchor order, one f32 add at a time
        np.add.at(freq, inv, np.float32(1.0) / (np.float32(1.0) + cost[ok]))
        k = K1 * (OMB + (B * np.float32(bc.TITLE_DL)) / avgdl)
        return docs, (np.float32(w) * freq) / (freq + k)

    def title_set(self, rows) -> np.ndarray:
        """Counted docs holding any of the title rows `rows`, sorted;
        cached until the statistics change."""
        key = ("title_set", rows)
        got = self.contrib.get(key)
        if got is None:
            parts = [self.title_docs(r) for r in rows]
            got = (parts[0] if len(parts) == 1
                   else np.unique(np.concatenate(parts)))
            self.contrib[key] = got
        return got

    def phrase_page(self, terms, slop: int = 0, prefix_last: bool = False,
                    frm: int = 0, size: int = 10) -> tuple:
        """page() of a title phrase, from its sparse hits."""
        docs, score = self.phrase(terms, slop, prefix_last)
        keep = self.live[docs]
        docs, score = docs[keep], score[keep]
        sel = np.lexsort((docs, -score))[frm:frm + size]
        return ([self.id_of(int(g)) for g in docs[sel]],
                score[sel].astype(np.float32).tolist(), len(docs))

    def keyword(self, value: int):
        """A `term` on the status keyword in scoring context: BM25 with no
        norms (b 0, dl 0, tf 1)."""
        ok = self.status == value
        k = K1 * (np.float32(1.0) + (np.float32(0.0) * np.float32(0.0))
                  / np.float32(1.0))
        w = self.weight(int((ok & self.counted).sum()))
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


def check_page(resp: dict, want: tuple, what: str,
               rtol: float = 1e-6) -> None:
    """One response against its brute force: ids and order equal (two hits
    may swap only when their scores agree within rtol), scores within
    rtol (1e-6) relative, the total equal where the relation is eq, else
    a lower bound."""
    ids, scores, total = want
    h = resp["hits"]
    got_ids = [x["_id"] for x in h["hits"]]
    got_sc = np.asarray([x["_score"] for x in h["hits"]], np.float64)
    t = h["total"]
    ok = len(got_ids) == len(ids) and np.allclose(got_sc, scores, rtol=rtol,
                                                  atol=0) and (
        t["value"] == total if t["relation"] == "eq"
        else t["value"] <= total)
    for j, (g, w) in enumerate(zip(got_ids, ids)):
        if ok and g != w:
            twin = [k for k, x in enumerate(ids) if x == g]
            ok = bool(twin) and abs(scores[twin[0]] - got_sc[j]) \
                <= rtol * abs(scores[twin[0]])
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
                      op_ms: dict, memo: dict,
                      op_bodies: int = OP_BODIES) -> dict:
    """One class through msearch in BATCH-body requests (counts and rungs
    set to 0 just before), every page against the brute force, the
    sampled bodies on the card against the CPU, `op_bodies` bodies again
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
    nb = min(op_bodies, len(bodies))
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
    bodies per class that the fused kernels decline, then REINDEXED
    re-indexed `_id`s (phase 8 updates them) and `n` of phase 5's match
    bodies over the segments with deletes."""
    from opensearch_tpu_torch import RestClient
    from opensearch_tpu_torch import bench_corpus as bc
    client, seg = big["client"], big["seg"]
    dev = client.device
    ix = big.get("ix") or NumpyIndex(big["corpus"], big["columns"],
                                     big["title"])
    cpu = cpu_twin(seg)
    classes = general_classes(big, n)
    srng = np.random.default_rng(13)
    out: dict = {}
    op_ms: dict = {}
    memo: dict = {}
    idle = {}
    for name, items in classes.items():
        # one body a class on the CPU (2 before phase 15 shared the time
        # limit)
        sample = sorted(srng.choice(len(items), 1, replace=False).tolist())
        # the impact rung's host work makes a re-run of a 9-term class
        # cost as much as its run: 4 bodies under the op timer
        out[name] = run_general_class(
            client, name, items, ix, sample, cpu, op_ms, memo,
            IMPACT_OP_BODIES if name.startswith("match9") else OP_BODIES)
        if name == "mixed_field_bool":
            idle[name] = profile_batch(client,
                                       [b for b, _o in items[:OP_BODIES]])
    # re-index n existing _ids: the big segment gets n deleted docs, a new
    # segment takes their new versions
    vs = bc.vocab_strings(len(big["corpus"][4]))
    olds = sorted(srng.choice(seg.ndocs, REINDEXED, replace=False).tolist())
    terms = big["body_terms"][:REINDEXED]
    docs = [(old, list(terms[j]) + [terms[j][0]], j % 3, j,
             reindexed_cols(j)) for j, old in enumerate(olds)]
    t0 = time.perf_counter()
    for old, ts, st, pr, cols in docs:
        r = client.index("bench", {
            "body": " ".join(vs[int(t)] for t in ts),
            "status": bc.STATUS_VALUES[st], "price": pr, **cols},
            id=str(old))
        if r["result"] != "updated":
            raise AssertionError(f"re-index of _id {old}: {r}")
    client.indices.refresh("bench")
    t_reindex = time.perf_counter() - t0
    ix.reindex(docs)
    segs = client._indices["bench"].engine.segments
    if len(segs) != 2 or segs[0].live_count != seg.ndocs - REINDEXED:
        raise AssertionError("re-indexing did not leave REINDEXED deleted "
                             "docs")
    cpu2 = RestClient(device="cpu")
    cpu2.indices.create("bench", BENCH_MAPPING)
    cpu2._indices["bench"].engine.segments = list(segs)
    items = [(big["bodies"][j], (lambda ts: lambda ix_: ix_.page(
        *ix_.group(ts), 0, 10))(list(big["body_terms"][j])))
        for j in range(n)]
    sample = sorted(srng.choice(n, 1, replace=False).tolist())
    log(f"  re-indexed {REINDEXED} _ids in {t_reindex:.2f}s: segments "
        f"{[(s.ndocs, s.live_count) for s in segs]}")
    out["reindexed_match"] = run_general_class(
        client, "reindexed_match", items, ix, sample, cpu2, op_ms, {},
        IMPACT_OP_BODIES)
    nbytes = {s.name: s.device_nbytes(dev) for s in segs}
    log(f"  general path device arrays (live masks, numeric columns, doc "
        f"lengths, CSR copies; the postings are the aligned layout's): "
        f"{nbytes} bytes")
    big["ix"], big["reindexed"] = ix, docs
    return {"classes": out, "device_bytes": nbytes,
            "idle_share_one_batch": idle}


# ---------------------------------------------------------------------
# phase 10: size-0 analytics bodies (aggregations) at MS MARCO passage
# scale
# ---------------------------------------------------------------------

DAY_MS = 86_400_000
F32_U = 2.0 ** -24
# the probabilistic bound on an f32 sum of n terms in any order (Higham
# and Mary): |error| <= LAMBDA * sqrt(n) * u * sum|v| fails with
# probability below 2 exp(-LAMBDA^2 / 2) ~ 2.5e-14 per sum, for rounding
# errors that are independent and of mean zero
LAMBDA = 8.0
AGG_PRICE_RANGES = [{"to": 250}, {"from": 250, "to": 750}, {"from": 750}]


def month_ms(m: int) -> int:
    """Epoch ms of 2024-(m+1)-01 UTC (m = 12: 2025-01-01)."""
    return int(np.datetime64(f"{2024 + m // 12}-{m % 12 + 1:02d}-01",
                             "ms").astype(np.int64))


def agg_classes(big: dict, n: int, n_refine: int) -> dict:
    """Phase 10's bodies: class -> [body], `n` a class (`n_refine` for
    the refinement class (e))."""
    months = [f"{2024 + m // 12}-{m % 12 + 1:02d}-01" for m in range(13)]
    out = {"a_terms_stats": [
        {"size": 0, "query": {"match_all": {}}, "aggs": {"st": {
            "terms": {"field": "status", "size": 1 + i % 3,
                      "order": {"_key" if i % 2 else "_count":
                                "asc" if i % 4 == 1 else "desc"}},
            "aggs": {"p": {"stats": {"field": "price"}}}}}}
        for i in range(n)],
        "b_month_date_hist": [
        {"size": 0, "query": {"bool": {"filter": [{"range": {"ts": {
            "gte": months[i % 12], "lt": months[i % 12 + 1]}}}]}},
         "aggs": {"d": {"date_histogram": {
             "field": "ts", "calendar_interval": "day" if i % 2 == 0
             else "month"}, "aggs": {"avg_rating": {"avg": {
                 "field": "rating"}}}}}}
        for i in range(n)],
        "c_match_metrics": [
        {"size": 10, "query": big["bodies"][2 * i]["query"], "aggs": {
            "h": {"histogram": {"field": "price", "interval": 50}},
            "r": {"range": {"field": "price", "ranges": AGG_PRICE_RANGES}},
            "p": {"percentiles": {"field": "rating"}},
            "cp": {"cardinality": {"field": "price"}},
            "cs": {"cardinality": {"field": "status"}}}}
        for i in range(n)],
        "d_filters_missing_global": [
        {"size": 0, "query": {"range": {"price": {
            "gte": 50 * (i % 18), "lt": 50 * (i % 18) + 100}}},
         "aggs": {"f": {"filters": {"filters": {
             "published": {"term": {"status": "published"}},
             "draft": {"term": {"status": "draft"}}}}},
             "m": {"missing": {"field": "rating"}},
             "g": {"global": {}, "aggs": {"vc": {"value_count": {
                 "field": "price"}}}}}}
        for i in range(n)],
        # a quarter's weeks a body, 13 or 14 sub-searches (a price range's
        # 53 before phase 15 shared the time limit)
        "e_week_terms_refined": [
        {"size": 0, "query": {"bool": {"filter": [{"range": {"ts": {
            "gte": months[3 * (i % 4)], "lt": months[3 * (i % 4) + 3]}}}]}},
         "aggs": {"w": {"date_histogram": {"field": "ts",
                                           "calendar_interval": "week"},
                        "aggs": {"st": {"terms": {"field": "status"}}}}}}
        for i in range(n_refine)]}
    return out


class AggOracle:
    """Phase 10's numpy brute force over NumpyIndex's docs (the corpus's,
    then those indexed later, with deletes): the status and price
    columns, the corpus docs' `ts` and `rating`, and those of the docs
    indexed later with them (phase 7's re-indexed _ids). Values are the
    f32 views the aggregations read; counts,
    keys, minima, maxima, HLL registers and sketch bins are computed
    exactly (a numpy copy of the reference's arithmetic), sums in f64."""

    def __init__(self, ix, aggcols):
        self.ix = ix
        self.ts0, self.rating0, self.rpresent0 = aggcols
        self.static: dict = {}

    def cols(self) -> dict:
        ix = self.ix
        n, n0 = ix.n, ix.n0
        if self.static.get("n") != n:     # docs added since: pad again
            ts, rating, has = ix.later_arrays()
            self.static = {
                "n": n,
                "ts": np.concatenate([self.ts0, ts]),
                "ts_present": np.concatenate([np.ones(n0, bool), has]),
                "rating": np.concatenate([self.rating0, rating])
                .astype(np.float32),
                "rating_present": np.concatenate([self.rpresent0, has])}
        return {**self.static, "live": ix.live, "status": ix.status,
                "price": ix.price.astype(np.float32)}

    def match(self, body: dict, c: dict) -> np.ndarray:
        """The live docs a phase-10 query matches."""
        q = body["query"]
        if "match_all" in q:
            return c["live"].copy()
        if "bool" in q:           # a ts month filter
            r = q["bool"]["filter"][0]["range"]["ts"]
            lo = int(np.datetime64(r["gte"], "ms").astype(np.int64))
            hi = int(np.datetime64(r["lt"], "ms").astype(np.int64))
            return c["live"] & c["ts_present"] & (c["ts"] >= lo) \
                & (c["ts"] < hi)
        if "range" in q:          # a price range
            r = q["range"]["price"]
            return c["live"] & (c["price"] >= r["gte"]) \
                & (c["price"] < r["lt"])
        raise AssertionError(f"no brute force for {q}")


def sum_bound(v: np.ndarray) -> float:
    return LAMBDA * np.sqrt(max(len(v), 1)) * F32_U * float(
        np.abs(v.astype(np.float64)).sum())


class SumCheck:
    """f32 sums against their exact value within `sum_bound`; keeps the
    largest relative error and error / bound seen."""

    def __init__(self):
        self.rel = 0.0
        self.of_bound = 0.0

    def __call__(self, got, v: np.ndarray, what: str, div: int = 1):
        self.exact(got, float(v.astype(np.float64).sum()) / div,
                   sum_bound(v) / div, what)

    def exact(self, got, exact: float, bound: float, what: str):
        err = abs(float(got) - exact)
        if err > bound:
            raise AssertionError(f"{what}: {got} vs exact {exact}: error "
                                 f"{err} > bound {bound}")
        if exact:
            self.rel = max(self.rel, err / abs(exact))
        if bound:
            self.of_bound = max(self.of_bound, err / bound)


def check_stats(got: dict, v: np.ndarray, sums: SumCheck, what: str):
    """A stats agg's count, min and max exact, sum and avg in bound."""
    n = len(v)
    if got["count"] != n or (n and (got["min"] != float(v.min())
                                   or got["max"] != float(v.max()))):
        raise AssertionError(f"{what}: stats {got} vs count {n} min/max "
                             f"{v.min() if n else None}/"
                             f"{v.max() if n else None}")
    if n:
        sums(got["sum"], v, f"{what} sum")
        sums(got["avg"], v, f"{what} avg", n)


def np_hash_f32(v: np.ndarray) -> np.ndarray:
    """The reference's fmix32 of f32 bit patterns, in numpy u32."""
    h = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    m = np.uint64(0xFFFFFFFF)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & m
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & m
    return h ^ (h >> np.uint64(16))


def np_hll_registers(hashes: np.ndarray, log2m: int = 14) -> np.ndarray:
    """The reference's registers: the low log2m bits pick the register,
    the rank is (33 - log2m) - ceil(log2(rest + 1)), i.e. the remainder's
    bit length subtracted."""
    m = 1 << log2m
    h = hashes.astype(np.uint64)
    reg = (h & np.uint64(m - 1)).astype(np.int64)
    rest = (h >> np.uint64(log2m)).astype(np.int64)
    bitlen = np.zeros(len(rest), np.int64)
    r = rest.copy()
    while (r > 0).any():
        bitlen += r > 0
        r >>= 1
    rank = (32 - log2m + 1) - bitlen
    out = np.zeros(m, np.int32)
    np.maximum.at(out, reg, rank.astype(np.int32))
    return out


def np_dd_bins(v: np.ndarray) -> np.ndarray:
    """The reference's sketch bins in numpy f32 (its host arithmetic)."""
    from opensearch_tpu_torch.ops import aggs as A
    mag = np.abs(v).astype(np.float32)
    ln = np.log(np.maximum(mag, np.float32(A.DD_MIN_MAG)))
    idx = np.floor((ln - np.float32(np.log(A.DD_MIN_MAG)))
                   / np.float32(A.DD_LN_GAMMA)).astype(np.int64)
    idx = np.clip(idx, 0, A.DD_HALF - 1)
    return np.where(v > 0, A.DD_HALF + 1 + idx,
                    np.where(v < 0, A.DD_HALF - 1 - idx, A.DD_HALF))


def expected_terms(keys: np.ndarray, vocab, size: int, order) -> tuple:
    """([(key, count)] shown, sum_other) of a terms agg over the matched
    docs' ordinals `keys`, as the reference orders them."""
    counts = np.bincount(keys, minlength=len(vocab))
    items = [(vocab[o], int(c)) for o, c in enumerate(counts) if c > 0]
    (okey, odir), = order.items()
    if okey == "_key":
        items.sort(key=lambda kv: kv[0], reverse=odir == "desc")
    else:
        items.sort(key=lambda kv: (-kv[1], kv[0]) if odir == "desc"
                   else (kv[1], kv[0]))
    shown = items[:size]
    return shown, sum(c for _k, c in items) - sum(c for _k, c in shown)


def check_terms(got: dict, keys: np.ndarray, body: dict, what: str):
    from opensearch_tpu_torch import bench_corpus as bc
    shown, other = expected_terms(keys, bc.STATUS_VALUES,
                                  int(body.get("size", 10)),
                                  body.get("order", {"_count": "desc"}))
    if [(b["key"], b["doc_count"]) for b in got["buckets"]] != shown \
            or got["sum_other_doc_count"] != other:
        raise AssertionError(f"{what}: terms {got} vs {shown} other {other}")


def check_agg_response(resp: dict, body: dict, oracle: AggOracle,
                       sums: SumCheck, sketch: Counter, what: str,
                       page=None) -> None:
    """One phase-10 response against the brute force."""
    from opensearch_tpu_torch.search import aggregations as A
    from opensearch_tpu_torch.search.compiler import DEFAULT_PERCENTS
    c = oracle.cols()
    m = oracle.match(body, c) if page is None else page[1]
    aggs = resp["aggregations"]
    if page is not None:
        check_page(resp, page[0], what)
    elif resp["hits"]["total"]["value"] != int(m.sum()):
        raise AssertionError(f"{what}: total {resp['hits']['total']} != "
                             f"{int(m.sum())}")
    if "st" in aggs:                                         # (a)
        spec = body["aggs"]["st"]["terms"]
        check_terms(aggs["st"], c["status"][m], spec, what)
        for b in aggs["st"]["buckets"]:
            o = ["archived", "draft", "published"].index(b["key"])
            check_stats(b["p"], c["price"][m & (c["status"] == o)], sums,
                        f"{what} {b['key']}")
    if "d" in aggs:                                          # (b)
        cal = body["aggs"]["d"]["date_histogram"]["calendar_interval"]
        ts = c["ts"][m]
        if cal == "day":
            ids = ts // DAY_MS
            keys = ids * DAY_MS
        else:
            ids = (ts // DAY_MS).astype("datetime64[D]").astype(
                "datetime64[M]").astype(np.int64)
            keys = ids.astype("datetime64[M]").astype(
                "datetime64[ms]").astype(np.int64)
        uniq, counts = np.unique(ids, return_counts=True)
        got = aggs["d"]["buckets"]
        want_keys = [int(keys[ids == u][0]) for u in uniq]
        if [(b["key"], b["doc_count"]) for b in got] \
                != list(zip(want_keys, counts.tolist())):
            raise AssertionError(f"{what}: date_histogram "
                                 f"{[(b['key'], b['doc_count']) for b in got]}"
                                 f" vs {list(zip(want_keys, counts))}")
        rp = c["rating_present"][m]
        rv = c["rating"][m]
        for b, u in zip(got, uniq):
            v = rv[(ids == u) & rp]
            if len(v) == 0:
                if b["avg_rating"]["value"] is not None:
                    raise AssertionError(f"{what}: avg of no ratings")
                continue
            sums(b["avg_rating"]["value"], v, f"{what} avg", len(v))
    if "h" in aggs:                                          # (c)
        pb = np.floor(c["price"][m] / np.float32(50.0)).astype(np.int64)
        uniq, counts = np.unique(pb, return_counts=True)
        if [(b["key"], b["doc_count"]) for b in aggs["h"]["buckets"]] \
                != [(float(u) * 50.0, int(k)) for u, k in zip(uniq, counts)]:
            raise AssertionError(f"{what}: histogram {aggs['h']}")
        pr = c["price"][m]
        want = [int(((pr >= r.get("from", -np.inf))
                     & (pr < r.get("to", np.inf))).sum())
                for r in AGG_PRICE_RANGES]
        if [b["doc_count"] for b in aggs["r"]["buckets"]] != want:
            raise AssertionError(f"{what}: range {aggs['r']} vs {want}")
        rv = c["rating"][m & c["rating_present"]]
        hist = np.bincount(np_dd_bins(rv), minlength=8193)
        want_p = A.hist_percentiles({"hist": hist, "percents": list(
            DEFAULT_PERCENTS)})
        for k, v in aggs["p"]["values"].items():
            if v != want_p[k]:
                sketch["percentile_mismatches"] += 1
                if not np.isclose(v, want_p[k], rtol=0.0102):
                    raise AssertionError(f"{what}: percentile {k} {v} vs "
                                         f"{want_p[k]}: more than one bin")
        regs = np_hll_registers(np_hash_f32(c["price"][m]))
        if aggs["cp"]["value"] != int(round(A.hll_estimate(regs))):
            raise AssertionError(f"{what}: price cardinality "
                                 f"{aggs['cp']} vs registers' "
                                 f"{A.hll_estimate(regs)}")
        import zlib
        from opensearch_tpu_torch import bench_corpus as bc
        held = np.unique(c["status"][m])
        sregs = np_hll_registers(np.asarray(
            [zlib.crc32(bc.STATUS_VALUES[o].encode()) for o in held],
            np.uint64))
        if aggs["cs"]["value"] != int(round(A.hll_estimate(sregs))):
            raise AssertionError(f"{what}: status cardinality {aggs['cs']}")
    if "f" in aggs:                                          # (d)
        f = aggs["f"]["buckets"]
        want = {"published": int((m & (c["status"] == 2)).sum()),
                "draft": int((m & (c["status"] == 1)).sum())}
        if {k: v["doc_count"] for k, v in f.items()} != want:
            raise AssertionError(f"{what}: filters {f} vs {want}")
        if aggs["m"]["doc_count"] != int((m & ~c["rating_present"]).sum()):
            raise AssertionError(f"{what}: missing {aggs['m']}")
        nlive = int(c["live"].sum())
        if aggs["g"]["doc_count"] != nlive \
                or aggs["g"]["vc"]["value"] != nlive:
            raise AssertionError(f"{what}: global {aggs['g']} vs {nlive}")
    if "w" in aggs:                                          # (e)
        mt = m & c["ts_present"]
        wk = (c["ts"][mt] // DAY_MS + 3) // 7
        st = c["status"][mt]
        uniq, counts = np.unique(wk, return_counts=True)
        got = aggs["w"]["buckets"]
        if [(b["key"], b["doc_count"]) for b in got] != [
                (int((u * 7 - 3) * DAY_MS), int(k))
                for u, k in zip(uniq, counts)]:
            raise AssertionError(f"{what}: week buckets")
        for b, u in zip(got, uniq):
            check_terms(b["st"], st[wk == u], {}, f"{what} week {u}")


def split_sums(resp, out=None, key=None):
    """(the response with its sum-derived floats set to None, those floats
    in order): card and CPU responses must agree exactly on the rest."""
    out = [] if out is None else out
    if isinstance(resp, dict):
        d = {}
        for k, v in resp.items():
            if isinstance(v, float) and (k in ("sum", "avg") or key in (
                    "avg_rating",)):
                out.append(v)
                d[k] = None
            else:
                d[k] = split_sums(v, out, k)[0]
        return d, out
    if isinstance(resp, list):
        return [split_sums(v, out, key)[0] for v in resp], out
    return resp, out


def agg_op_timer():
    """CUDA events around the query's mask (`compiler.emit`), the agg
    tree's device ops (top-level `emit_agg` calls) and the top-k, and
    host seconds in the partials and the finalize: -> (restore(),
    {op: [(start, end)]}, {host op: s})."""
    import torch
    from opensearch_tpu_torch.ops import scoring
    from opensearch_tpu_torch.search import aggregations as A
    from opensearch_tpu_torch.search import compiler as C
    from opensearch_tpu_torch.search import executor as E
    spans: dict = {}
    host: dict = {}
    depth = [0]
    saved = []

    def wrap(mod, name, label, device):
        real = getattr(mod, name)

        def timed(*a, **kw):
            if device:
                if depth[0]:
                    return real(*a, **kw)
                depth[0] += 1
                s0 = torch.cuda.Event(enable_timing=True)
                s1 = torch.cuda.Event(enable_timing=True)
                s0.record()
                try:
                    out = real(*a, **kw)
                finally:
                    depth[0] -= 1
                s1.record()
                spans.setdefault(label, []).append((s0, s1))
                return out
            t0 = time.perf_counter()
            out = real(*a, **kw)
            host[label] = host.get(label, 0.0) + time.perf_counter() - t0
            return out
        setattr(mod, name, timed)
        saved.append((mod, name, real))
    wrap(C, "emit", "query_mask", True)
    wrap(C, "emit_agg", "agg_ops", True)
    wrap(scoring, "topk_docs", "topk", True)
    wrap(E, "device_agg_to_partial", "partials_host", False)
    wrap(A, "finalize", "finalize_host", False)

    def restore():
        for mod, name, real in reversed(saved):
            setattr(mod, name, real)
    return restore, spans, host


def agg_column_bytes(segs, dev) -> int:
    """Device bytes of the aggregations' arrays: f32 views, keyword
    ordinals, date buckets, keyword hashes."""
    n = 0
    for s in segs:
        for k, v in s.device_arrays.items():
            if k[0] in ("f32", "keyword", "dbuckets", "kw_hashes") \
                    and k[-1] == str(dev):
                for t in (v if isinstance(v, tuple) else (v,)):
                    n += t.numel() * t.element_size()
    return n


def run_agg_class(client, name: str, bodies, oracle: AggOracle, cpu,
                  ncpu: int, pages=None) -> dict:
    """One class body by body through RestClient.search (the path a
    size-0 analytics request takes), every response against the brute
    force, `ncpu` bodies on the card against the CPU twin, the class's
    first 2 bodies through msearch (a body with aggs reruns as a single
    search there), then OP_BODIES bodies under the op timer."""
    import torch
    from opensearch_tpu_torch.search import compiler as C
    from opensearch_tpu_torch.search import fastpath
    from opensearch_tpu_torch.ops import bm25
    sums = SumCheck()
    sketch: Counter = Counter()
    C.reset_stats()
    bm25.reset_counts()
    fastpath.reset_stats()
    lat, resps = [], []
    t_all = time.perf_counter()
    for b in bodies:
        t0 = time.perf_counter()
        resps.append(client.search("bench", b))
        lat.append((time.perf_counter() - t0) * 1e3)
    wall = time.perf_counter() - t_all
    general = C.STATS["general_served"]
    launches = dict(bm25.COUNTS)
    t0 = time.perf_counter()
    for i, (b, r) in enumerate(zip(bodies, resps)):
        check_agg_response(r, b, oracle, sums, sketch, f"{name} body {i}",
                           None if pages is None else pages(i))
    t_oracle = time.perf_counter() - t0
    t0 = time.perf_counter()
    for b in bodies[:ncpu]:
        got, gs = split_sums(strip_took(client.search("bench", b)))
        want, ws = split_sums(strip_took(cpu.search("bench", b)))
        if got != want or not np.allclose(gs, ws, rtol=1e-4, atol=0):
            raise AssertionError(f"{name}: card and CPU responses differ "
                                 f"for {b}")
    t_cpu = time.perf_counter() - t0
    ms = client.msearch(sum([[{}, b] for b in bodies[:2]], []),
                        index="bench")["responses"]
    if [split_sums(strip_took(r))[0] for r in ms] != \
            [split_sums(strip_took(r))[0] for r in resps[:2]]:
        raise AssertionError(f"{name}: msearch != search")
    nb = min(OP_BODIES, len(bodies))
    restore, spans, host = agg_op_timer()
    try:
        for b in bodies[:nb]:
            client.search("bench", b)
        torch.cuda.synchronize()
    finally:
        restore()
    ops_ms = {k: sum(a.elapsed_time(e) for a, e in v) / nb
              for k, v in spans.items()}
    host_ms = {k: v * 1e3 / nb for k, v in host.items()}
    n = len(bodies)
    log(f"  {name}: bodies={n} wall_s={wall:.2f} bodies_per_s={n / wall:.1f}"
        f" ms_p50={np.percentile(lat, 50):.1f} "
        f"ms_p99={np.percentile(lat, 99):.1f} first_ms={lat[0]:.1f} "
        f"general={general} kernel_launches="
        f"{ {k: v for k, v in launches.items() if v} }; {n} responses == "
        f"numpy brute force ({t_oracle:.1f}s; sums: max relative error "
        f"{sums.rel:.3e}, {sums.of_bound:.3e} of the bound; percentile "
        f"values one bin off: {sketch['percentile_mismatches']}); {ncpu} "
        f"card == CPU ({t_cpu:.1f}s); device ms per body (events) " + " ".join(
            f"{k}={v:.4f}" for k, v in sorted(ops_ms.items()))
        + "; host ms per body " + " ".join(
            f"{k}={v:.2f}" for k, v in sorted(host_ms.items())))
    if any(launches.values()) or general < n:
        raise AssertionError(f"{name}: bodies with aggs left the general "
                             f"path: {launches} general={general}")
    return {"bodies": n, "bodies_per_s": n / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)), "first_ms": lat[0],
            "sum_max_rel_err": sums.rel, "sum_err_of_bound": sums.of_bound,
            "percentile_mismatches": sketch["percentile_mismatches"],
            "op_ms": ops_ms, "host_ms": host_ms}


def agg_register_check(client, seg, body) -> dict:
    """The card's HLL registers (price) and sketch histogram (rating) of
    one class-(c) body's match, called on the ops directly, against the
    numpy copy of the reference's arithmetic: mismatches counted."""
    from opensearch_tpu_torch.ops import aggs as agg_ops
    from opensearch_tpu_torch.search import compiler as C
    from opensearch_tpu_torch.search import query_dsl as dsl
    dev = client.device
    ctx = client._indices["bench"].searcher.context()
    lroot = C.rewrite(dsl.parse_query(body["query"]), ctx)
    match = C.emit(lroot, seg, ctx, dev).matched & seg.live_on(dev)
    price = seg.f32_on("price", dev)
    rating = seg.f32_on("rating", dev)
    regs = agg_ops.cardinality_numeric_registers(*price, match).cpu().numpy()
    hist = agg_ops.ddsketch_hist(*rating, match).cpu().numpy()
    m = match.cpu().numpy()
    pv = price[0].cpu().numpy()[m]
    rp = rating[1].cpu().numpy()
    rv = rating[0].cpu().numpy()[m & rp]
    want_r = np_hll_registers(np_hash_f32(pv))
    want_h = np.bincount(np_dd_bins(rv), minlength=agg_ops.DD_NBINS)
    return {"register_mismatches": int((regs != want_r).sum()),
            "sketch_bin_mismatches": int(np.abs(hist - want_h).sum() // 2),
            "values": int(len(rv))}


def phase_aggs_msmarco(big: dict, n: int) -> dict:
    """Size-0 analytics bodies over phase 7's end state (the big segment
    with phase 7's re-indexed _ids deleted, their new versions in a small
    segment): classes (a)-(e) of `agg_classes`, each against the numpy
    brute force, 2 bodies a class on the card against the CPU (1 for the
    refinement class), the ops timed by step."""
    from opensearch_tpu_torch import RestClient
    client = big["client"]
    dev = client.device
    ix = big["ix"]
    segs = list(client._indices["bench"].engine.segments)
    oracle = AggOracle(ix, big["aggs"])
    cpu = RestClient(device="cpu")
    cpu.indices.create("bench", BENCH_MAPPING)
    cpu._indices["bench"].engine.segments = segs
    n_refine = min(4, n)
    classes = agg_classes(big, n, n_refine)
    log(f"  {n} bodies a class, {n_refine} of the refinement class (e) "
        f"(each runs one size-0 sub-search per week bucket)")
    out: dict = {}
    bytes_before = agg_column_bytes(segs, dev)
    # the host's date buckets of the big segment, built once per calendar
    # and cached (the classes below find them built)
    from opensearch_tpu_torch.search import compiler as C
    build_s = {}
    for cal in ("day", "month", "week"):
        t0 = time.perf_counter()
        C.host_date_buckets(segs[0], "ts", 1, 0, cal)
        build_s[cal] = time.perf_counter() - t0
    log("  date buckets' host build (once per segment and calendar): "
        + " ".join(f"{k}={v:.3f}s" for k, v in build_s.items()))
    for name, bodies in classes.items():
        pages = None
        if name == "c_match_metrics":
            def pages(i, _ix=ix):
                score, ok = _ix.group(list(big["body_terms"][2 * i]))
                return _ix.page(score, ok, 0, 10), ok & _ix.live
        out[name] = run_agg_class(client, name, bodies, oracle, cpu,
                                  1 if name.startswith("e_") else 2, pages)
    check = agg_register_check(client, segs[0],
                               classes["c_match_metrics"][0])
    log(f"  ops on the card vs numpy (class (c), body 0): HLL register "
        f"mismatches {check['register_mismatches']} of 16384, sketch "
        f"values in another bin {check['sketch_bin_mismatches']} of "
        f"{check['values']}")
    if check["register_mismatches"]:
        raise AssertionError("HLL registers differ from the reference's "
                             "arithmetic")
    nbytes = agg_column_bytes(segs, dev)
    log(f"  aggregation device arrays (f32 views of price, ts and rating, "
        f"status ordinals, date buckets, keyword hashes): {nbytes} bytes "
        f"(before the phase: {bytes_before})")
    return {"classes": out, "device_bytes": nbytes, "ops_check": check,
            "date_buckets_build_s": build_s}


# ---------------------------------------------------------------------
# phase 11: a search results page (sort, search_after, collapse, the
# fetch options) at MS MARCO passage scale
# ---------------------------------------------------------------------

SORT_CHAIN = 4     # search_after pages after each first page in (b), (c)


def sort_classes(big: dict, n: int) -> dict:
    """Phase 11's bodies, `n` a class: class -> [body] ((b) and (c): each
    chain's first page). Matches are phase 5's 2-term bodies."""
    m = len(big["bodies"]) // 2

    def match(i):
        return big["bodies"][2 * (i % m)]["query"]
    return {
        "a_price_listing": [
            {"query": match(i), "sort": [{"price": "asc"}, {"ts": "desc"}],
             "size": 10, "docvalue_fields": ["price", "status", "ts"],
             "_source": {"includes": ["doc"]}} for i in range(n)],
        "b_newest_first": [
            {"query": {"range": {"price": {"gte": (61 * i) % 900,
                                           "lt": (61 * i) % 900 + 100}}},
             "sort": [{"ts": "desc"}], "size": 20} for i in range(n)],
        # each range starts just below a re-indexed doc's rating, which
        # the big segment lacks: a page of the chain holds it
        "c_rating_ascending": [
            {"query": {"range": {"rating": {
                "gte": reindexed_cols(4 * i % REINDEXED)["rating"] - 1.2e-5,
                "lt": 2.1}}},
             "sort": [{"rating": "asc"}], "size": 10} for i in range(n)],
        "d_keyword_missing": [
            {"query": match(i + 16), "sort": [
                {"status": "desc"},
                {"rating": {"order": "asc", "missing": "_first"}}],
             "size": 10, "track_scores": True} for i in range(n)],
        "e_collapse": [
            dict({"query": match(i + 32), "size": 10},
                 collapse=dict({"field": "price"}, **(
                     {"inner_hits": {"name": "more", "size": 2}}
                     if i % 4 == 1 else {}))) for i in range(n)],
    }


def snippet_bodies(big: dict, n: int) -> list:
    """Class (f): 2-term matches of title pool pairs (phase 9's picks),
    score order, highlighted titles; half with exact totals."""
    from opensearch_tpu_torch import bench_corpus as bc
    title = big["title"]
    tvs = bc.title_vocab_strings(len(title[0]) - 1)
    pairs = bc.pick_phrase_pairs(title[7], n, seed=11)
    return [dict({"query": {"match": {"title": f"{tvs[title[5][p]]} "
                                               f"{tvs[title[6][p]]}"}},
                  "size": 10, "highlight": {"fields": {"title": {}}},
                  "_source": ["title"]},
                 **({"track_total_hits": True} if i % 2 else {}))
            for i, p in enumerate(pairs)]


class SortOracle:
    """Phase 11's numpy brute force over NumpyIndex's docs in phase 7's
    end state (the big segment, global ids 0..n0-1 with deletes, then the
    re-indexed docs' segment): the contract of a sorted page. Per
    segment, the best next_pow2(max(need, 16)) matched live docs by
    (primary key, ascending doc), after the cursor where one is given;
    those of both segments by the full tuple, then `_id`; `need` =
    twice the window under a field sort. The cursor keeps the docs
    strictly after its value; the reference's rule (`ref_cursor`) keeps,
    ascending, the docs whose rank in their segment is above the count of
    the segment's values below the cursor."""

    def __init__(self, ix, aggcols):
        self.ix = ix
        n0, n = ix.n0, ix.n
        ts0, r0, rp0 = aggcols
        ts, rating, has = ix.later_arrays()
        self.vals = {"price": ix.price.astype(np.int64),
                     "status": ix.status.astype(np.int64),
                     "ts": np.concatenate([ts0, ts]),
                     "rating": np.concatenate([r0, rating])}
        ones = np.ones(n, bool)
        self.present = {"price": ones, "status": ones,
                        "ts": np.concatenate([np.ones(n0, bool), has]),
                        "rating": np.concatenate([rp0, has])}
        self.seg_of = (np.arange(n) >= n0).astype(np.int64)
        self._docs = (None, None)

    def seg_docs(self, matched: np.ndarray) -> list:
        """Each segment's matched live docs, ascending; kept for the
        last `matched` (a chain's pages share it)."""
        if self._docs[0] is not matched:
            m = matched & self.ix.live
            self._docs = (matched, [np.flatnonzero(m & (self.seg_of == s))
                                    for s in (0, 1)])
        return self._docs[1]

    def render(self, f: str, g: int):
        from opensearch_tpu_torch import bench_corpus as bc
        if not self.present[f][g]:
            return None
        v = self.vals[f][g]
        if f == "status":
            return bc.STATUS_VALUES[int(v)]
        return float(v) if f == "rating" else int(v)

    def primary(self, spec: dict, docs: np.ndarray) -> np.ndarray:
        """f64 key per doc, larger first (the device's rank key)."""
        f, desc, last = self.spec_parts(spec)
        v = self.vals[f][docs].astype(np.float64)
        k = v if desc else -v
        return np.where(self.present[f][docs], k,
                        -np.inf if last else np.inf)

    @functools.lru_cache(maxsize=8)
    def distinct(self, f: str, s: int) -> np.ndarray:
        """The distinct values of a field in segment s, deleted docs'
        included (its sort ordinals rank them)."""
        return np.unique(self.vals[f][(self.seg_of == s)
                                      & self.present[f]])

    @staticmethod
    def spec_parts(spec: dict) -> tuple:
        ((f, o),) = spec.items()
        if isinstance(o, str):
            o = {"order": o}
        return (f, o.get("order", "asc") == "desc",
                o.get("missing", "_last") == "_last")

    def comp(self, specs, g: int) -> tuple:
        out = []
        for spec in specs:
            f, desc, last = self.spec_parts(spec)
            if not self.present[f][g]:
                out.append((1 if last else -1, 0))
                continue
            v = self.vals[f][g]
            v = float(v) if f == "rating" else int(v)
            out.append((0, -v if desc else v))
        return tuple(out) + (self.ix.id_of(g),)

    def after_mask(self, spec: dict, docs: np.ndarray, v,
                   ref_cursor: bool) -> np.ndarray:
        f, desc, last = self.spec_parts(spec)
        x = self.vals[f][docs]
        pres = self.present[f][docs]
        if ref_cursor and not desc:
            keep = np.zeros(len(docs), bool)
            for s in (0, 1):
                u = self.distinct(f, s)
                lo = int(np.searchsorted(u, v, "left"))
                on = self.seg_of[docs] == s
                keep[on] = np.searchsorted(u, x[on]) > lo
            return (pres & keep) | (~pres & last)
        after = (x < v) if desc else (x > v)
        return (pres & after) | (~pres & last)

    def page(self, matched: np.ndarray, score, body: dict,
             ref_cursor: bool = False) -> dict:
        """The port's page of a sorted body over `matched` (live docs are
        taken here): {"ids", "hits": [(g, score)], "total"}."""
        ix = self.ix
        specs = body["sort"]
        size = int(body.get("size", 10))
        need = 2 * size
        k = next_pow2_16(need)
        after = body.get("search_after")
        cands = []
        total = 0
        for d in self.seg_docs(matched):
            if after is not None:
                d = d[self.after_mask(specs[0], d, after[0], ref_cursor)]
            total += len(d)
            cands += top_by(self.primary(specs[0], d), d, k).tolist()
        cands.sort(key=lambda g: self.comp(specs, g))
        sel = cands[:need][:size]
        return {"ids": [ix.id_of(g) for g in sel],
                "hits": [(g, None if score is None else
                          float(score[g])) for g in sel], "total": total}

    def exact_ids(self, matched: np.ndarray, body: dict) -> list:
        """The exact page: every matched live doc by the full tuple."""
        d = np.flatnonzero(matched & self.ix.live)
        specs = body["sort"]
        keys = [self.comp(specs, int(g)) for g in d] if len(d) < 5000 \
            else None
        if keys is None:
            # narrow first: the best docs by the primary key, whole tie
            # classes at the edge
            pk = self.primary(specs[0], d)
            kth = np.partition(-pk, 20)[20]
            d = d[-pk <= kth]
            keys = [self.comp(specs, int(g)) for g in d]
        order = sorted(range(len(d)), key=keys.__getitem__)
        return [self.ix.id_of(int(d[j])) for j in order[:body["size"]]]

    def collapse_page(self, matched, score, size: int = 10) -> list:
        """A score-ordered body collapsed on price: per segment, the best
        doc of each price group (ties: the lowest doc), the
        next_pow2(max(size, 16)) best groups (ties: the lowest price);
        both segments' by score (stable), cut to the window, one per price
        across segments: -> [(g, score)]."""
        ix = self.ix
        k = next_pow2_16(size)
        m = matched & ix.live
        cands = []
        for s in (0, 1):
            d = np.flatnonzero(m & (self.seg_of == s))
            sc = score[d]
            p = self.vals["price"][d]
            o = np.lexsort((d, -sc, p))
            _u, first = np.unique(p[o], return_index=True)
            best = o[first]
            best = best[np.lexsort((p[best], -sc[best]))][:k]
            cands += [(int(d[j]), float(sc[j])) for j in best]
        cands.sort(key=lambda c: -c[1])
        seen, out = set(), []
        for g, sc in cands[:size]:
            pv = int(self.vals["price"][g])
            if pv not in seen:
                seen.add(pv)
                out.append((g, sc))
        return out


def top_by(key: np.ndarray, d: np.ndarray, k: int) -> np.ndarray:
    """The k docs of `d` (ascending) with the largest keys, ties by
    ascending doc, in that order."""
    if len(d) > k:
        kth = np.partition(-key, k - 1)[k - 1]
        sel = -key <= kth
        key, d = key[sel], d[sel]
    return d[np.lexsort((d, -key))[:k]]


def next_pow2_16(n: int) -> int:
    return 1 << (max(int(n), 16) - 1).bit_length()


def title_group(ix, terms) -> tuple:
    """BM25 of a 2-term `match` on the title field over the counted docs
    (every title holds TITLE_DL tokens): (scores f32[n], matched)."""
    import math
    from opensearch_tpu_torch import bench_corpus as bc
    avgdl, n = ix.title_stats()
    starts, docs_all, tfs_all = ix.title[:3]
    score = np.zeros(ix.n, np.float32)
    ok = np.zeros(ix.n, bool)
    k = K1 * (OMB + (B * np.float32(bc.TITLE_DL)) / avgdl)
    for t in terms:
        (r,) = ix.title_rows(t)
        a, b_ = int(starts[r]), int(starts[r + 1])
        d = docs_all[a:b_].astype(np.int64)
        tf = tfs_all[a:b_]
        if ix.n_stats != ix.n:
            keep = ix.counted[d]
            d, tf = d[keep], tf[keep]
        w = np.float32(math.log(1.0 + (n - len(d) + 0.5) / (len(d) + 0.5)))
        score[d] += (w * tf) / (tf + k)
        ok[d] = True
    return score, ok


def query_match(ix, oracle: SortOracle, body: dict, terms) -> tuple:
    """(scores or None, matched over every doc) of a phase-11 query."""
    q = body["query"]
    if "match" in q:
        return ix.group(terms)
    ((f, r),) = q["range"].items()
    x = oracle.vals[f]
    if f == "rating":
        x = x.astype(np.float32)
        lo, hi = np.float32(r["gte"]), np.float32(r["lt"])
    else:
        lo, hi = r["gte"], r["lt"]
    m = oracle.present[f] & (x >= lo) & (x < hi)
    return np.where(m, np.float32(1.0), np.float32(0.0)), m


def check_hits(resp: dict, want_hits: list, total: int, max_score,
               what: str, score_order: bool = False, rtol: float = 1e-6):
    """A response's hits against the brute force's: [{"_id", "_score",
    and any of "sort", "fields", "_source", "highlight",
    "inner_hits"}]; ids in order (two hits may swap under score order
    when their scores agree within rtol), scores within rtol, the rest
    equal; the total equal (a lower bound where its relation is gte);
    max_score within rtol or both None."""
    h = resp["hits"]
    t = h["total"]
    ok = (t["value"] == total if t["relation"] == "eq"
          else t["value"] <= total) and len(h["hits"]) == len(want_hits)
    ms = h["max_score"]
    ok = ok and (ms is None) == (max_score is None) and (
        ms is None or np.isclose(ms, max_score, rtol=rtol, atol=0))
    by_id = {w["_id"]: w for w in want_hits}
    for got, want in zip(h["hits"], want_hits):
        if not ok:
            break
        if got["_id"] != want["_id"]:
            twin = by_id.get(got["_id"])
            ok = score_order and twin is not None and np.isclose(
                twin["_score"], want["_score"], rtol=rtol, atol=0)
            want = twin if ok else want
        ok = ok and np.isclose(got["_score"], want["_score"], rtol=rtol,
                               atol=0)
        for key, v in want.items():
            if not ok:
                break
            if key in ("_id", "_score"):
                continue
            if key == "inner_hits":
                for name, (iw, itotal, ims) in v.items():
                    check_hits(got["inner_hits"][name], iw, itotal, ims,
                               f"{what} inner hits {name}", True, rtol)
            else:
                ok = got.get(key) == v
    if not ok:
        raise AssertionError(f"{what} != numpy brute force: "
                             f"{json.dumps(h)[:1500]} vs "
                             f"{json.dumps([want_hits, total, max_score])[:1500]}")


def sort_op_timer():
    """Events around the sort key, the top-k and the collapse scatters on
    the card, host clocks around the sort tuples, the fetch and the
    highlighter: -> (restore(), {op: [(start, end)]}, {host op: s},
    {host op: calls})."""
    import torch
    from opensearch_tpu_torch.ops import scoring
    from opensearch_tpu_torch.search import compiler as C
    from opensearch_tpu_torch.search import executor as E
    spans: dict = {}
    host: Counter = Counter()
    calls: Counter = Counter()
    saved = []

    def wrap(owner, name, label, device):
        real = getattr(owner, name)

        def timed(*a, _real=real, **kw):
            if device:
                s0 = torch.cuda.Event(enable_timing=True)
                s1 = torch.cuda.Event(enable_timing=True)
                s0.record()
                out = _real(*a, **kw)
                s1.record()
                spans.setdefault(label, []).append((s0, s1))
                return out
            t0 = time.perf_counter()
            out = _real(*a, **kw)
            host[label] += time.perf_counter() - t0
            calls[label] += 1
            return out
        setattr(owner, name, timed)
        saved.append((owner, name, real))
    wrap(C, "sort_key", "sort_key", True)
    wrap(scoring, "topk_docs", "topk", True)
    wrap(scoring, "collapse_topk", "collapse", True)
    wrap(E, "host_sort_values", "sort_tuple", False)
    wrap(E.ShardSearcher, "fetch_phase", "fetch", False)
    wrap(E.ShardSearcher, "highlight", "highlight", False)

    def restore():
        for owner, name, real in saved:
            setattr(owner, name, real)
    return restore, spans, host, calls


def sort_ords_bytes(segs, dev) -> int:
    n = 0
    for s in segs:
        for k, v in s.device_arrays.items():
            if k[0] == "sort_ords" and k[-1] == str(dev):
                n += v.numel() * v.element_size()
    return n


def run_sort_class(client, name: str, bodies, chain: int, want_of,
                   cpu) -> dict:
    """One class body by body through RestClient.search (a results page
    is one request; a chain's next page is the same body after the last
    hit's sort values), every response against the brute force
    (`want_of(body, resp) -> Counter`, raising on a difference), the
    first 2 requests on the card against the CPU, then OP_BODIES
    requests under the op timer."""
    import torch
    from opensearch_tpu_torch.ops import bm25
    from opensearch_tpu_torch.search import compiler as C
    from opensearch_tpu_torch.search import fastpath, impactpath
    C.reset_stats()
    bm25.reset_counts()
    fastpath.reset_stats()
    impactpath.reset_stats()
    lat, reqs, resps = [], [], []
    t_all = time.perf_counter()
    for b in bodies:
        body = b
        for page in range(1 + chain):
            t0 = time.perf_counter()
            r = client.search("bench", body)
            lat.append((time.perf_counter() - t0) * 1e3)
            reqs.append(body)
            resps.append(r)
            hits = r["hits"]["hits"]
            if page == chain or not hits:
                break
            body = dict(b, search_after=hits[-1]["sort"])
    wall = time.perf_counter() - t_all
    general = C.STATS["general_served"]
    launches = {k: v for k, v in bm25.COUNTS.items() if v}
    rungs = {k: v for k, v in fastpath.STATS.items() if v}
    t0 = time.perf_counter()
    extra: Counter = Counter()
    for body, r in zip(reqs, resps):
        extra.update(want_of(body, r))
    t_oracle = time.perf_counter() - t0
    t0 = time.perf_counter()
    ncpu = 1         # 2 before phase 15 shared the time limit
    for body in reqs[:ncpu]:
        if strip_took(client.search("bench", body)) \
                != strip_took(cpu.search("bench", body)):
            raise AssertionError(f"{name}: card and CPU responses differ "
                                 f"for {body}")
    t_cpu = time.perf_counter() - t0
    nb = min(OP_BODIES, len(reqs))
    restore, spans, host, calls = sort_op_timer()
    try:
        for body in reqs[:nb]:
            client.search("bench", body)
        torch.cuda.synchronize()
    finally:
        restore()
    ops_ms = {k: sum(a.elapsed_time(e) for a, e in v) / nb
              for k, v in spans.items()}
    host_ms = {k: v * 1e3 / nb for k, v in host.items()
               if k != "highlight"}
    if calls["highlight"]:
        host_ms["highlight_per_hit"] = host["highlight"] * 1e3 / calls[
            "highlight"]
    n = len(reqs)
    rest = lat[1:] or lat
    log(f"  {name}: requests={n} ({len(bodies)} bodies) wall_s={wall:.2f} "
        f"bodies_per_s={n / wall:.1f} ms_p50={np.percentile(lat, 50):.1f} "
        f"ms_p99={np.percentile(lat, 99):.1f} first_ms={lat[0]:.1f} "
        f"after_first_per_s={len(rest) / (sum(rest) / 1e3):.1f} "
        f"general={general} kernel_launches={launches} rungs={rungs}; {n} "
        f"responses == numpy brute force ({t_oracle:.1f}s) "
        f"{dict(extra)}; {ncpu} card == CPU ({t_cpu:.1f}s); device ms "
        f"per body (events) " + " ".join(
            f"{k}={v:.4f}" for k, v in sorted(ops_ms.items()))
        + "; host ms per body " + " ".join(
            f"{k}={v:.3f}" for k, v in sorted(host_ms.items())))
    return {"requests": n, "bodies": len(bodies), "bodies_per_s": n / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)), "first_ms": lat[0],
            "general": general, "launches": launches, "rungs": rungs,
            "op_ms": ops_ms, "host_ms": host_ms, **dict(extra)}


def sort_checker(big: dict, oracle: SortOracle):
    """-> want_of(body, resp) -> Counter: a phase-11 response of classes
    (a)-(e) against SortOracle (raises on a difference), with the counts
    of pages other than the exact page ((a), (d): several keys) and of
    hits the reference's cursor would drop ((c))."""
    ix = oracle.ix
    terms_of = {json.dumps(big["bodies"][j]["query"], sort_keys=True):
                big["body_terms"][j] for j in range(0, len(big["bodies"]),
                                                    2)}
    memo: dict = {}

    def matched_of(body):
        key = json.dumps(body["query"], sort_keys=True)
        if key not in memo:
            memo.clear()       # one query's dense arrays at a time
            memo[key] = query_match(ix, oracle, body, terms_of.get(key))
        return memo[key]

    def sorted_want(body, r):
        score, m = matched_of(body)
        want = oracle.page(m, score, body)
        hits = []
        for g, sc in want["hits"]:
            h = {"_id": ix.id_of(g), "_score": sc,
                 "sort": [oracle.render(oracle.spec_parts(s)[0], g)
                          for s in body["sort"]]}
            if "docvalue_fields" in body:
                h["fields"] = {f: [oracle.render(f, g)]
                               for f in body["docvalue_fields"]}
                h["_source"] = {"doc": g} if g < ix.n0 else {}
            hits.append(h)
        ms = (float(np.max(score[m & ix.live])) if body.get("track_scores")
              else None)
        check_hits(r, hits, want["total"], ms, f"body {body}")
        extra: Counter = Counter()
        if len(body["sort"]) > 1:
            extra["pages_not_exact"] += oracle.exact_ids(m, body) \
                != want["ids"]
        if body["sort"] == [{"rating": "asc"}] and "search_after" in body:
            ref = oracle.page(m, score, body, ref_cursor=True)["ids"]
            extra["reference_cursor_drops"] += len(set(want["ids"])
                                                   - set(ref))
        return extra

    def collapse_want(body, r):
        score, m = matched_of(body)
        hits = []
        for g, sc in oracle.collapse_page(m, score):
            pv = int(oracle.vals["price"][g])
            h = {"_id": ix.id_of(g), "_score": sc, "fields": {"price": [pv]}}
            if "inner_hits" in body["collapse"]:
                grp = m & (oracle.vals["price"] == pv)
                ids, scs, tot = ix.page(score, grp, 0, 2)
                h["inner_hits"] = {"more": (
                    [{"_id": i, "_score": s} for i, s in zip(ids, scs)],
                    tot, scs[0] if scs else None)}
            hits.append(h)
        live = m & ix.live
        check_hits(r, hits, int(live.sum()), float(np.max(score[live])),
                   f"body {body}", True)
        return Counter()

    return lambda body, r: (collapse_want if "collapse" in body
                            else sorted_want)(body, r)


def phase_sort_msmarco(big: dict, n: int) -> dict:
    """Classes (a)-(e) over phase 7's end state (the big segment with
    phase 7's re-indexed _ids deleted, their new versions, with ts and
    ratings, in a small segment), body by body through `search`, each
    response against SortOracle; (a) and (d) also count the pages that
    differ from the exact page (the window approximation at this size),
    (c) the hits the reference's cursor would drop. Class (f) runs on the
    merged segment (`phase_snippets_merged`): the kernels decline a
    segment with deletes."""
    client = big["client"]
    dev = client.device
    eng = client._indices["bench"].engine
    segs = list(eng.segments)
    oracle = SortOracle(big["ix"], big["aggs"])
    want_of = sort_checker(big, oracle)
    cpu = twin_of(eng)
    out: dict = {}
    nbytes0 = sort_ords_bytes(segs, dev)
    for name, bodies in sort_classes(big, n).items():
        out[name] = run_sort_class(client, name, bodies,
                                   SORT_CHAIN if name[0] in "bc" else 0,
                                   want_of, cpu)
        # (e)'s inner hits are sub-searches that any rung may serve
        if (out[name]["launches"] and name[0] != "e") \
                or out[name]["general"] < out[name]["requests"]:
            raise AssertionError(f"{name}: not on the general path: "
                                 f"{out[name]}")
    nbytes = sort_ords_bytes(segs, dev)
    slots = next_pow2_16(segs[0].ndocs + 1)
    log(f"  sort ordinals on the card (price, ts, rating of both "
        f"segments; i32 a doc): {nbytes} bytes (before the phase: "
        f"{nbytes0}); collapse on price, transient a body: {slots} group "
        f"slots (f32 best key + i64 best doc, {slots * 12} bytes) and the "
        f"big segment's i64 group and candidate per doc "
        f"({segs[0].ndocs * 16} bytes)")
    return {"classes": out, "sort_ords_bytes": nbytes,
            "collapse_slot_bytes": slots * 12,
            "collapse_doc_bytes": segs[0].ndocs * 16}


def snippet_checker(big: dict):
    """-> want_of(body, resp): a class-(f) response against the title
    BM25 brute force and the rendered title with each query term
    wrapped."""
    from opensearch_tpu_torch import bench_corpus as bc
    ix = big["ix"]
    src = bc.LazySources(ix.n0, big["title"])

    def want_of(body, r):
        terms = body["query"]["match"]["title"].split()
        score, m = title_group(ix, terms)
        ids, scs, total = ix.page(score, m, 0, 10)
        hits = []
        for i, s in zip(ids, scs):
            text = src[int(i)]["title"]
            hl = " ".join(f"<em>{t}</em>" if t in terms else t
                          for t in text.split(" "))
            hits.append({"_id": i, "_score": s, "_source": {"title": text},
                         "highlight": {"title": [hl]}})
        check_hits(r, hits, total, scs[0] if scs else None,
                   f"body {body}", True)
        return Counter()
    return want_of


def phase_snippets_merged(big: dict, n: int) -> dict:
    """Class (f) on phase 8's merged segment (no deletes, so the fused
    kernels serve it): score-ordered title matches with highlighted
    titles, B2 on the default bodies, B1 on those with exact totals."""
    client = big["client"]
    out = run_sort_class(client, "f_snippets (merged segment)",
                         snippet_bodies(big, n), 0, snippet_checker(big),
                         twin_of(client._indices["bench"].engine))
    la = out["launches"]
    if not la.get("launches") or not la.get("impact_launches") \
            or la.get("plain_calls") or out["general"]:
        raise AssertionError(f"class (f): not on B1 and B2 alone: {out}")
    return out


def twin_of(eng):
    from opensearch_tpu_torch import RestClient
    cpu = RestClient(device="cpu")
    cpu.indices.create("bench", BENCH_MAPPING)
    cpu._indices["bench"].engine.segments = list(eng.segments)
    return cpu


# ---------------------------------------------------------------------
# phase 12: term-expanding queries and keyword ranges at MS MARCO scale
# ---------------------------------------------------------------------

VOCAB_ALPHABET = "t0123456789"    # every body term is "t" and 7 digits


def osa_distance(a: str, b: str) -> int:
    """Plain optimal string alignment distance: insertions, deletions,
    substitutions and swaps of two adjacent chars each count 1."""
    d = [[i + j if i * j == 0 else 0 for j in range(len(b) + 1)]
         for i in range(len(a) + 1)]
    for i in range(1, len(a) + 1):
        for j in range(1, len(b) + 1):
            d[i][j] = min(d[i - 1][j] + 1, d[i][j - 1] + 1,
                          d[i - 1][j - 1] + (a[i - 1] != b[j - 1]))
            if i > 1 and j > 1 and a[i - 1] == b[j - 2] \
                    and a[i - 2] == b[j - 1]:
                d[i][j] = min(d[i][j], d[i - 2][j - 2] + 1)
    return d[-1][-1]


def one_edit(s: str) -> set:
    """The strings one insertion, deletion, substitution or adjacent swap
    from `s` over the vocabulary's alphabet."""
    out = set()
    for i in range(len(s) + 1):
        out.update(s[:i] + c + s[i:] for c in VOCAB_ALPHABET)
        if i < len(s):
            out.add(s[:i] + s[i + 1:])
            out.update(s[:i] + c + s[i + 1:] for c in VOCAB_ALPHABET)
        if i < len(s) - 1:
            out.add(s[:i] + s[i + 1] + s[i] + s[i + 2:])
    return out


def fuzzy_ids(term: str, k: int, index: dict) -> list:
    """Vocabulary ids within k single edits of `term` that pass a plain
    OSA check (two edits can compose to more than two OSA steps)."""
    cands = frontier = {term}
    for _ in range(k):
        frontier = set().union(*(one_edit(s) for s in frontier))
        cands = cands | frontier
    return sorted(index[s] for s in cands
                  if s in index and osa_distance(s, term) <= k)


def auto_k(term: str) -> int:
    """OpenSearch's AUTO fuzziness: 0 below 3 chars, 1 up to 5, else 2."""
    return 0 if len(term) < 3 else (1 if len(term) <= 5 else 2)


def rows_mask(ix, ids, cap=None, vs=None) -> np.ndarray:
    """bool[ix.n]: the docs holding any of the term ids. With `cap` (a
    prefix's max expansions) each segment keeps its own first `cap` rows:
    the corpus segment's vocabulary is every vocab string, the
    re-indexed docs' segment's the terms they hold."""
    m = np.zeros(ix.n, bool)
    big = ids if cap is None else ids[:cap]
    small = ids if cap is None else [t for t in ids if t in ix.extra][:cap]
    for part, keep in ((big, lambda d: d < ix.n0),
                       (small, lambda d: d >= ix.n0)):
        for t in part:
            d, _tf = ix.row(int(t))
            m[d[keep(d)]] = True
    return m


def expand_classes(big: dict, n: int) -> dict:
    """Phase 12's traffic, `n` bodies a class from pick_queries rows (the
    mid-df band) over the body vocabulary t0000000..t0199999: name ->
    [(body, oracle(ix))], each oracle expanding from the vocabulary
    strings alone (str.startswith, fnmatch, re.fullmatch, the strings
    within two single edits with a plain OSA check) and scoring with the
    NumpyIndex."""
    import fnmatch
    import re
    from opensearch_tpu_torch import bench_corpus as bc
    df = big["corpus"][4]
    vs = bc.vocab_strings(len(df))
    index = {v: i for i, v in enumerate(vs)}
    q = bc.pick_queries(df, n, seed=12)

    def ids_where(pred):
        return lambda: [i for i, v in enumerate(vs) if pred(v)]

    def const(ids_fn):
        def f(ix):
            return ix.page(np.ones(ix.n, np.float32), rows_mask(
                ix, ids_fn()), 0, 10)
        return f

    def t(i, j=0):
        return vs[int(q[i][j])]

    def changed(s: str, i: int) -> str:
        p = 4 + i % 4               # one digit of the last four
        return s[:p] + str((int(s[p]) + 1) % 10) + s[p + 1:]

    def match_fuzzy(terms, msm):
        def f(ix):
            score = np.zeros(ix.n, np.float32)
            for s in terms:
                score = score + rows_mask(
                    ix, fuzzy_ids(s, auto_k(s), index)).astype(np.float32)
            return ix.page(score, score >= np.float32(msm), 0, 10)
        return f

    def bool_prefix(a, b_, prefix):
        def f(ix):
            s1, ok1 = ix.group([a])
            s2, ok2 = ix.group([b_])
            m = rows_mask(ix, [i for i, v in enumerate(vs)
                               if v.startswith(prefix)], cap=50)
            score = ((np.float32(0.0) + s1) + s2) + m.astype(np.float32)
            return ix.page(score, ok1 | ok2 | m, 0, 10)
        return f

    classes = {
        "prefix7": [({"query": {"prefix": {"body": t(i)[:7]}}},
                     const(ids_where((lambda p: lambda v: v.startswith(p))(
                         t(i)[:7])))) for i in range(n)],
        "prefix6": [({"query": {"prefix": {"body": t(i)[:6]}}},
                     const(ids_where((lambda p: lambda v: v.startswith(p))(
                         t(i)[:6])))) for i in range(n)],
        "wildcard": [({"query": {"wildcard": {"body": p}}},
                      const(ids_where((lambda p_: lambda v: fnmatch
                                       .fnmatchcase(v, p_))(p))))
                     for p in (t(i)[:5] + "?" + t(i)[6] + "*"
                               for i in range(n))],
        "regexp": [({"query": {"regexp": {"body": p}}},
                    const(ids_where((lambda r: lambda v: r.fullmatch(v)
                                     is not None)(re.compile(p)))))
                   for p in (t(i)[:4] + "[0-9]{2}" + t(i)[6] + "[0-9]"
                             for i in range(n))],
        "regexp_alt": [({"query": {"regexp": {"body": p}}},
                        const(ids_where((lambda r: lambda v: r.fullmatch(v)
                                         is not None)(re.compile(p)))))
                       for p in (t(i)[:5] + "(" + "|".join(
                           t(i, j)[5:7] for j in range(3)) + ")[0-9]"
                           for i in range(n))],
        "fuzzy": [({"query": {"fuzzy": {"body": t(i)}}},
                   const((lambda s: lambda: fuzzy_ids(s, auto_k(s), index))(
                       t(i)))) for i in range(n)],
        "match_fuzzy": [({"query": {"match": {"body": dict(
            query=f"{changed(t(i), i)} {changed(t(i, 1), i + 1)}",
            fuzziness="AUTO", **({"operator": "and"} if i % 2 else {}))}}},
            match_fuzzy([changed(t(i), i), changed(t(i, 1), i + 1)],
                        2 if i % 2 else 1)) for i in range(n)],
        "bool_prefix": [({"query": {"match_bool_prefix": {
            "body": f"{t(i)} {t(i, 1)} {t(i, 2)[:6]}"}}},
            bool_prefix(int(q[i][0]), int(q[i][1]), t(i, 2)[:6]))
            for i in range(n)],
    }
    return classes


def filter_classes(big: dict, n: int) -> list:
    """The bool class with an expanded filter (run on phase 8's merged
    segment, which the kernels serve): a 2-term match must of mid-df
    terms with, in the filter, a keyword range on status (draft and
    published: 2/3 of the docs, a dense filter) in body 0, a 6-char
    prefix of a third mid-df term on body (100 rows) in the others. One
    use of the dense filter builds its mask and list; a second would
    build its filter-specialized postings (24.7 s at 8.8M passages on an
    H100 80GB HBM3, 700 W) and a third its filtered view (22.4 s), which
    phases 6 and 8 measure."""
    from opensearch_tpu_torch import bench_corpus as bc
    df = big["corpus"][4]
    vs = bc.vocab_strings(len(df))
    q = bc.pick_queries(df, n, seed=12)
    lo = bc.STATUS_VALUES.index("draft")
    hi = bc.STATUS_VALUES.index("published")
    items = []
    for i in range(n):
        a, b_ = int(q[i][0]), int(q[i][1])
        if i == 0:
            filt = {"range": {"status": {"gte": "b", "lt": "q"}}}

            def mask(ix):
                return (ix.status >= lo) & (ix.status <= hi)
        else:
            p = vs[int(q[i][2])][:6]
            filt = {"prefix": {"body": p}}

            def mask(ix, p=p):
                return rows_mask(ix, [j for j, v in enumerate(vs)
                                      if v.startswith(p)])
        body = {"query": {"bool": {"must": [
            {"match": {"body": f"{vs[a]} {vs[b_]}"}}], "filter": [filt]}}}
        items.append((body, (lambda a_, b2, mk: lambda ix: ix.bool_page(
            [(a_, "fam"), (b2, "fam")], 1, mk(ix), None))(a, b_, mask)))
    return items


def expand_timer():
    """Time the expansions: host ms of each expander call by kind (the
    nonzero copy back syncs the card), rows and postings per call, and
    CUDA events around the regexp DFA and the fuzzy DP; and the event ms
    of the general path's gather + mask (`term_match_mask`), BM25 term
    scatter and top-k. -> (restore(), stats)."""
    import torch
    from opensearch_tpu_torch.ops import scoring
    from opensearch_tpu_torch.search import compiler as C
    from opensearch_tpu_torch.search import regexp as rx
    st = {"host": {}, "rows": {}, "postings": {}, "events": {}}
    saved = []

    def patch(obj, name, new):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    def factory(kind, real):
        def make(field, *a, **kw):
            expand = real(field, *a, **kw)

            def timed(seg):
                t0 = time.perf_counter()
                rows = expand(seg)
                st["host"].setdefault(kind, []).append(
                    (time.perf_counter() - t0) * 1e3)
                pb = seg.postings.get(field)
                npost = (int((pb.starts[rows + 1] - pb.starts[rows]).sum())
                         if pb is not None and len(rows) else 0)
                st["rows"].setdefault(kind, []).append(len(rows))
                st["postings"].setdefault(kind, []).append(npost)
                return rows
            return timed
        return make

    for kind in ("prefix", "wildcard", "regexp", "fuzzy",
                 "keyword_range"):
        name = f"_{kind}_expander"
        patch(C, name, factory(kind, getattr(C, name)))

    def evented(label, real):
        def run(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = real(*a, **kw)
            e1.record()
            st["events"].setdefault(label, []).append((e0, e1))
            return out
        return run

    patch(rx, "osa_within", evented("fuzzy_dp", rx.osa_within))
    patch(rx.Dfa, "match_matrix", evented("regexp_dfa",
                                          rx.Dfa.match_matrix))
    for name, label in (("term_match_mask", "gather_mask"),
                        ("score_term_group", "term_scatter"),
                        ("topk_docs", "topk")):
        patch(scoring, name, evented(label, getattr(scoring, name)))

    def restore():
        for obj, name, real in reversed(saved):
            setattr(obj, name, real)
    return restore, st


def run_expand_class(client, name: str, items, ix, cpu, rtol=1e-6,
                     cpu_bodies=(0, 1), profiled=slice(None)) -> dict:
    """One class through msearch (counts set to 0 just before) under the
    expansion timer, every page against the brute force, the 2 bodies
    `cpu_bodies` on the card against the CPU, the bodies `profiled` again
    in one profiled batch: -> the class's numbers."""
    import torch
    from opensearch_tpu_torch.search import compiler as C
    from opensearch_tpu_torch.search import impactpath
    bodies = [b for b, _o in items]
    impactpath.reset_stats()
    C.reset_stats()
    restore, st = expand_timer()
    try:
        resps, wall, lat, counts, rungs = run_batches(client, bodies)
        torch.cuda.synchronize()
    finally:
        restore()
    rungs = {**rungs, "impact_served": impactpath.STATS["served"],
             "general": C.STATS["general_served"]}
    t0 = time.perf_counter()
    for (b, oracle), r in zip(items, resps):
        check_page(r, oracle(ix), f"{name} body {b}", rtol)
    t_oracle = time.perf_counter() - t0
    lines = sum([[{}, bodies[i]] for i in cpu_bodies if i < len(bodies)],
                [])
    t0 = time.perf_counter()
    if strip_took(client.msearch(lines, index="bench")) \
            != strip_took(cpu.msearch(lines, index="bench")):
        raise AssertionError(f"{name}: 2 bodies: card and CPU responses "
                             f"differ")
    t_cpu = time.perf_counter() - t0
    n = len(bodies)
    ev = {k: sum(a.elapsed_time(e) for a, e in v) / n
          for k, v in st["events"].items()}
    host = {k: sum(v) / n for k, v in st["host"].items()}
    rows = {k: (min(v), max(v), sum(v) / len(v))
            for k, v in st["rows"].items()}
    post = {k: sum(v) / n for k, v in st["postings"].items()}
    idle = profile_batch(client, bodies[profiled])
    rels = Counter(r["hits"]["total"]["relation"] for r in resps)
    log(f"  {name}: queries={n} batch={BATCH} wall_s={wall:.2f} "
        f"qps={n / wall:.1f} batch_ms_p50={np.percentile(lat, 50):.1f} "
        f"batch_ms_p99={np.percentile(lat, 99):.1f} kernel launches "
        f"B1={counts['launches']} B2={counts['impact_launches']} "
        f"B3={counts['bool_launches']} plain_calls={counts['plain_calls']}"
        f" rungs " + " ".join(f"{k}={v}" for k, v in rungs.items() if v)
        + f" relations={dict(rels)}; {n} pages == numpy brute force "
        f"({t_oracle:.1f}s); 2 bodies card == CPU ({t_cpu:.1f}s)")
    log(f"  {name}: per body: expansion host ms " + " ".join(
        f"{k}={v:.3f}" for k, v in sorted(host.items()))
        + "; rows (min, max, mean over segments) " + " ".join(
        f"{k}={v[0]}/{v[1]}/{v[2]:.1f}" for k, v in sorted(rows.items()))
        + "; postings " + " ".join(
        f"{k}={v:.0f}" for k, v in sorted(post.items()))
        + "; event ms " + " ".join(
        f"{k}={v:.4f}" for k, v in sorted(ev.items())))
    return {"qps": n / wall, "p50": float(np.percentile(lat, 50)),
            "p99": float(np.percentile(lat, 99)), "batch_ms": lat,
            "counts": counts, "rungs": rungs, "expand_host_ms": host,
            "rows": rows, "postings": post, "event_ms": ev,
            "idle_share_one_batch": idle}


def phase_expand_msmarco(big: dict, n: int) -> dict:
    """Phase 12 over phase 7's end state (the corpus segment with 64
    deletes, the re-indexed docs' segment): every class on the general
    path (no fused kernel serves an expansion in scoring position, and
    none serves a segment with deletes)."""
    client = big["client"]
    cpu = twin_of(client._indices["bench"].engine)
    out = {}
    for name, items in expand_classes(big, n).items():
        out[name] = r = run_expand_class(client, name, items, big["ix"], cpu)
        c = r["counts"]
        if r["rungs"]["general"] == 0 or c["plain_calls"] or any(
                c[k] for k in ("launches", "impact_launches",
                               "bool_launches")):
            raise AssertionError(f"{name}: not on the general path alone: "
                                 f"{r}")
    return out


def phase_expand_filter_merged(big: dict, n: int) -> dict:
    """Phase 12's filter class on phase 8's merged segment: B3 (the filter
    as a slot or a probe, filter-specialized postings from a dense
    filter's second use) or the pruned ladder over the filtered view."""
    client = big["client"]
    # the dense filter once: card == CPU and the profile on prefix-filter
    # bodies (see filter_classes)
    out = run_expand_class(client, "bool_expanded_filter (merged segment)",
                           filter_classes(big, n), big["ix"],
                           twin_of(client._indices["bench"].engine),
                           rtol=9 * 2.0**-23, cpu_bodies=(1, 3),
                           profiled=slice(1, None))
    c = out["counts"]
    if not (c["bool_launches"] or c["launches"]) or c["plain_calls"] \
            or out["rungs"]["general"]:
        raise AssertionError(f"bool_expanded_filter: not on the kernels: "
                             f"{out}")
    return out


# ---------------------------------------------------------------------
# phase 13: compound and multi-field queries, named queries
# ---------------------------------------------------------------------

def body_terms(ix, terms, boost: float = 1.0) -> tuple:
    """BM25 of a body term group (term ids, query order) with `boost`
    folded into each weight, f32(boost x idf): (scores f32[n], number of
    the terms each doc holds i32[n]) over the counted docs."""
    import math
    score = np.zeros(ix.n, np.float32)
    count = np.zeros(ix.n, np.int32)
    for t in terms:
        if boost == 1.0:
            d, c = ix.contributions(t)
        else:
            d, tf = ix.row(t)
            n, df = ix.n_stats, len(d)
            w = np.float32(boost * math.log(1.0 + (n - df + 0.5)
                                            / (df + 0.5)))
            c = (w * tf) / (tf + K1 * (OMB + (B * ix.dl[d]) / ix.avgdl()))
        score[d] += c
        count[d] += 1
    return score, count


def title_rows_of(ix, t: str):
    """(counted docs, tfs) of title term `t` (none where the title
    vocabulary lacks it)."""
    rows = ix.title_rows(t)
    if not rows:
        return np.zeros(0, np.int64), np.zeros(0, np.float32)
    starts, docs_all, tfs_all = ix.title[:3]
    a, b_ = int(starts[rows[0]]), int(starts[rows[0] + 1])
    d, tf = docs_all[a:b_].astype(np.int64), tfs_all[a:b_]
    if ix.n_stats != ix.n:
        keep = ix.counted[d]
        d, tf = d[keep], tf[keep]
    return d, tf


def title_terms(ix, terms, boost: float = 1.0) -> tuple:
    """body_terms over the title field (term strings): every title holds
    TITLE_DL tokens."""
    import math
    from opensearch_tpu_torch import bench_corpus as bc
    avgdl, n = ix.title_stats()
    k = K1 * (OMB + (B * np.float32(bc.TITLE_DL)) / avgdl)
    score = np.zeros(ix.n, np.float32)
    count = np.zeros(ix.n, np.int32)
    for t in terms:
        d, tf = title_rows_of(ix, t)
        if len(d) == 0:
            continue
        w = np.float32(boost * math.log(1.0 + (n - len(d) + 0.5)
                                        / (len(d) + 0.5)))
        score[d] += (w * tf) / (tf + k)
        count[d] += 1
    return score, count


def np_dismax(parts, tie: float, boost: float) -> tuple:
    """dis_max of children's (scores zero where unmatched, matched): the
    best plus tie x the rest, x boost: (scores, matched)."""
    best = total = np.zeros(len(parts[0][0]), np.float32)
    matched = np.zeros(len(best), bool)
    for s, ok in parts:
        best = np.maximum(best, s)
        total = total + s
        matched |= ok
    sc = best + np.float32(tie) * (total - best)
    return np.where(matched, sc * np.float32(boost), np.float32(0)), matched


def np_combined(ix, terms, weights, title_len) -> tuple:
    """combined_fields' BM25F over body and title of the body term ids
    and title strings in `terms` [(kind, term)], fields weighted by
    `weights` (body, title): each term's tf summed over the fields and
    the doc lengths likewise (the title's only where the doc has one,
    `title_len`), idf from the union df (the fields share no term here),
    the LUCENE-8563 saturation, terms summed in order: (scores,
    matched)."""
    import math
    from opensearch_tpu_torch import bench_corpus as bc
    wb, wt = np.float32(weights[0]), np.float32(weights[1])
    n = ix.n_stats
    dlc = np.float32(0) + wb * ix.dl
    dlc = np.where(title_len, dlc + wt * np.float32(bc.TITLE_DL), dlc)
    avgdl = np.float32(weights[0] * (ix.sum_dl / ix.n_stats)
                       + weights[1] * float(ix.title_stats()[0]))
    norm = K1 * (OMB + (B * dlc) / avgdl)
    score = np.zeros(ix.n, np.float32)
    count = np.zeros(ix.n, np.int32)
    for kind, t in terms:
        tfc = np.zeros(ix.n, np.float32)
        if kind == "body":
            d, tf = ix.row(t)
            tfc[d] = wb * tf
        else:
            d, tf = title_rows_of(ix, t)
            tfc[d] = wt * tf
        idf = np.float32(math.log(1.0 + (n - len(d) + 0.5) / (len(d) + 0.5))
                         if len(d) else 0.0)
        hit = tfc > 0
        score = score + np.where(hit, idf * (tfc / (tfc + norm)),
                                 np.float32(0))
        count += hit
    return score, count >= 1


def compound_classes(big: dict, n: int) -> dict:
    """Phase 13's traffic on phase 7's end state, `n` bodies a class from
    seeded pick_queries rows (mid-df body terms t...) and title pool
    bigrams (p...): name -> [(body, oracle(ix) -> page, or (page, the
    expected matched_queries of each hit))], every oracle reading the
    CSR arrays and columns alone."""
    from opensearch_tpu_torch import bench_corpus as bc
    df = big["corpus"][4]
    vs = bc.vocab_strings(len(df))
    title = big["title"]
    tvs = bc.title_vocab_strings(len(title[0]) - 1)
    pairs = bc.pick_phrase_pairs(title[7], n, seed=31)
    q = bc.pick_queries(df, n, seed=13)
    rng = np.random.default_rng(131)
    high = np.argsort(-df)[8:40]
    has_title = (lambda ix: np.arange(ix.n) < ix.n0)

    def t(i, j=0):
        return vs[int(q[i][j])]

    def p(i, j=0):
        return tvs[int(title[5 + j][pairs[i]])]

    def mm_best(i):
        a, px = int(q[i][0]), p(i)
        body = {"query": {"multi_match": {
            "query": f"{vs[a]} {px}", "fields": ["title^2", "body"],
            "tie_breaker": 0.3}}}

        def oracle(ix):
            st, ct = title_terms(ix, [px], 2.0)
            sb, cb = body_terms(ix, [a])
            return ix.page(*np_dismax([(st, ct > 0), (sb, cb > 0)], 0.3,
                                      1.0), 0, 10)
        return body, oracle

    def mm_most(i):
        a, px = int(q[i][0]), p(i, 1)
        body = {"query": {"multi_match": {
            "query": f"{vs[a]} {px}", "fields": ["title", "body"],
            "type": "most_fields"}}}

        def oracle(ix):
            st, ct = title_terms(ix, [px])
            sb, cb = body_terms(ix, [a])
            ok = (ct > 0) | (cb > 0)
            return ix.page(np.where(ok, ((np.float32(0) + st) + sb)
                                    * np.float32(1), np.float32(0)), ok,
                           0, 10)
        return body, oracle

    def mm_phrase(i):
        terms = [p(i), p(i, 1)]
        body = {"query": {"multi_match": {
            "query": " ".join(terms), "fields": ["title", "body"],
            "type": "phrase"}}}
        return body, lambda ix: ix.phrase_page(terms)

    def dis_max(i):
        a, px, py = int(q[i][1]), p(i), p(i, 1)
        body = {"query": {"dis_max": {"queries": [
            {"term": {"body": vs[a]}},
            {"match": {"title": f"{px} {py}"}}], "tie_breaker": 0.7}}}

        def oracle(ix):
            sb, cb = body_terms(ix, [a])
            st, ct = title_terms(ix, [px, py])
            return ix.page(*np_dismax([(sb, cb > 0), (st, ct > 0)], 0.7,
                                      1.0), 0, 10)
        return body, oracle

    def boosting(i):
        a, b_, st = int(q[i][0]), int(q[i][1]), i % 3
        body = {"query": {"boosting": {
            "positive": {"match": {"body": f"{vs[a]} {vs[b_]}"}},
            "negative": {"term": {"status": bc.STATUS_VALUES[st]}},
            "negative_boost": 0.2}}}

        def oracle(ix):
            s, c = body_terms(ix, [a, b_])
            f = np.where(ix.status == st, np.float32(0.2), np.float32(1.0))
            return ix.page((s * f) * np.float32(1.0), c > 0, 0, 10)
        return body, oracle

    def combined(i):
        a, px = int(q[i][2]), p(i)
        body = {"query": {"combined_fields": {
            "query": f"{vs[a]} {px}", "fields": ["body", "title^2"]}}}

        def oracle(ix):
            return ix.page(*np_combined(ix, [("body", a), ("title", px)],
                                        (1.0, 2.0), has_title(ix)), 0, 10)
        return body, oracle

    def terms_set(i):
        terms = sorted(rng.choice(high, 4, replace=False).tolist())
        body = {"query": {"terms_set": {"body": {
            "terms": [vs[x] for x in terms],
            "minimum_should_match_field": "rating"}}}}

        def oracle(ix):
            s, c = body_terms(ix, terms)
            _ts, r_later, has_later = ix.later_arrays()
            _ts0, r0, has0 = big["aggs"]
            r = np.concatenate([r0, r_later]).astype(np.float32)
            has = np.concatenate([has0, has_later])
            need = np.where(has, np.maximum(r, np.float32(1)),
                            np.float32(np.inf))
            ok = c.astype(np.float32) >= need
            return ix.page(np.where(ok, s, np.float32(0)), ok, 0, 10)
        return body, oracle

    def pinned(i):
        a, b_ = int(q[i][0]), int(q[i][2])
        re_id = str(big["reindexed"][i % len(big["reindexed"])][0])
        picks = rng.choice(big["seg"].ndocs, 7, replace=False).tolist()
        ids = [str(x) for x in picks[:3]] + [re_id, str(picks[1]),
                                             str(10 ** 9)] + \
            [str(x) for x in picks[3:]]
        body = {"query": {"pinned": {"ids": ids, "organic": {
            "match": {"body": f"{vs[a]} {vs[b_]}"}}}}}

        def oracle(ix):
            g_of = {s: ix.n0 + j for j, s in enumerate(ix.new_ids)}
            pin = np.zeros(ix.n, np.float32)
            for rank in range(len(ids) - 1, -1, -1):
                s = ids[rank]
                g = g_of.get(s, int(s) if int(s) < ix.n0 else -1)
                if g >= 0:
                    pin[g] = np.float32(1e6) - np.float32(rank)
            s, c = body_terms(ix, [a, b_])
            pinned_ = pin > 0
            score = np.where(pinned_, pin, s * np.float32(1.0))
            return ix.page(score, pinned_ | (c > 0), 0, 10)
        return body, oracle

    def named(i):
        a, b_ = int(q[i][0]), int(q[i][1])
        lo = 100 * (i % 5)
        body = {"query": {"bool": {"should": [
            {"match": {"body": {"query": vs[a], "_name": "first"}}},
            {"match": {"body": {"query": vs[b_], "_name": "second"}}}],
            "filter": [{"range": {"price": {"gte": lo, "lt": lo + 300,
                                            "_name": "price"}}}],
            "minimum_should_match": 1}}}

        def oracle(ix):
            sa, ca = body_terms(ix, [a])
            sb, cb = body_terms(ix, [b_])
            pm = (ix.price >= lo) & (ix.price < lo + 300)
            ok = pm & ((ca > 0) | (cb > 0))
            page = ix.page(np.where(ok, ((np.float32(0) + sa) + sb)
                                    * np.float32(1), np.float32(0)), ok,
                           0, 10)
            names = []
            for hid in page[0]:
                g = (ix.n0 + ix.new_ids.index(hid) if hid in ix.new_ids
                     else int(hid))
                names.append([nm for nm, m in (("first", ca[g] > 0),
                                               ("price", pm[g]),
                                               ("second", cb[g] > 0)) if m])
            return page, names
        return body, oracle

    makers = {"mm_best": mm_best, "mm_most": mm_most,
              "mm_phrase": mm_phrase, "dis_max": dis_max,
              "boosting": boosting, "combined": combined,
              "terms_set": terms_set, "pinned": pinned, "named": named}
    return {name: [f(i) for i in range(n)] for name, f in makers.items()}


def compound_merged_classes(big: dict, n: int) -> dict:
    """Phase 13's classes on phase 8's merged segment: a single-field
    most_fields multi_match (B3), a 2-term match must with, in the
    filter, a dis_max of a status term and a 1% price range beside a 10%
    price range (B3; each body's 1% range its own), a base64 wrapper of
    a 2-term match (the pruned ladder). The 10% range keeps each filter
    list under 1/8 of the docs: a dense one (the status term alone is
    1/3) would build its filter-specialized postings at its second use
    (24.7 s at 8.8M passages on an H100 80GB HBM3, 700 W), which
    the class's card == CPU check and profile would be."""
    import base64
    from opensearch_tpu_torch import bench_corpus as bc
    df = big["corpus"][4]
    vs = bc.vocab_strings(len(df))
    q = bc.pick_queries(df, n, seed=17)
    items: dict = {"mm_one_field": [], "compound_filter": [], "wrapper": []}
    for i in range(n):
        a, b_ = int(q[i][0]), int(q[i][1])
        text = f"{vs[a]} {vs[b_]}"
        group = (lambda a_, b2: lambda ix: ix.page(
            *ix.group([a_, b2]), 0, 10))(a, b_)
        items["mm_one_field"].append(({"query": {"multi_match": {
            "query": text, "fields": ["body"], "type": "most_fields"}}},
            group))
        st, lo = i % 3, 200 + 10 * (i % 10)
        items["compound_filter"].append(({"query": {"bool": {
            "must": [{"match": {"body": text}}],
            "filter": [{"dis_max": {"queries": [
                {"term": {"status": bc.STATUS_VALUES[st]}},
                {"range": {"price": {"gte": lo, "lt": lo + 10}}}]}},
                {"range": {"price": {"gte": 200, "lt": 300}}}]}}},
            (lambda a_, b2, st_, lo_: lambda ix: ix.bool_page(
                [(a_, "fam"), (b2, "fam")], 1,
                ((ix.status == st_) | ((ix.price >= lo_)
                                       & (ix.price < lo_ + 10)))
                & (ix.price >= 200) & (ix.price < 300), None))(
                a, b_, st, lo)))
        wrapped = base64.b64encode(json.dumps(
            {"match": {"body": text}}).encode()).decode()
        items["wrapper"].append(({"query": {"wrapper": {"query": wrapped}}},
                                 (lambda a_, b2: lambda ix: ix.group_page(
                                     [a_, b2]))(a, b_)))
    return items


def compound_timer():
    """CUDA events around the compound layer's new ops (the dense tf
    gather of combined_fields, the dis_max and BM25F combines) and the
    general path's term scatter and top-k: -> (restore(), {op: [(start,
    end)]})."""
    import torch
    from opensearch_tpu_torch.ops import scoring
    spans: dict = {}
    saved = []
    for name, label in (("gather_tf_dense", "tf_gather"),
                        ("dismax", "dismax"), ("bm25f", "combine"),
                        ("score_term_group", "term_scatter"),
                        ("topk_docs", "topk")):
        real = getattr(scoring, name)

        def timed(*a, _real=real, _label=label, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = _real(*a, **kw)
            e1.record()
            spans.setdefault(_label, []).append((e0, e1))
            return out
        setattr(scoring, name, timed)
        saved.append((name, real))

    def restore():
        for name, real in saved:
            setattr(scoring, name, real)
    return restore, spans


def run_compound_class(client, name: str, items, ix, cpu,
                       rtol: float = 1e-6) -> dict:
    """One class through msearch (counts set to 0 just before) under the
    op timer, with the device's peak bytes above what it held before;
    every page against the brute force (and, where the oracle gives
    them, each hit's matched_queries), the first body on the card
    against the CPU (2 before phase 15 shared the time limit), one batch
    profiled: -> the class's numbers."""
    import torch
    from opensearch_tpu_torch.search import compiler as C
    from opensearch_tpu_torch.search import impactpath
    bodies = [b for b, _o in items]
    impactpath.reset_stats()
    C.reset_stats()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    restore, spans = compound_timer()
    try:
        resps, wall, lat, counts, rungs = run_batches(client, bodies)
        torch.cuda.synchronize()
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated() - base
    rungs = {**rungs, "impact_served": impactpath.STATS["served"],
             "general": C.STATS["general_served"]}
    t0 = time.perf_counter()
    named = 0
    for (b, oracle), r in zip(items, resps):
        want = oracle(ix)
        if len(want) == 2:
            want, names = want
            got = [h.get("matched_queries", []) for h in r["hits"]["hits"]]
            if got != names:
                raise AssertionError(f"{name} body {b}: matched_queries "
                                     f"{got} != {names}")
            named += sum(1 for x in got if x)
        check_page(r, want, f"{name} body {b}", rtol)
    t_oracle = time.perf_counter() - t0
    lines = sum([[{}, b] for b in bodies[:2]], [])
    t0 = time.perf_counter()
    if strip_took(client.msearch(lines, index="bench")) \
            != strip_took(cpu.msearch(lines, index="bench")):
        raise AssertionError(f"{name}: 2 bodies: card and CPU responses "
                             f"differ")
    t_cpu = time.perf_counter() - t0
    n = len(bodies)
    ev = {k: sum(a.elapsed_time(e) for a, e in v) / n
          for k, v in spans.items()}
    idle = profile_batch(client, bodies)
    log(f"  {name}: queries={n} wall_s={wall:.2f} qps={n / wall:.1f} "
        f"batch_ms={lat[0]:.1f} kernel launches B1={counts['launches']} "
        f"B2={counts['impact_launches']} B3={counts['bool_launches']} "
        f"plain_calls={counts['plain_calls']} rungs " + " ".join(
            f"{k}={v}" for k, v in rungs.items() if v)
        + f"; {n} pages == numpy brute force ({t_oracle:.1f}s"
        + (f", {named} hits' matched_queries" if named else "")
        + f"); 1 body card == CPU ({t_cpu:.1f}s); event ms a body "
        + " ".join(f"{k}={v:.4f}" for k, v in sorted(ev.items()))
        + f"; device peak bytes above the class's start {peak}")
    return {"qps": n / wall, "batch_ms": lat[0], "counts": counts,
            "rungs": rungs, "event_ms": ev, "peak_bytes": peak,
            "oracle_s": t_oracle, "cpu_check_s": t_cpu,
            "idle_share_one_batch": idle}


def phase_compound_msmarco(big: dict, n: int) -> dict:
    """Phase 13 over phase 7's end state (the corpus segment with 64
    deletes, the re-indexed docs' segment): every class on the general
    path (no fused kernel serves a segment with deletes or a named
    body)."""
    client = big["client"]
    eng = client._indices["bench"].engine
    cpu = twin_of(eng)
    dev = client.device
    out = {}
    for name, items in compound_classes(big, n).items():
        out[name] = r = run_compound_class(client, name, items, big["ix"],
                                           cpu)
        c = r["counts"]
        if r["rungs"]["general"] == 0 or c["plain_calls"] or any(
                c[k] for k in ("launches", "impact_launches",
                               "bool_launches")):
            raise AssertionError(f"{name}: not on the general path alone: "
                                 f"{r}")
    nbytes = {s.name: s.device_nbytes(dev) for s in eng.segments}
    log(f"  general path device arrays after phase 13 (terms_set minimum "
        f"columns among them): {nbytes} bytes")
    return {"classes": out, "device_bytes": nbytes}


def phase_compound_merged(big: dict, n: int) -> dict:
    """Phase 13's last three classes on phase 8's merged segment: B3 for
    the single-field multi_match and the compound filter, the pruned
    ladder (B2, B1) for the wrapper."""
    client = big["client"]
    cpu = twin_of(client._indices["bench"].engine)
    out = {}
    for name, items in compound_merged_classes(big, n).items():
        out[name] = r = run_compound_class(client, name, items, big["ix"],
                                           cpu, rtol=9 * 2.0**-23)
        c = r["counts"]
        on = (c["bool_launches"] if name != "wrapper"
              else c["launches"] + c["impact_launches"])
        if not on or c["plain_calls"] or r["rungs"]["general"]:
            raise AssertionError(f"{name}: not on its kernels: {r}")
    return out


# ---------------------------------------------------------------------
# phase 14: the search body's last options and the calls around a search
# ---------------------------------------------------------------------

RESCORE_MODES = ("total", "multiply", "avg", "max", "min")
SCROLL_SIZE, SCROLL_PAGES = 500, 8
PIT_SIZE, PIT_PAGES = 20, 4
CONTEXT_WRITES = 64    # _ids (d) re-indexes between its pages, and deletes
RESCORE_LANES = 16     # the kernels' lanes of a 10-hit page (K)
SHORT_TIMEOUT = "1ms"  # spent by the big segment's query phase


def np_combine(mode: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """A rescorer's score mode over f32 arrays, as the port combines."""
    if mode == "total":
        return a + b
    if mode == "multiply":
        return a * b
    if mode == "avg":
        return (a + b) / 2
    return np.maximum(a, b) if mode == "max" else np.minimum(a, b)


def rescored_page(ix, first, ok, rescorers, size: int = 10,
                  k: int = RESCORE_LANES) -> tuple:
    """The brute force of a rescored body on one segment: the first
    phase's k best live matched docs by (score desc, doc asc) are the
    lanes; each rescorer [(window_size, query weight, rescore weight,
    mode, (scores f32[n], matched bool[n]))] turns the lanes before its
    window into mode(qw x score, rw x rescore) where its query matches,
    else qw x score; the page is the lanes by score, ties in lane order:
    -> (ids, scores, total)."""
    docs = np.flatnonzero(ok & ix.live)
    lanes = top_by(first[docs], docs, k)
    sc = first[lanes].astype(np.float32)
    for ws, qw, rw, mode, (rs, rm) in rescorers:
        qs = qw * sc
        comb = np.where(rm[lanes], np_combine(mode, qs, rw * rs[lanes]), qs)
        sc = np.where(np.arange(len(sc)) < ws, comb, sc).astype(np.float32)
    order = np.argsort(-sc, kind="stable")[:size]
    return ([ix.id_of(int(g)) for g in lanes[order]], sc[order].tolist(),
            len(docs))


def phrase_dense(ix, terms) -> tuple:
    """(f32[n] scores, bool[n] matched) of a title match_phrase."""
    d, s = ix.phrase(terms)
    sc = np.zeros(ix.n, np.float32)
    m = np.zeros(ix.n, bool)
    sc[d], m[d] = s, True
    return sc, m


def rescore_classes(big: dict, n: int, b3_kinds=(0, 1, 2, 3)) -> dict:
    """Phase 14's rescored bodies for the merged segment, `n` a class:
    (a) a 2-term body match of phase 5, size 10, rescored over 50 lanes
    (the kernels return 16) by a match_phrase of a title pool bigram of
    one of its first-phase lanes (so that it matches), score modes
    cycling, body 5 of each 6 with a second rescorer (a title term, max,
    over 8 lanes); (a') phase 6's b3 bool shapes of `b3_kinds` (i % 4),
    rescored by a title term of one of their lanes. name -> [(body,
    oracle(ix))]."""
    from opensearch_tpu_torch import bench_corpus as bc
    ix = big["ix"]
    title = big["title"]
    tvs = bc.title_vocab_strings(len(title[0]) - 1)
    first_t, second_t, draw = title[5], title[6], title[8]
    df = big["corpus"][4]
    vs = bc.vocab_strings(len(df))
    queries = bc.pick_queries(df, 4 * n)

    def lane_pair(score, ok, i):
        """A pool bigram of the title of one of the first phase's lanes
        (a corpus doc, which has a title), or None without lanes."""
        docs = np.flatnonzero(ok & ix.live)
        lanes = [int(g) for g in top_by(score[docs], docs, RESCORE_LANES)
                 if g < ix.n0]
        if not lanes:
            return None
        g = lanes[(3 * i) % len(lanes)]
        p = int(draw[g, i % 4])
        return tvs[int(first_t[p])], tvs[int(second_t[p])]

    match, boolean = [], []
    cands = iter(range(len(big["body_terms"]) // 2))
    while len(match) < n:
        terms = list(big["body_terms"][2 * next(cands)])
        score, ok = ix.group(terms)
        i = len(match)
        pair = lane_pair(score, ok, i)
        if pair is None:
            continue
        a, b = pair
        mode = RESCORE_MODES[i % len(RESCORE_MODES)]
        body = {"query": {"match": {"body": " ".join(vs[t]
                                                     for t in terms)}},
                "size": 10, "rescore": [{"window_size": 50, "query": {
                    "rescore_query": {"match_phrase": {"title": f"{a} {b}"}},
                    "query_weight": 1.0, "rescore_query_weight": 1.5,
                    "score_mode": mode}}]}
        spec = [(50, 1.0, 1.5, mode, ("phrase", (a, b)))]
        if i % 6 == 5:
            body["rescore"].append({"window_size": 8, "query": {
                "rescore_query": {"match": {"title": b}},
                "score_mode": "max"}})
            spec.append((8, 1.0, 1.0, "max", ("term", b)))
        match.append((body, (lambda terms_, spec_: lambda ix_: (
            rescored_page(ix_, *ix_.group(terms_), resolve(ix_, spec_))))(
                terms, spec)))
    for i in range(len(queries)):
        if len(boolean) == n:
            break
        if i % 4 not in b3_kinds:
            continue
        slots, fam, mask, const = bool_oracle("b3", i, queries, ix.status,
                                              ix.price)
        pair = lane_pair(*ix.bool_scores(slots, fam, mask, const), i + 1)
        if pair is None:
            continue
        a = pair[0]
        mode = RESCORE_MODES[(i + 2) % len(RESCORE_MODES)]
        body = dict(bc.b3_body(i, queries, vs), rescore={
            "window_size": 50, "query": {
                "rescore_query": {"match": {"title": a}},
                "rescore_query_weight": 2.0, "score_mode": mode}})
        boolean.append((body, (lambda i_, spec_: lambda ix_: rescored_page(
            ix_, *ix_.bool_scores(*bool_oracle("b3", i_, queries,
                                               ix_.status, ix_.price)),
            resolve(ix_, spec_)))(i, [(50, 1.0, 2.0, mode, ("term", a))])))
    return {"a_rescore_match": match, "a2_rescore_bool": boolean}


def resolve(ix, spec) -> list:
    """A rescorer spec's query as dense (scores, matched) arrays."""
    out = []
    for ws, qw, rw, mode, (kind, arg) in spec:
        if kind == "phrase":
            q = phrase_dense(ix, list(arg))
        else:
            s, c = title_terms(ix, [arg])
            q = (s, c > 0)
        out.append((ws, qw, rw, mode, q))
    return out


def gather_timer():
    """CUDA events around the rescore's second pass
    (`compiler.gather_scores`: the rescore query's emit, then the gather
    at the lanes), on the card: -> (restore(), [(start, end)])."""
    import torch
    from opensearch_tpu_torch.search import compiler as C
    spans = []
    real = C.gather_scores

    def timed(lroot, seg, ctx, docs, device):
        if device.type != "cuda":
            return real(lroot, seg, ctx, docs, device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(lroot, seg, ctx, docs, device)
        e1.record()
        spans.append((e0, e1))
        return out
    C.gather_scores = timed

    def restore():
        C.gather_scores = real
    return restore, spans


def run_rescore_class(client, name: str, items, ix, cpu,
                      rtol: float = 4e-6) -> dict:
    """A rescored class body by body through RestClient.search (a
    rescored body leaves an msearch batch), counts set to 0 just before,
    under the gather timer: every page against the brute force, 2 bodies
    on the card against the CPU: -> the class's numbers."""
    from opensearch_tpu_torch.ops import bm25
    from opensearch_tpu_torch.search import compiler as C
    from opensearch_tpu_torch.search import fastpath, impactpath
    bm25.reset_counts()
    fastpath.reset_stats()
    impactpath.reset_stats()
    C.reset_stats()
    restore, spans = gather_timer()
    lat, resps = [], []
    t0 = time.perf_counter()
    try:
        for body, _o in items:
            tb = time.perf_counter()
            resps.append(client.search("bench", body))
            lat.append((time.perf_counter() - tb) * 1e3)
        device_bytes(client.device)    # a sync on the card
    finally:
        restore()
    wall = time.perf_counter() - t0
    counts, rungs = dict(bm25.COUNTS), dict(fastpath.STATS)
    rungs.update(impact_served=impactpath.STATS["served"],
                 general=C.STATS["general_served"])
    for (b, oracle), r in zip(items, resps):
        check_page(r, oracle(ix), f"{name} body {b}", rtol)
    for body, _o in items[:1]:
        if strip_took(client.search("bench", body)) \
                != strip_took(cpu.search("bench", body)):
            raise AssertionError(f"{name}: card and CPU responses differ")
    n = len(items)
    ev_sum = sum(a.elapsed_time(e) for a, e in spans)
    ev = ev_sum / max(len(spans), 1)
    idle = (profile_batch(client, [b for b, _o in items[:4]])
            if client.device.type == "cuda" else None)
    out = {"bodies_per_s": n / wall, "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)), "counts": counts,
           "rungs": rungs, "rescore_event_ms_per_pass": ev,
           "rescore_event_ms_per_body": ev_sum / n,
           "rescore_passes": len(spans), "idle_share_one_batch": idle}
    log(f"  {name}: bodies={n} bodies/s={n / wall:.1f} p50_ms="
        f"{out['p50_ms']:.1f} p99_ms={out['p99_ms']:.1f} first phase: "
        f"B1={counts['launches']} B2={counts['impact_launches']} "
        f"B3={counts['bool_launches']} plain_calls={counts['plain_calls']} "
        f"rungs " + " ".join(f"{k}={v}" for k, v in rungs.items() if v)
        + f"; rescore passes {len(spans)}, event ms a pass (emit + gather) "
        f"{ev:.3f}, a body {ev_sum / n:.3f}; {n} pages == numpy brute "
        f"force; 2 bodies card == CPU; idle share of 4 bodies {idle}")
    return out


def phase_rescore_merged(big: dict, n: int) -> dict:
    """Phase 14's rescore classes on phase 8's merged segment (the kernels
    decline a segment with deletes): the first phase on B2 and B1 (the
    match) and on B3 (the bool), the second as torch ops."""
    client = big["client"]
    cpu = twin_of(client._indices["bench"].engine)
    out = {}
    # the b3 shapes' price-range kinds: the status kinds would build the
    # dense status filters' postings on the merged segment first (about
    # 50 s at 8.8M passages), a route phase 6 runs before the merge
    for name, items in rescore_classes(big, n, b3_kinds=(2, 3)).items():
        # within 4e-6 relative: the first phase's and the rescore query's
        # f32 sums (each within 1e-6 of the brute force), then combined
        out[name] = r = run_rescore_class(client, name, items, big["ix"],
                                          cpu)
        c = r["counts"]
        on = (c["bool_launches"] if name.startswith("a2")
              else c["launches"] + c["impact_launches"])
        if not on or c["plain_calls"] or r["rungs"]["general"] \
                or r["rungs"]["impact_served"]:
            raise AssertionError(f"{name}: the first phase is not on its "
                                 f"kernels: {r}")
    return out


def device_bytes(dev) -> int:
    """Bytes the caching allocator holds on the card (0 on the CPU)."""
    import torch
    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize(dev)
    return torch.cuda.memory_allocated(dev)


def np_explain(ix, terms, g: int) -> float:
    """A body term group's explanation value of global doc g, the way
    the reference's explain_doc sums it: Python floats, terms in query
    order, f32 idf, k1 (1 - b + b dl / avgdl) with avgdl = sum_dl /
    maxDoc."""
    avgdl = ix.sum_dl / ix.n_stats
    dl = float(ix.dl[g])
    total = 0.0
    for t in dict.fromkeys(terms):
        d, tf = ix.row(t)
        j = int(np.searchsorted(d, g))
        if j < len(d) and d[j] == g:
            w = float(ix.weight(len(d)))
            tfv = float(tf[j])
            kk = 1.2 * (1 - 0.75 + 0.75 * dl / max(avgdl, 1e-9))
            total += w * tfv / (tfv + kk)
    return total


def g_of(ix, doc_id: str) -> int:
    """The brute force's global id of a live `_id`: a corpus doc, else
    the last doc indexed under it."""
    if doc_id.isdigit() and int(doc_id) < ix.n0 and ix.live[int(doc_id)]:
        return int(doc_id)
    return ix.n0 + len(ix.new_ids) - 1 - ix.new_ids[::-1].index(doc_id)


def phase_options_msmarco(big: dict, n: int) -> dict:
    """Phase 14 on phase 7's end state (the big segment with deletes,
    the re-indexed docs' segment): count, explain, the budgets, profile
    and validate_query, the index reads; then a scroll and a point in
    time over the same segments with writes between their pages; every
    context cleared at the end. 2 bodies a class on the card against the
    CPU."""
    from opensearch_tpu_torch import ApiError
    from opensearch_tpu_torch import bench_corpus as bc
    client = big["client"]
    ix = big["ix"]
    eng = client._indices["bench"].engine
    dev = client.device
    cpu = twin_of(eng)
    df = big["corpus"][4]
    vs = bc.vocab_strings(len(df))
    queries = bc.pick_queries(df, max(n, 4))
    out: dict = {}
    t0 = time.perf_counter()

    def same_on_cpu(fn, what):
        if strip_took(fn(client)) != strip_took(fn(cpu)):
            raise AssertionError(f"{what}: card and CPU differ")

    def match_terms(i):
        return list(big["body_terms"][2 * i])

    def match_q(i):
        return {"match": {"body": " ".join(vs[t] for t in match_terms(i))}}

    # (a0) a rescored body with the first phase on the general path (the
    # kernels decline the big segment's deletes): the rescore's phase 2
    # over two segments
    body = {"query": match_q(0), "rescore": {"window_size": 16, "query": {
        "rescore_query": {"match": {"body": vs[match_terms(1)[0]]}},
        "score_mode": "total"}}}
    if not client.search("bench", body)["hits"]["hits"]:
        raise AssertionError("(a0) rescore: an empty page")
    same_on_cpu(lambda c: c.search("bench", body), "(a0) rescore")
    # (b) count: phase 5's matches and phase 6's guardrail bools
    t = time.perf_counter()
    for i in range(n):
        ts = match_terms(i)
        got = client.count("bench", {"query": match_q(i)})["count"]
        want = int((ix.group(ts)[1] & ix.live).sum())
        bbody = bc.bool_body(i, queries, vs)
        gotb = client.count("bench", bbody)["count"]
        wantb = ix.bool_page(*bool_oracle("guardrail", i, queries,
                                          ix.status, ix.price))[2]
        if (got, gotb) != (want, wantb):
            raise AssertionError(f"(b) count {i}: {got}, {gotb} != the "
                                 f"brute force {want}, {wantb}")
        if i < 2:
            same_on_cpu(lambda c: c.count("bench", bbody), "(b) count")
    out["count_s"] = time.perf_counter() - t
    log(f"  (b) count: {2 * n} bodies == the brute force's totals "
        f"({out['count_s']:.2f}s), 2 card == CPU")
    # (e) explain: explain: true on matches and bools, then the call
    t = time.perf_counter()
    worst = 0.0
    for i in range(n):
        ts = match_terms(i)
        for q in (match_q(i), {"bool": {"must": [match_q(i)], "filter": [
                {"term": {"status": "published"}}]}}):
            resp = client.search("bench", {"query": q, "explain": True})
            for h in resp["hits"]["hits"]:
                g = g_of(ix, h["_id"])
                want = np_explain(ix, ts, g)
                got = h["_explanation"]["value"]
                worst = max(worst, abs(got - want) / max(abs(want), 1e-30))
                if abs(got - want) > 1e-12 * abs(want) or not np.isclose(
                        got, h["_score"], rtol=1e-5, atol=0):
                    raise AssertionError(f"(e) explain {h['_id']}: {got} "
                                         f"vs numpy {want}, score "
                                         f"{h['_score']}")
            if i < 2:
                same_on_cpu(lambda c: c.search("bench", {
                    "query": q, "explain": True, "size": 3}), "(e) explain")
    hits = client.search("bench", {"query": match_q(0), "size": 6})
    ids = [h["_id"] for h in hits["hits"]["hits"]] + [
        str(g) for g in range(17, ix.n0, 4225) if ix.live[g]][:2]
    for doc_id in ids:
        got = client.explain("bench", doc_id, {"query": match_q(0)})
        want = np_explain(ix, match_terms(0), g_of(ix, doc_id))
        if abs(got["explanation"]["value"] - want) > 1e-12 * abs(want) \
                or got["matched"] != (want > 0):
            raise AssertionError(f"(e) explain call {doc_id}: {got} vs "
                                 f"numpy {want}")
    same_on_cpu(lambda c: c.explain("bench", ids[0], {"query": match_q(0)}),
                "(e) explain call")
    out["explain_s"] = time.perf_counter() - t
    log(f"  (e) explain: {2 * n} bodies' hits and 8 explain calls == a "
        f"numpy evaluation (largest relative difference {worst:.2e}), "
        f"scores within 1e-5 ({out['explain_s']:.2f}s)")
    # (f) terminate_after and timeout on the two-segment shard
    full = client.search("bench", {"query": match_q(1)})
    ta = client.search("bench", {"query": match_q(1), "terminate_after": 1})
    to = client.search("bench", {"query": match_q(1),
                                 "timeout": SHORT_TIMEOUT})
    long = client.search("bench", {"query": match_q(1), "timeout": "30s"})
    check_page(long, ix.page(*ix.group(match_terms(1)), 0, 10),
               "(f) timeout 30s")
    if not (ta.get("terminated_early") and ta["hits"]["total"]["relation"]
            == "gte" and to["timed_out"] and to["hits"]["total"][
                "relation"] == "gte" and not long["timed_out"]
            and strip_took(long) == strip_took(full)):
        raise AssertionError(f"(f) budgets: {ta['hits']['total']} "
                             f"{to['timed_out']} {to['hits']['total']}")
    same_on_cpu(lambda c: c.search("bench", {"query": match_q(1),
                                             "terminate_after": 1}),
                "(f) terminate_after")
    log(f"  (f) terminate_after 1: terminated_early, total "
        f"{ta['hits']['total']}; timeout {SHORT_TIMEOUT}: timed_out, total "
        f"{to['hits']['total']}, {len(to['hits']['hits'])} hits; timeout "
        f"30s == the unbounded page == the brute force")
    # (g) profile and validate_query
    prof = client.search("bench", {"query": match_q(2), "profile": True})
    root = prof["profile"]["shards"][0]["searches"][0]["query"][0]
    want_desc = f"body:{[vs[t] for t in dict.fromkeys(match_terms(2))]}"
    if (root["type"], root["description"]) != ("Terms", want_desc) or \
            root["time_in_nanos"] <= 0:
        raise AssertionError(f"(g) profile root {root}")
    verdicts = [client.validate_query("bench", b, explain=True)
                for b in ({"query": match_q(2)}, {"query": {"nope": {}}},
                          {"query": {"range": {"body": {"gte": 1}}}})]
    if [v["valid"] for v in verdicts] != [True, False, False]:
        raise AssertionError(f"(g) validate_query {verdicts}")
    same_on_cpu(lambda c: c.validate_query("bench", {"query": match_q(2)},
                                           explain=True), "(g) validate")
    log(f"  (g) profile: root {root['type']}({root['description']}) "
        f"{root['time_in_nanos']} ns, rescore_path "
        f"{prof['profile']['shards'][0]['device']['rescore_path']}; "
        f"validate_query verdicts True, False, False")
    # (h) field caps and the index reads, then a small index deleted
    caps = client.field_caps("bench")["fields"]
    want_caps = {"body": "text", "title": "text", "status": "keyword",
                 "price": "integer", "ts": "date", "rating": "double"}
    if {f: next(iter(v)) for f, v in caps.items()} != want_caps:
        raise AssertionError(f"(h) field_caps {caps}")
    got = client.indices.get("bench")["bench"]
    if got["mappings"] != client.indices.get_mapping("bench")["bench"][
            "mappings"] or set(got["mappings"]["properties"]) != set(
                want_caps) or client.indices.get_settings("bench") != {
                    "bench": {"settings": {"index": {}}}}:
        raise AssertionError(f"(h) indices.get {got}")
    same_on_cpu(lambda c: c.indices.get("bench"), "(h) indices.get")
    client.indices.create("small14", {"mappings": {"properties": {
        "body": {"type": "text"}}}})
    client.bulk(sum([[{"index": {"_index": "small14", "_id": str(i)}},
                      {"body": f"w{i % 3} w{i % 5}"}] for i in range(40)],
                    []), refresh=True)
    client.search("small14", {"query": {"match": {"body": "w1 w2"}}})
    segs = list(client._indices["small14"].engine.segments)
    held = sum(bool(s.aligned or s.device_arrays) for s in segs)
    client.indices.delete("small14")
    if not held or client.indices.exists("small14") or any(
            s.aligned or s.device_arrays for s in segs):
        raise AssertionError("(h) indices.delete left device state")
    log(f"  (h) field_caps, indices.get, get_mapping, get_settings on the "
        f"{ix.n0}-passage index; a small index's device state released by "
        f"indices.delete, exists false after")
    bytes_before = device_bytes(dev)

    # (c) scroll: a mid-df term, SCROLL_PAGES pages of SCROLL_SIZE
    order = np.argsort(np.abs(df.astype(np.int64) - 50_000))
    term = int(next(t for t in order if df[t] > SCROLL_PAGES * SCROLL_SIZE))
    want_pages = [ix.group_page([term], k * SCROLL_SIZE, SCROLL_SIZE)
                  for k in range(SCROLL_PAGES)]
    sbody = {"query": {"match": {"body": vs[term]}}, "size": SCROLL_SIZE}
    t = time.perf_counter()
    first = client.search("bench", sbody, scroll="1m")
    cfirst = cpu.search("bench", sbody, scroll="1m")
    # a doc indexed and refreshed after the first page, outside the
    # snapshot; (d)'s range holds it (it has no ts: sorted last there)
    client.index("bench", {"body": f"{vs[term]} {vs[term]}",
                           "status": "published", "price": 301},
                 id="late14", refresh=True)
    ix.add([term, term], 2, 301, "late14")
    pages, lat = [first], []
    cpages = [cfirst]
    for _k in range(1, SCROLL_PAGES):
        tb = time.perf_counter()
        pages.append(client.scroll(first["_scroll_id"], scroll="1m"))
        lat.append((time.perf_counter() - tb) * 1e3)
        cpages.append(cpu.scroll(cfirst["_scroll_id"]))
    seen: list = []
    for k, (p, cp, want) in enumerate(zip(pages, cpages, want_pages)):
        check_page(p, want, f"(c) scroll page {k}")
        if strip_took({**p, "_scroll_id": 0}) \
                != strip_took({**cp, "_scroll_id": 0}):
            raise AssertionError(f"(c) scroll page {k}: card != CPU")
        seen += [h["_id"] for h in p["hits"]["hits"]]
    if len(seen) != len(set(seen)) or "late14" in seen \
            or len(seen) != SCROLL_PAGES * SCROLL_SIZE:
        raise AssertionError("(c) scroll pages overlap, miss docs or see "
                             "the late doc")
    for c, sid in ((client, first["_scroll_id"]),
                   (cpu, cfirst["_scroll_id"])):
        c.clear_scroll(scroll_id=sid)
        try:
            c.scroll(sid)
            raise AssertionError("(c) a cleared scroll answered")
        except ApiError as e:
            if e.status != 404:
                raise
    out["scroll"] = {"df": int(df[term]), "pages": SCROLL_PAGES,
                     "size": SCROLL_SIZE,
                     "page_ms_p50": float(np.percentile(lat, 50)),
                     "page_ms_p99": float(np.percentile(lat, 99)),
                     "wall_s": time.perf_counter() - t}
    log(f"  (c) scroll: term df {int(df[term])}, {SCROLL_PAGES} pages of "
        f"{SCROLL_SIZE} == the brute force, disjoint, card == CPU; the "
        f"late doc unseen; page ms p50 {out['scroll']['page_ms_p50']:.1f} "
        f"p99 {out['scroll']['page_ms_p99']:.1f}; cleared, then 404")

    # (d) point in time: newest first over a ~10% price range, with
    # CONTEXT_WRITES re-indexed and as many deleted _ids between pages
    t = time.perf_counter()
    lo = 300      # the late doc's price, 301, is in the range
    pbody = {"query": {"range": {"price": {"gte": lo, "lt": lo + 100}}},
             "sort": [{"ts": "desc"}], "size": PIT_SIZE}
    ts0 = big["aggs"][0]
    later_ts, _r, later_has = ix.later_arrays()
    ts_all = np.concatenate([ts0, later_ts])
    has_ts = np.concatenate([np.ones(ix.n0, bool), later_has])
    n_pit = ix.n
    # a CPU twin over the same segments, the late doc's among them
    cpu = twin_of(eng)
    pid = client.create_pit("bench", keep_alive="2m")["pit_id"]
    cpid = cpu.create_pit("bench", keep_alive="2m")["pit_id"]
    snapshot = list(eng.segments)

    def pit_page(after):
        """The snapshot's page after the cursor: its docs (the first
        n_pit of the brute force) live now, in the range, by (ts desc,
        _id)."""
        m = (ix.live[:n_pit] & (ix.price[:n_pit] >= lo)
             & (ix.price[:n_pit] < lo + 100) & has_ts)
        d = np.flatnonzero(m)
        v = ts_all[d]
        if after is not None:
            d, v = d[v < after], v[v < after]
        top = d[np.argsort(-v, kind="stable")[:4 * PIT_SIZE]].tolist()
        top.sort(key=lambda g: (-int(ts_all[g]), ix.id_of(g)))
        return [ix.id_of(g) for g in top[:PIT_SIZE]]

    after = None
    pit_pages = []
    for k in range(PIT_PAGES):
        b = dict(pbody, pit={"id": pid})
        cb = dict(pbody, pit={"id": cpid})
        if after is not None:
            b["search_after"] = cb["search_after"] = [after]
        resp = client.search(body=b)
        cresp = cpu.search(body=cb)
        got = [h["_id"] for h in resp["hits"]["hits"]]
        if got != pit_page(after):
            raise AssertionError(f"(d) pit page {k}: {got} != "
                                 f"{pit_page(after)}")
        if strip_took({**resp, "pit_id": 0}) \
                != strip_took({**cresp, "pit_id": 0}):
            raise AssertionError(f"(d) pit page {k}: card != CPU")
        pit_pages.append(got)
        after = resp["hits"]["hits"][-1]["sort"][0]
        if k == 0:
            # the next pages' leading hits and random others: half
            # re-indexed (their new versions outside the snapshot), half
            # deleted; the deletes flip the snapshot's live masks
            nxt = [int(x) for x in pit_page(after)[:16]]
            wrng = np.random.default_rng(141)
            pool = np.flatnonzero(ix.live[:ix.n0])
            pool = pool[~np.isin(pool, nxt)]
            others = wrng.choice(pool, 2 * CONTEXT_WRITES - len(nxt),
                                 replace=False).tolist()
            chosen = nxt + others
            reidx = sorted(chosen[0::2][:CONTEXT_WRITES])
            dels = sorted(chosen[1::2][:CONTEXT_WRITES])
            docs = []
            for j, old in enumerate(reidx):
                terms = [int(x) for x in queries[j % len(queries)][:2]]
                docs.append((old, terms, j % 3, 900 + j % 50))
            client.bulk(sum([[{"index": {"_index": "bench",
                                         "_id": str(old)}},
                              {"body": " ".join(vs[x] for x in terms),
                               "status": bc.STATUS_VALUES[st],
                               "price": pr}]
                             for old, terms, st, pr in docs], [])
                        + [{"delete": {"_index": "bench", "_id": str(d)}}
                           for d in dels], refresh=True)
            ix.reindex(docs)
            ix.live[dels] = False
    log(f"  (d) point in time: {PIT_PAGES} pages of {PIT_SIZE} newest "
        f"first over a 10% price range == the brute force of the "
        f"snapshot (the re-indexed versions unseen, the {CONTEXT_WRITES} "
        f"deletes seen), card == CPU ({time.perf_counter() - t:.2f}s)")
    # the deferred release: the late doc's segment, which the point in
    # time holds, merges with the re-indexed versions' segment
    late_seg = next(s for s in eng.segments if s.local_doc("late14") >= 0)
    new_seg = eng.segments[-1]
    if late_seg not in snapshot or new_seg in snapshot:
        raise AssertionError("(d) unexpected segment layout")
    eng.force_merge_group([late_seg, new_seg])
    resp = client.search(body=dict(pbody, pit={"id": pid}))
    if [h["_id"] for h in resp["hits"]["hits"]] != pit_page(None):
        raise AssertionError("(d) pit page after the merge differs")
    kept = bool(late_seg.aligned or late_seg.device_arrays)
    released_new = not (new_seg.aligned or new_seg.device_arrays)
    client.delete_pit({"pit_id": [pid]})
    cpu.delete_pit({"pit_id": [cpid]})
    if not (kept and released_new and late_seg.holders == 0
            and not late_seg.device_arrays and not late_seg.aligned):
        raise AssertionError("(d) the held segment's device state was not "
                             "kept until delete_pit, then released")
    try:
        client.search(body=dict(pbody, pit={"id": pid}))
        raise AssertionError("(d) a deleted point in time answered")
    except ApiError as e:
        if e.status != 404:
            raise
    held = [s.name for s in eng.segments + snapshot if s.holders]
    bytes_after = device_bytes(dev)
    if held or client._scrolls or client._pits:
        raise AssertionError(f"contexts left before phase 8: {held}")
    out["pit"] = {"pages": PIT_PAGES, "size": PIT_SIZE,
                  "reindexed": CONTEXT_WRITES, "deleted": CONTEXT_WRITES,
                  "wall_s": time.perf_counter() - t}
    out["device_bytes"] = {"before_contexts": bytes_before,
                           "after_contexts_cleared": bytes_after}
    log(f"  (d) a merge of the held segment deferred its release until "
        f"delete_pit, then released it; every context cleared; device "
        f"bytes before the contexts {bytes_before}, after {bytes_after}; "
        f"segments (name, ndocs, live) "
        f"{[(s.name, s.ndocs, s.live_count) for s in eng.segments]}")
    out["wall_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------
# phase 8: deletes, updates and a forced merge at MS MARCO passage scale
# ---------------------------------------------------------------------

DELETE_SHARE = 100     # 1 in 100 of the big segment's _ids is deleted
MERGE_FIRST = 8        # phase 8's match bodies before the merge (16 before
#                        phase 17), and first after it
BULK_ITEMS = 1000      # items per bulk request


def bulk_checked(client, lines, action: str, want: dict) -> None:
    """One bulk request whose every item must be `action` with a result
    and status in `want` ({result: status})."""
    r = client.bulk(lines)
    for it in r["items"]:
        got = it.get(action, {})
        if want.get(got.get("result")) != got.get("status"):
            raise AssertionError(f"bulk {action} item: {it}")


def run_write_class(client, name: str, items, ix, cpu, rtol=1e-6,
                    memo=None) -> dict:
    """One class of bodies through msearch (counts and rungs set to 0
    just before), every page against the brute force (kept in `memo` by
    item index, when given, for a class of the same pages), one body on
    the card against `cpu` (2 before phase 16 shared the time limit): -> the class's numbers."""
    from opensearch_tpu_torch.search import compiler as C
    from opensearch_tpu_torch.search import impactpath
    bodies = [b for b, _o in items]
    impactpath.reset_stats()
    C.reset_stats()
    resps, wall, lat, counts, rungs = run_batches(client, bodies)
    rungs = {**rungs, "impact_served": impactpath.STATS["served"],
             "general": C.STATS["general_served"]}
    t0 = time.perf_counter()
    memo = {} if memo is None else memo
    for j, ((b, oracle), r) in enumerate(zip(items, resps)):
        if j not in memo:
            memo[j] = oracle(ix)
        check_page(r, memo[j], f"{name} body {b}", rtol)
    t_oracle = time.perf_counter() - t0
    lines = sum([[{}, b] for b in bodies[:1]], [])
    t0 = time.perf_counter()
    if strip_took(client.msearch(lines, index="bench")) \
            != strip_took(cpu.msearch(lines, index="bench")):
        raise AssertionError(f"{name}: 1 body: card and CPU responses "
                             f"differ")
    t_cpu = time.perf_counter() - t0
    n = len(bodies)
    rels = Counter(r["hits"]["total"]["relation"] for r in resps)
    log(f"  {name}: queries={n} batch={BATCH} wall_s={wall:.2f} "
        f"qps={n / wall:.1f} batch_ms_p50={np.percentile(lat, 50):.1f} "
        f"batch_ms_p99={np.percentile(lat, 99):.1f} "
        f"{after_first(n, wall, lat)}kernel launches "
        f"B1={counts['launches']} B2={counts['impact_launches']} "
        f"B3={counts['bool_launches']} plain_calls={counts['plain_calls']}"
        f" rungs " + " ".join(f"{k}={v}" for k, v in rungs.items() if v)
        + f" relations={dict(rels)}; {n} pages == numpy brute force "
        f"({t_oracle:.1f}s); 1 body card == CPU ({t_cpu:.1f}s)")
    out = {"qps": n / wall, "p50": float(np.percentile(lat, 50)),
           "p99": float(np.percentile(lat, 99)), "batch_ms": lat,
           "counts": counts, "rungs": rungs}
    if len(lat) > 1:
        out["qps_after_first_batch"] = (n - BATCH) / (wall - lat[0] / 1e3)
    return out


def phase_writes_msmarco(big: dict, rng) -> dict:
    """Phase 7's end state (the big segment with phase 7's re-indexed
    _ids deleted, and their new versions in a small segment): bulk-delete
    1% of the big segment's _ids, bulk-update the re-indexed _ids (a
    partial doc: new status and price) and upsert as many new _ids,
    refresh; phase 5's match bodies on that state (the impact rung); then
    forcemerge into one segment and, on it, phase 5's match bodies
    pruned, the same with exact totals and the b3 mix's price-range
    bodies, each class on its kernel. Every page against the numpy brute force with the writes
    applied, 2 bodies a class on the card against the CPU."""
    import torch
    from opensearch_tpu_torch import RestClient
    from opensearch_tpu_torch import bench_corpus as bc
    from opensearch_tpu_torch.index import merge as M
    from opensearch_tpu_torch.ops import device_merge
    from opensearch_tpu_torch.search import fastpath

    client, seg, ix = big["client"], big["seg"], big["ix"]
    dev = client.device
    eng = client._indices["bench"].engine
    # the reference would run its BP doc-id reorder on this merge, which
    # the port refuses (NotPortedError "BP reorder"); with the reorder
    # off, as its own switch sets it, both merge in concatenation order
    os.environ["OPENSEARCH_TPU_REORDER"] = "0"
    log("  OPENSEARCH_TPU_REORDER=0: the merge runs as the reference's "
        "does with its BP reorder off (not ported: with it on, a merge "
        "of 32,768 docs or more raises)")
    df = big["corpus"][4]
    vs = bc.vocab_strings(len(df))
    reidx = big["reindexed"]
    nq = len(reidx)

    def twin():
        cpu = RestClient(device="cpu")
        cpu.indices.create("bench", BENCH_MAPPING)
        cpu._indices["bench"].engine.segments = list(eng.segments)
        return cpu

    # 1. bulk-delete 1% of the big segment's _ids (not the re-indexed ones)
    n_del = seg.ndocs // DELETE_SHARE
    cand = np.flatnonzero(seg.live)
    # nothing here holds the corpus segment past the merge: its vector
    # column (27 GB of host memory at 8.8M passages) goes with it
    del seg
    big.pop("seg")
    dels = rng.choice(cand, n_del, replace=False)
    t0 = time.perf_counter()
    for i in range(0, n_del, BULK_ITEMS):
        bulk_checked(client, [{"delete": {"_index": "bench", "_id": str(d)}}
                              for d in dels[i:i + BULK_ITEMS]], "delete",
                     {"deleted": 200})
    t_del = time.perf_counter() - t0
    ix.live[dels] = False
    # 2. update the re-indexed _ids (their versions are ix's first added
    # docs), upsert as many new ones
    lines = []
    adds = []
    for j, (old, terms, _st, _pr, cols) in enumerate(reidx):
        st, pr = (j + 1) % 3, (7 * j) % 1000
        lines += [{"update": {"_index": "bench", "_id": str(old)}},
                  {"doc": {"status": bc.STATUS_VALUES[st], "price": pr}}]
        ix.live[ix.n0 + j] = False
        # a partial update keeps the source's ts and rating
        adds.append((terms, st, pr, str(old), cols))
    up_terms = big["body_terms"][nq:2 * nq]
    for j, terms in enumerate(up_terms):
        st, pr = j % 3, (13 * j) % 1000
        lines += [{"update": {"_index": "bench", "_id": f"new{j}"}},
                  {"doc": {"body": " ".join(vs[int(t)] for t in terms),
                           "status": bc.STATUS_VALUES[st], "price": pr},
                   "doc_as_upsert": True}]
        adds.append((list(terms), st, pr, f"new{j}"))
    t0 = time.perf_counter()
    bulk_checked(client, lines, "update", {"updated": 200, "created": 200})
    t_upd = time.perf_counter() - t0
    for a in adds:
        ix.add(*a)
    # 3. refresh: the re-indexed versions' segment, now all deleted,
    # merges away alone
    t0 = time.perf_counter()
    client.indices.refresh("bench")
    t_refresh = time.perf_counter() - t0
    ix.compact(slice(ix.n0, ix.n0 + len(reidx)))
    layout = [(s.name, s.ndocs, s.live_count) for s in eng.segments]
    log(f"  bulk-deleted {n_del} _ids in {-(-n_del // BULK_ITEMS)} "
        f"requests of "
        f"{BULK_ITEMS} ({t_del:.2f}s); updated {len(reidx)} and upserted "
        f"{len(up_terms)} _ids in one bulk ({t_upd:.2f}s); refresh "
        f"{t_refresh:.2f}s; segments (name, ndocs, live) {layout}")
    if sum(s.live_count for s in eng.segments) != int(ix.live.sum()):
        raise AssertionError("live docs != the brute force's after the "
                             "writes")
    out: dict = {"deleted": n_del, "updated": len(reidx),
                 "upserted": len(up_terms), "delete_s": t_del,
                 "update_s": t_upd, "refresh_s": t_refresh}

    def match_items(n):
        return [(big["bodies"][j], (lambda ts: lambda ix_: ix_.page(
            *ix_.group(ts), 0, 10))(list(big["body_terms"][j])))
            for j in range(n)]

    # 4. phase 5's match bodies on the segments with deletes
    out["before_merge"] = run_write_class(client, "match, deletes",
                                          match_items(MERGE_FIRST), ix,
                                          twin())

    # 5. forcemerge
    spans = []
    real_sort = device_merge.merge_sorted_runs

    def timed_sort(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        got = real_sort(*a, **kw)
        e1.record()
        spans.append((e0, e1))
        return got
    torch.cuda.synchronize()
    bytes_before = torch.cuda.memory_allocated(dev)
    # host memory for the merge's copies (the new vector column is as
    # large as the old): the replaced segments' caches, on the card and
    # the host, go now, not at their retirement after the merge
    for s in eng.segments:
        s.release_device()
    trim_host()
    rss_before = rss_bytes()[0]
    torch.cuda.reset_peak_memory_stats(dev)
    device_merge.merge_sorted_runs = timed_sort
    t0 = time.perf_counter()
    try:
        with RssPeak() as merge_rss:
            client.indices.forcemerge("bench", max_num_segments=1)
    finally:
        device_merge.merge_sorted_runs = real_sort
    torch.cuda.synchronize()
    t_merge = time.perf_counter() - t0
    bytes_after = torch.cuda.memory_allocated(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    (merged,) = eng.segments
    big["seg"] = merged
    gc.collect()
    t0 = time.perf_counter()
    fastpath.get_aligned(merged, "body", dev)
    torch.cuda.synchronize()
    t_align = time.perf_counter() - t0
    bytes_aligned = torch.cuda.memory_allocated(dev)
    sort_ms = sum(a.elapsed_time(b) for a, b in spans)
    ix.compact()
    split = dict(M.LAST_MERGE, sort_event_ms=sort_ms, aligned_heads_s=t_align,
                 merge_wall_s=t_merge)
    log(f"  forcemerge: {merged.ndocs} docs, {merged.postings['body'].size}"
        f" body postings; wall {t_merge:.2f}s = host concat "
        f"{split['host_concat_s']:.2f}s + sort {split['sort_s']:.2f}s "
        f"(merge_sorted_runs event ms {sort_ms:.1f}, {len(spans)} calls) + "
        f"title positions {split['positions_s']:.2f}s "
        f"({len(merged.postings['title'].positions)} positions) + "
        f"quantize {split['quantize_s']:.2f}s + vectors "
        f"{split['vectors_s']:.2f}s; then aligned layout + heads "
        f"{t_align:.2f}s")
    log(f"  device bytes: before the merge {bytes_before}, after it "
        f"{bytes_after} (the replaced segments' state released just before "
        f"it), "
        f"with the merged segment's aligned layout {bytes_aligned}; peak "
        f"during the merge {peak}; host RSS before the merge {rss_before}, "
        f"its peak during the merge {merge_rss.peak}, now / the process's "
        f"peak {rss_bytes()}")
    live = int(ix.live.sum())
    if not merged.ndocs == merged.live_count == live:
        raise AssertionError(f"merged segment: ndocs {merged.ndocs} live "
                             f"{merged.live_count}, the brute force {live}")
    # a sample of rows against a numpy merge of the same rows
    pb = merged.postings["body"]
    rank = np.cumsum(ix.live) - 1
    srng = np.random.default_rng(19)
    rows = srng.choice(len(df), 1000, replace=False)
    n_post = 0
    for t in rows:
        d, tf = ix.row(int(t))
        r = pb.row(vs[int(t)])
        a, b = pb.row_slice(r) if r >= 0 else (0, 0)
        if not (np.array_equal(pb.doc_ids[a:b], rank[d])
                and np.array_equal(pb.tfs[a:b], tf)):
            raise AssertionError(f"merged row {vs[int(t)]} != numpy merge")
        n_post += b - a
    log(f"  merged segment: ndocs == live == {live} (the brute force's); "
        f"1000 sampled rows ({n_post} postings) == a numpy merge")
    out.update(merge=split, rss_before_merge=rss_before,
               rss_peak_merge=merge_rss.peak,
               device_bytes_before=bytes_before,
               device_bytes_after=bytes_after,
               device_bytes_with_aligned=bytes_aligned, device_peak=peak,
               sampled_rows=1000, sampled_postings=n_post)

    # 6. on the merged segment: the kernels serve. First the bodies of
    # step 4 in one batch (their first use builds the merged segment's
    # lazy per-row state, row by row), then the same bodies pruned and
    # with exact totals (128 pruned before phase 13 shared the time
    # limit, 64 before phase 15 did, 32 before phase 17 did)
    cpu = twin()
    items = match_items(min(MERGE_FIRST, len(big["bodies"])))
    pages: dict = {}
    out["first_use"] = run_write_class(
        client, f"match, merged, the {MERGE_FIRST} bodies of the segments "
        f"with deletes", items[:MERGE_FIRST], ix, cpu, memo=pages)
    out["pruned"] = run_write_class(client, "match, merged, pruned", items,
                                    ix, cpu, memo=pages)
    out["dense"] = run_write_class(
        client, "match, merged, track_total_hits",
        [(dict(b, track_total_hits=True), o) for b, o in items], ix, cpu,
        memo=pages)
    # the b3 mix's price-range kinds (i % 4 in (2, 3): the filter as a
    # slot or a probe); its status kinds would build the dense status
    # filters' postings on the merged segment first (about 50 s at 8.8M
    # passages), a route phase 6 runs before the merge
    queries = bc.pick_queries(df, 64)
    b3 = [(bc.b3_body(i, queries, vs), (lambda i_: lambda ix_: ix_.bool_page(
        *bool_oracle("b3", i_, queries, ix_.status, ix_.price)))(i))
        for i in range(64) if i % 4 in (2, 3)]
    # B3 sums in slot order; phase 6's tolerance for three slots
    out["b3"] = run_write_class(client, "b3 mix, merged", b3, ix, cpu,
                                rtol=9 * 2.0**-23)
    # phrases: positions survived the deletes and the merge
    title = big["title"]
    tvs = bc.title_vocab_strings(len(title[0]) - 1)
    pairs = bc.pick_phrase_pairs(title[7], 16)
    out["phrase"] = run_write_class(
        client, "config-3 phrases, merged",
        [(bc.phrase_body(i, pairs, title),
          (lambda ts: lambda ix_: ix_.phrase_page(ts))(
              [tvs[title[5][pairs[i]]], tvs[title[6][pairs[i]]]]))
         for i in range(16)], ix, cpu)
    r = out["phrase"]
    if r["rungs"]["general"] != 16 or any(
            r["counts"][k] for k in ("launches", "impact_launches",
                                     "bool_launches", "plain_calls")):
        raise AssertionError(f"merged segment, phrases: not served by the "
                             f"general path alone: {r}")
    # size-0 analytics bodies: the status keyword column, ts and rating
    # went through the deletes and the merge
    classes = agg_classes(big, 2, 0)
    out["aggs"] = run_agg_class(
        client, "aggs (a) and (b), merged",
        classes["a_terms_stats"] + classes["b_month_date_hist"],
        AggOracle(ix, big["aggs"]), cpu, 2)
    for name, key in (("first_use", "impact_launches"),
                      ("pruned", "impact_launches"), ("dense", "launches"),
                      ("b3", "bool_launches")):
        c, r = out[name]["counts"], out[name]["rungs"]
        if c[key] == 0 or c["plain_calls"] or r["impact_served"] \
                or r["general"]:
            raise AssertionError(f"merged segment, {name}: not served by "
                                 f"its kernel alone: {c} {r}")
    return out


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


# ---------------------------------------------------------------------
# phase 15: the long-tail aggregations (a composite export, a
# time-series panel with pipelines, top hits, groupings, metrics,
# significance and the samplers) at MS MARCO passage scale
# ---------------------------------------------------------------------

LT_PAGE = 500          # composite buckets a page in class (a)
LT_OP_BODIES = 2       # bodies a class timed op by op
LT_MONTH = {"field": "ts", "calendar_interval": "month"}
# matrix_stats against the f64 brute force: the power sums are f32 over
# millions of docs (centred about the index-wide mean), so the moments
# carry their rounding: relative for the mean, variance and covariance,
# absolute for the correlation, skewness and kurtosis
LT_MS_TOL = {"mean": 1e-5, "variance": 1e-3, "covariance": 1e-3,
             "correlation": 1e-3, "skewness": 1e-2, "kurtosis": 1e-2}


def lt_query(i: int) -> dict:
    """Query i of the classes AggOracle matches: match_all, then price
    ranges 500 wide."""
    if i == 0:
        return {"match_all": {}}
    lo = 250 * ((i - 1) % 3)
    return {"range": {"price": {"gte": lo, "lt": lo + 500}}}


def rare_term(ix) -> tuple:
    """A body term whose live docs hold at least two distinct nonzero
    counts of the statuses: (term, its smallest count)."""
    df = np.diff(ix.starts)
    for t in np.flatnonzero((df >= 6) & (df <= 60)).tolist():
        d, _tf = ix.row(t)
        c = np.bincount(ix.status[d[ix.live[d]]], minlength=3)
        nz = sorted(set(c[c > 0].tolist()))
        if len(nz) >= 2:
            return t, nz[0]
    raise AssertionError("no body term for rare_terms")


def longtail_classes(big: dict, n: int) -> dict:
    """Phase 15's bodies: class -> [(body, its match terms or None)], `n`
    a class."""
    from opensearch_tpu_torch import bench_corpus as bc
    vs = bc.vocab_strings(len(big["corpus"][4]))

    def match(i):
        ts = list(big["body_terms"][2 * i])
        return {"match": {"body": " ".join(vs[t] for t in ts)}}, ts

    rt, rmax = rare_term(big["ix"])
    composite = {"size": LT_PAGE, "sources": [
        {"status": {"terms": {"field": "status"}}},
        {"day": {"date_histogram": {"field": "ts",
                                    "calendar_interval": "day"}}}]}
    panel = {"date_histogram": LT_MONTH, "aggs": {
        "s": {"sum": {"field": "price"}},
        "d": {"derivative": {"buckets_path": "s"}},
        "c": {"cumulative_sum": {"buckets_path": "s"}},
        "mf": {"moving_fn": {"buckets_path": "s", "window": 3, "script":
                             "MovingFunctions.unweightedAvg(values)"}},
        "sd": {"serial_diff": {"buckets_path": "s", "lag": 1}},
        "ab": {"avg_bucket": {"buckets_path": "s"}},
        "mx": {"max_bucket": {"buckets_path": "s"}},
        "sb": {"stats_bucket": {"buckets_path": "s"}},
        "pb": {"percentiles_bucket": {"buckets_path": "s",
                                      "percents": [50.0, 90.0]}},
        "top": {"bucket_sort": {"sort": [{"s": {"order": "desc"}}],
                                "size": 5}}}}
    metrics = {
        "w": {"weighted_avg": {"value": {"field": "rating"},
                               "weight": {"field": "price"}}},
        "m": {"median_absolute_deviation": {"field": "rating"}},
        "x": {"matrix_stats": {"fields": ["price", "rating"]}},
        "h": {"auto_date_histogram": {"field": "ts", "buckets": 12},
              "aggs": {"a": {"avg": {"field": "rating"}}}}}
    adjacency = {"adjacency_matrix": {"filters": {
        "published": {"term": {"status": "published"}},
        "cheap": {"range": {"price": {"lt": 100}}},
        "rated": {"range": {"rating": {"gt": 5}}}}}}

    def top_hits(i):
        if i % 2 == 0:
            return ({"size": 0, "query": lt_query(1 + i // 2), "aggs": {
                "st": {"terms": {"field": "status"}, "aggs": {
                    "th": {"top_hits": {
                        "size": 3, "sort": [{"price": {"order": "desc"}}],
                        "_source": {"includes": ["doc", "price"]}}}}}}},
                None)
        q, ts = match(i)
        return ({"size": 0, "query": q, "aggs": {"th": {"top_hits": {
            "size": 5, "_source": {"includes": ["doc"]}}}}}, ts)

    def grouping(i):
        if i % 4 in (0, 1):
            return ({"size": 0, "query": lt_query(i % 4), "aggs": {
                "mt": {"multi_terms": {"terms": [{"field": "status"},
                                                 {"field": "price"}],
                                       "size": 10}}}}, None)
        if i % 4 == 2:
            return ({"size": 0, "query": {"match": {"body": vs[rt]}},
                     "aggs": {"r": {"rare_terms": {
                         "field": "status", "max_doc_count": rmax}}}}, [rt])
        return {"size": 0, "query": {"match_all": {}},
                "aggs": {"adj": adjacency}}, None

    def samplers(i):
        q, ts = match(i)
        return ({"size": 0, "query": q, "aggs": {
            "sig": {"significant_terms": {"field": "status"}},
            "s": {"sampler": {"shard_size": 200}, "aggs": {
                "t": {"significant_text": {"field": "title"}}}},
            "d": {"diversified_sampler": {"field": "status",
                                          "max_docs_per_value": 50},
                  "aggs": {"a": {"avg": {"field": "price"}}}}}}, ts)

    return {
        "a_composite_export": [
            ({"size": 0, "query": lt_query(i), "aggs": {
                "c": {"composite": composite}}}, None) for i in range(n)],
        "b_time_series_panel": [
            ({"size": 0, "query": lt_query(i), "aggs": {"m": panel}}, None)
            for i in range(n)],
        "c_top_hits": [top_hits(i) for i in range(n)],
        "d_groupings": [grouping(i) for i in range(n)],
        "e_metrics": [({"size": 0, "query": lt_query(i), "aggs": metrics},
                       None) for i in range(n)],
        "f_significance_samplers": [samplers(i) for i in range(n)]}


class LongtailOracle(AggOracle):
    """Phase 15's numpy brute force: AggOracle's columns and matches, the
    match bodies' BM25 from NumpyIndex, and the segments of phase 7's
    end state as global id ranges (the corpus segment, phase 7's
    re-indexed docs', then the later docs')."""

    def __init__(self, ix, aggcols, title):
        super().__init__(ix, aggcols)
        self.title = title

    def segments(self) -> list:
        ix = self.ix
        return [(0, ix.n0), (ix.n0, ix.n0 + REINDEXED),
                (ix.n0 + REINDEXED, ix.n)]

    def months(self, c: dict) -> np.ndarray:
        """i64 months since 1970-01 of every doc's ts (0 without one),
        computed once for the docs indexed so far."""
        if getattr(self, "_months", (None, 0))[1] != len(c["ts"]):
            self._months = ((c["ts"] // DAY_MS).astype("datetime64[D]")
                            .astype("datetime64[M]").astype(np.int64),
                            len(c["ts"]))
        return self._months[0]

    def matched(self, body: dict, terms, c: dict) -> tuple:
        """(live matched docs, BM25 scores or None) of a phase-15 query."""
        if terms is None:
            return self.match(body, c), None
        score, ok = self.ix.group(terms)
        return ok & c["live"], score


def lt_bound_close(got, exact: float, bound: float, what: str) -> None:
    if got is None or abs(float(got) - exact) > bound + 1e-9 * abs(exact):
        raise AssertionError(f"{what}: {got} vs exact {exact} (bound "
                             f"{bound})")


def lt_check_composite(pages: list, m, c, what: str) -> None:
    """The pages of one composite chain: together the (status, day)
    groups of the matched docs with a ts, in order, each once; each page
    LT_PAGE buckets but the last, its after_key its last key."""
    from opensearch_tpu_torch import bench_corpus as bc
    mt = m & c["ts_present"]
    day = c["ts"][mt] // DAY_MS
    d0 = int(day.min()) if len(day) else 0
    nd = int(day.max()) - d0 + 1 if len(day) else 1
    counts = np.bincount(c["status"][mt].astype(np.int64) * nd + day - d0,
                         minlength=3 * nd)
    want = [(bc.STATUS_VALUES[u // nd], (d0 + u % nd) * DAY_MS,
             int(counts[u])) for u in np.flatnonzero(counts).tolist()]
    got = []
    for k, p in enumerate(pages):
        agg = p["aggregations"]["c"]
        bs = agg["buckets"]
        if (len(bs) != LT_PAGE and k != len(pages) - 1) or (
                bs and agg["after_key"] != bs[-1]["key"]):
            raise AssertionError(f"{what}: page {k} of {len(bs)} buckets")
        got += [(b["key"]["status"], b["key"]["day"], b["doc_count"])
                for b in bs]
    if got != want:
        raise AssertionError(f"{what}: {len(got)} composite buckets != the "
                             f"{len(want)} groups")


def lt_check_panel(resp: dict, m, c, oracle, sums: SumCheck,
                   what: str) -> None:
    """The monthly sums and every pipeline over them against exact f64
    sums, each within the f32 bound of the sums it is made of."""
    mt = m & c["ts_present"]
    months = oracle.months(c)[mt]
    pr = c["price"][mt]
    m0 = int(months.min())
    per = np.bincount(months - m0)
    uniq = m0 + np.flatnonzero(per)
    inv = (np.cumsum(per > 0) - 1)[months - m0]
    s = [float(pr[inv == j].astype(np.float64).sum())
         for j in range(len(uniq))]
    bnd = [sum_bound(pr[inv == j]) for j in range(len(uniq))]
    cnt = np.bincount(inv, minlength=len(uniq))
    keys = [int(np.datetime64(u, "M").astype("datetime64[ms]").astype(
        np.int64)) for u in uniq.tolist()]
    agg = resp["aggregations"]["m"]
    order = sorted(range(len(s)), key=lambda j: -s[j])[:5]
    got = agg["buckets"]
    if len(got) != len(order):
        raise AssertionError(f"{what}: {len(got)} buckets after bucket_sort")
    for b, j in zip(got, order):
        if b["key"] != keys[j]:
            # a swap only between sums within their bounds
            jj = keys.index(b["key"])
            if abs(s[jj] - s[j]) > bnd[jj] + bnd[j]:
                raise AssertionError(f"{what}: bucket_sort order")
            j = jj
        if b["doc_count"] != int(cnt[j]):
            raise AssertionError(f"{what}: month {keys[j]} count")
        sums(b["s"]["value"], pr[inv == j], f"{what} sum")
        prev = (s[j - 1], bnd[j - 1]) if j else None
        for name in ("d", "sd"):
            if prev is None:
                if b[name]["value"] is not None:
                    raise AssertionError(f"{what}: {name} of the first month")
            else:
                lt_bound_close(b[name]["value"], s[j] - prev[0],
                               bnd[j] + prev[1], f"{what} {name}")
        lt_bound_close(b["c"]["value"], sum(s[:j + 1]), sum(bnd[:j + 1]),
                       f"{what} cumulative_sum")
        win = range(max(0, j - 3), j)
        if not win:
            if b["mf"]["value"] is not None:
                raise AssertionError(f"{what}: moving_fn of no window")
        else:
            lt_bound_close(b["mf"]["value"], sum(s[k] for k in win) / len(win),
                           sum(bnd[k] for k in win) / len(win),
                           f"{what} moving_fn")
    top = max(bnd)
    lt_bound_close(agg["ab"]["value"], sum(s) / len(s), sum(bnd) / len(s),
                   f"{what} avg_bucket")
    lt_bound_close(agg["mx"]["value"], max(s), 2 * top, f"{what} max_bucket")
    sb = agg["sb"]
    if sb["count"] != len(s):
        raise AssertionError(f"{what}: stats_bucket count")
    lt_bound_close(sb["sum"], sum(s), sum(bnd), f"{what} stats_bucket sum")
    lt_bound_close(sb["min"], min(s), 2 * top, f"{what} stats_bucket min")
    srt = sorted(s)
    for pc in (50.0, 90.0):
        idx = min(int(round(pc / 100.0 * len(srt) + 0.5)) - 1, len(srt) - 1)
        lt_bound_close(agg["pb"]["values"][f"{pc:.1f}"], srt[max(idx, 0)],
                       2 * top, f"{what} percentiles_bucket")


def lt_source(oracle, g: int, includes) -> dict:
    """A hit's `_source` filtered to `includes`: a corpus doc's is {"doc":
    g} (and its title), a later doc's its indexed fields."""
    ix = oracle.ix
    if g < ix.n0:
        src = {"doc": g}
    else:
        src = {"price": int(ix.price[g])}
    return {k: v for k, v in src.items() if k in includes}


def lt_check_top_hits(resp: dict, body: dict, m, score, oracle, c,
                      what: str) -> None:
    """terms(status) > top_hits: the statuses' counts, and in each bucket
    its sub-search's first 3 candidates (a range scores every doc 1.0,
    so the first docs in segment order), their `_source` filtered; a
    root top_hits under a match: the page of the best 5 by score."""
    ix = oracle.ix
    aggs = resp["aggregations"]
    if "st" in aggs:
        check_terms(aggs["st"], c["status"][m], {}, what)
        for b in aggs["st"]["buckets"]:
            from opensearch_tpu_torch import bench_corpus as bc
            o = bc.STATUS_VALUES.index(b["key"])
            docs = np.flatnonzero(m & (c["status"] == o))
            th = b["th"]["hits"]
            got = [(h["_id"], h["_source"], h["_score"]) for h in th["hits"]]
            want = [(ix.id_of(int(g)), lt_source(oracle, int(g),
                                                 ("doc", "price")), 1.0)
                    for g in docs[:3]]
            if got != want or th["total"]["value"] != len(docs):
                raise AssertionError(f"{what}: {b['key']} top_hits {got} != "
                                     f"{want}")
        return
    th = aggs["th"]["hits"]
    ids, scores, _total = ix.page(score, m, 0, 5)
    check_page({"hits": {"hits": th["hits"], "total": {
        "value": int(m.sum()), "relation": "eq"}}},
        (ids, scores, int(m.sum())), f"{what} root top_hits")
    docs = np.flatnonzero(m)
    g_of = {ix.id_of(int(g)): int(g)
            for g in docs[np.lexsort((docs, -score[docs]))][:10]}
    if any(h["_source"] != lt_source(oracle, g_of[h["_id"]], ("doc",))
           for h in th["hits"]):
        raise AssertionError(f"{what}: root top_hits _source")


def lt_check_groupings(resp: dict, body: dict, m, c, what: str) -> None:
    from opensearch_tpu_torch import bench_corpus as bc
    aggs = resp["aggregations"]
    if "mt" in aggs:
        code = c["status"][m].astype(np.int64) * 1000 + c["price"][m].astype(
            np.int64)
        counts = np.bincount(code, minlength=3000)
        uniq = np.flatnonzero(counts)
        items = sorted(zip(uniq.tolist(), counts[uniq].tolist()),
                       key=lambda kv: (-kv[1], kv[0]))
        want = [([bc.STATUS_VALUES[u // 1000], u % 1000], k)
                for u, k in items[:10]]
        got = [(b["key"], b["doc_count"]) for b in aggs["mt"]["buckets"]]
        other = int(m.sum()) - sum(k for _u, k in want)
        if got != want or aggs["mt"]["sum_other_doc_count"] != other or any(
                b["key_as_string"] != f"{b['key'][0]}|{b['key'][1]}"
                for b in aggs["mt"]["buckets"]):
            raise AssertionError(f"{what}: multi_terms {got} != {want}")
    if "r" in aggs:
        mx = body["aggs"]["r"]["rare_terms"]["max_doc_count"]
        cnt = np.bincount(c["status"][m], minlength=3)
        want = sorted(((int(k), bc.STATUS_VALUES[o]) for o, k in
                       enumerate(cnt) if 0 < k <= mx))
        got = [(b["doc_count"], b["key"]) for b in aggs["r"]["buckets"]]
        if got != want or not want or len(want) == int((cnt > 0).sum()):
            raise AssertionError(f"{what}: rare_terms {got} != {want} "
                                 f"(counts {cnt}, max {mx})")
    if "adj" in aggs:
        masks = {"cheap": m & (c["price"] < 100),
                 "published": m & (c["status"] == 2),
                 "rated": m & c["rating_present"]
                 & (c["rating"] > np.float32(5.0))}
        keys = sorted(masks)
        want = [(k, int(masks[k].sum())) for k in keys]
        want += [(f"{a}&{b}", int((masks[a] & masks[b]).sum()))
                 for i, a in enumerate(keys) for b in keys[i + 1:]]
        want = sorted((k, v) for k, v in want if v > 0)
        got = [(b["key"], b["doc_count"]) for b in aggs["adj"]["buckets"]]
        if got != want:
            raise AssertionError(f"{what}: adjacency {got} != {want}")


def lt_auto_keys(oracle, c, target: int) -> tuple:
    """auto_date_histogram's segment rungs: each segment's ladder interval
    over its own ts span (its deleted docs in it), each doc's key at its
    segment's interval rounded down to the widest of them: (that
    interval, i64 key of every doc), once per oracle state."""
    from opensearch_tpu_torch.search import aggregations as A
    memo = getattr(oracle, "_auto_keys", None)
    if memo is not None and memo[0] == (target, len(c["ts"])):
        return memo[1]
    ladder = [ms for ms, _n in A.AUTO_LADDER]
    ivs = []
    for lo, hi in oracle.segments():
        has = c["ts_present"][lo:hi]
        span = (float(c["ts"][lo:hi][has].max() - c["ts"][lo:hi][has].min())
                if has.any() else None)
        ivs.append(ladder[0] if span is None else next(
            (ms for ms in ladder if max(span, 1.0) / ms <= target),
            ladder[-1]))
    interval = max(ivs)
    keys = np.zeros(len(c["ts"]), np.int64)
    for (lo, hi), iv in zip(oracle.segments(), ivs):
        keys[lo:hi] = (c["ts"][lo:hi] // iv) * iv // interval * interval
    oracle._auto_keys = ((target, len(c["ts"])), (interval, keys))
    return interval, keys


def lt_auto_buckets(keys: np.ndarray, interval: int, target: int) -> tuple:
    """The coordinator's coarser rungs over the matched docs' keys, each
    rung rounding the last one's keys down, until the buckets fit
    `target`: (interval ms, key of each doc)."""
    from opensearch_tpu_torch.search import aggregations as A
    ladder = [ms for ms, _n in A.AUTO_LADDER]
    k = keys // interval
    k0 = int(k.min()) if len(k) else 0
    per = np.bincount(k - k0)
    cur = (k0 + np.flatnonzero(per)) * interval
    li = ladder.index(interval)
    while len(np.unique(cur)) > target and li + 1 < len(ladder):
        li += 1
        interval = ladder[li]
        cur = (cur // interval) * interval
    return interval, cur[(np.cumsum(per > 0) - 1)[k - k0]]


def lt_check_metrics(resp: dict, m, c, oracle, sums: SumCheck, sketch,
                     ms_err: dict, what: str) -> None:
    from opensearch_tpu_torch.search import aggregations as A
    aggs = resp["aggregations"]
    ok = m & c["rating_present"]
    r, p = c["rating"][ok], c["price"][ok]
    rp = r.astype(np.float64) * p.astype(np.float64)
    vw, ws = float(rp.sum()), float(p.astype(np.float64).sum())
    lt_bound_close(aggs["w"]["value"], vw / ws,
                   (sum_bound(rp) + abs(vw / ws) * sum_bound(p)) / ws,
                   f"{what} weighted_avg")
    hist = np.bincount(np_dd_bins(r), minlength=8193)
    want_mad = A.mad_from_hist(hist)
    if aggs["m"]["value"] != want_mad:
        sketch["mad_mismatches"] += 1
        if not np.isclose(aggs["m"]["value"], want_mad, rtol=0.0205):
            raise AssertionError(f"{what}: MAD {aggs['m']} vs {want_mad}")
    x = aggs["x"]
    X = np.stack([p, r]).astype(np.float64)
    n = X.shape[1]
    if x["doc_count"] != n:
        raise AssertionError(f"{what}: matrix_stats count {x['doc_count']}")
    mean = X.mean(axis=1)
    d = X - mean[:, None]
    cov = d @ d.T / (n - 1)
    d2 = d * d
    m2 = d2.mean(axis=1)
    skew = (d2 * d).mean(axis=1) / m2 ** 1.5
    kurt = (d2 * d2).mean(axis=1) / m2 ** 2
    for i, f in enumerate(x["fields"]):
        errs = {"mean": abs(f["mean"] - mean[i]) / abs(mean[i]),
                "variance": abs(f["variance"] - cov[i, i]) / cov[i, i],
                "covariance": max(abs(f["covariance"][g] - cov[i, j])
                                  / np.sqrt(cov[i, i] * cov[j, j])
                                  for j, g in enumerate(("price", "rating"))),
                "correlation": max(abs(f["correlation"][g] - cov[i, j]
                                       / np.sqrt(cov[i, i] * cov[j, j]))
                                   for j, g in enumerate(("price", "rating"))),
                "skewness": abs(f["skewness"] - skew[i]),
                "kurtosis": abs(f["kurtosis"] - kurt[i])}
        for k, e in errs.items():
            ms_err[k] = max(ms_err.get(k, 0.0), float(e))
            if e > LT_MS_TOL[k]:
                raise AssertionError(f"{what}: matrix_stats {f['name']} {k} "
                                     f"error {e} > {LT_MS_TOL[k]}")
    mt = m & c["ts_present"]
    interval, keys = lt_auto_keys(oracle, c, 12)
    interval, keys = lt_auto_buckets(keys[mt], interval, 12)
    h = aggs["h"]
    k = keys // interval
    k0 = int(k.min()) if len(k) else 0
    per = np.bincount(k - k0)
    uniq = (k0 + np.flatnonzero(per)) * interval
    if h["interval"] != A.auto_interval_name(interval) or [
            (b["key"], b["doc_count"]) for b in h["buckets"]] != list(
                zip(uniq.tolist(), per[per > 0].tolist())):
        raise AssertionError(f"{what}: auto_date_histogram {h['interval']} "
                             f"{[(b['key'], b['doc_count']) for b in h['buckets']]}"
                             f" vs {A.auto_interval_name(interval)} "
                             f"{list(zip(uniq.tolist(), per[per > 0].tolist()))}")
    # each bucket's avg(rating) within the f32 bound of its sum
    rp = c["rating_present"][mt]
    j = (np.cumsum(per > 0) - 1)[k - k0][rp]
    rv = c["rating"][mt][rp].astype(np.float64)
    nb = len(uniq)
    cnt = np.bincount(j, minlength=nb)
    tot = np.bincount(j, weights=rv, minlength=nb)
    mag = np.bincount(j, weights=np.abs(rv), minlength=nb)
    for b, n_j, t_j, a_j in zip(h["buckets"], cnt, tot, mag):
        sums.exact(b["a"]["value"], t_j / n_j, LAMBDA * np.sqrt(n_j) * F32_U
                   * a_j / n_j, f"{what} auto avg")


def lt_sample(oracle, m, score, k: int, shard_wide: bool) -> np.ndarray:
    """The sampled docs: per segment the matched docs scoring at least
    its k-th best (all of them with fewer), or, with `shard_wide` and
    more than k scores over the segments' top lists, those scoring at
    least the k-th best of the shard."""
    sel = np.zeros(len(m), bool)
    tops = []
    for lo, hi in oracle.segments():
        d = lo + np.flatnonzero(m[lo:hi])
        if hi - lo == 0:
            continue
        kk = min(k, hi - lo)
        sc = score[d]
        thr = (np.partition(sc, len(sc) - kk)[len(sc) - kk]
               if len(sc) >= kk else -np.inf)
        sel[d[sc >= thr]] = True
        tops.append(np.sort(sc)[::-1][:kk])
    allsc = np.concatenate(tops) if tops else np.zeros(0, np.float32)
    if shard_wide and len(allsc) > k:
        thr = np.sort(allsc)[-k]
        sel = m & (score >= thr)
    return sel


def lt_check_samplers(resp: dict, m, score, oracle, c, what: str) -> None:
    """significant_terms(status) against the live background; the
    sampler's shard-wide sample and significant_text over its titles;
    the diversified sample (at most 50 a status a segment) and its
    average price."""
    from opensearch_tpu_torch import bench_corpus as bc
    from opensearch_tpu_torch.search import aggregations as A
    ix = oracle.ix
    aggs = resp["aggregations"]
    fg = np.bincount(c["status"][m], minlength=3)
    bg = np.bincount(c["status"][c["live"]], minlength=3)
    fgt, bgt = int(m.sum()), int(c["live"].sum())
    want = sorted(((A.significance_score(int(fg[o]), fgt, int(bg[o]), bgt,
                                         "jlh"), bc.STATUS_VALUES[o],
                    int(fg[o]), int(bg[o])) for o in range(3)
                   if fg[o] >= 3), key=lambda t: (-t[0], t[1]))
    want = [(k, f, s, b) for s, k, f, b in want if s > 0]
    sig = aggs["sig"]
    got = [(b["key"], b["doc_count"], b["score"], b["bg_count"])
           for b in sig["buckets"]]
    if got != want or (sig["doc_count"], sig["bg_count"]) != (fgt, bgt):
        raise AssertionError(f"{what}: significant_terms {got} != {want}")
    sel = lt_sample(oracle, m, score, 200, True)
    if aggs["s"]["doc_count"] != int(sel.sum()):
        raise AssertionError(f"{what}: sampler {aggs['s']['doc_count']} "
                             f"!= {int(sel.sum())}")
    title = oracle.title
    tstarts, first, second, draw = title[0], title[5], title[6], title[8]
    tvs = bc.title_vocab_strings(len(tstarts) - 1)
    tf: Counter = Counter()
    n_fg = 0
    for lo, hi in oracle.segments():
        d = lo + np.flatnonzero(sel[lo:hi])
        d = d[np.lexsort((d, -score[d]))][:200]
        n_fg += len(d)
        for g in d[d < ix.n0].tolist():
            pr = draw[g].astype(np.int64)
            tf.update(set(first[pr].tolist()) | set(second[pr].tolist()))
    df = np.diff(tstarts)
    scored = sorted(((A.significance_score(k, n_fg, int(df[t]), bgt, "jlh"),
                      tvs[t], k, int(df[t])) for t, k in tf.items()
                     if k >= 3), key=lambda x: (-x[0], x[1]))
    want_t = [(key, k, s, b) for s, key, k, b in scored if s > 0][:10]
    st = aggs["s"]["t"]
    got_t = [(b["key"], b["doc_count"], b["score"], b["bg_count"])
             for b in st["buckets"]]
    if got_t != want_t or (st["doc_count"], st["bg_count"]) != (n_fg, bgt):
        raise AssertionError(f"{what}: significant_text {got_t} != {want_t}")
    dsel = np.zeros(len(m), bool)
    per = lt_sample(oracle, m, score, 100, False)
    for lo, hi in oracle.segments():
        for o in range(3):
            d = lo + np.flatnonzero(per[lo:hi] & (c["status"][lo:hi] == o))
            dsel[d[np.lexsort((d, -score[d]))][:50]] = True
    dv = aggs["d"]
    if dv["doc_count"] != int(dsel.sum()):
        raise AssertionError(f"{what}: diversified_sampler "
                             f"{dv['doc_count']} != {int(dsel.sum())}")
    pv = c["price"][dsel]
    lt_bound_close(dv["a"]["value"], float(pv.astype(np.float64).mean()),
                   sum_bound(pv) / len(pv), f"{what} diversified avg")


def lt_close(got, want, rtol: float = 1e-4, scale: float = 0.0) -> bool:
    """Card against CPU: equal but for floats, each within rtol of the
    largest of itself, the floats beside it and `scale` (a difference of
    sums or a moment near 0 carries the error of the sums beside it; the
    brute force holds each side to its own bound)."""
    if isinstance(want, dict):
        near = max([abs(v) for v in want.values() if isinstance(v, float)]
                   + [scale])
        return isinstance(got, dict) and got.keys() == want.keys() and all(
            lt_close(got[k], want[k], rtol, near) for k in want)
    if isinstance(want, list):
        return isinstance(got, list) and len(got) == len(want) and all(
            lt_close(g, w, rtol, scale) for g, w in zip(got, want))
    if isinstance(want, float) and isinstance(got, float):
        return abs(got - want) <= rtol * max(abs(got), abs(want), scale) \
            + 1e-9
    return got == want


def lt_pages(client, body: dict) -> list:
    """A body's responses: a composite pages by after_key until a page
    holds fewer than its size."""
    agg = body["aggs"].get("c", {}).get("composite")
    out = [client.search("bench", body)]
    while agg is not None and len(
            out[-1]["aggregations"]["c"]["buckets"]) == agg["size"]:
        after = out[-1]["aggregations"]["c"]["after_key"]
        out.append(client.search("bench", {**body, "aggs": {"c": {
            "composite": {**agg, "after": after}}}}))
    return out


def longtail_timer():
    """agg_op_timer's spans and host seconds, with the host seconds of
    the pipelines and of the refinement (its sub-searches inside) and
    the count of the refinement's sub-searches."""
    from opensearch_tpu_torch.search import aggregations as A
    from opensearch_tpu_torch.search import executor as E
    restore0, spans, host = agg_op_timer()
    depth = [0]
    saved = []

    def wrap(mod, name, label, refine=False):
        real = getattr(mod, name)

        def timed(*a, **kw):
            if name == "search_shards" and depth[0]:
                host["refinement_subsearches"] = host.get(
                    "refinement_subsearches", 0) + 1
            if (refine and depth[0]) or name == "search_shards":
                return real(*a, **kw)
            depth[0] += refine
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                depth[0] -= refine
                host[label] = host.get(label, 0.0) + time.perf_counter() - t0
        setattr(mod, name, timed)
        saved.append((mod, name, real))
    wrap(A, "apply_bucket_pipelines", "pipelines_host")
    wrap(E, "refine_complex_subs", "refinement_host", refine=True)
    wrap(E, "search_shards", "subsearches")

    def restore():
        for mod, name, real in reversed(saved):
            setattr(mod, name, real)
        restore0()
    return restore, spans, host


def longtail_cache_bytes(segs, dev) -> int:
    """Device bytes of the long-tail aggs' per-segment caches: the
    multi_terms ordinals and the date buckets."""
    n = 0
    for s in segs:
        for k, v in s.device_arrays.items():
            if k[0] in ("mterms", "dbuckets") and k[-1] == str(dev):
                n += v.numel() * v.element_size()
    return n


def run_longtail_class(client, name: str, items, oracle, cpu, check,
                       ncpu: int = 1) -> dict:
    """One class body by body through RestClient.search (a composite
    paged to its end), every response against the brute force, `ncpu`
    bodies on the card against the CPU twin, then its first LT_OP_BODIES
    bodies again under the op timer."""
    import torch
    from opensearch_tpu_torch.ops import bm25
    from opensearch_tpu_torch.search import compiler as C
    from opensearch_tpu_torch.search import fastpath
    C.reset_stats()
    bm25.reset_counts()
    fastpath.reset_stats()
    lat, resps = [], []
    t_all = time.perf_counter()
    for body, _ts in items:
        t0 = time.perf_counter()
        pages = lt_pages(client, body)
        resps.append(pages)
        lat += [(time.perf_counter() - t0) * 1e3 / len(pages)] * len(pages)
    wall = time.perf_counter() - t_all
    general = C.STATS["general_served"]
    launches = {k: v for k, v in bm25.COUNTS.items() if v}
    t0 = time.perf_counter()
    c = oracle.cols()
    for i, ((body, ts), pages) in enumerate(zip(items, resps)):
        m, score = oracle.matched(body, ts, c)
        check(pages, body, m, score, c, f"{name} body {i}")
    t_oracle = time.perf_counter() - t0
    t0 = time.perf_counter()
    for (body, ts), pages in list(zip(items, resps))[:ncpu]:
        want = [strip_took(r) for r in lt_pages(cpu, body)]
        # the panel's differences of sums carry the sums' errors
        scale = (max(abs(b["s"]["value"]) for b in want[0]["aggregations"][
            "m"]["buckets"]) if name.startswith("b_") else 0.0)
        if not lt_close([strip_took(r) for r in pages], want, 1e-4, scale):
            raise AssertionError(f"{name}: card and CPU responses differ "
                                 f"for {body}")
        m, score = oracle.matched(body, ts, c)
        check(want, body, m, score, c, f"{name} CPU")
    t_cpu = time.perf_counter() - t0
    nb = min(LT_OP_BODIES, len(items))
    restore, spans, host = longtail_timer()
    try:
        for body, _ts in items[:nb]:
            lt_pages(client, body)
        torch.cuda.synchronize()
    finally:
        restore()
    subs = host.pop("refinement_subsearches", 0)
    ops_ms = {k: sum(a.elapsed_time(e) for a, e in v) / nb
              for k, v in spans.items()}
    host_ms = {k: v * 1e3 / nb for k, v in host.items()}
    nreq = len(lat)
    n = len(items)
    log(f"  {name}: bodies={n} requests={nreq} wall_s={wall:.2f} "
        f"bodies_per_s={n / wall:.1f} ms_p50={np.percentile(lat, 50):.1f} "
        f"ms_p99={np.percentile(lat, 99):.1f} general={general} "
        f"kernel_launches={launches}; == numpy brute force "
        f"({t_oracle:.1f}s); {ncpu} card == CPU ({t_cpu:.1f}s); device ms "
        f"per body ({nb} bodies, events) " + " ".join(
            f"{k}={v:.4f}" for k, v in sorted(ops_ms.items()))
        + "; host ms per body " + " ".join(
            f"{k}={v:.2f}" for k, v in sorted(host_ms.items()))
        + f"; refinement sub-searches per body {subs / nb:.1f}")
    if launches or general < nreq:
        raise AssertionError(f"{name}: bodies with aggs left the general "
                             f"path: {launches} general={general}")
    return {"bodies": n, "requests": nreq, "bodies_per_s": n / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "op_ms": ops_ms, "host_ms": host_ms,
            "refinement_subsearches_per_body": subs / nb,
            "oracle_s": t_oracle, "cpu_s": t_cpu}


def longtail_checks(oracle, sums: SumCheck, sketch: Counter,
                    ms_err: dict) -> dict:
    """class -> check(pages, body, matched, scores, columns, what)."""
    return {
        "a_composite_export": lambda p, b, m, s, c, w:
            lt_check_composite(p, m, c, w),
        "b_time_series_panel": lambda p, b, m, s, c, w:
            lt_check_panel(p[0], m, c, oracle, sums, w),
        "c_top_hits": lambda p, b, m, s, c, w:
            lt_check_top_hits(p[0], b, m, s, oracle, c, w),
        "d_groupings": lambda p, b, m, s, c, w:
            lt_check_groupings(p[0], b, m, c, w),
        "e_metrics": lambda p, b, m, s, c, w:
            lt_check_metrics(p[0], m, c, oracle, sums, sketch, ms_err, w),
        "f_significance_samplers": lambda p, b, m, s, c, w:
            lt_check_samplers(p[0], m, s, oracle, c, w)}


def phase_longtail_msmarco(big: dict, n: int) -> dict:
    """Phase 15 on phase 7's end state (the corpus segment with deletes,
    phase 7's re-indexed docs, the later docs' segment): classes (a)-(f)
    of `longtail_classes`, every response against LongtailOracle, one
    body a class on the card against the CPU."""
    import torch
    client = big["client"]
    dev = client.device
    eng = client._indices["bench"].engine
    segs = list(eng.segments)
    oracle = LongtailOracle(big["ix"], big["aggs"], big["title"])
    if len(segs) != len(oracle.segments()):
        raise AssertionError(f"phase 15 expects {len(oracle.segments())} "
                             f"segments, not {len(segs)}")
    cpu = twin_of(eng)
    classes = longtail_classes(big, n)
    sums = SumCheck()
    sketch: Counter = Counter()
    ms_err: dict = {}
    checks = longtail_checks(oracle, sums, sketch, ms_err)
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated(dev)
    cache_before = longtail_cache_bytes(segs, dev)
    t0 = time.perf_counter()
    out = {name: run_longtail_class(client, name, items, oracle, cpu,
                                    checks[name])
           for name, items in classes.items()}
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated(dev)
    cache_after = longtail_cache_bytes(segs, dev)
    log(f"  sums: max relative error {sums.rel:.3e} ({sums.of_bound:.3e} of "
        f"the bound); MAD one bin off: {sketch['mad_mismatches']}; "
        f"matrix_stats' largest errors " + " ".join(
            f"{k}={v:.2e}" for k, v in sorted(ms_err.items())))
    log(f"  device bytes allocated: {mem_before} before the phase, "
        f"{mem_after} after; its per-segment caches (multi_terms ordinals, "
        f"date buckets) {cache_before} -> {cache_after} bytes, released "
        f"with their segments (phase 8's merge); phase {time.perf_counter() - t0:.1f}s")
    return {"classes": out, "device_bytes_before": mem_before,
            "device_bytes_after": mem_after,
            "cache_bytes_before": cache_before,
            "cache_bytes_after": cache_after,
            "sum_max_rel_err": sums.rel, "sum_err_of_bound": sums.of_bound,
            "mad_mismatches": sketch["mad_mismatches"],
            "matrix_stats_err": ms_err}


# ---------------------------------------------------------------------
# dense vectors, kNN and hybrid search: phase 4's small checks, phase
# 16 at MS MARCO passage scale, phase 8's merged bodies
# ---------------------------------------------------------------------

VEC_DIMS = 768         # the vectors of phase 16 (a BERT-base embedding)
VEC_CENTRES = 4096     # unit centres of the mixture
VEC_NOISE = 0.02       # per-dimension noise of a passage about its centre
VEC_QNOISE = 0.01      # per-dimension noise of a query about its passage
VEC_CHUNK = 1 << 19    # rows generated, uploaded or scored a step
VEC_WINDOW = 100       # the hybrid bodies' fusion window
VEC_MSEARCH = 64       # exact bodies of class (f)'s msearch
VEC_RTOL = 1e-6
VEC_EPS = 2.0 ** -23
VEC_SMALL_DIMS = 64
VEC_SMALL_FIELDS = ("cos", "dot", "l2")
VEC_SMALL_MAPPING = {"mappings": {"properties": {
    "cos": {"type": "dense_vector", "dims": VEC_SMALL_DIMS,
            "similarity": "cosine", "method": {"name": "ivf"}},
    "dot": {"type": "dense_vector", "dims": VEC_SMALL_DIMS,
            "similarity": "dot_product",
            "method": {"name": "ivf", "parameters": {"nlist": 24}}},
    "l2": {"type": "knn_vector", "dimension": VEC_SMALL_DIMS,
           "space_type": "l2_norm",
           "method": {"name": "ivf", "parameters": {"nlist": 32,
                                                    "nprobe": 6}}},
    "body": {"type": "text"}, "status": {"type": "keyword"},
    "price": {"type": "integer"}}}}


def vec_close(a: float, b: float, tol: tuple) -> bool:
    """|a - b| within tol = (rtol, atol, sq): atol + rtol |b| + sq b^2."""
    return abs(a - b) <= tol[1] + tol[0] * abs(b) + tol[2] * b * b


def same_vec(got, want, tol=(VEC_RTOL, 0.0, 0.0), path="") -> None:
    """Two responses equal apart from `took`, floats within `tol`
    (`vec_close`); in a hits list, hits whose `want` scores lie within
    2 tol of each other may come in either order (a run of them cut by
    the page's end may hold other such docs)."""
    if isinstance(want, dict):
        if not (isinstance(got, dict) and set(got) == set(want)):
            raise AssertionError(f"{path}: keys {sorted(got)} != "
                                 f"{sorted(want)}")
        for k in want:
            if k == "took":
                continue
            if k == "hits" and isinstance(want[k], list):
                _same_hits(got[k], want[k], tol, path + "hits.")
            elif k in ("_score", "max_score") and want[k] is not None:
                if got[k] is None or not vec_close(got[k], want[k], tol):
                    raise AssertionError(f"{path}{k}: {got[k]} != "
                                         f"{want[k]}")
            else:
                same_vec(got[k], want[k], tol, f"{path}{k}.")
    elif isinstance(want, list):
        if not (isinstance(got, list) and len(got) == len(want)):
            raise AssertionError(f"{path}: list lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            same_vec(g, w, tol, f"{path}{i}.")
    elif isinstance(want, float) and isinstance(got, float):
        if not vec_close(got, want, tol):
            raise AssertionError(f"{path}: {got} != {want}")
    elif got != want:
        raise AssertionError(f"{path}: {got} != {want}")


def _same_hits(got: list, want: list, tol, path: str) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{path}: {len(got)} hits != {len(want)}")
    i = 0
    while i < len(want):
        j = i + 1
        while (j < len(want) and want[j]["_score"] is not None
               and want[j - 1]["_score"] is not None
               and vec_close(want[j]["_score"], want[j - 1]["_score"],
                             tuple(2 * t for t in tol))):
            j += 1
        by_id = {h["_id"]: h for h in want[i:j]}
        for g in got[i:j]:
            w = by_id.get(g["_id"])
            if w is None:
                # a tie run cut by the page's end
                if not (j == len(want) and j - i > 1 and vec_close(
                        g["_score"], want[i]["_score"],
                        tuple(2 * t for t in tol))):
                    raise AssertionError(f"{path}{i}: {g['_id']} not in "
                                         f"{sorted(by_id)}")
                continue
            same_vec(g, w, tol, f"{path}{i}.")
        i = j


def l2_tolerance(vsq_max: float, q) -> tuple:
    """The tolerance of an L2 score S = 1 / (1 + d2): the expansion
    d2 = |v|^2 + |q|^2 - 2 v.q cancels, so its rounding is a few ulp of
    |v|^2 + |q|^2 whatever the distance, and S moves by S^2 times it;
    plus VEC_RTOL relative."""
    q = np.asarray(q, np.float64)
    return VEC_RTOL, 0.0, 4 * VEC_EPS * (vsq_max + float(q @ q))


def ivf_lists_agree(got: np.ndarray, want: np.ndarray, mat: np.ndarray,
                    cents: np.ndarray, rtol: float = 1e-6) -> int:
    """Two IVF builds' lists over the same scored matrix `mat` (rows) and
    `want`'s centroids: equal, but where a row's two nearest centroids
    are within `rtol` (it may sit in either list), or where two rows of
    one list are equally near its centroid within `rtol` (their slots
    may swap); distances are the build's ||c||^2 - 2 v.c in f64, `rtol`
    relative to ||c||^2 + 2 |v| |c|. -> the number of such slots; any
    other difference raises."""
    if got.shape != want.shape:
        raise AssertionError(f"IVF lists {got.shape} != {want.shape}")
    m = np.asarray(mat, np.float64)
    c = np.asarray(cents, np.float64)
    csq = (c * c).sum(1)
    cn = np.sqrt(csq)

    def dist(r, li):
        v = m[r]
        return csq[li] - 2 * v @ c[li], rtol * (csq[li] + 2 * np.sqrt(
            v @ v) * cn[li])

    def near_tied(r):
        d = csq - 2 * m[r] @ c.T
        a, b = np.argsort(d, kind="stable")[:2]
        return d[b] - d[a] <= max(dist(r, a)[1], dist(r, b)[1])
    bad = np.argwhere(got != want)
    for li, s in bad:
        rg, rw = int(got[li, s]), int(want[li, s])
        same_list = (rg >= 0 and rw >= 0 and rg in set(want[li].tolist())
                     and rw in set(got[li].tolist()))
        if same_list:
            (dg, tg), (dw, tw) = dist(rg, li), dist(rw, li)
            if abs(dg - dw) <= max(tg, tw):
                continue
        if all(r < 0 or near_tied(r) for r in (rg, rw)):
            continue
        raise AssertionError(f"IVF list {li} slot {s}: row {rg} != {rw}")
    return len(bad)


def vec_small_docs(rng, n: int) -> tuple:
    """n docs of phase 4's vector index: three clustered 64-dim fields
    (every ninth doc without them), a body, a status and a price: ->
    (docs, {field: f32[n, 64]})."""
    vecs = {}
    for f in VEC_SMALL_FIELDS:
        centres = rng.normal(size=(24, VEC_SMALL_DIMS)).astype(np.float32)
        vecs[f] = (centres[rng.integers(0, 24, n)] + 0.3 * rng.normal(
            size=(n, VEC_SMALL_DIMS))).astype(np.float32)
    words = ["red", "fox", "dog", "tree", "blue", "quick", "moon", "lake"]
    docs = []
    for i in range(n):
        d = {"body": " ".join(rng.choice(words, int(rng.integers(2, 7)))),
             "status": STATUS[i % 3], "price": int(rng.integers(1000))}
        if i % 9:
            for f in VEC_SMALL_FIELDS:
                d[f] = vecs[f][i].tolist()
        docs.append(d)
    return docs, vecs


def vec_small_bodies(rng, vecs, vsq_max: float) -> list:
    """(body, tolerance) pairs: per field the default route (IVF) and the
    exact scan at two vectors (one on `dot`), a filtered kNN, kNN in a
    bool, the body's kNN section beside a query, and hybrid rrf / linear
    bodies; scores within VEC_RTOL, an L2 score within its expansion's
    rounding at the query (`l2_tolerance`), a fused score within one step
    of its 7-place rounding."""
    out = []
    for f in VEC_SMALL_FIELDS:
        for i in (3, 200)[:1 if f == "dot" else 2]:
            q = (vecs[f][i] + 0.05 * rng.normal(size=VEC_SMALL_DIMS)
                 ).astype(np.float32).tolist()
            tol = (l2_tolerance(vsq_max, q) if f == "l2"
                   else (VEC_RTOL, 0.0, 0.0))
            fused = (tol[0], 1.5e-7, tol[2])
            knn = {"knn": {f: {"vector": q, "k": 10}}}
            out += [
                ({"size": 10, "query": knn}, tol),
                ({"size": 10, "query": {"knn": {f: {
                    "vector": q, "k": 10, "exact": True}}}}, tol),
                ({"size": 10, "query": {"knn": {f: {
                    "vector": q, "filter": {"term": {"status": "draft"}}}}}},
                 tol),
                ({"size": 10, "query": {"bool": {
                    "must": [{"match": {"body": "fox"}}], "should": [knn],
                    "filter": [{"range": {"price": {"lt": 600}}}]}}}, tol),
                ({"size": 10, "query": {"match": {"body": "red lake"}},
                  "knn": {"field": f, "query_vector": q, "k": 10}}, tol),
                ({"size": 10, "query": {"hybrid": {"queries": [
                    {"match": {"body": "blue moon"}}, knn]}},
                  "aggs": {"st": {"terms": {"field": "status"}}}}, fused),
            ]
            if f != "l2":
                # a linear fusion normalizes L2 scores by their spread,
                # past which the expansion's rounding has no bound
                out.append(({"size": 10, "query": {"hybrid": {
                    "queries": [{"match": {"body": "blue moon"}}, knn],
                    "fusion": {"method": "linear", "weights": [0.3, 0.7],
                               "normalization": "l2"}}}}, fused))
    return out


def run_vectors_small(name: str, docs, bodies) -> tuple:
    """Phase 4's vector index on `name` under a data path: 8 refreshes of
    docs (the 8th merges the tier), a 9th, 40 deletes; `bodies` through
    msearch and single searches; flush and a recovery serving the same
    pages; a forcemerge serving them again: -> (responses before the
    flush, after the forcemerge, each segment's IvfIndex per field before
    the flush, their scored matrices, kNN scans and probes)."""
    import tempfile
    import torch
    from opensearch_tpu_torch import RestClient
    from opensearch_tpu_torch.ops import knn as knn_ops

    n = len(docs)
    per = n // 9
    lines = sum([[{}, b] for b, _t in bodies], [])
    knn_ops.reset_stats()
    with tempfile.TemporaryDirectory() as path:
        c = RestClient(device=name, data_path=path)
        c.indices.create("v", VEC_SMALL_MAPPING)
        for r in range(9):
            hi = n if r == 8 else per * (r + 1)
            c.bulk(sum([[{"index": {"_index": "v", "_id": f"d{i}"}},
                         docs[i]] for i in range(per * r, hi)], []),
                   refresh=True)
        c.bulk([{"delete": {"_index": "v", "_id": f"d{i}"}}
                for i in range(0, n, n // 40)], refresh=True)
        segs = c._indices["v"].engine.segments
        if len(segs) != 2 or not segs[0].name.startswith("_m"):
            raise AssertionError(f"{name}: vectors, small: no tiered merge: "
                                 f"{[(s.name, s.ndocs) for s in segs]}")
        before = [c.msearch(lines, index="v")["responses"],
                  [c.search("v", b) for b, _t in bodies]]
        ivfs = [{f: s.vector_cols[f].ivf for f in VEC_SMALL_FIELDS}
                for s in segs]
        mats = [{f: s.vector_on(f, c.device)["mat"].cpu().numpy()
                 for f in VEC_SMALL_FIELDS} for s in segs]
        c.indices.flush("v")
        c.close()
        c = RestClient(device=name, data_path=path)
        again = c.msearch(lines, index="v")["responses"]
        for i, ((_b, tol), g, w) in enumerate(zip(bodies, again,
                                                  before[0])):
            same_vec(g, w, tol, f"{name} recovered {i}: ")
        c.indices.forcemerge("v")
        if len(c._indices["v"].engine.segments) != 1:
            raise AssertionError(f"{name}: vectors, small: no forcemerge")
        merged = c.msearch(lines, index="v")["responses"]
        c.close()
    if name == "cuda":
        torch.cuda.synchronize()
    return before, merged, ivfs, mats, dict(knn_ops.STATS)


def phase_vectors_small(rng) -> dict:
    """Phase 4's vector checks: the same bulk and bodies on the card and
    on the CPU; pages within tolerance (scores 1e-6 relative, L2 the
    expansion's rounding), the IVF lists built on the card equal to the
    CPU's under the tie rule (`ivf_lists_agree`), scans and probes on
    both, then the pages through a flush, a recovery and a forcemerge."""
    docs, vecs = vec_small_docs(rng, 2700)
    vsq_max = float((vecs["l2"].astype(np.float64) ** 2).sum(1).max())
    bodies = vec_small_bodies(rng, vecs, vsq_max)
    t0 = time.perf_counter()
    out = {name: run_vectors_small(name, docs, bodies)
           for name in ("cuda", "cpu")}
    t_run = time.perf_counter() - t0
    gc, cc = out["cuda"], out["cpu"]
    for part in (0, 1):
        for i, ((_b, tol), g, w) in enumerate(zip(bodies, gc[0][part],
                                                  cc[0][part])):
            same_vec(g, w, tol, f"vectors small {i}: ")
    for i, ((_b, tol), g, w) in enumerate(zip(bodies, gc[1], cc[1])):
        same_vec(g, w, tol, f"vectors merged {i}: ")
    swapped = 0
    for s, (gi, ci) in enumerate(zip(gc[2], cc[2])):
        for f in VEC_SMALL_FIELDS:
            swapped += ivf_lists_agree(gi[f].lists, ci[f].lists,
                                       cc[3][s][f], ci[f].centroids)
    if not (gc[4]["exact"] and gc[4]["ivf"]):
        raise AssertionError(f"vectors, small: no scan or no probe on the "
                             f"card: {gc[4]}")
    log(f"  vectors, small: {len(docs)} docs x 3 fields of "
        f"{VEC_SMALL_DIMS} dims (cosine, dot_product, l2_norm; IVF), "
        f"{len(bodies)} bodies: card == CPU within tolerance before and "
        f"after a flush, a recovery and a forcemerge; IVF lists of both "
        f"segments card == CPU ({swapped} slots differ under the tie rule); "
        f"card scans {gc[4]['exact']}, probes {gc[4]['ivf']} ({t_run:.1f}s)")
    return {"bodies": len(bodies), "ivf_slots_tied": swapped}


# ---------------------------------------------------------------------
# phase 16: dense vectors, kNN and hybrid search at MS MARCO scale
# ---------------------------------------------------------------------

def vector_chunks(n: int, seed: int, dev):
    """Phase 16's n passage vectors of VEC_DIMS on the card, VEC_CHUNK
    rows at a time: a mixture of VEC_CENTRES unit centres plus
    VEC_NOISE per dimension from a seeded torch.Generator, so that a
    second pass yields the same bits: -> (first row, f32 rows, their
    centres)."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    centres = torch.randn(VEC_CENTRES, VEC_DIMS, generator=gen, device=dev)
    centres /= torch.linalg.vector_norm(centres, dim=1, keepdim=True)
    for a in range(0, n, VEC_CHUNK):
        m = min(VEC_CHUNK, n - a)
        idx = torch.randint(0, VEC_CENTRES, (m,), generator=gen, device=dev)
        yield a, centres[idx] + VEC_NOISE * torch.randn(
            m, VEC_DIMS, generator=gen, device=dev), idx


def make_vectors(n: int, seed: int, dev) -> tuple:
    """`vector_chunks` copied to the host once: -> (f32[n, VEC_DIMS],
    each row's centre)."""
    import torch
    out = np.empty((n, VEC_DIMS), np.float32)
    which = np.empty(n, np.int64)
    # each chunk lands in a pinned buffer, then 8 threads copy it into the
    # host array (the first writes to its fresh pages fault them in)
    stage = torch.empty((VEC_CHUNK, VEC_DIMS), dtype=torch.float32,
                        pin_memory=torch.device(dev).type == "cuda")
    staged = stage.numpy()
    step = VEC_CHUNK // 8

    def put(job):
        a, s0, m = job
        out[a + s0:a + min(s0 + step, m)] = staged[s0:min(s0 + step, m)]
    with ThreadPoolExecutor(8) as pool:
        for a, x, idx in vector_chunks(n, seed, dev):
            m = len(x)
            stage[:m].copy_(x)
            which[a:a + m] = idx.cpu().numpy()
            list(pool.map(put, [(a, s0, m) for s0 in range(0, m, step)]))
    return out, which


def trim_host() -> None:
    """Collect garbage and hand the C heap's free pages back to the OS
    (glibc's malloc_trim on this process), so that state already freed
    no longer counts in the resident bytes."""
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass


class RssPeak:
    """The process's largest resident bytes while the block runs, read
    from /proc/self/statm every 20 ms on a thread (the kernel's own peak
    counts the whole run)."""

    def __enter__(self):
        import threading
        self.peak = rss_bytes()[0]
        self._stop = threading.Event()

        def watch():
            while not self._stop.wait(0.02):
                self.peak = max(self.peak, rss_bytes()[0])
        self._thread = threading.Thread(target=watch, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_bytes()[0])


def rss_bytes() -> tuple:
    """(the process's resident bytes now, its peak)."""
    import resource
    with open("/proc/self/statm") as fh:
        now = int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    return now, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class VecOracle:
    """Phase 16's brute force, apart from the port: cosine scores
    (1 + q.v / (|q| |v|)) / 2 in f64 of the passage vectors (corpus doc
    g is row g), over the live docs of `ix`; the IVF probe read from an
    index's centroids and lists (f64 centroid scores, the nprobe best
    with ties to the lower list) mapped to corpus docs by `to_g`. The
    vectors are the host's array `vecs`, or, where the caller has let it
    go, `vector_chunks` drawn again from `seed` (the same bits)."""

    def __init__(self, vecs, ix, dev, n0: int = 0, seed: int = 0):
        self.v, self.ix, self.dev = vecs, ix, dev
        self.n0 = len(vecs) if vecs is not None else n0
        self.seed = seed

    def chunks(self):
        """(first row, f32 rows on the card) over the corpus docs."""
        import torch
        if self.v is None:
            for a, x, _idx in vector_chunks(self.n0, self.seed, self.dev):
                yield a, x
            return
        for a in range(0, self.n0, VEC_CHUNK):
            yield a, torch.from_numpy(self.v[a:a + VEC_CHUNK]).to(self.dev)

    def live(self) -> np.ndarray:
        return self.ix.live[:self.n0]

    def unit(self, q) -> np.ndarray:
        q = np.asarray(q, np.float64)
        return q / max(np.linalg.norm(q), 1e-300)

    def at(self, docs: np.ndarray, q) -> np.ndarray:
        """f64 scores of corpus docs `docs`."""
        x = self.v[docs].astype(np.float64)
        x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-300)
        return (1.0 + x @ self.unit(q)) / 2.0

    def probe(self, q, ivf, nprobe: int, to_g: np.ndarray) -> list:
        """The probed docs' masks over the corpus (bool[n0]); two where
        the nprobe-th and next lists' scores lie within 1e-6 relative
        (either may be probed)."""
        s = np.asarray(ivf.centroids, np.float64) @ self.unit(q)
        order = np.lexsort((np.arange(len(s)), -s))
        picks = [order[:nprobe]]
        if nprobe < len(s) and s[order[nprobe - 1]] - s[order[nprobe]] \
                <= 1e-6 * abs(s[order[nprobe]]):
            picks.append(np.concatenate([order[:nprobe - 1],
                                         order[nprobe:nprobe + 1]]))
        masks = []
        for p in picks:
            rows = ivf.lists[p].reshape(-1)
            m = np.zeros(self.n0, bool)
            m[to_g[rows[rows >= 0]]] = True
            masks.append(m)
        return masks

    def top(self, reqs: list) -> list:
        """reqs: [(query vector, mask bool[n0] or None, c)] -> per request
        (corpus docs, f64 scores) of its c best live docs in the mask by
        (score desc, doc asc), and the mask's live count; one f64 pass
        over the vectors on the card, VEC_CHUNK rows a step."""
        import torch
        q = torch.tensor(np.stack([self.unit(r[0]) for r in reqs]),
                         dtype=torch.float64, device=self.dev)
        live = self.live()
        masks = [torch.from_numpy(live if m is None else m & live).to(
            self.dev) for _q, m, _c in reqs]
        parts = [[] for _ in reqs]
        for a, x in self.chunks():
            x = x.double()
            x /= torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(
                1e-300)
            s = (1.0 + x @ q.T) / 2.0
            for j, (_q, _m, c) in enumerate(reqs):
                sj = torch.where(masks[j][a:a + len(x)], s[:, j],
                                 float("-inf"))
                val, idx = torch.topk(sj, min(c + 8, len(x)))
                ok = torch.isfinite(val)
                parts[j].append((idx[ok].cpu().numpy() + a,
                                 val[ok].cpu().numpy()))
        out = []
        for j, (_q, _m, c) in enumerate(reqs):
            g = np.concatenate([p[0] for p in parts[j]])
            sc = np.concatenate([p[1] for p in parts[j]])
            o = np.lexsort((g, -sc))[:c]
            out.append((g[o], sc[o], int(masks[j].sum())))
        return out


def vec_page(ix, docs, scores, total: int, frm: int = 0,
             size: int = 10) -> tuple:
    """(ids, scores, total) of ranked corpus docs, positions frm..+size."""
    return ([ix.id_of(int(g)) for g in docs[frm:frm + size]],
            [float(s) for s in scores[frm:frm + size]], total)


def oracle_fusion(lists: list, spec: dict) -> list:
    """Fusion recomputed from ranked [(key, score)] lists: RRF sums
    w / (rank_constant + rank); linear sums w x the list's min-max or L2
    normalized score; order fused desc, best (list, rank), key."""
    fused, best = {}, {}
    for li, lst in enumerate(lists):
        w = spec["weights"][li]
        sc = np.asarray([s for _k, s in lst], np.float64)
        if spec["method"] == "rrf":
            part = w / (spec.get("rank_constant", 60) + np.arange(
                1, len(lst) + 1))
        elif spec.get("normalization", "min_max") == "l2":
            nrm = np.sqrt((sc * sc).sum())
            part = w * (sc / nrm if nrm > 0 else sc * 0)
        else:
            lo, hi = (sc.min(), sc.max()) if len(sc) else (0.0, 0.0)
            part = w * ((sc - lo) / (hi - lo) if hi > lo
                        else np.ones_like(sc))
        for r, ((k, _s), p) in enumerate(zip(lst, part)):
            fused[k] = fused.get(k, 0.0) + float(p)
            best.setdefault(k, (li, r))
    return sorted(fused.items(), key=lambda kv: (-kv[1], best[kv[0]],
                                                 kv[0]))


def vec_op_timer():
    """CUDA events around the scan, the probe and the top-k: ->
    (restore(), {op: [(start, end)]})."""
    import torch
    from opensearch_tpu_torch.ops import knn as knn_ops, scoring
    spans: dict = {}
    saved = []
    for mod, name, label in ((knn_ops, "exact_scan", "scan"),
                             (knn_ops, "ivf_probe", "probe"),
                             (scoring, "topk_docs", "topk")):
        real = getattr(mod, name)

        def timed(*a, _real=real, _label=label, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = _real(*a, **kw)
            e1.record()
            spans.setdefault(_label, []).append((e0, e1))
            return out
        setattr(mod, name, timed)
        saved.append((mod, name, real))

    def restore():
        for mod, name, real in saved:
            setattr(mod, name, real)
    return restore, spans


def run_vec_class(client, name: str, items, cpu=None, msearch=False,
                  tol=(VEC_RTOL, 0.0, 0.0)) -> dict:
    """One class body by body through RestClient.search (or as one
    msearch), kNN and bm25 counts set to 0 just before, the scan / probe
    / top-k event ms a body, then the first body on the card against the
    CPU twin: -> the class's numbers, its responses under "resps"."""
    import torch
    from opensearch_tpu_torch.ops import bm25, knn as knn_ops
    bodies = [b for b, _s in items]
    torch.cuda.synchronize()
    knn_ops.reset_stats()
    bm25.reset_counts()
    restore, spans = vec_op_timer()
    lat = []
    t0 = time.perf_counter()
    try:
        if msearch:
            resps = client.msearch(sum([[{}, b] for b in bodies], []),
                                   index="bench")["responses"]
            lat.append((time.perf_counter() - t0) * 1e3)
        else:
            resps = []
            for b in bodies:
                t1 = time.perf_counter()
                resps.append(client.search("bench", b))
                lat.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
    finally:
        restore()
    wall = time.perf_counter() - t0
    counts = {**dict(knn_ops.STATS), **{k: bm25.COUNTS[k] for k in (
        "launches", "impact_launches", "bool_launches", "plain_calls")}}
    op_ms = {k: sum(a.elapsed_time(e) for a, e in v) / len(bodies)
             for k, v in spans.items()}
    t_cpu = 0.0
    if cpu is not None:
        t0 = time.perf_counter()
        want = (cpu.msearch([{}, bodies[0]], index="bench")["responses"][0]
                if msearch else cpu.search("bench", bodies[0]))
        t_cpu = time.perf_counter() - t0
        same_vec(resps[0], want, tol, f"{name} card vs CPU: ")
    out = {"bodies": len(bodies), "wall_s": wall,
           "bodies_per_s": len(bodies) / wall,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "first_ms": lat[0], "op_ms": op_ms, "counts": counts,
           "resps": resps}
    if len(lat) > 1:
        out["bodies_per_s_after_first"] = (len(lat) - 1) / (sum(lat[1:])
                                                           / 1e3)
    log(f"  {name}: {len(bodies)} bodies in {wall:.2f}s "
        f"({out['bodies_per_s']:.1f}/s) p50 {out['p50_ms']:.1f} p99 "
        f"{out['p99_ms']:.1f} ms, first {lat[0]:.1f} ms; event ms a body "
        + " ".join(f"{k}={v:.3f}" for k, v in sorted(op_ms.items()))
        + f"; counts {counts}" + (f"; one body card == CPU ({t_cpu:.1f}s)"
                                  if cpu is not None else ""))
    return out


def drop_cpu_state(segs) -> None:
    """Drop the CPU twins' cached state of `segs` (aligned copies, masks,
    the general path's arrays, a vector matrix): what a later twin needs
    is rebuilt, mostly copied from the card's."""
    for s in segs:
        for cache in (s.aligned, s.device_arrays):
            for k in [k for k in cache if k and k[-1] == "cpu"]:
                del cache[k]


def vec_twin(eng):
    """A CPU client over the engine's segments with phase 16's mapping."""
    cpu = twin_of(eng)
    cpu.indices.put_mapping("bench", VEC_PUT_MAPPING)
    return cpu


VEC_PUT_MAPPING = {"properties": {"vec": {
    "type": "dense_vector", "dims": VEC_DIMS, "similarity": "cosine",
    "method": {"name": "ivf"}}}}


def vec_bodies(big: dict, vq: np.ndarray, n: int) -> dict:
    """Phase 16's bodies: class -> [(body, spec)], spec what the brute
    force needs (the query's row of `vq`, the route, a filter, terms)."""
    from opensearch_tpu_torch import bench_corpus as bc
    vs = bc.vocab_strings(len(big["corpus"][4]))
    terms = [list(big["body_terms"][2 * j]) for j in range(n)]

    def text(j):
        return " ".join(vs[int(t)] for t in terms[j])
    src = {"_source": {"excludes": ["vec"]}}

    def knn(j, **kw):
        return {"knn": {"vec": dict(vector=vq[j].tolist(), k=10, **kw)}}
    out = {"a_exact": [], "b_ivf": [], "c_filtered_bool": [],
           "d_body_section": [], "e_hybrid": [], "f_msearch": []}
    for j in range(n):
        out["a_exact"].append(({**src, "size": 10,
                                "query": knn(j, exact=True)},
                               {"q": j, "kind": "exact"}))
        out["b_ivf"].append(({**src, "size": 10, "query": knn(j)},
                             {"q": j, "kind": "ivf"}))
        k = n + j
        if j % 2 == 0:
            st, lo = j % 3, 100 * (j % 7)
            flt = {"bool": {"filter": [
                {"term": {"status": bc.STATUS_VALUES[st]}},
                {"range": {"price": {"gte": lo, "lt": lo + 300}}}]}}
            out["c_filtered_bool"].append((
                {**src, "size": 10, "query": knn(k, filter=flt)},
                {"q": k, "kind": "ivf", "status": st,
                 "price": (lo, lo + 300)}))
        else:
            out["c_filtered_bool"].append((
                {**src, "size": 10, "query": {"bool": {
                    "must": [{"match": {"body": text(j)}}],
                    "should": [knn(k)]}}},
                {"q": k, "kind": "bool_must", "terms": terms[j]}))
        k = 2 * n + j
        section = {"field": "vec", "query_vector": vq[k].tolist(), "k": 10}
        if j % 2 == 0:
            out["d_body_section"].append((
                {**src, "size": 10, "knn": section},
                {"q": k, "kind": "ivf"}))
        else:
            out["d_body_section"].append((
                {**src, "size": 10, "knn": section,
                 "query": {"match": {"body": text(j)}}},
                {"q": k, "kind": "bool_should", "terms": terms[j]}))
        k = 3 * n + j
        fusion = [{"method": "rrf", "window_size": VEC_WINDOW},
                  {"method": "linear", "weights": [0.3, 0.7],
                   "normalization": "min_max", "window_size": VEC_WINDOW},
                  {"method": "linear", "normalization": "l2",
                   "window_size": VEC_WINDOW},
                  {"method": "rrf", "window_size": VEC_WINDOW}][j % 4]
        body = {**src, "size": 10, "query": {"hybrid": {
            "queries": [{"match": {"body": text(j)}}, knn(k)],
            "fusion": fusion}}}
        if j % 4 == 3:
            body["aggs"] = {"st": {"terms": {"field": "status"}}}
        out["e_hybrid"].append((body, {"q": k, "kind": "hybrid",
                                       "terms": terms[j],
                                       "fusion": fusion,
                                       "aggs": j % 4 == 3}))
    for j in range(VEC_MSEARCH):
        k = 4 * n + j
        out["f_msearch"].append(({**src, "size": 10,
                                  "query": knn(k, exact=True)},
                                 {"q": k, "kind": "exact"}))
    return out


def vec_query_vectors(vecs: np.ndarray, live: np.ndarray, m: int,
                      seed: int) -> np.ndarray:
    """m query vectors: live passages' vectors plus VEC_QNOISE noise."""
    rng = np.random.default_rng([seed, 16])
    rows = rng.choice(np.flatnonzero(live), m, replace=False)
    return (vecs[rows] + VEC_QNOISE * rng.normal(
        size=(m, VEC_DIMS))).astype(np.float32)


def vec_checks(oracle: VecOracle, ix, vq, items: list, ivf, nprobe: int,
               to_g: np.ndarray, columns) -> list:
    """One check a body (resp -> None, raising on a difference) from one
    f64 pass of the brute force over every request the bodies need."""
    status, price = columns
    reqs, plan = [], []

    def want(q, mask, c):
        reqs.append((vq[q], mask, c))
        return len(reqs) - 1

    n0 = oracle.n0
    for body, spec in items:
        q = spec["q"]
        masks = ([None] if spec["kind"] == "exact"
                 else oracle.probe(vq[q], ivf, nprobe, to_g))
        if "status" in spec:
            lo, hi = spec["price"]
            f = (status[:n0] == spec["status"]) & (price[:n0] >= lo) \
                & (price[:n0] < hi)
            masks = [m & f for m in masks]
        c = VEC_WINDOW if spec["kind"] == "hybrid" else 10
        plan.append((body, spec, masks, [want(q, m, c) for m in masks]))
    got = oracle.top(reqs)
    checks = []
    for body, spec, masks, rid in plan:
        variants = [vec_expect(oracle, ix, vq, body, spec, m, got[r])
                    for m, r in zip(masks, rid)]
        checks.append(lambda resp, vs=variants, b=body: vec_check(
            resp, vs, b))
    return checks


def vec_expect(oracle, ix, vq, body, spec, mask, top) -> tuple:
    """(page (ids, scores, total), tolerance, extra checks) of one body
    under one probe variant."""
    docs, sc, total = top
    kind = spec["kind"]
    if kind in ("exact", "ivf"):
        return vec_page(ix, docs, sc, total), (VEC_RTOL, 0.0, 0.0), None
    n0 = oracle.n0
    bm, ok = ix.group(spec["terms"])
    ok = ok & ix.live
    if kind in ("bool_must", "bool_should"):
        inp = np.zeros(ix.n, bool)
        inp[:n0] = mask & oracle.live()
        score = np.where(ok, bm, 0.0).astype(np.float64)
        cand = np.flatnonzero(ok)
        if kind == "bool_should":
            cand = np.union1d(cand, docs)
        kn = cand[inp[cand]]
        score[kn] += oracle.at(kn, vq[spec["q"]])
        o = np.lexsort((cand, -score[cand]))
        matched = ok | inp if kind == "bool_should" else ok
        return (vec_page(ix, cand[o], score[cand][o], int(matched.sum())),
                (VEC_RTOL, 0.0, 0.0), None)
    # hybrid: the oracle's two sub-pages, fused
    mids, msc, mtotal = ix.page(bm, ok, 0, VEC_WINDOW)
    sub = [[(("bench", i), float(s)) for i, s in zip(mids, msc)],
           [(("bench", ix.id_of(int(g))), float(s))
            for g, s in zip(docs, sc)]]
    fusion = dict({"weights": [1.0, 1.0]}, **spec["fusion"])
    fused = oracle_fusion(sub, fusion)
    atol = 1.5e-7
    if fusion["method"] == "linear" and fusion["normalization"] == \
            "min_max":
        # a score's rounding, scaled by its list's spread
        for w, lst in zip(fusion["weights"], sub):
            s = np.asarray([x for _k, x in lst])
            if len(s) and s.max() > s.min():
                atol += w * 2e-6 * np.abs(s).max() / (s.max() - s.min())
    page = ([k[1] for k, _s in fused[:10]], [s for _k, s in fused[:10]],
            None)
    extra = {"totals": (total, max(total, mtotal))}
    if spec["aggs"]:
        from opensearch_tpu_torch import bench_corpus as bc
        cnt = Counter(bc.STATUS_VALUES[int(ix.status[oracle_global(
            ix, k[1])])] for k, _s in fused)
        extra["buckets"] = [{"key": k, "doc_count": v} for k, v in sorted(
            cnt.items(), key=lambda kv: (-kv[1], kv[0]))]
    return page, (0.0, atol, 0.0), extra


def oracle_global(ix, doc_id: str) -> int:
    """The global id of the live doc with `_id` doc_id."""
    if doc_id.isdigit() and int(doc_id) < ix.n0 and ix.live[int(doc_id)]:
        return int(doc_id)
    for k in range(len(ix.new_ids) - 1, -1, -1):
        if ix.new_ids[k] == doc_id and ix.live[ix.n0 + k]:
            return ix.n0 + k
    raise AssertionError(f"no live doc [{doc_id}] in the brute force")


def vec_check(resp: dict, variants: list, body: dict) -> None:
    """A response against the brute force's page (any probe variant)."""
    errors = []
    for (ids, scores, total), tol, extra in variants:
        try:
            h = resp["hits"]
            got = [(x["_id"], x["_score"]) for x in h["hits"]]
            want_hits = [{"_id": i, "_score": s} for i, s in zip(ids,
                                                                  scores)]
            _same_hits([{"_id": i, "_score": s} for i, s in got],
                       want_hits, tol, "hits.")
            t = h["total"]
            if extra is None:
                if t != {"value": total, "relation": "eq"}:
                    raise AssertionError(f"total {t} != {total}")
            else:
                lo, hi = extra["totals"]
                if not (t["relation"] == "gte" and lo <= t["value"] <= hi):
                    raise AssertionError(f"hybrid total {t} not in "
                                         f"[{lo}, {hi}] gte")
                if "buckets" in extra and resp["aggregations"]["st"][
                        "buckets"] != extra["buckets"]:
                    raise AssertionError(
                        f"aggs over fusion {resp['aggregations']} != "
                        f"{extra['buckets']}")
            return
        except AssertionError as e:
            errors.append(str(e))
    raise AssertionError(f"body {json.dumps(body)[:300]} != brute force: "
                         f"{errors}")


def phase_vectors_msmarco(big: dict, n: int, seed: int) -> dict:
    """Phase 16 on phase 7's end state: a cosine `vec` field of VEC_DIMS
    with the mapping's default IVF, its column attached to the corpus
    segment (every passage has a vector; phase 7's re-indexed docs and
    phase 14's later docs have none), `n` bodies a class of (a) exact kNN,
    (b) IVF kNN at the default probe (recall@10 against (a)), (c) a
    filtered kNN and a bool of a match with a kNN should, (d) the body's
    kNN section alone and beside a query, (e) hybrid rrf, linear min_max
    [0.3, 0.7], linear l2 and rrf with a terms agg over the fused window,
    (f) one msearch of VEC_MSEARCH exact bodies; every page against
    VecOracle (the probe over the card's own lists and centroids), one
    body a class card == CPU (the CPU twin reuses the card's IVF index)."""
    import torch
    from opensearch_tpu_torch.index.segment import VectorColumn
    from opensearch_tpu_torch.ops import ann
    client, seg, ix = big["client"], big["seg"], big["ix"]
    dev = client.device
    eng = client._indices["bench"].engine
    n0 = seg.ndocs
    if seg not in eng.segments or n0 != ix.n0 \
            or not np.array_equal(seg.live, ix.live[:n0]):
        raise AssertionError("phase 16: the corpus segment or its live docs "
                             "differ from the brute force's")
    torch.cuda.synchronize()
    bytes0 = torch.cuda.memory_allocated(dev)
    rss0 = rss_bytes()[0]
    # host memory for the vectors and the CPU twin's unit-normed copy:
    # the earlier twins' CPU state goes (a later twin copies it back), and
    # the caches no later phase reads on these segments (filter lists,
    # phrase pairs, date buckets, keyword hashes: rebuilt on use)
    drop_cpu_state(eng.segments)
    for s in eng.segments:
        for k in ("filter_lists", "phrase_pairs", "date_buckets",
                  "kw_hashes"):
            s.__dict__.pop(k, None)
    trim_host()
    log(f"  host RSS {rss0} before the phase, {rss_bytes()[0]} without the "
        f"earlier CPU twins' state and the segments' host caches")
    t0 = time.perf_counter()
    vecs, _which = make_vectors(n0, seed, dev)
    t_gen = time.perf_counter() - t0
    client.indices.put_mapping("bench", VEC_PUT_MAPPING)
    ft = eng.mappings.resolve_field("vec")
    seg.vector_cols["vec"] = VectorColumn("vec", vecs, np.ones(n0, bool),
                                          ft.vector_similarity,
                                          method=ft.vector_method)
    log(f"  {n0} x {VEC_DIMS} vectors ({vecs.nbytes} bytes) drawn on the "
        f"card from {VEC_CENTRES} unit centres + {VEC_NOISE} noise and "
        f"copied to the host in {t_gen:.1f}s; host RSS now / peak "
        f"{rss_bytes()}")
    vq = vec_query_vectors(vecs, ix.live[:n0], 4 * n + VEC_MSEARCH, seed)
    classes = vec_bodies(big, vq, n)
    cpu = vec_twin(eng)
    out: dict = {"classes": {}}
    resps: dict = {}
    for name, items in classes.items():
        if name == "b_ivf":
            torch.cuda.synchronize()
            out["device_bytes_scan"] = torch.cuda.memory_allocated(dev)
        r = run_vec_class(client, name, items, cpu,
                          msearch=name == "f_msearch",
                          tol=(VEC_RTOL, 1.5e-7, 0.0)
                          if name == "e_hybrid" else
                          (VEC_RTOL, 0.0, 0.0))
        out["classes"][name] = r
        resps[name] = r.pop("resps")
        if name == "b_ivf":
            out["ivf_build"] = dict(ann.LAST_BUILD)
    torch.cuda.synchronize()
    col = seg.vector_cols["vec"]
    ivf = col.ivf
    out["device_bytes"] = torch.cuda.memory_allocated(dev) - bytes0
    out["nlist"], out["cap"], out["nprobe"] = (ivf.nlist, ivf.cap,
                                               ivf.default_nprobe)
    # the brute force, one f64 pass on the card over the host's vectors
    oracle = VecOracle(vecs, ix, dev)
    t0 = time.perf_counter()
    everything = [it for items in classes.values() for it in items]
    checks = vec_checks(oracle, ix, vq, everything, ivf, ivf.default_nprobe,
                        np.arange(n0), (ix.status, ix.price))
    flat = [r for name in classes for r in resps[name]]
    for check, r in zip(checks, flat):
        check(r)
    t_oracle = time.perf_counter() - t0
    # recall@10 of the probe against the scan, the same query vectors
    rec = [len({h["_id"] for h in a["hits"]["hits"]}
               & {h["_id"] for h in b["hits"]["hits"]}) / 10
           for a, b in zip(resps["a_exact"], resps["b_ivf"])]
    out["recall_at_10"] = float(np.mean(rec))
    scan_bytes = n0 * VEC_DIMS * 4
    probe_bytes = ivf.default_nprobe * ivf.cap * VEC_DIMS * 4
    out["scan_bound_ms"] = scan_bytes / HBM_BYTES_PER_S * 1e3
    out["probe_bound_ms"] = probe_bytes / HBM_BYTES_PER_S * 1e3
    out["hybrid_launches"] = {k: out["classes"]["e_hybrid"]["counts"][k]
                              for k in ("launches", "impact_launches")}
    out["rss_bytes"], out["rss_peak_bytes"] = rss_bytes()
    b = out["ivf_build"]
    log(f"  IVF: nlist {ivf.nlist}, cap {ivf.cap}, default nprobe "
        f"{ivf.default_nprobe}; k-means {b['kmeans_s']:.2f}s, top-2 "
        f"assignment {b['assign_s']:.2f}s, fill {b['fill_s']:.2f}s; "
        f"recall@10 of (b) against (a) {out['recall_at_10']:.3f}")
    log(f"  bounds at 3.35 TB/s: scan {out['scan_bound_ms']:.2f} ms "
        f"({scan_bytes} bytes), probe {out['probe_bound_ms']:.2f} ms "
        f"({ivf.default_nprobe} x {ivf.cap} rows of {VEC_DIMS * 4} bytes); "
        f"vector device bytes {out['device_bytes']} (with the scan alone "
        f"{out['device_bytes_scan'] - bytes0}); B1 / B2 launches of the "
        f"hybrid bodies {out['hybrid_launches']}; every page == the brute "
        f"force "
        f"({t_oracle:.1f}s); host RSS now / peak {out['rss_bytes']} / "
        f"{out['rss_peak_bytes']}")
    if out["classes"]["a_exact"]["counts"]["exact"] == 0 \
            or out["classes"]["b_ivf"]["counts"]["ivf"] == 0:
        raise AssertionError("phase 16: no scan or no probe ran")
    # the CPU twin's state (its unit-normed matrix in host memory) goes
    drop_cpu_state(eng.segments)
    # the corpus segment's column keeps the vectors until phase 8's merge
    # replaces it; phase 8's oracle draws them again from the seed
    big["vec"] = {"seed": seed, "n0": n0, "vq": vq, "n": n}
    return out


def phase_vectors_merged(big: dict) -> dict:
    """Phase 8's merged segment: one body of classes (a), (b) and (e) of
    phase 16 (the IVF rebuilt on the merged column, timed), each page
    against VecOracle over the merged segment's lists (merged rows map to
    the live corpus docs in order), its vectors drawn again from the
    seed; 1,000 sampled merged rows against them; the hybrid body's
    match on B1 / B2."""
    import torch
    from opensearch_tpu_torch.ops import ann
    client, ix = big["client"], big["ix"]
    vq, n, n0 = big["vec"]["vq"], big["vec"]["n"], big["vec"]["n0"]
    eng = client._indices["bench"].engine
    (merged,) = eng.segments
    live_g = np.flatnonzero(ix.live)
    col = merged.vector_cols["vec"]
    k = int((live_g < n0).sum())
    srng = np.random.default_rng(23)
    rows = np.sort(srng.choice(k, 1000, replace=False))
    oracle = VecOracle(None, ix, client.device, n0=n0,
                       seed=big["vec"]["seed"])
    drawn = np.empty((len(rows), VEC_DIMS), np.float32)
    g = live_g[rows]
    for a, x in oracle.chunks():
        at = (g >= a) & (g < a + len(x))
        if at.any():
            drawn[at] = x[torch.from_numpy(g[at] - a).to(x.device)].cpu(
            ).numpy()
    if not (np.array_equal(col.values[rows], drawn)
            and col.present[:k].all() and not col.present[k:].any()):
        raise AssertionError("merged vectors != the live corpus rows")
    classes = vec_bodies(big, vq, n)
    picks = {"a_exact": classes["a_exact"][:1],
             "b_ivf": classes["b_ivf"][:1],
             "e_hybrid": classes["e_hybrid"][:1]}
    out: dict = {"classes": {}}
    resps = []
    for name, items in picks.items():
        r = run_vec_class(client, f"{name}, merged", items)
        resps += r.pop("resps")
        out["classes"][name] = r
        if name == "b_ivf":
            out["ivf_build"] = dict(ann.LAST_BUILD)
    ivf = col.ivf
    checks = vec_checks(oracle, ix, vq, [it for items in picks.values()
                                         for it in items], ivf,
                        ivf.default_nprobe, live_g, (ix.status, ix.price))
    for check, r in zip(checks, resps):
        check(r)
    c = out["classes"]["e_hybrid"]["counts"]
    if c["launches"] + c["impact_launches"] == 0 or c["plain_calls"]:
        raise AssertionError(f"merged hybrid: its match not on B1 / B2: {c}")
    b = out["ivf_build"]
    log(f"  merged: IVF rebuilt (nlist {ivf.nlist}, cap {ivf.cap}): "
        f"k-means {b['kmeans_s']:.2f}s, assignment {b['assign_s']:.2f}s, "
        f"fill {b['fill_s']:.2f}s; 3 pages == the brute force; the hybrid "
        f"body's B1 / B2 launches {c['launches']} / {c['impact_launches']}")
    torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------
# learned sparse retrieval, rank_feature and distance_feature: phase 4's
# small index and phase 17 at MS MARCO scale
# ---------------------------------------------------------------------

SP_VOCAB = 30_522      # BERT-base's WordPiece vocabulary
SP_ZIPF = 1.1          # token popularity (bench.py's hybrid corpus)
SP_TOKENS = 64         # distinct tokens a passage
SP_DRAWS = 128         # iid draws a passage; its first SP_TOKENS distinct
SP_CHUNK = 1 << 17     # passages drawn a step
SP_WINDOW = 50         # the hybrid bodies' fusion window
SP_RTOL = 1e-6
SP_MAPPING = {"properties": {
    "emb": {"type": "rank_features", "index_impacts": True},
    "pagerank": {"type": "rank_feature"}}}
SP_FUNCTIONS = (("saturation", {}), ("log", {"log": {"scaling_factor": 2.0}}),
                ("sigmoid", {"sigmoid": {"pivot": 1.2, "exponent": 0.8}}),
                ("linear", {"linear": {}}))
SP_SMALL_MAPPING = {"mappings": {"properties": {
    "body": {"type": "text"}, "st": {"type": "keyword"},
    "emb": {"type": "rank_features", "index_impacts": True},
    "pr": {"type": "rank_feature"}, "ts": {"type": "date"}}}}


def sp_token(t: int) -> str:
    """Token t's feature name, zero-padded: names sort as the ranks do."""
    return f"s{t:05d}"


def sp_query_tokens(rng, vocab: int) -> dict:
    """bench.py's learned-sparse query: 3 rare head tokens (ranks 120
    and up, uniform) weighted 3 / (r + 1), up to 8 popular tail tokens
    (the top 100 by popularity) weighted 0.25 / (1 + r) + 0.02."""
    head = rng.choice(np.arange(120, vocab), 3, replace=False)
    p = 1.0 / np.arange(1, 101) ** SP_ZIPF
    tail = dict.fromkeys(int(t) for t in rng.choice(100, 8, p=p / p.sum()))
    toks = {sp_token(int(t)): round(3.0 / (r + 1), 3)
            for r, t in enumerate(head)}
    for r, t in enumerate(tail):
        toks.setdefault(sp_token(t), round(0.25 / (1 + r) + 0.02, 3))
    return toks


def sp_plane_check(pb, what: str, rows=None) -> None:
    """A FEATURE plane against its numpy form: scale = max / qmax in
    double, q = round(w / f32(scale)) in f32 (half to even) clipped, and
    the per-128-posting block maxima of each row; over every row, or the
    rows `rows` (the scale and the block counts still over all)."""
    ip = pb.impact
    qmax = (1 << ip.bits) - 1
    scale = float(pb.tfs.max()) / qmax
    lens = np.diff(pb.starts)
    nblk = -(-lens // 128)
    bstarts = np.concatenate([[0], np.cumsum(nblk)]).astype(np.int64)
    ok = (ip.kind == "feature" and ip.scale == scale
          and np.array_equal(ip.block_starts, bstarts)
          and len(ip.q) == pb.size)
    for r in [None] if rows is None else rows:
        a, b = (0, pb.size) if r is None else pb.row_slice(int(r))
        ba, bb = (0, int(bstarts[-1])) if r is None else (
            int(bstarts[r]), int(bstarts[r + 1]))
        q = np.minimum(np.round(pb.tfs[a:b] / np.float32(scale)),
                       qmax).astype(ip.q.dtype)
        row = np.repeat(np.arange(len(lens)), nblk)[ba:bb] if r is None \
            else np.full(bb - ba, r)
        boff = (pb.starts[row] + 128 * (np.arange(ba, bb) - bstarts[row])
                ).astype(np.int64)
        bmax = np.maximum.reduceat(q, boff - a) if len(boff) else q[:0]
        ok = ok and ip.q.dtype == q.dtype and np.array_equal(ip.q[a:b], q) \
            and np.array_equal(ip.block_off[ba:bb], boff) \
            and np.array_equal(ip.block_max[ba:bb], bmax)
    if not ok:
        raise AssertionError(f"{what}: the FEATURE plane != its numpy form")


def sp_small_docs(rng, n: int) -> list:
    """n docs of phase 4's sparse index: 24 Zipf(1.1) draws a doc over
    2,000 tokens (weights expovariate(1) + 0.05, 3 places), a pagerank
    on 4 in 5, a date, a body and a status."""
    p = 1.0 / np.arange(1, 2001) ** SP_ZIPF
    p /= p.sum()
    words = ["red", "fox", "dog", "tree", "blue", "quick", "moon", "lake"]
    docs = []
    for i in range(n):
        toks = rng.choice(2000, 24, p=p)
        d = {"body": " ".join(rng.choice(words, int(rng.integers(2, 7)))),
             "st": "abc"[i % 3],
             "emb": {sp_token(int(t)): round(float(rng.exponential()) + 0.05,
                                             3) for t in toks},
             "ts": int(1_704_067_200_000 + rng.integers(0, 300 * DAY_MS))}
        if i % 5:
            d["pr"] = round(float(rng.lognormal()), 4)
        docs.append(d)
    return docs


def sp_small_bodies(rng) -> list:
    """Phase 4's sparse bodies: neural_sparse (pruned, exact totals,
    boosted), in a bool, as a filter; rank_feature in each function over
    a feature and the column; distance_feature; a hybrid."""
    match = {"match": {"body": "fox tree"}}
    out = []
    for i in range(4):
        toks = sp_query_tokens(rng, 2000)
        out += [{"query": {"neural_sparse": {"emb": {"query_tokens": toks}}},
                 "size": (10, 3)[i % 2]},
                {"query": {"neural_sparse": {"emb": {
                    "query_tokens": toks, "boost": 1.5}}},
                 "track_total_hits": True},
                {"query": {"bool": {"must": [match],
                                    "filter": [{"term": {"st": "b"}}],
                                    "should": [{"neural_sparse": {"emb": {
                                        "query_tokens": toks}}}]}}}]
    for _name, fn in SP_FUNCTIONS:
        for field in ("emb.s00007", "pr"):
            out.append({"query": {"bool": {"must": [match], "should": [
                {"rank_feature": dict(field=field, **fn)}]}}})
    out += [
        {"query": {"bool": {"must": [match], "should": [
            {"distance_feature": {"field": "ts", "origin":
                                  "2024-06-01T00:00:00Z", "pivot": "7d"}}]}}},
        {"query": {"bool": {"must": [match], "filter": [
            {"rank_feature": {"field": "emb.s00003"}},
            {"neural_sparse": {"emb": {"query_tokens": {"s00001": 1.0}}}}]}}},
        {"query": {"hybrid": {"queries": [
            match, {"neural_sparse": {"emb": {"query_tokens":
                                              sp_query_tokens(rng, 2000)}}}],
            "fusion": {"method": "rrf", "window_size": 30}}}}]
    return out


def run_sparse_small(name: str, docs, bodies) -> tuple:
    """Phase 4's sparse index on `name`: two refreshes (5,000 and 2,000
    docs), 40 deletes; `bodies` one by one, then a forcemerge and the
    bodies again; each segment's FEATURE plane against its numpy form
    (the first past DEVICE_IMPACT_MIN postings: quantized by the torch
    quantizer on `name`): -> (responses before, after the merge, the
    impact rung's counts)."""
    from opensearch_tpu_torch import RestClient
    from opensearch_tpu_torch.ops import device_merge
    from opensearch_tpu_torch.search import impactpath
    c = RestClient(device=name)
    c.indices.create("sp", SP_SMALL_MAPPING)
    for a, b in ((0, 5000), (5000, len(docs))):
        c.bulk(sum([[{"index": {"_index": "sp", "_id": f"d{i}"}}, docs[i]]
                    for i in range(a, b)], []), refresh=True)
    c.bulk([{"delete": {"_index": "sp", "_id": f"d{i}"}}
            for i in range(0, len(docs), len(docs) // 40)], refresh=True)
    segs = c._indices["sp"].engine.segments
    if segs[0].postings["emb"].size < device_merge.DEVICE_IMPACT_MIN:
        raise AssertionError("sparse, small: the first segment's plane is "
                             "below the device quantizer's size")
    for s in segs:
        sp_plane_check(s.postings["emb"], f"{name} segment {s.name}")
    impactpath.reset_stats()
    before = [c.search("sp", b) for b in bodies]
    c.indices.forcemerge("sp")
    (merged,) = c._indices["sp"].engine.segments
    sp_plane_check(merged.postings["emb"], f"{name} merged")
    after = [c.search("sp", b) for b in bodies]
    return before, after, {k: v for k, v in impactpath.STATS.items()
                           if k.startswith("sparse_")}


def phase_sparse_small(rng) -> dict:
    """Phase 4's sparse checks: the same bulk and bodies on the card and
    on the CPU; FEATURE planes against numpy (built on the card past
    DEVICE_IMPACT_MIN postings, in numpy below it, and by the merge);
    pages card == CPU within 1e-6 relative before and after the merge;
    the sparse rung served and pruned on the card as on the CPU."""
    docs = sp_small_docs(rng, 7000)
    bodies = sp_small_bodies(rng)
    t0 = time.perf_counter()
    out = {name: run_sparse_small(name, docs, bodies)
           for name in ("cuda", "cpu")}
    for part in (0, 1):
        for i, (g, w) in enumerate(zip(out["cuda"][part],
                                       out["cpu"][part])):
            same_vec(g, w, (SP_RTOL, 0.0, 0.0) if "hybrid" not in json.dumps(
                bodies[i]) else (SP_RTOL, 1.5e-7, 0.0),
                f"sparse small {part} {i}: ")
    st = out["cuda"][2]
    if st != out["cpu"][2] or not st["sparse_served"] \
            or not st["sparse_blocks_skipped"]:
        raise AssertionError(f"sparse, small: the sparse rung's counts "
                             f"card {st} cpu {out['cpu'][2]}")
    log(f"  sparse, small: {len(docs)} docs (rank_features with "
        f"index_impacts, rank_feature, a date), {len(bodies)} bodies: "
        f"FEATURE planes == numpy (the first segment's quantized on the "
        f"card), card == CPU before and after a forcemerge; sparse rung "
        f"{st} ({time.perf_counter() - t0:.1f}s)")
    return st


def _first_distinct(draws, k: int) -> tuple:
    """(the first k distinct values of each row of `draws` in draw order
    [rows, k] of the rows that hold k, those rows' mask)."""
    import torch
    s, idx = torch.sort(draws, dim=1, stable=True)
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    isfirst = torch.zeros_like(first).scatter_(1, idx, first)
    keep = isfirst & (torch.cumsum(isfirst, 1) <= k)
    ok = keep.sum(1) == k
    return draws[ok][keep[ok]].view(-1, k), ok


def sparse_draw(n: int, seed: int, dev) -> tuple:
    """Phase 17's data on `dev` from a seeded torch.Generator: each of n
    passages' SP_TOKENS distinct tokens, the first distinct values of an
    iid Zipf(SP_ZIPF) stream over SP_VOCAB tokens (sampling without
    replacement in proportion to popularity; a row short of SP_TOKENS
    after SP_DRAWS draws draws on), their weights expovariate(1) + 0.05
    rounded to 3 places, and a log-normal pagerank a passage: -> (tokens
    i16[n, SP_TOKENS], weights f32[n, SP_TOKENS], pagerank f64[n])."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) * 1000 + 17)
    cdf = torch.cumsum(torch.arange(1, SP_VOCAB + 1, dtype=torch.float64,
                                    device=dev) ** -SP_ZIPF, 0)
    cdf /= cdf[-1].clone()

    def draw(rows: int):
        u = torch.rand(rows, SP_DRAWS, dtype=torch.float64, generator=gen,
                       device=dev)
        return torch.searchsorted(cdf, u).clamp_(max=SP_VOCAB - 1)
    tok = torch.empty((n, SP_TOKENS), dtype=torch.int16, device=dev)
    w = torch.empty((n, SP_TOKENS), dtype=torch.float32, device=dev)
    for a in range(0, n, SP_CHUNK):
        m = min(SP_CHUNK, n - a)
        draws = draw(m)
        rows = torch.arange(a, a + m, device=dev)
        while len(rows):
            got, ok = _first_distinct(draws, SP_TOKENS)
            tok[rows[ok]] = got.to(torch.int16)
            rows, draws = rows[~ok], draws[~ok]
            if len(rows):
                draws = torch.cat([draws, draw(len(rows))], 1)
        e = torch.empty((m, SP_TOKENS), dtype=torch.float64,
                        device=dev).exponential_(generator=gen)
        w[a:a + m] = (torch.round((e + 0.05) * 1000.0) / 1000.0).float()
    pagerank = torch.empty(n, dtype=torch.float64,
                           device=dev).log_normal_(0.0, 1.0, generator=gen)
    return tok, w, pagerank


def sparse_csr(tok, w) -> tuple:
    """The passages' tokens as CSR postings, built on their device: rows
    by token (the tokens that occur), docs ascending within a row (a
    stable sort of the passage-major tokens), the weights beside them:
    -> (token ids i64[rows], starts i64[rows + 1], doc ids i32[P],
    weights f32[P]) on the host."""
    import torch
    k = tok.shape[1]
    flat = tok.reshape(-1)
    keys, perm = torch.sort(flat, stable=True)
    counts = torch.bincount(keys.to(torch.int32), minlength=SP_VOCAB)
    del keys
    docs = torch.div(perm, k, rounding_mode="floor").to(torch.int32).cpu()
    weights = w.reshape(-1)[perm].cpu()
    del perm
    counts = counts.cpu().numpy().astype(np.int64)
    present = np.flatnonzero(counts)
    starts = np.zeros(len(present) + 1, np.int64)
    np.cumsum(counts[present], out=starts[1:])
    return present, starts, docs.numpy(), weights.numpy()


class SparseOracle:
    """Phase 17's brute force, apart from the port: the passages' CSR as
    drawn (corpus doc g is passage g), their pagerank and the dates of
    every doc, over the live docs and statistics of `ix` (NumpyIndex).
    Scores are f32 in the port's order: a sparse dot sums query weight x
    stored weight token by token (sorted names), then x boost; the
    feature functions and the distance are the reference's f32 forms."""

    def __init__(self, token_ids, starts, docs, weights, pagerank, ts,
                 ts_present, ix, dev):
        self.row_of = {int(t): i for i, t in enumerate(token_ids)}
        self.starts, self.docs, self.weights = starts, docs, weights
        self.pagerank, self.ts, self.ts_present = pagerank, ts, ts_present
        self.ix, self.dev = ix, dev
        self.n0 = len(pagerank)

    def row(self, name: str) -> tuple:
        r = self.row_of.get(int(name[1:]), -1)
        if r < 0:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        a, b = int(self.starts[r]), int(self.starts[r + 1])
        return self.docs[a:b].astype(np.int64), self.weights[a:b]

    def dot(self, tokens: dict, boost: float = 1.0) -> tuple:
        """(scores f32[ix.n], docs holding a token): the f32 adds token by
        token on `dev` (a row's docs are distinct: one add a doc)."""
        import torch
        score = torch.zeros(self.ix.n, dtype=torch.float32, device=self.dev)
        hit = torch.zeros(self.ix.n, dtype=torch.bool, device=self.dev)
        for name in sorted(tokens):
            d, w = self.row(name)
            d = torch.from_numpy(d).to(self.dev)
            score.index_add_(0, d, torch.from_numpy(w).to(self.dev)
                             * float(np.float32(tokens[name])))
            hit[d] = True
        if boost != 1.0:
            score = score * float(np.float32(boost))
        return score.cpu().numpy(), hit.cpu().numpy()

    def feature(self, field: str, fn: str, spec: dict) -> tuple:
        """rank_feature over `emb.<token>` or `pagerank`: (scores
        f32[ix.n], docs with the value); the saturation pivot by default
        the arithmetic mean of the values (deleted docs included)."""
        vals = np.zeros(self.ix.n, np.float32)
        has = np.zeros(self.ix.n, bool)
        if field == "pagerank":
            raw = self.pagerank
            vals[:self.n0] = raw.astype(np.float32)
            has[:self.n0] = True
        else:
            d, raw = self.row(field.split(".", 1)[1])
            vals[d] = raw
            has[d] = True
        p = spec.get(fn, {})
        if fn == "saturation":
            p1 = np.float32(p.get("pivot", float(np.mean(raw.astype(
                np.float64)))))
            out = vals / (vals + p1)
        elif fn == "log":
            out = np.log(np.float32(p["scaling_factor"]) + vals)
        elif fn == "sigmoid":
            e = np.float32(p["exponent"])
            we = np.power(np.maximum(vals, np.float32(0)), e)
            pe = np.power(np.float32(p["pivot"]), e)
            out = we / (we + pe)
        else:
            out = vals
        return np.where(has, out, np.float32(0)).astype(np.float32), has

    def distance(self, origin: int, pivot_ms: float) -> tuple:
        """distance_feature on `ts`: pivot / (pivot + d) with d the f32
        distance over the biased (hi, lo) words of the dates."""
        ts = self.ts
        hi, lo = ts >> 32, (ts & 0xFFFFFFFF) - (1 << 31)
        ohi, olo = origin >> 32, (origin & 0xFFFFFFFF) - (1 << 31)
        d = np.abs((hi - ohi).astype(np.int32).astype(np.float32)
                   * np.float32(2.0 ** 32)
                   + (lo.astype(np.int32).astype(np.float32)
                      - np.float32(olo)))
        pv = np.float32(pivot_ms)
        return (np.where(self.ts_present, pv / (pv + d), np.float32(0))
                .astype(np.float32), self.ts_present)


def sp_classes(big: dict, n: int, rng, vq: np.ndarray) -> dict:
    """Phase 17's bodies: class -> [(body, spec)], spec what the brute
    force needs; `vq` the hybrids' kNN query vectors."""
    from opensearch_tpu_torch import bench_corpus as bc
    vs = bc.vocab_strings(len(big["corpus"][4]))
    terms = [list(big["body_terms"][(2 * j + 1) % len(big["body_terms"])])
             for j in range(3 * n)]

    def text(j):
        return " ".join(vs[int(t)] for t in terms[j])
    src = {"_source": {"excludes": ["vec"]}}
    out = {k: [] for k in ("a_pruned", "b_exact", "c_bool", "d_rank_feature",
                           "e_distance", "f_hybrid")}
    for j in range(n):
        toks = sp_query_tokens(rng, SP_VOCAB)
        out["a_pruned"].append(({**src, "size": 10, "query": {
            "neural_sparse": {"emb": {"query_tokens": toks}}}},
            {"kind": "dot", "tokens": toks}))
        toks = sp_query_tokens(rng, SP_VOCAB)
        out["b_exact"].append(({**src, "size": 10, "track_total_hits": True,
                                "query": {"neural_sparse": {"emb": {
                                    "query_tokens": toks}}}},
                               {"kind": "dot", "tokens": toks}))
        toks = sp_query_tokens(rng, SP_VOCAB)
        st = j % 3
        out["c_bool"].append(({**src, "size": 10, "query": {"bool": {
            "must": [{"match": {"body": text(j)}}],
            "filter": [{"term": {"status": bc.STATUS_VALUES[st]}}],
            "should": [{"neural_sparse": {"emb": {"query_tokens": toks}}}]
        }}}, {"kind": "bool", "terms": terms[j], "status": st,
              "tokens": toks}))
        fn, spec = SP_FUNCTIONS[j % 4]
        feat = sp_token(int(rng.integers(100, 2000)))
        out["d_rank_feature"].append(({**src, "size": 10, "query": {"bool": {
            "must": [{"match": {"body": text(n + j)}}],
            "should": [{"rank_feature": dict(field=f"emb.{feat}", **spec)},
                       {"rank_feature": dict(field="pagerank", **spec)}]}}},
            {"kind": "rank", "terms": terms[n + j], "fn": fn, "spec": spec,
             "fields": [f"emb.{feat}", "pagerank"]}))
        out["e_distance"].append(({**src, "size": 10, "query": {"bool": {
            "must": [{"match": {"body": text(2 * n + j)}}],
            "should": [{"distance_feature": {
                "field": "ts", "origin": bc.TS_HI, "pivot": "7d"}}]}}},
            {"kind": "distance", "terms": terms[2 * n + j]}))
        toks = sp_query_tokens(rng, SP_VOCAB)
        fusion = ({"method": "rrf", "window_size": SP_WINDOW} if j % 2 == 0
                  else {"method": "linear", "normalization": "min_max",
                        "window_size": SP_WINDOW})
        q = vq[j]
        out["f_hybrid"].append(({**src, "size": 10, "query": {"hybrid": {
            "queries": [{"match": {"body": text(j)}},
                        {"neural_sparse": {"emb": {"query_tokens": toks}}},
                        {"knn": {"vec": {"vector": q.tolist(), "k": 10,
                                         "exact": True}}}],
            "fusion": fusion}}},
            {"kind": "hybrid", "terms": terms[j], "tokens": toks, "q": q,
             "fusion": fusion}))
    return out


def sp_want(oracle: SparseOracle, ix, body: dict, spec: dict,
            vec_oracle=None) -> tuple:
    """The brute force's page of one body: (ids, scores, total) or, for a
    hybrid, (fused [(key, score)], (lo, hi) of its total)."""
    kind = spec["kind"]
    if kind == "dot":
        sc, hit = oracle.dot(spec["tokens"])
        return ix.page(sc, hit, 0, 10)
    bm, ok = ix.group(spec["terms"])
    ok = ok & ix.live
    if kind == "bool":
        sc, _hit = oracle.dot(spec["tokens"])
        ok = ok & (ix.status == spec["status"])
        return ix.page(bm + sc, ok, 0, 10)
    if kind == "rank":
        total = bm
        for f in spec["fields"]:
            total = total + oracle.feature(f, spec["fn"], spec["spec"])[0]
        return ix.page(total, ok, 0, 10)
    if kind == "distance":
        from opensearch_tpu_torch import bench_corpus as bc
        return ix.page(bm + oracle.distance(bc.TS_HI, 7 * DAY_MS)[0], ok, 0,
                       10)
    # hybrid: the three sub-pages, fused
    mids, msc, mtotal = ix.page(bm, ok, 0, SP_WINDOW)
    sc, hit = oracle.dot(spec["tokens"])
    sids, ssc, stotal = ix.page(sc, hit, 0, SP_WINDOW)
    docs, vsc, vtotal = spec.get("knn_top") or vec_oracle.top(
        [(spec["q"], None, SP_WINDOW)])[0]
    subs = [[(("bench", i), float(s)) for i, s in zip(mids, msc)],
            [(("bench", i), float(s)) for i, s in zip(sids, ssc)],
            [(("bench", ix.id_of(int(g))), float(s))
             for g, s in zip(docs, vsc)]]
    fusion = dict({"weights": [1.0, 1.0, 1.0]}, **spec["fusion"])
    return oracle_fusion(subs, fusion), (0, max(mtotal, stotal, vtotal)), subs


def sp_check(resp: dict, want: tuple, spec: dict, what: str) -> None:
    """A response against `sp_want`'s page: ids, scores within 1e-6
    relative, a pruned total a lower bound; a hybrid's fused page within
    one step of its 7-place rounding (plus a min_max list's score
    rounding over its spread) and its total `gte` within [lo, hi]."""
    if spec["kind"] != "hybrid":
        check_page(resp, want, what, SP_RTOL)
        return
    fused, (lo, hi), subs = want
    atol = 1.5e-7
    if spec["fusion"]["method"] == "linear":
        for lst in subs:
            s = np.asarray([x for _k, x in lst])
            if len(s) and s.max() > s.min():
                atol += 2e-6 * np.abs(s).max() / (s.max() - s.min())
    want_hits = [{"_id": k[1], "_score": s} for k, s in fused[:10]]
    got = [{"_id": h["_id"], "_score": h["_score"]}
           for h in resp["hits"]["hits"]]
    try:
        _same_hits(got, want_hits, (0.0, atol, 0.0), "hits.")
    except AssertionError as e:
        raise AssertionError(f"{what} != the brute force's fusion: {e}")
    t = resp["hits"]["total"]
    if not (t["relation"] == "gte" and lo <= t["value"] <= hi):
        raise AssertionError(f"{what}: hybrid total {t} not in [{lo}, {hi}]")


def sp_timer():
    """CUDA events around the sparse rung's device pass and the general
    path's feature gather / scatter and top-k, host clocks around the
    rung's planning and certificate: -> (restore(), {op: [spans]})."""
    import torch
    from opensearch_tpu_torch.ops import scoring
    from opensearch_tpu_torch.search import impactpath
    spans: dict = {}
    saved = []
    for mod, name, label, dev_timed in (
            (impactpath, "impact_program", "rung_pass", True),
            (scoring, "feature_score", "feature_scatter", True),
            (scoring, "topk_docs", "topk", True),
            (impactpath, "_plan_blocks", "plan_host", False),
            (impactpath, "_exact_scores", "certify_host", False)):
        real = getattr(mod, name)

        def timed(*a, _real=real, _label=label, _dev=dev_timed, **kw):
            if _dev:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = _real(*a, **kw)
                e1.record()
                spans.setdefault(_label, []).append((e0, e1))
                return out
            t0 = time.perf_counter()
            out = _real(*a, **kw)
            spans.setdefault(_label, []).append(
                (time.perf_counter() - t0) * 1e3)
            return out
        setattr(mod, name, timed)
        saved.append((mod, name, real))

    def restore():
        for mod, name, real in saved:
            setattr(mod, name, real)
    return restore, spans


def sp_postings(oracle: SparseOracle, tokens: dict) -> int:
    return sum(len(oracle.row(t)[0]) for t in tokens)


def run_sp_class(client, name: str, items, cpu=None, cpu_body=None) -> dict:
    """One class body by body through RestClient.search, the counts set to
    0 just before: bodies/s, p50 / p99, the ops' event ms and host ms a
    body, the sparse rung's counts, B1 / B2 launches; then one body on
    the card against the CPU twin (`cpu_body`, the class's first body by
    default): -> the class's numbers, its responses under "resps"."""
    import torch
    from opensearch_tpu_torch.ops import bm25
    from opensearch_tpu_torch.search import impactpath
    bodies = [b for b, _s in items]
    torch.cuda.synchronize()
    impactpath.reset_stats()
    bm25.reset_counts()
    restore, spans = sp_timer()
    lat = []
    t0 = time.perf_counter()
    try:
        resps = []
        for b in bodies:
            t1 = time.perf_counter()
            resps.append(client.search("bench", b))
            lat.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
    finally:
        restore()
    wall = time.perf_counter() - t0
    ms = {k: sum(s if isinstance(s, float) else s[0].elapsed_time(s[1])
                 for s in v) / len(bodies) for k, v in spans.items()}
    counts = {**{k: v for k, v in impactpath.STATS.items()
                 if k.startswith("sparse_")},
              **{k: bm25.COUNTS[k] for k in ("launches", "impact_launches",
                                             "bool_launches",
                                             "plain_calls")}}
    t_cpu = 0.0
    if cpu is not None:
        body = cpu_body or bodies[0]
        t0 = time.perf_counter()
        want = cpu.search("bench", body)
        t_cpu = time.perf_counter() - t0
        got = resps[0] if cpu_body is None else client.search("bench", body)
        same_vec(got, want, (SP_RTOL, 1.5e-7, 0.0),
                 f"{name} card vs CPU: ")
    out = {"bodies": len(bodies), "wall_s": wall,
           "bodies_per_s": len(bodies) / wall,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)), "first_ms": lat[0],
           "ms_a_body": ms, "counts": counts, "cpu_s": t_cpu,
           "resps": resps}
    if len(lat) > 1:
        out["bodies_per_s_after_first"] = (len(lat) - 1) / (sum(lat[1:])
                                                           / 1e3)
    log(f"  {name}: {len(bodies)} bodies in {wall:.2f}s "
        f"({out['bodies_per_s']:.1f}/s) p50 {out['p50_ms']:.1f} p99 "
        f"{out['p99_ms']:.1f} ms, first {lat[0]:.1f} ms; ms a body "
        + " ".join(f"{k}={v:.3f}" for k, v in sorted(ms.items()))
        + f"; counts {counts}" + (f"; one body card == CPU ({t_cpu:.1f}s)"
                                  if cpu is not None else ""))
    return out


def sp_attach(big: dict, seed: int) -> dict:
    """Phase 17's data drawn on the card, its CSR built there and copied
    to the host, attached to the corpus segment as the `emb` field (a
    PostingsBlock with its FEATURE plane) and the `pagerank` column, the
    mapping put: -> the timings, bytes and the oracle's arrays."""
    import torch
    from opensearch_tpu_torch.index.segment import (
        NumericColumn, PostingsBlock, build_feature_impact_plane)
    client, seg = big["client"], big["seg"]
    dev = client.device

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
    n0 = seg.ndocs
    sync()
    t0 = time.perf_counter()
    tok, w, pagerank = sparse_draw(n0, seed, dev)
    sync()
    t_draw = time.perf_counter() - t0
    t0 = time.perf_counter()
    token_ids, starts, docs, weights = sparse_csr(tok, w)
    del tok, w
    pr = pagerank.cpu().numpy()
    del pagerank
    t_csr = time.perf_counter() - t0
    vocab = [sp_token(int(t)) for t in token_ids]
    pb = PostingsBlock("emb", vocab, {t: i for i, t in enumerate(vocab)},
                       starts, docs, weights, feature=True)
    t0 = time.perf_counter()
    pb.impact = build_feature_impact_plane(pb, device=dev)
    t_plane = time.perf_counter() - t0
    seg.postings["emb"] = pb
    seg.numeric_cols["pagerank"] = NumericColumn("pagerank", "float", pr,
                                                 np.ones(n0, bool))
    client.indices.put_mapping("bench", SP_MAPPING)
    return {"draw_s": t_draw, "csr_s": t_csr, "plane_s": t_plane,
            "postings": int(pb.size), "rows": len(vocab),
            "plane_bytes": int(pb.impact.nbytes),
            "csr_host_bytes": int(docs.nbytes + weights.nbytes),
            "arrays": (token_ids, starts, docs, weights, pr)}


def sp_oracle(big: dict, arrays) -> SparseOracle:
    """The brute force over phase 17's arrays and every doc's date (the
    corpus's `ts` column, then the docs indexed later)."""
    ix = big["ix"]
    token_ids, starts, docs, weights, pr = arrays
    ts_c, _rating, _present = big["aggs"]
    ts_l, _r, has_l = ix.later_arrays()
    ts = np.concatenate([ts_c.astype(np.int64), ts_l])
    present = np.concatenate([np.ones(len(ts_c), bool), has_l])
    return SparseOracle(token_ids, starts, docs, weights, pr, ts, present,
                        ix, big["client"].device)


def phase_sparse_msmarco(big: dict, n: int, seed: int) -> dict:
    """Phase 17 on phase 16's end state: a `rank_features` field `emb`
    with index_impacts (64 distinct tokens a passage over SP_VOCAB,
    Zipf(1.1), drawn and made CSR on the card, its FEATURE plane
    quantized there) and a `pagerank` rank_feature column attached to
    the corpus segment; `n` bodies a class of (a) neural_sparse on the
    pruned sparse rung, (b) the same with exact totals, (c) neural_sparse
    in a bool with a match and a status filter (the general path's
    sparse dot), (d) a match with rank_feature shoulds (each function,
    over a feature and the column), (e) a match with a distance_feature
    on `ts`, (f) a hybrid of a match, a neural_sparse and an exact kNN
    (rrf, linear min_max); every page against SparseOracle, one body a
    class card == CPU (class (f)'s a hybrid of its match and
    neural_sparse: a kNN on the CPU twin needs a second unit-normed copy
    of the 27 GB of vectors in host memory)."""
    import torch
    from opensearch_tpu_torch.search import impactpath
    client, seg, ix = big["client"], big["seg"], big["ix"]
    dev = client.device
    eng = client._indices["bench"].engine
    if seg not in eng.segments or not np.array_equal(seg.live,
                                                     ix.live[:seg.ndocs]):
        raise AssertionError("phase 17: the corpus segment or its live docs "
                             "differ from the brute force's")
    drop_cpu_state(eng.segments)
    trim_host()
    torch.cuda.synchronize()
    bytes0 = torch.cuda.memory_allocated(dev)
    rss0 = rss_bytes()
    rss_watch = RssPeak().__enter__()
    att = sp_attach(big, seed)
    arrays = att.pop("arrays")
    torch.cuda.synchronize()
    log(f"  emb: {att['postings']} postings over {att['rows']} tokens "
        f"({SP_TOKENS} distinct a passage, Zipf({SP_ZIPF}) over {SP_VOCAB}) "
        f"drawn on the card in {att['draw_s']:.1f}s, CSR built there and "
        f"copied to the host in {att['csr_s']:.1f}s ({att['csr_host_bytes']}"
        f" bytes), FEATURE plane {att['plane_s']:.1f}s ({att['plane_bytes']}"
        f" bytes); host RSS {rss0} at the phase's start, now / peak "
        f"{rss_bytes()}")
    t0 = time.perf_counter()
    pb = seg.postings["emb"]
    sample = np.random.default_rng([seed, 18]).choice(pb.nterms, 200,
                                                      replace=False)
    sp_plane_check(pb, "phase 17", rows=np.concatenate([[0, 1], sample]))
    log(f"  the FEATURE plane == its numpy form on 202 rows, the two "
        f"largest among them ({time.perf_counter() - t0:.1f}s)")
    oracle = sp_oracle(big, arrays)
    # the vectors drawn again on the card from phase 16's seed (faster
    # than uploading the host's 27 GB)
    vec_oracle = VecOracle(None, ix, dev, n0=seg.ndocs,
                           seed=big["vec"]["seed"])
    vq = vec_query_vectors(seg.vector_cols["vec"].values, ix.live[:seg.ndocs],
                           n, seed + 1)
    classes = sp_classes(big, n, np.random.default_rng([seed, 17]), vq)
    # the hybrids' kNN sub-pages in one pass over the vectors
    hyb = [s for _b, s in classes["f_hybrid"]]
    for s, top in zip(hyb, vec_oracle.top([(s["q"], None, SP_WINDOW)
                                           for s in hyb])):
        s["knn_top"] = top
    cpu = twin_of(eng)
    cpu.indices.put_mapping("bench", SP_MAPPING)
    cpu.indices.put_mapping("bench", VEC_PUT_MAPPING)
    out: dict = {"build": att, "classes": {}}
    for name, items in classes.items():
        cpu_body = None
        if name == "f_hybrid":
            q = items[0][0]["query"]["hybrid"]
            cpu_body = {**items[0][0], "query": {"hybrid": {
                "queries": q["queries"][:2], "fusion": q["fusion"]}}}
        r = run_sp_class(client, f"({name[0]}) {name[2:]}", items, cpu,
                         cpu_body)
        resps = r.pop("resps")
        t0 = time.perf_counter()
        for j, ((body, spec), resp) in enumerate(zip(items, resps)):
            sp_check(resp, sp_want(oracle, ix, body, spec, vec_oracle),
                     spec, f"phase 17 {name} {j}")
        r["oracle_s"] = time.perf_counter() - t0
        if items[0][1]["kind"] in ("dot", "bool", "hybrid"):
            posts = [sp_postings(oracle, s["tokens"]) for _b, s in items]
            r["token_postings_a_body"] = float(np.mean(posts))
        out["classes"][name] = r
    a = out["classes"]["a_pruned"]
    if not a["counts"]["sparse_served"] \
            or not a["counts"]["sparse_blocks_skipped"]:
        raise AssertionError(f"phase 17: class (a) skipped no block on the "
                             f"sparse rung: {a['counts']}")
    if out["classes"]["b_exact"]["counts"]["sparse_blocks_skipped"]:
        raise AssertionError("phase 17: class (b) pruned")
    # byte bounds at 3.35 TB/s: the rung reads 4 + 2 bytes a kept posting;
    # the general path's gather 8 bytes a posting and writes the f32
    # scores and counts; the top-k reads the scores and the live mask
    nd = seg.ndocs
    kept = (a["counts"]["sparse_postings_total"]
            - a["counts"]["sparse_postings_skipped"]) / a["bodies"]
    c = out["classes"]["c_bool"]
    out["bounds_ms"] = {
        "rung_pass_a": (kept * 6 + 8 * nd) / HBM_BYTES_PER_S * 1e3,
        "feature_scatter_c": (c["token_postings_a_body"] * 8 + 8 * nd)
        / HBM_BYTES_PER_S * 1e3,
        "topk": 5 * nd / HBM_BYTES_PER_S * 1e3}
    torch.cuda.synchronize()
    out["device_bytes"] = torch.cuda.memory_allocated(dev) - bytes0
    rss_watch.__exit__()
    out["rss_start"], out["rss_end"] = rss0[0], rss_bytes()[0]
    out["rss_peak"] = rss_watch.peak
    f = out["classes"]["f_hybrid"]["counts"]
    out["hybrid_launches"] = {k: f[k] for k in ("launches",
                                                "impact_launches")}
    log(f"  bounds at 3.35 TB/s: rung pass (a) "
        f"{out['bounds_ms']['rung_pass_a']:.4f} ms ({kept:.0f} kept "
        f"postings a body), feature gather / scatter (c) "
        f"{out['bounds_ms']['feature_scatter_c']:.4f} ms, top-k "
        f"{out['bounds_ms']['topk']:.4f} ms; device bytes {out['device_bytes']}"
        f"; B1 / B2 launches of the hybrids {out['hybrid_launches']}; host "
        f"RSS start {out['rss_start']}, end {out['rss_end']}, the phase's "
        f"peak {out['rss_peak']}, the process's {rss_bytes()[1]}")
    drop_cpu_state(eng.segments)
    # the oracle's CSR goes (host memory for phase 8's merge): the merged
    # classes draw it again from the seed
    for _b, s in classes["f_hybrid"]:
        s.pop("knn_top")
    big["sparse"] = {"classes": classes, "seed": seed}
    impactpath.reset_stats()
    return out


def phase_sparse_merged(big: dict) -> dict:
    """Phase 8's merged segment: its FEATURE plane rebuilt by the merge
    against its numpy form, the merged `emb` rows against the live
    passages' rows, and one body of classes (a), (c) and (f) against the
    brute force."""
    import torch
    client, ix = big["client"], big["ix"]
    eng = client._indices["bench"].engine
    (merged,) = eng.segments
    pb = merged.postings["emb"]
    t0 = time.perf_counter()
    tok, w, pagerank = sparse_draw(big["vec"]["n0"], big["sparse"]["seed"],
                                   client.device)
    arrays = sparse_csr(tok, w) + (pagerank.cpu().numpy(),)
    del tok, w, pagerank
    oracle = sp_oracle(big, arrays)
    t_draw = time.perf_counter() - t0
    t0 = time.perf_counter()
    sample = np.random.default_rng(19).choice(pb.nterms, 200, replace=False)
    sp_plane_check(pb, "merged", rows=np.concatenate([[0, 1], sample]))
    live_g = np.flatnonzero(ix.live)
    new_of = np.full(ix.n, -1, np.int64)
    new_of[live_g] = np.arange(len(live_g))
    for name in (sp_token(0), sp_token(57), sp_token(4321)):
        d, w = oracle.row(name)
        keep = ix.live[d]
        a, b = pb.row_slice(pb.row(name))
        if not (np.array_equal(pb.doc_ids[a:b], new_of[d[keep]])
                and np.array_equal(pb.tfs[a:b], w[keep])):
            raise AssertionError(f"merged emb row {name} != the live "
                                 f"passages'")
    t_check = time.perf_counter() - t0
    classes = big["sparse"]["classes"]
    vec_oracle = VecOracle(None, ix, client.device, n0=big["vec"]["n0"],
                           seed=big["vec"]["seed"])
    out = {"classes": {}, "check_s": t_check, "redraw_s": t_draw}
    for name in ("a_pruned", "c_bool", "f_hybrid"):
        items = classes[name][:1]
        r = run_sp_class(client, f"({name[0]}) {name[2:]}, merged", items)
        for (body, spec), resp in zip(items, r.pop("resps")):
            sp_check(resp, sp_want(oracle, ix, body, spec, vec_oracle),
                     spec, f"merged {name}")
        out["classes"][name] = r
    if not out["classes"]["a_pruned"]["counts"]["sparse_served"]:
        raise AssertionError("merged: class (a) not on the sparse rung")
    c = out["classes"]["f_hybrid"]["counts"]
    log(f"  merged: the brute force's CSR drawn again from the seed "
        f"({t_draw:.1f}s); FEATURE plane == numpy on 202 rows, 3 rows == the "
        f"live passages' ({t_check:.1f}s); 3 pages == the brute force; the hybrid's B1 / "
        f"B2 launches {c['launches']} / {c['impact_launches']}")
    torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------
# phase 18: text analysis and the scalar field types (small beside phase
# 4, then at MS MARCO passage scale on phase 17's end state)
# ---------------------------------------------------------------------

FT_ANALYSIS = {
    "char_filter": {
        "amp": {"type": "mapping", "mappings": ["& => and", "ph => f"]},
        "nums": {"type": "pattern_replace", "pattern": "(\\d+)",
                 "replacement": "n$1"}},
    "tokenizer": {
        "dash": {"type": "pattern", "pattern": "[-\\s/]+"},
        "caps": {"type": "pattern", "pattern": "([a-z]+)", "group": 1},
        "grams": {"type": "ngram", "min_gram": 2, "max_gram": 3},
        "edges": {"type": "edge_ngram", "min_gram": 1, "max_gram": 4}},
    "filter": {
        "short": {"type": "length", "min": 2, "max": 30},
        "syn": {"type": "synonym", "synonyms": ["fox, tod",
                                                "quick => fast"]},
        "kw": {"type": "keyword_marker", "keywords": ["running"]},
        "ovr": {"type": "stemmer_override", "rules": ["dogs => hound"]},
        "shing": {"type": "shingle", "max_shingle_size": 3},
        "cut": {"type": "truncate", "length": 6},
        "lim": {"type": "limit", "max_token_count": 50},
        "wd": {"type": "word_delimiter_graph", "catenate_words": True},
        "cap": {"type": "pattern_capture", "patterns": ["(\\d+)"]},
        "el": {"type": "elision"},
        "ng": {"type": "ngram", "min_gram": 3, "max_gram": 4},
        "eg": {"type": "edge_ngram", "min_gram": 2, "max_gram": 5},
        "stop_en": {"type": "stop"},
        "ph": {"type": "phonetic", "encoder": "metaphone"},
        "tr": {"type": "icu_transform", "id": "Any-Latin"}},
    "analyzer": {
        "chain": {"type": "custom",
                  "char_filter": ["html_strip", "amp", "nums"],
                  "tokenizer": "dash",
                  "filter": ["el", "lowercase", "asciifolding", "short",
                             "kw", "ovr", "syn", "porter_stem", "unique",
                             "lim"]},
        "grams": {"tokenizer": "grams", "filter": ["lowercase"]},
        "edges": {"tokenizer": "edges"},
        "caps": {"tokenizer": "caps", "filter": ["uppercase", "reverse",
                                                 "trim"]},
        "shingles": {"tokenizer": "whitespace",
                     "filter": ["lowercase", "stop_en", "shing"]},
        "parts": {"tokenizer": "whitespace",
                  "filter": ["wd", "cap", "decimal_digit", "apostrophe",
                             "cut"]},
        "sub": {"tokenizer": "letter", "filter": ["lowercase", "ng", "eg"]},
        "sounds": {"tokenizer": "lowercase", "filter": ["ph"]},
        "intl": {"tokenizer": "standard",
                 "filter": ["tr", "icu_folding", "cjk_width", "cjk_bigram",
                            "stemmer", "polish_stem", "ukrainian_stem"]},
        "keyword_ws": {"tokenizer": "keyword", "filter": ["trim"]}},
    "normalizer": {"fold": {"type": "custom",
                            "char_filter": ["amp"],
                            "filter": ["lowercase", "asciifolding"]}}}
FT_LANGS = ("english", "cjk", "kuromoji", "nori", "icu_analyzer", "polish",
            "ukrainian")
FT_SMALL_MAPPING = {"settings": {"analysis": FT_ANALYSIS}, "mappings": {
    "dynamic_templates": [{"dyn_kw": {"match": "dyn_*",
                                      "mapping": {"type": "keyword"}}}],
    "properties": {
        **{f"t_{lang}": {"type": "text", "analyzer": lang}
           for lang in FT_LANGS},
        "title": {"type": "text", "analyzer": "english", "copy_to": "all"},
        "all": {"type": "text"},
        "body": {"type": "text", "analyzer": "chain"},
        "tag": {"type": "keyword", "normalizer": "fold",
                "null_value": "none", "store": True},
        "addr": {"type": "ip", "store": True},
        "stock": {"type": "short", "null_value": 0},
        "grade": {"type": "byte"},
        "hf": {"type": "half_float"},
        "price": {"type": "scaled_float", "scaling_factor": 100,
                  "store": True},
        "views": {"type": "unsigned_long"},
        "ntok": {"type": "token_count", "analyzer": "standard"},
        "shop": {"type": "constant_keyword", "value": "acme"},
        "coll": {"type": "icu_collation_keyword", "strength": "primary"},
        "mot": {"type": "match_only_text"},
        "sayt": {"type": "search_as_you_type"},
        "blob": {"type": "binary"},
        "price_alias": {"type": "alias", "path": "price"}}}}
FT_WORDS = {
    "english": ["running", "runs", "ran", "foxes", "jumped", "lazy", "dogs",
                "the", "a", "of", "kennels", "shoes", "john's", "quickly"],
    "cjk": ["北京大学", "博物馆", "中文", "东京都", "ＡＢＣ"],
    "kuromoji": ["東京都の", "観光案内所", "カタカナ", "ひらがなを"],
    "nori": ["한국어를", "학생들이", "서울에서", "공부하는"],
    "icu_analyzer": ["Café", "Résumé", "ＦＵＬＬ", "straße", "naïve"],
    "polish": ["książkami", "domach", "kotów", "zażółć", "i"],
    "ukrainian": ["книжками", "будинках", "українського", "і"]}
FT_SMALL_DOCS = 8000


def ft_small_docs(rng, n: int) -> list:
    """Phase 4's field-type docs: a text per language analyzer, an
    english title with at least one word that is not a stopword, the
    custom chain's HTML body, every scalar type (some values missing or
    null, an ip array every 17th doc), a dynamic `dyn_` string."""
    en = FT_WORDS["english"]
    docs = []
    for i in range(n):
        d = {f"t_{lang}": " ".join(rng.choice(FT_WORDS[lang], 3))
             for lang in FT_LANGS}
        d["title"] = " ".join([str(rng.choice(en[:7]))]
                              + list(rng.choice(en, int(rng.integers(1, 5)))))
        d.update({
            "body": "<p>" + "-".join(rng.choice(en, 3)) + f"</p> & ph{i % 7}",
            "tag": (None if i % 7 == 0
                    else str(rng.choice(["Café", "CAFE", "tea", "T&ea"]))),
            "addr": f"10.{i % 4}.{(i // 4) % 8}.{i % 250}",
            "stock": None if i % 11 == 0 else int(rng.integers(-300, 300)),
            "grade": int(rng.integers(-100, 100)),
            "hf": float(rng.random()),
            "price": float(rng.random() * 100),
            "views": int(rng.integers(0, 1 << 62))
            + ((1 << 63) if i % 3 == 0 else 0),
            "ntok": " ".join(rng.choice(en, int(rng.integers(1, 6)))),
            "coll": str(rng.choice(["Apple", "apple", "Äpple", "banana"])),
            "mot": " ".join(rng.choice(en, 5)),
            "sayt": " ".join(rng.choice(en, 4)),
            "blob": "aGVsbG8=",
            "dyn_x": f"v{i % 4}"})
        if i % 13 == 0:
            for f in ("addr", "price", "views", "mot", "grade"):
                del d[f]
        if i % 17 == 0:
            d["addr"] = [d.get("addr", "10.9.9.9"), "192.168.0.1"]
        docs.append(d)
    return docs


FT_SMALL_BODIES = [
    {"query": {"term": {"addr": "10.1.1.1"}}},
    {"query": {"term": {"addr": "10.1.0.0/16"}}},
    {"query": {"terms": {"addr": ["10.2.0.0/16", "192.168.0.1"]}}},
    {"query": {"range": {"addr": {"gte": "10.1.0.0", "lt": "10.3.0.0"}}}},
    {"query": {"term": {"stock": 0}}},
    {"query": {"range": {"stock": {"gte": -10, "lte": 100}}}},
    {"query": {"range": {"grade": {"gt": 50}}}},
    {"query": {"range": {"price": {"gte": 10.5, "lte": 60}}}},
    {"query": {"range": {"views": {"gte": 1 << 63}}}},
    {"query": {"exists": {"field": "views"}}},
    {"query": {"match": {"title": "running foxes"}}},
    {"query": {"match": {"title": "runs dogs"}}, "track_total_hits": True},
    {"query": {"match": {"t_polish": "książki"}}},
    {"query": {"match": {"t_kuromoji": "観光"}}},
    {"query": {"match": {"body": "running fast"}}},
    {"query": {"match_phrase": {"title": "lazy dogs"}}},
    {"query": {"match_phrase": {"mot": "lazy dogs"}}},
    {"query": {"term": {"tag": "CAFÉ"}}},
    {"query": {"term": {"coll": "APPLE"}}},
    {"query": {"term": {"dyn_x": "v1"}}},
    {"query": {"multi_match": {"query": "quick fo", "type": "bool_prefix",
                               "fields": ["sayt", "sayt._2gram",
                                          "sayt._3gram"]}}},
    {"query": {"bool": {"must": [{"match": {"title": "running"}}],
                        "filter": [{"term": {"addr": "10.0.0.0/16"}},
                                   {"range": {"stock": {"gte": 0}}}]}}},
    {"query": {"match": {"title": "dogs"}}, "sort": [{"views": "desc"}],
     "docvalue_fields": ["addr", "views", "price", "stock"]},
    {"query": {"match": {"title": "dogs"}}, "stored_fields": ["tag",
                                                              "price"]},
    {"size": 0, "aggs": {
        "r": {"ip_range": {"field": "addr", "ranges": [
            {"to": "10.1.0.0"}, {"from": "10.1.0.0"},
            {"mask": "10.2.0.0/16"}]}},
        "t": {"terms": {"field": "addr"}},
        "s": {"stats": {"field": "price"}},
        "c": {"terms": {"field": "coll"}}}},
]


def ft_small_analyze() -> list:
    """indices.analyze bodies: every analyzer of FT_ANALYSIS and every
    language analyzer on the index, a field, the built-ins without an
    index."""
    text = ("<b>John's</b> Running-dogs & ph 42 quickly Café "
            "北京大学 한국어를 książkami українського")
    out = [("ft", {"analyzer": a, "text": text}) for a in FT_ANALYSIS[
        "analyzer"]]
    out += [("ft", {"analyzer": lang, "text": text}) for lang in FT_LANGS]
    out += [("ft", {"field": "tag", "text": "T&ea Café"}),
            ("ft", {"field": "sayt._index_prefix", "text": "quick fox"}),
            (None, {"analyzer": "english", "text": [text, "the foxes"]})]
    return out


def ft_same(got, want, body, what: str) -> None:
    """Card == CPU: equal apart from `took`, but for an aggregation's
    f32 sums, which the card and the CPU add in other orders (within
    1e-4 relative, as phase 10 holds them)."""
    if body is not None and "aggs" in body:
        same_vec(strip_took(got), strip_took(want), (1e-4, 0.0, 0.0),
                 what + ": ")
    elif strip_took(got) != strip_took(want):
        raise AssertionError(f"{what}: card != CPU")


def ft_small_run(name: str, docs, bodies) -> tuple:
    """Phase 4's field-type index on `name`: two refreshes, deletes,
    `bodies` and the analyze calls, then a forcemerge and the bodies
    again: -> (responses before, after, analyze responses, parse s)."""
    from opensearch_tpu_torch import RestClient
    c = RestClient(device=name)
    c.indices.create("ft", json.loads(json.dumps(FT_SMALL_MAPPING)))
    t0 = time.perf_counter()
    cut = len(docs) * 5 // 8
    for a, b in ((0, cut), (cut, len(docs))):
        bulk_checked(c, sum([[{"index": {"_index": "ft", "_id": f"d{i}"}},
                              docs[i]] for i in range(a, b)], []), "index",
                     {"created": 201})
        c.indices.refresh("ft")
    t_bulk = time.perf_counter() - t0
    bulk_checked(c, [{"delete": {"_index": "ft", "_id": f"d{i}"}}
                     for i in range(0, len(docs), 97)], "delete",
                 {"deleted": 200})
    c.indices.refresh("ft")
    before = [c.search("ft", json.loads(json.dumps(b))) for b in bodies]
    analyzed = [c.indices.analyze(ix, b) for ix, b in ft_small_analyze()]
    c.indices.forcemerge("ft")
    after = [c.search("ft", json.loads(json.dumps(b))) for b in bodies]
    return before, after, analyzed, t_bulk


class FtSmallOracle:
    """The small phase's brute force over the docs themselves: which live
    docs hold each value, BM25 (f32, the port's per-term order) of a
    `match` over the english analyzer's terms with the index statistics
    (deleted docs count until the merge drops them)."""

    def __init__(self, docs, deleted):
        from opensearch_tpu_torch.analysis import AnalysisRegistry
        from opensearch_tpu_torch.index.mappings import ip_to_int
        self.n = len(docs)
        self.live = np.ones(self.n, bool)
        self.live[list(deleted)] = False
        self.en = AnalysisRegistry().get("english")
        self.title = [self.en.terms(d["title"]) for d in docs]
        self.dl = np.asarray([len(t) for t in self.title], np.float32)

        def ips(d):
            v = d.get("addr")
            return [ip_to_int(x) for x in (v if isinstance(v, list)
                                           else [v] if v else [])]
        self.addr = [ips(d) for d in docs]
        self.stock = np.asarray([d["stock"] if d.get("stock") is not None
                                 else 0 for d in docs], np.int64)
        self.price = [d.get("price") for d in docs]
        self.views = [d.get("views") for d in docs]

    def ids(self, mask) -> list:
        return [f"d{i}" for i in np.flatnonzero(mask & self.live)]

    def match_page(self, terms, merged: bool, size: int = 10) -> tuple:
        import math
        counted = self.live if merged else np.ones(self.n, bool)
        n = int(counted.sum())
        avgdl = np.float32(self.dl[counted].sum()
                           / (counted & (self.dl > 0)).sum())
        score = np.zeros(self.n, np.float32)
        hit = np.zeros(self.n, bool)
        for t in dict.fromkeys(terms):
            tf = np.asarray([toks.count(t) for toks in self.title],
                            np.float32)
            has = (tf > 0) & counted
            df = int(has.sum())
            if not df:
                continue
            w = np.float32(math.log(1.0 + (n - df + 0.5) / (df + 0.5)))
            c = (w * tf) / (tf + K1 * (OMB + (B * self.dl) / avgdl))
            score = np.where(has, score + c, score).astype(np.float32)
            hit |= has
        docs = np.flatnonzero(hit & self.live)
        order = np.lexsort((docs, -score[docs]))[:size]
        return ([f"d{i}" for i in docs[order]],
                score[docs[order]].tolist(), len(docs))


def ft_small_check(oracle: FtSmallOracle, resps, merged: bool) -> int:
    """Pages of FT_SMALL_BODIES against the brute force: the filter
    bodies' totals and first pages (constant scores: doc order), the
    english matches' pages, the sort's order and docvalue_fields, the
    ip_range counts: -> bodies checked."""
    from opensearch_tpu_torch.index.mappings import ip_to_int
    checked = 0
    pages = {0: lambda a: ip_to_int("10.1.1.1") in a,
             # a CIDR or range reads the column: the first value
             1: lambda a: any(ip_to_int("10.1.0.0") <= x
                              <= ip_to_int("10.1.255.255") for x in a[:1]),
             3: lambda a: any(ip_to_int("10.1.0.0") <= x
                              < ip_to_int("10.3.0.0") for x in a[:1])}
    for i, pred in pages.items():
        mask = np.asarray([pred(a) for a in oracle.addr])
        want = oracle.ids(mask)
        h = resps[i]["hits"]
        if h["total"]["value"] != len(want) or [
                x["_id"] for x in h["hits"]] != want[:10]:
            raise AssertionError(f"fields small body {i} != brute force")
        checked += 1
    mask = (oracle.stock >= -10) & (oracle.stock <= 100)
    if resps[5]["hits"]["total"]["value"] != len(oracle.ids(mask)):
        raise AssertionError("fields small: short range != brute force")
    vmask = np.asarray([v is not None and v >= 1 << 63
                        for v in oracle.views])
    if resps[8]["hits"]["total"]["value"] != len(oracle.ids(vmask)):
        raise AssertionError("fields small: unsigned_long range != brute "
                             "force")
    checked += 2
    for i, text in ((10, "running foxes"), (11, "runs dogs")):
        check_page(resps[i], oracle.match_page(oracle.en.terms(text),
                                               merged),
                   f"fields small match {i}")
        checked += 1
    # the sort: the matching live docs by views desc, missing last
    match = np.asarray(["dog" in t for t in oracle.title]) & oracle.live
    key = [(-(v if v is not None else -1), j) for j, v in
           enumerate(oracle.views)]
    order = sorted(np.flatnonzero(match), key=lambda j: key[j])[:10]
    got = resps[22]["hits"]["hits"]
    if [x["_id"] for x in got] != [f"d{j}" for j in order] or any(
            x["fields"].get("views") != [oracle.views[j]]
            for x, j in zip(got, order) if oracle.views[j] is not None):
        raise AssertionError("fields small: the views sort != brute force")
    buckets = resps[24]["aggregations"]["r"]["buckets"]
    bounds = [(None, "10.1.0.0"), ("10.1.0.0", None),
              ("10.2.0.0", "10.3.0.0")]
    for bk, (lo, hi) in zip(buckets, bounds):
        lo_i = ip_to_int(lo) if lo else -1
        hi_i = ip_to_int(hi) if hi else 1 << 64
        want = sum(1 for j in np.flatnonzero(oracle.live)
                   if any(lo_i <= x < hi_i for x in oracle.addr[j][:1]))
        if bk["doc_count"] != want:
            raise AssertionError(f"fields small: ip_range {bk} != {want}")
    if resps[24]["aggregations"]["t"]["buckets"]:
        raise AssertionError("fields small: terms on an ip has buckets")
    return checked + 2


def phase_fields_small(rng) -> dict:
    """Phase 4's text analysis and field types: FT_SMALL_DOCS docs bulk-
    indexed through the write path on the card and on the CPU into an
    index with every language analyzer but smartcn (jieba: not on the
    card's machine), custom char filters, tokenizers, token filters and
    a normalizer, every scalar type of the slice, store / copy_to /
    null_value and a dynamic template; two refreshes, deletes, the
    bodies and analyze calls, a forcemerge, the bodies again: card ==
    CPU (exact; an aggregation's f32 sums within 1e-4 relative), pages
    against FtSmallOracle."""
    docs = ft_small_docs(rng, FT_SMALL_DOCS)
    t0 = time.perf_counter()
    out = {name: ft_small_run(name, docs, FT_SMALL_BODIES)
           for name in ("cuda", "cpu")}
    for part in (0, 1, 2):
        for i, (g, w) in enumerate(zip(out["cuda"][part], out["cpu"][part])):
            ft_same(g, w, FT_SMALL_BODIES[i] if part < 2 else None,
                    f"fields small: part {part} body {i}")
    oracle = FtSmallOracle(docs, range(0, len(docs), 97))
    n = ft_small_check(oracle, out["cuda"][0], merged=False)
    n += ft_small_check(oracle, out["cuda"][1], merged=True)
    log(f"  fields, small: {len(docs)} docs ({len(FT_LANGS)} language "
        f"analyzers, {len(FT_ANALYSIS['analyzer'])} custom analyzers, a "
        f"normalizer, 13 field types, store / copy_to / null_value, a "
        f"dynamic template), {len(FT_SMALL_BODIES)} bodies and "
        f"{len(out['cuda'][2])} analyze calls card == CPU before and after "
        f"a forcemerge; {n} pages == the brute force; bulk + refresh "
        f"{out['cuda'][3]:.1f}s on the card's client, "
        f"{out['cpu'][3]:.1f}s on the CPU's "
        f"({time.perf_counter() - t0:.1f}s)")
    res = {"docs": len(docs), "bodies": len(FT_SMALL_BODIES),
           "analyze_calls": len(out["cuda"][2]), "pages_checked": n,
           "bulk_refresh_s": out["cuda"][3],
           "host_ms_a_doc": out["cuda"][3] / len(docs) * 1e3}
    del oracle, out
    # the two clients' heap back to the OS before phase 5's draws land
    trim_host()
    return res


FT_MAPPING = {"properties": {
    "title_en": {"type": "text", "analyzer": "english"},
    "client_ip": {"type": "ip"}, "stock": {"type": "short"},
    "grade": {"type": "byte"},
    "price_scaled": {"type": "scaled_float", "scaling_factor": 100},
    "views": {"type": "unsigned_long"},
    "shop": {"type": "constant_keyword", "value": "acme"}}}
FT_SUBNET = "172.18.0.0/16"           # class (c)'s CIDR filter
FT_RANGES = [{"to": "172.17.0.0"}, {"mask": "172.16.0.0/14"},
             {"from": "172.20.0.0", "to": "172.24.0.0"},
             {"key": "rest", "from": "172.24.0.0"}]


def sync(dev) -> None:
    """Wait for the card when `dev` is one."""
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def en_remap(title: tuple, forms: list, analyzer, dev) -> dict:
    """The title's tokens under the english analyzer, remapped on `dev`:
    each title term's surface form analyzed once (a stopword drops out,
    forms that share a stem share a row); the passages' tokens rebuilt
    from the title draw, remapped, stopwords removed (positions keep
    their gaps, a doc's length counts the kept tokens), sorted by (row,
    doc, position) and cut into postings: -> the CSR arrays on the host
    and the timings."""
    import torch
    tstarts, _d, _t, _ps, _p, first, second, _pc, draw = title
    t0 = time.perf_counter()
    analyzed = [analyzer.terms(f) for f in forms]
    if any(len(a) > 1 for a in analyzed):
        raise AssertionError("a title form analyzed to several tokens")
    vocab = sorted({a[0] for a in analyzed if a})
    row_of = {t: i for i, t in enumerate(vocab)}
    remap = np.asarray([row_of[a[0]] if a else -1 for a in analyzed],
                       np.int64)
    t_analyze = time.perf_counter() - t0
    sync(dev)
    t0 = time.perf_counter()
    n = draw.shape[0]
    pr = torch.from_numpy(draw.astype(np.int64)).to(dev)
    tok = torch.empty((n, 8), dtype=torch.int64, device=dev)
    tok[:, 0::2] = torch.from_numpy(first).to(dev)[pr]
    tok[:, 1::2] = torch.from_numpy(second).to(dev)[pr]
    del pr
    new = torch.from_numpy(remap).to(dev)[tok]
    del tok
    keep = new >= 0
    dl = keep.sum(1)
    doc = torch.arange(n, dtype=torch.int64, device=dev)[:, None].expand(
        n, 8)
    pos = torch.arange(8, dtype=torch.int64, device=dev)[None, :].expand(
        n, 8)
    key = (new << 27 | doc << 3 | pos)[keep]
    del new, keep, doc, pos
    key = torch.sort(key).values
    td = key >> 3
    head = torch.ones(len(td), dtype=torch.bool, device=dev)
    head[1:] = td[1:] != td[:-1]
    idx = torch.nonzero(head).squeeze(1)
    counts = torch.diff(idx, append=torch.tensor([len(td)], device=dev))
    rows = key[idx] >> 27
    out = {"vocab": vocab, "remap": remap,
           "doc_ids": (td[idx] & ((1 << 24) - 1)).to(torch.int32).cpu()
           .numpy(),
           "tfs": counts.to(torch.float32).cpu().numpy(),
           "positions": (key & 7).to(torch.int32).cpu().numpy(),
           "dl": dl.cpu().numpy().astype(np.int64)}
    starts = np.zeros(len(vocab) + 1, np.int64)
    np.cumsum(torch.bincount(rows, minlength=len(vocab)).cpu().numpy(),
              out=starts[1:])
    pos_starts = np.zeros(len(idx) + 1, np.int64)
    np.cumsum(counts.cpu().numpy(), out=pos_starts[1:])
    out.update(starts=starts, pos_starts=pos_starts)
    del key, td, head, idx, counts, rows
    sync(dev)
    out["remap_s"] = time.perf_counter() - t0
    out["analyze_s"] = t_analyze
    out["analyzer_ms_a_form"] = t_analyze / len(forms) * 1e3
    return out


def ft_attach(big: dict, seed: int) -> dict:
    """Phase 18's fields attached to the corpus segment: `title_en` (the
    title remapped through the english analyzer on the card, its codec-v2
    impact plane built there), the `client_ip` column and its address
    postings, `stock`, `grade`, `price_scaled`, `views` and `shop` (one
    term, every passage); the mapping put: -> the timings, bytes and the
    oracle's arrays."""
    import torch
    from opensearch_tpu_torch import bench_corpus as bc
    from opensearch_tpu_torch.index.segment import (
        KeywordColumn, NumericColumn, PostingsBlock, TextFieldStats,
        build_impact_plane)
    client, seg = big["client"], big["seg"]
    dev = client.device
    n0 = seg.ndocs
    title = big["title"]
    forms = bc.english_title_forms(title[5], title[6], title[7],
                                   len(title[0]) - 1)
    client.indices.put_mapping("bench", FT_MAPPING)
    mappings = client._indices["bench"].mappings
    en = en_remap(title, forms, mappings.analysis.get("english"), dev)
    vocab = en["vocab"]
    pb = PostingsBlock("title_en", vocab, {t: i for i, t in enumerate(vocab)},
                       en["starts"], en["doc_ids"], en["tfs"],
                       en["pos_starts"], en["positions"])
    dl = en["dl"]
    doc_count, sum_dl = int((dl > 0).sum()), int(dl.sum())
    t0 = time.perf_counter()
    pb.impact = build_impact_plane(pb, dl, avgdl=sum_dl / doc_count,
                                   device=dev)
    sync(dev)
    t_plane = time.perf_counter() - t0
    t0 = time.perf_counter()
    cols = bc.field_type_columns(n0, big["columns"][1], seed)
    ipi = cols["client_ip"].astype(np.int64)
    used = np.unique(ipi)
    names = [bc.ip_pool_str(i) for i in used]
    order = sorted(range(len(used)), key=names.__getitem__)
    row_of = np.empty(bc.IP_POOL, np.int64)
    row_of[used[order]] = np.arange(len(used))
    rows = row_of[ipi]
    ip_docs = np.argsort(rows, kind="stable").astype(np.int32)
    ip_starts = np.zeros(len(used) + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=len(used)), out=ip_starts[1:])
    ip_vocab = [names[j] for j in order]
    ones = np.ones(n0, bool)
    empty_pos = (np.zeros(n0 + 1, np.int64), np.empty(0, np.int32))
    seg.postings["client_ip"] = PostingsBlock(
        "client_ip", ip_vocab, {t: i for i, t in enumerate(ip_vocab)},
        ip_starts, ip_docs, np.ones(n0, np.float32), *empty_pos)
    seg.postings["shop"] = PostingsBlock(
        "shop", ["acme"], {"acme": 0}, np.asarray([0, n0], np.int64),
        np.arange(n0, dtype=np.int32), np.ones(n0, np.float32), *empty_pos)
    seg.keyword_cols["shop"] = KeywordColumn(
        "shop", ["acme"], np.arange(n0 + 1, dtype=np.int64),
        np.zeros(n0, np.int32), np.arange(n0, dtype=np.int32),
        np.zeros(n0, np.int32))
    ip_int = bc.ip_pool_int(ipi)
    for f, kind, v in (("client_ip", "int", ip_int),
                       ("stock", "int", cols["stock"]),
                       ("grade", "int", cols["grade"]),
                       ("price_scaled", "float", cols["price_scaled"]),
                       ("views", "uint", cols["views_biased"])):
        seg.numeric_cols[f] = NumericColumn(f, kind, v, ones)
    t_cols = time.perf_counter() - t0
    seg.postings["title_en"] = pb
    seg.doc_lens["title_en"] = dl
    seg.text_stats["title_en"] = TextFieldStats(doc_count, sum_dl)
    nbytes = (pb.doc_ids.nbytes + pb.tfs.nbytes + pb.pos_starts.nbytes
              + pb.positions.nbytes + dl.nbytes)
    col_bytes = sum(c.values.nbytes + c.present.nbytes
                    for f, c in seg.numeric_cols.items()
                    if f in ("client_ip", "stock", "grade", "price_scaled",
                             "views")) + ip_docs.nbytes + n0 * 8
    return {"analyze_s": en["analyze_s"], "remap_s": en["remap_s"],
            "analyzer_ms_a_form": en["analyzer_ms_a_form"],
            "plane_s": t_plane, "columns_s": t_cols,
            "postings": int(pb.size), "rows": len(vocab),
            "stopword_forms": int((en["remap"] < 0).sum()),
            "tokens_kept": sum_dl, "plane_bytes": int(pb.impact.nbytes),
            "title_en_host_bytes": int(nbytes),
            "column_host_bytes": int(col_bytes),
            "arrays": {"starts": en["starts"], "docs": en["doc_ids"],
                       "tfs": en["tfs"], "dl": dl, "vocab": vocab,
                       "forms": forms, "remap": en["remap"],
                       "ip": ip_int, "stock": cols["stock"],
                       "grade": cols["grade"],
                       "price_scaled": cols["price_scaled"],
                       "views": cols["views_biased"]}}


class FtOracle:
    """Phase 18's brute force over its own arrays (corpus docs 0..n0-1;
    the docs indexed later hold none of the fields) and NumpyIndex's live
    and counted docs: title_en BM25 in f32 with the port's per-term
    order (idf over maxDoc, avgdl over the docs with a title_en token),
    the columns' filters, the views sort, ip_range, stats."""

    def __init__(self, arrays: dict, ix):
        self.a = arrays
        self.ix = ix
        self.n0 = len(arrays["dl"])
        self.dl = arrays["dl"].astype(np.float32)

    def pad(self, v, fill) -> np.ndarray:
        """A corpus column over every global doc (`fill` for later
        docs)."""
        out = np.full(self.ix.n, fill, v.dtype)
        out[:self.n0] = v
        return out

    def row(self, term: str):
        r = self.a["vocab"].index(term)
        lo, hi = int(self.a["starts"][r]), int(self.a["starts"][r + 1])
        return self.a["docs"][lo:hi].astype(np.int64), self.a["tfs"][lo:hi]

    def scores(self, terms) -> tuple:
        import math
        counted = self.ix.counted[:self.n0]
        avgdl = np.float32(self.dl[counted].sum()
                           / (counted & (self.dl > 0)).sum())
        n = self.ix.n_stats
        score = np.zeros(self.ix.n, np.float32)
        hit = np.zeros(self.ix.n, bool)
        for t in dict.fromkeys(terms):
            if t not in self.a["vocab"]:
                continue
            d, tf = self.row(t)
            keep = counted[d]
            d, tf = d[keep], tf[keep]
            df = len(d)
            w = np.float32(math.log(1.0 + (n - df + 0.5) / (df + 0.5)))
            score[d] += (w * tf) / (tf + K1 * (OMB + (B * self.dl[d])
                                               / avgdl))
            hit[d] = True
        return score, hit

    def filters(self, spec: dict) -> np.ndarray:
        from opensearch_tpu_torch.index.mappings import ip_to_int
        import ipaddress
        net = ipaddress.ip_network(spec["cidr"])
        ip = self.pad(self.a["ip"], -1)
        stock = self.pad(self.a["stock"], -1)
        lo, hi = spec["stock"]
        has = np.zeros(self.ix.n, bool)
        has[:self.n0] = True
        return (has & (ip >= ip_to_int(str(net.network_address)))
                & (ip <= ip_to_int(str(net.broadcast_address)))
                & (stock >= lo) & (stock <= hi))


def ft_classes(arrays: dict, n: int, rng) -> dict:
    """`n` bodies a class: (a) a pruned english match on title_en (two
    inflected forms of distinct stems and a stopword), (b) the same with
    exact totals, (c) the match in a bool with a client_ip CIDR filter and
    a stock range, (d) a one-word match sorted by views desc with
    docvalue_fields of client_ip and views, (e) size-0 ip_range, terms on
    client_ip and stats on price_scaled under a one-word match:
    -> {class: [(body, spec)]}."""
    forms, remap = arrays["forms"], arrays["remap"]
    vocab = arrays["vocab"]
    df = np.diff(arrays["starts"])
    stops = [f for f, r in zip(forms, remap) if r < 0]
    # the forms of rows neither rare nor of the densest tenth
    ok_rows = set(np.flatnonzero((df > np.quantile(df, 0.3))
                                 & (df < np.quantile(df, 0.9))).tolist())
    cand = [(f, int(r)) for f, r in zip(forms, remap) if r in ok_rows]
    out = {k: [] for k in ("a_pruned", "b_exact", "c_bool", "d_sort",
                           "e_aggs")}
    for i in range(n):
        j1, j2 = rng.choice(len(cand), 2, replace=False)
        while cand[j2][1] == cand[j1][1]:
            j2 = int(rng.integers(len(cand)))
        (f1, r1), (f2, r2) = cand[j1], cand[j2]
        text = f"{f1} {stops[i % len(stops)]} {f2}"
        terms = [vocab[r1], vocab[r2]]
        m = {"match": {"title_en": text}}
        out["a_pruned"].append(({"query": m, "size": 10},
                                {"terms": terms}))
        out["b_exact"].append(({"query": m, "size": 10,
                                "track_total_hits": True},
                               {"terms": terms}))
        lo = int(rng.integers(0, 300))
        spec = {"terms": terms, "cidr": FT_SUBNET, "stock": (lo, lo + 150)}
        out["c_bool"].append(({"query": {"bool": {"must": [m], "filter": [
            {"term": {"client_ip": FT_SUBNET}},
            {"range": {"stock": {"gte": lo, "lte": lo + 150}}}]}},
            "size": 10}, spec))
        one = {"match": {"title_en": f1}}
        out["d_sort"].append(({"query": one, "size": 10,
                               "sort": [{"views": "desc"}],
                               "docvalue_fields": ["client_ip", "views"]},
                              {"terms": [vocab[r1]]}))
        out["e_aggs"].append(({"query": {"match": {"title_en": f2}},
                               "size": 0, "aggs": {
            "r": {"ip_range": {"field": "client_ip", "ranges": FT_RANGES}},
            "t": {"terms": {"field": "client_ip"}},
            "s": {"stats": {"field": "price_scaled"}}}},
            {"terms": [vocab[r2]]}))
    return out


def ft_check(oracle: FtOracle, name: str, body: dict, spec: dict, resp,
             sums: SumCheck, what: str) -> None:
    """One response of class `name` against the brute force."""
    from opensearch_tpu_torch.index.mappings import ip_to_int
    ix = oracle.ix
    score, hit = oracle.scores(spec["terms"])
    if name in ("a_pruned", "b_exact"):
        check_page(resp, ix.page(score, hit, 0, 10), what)
        return
    if name == "c_bool":
        check_page(resp, ix.page(score, hit & oracle.filters(spec), 0, 10),
                   what)
        return
    docs = np.flatnonzero(hit & ix.live)
    if name == "d_sort":
        # views desc (the biased column keeps the order), ties by doc; the
        # matching docs all hold a views value (corpus docs)
        v = oracle.a["views"][docs]
        sel = docs[np.lexsort((docs, ~v))][:10]
        ip = oracle.a["ip"]
        want = [(ix.id_of(int(g)), [int(oracle.a["views"][g]) + (1 << 63)],
                 {"client_ip": [int(ip[g])],
                  "views": [int(oracle.a["views"][g]) + (1 << 63)]})
                for g in sel]
        got = [(h["_id"], h["sort"], h["fields"])
               for h in resp["hits"]["hits"]]
        if got != want or resp["hits"]["total"]["value"] != len(docs):
            raise AssertionError(f"{what}: sorted page != brute force")
        return
    aggs = resp["aggregations"]
    ip = oracle.pad(oracle.a["ip"], -1)[docs]
    ip = ip[ip >= 0]
    for bk, r in zip(aggs["r"]["buckets"], FT_RANGES):
        if "mask" in r:
            import ipaddress
            net = ipaddress.ip_network(r["mask"])
            lo = ip_to_int(str(net.network_address))
            hi = ip_to_int(str(net.broadcast_address)) + 1
        else:
            lo = ip_to_int(r["from"]) if "from" in r else -1
            hi = ip_to_int(r["to"]) if "to" in r else 1 << 63
        if bk["doc_count"] != int(((ip >= lo) & (ip < hi)).sum()):
            raise AssertionError(f"{what}: ip_range bucket {bk}")
    if aggs["t"]["buckets"]:
        raise AssertionError(f"{what}: terms on an ip field has buckets "
                             f"(the reference keeps no keyword doc values "
                             f"for an ip)")
    ps = oracle.a["price_scaled"][docs[docs < oracle.n0]]
    check_stats(aggs["s"], ps.astype(np.float32), sums, f"{what} stats")


def run_ft_class(client, name: str, items, oracle: FtOracle, sums,
                 cpu=None, label: str = "") -> dict:
    """One class body by body through RestClient.search (the counts set
    to 0 just before), each page against the brute force, the first body
    on the card against the CPU twin: -> the class's numbers."""
    from opensearch_tpu_torch.ops import bm25
    from opensearch_tpu_torch.search import compiler as C
    from opensearch_tpu_torch.search import fastpath, impactpath
    bodies = [b for b, _s in items]
    sync(client.device)
    impactpath.reset_stats()
    fastpath.reset_stats()
    C.reset_stats()
    bm25.reset_counts()
    lat, resps = [], []
    t0 = time.perf_counter()
    for b in bodies:
        t1 = time.perf_counter()
        resps.append(client.search("bench", b))
        lat.append((time.perf_counter() - t1) * 1e3)
    sync(client.device)
    wall = time.perf_counter() - t0
    counts = {**{k: bm25.COUNTS[k] for k in ("launches", "impact_launches",
                                             "bool_launches",
                                             "plain_calls")},
              "impact_rung": sum(impactpath.STATS[k] for k in (
                  "served", "pruned_served", "phase2_served", "escalated")),
              "pruned_ladder": sum(fastpath.STATS.get(k, 0) for k in RUNGS),
              "general": C.STATS["general_served"]}
    t0 = time.perf_counter()
    for j, ((b, spec), r) in enumerate(zip(items, resps)):
        ft_check(oracle, name, b, spec, r, sums,
                 f"phase 18 {name}{label} {j}")
    t_oracle = time.perf_counter() - t0
    t_cpu = 0.0
    if cpu is not None:
        t0 = time.perf_counter()
        want = cpu.search("bench", bodies[0])
        t_cpu = time.perf_counter() - t0
        ft_same(resps[0], want, bodies[0], f"phase 18 {name}")
    if counts["plain_calls"]:
        raise AssertionError(f"phase 18 {name}: a plain call on the card")
    out = {"bodies": len(bodies), "wall_s": wall,
           "bodies_per_s": len(bodies) / wall,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)), "first_ms": lat[0],
           "counts": counts, "oracle_s": t_oracle, "cpu_s": t_cpu}
    log(f"  {name}{label}: {len(bodies)} bodies in {wall:.2f}s p50 "
        f"{out['p50_ms']:.1f} p99 {out['p99_ms']:.1f} first "
        f"{lat[0]:.1f} ms; routes {counts}; pages == brute force "
        f"({t_oracle:.1f}s)" + (f"; body 0 card == CPU ({t_cpu:.1f}s)"
                                 if cpu is not None else ""))
    return out


def ft_twin(eng):
    cpu = twin_of(eng)
    cpu.indices.put_mapping("bench", FT_MAPPING)
    return cpu


def phase_fields_msmarco(big: dict, n: int, seed: int) -> dict:
    """Phase 18 on phase 17's end state: FT_MAPPING's fields attached to
    the corpus segment (`ft_attach`), `n` bodies a class of `ft_classes`,
    every page against FtOracle, one body a class card == CPU; seconds,
    device bytes and host RSS at the phase's start, peak and end."""
    import torch
    client, seg, ix = big["client"], big["seg"], big["ix"]
    dev = client.device
    eng = client._indices["bench"].engine
    drop_cpu_state(eng.segments)
    trim_host()
    torch.cuda.synchronize()
    t_phase = time.perf_counter()
    bytes0 = torch.cuda.memory_allocated(dev)
    rss0 = rss_bytes()
    rss_watch = RssPeak().__enter__()
    att = ft_attach(big, seed)
    arrays = att.pop("arrays")
    torch.cuda.synchronize()
    bytes_attach = torch.cuda.memory_allocated(dev) - bytes0
    log(f"  title_en: {len(arrays['forms'])} title forms through the "
        f"english analyzer in {att['analyze_s'] * 1e3:.1f} ms "
        f"({att['analyzer_ms_a_form']:.4f} ms a form; "
        f"{att['stopword_forms']} stopwords), {att['postings']} postings "
        f"over {att['rows']} stems ({att['tokens_kept']} tokens kept) "
        f"remapped on the card in {att['remap_s']:.2f}s, impact plane "
        f"{att['plane_s']:.2f}s ({att['plane_bytes']} bytes), "
        f"{att['title_en_host_bytes']} host bytes; columns and ip postings "
        f"{att['columns_s']:.2f}s ({att['column_host_bytes']} host bytes)")
    oracle = FtOracle(arrays, ix)
    classes = ft_classes(arrays, n, np.random.default_rng([seed, 18]))
    cpu = ft_twin(eng)
    sums = SumCheck()
    out: dict = {"build": att, "classes": {}}
    for name, items in classes.items():
        out["classes"][name] = run_ft_class(client, name, items, oracle,
                                            sums, cpu)
    torch.cuda.synchronize()
    out["device_bytes_attach"] = bytes_attach
    out["device_bytes"] = torch.cuda.memory_allocated(dev) - bytes0
    rss_watch.__exit__()
    out["rss_start"], out["rss_end"] = rss0[0], rss_bytes()[0]
    out["rss_peak"] = rss_watch.peak
    out["seconds"] = time.perf_counter() - t_phase
    out["sum_rel_err"] = sums.rel
    log(f"  phase 18: {out['seconds']:.1f}s; device bytes "
        f"{bytes_attach} after the attach, {out['device_bytes']} at the "
        f"end; host RSS start {out['rss_start']}, peak {out['rss_peak']}, "
        f"end {out['rss_end']}, the process's {rss_bytes()[1]}")
    drop_cpu_state(eng.segments)
    big["fields"] = {"classes": classes, "seed": seed, "arrays": arrays}
    return out


def phase_fields_merged(big: dict) -> dict:
    """Phase 8's merged segment: classes (a), (b), (c) and (e) again, one
    body each, against the brute force (deleted docs compacted away), the
    merged title_en rows against the live passages'."""
    client, ix = big["client"], big["ix"]
    eng = client._indices["bench"].engine
    (merged,) = eng.segments
    f = big["fields"]
    oracle = FtOracle(f["arrays"], ix)
    live_g = np.flatnonzero(ix.live)
    new_of = np.full(ix.n, -1, np.int64)
    new_of[live_g] = np.arange(len(live_g))
    pb = merged.postings["title_en"]
    for term in oracle.a["vocab"][:3]:
        d, tf = oracle.row(term)
        keep = ix.live[d]
        a, b = pb.row_slice(pb.row(term))
        if not (np.array_equal(pb.doc_ids[a:b], new_of[d[keep]])
                and np.array_equal(pb.tfs[a:b], tf[keep])):
            raise AssertionError(f"merged title_en row {term} != the live "
                                 f"passages'")
    if merged.numeric_cols["views"].kind != "uint":
        raise AssertionError("merged views column lost its kind")
    sums = SumCheck()
    out = {"classes": {}}
    for name in ("a_pruned", "b_exact", "c_bool", "e_aggs"):
        out["classes"][name] = run_ft_class(
            client, name, f["classes"][name][:1], oracle, sums,
            label=", merged")
    return out


# ---------------------------------------------------------------------
# phase 19: query strings, function_score, script / script_score and the
# host script contexts
# ---------------------------------------------------------------------

SC_SMALL_DOCS = 3000
SC_QUERIES = 4         # phase 19's bodies a class
SC_WORDS = ["red", "blue", "green", "shirt", "hat", "coat", "wool", "silk",
            "warm", "light", "dress", "scarf", "boot", "linen", "sale"]
SC_MAPPING = {"mappings": {"properties": {
    "name": {"type": "text"}, "status": {"type": "keyword"},
    "price": {"type": "float"}, "qty": {"type": "integer"},
    "tag": {"type": "keyword"}}}}


def sc_small_bodies() -> list:
    """Phase 4's host script contexts: script_fields, `_script` sorts,
    terms_set's minimum_should_match_script, scripted_metric,
    bucket_script, bucket_selector and a scripted moving_fn."""
    match = {"match": {"name": "shirt wool boot"}}
    return [
        {"query": match, "script_fields": {
            "margin": {"script": {"source": "doc['price'].value * 0.5"}},
            "label": {"script": "doc['status'].value + '!'"}}},
        {"query": match, "size": 20, "sort": [{"_script": {
            "type": "number", "order": "desc", "script": {
                "source": "doc['qty'].value * params.m + doc['price'].value",
                "params": {"m": 3}}}}]},
        {"query": match, "size": 20, "sort": [{"status": "asc"}, {
            "_script": {"type": "string", "script":
                        "doc['tag'].value + doc['status'].value"}}]},
        {"query": {"terms_set": {"name": {
            "terms": ["red", "shirt", "wool", "hat", "silk"],
            "minimum_should_match_script": {
                "source": "Math.max(1, doc['qty'].value / 5)"}}}}},
        {"size": 0, "query": match, "aggs": {"m": {"scripted_metric": {
            "init_script": "state.t = []",
            "map_script": "state.t.add(doc['qty'].value)",
            "combine_script": "def s = 0; for (t in state.t) { s += t } "
                              "return s",
            "reduce_script": "def s = 0; for (a in states) { s += a } "
                             "return s"}}}},
        {"size": 0, "aggs": {"h": {"terms": {"field": "tag"}, "aggs": {
            "q": {"sum": {"field": "qty"}},
            "r": {"bucket_script": {"buckets_path": {"n": "_count",
                                                    "q": "q"},
                                    "script": "params.q / params.n"}},
            "k": {"bucket_selector": {"buckets_path": {"n": "_count"},
                                      "script": "params.n > 300"}}}}}},
        {"size": 0, "aggs": {"h": {"histogram": {"field": "qty",
                                                 "interval": 4}, "aggs": {
            "m": {"moving_fn": {"buckets_path": "_count", "window": 3,
                                "script": "def s = 0; for (v in values) "
                                          "{ s += v } return s / 2"}}}}}},
    ]


def sc_small_run(name: str, docs, bodies) -> tuple:
    """The script contexts on one device: two segments, deletes, the
    bodies, scripted updates (an update, a scripted upsert twice, a noop
    and a ctx.op delete), a refresh, the bodies again."""
    from opensearch_tpu_torch import RestClient
    c = RestClient(device=name)
    c.indices.create("s", SC_MAPPING)
    half = len(docs) // 2
    for lo, hi in ((0, half), (half, len(docs))):
        c.bulk(sum([[{"index": {"_index": "s", "_id": f"d{i}"}}, docs[i]]
                    for i in range(lo, hi)], []), refresh=True)
    c.bulk([{"delete": {"_index": "s", "_id": f"d{i}"}}
            for i in range(0, half, 13)], refresh=True)
    first = [strip_took(c.search("s", b)) for b in bodies]
    updates = [
        c.update("s", "d1", {"script": {"source": "ctx._source.qty += "
                                        "params.n", "params": {"n": 40}}}),
        c.update("s", "k", {"scripted_upsert": True, "upsert": {"qty": 0},
                            "script": "ctx._source.qty += 1"}),
        c.update("s", "k", {"scripted_upsert": True, "upsert": {"qty": 0},
                            "script": "ctx._source.qty += 1"}),
        c.update("s", "d2", {"script": "ctx._source.name += ' x'; "
                                       "ctx.op = 'none'"}),
        c.update("s", "d3", {"script": "if (ctx._source.qty >= 0) "
                                       "{ ctx.op = 'delete' }"})]
    c.indices.refresh("s")
    gets = [c.get("s", i)["_source"] for i in ("d1", "k", "d2")]
    then = [strip_took(c.search("s", b)) for b in bodies]
    return first, [{k: u.get(k) for k in ("_id", "result")}
                   for u in updates], gets, then, c.exists("s", "d3")


def phase_scripts_small(rng) -> dict:
    """Phase 4's host script contexts at SC_SMALL_DOCS docs, card == CPU
    (exact: they run on the host over the same documents)."""
    docs = [{"name": " ".join(rng.choice(SC_WORDS, int(rng.integers(2, 6)))),
             "status": ["new", "sale", "old"][int(rng.integers(3))],
             "price": float(np.float32(rng.uniform(1, 200))),
             "qty": int(rng.integers(0, 30)),
             "tag": f"t{int(rng.integers(5))}"}
            for _ in range(SC_SMALL_DOCS)]
    bodies = sc_small_bodies()
    t0 = time.perf_counter()
    out = {name: sc_small_run(name, docs, bodies) for name in ("cuda", "cpu")}
    if out["cuda"] != out["cpu"]:
        for part, (g, w) in enumerate(zip(out["cuda"], out["cpu"])):
            if g != w:
                raise AssertionError(f"scripts small: part {part} differs "
                                     f"between cuda and cpu:\n{g}\n{w}")
    first, updates, gets, then, d3 = out["cuda"]
    if not first[0]["hits"]["hits"] or "fields" not in \
            first[0]["hits"]["hits"][0] or d3 \
            or gets[1]["qty"] != 2 or updates[3]["result"] != "noop":
        raise AssertionError(f"scripts small: unexpected responses "
                             f"{updates} {gets} {d3}")
    log(f"  scripts, small: {len(docs)} docs, {len(bodies)} bodies "
        f"(script_fields, _script sorts, terms_set script, scripted_metric,"
        f" bucket_script / bucket_selector, scripted moving_fn) before and "
        f"after 5 scripted updates / upserts / ctx.op: card == CPU "
        f"({time.perf_counter() - t0:.1f}s)")
    return {"docs": len(docs), "bodies": len(bodies),
            "updates": len(updates)}


SC_ORIGIN = 1_704_067_200_000 + 200 * 86_400_000    # 2024-07-19, epoch ms
SC_SCALE_MS, SC_OFFSET_MS = 30 * 86_400_000, 86_400_000
SC_SEED = 20_251


def sc_fs_body(text: str) -> dict:
    """Class (d): a shop's relevance by popularity and recency."""
    return {"query": {"function_score": {
        "query": {"match": {"body": text}},
        "functions": [
            {"field_value_factor": {"field": "rating", "factor": 1.0,
                                    "modifier": "log1p", "missing": 1}},
            {"gauss": {"ts": {"origin": SC_ORIGIN, "scale": "30d",
                              "offset": "1d", "decay": 0.5}}},
            {"filter": {"term": {"status": "published"}}, "weight": 1.5}],
        "score_mode": "sum", "boost_mode": "multiply"}}, "size": 10}


def sc_classes(big: dict, n: int) -> dict:
    """`n` bodies a class drawn from phase 5's query terms (each item
    (body, spec)): (a) query_string on body under default_operator and,
    half with a status clause (the other half also against the brute
    force of its terms, all required); (b) query_string over body and title^2
    with a quoted title phrase; (c) simple_query_string `a b -c` on body,
    half with a prefix or a phrase; (d) function_score; (e) script_score
    and a match filtered by a script; (f) random_score, boost_mode
    replace. The spec holds what the check reads: the JSON DSL
    equivalent of (a)-(c), the term ids of (d)-(f)."""
    from opensearch_tpu_torch import bench_corpus as bc
    corpus = big["corpus"]
    vs = bc.vocab_strings(len(corpus[0]) - 1)
    terms = big["body_terms"]
    title = big["title"]
    tvs = bc.title_vocab_strings(len(title[0]) - 1)
    pairs = bc.pick_phrase_pairs(title[7], n, seed=19)
    # a 10% price filter: under 1/8 of the docs, so its re-runs on the
    # merged segment build no filter-specialized postings
    price_p = float(np.percentile(big["columns"][1], 90))
    out = {k: [] for k in ("a_query_string", "b_multi_field",
                           "c_simple", "d_function_score", "e_scripts",
                           "f_random")}
    for i in range(n):
        ts = terms[(2 * i) % len(terms)]
        t3 = terms[(2 * i + 1) % len(terms)]
        # 2 terms of a pair query, or 3-4 of a real one, all required
        ids = [int(t) for t in (ts[:2] if i % 3 == 0 else t3[:2 + i % 3])]
        words = [vs[t] for t in ids]
        status = bc.STATUS_VALUES[i % 3]
        q = " ".join(words) + (f" status:{status}" if i % 2 else "")
        equiv = [{"match": {"body": {"query": w, "operator": "and"}}}
                 for w in words]
        if i % 2:
            equiv.append({"match": {"status": {"query": status,
                                               "operator": "and"}}})
        out["a_query_string"].append((
            {"query": {"query_string": {"query": q, "default_field": "body",
                                        "default_operator": "and"}}},
            {"query": {"bool": {"must": equiv}},
             **({} if i % 2 else {"all": ids})}))
        a = tvs[title[5][pairs[i]]]
        b = tvs[title[6][pairs[i]]]
        w3 = vs[t3[0]]
        out["b_multi_field"].append((
            {"query": {"query_string": {"query": f'"{a} {b}" {w3}',
                                        "fields": ["body", "title^2"]}}},
            {"query": {"bool": {"should": [
                {"dis_max": {"queries": [
                    {"match_phrase": {"body": {"query": f"{a} {b}",
                                               "slop": 0}}},
                    {"match_phrase": {"title": {"query": f"{a} {b}",
                                                "slop": 0, "boost": 2.0}}}]}},
                {"dis_max": {"queries": [
                    {"match": {"body": {"query": w3, "operator": "or"}}},
                    {"match": {"title": {"query": w3, "operator": "or",
                                         "boost": 2.0}}}]}}],
                "minimum_should_match": "1"}}}))
        x, y = vs[ts[0]], vs[ts[1]]
        z = vs[t3[-1]]
        extra, extra_q = "", []
        if i % 4 == 1:
            extra = f" {vs[t3[0]][:6]}*"
            extra_q = [{"prefix": {"body": vs[t3[0]][:6]}}]
        elif i % 4 == 3:
            extra = f' "{vs[t3[0]]} {x}"'
            extra_q = [{"match_phrase": {"body": {
                "query": f"{vs[t3[0]]} {x}", "slop": 0}}}]
        out["c_simple"].append((
            {"query": {"simple_query_string": {"query": f"{x} {y} -{z}"
                                               + extra,
                                               "fields": ["body"]}}},
            {"query": {"bool": {
                "should": [{"match": {"body": {"query": x}}},
                           {"match": {"body": {"query": y}}}] + extra_q,
                "must_not": [{"match": {"body": {"query": z}}}],
                "minimum_should_match": "1"}}, "plain": not extra,
             "terms": [int(ts[0]), int(ts[1])], "not": int(t3[-1])}))
        two = list(ts[:2])
        text = f"{vs[two[0]]} {vs[two[1]]}"
        out["d_function_score"].append((sc_fs_body(text), {"terms": two}))
        if i % 2 == 0:
            body = {"query": {"script_score": {
                "query": {"match": {"body": text}},
                "script": {"source": "_score * Math.log(2 + "
                                     "doc['rating'].value) * params.w",
                           "params": {"w": 1.5}}}}, "size": 10}
            spec = {"terms": two, "kind": "script_score"}
        else:
            body = {"query": {"bool": {
                "must": [{"match": {"body": text}}],
                "filter": [{"script": {"script": {
                    "source": "doc['price'].value > params.p",
                    "params": {"p": price_p}}}}]}}, "size": 10}
            spec = {"terms": two, "kind": "script_filter", "p": price_p}
        out["e_scripts"].append((body, spec))
        out["f_random"].append((
            {"query": {"function_score": {
                "query": {"match": {"body": text}},
                "random_score": {"seed": SC_SEED + i},
                "boost_mode": "replace"}}, "size": 10},
            {"terms": two, "seed": SC_SEED + i}))
    return out


def np_random_values(seed: int, n: int) -> np.ndarray:
    """The reference's random_score hash of doc indices 0..n-1 (uint32
    steps), over [0, 1) in f32."""
    h = (np.arange(n, dtype=np.uint32) * np.uint32(2654435761)
         ^ np.uint32(np.int32(seed).view(np.uint32)))
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x45D9F3B)
    h = h ^ (h >> np.uint32(16))
    return h.astype(np.float32) / np.float32(2**32)


class ScOracle:
    """Phase 19's numpy brute force over NumpyIndex's docs: phase 5's
    BM25 (`NumpyIndex.group`) times the functions in f32 over the f32
    views of the rating, ts, price and status columns (AggOracle's)."""

    def __init__(self, ix, aggcols, eng):
        self.ix = ix
        self.cols = AggOracle(ix, aggcols).cols()
        self.eng = eng

    def page(self, body: dict, spec: dict) -> tuple:
        ix, c = self.ix, self.cols
        if "all" in spec:           # (a) without status: every term
            return ix.page(*ix.group(spec["all"], len(spec["all"])), 0, 10)
        score, ok = ix.group(spec["terms"], 1)
        f32 = np.float32
        if "seed" in spec:
            return self.random_page(spec["seed"], ok)
        if "not" in spec:           # (c)'s plain `a b -c`
            ok = ok.copy()
            ok[ix.row(spec["not"])[0]] = False
        elif spec.get("kind") == "script_score":
            r = np.where(c["rating_present"], c["rating"], f32(0))
            score = (score * np.log(f32(2) + r)) * f32(1.5)
        elif spec.get("kind") == "script_filter":
            ok = ok & (c["price"] > f32(spec["p"]))
        else:
            r = np.where(c["rating_present"], c["rating"] * f32(1.0),
                         f32(1))
            v1 = np.log10(r + f32(1.0))
            tsf = c["ts"].astype(np.float32)
            a = f32(math.log(0.5) / (float(SC_SCALE_MS) ** 2))
            d = np.abs(tsf - f32(SC_ORIGIN))
            d = np.maximum(d - f32(SC_OFFSET_MS), f32(0))
            v2 = np.where(c["ts_present"], np.exp(a * d * d), f32(1))
            v3 = np.where(c["status"] == 2, f32(1.5), f32(0))
            score = score * ((v1 + v2) + v3)
        return ix.page(np.where(ok, score, f32(0)).astype(np.float32),
                       ok, 0, 10)

    def random_page(self, seed: int, ok: np.ndarray) -> tuple:
        """random_score, boost_mode replace: each matched doc's hash of
        its segment-local index; ties by (segment, local doc)."""
        ix = self.ix
        segs = self.eng.segments
        if segs[0].ndocs != ix.n0:
            raise AssertionError("the corpus segment is not the first")
        docs = np.flatnonzero(ok & ix.live)
        seg_of = np.zeros(len(docs), np.int64)
        local = docs.copy()
        for j in np.flatnonzero(docs >= ix.n0):
            sid = ix.id_of(int(docs[j]))
            for s_ord, s in enumerate(segs[1:], 1):
                d = s.local_doc(sid)
                if d >= 0 and s.live[d]:
                    seg_of[j], local[j] = s_ord, d
                    break
        vals = np.zeros(len(docs), np.float32)
        for s_ord in np.unique(seg_of):
            sel = seg_of == s_ord
            vals[sel] = np_random_values(seed, segs[s_ord].ndocs)[local[sel]]
        order = np.lexsort((local, seg_of, -vals))[:10]
        return ([ix.id_of(int(docs[j])) for j in order],
                vals[order].tolist(), len(docs))


def sc_close(got: dict, want: dict, rtol: float, what: str) -> None:
    """Card against the CPU twin where a transcendental enters: totals
    equal, scores within rtol, ids and order identical but for swaps
    between scores within rtol."""
    gh, wh = got["hits"]["hits"], want["hits"]["hits"]
    wsc = {h["_id"]: h["_score"] for h in wh}
    ok = (got["hits"]["total"] == want["hits"]["total"]
          and len(gh) == len(wh))
    for g, w in zip(gh, wh):
        ws = wsc.get(g["_id"])
        ok = ok and ws is not None and abs(g["_score"] - ws) <= rtol * abs(
            ws) and abs(ws - w["_score"]) <= rtol * abs(w["_score"])
    if not ok:
        raise AssertionError(f"{what}: card != CPU\n{got['hits']}\n"
                             f"{want['hits']}")


SC_RTOL = 1e-5      # a transcendental enters: another libm than numpy's


def run_sc_class(client, name: str, items, oracle, cpu=None,
                 label: str = "") -> dict:
    """One class body by body through RestClient.search (the counts set
    to 0 just before): (a)-(c) each page against its JSON DSL page
    through the same client (and (a) without status against the brute
    force, since both pages take one route), (d)-(f) against the brute
    force; the first
    body on the card against the CPU twin: -> the class's numbers."""
    from opensearch_tpu_torch.ops import bm25
    from opensearch_tpu_torch.search import compiler as C
    from opensearch_tpu_torch.search import fastpath, impactpath
    bodies = [b for b, _s in items]
    sync(client.device)
    impactpath.reset_stats()
    fastpath.reset_stats()
    C.reset_stats()
    bm25.reset_counts()
    lat, resps = [], []
    t0 = time.perf_counter()
    for b in bodies:
        t1 = time.perf_counter()
        resps.append(client.search("bench", b))
        lat.append((time.perf_counter() - t1) * 1e3)
    sync(client.device)
    wall = time.perf_counter() - t0
    counts = {**{k: bm25.COUNTS[k] for k in ("launches", "impact_launches",
                                             "bool_launches",
                                             "plain_calls")},
              "impact_rung": sum(impactpath.STATS[k] for k in (
                  "served", "pruned_served", "phase2_served", "escalated")),
              "pruned_ladder": sum(fastpath.STATS.get(k, 0) for k in RUNGS),
              "b3_filter_slot": fastpath.STATS.get("b3_filter_slot", 0),
              "b3_filtered_postings": fastpath.STATS.get(
                  "b3_filtered_postings", 0),
              "general": C.STATS["general_served"]}
    t0 = time.perf_counter()
    for j, ((b, spec), r) in enumerate(zip(items, resps)):
        what = f"phase 19 {name}{label} {j}"
        if "query" in spec:          # (a)-(c): the JSON DSL page
            want = client.search("bench", {"query": spec["query"]})
            if strip_took(r) != strip_took(want):
                raise AssertionError(f"{what}: string page != its DSL "
                                     f"page\n{r['hits']}\n{want['hits']}")
            if "all" in spec:
                check_page(r, oracle.page(b, spec), what)
        else:
            check_page(r, oracle.page(b, spec), what,
                       rtol=0.0 if "seed" in spec else
                       1e-6 if "not" in spec else SC_RTOL)
    t_check = time.perf_counter() - t0
    t_cpu = 0.0
    if cpu is not None:
        t0 = time.perf_counter()
        want = cpu.search("bench", bodies[0])
        t_cpu = time.perf_counter() - t0
        if name.startswith(("d_", "e_")):
            sc_close(resps[0], want, SC_RTOL, f"phase 19 {name}")
        elif strip_took(resps[0]) != strip_took(want):
            raise AssertionError(f"phase 19 {name}: card != CPU")
    if counts["plain_calls"]:
        raise AssertionError(f"phase 19 {name}: a plain call on the card")
    out = {"bodies": len(bodies), "wall_s": wall,
           "bodies_per_s": len(bodies) / wall,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)), "first_ms": lat[0],
           "counts": counts, "check_s": t_check, "cpu_s": t_cpu}
    log(f"  {name}{label}: {len(bodies)} bodies in {wall:.2f}s "
        f"({out['bodies_per_s']:.1f} bodies/s) p50 {out['p50_ms']:.1f} p99 "
        f"{out['p99_ms']:.1f} first {lat[0]:.1f} ms; routes {counts}; pages "
        f"checked ({t_check:.1f}s)"
        + (f"; body 0 card == CPU ({t_cpu:.1f}s)" if cpu is not None
           else ""))
    return out


def phase_scripts_msmarco(big: dict) -> dict:
    """Phase 19 on phase 18's end state (the kernels decline the corpus
    segment, which has deletes): SC_QUERIES bodies a class of `sc_classes`,
    (a)-(c) against their JSON DSL pages, (d)-(f) against ScOracle, one
    body a class card == CPU; seconds, device bytes and host RSS."""
    import torch
    client, ix = big["client"], big["ix"]
    dev = client.device
    eng = client._indices["bench"].engine
    torch.cuda.synchronize()
    t_phase = time.perf_counter()
    bytes0 = torch.cuda.memory_allocated(dev)
    rss0 = rss_bytes()
    rss_watch = RssPeak().__enter__()
    classes = sc_classes(big, SC_QUERIES)
    oracle = ScOracle(ix, big["aggs"], eng)
    cpu = ft_twin(eng)
    out: dict = {"classes": {}}
    for name, items in classes.items():
        out["classes"][name] = run_sc_class(client, name, items, oracle,
                                            cpu)
    torch.cuda.synchronize()
    out["device_bytes"] = torch.cuda.memory_allocated(dev) - bytes0
    rss_watch.__exit__()
    out["rss_start"], out["rss_end"] = rss0[0], rss_bytes()[0]
    out["rss_peak"] = rss_watch.peak
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 19: {out['seconds']:.1f}s; device bytes "
        f"{out['device_bytes']} above the phase's start; host RSS start "
        f"{out['rss_start']}, peak {out['rss_peak']}, end {out['rss_end']}")
    drop_cpu_state(eng.segments)
    big["scripts"] = {"classes": classes}
    return out


def phase_scripts_merged(big: dict) -> dict:
    """Phase 8's merged segment: (a) without its status clause and the
    plain (c) bodies (B3: a bool of one-term groups on body), (d) and
    (e)'s script-filtered match (B3, the script's mask by eval_device)
    against the brute force (deleted docs compacted away)."""
    client, ix = big["client"], big["ix"]
    eng = client._indices["bench"].engine
    classes = big["scripts"]["classes"]
    oracle = ScOracle(ix, big["aggs"], eng)
    cpu = twin_of(eng)
    picks = {
        "a_query_string": [it for j, it in enumerate(
            classes["a_query_string"]) if j % 2 == 0][:2],
        # against the brute force: the DSL page would be a second use
        # of the must_not's dense filter, which builds the
        # filter-specialized postings (tens of seconds at 8.8M)
        "c_simple": [(b, {k: v for k, v in spec.items() if k != "query"})
                     for b, spec in classes["c_simple"] if spec["plain"]][:2],
        "d_function_score": classes["d_function_score"][:1],
        "e_script_filter": [it for it in classes["e_scripts"]
                            if it[1]["kind"] == "script_filter"][:2]}
    out = {"classes": {}}
    for name, items in picks.items():
        r = out["classes"][name] = run_sc_class(
            client, name, items, oracle, cpu if name.startswith("e") else
            None, label=", merged")
        c = r["counts"]
        on = c["launches"] + c["impact_launches"] + c["bool_launches"]
        if name == "d_function_score":
            if not c["general"]:
                raise AssertionError(f"{name}: not on the general path {c}")
        elif not on or c["general"] or (name == "e_script_filter"
                                        and not c["bool_launches"]):
            raise AssertionError(f"{name}: not on its kernels: {c}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ndocs", type=int, default=NDOCS_MSMARCO)
    # phase 5 ran 2,048 queries before phase 6 shared the time limit,
    # 1,024 before phase 8 did; phase 7 ran 64 bodies a class before
    # phase 8 did, 32 before phase 11 did; before phase 13 did, phase 7
    # ran 16 a class, phase 9 1,024 config-3 and 64 sloppy and prefix
    # bodies, phase 10 16 a class, phase 11 16 and phase 12 8; before
    # phase 15 did, phase 7 and phase 13 ran 8 a class and phase 9 32
    # sloppy and prefix bodies; before phase 16 did, phase 9 ran 512
    # config-3 and mixed bodies and 16 sloppy and prefix bodies, phases
    # 12, 13 and 15 4 bodies a class and phase 10 8; before phase 17 did,
    # phase 9 ran 8 sloppy and prefix bodies and phase 8 16 match bodies
    # around its merge and the whole b3 mix on the merged segment; before
    # phase 19 did, phase 9 ran 256 config-3 and mixed bodies (phase 7's
    # count also seeds which _ids it re-indexes, which later phases' data
    # follow)
    ap.add_argument("--queries", type=int, default=128)
    ap.add_argument("--bool-queries", type=int, default=1024)
    ap.add_argument("--general-queries", type=int, default=4,
                    help="phase-7 bodies per class")
    ap.add_argument("--phrase-queries", type=int, default=128,
                    help="phase-9 config-3 and mixed bodies each")
    ap.add_argument("--phrase-sloppy", type=int, default=4,
                    help="phase-9 sloppy and prefix bodies together")
    ap.add_argument("--agg-queries", type=int, default=4,
                    help="phase-10 bodies per class (the refinement class "
                    "takes at most 4)")
    ap.add_argument("--sort-queries", type=int, default=8,
                    help="phase-11 bodies per class (the chains of (b) "
                    "and (c) add 4 pages each)")
    ap.add_argument("--expand-queries", type=int, default=2,
                    help="phase-12 bodies per class")
    ap.add_argument("--compound-queries", type=int, default=2,
                    help="phase-13 bodies per class")
    ap.add_argument("--context-queries", type=int, default=8,
                    help="phase-14 bodies per class")
    ap.add_argument("--longtail-queries", type=int, default=2,
                    help="phase-15 bodies per class (a composite body "
                    "pages to its end)")
    ap.add_argument("--vector-queries", type=int, default=4,
                    help="phase-16 bodies per class (class (f) is one "
                    "msearch of 64)")
    ap.add_argument("--sparse-queries", type=int, default=4,
                    help="phase-17 bodies per class")
    ap.add_argument("--field-queries", type=int, default=4,
                    help="phase-18 bodies per class")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stop-after", type=int, default=0,
                    help="end after this phase (3 to 19; they run 3, 4, 5, "
                    "6, 9, 7, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 8); "
                    "no result line")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    draws = HostDraws(args.ndocs) if args.stop_after not in (3, 4) else None
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

    log("[4] slice, small: RestClient on cuda vs cpu" + at(t_start))
    phase_slice_small(rng(7))
    vec_small = phase_vectors_small(rng(9))
    sp_small = phase_sparse_small(rng(10))
    ft_small = phase_fields_small(rng(11))
    sc_small = phase_scripts_small(rng(12))
    if args.stop_after == 4:
        return 0

    log(f"[5] slice at MS MARCO passage scale (ndocs={args.ndocs})"
        + at(t_start))
    if args.ndocs < NDOCS_MSMARCO:
        log(f"  cut: ndocs {args.ndocs} < {NDOCS_MSMARCO} as asked on the "
            f"command line")
    if args.queries < 2048:
        log(f"  cut: {args.queries} match queries (2048 uncut), so that "
            f"phases 6-12 fit the same time limit")
    big = phase_msmarco(args.ndocs, args.queries, draws)
    if args.stop_after == 5:
        return 0

    log(f"[6] bool traffic at MS MARCO passage scale (ndocs={args.ndocs})"
        + at(t_start))
    bools = phase_bool_msmarco(big, args.bool_queries)
    if args.stop_after == 6:
        return 0

    log(f"[9] phrase traffic at MS MARCO passage scale (ndocs="
        f"{args.ndocs}): bench.py's config 3, sloppy and prefix phrases, "
        f"its mixed stream" + at(t_start))
    n_mixed = min(args.phrase_queries, args.bool_queries)
    if args.phrase_queries < 1024 or args.phrase_sloppy < 64:
        log(f"  cut: {args.phrase_queries} config-3 and mixed bodies "
            f"(1024 uncut) and {args.phrase_sloppy} sloppy and prefix "
            f"bodies (64), so that phases 7-8, 13, 15 and 16 fit the same "
            f"time limit")
    phrase = phase_phrase_msmarco(big, bools, args.phrase_queries,
                                  args.phrase_sloppy, n_mixed)
    if args.stop_after == 9:
        return 0

    log(f"[7] the general path and the impact rung at MS MARCO passage "
        f"scale (ndocs={args.ndocs})" + at(t_start))
    if args.general_queries < 64:
        log(f"  cut: {args.general_queries} bodies a class (64 uncut), so "
            f"that phases 8, 11, 13 and 15 fit the same time limit")
    general = phase_general_msmarco(big, args.general_queries)
    if args.stop_after == 7:
        return 0

    log(f"[10] size-0 analytics bodies (aggregations) at MS MARCO passage "
        f"scale (ndocs={args.ndocs})" + at(t_start))
    if args.agg_queries < 16:
        log(f"  cut: {args.agg_queries} bodies a class (16 uncut), so "
            f"that phases 13 and 16 fit the same time limit")
    aggs = phase_aggs_msmarco(big, args.agg_queries)
    if args.stop_after == 10:
        return 0

    log(f"[11] a search results page (sort, search_after, collapse, the "
        f"fetch options) at MS MARCO passage scale (ndocs={args.ndocs}): "
        f"classes (a)-(e) here, (f) after phase 8" + at(t_start))
    if args.sort_queries < 16:
        log(f"  cut: {args.sort_queries} bodies a class (16 uncut), so "
            f"that phase 13 fits the same time limit")
    sort = phase_sort_msmarco(big, args.sort_queries)
    if args.stop_after == 11:
        return 0

    log(f"[12] term-expanding queries and keyword ranges (prefix, "
        f"wildcard, regexp, fuzzy, fuzzy match, match_bool_prefix) at MS "
        f"MARCO passage scale (ndocs={args.ndocs}), on phase 7's end "
        f"state; the expanded-filter class after phase 8" + at(t_start))
    if args.expand_queries < 8:
        log(f"  cut: {args.expand_queries} bodies a class (8 uncut), so "
            f"that phases 13 and 16 fit the same time limit")
    expand = phase_expand_msmarco(big, args.expand_queries)
    if args.stop_after == 12:
        return 0

    log(f"[13] compound and multi-field queries (multi_match, dis_max, "
        f"boosting, combined_fields, terms_set, pinned) and named queries "
        f"at MS MARCO passage scale (ndocs={args.ndocs}), on phase 7's end "
        f"state; the single-field multi_match, compound-filter and "
        f"wrapper classes after phase 8" + at(t_start))
    if args.compound_queries < 8:
        log(f"  cut: {args.compound_queries} bodies a class (8 uncut), so "
            f"that phases 15 and 16 fit the same time limit")
    compound = phase_compound_msmarco(big, args.compound_queries)
    if args.stop_after == 13:
        return 0

    log(f"[14] the search body's last options and the calls around a "
        f"search (count, explain, terminate_after, timeout, profile, "
        f"validate_query, field_caps, the index reads, a scroll and a point "
        f"in time) at MS MARCO passage scale (ndocs={args.ndocs}), on phase "
        f"7's end state; the rescore classes after phase 8" + at(t_start))
    options = phase_options_msmarco(big, args.context_queries)
    if args.stop_after == 14:
        return 0

    log(f"[15] the long-tail aggregations (a composite export, a "
        f"time-series panel with pipelines, top hits, multi / rare terms "
        f"and adjacency_matrix, weighted_avg, MAD, matrix_stats and "
        f"auto_date_histogram, significance and the samplers) at MS MARCO "
        f"passage scale (ndocs={args.ndocs}), on phase 7's end state"
        + at(t_start))
    if args.longtail_queries < 4:
        log(f"  cut: {args.longtail_queries} bodies a class (4 uncut), so "
            f"that phase 16 fits the same time limit")
    longtail = phase_longtail_msmarco(big, args.longtail_queries)
    if args.stop_after == 15:
        return 0

    log(f"[16] dense vectors, kNN (exact scan and balanced IVF) and hybrid "
        f"search (RRF, linear min_max / l2) at MS MARCO passage scale "
        f"(ndocs={args.ndocs}, {VEC_DIMS} dims), on phase 7's end state; "
        f"classes (a), (b), (e) again after phase 8" + at(t_start))
    vectors = phase_vectors_msmarco(big, args.vector_queries, args.seed)
    vectors["small"] = vec_small
    if args.stop_after == 16:
        return 0

    log(f"[17] learned sparse retrieval (neural_sparse on the impact "
        f"rung's FEATURE plane and the general path's sparse dot), "
        f"rank_feature and distance_feature at MS MARCO passage scale "
        f"(ndocs={args.ndocs}, {SP_TOKENS} tokens a passage over "
        f"{SP_VOCAB}), on phase 16's end state; classes (a), (c), (f) again "
        f"after phase 8" + at(t_start))
    sparse = phase_sparse_msmarco(big, args.sparse_queries, args.seed)
    sparse["small"] = sp_small
    if args.stop_after == 17:
        return 0

    log(f"[18] text analysis and the scalar field types (an english "
        f"title_en remapped on the card from the title, client_ip, stock, "
        f"grade, price_scaled, views, shop) at MS MARCO passage scale "
        f"(ndocs={args.ndocs}), on phase 17's end state; classes (a), (b), "
        f"(c), (e) again after phase 8" + at(t_start))
    fields = phase_fields_msmarco(big, args.field_queries, args.seed)
    fields["small"] = ft_small
    if args.stop_after == 18:
        return 0

    log(f"[19] query strings (query_string, simple_query_string), "
        f"function_score, script_score and a script filter at MS MARCO "
        f"passage scale (ndocs={args.ndocs}), on phase 18's end state; "
        f"classes (a), (c), (d), (e) again after phase 8" + at(t_start))
    scripts = phase_scripts_msmarco(big)
    scripts["small"] = sc_small
    if args.stop_after == 19:
        return 0

    log(f"[8] deletes, updates and a forced merge at MS MARCO passage "
        f"scale (ndocs={args.ndocs})" + at(t_start))
    log("  cut: no flush and recovery at this size (about 6 GB to write "
        "and read, and the heads' build again); phase 4 runs them small")
    writes = phase_writes_msmarco(big, rng(8))
    log("[11f] class (f), a results page with snippets, on phase 8's "
        "merged segment (the kernels decline a segment with deletes)"
        + at(t_start))
    sort["classes"]["f_snippets"] = phase_snippets_merged(
        big, args.sort_queries)
    log("[12f] phase 12's bool with an expanded filter, on phase 8's "
        "merged segment (the kernels decline a segment with deletes)"
        + at(t_start))
    expand["bool_expanded_filter"] = phase_expand_filter_merged(
        big, args.expand_queries)
    xf = expand["bool_expanded_filter"]["counts"]
    log("[13m] phase 13's single-field multi_match, compound filter and "
        "wrapper classes, on phase 8's merged segment (the kernels decline "
        "a segment with deletes)" + at(t_start))
    compound["merged"] = phase_compound_merged(big, args.compound_queries)
    cm = compound["merged"]
    log("[14m] phase 14's rescore classes, on phase 8's merged segment (the "
        "kernels decline a segment with deletes)" + at(t_start))
    options["rescore"] = phase_rescore_merged(big, args.context_queries)
    rc = [r["counts"] for r in options["rescore"].values()]
    log("[16m] phase 16's classes (a), (b) and (e), on phase 8's merged "
        "segment (its IVF index rebuilt)" + at(t_start))
    vectors["merged"] = phase_vectors_merged(big)
    vh = vectors["merged"]["classes"]["e_hybrid"]["counts"]
    log("[17m] phase 17's classes (a), (c) and (f), on phase 8's merged "
        "segment (its FEATURE plane rebuilt by the merge)" + at(t_start))
    sparse["merged"] = phase_sparse_merged(big)
    sh = sparse["hybrid_launches"]
    log("[18m] phase 18's classes (a), (b), (c) and (e), on phase 8's "
        "merged segment (title_en's plane and the columns carried by the "
        "merge)" + at(t_start))
    fields["merged"] = phase_fields_merged(big)
    fm = {k: v["counts"] for k, v in fields["merged"]["classes"].items()}
    log("[19m] phase 19's classes (a), (c), (d) and (e)'s script-filtered "
        "match, on phase 8's merged segment" + at(t_start))
    scripts["merged"] = phase_scripts_merged(big)
    scm = {k: v["counts"] for k, v in scripts["merged"]["classes"].items()}

    kernels = [{
        "name": "fused_bm25_topk_tfdl", "route": "cuda",
        "source": "opensearch_tpu_torch/csrc/bm25_tfdl.cu",
        "replaces": "opensearch_tpu/ops/pallas_bm25.py:343",
        "launches": big["tfdl_launches"],
        "launches_results_page": sort["classes"]["f_snippets"]["launches"]
        .get("launches", 0),
        "launches_expanded_filter": xf["launches"],
        "launches_compound": cm["wrapper"]["counts"]["launches"],
        "launches_body_options": sum(c["launches"] for c in rc),
        "launches_hybrid": vh["launches"],
        "launches_sparse_hybrid": sh["launches"],
        "launches_fields": sum(c["launches"] for c in fm.values()),
        "launches_scripts": sum(c["launches"] for c in scm.values()),
        "max_abs_err": max(grid["max_abs_err"], egrid["max_abs_err"],
                           big["max_abs_err"]),
        **times(big["b1"]), "bound_by": "bytes",
        "library_ms": None, "parity": "exact"}, {
        "name": "fused_bm25_topk_impact", "route": "cuda",
        "source": "opensearch_tpu_torch/csrc/bm25_impact.cu",
        "replaces": "opensearch_tpu/ops/pallas_bm25.py:820",
        "launches": big["impact_launches"],
        "launches_results_page": sort["classes"]["f_snippets"]["launches"]
        .get("impact_launches", 0),
        "launches_compound": cm["wrapper"]["counts"]["impact_launches"],
        "launches_body_options": sum(c["impact_launches"] for c in rc),
        "launches_hybrid": vh["impact_launches"],
        "launches_sparse_hybrid": sh["impact_launches"],
        "launches_fields": sum(c["impact_launches"] for c in fm.values()),
        "launches_scripts": sum(c["impact_launches"] for c in scm.values()),
        "max_abs_err": max(igrid["max_abs_err"], egrid["max_abs_err"],
                           big["max_abs_err"]),
        **times(big["b2"]), "bound_by": "bytes",
        "library_ms": None, "parity": "exact"}, {
        "name": "fused_bm25_bool_topk", "route": "cuda",
        "source": "opensearch_tpu_torch/csrc/bm25_bool.cu",
        "replaces": "opensearch_tpu/ops/pallas_bm25.py:570",
        "launches": bools["bool_launches"],
        "launches_expanded_filter": xf["bool_launches"],
        "launches_compound": sum(cm[k]["counts"]["bool_launches"]
                                 for k in ("mm_one_field",
                                           "compound_filter")),
        "launches_body_options": sum(c["bool_launches"] for c in rc),
        "launches_fields": sum(c["bool_launches"] for c in fm.values()),
        "launches_scripts": sum(c["bool_launches"] for c in scm.values()),
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
    print(json.dumps({"phrase": {k: {kk: vv for kk, vv in v.items()
                                     if kk != "batch_ms"}
                                 for k, v in phrase.items()}}), flush=True)
    print(json.dumps({"general_path": general}), flush=True)
    print(json.dumps({"aggs": aggs}), flush=True)
    print(json.dumps({"writes": writes}), flush=True)
    print(json.dumps({"results_page": sort}), flush=True)
    print(json.dumps({"expand": {k: {kk: vv for kk, vv in v.items()
                                     if kk != "batch_ms"}
                                 for k, v in expand.items()}}), flush=True)
    print(json.dumps({"compound": {
        "classes": {**compound["classes"], **compound["merged"]},
        "device_bytes": compound["device_bytes"]}}), flush=True)
    print(json.dumps({"body_options": options}), flush=True)
    print(json.dumps({"longtail_aggs": longtail}), flush=True)
    print(json.dumps({"vectors": vectors}), flush=True)
    print(json.dumps({"sparse": sparse}), flush=True)
    print(json.dumps({"fields": fields}), flush=True)
    print(json.dumps({"scripts": scripts}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
