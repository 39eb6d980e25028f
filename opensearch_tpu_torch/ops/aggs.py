"""Aggregation ops: torch counterparts of opensearch_tpu/ops/aggs.py (jnp
there, not Pallas), run on the engine's device.

Every op takes `match`, the query's bool[ndocs] match mask, already
ANDed with the live mask. Counts are integers: exact, the same under
CUDA atomics in any order, and equal to the reference's f32 counts
wherever those are exact (below 2^24 per bucket and segment). Sums and
sums of squares are f32, as in the reference; their order of addition
differs by device, so they agree with the reference's within f32
rounding. Minima and maxima are exact.

A bucketed op takes `bucket` i64[n] with the dropped entries at `nb`,
one past the last bucket, and returns [nb] arrays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

F32_MAX = float(np.float32(3.4e38))


def bucket_counts(bucket: torch.Tensor, nb: int) -> torch.Tensor:
    """i64[nb] entries per bucket (entries at `nb` dropped)."""
    return torch.bincount(bucket, minlength=nb + 1)[:nb]


def bucket_metrics(bucket: torch.Tensor, nb: int, v: torch.Tensor
                   ) -> Tuple[torch.Tensor, ...]:
    """(sums f32, counts i64, mins f32, maxs f32, sums of squares f32)
    per bucket of the values `v` (f32[n]): the reference's per-bucket
    scatters (`terms_sub_metric`, compiler `_emit_bucketed_sub`). An
    empty bucket has min F32_MAX and max -F32_MAX, as there."""
    dev = v.device
    sums = torch.zeros(nb + 1, dtype=torch.float32, device=dev)
    sums.index_add_(0, bucket, v)
    sumsq = torch.zeros(nb + 1, dtype=torch.float32, device=dev)
    sumsq.index_add_(0, bucket, v * v)
    mins = torch.full((nb + 1,), F32_MAX, dtype=torch.float32, device=dev)
    mins.scatter_reduce_(0, bucket, v, "amin")
    maxs = torch.full((nb + 1,), -F32_MAX, dtype=torch.float32, device=dev)
    maxs.scatter_reduce_(0, bucket, v, "amax")
    return (sums[:nb], bucket_counts(bucket, nb), mins[:nb], maxs[:nb],
            sumsq[:nb])


def value_buckets(ords: torch.Tensor, doc_of_value: torch.Tensor,
                  match: torch.Tensor, nvocab: int) -> torch.Tensor:
    """i64[V]: the ordinal of each keyword value whose doc matches, else
    `nvocab` (dropped)."""
    return torch.where(match[doc_of_value], ords,
                       torch.full_like(ords, nvocab))


def terms_counts(kw, match: torch.Tensor, nvocab: int) -> torch.Tensor:
    """Keyword terms agg: i64[nvocab] matched docs per ordinal."""
    ords, docs, _min_ord = kw
    return bucket_counts(value_buckets(ords, docs, match, nvocab), nvocab)


def terms_sub_metric(kw, match: torch.Tensor, values: torch.Tensor,
                     present: torch.Tensor, nvocab: int):
    """Per-ordinal (sum, count, min, max, sum of squares) of a numeric
    column's f32 view over the matched docs that have a value."""
    ords, docs, _min_ord = kw
    ok = match & present
    return bucket_metrics(value_buckets(ords, docs, ok, nvocab), nvocab,
                          values[docs])


def doc_buckets(bucket_of_doc: torch.Tensor, valid: torch.Tensor,
                nb: int) -> torch.Tensor:
    """i64[ndocs]: each valid doc's bucket, else `nb` (dropped)."""
    return torch.where(valid & (bucket_of_doc >= 0) & (bucket_of_doc < nb),
                       bucket_of_doc.long(),
                       torch.full_like(bucket_of_doc, nb, dtype=torch.int64))


def histogram_buckets(values: torch.Tensor, present: torch.Tensor,
                      match: torch.Tensor, interval: float, offset: float,
                      min_bucket: int, nb: int) -> torch.Tensor:
    """i64[ndocs] fixed-interval histogram buckets (the reference's f32
    `floor((v - offset) / interval)`), dropped outside [0, nb)."""
    b = torch.floor((values - float(np.float32(offset)))
                    / float(np.float32(interval))).to(torch.int32) \
        - min_bucket
    return doc_buckets(b, match & present, nb)


def range_counts(values: torch.Tensor, present: torch.Tensor,
                 match: torch.Tensor, lows, highs) -> torch.Tensor:
    """range agg: i64[nranges] matched docs with a value in [low, high);
    the bounds are f32 values."""
    ok = match & present
    return torch.stack([(ok & (values >= float(lo)) & (values < float(hi)))
                        .sum() for lo, hi in zip(lows, highs)])


def stats_agg(values: torch.Tensor, present: torch.Tensor,
              match: torch.Tensor):
    """(count i64, sum, min, max, sum of squares) of the matched values in
    one pass (the reference's StatsAggregator)."""
    ok = match & present
    v = torch.where(ok, values, torch.zeros_like(values))
    return (ok.sum(), v.sum(), torch.where(ok, values, F32_MAX).min(),
            torch.where(ok, values, -F32_MAX).max(), (v * v).sum())


def value_count_keyword(kw, match: torch.Tensor) -> torch.Tensor:
    """Matched keyword values (a doc counts once per distinct value)."""
    _ords, docs, _min_ord = kw
    return match[docs].sum()


# ---------------------------------------------------------------------
# cardinality: HyperLogLog registers (mergeable by elementwise max)
# ---------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def hash_f32(v: torch.Tensor) -> torch.Tensor:
    """i64[n] in [0, 2^32): fmix32 (MurmurHash3) of the f32 bit patterns,
    in i64 arithmetic masked to 32 bits (the reference's u32 ops)."""
    h = v.contiguous().view(torch.int32).to(torch.int64) & _M32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def hll_registers(hashes: torch.Tensor, valid: torch.Tensor,
                  log2m: int = 14) -> torch.Tensor:
    """i32[2^log2m] HyperLogLog registers from 32-bit hashes (i64 values):
    register = the low log2m bits, rank = 1 + the leading zeros of the
    remaining 32 - log2m bits. The reference computes the rank as
    (nbits + 1) - ceil(log2(f32(rest) + 1)); for an integer rest below
    2^18 that is (nbits + 1) - bit_length(rest), taken here exactly from
    the exponent of `frexp`."""
    m = 1 << log2m
    nbits = 32 - log2m
    reg = torch.where(valid, hashes & (m - 1), torch.full_like(hashes, m))
    rest = (hashes >> log2m).to(torch.float32)
    rank = (nbits + 1) - torch.frexp(rest).exponent.to(torch.int32)
    rank = torch.where(valid, rank.clamp(1, nbits + 1),
                       torch.zeros_like(rank))
    out = torch.zeros(m + 1, dtype=torch.int32, device=hashes.device)
    out.scatter_reduce_(0, reg, rank, "amax")
    return out[:m]


def cardinality_numeric_registers(values: torch.Tensor,
                                  present: torch.Tensor,
                                  match: torch.Tensor,
                                  log2m: int = 14) -> torch.Tensor:
    return hll_registers(hash_f32(values), match & present, log2m)


def cardinality_keyword_registers(kw, match: torch.Tensor, nvocab: int,
                                  ord_hashes: torch.Tensor,
                                  log2m: int = 14) -> torch.Tensor:
    """HLL over the per-ordinal string hashes (i64[nvocab], crc32 of each
    vocab string) of the ordinals some matched doc holds."""
    return hll_registers(ord_hashes, terms_counts(kw, match, nvocab) > 0,
                         log2m)


# ---------------------------------------------------------------------
# percentiles: the reference's DDSketch-style log-binned histogram, its
# bins global constants so histograms merge by addition
# ---------------------------------------------------------------------

DD_HALF = 4096
DD_MIN_MAG = 1e-9
DD_MAX_MAG = 1e9
DD_LN_GAMMA = (np.log(DD_MAX_MAG) - np.log(DD_MIN_MAG)) / DD_HALF
DD_NBINS = 2 * DD_HALF + 1
# the reference's device arithmetic runs in f32 with f32 constants
_F32_MIN_MAG = float(np.float32(DD_MIN_MAG))
_F32_LN_MIN = float(np.float32(np.log(DD_MIN_MAG)))
_F32_LN_GAMMA = float(np.float32(DD_LN_GAMMA))


def ddsketch_bins(values: torch.Tensor) -> torch.Tensor:
    """i64[n] sketch bin of each f32 value: floor((log(max(|v|, min)) -
    log(min)) / ln_gamma) in f32, mirrored below zero, DD_HALF at 0. The
    log is taken in f64 and rounded to f32: torch's f32 log takes a
    vectorised or a scalar path by an element's place in its thread's
    chunk, and the two differ by an ulp on some inputs, which would move
    a value at a bin edge with the thread count."""
    mag = values.abs()
    ln = torch.log(torch.clamp(mag, min=_F32_MIN_MAG).double()).float()
    idx = torch.floor((ln - _F32_LN_MIN) / _F32_LN_GAMMA).to(torch.int64)
    idx = idx.clamp(0, DD_HALF - 1)
    return torch.where(values > 0, DD_HALF + 1 + idx,
                       torch.where(values < 0, DD_HALF - 1 - idx,
                                   torch.full_like(idx, DD_HALF)))


def ddsketch_hist(values: torch.Tensor, present: torch.Tensor,
                  match: torch.Tensor) -> torch.Tensor:
    """i64[DD_NBINS] mergeable quantile histogram of the matched values."""
    b = torch.where(match & present, ddsketch_bins(values),
                    torch.full(values.shape, DD_NBINS, dtype=torch.int64,
                               device=values.device))
    return bucket_counts(b, DD_NBINS)


def ddsketch_bin(v: float) -> int:
    """Host bin of one value with the device's f32 arithmetic
    (percentile_ranks inverts percentiles through it)."""
    mag = np.float32(abs(v))
    ln = np.log(np.maximum(mag, np.float32(DD_MIN_MAG)))
    idx = int(np.floor((ln - np.float32(np.log(DD_MIN_MAG)))
                       / np.float32(DD_LN_GAMMA)))
    idx = min(max(idx, 0), DD_HALF - 1)
    if v > 0:
        return DD_HALF + 1 + idx
    if v < 0:
        return DD_HALF - 1 - idx
    return DD_HALF


def ddsketch_value(b: int) -> float:
    """Representative value of bin b (host finalize)."""
    if b == DD_HALF:
        return 0.0
    if b > DD_HALF:
        return float(DD_MIN_MAG * np.exp((b - DD_HALF - 1 + 0.5)
                                         * DD_LN_GAMMA))
    return float(-DD_MIN_MAG * np.exp((DD_HALF - 1 - b + 0.5)
                                      * DD_LN_GAMMA))


# ---------------------------------------------------------------------
# the long-tail kinds: weighted_avg, ordinal counts, composite ordinals,
# matrix_stats' power sums, the samplers
# ---------------------------------------------------------------------

def weighted_avg_agg(v: torch.Tensor, v_present: torch.Tensor,
                     w: torch.Tensor, w_present: torch.Tensor,
                     match: torch.Tensor, v_missing: float, w_missing: float,
                     has_v_missing: bool, has_w_missing: bool) -> tuple:
    """(sum of value x weight f32, sum of weight f32, docs i64) over the
    matched docs (the reference's WeightedAvgAggregator): a doc without
    a value or a weight counts only where that side has a `missing`
    default, which then stands in (an f32, as the reference's param)."""
    veff = torch.where(v_present, v, float(np.float32(v_missing)))
    weff = torch.where(w_present, w, float(np.float32(w_missing)))
    ok = match
    if not has_v_missing:
        ok = ok & v_present
    if not has_w_missing:
        ok = ok & w_present
    zero = torch.zeros((), dtype=torch.float32, device=v.device)
    return (torch.where(ok, veff * weff, zero).sum(),
            torch.where(ok, weff, zero).sum(), ok.sum())


def geo_bounds_agg(lat: torch.Tensor, lon: torch.Tensor,
                   present: torch.Tensor, match: torch.Tensor) -> tuple:
    """(top, bottom, left, right, count) over the matched docs with a
    point (the reference's GeoBoundsAggregator, no longitude wrap):
    +-F32_MAX sentinels where no doc counts."""
    ok = match & present
    big = torch.full((), F32_MAX, dtype=torch.float32, device=lat.device)
    return (torch.where(ok, lat, -big).max(), torch.where(ok, lat, big).min(),
            torch.where(ok, lon, big).min(), torch.where(ok, lon, -big).max(),
            ok.sum())


def geo_centroid_agg(lat: torch.Tensor, lon: torch.Tensor,
                     present: torch.Tensor, match: torch.Tensor) -> tuple:
    """(sum of lat f32, sum of lon f32, count) over the matched docs with
    a point (the reference's GeoCentroidAggregator)."""
    ok = match & present
    zero = torch.zeros((), dtype=torch.float32, device=lat.device)
    return (torch.where(ok, lat, zero).sum(), torch.where(ok, lon, zero).sum(),
            ok.sum())


def ord_counts(ords: torch.Tensor, match: torch.Tensor,
               nord: int) -> torch.Tensor:
    """i64[nord] matched docs per doc-major ordinal (multi_terms'
    combined ordinals); an ordinal below 0 (missing) is dropped."""
    return bucket_counts(ord_buckets(ords, match, nord), nord)


def ord_buckets(ords: torch.Tensor, match: torch.Tensor,
                nord: int) -> torch.Tensor:
    """i64[ndocs]: each matched doc's ordinal, else `nord` (dropped)."""
    return torch.where(match & (ords >= 0), ords.long(),
                       torch.full(ords.shape, nord, dtype=torch.int64,
                                  device=ords.device))


def composite_buckets(ords: list, sizes: list,
                      match: torch.Tensor) -> tuple:
    """(i64[ndocs] combined ordinal of each matched doc holding a value
    of every source, else `total`; total): the reference's
    `combined * n + o` over the sources in order, in i64. Each source's
    ordinal is i32/i64[ndocs] in [0, n), below 0 where the doc lacks
    it."""
    dev = match.device
    combined = torch.zeros(match.shape, dtype=torch.int64, device=dev)
    valid = match
    total = 1
    for o, n in zip(ords, sizes):
        valid = valid & (o >= 0)
        combined = combined * n + o.long().clamp(min=0)
        total *= max(n, 1)
    return torch.where(valid, combined,
                       torch.full_like(combined, total)), total


def histogram_source_ords(values: torch.Tensor, present: torch.Tensor,
                          interval: float, min_bucket: int,
                          nb: int) -> torch.Tensor:
    """i32[ndocs] a composite histogram source's bucket, floor(f32 value
    / f32 interval) less `min_bucket`, -1 outside [0, nb) or missing."""
    o = torch.floor(values / float(np.float32(interval))).to(
        torch.int32) - min_bucket
    return torch.where(present & (o >= 0) & (o < nb), o,
                       torch.full_like(o, -1))


def matrix_stats_sums(cols: list, shift: np.ndarray,
                      match: torch.Tensor) -> dict:
    """matrix_stats' power sums over the docs that match and hold every
    field: count i64, s1..s4 f32[k] of (x - shift) and the pairwise
    products xy f32[k, k], the columns centred about the f32 `shift` as
    the reference centres them (its power sums are f32). Each pair's
    products are summed by torch's reduction, as the powers are: the
    CPU's f32 matrix product accumulates a dot product over millions of
    docs less accurately than the reference's sums need."""
    ok = match
    for _v, p in cols:
        ok = ok & p
    dev = match.device
    x = torch.stack([v for v, _p in cols]) - torch.from_numpy(
        np.asarray(shift, np.float32)).to(dev)[:, None]
    xw = x * ok.to(torch.float32)[None, :]
    return {"count": ok.sum(), "s1": xw.sum(dim=1),
            "s2": (xw * x).sum(dim=1), "s3": (xw * x * x).sum(dim=1),
            "s4": (xw * x * x * x).sum(dim=1),
            "xy": torch.stack([(xw[i] * x).sum(dim=1)
                               for i in range(len(cols))])}


def sampler_select(match: torch.Tensor, scores: torch.Tensor,
                   shard_size: int, thr=None) -> tuple:
    """(bool[ndocs] the sampled docs, f32[k] the segment's top scores or
    None): the matched docs scoring at least the shard_size-th best
    (score ties there admit more), or at least a shard-wide `thr` (the
    sampler's second pass)."""
    dev = match.device
    masked = torch.where(match, scores,
                         torch.full((), float("-inf"), device=dev))
    if thr is not None:
        return match & (masked >= float(np.float32(thr))), None
    k = min(int(shard_size), masked.shape[0])
    vals = torch.topk(masked, k).values
    t = vals[k - 1]
    t = torch.where(torch.isfinite(t), t,
                    torch.full((), float("-inf"), device=dev))
    return match & (masked >= t), vals


def diversify(sel: torch.Tensor, ords: torch.Tensor, scores: torch.Tensor,
              max_per_value: int) -> torch.Tensor:
    """bool[ndocs]: at most `max_per_value` sampled docs per key (the
    reference's diversified sampler). Its rounds take, per key, the best
    remaining score, ties to the lowest doc, `max_per_value` times: the
    same docs as each key's first `max_per_value` in (score desc, doc
    asc) order, which two stable sorts of the sampled keyed docs give.
    Docs without a key (ord < 0) stay."""
    keyed = ords >= 0
    chosen = sel & ~keyed
    docs = torch.nonzero(sel & keyed).reshape(-1)
    if docs.numel() == 0:
        return chosen
    o = torch.argsort(-scores[docs], stable=True)
    g = ords[docs].long()[o]
    by_key = torch.argsort(g, stable=True)
    o, g = o[by_key], g[by_key]
    pos = torch.arange(len(g), device=g.device)
    head = torch.ones_like(g, dtype=torch.bool)
    head[1:] = g[1:] != g[:-1]
    first = torch.cummax(torch.where(head, pos, torch.zeros_like(pos)),
                         0).values
    chosen[docs[o[pos - first < max_per_value]]] = True
    return chosen
