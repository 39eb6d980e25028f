"""Positional joins: phrase / span-near matching (opensearch_tpu/ops/
positions.py), as torch ops on any device.

Each query term carries its (doc, position) pairs over the segment,
lexicographically sorted, one i64 key per pair:

    key = doc << 32 | (position + 2^31)

The bias keeps the order of the pairs for any i32 position, negative ones
included (the ordered join can ask for one), so `torch.searchsorted` over
the keys is the reference's binary search over (doc, position) pairs. A
doc of INT32_SENTINEL (the reference's pad) still sorts last.

Term 0's pairs are the anchors. For an anchor (d, p) each other term i
finds its nearest occurrence in doc d, shifted by its query offset i; the
anchor's cost over those moves is compared against the slop, and an
anchor that passes weighs 1/(1 + cost) (Lucene's sloppyFreq). Three cost
modes, as the reference has them:
- the default (match_phrase slop): total movement against the median of
  the per-term displacements;
- `gap_cost` (span_near, intervals): positions of the span not covered by
  a query term;
- `ordered` (span_near in_order, intervals ordered): a greedy join, term i
  at its earliest position after term i-1's; the cost is the gaps.

The per-doc frequency is the sum of a doc's anchor weights in anchor
order, as the reference's scatter-add on the CPU applies them: anchors are
sorted by doc, so `accumulate_freqs` adds each doc's run one rank at a
time, with no atomics, and the sums are equal on every device and run to
run. Anchors of a doc outside [0, ndocs) (the sentinel pad) are dropped.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .scoring import posting_contrib

INT32_SENTINEL = 2**31 - 1
BIG_COST = 1e9
POS_BIAS = 1 << 31
_LOW32 = 0xFFFFFFFF


def pair_keys(d: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """i64 sort keys of (doc, position) pairs (i32 docs >= 0, any i32
    positions)."""
    return (d.to(torch.int64) << 32) | (p.to(torch.int64) + POS_BIAS)


def key_docs(keys: torch.Tensor) -> torch.Tensor:
    return (keys >> 32).to(torch.int32)


def key_positions(keys: torch.Tensor) -> torch.Tensor:
    return ((keys & _LOW32) - POS_BIAS).to(torch.int32)


def search_pairs(keys: torch.Tensor, dq: torch.Tensor,
                 pq: torch.Tensor) -> torch.Tensor:
    """Index of the first pair of `keys` that is >= (dq, pq), per query
    (i64)."""
    return torch.searchsorted(keys, pair_keys(dq, pq))


def nearest_delta(keys: torch.Tensor, d0: torch.Tensor, base: torch.Tensor,
                  shift: int = 0):
    """Signed displacement (position - shift - base, f32) of the term's
    occurrence nearest the anchor within the anchor's doc, and a found
    flag. On a tie the later occurrence wins."""
    n = keys.numel()
    idx = search_pairs(keys, d0, base + shift)
    rk = keys[idx.clamp(max=n - 1)]
    right_ok = (idx < n) & (key_docs(rk) == d0)
    right_delta = (key_positions(rk) - shift - base).to(torch.float32)
    big = torch.tensor(BIG_COST, dtype=torch.float32, device=keys.device)
    right_cost = torch.where(right_ok, right_delta, big)
    lk = keys[(idx - 1).clamp(min=0)]
    left_ok = (idx > 0) & (key_docs(lk) == d0)
    left_delta = (key_positions(lk) - shift - base).to(torch.float32)
    left_cost = torch.where(left_ok, -left_delta, big)
    delta = torch.where(right_cost <= left_cost, right_delta, left_delta)
    return delta, right_ok | left_ok


def anchor_weights(anchor_d: torch.Tensor, anchor_p: torch.Tensor,
                   others: Sequence[torch.Tensor], slop: float,
                   ordered: bool = False, gap_cost: bool = False,
                   shifts: Optional[Sequence[int]] = None) -> torch.Tensor:
    """f32 weight of each anchor: 1/(1 + cost) where every term occurs
    and the cost is within `slop`, else 0. `others` are the other terms'
    pair keys, `shifts` their query offsets (default 0)."""
    dev = anchor_d.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ok = anchor_d != INT32_SENTINEL
    m = len(others) + 1
    if shifts is None:
        shifts = [0] * len(others)
    if any(k.numel() == 0 for k in others):
        return torch.zeros(anchor_d.shape, dtype=torch.float32, device=dev)
    if ordered:
        prev = torch.zeros_like(anchor_p)      # delta_0 = 0
        for keys, sh in zip(others, shifts):
            n = keys.numel()
            idx = search_pairs(keys, anchor_d, anchor_p + prev + sh)
            k = keys[idx.clamp(max=n - 1)]
            ok = ok & (idx < n) & (key_docs(k) == anchor_d)
            prev = key_positions(k) - sh - anchor_p
        cost = prev.to(torch.float32)          # = the span's gaps
    elif m > 1:
        deltas = [torch.zeros(anchor_d.shape, dtype=torch.float32,
                              device=dev)]
        for keys, sh in zip(others, shifts):
            di, found = nearest_delta(keys, anchor_d, anchor_p, sh)
            ok = ok & found
            deltas.append(di)
        if gap_cost:
            abs_off = [di + float(i) for i, di in enumerate(deltas)]
            span_hi = span_lo = abs_off[0]
            for a in abs_off[1:]:
                span_hi = torch.maximum(span_hi, a)
                span_lo = torch.minimum(span_lo, a)
            cost = span_hi - span_lo + 1.0 - float(m)
        else:
            med = torch.sort(torch.stack(deltas, dim=1),
                             dim=1).values[:, m // 2]
            cost = torch.zeros(anchor_d.shape, dtype=torch.float32,
                               device=dev)
            for di in deltas:
                cost = cost + torch.abs(di - med)
    else:
        cost = torch.zeros(anchor_d.shape, dtype=torch.float32, device=dev)
    ok = ok & (cost <= torch.tensor(slop, dtype=torch.float32, device=dev))
    return torch.where(ok, 1.0 / (1.0 + cost), zero)


def accumulate_freqs(anchor_d: torch.Tensor, w: torch.Tensor,
                     ndocs: int) -> torch.Tensor:
    """Dense f32[ndocs] sum of the anchors' weights per doc, each doc's
    in anchor order ((0 + w_0) + w_1) + ...: its run of anchors (anchors
    are sorted by doc) is added one rank per step, so no two adds of a
    step meet at one doc. Docs outside [0, ndocs) are dropped."""
    dev = w.device
    freq = torch.zeros(ndocs, dtype=torch.float32, device=dev)
    n = anchor_d.numel()
    if n == 0:
        return freq
    d = anchor_d.to(torch.int64)
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = d[1:] != d[:-1]
    firsts = torch.nonzero(head).flatten()
    ends = torch.cat([firsts[1:], torch.full((1,), n, dtype=torch.int64,
                                             device=dev)])
    keep = (d[firsts] >= 0) & (d[firsts] < ndocs)
    firsts, ends = firsts[keep], ends[keep]
    if firsts.numel() == 0:
        return freq
    run = int((ends - firsts).max())
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    acc = w[firsts]
    for k in range(1, run):
        idx = firsts + k
        acc = acc + torch.where(idx < ends, w[idx.clamp(max=n - 1)], zero)
    freq[d[firsts]] = acc
    return freq


def phrase_freqs(anchor_d: torch.Tensor, anchor_p: torch.Tensor,
                 others: List[torch.Tensor], slop: float, ndocs: int,
                 ordered: bool = False, gap_cost: bool = False,
                 shifts: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Dense per-doc sloppy phrase frequency f32[ndocs] (the reference's
    `phrase_freqs`; `others` as pair keys)."""
    w = anchor_weights(anchor_d, anchor_p, others, slop, ordered=ordered,
                       gap_cost=gap_cost, shifts=shifts)
    return accumulate_freqs(anchor_d, w, ndocs)


def phrase_score(freq: torch.Tensor, dl: torch.Tensor, live: torch.Tensor,
                 weight: float, k1: float, b: float, avgdl: float):
    """BM25 over the phrase frequency, the phrase scored as one
    pseudo-term whose weight is the terms' idf sum: -> (scores f32,
    matched bool), zero outside `live` and where the phrase is absent."""
    dev = freq.device
    scores = posting_contrib(
        freq, dl, torch.tensor(weight, dtype=torch.float32, device=dev),
        k1, b, torch.tensor(avgdl, dtype=torch.float32, device=dev))
    matched = (freq > 0) & live
    return torch.where(matched, scores, torch.zeros((), dtype=torch.float32,
                                                    device=dev)), matched
