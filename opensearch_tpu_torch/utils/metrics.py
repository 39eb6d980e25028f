"""Latency sketches for an index's stats: the sparse DDSketch histogram and
its nearest-rank percentiles (the part of opensearch_tpu/utils/metrics.py
that `indices.stats` reads), and the per-index refresh-to-visible sketch
each refresh feeds (the reference's ingest instrumentation).

A value's bin is the aggregations' f32 DDSketch bin (`ops/aggs.py`), so a
percentile is the representative value of the bin holding the
ceil(p/100 n)-th smallest value. The sketches live in one process-wide
registry keyed by name, as the reference's do.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

import numpy as np

from ..ops.aggs import DD_HALF, DD_LN_GAMMA, DD_MIN_MAG, ddsketch_value


class LatencyHistogram:
    """Sparse DDSketch of millisecond values: bin index -> count."""

    def __init__(self, name: str):
        self.name = name
        self._bins: Dict[int, int] = {}
        self.count = 0
        self.sum_ms = 0.0
        self._lock = threading.Lock()

    def record_many(self, values) -> None:
        arr = np.asarray(values, dtype=np.float64)
        if arr.size == 0:
            return
        mag = np.abs(arr).astype(np.float32)
        ln = np.log(np.maximum(mag, np.float32(DD_MIN_MAG)))
        idx = np.floor((ln - np.float32(np.log(DD_MIN_MAG)))
                       / np.float32(DD_LN_GAMMA)).astype(np.int64)
        np.clip(idx, 0, DD_HALF - 1, out=idx)
        b = np.where(arr > 0, DD_HALF + 1 + idx,
                     np.where(arr < 0, DD_HALF - 1 - idx, DD_HALF))
        bins_u, counts = np.unique(b, return_counts=True)
        with self._lock:
            for bi, c in zip(bins_u.tolist(), counts.tolist()):
                self._bins[bi] = self._bins.get(bi, 0) + c
            self.count += int(arr.size)
            self.sum_ms += float(arr.sum())

    def percentile(self, p: float) -> Optional[float]:
        with self._lock:
            total = self.count
            bins = dict(self._bins)
        return sketch_percentile(bins, total, p)

    def snapshot(self, percentiles: Sequence[float] = (50, 95, 99)) -> dict:
        out = {"count": self.count, "sum_ms": round(self.sum_ms, 3)}
        for p in percentiles:
            v = self.percentile(p)
            out[f"p{int(p) if float(p).is_integer() else p}_ms"] = (
                round(v, 4) if v is not None else None)
        return out


def sketch_percentile(bins: Dict[int, int], total: int,
                      p: float) -> Optional[float]:
    """Nearest-rank percentile over sparse DDSketch bins."""
    if total <= 0:
        return None
    items = sorted(bins.items())
    if not items:
        return None
    rank = max(1, -(-int(p * total) // 100))     # ceil(p/100 * total)
    cum = 0
    for b, c in items:
        cum += c
        if cum >= rank:
            return float(ddsketch_value(b))
    return float(ddsketch_value(items[-1][0]))


_HISTS: Dict[str, LatencyHistogram] = {}
_LOCK = threading.Lock()


def histogram(name: str) -> LatencyHistogram:
    h = _HISTS.get(name)
    if h is None:
        with _LOCK:
            h = _HISTS.setdefault(name, LatencyHistogram(name))
    return h


def percentiles(name: str, ps: Sequence[float] = (50, 95, 99)) -> dict:
    """The named sketch's snapshot, {} until it has recorded."""
    h = _HISTS.get(name)
    return {} if h is None else h.snapshot(ps)


def refresh_to_visible_name(index_name: str) -> str:
    return f"indexing.index.{index_name}.refresh_to_visible_ms"


def record_refresh_to_visible(index_name: str, accept_stamps,
                              now_mono: float) -> None:
    """One refresh's accept-to-searchable delays, in ms, into the index's
    sketch (an engine without an index name records nothing)."""
    if not accept_stamps or not index_name:
        return
    deltas = (now_mono - np.asarray(accept_stamps, np.float64)) * 1000.0
    np.clip(deltas, 0.0, None, out=deltas)
    histogram(refresh_to_visible_name(index_name)).record_many(deltas)
