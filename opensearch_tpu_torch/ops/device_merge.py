"""Device-side sorted-run merge and codec-v2 impact quantizer (a port of
opensearch_tpu/ops/device_merge.py as torch ops on the engine's device).

`merge_sorted_runs` is the compute core of a segment merge
(`index/merge.py`): each input's postings, remapped to (union row, new
doc, tf) triples, are sorted by (row, doc) and sliced into CSR runs. At
DEVICE_MERGE_MIN postings and above the sort runs on the device as one
stable sort of the composite key `row << 32 | doc`, carrying the source
index (`order`) and the tf; below it the numpy branch of the merge runs,
as the reference splits them. Both equal `np.lexsort((docs, rows))`
bit for bit.

Above DEVICE_IMPACT_MIN postings the quantizer runs as torch ops on the
engine's device, so refresh does not serialize on a host pass; below it
the numpy branch of `index/segment.build_impact_plane` runs (and of
`build_feature_impact_plane` for a feature field's weights). The f32
expression, the global scale and round-half-to-even match the reference's
jitted quantizer; every scalar is a 0-d tensor on the device, so each
operation rounds once in f32 as the reference's weak-typed scalars do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# below this many postings the device round trip costs more than numpy
DEVICE_MERGE_MIN = 1 << 16
DEVICE_IMPACT_MIN = 1 << 16


def merge_sorted_runs(rows: np.ndarray, docs: np.ndarray, tfs: np.ndarray,
                      n_rows: int, device=None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]:
    """-> (rows i32, docs i32, tfs f32, order i32, per-row counts i32),
    sorted by (row, doc) on `device` (the CPU when None). `order` is the
    permutation applied; rows lie in [0, n_rows) and docs in [0, 2^31)."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    r = torch.from_numpy(np.ascontiguousarray(rows, np.int32)).to(dev)
    d = torch.from_numpy(np.ascontiguousarray(docs, np.int32)).to(dev)
    key = (r.to(torch.int64) << 32) | d.to(torch.int64)
    del r, d
    key, order = torch.sort(key, stable=True)
    t = torch.from_numpy(np.ascontiguousarray(tfs, np.float32)).to(dev)
    t = t[order]
    r = (key >> 32).to(torch.int32)
    d = (key & 0xFFFFFFFF).to(torch.int32)
    del key
    counts = torch.bincount(r, minlength=n_rows)[:n_rows].to(torch.int32)
    return (r.cpu().numpy(), d.cpu().numpy(), t.cpu().numpy(),
            order.to(torch.int32).cpu().numpy(), counts.cpu().numpy())


def use_device_merge(total_postings: int) -> bool:
    return total_postings >= DEVICE_MERGE_MIN


def quantize_impacts(tfs: np.ndarray, dl_of: np.ndarray, k1: float,
                     b: float, avgdl: float, qmax: int, device=None
                     ) -> Tuple[np.ndarray, float]:
    """-> (q i32[P], scale): quantized eager impacts computed on `device`
    (the CPU when None)."""
    dev = torch.device("cpu") if device is None else torch.device(device)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    tf = torch.from_numpy(np.ascontiguousarray(tfs, np.float32)).to(dev)
    dl = torch.from_numpy(np.ascontiguousarray(dl_of, np.float32)).to(dev)
    kfac = f32(k1) * (f32(1.0 - b) + f32(b) * dl / f32(max(avgdl, 1e-9)))
    imp = tf / (tf + kfac)
    m = torch.clamp(imp.max(), min=0.0) if imp.numel() else f32(0.0)
    scale = torch.where(m > 0, m / f32(qmax), f32(1.0))
    q = torch.clamp(torch.round(imp / scale), max=qmax).to(torch.int32)
    return q.cpu().numpy(), float(scale.cpu())


# postings a step of the feature quantizer moves to the device
FEATURE_CHUNK = 1 << 26


def quantize_features(weights: np.ndarray, qmax: int, device=None
                      ) -> Optional[Tuple[np.ndarray, float]]:
    """-> (q u8/u16[P] (u8 when qmax is 255), scale) of a FEATURE plane
    computed on `device` (the CPU when None) in steps of FEATURE_CHUNK
    weights, or None when no weight is positive: scale = max / qmax in
    double, q = round(w / f32(scale)) in f32, half to even, clipped to
    qmax; bit-equal to `index/segment.build_feature_impact_plane`'s
    numpy form (the max is exact, the division rounds once)."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    w = np.ascontiguousarray(weights, np.float32)
    step = FEATURE_CHUNK
    m = max((float(torch.from_numpy(w[a:a + step]).to(dev).max().cpu())
             for a in range(0, len(w), step)), default=0.0)
    if m <= 0.0:
        return None
    scale = m / qmax
    div = torch.tensor(np.float32(scale), device=dev)
    u8 = qmax <= 255
    q = np.empty(len(w), np.uint8 if u8 else np.uint16)
    for a in range(0, len(w), step):
        part = torch.clamp(torch.round(
            torch.from_numpy(w[a:a + step]).to(dev) / div), max=qmax).to(
                torch.int32)
        # u16 values travel as their i16 bit patterns
        part = part.to(torch.uint8 if u8 else torch.int16).cpu().numpy()
        q[a:a + len(part)] = part if u8 else part.view(np.uint16)
    return q, scale


def use_device_impacts(total_postings: int) -> bool:
    return total_postings >= DEVICE_IMPACT_MIN
