"""Device-side codec-v2 impact quantizer (the impact subset of
opensearch_tpu/ops/device_merge.py; its sorted-run merge comes with segment
merges).

Above DEVICE_IMPACT_MIN postings the quantizer runs as torch ops on the
engine's device, so refresh does not serialize on a host pass; below it
the numpy branch of `index/segment.build_impact_plane` runs. The f32
expression, the global scale and round-half-to-even match the reference's
jitted quantizer; every scalar is a 0-d tensor on the device, so each
operation rounds once in f32 as the reference's weak-typed scalars do.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

DEVICE_IMPACT_MIN = 1 << 16


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


def use_device_impacts(total_postings: int) -> bool:
    return total_postings >= DEVICE_IMPACT_MIN
