"""The serve margin of the codec-v2 impact domain (the `_error_bound`
subset of opensearch_tpu/search/impactpath.py). The fastpath's impact
frontier pass certifies its pages against exactly this epsilon. The XLA
impact path itself (`segment_search`, block planning) is not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _error_bound(plane, weights: np.ndarray, rows: np.ndarray,
                 k1q: float, bq: float, avgdlq: float,
                 drift: Optional[float] = None) -> float:
    """Sound |exact - approx| per-doc bound: per-term quantization
    half-step + build->query param drift, plus f32 accumulation slack on
    both sums (<= T adds each against the max representable score)."""
    quant = plane.quant_err()
    if drift is None:
        drift = plane.drift_bound(k1q, bq, avgdlq)
    wsum = float(np.abs(weights[rows >= 0]).sum())
    e = wsum * (quant + drift)
    t = int((rows >= 0).sum())
    umax = max(wsum * float(plane.scale) * plane.qmax, 1e-30)
    e += 4.0 * (t + 2) * float(np.spacing(np.float32(umax)))
    return e
