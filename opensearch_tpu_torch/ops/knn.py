"""The kNN scorer of the general path (the reference's emit kind "knn",
opensearch_tpu/search/compiler.py), as torch ops on the segment's device.

A similarity turns the raw dot product into a score: (1 + raw) / 2 for
cosine (query and rows unit-normed), raw + 1 for a positive dot product
and 1 / (1 - raw) for a negative one (`dot_product`, `innerproduct`),
and 1 / (1 + max(|v|^2 + |q|^2 - 2 raw, 0)) for any other name (L2).

The exact scan is one matrix-vector product over the segment's scored
matrix, as the reference's `jnp.dot`. The IVF probe scores the centroids
(an L2 field ranks them by 2 c.q - |c|^2), keeps the `nprobe` best with
ties to the lower list, as `lax.top_k` breaks them, gathers those lists'
[nprobe, cap] rows, scores them and scatters the scores back into doc
space; a doc lives in one list, so a doc outside the probed lists scores
0 and does not match. `STATS` counts the scans and probes served.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

STATS = {"exact": 0, "ivf": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def similarity_score(raw: torch.Tensor, vsq: Optional[torch.Tensor],
                     qsq: float, simkind: str) -> torch.Tensor:
    """f32 scores of raw dot products under `simkind`; `vsq` holds the
    rows' squared norms (L2 only)."""
    if simkind == "cosine":
        return (1.0 + raw) / 2.0
    if simkind in ("dot_product", "innerproduct"):
        return torch.where(raw > 0, raw + 1.0, 1.0 / (1.0 - raw))
    d2 = torch.clamp_min(vsq + qsq - 2.0 * raw, 0.0)
    return 1.0 / (1.0 + d2)


def exact_scan(arr: dict, q: torch.Tensor, qsq: float,
               simkind: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores f32[ndocs], present bool[ndocs]) of every row of the
    vector column's device arrays `arr` (`Segment.vector_on`)."""
    STATS["exact"] += 1
    raw = arr["mat"] @ q
    return similarity_score(raw, arr["sq"], qsq, simkind), arr["present"]


def probe_lists(cents: torch.Tensor, q: torch.Tensor, nprobe: int,
                simkind: str) -> torch.Tensor:
    """i64[nprobe]: the lists to probe, best centroid score first, ties
    to the lower list."""
    cdot = cents @ q
    if simkind not in ("cosine", "dot_product", "innerproduct"):
        cdot = 2.0 * cdot - (cents * cents).sum(1)
    order = torch.sort(cdot, descending=True, stable=True).indices
    return order[:nprobe]


def ivf_probe(arr: dict, cents: torch.Tensor, lists: torch.Tensor,
              q: torch.Tensor, qsq: float, simkind: str,
              nprobe: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores f32[ndocs], in a probed list bool[ndocs]): the probe's
    rows scored, every other doc 0."""
    STATS["ivf"] += 1
    n = arr["mat"].shape[0]
    cand = lists[probe_lists(cents, q, nprobe, simkind)].reshape(-1)
    valid = cand >= 0
    rows = torch.where(valid, cand, 0)
    raw = arr["mat"][rows] @ q
    vsq = arr["sq"][rows] if arr["sq"] is not None else None
    s = torch.where(valid, similarity_score(raw, vsq, qsq, simkind), 0.0)
    # an empty slot lands on the dropped last doc
    slot = torch.where(valid, cand, n)
    score = torch.zeros(n + 1, dtype=torch.float32, device=q.device)
    score[slot] = s
    hit = torch.zeros(n + 1, dtype=torch.bool, device=q.device)
    hit[slot] = valid
    return score[:n], hit[:n]
