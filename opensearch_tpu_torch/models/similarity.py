"""Similarity models: BM25 only in this slice (the BM25 subset of
opensearch_tpu/models/similarity.py).

A similarity contributes a host-side per-term weight (idf x boost, from
index-wide collection statistics) and the (k1, b) scalars of the
per-posting expression in `ops/scoring.posting_contrib`.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import NotPortedError
from ..ops.scoring import SIM_BM25, bm25_idf


@dataclass(frozen=True)
class Similarity:
    sim_id: int
    k1: float = 1.2
    b: float = 0.75

    def term_weight(self, boost: float, n_docs: int, df: int) -> float:
        raise NotImplementedError

    @property
    def uses_norms(self) -> bool:
        return True


@dataclass(frozen=True)
class BM25(Similarity):
    """BM25 with Lucene's idf and tf saturation (default k1=1.2, b=0.75)."""

    sim_id: int = SIM_BM25

    def term_weight(self, boost: float, n_docs: int, df: int) -> float:
        return boost * bm25_idf(n_docs, df)


def resolve_similarity(cfg) -> Similarity:
    if cfg is None:
        return BM25()
    if isinstance(cfg, Similarity):
        return cfg
    if isinstance(cfg, str):
        cfg = {"type": cfg}
    t = cfg.get("type", "BM25").lower()
    if t == "bm25":
        return BM25(k1=float(cfg.get("k1", 1.2)), b=float(cfg.get("b", 0.75)))
    raise NotPortedError(f"similarity [{t}]")
