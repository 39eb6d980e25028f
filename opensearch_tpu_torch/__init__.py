"""opensearch_tpu_torch: the PyTorch/CUDA port of opensearch_tpu.

It serves the engine's main path on an NVIDIA H100: bulk indexing, refresh
into codec-v2 CSR segments, and BM25 `term`/`terms`/`match`, `bool`,
`constant_score`, `range`, `match_all`, `exists` and `ids` search through
the hand-written CUDA kernels of `ops/bm25.py`, with the impact rung and
the general path (torch ops) behind them for what the kernels decline.
Everything outside the port raises `NotPortedError` naming what it met.

Entry points run on the card (`device="cuda"`) unless the caller asks for
the CPU, where every kernel wrapper takes its plain PyTorch version.
"""

from .errors import NotPortedError
from .rest.client import ApiError, RestClient

__all__ = ["ApiError", "NotPortedError", "RestClient"]
