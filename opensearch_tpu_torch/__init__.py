"""opensearch_tpu_torch: the PyTorch/CUDA port of opensearch_tpu.

This slice serves the engine's main path on an NVIDIA H100: bulk indexing,
refresh into codec-v1 CSR segments, and BM25 `term`/`terms`/`match`
search through the hand-written CUDA kernel `ops/bm25.fused_bm25_topk_tfdl`.
Everything outside that path raises `NotPortedError` naming what it met.

Entry points run on the card (`device="cuda"`) unless the caller asks for
the CPU, where every kernel wrapper takes its plain PyTorch version.
"""

from .errors import NotPortedError
from .rest.client import ApiError, RestClient

__all__ = ["ApiError", "NotPortedError", "RestClient"]
