"""The index engine: buffered writes and refresh (the in-memory subset of
opensearch_tpu/index/engine.py; no translog, no flush, no merge in this
slice).

Write path: parse -> version/concurrency check -> in-memory buffer.
`refresh()` turns the buffer into an immutable Segment (codec v2 by
default, its impact planes quantized on the engine's device).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from ..errors import NotPortedError
from .mappings import Mappings, ParsedDocument
from .segment import Segment, build_segment

# the reference's TieredMergePolicy defaults: a refresh that leaves this
# many segments under MAX_MERGED_DOCS live docs would merge them there
SEGMENTS_PER_TIER = 8
MAX_MERGED_DOCS = 1 << 24


class VersionConflictError(Exception):
    """Analog of reference VersionConflictEngineException (HTTP 409)."""


@dataclass
class DocLocation:
    seq_no: int
    in_buffer: bool
    segment: Optional[Segment] = None
    local_doc: int = -1


class Engine:
    def __init__(self, mappings: Mappings, primary_term: int = 1,
                 device=None):
        self.mappings = mappings
        self.device = device
        self.primary_term = primary_term
        self.segments: List[Segment] = []
        self.buffer: List[Optional[ParsedDocument]] = []
        self.buffer_seq: List[int] = []
        self._buffer_ids: Dict[str, int] = {}
        self.seq_no = -1
        self._seg_counter = 0
        self.version_map: Dict[str, DocLocation] = {}

    def _next_seq(self) -> int:
        self.seq_no += 1
        return self.seq_no

    def _check_concurrency(self, doc_id: str, if_seq_no: Optional[int],
                           if_primary_term: Optional[int]) -> None:
        if if_seq_no is None and if_primary_term is None:
            return
        loc = self.version_map.get(doc_id)
        cur = loc.seq_no if loc else -1
        if if_seq_no is not None and cur != if_seq_no:
            raise VersionConflictError(
                f"[{doc_id}]: version conflict, required seqNo [{if_seq_no}], "
                f"current document has seqNo [{cur}] (index)")
        if if_primary_term is not None and self.primary_term != if_primary_term:
            raise VersionConflictError(
                f"[{doc_id}]: version conflict on primary term (index)")

    def index_doc(self, doc_id: str, source: dict,
                  routing: Optional[str] = None,
                  if_seq_no: Optional[int] = None,
                  if_primary_term: Optional[int] = None,
                  op_type: str = "index") -> dict:
        self._check_concurrency(doc_id, if_seq_no, if_primary_term)
        existed = (doc_id in self.version_map
                   or bool(self._attached_copies(doc_id)))
        if op_type == "create" and existed:
            raise VersionConflictError(f"[{doc_id}]: document already exists")
        parsed = self.mappings.parse(doc_id, source, routing)
        seq = self._next_seq()
        self._delete_previous(doc_id)
        self._buffer_ids[doc_id] = len(self.buffer)
        self.buffer.append(parsed)
        self.buffer_seq.append(seq)
        self.version_map[doc_id] = DocLocation(seq, in_buffer=True)
        return {"_id": doc_id, "_seq_no": seq,
                "_primary_term": self.primary_term,
                "result": "updated" if existed else "created"}

    def _attached_copies(self, doc_id: str) -> list:
        """(segment, local doc) of each live copy of `doc_id` that no
        version map entry knows: segments attached from arrays."""
        out = []
        for seg in self.segments:
            d = seg.local_doc(doc_id)
            if d >= 0 and seg.live[d]:
                out.append((seg, d))
        return out

    def _delete_previous(self, doc_id: str) -> None:
        loc = self.version_map.get(doc_id)
        if loc is None:
            for seg, d in self._attached_copies(doc_id):
                seg.delete_doc(d)
            return
        if loc.in_buffer:
            idx = self._buffer_ids.pop(doc_id, None)
            if idx is not None:
                self.buffer[idx] = None    # compacted away at refresh
        else:
            # the refreshed copy becomes a deleted doc of its segment: the
            # kernels decline that segment, and the impact rung and the
            # general path serve it with its live mask
            loc.segment.delete_doc(loc.local_doc)

    def _check_no_merge(self) -> None:
        """Raise where the reference's tiered merge policy would merge
        after this refresh: a full tier, or a segment with most of its
        docs deleted."""
        if 1 + sum(1 for s in self.segments
                   if s.live_count < MAX_MERGED_DOCS) >= SEGMENTS_PER_TIER:
            raise NotPortedError(
                f"segment merge ({SEGMENTS_PER_TIER} segments in one tier)")
        if any(s.ndocs > 0 and s.live_count < 0.5 * s.ndocs
               for s in self.segments):
            raise NotPortedError("segment merge (a segment with most of "
                                 "its docs deleted)")

    def refresh(self) -> bool:
        live = [(d, s) for d, s in zip(self.buffer, self.buffer_seq)
                if d is not None]
        if live:
            self._check_no_merge()
        self.buffer = []
        self.buffer_seq = []
        self._buffer_ids = {}
        if not live:
            return False
        docs = [d for d, _ in live]
        seqs = [s for _, s in live]
        seg = build_segment(f"_{self._seg_counter}", docs, self.mappings,
                            seq_nos=seqs, device=self.device)
        self._seg_counter += 1
        self.segments.append(seg)
        for local, (d, s) in enumerate(live):
            self.version_map[d.doc_id] = DocLocation(
                s, in_buffer=False, segment=seg, local_doc=local)
        return True
