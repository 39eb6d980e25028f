"""The index engine: buffered writes, realtime get, refresh, tiered merge,
flush and recovery (opensearch_tpu/index/engine.py without its ingest
instrumentation and its streaming refresh builder). It keeps the counters
and the writer buffer's shape that an index's stats report: index,
delete, refresh, flush and merge totals, the buffer's docs and sampled
bytes, and each refresh's accept-to-visible delays.

Write path: parse -> version/concurrency check -> translog append (when
the engine has a path) -> in-memory buffer. `refresh()` turns the buffer
into an immutable Segment (codec v2 by default, its impact planes
quantized on the engine's device), publishes it, then runs the tiered
merge policy. `flush()` writes the segments and a commit point and rolls
the translog; opening an engine on an existing path recovers from the
last commit point plus a translog replay.

Segments attached from arrays (`index/convert.py`) carry docs that no
version map entry knows: writes, deletes and gets reach those copies
through the segments' `_id` lookups.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..utils import metrics
from .mappings import Mappings, ParsedDocument
from .merge import (TieredMergePolicy, check_no_reorder, doc_maps,
                    merge_segments)
from .segment import Segment, build_segment
from .translog import Translog

# the writer buffer's byte estimate folds in every FLUSH_EVERY accepted
# docs and at refresh, sizing at most BYTES_SAMPLE of them (the
# reference's ingest instrumentation)
FLUSH_EVERY = 64
BYTES_SAMPLE = 8


def doc_bytes(source: dict) -> int:
    """A structural byte estimate of one source's top level."""
    est = 24
    for k, v in source.items():
        est += len(k) + 8
        if isinstance(v, str):
            est += len(v)
        elif isinstance(v, (list, tuple)):
            est += 8 * len(v)
    return est


class VersionConflictError(Exception):
    """Analog of reference VersionConflictEngineException (HTTP 409)."""


@dataclass
class DocLocation:
    seq_no: int
    in_buffer: bool
    segment: Optional[Segment] = None
    local_doc: int = -1


class Engine:
    def __init__(self, mappings: Mappings, path: Optional[str] = None,
                 primary_term: int = 1, device=None):
        self.mappings = mappings
        self.path = path
        self.merge_policy = TieredMergePolicy()
        self.device = device
        self.primary_term = primary_term
        self.segments: List[Segment] = []
        self.buffer: List[Optional[ParsedDocument]] = []
        self.buffer_seq: List[int] = []
        # accept-time monotonic stamp per buffered doc (parallel to
        # `buffer`): refresh records the accept-to-visible delays
        self.buffer_accepts: List[float] = []
        self._buffer_ids: Dict[str, int] = {}
        # the buffer's folded byte estimate and the docs not yet folded
        self._buf_bytes = 0
        self._pend_docs = 0
        self.index_name = ""      # names the refresh-to-visible sketch
        self.seq_no = -1
        self._seg_counter = 0
        self.version_map: Dict[str, DocLocation] = {}
        self.translog: Optional[Translog] = None
        self.stats = {"index_ops": 0, "delete_ops": 0, "refreshes": 0,
                      "flushes": 0, "merges": 0}
        if path is not None:
            os.makedirs(path, exist_ok=True)
            self._recover()

    # ---------------- write path ----------------

    def _next_seq(self) -> int:
        self.seq_no += 1
        return self.seq_no

    def _check_concurrency(self, doc_id: str, if_seq_no: Optional[int],
                           if_primary_term: Optional[int], op: str) -> None:
        if if_seq_no is None and if_primary_term is None:
            return
        loc = self.version_map.get(doc_id)
        cur = loc.seq_no if loc else -1
        if if_seq_no is not None and cur != if_seq_no:
            raise VersionConflictError(
                f"[{doc_id}]: version conflict, required seqNo [{if_seq_no}], "
                f"current document has seqNo [{cur}] ({op})")
        if if_primary_term is not None and self.primary_term != if_primary_term:
            raise VersionConflictError(
                f"[{doc_id}]: version conflict on primary term ({op})")

    def _exists(self, doc_id: str) -> bool:
        return (doc_id in self.version_map
                or bool(self._attached_copies(doc_id)))

    def index_doc(self, doc_id: str, source: dict,
                  routing: Optional[str] = None,
                  if_seq_no: Optional[int] = None,
                  if_primary_term: Optional[int] = None,
                  op_type: str = "index", translog_op: bool = True) -> dict:
        self._check_concurrency(doc_id, if_seq_no, if_primary_term, "index")
        existed = self._exists(doc_id)
        if op_type == "create" and existed:
            raise VersionConflictError(f"[{doc_id}]: document already exists")
        parsed = self.mappings.parse(doc_id, source, routing)
        seq = self._next_seq()
        if translog_op and self.translog is not None:
            self.translog.add_index(doc_id, source, routing, seq)
        self._delete_previous(doc_id)
        self._buffer_ids[doc_id] = len(self.buffer)
        self.buffer.append(parsed)
        self.buffer_seq.append(seq)
        self.buffer_accepts.append(time.monotonic())
        self.version_map[doc_id] = DocLocation(seq, in_buffer=True)
        self.stats["index_ops"] += 1
        self._pend_docs += 1
        if self._pend_docs >= FLUSH_EVERY:
            self._fold_pending()
        return {"_id": doc_id, "_seq_no": seq,
                "_primary_term": self.primary_term,
                "result": "updated" if existed else "created"}

    def delete_doc(self, doc_id: str, if_seq_no: Optional[int] = None,
                   if_primary_term: Optional[int] = None,
                   translog_op: bool = True) -> dict:
        self._check_concurrency(doc_id, if_seq_no, if_primary_term, "delete")
        found = self._exists(doc_id)
        seq = self._next_seq()
        if translog_op and self.translog is not None:
            self.translog.add_delete(doc_id, seq)
        if found:
            self._delete_previous(doc_id)
            self.version_map.pop(doc_id, None)
        self.stats["delete_ops"] += 1
        return {"_id": doc_id, "_seq_no": seq,
                "_primary_term": self.primary_term,
                "result": "deleted" if found else "not_found"}

    def _attached_copies(self, doc_id: str) -> list:
        """(segment, local doc) of each live copy of `doc_id` that no
        version map entry knows: segments attached from arrays."""
        if doc_id in self.version_map:
            return []
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
            # kernels decline that segment until a merge compacts it
            loc.segment.delete_doc(loc.local_doc)

    # ---------------- realtime get ----------------

    def get(self, doc_id: str) -> Optional[dict]:
        """Realtime get through the version map (the buffer is readable
        as it is, so no refresh), then through attached segments."""
        loc = self.version_map.get(doc_id)
        if loc is None:
            copies = self._attached_copies(doc_id)
            if not copies:
                return None
            seg, d = copies[0]
            loc = DocLocation(int(seg.seq_nos[d]), in_buffer=False,
                              segment=seg, local_doc=d)
        if loc.in_buffer:
            source = self.buffer[self._buffer_ids[doc_id]].source
        else:
            source = loc.segment.sources[loc.local_doc]
        return {"_id": doc_id, "_source": source, "_seq_no": loc.seq_no,
                "_primary_term": self.primary_term, "found": True}

    # ---------------- refresh / merge / flush ----------------

    @property
    def num_docs(self) -> int:
        return sum(s.live_count for s in self.segments) + \
            sum(1 for d in self.buffer if d is not None)

    def _fold_pending(self) -> None:
        """Fold the docs accepted since the last fold into the buffer's
        byte estimate: the mean size of at most BYTES_SAMPLE docs of the
        buffer's tail, scaled to the fold."""
        n = self._pend_docs
        if not n:
            return
        tail = self.buffer[-n:]
        samples = [p for p in tail[::max(1, n // BYTES_SAMPLE)]
                   if p is not None][:BYTES_SAMPLE]
        if samples:
            self._buf_bytes += int(sum(doc_bytes(p.source) for p in samples)
                                   / len(samples) * n)
        self._pend_docs = 0

    def buffer_stats(self) -> dict:
        """Docs pending refresh and the buffer's folded byte estimate."""
        return {"docs": sum(1 for d in self.buffer if d is not None),
                "bytes": self._buf_bytes}

    def merge_backlog(self) -> int:
        """Merge groups the policy would run right now."""
        return len([g for g in self.merge_policy.find_merges(self.segments)
                    if len(g) >= 2 or any(s.live_count < s.ndocs
                                          for s in g)])

    def refresh(self) -> bool:
        self._fold_pending()
        live = [(d, s, a) for d, s, a in zip(self.buffer, self.buffer_seq,
                                             self.buffer_accepts)
                if d is not None]
        self.buffer = []
        self.buffer_seq = []
        self.buffer_accepts = []
        self._buffer_ids = {}
        self._buf_bytes = 0
        if not live:
            return False
        docs = [d for d, _, _ in live]
        seqs = [s for _, s, _ in live]
        seg = build_segment(f"_{self._seg_counter}", docs, self.mappings,
                            seq_nos=seqs, device=self.device)
        self._seg_counter += 1
        self.segments.append(seg)
        for local, (d, s, _a) in enumerate(live):
            self.version_map[d.doc_id] = DocLocation(
                s, in_buffer=False, segment=seg, local_doc=local)
        self.stats["refreshes"] += 1
        # the docs became searchable here, before the merge work
        metrics.record_refresh_to_visible(
            self.index_name, [a for _, _, a in live], time.monotonic())
        self.maybe_merge()
        return True

    def maybe_merge(self) -> None:
        for group in self.merge_policy.find_merges(self.segments):
            if len(group) < 2 and not any(s.live_count < s.ndocs
                                          for s in group):
                continue
            self.force_merge_group(group)

    def force_merge_group(self, group: List[Segment]) -> Segment:
        """Merge `group` into one segment, publish it in their place,
        re-anchor the version map on it and release the merged-away
        segments' device state (at once, or when the last scroll or
        point in time holding one lets go)."""
        name = f"_m{self._seg_counter}"
        self._seg_counter += 1
        merged = merge_segments(name, group, device=self.device)
        where = {id(s): dmap for s, dmap in zip(group, doc_maps(group))}
        self.segments = [s for s in self.segments if id(s) not in where]
        self.segments.append(merged)
        for loc in self.version_map.values():
            if not loc.in_buffer and id(loc.segment) in where:
                loc.local_doc = int(where[id(loc.segment)][loc.local_doc])
                loc.segment = merged
        for s in group:
            s.retire()
        self.__dict__.pop("_shard_view", None)
        self.stats["merges"] += 1
        return merged

    def force_merge(self, max_num_segments: int = 1) -> None:
        """Merge every segment into one when there are more than
        `max_num_segments`. A lone segment stays as it is, except where
        the reference would merge it alone to run its BP doc-id reorder,
        which is not ported: there this raises."""
        if len(self.segments) > max_num_segments:
            self.force_merge_group(list(self.segments))
        elif len(self.segments) == 1:
            seg = self.segments[0]
            check_no_reorder(seg.ndocs, getattr(seg, "codec_version", 1))

    def flush(self) -> None:
        """Durable commit: segments to disk plus a commit point, translog
        rolled (reference: InternalEngine#flush)."""
        self.refresh()
        if self.path is None:
            return
        seg_dir = os.path.join(self.path, "segments")
        committed = []
        for seg in self.segments:
            # every flush rewrites each segment: live masks change
            seg.save(os.path.join(seg_dir, seg.name))
            committed.append(seg.name)
        gen = self.translog.rollover() if self.translog else 0
        commit = {"segments": committed, "seq_no": self.seq_no,
                  "translog_gen": gen, "primary_term": self.primary_term,
                  "ts": time.time()}
        tmp = os.path.join(self.path, "commit.json.tmp")
        with open(tmp, "w") as fh:
            json.dump(commit, fh)
        os.replace(tmp, os.path.join(self.path, "commit.json"))
        if self.translog:
            self.translog.prune_below(gen)
        self.stats["flushes"] += 1

    # ---------------- recovery ----------------

    def _recover(self) -> None:
        commit_path = os.path.join(self.path, "commit.json")
        translog_dir = os.path.join(self.path, "translog")
        gen = 0
        committed = os.path.exists(commit_path)
        if committed:
            with open(commit_path) as fh:
                commit = json.load(fh)
            for name in commit["segments"]:
                seg = Segment.load(os.path.join(self.path, "segments", name))
                self.segments.append(seg)
                num = int(name.lstrip("_m").lstrip("_") or 0)
                self._seg_counter = max(self._seg_counter, num + 1)
                for local, doc_id in enumerate(seg.ids):
                    if seg.live[local]:
                        self.version_map[doc_id] = DocLocation(
                            int(seg.seq_nos[local]), in_buffer=False,
                            segment=seg, local_doc=local)
            self.seq_no = commit["seq_no"]
            gen = commit["translog_gen"]
            self.primary_term = commit.get("primary_term", 1)
        self.translog = Translog(translog_dir, generation=gen)
        replayed = 0
        for rec in self.translog.replay_from(gen):
            if committed and rec["seq_no"] <= self.seq_no:
                continue
            if rec["op"] == "index":
                self.index_doc(rec["_id"], rec["_source"], rec.get("routing"),
                               translog_op=False)
            else:
                self.delete_doc(rec["_id"], translog_op=False)
            replayed += 1
        if replayed:
            self.refresh()

    # ---------------- index-wide stats ----------------

    def doc_freq(self, field: str, term: str) -> int:
        return sum(s.postings[field].doc_freq(term)
                   for s in self.segments if field in s.postings)

    def close(self) -> None:
        if self.translog:
            self.translog.close()
