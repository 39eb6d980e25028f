"""Segment merging (the tiered policy and the compacting merge of
opensearch_tpu/index/merge.py, for the planes a port Segment has).

`merge_segments` compacts deleted docs away and concatenates the inputs'
live docs in input order, as the reference does, so the merged internal
ids equal the reference's (with its BP doc-id reorder off: the port keeps
concatenation order, its tie key). Numeric columns keep their kind;
keyword columns merge over the union of their vocabs with ordinals
remapped and deleted docs' values dropped; vector columns keep their
similarity and method, their rows copied in blocks of VECTOR_CHUNK_ROWS
(no second full copy of a column stands beside the merged one), and the
merged column builds its IVF index on first use; geo columns (lat, lon,
present) and shape columns (specs, bounding boxes, present) follow their
docs to the merged ids. Postings (text and keyword rows) merge
as one sort of (union row, new doc) triples: on the engine's device at
DEVICE_MERGE_MIN postings and above (`ops/device_merge.merge_sorted_runs`),
else `np.lexsort`; a positional field's position runs follow their
postings through the sort's order. A field that one input holds keeps
that input's order (a doc map keeps it), so it merges without the sort. Codec-v2 impact planes are rebuilt
from the merged tf and doc-length planes: the merged field's avgdl
differs from every input's, so carried quantized values would bake a
stale norm. Feature fields (rank_features / sparse_vector) merge as
postings whose tf slot is the weight, and a FEATURE plane is rebuilt
for every field that any input carried one for.

The reference runs a BP doc-id reorder on a codec-v2 merge of
REORDER_MIN_DOCS docs or more (opensearch_tpu/index/reorder.py), and its
served pages then can differ from those of its unreordered merge
(tests/test_torch_merge.py). The port has no reorder: such a merge
raises NotPortedError("BP reorder"), unless OPENSEARCH_TPU_REORDER=0
(the reference's own switch) turns the reorder off, as it does there.

A nested path's children merge as their own segments, those of deleted
parents dropped and their parent ids remapped (`_merge_nested`); an
input with term vectors (`term_vectors`, a reference plane the port does
not build) raises NotPortedError.

Inputs whose `ids` / `sources` are lazy views (a synthetic corpus) merge
into `MergedView`s that map a new doc to (input, old doc), so no list of
millions of strings is built.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from ..errors import NotPortedError
from ..ops import device_merge
from .segment import (CODEC_V2, VECTOR_CHUNK_ROWS, GeoColumn,
                      KeywordColumn, NestedBlock, NumericColumn,
                      PostingsBlock, Segment,
                      ShapeColumn, TextFieldStats, VectorColumn,
                      default_codec_version)

# planes of a reference segment that no port segment carries
_UNPORTED_PLANES = ("term_vectors",)

# the reference's reorder threshold (index/reorder.py)
REORDER_MIN_DOCS = 1 << 15

# wall seconds of the last merge by step: host_concat_s (doc maps, row
# remap, concatenation, CSR slicing and the other planes), sort_s (the
# (row, doc) sort, merge_sorted_runs on the device or np.lexsort),
# positions_s (the positions' gather and regather, on the host),
# quantize_s (the impact planes' rebuild), vectors_s (the vector
# columns' copy) and geo_s (the geo and shape columns' copy)
LAST_MERGE: Dict[str, float] = {}


class TieredMergePolicy:
    """Size-tiered selection: merge when >= `segments_per_tier` segments
    share a size tier (by live doc count), preferring the smallest; below
    that, merge alone each segment with most of its docs deleted."""

    def __init__(self, segments_per_tier: int = 8,
                 max_merged_docs: int = 1 << 24):
        self.segments_per_tier = segments_per_tier
        self.max_merged_docs = max_merged_docs

    def find_merges(self, segments: List[Segment]) -> List[List[Segment]]:
        candidates = [s for s in segments
                      if s.live_count < self.max_merged_docs]
        if len(candidates) < self.segments_per_tier:
            heavy = [s for s in segments
                     if s.ndocs > 0 and s.live_count < 0.5 * s.ndocs]
            return [[s] for s in heavy]
        candidates.sort(key=lambda s: s.live_count)
        return [candidates[: self.segments_per_tier]]


def doc_maps(segments: List[Segment]) -> List[np.ndarray]:
    """Per input, i64[ndocs]: its docs' ids in the merged segment (live
    docs in input order, then doc order), -1 for a deleted doc."""
    out = []
    base = 0
    for s in segments:
        live = s.live.astype(bool)
        dmap = np.full(s.ndocs, -1, np.int64)
        n = int(live.sum())
        dmap[live] = base + np.arange(n, dtype=np.int64)
        out.append(dmap)
        base += n
    return out


class MergedView:
    """The merged segment's `ids` or `sources` where an input's are lazy:
    new doc -> (input, old doc), resolved on access. `find` (ids only)
    answers an `_id`'s new doc, or -1."""

    def __init__(self, parts: list, kept: List[np.ndarray],
                 finders: Optional[list] = None):
        self.parts = parts
        self.kept = kept                      # per input: old live docs
        self.bases = np.cumsum([0] + [len(k) for k in kept])
        self.finders = finders

    def __len__(self) -> int:
        return int(self.bases[-1])

    def __getitem__(self, i):
        i = int(i)
        if not 0 <= i < len(self):
            raise IndexError(i)
        k = int(np.searchsorted(self.bases, i, "right") - 1)
        return self.parts[k][int(self.kept[k][i - self.bases[k]])]

    def find(self, doc_id: str) -> int:
        for k, find in enumerate(self.finders):
            old = find(doc_id)
            if old is None or old < 0:
                continue
            j = int(np.searchsorted(self.kept[k], old))
            if j < len(self.kept[k]) and int(self.kept[k][j]) == old:
                return int(self.bases[k]) + j
        return -1


def check_no_reorder(ndocs: int, codec_version: int) -> None:
    """Raise where the reference would run its BP doc-id reorder on a
    merged segment of `ndocs` docs and this codec."""
    if (os.environ.get("OPENSEARCH_TPU_REORDER", "1") != "0"
            and codec_version >= CODEC_V2 and ndocs >= REORDER_MIN_DOCS):
        raise NotPortedError(
            f"BP reorder (a codec-v2 merge of {ndocs} docs; "
            f"OPENSEARCH_TPU_REORDER=0 merges without it)")


def _check_ported(segments: List[Segment]) -> None:
    for s in segments:
        for attr in _UNPORTED_PLANES:
            if getattr(s, attr, None):
                raise NotPortedError(f"merging a segment with [{attr}]")


def _merge_ids_sources(segments, live_masks):
    """-> (ids, sources): lists as the reference builds them, or
    MergedViews where an input's are lazy."""
    kept = [np.flatnonzero(m) for m in live_masks]
    if all(isinstance(s.ids, list) and isinstance(s.sources, list)
           for s in segments):
        ids, sources = [], []
        for s, k in zip(segments, kept):
            ids.extend(s.ids[i] for i in k)
            sources.extend(s.sources[i] for i in k)
        return ids, sources
    finders = [getattr(s.ids, "find", None) or s.id2doc.get
               for s in segments]
    return (MergedView([s.ids for s in segments], kept, finders),
            MergedView([s.sources for s in segments], kept))


def ranges_gather(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """i64 indices of the runs [starts[i], starts[i] + lens[i]) laid end
    to end (the reference's `_ranges_gather`)."""
    lens = np.asarray(lens, np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, np.int64)
    run_first = np.cumsum(lens) - lens
    return np.repeat(np.asarray(starts, np.int64) - run_first, lens) \
        + np.arange(total, dtype=np.int64)


def _merge_postings(field: str, segments, dmaps, device):
    """One field's CSR postings over the merged doc ids, or None when no
    input holds a posting of it; -> (PostingsBlock, sort seconds,
    positions seconds). Positions merge when every input that has the
    field has them: deleted docs' runs are dropped, the kept runs are
    regathered in the sort's order and `pos_starts` is rebuilt from
    their lengths, as the reference does."""
    vocab_union = sorted({t for s in segments if field in s.postings
                          for t in s.postings[field].vocab})
    new_row_of = {t: i for i, t in enumerate(vocab_union)}
    has_pos = all(field not in s.postings
                  or s.postings[field].pos_starts is not None
                  for s in segments)
    held = [(s, dmap) for s, dmap in zip(segments, dmaps)
            if field in s.postings and s.postings[field].size]
    if len(held) == 1 and held[0][0].postings[field].vocab == vocab_union:
        return _merge_one_input(field, *held[0], has_pos, vocab_union,
                                new_row_of)
    rows_parts, docs_parts, tfs_parts = [], [], []
    plen_parts, pos_parts = [], []
    t_pos = 0.0
    for s, dmap in zip(segments, dmaps):
        pb = s.postings.get(field)
        if pb is None or pb.size == 0:
            continue
        row_map = np.fromiter((new_row_of[t] for t in pb.vocab), np.int32,
                              count=len(pb.vocab))
        rows = np.repeat(row_map, np.diff(pb.starts))
        new_docs = dmap.astype(np.int32)[pb.doc_ids]
        tfs = pb.tfs
        keep = None
        if s.live_count != s.ndocs:
            keep = new_docs >= 0
            rows, new_docs, tfs = rows[keep], new_docs[keep], tfs[keep]
        rows_parts.append(rows)
        docs_parts.append(new_docs)
        tfs_parts.append(tfs)
        if has_pos:
            t1 = time.perf_counter()
            plens = np.diff(pb.pos_starts)
            if keep is None:
                pos_parts.append(pb.positions)
            else:
                plens = plens[keep]
                pos_parts.append(pb.positions[ranges_gather(
                    pb.pos_starts[:-1][keep], plens)])
            plen_parts.append(plens)
            t_pos += time.perf_counter() - t1
    if not rows_parts:
        return None, 0.0, 0.0
    rows = np.concatenate(rows_parts)
    docs = np.concatenate(docs_parts)
    tfs = np.concatenate(tfs_parts)
    del rows_parts, docs_parts, tfs_parts
    starts = np.zeros(len(vocab_union) + 1, np.int64)
    t0 = time.perf_counter()
    if device_merge.use_device_merge(len(rows)):
        _r, docs, tfs, order, counts = device_merge.merge_sorted_runs(
            rows, docs, tfs, len(vocab_union), device)
        np.cumsum(counts.astype(np.int64), out=starts[1:])
    else:
        order = np.lexsort((docs, rows))
        rows, docs, tfs = rows[order], docs[order], tfs[order]
        np.cumsum(np.bincount(rows, minlength=len(vocab_union)),
                  out=starts[1:])
    t_sort = time.perf_counter() - t0
    pb = PostingsBlock(field, vocab_union, new_row_of, starts,
                       docs.astype(np.int32, copy=False),
                       tfs.astype(np.float32, copy=False),
                       feature=any(s.postings[field].feature
                                   for s in segments
                                   if field in s.postings))
    if has_pos:
        t1 = time.perf_counter()
        # positions were concatenated in pre-sort posting order
        plens = np.concatenate(plen_parts)
        pre_starts = np.cumsum(plens) - plens
        plens = plens[order]
        pb.positions = np.concatenate(pos_parts)[
            ranges_gather(pre_starts[order], plens)].astype(np.int32,
                                                           copy=False)
        pb.pos_starts = np.zeros(len(plens) + 1, np.int64)
        np.cumsum(plens, out=pb.pos_starts[1:])
        t_pos += time.perf_counter() - t1
    return pb, t_sort, t_pos


def _merge_one_input(field: str, s, dmap, has_pos: bool, vocab, row_of):
    """`_merge_postings` where one input holds every posting of the field
    under the merged vocab: its live docs keep their order within each
    row (a doc map keeps an input's order), so the sorted merge's result
    is that input's CSR with deleted docs dropped and doc ids remapped,
    built without the sort; -> (PostingsBlock, 0.0, positions
    seconds)."""
    pb = s.postings[field]
    docs = dmap.astype(np.int32)[pb.doc_ids]
    tfs = pb.tfs
    starts = pb.starts
    keep = None
    if s.live_count != s.ndocs:
        keep = docs >= 0
        lens = np.diff(pb.starts)
        counts = np.zeros(len(lens), np.int64)
        nz = lens > 0
        counts[nz] = np.add.reduceat(keep, pb.starts[:-1][nz],
                                     dtype=np.int64)
        starts = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        docs, tfs = docs[keep], tfs[keep]
    # without deletes the tf and position arrays are shared: a
    # segment's postings are never written after its build
    out = PostingsBlock(field, vocab, row_of, starts, docs,
                        np.asarray(tfs, np.float32), feature=pb.feature)
    t_pos = 0.0
    if has_pos:
        t1 = time.perf_counter()
        plens = np.diff(pb.pos_starts)
        if keep is None:
            out.positions = pb.positions
        else:
            plens = plens[keep]
            out.positions = pb.positions[ranges_gather(
                pb.pos_starts[:-1][keep], plens)]
        out.pos_starts = np.zeros(len(plens) + 1, np.int64)
        np.cumsum(plens, out=out.pos_starts[1:])
        t_pos = time.perf_counter() - t1
    return out, 0.0, t_pos


def _merge_keywords(field: str, segments, dmaps,
                    ndocs: int) -> KeywordColumn:
    """One keyword column over the merged doc ids: the inputs' vocabs'
    union, their ordinals remapped, deleted docs' values dropped, values
    sorted by (doc, ordinal), as the reference merges them."""
    vocab_union = sorted({v for s in segments if field in s.keyword_cols
                          for v in s.keyword_cols[field].vocab})
    new_ord_of = {v: i for i, v in enumerate(vocab_union)}
    doc_parts, ord_parts = [], []
    for s, dmap in zip(segments, dmaps):
        col = s.keyword_cols.get(field)
        if col is None or len(col.ords) == 0:
            continue
        remap = np.fromiter((new_ord_of[v] for v in col.vocab), np.int64,
                            count=len(col.vocab))
        new_docs = dmap[col.doc_of_value]
        keep = new_docs >= 0
        doc_parts.append(new_docs[keep])
        ord_parts.append(remap[col.ords[keep]])
    docs = np.concatenate(doc_parts) if doc_parts else np.empty(0, np.int64)
    ords = np.concatenate(ord_parts) if ord_parts else np.empty(0, np.int64)
    order = np.lexsort((ords, docs))
    docs, ords = docs[order], ords[order]
    starts = np.zeros(ndocs + 1, dtype=np.int64)
    np.cumsum(np.bincount(docs, minlength=ndocs), out=starts[1:])
    min_ord = np.full(ndocs, -1, dtype=np.int32)
    if len(docs):
        first, at = np.unique(docs, return_index=True)
        min_ord[first] = ords[at].astype(np.int32)
    return KeywordColumn(field, vocab_union, starts, ords.astype(np.int32),
                         docs.astype(np.int32), min_ord)


def _merge_vectors(field: str, segments, live_masks, dmaps,
                   ndocs: int) -> VectorColumn:
    """One vector column over the merged doc ids: the first input's
    similarity and method, the live rows copied block by block, the
    blocks on a few threads (numpy releases the interpreter lock for
    the copies, and a fresh column's first writes fault its pages in). A
    block's live docs take consecutive new ids (`doc_maps`), so each
    block lands in one slice of the merged rows."""
    first = next(s.vector_cols[field] for s in segments
                 if field in s.vector_cols)
    values = np.zeros((ndocs, first.dims), np.float32)
    present = np.zeros(ndocs, bool)
    step = VECTOR_CHUNK_ROWS // 4

    def copy(job):
        col, m, dmap, a = job
        mm = m[a:a + step]
        to = dmap[a:a + step][mm]
        if len(to):
            rows = slice(int(to[0]), int(to[0]) + len(to))
            # mode "clip" writes straight into `out` (the default mode
            # buffers it: a block's copy more on each thread)
            np.take(col.values[a:a + step], np.flatnonzero(mm), axis=0,
                    out=values[rows], mode="clip")
            present[rows] = col.present[a:a + step][mm]
    jobs = [(s.vector_cols[field], m, dmap, a)
            for s, m, dmap in zip(segments, live_masks, dmaps)
            if field in s.vector_cols for a in range(0, s.ndocs, step)]
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(copy, jobs))
    return VectorColumn(field, values, present, first.similarity,
                        method=first.method)


def _merge_geo(segments, live_masks, dmaps, ndocs: int) -> tuple:
    """(geo_cols, shape_cols) over the merged doc ids."""
    geo_cols: Dict[str, GeoColumn] = {}
    for f in sorted({f for s in segments for f in s.geo_cols}):
        lat = np.zeros(ndocs, np.float32)
        lon = np.zeros(ndocs, np.float32)
        present = np.zeros(ndocs, bool)
        for s, m, dmap in zip(segments, live_masks, dmaps):
            col = s.geo_cols.get(f)
            if col is not None:
                lat[dmap[m]] = col.lat[m]
                lon[dmap[m]] = col.lon[m]
                present[dmap[m]] = col.present[m]
        geo_cols[f] = GeoColumn(f, lat, lon, present)
    shape_cols: Dict[str, ShapeColumn] = {}
    for f in sorted({f for s in segments for f in s.shape_cols}):
        specs: list = [None] * ndocs
        box = np.empty((4, ndocs))
        box[:2], box[2:] = np.inf, -np.inf
        present = np.zeros(ndocs, bool)
        for s, m, dmap in zip(segments, live_masks, dmaps):
            col = s.shape_cols.get(f)
            if col is None:
                continue
            tgt = dmap[m]
            for old_i, new_i in zip(np.flatnonzero(m), tgt):
                specs[new_i] = col.specs[old_i]
            for j, arr in enumerate((col.minx, col.miny, col.maxx,
                                     col.maxy)):
                box[j, tgt] = arr[m]
            present[tgt] = col.present[m]
        shape_cols[f] = ShapeColumn(f, specs, *box, present)
    return geo_cols, shape_cols


def _merge_nested(name: str, npath: str, segments: List[Segment], dmaps,
                  device) -> Optional[NestedBlock]:
    """One nested path's block of the merged segment (the reference's
    merge): the children of deleted parents dropped, the rest merged as
    their own segments, their parent ids remapped; None without any
    child."""
    child_segs, saved, parents = [], [], []
    for s, dmap in zip(segments, dmaps):
        blk = s.nested.get(npath)
        if blk is None or blk.child.ndocs == 0:
            continue
        keep = (dmap[blk.parent_of] >= 0) & blk.child.live
        saved.append(blk.child.live)
        blk.child.live = keep       # drives the child compaction
        child_segs.append(blk.child)
        parents.append(dmap[blk.parent_of[keep]].astype(np.int32))
    if not child_segs:
        return None
    try:
        merged_child = merge_segments(f"{name}/{npath}", child_segs, device)
    finally:
        for cs, old in zip(child_segs, saved):
            cs.live = old
    return NestedBlock(merged_child, np.concatenate(parents))


def merge_segments(name: str, segments: List[Segment],
                   device=None) -> Segment:
    """Compacting multiway merge of N segments into one; large postings
    sort and impact planes quantize on `device` (the CPU when None)."""
    _check_ported(segments)
    t0 = time.perf_counter()
    live_masks = [s.live.astype(bool) for s in segments]
    ndocs = sum(int(m.sum()) for m in live_masks)
    check_no_reorder(ndocs, default_codec_version())
    dmaps = doc_maps(segments)
    ids, sources = _merge_ids_sources(segments, live_masks)
    seq_nos = np.empty(ndocs, np.int64)
    for s, m, dmap in zip(segments, live_masks, dmaps):
        seq_nos[dmap[m]] = s.seq_nos[m]

    t_sort = t_pos = 0.0
    postings: Dict[str, PostingsBlock] = {}
    for f in sorted({f for s in segments for f in s.postings}):
        pb, ts, tp = _merge_postings(f, segments, dmaps, device)
        t_sort += ts
        t_pos += tp
        if pb is not None:
            postings[f] = pb

    numeric_cols: Dict[str, NumericColumn] = {}
    for f in sorted({f for s in segments for f in s.numeric_cols}):
        kind = next(s.numeric_cols[f].kind for s in segments
                    if f in s.numeric_cols)
        values = np.zeros(ndocs, np.float64 if kind == "float" else np.int64)
        present = np.zeros(ndocs, bool)
        for s, m, dmap in zip(segments, live_masks, dmaps):
            col = s.numeric_cols.get(f)
            if col is None:
                continue
            values[dmap[m]] = col.values[m]
            present[dmap[m]] = col.present[m]
        numeric_cols[f] = NumericColumn(f, kind, values, present)
    keyword_cols = {f: _merge_keywords(f, segments, dmaps, ndocs)
                    for f in sorted({f for s in segments
                                     for f in s.keyword_cols})}

    doc_lens: Dict[str, np.ndarray] = {}
    text_stats: Dict[str, TextFieldStats] = {}
    for f in sorted({f for s in segments for f in s.doc_lens}):
        dl = np.zeros(ndocs, np.int64)
        for s, m, dmap in zip(segments, live_masks, dmaps):
            sdl = s.doc_lens.get(f)
            if sdl is not None:
                dl[dmap[m]] = sdl[m]
        doc_lens[f] = dl
        text_stats[f] = TextFieldStats(doc_count=int((dl > 0).sum()),
                                       sum_dl=int(dl.sum()))

    stored_vals = None
    if any(s.stored_vals for s in segments):
        # in the concatenation order of `ids`
        stored_vals = [s.stored_vals[i] if s.stored_vals else None
                       for s, m in zip(segments, live_masks)
                       for i in np.flatnonzero(m)]
    t_geo = time.perf_counter()
    geo_cols, shape_cols = _merge_geo(segments, live_masks, dmaps, ndocs)
    t_geo = time.perf_counter() - t_geo
    nested = {npath: _merge_nested(name, npath, segments, dmaps, device)
              for npath in sorted({p for s in segments for p in s.nested})}
    merged = Segment(name, ndocs, postings, doc_lens, text_stats, ids,
                     sources, seq_nos=seq_nos, numeric_cols=numeric_cols,
                     keyword_cols=keyword_cols, stored_vals=stored_vals,
                     geo_cols=geo_cols, shape_cols=shape_cols,
                     nested={p: b for p, b in nested.items()
                             if b is not None})
    t_host = time.perf_counter() - t0 - t_sort - t_pos - t_geo
    t1 = time.perf_counter()
    if default_codec_version() >= CODEC_V2:
        # a FEATURE plane is rebuilt wherever any input carried one: the
        # opt-in travels with the data, so a merge needs no mappings
        merged.build_impacts(feature_fields={
            f for s in segments for f, pb in s.postings.items()
            if pb.impact is not None and pb.impact.kind == "feature"},
            device=device)
    t2 = time.perf_counter()
    # last, when the postings' and the quantizer's temporaries are gone:
    # a column may be as large as every other plane together
    merged.vector_cols = {f: _merge_vectors(f, segments, live_masks, dmaps,
                                            ndocs)
                          for f in sorted({f for s in segments
                                           for f in s.vector_cols})}
    LAST_MERGE.clear()
    LAST_MERGE.update(host_concat_s=t_host, sort_s=t_sort,
                      positions_s=t_pos, quantize_s=t2 - t1,
                      vectors_s=time.perf_counter() - t2, geo_s=t_geo)
    return merged
