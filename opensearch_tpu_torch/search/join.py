"""The parent-child join (a copy of opensearch_tpu/search/join.py, its
slot-space passes as torch ops).

The shard's join is a flat slot space: every segment gets a base offset
(its predecessors' `ndocs_pad` summed), a doc's own slot is base + doc, and
each child doc holds the slot of its parent (`parent_slot`, -1 where the
parent id resolves to no doc; the latest live copy of an id wins, else its
first dead one, as in the reference). A has_child query is two passes: the
child plan over every segment, its matches and scores scattered into the
parents' slots (`join_prepass`: counts and sums as f32 index_add, max and
min as scatter_reduce), then each segment's window of the slot vectors
read at its parents (`emit_join`). A has_parent query places the parent
plan's matches and scores at the parents' own slots and gathers them
through each child's slot. The children / parent aggregations ride the
same pre-pass (`compiler.emit_agg`).

A `JoinIndex` holds its segments by weak reference, so a cached one pins
no segment that a refresh or a merge replaced (only its own parent-slot
arrays, and their copies on a device, `pslot_on`); `get_join_index` keeps
the last 8, keyed by the segments' ids and delete generations.
"""

from __future__ import annotations

import time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..index.segment import Segment, next_pow2
from ..ops import scoring as ops
from . import compiler as C

F32_MAX = 3.4e38


class JoinIndex:
    """The slot space over one immutable segment list."""

    def __init__(self, segments: List[Segment], join_field: str):
        self._seg_refs = [weakref.ref(s) for s in segments]
        self.join_field = join_field
        self.base: Dict[int, int] = {}
        off = 0
        for s in segments:
            self.base[s.uid] = off
            off += s.ndocs_pad
        self.gsize = next_pow2(max(off, 16))

        def locate(pid: str) -> int:
            fallback = -1
            for s in segments:
                d = s.local_doc(pid)
                if d >= 0:
                    if s.live[d]:
                        return self.base[s.uid] + d
                    if fallback < 0:
                        fallback = self.base[s.uid] + d
            return fallback

        self.parent_slot: Dict[int, np.ndarray] = {}
        for s in segments:
            arr = np.full(s.ndocs, -1, np.int32)
            pcol = s.keyword_cols.get(f"{join_field}#parent")
            if pcol is not None and pcol.vocab:
                # each distinct parent id resolved once, fanned out by
                # ordinal
                slot_of_ord = np.fromiter((locate(p) for p in pcol.vocab),
                                          np.int32, count=len(pcol.vocab))
                present = pcol.min_ord[:s.ndocs] >= 0
                vals = np.where(present, pcol.min_ord[:s.ndocs], 0)
                arr[:] = np.where(present, slot_of_ord[vals], -1)
            self.parent_slot[s.uid] = arr
        self._children_sorted = None
        self._on: Dict[tuple, torch.Tensor] = {}

    @property
    def segments(self) -> List[Segment]:
        return [s for s in (r() for r in self._seg_refs) if s is not None]

    def seg_base(self, seg: Segment) -> int:
        return self.base.get(seg.uid, 0)

    def pslot(self, seg: Segment) -> np.ndarray:
        arr = self.parent_slot.get(seg.uid)
        return arr if arr is not None else np.full(seg.ndocs, -1, np.int32)

    def pslot_on(self, seg: Segment, device) -> torch.Tensor:
        """i64[ndocs] parent slots of `seg` on `device`."""
        key = (seg.uid, str(device))
        got = self._on.get(key)
        if got is None:
            got = self._on[key] = torch.from_numpy(
                self.pslot(seg).astype(np.int64)).to(device)
        return got

    def slot_to_doc(self, slot: int) -> Optional[Tuple[Segment, int]]:
        for s in self.segments:
            b = self.base[s.uid]
            if b <= slot < b + s.ndocs_pad:
                d = slot - b
                return (s, d) if d < s.ndocs else None
        return None

    def children_of(self, gslot: int) -> List[Tuple[Segment, int]]:
        """Every child doc whose parent holds `gslot` (the host's reverse
        lookup for inner_hits)."""
        if self._children_sorted is None:
            snapshot = self.segments
            slots, segi, docs = [], [], []
            for i, s in enumerate(snapshot):
                arr = self.parent_slot[s.uid]
                nz = np.nonzero(arr >= 0)[0]
                slots.append(arr[nz])
                segi.append(np.full(len(nz), i, np.int32))
                docs.append(nz.astype(np.int32))
            sl = np.concatenate(slots) if slots else np.empty(0, np.int32)
            sg = np.concatenate(segi) if segi else np.empty(0, np.int32)
            dc = np.concatenate(docs) if docs else np.empty(0, np.int32)
            order = np.argsort(sl, kind="stable")
            self._children_sorted = (sl[order], sg[order], dc[order],
                                     [weakref.ref(s) for s in snapshot])
        sl, sg, dc, refs = self._children_sorted
        a = int(np.searchsorted(sl, gslot, "left"))
        b = int(np.searchsorted(sl, gslot, "right"))
        out = []
        for i in range(a, b):
            s = refs[int(sg[i])]()
            if s is not None:
                out.append((s, int(dc[i])))
        return out


_cache: Dict[Tuple, JoinIndex] = {}
# seconds of the last JoinIndex build (read by chip_smoke's phase 22)
LAST_BUILD_S = [0.0]


def get_join_index(segments: List[Segment], join_field: str) -> JoinIndex:
    key = (join_field, tuple((s.uid, s.live_gen) for s in segments))
    ji = _cache.get(key)
    if ji is None:
        t0 = time.perf_counter()
        ji = JoinIndex(segments, join_field)
        LAST_BUILD_S[0] = time.perf_counter() - t0
        if len(_cache) >= 8:
            _cache.pop(next(iter(_cache)))
        _cache[key] = ji
    return ji


def clear_cache() -> None:
    _cache.clear()


def join_prepass(child: C.LNode, ji: JoinIndex, need: Tuple[str, ...],
                 ctx: C.ShardContext, device,
                 self_slots: bool = False) -> Dict[str, torch.Tensor]:
    """The slot-space vectors of `child` over every live segment of the
    join index: "cnt" (matches) and "sum" (scores) f32 adds, "max" / "min"
    reductions; at each doc's parent slot, or at its own with
    `self_slots`. Unmatched slots hold 0, -3.4e38 or 3.4e38."""
    acc: Dict[str, torch.Tensor] = {}
    for seg in ji.segments:
        if seg.live_count == 0:
            continue
        sm = C.emit(child, seg, ctx, device)
        if self_slots:
            base = ji.seg_base(seg)
            gslot = torch.arange(base, base + seg.ndocs, device=device)
        else:
            gslot = ji.pslot_on(seg, device)
        ok = (gslot >= 0) & sm.matched
        idx = gslot[ok]
        sc = sm.scores[ok]
        vecs = {}
        if "cnt" in need:
            vecs["cnt"] = torch.zeros(ji.gsize, device=device).index_add_(
                0, idx, torch.ones_like(sc))
        if "sum" in need:
            vecs["sum"] = torch.zeros(ji.gsize, device=device).index_add_(
                0, idx, sc)
        for k, fill, how in (("max", -F32_MAX, "amax"),
                             ("min", F32_MAX, "amin")):
            if k in need:
                vecs[k] = torch.full((ji.gsize,), fill, device=device
                                     ).scatter_reduce_(0, idx, sc, how)
        for k, v in vecs.items():
            if k not in acc:
                acc[k] = v
            elif k == "max":
                acc[k] = torch.maximum(acc[k], v)
            elif k == "min":
                acc[k] = torch.minimum(acc[k], v)
            else:
                acc[k] = acc[k] + v
    fill = {"cnt": 0.0, "sum": 0.0, "max": -F32_MAX, "min": F32_MAX}
    for k in need:
        if k not in acc:
            acc[k] = torch.full((ji.gsize,), fill[k], device=device)
    return acc


def emit_join(node, seg: Segment, ctx: C.ShardContext, live: torch.Tensor,
              zeros: torch.Tensor, device) -> ops.ScoredMask:
    """The (scores, match) of a has_child or has_parent node over `seg`,
    its slot pre-pass run once for the query."""
    ji = node.join_index
    if isinstance(node, C.LHasChild):
        if node.pre is None:
            need = {"cnt"}
            if node.score_mode in ("sum", "avg"):
                need.add("sum")
            elif node.score_mode in ("max", "min"):
                need.add(node.score_mode)
            node.pre = join_prepass(node.child, ji, tuple(sorted(need)),
                                    ctx, device)
        base = ji.seg_base(seg)
        window = slice(base, base + seg.ndocs)
        cnt = node.pre["cnt"][window]
        pmask = C.emit(node.parent_filter, seg, ctx, device).matched
        # at least one matching child, always
        ok = ((cnt >= C._f32(max(node.min_children, 1)))
              & (cnt <= C._f32(min(node.max_children, 2**31 - 1)))
              & pmask & live)
        mode = node.score_mode
        if mode == "none":
            sc = torch.ones_like(zeros)
        elif mode in ("sum", "avg"):
            sc = node.pre["sum"][window]
            if mode == "avg":
                sc = sc / torch.clamp(cnt, min=1.0)
        else:
            sc = node.pre[mode][window]
        return ops.ScoredMask(torch.where(ok, sc * C._f32(node.boost), zeros),
                              ok.to(torch.float32))
    if node.pre is None:
        node.pre = join_prepass(node.child, ji, ("cnt", "sum"), ctx, device,
                                self_slots=True)
    pslot = ji.pslot_on(seg, device)
    idx = torch.clamp(pslot, 0, ji.gsize - 1)
    cmask = C.emit(node.child_filter, seg, ctx, device).matched
    ok = (pslot >= 0) & (node.pre["cnt"][idx] > 0) & cmask & live
    sc = node.pre["sum"][idx] if node.use_score else torch.ones_like(zeros)
    return ops.ScoredMask(torch.where(ok, sc * C._f32(node.boost), zeros),
                          ok.to(torch.float32))
