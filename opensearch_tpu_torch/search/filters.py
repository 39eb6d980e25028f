"""Filter masks: the dense bool[ndocs] match mask of a filter-context plan
node over one segment, as torch ops on a device (the counterpart of the
reference's mask programs and mask cache, opensearch_tpu/search/
compiler.py `filter_mask_for` / `_mask_for_key`).

Served nodes:
- `LTerms` in filter mode (a term or terms clause): docs with a posting in
  any of the term rows; in score mode (a match in filter context): docs
  with postings in at least `msm` of the term rows;
- `LRange`: the exact i64 bounds over the numeric column, docs with a
  value only;
- `LBool` of served nodes: musts and filters ANDed, must_nots negated,
  shoulds counted against `msm`;
- `LConstScore`: its child's mask; `LMatchNone`: no doc; `LMatchAll`:
  every doc;
- `LExists`: docs with a value (`present_mask`); `LIds`: the listed docs.
Any other node raises `NotPortedError`. A mask ignores deletes: every
consumer ANDs the segment's live mask itself (the general path starts
each bool from it; the fast path serves no segment with deletes), so a
delete leaves the cached masks valid.

Masks are cached per (segment, device) under a structural key made of
what the reference's mask-cache digest hashes: a term group's rows,
weights, msm, avgdl, boost, similarity and mode; a range's i64 bounds,
flags and boost; a bool's msm, boost and children. Clauses the reference
caches as one mask share one mask here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import NotPortedError
from ..index.segment import next_pow2
from ..ops import scoring as ops
from . import compiler as C

I64_MIN = -(2**63)
I64_MAX = 2**63 - 1


def mask_key(node: C.LNode, seg, ctx: C.ShardContext) -> tuple:
    """Structural cache key of a filter node over `seg`."""
    if isinstance(node, C.LTerms):
        pb = seg.postings.get(node.field)
        T_pad = next_pow2(len(node.terms), floor=1)
        rows = [-1] * T_pad
        if pb is not None:
            for i, t in enumerate(node.terms):
                rows[i] = pb.row(t)
        w = np.zeros(T_pad, np.float32)
        w[:len(node.terms)] = node.weights
        b_eff = node.sim.b if node.has_norms else 0.0
        return ("terms", node.field, tuple(rows), w.tobytes(),
                float(np.float32(node.msm)),
                float(np.float32(ctx.avgdl(node.field))),
                float(np.float32(node.boost)), node.sim.sim_id,
                float(node.sim.k1), float(b_eff), node.mode)
    if isinstance(node, C.LRange):
        return ("range", node.field, node.kind, node.include_lo,
                node.include_hi, node.field in seg.numeric_cols,
                float(np.float32(node.boost)),
                I64_MIN if node.lo is None else int(node.lo),
                I64_MAX if node.hi is None else int(node.hi))
    if isinstance(node, C.LBool):
        def keys(nodes):
            return tuple(mask_key(c, seg, ctx) for c in nodes)
        return ("bool", float(np.float32(node.msm)),
                float(np.float32(node.boost)), keys(node.musts),
                keys(node.shoulds), keys(node.must_nots),
                keys(node.filters))
    if isinstance(node, C.LConstScore):
        return ("const", float(np.float32(node.boost)),
                mask_key(node.child, seg, ctx))
    if isinstance(node, C.LMatchNone):
        return ("match_none",)
    if isinstance(node, C.LMatchAll):
        return ("match_all",)
    if isinstance(node, C.LExists):
        return ("exists", node.field)
    if isinstance(node, C.LIds):
        return ("ids", tuple(sorted({d for d in (seg.local_doc(i)
                                                  for i in node.ids)
                                     if d >= 0})))
    raise NotPortedError(f"filter clause [{type(node).__name__}]")


def filter_mask(node: C.LNode, seg, ctx: C.ShardContext,
                device: torch.device) -> torch.Tensor:
    """bool[ndocs] on `device`: the docs of `seg` that `node` matches,
    cached per segment and device."""
    key = ("mask", mask_key(node, seg, ctx), str(device))
    mask = seg.aligned.get(key)
    if mask is None:
        mask = _mask(node, seg, ctx, device)
        seg.aligned[key] = mask
    return mask


def _mask(node, seg, ctx, device) -> torch.Tensor:
    nd = seg.ndocs
    if isinstance(node, C.LTerms):
        pb = seg.postings.get(node.field)
        if pb is None:
            return torch.zeros(nd, dtype=torch.bool, device=device)
        count = torch.zeros(nd, dtype=torch.int32, device=device)
        for t in node.terms:
            r = pb.row(t)
            if r < 0:
                continue
            a, b = pb.row_slice(r)
            docs = torch.from_numpy(pb.doc_ids[a:b]).to(device).long()
            # doc ids are unique within a row: one add per doc
            count[docs] += 1
        if node.mode == "filter":
            return count > 0
        return (count > 0) & (count.to(torch.float32)
                              >= float(np.float32(node.msm)))
    if isinstance(node, C.LRange):
        col = seg.numeric_on(node.field, device)
        if col is None:
            return torch.zeros(nd, dtype=torch.bool, device=device)
        values, present = col
        lo = I64_MIN if node.lo is None else int(node.lo)
        hi = I64_MAX if node.hi is None else int(node.hi)
        lower = values >= lo if node.include_lo else values > lo
        upper = values <= hi if node.include_hi else values < hi
        return lower & upper & present
    if isinstance(node, C.LBool):
        m = torch.ones(nd, dtype=torch.bool, device=device)
        for c in node.musts + node.filters:
            m &= filter_mask(c, seg, ctx, device)
        for c in node.must_nots:
            m &= ~filter_mask(c, seg, ctx, device)
        if node.shoulds:
            count = torch.zeros(nd, dtype=torch.float32, device=device)
            for c in node.shoulds:
                count += filter_mask(c, seg, ctx, device).to(torch.float32)
            m &= count >= float(np.float32(node.msm))
        return m
    if isinstance(node, C.LConstScore):
        return filter_mask(node.child, seg, ctx, device)
    if isinstance(node, C.LMatchNone):
        return torch.zeros(nd, dtype=torch.bool, device=device)
    if isinstance(node, C.LMatchAll):
        return torch.ones(nd, dtype=torch.bool, device=device)
    if isinstance(node, C.LExists):
        return present_mask(node.field, seg, device)
    if isinstance(node, C.LIds):
        return ops.docs_mask(mask_key(node, seg, ctx)[1], nd, device)
    raise NotPortedError(f"filter clause [{type(node).__name__}]")


def present_mask(field: str, seg, device: torch.device) -> torch.Tensor:
    """bool[ndocs]: the docs of `seg` with a value in `field`, as the
    reference's `exists` reads them: a numeric column's present flags, a
    text field's nonzero doc lengths, else (a keyword field) any posting
    of the field. Cached per segment and device."""
    def make():
        nd = seg.ndocs
        col = seg.numeric_on(field, device)
        if col is not None:
            return col[1]
        if field in seg.doc_lens:
            return torch.from_numpy(seg.doc_lens[field] > 0).to(device)
        m = torch.zeros(nd, dtype=torch.bool, device=device)
        pb = seg.postings.get(field)
        if pb is not None and pb.size:
            m[torch.from_numpy(pb.doc_ids).to(device).long()] = True
        return m
    return seg.device_cached(("present", field), device, make)
