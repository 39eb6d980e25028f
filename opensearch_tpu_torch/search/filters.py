"""Filter masks: the dense bool[ndocs] match mask of a filter-context plan
node over one segment, as torch ops on a device (the counterpart of the
reference's mask programs and mask cache, opensearch_tpu/search/
compiler.py `filter_mask_for` / `_mask_for_key`).

Served nodes:
- `LTerms` in filter mode (a term or terms clause): docs with a posting in
  any of the term rows; in score mode (a match in filter context): docs
  with postings in at least `msm` of the term rows;
- `LRange`: the exact i64 bounds over a long-family column (an ip's
  integers, an unsigned_long's biased values), or f32 bounds over the
  f32 view of a float-family column (the reference's
  `float_range_mask`), docs with a value only;
- `LBool` of served nodes: musts and filters ANDed, must_nots negated,
  shoulds counted against `msm`;
- `LPhrase`: docs where the phrase occurs (its frequency is above 0);
  `LSourcePhrase`: the docs whose `_source` holds the phrase;
  `LExpandTerms`: docs with a posting in any of the expanded rows;
- `LConstScore`: its child's mask; `LMatchNone`: no doc; `LMatchAll`:
  every doc;
- `LExists`: docs with a value (`present_mask`); `LIds`: the listed docs;
- `LDisMax`: any child's docs; `LBoosting`: its positive side's;
  `LTermsSet`: docs holding at least their own minimum of the terms;
  `LPinned`: the pinned docs and the organic mask; `LCombined`: docs
  holding at least `msm` of the terms over the weighted fields;
- `LKnn`: the docs with a vector (on the IVF route, those in the probed
  lists) that its own filter matches;
- `LRankFeature`: the docs holding its feature (a column: a value);
  `LSparseDot`: the docs holding any of its tokens; `LDistanceFeature`:
  the docs with a date or a geo point;
- `LGeoDist`, `LGeoBox`, `LGeoPolygon`: the geo_point docs inside the
  radius, the box or the ring (`compiler.geo_mask`); `LGeoShape`: the
  host mask of its relation (`compiler.geo_shape_mask`);
- `LScriptFilter`: the docs where the script's value is nonzero, the
  script evaluated over the segment's f32 columns (`eval_device`);
  `LScriptScore` and `LFuncScore`: the docs their own emit matches (the
  child's, cut at `min_score`).
Any other node raises `NotPortedError`. A mask ignores deletes: every
consumer ANDs the segment's live mask itself (the general path starts
each bool from it; the fast path serves no segment with deletes), so a
delete leaves the cached masks valid (the function_score and
script_score masks hold the live mask of their first use: a later
delete only clears docs the consumer's live mask clears too).

Masks are cached per (segment, device), least recently used first out,
in one cache bounded by bytes (`FILTER_MASK_MAX_BYTES`, the reference's
`_FILTER_MASK_MAX_BYTES`), under a structural key made of what the
reference's mask-cache digest hashes: a term group's rows, weights,
msm, avgdl, boost, similarity and mode; a range's kind, its i64 or f32
bounds, flags and boost; a bool's msm, boost and children. Clauses the
reference caches as one mask share one mask here. A phrase's key is its term rows,
slop and cost mode, an expansion's its rows; a compound node's key holds
what its mask reads (a dis_max's children, a boosting's positive side,
a terms_set's minimum field and term group, a pinned query's docs and
organic clause, a combined_fields query's weighted fields, rows and
msm, a kNN node's field, its filter and, on the IVF route, its vector
and nprobe; a script's AST and f32 params; a function_score's child,
modes, min_score, boost and each function's kind, f32 parameters and
filter; a terms_set script's source, params and term count; a geo
node's field and its parameters as f32 where the reference ships them
as f32 scalars or vertices (a radius's `inclusive` flag beside them), a
geo_shape's relation and shape). A segment's masks leave the cache
when it releases its device state or is collected.
"""

from __future__ import annotations

import collections
import itertools
import weakref

import numpy as np
import torch

from ..errors import NotPortedError
from ..index.segment import next_pow2
from ..ops import scoring as ops
from . import compiler as C

I64_MIN = -(2**63)
I64_MAX = 2**63 - 1

# the reference's filter-mask cache bound (IndicesQueryCache's): a body
# whose masks are its own (a locator's origin, a viewport's box, a grid
# bucket's refinement box) cannot grow the cache past it
FILTER_MASK_MAX_BYTES = 256 << 20
# (segment owner, key, device) -> bool[ndocs], least recently used first
_MASKS: collections.OrderedDict = collections.OrderedDict()
_MASK_BYTES = [0]
_OWNERS = itertools.count()


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
    if isinstance(node, C.LPhrase):
        pb = seg.postings.get(node.field)
        rows = ((C._phrase_rows(node, pb, i) for i in range(len(node.terms)))
                if pb is not None and pb.pos_starts is not None else ())
        return ("phrase", node.field, tuple(rows), node.slop, node.ordered,
                node.gap_cost)
    if isinstance(node, C.LExpandTerms):
        return ("xterms", node.field, tuple(node.rows(seg).tolist()))
    if isinstance(node, C.LRange):
        return ("range", node.field, node.kind, node.include_lo,
                node.include_hi, node.field in seg.numeric_cols,
                float(np.float32(node.boost))) + _bounds(node)
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
    if isinstance(node, C.LSourcePhrase):
        return ("source_phrase", node.field, tuple(node.terms), node.slop)
    if isinstance(node, C.LIds):
        return ("ids", tuple(sorted({d for d in (seg.local_doc(i)
                                                  for i in node.ids)
                                     if d >= 0})))
    if isinstance(node, C.LDisMax):
        return ("dismax",) + tuple(mask_key(c, seg, ctx)
                                   for c in node.children)
    if isinstance(node, C.LBoosting):
        return ("boosting", mask_key(node.positive, seg, ctx))
    if isinstance(node, C.LTermsSet):
        return ("terms_set", C.terms_set_key(node),
                mask_key(node.child, seg, ctx))
    if isinstance(node, C.LPinned):
        return ("pinned", tuple(sorted(set(C.pinned_docs(node, seg)[0]))),
                None if node.organic is None
                else mask_key(node.organic, seg, ctx))
    if isinstance(node, C.LCombined):
        rows = tuple(
            tuple(pb.row(t) for t in node.terms) if pb is not None else None
            for pb in (seg.postings.get(f) for f, _w in node.fields))
        return ("combined", tuple((f, float(np.float32(w)))
                                  for f, w in node.fields), rows,
                float(np.float32(node.msm)))
    if isinstance(node, C.LKnn):
        probe = C.knn_nprobe(node, seg, ctx.device)
        route = (None if probe is None else
                 (np.asarray(node.vector, np.float32).tobytes(), probe[1]))
        return ("knn", node.field, route,
                None if node.filter is None
                else mask_key(node.filter, seg, ctx))
    if isinstance(node, C.LRankFeature):
        return ("rank_feature", node.field, node.feature)
    if isinstance(node, C.LSparseDot):
        pb = seg.postings.get(node.field)
        return ("sparse_dot", node.field, None if pb is None
                else tuple(pb.row(t) for t in node.tokens))
    if isinstance(node, C.LDistanceFeature):
        return ("distance_feature", node.field)
    if isinstance(node, C.LGeoDist):
        return ("geo_distance", node.field, _f32s(node.lat, node.lon,
                                                  node.radius_m),
                node.inclusive)
    if isinstance(node, C.LGeoBox):
        return ("geo_box", node.field, _f32s(node.top, node.left,
                                             node.bottom, node.right))
    if isinstance(node, C.LGeoPolygon):
        return ("geo_polygon", node.field, _f32s(*node.lats),
                _f32s(*node.lons))
    if isinstance(node, C.LGeoShape):
        return ("geo_shape", node.field, node.relation,
                C.shape_key(node.shape))
    if isinstance(node, C.LScriptFilter):
        return ("script", node.ast, _script_params_key(node.params))
    if isinstance(node, C.LScriptScore):
        return ("script_score", node.ast, _script_params_key(node.params),
                _f32_or_min(node.min_score), float(np.float32(node.boost)),
                mask_key(node.child, seg, ctx))
    if isinstance(node, C.LNested):
        blk = seg.nested.get(node.path)
        return ("nested", node.path, None if blk is None else
                mask_key(node.child, blk.child, node.child_ctx))
    if isinstance(node, (C.LHasChild, C.LHasParent, C.LPercolate)):
        # a join reads every segment, a percolation its candidates: a key
        # of its own a node, never shared
        if "mask_token" not in node.__dict__:
            node.__dict__["mask_token"] = next(_OWNERS)
        return ("once", node.__dict__["mask_token"])
    if isinstance(node, C.LFuncScore):
        return ("function_score", mask_key(node.child, seg, ctx),
                tuple(_function_key(fn, filt, seg, ctx)
                      for fn, filt in zip(node.functions, node.fn_filters)),
                node.score_mode, node.boost_mode,
                _f32_or_min(node.min_score), float(np.float32(node.boost)))
    raise NotPortedError(f"filter clause [{type(node).__name__}]")


def _f32s(*vals) -> tuple:
    return tuple(float(np.float32(v)) for v in vals)


def _script_params_key(params: dict) -> tuple:
    """A score / filter script's params as the f32 values it reads (a
    non-numeric one is the reference's 400, as the mask would raise)."""
    return tuple((k, float(v))
                 for k, v in C.script_param_values(params).items())


def _f32_or_min(v) -> float:
    return float(np.float32(C.F32_MIN if v is None else v))


def _function_key(fn, filt, seg, ctx) -> tuple:
    """One function_score function's key: its kind, f32 weight, what its
    factor reads (a decay its resolved f32 origin, scale constant and
    offset) and its filter's key."""
    if fn.kind == "field_value_factor":
        what = (fn.field, float(np.float32(fn.factor)),
                _f32_or_min(1.0 if fn.missing is None else fn.missing),
                fn.modifier)
    elif fn.kind == "random_score":
        what = (int(np.int32(fn.seed)),)
    elif fn.kind == "script_score":
        what = (fn.script, _script_params_key(fn.script_params or {}))
    elif fn.kind == "decay":
        field, origin, a, offset, exists, kind = C.decay_params(fn, seg, ctx)
        what = (fn.decay_shape, field,
                _f32s(*origin) if kind == "geo" else _f32s(origin),
                float(np.float32(a)), float(np.float32(offset)), exists)
    else:
        what = ()
    return (fn.kind, float(np.float32(fn.weight)), what,
            None if filt is None else mask_key(filt, seg, ctx))


class _MaskOwner:
    """A segment's handle on its cached masks: they leave the cache when
    the segment drops the handle (`Segment.release_device`) or is
    collected."""

    __slots__ = ("n", "__weakref__")

    def __init__(self):
        self.n = next(_OWNERS)
        weakref.finalize(self, _purge, self.n)


def _purge(owner: int) -> None:
    for k in [k for k in _MASKS if k[0] == owner]:
        _MASK_BYTES[0] -= _nbytes(_MASKS.pop(k))


def _nbytes(mask: torch.Tensor) -> int:
    return mask.numel() * mask.element_size()


def mask_cache_stats(device=None) -> dict:
    """The mask cache's entries and bytes (the reference's
    `filter_mask_cache_stats`), and the bytes of its masks on `device`
    where one is given."""
    out = {"entries": len(_MASKS), "bytes": _MASK_BYTES[0],
           "max_bytes": FILTER_MASK_MAX_BYTES}
    if device is not None:
        out["device_bytes"] = sum(_nbytes(m) for k, m in _MASKS.items()
                                  if k[2] == str(device))
    return out


def filter_mask(node: C.LNode, seg, ctx: C.ShardContext,
                device: torch.device) -> torch.Tensor:
    """bool[ndocs] on `device`: the docs of `seg` that `node` matches,
    cached per segment and device under the byte bound."""
    owner = seg.__dict__.get("filter_mask_owner")
    if owner is None:
        owner = seg.__dict__["filter_mask_owner"] = _MaskOwner()
    key = (owner.n, mask_key(node, seg, ctx), str(device))
    mask = _MASKS.get(key)
    if mask is not None:
        _MASKS.move_to_end(key)
        return mask
    mask = _mask(node, seg, ctx, device)
    _MASKS[key] = mask
    _MASK_BYTES[0] += _nbytes(mask)
    while _MASK_BYTES[0] > FILTER_MASK_MAX_BYTES and len(_MASKS) > 1:
        _MASK_BYTES[0] -= _nbytes(_MASKS.popitem(last=False)[1])
    return mask


def _mask(node, seg, ctx, device) -> torch.Tensor:
    nd = seg.ndocs
    if isinstance(node, C.LTerms):
        count = _term_counts(node, seg, device)
        if node.mode == "filter":
            return count > 0
        return (count > 0) & (count.to(torch.float32)
                              >= float(np.float32(node.msm)))
    if isinstance(node, C.LPhrase):
        freq = C.phrase_freq(node, seg, device)
        if freq is None:
            return torch.zeros(nd, dtype=torch.bool, device=device)
        return freq > 0
    if isinstance(node, C.LExpandTerms):
        post = C.field_postings(seg, node.field, device)
        if post is None:
            return torch.zeros(nd, dtype=torch.bool, device=device)
        return ops.term_match_mask(post, torch.ones(nd, dtype=torch.bool,
                                                    device=device),
                                   node.rows(seg).tolist() or [-1], nd)
    if isinstance(node, C.LRange):
        mask = range_mask(node, seg, device)
        return (torch.zeros(nd, dtype=torch.bool, device=device)
                if mask is None else mask)
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
    if isinstance(node, C.LSourcePhrase):
        return ops.docs_mask(node.docs(seg, ctx.mappings), nd, device)
    if isinstance(node, C.LDisMax):
        m = torch.zeros(nd, dtype=torch.bool, device=device)
        for c in node.children:
            m |= filter_mask(c, seg, ctx, device)
        return m
    if isinstance(node, C.LBoosting):
        return filter_mask(node.positive, seg, ctx, device)
    if isinstance(node, C.LTermsSet):
        return (_term_counts(node.child, seg, device).to(torch.float32)
                >= C.terms_set_need(node, seg, device))
    if isinstance(node, C.LPinned):
        m = ops.docs_mask(C.pinned_docs(node, seg)[0], nd, device)
        if node.organic is not None:
            m |= filter_mask(node.organic, seg, ctx, device)
        return m
    if isinstance(node, C.LCombined):
        return (C.combined_counts(node, seg, device)
                >= float(np.float32(node.msm)))
    if isinstance(node, C.LKnn):
        arr = seg.vector_on(node.field, device)
        if arr is None:
            return torch.zeros(nd, dtype=torch.bool, device=device)
        # the scan matches every present row: no product is needed
        m = (arr["present"] if C.knn_nprobe(node, seg, device) is None
             else C.knn_scores(node, seg, device)[1])
        if node.filter is not None:
            m = m & filter_mask(node.filter, seg, ctx, device)
        return m
    if isinstance(node, C.LRankFeature) and node.feature is None:
        col = seg.numeric_on(node.field, device)
        return (torch.zeros(nd, dtype=torch.bool, device=device)
                if col is None else col[1])
    if isinstance(node, (C.LRankFeature, C.LSparseDot)):
        post = C.field_postings(seg, node.field, device)
        if post is None:
            return torch.zeros(nd, dtype=torch.bool, device=device)
        pb = seg.postings[node.field]
        rows = ([pb.row(node.feature)] if isinstance(node, C.LRankFeature)
                else [pb.row(t) for t in node.tokens])
        return ops.term_match_mask(post, torch.ones(nd, dtype=torch.bool,
                                                    device=device), rows, nd)
    if isinstance(node, C.LDistanceFeature):
        return present_mask(node.field, seg, device)
    if isinstance(node, (C.LGeoDist, C.LGeoBox, C.LGeoPolygon,
                         C.LGeoShape)):
        return C.geo_mask(node, seg, device)
    if isinstance(node, C.LScriptFilter):
        return C.script_filter_mask(node, seg, device)
    if isinstance(node, C.LNested):
        blk = seg.nested.get(node.path)
        if blk is None or blk.child.ndocs == 0:
            return torch.zeros(nd, dtype=torch.bool, device=device)
        cm = (filter_mask(node.child, blk.child, node.child_ctx, device)
              & blk.child.live_on(device))
        return torch.zeros(nd, device=device).index_add(
            0, blk.parent_on(device), cm.to(torch.float32)) > 0
    if isinstance(node, (C.LScriptScore, C.LFuncScore, C.LHasChild,
                         C.LHasParent, C.LPercolate)):
        # the min_score cut reads the scores, a join every segment, a
        # percolation its candidates: the node's own emit
        return C.emit(node, seg, ctx, device).matched
    raise NotPortedError(f"filter clause [{type(node).__name__}]")


def _term_counts(node: C.LTerms, seg, device: torch.device) -> torch.Tensor:
    """i32[ndocs]: how many of the group's terms each doc holds."""
    count = torch.zeros(seg.ndocs, dtype=torch.int32, device=device)
    pb = seg.postings.get(node.field)
    if pb is None:
        return count
    for t in node.terms:
        r = pb.row(t)
        if r < 0:
            continue
        a, b = pb.row_slice(r)
        docs = torch.from_numpy(pb.doc_ids[a:b]).to(device).long()
        # doc ids are unique within a row: one add per doc
        count[docs] += 1
    return count


def _bounds(node: C.LRange) -> tuple:
    """(lo, hi) of a range: i64 for kind "int" (open = the i64 extremes),
    f32 values for kind "float" (open = -inf / +inf)."""
    if node.kind == "float":
        return (float(np.float32(-np.inf if node.lo is None else node.lo)),
                float(np.float32(np.inf if node.hi is None else node.hi)))
    return (I64_MIN if node.lo is None else int(node.lo),
            I64_MAX if node.hi is None else int(node.hi))


def range_mask(node: C.LRange, seg, device: torch.device):
    """bool[ndocs] of the docs whose value lies in the range (deletes
    ignored), or None when the segment has no such column."""
    lo, hi = _bounds(node)
    if node.kind == "int":
        col = seg.numeric_on(node.field, device)
        return None if col is None else ops.int64_range_mask(
            *col, lo, hi, node.include_lo, node.include_hi)
    col = seg.f32_on(node.field, device)
    if col is None:
        return None
    v, present = col
    lower = v >= lo if node.include_lo else v > lo
    upper = v <= hi if node.include_hi else v < hi
    return lower & upper & present


def present_mask(field: str, seg, device: torch.device) -> torch.Tensor:
    """bool[ndocs]: the docs of `seg` with a value in `field`, as the
    reference's `exists` reads them: a numeric column's present flags, a
    keyword column's docs with a value, a geo_point column's present
    flags, a text field's nonzero doc lengths, else no doc (a keyword
    field without doc values, a geo_shape field). Cached per segment and
    device."""
    def make():
        col = seg.numeric_on(field, device)
        if col is not None:
            return col[1]
        kw = seg.keyword_on(field, device)
        if kw is not None:
            return kw[2] >= 0
        geo = seg.geo_on(field, device)
        if geo is not None:
            return geo["present"]
        if field in seg.doc_lens:
            return torch.from_numpy(seg.doc_lens[field] > 0).to(device)
        return torch.zeros(seg.ndocs, dtype=torch.bool, device=device)
    return seg.device_cached(("present", field), device, make)
