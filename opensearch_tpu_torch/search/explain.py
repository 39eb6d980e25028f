"""Per-hit `_explanation` and the explain call (the reference's
`explain_doc` and `_host_phrase_freq`, opensearch_tpu/search/executor.py):
a host recompute of one doc's score, node by node, with the reference's
Python-float arithmetic, so that each value equals the reference's bit
for bit. The hit's `_score` comes from a kernel or a torch op and may sit
a few ulp away, as it does in the reference.

A term group sums each matching term's BM25 (`idf*boost * tf/(tf+k)`), a
phrase its sloppy frequency's; bool sums its must and should clauses
times its boost, dis_max takes the best plus the tie breaker times the
rest, constant_score, range, match_all and exists give their boost where
they match. Every other node the port serves (boosting, terms_set,
pinned, combined_fields, ids, match_none, the term expansions, kNN) gets
the reference's fallback: 0.0 described by its class name. A nested
node reduces the child program's scores in the doc's block by its score
mode, each matching child explained as a detail; has_child reduces its
matching children's, has_parent takes its parent's (or 1), both from
the device program over their segments, as the reference's. The
reference's host-span branch has no node to walk here: the port's
rewrite raises NotPortedError for those queries before a search reaches
the fetch.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..index.segment import Segment
from ..ops.scoring import SIM_BM25
from . import compiler as C


def host_phrase_freq(node: C.LPhrase, seg: Segment, doc: int) -> float:
    """One doc's sloppy phrase frequency on the host (the reference's
    `_host_phrase_freq`, a mirror of its device pair join)."""
    pb = seg.postings.get(node.field)
    if pb is None or pb.pos_starts is None:
        return 0.0
    pos_lists: List[np.ndarray] = []
    last = len(node.terms) - 1
    for i, t in enumerate(node.terms):
        if node.prefix_last and i == last:
            rows = list(C._prefix_rows(pb, t, node.max_expansions))
        else:
            r = pb.row(t)
            rows = [r] if r >= 0 else []
        plist: List[int] = []
        for r in rows:
            a, b = pb.row_slice(r)
            k = a + int(np.searchsorted(pb.doc_ids[a:b], doc))
            if k < b and pb.doc_ids[k] == doc:
                plist.extend((pb.positions[pb.pos_starts[k]:
                                           pb.pos_starts[k + 1]]
                              - i).tolist())
        if not plist:
            return 0.0
        pos_lists.append(np.asarray(sorted(plist)))
    freq = 0.0
    for base in pos_lists[0]:
        ok = True
        if node.ordered:
            # greedy sequential join, as the device's ordered path
            prev = 0.0
            for arr in pos_lists[1:]:
                j = int(np.searchsorted(arr, base + prev))
                if j >= len(arr):
                    ok = False
                    break
                prev = float(arr[j]) - float(base)
            cost = prev if ok else 0.0
        else:
            deltas = [0.0]
            for arr in pos_lists[1:]:
                j = int(np.searchsorted(arr, base))
                # a tie prefers the right neighbour, as the device does
                cands = [int(arr[jj]) - int(base)
                         for jj in (j, j - 1) if 0 <= jj < len(arr)]
                if not cands:
                    ok = False
                    break
                deltas.append(float(min(cands, key=abs)))
            if ok:
                if node.gap_cost:
                    abs_off = [d + i for i, d in enumerate(deltas)]
                    cost = max(abs_off) - min(abs_off) + 1 - len(deltas)
                else:
                    med = sorted(deltas)[len(deltas) // 2]
                    cost = sum(abs(d - med) for d in deltas)
        if ok and cost <= node.slop:
            freq += 1.0 / (1.0 + cost)
    return freq


def _doc_len(seg: Segment, field: str, doc: int) -> float:
    return float(seg.doc_lens[field][doc]) if field in seg.doc_lens else 0.0


def explain_doc(lroot: C.LNode, seg: Segment, doc: int,
                ctx: C.ShardContext) -> dict:
    """The explanation tree {value, description, details} of `doc`
    under the plan `lroot`, with the collection statistics of `ctx` (the
    ones the query phase scored with)."""

    def walk(n) -> Tuple[float, dict]:
        if isinstance(n, C.LPhrase):
            freq = host_phrase_freq(n, seg, doc)
            dl = _doc_len(seg, n.field, doc)
            avgdl = max(ctx.avgdl(n.field), 1e-9)
            b_eff = n.sim.b if n.has_norms else 0.0
            kk = n.sim.k1 * (1 - b_eff + b_eff * dl / avgdl)
            total = n.weight * freq / (freq + kk) if freq > 0 else 0.0
            desc = (f'phrase "{" ".join(n.terms)}" on [{n.field}]: '
                    f'idf-sum*boost {n.weight:.4f} * sloppyFreq '
                    f'{freq:.3f}/(freq+{kk:.3f})')
            return total, {"value": total, "description": desc,
                           "details": []}
        if isinstance(n, C.LTerms):
            details = []
            total = 0.0
            dl = _doc_len(seg, n.field, doc)
            avgdl = ctx.avgdl(n.field)
            pb = seg.postings.get(n.field)
            for i, t in enumerate(n.terms):
                if pb is None:
                    continue
                r = pb.row(t)
                if r < 0:
                    continue
                a, b = pb.row_slice(r)
                k = a + int(np.searchsorted(pb.doc_ids[a:b], doc))
                if k >= b or pb.doc_ids[k] != doc:
                    continue
                tf = float(pb.tfs[k])
                w = float(n.weights[i])
                sim = n.sim
                if sim.sim_id == SIM_BM25:
                    b_eff = sim.b if n.has_norms else 0.0
                    kk = sim.k1 * (1 - b_eff
                                   + b_eff * dl / max(avgdl, 1e-9))
                    contrib = w * tf / (tf + kk)
                    desc = (f"weight({n.field}:{t}) = idf*boost {w:.4f} * "
                            f"tf {tf:.0f}/(tf+{kk:.3f})")
                else:
                    contrib = w
                    desc = f"weight({n.field}:{t})"
                total += contrib
                details.append({"value": contrib, "description": desc,
                                "details": []})
            return total, {"value": total,
                           "description": f"sum of term scores on "
                                          f"[{n.field}]",
                           "details": details}
        if isinstance(n, C.LBool):
            total = 0.0
            details = []
            for c in n.musts + n.shoulds:
                v, d = walk(c)
                total += v
                details.append(d)
            total *= n.boost
            return total, {"value": total, "description": "sum of:",
                           "details": details}
        if isinstance(n, C.LConstScore):
            return n.boost, {"value": n.boost,
                             "description": "ConstantScore", "details": []}
        if isinstance(n, C.LDisMax):
            vals = [walk(c) for c in n.children]
            best = max((v for v, _ in vals), default=0.0)
            total = best + n.tie_breaker * (sum(v for v, _ in vals) - best)
            return total, {"value": total,
                           "description": "max plus tie_breaker of:",
                           "details": [d for _, d in vals]}
        if isinstance(n, C.LRange):
            col = seg.numeric_cols.get(n.field)
            ok = col is not None and bool(col.present[doc])
            if ok:
                v = float(col.values[doc])
                if n.lo is not None:
                    ok = v >= float(n.lo) if n.include_lo else v > float(n.lo)
                if ok and n.hi is not None:
                    ok = v <= float(n.hi) if n.include_hi else v < float(n.hi)
            val = n.boost if ok else 0.0
            return val, {"value": val,
                         "description": f"range filter on [{n.field}]",
                         "details": []}
        if isinstance(n, C.LMatchAll):
            return n.boost, {"value": n.boost, "description": "*:*",
                             "details": []}
        if isinstance(n, C.LExists):
            f = n.field
            ok = ((f in seg.numeric_cols
                   and bool(seg.numeric_cols[f].present[doc]))
                  or (f in seg.keyword_cols
                      and int(seg.keyword_cols[f].min_ord[doc]) >= 0)
                  or (f in seg.doc_lens and int(seg.doc_lens[f][doc]) > 0))
            val = n.boost if ok else 0.0
            return val, {"value": val, "description": f"exists [{f}]",
                         "details": []}
        if isinstance(n, C.LNested):
            return _explain_nested(n, seg, doc)
        if isinstance(n, C.LHasChild):
            ji = n.join_index
            vals = []
            dense: dict = {}
            for cseg, cd in ji.children_of(ji.seg_base(seg) + doc):
                if cseg.uid not in dense:
                    dense[cseg.uid] = _dense(n.child, cseg, ctx)
                csc, cm = dense[cseg.uid]
                if cm[cd] and cseg.live[cd]:
                    vals.append(float(csc[cd]))
            mode = n.score_mode
            total = 0.0
            if max(n.min_children, 1) <= len(vals) <= n.max_children:
                total = _reduce(vals, mode) * n.boost
            return total, {"value": total,
                           "description": (f"has_child [{n.child_rel}] "
                                           f"{mode} of {len(vals)} matching "
                                           f"children"),
                           "details": []}
        if isinstance(n, C.LHasParent):
            ji = n.join_index
            slot = int(ji.pslot(seg)[doc])
            loc = ji.slot_to_doc(slot) if slot >= 0 else None
            total = 0.0
            if loc is not None:
                pseg, pd = loc
                psc, pm = _dense(n.child, pseg, ctx)
                if pm[pd] and pseg.live[pd]:
                    total = (float(psc[pd]) if n.use_score else 1.0) * n.boost
            return total, {"value": total,
                           "description": f"has_parent [{n.parent_rel}]",
                           "details": []}
        return 0.0, {"value": 0.0, "description": type(n).__name__,
                     "details": []}

    return walk(lroot)[1]


def _dense(node: C.LNode, seg: Segment, ctx) -> tuple:
    """(scores, matched) of `node` over every doc of `seg`, as numpy: the
    device program the query ran, whose matches a host walk cannot see in
    filter context."""
    sm = C.emit(node, seg, ctx, ctx.device)
    return sm.scores.cpu().numpy(), sm.matched.cpu().numpy()


def _reduce(vals: List[float], mode: str) -> float:
    return (sum(vals) / len(vals) if mode == "avg" else
            max(vals) if mode == "max" else
            min(vals) if mode == "min" else
            1.0 if mode == "none" else sum(vals))


def _explain_nested(n: C.LNested, seg: Segment, doc: int) -> tuple:
    """A nested node: its score from the child program's matches in the
    doc's block, reduced by the score mode, with each matching child's
    explanation as a detail."""
    blk = seg.nested.get(n.path)
    if blk is None or blk.child.ndocs == 0:
        return 0.0, {"value": 0.0, "description": "no nested docs",
                     "details": []}
    csc, cm = _dense(n.child, blk.child, n.child_ctx)
    a, b = blk.children_of(doc)
    vals = [float(csc[i]) for i in range(a, b) if cm[i]]
    if not vals:
        return 0.0, {"value": 0.0,
                     "description": f"no matching children in [{n.path}]",
                     "details": []}
    total = _reduce(vals, n.score_mode) * n.boost
    return total, {"value": total,
                   "description": f"nested [{n.path}] {n.score_mode} of "
                                  f"children:",
                   "details": [explain_doc(n.child, blk.child, cd,
                                           n.child_ctx)
                               for cd in range(a, b) if cm[cd]]}
