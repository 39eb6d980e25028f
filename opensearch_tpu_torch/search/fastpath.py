"""The dense term-group fast path: term / terms / match queries through the
fused kernel `ops/bm25.fused_bm25_topk_tfdl` (the dense, exact part of
opensearch_tpu/search/fastpath.py).

Per (segment, field, device) the postings are laid out once as aligned CSR
rows of (doc_id i32, tf<<21|dl i32) resident on the device. Each query
becomes one kernel row, or, when a term's postings exceed the per-slot
budget, one row per doc-range chunk (every doc's postings live in exactly
one chunk, so sums, msm counts and totals stay exact). The host planner
keeps the reference's constants, so kernel rows and chunking are the
reference's. All rows of one shape group ride one launch, and all groups of
a batch come back in ONE device-to-host copy.

Unlike the reference there is no general path behind this one: a search
the fast path cannot serve raises `NotPortedError` naming what it met.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..errors import NotPortedError
from ..index.segment import Segment, next_pow2
from ..ops.bm25 import (DL_BITS, DL_MAX, HBM_ALIGN, LANES, TF_MAX,
                        align_csr_rows, fused_bm25_topk_tfdl)
from . import compiler as C

MAX_T = 8            # pow2-padded term slots per query group
MAX_L = 1 << 16      # per-term window cap (elements)
MAX_TL = 1 << 17     # T_pad * L cap per kernel row
MAX_K = 128          # top-k lanes the kernel returns
MAX_CHUNKS = 4096    # doc-range split bound
INT_MAX = np.int32(2**31 - 1)


class AlignedPostings:
    """Device-resident aligned (doc, tf.dl) postings of one segment field."""

    __slots__ = ("starts_rows", "lens", "d_docs", "d_tfdl", "nbytes")

    def __init__(self, starts_rows: np.ndarray, lens: np.ndarray,
                 d_docs: torch.Tensor, d_tfdl: torch.Tensor):
        self.starts_rows = starts_rows    # i64[nterms] aligned start / LANES
        self.lens = lens                  # i64[nterms] true posting counts
        self.d_docs = d_docs
        self.d_tfdl = d_tfdl
        self.nbytes = (d_docs.numel() + d_tfdl.numel()) * 4


def get_aligned(seg: Segment, field: str,
                device: torch.device) -> Optional[AlignedPostings]:
    """Build (or fetch cached) aligned postings; None when the segment has
    no postings for the field."""
    key = (field, str(device))
    if key not in seg.aligned:
        seg.aligned[key] = _build_aligned(seg, field, device)
    return seg.aligned[key]


def _build_aligned(seg: Segment, field: str,
                   device: torch.device) -> Optional[AlignedPostings]:
    pb = seg.postings.get(field)
    dl = seg.doc_lens.get(field)
    if pb is None or pb.size == 0:
        return None
    tfs = pb.tfs
    dl_of = (dl[pb.doc_ids].astype(np.int64) if dl is not None
             else np.zeros(len(pb.doc_ids), np.int64))
    if tfs.max() > TF_MAX or dl_of.max() > DL_MAX:
        raise NotPortedError(
            f"field [{field}] of segment [{seg.name}] with a term frequency "
            f"above {TF_MAX} or a doc length above {DL_MAX}")
    packed = ((tfs.astype(np.int64) << DL_BITS) | dl_of).astype(np.int32)
    # rows align to 128 lanes only; windows align DOWN to the 1024 tile
    # and the kernel masks the spilled prefix positionally (skip)
    a_starts, a_docs, a_packed = align_csr_rows(
        pb.starts, pb.doc_ids, packed, margin=MAX_L, alignment=LANES)
    return AlignedPostings((a_starts[:-1] // LANES).astype(np.int64),
                           np.diff(pb.starts).astype(np.int64),
                           torch.from_numpy(a_docs).to(device),
                           torch.from_numpy(a_packed).to(device))


class FastSpec:
    """A search the dense fast path serves: one BM25 term group."""

    __slots__ = ("lt", "window")

    def __init__(self, lt: C.LTerms, window: int):
        self.lt = lt
        self.window = window


def make_spec(lroot: C.LNode, window: int) -> FastSpec:
    """-> FastSpec for a term-group plan, else NotPortedError."""
    if window > MAX_K:
        raise NotPortedError(f"from + size > {MAX_K}")
    if not isinstance(lroot, C.LTerms):
        raise NotPortedError(f"plan [{type(lroot).__name__}]")
    if next_pow2(len(lroot.terms), floor=1) > MAX_T:
        raise NotPortedError(f"a term group of more than {MAX_T} terms")
    return FastSpec(lroot, window)


class _VQuery:
    """The kernel rows of one query over one segment: 1 row, or one row
    per doc-range chunk. Row arrays are [n, T_pad]; dlo/dhi are [n]."""

    __slots__ = ("T_pad", "L", "rowstarts", "nrows", "lens", "skips",
                 "weights", "msm", "avgdl", "dlo", "dhi", "k1", "b_eff",
                 "field")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)

    @property
    def n(self) -> int:
        return self.rowstarts.shape[0]


def _pow2_rows(n: np.ndarray, floor: int) -> np.ndarray:
    """Vectorized next_pow2 over row counts."""
    n = np.maximum(n, floor)
    return np.left_shift(1, np.ceil(np.log2(n)).astype(np.int64))


def _chunk_slots(slots: List[Optional[Tuple[np.ndarray, int]]], ndocs: int,
                 T_total: int, nchunk: int = 2) -> Optional[tuple]:
    """Split a query whose slot windows exceed the per-slot budget into
    doc-range chunks: uniform doc-id edges, verified against the exact
    per-(slot, chunk) posting counts, doubling the chunk count until every
    chunk fits. `slots[i]` = (sorted_docs, aligned_start_elem) or None for
    an absent slot. Returns (edges i64[nchunk+1], rowstarts, nrows, lens,
    skips each i32[nchunk, T_total], max_nr i64[nchunk]); None when no
    split within MAX_CHUNKS fits."""
    budget = MAX_TL // T_total        # elements per slot
    min_rows = HBM_ALIGN // LANES
    # start at the provably-needed chunk count instead of doubling up from
    # the caller's floor: a slot of L postings needs >= L/budget chunks
    max_len = max((len(s[0]) for s in slots if s is not None), default=0)
    if max_len > budget:
        nchunk = max(nchunk, next_pow2(-(-max_len // budget), floor=2))
    while nchunk <= MAX_CHUNKS:
        edges = np.linspace(0, ndocs, nchunk + 1).astype(np.int64)
        edges[-1] = np.int64(2**31 - 1)
        arrs = [np.zeros((nchunk, T_total), np.int32) for _ in range(4)]
        rowstarts, nrows, lens, skips = arrs
        max_nr = np.full(nchunk, min_rows, np.int64)
        ok = True
        for i, slot in enumerate(slots):
            if slot is None:
                continue
            seg_docs, start_el = slot
            # edges in the docs' own dtype: a mixed-dtype searchsorted
            # would first copy the whole posting row
            offs = np.searchsorted(seg_docs, edges.astype(seg_docs.dtype),
                                   "left").astype(np.int64)
            ln = offs[1:] - offs[:-1]
            here = ln > 0
            # a window starts at the 1024 tile below it; the spilled prefix
            # (which may belong to the previous row) is masked by `skip`
            abs_el = start_el + offs[:-1]
            dma_el = (abs_el // HBM_ALIGN) * HBM_ALIGN
            skip = abs_el - dma_el
            if np.any(here & (skip + ln > budget)):
                ok = False
                break
            nr = _pow2_rows((skip + ln + LANES - 1) // LANES, min_rows)
            rowstarts[here, i] = dma_el[here] // LANES
            nrows[here, i] = nr[here]
            lens[here, i] = ln[here]
            skips[here, i] = skip[here]
            max_nr = np.maximum(max_nr, np.where(here, nr, min_rows))
        if ok and not np.any(T_total * max_nr * LANES > MAX_TL):
            return edges, rowstarts, nrows, lens, skips, max_nr
        nchunk *= 2
    return None


def _prepare_vqueries(seg: Segment, ctx: C.ShardContext,
                      lts: Sequence[C.LTerms], avgdl_cache: dict,
                      device: torch.device) -> List[Optional[_VQuery]]:
    """-> per input query, its kernel rows over `seg`; None = the segment
    holds no postings of the query's field (no hits there)."""
    out: List[Optional[_VQuery]] = []
    min_rows = HBM_ALIGN // LANES
    for lt in lts:
        al = get_aligned(seg, lt.field, device)
        pb = seg.postings.get(lt.field)
        if al is None:
            out.append(None)
            continue
        nt = len(lt.terms)
        T_pad = next_pow2(nt, floor=1)
        rows = np.full(T_pad, -1, np.int64)
        for i, t in enumerate(lt.terms):
            rows[i] = pb.row(t)
        weights = np.zeros(T_pad, np.float32)
        if lt.mode == "score":
            weights[:nt] = np.asarray(lt.weights, np.float32)[:nt]
        # filter mode: zero weights, every match scores 0 in the kernel
        # and the constant boost is applied at assembly
        if lt.field not in avgdl_cache:
            avgdl_cache[lt.field] = np.float32(ctx.avgdl(lt.field))
        sim = lt.sim
        b_eff = float(sim.b) if lt.has_norms else 0.0
        common = dict(T_pad=T_pad, weights=weights[None, :],
                      msm=float(lt.msm), avgdl=avgdl_cache[lt.field],
                      k1=float(sim.k1), b_eff=b_eff, field=lt.field)

        # single-row case: every term's window fits the per-term bucket
        rowstarts = np.zeros(T_pad, np.int32)
        nrows = np.zeros(T_pad, np.int32)
        lens = np.zeros(T_pad, np.int32)
        skips = np.zeros(T_pad, np.int32)
        max_nr = min_rows
        fits = True
        for i, r in enumerate(rows):
            if r < 0:
                continue
            ln = int(al.lens[r])
            if ln == 0:
                continue
            abs_el = int(al.starts_rows[r]) * LANES
            dma_el = (abs_el // HBM_ALIGN) * HBM_ALIGN
            skip = abs_el - dma_el
            if skip + ln > MAX_L:
                fits = False
                break
            rowstarts[i] = dma_el // LANES
            nr = next_pow2((skip + ln + LANES - 1) // LANES, floor=min_rows)
            nrows[i] = nr
            lens[i] = ln
            skips[i] = skip
            max_nr = max(max_nr, nr)
        if fits and T_pad * max_nr * LANES <= MAX_TL:
            out.append(_VQuery(L=max_nr * LANES, rowstarts=rowstarts[None],
                               nrows=nrows[None], lens=lens[None],
                               skips=skips[None],
                               dlo=np.zeros(1, np.int32),
                               dhi=np.full(1, INT_MAX, np.int32), **common))
            continue

        # oversized: doc-range chunk decomposition
        slots = []
        for r in rows:
            if r < 0:
                slots.append(None)
                continue
            a, e = pb.row_slice(int(r))
            slots.append((pb.doc_ids[a:e], int(al.starts_rows[r]) * LANES))
        chunks = _chunk_slots(slots, seg.ndocs, T_pad)
        if chunks is None:
            raise NotPortedError(
                f"a query on [{lt.field}] that needs more than {MAX_CHUNKS} "
                f"doc-range chunks")
        edges, rowstarts, nrows, lens, skips, max_nr = chunks
        out.append(_VQuery(L=int(max_nr.max()) * LANES, rowstarts=rowstarts,
                           nrows=nrows, lens=lens, skips=skips,
                           dlo=edges[:-1].astype(np.int32),
                           dhi=edges[1:].astype(np.int32), **common))
    return out


def _launch_groups(seg: Segment, vqs: List[Optional[_VQuery]], K: int,
                   device: torch.device) -> list:
    """LAUNCH stage: group kernel rows by shape, enqueue one kernel per
    group, and return the pending launches without any device sync."""
    groups: dict = {}
    for vq in vqs:
        if vq is not None:
            key = (vq.field, vq.T_pad, vq.k1, vq.b_eff)
            groups.setdefault(key, []).append(vq)
    pending = []
    for (field, T_pad, k1, b_eff), gvqs in groups.items():
        al = get_aligned(seg, field, device)
        # ONE launch per group: every row rides the group's largest L
        L = max(v.L for v in gvqs)
        pending.append((gvqs, fused_bm25_topk_tfdl(
            al.d_docs, al.d_tfdl, *_launch_inputs(gvqs, device),
            T=T_pad, L=L, K=K, k1=k1, b=b_eff)))
    return pending


def _launch_inputs(gvqs: List[_VQuery], device: torch.device) -> list:
    """The kernel inputs of a group's rows (rowstarts, nrows, lens, skips,
    weights, msm, avgdl, dlo, dhi), in ONE host-to-device copy: the
    tensors are views of one buffer."""
    T_pad = gvqs[0].T_pad
    n = [v.n for v in gvqs]
    QB = sum(n)
    ints = np.concatenate([
        np.concatenate([getattr(v, a) for v in gvqs]).ravel()
        for a in ("rowstarts", "nrows", "lens", "skips", "dlo", "dhi")])
    floats = np.concatenate([
        np.concatenate([np.broadcast_to(v.weights, (v.n, T_pad))
                        for v in gvqs]).ravel(),
        np.repeat([v.msm for v in gvqs], n).astype(np.float32),
        np.repeat([v.avgdl for v in gvqs], n).astype(np.float32)])
    buf = torch.from_numpy(np.concatenate(
        [ints.astype(np.int32), floats.view(np.int32)])).to(device)
    QT = QB * T_pad
    i32 = [buf[k * QT:(k + 1) * QT].view(QB, T_pad) for k in range(4)]
    dlo = buf[4 * QT:4 * QT + QB].view(QB, 1)
    dhi = buf[4 * QT + QB:4 * QT + 2 * QB].view(QB, 1)
    f32 = buf[4 * QT + 2 * QB:].view(torch.float32)
    return [*i32, f32[:QT].view(QB, T_pad), f32[QT:QT + QB].view(QB, 1),
            f32[QT + QB:].view(QB, 1), dlo, dhi]


def _fetch_groups(pending: list, K: int) -> dict:
    """FETCH stage: id(vq) -> (scores f32[n, K], docs i32[n, K], totals
    i64[n]), all groups' outputs in ONE device-to-host copy."""
    if not pending:
        return {}
    flat = []
    for _gvqs, (scores, docs, totals) in pending:
        flat += [scores[:, :K].reshape(-1).view(torch.int32),
                 docs[:, :K].reshape(-1), totals[:, 0]]
    host = torch.cat(flat).cpu().numpy()
    results = {}
    at = 0
    for gvqs, (scores, _d, _t) in pending:
        QB = scores.shape[0]
        sc = host[at:at + QB * K].view(np.float32).reshape(QB, K)
        at += QB * K
        dc = host[at:at + QB * K].reshape(QB, K)
        at += QB * K
        tot = host[at:at + QB].astype(np.int64)
        at += QB
        row = 0
        for vq in gvqs:
            results[id(vq)] = (sc[row:row + vq.n], dc[row:row + vq.n],
                               tot[row:row + vq.n])
            row += vq.n
    return results


def _assemble(vqs: List[Optional[_VQuery]], lts: Sequence[C.LTerms],
              results: dict, K: int) -> List[dict]:
    """Per-query outputs from per-kernel-row results: chunked queries merge
    their chunk top-Ks on host (score desc, doc asc, as the kernel);
    constant-score (filter mode) queries take their boost."""
    out = []
    for vq, lt in zip(vqs, lts):
        if vq is None:
            sc = np.full(0, -np.inf, np.float32)
            dc = np.full(0, -1, np.int32)
            total = 0
        else:
            sc_rows, dc_rows, tot = results[id(vq)]
            total = int(tot.sum())
            if vq.n == 1:
                sc, dc = sc_rows[0], dc_rows[0]
            else:
                sc_all = sc_rows.ravel()
                dc_all = dc_rows.ravel()
                key = np.where(dc_all >= 0, dc_all.astype(np.int64),
                               np.int64(np.iinfo(np.int64).max))
                order = np.lexsort((key, -sc_all))[:K]
                sc, dc = sc_all[order], dc_all[order]
        if lt.mode == "filter":
            sc = np.where(np.isfinite(sc), np.float32(lt.boost),
                          sc).astype(np.float32)
        ms = (float(sc[0]) if total > 0 and len(sc) and np.isfinite(sc[0])
              else -np.inf)
        out.append({"topk_idx": dc, "topk_scores": sc, "total": total,
                    "max_score": ms})
    return out


class LaunchHandle:
    """Launched kernel rows of a batch over one segment; `fetch()` syncs
    them and returns the per-spec result dicts."""

    def __init__(self, vqs, lts, pending, K):
        self._vqs, self._lts, self._pending, self._K = vqs, lts, pending, K

    def fetch(self) -> List[dict]:
        return _assemble(self._vqs, self._lts,
                         _fetch_groups(self._pending, self._K), self._K)


def launch_batch(seg: Segment, ctx: C.ShardContext,
                 specs: Sequence[FastSpec], k: int,
                 device: torch.device) -> LaunchHandle:
    """LAUNCH stage of the batched kernel path: many FastSpecs over ONE
    segment in as few kernel launches as possible."""
    if seg.live_count != seg.ndocs:
        raise NotPortedError(f"search over segment [{seg.name}] with "
                             f"deleted docs")
    K = min(next_pow2(max(k, 16)), MAX_K)
    lts = [s.lt for s in specs]
    vqs = _prepare_vqueries(seg, ctx, lts, {}, device)
    return LaunchHandle(vqs, lts, _launch_groups(seg, vqs, K, device), K)


def batch_search(seg: Segment, ctx: C.ShardContext,
                 specs: Sequence[FastSpec], k: int,
                 device: torch.device) -> List[dict]:
    """Synchronous batched kernel path: `launch_batch(...).fetch()`."""
    return launch_batch(seg, ctx, specs, k, device).fetch()
