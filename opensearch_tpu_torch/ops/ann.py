"""Balanced IVF-flat for approximate kNN (the port of
opensearch_tpu/ops/ann.py), as torch ops on the matrix's device.

Build: Lloyd k-means over blocks of BLOCK rows in f32 (each block's
assignment one [BLOCK, dims] x [dims, nlist] product, the centroid update
a scatter-add whose absent rows fall into a dropped last slot), then the
top-2 assignment on the device, then the reference's vectorized host
fill, which caps every list at `cap` rows: rows claim their nearest list
closest-first, the overflow spills to its second-nearest list, and what
is left fills the open slots in order. `lists` is a dense i32[nlist, cap]
matrix padded with -1, so a probe is one gather of [nprobe, cap] rows.
Every present row sits in exactly one list: probing every list is the
exact scan. The init is the reference's seeded
`np.random.default_rng(seed).choice` of present rows, and the defaults
are its: nlist = round(sqrt(n)), cap = ceil(n * slack / nlist), nprobe =
nlist // 8.

Sums run in another order than the reference's XLA program (a matrix
product on another library; on a card, atomic adds), so a row whose two
nearest centroids lie within a few ulp of each other may land in the
other list; elsewhere the lists equal the reference's. TF32 is not
enabled here: the products are f32.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

BLOCK = 8192
# wall seconds of the last build by step: kmeans_s (the Lloyd
# iterations), assign_s (the top-2 assignment and its copy to the host),
# fill_s (the host fill)
LAST_BUILD: dict = {}


@dataclass
class IvfIndex:
    centroids: np.ndarray   # f32[nlist, dims], in the scored matrix's space
    lists: np.ndarray       # i32[nlist, cap], -1 = empty slot
    nlist: int
    cap: int
    default_nprobe: int


def _distances(v: torch.Tensor, cents: torch.Tensor,
               csq: torch.Tensor) -> torch.Tensor:
    """||v - c||^2 up to each row's own constant: ||c||^2 - 2 v.c."""
    return csq - 2.0 * (v @ cents.T)


def kmeans(mat: torch.Tensor, present: torch.Tensor, init: torch.Tensor,
           iters: int) -> torch.Tensor:
    """Lloyd iterations over `mat` f32[n, dims] (rows where `present` is
    false take no part) from `init` f32[nlist, dims]; an empty list keeps
    its centroid. -> f32[nlist, dims]."""
    cents = init.clone()
    nlist, dims = cents.shape
    for _ in range(iters):
        csq = (cents * cents).sum(1)
        sums = torch.zeros((nlist + 1, dims), dtype=torch.float32,
                           device=mat.device)
        counts = torch.zeros(nlist + 1, dtype=torch.float32,
                             device=mat.device)
        for a in range(0, mat.shape[0], BLOCK):
            v = mat[a:a + BLOCK]
            near = _distances(v, cents, csq).argmin(1)
            near = torch.where(present[a:a + BLOCK], near, nlist)
            sums.scatter_add_(0, near[:, None].expand(-1, dims), v)
            counts.index_add_(0, near, torch.ones_like(near,
                                                       dtype=torch.float32))
        sums, counts = sums[:nlist], counts[:nlist]
        newc = sums / counts.clamp_min(1.0)[:, None]
        cents = torch.where((counts > 0)[:, None], newc, cents)
    return cents


def assign_top2(mat: torch.Tensor, cents: torch.Tensor) -> tuple:
    """Each row's nearest and second-nearest list and its distance to the
    nearest (first index on ties) -> numpy (i32[n], i32[n], f32[n])."""
    csq = (cents * cents).sum(1)
    a1s, a2s, d1s = [], [], []
    for a in range(0, mat.shape[0], BLOCK):
        d2 = _distances(mat[a:a + BLOCK], cents, csq)
        a1 = d2.argmin(1)
        d1s.append(d2.gather(1, a1[:, None])[:, 0])
        d2.scatter_(1, a1[:, None], float("inf"))
        a2s.append(d2.argmin(1).to(torch.int32))
        a1s.append(a1.to(torch.int32))
    return tuple(torch.cat(x).cpu().numpy() for x in (a1s, a2s, d1s))


def balanced_fill(a1: np.ndarray, a2: np.ndarray, d1: np.ndarray,
                  pres_idx: np.ndarray, nlist: int, cap: int) -> np.ndarray:
    """The reference's host fill: i32[nlist, cap] lists, -1 padded."""
    lists = np.full((nlist, cap), -1, np.int32)
    # round 1: rows claim their nearest list, closest-first
    rows = pres_idx[np.lexsort((d1[pres_idx], a1[pres_idx]))]
    c = a1[rows]
    starts = np.searchsorted(c, np.arange(nlist))
    rank = np.arange(len(rows)) - starts[c]
    keep = rank < cap
    lists[c[keep], rank[keep]] = rows[keep]
    fill = np.bincount(c[keep], minlength=nlist).astype(np.int64)
    # round 2: the overflow goes to its second-nearest list where it fits
    spill = rows[~keep]
    if len(spill):
        c2 = a2[spill]
        order2 = np.argsort(c2, kind="stable")
        spill, c2 = spill[order2], c2[order2]
        starts2 = np.searchsorted(c2, np.arange(nlist))
        rank2 = (np.arange(len(spill)) - starts2[c2]) + fill[c2]
        keep2 = rank2 < cap
        lists[c2[keep2], rank2[keep2]] = spill[keep2]
        # round 3 (rare): whatever is left fills the open slots in order
        left = spill[~keep2]
        if len(left):
            open_slots = np.nonzero(lists.reshape(-1) == -1)[0]
            lists.reshape(-1)[open_slots[: len(left)]] = left
    return lists


def build_ivf(mat: torch.Tensor, present: np.ndarray,
              nlist: Optional[int] = None, nprobe: Optional[int] = None,
              iters: int = 8, seed: int = 0, slack: float = 1.5
              ) -> Optional[IvfIndex]:
    """The IVF index of the scored matrix `mat` f32[n, dims] (unit-normed
    for cosine, so that the lists' geometry is the search's) on its own
    device; `present` is the host mask of rows with a vector. None when
    no row has one."""
    present = np.asarray(present, bool)
    pres_idx = np.nonzero(present)[0]
    npres = len(pres_idx)
    if npres == 0:
        return None
    nlist = int(min(nlist or max(1, round(npres ** 0.5)), npres))
    cap = max(1, int(np.ceil(npres * slack / nlist)))
    default_nprobe = int(min(nprobe or max(1, nlist // 8), nlist))
    rng = np.random.default_rng(seed)
    pick = rng.choice(pres_idx, nlist, replace=False)
    init = mat[torch.from_numpy(pick).to(mat.device)]
    d_present = torch.from_numpy(present).to(mat.device)
    t0 = time.perf_counter()
    cents = kmeans(mat, d_present, init, iters)
    centroids = cents.cpu().numpy()         # waits for the iterations
    t1 = time.perf_counter()
    a1, a2, d1 = assign_top2(mat, cents)
    t2 = time.perf_counter()
    lists = balanced_fill(a1, a2, d1, pres_idx, nlist, cap)
    LAST_BUILD.clear()
    LAST_BUILD.update(kmeans_s=t1 - t0, assign_s=t2 - t1,
                      fill_s=time.perf_counter() - t2)
    return IvfIndex(centroids=centroids, lists=lists, nlist=nlist,
                    cap=cap, default_nprobe=default_nprobe)
