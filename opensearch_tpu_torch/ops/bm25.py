"""Fused BM25 top-k over aligned CSR postings: the counterpart of
opensearch_tpu/ops/pallas_bm25.py (`fused_bm25_topk_tfdl`,
`fused_bm25_topk_impact`, `fused_bm25_bool_topk`, `fused_bm25_topk`,
`align_csr_rows` and the layout constants).

Every kernel takes one kernel row per query (or per doc-range chunk, or per
impact-head form of a query). Each row names up to T slot windows in the
aligned CSR buffers, and the function returns the row's top-K docs by
(score desc, doc asc), padded with -inf/-1 to 128 lanes, plus the exact
count of docs that pass the row's minimum-should-match (its threshold).
`fused_bm25_topk_tfdl` scores exact f32 BM25 from packed (tf, dl);
`fused_bm25_topk_impact` scores `w * f32(imp)` from a codec-v2 quantized
impact plane, one multiply per posting; `fused_bm25_bool_topk` is the
tf.dl kernel with per-slot count weights against a threshold and an
optional filter, either a slot read from its own doc list or a probe of
the filter's bitmap (`pack_bits`); `fused_bm25_topk` scores `w * norm`
over precomputed f32 norms in fixed-L windows.

On a CUDA tensor each wrapper launches its hand-written kernel
(`csrc/bm25_tfdl.cu`, `csrc/bm25_impact.cu`, `csrc/bm25_bool.cu`,
`csrc/bm25_norms.cu`, all on the row machinery of `csrc/bm25_rows.cuh`);
on a CPU tensor it runs its `_plain` version, the plain PyTorch version of
the same function. Nothing else selects between them. A launch of fewer
rows than the card holds blocks splits each row into `split_rows(...)`
doc sub-ranges, one block each, merged inside the launch. The kernels'
counters and partials live in a workspace kept per (device, stream); each
launch leaves its counters zero, so nothing is set before a launch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import load_library

INT_SENTINEL = np.int32(2**31 - 1)
LANES = 128
# CSR windows start at 1024-element tiles below the window (a TPU DMA rule
# kept so the host planner's rowstarts/nrows/skips are the reference's)
HBM_ALIGN = 1024
NEG_INF = float("-inf")

# tf and doc length packed losslessly into one i32 per posting:
#   packed = tf << DL_BITS | dl    (tf < 2^TF_BITS, dl < 2^DL_BITS)
TF_BITS = 11
DL_BITS = 21
DL_MASK = (1 << DL_BITS) - 1
TF_MAX = (1 << TF_BITS) - 1
DL_MAX = DL_MASK

# count weight of a required bool slot (and of the filter slot): larger
# than any sum of optional weights, so `thresh = REQ_W * n_required +
# fam_msm` demands every required slot and fam_msm family slots
REQ_W = 1024.0
INT_MIN = -(2**31)

# the row machinery's tile (csrc/bm25_rows.cuh kTile), the most doc
# sub-ranges a row is split into, and the kernel's symbol
TILE = 2048
MAX_SPLIT = 32
KERNEL_NAME = "rows_tile_kernel"

# Calls made through each route since the last reset_counts(): "launches"
# counts fused_bm25_topk_tfdl kernel launches (one per launch, nowhere
# else) and "rows" the kernel rows they scored; "impact_launches" and
# "impact_rows" the same for fused_bm25_topk_impact, "bool_launches" and
# "bool_rows" for fused_bm25_bool_topk, "norms_launches" and "norms_rows"
# for fused_bm25_topk; "plain_calls" the CPU-tensor calls of any wrapper
# that ran the plain version instead.
COUNTS = {"launches": 0, "rows": 0, "impact_launches": 0, "impact_rows": 0,
          "bool_launches": 0, "bool_rows": 0, "norms_launches": 0,
          "norms_rows": 0, "plain_calls": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def align_csr_rows(starts: np.ndarray, doc_ids: np.ndarray, *vals: np.ndarray,
                   margin: int, alignment: int = HBM_ALIGN):
    """Re-pack CSR postings so every row begins at an `alignment`-aligned
    offset (sentinel-padded gaps), with `margin` sentinel slack at the end
    so a fixed-size window never runs off the buffer. Returns (new_starts
    i64[nrows+1], docs, *aligned vals); each `vals` array is scattered to
    the same layout with zero fill."""
    nrows = len(starts) - 1
    lens = np.diff(starts)
    aligned_lens = ((lens + alignment - 1) // alignment) * alignment
    new_starts = np.zeros(nrows + 1, dtype=np.int64)
    np.cumsum(aligned_lens, out=new_starts[1:])
    total = int(new_starts[-1]) + margin
    total = ((total + LANES - 1) // LANES) * LANES
    new_docs = np.full(total, INT_SENTINEL, dtype=np.int32)
    # every posting moves by its row's shift (aligned start - old start)
    shift = np.repeat(new_starts[:-1] - starts[:-1], lens)
    dst = np.arange(len(doc_ids), dtype=np.int64) + shift
    new_docs[dst] = doc_ids
    out_vals = []
    for v in vals:
        nv = np.zeros(total, dtype=v.dtype)
        nv[dst] = v
        out_vals.append(nv)
    return (new_starts, new_docs, *out_vals)


def _check_sizes(T: int, L: int, K: int, slot_name: str = "T") -> None:
    if not (T in (1, 2, 4, 8)):
        raise ValueError(f"{slot_name} must be 1, 2, 4 or 8, got {T}")
    if L < 1 or L & (L - 1) or L % LANES:
        raise ValueError(f"L must be a power of two multiple of {LANES}, "
                         f"got {L}")
    if not 1 <= K <= LANES:
        raise ValueError(f"K must be in [1, {LANES}], got {K}")


def _check_tensors(dev, shapes: dict) -> None:
    """Each `name: (tensor, dtype, shape or None)` on `dev`, contiguous."""
    for name, (t, dtype, shape) in shapes.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, docs on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")


def _check_postings(docs, vals, vals_name: str) -> None:
    if docs.dim() != 1 or tuple(vals.shape) != tuple(docs.shape) \
            or docs.shape[0] % LANES:
        raise ValueError(f"docs and {vals_name} must be i32[P] with P a "
                         f"multiple of {LANES}")


def _check_inputs(docs, vals, rowstarts, nrows, lens, skips, weights, msm,
                  avgdl, dlo, dhi, T, L, K, vals_name="tfdl",
                  vals_dtype=torch.int32):
    _check_sizes(T, L, K)
    QB = rowstarts.shape[0]
    shapes = {"docs": (docs, torch.int32, None),
              vals_name: (vals, vals_dtype, None),
              "rowstarts": (rowstarts, torch.int32, (QB, T)),
              "nrows": (nrows, torch.int32, (QB, T)),
              "lens": (lens, torch.int32, (QB, T)),
              "skips": (skips, torch.int32, (QB, T)),
              "weights": (weights, torch.float32, (QB, T)),
              "msm": (msm, torch.float32, (QB, 1)),
              "dlo": (dlo, torch.int32, (QB, 1)),
              "dhi": (dhi, torch.int32, (QB, 1))}
    if avgdl is not None:
        shapes["avgdl"] = (avgdl, torch.float32, (QB, 1))
    _check_tensors(docs.device, shapes)
    _check_postings(docs, vals, vals_name)


def fused_bm25_topk_tfdl(docs: torch.Tensor, tfdl: torch.Tensor,
                         rowstarts: torch.Tensor, nrows: torch.Tensor,
                         lens: torch.Tensor, skips: torch.Tensor,
                         weights: torch.Tensor, msm: torch.Tensor,
                         avgdl: torch.Tensor, dlo: torch.Tensor,
                         dhi: torch.Tensor, T: int, L: int, K: int,
                         k1: float, b: float):
    """Batched fused BM25 top-k over packed (tf, dl) postings.

    docs      i32[P] - doc ids, CSR-flat, rows 128-lane aligned
    tfdl      i32[P] - tf << DL_BITS | dl per posting
    rowstarts i32[QB, T] - window starts in 128-lane row units
    nrows     i32[QB, T] - pow2 rows in each window (0 = absent term)
    lens      i32[QB, T] - true posting counts of the windows
    skips     i32[QB, T] - spilled-in prefix before each window's postings
    weights   f32[QB, T] - query-time idf * boost
    msm       f32[QB, 1] - minimum matching terms
    avgdl     f32[QB, 1] - average doc length
    dlo/dhi   i32[QB, 1] - doc-id range [dlo, dhi) of the row
    T, L, K   slots (1, 2, 4, 8), window size (pow2), top-k (<= 128)
    k1, b     similarity parameters (b already 0 when norms are off)

    Slot t of row q covers positions [skips, skips + lens) of the window
    at element rowstarts * 128, cut to [0, nrows * 128) and [0, L).
    Returns (scores f32[QB, 128], doc_ids i32[QB, 128], totals i32[QB, 128]).
    """
    _check_inputs(docs, tfdl, rowstarts, nrows, lens, skips, weights, msm,
                  avgdl, dlo, dhi, T, L, K)
    if docs.device.type == "cpu":
        COUNTS["plain_calls"] += 1
        return fused_bm25_topk_tfdl_plain(docs, tfdl, rowstarts, nrows, lens,
                                          skips, weights, msm, avgdl, dlo,
                                          dhi, T, L, K, k1, b)
    return _launch("bm25_tfdl", docs.device, rowstarts.shape[0], T, L, K,
                   lambda lib, split, part, grid, out, stream:
                   lib.bm25_tfdl_launch(
                       docs.data_ptr(), tfdl.data_ptr(), docs.shape[0],
                       rowstarts.data_ptr(), nrows.data_ptr(),
                       lens.data_ptr(), skips.data_ptr(),
                       weights.data_ptr(), msm.data_ptr(), avgdl.data_ptr(),
                       dlo.data_ptr(), dhi.data_ptr(),
                       rowstarts.shape[0], T, L, K, float(k1), float(b),
                       float(np.float32(1.0 - b)), split, *part, grid,
                       *out, stream),
                   ("launches", "rows"))


def fused_bm25_topk_impact(docs: torch.Tensor, imp: torch.Tensor,
                           rowstarts: torch.Tensor, nrows: torch.Tensor,
                           lens: torch.Tensor, skips: torch.Tensor,
                           weights: torch.Tensor, msm: torch.Tensor,
                           dlo: torch.Tensor, dhi: torch.Tensor,
                           T: int, L: int, K: int):
    """Batched fused top-k over codec-v2 quantized impacts.

    docs      i32[P] - doc ids, CSR-flat, rows 128-lane aligned
    imp       i32[P] - quantized impact per posting (u8/u16 widened)
    weights   f32[QB, T] - idf * boost * plane scale, folded on the host
    (rowstarts/nrows/lens/skips/msm/dlo/dhi as in fused_bm25_topk_tfdl.)
    Each valid posting contributes `weights * f32(imp)`, one f32 multiply;
    no similarity parameters. Returns (scores f32[QB, 128],
    doc_ids i32[QB, 128], totals i32[QB, 128]).
    """
    _check_inputs(docs, imp, rowstarts, nrows, lens, skips, weights, msm,
                  None, dlo, dhi, T, L, K, vals_name="imp")
    if docs.device.type == "cpu":
        COUNTS["plain_calls"] += 1
        return fused_bm25_topk_impact_plain(docs, imp, rowstarts, nrows,
                                            lens, skips, weights, msm, dlo,
                                            dhi, T, L, K)
    return _launch("bm25_impact", docs.device, rowstarts.shape[0], T, L, K,
                   lambda lib, split, part, grid, out, stream:
                   lib.bm25_impact_launch(
                       docs.data_ptr(), imp.data_ptr(), docs.shape[0],
                       rowstarts.data_ptr(), nrows.data_ptr(),
                       lens.data_ptr(), skips.data_ptr(),
                       weights.data_ptr(), msm.data_ptr(), dlo.data_ptr(),
                       dhi.data_ptr(), rowstarts.shape[0], T, L, K,
                       split, *part, grid, *out, stream),
                   ("impact_launches", "impact_rows"))


def fused_bm25_bool_topk(docs: torch.Tensor, tfdl: torch.Tensor,
                         filt: torch.Tensor, rowstarts: torch.Tensor,
                         nrows: torch.Tensor, lens: torch.Tensor,
                         skips: torch.Tensor, weights: torch.Tensor,
                         cw: torch.Tensor, thresh: torch.Tensor,
                         avgdl: torch.Tensor, dlo: torch.Tensor,
                         dhi: torch.Tensor, TS: int, L: int, K: int,
                         k1: float, b: float, filtered: bool,
                         probe: bool = False):
    """Batched fused bool/filtered BM25 top-k over packed (tf, dl) postings.

    docs, tfdl i32[P] - as in fused_bm25_topk_tfdl
    filt      list form: i32[Pf] filter doc lists, sorted runs, sentinel
              padded (read only when `filtered`; Pf a multiple of 128);
              probe form: the filter's bitmap, `pack_bits(mask)`
    rowstarts, nrows, lens, skips i32[QB, T] - slot windows; slots
              [0, TS) index docs/tfdl, slot TS (list form) indexes filt,
              slots (TS, 2 TS) are dead (nrows 0)
    weights   f32[QB, TS] - term weights (idf * boost)
    cw        f32[QB, T] - count weight per slot (REQ_W required, 1 family,
              0 bonus or dead); probe form f32[QB, TS + 1], the last
              column the filter's
    thresh    f32[QB, 1] - a doc passes iff its summed cw >= thresh
    avgdl     f32[QB, 1]; dlo/dhi i32[QB, 1] - as in fused_bm25_topk_tfdl
    TS, L, K  term slots (1, 2, 4, 8), window size (pow2), top-k (<= 128);
              T = 2 TS in list form, else TS
    k1, b     similarity parameters (b already 0 when norms are off)
    filtered  the rows carry a filter; `probe` in its probe form

    The filter is the last slot in slot order: it contributes score 0 and
    its count weight. In probe form a doc's bit stands for its filter
    posting, so docs of the filter alone never pass: the two forms agree
    on rows whose threshold exceeds the filter's count weight. Returns
    (scores f32[QB, 128], doc_ids i32[QB, 128], totals i32[QB, 128]).
    """
    if probe and not filtered:
        raise ValueError("probe needs filtered")
    T = 2 * TS if filtered and not probe else TS
    _check_sizes(TS, L, K, "TS")
    QB = rowstarts.shape[0]
    shapes = {"docs": (docs, torch.int32, None),
              "tfdl": (tfdl, torch.int32, None),
              "filt": (filt, torch.int32, None)}
    for name, t in (("rowstarts", rowstarts), ("nrows", nrows),
                    ("lens", lens), ("skips", skips)):
        shapes[name] = (t, torch.int32, (QB, T))
    shapes.update({"weights": (weights, torch.float32, (QB, TS)),
                   "cw": (cw, torch.float32, (QB, T + probe)),
                   "thresh": (thresh, torch.float32, (QB, 1)),
                   "avgdl": (avgdl, torch.float32, (QB, 1)),
                   "dlo": (dlo, torch.int32, (QB, 1)),
                   "dhi": (dhi, torch.int32, (QB, 1))})
    _check_tensors(docs.device, shapes)
    _check_postings(docs, tfdl, "tfdl")
    if filt.dim() != 1 or (not probe and filt.shape[0] % LANES):
        raise ValueError(f"filt must be i32[Pf] with Pf a multiple of "
                         f"{LANES} (a bitmap i32[W] in probe form)")
    if docs.device.type == "cpu":
        COUNTS["plain_calls"] += 1
        return fused_bm25_bool_topk_plain(docs, tfdl, filt, rowstarts, nrows,
                                          lens, skips, weights, cw, thresh,
                                          avgdl, dlo, dhi, TS, L, K, k1, b,
                                          filtered, probe)
    slot = filtered and not probe
    return _launch("bm25_bool", docs.device, QB, T, L, K,
                   lambda lib, split, part, grid, out, stream:
                   lib.bm25_bool_launch(
                       docs.data_ptr(), tfdl.data_ptr(), docs.shape[0],
                       filt.data_ptr() if slot else None, filt.shape[0],
                       filt.data_ptr() if probe else None, filt.shape[0],
                       rowstarts.data_ptr(), nrows.data_ptr(),
                       lens.data_ptr(), skips.data_ptr(),
                       weights.data_ptr(), cw.data_ptr(), thresh.data_ptr(),
                       avgdl.data_ptr(), dlo.data_ptr(), dhi.data_ptr(),
                       QB, TS, T, L, K, float(k1), float(b),
                       float(np.float32(1.0 - b)), split, *part, grid,
                       *out, stream),
                   ("bool_launches", "bool_rows"))


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """The bitmap of a bool[n] mask on its device: i32[ceil(n / 32)], bit
    d & 31 of word d >> 5 set iff mask[d] (the probe form's filter)."""
    n = mask.shape[0]
    nw = (n + 31) // 32
    bits = torch.zeros(nw * 32, dtype=torch.int64, device=mask.device)
    bits[:n] = mask
    shift = torch.arange(32, dtype=torch.int64, device=mask.device)
    words = (bits.view(nw, 32) << shift).sum(dim=1)
    # words >= 2^31 as their two's-complement i32
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def fused_bm25_topk(docs: torch.Tensor, norms: torch.Tensor,
                    starts: torch.Tensor, lens: torch.Tensor,
                    weights: torch.Tensor, msm: torch.Tensor,
                    T: int, L: int, K: int):
    """Batched fused top-k over precomputed per-posting f32 norms.

    docs      i32[P] - doc ids, CSR-flat, rows 128-aligned, >= L tail margin
    norms     f32[P] - per-posting eager impacts tf / (tf + K_d)
    starts    i32[QB, T] - 128-aligned element starts of the windows
    lens      i32[QB, T] - postings of each window (0 = absent term)
    weights   f32[QB, T] - query-time idf * boost
    msm       f32[QB, 1] - minimum matching terms
    Each window is the L elements at its start; its first `lens` postings
    are valid and contribute `weights * norm`. No caller in the package
    uses it. Returns (scores f32[QB, 128], doc_ids i32[QB, 128],
    totals i32[QB, 128]).
    """
    _check_sizes(T, L, K)
    QB = starts.shape[0]
    _check_tensors(docs.device, {
        "docs": (docs, torch.int32, None),
        "norms": (norms, torch.float32, None),
        "starts": (starts, torch.int32, (QB, T)),
        "lens": (lens, torch.int32, (QB, T)),
        "weights": (weights, torch.float32, (QB, T)),
        "msm": (msm, torch.float32, (QB, 1))})
    _check_postings(docs, norms, "norms")
    if docs.device.type == "cpu":
        COUNTS["plain_calls"] += 1
        return fused_bm25_topk_plain(docs, norms, starts, lens, weights, msm,
                                     T, L, K)
    return _launch("bm25_norms", docs.device, QB, T, L, K,
                   lambda lib, split, part, grid, out, stream:
                   lib.bm25_norms_launch(
                       docs.data_ptr(), norms.data_ptr(), docs.shape[0],
                       starts.data_ptr(), lens.data_ptr(),
                       weights.data_ptr(), msm.data_ptr(), QB, T, L, K,
                       split, *part, grid, *out, stream),
                   ("norms_launches", "norms_rows"))


def _window_rows(starts: torch.Tensor, L: int) -> tuple:
    """fused_bm25_topk's fixed-L windows as rows of the general plain
    version: (rowstarts = starts / 128, nrows = L / 128, skips = 0, dlo =
    INT_MIN, dhi = INT_MAX) on the device of `starts` (the kernel reads
    the windows as they are)."""
    QB, T = starts.shape
    dev = starts.device
    return (torch.div(starts, LANES, rounding_mode="floor"),
            torch.full((QB, T), L // LANES, dtype=torch.int32, device=dev),
            torch.zeros((QB, T), dtype=torch.int32, device=dev),
            torch.full((QB, 1), INT_MIN, dtype=torch.int32, device=dev),
            torch.full((QB, 1), int(INT_SENTINEL), dtype=torch.int32,
                       device=dev))


def fused_bm25_topk_plain(docs, norms, starts, lens, weights, msm, T: int,
                          L: int, K: int):
    """The plain PyTorch version of `fused_bm25_topk` (same signature, same
    results bit for bit): the windows mapped to rows as the wrapper maps
    them, each valid posting scored `weights * norm`."""
    rs, nr, sk, dlo, dhi = _window_rows(starts, L)
    return _plain(docs, norms, rs, nr, lens, sk, weights, msm, dlo, dhi, T,
                  L, K, lambda p, w, _rows: w * p)


def split_rows(QB: int, T: int, L: int, resident: int) -> int:
    """Doc sub-ranges per row of a launch: the largest power of two S <=
    MAX_SPLIT with QB * S within the resident grid and a row's T * L
    window elements at least a tile per sub-range."""
    S = 1
    while (S < MAX_SPLIT and QB * 2 * S <= resident
           and T * L >= 2 * S * TILE):
        S *= 2
    return S


def _launch(name: str, dev: torch.device, QB: int, T: int, L: int, K: int,
            call, counts: tuple):
    """Launch library `name`'s kernel on the card: the outputs (three
    views of one allocation), the split and its [QB, S, K] partials and
    the counters (per-row arrivals, the work-item counter of the
    persistent grid, the blocks that left it) from the stream's workspace,
    the error check, and the launch/row counts (`counts` names the two
    COUNTS keys)."""
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((3, QB, LANES), dtype=torch.int32, device=dev)
    scores, ids, totals = out[0].view(torch.float32), out[1], out[2]
    if QB == 0:
        return scores, ids, totals
    with torch.cuda.device(dev):
        lib = load_library(name)
        resident = resident_blocks(name, dev)
        S = split_rows(QB, T, L, resident)
        stream = torch.cuda.current_stream(dev).cuda_stream
        counters, part = _workspace(dev, stream, QB + 2,
                                    QB * S * K if S > 1 else 0, QB * S)
        grid = min(QB * S, resident)
        err = call(lib, S, part + (counters.data_ptr(),), grid,
                   (scores.data_ptr(), ids.data_ptr(), totals.data_ptr()),
                   stream)
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")
    COUNTS[counts[0]] += 1
    COUNTS[counts[1]] += QB
    return scores, ids, totals


# (device index, stream) -> (counters i32, partials i32): the kernels'
# workspace, grown on demand. The counters are zero between launches (each
# launch resets what it used); a launch on the same stream reuses both
# after the previous one ends.
_WORKSPACE: dict = {}


def _workspace(dev: torch.device, stream: int, n_counters: int, n_part: int,
               n_tot: int) -> tuple:
    """(counters, (part_s, part_d, part_tot) pointers, None without a
    split) of the (device, stream) workspace, at least this large."""
    key = (dev.index, stream)
    counters, part = _WORKSPACE.get(key, (None, None))
    if counters is None or counters.numel() < n_counters:
        size = max(n_counters, 2 * (0 if counters is None
                                    else counters.numel()))
        counters = torch.zeros(size, dtype=torch.int32, device=dev)
    need = 2 * n_part + n_tot if n_part else 0
    if part is None or part.numel() < need:
        size = max(need, 2 * (0 if part is None else part.numel()), 1)
        part = torch.empty(size, dtype=torch.int32, device=dev)
    _WORKSPACE[key] = (counters, part)
    if not n_part:
        return counters, (None, None, None)
    at = part.data_ptr()
    return counters, (at, at + 4 * n_part, at + 8 * n_part)


_RESIDENT: dict = {}


def _occupancy(name: str, dev: torch.device) -> tuple:
    key = (name, dev.index)
    if key not in _RESIDENT:
        out, smem = ctypes.c_int(0), ctypes.c_int(0)
        err = getattr(load_library(name), f"{name}_resident_blocks")(
            ctypes.byref(out), ctypes.byref(smem))
        if err != 0:
            raise RuntimeError(f"{name} occupancy query failed: CUDA "
                               f"error {err}")
        _RESIDENT[key] = (max(int(out.value), 1), int(smem.value))
    return _RESIDENT[key]


def resident_blocks(name: str, dev: torch.device) -> int:
    """Blocks of library `name`'s kernel that fit on the card at once (SMs
    x blocks per SM at its dynamic shared memory): the grid of the
    persistent launch, cached per (library, device)."""
    return _occupancy(name, dev)[0]


def smem_bytes(name: str, dev: torch.device) -> int:
    """Dynamic shared memory of one block of library `name`'s kernel."""
    return _occupancy(name, dev)[1]


# rows per plain-version block: bounds its [rows, T, L] temporaries
_PLAIN_ELEMS = 1 << 22


def fused_bm25_topk_tfdl_plain(docs, tfdl, rowstarts, nrows, lens, skips,
                               weights, msm, avgdl, dlo, dhi, T: int, L: int,
                               K: int, k1: float, b: float):
    """The plain PyTorch version of `fused_bm25_topk_tfdl` (same signature,
    same results bit for bit): gather each slot's window, score every
    valid posting with the same f32 expression, stable-sort by doc
    (slot-major input, so a doc's postings stay in slot order), sum each
    doc's run in slot order with shifted adds, apply msm, count, and take
    the top K by (score desc, doc asc) with two stable sorts."""
    from .scoring import posting_contrib

    def contrib(p, w, rows):
        # mask after the arithmetic shift: tf >= 1024 sets the sign bit
        tf = ((p >> DL_BITS) & TF_MAX).to(torch.float32)
        dl = (p & DL_MASK).to(torch.float32)
        return posting_contrib(tf, dl, w, k1, b, avgdl[rows][:, :, None])

    return _plain(docs, tfdl, rowstarts, nrows, lens, skips, weights, msm,
                  dlo, dhi, T, L, K, contrib)


def fused_bm25_topk_impact_plain(docs, imp, rowstarts, nrows, lens, skips,
                                 weights, msm, dlo, dhi, T: int, L: int,
                                 K: int):
    """The plain PyTorch version of `fused_bm25_topk_impact` (same
    signature, same results bit for bit): as the tf.dl plain version, with
    each valid posting's contribution `weights * f32(imp)`."""
    return _plain(docs, imp, rowstarts, nrows, lens, skips, weights, msm,
                  dlo, dhi, T, L, K,
                  lambda p, w, rows: w * p.to(torch.float32))


def fused_bm25_bool_topk_plain(docs, tfdl, filt, rowstarts, nrows, lens,
                               skips, weights, cw, thresh, avgdl, dlo, dhi,
                               TS: int, L: int, K: int, k1: float, b: float,
                               filtered: bool, probe: bool = False):
    """The plain PyTorch version of `fused_bm25_bool_topk` (same
    signature, same results bit for bit): as the tf.dl plain version, with
    the term weights padded to T slots, the filter slot's docs gathered
    from `filt` and scored 0.0 without a decode, and each doc's count
    weights summed in slot order against `thresh`; in probe form each
    doc's bit gathered from the bitmap and, where set, its count weight
    and 0.0 added last."""
    from .scoring import posting_contrib

    T = 2 * TS if filtered and not probe else TS
    if T > TS:
        weights = torch.cat([weights, torch.zeros_like(weights)], dim=1)

    def contrib(p, w, rows):
        tf = ((p >> DL_BITS) & TF_MAX).to(torch.float32)
        dl = (p & DL_MASK).to(torch.float32)
        return posting_contrib(tf, dl, w, k1, b, avgdl[rows][:, :, None])

    if probe:
        return _plain(docs, tfdl, rowstarts, nrows, lens, skips, weights,
                      thresh, dlo, dhi, T, L, K, contrib, cw=cw[:, :TS],
                      bits=filt, cwf=cw[:, TS:])
    return _plain(docs, tfdl, rowstarts, nrows, lens, skips, weights, thresh,
                  dlo, dhi, T, L, K, contrib, cw=cw,
                  filt=filt if filtered else None, TS=TS)


def _plain(docs, vals, rowstarts, nrows, lens, skips, weights, msm, dlo,
           dhi, T: int, L: int, K: int, contrib, cw=None, filt=None,
           TS: int = 0, bits=None, cwf=None):
    """Row blocks of the plain version; `contrib(vals_window f32/i32[n, T,
    L], weights f32[n, T, 1], rows slice)` scores the gathered postings.
    `cw` f32[QB, T] count weights (None: 1 per slot); `filt` the filter
    doc lists that slot TS reads (None: no filter slot); `bits` the probed
    filter's bitmap and `cwf` f32[QB, 1] its count weight (None: no
    probe)."""
    QB = rowstarts.shape[0]
    step = max(1, _PLAIN_ELEMS // (T * L))
    parts = [_plain_rows(docs, vals, rowstarts[i:i + step],
                         nrows[i:i + step], lens[i:i + step],
                         skips[i:i + step], weights[i:i + step],
                         msm[i:i + step], dlo[i:i + step], dhi[i:i + step],
                         T, L, K,
                         lambda p, w, _i=i: contrib(p, w,
                                                    slice(_i, _i + step)),
                         None if cw is None else cw[i:i + step], filt, TS,
                         None if bits is None else (bits, cwf[i:i + step]))
             for i in range(0, QB, step)]
    if not parts:
        dev = docs.device
        return (torch.empty((0, LANES), dtype=torch.float32, device=dev),
                torch.empty((0, LANES), dtype=torch.int32, device=dev),
                torch.empty((0, LANES), dtype=torch.int32, device=dev))
    return tuple(torch.cat([p[i] for p in parts]) for i in range(3))


def _plain_rows(docs, vals, rowstarts, nrows, lens, skips, weights, msm,
                dlo, dhi, T, L, K, contrib, cw, filt, TS, probe):
    dev = docs.device
    QB = rowstarts.shape[0]
    P = docs.shape[0]
    pos = torch.arange(L, dtype=torch.int64, device=dev)
    start = rowstarts.long()[:, :, None] * LANES
    sk = skips.long()[:, :, None]
    hi = torch.minimum(sk + lens.long()[:, :, None],
                       nrows.long()[:, :, None] * LANES)
    at = start + pos                                   # [QB, T, L]
    if filt is None:
        in_win = (pos >= sk) & (pos < hi) & (at < P)
        at = at.clamp(max=P - 1)
        d = docs[at]
        term = in_win
    else:
        # slot TS reads its docs from `filt`, of its own length, and has
        # no payload to decode
        is_f = (torch.arange(T, device=dev) == TS)[None, :, None]
        Pf = filt.shape[0]
        in_win = (pos >= sk) & (pos < hi) & (at < torch.where(is_f, Pf, P))
        at_f = torch.where(is_f, at, 0).clamp(max=Pf - 1)
        at = torch.where(is_f, 0, at).clamp(max=P - 1)
        d = torch.where(is_f, filt[at_f], docs[at])
        term = in_win & ~is_f
    valid = in_win & (d >= dlo[:, :, None]) & (d < dhi[:, :, None])
    c = contrib(vals[at], weights[:, :, None])
    sent = int(INT_SENTINEL)
    keys = torch.where(valid, d, torch.full_like(d, sent)).reshape(QB, T * L)
    c = torch.where(valid & term, c, torch.zeros_like(c)).reshape(QB, T * L)
    w_cnt = (torch.ones_like(c) if cw is None else
             torch.where(valid, cw[:, :, None], 0.0).reshape(QB, T * L))
    keys, order = torch.sort(keys, dim=1, stable=True)
    c = torch.gather(c, 1, order)
    w_cnt = torch.gather(w_cnt, 1, order)
    n = T * L
    # a doc's run holds <= T postings, in slot order; the run's first
    # element accumulates the rest left to right
    acc = c.clone()
    cnt = w_cnt.clone()
    for s in range(1, T):
        same = torch.zeros_like(keys, dtype=torch.bool)
        same[:, :n - s] = keys[:, s:] == keys[:, :n - s]
        nxt = torch.zeros_like(c)
        nxt[:, :n - s] = c[:, s:]
        acc = torch.where(same, acc + nxt, acc)
        nxt_cnt = torch.zeros_like(c)
        nxt_cnt[:, :n - s] = w_cnt[:, s:]
        cnt = torch.where(same, cnt + nxt_cnt, cnt)
    if probe is not None:
        # the probed filter as the last slot: where the doc's bit is set,
        # its count weight and 0.0 (a -0.0 sum becomes +0.0)
        bits, cwf = probe
        word = (keys >> 5).long()
        inside = (keys >= 0) & (word < bits.shape[0])
        bit = (bits[word.clamp(0, bits.shape[0] - 1)] >> (keys & 31)) & 1
        hit = inside & (bit == 1)
        cnt = torch.where(hit, cnt + cwf, cnt)
        acc = torch.where(hit, acc + 0.0, acc)
    first = torch.ones_like(keys, dtype=torch.bool)
    first[:, 1:] = keys[:, 1:] != keys[:, :-1]
    passed = first & (keys != sent) & (cnt >= msm)
    final = torch.where(passed, acc, torch.full_like(acc, NEG_INF))
    total = passed.sum(dim=1, dtype=torch.int32)
    # keys are doc-ascending, so a stable sort on -score breaks ties by doc
    _, top = torch.sort(-final, dim=1, stable=True)
    top = top[:, :K]
    sc = torch.gather(final, 1, top)
    ids = torch.where(sc > NEG_INF, torch.gather(keys, 1, top),
                      torch.full_like(top, -1, dtype=torch.int32))
    scores = torch.full((QB, LANES), NEG_INF, dtype=torch.float32,
                        device=dev)
    out_ids = torch.full((QB, LANES), -1, dtype=torch.int32, device=dev)
    scores[:, :K] = sc
    out_ids[:, :K] = ids.to(torch.int32)
    return scores, out_ids, total[:, None].expand(QB, LANES).contiguous()
