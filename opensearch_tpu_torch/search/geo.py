"""Geo shapes: parsing (GeoJSON + a WKT subset) and exact spatial relations.

Reference analog: `index/mapper/GeoShapeFieldMapper.java` +
`index/query/GeoShapeQueryBuilder.java`, which delegate to Lucene's BKD
tesselation. The TPU-first split here is different: per-doc bounding boxes
live in columns for a vectorized prefilter, and the EXACT relation math
(this module) runs on the host over the bbox survivors at plan-prepare
time, producing a per-(segment, query) boolean mask that is uploaded as a
plan parameter — so the device plan stays static-shape and the mask rides
the (segment, plan) filter cache like any other filter.

Coordinates are (lon, lat) internally, GeoJSON order. Dateline-crossing
shapes are not split (documents near ±180° should use two shapes);
`circle` is approximated by a 64-gon (the reference requires explicit
tesselation for circles too).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field as dc_field
from typing import List, Optional, Tuple

import numpy as np

Ring = np.ndarray          # f64[k, 2] closed implicitly (last != first ok)
Poly = Tuple[Ring, List[Ring]]   # (outer, holes)


@dataclass
class Shape:
    points: np.ndarray = None          # f64[n, 2]
    lines: List[Ring] = dc_field(default_factory=list)
    polys: List[Poly] = dc_field(default_factory=list)
    bbox: Tuple[float, float, float, float] = (0, 0, 0, 0)  # minx,miny,maxx,maxy

    def __post_init__(self):
        if self.points is None:
            self.points = np.zeros((0, 2), np.float64)

    def finish(self) -> "Shape":
        xs, ys = [], []
        for arr in ([self.points] + self.lines
                    + [r for o, hs in self.polys for r in [o] + hs]):
            if len(arr):
                xs += [arr[:, 0].min(), arr[:, 0].max()]
                ys += [arr[:, 1].min(), arr[:, 1].max()]
        if xs:
            self.bbox = (min(xs), min(ys), max(xs), max(ys))
        return self

    @property
    def empty(self) -> bool:
        return not (len(self.points) or self.lines or self.polys)


class ShapeParseError(ValueError):
    pass


def _ring(coords) -> Ring:
    a = np.asarray(coords, np.float64)
    if a.ndim != 2 or a.shape[1] < 2 or len(a) < 2:
        raise ShapeParseError(f"bad ring/line coordinates (shape {a.shape})")
    return a[:, :2]


def _circle_poly(lon: float, lat: float, radius_m: float, n: int = 64) -> Ring:
    # small-circle approximation in degrees (fine for the filter use case)
    dlat = radius_m / 111_195.0
    dlon = dlat / max(math.cos(math.radians(lat)), 1e-6)
    t = np.linspace(0, 2 * math.pi, n, endpoint=False)
    return np.stack([lon + dlon * np.cos(t), lat + dlat * np.sin(t)], axis=1)


def parse_distance_m(v) -> float:
    """Delegates to the one DistanceUnit table (query_dsl._parse_distance)
    so circle radii accept exactly what geo_distance accepts."""
    from .query_dsl import parse_distance
    try:
        return parse_distance(v)
    except (ValueError, TypeError) as e:
        raise ShapeParseError(f"cannot parse distance [{v}]: {e}")


def parse_shape(spec) -> Shape:
    """GeoJSON dict or WKT string -> Shape. Any malformation (missing/
    ragged coordinates included) surfaces as ShapeParseError so the REST
    layer can 400 it."""
    try:
        return _parse_shape_inner(spec)
    except ShapeParseError:
        raise
    except (TypeError, KeyError, IndexError, ValueError) as e:
        raise ShapeParseError(f"malformed shape [{spec!r}]: {e}")


def _parse_shape_inner(spec) -> Shape:  # noqa: C901
    if isinstance(spec, str):
        return _parse_wkt(spec)
    if not isinstance(spec, dict):
        raise ShapeParseError(f"cannot parse shape [{spec!r}]")
    t = str(spec.get("type", "")).lower()
    co = spec.get("coordinates")
    s = Shape()
    if t == "point":
        s.points = np.asarray([co[:2]], np.float64)
    elif t == "multipoint":
        s.points = _ring(co)
    elif t == "linestring":
        s.lines = [_ring(co)]
    elif t == "multilinestring":
        s.lines = [_ring(c) for c in co]
    elif t == "polygon":
        s.polys = [(_ring(co[0]), [_ring(h) for h in co[1:]])]
    elif t == "multipolygon":
        s.polys = [(_ring(p[0]), [_ring(h) for h in p[1:]]) for p in co]
    elif t == "envelope":
        # GeoJSON-extension order: [[minlon, maxlat], [maxlon, minlat]]
        (x1, y2), (x2, y1) = co
        s.polys = [(np.asarray([[x1, y1], [x2, y1], [x2, y2], [x1, y2]],
                               np.float64), [])]
    elif t == "circle":
        lon, lat = spec["coordinates"][:2]
        s.polys = [(_circle_poly(lon, lat,
                                 parse_distance_m(spec.get("radius", "1km"))),
                    [])]
    elif t == "geometrycollection":
        for g in spec.get("geometries", []):
            sub = parse_shape(g)
            s.points = np.concatenate([s.points, sub.points])
            s.lines += sub.lines
            s.polys += sub.polys
    else:
        raise ShapeParseError(f"unknown shape type [{spec.get('type')}]")
    return s.finish()


_WKT_NUM = r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?"


def _wkt_coords(body: str) -> list:
    """'(a b, c d)' nested parens -> nested lists of [x, y]."""
    body = body.strip()
    if body.startswith("("):
        out, depth, start = [], 0, None
        for i, ch in enumerate(body):
            if ch == "(":
                if depth == 0:
                    start = i + 1
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    out.append(_wkt_coords(body[start:i]))
        return out
    return [[float(x) for x in re.findall(_WKT_NUM, pt)][:2]
            for pt in body.split(",")]


def _parse_wkt(s: str) -> Shape:
    m = re.match(r"\s*([A-Za-z]+)\s*(\(.*\)|EMPTY)\s*$", s, re.S)
    if not m:
        raise ShapeParseError(f"cannot parse WKT [{s[:80]}]")
    kind = m.group(1).upper()
    if m.group(2) == "EMPTY":
        return Shape().finish()
    # the outermost WKT paren pair is pure wrapping — unwrap one level
    co = _wkt_coords(m.group(2))[0]
    sh = Shape()
    if kind == "POINT":
        sh.points = np.asarray(co, np.float64)
    elif kind == "MULTIPOINT":
        pts = [c[0] if isinstance(c, list) and c and isinstance(c[0], list)
               else c for c in co]
        sh.points = np.asarray(pts, np.float64)
    elif kind == "LINESTRING":
        sh.lines = [_ring(co)]
    elif kind == "MULTILINESTRING":
        sh.lines = [_ring(c) for c in co]
    elif kind == "POLYGON":
        sh.polys = [(_ring(co[0]), [_ring(h) for h in co[1:]])]
    elif kind == "MULTIPOLYGON":
        sh.polys = [(_ring(p[0]), [_ring(h) for h in p[1:]]) for p in co]
    elif kind in ("ENVELOPE", "BBOX"):  # ENVELOPE(minx, maxx, maxy, miny)
        flat = [float(x) for x in re.findall(_WKT_NUM, m.group(2))]
        x1, x2, y2, y1 = flat[:4]
        sh.polys = [(np.asarray([[x1, y1], [x2, y1], [x2, y2], [x1, y2]],
                                np.float64), [])]
    else:
        raise ShapeParseError(f"unknown WKT type [{kind}]")
    return sh.finish()


# ---------------------------------------------------------------------------
# exact predicates (host, vectorized numpy)
# ---------------------------------------------------------------------------

def points_in_ring(pts: np.ndarray, ring: Ring) -> np.ndarray:
    """Ray-cast: bool[n] — strict interior wins; boundary points count as
    inside (matches Lucene's 'contains includes boundary' behavior)."""
    if len(pts) == 0:
        return np.zeros(0, bool)
    x, y = pts[:, 0][:, None], pts[:, 1][:, None]
    rx, ry = ring[:, 0], ring[:, 1]
    x1, y1 = rx[None, :], ry[None, :]
    x2 = np.roll(rx, -1)[None, :]
    y2 = np.roll(ry, -1)[None, :]
    cond = ((y1 <= y) & (y < y2)) | ((y2 <= y) & (y < y1))
    denom = np.where(y2 == y1, 1e-300, y2 - y1)
    xin = x1 + (y - y1) / denom * (x2 - x1)
    inside = (np.sum(cond & (x < xin), axis=1) % 2) == 1
    # boundary: point on any edge segment
    on = _points_on_segments(pts, np.stack([x1[0], y1[0]], 1),
                             np.stack([x2[0], y2[0]], 1))
    return inside | on


def _points_on_segments(pts, a, b, eps=1e-9) -> np.ndarray:
    """bool[n]: pt collinear with and between a[j]..b[j] for some j."""
    if len(pts) == 0 or len(a) == 0:
        return np.zeros(len(pts), bool)
    p = pts[:, None, :]
    ab = (b - a)[None, :, :]
    ap = p - a[None, :, :]
    cross = ab[..., 0] * ap[..., 1] - ab[..., 1] * ap[..., 0]
    dot = ab[..., 0] * ap[..., 0] + ab[..., 1] * ap[..., 1]
    sq = (ab ** 2).sum(-1)
    on = ((np.abs(cross) <= eps * np.maximum(np.sqrt(sq), 1.0))
          & (dot >= -eps) & (dot <= sq + eps))
    # zero-length edges (e.g. the duplicated ring-closing vertex) match only
    # the vertex itself, not every point
    degenerate = sq <= eps * eps
    at_vertex = (ap ** 2).sum(-1) <= eps * eps
    return np.where(degenerate, at_vertex, on).any(axis=1)


def points_in_poly(pts: np.ndarray, poly: Poly) -> np.ndarray:
    outer, holes = poly
    m = points_in_ring(pts, outer)
    for h in holes:
        # boundary of a hole still counts as inside the polygon
        m &= ~(points_in_ring(pts, h) & ~_ring_boundary(pts, h))
    return m


def _ring_boundary(pts, ring) -> np.ndarray:
    a = ring
    b = np.roll(ring, -1, axis=0)
    return _points_on_segments(pts, a, b)


def points_in_shape(pts: np.ndarray, shape: Shape) -> np.ndarray:
    m = np.zeros(len(pts), bool)
    for poly in shape.polys:
        m |= points_in_poly(pts, poly)
    return m


def _shape_edges(shape: Shape) -> Tuple[np.ndarray, np.ndarray]:
    """All boundary edges (polygon rings incl. holes + lines) as (a, b)."""
    av, bv = [], []
    for o, hs in shape.polys:
        for r in [o] + hs:
            av.append(r)
            bv.append(np.roll(r, -1, axis=0))
    for ln in shape.lines:
        av.append(ln[:-1])
        bv.append(ln[1:])
    if not av:
        z = np.zeros((0, 2), np.float64)
        return z, z
    return np.concatenate(av), np.concatenate(bv)


def _segments_cross(a1, b1, a2, b2) -> bool:
    """Any segment of set 1 properly or improperly intersects any of set 2."""
    if len(a1) == 0 or len(a2) == 0:
        return False
    # orientation tests, broadcast [n1, n2]
    d1 = (b1 - a1)[:, None, :]
    d2 = (b2 - a2)[None, :, :]
    w = a2[None, :, :] - a1[:, None, :]
    den = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    t_num = w[..., 0] * d2[..., 1] - w[..., 1] * d2[..., 0]
    u_num = w[..., 0] * d1[..., 1] - w[..., 1] * d1[..., 0]
    eps = 1e-12
    nonpar = np.abs(den) > eps
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(nonpar, t_num / np.where(nonpar, den, 1.0), np.inf)
        u = np.where(nonpar, u_num / np.where(nonpar, den, 1.0), np.inf)
    hit = nonpar & (t >= -eps) & (t <= 1 + eps) & (u >= -eps) & (u <= 1 + eps)
    if hit.any():
        return True
    # collinear overlap: endpoints of one lying on the other
    par = ~nonpar & (np.abs(t_num) <= eps)
    if not par.any():
        return False
    ep = np.concatenate([a1, b1])
    return bool(_points_on_segments(ep, a2, b2).any()
                or _points_on_segments(np.concatenate([a2, b2]), a1, b1).any())


def _bbox_overlap(b1, b2) -> bool:
    return not (b1[2] < b2[0] or b2[2] < b1[0]
                or b1[3] < b2[1] or b2[3] < b1[1])


def intersects(a: Shape, b: Shape) -> bool:
    if a.empty or b.empty or not _bbox_overlap(a.bbox, b.bbox):
        return False
    # point tests both directions
    if len(a.points) and (points_in_shape(a.points, b).any()
                          or _points_on_edges(a.points, b).any()):
        return True
    if len(b.points) and (points_in_shape(b.points, a).any()
                          or _points_on_edges(b.points, a).any()):
        return True
    if len(a.points) and len(b.points):
        # shared coordinates
        aset = {tuple(p) for p in np.round(a.points, 9).tolist()}
        if any(tuple(p) in aset for p in np.round(b.points, 9).tolist()):
            return True
    ea, eb = _shape_edges(a), _shape_edges(b)
    if _segments_cross(ea[0], ea[1], eb[0], eb[1]):
        return True
    # full containment (no edge crossings): one representative vertex PER
    # CONNECTED PART — a non-first part can sit wholly inside the other
    # shape while the first part is far away
    va = _part_representatives(a)
    if len(va) and points_in_shape(va, b).any():
        return True
    vb = _part_representatives(b)
    if len(vb) and points_in_shape(vb, a).any():
        return True
    return False


def _part_representatives(shape: Shape) -> np.ndarray:
    """First vertex of each connected component (every poly, every line)."""
    parts = [o[:1] for o, _hs in shape.polys] + [ln[:1] for ln in shape.lines]
    if len(shape.points):
        parts.append(shape.points)
    return np.concatenate(parts) if parts else np.zeros((0, 2), np.float64)


def _points_on_edges(pts, shape: Shape) -> np.ndarray:
    a, b = _shape_edges(shape)
    return _points_on_segments(pts, a, b)


def _all_vertices(shape: Shape) -> np.ndarray:
    parts = [shape.points] + shape.lines + \
        [r for o, hs in shape.polys for r in [o] + hs]
    parts = [p for p in parts if len(p)]
    return np.concatenate(parts) if parts else np.zeros((0, 2), np.float64)


def _segments_cross_proper(a1, b1, a2, b2) -> bool:
    """Transversal interior-to-interior crossing only: touching at
    endpoints or collinear overlap does NOT count."""
    if len(a1) == 0 or len(a2) == 0:
        return False
    d1 = (b1 - a1)[:, None, :]
    d2 = (b2 - a2)[None, :, :]
    w = a2[None, :, :] - a1[:, None, :]
    den = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    t_num = w[..., 0] * d2[..., 1] - w[..., 1] * d2[..., 0]
    u_num = w[..., 0] * d1[..., 1] - w[..., 1] * d1[..., 0]
    eps = 1e-12
    nonpar = np.abs(den) > eps
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(nonpar, t_num / np.where(nonpar, den, 1.0), np.inf)
        u = np.where(nonpar, u_num / np.where(nonpar, den, 1.0), np.inf)
    return bool((nonpar & (t > eps) & (t < 1 - eps)
                 & (u > eps) & (u < 1 - eps)).any())


def within(a: Shape, b: Shape) -> bool:
    """a within b: b must be areal; every part of a inside b's polygons.
    Touching b's boundary is allowed; properly crossing it is not."""
    if a.empty or not b.polys:
        return False
    va = _all_vertices(a)
    if not points_in_shape(va, b).all():
        return False
    ea = _shape_edges(a)
    eb = _shape_edges(b)
    # a boundary edge of `a` transversally crossing b's boundary (outer
    # rings OR holes) means part of a's interior escapes b — this is what
    # catches a region protruding into a hole whose vertices/midpoints all
    # sample inside b
    if _segments_cross_proper(ea[0], ea[1], eb[0], eb[1]):
        return False
    if len(ea[0]):
        mids = (ea[0] + ea[1]) / 2.0
        if not points_in_shape(mids, b).all():
            return False
    # a hole of b strictly inside a would break containment
    for o, hs in b.polys:
        for h in hs:
            if a.polys and points_in_shape(h, a).all() \
                    and not _points_on_edges(h, a).all():
                return False
    return True


def relation_matches(doc: Shape, query: Shape, relation: str) -> bool:
    if relation == "intersects":
        return intersects(doc, query)
    if relation == "disjoint":
        return not intersects(doc, query)
    if relation == "within":
        return within(doc, query)
    if relation == "contains":
        return within(query, doc)
    raise ShapeParseError(f"unknown geo_shape relation [{relation}]")
