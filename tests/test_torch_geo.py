"""geo_point and geo_shape in the port against the JAX package on the CPU.

- One index maps `loc` (geo_point, every accepted form: {lat, lon},
  "lat,lon", GeoJSON [lon, lat], an array of points, missing), `area`
  (geo_shape: points, linestrings, polygons with holes, multipolygons,
  envelopes, circles, in WKT and GeoJSON, an array of two shapes), a
  text `body`, a keyword `tag` and an integer `n`. The same seeded
  documents (numpy seed 19: 500 docs around 12 centres) go through both
  packages' RestClient (the reference's on a node without a mesh
  service, 0 replicas) in two segments, the first with deletes.
- The same bodies give the same responses, `took` aside: geo_distance,
  geo_bounding_box (both forms), geo_polygon, geo_shape with every
  relation on both fields, geo filters in bools (filter and must_not),
  exists, the `_geo_distance` sort (units, order, several keys, a
  missing point last), gauss / exp / linear decays and distance_feature
  on `loc`, and the geo_distance, geohash_grid, geotile_grid,
  geo_bounds and geo_centroid aggregations (a grid's geo_centroid sub
  served by the bucket refinement, as in the reference); through
  search and msearch, after a forcemerge, and after a flush and a
  recovery. An `indexed_shape` resolves to the stored shape.
- The reference's 400s: a malformed shape (at index and query time), a
  malformed point, distance and relation.
- `segment_from_arrays` carries a reference segment's geo and shape
  columns; the ops against the reference's jnp ones.
- A geo or range-field filter in a bool's filter or must_not rides B3
  where the reference's fastpath takes it (the same routes, the same
  pages); a geo query at the root, a geo decay and distance_feature
  take the general path in both.
- chip_smoke phase 20's classes against GeoOracle on a 3,000-passage
  bench corpus, and phase 4's index of every new family against the
  reference (and its recovery against itself).
- What the port still refuses (`star_tree`, the span kinds left in
  `REFERENCE_KINDS`), and what it serves since nested objects, joins and
  the percolator were ported (their types, kinds and a `_geo_distance`
  sort's `nested` option, as the reference's); the valid geo forms on
  which both packages fail with a bare Python error (ROADMAP Queue 3),
  pinned as the reference's.

Tolerances (ROADMAP Queue 3): distances, `_geo_distance` sort values,
decay and distance_feature scores within GEO_RTOL = 1e-5 relative (the
f32 haversine's transcendentals come from another libm than XLA's, the
"haversine band" entry); a doc whose f64 distance lies within 1e-5
relative of a query's radius or a ring's edge may flip, so such docs
are counted, printed and left out of the id comparison of that body
(no doc is moved to keep the band empty); geo_centroid within
CENTROID_RTOL = 1e-6 relative (f32 sums in another order, the "centroid
sum order" entry); geo_bounds, counts, grid keys and shape relations
exactly. The ray-cast's FMA difference ("ray-cast FMA") is pinned in
`test_ray_cast_is_uncontracted`.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import strip_took
from opensearch_tpu.cluster.node import Node
from opensearch_tpu.ops import aggs as ref_aggs
from opensearch_tpu.ops import scoring as ref_scoring
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu_torch import RestClient
from opensearch_tpu_torch.index.convert import segment_from_arrays
from opensearch_tpu_torch.ops import aggs as agg_ops
from opensearch_tpu_torch.ops import scoring as ops
from tests.test_torch_bool import reference_fastpath  # noqa: F401
from tests.test_torch_scripts import bench_small  # noqa: F401

jax.config.update("jax_platforms", "cpu")

GEO_RTOL = 1e-5
CENTROID_RTOL = 1e-6
AGG_RTOL = 1e-5
NDOCS = 500
SPLIT = 320
DELETED = ("d3", "d40", "d41", "d300", "d410")
SETTINGS = {"number_of_replicas": 0}
MAPPING = {"properties": {
    "body": {"type": "text"}, "tag": {"type": "keyword"},
    "n": {"type": "integer"}, "loc": {"type": "geo_point"},
    "area": {"type": "geo_shape"}}}
WORDS = ["cafe", "pizza", "park", "museum", "bar", "hotel", "shop",
         "beach", "river", "market"]
CENTRES = [(40.7, -74.0), (48.85, 2.35), (35.7, 139.7), (-33.9, 151.2),
           (51.5, -0.12), (52.52, 13.4), (19.4, -99.1), (-23.5, -46.6),
           (1.35, 103.8), (55.75, 37.6), (30.0, 31.2), (37.77, -122.4)]


def _square(lon, lat, h):
    return [[lon - h, lat - h], [lon + h, lat - h], [lon + h, lat + h],
            [lon - h, lat + h], [lon - h, lat - h]]


def _wkt_ring(ring):
    return "(" + ", ".join(f"{x:.6f} {y:.6f}" for x, y in ring) + ")"


def shape_of(kind: int, lon: float, lat: float):
    """One geo_shape value of each kind near (lon, lat)."""
    if kind == 0:
        return {"type": "Point", "coordinates": [lon, lat]}
    if kind == 1:
        return f"LINESTRING ({lon:.6f} {lat:.6f}, {lon + 0.3:.6f} " \
               f"{lat + 0.2:.6f}, {lon + 0.5:.6f} {lat - 0.1:.6f})"
    if kind == 2:
        return {"type": "Polygon", "coordinates": [
            _square(lon, lat, 0.4), _square(lon, lat, 0.1)]}
    if kind == 3:
        return ("MULTIPOLYGON ((" + _wkt_ring(_square(lon, lat, 0.2))
                + "), (" + _wkt_ring(_square(lon + 1.0, lat, 0.2)) + "))")
    if kind == 4:
        return {"type": "envelope", "coordinates": [[lon - 0.3, lat + 0.2],
                                                    [lon + 0.3, lat - 0.2]]}
    if kind == 5:
        return {"type": "circle", "coordinates": [lon, lat],
                "radius": "15km"}
    if kind == 6:
        return f"POINT ({lon:.6f} {lat:.6f})"
    if kind == 7:
        return {"type": "MultiPoint", "coordinates": [[lon, lat],
                                                      [lon + 0.2, lat]]}
    return [{"type": "Point", "coordinates": [lon, lat]},
            "POLYGON (" + _wkt_ring(_square(lon, lat, 0.05)) + ")"]


def make_docs(n: int = NDOCS, seed: int = 19) -> list:
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        clat, clon = CENTRES[int(rng.integers(0, len(CENTRES)))]
        lat = round(float(clat + rng.normal(0, 0.4)), 6)
        lon = round(float(clon + rng.normal(0, 0.4)), 6)
        d = {"body": " ".join(rng.choice(WORDS, int(rng.integers(1, 5)))),
             "tag": str(rng.choice(["a", "b", "c"])),
             "n": int(rng.integers(0, 100))}
        form = i % 6
        if form == 0:
            d["loc"] = {"lat": lat, "lon": lon}
        elif form == 1:
            d["loc"] = f"{lat},{lon}"
        elif form == 2:
            d["loc"] = [lon, lat]
        elif form == 3:
            d["loc"] = [{"lat": lat, "lon": lon},
                        {"lat": lat + 1.0, "lon": lon}]
        elif form == 4:
            d["loc"] = {"lat": lat, "lon": lon}
        if i % 4 != 3:
            d["area"] = shape_of(i % 9, lon, lat)
        docs.append(d)
    return docs


def fill(c, docs, index="g"):
    c.indices.create(index, {"settings": copy.deepcopy(SETTINGS),
                             "mappings": copy.deepcopy(MAPPING)})
    for a, b in ((0, SPLIT), (SPLIT, len(docs))):
        c.bulk(sum([[{"index": {"_index": index, "_id": f"d{i}"}},
                     copy.deepcopy(docs[i])] for i in range(a, b)], []),
               refresh=True)
    c.bulk([{"delete": {"_index": index, "_id": d}} for d in DELETED],
           refresh=True)
    return c


NYC, PARIS, TOKYO = CENTRES[0], CENTRES[1], CENTRES[2]
POLY6 = [{"lat": PARIS[0] + 0.5 * math.sin(k * math.pi / 3),
          "lon": PARIS[1] + 0.7 * math.cos(k * math.pi / 3)}
         for k in range(6)]
ENV_NYC = {"type": "envelope", "coordinates": [[-74.6, 41.2],
                                               [-73.4, 40.2]]}
HOLED = {"type": "Polygon", "coordinates": [
    _square(TOKYO[1], TOKYO[0], 0.8), _square(TOKYO[1], TOKYO[0], 0.2)]}
WKT_POLY = "POLYGON (" + _wkt_ring(_square(PARIS[1], PARIS[0], 0.6)) + ")"
LINE = {"type": "LineString", "coordinates": [[-75.0, 40.5],
                                              [-73.0, 41.0]]}


BODIES = [
    # (body, band spec: (lat, lon, radius m) whose edge docs may flip)
    ({"query": {"geo_distance": {"distance": "50km", "loc": {
        "lat": NYC[0], "lon": NYC[1]}}}, "size": 100},
     (NYC[0], NYC[1], 50_000.0)),
    ({"query": {"geo_distance": {"distance": "25mi",
                                 "loc": f"{PARIS[0]},{PARIS[1]}"}},
      "size": 100}, (PARIS[0], PARIS[1], 25 * 1609.344)),
    ({"query": {"bool": {"must": [{"match": {"body": "cafe"}}],
                         "filter": [{"geo_distance": {
                             "distance": 40000,
                             "loc": [TOKYO[1], TOKYO[0]]}}]}}},
     (TOKYO[0], TOKYO[1], 40_000.0)),
    ({"query": {"bool": {"must": [{"match": {"body": "park"}}],
                         "must_not": [{"geo_distance": {
                             "distance": "1000km", "loc": {
                                 "lat": NYC[0], "lon": NYC[1]}}}]}}},
     (NYC[0], NYC[1], 1_000_000.0)),
    ({"query": {"geo_bounding_box": {"loc": {
        "top_left": {"lat": 49.5, "lon": 1.5},
        "bottom_right": {"lat": 48.0, "lon": 3.0}}}}, "size": 100}, None),
    ({"query": {"geo_bounding_box": {"loc": {
        "top": 53.0, "left": 12.5, "bottom": 52.0, "right": 14.5}}},
      "size": 100}, None),
    ({"query": {"geo_polygon": {"loc": {"points": POLY6}}}, "size": 100},
     None),
    ({"query": {"bool": {"should": [{"match": {"body": "bar"}}],
                         "filter": [{"geo_polygon": {"loc": {
                             "points": POLY6}}}]}}}, None),
    ({"query": {"geo_shape": {"loc": {"shape": ENV_NYC,
                                      "relation": "within"}}},
      "size": 100}, None),
    ({"query": {"geo_shape": {"loc": {"shape": HOLED}}}, "size": 100},
     None),
    ({"query": {"geo_shape": {"loc": {"shape": WKT_POLY,
                                      "relation": "disjoint"}}},
      "size": 20}, None),
    ({"query": {"geo_shape": {"loc": {"shape": {
        "type": "Point", "coordinates": [-74.0, 40.7]},
        "relation": "contains"}}}}, None),
    ({"query": {"geo_shape": {"area": {"shape": ENV_NYC}}}, "size": 100},
     None),
    ({"query": {"geo_shape": {"area": {"shape": ENV_NYC,
                                       "relation": "within"}}},
      "size": 100}, None),
    ({"query": {"geo_shape": {"area": {"shape": HOLED,
                                       "relation": "disjoint"}}},
      "size": 30}, None),
    ({"query": {"geo_shape": {"area": {"shape": {
        "type": "Point", "coordinates": [TOKYO[1], TOKYO[0]]},
        "relation": "contains"}}}, "size": 100}, None),
    ({"query": {"geo_shape": {"area": {"shape": LINE,
                                       "relation": "intersects"}}},
      "size": 100}, None),
    ({"query": {"geo_shape": {"area": {"shape": {
        "type": "circle", "coordinates": [PARIS[1], PARIS[0]],
        "radius": "30km"}}}}, "size": 100}, None),
    ({"query": {"geo_shape": {"area": {"shape": WKT_POLY,
                                       "relation": "contains"}}}}, None),
    ({"query": {"geo_shape": {"nope": {"shape": WKT_POLY},
                              "ignore_unmapped": True}}}, None),
    ({"query": {"exists": {"field": "loc"}}, "size": 5}, None),
    ({"query": {"exists": {"field": "area"}}, "size": 5}, None),
    ({"query": {"match": {"body": "museum"}}, "sort": [
        {"_geo_distance": {"loc": {"lat": PARIS[0], "lon": PARIS[1]},
                           "unit": "km"}}], "size": 20}, None),
    ({"query": {"geo_bounding_box": {"loc": {
        "top_left": {"lat": 41.5, "lon": -75.0},
        "bottom_right": {"lat": 40.0, "lon": -73.0}}}},
      "sort": [{"_geo_distance": {"loc": [NYC[1], NYC[0]],
                                  "order": "desc", "mode": "min",
                                  "distance_type": "arc"}}, "n"],
      "size": 20}, None),
    ({"query": {"match_all": {}}, "sort": [
        {"_geo_distance": {"loc": "0,0", "unit": "mi"}}, {"n": "desc"}],
      "from": 470, "size": 30}, None),
    ({"query": {"function_score": {
        "query": {"match": {"body": "hotel"}},
        "functions": [{"gauss": {"loc": {
            "origin": {"lat": NYC[0], "lon": NYC[1]}, "scale": "10km",
            "offset": "2km"}}}]}}}, None),
    ({"query": {"function_score": {
        "query": {"match_all": {}},
        "functions": [{"exp": {"loc": {"origin": f"{PARIS[0]},{PARIS[1]}",
                                       "scale": "50km", "decay": 0.3}}},
                      {"linear": {"loc": {"origin": [TOKYO[1], TOKYO[0]],
                                          "scale": "3000km"}},
                       "weight": 2.0}],
        "score_mode": "sum", "boost_mode": "replace"}}, "size": 30}, None),
    ({"query": {"bool": {"must": [{"match": {"body": "shop"}}],
                         "should": [{"distance_feature": {
                             "field": "loc", "origin": [NYC[1], NYC[0]],
                             "pivot": "5km"}}]}}}, None),
    ({"query": {"distance_feature": {"field": "loc",
                                     "origin": f"{PARIS[0]},{PARIS[1]}",
                                     "pivot": "100km", "boost": 2.0}},
      "size": 30}, None),
    ({"size": 0, "query": {"match": {"body": "cafe"}}, "aggs": {
        "grid": {"geohash_grid": {"field": "loc", "precision": 3,
                                  "size": 6},
                 "aggs": {"c": {"geo_centroid": {"field": "loc"}},
                          "m": {"max": {"field": "n"}}}},
        "b": {"geo_bounds": {"field": "loc"}},
        "rings": {"geo_distance": {
            "field": "loc", "origin": f"{PARIS[0]},{PARIS[1]}",
            "unit": "km", "ranges": [{"to": 10}, {"from": 10, "to": 50},
                                     {"from": 50, "to": 200}]},
            "aggs": {"a": {"avg": {"field": "n"}}}}}}, None),
    ({"size": 0, "aggs": {
        "tiles": {"geotile_grid": {"field": "loc", "precision": 6},
                  "aggs": {"t": {"terms": {"field": "tag"}}}},
        "c": {"geo_centroid": {"field": "loc"}},
        "hash7": {"geohash_grid": {"field": "loc"}},
        "rings": {"geo_distance": {
            "field": "loc", "origin": {"lat": NYC[0], "lon": NYC[1]},
            "ranges": [{"key": "near", "to": 30000},
                       {"from": 30000}]},
            "aggs": {"g": {"geohash_grid": {"field": "loc",
                                            "precision": 2},
                           "aggs": {"c": {"geo_centroid": {
                               "field": "loc"}}}}}}}}, None),
    ({"size": 0, "query": {"term": {"tag": "zzz"}}, "aggs": {
        "b": {"geo_bounds": {"field": "loc"}},
        "c": {"geo_centroid": {"field": "loc"}},
        "r": {"geo_distance": {"field": "loc", "origin": "0,0",
                               "ranges": [{"to": 1}]}},
        "h": {"geohash_grid": {"field": "loc"}}}}, None),
    ({"size": 0, "aggs": {"b": {"geo_bounds": {"field": "area"}},
                          "u": {"geo_centroid": {"field": "nope"}}}}, None),
]


def f64_dist(lat, lon, olat, olon):
    """f64 haversine meters from f32 points (the band's yardstick)."""
    p1, p2 = np.radians(lat), np.radians(olat)
    dl = np.radians(olon - lon)
    a = (np.sin((p2 - p1) / 2) ** 2
         + np.cos(p1) * np.cos(p2) * np.sin(dl / 2) ** 2)
    return 2 * 6371008.8 * np.arcsin(np.sqrt(np.minimum(a, 1.0)))


def band_ids(port, spec, index="g") -> set:
    """The live docs whose f64 distance lies within GEO_RTOL of the
    radius: a membership the f32 haversines of the two packages may
    decide apart."""
    if spec is None:
        return set()
    olat, olon, r = spec
    out = set()
    for seg in port._indices[index].engine.segments:
        col = seg.geo_cols.get("loc")
        if col is None:
            continue
        d = f64_dist(col.lat.astype(np.float64), col.lon.astype(np.float64),
                     olat, olon)
        for i in np.flatnonzero(col.present & seg.live
                                & (np.abs(d - r) <= GEO_RTOL * r)):
            out.add(seg.ids[i])
    return out


def same(got, want, path="", in_aggs=False, centroid=False) -> None:
    """Equal, `took` stripped, but scores and sort values within GEO_RTOL,
    aggregation floats within AGG_RTOL, a centroid within
    CENTROID_RTOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            same(got[k], want[k], f"{path}.{k}",
                 in_aggs or k == "aggregations",
                 centroid or k == "location")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}[{i}]", in_aggs, centroid)
    elif isinstance(want, float) and isinstance(got, float) and (
            in_aggs or ".sort" in path
            or path.endswith(("._score", ".max_score"))):
        rtol = (CENTROID_RTOL if centroid else AGG_RTOL if in_aggs
                else GEO_RTOL)
        assert abs(got - want) <= rtol * abs(want), (path, got, want)
    else:
        assert got == want, (path, got, want)


def check(ref, port, body, spec=None, index="g") -> int:
    """The port's page against the reference's; -> the docs in the band
    (left out of the ids and the total, each side's within their count)."""
    want = strip_took(ref.search(index, copy.deepcopy(body)))
    got = strip_took(port.search(index, copy.deepcopy(body)))
    band = band_ids(port, spec, index)
    if band:
        print(f"haversine band: {len(band)} docs of {body}")
        for resp in (got, want):
            hits = resp["hits"]
            hits["hits"] = [h for h in hits["hits"] if h["_id"] not in band]
        gt, wt = got["hits"]["total"]["value"], want["hits"]["total"]["value"]
        assert abs(gt - wt) <= len(band)
        got["hits"]["total"] = want["hits"]["total"]
        if got["hits"]["hits"] and want["hits"]["hits"]:
            got["hits"]["max_score"] = want["hits"]["max_score"]
    same(got, want, str(body))
    return len(band)


@pytest.fixture(scope="module")
def docs():
    return make_docs()


@pytest.fixture(scope="module")
def clients(docs):
    ref = fill(RefClient(node=Node(mesh_service=False)), docs)
    port = fill(RestClient(device="cpu"), docs)
    return ref, port


@pytest.mark.parametrize("i", range(len(BODIES)))
def test_geo_bodies_match_reference(clients, i):
    ref, port = clients
    segs = port._indices["g"].engine.segments
    assert len(segs) == 2 and segs[0].live_count < segs[0].ndocs
    body, spec = BODIES[i]
    check(ref, port, body, spec)


def test_geo_bodies_in_msearch(clients):
    ref, port = clients
    lines = sum([[{}, copy.deepcopy(b)] for b, spec in BODIES[:12]
                 if spec is None], [])
    got = port.msearch(lines, index="g")["responses"]
    want = ref.msearch(lines, index="g")["responses"]
    for g, w, b in zip(got, want, lines[1::2]):
        same(strip_took(g), strip_took(w), str(b))


def test_geo_after_forcemerge_and_recovery(docs, tmp_path):
    ref = fill(RefClient(node=Node(mesh_service=False)), docs)
    port = fill(RestClient(device="cpu", data_path=str(tmp_path)), docs)
    for c in (ref, port):
        c.indices.forcemerge("g", max_num_segments=1)
    seg = port._indices["g"].engine.segments[0]
    rseg = ref.node.indices["g"].shards[0].segments[0]
    for f in ("lat", "lon", "present"):
        np.testing.assert_array_equal(getattr(seg.geo_cols["loc"], f),
                                      getattr(rseg.geo_cols["loc"], f))
    scol, rcol = seg.shape_cols["area"], rseg.shape_cols["area"]
    assert scol.specs == rcol.specs
    for f in ("minx", "miny", "maxx", "maxy", "present"):
        np.testing.assert_array_equal(getattr(scol, f), getattr(rcol, f))
    for body, spec in BODIES:
        check(ref, port, body, spec)
    port.indices.flush("g")
    port.close()
    back = RestClient(device="cpu", data_path=str(tmp_path))
    for body, spec in BODIES[::3]:
        check(ref, back, body, spec)


def test_geo_distance_search_after_pinned(clients):
    """A `_geo_distance` primary sort's `search_after` (ROADMAP Queue 3):
    the reference's device cursor is +inf and its host does not cut, so
    its page starts before the cursor again (as its `_doc` cursor does);
    the port serves the hits strictly after the full tuple (its rule
    for every cursor, tests/test_torch_sort.py). Both totals count every
    match."""
    ref, port = clients
    sort = [{"_geo_distance": {"loc": [PARIS[1], PARIS[0]], "unit": "km"}},
            {"n": "asc"}]
    q = {"match": {"body": "river"}}
    every = port.search("g", {"query": q, "sort": sort, "size": 500})
    after = (500.0, 40)
    want = [h["_id"] for h in every["hits"]["hits"]
            if h["sort"][0] is None or tuple(h["sort"]) > after][:15]
    body = {"query": q, "sort": sort, "search_after": list(after),
            "size": 15}
    got, rgot = port.search("g", body), ref.search("g", body)
    assert [h["_id"] for h in got["hits"]["hits"]] == want
    assert rgot["hits"]["hits"][0]["sort"][0] < after[0]
    assert got["hits"]["total"] == rgot["hits"]["total"] == \
        every["hits"]["total"]


def test_indexed_shape_resolves_the_stored_shape(clients):
    ref, port = clients
    for c in (ref, port):
        c.indices.create("shapes", {"settings": dict(SETTINGS), "mappings": {
            "properties": {"zone": {"properties": {
                "shape": {"type": "geo_shape"}}}}}})
        c.index("shapes", {"zone": {"shape": ENV_NYC}}, id="nyc",
                refresh=True)
    body = {"query": {"geo_shape": {"area": {"indexed_shape": {
        "index": "shapes", "id": "nyc", "path": "zone.shape"}}}},
        "size": 100}
    check(ref, port, body)
    assert port.count("g", {"query": body["query"]}) == \
        ref.count("g", {"query": body["query"]})
    for bad in ({"index": "shapes", "id": "missing"},
                {"index": "shapes", "id": "nyc", "path": "zone.nope"},
                {"id": "nyc"}):
        q = {"query": {"geo_shape": {"area": {"indexed_shape": bad}}}}
        errs = []
        for c in (ref, port):
            with pytest.raises(Exception) as e:
                c.search("g", q)
            errs.append(e.value)
        assert [type(e).__name__ for e in errs] == ["ApiError"] * 2
        assert str(errs[0]) == str(errs[1])


BAD_QUERIES = [
    {"geo_shape": {"area": {"shape": {"type": "Polygon",
                                      "coordinates": [[[0, 0], [1]]]}}}},
    {"geo_shape": {"area": {"shape": "POLYGON ((0 0, 1 1"}}},
    {"geo_shape": {"area": {"shape": {"type": "blob",
                                      "coordinates": [0, 0]}}}},
    {"geo_shape": {"area": {"shape": ENV_NYC, "relation": "overlaps"}}},
    {"geo_shape": {"area": {}}},
    {"geo_shape": {"body": {"shape": ENV_NYC}}},
    {"geo_shape": {"nope": {"shape": ENV_NYC}}},
    {"geo_distance": {"distance": "12 parsecs", "loc": "1,2"}},
    {"geo_distance": {"distance": "5km", "loc": "1;2"}},
    {"geo_distance": {"distance": "5km", "loc": {"lat": 1}}},
    {"geo_polygon": {"loc": {"points": [[0, 0], [1, 1]]}}},
    {"geo_polygon": {"loc": [0, 0]}},
    {"function_score": {"functions": [{"gauss": {"loc": {
        "scale": "10km"}}}]}},
    {"function_score": {"functions": [{"gauss": {"loc": {
        "origin": "0,0", "scale": "ten km"}}}]}},
    {"function_score": {"functions": [{"exp": {"loc": {
        "origin": "0,0", "scale": "0km"}}}]}},
    {"distance_feature": {"field": "loc", "origin": "0,0"}},
    {"distance_feature": {"field": "tag", "origin": "0,0",
                          "pivot": "1km"}},
    {"range": {"loc": {"gte": 1}}},
]


@pytest.mark.parametrize("q", BAD_QUERIES, ids=str)
def test_malformed_geo_queries_are_the_references_errors(clients, q):
    ref, port = clients
    errs = []
    for c in (ref, port):
        with pytest.raises(Exception) as e:
            c.search("g", {"query": copy.deepcopy(q)})
        errs.append(e.value)
    assert type(errs[1]).__name__ == type(errs[0]).__name__, errs
    assert str(errs[1]) == str(errs[0])


# valid OpenSearch geo forms that both packages fail on with a bare
# Python error (ROADMAP Queue 3): kept as the reference's, pinned so that
# a change to any of them is a choice
UNSERVED_GEO_FORMS = {
    "distance_type": {"query": {"geo_distance": {
        "distance": "100km", "distance_type": "arc",
        "loc": {"lat": 40, "lon": -74}}}},
    "geohash origin": {"query": {"geo_distance": {
        "distance": "100km", "loc": "dr5regw3"}}},
    "geohash corner": {"query": {"geo_bounding_box": {"loc": {
        "top_left": "dr5r", "bottom_right": "dr5x"}}}},
    "geohash polygon point": {"query": {"geo_polygon": {"loc": {
        "points": ["dr5r", "dr5x", "dr72"]}}}},
    "geohash sort origin": {"sort": [{"_geo_distance": {
        "loc": "dr5regw3", "order": "asc"}}]},
    "top_right / bottom_left": {"query": {"geo_bounding_box": {"loc": {
        "top_right": {"lat": 41, "lon": -73},
        "bottom_left": {"lat": 39, "lon": -75}}}}},
    "WKT BBOX": {"query": {"geo_bounding_box": {"loc": {
        "wkt": "BBOX (-75, -73, 41, 39)"}}}},
    "box type": {"query": {"geo_bounding_box": {"type": "indexed", "loc": {
        "top_left": {"lat": 41, "lon": -75},
        "bottom_right": {"lat": 39, "lon": -73}}}}},
    "several sort origins": {"sort": [{"_geo_distance": {
        "loc": [{"lat": 40, "lon": -74}, {"lat": 41, "lon": -73}],
        "order": "asc"}}]},
    "grid precision as a distance": {"size": 0, "aggs": {"g": {
        "geohash_grid": {"field": "loc", "precision": "100km"}}}},
}


@pytest.mark.parametrize("name", list(UNSERVED_GEO_FORMS))
def test_unserved_geo_forms_are_the_references_python_errors(clients, name):
    """Each form raises the same bare Python error in both packages
    (ValueError "not enough values to unpack", KeyError 'top',
    AttributeError, TypeError, ValueError), not an ApiError."""
    ref, port = clients
    errs = []
    for c in (ref, port):
        with pytest.raises(Exception) as e:
            c.search("g", copy.deepcopy(UNSERVED_GEO_FORMS[name]))
        errs.append(e.value)
    assert type(errs[0]).__name__ in ("ValueError", "KeyError",
                                      "AttributeError", "TypeError")
    assert type(errs[1]).__name__ == type(errs[0]).__name__, errs
    assert str(errs[1]) == str(errs[0])


@pytest.mark.parametrize("doc", [
    {"loc": "12"}, {"loc": {"lat": 1}}, {"loc": "a,b"},
    {"area": "POLYGON ((0 0, 1 1"}, {"area": {"type": "Point"}},
    {"area": {"type": "nope", "coordinates": [1, 2]}}, {"area": 7},
], ids=str)
def test_malformed_geo_documents_are_the_references_errors(doc):
    errs = []
    for c in (RefClient(node=Node(mesh_service=False)),
              RestClient(device="cpu")):
        c.indices.create("g", {"settings": dict(SETTINGS),
                               "mappings": copy.deepcopy(MAPPING)})
        with pytest.raises(Exception) as e:
            c.index("g", copy.deepcopy(doc), id="1")
        errs.append(e.value)
    assert type(errs[1]).__name__ == type(errs[0]).__name__, errs
    assert str(errs[1]) == str(errs[0])


def test_a_scalar_point_in_a_query_is_the_index_time_error(clients):
    """A bare number where a query wants a point (ROADMAP Queue 3, "a
    scalar point"): the port parses query and document points with one
    function, so the query fails with the document's ValueError; the
    reference's query parser fails on it with a bare TypeError."""
    ref, port = clients
    body = {"query": {"geo_distance": {"distance": "5km", "loc": 5}}}
    with pytest.raises(TypeError):
        ref.search("g", copy.deepcopy(body))
    with pytest.raises(ValueError, match=r"cannot parse geo_point \[5\]"):
        port.search("g", copy.deepcopy(body))


def test_filter_masks_are_bounded_by_bytes(clients, monkeypatch):
    """Filter masks built from a request's own geo parameters (a
    locator's origin, a grid bucket's refinement box) share one cache
    bounded by bytes, least recently used first out, as the reference's
    `_FILTER_MASK_MAX_BYTES`: with the bound at four masks, a run of
    such bodies keeps the cache within it and the pages the
    reference's; a segment that releases its device state takes its
    masks out of the cache."""
    from opensearch_tpu_torch.search import filters
    ref, port = clients
    segs = port._indices["g"].engine.segments
    monkeypatch.setattr(filters, "FILTER_MASK_MAX_BYTES",
                        4 * max(s.ndocs for s in segs))
    panel = {"size": 0, "query": {"bool": {"filter": [{"exists": {
        "field": "loc"}}]}}, "aggs": {"grid": {
            "geohash_grid": {"field": "loc", "precision": 3},
            "aggs": {"c": {"geo_centroid": {"field": "loc"}}}}}}
    bodies = [panel] + [{"query": {"bool": {
        "must": [{"match": {"body": "cafe"}}], "filter": [{"geo_distance": {
            "distance": f"{20 + 7 * i}km",
            "loc": {"lat": lat, "lon": lon}}}]}}}
        for i, (lat, lon) in enumerate(CENTRES)]
    for body in bodies:
        check(ref, port, body)
        stats = filters.mask_cache_stats()
        assert 0 < stats["bytes"] <= filters.FILTER_MASK_MAX_BYTES, stats
    fresh = fill(RestClient(device="cpu"), make_docs(seed=3))
    fresh.search("g", bodies[1])
    before = filters.mask_cache_stats()["entries"]
    for seg in fresh._indices["g"].engine.segments:
        seg.release_device()
    assert filters.mask_cache_stats()["entries"] < before


def test_segment_from_arrays_carries_geo_and_shape_columns(clients):
    ref, port = clients
    rseg = ref.node.indices["g"].shards[0].segments[1]
    postings = {f: {"vocab": pb.vocab, "starts": pb.starts,
                    "doc_ids": pb.doc_ids, "tfs": pb.tfs,
                    "pos_starts": pb.pos_starts, "positions": pb.positions}
                for f, pb in rseg.postings.items()}
    stats = {f: (s.doc_count, s.sum_dl) for f, s in rseg.text_stats.items()}
    seg = segment_from_arrays(
        "_0", rseg.ndocs, postings, rseg.doc_lens, stats, list(rseg.ids),
        list(rseg.sources), numeric_cols=rseg.numeric_cols,
        keyword_cols=rseg.keyword_cols, geo_cols=rseg.geo_cols,
        shape_cols=rseg.shape_cols)
    c = RestClient(device="cpu")
    c.indices.create("g", {"mappings": copy.deepcopy(MAPPING)})
    eng = c._indices["g"].engine
    eng.segments.append(seg)
    ref2 = RefClient(node=Node(mesh_service=False))
    ref2.indices.create("g", {"settings": dict(SETTINGS),
                              "mappings": copy.deepcopy(MAPPING)})
    ref2.bulk(sum([[{"index": {"_index": "g", "_id": rseg.ids[i]}},
                    rseg.sources[i]] for i in range(rseg.ndocs)], []),
              refresh=True)
    for body, spec in BODIES:
        if "aggs" in body:
            continue
        check(ref2, c, body, spec)


# ---------------------------------------------------------------------
# the ops against the reference's jnp ones
# ---------------------------------------------------------------------

def _points(n=4000, seed=5):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(-80, 80, n).astype(np.float32)
    lon = rng.uniform(-180, 180, n).astype(np.float32)
    present = rng.random(n) > 0.05
    return lat, lon, present


def test_haversine_ops_within_the_band_tolerance():
    lat, lon, present = _points()
    geo_t = {"lat": torch.from_numpy(lat), "lon": torch.from_numpy(lon),
             "present": torch.from_numpy(present)}
    geo_j = {"lat": jnp.asarray(lat), "lon": jnp.asarray(lon),
             "present": jnp.asarray(present)}
    for olat, olon in ((40.7, -74.0), (0.0, 0.0), (-33.9, 151.2)):
        want = np.asarray(ref_scoring.geo_distance_vec(
            geo_j, jnp.float32(olat), jnp.float32(olon)))
        got = ops.geo_distance_vec(geo_t, olat, olon).numpy()
        np.testing.assert_allclose(got, want, rtol=GEO_RTOL, atol=1e-2)
        for r in (1e5, 2e6, 9e6):
            wm = np.asarray(ref_scoring.geo_distance_mask(
                geo_j, jnp.float32(olat), jnp.float32(olon), jnp.float32(r)))
            gm = ops.geo_distance_mask(geo_t, olat, olon, r).numpy()
            d64 = f64_dist(lat.astype(np.float64), lon.astype(np.float64),
                           olat, olon)
            edge = np.abs(d64 - r) <= GEO_RTOL * r
            print(f"haversine band: {int(edge.sum())} of {len(lat)} "
                  f"points at r={r}")
            np.testing.assert_array_equal(gm[~edge], wm[~edge])


def test_ray_cast_is_uncontracted():
    """The port's crossing rounds each op on its own: it equals numpy's
    f32 ops exactly. The reference's XLA build may contract an FMA; the
    points where the two decide apart all lie on or within an f32 ulp of
    an edge, and are counted here."""
    lat, lon, present = _points(20000, seed=7)
    ring_lat = np.asarray([48.0, 48.5, 49.7, 49.2, 48.1, 48.0], np.float32)
    ring_lon = np.asarray([1.0, 3.4, 3.1, 0.7, 0.2, 1.0], np.float32)
    # points on and next to the edges, and uniform ones
    t = np.random.default_rng(3).random(2000).astype(np.float32)
    k = np.arange(2000) % 5
    elat = ring_lat[k] + t * (ring_lat[k + 1] - ring_lat[k])
    elon = ring_lon[k] + t * (ring_lon[k + 1] - ring_lon[k])
    lat = np.concatenate([lat, elat]).astype(np.float32)
    lon = np.concatenate([lon, elon]).astype(np.float32)
    present = np.concatenate([present, np.ones(2000, bool)])
    geo_t = {"lat": torch.from_numpy(lat), "lon": torch.from_numpy(lon),
             "present": torch.from_numpy(present)}
    got = ops.point_in_polygon_mask(geo_t, ring_lat, ring_lon).numpy()
    # numpy, one rounding per op
    x, y = lon[:, None], lat[:, None]
    x1, y1, x2, y2 = ring_lon[:-1], ring_lat[:-1], ring_lon[1:], ring_lat[1:]
    spans = ((y1 <= y) & (y < y2)) | ((y2 <= y) & (y < y1))
    denom = np.where(y2 == y1, np.float32(1e-30), y2 - y1)
    xin = x1 + (y - y1) / denom * (x2 - x1)
    np.testing.assert_array_equal(
        got, ((spans & (x < xin)).sum(1) % 2 == 1) & present)
    pad = np.full(8, ring_lat[0], np.float32)
    padlon = np.full(8, ring_lon[0], np.float32)
    pad[:6], padlon[:6] = ring_lat, ring_lon
    want = np.asarray(ref_scoring.point_in_polygon_mask(
        {"lat": jnp.asarray(lat), "lon": jnp.asarray(lon),
         "present": jnp.asarray(present)}, jnp.asarray(pad),
        jnp.asarray(padlon)))
    apart = np.flatnonzero(got != want)
    print(f"ray-cast: {len(apart)} of {len(lat)} points decided apart")
    # every point decided apart sits within an f32 ulp of its crossing
    xin_f64 = (x1.astype(np.float64) + (y - y1).astype(np.float64)
               / np.where(y2 == y1, 1e-30, (y2 - y1).astype(np.float64))
               * (x2 - x1).astype(np.float64))
    near = (spans & (np.abs(x.astype(np.float64) - xin_f64)
                     <= 4 * np.spacing(np.abs(x))))
    assert near[apart].any(axis=1).all()
    assert (got == want).mean() > 0.99


def test_geo_agg_ops_against_the_reference():
    lat, lon, present = _points()
    match = np.random.default_rng(9).random(len(lat)) > 0.3
    args_t = [torch.from_numpy(a) for a in (lat, lon, present, match)]
    args_j = [jnp.asarray(a) for a in (lat, lon, present)] + [
        jnp.asarray(match.astype(np.float32))]
    got = [float(v) for v in agg_ops.geo_bounds_agg(*args_t)]
    want = [float(v) for v in ref_aggs.geo_bounds_agg(*args_j)]
    assert got == want
    got = [float(v) for v in agg_ops.geo_centroid_agg(*args_t)]
    want = [float(v) for v in ref_aggs.geo_centroid_agg(*args_j)]
    np.testing.assert_allclose(got, want, rtol=CENTROID_RTOL)
    none = torch.zeros(len(lat), dtype=torch.bool)
    empty = [float(v) for v in agg_ops.geo_bounds_agg(*args_t[:3], none)]
    want = [float(v) for v in ref_aggs.geo_bounds_agg(
        *args_j[:3], jnp.zeros(len(lat), jnp.float32))]
    assert empty == want          # the +-F32_MAX sentinels, count 0


def test_what_the_port_still_refuses():
    """The port refuses star_tree and the span kinds, each
    NotPortedError naming it; the geo query and agg kinds and the five
    field families are served, and since nested objects and joins were
    ported the document-structure types, the nested / join / percolate /
    more_like_this kinds (here the reference's 400s on an index without
    such fields, or its page) and a `_geo_distance` sort's `nested`
    option, which the reference does not read."""
    from opensearch_tpu.rest.client import ApiError as RefApiError
    from opensearch_tpu_torch import ApiError, NotPortedError
    from opensearch_tpu_torch.search import aggregations as A
    from opensearch_tpu_torch.search import query_dsl as dsl
    for kind in ("geo_distance", "geo_bounding_box", "geo_polygon",
                 "geo_shape", "nested", "has_child", "has_parent",
                 "parent_id", "percolate", "more_like_this"):
        assert kind not in dsl.REFERENCE_KINDS
    assert "span_or" in dsl.REFERENCE_KINDS
    assert {"geo_distance", "geohash_grid", "geotile_grid", "geo_bounds",
            "geo_centroid", "nested", "reverse_nested", "children",
            "parent"} <= A.PORTED_KINDS
    with pytest.raises(NotPortedError, match="star_tree"):
        RestClient(device="cpu").indices.create("y", {"mappings": {
            "properties": {"v": {"type": "star_tree"}}}})
    for ftype in ("integer_range", "long_range", "float_range",
                  "double_range", "date_range", "ip_range", "flat_object",
                  "annotated_text", "geo_point", "geo_shape", "nested",
                  "join", "percolator"):
        RestClient(device="cpu").indices.create("y", {"mappings": {
            "properties": {"v": {"type": ftype}}}})
    pair = (RefClient(), RestClient(device="cpu"))
    for c in pair:
        c.index("t", {"body": "x", "loc": [0, 0]}, id="1", refresh=True)
    for kind, body in (("nested", {"path": "p", "query": {"match_all": {}}}),
                       ("has_child", {"type": "c",
                                      "query": {"match_all": {}}}),
                       ("percolate", {"field": "q", "document": {}})):
        errs = []
        for c in pair:
            with pytest.raises((RefApiError, ApiError)) as e:
                c.search("t", {"query": {kind: body}})
            errs.append((e.value.status, e.value.err_type, e.value.reason))
        assert errs[0] == errs[1] and errs[0][0] == 400, errs
    for body in ({"query": {"more_like_this": {"like": "x"}}},
                 {"sort": [{"_geo_distance": {
                     "loc": [0, 0], "nested": {"path": "p"}}}]}):
        got, want = (c.search("t", body) for c in pair[::-1])
        assert strip_took(got) == strip_took(want)


def test_geo_and_range_filters_ride_b3_where_the_reference_does(
        reference_fastpath, docs):
    """A geo filter (distance, box, polygon, shape) or a range-field
    filter in a bool's filter or must_not becomes B3's filter on a
    segment without deletes, as the reference's fastpath takes it; a geo
    query at the root, a geo decay and a distance_feature take the
    general path in both."""
    from opensearch_tpu.search import fastpath as rfp
    from opensearch_tpu_torch.search import compiler as C
    from opensearch_tpu_torch.search import fastpath
    from tests.test_torch_bool import ROUTES, _route_counts
    mapping = copy.deepcopy(MAPPING)
    mapping["properties"]["valid"] = {"type": "date_range"}
    rows = []
    for i, d in enumerate(docs):
        d = copy.deepcopy(d)
        d["valid"] = {"gte": 1735689600000 + i * 86400000,
                      "lt": 1735689600000 + (i + 30) * 86400000}
        rows += [{"index": {"_index": "g", "_id": f"d{i}"}}, d]
    ref, port = RefClient(), RestClient(device="cpu")
    for c in (ref, port):
        c.indices.create("g", {"settings": dict(SETTINGS),
                               "mappings": copy.deepcopy(mapping)})
        c.bulk(copy.deepcopy(rows), refresh=True)
    match = {"match": {"body": "cafe park"}}
    dist = {"geo_distance": {"distance": "60km", "loc": "48.85,2.35"}}
    cases = [
        ({"bool": {"must": [match], "filter": [dist]}}, True),
        ({"bool": {"must": [match], "must_not": [{"geo_bounding_box": {
            "loc": {"top": 49.5, "left": 1.5, "bottom": 48.0,
                    "right": 3.0}}}]}}, True),
        ({"bool": {"must": [match], "filter": [{"geo_polygon": {
            "loc": {"points": POLY6}}}]}}, True),
        ({"bool": {"must": [match], "filter": [{"geo_shape": {
            "area": {"shape": ENV_NYC}}}]}}, True),
        ({"bool": {"must": [match], "filter": [{"range": {"valid": {
            "gte": "2025-03-01", "lte": "2025-03-10",
            "relation": "within"}}}]}}, True),
        (dist, False),
        ({"function_score": {"query": match, "gauss": {"loc": {
            "origin": "48.85,2.35", "scale": "20km"}}}}, False),
        ({"bool": {"must": [match], "should": [{"distance_feature": {
            "field": "loc", "origin": "48.85,2.35", "pivot": "10km"}}]}},
         False),
    ]
    for query, b3 in cases:
        del reference_fastpath[:]
        pbefore = dict(fastpath.STATS)
        rbefore = rfp.STATS["bool_served"]
        gbefore = C.STATS["general_served"]
        want = strip_took(ref.search("g", {"query": query}))
        got = strip_took(port.search("g", {"query": query}))
        same(got, want, str(query))
        routes = {r: fastpath.STATS[r] - pbefore[r] for r in ROUTES}
        assert routes == _route_counts(reference_fastpath), query
        assert (fastpath.STATS["bool_served"] - pbefore["bool_served"]
                == rfp.STATS["bool_served"] - rbefore == int(b3)), query
        assert (C.STATS["general_served"] - gbefore > 0) == (not b3), query


# ---------------------------------------------------------------------
# chip_smoke phase 20's classes and brute force, phase 4's geo index
# ---------------------------------------------------------------------

def test_phase20_classes_match_brute_force(bench_small):
    """Phase 20's pages over a 3,000-passage bench corpus with
    `location` and `valid` attached to its segment (which has deletes)
    and the re-indexed docs' segment (which holds neither field): every
    class == GeoOracle, the docs in the haversine band counted."""
    import chip_smoke
    _ref, _port, port2, ix2, big = bench_small
    eng = port2._indices["bench"].engine
    big = dict(big, client=port2, seg=eng.segments[0])
    att = chip_smoke.geo_attach(big, 0)
    g = att.pop("arrays")
    oracle = chip_smoke.GeoOracle(g, ix2)
    classes = chip_smoke.geo_classes(big, g, chip_smoke.GEO_QUERIES,
                                     np.random.default_rng([0, 20]))
    hits, band = {}, 0
    for name, items in classes.items():
        for body, spec in items:
            got = port2.search("bench", copy.deepcopy(body))
            band += chip_smoke.geo_check(oracle, name, spec, got,
                                         f"{name} {body}")
            hits[name] = hits.get(name, 0) + got["hits"]["total"]["value"]
    print(f"phase 20 small: {band} docs in the haversine band; {hits}")
    assert hits["b_viewport"] > 0 and hits["e_panel"] > 0
    assert hits["f_valid"] > 0 and hits["d_near"] > 0
    # (a)'s and (c)'s filters alone (their 2-term matches are rare at
    # 3,000 passages): totals == the brute force's masks
    for body, spec in classes["a_locator"] + classes["c_zone"]:
        flt = {"query": {"bool": {
            "filter": body["query"]["bool"]["filter"]}}, "size": 0}
        got = port2.search("bench", flt)["hits"]["total"]["value"]
        if "radius" in spec:
            every = np.arange(ix2.n)
            m = oracle.dist(*spec["origin"], every) <= np.float32(
                spec["radius"])
            slack = int((oracle.band(*spec["origin"], [spec["radius"]],
                                     every) & ix2.live).sum())
        elif spec["shape"]:
            m, near = oracle.within_ring(*spec["ring"])
            slack = int((near & ix2.live).sum())
        else:
            m, slack = oracle.ray_cast(*spec["ring"]), 0
        want = int((m & ix2.live).sum())
        assert want > 0 and abs(got - want) <= slack, (spec, got, want)


def test_phase4_geo_index_matches_reference(tmp_path):
    """chip_smoke phase 4's index of every new family on the CPU: its
    pages == the reference's on the same documents (within the geo
    tolerances), and the recovered pages == the first ones."""
    import chip_smoke
    docs = chip_smoke.geo_small_docs(np.random.default_rng(13), 400)
    bodies = chip_smoke.geo_small_bodies()
    out, _t = chip_smoke.geo_small_run("cpu", docs, bodies, str(tmp_path))
    assert [strip_took(r) for r in out[1]] == [strip_took(r)
                                              for r in out[0]]
    ref = RefClient(node=Node(mesh_service=False))
    ref.indices.create("geo", {"settings": dict(SETTINGS), "mappings":
                               copy.deepcopy(chip_smoke.GEO_SMALL_MAPPING)})
    ref.indices.create("zones", {"settings": dict(SETTINGS), "mappings": {
        "properties": {"zone": {"type": "geo_shape"}}}})
    ref.index("zones", {"zone": {"type": "envelope", "coordinates": [
        [-74.6, 41.2], [-73.4, 40.2]]}}, id="nyc", refresh=True)
    cut = len(docs) * 5 // 8
    for a, b in ((0, cut), (cut, len(docs))):
        ref.bulk(sum([[{"index": {"_index": "geo", "_id": f"d{i}"}},
                       copy.deepcopy(docs[i])] for i in range(a, b)], []),
                 refresh=True)
    ref.bulk([{"delete": {"_index": "geo", "_id": f"d{i}"}}
              for i in range(0, len(docs), 97)], refresh=True)
    for body, got in zip(bodies, out[0]):
        same(strip_took(got), strip_took(ref.search("geo",
                                                    copy.deepcopy(body))),
             str(body))
