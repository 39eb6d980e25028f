"""The range family, flat_object and annotated_text in the port against
the JAX package on the CPU.

- One index maps the six range types (`integer_range`, `long_range`,
  `float_range`, `double_range`, `date_range` with its `format`,
  `ip_range`), a `flat_object` (nested leaves and arrays), an
  `annotated_text` (markup, several values to a term, URL-encoded values,
  overlapping spans) and a text `body`. The same seeded documents (numpy
  seed 29: 400 docs) go through both packages' RestClient (the
  reference's on a node without a mesh service, 0 replicas) in two
  segments, the first with deletes.
- The same bodies give the same responses, `took` aside: `range` with
  each `relation` (intersects, within, contains) and open or closed
  bounds on every range type, a term's containment, `exists`, range
  filters in bools; a dotted flat_object path (`attrs.color`, the
  `color=<v>` term on `attrs#paths`), the bare field's leaf values,
  `exists` on a leaf path, terms aggs on the field; annotation terms at
  the covered token's position (term, phrase), and the highlight over
  the raw value as the reference renders it; through search and
  msearch, after a forcemerge, and after a flush and a recovery.
- The reference's 400s: a lower bound above the upper, an unknown bound,
  a non-object range or flat_object value, an IPv6 ip_range bound.
- `segment_from_arrays` carries a reference segment's `#lo` / `#hi`
  columns.

Range relations compare in the member type's column form (i64 for
integer / long / date / ip, the f32 view for float / double, as the
reference's float ranges read it), so every answer is exact: the
tolerance is equality, but for BM25 scores over the annotated field
within SCORE_RTOL = 1e-6 relative (the reference's fused program rounds
them in another order, as in the earlier slices).
"""

import copy

import jax
import numpy as np
import pytest

from chip_smoke import strip_took
from opensearch_tpu.cluster.node import Node
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu_torch import RestClient
from opensearch_tpu_torch.index.convert import segment_from_arrays
from opensearch_tpu_torch.index.mappings import Mappings

jax.config.update("jax_platforms", "cpu")

SCORE_RTOL = 1e-6
NDOCS = 400
SPLIT = 260
DELETED = ("d2", "d30", "d31", "d259", "d333")
SETTINGS = {"number_of_replicas": 0}
MAPPING = {"properties": {
    "body": {"type": "text"},
    "ir": {"type": "integer_range"}, "lr": {"type": "long_range"},
    "fr": {"type": "float_range"}, "dr": {"type": "double_range"},
    "when": {"type": "date_range", "format": "yyyy-MM-dd"},
    "ips": {"type": "ip_range"},
    "attrs": {"type": "flat_object"},
    "note": {"type": "annotated_text"}}}
WORDS = ["apple", "berry", "cherry", "date", "elder", "fig", "grape"]
DAY = 86_400_000
T0 = 1_735_689_600_000              # 2025-01-01


def _bounds(rng, lo, hi):
    """A range object with a random mix of open and closed bounds."""
    out = {}
    out["gt" if rng.random() < 0.3 else "gte"] = lo
    if rng.random() < 0.9:
        out["lt" if rng.random() < 0.3 else "lte"] = hi
    return out


def make_docs(n: int = NDOCS, seed: int = 29) -> list:
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        a = int(rng.integers(-50, 50))
        b = a + int(rng.integers(1, 40))
        fa = round(float(rng.normal(0, 10)), 3)
        t = T0 + int(rng.integers(0, 365)) * DAY
        ip = int(rng.integers(0, 200))
        d = {"body": " ".join(rng.choice(WORDS, 3)),
             "ir": _bounds(rng, a, b),
             "lr": _bounds(rng, a * 10**12, b * 10**12),
             "fr": _bounds(rng, fa, fa + float(rng.random() * 5)),
             "dr": {"gte": fa, "lte": fa + 2.5},
             "when": {"gte": t, "lt": t + int(rng.integers(1, 90)) * DAY},
             "ips": {"gte": f"10.0.0.{ip}",
                     "lte": f"10.0.{int(rng.integers(0, 3))}.{ip + 50}"},
             "attrs": {"color": str(rng.choice(["red", "blue", "Green"])),
                       "size": {"w": int(rng.integers(1, 5)),
                                "h": [int(rng.integers(1, 5)), 7]},
                       "tags": ["x", {"deep": str(rng.choice(WORDS))}]},
             "note": (f"the [{rng.choice(WORDS)} pie](Food&Dessert) from "
                      f"[Acme Corp](Acme%20Corp&org) is "
                      f"{rng.choice(WORDS)}")}
        if i % 7 == 0:
            del d["ir"], d["when"]
        if i % 11 == 0:
            d["fr"] = [d["fr"], {"gte": 100.0, "lte": 101.0}]
            del d["attrs"]
        if i % 13 == 0:
            d["note"] = ["plain [two words](Two) here",
                         "[overlap [inner](In) text](Out) tail"]
        docs.append(d)
    return docs


def fill(c, docs, index="r"):
    c.indices.create(index, {"settings": copy.deepcopy(SETTINGS),
                             "mappings": copy.deepcopy(MAPPING)})
    for a, b in ((0, SPLIT), (SPLIT, len(docs))):
        c.bulk(sum([[{"index": {"_index": index, "_id": f"d{i}"}},
                     copy.deepcopy(docs[i])] for i in range(a, b)], []),
               refresh=True)
    c.bulk([{"delete": {"_index": index, "_id": d}} for d in DELETED],
           refresh=True)
    return c


def rq(field, relation=None, **bounds):
    spec = dict(bounds)
    if relation:
        spec["relation"] = relation
    return {"query": {"range": {field: spec}}, "size": 50}


BODIES = [
    rq("ir", gte=0, lte=10), rq("ir", "within", gte=-20, lte=30),
    rq("ir", "contains", gte=5, lte=8), rq("ir", "INTERSECTS", gt=40),
    rq("ir", "within", lt=0), rq("ir", "contains", gte=12, lt=13),
    rq("lr", gte=10**13, lte=2 * 10**13),
    rq("lr", "within", gte=-10**14, lt=10**14),
    rq("lr", "contains", gte=0, lte=10**12),
    rq("fr", gte=0.5, lte=1.5), rq("fr", "within", gte=-5.0, lte=5.0),
    rq("fr", "contains", gt=1.0, lt=1.25), rq("fr", "contains", gte=100.5),
    rq("dr", gte=2.0, lte=2.0), rq("dr", "within", gt=-10.0, lt=10.0),
    rq("dr", "contains", gte=0.1, lte=0.2),
    rq("when", gte="2025-03-01", lte="2025-03-31"),
    rq("when", "within", gte="2025-06-01", lt="2025-09-01"),
    rq("when", "contains", gte="2025-05-05", lte="2025-05-06"),
    rq("ips", gte="10.0.0.40", lte="10.0.0.60"),
    rq("ips", "within", gte="10.0.0.0", lte="10.0.0.255"),
    rq("ips", "contains", gte="10.0.0.120", lte="10.0.0.121"),
    {"query": {"term": {"ir": 7}}, "size": 50},
    {"query": {"term": {"fr": 1.25}}, "size": 50},
    {"query": {"term": {"when": "2025-04-01"}}, "size": 50},
    {"query": {"term": {"ips": "10.0.0.77"}}, "size": 50},
    {"query": {"exists": {"field": "ir"}}, "size": 5},
    {"query": {"exists": {"field": "when"}}, "size": 5},
    {"query": {"bool": {"must": [{"match": {"body": "apple"}}],
                        "filter": [{"range": {"when": {
                            "gte": "2025-02-01", "lte": "2025-04-01",
                            "relation": "intersects"}}}],
                        "must_not": [{"range": {"ir": {
                            "gte": 0, "lte": 5}}}]}}},
    {"query": {"constant_score": {"filter": {"range": {"lr": {
        "gte": 0, "relation": "within"}}}, "boost": 3.0}}, "size": 30},
    {"query": {"term": {"attrs.color": "red"}}, "size": 50},
    {"query": {"term": {"attrs.color": "Green"}}, "size": 50},
    {"query": {"terms": {"attrs.size.w": [1, 4]}}, "size": 50},
    {"query": {"term": {"attrs.size.h": 7}}, "size": 5},
    {"query": {"term": {"attrs.tags.deep": "fig"}}, "size": 50},
    {"query": {"term": {"attrs": "blue"}}, "size": 50},
    {"query": {"match": {"attrs.color": "red"}}, "size": 50},
    {"query": {"exists": {"field": "attrs.size.w"}}, "size": 5},
    {"query": {"exists": {"field": "attrs"}}, "size": 5},
    {"query": {"bool": {"must": [{"match": {"body": "grape"}}],
                        "filter": [{"term": {"attrs.color": "blue"}}]}}},
    {"size": 0, "aggs": {"a": {"terms": {"field": "attrs", "size": 20}},
                         "c": {"cardinality": {"field": "attrs"}}}},
    {"query": {"match": {"note": "pie"}}, "size": 50},
    {"query": {"match": {"note": "acme corp"}}, "size": 50},
    {"query": {"term": {"note": "Dessert"}}, "size": 50},
    {"query": {"term": {"note": "Acme Corp"}}, "size": 50},
    {"query": {"term": {"note": "Out"}}, "size": 50},
    {"query": {"match_phrase": {"note": "from acme"}}, "size": 50},
    {"query": {"match_phrase": {"note": "the Food"}}, "size": 50},
    {"query": {"exists": {"field": "note"}}, "size": 5},
    {"query": {"match": {"note": "pie"}}, "size": 5,
     "highlight": {"fields": {"note": {}}}},
    {"query": {"match": {"note": "inner"}}, "size": 5,
     "highlight": {"fields": {"note": {"type": "unified"}}}},
    {"query": {"query_string": {"query": "elder"}}, "size": 10},
]


def same(got, want, path="") -> None:
    """Equal, `took` stripped; a score within SCORE_RTOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and isinstance(got, float) and \
            path.endswith(("._score", ".max_score")):
        assert abs(got - want) <= SCORE_RTOL * abs(want), (path, got, want)
    else:
        assert got == want, (path, got, want)


def check(ref, port, body, index="r"):
    want = strip_took(ref.search(index, copy.deepcopy(body)))
    got = strip_took(port.search(index, copy.deepcopy(body)))
    same(got, want, str(body))


@pytest.fixture(scope="module")
def docs():
    return make_docs()


@pytest.fixture(scope="module")
def clients(docs):
    ref = fill(RefClient(node=Node(mesh_service=False)), docs)
    port = fill(RestClient(device="cpu"), docs)
    return ref, port


@pytest.mark.parametrize("i", range(len(BODIES)))
def test_range_flat_annotated_bodies_match_reference(clients, i):
    ref, port = clients
    segs = port._indices["r"].engine.segments
    assert len(segs) == 2 and segs[0].live_count < segs[0].ndocs
    check(ref, port, BODIES[i])


def test_range_bodies_in_msearch(clients):
    ref, port = clients
    lines = sum([[{}, copy.deepcopy(b)] for b in BODIES[:30]], [])
    got = port.msearch(lines, index="r")["responses"]
    want = ref.msearch(lines, index="r")["responses"]
    for g, w, b in zip(got, want, lines[1::2]):
        same(strip_took(g), strip_took(w), str(b))


def test_range_columns_are_the_references(clients):
    ref, port = clients
    for seg, rseg in zip(port._indices["r"].engine.segments,
                         ref.node.indices["r"].shards[0].segments):
        for f in ("ir", "lr", "fr", "dr", "when", "ips"):
            for side in ("#lo", "#hi"):
                pc, rc = seg.numeric_cols[f + side], rseg.numeric_cols[f + side]
                assert pc.kind == rc.kind
                np.testing.assert_array_equal(pc.values, rc.values)
                np.testing.assert_array_equal(pc.present, rc.present)
        for f in ("attrs", "attrs#paths"):
            assert seg.keyword_cols[f].vocab == rseg.keyword_cols[f].vocab
            assert seg.postings[f].vocab == rseg.postings[f].vocab
        pb, rpb = seg.postings["note"], rseg.postings["note"]
        assert pb.vocab == rpb.vocab
        np.testing.assert_array_equal(pb.positions, rpb.positions)
        np.testing.assert_array_equal(pb.tfs, rpb.tfs)


def test_range_fields_after_forcemerge_and_recovery(docs, tmp_path):
    ref = fill(RefClient(node=Node(mesh_service=False)), docs)
    port = fill(RestClient(device="cpu", data_path=str(tmp_path)), docs)
    for c in (ref, port):
        c.indices.forcemerge("r", max_num_segments=1)
    for body in BODIES:
        check(ref, port, body)
    port.indices.flush("r")
    port.close()
    back = RestClient(device="cpu", data_path=str(tmp_path))
    assert back.indices.get_mapping("r") == port.indices.get_mapping("r")
    for body in BODIES[::2]:
        check(ref, back, body)


BAD_DOCS = [
    {"ir": {"gte": 10, "lte": 5}}, {"ir": {"gte": 1, "between": 5}},
    {"ir": 5}, {"when": {"gte": "yesterday"}},
    {"ips": {"gte": "2001:db8::1"}}, {"fr": {"gte": "x"}},
    {"attrs": "flat"}, {"attrs": ["flat"]},
]


@pytest.mark.parametrize("doc", BAD_DOCS, ids=str)
def test_malformed_range_and_flat_documents_are_the_references_errors(doc):
    errs = []
    for c in (RefClient(node=Node(mesh_service=False)),
              RestClient(device="cpu")):
        c.indices.create("r", {"settings": dict(SETTINGS),
                               "mappings": copy.deepcopy(MAPPING)})
        with pytest.raises(Exception) as e:
            c.index("r", copy.deepcopy(doc), id="1")
        errs.append(e.value)
    assert type(errs[1]).__name__ == type(errs[0]).__name__, errs
    assert str(errs[1]) == str(errs[0])


@pytest.mark.parametrize("q", [
    {"range": {"ir": {"gte": "ten"}}},
    {"range": {"when": {"gte": "not a date"}}},
    {"range": {"ips": {"gte": "10.0.0.300"}}},
    {"term": {"ir": "x"}},
], ids=str)
def test_malformed_range_queries_are_the_references_errors(clients, q):
    ref, port = clients
    errs = []
    for c in (ref, port):
        with pytest.raises(Exception) as e:
            c.search("r", {"query": copy.deepcopy(q)})
        errs.append(e.value)
    assert type(errs[1]).__name__ == type(errs[0]).__name__, errs
    assert str(errs[1]) == str(errs[0])


def test_segment_from_arrays_carries_range_columns(clients):
    ref, _port = clients
    rseg = ref.node.indices["r"].shards[0].segments[1]
    postings = {f: {"vocab": pb.vocab, "starts": pb.starts,
                    "doc_ids": pb.doc_ids, "tfs": pb.tfs,
                    "pos_starts": pb.pos_starts, "positions": pb.positions}
                for f, pb in rseg.postings.items()}
    stats = {f: (s.doc_count, s.sum_dl) for f, s in rseg.text_stats.items()}
    seg = segment_from_arrays(
        "_0", rseg.ndocs, postings, rseg.doc_lens, stats, list(rseg.ids),
        list(rseg.sources), numeric_cols=rseg.numeric_cols,
        keyword_cols=rseg.keyword_cols)
    c = RestClient(device="cpu")
    c.indices.create("r", {"mappings": copy.deepcopy(MAPPING)})
    c._indices["r"].engine.segments.append(seg)
    ref2 = RefClient(node=Node(mesh_service=False))
    ref2.indices.create("r", {"settings": dict(SETTINGS),
                              "mappings": copy.deepcopy(MAPPING)})
    ref2.bulk(sum([[{"index": {"_index": "r", "_id": rseg.ids[i]}},
                    rseg.sources[i]] for i in range(rseg.ndocs)], []),
              refresh=True)
    for body in BODIES[:30]:
        check(ref2, c, body)


def test_mapping_parse_of_each_family_is_the_references():
    from opensearch_tpu.index.mappings import Mappings as RefMappings
    for doc in make_docs(60, seed=3):
        got = Mappings(copy.deepcopy(MAPPING)).parse("1", doc)
        want = RefMappings(copy.deepcopy(MAPPING)).parse("1", doc)
        assert got.terms == want.terms
        assert got.positions == want.positions
        assert got.numerics == want.numerics
        assert got.keywords == want.keywords
