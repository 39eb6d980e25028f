"""The scalar field types, the field parameters and dynamic templates in
the port against the JAX package on the CPU.

- One index names every type of the slice (`short`, `byte`,
  `half_float`, `scaled_float`, `unsigned_long`, `token_count`, `ip`,
  `constant_keyword`, `icu_collation_keyword`, `match_only_text`,
  `search_as_you_type`, `binary`, `alias`), an `english` text field, a
  custom analyzer with a char filter and a custom tokenizer, a custom
  normalizer, `store`, `copy_to`, `null_value`, `boost` and a dynamic
  template. The same seeded documents (numpy seed 17: 600 docs) go
  through both packages' RestClient (the reference's on a node without a
  mesh service, 0 replicas) in two segments, the first with deletes.
- The same bodies (term / terms / CIDR / range / match / phrase / exists /
  sort / docvalue_fields / stored_fields / ip_range / terms on an ip /
  multi_match bool_prefix over search_as_you_type / an english match,
  pruned and with exact totals) give the same responses, `took` aside,
  through search and msearch, then after a forcemerge, then after a
  flush and a recovery.
- The reference's errors as its 400s: a `short` out of range, a
  `scaled_float` without a factor, a second `constant_keyword` value, an
  unknown analyzer.
- Queue 3 decisions pinned here: an IPv6 address outside ::ffff:0:0/96 (the
  reference accepts the document and its refresh fails with an
  OverflowError; the port refuses the document with a 400); `terms` on an
  ip field has no buckets in either (the reference keeps no keyword doc
  values for an ip); docvalue_fields and sort values of an ip are its
  integer in both.

The tolerance is exact equality throughout, but for the two float kinds
the earlier slices hold within a tolerance (`same`): a phrase score within
1e-6 relative (the reference's fused XLA program rounds its BM25 in
another order; a merged `english` title shows it) and an aggregation's
f32 sums within 1e-5 relative.
"""

import copy

import jax
import numpy as np
import pytest

from chip_smoke import strip_took
from tests.test_torch_compound import bench_small  # noqa: F401
from opensearch_tpu.cluster.node import Node
from opensearch_tpu.index.mappings import Mappings as RefMappings
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu_torch import RestClient
from opensearch_tpu_torch.index.convert import segment_from_arrays
from opensearch_tpu_torch.index.mappings import Mappings, U64_BIAS

jax.config.update("jax_platforms", "cpu")

SCORE_RTOL = 1e-6
AGG_RTOL = 1e-5
NDOCS = 600
SPLIT = 400
DELETED = ("d3", "d50", "d51", "d399", "d450")
SETTINGS = {"number_of_replicas": 0, "analysis": {
    "char_filter": {"amp": {"type": "mapping", "mappings": ["& => and"]}},
    "tokenizer": {"dash": {"type": "pattern", "pattern": "[-\\s]+"}},
    "filter": {"short": {"type": "length", "min": 2}},
    "analyzer": {"chain": {"type": "custom",
                           "char_filter": ["html_strip", "amp"],
                           "tokenizer": "dash",
                           "filter": ["lowercase", "asciifolding", "short",
                                      "porter_stem"]}},
    "normalizer": {"fold": {"type": "custom",
                            "filter": ["lowercase", "asciifolding"]}}}}
MAPPING = {
    "dynamic_templates": [{"strs": {"match": "dyn_*",
                                    "mapping": {"type": "keyword"}}}],
    "properties": {
        "title": {"type": "text", "analyzer": "english", "copy_to": "all"},
        "all": {"type": "text"},
        "body": {"type": "text", "analyzer": "chain", "boost": 2.0},
        "tag": {"type": "keyword", "normalizer": "fold",
                "null_value": "none", "store": True},
        "addr": {"type": "ip", "store": True},
        "stock": {"type": "short", "null_value": 0},
        "grade": {"type": "byte"},
        "hf": {"type": "half_float"},
        "price": {"type": "scaled_float", "scaling_factor": 100,
                  "store": True},
        "views": {"type": "unsigned_long"},
        "ntok": {"type": "token_count", "analyzer": "standard"},
        "shop": {"type": "constant_keyword", "value": "acme"},
        "coll": {"type": "icu_collation_keyword", "strength": "primary"},
        "mot": {"type": "match_only_text"},
        "sayt": {"type": "search_as_you_type"},
        "blob": {"type": "binary"},
        "price_alias": {"type": "alias", "path": "price"}}}
WORDS = ["running", "runs", "quick", "foxes", "jumped", "the", "lazy",
         "dogs", "café", "Résumé", "shoes", "kennel", "john's", "is"]


def make_docs(n: int = NDOCS, seed: int = 17) -> list:
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        d = {"title": " ".join(rng.choice(WORDS, int(rng.integers(2, 7)))),
             "body": "<b>" + "-".join(rng.choice(WORDS, 3)) + "</b> & x",
             "tag": (None if i % 7 == 0
                     else str(rng.choice(["Café", "CAFE", "tea", "Tea"]))),
             "addr": f"10.{i % 3}.{(i // 3) % 5}.{i % 250}",
             "stock": None if i % 11 == 0 else int(rng.integers(-300, 300)),
             "grade": int(rng.integers(-100, 100)),
             "hf": float(rng.random()),
             "price": float(rng.random() * 100),
             "views": int(rng.integers(0, 1 << 62))
             + (U64_BIAS if i % 3 == 0 else 0),
             "ntok": " ".join(rng.choice(WORDS, int(rng.integers(1, 6)))),
             "coll": str(rng.choice(["Apple", "apple", "Äpple", "banana"])),
             "mot": " ".join(rng.choice(WORDS, 5)),
             "sayt": " ".join(rng.choice(WORDS, 4)),
             "blob": "aGVsbG8=",
             "dyn_x": f"v{i % 4}"}
        if i % 13 == 0:
            for f in ("addr", "price", "views", "mot", "grade"):
                del d[f]
        if i % 17 == 0:
            d["addr"] = [d.get("addr", "10.9.9.9"), "192.168.0.1"]
        docs.append(d)
    return docs


def fill(c, docs, index="t"):
    c.indices.create(index, {"settings": copy.deepcopy(SETTINGS),
                             "mappings": copy.deepcopy(MAPPING)})
    for a, b in ((0, SPLIT), (SPLIT, len(docs))):
        c.bulk(sum([[{"index": {"_index": index, "_id": f"d{i}"}},
                     copy.deepcopy(docs[i])] for i in range(a, b)], []),
               refresh=True)
    c.bulk([{"delete": {"_index": index, "_id": d}} for d in DELETED],
           refresh=True)
    return c


BODIES = [
    {"query": {"term": {"addr": "10.1.1.1"}}},
    {"query": {"term": {"addr": "10.1.0.0/16"}}},
    {"query": {"term": {"addr": "192.168.0.0/24"}}},
    {"query": {"term": {"addr": "2001:db8::/32"}}},
    {"query": {"terms": {"addr": ["10.2.0.0/16", "10.0.0.5"]}}},
    {"query": {"range": {"addr": {"gte": "10.1.0.0", "lt": "10.2.0.0"}}}},
    {"query": {"term": {"stock": 0}}},
    {"query": {"terms": {"grade": [5, -7, 99]}}},
    {"query": {"range": {"stock": {"gte": -10, "lte": 100}}}},
    {"query": {"range": {"grade": {"gt": 50}}}},
    {"query": {"range": {"hf": {"lt": 0.25}}}},
    {"query": {"range": {"price": {"gte": 10.5, "lte": 60}}}},
    {"query": {"range": {"price_alias": {"gte": 90}}}},
    {"query": {"match": {"price": 10.5}}},
    {"query": {"range": {"views": {"gte": U64_BIAS}}}},
    {"query": {"range": {"views": {"lt": 1 << 61}}}},
    {"query": {"term": {"ntok": 3}}},
    {"query": {"range": {"ntok": {"gte": 4}}}},
    {"query": {"match": {"title": "run fox"}}},
    {"query": {"match": {"title": {"query": "running foxes",
                                   "operator": "and"}}}},
    {"query": {"match": {"title": "the john's kennels"}},
     "track_total_hits": True},
    {"query": {"match": {"title": "running shoes kennel"}}, "size": 5},
    {"query": {"match": {"all": "runs"}}},
    {"query": {"match": {"body": "running"}}},
    {"query": {"match_phrase": {"title": "quick foxes"}}},
    {"query": {"term": {"tag": "CAFÉ"}}},
    {"query": {"term": {"tag": "none"}}},
    {"query": {"term": {"coll": "APPLE"}}},
    {"query": {"term": {"shop": "acme"}}},
    {"query": {"range": {"coll": {"gte": "b"}}}},
    {"query": {"match_phrase": {"mot": "quick foxes"}}},
    {"query": {"match_phrase": {"mot": {"query": "quick the", "slop": 2}}}},
    {"query": {"match": {"mot": "quick"}}},
    {"query": {"bool": {"must": [{"match": {"title": "runs"}}],
                        "filter": [{"match_phrase": {"mot": "lazy dogs"}}]}}},
    {"query": {"exists": {"field": "addr"}}},
    {"query": {"exists": {"field": "views"}}},
    {"query": {"exists": {"field": "mot"}}},
    {"query": {"exists": {"field": "tag"}}},
    {"query": {"exists": {"field": "blob"}}},
    {"query": {"term": {"dyn_x": "v1"}}},
    {"query": {"multi_match": {"query": "quick fo", "type": "bool_prefix",
                               "fields": ["sayt", "sayt._2gram",
                                          "sayt._3gram"]}}},
    {"query": {"match": {"sayt._index_prefix": "ken"}}},
    {"query": {"match_all": {}}, "sort": [{"views": "desc"}],
     "docvalue_fields": ["addr", "views", "price", "stock", "coll", "shop",
                         "ntok"]},
    {"query": {"match_all": {}}, "sort": [{"addr": "asc"},
                                          {"price": "desc"}], "size": 20},
    {"query": {"match_all": {}}, "sort": [{"views": {"order": "asc",
                                                     "missing": "_first"}}]},
    {"query": {"match": {"title": "dogs"}}, "stored_fields": ["tag", "price",
                                                              "addr"]},
    {"query": {"match": {"title": "dogs"}}, "stored_fields": ["tag"],
     "_source": ["title"]},
    {"query": {"match": {"title": "dogs"}},
     "highlight": {"fields": {"title": {}, "mot": {}, "sayt": {}}}},
    {"query": {"match": {"mot": "lazy"}},
     "highlight": {"fields": {"mot": {}}}},
    {"size": 0, "aggs": {
        "r": {"ip_range": {"field": "addr", "ranges": [
            {"to": "10.1.0.0"}, {"from": "10.1.0.0"},
            {"mask": "10.2.0.0/16"},
            {"key": "lan", "from": "192.168.0.0", "to": "192.169.0.0"}]},
            "aggs": {"p": {"avg": {"field": "price"}}}},
        "t": {"terms": {"field": "addr"}},
        "s": {"stats": {"field": "price"}},
        "v": {"stats": {"field": "views"}},
        "g": {"terms": {"field": "coll"}},
        "k": {"terms": {"field": "shop"}},
        "h": {"histogram": {"field": "stock", "interval": 100}},
        "n": {"avg": {"field": "ntok"}}}},
    {"size": 0, "query": {"match": {"title": "quick"}}, "aggs": {
        "r": {"ip_range": {"field": "addr", "ranges": [
            {"mask": "10.0.0.0/8"}]}},
        "m": {"max": {"field": "views"}}}},
]


def same(got, want, path="", in_aggs=False) -> None:
    """Equal, `took` stripped, but for two float kinds held as the earlier
    slices hold them: a score within SCORE_RTOL (the reference's fused XLA
    program rounds a phrase's BM25 in another order than the port's
    ops, tests/test_torch_phrase.py) and an aggregation's float within
    AGG_RTOL (f32 sums in another order, tests/test_torch_aggs.py)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            same(got[k], want[k], f"{path}.{k}",
                 in_aggs or k == "aggregations")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}[{i}]", in_aggs)
    elif isinstance(want, float) and isinstance(got, float) and (
            in_aggs or path.endswith(("._score", ".max_score"))):
        rtol = AGG_RTOL if in_aggs else SCORE_RTOL
        assert abs(got - want) <= rtol * abs(want), (path, got, want)
    else:
        assert got == want, (path, got, want)


def _check(ref, port, bodies=BODIES, index="t"):
    for body in bodies:
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
def test_bodies_match_reference(clients, i):
    ref, port = clients
    _check(ref, port, [BODIES[i]])


def test_msearch_matches_reference(clients):
    ref, port = clients
    lines = []
    for b in BODIES[:20]:
        lines += [{"index": "t"}, copy.deepcopy(b)]
    want = [strip_took(r) for r in ref.msearch(copy.deepcopy(lines))[
        "responses"]]
    got = [strip_took(r) for r in port.msearch(lines)["responses"]]
    same(got, want)


def test_forcemerge_matches_reference(docs):
    ref = fill(RefClient(node=Node(mesh_service=False)), docs)
    port = fill(RestClient(device="cpu"), docs)
    for c in (ref, port):
        c.indices.forcemerge("t", max_num_segments=1)
    seg = port._indices["t"].engine.segments
    assert len(seg) == 1 and seg[0].stored_vals is not None
    assert seg[0].numeric_cols["views"].kind == "uint"
    _check(ref, port)


def test_flush_and_recovery_match_reference(docs, tmp_path):
    """The recovered port serves the reference's pages of the same index
    before the flush: the reference cannot recover this index (Queue 3:
    it persists `to_dict()`, which drops `scaling_factor`, and its
    recovery raises its missing-factor ValueError); the port persists
    the mapping bodies merged over it."""
    paths = {"ref": str(tmp_path / "ref"), "port": str(tmp_path / "port")}
    ref = fill(RefClient(data_path=paths["ref"]), docs)
    port = fill(RestClient(device="cpu", data_path=paths["port"]), docs)
    for c in (ref, port):
        c.index("t", {"title": "late running fox", "addr": "10.7.7.7",
                      "views": U64_BIAS + 5, "tag": "Late"}, id="late")
        c.indices.flush("t")
    port.close()
    with pytest.raises(ValueError, match="scaling_factor"):
        RefClient(data_path=paths["ref"])
    port2 = RestClient(device="cpu", data_path=paths["port"])
    _check(ref, port2)
    assert port2._indices["t"].engine.segments[0].stored_vals is not None


def test_mapping_round_trips_as_reference(clients):
    ref, port = clients
    assert port.indices.get_mapping("t") == ref.indices.get_mapping("t")


def test_parsed_documents_match_reference(docs):
    ref_m = RefMappings(copy.deepcopy(MAPPING))
    port_m = Mappings(copy.deepcopy(MAPPING))
    from opensearch_tpu.analysis import AnalysisRegistry as RA
    from opensearch_tpu_torch.analysis import AnalysisRegistry as PA
    ref_m.analysis = RA(copy.deepcopy(SETTINGS["analysis"]))
    port_m.analysis = PA(copy.deepcopy(SETTINGS["analysis"]))
    for m in (ref_m, port_m):
        m.analysis.ensure_sayt_chains(3)
    for i, d in enumerate(docs[:200]):
        r = ref_m.parse(f"d{i}", copy.deepcopy(d))
        p = port_m.parse(f"d{i}", copy.deepcopy(d))
        for attr in ("terms", "numerics", "keywords", "positions",
                     "stored"):
            assert getattr(p, attr) == getattr(r, attr), (i, attr)
    assert set(port_m.fields) == set(ref_m.fields)
    for name, ft in ref_m.fields.items():
        assert port_m.fields[name].type == ft.type
        assert set(port_m.fields[name].subfields) == set(ft.subfields)


@pytest.mark.parametrize("ftype,value", [
    ("short", 1 << 15), ("short", -(1 << 15) - 1), ("byte", 128),
    ("byte", -129), ("unsigned_long", -1), ("unsigned_long", 1 << 64),
    ("integer", 1 << 31), ("ip", "not an ip")])
def test_out_of_range_values_are_the_reference_400s(ftype, value):
    errs = []
    for c in (RefClient(node=Node(mesh_service=False)),
              RestClient(device="cpu")):
        c.indices.create("x", {"mappings": {"properties": {
            "v": {"type": ftype}}}})
        with pytest.raises(Exception) as e:
            c.index("x", {"v": value}, id="1")
        errs.append((type(e.value).__name__, str(e.value),
                     getattr(e.value, "status", None)))
        resp = c.bulk([{"index": {"_index": "x", "_id": "2"}}, {"v": value}])
        errs.append(resp["items"][0]["index"]["error"])
    assert errs[2:] == errs[:2] and errs[0][2] == 400


def test_mapping_and_document_errors_match_reference():
    def run(c):
        out = []

        def tr(f):
            try:
                out.append(("ok", strip_took(f())))
            except Exception as e:
                out.append((type(e).__name__, str(e),
                            getattr(e, "status", None)))
        tr(lambda: c.indices.create("b", {"mappings": {"properties": {
            "p": {"type": "scaled_float"}}}}))
        tr(lambda: c.indices.create("c", {"mappings": {"properties": {
            "k": {"type": "constant_keyword"}}}}))
        tr(lambda: c.index("c", {"k": "x"}, id="1"))
        tr(lambda: c.index("c", {"k": "y"}, id="2"))
        tr(lambda: c.index("c", {"other": 1}, id="3", refresh=True))
        tr(lambda: c.search("c", {"query": {"term": {"k": "x"}}}))
        tr(lambda: c.indices.create("d", {"mappings": {"properties": {
            "t": {"type": "text", "analyzer": "nope"}}}}))
        tr(lambda: c.index("d", {"t": "hello"}, id="1"))
        tr(lambda: c.indices.create("e", {"mappings": {"properties": {
            "s": {"type": "icu_collation_keyword", "strength":
                  "quaternary"}}}}))
        return out
    want = run(RefClient(node=Node(mesh_service=False)))
    got = run(RestClient(device="cpu"))
    assert got == want
    assert want[0] == ("ValueError", "Field [p] misses required parameter "
                       "[scaling_factor]", None)
    assert want[3][2] == 400 and want[7] == ("ApiError",
                                             "unknown analyzer [nope]", 400)


def test_ipv6_outside_the_mapped_range_is_refused_where_the_reference_fails():
    """Queue 3: the reference accepts 2001:db8::1 and its refresh then
    raises an OverflowError (the integer exceeds i64); the port refuses
    the document with a 400 and the index stays searchable."""
    ref = RefClient(node=Node(mesh_service=False))
    port = RestClient(device="cpu")
    for c in (ref, port):
        c.indices.create("e", {"mappings": {"properties": {
            "i": {"type": "ip"}}}})
        c.index("e", {"i": "::ffff:1.2.3.4"}, id="0")
    ref.index("e", {"i": "2001:db8::1"}, id="1")
    with pytest.raises(OverflowError):
        ref.indices.refresh("e")
    with pytest.raises(Exception, match="outside ::ffff:0:0/96") as e:
        port.index("e", {"i": "2001:db8::1"}, id="1")
    assert e.value.status == 400
    port.indices.refresh("e")
    hits = port.search("e", {"query": {"term": {"i": "1.2.3.0/24"}},
                             "docvalue_fields": ["i"]})["hits"]["hits"]
    assert [(h["_id"], h["fields"]["i"]) for h in hits] == [
        ("0", [0xFFFF01020304])]


def test_dynamic_templates_and_copy_to_map_as_reference():
    """Queue 3: a template matches by `match` alone, as the reference's
    (its `match_mapping_type` is not read: a string maps as ip here)."""
    body = {"mappings": {"dynamic_templates": [
        {"ints": {"match": "n_*", "mapping": {"type": "short"}}},
        {"addrs": {"match": "s*", "match_mapping_type": "long",
                   "mapping": {"type": "ip"}}}],
        "properties": {"a": {"type": "keyword", "copy_to": ["b", "c"]},
                       "b": {"type": "text"}}}}
    docs = [{"n_x": 5, "a": "Hello World", "s": "1.2.3.4"},
            {"n_x": 7, "a": "other"}]
    out = []
    for c in (RefClient(node=Node(mesh_service=False)),
              RestClient(device="cpu")):
        c.indices.create("d", copy.deepcopy(body))
        for i, d in enumerate(docs):
            c.index("d", copy.deepcopy(d), id=str(i), refresh=True)
        out.append((c.indices.get_mapping("d"),
                    [strip_took(c.search("d", q)) for q in (
                        {"query": {"match": {"b": "world"}}},
                        {"query": {"match": {"c": "other"}}},
                        {"query": {"term": {"s": "1.2.3.0/24"}}},
                        {"query": {"range": {"n_x": {"gte": 6}}}})]))
    assert out[1] == out[0]


def test_segment_from_arrays_takes_the_new_columns(clients):
    """convert carries a reference segment's unsigned_long column (kind
    "uint") and its stored values across."""
    ref, port = clients
    rseg = ref.node.get_index("t").shards[0].segments[0]
    pseg = port._indices["t"].engine.segments[0]
    numeric = {f: {"kind": c.kind, "values": c.values, "present": c.present}
               for f, c in pseg.numeric_cols.items()}
    postings = {f: {"vocab": pb.vocab, "starts": pb.starts,
                    "doc_ids": pb.doc_ids, "tfs": pb.tfs}
                for f, pb in pseg.postings.items()}
    seg = segment_from_arrays(
        "_c", pseg.ndocs, postings, pseg.doc_lens,
        {f: (s.doc_count, s.sum_dl) for f, s in pseg.text_stats.items()},
        list(pseg.ids), list(pseg.sources), numeric_cols=numeric,
        stored_vals=pseg.stored_vals)
    assert seg.numeric_cols["views"].kind == "uint"
    assert seg.stored_vals == pseg.stored_vals
    rcol = rseg.numeric_cols["views"]
    assert rcol.kind == "uint"
    np.testing.assert_array_equal(rcol.values,
                                  pseg.numeric_cols["views"].values)
    assert rseg.stored_vals == pseg.stored_vals


# ---------------------------------------------------------------------
# chip_smoke's phase-4 field-type index and phase 18's brute force
# ---------------------------------------------------------------------

def test_phase4_fields_small_on_the_cpu(monkeypatch):
    """Phase 4's field-type index (2,000 docs here) run on the CPU in
    place of both devices: its bodies and analyze calls through the write
    path before and after the forcemerge, every checked page against
    FtSmallOracle."""
    import chip_smoke
    real = chip_smoke.ft_small_run
    monkeypatch.setattr(chip_smoke, "ft_small_run",
                        lambda _name, docs, bodies: real("cpu", docs, bodies))
    monkeypatch.setattr(chip_smoke, "FT_SMALL_DOCS", 2000)
    out = chip_smoke.phase_fields_small(np.random.default_rng([0, 11]))
    assert out["pages_checked"] == 18 and out["analyze_calls"] == 20


def test_phase4_fields_small_oracle_catches_a_wrong_page():
    import chip_smoke
    docs = chip_smoke.ft_small_docs(np.random.default_rng(3), 600)
    before, after, _an, _t = chip_smoke.ft_small_run(
        "cpu", docs, chip_smoke.FT_SMALL_BODIES)
    oracle = chip_smoke.FtSmallOracle(docs, range(0, len(docs), 97))
    chip_smoke.ft_small_check(oracle, before, merged=False)
    bad = copy.deepcopy(before)
    bad[10]["hits"]["hits"] = bad[10]["hits"]["hits"][::-1]
    with pytest.raises(AssertionError):
        chip_smoke.ft_small_check(oracle, bad, merged=False)
    bad = copy.deepcopy(after)
    bad[24]["aggregations"]["r"]["buckets"][0]["doc_count"] += 1
    with pytest.raises(AssertionError):
        chip_smoke.ft_small_check(oracle, bad, merged=True)


SAYT_TEXTS = ("quick brown fox", "quick red fox")


def _sayt_totals(c, index, fields=("ss._2gram", "ss._3gram")):
    return [c.search(index, {"query": {"match": {f: "quick brown"}}})[
        "hits"]["total"]["value"] for f in fields]


def test_sayt_subfields_named_in_a_mapping_keep_their_chains():
    """A create body that names a search_as_you_type field's `_2gram` as
    `{"type": "text"}`: the port keeps the shingle chain (OpenSearch's
    page), the reference rebuilds it as plain text (ROADMAP Queue 3, the
    recovery note): "quick brown" on `ss._2gram` totals 1 in the port
    and 2 in the reference; the mapping reads back the same."""
    body = {"mappings": {"properties": {"ss": {
        "type": "search_as_you_type",
        "fields": {"_2gram": {"type": "text"}}}}}}
    ref, port = RefClient(), RestClient(device="cpu")
    for c in (ref, port):
        c.indices.create("s", copy.deepcopy(body))
        for i, t in enumerate(SAYT_TEXTS):
            c.index("s", {"ss": t}, id=str(i), refresh=True)
    assert port.indices.get_mapping("s") == ref.indices.get_mapping("s")
    assert _sayt_totals(port, "s") == [1, 0]
    assert _sayt_totals(ref, "s") == [2, 0]


def test_english_title_forms():
    """bench_corpus's English forms of the title vocabulary: distinct
    words, the 30 most drawn terms Lucene's stopwords, every other form
    one token under the english analyzer, a stem's forms sharing it."""
    from opensearch_tpu_torch import bench_corpus as bc
    from opensearch_tpu_torch.analysis import AnalysisRegistry
    t = bc.build_title_corpus(3000)
    forms = bc.english_title_forms(t[5], t[6], t[7])
    assert len(set(forms)) == 1000
    en = AnalysisRegistry().get("english")
    terms = [en.terms(f) for f in forms]
    assert sum(not x for x in terms) == 30
    assert all(len(x) == 1 for x in terms if x)
    assert len({x[0] for x in terms if x}) < 500
    freq = (np.bincount(t[5], weights=t[7], minlength=1000)
            + np.bincount(t[6], weights=t[7], minlength=1000))
    assert min(freq[i] for i, x in enumerate(terms) if not x) >= max(
        freq[i] for i, x in enumerate(terms) if x)
    assert forms == bc.english_title_forms(t[5], t[6], t[7])


def test_phase18_brute_force_matches_pages(bench_small):
    """Phase 18's fields attached as phase 18 attaches them to the bench
    corpus segment with deletes (the re-indexed docs' segment holds none
    of them); every class's pages of the port against FtOracle; a wrong
    page fails; the remap's postings equal the english analyzer's terms
    of each passage's title."""
    import chip_smoke
    from opensearch_tpu_torch import bench_corpus as bc
    from opensearch_tpu_torch.analysis import AnalysisRegistry
    _ref, _port, _ix, port2, ix2, big = bench_small
    sbig = dict(big, client=port2, ix=ix2,
                columns=bc.guardrail_columns(len(big["corpus"][3])))
    att = chip_smoke.ft_attach(sbig, 5)
    arrays = att.pop("arrays")
    seg = big["seg"]
    en = AnalysisRegistry().get("english")
    pb = seg.postings["title_en"]
    title = big["title"]
    draw, first, second = title[8], title[5], title[6]
    forms = arrays["forms"]
    for d in range(0, seg.ndocs, 37):
        toks = []
        for p in draw[d].astype(np.int64):
            toks += [forms[first[p]], forms[second[p]]]
        terms = en.terms(" ".join(toks))
        assert arrays["dl"][d] == len(terms)
        for t in set(terms):
            a, b = pb.row_slice(pb.row(t))
            k = np.searchsorted(pb.doc_ids[a:b], d)
            assert pb.doc_ids[a + k] == d and pb.tfs[a + k] == terms.count(t)
            ps, pe = pb.pos_starts[a + k], pb.pos_starts[a + k + 1]
            assert pb.positions[ps:pe].tolist() == [
                tok.position for tok in en.analyze(" ".join(toks))
                if tok.text == t]
    oracle = chip_smoke.FtOracle(arrays, ix2)
    classes = chip_smoke.ft_classes(arrays, 3,
                                    np.random.default_rng(17))
    cpu = chip_smoke.ft_twin(port2._indices["bench"].engine)
    chip_smoke.share_with_verifier(port2._indices["bench"].engine.segments)
    sums = chip_smoke.SumCheck()
    outs = []
    for name, items in classes.items():
        r = chip_smoke.run_ft_class(port2, name, items, oracle, sums, cpu)
        assert r["bodies"] == 3
        outs.append(r)
    # the pages' checks and the CPU twin ran on the verifier's thread
    chip_smoke.VERIFY.drain()
    assert all("oracle_s" in r and "cpu_s" in r for r in outs)
    body, spec = classes["d_sort"][0]
    resp = port2.search("bench", body)
    bad = copy.deepcopy(resp)
    bad["hits"]["hits"] = bad["hits"]["hits"][::-1]
    with pytest.raises(AssertionError):
        chip_smoke.ft_check(oracle, "d_sort", body, spec, bad, sums, "bad")
    body, spec = classes["c_bool"][0]
    resp = port2.search("bench", dict(body, query=body["query"]["bool"][
        "must"][0]))
    if resp["hits"]["hits"] != port2.search("bench", body)["hits"]["hits"]:
        with pytest.raises(AssertionError):
            chip_smoke.ft_check(oracle, "c_bool", body, spec, resp, sums,
                                "unfiltered")
