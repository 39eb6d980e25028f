"""RestClient: the dict-in / dict-out API facade (the document, bulk,
search, msearch, count, explain, validate_query, field_caps, scroll,
point-in-time, term vector and indices subset of
opensearch_tpu/rest/client.py), with the same request and response shapes
for this subset.

A search's `timeout` becomes one deadline where the call accepts the body
(`utils/deadline.py`). A scroll (`search(..., scroll=...)`) and a point
in time (`create_pit`, then searches with a `pit` body) freeze the
index's segment list: their pages search that snapshot, offset paging
for a scroll, and never see a later refresh; deletes flip the snapshot
segments' live masks in place, so a page sees a later delete, as the
reference's. A context holds its segments (`Segment.hold`), so a merge
that replaces them releases their device state only when the last
context goes: at `clear_scroll`, `delete_pit` or expiry. Keep-alives
expire lazily, when a scroll or point-in-time search next looks.

An index has one shard and no replicas. Its segments' postings live on the
client's device: a card unless the caller asks for the CPU. With a
`data_path`, each index keeps its metadata (settings, mapping, open or
closed) in `<data_path>/<index>/index_meta.json` and its shard (translog,
segments, commit point) under `<data_path>/<index>/0`, and a client opened
on the same path recovers every index found there. Aliases and index
templates live in memory only, as in the reference.

Index names resolve through the client's metadata (`cluster/state.py`):
names, comma lists, wildcards and aliases. A write through an alias goes
to its write index; a search, count, msearch or point in time through an
expression that names no open index serves the reference's empty response
(no shards, a total of 0); one that names more than one open index raises
NotPortedError, as does one through
an alias that carries a `filter` or a `routing` (the reference serves
such a search unfiltered). A closed index refuses searches and writes
with index_closed_exception; `index.blocks.write` (or `read_only`)
refuses writes with cluster_block_exception.

A `geo_shape` query's `indexed_shape` ({index, id, path}) is replaced by
the shape stored at `path` ("shape" by default) of that document before
a search, a count or an explain parses the body, as the reference's
client does (a missing document or path is its 400).

A missing index raises `IndexNotFoundError` and creating an existing one
`ResourceAlreadyExistsError` (`errors.py`), where the reference's client
raises them; msearch turns a missing or closed index into its per-body
error entry.
"""

from __future__ import annotations

import copy
import fnmatch
import json
import math
import os
import shutil
import time
import uuid
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..analysis import AnalysisRegistry
from ..cluster import admin
from ..cluster.admin import IndexClosedError, SettingsError
from ..cluster.state import AliasMetadata, ClusterMetadata, IndexMetadata
from ..device import resolve_device
from ..errors import (ClusterStateError, IndexNotFoundError, NotPortedError,
                      ResourceAlreadyExistsError)
from ..index.engine import DocLocation, Engine, VersionConflictError
from ..index.mappings import Mappings, parse_annotated_text
from ..models.similarity import resolve_similarity
from ..script import painless_lite as pl
from ..search import compiler as C
from ..search import fastpath
from ..search import query_dsl as dsl
from ..search.executor import (ShardSearcher, msearch_batched,
                               search_shards, search_snapshot)
from ..search.explain import explain_doc
from ..utils import deadline as DL
from ..utils import metrics
from ..utils.slowlog import SlowLog

# the public calls of the reference's client (dir() of its RestClient and
# IndicesClient, opensearch_tpu/rest/client.py); one the port does not
# define raises NotPortedError naming it, not AttributeError
REFERENCE_CALLS = (
    "bulk", "cancel_task", "clear_scroll", "cluster_stats", "count",
    "create", "create_pit", "delete", "delete_by_query", "delete_pit",
    "delete_remote_cluster", "delete_script", "delete_search_pipeline",
    "exists", "explain", "field_caps", "flight_recorder",
    "flight_recorder_dump", "get", "get_lifecycle_policy", "get_script",
    "get_search_pipeline", "get_traces", "hot_threads", "index",
    "indices_summary", "insights_status", "insights_top_queries",
    "lifecycle_explain", "lifecycle_step", "metrics_history", "mget",
    "msearch", "msearch_template", "mtermvectors", "nodes_stats",
    "put_lifecycle_policy", "put_remote_cluster", "put_script",
    "put_search_pipeline", "put_workload_group", "rank_eval", "reindex",
    "remediation_status", "remote_info", "remotestore_restore",
    "render_search_template", "rollover", "scroll", "search",
    "search_template", "slo_status", "tasks", "termvectors", "update",
    "update_by_query", "validate_query")
# the reference client's namespaces other than `indices`
REFERENCE_NAMESPACES = ("cat", "cluster", "ingest", "snapshot")
REFERENCE_INDICES_CALLS = (
    "analyze", "clone", "close", "create", "create_data_stream", "delete",
    "delete_data_stream", "delete_index_template", "exists",
    "exists_index_template", "flush", "forcemerge", "get", "get_alias",
    "get_data_stream", "get_mapping", "get_settings", "open", "put_alias",
    "put_index_template", "put_mapping", "put_settings", "put_template",
    "refresh", "shrink", "split", "stats", "update_aliases")


class ApiError(Exception):
    def __init__(self, status: int, err_type: str, reason: str):
        super().__init__(reason)
        self.status = status
        self.err_type = err_type
        self.reason = reason

    def body(self) -> dict:
        return {"error": {"type": self.err_type, "reason": self.reason},
                "status": self.status}


def parse_keepalive_s(v, default: float = 60.0) -> float:
    """A scroll or point-in-time keep-alive ("1m", "30s", "500ms" or a
    number of seconds) in seconds; a malformed one is a 400 (the
    reference's `_parse_keepalive_s`)."""
    if v is None:
        return default
    if isinstance(v, (int, float)):
        return float(v)
    sv = str(v).strip()
    try:
        for suf, mult in (("micros", 1e-6), ("nanos", 1e-9), ("ms", 0.001),
                          ("s", 1.0), ("m", 60.0), ("h", 3600.0),
                          ("d", 86400.0)):
            if sv.endswith(suf):
                return float(sv[: -len(suf)]) * mult
        return float(sv)
    except ValueError:
        raise ApiError(400, "illegal_argument_exception",
                       f"failed to parse time value [{v}]")


def unported_setting(key: str, value) -> Optional[str]:
    """The name of an index setting (flattened, `index.` stripped) whose
    effect the port does not serve, or None: more shards or replicas than
    one and none, and the ingest, search pipeline and lifecycle settings
    the reference acts on."""
    if key == "number_of_shards" and int(value) != 1:
        return "number_of_shards > 1"
    if key == "number_of_replicas" and int(value) > 0:
        return "number_of_replicas > 0"
    if key in ("default_pipeline", "search.default_pipeline") \
            or key.startswith("lifecycle."):
        return f"index setting [{key}]"
    return None


class IndexService:
    """One index: its metadata, mappings, single shard's engine and
    searcher, and slow logs. With a `data_path` the shard's engine lives
    under `<data_path>/<name>/0`. `meta.settings` holds the settings as
    the reference keeps them ({"index": {...}}); `mapping_body` the create
    body's mapping with every put_mapping body merged in, which the
    index's metadata file persists."""

    def __init__(self, meta: IndexMetadata, mapping: Optional[dict],
                 device: torch.device, data_path: Optional[str] = None):
        settings = meta.settings.setdefault("index", {})
        for key, value in admin.flatten(settings).items():
            what = unported_setting(key, value)
            if what is not None:
                raise NotPortedError(what)
        self.meta = meta
        self.name = meta.name
        self.mapping_body = dict(mapping or {})
        self.mappings = Mappings(mapping,
                                 analysis=AnalysisRegistry(
                                     settings.get("analysis")),
                                 dynamic=(mapping or {}).get("dynamic", True))
        self.similarity = _similarity(settings)
        path = os.path.join(data_path, meta.name, "0") if data_path else None
        self.engine = Engine(self.mappings, path=path, device=device)
        self.engine.index_name = meta.name
        self.searcher = ShardSearcher(self.engine, device,
                                      similarity=self.similarity,
                                      index_name=meta.name)
        self.search_slowlog = SlowLog(meta.name, meta.settings, "search",
                                      "query")
        self.index_slowlog = SlowLog(meta.name, meta.settings, "indexing",
                                     "index")

    def reapply_static_settings(self) -> None:
        """After an open: the analysis chains and the default similarity
        from the settings, which may have changed while the index was
        closed; the segments and their device arrays stay as they are."""
        idx = self.meta.settings.get("index", {})
        self.mappings.analysis = AnalysisRegistry(idx.get("analysis"))
        for ft in self.mappings.fields.values():
            if ft.type == "search_as_you_type":
                shingles = sum(1 for s in ft.subfields if s.endswith("gram"))
                self.mappings.analysis.ensure_sayt_chains(shingles + 1)
        self.similarity = _similarity(idx)
        self.searcher.similarity = self.similarity

    def stats(self) -> dict:
        """The reference's index stats: docs, store bytes (each segment's
        postings doc ids, tfs and row starts, and its numeric columns'
        values), slow logs, segments, indexing and its buffer, refresh
        (with the refresh-to-visible percentiles once a refresh has run),
        flush and merges."""
        eng = self.engine
        store_bytes = 0
        for seg in eng.segments:
            for pb in seg.postings.values():
                store_bytes += (pb.doc_ids.nbytes + pb.tfs.nbytes
                                + pb.starts.nbytes)
            for col in seg.numeric_cols.values():
                store_bytes += col.values.nbytes
        ops = eng.stats
        buf = eng.buffer_stats()
        rtv = metrics.percentiles(metrics.refresh_to_visible_name(self.name))
        return {"docs": {"count": eng.num_docs},
                "store": {"size_in_bytes": store_bytes},
                "slowlog": {"search": self.search_slowlog.stats(),
                            "indexing": self.index_slowlog.stats()},
                "segments": {"count": len(eng.segments)},
                "indexing": {"index_total": ops["index_ops"],
                             "delete_total": ops["delete_ops"],
                             "buffer": {"docs": buf["docs"],
                                        "bytes": buf["bytes"]}},
                "refresh": {"total": ops["refreshes"],
                            **({"refresh_to_visible_ms": rtv}
                               if rtv else {})},
                "flush": {"total": ops["flushes"]},
                "merges": {"total": ops["merges"],
                           "backlog": eng.merge_backlog()}}


def _similarity(idx_settings: dict):
    sim = idx_settings.get("similarity", {})
    return resolve_similarity(sim.get("default") if isinstance(sim, dict)
                              else None)


def _get_source_path(src: dict, path: str):
    node: Any = src
    for p in path.split("."):
        if isinstance(node, dict):
            node = node.get(p)
        else:
            return None
    return node


def _map_admin_errors(fn, *args):
    """cluster/admin.py's errors -> the reference's ApiErrors."""
    try:
        return fn(*args)
    except IndexClosedError as e:
        raise ApiError(400, "index_closed_exception", str(e))
    except SettingsError as e:
        raise ApiError(400, "illegal_argument_exception", str(e))
    except IndexNotFoundError as e:
        raise ApiError(404, "index_not_found_exception", str(e))


def _run_update_script_or_400(script_body, src: dict, meta: dict):
    """Deep-copy `src`, run the update script, map ScriptError to 400.
    The deep copy matters: engine.get() hands back the live stored
    _source, and a script that mutates nested state then sets
    ctx.op='none' must not corrupt the segment in place."""
    src_str, prm = dsl.parse_script_spec(script_body)
    try:
        return pl.run_update_script(src_str, prm, copy.deepcopy(src), meta)
    except pl.ScriptError as e:
        raise ApiError(400, "illegal_argument_exception",
                       f"failed to execute script: {e}")

class RestClient:
    """`device` is where segment postings live and the kernels run: the
    current card by default; "cpu" runs the plain versions and is taken
    only when asked for."""

    def __init__(self, device="cuda", data_path: Optional[str] = None):
        self.device = resolve_device(device)
        self.data_path = data_path
        self.metadata = ClusterMetadata()
        self.indices = IndicesClient(self)
        self._indices: Dict[str, IndexService] = {}
        # scroll / point-in-time id -> context (its index service, the
        # segment snapshot it holds, its keep-alive and expiry)
        self._scrolls: Dict[str, dict] = {}
        self._pits: Dict[str, dict] = {}
        if data_path is not None:
            os.makedirs(data_path, exist_ok=True)
            self._recover_indices()

    def _recover_indices(self) -> None:
        """Open every index persisted under `data_path`: its metadata
        (a closed index recovers closed), then its shard from the last
        commit point and the translog."""
        for name in sorted(os.listdir(self.data_path)):
            path = os.path.join(self.data_path, name, "index_meta.json")
            if not os.path.exists(path):
                continue
            with open(path) as fh:
                saved = json.load(fh)
            meta = IndexMetadata(name, settings=saved.get("settings", {}))
            meta.state = saved.get("state", "open")
            self._register(IndexService(meta, saved.get("mappings"),
                                        self.device, self.data_path))

    def _register(self, svc: IndexService) -> None:
        self._indices[svc.name] = svc
        self.metadata.indices[svc.name] = svc.meta

    def close(self) -> None:
        for svc in self._indices.values():
            svc.engine.close()

    def __getattr__(self, name: str):
        if name in REFERENCE_CALLS or name in REFERENCE_NAMESPACES:
            raise NotPortedError(f"rest call [{name}]")
        raise AttributeError(name)

    # ---------------- index metadata ----------------

    def _create_index(self, name: str, body: Optional[dict] = None) -> dict:
        """A new index: the matching templates' settings under the body's,
        the first matching template's mapping where the body has none,
        and the body's aliases (the reference's `_create_index_locked`)."""
        if name in self._indices:
            raise ResourceAlreadyExistsError(f"index [{name}] already exists")
        body = body or {}
        settings = dict(body.get("settings", {}))
        mapping = body.get("mappings")
        for tmpl in reversed(self.metadata.matching_templates(name)):
            tbody = tmpl.get("template", tmpl)
            merged = dict(tbody.get("settings", {}))
            merged.update(settings)
            settings = merged
            if mapping is None and tbody.get("mappings"):
                mapping = tbody["mappings"]
        meta = IndexMetadata(name, settings={
            "index": copy.deepcopy(settings.get("index", settings))})
        svc = IndexService(meta, mapping, self.device, self.data_path)
        self._register(svc)
        for alias, acfg in body.get("aliases", {}).items():
            self._put_alias(alias, name, acfg)
        self._persist_meta(svc)
        return {"acknowledged": True, "shards_acknowledged": True,
                "index": name}

    def _put_alias(self, alias: str, index: str,
                   cfg: Optional[dict] = None) -> None:
        am = self.metadata.aliases.setdefault(alias, AliasMetadata(alias))
        am.indices[index] = cfg or {}

    def update_aliases(self, actions: List[dict]) -> dict:
        """`add` and `remove` actions, applied in order; aliases left with
        no index go."""
        for action in actions:
            ((verb, spec),) = action.items()
            indices = spec.get("indices", [spec.get("index")])
            aliases = spec.get("aliases", [spec.get("alias")])
            for idx in indices:
                for name in self.metadata.resolve(idx,
                                                  allow_no_indices=False):
                    for al in aliases:
                        if verb == "add":
                            cfg = {k: v for k, v in spec.items()
                                   if k in ("filter", "is_write_index",
                                            "routing")}
                            self._put_alias(al, name, cfg)
                        elif verb == "remove":
                            am = self.metadata.aliases.get(al)
                            if am:
                                am.indices.pop(name, None)
                        else:
                            raise ClusterStateError(
                                f"unknown alias action [{verb}]")
        self._drop_empty_aliases()
        return {"acknowledged": True}

    def _drop_empty_aliases(self) -> None:
        self.metadata.aliases = {a: am for a, am
                                 in self.metadata.aliases.items()
                                 if am.indices}

    def _persist_meta(self, svc: IndexService) -> None:
        """Write the index's metadata: its settings, its state and its
        mapping as the reference persists it (`to_dict()`, so the fields
        mapped dynamically so far), with the mapping bodies it was given
        merged over it, which keep the field options `to_dict` leaves
        out."""
        if self.data_path is None:
            return
        with open(os.path.join(self.data_path, svc.name,
                               "index_meta.json"), "w") as fh:
            json.dump({"settings": svc.meta.settings,
                       "mappings": _deep_merge(svc.mappings.to_dict(),
                                               svc.mapping_body),
                       "state": svc.meta.state}, fh)

    # ---------------- index resolution ----------------

    def _check_alias_options(self, expression, names: List[str]) -> None:
        """A search through an alias with a `filter` or a `routing` for
        one of `names` raises: the reference serves it unfiltered."""
        if expression in (None, "", "_all", "*"):
            return
        exprs = (expression if isinstance(expression, list)
                 else str(expression).split(","))
        for ex in exprs:
            ex = ex.strip()
            if ex in self._indices:
                continue
            for alias, am in self.metadata.aliases.items():
                if alias != ex and not (("*" in ex or "?" in ex)
                                        and fnmatch.fnmatch(alias, ex)):
                    continue
                for n in names:
                    for opt in ("filter", "routing"):
                        if am.indices.get(n, {}).get(opt) is not None:
                            raise NotPortedError(
                                f"a search through an alias with a "
                                f"[{opt}]")

    def _open_names(self, index) -> List[str]:
        """The open indices an expression names: a closed index named
        (or behind a named alias) raises IndexClosedError, one matched by
        a wildcard drops out."""
        names = admin.check_open(self, self.metadata.resolve(index), index)
        self._check_alias_options(index, names)
        return names

    def _svc(self, index: str) -> Optional[IndexService]:
        """The one open index a search, count or msearch reads, or None
        where the expression names no open index (the reference's empty
        response)."""
        names = self._open_names(index)
        if not names:
            return None
        if len(names) != 1:
            raise NotPortedError("a search over several indices")
        return self._indices[names[0]]

    def _svc_of(self, index: str) -> IndexService:
        """The index a get, explain or term vector reads: the name, or
        its alias's write index."""
        return self._indices[self.metadata.write_index(index)]

    def _svc_for_write(self, index: str) -> IndexService:
        """The index a write goes to (its alias's write index), created
        when it does not exist; a closed index is the reference's 400."""
        try:
            concrete = self.metadata.write_index(index)
        except IndexNotFoundError:
            self._create_index(index)
            concrete = index
        svc = self._indices[concrete]
        if svc.meta.state == "close":
            raise ApiError(400, "index_closed_exception",
                           f"closed index [{concrete}]")
        return svc

    @staticmethod
    def _check_write_block(svc: IndexService) -> None:
        """`index.blocks.write` or `read_only` refuses the write."""
        blocks = svc.meta.settings.get("index", {}).get("blocks", {})
        if blocks.get("write") or blocks.get("read_only"):
            raise ApiError(403, "cluster_block_exception",
                           f"index [{svc.name}] blocked by: "
                           f"[FORBIDDEN/8/index write (api)]")

    # ---------------- document APIs ----------------

    def index(self, index: str, body: dict, id: Optional[str] = None,
              routing: Optional[str] = None, refresh: bool = False,
              op_type: str = "index", if_seq_no: Optional[int] = None,
              if_primary_term: Optional[int] = None,
              pipeline: Optional[str] = None) -> dict:
        if pipeline is not None:
            raise NotPortedError("ingest pipeline")
        svc = self._svc_for_write(index)
        self._check_write_block(svc)
        doc_id = id if id is not None else uuid.uuid4().hex[:20]
        t0 = time.monotonic()
        try:
            res = svc.engine.index_doc(doc_id, body, routing, if_seq_no,
                                       if_primary_term, op_type)
        except VersionConflictError as e:
            raise ApiError(409, "version_conflict_engine_exception", str(e))
        except ValueError as e:
            raise ApiError(400, "mapper_parsing_exception", str(e))
        if refresh:
            svc.engine.refresh()
        svc.index_slowlog.maybe_log(time.monotonic() - t0, {"_id": doc_id})
        res["_index"] = svc.name
        res["_shards"] = {"total": 1, "successful": 1, "failed": 0}
        return res

    def create(self, index: str, id: str, body: dict, **kw) -> dict:
        """Index a new document: a 409 when the id exists."""
        return self.index(index, body, id=id, op_type="create", **kw)

    def get(self, index: str, id: str, routing: Optional[str] = None
            ) -> dict:
        svc = self._svc_of(index)
        res = svc.engine.get(id)
        if res is None:
            raise ApiError(404, "document_missing_exception",
                           f"[{id}]: document missing")
        res["_index"] = svc.name
        return res

    def exists(self, index: str, id: str,
               routing: Optional[str] = None) -> bool:
        try:
            self.get(index, id, routing)
            return True
        except (ApiError, IndexNotFoundError):
            return False

    def mget(self, body: dict, index: Optional[str] = None) -> dict:
        docs = []
        for spec in body.get("docs", []):
            idx = spec.get("_index", index)
            try:
                docs.append(self.get(idx, spec["_id"], spec.get("routing")))
            except (ApiError, IndexNotFoundError):
                docs.append({"_index": idx, "_id": spec["_id"],
                             "found": False})
        return {"docs": docs}

    def delete(self, index: str, id: str, routing: Optional[str] = None,
               refresh: bool = False, if_seq_no: Optional[int] = None,
               if_primary_term: Optional[int] = None) -> dict:
        svc = self._svc_of(index)
        if svc.meta.state == "close":
            raise ApiError(400, "index_closed_exception",
                           f"closed index [{svc.name}]")
        self._check_write_block(svc)
        try:
            res = svc.engine.delete_doc(id, if_seq_no, if_primary_term)
        except VersionConflictError as e:
            raise ApiError(409, "version_conflict_engine_exception", str(e))
        if refresh:
            svc.engine.refresh()
        res["_index"] = svc.name
        if res["result"] == "not_found":
            raise ApiError(404, "document_missing_exception",
                           f"[{id}]: not found")
        return res

    def update(self, index: str, id: str, body: dict,
               routing: Optional[str] = None, refresh: bool = False,
               retry_on_conflict: Optional[int] = None,
               if_seq_no: Optional[int] = None,
               if_primary_term: Optional[int] = None) -> dict:
        """Partial-doc update and upserts (reference UpdateHelper): `doc`
        deep-merged into the current source (a no-op when nothing changes
        and `detect_noop` holds), `doc_as_upsert`, `upsert`, a script
        (painless-lite over a deep copy of the source: `ctx.op` "none" or
        "noop" is a no-op, "delete" deletes) and `scripted_upsert` (the
        script runs over the upsert document). `retry_on_conflict` changes
        nothing with one writer; `if_seq_no` / `if_primary_term`, which
        the reference ignores on an update where OpenSearch checks them,
        raise NotPortedError."""
        if if_seq_no is not None or if_primary_term is not None:
            raise NotPortedError("[if_seq_no] / [if_primary_term] on an "
                                 "update")
        svc = self._svc_for_write(index)
        self._check_write_block(svc)
        current = svc.engine.get(id)
        if current is None:
            if body.get("doc_as_upsert") and "doc" in body:
                return self.index(index, body["doc"], id=id,
                                  routing=routing, refresh=refresh)
            if "upsert" in body:
                upsert_src = dict(body["upsert"])
                if body.get("scripted_upsert") and "script" in body:
                    upsert_src, op = _run_update_script_or_400(
                        body["script"], upsert_src,
                        {"_index": svc.name, "_id": id, "op": "create"})
                    if op in ("none", "delete"):
                        return {"_index": svc.name, "_id": id,
                                "result": "noop"}
                return self.index(index, upsert_src, id=id,
                                  routing=routing, refresh=refresh)
            raise ApiError(404, "document_missing_exception",
                           f"[{id}]: document missing")
        src = dict(current["_source"])
        if "doc" in body:
            merged = _deep_merge(src, body["doc"])
            if body.get("detect_noop", True) and merged == src:
                return {"_index": svc.name, "_id": id, "result": "noop"}
            return self.index(index, merged, id=id, routing=routing,
                              refresh=refresh)
        if "script" in body:
            meta = {"_index": svc.name, "_id": id,
                    "_version": current.get("_version", 1),
                    "_routing": routing}
            new_src, op = _run_update_script_or_400(body["script"], src,
                                                    meta)
            if op == "none":
                return {"_index": svc.name, "_id": id, "result": "noop"}
            if op == "delete":
                return self.delete(index, id, routing=routing,
                                   refresh=refresh)
            return self.index(index, new_src, id=id, routing=routing,
                              refresh=refresh)
        raise ApiError(400, "action_request_validation_exception",
                       "update requires doc, upsert or script")

    def bulk(self, body, index: Optional[str] = None,
             refresh: bool = False) -> dict:
        """Bulk API: an NDJSON string or a list of alternating action and
        source dicts; `index`, `create`, `delete` and `update` actions,
        each item's status and error as the reference reports them."""
        if isinstance(body, str):
            lines = [json.loads(ln) for ln in body.splitlines() if ln.strip()]
        else:
            lines = list(body)
        items = []
        errors = False
        touched = set()
        i = 0
        while i < len(lines):
            ((action, meta),) = lines[i].items()
            i += 1
            idx = meta.get("_index", index)
            doc_id = meta.get("_id")
            routing = meta.get("routing", meta.get("_routing"))
            try:
                if action in ("index", "create"):
                    src = lines[i]
                    i += 1
                    res = self.index(idx, src, id=doc_id, routing=routing,
                                     op_type=action)
                    status = 201 if res.get("result") == "created" else 200
                    items.append({action: {**res, "status": status}})
                elif action == "delete":
                    try:
                        res = self.delete(idx, doc_id, routing=routing)
                        items.append({"delete": {**res, "status": 200}})
                    except ApiError as e:
                        if e.status != 404 or e.err_type \
                                != "document_missing_exception":
                            raise
                        items.append({"delete": {
                            "_index": idx, "_id": doc_id,
                            "result": "not_found", "status": 404}})
                elif action == "update":
                    src = lines[i]
                    i += 1
                    res = self.update(idx, doc_id, src, routing=routing)
                    items.append({"update": {**res, "status": 200}})
                else:
                    raise ApiError(400, "illegal_argument_exception",
                                   f"unknown bulk action [{action}]")
                touched.add(idx)
            except ApiError as e:
                errors = True
                items.append({action: {"_index": idx, "_id": doc_id,
                                       "status": e.status,
                                       "error": e.body()["error"]}})
        if refresh:
            for idx in touched:
                try:
                    svc = self._svc_of(idx)
                except IndexNotFoundError:
                    continue
                svc.engine.refresh()
        return {"took": 0, "errors": errors, "items": items}

    # ---------------- search APIs ----------------

    def search(self, index: str = "_all", body: Optional[dict] = None,
               scroll: Optional[str] = None, **kw) -> dict:
        """A search; with `scroll` (a keep-alive) its response carries a
        `_scroll_id` whose context pages the same body over the segments
        of this moment; a `pit` body searches a point in time. The body's
        `timeout` starts its deadline here."""
        body = dict(body or {})
        body.update({k: v for k, v in kw.items() if v is not None})
        token = None
        if DL.current() is None:
            try:
                deadline = DL.Deadline.from_body(body)
            except ValueError as e:
                raise ApiError(400, "parsing_exception", str(e))
            if deadline is not None:
                token = DL.set_current(deadline)
        try:
            return self._search_deadlined(index, body, scroll)
        except DL.PartialResultsUnacceptable as e:
            raise ApiError(503, "search_phase_execution_exception", str(e))
        finally:
            if token is not None:
                DL.reset_current(token)

    def _search_deadlined(self, index: str, body: dict,
                          scroll: Optional[str]) -> dict:
        if body.get("query") is not None:
            body["query"] = self._resolve_percolate_refs(body["query"])
        pit = body.pop("pit", None)
        try:
            if pit is not None:
                return self._search_pit(pit, body)
            svc = self._svc(index)
            if svc is None:
                if scroll:
                    raise NotPortedError("a scroll over no open index")
                return search_snapshot([], [], body, index)
            slow = svc.search_slowlog
            before = dict(fastpath.STATS) if slow.thresholds else None
            t0 = time.monotonic()
            resp = search_shards([svc.searcher], body, index_name=svc.name)
            if before is not None:
                slow.maybe_log(time.monotonic() - t0, body.get("query"),
                               extra=lambda: {"fastpath_rungs": {
                                   k: v - before.get(k, 0)
                                   for k, v in fastpath.STATS.items()
                                   if v != before.get(k, 0)}})
        except dsl.QueryParseError as e:
            raise ApiError(400, "parsing_exception", str(e))
        except IndexClosedError as e:
            raise ApiError(400, "index_closed_exception", str(e))
        if scroll:
            sid = uuid.uuid4().hex
            ka = parse_keepalive_s(scroll if scroll is not True else None)
            self._scrolls[sid] = {
                **self._snapshot(svc), "index": index, "body": body,
                "offset": int(body.get("from", 0))
                + int(body.get("size", 10)),
                "keep_alive": ka, "expires": time.time() + ka}
            resp["_scroll_id"] = sid
        return resp

    # ---------------- scroll and point in time ----------------

    @staticmethod
    def _snapshot(svc: IndexService) -> dict:
        """A context's frozen segment list, each segment held."""
        segs = list(svc.engine.segments)
        for seg in segs:
            seg.hold()
        return {"svc": svc, "segments": segs}

    @staticmethod
    def _release(ctx: dict) -> None:
        for seg in ctx["segments"]:
            seg.unhold()

    def _search_context(self, ctx: dict, body: dict) -> dict:
        """One page over a context's snapshot; an index deleted since
        then gives the reference's empty page."""
        svc = ctx["svc"]
        if svc is None or self._indices.get(svc.name) is not svc:
            return search_snapshot([], [], body, ctx["index"])
        return search_snapshot([svc.searcher], [ctx["segments"]], body,
                               ctx["index"])

    def _expire_contexts(self) -> None:
        """Lazy keep-alive enforcement (the reference's reaper)."""
        now = time.time()
        for table in (self._scrolls, self._pits):
            for key in [k for k, v in table.items()
                        if v["expires"] <= now]:
                self._release(table.pop(key))

    def scroll(self, scroll_id: str, scroll: Optional[str] = None) -> dict:
        """The next page of a scroll: its body again with `from` moved on
        by `size`, over its snapshot."""
        self._expire_contexts()
        sctx = self._scrolls.get(scroll_id)
        if sctx is None:
            raise ApiError(404, "search_context_missing_exception",
                           f"No search context found for id [{scroll_id}]")
        ka = (parse_keepalive_s(scroll) if scroll
              else sctx.get("keep_alive", 60.0))
        sctx["keep_alive"] = ka
        sctx["expires"] = time.time() + ka
        body = dict(sctx["body"])
        body["from"] = sctx["offset"]
        resp = self._search_context(sctx, body)
        sctx["offset"] += int(body.get("size", 10))
        resp["_scroll_id"] = scroll_id
        return resp

    def clear_scroll(self, scroll_id=None, body: Optional[dict] = None
                     ) -> dict:
        ids = []
        if scroll_id:
            ids = (list(scroll_id) if isinstance(scroll_id, list)
                   else [scroll_id])
        if body:
            bid = body.get("scroll_id", [])
            ids.extend(bid if isinstance(bid, list) else [bid])
        if any(sid in ("_all", "*") for sid in ids):
            n = len(self._scrolls)
            for sctx in self._scrolls.values():
                self._release(sctx)
            self._scrolls.clear()
            return {"succeeded": True, "num_freed": n}
        n = 0
        for sid in ids:
            sctx = self._scrolls.pop(sid, None)
            if sctx is not None:
                self._release(sctx)
                n += 1
        return {"succeeded": True, "num_freed": n}

    def create_pit(self, index: str, keep_alive: str = "1m") -> dict:
        """A point in time: the index's segment list of this moment (none
        where the expression names no index: its pages are empty)."""
        names = self.metadata.resolve(index)
        self._check_alias_options(index, names)
        if len(names) > 1:
            raise NotPortedError("a point in time over several indices")
        ka = parse_keepalive_s(keep_alive)
        pid = uuid.uuid4().hex
        snap = (self._snapshot(self._indices[names[0]]) if names
                else {"svc": None, "segments": []})
        self._pits[pid] = {**snap,
                           "index": index, "creation_time": time.time(),
                           "keep_alive": ka, "expires": time.time() + ka}
        return {"pit_id": pid, "creation_time": int(time.time() * 1000)}

    def delete_pit(self, body: dict) -> dict:
        ids = body.get("pit_id", [])
        ids = ids if isinstance(ids, list) else [ids]
        deleted = []
        for p in ids:
            pctx = self._pits.pop(p, None)
            if pctx is not None:
                self._release(pctx)
                deleted.append(p)
        return {"pits": [{"pit_id": p, "successful": True} for p in deleted]}

    def _search_pit(self, pit: dict, body: dict) -> dict:
        pit_id = pit["id"]
        self._expire_contexts()
        pctx = self._pits.get(pit_id)
        if pctx is None:
            raise ApiError(404, "search_context_missing_exception",
                           f"Point in time [{pit_id}] not found")
        # a keep_alive on the request extends the context
        ka = (parse_keepalive_s(pit["keep_alive"])
              if pit.get("keep_alive") else pctx.get("keep_alive", 60.0))
        pctx["keep_alive"] = ka
        pctx["expires"] = time.time() + ka
        resp = self._search_context(pctx, body)
        resp["pit_id"] = pit_id
        return resp

    def _resolve_percolate_refs(self, node):
        """A copy of the query tree with each `percolate` that names a
        stored document by `index` / `id` (and no `document(s)`) given
        that document's `_source` as its `document`, and each `geo_shape`
        field's `indexed_shape` replaced by the stored shape; a percolate
        body's documents are not descended into."""
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == "percolate" and isinstance(v, dict):
                    if ("document" not in v and "documents" not in v
                            and v.get("index") and v.get("id")):
                        got = self.get(v["index"], v["id"],
                                       routing=v.get("routing"))
                        v = dict(v)
                        v["document"] = got.get("_source", {})
                    out[k] = v
                elif k == "geo_shape" and isinstance(v, dict):
                    out[k] = {fk: self._resolve_indexed_shape(fv)
                              for fk, fv in v.items()}
                else:
                    out[k] = self._resolve_percolate_refs(v)
            return out
        if isinstance(node, list):
            return [self._resolve_percolate_refs(v) for v in node]
        return node

    def _resolve_indexed_shape(self, spec):
        if not (isinstance(spec, dict)
                and isinstance(spec.get("indexed_shape"), dict)):
            return spec
        ref = spec["indexed_shape"]
        if not (ref.get("index") and ref.get("id")):
            raise ApiError(400, "parsing_exception",
                           "[geo_shape] indexed_shape needs [index] and [id]")
        try:
            got = self.get(ref["index"], ref["id"],
                           routing=ref.get("routing"))
        except (ApiError, IndexNotFoundError):
            raise ApiError(400, "illegal_argument_exception",
                           f"indexed shape [{ref['index']}/{ref['id']}] "
                           f"not found")
        shape = got.get("_source", {})
        for part in str(ref.get("path", "shape")).split("."):
            shape = shape.get(part) if isinstance(shape, dict) else None
        if shape is None:
            raise ApiError(400, "illegal_argument_exception",
                           f"shape path [{ref.get('path', 'shape')}] not "
                           f"found in indexed document")
        out = {fk: fv for fk, fv in spec.items() if fk != "indexed_shape"}
        out["shape"] = shape
        return out

    # ---------------- count, explain, validate, field caps ----------------

    def count(self, index: str = "_all", body: Optional[dict] = None
              ) -> dict:
        body = dict(body or {})
        body["size"] = 0
        body.pop("sort", None)
        if body.get("query") is not None:
            body["query"] = self._resolve_percolate_refs(body["query"])
        svc = self._svc(index)
        resp = (search_snapshot([], [], body, index) if svc is None else
                search_shards([svc.searcher], body, index_name=svc.name))
        return {"count": resp["hits"]["total"]["value"],
                "_shards": resp["_shards"]}

    def explain(self, index: str, id: str, body: dict) -> dict:
        """One doc's explanation under the body's query, with the
        index-wide statistics; a buffered id is refreshed first, a
        missing one is a 404."""
        svc = self._svc_of(index)
        eng = svc.engine
        if id in eng._buffer_ids:
            eng.refresh()
        loc = eng.version_map.get(id)
        if loc is None:
            # a doc of a segment attached from arrays (index/convert.py)
            copies = eng._attached_copies(id)
            if copies:
                seg, d = copies[0]
                loc = DocLocation(int(seg.seq_nos[d]), in_buffer=False,
                                  segment=seg, local_doc=d)
        if loc is None or loc.in_buffer:
            raise ApiError(404, "document_missing_exception",
                           f"[{id}] missing")
        ctx = svc.searcher.context()
        qdict = (self._resolve_percolate_refs(body["query"])
                 if body.get("query") is not None else None)
        lroot = C.rewrite(dsl.parse_query(qdict), ctx)
        expl = explain_doc(lroot, loc.segment, loc.local_doc, ctx)
        return {"_index": svc.name, "_id": id,
                "matched": expl["value"] > 0, "explanation": expl}

    def validate_query(self, index: str = "_all",
                       body: Optional[dict] = None, explain: bool = False,
                       rewrite: bool = False) -> dict:
        """Parse and rewrite the query against every resolved index
        without running it; `explain` and `rewrite` only add the
        per-index entries (the plan's root as type(description))."""
        body = body or {}
        try:
            names = self.metadata.resolve(index)
        except IndexNotFoundError as e:
            raise ApiError(404, "index_not_found_exception", str(e))
        try:
            q = dsl.parse_query(body.get("query", {"match_all": {}}))
        except ValueError as e:     # QueryParseError is a ValueError
            out = {"valid": False,
                   "_shards": {"total": 1, "successful": 1, "failed": 0}}
            if explain:
                out["explanations"] = [
                    {"index": n, "valid": False, "error": str(e)}
                    for n in names] or [
                    {"index": index, "valid": False, "error": str(e)}]
            return out
        explanations = []
        all_valid = True
        for n in names:
            try:
                detail = C.describe_plan(C.rewrite(
                    q, self._indices[n].searcher.context()))
                explanations.append({
                    "index": n, "valid": True,
                    "explanation":
                        f"{detail['type']}({detail['description']})"})
            except ValueError as e:
                all_valid = False
                explanations.append({"index": n, "valid": False,
                                     "error": str(e)})
        out = {"valid": all_valid,
               "_shards": {"total": len(names) or 1,
                           "successful": len(names) or 1, "failed": 0}}
        if explain or rewrite:
            out["explanations"] = explanations
        return out

    def field_caps(self, index: str = "_all", fields="*") -> dict:
        """Each mapped field (subfields too) matching a pattern of
        `fields`: its type, searchable and aggregatable."""
        names = self.metadata.resolve(index)
        pats = fields if isinstance(fields, list) else fields.split(",")
        out: Dict[str, dict] = {}
        for n in names:
            allf = dict(self._indices[n].mappings.fields)
            for f, ft in list(allf.items()):
                for sub, sft in ft.subfields.items():
                    allf[f"{f}.{sub}"] = sft
            for f, ft in allf.items():
                if not any(fnmatch.fnmatch(f, p) for p in pats):
                    continue
                out.setdefault(f, {}).setdefault(ft.type, {
                    "type": ft.type, "searchable": ft.index,
                    "aggregatable": ft.doc_values or ft.type == "text"})
        return {"indices": names, "fields": out}

    # ---------------- term vectors ----------------

    def termvectors(self, index: str, id: Optional[str] = None,
                    body: Optional[dict] = None,
                    fields: Optional[List[str]] = None,
                    term_statistics: bool = False,
                    field_statistics: bool = True,
                    positions: bool = True, offsets: bool = True) -> dict:
        """A stored doc's or an artificial `doc`'s term vectors (the
        reference's `termvectors`): each text, keyword and annotated_text
        field's terms with their frequency, positions and offsets (an
        annotation at its first covered token's), `term_statistics`
        (doc_freq, ttf) and `field_statistics` (sum_doc_freq, doc_count,
        sum_ttf) read from the segments' host CSR (deleted docs counted,
        as there), and the tf-idf `filter` block."""
        body = body or {}
        fields = fields or body.get("fields")
        term_statistics = bool(body.get("term_statistics", term_statistics))
        field_statistics = bool(body.get("field_statistics",
                                         field_statistics))
        positions = bool(body.get("positions", positions))
        offsets = bool(body.get("offsets", offsets))
        tv_filter = body.get("filter") or {}
        svc = self._svc_of(index)
        if body.get("doc") is not None:
            src = body["doc"]
            resp_id = id or ""
        else:
            if id is None:
                raise ApiError(400, "action_request_validation_exception",
                               "termvectors needs an [id] or a [doc]")
            try:
                src = self.get(index, id)["_source"]
            except ApiError:
                return {"_index": svc.name, "_id": id, "found": False}
            resp_id = id
        segs = list(svc.engine.segments)

        def term_stats(fname: str, term: str):
            df = ttf = 0
            for seg in segs:
                pb = seg.postings.get(fname)
                if pb is None:
                    continue
                r = pb.row(term)
                if r >= 0:
                    a, b = int(pb.starts[r]), int(pb.starts[r + 1])
                    df += b - a
                    ttf += int(pb.tfs[a:b].sum())
            return df, ttf

        out_fields = {}
        for fname, ft in list(svc.mappings.fields.items()):
            if ft.type not in ("text", "keyword", "annotated_text") or \
                    (fields and fname not in fields):
                continue
            vals = _get_source_path(src, fname)
            if vals is None:
                continue
            terms = _field_terms(svc.mappings, ft, vals, positions, offsets)
            if not terms:
                continue
            ndocs = max(sum(seg.live_count for seg in segs), 1)
            if term_statistics or tv_filter:
                for term, t in terms.items():
                    df, ttf = term_stats(fname, term)
                    if term_statistics:
                        t["doc_freq"] = df
                        t["ttf"] = ttf
                    t["_df"] = df
            if tv_filter:
                terms = _tv_filter(terms, tv_filter, ndocs)
            for t in terms.values():
                t.pop("_df", None)
            fblock: dict = {"terms": dict(sorted(terms.items()))}
            if field_statistics:
                fblock["field_statistics"] = _field_statistics(segs, fname)
            out_fields[fname] = fblock
        return {"_index": svc.name, "_id": resp_id, "found": True,
                "term_vectors": out_fields}

    def mtermvectors(self, body: dict, index: Optional[str] = None) -> dict:
        """Each `docs` entry's term vectors (its `_index`, `_id` and
        options)."""
        docs = []
        for spec in body.get("docs", []):
            idx = spec.get("_index", index)
            if idx is None:
                raise ApiError(400, "action_request_validation_exception",
                               "mtermvectors doc needs an [_index]")
            docs.append(self.termvectors(
                idx, spec.get("_id"), body={k: v for k, v in spec.items()
                                            if not k.startswith("_")}))
        return {"docs": docs}

    def msearch(self, body: List[dict], index: Optional[str] = None) -> dict:
        """Alternating header / body dicts. Bodies that name one index run
        as one batch: one kernel launch per shape group and segment. A
        missing index or a body that fails to parse gets the reference's
        per-body error entry."""
        pairs = []
        for i in range(0, len(body), 2):
            pairs.append((body[i].get("index", index or "_all"),
                          body[i + 1]))
        names = {idx for idx, _ in pairs}
        if len(names) > 1:
            raise NotPortedError("an msearch over several indices")
        if not pairs:
            return {"took": 0, "responses": []}
        name = names.pop()
        try:
            svc = self._svc(name)
        except (IndexNotFoundError, IndexClosedError) as e:
            # the reference's per-body entry: a closed index's is the
            # ApiError its single search raises
            kind = ("ApiError" if isinstance(e, IndexClosedError)
                    else type(e).__name__)
            return {"took": 0, "responses": [
                {"error": {"type": kind, "reason": str(e)}}
                for _ in pairs]}
        if svc is None:
            return {"took": 0, "responses": [
                search_snapshot([], [], b, name) for _, b in pairs]}
        responses = msearch_batched([svc.searcher], [b for _, b in pairs],
                                    index_name=svc.name)
        return {"took": 0, "responses": responses}


class IndicesClient:
    def __init__(self, client: RestClient):
        self.c = client

    def __getattr__(self, name: str):
        if name in REFERENCE_INDICES_CALLS:
            raise NotPortedError(f"rest call [indices.{name}]")
        raise AttributeError(name)

    def analyze(self, index: Optional[str] = None,
                body: Optional[dict] = None) -> dict:
        """The tokens of `text` (a string or a list) under the body's
        `analyzer`, or a `field`'s index analyzer, of an index's registry
        or of the built-ins (the reference's `analyze`)."""
        body = body or {}
        text = body.get("text", "")
        texts = text if isinstance(text, list) else [text]
        if index is not None:
            svc = self.c._svc_of(index)
            registry = svc.mappings.analysis
            if "field" in body:
                ft = svc.mappings.resolve_field(body["field"])
                analyzer = (svc.mappings.index_analyzer(ft) if ft
                            else registry.get("standard"))
            else:
                analyzer = registry.get(body.get("analyzer", "standard"))
        else:
            analyzer = AnalysisRegistry().get(body.get("analyzer",
                                                       "standard"))
        return {"tokens": [
            {"token": tok.text, "position": tok.position,
             "start_offset": tok.start_offset, "end_offset": tok.end_offset,
             "type": "<ALPHANUM>"}
            for t in texts for tok in analyzer.analyze(t)]}

    def create(self, index: str, body: Optional[dict] = None) -> dict:
        return self.c._create_index(index, body)

    def delete(self, index: str) -> dict:
        """Drop every resolved index (an alias resolves to its indices):
        its device state, its engine, its place in every alias (an alias
        left empty goes) and, with a data path, its files. A scroll or
        point in time over it then pages nothing, as the reference's."""
        try:
            names = self.c.metadata.resolve(index, allow_no_indices=False)
        except IndexNotFoundError as e:
            raise ApiError(404, "index_not_found_exception", str(e))
        for n in names:
            svc = self.c._indices.pop(n)
            self.c.metadata.indices.pop(n, None)
            for am in self.c.metadata.aliases.values():
                am.indices.pop(n, None)
            for seg in svc.engine.segments:
                seg.release_device()
            svc.engine.close()
            if self.c.data_path is not None:
                p = os.path.join(self.c.data_path, n)
                if os.path.exists(p):
                    shutil.rmtree(p)
        self.c._drop_empty_aliases()
        return {"acknowledged": True}

    def exists(self, index: str) -> bool:
        try:
            return bool(self.c.metadata.resolve(index, allow_no_indices=False))
        except IndexNotFoundError:
            return False

    def get(self, index: str) -> dict:
        out = {}
        for n in self.c.metadata.resolve(index, allow_no_indices=False):
            svc = self.c._indices[n]
            aliases = {a: am.indices[n] for a, am
                       in self.c.metadata.aliases.items() if n in am.indices}
            out[n] = {"settings": {"index": {
                **svc.meta.settings.get("index", {}),
                "number_of_shards": svc.meta.num_shards, "uuid": n}},
                "mappings": svc.mappings.to_dict(), "aliases": aliases}
        return out

    def get_mapping(self, index: str = "_all") -> dict:
        return {n: {"mappings": self.c._indices[n].mappings.to_dict()}
                for n in self.c.metadata.resolve(index)}

    def put_mapping(self, index: str, body: dict) -> dict:
        """Merge `body` into each resolved index's mapping and persist
        it."""
        for n in self.c.metadata.resolve(index, allow_no_indices=False):
            svc = self.c._indices[n]
            svc.mappings.merge(body)
            svc.mapping_body = _deep_merge(svc.mapping_body, body)
            self.c._persist_meta(svc)
        return {"acknowledged": True}

    def get_settings(self, index: str = "_all") -> dict:
        return {n: {"settings": {"index": self.c._indices[n].meta.settings
                                 .get("index", {})}}
                for n in self.c.metadata.resolve(index)}

    def put_settings(self, index: str, body: dict,
                     preserve_existing: bool = False) -> dict:
        """Dynamic settings apply to open indices, static ones only to
        closed ones, final ones never (cluster/admin.py)."""
        return _map_admin_errors(admin.update_index_settings, self.c, index,
                                 body, preserve_existing)

    def close(self, index: str) -> dict:
        return _map_admin_errors(admin.close_index, self.c, index)

    def open(self, index: str) -> dict:
        return _map_admin_errors(admin.open_index, self.c, index)

    def shrink(self, index: str, target: str,
               body: Optional[dict] = None) -> dict:
        return _map_admin_errors(admin.resize_index, self.c, index, target,
                                 "shrink", body)

    def split(self, index: str, target: str,
              body: Optional[dict] = None) -> dict:
        return _map_admin_errors(admin.resize_index, self.c, index, target,
                                 "split", body)

    def clone(self, index: str, target: str,
              body: Optional[dict] = None) -> dict:
        return _map_admin_errors(admin.resize_index, self.c, index, target,
                                 "clone", body)

    def refresh(self, index: str = "_all") -> dict:
        for n in self.c.metadata.resolve(index):
            self.c._indices[n].engine.refresh()
        return {"_shards": {"successful": 1, "failed": 0}}

    def flush(self, index: str = "_all") -> dict:
        names = self.c.metadata.resolve(index)
        for n in names:
            self.c._indices[n].engine.flush()
        return {"_shards": {"successful": len(names), "failed": 0}}

    def forcemerge(self, index: str = "_all",
                   max_num_segments: int = 1) -> dict:
        for n in self.c.metadata.resolve(index):
            self.c._indices[n].engine.force_merge(max_num_segments)
        return {"_shards": {"successful": 1, "failed": 0}}

    def stats(self, index: str = "_all") -> dict:
        out = {n: self.c._indices[n].stats()
               for n in self.c.metadata.resolve(index)}
        total = {"docs": {"count": sum(v["docs"]["count"]
                                       for v in out.values())}}
        return {"_all": {"primaries": total, "total": total},
                "indices": {n: {"primaries": v, "total": v}
                            for n, v in out.items()}}

    def get_alias(self, index: str = "_all",
                  name: Optional[str] = None) -> dict:
        """Every alias (or the one named) by index; like the reference's,
        the `index` argument selects nothing."""
        out: Dict[str, dict] = {}
        for a, am in self.c.metadata.aliases.items():
            if name and a != name:
                continue
            for n, cfg in am.indices.items():
                out.setdefault(n, {"aliases": {}})["aliases"][a] = cfg
        return out

    def update_aliases(self, body: dict) -> dict:
        return self.c.update_aliases(body.get("actions", []))

    def put_alias(self, index: str, name: str,
                  body: Optional[dict] = None) -> dict:
        return self.c.update_aliases(
            [{"add": {"index": index, "alias": name, **(body or {})}}])

    def put_index_template(self, name: str, body: dict) -> dict:
        self.c.metadata.templates[name] = body
        return {"acknowledged": True}

    put_template = put_index_template

    def delete_index_template(self, name: str) -> dict:
        if self.c.metadata.templates.pop(name, None) is None:
            raise ApiError(404, "resource_not_found_exception",
                           f"index template [{name}] missing")
        return {"acknowledged": True}

    def exists_index_template(self, name: str) -> bool:
        return name in self.c.metadata.templates


def _field_terms(mappings, ft, vals, positions: bool,
                 offsets: bool) -> Dict[str, dict]:
    """term -> {term_freq, tokens} of one field's values in a source."""
    terms: Dict[str, dict] = {}
    for v in (vals if isinstance(vals, list) else [vals]):
        if ft.type == "keyword":
            t = terms.setdefault(str(v), {"term_freq": 0})
            t["term_freq"] += 1
            continue
        raw_v = str(v)
        annot_spans: list = []
        if ft.type == "annotated_text":
            raw_v, annot_spans = parse_annotated_text(raw_v)
        toks = list(mappings.index_analyzer(ft).analyze(raw_v))
        for (cs, ce, anns) in annot_spans:
            # an annotation takes its first covered token's position and
            # offsets, as at index time
            tok0 = next((t for t in toks if cs <= t.start_offset < ce), None)
            if tok0 is None:
                continue
            for a in anns:
                toks.append(type(tok0)(text=a, position=tok0.position,
                                       start_offset=tok0.start_offset,
                                       end_offset=tok0.end_offset))
        for tok in toks:
            t = terms.setdefault(tok.text, {"term_freq": 0, "tokens": []})
            t["term_freq"] += 1
            entry = {}
            if positions:
                entry["position"] = tok.position
            if offsets:
                entry["start_offset"] = tok.start_offset
                entry["end_offset"] = tok.end_offset
            if entry:
                t["tokens"].append(entry)
    return terms


def _tv_filter(terms: Dict[str, dict], tv_filter: dict,
               ndocs: int) -> Dict[str, dict]:
    """The term vectors' `filter`: terms within the tf and df limits,
    ranked by tf * log(1 + (n - df + 0.5) / (df + 0.5)), the first
    `max_num_terms` kept, each with its score rounded to 6 places."""
    min_tf = int(tv_filter.get("min_term_freq", 1))
    min_df = int(tv_filter.get("min_doc_freq", 1))
    max_df = int(tv_filter.get("max_doc_freq", 1 << 60))
    kept = {}
    for term, t in terms.items():
        df = t["_df"]
        if t["term_freq"] < min_tf or df < min_df or df > max_df:
            continue
        idf = math.log(1.0 + (ndocs - df + 0.5) / (df + 0.5))
        kept[term] = (t["term_freq"] * idf, t)
    maxn = tv_filter.get("max_num_terms")
    ranked = sorted(kept.items(), key=lambda kv: -kv[1][0])
    if maxn is not None:
        ranked = ranked[: int(maxn)]
    out = {}
    for term, (score, t) in ranked:
        t["score"] = round(score, 6)
        out[term] = t
    return out


def _field_statistics(segs, fname: str) -> dict:
    sum_ttf = sum_df = doc_count = 0
    for seg in segs:
        pb = seg.postings.get(fname)
        if pb is not None:
            sum_df += len(pb.doc_ids)
            # a segment's postings never change: their tf total is kept
            total = pb.__dict__.get("_tf_total")
            if total is None:
                total = pb.__dict__["_tf_total"] = int(pb.tfs.sum())
            sum_ttf += total
        if fname in seg.text_stats:
            doc_count += seg.text_stats[fname].doc_count
        elif pb is not None:
            doc_count += len(np.unique(pb.doc_ids))
    return {"sum_doc_freq": sum_df, "doc_count": doc_count,
            "sum_ttf": sum_ttf}


def _deep_merge(base: dict, patch: dict) -> dict:
    out = dict(base)
    for k, v in patch.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out
