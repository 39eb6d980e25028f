"""RestClient: the dict-in / dict-out API facade (the document, bulk,
search, msearch and indices subset of opensearch_tpu/rest/client.py),
with the same request and response shapes for this subset.

An index has one shard and no replicas. Its segments' postings live on the
client's device: a card unless the caller asks for the CPU. With a
`data_path`, each index keeps its metadata in
`<data_path>/<index>/index_meta.json` and its shard (translog, segments,
commit point) under `<data_path>/<index>/0`, and a client opened on the
same path recovers every index found there.

A missing index raises `IndexNotFoundError` and creating an existing one
`ResourceAlreadyExistsError` (`errors.py`), where the reference's client
raises them; msearch turns a missing index into its per-body error entry.
"""

from __future__ import annotations

import json
import os
import uuid
from typing import Dict, List, Optional

import torch

from ..analysis import AnalysisRegistry
from ..device import resolve_device
from ..errors import (IndexNotFoundError, NotPortedError,
                      ResourceAlreadyExistsError)
from ..index.engine import Engine, VersionConflictError
from ..index.mappings import Mappings
from ..models.similarity import resolve_similarity
from ..search import query_dsl as dsl
from ..search.executor import ShardSearcher, msearch_batched, search_shards

_INDEX_SETTINGS = {"number_of_shards", "number_of_replicas", "analysis",
                   "similarity"}

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


class IndexService:
    """One index: its mappings, its single shard's engine and searcher.
    With a `data_path` the shard's engine lives under
    `<data_path>/<name>/0`."""

    def __init__(self, name: str, body: Optional[dict],
                 device: torch.device, data_path: Optional[str] = None):
        body = body or {}
        for key in body:
            if key not in ("settings", "mappings"):
                raise NotPortedError(f"create index option [{key}]")
        settings = dict(body.get("settings", {}))
        settings = dict(settings.get("index", settings))
        for key in settings:
            if key not in _INDEX_SETTINGS:
                raise NotPortedError(f"index setting [{key}]")
        if int(settings.get("number_of_shards", 1)) != 1:
            raise NotPortedError("number_of_shards > 1")
        if int(settings.get("number_of_replicas", 0)) != 0:
            raise NotPortedError("number_of_replicas > 0")
        mapping = body.get("mappings")
        self.name = name
        self.mappings = Mappings(mapping,
                                 analysis=AnalysisRegistry(
                                     settings.get("analysis")),
                                 dynamic=(mapping or {}).get("dynamic", True))
        sim = settings.get("similarity", {})
        self.similarity = resolve_similarity(
            sim.get("default") if isinstance(sim, dict) else None)
        self.body = body
        path = os.path.join(data_path, name, "0") if data_path else None
        self.engine = Engine(self.mappings, path=path, device=device)
        self.searcher = ShardSearcher(self.engine, device,
                                      similarity=self.similarity)


class RestClient:
    """`device` is where segment postings live and the kernels run: the
    current card by default; "cpu" runs the plain versions and is taken
    only when asked for."""

    def __init__(self, device="cuda", data_path: Optional[str] = None):
        self.device = resolve_device(device)
        self.data_path = data_path
        self.indices = IndicesClient(self)
        self._indices: Dict[str, IndexService] = {}
        if data_path is not None:
            os.makedirs(data_path, exist_ok=True)
            self._recover_indices()

    def _recover_indices(self) -> None:
        """Open every index persisted under `data_path`: its metadata,
        then its shard from the last commit point and the translog."""
        for name in sorted(os.listdir(self.data_path)):
            meta = os.path.join(self.data_path, name, "index_meta.json")
            if not os.path.exists(meta):
                continue
            with open(meta) as fh:
                body = json.load(fh)
            self._indices[name] = IndexService(name, body, self.device,
                                               self.data_path)

    def close(self) -> None:
        for svc in self._indices.values():
            svc.engine.close()

    def __getattr__(self, name: str):
        if name in REFERENCE_CALLS:
            raise NotPortedError(f"rest call [{name}]")
        raise AttributeError(name)

    # ---------------- index resolution ----------------

    def _svc(self, index: str) -> IndexService:
        if index == "_all":
            if len(self._indices) != 1:
                raise NotPortedError("a search over several indices")
            return next(iter(self._indices.values()))
        svc = self._indices.get(index)
        if svc is None:
            raise IndexNotFoundError(f"no such index [{index}]")
        return svc

    def _svc_for_write(self, index: str) -> IndexService:
        if index not in self._indices:
            self.indices.create(index)
        return self._indices[index]

    # ---------------- document APIs ----------------

    def index(self, index: str, body: dict, id: Optional[str] = None,
              routing: Optional[str] = None, refresh: bool = False,
              op_type: str = "index", if_seq_no: Optional[int] = None,
              if_primary_term: Optional[int] = None) -> dict:
        svc = self._svc_for_write(index)
        doc_id = id if id is not None else uuid.uuid4().hex[:20]
        try:
            res = svc.engine.index_doc(doc_id, body, routing, if_seq_no,
                                       if_primary_term, op_type)
        except VersionConflictError as e:
            raise ApiError(409, "version_conflict_engine_exception", str(e))
        except ValueError as e:
            raise ApiError(400, "mapper_parsing_exception", str(e))
        if refresh:
            svc.engine.refresh()
        res["_index"] = svc.name
        res["_shards"] = {"total": 1, "successful": 1, "failed": 0}
        return res

    def get(self, index: str, id: str, routing: Optional[str] = None
            ) -> dict:
        svc = self._svc(index)
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
        svc = self._svc(index)
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
               routing: Optional[str] = None, refresh: bool = False) -> dict:
        """Partial-doc update and upserts (reference UpdateHelper): `doc`
        deep-merged into the current source (a no-op when nothing changes
        and `detect_noop` holds), `doc_as_upsert`, `upsert`. Update
        scripts are not ported and raise."""
        svc = self._svc_for_write(index)
        current = svc.engine.get(id)
        if current is None:
            if body.get("doc_as_upsert") and "doc" in body:
                return self.index(index, body["doc"], id=id,
                                  routing=routing, refresh=refresh)
            if "upsert" in body:
                if body.get("scripted_upsert") and "script" in body:
                    raise NotPortedError("update script")
                return self.index(index, dict(body["upsert"]), id=id,
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
            raise NotPortedError("update script")
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
                self._indices[idx].engine.refresh()
        return {"took": 0, "errors": errors, "items": items}

    # ---------------- search APIs ----------------

    def search(self, index: str = "_all", body: Optional[dict] = None,
               **kw) -> dict:
        body = dict(body or {})
        body.update({k: v for k, v in kw.items() if v is not None})
        svc = self._svc(index)
        try:
            return search_shards([svc.searcher], body, index_name=svc.name)
        except dsl.QueryParseError as e:
            raise ApiError(400, "parsing_exception", str(e))

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
        try:
            svc = self._svc(names.pop())
        except IndexNotFoundError as e:
            return {"took": 0, "responses": [
                {"error": {"type": type(e).__name__, "reason": str(e)}}
                for _ in pairs]}
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

    def create(self, index: str, body: Optional[dict] = None) -> dict:
        if index in self.c._indices:
            raise ResourceAlreadyExistsError(
                f"index [{index}] already exists")
        svc = IndexService(index, body, self.c.device, self.c.data_path)
        self.c._indices[index] = svc
        if self.c.data_path is not None:
            with open(os.path.join(self.c.data_path, index,
                                   "index_meta.json"), "w") as fh:
                json.dump(svc.body, fh)
        return {"acknowledged": True, "shards_acknowledged": True,
                "index": index}

    def refresh(self, index: str = "_all") -> dict:
        names = list(self.c._indices) if index == "_all" else [index]
        for n in names:
            self.c._svc(n).engine.refresh()
        return {"_shards": {"successful": 1, "failed": 0}}

    def flush(self, index: str = "_all") -> dict:
        names = list(self.c._indices) if index == "_all" else [index]
        for n in names:
            self.c._svc(n).engine.flush()
        return {"_shards": {"successful": len(names), "failed": 0}}

    def forcemerge(self, index: str = "_all",
                   max_num_segments: int = 1) -> dict:
        names = list(self.c._indices) if index == "_all" else [index]
        for n in names:
            self.c._svc(n).engine.force_merge(max_num_segments)
        return {"_shards": {"successful": 1, "failed": 0}}


def _deep_merge(base: dict, patch: dict) -> dict:
    out = dict(base)
    for k, v in patch.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out
