"""RestClient: the dict-in / dict-out API facade (the document, bulk,
search, msearch, count, explain, validate_query, field_caps, scroll,
point-in-time and indices subset of opensearch_tpu/rest/client.py), with
the same request and response shapes for this subset.

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
`data_path`, each index keeps its metadata in
`<data_path>/<index>/index_meta.json` and its shard (translog, segments,
commit point) under `<data_path>/<index>/0`, and a client opened on the
same path recovers every index found there.

A missing index raises `IndexNotFoundError` and creating an existing one
`ResourceAlreadyExistsError` (`errors.py`), where the reference's client
raises them; msearch turns a missing index into its per-body error entry.
"""

from __future__ import annotations

import copy
import fnmatch
import json
import os
import shutil
import time
import uuid
from typing import Dict, List, Optional

import torch

from ..analysis import AnalysisRegistry
from ..device import resolve_device
from ..errors import (IndexNotFoundError, NotPortedError,
                      ResourceAlreadyExistsError)
from ..index.engine import DocLocation, Engine, VersionConflictError
from ..index.mappings import Mappings
from ..models.similarity import resolve_similarity
from ..script import painless_lite as pl
from ..search import compiler as C
from ..search import query_dsl as dsl
from ..search.executor import (ShardSearcher, msearch_batched,
                               search_shards, search_snapshot)
from ..search.explain import explain_doc
from ..utils import deadline as DL

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


class IndexService:
    """One index: its mappings, its single shard's engine and searcher.
    With a `data_path` the shard's engine lives under
    `<data_path>/<name>/0`. `settings` is the create body's settings as
    the reference keeps them ({"index": {...}}); `mapping_body` the
    create body's mapping with every put_mapping body merged in, which
    the index's metadata file persists."""

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
        self.settings = {"index": settings}
        self.mapping_body = dict(mapping or {})
        self.mappings = Mappings(mapping,
                                 analysis=AnalysisRegistry(
                                     settings.get("analysis")),
                                 dynamic=(mapping or {}).get("dynamic", True))
        sim = settings.get("similarity", {})
        self.similarity = resolve_similarity(
            sim.get("default") if isinstance(sim, dict) else None)
        path = os.path.join(data_path, name, "0") if data_path else None
        self.engine = Engine(self.mappings, path=path, device=device)
        self.searcher = ShardSearcher(self.engine, device,
                                      similarity=self.similarity,
                                      index_name=name)


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

    def _resolve(self, expression, allow_no_indices: bool = True
                 ) -> List[str]:
        """Index names of an expression (`_all`, `*`, names, wildcards,
        comma lists; the reference's `resolve` without aliases and data
        streams)."""
        if expression in (None, "", "_all", "*"):
            return sorted(self._indices)
        exprs = (expression if isinstance(expression, list)
                 else str(expression).split(","))
        out: List[str] = []
        for ex in exprs:
            ex = ex.strip()
            if ex in self._indices:
                out.append(ex)
            elif "*" in ex or "?" in ex:
                out.extend(sorted(n for n in self._indices
                                  if fnmatch.fnmatch(n, ex)))
            else:
                raise IndexNotFoundError(f"no such index [{ex}]")
        seen: set = set()
        uniq = [x for x in out if not (x in seen or seen.add(x))]
        if not uniq and not allow_no_indices:
            raise IndexNotFoundError(f"no indices match [{expression}]")
        return uniq

    def _persist_meta(self, svc: IndexService) -> None:
        """Write the index's metadata: its settings and its mapping as
        the reference persists it (`to_dict()`, so the fields mapped
        dynamically so far), with the mapping bodies it was given merged
        over it, which keep the field options `to_dict` leaves out."""
        if self.data_path is None:
            return
        with open(os.path.join(self.data_path, svc.name,
                               "index_meta.json"), "w") as fh:
            json.dump({"settings": svc.settings,
                       "mappings": _deep_merge(svc.mappings.to_dict(),
                                               svc.mapping_body)}, fh)

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
        and `detect_noop` holds), `doc_as_upsert`, `upsert`, a script
        (painless-lite over a deep copy of the source: `ctx.op` "none" or
        "noop" is a no-op, "delete" deletes) and `scripted_upsert` (the
        script runs over the upsert document)."""
        svc = self._svc_for_write(index)
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
                self._indices[idx].engine.refresh()
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
        pit = body.pop("pit", None)
        try:
            if pit is not None:
                return self._search_pit(pit, body)
            svc = self._svc(index)
            resp = search_shards([svc.searcher], body, index_name=svc.name)
        except dsl.QueryParseError as e:
            raise ApiError(400, "parsing_exception", str(e))
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
        if self._indices.get(svc.name) is not svc:
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
        """A point in time: the index's segment list of this moment."""
        names = self._resolve(index)
        if len(names) != 1:
            raise NotPortedError("a point in time over several indices")
        ka = parse_keepalive_s(keep_alive)
        pid = uuid.uuid4().hex
        self._pits[pid] = {**self._snapshot(self._indices[names[0]]),
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

    # ---------------- count, explain, validate, field caps ----------------

    def count(self, index: str = "_all", body: Optional[dict] = None
              ) -> dict:
        body = dict(body or {})
        body["size"] = 0
        body.pop("sort", None)
        svc = self._svc(index)
        resp = search_shards([svc.searcher], body, index_name=svc.name)
        return {"count": resp["hits"]["total"]["value"],
                "_shards": resp["_shards"]}

    def explain(self, index: str, id: str, body: dict) -> dict:
        """One doc's explanation under the body's query, with the
        index-wide statistics; a buffered id is refreshed first, a
        missing one is a 404."""
        svc = self._svc(index)
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
        lroot = C.rewrite(dsl.parse_query(body.get("query")), ctx)
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
            names = self._resolve(index)
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
        names = self._resolve(index)
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

    def analyze(self, index: Optional[str] = None,
                body: Optional[dict] = None) -> dict:
        """The tokens of `text` (a string or a list) under the body's
        `analyzer`, or a `field`'s index analyzer, of an index's registry
        or of the built-ins (the reference's `analyze`)."""
        body = body or {}
        text = body.get("text", "")
        texts = text if isinstance(text, list) else [text]
        if index is not None:
            svc = self.c._svc(index)
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
        if index in self.c._indices:
            raise ResourceAlreadyExistsError(
                f"index [{index}] already exists")
        svc = IndexService(index, body, self.c.device, self.c.data_path)
        self.c._indices[index] = svc
        self.c._persist_meta(svc)
        return {"acknowledged": True, "shards_acknowledged": True,
                "index": index}

    def delete(self, index: str) -> dict:
        """Drop every resolved index: its device state, its engine and,
        with a data path, its files. A scroll or point in time over it
        then pages nothing, as the reference's."""
        try:
            names = self.c._resolve(index, allow_no_indices=False)
        except IndexNotFoundError as e:
            raise ApiError(404, "index_not_found_exception", str(e))
        for n in names:
            svc = self.c._indices.pop(n)
            for seg in svc.engine.segments:
                seg.release_device()
            svc.engine.close()
            if self.c.data_path is not None:
                p = os.path.join(self.c.data_path, n)
                if os.path.exists(p):
                    shutil.rmtree(p)
        return {"acknowledged": True}

    def exists(self, index: str) -> bool:
        try:
            return bool(self.c._resolve(index, allow_no_indices=False))
        except IndexNotFoundError:
            return False

    def get(self, index: str) -> dict:
        out = {}
        for n in self.c._resolve(index, allow_no_indices=False):
            svc = self.c._indices[n]
            idx = svc.settings["index"]
            out[n] = {"settings": {"index": {
                **idx, "number_of_shards": int(idx.get("number_of_shards",
                                                       1)), "uuid": n}},
                "mappings": svc.mappings.to_dict(), "aliases": {}}
        return out

    def get_mapping(self, index: str = "_all") -> dict:
        return {n: {"mappings": self.c._indices[n].mappings.to_dict()}
                for n in self.c._resolve(index)}

    def put_mapping(self, index: str, body: dict) -> dict:
        """Merge `body` into each resolved index's mapping and persist
        it."""
        for n in self.c._resolve(index, allow_no_indices=False):
            svc = self.c._indices[n]
            svc.mappings.merge(body)
            svc.mapping_body = _deep_merge(svc.mapping_body, body)
            self.c._persist_meta(svc)
        return {"acknowledged": True}

    def get_settings(self, index: str = "_all") -> dict:
        return {n: {"settings": {"index": self.c._indices[n].settings[
            "index"]}} for n in self.c._resolve(index)}

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
