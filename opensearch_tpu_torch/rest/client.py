"""RestClient: the dict-in / dict-out API facade (the index, bulk, search,
msearch and indices subset of opensearch_tpu/rest/client.py), with the
same request and response shapes for this subset.

An index has one shard and no replicas. Its segments' postings live on the
client's device: a card unless the caller asks for the CPU.
"""

from __future__ import annotations

import json
import uuid
from typing import Dict, List, Optional

import torch

from ..analysis import AnalysisRegistry
from ..device import resolve_device
from ..errors import NotPortedError
from ..index.engine import Engine, VersionConflictError
from ..index.mappings import Mappings
from ..models.similarity import resolve_similarity
from ..search import query_dsl as dsl
from ..search.executor import ShardSearcher, msearch_batched, search_shards

_INDEX_SETTINGS = {"number_of_shards", "number_of_replicas", "analysis",
                   "similarity"}


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
    """One index: its mappings, its single shard's engine and searcher."""

    def __init__(self, name: str, body: Optional[dict],
                 device: torch.device):
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
        self.engine = Engine(self.mappings, device=device)
        self.searcher = ShardSearcher(self.engine, device,
                                      similarity=self.similarity)


class RestClient:
    """`device` is where segment postings live and the kernels run: the
    current card by default; "cpu" runs the plain versions and is taken
    only when asked for."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.indices = IndicesClient(self)
        self._indices: Dict[str, IndexService] = {}

    # ---------------- index resolution ----------------

    def _svc(self, index: str) -> IndexService:
        if index == "_all":
            if len(self._indices) != 1:
                raise NotPortedError("a search over several indices")
            return next(iter(self._indices.values()))
        svc = self._indices.get(index)
        if svc is None:
            raise ApiError(404, "index_not_found_exception",
                           f"no such index [{index}]")
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

    def bulk(self, body, index: Optional[str] = None,
             refresh: bool = False) -> dict:
        """Bulk API: an NDJSON string or a list of alternating action and
        source dicts. `index` and `create` actions are served."""
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
            if action not in ("index", "create"):
                raise NotPortedError(f"bulk action [{action}]")
            idx = meta.get("_index", index)
            doc_id = meta.get("_id")
            routing = meta.get("routing", meta.get("_routing"))
            src = lines[i]
            i += 1
            try:
                res = self.index(idx, src, id=doc_id, routing=routing,
                                 op_type=action)
                status = 201 if res.get("result") == "created" else 200
                items.append({action: {**res, "status": status}})
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
        as one batch: one kernel launch per shape group and segment."""
        pairs = []
        for i in range(0, len(body), 2):
            pairs.append((body[i].get("index", index or "_all"),
                          body[i + 1]))
        names = {idx for idx, _ in pairs}
        if len(names) > 1:
            raise NotPortedError("an msearch over several indices")
        if not pairs:
            return {"took": 0, "responses": []}
        svc = self._svc(names.pop())
        responses = msearch_batched([svc.searcher], [b for _, b in pairs],
                                    index_name=svc.name)
        return {"took": 0, "responses": responses}


class IndicesClient:
    def __init__(self, client: RestClient):
        self.c = client

    def create(self, index: str, body: Optional[dict] = None) -> dict:
        if index in self.c._indices:
            raise ApiError(400, "resource_already_exists_exception",
                           f"index [{index}] already exists")
        self.c._indices[index] = IndexService(index, body, self.c.device)
        return {"acknowledged": True, "shards_acknowledged": True,
                "index": index}

    def refresh(self, index: str = "_all") -> dict:
        names = list(self.c._indices) if index == "_all" else [index]
        for n in names:
            self.c._svc(n).engine.refresh()
        return {"_shards": {"successful": 1, "failed": 0}}
