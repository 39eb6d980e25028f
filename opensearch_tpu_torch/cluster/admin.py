"""Index administration: settings updates, close and open, and the resize
family (shrink, split, clone); a copy of opensearch_tpu/cluster/admin.py
without the cluster settings, over the port's client.

Settings are host metadata. A dynamic setting applies to an open index, a
static one only while the index is closed, a final one never; the slow
log thresholds take effect at once, and `number_of_replicas` above 0
raises NotPortedError, as at create. Closing an index flushes it and
marks it closed; opening it re-applies its analysis and similarity
settings to the live mappings and searcher, so no segment is rebuilt and
nothing is uploaded to the card again. A resize re-indexes every live
document's `_source` through the target's write path, then refreshes and
force-merges it, as the reference does; a target of more than one shard
raises NotPortedError where the reference's shard-count rules let it
through.

`client` is the port's RestClient: its `metadata` (cluster/state.py), its
index services by name (`_indices`) and its create, alias and persist
helpers.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

from ..errors import ClusterStateError, IndexNotFoundError, NotPortedError
from ..utils.slowlog import SlowLog


class IndexClosedError(ClusterStateError):
    """HTTP 400 index_closed_exception analog."""


class SettingsError(ClusterStateError):
    """HTTP 400 illegal_argument_exception analog for settings updates."""


# dynamic settings: updatable on an open index
_DYNAMIC_EXACT = {
    "number_of_replicas",
    "refresh_interval",
    "max_result_window",
    "max_inner_result_window",
    "default_pipeline",
    "final_pipeline",
    "search.default_pipeline",
    "blocks.read_only",
    "blocks.read_only_allow_delete",
    "blocks.read",
    "blocks.write",
    "blocks.metadata",
    "highlight.max_analyzed_offset",
    "requests.cache.enable",
}
_DYNAMIC_PREFIXES = (
    "search.slowlog.",
    "indexing.slowlog.",
    "routing.allocation.",
    "lifecycle.",
)

# static settings change only while the index is closed; final ones never
_FINAL = {"number_of_shards", "uuid", "creation_date", "version.created",
          "routing_partition_size"}
_STATIC_PREFIXES = ("analysis.", "similarity.", "sort.", "merge.")
_STATIC_EXACT = {"codec", "knn"}


def flatten(settings: dict, prefix: str = "") -> Dict[str, object]:
    """{"index": {"blocks": {"write": true}}} -> {"blocks.write": True};
    accepts dotted keys and a leading "index." prefix."""
    out: Dict[str, object] = {}
    for k, v in (settings or {}).items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, f"{key}."))
        else:
            out[key] = v
    return {k[6:] if k.startswith("index.") else k: v
            for k, v in out.items()}


def classify(key: str) -> str:
    if key in _FINAL:
        return "final"
    if key in _DYNAMIC_EXACT or key.startswith(_DYNAMIC_PREFIXES):
        return "dynamic"
    if key in _STATIC_EXACT or key.startswith(_STATIC_PREFIXES):
        return "static"
    return "unknown"


def _set_nested(d: dict, dotted: str, value) -> None:
    parts = dotted.split(".")
    for p in parts[:-1]:
        nxt = d.get(p)
        if not isinstance(nxt, dict):
            nxt = d[p] = {}
        d = nxt
    d[parts[-1]] = value


def _has_nested(d: dict, dotted: str) -> bool:
    for p in dotted.split("."):
        if not isinstance(d, dict) or p not in d:
            return False
        d = d[p]
    return True


def update_index_settings(client, expression: str, body: dict,
                          preserve_existing: bool = False) -> dict:
    """PUT /{index}/_settings: every target validated first (all or
    nothing), then each updated and persisted."""
    flat = flatten(body.get("settings", body))
    names = client.metadata.resolve(expression, allow_no_indices=False)
    for name in names:
        closed = client._indices[name].meta.state == "close"
        for key, value in flat.items():
            cls = classify(key)
            if cls == "final":
                raise SettingsError(
                    f"final index setting [index.{key}], not updateable")
            if cls == "static" and not closed:
                raise SettingsError(
                    f"Can't update non dynamic settings [[index.{key}]] "
                    f"for open indices [[{name}]]")
            if cls == "unknown":
                raise SettingsError(f"unknown setting [index.{key}]")
            if key == "number_of_replicas":
                if int(value) < 0:
                    raise SettingsError("number_of_replicas must be >= 0")
                if int(value) > 0:
                    raise NotPortedError("number_of_replicas > 0")
    for name in names:
        svc = client._indices[name]
        idx = svc.meta.settings.setdefault("index", {})
        for key, value in flat.items():
            if preserve_existing and _has_nested(idx, key):
                continue
            _set_nested(idx, key, value)
        _apply_effects(svc, flat)
        client._persist_meta(svc)
    return {"acknowledged": True}


def _apply_effects(svc, flat: Dict[str, object]) -> None:
    if any(k.startswith("search.slowlog.") for k in flat):
        svc.search_slowlog = SlowLog(svc.name, svc.meta.settings, "search",
                                     "query")
    if any(k.startswith("indexing.slowlog.") for k in flat):
        svc.index_slowlog = SlowLog(svc.name, svc.meta.settings, "indexing",
                                    "index")


def close_index(client, expression: str) -> dict:
    """POST /{index}/_close: flush, then mark closed; searches and writes
    then fail with index_closed_exception until the index reopens."""
    names = client.metadata.resolve(expression, allow_no_indices=False)
    for name in names:
        svc = client._indices[name]
        if svc.meta.state == "close":
            continue
        svc.engine.flush()
        svc.meta.state = "close"
        client._persist_meta(svc)
    return {"acknowledged": True, "shards_acknowledged": True,
            "indices": {n: {"closed": True} for n in names}}


def open_index(client, expression: str) -> dict:
    names = client.metadata.resolve(expression, allow_no_indices=False)
    for name in names:
        svc = client._indices[name]
        if svc.meta.state != "close":
            continue
        svc.meta.state = "open"
        svc.reapply_static_settings()
        client._persist_meta(svc)
    return {"acknowledged": True, "shards_acknowledged": True}


def check_open(client, names: List[str], expression) -> List[str]:
    """Closed indices drop out of wildcard resolutions; a closed index
    named, or behind a named alias, raises."""
    explicit = set()
    if expression not in (None, "", "_all", "*"):
        exprs = (expression if isinstance(expression, list)
                 else str(expression).split(","))
        for e in exprs:
            e = e.strip()
            if "*" in e or "?" in e:
                continue
            explicit.add(e)
            if e not in client._indices:
                try:
                    explicit.update(client.metadata.resolve(e))
                except ClusterStateError:
                    pass
    out = []
    for n in names:
        svc = client._indices.get(n)
        if svc is not None and svc.meta.state == "close":
            if n in explicit:
                raise IndexClosedError(f"closed index [{n}]")
            continue
        out.append(n)
    return out


def _truthy(v) -> bool:
    return v is True or v == "true" or v == 1


def resize_index(client, source: str, target: str, kind: str,
                 body: Optional[dict] = None) -> dict:
    """_shrink / _split / _clone: a shrink needs a divisor of the source's
    shard count, a split a multiple, a clone the same count; the source
    must be write-blocked. The target takes the source's settings without
    its blocks, the request's over them, and the source's mapping."""
    body = body or {}
    if source not in client._indices:
        raise IndexNotFoundError(f"no such index [{source}]")
    if target in client._indices:
        raise SettingsError(f"index [{target}] already exists")
    svc = client._indices[source]
    if svc.meta.state == "close":
        raise IndexClosedError(f"closed index [{source}]")
    idx_settings = svc.meta.settings.get("index", {})
    blocks = idx_settings.get("blocks", {})
    if not (_truthy(blocks.get("write"))
            or _truthy(blocks.get("read_only"))):
        raise SettingsError(
            f"index {source} must be read-only to resize index. use "
            f"\"index.blocks.write=true\"")
    s_shards = svc.meta.num_shards
    tset = flatten(body.get("settings", {}))
    t_shards = int(tset.get("number_of_shards",
                            1 if kind == "shrink" else s_shards))
    if kind == "shrink":
        if t_shards > s_shards or s_shards % t_shards:
            raise SettingsError(
                f"the number of source shards [{s_shards}] must be a "
                f"multiple of [{t_shards}]")
    elif kind == "split":
        if t_shards < s_shards or t_shards % s_shards:
            raise SettingsError(
                f"the number of target shards [{t_shards}] must be a "
                f"multiple of the source shards [{s_shards}]")
    elif t_shards != s_shards:
        raise SettingsError("clone must keep the source shard count")
    if t_shards != 1:
        raise NotPortedError("number_of_shards > 1")
    new_index = copy.deepcopy({k: v for k, v in idx_settings.items()
                               if k != "blocks"})
    new_index["number_of_shards"] = t_shards
    for key, value in tset.items():
        _set_nested(new_index, key, value)
    client._create_index(target, {"settings": {"index": new_index},
                                  "mappings": svc.mappings.to_dict()})
    teng = client._indices[target].engine
    svc.engine.refresh()
    copied = 0
    for seg in svc.engine.segments:
        for local in range(seg.ndocs):
            if not seg.live[local]:
                continue
            doc_id = seg.ids[local]
            teng.index_doc(doc_id, seg.sources[local])
            copied += 1
    teng.refresh()
    teng.force_merge(1)
    for alias, cfg in (body.get("aliases") or {}).items():
        client._put_alias(alias, target, cfg or {})
    return {"acknowledged": True, "shards_acknowledged": True,
            "index": target, "copied_docs": copied}
