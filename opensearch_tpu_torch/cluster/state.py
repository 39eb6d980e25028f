"""Index metadata: each index's settings and state, the aliases and the
index templates (a copy of opensearch_tpu/cluster/state.py without data
streams, which the port does not serve).

One client owns the metadata. `resolve` turns an index expression (names,
comma lists, wildcards, aliases) into concrete index names; `write_index`
turns a name or an alias into the one index a write goes to;
`matching_templates` gives the templates whose patterns match a new
index's name, highest priority first.
"""

from __future__ import annotations

import fnmatch
import time
from dataclasses import dataclass, field as dc_field
from typing import Dict, List

from ..errors import ClusterStateError, IndexNotFoundError


@dataclass
class IndexMetadata:
    name: str
    settings: dict = dc_field(default_factory=dict)
    creation_date: float = dc_field(default_factory=time.time)
    state: str = "open"

    @property
    def num_shards(self) -> int:
        s = self.settings.get("index", {}).get(
            "number_of_shards", self.settings.get("number_of_shards", 1))
        return int(s)


@dataclass
class AliasMetadata:
    alias: str
    # index -> its alias options ({filter, routing, is_write_index})
    indices: Dict[str, dict] = dc_field(default_factory=dict)


class ClusterMetadata:
    """Indices, aliases and index templates."""

    def __init__(self):
        self.indices: Dict[str, IndexMetadata] = {}
        self.aliases: Dict[str, AliasMetadata] = {}
        self.templates: Dict[str, dict] = {}

    def resolve(self, expression, allow_no_indices: bool = True
                ) -> List[str]:
        """Wildcards, comma lists and aliases -> concrete index names."""
        if expression in (None, "", "_all", "*"):
            return sorted(self.indices)
        exprs = (expression if isinstance(expression, list)
                 else str(expression).split(","))
        out: List[str] = []
        for ex in exprs:
            ex = ex.strip()
            if ex in self.indices:
                out.append(ex)
                continue
            if ex in self.aliases:
                out.extend(sorted(self.aliases[ex].indices))
                continue
            if "*" in ex or "?" in ex:
                matched = [n for n in self.indices if fnmatch.fnmatch(n, ex)]
                matched += [n for a, am in self.aliases.items()
                            if fnmatch.fnmatch(a, ex) for n in am.indices]
                out.extend(sorted(set(matched)))
                continue
            raise IndexNotFoundError(f"no such index [{ex}]")
        seen: set = set()
        uniq = [x for x in out if not (x in seen or seen.add(x))]
        if not uniq and not allow_no_indices:
            raise IndexNotFoundError(f"no indices match [{expression}]")
        return uniq

    def write_index(self, name: str) -> str:
        """An index name, or an alias's write index."""
        if name in self.indices:
            return name
        am = self.aliases.get(name)
        if am is not None:
            writes = [i for i, cfg in am.indices.items()
                      if cfg.get("is_write_index")]
            if len(writes) == 1:
                return writes[0]
            if len(am.indices) == 1:
                return next(iter(am.indices))
            raise ClusterStateError(
                f"alias [{name}] has multiple indices and no write index")
        raise IndexNotFoundError(f"no such index [{name}]")

    def matching_templates(self, index_name: str) -> List[dict]:
        matches = [t for t in self.templates.values()
                   if any(fnmatch.fnmatch(index_name, p)
                          for p in t.get("index_patterns", []))]
        return sorted(matches,
                      key=lambda t: -t.get("priority", t.get("order", 0)))
