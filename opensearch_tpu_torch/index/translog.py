"""Write-ahead log (a copy of opensearch_tpu/index/translog.py without its
ingest instrumentation).

Every index/delete op is appended durably (one `fsync` per op) before it
is acknowledged; on engine open, the ops after the last commit point are
replayed. Format: JSONL generations (`translog-<gen>.log`).
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional


class Translog:
    def __init__(self, path: str, generation: int = 0):
        self.dir = path
        os.makedirs(path, exist_ok=True)
        self.generation = generation
        self._fh = open(self._gen_path(generation), "a", encoding="utf-8")

    def _gen_path(self, gen: int) -> str:
        return os.path.join(self.dir, f"translog-{gen}.log")

    def add_index(self, doc_id: str, source: dict, routing: Optional[str],
                  seq_no: int) -> None:
        self._append({"op": "index", "_id": doc_id, "_source": source,
                      "routing": routing, "seq_no": seq_no})

    def add_delete(self, doc_id: str, seq_no: int) -> None:
        self._append({"op": "delete", "_id": doc_id, "seq_no": seq_no})

    def _append(self, rec: dict) -> None:
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def rollover(self) -> int:
        """Start a new generation (at flush); returns its id."""
        self._fh.close()
        self.generation += 1
        self._fh = open(self._gen_path(self.generation), "a",
                        encoding="utf-8")
        return self.generation

    def prune_below(self, gen: int) -> None:
        """Delete generations < gen, made durable by a commit point."""
        for g in range(gen):
            p = self._gen_path(g)
            if os.path.exists(p):
                os.remove(p)

    def replay_from(self, gen: int) -> Iterator[dict]:
        g = gen
        while True:
            p = self._gen_path(g)
            if not os.path.exists(p):
                break
            with open(p, encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if line:
                        yield json.loads(line)
            g += 1

    def close(self) -> None:
        self._fh.close()
