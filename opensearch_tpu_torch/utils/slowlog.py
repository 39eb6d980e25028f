"""Search and indexing slow logs (a copy of opensearch_tpu/utils/slowlog.py
without its flight-recorder link): per-index thresholds from settings
(`index.search.slowlog.threshold.query.warn` and so on), emitted to the
standard `logging` tree and kept in a ring of recent entries that an
index's stats report."""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Any, Deque, Dict, Optional

LEVELS = ("warn", "info", "debug", "trace")
_LOG_LEVEL = {"warn": logging.WARNING, "info": logging.INFO,
              "debug": logging.DEBUG, "trace": logging.DEBUG}


def _parse_thresholds(settings: dict, section: str, op: str
                      ) -> Dict[str, float]:
    """Settings like {"index": {"search": {"slowlog": {"threshold":
    {"query": {"warn": "1s", ...}}}}}}, or the flattened dotted form, ->
    seconds by level."""
    out: Dict[str, float] = {}
    idx = settings.get("index", settings)
    node: Any = idx
    for part in (section, "slowlog", "threshold", op):
        node = node.get(part, {}) if isinstance(node, dict) else {}
    prefixes = (f"{section}.slowlog.threshold.{op}.",
                f"index.{section}.slowlog.threshold.{op}.")
    flat = {k.split(".")[-1]: v
            for src in (settings or {}, idx) if isinstance(src, dict)
            for k, v in src.items()
            if isinstance(k, str) and k.startswith(prefixes)}
    merged = dict(node) if isinstance(node, dict) else {}
    merged.update(flat)
    for level, raw in merged.items():
        if level not in LEVELS or raw in (None, "", "-1", -1):
            continue
        out[level] = _time_s(raw)
    return out


def _time_s(v) -> float:
    if isinstance(v, (int, float)):
        return float(v) / 1000.0
    s = str(v).strip()
    for suf, mult in (("ms", 0.001), ("s", 1.0), ("m", 60.0)):
        if s.endswith(suf):
            return float(s[: -len(suf)]) * mult
    return float(s) / 1000.0


class SlowLog:
    def __init__(self, index_name: str, settings: dict, section: str,
                 op: str, source_limit: int = 1000):
        self.index = index_name
        self.thresholds = _parse_thresholds(settings or {}, section, op)
        self.logger = logging.getLogger(
            f"opensearch_tpu_torch.{section}.slowlog.{op}")
        self.entries: Deque[dict] = deque(maxlen=256)
        self.source_limit = source_limit

    def maybe_log(self, took_s: float, source: Any,
                  extra=None) -> Optional[str]:
        """Log at the most severe threshold `took_s` crosses; -> the level
        or None. `extra` (a dict, or a callable called only when a
        threshold fires) enriches the entry."""
        hit = None
        for level in LEVELS:           # warn is most severe; first hit wins
            thr = self.thresholds.get(level)
            if thr is not None and took_s >= thr:
                hit = level
                break
        if hit is None:
            return None
        msg = str(source)[: self.source_limit]
        entry = {"index": self.index, "level": hit,
                 "took_millis": int(took_s * 1000), "source": msg,
                 "timestamp": time.time()}
        if callable(extra):
            extra = extra()
        if isinstance(extra, dict):
            entry.update(extra)
        self.entries.append(entry)
        self.logger.log(_LOG_LEVEL[hit], "[%s] took[%dms], source[%s]",
                        self.index, entry["took_millis"], msg)
        return hit

    def stats(self) -> dict:
        return {"thresholds": self.thresholds,
                "recent": list(self.entries)[-10:]}
