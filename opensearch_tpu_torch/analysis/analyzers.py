"""Analyzers and the per-index analysis registry (the subset of
opensearch_tpu/analysis/analyzers.py this slice serves).

Built-ins: standard, simple, whitespace, keyword, stop. Custom analyzers
may chain a ported tokenizer with the lowercase and stop filters; char
filters, other tokenizers and other filters raise `NotPortedError`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List

from ..errors import NotPortedError
from .filters import (TokenFilter, lowercase_filter, make_stop_filter,
                      resolve_token_filter)
from .tokenizers import (Token, keyword_tokenizer, resolve_tokenizer,
                         standard_tokenizer, whitespace_tokenizer)


@dataclass
class Analyzer:
    name: str
    tokenizer: Callable[[str], List[Token]]
    token_filters: List[TokenFilter] = field(default_factory=list)

    def analyze(self, text: str) -> List[Token]:
        tokens = self.tokenizer(text)
        for tf in self.token_filters:
            tokens = tf(tokens)
        return tokens

    def terms(self, text: str) -> List[str]:
        return [t.text for t in self.analyze(text)]


def _builtin(name: str) -> Analyzer:
    if name == "standard":
        return Analyzer(name, standard_tokenizer, [lowercase_filter])
    if name == "simple":
        return Analyzer(name, resolve_tokenizer("lowercase"), [])
    if name == "whitespace":
        return Analyzer(name, whitespace_tokenizer, [])
    if name == "keyword":
        return Analyzer(name, keyword_tokenizer, [])
    if name == "stop":
        return Analyzer(name, resolve_tokenizer("lowercase"),
                        [make_stop_filter()])
    raise NotPortedError(f"analyzer [{name}]")


class AnalysisRegistry:
    """Per-index analyzer registry built from index settings."""

    def __init__(self, analysis_settings: dict | None = None):
        self._settings = analysis_settings or {}
        for key in ("char_filter", "tokenizer"):
            if self._settings.get(key):
                raise NotPortedError(f"custom analysis [{key}]")
        self._cache: dict[str, Analyzer] = {}

    def get(self, name: str) -> Analyzer:
        if name in self._cache:
            return self._cache[name]
        custom = self._settings.get("analyzer", {}).get(name)
        ana = (self._build_custom(name, custom) if custom is not None
               else _builtin(name))
        self._cache[name] = ana
        return ana

    def normalizer(self, name: str | None) -> Analyzer:
        """Keyword-field normalizers: none (identity) or `lowercase`."""
        if name is None:
            return Analyzer("identity", keyword_tokenizer, [])
        if name == "lowercase":
            return Analyzer("lowercase", keyword_tokenizer, [lowercase_filter])
        raise NotPortedError(f"normalizer [{name}]")

    def _resolve_filter(self, name: str) -> TokenFilter:
        custom = self._settings.get("filter", {}).get(name)
        if custom is not None:
            return resolve_token_filter(custom["type"], custom)
        return resolve_token_filter(name)

    def _build_custom(self, name: str, cfg: dict) -> Analyzer:
        if cfg.get("type", "custom") != "custom":
            return _builtin(cfg["type"])
        if cfg.get("char_filter"):
            raise NotPortedError(f"char_filter in analyzer [{name}]")
        tokenizer = resolve_tokenizer(cfg.get("tokenizer", "standard"))
        filters = [self._resolve_filter(f) for f in cfg.get("filter", [])]
        return Analyzer(name, tokenizer, filters)
