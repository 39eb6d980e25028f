"""Analyzers and the per-index analysis registry (a copy of
opensearch_tpu/analysis/analyzers.py). Analog of OpenSearch's
`AnalysisRegistry` and the built-in analyzers wired in `AnalysisModule`.

An Analyzer = [char filters] -> tokenizer -> [token filters]. Custom
analyzers, tokenizers, token filters, char filters and normalizers are
declared in index settings as in OpenSearch:

    {"analysis": {"analyzer": {"my": {"type": "custom", "tokenizer": "standard",
                                       "filter": ["lowercase", "stop"]}}}}

The reference tokenizes a standard + lowercase chain's ASCII text with
its C++ tokenizer (`native.tokenize_ascii`); the port keeps no C++
tokenizer: its Python standard tokenizer gives the same tokens and
offsets. An unknown analyzer, normalizer, tokenizer or filter is the
reference's ValueError (a 400).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List

from .filters import (CharFilter, TokenFilter, lowercase_filter, make_stop_filter,
                      porter_stem_filter, resolve_char_filter, resolve_token_filter)
from .tokenizers import Token, keyword_tokenizer, resolve_tokenizer, standard_tokenizer, whitespace_tokenizer


@dataclass
class Analyzer:
    name: str
    tokenizer: Callable[[str], List[Token]]
    token_filters: List[TokenFilter] = field(default_factory=list)
    char_filters: List[CharFilter] = field(default_factory=list)

    def analyze(self, text: str) -> List[Token]:
        for cf in self.char_filters:
            text = cf(text)
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
        return Analyzer(name, resolve_tokenizer("lowercase"), [make_stop_filter()])
    if name == "english":
        # reference EnglishAnalyzerProvider: std -> lowercase -> stop -> porter
        return Analyzer(name, standard_tokenizer,
                        [lowercase_filter, make_stop_filter(), porter_stem_filter])
    if name == "cjk":
        # reference CjkAnalyzerProvider: width fold -> lowercase -> bigram
        # -> stop (std tokenizer keeps CJK runs; the bigram filter splits)
        from .unicode_plugins import cjk_bigram_filter, cjk_width_filter
        return Analyzer(name, standard_tokenizer,
                        [cjk_width_filter, lowercase_filter,
                         cjk_bigram_filter, make_stop_filter()])
    if name == "smartcn":
        # reference plugins/analysis-smartcn: dictionary segmentation
        # (jieba-backed here — its dictionary ships in the wheel)
        from .cjk_morph import smartcn_tokenizer
        return Analyzer(name, smartcn_tokenizer, [lowercase_filter])
    if name == "kuromoji":
        # reference plugins/analysis-kuromoji: script-run segmentation +
        # kanji-compound bigrams (dictionary-free approximation; see
        # cjk_morph module docstring for the documented contract)
        from .cjk_morph import (kanji_compound_bigram_filter,
                                kuromoji_lite_tokenizer)
        from .unicode_plugins import cjk_width_filter
        return Analyzer(name, kuromoji_lite_tokenizer,
                        [cjk_width_filter, lowercase_filter,
                         kanji_compound_bigram_filter])
    if name == "nori":
        # reference plugins/analysis-nori: word segmentation + josa strip
        from .cjk_morph import nori_lite_tokenizer
        return Analyzer(name, nori_lite_tokenizer, [lowercase_filter])
    if name == "icu_analyzer":
        # reference plugins/analysis-icu IcuAnalyzerProvider:
        # nfkc_cf normalization + folding over the standard tokenizer
        from .unicode_plugins import (icu_folding_filter,
                                      icu_normalizer_char_filter)
        return Analyzer(name, standard_tokenizer, [icu_folding_filter],
                        [icu_normalizer_char_filter])
    if name == "polish":
        # reference plugins/analysis-stempel PolishAnalyzerProvider
        # (rule-based approximation; see slavic.py module contract)
        from .slavic import make_polish_analyzer
        return make_polish_analyzer()
    if name == "ukrainian":
        # reference plugins/analysis-ukrainian UkrainianAnalyzerProvider
        from .slavic import make_ukrainian_analyzer
        return make_ukrainian_analyzer()
    raise ValueError(f"unknown analyzer [{name}]")


class AnalysisRegistry:
    """Per-index analyzer registry built from index settings."""

    def __init__(self, analysis_settings: dict | None = None):
        self._settings = analysis_settings or {}
        self._cache: dict[str, Analyzer] = {}

    def get(self, name: str) -> Analyzer:
        if name in self._cache:
            return self._cache[name]
        custom = self._settings.get("analyzer", {}).get(name)
        if custom is not None:
            ana = self._build_custom(name, custom)
        else:
            ana = _builtin(name)
        self._cache[name] = ana
        return ana

    def normalizer(self, name: str | None) -> Analyzer:
        """Keyword-field normalizers (reference: keyword normalizers are
        analyzers without a tokenizer). `lowercase` builtin supported."""
        if name is None:
            return Analyzer("identity", keyword_tokenizer, [])
        if name == "lowercase":
            return Analyzer("lowercase", keyword_tokenizer, [lowercase_filter])
        if name.startswith("_icu_collation:"):
            # internal: icu_collation_keyword fields normalize values to
            # collation sort keys (strength encoded in the name)
            from .unicode_plugins import make_collation_key_filter
            return Analyzer(name, keyword_tokenizer,
                            [make_collation_key_filter(
                                name.split(":", 1)[1])])
        custom = self._settings.get("normalizer", {}).get(name)
        if custom is not None:
            filters = [self._resolve_filter(f) for f in custom.get("filter", [])]
            chars = [self._resolve_char(f) for f in custom.get("char_filter", [])]
            return Analyzer(name, keyword_tokenizer, filters, chars)
        raise ValueError(f"unknown normalizer [{name}]")

    def ensure_sayt_chains(self, max_shingle: int) -> None:
        """Register the search_as_you_type analyzer chains (reference
        SearchAsYouTypeFieldMapper): `__sayt_{n}gram` = standard + lowercase
        + fixed-size shingles; `__sayt_prefix` = the same plus edge ngrams
        for the bool_prefix last-term match."""
        ana = self._settings.setdefault("analyzer", {})
        flt = self._settings.setdefault("filter", {})
        for n in range(2, max_shingle + 1):
            flt.setdefault(f"__sayt_shingle{n}", {
                "type": "shingle", "min_shingle_size": n,
                "max_shingle_size": n, "output_unigrams": False})
            ana.setdefault(f"__sayt_{n}gram", {
                "type": "custom", "tokenizer": "standard",
                "filter": ["lowercase", f"__sayt_shingle{n}"]})
        flt.setdefault("__sayt_edge", {
            "type": "edge_ngram", "min_gram": 1, "max_gram": 20})
        ana.setdefault("__sayt_prefix", {
            "type": "custom", "tokenizer": "standard",
            "filter": ["lowercase", "__sayt_edge"]})

    def _resolve_filter(self, name: str) -> TokenFilter:
        custom = self._settings.get("filter", {}).get(name)
        if custom is not None:
            return resolve_token_filter(custom["type"], custom)
        return resolve_token_filter(name)

    def _resolve_char(self, name: str) -> CharFilter:
        custom = self._settings.get("char_filter", {}).get(name)
        if custom is not None:
            return resolve_char_filter(custom["type"], custom)
        return resolve_char_filter(name)

    def _build_custom(self, name: str, cfg: dict) -> Analyzer:
        if cfg.get("type", "custom") != "custom":
            return _builtin(cfg["type"])
        tok_name = cfg.get("tokenizer", "standard")
        tok_custom = self._settings.get("tokenizer", {}).get(tok_name)
        if tok_custom is not None:
            tokenizer = resolve_tokenizer(tok_custom["type"], tok_custom)
        else:
            tokenizer = resolve_tokenizer(tok_name)
        filters = [self._resolve_filter(f) for f in cfg.get("filter", [])]
        chars = [self._resolve_char(f) for f in cfg.get("char_filter", [])]
        return Analyzer(name, tokenizer, filters, chars)
