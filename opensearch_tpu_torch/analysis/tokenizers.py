"""Tokenizers (a copy of opensearch_tpu/analysis/tokenizers.py; its
regexes exactly). Analog of OpenSearch's `modules/analysis-common/.../CommonAnalysisModulePlugin.java`
tokenizer registrations (standard, whitespace, keyword, letter, ngram,
edge_ngram, pattern, lowercase).

Tokenizers run on the host during the write path; the device never sees
strings, only term ids. Each tokenizer maps `str -> list[Token]`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Dict, List


@dataclass
class Token:
    """A single token with position + offsets (offsets power highlighting;
    positions power phrase queries — analog of Lucene's PackedTokenAttributeImpl).
    `keyword` mirrors Lucene's KeywordAttribute: set by keyword_marker /
    stemmer_override, honored (skipped) by stemmers, and it SURVIVES
    intervening text transforms because filters rebuild via with_text."""

    text: str
    position: int
    start_offset: int
    end_offset: int
    keyword: bool = False

    def with_text(self, text: str) -> "Token":
        """Rebuild with new text, preserving position/offsets/flags."""
        return Token(text, self.position, self.start_offset,
                     self.end_offset, self.keyword)


# UAX#29-lite: runs of word characters incl. digits; keeps unicode letters.
_STANDARD_RE = re.compile(r"[\w][\w']*", re.UNICODE)
_LETTER_RE = re.compile(r"[^\W\d_]+", re.UNICODE)


def _re_tokenize(text: str, pattern: re.Pattern) -> List[Token]:
    return [Token(m.group(0), pos, *m.span())
            for pos, m in enumerate(pattern.finditer(text))]


def standard_tokenizer(text: str) -> List[Token]:
    """Word-boundary tokenizer (simplified UAX#29, like Lucene StandardTokenizer)."""
    return _re_tokenize(text, _STANDARD_RE)


def whitespace_tokenizer(text: str) -> List[Token]:
    out, pos = [], 0
    for m in re.finditer(r"\S+", text):
        out.append(Token(m.group(0), pos, m.start(), m.end()))
        pos += 1
    return out


def letter_tokenizer(text: str) -> List[Token]:
    return _re_tokenize(text, _LETTER_RE)


def keyword_tokenizer(text: str) -> List[Token]:
    """Whole input as a single token (reference KeywordTokenizer)."""
    if not text:
        return []
    return [Token(text, 0, 0, len(text))]


def lowercase_tokenizer(text: str) -> List[Token]:
    return [Token(t.text.lower(), t.position, t.start_offset, t.end_offset)
            for t in letter_tokenizer(text)]


def make_pattern_tokenizer(pattern: str = r"\W+", group: int = -1) -> Callable[[str], List[Token]]:
    """Reference PatternTokenizer: pattern splits (group=-1) or captures (group>=0)."""
    compiled = re.compile(pattern)

    def tokenize(text: str) -> List[Token]:
        out: List[Token] = []
        if group >= 0:
            for pos, m in enumerate(compiled.finditer(text)):
                g = m.group(group)
                if g:
                    out.append(Token(g, pos, m.start(group), m.end(group)))
            return out
        pos = 0
        prev = 0
        for m in compiled.finditer(text):
            if m.start() > prev:
                out.append(Token(text[prev:m.start()], pos, prev, m.start()))
                pos += 1
            prev = m.end()
        if prev < len(text):
            out.append(Token(text[prev:], pos, prev, len(text)))
        return out

    return tokenize


def _ngrams(text: str, min_gram: int, max_gram: int, edge: bool) -> List[Token]:
    out: List[Token] = []
    pos = 0
    n = len(text)
    starts = [0] if edge else range(n)
    for i in starts:
        for g in range(min_gram, max_gram + 1):
            if i + g <= n:
                out.append(Token(text[i:i + g], pos, i, i + g))
                pos += 1
    return out


def make_ngram_tokenizer(min_gram: int = 1, max_gram: int = 2) -> Callable[[str], List[Token]]:
    return lambda text: _ngrams(text, min_gram, max_gram, edge=False)


def make_edge_ngram_tokenizer(min_gram: int = 1, max_gram: int = 2) -> Callable[[str], List[Token]]:
    return lambda text: _ngrams(text, min_gram, max_gram, edge=True)


TOKENIZERS: Dict[str, Callable] = {
    "standard": standard_tokenizer,
    "whitespace": whitespace_tokenizer,
    "letter": letter_tokenizer,
    "keyword": keyword_tokenizer,
    "lowercase": lowercase_tokenizer,
}


def resolve_tokenizer(name: str, params: dict | None = None) -> Callable[[str], List[Token]]:
    params = params or {}
    if name in TOKENIZERS:
        return TOKENIZERS[name]
    if name == "pattern":
        return make_pattern_tokenizer(params.get("pattern", r"\W+"), params.get("group", -1))
    if name == "ngram":
        return make_ngram_tokenizer(params.get("min_gram", 1), params.get("max_gram", 2))
    if name == "edge_ngram":
        return make_edge_ngram_tokenizer(params.get("min_gram", 1), params.get("max_gram", 2))
    raise ValueError(f"unknown tokenizer [{name}]")
