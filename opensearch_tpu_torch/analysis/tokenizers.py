"""Tokenizers (copy of the subset of opensearch_tpu/analysis/tokenizers.py
this slice serves: standard, whitespace, letter, keyword, lowercase).

Tokenizers run on the host during the write path; the device only ever
sees term rows. Each tokenizer maps `str -> list[Token]`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Dict, List

from ..errors import NotPortedError


@dataclass
class Token:
    """One token with its position and offsets."""

    text: str
    position: int
    start_offset: int
    end_offset: int

    def with_text(self, text: str) -> "Token":
        return Token(text, self.position, self.start_offset, self.end_offset)


# UAX#29-lite: runs of word characters incl. digits; keeps unicode letters.
_STANDARD_RE = re.compile(r"[\w][\w']*", re.UNICODE)
_LETTER_RE = re.compile(r"[^\W\d_]+", re.UNICODE)


def _re_tokenize(text: str, pattern: re.Pattern) -> List[Token]:
    return [Token(m.group(0), pos, m.start(), m.end())
            for pos, m in enumerate(pattern.finditer(text))]


def standard_tokenizer(text: str) -> List[Token]:
    """Word-boundary tokenizer (simplified UAX#29)."""
    return _re_tokenize(text, _STANDARD_RE)


def whitespace_tokenizer(text: str) -> List[Token]:
    return [Token(m.group(0), pos, m.start(), m.end())
            for pos, m in enumerate(re.finditer(r"\S+", text))]


def letter_tokenizer(text: str) -> List[Token]:
    return _re_tokenize(text, _LETTER_RE)


def keyword_tokenizer(text: str) -> List[Token]:
    """Whole input as a single token."""
    if not text:
        return []
    return [Token(text, 0, 0, len(text))]


def lowercase_tokenizer(text: str) -> List[Token]:
    return [t.with_text(t.text.lower()) for t in letter_tokenizer(text)]


TOKENIZERS: Dict[str, Callable[[str], List[Token]]] = {
    "standard": standard_tokenizer,
    "whitespace": whitespace_tokenizer,
    "letter": letter_tokenizer,
    "keyword": keyword_tokenizer,
    "lowercase": lowercase_tokenizer,
}


def resolve_tokenizer(name: str) -> Callable[[str], List[Token]]:
    if name in TOKENIZERS:
        return TOKENIZERS[name]
    raise NotPortedError(f"tokenizer [{name}]")
