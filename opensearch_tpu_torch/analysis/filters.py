"""Token filters (copy of the lowercase and stop filters of
opensearch_tpu/analysis/filters.py; every other filter raises)."""

from __future__ import annotations

from typing import Callable, List

from ..errors import NotPortedError
from .tokenizers import Token

TokenFilter = Callable[[List[Token]], List[Token]]

# Lucene EnglishAnalyzer.ENGLISH_STOP_WORDS_SET
ENGLISH_STOPWORDS = frozenset(
    "a an and are as at be but by for if in into is it no not of on or such that "
    "the their then there these they this to was will with".split()
)


def lowercase_filter(tokens: List[Token]) -> List[Token]:
    return [t.with_text(t.text.lower()) for t in tokens]


def make_stop_filter(stopwords=ENGLISH_STOPWORDS) -> TokenFilter:
    """Removes stopwords but keeps the position gaps."""
    stopset = frozenset(stopwords)

    def f(tokens: List[Token]) -> List[Token]:
        return [t for t in tokens if t.text not in stopset]

    return f


def resolve_token_filter(name: str, params: dict | None = None) -> TokenFilter:
    params = params or {}
    if name == "lowercase":
        return lowercase_filter
    if name == "stop":
        sw = params.get("stopwords", "_english_")
        return make_stop_filter(ENGLISH_STOPWORDS if sw == "_english_" else sw)
    raise NotPortedError(f"token filter [{name}]")
