"""Polish and Ukrainian analysis (a copy of opensearch_tpu/analysis/slavic.py,
the rule-based rebuild of OpenSearch's `plugins/analysis-stempel` (StempelPolishStemTokenFilterFactory)
and `plugins/analysis-ukrainian` (UkrainianAnalyzerProvider over
morfologik).

The real plugins are table-driven (Egothor stemmer tables / morfologik
dictionaries) — neither data set exists in this image, so these are
DOCUMENTED APPROXIMATIONS: longest-suffix stemmers over the productive
inflection paradigms plus the standard stopword lists. Same class of
contract as the kuromoji/nori approximations in `cjk_morph.py`: correct
conflation on the regular morphology, no claim of dictionary-level
accuracy on irregulars.
"""

from __future__ import annotations

from typing import List

from .tokenizers import Token

# Productive Polish inflectional suffixes, longest-match-first (noun case
# endings, adjective agreement, verb conjugation, diminutives).
_PL_SUFFIXES = [
    "iesz", "iecie", "iemy", "iłem", "iłam", "iłes", "iłaś", "ałem",
    "ałam", "ałes", "ałaś", "owie", "owych", "owymi", "owego", "owemu",
    "owej", "owym", "ować", "acji", "acja", "acją", "acje", "ość",
    "ości", "ościa", "oscią", "ysta", "ami", "ach", "iej", "ymi", "ego",
    "emu", "ych", "ów", "om", "ow", "em", "ie", "ia", "ią", "ię", "yc",
    "ej", "ym", "im", "ą", "ę", "y", "i", "e", "a", "u", "o",
]

# Productive Ukrainian endings (noun cases, adjective agreement, verbs).
_UK_SUFFIXES = [
    "ювати", "ювання", "ування", "еннями", "очками", "увати", "ення",
    "еням", "ятами", "ості", "істю", "ання", "яння", "ами", "ями",
    "ові", "еві", "ого", "ому", "ими", "іми", "ій", "ів", "ом", "ем",
    "ам", "ям", "ах", "ях", "ою", "ею", "ий", "ій", "ї", "є", "у",
    "ю", "а", "я", "и", "і", "о", "е",
]

_PL_STOPWORDS = frozenset("""
a aby ale by być co czy dla do i jak jest jego jej już lub ma na nie o od
po pod przez się są tak ten to w we z za że
""".split())

_UK_STOPWORDS = frozenset("""
а але б би в від він вона вони воно до з за і й його її як що це та ти ми
ви на не ні по при про у
""".split())


def _suffix_stem(text: str, suffixes: List[str], min_stem: int = 3) -> str:
    low = text.lower()
    for suf in suffixes:
        if low.endswith(suf) and len(low) - len(suf) >= min_stem:
            return text[: len(text) - len(suf)]
    return text


def polish_stem_filter(tokens: List[Token]) -> List[Token]:
    """reference: StempelPolishStemTokenFilterFactory
    (plugins/analysis-stempel) — longest-suffix approximation."""
    return [t if getattr(t, "keyword", False)
            else t.with_text(_suffix_stem(t.text, _PL_SUFFIXES))
            for t in tokens]


def ukrainian_stem_filter(tokens: List[Token]) -> List[Token]:
    """reference: UkrainianAnalyzerProvider's morfologik stemming
    (plugins/analysis-ukrainian) — longest-suffix approximation."""
    return [t if getattr(t, "keyword", False)
            else t.with_text(_suffix_stem(t.text, _UK_SUFFIXES))
            for t in tokens]


def make_polish_analyzer():
    from .analyzers import Analyzer
    from .filters import lowercase_filter, make_stop_filter
    from .tokenizers import standard_tokenizer
    return Analyzer("polish", standard_tokenizer,
                    [lowercase_filter,
                     make_stop_filter(sorted(_PL_STOPWORDS)),
                     polish_stem_filter])


def make_ukrainian_analyzer():
    from .analyzers import Analyzer
    from .filters import lowercase_filter, make_stop_filter
    from .tokenizers import standard_tokenizer
    return Analyzer("ukrainian", standard_tokenizer,
                    [lowercase_filter,
                     make_stop_filter(sorted(_UK_STOPWORDS)),
                     ukrainian_stem_filter])
