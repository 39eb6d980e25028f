"""Token filters and char filters (a copy of
opensearch_tpu/analysis/filters.py). Analog of OpenSearch's
`modules/analysis-common` filter factories (lowercase, stop, stemmer,
asciifolding, trim, length, shingle, synonym, unique, reverse, truncate) and
char filters (html_strip, mapping, pattern_replace).
"""

from __future__ import annotations

import re
import unicodedata
from typing import Callable, Dict, List, Optional

from .porter import porter_stem
from .tokenizers import Token

TokenFilter = Callable[[List[Token]], List[Token]]
CharFilter = Callable[[str], str]

# Lucene EnglishAnalyzer.ENGLISH_STOP_WORDS_SET
ENGLISH_STOPWORDS = frozenset(
    "a an and are as at be but by for if in into is it no not of on or such that "
    "the their then there these they this to was will with".split()
)


def lowercase_filter(tokens: List[Token]) -> List[Token]:
    # a token already lower case passes as it is (no filter changes a
    # token in place)
    out = []
    for t in tokens:
        low = t.text.lower()
        out.append(t if low == t.text else t.with_text(low))
    return out


def uppercase_filter(tokens: List[Token]) -> List[Token]:
    return [t.with_text(t.text.upper()) for t in tokens]


def make_stop_filter(stopwords=ENGLISH_STOPWORDS) -> TokenFilter:
    """Removes stopwords but preserves position gaps (like Lucene StopFilter
    with enablePositionIncrements), so phrase queries stay correct."""
    stopset = frozenset(stopwords)

    def f(tokens: List[Token]) -> List[Token]:
        return [t for t in tokens if t.text not in stopset]

    return f


def porter_stem_filter(tokens: List[Token]) -> List[Token]:
    # keyword-flagged tokens (keyword_marker / stemmer_override) skip
    # stemming, like Lucene stemmers honoring KeywordAttribute
    return [t if t.keyword else t.with_text(porter_stem(t.text))
            for t in tokens]


def asciifolding_filter(tokens: List[Token]) -> List[Token]:
    def fold(s: str) -> str:
        return unicodedata.normalize("NFKD", s).encode("ascii", "ignore").decode("ascii") or s

    return [t.with_text(fold(t.text)) for t in tokens]


def trim_filter(tokens: List[Token]) -> List[Token]:
    return [t.with_text(t.text.strip()) for t in tokens]


def unique_filter(tokens: List[Token]) -> List[Token]:
    seen, out = set(), []
    for t in tokens:
        if t.text not in seen:
            seen.add(t.text)
            out.append(t)
    return out


def reverse_filter(tokens: List[Token]) -> List[Token]:
    return [t.with_text(t.text[::-1]) for t in tokens]


def make_length_filter(min_len: int = 0, max_len: int = 1 << 30) -> TokenFilter:
    return lambda tokens: [t for t in tokens if min_len <= len(t.text) <= max_len]


def make_truncate_filter(length: int = 10) -> TokenFilter:
    return lambda tokens: [t.with_text(t.text[:length])
                           for t in tokens]


def make_shingle_filter(min_size: int = 2, max_size: int = 2,
                        separator: str = " ", output_unigrams: bool = True) -> TokenFilter:
    def f(tokens: List[Token]) -> List[Token]:
        out = list(tokens) if output_unigrams else []
        for n in range(min_size, max_size + 1):
            for i in range(len(tokens) - n + 1):
                grp = tokens[i:i + n]
                out.append(Token(separator.join(t.text for t in grp),
                                 grp[0].position, grp[0].start_offset,
                                 grp[-1].end_offset))
        out.sort(key=lambda t: (t.position, t.end_offset))
        return out

    return f


def make_synonym_filter(synonyms: List[str]) -> TokenFilter:
    """Solr-format synonym rules: "a, b => c" (replace) or "a, b, c" (expand).
    Expansion emits extra tokens at the same position (like Lucene SynonymGraphFilter
    for single-word synonyms; multi-word synonym graphs are a later round)."""
    replace: Dict[str, List[str]] = {}
    expand: Dict[str, List[str]] = {}
    for rule in synonyms:
        if "=>" in rule:
            lhs, rhs = rule.split("=>")
            targets = [w.strip() for w in rhs.split(",") if w.strip()]
            for w in lhs.split(","):
                replace[w.strip()] = targets
        else:
            group = [w.strip() for w in rule.split(",") if w.strip()]
            for w in group:
                expand[w] = group

    def f(tokens: List[Token]) -> List[Token]:
        out: List[Token] = []
        for t in tokens:
            if t.text in replace:
                for w in replace[t.text]:
                    out.append(t.with_text(w))
            elif t.text in expand:
                for w in expand[t.text]:
                    out.append(t.with_text(w))
            else:
                out.append(t)
        return out

    return f


# ---------------- char filters ----------------

_HTML_TAG_RE = re.compile(r"<[^>]*>")


def html_strip_char_filter(text: str) -> str:
    import html

    return html.unescape(_HTML_TAG_RE.sub(" ", text))


def make_mapping_char_filter(mappings: List[str]) -> CharFilter:
    """Rules like "ph => f"."""
    pairs = []
    for rule in mappings:
        lhs, rhs = rule.split("=>")
        pairs.append((lhs.strip(), rhs.strip()))

    def f(text: str) -> str:
        for a, b in pairs:
            text = text.replace(a, b)
        return text

    return f


def make_pattern_replace_char_filter(pattern: str, replacement: str = "") -> CharFilter:
    compiled = re.compile(pattern)
    return lambda text: compiled.sub(replacement, text)


def make_word_delimiter_filter(generate_word_parts: bool = True,
                               generate_number_parts: bool = True,
                               catenate_words: bool = False,
                               catenate_numbers: bool = False,
                               catenate_all: bool = False,
                               preserve_original: bool = False,
                               split_on_case_change: bool = True,
                               split_on_numerics: bool = True) -> TokenFilter:
    """word_delimiter(_graph): split on intra-word delimiters, case
    transitions and letter/number transitions (reference analysis-common
    WordDelimiterGraphFilterFactory; graph vs non-graph is a position
    bookkeeping difference — both forms split identically here)."""

    def split(text: str) -> List[str]:
        runs: List[str] = []
        cur = ""
        prev_kind = ""
        for ch in text:
            if ch.isalpha():
                kind = "u" if ch.isupper() else "l"
            elif ch.isdigit():
                kind = "d"
            else:
                kind = ""
            if not kind:
                if cur:
                    runs.append(cur)
                cur = ""
                prev_kind = ""
                continue
            boundary = False
            if cur:
                if split_on_case_change and prev_kind == "l" and kind == "u":
                    boundary = True
                if split_on_numerics and prev_kind != kind \
                        and "d" in (prev_kind, kind):
                    boundary = True
            if boundary:
                runs.append(cur)
                cur = ch
            else:
                cur += ch
            prev_kind = kind
        if cur:
            runs.append(cur)
        return runs

    def f(tokens: List[Token]) -> List[Token]:
        out: List[Token] = []
        for t in tokens:
            parts = split(t.text)
            kept = [p for p in parts
                    if (generate_word_parts and not p.isdigit())
                    or (generate_number_parts and p.isdigit())]
            emitted = []
            if preserve_original or not kept:
                emitted.append(t.text)
            emitted.extend(kept)
            if catenate_all and len(parts) > 1:
                emitted.append("".join(parts))
            elif catenate_words and len(parts) > 1 \
                    and all(not p.isdigit() for p in parts):
                emitted.append("".join(parts))
            elif catenate_numbers and len(parts) > 1 \
                    and all(p.isdigit() for p in parts):
                emitted.append("".join(parts))
            seen = set()
            for e in emitted:
                if e and e not in seen:
                    seen.add(e)
                    out.append(t.with_text(e))
        return out
    return f


def make_pattern_capture_filter(patterns: List[str],
                                preserve_original: bool = True
                                ) -> TokenFilter:
    compiled = [re.compile(p) for p in patterns]

    def f(tokens: List[Token]) -> List[Token]:
        out: List[Token] = []
        for t in tokens:
            emitted = [t.text] if preserve_original else []
            for pat in compiled:
                for m in pat.finditer(t.text):
                    if m.groups():
                        emitted.extend(g for g in m.groups() if g)
                    else:
                        emitted.append(m.group(0))
            seen = set()
            for e in emitted:
                if e and e not in seen:
                    seen.add(e)
                    out.append(t.with_text(e))
        return out
    return f


_ELISION_DEFAULT = ["l", "m", "t", "qu", "n", "s", "j"]


def make_elision_filter(articles=None) -> TokenFilter:
    arts = tuple(a.lower() + "'" for a in (articles or _ELISION_DEFAULT))

    def f(tokens: List[Token]) -> List[Token]:
        out = []
        for t in tokens:
            text = t.text
            low = text.lower().replace("’", "'")
            for a in arts:
                if low.startswith(a):
                    text = text[len(a):]
                    break
            if text:
                out.append(t.with_text(text))
        return out
    return f


def make_ngram_token_filter(min_gram: int = 1, max_gram: int = 2
                            ) -> TokenFilter:
    def f(tokens: List[Token]) -> List[Token]:
        out = []
        for t in tokens:
            for n in range(min_gram, max_gram + 1):
                for i in range(0, max(len(t.text) - n + 1, 0)):
                    out.append(t.with_text(t.text[i:i + n]))
        return out
    return f


def make_edge_ngram_token_filter(min_gram: int = 1, max_gram: int = 2
                                 ) -> TokenFilter:
    def f(tokens: List[Token]) -> List[Token]:
        out = []
        for t in tokens:
            for n in range(min_gram, min(max_gram, len(t.text)) + 1):
                out.append(t.with_text(t.text[:n]))
        return out
    return f


def make_keyword_marker_filter(keywords: List[str],
                               ignore_case: bool = False) -> TokenFilter:
    """Sets the token keyword flag (Lucene KeywordMarkerFilter): the flag
    survives later text transforms and stemmers skip flagged tokens."""
    kw = frozenset(k.lower() for k in keywords) if ignore_case \
        else frozenset(keywords)

    def f(tokens: List[Token]) -> List[Token]:
        out = []
        for t in tokens:
            probe = t.text.lower() if ignore_case else t.text
            if probe in kw and not t.keyword:
                nt = t.with_text(t.text)
                nt.keyword = True
                out.append(nt)
            else:
                out.append(t)
        return out
    return f


def make_stemmer_override_filter(rules) -> TokenFilter:
    """"running => run" rules (list of strings or a parsed {src: dst}
    dict) applied before/instead of the stemmer."""
    if isinstance(rules, dict):
        table = dict(rules)
    else:
        table = {}
        for r in rules:
            if "=>" in r:
                src, dst = r.split("=>", 1)
                table[src.strip()] = dst.strip()

    def f(tokens: List[Token]) -> List[Token]:
        out = []
        for t in tokens:
            if t.text in table:
                nt = t.with_text(table[t.text])
                nt.keyword = True    # overridden => later stemmers skip
                out.append(nt)
            else:
                out.append(t)
        return out
    return f


def make_limit_filter(max_token_count: int = 1) -> TokenFilter:
    return lambda tokens: tokens[:max_token_count]


def decimal_digit_filter(tokens: List[Token]) -> List[Token]:
    """Fold unicode digits to latin 0-9 (reference DecimalDigitFilter)."""
    def fold(s: str) -> str:
        return "".join(str(unicodedata.digit(c)) if c.isdigit() else c
                       for c in s)
    return [t.with_text(fold(t.text))
            for t in tokens]


def apostrophe_filter(tokens: List[Token]) -> List[Token]:
    """Strip everything after an apostrophe (reference ApostropheFilter)."""
    out = []
    for t in tokens:
        text = t.text.split("'")[0].split("’")[0]
        if text:
            out.append(t.with_text(text))
    return out


def resolve_token_filter(name: str, params: dict | None = None) -> TokenFilter:
    params = params or {}
    simple: Dict[str, TokenFilter] = {
        "lowercase": lowercase_filter,
        "uppercase": uppercase_filter,
        "porter_stem": porter_stem_filter,
        "stemmer": porter_stem_filter,
        "asciifolding": asciifolding_filter,
        "trim": trim_filter,
        "unique": unique_filter,
        "reverse": reverse_filter,
        "decimal_digit": decimal_digit_filter,
        "apostrophe": apostrophe_filter,
        "flatten_graph": lambda tokens: tokens,  # positions already linear
    }
    if name in simple:
        return simple[name]
    if name in ("word_delimiter", "word_delimiter_graph"):
        return make_word_delimiter_filter(
            generate_word_parts=params.get("generate_word_parts", True),
            generate_number_parts=params.get("generate_number_parts", True),
            catenate_words=params.get("catenate_words", False),
            catenate_numbers=params.get("catenate_numbers", False),
            catenate_all=params.get("catenate_all", False),
            preserve_original=params.get("preserve_original", False),
            split_on_case_change=params.get("split_on_case_change", True),
            split_on_numerics=params.get("split_on_numerics", True))
    if name == "pattern_capture":
        return make_pattern_capture_filter(
            params.get("patterns", []),
            params.get("preserve_original", True))
    if name == "elision":
        return make_elision_filter(params.get("articles"))
    if name == "ngram":
        return make_ngram_token_filter(int(params.get("min_gram", 1)),
                                       int(params.get("max_gram", 2)))
    if name == "edge_ngram":
        return make_edge_ngram_token_filter(int(params.get("min_gram", 1)),
                                            int(params.get("max_gram", 2)))
    if name == "keyword_marker":
        return make_keyword_marker_filter(params.get("keywords", []),
                                          bool(params.get("ignore_case",
                                                          False)))
    if name == "stemmer_override":
        return make_stemmer_override_filter(params.get("rules", []))
    if name == "limit":
        return make_limit_filter(int(params.get("max_token_count", 1)))
    if name == "synonym_graph":
        return make_synonym_filter(params.get("synonyms", []))
    if name == "stop":
        sw = params.get("stopwords", "_english_")
        return make_stop_filter(ENGLISH_STOPWORDS if sw == "_english_" else sw)
    if name == "length":
        return make_length_filter(params.get("min", 0), params.get("max", 1 << 30))
    if name == "truncate":
        return make_truncate_filter(params.get("length", 10))
    if name == "shingle":
        return make_shingle_filter(params.get("min_shingle_size", 2),
                                   params.get("max_shingle_size", 2),
                                   params.get("token_separator", " "),
                                   params.get("output_unigrams", True))
    if name == "synonym":
        return make_synonym_filter(params.get("synonyms", []))
    if name in ("icu_folding", "icu_normalizer", "cjk_width", "cjk_bigram"):
        from .unicode_plugins import (cjk_bigram_filter, cjk_width_filter,
                                      icu_folding_filter,
                                      icu_normalizer_filter)
        return {"icu_folding": icu_folding_filter,
                "icu_normalizer": icu_normalizer_filter,
                "cjk_width": cjk_width_filter,
                "cjk_bigram": cjk_bigram_filter}[name]
    if name == "icu_transform":
        from .unicode_plugins import make_icu_transform_filter
        return make_icu_transform_filter(params.get("id", "Any-Latin"))
    if name == "phonetic":
        from .phonetic import make_phonetic_filter
        return make_phonetic_filter(params.get("encoder", "metaphone"),
                                    bool(params.get("replace", True)))
    if name == "polish_stem":
        from .slavic import polish_stem_filter
        return polish_stem_filter
    if name == "ukrainian_stem":
        from .slavic import ukrainian_stem_filter
        return ukrainian_stem_filter
    raise ValueError(f"unknown token filter [{name}]")


def resolve_char_filter(name: str, params: dict | None = None) -> CharFilter:
    params = params or {}
    if name == "html_strip":
        return html_strip_char_filter
    if name == "mapping":
        return make_mapping_char_filter(params.get("mappings", []))
    if name == "pattern_replace":
        return make_pattern_replace_char_filter(params.get("pattern", ""),
                                                params.get("replacement", ""))
    if name == "icu_normalizer":
        from .unicode_plugins import icu_normalizer_char_filter
        return icu_normalizer_char_filter
    raise ValueError(f"unknown char filter [{name}]")
