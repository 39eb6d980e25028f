"""ICU-class and CJK analysis (a copy of
opensearch_tpu/analysis/unicode_plugins.py, the stdlib-unicodedata rebuild
of OpenSearch's language-analysis plugins).

Reference: `plugins/analysis-icu/` (ICUNormalizerCharFilterFactory,
ICUFoldingTokenFilterFactory, ICUNormalizer2TokenFilterFactory) and the
CJK pieces of `modules/analysis-common` (CJKWidthFilterFactory,
CJKBigramFilterFactory, CjkAnalyzerProvider). The real plugins wrap ICU4J;
Python's `unicodedata` provides the same Unicode database operations this
engine needs: NFKC/NFKD normalization, case folding, combining-mark
stripping, and width folding (NFKC subsumes half/full-width mapping).
Transliteration (icu_transform) is out of scope.

All functions are host-side string/token transforms — the device only ever
sees term ids, so language analysis composes with every query/agg path
unchanged.
"""

from __future__ import annotations

import unicodedata
from typing import List

from .tokenizers import Token


# ---------------------------------------------------------------------
# ICU analogs
# ---------------------------------------------------------------------

def icu_normalizer_char_filter(text: str) -> str:
    """nfkc_cf: NFKC normalization + Unicode case folding (the ICU
    plugin's default normalizer) applied BEFORE tokenization."""
    return unicodedata.normalize("NFKC", text).casefold()


def _fold(term: str) -> str:
    """ICU folding: NFKD-decompose, drop combining marks (diacritics in
    any script), recompose, case fold. Broader than asciifolding, which
    only maps the Latin-1/Latin-A supplement."""
    decomposed = unicodedata.normalize("NFKD", term)
    stripped = "".join(ch for ch in decomposed
                       if not unicodedata.combining(ch))
    return unicodedata.normalize("NFKC", stripped).casefold()


def icu_folding_filter(tokens: List[Token]) -> List[Token]:
    return [t.with_text(_fold(t.text)) for t in tokens]


def icu_normalizer_filter(tokens: List[Token]) -> List[Token]:
    """Token-filter form of nfkc_cf (ICUNormalizer2TokenFilterFactory)."""
    return [t.with_text(unicodedata.normalize("NFKC", t.text).casefold())
            for t in tokens]


# ---------------------------------------------------------------------
# CJK analogs
# ---------------------------------------------------------------------

def cjk_width_filter(tokens: List[Token]) -> List[Token]:
    """Full-width ASCII -> half-width, half-width katakana -> full-width:
    exactly the NFKC mapping restricted to width variants; NFKC itself is
    a superset and matches the reference filter on its test corpus."""
    return [t.with_text(unicodedata.normalize("NFKC", t.text))
            for t in tokens]


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return (0x4E00 <= cp <= 0x9FFF or     # CJK unified
            0x3400 <= cp <= 0x4DBF or     # ext A
            0xF900 <= cp <= 0xFAFF or     # compat ideographs
            0x3040 <= cp <= 0x30FF or     # hiragana + katakana
            0xAC00 <= cp <= 0xD7AF)       # hangul syllables


def cjk_bigram_filter(tokens: List[Token]) -> List[Token]:
    """Split runs of CJK characters into overlapping bigrams (reference
    CJKBigramFilter): 'こんにちは' -> こん んに にち ちは. Non-CJK tokens
    pass through; a single CJK char emits as a unigram. Position
    INCREMENTS from the input stream are preserved (a stopword gap stays a
    gap, like Lucene's posIncAtt handling); each extra bigram of one token
    advances the position by 1, shifting everything after it."""
    out: List[Token] = []
    prev_in = None     # previous input token position
    prev_out = -1      # last emitted position
    for t in tokens:
        inc = t.position - prev_in if prev_in is not None else t.position + 1
        prev_in = t.position
        pos = prev_out + max(inc, 1)
        text = t.text
        if len(text) >= 2 and all(_is_cjk(c) for c in text):
            for i in range(len(text) - 1):
                out.append(Token(text[i: i + 2], pos + i,
                                 t.start_offset + i,
                                 t.start_offset + i + 2, t.keyword))
            prev_out = pos + len(text) - 2
        else:
            out.append(Token(text, pos, t.start_offset, t.end_offset,
                             t.keyword))
            prev_out = pos
    return out


# ---------------------------------------------------------------------
# icu_transform (subset) — reference: ICUTransformTokenFilterFactory
# (plugins/analysis-icu). The real plugin exposes arbitrary ICU transliterator
# ids; this rebuild supports the ids seen in practice, composed with ";".
# Unknown ids raise — never silently pass text through.
# ---------------------------------------------------------------------

_CYR2LAT = {
    "а": "a", "б": "b", "в": "v", "г": "g", "д": "d", "е": "e", "ё": "e",
    "ж": "zh", "з": "z", "и": "i", "й": "j", "к": "k", "л": "l", "м": "m",
    "н": "n", "о": "o", "п": "p", "р": "r", "с": "s", "т": "t", "у": "u",
    "ф": "f", "х": "h", "ц": "c", "ч": "ch", "ш": "sh", "щ": "shch",
    "ъ": "", "ы": "y", "ь": "", "э": "e", "ю": "ju", "я": "ja",
    "є": "je", "і": "i", "ї": "ji", "ґ": "g",
}

_GRK2LAT = {
    "α": "a", "β": "b", "γ": "g", "δ": "d", "ε": "e", "ζ": "z", "η": "e",
    "θ": "th", "ι": "i", "κ": "k", "λ": "l", "μ": "m", "ν": "n",
    "ξ": "x", "ο": "o", "π": "p", "ρ": "r", "σ": "s", "ς": "s",
    "τ": "t", "υ": "y", "φ": "ph", "χ": "kh", "ψ": "ps", "ω": "o",
}


def _translit(text: str, table: dict) -> str:
    out = []
    for ch in text:
        low = ch.lower()
        rep = table.get(low)
        if rep is None:
            # accented forms fall back to their decomposed base letter
            # (ICU transliterates e.g. ή the same as η)
            base = unicodedata.normalize("NFD", low)[0]
            rep = table.get(base)
        if rep is None:
            out.append(ch)
        elif ch.isupper():
            out.append(rep.capitalize())
        else:
            out.append(rep)
    return "".join(out)


def _strip_marks(text: str) -> str:
    return unicodedata.normalize("NFC", "".join(
        c for c in unicodedata.normalize("NFD", text)
        if unicodedata.category(c) != "Mn"))


def _latin_ascii(text: str) -> str:
    return "".join(c for c in unicodedata.normalize("NFKD", text)
                   if ord(c) < 128)


_TRANSFORMS = {
    "any-latin": lambda s: _translit(_translit(s, _CYR2LAT), _GRK2LAT),
    "cyrillic-latin": lambda s: _translit(s, _CYR2LAT),
    "greek-latin": lambda s: _translit(s, _GRK2LAT),
    "latin-ascii": _latin_ascii,
    "any-lower": str.lower,
    "any-upper": str.upper,
    "nfd; [:nonspacing mark:] remove; nfc": _strip_marks,
    "nfd": lambda s: unicodedata.normalize("NFD", s),
    "nfc": lambda s: unicodedata.normalize("NFC", s),
    "nfkd": lambda s: unicodedata.normalize("NFKD", s),
    "nfkc": lambda s: unicodedata.normalize("NFKC", s),
    "[:nonspacing mark:] remove": lambda s: "".join(
        c for c in s if unicodedata.category(c) != "Mn"),
}


def make_icu_transform_filter(transform_id: str = "Any-Latin"):
    """Compose the ";"-separated transform id into one token transform.
    The full literal id is tried first (so the canonical accent-strip
    chain "NFD; [:Nonspacing Mark:] Remove; NFC" matches as one unit)."""
    tid = transform_id.strip().lower()
    if tid in _TRANSFORMS:
        steps = [_TRANSFORMS[tid]]
    else:
        steps = []
        for part in tid.split(";"):
            part = part.strip()
            if not part:
                continue
            fn = _TRANSFORMS.get(part)
            if fn is None:
                raise ValueError(
                    f"icu_transform id [{transform_id}] not supported; "
                    f"supported ids: {sorted(_TRANSFORMS)}")
            steps.append(fn)

    def icu_transform(tokens: List[Token]) -> List[Token]:
        out = []
        for t in tokens:
            text = t.text
            for fn in steps:
                text = fn(text)
            out.append(t.with_text(text))
        return out

    return icu_transform


# ---------------------------------------------------------------------
# icu_collation_keyword (plugins/analysis-icu ICUCollationKeywordFieldMapper)
# — collation SORT KEYS approximating the ICU strength cascade: primary
# (base letters) > secondary (accents) > tertiary (case). Within-level
# ordering uses codepoint order rather than DUCET weights (documented
# approximation; the image has no ICU collation tables). Keys are what
# gets indexed and stored in doc values, so term queries, sorting, and
# aggregations all operate in collation space, like the reference.
# ---------------------------------------------------------------------

def collation_key(s: str, strength: str = "tertiary") -> str:
    nfkd = unicodedata.normalize("NFKD", s)
    base = "".join(c for c in nfkd
                   if unicodedata.category(c) != "Mn").casefold()
    if strength == "primary":
        return base
    marks = "".join(c for c in nfkd if unicodedata.category(c) == "Mn")
    if strength == "secondary":
        return f"{base}\x01{marks}"
    case_sig = "".join("1" if c.isupper() else "0" for c in nfkd
                       if unicodedata.category(c) != "Mn")
    return f"{base}\x01{marks}\x01{case_sig}"


def make_collation_key_filter(strength: str = "tertiary"):
    def collation_filter(tokens: List[Token]) -> List[Token]:
        return [t.with_text(collation_key(t.text, strength))
                for t in tokens]
    return collation_filter
