"""CJK morphological analysis (a copy of opensearch_tpu/analysis/cjk_morph.py,
the rebuild of OpenSearch's smartcn / kuromoji / nori plugins).

Reference: `plugins/analysis-smartcn/.../SmartChineseAnalyzerProvider.java`,
`plugins/analysis-kuromoji/.../KuromojiTokenizerFactory.java`,
`plugins/analysis-nori/.../NoriTokenizerFactory.java`. Those wrap
dictionary-backed morphological analyzers (SmartCN's HMM model, UniDic/
mecab-ko dictionaries). This environment ships no Japanese/Korean
dictionaries, so each language gets the strongest analyzer the image can
support, with the contract documented per analyzer:

- **Chinese (`smartcn`)**: REAL dictionary segmentation via the bundled
  `jieba` package (its dict.txt ships inside the wheel — no downloads).
  Accuracy class matches the reference's SmartCN HMM for search use.
- **Japanese (`kuromoji`)**: dictionary-free SCRIPT-RUN segmentation.
  Japanese interleaves scripts (kanji stems, hiragana inflection/particles,
  katakana loanwords, latin/digits), and script transitions are true word
  boundaries with high precision; long kanji compounds additionally emit
  sliding bigrams so 観光案内 matches 観光 and 案内 queries. This is an
  approximation of morphological analysis (documented; UniDic-class
  accuracy needs a dictionary the image lacks).
- **Korean (`nori`)**: Korean text is space-delimited; the analyzer
  segments on word boundaries, then strips the CLOSED CLASS of trailing
  case particles (josa) and a few copular endings by longest match —
  한국어를 indexes as 한국어, matching nori's default POS-filtered output
  for nominals. Verbal morphology beyond the copula is out of scope.

All are host-side string transforms; the device only sees term ids.
"""

from __future__ import annotations

from typing import List, Optional

from .tokenizers import Token

# ---------------------------------------------------------------------
# Chinese: jieba-backed dictionary segmentation
# ---------------------------------------------------------------------

_JIEBA = None


def _jieba():
    """The `jieba` module, imported at smartcn's first use. Unlike the
    reference, which falls back to script-run tokens without it, a
    missing `jieba` raises: smartcn's tokens are jieba's or none."""
    global _JIEBA
    if _JIEBA is None:
        try:
            import jieba
        except ImportError as e:
            raise ImportError(
                "the [smartcn] analyzer needs the [jieba] package, which "
                "is not installed") from e
        jieba.setLogLevel(60)          # silence init logging
        _JIEBA = jieba
    return _JIEBA


def smartcn_tokenizer(text: str) -> List[Token]:
    """Dictionary-based Chinese word segmentation (reference smartcn)."""
    jb = _jieba()
    out: List[Token] = []
    pos = 0
    # search mode also emits sub-words of long entities (北京故宮博物院 ->
    # 北京/故宮/博物/博物院/北京故宮博物院) so entity-component queries
    # match — the same index-time granularity call smartcn makes
    for word, start, end in jb.tokenize(text, mode="search"):
        w = word.strip()
        if not w or all(not ch.isalnum() for ch in w):
            continue
        out.append(Token(w, pos, start, end))
        pos += 1
    return out


# ---------------------------------------------------------------------
# Japanese: script-run segmentation + kanji-compound bigrams
# ---------------------------------------------------------------------

def _script(ch: str) -> str:
    cp = ord(ch)
    if 0x3040 <= cp <= 0x309F:
        return "hira"
    if 0x30A0 <= cp <= 0x30FF or cp == 0xFF70 or 0xFF66 <= cp <= 0xFF9F:
        # incl. U+FF9E/FF9F halfwidth voiced marks: they continue a
        # halfwidth-katakana word (width folding composes them later)
        return "kata"
    if (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0xF900 <= cp <= 0xFAFF):
        return "kanji"
    if 0xAC00 <= cp <= 0xD7AF or 0x1100 <= cp <= 0x11FF:
        return "hangul"
    if ch.isalnum():
        return "latin"
    return "other"


_KATA_JOIN = "ー・"          # prolonged sound / middle dot continue katakana


def kuromoji_lite_tokenizer(text: str) -> List[Token]:
    """Maximal same-script runs as tokens. Script transitions are word
    boundaries in Japanese orthography (kanji stem | hiragana okurigana/
    particle | katakana loanword | latin). Hiragana runs ARE emitted
    (kuromoji emits particles too; stop filtering is a later stage)."""
    out: List[Token] = []
    pos = 0
    i = 0
    n = len(text)
    while i < n:
        s = _script(text[i])
        if s == "other":
            i += 1
            continue
        j = i + 1
        while j < n and (_script(text[j]) == s
                         or (s == "kata" and text[j] in _KATA_JOIN)):
            j += 1
        out.append(Token(text[i:j], pos, i, j))
        pos += 1
        i = j
    return out


def kanji_compound_bigram_filter(tokens: List[Token]) -> List[Token]:
    """Long kanji compounds (>= 4 chars: 観光案内, 東京都庁舎) also emit
    sliding 2-char bigrams at successive positions so compound queries and
    their components both match — the recall half of what a UniDic
    decompound step would give. 2-3 char kanji tokens pass through whole
    (they are overwhelmingly single words)."""
    out: List[Token] = []
    prev_in: Optional[int] = None
    prev_out = -1
    for t in tokens:
        inc = t.position - prev_in if prev_in is not None else t.position + 1
        prev_in = t.position
        pos = prev_out + max(inc, 1)
        text = t.text
        if len(text) >= 4 and all(_script(c) == "kanji" for c in text):
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
# Korean: word-boundary segmentation + josa stripping
# ---------------------------------------------------------------------

# closed-class trailing case particles (josa) + copular endings, longest
# match first. Reference nori discards these as POS J*/E* by default.
_JOSA = sorted([
    "은", "는", "이", "가", "을", "를", "의", "에", "에서", "에게", "한테",
    "께", "께서", "으로", "로", "와", "과", "랑", "이랑", "도", "만",
    "부터", "까지", "보다", "처럼", "마다", "조차", "마저", "밖에",
    "이나", "나", "이며", "며", "하고", "에게서", "으로서", "로서",
    "으로써", "로써", "이라고", "라고",
], key=len, reverse=True)

_ENDINGS = sorted(["입니다", "습니다", "합니다", "했습니다", "인", "고",
                   "지만", "면서", "세요", "어요", "아요"],
                  key=len, reverse=True)


def _is_hangul(ch: str) -> bool:
    return 0xAC00 <= ord(ch) <= 0xD7AF


def nori_lite_tokenizer(text: str) -> List[Token]:
    """Space/punct word segmentation, then longest-match stripping of one
    trailing josa (or copular ending) per hangul word: 한국어를 -> 한국어.
    The stripped stem keeps the ORIGINAL offsets (highlighting covers the
    surface form, like nori's compound handling)."""
    out: List[Token] = []
    pos = 0
    i = 0
    n = len(text)
    while i < n:
        if not (text[i].isalnum() or _is_hangul(text[i])):
            i += 1
            continue
        j = i + 1
        while j < n and (text[j].isalnum() or _is_hangul(text[j])):
            j += 1
        word = text[i:j]
        if any(_is_hangul(c) for c in word):
            stem = word
            for suf in _ENDINGS:
                if stem.endswith(suf) and len(stem) - len(suf) >= 1:
                    stem = stem[: -len(suf)]
                    break
            for suf in _JOSA:
                if stem.endswith(suf) and len(stem) - len(suf) >= 1:
                    stem = stem[: -len(suf)]
                    break
            out.append(Token(stem, pos, i, j))
        else:
            out.append(Token(word, pos, i, j))
        pos += 1
        i = j
    return out
