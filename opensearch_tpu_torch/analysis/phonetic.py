"""Phonetic analysis (a copy of opensearch_tpu/analysis/phonetic.py, the
pure-python rebuild of OpenSearch's
`plugins/analysis-phonetic` (PhoneticTokenFilterFactory over commons-codec
encoders).

Implemented encoders: soundex, refined_soundex, metaphone, nysiis,
caverphone2, cologne (Kölner Phonetik). The statistical/table-driven ones
the image can't carry (beider_morse, daitch_mokotoff) and double_metaphone
are declined with an explicit error — never silently approximated.

Filter contract (reference PhoneticTokenFilter): each token is replaced by
its encoding, or — with `replace: false` — the original token is kept and
the encoding is emitted at the SAME position (a synonym-style stack), so
phrase queries still align.
"""

from __future__ import annotations

import re
from typing import List

from .tokenizers import Token

_VOWELS = set("AEIOU")


def soundex(word: str) -> str:
    """American Soundex (the commons-codec default): first letter + 3
    digits, H/W transparent between same-coded consonants."""
    w = re.sub(r"[^A-Z]", "", word.upper())
    if not w:
        return ""
    codes = {**dict.fromkeys("BFPV", "1"), **dict.fromkeys("CGJKQSXZ", "2"),
             **dict.fromkeys("DT", "3"), "L": "4",
             **dict.fromkeys("MN", "5"), "R": "6"}
    out = w[0]
    last = codes.get(w[0], "")
    for ch in w[1:]:
        c = codes.get(ch, "")
        if ch in "HW":
            continue              # transparent: do not reset `last`
        if c and c != last:
            out += c
            if len(out) == 4:
                break
        last = c
    return (out + "000")[:4]


def refined_soundex(word: str) -> str:
    """Refined Soundex: finer 9-group coding, no length cap, vowels keep
    a 0 marker between consonant groups."""
    w = re.sub(r"[^A-Z]", "", word.upper())
    if not w:
        return ""
    codes = {**dict.fromkeys("AEIOUYHW", "0"),
             **dict.fromkeys("BP", "1"), **dict.fromkeys("FV", "2"),
             **dict.fromkeys("CKS", "3"), **dict.fromkeys("GJ", "4"),
             **dict.fromkeys("QXZ", "5"), **dict.fromkeys("DT", "6"),
             "L": "7", **dict.fromkeys("MN", "8"), "R": "9"}
    out = w[0]
    last = None
    for ch in w:
        c = codes.get(ch)
        if c is None or c == last:
            continue
        out += c
        last = c
    return out


def metaphone(word: str, max_len: int = 4) -> str:
    """Lawrence Philips' original Metaphone (1990), commons-codec
    behavior, default 4-char cap."""
    w = re.sub(r"[^A-Z]", "", word.upper())
    if not w:
        return ""
    # initial-letter exceptions
    if w[:2] in ("AE", "GN", "KN", "PN", "WR"):
        w = w[1:]
    elif w[:1] == "X":
        w = "S" + w[1:]
    elif w[:2] == "WH":
        w = "W" + w[2:]
    n = len(w)
    out = []
    i = 0
    while i < n and len(out) < max_len:
        ch = w[i]
        prev = w[i - 1] if i > 0 else ""
        nxt = w[i + 1] if i + 1 < n else ""
        nxt2 = w[i + 2] if i + 2 < n else ""
        if ch == prev and ch != "C":
            i += 1
            continue
        if ch in _VOWELS:
            if i == 0:
                out.append(ch)
        elif ch == "B":
            if not (i == n - 1 and prev == "M"):
                out.append("B")
        elif ch == "C":
            if nxt == "I" and nxt2 == "A":
                out.append("X")
            elif nxt == "H":
                if prev == "S":
                    out.append("K")
                else:
                    out.append("X")
                i += 1
            elif nxt in "IEY":
                if prev != "S":
                    out.append("S")
            else:
                out.append("K")
        elif ch == "D":
            if nxt == "G" and nxt2 in "EIY":
                out.append("J")
                i += 2
            else:
                out.append("T")
        elif ch == "G":
            if nxt == "H":
                if i + 2 < n and w[i + 2] in _VOWELS:
                    out.append("K")
                    i += 1
                # silent otherwise (nigh, light): skip both
                else:
                    i += 1
            elif nxt == "N":
                pass                      # GN/GNED: silent
            elif nxt in "EIY":
                out.append("J")
            else:
                out.append("K")
        elif ch == "H":
            if prev in _VOWELS and nxt not in _VOWELS:
                pass
            elif prev in "CSPTG":
                pass
            else:
                out.append("H")
        elif ch in "FJLMNR":
            out.append(ch)
        elif ch == "K":
            if prev != "C":
                out.append("K")
        elif ch == "P":
            if nxt == "H":
                out.append("F")
                i += 1
            else:
                out.append("P")
        elif ch == "Q":
            out.append("K")
        elif ch == "S":
            if nxt == "H":
                out.append("X")
                i += 1
            elif nxt == "I" and nxt2 in ("O", "A"):
                out.append("X")
            else:
                out.append("S")
        elif ch == "T":
            if nxt == "H":
                out.append("0")
                i += 1
            elif nxt == "I" and nxt2 in ("O", "A"):
                out.append("X")
            else:
                out.append("T")
        elif ch == "V":
            out.append("F")
        elif ch == "W":
            if nxt in _VOWELS:
                out.append("W")
        elif ch == "X":
            out.append("K")
            if len(out) < max_len:
                out.append("S")
        elif ch == "Y":
            if nxt in _VOWELS:
                out.append("Y")
        elif ch == "Z":
            out.append("S")
        i += 1
    return "".join(out[:max_len])


def nysiis(word: str) -> str:
    """NYSIIS (New York State Identification and Intelligence System)."""
    w = re.sub(r"[^A-Z]", "", word.upper())
    if not w:
        return ""
    for pre, rep in (("MAC", "MCC"), ("KN", "NN"), ("K", "C"),
                     ("PH", "FF"), ("PF", "FF"), ("SCH", "SSS")):
        if w.startswith(pre):
            w = rep + w[len(pre):]
            break
    for suf, rep in (("EE", "Y"), ("IE", "Y"), ("DT", "D"), ("RT", "D"),
                     ("RD", "D"), ("NT", "D"), ("ND", "D")):
        if w.endswith(suf):
            w = w[: -len(suf)] + rep
            break
    if not w:
        return ""
    key = w[0]
    prev = w[0]
    i = 1
    n = len(w)
    while i < n:
        ch = w[i]
        rep = ch
        if ch in "EIOU":
            rep = "A"
        if w[i:i + 2] == "EV":
            rep = "A"             # EV -> AF handled as A then F next loop
        if ch == "Q":
            rep = "G"
        elif ch == "Z":
            rep = "S"
        elif ch == "M":
            rep = "N"
        if w[i:i + 2] == "KN":
            rep = "N"
            i += 1
        elif ch == "K":
            rep = "C"
        if w[i:i + 3] == "SCH":
            rep = "S"
            i += 2
        elif w[i:i + 2] == "PH":
            rep = "F"
            i += 1
        if ch == "H" and (prev not in "AEIOU"
                          or (i + 1 < n and w[i + 1] not in "AEIOU")):
            rep = prev
        if ch == "W" and prev in "AEIOU":
            rep = prev
        if rep and rep[-1] != key[-1]:
            key += rep[-1]
        prev = rep[-1] if rep else prev
        i += 1
    if key.endswith("S") and len(key) > 1:
        key = key[:-1]
    if key.endswith("AY"):
        key = key[:-2] + "Y"
    if key.endswith("A") and len(key) > 1:
        key = key[:-1]
    return key


def caverphone2(word: str) -> str:
    """Caverphone 2.0 (David Hood, Caversham project) — 10-char keys
    padded with 1."""
    w = re.sub(r"[^a-z]", "", word.lower())
    if not w:
        return ""
    if w.endswith("e"):
        w = w[:-1]
    for pre, rep in (("cough", "cou2f"), ("rough", "rou2f"),
                     ("tough", "tou2f"), ("enough", "enou2f"),
                     ("trough", "trou2f"), ("gn", "2n")):
        if w.startswith(pre):
            w = rep + w[len(pre):]
    if w.endswith("mb"):
        w = w[:-2] + "m2"
    subs = [("cq", "2q"), ("ci", "si"), ("ce", "se"), ("cy", "sy"),
            ("tch", "2ch"), ("c", "k"), ("q", "k"), ("x", "k"), ("v", "f"),
            ("dg", "2g"), ("tio", "sio"), ("tia", "sia"), ("d", "t"),
            ("ph", "fh"), ("b", "p"), ("sh", "s2h"), ("z", "s")]
    for a, bb in subs:
        w = w.replace(a, bb)
    w = re.sub(r"^[aeiou]", "A", w)
    w = re.sub(r"[aeiou]", "3", w)
    w = w.replace("j", "y")
    w = re.sub(r"^y3", "Y3", w)
    w = re.sub(r"^y", "A", w)
    w = w.replace("y", "3")
    w = w.replace("3gh3", "3kh3")
    w = w.replace("gh", "22")
    w = w.replace("g", "k")
    for ch in "stpkfmn":
        w = re.sub(ch + "+", ch.upper(), w)
    w = w.replace("w3", "W3")
    w = w.replace("wh3", "Wh3")
    if w.endswith("w"):
        w = w[:-1] + "3"
    w = w.replace("w", "2")
    w = re.sub(r"^h", "A", w)
    w = w.replace("h", "2")
    w = w.replace("r3", "R3")
    if w.endswith("r"):
        w = w[:-1] + "3"
    w = w.replace("r", "2")
    w = w.replace("l3", "L3")
    if w.endswith("l"):
        w = w[:-1] + "3"
    w = w.replace("l", "2")
    w = w.replace("2", "")
    if w.endswith("3"):
        w = w[:-1] + "A"
    w = w.replace("3", "")
    return (w + "1" * 10)[:10]


def cologne(word: str) -> str:
    """Kölner Phonetik (German). commons-codec ColognePhonetic."""
    w = re.sub(r"[^A-ZÄÖÜß]", "", word.upper())
    w = (w.replace("Ä", "A").replace("Ö", "O").replace("Ü", "U")
          .replace("ß", "SS"))
    if not w:
        return ""
    n = len(w)
    raw = []
    for i, ch in enumerate(w):
        prev = w[i - 1] if i > 0 else ""
        nxt = w[i + 1] if i + 1 < n else ""
        if ch in "AEIJOUY":
            code = "0"
        elif ch == "B":
            code = "1"
        elif ch == "P":
            code = "3" if nxt == "H" else "1"
        elif ch in "DT":
            code = "8" if nxt in "CSZ" else "2"
        elif ch in "FVW":
            code = "3"
        elif ch in "GKQ":
            code = "4"
        elif ch == "C":
            if i == 0:
                code = "4" if nxt in "AHKLOQRUX" else "8"
            elif prev in "SZ":
                code = "8"
            else:
                code = "4" if nxt in "AHKOQUX" else "8"
        elif ch == "X":
            code = "8" if prev in "CKQ" else "48"
        elif ch == "L":
            code = "5"
        elif ch in "MN":
            code = "6"
        elif ch == "R":
            code = "7"
        elif ch in "SZ":
            code = "8"
        elif ch == "H":
            code = ""
        else:
            code = ""
        raw.append(code)
    # collapse runs, drop 0s except leading
    out = []
    last = None
    for code in raw:
        for c in code:
            if c != last:
                out.append(c)
            last = c
    key = "".join(out)
    return key[0] + key[1:].replace("0", "") if key else ""


_ENCODERS = {
    "soundex": soundex,
    "refined_soundex": refined_soundex,
    "metaphone": metaphone,
    "nysiis": nysiis,
    "caverphone2": caverphone2,
    "caverphone": caverphone2,     # the plugin's alias points at 2.0
    "cologne": cologne,
    "koelnerphonetik": cologne,
}

_UNSUPPORTED = ("double_metaphone", "beider_morse", "daitch_mokotoff",
                "haasephonetik")


def make_phonetic_filter(encoder: str = "metaphone", replace: bool = True):
    """reference: PhoneticTokenFilterFactory (plugins/analysis-phonetic).
    `replace: false` stacks the encoding at the original token's position."""
    enc = _ENCODERS.get(encoder)
    if enc is None:
        hint = ("statistical tables not available in this build"
                if encoder in _UNSUPPORTED else "unknown encoder")
        raise ValueError(
            f"phonetic encoder [{encoder}] not supported ({hint}); "
            f"supported: {sorted(set(_ENCODERS))}")

    def phonetic_filter(tokens: List[Token]) -> List[Token]:
        out: List[Token] = []
        for t in tokens:
            code = enc(t.text)
            if not code:
                out.append(t)
                continue
            if replace:
                out.append(t.with_text(code))
            else:
                out.append(t)
                out.append(t.with_text(code))
        return out

    return phonetic_filter
