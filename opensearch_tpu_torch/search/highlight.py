"""Highlighters (opensearch_tpu/search/highlight.py's plain and unified
ones): re-analyze the source text, mark the query's terms, and return the
best fragments. The port stores no term vectors, so `fvh` runs the
unified highlighter, as the reference does without them."""

from __future__ import annotations

from typing import Dict, List, Set

from ..analysis import Analyzer


def _term_sets(terms: Set[str]) -> tuple:
    """(exact terms, prefixes): a term ending in "*" is a prefix (the
    last position of a match_phrase_prefix)."""
    exact = {t for t in terms if not t.endswith("*")}
    prefixes = tuple(t[:-1] for t in terms if t.endswith("*") and len(t) > 1)
    return exact, prefixes


def highlight_field(text: str, terms: Set[str], analyzer: Analyzer,
                    pre_tag: str = "<em>", post_tag: str = "</em>",
                    fragment_size: int = 100,
                    number_of_fragments: int = 5) -> List[str]:
    """The plain highlighter: fragments grown greedily around runs of
    hits, in text order."""
    exact, prefixes = _term_sets(terms)
    hits = [(t.start_offset, t.end_offset) for t in analyzer.analyze(text)
            if t.text in exact or (prefixes and t.text.startswith(prefixes))]
    if not hits:
        return []
    if number_of_fragments == 0:
        return [_mark(text, hits, pre_tag, post_tag)]
    fragments: List[tuple] = []
    cur: List[tuple] = []
    for h in hits:
        if cur and h[1] - cur[0][0] > fragment_size:
            fragments.append(tuple(cur))
            cur = []
        cur.append(h)
    if cur:
        fragments.append(tuple(cur))
    out = []
    for frag in fragments[:number_of_fragments]:
        span = frag[-1][1] - frag[0][0]
        s = max(0, frag[0][0] - (fragment_size - span) // 2)
        e = min(len(text), s + max(fragment_size, span))
        rel = [(a - s, b - s) for a, b in frag if a >= s and b <= e]
        out.append(_mark(text[s:e], rel, pre_tag, post_tag))
    return out


def highlight_unified(text: str, terms: Set[str], analyzer: Analyzer,
                      pre_tag: str = "<em>", post_tag: str = "</em>",
                      fragment_size: int = 100,
                      number_of_fragments: int = 5) -> List[str]:
    """The unified highlighter: sentence-bounded passages merged up to
    about `fragment_size`, ranked by distinct matched terms, then hits,
    then position."""
    exact, prefixes = _term_sets(terms)
    hits = [(t.start_offset, t.end_offset, t.text)
            for t in analyzer.analyze(text)
            if t.text in exact or (prefixes and t.text.startswith(prefixes))]
    if not hits:
        return []
    if number_of_fragments == 0:
        return [_mark(text, [(a, b) for a, b, _ in hits], pre_tag, post_tag)]
    bounds = [0] + [i + 1 for i, ch in enumerate(text) if ch in ".!?\n"]
    if bounds[-1] != len(text):
        bounds.append(len(text))
    passages: List[tuple] = []
    s = bounds[0]
    for e in bounds[1:]:
        if e - s >= fragment_size and s != e:
            passages.append((s, e))
            s = e
    if s < len(text):
        passages.append((s, len(text)))
    scored = []
    for a, b in passages:
        ph = [(ha, hb, tt) for ha, hb, tt in hits if ha >= a and hb <= b]
        if ph:
            scored.append((len({tt for _, _, tt in ph}), len(ph), a, b, ph))
    scored.sort(key=lambda x: (-x[0], -x[1], x[2]))
    return [_mark(text[a:b], [(ha - a, hb - a) for ha, hb, _ in ph],
                  pre_tag, post_tag)
            for _u, _n, a, b, ph in scored[:number_of_fragments]]


def _mark(text: str, spans: List[tuple], pre: str, post: str) -> str:
    out = []
    prev = 0
    for a, b in spans:
        out += [text[prev:a], pre, text[a:b], post]
        prev = b
    out.append(text[prev:])
    return "".join(out)


def collect_query_terms(lnode) -> Dict[str, Set[str]]:
    """field -> the query's terms, from the logical plan: term groups,
    phrases (a prefix last term as "term*"), the must, should and filter
    clauses of a bool, the child of a constant_score, a dis_max's
    children and a boosting's positive side; not a combined_fields,
    terms_set or pinned query, as in the reference."""
    from .compiler import (LBool, LBoosting, LConstScore, LDisMax, LPhrase,
                           LTerms)

    out: Dict[str, Set[str]] = {}

    def walk(n):
        if isinstance(n, LPhrase):
            s = out.setdefault(n.field, set())
            s.update(n.terms[:-1] if n.prefix_last else n.terms)
            if n.prefix_last:
                s.add(n.terms[-1] + "*")
        elif isinstance(n, LTerms):
            out.setdefault(n.field, set()).update(n.terms)
        elif isinstance(n, LBool):
            for c in n.musts + n.shoulds + n.filters:
                walk(c)
        elif isinstance(n, LConstScore):
            walk(n.child)
        elif isinstance(n, LDisMax):
            for c in n.children:
                walk(c)
        elif isinstance(n, LBoosting):
            walk(n.positive)

    walk(lnode)
    return out
