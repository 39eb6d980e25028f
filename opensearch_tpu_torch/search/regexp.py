"""Lucene regexp syntax -> DFA, with a vectorized term-dictionary runner:
the port's copy of opensearch_tpu/search/regexp.py (the reference analog
is `index/query/RegexpQueryBuilder.java` over Lucene's `RegExp` /
`Automaton`). Full default operator set:

    concat   ab        union  a|b        group  (a)
    repeat   a* a+ a?  bounds a{2} a{1,3}
    classes  [a-z] [^a-z]     any char  .
    anystring @        empty  #          numeric interval <10-99>
    intersection a&b   complement ~a     escaping \\x

Pipeline (host, numpy): parse -> Thompson NFA over disjoint char ranges
-> subset-construction DFA; `~` complements a completed DFA, `&` takes a
product. Matching a query against the whole term dictionary runs as
torch ops on the device of the dictionary's codepoint matrix
(`vocab_matrix`: i32[nterms, maxlen], 0-padded, built once per segment
and field by the caller): every term steps at once, `state =
trans[state, class_of_char]`, one gather per character position.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np
import torch

MAXCP = 0x10FFFF + 1


class RegexpError(ValueError):
    pass


# ---------------------------------------------------------------------------
# parser (Lucene RegExp grammar, operator precedence: | < & < concat < ~ <
# repeat < atom)
# ---------------------------------------------------------------------------

class _P:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def eof(self) -> bool:
        return self.i >= len(self.s)

    def peek(self) -> str:
        return self.s[self.i]

    def next(self) -> str:
        c = self.s[self.i]
        self.i += 1
        return c

    def expect(self, c: str) -> None:
        if self.eof() or self.s[self.i] != c:
            raise RegexpError(
                f"expected [{c}] at position {self.i} in /{self.s}/")
        self.i += 1

    # union := inter ('|' inter)*
    def union(self):
        left = self.inter()
        while not self.eof() and self.peek() == "|":
            self.next()
            left = ("union", left, self.inter())
        return left

    # inter := concat ('&' concat)*
    def inter(self):
        left = self.concat()
        while not self.eof() and self.peek() == "&":
            self.next()
            left = ("inter", left, self.concat())
        return left

    # concat := repeat+
    def concat(self):
        parts = []
        while not self.eof() and self.peek() not in "|&)":
            parts.append(self.repeat())
        if not parts:
            return ("empty_string",)
        node = parts[0]
        for p in parts[1:]:
            node = ("concat", node, p)
        return node

    # repeat := complement (('*'|'+'|'?'|'{m,n}') )*
    def repeat(self):
        node = self.complement()
        while not self.eof() and self.peek() in "*+?{":
            c = self.next()
            if c == "*":
                node = ("rep", node, 0, None)
            elif c == "+":
                node = ("rep", node, 1, None)
            elif c == "?":
                node = ("rep", node, 0, 1)
            else:  # {m} {m,} {m,n}
                m = self._int("}")
                if not self.eof() and self.peek() == ",":
                    self.next()
                    if not self.eof() and self.peek() == "}":
                        n = None
                    else:
                        n = self._int("}")
                else:
                    n = m
                self.expect("}")
                node = ("rep", node, m, n)
        return node

    def _int(self, *stops) -> int:
        start = self.i
        while not self.eof() and self.peek().isdigit():
            self.next()
        if start == self.i:
            raise RegexpError(f"expected number at {start} in /{self.s}/")
        return int(self.s[start: self.i])

    # complement := '~' complement | atom
    def complement(self):
        if not self.eof() and self.peek() == "~":
            self.next()
            return ("not", self.complement())
        return self.atom()

    def atom(self):  # noqa: C901
        if self.eof():
            return ("empty_string",)
        c = self.next()
        if c == "(":
            if not self.eof() and self.peek() == ")":
                self.next()
                return ("empty_string",)
            node = self.union()
            self.expect(")")
            return node
        if c == "[":
            return self._char_class()
        if c == ".":
            return ("ranges", ((0, MAXCP - 1),))
        if c == "@":
            return ("anystring",)
        if c == "#":
            return ("empty_lang",)
        if c == "<":
            return self._interval()
        if c == "\\":
            if self.eof():
                raise RegexpError("trailing backslash")
            e = self.next()
            return ("ranges", ((ord(e), ord(e)),))
        if c in ")|&":
            raise RegexpError(f"unexpected [{c}] at {self.i - 1}")
        return ("ranges", ((ord(c), ord(c)),))

    def _char_class(self):
        negate = False
        if not self.eof() and self.peek() == "^":
            self.next()
            negate = True
        ranges: List[Tuple[int, int]] = []
        first = True
        while True:
            if self.eof():
                raise RegexpError("unterminated character class")
            c = self.next()
            if c == "]" and not first:
                break
            first = False
            if c == "\\":
                if self.eof():
                    raise RegexpError("trailing backslash in class")
                c = self.next()
            lo = ord(c)
            hi = lo
            if (not self.eof() and self.peek() == "-"
                    and self.i + 1 < len(self.s)
                    and self.s[self.i + 1] != "]"):
                self.next()
                c2 = self.next()
                if c2 == "\\":
                    if self.eof():
                        raise RegexpError("trailing backslash in class")
                    c2 = self.next()
                hi = ord(c2)
                if hi < lo:
                    raise RegexpError(f"bad range {chr(lo)}-{chr(hi)}")
            ranges.append((lo, hi))
        if negate:
            ranges = _negate_ranges(ranges)
            if not ranges:
                return ("empty_lang",)
        return ("ranges", tuple(sorted(ranges)))

    def _interval(self):
        """<m-n>: any decimal string numerically within [m, n], with the
        shorter-number zero-pad convention Lucene uses (leading zeros
        allowed up to the max width)."""
        start = self.i
        while not self.eof() and self.peek() != ">":
            self.next()
        body = self.s[start: self.i]
        self.expect(">")
        m = body.split("-")
        if len(m) != 2 or not m[0].isdigit() or not m[1].isdigit():
            raise RegexpError(f"bad numeric interval <{body}>")
        lo, hi = int(m[0]), int(m[1])
        if lo > hi:
            lo, hi = hi, lo
        # union of the explicit decimal strings (bounded widths); Lucene
        # builds a digit automaton — an explicit union is equivalent for
        # the practical widths (guarded) and reuses the machinery
        if hi - lo > 2000:
            raise RegexpError(f"numeric interval too large <{body}>")
        # Lucene's interval automaton accepts leading zeros up to the max
        # operand width: <1-31> matches "07" as well as "7"
        width = max(len(m[0]), len(m[1]))
        node = None
        for v in range(lo, hi + 1):
            for w in range(len(str(v)), width + 1):
                alt = _string_node(str(v).zfill(w))
                node = alt if node is None else ("union", node, alt)
        return node if node is not None else ("empty_lang",)


def _string_node(s: str):
    node = ("empty_string",)
    for ch in s:
        node = ("concat", node, ("ranges", ((ord(ch), ord(ch)),)))
    return node


def _negate_ranges(ranges: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out = []
    cur = 0
    for lo, hi in sorted(ranges):
        if lo > cur:
            out.append((cur, lo - 1))
        cur = max(cur, hi + 1)
    if cur < MAXCP:
        out.append((cur, MAXCP - 1))
    return out


# ---------------------------------------------------------------------------
# NFA (Thompson) -> DFA (subset construction); complement/product on DFAs
# ---------------------------------------------------------------------------

class _Nfa:
    def __init__(self):
        self.eps: List[List[int]] = []
        self.edges: List[List[Tuple[int, int, int]]] = []  # (lo, hi, dst)

    def state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1


class Dfa:
    """Transitions over a partition of the codepoint space.
    `cuts`: sorted boundary starts; char -> class = searchsorted(cuts).
    `trans`: int32[nstates, nclasses]; -1 = dead. State 0 = start."""

    __slots__ = ("cuts", "trans", "accept", "_completed")

    def __init__(self, cuts: np.ndarray, trans: np.ndarray,
                 accept: np.ndarray):
        self.cuts = cuts
        self.trans = trans
        self.accept = accept
        self._completed = None

    def match(self, term: str) -> bool:
        st = 0
        for ch in term:
            cls = int(np.searchsorted(self.cuts, ord(ch), side="right") - 1)
            st = int(self.trans[st, cls])
            if st < 0:
                return False
        return bool(self.accept[st])

    def match_matrix(self, mat: torch.Tensor,
                     lens: torch.Tensor) -> torch.Tensor:
        """bool[nterms] on `mat`'s device: mat i32[nterms, maxlen]
        codepoints (0-padded), lens i32[nterms]. One gather per char
        position for ALL terms; every 8 positions, stop once every term
        is dead."""
        n, maxlen = mat.shape
        dev = mat.device
        if self._completed is None:
            self._completed = _complete(self)  # shared with complement()
        trans, accept = self._completed
        d_trans = torch.from_numpy(trans).to(dev)
        cuts = torch.from_numpy(self.cuts.astype(np.int32)).to(dev)
        cls = torch.searchsorted(cuts, mat, right=True) - 1
        state = torch.zeros(n, dtype=torch.int64, device=dev)
        dead = trans.shape[0] - 1
        for pos in range(maxlen):
            step = d_trans[state, cls[:, pos]]
            state = torch.where(lens > pos, step, state)
            if pos % 8 == 7 and bool((state == dead).all()):
                break
        return torch.from_numpy(accept).to(dev)[state]


def _ast_to_nfa(ast, nfa: _Nfa) -> Tuple[int, int]:  # noqa: C901
    kind = ast[0]
    if kind == "empty_string":
        s = nfa.state()
        return s, s
    if kind == "empty_lang":
        a, b = nfa.state(), nfa.state()
        return a, b          # no path
    if kind == "ranges":
        a, b = nfa.state(), nfa.state()
        for lo, hi in ast[1]:
            nfa.edges[a].append((lo, hi, b))
        return a, b
    if kind == "anystring":
        a = nfa.state()
        nfa.edges[a].append((0, MAXCP - 1, a))
        return a, a
    if kind == "concat":
        a1, b1 = _ast_to_nfa(ast[1], nfa)
        a2, b2 = _ast_to_nfa(ast[2], nfa)
        nfa.eps[b1].append(a2)
        return a1, b2
    if kind == "union":
        a1, b1 = _ast_to_nfa(ast[1], nfa)
        a2, b2 = _ast_to_nfa(ast[2], nfa)
        s, e = nfa.state(), nfa.state()
        nfa.eps[s] += [a1, a2]
        nfa.eps[b1].append(e)
        nfa.eps[b2].append(e)
        return s, e
    if kind == "rep":
        _, sub, mn, mx = ast
        if mx is not None and mx < mn:
            raise RegexpError(f"bad repeat bounds {{{mn},{mx}}}")
        s = nfa.state()
        cur = s
        for _i in range(mn):
            a, b = _ast_to_nfa(sub, nfa)
            nfa.eps[cur].append(a)
            cur = b
        if mx is None:
            a, b = _ast_to_nfa(sub, nfa)
            nfa.eps[cur].append(a)
            nfa.eps[b].append(cur)   # loop
            return s, cur
        end = nfa.state()
        nfa.eps[cur].append(end)
        for _i in range(mx - mn):
            a, b = _ast_to_nfa(sub, nfa)
            nfa.eps[cur].append(a)
            cur = b
            nfa.eps[cur].append(end)
        return s, end
    if kind in ("inter", "not"):
        # handled at the DFA level (compile sub-automata first)
        raise RegexpError("internal: inter/not must be compiled via _to_dfa")
    raise RegexpError(f"internal: unknown node {kind}")


def _eclosure(nfa: _Nfa, states: FrozenSet[int]) -> FrozenSet[int]:
    stack = list(states)
    seen = set(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


def _nfa_to_dfa(nfa: _Nfa, start: int, end: int) -> Dfa:
    # alphabet partition from all edge boundaries
    cutset = {0}
    for edges in nfa.edges:
        for lo, hi, _ in edges:
            cutset.add(lo)
            if hi + 1 < MAXCP:
                cutset.add(hi + 1)
    cuts = np.asarray(sorted(cutset), np.int64)
    ncls = len(cuts)

    start_set = _eclosure(nfa, frozenset([start]))
    index: Dict[FrozenSet[int], int] = {start_set: 0}
    order = [start_set]
    rows: List[List[int]] = []
    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        row = []
        for ci in range(ncls):
            lo = int(cuts[ci])
            nxt = set()
            for s in cur:
                for elo, ehi, dst in nfa.edges[s]:
                    if elo <= lo <= ehi:
                        nxt.add(dst)
            if not nxt:
                row.append(-1)
                continue
            closed = _eclosure(nfa, frozenset(nxt))
            if closed not in index:
                index[closed] = len(order)
                order.append(closed)
            row.append(index[closed])
        rows.append(row)
    trans = np.asarray(rows, np.int64).reshape(len(order), ncls)
    accept = np.asarray([end in st for st in order], bool)
    return Dfa(cuts, trans, accept)


def _complete(d: Dfa) -> Tuple[np.ndarray, np.ndarray]:
    """trans with an explicit dead state appended (total function)."""
    n, ncls = d.trans.shape
    trans = np.vstack([d.trans, np.full((1, ncls), n, np.int64)])
    trans = np.where(trans < 0, n, trans)
    accept = np.concatenate([d.accept, [False]])
    return trans, accept


def _dfa_complement(d: Dfa) -> Dfa:
    trans, accept = _complete(d)
    return Dfa(d.cuts, trans, ~accept)


def _merge_cuts(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.unique(np.concatenate([a, b]))


def _reclass(d: Dfa, cuts: np.ndarray) -> Dfa:
    """Re-express transitions over a finer partition."""
    cols = np.searchsorted(d.cuts, cuts, side="right") - 1
    return Dfa(cuts, d.trans[:, cols], d.accept)


def _dfa_product(a: Dfa, b: Dfa, op) -> Dfa:
    cuts = _merge_cuts(a.cuts, b.cuts)
    a = _reclass(a, cuts)
    b = _reclass(b, cuts)
    ta, aa = _complete(a)
    tb, ab = _complete(b)
    na, nb = ta.shape[0], tb.shape[0]
    ncls = len(cuts)
    # reachable product states only
    index = {(0, 0): 0}
    order = [(0, 0)]
    rows = []
    i = 0
    while i < len(order):
        sa, sb = order[i]
        i += 1
        row = []
        for c in range(ncls):
            ns = (int(ta[sa, c]), int(tb[sb, c]))
            if ns not in index:
                index[ns] = len(order)
                order.append(ns)
            row.append(index[ns])
        rows.append(row)
    trans = np.asarray(rows, np.int64)
    accept = np.asarray([op(bool(aa[sa]), bool(ab[sb]))
                         for sa, sb in order], bool)
    return Dfa(cuts, trans, accept)


def _to_dfa(ast) -> Dfa:
    kind = ast[0]
    if kind == "not":
        return _dfa_complement(_to_dfa(ast[1]))
    if kind == "inter":
        return _dfa_product(_to_dfa(ast[1]), _to_dfa(ast[2]),
                            lambda x, y: x and y)
    if _has_setops(ast):
        # a set-op (~ / &) below this node: compile the children to DFAs
        # and recombine at the automaton level (a DFA is a valid NFA, so
        # concat/repeat splice via epsilon edges)
        if kind == "union":
            return _dfa_product(_to_dfa(ast[1]), _to_dfa(ast[2]),
                                lambda x, y: x or y)
        if kind == "concat":
            return _concat_dfas(_to_dfa(ast[1]), _to_dfa(ast[2]))
        if kind == "rep":
            return _repeat_dfa(_to_dfa(ast[1]), ast[2], ast[3])
    nfa = _Nfa()
    s, e = _ast_to_nfa(ast, nfa)
    return _nfa_to_dfa(nfa, s, e)


def _has_setops(ast) -> bool:
    if not isinstance(ast, tuple):
        return False
    if ast[0] in ("not", "inter"):
        return True
    return any(_has_setops(x) for x in ast[1:] if isinstance(x, tuple))


def _dfa_fragment(nfa: _Nfa, d: Dfa) -> Tuple[int, List[int]]:
    """Splice a DFA into an NFA under construction; returns (start,
    accepting-state list)."""
    off = [nfa.state() for _ in range(d.trans.shape[0])]
    n, ncls = d.trans.shape
    for s in range(n):
        for c in range(ncls):
            dst = int(d.trans[s, c])
            if dst < 0:
                continue
            lo = int(d.cuts[c])
            hi = (int(d.cuts[c + 1]) - 1 if c + 1 < len(d.cuts)
                  else MAXCP - 1)
            nfa.edges[off[s]].append((lo, hi, off[dst]))
    return off[0], [off[s] for s in range(n) if d.accept[s]]


def _concat_dfas(a: Dfa, b: Dfa) -> Dfa:
    nfa = _Nfa()
    sa, enda = _dfa_fragment(nfa, a)
    sb, endb = _dfa_fragment(nfa, b)
    end = nfa.state()
    for s in enda:
        nfa.eps[s].append(sb)
    for s in endb:
        nfa.eps[s].append(end)
    return _nfa_to_dfa(nfa, sa, end)


def _repeat_dfa(d: Dfa, mn: int, mx: Optional[int]) -> Dfa:
    if mx is not None and mx < mn:
        raise RegexpError(f"bad repeat bounds {{{mn},{mx}}}")
    nfa = _Nfa()
    start = nfa.state()
    cur = [start]
    for _i in range(mn):
        s, ends = _dfa_fragment(nfa, d)
        for c in cur:
            nfa.eps[c].append(s)
        cur = ends
    end = nfa.state()
    if mx is None:
        s, ends = _dfa_fragment(nfa, d)
        for c in cur:
            nfa.eps[c].append(s)
            nfa.eps[c].append(end)
        for e in ends:
            nfa.eps[e].append(s)       # loop
            nfa.eps[e].append(end)
    else:
        for c in cur:
            nfa.eps[c].append(end)
        for _i in range(mx - mn):
            s, ends = _dfa_fragment(nfa, d)
            for c in cur:
                nfa.eps[c].append(s)
            cur = ends
            for c in cur:
                nfa.eps[c].append(end)
    return _nfa_to_dfa(nfa, start, end)


_COMPILE_CACHE: Dict[str, Dfa] = {}


def compile_regexp(pattern: str) -> Dfa:
    d = _COMPILE_CACHE.get(pattern)
    if d is None:
        ast = _parse(pattern)
        d = _to_dfa(ast)
        if len(_COMPILE_CACHE) > 256:
            _COMPILE_CACHE.clear()
        _COMPILE_CACHE[pattern] = d
    return d


def _parse(pattern: str):
    p = _P(pattern)
    ast = p.union()
    if not p.eof():
        raise RegexpError(
            f"unexpected [{p.peek()}] at position {p.i} in /{pattern}/")
    return ast


# ---------------------------------------------------------------------------
# the term dictionary as a codepoint matrix
# ---------------------------------------------------------------------------

def vocab_matrix(vocab: List[str], device="cpu"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(i32[nterms, maxlen] codepoints, 0-padded; i32[nterms] lengths) of
    a term list on `device`, built in one pass over the joined terms. The
    caller caches it per segment and field (`compiler.vocab_matrix_on`),
    so a merge drops it with the segment's other device arrays."""
    lens = np.fromiter((len(t) for t in vocab), np.int64, count=len(vocab))
    maxlen = int(lens.max()) if len(lens) else 0
    flat = np.frombuffer("".join(vocab).encode("utf-32-le"), np.uint32)
    mat = np.zeros((len(vocab), maxlen), np.int32)
    starts = np.cumsum(lens) - lens
    rows = np.repeat(np.arange(len(vocab)), lens)
    mat[rows, np.arange(len(flat)) - np.repeat(starts, lens)] = flat
    return (torch.from_numpy(mat).to(device),
            torch.from_numpy(lens.astype(np.int32)).to(device))


def match_vocab(pattern: str, vocab: List[str],
                matrix: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> np.ndarray:
    """bool[len(vocab)]: anchored (full-term) matches; `matrix` is the
    vocab's `vocab_matrix` where the caller holds one."""
    d = compile_regexp(pattern)
    if not vocab:
        return np.zeros(0, bool)
    mat, lens = matrix if matrix is not None else vocab_matrix(vocab)
    return d.match_matrix(mat, lens).cpu().numpy()


def osa_within(mat: torch.Tensor, lens: torch.Tensor, term: str, k: int,
               prefix: str = "") -> torch.Tensor:
    """bool[nterms] on `mat`'s device: the dictionary terms (the rows of
    a `vocab_matrix`) that start with `prefix` and lie within `k` edits
    of `term` in optimal string alignment distance (a swap of two
    adjacent chars counts 1, Lucene FuzzyQuery's default; the reference's
    `_edit_distance_le`). One DP row per dictionary char position, every
    term at once, held as [len(term) + 1, nterms] so that each step is
    contiguous over the terms; within a row the insertions close as a
    running minimum down the columns (cur[j] = min over l <= j of
    tmp[l] + j - l). A term stops at its length; a term longer than
    len(term) + k never matches, so the rows stop there."""
    dev = mat.device
    nterms, maxlen = mat.shape
    n = len(term)
    steps = min(maxlen, n + k)
    cols = mat[:, :steps].t().contiguous()           # [steps, nterms]
    b = torch.tensor([ord(c) for c in term], dtype=torch.int32,
                     device=dev)[:, None]
    jj = torch.arange(n + 1, dtype=torch.int32, device=dev)[:, None]
    prev = jj.expand(n + 1, nterms).clone()           # row 0: j inserts
    prev2 = prev
    for i in range(1, steps + 1):
        a = cols[i - 1][None, :]
        tmp = torch.empty_like(prev)
        tmp[0] = i
        tmp[1:] = torch.minimum(prev[1:] + 1,
                                prev[:-1] + (a != b).to(torch.int32))
        if i >= 2 and n >= 2:
            swap = (a == b[:-1]) & (cols[i - 2][None, :] == b[1:])
            tmp[2:] = torch.where(swap, torch.minimum(tmp[2:],
                                                      prev2[:-2] + 1),
                                  tmp[2:])
        cur = torch.cummin(tmp - jj, dim=0).values + jj
        prev2, prev = prev, torch.where(lens >= i, cur, prev)
    ok = (prev[n] <= k) & ((lens - n).abs() <= k)
    if prefix:
        np_ = len(prefix)
        if np_ > maxlen:
            return torch.zeros(nterms, dtype=torch.bool, device=dev)
        pre = torch.tensor([ord(c) for c in prefix], dtype=torch.int32,
                           device=dev)
        ok &= (lens >= np_) & (mat[:, :np_] == pre).all(dim=1)
    return ok
