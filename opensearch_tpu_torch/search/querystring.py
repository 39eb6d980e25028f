"""The Lucene query_string grammar and the lenient simple_query_string
grammar -> DSL Query tree (a copy of opensearch_tpu/search/querystring.py;
OpenSearch's `QueryStringQueryBuilder` over Lucene's classic QueryParser,
and `SimpleQueryStringBuilder`). Grammar covered by `parse_query_string`:

    field:term   field:(a OR b)   "a phrase"~slop   wild*card   prefix*
    fuzzy~   fuzzy~1   [a TO b]   {a TO b}   /regex/   term^boost
    + - ! NOT AND OR && ||   ( grouping )   _exists_:field   *:*
    \\ escaping of specials inside terms; dotted field names; field^boost
    in the `fields` list.

Boolean combination follows the classic parser's addClause algorithm
(AND retro-promotes the previous SHOULD clause to MUST; with a default
AND operator, OR demotes it), so `a AND b OR c` is (+a +b c). A string
over several fields becomes a `dis_max` of one clause per field.

The output is a plain dsl Query tree (BoolQuery / MatchQuery / RangeQuery
/ WildcardQuery / ...), so the rewrite serves a parsed string exactly as
the JSON DSL it stands for: the same plans, routes and caches.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from . import query_dsl as dsl

FieldSpec = Tuple[str, float]          # (name, boost)


def _float_or_400(v: str, what: str) -> float:
    try:
        return float(v)
    except ValueError:
        raise dsl.QueryParseError(f"[query_string] bad {what} [{v}]")


def parse_field_specs(fields: List[str]) -> List[FieldSpec]:
    """["title^5", "body"] -> [("title", 5.0), ("body", 1.0)]"""
    out = []
    for f in fields:
        if "^" in f:
            name, b = f.rsplit("^", 1)
            out.append((name, _float_or_400(b, "field boost")))
        else:
            out.append((f, 1.0))
    return out


def _unescape(s: str) -> str:
    return re.sub(r"\\(.)", r"\1", s)


def _wild_tokens(text: str) -> List[Tuple[str, str]]:
    """[("wild", "*"|"?") | ("lit", ch)]: only UNESCAPED * ? are wild."""
    out: List[Tuple[str, str]] = []
    i = 0
    while i < len(text):
        c = text[i]
        if c == "\\" and i + 1 < len(text):
            out.append(("lit", text[i + 1]))
            i += 2
        elif c in "*?":
            out.append(("wild", c))
            i += 1
        else:
            out.append(("lit", c))
            i += 1
    return out


def _wild_pattern(toks: List[Tuple[str, str]]) -> str:
    """fnmatch pattern: literal * ? [ are bracket-escaped so only the
    intended wildcards stay active."""
    out = []
    for kind, c in toks:
        if kind == "wild":
            out.append(c)
        elif c in "*?[":
            out.append(f"[{c}]")
        else:
            out.append(c)
    return "".join(out)


_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<lparen>\()
  | (?P<rparen>\))
  | (?P<and>AND\b|&&)
  | (?P<or>OR\b|\|\|)
  | (?P<not>NOT\b|!)
  | (?P<plus>\+)
  | (?P<minus>-)
  | (?P<phrase>"(?:\\.|[^"\\])*")
  | (?P<regex>/(?:\\.|[^/\\])+/)
  | (?P<range>[\[{](?:\\.|[^\]}\\])*?\s+TO\s+(?:\\.|[^\]}\\])*?[\]}])
  | (?P<caret>\^(?P<boost>[\d.]+))
  | (?P<tilde>~(?P<fuzz>[\d.]+)?)
  | (?P<field>(?:\\.|[*]|[^\s\\+\-!():^\[\]"{}~*?/|&])
              (?:\\.|[*+\-]|&(?!&)|\|(?!\|)|[^\s\\!():^\[\]"{}~*?/|&])*\s*:)
  | (?P<term>(?:\\.|[*?]|&(?!&)|\|(?!\|)|[^\s\\+\-!():^\[\]"{}~/|&])
             (?:\\.|[*?+\-]|&(?!&)|\|(?!\|)|[^\s\\!():^\[\]"{}~/|&])*)
""", re.X)
# NB: '+'/'-' are special only at clause start (their named groups match
# first); INSIDE a term they are literal, matching Lucene's _TERM_CHAR —
# "well-known", "C++" are single terms. Single '&'/'|' are literal; only
# '&&'/'||' are operators (the lookaheads stop the term before them).


def _lex(s: str) -> List[Tuple[str, str]]:
    out: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if m is None:
            raise dsl.QueryParseError(
                f"[query_string] cannot parse at offset {pos}: "
                f"{s[pos:pos + 20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        if kind == "caret":
            out.append(("CARET", m.group("boost")))
        elif kind == "tilde":
            out.append(("TILDE", m.group("fuzz") or ""))
        elif kind == "field":
            out.append(("FIELD",
                        _unescape(m.group(0).rstrip()[:-1].rstrip())))
        else:
            out.append((kind.upper(), m.group(0)))
    out.append(("EOF", ""))
    return out


class _Parser:
    def __init__(self, tokens, fields: List[FieldSpec], op_and: bool,
                 phrase_slop: int):
        self.toks = tokens
        self.i = 0
        self.fields = fields
        self.op_and = op_and
        self.phrase_slop = phrase_slop

    def peek(self) -> Tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> Tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    # ---- boolean clause list (classic QueryParser.addClause) ----

    def query(self, scope: Optional[List[FieldSpec]],
              in_group: bool = False) -> Optional[dsl.Query]:
        clauses: List[list] = []       # [occur, query]
        while True:
            kind, _ = self.peek()
            if kind == "EOF" or (in_group and kind == "RPAREN"):
                break
            conj = None
            if kind in ("AND", "OR"):
                conj = kind
                self.next()
                kind, _ = self.peek()
                if kind == "EOF" or (in_group and kind == "RPAREN"):
                    break
            mods = None
            while self.peek()[0] in ("PLUS", "MINUS", "NOT"):
                k = self.next()[0]
                mods = "+" if k == "PLUS" else "-"
            q = self.clause(scope)
            if q is None:
                continue
            self._add_clause(clauses, conj, mods, q)
        return self._assemble(clauses)

    def _add_clause(self, clauses: List[list], conj, mods, q) -> None:
        if clauses and conj == "AND" and clauses[-1][0] == "should":
            clauses[-1][0] = "must"
        if clauses and self.op_and and conj == "OR" \
                and clauses[-1][0] == "must":
            clauses[-1][0] = "should"
        if mods == "-":
            occur = "must_not"
        elif mods == "+":
            occur = "must"
        elif conj == "AND":
            occur = "must"           # AND requires the current clause too
        elif self.op_and and conj != "OR":
            occur = "must"
        else:
            occur = "should"
        clauses.append([occur, q])

    def _assemble(self, clauses: List[list]) -> Optional[dsl.Query]:
        if not clauses:
            return None
        if len(clauses) == 1 and clauses[0][0] in ("should", "must"):
            return clauses[0][1]
        b = dsl.BoolQuery()
        for occur, q in clauses:
            getattr(b, {"must": "must", "should": "should",
                        "must_not": "must_not"}[occur]).append(q)
        if b.should and not b.must:
            b.minimum_should_match = "1"
        return b

    # ---- a single clause ----

    def clause(self, scope: Optional[List[FieldSpec]]) -> Optional[dsl.Query]:  # noqa: C901
        kind, val = self.peek()

        if kind == "FIELD":
            self.next()
            fname = val
            if fname == "_exists_":
                k2, v2 = self.peek()
                if k2 not in ("TERM", "PHRASE"):
                    raise dsl.QueryParseError(
                        "[query_string] _exists_: needs a field name")
                self.next()
                q: dsl.Query = dsl.ExistsQuery(field=_unescape(
                    v2.strip('"')))
                return self._postfix_boost(q)
            if fname == "*" and self.peek() == ("TERM", "*"):
                self.next()
                return self._postfix_boost(dsl.MatchAllQuery())
            return self.clause([(fname, 1.0)])

        fields = scope or self.fields

        if kind == "LPAREN":
            self.next()
            q = self.query(fields, in_group=True)
            if self.peek()[0] != "RPAREN":
                raise dsl.QueryParseError(
                    "[query_string] missing closing \")\"")
            self.next()
            if q is None:
                return None
            return self._postfix_boost(q)

        if kind == "PHRASE":
            self.next()
            text = _unescape(val[1:-1])
            slop = self.phrase_slop
            boost = 1.0
            while self.peek()[0] in ("TILDE", "CARET"):
                k2, v2 = self.next()
                if k2 == "TILDE":
                    slop = int(_float_or_400(v2, "slop")) if v2 else slop
                else:
                    boost = _float_or_400(v2, "boost")
            return self._multi(
                fields,
                lambda f: dsl.MatchPhraseQuery(field=f, query=text,
                                               slop=slop), boost)

        if kind == "RANGE":
            self.next()
            include_lo = val[0] == "["
            include_hi = val[-1] == "]"
            body = val[1:-1]
            m = re.split(r"\s+TO\s+", body, maxsplit=1)
            if len(m) != 2:
                raise dsl.QueryParseError(
                    f"[query_string] bad range [{val}]")
            lo = _unescape(m[0].strip().strip('"'))
            hi = _unescape(m[1].strip().strip('"'))

            def mk_range(f):
                rq = dsl.RangeQuery(field=f)
                if lo not in ("*", ""):
                    setattr(rq, "gte" if include_lo else "gt", lo)
                if hi not in ("*", ""):
                    setattr(rq, "lte" if include_hi else "lt", hi)
                return rq
            return self._multi(fields, mk_range, self._boost_suffix())

        if kind == "REGEX":
            self.next()
            pat = _unescape(val[1:-1])
            return self._multi(fields,
                               lambda f: dsl.RegexpQuery(field=f, value=pat),
                               self._boost_suffix())

        if kind == "TERM":
            self.next()
            text = val
            fuzz = None
            boost = 1.0
            while self.peek()[0] in ("TILDE", "CARET"):
                k2, v2 = self.next()
                if k2 == "TILDE":
                    fuzz = v2 if v2 else "AUTO"
                else:
                    boost = _float_or_400(v2, "boost")
            toks = _wild_tokens(text)
            wild_idx = [i for i, (k, _) in enumerate(toks) if k == "wild"]
            plain = _unescape(text)

            def mk_term(f):
                if fuzz is not None:
                    fz = ("AUTO" if fuzz == "AUTO"
                          else int(_float_or_400(fuzz, "fuzziness")))
                    return dsl.FuzzyQuery(field=f, value=plain, fuzziness=fz)
                if wild_idx:
                    if len(toks) == 1 and toks[0] == ("wild", "*"):
                        return dsl.ExistsQuery(field=f)
                    if (wild_idx == [len(toks) - 1]
                            and toks[-1] == ("wild", "*")):
                        return dsl.PrefixQuery(
                            field=f,
                            value="".join(c for _k, c in toks[:-1]))
                    return dsl.WildcardQuery(field=f,
                                             value=_wild_pattern(toks))
                op = "and" if self.op_and else "or"
                return dsl.MatchQuery(field=f, query=plain, operator=op)
            return self._multi(fields, mk_term, boost)

        if kind == "RPAREN":
            raise dsl.QueryParseError("[query_string] unexpected \")\"")
        if kind in ("CARET", "TILDE"):
            self.next()  # dangling postfix: skip
            return None
        raise dsl.QueryParseError(
            f"[query_string] unexpected token {val!r}")

    def _boost_suffix(self) -> float:
        if self.peek()[0] == "CARET":
            return _float_or_400(self.next()[1], "boost")
        return 1.0

    def _postfix_boost(self, q: dsl.Query) -> dsl.Query:
        b = self._boost_suffix()
        if b != 1.0:
            q.boost = q.boost * b
        return q

    def _multi(self, fields: List[FieldSpec], mk, boost: float) -> dsl.Query:
        qs = []
        for fname, fboost in fields:
            q = mk(fname)
            q.boost = fboost * boost
            qs.append(q)
        if len(qs) == 1:
            return qs[0]
        dm = dsl.DisMaxQuery(queries=qs)
        return dm


def parse_query_string(query: str, fields: List[str],
                       default_operator: str = "or",
                       phrase_slop: int = 0) -> dsl.Query:
    toks = _lex(query)
    p = _Parser(toks, parse_field_specs(fields),
                str(default_operator).lower() == "and", phrase_slop)
    q = p.query(None)
    if p.peek()[0] != "EOF":
        raise dsl.QueryParseError(
            f"[query_string] trailing input at token {p.peek()[1]!r}")
    return q if q is not None else dsl.MatchNoneQuery()


# ---------------------------------------------------------------------------
# simple_query_string: the lenient grammar (+ | - " ( ) * ~N), never throws
# ---------------------------------------------------------------------------

_SQS_TOKEN = re.compile(r"""
    (?P<ws>\s+)
  | (?P<lparen>\()
  | (?P<rparen>\))
  | (?P<or>\|)
  | (?P<plus>\+)
  | (?P<minus>-)
  | (?P<phrase>"(?:\\.|[^"\\])*"?)
  | (?P<tilde>~(?P<n>\d+)?)
  | (?P<term>(?:\\.|[^\s\\+\-|()"~])(?:\\.|-|[^\s\\+\-|()"~])*)
""", re.X)
# '-' negates only at clause start (SimpleQueryParser); mid-term it is
# literal so "well-known" stays one term. '+' remains an operator anywhere
# unescaped, as in the reference.


def _sqs_lex(s: str) -> List[Tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(s):
        m = _SQS_TOKEN.match(s, pos)
        if m is None:          # lenient: skip one char
            pos += 1
            continue
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        if m.lastgroup == "tilde":
            out.append(("TILDE", m.group("n") or "1"))
        else:
            out.append((m.lastgroup.upper(), m.group(0)))
    out.append(("EOF", ""))
    return out


class _SqsParser:
    """or_expr := seq ('|' seq)* ; seq := chunk+ (default-op joined);
    chunk := unit ('+' unit)* (must-joined); unit := '-'? atom."""

    def __init__(self, toks, fields: List[FieldSpec], op_and: bool):
        self.toks = toks
        self.i = 0
        self.fields = fields
        self.op_and = op_and

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def or_expr(self, in_group=False) -> Optional[dsl.Query]:
        parts = []
        while True:
            s = self.seq(in_group)
            if s is not None:
                parts.append(s)
            if self.peek()[0] == "OR":
                self.next()
                continue
            break
        if not parts:
            return None
        if len(parts) == 1:
            return parts[0]
        # a purely-negative alternative ("-a | b") becomes its own
        # NOT-clause inside the OR, never a bare sentinel
        parts = [dsl.BoolQuery(must_not=[p.q]) if isinstance(p, _Negated)
                 else p for p in parts]
        return dsl.BoolQuery(should=parts, minimum_should_match="1")

    def seq(self, in_group) -> Optional[dsl.Query]:
        chunks = []
        while True:
            kind, _ = self.peek()
            if kind in ("EOF", "OR") or (in_group and kind == "RPAREN"):
                break
            if kind == "RPAREN":   # lenient: stray ) is skipped
                self.next()
                continue
            c = self.chunk(in_group)
            if c is not None:
                chunks.append(c)
            elif self.i < len(self.toks) - 1 and self.peek()[0] not in (
                    "EOF", "OR", "RPAREN"):
                self.next()        # lenient: skip unusable token
            else:
                break
        if not chunks:
            return None
        if len(chunks) == 1:
            return chunks[0]
        pos = [c for c in chunks if not isinstance(c, _Negated)]
        neg = [c.q for c in chunks if isinstance(c, _Negated)]
        if self.op_and:
            return dsl.BoolQuery(must=pos, must_not=neg)
        return dsl.BoolQuery(should=pos, must_not=neg,
                             minimum_should_match="1" if pos else None)

    def chunk(self, in_group) -> Optional[dsl.Query]:
        units = []
        u = self.unit(in_group)
        if u is None:
            return None
        units.append(u)
        while self.peek()[0] == "PLUS":
            self.next()
            u = self.unit(in_group)
            if u is not None:
                units.append(u)
        if len(units) == 1:
            return units[0]
        pos = [c for c in units if not isinstance(c, _Negated)]
        neg = [c.q for c in units if isinstance(c, _Negated)]
        return dsl.BoolQuery(must=pos, must_not=neg)

    def unit(self, in_group):
        negate = False
        while self.peek()[0] == "MINUS":
            self.next()
            negate = not negate
        q = self.atom(in_group)
        if q is None:
            return None
        if not negate:
            return q
        if isinstance(q, _Negated):      # "-(-a)" cancels
            return q.q
        return _Negated(q)

    def atom(self, in_group) -> Optional[dsl.Query]:
        kind, val = self.peek()
        if kind == "LPAREN":
            self.next()
            q = self.or_expr(in_group=True)
            if self.peek()[0] == "RPAREN":
                self.next()
            return q
        if kind == "PHRASE":
            self.next()
            text = _unescape(val.strip('"'))
            slop = 0
            if self.peek()[0] == "TILDE":
                slop = int(self.next()[1])
            if not text:
                return None
            return self._multi(
                lambda f: dsl.MatchPhraseQuery(field=f, query=text,
                                               slop=slop))
        if kind == "TERM":
            self.next()
            text = _unescape(val)
            fuzz = None
            if self.peek()[0] == "TILDE":
                fuzz = int(self.next()[1])

            def mk(f):
                if fuzz is not None:
                    return dsl.FuzzyQuery(field=f, value=text, fuzziness=fuzz)
                if text.endswith("*"):
                    return dsl.PrefixQuery(field=f, value=text[:-1])
                op = "and" if self.op_and else "or"
                return dsl.MatchQuery(field=f, query=text, operator=op)
            return self._multi(mk)
        return None

    def _multi(self, mk) -> dsl.Query:
        qs = []
        for fname, fboost in self.fields:
            q = mk(fname)
            q.boost = fboost
            qs.append(q)
        return qs[0] if len(qs) == 1 else dsl.DisMaxQuery(queries=qs)


class _Negated:
    def __init__(self, q):
        self.q = q


def parse_simple_query_string(query: str, fields: List[str],
                              default_operator: str = "or") -> dsl.Query:
    p = _SqsParser(_sqs_lex(query), parse_field_specs(fields),
                   str(default_operator).lower() == "and")
    q = p.or_expr()
    if isinstance(q, _Negated):
        q = dsl.BoolQuery(must_not=[q.q])
    return q if q is not None else dsl.MatchNoneQuery()
