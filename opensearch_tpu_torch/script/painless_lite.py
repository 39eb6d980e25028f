"""painless-lite: a safe expression/statement language run by a host
interpreter or evaluated over dense per-document columns as torch ops.

A copy of opensearch_tpu/script/painless_lite.py (the analog of
OpenSearch's Painless engine, `modules/lang-painless`): the lexer, the
parser to hashable tuple ASTs, the host interpreter of the update,
script_fields, sort, terms_set, scripted_metric and pipeline contexts,
and `validate_device_script`. The device evaluator of the score and
filter contexts (`eval_device`) evaluates the same AST over torch tensors
on an explicit device: `doc['f'].value` is the f32 view of the column
over the whole segment (`Segment.f32_on`), a param an f32 scalar tensor,
and a Python literal a weak constant, as jnp treats it (a Math function
of a bare number is evaluated in f32, `%` is the reference's truncated
remainder, `Math.round` rounds half to even).

Grammar (subset of Painless):
  program   := stmt (';' stmt)* ';'?
  stmt      := type ID '=' expr | 'if' '(' expr ')' block ('else' (block|if))?
             | 'for' '(' [type] ID (in|':') expr ')' block
             | 'for' '(' init ';' cond ';' update ')' block
             | 'while' '(' expr ')' block | 'break' | 'continue'
             | 'return' expr | lvalue ('='|'+='|'-='|'*='|'/=') expr | expr
  expr      := ternary with ||, &&, ==/!=, </<=/>/>=, +/-, */ /%, unary -/!,
               ++/-- (pre/post), postfix .member, [index], call(args),
               lambda: ID '->' body | '(' params ')' '->' body, f(args)
Literals: numbers, 'str'/"str", true/false/null, [a,b] lists, [:] maps.
Collections carry the whitelisted java.util surface incl. sort(cmp),
removeIf(f), stream() pipelines (filter/map/sorted/distinct/limit/skip/
count/sum/average/min/max/anyMatch/allMatch/noneMatch/collect/findFirst),
String.splitOnToken, array .length. Device (score-context) scripts are
arithmetic only: loops and collections are host contexts.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

MAX_LOOP_ITERS = 100_000


class ScriptError(ValueError):
    """Analog of reference ScriptException (HTTP 400)."""


# =====================================================================
# lexer
# =====================================================================

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>//[^\n]*|/\*.*?\*/)
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?[fFdDlL]?)
  | (?P<str>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
  | (?P<id>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>==|!=|<=|>=|&&|\|\||->|\+=|-=|\*=|/=|%=|\+\+|--|[-+*/%!<>=?:.,()\[\]{};])
""", re.VERBOSE | re.DOTALL)

_KEYWORDS = {"def", "if", "else", "for", "in", "return", "true", "false", "null",
             "int", "long", "float", "double", "boolean", "String", "var",
             "while", "break", "continue"}

_TYPE_KWS = ("def", "var", "int", "long", "float", "double", "boolean",
             "String")


def _lex(src: str) -> List[Tuple[str, Any]]:
    toks: List[Tuple[str, Any]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise ScriptError(f"unexpected character {src[pos]!r} at {pos}")
        pos = m.end()
        if m.lastgroup in ("ws", "comment"):
            continue
        if m.lastgroup == "num":
            t = m.group("num")
            if t[-1] in "fFdDlL":
                t = t[:-1]
            toks.append(("num", float(t) if ("." in t or "e" in t or "E" in t)
                         else int(t)))
        elif m.lastgroup == "str":
            raw = m.group("str")[1:-1]
            toks.append(("str", re.sub(
                r"\\(.)",
                lambda mm: {"n": "\n", "t": "\t", "r": "\r"}.get(mm.group(1),
                                                                mm.group(1)),
                raw)))
        elif m.lastgroup == "id":
            name = m.group("id")
            toks.append(("kw" if name in _KEYWORDS else "id", name))
        else:
            toks.append(("op", m.group("op")))
    toks.append(("eof", None))
    return toks


# =====================================================================
# parser -> tuple AST
# =====================================================================

class _Parser:
    def __init__(self, toks: List[Tuple[str, Any]]):
        self.toks = toks
        self.i = 0

    def peek(self) -> Tuple[str, Any]:
        return self.toks[self.i]

    def next(self) -> Tuple[str, Any]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, val=None) -> bool:
        k, v = self.peek()
        if k == kind and (val is None or v == val):
            self.i += 1
            return True
        return False

    def expect(self, kind: str, val=None) -> Any:
        k, v = self.next()
        if k != kind or (val is not None and v != val):
            raise ScriptError(f"expected {val or kind}, got {v!r}")
        return v

    # ---- statements ----

    def program(self) -> tuple:
        stmts = []
        while self.peek()[0] != "eof":
            if self.accept("op", ";"):
                continue
            stmts.append(self.stmt())
        return ("block", tuple(stmts))

    def block(self) -> tuple:
        if self.accept("op", "{"):
            stmts = []
            while not self.accept("op", "}"):
                if self.accept("op", ";"):
                    continue
                stmts.append(self.stmt())
            return ("block", tuple(stmts))
        return ("block", (self.stmt(),))

    def stmt(self) -> tuple:
        k, v = self.peek()
        if k == "kw" and v in _TYPE_KWS:
            self.next()
            name = self.expect("id")
            self.expect("op", "=")
            return ("decl", name, self.expr())
        if k == "kw" and v == "if":
            return self._if()
        if k == "kw" and v == "while":
            self.next()
            self.expect("op", "(")
            cond = self.expr()
            self.expect("op", ")")
            return ("while", cond, self.block())
        if k == "kw" and v == "break":
            self.next()
            return ("break",)
        if k == "kw" and v == "continue":
            self.next()
            return ("continue",)
        if k == "kw" and v == "for":
            return self._for()
        if k == "kw" and v == "return":
            self.next()
            if self.peek() in (("op", ";"), ("eof", None)):
                return ("return", ("null",))
            return ("return", self.expr())
        expr = self.expr()
        kk, vv = self.peek()
        if kk == "op" and vv in ("=", "+=", "-=", "*=", "/=", "%="):
            self.next()
            rhs = self.expr()
            if expr[0] not in ("var", "member", "index"):
                raise ScriptError("invalid assignment target")
            return ("assign", vv, expr, rhs)
        return ("exprstmt", expr)

    def _for(self) -> tuple:
        """All three reference for-forms:
        `for (x in e)` / `for ([type] x : e)` (for-each) and the C-style
        `for (init; cond; update)` (the dominant shape in the reference's
        painless test corpus)."""
        self.expect("kw", "for")
        self.expect("op", "(")
        save = self.i
        # try for-each: optional type keyword, id, then `in` or `:`
        k, v = self.peek()
        if k == "kw" and v in _TYPE_KWS:
            self.next()
        if self.peek()[0] == "id":
            name = self.next()[1]
            if self.accept("kw", "in") or self.accept("op", ":"):
                it = self.expr()
                self.expect("op", ")")
                return ("for", name, it, self.block())
        # C-style: rewind and parse init; cond; update
        self.i = save
        init = None if self.peek() == ("op", ";") else self.stmt()
        self.expect("op", ";")
        cond = (("bool", True) if self.peek() == ("op", ";")
                else self.expr())
        self.expect("op", ";")
        update = None if self.peek() == ("op", ")") else self.stmt()
        self.expect("op", ")")
        return ("cfor", init, cond, update, self.block())

    def _if(self) -> tuple:
        self.expect("kw", "if")
        self.expect("op", "(")
        cond = self.expr()
        self.expect("op", ")")
        then = self.block()
        if self.accept("kw", "else"):
            if self.peek() == ("kw", "if"):
                return ("if", cond, then, ("block", (self._if(),)))
            return ("if", cond, then, self.block())
        return ("if", cond, then, ("block", ()))

    # ---- expressions (precedence climbing) ----

    def expr(self) -> tuple:
        return self.ternary()

    def ternary(self) -> tuple:
        c = self.or_()
        if self.accept("op", "?"):
            t = self.expr()
            self.expect("op", ":")
            f = self.expr()
            return ("cond", c, t, f)
        return c

    def _binop(self, sub, ops) -> tuple:
        left = sub()
        while True:
            k, v = self.peek()
            if k == "op" and v in ops:
                self.next()
                left = ("bin", v, left, sub())
            else:
                return left

    def or_(self):
        return self._binop(self.and_, ("||",))

    def and_(self):
        return self._binop(self.eq, ("&&",))

    def eq(self):
        return self._binop(self.cmp, ("==", "!="))

    def cmp(self):
        return self._binop(self.add, ("<", "<=", ">", ">="))

    def add(self):
        return self._binop(self.mul, ("+", "-"))

    def mul(self):
        return self._binop(self.unary, ("*", "/", "%"))

    def unary(self) -> tuple:
        if self.accept("op", "++"):
            return ("incdec", self.unary(), 1, True)
        if self.accept("op", "--"):
            return ("incdec", self.unary(), -1, True)
        if self.accept("op", "-"):
            return ("un", "-", self.unary())
        if self.accept("op", "!"):
            return ("un", "!", self.unary())
        if self.accept("op", "+"):
            return self.unary()
        return self.postfix()

    def postfix(self) -> tuple:
        e = self.primary()
        while True:
            if self.accept("op", "."):
                name = self.next()
                if name[0] not in ("id", "kw"):
                    raise ScriptError(f"expected member name, got {name[1]!r}")
                if self.accept("op", "("):
                    args = self._args()
                    e = ("call", e, name[1], tuple(args))
                else:
                    e = ("member", e, name[1])
            elif self.accept("op", "["):
                idx = self.expr()
                self.expect("op", "]")
                e = ("index", e, idx)
            elif self.accept("op", "++"):
                e = ("incdec", e, 1, False)
            elif self.accept("op", "--"):
                e = ("incdec", e, -1, False)
            elif e[0] in ("var", "lambda") and self.accept("op", "("):
                e = ("invoke", e, tuple(self._args()))   # f(x): lambda call
            else:
                return e

    def _args(self) -> List[tuple]:
        args: List[tuple] = []
        if self.accept("op", ")"):
            return args
        args.append(self.expr())
        while self.accept("op", ","):
            args.append(self.expr())
        self.expect("op", ")")
        return args

    def _peek_lambda_params(self) -> Optional[tuple]:
        """Called with '(' already consumed: scan ahead for the
        `id (, id)* ) ->` (or `) ->`) pattern WITHOUT consuming; on match,
        consume through '->' and return the parameter tuple."""
        j = self.i
        params = []
        if self.toks[j][0] == "id":
            params.append(self.toks[j][1])
            j += 1
            while self.toks[j] == ("op", ","):
                if self.toks[j + 1][0] != "id":
                    return None
                params.append(self.toks[j + 1][1])
                j += 2
        if self.toks[j] != ("op", ")") or self.toks[j + 1] != ("op", "->"):
            return None
        self.i = j + 2
        return tuple(params)

    def _lambda_body(self) -> tuple:
        if self.peek() == ("op", "{"):
            return self.block()
        return ("block", (("return", self.expr()),))

    def primary(self) -> tuple:
        k, v = self.next()
        if k == "num":
            return ("num", v)
        if k == "str":
            return ("strlit", v)
        if k == "kw" and v == "true":
            return ("bool", True)
        if k == "kw" and v == "false":
            return ("bool", False)
        if k == "kw" and v == "null":
            return ("null",)
        if k == "id":
            if self.peek() == ("op", "->"):        # x -> expr
                self.next()
                return ("lambda", (v,), self._lambda_body())
            return ("var", v)
        if k == "op" and v == "(":
            params = self._peek_lambda_params()
            if params is not None:                 # (a, b) -> expr
                return ("lambda", params, self._lambda_body())
            e = self.expr()
            self.expect("op", ")")
            return e
        if k == "op" and v == "[":
            if self.accept("op", ":"):  # [:] empty map
                self.expect("op", "]")
                return ("maplit", ())
            items = []
            if not self.accept("op", "]"):
                first = self.expr()
                if self.accept("op", ":"):  # map literal
                    pairs = [(first, self.expr())]
                    while self.accept("op", ","):
                        pk = self.expr()
                        self.expect("op", ":")
                        pairs.append((pk, self.expr()))
                    self.expect("op", "]")
                    return ("maplit", tuple(pairs))
                items.append(first)
                while self.accept("op", ","):
                    items.append(self.expr())
                self.expect("op", "]")
            return ("listlit", tuple(items))
        raise ScriptError(f"unexpected token {v!r}")


def parse(source: str) -> tuple:
    """Parse script source -> hashable tuple AST (cached)."""
    return _parse_cached(source)


_parse_cache: Dict[str, tuple] = {}


def _parse_cached(source: str) -> tuple:
    ast = _parse_cache.get(source)
    if ast is None:
        ast = _Parser(_lex(source)).program()
        if len(_parse_cache) > 4096:
            _parse_cache.clear()
        _parse_cache[source] = ast
    return ast


def referenced_doc_fields(ast: tuple) -> Tuple[str, ...]:
    """Fields read via doc['f'] / doc.f — drives per-segment column binding."""
    out: List[str] = []

    def walk(n):
        if not isinstance(n, tuple) or not n:
            return
        if n[0] == "index" and n[1] == ("var", "doc") \
                and isinstance(n[2], tuple) and n[2][0] == "strlit":
            out.append(n[2][1])
        elif n[0] == "member" and n[1] == ("var", "doc") and isinstance(n[2], str):
            out.append(n[2])
        for c in n:
            walk(c)
    walk(ast)
    seen, uniq = set(), []
    for f in out:
        if f not in seen:
            seen.add(f)
            uniq.append(f)
    return tuple(uniq)


# =====================================================================
# host interpreter (update / ingest / script_fields / sort contexts)
# =====================================================================

class _Return(Exception):
    def __init__(self, value):
        self.value = value


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


class _Lambda:
    """A painless lambda closing over the enclosing scope (reference
    lambdas capture effectively-final locals; we shadow + restore)."""

    __slots__ = ("params", "body", "env")

    def __init__(self, params, body, env):
        self.params = params
        self.body = body
        self.env = env

    def __call__(self, *args):
        saved = {p: self.env.vars.get(p, _MISSING) for p in self.params}
        self.env.vars.update(dict(zip(self.params, args)))
        try:
            return _exec_block(self.body, self.env)
        except _Return as r:
            return r.value
        except (_Break, _Continue):
            # real Painless rejects break/continue inside a lambda at
            # compile time; it must never unwind into the CALLER's loop
            raise ScriptError("break/continue not allowed in a lambda")
        finally:
            for p, old in saved.items():
                if old is _MISSING:
                    self.env.vars.pop(p, None)
                else:
                    self.env.vars[p] = old


_MISSING = object()


_MATH_FNS: Dict[str, Callable] = {
    "log": math.log, "log10": math.log10, "sqrt": math.sqrt, "abs": abs,
    "exp": math.exp, "pow": math.pow, "min": min, "max": max,
    "floor": math.floor, "ceil": math.ceil, "round": round,
    "sin": math.sin, "cos": math.cos, "tan": math.tan, "atan2": math.atan2,
}
_MATH_CONSTS = {"PI": math.pi, "E": math.e}


class _DocValuesView:
    """Host `doc['field']` — mimics reference ScriptDocValues."""

    def __init__(self, values: list):
        self.values = values

    @property
    def value(self):
        if not self.values:
            raise ScriptError("A document doesn't have a value for a field")
        return self.values[0]

    def size(self):
        return len(self.values)

    @property
    def empty(self):
        return not self.values

    @property
    def length(self):
        return len(self.values)

    def get(self, i):
        return self.values[int(i)]

    def contains(self, v):
        return v in self.values


HostDocValue = _DocValuesView     # public alias (search/derived.py)


class HostEnv:
    """Variable scope + builtins for the host interpreter."""

    def __init__(self, variables: Dict[str, Any]):
        self.vars = dict(variables)

    def lookup(self, name: str):
        if name in self.vars:
            return self.vars[name]
        if name == "Math":
            return "__Math__"
        raise ScriptError(f"unknown variable [{name}]")


def execute(ast_or_src, variables: Dict[str, Any]) -> Any:
    """Run a script on the host; returns the `return` value or the value of
    the final expression statement (Painless's implicit return)."""
    ast = parse(ast_or_src) if isinstance(ast_or_src, str) else ast_or_src
    env = HostEnv(variables)
    try:
        return _exec_block(ast, env)
    except _Return as r:
        return r.value
    except (_Break, _Continue):
        raise ScriptError("break/continue outside of a loop")
    except ScriptError:
        raise
    except (ZeroDivisionError, IndexError, TypeError, KeyError, ValueError,
            OverflowError, AttributeError, RecursionError) as e:
        # runtime faults keep the ScriptError contract (callers map it to 400)
        raise ScriptError(f"runtime error: {type(e).__name__}: {e}")


def _exec_block(block: tuple, env: HostEnv) -> Any:
    last = None
    for st in block[1]:
        last = _exec_stmt(st, env)
    return last


def _exec_stmt(st: tuple, env: HostEnv) -> Any:  # noqa: C901
    op = st[0]
    if op == "decl":
        env.vars[st[1]] = _eval(st[2], env)
        return None
    if op == "if":
        if _truthy(_eval(st[1], env)):
            return _exec_block(st[2], env)
        return _exec_block(st[3], env)
    if op == "for":
        _, name, it_expr, body = st
        it = _eval(it_expr, env)
        if isinstance(it, _DocValuesView):
            it = it.values
        if not isinstance(it, (list, tuple, dict)):
            raise ScriptError("for-in requires a list or map")
        if isinstance(it, dict):
            it = list(it.keys())
        for i, item in enumerate(it):
            if i >= MAX_LOOP_ITERS:
                raise ScriptError("loop iteration limit exceeded")
            env.vars[name] = item
            try:
                _exec_block(body, env)
            except _Break:
                break
            except _Continue:
                continue
        return None
    if op == "cfor":
        _, init, cond, update, body = st
        if init is not None:
            _exec_stmt(init, env)
        n = 0
        while _truthy(_eval(cond, env)):
            if n >= MAX_LOOP_ITERS:
                raise ScriptError("loop iteration limit exceeded")
            n += 1
            try:
                _exec_block(body, env)
            except _Break:
                break
            except _Continue:
                pass
            if update is not None:
                _exec_stmt(update, env)
        return None
    if op == "while":
        _, cond, body = st
        n = 0
        while _truthy(_eval(cond, env)):
            if n >= MAX_LOOP_ITERS:
                raise ScriptError("loop iteration limit exceeded")
            n += 1
            try:
                _exec_block(body, env)
            except _Break:
                break
            except _Continue:
                continue
        return None
    if op == "break":
        raise _Break()
    if op == "continue":
        raise _Continue()
    if op == "return":
        raise _Return(_eval(st[1], env))
    if op == "assign":
        _, aop, target, rhs = st
        val = _eval(rhs, env)
        if aop != "=":
            cur = _eval(target, env)
            val = _apply_binop(aop[0], cur, val)
        _assign(target, val, env)
        return None
    if op == "exprstmt":
        return _eval(st[1], env)
    raise ScriptError(f"unknown statement {op}")


def _assign(target: tuple, val, env: HostEnv) -> None:
    kind = target[0]
    if kind == "var":
        env.vars[target[1]] = val
        return
    if kind == "member":
        obj = _eval(target[1], env)
        if isinstance(obj, dict):
            obj[target[2]] = val
            return
        raise ScriptError(f"cannot assign member [{target[2]}]")
    if kind == "index":
        obj = _eval(target[1], env)
        key = _eval(target[2], env)
        if isinstance(obj, dict):
            obj[key] = val
            return
        if isinstance(obj, list):
            obj[int(key)] = val
            return
        raise ScriptError("cannot index-assign")
    raise ScriptError("invalid assignment target")


def _truthy(v) -> bool:
    if isinstance(v, _DocValuesView):
        return not v.empty
    return bool(v)


def _apply_binop(op: str, a, b):  # noqa: C901
    if op == "+":
        if isinstance(a, str) or isinstance(b, str):
            return _to_str(a) + _to_str(b)
        if isinstance(a, list) and isinstance(b, list):
            return a + b
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        if isinstance(a, int) and isinstance(b, int):
            if b == 0:
                raise ScriptError("/ by zero")
            q = a // b
            if q < 0 and q * b != a:
                q += 1  # Java integer division truncates toward zero
            return q
        return a / b
    if op == "%":
        if isinstance(a, int) and isinstance(b, int):
            r = abs(a) % abs(b)
            return -r if a < 0 else r  # Java remainder semantics
        return math.fmod(a, b)
    if op == "==":
        return _unwrap(a) == _unwrap(b)
    if op == "!=":
        return _unwrap(a) != _unwrap(b)
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    raise ScriptError(f"unknown operator {op}")


def _unwrap(v):
    return v.value if isinstance(v, _DocValuesView) else v


def _to_str(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(v)
    if v is None:
        return "null"
    return str(v)


def _eval(e: tuple, env: HostEnv) -> Any:  # noqa: C901
    kind = e[0]
    if kind == "num":
        return e[1]
    if kind == "strlit":
        return e[1]
    if kind == "bool":
        return e[1]
    if kind == "null":
        return None
    if kind == "var":
        return env.lookup(e[1])
    if kind == "listlit":
        return [_eval(x, env) for x in e[1]]
    if kind == "maplit":
        return {_eval(k, env): _eval(v, env) for k, v in e[1]}
    if kind == "cond":
        return _eval(e[2], env) if _truthy(_eval(e[1], env)) else _eval(e[3], env)
    if kind == "lambda":
        return _Lambda(e[1], e[2], env)
    if kind == "invoke":
        fn = _eval(e[1], env)
        if not callable(fn):
            raise ScriptError("not a function")
        return fn(*[_eval(a, env) for a in e[2]])
    if kind == "incdec":
        _, target, delta, pre = e
        cur = _eval(target, env)
        new = cur + delta
        _assign(target, new, env)
        return new if pre else cur
    if kind == "un":
        v = _eval(e[2], env)
        return (not _truthy(v)) if e[1] == "!" else -v
    if kind == "bin":
        op = e[1]
        if op == "&&":
            return _truthy(_eval(e[2], env)) and _truthy(_eval(e[3], env))
        if op == "||":
            return _truthy(_eval(e[2], env)) or _truthy(_eval(e[3], env))
        return _apply_binop(op, _eval(e[2], env), _eval(e[3], env))
    if kind == "member":
        return _member(_eval(e[1], env), e[2])
    if kind == "index":
        obj = _eval(e[1], env)
        key = _eval(e[2], env)
        if isinstance(obj, _LazyDoc):
            return obj.get(key)
        if isinstance(obj, dict):
            return obj.get(key)
        if isinstance(obj, (list, str)):
            return obj[int(key)]
        if isinstance(obj, _DocValuesView):
            return obj.get(key)
        raise ScriptError(f"cannot index {type(obj).__name__}")
    if kind == "call":
        return _call(e, env)
    raise ScriptError(f"cannot evaluate {kind}")


def _member(obj, name: str):  # noqa: C901
    if isinstance(obj, _LazyDoc):
        return obj.get(name)
    if obj == "__Math__":
        if name in _MATH_CONSTS:
            return _MATH_CONSTS[name]
        raise ScriptError(f"unknown Math member [{name}]")
    if isinstance(obj, dict):
        return obj.get(name)
    if isinstance(obj, _DocValuesView):
        if name == "value":
            return obj.value
        if name == "empty":
            return obj.empty
        if name == "length":
            return obj.length
        if name == "values":
            return obj.values
    if isinstance(obj, str) and name == "length":
        return len(obj)
    if isinstance(obj, list) and name == "length":
        return len(obj)     # Java array .length (splitOnToken results)
    raise ScriptError(f"unknown member [{name}] on {type(obj).__name__}")


def _call(e: tuple, env: HostEnv):  # noqa: C901
    _, obj_expr, name, arg_exprs = e
    if obj_expr == ("var", "Math"):
        fn = _MATH_FNS.get(name)
        if fn is None:
            raise ScriptError(f"unknown Math function [{name}]")
        return fn(*[_eval(a, env) for a in arg_exprs])
    obj = _eval(obj_expr, env)
    args = [_eval(a, env) for a in arg_exprs]
    if isinstance(obj, _DocValuesView):
        if name == "size":
            return obj.size()
        if name == "contains":
            return obj.contains(args[0])
        if name == "get":
            return obj.get(args[0])
        if name == "isEmpty":
            return obj.empty
    if isinstance(obj, _Stream):
        return obj.method(name, args)
    if isinstance(obj, str):
        return _str_method(obj, name, args)
    if isinstance(obj, list):
        return _list_method(obj, name, args)
    if isinstance(obj, dict):
        return _map_method(obj, name, args)
    if isinstance(obj, (int, float)):
        if name == "intValue":
            return int(obj)
        if name == "doubleValue" or name == "floatValue":
            return float(obj)
        if name == "longValue":
            return int(obj)
        if name == "toString":
            return _to_str(obj)
    raise ScriptError(f"unknown method [{name}] on {type(obj).__name__}")


def _str_method(s: str, name: str, args: list):  # noqa: C901
    if name == "contains":
        return args[0] in s
    if name == "startsWith":
        return s.startswith(args[0])
    if name == "endsWith":
        return s.endswith(args[0])
    if name == "toLowerCase":
        return s.lower()
    if name == "toUpperCase":
        return s.upper()
    if name == "trim":
        return s.strip()
    if name == "length":
        return len(s)
    if name == "substring":
        return s[int(args[0]):] if len(args) == 1 else s[int(args[0]): int(args[1])]
    if name == "replace":
        return s.replace(args[0], args[1])
    if name == "split":
        return re.split(args[0], s)
    if name == "splitOnToken":
        # Java limit = max number of RESULT pieces (Python maxsplit + 1)
        return s.split(args[0], int(args[1]) - 1) if len(args) == 2 \
            and int(args[1]) > 0 else s.split(args[0])
    if name == "indexOf":
        return s.find(args[0])
    if name == "equals":
        return s == args[0]
    if name == "equalsIgnoreCase":
        return s.lower() == str(args[0]).lower()
    if name == "isEmpty":
        return len(s) == 0
    if name == "charAt":
        return s[int(args[0])]
    if name == "toString":
        return s
    raise ScriptError(f"unknown String method [{name}]")


def _cmp_key(fn):
    """Painless comparator -> sort key. int() truncation matches Java's
    def-to-int cast of the comparator return."""
    import functools
    return functools.cmp_to_key(lambda a, b: int(fn(a, b)))


def _list_method(lst: list, name: str, args: list):  # noqa: C901
    if name == "add":
        if len(args) == 2:
            lst.insert(int(args[0]), args[1])
        else:
            lst.append(args[0])
        return None
    if name == "remove":
        v = args[0]
        if isinstance(v, int):
            return lst.pop(v)
        lst.remove(v)
        return None
    if name == "removeIf":
        keep = [x for x in lst if not _truthy(args[0](x))]
        changed = len(keep) != len(lst)
        lst[:] = keep
        return changed
    if name == "size":
        return len(lst)
    if name == "contains":
        return args[0] in lst
    if name == "get":
        return lst[int(args[0])]
    if name == "indexOf":
        return lst.index(args[0]) if args[0] in lst else -1
    if name == "isEmpty":
        return len(lst) == 0
    if name == "addAll":
        lst.extend(args[0])
        return None
    if name == "sort":
        if args and callable(args[0]):
            lst.sort(key=_cmp_key(args[0]))
        else:
            lst.sort()
        return None
    if name == "stream":
        return _Stream(list(lst))
    if name == "each":
        for x in list(lst):
            args[0](x)
        return None
    raise ScriptError(f"unknown List method [{name}]")


class _Stream:
    """Painless stream pipeline over a host list (the java.util.stream
    subset the reference's painless whitelist exposes; terminal ops
    materialize eagerly — scripts are bounded by MAX_LOOP_ITERS anyway)."""

    __slots__ = ("items",)

    def __init__(self, items):
        self.items = items

    def method(self, name, args):
        if name == "filter":
            return _Stream([x for x in self.items if _truthy(args[0](x))])
        if name == "map" or name == "mapToDouble" or name == "mapToInt" \
                or name == "mapToLong":
            out = [args[0](x) for x in self.items]
            if name == "mapToInt" or name == "mapToLong":
                out = [int(x) for x in out]
            elif name == "mapToDouble":
                out = [float(x) for x in out]
            return _Stream(out)
        if name == "sorted":
            if args and callable(args[0]):
                return _Stream(sorted(self.items, key=_cmp_key(args[0])))
            return _Stream(sorted(self.items))
        if name == "distinct":
            # equals()-based like Java (lists/maps compare by value):
            # O(n^2) contains scan for unhashables, set for primitives
            seen, out = set(), []
            for x in self.items:
                if isinstance(x, (int, float, str, bool, type(None))):
                    k = (type(x).__name__, x)
                    if k in seen:
                        continue
                    seen.add(k)
                elif x in out:
                    continue
                out.append(x)
            return _Stream(out)
        if name == "limit":
            return _Stream(self.items[: int(args[0])])
        if name == "skip":
            return _Stream(self.items[int(args[0]):])
        if name == "count":
            return len(self.items)
        if name == "sum":
            return sum(self.items)
        if name == "average":
            return (sum(self.items) / len(self.items)) if self.items else None
        if name == "min":
            return min(self.items) if self.items else None
        if name == "max":
            return max(self.items) if self.items else None
        if name == "anyMatch":
            return any(_truthy(args[0](x)) for x in self.items)
        if name == "allMatch":
            return all(_truthy(args[0](x)) for x in self.items)
        if name == "noneMatch":
            return not any(_truthy(args[0](x)) for x in self.items)
        if name == "forEach":
            for x in self.items:
                args[0](x)
            return None
        if name == "collect" or name == "toList":
            return list(self.items)
        if name == "findFirst" or name == "findAny":
            return self.items[0] if self.items else None
        raise ScriptError(f"unknown Stream method [{name}]")


def _map_method(m: dict, name: str, args: list):  # noqa: C901
    if name == "containsKey":
        return args[0] in m
    if name == "get":
        return m.get(args[0])
    if name == "getOrDefault":
        return m.get(args[0], args[1])
    if name == "put":
        prev = m.get(args[0])
        m[args[0]] = args[1]
        return prev
    if name == "remove":
        return m.pop(args[0], None)
    if name == "keySet":
        return list(m.keys())
    if name == "values":
        return list(m.values())
    if name == "size":
        return len(m)
    if name == "isEmpty":
        return len(m) == 0
    if name == "entrySet":
        return [{"key": k, "value": v} for k, v in m.items()]
    raise ScriptError(f"unknown Map method [{name}]")


# =====================================================================
# script contexts (host)
# =====================================================================

def run_update_script(source: str, params: Optional[dict], src: dict,
                      doc_meta: dict) -> Tuple[dict, str]:
    """Update-context: mutate ctx._source; ctx.op in {index,none,delete}
    (reference UpdateHelper.executeScriptedUpsert)."""
    ctx = {"_source": src, "op": "index", **doc_meta}
    execute(source, {"ctx": ctx, "params": params or {}})
    op = ctx.get("op", "index")
    if op == "noop":
        op = "none"
    if op not in ("index", "none", "delete", "create"):
        raise ScriptError(f"invalid ctx.op [{op}]")
    return ctx["_source"], op


def doc_view_for(seg, doc: int, field: str) -> _DocValuesView:
    """Build `doc['field']` for one stored doc from segment columns."""
    col = seg.numeric_cols.get(field)
    if col is not None:
        if col.present[doc]:
            v = col.values[doc]
            return _DocValuesView([float(v) if col.kind == "float" else int(v)])
        return _DocValuesView([])
    kcol = seg.keyword_cols.get(field)
    if kcol is not None:
        a, b = int(kcol.starts[doc]), int(kcol.starts[doc + 1])
        return _DocValuesView([kcol.vocab[o] for o in kcol.ords[a:b]])
    gcol = seg.geo_cols.get(field) if hasattr(seg, "geo_cols") else None
    if gcol is not None and gcol.present[doc]:
        return _DocValuesView([{"lat": float(gcol.lat[doc]),
                                "lon": float(gcol.lon[doc])}])
    return _DocValuesView([])


class _LazyDoc:
    """Lazy doc map: only referenced fields materialize views."""

    def __init__(self, seg, doc: int):
        self.seg = seg
        self.doc = doc
        self._cache: Dict[str, _DocValuesView] = {}

    def get(self, field):
        v = self._cache.get(field)
        if v is None:
            v = self._cache[field] = doc_view_for(self.seg, self.doc, field)
        return v

    def __contains__(self, field):
        return True


def run_field_script(source: str, params: Optional[dict], seg, doc: int,
                     score: Optional[float] = None,
                     extra: Optional[dict] = None) -> Any:
    """script_fields / script-sort / field-context evaluation for one doc."""
    variables: Dict[str, Any] = {"doc": _LazyDoc(seg, doc), "params": params or {},
                                 "_score": 0.0 if score is None else float(score)}
    ast = parse(source)
    if _references_source(ast):
        variables["_source"] = seg.sources[doc] if hasattr(seg, "sources") else {}
    if extra:
        variables.update(extra)
    return execute(ast, variables)


def _references_source(ast: tuple) -> bool:
    def walk(n) -> bool:
        if not isinstance(n, tuple) or not n:
            return False
        if n == ("var", "_source"):
            return True
        return any(walk(c) for c in n if isinstance(c, tuple))
    return walk(ast)




# =====================================================================
# device evaluator (torch ops) — score and filter contexts
# =====================================================================

def validate_device_script(source: str) -> tuple:
    """Parse + check the script is expressible over dense columns: decls,
    if-less expressions and a final return / expression. Returns the
    AST."""
    ast = parse(source)
    for st in ast[1]:
        if st[0] not in ("decl", "return", "exprstmt", "assign"):
            raise ScriptError(
                f"score scripts support expressions and `def` locals; "
                f"got a `{st[0]}` statement (use ternaries instead of if)")
    return ast


class DeviceEnv:
    """Bindings of the device evaluator on `device`: `columns[f]` is the
    f32 per-doc vector of doc['f'].value, `present[f]` its bool existence
    mask, `score` the f32 `_score` vector (None where the context has
    none), `params` f32 scalar tensors."""

    def __init__(self, device, columns: Dict[str, Any],
                 present: Dict[str, Any], score, params: Dict[str, Any],
                 ndocs: int):
        self.device = device
        self.columns = columns
        self.present = present
        self.score = score
        self.params = params
        self.ndocs = ndocs
        self.locals: Dict[str, Any] = {}


def eval_device(ast: tuple, env: DeviceEnv):
    """Evaluate the script over dense columns -> f32[ndocs] tensor."""
    result = None
    for st in ast[1]:
        if st[0] == "decl":
            env.locals[st[1]] = _dev_expr(st[2], env)
        elif st[0] == "assign":
            if st[2][0] != "var":
                raise ScriptError("device scripts only assign local variables")
            val = _dev_expr(st[3], env)
            if st[1] != "=":
                if st[2][1] not in env.locals:
                    raise ScriptError(f"unknown variable [{st[2][1]}]")
                val = _dev_binop(env, st[1][0], env.locals[st[2][1]], val)
            env.locals[st[2][1]] = val
        elif st[0] == "return":
            return _as_vec(_dev_expr(st[1], env), env)
        else:  # exprstmt
            result = _dev_expr(st[1], env)
    if result is None:
        raise ScriptError("script has no result expression")
    return _as_vec(result, env)


def _is_py(v) -> bool:
    return isinstance(v, (bool, int, float))


def _lift(v, env: DeviceEnv):
    """A Python number as jnp takes it into a function: an f32 scalar
    tensor (a bool stays bool); a tensor as it is."""
    if isinstance(v, bool):
        return torch.tensor(v, device=env.device)
    if _is_py(v):
        return torch.tensor(float(v), dtype=torch.float32, device=env.device)
    return v


def _as_vec(v, env: DeviceEnv):
    arr = _lift(v, env).to(torch.float32)
    if arr.dim() == 0:
        arr = arr.expand(env.ndocs).clone()
    return arr


def _as_bool(v, env: DeviceEnv):
    return _lift(v, env).to(torch.bool)


_DEV_MATH = ("log", "log10", "sqrt", "abs", "exp", "floor", "ceil", "round",
             "sin", "cos", "tan")


def _dev_binop(env: DeviceEnv, op: str, a, b):  # noqa: C901
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        if _is_py(a) and _is_py(b):
            return a / b
        # a scalar divisor as a tensor on the device: a division by a
        # host scalar may run as a multiply by its reciprocal
        return _lift(a, env) / _lift(b, env)
    if op == "%":
        # the reference's jnp.where(a < 0, -(|a| % |b|), |a| % |b|): a
        # remainder of magnitudes, signed as the dividend (Java's %)
        if _is_py(a) and _is_py(b) and isinstance(a, int) \
                and isinstance(b, int):
            r = abs(a) % abs(b)
            return -r if a < 0 else r
        ta, tb = _lift(a, env), _lift(b, env)
        r = torch.fmod(torch.abs(ta), torch.abs(tb))
        return torch.where(ta < 0, -r, r)
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    raise ScriptError(f"unsupported device operator {op}")


def _dev_expr(e: tuple, env: DeviceEnv):  # noqa: C901
    kind = e[0]
    if kind == "num":
        return e[1]
    if kind == "bool":
        return e[1]
    if kind == "null":
        return 0.0
    if kind == "var":
        name = e[1]
        if name == "_score":
            if env.score is None:
                raise ScriptError("_score unavailable in this context")
            return env.score
        if name in env.locals:
            return env.locals[name]
        raise ScriptError(f"unknown variable [{name}] in score script")
    if kind == "member":
        obj, name = e[1], e[2]
        if obj == ("var", "Math"):
            if name in _MATH_CONSTS:
                return _MATH_CONSTS[name]
            raise ScriptError(f"unknown Math member [{name}]")
        if obj == ("var", "params"):
            if name not in env.params:
                raise ScriptError(f"unknown param [{name}]")
            return env.params[name]
        dv = _dev_docvalues(obj, env)
        if dv is not None:
            col, present = dv
            if name == "value":
                return col
            if name == "empty":
                return ~present
            if name == "length":
                return present.to(torch.float32)
        raise ScriptError(f"unsupported member [{name}] in score script")
    if kind == "index":
        if e[1] == ("var", "params") and e[2][0] == "strlit":
            key = e[2][1]
            if key not in env.params:
                raise ScriptError(f"unknown param [{key}]")
            return env.params[key]
        raise ScriptError("only params['k'] / doc['f'].value indexing on device")
    if kind == "call":
        _, obj, name, args = e
        if obj == ("var", "Math"):
            vals = [_dev_expr(a, env) for a in args]
            if name in ("pow", "min", "max"):
                if len(vals) != 2:
                    raise ScriptError(f"Math.{name} takes 2 arguments")
                a, b = vals
                if isinstance(a, int) and isinstance(b, int) \
                        and not isinstance(a, bool) \
                        and not isinstance(b, bool) and name != "pow":
                    return min(a, b) if name == "min" else max(a, b)
                a, b = _lift(a, env), _lift(b, env)
                if name == "pow":
                    return torch.pow(a, b)
                return (torch.minimum if name == "min" else torch.maximum)(
                    a, b)
            if name not in _DEV_MATH:
                raise ScriptError(f"unknown Math function [{name}]")
            if len(vals) != 1:
                raise ScriptError(f"Math.{name} takes 1 argument")
            v = vals[0]
            if isinstance(v, int) and not isinstance(v, bool) \
                    and name in ("abs", "floor", "ceil", "round"):
                return abs(v) if name == "abs" else v
            return getattr(torch, name)(_lift(v, env))
        dv = _dev_docvalues(obj, env)
        if dv is not None:
            col, present = dv
            if name == "size":
                return present.to(torch.float32)
            if name == "isEmpty":
                return ~present
        raise ScriptError(f"unsupported call [{name}] in score script")
    if kind == "cond":
        c = _dev_expr(e[1], env)
        t = _dev_expr(e[2], env)
        f = _dev_expr(e[3], env)
        if _is_py(c) and _is_py(t) and _is_py(f):
            return t if c else f
        return torch.where(_as_bool(c, env), _lift(t, env), _lift(f, env))
    if kind == "un":
        v = _dev_expr(e[2], env)
        if e[1] == "!":
            return ~_as_bool(v, env)
        return -v
    if kind == "bin":
        op = e[1]
        if op in ("&&", "||"):
            a = _as_bool(_dev_expr(e[2], env), env)
            b = _as_bool(_dev_expr(e[3], env), env)
            return a & b if op == "&&" else a | b
        return _dev_binop(env, op, _dev_expr(e[2], env), _dev_expr(e[3], env))
    raise ScriptError(f"cannot trace {kind} on device")


def _dev_docvalues(obj: tuple, env: DeviceEnv):
    """Match doc['f'] / doc.f -> (values vector, present mask) or None."""
    field = None
    if obj[0] == "index" and obj[1] == ("var", "doc") and obj[2][0] == "strlit":
        field = obj[2][1]
    elif obj[0] == "member" and obj[1] == ("var", "doc"):
        field = obj[2]
    if field is None:
        return None
    if field not in env.columns:
        return (torch.zeros(env.ndocs, dtype=torch.float32,
                            device=env.device),
                torch.zeros(env.ndocs, dtype=torch.bool, device=env.device))
    return env.columns[field], env.present[field]
