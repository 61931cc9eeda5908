"""From-scratch Lua interpreter for object scripts.

A copy of ``substrata_tpu/scripting/lua.py``: importing any module of the
reference package loads jax, so the port keeps its own.

The reference runs object scripts marked with a leading ``--lua`` in a Luau
VM (shared/SubstrataLuaVM.cpp, shared/LuaScriptEvaluator.cpp; scripts are
detected by prefix in server/Server.cpp:551).  Luau is a Lua 5.1 dialect;
this module implements the Lua language itself — lexer, recursive-descent
parser and tree-walking evaluator — so Substrata Lua scripts run unmodified:

  * full statement set: local/global assignment (incl. multiple targets),
    if/elseif/else, while, repeat, numeric + generic for, nested functions
    and closures, methods (``function t:m()``), break, return, do blocks
  * expressions: operator precedence, short-circuit and/or, concat ``..``,
    length ``#``, varargs ``...``, multiple return values, method calls,
    table constructors (array / record / ``[k]=v`` forms)
  * tables with metatables: __index, __newindex, __call, __tostring, __len,
    __eq/__lt/__le, arithmetic/concat metamethods
  * stdlib subset: basic functions (print, type, pairs, ipairs, next,
    tostring, tonumber, select, rawget/rawset/rawequal/rawlen, pcall,
    error, assert, setmetatable, getmetatable, unpack), string (incl. Lua
    pattern matching for find/match/gmatch/gsub), table, math, os.time/clock
  * sandboxed: no io / load / require / dofile; an instruction budget
    bounds runaway scripts (ScriptBudgetExceeded), mirroring Luau's
    interrupt callback in the reference (SubstrataLuaVM.cpp ``interrupt``).

Numbers are doubles (Luau semantics); integral floats print without the
trailing ``.0`` as in Lua 5.1/Luau.
"""

from __future__ import annotations

import math
import re as _re


class LuaError(Exception):
    """Runtime error raised inside a script (``error()`` or a fault)."""

    def __init__(self, value, level=1, traceback=None):
        super().__init__(lua_tostring_basic(value))
        self.value = value


class LuaSyntaxError(LuaError):
    pass


class ScriptBudgetExceeded(LuaError):
    def __init__(self):
        super().__init__("script exceeded execution budget")


# ---------------------------------------------------------------------------
# Values
# ---------------------------------------------------------------------------

class LuaTable:
    __slots__ = ("hash", "metatable")

    def __init__(self, pairs=None):
        self.hash = {}
        self.metatable = None
        if pairs:
            for k, v in pairs:
                if v is not None and k is not None:
                    self.hash[norm_key(k)] = v

    def get(self, key):
        return self.hash.get(norm_key(key))

    def set(self, key, value):
        k = norm_key(key)
        if k is None:
            raise LuaError("table index is nil")
        if isinstance(k, float) and math.isnan(k):
            raise LuaError("table index is NaN")
        if value is None:
            self.hash.pop(k, None)
        else:
            self.hash[k] = value

    def length(self):
        # A border: n where t[n] ~= nil and t[n+1] == nil.
        n = 0
        while (n + 1) in self.hash:
            n += 1
        return float(n)

    def __repr__(self):
        return f"table: 0x{id(self):012x}"


class LuaFunction:
    __slots__ = ("params", "is_vararg", "body", "env", "name")

    def __init__(self, params, is_vararg, body, env, name="?"):
        self.params = params
        self.is_vararg = is_vararg
        self.body = body
        self.env = env
        self.name = name

    def __repr__(self):
        return f"function: 0x{id(self):012x}"


def norm_key(k):
    """Integral float keys normalise to int so t[1] and t[1.0] coincide."""
    if isinstance(k, float) and k.is_integer():
        return int(k)
    if isinstance(k, bool):
        return k
    return k


def lua_type_name(v):
    if v is None:
        return "nil"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, float) or isinstance(v, int):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, LuaTable):
        return "table"
    return "function"


def lua_tostring_basic(v):
    if v is None:
        return "nil"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        f = float(v)
        if math.isinf(f):
            return "inf" if f > 0 else "-inf"
        if math.isnan(f):
            return "nan"
        if f.is_integer() and abs(f) < 1e16:
            return str(int(f))
        return repr(f)
    if isinstance(v, str):
        return v
    return repr(v)


def truthy(v):
    return v is not None and v is not False


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_KEYWORDS = {
    "and", "break", "do", "else", "elseif", "end", "false", "for", "function",
    "if", "in", "local", "nil", "not", "or", "repeat", "return", "then",
    "true", "until", "while",
}

# Luau-dialect compound-assignment operators (SubstrataLuaVM.h:21-67: the
# reference runs scripts under Luau, not vanilla 5.1).
_COMPOUND_OPS = {"+=", "-=", "*=", "/=", "%=", "^=", "..="}
_TWO_CHAR = {"==", "~=", "<=", ">=", "..", "+=", "-=", "*=", "/=", "%=",
             "^=", "->"}
_THREE_CHAR = {"...", "..="}


class _Tok:
    __slots__ = ("kind", "value", "line")

    def __init__(self, kind, value, line):
        self.kind = kind      # name | number | string | op | keyword | eof
        self.value = value
        self.line = line

    def __repr__(self):
        return f"{self.kind}:{self.value!r}"


def _lex(src: str):
    toks = []
    i, n, line = 0, len(src), 1
    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        if src.startswith("--", i):
            if src.startswith("--[", i):
                # long comment --[=*[ ... ]=*]
                m = _re.match(r"--\[(=*)\[", src[i:])
                if m:
                    close = "]" + m.group(1) + "]"
                    end = src.find(close, i + m.end())
                    if end < 0:
                        raise LuaSyntaxError(f"unterminated long comment at line {line}")
                    line += src.count("\n", i, end)
                    i = end + len(close)
                    continue
            end = src.find("\n", i)
            i = n if end < 0 else end
            continue
        if c == "[" and i + 1 < n and src[i + 1] in "[=":
            m = _re.match(r"\[(=*)\[", src[i:])
            if m:
                close = "]" + m.group(1) + "]"
                start = i + m.end()
                if src.startswith("\n", start):
                    start += 1
                    line += 1
                end = src.find(close, start)
                if end < 0:
                    raise LuaSyntaxError(f"unterminated long string at line {line}")
                s = src[start:end]
                line += s.count("\n")
                toks.append(_Tok("string", s, line))
                i = end + len(close)
                continue
        if c in "'\"":
            j = i + 1
            buf = []
            while j < n and src[j] != c:
                ch = src[j]
                if ch == "\n":
                    raise LuaSyntaxError(f"unfinished string at line {line}")
                if ch == "\\":
                    j += 1
                    if j >= n:
                        raise LuaSyntaxError(f"unfinished string at line {line}")
                    e = src[j]
                    if e == "n":
                        buf.append("\n")
                    elif e == "t":
                        buf.append("\t")
                    elif e == "r":
                        buf.append("\r")
                    elif e == "a":
                        buf.append("\a")
                    elif e == "b":
                        buf.append("\b")
                    elif e == "f":
                        buf.append("\f")
                    elif e == "v":
                        buf.append("\v")
                    elif e == "\\":
                        buf.append("\\")
                    elif e == '"':
                        buf.append('"')
                    elif e == "'":
                        buf.append("'")
                    elif e == "\n":
                        buf.append("\n")
                        line += 1
                    elif e.isdigit():
                        num = e
                        while (len(num) < 3 and j + 1 < n and src[j + 1].isdigit()):
                            j += 1
                            num += src[j]
                        buf.append(chr(int(num)))
                    elif e == "x":
                        buf.append(chr(int(src[j + 1:j + 3], 16)))
                        j += 2
                    else:
                        raise LuaSyntaxError(
                            f"invalid escape '\\{e}' at line {line}")
                else:
                    buf.append(ch)
                j += 1
            if j >= n:
                raise LuaSyntaxError(f"unfinished string at line {line}")
            toks.append(_Tok("string", "".join(buf), line))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            m = _re.match(r"0[xX][0-9a-fA-F]+|\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?",
                          src[i:])
            text = m.group(0)
            if text.lower().startswith("0x"):
                toks.append(_Tok("number", float(int(text, 16)), line))
            else:
                toks.append(_Tok("number", float(text), line))
            i += len(text)
            continue
        if c.isalpha() or c == "_":
            m = _re.match(r"[A-Za-z_]\w*", src[i:])
            w = m.group(0)
            toks.append(_Tok("keyword" if w in _KEYWORDS else "name", w, line))
            i += len(w)
            continue
        if src[i:i + 3] in _THREE_CHAR:
            toks.append(_Tok("op", src[i:i + 3], line))
            i += 3
            continue
        if src[i:i + 2] in _TWO_CHAR:
            toks.append(_Tok("op", src[i:i + 2], line))
            i += 2
            continue
        if c == "`":
            # Luau interpolated string: `text {expr} text` (the reference's
            # scripts run under Luau, SubstrataLuaVM.h:21-67).  Token value
            # is a list of ("str", s) / ("expr", source_text) parts; the
            # parser compiles each expr part.
            parts = []
            buf = []
            j = i + 1
            while True:
                if j >= n:
                    raise LuaSyntaxError(
                        f"unfinished interpolated string at line {line}")
                ch = src[j]
                if ch == "`":
                    break
                if ch == "\\" and j + 1 < n:
                    e = src[j + 1]
                    rep = {"`": "`", "{": "{", "}": "}", "\\": "\\",
                           "n": "\n", "t": "\t", "r": "\r"}.get(e)
                    if rep is None:
                        raise LuaSyntaxError(
                            f"invalid escape '\\{e}' in interpolated string "
                            f"at line {line}")
                    buf.append(rep)
                    j += 2
                    continue
                if ch == "{":
                    if buf:
                        parts.append(("str", "".join(buf)))
                        buf = []
                    depth = 1
                    k = j + 1
                    while k < n and depth:
                        ck = src[k]
                        if ck in "'\"":            # skip quoted strings
                            q = ck
                            k += 1
                            while k < n and src[k] != q:
                                k += 2 if src[k] == "\\" else 1
                        elif ck == "{":
                            depth += 1
                        elif ck == "}":
                            depth -= 1
                            if depth == 0:
                                break
                        k += 1
                    if depth:
                        raise LuaSyntaxError(
                            f"unterminated interpolation at line {line}")
                    parts.append(("expr", src[j + 1:k]))
                    j = k + 1
                    continue
                if ch == "\n":
                    line += 1
                buf.append(ch)
                j += 1
            if buf or not parts:
                parts.append(("str", "".join(buf)))
            toks.append(_Tok("istring", parts, line))
            i = j + 1
            continue
        if c in "+-*/%^#<>=(){}[];:,.|&?":
            toks.append(_Tok("op", c, line))
            i += 1
            continue
        raise LuaSyntaxError(f"unexpected character {c!r} at line {line}")
    toks.append(_Tok("eof", None, line))
    return toks


# ---------------------------------------------------------------------------
# Parser -> tuple AST
#   Statements: ("local", names, exprs) ("assign", targets, exprs)
#     ("call_stmt", expr) ("if", [(cond, block)...], else_block)
#     ("while", cond, block) ("repeat", block, cond)
#     ("fornum", var, e1, e2, e3, block) ("forin", names, exprs, block)
#     ("func_stmt", target_expr, func) ("local_func", name, func)
#     ("return", exprs) ("break",) ("do", block)
#   Expressions: ("nil",) ("true",) ("false",) ("num", v) ("str", s)
#     ("vararg",) ("name", s) ("index", obj, key) ("call", f, args)
#     ("method", obj, name, args) ("func", params, is_vararg, body)
#     ("binop", op, l, r) ("unop", op, e) ("table", array_items, pairs)
#     ("and", l, r) ("or", l, r)
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def check(self, kind, value=None):
        t = self.peek()
        return t.kind == kind and (value is None or t.value == value)

    def accept(self, kind, value=None):
        if self.check(kind, value):
            return self.next()
        return None

    def expect(self, kind, value=None):
        t = self.next()
        if t.kind != kind or (value is not None and t.value != value):
            raise LuaSyntaxError(
                f"expected {value or kind}, got {t.value!r} at line {t.line}")
        return t

    # ---- blocks ----

    def parse_chunk(self):
        block = self.parse_block()
        self.expect("eof")
        return block

    _BLOCK_ENDERS = {"end", "else", "elseif", "until"}

    def parse_block(self):
        stmts = []
        while True:
            t = self.peek()
            if t.kind == "eof" or (t.kind == "keyword" and t.value in self._BLOCK_ENDERS):
                return stmts
            if t.kind == "keyword" and t.value == "return":
                self.next()
                exprs = []
                t2 = self.peek()
                if not (t2.kind == "eof"
                        or (t2.kind == "keyword" and t2.value in self._BLOCK_ENDERS)
                        or (t2.kind == "op" and t2.value == ";")):
                    exprs = self.parse_exprlist()
                self.accept("op", ";")
                stmts.append(("return", exprs))
                return stmts
            s = self.parse_statement()
            if s is not None:
                stmts.append(s)

    def parse_statement(self):
        t = self.peek()
        if t.kind == "op" and t.value == ";":
            self.next()
            return None
        if t.kind == "keyword":
            kw = t.value
            if kw == "local":
                self.next()
                if self.accept("keyword", "function"):
                    name = self.expect("name").value
                    fn = self.parse_funcbody(name)
                    return ("local_func", name, fn)
                names = [self.expect("name").value]
                if self.accept("op", ":"):
                    self._skip_type()          # Luau: local x : number = ...
                while self.accept("op", ","):
                    names.append(self.expect("name").value)
                    if self.accept("op", ":"):
                        self._skip_type()
                exprs = []
                if self.accept("op", "="):
                    exprs = self.parse_exprlist()
                return ("local", names, exprs)
            if kw == "if":
                self.next()
                arms = []
                cond = self.parse_expr()
                self.expect("keyword", "then")
                arms.append((cond, self.parse_block()))
                els = None
                while True:
                    if self.accept("keyword", "elseif"):
                        c = self.parse_expr()
                        self.expect("keyword", "then")
                        arms.append((c, self.parse_block()))
                    elif self.accept("keyword", "else"):
                        els = self.parse_block()
                        self.expect("keyword", "end")
                        break
                    else:
                        self.expect("keyword", "end")
                        break
                return ("if", arms, els)
            if kw == "while":
                self.next()
                cond = self.parse_expr()
                self.expect("keyword", "do")
                body = self.parse_block()
                self.expect("keyword", "end")
                return ("while", cond, body)
            if kw == "repeat":
                self.next()
                body = self.parse_block()
                self.expect("keyword", "until")
                cond = self.parse_expr()
                return ("repeat", body, cond)
            if kw == "for":
                self.next()
                name1 = self.expect("name").value
                if self.accept("op", ":"):
                    self._skip_type()          # Luau: for i : number = ...
                if self.accept("op", "="):
                    e1 = self.parse_expr()
                    self.expect("op", ",")
                    e2 = self.parse_expr()
                    e3 = None
                    if self.accept("op", ","):
                        e3 = self.parse_expr()
                    self.expect("keyword", "do")
                    body = self.parse_block()
                    self.expect("keyword", "end")
                    return ("fornum", name1, e1, e2, e3, body)
                names = [name1]
                while self.accept("op", ","):
                    names.append(self.expect("name").value)
                    if self.accept("op", ":"):
                        self._skip_type()
                self.expect("keyword", "in")
                exprs = self.parse_exprlist()
                self.expect("keyword", "do")
                body = self.parse_block()
                self.expect("keyword", "end")
                return ("forin", names, exprs, body)
            if kw == "function":
                self.next()
                # funcname: Name {"." Name} [":" Name]
                target = ("name", self.expect("name").value)
                is_method = False
                while True:
                    if self.accept("op", "."):
                        target = ("index", target, ("str", self.expect("name").value))
                    elif self.accept("op", ":"):
                        target = ("index", target, ("str", self.expect("name").value))
                        is_method = True
                        break
                    else:
                        break
                fn = self.parse_funcbody("method" if is_method else "fn",
                                         implicit_self=is_method)
                return ("func_stmt", target, fn)
            if kw == "do":
                self.next()
                body = self.parse_block()
                self.expect("keyword", "end")
                return ("do", body)
            if kw == "break":
                self.next()
                return ("break",)
            raise LuaSyntaxError(f"unexpected '{kw}' at line {t.line}")
        # Luau 'continue': a contextual keyword — a statement only when the
        # next token cannot extend it into an expression statement (so
        # 'continue = 5', 'continue()' and 'continue.x' still treat it as a
        # plain name, like Luau's parser does).
        if t.kind == "name" and t.value == "continue":
            nxt = self.toks[self.i + 1]
            extends = nxt.kind in ("string", "istring") or (
                nxt.kind == "op" and nxt.value in
                ("=", ",", "(", "[", ".", ":", "{") | _COMPOUND_OPS)
            if not extends:
                self.next()
                return ("continue",)
        # expression statement: call or assignment
        e = self.parse_prefix_expr()
        ct = self.peek()
        if ct.kind == "op" and ct.value in _COMPOUND_OPS:
            # Luau compound assignment: a op= b  ==>  a = a op b.
            # (Caveat vs real Luau: an index target's subexpressions
            # evaluate twice here; fine for the side-effect-free targets
            # real scripts use.)
            self.next()
            if e[0] not in ("name", "index"):
                raise LuaSyntaxError(
                    f"cannot compound-assign to this expression at line {ct.line}")
            rhs = self.parse_expr()
            return ("assign", [e], [("binop", ct.value[:-1], e, rhs)])
        if self.check("op", "=") or self.check("op", ","):
            targets = [e]
            while self.accept("op", ","):
                targets.append(self.parse_prefix_expr())
            self.expect("op", "=")
            exprs = self.parse_exprlist()
            for tgt in targets:
                if tgt[0] not in ("name", "index"):
                    raise LuaSyntaxError("cannot assign to this expression")
            return ("assign", targets, exprs)
        if e[0] not in ("call", "method"):
            raise LuaSyntaxError(f"syntax error near line {t.line}")
        return ("call_stmt", e)

    def parse_funcbody(self, name, implicit_self=False):
        self.expect("op", "(")
        params = ["self"] if implicit_self else []
        is_vararg = False
        if not self.check("op", ")"):
            while True:
                if self.accept("op", "..."):
                    is_vararg = True
                    if self.accept("op", ":"):
                        self._skip_type()
                    break
                params.append(self.expect("name").value)
                if self.accept("op", ":"):
                    self._skip_type()  # Luau: function f(av : Avatar, ...)
                if not self.accept("op", ","):
                    break
        self.expect("op", ")")
        if self.accept("op", ":"):
            self._skip_type()          # Luau return-type annotation
        body = self.parse_block()
        self.expect("keyword", "end")
        return ("func", params, is_vararg, body, name)

    # ---- Luau type annotations (type-erased: no runtime effect) ----

    def _skip_type(self):
        self._skip_type_prefix()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("|", "&"):
                self.next()
                self._skip_type_prefix()
            else:
                return

    def _skip_type_prefix(self):
        t = self.peek()
        if t.kind == "op" and t.value in ("{", "("):
            self._skip_balanced(t.value, {"{": "}", "(": ")"}[t.value])
            if self.accept("op", "->"):
                self._skip_type()      # function type (args) -> ret
        elif t.kind == "string":
            self.next()                # string-literal singleton type
        elif t.kind == "keyword" and t.value in ("nil", "true", "false"):
            self.next()
        elif t.kind == "name":
            self.next()
            while self.accept("op", "."):
                self.expect("name")
            if self.check("op", "<"):
                self._skip_balanced("<", ">")   # generic args
        else:
            raise LuaSyntaxError(f"bad type annotation at line {t.line}")
        while self.accept("op", "?"):
            pass

    def _skip_balanced(self, open_, close):
        depth = 0
        while True:
            t = self.next()
            if t.kind == "eof":
                raise LuaSyntaxError("unterminated type annotation")
            if t.kind == "op" and t.value == open_:
                depth += 1
            elif t.kind == "op" and t.value == close:
                depth -= 1
                if depth == 0:
                    return

    # ---- expressions (precedence climbing) ----

    _BIN_PREC = {
        "or": (1, 1), "and": (2, 2),
        "<": (3, 3), ">": (3, 3), "<=": (3, 3), ">=": (3, 3),
        "~=": (3, 3), "==": (3, 3),
        "..": (5, 4),          # right assoc
        "+": (6, 6), "-": (6, 6),
        "*": (7, 7), "/": (7, 7), "%": (7, 7),
        "^": (10, 9),          # right assoc
    }
    _UNARY_PREC = 8

    def parse_exprlist(self):
        out = [self.parse_expr()]
        while self.accept("op", ","):
            out.append(self.parse_expr())
        return out

    def parse_expr(self, limit=0):
        t = self.peek()
        if t.kind == "keyword" and t.value == "not":
            self.next()
            e = ("unop", "not", self.parse_expr(self._UNARY_PREC))
        elif t.kind == "op" and t.value == "-":
            self.next()
            e = ("unop", "-", self.parse_expr(self._UNARY_PREC))
        elif t.kind == "op" and t.value == "#":
            self.next()
            e = ("unop", "#", self.parse_expr(self._UNARY_PREC))
        else:
            e = self.parse_simple_expr()
        while True:
            t = self.peek()
            op = None
            if t.kind == "op" and t.value in self._BIN_PREC:
                op = t.value
            elif t.kind == "keyword" and t.value in ("and", "or"):
                op = t.value
            if op is None:
                return e
            left_prec, right_prec = self._BIN_PREC[op]
            if left_prec <= limit:
                return e
            self.next()
            rhs = self.parse_expr(right_prec)
            if op == "and":
                e = ("and", e, rhs)
            elif op == "or":
                e = ("or", e, rhs)
            else:
                e = ("binop", op, e, rhs)

    def parse_simple_expr(self):
        t = self.peek()
        if t.kind == "number":
            self.next()
            return ("num", t.value)
        if t.kind == "string":
            self.next()
            return ("str", t.value)
        if t.kind == "istring":
            # Luau interpolated string -> ("interp", [("str", s) |
            # ("val", expr_ast)]); each value part is tostring'd at eval.
            self.next()
            parts = []
            for kind, val in t.value:
                if kind == "str":
                    parts.append(("str", val))
                else:
                    sub = _Parser(_lex(val))
                    e = sub.parse_expr()
                    sub.expect("eof")
                    parts.append(("val", e))
            return ("interp", parts)
        if t.kind == "keyword":
            if t.value == "nil":
                self.next()
                return ("nil",)
            if t.value == "true":
                self.next()
                return ("true",)
            if t.value == "false":
                self.next()
                return ("false",)
            if t.value == "function":
                self.next()
                return self.parse_funcbody("anonymous")
        if t.kind == "op" and t.value == "...":
            self.next()
            return ("vararg",)
        if t.kind == "op" and t.value == "{":
            return self.parse_table()
        return self.parse_prefix_expr()

    def parse_prefix_expr(self):
        t = self.peek()
        if t.kind == "name":
            self.next()
            e = ("name", t.value)
        elif t.kind == "op" and t.value == "(":
            self.next()
            inner = self.parse_expr()
            self.expect("op", ")")
            e = ("paren", inner)
        else:
            raise LuaSyntaxError(f"unexpected {t.value!r} at line {t.line}")
        while True:
            t = self.peek()
            if t.kind == "op" and t.value == ".":
                self.next()
                e = ("index", e, ("str", self.expect("name").value))
            elif t.kind == "op" and t.value == "[":
                self.next()
                k = self.parse_expr()
                self.expect("op", "]")
                e = ("index", e, k)
            elif t.kind == "op" and t.value == ":":
                self.next()
                mname = self.expect("name").value
                args = self.parse_call_args()
                e = ("method", e, mname, args)
            elif (t.kind == "op" and t.value == "(") or t.kind == "string" \
                    or (t.kind == "op" and t.value == "{"):
                args = self.parse_call_args()
                e = ("call", e, args)
            else:
                return e

    def parse_call_args(self):
        t = self.peek()
        if t.kind == "string":
            self.next()
            return [("str", t.value)]
        if t.kind == "op" and t.value == "{":
            return [self.parse_table()]
        self.expect("op", "(")
        args = []
        if not self.check("op", ")"):
            args = self.parse_exprlist()
        self.expect("op", ")")
        return args

    def parse_table(self):
        self.expect("op", "{")
        array_items = []
        pairs = []
        while not self.check("op", "}"):
            t = self.peek()
            if t.kind == "op" and t.value == "[":
                self.next()
                k = self.parse_expr()
                self.expect("op", "]")
                self.expect("op", "=")
                pairs.append((k, self.parse_expr()))
            elif t.kind == "name" and self.toks[self.i + 1].kind == "op" \
                    and self.toks[self.i + 1].value == "=":
                self.next()
                self.next()
                pairs.append((("str", t.value), self.parse_expr()))
            else:
                array_items.append(self.parse_expr())
            if not (self.accept("op", ",") or self.accept("op", ";")):
                break
        self.expect("op", "}")
        return ("table", array_items, pairs)


def parse(src: str):
    return _Parser(_lex(src)).parse_chunk()


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------

class _Break(Exception):
    pass


class _Continue(Exception):
    """Luau 'continue' statement unwind."""
    pass


class _Return(Exception):
    def __init__(self, values):
        self.values = values


class _Env:
    __slots__ = ("vars", "parent")

    def __init__(self, parent=None):
        self.vars = {}
        self.parent = parent

    def lookup(self, name):
        e = self
        while e is not None:
            if name in e.vars:
                return e
            e = e.parent
        return None


class Interpreter:
    """One interpreter instance = one sandboxed global environment."""

    def __init__(self, budget: int = 1_000_000, output=None):
        self.globals = LuaTable()
        self.budget = budget
        self.ops = 0
        self.output = output if output is not None else []
        install_stdlib(self)

    # -- entry points --

    def run(self, src: str, chunk_name: str = "script"):
        ast = parse(src)
        env = _Env()
        try:
            self.exec_block(ast, env, varargs=[])
        except _Return as r:
            return r.values
        return []

    def call(self, fn, args):
        """Call a Lua (or Python) function value with a Python list of args."""
        return self.call_value(fn, list(args))

    def _tick(self):
        self.ops += 1
        if self.ops > self.budget:
            raise ScriptBudgetExceeded()

    # -- statements --

    def exec_block(self, block, env, varargs):
        for stmt in block:
            self.exec_stmt(stmt, env, varargs)

    def exec_stmt(self, stmt, env, varargs):
        self._tick()
        op = stmt[0]
        if op == "local":
            _, names, exprs = stmt
            vals = self.eval_exprlist(exprs, env, varargs, len(names))
            for name, v in zip(names, vals):
                env.vars[name] = v
        elif op == "assign":
            _, targets, exprs = stmt
            vals = self.eval_exprlist(exprs, env, varargs, len(targets))
            for tgt, v in zip(targets, vals):
                self.assign(tgt, v, env, varargs)
        elif op == "call_stmt":
            self.eval_multi(stmt[1], env, varargs)
        elif op == "if":
            _, arms, els = stmt
            for cond, body in arms:
                if truthy(self.eval(cond, env, varargs)):
                    self.exec_block(body, _Env(env), varargs)
                    return
            if els is not None:
                self.exec_block(els, _Env(env), varargs)
        elif op == "while":
            _, cond, body = stmt
            while truthy(self.eval(cond, env, varargs)):
                self._tick()
                try:
                    self.exec_block(body, _Env(env), varargs)
                except _Break:
                    break
                except _Continue:
                    pass
        elif op == "repeat":
            _, body, cond = stmt
            while True:
                self._tick()
                scope = _Env(env)
                try:
                    self.exec_block(body, scope, varargs)
                except _Break:
                    break
                except _Continue:
                    pass   # Luau: continue in repeat jumps to the until check
                # until condition sees the loop body's locals
                if truthy(self.eval(cond, scope, varargs)):
                    break
        elif op == "fornum":
            _, var, e1, e2, e3, body = stmt
            start = self.tonum(self.eval(e1, env, varargs), "'for' initial value")
            stop = self.tonum(self.eval(e2, env, varargs), "'for' limit")
            step = (self.tonum(self.eval(e3, env, varargs), "'for' step")
                    if e3 is not None else 1.0)
            if step == 0:
                raise LuaError("'for' step is zero")
            v = start
            while (v <= stop) if step > 0 else (v >= stop):
                self._tick()
                scope = _Env(env)
                scope.vars[var] = v
                try:
                    self.exec_block(body, scope, varargs)
                except _Break:
                    break
                except _Continue:
                    pass
                v += step
        elif op == "forin":
            _, names, exprs, body = stmt
            vals = self.eval_exprlist(exprs, env, varargs, 3)
            f, s, ctrl = vals[0], vals[1], vals[2]
            if isinstance(f, LuaTable):
                # Luau generalised iteration: `for k, v in t do` iterates
                # the table directly (array part in order, then hash keys)
                # — used by the reference's example corpus
                # (example_luau_scripts.htmlfrag race script).
                it = f.metatable.get("__iter") if f.metatable else None
                if it is not None:
                    rets = self.call_value(it, [f])
                    f = rets[0] if rets else None
                    s = rets[1] if len(rets) > 1 else None
                    ctrl = rets[2] if len(rets) > 2 else None
                else:
                    n_arr = int(f.length())
                    arr_keys = set(range(1, n_arr + 1))

                    def _luak(k):
                        return (float(k) if isinstance(k, int)
                                and not isinstance(k, bool) else k)

                    items = ([(float(i), f.hash[i])
                              for i in range(1, n_arr + 1)]
                             + [(_luak(k), v) for k, v in f.hash.items()
                                if not (isinstance(k, int)
                                        and not isinstance(k, bool)
                                        and k in arr_keys)])
                    for k, v in items:
                        self._tick()
                        scope = _Env(env)
                        pair = (k, v)
                        for j, name in enumerate(names):
                            scope.vars[name] = pair[j] if j < 2 else None
                        try:
                            self.exec_block(body, scope, varargs)
                        except _Break:
                            return
                        except _Continue:
                            pass
                    return
            while True:
                self._tick()
                rets = self.call_value(f, [s, ctrl])
                if not rets or rets[0] is None:
                    break
                ctrl = rets[0]
                scope = _Env(env)
                for j, name in enumerate(names):
                    scope.vars[name] = rets[j] if j < len(rets) else None
                try:
                    self.exec_block(body, scope, varargs)
                except _Break:
                    break
                except _Continue:
                    pass
        elif op == "func_stmt":
            _, target, fnexpr = stmt
            fn = self.eval(fnexpr, env, varargs)
            self.assign(target, fn, env, varargs)
        elif op == "local_func":
            _, name, fnexpr = stmt
            env.vars[name] = None   # visible to itself (recursion)
            env.vars[name] = self.eval(fnexpr, env, varargs)
        elif op == "return":
            raise _Return(self.eval_exprlist(stmt[1], env, varargs, -1))
        elif op == "break":
            raise _Break()
        elif op == "continue":
            raise _Continue()
        elif op == "do":
            self.exec_block(stmt[1], _Env(env), varargs)
        else:                                         # pragma: no cover
            raise LuaError(f"bad statement {op}")

    def assign(self, target, value, env, varargs):
        if target[0] == "name":
            name = target[1]
            scope = env.lookup(name)
            if scope is not None:
                scope.vars[name] = value
            else:
                self.globals.set(name, value)
        elif target[0] == "index":
            obj = self.eval(target[1], env, varargs)
            key = self.eval(target[2], env, varargs)
            self.setindex(obj, key, value)
        else:
            raise LuaError("cannot assign")

    # -- expressions --

    def eval_exprlist(self, exprs, env, varargs, want):
        """Evaluate an expression list with Lua multi-value semantics: the
        LAST expression expands (call / varargs), earlier ones truncate.
        want=-1 returns everything."""
        vals = []
        for j, e in enumerate(exprs):
            if j == len(exprs) - 1:
                vals.extend(self.eval_multi(e, env, varargs))
            else:
                vals.append(self.eval(e, env, varargs))
        if want >= 0:
            while len(vals) < want:
                vals.append(None)
            vals = vals[:want]
        return vals

    def eval_multi(self, e, env, varargs):
        """Evaluate in multi-value context -> python list."""
        if e[0] == "call":
            fn = self.eval(e[1], env, varargs)
            args = self.eval_exprlist(e[2], env, varargs, -1)
            return self.call_value(fn, args)
        if e[0] == "method":
            obj = self.eval(e[1], env, varargs)
            fn = self.getindex(obj, e[2])
            args = [obj] + self.eval_exprlist(e[3], env, varargs, -1)
            return self.call_value(fn, args)
        if e[0] == "vararg":
            return list(varargs)
        return [self.eval(e, env, varargs)]

    def eval(self, e, env, varargs):
        self._tick()
        op = e[0]
        if op == "num":
            return e[1]
        if op == "str":
            return e[1]
        if op == "nil":
            return None
        if op == "true":
            return True
        if op == "false":
            return False
        if op == "name":
            scope = env.lookup(e[1])
            if scope is not None:
                return scope.vars[e[1]]
            return self.globals.get(e[1])
        if op == "paren":
            return self.eval(e[1], env, varargs)
        if op == "index":
            obj = self.eval(e[1], env, varargs)
            key = self.eval(e[2], env, varargs)
            return self.getindex(obj, key)
        if op in ("call", "method", "vararg"):
            vals = self.eval_multi(e, env, varargs)
            return vals[0] if vals else None
        if op == "func":
            _, params, is_vararg, body, name = e
            return LuaFunction(params, is_vararg, body, env, name)
        if op == "and":
            left = self.eval(e[1], env, varargs)
            if not truthy(left):
                return left
            return self.eval(e[2], env, varargs)
        if op == "or":
            left = self.eval(e[1], env, varargs)
            if truthy(left):
                return left
            return self.eval(e[2], env, varargs)
        if op == "unop":
            return self.unop(e[1], self.eval(e[2], env, varargs))
        if op == "binop":
            left = self.eval(e[2], env, varargs)
            right = self.eval(e[3], env, varargs)
            return self.binop(e[1], left, right)
        if op == "interp":
            # Luau interpolated string: tostring each value part (respects
            # __tostring, like Luau's string interpolation).
            out = []
            for kind, val in e[1]:
                out.append(val if kind == "str"
                           else self.tostring(self.eval(val, env, varargs)))
            return "".join(out)
        if op == "table":
            _, array_items, pairs = e
            t = LuaTable()
            idx = 1
            for j, item in enumerate(array_items):
                if j == len(array_items) - 1:
                    for v in self.eval_multi(item, env, varargs):
                        if v is not None:
                            t.hash[idx] = v
                        idx += 1
                else:
                    v = self.eval(item, env, varargs)
                    if v is not None:
                        t.hash[idx] = v
                    idx += 1
            for kexpr, vexpr in pairs:
                k = self.eval(kexpr, env, varargs)
                v = self.eval(vexpr, env, varargs)
                if k is not None and v is not None:
                    t.set(k, v)
            return t
        raise LuaError(f"bad expression {op}")          # pragma: no cover

    # -- operations --

    def call_value(self, fn, args):
        self._tick()
        if isinstance(fn, LuaFunction):
            env = _Env(fn.env)
            np_ = len(fn.params)
            for j, p in enumerate(fn.params):
                env.vars[p] = args[j] if j < len(args) else None
            va = args[np_:] if fn.is_vararg else []
            try:
                self.exec_block(fn.body, env, va)
            except _Return as r:
                return r.values
            return []
        if callable(fn):
            out = fn(self, args)
            if out is None:
                return []
            if isinstance(out, list):
                return out
            return [out]
        if isinstance(fn, LuaTable) and fn.metatable is not None:
            call_mm = fn.metatable.get("__call")
            if call_mm is not None:
                return self.call_value(call_mm, [fn] + args)
        raise LuaError(f"attempt to call a {lua_type_name(fn)} value")

    def getindex(self, obj, key):
        if isinstance(obj, LuaTable):
            v = obj.get(key)
            if v is not None:
                return v
            if obj.metatable is not None:
                mm = obj.metatable.get("__index")
                if isinstance(mm, LuaTable):
                    return self.getindex(mm, key)
                if mm is not None:
                    out = self.call_value(mm, [obj, key])
                    return out[0] if out else None
            return None
        if isinstance(obj, str):
            strlib = self.globals.get("string")
            return strlib.get(key) if strlib is not None else None
        raise LuaError(f"attempt to index a {lua_type_name(obj)} value")

    def setindex(self, obj, key, value):
        if isinstance(obj, LuaTable):
            if obj.get(key) is None and obj.metatable is not None:
                mm = obj.metatable.get("__newindex")
                if isinstance(mm, LuaTable):
                    return self.setindex(mm, key, value)
                if mm is not None:
                    self.call_value(mm, [obj, key, value])
                    return
            obj.set(key, value)
            return
        raise LuaError(f"attempt to index a {lua_type_name(obj)} value")

    def tonum(self, v, what="value"):
        if isinstance(v, bool):
            raise LuaError(f"{what} must be a number")
        if isinstance(v, (int, float)):
            return float(v)
        if isinstance(v, str):
            try:
                return float(int(v, 16)) if v.strip().lower().startswith("0x") \
                    else float(v)
            except ValueError:
                pass
        raise LuaError(f"{what} must be a number")

    def _arith_mm(self, op, a, b, mm_name):
        for operand in (a, b):
            if isinstance(operand, LuaTable) and operand.metatable is not None:
                mm = operand.metatable.get(mm_name)
                if mm is not None:
                    out = self.call_value(mm, [a, b])
                    return out[0] if out else None
        raise LuaError(
            f"attempt to perform arithmetic ({op}) on a "
            f"{lua_type_name(a if not isinstance(a, (int, float)) else b)} value")

    def binop(self, op, a, b):
        if op in ("+", "-", "*", "/", "%", "^"):
            an = a if isinstance(a, (int, float)) and not isinstance(a, bool) else None
            bn = b if isinstance(b, (int, float)) and not isinstance(b, bool) else None
            if isinstance(a, str):
                try:
                    an = self.tonum(a)
                except LuaError:
                    an = None
            if isinstance(b, str):
                try:
                    bn = self.tonum(b)
                except LuaError:
                    bn = None
            if an is None or bn is None:
                return self._arith_mm(op, a, b, {
                    "+": "__add", "-": "__sub", "*": "__mul", "/": "__div",
                    "%": "__mod", "^": "__pow"}[op])
            an, bn = float(an), float(bn)
            if op == "+":
                return an + bn
            if op == "-":
                return an - bn
            if op == "*":
                return an * bn
            if op == "/":
                if bn == 0.0:
                    return math.inf if an > 0 else (-math.inf if an < 0 else math.nan)
                return an / bn
            if op == "%":
                if bn == 0.0:
                    return math.nan
                return an - math.floor(an / bn) * bn
            if op == "^":
                return an ** bn
        if op == "..":
            if isinstance(a, (int, float, str)) and not isinstance(a, bool) \
                    and isinstance(b, (int, float, str)) and not isinstance(b, bool):
                return lua_tostring_basic(a) + lua_tostring_basic(b)
            return self._arith_mm(op, a, b, "__concat")
        if op == "==":
            return self._eq(a, b)
        if op == "~=":
            return not self._eq(a, b)
        if op in ("<", "<=", ">", ">="):
            if op == ">":
                return self.binop("<", b, a)
            if op == ">=":
                return self.binop("<=", b, a)
            num_a = isinstance(a, (int, float)) and not isinstance(a, bool)
            num_b = isinstance(b, (int, float)) and not isinstance(b, bool)
            if num_a and num_b:
                return a < b if op == "<" else a <= b
            if isinstance(a, str) and isinstance(b, str):
                return a < b if op == "<" else a <= b
            mm_name = "__lt" if op == "<" else "__le"
            for operand in (a, b):
                if isinstance(operand, LuaTable) and operand.metatable is not None:
                    mm = operand.metatable.get(mm_name)
                    if mm is not None:
                        out = self.call_value(mm, [a, b])
                        return truthy(out[0] if out else None)
            raise LuaError(
                f"attempt to compare {lua_type_name(a)} with {lua_type_name(b)}")
        raise LuaError(f"bad operator {op}")            # pragma: no cover

    def _eq(self, a, b):
        if isinstance(a, bool) or isinstance(b, bool):
            return a is b
        if isinstance(a, (int, float)) and isinstance(b, (int, float)):
            return float(a) == float(b)
        if a is b:
            return True
        if type(a) is not type(b):
            return False
        if isinstance(a, str):
            return a == b
        if isinstance(a, LuaTable) and isinstance(b, LuaTable):
            for operand in (a, b):
                if operand.metatable is not None:
                    mm = operand.metatable.get("__eq")
                    if mm is not None:
                        out = self.call_value(mm, [a, b])
                        return truthy(out[0] if out else None)
        return False

    def unop(self, op, v):
        if op == "-":
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                return -float(v)
            if isinstance(v, str):
                return -self.tonum(v)
            if isinstance(v, LuaTable) and v.metatable is not None:
                mm = v.metatable.get("__unm")
                if mm is not None:
                    out = self.call_value(mm, [v, v])
                    return out[0] if out else None
            raise LuaError(
                f"attempt to perform arithmetic (unm) on a {lua_type_name(v)} value")
        if op == "not":
            return not truthy(v)
        if op == "#":
            if isinstance(v, str):
                return float(len(v))
            if isinstance(v, LuaTable):
                if v.metatable is not None:
                    mm = v.metatable.get("__len")
                    if mm is not None:
                        out = self.call_value(mm, [v])
                        return out[0] if out else None
                return v.length()
            raise LuaError(f"attempt to get length of a {lua_type_name(v)} value")
        raise LuaError(f"bad unop {op}")                # pragma: no cover

    def tostring(self, v):
        if isinstance(v, LuaTable) and v.metatable is not None:
            mm = v.metatable.get("__tostring")
            if mm is not None:
                out = self.call_value(mm, [v])
                return out[0] if out else ""
        return lua_tostring_basic(v)


# ---------------------------------------------------------------------------
# Lua pattern -> python regex translation (string.find/match/gmatch/gsub)
# ---------------------------------------------------------------------------

_CLASS_MAP = {
    "a": "[a-zA-Z]", "A": "[^a-zA-Z]",
    "d": r"\d", "D": r"\D",
    "l": "[a-z]", "L": "[^a-z]",
    "s": r"\s", "S": r"\S",
    "u": "[A-Z]", "U": "[^A-Z]",
    "w": "[a-zA-Z0-9]", "W": "[^a-zA-Z0-9]",
    "x": "[0-9a-fA-F]", "X": "[^0-9a-fA-F]",
    "p": r"[!-/:-@\[-`{-~]", "P": r"[^!-/:-@\[-`{-~]",
    "c": r"[\x00-\x1f]", "C": r"[^\x00-\x1f]",
}


def _lua_class_to_re(c, in_set):
    if c in _CLASS_MAP:
        r = _CLASS_MAP[c]
        if in_set and r.startswith("[") and not r.startswith("[^"):
            return r[1:-1]
        if in_set and r.startswith(("\\",)):
            return r
        if in_set and r.startswith("[^"):
            raise LuaError("complement class not supported inside set")
        return r
    return _re.escape(c)


def lua_pattern_to_re(pat: str) -> str:
    out = []
    i, n = 0, len(pat)
    if pat.startswith("^"):
        out.append("^")
        i = 1
    while i < n:
        c = pat[i]
        if c == "%":
            i += 1
            if i >= n:
                raise LuaError("malformed pattern (ends with '%')")
            nc = pat[i]
            if nc.isdigit():
                out.append("\\" + nc)       # back-reference
            elif nc == "b":
                raise LuaError("%b not supported")
            elif nc == "f":
                # frontier pattern %f[set]: lookbehind/ahead approximation
                raise LuaError("%f not supported")
            else:
                out.append(_lua_class_to_re(nc, False))
            i += 1
        elif c == "[":
            j = i + 1
            neg = False
            if j < n and pat[j] == "^":
                neg = True
                j += 1
            items = []
            first = True
            while j < n and (pat[j] != "]" or first):
                first = False
                if pat[j] == "%" and j + 1 < n:
                    items.append(_lua_class_to_re(pat[j + 1], True))
                    j += 2
                elif j + 2 < n and pat[j + 1] == "-" and pat[j + 2] != "]":
                    items.append(_re.escape(pat[j]) + "-" + _re.escape(pat[j + 2]))
                    j += 3
                else:
                    ch = pat[j]
                    items.append("\\" + ch if ch in "\\^]" else _re.escape(ch))
                    j += 1
            if j >= n:
                raise LuaError("malformed pattern (missing ']')")
            out.append("[" + ("^" if neg else "") + "".join(items) + "]")
            i = j + 1
        elif c == ".":
            out.append(".")
            i += 1
        elif c in "()":
            # Lua position capture "()" -> unsupported; plain captures map 1:1
            if c == "(" and i + 1 < n and pat[i + 1] == ")":
                raise LuaError("position capture not supported")
            out.append(c)
            i += 1
        elif c == "-":
            out.append("*?")        # Lua's lazy star
            i += 1
        elif c in "*+?":
            out.append(c)
            i += 1
        elif c == "$" and i == n - 1:
            out.append("$")
            i += 1
        else:
            out.append(_re.escape(c))
            i += 1
    return "".join(out)


# ---------------------------------------------------------------------------
# Standard library
# ---------------------------------------------------------------------------

def _arg(args, i, default=None):
    return args[i] if i < len(args) else default


def install_stdlib(interp: Interpreter):
    G = interp.globals

    def reg(name, fn):
        G.set(name, fn)

    reg("_G", G)
    reg("_VERSION", "Lua 5.1 (substrata-tpu)")

    def _print(ip, args):
        ip.output.append("\t".join(ip.tostring(a) for a in args))
    reg("print", _print)

    reg("type", lambda ip, a: lua_type_name(_arg(a, 0)))
    reg("tostring", lambda ip, a: ip.tostring(_arg(a, 0)))

    def _tonumber(ip, args):
        v = _arg(args, 0)
        base = _arg(args, 1)
        if base is not None:
            try:
                return float(int(str(v).strip(), int(base)))
            except (ValueError, TypeError):
                return None
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
        if isinstance(v, str):
            s = v.strip()
            try:
                if s.lower().startswith(("0x", "-0x")):
                    return float(int(s, 16))
                return float(s)
            except ValueError:
                return None
        return None
    reg("tonumber", _tonumber)

    def _ipairs_iter(ip, args):
        t, i = args[0], args[1] + 1
        v = t.get(i)
        if v is None:
            return [None]
        return [i, v]

    def _ipairs(ip, args):
        return [_ipairs_iter, args[0], 0.0]
    reg("ipairs", _ipairs)

    def _next(ip, args):
        t = _arg(args, 0)
        if not isinstance(t, LuaTable):
            raise LuaError("bad argument #1 to 'next' (table expected)")
        keys = list(t.hash.keys())
        k = _arg(args, 1)
        if k is None:
            if not keys:
                return [None]
            k0 = keys[0]
            return [float(k0) if isinstance(k0, int) else k0, t.hash[k0]]
        nk = norm_key(k)
        try:
            idx = keys.index(nk)
        except ValueError:
            raise LuaError("invalid key to 'next'")
        if idx + 1 >= len(keys):
            return [None]
        k1 = keys[idx + 1]
        return [float(k1) if isinstance(k1, int) else k1, t.hash[k1]]
    reg("next", _next)

    def _pairs(ip, args):
        t = _arg(args, 0)
        if isinstance(t, LuaTable) and t.metatable is not None:
            mm = t.metatable.get("__pairs")
            if mm is not None:
                return ip.call_value(mm, [t])
        return [_next, t, None]
    reg("pairs", _pairs)

    def _select(ip, args):
        n = _arg(args, 0)
        rest = args[1:]
        if n == "#":
            return float(len(rest))
        n = int(ip.tonum(n))
        if n < 0:
            n = len(rest) + n + 1
        return list(rest[n - 1:])
    reg("select", _select)

    def _rawget(ip, args):
        return args[0].get(args[1])
    reg("rawget", _rawget)

    def _rawset(ip, args):
        args[0].set(args[1], args[2])
        return args[0]
    reg("rawset", _rawset)

    def _rawequal(ip, args):
        a, b = _arg(args, 0), _arg(args, 1)
        if isinstance(a, (int, float)) and isinstance(b, (int, float)) \
                and not isinstance(a, bool) and not isinstance(b, bool):
            return float(a) == float(b)
        return a is b or a == b if isinstance(a, str) else a is b
    reg("rawequal", _rawequal)

    def _rawlen(ip, args):
        v = _arg(args, 0)
        if isinstance(v, str):
            return float(len(v))
        return v.length()
    reg("rawlen", _rawlen)

    def _setmetatable(ip, args):
        t, mt = _arg(args, 0), _arg(args, 1)
        if not isinstance(t, LuaTable):
            raise LuaError("bad argument #1 to 'setmetatable' (table expected)")
        t.metatable = mt
        return t
    reg("setmetatable", _setmetatable)

    def _getmetatable(ip, args):
        t = _arg(args, 0)
        if isinstance(t, LuaTable) and t.metatable is not None:
            mt = t.metatable
            protected = mt.get("__metatable")
            return protected if protected is not None else mt
        return None
    reg("getmetatable", _getmetatable)

    def _pcall(ip, args):
        fn = _arg(args, 0)
        try:
            out = ip.call_value(fn, list(args[1:]))
            return [True] + out
        except ScriptBudgetExceeded:
            raise
        except LuaError as e:
            return [False, e.value]
        except ZeroDivisionError:
            return [False, "attempt to divide by zero"]
    reg("pcall", _pcall)

    def _xpcall(ip, args):
        fn, handler = _arg(args, 0), _arg(args, 1)
        try:
            out = ip.call_value(fn, list(args[2:]))
            return [True] + out
        except ScriptBudgetExceeded:
            raise
        except LuaError as e:
            h = ip.call_value(handler, [e.value])
            return [False] + h
    reg("xpcall", _xpcall)

    def _error(ip, args):
        v = _arg(args, 0)
        level = _arg(args, 1, 1.0)
        if isinstance(v, str) and level and level > 0:
            v = "script: " + v
        raise LuaError(v)
    reg("error", _error)

    def _assert(ip, args):
        if not truthy(_arg(args, 0)):
            msg = _arg(args, 1, "assertion failed!")
            raise LuaError(msg)
        return list(args)
    reg("assert", _assert)

    def _unpack(ip, args):
        t = _arg(args, 0)
        i = int(_arg(args, 1, 1.0))
        j = int(_arg(args, 2) if _arg(args, 2) is not None else t.length())
        return [t.get(float(k)) for k in range(i, j + 1)]
    reg("unpack", _unpack)

    # ---- string ----
    s = LuaTable()
    G.set("string", s)

    def _norm_i(i, ln, default):
        if i is None:
            i = default
        i = int(i)
        if i < 0:
            i = max(ln + i + 1, 1)
        elif i == 0:
            i = 1
        return i

    def _str_sub(ip, args):
        st = args[0]
        ln = len(st)
        i = _norm_i(_arg(args, 1, 1.0), ln, 1)
        j = _arg(args, 2)
        j = int(j) if j is not None else -1
        if j < 0:
            j = ln + j + 1
        j = min(j, ln)
        if i > j:
            return ""
        return st[i - 1:j]
    s.set("sub", _str_sub)
    s.set("len", lambda ip, a: float(len(a[0])))
    s.set("upper", lambda ip, a: a[0].upper())
    s.set("lower", lambda ip, a: a[0].lower())
    s.set("rep", lambda ip, a: a[0] * int(a[1]) if a[1] >= 1 else "")
    s.set("reverse", lambda ip, a: a[0][::-1])

    def _str_byte(ip, args):
        st = args[0]
        i = int(_arg(args, 1, 1.0))
        j = int(_arg(args, 2, float(i)))
        return [float(ord(c)) for c in st[i - 1:j]]
    s.set("byte", _str_byte)

    def _str_char(ip, args):
        return "".join(chr(int(a)) for a in args)
    s.set("char", _str_char)

    def _str_format(ip, args):
        fmt = args[0]
        out = []
        ai = 1
        i = 0
        while i < len(fmt):
            c = fmt[i]
            if c != "%":
                out.append(c)
                i += 1
                continue
            m = _re.match(r"%%[-+ #0]*\d*(?:\.\d+)?[diouxXeEfgGqscln%%]",
                          fmt[i:].replace("%%", "%%", 1))
            m = _re.match(r"%[-+ #0]*\d*(?:\.\d+)?[diouxXeEfgGqscl%]", fmt[i:])
            if not m:
                raise LuaError(f"invalid format string near {fmt[i:i+4]!r}")
            spec = m.group(0)
            conv = spec[-1]
            if conv == "%":
                out.append("%")
            elif conv == "q":
                v = ip.tostring(args[ai]); ai += 1
                out.append('"' + v.replace("\\", "\\\\").replace('"', '\\"')
                           .replace("\n", "\\n") + '"')
            elif conv == "s":
                v = ip.tostring(_arg(args, ai)); ai += 1
                out.append(spec % v)
            elif conv in "diouxX":
                v = int(ip.tonum(_arg(args, ai))); ai += 1
                out.append(spec.replace("i", "d") % v)
            else:
                v = ip.tonum(_arg(args, ai)); ai += 1
                out.append(spec % v)
            i += len(spec)
        return "".join(out)
    s.set("format", _str_format)

    def _compiled(pat):
        return _re.compile(lua_pattern_to_re(pat), _re.DOTALL)

    def _groups_or_whole(m):
        if m.groups():
            return [g if g is not None else None for g in m.groups()]
        return [m.group(0)]

    def _str_find(ip, args):
        st, pat = args[0], args[1]
        init = _norm_i(_arg(args, 2, 1.0), len(st), 1) - 1
        plain = truthy(_arg(args, 3))
        if plain:
            idx = st.find(pat, init)
            if idx < 0:
                return [None]
            return [float(idx + 1), float(idx + len(pat))]
        m = _compiled(pat).search(st, init)
        if not m:
            return [None]
        caps = list(m.groups()) if m.groups() else []
        return [float(m.start() + 1), float(m.end())] + caps
    s.set("find", _str_find)

    def _str_match(ip, args):
        st, pat = args[0], args[1]
        init = _norm_i(_arg(args, 2, 1.0), len(st), 1) - 1
        m = _compiled(pat).search(st, init)
        if not m:
            return [None]
        return _groups_or_whole(m)
    s.set("match", _str_match)

    def _str_gmatch(ip, args):
        st, pat = args[0], args[1]
        it = _compiled(pat).finditer(st)

        def step(ip2, _a):
            for m in it:
                return _groups_or_whole(m)
            return [None]
        return [step]
    s.set("gmatch", _str_gmatch)

    def _str_gsub(ip, args):
        st, pat, repl = args[0], args[1], args[2]
        max_n = _arg(args, 3)
        max_n = int(max_n) if max_n is not None else -1
        rx = _compiled(pat)
        count = 0
        out = []
        pos = 0
        while pos <= len(st):
            if max_n >= 0 and count >= max_n:
                break
            m = rx.search(st, pos)
            if not m:
                break
            out.append(st[pos:m.start()])
            whole = m.group(0)
            caps = _groups_or_whole(m)
            if isinstance(repl, str):
                def sub_cap(mm):
                    d = mm.group(0)[1]
                    if d == "0":
                        return whole
                    if d == "%":
                        return "%"
                    gi = int(d)
                    return caps[gi - 1] if gi - 1 < len(caps) and caps[gi - 1] is not None else ""
                out.append(_re.sub(r"%[%0-9]", sub_cap, repl))
            elif isinstance(repl, LuaTable):
                v = repl.get(caps[0])
                out.append(ip.tostring(v) if truthy(v) else whole)
            else:
                rv = ip.call_value(repl, caps)
                v = rv[0] if rv else None
                out.append(ip.tostring(v) if truthy(v) else whole)
            count += 1
            pos = m.end() if m.end() > m.start() else m.start() + 1
            if m.end() == m.start() and m.start() < len(st):
                out.append(st[m.start()])
        out.append(st[pos:])
        return ["".join(out), float(count)]
    s.set("gsub", _str_gsub)

    # ---- table ----
    tl = LuaTable()
    G.set("table", tl)

    def _tbl_insert(ip, args):
        t = args[0]
        if len(args) >= 3:
            pos = int(args[1])
            v = args[2]
            n = int(t.length())
            for k in range(n, pos - 1, -1):
                t.hash[k + 1] = t.hash[k]
            t.set(float(pos), v)
        else:
            t.set(t.length() + 1, args[1])
    tl.set("insert", _tbl_insert)

    def _tbl_remove(ip, args):
        t = args[0]
        n = int(t.length())
        pos = int(_arg(args, 1, float(n)))
        if n == 0:
            return None
        v = t.get(float(pos))
        for k in range(pos, n):
            t.hash[k] = t.hash[k + 1]
        t.hash.pop(n, None)
        return v
    tl.set("remove", _tbl_remove)

    def _tbl_concat(ip, args):
        t = args[0]
        sep = _arg(args, 1, "")
        i = int(_arg(args, 2, 1.0))
        j = int(_arg(args, 3) if _arg(args, 3) is not None else t.length())
        return sep.join(lua_tostring_basic(t.get(float(k)))
                        for k in range(i, j + 1))
    tl.set("concat", _tbl_concat)

    def _tbl_sort(ip, args):
        t = args[0]
        comp = _arg(args, 1)
        n = int(t.length())
        items = [t.hash[k] for k in range(1, n + 1)]
        if comp is None:
            items.sort(key=lambda v: (0, float(v)) if isinstance(v, (int, float))
                       else (1, v))
        else:
            import functools

            def cmp(a, b):
                out = ip.call_value(comp, [a, b])
                if truthy(out[0] if out else None):
                    return -1
                out2 = ip.call_value(comp, [b, a])
                if truthy(out2[0] if out2 else None):
                    return 1
                return 0
            items.sort(key=functools.cmp_to_key(cmp))
        for k, v in enumerate(items):
            t.hash[k + 1] = v
    tl.set("sort", _tbl_sort)
    tl.set("unpack", _unpack)
    tl.set("getn", lambda ip, a: a[0].length())

    # ---- math ----
    m = LuaTable()
    G.set("math", m)
    m.set("pi", math.pi)
    m.set("huge", math.inf)
    m.set("maxinteger", float(2**53))
    m.set("mininteger", float(-(2**53)))
    for name, fn in [
        ("abs", abs), ("ceil", math.ceil), ("floor", math.floor),
        ("sqrt", math.sqrt), ("sin", math.sin), ("cos", math.cos),
        ("tan", math.tan), ("asin", math.asin), ("acos", math.acos),
        ("exp", math.exp), ("rad", math.radians), ("deg", math.degrees),
    ]:
        m.set(name, (lambda f: lambda ip, a: float(f(ip.tonum(a[0]))))(fn))

    def _atan(ip, args):
        y = ip.tonum(args[0])
        x = ip.tonum(_arg(args, 1, 1.0))
        return math.atan2(y, x)
    m.set("atan", _atan)
    m.set("atan2", _atan)

    def _log(ip, args):
        x = ip.tonum(args[0])
        base = _arg(args, 1)
        return math.log(x, ip.tonum(base)) if base is not None else math.log(x)
    m.set("log", _log)

    def _fmod(ip, args):
        return math.fmod(ip.tonum(args[0]), ip.tonum(args[1]))
    m.set("fmod", _fmod)

    def _modf(ip, args):
        frac, whole = math.modf(ip.tonum(args[0]))
        return [whole, frac]
    m.set("modf", _modf)

    def _max(ip, args):
        return max(ip.tonum(a) for a in args)
    m.set("max", _max)

    def _min(ip, args):
        return min(ip.tonum(a) for a in args)
    m.set("min", _min)

    import random as _random
    rng = _random.Random(0)

    def _mrandom(ip, args):
        if not args:
            return rng.random()
        if len(args) == 1:
            return float(rng.randint(1, int(args[0])))
        return float(rng.randint(int(args[0]), int(args[1])))
    m.set("random", _mrandom)
    m.set("randomseed", lambda ip, a: rng.seed(a[0] if a else 0))

    # ---- os (safe subset) ----
    o = LuaTable()
    G.set("os", o)
    import time as _time
    o.set("time", lambda ip, a: float(int(_time.time())))
    o.set("clock", lambda ip, a: float(_time.process_time()))
    o.set("date", lambda ip, a: _time.strftime(
        (a[0].lstrip("*!") if a and isinstance(a[0], str) else "%c")))
