"""Batched object animation scripts: the Winter language on the card.

Counterpart of ``substrata_tpu/scripting/winter.py`` (program K16 of
ROADMAP.md queue 2).  The lexer, the AST, the parser and ``_Program``'s
validation and lookup are copies of the reference's, so the same sources
parse to the same trees and the same ``WinterParseError`` messages.  The
evaluation moves from jnp tracing to ``scripting/lower.py``: each source's
two hooks are lowered once to an instruction list over typed scalar
registers, which kernel KR (``kernels/winter.py``, ``csrc/winter.cu``)
runs for every instance of every source of a call in one launch, and
whose plain twin runs it on the CPU.

``WinterScriptEvaluator`` and ``ObjectScriptsEvaluator`` keep the
reference's surface and outputs (axis-angle rotation and translation
[..., 3] float32, the pow2 buckets, programs cached by (source, bucket));
they return torch tensors and run on the card unless ``device="cpu"``
is asked for.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

from substrata_tpu_torch.device import resolve_device
from substrata_tpu_torch.kernels import winter as kwinter
from substrata_tpu_torch.scripting.lower import WinterParseError, lower

# ---------------------------------------------------------------- lexer

_TOKEN_RE = re.compile(r"""
    (?P<ws>[\s]+)
  | (?P<comment>\#[^\n]*)
  | (?P<float>(?:\d+\.\d*|\.\d+)(?:[eE][+-]?\d+)?f?|\d+[eE][+-]?\d+f?|\d+f)
  | (?P<int>\d+)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>==|!=|<=|>=|&&|\|\||[-+*/%<>=(),:.\[\]{}!])
""", re.VERBOSE)

_KEYWORDS = {"def", "let", "in", "struct", "true", "false"}


@dataclass
class _Tok:
    kind: str   # 'float' | 'int' | 'ident' | 'op' | 'kw' | 'eof'
    text: str
    pos: int


def _tokenize(src: str) -> list[_Tok]:
    toks, i = [], 0
    while i < len(src):
        m = _TOKEN_RE.match(src, i)
        if m is None:
            raise WinterParseError(f"bad character {src[i]!r} at offset {i}")
        i = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        text = m.group()
        if kind == "ident" and text in _KEYWORDS:
            kind = "kw"
        toks.append(_Tok(kind, text, m.start()))
    toks.append(_Tok("eof", "", len(src)))
    return toks


# ---------------------------------------------------------------- AST

@dataclass
class _Num:
    value: float
    is_int: bool

@dataclass
class _Bool:
    value: bool

@dataclass
class _Var:
    name: str

@dataclass
class _Call:
    name: str
    args: list

@dataclass
class _Field:
    base: object
    name: str

@dataclass
class _BinOp:
    op: str
    left: object
    right: object

@dataclass
class _UnaryOp:
    op: str
    operand: object

@dataclass
class _Let:
    bindings: list          # [(name, expr), ...]
    body: object

@dataclass
class _VecLit:
    elems: list             # [expr, ...]; `[a,b,c]v` / `[a,b,c]vec3`

@dataclass
class _FuncDef:
    name: str
    params: list            # [(type, name), ...]
    body: object

@dataclass
class _StructDef:
    name: str
    fields: list            # [name, ...]


class _Parser:
    """Recursive-descent parser for the Winter surface above."""

    def __init__(self, toks: list[_Tok]):
        self.toks = toks
        self.i = 0

    def peek(self) -> _Tok:
        return self.toks[self.i]

    def next(self) -> _Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind: str, text: str | None = None) -> _Tok:
        t = self.next()
        if t.kind != kind or (text is not None and t.text != text):
            raise WinterParseError(
                f"expected {text or kind}, got {t.text!r} at offset {t.pos}")
        return t

    def at(self, kind: str, text: str | None = None) -> bool:
        t = self.peek()
        return t.kind == kind and (text is None or t.text == text)

    # ---- top level: a sequence of struct and def items
    def parse_program(self) -> list:
        items = []
        while not self.at("eof"):
            if self.at("kw", "struct"):
                items.append(self.parse_struct())
            elif self.at("kw", "def"):
                items.append(self.parse_def())
            else:
                t = self.peek()
                raise WinterParseError(
                    f"expected 'def' or 'struct', got {t.text!r} at {t.pos}")
        return items

    def parse_struct(self) -> _StructDef:
        self.expect("kw", "struct")
        name = self.expect("ident").text
        self.expect("op", "{")
        fields = []
        while not self.at("op", "}"):
            self._parse_type()                       # field type (ignored)
            fields.append(self.expect("ident").text)
            if self.at("op", ","):
                self.next()
        self.expect("op", "}")
        return _StructDef(name, fields)

    def _parse_type(self):
        """Consume a type name, incl. generics like vector<real, 4>."""
        self.expect("ident")
        if self.at("op", "<"):
            depth = 0
            while True:
                t = self.next()
                if t.kind == "op" and t.text == "<":
                    depth += 1
                elif t.kind == "op" and t.text == ">":
                    depth -= 1
                    if depth == 0:
                        break
                elif t.kind == "eof":
                    raise WinterParseError("unterminated generic type")

    def parse_def(self) -> _FuncDef:
        self.expect("kw", "def")
        name = self.expect("ident").text
        self.expect("op", "(")
        params = []
        while not self.at("op", ")"):
            tname = self.expect("ident").text          # param type
            if self.at("op", "<"):                     # generic param type
                self.i -= 1
                self._parse_type()
                tname = "vector"
            pname = self.expect("ident").text
            params.append((tname, pname))
            if self.at("op", ","):
                self.next()
        self.expect("op", ")")
        if self.at("ident"):                           # optional return type
            self._parse_type()
        self.expect("op", ":")
        body = self.parse_expr()
        return _FuncDef(name, params, body)

    # ---- expressions, lowest precedence first
    def parse_expr(self):
        if self.at("kw", "let"):
            return self.parse_let()
        return self.parse_or()

    def parse_let(self) -> _Let:
        self.expect("kw", "let")
        bindings = []
        while not self.at("kw", "in"):
            # optional type annotation: `let real x = ...` / `let x = ...`
            name = self.expect("ident").text
            if self.at("ident"):                       # first ident was a type
                name = self.expect("ident").text
            self.expect("op", "=")
            bindings.append((name, self.parse_or()))
        self.expect("kw", "in")
        body = self.parse_expr()
        return _Let(bindings, body)

    def parse_or(self):
        left = self.parse_and()
        while self.at("op", "||"):
            self.next()
            left = _BinOp("||", left, self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_cmp()
        while self.at("op", "&&"):
            self.next()
            left = _BinOp("&&", left, self.parse_cmp())
        return left

    def parse_cmp(self):
        left = self.parse_add()
        while self.peek().kind == "op" and self.peek().text in (
                "==", "!=", "<", "<=", ">", ">="):
            op = self.next().text
            left = _BinOp(op, left, self.parse_add())
        return left

    def parse_add(self):
        left = self.parse_mul()
        while self.peek().kind == "op" and self.peek().text in ("+", "-"):
            op = self.next().text
            left = _BinOp(op, left, self.parse_mul())
        return left

    def parse_mul(self):
        left = self.parse_unary()
        while self.peek().kind == "op" and self.peek().text in ("*", "/", "%"):
            op = self.next().text
            left = _BinOp(op, left, self.parse_unary())
        return left

    def parse_unary(self):
        if self.at("op", "-"):
            self.next()
            return _UnaryOp("-", self.parse_unary())
        if self.at("op", "!"):
            self.next()
            return _UnaryOp("!", self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self):
        e = self.parse_primary()
        while True:
            if self.at("op", "."):
                self.next()
                e = _Field(e, self.expect("ident").text)
            elif self.at("op", "["):                   # index: v[i] (const)
                self.next()
                idx = self.parse_expr()
                self.expect("op", "]")
                e = _Call("__index", [e, idx])
            else:
                return e

    def parse_primary(self):
        t = self.peek()
        if t.kind == "float":
            self.next()
            return _Num(float(t.text.rstrip("f")), is_int=False)
        if t.kind == "int":
            self.next()
            return _Num(int(t.text), is_int=True)
        if t.kind == "kw" and t.text in ("true", "false"):
            self.next()
            return _Bool(t.text == "true")
        if t.kind == "op" and t.text == "(":
            self.next()
            e = self.parse_expr()
            self.expect("op", ")")
            return e
        if t.kind == "op" and t.text == "[":           # vector literal
            self.next()
            elems = []
            while not self.at("op", "]"):
                elems.append(self.parse_expr())
                if self.at("op", ","):
                    self.next()
            self.expect("op", "]")
            # suffix: `v`, `vec3`, `vec4`... (required by Winter; we accept
            # its absence too)
            if self.at("ident") and self.peek().text in (
                    "v", "vec2", "vec3", "vec4"):
                self.next()
            return _VecLit(elems)
        if t.kind == "ident":
            self.next()
            if self.at("op", "("):
                self.next()
                args = []
                while not self.at("op", ")"):
                    args.append(self.parse_expr())
                    if self.at("op", ","):
                        self.next()
                self.expect("op", ")")
                return _Call(t.text, args)
            return _Var(t.text)
        raise WinterParseError(f"unexpected token {t.text!r} at offset {t.pos}")


# Names the reference's _BUILTINS table defines (winter.py:488-548):
# validation accepts a call to any of them.
_BUILTINS = frozenset((
    "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "sqrt", "abs", "exp", "log",
    "floor", "ceil", "pow", "mod", "min", "max", "fract", "clamp", "lerp", "step",
    "smoothstep", "smootherstep", "pulse", "toFloat", "real", "toInt", "truncateToInt",
    "floorToInt", "ceilToInt", "neg", "recip", "pi", "if", "vec2", "vec3", "vec4",
    "x", "y", "z", "w", "e0", "e1", "e2", "e3", "doti", "dotj", "dotk", "dot", "cross",
    "length", "length2", "dist", "normalise", "normalize", "and", "or", "not", "xor",
    "noise", "noise01", "fbm", "__index", "add", "sub", "mul", "div", "lt", "lte", "gt",
    "gte", "eq", "neq"))


class _Program:
    """Parsed script: user defs (by name) + struct defs."""

    def __init__(self, src: str):
        items = _Parser(_tokenize(src)).parse_program()
        self.funcs: dict[str, list[_FuncDef]] = {}
        self.structs: dict[str, _StructDef] = {}
        for it in items:
            if isinstance(it, _FuncDef):
                self.funcs.setdefault(it.name, []).append(it)
            else:
                self.structs[it.name] = it
        for fns in self.funcs.values():
            for f in fns:
                self._validate(f.body, {n for _t, n in f.params})

    def _validate(self, node, bound: set):
        """Parse-time name resolution: every call target and variable must be
        a builtin, user def, struct, or bound name — rejects injection
        attempts (and typos) before any evaluation happens."""
        if isinstance(node, _Var):
            if node.name not in bound:
                raise WinterParseError(f"unknown name {node.name!r}")
        elif isinstance(node, _Call):
            if (node.name not in _BUILTINS and node.name not in self.funcs
                    and node.name not in self.structs):
                raise WinterParseError(f"call to {node.name!r} not allowed")
            for a in node.args:
                self._validate(a, bound)
        elif isinstance(node, _Let):
            inner = set(bound)
            for name, expr in node.bindings:
                self._validate(expr, inner)
                inner.add(name)
            self._validate(node.body, inner)
        elif isinstance(node, _BinOp):
            self._validate(node.left, bound)
            self._validate(node.right, bound)
        elif isinstance(node, _UnaryOp):
            self._validate(node.operand, bound)
        elif isinstance(node, _Field):
            self._validate(node.base, bound)
        elif isinstance(node, _VecLit):
            for e in node.elems:
                self._validate(e, bound)

    def lookup(self, name: str, nargs: int) -> _FuncDef | None:
        for f in self.funcs.get(name, ()):
            if len(f.params) == nargs:
                return f
        return None


def _as_tensor(x, dtype, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), device=device).to(dtype)


class WinterScriptEvaluator:
    """Per-script evaluator (WinterShaderEvaluator parity:
    gui_client/WinterShaderEvaluator.h:38-50).  The source is lowered at
    first use; a script that parses but cannot be evaluated raises
    WinterParseError then, as the reference's trace does."""

    def __init__(self, src: str, device="cuda"):
        self.src = src
        self.device = resolve_device(device)
        self.program = _Program(src)
        self.has_rotation = self.program.lookup("evalRotation", 2) is not None
        self.has_translation = (
            self.program.lookup("evalTranslation", 2) is not None)
        if not (self.has_rotation or self.has_translation):
            raise WinterParseError(
                "script defines neither evalRotation nor evalTranslation")
        self._code = None

    def code(self):
        """(instruction list int32 [n, 5], register count), lowered once."""
        if self._code is None:
            low = lower(self.program)
            self._code = (low.code, low.n_regs)
        return self._code

    def batch(self, n: int) -> kwinter.Batch:
        """This script's program over ``n`` instances, for ``winter_eval``."""
        code, n_regs = self.code()
        return kwinter.Batch([code], [n_regs], [(0, n)], self.device)

    def evaluate(self, time, instance_index=0.0, num_instances=1.0) -> torch.Tensor:
        """Both hooks at once: [..., 6] (axis-angle, translation)."""
        t = _as_tensor(time, torch.float32, self.device)
        idx = _as_tensor(instance_index, torch.float32, self.device)
        n = _as_tensor(num_instances, torch.float32, self.device)
        shape = torch.broadcast_shapes(t.shape, idx.shape, n.shape)
        # As the reference: the env fields are int32 (a float index truncates).
        t, idx, n = (x.expand(shape).reshape(-1) for x in (t, idx, n))
        out = kwinter.winter_eval(self.batch(t.shape[0]), t.contiguous(),
                                  kwinter.to_int32(idx), kwinter.to_int32(n))
        return out.reshape(shape + (6,))

    def eval_rotation(self, time, instance_index=0.0, num_instances=1.0):
        """Axis*angle vector [..., 3]."""
        return self.evaluate(time, instance_index, num_instances)[..., :3]

    def eval_translation(self, time, instance_index=0.0, num_instances=1.0):
        return self.evaluate(time, instance_index, num_instances)[..., 3:]


@dataclass
class ScriptedObject:
    evaluator: WinterScriptEvaluator
    world_object: object
    num_instances: int = 1


def _bucket(n: int) -> int:
    """Pad batch sizes to pow2 buckets (min 8) so adding/removing scripted
    objects reuses compiled programs instead of recompiling per count."""
    b = 8
    while b < n:
        b *= 2
    return b


class ObjectScriptsEvaluator:
    """Evaluate every scripted object at one global time, batched by script
    source (replacing the task-group parallel eval, Scripting.cpp:735-880).

    Every source group goes into ONE launch of kernel KR (one segment per
    group, padded to its pow2 bucket) and comes back in ONE device -> host
    copy.  Programs are cached by (source, bucket) as the reference caches
    its jitted ones (``_jitted``)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.scripted: list[ScriptedObject] = []
        self._evaluators: dict[str, WinterScriptEvaluator] = {}
        self._jitted: dict[tuple[str, int], tuple] = {}

    def add(self, ob, src: str, num_instances: int = 1):
        ev = self._evaluators.get(src)
        if ev is None:
            ev = self._evaluators[src] = WinterScriptEvaluator(src, device=self.device)
        self.scripted.append(ScriptedObject(ev, ob, num_instances))

    def remove(self, ob):
        self.scripted = [s for s in self.scripted if s.world_object is not ob]

    def _get_jitted(self, src: str, bucket: int):
        key = (src, bucket)
        fn = self._jitted.get(key)
        if fn is None:
            fn = self._jitted[key] = self._evaluators[src].code()
        return fn

    def evaluate(self, global_time: float):
        """Returns list of (world_object, axis_angle [n,3], translation [n,3])
        numpy arrays in add order — the WinterScriptEvalOutput equivalent
        (Scripting.h:199-206)."""
        by_src: dict[str, list[ScriptedObject]] = {}
        for s in self.scripted:
            by_src.setdefault(s.evaluator.src, []).append(s)
        if not by_src:
            return []
        codes, n_regs, segments, idx, n_inst, spans = [], [], [], [], [], []
        o = 0
        for src, group in by_src.items():
            counts = [max(s.num_instances, 1) for s in group]
            bucket = _bucket(sum(counts))
            code, regs = self._get_jitted(src, bucket)
            codes.append(code)
            n_regs.append(regs)
            segments.append((o, bucket))
            gi = np.zeros(bucket, np.int32)
            gn = np.ones(bucket, np.int32)
            p = 0
            for s, c in zip(group, counts):
                gi[p:p + c] = np.arange(c)
                gn[p:p + c] = c
                spans.append((s, o + p, c))
                p += c
            idx.append(gi)
            n_inst.append(gn)
            o += bucket
        dev = self.device
        out = kwinter.winter_eval(
            kwinter.Batch(codes, n_regs, segments, dev),
            torch.full((o,), float(np.float32(global_time)), dtype=torch.float32, device=dev),
            torch.as_tensor(np.concatenate(idx), device=dev),
            torch.as_tensor(np.concatenate(n_inst), device=dev)).cpu().numpy()
        results = {id(s): (s.world_object, out[a:a + c, :3], out[a:a + c, 3:])
                   for s, a, c in spans}
        return [results[id(s)] for s in self.scripted]
