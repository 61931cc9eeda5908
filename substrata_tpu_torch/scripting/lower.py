"""Lowering of a Winter program's evalRotation / evalTranslation hooks to
straight-line code over typed scalar registers (K16's instruction list).

The reference traces each hook with jnp under ``jax.jit``
(substrata_tpu/scripting/winter.py:656-718, jitted at :820); XLA then
fuses the whole evaluation into loops and rounds it its own way.  This
module repeats that evaluation once per source, on the host, and writes
it out as instructions that the plain twin (``kernels/winter.py``) and
kernel KR (``csrc/winter.cu``) both execute, one instance per lane:

- user functions are inlined (call depth limit 64, as the reference's);
  ``let`` bindings, struct fields and the N components of a ``vecN``
  become registers (a struct is a compile-time map from field to value);
- ``if`` is a select with both branches computed, as ``jnp.where`` is;
  ``fbm`` takes 4 octaves, as the jitted ``_fbm`` does with a traced
  octave count (under ``jax.jit`` a literal is a tracer too);
- types follow jnp's promotion: float32 beside any int or bool is
  float32, int / int is float32, ``%`` is ``jnp.mod`` (floor modulo;
  ``x % 0`` is 0 for ints), a vector beside a scalar takes the scalar as
  float32, a float -> int conversion saturates (NaN -> 0), and
  ``v[i]`` with i out of [-N, N) is NaN (``jnp.take``'s fill mode;
  negative indices count from the end).

**Rounding.**  Under ``jax.jit`` even a literal is traced, so the whole
hook is one XLA program; a value that depends on neither ``time`` nor
``env`` is folded here in float32 (int32 with wraparound) op by op, with
no fusion, as XLA's constant folding does.  The rest repeats XLA's
rounding, as measured against the jitted reference
(tests/test_torch_winter.py):

1. ``x / c`` with a constant c is ``x * fl(1/c)`` (XLA's algebraic
   simplifier), a constant x too; division by a traced value divides.
   ``(x * c1) * c2`` is ``x * fl(c1 c2)``, ``(x + c1) + c2`` is
   ``x + fl(c1 + c2)`` and ``x - c`` is ``x + (-c)`` (constants
   reassociate); ``x + 0`` and ``x * 1`` are x.
2. A float multiply that an add or a subtract uses is fused with it into
   one rounding when the product has exactly one use in its region, as
   LLVM contracts XLA's fused loop: ``fadd(fmul(a, b), c)`` ->
   ``fma(a, b, c)``, ``fsub(fmul(a, b), c)`` -> ``fma(a, b, -c)``,
   ``fsub(c, fmul(a, b))`` -> ``fma(-a, b, c)``; when both operands of an
   add are single-use products, the one LLVM's Reassociate pass puts on
   the left is fused: the lower rank (constants 0, each input its own
   rank in order of first use, an op one above its highest operand).  A
   region is one output
   component (each component of the stacked [B, 3] results is emitted on
   its own, so a product shared by two components is fused in each), or
   one reduction: ``dot`` and friends are ``fma(a2, b2, fma(a1, b1,
   a0 b0))``, with their operands counted in their own region.
3. Transcendentals are the device's (torch's on the CPU, CUDA's precise
   ``sinf``... in KR); they differ from XLA's by an ulp or two.

``lower(program)`` returns a ``Lowered``: the int32 [n, 5] instruction
list ``(op, dst, a, b, c)``, the register count (registers are reused
once dead), and nothing else: the six results leave through ``out``
instructions (columns 0-2 the axis-angle rotation, 3-5 the translation).
Registers 0, 1 and 2 hold time (f32), the instance index and the
instance count (i32) on entry.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

MAX_CALL_DEPTH = 64

# Op codes, shared with csrc/winter.cu (tests/test_torch_winter.py checks
# the two tables agree).  Operand and result types are implied by the op.
OPS = (
    "constf", "consti", "constb",
    "fadd", "fsub", "fmul", "fdiv", "ffma", "fneg", "fabs", "ffloor", "fceil", "ftrunc",
    "fsqrt", "fsin", "fcos", "ftan", "fasin", "facos", "fatan", "fatan2", "fexp", "flog",
    "fpow", "fmod", "fmin", "fmax",
    "iadd", "isub", "imul", "imod", "ineg", "iabs", "imin", "imax",
    "i2f", "f2i", "b2i", "b2f", "f2b", "i2b",
    "flt", "fle", "feq", "fne", "ilt", "ile", "ieq", "ine",
    "and", "or", "xor", "not", "sel", "out",
)
OP = {name: code for code, name in enumerate(OPS)}
N_INPUTS = 3          # time, instance index, instance count
N_OUT = 6             # rotation xyz, translation xyz

_F, _I, _B = "f", "i", "b"
_NP = {_F: np.float32, _I: np.int32, _B: np.bool_}
_REDUCE = ("dot",)    # nodes emitted in a region of their own


class WinterParseError(Exception):
    pass


# ---------------------------------------------------------------- the DAG

@dataclasses.dataclass(eq=False)
class Node:
    """One scalar value: an op over child nodes, a folded constant
    (``op == "const"``, ``imm`` a numpy scalar) or an input."""

    op: str
    ty: str
    args: tuple = ()
    imm: object = None


class Vec:
    """A vecN: N scalar nodes of one type."""

    __slots__ = ("comps",)

    def __init__(self, comps):
        self.comps = list(comps)

    @property
    def n(self):
        return len(self.comps)


def _is_const(x):
    return isinstance(x, Node) and x.op == "const"


def _f32_to_i32(v):
    """float32 -> int32 as XLA converts: truncate, saturate, NaN -> 0."""
    v = float(v)
    if math.isnan(v):
        return np.int32(0)
    if v >= 2147483648.0:
        return np.int32(2147483647)
    if v <= -2147483649.0:
        return np.int32(-2147483648)
    return np.int32(math.trunc(v))


def _fmod(x, y):
    """jnp.mod on floats: fmod, moved into the divisor's sign."""
    r = np.fmod(x, y)
    if r != 0 and ((r < 0) != (y < 0)):
        r = np.float32(r + y)
    return np.float32(r)


def _imod(x, y):
    """jnp.mod on int32 (XLA: x % 0 == 0, INT_MIN % -1 == 0)."""
    x, y = int(x), int(y)
    if y == 0 or y == -1:
        return np.int32(0)
    r = int(math.fmod(x, y))
    if r != 0 and ((r < 0) != (y < 0)):
        r += y
    return np.int32(r)


def _wrap(v):
    return np.int32(((int(v) + (1 << 31)) % (1 << 32)) - (1 << 31))


_FOLD_F1 = {"fneg": np.negative, "fabs": np.abs, "ffloor": np.floor, "fceil": np.ceil,
            "ftrunc": np.trunc, "fsqrt": np.sqrt, "fsin": np.sin, "fcos": np.cos,
            "ftan": np.tan, "fasin": np.arcsin, "facos": np.arccos, "fatan": np.arctan,
            "fexp": np.exp, "flog": np.log}
_FOLD_F2 = {"fadd": np.add, "fsub": np.subtract, "fmul": np.multiply, "fdiv": np.divide,
            "fatan2": np.arctan2, "fpow": np.power, "fmod": _fmod, "fmin": np.minimum,
            "fmax": np.maximum}


def _fold(op, vals):
    """Eager (op-by-op) float32 / int32 evaluation of a constant node."""
    with np.errstate(all="ignore"):
        if op in _FOLD_F1:
            return np.float32(_FOLD_F1[op](np.float32(vals[0])))
        if op in _FOLD_F2:
            return np.float32(_FOLD_F2[op](np.float32(vals[0]), np.float32(vals[1])))
        a = vals[0]
        b = vals[1] if len(vals) > 1 else None
        if op == "iadd":
            return _wrap(int(a) + int(b))
        if op == "isub":
            return _wrap(int(a) - int(b))
        if op == "imul":
            return _wrap(int(a) * int(b))
        if op == "imod":
            return _imod(a, b)
        if op == "ineg":
            return _wrap(-int(a))
        if op == "iabs":
            return _wrap(abs(int(a)))
        if op == "imin":
            return np.int32(min(int(a), int(b)))
        if op == "imax":
            return np.int32(max(int(a), int(b)))
        if op == "i2f":
            return np.float32(int(a))
        if op == "f2i":
            return _f32_to_i32(a)
        if op in ("b2i", "b2f"):
            return (np.int32 if op == "b2i" else np.float32)(1 if a else 0)
        if op in ("f2b", "i2b"):
            return np.bool_(a != 0)
        cmp = {"lt": a < b, "le": a <= b, "eq": a == b, "ne": a != b} \
            if op[1:] in ("lt", "le", "eq", "ne") else None
        if cmp is not None:
            return np.bool_(cmp[op[1:]])
        if op == "and":
            return np.bool_(bool(a) and bool(b))
        if op == "or":
            return np.bool_(bool(a) or bool(b))
        if op == "xor":
            return np.bool_(bool(a) != bool(b))
        if op == "not":
            return np.bool_(not a)
        if op == "sel":
            return vals[1] if vals[0] else vals[2]
    raise AssertionError(op)


class _Builder:
    """Hash-consed DAG construction with eager folding of constants."""

    def __init__(self):
        self._memo = {}
        self.time = Node("time", _F)
        self.idx = Node("idx", _I)
        self.ninst = Node("ninst", _I)

    def const(self, value, ty):
        v = _NP[ty](value)
        key = ("const", ty, v.tobytes())
        n = self._memo.get(key)
        if n is None:
            n = self._memo[key] = Node("const", ty, (), v)
        return n

    def node(self, op, ty, *args):
        if args and all(_is_const(a) for a in args):
            return self.const(_fold(op, [a.imm for a in args]), ty)
        key = (op, ty) + tuple(id(a) for a in args)
        n = self._memo.get(key)
        if n is None:
            n = self._memo[key] = Node(op, ty, args)
        return n

    # -- conversions
    def to_f(self, x):
        if x.ty == _F:
            return x
        return self.node("i2f" if x.ty == _I else "b2f", _F, x)

    def to_i(self, x):
        if x.ty == _I:
            return x
        return self.node("f2i" if x.ty == _F else "b2i", _I, x)

    def to_b(self, x):
        if x.ty == _B:
            return x
        return self.node("f2b" if x.ty == _F else "i2b", _B, x)

    def to(self, x, ty):
        return {_F: self.to_f, _I: self.to_i, _B: self.to_b}[ty](x)

    # -- float ops with XLA's simplifications
    def _reassoc(self, op, a, b):
        """(X op C1) op C2 -> X op (C1 op C2), C folded in float32."""
        if _is_const(a) and not _is_const(b):
            a, b = b, a
        if _is_const(b) and a.op == op:
            x, c1 = a.args if _is_const(a.args[1]) else a.args[::-1]
            if _is_const(c1) and not _is_const(x):
                return x, self.node(op, _F, c1, b)
        return a, b

    def fmul(self, a, b):
        if _is_const(b) and b.imm == 1.0 and not _is_const(a):
            return a
        if _is_const(a) and a.imm == 1.0 and not _is_const(b):
            return b
        if _is_const(a) or _is_const(b):
            a, b = self._reassoc("fmul", a, b)
        return self.node("fmul", _F, a, b)

    def fadd(self, a, b):
        if _is_const(b) and b.imm == 0.0 and not _is_const(a):
            return a
        if _is_const(a) and a.imm == 0.0 and not _is_const(b):
            return b
        if _is_const(a) or _is_const(b):
            a, b = self._reassoc("fadd", a, b)
        return self.node("fadd", _F, a, b)

    def fsub(self, a, b):
        if _is_const(b) and not _is_const(a):          # A - C -> A + (-C)
            return self.fadd(a, self.const(-b.imm, _F))
        return self.node("fsub", _F, a, b)

    def fdiv(self, a, b):
        if _is_const(b):            # constant numerators too: XLA folds later
            with np.errstate(all="ignore"):
                return self.fmul(a, self.const(np.float32(1.0) / b.imm, _F))
        return self.node("fdiv", _F, a, b)

    def f1(self, op, x):
        return self.node(op, _F, self.to_f(x))

    def select(self, c, a, b):
        if _is_const(c):
            return a if bool(c.imm) else b
        return self.node("sel", a.ty, c, a, b)


def _promote(*xs):
    tys = {x.ty for x in xs}
    return _F if _F in tys else (_I if _I in tys else _B)


# ---------------------------------------------------------------- evaluation

class Lowerer:
    """Evaluates a parsed program's hooks over the DAG, mirroring
    ``_Program.eval`` of the reference."""

    def __init__(self, program):
        self.p = program
        self.g = _Builder()

    # -- arithmetic on scalars
    def arith(self, op, a, b):
        g = self.g
        if op in ("&&", "||"):
            a, b = g.to_b(self._scalar(a, op)), g.to_b(self._scalar(b, op))
            return g.node("and" if op == "&&" else "or", _B, a, b)
        if isinstance(a, Vec) or isinstance(b, Vec):
            return self._vec_binop(op, a, b)
        a, b = self._scalar(a, op), self._scalar(b, op)
        if op == "/":
            return g.fdiv(g.to_f(a), g.to_f(b))
        ty = _promote(a, b)
        if op in ("==", "!=", "<", "<=", ">", ">="):
            if ty == _B:
                ty = _I
            a, b = g.to(a, ty), g.to(b, ty)
            p = "f" if ty == _F else "i"
            if op in (">", ">="):
                a, b, op = b, a, "<" if op == ">" else "<="
            name = {"==": "eq", "!=": "ne", "<": "lt", "<=": "le"}[op]
            return g.node(p + name, _B, a, b)
        if ty == _B:
            if op == "+":
                return g.node("or", _B, a, b)
            if op == "*":
                return g.node("and", _B, a, b)
            raise WinterParseError(f"operator {op} not defined on booleans")
        a, b = g.to(a, ty), g.to(b, ty)
        if ty == _F:
            if op == "+":
                return g.fadd(a, b)
            if op == "-":
                return g.fsub(a, b)
            if op == "*":
                return g.fmul(a, b)
            if op == "%":
                return g.node("fmod", _F, a, b)
        else:
            name = {"+": "iadd", "-": "isub", "*": "imul", "%": "imod"}.get(op)
            if name:
                return g.node(name, _I, a, b)
        raise WinterParseError(f"unknown operator {op}")

    def _scalar(self, x, what):
        if isinstance(x, Node):
            return x
        raise WinterParseError(f"{what} on a non-scalar value")

    def _vec_binop(self, op, a, b):
        g = self.g
        if isinstance(a, Vec) and isinstance(b, Vec):
            if a.n != b.n:
                raise WinterParseError(f"vector sizes {a.n} and {b.n} differ")
            la, lb = a.comps, b.comps
        elif isinstance(a, Vec):
            la, lb = a.comps, [g.to_f(self._scalar(b, op))] * a.n
        else:
            la, lb = [g.to_f(self._scalar(a, op))] * b.n, b.comps
        if op in ("+", "-", "*", "/"):
            return Vec([self.arith(op, x, y) for x, y in zip(la, lb)])
        if op in ("==", "!="):
            eq = [self.arith("==", x, y) for x, y in zip(la, lb)]
            acc = eq[0]
            for e in eq[1:]:
                acc = g.node("and", _B, acc, e)
            return acc if op == "==" else g.node("not", _B, acc)
        raise WinterParseError(f"operator {op} not defined on vectors")

    # -- builtins
    def _map(self, fn, *args):
        """Lift a scalar builtin over vectors (scalars broadcast)."""
        vecs = [a for a in args if isinstance(a, Vec)]
        if not vecs:
            return fn(*[self._scalar(a, "builtin") for a in args])
        n = vecs[0].n
        if any(v.n != n for v in vecs):
            raise WinterParseError("vector sizes differ")
        return Vec([fn(*[a.comps[i] if isinstance(a, Vec) else self._scalar(a, "builtin")
                         for a in args]) for i in range(n)])

    def _unary_f(self, op):
        return lambda x: self.g.f1(op, x)

    def _minmax(self, which):
        def fn(a, b):
            g = self.g
            ty = _promote(a, b)
            if ty == _B:
                ty = _I
            return g.node(("f" if ty == _F else "i") + which, ty, g.to(a, ty), g.to(b, ty))
        return fn

    def _round(self, op):
        def fn(x):
            return x if x.ty != _F else self.g.node(op, _F, x)
        return fn

    def _abs(self, x):
        if x.ty == _F:
            return self.g.node("fabs", _F, x)
        return self.g.node("iabs", _I, self.g.to_i(x))

    def _pow(self, x, y):
        g = self.g
        if _is_const(y) and y.ty in (_I, _B):
            e = int(y.imm)
            if x.ty == _B:
                x = g.to_i(x)
            if e == 0:
                return g.const(1, x.ty)
            mul = g.fmul if x.ty == _F else (lambda a, b: g.node("imul", _I, a, b))
            neg, e = e < 0, abs(e)
            acc = None
            while e > 0:
                if e & 1:
                    acc = x if acc is None else mul(acc, x)
                e >>= 1
                if e > 0:
                    x = mul(x, x)
            if neg:
                if acc.ty != _F:
                    raise WinterParseError("integer to a negative power")
                acc = g.fdiv(g.const(1.0, _F), acc)
            return acc
        if x.ty != _F and y.ty != _F:
            raise WinterParseError("pow of an integer by a traced integer is not supported")
        return g.node("fpow", _F, g.to_f(x), g.to_f(y))

    def _mod(self, a, b):
        return self.arith("%", a, b)

    def _where(self, c, a, b):
        g = self.g
        ty = _promote(a, b)
        return g.select(g.to_b(c), g.to(a, ty), g.to(b, ty))

    def _smooth(self, kind):
        g = self.g

        def fn(a, b, x):
            a, b, x = g.to_f(a), g.to_f(b), g.to_f(x)
            xa = g.fsub(x, a)
            ba = g.fsub(b, a)
            q = g.fdiv(xa, ba)
            if kind == 2:        # q ** 2 * (3 - 2 (x - a) / (b - a))
                inner = g.fsub(g.const(3.0, _F), g.fdiv(g.fmul(g.const(2.0, _F), xa), ba))
                val = g.fmul(self._pow(q, g.const(2, _I)), inner)
            else:                # q ** 3 * (q (q 6 - 15) + 10)
                inner = g.fadd(g.fmul(q, g.fsub(g.fmul(q, g.const(6.0, _F)),
                                                g.const(15.0, _F))), g.const(10.0, _F))
                val = g.fmul(self._pow(q, g.const(3, _I)), inner)
            return g.select(g.node("flt", _B, x, a), g.const(0.0, _F),
                            g.select(g.node("fle", _B, b, x), g.const(1.0, _F), val))
        return fn

    def _noise1(self, x):
        g = self.g
        if isinstance(x, Vec):
            ws = [12.9898, 78.233, 37.719, 9.151][:x.n]
            acc = g.const(0.0, _F)          # Python's sum() starts at 0
            for comp, w in zip(x.comps, ws):
                acc = g.fadd(acc, g.fmul(g.to_f(comp), g.const(w, _F)))
            x = acc
        x = g.to_f(self._scalar(x, "noise"))
        i = g.node("ffloor", _F, x)
        t = g.fsub(x, i)
        t = g.fmul(g.fmul(t, t), g.fsub(g.const(3.0, _F), g.fmul(g.const(2.0, _F), t)))

        def h(k):
            s = g.node("fsin", _F, g.fadd(g.fmul(k, g.const(127.1, _F)), g.const(311.7, _F)))
            m = g.node("fmod", _F, g.fmul(s, g.const(43758.5453, _F)), g.const(2.0, _F))
            return g.fsub(m, g.const(1.0, _F))
        one = g.const(1.0, _F)
        return g.fadd(g.fmul(h(i), g.fsub(one, t)), g.fmul(h(g.fadd(i, one)), t))

    def _fbm(self, x, octaves):
        g = self.g
        # Under jit even a literal count is a tracer, so _fbm's int() fails
        # and it takes 4 octaves: the jitted reference always does.
        octs = 4
        acc = g.const(0.0, _F)
        amp, freq = 0.5, 1.0
        for _ in range(max(1, min(int(octs), 8))):
            if isinstance(x, Vec):
                xs = Vec([g.fmul(g.to_f(c), g.const(freq, _F)) for c in x.comps])
            else:
                xs = g.fmul(g.to_f(x), g.const(freq, _F))
            acc = g.fadd(acc, g.fmul(g.const(amp, _F), self._noise1(xs)))
            amp, freq = amp * 0.5, freq * 2.0
        return acc

    def _dot(self, a, b):
        g = self.g
        if not (isinstance(a, Vec) and isinstance(b, Vec)) or a.n != b.n:
            raise WinterParseError("dot of non-vectors")
        ty = _promote(*a.comps, *b.comps)
        la = [g.to(c, ty) for c in a.comps]
        lb = [g.to(c, ty) for c in b.comps]
        if all(_is_const(c) for c in la + lb):      # eager: a sum of products
            acc = g.const(0, ty)
            for x, y in zip(la, lb):
                p = g.fmul(x, y) if ty == _F else g.node("imul", _I, x, y)
                acc = g.fadd(acc, p) if ty == _F else g.node("iadd", _I, acc, p)
            return acc
        if ty != _F:
            acc = g.const(0, _I)
            for x, y in zip(la, lb):
                acc = g.node("iadd", _I, acc, g.node("imul", _I, x, y))
            return acc
        return g.node("dot", _F, *(la + lb))

    def _length(self, a):
        return self.g.node("fsqrt", _F, self.g.to_f(self._dot(a, a)))

    def _cross(self, a, b):
        g = self.g
        if not (isinstance(a, Vec) and isinstance(b, Vec)) or a.n < 3 or b.n < 3:
            raise WinterParseError("cross of non-vec3s")
        ty = _promote(*a.comps[:3], *b.comps[:3])
        (a0, a1, a2), (b0, b1, b2) = ([g.to(c, ty) for c in v.comps[:3]] for v in (a, b))
        if ty != _F:
            def m(x, y):
                return g.node("imul", _I, x, y)

            def s(x, y):
                return g.node("isub", _I, x, y)
        else:
            m, s = g.fmul, g.fsub
        return Vec([s(m(a1, b2), m(a2, b1)), s(m(a2, b0), m(a0, b2)),
                    s(m(a0, b1), m(a1, b0))])

    def _normalise(self, a):
        if not isinstance(a, Vec):
            raise WinterParseError("normalise of a non-vector")
        ln = self._length(a)
        return Vec([self.g.fdiv(self.g.to_f(c), ln) for c in a.comps])

    def _make_vec(self, n, args):
        g = self.g
        if len(args) == 1 and isinstance(args[0], Vec):
            c = args[0].comps
            if len(c) >= n:
                return Vec(c[:n])
            return Vec(c + [g.const(0, c[0].ty)] * (n - len(c)))
        if len(args) == 1:
            return Vec([g.to_f(self._scalar(args[0], f"vec{n}"))] * n)
        if len(args) != n:
            raise WinterParseError(f"vec{n} expects 1 or {n} args")
        return Vec([g.to_f(self._scalar(a, f"vec{n}")) for a in args])

    def _comp(self, i, v):
        if isinstance(v, Vec):
            if i >= v.n:
                raise WinterParseError(f"component {i} of a vec{v.n}")
            return v.comps[i]
        raise WinterParseError(f"e{i}() on non-vector")

    def _index(self, v, i):
        g = self.g
        if not isinstance(v, Vec):
            raise WinterParseError("indexing on non-vector")
        i = g.to_i(self._scalar(i, "index"))
        n = v.n
        fill = g.const(np.nan, _F) if v.comps[0].ty == _F else g.const(0, v.comps[0].ty)
        if _is_const(i):
            k = int(i.imm)
            return v.comps[k + n if k < 0 else k] if -n <= k < n else fill
        out = fill
        for k in range(n):
            hit = g.node("or", _B, g.node("ieq", _B, i, g.const(k, _I)),
                         g.node("ieq", _B, i, g.const(k - n, _I)))
            out = g.select(hit, v.comps[k], out)
        return out

    def builtin(self, name, args):
        g = self.g
        m = self._map
        table = {
            "sin": "fsin", "cos": "fcos", "tan": "ftan", "asin": "fasin", "acos": "facos",
            "atan": "fatan", "sqrt": "fsqrt", "exp": "fexp", "log": "flog",
        }
        n = len(args)

        def need(k):
            if n != k:
                raise WinterParseError(f"{name} expects {k} args, got {n}")
        if name in table:
            need(1)
            return m(self._unary_f(table[name]), *args)
        if name in ("floor", "ceil"):
            need(1)
            return m(self._round("f" + name), *args)
        if name == "abs":
            need(1)
            return m(self._abs, *args)
        if name == "atan2":
            need(2)
            return m(lambda y, x: g.node("fatan2", _F, g.to_f(y), g.to_f(x)), *args)
        if name == "pow":
            need(2)
            return m(self._pow, *args)
        if name == "mod":
            need(2)
            return m(self._mod, *args)
        if name in ("min", "max"):
            need(2)
            return m(self._minmax(name), *args)
        if name == "fract":
            need(1)
            return m(lambda x: g.const(0, x.ty) if x.ty != _F
                     else g.fsub(x, g.node("ffloor", _F, x)), *args)
        if name == "clamp":
            need(3)
            return m(lambda x, a, b: self._minmax("min")(self._minmax("max")(a, x), b), *args)
        if name == "lerp":
            need(3)
            return m(lambda a, b, t: self.arith("+", a, self.arith("*", self.arith("-", b, a),
                                                                    t)), *args)
        if name == "step":
            need(2)
            return m(lambda e, x: self._where(self.arith(">=", x, e), g.const(1.0, _F),
                                              g.const(0.0, _F)), *args)
        if name in ("smoothstep", "smootherstep"):
            need(3)
            return m(self._smooth(2 if name == "smoothstep" else 3), *args)
        if name == "pulse":
            need(3)
            return m(lambda a, b, x: self._where(
                g.node("or", _B, self.arith("<", x, a), self.arith(">", x, b)),
                g.const(0.0, _F), g.const(1.0, _F)), *args)
        if name in ("toFloat", "real"):
            need(1)
            return m(g.to_f, *args)
        if name == "toInt":
            need(1)
            return m(g.to_i, *args)
        if name in ("truncateToInt", "floorToInt", "ceilToInt"):
            need(1)
            op = {"truncateToInt": "ftrunc", "floorToInt": "ffloor", "ceilToInt": "fceil"}[name]
            return m(lambda x: g.to_i(x if x.ty != _F else g.node(op, _F, x)), *args)
        if name == "neg":
            need(1)
            return m(lambda x: self._neg(x), *args)
        if name == "recip":
            need(1)
            return m(lambda x: g.fdiv(g.const(1.0, _F), g.to_f(x)), *args)
        if name == "pi":
            need(0)
            return g.const(math.pi, _F)
        if name == "if":
            need(3)
            c, a, b = args
            if isinstance(a, Vec) or isinstance(b, Vec):
                if not (isinstance(a, Vec) and isinstance(b, Vec)) or a.n != b.n:
                    raise WinterParseError("if() mixes vectors of different sizes")
                cb = g.to_b(self._scalar(c, "if"))
                return Vec([self._where(cb, x, y) for x, y in zip(a.comps, b.comps)])
            if isinstance(a, dict) or isinstance(b, dict):
                raise WinterParseError("if() on structs")
            return self._where(self._scalar(c, "if"), a, b)
        if name in ("vec2", "vec3", "vec4"):
            return self._make_vec(int(name[3]), args)
        comps = {"x": 0, "y": 1, "z": 2, "w": 3, "e0": 0, "e1": 1, "e2": 2, "e3": 3,
                 "doti": 0, "dotj": 1, "dotk": 2}
        if name in comps:
            need(1)
            return self._comp(comps[name], args[0])
        if name == "dot":
            need(2)
            return self._dot(*args)
        if name == "cross":
            need(2)
            return self._cross(*args)
        if name == "length":
            need(1)
            return self._length(args[0])
        if name == "length2":
            need(1)
            return self._dot(args[0], args[0])
        if name == "dist":
            need(2)
            return self._length(self.arith("-", args[0], args[1]))
        if name in ("normalise", "normalize"):
            need(1)
            return self._normalise(args[0])
        if name in ("and", "or", "xor"):
            need(2)
            return m(lambda a, b: g.node(name, _B, g.to_b(a), g.to_b(b)), *args)
        if name == "not":
            need(1)
            return m(lambda a: g.node("not", _B, g.to_b(a)), *args)
        if name == "noise":
            need(1)
            return self._noise1(args[0])
        if name == "noise01":
            need(1)
            return g.fmul(g.fadd(self._noise1(args[0]), g.const(1.0, _F)), g.const(0.5, _F))
        if name == "fbm":
            need(2)
            return self._fbm(args[0], self._scalar(args[1], "fbm"))
        if name == "__index":
            need(2)
            return self._index(*args)
        if name in ("add", "sub", "div"):
            need(2)
            op = {"add": "+", "sub": "-", "div": "/"}[name]
            return m(lambda a, b: self.arith(op, a, b), *args)
        if name in ("lt", "lte", "gt", "gte", "eq", "neq"):
            need(2)
            op = {"lt": "<", "lte": "<=", "gt": ">", "gte": ">=", "eq": "==", "neq": "!="}[name]
            return m(lambda a, b: self.arith(op, a, b), *args)
        raise WinterParseError(f"call to {name!r} not allowed")

    def _neg(self, v):
        g = self.g
        if isinstance(v, Vec):
            return Vec([self._neg(c) for c in v.comps])
        v = self._scalar(v, "-")
        if v.ty == _F:
            return g.node("fneg", _F, v)
        if v.ty == _I:
            return g.node("ineg", _I, v)
        raise WinterParseError("unary - on a boolean")

    # -- the tree walk (reference winter.py:656-718)
    def eval(self, node, env, depth=0):
        from substrata_tpu_torch.scripting import winter as w
        g = self.g
        if depth > MAX_CALL_DEPTH:
            raise WinterParseError("call depth limit exceeded (recursion?)")
        if isinstance(node, w._Num):
            return g.const(node.value, _I if node.is_int else _F)
        if isinstance(node, w._Bool):
            return g.const(node.value, _B)
        if isinstance(node, w._Var):
            if node.name not in env:
                raise WinterParseError(f"unknown name {node.name!r}")
            return env[node.name]
        if isinstance(node, w._VecLit):
            return Vec([g.to_f(self._scalar(self.eval(e, env, depth), "vector literal"))
                        for e in node.elems])
        if isinstance(node, w._Let):
            inner = dict(env)
            for name, expr in node.bindings:
                inner[name] = self.eval(expr, inner, depth)
            return self.eval(node.body, inner, depth)
        if isinstance(node, w._BinOp):
            return self.arith(node.op, self.eval(node.left, env, depth),
                              self.eval(node.right, env, depth))
        if isinstance(node, w._UnaryOp):
            v = self.eval(node.operand, env, depth)
            if node.op == "-":
                return self._neg(v)
            return g.node("not", _B, g.to_b(self._scalar(v, "!")))
        if isinstance(node, w._Field):
            base = self.eval(node.base, env, depth)
            if isinstance(base, dict):
                if node.name not in base:
                    raise WinterParseError(f"no field {node.name!r}")
                return base[node.name]
            if isinstance(base, Vec):
                comp = {"x": 0, "y": 1, "z": 2, "w": 3}
                if node.name in comp and comp[node.name] < base.n:
                    return base.comps[comp[node.name]]
                if node.name == "v":
                    return base
            raise WinterParseError(f"field access .{node.name} not allowed")
        if isinstance(node, w._Call):
            args = [self.eval(a, env, depth) for a in node.args]
            f = self.p.lookup(node.name, len(args))
            if f is not None:
                inner = {name: arg for (_t, name), arg in zip(f.params, args)}
                return self.eval(f.body, inner, depth + 1)
            if node.name in self.p.structs:
                sd = self.p.structs[node.name]
                if len(args) != len(sd.fields):
                    raise WinterParseError(
                        f"struct {node.name} expects {len(sd.fields)} args")
                return dict(zip(sd.fields, args))
            if node.name == "mul":
                if len(args) != 2:
                    raise WinterParseError("mul expects 2 args")
                return self.arith("*", *args)
            return self.builtin(node.name, args)
        raise WinterParseError(f"bad node {type(node).__name__}")

    def hook(self, name):
        """The hook's result as 3 float nodes (reference _as_vec3_arr)."""
        g = self.g
        f = self.p.lookup(name, 2)
        if f is None:
            return [g.const(0.0, _F)] * 3
        env = {"instance_index": g.idx, "num_instances": g.ninst}
        out = self.eval(f.body, {f.params[0][1]: g.time, f.params[1][1]: env})
        if isinstance(out, Vec):
            c = [g.to_f(x) for x in out.comps[:3]]
            return c + [g.const(0.0, _F)] * (3 - len(c))
        if isinstance(out, dict):
            raise WinterParseError("a hook returned a struct")
        return [g.to_f(out)] * 3


# ---------------------------------------------------------------- emission

@dataclasses.dataclass
class Lowered:
    code: np.ndarray      # int32 [n, 5]: op, dst, a, b, c
    n_regs: int


class _Emitter:
    def __init__(self):
        self.code = []           # [op, dst, a, b, c] with virtual registers
        self.n = N_INPUTS
        self.cse = {}
        self.reduced = {}        # id(reduction node) -> register

    def emit(self, op, *args, imm=None):
        key = (op, args, imm)
        r = self.cse.get(key)
        if r is None:
            r = self.cse[key] = self.n
            self.n += 1
            a = list(args) + [0] * (3 - len(args))
            if imm is not None:
                a[0] = imm
            self.code.append([OP[op], r, *a])
        return r

    def _dot(self, n, gen):
        """A reduction sum of products, as XLA's reduce loop rounds it: the
        running sum takes each next product by one multiply-add (a product of
        two constants is folded, and then the first product is the one
        fused)."""
        k = len(n.args) // 2
        terms = []
        for x, y in zip(n.args[:k], n.args[k:]):
            if _is_const(x) and _is_const(y):
                terms.append(("c", np.float32(x.imm) * np.float32(y.imm)))
            else:
                terms.append(("p", x, y))
        acc = terms[0]
        for t in terms[1:]:
            if t[0] == "p":
                acc = ("r", self.emit("ffma", gen(t[1]), gen(t[2]), self._term(acc, gen)))
            elif acc[0] == "p":
                acc = ("r", self.emit("ffma", gen(acc[1]), gen(acc[2]), self._const(t[1])))
            else:
                acc = ("r", self.emit("fadd", self._term(acc, gen), self._const(t[1])))
        return self._term(acc, gen)

    def _term(self, t, gen):
        if t[0] == "p":
            return self.emit("fmul", gen(t[1]), gen(t[2]))
        if t[0] == "c":
            return self._const(t[1])
        return t[1]

    def _const(self, v):
        return self.emit("constf", imm=int(np.array(v, np.float32).view(np.int32)))

    def region(self, root):
        """Emit ``root`` with multiply-add contraction decided by the uses
        inside its region; reductions below it are regions of their own."""
        uses = {}
        seen = set()
        stack = [root]
        while stack:
            n = stack.pop()
            if id(n) in seen:
                continue
            seen.add(id(n))
            if n.op in _REDUCE and n is not root:
                continue
            for a in n.args:
                uses[id(a)] = uses.get(id(a), 0) + 1
                stack.append(a)
        memo = {}
        ranks = {}
        loads = []

        def rank(n):
            """LLVM Reassociate's rank: constants 0, each input (a load)
            its own rank in order of first use, an op 1 + its operands'
            highest (a negation adds nothing)."""
            r = ranks.get(id(n))
            if r is None:
                if n.op == "const":
                    r = 0
                elif not n.args or (n.op in _REDUCE and n is not root):
                    loads.append(n)
                    r = 1000 + len(loads)
                else:
                    r = max(rank(a) for a in n.args) + (n.op not in ("fneg", "ineg"))
                ranks[id(n)] = r
            return r
        rank(root)

        def gen_all(*nodes):
            """Registers of ``nodes``, the deepest generated first (fewer
            live registers; the order changes no value)."""
            order = sorted(range(len(nodes)), key=lambda k: -rank(nodes[k]))
            regs = [None] * len(nodes)
            for k in order:
                regs[k] = gen(nodes[k])
            return regs

        def single_mul(n):
            return n.op == "fmul" and uses.get(id(n), 0) == 1

        def gen(n):
            r = memo.get(id(n))
            if r is not None:
                return r
            if n.op in _REDUCE and n is not root:
                r = self.reduced.get(id(n))
                if r is None:
                    r = self.reduced[id(n)] = self.region(n)
            elif n.op == "const":
                bits = int(np.array(n.imm, _NP[n.ty]).astype(_NP[n.ty]).view(np.int32)) \
                    if n.ty != _B else int(bool(n.imm))
                r = self.emit("const" + n.ty, imm=bits)
            elif n.op == "time":
                r = 0
            elif n.op == "idx":
                r = 1
            elif n.op == "ninst":
                r = 2
            elif n.op == "dot":
                r = self._dot(n, gen)
            elif n.op == "fadd" and (single_mul(n.args[0]) or single_mul(n.args[1])):
                x, y = n.args
                if _is_const(x) or rank(y) < rank(x):      # LLVM's operand order
                    x, y = y, x
                m, c = (x, y) if single_mul(x) else (y, x)
                r = self.emit("ffma", *gen_all(m.args[0], m.args[1], c))
            elif n.op == "fsub" and single_mul(n.args[0]):
                m, c = n.args
                ra, rb, rc = gen_all(m.args[0], m.args[1], c)
                r = self.emit("ffma", ra, rb, self.emit("fneg", rc))
            elif n.op == "fsub" and single_mul(n.args[1]):
                c, m = n.args
                ra, rb, rc = gen_all(m.args[0], m.args[1], c)
                r = self.emit("ffma", self.emit("fneg", ra), rb, rc)
            else:
                r = self.emit(n.op, *gen_all(*n.args))
            memo[id(n)] = r
            return r
        return gen(root)


def _allocate(code, n_virtual):
    """Reuse registers once their value is dead (linear scan over the
    straight-line code).  Inputs keep registers 0-2."""
    last = {}
    for i, (op, dst, a, b, c) in enumerate(code):
        for k, r in zip((a, b, c), _operands(op)):
            if r:
                last[k] = i
    phys = {0: 0, 1: 1, 2: 2}
    free, top = [], N_INPUTS
    out = []
    for i, (op, dst, a, b, c) in enumerate(code):
        args = [phys[x] if used else x for x, used in zip((a, b, c), _operands(op))]
        for x, used in zip((a, b, c), _operands(op)):
            if used and last.get(x) == i and x >= N_INPUTS and phys[x] not in free:
                free.append(phys[x])
        if OPS[op] == "out":
            out.append([op, dst, *args])
            continue
        if free:
            p = free.pop()
        else:
            p, top = top, top + 1
        phys[dst] = p
        if dst not in last:          # never read: give it back at once
            free.append(p)
        out.append([op, p, *args])
    return out, top


def _operands(op):
    """Which of (a, b, c) are register operands of op code ``op``."""
    name = OPS[op]
    if name.startswith("const"):
        return (False, False, False)
    if name in ("ffma", "sel"):
        return (True, True, True)
    if name in ("fadd", "fsub", "fmul", "fdiv", "fatan2", "fpow", "fmod", "fmin", "fmax",
                "iadd", "isub", "imul", "imod", "imin", "imax", "flt", "fle", "feq", "fne",
                "ilt", "ile", "ieq", "ine", "and", "or", "xor"):
        return (True, True, False)
    return (True, False, False)


def lower(program) -> Lowered:
    """Lower both hooks of a parsed ``_Program`` (raises WinterParseError
    where the reference's evaluation would)."""
    lw = Lowerer(program)
    outs = lw.hook("evalRotation") + lw.hook("evalTranslation")
    em = _Emitter()
    regs = [em.region(n) for n in outs]
    code = em.code + [[OP["out"], k, r, 0, 0] for k, r in enumerate(regs)]
    code, n_regs = _allocate(code, em.n)
    return Lowered(code=np.asarray(code, np.int32).reshape(-1, 5), n_regs=n_regs)
