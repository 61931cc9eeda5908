"""Winter script evaluation (kernel KR).

Replaces K16, the jitted batch evaluation of
``substrata_tpu/scripting/winter.py`` (``ObjectScriptsEvaluator._get_jitted``
:817-829; bench.py's ``winter_eval`` :200-207): f(time [B] f32, instance
index [B] i32, instance count [B] i32) -> axis-angle rotation and
translation [B, 3] each.

Each source is lowered once (``scripting/lower.py``) to straight-line
code over typed scalar registers.  A ``Batch`` puts the programs of one
call side by side: one int32 buffer holds every program's instructions,
a segment table (code offset, length, first instance, count) and a block
table, uploaded once.  ``winter_eval`` then runs all of them in one
launch of ``csrc/winter.cu``, one thread per instance: each block stages
its segment's instructions in shared memory in chunks and every thread
reads them uniformly; the register file lies in a device scratch buffer
laid out [R, B] (register-major: neighbouring threads touch neighbouring
words), R the largest register count of the batch.  The output is
[B, 6].  Bound: the interpreter's instruction issue and the scratch
traffic (R x 4 bytes per instance per touch), latency-bound at the
bench's 512 instances.

``winter_eval_plain`` is the twin: the same instruction list over [B]
tensors, op for op (torch's transcendentals, which on the card are the
precise CUDA functions the kernel calls).
"""

from __future__ import annotations

import numpy as np
import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.maths import fp
from substrata_tpu_torch.scripting.lower import N_INPUTS, N_OUT, OPS

launches = 0
THREADS = 128      # instances per block


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.asarray(x, jnp.int32)``: floats truncate (saturating, NaN -> 0)."""
    if not x.dtype.is_floating_point:
        return x.to(torch.int32)
    return _f2i(x.to(torch.float32))


def _f2i(x):
    t = torch.trunc(torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0))
    t = torch.clamp(t, -2147483648.0, 2147483520.0).to(torch.int32)
    t = torch.where(x >= 2147483648.0, 2147483647, t)
    return torch.where(x < -2147483648.0, -2147483648, t).to(torch.int32)


class Batch:
    """The programs of one call and where their instances lie.

    ``codes``: int32 [n_i, 5] numpy instruction lists; ``n_regs``: each
    program's register count; ``segments``: (first instance, count) of
    each program over the batch's B instances, in order and together
    covering [0, B)."""

    def __init__(self, codes, n_regs, segments, device):
        self.codes = [np.asarray(c, np.int32).reshape(-1, 5) for c in codes]
        self.n_regs = max(n_regs)
        self.segments = [(int(a), int(c)) for a, c in segments]
        self.size = sum(c for _, c in self.segments)
        self.device = torch.device(device)
        offs = np.cumsum([0] + [len(c) for c in self.codes])
        seg = np.array([(offs[k], len(c), a, n) for k, (c, (a, n))
                        in enumerate(zip(self.codes, self.segments))], np.int32).reshape(-1, 4)
        blk = np.array([(k, a + j) for k, (a, n) in enumerate(self.segments)
                        for j in range(0, n, THREADS)], np.int32).reshape(-1, 2)
        self.n_instr = int(offs[-1])
        self.n_blocks = blk.shape[0]
        self.table = torch.as_tensor(
            np.concatenate([np.concatenate(self.codes).reshape(-1), seg.reshape(-1),
                            blk.reshape(-1)]), device=self.device)

    def views(self):
        """(code [n, 5], segments [S, 4], blocks [nb, 2]) of the device table."""
        n5 = self.n_instr * 5
        s4 = len(self.segments) * 4
        t = self.table
        return (t[:n5].view(-1, 5), t[n5:n5 + s4].view(-1, 4), t[n5 + s4:].view(-1, 2))


def _run_plain(code, time, idx, n_inst, n_regs):
    """Interpret one program over [b] tensors; returns [b, 6] float32."""
    regs = [None] * max(n_regs, N_INPUTS)
    regs[0], regs[1], regs[2] = time, idx, n_inst
    out = torch.zeros((time.shape[0], N_OUT), dtype=torch.float32, device=time.device)
    b = time.shape[0]
    dev = time.device
    for op, dst, a, bb, c in code.tolist():
        name = OPS[op]
        if name.startswith("const"):
            bits = np.array([a], np.int32)
            if name == "constf":
                val = torch.full((b,), float(bits.view(np.float32)[0]), dtype=torch.float32,
                                 device=dev)
            elif name == "consti":
                val = torch.full((b,), int(a), dtype=torch.int32, device=dev)
            else:
                val = torch.full((b,), bool(a), dtype=torch.bool, device=dev)
            regs[dst] = val
            continue
        x = regs[a]
        y = regs[bb] if name in _BINARY or name in ("ffma", "sel") else None
        if name == "out":
            out[:, dst] = x
            continue
        regs[dst] = _apply(name, x, y, regs[c] if name in ("ffma", "sel") else None)
    return out


_BINARY = {"fadd", "fsub", "fmul", "fdiv", "fatan2", "fpow", "fmod", "fmin", "fmax",
           "iadd", "isub", "imul", "imod", "imin", "imax", "flt", "fle", "feq", "fne",
           "ilt", "ile", "ieq", "ine", "and", "or", "xor"}
_F1 = {"fneg": torch.neg, "fabs": torch.abs, "ffloor": torch.floor, "fceil": torch.ceil,
       "ftrunc": torch.trunc, "fsqrt": torch.sqrt, "fsin": torch.sin, "fcos": torch.cos,
       "ftan": torch.tan, "fasin": torch.asin, "facos": torch.acos, "fatan": torch.atan,
       "fexp": torch.exp, "flog": torch.log}


def _min_max(x, y, pick_x):
    """NaN-propagating minimum / maximum (jnp.minimum, jnp.maximum)."""
    r = torch.where(pick_x, x, y)
    return torch.where(torch.isnan(y), y, torch.where(torch.isnan(x), x, r))


def _apply(name, x, y, z):
    if name in _F1:
        return _F1[name](x)
    if name == "fadd":
        return x + y
    if name == "fsub":
        return x - y
    if name == "fmul":
        return x * y
    if name == "fdiv":
        return x / y
    if name == "ffma":
        return fp.fma(x, y, z)
    if name == "fatan2":
        return torch.atan2(x, y)
    if name == "fpow":
        return torch.pow(x, y)
    if name == "fmod":
        return fp.float_mod(x, y)
    if name in ("fmin", "imin"):
        return _min_max(x, y, x < y) if name == "fmin" else torch.minimum(x, y)
    if name in ("fmax", "imax"):
        return _min_max(x, y, x > y) if name == "fmax" else torch.maximum(x, y)
    if name == "iadd":
        return x + y
    if name == "isub":
        return x - y
    if name == "imul":
        return x * y
    if name == "imod":
        # jnp.mod on int32: floor modulo; x % 0 and x % -1 are 0 (XLA).
        bad = (y == 0) | (y == -1)
        ys = torch.where(bad, 1, y).to(torch.int32)
        r = torch.fmod(x, ys)
        r = torch.where((r != 0) & ((r < 0) != (ys < 0)), r + ys, r)
        return torch.where(bad, 0, r).to(torch.int32)
    if name == "ineg":
        return torch.neg(x)
    if name == "iabs":
        return torch.abs(x)
    if name == "i2f":
        return x.to(torch.float32)
    if name == "f2i":
        return _f2i(x)
    if name == "b2i":
        return x.to(torch.int32)
    if name == "b2f":
        return x.to(torch.float32)
    if name in ("f2b", "i2b"):
        return x != 0
    if name in ("flt", "ilt"):
        return x < y
    if name in ("fle", "ile"):
        return x <= y
    if name in ("feq", "ieq"):
        return x == y
    if name in ("fne", "ine"):
        return x != y
    if name == "and":
        return x & y
    if name == "or":
        return x | y
    if name == "xor":
        return x ^ y
    if name == "not":
        return ~x
    if name == "sel":
        return torch.where(x, y, z)
    raise AssertionError(name)


def winter_eval_plain(batch: Batch, time, idx, n_inst):
    out = torch.empty((batch.size, N_OUT), dtype=torch.float32, device=time.device)
    for code, (a, n) in zip(batch.codes, batch.segments):
        s = slice(a, a + n)
        out[s] = _run_plain(code, time[s], idx[s], n_inst[s], batch.n_regs)
    return out


def winter_eval(batch: Batch, time, idx, n_inst):
    """KR: every program of ``batch`` over its instances -> [B, 6] float32
    (axis-angle rotation, translation).  ``time`` [B] f32, ``idx`` and
    ``n_inst`` [B] i32.  The twin for CPU tensors, one launch of
    ``csrc/winter.cu`` for CUDA tensors."""
    global launches
    if time.device.type == "cpu":
        return winter_eval_plain(batch, time, idx, n_inst)
    dev = time.device
    b = batch.size
    build.check(time, "time", torch.float32, (b,), dev)
    build.check(idx, "idx", torch.int32, (b,), dev)
    build.check(n_inst, "n_inst", torch.int32, (b,), dev)
    if batch.table.device != dev:
        raise ValueError(f"batch on {batch.table.device}, inputs on {dev}")
    code, seg, blk = batch.views()
    out = torch.empty((b, N_OUT), dtype=torch.float32, device=dev)
    scratch = torch.empty((batch.n_regs * b,), dtype=torch.int32, device=dev)
    build.launch("winter_eval", code, seg, blk, batch.n_blocks, time, idx, n_inst, scratch,
                 b, out)
    launches += 1
    return out
