"""One projected-Jacobi iteration of the contact solve (kernel KC), the
whole solve, and the row layout the solve's setup (kernel KQ) writes.

Replaces the iteration body and the warm-start pre-apply of
``substrata_tpu/physics/solver.py:solve_contacts`` (:363-401, :427-428):
the FISTA-accelerated projected update of every contact row's (normal,
tangent1, tangent2) impulse, then the impulse application to the bodies
through the per-body incidence table.

Two ordered launches a pass, no atomics, so the result is deterministic
(``csrc/solve_contacts.cu``):

1. rows: a thread per contact row.  A static (ground) row works on its
   body's f32 velocities; a pair row reads both bodies' velocities rounded
   to bf16 (solver.py:289-290).  The K lanes of a body's static rows fold
   their impulses into the body's static sums, the wm lanes of a pair
   entry into the entry's [9] impulse block (linear | angular on a |
   angular on b) rounded to bf16 (:354-355), in row order;
2. bodies: a thread per body gathers its CPB table entries, weights them
   by side as ``W`` does (:330-333), accumulates in f32 and updates
   linvel / angvel (:356-360).

``solve_iteration`` is one pass (``warm=True`` applies the state's current
impulses ``y`` as they are and leaves the state unchanged): the twin
``solve_iteration_plain`` for CPU tensors, the kernel for CUDA tensors,
checked at every call.  ``solve`` is the warm pass and every iteration:
on the card it checks the rows once and packs all the passes' arguments
once (``_Plan``), then makes one packed launcher call a pass.

The row layout (``row_layout``) is component-major: every field of
``ContactRows`` and ``SolveState`` keeps its documented shape, as a view
whose components are the slowest axis (a [.., 3, 3] block of R rows is
stored [9, R]), so a warp's threads read and write neighbouring words.
KQ's wrapper makes one allocation per step (``SolveWork``) that holds the
rows, the warm impulses and KC's buffers; the rows keep it as ``work``.
"""

from __future__ import annotations

import dataclasses
import math
import struct

import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.maths import fp
from substrata_tpu_torch.maths import quat as quatm

launches = 0
_F32, _I32, _BF16, _BOOL = torch.float32, torch.int32, torch.bfloat16, torch.bool


@dataclasses.dataclass
class ContactRows:
    """Per-step constants of the velocity solve (built by
    physics.solver.solve_contacts).  Static rows are body-blocked [N, K];
    pair rows are [Q entries, wm rows]; the last axis of the [.., 3, 3]
    blocks is xyz and the one before it (normal, tangent1, tangent2).
    ``work`` holds KC's buffers for one solve where KQ allocated them."""

    s_dir: torch.Tensor     # [N, K, 3, 3] (n, t1, t2)
    s_ang: torch.Tensor     # [N, K, 3, 3] Iw (r x d) for each direction
    s_r: torch.Tensor       # [N, K, 3] contact point - body position
    s_k: torch.Tensor       # [N, K, 3] effective mass denominators
    s_target: torch.Tensor  # [N, K] target normal velocity
    s_fric: torch.Tensor    # [N, K]
    s_valid: torch.Tensor   # [N, K] f32 0/1
    p_dir: torch.Tensor     # [Q, wm, 3, 3]
    p_ang_a: torch.Tensor   # [Q, wm, 3, 3]
    p_ang_b: torch.Tensor   # [Q, wm, 3, 3]
    p_ra: torch.Tensor      # [Q, wm, 3]
    p_rb: torch.Tensor      # [Q, wm, 3]
    p_k: torch.Tensor       # [Q, wm, 3]
    p_target: torch.Tensor  # [Q, wm]
    p_fric: torch.Tensor    # [Q, wm]
    p_valid: torch.Tensor   # [Q, wm] f32 0/1
    p_ab: torch.Tensor      # [2Q] i32 entry bodies a then b (gather-safe)
    tbl: torch.Tensor       # [N, CPB] i32 entry per table slot (gather-safe)
    w: torch.Tensor         # [N, CPB, 3] f32 side weights (bf16-exact)
    im: torch.Tensor        # [N] f32 inverse mass (0 while asleep)
    work: SolveWork | None = dataclasses.field(default=None, repr=False)


@dataclasses.dataclass
class SolveState:
    """FISTA carry: extrapolated (y) and last feasible (l) impulses, last
    axis (normal, tangent1, tangent2)."""

    s_y: torch.Tensor  # [N, K, 3]
    s_l: torch.Tensor
    p_y: torch.Tensor  # [Q, wm, 3]
    p_l: torch.Tensor


def _contig(shape):
    strides, acc = [], 1
    for d in reversed(shape):
        strides.append(acc)
        acc *= d
    return tuple(reversed(strides))


def cm_view(flat, lead, comp):
    """The [*lead, *comp] view of ``flat`` stored component-major, i.e. as
    a row-major [*comp, *lead]."""
    nl, nc = len(lead), len(comp)
    return flat.view(*comp, *lead).permute(*range(nc, nc + nl), *range(nc))


def _cm_strides(lead, comp):
    r = math.prod(lead)
    return _contig(lead) + tuple(r * s for s in _contig(comp))


def row_layout(n, k, q, wm, cpb):
    """The row layout KQ writes and KC reads, field -> (lead, comp, dtype):
    each ``ContactRows`` field is a [*lead, *comp] view stored as a
    row-major [*comp, *lead] (``cm_view``).  Static rows lead with (N, K),
    pair rows with (Q, wm), the table and its weights with (N,), stored
    slot-major."""
    s, p, b = (n, k), (q, wm), (n,)
    return {"s_dir": (s, (3, 3), _F32), "s_ang": (s, (3, 3), _F32), "s_r": (s, (3,), _F32),
            "s_k": (s, (3,), _F32), "s_target": (s, (), _F32), "s_fric": (s, (), _F32),
            "s_valid": (s, (), _F32), "p_dir": (p, (3, 3), _F32),
            "p_ang_a": (p, (3, 3), _F32), "p_ang_b": (p, (3, 3), _F32),
            "p_ra": (p, (3,), _F32), "p_rb": (p, (3,), _F32), "p_k": (p, (3,), _F32),
            "p_target": (p, (), _F32), "p_fric": (p, (), _F32), "p_valid": (p, (), _F32),
            "p_ab": ((2 * q,), (), _I32), "tbl": (b, (cpb,), _I32), "w": (b, (cpb, 3), _F32),
            "im": (b, (), _F32)}


_STATE_FIELDS = ("s_y", "s_l", "p_y", "p_l")


def _state_specs(n, k, q, wm):
    return {f: ((n, k) if f[0] == "s" else (q, wm), (3,), _F32) for f in _STATE_FIELDS}


def _in_layout(t, lead, comp, dtype, device):
    return (t.dtype is dtype and t.device == device and t.shape == lead + comp
            and t.stride() == _cm_strides(lead, comp))


def _to_layout(obj, specs, device):
    """``obj``'s fields (ContactRows or SolveState) in the layout, each
    checked; a field in another layout (the twin's row-major tensors) is
    copied into it."""
    out = {}
    for name, (lead, comp, dtype) in specs.items():
        t = getattr(obj, name)
        if not _in_layout(t, lead, comp, dtype, device):
            build.check(t.contiguous() if t.device == device else t, name, dtype, lead + comp,
                        device)
            flat = torch.empty(math.prod(lead + comp), dtype=dtype, device=device)
            view = cm_view(flat, lead, comp)
            view.copy_(t)
            t = view
        out[name] = t
    return out


# One step's regions in KQ's allocation: name -> (dtype, storage shape).
# Row fields of one class share a region ([m, comp, R]: m fields), so one
# strided view and an unbind make them all.
def _regions(n, k, q, wm, cpb):
    s, p = n * k, q * wm
    return (("sblk", _F32, (2, 9, s)), ("pblk", _F32, (3, 9, p)),     # dir, ang(_a, _b)
            ("svec", _F32, (3, 3, s)), ("pvec", _F32, (4, 3, p)),     # r, k, y | ra, rb, k, y
            ("sscal", _F32, (2, s)), ("pscal", _F32, (2, p)),         # target, valid
            ("w", _F32, (cpb, 3, n)), ("im", _F32, (n,)), ("terms", _F32, (n, 16)),
            ("sstate", _F32, (2, 2, 3, s)), ("pstate", _F32, (2, 2, 3, p)),  # [A|B][y|l]
            ("vel", _F32, (2, 2, n, 3)), ("sums", _F32, (2, n, 3)),   # [0|1][lin|ang]
            ("p_ab", _I32, (2 * q,)), ("tbl", _I32, (cpb, n)), ("h", _I32, (s + p,)),
            ("block", _BF16, (q, 9)), ("valid_all", _BOOL, (s + p,)))


_ALIGN = 256
_layouts: dict = {}


def _layout(dims):
    """(byte offset per region, bytes between the fields of a region, total
    bytes) for these sizes, cached."""
    lay = _layouts.get(dims)
    if lay is None:
        off, step, total = {}, {}, 0
        for name, dtype, shape in _regions(*dims):
            off[name] = total
            step[name] = math.prod(shape[1:]) * dtype.itemsize
            total += -(-math.prod(shape) * dtype.itemsize // _ALIGN) * _ALIGN
        step["sstate"] //= 2                     # [A|B][y|l]: one field a step
        step["pstate"] //= 2
        step["vel"] //= 2
        lay = _layouts[dims] = (off, step, max(total, _ALIGN))
    return lay


class SolveWork:
    """One step's buffers for KQ and KC in ONE allocation, each region on a
    256-byte boundary: the rows, the warm impulses, the cache lookup, KQ's
    per-body scratch ``terms`` [N, 16], and KC's two FISTA states and two
    velocity pairs (each pass reads one and writes the other), the static
    sums and the entries' bf16 impulse blocks.  Region pointers are plain
    integers (``ptr``); tensor views are made only for what a caller sees."""

    def __init__(self, dims, device):
        self.dims = dims
        self.off, self.step, total = _layout(dims)
        self.buf = torch.empty(total, dtype=torch.uint8, device=device)
        base = self.buf.data_ptr()
        self.addr = {name: base + o for name, o in self.off.items()}
        self.typed = {}
        self.views = None

    def ptr(self, region, index=0):
        """Address of field ``index`` of a region (its leading axes' slices
        counted as ``_regions`` lays them out: [A|B][y|l] for the states,
        [0|1][lin|ang] for the velocities)."""
        return self.addr[region] + index * self.step[region]

    def _view(self, region, dtype, size, stride, at=0):
        """A view of ``region`` starting ``at`` elements into it."""
        base = self.typed.get(dtype)
        if base is None:
            base = self.typed[dtype] = self.buf.view(dtype)
        return torch.as_strided(base, size, stride, self.off[region] // dtype.itemsize + at)

    def row_views(self):
        """The rows' views (their friction fields excepted), the warm
        impulses y_s and y_p, and the lookup (h, valid_all): a dict."""
        n, k, q, wm, cpb = self.dims
        s, p = n * k, q * wm
        v = {}
        v["s_dir"], v["s_ang"] = self._view("sblk", _F32, (2, n, k, 3, 3),
                                            (9 * s, k, 1, 3 * s, s)).unbind(0)
        v["p_dir"], v["p_ang_a"], v["p_ang_b"] = self._view(
            "pblk", _F32, (3, q, wm, 3, 3), (9 * p, wm, 1, 3 * p, p)).unbind(0)
        v["s_r"], v["s_k"], v["y_s"] = self._view("svec", _F32, (3, n, k, 3),
                                                  (3 * s, k, 1, s)).unbind(0)
        v["p_ra"], v["p_rb"], v["p_k"], v["y_p"] = self._view(
            "pvec", _F32, (4, q, wm, 3), (3 * p, wm, 1, p)).unbind(0)
        v["s_target"], v["s_valid"] = self._view("sscal", _F32, (2, n, k), (s, k, 1)).unbind(0)
        v["p_target"], v["p_valid"] = self._view("pscal", _F32, (2, q, wm),
                                                 (p, wm, 1)).unbind(0)
        v["w"] = self._view("w", _F32, (n, cpb, 3), (1, 3 * n, n))
        v["im"] = self._view("im", _F32, (n,), (1,))
        v["p_ab"] = self._view("p_ab", _I32, (2 * q,), (1,))
        v["tbl"] = self._view("tbl", _I32, (n, cpb), (1, n))
        v["h"] = self._view("h", _I32, (s + p,), (1,))
        v["valid_all"] = self._view("valid_all", _BOOL, (s + p,), (1,))
        self.views = v
        return v

    def state(self, j):
        """FISTA state ``j`` (0 or 1) as a SolveState of views."""
        n, k, q, wm, _ = self.dims
        s, p = n * k, q * wm
        s_y, s_l = self._view("sstate", _F32, (2, n, k, 3), (3 * s, k, 1, s),
                              j * 6 * s).unbind(0)
        p_y, p_l = self._view("pstate", _F32, (2, q, wm, 3), (3 * p, wm, 1, p),
                              j * 6 * p).unbind(0)
        return SolveState(s_y, s_l, p_y, p_l)

    def velocity(self, j):
        """Velocity pair ``j`` (0 or 1): (linvel, angvel) [N, 3] views."""
        n = self.dims[0]
        return tuple(self._view("vel", _F32, (2, n, 3), (3 * n, 3, 1), j * 6 * n).unbind(0))


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _dir_sum(d, dirs):
    """d[..., 0] dirs[..., 0, :] + d[..., 1] dirs[..., 1, :] + d[..., 2] dirs[..., 2, :],
    as the jitted reference contracts the sum: fma(d2, m2, fma(d0, m0, d1 m1))."""
    return fp.fma(d[..., 2:3], dirs[..., 2, :],
                  fp.fma(d[..., 0:1], dirs[..., 0, :], d[..., 1:2] * dirs[..., 1, :]))


def _project(v, dirs, k, target, fric, y, l_old, beta):
    """FISTA projected update of rows [..., 3] from relative velocity v."""
    vn = quatm.dot3_fma(v, dirs[..., 0, :])
    ln = torch.clamp(y[..., 0] + (target - vn) / k[..., 0], min=0.0)
    vt1 = quatm.dot3_fma(v, dirs[..., 1, :])
    vt2 = quatm.dot3_fma(v, dirs[..., 2, :])
    mf = fric * ln
    lt1 = torch.minimum(torch.maximum(y[..., 1] - vt1 / k[..., 1], -mf), mf)
    lt2 = torch.minimum(torch.maximum(y[..., 2] - vt2 / k[..., 2], -mf), mf)
    l_new = torch.stack([ln, lt1, lt2], dim=-1)
    return fp.fma(beta, l_new - l_old, l_new), l_new    # l + beta (l - l0), contracted


def _velocity_update(linvel, im, dlin):
    """linvel + im dlin, contracted as the jitted solve contracts it:
    fma(im, dlin, linvel) in every component."""
    return fp.fma(im[:, None], dlin, linvel)


def _seq_sum(x, dim):
    """Sum over ``dim`` in index order (as the kernels accumulate)."""
    parts = x.unbind(dim)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def solve_iteration_plain(rows: ContactRows, st: SolveState, linvel, angvel,
                          beta: float, warm: bool = False):
    """Returns (state', linvel', angvel')."""
    n, k = rows.s_target.shape
    q = rows.p_target.shape[0]
    if warm:
        ds, dp, new = st.s_y, st.p_y, st
    else:
        v_s = linvel[:, None, :] + quatm.cross_fma(angvel[:, None, :], rows.s_r)
        s_y, s_l = _project(v_s, rows.s_dir, rows.s_k, rows.s_target,
                            rows.s_fric, st.s_y, st.s_l, beta)
        vv = _bf16(torch.cat([linvel, angvel], dim=1))[rows.p_ab.long()]
        wa, wb = vv[:q, None, :], vv[q:, None, :]
        v_a = wa[..., :3] + quatm.cross_fma(wa[..., 3:], rows.p_ra)
        v_b = wb[..., :3] + quatm.cross_fma(wb[..., 3:], rows.p_rb)
        p_y, p_l = _project(v_a - v_b, rows.p_dir, rows.p_k, rows.p_target,
                            rows.p_fric, st.p_y, st.p_l, beta)
        ds, dp = s_y - st.s_y, p_y - st.p_y
        new = SolveState(s_y=s_y, s_l=s_l, p_y=p_y, p_l=p_l)
    sv = rows.s_valid[..., None]
    dlin_s = _seq_sum(_dir_sum(ds, rows.s_dir) * sv, 1)
    dang_s = _seq_sum(_dir_sum(ds, rows.s_ang) * sv, 1)
    pv = rows.p_valid[..., None]
    block = torch.cat([_seq_sum(_dir_sum(dp, rows.p_dir) * pv, 1),
                       _seq_sum(_dir_sum(dp, rows.p_ang_a) * pv, 1),
                       _seq_sum(_dir_sum(dp, rows.p_ang_b) * pv, 1)], dim=1)
    g = block.to(torch.bfloat16)[rows.tbl.long()].to(torch.float32)  # [N, CPB, 9]
    w = rows.w
    out_l = _seq_sum(g[..., 0:3] * w[..., 0:1], 1)
    out_a = _seq_sum(g[..., 3:6] * w[..., 1:2], 1)
    out_b = _seq_sum(g[..., 6:9] * w[..., 2:3], 1)
    linvel = _velocity_update(linvel, rows.im, out_l + dlin_s)
    angvel = angvel + out_a + out_b + dang_s
    return new, linvel, angvel


# The launcher's argument buffer: 35 pointers, N, K, Q, WM, CPB, warm and
# beta as a double (csrc/solve_contacts.cu:solve_pass).
_PASS = struct.Struct("=41qd")
_KQ_FIELDS = ("s_dir", "s_ang", "s_r", "s_k", "s_target", "s_valid", "p_dir", "p_ang_a",
              "p_ang_b", "p_ra", "p_rb", "p_k", "p_target", "p_valid", "p_ab", "tbl", "w", "im")


def _dims(rows: ContactRows):
    n, k = rows.s_target.shape
    q, wm = rows.p_target.shape
    return n, k, q, wm, rows.tbl.shape[1]


def _row_ptrs(rows: ContactRows, dims, device):
    """The rows' pointers for the launcher, (static 7, pair 10, table 3),
    the work buffer that holds them or None, and the tensors behind the
    pointers (the caller holds them until its launches are queued, so
    their memory is not handed out before).  Rows that are still the views
    KQ made (``rows.work``) are known to be in the layout: only their
    friction fields, views of the contacts, are checked.  Any other rows
    are checked field by field and copied into the layout where they are
    not in it."""
    n, k, q, wm, cpb = dims
    work = rows.work
    if work is not None and work.dims == dims and work.buf.device == device \
            and all(getattr(rows, f) is work.views[f] for f in _KQ_FIELDS):
        build.check_all(device, (rows.s_fric, rows.p_fric), ("s_fric", "p_fric"),
                        (_F32, _F32), ((n, k), (q, wm)))
        p = work.ptr
        return ((p("sblk", 0), p("sblk", 1), p("svec", 0), p("svec", 1), p("sscal", 0),
                 rows.s_fric.data_ptr(), p("sscal", 1)),
                (p("pblk", 0), p("pblk", 1), p("pblk", 2), p("pvec", 0), p("pvec", 1),
                 p("pvec", 2), p("pscal", 0), rows.p_fric.data_ptr(), p("pscal", 1), p("p_ab")),
                (p("tbl"), p("w"), p("im"))), work, rows
    r = _to_layout(rows, row_layout(*dims), device)
    return (tuple(r[f].data_ptr() for f in ("s_dir", "s_ang", "s_r", "s_k", "s_target",
                                            "s_fric", "s_valid")),
            tuple(r[f].data_ptr() for f in ("p_dir", "p_ang_a", "p_ang_b", "p_ra", "p_rb",
                                            "p_k", "p_target", "p_fric", "p_valid", "p_ab")),
            tuple(r[f].data_ptr() for f in ("tbl", "w", "im"))), None, r


def _state_ptrs(st: SolveState, dims, device, work):
    """(s_y, s_l, p_y, p_l) pointers of a state: KQ's warm impulses as KQ
    made them, or any state checked (and copied into the layout if it is
    not in it); and the tensors behind them, held as ``_row_ptrs``'s."""
    if work is not None and work.views is not None:
        v = work.views
        if st.s_y is v["y_s"] and st.s_l is v["y_s"] and st.p_y is v["y_p"] \
                and st.p_l is v["y_p"]:
            return (work.ptr("svec", 2),) * 2 + (work.ptr("pvec", 3),) * 2, st
    s = _to_layout(st, _state_specs(*dims[:4]), device)
    return tuple(s[f].data_ptr() for f in _STATE_FIELDS), s


def _check_velocities(linvel, angvel, n, device):
    build.check_all(device, (linvel, angvel), ("linvel", "angvel"), (_F32, _F32),
                    ((n, 3), (n, 3)))


def solve_iteration(rows: ContactRows, st: SolveState, linvel, angvel,
                    beta: float, warm: bool = False):
    """KC, one pass: ``solve_iteration_plain`` for CPU tensors, the two
    launches of ``csrc/solve_contacts.cu`` for CUDA tensors (every argument
    checked; rows or a state in another layout are copied into the row
    layout first).  Returns (state', linvel', angvel')."""
    global launches
    if linvel.device.type == "cpu":
        return solve_iteration_plain(rows, st, linvel, angvel, beta, warm)
    dev = linvel.device
    n, k, q, wm, cpb = dims = _dims(rows)
    # rows_held and st_held live to the end of the call, past the launch.
    (sp, pp, tp), work, rows_held = _row_ptrs(rows, dims, dev)
    st_in, st_held = _state_ptrs(st, dims, dev, work)
    _check_velocities(linvel, angvel, n, dev)
    # One buffer: the new state (component-major), the static sums, the
    # velocities out, the entries' blocks; views only for what is returned.
    s, p = n * k, q * wm
    buf = torch.empty(4 * (6 * (s + p) + 12 * n) + 18 * q, dtype=torch.uint8, device=dev)
    f32 = buf[:4 * (6 * (s + p) + 12 * n)].view(_F32)
    base = buf.data_ptr()
    st_out = (0, 0, 0, 0) if warm else (base, base + 12 * s, base + 24 * s,
                                        base + 24 * s + 12 * p)
    at = 4 * 6 * (s + p)
    build.launch_packed("solve_pass", _PASS.pack(
        *sp, *st_in[:2], *pp, *st_in[2:], linvel.data_ptr(), angvel.data_ptr(), *st_out,
        base + at, base + at + 12 * n, base + at + 48 * n, *tp, base + at + 24 * n,
        base + at + 36 * n, *dims, int(bool(warm)), float(beta)))
    launches += 1
    lin, ang = torch.as_strided(f32, (2, n, 3), (3 * n, 3, 1), at // 4 + 6 * n).unbind(0)
    if warm:
        return st, lin, ang
    s_y, s_l = torch.as_strided(f32, (2, n, k, 3), (3 * s, k, 1, s), 0).unbind(0)
    p_y, p_l = torch.as_strided(f32, (2, q, wm, 3), (3 * p, wm, 1, p), 6 * s).unbind(0)
    return SolveState(s_y, s_l, p_y, p_l), lin, ang


def betas(iters: int):
    """FISTA's beta_k = k/(k+3), 0 on the last iteration so the final
    velocities match the feasible impulses."""
    return [k / (k + 3.0) if k < iters - 1 else 0.0 for k in range(iters)]


class _Plan:
    """One solve on the card: the rows, the warm state and the velocities
    checked once, KC's buffers (``rows.work``, taken once, or allocated),
    and every pass's launcher arguments packed once."""

    def __init__(self, rows: ContactRows, st0: SolveState, linvel, angvel, iters: int,
                 warm: bool):
        dev = linvel.device
        dims = _dims(rows)
        (sp, pp, tp), work, rows_held = _row_ptrs(rows, dims, dev)
        st, st_held = _state_ptrs(st0, dims, dev, work)
        _check_velocities(linvel, angvel, dims[0], dev)
        # A solve's outputs live in its work buffers: hand them to one solve
        # only, so no later solve writes what an earlier one returned.
        rows.work = None
        if work is None:
            work = SolveWork(dims, dev)
        self.keep = (rows, st0, work, linvel, angvel)
        self.held = (rows_held, st_held)
        self.work = work
        p = work.ptr
        tail = (p("sums", 0), p("sums", 1), p("block"), *tp)
        schedule = ([(0.0, True)] if warm else []) + [(b, False) for b in betas(iters)]
        self.passes, vel = [], (linvel.data_ptr(), angvel.data_ptr())
        for i, (beta, is_warm) in enumerate(schedule):
            j = i % 2
            st_out = (0, 0, 0, 0) if is_warm else (p("sstate", 2 * j), p("sstate", 2 * j + 1),
                                                   p("pstate", 2 * j), p("pstate", 2 * j + 1))
            vel_out = (p("vel", 2 * j), p("vel", 2 * j + 1))
            self.passes.append(_PASS.pack(*sp, *st[:2], *pp, *st[2:], *vel, *st_out, *tail,
                                          *vel_out, *dims, int(is_warm), float(beta)))
            st = st if is_warm else st_out
            vel = vel_out
        n_pass = len(schedule)
        self.last = (n_pass - 1) % 2 if n_pass else None
        self.iters = iters

    def run(self):
        """Launch every pass; returns (state, linvel, angvel) as views of
        the work buffer (the last iteration's state; the warm state where
        no iteration ran)."""
        global launches
        for args in self.passes:
            build.launch_packed("solve_pass", args)
            launches += 1
        rows, st0, work, linvel, angvel = self.keep
        if self.last is None:
            return st0, linvel, angvel
        st = work.state(self.last) if self.iters else st0
        return (st, *work.velocity(self.last))


def solve(rows: ContactRows, st0: SolveState, linvel, angvel, iters: int, warm: bool):
    """The warm-start pre-apply (with ``warm``), then ``iters`` FISTA
    iterations.  CPU tensors take the twin pass by pass; CUDA tensors one
    ``_Plan``: checked and packed once, one launcher call a pass.  Returns
    (state, linvel, angvel)."""
    if linvel.device.type == "cpu":
        st = st0
        if warm:
            st, linvel, angvel = solve_iteration_plain(rows, st, linvel, angvel, 0.0, True)
        for beta in betas(iters):
            st, linvel, angvel = solve_iteration_plain(rows, st, linvel, angvel, beta)
        return st, linvel, angvel
    return _Plan(rows, st0, linvel, angvel, iters, warm).run()
