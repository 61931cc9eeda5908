"""The strike wake and the sleep pass (kernel KV).

Replaces K8's sleeping: ``substrata_tpu/physics/step.py:103-117`` (a
sleeper paired with a fast awake body joins this step's solve),
``step.py:166-187`` (the entry reductions over each entry's rows and the
deep static contacts), ``substrata_tpu/physics/integrate.py:update_sleeping``
(:103: the timers, the wake through the incidence table, the kinematic rule
and the velocity zeroing) and ``step.py:216-224`` (a fast wake forces the
next step to rebuild its pairs).

``strike_wake`` and ``sleep_pass`` run their ``*_plain`` twins for CPU
tensors and the launches of ``csrc/sleep.cu`` for CUDA ones: the sleep
pass one launch a call, a lane per incidence slot (up to 32 a body, fewer
where the bodies alone near fill the card: ``MAX_THREADS``).  Squared
speeds sum as (x² + y²) + z² in both.
"""

from __future__ import annotations

import dataclasses
import struct

import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.physics.state import MotionType

launches = {"strike_wake": 0, "sleep_pass": 0}


def _len2(v):
    return (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2]


def strike_wake_plain(awake, linvel, alive, motion_type, pair_a, pair_b, pair_valid):
    n = awake.shape[0]
    striker = awake & (_len2(linvel) > 0.25)
    pa_s = torch.clamp(pair_a, min=0).long()
    pb_s = torch.clamp(pair_b, min=0).long()
    dst_a = torch.where(pair_valid & striker[pb_s], pa_s, n)
    dst_b = torch.where(pair_valid & striker[pa_s], pb_s, n)
    struck = torch.zeros((n + 1,), dtype=torch.bool, device=awake.device)
    struck.index_fill_(0, dst_a, True).index_fill_(0, dst_b, True)
    dynamic = motion_type == int(MotionType.DYNAMIC)
    return awake | (struck[:n] & alive & dynamic)


def strike_wake(awake, linvel, alive, motion_type, pair_a, pair_b, pair_valid):
    """KV (a): the awake flags after the pre-solve strike wake: a sleeping
    dynamic body paired with an awake body faster than 0.5 m/s wakes."""
    if awake.device.type == "cpu":
        return strike_wake_plain(awake, linvel, alive, motion_type, pair_a, pair_b,
                                 pair_valid)
    dev = awake.device
    n, p = awake.shape[0], pair_a.shape[0]
    for t, name, dt, shp in ((awake, "awake", torch.bool, (n,)),
                             (linvel, "linvel", torch.float32, (n, 3)),
                             (alive, "alive", torch.bool, (n,)),
                             (motion_type, "motion_type", torch.int32, (n,)),
                             (pair_a, "pair_a", torch.int32, (p,)),
                             (pair_b, "pair_b", torch.int32, (p,)),
                             (pair_valid, "pair_valid", torch.bool, (p,))):
        build.check(t, name, dt, shp, dev)
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    build.launch("strike_wake", awake, linvel, alive, motion_type, pair_a, pair_b, pair_valid,
                 n, p, out)
    launches["strike_wake"] += 1
    return out


def update_sleeping_plain(body, linvel, angvel, contact_a, contact_b, contact_impulse,
                          contact_valid, incidence_table, incidence_sign, dt, params,
                          contact_pen=None, extra_deep=None):
    """Velocity-threshold sleeping with contact-driven waking through the
    per-body incidence table (integrate.py:update_sleeping).  Returns
    (awake, sleep_timer, linvel, angvel)."""
    lin2 = _len2(linvel)
    ang2 = _len2(angvel)
    slow = (lin2 < params.sleep_lin_vel ** 2) & (ang2 < params.sleep_ang_vel ** 2)
    # Woken by an impulse from an ACTIVE (awake, above threshold)
    # counterpart, or by touching an awake fast one.
    fast = body.awake & ((lin2 > 4.0 * params.sleep_lin_vel ** 2)
                         | (ang2 > 4.0 * params.sleep_ang_vel ** 2))
    active = body.awake & ~slow
    imp_sig = contact_valid & (contact_impulse > 1e-4)
    tbl = torch.clamp(incidence_table, min=0).long()
    tbl_ok = incidence_table >= 0
    iam_a = incidence_sign > 0
    deep = (contact_valid & (contact_pen > 0.1) if contact_pen is not None
            else torch.zeros_like(contact_valid))
    other = torch.where(iam_a, contact_b[tbl], contact_a[tbl])
    other_static = other < 0
    oth = torch.clamp(other, min=0).long()
    other_active = torch.where(other_static, False, active[oth])
    other_fast = torch.where(other_static, False, fast[oth])
    slot_wake = tbl_ok & ((imp_sig[tbl] & other_active)
                          | (contact_valid[tbl] & other_fast))
    wake_hit = torch.any(slot_wake, dim=1)
    # A deeply penetrating body must not sleep: depenetration keeps working.
    body_deep = torch.any(tbl_ok & deep[tbl], dim=1)
    if extra_deep is not None:
        body_deep = body_deep | extra_deep

    dyn = body.dynamic & body.alive
    timer = torch.where(slow & ~wake_hit & ~body_deep, body.sleep_timer + dt, 0.0)
    asleep = dyn & (timer > params.sleep_time)
    woken = dyn & ~body.awake & wake_hit
    awake = torch.where(dyn, (~asleep) & (body.awake | woken), body.awake)
    kin = body.alive & (body.motion_type == int(MotionType.KINEMATIC))
    awake = torch.where(kin, (lin2 + ang2) > 1e-10, awake)
    sleeping = (dyn & ~awake)[:, None]
    linvel = torch.where(sleeping, 0.0, linvel)
    angvel = torch.where(sleeping, 0.0, angvel)
    return awake, timer, linvel, angvel


@dataclasses.dataclass
class SleepOut:
    awake: torch.Tensor         # [N] bool
    sleep_timer: torch.Tensor   # [N] f32
    linvel: torch.Tensor        # [N, 3]
    angvel: torch.Tensor        # [N, 3]
    newly_awake: torch.Tensor   # [N] bool
    newly_asleep: torch.Tensor  # [N] bool
    steps_left: torch.Tensor    # [] i32 (0 after a fast wake)


def sleep_pass_plain(body, prev_awake, linvel, angvel, static_rows, pair_rows, lambda_p,
                     table, sign, wm: int, dt, params, steps_left):
    """The twin.  ``static_rows`` = (valid, penetration) of N*K rows;
    ``pair_rows`` = (a, b, valid, penetration) of Q*wm rows; ``lambda_p``
    [Q, wm]."""
    n = body.capacity
    s_valid, s_pen = static_rows
    c_a, c_b, c_valid, c_pen = pair_rows
    k_s = s_valid.shape[0] // n
    deep_static = torch.any((s_valid & (s_pen > 0.1)).reshape(n, k_s), dim=1)
    n_e = c_a.shape[0] // wm
    row_valid = c_valid.reshape(n_e, wm)
    e_a = c_a.reshape(n_e, wm)[:, 0]
    e_b = c_b.reshape(n_e, wm)[:, 0]
    e_valid = torch.any(row_valid, dim=1)
    e_imp = torch.where(row_valid, lambda_p, 0.0).max(dim=1).values
    e_pen = torch.where(row_valid, c_pen.reshape(n_e, wm), -1e9).max(dim=1).values
    awake, timer, linvel, angvel = update_sleeping_plain(
        body, linvel, angvel, e_a, e_b, e_imp, e_valid, table, sign, dt, params,
        contact_pen=e_pen, extra_deep=deep_static)
    newly_awake = awake & ~prev_awake
    # Only FAST wakes force a pair rebuild (slow ones stay inside the
    # rebuild's 8 cm base margin for the rest of the window).
    woke_speed = torch.where(newly_awake, torch.sqrt(_len2(linvel)), 0.0)
    fast_wake = woke_speed.max() > 1.0
    return SleepOut(awake, timer, linvel, angvel, newly_awake, prev_awake & ~awake,
                    torch.where(fast_wake, 0, steps_left).to(torch.int32))


# csrc/sleep.cu:SleepArgs: 20 inputs, the ticket and the output buffer;
# lambda's row stride, N, wm, K, CPB, log2 of the lanes a body; dt.
_PACK = struct.Struct("=22q6qd")
MAX_WM = 8          # csrc/sleep.cu:kMaxWm
# Lanes a body: CPB's (up to 32, a power of two) while N x lanes stays within
# this many threads, fewer past it.  A lane a slot takes a body's slots off
# one thread's serial walk; where the bodies alone come near filling the
# card, more lanes only add loads (PERF.md, K8: bench_halo_sleep.py's lane
# sweep, 8 lanes the fastest at 10,240 bodies, 1 at 65,536).
MAX_THREADS = 100_000
_plans = {}
_NAMES = ("awake", "prev_awake", "sleep_timer", "alive", "motion_type", "linvel", "angvel",
          "contact a", "contact b", "contact valid", "contact penetration", "static valid",
          "static penetration", "table", "sign", "sleep_lin_vel", "sleep_ang_vel", "sleep_time",
          "steps_left")


class _Plan:
    """The sleep pass's checks and ticket for one (N, rows, wm, K, CPB,
    device, stream): the inputs' dtypes and shapes in the kernel's order,
    the lanes a body (see ``MAX_THREADS``), and a 64-bit word (the blocks
    done and those with a fast or a NaN wake) that every launch leaves zero
    for the next; keyed by stream, so launches that share it run in stream
    order."""

    def __init__(self, n, rows, wm, k, cpb, device):
        f32, i32, b8 = torch.float32, torch.int32, torch.bool
        if not 1 <= wm <= MAX_WM:
            raise ValueError(f"sleep_pass: wm = {wm}, the kernel takes 1 to {MAX_WM}")
        if n < 1:
            raise ValueError("sleep_pass: no bodies")
        self.device = device
        self.dtypes = (b8, b8, f32, b8, i32, f32, f32, i32, i32, b8, f32, b8, f32, i32, f32,
                       f32, f32, f32, i32)
        self.shapes = ((n,), (n,), (n,), (n,), (n,), (n, 3), (n, 3), (rows,), (rows,), (rows,),
                       (rows,), (n * k,), (n * k,), (n, cpb), (n, cpb), (), (), (), ())
        self.g_shift = min((min(max(cpb, 1), 32) - 1).bit_length(),
                           max(MAX_THREADS // n, 1).bit_length() - 1)
        self.ticket = torch.zeros(1, dtype=torch.int64, device=device)


def sleep_pass(body, prev_awake, linvel, angvel, static_rows, pair_rows, lambda_p, table,
               sign, wm: int, dt, params, steps_left) -> SleepOut:
    """KV (b): the post-solve sleep pass and its tail, for the step.  On the
    card one launch from one packed argument, checked against a plan of
    its shape; the outputs are views of one allocation."""
    if linvel.device.type == "cpu":
        return sleep_pass_plain(body, prev_awake, linvel, angvel, static_rows, pair_rows,
                                lambda_p, table, sign, wm, dt, params, steps_left)
    dev = linvel.device
    n = body.capacity
    s_valid, s_pen = static_rows
    c_a, c_b, c_valid, c_pen = pair_rows
    K = s_valid.shape[0] // n
    rows = c_a.shape[0]
    q = rows // wm
    cpb = table.shape[1]
    # lambda_p is [Q, wm], usually a strided view of the solver's impulses.
    lam, ls = lambda_p, lambda_p.stride(1)
    if tuple(lam.shape) != (q, wm) or lam.stride(0) != wm * ls or lam.dtype != torch.float32 \
            or lam.device != dev:
        raise ValueError(f"lambda_p: expected float32 [{q}, {wm}] at strides (wm * s, s) "
                         f"on {dev}")
    key = (n, rows, wm, K, cpb, dev, build.stream())
    plan = build.plan(_plans, key, lambda: _Plan(n, rows, wm, K, cpb, dev))
    ins = (body.awake, prev_awake, body.sleep_timer, body.alive, body.motion_type, linvel,
           angvel, c_a, c_b, c_valid, c_pen, s_valid, s_pen, table, sign, params.sleep_lin_vel,
           params.sleep_ang_vel, params.sleep_time, steps_left)
    build.check_all(plan.device, ins, _NAMES, plan.dtypes, plan.shapes)
    # One buffer (csrc/sleep.cu:SleepArgs.out): timer, linvel, angvel (f32),
    # steps_left (i32), then the awake, newly_awake and newly_asleep flags.
    ints = torch.empty((7 * n + 1 + (3 * n + 3) // 4,), dtype=torch.int32, device=dev)
    timer, lin_o, ang_o = ints[:7 * n].view(torch.float32).split([n, 3 * n, 3 * n])
    flags = ints[7 * n + 1:].view(torch.bool)
    flags = flags.split([n, n, n, flags.shape[0] - 3 * n])
    try:
        build.launch_packed("sleep_pass", _PACK.pack(
            *(t.data_ptr() for t in ins[:11]), lam.data_ptr(),
            *(t.data_ptr() for t in ins[11:]), plan.ticket.data_ptr(), ints.data_ptr(), ls, n,
            wm, K, cpb, plan.g_shift, float(dt)))
    except RuntimeError:
        # A launch that failed may leave the ticket set: the next call
        # gets a zeroed plan.
        _plans.pop(key, None)
        raise
    launches["sleep_pass"] += 1
    return SleepOut(flags[0], timer, lin_o.view(n, 3), ang_o.view(n, 3), flags[1], flags[2],
                    ints[7 * n])
