"""One projected-Jacobi iteration of the contact solve (kernel KC).

Replaces the iteration body and the warm-start pre-apply of
``substrata_tpu/physics/solver.py:solve_contacts`` (:363-401, :427-428):
the FISTA-accelerated projected update of every contact row's (normal,
tangent1, tangent2) impulse, then the impulse application to the bodies
through the per-body incidence table.

Two passes, no atomics, so the result is deterministic:

1. rows: one thread per body covers its K static (ground) rows and sums
   their impulses; one thread per pair entry covers its wm rows, reading
   both bodies' velocities rounded to bf16 (solver.py:289-290), and writes
   the entry's [9] impulse block (linear | angular on a | angular on b)
   rounded to bf16 (:354-355);
2. bodies: one thread per body gathers its CPB table entries, weights them
   by side as ``W`` does (:330-333), accumulates in f32 and updates
   linvel / angvel (:356-360).

``solve_iteration`` launches ``csrc/solve_contacts.cu`` for CUDA tensors
and runs ``solve_iteration_plain`` for CPU tensors.  ``warm=True`` applies
the state's current impulses ``y`` as they are (the warm-start
pre-apply) and leaves the state unchanged.
"""

from __future__ import annotations

import dataclasses

import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.maths import quat as quatm

launches = 0


@dataclasses.dataclass
class ContactRows:
    """Per-step constants of the velocity solve (built by
    physics.solver.solve_contacts).  Static rows are body-blocked [N, K];
    pair rows are [Q entries, wm rows]; the last axis of the [.., 3, 3]
    blocks is xyz and the one before it (normal, tangent1, tangent2)."""

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


@dataclasses.dataclass
class SolveState:
    """FISTA carry: extrapolated (y) and last feasible (l) impulses, last
    axis (normal, tangent1, tangent2)."""

    s_y: torch.Tensor  # [N, K, 3]
    s_l: torch.Tensor
    p_y: torch.Tensor  # [Q, wm, 3]
    p_l: torch.Tensor


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _dir_sum(d, dirs):
    """d[..., 0] dirs[..., 0, :] + d[..., 1] dirs[..., 1, :] + d[..., 2] dirs[..., 2, :]."""
    return (d[..., 0:1] * dirs[..., 0, :] + d[..., 1:2] * dirs[..., 1, :]
            + d[..., 2:3] * dirs[..., 2, :])


def _project(v, dirs, k, target, fric, y, l_old, beta):
    """FISTA projected update of rows [..., 3] from relative velocity v."""
    vn = quatm.dot3(v, dirs[..., 0, :])
    ln = torch.clamp(y[..., 0] + (target - vn) / k[..., 0], min=0.0)
    vt1 = quatm.dot3(v, dirs[..., 1, :])
    vt2 = quatm.dot3(v, dirs[..., 2, :])
    mf = fric * ln
    lt1 = torch.minimum(torch.maximum(y[..., 1] - vt1 / k[..., 1], -mf), mf)
    lt2 = torch.minimum(torch.maximum(y[..., 2] - vt2 / k[..., 2], -mf), mf)
    l_new = torch.stack([ln, lt1, lt2], dim=-1)
    return l_new + beta * (l_new - l_old), l_new


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
        v_s = linvel[:, None, :] + quatm.cross(angvel[:, None, :], rows.s_r)
        s_y, s_l = _project(v_s, rows.s_dir, rows.s_k, rows.s_target,
                            rows.s_fric, st.s_y, st.s_l, beta)
        vv = _bf16(torch.cat([linvel, angvel], dim=1))[rows.p_ab.long()]
        wa, wb = vv[:q, None, :], vv[q:, None, :]
        v_a = wa[..., :3] + quatm.cross(wa[..., 3:], rows.p_ra)
        v_b = wb[..., :3] + quatm.cross(wb[..., 3:], rows.p_rb)
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
    linvel = linvel + rows.im[:, None] * (out_l + dlin_s)
    angvel = angvel + out_a + out_b + dang_s
    return new, linvel, angvel


def solve_iteration(rows: ContactRows, st: SolveState, linvel, angvel,
                    beta: float, warm: bool = False):
    """KC: ``solve_iteration_plain`` for CPU tensors, the two launches of
    ``csrc/solve_contacts.cu`` for CUDA tensors."""
    global launches
    if linvel.device.type == "cpu":
        return solve_iteration_plain(rows, st, linvel, angvel, beta, warm)
    dev = linvel.device
    n, k = rows.s_target.shape
    q, wm = rows.p_target.shape
    cpb = rows.tbl.shape[1]
    f32, i32 = torch.float32, torch.int32
    for t, name, dt, shp in (
            (rows.s_dir, "s_dir", f32, (n, k, 3, 3)), (rows.s_ang, "s_ang", f32, (n, k, 3, 3)),
            (rows.s_r, "s_r", f32, (n, k, 3)), (rows.s_k, "s_k", f32, (n, k, 3)),
            (rows.s_target, "s_target", f32, (n, k)), (rows.s_fric, "s_fric", f32, (n, k)),
            (rows.s_valid, "s_valid", f32, (n, k)),
            (rows.p_dir, "p_dir", f32, (q, wm, 3, 3)),
            (rows.p_ang_a, "p_ang_a", f32, (q, wm, 3, 3)),
            (rows.p_ang_b, "p_ang_b", f32, (q, wm, 3, 3)),
            (rows.p_ra, "p_ra", f32, (q, wm, 3)), (rows.p_rb, "p_rb", f32, (q, wm, 3)),
            (rows.p_k, "p_k", f32, (q, wm, 3)), (rows.p_target, "p_target", f32, (q, wm)),
            (rows.p_fric, "p_fric", f32, (q, wm)), (rows.p_valid, "p_valid", f32, (q, wm)),
            (rows.p_ab, "p_ab", i32, (2 * q,)), (rows.tbl, "tbl", i32, (n, cpb)),
            (rows.w, "w", f32, (n, cpb, 3)), (rows.im, "im", f32, (n,)),
            (st.s_y, "s_y", f32, (n, k, 3)), (st.s_l, "s_l", f32, (n, k, 3)),
            (st.p_y, "p_y", f32, (q, wm, 3)), (st.p_l, "p_l", f32, (q, wm, 3)),
            (linvel, "linvel", f32, (n, 3)), (angvel, "angvel", f32, (n, 3))):
        build.check(t, name, dt, shp, dev)
    new = SolveState(*(torch.empty_like(x) for x in (st.s_y, st.s_l, st.p_y, st.p_l)))
    dlin_s = torch.empty((n, 3), dtype=f32, device=dev)
    dang_s = torch.empty((n, 3), dtype=f32, device=dev)
    block = torch.empty((q, 9), dtype=torch.bfloat16, device=dev)
    build.launch("solve_rows",
                 rows.s_dir, rows.s_ang, rows.s_r, rows.s_k, rows.s_target,
                 rows.s_fric, rows.s_valid, st.s_y, st.s_l,
                 rows.p_dir, rows.p_ang_a, rows.p_ang_b, rows.p_ra, rows.p_rb,
                 rows.p_k, rows.p_target, rows.p_fric, rows.p_valid, rows.p_ab,
                 st.p_y, st.p_l, linvel, angvel,
                 new.s_y, new.s_l, new.p_y, new.p_l, dlin_s, dang_s, block,
                 n, k, q, wm, float(beta), int(bool(warm)))
    lin_out = torch.empty_like(linvel)
    ang_out = torch.empty_like(angvel)
    build.launch("solve_bodies", rows.tbl, rows.w, rows.im, block, dlin_s,
                 dang_s, linvel, angvel, lin_out, ang_out, n, cpb)
    launches += 1
    return new, lin_out, ang_out
