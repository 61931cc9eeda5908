"""The position solve (kernel KU).

Replaces K7, ``substrata_tpu/physics/solver.py:solve_positions`` (:477):
two split-impulse, translation-only iterations after integration.  Each
iteration pushes every penetrating static row and pair entry apart by
``max(pen - slop, 0) * beta``, shared by inverse mass, and moves each body
by its static pushes plus its entries' impulses gathered through the
incidence table.

``solve_positions`` runs ``solve_positions_plain`` for CPU tensors and,
for CUDA ones, ``csrc/positions.cu``: one launch an iteration, each body
computing its own entries' impulses (a group of lanes a body, a slot a
lane), from one packed argument checked against a plan of its shape.  The
twin's sums run in an explicit order (the first term, then each next one
added), which the kernel repeats.
"""

from __future__ import annotations

import struct

import torch

from substrata_tpu_torch.kernels import build

launches = 0


def _seq_sum(x, dim: int):
    """Sum over ``dim`` as first + second + ... (left to right)."""
    s = x.select(dim, 0)
    for k in range(1, x.shape[dim]):
        s = s + x.select(dim, k)
    return s


def _dot3(a, b):
    """(a0 b0 + a1 b1) + a2 b2 over the trailing axis."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _entry_first_row(x, q: int, wm: int):
    return x.reshape(q, wm)[:, 0]


def solve_positions_plain(pos, inv_mass, awake, static_rows, pair_rows, table, sign, slop,
                          iters: int, beta: float, wm: int):
    """The twin.  ``static_rows`` = (valid [N*K], normal [N*K, 3], pen
    [N*K]); ``pair_rows`` = (a, b, valid, normal, pen) of Q*wm rows."""
    n = pos.shape[0]
    s_valid, s_normal, s_pen = static_rows
    p_a, p_b, p_valid, p_normal, p_pen = pair_rows
    K = s_valid.shape[0] // n
    Q = p_a.shape[0] // wm
    a_eg = torch.clamp(_entry_first_row(p_a, Q, wm), min=0).long()
    b_eg = torch.clamp(_entry_first_row(p_b, Q, wm), min=0).long()
    validf_p = p_valid.reshape(Q, wm).to(torch.float32)
    nrm_p = p_normal.reshape(Q, wm, 3)
    pen_p = p_pen.reshape(Q, wm)
    validf_s = s_valid.reshape(n, K).to(torch.float32)
    nrm_s = s_normal.reshape(n, K, 3)
    pen_s = s_pen.reshape(n, K)

    tbl = torch.clamp(table, min=0).long()
    tbl_valid = (table >= 0).to(torch.float32)[..., None]
    im_per_body = (inv_mass * awake)[:, None]
    pos0 = pos
    pos0_a, pos0_b = pos[a_eg], pos[b_eg]
    w_sum = torch.clamp(im_per_body[a_eg, 0] + im_per_body[b_eg, 0], min=1e-9)[:, None]
    w_s = torch.clamp(im_per_body[:, 0], min=1e-9)[:, None]
    for i in range(iters):
        if i == 0:
            pen_res_s, pen_res_p = pen_s, pen_p
        else:
            pen_res_s = pen_s - _dot3((pos - pos0)[:, None, :], nrm_s)
            dp = ((pos[a_eg] - pos0_a) - (pos[b_eg] - pos0_b))[:, None, :]
            pen_res_p = pen_p - _dot3(dp, nrm_p)
        push_s = torch.clamp(pen_res_s - slop, min=0.0) * beta
        dpos_s = _seq_sum(nrm_s * (push_s / w_s * validf_s)[..., None], 1)
        push_p = torch.clamp(pen_res_p - slop, min=0.0) * beta
        imp = _seq_sum(nrm_p * (push_p / w_sum * validf_p)[..., None], 1)
        g = imp[tbl] * sign[..., None] * tbl_valid
        pos = pos + im_per_body * (_seq_sum(g, 1) + dpos_s)
    return pos


# csrc/positions.cu:PositionsArgs: 14 input pointers, the scratch and the output;
# N, K, Q, WM, CPB, iters; beta.
_PACK = struct.Struct("=16q6qd")
MAX_WM = 8          # csrc/positions.cu:kMaxRows
_plans = {}
_NAMES = ("pos", "inv_mass", "awake", "static valid", "static normal", "static penetration",
          "pair a", "pair b", "pair valid", "pair normal", "pair penetration", "table", "sign",
          "contact_slop")


class _Plan:
    """KU's checks for one (N, K, Q, WM, CPB, device): the 14 inputs'
    dtypes and shapes in the kernel's order."""

    def __init__(self, n, k, q, wm, cpb, device):
        f32, i32, bl = torch.float32, torch.int32, torch.bool
        if not 1 <= wm <= MAX_WM:
            raise ValueError(f"solve_positions: wm = {wm}, the kernel takes 1 to {MAX_WM}")
        self.device = device
        self.dtypes = (f32, f32, bl, bl, f32, f32, i32, i32, bl, f32, f32, i32, f32, f32)
        self.shapes = ((n, 3), (n,), (n,), (n * k,), (n * k, 3), (n * k,), (q * wm,), (q * wm,),
                       (q * wm,), (q * wm, 3), (q * wm,), (n, cpb), (n, cpb), ())


def solve_positions(pos, inv_mass, awake, static_rows, pair_rows, table, sign, slop,
                    iters: int = 2, beta: float = 0.25, wm: int = 1):
    """KU: the corrected positions [N, 3] (a new tensor)."""
    if pos.device.type == "cpu":
        return solve_positions_plain(pos, inv_mass, awake, static_rows, pair_rows, table,
                                     sign, slop, iters, beta, wm)
    global launches
    dev = pos.device
    n = pos.shape[0]
    k = static_rows[0].shape[0] // max(n, 1)
    q = pair_rows[0].shape[0] // wm
    cpb = table.shape[1]
    plan = build.plan(_plans, (n, k, q, wm, cpb, dev), lambda: _Plan(n, k, q, wm, cpb, dev))
    ins = (pos, inv_mass, awake) + tuple(static_rows) + tuple(pair_rows) + (table, sign, slop)
    build.check_all(plan.device, ins, _NAMES, plan.dtypes, plan.shapes)
    if iters == 0:
        return pos.clone()
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    # A scratch only where an iteration lands outside ``out``, held until
    # the launch is queued: freed earlier, another thread's allocation on
    # this stream could take its memory before the kernel writes it.
    scratch = torch.empty((n, 3), dtype=torch.float32, device=dev) if iters > 1 else None
    build.launch_packed("solve_positions", _PACK.pack(
        *(t.data_ptr() for t in ins), 0 if scratch is None else scratch.data_ptr(),
        out.data_ptr(), n, k, q, wm, cpb, iters, float(beta)))
    launches += 1
    return out
