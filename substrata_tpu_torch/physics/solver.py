"""Mass-splitting Jacobi contact solver with warm starting.

Counterpart of ``substrata_tpu/physics/solver.py``.  The per-step setup
(effective masses, targets, warm-start lookup) and the cache refresh go
through kernel KQ (``kernels/solve_setup.py``), every iteration and the
warm-start pre-apply through kernel KC (``kernels/solve.py``, two
launches each on the card); the incidence table (K5) and the position
solve (K7) are plain torch.

Static (ground) rows are body-blocked [N, K]; pair rows are [Q entries, wm
rows] addressed through the per-body entry table.  Pair velocities and
impulse blocks travel as bf16 with f32 accumulation, at the reference's
rounding points.
"""

from __future__ import annotations

import dataclasses

import torch

from substrata_tpu_torch.kernels.solve import ContactRows, SolveState, solve_iteration
from substrata_tpu_torch.kernels.solve_setup import cache_refresh, solve_setup
from substrata_tpu_torch.physics.narrowphase import Contacts
from substrata_tpu_torch.physics.state import (BodyState, SimConfig, SimParams,
                                               _Replace)


@dataclasses.dataclass
class SolverCache(_Replace):
    """Warm-start impulse cache: one [H, 5] f32 row per entry, lanes 0-1
    the int32 (body slot, feature key) identity stored bit for bit, lanes
    2-4 the (normal, tangent1, tangent2) impulses."""

    data: torch.Tensor

    @property
    def size(self):
        return self.data.shape[0]


def empty_solver_cache(size: int = 1 << 17, *, device) -> SolverCache:
    keys = torch.zeros((size, 2), dtype=torch.int32, device=device)
    keys[:, 0] = -1
    return SolverCache(data=torch.cat(
        [keys.view(torch.float32),
         torch.zeros((size, 3), dtype=torch.float32, device=device)], dim=1))


def cache_size_for(config: SimConfig) -> int:
    rows = (config.capacity * config.static_contacts_per_body
            + config.max_active_contacts)
    size = 1
    while size < 2 * rows:
        size <<= 1
    return size



def build_incidence(entry_a, entry_b, entry_occ, n_bodies: int, cpb: int):
    """Per-body entry table.  Returns (table [N, CPB] i32 (-1 empty),
    sign [N, CPB] f32 (+1 body is entry a, -1 entry b), counts [N] f32).
    Entries beyond a body's CPB slots are dropped for that body."""
    c = entry_a.shape[0]
    dev = entry_a.device
    cbits = max(c.bit_length(), 1)
    if n_bodies.bit_length() + cbits + 1 > 32:
        raise ValueError("capacity*entries too large for the packed 32-bit key")
    static_b = entry_b < 0
    cidx = torch.arange(c, dtype=torch.int64, device=dev)
    body_a = torch.where(entry_occ, entry_a.long(), n_bodies)
    body_b = torch.where(entry_occ & ~static_b, entry_b.long(), n_bodies)
    key = torch.cat([(body_a << (cbits + 1)) | (cidx << 1) | 1,
                     (body_b << (cbits + 1)) | (cidx << 1)])
    skey = torch.sort(key).values
    sb = skey >> (cbits + 1)
    idx = torch.arange(2 * c, device=dev)
    start = torch.ones(2 * c, dtype=torch.bool, device=dev)
    start[1:] = sb[1:] != sb[:-1]
    rank = idx - torch.cummax(torch.where(start, idx, 0), dim=0).values
    in_cap = (rank < cpb) & (sb < n_bodies)
    slot = torch.where(in_cap, sb * cpb + rank, n_bodies * cpb)
    entry = skey & ((1 << (cbits + 1)) - 1)
    packed = torch.full((n_bodies * cpb + 1,), -1, dtype=torch.int64, device=dev)
    packed.index_put_((slot,), torch.where(in_cap, entry, -1))
    packed = packed[:-1].reshape(n_bodies, cpb)
    table = torch.where(packed >= 0, packed >> 1, -1).to(torch.int32)
    sign = torch.where(packed >= 0, torch.where((packed & 1) > 0, 1.0, -1.0), 0.0)
    counts = (table >= 0).sum(dim=1).to(torch.float32)
    return table, sign, counts


@dataclasses.dataclass
class SolveSetup:
    """Everything the iterations need, built once per step."""

    rows: ContactRows
    state0: SolveState        # warm-start impulses (zeros without a cache)
    warm: bool                # pre-apply state0 before iterating
    table: torch.Tensor
    sign: torch.Tensor
    lookup: tuple | None      # (hash slot i32, valid) of every row, with a cache


def prepare_solve(body: BodyState, static_cts: Contacts, pair_cts: Contacts,
                  dt, params: SimParams, config: SimConfig,
                  cache: SolverCache | None = None, *,
                  wm: int = 1, table=None, sign=None) -> SolveSetup:
    """Effective masses, targets, side weights and the warm-start lookup
    (kernel KQ on the card, its twin on the CPU); the incidence table (K5)
    is built here in plain torch when the caller has none."""
    n = body.capacity
    if table is None:
        Q = pair_cts.capacity // wm
        a_e = pair_cts.a.reshape(Q, wm)[:, 0]
        b_e = pair_cts.b.reshape(Q, wm)[:, 0]
        valid0 = pair_cts.valid.reshape(Q, wm)[:, 0]
        entry_occ = (a_e >= 0) if wm > 1 else (valid0 & (a_e >= 0))
        table, sign, _ = build_incidence(a_e, b_e, entry_occ, n, config.contacts_per_body)
    rows, y_s, y_p, lookup = solve_setup(body, static_cts, pair_cts, table, sign, params, dt,
                                         None if cache is None else cache.data, wm)
    return SolveSetup(rows, SolveState(y_s, y_s, y_p, y_p), cache is not None, table, sign,
                      lookup)


def iterate(setup: SolveSetup, linvel, angvel, iters: int, step=solve_iteration):
    """Warm-start pre-apply, then ``iters`` FISTA iterations with
    beta_k = k/(k+3), 0 on the last so the final velocities match the
    feasible impulses.  ``step`` is kernel KC (or its plain twin)."""
    st = setup.state0
    if setup.warm:
        st, linvel, angvel = step(setup.rows, st, linvel, angvel, 0.0, True)
    for k in range(iters):
        beta = k / (k + 3.0) if k < iters - 1 else 0.0
        st, linvel, angvel = step(setup.rows, st, linvel, angvel, beta)
    return st, linvel, angvel


def solve_contacts(body: BodyState, static_cts: Contacts, pair_cts: Contacts,
                   dt, params: SimParams, config: SimConfig,
                   cache: SolverCache | None = None, *,
                   wm: int = 1, table=None, sign=None):
    """Two-class warm-started contact solve.

    Returns (linvel, angvel, pair lambda_n [Q, wm], table, sign,
    static lambda_n [N, K], cache')."""
    setup = prepare_solve(body, static_cts, pair_cts, dt, params, config, cache,
                          wm=wm, table=table, sign=sign)
    st, linvel, angvel = iterate(setup, body.linvel, body.angvel, config.solver_iters)
    lam_s, lam_p = st.s_l, st.p_l

    new_cache = None
    if cache is not None:
        h, valid_all = setup.lookup
        new_cache = SolverCache(data=cache_refresh(
            cache.data, h, valid_all, static_cts, pair_cts, lam_s, setup.rows.s_valid, lam_p,
            setup.rows.p_valid))
    return (linvel, angvel, lam_p[..., 0], setup.table, setup.sign, lam_s[..., 0],
            new_cache)


def solve_positions(pos, body: BodyState, static_cts: Contacts,
                    pair_cts: Contacts, table, sign, params: SimParams,
                    config: SimConfig, iters: int = 2, beta: float = 0.25,
                    wm: int = 1):
    """Split-impulse, translation-only position correction."""
    n = body.capacity
    K = static_cts.capacity // n
    Q = pair_cts.capacity // wm
    a_eg = torch.clamp(pair_cts.a.reshape(Q, wm)[:, 0], min=0).long()
    b_eg = torch.clamp(pair_cts.b.reshape(Q, wm)[:, 0], min=0).long()
    validf_p = pair_cts.valid.reshape(Q, wm).to(torch.float32)
    nrm_p = pair_cts.normal.reshape(Q, wm, 3)
    pen_p = pair_cts.penetration.reshape(Q, wm)
    validf_s = static_cts.valid.reshape(n, K).to(torch.float32)
    nrm_s = static_cts.normal.reshape(n, K, 3)
    pen_s = static_cts.penetration.reshape(n, K)

    tbl = torch.clamp(table, min=0).long()
    tbl_valid = (table >= 0).to(torch.float32)[..., None]
    im_per_body = (body.inv_mass * body.awake)[:, None]
    pos0 = pos
    pos0_a, pos0_b = pos[a_eg], pos[b_eg]
    w_sum = torch.clamp(im_per_body[a_eg, 0] + im_per_body[b_eg, 0], min=1e-9)[:, None]
    w_s = torch.clamp(im_per_body[:, 0], min=1e-9)[:, None]
    slop = params.contact_slop
    for i in range(iters):
        if i == 0:
            pen_res_s, pen_res_p = pen_s, pen_p
        else:
            pen_res_s = pen_s - torch.sum((pos - pos0)[:, None, :] * nrm_s, -1)
            dp = ((pos[a_eg] - pos0_a) - (pos[b_eg] - pos0_b))[:, None, :]
            pen_res_p = pen_p - torch.sum(dp * nrm_p, -1)
        push_s = torch.clamp(pen_res_s - slop, min=0.0) * beta
        dpos_s = torch.sum(nrm_s * (push_s / w_s * validf_s)[..., None], dim=1)
        push_p = torch.clamp(pen_res_p - slop, min=0.0) * beta
        imp = torch.sum(nrm_p * (push_p / w_sum * validf_p)[..., None], dim=1)
        g = imp[tbl] * sign[..., None] * tbl_valid
        pos = pos + im_per_body * (torch.sum(g, dim=1) + dpos_s)
    return pos
