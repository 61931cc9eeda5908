"""Mass-splitting Jacobi contact solver with warm starting.

Counterpart of ``substrata_tpu/physics/solver.py``.  The per-step setup
(effective masses, targets, warm-start lookup, cache refresh), the
incidence table (K5) and the position solve (K7) are plain torch; every
iteration and the warm-start pre-apply go through kernel KC
(``kernels/solve.py``, two launches each on the card).

Static (ground) rows are body-blocked [N, K]; pair rows are [Q entries, wm
rows] addressed through the per-body entry table.  Pair velocities and
impulse blocks travel as bf16 with f32 accumulation, at the reference's
rounding points.
"""

from __future__ import annotations

import dataclasses

import torch

from substrata_tpu_torch.kernels.solve import (ContactRows, SolveState,
                                               solve_iteration)
from substrata_tpu_torch.maths import quat as quatm
from substrata_tpu_torch.maths import transform as tmath
from substrata_tpu_torch.physics.narrowphase import Contacts
from substrata_tpu_torch.physics.state import (BodyState, SimConfig, SimParams,
                                               _Replace)

_MASK32 = 0xFFFFFFFF


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


def _cache_hash(a, k, size: int):
    """uint32 (a * 2654435761) ^ (k * 40503), masked to the table size."""
    a = a.to(torch.int64) & _MASK32
    k = k.to(torch.int64) & _MASK32
    h = ((a * 2654435761) & _MASK32) ^ ((k * 40503) & _MASK32)
    return h & (size - 1)


def _tangent_basis(n):
    """Orthonormal (t1, t2) perpendicular to n [..., 3]."""
    c = (torch.abs(n[..., 0:1]) < 0.9).to(n.dtype)    # x axis, else y axis
    ax = torch.cat([c, 1.0 - c, torch.zeros_like(c)], dim=-1)
    t1 = quatm.cross(ax, n)
    t1 = t1 / torch.clamp(torch.sqrt(quatm.dot3(t1, t1)), min=1e-9)[..., None]
    return t1, quatm.cross(n, t1)


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


def _mat_vec_rows(iw, v):
    """iw [M, 3, 3] applied to v [M, ..., 3]."""
    shape = (iw.shape[0],) + (1,) * (v.dim() - 2) + (3, 3)
    return tmath.mat_vec(iw.reshape(shape), v)


@dataclasses.dataclass
class SolveSetup:
    """Everything the iterations need, built once per step."""

    rows: ContactRows
    state0: SolveState        # warm-start impulses (zeros without a cache)
    warm: bool                # pre-apply state0 before iterating
    table: torch.Tensor
    sign: torch.Tensor
    lookup: tuple | None      # (hash slot, a, key, valid) of every row


def prepare_solve(body: BodyState, static_cts: Contacts, pair_cts: Contacts,
                  dt, params: SimParams, config: SimConfig,
                  cache: SolverCache | None = None, *,
                  wm: int = 1, table=None, sign=None) -> SolveSetup:
    """Effective masses, targets, side weights and the warm-start lookup
    (plain torch)."""
    n = body.capacity
    dev = body.device
    cpb = config.contacts_per_body
    K = static_cts.capacity // n
    Q = pair_cts.capacity // wm
    a_rows = pair_cts.a
    a_e = a_rows.reshape(Q, wm)[:, 0]
    b_e = pair_cts.b.reshape(Q, wm)[:, 0]
    a_eg = torch.clamp(a_e, min=0).long()
    b_eg = torch.clamp(b_e, min=0).long()
    valid_p = pair_cts.valid.reshape(Q, wm)
    validf_p = valid_p.to(torch.float32)
    validf_s = static_cts.valid.reshape(n, K).to(torch.float32)

    if table is None:
        entry_occ = (a_e >= 0) if wm > 1 else (valid_p[:, 0] & (a_e >= 0))
        table, sign, _ = build_incidence(a_e, b_e, entry_occ, n, cpb)
    counts = (table >= 0).sum(dim=1).to(torch.float32) * wm + validf_s.sum(dim=1)
    # Sleeping bodies are immovable inside the solve.
    awakef = body.awake.to(torch.float32)
    inv_mass = body.inv_mass * awakef
    iw = tmath.world_inv_inertia(body.quat, body.inv_inertia * awakef[:, None])
    c_body = torch.clamp(counts, min=1.0)

    # Static class: dense [N, K].
    nrm_s = static_cts.normal.reshape(n, K, 3)
    pen_s = static_cts.penetration.reshape(n, K)
    fric_s = static_cts.friction.reshape(n, K)
    rest_s = static_cts.restitution.reshape(n, K)
    t1_s, t2_s = _tangent_basis(nrm_s)
    r_s = static_cts.point.reshape(n, K, 3) - body.pos[:, None, :]
    d_s = torch.stack([nrm_s, t1_s, t2_s], dim=2)             # [N, K, 3, 3]
    rx_s = quatm.cross(r_s[:, :, None, :], d_s)
    term_s = _mat_vec_rows(iw, rx_s)                          # Iw (r x d)
    k_s = torch.clamp((inv_mass * c_body)[:, None, None]
                      + torch.sum(rx_s * term_s, -1) * c_body[:, None, None], min=1e-9)

    # Pair class: [Q entries, wm rows].
    bview = torch.cat([body.pos, inv_mass[:, None], c_body[:, None],
                       iw.reshape(n, 9)], dim=1)
    va, vb = bview[a_eg], bview[b_eg]
    point_p = pair_cts.point.reshape(Q, wm, 3)
    r_a = point_p - va[:, None, :3]
    r_b = point_p - vb[:, None, :3]
    nrm_p = pair_cts.normal.reshape(Q, wm, 3)
    t1_p, t2_p = _tangent_basis(nrm_p)
    d_p = torch.stack([nrm_p, t1_p, t2_p], dim=2)             # [Q, wm, 3, 3]
    ra_x = quatm.cross(r_a[:, :, None, :], d_p)
    rb_x = quatm.cross(r_b[:, :, None, :], d_p)
    term_a = _mat_vec_rows(va[:, 5:14].reshape(Q, 3, 3), ra_x)
    term_b = _mat_vec_rows(vb[:, 5:14].reshape(Q, 3, 3), rb_x)
    c_a, c_b = va[:, 4], vb[:, 4]
    k_p = torch.clamp((va[:, 3] * c_a + vb[:, 3] * c_b)[:, None, None]
                      + torch.sum(ra_x * term_a, -1) * c_a[:, None, None]
                      + torch.sum(rb_x * term_b, -1) * c_b[:, None, None], min=1e-9)

    # Targets from the pre-solve relative velocities (pairs via bf16).
    v0_s = body.linvel[:, None, :] + quatm.cross(body.angvel[:, None, :], r_s)
    vv = torch.cat([body.linvel, body.angvel], dim=1).to(torch.bfloat16).to(torch.float32)
    wa, wb = vv[a_eg][:, None, :], vv[b_eg][:, None, :]
    v0_p = ((wa[..., :3] + quatm.cross(wa[..., 3:], r_a))
            - (wb[..., :3] + quatm.cross(wb[..., 3:], r_b)))
    deep = 0.04  # m; the position solve handles anything shallower

    def vn_target(pen, rest, vn0):
        rt = torch.where(vn0 < -params.restitution_threshold, -rest * vn0, -torch.inf)
        bias = torch.where(pen > 0.0,
                           torch.clamp((params.baumgarte / dt)
                                       * torch.clamp(pen - deep, min=0.0), max=3.0),
                           pen / dt)
        return torch.maximum(bias, rt)

    target_s = vn_target(pen_s, rest_s, torch.sum(v0_s * nrm_s, -1))
    target_p = vn_target(pair_cts.penetration.reshape(Q, wm),
                         pair_cts.restitution.reshape(Q, wm), torch.sum(v0_p * nrm_p, -1))

    signv = sign * (table >= 0)
    rows = ContactRows(
        s_dir=d_s.contiguous(), s_ang=term_s.contiguous(), s_r=r_s.contiguous(),
        s_k=k_s.contiguous(), s_target=target_s.contiguous(),
        s_fric=fric_s.contiguous(), s_valid=validf_s.contiguous(),
        p_dir=d_p.contiguous(), p_ang_a=term_a.contiguous(),
        p_ang_b=term_b.contiguous(), p_ra=r_a.contiguous(), p_rb=r_b.contiguous(),
        p_k=k_p.contiguous(), p_target=target_p.contiguous(),
        p_fric=pair_cts.friction.reshape(Q, wm).contiguous(),
        p_valid=validf_p.contiguous(),
        p_ab=torch.cat([a_eg, b_eg]).to(torch.int32),
        tbl=torch.clamp(table, min=0).to(torch.int32).contiguous(),
        w=torch.stack([signv, torch.clamp(signv, min=0.0), torch.clamp(signv, max=0.0)],
                      dim=2).contiguous(),
        im=inv_mass.contiguous())

    if cache is None:
        z_s = torch.zeros((n, K, 3), dtype=torch.float32, device=dev)
        z_p = torch.zeros((Q, wm, 3), dtype=torch.float32, device=dev)
        return SolveSetup(rows, SolveState(z_s, z_s, z_p, z_p), False, table, sign, None)

    # Warm start: last step's impulses by contact identity.
    a_all = torch.cat([static_cts.a, a_rows])
    key_all = torch.cat([static_cts.key, pair_cts.key])
    valid_all = torch.cat([static_cts.valid, pair_cts.valid]) & (a_all >= 0)
    h = _cache_hash(torch.clamp(a_all, min=0), key_all, cache.size)
    row = cache.data[h]
    kk = row[:, 0:2].contiguous().view(torch.int32)
    hit = valid_all & (kk[:, 0] == a_all) & (kk[:, 1] == key_all)
    warm = torch.where(hit[:, None], row[:, 2:5], 0.0)

    def clamp_warm(w, fric, validf):
        ln0 = torch.clamp(w[..., 0], min=0.0) * validf
        mf0 = fric * ln0
        lt1 = torch.minimum(torch.maximum(w[..., 1], -mf0), mf0) * validf
        lt2 = torch.minimum(torch.maximum(w[..., 2], -mf0), mf0) * validf
        return torch.stack([ln0, lt1, lt2], dim=-1)

    y_s = clamp_warm(warm[:n * K].reshape(n, K, 3), fric_s, validf_s)
    y_p = clamp_warm(warm[n * K:].reshape(Q, wm, 3), rows.p_fric, validf_p)
    return SolveSetup(rows, SolveState(y_s, y_s, y_p, y_p), True, table, sign,
                      (h, a_all, key_all, valid_all))


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
        h, a_all, key_all, valid_all = setup.lookup
        rows = setup.rows
        lam_all = torch.cat([(lam_s * rows.s_valid[..., None]).reshape(-1, 3),
                             (lam_p * rows.p_valid[..., None]).reshape(-1, 3)])
        dst = torch.where(valid_all, h, cache.size)
        # Colliding hash slots keep their last writer, as a sequential
        # scatter does (the reference's, and torch's on the CPU); torch on
        # the card leaves the winner of duplicate indices unspecified.
        order = torch.arange(dst.shape[0], device=body.device)
        last = torch.full((cache.size + 1,), -1, dtype=order.dtype,
                          device=body.device).scatter_reduce_(0, dst, order, reduce="amax")
        dst = torch.where(last[dst] == order, dst, cache.size)
        new_keys = torch.stack([torch.where(valid_all, a_all, -1),
                                torch.where(valid_all, key_all, 0)], dim=1).to(torch.int32)
        new_row = torch.cat([new_keys.view(torch.float32), lam_all], dim=1)
        data = torch.cat([cache.data, torch.zeros((1, 5), device=body.device)])
        data.index_put_((dst,), new_row)
        new_cache = SolverCache(data=data[:cache.size])
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
