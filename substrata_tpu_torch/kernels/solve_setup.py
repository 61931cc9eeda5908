"""The contact solve's per-step setup and its cache refresh (kernel KQ).

Replaces the part of K6 around the iterations,
``substrata_tpu/physics/solver.py:solve_contacts``: the setup before them
(:156-340, :408-428 — the awake-masked inverse mass, the world inverse
inertia, per static row [N, K] and per pair row [Q, wm] the tangent basis,
r x d, Iw (r x d), the mass-split effective mass, the restitution /
Baumgarte target from the pre-solve relative velocity, and the warm-start
probe of the [H, 5] hash cache with the friction-cone clamp) and the
refresh scatter after them (:449-471).

``solve_setup`` runs ``solve_setup_plain`` for CPU tensors and one launch
of ``csrc/solve_setup.cu`` for CUDA tensors: one thread per body (its
mass terms, its table row and its K static rows) and one per pair entry
(both bodies' terms again, then its wm rows).  ``cache_refresh`` keeps the
last writer of each colliding cache slot, as a sequential scatter does:
on the card, an atomicMax of the row index per slot, then only the
winning row writes (three short kernels in one call).

The pair velocities go through bf16 where the reference rounds them
(:289); the targets divide by the traced ``dt`` (a 0-d tensor here, a
float32 in the kernel), never by its reciprocal.
"""

from __future__ import annotations

import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.kernels.solve import ContactRows
from substrata_tpu_torch.maths import quat as quatm
from substrata_tpu_torch.maths import transform as tmath

launches = {"solve_setup": 0, "cache_refresh": 0}
DEEP = 0.04       # m; the position solve handles anything shallower
_MASK32 = 0xFFFFFFFF


def cache_hash(a, k, size: int):
    """uint32 (a * 2654435761) ^ (k * 40503), masked to the table size."""
    a = a.to(torch.int64) & _MASK32
    k = k.to(torch.int64) & _MASK32
    h = ((a * 2654435761) & _MASK32) ^ ((k * 40503) & _MASK32)
    return h & (size - 1)


def tangent_basis(n):
    """Orthonormal (t1, t2) perpendicular to n [..., 3]."""
    c = (torch.abs(n[..., 0:1]) < 0.9).to(n.dtype)    # x axis, else y axis
    ax = torch.cat([c, 1.0 - c, torch.zeros_like(c)], dim=-1)
    t1 = quatm.cross(ax, n)
    t1 = t1 / torch.clamp(torch.sqrt(quatm.dot3(t1, t1)), min=1e-9)[..., None]
    return t1, quatm.cross(n, t1)


def _mat_vec_rows(iw, v):
    """iw [M, 3, 3] applied to v [M, ..., 3]."""
    shape = (iw.shape[0],) + (1,) * (v.dim() - 2) + (3, 3)
    return tmath.mat_vec(iw.reshape(shape), v)


def _clamp_warm(w, fric, validf):
    ln0 = torch.clamp(w[..., 0], min=0.0) * validf
    mf0 = fric * ln0
    lt1 = torch.minimum(torch.maximum(w[..., 1], -mf0), mf0) * validf
    lt2 = torch.minimum(torch.maximum(w[..., 2], -mf0), mf0) * validf
    return torch.stack([ln0, lt1, lt2], dim=-1)


def solve_setup_plain(body, static_cts, pair_cts, table, sign, baumgarte, restitution_threshold,
                      dt, cache_data, wm: int):
    """Returns (rows, y_s [N, K, 3], y_p [Q, wm, 3], lookup): ``lookup`` is
    (hash slot [S + Q wm] i32, valid [S + Q wm] bool) with a cache, else
    None, and the warm impulses are zeros without one."""
    n = body.capacity
    dev = body.device
    K = static_cts.capacity // n
    Q = pair_cts.capacity // wm
    a_e = pair_cts.a.reshape(Q, wm)[:, 0]
    b_e = pair_cts.b.reshape(Q, wm)[:, 0]
    a_eg = torch.clamp(a_e, min=0).long()
    b_eg = torch.clamp(b_e, min=0).long()
    validf_p = pair_cts.valid.reshape(Q, wm).to(torch.float32)
    validf_s = static_cts.valid.reshape(n, K).to(torch.float32)

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
    t1_s, t2_s = tangent_basis(nrm_s)
    r_s = static_cts.point.reshape(n, K, 3) - body.pos[:, None, :]
    d_s = torch.stack([nrm_s, t1_s, t2_s], dim=2)             # [N, K, 3, 3]
    rx_s = quatm.cross(r_s[:, :, None, :], d_s)
    term_s = _mat_vec_rows(iw, rx_s)                          # Iw (r x d)
    k_s = torch.clamp((inv_mass * c_body)[:, None, None]
                      + quatm.dot3(rx_s, term_s) * c_body[:, None, None], min=1e-9)

    # Pair class: [Q entries, wm rows].
    bview = torch.cat([body.pos, inv_mass[:, None], c_body[:, None],
                       iw.reshape(n, 9)], dim=1)
    va, vb = bview[a_eg], bview[b_eg]
    point_p = pair_cts.point.reshape(Q, wm, 3)
    r_a = point_p - va[:, None, :3]
    r_b = point_p - vb[:, None, :3]
    nrm_p = pair_cts.normal.reshape(Q, wm, 3)
    t1_p, t2_p = tangent_basis(nrm_p)
    d_p = torch.stack([nrm_p, t1_p, t2_p], dim=2)             # [Q, wm, 3, 3]
    ra_x = quatm.cross(r_a[:, :, None, :], d_p)
    rb_x = quatm.cross(r_b[:, :, None, :], d_p)
    term_a = _mat_vec_rows(va[:, 5:14].reshape(Q, 3, 3), ra_x)
    term_b = _mat_vec_rows(vb[:, 5:14].reshape(Q, 3, 3), rb_x)
    c_a, c_b = va[:, 4], vb[:, 4]
    k_p = torch.clamp((va[:, 3] * c_a + vb[:, 3] * c_b)[:, None, None]
                      + quatm.dot3(ra_x, term_a) * c_a[:, None, None]
                      + quatm.dot3(rb_x, term_b) * c_b[:, None, None], min=1e-9)

    # Targets from the pre-solve relative velocities (pairs via bf16).
    v0_s = body.linvel[:, None, :] + quatm.cross(body.angvel[:, None, :], r_s)
    vv = torch.cat([body.linvel, body.angvel], dim=1).to(torch.bfloat16).to(torch.float32)
    wa, wb = vv[a_eg][:, None, :], vv[b_eg][:, None, :]
    v0_p = ((wa[..., :3] + quatm.cross(wa[..., 3:], r_a))
            - (wb[..., :3] + quatm.cross(wb[..., 3:], r_b)))

    def vn_target(pen, rest, vn0):
        rt = torch.where(vn0 < -restitution_threshold, -rest * vn0, -torch.inf)
        bias = torch.where(pen > 0.0,
                           torch.clamp((baumgarte / dt) * torch.clamp(pen - DEEP, min=0.0),
                                       max=3.0),
                           pen / dt)
        return torch.maximum(bias, rt)

    target_s = vn_target(pen_s, rest_s, quatm.dot3(v0_s, nrm_s))
    target_p = vn_target(pair_cts.penetration.reshape(Q, wm),
                         pair_cts.restitution.reshape(Q, wm), quatm.dot3(v0_p, nrm_p))

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

    if cache_data is None:
        return (rows, torch.zeros((n, K, 3), dtype=torch.float32, device=dev),
                torch.zeros((Q, wm, 3), dtype=torch.float32, device=dev), None)

    # Warm start: last step's impulses by contact identity.
    a_all = torch.cat([static_cts.a, pair_cts.a])
    key_all = torch.cat([static_cts.key, pair_cts.key])
    valid_all = torch.cat([static_cts.valid, pair_cts.valid]) & (a_all >= 0)
    h = cache_hash(torch.clamp(a_all, min=0), key_all, cache_data.shape[0])
    row = cache_data[h]
    kk = row[:, 0:2].contiguous().view(torch.int32)
    hit = valid_all & (kk[:, 0] == a_all) & (kk[:, 1] == key_all)
    warm = torch.where(hit[:, None], row[:, 2:5], 0.0)
    y_s = _clamp_warm(warm[:n * K].reshape(n, K, 3), fric_s, validf_s)
    y_p = _clamp_warm(warm[n * K:].reshape(Q, wm, 3), rows.p_fric, validf_p)
    return rows, y_s, y_p, (h.to(torch.int32), valid_all)


def solve_setup(body, static_cts, pair_cts, table, sign, params, dt, cache_data, wm: int):
    """KQ's first launch: (rows, y_s, y_p, lookup) as ``solve_setup_plain``
    returns them.  ``dt`` is a Python number, passed to the kernel as a
    float32 argument (a device tensor would need a sync to read); the CPU
    twin also takes a 0-d tensor."""
    if body.device.type == "cpu":
        dt_t = dt if isinstance(dt, torch.Tensor) else torch.full((), float(dt))
        return solve_setup_plain(body, static_cts, pair_cts, table, sign, params.baumgarte,
                                 params.restitution_threshold, dt_t, cache_data, wm)
    if isinstance(dt, torch.Tensor):
        raise TypeError("solve_setup: on the card dt is a Python number, not a tensor")
    dev = body.device
    n = body.capacity
    K = static_cts.capacity // n
    Q = pair_cts.capacity // wm
    cpb = table.shape[1]
    S, P = n * K, Q * wm
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    checks = [(body.pos, "pos", f32, (n, 3)), (body.quat, "quat", f32, (n, 4)),
              (body.linvel, "linvel", f32, (n, 3)), (body.angvel, "angvel", f32, (n, 3)),
              (body.inv_mass, "inv_mass", f32, (n,)), (body.inv_inertia, "inv_inertia", f32,
                                                       (n, 3)),
              (body.awake, "awake", b8, (n,)), (table, "table", i32, (n, cpb)),
              (sign, "sign", f32, (n, cpb)),
              (params.baumgarte, "baumgarte", f32, ()),
              (params.restitution_threshold, "restitution_threshold", f32, ())]
    for c, cap, tag in ((static_cts, S, "static"), (pair_cts, P, "pair")):
        checks += [(c.a, f"{tag}.a", i32, (cap,)), (c.b, f"{tag}.b", i32, (cap,)),
                   (c.point, f"{tag}.point", f32, (cap, 3)),
                   (c.normal, f"{tag}.normal", f32, (cap, 3)),
                   (c.penetration, f"{tag}.penetration", f32, (cap,)),
                   (c.valid, f"{tag}.valid", b8, (cap,)),
                   (c.friction, f"{tag}.friction", f32, (cap,)),
                   (c.restitution, f"{tag}.restitution", f32, (cap,)),
                   (c.key, f"{tag}.key", i32, (cap,))]
    if cache_data is not None:
        checks.append((cache_data, "cache", f32, (cache_data.shape[0], 5)))
    for t, name, dtype, shp in checks:
        build.check(t, name, dtype, shp, dev)
    e = lambda *shape, dtype=f32: torch.empty(shape, dtype=dtype, device=dev)  # noqa: E731
    rows = ContactRows(
        s_dir=e(n, K, 3, 3), s_ang=e(n, K, 3, 3), s_r=e(n, K, 3), s_k=e(n, K, 3),
        s_target=e(n, K), s_fric=static_cts.friction.reshape(n, K), s_valid=e(n, K),
        p_dir=e(Q, wm, 3, 3), p_ang_a=e(Q, wm, 3, 3), p_ang_b=e(Q, wm, 3, 3),
        p_ra=e(Q, wm, 3), p_rb=e(Q, wm, 3), p_k=e(Q, wm, 3), p_target=e(Q, wm),
        p_fric=pair_cts.friction.reshape(Q, wm), p_valid=e(Q, wm),
        p_ab=e(2 * Q, dtype=i32), tbl=e(n, cpb, dtype=i32), w=e(n, cpb, 3), im=e(n))
    y_s, y_p = e(n, K, 3), e(Q, wm, 3)
    warm = cache_data is not None
    h = e(S + P, dtype=i32) if warm else None
    valid_all = e(S + P, dtype=b8) if warm else None
    build.launch("solve_setup",
                 body.pos, body.quat, body.linvel, body.angvel, body.inv_mass,
                 body.inv_inertia, body.awake, table, sign,
                 static_cts.a, static_cts.point, static_cts.normal, static_cts.penetration,
                 static_cts.valid, static_cts.friction, static_cts.restitution, static_cts.key,
                 pair_cts.a, pair_cts.b, pair_cts.point, pair_cts.normal,
                 pair_cts.penetration, pair_cts.valid, pair_cts.friction,
                 pair_cts.restitution, pair_cts.key,
                 params.baumgarte, params.restitution_threshold, cache_data,
                 n, K, Q, wm, cpb, cache_data.shape[0] if warm else 0, float(dt),
                 rows.s_dir, rows.s_ang, rows.s_r, rows.s_k, rows.s_target, rows.s_valid,
                 rows.p_dir, rows.p_ang_a, rows.p_ang_b, rows.p_ra, rows.p_rb, rows.p_k,
                 rows.p_target, rows.p_valid, rows.p_ab, rows.tbl, rows.w, rows.im,
                 y_s, y_p, h, valid_all)
    launches["solve_setup"] += 1
    return rows, y_s, y_p, ((h, valid_all) if warm else None)


def cache_refresh_plain(cache_data, h, valid_all, static_cts, pair_cts, lam_s, s_valid,
                        lam_p, p_valid):
    """The [H, 5] cache with this step's impulses written at each valid
    row's slot; of rows sharing a slot the last one wins, as a sequential
    scatter (the reference's) keeps it."""
    size = cache_data.shape[0]
    dev = cache_data.device
    a_all = torch.cat([static_cts.a, pair_cts.a])
    key_all = torch.cat([static_cts.key, pair_cts.key])
    lam_all = torch.cat([(lam_s * s_valid[..., None]).reshape(-1, 3),
                         (lam_p * p_valid[..., None]).reshape(-1, 3)])
    dst = torch.where(valid_all, h.long(), size)
    # torch on the card leaves the winner of duplicate indices unspecified.
    order = torch.arange(dst.shape[0], device=dev)
    last = torch.full((size + 1,), -1, dtype=order.dtype,
                      device=dev).scatter_reduce_(0, dst, order, reduce="amax")
    dst = torch.where(last[dst] == order, dst, size)
    new_keys = torch.stack([torch.where(valid_all, a_all, -1),
                            torch.where(valid_all, key_all, 0)], dim=1).to(torch.int32)
    new_row = torch.cat([new_keys.view(torch.float32), lam_all], dim=1)
    data = torch.cat([cache_data, torch.zeros((1, 5), device=dev)])
    data.index_put_((dst,), new_row)
    return data[:size]


def cache_refresh(cache_data, h, valid_all, static_cts, pair_cts, lam_s, s_valid, lam_p,
                  p_valid):
    """KQ's refresh: ``cache_refresh_plain`` for CPU tensors, one call of
    ``csrc/solve_setup.cu:cache_refresh`` for CUDA tensors."""
    if cache_data.device.type == "cpu":
        return cache_refresh_plain(cache_data, h, valid_all, static_cts, pair_cts, lam_s,
                                   s_valid, lam_p, p_valid)
    dev = cache_data.device
    size = cache_data.shape[0]
    n, K = s_valid.shape
    Q, wm = p_valid.shape
    S, P = n * K, Q * wm
    f32, i32 = torch.float32, torch.int32
    for t, name, dtype, shp in ((cache_data, "cache", f32, (size, 5)), (h, "h", i32, (S + P,)),
                                (valid_all, "valid", torch.bool, (S + P,)),
                                (static_cts.a, "static.a", i32, (S,)),
                                (static_cts.key, "static.key", i32, (S,)),
                                (pair_cts.a, "pair.a", i32, (P,)),
                                (pair_cts.key, "pair.key", i32, (P,)),
                                (lam_s, "lam_s", f32, (n, K, 3)), (s_valid, "s_valid", f32, (n, K)),
                                (lam_p, "lam_p", f32, (Q, wm, 3)),
                                (p_valid, "p_valid", f32, (Q, wm))):
        build.check(t, name, dtype, shp, dev)
    out = torch.empty_like(cache_data)
    last = torch.empty((size,), dtype=i32, device=dev)
    build.launch("cache_refresh", cache_data, h, valid_all, static_cts.a, static_cts.key,
                 pair_cts.a, pair_cts.key, lam_s, s_valid, lam_p, p_valid, S, P, size, last,
                 out)
    launches["cache_refresh"] += 1
    return out
