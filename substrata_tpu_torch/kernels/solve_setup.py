"""The contact solve's per-step setup and its cache refresh (kernel KQ).

Replaces the part of K6 around the iterations,
``substrata_tpu/physics/solver.py:solve_contacts``: the setup before them
(:156-340, :408-428 — the awake-masked inverse mass, the world inverse
inertia, per static row [N, K] and per pair row [Q, wm] the tangent basis,
r x d, Iw (r x d), the mass-split effective mass, the restitution /
Baumgarte target from the pre-solve relative velocity, and the warm-start
probe of the [H, 5] hash cache with the friction-cone clamp) and the
refresh scatter after them (:449-471).

``solve_setup`` runs ``solve_setup_plain`` for CPU tensors and, for CUDA
tensors, one packed call of ``csrc/solve_setup.cu`` that makes two
launches: a thread per body computes its mass terms and table row once,
then a thread per contact row builds the row from its bodies' terms.  The
rows come out in the solve's component-major row layout
(``solve.row_layout``), views of one allocation that also holds KC's
buffers.  ``cache_refresh`` keeps the last writer of each colliding cache
slot, as a sequential scatter does: on the card, an atomicMax of the row
index per slot, then only the winning row writes (three short kernels in
one call).

The pair velocities go through bf16 where the reference rounds them
(:289); the targets divide by the traced ``dt`` (a 0-d tensor here, a
float32 in the kernel), never by its reciprocal.
"""

from __future__ import annotations

import struct

import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.kernels.solve import _KQ_FIELDS, ContactRows, SolveWork
from substrata_tpu_torch.maths import fp
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
    """Orthonormal (t1, t2) perpendicular to n [..., 3], rounded as the
    jitted reference contracts ``jnp.cross`` and ``jnp.linalg.norm``."""
    c = (torch.abs(n[..., 0:1]) < 0.9).to(n.dtype)    # x axis, else y axis
    ax = torch.cat([c, 1.0 - c, torch.zeros_like(c)], dim=-1)
    t1 = quatm.cross_fma(ax, n)
    t1 = t1 / torch.clamp(fp.sqrt(quatm.dot3_fma(t1, t1)), min=1e-9)[..., None]
    return t1, quatm.cross_fma(n, t1)


def _mat_vec_rows(iw, v):
    """iw [M, 3, 3] applied to v [M, ..., 3], as the reference's einsum."""
    shape = (iw.shape[0],) + (1,) * (v.dim() - 2) + (3, 3)
    return tmath.mat_vec_fma(iw.reshape(shape), v)


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
    rx_s = quatm.cross_fma(r_s[:, :, None, :], d_s)
    term_s = _mat_vec_rows(iw, rx_s)                          # Iw (r x d)
    k_s = torch.clamp((inv_mass * c_body)[:, None, None]
                      + quatm.dot3_fma(rx_s, term_s) * c_body[:, None, None], min=1e-9)

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
    ra_x = quatm.cross_fma(r_a[:, :, None, :], d_p)
    rb_x = quatm.cross_fma(r_b[:, :, None, :], d_p)
    term_a = _mat_vec_rows(va[:, 5:14].reshape(Q, 3, 3), ra_x)
    term_b = _mat_vec_rows(vb[:, 5:14].reshape(Q, 3, 3), rb_x)
    c_a, c_b = va[:, 4], vb[:, 4]
    k_p = torch.clamp((va[:, 3] * c_a + vb[:, 3] * c_b)[:, None, None]
                      + quatm.dot3_fma(ra_x, term_a) * c_a[:, None, None]
                      + quatm.dot3_fma(rb_x, term_b) * c_b[:, None, None], min=1e-9)

    # Targets from the pre-solve relative velocities (pairs via bf16).
    v0_s = body.linvel[:, None, :] + quatm.cross_fma(body.angvel[:, None, :], r_s)
    vv = torch.cat([body.linvel, body.angvel], dim=1).to(torch.bfloat16).to(torch.float32)
    wa, wb = vv[a_eg][:, None, :], vv[b_eg][:, None, :]
    v0_p = ((wa[..., :3] + quatm.cross_fma(wa[..., 3:], r_a))
            - (wb[..., :3] + quatm.cross_fma(wb[..., 3:], r_b)))

    def vn_target(pen, rest, vn0):
        rt = torch.where(vn0 < -restitution_threshold, -rest * vn0, -torch.inf)
        bias = torch.where(pen > 0.0,
                           torch.clamp((baumgarte / dt) * torch.clamp(pen - DEEP, min=0.0),
                                       max=3.0),
                           pen / dt)
        return torch.maximum(bias, rt)

    target_s = vn_target(pen_s, rest_s, quatm.dot3_fma(v0_s, nrm_s))
    target_p = vn_target(pair_cts.penetration.reshape(Q, wm),
                         pair_cts.restitution.reshape(Q, wm), quatm.dot3_fma(v0_p, nrm_p))

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


_BODY_NAMES = ("pos", "quat", "linvel", "angvel", "inv_mass", "inv_inertia", "awake", "table",
               "sign")
_CONTACT_FIELDS = ("a", "b", "point", "normal", "penetration", "valid", "friction",
                   "restitution", "key")
_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
# The launcher's argument buffer: 29 input pointers, 6 sizes, dt as a
# double, 23 output and scratch pointers (csrc/solve_setup.cu:solve_setup).
_PACK = struct.Struct("=35qd23q")


def solve_setup(body, static_cts, pair_cts, table, sign, params, dt, cache_data, wm: int):
    """KQ's setup: (rows, y_s, y_p, lookup) as ``solve_setup_plain`` returns
    them.  On the card: one allocation (``solve.SolveWork``, kept as
    ``rows.work``) holds the rows in the solve's row layout, the warm
    impulses, the lookup, KQ's per-body scratch and KC's buffers; one
    packed launcher call makes the two launches.  ``dt`` is a Python number, passed to the
    kernel as a float32 (a device tensor would need a sync to read); the CPU
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
    ins = (body.pos, body.quat, body.linvel, body.angvel, body.inv_mass, body.inv_inertia,
           body.awake, table, sign)
    names = _BODY_NAMES
    dtypes = (_F32,) * 6 + (_BOOL, _I32, _F32)
    shapes = ((n, 3), (n, 4), (n, 3), (n, 3), (n,), (n, 3), (n,), (n, cpb), (n, cpb))
    for c, cap, tag in ((static_cts, S, "static"), (pair_cts, P, "pair")):
        fields = _CONTACT_FIELDS if tag == "pair" else _CONTACT_FIELDS[:1] + _CONTACT_FIELDS[2:]
        ins += tuple(getattr(c, f) for f in fields)
        names += tuple(f"{tag}.{f}" for f in fields)
        dtypes += tuple(_F32 if f in ("point", "normal", "penetration", "friction",
                                      "restitution") else _BOOL if f == "valid" else _I32
                        for f in fields)
        shapes += tuple((cap, 3) if f in ("point", "normal") else (cap,) for f in fields)
    ins += (params.baumgarte, params.restitution_threshold)
    names += ("baumgarte", "restitution_threshold")
    dtypes += (_F32, _F32)
    shapes += ((), ())
    warm = cache_data is not None
    if warm:
        ins += (cache_data,)
        names += ("cache",)
        dtypes += (_F32,)
        shapes += ((cache_data.shape[0], 5),)
    build.check_all(dev, ins, names, dtypes, shapes)
    h_size = cache_data.shape[0] if warm else 0
    work = SolveWork((n, K, Q, wm, cpb), dev)
    v = work.row_views()
    rows = ContactRows(**{f: v[f] for f in _KQ_FIELDS}, s_fric=static_cts.friction.reshape(n, K),
                       p_fric=pair_cts.friction.reshape(Q, wm), work=work)
    p = work.ptr
    build.launch_packed("solve_setup", _PACK.pack(
        *(t.data_ptr() for t in ins[:28]), cache_data.data_ptr() if warm else 0,
        n, K, Q, wm, cpb, h_size, float(dt),
        p("sblk", 0), p("sblk", 1), p("svec", 0), p("svec", 1), p("sscal", 0), p("sscal", 1),
        p("pblk", 0), p("pblk", 1), p("pblk", 2), p("pvec", 0), p("pvec", 1), p("pvec", 2),
        p("pscal", 0), p("pscal", 1), p("p_ab"), p("tbl"), p("w"), p("im"), p("svec", 2),
        p("pvec", 3), p("h"), p("valid_all"), p("terms")))
    launches["solve_setup"] += 1
    return rows, v["y_s"], v["y_p"], ((v["h"], v["valid_all"]) if warm else None)


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


def _lam_strides(lam, n_rows, name):
    """(row, component) element strides of an impulse tensor [.., 3]: a
    row-major one (3, 1) or the solve's component-major state (1, n_rows)."""
    st = lam.stride()
    rs, cs = st[-2], st[-1]
    if (rs, cs) not in ((3, 1), (1, n_rows)) or st[0] != lam.shape[1] * rs:
        raise ValueError(f"{name}: strides {st}, expected a row-major or component-major "
                         f"[.., 3] tensor")
    return rs, cs


def cache_refresh(cache_data, h, valid_all, static_cts, pair_cts, lam_s, s_valid, lam_p,
                  p_valid):
    """KQ's refresh: ``cache_refresh_plain`` for CPU tensors, one call of
    ``csrc/solve_setup.cu:cache_refresh`` for CUDA tensors (the impulses
    row-major or in the solve's component-major layout)."""
    if cache_data.device.type == "cpu":
        return cache_refresh_plain(cache_data, h, valid_all, static_cts, pair_cts, lam_s,
                                   s_valid, lam_p, p_valid)
    dev = cache_data.device
    size = cache_data.shape[0]
    n, K = s_valid.shape
    Q, wm = p_valid.shape
    S, P = n * K, Q * wm
    build.check_all(
        dev, (cache_data, h, valid_all, static_cts.a, static_cts.key, pair_cts.a, pair_cts.key,
              s_valid, p_valid),
        ("cache", "h", "valid", "static.a", "static.key", "pair.a", "pair.key", "s_valid",
         "p_valid"),
        (_F32, _I32, _BOOL, _I32, _I32, _I32, _I32, _F32, _F32),
        ((size, 5), (S + P,), (S + P,), (S,), (S,), (P,), (P,), (n, K), (Q, wm)))
    for lam, name, shape in ((lam_s, "lam_s", (n, K, 3)), (lam_p, "lam_p", (Q, wm, 3))):
        if lam.dtype is not _F32 or lam.device != dev or lam.shape != shape:
            build.check(lam.contiguous(), name, _F32, shape, dev)
    s_rs, s_cs = _lam_strides(lam_s, S, "lam_s")
    p_rs, p_cs = _lam_strides(lam_p, P, "lam_p")
    out = torch.empty_like(cache_data)
    last = torch.empty((size,), dtype=_I32, device=dev)
    build.launch("cache_refresh", cache_data, h, valid_all, static_cts.a, static_cts.key,
                 pair_cts.a, pair_cts.key, lam_s, s_valid, lam_p, p_valid, S, P, size,
                 s_rs, s_cs, p_rs, p_cs, last, out)
    launches["cache_refresh"] += 1
    return out
