"""Box-box contact manifolds for the pair list (kernel KA).

Replaces ``substrata_tpu/physics/narrowphase.py:pair_contacts`` (single-
combo branch, :670-797) with ``_box_box`` (:227): SAT over 15 axes, a
clamped reference-face manifold of up to 4 points or one edge-edge point,
the speculative one-point prune (:739-742), friction/restitution combine
and the pair-blocked emission (:763-774): ``WM = 4`` rows per pair slot,
``a = -1`` on an empty slot, ``key = b*4 + slot + 9``.

``box_box_rows`` launches ``csrc/box_box.cu`` for CUDA tensors and runs
``box_box_rows_plain`` for CPU tensors.  The plain twin is written out
component by component in the order the kernel computes, so the two agree
to rounding.
"""

from __future__ import annotations

import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.maths import quat as quatm

CONTACT_MARGIN = 0.04  # speculative contact distance, metres
WM = 4                 # manifold rows per box-box pair slot

launches = 0


def _sgn(x):
    """sign(x) + (x == 0): +1 for x >= 0, -1 below."""
    return torch.where(x < 0, -1.0, 1.0)


def _mtv(m, v):
    """m^T v over [..., 3, 3] x [..., 3]: out[i] = sum_k m[k][i] v[k]."""
    return (m[..., 0, :] * v[..., 0:1] + m[..., 1, :] * v[..., 1:2]
            + m[..., 2, :] * v[..., 2:3])


def _mv(m, v):
    """m v: out[k] = sum_j m[k][j] v[j]."""
    return (m[..., :, 0] * v[..., 0:1] + m[..., :, 1] * v[..., 1:2]
            + m[..., :, 2] * v[..., 2:3])


def _col(m, idx):
    """Column idx[...] of m [..., 3, 3] -> [..., 3]."""
    return torch.gather(m, -1, idx[..., None, None].expand(m.shape[:-1] + (1,)))[..., 0]


def _pick(v, idx):
    return torch.gather(v, -1, idx[..., None])[..., 0]


def _norm3(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def segment_closest(p1, d1, p2, d2):
    """Closest points between segments p1±d1 and p2±d2 -> (t1, t2) in
    [-1, 1] (Ericson 5.1.9, branch-free)."""
    r = p1 - p2
    a = quatm.dot3(d1, d1) + 1e-12
    e = quatm.dot3(d2, d2) + 1e-12
    b = quatm.dot3(d1, d2)
    c = quatm.dot3(d1, r)
    f = quatm.dot3(d2, r)
    denom = a * e - b * b
    t1 = torch.where(denom > 1e-9,
                     torch.clamp((b * f - c * e) / torch.clamp(denom, min=1e-9),
                                 -1.0, 1.0), 0.0)
    t2 = (b * t1 + f) / e
    t2c = torch.clamp(t2, -1.0, 1.0)
    t1 = torch.clamp((b * t2c - c) / a, -1.0, 1.0)
    return t1, t2c


def box_box(pa, qa, hea, pb, qb, heb, with_gap: bool = False):
    """Batched box-box SAT manifold over a leading axis [P].

    Returns (points [P, 4, 3], pens [P, 4], normal [P, 3] from b to a,
    valid [P, 4]); with ``with_gap`` also the smallest distance [P] of any
    of the pair's discrete decisions (axis and face choice, signs, point
    masks) from its threshold — a pair whose gap is below rounding can
    legitimately take either branch."""
    ra = quatm.to_matrix(qa)
    rb = quatm.to_matrix(qb)
    c = (ra[..., 0, :, None] * rb[..., 0, None, :]
         + ra[..., 1, :, None] * rb[..., 1, None, :]
         + ra[..., 2, :, None] * rb[..., 2, None, :])       # ra^T rb
    absc = torch.abs(c) + 1e-5
    t_w = pb - pa
    t = _mtv(ra, t_w)
    sep_a = torch.abs(t) - (hea + _mv(absc, heb))
    tb = _mtv(c, t)
    sep_b = torch.abs(tb) - (heb + _mtv(absc, hea))

    zero = torch.zeros_like(t[..., 0])
    seps, axes, gaps = [], [], []
    for i in range(3):
        for j in range(3):
            i1, i2 = (i + 1) % 3, (i + 2) % 3
            j1, j2 = (j + 1) % 3, (j + 2) % 3
            comps = [zero, zero, zero]
            comps[i1] = -c[..., i2, j]
            comps[i2] = c[..., i1, j]
            axis = torch.stack(comps, dim=-1)
            alen = _norm3(axis)
            den = torch.clamp(alen, min=1e-9)
            axis_n = axis / den[..., None]
            ra_proj = hea[..., i1] * absc[..., i2, j] + hea[..., i2] * absc[..., i1, j]
            rb_proj = heb[..., j1] * absc[..., i, j2] + heb[..., j2] * absc[..., i, j1]
            dist = torch.abs(quatm.dot3(t, axis_n)) - (ra_proj + rb_proj) / den
            dist = torch.where(alen > 1e-6, dist, -1e9)
            seps.append(dist)
            axes.append(axis_n)
            if with_gap:   # the 1e-6 cut is a scale: near = within 2x of it
                gaps.append(torch.where((alen > 5e-7) & (alen < 2e-6), 0.0, float("inf")))
    sep_e = torch.stack(seps, dim=-1)                       # [P, 9]
    axes_e = torch.stack(axes, dim=-2)                      # [P, 9, 3]

    best_face_a = sep_a.max(dim=-1).values
    best_face_b = sep_b.max(dim=-1).values
    best_edge = sep_e.max(dim=-1).values
    best_face = torch.maximum(best_face_a, best_face_b)
    best = torch.maximum(best_face, best_edge)
    separated = best > CONTACT_MARGIN
    use_edge = best_edge > best_face * 0.98 + 0.001
    use_b_face = (~use_edge) & (best_face_b > best_face_a * 0.98 + 0.001)
    if with_gap:
        gaps += [torch.abs(best - CONTACT_MARGIN),
                 torch.abs(best_edge - (best_face * 0.98 + 0.001)),
                 torch.abs(best_face_b - (best_face_a * 0.98 + 0.001))]

    # --- Reference-face manifold on the selected reference box.
    ub = use_b_face[..., None]
    p_ref = torch.where(ub, pb, pa)
    q_ref = torch.where(ub, qb, qa)
    he_ref = torch.where(ub, heb, hea)
    p_inc = torch.where(ub, pa, pb)
    q_inc = torch.where(ub, qa, qb)
    he_inc = torch.where(ub, hea, heb)
    sep_sel = torch.where(ub, sep_b, sep_a)

    ax = torch.argmax(sep_sel, dim=-1)
    r_ref = quatm.to_matrix(q_ref)
    t_ref = _mtv(r_ref, p_inc - p_ref)
    t_ax = _pick(t_ref, ax)
    he_ax = _pick(he_ref, ax)
    sgn = _sgn(t_ax)
    n_world = sgn[..., None] * _col(r_ref, ax)
    r_inc = quatm.to_matrix(q_inc)
    dots = _mtv(r_inc, n_world)
    ai = torch.argmax(torch.abs(dots), dim=-1)
    d_ax = _pick(dots, ai)
    inc_sgn = -_sgn(d_ax)
    u1 = (ai + 1) % 3
    u2 = (ai + 2) % 3
    e0 = (_col(r_inc, ai) * _pick(he_inc, ai)[..., None]) * inc_sgn[..., None]
    e1 = _col(r_inc, u1) * _pick(he_inc, u1)[..., None]
    e2 = _col(r_inc, u2) * _pick(he_inc, u2)[..., None]
    base = p_inc + e0
    corners = torch.stack([base + e1 + e2, base - e1 + e2,
                           base - e1 - e2, base + e1 - e2], dim=-2)  # [P,4,3]
    r_ref4 = r_ref[..., None, :, :]
    local = _mtv(r_ref4, corners - p_ref[..., None, :])     # [P, 4, 3]
    ax4 = ax[..., None].expand(local.shape[:-1])
    depth = he_ax[..., None] - sgn[..., None] * _pick(local, ax4)
    he_ref4 = he_ref[..., None, :]
    clamped = torch.minimum(torch.maximum(local, -he_ref4), he_ref4)
    ax_val = sgn[..., None] * (he_ax[..., None] - torch.clamp(depth, min=0.0) * 0.5)
    is_ax = torch.arange(3, device=pa.device) == ax[..., None, None]   # [P,1,3]
    clamped = torch.where(is_ax, ax_val[..., None], clamped)
    pts_f = p_ref[..., None, :] + _mv(r_ref4, clamped)
    diff = torch.where(is_ax, 0.0, clamped - local)
    lateral = _norm3(diff)
    lat_lim = he_inc.max(dim=-1).values[..., None] * 1.5
    val_f = (depth > -CONTACT_MARGIN) & (lateral < lat_lim)
    pens_f = torch.where(val_f, depth, -1e9)
    if with_gap:
        top2 = torch.topk(sep_sel, 2, dim=-1).values
        top2d = torch.topk(torch.abs(dots), 2, dim=-1).values
        gaps += [top2[..., 0] - top2[..., 1], torch.abs(t_ax),
                 top2d[..., 0] - top2d[..., 1], torch.abs(d_ax)]
        face_gap = torch.minimum(torch.abs(depth + CONTACT_MARGIN),
                                 torch.abs(lateral - lat_lim)).min(dim=-1).values
        gaps.append(torch.where(use_edge, float("inf"), face_gap))

    # --- Edge-edge single point.
    eidx = torch.argmax(sep_e, dim=-1)
    ei = torch.div(eidx, 3, rounding_mode="floor")
    ej = eidx % 3
    axis_a = torch.gather(axes_e, -2, eidx[..., None, None].expand(
        eidx.shape + (1, 3)))[..., 0, :]
    n_edge = _mv(ra, axis_a)
    dd = quatm.dot3(n_edge, t_w)
    n_edge = n_edge * _sgn(dd)[..., None]
    sa_raw = _mtv(ra, n_edge)
    sb_raw = -_mtv(rb, n_edge)
    sa = _sgn(sa_raw)
    sb = _sgn(sb_raw)
    not_i = torch.arange(3, device=pa.device) != ei[..., None]
    not_j = torch.arange(3, device=pa.device) != ej[..., None]
    a_center = pa + _mv(ra, torch.where(not_i, sa * hea, 0.0))
    b_center = pb + _mv(rb, torch.where(not_j, sb * heb, 0.0))
    ea_half = _col(ra, ei) * _pick(hea, ei)[..., None]
    eb_half = _col(rb, ej) * _pick(heb, ej)[..., None]
    t1, t2 = segment_closest(a_center, ea_half, b_center, eb_half)
    pe_a = a_center + ea_half * t1[..., None]
    pe_b = b_center + eb_half * t2[..., None]
    edge_pen = -best_edge
    edge_pt = 0.5 * (pe_a + pe_b)
    n_e = -n_edge
    if with_gap:
        top2e = torch.topk(sep_e, 2, dim=-1).values
        edge_gap = torch.minimum(top2e[..., 0] - top2e[..., 1], torch.abs(dd))
        edge_gap = torch.minimum(edge_gap, torch.abs(edge_pen + CONTACT_MARGIN))
        side_gap = torch.minimum(
            torch.where(not_i, torch.abs(sa_raw), float("inf")).min(dim=-1).values,
            torch.where(not_j, torch.abs(sb_raw), float("inf")).min(dim=-1).values)
        edge_gap = torch.minimum(edge_gap, side_gap)
        gaps.append(torch.where(use_edge, edge_gap, float("inf")))

    slot0 = (torch.arange(4, device=pa.device) == 0)
    pts_e = torch.where(slot0[:, None], edge_pt[..., None, :], 0.0)
    pens_e = torch.where(slot0, edge_pen[..., None], -1e9)
    val_e = slot0 & (edge_pen > -CONTACT_MARGIN)[..., None]

    ue = use_edge[..., None]
    pts = torch.where(ue[..., None], pts_e, pts_f)
    pens = torch.where(ue, pens_e, pens_f)
    normal = torch.where(ue, n_e, torch.where(ub, n_world, -n_world))
    valid = torch.where(ue, val_e, val_f) & ~separated[..., None]
    if with_gap:
        return pts, pens, normal, valid, torch.stack(gaps, dim=-1).min(dim=-1).values
    return pts, pens, normal, valid


def prune_speculative(pens, valid):
    """Clearly separated pairs keep only their deepest point; pairs within
    1 cm keep the full manifold (narrowphase.py:739-742)."""
    near = torch.any(valid & (pens > -0.01), dim=-1)
    deepest = torch.argmax(torch.where(valid, pens, -1e9), dim=-1)
    keep1 = torch.arange(pens.shape[-1], device=pens.device) == deepest[..., None]
    return valid & (near[..., None] | keep1)


def combine_friction(fa, fb):
    return torch.sqrt(torch.clamp(fa * fb, min=0.0))


def combine_restitution(ra, rb):
    return torch.maximum(ra, rb)


def box_box_rows_plain(pos, quat, shape_params, friction, restitution,
                       is_sensor, pair_a, pair_b, pair_valid):
    """Pair-blocked rows [P*WM] for the box-box pair list.

    Returns (a, b, point, normal, pen, valid, friction, restitution, key,
    touching [P])."""
    p = pair_a.shape[0]
    a = torch.clamp(pair_a, min=0).long()
    b = torch.clamp(pair_b, min=0).long()
    pts, pens, normal, valid = box_box(pos[a], quat[a], shape_params[a, :3],
                                       pos[b], quat[b], shape_params[b, :3])
    valid = prune_speculative(pens, valid & pair_valid[:, None])
    touching = torch.any(valid, dim=-1) & pair_valid
    sensor = is_sensor[a] | is_sensor[b]
    fr = combine_friction(friction[a], friction[b])
    re = combine_restitution(restitution[a], restitution[b])
    a32 = torch.where(pair_valid, a, -1).to(torch.int32)
    b32 = b.to(torch.int32)
    slot = torch.arange(WM, dtype=torch.int32, device=pos.device)
    return (a32.repeat_interleave(WM), b32.repeat_interleave(WM),
            pts.reshape(p * WM, 3), normal.repeat_interleave(WM, dim=0),
            pens.reshape(p * WM), (valid & ~sensor[:, None]).reshape(p * WM),
            fr.repeat_interleave(WM), re.repeat_interleave(WM),
            (b32[:, None] * 4 + slot[None, :] + 9).reshape(p * WM), touching)


def box_box_rows(pos, quat, shape_params, friction, restitution, is_sensor,
                 pair_a, pair_b, pair_valid):
    """KA: ``box_box_rows_plain`` for CPU tensors, ``csrc/box_box.cu``
    (one thread per pair slot) for CUDA tensors."""
    global launches
    if pos.device.type == "cpu":
        return box_box_rows_plain(pos, quat, shape_params, friction,
                                  restitution, is_sensor, pair_a, pair_b,
                                  pair_valid)
    dev = pos.device
    n = pos.shape[0]
    p = pair_a.shape[0]
    f32, i32, bl = torch.float32, torch.int32, torch.bool
    for t, name, dt, shp in (
            (pos, "pos", f32, (n, 3)), (quat, "quat", f32, (n, 4)),
            (shape_params, "shape_params", f32, (n, 4)),
            (friction, "friction", f32, (n,)),
            (restitution, "restitution", f32, (n,)),
            (is_sensor, "is_sensor", bl, (n,)), (pair_a, "pair_a", i32, (p,)),
            (pair_b, "pair_b", i32, (p,)), (pair_valid, "pair_valid", bl, (p,))):
        build.check(t, name, dt, shp, dev)
    r = p * WM
    out = (torch.empty(r, dtype=i32, device=dev), torch.empty(r, dtype=i32, device=dev),
           torch.empty((r, 3), dtype=f32, device=dev),
           torch.empty((r, 3), dtype=f32, device=dev),
           torch.empty(r, dtype=f32, device=dev), torch.empty(r, dtype=bl, device=dev),
           torch.empty(r, dtype=f32, device=dev), torch.empty(r, dtype=f32, device=dev),
           torch.empty(r, dtype=i32, device=dev), torch.empty(p, dtype=bl, device=dev))
    build.launch("box_box_rows", pair_a, pair_b, pair_valid, pos, quat,
                 shape_params, friction, restitution, is_sensor, p, *out)
    launches += 1
    return out
