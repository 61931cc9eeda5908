"""Batched ray trace against the bodies, the heightfield and the static
trimesh (kernel KH).

Replaces ``substrata_tpu/physics/queries.py:_ray_bodies`` (:243) with the
hull-plane clip ``_ray_hull_planes`` (:134), ``_ray_heightfield_single``
(:180) and ``_ray_trimesh_single`` (:223) with ``_ray_triangle`` (:161), as
``trace_rays`` (:395-440) combines them.

Stage 1 marches ``body_steps`` sample points per ray, gathers the cell
table rows of the 9 xy-neighbour cells at each point (the int32-wrapping
hash of ``physics/broadphase.py``) and the ``MAX_OVERSIZE`` oversize slots,
and keys every candidate by its bounding-sphere entry distance.  With
``dedup`` a body that appears several times keeps its key once.  The ``k``
smallest keys survive, ties going to the lower slot (``dedup``) or to the
earlier candidate (no ``dedup``), as ``lax.top_k`` picks them.  Stage 2
runs the exact sphere, box, capsule or hull test on the survivors (a hull:
the ray in hull-local space clipped by the library's face planes, the
entering face's normal, the first on ties) and takes the first minimum.
The heightfield (the flat analytic hit, or the march with 10 bisection
steps) and the trimesh (the first 8 triangles of the grid cell at each of
the ``n_steps`` march points, Möller-Trumbore, the first minimum) are the
other operands of the final min; the trimesh wins only strictly, and then
reports its triangle's owner as the hit body and its material.

``ray_trace`` launches ``csrc/ray_trace.cu`` for CUDA tensors and runs
``ray_trace_plain`` for CPU tensors.  The plain twin is written out
component by component in the order the kernel computes, so the two agree
to rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from substrata_tpu_torch.kernels import build, cell_table
from substrata_tpu_torch.kernels.static_contacts import trimesh_cells
from substrata_tpu_torch.maths import fp
from substrata_tpu_torch.maths import quat as quatm
from substrata_tpu_torch.physics.state import (BodyState, Heightfield, HullLibrary, ShapeType,
                                               TriMesh)

BIG = 1e9
MAX_K = 16          # survivors per ray the kernel keeps (queries.py: k_cand)
BISECT_STEPS = 10
TRI_CAP = 8         # triangles read per grid cell of the march (queries.py:425)

launches = 0


def march_fractions(n: int, device):
    """``jnp.linspace(0, 1, n)`` bit for bit: XLA multiplies i by the
    float32 reciprocal of n - 1 (not i / (n - 1)), and the last is 1."""
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    inv = float(np.float32(1.0) / np.float32(n - 1))
    f = torch.arange(n, dtype=torch.float32, device=device) * inv
    f[-1] = 1.0
    return f


def _ray_sphere(o, d, c, r):
    oc = o - c
    b = quatm.dot3(oc, d)
    cc = quatm.dot3(oc, oc) - r * r
    disc = b * b - cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = -b - sq
    t = torch.where(t < 0.0, -b + sq, t)
    ok = (disc >= 0.0) & (t >= 0.0)
    n = (o + d * t[..., None] - c) / torch.clamp(r, min=1e-9)[..., None]
    return torch.where(ok, t, BIG), n


def _ray_box(o, d, pb, qb, he):
    ol = quatm.inverse_rotate_vec(qb, o - pb)
    dl = quatm.inverse_rotate_vec(qb, d)
    small = torch.where(dl < 0, -1e-9, torch.where(dl > 0, 1e-9, 0.0)) + (dl == 0) * 1e-9
    inv = 1.0 / torch.where(torch.abs(dl) > 1e-9, dl, small)
    t1 = (-he - ol) * inv
    t2 = (he - ol) * inv
    tmin_ax = torch.minimum(t1, t2)
    tmax_ax = torch.maximum(t1, t2)
    tmin = tmin_ax.max(dim=-1).values
    tmax = tmax_ax.min(dim=-1).values
    ok = (tmax >= tmin) & (tmax >= 0.0)
    t = torch.where(tmin >= 0.0, tmin, tmax)
    ax = torch.argmax(tmin_ax, dim=-1, keepdim=True)
    oh = (torch.arange(3, device=o.device) == ax).to(dl.dtype)
    dax = torch.gather(dl, -1, ax)
    n_local = oh * (torch.where(dax < 0, 1.0, torch.where(dax > 0, -1.0, 0.0))
                    + (dax == 0).to(dl.dtype))
    return torch.where(ok, t, BIG), quatm.rotate_vec(qb, n_local)


def _ray_capsule(o, d, pc, qc, r, hh):
    ez = quatm.basis(o.shape[:-1], 2, o.device)
    z = quatm.rotate_vec(qc, ez) * hh[..., None]
    w = o - pc
    zn = torch.sqrt(quatm.dot3(z, z))
    a_ax = z / torch.clamp(zn, min=1e-9)[..., None]
    d_perp = d - quatm.dot3(d, a_ax)[..., None] * a_ax
    w_perp = w - quatm.dot3(w, a_ax)[..., None] * a_ax
    a = quatm.dot3(d_perp, d_perp)
    b = quatm.dot3(d_perp, w_perp)
    c = quatm.dot3(w_perp, w_perp) - r * r
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_cyl = (-b - sq) / torch.where(a > 1e-9, a, 1e-9)
    ok_cyl = (disc >= 0.0) & (a > 1e-9) & (t_cyl >= 0.0)
    hitp = o + d * t_cyl[..., None]
    s = quatm.dot3(hitp - pc, a_ax)
    ok_cyl = ok_cyl & (torch.abs(s) <= zn)
    n_cyl = hitp - (pc + a_ax * s[..., None])
    n_cyl = n_cyl / torch.clamp(torch.sqrt(quatm.dot3(n_cyl, n_cyl)), min=1e-9)[..., None]
    t_a, n_a = _ray_sphere(o, d, pc + z, r)
    t_b, n_b = _ray_sphere(o, d, pc - z, r)
    t = torch.where(ok_cyl, t_cyl, BIG)
    n = torch.where(ok_cyl[..., None], n_cyl, ez)
    better_a = t_a < t
    t = torch.where(better_a, t_a, t)
    n = torch.where(better_a[..., None], n_a, n)
    better_b = t_b < t
    t = torch.where(better_b, t_b, t)
    n = torch.where(better_b[..., None], n_b, n)
    return t, n


def _ray_hull_planes(o, d, pos, q, pl, nf):
    """queries.py:_ray_hull_planes: the ray in hull-local space, clipped by
    the face planes ``pl`` [..., F, 4] (the first ``nf`` valid) -> (t,
    normal of the entering face that set t, the first on ties)."""
    ol = quatm.inverse_rotate_vec(q, o - pos)
    dl = quatm.inverse_rotate_vec(q, d)
    n = pl[..., :3]
    denom = quatm.dot3(n, dl[..., None, :])
    dist = pl[..., 3] - quatm.dot3(n, ol[..., None, :])
    eps = 1e-9
    t_pl = dist / torch.where(torch.abs(denom) > eps, denom, eps)
    fmask = torch.arange(pl.shape[-2], device=pl.device) < nf[..., None]
    entering = fmask & (denom < -eps)
    exiting = fmask & (denom > eps)
    parallel_out = fmask & (torch.abs(denom) <= eps) & (dist < 0.0)
    t_enter = torch.where(entering, t_pl, 0.0).max(dim=-1).values
    t_exit = torch.where(exiting, t_pl, BIG).min(dim=-1).values
    ok = (t_enter <= t_exit) & ~parallel_out.any(dim=-1) & (nf > 0) & (t_enter > 0.0)
    j = torch.argmax(torch.where(entering, t_pl, -BIG), dim=-1, keepdim=True)
    nj = torch.gather(n, -2, j[..., None].expand(j.shape + (3,)))[..., 0, :]
    return torch.where(ok, t_enter, BIG), quatm.rotate_vec(q, nj)


def _ray_shapes(o, d, st, prm, pos, q, hulls: HullLibrary):
    """Exact test against each candidate's own shape -> (t, n); a hull
    body takes its library row ``params[0]``."""
    t_s, n_s = _ray_sphere(o, d, pos, prm[..., 0])
    t_b, n_b = _ray_box(o, d, pos, q, prm[..., :3])
    t_c, n_c = _ray_capsule(o, d, pos, q, prm[..., 0], prm[..., 1])
    hid = torch.clamp(prm[..., 0].to(torch.int32), 0, hulls.capacity - 1).long()
    t_h, n_h = _ray_hull_planes(o, d, pos, q, hulls.planes[hid], hulls.n_faces[hid])
    sph, box, cap = (st == int(ShapeType.SPHERE), st == int(ShapeType.BOX),
                     st == int(ShapeType.CAPSULE))
    t = torch.where(sph, t_s, torch.where(box, t_b, torch.where(cap, t_c, t_h)))
    n = torch.where(sph[..., None], n_s, torch.where(
        box[..., None], n_b, torch.where(cap[..., None], n_c, n_h)))
    return t, n


def _ray_triangle(o, d, v0, v1, v2):
    """queries.py:_ray_triangle (Moller-Trumbore) -> (t, BIG on a miss;
    unit normal facing the ray)."""
    e1, e2 = v1 - v0, v2 - v0
    p = quatm.cross(d, e2)
    det = quatm.dot3(e1, p)
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, 1e-12)
    s = o - v0
    u = quatm.dot3(s, p) * inv_det
    qv = quatm.cross(s, e1)
    v = quatm.dot3(d, qv) * inv_det
    t = quatm.dot3(e2, qv) * inv_det
    ok = (torch.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= 0)
    n = quatm.cross(e1, e2)
    n = n / torch.clamp(torch.sqrt(quatm.dot3(n, n)), min=1e-12)[..., None]
    n = torch.where((quatm.dot3(n, d) > 0)[..., None], -n, n)
    return torch.where(ok, t, BIG), n


def _ray_trimesh(origins, dirs, max_ts, tm: TriMesh, n_steps: int):
    """queries.py:_ray_trimesh_single over all rays -> (t, normal,
    material, owner) of the first nearest triangle among the first 8 of
    the cell at each march point."""
    r = origins.shape[0]
    k = min(tm.cell_tris.shape[2], TRI_CAP)
    ts = march_fractions(n_steps, origins.device)[None, :] * max_ts[:, None]
    ps = origins[:, None, :] + dirs[:, None, :] * ts[..., None]
    ci, cj = trimesh_cells(tm, ps[..., :2])
    cand = tm.cell_tris[ci, cj][..., :k].reshape(r, n_steps * k)
    tri = tm.tris[torch.clamp(cand, min=0).long()].long()
    o = origins[:, None, :].expand(r, n_steps * k, 3)
    d = dirs[:, None, :].expand(r, n_steps * k, 3)
    t, n = _ray_triangle(o, d, tm.verts[tri[..., 0]], tm.verts[tri[..., 1]],
                         tm.verts[tri[..., 2]])
    t = torch.where(cand >= 0, t, BIG)
    best = torch.argmin(t, dim=1, keepdim=True)
    tri_best = torch.clamp(torch.gather(cand, 1, best)[:, 0], min=0).long()
    return (torch.gather(t, 1, best)[:, 0],
            torch.gather(n, 1, best[..., None].expand(r, 1, 3))[:, 0],
            tm.tri_mats[tri_best], tm.tri_owner[tri_best])


def survivors(origins, dirs, max_ts, body: BodyState, table, os_idx, cell_size: float,
              grid_dim: int, n_steps: int, exclude, collidable_only: bool, k: int,
              dedup: bool):
    """Stage 1 of queries.py:_ray_bodies -> (buckets [R, 9 * n_steps] the
    rays read, candidates [R, C], survivor slots [R, k], survivor has a
    finite key [R, k])."""
    r = origins.shape[0]
    cap = table.shape[1]
    num_buckets = grid_dim * grid_dim
    if n_steps == 1:
        ts = 0.5 * max_ts[:, None]
    else:
        ts = march_fractions(n_steps, origins.device)[None, :] * max_ts[:, None]
    # XLA fuses the march point into one multiply-add and folds the static
    # division into a multiply by the reciprocal.
    ps = fp.fma(dirs[:, None, :], ts[..., None], origins[:, None, :])    # [R, S, 3]
    cells = torch.floor(ps * fp.recip(cell_size)).to(torch.int32)
    cand_list, buckets = [], []
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            nb = cells.clone()
            nb[..., 0] += ox
            nb[..., 1] += oy
            hb = cell_table.hash_cells(nb, num_buckets)
            buckets.append(hb)
            cand_list.append(table[hb.reshape(-1)].reshape(r, n_steps * cap))
    os_b = os_idx.to(table.dtype)[None, :].expand(r, os_idx.shape[0])
    cand = torch.cat(cand_list + [os_b], dim=1).long()
    n_cand = cand.shape[1]
    k = min(k, n_cand)

    # Stage 1: bounding-sphere entry distance of every candidate.
    ok_body = body.alive & body.collidable if collidable_only else body.alive
    safe = torch.clamp(cand, min=0)
    cpos, crad, cok = body.pos[safe], body.bound_radius[safe], ok_body[safe]
    okc = (cand >= 0) & (cand != exclude[:, None].long()) & cok
    oc = origins[:, None, :] - cpos
    b = quatm.dot3(oc, dirs[:, None, :])
    cc = quatm.dot3(oc, oc) - crad * crad
    disc = b * b - cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_in = torch.clamp(-b - sq, min=0.0)
    reach = (disc >= 0.0) & (-b + sq >= 0.0) & (t_in <= max_ts[:, None])
    key = torch.where(okc & reach, t_in, BIG)
    if dedup:
        slot_s, order = torch.sort(cand, dim=1, stable=True)
        key_s = torch.gather(key, 1, order)
        dup = torch.zeros_like(okc)
        dup[:, 1:] = slot_s[:, 1:] == slot_s[:, :-1]
        key_s = torch.where(dup, BIG, key_s)
    else:
        slot_s, key_s = cand, key
    # lax.top_k(-key, k): the k smallest keys, the lower column first on ties.
    key_k, ti = torch.sort(key_s, dim=1, stable=True)
    key_k, ti = key_k[:, :k], ti[:, :k]
    return torch.cat(buckets, dim=1), cand, torch.gather(slot_s, 1, ti), key_k < BIG


def _ray_bodies(origins, dirs, max_ts, body: BodyState, table, os_idx, hulls: HullLibrary,
                cell_size: float, grid_dim: int, n_steps: int, exclude, collidable_only: bool,
                k: int, dedup: bool):
    """queries.py:_ray_bodies -> (t [R], normal [R, 3], slot [R], -1 = none)."""
    r = origins.shape[0]
    _, _, slotk, okk = survivors(origins, dirs, max_ts, body, table, os_idx, cell_size,
                                 grid_dim, n_steps, exclude, collidable_only, k, dedup)
    k = slotk.shape[1]

    # Stage 2: exact shape tests on the k survivors.
    sk = torch.clamp(slotk, min=0)
    o = origins[:, None, :].expand(r, k, 3)
    d = dirs[:, None, :].expand(r, k, 3)
    t, n = _ray_shapes(o, d, body.shape_type[sk], body.shape_params[sk], body.pos[sk],
                       body.quat[sk], hulls)
    t_all = torch.where(okk, t, BIG)
    best = torch.argmin(t_all, dim=1, keepdim=True)
    t_best = torch.gather(t_all, 1, best)[:, 0]
    n_best = torch.gather(n, 1, best[..., None].expand(r, 1, 3))[:, 0]
    slot_best = torch.gather(slotk, 1, best)[:, 0]
    return t_best, n_best, torch.where(t_best < BIG, slot_best, -1).to(torch.int32)


def _ray_heightfield(origins, dirs, max_ts, hf: Heightfield, n_steps: int):
    """queries.py:_ray_heightfield_single over all rays -> (t, normal)."""
    if hf.is_flat:
        z0 = hf.heights[0, 0]
        dz = torch.where(torch.abs(dirs[:, 2]) > 1e-9, dirs[:, 2], 1e-9)
        t = (z0 - origins[:, 2]) / dz
        start_below = origins[:, 2] < z0
        ok = start_below | ((t >= 0.0) & (t <= max_ts) & (dirs[:, 2] < 0.0))
        t = torch.where(start_below, 0.0, t)
        return torch.where(ok, t, BIG), quatm.basis(origins.shape[:-1], 2, origins.device)

    def above(t):
        p = origins + dirs * t[:, None]
        return p[:, 2] - hf.sample(p[:, :2])

    ts = march_fractions(n_steps, origins.device)[None, :] * max_ts[:, None]   # [R, S]
    ps = origins[:, None, :] + dirs[:, None, :] * ts[..., None]
    vals = ps[..., 2] - hf.sample(ps[..., :2])
    below = vals < 0.0
    first = torch.argmax(below.to(torch.uint8), dim=1, keepdim=True)
    any_below = below.any(dim=1)
    lo = torch.gather(ts, 1, torch.clamp(first - 1, min=0))[:, 0]
    hi = torch.gather(ts, 1, first)[:, 0]
    for _ in range(BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        is_above = above(mid) > 0
        lo, hi = torch.where(is_above, mid, lo), torch.where(is_above, hi, mid)
    t = 0.5 * (lo + hi)
    n = hf.normal((origins + dirs * t[:, None])[:, :2])
    t = torch.where(vals[:, 0] < 0.0, 0.0, t)
    return torch.where(any_below, t, BIG), n


def ray_trace_plain(origins, dirs, max_ts, body: BodyState, table, os_idx, hf: Heightfield,
                    has_heightfield, exclude, hulls: HullLibrary, trimesh: TriMesh, *,
                    cell_size: float, grid_dim: int, n_steps: int, body_steps: int,
                    collidable_only: bool, k: int, dedup: bool):
    """First hit among the bodies, the heightfield and the trimesh ->
    (t [R], normal [R, 3], body [R] i32, hit [R] bool, material [R] i32).
    A trimesh with no triangles is skipped (its grid holds none)."""
    tb, nb, bi = _ray_bodies(origins, dirs, max_ts, body, table, os_idx, hulls, cell_size,
                             grid_dim, body_steps, exclude, collidable_only, k, dedup)
    th, nh = _ray_heightfield(origins, dirs, max_ts, hf, n_steps)
    th = torch.where(has_heightfield, th, BIG)
    if trimesh.count > 0:
        tm, nm, mat, owner = _ray_trimesh(origins, dirs, max_ts, trimesh, n_steps)
    else:
        tm, nm = torch.full_like(tb, BIG), torch.zeros_like(nb)
        mat = owner = torch.zeros_like(bi)
    body_first = (tb <= th) & (tb <= tm)
    tri_wins = (tm < th) & (tm < tb)
    t = torch.minimum(torch.minimum(tb, th), tm)
    hit = t <= max_ts
    n = torch.where(body_first[:, None], nb, torch.where((th <= tm)[:, None], nh, nm))
    bodyi = torch.where(body_first, bi, torch.where(tri_wins, owner, -1))
    return (torch.where(hit, t, BIG), n, bodyi.to(torch.int32), hit,
            torch.where(tri_wins, mat, 0).to(torch.int32))


def ray_trace(origins, dirs, max_ts, body: BodyState, table, os_idx, hf: Heightfield,
              has_heightfield, exclude, hulls: HullLibrary, trimesh: TriMesh, *,
              cell_size: float, grid_dim: int, n_steps: int, body_steps: int,
              collidable_only: bool, k: int, dedup: bool):
    """KH: ``ray_trace_plain`` for CPU tensors, ``csrc/ray_trace.cu`` (one
    thread per ray) for CUDA tensors."""
    global launches
    kw = dict(cell_size=cell_size, grid_dim=grid_dim, n_steps=n_steps,
              body_steps=body_steps, collidable_only=collidable_only, k=k, dedup=dedup)
    if origins.device.type == "cpu":
        return ray_trace_plain(origins, dirs, max_ts, body, table, os_idx, hf,
                               has_heightfield, exclude, hulls, trimesh, **kw)
    if k > MAX_K:
        raise ValueError(f"ray_trace: k={k} survivors, the kernel keeps at most {MAX_K}")
    dev = origins.device
    r, n = origins.shape[0], body.capacity
    f32, i32, bl = torch.float32, torch.int32, torch.bool
    hx, hy = hf.heights.shape
    for t, name, dt, shp in (
            (origins, "origins", f32, (r, 3)), (dirs, "dirs", f32, (r, 3)),
            (max_ts, "max_ts", f32, (r,)), (exclude, "exclude", i32, (r,)),
            (body.pos, "pos", f32, (n, 3)), (body.quat, "quat", f32, (n, 4)),
            (body.bound_radius, "bound_radius", f32, (n,)),
            (body.shape_type, "shape_type", i32, (n,)),
            (body.shape_params, "shape_params", f32, (n, 4)),
            (body.alive, "alive", bl, (n,)), (body.layer, "layer", i32, (n,)),
            (table, "table", i32, (grid_dim * grid_dim + 1, table.shape[1])),
            (os_idx, "os_idx", i32, (os_idx.shape[0],)),
            (hf.heights, "heights", f32, (hx, hy)), (hf.origin, "hf_origin", f32, (2,)),
            (hf.cell_w, "hf_cell_w", f32, ()), (has_heightfield, "has_heightfield", bl, ()),
            (hulls.planes, "hull_planes", f32, (hulls.capacity, hulls.max_faces, 4)),
            (hulls.n_faces, "hull_n_faces", i32, (hulls.capacity,)),
            (trimesh.verts, "tri_verts", f32, (trimesh.verts.shape[0], 3)),
            (trimesh.tris, "tris", i32, (trimesh.tris.shape[0], 3)),
            (trimesh.tri_mats, "tri_mats", i32, (trimesh.tris.shape[0],)),
            (trimesh.tri_owner, "tri_owner", i32, (trimesh.tris.shape[0],)),
            (trimesh.cell_tris, "cell_tris", i32, tuple(trimesh.cell_tris.shape)),
            (trimesh.origin, "tri_origin", f32, (2,)), (trimesh.cell_w, "tri_cell_w", f32, ())):
        build.check(t, name, dt, shp, dev)
    if hulls.max_faces > 32:
        raise ValueError("ray_trace: the kernel clips at most 32 hull faces")
    out = (torch.empty(r, dtype=f32, device=dev), torch.empty((r, 3), dtype=f32, device=dev),
           torch.empty(r, dtype=i32, device=dev), torch.empty(r, dtype=bl, device=dev),
           torch.empty(r, dtype=i32, device=dev))
    flags = ((1 if hf.is_flat else 0) | (2 if collidable_only else 0)
             | (4 if dedup else 0) | (8 if trimesh.count > 0 else 0))
    gx, gy, tcap = trimesh.cell_tris.shape
    build.launch("ray_trace", origins, dirs, max_ts, exclude, body.pos, body.quat,
                 body.bound_radius, body.shape_type, body.shape_params, body.alive,
                 body.layer, table, os_idx, hf.heights, hf.origin, hf.cell_w,
                 has_heightfield, hulls.planes, hulls.n_faces, trimesh.verts, trimesh.tris,
                 trimesh.tri_mats, trimesh.tri_owner, trimesh.cell_tris, trimesh.origin,
                 trimesh.cell_w, r, grid_dim * grid_dim, table.shape[1],
                 os_idx.shape[0], hx, hy, n_steps, body_steps, k, flags, hulls.capacity,
                 hulls.max_faces, gx, gy, tcap, fp.recip(cell_size), *out)
    launches += 1
    return out
