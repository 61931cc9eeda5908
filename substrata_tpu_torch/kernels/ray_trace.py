"""Batched ray trace against dynamic bodies and the heightfield (kernel KH).

Replaces ``substrata_tpu/physics/queries.py:_ray_bodies`` (:243) and
``_ray_heightfield_single`` (:180) as ``trace_rays`` (:395) combines them
(the trimesh and the hull-plane clip are not in the port yet).

Stage 1 marches ``body_steps`` sample points per ray, gathers the cell
table rows of the 9 xy-neighbour cells at each point (the int32-wrapping
hash of ``physics/broadphase.py``) and the ``MAX_OVERSIZE`` oversize slots,
and keys every candidate by its bounding-sphere entry distance.  With
``dedup`` a body that appears several times keeps its key once.  The ``k``
smallest keys survive, ties going to the lower slot (``dedup``) or to the
earlier candidate (no ``dedup``), as ``lax.top_k`` picks them.  Stage 2
runs the exact sphere, box and capsule tests on the survivors and takes
the first minimum; the heightfield (the flat analytic hit, or the march
with 10 bisection steps) is the other operand of the final min.

``ray_trace`` launches ``csrc/ray_trace.cu`` for CUDA tensors and runs
``ray_trace_plain`` for CPU tensors.  The plain twin is written out
component by component in the order the kernel computes, so the two agree
to rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.maths import quat as quatm
from substrata_tpu_torch.physics import broadphase
from substrata_tpu_torch.physics.state import BodyState, Heightfield, ShapeType

BIG = 1e9
MAX_K = 16          # survivors per ray the kernel keeps (queries.py: k_cand)
BISECT_STEPS = 10

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


def _ray_shapes(o, d, st, prm, pos, q):
    """Exact test against each candidate's own shape -> (t, n).  Hull
    bodies (none can exist without a hull library) miss with a zero
    normal, as the reference's test against an empty library does."""
    t_s, n_s = _ray_sphere(o, d, pos, prm[..., 0])
    t_b, n_b = _ray_box(o, d, pos, q, prm[..., :3])
    t_c, n_c = _ray_capsule(o, d, pos, q, prm[..., 0], prm[..., 1])
    t_h, n_h = torch.full_like(t_s, BIG), torch.zeros_like(n_s)
    sph, box, cap = (st == int(ShapeType.SPHERE), st == int(ShapeType.BOX),
                     st == int(ShapeType.CAPSULE))
    t = torch.where(sph, t_s, torch.where(box, t_b, torch.where(cap, t_c, t_h)))
    n = torch.where(sph[..., None], n_s, torch.where(
        box[..., None], n_b, torch.where(cap[..., None], n_c, n_h)))
    return t, n


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
    ps = origins[:, None, :] + dirs[:, None, :] * ts[..., None]           # [R, S, 3]
    cells = torch.floor(ps / cell_size).to(torch.int32)
    cand_list, buckets = [], []
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            nb = cells.clone()
            nb[..., 0] += ox
            nb[..., 1] += oy
            hb = broadphase._hash_cells(nb, num_buckets)
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


def _ray_bodies(origins, dirs, max_ts, body: BodyState, table, os_idx, cell_size: float,
                grid_dim: int, n_steps: int, exclude, collidable_only: bool, k: int,
                dedup: bool):
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
                       body.quat[sk])
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
                    has_heightfield, exclude, *, cell_size: float, grid_dim: int,
                    n_steps: int, body_steps: int, collidable_only: bool, k: int,
                    dedup: bool):
    """First hit among the bodies and the heightfield ->
    (t [R], normal [R, 3], body [R] i32, hit [R] bool)."""
    tb, nb, bi = _ray_bodies(origins, dirs, max_ts, body, table, os_idx, cell_size,
                             grid_dim, body_steps, exclude, collidable_only, k, dedup)
    th, nh = _ray_heightfield(origins, dirs, max_ts, hf, n_steps)
    th = torch.where(has_heightfield, th, BIG)
    body_wins = tb <= th
    t = torch.minimum(tb, th)
    hit = t <= max_ts
    return (torch.where(hit, t, BIG), torch.where(body_wins[:, None], nb, nh),
            torch.where(body_wins, bi, -1), hit)


def ray_trace(origins, dirs, max_ts, body: BodyState, table, os_idx, hf: Heightfield,
              has_heightfield, exclude, *, cell_size: float, grid_dim: int, n_steps: int,
              body_steps: int, collidable_only: bool, k: int, dedup: bool):
    """KH: ``ray_trace_plain`` for CPU tensors, ``csrc/ray_trace.cu`` (one
    thread per ray) for CUDA tensors."""
    global launches
    kw = dict(cell_size=cell_size, grid_dim=grid_dim, n_steps=n_steps,
              body_steps=body_steps, collidable_only=collidable_only, k=k, dedup=dedup)
    if origins.device.type == "cpu":
        return ray_trace_plain(origins, dirs, max_ts, body, table, os_idx, hf,
                               has_heightfield, exclude, **kw)
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
            (hf.cell_w, "hf_cell_w", f32, ()), (has_heightfield, "has_heightfield", bl, ())):
        build.check(t, name, dt, shp, dev)
    out = (torch.empty(r, dtype=f32, device=dev), torch.empty((r, 3), dtype=f32, device=dev),
           torch.empty(r, dtype=i32, device=dev), torch.empty(r, dtype=bl, device=dev))
    flags = ((1 if hf.is_flat else 0) | (2 if collidable_only else 0)
             | (4 if dedup else 0))
    build.launch("ray_trace", origins, dirs, max_ts, exclude, body.pos, body.quat,
                 body.bound_radius, body.shape_type, body.shape_params, body.alive,
                 body.layer, table, os_idx, hf.heights, hf.origin, hf.cell_w,
                 has_heightfield, r, grid_dim * grid_dim, table.shape[1],
                 os_idx.shape[0], hx, hy, n_steps, body_steps, k, flags,
                 float(cell_size), *out)
    launches += 1
    return out
