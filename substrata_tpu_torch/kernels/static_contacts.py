"""Static contacts: every body's sample points against the heightfield
and the static trimesh (kernel KB).

Replaces ``substrata_tpu/physics/narrowphase.py:static_contacts`` (:911)
with ``shape_sample_points`` (:804), ``_closest_point_triangle`` (:870)
and ``Heightfield.sample_with_normal`` (state.py:208): 8 sample points per
body (a hull's are its vertices furthest along world-down and a 30° ring of
8 directions around it, in its local frame, the first vertex on ties);
the heightfield's penetration projected on the surface normal and its
contact point; the trimesh's first ``min(cap, max_tri_candidates)``
triangles of the point's grid cell, each by its closest point, the signed
distance below its plane and the normal rule, the deepest first on ties
(:940-976); the deeper of the two (:992-996); the eligibility mask
(:1005-1007), the 0.5 m clamp, and the K deepest samples per body with the
LOWER sample index first on ties, as ``lax.top_k`` picks them (:1017).
The selected sample becomes the warm-start key (``slot + 1``), so the tie
order decides which cached impulses warm the next step.  Rows are
body-blocked: rows n*K .. n*K+K-1 belong to body n.

A trimesh of at most one triangle (the empty placeholder) is skipped, as
the reference skips it at trace time (:986-990).

``static_contacts`` launches ``csrc/static_contacts.cu`` for CUDA tensors
and runs ``static_contacts_plain`` for CPU tensors.
"""

from __future__ import annotations

import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.kernels.box_box import CONTACT_MARGIN, _norm3, combine_friction
from substrata_tpu_torch.kernels.closed_forms import closest_point_triangle, safe_normalize
from substrata_tpu_torch.maths import quat as quatm
from substrata_tpu_torch.physics.state import (BodyState, Heightfield, HullLibrary, ShapeType,
                                               TriMesh)

launches = 0

_CORNERS = [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
# cos and sin of jnp.arange(8, float32) * (2 pi / 8) as the reference's CPU
# backend rounds them (csrc/static_contacts.cu holds the same table).
RING_COS = [float.fromhex(x) for x in (
    "0x1p+0", "0x1.6a09e6p-1", "-0x1.777a5cp-25", "-0x1.6a09e6p-1", "-0x1p+0",
    "-0x1.6a09e2p-1", "0x1.99bc5cp-27", "0x1.6a09eep-1")]
RING_SIN = [float.fromhex(x) for x in (
    "0x0p+0", "0x1.6a09e6p-1", "0x1p+0", "0x1.6a09e6p-1", "-0x1.777a5cp-24",
    "-0x1.6a09eap-1", "-0x1p+0", "-0x1.6a09dep-1")]


def hull_sample_local(quat, hverts):
    """A hull's 8 local sample points (narrowphase.py:833-852): the vertex
    of ``hverts`` [N, V, 3] furthest along world-down in the local frame
    and a 30° ring of 8 directions around it, the first on ties."""
    n, dev = quat.shape[0], quat.device
    down = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    down[:, 2] = -1.0
    down_l = quatm.inverse_rotate_vec(quat, down)
    ax = torch.where((torch.abs(down_l[:, 0:1]) < 0.9), quatm.basis((n,), 0, dev),
                     quatm.basis((n,), 1, dev))
    u1 = quatm.cross(ax, down_l)
    u1 = u1 / torch.clamp(_norm3(u1), min=1e-9)[:, None]
    u2 = quatm.cross(down_l, u1)
    c = torch.tensor(RING_COS, dtype=torch.float32, device=dev)[None, :, None]
    s = torch.tensor(RING_SIN, dtype=torch.float32, device=dev)[None, :, None]
    dirs = down_l[:, None, :] * 0.866 + (u1[:, None, :] * c + u2[:, None, :] * s) * 0.5
    scores = quatm.dot3(hverts[:, None, :, :], dirs[:, :, None, :])        # [N, 8, V]
    sel = torch.argmax(scores, dim=-1)
    return torch.gather(hverts, 1, sel[..., None].expand(n, 8, 3))


def shape_sample_points(body: BodyState, present=(True, True, True, True),
                        hulls: HullLibrary | None = None):
    """Per-body sample points [N, 8, 3] (world), radii [N] and slot mask
    [N, 8]: sphere = centre (radius r), capsule = 2 endpoints (radius r),
    box = 8 corners, hull = ``hull_sample_local`` (radius 0).  ``present``
    mirrors the reference: absent shape types contribute no candidate, and
    the last candidate is the default for every body whose type has none."""
    n = body.capacity
    dev = body.device
    st = body.shape_type
    p = body.shape_params
    corners = torch.tensor(_CORNERS, dtype=torch.float32, device=dev)
    cands = []
    if present[int(ShapeType.BOX)]:
        cands.append((int(ShapeType.BOX), corners[None, :, :] * p[:, None, :3]))
    if present[int(ShapeType.CAPSULE)]:
        cap = torch.zeros((n, 8, 3), dtype=torch.float32, device=dev)
        cap[:, 0, 2] = p[:, 1]
        cap[:, 1, 2] = -p[:, 1]
        cands.append((int(ShapeType.CAPSULE), cap))
    if present[int(ShapeType.HULL)]:
        hid = torch.clamp(p[:, 0].to(torch.int32), 0, hulls.capacity - 1).long()
        cands.append((int(ShapeType.HULL), hull_sample_local(body.quat, hulls.verts[hid])))
    if present[int(ShapeType.SPHERE)] or not cands:
        cands.append((int(ShapeType.SPHERE),
                      torch.zeros((n, 8, 3), dtype=torch.float32, device=dev)))
    local = cands[-1][1]
    for stype, cand in cands[:-1]:
        local = torch.where((st == stype)[:, None, None], cand, local)
    n_samples = torch.where(st == int(ShapeType.BOX), 8,
                            torch.where(st == int(ShapeType.CAPSULE), 2,
                                        torch.where(st == int(ShapeType.HULL), 8, 1)))
    radius = torch.where((st == int(ShapeType.SPHERE)) | (st == int(ShapeType.CAPSULE)),
                         p[:, 0], 0.0)
    world = body.pos[:, None, :] + quatm.rotate_vec(body.quat[:, None, :], local)
    slot_valid = torch.arange(8, device=dev)[None, :] < n_samples[:, None]
    return world, radius, slot_valid


def trimesh_cells(tm: TriMesh, xy):
    """Grid cell (ci, cj) of world xy [..., 2]: truncated toward zero, then
    clamped, as ``astype(int32)`` and ``clip`` do."""
    gx, gy = tm.cell_tris.shape[:2]
    ci = torch.clamp(((xy[..., 0] - tm.origin[0]) / tm.cell_w).to(torch.int32), 0, gx - 1)
    cj = torch.clamp(((xy[..., 1] - tm.origin[1]) / tm.cell_w).to(torch.int32), 0, gy - 1)
    return ci.long(), cj.long()


def trimesh_sphere_rows(tm: TriMesh, pts, rad, k: int):
    """Every point of ``pts`` [M, 3] (sphere radius ``rad`` [M]) against the
    first ``k`` triangles of its grid cell (narrowphase.py:944-976) -> per
    candidate (pen [M, k], -1e9 where empty; closest point [M, k, 3];
    normal [M, k, 3]; candidate ok [M, k])."""
    ci, cj = trimesh_cells(tm, pts[:, :2])
    cand = tm.cell_tris[ci, cj][:, :k]
    cand_ok = cand >= 0
    tri = tm.tris[torch.clamp(cand, min=0).long()].long()
    v0, v1, v2 = tm.verts[tri[..., 0]], tm.verts[tri[..., 1]], tm.verts[tri[..., 2]]
    p = pts[:, None, :].expand(v0.shape)
    cp = closest_point_triangle(p, v0, v1, v2)
    delta = p - cp
    dist = _norm3(delta)
    tri_n = safe_normalize(quatm.cross(v1 - v0, v2 - v0))
    side = quatm.dot3(p - v0, tri_n)
    sdist = torch.where(side >= 0, dist, -dist)
    pen = torch.where(cand_ok, rad[:, None] - sdist, -1e9)
    cn = torch.where(((dist > 1e-6) & (side >= 0))[..., None],
                     delta / torch.clamp(dist, min=1e-6)[..., None], tri_n)
    return pen, cp, cn, cand_ok


def static_contacts_plain(body: BodyState, hf: Heightfield, has_heightfield,
                          k: int, present, hulls: HullLibrary | None = None,
                          trimesh: TriMesh | None = None, max_tri_candidates: int = 16):
    """Body-blocked static contact rows [N*k].

    Returns (a, b, point, normal, pen, valid, friction, restitution, key)."""
    n = body.capacity
    dev = body.device
    pts, radius, slot_valid = shape_sample_points(body, present, hulls)
    flat = pts.reshape(n * 8, 3)
    rad = radius.repeat_interleave(8)
    h, hf_n = hf.sample_with_normal(flat[:, :2])
    pen = (h - (flat[:, 2] - rad)) * hf_n[:, 2]
    point = torch.where((rad > 0)[:, None], flat - hf_n * rad[:, None],
                        torch.stack([flat[:, 0], flat[:, 1], h], dim=1))
    normal = hf_n.expand(n * 8, 3)
    hf_ok = has_heightfield & (pen > -CONTACT_MARGIN)
    elig = (body.alive & body.collidable & body.dynamic & ~body.is_sensor
            & body.awake).repeat_interleave(8)
    if trimesh is not None and trimesh.tris.shape[0] > 1:
        # Only eligible bodies' samples take a trimesh contact, as the
        # kernel tests only theirs: every other row is invalid either way.
        tpen, tcp, tcn, tok = trimesh_sphere_rows(
            trimesh, flat, rad, min(trimesh.cell_tris.shape[2], max_tri_candidates))
        best = torch.argmax(tpen, dim=1)
        r = torch.arange(n * 8, device=dev)
        tm_pen, tm_point, tm_normal = tpen[r, best], tcp[r, best], tcn[r, best]
        tm_ok = (tm_pen > -CONTACT_MARGIN) & (tm_pen < 1e8) & tok[r, best] & elig
        use_tm = tm_ok & (~hf_ok | (tm_pen > pen))
        pen = torch.where(use_tm, tm_pen, pen)
        point = torch.where(use_tm[:, None], tm_point, point)
        normal = torch.where(use_tm[:, None], tm_normal, normal)
        hf_ok = hf_ok | use_tm
    ok = hf_ok & slot_valid.reshape(-1) & elig
    pen = torch.clamp(pen, -1e9, 0.5)
    if k < 8:
        pen_rows = torch.where(ok, pen, -1e9).reshape(n, 8)
        # Stable descending sort: equal depths keep the lower sample first.
        top_pen, top_slot = torch.sort(pen_rows, dim=1, descending=True, stable=True)
        top_pen, top_slot = top_pen[:, :k], top_slot[:, :k]
        sel = (torch.arange(n, device=dev)[:, None] * 8 + top_slot).reshape(-1)
        point, normal, pen = point[sel], normal[sel], pen[sel]
        ok = ok[sel] & (top_pen.reshape(-1) > -1e8)
        key_slot = top_slot.reshape(-1).to(torch.int32)
    else:
        k = 8
        key_slot = torch.arange(8, dtype=torch.int32, device=dev).repeat(n)
    fr = combine_friction(body.friction, 0.5)
    return (torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(k),
            torch.full((n * k,), -1, dtype=torch.int32, device=dev),
            point.contiguous(), normal.contiguous(), pen, ok,
            fr.repeat_interleave(k), body.restitution.repeat_interleave(k),
            key_slot + 1)


def static_contacts(body: BodyState, hf: Heightfield, has_heightfield, k: int,
                    present, hulls: HullLibrary, trimesh: TriMesh,
                    max_tri_candidates: int = 16):
    """KB: ``static_contacts_plain`` for CPU tensors,
    ``csrc/static_contacts.cu`` (one thread per body) for CUDA tensors."""
    global launches
    if body.device.type == "cpu":
        return static_contacts_plain(body, hf, has_heightfield, k, present, hulls, trimesh,
                                     max_tri_candidates)
    dev = body.device
    n = body.capacity
    f32, i32, bl = torch.float32, torch.int32, torch.bool
    for t, name, dt, shp in (
            (body.pos, "pos", f32, (n, 3)), (body.quat, "quat", f32, (n, 4)),
            (body.shape_type, "shape_type", i32, (n,)),
            (body.shape_params, "shape_params", f32, (n, 4)),
            (body.alive, "alive", bl, (n,)), (body.layer, "layer", i32, (n,)),
            (body.motion_type, "motion_type", i32, (n,)),
            (body.is_sensor, "is_sensor", bl, (n,)), (body.awake, "awake", bl, (n,)),
            (body.friction, "friction", f32, (n,)),
            (body.restitution, "restitution", f32, (n,)),
            (hf.heights, "heights", f32, tuple(hf.heights.shape)),
            (hf.origin, "origin", f32, (2,)), (hf.cell_w, "cell_w", f32, ()),
            (has_heightfield, "has_heightfield", bl, ()),
            (hulls.verts, "hull_verts", f32, (hulls.capacity, hulls.max_verts, 3)),
            (hulls.n_verts, "hull_n_verts", i32, (hulls.capacity,)),
            (trimesh.verts, "tri_verts", f32, (trimesh.verts.shape[0], 3)),
            (trimesh.tris, "tris", i32, (trimesh.tris.shape[0], 3)),
            (trimesh.cell_tris, "cell_tris", i32, tuple(trimesh.cell_tris.shape)),
            (trimesh.origin, "tri_origin", f32, (2,)), (trimesh.cell_w, "tri_cell_w", f32, ())):
        build.check(t, name, dt, shp, dev)
    hx, hy = hf.heights.shape
    gx, gy, tcap = trimesh.cell_tris.shape
    use_tm = trimesh.tris.shape[0] > 1
    kk = min(k, 8)
    r = n * kk
    out = (torch.empty(r, dtype=i32, device=dev), torch.empty(r, dtype=i32, device=dev),
           torch.empty((r, 3), dtype=f32, device=dev),
           torch.empty((r, 3), dtype=f32, device=dev),
           torch.empty(r, dtype=f32, device=dev), torch.empty(r, dtype=bl, device=dev),
           torch.empty(r, dtype=f32, device=dev), torch.empty(r, dtype=f32, device=dev),
           torch.empty(r, dtype=i32, device=dev))
    present_mask = sum(1 << i for i, on in enumerate(present) if on)
    flags = (1 if hf.is_flat else 0) | (present_mask << 1) | ((1 << 5) if use_tm else 0)
    build.launch("static_contacts", body.pos, body.quat, body.shape_type,
                 body.shape_params, body.alive, body.layer, body.motion_type,
                 body.is_sensor, body.awake, body.friction, body.restitution,
                 hf.heights, hf.origin, hf.cell_w, has_heightfield, hulls.verts, hulls.n_verts,
                 trimesh.verts, trimesh.tris, trimesh.cell_tris, trimesh.origin, trimesh.cell_w,
                 n, hx, hy, flags, kk, hulls.capacity, hulls.max_verts, gx, gy, tcap,
                 min(tcap, max_tri_candidates), *out)
    launches += 1
    return out
