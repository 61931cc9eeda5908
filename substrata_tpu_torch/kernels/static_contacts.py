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
and runs ``static_contacts_plain`` for CPU tensors.  Its plan holds the
static world's tensors, checked once; a call checks the body fields and
passes one packed argument.
"""

from __future__ import annotations

import struct

import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.kernels.box_box import CONTACT_MARGIN, combine_friction
from substrata_tpu_torch.kernels.closed_forms import closest_point_triangle, safe_normalize_fma
from substrata_tpu_torch.maths import fp
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
    and a 30° ring of 8 directions around it, the first on ties.  The
    frame's cross products and norm, the ring's u1 cos + u2 sin and the
    scores round as the jitted reference contracts them."""
    n, dev = quat.shape[0], quat.device
    down = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    down[:, 2] = -1.0
    down_l = quatm.inverse_rotate_vec(quat, down)
    ax = torch.where((torch.abs(down_l[:, 0:1]) < 0.9), quatm.basis((n,), 0, dev),
                     quatm.basis((n,), 1, dev))
    u1 = quatm.cross_fma(ax, down_l)
    u1 = u1 / torch.clamp(fp.sqrt(quatm.dot3_fma(u1, u1)), min=1e-9)[:, None]
    u2 = quatm.cross_fma(down_l, u1)
    c = torch.tensor(RING_COS, dtype=torch.float32, device=dev)[None, :, None]
    s = torch.tensor(RING_SIN, dtype=torch.float32, device=dev)[None, :, None]
    dirs = down_l[:, None, :] * 0.866 + fp.fma(u1[:, None, :], c, u2[:, None, :] * s) * 0.5
    scores = quatm.dot3_fma(hverts[:, None, :, :], dirs[:, :, None, :])    # [N, 8, V]
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
    dist = fp.sqrt(quatm.dot3_fma(delta, delta))
    tri_n = safe_normalize_fma(quatm.cross_fma(v1 - v0, v2 - v0))
    side = quatm.dot3_fma(p - v0, tri_n)
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
    point = torch.where((rad > 0)[:, None], fp.fma(-hf_n, rad[:, None], flat),
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


# The call's own tensors, in the launcher's order: the bodies' fields.
_BODY_NAMES = ("pos", "quat", "shape_type", "shape_params", "alive", "layer", "motion_type",
               "is_sensor", "awake", "friction", "restitution")
_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
_BODY_DTYPES = (_F32, _F32, _I32, _F32, _BOOL, _I32, _I32, _BOOL, _BOOL, _F32, _F32)
_STATIC_NAMES = ("heights", "origin", "cell_w", "has_heightfield", "hull_verts",
                 "hull_n_verts", "tri_verts", "tris", "cell_tris", "tri_origin", "tri_cell_w")
# The launcher's argument buffer: 11 body pointers, 11 static-world
# pointers, 11 sizes, 9 output pointers (csrc/static_contacts.cu).
_PACK = struct.Struct("=42q")
# The output rows as views of one buffer: the 4-byte fields, then valid.
_ROW_BYTES = (4, 4, 12, 12, 4, 4, 4, 4, 1)
_MAX_PLANS = 8
_plans: dict = {}


class _Plan:
    """What one static world and configuration fix for every call: the
    static world's tensors (checked once, held so that their ids stay
    theirs and their pointers valid), the launcher's constant pointers and
    sizes, and the shapes of the call's body fields."""

    def __init__(self, static, hf, hulls, trimesh, n, k, present, max_tri_candidates):
        dev = static[0].device
        hx, hy = hf.heights.shape
        gx, gy, tcap = trimesh.cell_tris.shape
        build.check_all(dev, static, _STATIC_NAMES, (
            _F32, _F32, _F32, _BOOL, _F32, _I32, _F32, _I32, _I32, _F32, _F32), (
            (hx, hy), (2,), (), (), (hulls.capacity, hulls.max_verts, 3), (hulls.capacity,),
            (trimesh.verts.shape[0], 3), (trimesh.tris.shape[0], 3), (gx, gy, tcap), (2,), ()))
        use_tm = trimesh.tris.shape[0] > 1
        present_mask = sum(1 << i for i, on in enumerate(present) if on)
        flags = (1 if hf.is_flat else 0) | (present_mask << 1) | ((1 << 5) if use_tm else 0)
        self.static = static
        self.device = dev
        self.k = min(k, 8)
        self.rows = n * self.k
        self.body_shapes = ((n, 3), (n, 4), (n,), (n, 4), (n,), (n,), (n,), (n,), (n,), (n,),
                            (n,))
        self.ptrs = tuple(t.data_ptr() for t in static)
        self.sizes = (n, hx, hy, flags, self.k, hulls.capacity, hulls.max_verts, gx, gy, tcap,
                      min(tcap, max_tri_candidates))
        self.split = [b * self.rows for b in _ROW_BYTES]


def _plan(body, hf, has_heightfield, k, present, hulls, trimesh, max_tri_candidates):
    static = (hf.heights, hf.origin, hf.cell_w, has_heightfield, hulls.verts, hulls.n_verts,
              trimesh.verts, trimesh.tris, trimesh.cell_tris, trimesh.origin, trimesh.cell_w)
    key = (tuple(map(id, static)), hf.is_flat, body.pos.shape[0], k, tuple(present),
           max_tri_candidates)
    plan = _plans.get(key)
    if plan is None:
        if len(_plans) >= _MAX_PLANS:
            _plans.pop(next(iter(_plans)))
        plan = _plans[key] = _Plan(static, hf, hulls, trimesh, body.pos.shape[0], k, present,
                                   max_tri_candidates)
    return plan


def static_contacts(body: BodyState, hf: Heightfield, has_heightfield, k: int,
                    present, hulls: HullLibrary, trimesh: TriMesh,
                    max_tri_candidates: int = 16):
    """KB: ``static_contacts_plain`` for CPU tensors,
    ``csrc/static_contacts.cu`` (a warp per eligible body over a trimesh, a
    thread per body otherwise) for CUDA tensors.  The outputs are views of
    one buffer."""
    global launches
    if body.device.type == "cpu":
        return static_contacts_plain(body, hf, has_heightfield, k, present, hulls, trimesh,
                                     max_tri_candidates)
    plan = _plan(body, hf, has_heightfield, k, present, hulls, trimesh, max_tri_candidates)
    dyn = (body.pos, body.quat, body.shape_type, body.shape_params, body.alive, body.layer,
           body.motion_type, body.is_sensor, body.awake, body.friction, body.restitution)
    build.check_all(plan.device, dyn, _BODY_NAMES, _BODY_DTYPES, plan.body_shapes)
    r = plan.rows
    buf = torch.empty(49 * r, dtype=torch.uint8, device=plan.device)
    a, b, point, normal, pen, fr, re, key, valid = buf.split(plan.split)
    out = (a.view(_I32), b.view(_I32), point.view(_F32).view(r, 3),
           normal.view(_F32).view(r, 3), pen.view(_F32), valid.view(_BOOL), fr.view(_F32),
           re.view(_F32), key.view(_I32))
    build.launch_packed("static_contacts", _PACK.pack(*[t.data_ptr() for t in dyn], *plan.ptrs,
                                                      *plan.sizes,
                                                      *[t.data_ptr() for t in out]))
    launches += 1
    return out
