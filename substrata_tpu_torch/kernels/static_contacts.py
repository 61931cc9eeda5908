"""Ground contacts: every body's sample points against the heightfield
(kernel KB).

Replaces ``substrata_tpu/physics/narrowphase.py:static_contacts`` (:911,
heightfield branch) with ``shape_sample_points`` (:804) and
``Heightfield.sample_with_normal`` (state.py:208): 8 sample points per
body, penetration projected on the surface normal, contact point, the
eligibility mask (:1005-1007), the 0.5 m clamp, and the K deepest samples
per body with the LOWER sample index first on ties, as ``lax.top_k`` picks
them (:1017).  The selected sample becomes the warm-start key
(``slot + 1``), so the tie order decides which cached impulses warm the
next step.  Rows are body-blocked: rows n*K .. n*K+K-1 belong to body n.

``static_contacts`` launches ``csrc/static_contacts.cu`` for CUDA tensors
and runs ``static_contacts_plain`` for CPU tensors.
"""

from __future__ import annotations

import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.kernels.box_box import CONTACT_MARGIN, combine_friction
from substrata_tpu_torch.maths import quat as quatm
from substrata_tpu_torch.physics.state import BodyState, Heightfield, ShapeType

launches = 0

_CORNERS = [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]


def shape_sample_points(body: BodyState, present=(True, True, True, True)):
    """Per-body sample points [N, 8, 3] (world), radii [N] and slot mask
    [N, 8]: sphere = centre (radius r), capsule = 2 endpoints (radius r),
    box = 8 corners (radius 0).  ``present`` mirrors the reference: absent
    shape types contribute no candidate, and the last candidate is the
    default for every body whose type has none."""
    if present[int(ShapeType.HULL)]:
        raise NotImplementedError(
            "hull sample points are not ported yet (ROADMAP.md queue 1, "
            "slice 3: the other shapes)")
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


def static_contacts_plain(body: BodyState, hf: Heightfield, has_heightfield,
                          k: int, present):
    """Body-blocked ground contact rows [N*k].

    Returns (a, b, point, normal, pen, valid, friction, restitution, key)."""
    n = body.capacity
    dev = body.device
    pts, radius, slot_valid = shape_sample_points(body, present)
    flat = pts.reshape(n * 8, 3)
    rad = radius.repeat_interleave(8)
    h, hf_n = hf.sample_with_normal(flat[:, :2])
    pen = (h - (flat[:, 2] - rad)) * hf_n[:, 2]
    point = torch.where((rad > 0)[:, None], flat - hf_n * rad[:, None],
                        torch.stack([flat[:, 0], flat[:, 1], h], dim=1))
    normal = hf_n.expand(n * 8, 3)
    elig = (body.alive & body.collidable & body.dynamic & ~body.is_sensor
            & body.awake)
    ok = (has_heightfield & (pen > -CONTACT_MARGIN) & slot_valid.reshape(-1)
          & elig.repeat_interleave(8))
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
                    present):
    """KB: ``static_contacts_plain`` for CPU tensors,
    ``csrc/static_contacts.cu`` (one thread per body) for CUDA tensors."""
    global launches
    if body.device.type == "cpu":
        return static_contacts_plain(body, hf, has_heightfield, k, present)
    if present[int(ShapeType.HULL)]:
        raise NotImplementedError(
            "hull sample points are not ported yet (ROADMAP.md queue 1, "
            "slice 3: the other shapes)")
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
            (has_heightfield, "has_heightfield", bl, ())):
        build.check(t, name, dt, shp, dev)
    hx, hy = hf.heights.shape
    kk = min(k, 8)
    r = n * kk
    out = (torch.empty(r, dtype=i32, device=dev), torch.empty(r, dtype=i32, device=dev),
           torch.empty((r, 3), dtype=f32, device=dev),
           torch.empty((r, 3), dtype=f32, device=dev),
           torch.empty(r, dtype=f32, device=dev), torch.empty(r, dtype=bl, device=dev),
           torch.empty(r, dtype=f32, device=dev), torch.empty(r, dtype=f32, device=dev),
           torch.empty(r, dtype=i32, device=dev))
    present_mask = sum(1 << i for i, on in enumerate(present) if on)
    build.launch("static_contacts", body.pos, body.quat, body.shape_type,
                 body.shape_params, body.alive, body.layer, body.motion_type,
                 body.is_sensor, body.awake, body.friction, body.restitution,
                 hf.heights, hf.origin, hf.cell_w, has_heightfield, n, hx, hy, (1 if hf.is_flat else 0) | (present_mask << 1), kk, *out)
    launches += 1
    return out
