"""Generic convex-vs-convex contacts for the hull combos (kernel KO).

Replaces ``substrata_tpu/physics/narrowphase.py``: ``_convex_rep`` (:499),
``_convex_convex`` (:404) and ``_make_convex_kernel`` (:538) for the combo
codes that involve a hull (3, 7, 11, 12, 13, 14 and 15), with the bucket
epilogue of ``pair_contacts`` (:729-775, ``closed_forms.bucket_rows_plain``).

Each side is a convex set: a sphere is its centre with its radius, a
capsule its two segment ends with its radius, a box its 8 corners and 6
face planes, a hull its library vertices and face planes (``params[0]``
is the hull's library slot).  The contact is SAT over both sides' face
planes and two auxiliary axes (the direction between the closest vertices
and the centre axis), face axes preferred unless an axis is better by the
0.98 / 0.001 rule (:446-448).  A face axis gives the reference face's
manifold: the incident side's 4 deepest vertices past the plane (a sphere
or capsule incident side pads to 4 slots); an auxiliary axis gives one
point between the two supports.  The normal points from B to A.

Every arg-reduction takes the lower index on ties, as ``jnp.argmax``,
``jnp.argmin`` and ``lax.top_k`` do: the face argmax, the flat argmin of
the vertex distances over [Va, Vb] (:425), the top-4 depths (:458) and the
support arguments (:473-474).  A face of a cube has four vertices at
near-equal depth, so these ties are the common case.  The reference's
one-hot products (``oh @ pl``) select one row exactly; the port indexes
the row.

Products are written out component by component, in the order
``csrc/convex.cu`` computes them.  ``convex_buckets`` runs every hull
bucket of a step in one launch of the kernel for CUDA tensors (its bucket
table a plan per layout, its rows written into the caller's contact rows
or a ``contact_rows.contact_buffer`` of their own) and
``convex_rows_plain`` per bucket for CPU tensors; ``convex_rows`` is its
one-bucket call.
"""

from __future__ import annotations

import struct

import torch

from substrata_tpu_torch.kernels import build, contact_rows
from substrata_tpu_torch.kernels.box_box import CONTACT_MARGIN
from substrata_tpu_torch.kernels.closed_forms import (bucket_rows_plain, safe_normalize,
                                                      slot_offsets)
from substrata_tpu_torch.maths import quat as quatm
from substrata_tpu_torch.physics.state import HullLibrary, ShapeType

CODES = (3, 7, 11, 12, 13, 14, 15)   # the combo codes with a hull side
NEG = -3e38
POS = 3e38

launches = 0
MAX_BUCKETS = len(CODES)  # a bucket a code; csrc/convex.cu:kMaxBuckets
_TILE = 32                # csrc/convex.cu:kTile: slots a tile (one ballot word)
_TILE_BLOCKS = 8          # csrc/convex.cu:kBlocksPerTile: blocks of 4 warps a tile
# csrc/convex.cu:convex_buckets: 13 input and 10 output pointers, blocked,
# the number of buckets and of blocks, the library's capacity, max verts
# and max faces; then the bucket table (contact_rows.BucketPlan).
_PACK = struct.Struct("=29q")
_BUCKET = contact_rows.BUCKET
_NO_BLOCK = contact_rows.NO_BLOCK
_plans = {}


def _tile_blocks(slots):
    """A bucket's blocks: ``_TILE_BLOCKS`` a tile of ``_TILE`` slots."""
    return -(-slots // _TILE) * _TILE_BLOCKS

_CORNERS = [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
_NORMALS = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]


def convex_rep(stype: int, pos, quat, prm, hulls: HullLibrary):
    """World-space convex representation of bodies [K] of shape class
    ``stype`` (narrowphase.py:499): (verts [K, V, 3], mask [K, V], radius
    [K], planes [K, F, 4], plane mask [K, F])."""
    k = pos.shape[0]
    dev = pos.device
    zero_pl = torch.zeros((k, 1, 4), device=dev)
    no_pl = torch.zeros((k, 1), dtype=torch.bool, device=dev)
    if stype == int(ShapeType.SPHERE):
        return pos[:, None, :], torch.ones((k, 1), dtype=torch.bool, device=dev), \
            prm[:, 0], zero_pl, no_pl
    if stype == int(ShapeType.CAPSULE):
        z = quatm.rotate_vec(quat, quatm.basis((k,), 2, dev)) * prm[:, 1:2]
        return torch.stack([pos + z, pos - z], dim=1), \
            torch.ones((k, 2), dtype=torch.bool, device=dev), prm[:, 0], zero_pl, no_pl
    if stype == int(ShapeType.BOX):
        local = torch.tensor(_CORNERS, dtype=torch.float32, device=dev)[None] * prm[:, None, :3]
        verts = pos[:, None, :] + quatm.rotate_vec(quat[:, None, :], local)
        n_w = quatm.rotate_vec(quat[:, None, :], torch.tensor(_NORMALS, dtype=torch.float32,
                                                              device=dev)[None].expand(k, 6, 3))
        he6 = prm[:, [0, 0, 1, 1, 2, 2]]
        d = he6 + quatm.dot3(n_w, pos[:, None, :])
        return verts, torch.ones((k, 8), dtype=torch.bool, device=dev), \
            torch.zeros((k,), device=dev), torch.cat([n_w, d[..., None]], dim=-1), \
            torch.ones((k, 6), dtype=torch.bool, device=dev)
    hid = torch.clamp(prm[:, 0].to(torch.int32), 0, hulls.capacity - 1).long()
    local = hulls.verts[hid]
    verts = pos[:, None, :] + quatm.rotate_vec(quat[:, None, :], local)
    mask = torch.arange(local.shape[1], device=dev)[None] < hulls.n_verts[hid][:, None]
    pl = hulls.planes[hid]
    n_w = quatm.rotate_vec(quat[:, None, :], pl[..., :3])
    d = pl[..., 3] + quatm.dot3(n_w, pos[:, None, :])
    plmask = torch.arange(pl.shape[1], device=dev)[None] < hulls.n_faces[hid][:, None]
    return verts, mask, torch.zeros((k,), device=dev), torch.cat([n_w, d[..., None]], dim=-1), \
        plmask


def _row(x, idx):
    """x [K, M, ...] at per-slot row idx [K]."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _face_seps(pl, plmask, w_other, mask_other, r_other):
    """Separation along each face of one side: min over the other side's
    vertices of n·v, minus its radius, minus d (narrowphase.py:414-419)."""
    proj = quatm.dot3(w_other[:, None, :, :], pl[:, :, None, :3])       # [K, F, V]
    mn = torch.where(mask_other[:, None, :], proj, POS).min(dim=2).values
    return torch.where(plmask, (mn - r_other[:, None]) - pl[..., 3], NEG)


def _face_manifold(pl, sep, vin, maskin, rin):
    """The reference face's manifold (narrowphase.py:451-465): the incident
    vertices' 4 largest depths past the face, the lower index first on
    ties; a side with fewer than 4 vertices pads with (index 0, NEG)."""
    j = torch.argmax(sep, dim=1)
    plj = _row(pl, j)
    n, d = plj[:, :3], plj[:, 3]
    depth = torch.where(maskin, (d + rin)[:, None] - quatm.dot3(vin, n[:, None, :]), NEG)
    k = min(4, vin.shape[1])
    top_d, top_i = torch.sort(depth, dim=1, descending=True, stable=True)
    top_d, top_i = top_d[:, :k], top_i[:, :k]
    if k < 4:
        top_d = torch.cat([top_d, torch.full((vin.shape[0], 4 - k), NEG, device=vin.device)], 1)
        top_i = torch.cat([top_i, torch.zeros((vin.shape[0], 4 - k), dtype=top_i.dtype,
                                              device=vin.device)], 1)
    vsel = torch.gather(vin, 1, top_i[..., None].expand(-1, -1, 3))
    pts = vsel - n[:, None, :] * (rin[:, None] - 0.5 * torch.clamp(top_d, min=0.0))[..., None]
    return pts, top_d, n, top_d > -CONTACT_MARGIN


def convex_convex(ra, rb, pa, pb):
    """narrowphase.py:_convex_convex on batched representations ``ra``,
    ``rb`` (``convex_rep``) with centres ``pa``, ``pb`` [K, 3]: (pts [K, 4,
    3], pens [K, 4], normal [K, 3] from B to A, valid [K, 4])."""
    wa, maska, rad_a, pl_a, plm_a = ra
    wb, maskb, rad_b, pl_b, plm_b = rb
    kk = wa.shape[0]
    dev = wa.device
    sep_a = _face_seps(pl_a, plm_a, wb, maskb, rad_b)
    sep_b = _face_seps(pl_b, plm_b, wa, maska, rad_a)

    # Auxiliary axes: closest vertices (flat argmin over [Va, Vb]), centres.
    diff = wa[:, :, None, :] - wb[:, None, :, :]
    d2 = quatm.dot3(diff, diff)
    d2 = torch.where(maska[:, :, None] & maskb[:, None, :], d2, POS)
    flat = torch.argmin(d2.reshape(kk, -1), dim=1)
    ia, ib = flat // wb.shape[1], flat % wb.shape[1]
    axis1 = safe_normalize(_row(wb, ib) - _row(wa, ia))
    axis2 = safe_normalize(pb - pa)
    aux = torch.stack([axis1, axis2], dim=1)                              # [K, 2, 3]
    pa_dot = quatm.dot3(wa[:, None, :, :], aux[:, :, None, :])            # [K, 2, Va]
    pb_dot = quatm.dot3(wb[:, None, :, :], aux[:, :, None, :])
    pa_dot = torch.where(maska[:, None, :], pa_dot, NEG)
    pb_dot = torch.where(maskb[:, None, :], pb_dot, POS)
    sa = pa_dot.max(dim=2).values + rad_a[:, None]
    sb = pb_dot.min(dim=2).values - rad_b[:, None]
    sep_aux = sb - sa                                                     # [K, 2]

    best_a = sep_a.max(dim=1).values
    best_b = sep_b.max(dim=1).values
    best_x = sep_aux.max(dim=1).values
    separated = torch.maximum(torch.maximum(best_a, best_b), best_x) > CONTACT_MARGIN
    best_face = torch.maximum(best_a, best_b)
    use_aux = best_x > best_face * 0.98 + 0.001
    use_b = ~use_aux & (best_b > best_a * 0.98 + 0.001)

    pts_a, pen_a, n_a, val_a = _face_manifold(pl_a, sep_a, wb, maskb, rad_b)
    pts_b, pen_b, n_b, val_b = _face_manifold(pl_b, sep_b, wa, maska, rad_a)

    sel = torch.argmax(sep_aux, dim=1)
    u = _row(aux, sel)
    ia_s = torch.argmax(_row(pa_dot, sel), dim=1)
    ib_s = torch.argmin(_row(pb_dot, sel), dim=1)
    pa_s = _row(wa, ia_s) + u * rad_a[:, None]
    pb_s = _row(wb, ib_s) - u * rad_b[:, None]
    pen_x = -best_x
    pts_x = torch.zeros((kk, 4, 3), device=dev)
    pts_x[:, 0] = 0.5 * (pa_s + pb_s)
    pens_x = torch.full((kk, 4), -1e9, device=dev)
    pens_x[:, 0] = pen_x
    val_x = torch.zeros((kk, 4), dtype=torch.bool, device=dev)
    val_x[:, 0] = pen_x > -CONTACT_MARGIN

    ux, ub = use_aux[:, None], use_b[:, None]
    pts = torch.where(ux[..., None], pts_x, torch.where(ub[..., None], pts_b, pts_a))
    pens = torch.where(ux, pens_x, torch.where(ub, pen_b, pen_a))
    normal = torch.where(ux, -u, torch.where(ub, n_b, -n_a))
    valid = torch.where(ux, val_x, torch.where(ub, val_b, val_a)) & ~separated[:, None]
    return pts, pens, normal, valid


def convex_contact(code: int, pa, qa, prma, pb, qb, prmb, hulls: HullLibrary):
    """``_make_convex_kernel(code // 4, code % 4)`` on per-side rows."""
    ra = convex_rep(code // 4, pa, qa, prma, hulls)
    rb = convex_rep(code % 4, pb, qb, prmb, hulls)
    return convex_convex(ra, rb, pa, pb)


def convex_rows_plain(code: int, wm: int, blocked: bool, pos, quat, shape_params, friction,
                      restitution, is_sensor, ba, bb, bvalid, hulls: HullLibrary):
    """``wm`` rows per bucket slot [cap * wm] for the bucket pairs (``ba``,
    ``bb``) of one hull code, as ``closed_forms.closed_form_rows_plain``
    returns them.  Only occupied slots are evaluated, here and in the
    kernel: an empty slot's rows are invalid whatever its manifold, and its
    points, depths and normal are (0, -1e9, (0, 0, 1))."""
    cap, dev = ba.shape[0], pos.device
    pts = torch.zeros((cap, 4, 3), device=dev)
    pens = torch.full((cap, 4), -1e9, device=dev)
    normal = torch.zeros((cap, 3), device=dev)
    normal[:, 2] = 1.0
    valid = torch.zeros((cap, 4), dtype=torch.bool, device=dev)
    i = torch.nonzero(bvalid, as_tuple=True)[0]
    if i.numel():
        a, b = ba[i].long(), bb[i].long()
        pts[i], pens[i], normal[i], valid[i] = convex_contact(
            code, pos[a], quat[a], shape_params[a], pos[b], quat[b], shape_params[b], hulls)
    manifold = (pts, pens, normal, valid)
    return bucket_rows_plain(wm, blocked, manifold, friction, restitution, is_sensor, ba, bb,
                             bvalid)


def convex_buckets(buckets, wms, blocked: bool, pos, quat, shape_params, friction,
                   restitution, is_sensor, hulls: HullLibrary, out=None):
    """KO over a step's hull buckets [(code, ba, bb, bvalid)], of ``wms[k]``
    rows a slot in bucket k.

    ``out`` is (fields, touching, rows_at, touch_at) as
    ``contact_rows.placed`` takes it (any 9 fields and flags of the rows'
    shapes); where it is None, the rows go to a buffer of their own, the
    buckets one after another.
    ``convex_rows_plain`` per bucket for CPU tensors; for CUDA tensors one
    launch of ``csrc/convex.cu`` from one packed argument, its bucket table
    the plan of this layout (codes, slots, widths,
    ``closed_forms.slot_offsets``, placement, device).  Returns each
    bucket's 10 outputs (a, b, point, normal, pen, valid, friction,
    restitution, key, touching) as views of the buffer, or nothing where
    ``out`` is given."""
    global launches
    nb = len(buckets)
    if not 1 <= nb <= MAX_BUCKETS:
        raise ValueError(f"{nb} buckets: 1..{MAX_BUCKETS} in one launch")
    if len(wms) != nb:
        raise ValueError(f"{len(wms)} widths for {nb} buckets")
    for (code, *_), w in zip(buckets, wms):
        if code not in CODES:
            raise ValueError(f"combo code {code} has no hull side")
        if not 1 <= w <= 4:
            raise ValueError(f"manifold width {w} outside 1..4")
    dev = pos.device
    caps = tuple(b[1].shape[0] for b in buckets)
    own = out is None
    fields, touch, rows_at, touch_at = contact_rows.placed(out, caps, wms, dev)
    views = (contact_rows.placed_views(fields, touch, rows_at, touch_at, caps, wms)
             if own or dev.type == "cpu" else None)
    rows = (pos, quat, shape_params, friction, restitution, is_sensor)
    if dev.type == "cpu":
        for (code, ba, bb, bv), w, v in zip(buckets, wms, views):
            contact_rows.copied(convex_rows_plain(code, w, blocked, *rows, ba, bb, bv, hulls),
                                v)
        return views if own else None
    if hulls.max_verts > 32 or hulls.max_faces > 32:
        raise ValueError("convex_buckets: the kernel holds at most 32 hull vertices and faces")
    n, h = pos.shape[0], hulls.capacity
    f32, i32, bl = torch.float32, torch.int32, torch.bool
    build.check_all(dev, rows + (hulls.verts, hulls.n_verts, hulls.planes, hulls.n_faces),
                    ("pos", "quat", "shape_params", "friction", "restitution", "is_sensor",
                     "hull_verts", "hull_n_verts", "hull_planes", "hull_n_faces"),
                    (f32, f32, f32, f32, f32, bl, f32, i32, f32, i32),
                    ((n, 3), (n, 4), (n, 4), (n,), (n,), (n,), (h, hulls.max_verts, 3), (h,),
                     (h, hulls.max_faces, 4), (h,)))
    for (code, ba, bb, bv), cap in zip(buckets, caps):
        build.check_all(dev, (ba, bb, bv), ("ba", "bb", "bvalid"), (i32, i32, bl),
                        ((cap,), (cap,), (cap,)))
    offs = slot_offsets(buckets)
    codes, wms = tuple(b[0] for b in buckets), tuple(wms)
    plan = build.plan(_plans, (codes, caps, wms, offs, rows_at, touch_at, dev),
                      lambda: contact_rows.BucketPlan(codes, caps, wms, offs, rows_at, touch_at,
                                                      MAX_BUCKETS, _tile_blocks))
    build.launch_packed("convex_buckets", _PACK.pack(
        *(buckets[0][i].data_ptr() for i in (1, 2, 3)), *(x.data_ptr() for x in rows),
        hulls.verts.data_ptr(), hulls.n_verts.data_ptr(), hulls.planes.data_ptr(),
        hulls.n_faces.data_ptr(), *(f.data_ptr() for f in fields), touch.data_ptr(),
        1 if blocked else 0, nb, plan.blocks, h, hulls.max_verts, hulls.max_faces)
        + plan.table)
    launches += 1
    return views if own else None


def convex_rows(code: int, wm: int, blocked: bool, pos, quat, shape_params, friction,
                restitution, is_sensor, ba, bb, bvalid, hulls: HullLibrary, out=None):
    """KO on one bucket: ``convex_buckets`` with one bucket.  ``out``: the
    10 outputs' tensors to write, or None for views of a buffer of its
    own."""
    bucket = [(code, ba, bb, bvalid)]
    rows = (pos, quat, shape_params, friction, restitution, is_sensor)
    if out is None:
        return convex_buckets(bucket, (wm,), blocked, *rows, hulls)[0]
    convex_buckets(bucket, (wm,), blocked, *rows, hulls, out=(out[:9], out[9], (0,), (0,)))
    return out
