"""Sphere, box and capsule closed-form contacts (kernel KK).

Replaces the closed-form branches of
``substrata_tpu/physics/narrowphase.py``: ``_safe_normalize`` (:72),
``_one_point`` (:96), ``_sphere_sphere`` (:103), ``_sphere_box`` (:112),
``_closest_pt_segment_segment`` (:134), ``_capsule_capsule`` (:154),
``_sphere_capsule`` (:163), ``_box_sdf`` (:170), ``_capsule_box`` (:178),
``_flip3`` (:559) and ``_CLOSED_FORM_KERNELS`` (:564-583) for combo codes
0, 1, 2, 4, 6, 8, 9 and 10, with the per-bucket epilogue of
``pair_contacts`` (:729-775): the speculative prune, sensor, friction and
restitution, ``wm`` rows per pair slot and ``key = b*4 + slot + 9``.

Every routine here works on tensors with any leading batch shape and
returns a 4-slot manifold ``(points [..., 4, 3], pens [..., 4], normal
[..., 3], valid [..., 4])``.  The character controller's probe
(``kernels/character.py``) calls the same routines with its capsule as
operand A.  Products are written out component by component, in the order
``csrc/closed_forms.cuh`` computes them, so the kernel and this twin
round alike.

``closed_form_buckets`` runs every closed-form bucket of a step in one
launch of ``csrc/closed_forms.cu`` for CUDA tensors (its bucket table a
plan per layout, its rows written into the caller's contact rows or a
``contact_rows.contact_buffer`` of their own) and
``closed_form_rows_plain`` per bucket for CPU tensors;
``closed_form_rows`` is its one-bucket call.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from substrata_tpu_torch.kernels import build, contact_rows
from substrata_tpu_torch.kernels.box_box import (CONTACT_MARGIN, _norm3, combine_friction,
                                                 combine_restitution, prune_speculative,
                                                 segment_closest)
from substrata_tpu_torch.maths import fp
from substrata_tpu_torch.maths import quat as quatm

_THIRD = float(np.float32(1.0) / np.float32(3.0))
CODES = (0, 1, 2, 4, 6, 8, 9, 10)   # the closed-form combo codes (5 is KA)

launches = 0
MAX_BUCKETS = len(CODES)  # a bucket a code; csrc/closed_forms.cu:kMaxBuckets
_BLOCK = 128             # csrc/closed_forms.cu:kThreads: slots a block
# csrc/closed_forms.cu:closed_form_buckets: 9 input and 10 output pointers,
# blocked, the number of buckets and of blocks; then the bucket table
# (contact_rows.BucketPlan).
_PACK = struct.Struct("=22q")
_BUCKET = contact_rows.BUCKET
_NO_BLOCK = contact_rows.NO_BLOCK
_plans = {}


def safe_normalize(v, eps=1e-12):
    """v / |v|, or (0, 0, 1) where |v|^2 <= eps."""
    n2 = quatm.dot3(v, v)
    safe = v * (1.0 / torch.sqrt(torch.clamp(n2, min=eps)))[..., None]
    return torch.where((n2 > eps)[..., None], safe, quatm.basis(v.shape[:-1], 2, v.device))


def safe_normalize_fma(v, eps=1e-12):
    """``safe_normalize`` with |v|^2 as the jitted reference reduces
    ``jnp.sum(v * v)`` (``quat.dot3_fma``): the trimesh rows' face normal."""
    n2 = quatm.dot3_fma(v, v)
    safe = v * (1.0 / fp.sqrt(torch.clamp(n2, min=eps)))[..., None]
    return torch.where((n2 > eps)[..., None], safe, quatm.basis(v.shape[:-1], 2, v.device))


def _one_point(point, pen, normal, ok):
    """Slot 0 holds the contact; slots 1-3 are empty (0, -1e9, invalid)."""
    shp = pen.shape
    pts = torch.cat([point[..., None, :],
                     torch.zeros(shp + (3, 3), dtype=point.dtype, device=point.device)], dim=-2)
    pens = torch.cat([pen[..., None],
                      torch.full(shp + (3,), -1e9, dtype=pen.dtype, device=pen.device)], dim=-1)
    valid = torch.cat([ok[..., None], torch.zeros(shp + (3,), dtype=torch.bool,
                                                  device=ok.device)], dim=-1)
    return pts, pens, normal, valid


def sphere_sphere(pa, ra, pb, rb):
    d = pa - pb
    dist = _norm3(d)
    n = safe_normalize(d)
    pen = ra + rb - dist
    point = pb + n * (rb - 0.5 * pen)[..., None]
    return _one_point(point, pen, n, pen > -CONTACT_MARGIN)


def sphere_box(ps, rs, pb, qb, he):
    p = quatm.inverse_rotate_vec(qb, ps - pb)
    c = torch.minimum(torch.maximum(p, -he), he)
    delta = p - c
    dist = _norm3(delta)
    outside = dist > 1e-9
    depth_axes = he - torch.abs(p)
    ax = torch.argmin(depth_axes, dim=-1)
    p_ax = torch.gather(p, -1, ax[..., None])[..., 0]
    d_ax = depth_axes.min(dim=-1).values
    s = torch.where(p_ax < 0, -1.0, 1.0)           # sign(p_ax) + (p_ax == 0)
    oh = (torch.arange(3, device=p.device) == ax[..., None]).to(p.dtype)
    n_in = oh * s[..., None]
    n_local = torch.where(outside[..., None], safe_normalize(delta), n_in)
    pen = torch.where(outside, rs - dist, rs + d_ax)
    surf_local = torch.where(outside[..., None], c, p + n_in * d_ax[..., None])
    n = quatm.rotate_vec(qb, n_local)
    point = pb + quatm.rotate_vec(qb, surf_local)
    return _one_point(point, pen, n, pen > -CONTACT_MARGIN)


def _axis(q, h):
    """The capsule's half segment: rotate_vec(q, e_z) * h."""
    return quatm.rotate_vec(q, quatm.basis(q.shape[:-1], 2, q.device)) * h[..., None]


def capsule_capsule(pa, qa, ra, ha, pb, qb, rb, hb):
    za, zb = _axis(qa, ha), _axis(qb, hb)
    t1, t2 = segment_closest(pa, za, pb, zb)
    return sphere_sphere(pa + za * t1[..., None], ra, pb + zb * t2[..., None], rb)


def sphere_capsule(ps, rs, pc, qc, rc, hc):
    z = _axis(qc, hc)
    t = torch.clamp(quatm.dot3(ps - pc, z) / (quatm.dot3(z, z) + 1e-12), -1.0, 1.0)
    return sphere_sphere(ps, rs, pc + z * t[..., None], rc)


# The capsule-box search, as the jitted reference rounds it (found against
# jax.jit of ``_CLOSED_FORM_KERNELS[6]`` / ``[9]`` and of their parts): the
# rotation is ``quatm.rotate_vec`` (every jitted rotation contracts so), the
# segment point pc + z t is fma(z, t, pc), and the distance's norm
# (``box_sdf``) is the fma chain under sqrt.

def box_sdf(p, he):
    """Signed distance from p (box frame) to the box surface."""
    q = torch.abs(p) - he
    m = torch.clamp(q, min=0.0)
    return fp.sqrt(fp.dot3(m, m)) + torch.clamp(q.max(dim=-1).values, max=0.0)


def capsule_box(pc, qc, rc, hc, pb, qb, he, with_gap: bool = False):
    """14-step ternary search along the segment for the point nearest the
    box; slot 0 = that point's sphere contact, slot 1 = the deeper valid
    endpoint unless it lies within 0.5 rc of slot 0.

    With ``with_gap`` also the smallest |f(m1) - f(m2)| the search met: a
    segment parallel to a box face has a flat distance, and there the
    comparisons — so t* and the contact point along the face — are
    decided by rounding."""
    z = _axis(qc, hc)
    qb_inv = quatm.conjugate(qb)

    def dist(t):
        return box_sdf(quatm.rotate_vec(qb_inv, fp.fma(z, t[..., None], pc) - pb), he)

    lo = torch.full(rc.shape, -1.0, dtype=rc.dtype, device=rc.device)
    hi = torch.full(rc.shape, 1.0, dtype=rc.dtype, device=rc.device)
    gap = torch.full(rc.shape, float("inf"), dtype=rc.dtype, device=rc.device)
    # The reference's static division by 3 runs, under XLA, as one
    # multiply-add by the float32 reciprocal: fma(hi - lo, +-fl(1/3), lo | hi).
    for _ in range(14):
        m1 = fp.fma(hi - lo, _THIRD, lo)
        m2 = fp.fma(hi - lo, -_THIRD, hi)
        f1, f2 = dist(m1), dist(m2)
        closer = f1 < f2
        if with_gap:
            gap = torch.minimum(gap, torch.abs(f1 - f2))
        lo, hi = torch.where(closer, lo, m1), torch.where(closer, m2, hi)
    tstar = 0.5 * (lo + hi)
    p0, e0, n0, v0 = sphere_box(pc + z * tstar[..., None], rc, pb, qb, he)
    pt1 = torch.zeros_like(p0[..., 0, :])
    pen1 = torch.full(rc.shape, -1e9, dtype=rc.dtype, device=rc.device)
    val1 = torch.zeros(rc.shape, dtype=torch.bool, device=rc.device)
    for end in (-1.0, 1.0):
        pe, ee, _, ve = sphere_box(pc + z * end, rc, pb, qb, he)
        better = ve[..., 0] & (ee[..., 0] > pen1)
        pt1 = torch.where(better[..., None], pe[..., 0, :], pt1)
        pen1 = torch.where(better, ee[..., 0], pen1)
        val1 = val1 | better
    dup = _norm3(p0[..., 0, :] - pt1) < 0.5 * rc
    pts = torch.cat([p0[..., :1, :], pt1[..., None, :], p0[..., 2:, :]], dim=-2)
    pens = torch.cat([e0[..., :1], pen1[..., None], e0[..., 2:]], dim=-1)
    valid = torch.cat([v0[..., :1], (val1 & ~dup)[..., None], v0[..., 2:]], dim=-1)
    if with_gap:
        return pts, pens, n0, valid, gap
    return pts, pens, n0, valid


def closest_point_triangle(p, v0, v1, v2):
    """Closest point on triangle (v0, v1, v2) to p (Ericson 5.1.5,
    branch-free; narrowphase.py:870), rounded as the jitted reference
    contracts it: each of va, vb, vc one fma (its first product fused), the
    interior point two fmas, each edge point one.  KB's and KL's trimesh
    rows call it."""
    ab, ac, ap = v1 - v0, v2 - v0, p - v0
    d1, d2 = quatm.dot3(ab, ap), quatm.dot3(ac, ap)
    bp = p - v1
    d3, d4 = quatm.dot3(ab, bp), quatm.dot3(ac, bp)
    cp = p - v2
    d5, d6 = quatm.dot3(ab, cp), quatm.dot3(ac, cp)
    va = fp.fma(d3, d6, -(d5 * d4))
    vb = fp.fma(d5, d2, -(d1 * d6))
    vc = fp.fma(d1, d4, -(d3 * d2))
    denom = va + vb + vc

    def safe(x):
        return torch.where(torch.abs(x) > 1e-12, x, 1e-12)

    v = vb / safe(denom)
    w = vc / safe(denom)
    res = fp.fma(ac, w[..., None], fp.fma(ab, v[..., None], v0))

    def pick(mask, value):
        return torch.where(mask[..., None], value, res)

    res = pick((d1 <= 0) & (d2 <= 0), v0)
    res = pick((d3 >= 0) & (d4 <= d3), v1)
    res = pick((d6 >= 0) & (d5 <= d6), v2)
    t_ab = torch.clamp(d1 / safe(d1 - d3), 0, 1)
    res = pick((vc <= 0) & (d1 >= 0) & (d3 <= 0), fp.fma(t_ab[..., None], ab, v0))
    t_ac = torch.clamp(d2 / safe(d2 - d6), 0, 1)
    res = pick((vb <= 0) & (d2 >= 0) & (d6 <= 0), fp.fma(t_ac[..., None], ac, v0))
    t_bc = torch.clamp((d4 - d3) / safe((d4 - d3) + (d5 - d6)), 0, 1)
    res = pick((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
               fp.fma(t_bc[..., None], v2 - v1, v1))
    return res


def _flip(res):
    pts, pens, n, val = res
    return pts, pens, -n, val


def closed_form(code: int, pa, qa, prma, pb, qb, prmb):
    """``_CLOSED_FORM_KERNELS[code]`` on per-side rows (pos, quat, params)."""
    ra, rb = prma[..., 0], prmb[..., 0]
    if code == 0:
        return sphere_sphere(pa, ra, pb, rb)
    if code == 1:
        return sphere_box(pa, ra, pb, qb, prmb[..., :3])
    if code == 2:
        return sphere_capsule(pa, ra, pb, qb, rb, prmb[..., 1])
    if code == 4:
        return _flip(sphere_box(pb, rb, pa, qa, prma[..., :3]))
    if code == 6:
        return _flip(capsule_box(pb, qb, rb, prmb[..., 1], pa, qa, prma[..., :3]))
    if code == 8:
        return _flip(sphere_capsule(pb, rb, pa, qa, ra, prma[..., 1]))
    if code == 9:
        return capsule_box(pa, qa, ra, prma[..., 1], pb, qb, prmb[..., :3])
    if code == 10:
        return capsule_capsule(pa, qa, ra, prma[..., 1], pb, qb, rb, prmb[..., 1])
    raise ValueError(f"combo code {code} has no closed form")


def closed_form_rows_plain(code: int, wm: int, blocked: bool, pos, quat, shape_params,
                           friction, restitution, is_sensor, ba, bb, bvalid):
    """``wm`` rows per bucket slot [cap * wm] for the bucket pairs
    (``ba``, ``bb``) of one closed-form code.

    Returns (a, b, point, normal, pen, valid, friction, restitution, key,
    touching [cap]); ``a`` is -1 on empty slots in the blocked layout and
    the raw id in the compacted one, as the reference emits them."""
    a, b = ba.long(), bb.long()
    manifold = closed_form(code, pos[a], quat[a], shape_params[a], pos[b], quat[b],
                           shape_params[b])
    return bucket_rows_plain(wm, blocked, manifold, friction, restitution, is_sensor, ba, bb,
                             bvalid)


def bucket_rows_plain(wm: int, blocked: bool, manifold, friction, restitution, is_sensor,
                      ba, bb, bvalid):
    """The per-bucket epilogue of pair_contacts (narrowphase.py:729-775) on
    a bucket's 4-slot manifolds: the speculative prune, sensor, friction
    and restitution, ``wm`` rows per slot, ``key = b*4 + slot + 9`` and
    the touching flag (KK's and KO's, ``csrc/closed_forms.cuh:write_rows``)."""
    pts, pens, normal, valid = manifold
    cap = ba.shape[0]
    a, b = ba.long(), bb.long()
    valid = prune_speculative(pens, valid & bvalid[:, None])
    touching = torch.any(valid, dim=-1)
    sensor = is_sensor[a] | is_sensor[b]
    fr = combine_friction(friction[a], friction[b])
    re = combine_restitution(restitution[a], restitution[b])
    a32 = (torch.where(bvalid, a, -1) if blocked else a).to(torch.int32)
    b32 = b.to(torch.int32)
    slot = torch.arange(wm, dtype=torch.int32, device=pts.device)
    return (a32.repeat_interleave(wm), b32.repeat_interleave(wm),
            pts[:, :wm].reshape(cap * wm, 3), normal.repeat_interleave(wm, dim=0),
            pens[:, :wm].reshape(cap * wm),
            (valid[:, :wm] & ~sensor[:, None]).reshape(cap * wm),
            fr.repeat_interleave(wm), re.repeat_interleave(wm),
            (b32[:, None] * 4 + slot[None, :] + 9).reshape(cap * wm), touching)


def slot_offsets(buckets):
    """Each bucket's slot offset from the first bucket's.  The kernel reads
    every bucket's slots from the first bucket's ba, bb and bvalid, so each
    bucket's three must lie at one offset from the first's (views of one
    array each, as KT's grouping and ``hard_cases.closed_form_inputs`` lay
    them out); ValueError where they do not."""
    pa, pb, pv = (buckets[0][i].data_ptr() for i in (1, 2, 3))
    offs = []
    for code, ba, bb, bv in buckets:
        d = bv.data_ptr() - pv
        if ba.data_ptr() - pa != 4 * d or bb.data_ptr() - pb != 4 * d:
            raise ValueError(f"bucket of code {code}: its ba, bb and bvalid are not views of "
                             "the first bucket's arrays at one offset")
        offs.append(d)
    return tuple(offs)


def closed_form_buckets(buckets, wms, blocked: bool, pos, quat, shape_params, friction,
                        restitution, is_sensor, out=None):
    """KK over a step's closed-form buckets [(code, ba, bb, bvalid)], of
    ``wms[k]`` rows a slot in bucket k.

    ``out`` is (fields, touching, rows_at, touch_at): ``contact_rows.
    contact_buffer``'s views and each bucket's first row and slot in them;
    where it is None, the rows go to a buffer of their own, the buckets one
    after another.  ``closed_form_rows_plain`` per bucket for CPU tensors;
    for CUDA tensors one launch of ``csrc/closed_forms.cu`` from one packed
    argument, its bucket table the plan of this layout (codes, slots,
    widths, ``slot_offsets``, placement, device).  Returns each bucket's 10
    outputs (a, b, point, normal, pen, valid, friction, restitution, key,
    touching) as views of the buffer, or nothing where ``out`` is given."""
    global launches
    nb = len(buckets)
    if not 1 <= nb <= MAX_BUCKETS:
        raise ValueError(f"{nb} buckets: 1..{MAX_BUCKETS} in one launch")
    if len(wms) != nb:
        raise ValueError(f"{len(wms)} widths for {nb} buckets")
    for (code, *_), w in zip(buckets, wms):
        if code not in CODES:
            raise ValueError(f"combo code {code} has no closed form")
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
            contact_rows.copied(closed_form_rows_plain(code, w, blocked, *rows, ba, bb, bv), v)
        return views if own else None
    n = pos.shape[0]
    f32, i32, bl = torch.float32, torch.int32, torch.bool
    build.check_all(dev, rows, ("pos", "quat", "shape_params", "friction", "restitution",
                                "is_sensor"), (f32, f32, f32, f32, f32, bl),
                    ((n, 3), (n, 4), (n, 4), (n,), (n,), (n,)))
    for (code, ba, bb, bv), cap in zip(buckets, caps):
        build.check_all(dev, (ba, bb, bv), ("ba", "bb", "bvalid"), (i32, i32, bl),
                        ((cap,), (cap,), (cap,)))
    offs = slot_offsets(buckets)
    codes, wms = tuple(b[0] for b in buckets), tuple(wms)
    plan = build.plan(_plans, (codes, caps, wms, offs, rows_at, touch_at, dev),
                      lambda: contact_rows.BucketPlan(codes, caps, wms, offs, rows_at, touch_at,
                                                      MAX_BUCKETS, lambda c: -(-c // _BLOCK)))
    build.launch_packed("closed_form_buckets", _PACK.pack(
        *(buckets[0][i].data_ptr() for i in (1, 2, 3)), *(x.data_ptr() for x in rows),
        *(f.data_ptr() for f in fields), touch.data_ptr(), 1 if blocked else 0, nb,
        plan.blocks) + plan.table)
    launches += 1
    return views if own else None


def closed_form_rows(code: int, wm: int, blocked: bool, pos, quat, shape_params, friction,
                     restitution, is_sensor, ba, bb, bvalid):
    """KK on one bucket: ``closed_form_buckets`` with one bucket (its
    outputs views of one buffer)."""
    return closed_form_buckets([(code, ba, bb, bvalid)], (wm,), blocked, pos, quat,
                               shape_params, friction, restitution, is_sensor)[0]
