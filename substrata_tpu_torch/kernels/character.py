"""The character controller's update (kernel KL).

Replaces ``substrata_tpu/physics/character.py``: the candidate gather
``_gather_capsule_candidates`` (:108-144), the capsule probe
``_capsule_probe`` (:147-242), ``_support_info`` (:245),
``_remove_component`` (:259), ``character_update`` (:264-500) and the
packed readback of ``_player_update_packed`` (:504-523), as one function
of the tick's scalars:

  scal [8] f32: dt, move (3), jump, fly, sitting (> 0 = on), and the
  excluded body slot as int32 bits (the serving tick's input head,
  ``physics/world.py``'s ``_TIN_SCAL`` block);

returning the new character fields and the packed vector
``[campos (4), jumped, on_ground, pos (3), vel (3), ground_vel (3),
touched (K)]``, K = 6 static rows + the candidate rows.  The static rows
are the capsule segment's three sample spheres against the heightfield,
then the same three against every triangle of their trimesh grid cells
(the deepest, the first on ties; invalid when the world has no trimesh).

The candidate rows are, in the reference's order: the 27-cell
neighbourhoods (``_NEIGHBOR_OFFSETS`` order, ``cell_capacity`` slots each)
of two capsule centres — three when ``cell_size`` < 2.9 m, the stick-down
extreme — and then the oversize slots from ``kernels.pairs._compact``.  Every
``argmax`` takes the first maximum, so this order fixes the result.

``character_packed_plain`` evaluates a probe's contact only on rows that
pass the candidate's own sphere test and only for the candidate's own
shape (the reference evaluates all four shapes on every row and selects):
the rows it skips are invalid in both, and no output reads an invalid
row's values.  It branches in Python on the stair and stick conditions
(the reference's two ``lax.cond``).  ``character_packed`` launches
``csrc/character.cu`` for CUDA tensors — one block, the branches inside —
and runs the twin for CPU tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from substrata_tpu_torch.kernels import build, cell_table
from substrata_tpu_torch.kernels import closed_forms as cf
from substrata_tpu_torch.kernels.static_contacts import trimesh_sphere_rows
from substrata_tpu_torch.maths import fp
from substrata_tpu_torch.maths import quat as quatm
from substrata_tpu_torch.physics.state import BodyState, Heightfield, ShapeType, TriMesh

# PlayerPhysics.cpp:24-33 (substrata_tpu/physics/character.py:40-51)
RUN_FACTOR = 5.0
MOVE_SPEED = 3.0
JUMP_SPEED = 4.5
MAX_AIR_SPEED = 8.0
JUMP_PERIOD = 0.1
SPHERE_RAD = 0.3
CYLINDER_HEIGHT = 1.3
SITTING_HEIGHT = 0.3
EYE_HEIGHT = 1.67
STICK_TO_FLOOR_STEP = 0.5
STAIR_STEP_UP = 0.4
MAX_SLOPE_COS = 0.6428  # cos(50 deg), Jolt CharacterVirtual default
MAX_PROBE_CONTACTS = 40
N_STATIC = 6             # 3 heightfield rows, then 3 trimesh rows
N_PACKED_HEAD = 15

# Fields of the character state, in the order the kernel takes them.
STATE_FIELDS = ("pos", "vel", "on_ground", "ground_normal", "ground_vel",
                "campos_z_delta", "gravity_enabled", "fly_mode", "sitting")

launches = 0


def n_centers(cell_size: float) -> int:
    """Gather centres: the foot before and after integration, plus the
    stick-down extreme when a cell is too small to guarantee it
    (character.py:121)."""
    return 3 if cell_size < 2.0 * (SPHERE_RAD + 0.5 * CYLINDER_HEIGHT + 0.5) else 2


def n_rows(cell_size: float, cell_capacity: int, n_oversize: int) -> int:
    """Probe rows K: the static rows plus the candidate rows."""
    return N_STATIC + n_centers(cell_size) * 27 * cell_capacity + n_oversize


def _neighbor_offsets(device):
    """The 27 (dx, dy, dz) offsets, dx outermost (broadphase.py:34)."""
    o = torch.arange(27, device=device, dtype=torch.int32)
    return torch.stack([o // 9 - 1, (o // 3) % 3 - 1, o % 3 - 1], dim=1)


def _ez(device):
    return quatm.basis((), 2, device)


@dataclasses.dataclass
class Candidates:
    idx: torch.Tensor          # [Kc] body slot (-1 = empty)
    ok: torch.Tensor           # [Kc] alive, collidable, not sensor, not excluded
    pos: torch.Tensor
    quat: torch.Tensor
    shape_type: torch.Tensor
    shape_params: torch.Tensor
    bound_radius: torch.Tensor
    linvel: torch.Tensor
    angvel: torch.Tensor


def gather_candidates(foot_a, foot_b, cyl_h, body: BodyState, table, os_idx,
                      cell_size: float, grid_dim: int, exclude) -> Candidates:
    """The candidate rows of one update (character.py:108-144)."""
    dev = body.device
    half_h = 0.5 * cyl_h
    centers = [foot_a, foot_b]
    if n_centers(cell_size) == 3:
        centers.append(foot_b - torch.tensor([0.0, 0.0, 0.5], device=dev))
    offs = _neighbor_offsets(dev)
    up_r = torch.tensor([0.0, 0.0, SPHERE_RAD], device=dev)
    cands = []
    for foot in centers:
        center = foot + up_r + _ez(dev) * half_h
        cell = torch.floor(center * fp.recip(cell_size)).to(torch.int32)
        hb = cell_table.hash_cells(cell[None, :] + offs, grid_dim * grid_dim)
        cands.append(table[hb].reshape(-1))
    cand = torch.cat(cands + [os_idx.to(table.dtype)])
    ci = torch.clamp(cand, min=0).long()
    ok = ((cand >= 0) & (cand != exclude) & body.alive[ci] & body.collidable[ci]
          & ~body.is_sensor[ci])
    return Candidates(idx=cand, ok=ok, pos=body.pos[ci], quat=body.quat[ci],
                      shape_type=body.shape_type[ci], shape_params=body.shape_params[ci],
                      bound_radius=body.bound_radius[ci], linvel=body.linvel[ci],
                      angvel=body.angvel[ci])


def _contacts(center, half_h, c: Candidates, rows):
    """The probe contact of candidate rows ``rows`` against capsule centres
    ``center`` [M, 3] (character.py:163-186, each row's own shape only).
    Returns (normal, pen, point, velocity, valid) for those rows."""
    dev = center.device
    st = c.shape_type[rows]
    prm = c.shape_params[rows]
    pb, qb = c.pos[rows], c.quat[rows]
    m = rows.shape[0]
    pts = torch.zeros((m, 4, 3), device=dev)
    pens = torch.zeros((m, 4), device=dev)
    nrm = torch.zeros((m, 3), device=dev)
    val = torch.zeros((m, 4), dtype=torch.bool, device=dev)

    def run(mask, fn):
        i = mask.nonzero(as_tuple=True)[0]
        if i.numel():
            up_q = quatm.identity((i.numel(),), device=dev)
            rad = torch.full((i.numel(),), SPHERE_RAD, device=dev)
            pts[i], pens[i], nrm[i], val[i] = fn(i, center[i], up_q, rad,
                                                 half_h.expand(i.numel()))

    def sphere(i, ctr, up_q, rad, hh):
        p, e, n, v = cf.sphere_capsule(pb[i], prm[i, 0], ctr, up_q, rad, hh)
        return p, e, -n, v

    def capsule(i, ctr, up_q, rad, hh):
        return cf.capsule_capsule(ctr, up_q, rad, hh, pb[i], qb[i], prm[i, 0], prm[i, 1])

    def boxy(i, ctr, up_q, rad, hh):
        # Boxes take params[:3], hulls params[1:4] (character.py:169-170).
        he = torch.where((st[i] == int(ShapeType.BOX))[:, None], prm[i, :3], prm[i, 1:4])
        return cf.capsule_box(ctr, up_q, rad, hh, pb[i], qb[i], he)

    is_s, is_c = st == int(ShapeType.SPHERE), st == int(ShapeType.CAPSULE)
    run(is_s, sphere)
    run(is_c, capsule)
    run(~is_s & ~is_c, boxy)
    k = torch.argmax(torch.where(val, pens, -1e9), dim=1)
    pen = torch.gather(pens, 1, k[:, None])[:, 0]
    ok = torch.gather(val, 1, k[:, None])[:, 0]
    pt = torch.gather(pts, 1, k[:, None, None].expand(m, 1, 3))[:, 0]
    cvel = c.linvel[rows] + quatm.cross(c.angvel[rows], pt - pb)
    return nrm, pen, pt, cvel, ok


def _trimesh_rows(samples, tm: TriMesh | None):
    """The three trimesh rows of each probe (character.py:204-227): each
    sample sphere against all ``cap`` triangles of its grid cell -> (normal,
    pen, point, ok) [M, 3, ...]; a sample whose cell holds no triangle (or
    a world without a trimesh) gives the invalid row (0, 0, 1), -1e9, 0."""
    m, dev = samples.shape[0], samples.device
    n = quatm.basis((m, 3), 2, dev)
    pen = torch.full((m, 3), -1e9, device=dev)
    pt = torch.zeros((m, 3, 3), device=dev)
    if tm is None or tm.count == 0:
        return n, pen, pt, torch.zeros((m, 3), dtype=torch.bool, device=dev)
    flat = samples.reshape(m * 3, 3)
    tpen, tcp, tcn, tok = trimesh_sphere_rows(
        tm, flat, torch.full((m * 3,), SPHERE_RAD, device=dev), tm.cell_tris.shape[2])
    best = torch.argmax(tpen, dim=1)
    r = torch.arange(m * 3, device=dev)
    anyc = tok.any(dim=1)
    pen = torch.where(anyc, tpen[r, best], -1e9).reshape(m, 3)
    pt = torch.where(anyc[:, None], tcp[r, best], 0.0).reshape(m, 3, 3)
    n = torch.where(anyc[:, None], tcn[r, best], n.reshape(m * 3, 3)).reshape(m, 3, 3)
    return n, pen, pt, pen > -0.05


def capsule_probe(feet, cyl_h, c: Candidates, hf: Heightfield, has_hf,
                  trimesh: TriMesh | None = None):
    """All contacts of the character capsule at each foot position
    (character.py:147-242) for feet [M, 3].

    Returns (normal [M, K, 3] away from the obstacle, pen [M, K], point,
    body id [K], contact velocity, valid)."""
    dev = feet.device
    m, kc = feet.shape[0], c.idx.shape[0]
    center = feet + torch.stack([torch.zeros_like(cyl_h), torch.zeros_like(cyl_h),
                                 SPHERE_RAD + 0.5 * cyl_h])
    half_h = 0.5 * cyl_h
    d = c.pos[None] - center[:, None]
    reach = c.bound_radius + half_h + SPHERE_RAD + 0.6
    okc = c.ok[None] & (quatm.dot3(d, d) <= (reach * reach)[None])
    n_b = quatm.basis((m, kc), 2, dev)
    pen_b = torch.full((m, kc), -1e9, device=dev)
    pt_b = torch.zeros((m, kc, 3), device=dev)
    vel_b = torch.zeros((m, kc, 3), device=dev)
    ok_b = torch.zeros((m, kc), dtype=torch.bool, device=dev)
    mi, ri = okc.nonzero(as_tuple=True)
    if mi.numel():
        n_b[mi, ri], pen_b[mi, ri], pt_b[mi, ri], vel_b[mi, ri], ok_b[mi, ri] = _contacts(
            center[mi], half_h, c, ri)

    # Static world: 3 sample spheres along the segment, on the heightfield
    # and on the trimesh.
    z0 = torch.zeros_like(half_h)
    samples = torch.stack([center + torch.stack([z0, z0, -half_h]), center,
                           center + torch.stack([z0, z0, half_h])], dim=1)   # [M, 3, 3]
    h, hfn = hf.sample_with_normal(samples[..., :2])
    hf_pen = (h - (samples[..., 2] - SPHERE_RAD)) * hfn[..., 2]
    hf_pt = torch.cat([samples[..., :2], h[..., None]], dim=-1)
    hf_ok = has_hf & (hf_pen > -0.05)
    tm_n, tm_pen, tm_pt, tm_ok = _trimesh_rows(samples, trimesh)
    n_all = torch.cat([hfn, tm_n, n_b], dim=1)
    pen_all = torch.cat([hf_pen, tm_pen, pen_b], dim=1)
    pt_all = torch.cat([hf_pt, tm_pt, pt_b], dim=1)
    vel_all = torch.cat([torch.zeros((m, 6, 3), device=dev), vel_b], dim=1)
    ok_all = torch.cat([hf_ok, tm_ok, ok_b], dim=1)
    id_all = torch.cat([torch.full((N_STATIC,), -1, dtype=c.idx.dtype, device=dev), c.idx])
    return n_all, pen_all, pt_all, id_all, vel_all, ok_all


def support_info(feet, n, pen, pt, vel, ok):
    """Ground detection per foot (character.py:245-256)."""
    lower = pt[..., 2] <= (feet[:, 2] + SPHERE_RAD * 1.05)[:, None]
    touching = ok & lower & (pen > -0.02)
    supported = torch.any(touching, dim=1)
    gi = torch.argmax(torch.where(touching, n[..., 2], -1e9), dim=1)
    r = torch.arange(feet.shape[0], device=feet.device)
    gn = torch.where(supported[:, None], n[r, gi], _ez(feet.device))
    gv = torch.where(supported[:, None], vel[r, gi], 0.0)
    return supported, gn, gv, gn[:, 2] < MAX_SLOPE_COS


def _norm3(v):
    return torch.sqrt(quatm.dot3(v, v))


def _max_ok_pen(pen, ok):
    return torch.where(ok, pen, -1e9).max(dim=1).values


def character_packed_plain(char: dict, body: BodyState, hf: Heightfield, has_hf, water_z,
                           table, os_idx, scal, *, cell_size: float, grid_dim: int,
                           trimesh: TriMesh | None = None):
    """One substep of PlayerPhysics::update (character.py:264-523).
    Returns (new character fields, packed [15 + K])."""
    dev = body.device
    ez = _ez(dev)
    dt, move = scal[0], scal[1:4]
    jump, fly, sitting = scal[4] > 0, scal[5] > 0, scal[6] > 0
    exclude = scal[7:8].view(torch.int32)[0]
    cyl_h = torch.where(sitting, SITTING_HEIGHT, CYLINDER_HEIGHT)
    allow_sliding = quatm.dot3(move, move) > 0.0
    gravity_enabled = char["gravity_enabled"] | allow_sliding | jump | fly
    vel, foot = char["vel"], char["pos"]
    # Divisions by constants take a tensor divisor (see closed_forms.capsule_box).
    frac_sub = torch.clamp((water_z - foot[2]) / torch.full_like(water_z, EYE_HEIGHT), 0.0, 1.0)
    foot_next = foot + (vel + move) * dt
    c = gather_candidates(foot, foot_next, cyl_h, body, table, os_idx, cell_size, grid_dim,
                          exclude)

    def probe(feet):
        return capsule_probe(feet, cyl_h, c, hf, has_hf, trimesh)

    def probe1(f):
        n, pen, pt, bid, cv, ok = probe(f[None])
        return n[0], pen[0], pt[0], bid, cv[0], ok[0]

    n, pen, pt, _, cvel, ok = probe(foot[None])
    supported, gnormal, gvel, steep = (x[0] for x in support_info(foot[None], n, pen, pt,
                                                                   cvel, ok))

    # Velocity update (non-fly), fly mode, jump, anti-slide.
    flat = torch.tensor([1.0, 1.0, 0.0], device=dev)
    parallel_vel = torch.where(frac_sub < 0.3, move * flat, move)
    on_ground_now = supported & ((vel[2] - gvel[2]) < 0.1)
    ground_vel_new = parallel_vel + gvel
    pl = _norm3(parallel_vel)
    air_par = torch.where(pl > MAX_AIR_SPEED,
                          parallel_vel * (MAX_AIR_SPEED / torch.clamp(pl, min=1e-9)),
                          parallel_vel)
    air_vel_new = vel + air_par * dt
    vel_walk = torch.where(on_ground_now, ground_vel_new, air_vel_new)
    grav = torch.where(gravity_enabled, (-9.81 + 9.81 * 1.1 * frac_sub) * dt, 0.0)
    vel_walk = vel_walk + ez * grav
    vel_walk = vel_walk * torch.where(gravity_enabled,
                                      1.0 - torch.clamp(2.0 * frac_sub * dt, max=0.2), 1.0)
    vel_walk = torch.cat([vel_walk[:2], torch.clamp(vel_walk[2:], min=-100.0)])
    speed = _norm3(vel)
    mlen = _norm3(move)
    desired_fly = torch.where(mlen < 1e-4, 0.0, move / torch.clamp(mlen, min=1e-9) * speed)
    vel_fly = vel + (move * 3.0 + (desired_fly - vel) * 2.0) * dt
    vel = torch.where(fly, vel_fly, vel_walk)
    do_jump = jump & supported
    jump_up = ez * JUMP_SPEED
    jump_vel_walk = (move - gnormal * torch.clamp(quatm.dot3(move, gnormal), max=0.0)
                     + gvel + jump_up)
    jump_vel_fly = vel + jump_up
    vel = torch.where(do_jump, torch.where(fly, jump_vel_fly, jump_vel_walk), vel)
    static_ground = supported & (quatm.dot3(gvel, gvel) < 1e-8)
    anti_slide = ~allow_sliding & static_ground & ~steep & ~do_jump & ~fly
    vel = torch.where(anti_slide, vel * ez * (vel[2] > 0), vel)

    # Collide and slide: three probes, four cancel passes each.
    was_supported = supported
    old_foot = foot
    desired_vel_pre = vel
    foot = foot + vel * dt
    for _ in range(3):
        n, pen, pt, _, cvel, ok = probe1(foot)
        deep = torch.where(ok, pen, -1e9)
        di = torch.argmax(deep)
        foot = foot + torch.where(deep[di] > 0.0, n[di] * deep[di], 0.0)
        touching = ok & (pen > -0.01)
        for _ in range(4):
            vn = quatm.dot3(n, vel[None]) - quatm.dot3(n, cvel)
            viol = torch.where(touching, -vn, -1e9)
            k = torch.argmax(viol)
            vel = torch.where(viol[k] > 0.0, vel - n[k] * vn[k], vel)

    # Stair walk (step-up 0.4).
    desired_h = (desired_vel_pre * dt) * flat
    desired_len = _norm3(desired_h)
    achieved_h = (foot - old_foot) * flat
    fwd = desired_h / torch.clamp(desired_len, min=1e-9)
    achieved_len = torch.clamp(quatm.dot3(achieved_h, fwd), min=0.0)
    blocked = (desired_len > 1e-5) & (achieved_len + 1e-4 < desired_len * 0.5)
    step_fwd = fwd * torch.clamp(desired_len - achieved_len, min=0.02)
    up_foot = foot + ez * STAIR_STEP_UP + step_fwd
    pre_stair_z = foot[2]
    do_stairs = torch.zeros((), dtype=torch.bool, device=dev)
    if bool(blocked & was_supported & ~fly):
        zoffs9 = torch.arange(1, 10, dtype=torch.float32, device=dev) * 0.05

        def dscan(feet):
            n3, pen3, pt3, _, v3, ok3 = probe(feet)
            deep3 = _max_ok_pen(pen3, ok3)
            sup, _, _, steep3 = support_info(feet, n3, pen3, pt3, v3, ok3)
            return (deep3 > 0.0) & (deep3 < 0.08), deep3, sup, steep3

        _, pen2, _, _, _, ok2 = probe1(up_foot)
        clear_up = ~torch.any(ok2 & (pen2 > 0.01))
        probe_land = up_foot[None, :] - zoffs9[:, None] * ez
        cont, deep_s, sup_s, steep_s = dscan(probe_land)
        found = torch.any(cont)
        k = torch.argmax(cont.to(torch.int32))
        land_flat = sup_s[k] & ~steep_s[k]
        _, tpen, _, _, _, tok = probe1(up_foot + fwd * 0.15)
        tclear = ~torch.any(tok & (tpen > 0.01))
        tcont, _, tsup, tsteep = dscan(probe_land + fwd * 0.15)
        test_ok = tclear & torch.any(tcont & tsup & ~tsteep)
        do_stairs = clear_up & found & (land_flat | test_ok)
        foot = torch.where(do_stairs, probe_land[k] + ez * torch.clamp(deep_s[k], min=0.0),
                           foot)

    # Stick to floor (step-down 0.5).
    n4, pen4, pt4, _, v4, ok4 = probe(foot[None])
    sup_now = support_info(foot[None], n4, pen4, pt4, v4, ok4)[0][0]
    moving_up = (foot[2] - old_foot[2]) / torch.clamp(dt, min=1e-9) > 1e-6
    stuck = torch.zeros((), dtype=torch.bool, device=dev)
    if bool(was_supported & ~sup_now & ~moving_up & ~fly & ~do_jump):
        zoffs3 = torch.tensor([0.1, 0.25, 0.5], device=dev)
        probe3 = foot[None, :] - zoffs3[:, None] * ez
        n5, pen5, pt5, _, v5, ok5 = probe(probe3)
        sup5, _, _, steep5 = support_info(probe3, n5, pen5, pt5, v5, ok5)
        sup3 = sup5 & ~steep5
        deep3 = _max_ok_pen(pen5, ok5)
        stuck = torch.any(sup3)
        first = torch.argmax(sup3.to(torch.int32))
        foot = torch.where(stuck, probe3[first] + ez * torch.clamp(deep3[first], min=0.0), foot)

    # Final ground state, camera smoothing, touched bodies.
    n6, pen6, pt6, bid6, v6, ok6 = probe(foot[None])
    sup_f, gn_f, gv_f, _ = (x[0] for x in support_info(foot[None], n6, pen6, pt6, v6, ok6))
    on_ground = sup_f & ((vel[2] - gv_f[2]) < 0.1)
    dz = foot[2] - pre_stair_z
    cz0 = char["campos_z_delta"]
    cz = cz0 - 20.0 * dt * cz0
    cz = torch.where(torch.abs(cz) < 1e-5, 0.0, cz)
    cz = torch.clamp(cz + torch.where(do_stairs | stuck, dz, 0.0), -0.3, 0.3)
    campos = torch.stack([foot[0] - 0.0 * cz, foot[1] - 0.0 * cz,
                          (foot[2] + EYE_HEIGHT) - cz, 1.0 - 0.0 * cz])
    touched = torch.where(ok6[0] & (pen6[0] > -0.01) & (bid6 >= 0), bid6, -1)
    new = dict(pos=foot, vel=vel, on_ground=on_ground, ground_normal=gn_f, ground_vel=gv_f,
               campos_z_delta=cz, gravity_enabled=gravity_enabled, fly_mode=fly,
               sitting=sitting)
    packed = torch.cat([campos, do_jump.to(torch.float32)[None],
                        on_ground.to(torch.float32)[None], foot, vel, gv_f,
                        touched.to(torch.float32)])
    return new, packed


def character_packed(char: dict, body: BodyState, hf: Heightfield, has_hf, water_z, table,
                     os_idx, scal, *, cell_size: float, grid_dim: int,
                     trimesh: TriMesh | None = None, out=None):
    """KL: ``character_packed_plain`` for CPU tensors, ``csrc/character.cu``
    (one block, one launch) for CUDA tensors.  ``out``, when given, is the
    [15 + K] float32 tensor the packed vector goes to (a view into the
    tick's readback buffer)."""
    global launches
    if body.pos.device.type == "cpu":
        new, packed = character_packed_plain(char, body, hf, has_hf, water_z, table, os_idx,
                                             scal, cell_size=cell_size, grid_dim=grid_dim,
                                             trimesh=trimesh)
        if out is not None:
            out.copy_(packed)
            packed = out
        return new, packed
    dev = body.pos.device
    n = body.capacity
    cap = table.shape[1]
    k = n_rows(cell_size, cap, os_idx.shape[0])
    f32, i32, bl = torch.float32, torch.int32, torch.bool
    hx, hy = hf.heights.shape
    shapes = dict(pos=(3,), vel=(3,), on_ground=(), ground_normal=(3,), ground_vel=(3,),
                  campos_z_delta=(), gravity_enabled=(), fly_mode=(), sitting=())
    for name, shp in shapes.items():
        build.check(char[name], name, bl if shp == () and name != "campos_z_delta" else f32,
                    shp, dev)
    for t, name, dt, shp in (
            (body.pos, "pos", f32, (n, 3)), (body.quat, "quat", f32, (n, 4)),
            (body.linvel, "linvel", f32, (n, 3)), (body.angvel, "angvel", f32, (n, 3)),
            (body.shape_type, "shape_type", i32, (n,)),
            (body.shape_params, "shape_params", f32, (n, 4)),
            (body.bound_radius, "bound_radius", f32, (n,)), (body.alive, "alive", bl, (n,)),
            (body.layer, "layer", i32, (n,)), (body.is_sensor, "is_sensor", bl, (n,)),
            (table, "table", i32, (grid_dim * grid_dim + 1, cap)),
            (os_idx, "os_idx", i32, (os_idx.shape[0],)),
            (hf.heights, "heights", f32, (hx, hy)), (hf.origin, "hf_origin", f32, (2,)),
            (hf.cell_w, "hf_cell_w", f32, ()), (has_hf, "has_heightfield", bl, ()),
            (water_z, "water_z", f32, ()), (scal, "scal", f32, (8,))):
        build.check(t, name, dt, shp, dev)
    use_tm = trimesh is not None and trimesh.count > 0
    if use_tm:
        for t, name, dt, shp in (
                (trimesh.verts, "tri_verts", f32, (trimesh.verts.shape[0], 3)),
                (trimesh.tris, "tris", i32, (trimesh.tris.shape[0], 3)),
                (trimesh.cell_tris, "cell_tris", i32, tuple(trimesh.cell_tris.shape)),
                (trimesh.origin, "tri_origin", f32, (2,)),
                (trimesh.cell_w, "tri_cell_w", f32, ())):
            build.check(t, name, dt, shp, dev)
        tm_args = (trimesh.verts, trimesh.tris, trimesh.cell_tris, trimesh.origin,
                   trimesh.cell_w, *trimesh.cell_tris.shape)
    else:
        tm_args = (None,) * 5 + (0, 0, 0)
    new = {name: torch.empty(shp, dtype=char[name].dtype, device=dev)
           for name, shp in shapes.items()}
    if out is None:
        out = torch.empty(N_PACKED_HEAD + k, dtype=f32, device=dev)
    build.check(out, "out", f32, (N_PACKED_HEAD + k,), dev)
    build.launch("character_update", *(char[f] for f in STATE_FIELDS), body.pos, body.quat,
                 body.linvel, body.angvel, body.shape_type, body.shape_params,
                 body.bound_radius, body.alive, body.layer, body.is_sensor, table, os_idx,
                 hf.heights, hf.origin, hf.cell_w, has_hf, water_z, scal,
                 *tm_args[:5], grid_dim * grid_dim, cap, os_idx.shape[0], n_centers(cell_size),
                 hx, hy, 1 if hf.is_flat else 0, *tm_args[5:], fp.recip(cell_size),
                 *(new[f] for f in STATE_FIELDS), out)
    launches += 1
    return new, out
