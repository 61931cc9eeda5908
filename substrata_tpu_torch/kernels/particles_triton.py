"""The per-particle update after the motion ray (kernel KI, Triton).

Replaces ``substrata_tpu/physics/particles.py:particles_step`` after its
ray (:99-136): reflection with restitution and the 1 mm surface nudge,
death on the surface or in the water with its foam flag, the buoyancy clamp
(vel_z >= 0.5 under water), gravity, quadratic air drag with its accel
clamp, the opacity and width fades, and ``alive``.

One ``@triton.jit`` kernel, one program per block of particles: a fused
elementwise pass over independent [P] rows with no reduction, so what
bounds it on the card is memory (~80 bytes read and ~37 written per
particle, ~240 KB at 2,048 particles).  Each field is read once and every
intermediate stays in registers.

Rounding: divisions and square roots take libdevice's correctly rounded
forms and the launch turns floating-point fusion off, so the kernel rounds
like ``particles_update_plain``, which CPU tensors take.  ``triton`` is
imported only inside the launching function.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from substrata_tpu_torch.kernels import build

AIR_RHO = 1.293
DRAG_CD = 0.5
MAX_DRAG_ACCEL = 10.0
SURFACE_NUDGE = 1.0e-3
BLOCK = 256

launches = 0

_kernel = None


def particles_update_plain(ps, hit_t, hit_n, hit_ok, dt, water_z):
    """-> (pos, vel, opacity, width, alive, foam_events)."""
    dt = torch.tensor(np.float32(dt))          # the reference's float32 dt
    vel, pos = ps.vel, ps.pos
    speed = torch.sqrt(vel[:, 0] * vel[:, 0] + vel[:, 1] * vel[:, 1] + vel[:, 2] * vel[:, 2])
    max_ts = speed * dt
    hit = hit_ok & ps.alive & (max_ts > 1e-6)
    to_hit_dt = torch.where(hit, hit_t / torch.clamp(speed, min=1e-9), 0.0)
    remaining = dt - to_hit_dt
    n = hit_n
    vn = n[:, 0] * vel[:, 0] + n[:, 1] * vel[:, 1] + n[:, 2] * vel[:, 2]
    vel_refl = (vel - n * (2.0 * vn)[:, None]) * ps.restitution[:, None]
    hitpos = pos + vel * to_hit_dt[:, None]
    pos_hit = hitpos + n * SURFACE_NUDGE + vel_refl * remaining[:, None]
    pos_free = pos + vel * dt
    pos = torch.where(hit[:, None], pos_hit, pos_free)
    vel = torch.where(hit[:, None], vel_refl, vel)
    died_on_surface = hit & ps.die_on_hit

    underwater = (~hit) & (pos[:, 2] < water_z)
    die_in_water = underwater & ps.die_on_hit & (vel[:, 2] < 0)
    foam = die_in_water & ps.alive
    vz_water = torch.clamp(vel[:, 2], min=0.5)
    vz_grav = vel[:, 2] - 9.81 * dt
    new_vz = torch.where(underwater, vz_water, torch.where(hit, vel[:, 2], vz_grav))
    vel = torch.cat([vel[:, :2], new_vz[:, None]], dim=1)

    v2 = vel[:, 0] * vel[:, 0] + vel[:, 1] * vel[:, 1] + vel[:, 2] * vel[:, 2]
    f_d = 0.5 * AIR_RHO * v2 * DRAG_CD * ps.area
    accel = torch.clamp(f_d / torch.clamp(ps.mass, min=1e-12), max=MAX_DRAG_ACCEL)
    scale = torch.clamp(1.0 - accel * dt / torch.clamp(torch.sqrt(v2), min=1e-3), min=0.0)
    vel = vel * torch.where(v2 > 1e-6, scale, 1.0)[:, None]

    opacity = ps.opacity + ps.dopacity_dt * dt
    width = ps.width + ps.dwidth_dt * dt
    opacity = torch.where(died_on_surface | die_in_water, -1.0, opacity)
    alive = ps.alive & (opacity > 0.0)
    return pos, vel, opacity, width, alive, foam


def _triton_kernel():
    """Compile-on-first-use: triton exists only on the machine with the card."""
    global _kernel
    if _kernel is not None:
        return _kernel
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build.BUILD_DIR, "triton"))
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    @triton.jit
    def particles_kernel(pos, vel, area, mass, rest, width, dwidth, opac, dopac, die_on_hit,
                         alive, hit_t, hit_n, hit_ok, water_z, o_pos, o_vel, o_opac,
                         o_width, o_alive, o_foam, n, dt, BLOCK: tl.constexpr):
        i = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = i < n
        px = tl.load(pos + i * 3 + 0, mask=m, other=0.0)
        py = tl.load(pos + i * 3 + 1, mask=m, other=0.0)
        pz = tl.load(pos + i * 3 + 2, mask=m, other=0.0)
        vx = tl.load(vel + i * 3 + 0, mask=m, other=0.0)
        vy = tl.load(vel + i * 3 + 1, mask=m, other=0.0)
        vz = tl.load(vel + i * 3 + 2, mask=m, other=0.0)
        nx = tl.load(hit_n + i * 3 + 0, mask=m, other=0.0)
        ny = tl.load(hit_n + i * 3 + 1, mask=m, other=0.0)
        nz = tl.load(hit_n + i * 3 + 2, mask=m, other=0.0)
        ht = tl.load(hit_t + i, mask=m, other=0.0)
        hok = tl.load(hit_ok + i, mask=m, other=0) != 0
        al = tl.load(alive + i, mask=m, other=0) != 0
        doh = tl.load(die_on_hit + i, mask=m, other=0) != 0
        re = tl.load(rest + i, mask=m, other=0.0)
        ar = tl.load(area + i, mask=m, other=0.0)
        ma = tl.load(mass + i, mask=m, other=1.0)
        wd = tl.load(width + i, mask=m, other=0.0)
        dwd = tl.load(dwidth + i, mask=m, other=0.0)
        op = tl.load(opac + i, mask=m, other=0.0)
        dop = tl.load(dopac + i, mask=m, other=0.0)
        wz = tl.load(water_z)

        # Reflect + restitution (particles.py:99-112).
        speed = libdevice.sqrt_rn(vx * vx + vy * vy + vz * vz)
        max_t = speed * dt
        hit = hok & al & (max_t > 1e-6)
        to_hit = tl.where(hit, libdevice.div_rn(ht, tl.maximum(speed, 1e-9)), 0.0)
        remaining = dt - to_hit
        vn = nx * vx + ny * vy + nz * vz
        rx = (vx - nx * (2.0 * vn)) * re
        ry = (vy - ny * (2.0 * vn)) * re
        rz = (vz - nz * (2.0 * vn)) * re
        hx = (px + vx * to_hit) + nx * 1.0e-3 + rx * remaining
        hy = (py + vy * to_hit) + ny * 1.0e-3 + ry * remaining
        hz = (pz + vz * to_hit) + nz * 1.0e-3 + rz * remaining
        px = tl.where(hit, hx, px + vx * dt)
        py = tl.where(hit, hy, py + vy * dt)
        pz = tl.where(hit, hz, pz + vz * dt)
        vx = tl.where(hit, rx, vx)
        vy = tl.where(hit, ry, vy)
        vz = tl.where(hit, rz, vz)
        died = hit & doh

        # Water, gravity (:114-121).
        underwater = (~hit) & (pz < wz)
        die_water = underwater & doh & (vz < 0)
        foam = die_water & al
        vz = tl.where(underwater, tl.maximum(vz, 0.5), tl.where(hit, vz, vz - 9.81 * dt))

        # Quadratic air drag with the accel clamp (:123-128).
        v2 = vx * vx + vy * vy + vz * vz
        f_d = 0.6465 * v2 * 0.5 * ar
        accel = tl.minimum(libdevice.div_rn(f_d, tl.maximum(ma, 1e-12)), 10.0)
        scale = tl.maximum(1.0 - libdevice.div_rn(accel * dt,
                                                   tl.maximum(libdevice.sqrt_rn(v2), 1e-3)),
                           0.0)
        s = tl.where(v2 > 1e-6, scale, 1.0)

        # Fades and alive (:130-133).
        op = op + dop * dt
        wd = wd + dwd * dt
        op = tl.where(died | die_water, -1.0, op)
        tl.store(o_pos + i * 3 + 0, px, mask=m)
        tl.store(o_pos + i * 3 + 1, py, mask=m)
        tl.store(o_pos + i * 3 + 2, pz, mask=m)
        tl.store(o_vel + i * 3 + 0, vx * s, mask=m)
        tl.store(o_vel + i * 3 + 1, vy * s, mask=m)
        tl.store(o_vel + i * 3 + 2, vz * s, mask=m)
        tl.store(o_opac + i, op, mask=m)
        tl.store(o_width + i, wd, mask=m)
        tl.store(o_alive + i, al & (op > 0.0), mask=m)
        tl.store(o_foam + i, foam, mask=m)

    _kernel = particles_kernel
    return _kernel


def particles_update(ps, hit_t, hit_n, hit_ok, dt, water_z):
    """KI: ``particles_update_plain`` for CPU tensors, the Triton kernel for
    CUDA tensors."""
    global launches
    if ps.pos.device.type == "cpu":
        return particles_update_plain(ps, hit_t, hit_n, hit_ok, dt, water_z)
    dev = ps.pos.device
    p = ps.pos.shape[0]
    f32, bl = torch.float32, torch.bool
    for t, name, dtype, shp in (
            (ps.pos, "pos", f32, (p, 3)), (ps.vel, "vel", f32, (p, 3)),
            (ps.area, "area", f32, (p,)), (ps.mass, "mass", f32, (p,)),
            (ps.restitution, "restitution", f32, (p,)), (ps.width, "width", f32, (p,)),
            (ps.dwidth_dt, "dwidth_dt", f32, (p,)), (ps.opacity, "opacity", f32, (p,)),
            (ps.dopacity_dt, "dopacity_dt", f32, (p,)),
            (ps.die_on_hit, "die_on_hit", bl, (p,)), (ps.alive, "alive", bl, (p,)),
            (hit_t, "hit_t", f32, (p,)), (hit_n, "hit_n", f32, (p, 3)),
            (hit_ok, "hit_ok", bl, (p,)), (water_z, "water_z", f32, ())):
        build.check(t, name, dtype, shp, dev)
    kernel = _triton_kernel()
    out = (torch.empty_like(ps.pos), torch.empty_like(ps.vel), torch.empty_like(ps.opacity),
           torch.empty_like(ps.width), torch.empty_like(ps.alive), torch.empty_like(ps.alive))
    kernel[((p + BLOCK - 1) // BLOCK,)](
        ps.pos, ps.vel, ps.area, ps.mass, ps.restitution, ps.width, ps.dwidth_dt,
        ps.opacity, ps.dopacity_dt, ps.die_on_hit, ps.alive, hit_t, hit_n, hit_ok, water_z,
        *out, p, float(np.float32(dt)), BLOCK=BLOCK, enable_fp_fusion=False)
    launches += 1
    return out
