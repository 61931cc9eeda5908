"""Forces and semi-implicit Euler integration (kernel KD, Triton).

Replaces ``substrata_tpu/physics/integrate.py:apply_forces`` (:38) and
``integrate_positions`` (:93): gravity, Jolt-parity buoyancy and water
drag, linear/angular damping; then position and orientation integration
of awake moving bodies.

Each is one ``@triton.jit`` kernel, one program per block of bodies.  Both
are fused elementwise passes over independent [N] rows (no cross-row
traffic, no reduction, no shared memory), so what bounds them on the card
is memory: ``apply_forces`` reads ~100 bytes and writes 25 bytes per body,
``integrate_positions`` reads ~60 and writes 28; each launch moves about
1 MB at the 10k bench world.  The kernels read each field once and keep
every intermediate in registers.

Rounding: divisions and square roots use libdevice's correctly rounded
forms, the two speeds' squares and the buoyancy impulse's add are fmas
(``tl.fma``; the twin's ``quat.dot3_fma`` and ``fp.fma``), as the jitted
reference contracts them, the damping's exp is rounded once from float64 (``fp.exp``: the
card's and the CPU's float32 exps part in the last bit), and the launch
turns floating-point fusion off, so the kernels round like their plain
twins (``*_plain`` below), which CPU tensors take, on either device.
``triton`` is imported only inside the launching functions, and caches
what it compiles under ``_build/triton`` unless ``TRITON_CACHE_DIR`` says
otherwise.
"""

import os

import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.maths import fp
from substrata_tpu_torch.maths import quat as quatm
from substrata_tpu_torch.maths import transform as tmath
from substrata_tpu_torch.physics.state import (
    BodyState, MotionType, SimParams, WATER_ANGULAR_DRAG, WATER_DENSITY,
    WATER_LINEAR_DRAG,
)

BLOCK = 256

launches = {"apply_forces": 0, "integrate_positions": 0}

_kernels = None


def apply_forces_plain(body: BodyState, dt: float, params: SimParams):
    """Gravity, buoyancy and damping -> (linvel, angvel, in_water)."""
    dyn = body.dynamic & body.awake & body.alive
    dynf = dyn.to(torch.float32)[:, None]
    linvel = body.linvel + params.gravity[None, :] * (dt * body.gravity_factor[:, None]) * dynf

    r = torch.clamp(body.bound_radius, min=1e-6)
    pz = body.pos[:, 2]
    bottom = pz - r
    wz = params.water_z
    in_water = dyn & (bottom < wz)
    f = torch.clamp((wz - bottom) / (2.0 * r), 0.0, 1.0)
    frac = f * f * (3.0 - 2.0 * f)
    v_sub = body.volume * frac
    top_sub = torch.minimum(wz, pz + r)
    cob_z = 0.5 * (top_sub + bottom) - pz
    zero = torch.zeros_like(cob_z)
    cob = torch.stack([zero, zero, cob_z], dim=-1)
    inwf = in_water.to(torch.float32)
    neg_g = -params.gravity
    linvel = fp.fma(neg_g[None, :], (WATER_DENSITY * v_sub * body.inv_mass * dt * inwf)[:, None],
                    linvel)
    f_buoy = neg_g[None, :] * (WATER_DENSITY * v_sub * inwf)[:, None]
    tau = quatm.cross(cob, f_buoy)
    iw = tmath.world_inv_inertia(body.quat, body.inv_inertia)
    angvel = body.angvel + tmath.mat_vec(iw, tau) * dt

    drag_coeff = torch.where(body.use_zero_linear_drag, 0.0, WATER_LINEAR_DRAG)
    v_cob = linvel + quatm.cross(angvel, cob)
    speed = fp.sqrt(quatm.dot3_fma(v_cob, v_cob))[:, None]
    area = torch.clamp(v_sub, min=0.0) ** (2.0 / 3.0)
    drag_dv = -0.5 * WATER_DENSITY * speed * v_cob * (
        drag_coeff * area * body.inv_mass * dt * inwf)[:, None]
    drag_dv = torch.where(torch.abs(drag_dv) > torch.abs(v_cob), -v_cob, drag_dv)
    linvel = linvel + drag_dv

    wspeed = fp.sqrt(quatm.dot3_fma(angvel, angvel))[:, None]
    ang_dd = -0.5 * WATER_DENSITY * wspeed * angvel * (
        WATER_ANGULAR_DRAG * area[:, None] * r[:, None] ** 2 * body.inv_inertia
        * dt * inwf[:, None])
    ang_dd = torch.where(torch.abs(ang_dd) > torch.abs(angvel), -angvel, ang_dd)
    angvel = angvel + ang_dd

    lin_damp = fp.exp(-body.linear_damping * dt)[:, None]
    ang_damp = fp.exp(-body.angular_damping * dt)[:, None]
    linvel = torch.where(dyn[:, None], linvel * lin_damp, linvel)
    angvel = torch.where(dyn[:, None], angvel * ang_damp, angvel)
    return linvel, angvel, in_water


def integrate_positions_plain(body: BodyState, linvel, angvel, dt: float):
    """Semi-implicit Euler for awake non-static bodies -> (pos, quat)."""
    move = body.alive & body.awake & (body.motion_type != int(MotionType.STATIC))
    movef = move.to(torch.float32)[:, None]
    pos = body.pos + linvel * dt * movef
    q = quatm.integrate(body.quat, angvel, dt)
    return pos, torch.where(move[:, None], q, body.quat)


def _triton_kernels():
    """Compile-on-first-use: triton exists only on the machine with the card."""
    global _kernels, tl, libdevice
    if _kernels is not None:
        return _kernels
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build.BUILD_DIR, "triton"))
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    @triton.jit
    def apply_forces_kernel(pos, quat, linvel, angvel, inv_mass, inv_inertia,
                            gravity_factor, lin_damping, ang_damping, bound_radius,
                            volume, motion, awake, alive, zero_drag, gravity, water_z,
                            o_lin, o_ang, o_water, n, dt, BLOCK: tl.constexpr):
        i = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = i < n
        pz = tl.load(pos + i * 3 + 2, mask=m, other=0.0)
        qx = tl.load(quat + i * 4 + 0, mask=m, other=0.0)
        qy = tl.load(quat + i * 4 + 1, mask=m, other=0.0)
        qz = tl.load(quat + i * 4 + 2, mask=m, other=0.0)
        qw = tl.load(quat + i * 4 + 3, mask=m, other=1.0)
        lx = tl.load(linvel + i * 3 + 0, mask=m, other=0.0)
        ly = tl.load(linvel + i * 3 + 1, mask=m, other=0.0)
        lz = tl.load(linvel + i * 3 + 2, mask=m, other=0.0)
        wx = tl.load(angvel + i * 3 + 0, mask=m, other=0.0)
        wy = tl.load(angvel + i * 3 + 1, mask=m, other=0.0)
        wz = tl.load(angvel + i * 3 + 2, mask=m, other=0.0)
        im = tl.load(inv_mass + i, mask=m, other=0.0)
        d0 = tl.load(inv_inertia + i * 3 + 0, mask=m, other=0.0)
        d1 = tl.load(inv_inertia + i * 3 + 1, mask=m, other=0.0)
        d2 = tl.load(inv_inertia + i * 3 + 2, mask=m, other=0.0)
        gf = tl.load(gravity_factor + i, mask=m, other=0.0)
        ld = tl.load(lin_damping + i, mask=m, other=0.0)
        ad = tl.load(ang_damping + i, mask=m, other=0.0)
        br = tl.load(bound_radius + i, mask=m, other=1.0)
        vol = tl.load(volume + i, mask=m, other=0.0)
        mt = tl.load(motion + i, mask=m, other=0)
        aw = tl.load(awake + i, mask=m, other=0) != 0
        al = tl.load(alive + i, mask=m, other=0) != 0
        zd = tl.load(zero_drag + i, mask=m, other=0) != 0
        gx = tl.load(gravity + 0)
        gy = tl.load(gravity + 1)
        gz = tl.load(gravity + 2)
        wl = tl.load(water_z)

        dyn = (mt == 2) & aw & al
        dynf = dyn.to(tl.float32)
        dtgf = dt * gf
        lx = lx + gx * dtgf * dynf
        ly = ly + gy * dtgf * dynf
        lz = lz + gz * dtgf * dynf

        # Buoyancy (integrate.py:45-65).
        r = tl.maximum(br, 1e-6)
        bottom = pz - r
        in_water = dyn & (bottom < wl)
        f = tl.minimum(tl.maximum(libdevice.div_rn(wl - bottom, 2.0 * r), 0.0), 1.0)
        frac = f * f * (3.0 - 2.0 * f)
        v_sub = vol * frac
        top_sub = tl.minimum(wl, pz + r)
        cz = 0.5 * (top_sub + bottom) - pz
        inwf = in_water.to(tl.float32)
        s = 1020.0 * v_sub * im * dt * inwf
        # The impulse's add contracted, as the jitted reference does.
        lx = tl.fma(-gx, s, lx)
        ly = tl.fma(-gy, s, ly)
        lz = tl.fma(-gz, s, lz)
        fb = 1020.0 * v_sub * inwf
        fx = (-gx) * fb
        fy = (-gy) * fb
        fz = (-gz) * fb
        tx = 0.0 * fz - cz * fy
        ty = cz * fx - 0.0 * fz
        tz = 0.0 * fy - 0.0 * fx
        # World inverse inertia R diag(d) R^T (maths/transform.py).
        xx = qx * qx
        yy = qy * qy
        zz = qz * qz
        xy = qx * qy
        xz = qx * qz
        yz = qy * qz
        qwx = qw * qx
        qwy = qw * qy
        qwz = qw * qz
        r00 = 1.0 - 2.0 * (yy + zz)
        r01 = 2.0 * (xy - qwz)
        r02 = 2.0 * (xz + qwy)
        r10 = 2.0 * (xy + qwz)
        r11 = 1.0 - 2.0 * (xx + zz)
        r12 = 2.0 * (yz - qwx)
        r20 = 2.0 * (xz - qwy)
        r21 = 2.0 * (yz + qwx)
        r22 = 1.0 - 2.0 * (xx + yy)
        i00 = r00 * d0 * r00 + r01 * d1 * r01 + r02 * d2 * r02
        i01 = r00 * d0 * r10 + r01 * d1 * r11 + r02 * d2 * r12
        i02 = r00 * d0 * r20 + r01 * d1 * r21 + r02 * d2 * r22
        i10 = r10 * d0 * r00 + r11 * d1 * r01 + r12 * d2 * r02
        i11 = r10 * d0 * r10 + r11 * d1 * r11 + r12 * d2 * r12
        i12 = r10 * d0 * r20 + r11 * d1 * r21 + r12 * d2 * r22
        i20 = r20 * d0 * r00 + r21 * d1 * r01 + r22 * d2 * r02
        i21 = r20 * d0 * r10 + r21 * d1 * r11 + r22 * d2 * r12
        i22 = r20 * d0 * r20 + r21 * d1 * r21 + r22 * d2 * r22
        wx = wx + (i00 * tx + i01 * ty + i02 * tz) * dt
        wy = wy + (i10 * tx + i11 * ty + i12 * tz) * dt
        wz = wz + (i20 * tx + i21 * ty + i22 * tz) * dt

        # Quadratic linear drag on the centre of buoyancy (:67-75).
        dc = tl.where(zd, 0.0, 0.1)
        vx = lx + (wy * cz - wz * 0.0)
        vy = ly + (wz * 0.0 - wx * cz)
        vz = lz + (wx * 0.0 - wy * 0.0)
        speed = libdevice.sqrt_rn(tl.fma(vz, vz, tl.fma(vy, vy, vx * vx)))
        area = libdevice.pow(tl.maximum(v_sub, 0.0), 2.0 / 3.0)
        ds = dc * area * im * dt * inwf
        dx = -510.0 * speed * vx * ds
        dy = -510.0 * speed * vy * ds
        dz = -510.0 * speed * vz * ds
        dx = tl.where(tl.abs(dx) > tl.abs(vx), -vx, dx)
        dy = tl.where(tl.abs(dy) > tl.abs(vy), -vy, dy)
        dz = tl.where(tl.abs(dz) > tl.abs(vz), -vz, dz)
        lx = lx + dx
        ly = ly + dy
        lz = lz + dz

        # Quadratic angular drag (:77-82).
        wspeed = libdevice.sqrt_rn(tl.fma(wz, wz, tl.fma(wy, wy, wx * wx)))
        base = 3.0 * area * (r * r)
        ax_ = -510.0 * wspeed * wx * (base * d0 * dt * inwf)
        ay_ = -510.0 * wspeed * wy * (base * d1 * dt * inwf)
        az_ = -510.0 * wspeed * wz * (base * d2 * dt * inwf)
        ax_ = tl.where(tl.abs(ax_) > tl.abs(wx), -wx, ax_)
        ay_ = tl.where(tl.abs(ay_) > tl.abs(wy), -wy, ay_)
        az_ = tl.where(tl.abs(az_) > tl.abs(wz), -wz, az_)
        wx = wx + ax_
        wy = wy + ay_
        wz = wz + az_

        # Damping (:84-88).
        # Rounded once from float64, as fp.exp takes it on either device.
        lin_damp = libdevice.exp((-ld * dt).to(tl.float64)).to(tl.float32)
        ang_damp = libdevice.exp((-ad * dt).to(tl.float64)).to(tl.float32)
        lx = tl.where(dyn, lx * lin_damp, lx)
        ly = tl.where(dyn, ly * lin_damp, ly)
        lz = tl.where(dyn, lz * lin_damp, lz)
        wx = tl.where(dyn, wx * ang_damp, wx)
        wy = tl.where(dyn, wy * ang_damp, wy)
        wz = tl.where(dyn, wz * ang_damp, wz)
        tl.store(o_lin + i * 3 + 0, lx, mask=m)
        tl.store(o_lin + i * 3 + 1, ly, mask=m)
        tl.store(o_lin + i * 3 + 2, lz, mask=m)
        tl.store(o_ang + i * 3 + 0, wx, mask=m)
        tl.store(o_ang + i * 3 + 1, wy, mask=m)
        tl.store(o_ang + i * 3 + 2, wz, mask=m)
        tl.store(o_water + i, in_water, mask=m)

    @triton.jit
    def integrate_kernel(pos, quat, linvel, angvel, motion, awake, alive, o_pos, o_quat,
                         n, dt, half_dt, BLOCK: tl.constexpr):
        i = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = i < n
        mt = tl.load(motion + i, mask=m, other=0)
        aw = tl.load(awake + i, mask=m, other=0) != 0
        al = tl.load(alive + i, mask=m, other=0) != 0
        move = al & aw & (mt != 0)
        movef = move.to(tl.float32)
        for c in tl.static_range(3):
            p = tl.load(pos + i * 3 + c, mask=m, other=0.0)
            v = tl.load(linvel + i * 3 + c, mask=m, other=0.0)
            tl.store(o_pos + i * 3 + c, p + v * dt * movef, mask=m)
        qx = tl.load(quat + i * 4 + 0, mask=m, other=0.0)
        qy = tl.load(quat + i * 4 + 1, mask=m, other=0.0)
        qz = tl.load(quat + i * 4 + 2, mask=m, other=0.0)
        qw = tl.load(quat + i * 4 + 3, mask=m, other=1.0)
        ox = tl.load(angvel + i * 3 + 0, mask=m, other=0.0)
        oy = tl.load(angvel + i * 3 + 1, mask=m, other=0.0)
        oz = tl.load(angvel + i * 3 + 2, mask=m, other=0.0)
        # (omega, 0) * q, then normalize(q + 0.5 dt dq) (maths/quat.py).
        mx = 0.0 * qx + ox * qw + oy * qz - oz * qy
        my = 0.0 * qy - ox * qz + oy * qw + oz * qx
        mz = 0.0 * qz + ox * qy - oy * qx + oz * qw
        mw = 0.0 * qw - ox * qx - oy * qy - oz * qz
        nx = qx + half_dt * mx
        ny = qy + half_dt * my
        nz = qz + half_dt * mz
        nw = qw + half_dt * mw
        nrm = libdevice.sqrt_rn(tl.maximum(nx * nx + ny * ny + nz * nz + nw * nw, 1e-12))
        tl.store(o_quat + i * 4 + 0, tl.where(move, libdevice.div_rn(nx, nrm), qx), mask=m)
        tl.store(o_quat + i * 4 + 1, tl.where(move, libdevice.div_rn(ny, nrm), qy), mask=m)
        tl.store(o_quat + i * 4 + 2, tl.where(move, libdevice.div_rn(nz, nrm), qz), mask=m)
        tl.store(o_quat + i * 4 + 3, tl.where(move, libdevice.div_rn(nw, nrm), qw), mask=m)

    _kernels = (apply_forces_kernel, integrate_kernel)
    return _kernels


def _check_body(body: BodyState):
    n = body.capacity
    dev = body.device
    f32, i32, bl = torch.float32, torch.int32, torch.bool
    for name, dt, shp in (
            ("pos", f32, (n, 3)), ("quat", f32, (n, 4)), ("linvel", f32, (n, 3)),
            ("angvel", f32, (n, 3)), ("inv_mass", f32, (n,)),
            ("inv_inertia", f32, (n, 3)), ("gravity_factor", f32, (n,)),
            ("linear_damping", f32, (n,)), ("angular_damping", f32, (n,)),
            ("bound_radius", f32, (n,)), ("volume", f32, (n,)),
            ("motion_type", i32, (n,)), ("awake", bl, (n,)), ("alive", bl, (n,)),
            ("use_zero_linear_drag", bl, (n,))):
        build.check(getattr(body, name), name, dt, shp, dev)


def apply_forces(body: BodyState, dt: float, params: SimParams):
    """KD: ``apply_forces_plain`` for CPU tensors, the Triton kernel for
    CUDA tensors."""
    if body.device.type == "cpu":
        return apply_forces_plain(body, dt, params)
    _check_body(body)
    build.check(params.gravity, "gravity", torch.float32, (3,), body.device)
    build.check(params.water_z, "water_z", torch.float32, (), body.device)
    kernel, _ = _triton_kernels()
    n = body.capacity
    lin = torch.empty_like(body.linvel)
    ang = torch.empty_like(body.angvel)
    water = torch.empty_like(body.awake)
    kernel[(triton_cdiv(n, BLOCK),)](
        body.pos, body.quat, body.linvel, body.angvel, body.inv_mass,
        body.inv_inertia, body.gravity_factor, body.linear_damping,
        body.angular_damping, body.bound_radius, body.volume,
        body.motion_type, body.awake, body.alive, body.use_zero_linear_drag,
        params.gravity, params.water_z, lin, ang, water, n, float(dt),
        BLOCK=BLOCK, enable_fp_fusion=False)
    launches["apply_forces"] += 1
    return lin, ang, water


def integrate_positions(body: BodyState, linvel, angvel, dt: float):
    """KD: ``integrate_positions_plain`` for CPU tensors, the Triton kernel
    for CUDA tensors."""
    if body.device.type == "cpu":
        return integrate_positions_plain(body, linvel, angvel, dt)
    _check_body(body)
    n = body.capacity
    build.check(linvel, "linvel", torch.float32, (n, 3), body.device)
    build.check(angvel, "angvel", torch.float32, (n, 3), body.device)
    _, kernel = _triton_kernels()
    pos = torch.empty_like(body.pos)
    quat = torch.empty_like(body.quat)
    kernel[(triton_cdiv(n, BLOCK),)](
        body.pos, body.quat, linvel, angvel, body.motion_type, body.awake,
        body.alive, pos, quat, n, float(dt), 0.5 * float(dt),
        BLOCK=BLOCK, enable_fp_fusion=False)
    launches["integrate_positions"] += 1
    return pos, quat


def triton_cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b
