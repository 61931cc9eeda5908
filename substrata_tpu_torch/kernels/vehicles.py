"""Vehicle force models: car, bike, boat, hovercar (kernel KJ).

Replaces ``substrata_tpu/physics/vehicles/manager.py:_vehicle_update_one``
(:298-594), the body of the ``vmap`` at :637-649: steering smoothing,
suspension springs from the wheel-ray hits, the drivetrain (engine curve,
automatic gearbox with clutch time, open differential), brakes and engine
braking, friction-curve-clamped tyre forces, the bike's lean controller,
the boat's thrust, rudder and water drag, the hovercar's hover, control
torques, keep-upright controller, unflip window and air drag, the
righting controller, and the wheel spin state.

``vehicle_forces`` launches ``csrc/vehicles.cu`` (a block of four warps
per vehicle: the wheels on four lanes, the controllers on warps of their
own) for CUDA tensors and runs ``vehicle_forces_plain`` (the same model batched
over vehicles) for CPU tensors.  The drivetrain tables are the module
constants below; the kernel holds the same numbers.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.maths import fp
from substrata_tpu_torch.maths import quat as quatm
from substrata_tpu_torch.maths import transform as tmath

VEHICLE_CAR = 0
VEHICLE_BIKE = 1
VEHICLE_BOAT = 2
VEHICLE_HOVER = 3

MAX_WHEELS = 4

# Drivetrain (Jolt 5.3 defaults: the reference overrides only MaxTorque
# and MaxRPM, CarPhysics.cpp:188-216).
GEAR_RATIOS = np.array([2.66, 1.78, 1.30, 1.0, 0.74], np.float32)
REVERSE_GEAR_RATIO = -2.90
DIFF_RATIO = 3.42
LEFT_RIGHT_SPLIT = 0.5
SHIFT_UP_RPM = 4000.0
SHIFT_DOWN_RPM = 2000.0
SHIFT_SWITCH_TIME = 0.5
ENGINE_MIN_RPM = 1000.0
# The bike's drivetrain is fixed in the reference (BikePhysics.cpp:211-222).
BIKE_ENGINE_TORQUE = 390.0
BIKE_ENGINE_MAX_RPM = 10000.0
BIKE_GEAR_RATIOS = np.array([2.27, 1.63, 1.30, 1.09, 0.96, 0.88], np.float32)
BIKE_SHIFT_UP_RPM = 9000.0
BIKE_SHIFT_DOWN_RPM = 5000.0
BIKE_SHIFT_SWITCH_TIME = 0.2
_CAR_GEARS_PAD = np.array([2.66, 1.78, 1.30, 1.0, 0.74, 0.74], np.float32)
# Normalised engine torque curve (fraction of max RPM -> torque fraction).
ENGINE_CURVE_X = np.array([0.0, 0.66, 1.0], np.float32)
ENGINE_CURVE_Y = np.array([0.8, 1.0, 0.8], np.float32)
LONG_MU_PEAK = 1.2
LONG_MU_SLIDE = 1.0
BIKE_LONG_MU_PEAK = 8.0
BIKE_LONG_MU_SLIDE = 3.0
# Lateral slip-angle curve (degrees -> mu).
LAT_CURVE_DEG = np.array([0.0, 3.0, 20.0], np.float32)
LAT_CURVE_MU = np.array([0.0, 1.2, 1.0], np.float32)
BIKE_LAT_CURVE_MU = np.array([0.0, 3.6, 2.0], np.float32)
WHEEL_INERTIA = 0.9
RPM_PER_RAD_S = 60.0 / (2.0 * np.pi)

_F32 = np.float32
_DEG = float(_F32(180.0 / np.pi))         # jnp.degrees' float32 factor
_RPM = float(_F32(RPM_PER_RAD_S))

launches = 0


def _interp3(x, xp, f0, f1, f2):
    """``jnp.interp(x, xp, (f0, f1, f2))`` for three ascending float32
    points: the bracket of searchsorted(side='right') clipped to [1, 2],
    then fp[i-1] + (x - xp[i-1]) / dx * df, held at the ends."""
    xp = np.asarray(xp, _F32)
    upper = x >= float(xp[1])
    x_lo = torch.where(upper, float(xp[1]), float(xp[0]))
    dx = torch.where(upper, float(xp[2] - xp[1]), float(xp[1] - xp[0]))
    f_lo = torch.where(upper, f1, f0)
    f_hi = torch.where(upper, f2, f1)
    f = f_lo + (x - x_lo) / dx * (f_hi - f_lo)
    f = torch.where(x < float(xp[0]), f0, f)
    return torch.where(x > float(xp[2]), f2, f)


def _norm(v):
    """``jnp.linalg.norm`` as the jitted reference rounds it."""
    return fp.sqrt(quatm.dot3_fma(v, v))


def righting_torque_dv(quat, angvel, mass, iw, y_fwd_quat, dt, gain_vel=3.0,
                       gain_torque=1.5):
    """Keep-upright controller (manager.py:_righting_torque_dv): desired
    angular velocity = axis * angle * gain toward upright with the current
    yaw; torque = (desired - angvel) * mass * gain."""
    lead, dev = quat.shape[:-1], quat.device
    right_ws = quatm.rotate_vec(quat, quatm.rotate_vec(quatm.conjugate(y_fwd_quat),
                                                       quatm.basis(lead, 0, dev)))
    yaw = torch.atan2(right_ws[..., 1], right_ws[..., 0])
    desired = quatm.mul(quatm.from_axis_angle(quatm.basis(lead, 2, dev), yaw), y_fwd_quat)
    axis, angle = quatm.to_axis_angle(quatm.mul(desired, quatm.conjugate(quat)))
    torque = (axis * angle[..., None] * gain_vel - angvel) * mass[..., None] * gain_torque
    return tmath.mat_vec_fma(iw, torque) * dt


def vehicle_forces_plain(veh, inp, body_pos, body_quat, body_lin, body_ang, mass, iw,
                         hit_t, hit_n, hit_ok, water_z, dt):
    """Every vehicle's chassis velocity deltas and new controller state.

    Chassis state [V, ...] gathered from the bodies, wheel hits [V, 4].
    Returns (dv, dw, steering, sus_len, omega, rot, unflip, contact, gear,
    shift_timer, rpm)."""
    dt = torch.tensor(_F32(dt))
    vt = veh.vtype
    active = veh.active
    dev = body_pos.device
    col = (lambda x: x[:, None])

    inv_yq = quatm.conjugate(veh.y_fwd_quat)
    rows = body_pos.shape[:1]
    fwd_os = quatm.rotate_vec(inv_yq, quatm.basis(rows, 1, dev))
    right_os = quatm.rotate_vec(inv_yq, quatm.basis(rows, 0, dev))
    up_os = quatm.cross_fma(right_os, fwd_os)
    fwd_w = quatm.rotate_vec(body_quat, fwd_os)
    right_w = quatm.rotate_vec(body_quat, right_os)
    up_w = quatm.rotate_vec(body_quat, up_os)
    dt_m = dt / mass

    def force_at(force, point):
        """(dv, dw) of one force at a world point."""
        tau = quatm.cross_fma(point - body_pos, force)
        return force * col(dt_m), tmath.mat_vec_fma(iw, tau) * dt

    is_wheeled = (vt == VEHICLE_CAR) | (vt == VEHICLE_BIKE)
    is_bike = vt == VEHICLE_BIKE

    # Steering smoothing.
    target = -inp.right * veh.max_steer
    step = torch.clamp(target - veh.steering, min=-veh.steer_relax * dt,
                       max=veh.steer_relax * dt)
    new_steering = torch.where(is_wheeled & active, veh.steering + step, 0.0)

    # Suspension.
    widx = torch.arange(MAX_WHEELS, device=dev)[None, :]
    wheel_on = widx < col(veh.n_wheels)
    attach_w = body_pos[:, None, :] + quatm.rotate_vec(body_quat[:, None, :], veh.wheel_attach)
    sus_dir = -up_w
    rad = col(veh.wheel_radius)
    ray_len = veh.sus_max + veh.wheel_radius
    hit = hit_ok & wheel_on & (hit_t <= col(ray_len))
    sus_len = torch.minimum(torch.maximum(hit_t - rad, col(veh.sus_min)), col(veh.sus_max))
    compression = col(veh.sus_max) - sus_len
    comp_rate = (veh.prev_sus_len - sus_len) / dt
    m_quarter = mass / torch.clamp(veh.n_wheels.to(torch.float32), min=1.0)
    k = m_quarter * (2 * np.pi * veh.spring_freq) ** 2
    c = veh.spring_damping * 2.0 * torch.sqrt(k * m_quarter)
    f_spring = torch.clamp(col(k) * compression + col(c) * comp_rate, min=0.0)
    load = torch.where(hit, f_spring, 0.0)
    contact_pt = attach_w + sus_dir[:, None, :] * hit_t[..., None]

    # Tyre frames.
    is_front = torch.where(col(is_bike), widx == 0, widx < 2)
    ca, sa = torch.cos(new_steering), torch.sin(new_steering)
    steered = fwd_w * col(ca) - right_w * col(sa)
    wheel_fwd = torch.where(is_front[..., None], steered[:, None, :], fwd_w[:, None, :])
    wfl = wheel_fwd - hit_n * quatm.dot3_fma(wheel_fwd, hit_n)[..., None]
    wfl = wfl / torch.clamp(_norm(wfl), min=1e-6)[..., None]
    wlat = quatm.cross_fma(hit_n, wfl)
    v_cp = body_lin[:, None, :] + quatm.cross_fma(body_ang[:, None, :].expand(-1, MAX_WHEELS, 3),
                                              contact_pt - body_pos[:, None, :])
    v_long = quatm.dot3_fma(v_cp, wfl)
    v_lat = quatm.dot3_fma(v_cp, wlat)

    # Drivetrain.
    driven = torch.where(col(is_bike), widx == 1, widx < 2)
    speed_fwd = quatm.dot3_fma(body_lin, fwd_w)
    omega_avg = torch.abs(speed_fwd) / veh.wheel_radius
    in_reverse = (inp.forward < -0.01) & (speed_fwd < 0.5)
    brake_from_input = (inp.forward < -0.01) & (speed_fwd >= 0.5)
    max_gear = torch.where(is_bike, BIKE_GEAR_RATIOS.shape[0] - 1, GEAR_RATIOS.shape[0] - 1)
    shift_up_rpm = torch.where(is_bike, BIKE_SHIFT_UP_RPM, SHIFT_UP_RPM)
    shift_down_rpm = torch.where(is_bike, BIKE_SHIFT_DOWN_RPM, SHIFT_DOWN_RPM)
    switch_time = torch.where(is_bike, BIKE_SHIFT_SWITCH_TIME, SHIFT_SWITCH_TIME)
    ratio_fwd = torch.zeros_like(speed_fwd)
    for g in range(BIKE_GEAR_RATIOS.shape[0]):
        ratio_fwd = torch.where(veh.gear == g, torch.where(
            is_bike, float(BIKE_GEAR_RATIOS[g]), float(_CAR_GEARS_PAD[g])), ratio_fwd)
    ratio = torch.where(in_reverse, REVERSE_GEAR_RATIO, ratio_fwd) * DIFF_RATIO
    rpm_raw = torch.abs(omega_avg) * torch.abs(ratio) * _RPM
    new_rpm = torch.minimum(torch.maximum(rpm_raw, torch.full_like(rpm_raw, ENGINE_MIN_RPM)),
                            veh.engine_max_rpm)
    can_shift = veh.shift_timer <= 0.0
    shift_up = can_shift & ~in_reverse & (rpm_raw > shift_up_rpm) & (veh.gear < max_gear)
    shift_down = can_shift & ~in_reverse & (rpm_raw < shift_down_rpm) & (veh.gear > 0)
    new_gear = veh.gear + shift_up.to(torch.int32) - shift_down.to(torch.int32)
    new_shift_timer = torch.where(shift_up | shift_down, switch_time,
                                  torch.clamp(veh.shift_timer - dt, min=0.0))
    clutch = veh.shift_timer <= 0.0
    throttle = torch.abs(inp.forward)
    t_norm = _interp3(new_rpm / torch.clamp(veh.engine_max_rpm, min=1.0), ENGINE_CURVE_X,
                      *(float(y) for y in ENGINE_CURVE_Y))
    t_norm = torch.where(rpm_raw >= veh.engine_max_rpm, 0.0, t_norm)
    t_engine = veh.engine_torque * t_norm * throttle
    t_wheel = t_engine * ratio * torch.where(is_bike, 1.0, LEFT_RIGHT_SPLIT)
    driving = clutch & ~brake_from_input & (throttle > 0.01)
    f_drive = torch.where(driven & hit & col(driving), col(t_wheel) / rad, 0.0)

    # Brakes and engine braking.
    braking = inp.brake | brake_from_input
    coasting = (torch.abs(inp.forward) < 0.01) & clutch
    engine_omega = new_rpm / _RPM
    f_eng_brake = torch.where(driven & col(coasting),
                              col(0.2 * 0.5 * engine_omega * torch.abs(ratio)) / rad, 0.0)
    f_brake_cap = torch.where(col(inp.handbrake) & (widx >= 2), col(veh.handbrake_torque),
                              torch.where(col(braking), col(veh.brake_torque), 0.0)) / rad
    f_brake_cap = f_brake_cap + f_eng_brake
    f_brake = -torch.sign(v_long) * torch.minimum(f_brake_cap,
                                                  torch.abs(v_long) * col(m_quarter) / dt)
    f_long_want = f_drive + torch.where(hit, f_brake, 0.0)
    f_lat_want = -v_lat * col(m_quarter) / dt

    # Tyre friction curves.
    mu_pk = torch.where(is_bike, BIKE_LONG_MU_PEAK, LONG_MU_PEAK * veh.mu_long)
    mu_sl = torch.where(is_bike, BIKE_LONG_MU_SLIDE, LONG_MU_SLIDE * veh.mu_long)
    f_peak = col(mu_pk) * load
    f_slide = col(mu_sl) * load
    spinning = torch.abs(f_long_want) > f_peak
    f_long_max = torch.where(spinning, f_slide, f_peak)
    f_long = torch.minimum(torch.maximum(f_long_want, -f_long_max), f_long_max)
    slip_deg = torch.atan2(torch.abs(v_lat), torch.clamp(torch.abs(v_long), min=0.3)) * _DEG
    mu0 = torch.where(is_bike, float(BIKE_LAT_CURVE_MU[0]), float(LAT_CURVE_MU[0]) * veh.mu_lat)
    mu1 = torch.where(is_bike, float(BIKE_LAT_CURVE_MU[1]), float(LAT_CURVE_MU[1]) * veh.mu_lat)
    mu2 = torch.where(is_bike, float(BIKE_LAT_CURVE_MU[2]), float(LAT_CURVE_MU[2]) * veh.mu_lat)
    mu_lat = _interp3(slip_deg, LAT_CURVE_DEG, col(mu0), col(mu1), col(mu2))
    f_lat = torch.minimum(torch.maximum(f_lat_want, -mu_lat * load), mu_lat * load)

    dv = torch.zeros_like(body_pos)
    dw = torch.zeros_like(body_pos)
    dv_wh = torch.zeros_like(body_pos)
    dw_wh = torch.zeros_like(body_pos)
    for wi in range(MAX_WHEELS):
        force = (sus_dir * -f_spring[:, wi:wi + 1] + wfl[:, wi] * f_long[:, wi:wi + 1]
                 + wlat[:, wi] * f_lat[:, wi:wi + 1])
        force = torch.where(hit[:, wi:wi + 1], force, 0.0)
        a, b = force_at(force, contact_pt[:, wi])
        dv_wh, dw_wh = dv_wh + a, dw_wh + b
    dv = dv + torch.where(col(is_wheeled), dv_wh, 0.0)
    dw = dw + torch.where(col(is_wheeled), dw_wh, 0.0)

    # Bike lean controller.
    wheelbase = torch.clamp(torch.abs(veh.wheel_attach[:, 0, 1] - veh.wheel_attach[:, 1, 1]),
                            min=0.5)
    yaw_rate = speed_fwd * torch.tan(new_steering) / wheelbase
    lean_target = torch.clamp(torch.atan2(speed_fwd * yaw_rate, torch.full_like(yaw_rate, 9.81)),
                              -0.9, 0.9)
    z_up = quatm.cross_fma(quatm.basis(rows, 2, dev), up_w)
    lean_cur = torch.atan2(quatm.dot3_fma(z_up, fwd_w), up_w[:, 2])
    lean_rate = quatm.dot3_fma(body_ang, fwd_w)
    lean_tau = (fwd_w * col((lean_target - lean_cur) * veh.lean_spring
                            - lean_rate * veh.lean_damping) * col(mass) * 0.1)
    dw = dw + torch.where(col(is_bike & active), tmath.mat_vec_fma(iw, lean_tau) * dt, 0.0)

    # Boat: thrust and rudder at the propeller while it is under water.
    prop_w = body_pos + quatm.rotate_vec(body_quat, veh.propellor_os)
    prop_submerged = prop_w[:, 2] <= water_z
    thrust_dir = fwd_w - up_w * 0.2 - right_w * col(inp.right * veh.thrust_lateral)
    thrust_dir = thrust_dir / torch.clamp(_norm(thrust_dir), min=1e-6)[:, None]
    dv_b, dw_b = force_at(thrust_dir * col(veh.thrust_force * inp.forward), prop_w)
    fwd_vel = quatm.dot3_fma(body_lin, fwd_w)
    a, b = force_at(right_w * col(-inp.right * fwd_vel * veh.rudder_factor), prop_w)
    dv_b2, dw_b2 = dv_b + a, dw_b + b
    boat_on = (vt == VEHICLE_BOAT) & active & prop_submerged
    dv = dv + torch.where(col(boat_on & (torch.abs(inp.forward) > 0)), dv_b - 0 * dv_b, 0.0) * 0
    dv = dv + torch.where(col(boat_on), dv_b2, 0.0)
    dw = dw + torch.where(col(boat_on), dw_b2, 0.0)

    # Boat water drag.
    v_mag = _norm(body_lin)
    nv = body_lin / torch.clamp(v_mag, min=1e-6)[:, None]
    submerged = body_pos[:, 2] < water_z + 1.0
    proj = (torch.abs(quatm.dot3_fma(nv, fwd_w)) * veh.areas[:, 0] * 0.1
            + torch.abs(quatm.dot3_fma(nv, right_w)) * veh.areas[:, 1] * 0.5
            + torch.abs(quatm.dot3_fma(nv, up_w)) * veh.areas[:, 2] * 0.75)
    f_d_mag = 0.5 * 1020.0 * v_mag * v_mag * proj
    drag_dv = -nv * col(f_d_mag) * col(dt_m)
    drag_dv = torch.where(col(_norm(drag_dv) > v_mag), -body_lin, drag_dv)
    dv = dv + torch.where(col((vt == VEHICLE_BOAT) & submerged & (v_mag > 1e-3)), drag_dv, 0.0)

    # Hovercar.
    cos_theta = up_w[:, 2]
    up_factor = 1.0 / torch.clamp(cos_theta, min=0.7)
    hover_f = up_w * col((1.0 + inp.up * 0.6) * up_factor * mass * 9.81)
    hover_f = torch.where(col(cos_theta > 0), hover_f, 0.0)
    fwd_f = fwd_w * col(mass * 10.0 * inp.forward)
    extra_up = up_w * col(-fwd_f[:, 2])
    pitch_tau = right_w * col(mass * -0.5 * inp.forward)
    yaw_tau = up_w * col(mass * -3.0 * inp.right)
    roll_tau = fwd_w * col(mass * 2.0 * inp.right)
    dv_h = (hover_f + fwd_f + extra_up) * col(dt_m)
    dw_h = tmath.mat_vec_fma(iw, pitch_tau + yaw_tau + roll_tau) * dt
    dw_h = dw_h + righting_torque_dv(body_quat, body_ang, mass, iw, veh.y_fwd_quat, dt)
    unflip = veh.unflip_time
    new_unflip = torch.where(unflip > 0, torch.where(cos_theta > 0.2, -1.0, unflip - dt),
                             torch.where(cos_theta < -0.9, 1.0, unflip))
    lift = torch.zeros_like(dv_h)
    lift[:, 2] = 9.81 * dt
    dv_h = dv_h + torch.where(col((unflip > 0) & (cos_theta <= 0.2)), lift, 0.0)
    proj_a = (torch.abs(quatm.dot3_fma(nv, fwd_w)) * 2.0 * 0.2
              + torch.abs(quatm.dot3_fma(nv, right_w)) * 4.0 * 0.5
              + torch.abs(quatm.dot3_fma(nv, up_w)) * 8.0 * 0.75)
    f_ad = -nv * col(0.5 * 1.293 * v_mag * v_mag * proj_a)
    dv_h = dv_h + torch.where(col(v_mag > 1e-3), f_ad * col(dt_m), 0.0)
    hover_on = (vt == VEHICLE_HOVER) & active
    dv = dv + torch.where(col(hover_on), dv_h, 0.0)
    dw = dw + torch.where(col(hover_on), dw_h, 0.0)
    new_unflip = torch.where(hover_on, new_unflip, unflip)

    # Righting (car, bike).
    dw_right = righting_torque_dv(body_quat, body_ang, mass, iw, veh.y_fwd_quat, dt)
    dw = dw + torch.where(col(veh.righting_active & is_wheeled), dw_right, 0.0)

    # Wheel spin.
    excess = torch.clamp(torch.abs(f_long_want) - f_slide, min=0.0) * rad
    omega_spin = veh.wheel_omega + torch.sign(f_long_want) * excess / WHEEL_INERTIA * dt
    omega_cap = col((veh.engine_max_rpm / _RPM) / torch.clamp(torch.abs(ratio), min=0.1))
    omega_spin = torch.minimum(torch.maximum(omega_spin, -omega_cap), omega_cap)
    new_omega = torch.where(hit & spinning & driven, omega_spin,
                            torch.where(hit, v_long / rad, veh.wheel_omega * 0.95))
    new_rot = veh.wheel_rot + new_omega * dt
    new_gear = torch.where(is_wheeled & active, new_gear, veh.gear)
    new_shift_timer = torch.where(is_wheeled, new_shift_timer, veh.shift_timer)
    new_rpm = torch.where(is_wheeled, new_rpm, 0.0)
    gate = col(active | (vt == VEHICLE_HOVER) | is_wheeled)
    return (torch.where(gate, dv, 0.0), torch.where(gate, dw, 0.0), new_steering, sus_len,
            new_omega, new_rot, new_unflip, hit, new_gear, new_shift_timer, new_rpm)


# Argument order of the kernel's vehicle fields (all [V, ...] rows).
KERNEL_FIELDS = (
    "vtype", "active", "y_fwd_quat", "wheel_attach", "wheel_radius", "n_wheels", "sus_min",
    "sus_max", "spring_freq", "spring_damping", "max_steer", "engine_torque",
    "engine_max_rpm", "brake_torque", "handbrake_torque", "mu_long", "mu_lat", "steer_relax",
    "lean_spring", "lean_damping", "thrust_force", "propellor_os", "rudder_factor",
    "thrust_lateral", "areas", "steering", "prev_sus_len", "wheel_omega", "wheel_rot",
    "unflip_time", "righting_active", "gear", "shift_timer")
_INT_FIELDS = ("vtype", "n_wheels", "gear")
_BOOL_FIELDS = ("active", "righting_active")
_ROW_SHAPES = {"y_fwd_quat": (4,), "wheel_attach": (MAX_WHEELS, 3), "propellor_os": (3,),
               "areas": (3,), "prev_sus_len": (MAX_WHEELS,), "wheel_omega": (MAX_WHEELS,),
               "wheel_rot": (MAX_WHEELS,)}
_INPUTS = ("forward", "right", "up", "brake", "handbrake")
# csrc/vehicles.cu:vehicle_forces: 48 input pointers, the output buffer, V, dt.
_PACK = struct.Struct("=50qd")
# The output buffer, in units of V floats (csrc/vehicles.cu:Out): dv, dw,
# steering, sus_len, omega, rot, unflip, shift_timer, rpm; gear (int32) and
# contact (bool [V, 4]) in the last two.
_OUT_SPLIT = (3, 3, 1, 4, 4, 4, 1, 1, 1, 1, 1)
_OUT_FLOATS = sum(_OUT_SPLIT)
_plans = {}


class _Plan:
    """KJ's checks for one (V, device): the 48 inputs' names, dtypes and
    shapes in the kernel's order (csrc/vehicles.cu:In)."""

    NAMES = KERNEL_FIELDS + _INPUTS + ("body_pos", "body_quat", "body_lin", "body_ang", "mass",
                                       "iw", "hit_t", "hit_n", "hit_ok", "water_z")

    def __init__(self, nv, device):
        f32, i32, bl = torch.float32, torch.int32, torch.bool
        self.device = device
        self.dtypes = tuple(i32 if f in _INT_FIELDS else bl if f in _BOOL_FIELDS else f32
                            for f in KERNEL_FIELDS) + (f32,) * 3 + (bl,) * 2 \
            + (f32,) * 8 + (bl, f32)
        self.shapes = tuple((nv,) + _ROW_SHAPES.get(f, ()) for f in KERNEL_FIELDS) \
            + ((nv,),) * 5 + ((nv, 3), (nv, 4), (nv, 3), (nv, 3), (nv,), (nv, 3, 3),
                              (nv, MAX_WHEELS), (nv, MAX_WHEELS, 3), (nv, MAX_WHEELS), ())


def _views(out, nv):
    """The 11 outputs as views of the kernel's one buffer."""
    v, w = nv, MAX_WHEELS
    dv, dw, steering, sus_len, omega, rot, unflip, shift_timer, rpm, gear, contact = out.split(
        [k * v for k in _OUT_SPLIT])
    return (dv.view(v, 3), dw.view(v, 3), steering, sus_len.view(v, w), omega.view(v, w),
            rot.view(v, w), unflip, contact.view(torch.bool).view(v, w),
            gear.view(torch.int32), shift_timer, rpm)


def vehicle_forces(veh, inp, body_pos, body_quat, body_lin, body_ang, mass, iw,
                   hit_t, hit_n, hit_ok, water_z, dt):
    """KJ: ``vehicle_forces_plain`` for CPU tensors, ``csrc/vehicles.cu``
    for CUDA tensors (checked against the plan of its (V, device), launched
    from one packed argument, its outputs views of one buffer)."""
    global launches
    if body_pos.device.type == "cpu":
        return vehicle_forces_plain(veh, inp, body_pos, body_quat, body_lin, body_ang, mass,
                                    iw, hit_t, hit_n, hit_ok, water_z, dt)
    dev = body_pos.device
    nv = veh.vtype.shape[0]
    plan = build.plan(_plans, (nv, dev), lambda: _Plan(nv, dev))
    ins = ([getattr(veh, f) for f in KERNEL_FIELDS] + [getattr(inp, f) for f in _INPUTS]
           + [body_pos, body_quat, body_lin, body_ang, mass, iw, hit_t, hit_n, hit_ok, water_z])
    build.check_all(plan.device, ins, plan.NAMES, plan.dtypes, plan.shapes)
    out = torch.empty(_OUT_FLOATS * nv, dtype=torch.float32, device=dev)
    build.launch_packed("vehicle_forces", _PACK.pack(*(t.data_ptr() for t in ins),
                                                     out.data_ptr(), nv, float(_F32(dt))))
    launches += 1
    return _views(out, nv)
