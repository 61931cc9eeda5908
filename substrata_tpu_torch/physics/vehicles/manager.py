"""Batched vehicle controllers: car, bike, boat, hovercar.

Counterpart of ``substrata_tpu/physics/vehicles/manager.py``.  Every
vehicle updates in one pass over SoA vehicle arrays: the wheels'
suspension rays go out in one ``trace_rays`` batch (kernel KH), the force
models run in kernel KJ (``kernels/vehicles.py``, where the drivetrain
constants live), and the chassis velocity deltas land in one scatter
before the world step (the reference client ticks its vehicle controllers
before physics, GUIClient.cpp:6418-6430).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from substrata_tpu_torch.kernels import vehicles as kveh
from substrata_tpu_torch.kernels.vehicles import (  # noqa: F401
    BIKE_ENGINE_MAX_RPM, BIKE_ENGINE_TORQUE, BIKE_GEAR_RATIOS, BIKE_LAT_CURVE_MU,
    BIKE_LONG_MU_PEAK, BIKE_LONG_MU_SLIDE, BIKE_SHIFT_DOWN_RPM, BIKE_SHIFT_SWITCH_TIME,
    BIKE_SHIFT_UP_RPM, DIFF_RATIO, ENGINE_CURVE_X, ENGINE_CURVE_Y, ENGINE_MIN_RPM,
    GEAR_RATIOS, LAT_CURVE_DEG, LAT_CURVE_MU, LEFT_RIGHT_SPLIT, LONG_MU_PEAK, LONG_MU_SLIDE,
    MAX_WHEELS, REVERSE_GEAR_RATIO, RPM_PER_RAD_S, SHIFT_DOWN_RPM, SHIFT_SWITCH_TIME,
    SHIFT_UP_RPM, VEHICLE_BIKE, VEHICLE_BOAT, VEHICLE_CAR, VEHICLE_HOVER, WHEEL_INERTIA)
from substrata_tpu_torch.maths import quat as quatm
from substrata_tpu_torch.maths import transform as tmath
from substrata_tpu_torch.physics import queries
from substrata_tpu_torch.physics.state import (BodyState, SimConfig, SimParams, StaticWorld,
                                               _Replace)


@dataclass
class VehicleSettings:
    """Host-side settings (the reference's VehicleScriptedSettings
    subclasses: CarScriptSettings, BikeScriptSettings, BoatScriptSettings,
    HoverCarScriptSettings)."""

    vehicle_type: int = VEHICLE_CAR
    model_to_y_forwards_rot: np.ndarray = field(
        default_factory=lambda: np.array([0, 0, 0, 1], np.float32))
    # Wheels (car: FL, FR, RL, RR; bike: front, rear) in object space.
    wheel_attach_os: np.ndarray = field(
        default_factory=lambda: np.array(
            [[-0.8, 1.2, -0.2], [0.8, 1.2, -0.2],
             [-0.8, -1.2, -0.2], [0.8, -1.2, -0.2]], np.float32))
    wheel_radius: float = 0.35
    suspension_min_length: float = 0.1
    suspension_max_length: float = 0.5
    suspension_spring_freq: float = 2.0     # Hz
    suspension_spring_damping: float = 0.5  # damping ratio
    max_steering_angle: float = 0.6         # rad
    engine_max_torque: float = 500.0        # Nm at the crank
    engine_max_rpm: float = 6000.0          # rev limit
    max_brake_torque: float = 1500.0
    max_handbrake_torque: float = 4000.0
    # Scale factors of the friction curves' Y values (1.0 = stock tyres).
    longitudinal_friction_factor: float = 1.0
    lateral_friction_factor: float = 1.0
    steering_relax_rate: float = 3.0        # rad/s
    # Bike
    lean_spring: float = 30.0
    lean_damping: float = 8.0
    # Boat
    thrust_force: float = 20000.0
    propellor_point_os: np.ndarray = field(
        default_factory=lambda: np.array([0, -2.0, -0.3], np.float32))
    rudder_deflection_force_factor: float = 500.0
    thrust_vector_lateral_amount: float = 0.3
    front_cross_sectional_area: float = 1.5
    side_cross_sectional_area: float = 4.0
    top_cross_sectional_area: float = 8.0


@dataclasses.dataclass
class VehicleArrays(_Replace):
    """Device SoA for all registered vehicles (capacity V)."""

    vtype: torch.Tensor            # [V] i32
    body_slot: torch.Tensor        # [V] i32 chassis body
    y_fwd_quat: torch.Tensor       # [V, 4] model -> y-forward rotation
    wheel_attach: torch.Tensor     # [V, 4, 3]
    wheel_radius: torch.Tensor     # [V]
    n_wheels: torch.Tensor         # [V] i32
    sus_min: torch.Tensor          # [V]
    sus_max: torch.Tensor          # [V]
    spring_freq: torch.Tensor      # [V]
    spring_damping: torch.Tensor   # [V]
    max_steer: torch.Tensor        # [V]
    engine_torque: torch.Tensor    # [V]
    engine_max_rpm: torch.Tensor   # [V]
    brake_torque: torch.Tensor     # [V]
    handbrake_torque: torch.Tensor  # [V]
    mu_long: torch.Tensor          # [V]
    mu_lat: torch.Tensor           # [V]
    steer_relax: torch.Tensor      # [V]
    lean_spring: torch.Tensor      # [V]
    lean_damping: torch.Tensor     # [V]
    thrust_force: torch.Tensor     # [V]
    propellor_os: torch.Tensor     # [V, 3]
    rudder_factor: torch.Tensor    # [V]
    thrust_lateral: torch.Tensor   # [V]
    areas: torch.Tensor            # [V, 3] front/side/top
    active: torch.Tensor           # [V] bool (user in driver seat)
    # Mutable controller state
    steering: torch.Tensor         # [V] current smoothed steering angle
    prev_sus_len: torch.Tensor     # [V, 4]
    wheel_omega: torch.Tensor      # [V, 4] wheel spin (graphics, audio)
    wheel_rot: torch.Tensor        # [V, 4]
    unflip_time: torch.Tensor      # [V] unflip window remaining
    righting_active: torch.Tensor  # [V] bool
    wheel_contact: torch.Tensor    # [V, 4] bool
    gear: torch.Tensor             # [V] i32 current forward gear (0-based)
    shift_timer: torch.Tensor      # [V] clutch-disengaged time left
    engine_rpm: torch.Tensor       # [V]


VEHICLE_FIELDS = tuple(f.name for f in dataclasses.fields(VehicleArrays))


def zero_vehicles(capacity: int = 32, *, device) -> VehicleArrays:
    v = capacity
    f = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)
    return VehicleArrays(
        vtype=torch.zeros((v,), **i32), body_slot=torch.full((v,), -1, **i32),
        y_fwd_quat=quatm.identity((v,), device=device),
        wheel_attach=torch.zeros((v, 4, 3), **f), wheel_radius=torch.full((v,), 0.35, **f),
        n_wheels=torch.zeros((v,), **i32), sus_min=torch.full((v,), 0.1, **f),
        sus_max=torch.full((v,), 0.5, **f), spring_freq=torch.full((v,), 2.0, **f),
        spring_damping=torch.full((v,), 0.5, **f), max_steer=torch.full((v,), 0.6, **f),
        engine_torque=torch.full((v,), 500.0, **f),
        engine_max_rpm=torch.full((v,), 6000.0, **f),
        brake_torque=torch.full((v,), 1500.0, **f),
        handbrake_torque=torch.full((v,), 4000.0, **f), mu_long=torch.ones((v,), **f),
        mu_lat=torch.ones((v,), **f), steer_relax=torch.full((v,), 3.0, **f),
        lean_spring=torch.full((v,), 30.0, **f), lean_damping=torch.full((v,), 8.0, **f),
        thrust_force=torch.full((v,), 20000.0, **f), propellor_os=torch.zeros((v, 3), **f),
        rudder_factor=torch.full((v,), 500.0, **f), thrust_lateral=torch.full((v,), 0.3, **f),
        areas=torch.ones((v, 3), **f), active=torch.zeros((v,), **b),
        steering=torch.zeros((v,), **f), prev_sus_len=torch.full((v, 4), 0.5, **f),
        wheel_omega=torch.zeros((v, 4), **f), wheel_rot=torch.zeros((v, 4), **f),
        unflip_time=torch.zeros((v,), **f), righting_active=torch.zeros((v,), **b),
        wheel_contact=torch.zeros((v, 4), **b), gear=torch.zeros((v,), **i32),
        shift_timer=torch.zeros((v,), **f),
        engine_rpm=torch.full((v,), ENGINE_MIN_RPM, **f),
    )


@dataclasses.dataclass
class VehicleInputs(_Replace):
    """Per-vehicle control inputs (the reference's PlayerPhysicsInput)."""

    forward: torch.Tensor    # [V] -1..1 (W/S)
    right: torch.Tensor      # [V] -1..1 (D/A)
    up: torch.Tensor         # [V] 0..1 (space: hover lift)
    brake: torch.Tensor      # [V] bool
    handbrake: torch.Tensor  # [V] bool


INPUT_FIELDS = tuple(f.name for f in dataclasses.fields(VehicleInputs))

# PlayerPhysicsInput bitflags (wire parity for remote replay).
BF_W, BF_S, BF_A, BF_D, BF_SPACE, BF_C, BF_LEFT, BF_RIGHT, BF_UP, BF_DOWN, BF_B = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


@dataclass
class VehiclePhysicsInput:
    forward: float = 0.0
    right: float = 0.0
    up: float = 0.0
    brake: bool = False
    handbrake: bool = False

    @classmethod
    def from_bitflags(cls, bf: int):
        fwd = (1.0 if bf & (BF_W | BF_UP) else 0.0) - (1.0 if bf & (BF_S | BF_DOWN) else 0.0)
        right = (1.0 if bf & (BF_D | BF_RIGHT) else 0.0) - (1.0 if bf & (BF_A | BF_LEFT) else 0.0)
        return cls(forward=fwd, right=right, up=1.0 if bf & BF_SPACE else 0.0,
                   brake=bool(bf & BF_C), handbrake=bool(bf & BF_B))

    def to_bitflags(self) -> int:
        bf = 0
        if self.forward > 0.5:
            bf |= BF_W
        if self.forward < -0.5:
            bf |= BF_S
        if self.right > 0.5:
            bf |= BF_D
        if self.right < -0.5:
            bf |= BF_A
        if self.up > 0.5:
            bf |= BF_SPACE
        if self.brake:
            bf |= BF_C
        if self.handbrake:
            bf |= BF_B
        return bf


_righting_torque_dv = kveh.righting_torque_dv


def chassis_and_wheel_rays(veh: VehicleArrays, body: BodyState):
    """The pre-ray setup of vehicles_update: each vehicle's chassis state
    (pos, quat, linvel, angvel, mass, world inverse inertia) and its wheels'
    suspension rays (origins [V*4, 3], dirs, max_ts, exclude = the chassis)."""
    v = veh.vtype.shape[0]
    slots = torch.clamp(veh.body_slot, min=0).long()
    pos, quat = body.pos[slots], body.quat[slots]
    chassis = (pos, quat, body.linvel[slots], body.angvel[slots],
               1.0 / torch.clamp(body.inv_mass[slots], min=1e-9),
               tmath.world_inv_inertia(quat, body.inv_inertia[slots]))
    inv_yq = quatm.conjugate(veh.y_fwd_quat)
    up_os = quatm.cross(quatm.rotate_vec(inv_yq, quatm.basis((v,), 0, body.device)),
                        quatm.rotate_vec(inv_yq, quatm.basis((v,), 1, body.device)))
    up_w = quatm.rotate_vec(quat, up_os)
    attach_w = pos[:, None, :] + quatm.rotate_vec(quat[:, None, :], veh.wheel_attach)
    rays = (attach_w.reshape(v * MAX_WHEELS, 3),
            (-up_w)[:, None, :].expand(v, MAX_WHEELS, 3).reshape(v * MAX_WHEELS, 3),
            (veh.sus_max + veh.wheel_radius)[:, None].expand(v, MAX_WHEELS)
            .reshape(v * MAX_WHEELS),
            slots[:, None].expand(v, MAX_WHEELS).reshape(v * MAX_WHEELS).to(torch.int32))
    return chassis, rays


def vehicles_update(veh: VehicleArrays, inputs: VehicleInputs, body: BodyState,
                    world: StaticWorld, dt, params: SimParams, config: SimConfig,
                    table=None):
    """Every vehicle's update: all wheels' suspension rays in one
    ``trace_rays`` batch, then the force models.

    Returns (new_veh, dv [V, 3], dw [V, 3], slots [V]); apply the deltas
    with ``_apply_vehicle_deltas``."""
    v = veh.vtype.shape[0]
    has_body = veh.body_slot >= 0
    chassis, (origins, dirs, max_ts, exclude) = chassis_and_wheel_rays(veh, body)
    hits = queries.trace_rays(origins, dirs, max_ts, body, world, config, n_steps=4,
                              exclude=exclude, table=table)
    hit_t = hits.t.reshape(v, MAX_WHEELS)
    hit_n = hits.normal.reshape(v, MAX_WHEELS, 3)
    hit_ok = hits.hit.reshape(v, MAX_WHEELS) & has_body[:, None]

    (dv, dw, steering, sus_len, omega, rot, unflip, contact, gear, shift_timer,
     engine_rpm) = kveh.vehicle_forces(veh, inputs, *chassis, hit_t, hit_n, hit_ok,
                                       params.water_z, dt)
    ok = has_body[:, None]
    new_veh = veh.replace(steering=steering, prev_sus_len=sus_len, wheel_omega=omega,
                          wheel_rot=rot, unflip_time=unflip, wheel_contact=contact,
                          gear=gear, shift_timer=shift_timer, engine_rpm=engine_rpm)
    return (new_veh, torch.where(ok, dv, 0.0), torch.where(ok, dw, 0.0), veh.body_slot)


def _apply_vehicle_deltas(state: BodyState, slots, dv, dw) -> BodyState:
    """Add the deltas to the chassis velocities and wake them; vehicles
    without a body write to a trash row past the last slot."""
    n = state.capacity
    ok = slots >= 0
    dst = torch.where(ok, slots, n).long()

    def padded(x, fill):
        return torch.cat([x, torch.full((1,) + x.shape[1:], fill, dtype=x.dtype,
                                        device=x.device)])
    lin = padded(state.linvel, 0.0).index_add_(0, dst, torch.where(ok[:, None], dv, 0.0))
    ang = padded(state.angvel, 0.0).index_add_(0, dst, torch.where(ok[:, None], dw, 0.0))
    awake = padded(state.awake, False).index_fill_(0, dst, True)
    timer = padded(state.sleep_timer, 0.0).index_fill_(0, dst, 0.0)
    return state.replace(linvel=lin[:n], angvel=ang[:n], awake=awake[:n],
                         sleep_timer=timer[:n])


def _set_row(t, i, value):
    t = t.clone()
    t[i] = value
    return t


class VehicleManager:
    """Host registry and the per-tick batched update (the reference client
    keeps a vehicle_controllers map, GUIClient.h:502-815, and updates it
    before physics think)."""

    def __init__(self, physics_world, capacity: int = 32):
        self.world = physics_world
        self.veh = zero_vehicles(capacity, device=physics_world.device)
        self.controllers: dict[int, "VehiclePhysicsBase"] = {}
        self._free = list(range(capacity - 1, -1, -1))
        self._inputs: dict[int, VehiclePhysicsInput] = {}

    def _register(self, controller: "VehiclePhysicsBase", settings: VehicleSettings,
                  body_ob) -> int:
        if not self._free:
            raise RuntimeError("vehicle capacity reached")
        i = self._free.pop()
        s = settings
        nw = 2 if s.vehicle_type == VEHICLE_BIKE else (4 if s.vehicle_type == VEHICLE_CAR else 0)
        wa = np.zeros((4, 3), np.float32)
        wa[: len(s.wheel_attach_os)] = np.asarray(s.wheel_attach_os, np.float32)[:4]
        dev = self.world.device

        def vec(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)
        rows = dict(
            vtype=s.vehicle_type, body_slot=body_ob.slot,
            y_fwd_quat=vec(s.model_to_y_forwards_rot), wheel_attach=vec(wa),
            wheel_radius=s.wheel_radius, n_wheels=nw, sus_min=s.suspension_min_length,
            sus_max=s.suspension_max_length, spring_freq=s.suspension_spring_freq,
            spring_damping=s.suspension_spring_damping, max_steer=s.max_steering_angle,
            engine_torque=s.engine_max_torque, engine_max_rpm=s.engine_max_rpm,
            brake_torque=s.max_brake_torque, handbrake_torque=s.max_handbrake_torque,
            mu_long=s.longitudinal_friction_factor, mu_lat=s.lateral_friction_factor,
            steer_relax=s.steering_relax_rate, lean_spring=s.lean_spring,
            lean_damping=s.lean_damping, thrust_force=s.thrust_force,
            propellor_os=vec(s.propellor_point_os),
            rudder_factor=s.rudder_deflection_force_factor,
            thrust_lateral=s.thrust_vector_lateral_amount,
            areas=vec([s.front_cross_sectional_area, s.side_cross_sectional_area,
                       s.top_cross_sectional_area]),
            prev_sus_len=s.suspension_max_length)
        self.veh = self.veh.replace(**{k: _set_row(getattr(self.veh, k), i, val)
                                       for k, val in rows.items()})
        self.controllers[i] = controller
        self._inputs[i] = VehiclePhysicsInput()
        return i

    def remove(self, controller: "VehiclePhysicsBase"):
        i = controller.index
        self.veh = self.veh.replace(body_slot=_set_row(self.veh.body_slot, i, -1),
                                    active=_set_row(self.veh.active, i, False))
        self.controllers.pop(i, None)
        self._inputs.pop(i, None)
        self._free.append(i)

    def set_input(self, index: int, inp: VehiclePhysicsInput):
        self._inputs[index] = inp

    def set_active(self, index: int, active: bool):
        self.veh = self.veh.replace(active=_set_row(self.veh.active, index, bool(active)))

    def set_righting(self, index: int, on: bool):
        self.veh = self.veh.replace(
            righting_active=_set_row(self.veh.righting_active, index, bool(on)))

    def update(self, dt: float):
        """One batched controller step; call before world.think(dt)."""
        if not self.controllers:
            return  # no vehicles registered: skip the device pass
        w = self.world
        w._flush()
        v = self.veh.vtype.shape[0]
        f, r, u = (np.zeros(v, np.float32) for _ in range(3))
        br, hb = np.zeros(v, bool), np.zeros(v, bool)
        for i, inp in self._inputs.items():
            f[i], r[i], u[i] = inp.forward, inp.right, inp.up
            br[i], hb[i] = inp.brake, inp.handbrake
        dev = w.device
        inputs = VehicleInputs(*(torch.as_tensor(x, device=dev) for x in (f, r, u, br, hb)))
        self.veh, dv, dw, slots = vehicles_update(self.veh, inputs, w.state, w.static_world,
                                                  dt, w.params, w.config)
        w.state = _apply_vehicle_deltas(w.state, slots, dv, dw)
        # A direct state write bypasses the host mutation paths: clear the
        # fully-asleep latch so think() steps (a driven vehicle in an
        # otherwise sleeping world must move).
        w._world_asleep = False


class VehiclePhysicsBase:
    """The reference's VehiclePhysics interface (VehiclePhysics.h:30-80)."""

    vehicle_type: int = VEHICLE_CAR

    def __init__(self, manager: VehicleManager, body_ob,
                 settings: VehicleSettings | None = None):
        self.settings = settings or VehicleSettings(vehicle_type=self.vehicle_type)
        self.settings.vehicle_type = self.vehicle_type
        self.manager = manager
        self.body_ob = body_ob
        self.index = manager._register(self, self.settings, body_ob)
        self.user_in_driver_seat = False

    def get_body_id(self):
        return self.body_ob.slot

    def update(self, inp: VehiclePhysicsInput):
        """Queue this vehicle's input for the next batched manager update."""
        self.manager.set_input(self.index, inp)

    def player_entered(self, seat_index: int = 0):
        self.user_in_driver_seat = seat_index == 0
        self.manager.set_active(self.index, self.user_in_driver_seat)

    def player_exited(self):
        self.user_in_driver_seat = False
        self.manager.set_active(self.index, False)

    def start_righting(self):
        self.manager.set_righting(self.index, True)

    def stop_righting(self):
        self.manager.set_righting(self.index, False)

    def get_wheel_state(self):
        i = self.index
        veh = self.manager.veh
        return tuple(x[i].cpu().numpy() for x in (veh.wheel_rot, veh.wheel_omega,
                                                  veh.wheel_contact, veh.prev_sus_len))

    def get_doppler_factor(self, listener_pos, listener_vel=None):
        """Doppler from projected source and listener velocities, c = 343
        (the reference's AudioEngine.cpp:131-146)."""
        c = 343.0
        src_pos = np.asarray(self.body_ob.pos, np.float32)
        src_vel = np.asarray(self.body_ob.linvel, np.float32)
        lv = np.zeros(3, np.float32) if listener_vel is None else np.asarray(listener_vel)
        to_listener = np.asarray(listener_pos, np.float32) - src_pos
        d = np.linalg.norm(to_listener)
        if d < 1e-6:
            return 1.0
        dirn = to_listener / d
        vs = float(np.dot(src_vel, dirn))
        vl = float(np.dot(lv, dirn))
        return float(np.clip((c - vl) / max(c - vs, 1e-3), 0.5, 2.0))


class CarPhysics(VehiclePhysicsBase):
    vehicle_type = VEHICLE_CAR


class BikePhysics(VehiclePhysicsBase):
    vehicle_type = VEHICLE_BIKE

    def __init__(self, manager, body_ob, settings=None):
        # The reference fixes the bike's engine (BikePhysics.cpp:211-213).
        settings = settings or VehicleSettings(vehicle_type=VEHICLE_BIKE)
        settings.engine_max_torque = BIKE_ENGINE_TORQUE
        settings.engine_max_rpm = BIKE_ENGINE_MAX_RPM
        super().__init__(manager, body_ob, settings)


class BoatPhysics(VehiclePhysicsBase):
    vehicle_type = VEHICLE_BOAT

    def __init__(self, manager, body_ob, settings=None):
        super().__init__(manager, body_ob, settings)
        # Boats do their own drag; the world's buoyancy pass skips linear
        # drag for them (BoatPhysics.cpp:36 use_zero_linear_drag).
        self.body_ob.use_zero_linear_drag = True
        manager.world._dirty[self.body_ob.slot] = (self.body_ob, True)


class HoverCarPhysics(VehiclePhysicsBase):
    vehicle_type = VEHICLE_HOVER
