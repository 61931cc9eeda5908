"""Kinematic capsule character controller.

Counterpart of ``substrata_tpu/physics/character.py`` (the reference's
behavioural port of gui_client/PlayerPhysics): capsule r = 0.3, cylinder
1.3, eye height 1.67; walk 3 m/s, run x5, jump 4.5 m/s, air control capped
at 8 m/s, water buoyancy and drag, fly mode, collide-and-slide with
anti-slide on shallow static ground, stair walk (step-up 0.4) and
stick-to-floor (step-down 0.5), camera z smoothing.  The update itself is
kernel KL (``kernels/character.py``); this module holds the state, the
reference's entry points and the host wrapper ``PlayerPhysics``, which
also owns the kinematic capsule proxy body that lets the solver push
dynamic bodies.

Not in this slice: pipelined readback (``set_pipelined`` with a depth
raises, ROADMAP.md queue 1, slice 2).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from substrata_tpu_torch.kernels import character as _kl
from substrata_tpu_torch.kernels.character import (  # noqa: F401
    CYLINDER_HEIGHT, EYE_HEIGHT, JUMP_PERIOD, JUMP_SPEED, MAX_AIR_SPEED, MAX_PROBE_CONTACTS,
    MAX_SLOPE_COS, MOVE_SPEED, RUN_FACTOR, SITTING_HEIGHT, SPHERE_RAD, STAIR_STEP_UP,
    STICK_TO_FLOOR_STEP,
)
from substrata_tpu_torch.physics import broadphase, queries
from substrata_tpu_torch.physics.state import (BodyState, MotionType, SimConfig, SimParams,
                                               StaticWorld, _Replace)

_SLICE2 = "ROADMAP.md queue 1, slice 2: facade completion"


@dataclasses.dataclass
class CharacterState(_Replace):
    pos: torch.Tensor              # [3] foot position (capsule bottom)
    vel: torch.Tensor              # [3]
    on_ground: torch.Tensor        # [] bool
    ground_normal: torch.Tensor    # [3]
    ground_vel: torch.Tensor       # [3]
    campos_z_delta: torch.Tensor   # [] f32
    gravity_enabled: torch.Tensor  # [] bool
    fly_mode: torch.Tensor         # [] bool
    sitting: torch.Tensor          # [] bool


CHARACTER_FIELDS = _kl.STATE_FIELDS


def init_character_state(eye_pos, *, device) -> CharacterState:
    """The foot sits EYE_HEIGHT below ``eye_pos`` (PlayerPhysics::init);
    gravity stays off until the player first moves (spawn safety)."""
    foot = np.asarray(eye_pos, np.float32) - np.array([0, 0, EYE_HEIGHT], np.float32)
    f = dict(dtype=torch.float32, device=device)
    no = torch.zeros((), dtype=torch.bool, device=device)
    return CharacterState(
        pos=torch.as_tensor(foot, device=device), vel=torch.zeros(3, **f),
        on_ground=no.clone(), ground_normal=torch.tensor([0.0, 0.0, 1.0], **f),
        ground_vel=torch.zeros(3, **f), campos_z_delta=torch.zeros((), **f),
        gravity_enabled=no.clone(), fly_mode=no.clone(), sitting=no.clone())


def tick_scalars(dt, move, jump, fly, sitting, exclude) -> np.ndarray:
    """The update's 8 scalars as the serving tick packs them: dt, move (3),
    jump, fly, sitting, and the excluded slot as int32 bits."""
    s = np.zeros(8, np.float32)
    s[0] = dt
    s[1:4] = np.asarray(move, np.float32)
    s[4:7] = [1.0 if jump else 0.0, 1.0 if fly else 0.0, 1.0 if sitting else 0.0]
    s[7:8].view(np.int32)[0] = int(exclude)
    return s


def _fields(char: CharacterState) -> dict:
    return {f: getattr(char, f) for f in CHARACTER_FIELDS}


def player_update_packed(char: CharacterState, body: BodyState, world: StaticWorld, scal,
                         params: SimParams, config: SimConfig, table=None, os_idx=None,
                         out=None):
    """character_update + the packed readback vector from the device
    scalars ``scal`` [8] (see ``tick_scalars``).  ``table``: a cell table
    shared with the tick's other queries; ``out``: where the packed vector
    goes.  Returns (new state, packed [15 + K])."""
    if table is None:
        table = broadphase.build_cell_table(body, config)[0]
    if os_idx is None:
        os_idx = queries.oversize_slots(body, config)
    new, packed = _kl.character_packed(
        _fields(char), body, world.heightfield, world.has_heightfield, params.water_z, table,
        os_idx, scal, cell_size=config.cell_size, grid_dim=config.grid_dim,
        trimesh=world.trimesh, out=out)
    return CharacterState(**new), packed


def character_update(char: CharacterState, body: BodyState, world: StaticWorld,
                     move_desired_vel, jump_requested, fly_mode, sitting, dt,
                     params: SimParams, config: SimConfig, exclude_body, table=None):
    """One substep of PlayerPhysics::update (character.py:264), with the
    reference's arguments.  Returns (new state, campos [4], jumped [] bool,
    touched [K] i32)."""
    scal = torch.as_tensor(tick_scalars(dt, move_desired_vel, bool(jump_requested),
                                        bool(fly_mode), bool(sitting), int(exclude_body)),
                           device=body.device)
    new, packed = player_update_packed(char, body, world, scal, params, config, table=table)
    return new, packed[0:4], packed[4] > 0.5, packed[_kl.N_PACKED_HEAD:].to(torch.int32)


class PlayerPhysics:
    """Host wrapper: input accumulation and the kinematic proxy body.

    The API of gui_client/PlayerPhysics.h as the reference keeps it:
    process_move / process_jump / update / set_fly_mode_enabled /
    get_eye_position / set_position."""

    def __init__(self, physics_world, eye_pos=(0.0, 0.0, 2.0)):
        from substrata_tpu_torch.physics import shapes
        from substrata_tpu_torch.physics.world import USERDATA_AVATAR, PhysicsObject

        self.world = physics_world
        self.state = init_character_state(eye_pos, device=physics_world.device)
        self._host_pos = np.asarray(eye_pos, np.float32) - np.array([0, 0, EYE_HEIGHT],
                                                                    np.float32)
        self._host_on_ground = False
        self._host_vel = np.zeros(3, np.float32)
        self._last_campos = np.array(list(np.asarray(eye_pos, np.float32)) + [1.0], np.float32)
        self.move_desired_vel = np.zeros(3, np.float32)
        self.last_jump_time = -1.0
        self.fly_mode = False
        self.sitting = False
        self.last_update_events_jumped = False
        self.contacted_bodies: list = []
        self.last_xy_plane_vel_rel_ground = np.zeros(3, np.float32)
        self.proxy = physics_world.add_object(PhysicsObject(
            shape=shapes.make_capsule(SPHERE_RAD, CYLINDER_HEIGHT / 2),
            pos=self._capsule_center(), motion_type=int(MotionType.KINEMATIC),
            userdata_type=USERDATA_AVATAR))

    def _capsule_center(self):
        return self._host_pos + np.array([0, 0, SPHERE_RAD + CYLINDER_HEIGHT / 2], np.float32)

    def process_move(self, vec, runpressed=False):
        self.move_desired_vel += np.asarray(vec, np.float32) * MOVE_SPEED * (
            RUN_FACTOR if runpressed else 1.0)

    def process_jump(self, cur_time):
        self.last_jump_time = cur_time

    def set_fly_mode_enabled(self, enabled):
        self.fly_mode = bool(enabled)

    def is_move_desired_vel_nonzero(self):
        return float(np.sum(self.move_desired_vel ** 2)) > 0

    def zero_move_desired_vel(self):
        self.move_desired_vel = np.zeros(3, np.float32)

    def set_pipelined(self, depth: int):
        if depth > 0:
            raise NotImplementedError(f"pipelined readback is not ported yet ({_SLICE2})")

    def tick_scalars(self, dt, cur_time):
        """This tick's 8 update scalars (see ``tick_scalars``)."""
        jump_req = (cur_time - self.last_jump_time) < JUMP_PERIOD
        return tick_scalars(dt, self.move_desired_vel, jump_req, self.fly_mode, self.sitting,
                            self.proxy.slot)

    def update(self, dt, cur_time=0.0):
        """One character update outside the fused serving tick.  Returns
        (campos [4], jumped); reads back one packed vector."""
        w = self.world
        w._flush()
        scal = torch.as_tensor(self.tick_scalars(dt, cur_time), device=w.device)
        self.state, packed = player_update_packed(self.state, w.state, w.static_world, scal,
                                                  w.params, w.config)
        jumped = self._consume_packed(packed.cpu().numpy())
        w.move_kinematic_object(self.proxy, self._capsule_center(), self.proxy.rot, dt)
        self.zero_move_desired_vel()
        return self._last_campos.copy(), jumped

    def _consume_packed(self, pk) -> bool:
        """Refresh the host mirrors from one packed vector."""
        w = self.world
        jumped = bool(pk[4] > 0.5)
        self._host_on_ground = bool(pk[5] > 0.5)
        self._host_pos = pk[6:9].copy()
        v, gv = pk[9:12], pk[12:15]
        self._host_vel = v.copy()
        if jumped:
            self.last_jump_time = -1.0
        self.last_update_events_jumped = jumped
        t = pk[_kl.N_PACKED_HEAD:].astype(np.int32)
        self.contacted_bodies = [w.objects[int(s)] for s in t[t >= 0] if int(s) in w.objects]
        self.last_xy_plane_vel_rel_ground = (
            (v - gv) if self._host_on_ground else v) * np.array([1, 1, 0], np.float32)
        self._last_campos = pk[0:4].copy()
        return jumped

    @property
    def on_ground(self):
        return self._host_on_ground

    def get_velocity(self):
        return self._host_vel

    def get_eye_position(self):
        return self._host_pos + np.array([0, 0, EYE_HEIGHT], np.float32)

    def set_position(self, eye_pos, linvel=None):
        foot = np.asarray(eye_pos, np.float32) - np.array([0, 0, EYE_HEIGHT], np.float32)
        dev = self.world.device
        self.state = self.state.replace(pos=torch.as_tensor(foot, device=dev))
        self._host_pos = foot.copy()
        if linvel is not None:
            self.state = self.state.replace(
                vel=torch.as_tensor(np.asarray(linvel, np.float32), device=dev))
