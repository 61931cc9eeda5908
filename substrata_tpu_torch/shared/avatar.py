"""Avatar: remote-player record (parity: shared/Avatar.h).

A copy of ``substrata_tpu/shared/avatar.py``: importing any module of the
reference package loads jax, so the port keeps its own.

pos + rotation as (roll, pitch, heading) (Avatar.h:133-134), anim_state
bitflags (141), avatar settings (model URL + materials + pre-ob-to-world
matrix), snapshot ring like WorldObject (221), vehicle occupancy
(entered_vehicle + seat index, consumed by the client tick
GUIClient.cpp:10666-10676), gesture state, and the voice audio source.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field

import numpy as np

# anim_state bitflags (Avatar.h:141)
ANIM_STATE_IN_AIR = 1
ANIM_STATE_FLYING = 2
ANIM_STATE_MOVE_IMPULSE_ZERO = 4


@dataclass
class AvatarSettings:
    model_url: str = ""
    materials: list = field(default_factory=list)
    pre_ob_to_world_matrix: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float32))


@dataclass(eq=False)
class Avatar:
    uid: int = 0
    name: str = ""
    pos: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float64))
    rotation: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    # (roll, pitch, heading)
    anim_state: int = 0
    settings: AvatarSettings = field(default_factory=AvatarSettings)

    # Vehicle occupancy + the driver's last input bitflags so other clients
    # replay the vehicle controller locally (VehiclePhysics.h:79
    # last_physics_input_bitflags; replayed GUIClient.cpp:6497-6506).
    entered_vehicle_uid: int = 0   # 0 = on foot
    vehicle_seat_index: int = 0
    last_physics_input_bitflags: int = 0

    # Gestures
    performing_gesture: str = ""

    # Voice (ClientUDPHandlerThread: per-avatar stream id + audio source)
    audio_stream_id: int = 0
    audio_source: object = None

    # Client-side runtime
    graphics: object = None
    snapshot_index: int = -1   # slot in the client's SnapshotRings

    def write_to_stream(self, s: io.BytesIO):
        s.write(struct.pack("<Q", self.uid))
        b = self.name.encode("utf-8")
        s.write(struct.pack("<I", len(b)))
        s.write(b)
        s.write(struct.pack("<3d", *np.asarray(self.pos, np.float64)))
        s.write(struct.pack("<3f", *np.asarray(self.rotation, np.float32)))
        s.write(struct.pack("<I", self.anim_state))
        mb = self.settings.model_url.encode("utf-8")
        s.write(struct.pack("<I", len(mb)))
        s.write(mb)
        s.write(struct.pack("<QII", self.entered_vehicle_uid,
                            self.vehicle_seat_index,
                            self.last_physics_input_bitflags))

    @classmethod
    def read_from_stream(cls, s: io.BytesIO) -> "Avatar":
        av = cls()
        (av.uid,) = struct.unpack("<Q", s.read(8))
        (n,) = struct.unpack("<I", s.read(4))
        av.name = s.read(n).decode("utf-8")
        av.pos = np.array(struct.unpack("<3d", s.read(24)))
        av.rotation = np.array(struct.unpack("<3f", s.read(12)), np.float32)
        (av.anim_state,) = struct.unpack("<I", s.read(4))
        (m,) = struct.unpack("<I", s.read(4))
        av.settings.model_url = s.read(m).decode("utf-8")
        (av.entered_vehicle_uid, av.vehicle_seat_index,
         av.last_physics_input_bitflags) = struct.unpack("<QII", s.read(16))
        return av

    def to_bytes(self) -> bytes:
        s = io.BytesIO()
        self.write_to_stream(s)
        return s.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "Avatar":
        return cls.read_from_stream(io.BytesIO(data))
