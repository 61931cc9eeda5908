"""WorldObject: the scene-state record.

A copy of ``substrata_tpu/shared/world_object.py``: importing any module of the
reference package loads jax, so the port keeps its own.

Parity with shared/WorldObject.h: UID, object type enum (272-286), TRS
transform, model/script/audio URLs, materials, flags (346-359), physics
properties (mass/friction/restitution), dynamic/collidable state, physics
owner (412), velocity staging for snapshot send (566-567), voxel payload,
and binary (de)serialisation for ObjectInitialSend / ObjectFullUpdate.
"""

from __future__ import annotations

import enum
import io
import struct
from dataclasses import dataclass, field

import numpy as np


class ObjectType(enum.IntEnum):
    """WorldObject.h:272-286."""

    GENERIC = 0
    HYPERCARD = 1
    VOXEL_GROUP = 2
    SPOTLIGHT = 3
    WEB_VIEW = 4
    VIDEO = 5
    TEXT = 6
    PORTAL = 7
    SEAT = 8
    GEAR_ITEM = 9
    SPLAT = 10


# Flags — value-for-value parity with WorldObject.h:346-358.
COLLIDABLE_FLAG = 1
LIGHTMAP_NEEDS_COMPUTING_FLAG = 2
HIGH_QUAL_LIGHTMAP_NEEDS_COMPUTING_FLAG = 4
DYNAMIC_FLAG = 8
SUMMONED_FLAG = 16
VIDEO_AUTOPLAY = 32
VIDEO_LOOP = 64
VIDEO_MUTED = 128
IS_SENSOR_FLAG = 256
EXCLUDE_FROM_LOD_CHUNK_MESH = 512
AUDIO_AUTOPLAY = 1024
AUDIO_LOOP = 2048
CREATED_VIA_MCP = 4096


@dataclass
class WorldMaterial:
    """Minimal WorldMaterial (shared/WorldMaterial.h): colour + textures +
    the PBR scalars the sim/LOD path needs."""

    colour_rgb: tuple = (0.85, 0.85, 0.85)
    colour_texture_url: str = ""
    emission_texture_url: str = ""
    roughness: float = 0.5
    metallic: float = 0.0
    opacity: float = 1.0
    emission_lum_flux: float = 0.0
    flags: int = 0

    def write_to(self, s: io.BytesIO):
        s.write(struct.pack("<3f", *self.colour_rgb))
        _w_str(s, self.colour_texture_url)
        _w_str(s, self.emission_texture_url)
        s.write(struct.pack("<4fI", self.roughness, self.metallic,
                            self.opacity, self.emission_lum_flux, self.flags))

    @classmethod
    def read_from(cls, s: io.BytesIO):
        r, g, b = struct.unpack("<3f", s.read(12))
        ct = _r_str(s)
        et = _r_str(s)
        ro, me, op, em, fl = struct.unpack("<4fI", s.read(20))
        return cls((r, g, b), ct, et, ro, me, op, em, fl)


def _w_str(s, v: str):
    b = v.encode("utf-8")
    s.write(struct.pack("<I", len(b)))
    s.write(b)


def _r_str(s) -> str:
    (n,) = struct.unpack("<I", s.read(4))
    return s.read(n).decode("utf-8")


@dataclass(eq=False)
class WorldObject:
    uid: int = 0
    object_type: int = int(ObjectType.GENERIC)
    model_url: str = ""
    script: str = ""                 # XML script source (path/vehicle scripts)
    content: str = ""                # hypercard/text content
    target_url: str = ""
    audio_source_url: str = ""
    audio_volume: float = 1.0
    materials: list = field(default_factory=list)
    lightmap_url: str = ""

    pos: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float64))
    axis: np.ndarray = field(default_factory=lambda: np.array([0, 0, 1], np.float32))
    angle: float = 0.0
    scale: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))

    flags: int = COLLIDABLE_FLAG
    creator_id: int = 0
    created_time: float = 0.0

    # Physics (WorldObject.h mass/friction/restitution)
    mass: float = 50.0
    friction: float = 0.5
    restitution: float = 0.2
    centre_of_mass_offset_os: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))

    # Physics-ownership + velocity staging for snapshot send
    # (WorldObject.h:412, 566-567)
    physics_owner_id: int = 0
    last_physics_ownership_change_global_time: float = 0.0
    linear_vel: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    angular_vel: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    last_transform_update_avatar_uid: int = 0
    last_transform_client_time: float = 0.0

    # Voxels (compressed voxel group, WorldObject.h:234-235)
    voxel_data: bytes = b""

    # Spotlight / text / seat extras
    max_model_lod_level: int = 2

    # Client-side runtime refs (physics/audio/GL/scripts), not serialised —
    # mirrors WorldObject.h:460-522.
    physics_object: object = None
    mesh_instance_id: object = None   # static trimesh instance (client)
    audio_source: object = None
    script_evaluator: object = None
    vehicle_physics: object = None
    from_remote_physics_transform_dirty: bool = False
    from_local_physics_dirty: bool = False

    @property
    def quat(self) -> np.ndarray:
        """Rotation quaternion from axis-angle storage."""
        ax = np.asarray(self.axis, np.float32)
        n = np.linalg.norm(ax)
        ax = ax / n if n > 1e-9 else np.array([0, 0, 1], np.float32)
        half = self.angle * 0.5
        return np.concatenate([ax * np.sin(half),
                               [np.cos(half)]]).astype(np.float32)

    def set_rotation_quat(self, q: np.ndarray):
        q = np.asarray(q, np.float32)
        q = q / max(np.linalg.norm(q), 1e-9)
        s = np.linalg.norm(q[:3])
        self.angle = float(2.0 * np.arctan2(s, q[3]))
        self.axis = (q[:3] / s if s > 1e-6 else np.array([0, 0, 1], np.float32))

    def is_dynamic(self) -> bool:
        return bool(self.flags & DYNAMIC_FLAG)

    def is_collidable(self) -> bool:
        return bool(self.flags & COLLIDABLE_FLAG)

    def is_physics_owner_free(self, global_time: float) -> bool:
        from substrata_tpu_torch.net.snapshots import OWNERSHIP_PERIOD
        return (self.physics_owner_id == 0
                or (global_time - self.last_physics_ownership_change_global_time)
                > OWNERSHIP_PERIOD)

    # ------------------------------------------------------------------
    # Serialisation (writeToNetworkStream /
    # readWorldObjectFromNetworkStreamGivenUID parity)
    # ------------------------------------------------------------------
    def write_to_stream(self, s: io.BytesIO, include_uid: bool = True):
        if include_uid:
            s.write(struct.pack("<Q", self.uid))
        s.write(struct.pack("<I", self.object_type))
        _w_str(s, self.model_url)
        _w_str(s, self.script)
        _w_str(s, self.content)
        _w_str(s, self.target_url)
        _w_str(s, self.audio_source_url)
        _w_str(s, self.lightmap_url)
        s.write(struct.pack("<f", self.audio_volume))
        s.write(struct.pack("<3d", *np.asarray(self.pos, np.float64)))
        s.write(struct.pack("<3f", *np.asarray(self.axis, np.float32)))
        s.write(struct.pack("<f", self.angle))
        s.write(struct.pack("<3f", *np.asarray(self.scale, np.float32)))
        s.write(struct.pack("<IIf", self.flags, self.creator_id, self.created_time))
        s.write(struct.pack("<3f", self.mass, self.friction, self.restitution))
        s.write(struct.pack("<3f", *np.asarray(self.centre_of_mass_offset_os, np.float32)))
        s.write(struct.pack("<Id", self.physics_owner_id,
                            self.last_physics_ownership_change_global_time))
        s.write(struct.pack("<I", len(self.materials)))
        for m in self.materials:
            m.write_to(s)
        s.write(struct.pack("<I", len(self.voxel_data)))
        s.write(self.voxel_data)

    @classmethod
    def read_from_stream(cls, s: io.BytesIO, uid: int | None = None) -> "WorldObject":
        ob = cls()
        ob.uid = struct.unpack("<Q", s.read(8))[0] if uid is None else uid
        (ob.object_type,) = struct.unpack("<I", s.read(4))
        ob.model_url = _r_str(s)
        ob.script = _r_str(s)
        ob.content = _r_str(s)
        ob.target_url = _r_str(s)
        ob.audio_source_url = _r_str(s)
        ob.lightmap_url = _r_str(s)
        (ob.audio_volume,) = struct.unpack("<f", s.read(4))
        ob.pos = np.array(struct.unpack("<3d", s.read(24)))
        ob.axis = np.array(struct.unpack("<3f", s.read(12)), np.float32)
        (ob.angle,) = struct.unpack("<f", s.read(4))
        ob.scale = np.array(struct.unpack("<3f", s.read(12)), np.float32)
        ob.flags, ob.creator_id, ob.created_time = struct.unpack("<IIf", s.read(12))
        ob.mass, ob.friction, ob.restitution = struct.unpack("<3f", s.read(12))
        ob.centre_of_mass_offset_os = np.array(struct.unpack("<3f", s.read(12)), np.float32)
        ob.physics_owner_id, ob.last_physics_ownership_change_global_time = \
            struct.unpack("<Id", s.read(12))
        (nmats,) = struct.unpack("<I", s.read(4))
        ob.materials = [WorldMaterial.read_from(s) for _ in range(nmats)]
        (nvox,) = struct.unpack("<I", s.read(4))
        ob.voxel_data = s.read(nvox)
        return ob

    def to_bytes(self) -> bytes:
        s = io.BytesIO()
        self.write_to_stream(s)
        return s.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "WorldObject":
        return cls.read_from_stream(io.BytesIO(data))
