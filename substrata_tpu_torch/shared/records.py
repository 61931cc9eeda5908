"""Small shared world-model records.

Parity with the remaining shared/ records: WorldSettings.* (terrain spec +
water), WorldDetails.*, GestureSettings.*, GearItem.*, LODChunk.*,
GroundPatch.*, RateLimiter.*, UID.h/UserID.h conventions.

A copy of ``substrata_tpu/shared/records.py`` with the port's imports: importing
any module of the reference package loads jax, so the port keeps its own.
"""

from __future__ import annotations

import io
import struct
import time
from dataclasses import dataclass, field

import numpy as np


def _w_str(s, v: str):
    b = v.encode("utf-8")
    s.write(struct.pack("<I", len(b)))
    s.write(b)


def _r_str(s) -> str:
    (n,) = struct.unpack("<I", s.read(4))
    return s.read(n).decode("utf-8")


@dataclass
class TerrainSpecSection:
    """One heightmap/mask section of the world terrain spec."""

    x: int = 0
    y: int = 0
    heightmap_url: str = ""
    mask_map_url: str = ""
    tree_mask_map_url: str = ""


@dataclass
class WorldSettings:
    """shared/WorldSettings.h: terrain spec + water plane config, broadcast
    via WORLD_SETTINGS_UPDATE (3701, Protocol.h:152)."""

    terrain_sections: list = field(default_factory=list)
    terrain_section_width_m: float = 1024.0
    default_terrain_z: float = 0.0
    water_z: float = 0.0
    water_enabled: bool = False

    def to_bytes(self) -> bytes:
        s = io.BytesIO()
        s.write(struct.pack("<ffB", self.terrain_section_width_m,
                            self.default_terrain_z, self.water_enabled))
        s.write(struct.pack("<f", self.water_z))
        s.write(struct.pack("<I", len(self.terrain_sections)))
        for t in self.terrain_sections:
            s.write(struct.pack("<ii", t.x, t.y))
            _w_str(s, t.heightmap_url)
            _w_str(s, t.mask_map_url)
            _w_str(s, t.tree_mask_map_url)
        return s.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "WorldSettings":
        s = io.BytesIO(data)
        w, dz, we = struct.unpack("<ffB", s.read(9))
        (wz,) = struct.unpack("<f", s.read(4))
        (n,) = struct.unpack("<I", s.read(4))
        sections = []
        for _ in range(n):
            x, y = struct.unpack("<ii", s.read(8))
            sections.append(TerrainSpecSection(
                x, y, _r_str(s), _r_str(s), _r_str(s)))
        return cls(sections, w, dz, wz, bool(we))


@dataclass
class WorldDetails:
    """shared/WorldDetails.h: world metadata for the world list."""

    name: str = ""
    owner_id: int = 0
    created_time: float = 0.0
    description: str = ""


@dataclass
class GestureSettings:
    """shared/GestureSettings.h: a playable gesture's animation config."""

    name: str = ""
    animate_head: bool = False
    loop: bool = False
    duration: float = 2.0


@dataclass
class GearItem:
    """shared/GearItem.h: equippable item (model + attachment), streamed
    via the gear message family (Protocol.h:1400-1406)."""

    item_id: int = 0
    owner_id: int = 0
    name: str = ""
    model_url: str = ""
    attach_bone: str = "head"
    equipped: bool = False
    pre_attach_transform: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float32))

    def to_bytes(self) -> bytes:
        s = io.BytesIO()
        s.write(struct.pack("<QQB", self.item_id, self.owner_id,
                            self.equipped))
        _w_str(s, self.name)
        _w_str(s, self.model_url)
        _w_str(s, self.attach_bone)
        s.write(np.asarray(self.pre_attach_transform,
                           np.float32).tobytes())
        return s.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "GearItem":
        s = io.BytesIO(data)
        item_id, owner_id, eq = struct.unpack("<QQB", s.read(17))
        name, url, bone = _r_str(s), _r_str(s), _r_str(s)
        m = np.frombuffer(s.read(64), np.float32).reshape(4, 4).copy()
        return cls(item_id, owner_id, name, url, bone, bool(eq), m)


@dataclass
class LODChunk:
    """shared/LODChunk.h: a combined far-LOD mesh for a world grid cell
    (generated by ChunkGenThread, streamed via LOD-chunk messages)."""

    x: int = 0
    y: int = 0
    mesh_url: str = ""
    combined_array_texture_url: str = ""
    needs_rebuild: bool = False

    def to_bytes(self) -> bytes:
        s = io.BytesIO()
        s.write(struct.pack("<iiB", self.x, self.y, self.needs_rebuild))
        _w_str(s, self.mesh_url)
        _w_str(s, self.combined_array_texture_url)
        return s.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "LODChunk":
        s = io.BytesIO(data)
        x, y, nr = struct.unpack("<iiB", s.read(9))
        return cls(x, y, _r_str(s), _r_str(s), bool(nr))


@dataclass
class GroundPatch:
    """shared/GroundPatch.h: a claimed ground-texture patch."""

    x: int = 0
    y: int = 0
    texture_url: str = ""


class RateLimiter:
    """shared/RateLimiter.h: sliding-window event rate limiting used by the
    server to cap per-connection message rates."""

    def __init__(self, max_events: int, period: float,
                 clock=time.monotonic):
        self.max_events = max_events
        self.period = period
        self._clock = clock
        self._events: list[float] = []

    def check_add_event(self, now: float | None = None) -> bool:
        """True if the event is allowed (and recorded)."""
        now = self._clock() if now is None else now
        cutoff = now - self.period
        self._events = [t for t in self._events if t > cutoff]
        if len(self._events) >= self.max_events:
            return False
        self._events.append(now)
        return True
