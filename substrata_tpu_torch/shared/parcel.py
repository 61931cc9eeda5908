"""Parcel: land-parcel record (parity: shared/Parcel.h — bounds, owner,
writer/admin permission lists, auction state).

A copy of ``substrata_tpu/shared/parcel.py`` (the reference package cannot
be imported without jax)."""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field

import numpy as np


@dataclass(eq=False)
class Parcel:
    parcel_id: int = 0
    owner_id: int = 0
    title: str = ""
    description: str = ""
    # Axis-aligned bounds (verts in the reference are a quad + zmin/zmax;
    # we store the AABB directly).
    aabb_min: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float64))
    aabb_max: np.ndarray = field(default_factory=lambda: np.ones(3, np.float64))
    writer_ids: list = field(default_factory=list)
    admin_ids: list = field(default_factory=list)
    all_writeable: bool = False
    mute_outside_audio: bool = False  # parcel-based audio mute fades
    # Auction state (ParcelAuction linkage)
    auction_ids: list = field(default_factory=list)

    def contains(self, p) -> bool:
        p = np.asarray(p)
        return bool(np.all(p >= self.aabb_min) and np.all(p <= self.aabb_max))

    def user_has_write_perms(self, user_id: int) -> bool:
        """userHasObjectWritePermissions core (server WorkerThread.cpp:2069)."""
        return (self.all_writeable or user_id == self.owner_id
                or user_id in self.writer_ids or user_id in self.admin_ids)

    def write_to_stream(self, s: io.BytesIO):
        s.write(struct.pack("<QI", self.parcel_id, self.owner_id))
        b = self.description.encode("utf-8")
        s.write(struct.pack("<I", len(b)))
        s.write(b)
        s.write(struct.pack("<3d", *self.aabb_min))
        s.write(struct.pack("<3d", *self.aabb_max))
        s.write(struct.pack("<I", len(self.writer_ids)))
        for w in self.writer_ids:
            s.write(struct.pack("<I", w))
        s.write(struct.pack("<I", len(self.admin_ids)))
        for a in self.admin_ids:
            s.write(struct.pack("<I", a))
        s.write(struct.pack("<BB", self.all_writeable, self.mute_outside_audio))

    @classmethod
    def read_from_stream(cls, s: io.BytesIO) -> "Parcel":
        p = cls()
        p.parcel_id, p.owner_id = struct.unpack("<QI", s.read(12))
        (n,) = struct.unpack("<I", s.read(4))
        p.description = s.read(n).decode("utf-8")
        p.aabb_min = np.array(struct.unpack("<3d", s.read(24)))
        p.aabb_max = np.array(struct.unpack("<3d", s.read(24)))
        (nw,) = struct.unpack("<I", s.read(4))
        p.writer_ids = list(struct.unpack(f"<{nw}I", s.read(4 * nw))) if nw else []
        (na,) = struct.unpack("<I", s.read(4))
        p.admin_ids = list(struct.unpack(f"<{na}I", s.read(4 * na))) if na else []
        aw, mo = struct.unpack("<BB", s.read(2))
        p.all_writeable = bool(aw)
        p.mute_outside_audio = bool(mo)
        return p

    def to_bytes(self) -> bytes:
        s = io.BytesIO()
        self.write_to_stream(s)
        return s.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "Parcel":
        return cls.read_from_stream(io.BytesIO(data))
