"""Converters between numpy arrays and the port's tensor dataclasses.

The reference package's state converts field by field: the caller turns
each of its arrays into numpy (``np.asarray``) and passes a mapping of
field name -> array; the port never sees an array of the reference's
framework.  ``to_numpy`` goes the other way, for comparisons.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from substrata_tpu_torch.anim.clips import CLIP_RATE, ClipBank
from substrata_tpu_torch.anim.pose import PoseParams, pose_params_from_arrays
from substrata_tpu_torch.audio.mix import (LISTENER_FIELDS, ROOM_FIELDS, SOURCE_FIELDS,
                                           Listener, RoomState, SourceState)
from substrata_tpu_torch.physics.broadphase import PairCache
from substrata_tpu_torch.physics.character import CHARACTER_FIELDS, CharacterState
from substrata_tpu_torch.physics.particles import PARTICLE_FIELDS, ParticleState
from substrata_tpu_torch.physics.solver import SolverCache
from substrata_tpu_torch.physics.terrain import TerrainField
from substrata_tpu_torch.physics.state import (BODY_FIELDS, SIM_PARAM_FIELDS,
                                               BodyState, Heightfield, HullLibrary,
                                               SimParams, StaticWorld, TriMesh,
                                               empty_hull_library, empty_trimesh)
from substrata_tpu_torch.physics.vehicles.manager import (INPUT_FIELDS, VEHICLE_FIELDS,
                                                          VehicleArrays, VehicleInputs)

Arrays = Mapping[str, np.ndarray]


def _t(x, device):
    return torch.as_tensor(np.array(x, copy=True), device=device)


def body_state_from_numpy(arrays: Arrays, *, device) -> BodyState:
    """``arrays`` holds the 23 BodyState fields by name."""
    return BodyState(**{f: _t(arrays[f], device) for f in BODY_FIELDS})


def hull_library_from_numpy(arrays: Arrays, *, device) -> HullLibrary:
    """Keys: verts, n_verts, planes, n_faces."""
    return HullLibrary(verts=_t(np.asarray(arrays["verts"], np.float32), device),
                       n_verts=_t(np.asarray(arrays["n_verts"], np.int32), device),
                       planes=_t(np.asarray(arrays["planes"], np.float32), device),
                       n_faces=_t(np.asarray(arrays["n_faces"], np.int32), device))


def trimesh_from_numpy(arrays: Arrays, *, device) -> TriMesh:
    """Keys: the TriMesh fields verts, tris, tri_mats, tri_owner, cell_tris,
    origin, cell_w and n_tris (the reference's own grid, converted as is)."""
    f32 = ("verts", "origin", "cell_w")
    fields = {f: _t(np.asarray(arrays[f], np.float32 if f in f32 else np.int32), device)
              for f in ("verts", "tris", "tri_mats", "tri_owner", "cell_tris", "origin",
                        "cell_w", "n_tris")}
    return TriMesh(**fields, count=int(np.asarray(arrays["n_tris"])))


def static_world_from_numpy(arrays: Arrays, *, device) -> StaticWorld:
    """Keys: heights, origin, cell_w, is_flat, has_heightfield, water_z, and
    optionally trimesh and hulls (mappings for ``trimesh_from_numpy`` and
    ``hull_library_from_numpy``; absent = empty)."""
    hf = Heightfield(heights=_t(np.asarray(arrays["heights"], np.float32), device),
                     origin=_t(np.asarray(arrays["origin"], np.float32), device),
                     cell_w=_t(np.asarray(arrays["cell_w"], np.float32), device),
                     is_flat=bool(arrays["is_flat"]))
    tm = (trimesh_from_numpy(arrays["trimesh"], device=device) if "trimesh" in arrays
          else empty_trimesh(device=device))
    hulls = (hull_library_from_numpy(arrays["hulls"], device=device) if "hulls" in arrays
             else empty_hull_library(device=device))
    return StaticWorld(heightfield=hf,
                       has_heightfield=_t(np.asarray(arrays["has_heightfield"], bool), device),
                       trimesh=tm, hulls=hulls,
                       water_z=_t(np.asarray(arrays["water_z"], np.float32), device))


def character_from_numpy(arrays: Arrays, *, device) -> CharacterState:
    """``arrays`` holds the 9 CharacterState fields by name."""
    return CharacterState(**{f: _t(arrays[f], device) for f in CHARACTER_FIELDS})


def sim_params_from_numpy(arrays: Arrays, *, device) -> SimParams:
    return SimParams(**{f: _t(np.asarray(arrays[f], np.float32), device)
                        for f in SIM_PARAM_FIELDS})


def solver_cache_from_numpy(data: np.ndarray, *, device) -> SolverCache:
    """``data``: the reference cache's [H, 5] f32 rows."""
    return SolverCache(data=_t(np.asarray(data, np.float32), device))


def pair_cache_from_numpy(arrays: Arrays, *, device) -> PairCache:
    return PairCache(**{f.name: _t(arrays[f.name], device)
                        for f in dataclasses.fields(PairCache)})


def sources_from_numpy(arrays: Arrays, *, device) -> SourceState:
    """``arrays`` holds the 26 SourceState fields by name."""
    return SourceState(**{f: _t(arrays[f], device) for f in SOURCE_FIELDS})


def listener_from_numpy(arrays: Arrays, *, device) -> Listener:
    return Listener(**{f: _t(np.asarray(arrays[f], np.float32), device)
                       for f in LISTENER_FIELDS})


def room_from_numpy(arrays: Arrays, *, device) -> RoomState:
    return RoomState(**{f: _t(arrays[f], device) for f in ROOM_FIELDS})


def particles_from_numpy(arrays: Arrays, *, device) -> ParticleState:
    """``arrays`` holds the 13 ParticleState fields by name."""
    return ParticleState(**{f: _t(arrays[f], device) for f in PARTICLE_FIELDS})


def vehicles_from_numpy(arrays: Arrays, *, device) -> VehicleArrays:
    """``arrays`` holds the 36 VehicleArrays fields by name."""
    return VehicleArrays(**{f: _t(arrays[f], device) for f in VEHICLE_FIELDS})


def vehicle_inputs_from_numpy(arrays: Arrays, *, device) -> VehicleInputs:
    """``arrays`` holds forward, right, up, brake and handbrake."""
    return VehicleInputs(**{f: _t(arrays[f], device) for f in INPUT_FIELDS})


def clip_bank_from_numpy(skeleton, arrays: Arrays, names, *, device) -> ClipBank:
    """A ClipBank from the reference bank's packed arrays: ``arrays`` holds
    rot [C * F, J * 4], trans [C * F, J * 3], n_frames [C] and looping [C];
    ``names`` the clip names in bank order."""
    bank = ClipBank.__new__(ClipBank)
    bank.skeleton = skeleton
    bank.names = list(names)
    bank.index = {n: i for i, n in enumerate(bank.names)}
    bank.n_frames_host = np.asarray(arrays["n_frames"], np.float32).copy()
    bank.f_cap = np.asarray(arrays["rot"]).shape[0] // len(bank.names)
    bank.rot = _t(np.asarray(arrays["rot"], np.float32), device)
    bank.trans = _t(np.asarray(arrays["trans"], np.float32), device)
    bank.n_frames = _t(bank.n_frames_host, device)
    bank.looping = _t(np.asarray(arrays["looping"], bool), device)
    bank.durations = {n: float(f) / CLIP_RATE for n, f in zip(bank.names, bank.n_frames_host)}
    return bank


def pose_params_from_numpy(arrays: Arrays, *, device) -> PoseParams:
    """``arrays`` holds the 12 PoseParams fields by name (one copy)."""
    return pose_params_from_arrays({k: np.asarray(v) for k, v in arrays.items()},
                                   device=device)


def terrain_field_from_numpy(heights, origin, cell_w, *, device) -> TerrainField:
    """The terrain's heightfield (the reference TerrainSystem's Heightfield
    fields heights, origin, cell_w)."""
    return TerrainField(heights=_t(np.asarray(heights, np.float32), device),
                        origin=_t(np.asarray(origin, np.float32), device),
                        cell_w=_t(np.float32(cell_w), device))


def to_numpy(obj) -> dict:
    """Dataclass of tensors -> {field: numpy array} (nested dataclasses
    flatten with a ``parent.child`` key)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": x for k, x in to_numpy(v).items()})
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy()
        else:
            out[f.name] = np.asarray(v)
    return out
