"""Snapshot rings, interpolation, dejitter and physics-ownership logic.

A copy of ``substrata_tpu/net/snapshots.py``: importing any module of the
reference package loads jax, so the port keeps its own.

Batched (SoA) re-implementation of the reference's per-object snapshot
machinery so one tick processes every remote object at once:

- 4-entry snapshot ring per object (shared/WorldObject.h:542-564,
  HISTORY_BUF_SIZE = 4), entries {pos, rot quat, linvel, angvel,
  client_time, local_time}.
- getInterpolatedTransform (shared/WorldObject.cpp:460-496): render at
  cur_time - send_period*2 with send_period = 0.1 s; bracketing snapshots
  lerped (pos) / slerped (rot).
- Physics-snapshot dejitter playback (gui_client/GUIClient.cpp:7459-7489):
  insert snapshot i when global_time >= client_time +
  transmission_time_offset + padding (0.1 s); on insertion compute
  smoothing deltas smooth_translation/rotation = old_effective - snapshot,
  decayed per tick by factor (1 - 3*min(0.1, dt))
  (GUIClient.cpp:6634-6638; semantics PhysicsObject.h:93-105).
- Ownership arbitration (docs/networked physics.txt:64-187 +
  GUIClient.cpp:10636-10656): ownership valid for 10 s, renewal at half
  period, conflicting claims resolved by earliest timestamp.
- Snapshot-starved objects deactivate after 1 s (GUIClient.cpp:7439-7441).
"""

from __future__ import annotations

import numpy as np

HISTORY_BUF_SIZE = 4
SEND_PERIOD = 0.1                 # WorldObject.cpp:495
INTERP_DELAY = 2.0 * SEND_PERIOD  # WorldObject.cpp:496
PADDING_DELAY = 0.1               # GUIClient.cpp:7462
OWNERSHIP_PERIOD = 10.0           # GUIClient.cpp:10636
SNAPSHOT_STARVE_DEACTIVATE = 1.0  # GUIClient.cpp:7440-7441


def _slerp(a, b, t):
    """Batched quaternion slerp, shortest path; a, b: [N, 4], t: [N]."""
    d = np.sum(a * b, axis=-1, keepdims=True)
    b = np.where(d < 0, -b, b)
    d = np.clip(np.abs(d), -1.0, 1.0)
    theta = np.arccos(d)
    st = np.sin(theta)
    t = t[:, None]
    small = st < 1e-5
    wa = np.where(small, 1 - t, np.sin((1 - t) * theta) / np.where(small, 1, st))
    wb = np.where(small, t, np.sin(t * theta) / np.where(small, 1, st))
    q = wa * a + wb * b
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-9)


class SnapshotRings:
    """SoA snapshot rings for up to N replicated objects."""

    def __init__(self, capacity: int):
        n, h = capacity, HISTORY_BUF_SIZE
        self.pos = np.zeros((n, h, 3), np.float32)
        self.rot = np.zeros((n, h, 4), np.float32)
        self.rot[:, :, 3] = 1.0
        self.linvel = np.zeros((n, h, 3), np.float32)
        self.angvel = np.zeros((n, h, 3), np.float32)
        self.client_time = np.zeros((n, h), np.float64)
        self.local_time = np.zeros((n, h), np.float64)
        self.next_i = np.zeros(n, np.int64)           # next write index (pre-modulo)
        self.next_insertable_i = np.zeros(n, np.int64)  # physics playback cursor
        self.transmission_time_offset = np.zeros(n, np.float64)
        self.is_physics = np.zeros(n, bool)           # snapshots_are_physics_snapshots
        # Smoothing state (PhysicsObject.h:93-105).
        self.smooth_translation = np.zeros((n, 3), np.float32)
        self.smooth_rotation = np.zeros((n, 4), np.float32)
        self.smooth_rotation[:, 3] = 1.0
        # Slots with non-identity smoothing: decay touches only these
        # (decaying the full N-row ring cost ~2 ms/tick at 12k objects).
        self._smooth_active: set = set()
        self.last_snapshot_local_time = np.full(n, -1e18, np.float64)

    def insert_snapshot(self, idx: int, pos, rot, linvel, angvel,
                        client_time: float, local_time: float,
                        physics: bool = True):
        """Append one received snapshot (ClientThread applying
        ObjectPhysicsTransformUpdate / ObjectTransformUpdate)."""
        slot = int(self.next_i[idx] % HISTORY_BUF_SIZE)
        self.pos[idx, slot] = pos
        self.rot[idx, slot] = rot
        self.linvel[idx, slot] = linvel
        self.angvel[idx, slot] = angvel
        self.client_time[idx, slot] = client_time
        self.local_time[idx, slot] = local_time
        self.next_i[idx] += 1
        self.is_physics[idx] = physics
        self.last_snapshot_local_time[idx] = local_time
        # Playback cursor never lags more than the ring size.
        self.next_insertable_i[idx] = max(self.next_insertable_i[idx],
                                          self.next_i[idx] - HISTORY_BUF_SIZE)

    def set_transmission_time_offset(self, idx: int, offset: float):
        """Computed on ownership receipt (docs/networked physics.txt:42-55):
        offset = local(=global) receipt time - snapshot client time, so the
        dejittered insert time is client_time + offset + padding."""
        self.transmission_time_offset[idx] = offset

    # ------------------------------------------------------------------
    # Interpolated playback (non-physics objects)
    # ------------------------------------------------------------------
    def interpolated_transforms(self, indices: np.ndarray, cur_time: float):
        """Vectorised getInterpolatedTransform (WorldObject.cpp:460-496) for
        a batch of object indices.  Returns (pos [K,3], rot [K,4])."""
        k = len(indices)
        if k == 0:
            return (np.zeros((0, 3), np.float32), np.zeros((0, 4), np.float32))
        t = cur_time - INTERP_DELAY
        lt = self.local_time[indices]              # [K, H]
        ni = self.next_i[indices]
        # Walk the ring newest->oldest to find the bracketing pair.
        best_lo = np.full(k, -1, np.int64)
        best_hi = np.full(k, -1, np.int64)
        for back in range(HISTORY_BUF_SIZE - 1):
            hi_i = (ni - 1 - back) % HISTORY_BUF_SIZE
            lo_i = (ni - 2 - back) % HISTORY_BUF_SIZE
            valid = (ni - 2 - back) >= 0
            hi_t = lt[np.arange(k), hi_i]
            lo_t = lt[np.arange(k), lo_i]
            hit = valid & (lo_t <= t) & (t <= hi_t) & (best_lo < 0)
            best_lo = np.where(hit, lo_i, best_lo)
            best_hi = np.where(hit, hi_i, best_hi)
        # Fallbacks: before oldest -> clamp to oldest; after newest -> newest.
        newest = (ni - 1) % HISTORY_BUF_SIZE
        oldest = np.where(ni >= HISTORY_BUF_SIZE, ni % HISTORY_BUF_SIZE, 0)
        newest_t = lt[np.arange(k), newest]
        after = t >= newest_t
        none = best_lo < 0
        best_lo = np.where(none, np.where(after, newest, oldest), best_lo)
        best_hi = np.where(none, np.where(after, newest, oldest), best_hi)

        ar = np.arange(k)
        p0 = self.pos[indices, best_lo]
        p1 = self.pos[indices, best_hi]
        t0 = lt[ar, best_lo]
        t1 = lt[ar, best_hi]
        frac = np.where(t1 > t0, (t - t0) / np.maximum(t1 - t0, 1e-9), 0.0)
        frac = np.clip(frac, 0.0, 1.0).astype(np.float32)
        pos = p0 + (p1 - p0) * frac[:, None]
        rot = _slerp(self.rot[indices, best_lo], self.rot[indices, best_hi], frac)
        return pos, rot

    # ------------------------------------------------------------------
    # Physics-snapshot dejittered playback
    # ------------------------------------------------------------------
    def due_physics_snapshots(self, indices: np.ndarray, global_time: float):
        """For each object, the next unplayed physics snapshot whose
        dejittered play time has arrived (GUIClient.cpp:7459-7489).

        Returns (mask [K], pos, rot, linvel, angvel) for due objects; also
        advances the playback cursor for them.
        """
        k = len(indices)
        if k == 0:
            z = np.zeros((0, 3), np.float32)
            return (np.zeros(0, bool), z, np.zeros((0, 4), np.float32), z, z)
        cursor = self.next_insertable_i[indices]
        have = cursor < self.next_i[indices]
        slot = (cursor % HISTORY_BUF_SIZE).astype(np.int64)
        ct = self.client_time[indices, slot]
        play_t = ct + self.transmission_time_offset[indices] + PADDING_DELAY
        due = have & self.is_physics[indices] & (global_time >= play_t)
        self.next_insertable_i[indices] = np.where(due, cursor + 1, cursor)
        ar = np.arange(k)
        return (due, self.pos[indices, slot], self.rot[indices, slot],
                self.linvel[indices, slot], self.angvel[indices, slot])

    # ------------------------------------------------------------------
    # Smoothing (render transform = smoothing o snapshot)
    # ------------------------------------------------------------------
    def set_smoothing_from_correction(self, idx: int, old_pos, old_rot,
                                      new_pos, new_rot):
        """On snapshot insertion the visible transform must not pop:
        smoothing delta = old effective - inserted snapshot
        (GUIClient.cpp:7484-7486)."""
        self.smooth_translation[idx] = np.asarray(old_pos) - np.asarray(new_pos)
        # delta rotation old * new^-1
        n = np.asarray(new_rot, np.float32)
        o = np.asarray(old_rot, np.float32)
        n_conj = n * np.array([-1, -1, -1, 1], np.float32)
        x1, y1, z1, w1 = o
        x2, y2, z2, w2 = n_conj
        self.smooth_rotation[idx] = np.array([
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ], np.float32)
        self._smooth_active.add(int(idx))

    def set_smoothing_from_corrections(self, idx: np.ndarray, old_pos,
                                       old_rot, new_pos, new_rot):
        """Batched set_smoothing_from_correction: one vectorized call per
        playback tick instead of one Python call per due object (the
        12k-object networked tick inserts ~N_dyn/6 snapshots per tick)."""
        self.smooth_translation[idx] = np.asarray(old_pos) - np.asarray(new_pos)
        o = np.asarray(old_rot, np.float32)
        n = np.asarray(new_rot, np.float32) * np.array([-1, -1, -1, 1],
                                                       np.float32)
        x1, y1, z1, w1 = o[:, 0], o[:, 1], o[:, 2], o[:, 3]
        x2, y2, z2, w2 = n[:, 0], n[:, 1], n[:, 2], n[:, 3]
        self.smooth_rotation[idx] = np.stack([
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], axis=1).astype(np.float32)
        self._smooth_active.update(int(i) for i in np.asarray(idx))

    def decay_smoothing(self, dt: float):
        """smooth_change_factor = 1 - 3*min(0.1, dt) per tick
        (GUIClient.cpp:6634-6638).  Only slots with live smoothing decay
        (decaying the full N-row ring cost ~2 ms/tick at 12k objects);
        fully-decayed slots snap to identity and leave the active set.
        All writes are IN PLACE so per-object row views stay valid."""
        if not self._smooth_active:
            return
        act = np.fromiter(self._smooth_active, np.int64,
                          len(self._smooth_active))
        f = 1.0 - 3.0 * min(0.1, dt)
        st = self.smooth_translation[act] * f
        self.smooth_translation[act] = st
        # Rotation decays toward identity by nlerp.
        ident = np.array([0, 0, 0, 1], np.float32)
        q = self.smooth_rotation[act]
        q = np.where(q[:, 3:4] < 0, -q, q)
        q = q * f + ident * (1 - f)
        q /= np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-9)
        self.smooth_rotation[act] = q
        done = ((np.abs(st).max(axis=1) < 1e-4)
                & (np.abs(q - ident).max(axis=1) < 1e-4))
        if done.any():
            for s in act[done]:
                self.smooth_translation[s] = 0.0
                self.smooth_rotation[s] = ident
                self._smooth_active.discard(int(s))

    def starved(self, indices: np.ndarray, local_time: float) -> np.ndarray:
        """Objects with no snapshot for 1 s should deactivate."""
        return (local_time - self.last_snapshot_local_time[indices]) > SNAPSHOT_STARVE_DEACTIVATE


class PhysicsOwnership:
    """Timestamp-arbitrated physics ownership (docs/networked
    physics.txt:64-187; WorldObject physics_owner_id +
    last_physics_ownership_change_global_time)."""

    def __init__(self, capacity: int):
        self.owner_id = np.full(capacity, 0, np.uint32)  # 0 = no owner
        self.change_time = np.full(capacity, -1e18, np.float64)

    def is_free(self, idx: int, global_time: float) -> bool:
        """Unowned, or the owner's claim expired (10 s)."""
        return (self.owner_id[idx] == 0
                or (global_time - self.change_time[idx]) > OWNERSHIP_PERIOD)

    def owned_by(self, idx: int, avatar_uid: int, global_time: float) -> bool:
        return (self.owner_id[idx] == avatar_uid
                and (global_time - self.change_time[idx]) <= OWNERSHIP_PERIOD)

    def needs_renewal(self, idx: int, global_time: float) -> bool:
        """Renew at half-period (docs:64-67)."""
        return (global_time - self.change_time[idx]) > OWNERSHIP_PERIOD * 0.5

    def try_claim(self, idx: int, avatar_uid: int, global_time: float) -> bool:
        if self.is_free(idx, global_time) or self.owner_id[idx] == avatar_uid:
            self.owner_id[idx] = avatar_uid
            self.change_time[idx] = global_time
            return True
        return False

    def apply_remote_claim(self, idx: int, avatar_uid: int, claim_time: float):
        """Conflicting claims resolved by earliest timestamp (docs:148-187):
        accept the remote claim if it is earlier than ours, or ours expired."""
        if (self.owner_id[idx] == 0
                or claim_time < self.change_time[idx]
                or (claim_time - self.change_time[idx]) > OWNERSHIP_PERIOD):
            self.owner_id[idx] = avatar_uid
            self.change_time[idx] = claim_time

    def release(self, idx: int):
        self.owner_id[idx] = 0
        self.change_time[idx] = -1e18
