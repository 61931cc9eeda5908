"""ObjectPathController: kinematic objects moving along user-scripted paths.

A copy of ``substrata_tpu/scripting/path_controller.py``: importing any module of the
reference package loads jax, so the port keeps its own.

Behaviour parity with gui_client/ObjectPathController.{h,cpp}: waypoints of
type CurveIn (start of circular arc), CurveOut (end of arc) and Station
(pause for pause_time seconds), per-waypoint speed, precomputed segment
geometry (arc radius/angle, entry segment), follow-object offsets, optional
orientation along the path, and kinematic MoveKinematic driving.  Path
controllers are topologically sorted so followed objects update first
(GUIClient.h path_controllers; tick ordering comment GUIClient.cpp:6384-6390).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

WAYPOINT_CURVE_IN = 0
WAYPOINT_CURVE_OUT = 1
WAYPOINT_STATION = 2


@dataclass
class PathWaypoint:
    pos: np.ndarray
    waypoint_type: int
    pause_time: float = 10.0
    speed: float = 10.0
    # Precomputed:
    segment_len: float = 0.0   # total length to next waypoint (arc or straight)
    curve_r: float = 0.0
    curve_angle: float = 0.0
    curve_center: np.ndarray = None
    curve_start_angle: float = 0.0
    curve_sign: float = 1.0


class ObjectPathController:
    def __init__(self, controlled_ob, waypoints, initial_time: float = 0.0,
                 follow_ob_uid: int = 0, follow_dist: float = 0.0,
                 orient_along_path: bool = True):
        self.controlled_ob = controlled_ob
        self.follow_ob_uid = follow_ob_uid
        self.follow_dist = follow_dist
        self.orient_along_path = orient_along_path
        self.cur_waypoint_index = 0
        self.dist_along_segment = 0.0
        self.time_along_segment = 0.0
        self.waypoints: list[PathWaypoint] = []
        for w in waypoints:
            self.waypoints.append(PathWaypoint(
                pos=np.asarray(w["pos"], np.float64),
                waypoint_type=w.get("type", WAYPOINT_STATION),
                pause_time=float(w.get("pause_time", 10.0)),
                speed=float(w.get("speed", 10.0))))
        self._precompute()
        # Fast-forward to initial_time along the path (deterministic start).
        if initial_time > 0:
            self.walk(initial_time % max(self.total_time(), 1e-6))

    # ------------------------------------------------------------------
    def _precompute(self):
        """Segment geometry: straight segments between waypoints; a
        CurveIn->CurveOut pair becomes a circular arc through the
        intermediate direction change (ObjectPathController ctor)."""
        n = len(self.waypoints)
        for i, w in enumerate(self.waypoints):
            nxt = self.waypoints[(i + 1) % n]
            if w.waypoint_type == WAYPOINT_CURVE_IN:
                prev = self.waypoints[(i - 1) % n]
                after = self.waypoints[(i + 2) % n] if n > 2 else nxt
                d_in = _unit(w.pos - prev.pos)
                d_out = _unit(after.pos - nxt.pos)
                # Arc that rotates d_in into d_out between w.pos and nxt.pos.
                chord = nxt.pos - w.pos
                chord_len = np.linalg.norm(chord)
                cosang = float(np.clip(np.dot(d_in, d_out), -1.0, 1.0))
                ang = math.acos(cosang)
                if ang < 1e-4 or chord_len < 1e-9:
                    w.segment_len = chord_len
                    w.curve_r = 0.0
                else:
                    r = chord_len / (2.0 * math.sin(ang / 2.0))
                    w.curve_r = r
                    w.curve_angle = ang
                    w.segment_len = r * ang
                    # Arc centre: offset from w.pos perpendicular to d_in,
                    # on the side d_out turns toward.
                    turn = np.cross(d_in, d_out)
                    sign = 1.0 if turn[2] >= 0 else -1.0
                    perp = np.cross(np.array([0.0, 0.0, sign]), d_in)
                    perp = _unit(perp)
                    w.curve_center = w.pos + perp * r
                    v0 = w.pos - w.curve_center
                    w.curve_start_angle = math.atan2(v0[1], v0[0])
                    w.curve_sign = sign
            else:
                w.segment_len = float(np.linalg.norm(nxt.pos - w.pos))

    def total_time(self) -> float:
        t = 0.0
        for w in self.waypoints:
            t += w.segment_len / max(w.speed, 1e-6)
            if w.waypoint_type == WAYPOINT_STATION:
                t += w.pause_time
        return t

    # ------------------------------------------------------------------
    def eval_segment_pos(self, index: int, dist: float):
        """Position + direction at `dist` along segment starting at waypoint
        index (evalSegmentCurvePos parity)."""
        w = self.waypoints[index]
        nxt = self.waypoints[(index + 1) % len(self.waypoints)]
        if w.waypoint_type == WAYPOINT_CURVE_IN and w.curve_r > 0:
            frac = dist / max(w.segment_len, 1e-9)
            # Left turns (sign=+1, centre on the left) traverse CCW: the
            # polar angle increases; right turns decrease it.
            theta = w.curve_start_angle + w.curve_sign * frac * w.curve_angle
            p = w.curve_center + w.curve_r * np.array(
                [math.cos(theta), math.sin(theta), 0.0])
            p[2] = w.pos[2] + (nxt.pos[2] - w.pos[2]) * frac
            tang = np.array([-math.sin(theta), math.cos(theta), 0.0]) * w.curve_sign
            return p, _unit(tang)
        d = _unit(nxt.pos - w.pos)
        return w.pos + d * dist, d

    def walk(self, delta_time: float):
        """walkAlongPathForTime: advance by delta_time handling stations +
        speeds, wrapping around the loop."""
        remaining = delta_time
        guard = 0
        while remaining > 1e-9 and guard < 1000:
            guard += 1
            w = self.waypoints[self.cur_waypoint_index]
            # Station pause at segment start.
            if w.waypoint_type == WAYPOINT_STATION and self.time_along_segment < w.pause_time:
                wait = min(remaining, w.pause_time - self.time_along_segment)
                self.time_along_segment += wait
                remaining -= wait
                continue
            speed = max(w.speed, 1e-6)
            seg_left = w.segment_len - self.dist_along_segment
            t_left = seg_left / speed
            if remaining < t_left:
                self.dist_along_segment += remaining * speed
                self.time_along_segment += remaining
                remaining = 0.0
            else:
                remaining -= t_left
                self.cur_waypoint_index = (self.cur_waypoint_index + 1) % len(self.waypoints)
                self.dist_along_segment = 0.0
                self.time_along_segment = 0.0

    def current_pos_dir(self):
        return self.eval_segment_pos(self.cur_waypoint_index, self.dist_along_segment)

    def update(self, physics_world, dt: float, world_state=None):
        """Advance and kinematically drive the controlled object
        (MoveKinematic; ordered before player physics in the tick,
        GUIClient.cpp:6384-6396)."""
        self.walk(dt)
        pos, dirn = self.current_pos_dir()
        if self.follow_ob_uid and world_state is not None:
            # Follow another path-controlled object at follow_dist behind.
            leader = world_state.objects.get(self.follow_ob_uid)
            if leader is not None:
                back = -dirn * self.follow_dist
                pos = pos + back
        ob = self.controlled_ob
        rot = ob.rot if hasattr(ob, "rot") else None
        if self.orient_along_path:
            heading = math.atan2(dirn[1], dirn[0])
            half = heading * 0.5
            rot = np.array([0.0, 0.0, math.sin(half), math.cos(half)], np.float32)
        phys = getattr(ob, "physics_object", None) or ob
        if hasattr(phys, "slot") and phys.slot >= 0:
            physics_world.move_kinematic_object(
                phys, pos.astype(np.float32),
                rot if rot is not None else phys.rot, dt)
        return pos, dirn

    @staticmethod
    def sort_path_controllers(controllers):
        """Topological order so followed objects update before followers
        (sortPathControllers)."""
        by_uid = {}
        for c in controllers:
            uid = getattr(c.controlled_ob, "uid", None)
            if uid is not None:
                by_uid[uid] = c
        visited = {}
        out = []

        def visit(c):
            if visited.get(id(c)) == 2:
                return
            if visited.get(id(c)) == 1:
                return  # cycle; break arbitrarily
            visited[id(c)] = 1
            leader = by_uid.get(c.follow_ob_uid)
            if leader is not None and leader is not c:
                visit(leader)
            visited[id(c)] = 2
            out.append(c)

        for c in controllers:
            visit(c)
        return out


class ObjectMoveToController:
    """moveTo/rotateTo with easing (protocol messages 3018/moveTo family;
    gui_client/ObjectMoveToController.*): smoothstep interpolation from the
    start transform to the target over a duration."""

    def __init__(self, ob, target_pos, target_rot, duration: float = 1.0):
        self.ob = ob
        self.start_pos = np.asarray(ob.pos, np.float64).copy()
        self.start_rot = np.asarray(getattr(ob, "rot", [0, 0, 0, 1]), np.float32).copy()
        self.target_pos = np.asarray(target_pos, np.float64)
        self.target_rot = np.asarray(target_rot, np.float32)
        self.duration = max(duration, 1e-6)
        self.t = 0.0

    @property
    def done(self) -> bool:
        return self.t >= self.duration

    def update(self, physics_world, dt: float):
        self.t = min(self.t + dt, self.duration)
        f = self.t / self.duration
        f = f * f * (3 - 2 * f)  # smoothstep easing
        pos = self.start_pos + (self.target_pos - self.start_pos) * f
        d = float(np.dot(self.start_rot, self.target_rot))
        tr = self.target_rot if d >= 0 else -self.target_rot
        rot = self.start_rot * (1 - f) + tr * f
        rot = rot / max(np.linalg.norm(rot), 1e-9)
        phys = getattr(self.ob, "physics_object", None) or self.ob
        if hasattr(phys, "slot") and phys.slot >= 0:
            physics_world.move_kinematic_object(phys, pos.astype(np.float32), rot, dt)
        return pos, rot


def _unit(v):
    n = np.linalg.norm(v)
    return v / n if n > 1e-12 else np.array([1.0, 0.0, 0.0])
