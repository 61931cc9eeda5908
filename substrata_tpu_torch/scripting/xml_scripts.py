"""XML object-script parsing.

A copy of ``substrata_tpu/scripting/xml_scripts.py``: importing any module of the
reference package loads jax, so the port keeps its own.

parseXMLScript parity (gui_client/Scripting.cpp:138-330): a WorldObject's
`script` field holds XML like

    <?xml version="1.0"?>
    <script>
      <follow_path>
        <speed>5</speed>
        <orient_along_path/>
        <follow_ob_uid>12</follow_ob_uid>
        <follow_dist>3.0</follow_dist>
        <waypoint><pos>0 0 1</pos><type>Station</type><pause_time>2</pause_time></waypoint>
        <waypoint><pos>10 0 1</pos><type>CurveIn</type><speed>8</speed></waypoint>
        ...
      </follow_path>
      <hover_car> ... </hover_car> / <car> / <bike> / <boat>
    </script>

returning (path_controller_spec, vehicle_settings).  Vehicle elements map
to physics.vehicles.VehicleSettings fields (CarScriptSettings etc.,
Scripting.h:52-195), including seat settings.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from substrata_tpu_torch.physics.vehicles import (
    VEHICLE_BIKE, VEHICLE_BOAT, VEHICLE_CAR, VEHICLE_HOVER, VehicleSettings,
)
from substrata_tpu_torch.scripting.path_controller import (
    WAYPOINT_CURVE_IN, WAYPOINT_CURVE_OUT, WAYPOINT_STATION,
)

_WTYPE = {"CurveIn": WAYPOINT_CURVE_IN, "CurveOut": WAYPOINT_CURVE_OUT,
          "Station": WAYPOINT_STATION}


def _vec3(text: str):
    return np.array([float(x) for x in text.replace(",", " ").split()], np.float64)


def _child_f(elem, name, default):
    c = elem.find(name)
    return float(c.text) if c is not None and c.text else default


def parse_xml_script(src: str):
    """Returns dict with optional keys 'follow_path' (waypoint spec list +
    options) and 'vehicle' (VehicleSettings)."""
    out = {}
    if not src or "<" not in src:
        return out
    root = ET.fromstring(src)
    if root.tag != "script":
        # Allow a document with <?xml?> prolog where root is script anyway.
        raise ValueError("script XML root must be <script>")

    fp = root.find("follow_path")
    if fp is not None:
        default_speed = _child_f(fp, "speed", 10.0)
        waypoints = []
        for we in fp.findall("waypoint"):
            wp = {
                "pos": _vec3(we.find("pos").text),
                "type": _WTYPE[we.find("type").text.strip()],
                "pause_time": _child_f(we, "pause_time", 10.0),
                "speed": _child_f(we, "speed", default_speed),
            }
            waypoints.append(wp)
        out["follow_path"] = {
            "waypoints": waypoints,
            "orient_along_path": fp.find("orient_along_path") is not None,
            "follow_ob_uid": int(_child_f(fp, "follow_ob_uid", 0)),
            "follow_dist": _child_f(fp, "follow_dist", 0.0),
        }

    for tag, vtype in (("car", VEHICLE_CAR), ("bike", VEHICLE_BIKE),
                       ("boat", VEHICLE_BOAT), ("hover_car", VEHICLE_HOVER),
                       ("hovercar", VEHICLE_HOVER)):
        ve = root.find(tag)
        if ve is None:
            continue
        s = VehicleSettings(vehicle_type=vtype)
        rot = ve.find("model_to_y_forwards_rot")
        if rot is not None and rot.text:
            q = np.array([float(x) for x in rot.text.split()], np.float32)
            s.model_to_y_forwards_rot = q / max(np.linalg.norm(q), 1e-9)
        # Car/bike wheel + suspension params (CarScriptSettings:149-177).
        s.wheel_radius = _child_f(ve, "front_wheel_radius",
                                  _child_f(ve, "wheel_radius", s.wheel_radius))
        s.suspension_min_length = _child_f(ve, "front_suspension_min_length",
                                           s.suspension_min_length)
        s.suspension_max_length = _child_f(ve, "front_suspension_max_length",
                                           s.suspension_max_length)
        s.suspension_spring_freq = _child_f(ve, "front_suspension_spring_freq",
                                            s.suspension_spring_freq)
        s.suspension_spring_damping = _child_f(ve, "front_suspension_spring_damping",
                                               s.suspension_spring_damping)
        s.max_steering_angle = _child_f(ve, "max_steering_angle", s.max_steering_angle)
        s.engine_max_torque = _child_f(ve, "engine_max_torque", s.engine_max_torque)
        s.max_brake_torque = _child_f(ve, "max_brake_torque", s.max_brake_torque)
        s.max_handbrake_torque = _child_f(ve, "max_handbrake_torque",
                                          s.max_handbrake_torque)
        s.longitudinal_friction_factor = _child_f(ve, "longitudinal_friction_factor",
                                                  s.longitudinal_friction_factor)
        s.lateral_friction_factor = _child_f(ve, "lateral_friction_factor",
                                             s.lateral_friction_factor)
        wheels = ve.findall("wheel_pos")
        if wheels:
            wa = np.zeros((4, 3), np.float32)
            for i, w in enumerate(wheels[:4]):
                wa[i] = _vec3(w.text).astype(np.float32)
            s.wheel_attach_os = wa
        # Boat params (BoatScriptSettings:97-120).
        s.thrust_force = _child_f(ve, "thrust_force", s.thrust_force)
        pp = ve.find("propellor_point_os")
        if pp is not None and pp.text:
            s.propellor_point_os = _vec3(pp.text).astype(np.float32)
        s.rudder_deflection_force_factor = _child_f(
            ve, "rudder_deflection_force_factor", s.rudder_deflection_force_factor)
        s.thrust_vector_lateral_amount = _child_f(
            ve, "thrust_vector_lateral_amount", s.thrust_vector_lateral_amount)
        s.front_cross_sectional_area = _child_f(ve, "front_cross_sectional_area",
                                                s.front_cross_sectional_area)
        s.side_cross_sectional_area = _child_f(ve, "side_cross_sectional_area",
                                               s.side_cross_sectional_area)
        s.top_cross_sectional_area = _child_f(ve, "top_cross_sectional_area",
                                              s.top_cross_sectional_area)
        # Seats (SeatSettings, Scripting.h:23-50).
        seats = []
        for se in ve.findall("seat"):
            pe = se.find("seat_position")
            seats.append({
                "seat_position": _vec3(pe.text).astype(np.float32) if pe is not None
                else np.zeros(3, np.float32),
                "upper_body_rot_angle": _child_f(se, "upper_body_rot_angle", 0.4),
                "upper_leg_rot_angle": _child_f(se, "upper_leg_rot_angle", 1.3),
                "lower_leg_rot_angle": _child_f(se, "lower_leg_rot_angle", -0.5),
                "arm_down_angle": _child_f(se, "arm_down_angle", 2.7),
                "arm_out_angle": _child_f(se, "arm_out_angle", 0.2),
            })
        out["vehicle"] = s
        out["seats"] = seats
        break
    return out
