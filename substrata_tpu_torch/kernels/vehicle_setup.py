"""KAB: the vehicles' pre-ray setup and chassis velocity scatter, and their
plain twins.

Replace the setup of the device program
``substrata_tpu/physics/vehicles/manager.py:vehicles_update`` (:598-630:
each vehicle's chassis state, mass and world inverse inertia, its up axis
and its four suspension rays) and the scatter ``_apply_vehicle_deltas``
(:664-673) with two launches of ``csrc/vehicle_setup.cu``.

``vehicle_setup`` returns ONE float32 buffer of 55 * V words, field by
field, so that KH and KJ read contiguous views of it (``setup_views``):
the chassis (pos, quat, linvel, angvel, mass, inverse inertia: 23 words a
vehicle) and the rays (origins, dirs, max_ts and the excluded body as
int32 bits: 28 + 4 words a vehicle).  ``vehicle_scatter`` adds the deltas
to the chassis rows in place and wakes them; a vehicle without a body
(slot -1) writes nothing.  It assumes unique slots, as one controller per
body gives: the twin (``index_add_``) sums the deltas of duplicate slots
as the reference does, the kernel's threads would race on the row.

Each wrapper runs its ``*_plain`` twin for CPU tensors; for CUDA tensors
it launches the kernel or raises.  The arithmetic is maths/quat.py's and
maths/transform.py's, unfused, in the same order, so the kernel and its
twin agree to the bit.
"""

from __future__ import annotations

import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.maths import quat as quatm
from substrata_tpu_torch.maths import transform as tmath

launches = {"vehicle_setup": 0, "vehicle_scatter": 0}

WHEELS = 4
# (name, words per vehicle, shape after V) in buffer order.
LAYOUT = (("pos", 3, (3,)), ("quat", 4, (4,)), ("linvel", 3, (3,)), ("angvel", 3, (3,)),
          ("mass", 1, ()), ("iw", 9, (3, 3)), ("origins", 12, (3,)), ("dirs", 12, (3,)),
          ("max_ts", 4, ()), ("exclude", 4, ()))
WORDS = sum(n for _, n, _ in LAYOUT)     # 55

f32, i32 = torch.float32, torch.int32


def setup_views(buf: torch.Tensor, v: int) -> dict:
    """The fields of a setup buffer as contiguous views; the rays' fields
    have V * 4 rows."""
    out, off = {}, 0
    for name, n, shp in LAYOUT:
        rows = v * WHEELS if name in ("origins", "dirs", "max_ts", "exclude") else v
        seg = buf[off * v:(off + n) * v]
        out[name] = (seg.view(i32) if name == "exclude" else seg).view((rows,) + shp)
        off += n
    return out


def vehicle_setup_plain(body_slot, y_fwd_quat, wheel_attach, wheel_radius, sus_max, pos, quat,
                        linvel, angvel, inv_mass, inv_inertia):
    v = body_slot.shape[0]
    dev = pos.device
    slots = torch.clamp(body_slot, min=0).long()
    p, q = pos[slots], quat[slots]
    inv_yq = quatm.conjugate(y_fwd_quat)
    up_os = quatm.cross(quatm.rotate_vec(inv_yq, quatm.basis((v,), 0, dev)),
                        quatm.rotate_vec(inv_yq, quatm.basis((v,), 1, dev)))
    up_w = quatm.rotate_vec(q, up_os)
    attach_w = p[:, None, :] + quatm.rotate_vec(q[:, None, :], wheel_attach)
    buf = torch.empty((WORDS * v,), dtype=f32, device=dev)
    o = setup_views(buf, v)
    o["pos"].copy_(p)
    o["quat"].copy_(q)
    o["linvel"].copy_(linvel[slots])
    o["angvel"].copy_(angvel[slots])
    o["mass"].copy_(1.0 / torch.clamp(inv_mass[slots], min=1e-9))
    o["iw"].copy_(tmath.world_inv_inertia(q, inv_inertia[slots]))
    o["origins"].copy_(attach_w.reshape(v * WHEELS, 3))
    o["dirs"].copy_((-up_w)[:, None, :].expand(v, WHEELS, 3).reshape(v * WHEELS, 3))
    o["max_ts"].copy_((sus_max + wheel_radius)[:, None].expand(v, WHEELS).reshape(-1))
    o["exclude"].copy_(slots[:, None].expand(v, WHEELS).reshape(-1))
    return buf


def vehicle_setup(body_slot, y_fwd_quat, wheel_attach, wheel_radius, sus_max, pos, quat, linvel,
                  angvel, inv_mass, inv_inertia):
    """KAB's setup: ``vehicle_setup_plain`` for CPU tensors,
    ``csrc/vehicle_setup.cu`` for CUDA tensors.  Returns the setup buffer."""
    args = (body_slot, y_fwd_quat, wheel_attach, wheel_radius, sus_max, pos, quat, linvel,
            angvel, inv_mass, inv_inertia)
    if pos.device.type == "cpu":
        return vehicle_setup_plain(*args)
    dev = pos.device
    v, n = body_slot.shape[0], pos.shape[0]
    for t, name, dtype, shp in zip(
            args, ("body_slot", "y_fwd_quat", "wheel_attach", "wheel_radius", "sus_max", "pos",
                   "quat", "linvel", "angvel", "inv_mass", "inv_inertia"),
            (i32,) + (f32,) * 10,
            ((v,), (v, 4), (v, WHEELS, 3), (v,), (v,), (n, 3), (n, 4), (n, 3), (n, 3), (n,),
             (n, 3))):
        build.check(t, name, dtype, shp, dev)
    if n == 0:
        raise ValueError("vehicle_setup: the body state is empty")
    buf = torch.empty((WORDS * v,), dtype=f32, device=dev)
    build.launch("vehicle_setup", *args, v, buf)
    launches["vehicle_setup"] += 1
    return buf


def vehicle_scatter_plain(slots, dv, dw, linvel, angvel, awake, sleep_timer):
    ok = slots >= 0
    dst = slots[ok].long()
    linvel.index_add_(0, dst, dv[ok])
    angvel.index_add_(0, dst, dw[ok])
    awake[dst] = True
    sleep_timer[dst] = 0.0


def vehicle_scatter(slots, dv, dw, linvel, angvel, awake, sleep_timer):
    """KAB's scatter, in place: ``vehicle_scatter_plain`` for CPU tensors,
    ``csrc/vehicle_setup.cu`` for CUDA tensors."""
    args = (slots, dv, dw, linvel, angvel, awake, sleep_timer)
    if linvel.device.type == "cpu":
        return vehicle_scatter_plain(*args)
    dev = linvel.device
    v, n = slots.shape[0], linvel.shape[0]
    for t, name, dtype, shp in zip(
            args, ("slots", "dv", "dw", "linvel", "angvel", "awake", "sleep_timer"),
            (i32, f32, f32, f32, f32, torch.bool, f32),
            ((v,), (v, 3), (v, 3), (n, 3), (n, 3), (n,), (n,))):
        build.check(t, name, dtype, shp, dev)
    build.launch("vehicle_scatter", slots, dv, dw, v, n, linvel, angvel, awake, sleep_timer)
    launches["vehicle_scatter"] += 1
