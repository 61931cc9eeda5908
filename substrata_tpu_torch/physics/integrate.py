"""Forces, integration and sleeping.

Counterpart of ``substrata_tpu/physics/integrate.py``.  ``apply_forces``
and ``integrate_positions`` are the Triton kernel KD
(``kernels/integrate_triton.py``, plain twins beside them);
``update_sleeping`` is plain torch.
"""

from __future__ import annotations

import torch

from substrata_tpu_torch.kernels.integrate_triton import (  # noqa: F401
    apply_forces, apply_forces_plain, integrate_positions,
    integrate_positions_plain,
)
from substrata_tpu_torch.physics.state import BodyState, MotionType, SimParams


def update_sleeping(body: BodyState, linvel, angvel, contact_a, contact_b,
                    contact_impulse, contact_valid, incidence_table,
                    incidence_sign, dt, params: SimParams,
                    contact_pen=None, extra_deep=None):
    """Velocity-threshold sleeping with contact-driven waking through the
    per-body incidence table.  Returns (awake, sleep_timer, linvel, angvel)."""
    lin2 = torch.sum(linvel * linvel, -1)
    ang2 = torch.sum(angvel * angvel, -1)
    slow = (lin2 < params.sleep_lin_vel ** 2) & (ang2 < params.sleep_ang_vel ** 2)
    # Woken by an impulse from an ACTIVE (awake, above threshold)
    # counterpart, or by touching an awake fast one.
    fast = body.awake & ((lin2 > 4.0 * params.sleep_lin_vel ** 2)
                         | (ang2 > 4.0 * params.sleep_ang_vel ** 2))
    active = body.awake & ~slow
    imp_sig = contact_valid & (contact_impulse > 1e-4)
    tbl = torch.clamp(incidence_table, min=0).long()
    tbl_ok = incidence_table >= 0
    iam_a = incidence_sign > 0
    deep = (contact_valid & (contact_pen > 0.1) if contact_pen is not None
            else torch.zeros_like(contact_valid))
    other = torch.where(iam_a, contact_b[tbl], contact_a[tbl])
    other_static = other < 0
    oth = torch.clamp(other, min=0).long()
    other_active = torch.where(other_static, False, active[oth])
    other_fast = torch.where(other_static, False, fast[oth])
    slot_wake = tbl_ok & ((imp_sig[tbl] & other_active)
                          | (contact_valid[tbl] & other_fast))
    wake_hit = torch.any(slot_wake, dim=1)
    # A deeply penetrating body must not sleep: depenetration keeps working.
    body_deep = torch.any(tbl_ok & deep[tbl], dim=1)
    if extra_deep is not None:
        body_deep = body_deep | extra_deep

    dyn = body.dynamic & body.alive
    timer = torch.where(slow & ~wake_hit & ~body_deep, body.sleep_timer + dt, 0.0)
    asleep = dyn & (timer > params.sleep_time)
    woken = dyn & ~body.awake & wake_hit
    awake = torch.where(dyn, (~asleep) & (body.awake | woken), body.awake)
    kin = body.alive & (body.motion_type == int(MotionType.KINEMATIC))
    awake = torch.where(kin, (lin2 + ang2) > 1e-10, awake)
    sleeping = (dyn & ~awake)[:, None]
    linvel = torch.where(sleeping, 0.0, linvel)
    angvel = torch.where(sleeping, 0.0, angvel)
    return awake, timer, linvel, angvel
