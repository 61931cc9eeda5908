"""The physics step: forces -> broadphase -> narrowphase -> contact solve ->
integrate -> position solve -> sleeping.

Counterpart of ``substrata_tpu/physics/step.py:physics_step``.  The
broadphase rebuild/reuse choice is a plain Python ``if`` on the host's
``rebuild_pairs``; nothing in the step reads a device value back.
"""

from __future__ import annotations

import dataclasses

import torch

from substrata_tpu_torch.physics import broadphase, integrate, narrowphase, solver
from substrata_tpu_torch.physics.state import (BodyState, SimConfig, SimParams,
                                               StaticWorld, _Replace)


@dataclasses.dataclass
class StepEvents(_Replace):
    """Per-tick host-visible events."""

    contact_pair_a: torch.Tensor    # [P] i32
    contact_pair_b: torch.Tensor    # [P] i32
    contact_touching: torch.Tensor  # [P] bool
    newly_awake: torch.Tensor       # [N] bool
    newly_asleep: torch.Tensor      # [N] bool
    entered_water: torch.Tensor     # [N] bool
    num_pairs: torch.Tensor         # [] i32
    broadphase_overflow: torch.Tensor  # [] i32


@dataclasses.dataclass
class StepDiagnostics(_Replace):
    num_pairs: torch.Tensor
    num_contacts: torch.Tensor
    num_awake: torch.Tensor
    max_penetration: torch.Tensor


def physics_step(body: BodyState, world: StaticWorld, dt: float, params: SimParams,
                 config: SimConfig, solver_cache: solver.SolverCache,
                 pair_cache: broadphase.PairCache, rebuild_pairs: bool = True,
                 has_oversize: bool = True):
    """Advance the world one fixed substep, as ``PhysicsWorld.think`` runs
    it (warm-started solve, cached pair list).

    Returns (new_body, new_solver_cache, new_pair_cache, events, diagnostics)."""
    dt = float(dt)
    prev_awake = body.awake

    # 1. External forces + buoyancy.
    linvel, angvel, in_water = integrate.apply_forces(body, dt, params)
    body = body.replace(linvel=linvel, angvel=angvel)

    # 2. Broadphase (rebuild, or reuse the last rebuild's pair list).
    (pair_a, pair_b, pair_valid, num_pairs, overflow,
     new_pair_cache) = broadphase.find_pairs_cached(
        body, pair_cache, dt, config, rebuild=rebuild_pairs,
        has_oversize=has_oversize)

    # 2b. Pre-solve strike wake: a sleeper paired with a fast awake body
    # joins this step's solve.
    n = body.capacity
    striker = body.awake & (torch.sum(body.linvel * body.linvel, -1) > 0.25)
    pa_s = torch.clamp(pair_a, min=0).long()
    pb_s = torch.clamp(pair_b, min=0).long()
    dst_a = torch.where(pair_valid & striker[pb_s], pa_s, n)
    dst_b = torch.where(pair_valid & striker[pa_s], pb_s, n)
    struck = torch.zeros((n + 1,), dtype=torch.bool, device=body.device)
    struck.index_fill_(0, dst_a, True).index_fill_(0, dst_b, True)
    body = body.replace(awake=body.awake | (struck[:n] & body.alive & body.dynamic))

    # 3. Narrowphase: body-blocked static rows; pair-blocked pair rows
    # (or the compacted buffer when the world has no shape combo).
    wm = narrowphase.blocked_manifold_width(config, n)
    pair_cts, pair_touching, bucket_overflow = narrowphase.pair_contacts(
        body, pair_a, pair_b, pair_valid, config, hulls=world.hulls, blocked_wm=wm)
    static_cts = narrowphase.static_contacts(body, world, config)
    if wm:
        contacts_p = pair_cts
        contact_overflow = torch.zeros((), dtype=torch.int32, device=body.device)
        if not rebuild_pairs:
            # Reuse steps keep the rebuild step's entry table.
            inc_table, inc_sign = pair_cache.inc_table, pair_cache.inc_sign
        else:
            n_e = pair_cts.capacity // wm
            e_a = pair_cts.a.reshape(n_e, wm)[:, 0]
            e_b = pair_cts.b.reshape(n_e, wm)[:, 0]
            inc_table, inc_sign, _ = solver.build_incidence(
                e_a, e_b, e_a >= 0, n, config.contacts_per_body)
    else:
        wm = 1
        contacts_p, contact_overflow = narrowphase.compact_contacts(
            pair_cts, config.max_active_contacts)
        inc_table = inc_sign = None

    # 4. Velocity solve.
    (linvel, angvel, lambda_p, inc_table, inc_sign, _lambda_s,
     new_cache) = solver.solve_contacts(
        body, static_cts, contacts_p, dt, params, config, solver_cache,
        wm=wm, table=inc_table, sign=inc_sign)

    # 5. Integrate + split-impulse position correction.
    pos, quat = integrate.integrate_positions(body, linvel, angvel, dt)
    pos = solver.solve_positions(pos, body, static_cts, contacts_p,
                                 inc_table, inc_sign, params, config, wm=wm)

    # 6. Sleeping (pair-driven wake; deep static penetration keeps awake).
    k_s = static_cts.capacity // n
    deep_static = torch.any(
        (static_cts.valid & (static_cts.penetration > 0.1)).reshape(n, k_s), dim=1)
    n_e = contacts_p.capacity // wm
    row_valid = contacts_p.valid.reshape(n_e, wm)
    e_a = contacts_p.a.reshape(n_e, wm)[:, 0]
    e_b = contacts_p.b.reshape(n_e, wm)[:, 0]
    e_valid = torch.any(row_valid, dim=1)
    e_imp = torch.where(row_valid, lambda_p, 0.0).max(dim=1).values
    e_pen = torch.where(row_valid, contacts_p.penetration.reshape(n_e, wm),
                        -1e9).max(dim=1).values
    awake, sleep_timer, linvel, angvel = integrate.update_sleeping(
        body, linvel, angvel, e_a, e_b, e_imp, e_valid, inc_table, inc_sign,
        dt, params, contact_pen=e_pen, extra_deep=deep_static)

    new_body = body.replace(pos=pos, quat=quat, linvel=linvel, angvel=angvel,
                            awake=awake, sleep_timer=sleep_timer,
                            underwater=in_water)
    events = StepEvents(
        contact_pair_a=pair_a, contact_pair_b=pair_b,
        contact_touching=pair_touching,
        newly_awake=awake & ~prev_awake, newly_asleep=prev_awake & ~awake,
        entered_water=in_water & ~body.underwater, num_pairs=num_pairs,
        broadphase_overflow=(overflow + bucket_overflow + contact_overflow).to(torch.int32),
    )
    diags = StepDiagnostics(
        num_pairs=num_pairs,
        num_contacts=(contacts_p.valid.sum() + static_cts.valid.sum()).to(torch.int32),
        num_awake=(awake & new_body.alive).sum().to(torch.int32),
        max_penetration=torch.maximum(
            torch.where(contacts_p.valid, contacts_p.penetration, 0.0).max(),
            torch.where(static_cts.valid, static_cts.penetration, 0.0).max()),
    )
    # Only FAST wakes force a pair rebuild (slow ones stay inside the
    # rebuild's 8 cm base margin for the rest of the window).
    woke_speed = torch.where(events.newly_awake,
                             torch.sqrt(torch.sum(linvel * linvel, -1)), 0.0)
    fast_wake = woke_speed.max() > 1.0
    new_pair_cache = new_pair_cache.replace(
        steps_left=torch.where(fast_wake, 0, new_pair_cache.steps_left).to(torch.int32),
        inc_table=inc_table, inc_sign=inc_sign)
    return new_body, new_cache, new_pair_cache, events, diags
