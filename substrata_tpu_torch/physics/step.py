"""The physics step: forces -> broadphase -> narrowphase -> contact solve ->
integrate -> position solve -> sleeping.

Counterpart of ``substrata_tpu/physics/step.py:physics_step``.  The
broadphase rebuild/reuse choice is a plain Python ``if`` on the host's
``rebuild_pairs``; nothing in the step reads a device value back.  On the
card each stage is a hand-written kernel: KD, KP + KS, KV's strike wake,
KA/KK/KO (grouped by KT) and KB, KT's compaction and incidence, KQ, KC,
KU and KV's sleep pass.  Between them a few plain torch ops remain: the
concatenation of a mixed world's bucket rows, the blocked layout's entry
ids, and the events' and diagnostics' reductions below.
"""

from __future__ import annotations

import dataclasses

import torch

from substrata_tpu_torch.kernels import sleep
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

    Returns (new_body, new_solver_cache, new_pair_cache, events, diagnostics).
    The step runs inside a ``physics_step`` profiler range, so a trace can
    attribute its device work."""
    with torch.profiler.record_function("physics_step"):
        return _physics_step(body, world, dt, params, config, solver_cache, pair_cache,
                             rebuild_pairs, has_oversize)


def _physics_step(body, world, dt, params, config, solver_cache, pair_cache, rebuild_pairs,
                  has_oversize):
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
    body = body.replace(awake=sleep.strike_wake(body.awake, body.linvel, body.alive,
                                                body.motion_type, pair_a, pair_b, pair_valid))

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

    # 6. Sleeping (pair-driven wake; deep static penetration keeps awake),
    # and the fast-wake rebuild: only FAST wakes force a pair rebuild (slow
    # ones stay inside the rebuild's 8 cm base margin for the rest of the
    # window).
    slept = sleep.sleep_pass(
        body, prev_awake, linvel, angvel, (static_cts.valid, static_cts.penetration),
        (contacts_p.a, contacts_p.b, contacts_p.valid, contacts_p.penetration), lambda_p,
        inc_table, inc_sign, wm, dt, params, new_pair_cache.steps_left)
    awake, sleep_timer, linvel, angvel = slept.awake, slept.sleep_timer, slept.linvel, slept.angvel

    new_body = body.replace(pos=pos, quat=quat, linvel=linvel, angvel=angvel,
                            awake=awake, sleep_timer=sleep_timer,
                            underwater=in_water)
    events = StepEvents(
        contact_pair_a=pair_a, contact_pair_b=pair_b,
        contact_touching=pair_touching,
        newly_awake=slept.newly_awake, newly_asleep=slept.newly_asleep,
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
    new_pair_cache = new_pair_cache.replace(steps_left=slept.steps_left,
                                            inc_table=inc_table, inc_sign=inc_sign)
    return new_body, new_cache, new_pair_cache, events, diags
