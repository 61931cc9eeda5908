"""Mass-splitting Jacobi contact solver with warm starting.

Counterpart of ``substrata_tpu/physics/solver.py``.  The per-step setup
(effective masses, targets, warm-start lookup) and the cache refresh go
through kernel KQ (``kernels/solve_setup.py``), every iteration and the
warm-start pre-apply through kernel KC (``kernels/solve.py``, two
launches a pass on the card, the whole solve checked and packed once); the incidence table (K5) is kernel KT
(``kernels/layout.py``) and the position solve (K7) kernel KU
(``kernels/positions.py``).

Static (ground) rows are body-blocked [N, K]; pair rows are [Q entries, wm
rows] addressed through the per-body entry table.  Pair velocities and
impulse blocks travel as bf16 with f32 accumulation, at the reference's
rounding points.
"""

from __future__ import annotations

import dataclasses

import torch

from substrata_tpu_torch.kernels import layout, positions
from substrata_tpu_torch.kernels import solve as kc
from substrata_tpu_torch.kernels.solve import ContactRows, SolveState
from substrata_tpu_torch.kernels.solve_setup import cache_refresh, solve_setup
from substrata_tpu_torch.physics.narrowphase import Contacts
from substrata_tpu_torch.physics.state import (BodyState, SimConfig, SimParams,
                                               _Replace)


@dataclasses.dataclass
class SolverCache(_Replace):
    """Warm-start impulse cache: one [H, 5] f32 row per entry, lanes 0-1
    the int32 (body slot, feature key) identity stored bit for bit, lanes
    2-4 the (normal, tangent1, tangent2) impulses."""

    data: torch.Tensor

    @property
    def size(self):
        return self.data.shape[0]


def empty_solver_cache(size: int = 1 << 17, *, device) -> SolverCache:
    keys = torch.zeros((size, 2), dtype=torch.int32, device=device)
    keys[:, 0] = -1
    return SolverCache(data=torch.cat(
        [keys.view(torch.float32),
         torch.zeros((size, 3), dtype=torch.float32, device=device)], dim=1))


def cache_size_for(config: SimConfig) -> int:
    rows = (config.capacity * config.static_contacts_per_body
            + config.max_active_contacts)
    size = 1
    while size < 2 * rows:
        size <<= 1
    return size



def build_incidence(entry_a, entry_b, entry_occ, n_bodies: int, cpb: int):
    """Per-body entry table (kernel KT).  Returns (table [N, CPB] i32 (-1
    empty), sign [N, CPB] f32 (+1 body is entry a, -1 entry b), counts [N]
    f32).  Entries beyond a body's CPB slots are dropped for that body."""
    return layout.incidence(entry_a, entry_b, entry_occ, n_bodies, cpb)


@dataclasses.dataclass
class SolveSetup:
    """Everything the iterations need, built once per step."""

    rows: ContactRows
    state0: SolveState        # warm-start impulses (zeros without a cache)
    warm: bool                # pre-apply state0 before iterating
    table: torch.Tensor
    sign: torch.Tensor
    lookup: tuple | None      # (hash slot i32, valid) of every row, with a cache


def prepare_solve(body: BodyState, static_cts: Contacts, pair_cts: Contacts,
                  dt, params: SimParams, config: SimConfig,
                  cache: SolverCache | None = None, *,
                  wm: int = 1, table=None, sign=None) -> SolveSetup:
    """Effective masses, targets, side weights and the warm-start lookup
    (kernel KQ on the card, its twin on the CPU); the incidence table (K5,
    kernel KT) is built here when the caller has none."""
    n = body.capacity
    if table is None:
        Q = pair_cts.capacity // wm
        a_e = pair_cts.a.reshape(Q, wm)[:, 0]
        b_e = pair_cts.b.reshape(Q, wm)[:, 0]
        valid0 = pair_cts.valid.reshape(Q, wm)[:, 0]
        entry_occ = (a_e >= 0) if wm > 1 else (valid0 & (a_e >= 0))
        table, sign, _ = build_incidence(a_e, b_e, entry_occ, n, config.contacts_per_body)
    rows, y_s, y_p, lookup = solve_setup(body, static_cts, pair_cts, table, sign, params, dt,
                                         None if cache is None else cache.data, wm)
    return SolveSetup(rows, SolveState(y_s, y_s, y_p, y_p), cache is not None, table, sign,
                      lookup)


def iterate(setup: SolveSetup, linvel, angvel, iters: int, step=None):
    """Warm-start pre-apply, then ``iters`` FISTA iterations with
    beta_k = k/(k+3), 0 on the last so the final velocities match the
    feasible impulses.  By default the whole solve is kernel KC's
    ``solve`` (one plan a solve on the card); ``step`` runs it pass by
    pass instead (``solve_iteration``, KC checked at every call, or its
    plain twin)."""
    if step is None:
        return kc.solve(setup.rows, setup.state0, linvel, angvel, iters, setup.warm)
    st = setup.state0
    if setup.warm:
        st, linvel, angvel = step(setup.rows, st, linvel, angvel, 0.0, True)
    for beta in kc.betas(iters):
        st, linvel, angvel = step(setup.rows, st, linvel, angvel, beta)
    return st, linvel, angvel


def solve_contacts(body: BodyState, static_cts: Contacts, pair_cts: Contacts,
                   dt, params: SimParams, config: SimConfig,
                   cache: SolverCache | None = None, *,
                   wm: int = 1, table=None, sign=None):
    """Two-class warm-started contact solve.

    Returns (linvel, angvel, pair lambda_n [Q, wm], table, sign,
    static lambda_n [N, K], cache')."""
    setup = prepare_solve(body, static_cts, pair_cts, dt, params, config, cache,
                          wm=wm, table=table, sign=sign)
    st, linvel, angvel = iterate(setup, body.linvel, body.angvel, config.solver_iters)
    lam_s, lam_p = st.s_l, st.p_l

    new_cache = None
    if cache is not None:
        h, valid_all = setup.lookup
        new_cache = SolverCache(data=cache_refresh(
            cache.data, h, valid_all, static_cts, pair_cts, lam_s, setup.rows.s_valid, lam_p,
            setup.rows.p_valid))
    return (linvel, angvel, lam_p[..., 0], setup.table, setup.sign, lam_s[..., 0],
            new_cache)


def solve_positions(pos, body: BodyState, static_cts: Contacts,
                    pair_cts: Contacts, table, sign, params: SimParams,
                    config: SimConfig, iters: int = 2, beta: float = 0.25,
                    wm: int = 1):
    """Split-impulse, translation-only position correction (kernel KU)."""
    return positions.solve_positions(
        pos, body.inv_mass, body.awake,
        (static_cts.valid, static_cts.normal, static_cts.penetration),
        (pair_cts.a, pair_cts.b, pair_cts.valid, pair_cts.normal, pair_cts.penetration),
        table, sign, params.contact_slop, iters=iters, beta=beta, wm=wm)
