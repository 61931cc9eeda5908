"""The 10,000-box bench world (bench.py:105-154) and its churn kick
(bench.py:212-221), rebuilt on the port for chip_smoke.py and
profile_tick.py."""

from __future__ import annotations

import numpy as np
import torch

from substrata_tpu_torch.physics import shapes
from substrata_tpu_torch.physics.state import MotionType, SimConfig
from substrata_tpu_torch.physics.world import PhysicsObject, PhysicsWorld

N_BODIES = 10_000


def bench_config() -> SimConfig:
    return SimConfig(capacity=10_240, max_pairs=16_384, grid_dim=128, cell_size=1.4,
                     cell_capacity=6, solver_iters=7, pairs_per_body=10,
                     pair_rebuild_interval=6, max_active_contacts=36_864,
                     contacts_per_body=8)


def bench_world(device, n_bodies: int = N_BODIES, cfg: SimConfig | None = None):
    """Boxes of half-extent 0.4 in 3 layers over ~70 x 70 m on a ground
    plane, positions from seed 0."""
    w = PhysicsWorld(cfg or bench_config(), device=device)
    w.set_ground_plane(0.0)
    rng = np.random.default_rng(0)
    layers = 3
    side = int(np.ceil((n_bodies / layers) ** 0.5))
    n = 0
    for iz in range(layers):
        for ix in range(side):
            for iy in range(side):
                if n >= n_bodies:
                    break
                pos = np.array([(ix - side / 2) * 1.7 + rng.uniform(-0.15, 0.15),
                                (iy - side / 2) * 1.7 + rng.uniform(-0.15, 0.15),
                                0.6 + iz * 1.2], np.float32)
                w.add_object(PhysicsObject(shape=shapes.make_box([0.4, 0.4, 0.4]),
                                           pos=pos, motion_type=int(MotionType.DYNAMIC)))
                n += 1
    return w


def kick(state, gen: torch.Generator):
    """Random velocity kick in [-1.5, 1.5] m/s (z halved) to every dynamic
    body, and a full wake."""
    k = torch.rand(state.linvel.shape, generator=gen, device=state.linvel.device) * 3.0 - 1.5
    k[:, 2] *= 0.5
    dyn = state.alive & state.dynamic
    return state.replace(linvel=torch.where(dyn[:, None], state.linvel + k, state.linvel),
                         awake=state.awake | dyn,
                         sleep_timer=torch.where(dyn, 0.0, state.sleep_timer))
