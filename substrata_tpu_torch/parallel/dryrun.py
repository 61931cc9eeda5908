"""The port's multi-shard dry run: every sharding axis of the tick on one
device, at the tiny size of the reference's ``dryrun_multichip``
(``__graft_entry__.py:49``): (1) W = 2n worlds stepped at once, their
awake counts summed; (2) 32n audio sources mixed in n shards, the stereo
blocks summed and clipped; (3) ONE world in n x-slabs with the halo
exchange; (3b) for an even n >= 4, the same world in (n / 2) x 2 tiles.

    python3 -m substrata_tpu_torch.parallel.dryrun [n_shards] [--cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from substrata_tpu_torch.audio.mix import default_listener, zero_sources
from substrata_tpu_torch.parallel.mesh import (Mesh, make_mesh, multi_world_step,
                                               replicate_states, sharded_mix_block)
from substrata_tpu_torch.parallel.spatial import (partition_by_slab, partition_by_tile,
                                                  shard_partitioned, spatial_world_step,
                                                  spatial_world_step_2d)
from substrata_tpu_torch.physics import shapes
from substrata_tpu_torch.physics.state import MotionType, SimConfig
from substrata_tpu_torch.physics.world import PhysicsObject, PhysicsWorld

DT = 1.0 / 60.0


def dryrun_world(device):
    """The reference dry run's world (``__graft_entry__.py:89-104``): 12
    spheres, boxes and capsules over a ground plane, from seed 0."""
    cfg = SimConfig(capacity=32, max_pairs=128, grid_dim=8, cell_size=4.0, solver_iters=2)
    w = PhysicsWorld(cfg, device=device)
    w.set_ground_plane(0.0)
    rng = np.random.default_rng(0)
    for i in range(12):
        sh = (shapes.make_sphere(0.3) if i % 3 == 0
              else shapes.make_box([0.3, 0.3, 0.3]) if i % 3 == 1
              else shapes.make_capsule(0.2, 0.3))
        w.add_object(PhysicsObject(
            shape=sh, pos=np.array([rng.uniform(-5, 5), rng.uniform(-5, 5), 1 + i * 0.5],
                                   np.float32),
            motion_type=int(MotionType.DYNAMIC)))
    w._flush()
    return w


def dryrun_sources(n_src: int, device):
    """The dry run's sources (``__graft_entry__.py:122-131``): looping
    4,096-sample buffers along +y from 1 to 50 m, and their pool."""
    src = zero_sources(n_src, device=device)
    buf_len = src.buf_len.clone()
    buf_len[:, 0] = 4096
    pos = src.pos.clone()
    pos[:, 1] = torch.linspace(1.0, 50.0, n_src, device=device)
    src = src.replace(alive=torch.ones_like(src.alive), buf_len=buf_len,
                      looping=torch.ones_like(src.looping), pos=pos)
    pool = torch.sin(torch.arange(4096, dtype=torch.float32, device=device) * 0.05)
    return src, pool


def dryrun_multichip(n_shards: int, device=None) -> str:
    """Run the four sharding paths over ``n_shards`` shards on one device
    (the card unless ``device="cpu"``); raises on a failed check and
    returns the summary line."""
    mesh = make_mesh(n_shards, device=device)
    dev = mesh.device
    w = dryrun_world(dev)

    # --- Axis 1: worlds ---
    n_worlds = 2 * n_shards
    states = replicate_states(w.state, n_worlds)
    new_states, total_awake = multi_world_step(states, w.static_world, None, DT, w.params,
                                               w.config, mesh)
    assert int(total_awake) > 0, "no awake bodies after one step"
    assert new_states.pos.shape[0] == n_worlds

    # --- Axis 2: audio sources ---
    n_src = 32 * n_shards
    src, pool = dryrun_sources(n_src, dev)
    _new_src, block = sharded_mix_block(src, pool, default_listener(device=dev), mesh)
    assert tuple(block.shape) == (256, 2)
    assert float(block.abs().max()) > 0.0, "silent sharded mix"

    # --- Axis 3: ONE world in x-slabs ---
    local_cap = max(32 // n_shards, 4)
    part, _owner = partition_by_slab(w.state, n_shards, local_cap, -6.0, 6.0)
    part = shard_partitioned(part, mesh)
    part, spatial_awake, _ov = spatial_world_step(part, w.static_world, None, DT, w.params,
                                                  w.config, mesh, halo_cap=4, halo_width=2.0,
                                                  x_min=-6.0, x_max=6.0)
    assert bool(torch.isfinite(part.pos).all())
    assert int(spatial_awake) > 0, "no awake bodies in the spatially sharded step"

    # --- Axis 3b: 2-D tiles ---
    msg_2d = ""
    if n_shards >= 4 and n_shards % 2 == 0:
        px, py = n_shards // 2, 2
        mesh2 = Mesh((px, py), ("sx", "sy"), dev)
        part2, _ = partition_by_tile(w.state, px, py, max(32 // n_shards, 4),
                                     -6.0, 6.0, -6.0, 6.0)
        part2 = shard_partitioned(part2, mesh2)
        part2, _awake2, _ov2 = spatial_world_step_2d(
            part2, w.static_world, None, DT, w.params, w.config, mesh2, halo_cap=4,
            halo_width=2.0, x_min=-6.0, x_max=6.0, y_min=-6.0, y_max=6.0)
        assert bool(torch.isfinite(part2.pos).all())
        msg_2d = f" + {px}x{py} 2-D tiles"

    return (f"dryrun_multichip OK: {n_worlds} worlds + {n_src} sources in {n_shards} "
            f"shards + 1 world spatially sharded (halo exchange{msg_2d}) on {dev}; "
            f"awake = {int(total_awake)}/{int(spatial_awake)}")


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    print(dryrun_multichip(int(args[0]) if args else 4,
                           device="cpu" if "--cpu" in sys.argv else None))
