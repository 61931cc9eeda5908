"""substrata_tpu_torch's mesh world (benchworld.mesh_world and
mesh_tick: tools/bench_networked.py's world of hull cubes over the merged
static trimesh, ticked as the client's frame) against substrata_tpu's
facade built and ticked the same way, at a small size.

Tolerance: every dynamic body within 1e-3 m (the slice-1 bound of
test_torch_step.py) and the character within 1e-4 m of the reference at
every frame; the occlusion hit mask and the contact count exact.  The
config rebuilds the pair list every tick: the reference then compiles two
programs for its serving tick, not three (about 40 s each on the CPU).

Run as a script, it ticks the full-size world on both sides and prints
the hulls' heights and the character's foot (``mesh_world_runs``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from substrata_tpu.physics import character as jchar
from substrata_tpu.physics import queries as jq
from substrata_tpu.physics import shapes as jshapes
from substrata_tpu.physics import state as jstate
from substrata_tpu.physics import world as jworld
from substrata_tpu_torch import benchworld
from substrata_tpu_torch.physics import state as tstate
from substrata_tpu_torch.physics.character import EYE_HEIGHT

torch.set_num_threads(2)

DT = 1.0 / 60.0


def _jmesh_world(n_objects, n_dynamic, cfg):
    """benchworld.mesh_world, built through the reference's facade."""
    w = jworld.PhysicsWorld(jstate.SimConfig(**cfg))
    w.set_ground_plane(0.0)
    hull = jshapes.make_convex_hull(benchworld.CUBE_VERTS, mass=50.0)
    anchor_shape = jshapes.make_box([0.05, 0.05, 0.05])
    ident = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    slots = []
    for i, pos in enumerate(benchworld.mesh_layout(n_objects, n_dynamic)):
        dyn = i < n_dynamic
        shape = hull if dyn else anchor_shape
        bp, bq = shape.body_pose_from_mesh(pos, ident)
        ob = jworld.PhysicsObject(shape=shape, pos=bp, rot=bq, motion_type=2 if dyn else 0,
                                  friction=0.5, restitution=0.2, collidable=dyn)
        if dyn:
            slots.append(w.add_object(ob).slot)
        else:
            anchor = w.add_virtual_anchor(ob)
            w.add_static_mesh_instance(benchworld.CUBE_VERTS + np.asarray(pos, np.float32),
                                       benchworld.CUBE_TRIS,
                                       np.zeros(len(benchworld.CUBE_TRIS), np.int32),
                                       owner_slot=anchor.slot)
    return w, jchar.PlayerPhysics(w, eye_pos=(0.0, 0.0, EYE_HEIGHT)), np.array(slots)


def _jmesh_tick(w, p, t, slots):
    p.process_move(benchworld.walk_dir(t))
    w.think_with_player(DT, p, cur_time=t)
    ch = p.state
    pos = np.asarray(ch.pos)
    cam = np.concatenate([pos[:2], (pos[2:] + np.float32(EYE_HEIGHT))
                          - np.asarray(ch.campos_z_delta)[None]]).astype(np.float32)
    o, d, mt, keep = (x.numpy() for x in benchworld.occlusion_rays(
        torch.as_tensor(cam), torch.as_tensor(np.asarray(w.state.pos)[slots])))
    hits = jq.trace_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(mt), w.state,
                         w.static_world, w.config, n_steps=16)
    return np.asarray(hits.hit) & keep


MESH_CFG = dict(capacity=128, max_pairs=512, grid_dim=32, cell_size=4.0, solver_iters=7,
                pair_rebuild_interval=1)
MESH_TICKS = 30


@pytest.fixture(scope="module")
def reference_mesh_run():
    """The reference's small mesh world over MESH_TICKS client frames."""
    w, p, slots = _jmesh_world(300, 48, MESH_CFG)
    out = []
    for t in range(MESH_TICKS):
        hit = _jmesh_tick(w, p, t * DT, slots)
        out.append((np.asarray(w.state.pos)[slots], np.asarray(p.state.pos), hit,
                    int(w.last_diags.num_contacts)))
    return out


def test_small_mesh_world_tracks_reference(reference_mesh_run):
    """benchworld.mesh_world("cpu", 300 objects, 48 dynamic) through
    MESH_TICKS of benchworld.mesh_tick against the reference's facade built
    and ticked the same way."""
    w, p, sources = benchworld.mesh_world("cpu", n_objects=300, n_dynamic=48,
                                          cfg=tstate.SimConfig(**MESH_CFG))
    for t, (jpos, jfoot, jhit, jcontacts) in enumerate(reference_mesh_run):
        _, hit = benchworld.mesh_tick(w, p, t * DT, sources)
        if t == 0:
            assert w.static_world.n_tris == 252 * 12 and int(w.static_world.hulls.n_verts[0]) == 8
        np.testing.assert_allclose(w.state.pos[sources].numpy(), jpos, atol=1e-3,
                                   err_msg=f"tick {t}")
        np.testing.assert_allclose(p.state.pos.numpy(), jfoot, atol=1e-4, err_msg=f"tick {t}")
        np.testing.assert_array_equal(hit, jhit, err_msg=f"tick {t}")
        assert int(w.last_diags.num_contacts) == jcontacts, t
    assert jcontacts > 0 and hit.any()


def _frame_stats(z, thrown, foot, contacts):
    """Heights of the hulls (z [S]; ``thrown`` [S]: ever above 50 m or below
    -0.5 m), the character's foot and the contact count of one frame."""
    fin = np.isfinite(z)
    zf = z[fin]
    return dict(hull_z_min=float(zf.min()), hull_z_median=float(np.median(zf)),
                hull_z_max=float(zf.max()), below_minus_0_5=int((zf < -0.5).sum()),
                above_50=int((zf > 50).sum()), thrown=int(thrown.sum()),
                not_finite=int((~fin).sum()), foot=[float(x) for x in foot], contacts=contacts)


def mesh_world_runs(n_objects, n_dynamic, frames, every):
    """The mesh world on the reference's facade and on the port's CPU path,
    ``frames`` client frames each, as JSON lines of ``_frame_stats`` every
    ``every`` frames: what the reference's trimesh rule does to the hulls
    and the character at full size (ROADMAP.md queue 3)."""
    import json
    import time
    cfg = dict(capacity=4_096, max_pairs=8_192, grid_dim=64, cell_size=4.0, solver_iters=7,
               pair_rebuild_interval=6)
    for side in ("reference", "port"):
        t0 = time.perf_counter()
        if side == "reference":
            w, p, slots = _jmesh_world(n_objects, n_dynamic, cfg)
        else:
            w, p, sources = benchworld.mesh_world("cpu", n_objects, n_dynamic,
                                                  tstate.SimConfig(**cfg))
        thrown = np.zeros(n_dynamic, bool)
        for t in range(frames):
            if side == "reference":
                _jmesh_tick(w, p, t * DT, slots)
                z, foot = np.asarray(w.state.pos)[slots][:, 2], np.asarray(p.state.pos)
            else:
                benchworld.mesh_tick(w, p, t * DT, sources)
                z, foot = w.state.pos[sources][:, 2].numpy(), p.state.pos.numpy()
            thrown |= (z > 50.0) | (z < -0.5) | ~np.isfinite(z)
            if (t + 1) % every == 0:
                print(json.dumps(dict(side=side, frame=t, s=round(time.perf_counter() - t0, 1),
                                      **_frame_stats(z, thrown, foot,
                                                     int(w.last_diags.num_contacts)))),
                      flush=True)


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_mesh_world.py [n_objects n_dynamic frames every]
    # (default: tools/bench_networked.py's 12,000 objects, 512 dynamic, 180
    # frames; a few minutes a side on the CPU).
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    args = [int(x) for x in sys.argv[1:]] or [12_000, 512, 180, 30]
    mesh_world_runs(*args)
