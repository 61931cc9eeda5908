"""A thrown hull on the port against the reference: the mesh world cut down
to one of its hulls that the reference's trimesh sign rule throws.

``benchworld.mesh_world``'s hull 84 of a 1,200-object world (96 hulls)
lands among two static cubes and leaves at 169 m/s, then 462 m/s, on the
reference's facade and on the port's CPU path alike.  The scene here
keeps what that hull meets: the static cubes within 12 m of it, the four
cubes that span the world (so the trimesh grid's origin and cells are the
full world's), and one more hull placed beyond the grid's edge, which
gains speed tick after tick while it hovers near the ground.  Both
packages build the scene through their facades and step it with
``think(1/60)``; the reference's run is shared (one module-scoped run,
~20 s of its compiles).

What throws them (narrowphase.py:944-1009, kept by the port as
``tests/test_torch_trimesh.py::test_trimesh_sign_rule_kicks_like_the_
reference`` holds it): each sample point takes the deepest of its cell's
triangles with the sign of the distance from the triangle's plane,
wherever the closest point lies, and the depth is clamped to 0.5 m.  The
falling hull is 'behind' a nearby cube's bottom face, then its two side
faces, 2-4 m away: every kept sample carries a 0.5 m contact whose normal
flips between +y and -y tick to tick, and the solve's impulses at that
lever arm double or triple the spin each tick (0.8 to 1,333 rad/s in ten
ticks), which the contacts turn into speed.  The hull past the grid's
edge takes the edge cell's triangles (the cell index is clipped, :944-945)
and hovers under the same clamped contacts while gravity accumulates in
its velocity.

Tolerance: positions within 1e-3 m (the slice-1 bound of
test_torch_step.py) and velocities within 1e-4 of their scale at every
tick while both are finite.  The run stops at tick 15: from there the
thrown hull's 400 m/s carries the rounding of its position past 1e-3 m
(it moves ~7 m a tick)."""

import numpy as np
import pytest
import torch

from substrata_tpu.physics import shapes as jshapes
from substrata_tpu.physics import state as jstate
from substrata_tpu.physics import world as jworld
from substrata_tpu_torch import PhysicsObject, PhysicsWorld, benchworld
from substrata_tpu_torch.physics import narrowphase as tnp
from substrata_tpu_torch.physics import shapes
from substrata_tpu_torch.physics.state import SimConfig

torch.set_num_threads(2)

DT = 1.0 / 60.0
TICKS = 15
THROWN = 84          # mesh_layout(1200, 96)'s hull that the sign rule throws
REACH = 12.0         # m: the static cubes and hulls kept around it
CFG = dict(capacity=32, max_pairs=128, grid_dim=64, cell_size=4.0, solver_iters=7,
           pair_rebuild_interval=6)


def scene():
    """(static cube centres, hull mesh positions): the cut of the 1,200-object
    mesh world's layout around hull THROWN, the four cubes that span the
    world, and one hull past the grid's +x edge.  The thrown hull is first."""
    layout = benchworld.mesh_layout(1200, 96)
    hulls, cubes = layout[:96], layout[96:]
    c = hulls[THROWN]
    near = (np.abs(cubes[:, 0] - c[0]) < REACH) & (np.abs(cubes[:, 1] - c[1]) < REACH)
    for axis in (0, 1):
        near[np.argmin(cubes[:, axis])] = near[np.argmax(cubes[:, axis])] = True
    others = [i for i in range(96) if i != THROWN
              and abs(hulls[i, 0] - c[0]) < REACH and abs(hulls[i, 1] - c[1]) < REACH]
    beyond = np.array([[200.0, 101.0, 3.0]])
    return cubes[near], np.concatenate([hulls[[THROWN] + others], beyond])


def build(world_cls, object_cls, shape_mod, config_cls, **kw):
    """The scene through one package's facade: (world, the hulls' slots)."""
    cubes, hull_at = scene()
    w = world_cls(config_cls(**CFG), **kw)
    w.set_ground_plane(0.0)
    anchor_shape = shape_mod.make_box([0.05, 0.05, 0.05])
    ident = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    mats = np.zeros(len(benchworld.CUBE_TRIS), np.int32)
    for pos in cubes.astype(np.float32):
        bp, bq = anchor_shape.body_pose_from_mesh(pos, ident)
        anchor = w.add_virtual_anchor(object_cls(shape=anchor_shape, pos=bp, rot=bq,
                                                 motion_type=0, collidable=False))
        w.add_static_mesh_instance(benchworld.CUBE_VERTS + pos, benchworld.CUBE_TRIS, mats,
                                   owner_slot=anchor.slot)
    hull = shape_mod.make_convex_hull(benchworld.CUBE_VERTS, mass=50.0)
    slots = []
    for pos in hull_at.astype(np.float32):
        bp, bq = hull.body_pose_from_mesh(pos, ident)
        slots.append(w.add_object(object_cls(shape=hull, pos=bp, rot=bq, motion_type=2,
                                             friction=0.5, restitution=0.2)).slot)
    return w, np.array(slots)


def run(w, slots):
    """TICKS thinks: each tick's (pos, linvel, angvel) of the hulls."""
    out = []
    for _ in range(TICKS):
        w.think(DT)
        s = w.state
        out.append(tuple(np.array(np.asarray(getattr(s, f)))[slots]
                         for f in ("pos", "linvel", "angvel")))
    return out


@pytest.fixture(scope="module")
def reference_run():
    return run(*build(jworld.PhysicsWorld, jworld.PhysicsObject, jshapes, jstate.SimConfig))


@pytest.fixture(scope="module")
def port_world():
    w, slots = build(PhysicsWorld, PhysicsObject, shapes, SimConfig, device="cpu")
    return w, slots, run(w, slots)


def test_scene_cuts_the_mesh_world():
    """Eight static cubes (two beside the thrown hull, the four that span
    the world, two more within reach), the thrown hull alone among the
    world's hulls within reach, and the hull past the grid's edge."""
    cubes, hulls = scene()
    assert len(cubes) == 8 and len(hulls) == 2
    assert cubes[:, 0].max() < hulls[1, 0]
    w, _ = build(PhysicsWorld, PhysicsObject, shapes, SimConfig, device="cpu")
    w._flush()
    tm = w.static_world.trimesh
    edge = float(tm.origin[0] + tm.cell_w * tm.cell_tris.shape[0])
    assert w.static_world.n_tris == 8 * 12 and hulls[1, 0] - 0.5 > edge


def test_thrown_hulls_track_the_reference(reference_run, port_world):
    """Every tick: the hulls' positions within 1e-3 m of the reference's,
    their linear and angular velocities within 1e-4 of their scale."""
    for t, (want, got) in enumerate(zip(reference_run, port_world[2])):
        assert all(np.isfinite(x).all() for x in want + got), t
        np.testing.assert_allclose(got[0], want[0], atol=1e-3, rtol=0, err_msg=f"tick {t}")
        for g, w in zip(got[1:], want[1:]):
            scale = max(float(np.abs(w).max()), 1.0)
            np.testing.assert_allclose(g, w, atol=1e-4 * scale, rtol=0, err_msg=f"tick {t}")


@pytest.mark.parametrize("side", ["reference", "port"])
def test_sign_rule_throws_the_hull_sideways(side, reference_run, port_world):
    """On both packages the hull lands among the cubes at under 4 m/s, its
    speed grows at least 1.5x a tick over ticks 6-9 past 150 m/s (mostly
    along y, the side faces' normal: a sideways throw, 2 m above the
    ground, at 106 m/s), and its spin grows past 1,000 rad/s."""
    rec = reference_run if side == "reference" else port_world[2]
    speed = np.array([np.linalg.norm(v[0]) for _, v, _ in rec])
    spin = np.array([np.linalg.norm(w[0]) for _, _, w in rec])
    assert speed[:6].max() < 4.0
    assert (speed[6:10] > 1.5 * speed[5:9]).all() and speed[9] > 150.0, speed
    pos, vel, _ = rec[8]
    assert abs(vel[0, 1]) > 0.9 * speed[8] and pos[0, 2] < 2.0
    assert spin[:3].max() < 10.0 and spin.max() > 1000.0, spin


@pytest.mark.parametrize("side", ["reference", "port"])
def test_hull_past_the_grid_speeds_up(side, reference_run, port_world):
    """On both packages the hull past the grid's edge gains speed at every
    tick while it stays within 3.5 m of the ground: the clipped edge
    cell's triangles hold it with clamped contacts while gravity
    accumulates in its velocity."""
    rec = reference_run if side == "reference" else port_world[2]
    speed = np.array([np.linalg.norm(v[1]) for _, v, _ in rec])
    assert (np.diff(speed) > 0).all() and speed[-1] > 2.5, speed
    assert all(p[1, 2] < 3.5 for p, _, _ in rec)


def _static_rows(w, slot):
    """The port's static contacts of body ``slot``: (valid, depth, normal,
    distance from the body to each contact point) of its kept samples."""
    s = w.state
    c = tnp.static_contacts(s, w.static_world, w.config)
    k = c.capacity // s.capacity
    rows = slice(int(slot) * k, (int(slot) + 1) * k)
    return (c.valid[rows], c.penetration[rows], c.normal[rows],
            (c.point[rows] - s.pos[int(slot)]).norm(dim=1))


def test_far_sign_rule_contacts(port_world):
    """The contacts that throw and hold the hulls, on the port: after one
    tick the falling hull, over 3 m above the ground and clear of every
    cube, carries the 0.5 m clamp on each kept sample, its normal down (a
    cube's bottom face, 'behind' which it lies) and its point ~4 m away;
    after the last tick so does the hull past the grid's edge."""
    w, slots = build(PhysicsWorld, PhysicsObject, shapes, SimConfig, device="cpu")
    w.think(DT)
    assert float(w.state.pos[int(slots[0]), 2]) > 3.0
    valid, pen, normal, lever = _static_rows(w, slots[0])
    assert bool(valid.all()) and bool((pen == 0.5).all()), pen
    assert bool((normal[:, 2] == -1.0).all()) and float(lever.min()) > 3.0, (normal, lever)
    valid, pen, _, lever = _static_rows(port_world[0], port_world[1][1])
    assert bool(valid.any()) and bool((pen[valid] == 0.5).all()), pen
    assert float(lever[valid].min()) > 1.0, lever


def full_world_speeds(ticks=12):
    """Hull THROWN's speed each tick in the whole 1,200-object mesh world
    (96 hulls, think(1/60), no player) on the reference's facade and on the
    port's CPU path, as JSON lines: the throw the cut scene keeps."""
    import json
    from test_torch_mesh_world import _jmesh_world
    cfg = dict(capacity=1024, max_pairs=2048, grid_dim=64, cell_size=4.0, solver_iters=7,
               pair_rebuild_interval=6)
    jw, _, jslots = _jmesh_world(1200, 96, cfg)
    tw, _, tslots = benchworld.mesh_world("cpu", 1200, 96, SimConfig(**cfg))
    for t in range(ticks):
        jw.think(DT)
        tw.think(DT)
        jv = float(np.linalg.norm(np.asarray(jw.state.linvel)[jslots[THROWN]]))
        tv = float(tw.state.linvel[tslots[THROWN]].norm())
        print(json.dumps(dict(tick=t, reference=jv, port=tv)), flush=True)


if __name__ == "__main__":
    # PYTHONPATH=.:tests python tests/test_torch_thrown_hull.py (~2 min on
    # the CPU, mostly the reference's compiles).
    import jax
    jax.config.update("jax_platforms", "cpu")
    full_world_speeds()
