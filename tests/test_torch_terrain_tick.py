"""BASELINE config 4's client frame (``benchworld.terrain_tick``) at a small
size on the port's CPU path against the reference driven the same way.

Both packages' objects are built as ClientApp builds them and filled by
``benchworld.populate_terrain_scene`` (a 129 x 129 map over 1,024 m, the
trees of TerrainScattering as static capsules, 512 burst particles then 8
a frame, 8 avatars: walkers, a runner, idlers, one seated, one waving);
``terrain_tick`` drives both through the facades for 30 frames with one
camera jump (frame 30 is the first after them; the jump test below runs
31).  Each frame: the live particles within 1e-4 m and the alive masks
equal (the ray march and the update round a few ulp apart, PR 3), the
character's foot within 1e-4 m, every avatar's three joint sets within
1e-5 of each matrix's scale, the trees' count and positions equal, the
quadtree's leaves and the scatter cells equal."""

import numpy as np
import pytest
import torch

from substrata_tpu.avatar_graphics import AvatarGraphicsManager as JManager
from substrata_tpu.physics import shapes as jshapes
from substrata_tpu.physics import state as jstate
from substrata_tpu.physics import terrain as jterrain
from substrata_tpu.physics.character import PlayerPhysics as JPlayer
from substrata_tpu.physics.particles import ParticleManager as JParticles
from substrata_tpu.physics.world import PhysicsObject as JObject
from substrata_tpu.physics.world import PhysicsWorld as JWorld
from substrata_tpu.shared.avatar import Avatar as JAvatar
from substrata_tpu_torch import benchworld as bw
from substrata_tpu_torch.physics.character import EYE_HEIGHT
from substrata_tpu_torch.physics.state import SimConfig

torch.set_num_threads(2)

SMALL = dict(res=129, n_burst=512, n_stream=8, n_avatars=8)
CFG = dict(capacity=2048, max_pairs=4096, grid_dim=32, cell_size=4.0)


def ref_scene():
    w = JWorld(jstate.SimConfig(**CFG))
    w.set_ground_plane(0.0)
    terrain = jterrain.TerrainSystem(w)
    scattering = jterrain.TerrainScattering(terrain)
    particles = JParticles(w)
    player = JPlayer(w, eye_pos=(0.0, 0.0, EYE_HEIGHT))

    def make_tree(pos, scale):
        return w.add_object(JObject(
            shape=jshapes.make_capsule(0.2 * scale, 1.5 * scale),
            pos=np.asarray(pos, np.float32) + np.array([0, 0, 1.7], np.float32),
            motion_type=int(jstate.MotionType.STATIC)))

    scattering.make_tree_physics = make_tree
    return bw.populate_terrain_scene(w, player, terrain, scattering, particles, JManager(),
                                     JAvatar, **SMALL)


def _particles(scene):
    ps = scene.particles.state
    return np.asarray(ps.alive), np.asarray(ps.pos)


def _trees(scene):
    return sorted(tuple(np.round(np.asarray(o.pos, np.float64), 6))
                  for obs in scene.scattering.tree_physics_obs.values() for o in obs)


def compare(ref, port, frame):
    ja, jp = _particles(ref)
    ta, tp = _particles(port)
    np.testing.assert_array_equal(ta, ja, err_msg=f"frame {frame}: alive")
    assert np.abs(tp[ja] - jp[ja]).max() <= 1e-4, f"frame {frame}: particles"
    np.testing.assert_allclose(port.player.get_eye_position(), ref.player.get_eye_position(),
                               atol=1e-4, rtol=0, err_msg=f"frame {frame}: foot")
    for uid, jg in ref.graphics.by_uid.items():
        tg = port.graphics.by_uid[uid]
        for name in ("joints_obj", "joints_world", "skin_matrices"):
            j, t = getattr(jg, name).astype(np.float64), getattr(tg, name).astype(np.float64)
            scale = np.maximum(np.abs(j).max(axis=(-1, -2), keepdims=True), 1.0)
            assert (np.abs(t - j) / scale).max() <= 1e-5, f"frame {frame}: {uid} {name}"
    assert _trees(port) == _trees(ref), f"frame {frame}: trees"
    assert list(port.scattering.chunks) == list(ref.scattering.chunks)
    jv, tv = ref.terrain.visible_chunks(), port.terrain.visible_chunks()
    assert [(tuple(o), w) for o, w, _ in tv] == [(tuple(o), w) for o, w, _ in jv]


@pytest.fixture(scope="module")
def scenes():
    return ref_scene(), bw.terrain_world("cpu", cfg=SimConfig(**CFG), **SMALL)


def test_terrain_tick_30_frames_match_reference(scenes):
    ref, port = scenes
    assert len(port.world.objects) == len(ref.world.objects)
    for frame in range(30):
        bw.terrain_tick(ref, frame)
        bw.terrain_tick(port, frame)
        compare(ref, port, frame)
    alive = _particles(port)[0]
    assert alive.sum() > 400                              # the burst lives on
    assert port.scattering.num_instances() > 0 and port.terrain.num_chunks_built > 0


def test_terrain_tick_camera_jump_matches_reference(scenes):
    ref, port = scenes
    trees_before, built_before = _trees(port), port.terrain.num_chunks_built
    bw.terrain_tick(ref, 30)
    bw.terrain_tick(port, 30)
    compare(ref, port, 30)
    assert _trees(port) != trees_before                   # a column evicted, one added
    assert port.terrain.num_chunks_built > built_before   # the quadtree re-refined
    eye = port.player.get_eye_position()
    assert eye[0] > 40.0
