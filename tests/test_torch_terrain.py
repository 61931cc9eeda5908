"""substrata_tpu_torch.physics.terrain and kernels KW / KX's twins against
the reference.

threefry ``fold_in`` and ``uniform`` bit-equal to ``jax.random``'s (this
JAX draws under the partitionable counter layout); the scatter points of
81 cells with negative origins, the height (+ normal) queries on 4,096
points of a 129 x 129 map and the chunk meshes of 8 leaves against the
JITTED reference, all exact (the twins repeat XLA's three contractions of
the bilinear sum, its gradient fmas and its norm; the stated tolerances,
2e-6 of the map's scale for heights and 1e-6 for normals, are not used);
the quadtree's leaves, ids and chunks along a camera path equal; then
tests/test_terrain.py's eight scenarios on the port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from substrata_tpu.physics import terrain as jterrain
from substrata_tpu.physics.state import Heightfield as JHeightfield
from substrata_tpu_torch import PhysicsObject, PhysicsWorld, convert
from substrata_tpu_torch.kernels import terrain as kt
from substrata_tpu_torch.physics import shapes
from substrata_tpu_torch.physics.state import MotionType, SimConfig
from substrata_tpu_torch.physics.terrain import BiomeManager, TerrainScattering, TerrainSystem
from substrata_tpu_torch.shared.parcel import Parcel

torch.set_num_threads(2)


def hills(res=65, extent=512.0):
    xs = np.linspace(-extent / 2, extent / 2, res)
    return (np.sin(xs[:, None] * 0.05) * np.cos(xs[None, :] * 0.03) * 8.0
            ).astype(np.float32), extent / (res - 1)


def noisy_map(res=129, extent=512.0, seed=0):
    """Hills plus seeded noise (every cell a different slope)."""
    h, cw = hills(res, extent)
    h = h + np.random.default_rng(seed).normal(0, 0.5, h.shape).astype(np.float32)
    return h, np.float32(cw), np.array([-extent / 2, -extent / 2], np.float32)


def both_fields(h, cw, origin):
    jhf = JHeightfield(heights=jnp.asarray(h), origin=jnp.asarray(origin),
                       cell_w=jnp.float32(cw))
    return jhf, convert.terrain_field_from_numpy(h, origin, cw, device="cpu")


# --- threefry ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 1234, 2 ** 31 - 1])
def test_threefry_fold_in_and_uniform_bit_equal(seed):
    for data in (0, 1, 5, -3, -29 * 73856093, 2 ** 31 - 1, -2 ** 31):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), np.int32(data))
        tk = kt.fold_in(kt.prng_key(seed), data)
        assert tuple(int(x) for x in np.asarray(jk)) == tk, (seed, data)
        ju = np.asarray(jax.random.uniform(jk, (64, 4))).reshape(-1)
        tu = kt.bits_to_unit(kt.uniform_bits(tk, 256)).numpy()
        np.testing.assert_array_equal(tu, ju, err_msg=f"seed {seed} data {data}")


def test_cell_hash_wraps_as_int32():
    cells = np.array([[-128.0, 96.5], [-0.5, -31.9], [1e9, -1e9], [4096.0, -4096.0]],
                     np.float32)
    c = cells.astype(np.int32)
    want = (c[:, 0] * np.int32(73856093)) ^ (c[:, 1] * np.int32(19349663))
    got = kt.cell_hash(torch.as_tensor(cells)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32).view(np.int32), want)


# --- KX ---------------------------------------------------------------------

def test_scatter_points_81_cells_match_reference():
    h, cw, origin = noisy_map()
    jhf, thf = both_fields(h, cw, origin)
    r = np.arange(-4, 5)
    cells = np.array([[(kx - 3) * 32.0, (ky - 2) * 32.0] for kx in r for ky in r], np.float32)
    jp, js, jr, jv = (np.asarray(a) for a in jterrain.scatter_points_for_cells(
        jhf, jnp.asarray(cells), jnp.float32(32.0), 1234, 64))
    out = kt.terrain_scatter(thf.heights, thf.origin, thf.cell_w, torch.as_tensor(cells), 32.0,
                             1234, 64).numpy()
    np.testing.assert_array_equal(out[..., 0:2], jp[..., 0:2])
    np.testing.assert_array_equal(out[..., 2], jp[..., 2])
    np.testing.assert_array_equal(out[..., 3], js)
    np.testing.assert_array_equal(out[..., 4], jr)
    _, n = kt.sample_plain(thf.heights, thf.origin, thf.cell_w,
                           torch.as_tensor(jp[..., :2].reshape(-1, 2).copy()), True)
    clear = np.abs(n[:, 2].numpy().reshape(81, 64) - 0.8) > 1e-6
    np.testing.assert_array_equal((out[..., 5] > 0.5)[clear], jv[clear])
    assert 0 < jv.sum() < jv.size          # some slopes are masked


# --- KW ---------------------------------------------------------------------

def test_heights_and_normals_4096_points_match_reference():
    h, cw, origin = noisy_map()
    jhf, thf = both_fields(h, cw, origin)
    xy = np.random.default_rng(1).uniform(-300, 300, (4096, 2)).astype(np.float32)
    jh = np.asarray(jterrain._eval_heights(jhf, jnp.asarray(xy)))
    jh2, jn = (np.asarray(a) for a in jterrain._eval_heights_normals(jhf, jnp.asarray(xy)))
    got = thf.heights_at(torch.as_tensor(xy)).numpy()[:, 0]
    got4 = thf.heights_at(torch.as_tensor(xy), with_normals=True).numpy()
    scale = float(np.abs(h).max())
    assert np.abs(got - jh).max() <= 2e-6 * scale
    assert np.abs(got4[:, 0] - jh2).max() <= 2e-6 * scale
    assert np.abs(got4[:, 1:] - jn).max() <= 1e-6
    np.testing.assert_array_equal(got, jh)            # in fact exact
    np.testing.assert_array_equal(got4[:, 0], jh2)
    np.testing.assert_array_equal(got4[:, 1:], jn)


def test_chunks_of_8_leaves_match_reference():
    h, cw, origin = noisy_map()
    jhf, thf = both_fields(h, cw, origin)
    rng = np.random.default_rng(2)
    leaves = [(rng.uniform(-256, 200, 2).astype(np.float32), float(2 ** rng.integers(3, 9)))
              for _ in range(8)]
    packed = kt.terrain_chunks(thf.heights, thf.origin, thf.cell_w,
                               torch.as_tensor(np.array([o for o, _ in leaves])),
                               torch.as_tensor(np.array([w for _, w in leaves], np.float32)), 16)
    for (o, w), got in zip(leaves, kt.unpack_chunks(packed.numpy(), 16)):
        want = jterrain.make_terrain_chunk(jhf, jnp.asarray(o), jnp.float32(w), 16)
        for name, g, j in zip(("verts", "normals", "uvs", "tris"), got, want):
            assert g.dtype == np.asarray(j).dtype and g.shape == np.asarray(j).shape, name
            np.testing.assert_array_equal(g, np.asarray(j), err_msg=name)


def test_quadtree_builds_match_reference_along_a_camera_path():
    h, cw, origin = noisy_map(res=65)
    jts = jterrain.TerrainSystem(extent=512.0)
    tts = TerrainSystem(extent=512.0, device="cpu")
    for ts in (jts, tts):
        ts.set_heightmap(h, origin=origin, cell_w=cw)
    for cam in ([0, 0, 10], [40, 0, 10], [80, -30, 5], [5000, 5000, 0], [-100, 120, 3]):
        jts.update_campos(cam)
        tts.update_campos(cam)
        jv, tv = jts.visible_chunks(), tts.visible_chunks()
        assert len(jv) == len(tv) and jts.num_chunks_built == tts.num_chunks_built
        assert sorted(jts.built_chunks) == sorted(tts.built_chunks)
        for (jo, jw, jc), (to, tw, tc) in zip(jv, tv):
            np.testing.assert_array_equal(to, jo)
            assert tw == jw
            for a, b in zip(tc, jc):
                np.testing.assert_array_equal(a, b)


# --- tests/test_terrain.py's scenarios on the port. -----------------------

def make_terrain():
    ts = TerrainSystem(extent=512.0, device="cpu")
    h, cw = hills()
    ts.set_heightmap(h, origin=[-256, -256], cell_w=cw)
    return ts, h, cw


def test_eval_terrain_height_matches_heightmap():
    ts, h, cw = make_terrain()
    z = ts.eval_terrain_height(-256 + 10 * cw, -256 + 20 * cw)
    assert abs(z - h[10, 20]) < 1e-4


def test_quadtree_refines_near_camera():
    ts, _, _ = make_terrain()
    ts.update_campos([0, 0, 10])
    near = len(ts.visible_chunks())
    ts2, _, _ = make_terrain()
    ts2.update_campos([5000, 5000, 10])
    assert near > len(ts2.visible_chunks())
    widths = [w for _, w, _ in ts.visible_chunks()]
    assert min(widths) < max(widths)


def test_chunk_mesh_matches_terrain():
    ts, _, _ = make_terrain()
    ts.update_campos([0, 0, 10])
    _, _, (verts, normals, uvs, tris) = ts.visible_chunks()[0]
    assert np.isfinite(verts).all()
    np.testing.assert_allclose(verts[:, 2], ts.eval_terrain_heights(verts[:, :2]), atol=1e-4)
    assert np.all(np.abs(np.linalg.norm(normals, axis=1) - 1.0) < 1e-4)
    assert tris.min() >= 0 and tris.max() < len(verts)


def test_player_clamp_use_case():
    ts, _, _ = make_terrain()
    z = ts.eval_terrain_height(3.0, 4.0)
    player_z = z - 5.0
    if player_z < z - 0.5:
        player_z = z + 1.0
    assert player_z > z


def test_scattering_populates_and_evicts():
    ts, _, _ = make_terrain()
    sc = TerrainScattering(ts, cell_w=32.0, radius_cells=2, points_per_cell=32)
    sc.update_campos([0, 0, 0])
    assert sc.num_instances() > 0 and len(sc.chunks) == 25
    info = next(iter(sc.chunks.values()))[0]
    assert abs(info.pos[2] - ts.eval_terrain_height(float(info.pos[0]),
                                                    float(info.pos[1]))) < 1e-3
    sc.update_campos([500, 500, 0])
    assert len(sc.chunks) == 25
    assert all(abs(kx * 32 - 500) < 200 for kx, ky in sc.chunks)


def test_scattering_deterministic_and_equal_to_reference():
    ts, h, cw = make_terrain()
    jts = jterrain.TerrainSystem(extent=512.0)
    jts.set_heightmap(h, origin=[-256, -256], cell_w=cw)
    a = TerrainScattering(ts, cell_w=32.0, radius_cells=1, seed=7)
    b = TerrainScattering(ts, cell_w=32.0, radius_cells=1, seed=7)
    j = jterrain.TerrainScattering(jts, cell_w=32.0, radius_cells=1, seed=7)
    for s in (a, b, j):
        s.update_campos([0, 0, 0])
    assert list(a.chunks) == list(j.chunks)
    for key in sorted(a.chunks):
        pa = np.array([i.pos for i in a.chunks[key]])
        np.testing.assert_array_equal(pa, np.array([i.pos for i in b.chunks[key]]))
        np.testing.assert_array_equal(pa, np.array([i.pos for i in j.chunks[key]]))
        assert [(i.scale, i.rot) for i in a.chunks[key]] == \
            [(i.scale, i.rot) for i in j.chunks[key]]


def test_small_tree_physics_objects():
    w = PhysicsWorld(SimConfig(capacity=512, max_pairs=512, grid_dim=16, cell_size=8.0),
                     device="cpu")
    ts = TerrainSystem(physics_world=w, extent=512.0)
    h, cw = hills()
    ts.set_heightmap(h, origin=[-256, -256], cell_w=cw)
    sc = TerrainScattering(ts, cell_w=32.0, radius_cells=1, points_per_cell=8)

    def make_tree(pos, scale):
        return w.add_object(PhysicsObject(
            shape=shapes.make_capsule(0.2 * scale, 1.5 * scale),
            pos=np.asarray(pos, np.float32) + np.array([0, 0, 1.7], np.float32),
            motion_type=int(MotionType.STATIC)))

    sc.make_tree_physics = make_tree
    sc.update_campos([0, 0, 0])
    n_obs = len(w.objects)
    assert n_obs > 0
    sc.update_campos([5000, 5000, 0])
    sc.update_campos([5000 + 32 * 8, 5000, 0])
    assert len(w.objects) < n_obs + 200


def test_biome_manager():
    ts, _, _ = make_terrain()
    bm = BiomeManager(ts, density_per_m2=0.05)
    p = Parcel(parcel_id=7, aabb_min=np.array([0, 0, -10.0]),
               aabb_max=np.array([20, 20, 10.0]))
    infos = bm.add_biome_for_parcel(p)
    assert len(infos) == int(400 * 0.05)
    for i in infos[:5]:
        assert 0 <= i.pos[0] <= 20 and 0 <= i.pos[1] <= 20
        assert abs(i.pos[2] - ts.eval_terrain_height(float(i.pos[0]), float(i.pos[1]))) < 1e-6
    bm.remove_biome_for_parcel(7)
    assert 7 not in bm.parcel_scatter
