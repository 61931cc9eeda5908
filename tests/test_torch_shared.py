"""The port's copies of the reference's host modules against the originals,
on the same seeded inputs: WorldObject serialisation, the voxel mesher,
the bmesh codec, the model decoders, sub:// URLs, the load queue, the
snapshot rings and physics ownership, the path controllers and the XML
script parser.

The port keeps its own copies because importing any module of the
reference package loads jax.  Every comparison here is exact (bytes,
strings, arrays bit for bit): the copies run the same numpy code.
"""

import dataclasses

import numpy as np
import pytest

from substrata_tpu import loading as j_loading
from substrata_tpu.net import snapshots as j_snap
from substrata_tpu.scripting import path_controller as j_path
from substrata_tpu.scripting import xml_scripts as j_xml
from substrata_tpu.shared import bmesh as j_bmesh
from substrata_tpu.shared import model_formats as j_models
from substrata_tpu.shared import sub_url as j_url
from substrata_tpu.shared import voxel as j_voxel
from substrata_tpu.shared import world_object as j_wo
from substrata_tpu_torch import loading as t_loading
from substrata_tpu_torch.net import snapshots as t_snap
from substrata_tpu_torch.scripting import path_controller as t_path
from substrata_tpu_torch.scripting import xml_scripts as t_xml
from substrata_tpu_torch.shared import bmesh as t_bmesh
from substrata_tpu_torch.shared import model_formats as t_models
from substrata_tpu_torch.shared import sub_url as t_url
from substrata_tpu_torch.shared import voxel as t_voxel
from substrata_tpu_torch.shared import world_object as t_wo
from tests.test_gltf import make_cube_gltf
from tests.test_model_formats import CUBE_OBJ, _binary_stl, _vox_file, make_igmesh


def same(a, b, what=""):
    """Exact equality of nested results (arrays bit for bit, dataclasses
    field by field)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), what
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            same(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{what}[{i}]")
    elif hasattr(a, "__dict__") and not isinstance(a, type):
        same(vars(a), vars(b), what)
    else:
        assert a == b, (what, a, b)


# ---------------------------------------------------------------------------
# WorldObject
# ---------------------------------------------------------------------------

def _world_object(mod, seed):
    rng = np.random.default_rng(seed)
    ob = mod.WorldObject(
        uid=int(rng.integers(1, 1 << 40)), model_url=f"m{seed}.glb",
        script="<script/>" if seed % 2 else "--lua\nx = 1",
        audio_source_url="s.wav" if seed % 3 else "", audio_volume=float(rng.uniform()),
        pos=rng.normal(0, 50, 3), scale=rng.uniform(0.5, 3, 3).astype(np.float32),
        flags=int(rng.integers(0, 1 << 12)), mass=float(rng.uniform(1, 100)),
        friction=float(rng.uniform()), restitution=float(rng.uniform()),
        physics_owner_id=int(rng.integers(0, 1000)),
        materials=[mod.WorldMaterial(colour_rgb=tuple(rng.uniform(0, 1, 3)),
                                     roughness=float(rng.uniform()))
                   for _ in range(int(rng.integers(0, 3)))],
        voxel_data=rng.bytes(int(rng.integers(0, 20))),
        object_type=int(rng.integers(0, 4)), target_url="sub://h?x=1" if seed % 4 else "")
    ob.set_rotation_quat(rng.normal(size=4))
    return ob


@pytest.mark.parametrize("seed", range(6))
def test_world_object_serialisation_equal(seed):
    a, b = _world_object(j_wo, seed), _world_object(t_wo, seed)
    data = a.to_bytes()
    assert data == b.to_bytes()
    ja, tb = j_wo.WorldObject.from_bytes(data), t_wo.WorldObject.from_bytes(data)
    assert ja.to_bytes() == tb.to_bytes() == data
    for k in ("uid", "pos", "quat", "scale", "flags", "mass", "is_dynamic", "is_collidable"):
        x, y = getattr(ja, k), getattr(tb, k)
        same(x() if callable(x) else x, y() if callable(y) else y, k)
    assert [int(x) for x in j_wo.ObjectType] == [int(x) for x in t_wo.ObjectType]


# ---------------------------------------------------------------------------
# Voxels, bmesh, model formats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 40, 300])
def test_voxel_mesher_equal(n):
    rng = np.random.default_rng(n)
    coords = np.unique(rng.integers(-4, 5, (n, 3)), axis=0)
    mats = rng.integers(0, 3, len(coords))
    data = j_voxel.compress_voxel_group(coords, mats)
    assert data == t_voxel.compress_voxel_group(coords, mats)
    same(j_voxel.decompress_voxel_group(data), t_voxel.decompress_voxel_group(data))
    # The port copies the numpy mesher only; the reference takes its native
    # C++ mesher for 64 voxels or more where that is built, whose vertex
    # layout differs, so the port is held to the reference's numpy route.
    same(j_voxel.make_greedy_mesh(coords, mats, 0.5, use_native=False),
         t_voxel.make_greedy_mesh(coords, mats, 0.5))
    same(j_voxel.make_greedy_mesh(*j_voxel.decompress_voxel_group(data), 0.25,
                                  use_native=False),
         t_voxel.make_mesh_for_voxel_group(data, voxel_size=0.25))


@pytest.mark.parametrize("n_verts,n_tris", [(8, 12), (300, 500), (70_000, 3000)])
def test_bmesh_write_load_equal(n_verts, n_tris):
    rng = np.random.default_rng(n_verts)
    verts = rng.normal(size=(n_verts, 3)).astype(np.float32)
    tris = rng.integers(0, n_verts, (n_tris, 3)).astype(np.int32)
    mats = rng.integers(0, 3, n_tris).astype(np.int32)
    # The reference's writer compresses with the zstandard package, the
    # port's stores (shared/zstd.py): the files differ, their contents not.
    for data in (j_bmesh.write_bmesh(verts, tris, mats), t_bmesh.write_bmesh(verts, tris, mats)):
        same(j_bmesh.load_bmesh(data), t_bmesh.load_bmesh(data))
    same(t_bmesh.load_bmesh(t_bmesh.write_bmesh(verts, tris, mats)),
         j_bmesh.load_bmesh(j_bmesh.write_bmesh(verts, tris, mats)))


def _model_fixtures():
    tri = [[(0, 0, 0), (1, 0, 0), (0, 1, 0)], [(0, 0, 0), (0, 1, 0), (0, 0, 1)]]
    ascii_stl = ("solid t\n" + "".join(
        "facet normal 0 0 1\nouter loop\n" + "".join(f"vertex {x} {y} {z}\n" for x, y, z in t)
        + "endloop\nendfacet\n" for t in tri) + "endsolid t\n").encode()
    cube_v = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.float32)
    cube_t = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5]], np.int32)
    return {
        "cube.obj": CUBE_OBJ,
        "tri.stl": _binary_stl(tri),
        "tri_ascii.stl": ascii_stl,
        "two.vox": _vox_file([(0, 0, 0, 1), (1, 0, 0, 2)]),
        "wedge.igmesh": make_igmesh([(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), (0, 0, 1)],
                                    tris=[(0, 1, 4, 2)], quads=[(0, 1, 2, 3, 5)],
                                    mats=(b"brick", b"")),
        "cube.bmesh": j_bmesh.write_bmesh(cube_v, cube_t),
        "packed.igmesh": j_models.write_igmesh(cube_v, cube_t, compressed=True),
        "cube.glb": make_cube_gltf(as_glb=True),
        "cube.gltf": make_cube_gltf(as_glb=False),
    }


@pytest.mark.parametrize("name", sorted(_model_fixtures()))
def test_decode_model_equal(name):
    data = _model_fixtures()[name]
    same(j_models.decode_model(name, data), t_models.decode_model(name, data), name)


def test_decode_model_rejects_alike():
    for name, data in (("mesh.igmesh", b"xx"), ("mesh.wat", b"xx")):
        with pytest.raises(j_models.UnsupportedModelFormat) as ej:
            j_models.decode_model(name, data)
        with pytest.raises(t_models.UnsupportedModelFormat) as et:
            t_models.decode_model(name, data)
        assert str(ej.value) == str(et.value)


def _zstd_inputs():
    rng = np.random.default_rng(5)
    return {"empty": b"", "text": b"substrata " * 3000,
            "random": rng.integers(0, 256, 20_000).astype(np.uint8).tobytes(),
            "floats": rng.normal(size=20_000).astype(np.float32).tobytes(),
            "ints": np.arange(50_000, dtype=np.int32).tobytes(),
            "runs": np.repeat(rng.integers(0, 256, 2_000).astype(np.uint8), 40).tobytes()}


@pytest.mark.parametrize("level", [-5, 1, 3, 9, 19])
def test_zstd_decoder_reads_the_reference_codec(level):
    """The port's standard-library zstd decoder on frames of the zstandard
    package (compressed blocks: Huffman literals, FSE sequences, repeat
    offsets; raw and RLE blocks; checksums; two frames back to back), and
    the zstandard package on the port's stored frames."""
    import zstandard
    from substrata_tpu_torch.shared import zstd
    for name, data in _zstd_inputs().items():
        comp = zstandard.ZstdCompressor(level=level, write_checksum=True).compress(data)
        assert zstd.decompress(comp + comp) == data + data, name
        assert zstandard.ZstdDecompressor().decompress(zstd.compress(data)) == data, name
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(b"not a frame")


# ---------------------------------------------------------------------------
# sub:// URLs, the load queue
# ---------------------------------------------------------------------------

URLS = ["sub://substrata.info/nick/my+cool+world?x=1&y=2&z=3&heading=45",
        "substrata.info/parcel/10", "sub://localhost?x=20.0&y=20.0&z=2.0&heading=90.0",
        "sub://h", "sub://h/w?x=-1.5&y=1e3&z=0", "sub://host:7600/a%20b?heading=370"]


@pytest.mark.parametrize("url", URLS)
def test_sub_url_equal(url):
    a, b = j_url.parse_sub_url(url), t_url.parse_sub_url(url)
    same(a, b, url)
    args = (a.hostname, a.worldname)
    kw = dict(pos=(a.x, a.y, a.z) if a.has_position else None, heading=a.heading)
    assert j_url.make_sub_url(*args, **kw) == t_url.make_sub_url(*args, **kw)


def _queue_run(mod, seed):
    rng = np.random.default_rng(seed)
    q = mod.LoadItemQueue()
    out = []
    for step in range(200):
        op = rng.integers(0, 4)
        if op == 0:
            k = f"{int(rng.integers(0, 40))}.glb"
            out.append(("enq", q.enqueue(k, rng.uniform(-100, 100, 3), k)))
        elif op == 1:
            q.cancel(f"{int(rng.integers(0, 40))}.glb")
        elif op == 2:
            q.update_campos(rng.uniform(-100, 100, 3))
        else:
            out.append(("pop", [k for k, _ in q.pop_n(int(rng.integers(1, 4)))]))
        out.append(len(q))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_load_queue_order_equal(seed):
    assert _queue_run(j_loading, seed) == _queue_run(t_loading, seed)


# ---------------------------------------------------------------------------
# Snapshot rings and physics ownership
# ---------------------------------------------------------------------------

def _snapshots_run(mod, seed):
    rng = np.random.default_rng(seed)
    n = 16
    rings = mod.SnapshotRings(n)
    own = mod.PhysicsOwnership(n)
    out = []
    t = 0.0
    for step in range(120):
        t += 1 / 60
        for i in rng.choice(n, 4, replace=False):
            q = rng.normal(size=4)
            rings.insert_snapshot(int(i), rng.normal(size=3), q / np.linalg.norm(q),
                                  rng.normal(size=3), rng.normal(size=3), t - 0.05, t)
        if step % 17 == 0:
            rings.set_transmission_time_offset(int(rng.integers(0, n)), float(rng.uniform(0, .1)))
        idx = np.arange(n)
        out.append(rings.interpolated_transforms(idx, t))
        due = rings.due_physics_snapshots(idx, t)
        out.append(due)
        dk = np.nonzero(due[0])[0]
        if len(dk):
            old_q = rng.normal(size=(len(dk), 4))
            rings.set_smoothing_from_corrections(idx[dk], rng.normal(size=(len(dk), 3)),
                                                 old_q / np.linalg.norm(old_q, axis=1)[:, None],
                                                 due[1][dk], due[2][dk])
        rings.decay_smoothing(1 / 60)
        out.append((rings.smooth_translation.copy(), rings.smooth_rotation.copy(),
                    rings.starved(idx, t)))
        for _ in range(3):
            i, av = int(rng.integers(0, n)), int(rng.integers(1, 4))
            out.append((own.try_claim(i, av, t), own.is_free(i, t), own.owned_by(i, av, t),
                        own.needs_renewal(i, t)))
        if step % 11 == 0:
            own.apply_remote_claim(int(rng.integers(0, n)), 9, t - 0.2)
        if step % 23 == 0:
            own.release(int(rng.integers(0, n)))
    out.append((own.owner_id.copy(), own.change_time.copy()))
    return out


@pytest.mark.parametrize("seed", range(2))
def test_snapshot_rings_and_ownership_equal(seed):
    same(_snapshots_run(j_snap, seed), _snapshots_run(t_snap, seed))
    assert (j_snap.OWNERSHIP_PERIOD, j_snap.SEND_PERIOD) == (t_snap.OWNERSHIP_PERIOD,
                                                              t_snap.SEND_PERIOD)


# ---------------------------------------------------------------------------
# Path controllers and XML scripts
# ---------------------------------------------------------------------------

class _Recorder:
    """The physics-world surface the controllers touch: kinematic moves."""

    def __init__(self):
        self.moves = []

    def move_kinematic_object(self, ob, pos, rot, dt):
        self.moves.append((np.asarray(pos).copy(), np.asarray(rot).copy(), dt))
        ob.pos, ob.rot = np.asarray(pos), np.asarray(rot)


class _Ob:
    def __init__(self, uid, pos):
        self.uid = uid
        self.pos = np.asarray(pos, np.float32)
        self.rot = np.array([0, 0, 0, 1], np.float32)


WAYPOINTS = [{"pos": [0, 0, 1], "type": 2, "pause_time": 0.5, "speed": 4.0},
             {"pos": [6, 0, 1], "type": 0, "speed": 4.0},
             {"pos": [8, 2, 1], "type": 1, "speed": 4.0},
             {"pos": [8, 9, 2], "type": 2, "pause_time": 0.0, "speed": 3.0},
             {"pos": [0, 9, 1], "type": 2, "pause_time": 1.0, "speed": 5.0}]


def _paths_run(mod):
    rec = _Recorder()
    lead = mod.ObjectPathController(_Ob(1, [0, 0, 1]), WAYPOINTS, orient_along_path=True)
    follow = mod.ObjectPathController(_Ob(2, [0, 0, 1]), WAYPOINTS, follow_ob_uid=1,
                                      follow_dist=2.0)
    ws = type("WS", (), {"objects": {1: type("W", (), {"path_controller": lead,
                                                       "physics_object": lead.controlled_ob})()}})()
    order = mod.ObjectPathController.sort_path_controllers([follow, lead])
    mover = mod.ObjectMoveToController(_Ob(3, [0, 0, 0]), [4, 1, 2], [0, 0, 0.6, 0.8],
                                       duration=0.7)
    for _ in range(120):
        for pc in order:
            pc.update(rec, 1 / 60, world_state=ws)
        if not mover.done:
            mover.update(rec, 1 / 60)
    return [order.index(lead), rec.moves, mover.done,
            [(w.curve_r, w.curve_angle, w.segment_len) for w in lead.waypoints]]


def test_path_controller_trajectories_equal():
    same(_paths_run(j_path), _paths_run(t_path))


XML_SCRIPTS = [
    """<?xml version="1.0"?>
    <script>
      <follow_path>
        <speed>5</speed>
        <orient_along_path/>
        <waypoint><pos>0 0 1</pos><type>Station</type><pause_time>2</pause_time></waypoint>
        <waypoint><pos>10 0 1</pos><type>Station</type></waypoint>
      </follow_path>
      <car>
        <front_wheel_radius>0.4</front_wheel_radius>
        <max_steering_angle>0.5</max_steering_angle>
        <seat><seat_position>0 0.2 0.5</seat_position></seat>
      </car>
    </script>""",
    "<script><boat><thrust_force>5000</thrust_force>"
    "<propellor_point_os>0 -2 -0.5</propellor_point_os></boat></script>",
    "<script><bike/></script>", "<script><hover_car/></script>", "<script><car/></script>",
    "<script><follow_path><waypoint><pos>0 0 0</pos><type>CurveIn</type></waypoint>"
    "<waypoint><pos>4 0 0</pos><type>CurveOut</type></waypoint>"
    "<waypoint><pos>4 4 0</pos><type>Station</type></waypoint></follow_path></script>",
    "<notscript/>",
    "<script><follow_path><waypoint><pos>1 2 3</pos></waypoint></follow_path></script>",
]


def _parse_or_error(mod, src):
    try:
        return mod.parse_xml_script(src)
    except Exception as e:            # the error itself is part of the result
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("k", range(len(XML_SCRIPTS)))
def test_parse_xml_script_equal(k):
    same(_parse_or_error(j_xml, XML_SCRIPTS[k]), _parse_or_error(t_xml, XML_SCRIPTS[k]))
