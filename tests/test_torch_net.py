"""substrata_tpu_torch.net: the wire protocol, the Server and Client over
loopback, and the server's texture pipeline, against the reference.

Every message builder of the port's ``net/protocol.py`` and every sender of
its ``Client`` gives the reference's bytes; a reference ``Client`` talks to
the port's ``Server`` (and the port's to the reference's).  Then
tests/test_net.py's scenarios on the port's Server and Client: handshake
and time sync (over TLS, the default, once; the rest plaintext,
``tls_context=None``), object creation, the physics snapshot round trip,
the dynamic-only guard, resource upload and download with its
rejections, get-files on the updates connection, the compressed initial
send; 12,000 objects over TLS (the reference's read/write race on one
TLS connection, repaired in the port); and tests/test_asset_pipeline.py's scenarios on the port's
``MeshLODGenThread`` (``device="cpu"``), including an upload over
connection type 501 whose three ``.ktx2`` LODs are the reference's bytes.

Every socket test binds port 0 and bounds each wait with its own deadline
(``wait_for``)."""

import inspect
import struct
import threading
import time

import numpy as np
import pytest

from substrata_tpu.net import client as jclient
from substrata_tpu.net import protocol as JP
from substrata_tpu.net import server as jserver
from substrata_tpu.shared import texture_compress as jtc
from substrata_tpu.shared import world_object as jwo
from substrata_tpu_torch.net import client as tclient
from substrata_tpu_torch.net import protocol as P
from substrata_tpu_torch.net import server as tserver
from substrata_tpu_torch.net.snapshots import SnapshotRings
from substrata_tpu_torch.server_side.asset_pipeline import (
    ChunkGenThread, MeshLODGenThread, decode_image_bytes, generate_world_lod_chunks, pack_mesh,
    unpack_mesh)
from substrata_tpu_torch.shared import png
from substrata_tpu_torch.shared.avatar import Avatar
from substrata_tpu_torch.shared.lod import lod_model_url
from substrata_tpu_torch.shared.records import GearItem
from substrata_tpu_torch.shared.resources import ResourceManager
from substrata_tpu_torch.shared.texture_compress import lod_texture_url, read_ktx2
from substrata_tpu_torch.shared.world_object import DYNAMIC_FLAG, WorldObject

PLAIN = {"tls_context": None}


def wait_for(pred, timeout=10.0, interval=0.02):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(interval)
    return False


def obs_snapshot(c):
    ws = c.world_state
    with ws.lock:
        return dict(ws.objects)


def slot_of(c, uid):
    ws = c.world_state
    with ws.lock:
        return ws._slot_by_uid.get(uid)


# --- The protocol, byte for byte --------------------------------------------

def test_protocol_constants_equal():
    ours = {k: v for k, v in vars(P).items() if k.isupper() and isinstance(v, int)}
    ref = {k: v for k, v in vars(JP).items() if k.isupper() and isinstance(v, int)}
    assert ours == ref and len(ours) > 100


PACKERS = {
    "make_message": (1234, b"payload"),
    "pack_string": ("héllo wörld",),
    "pack_physics_transform_update": (7, [1.5, -2, 3], [0, 0, 0.6, 0.8], [1, 2, 3],
                                      [0.1, 0.2, 0.3], 12.25, 99),
    "pack_physics_ownership_taken": (7, 99, 12.5, 1),
    "pack_avatar_transform_update": (5, [1, 2, 3], [0.1, 0.2, 0.3], 4, 8, 1, 3),
    "pack_time_sync": (1234.5678,),
    "pack_chat_message": ("alice", "hello"),
    "pack_object_move_to": (3, 10.0, 2.5, 1, [0, 0, 0], [1, 2, 3]),
    "pack_object_rotate_to": (3, 10.0, 2.5, 1, [0, 0, 1], 0.5, [0, 1, 0], 1.5),
    "pack_summon_object": (3, [1, 2, 3], [0, 0, 1.5], 44),
    "pack_audio_stream_state": (5, 44100, 9),
    "pack_avatar_seat_change": (5, 6, 1),
    "pack_eth_transaction_request": (12, "0xabc"),
    "pack_builder_ai_user_message": ("build a tower",),
}


@pytest.mark.parametrize("name", sorted(PACKERS))
def test_message_builders_give_the_reference_bytes(name):
    args = PACKERS[name]
    ours, ref = getattr(P, name)(*args), getattr(JP, name)(*args)
    assert ours == ref
    unpack = "un" + name if name.startswith("pack_") else None
    if unpack and hasattr(P, unpack):
        extra = (0,) if name == "pack_string" else ()
        assert repr(getattr(P, unpack)(ours, *extra)) == repr(getattr(JP, unpack)(ref, *extra))


def test_every_builder_is_covered():
    names = {n for n, f in vars(JP).items()
             if inspect.isfunction(f) and (n.startswith("pack_") or n == "make_message")}
    assert names == set(PACKERS)


def test_message_reader_equal():
    stream = b"".join(P.make_message(t, bytes(range(t % 50))) for t in range(1, 40))
    ours, ref = P.MessageReader(), JP.MessageReader()
    out_ours, out_ref = [], []
    for i in range(0, len(stream), 7):
        ours.feed(stream[i:i + 7])
        ref.feed(stream[i:i + 7])
        out_ours += list(ours.messages())
        out_ref += list(ref.messages())
    assert out_ours == out_ref and len(out_ours) == 39


class _Recorder:
    def __init__(self):
        self.data = []

    def sendall(self, b):
        self.data.append(bytes(b))


class _Clock:
    def __init__(self):
        self.lock = threading.Lock()
        self.objects = {}

    def global_time(self):
        return 12.5


def _offline_client(cls):
    c = cls.__new__(cls)
    c.sock, c.send_lock, c.avatar_uid = _Recorder(), threading.Lock(), 77
    c.world_state, c.connected, c._ping_sent_at, c._io = _Clock(), True, {}, None
    return c


def _sender_calls(wo, av, gear):
    ob = wo.WorldObject(uid=5, model_url="m.glb", flags=3, pos=np.array([1.0, 2, 3]))
    return [
        ("send_login", ("alice", "pw")), ("send_perform_gesture", ("wave", "u", 1, 2.0)),
        ("send_stop_gesture", ()), ("send_select_object", (5, False)),
        ("send_object_flags_changed", (5, 9)), ("send_object_model_url_changed", (5, "x")),
        ("send_object_lightmap_url_changed", (5, "y")), ("send_change_world", ("moon",)),
        ("send_sign_up", ("a", "b", "c")), ("send_log_out", ()),
        ("send_create_object", (ob,)), ("send_object_full_update", (ob,)),
        ("send_destroy_object", (5,)),
        ("send_physics_snapshot", (5, [1, 2, 3], [0, 0, 0, 1], [1, 0, 0], [0, 0, 1])),
        ("send_ownership_taken", (5, 3.5)), ("send_avatar_created", (av,)),
        ("send_avatar_transform", ([1, 2, 3], [0, 0, 1], 2, 4, 1, 7)),
        ("send_chat", ("n", "m")), ("request_create_object", (ob,)),
        ("request_destroy_object", (5,)),
        ("send_object_move_to", (5, [4, 5, 6], 2.0, 1, [0, 0, 0])),
        ("send_summon_object", (5, [1, 1, 1], (0, 0, 1))), ("query_parcels", ()),
        ("query_map_tiles", ()), ("query_lod_chunks", ()),
        ("send_seat_change", (P.AVATAR_ENTERED_VEHICLE, 6, 1)),
        ("send_audio_stream_state", (True, 3, 44100)), ("query_user_gear", ()),
        ("send_create_gear_item", (gear,)), ("send_gear_action", (P.PICK_UP_GEAR_ITEM, 4)),
        ("submit_eth_transaction", (12, "0xabc")), ("send_builder_ai_message", ("hi",)),
        ("send_builder_ai_cancel", ()), ("send_ping", ()),
    ]


def test_client_senders_give_the_reference_bytes(monkeypatch):
    from substrata_tpu.shared import avatar as javatar
    from substrata_tpu.shared import records as jrecords
    import substrata_tpu_torch.shared.world_object as two
    # The ping carries the send time: make it the same on both sides.
    monkeypatch.setattr(time, "monotonic", lambda: 5.0)
    ours, ref = _offline_client(tclient.Client), _offline_client(jclient.Client)
    for (name, a), (_n, b) in zip(
            _sender_calls(two, Avatar(name="al"), GearItem(item_id=4, name="hat")),
            _sender_calls(jwo, javatar.Avatar(name="al"),
                          jrecords.GearItem(item_id=4, name="hat"))):
        getattr(ours, name)(*a)
        getattr(ref, name)(*b)
        assert ours.sock.data[-1] == ref.sock.data[-1], name
    assert len(ours.sock.data) == len(_sender_calls(two, None, None))


# --- The port's Server and Client over loopback ------------------------------

@pytest.fixture
def server(tmp_path):
    s = tserver.Server(port=0, udp_port=0, resource_dir=str(tmp_path / "res"), **PLAIN)
    s.start()
    yield s
    s.stop()


def connect(server, world="", **kw):
    c = tclient.Client("127.0.0.1", server.port, world_name=world, **{**PLAIN, **kw})
    c.start()
    return c


def test_handshake_and_time_sync_over_tls(tmp_path):
    s = tserver.Server(port=0, udp_port=0, resource_dir=str(tmp_path))
    s.start()
    try:
        c = tclient.Client("127.0.0.1", s.port)
        c.start()
        assert c.avatar_uid >= tserver.AVATAR_UID_BASE
        assert wait_for(lambda: c.world_state.time_sync.synced)
        c.send_ping()
        assert wait_for(lambda: c.world_state.time_sync.last_rtt > 0)
        c.stop()
    finally:
        s.stop()


def test_handshake_and_time_sync(server):
    c = connect(server)
    assert c.avatar_uid > 0
    assert wait_for(lambda: c.world_state.time_sync.synced)
    c.send_ping()
    assert wait_for(lambda: c.world_state.time_sync.last_rtt > 0)
    c.stop()


def test_reference_client_against_the_port_server(server):
    """The reference's Client and the port's Server speak one protocol."""
    a = connect(server)
    b = jclient.Client("127.0.0.1", server.port, tls_context=None)
    b.start()
    a.send_create_object(WorldObject(model_url="x.glb", flags=DYNAMIC_FLAG | 1,
                                     pos=np.array([1.0, 2, 3])))
    assert wait_for(lambda: len(obs_snapshot(b)) == 1)
    got = list(obs_snapshot(b).values())[0]
    assert got.model_url == "x.glb" and np.allclose(got.pos, [1, 2, 3])
    a.stop()
    b.stop()


def test_port_client_against_the_reference_server():
    s = jserver.Server(port=0, udp_port=0, tls_context=None)
    s.start()
    try:
        a = tclient.Client("127.0.0.1", s.port, tls_context=None)
        a.start()
        a.send_create_object(WorldObject(model_url="y.glb", flags=1))
        assert wait_for(lambda: len(obs_snapshot(a)) == 1)
        assert list(obs_snapshot(a).values())[0].model_url == "y.glb"
        a.stop()
    finally:
        s.stop()


def test_object_create_replicates(server):
    a = connect(server)
    b = connect(server)
    a.send_create_object(WorldObject(model_url="cube.glb", flags=DYNAMIC_FLAG | 1,
                                     pos=np.array([1, 2, 3.0])))
    assert wait_for(lambda: len(obs_snapshot(b)) == 1)
    got = list(obs_snapshot(b).values())[0]
    assert got.model_url == "cube.glb" and np.allclose(got.pos, [1, 2, 3]) and got.uid > 0
    c = connect(server)                                  # a late joiner
    assert wait_for(lambda: len(obs_snapshot(c)) == 1)
    for cl in (a, b, c):
        cl.stop()


def test_physics_snapshot_roundtrip(server):
    a = connect(server)
    b = connect(server)
    a.send_create_object(WorldObject(flags=DYNAMIC_FLAG | 1))
    assert wait_for(lambda: len(obs_snapshot(a)) == 1)
    uid = list(obs_snapshot(a))[0]
    assert wait_for(lambda: uid in obs_snapshot(b))
    a.send_ownership_taken(uid, a.world_state.global_time())
    for i in range(5):
        a.send_physics_snapshot(uid, [i * 1.0, 0, 1], [0, 0, 0, 1], [1, 0, 0], [0, 0, 0])
        time.sleep(0.12)

    def b_has_snapshots():
        slot = slot_of(b, uid)
        return slot is not None and b.world_state.snapshots.next_i[slot] >= 4
    assert wait_for(b_has_snapshots)
    slot_a = slot_of(a, uid)
    if slot_a is not None:
        assert a.world_state.snapshots.next_i[slot_a] == 0       # no echo to the owner
    assert b.world_state.ownership.owner_id[slot_of(b, uid)] == a.avatar_uid
    a.stop()
    b.stop()


def test_static_object_rejects_physics_updates(server):
    a = connect(server)
    a.send_create_object(WorldObject(flags=1))           # collidable, not dynamic
    assert wait_for(lambda: len(obs_snapshot(a)) == 1)
    uid = list(obs_snapshot(a))[0]
    a.send_physics_snapshot(uid, [9, 9, 9], [0, 0, 0, 1], [0, 0, 0], [0, 0, 0])
    # A marker after the snapshot: once the server has it, it has read the
    # snapshot too (one connection, in order).
    a.send_create_object(WorldObject(model_url="marker.glb", flags=1))

    def server_has_marker():
        with server.worlds_state.lock:
            return any(o.model_url == "marker.glb"
                       for o in server.worlds_state.get_world("").objects.values())
    assert wait_for(server_has_marker)
    with server.worlds_state.lock:
        assert not np.allclose(server.worlds_state.get_world("").objects[uid].pos, [9, 9, 9])
    a.stop()


def test_resource_upload_download_roundtrip(server, tmp_path):
    b = connect(server)
    data = b"BMESH" + bytes(range(256)) * 8
    assert tclient.upload_resource("127.0.0.1", server.port, "chair_abc123.glb", data,
                                   **PLAIN) == P.UPLOAD_ALLOWED
    heard = []
    assert wait_for(lambda: (heard.extend(b.pop_events().new_resources),
                             "chair_abc123.glb" in heard)[1])
    rm = ResourceManager(str(tmp_path / "client_b_res"))
    dl = tclient.ResourceDownloader("127.0.0.1", server.port, rm, **PLAIN)
    out = dl.fetch(["chair_abc123.glb", "missing.glb"])
    dl.close()
    assert out["chair_abc123.glb"] == data and out["missing.glb"] is None
    assert rm.load_resource("chair_abc123.glb") == data
    b.stop()


def test_upload_rejections(server):
    up = tclient.upload_resource
    assert up("127.0.0.1", server.port, "evil.exe", b"x", **PLAIN) == P.INVALID_FILE_TYPE
    server.read_only = True
    try:
        assert (up("127.0.0.1", server.port, "ok.glb", b"x", **PLAIN)
                == P.SERVER_IS_IN_READ_ONLY_MODE)
    finally:
        server.read_only = False
    big = tserver.Server.MAX_UPLOAD_BYTES + 1
    sock = tclient._resource_handshake("127.0.0.1", server.port,
                                       P.CONNECTION_TYPE_UPLOAD_RESOURCE, "", None)
    try:
        sock.sendall(struct.pack("<I", 5) + b"a.png" + struct.pack("<II", 0, big))
        assert struct.unpack("<I", sock.recv(4))[0] == P.INVALID_FILE_SIZE
    finally:
        sock.close()


def test_get_files_on_updates_connection(server):
    tclient.upload_resource("127.0.0.1", server.port, "tone.mp3", b"\xff\xfbsome", **PLAIN)
    a = connect(server)
    assert a.download_files(["tone.mp3"])["tone.mp3"] == b"\xff\xfbsome"
    a.stop()


def test_compressed_initial_send(server):
    a = connect(server)
    for _ in range(10):
        a.send_create_object(WorldObject(flags=1))
    assert wait_for(lambda: len(obs_snapshot(a)) >= 10)
    b = connect(server, capabilities=P.STREAMING_COMPRESSED_OBJECT_SUPPORT)
    assert wait_for(lambda: len(obs_snapshot(b)) >= 10)
    c = connect(server, capabilities=0)
    assert wait_for(lambda: len(obs_snapshot(c)) >= 10)
    for cl in (a, b, c):
        cl.stop()


def test_unported_connection_paths_raise(server):
    w = tserver.WorkerConnection(server, None, None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        w._builder_ai()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        w._handle_eth_submit(b"")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        w._handle_photo_upload_connection()


def test_snapshot_ring_interpolation():
    rings = SnapshotRings(8)
    for i in range(4):
        rings.insert_snapshot(0, [i * 1.0, 0, 0], [0, 0, 0, 1], [10, 0, 0], [0, 0, 0],
                              client_time=i * 0.1, local_time=i * 0.1, physics=False)
    pos, _ = rings.interpolated_transforms(np.array([0]), 0.45)
    assert abs(pos[0, 0] - 2.5) < 1e-5


# --- The asset pipeline (tests/test_asset_pipeline.py's scenarios) -----------

def grid_mesh(n=16):
    xs, ys = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n), indexing="ij")
    verts = np.stack([xs.ravel(), ys.ravel(), np.zeros(n * n)], axis=1).astype(np.float32)
    tris = []
    for i in range(n - 1):
        for j in range(n - 1):
            v = i * n + j
            tris += [[v, v + n, v + 1], [v + 1, v + n, v + n + 1]]
    tris = np.array(tris, np.int32)
    return verts, tris, np.zeros(len(tris), np.int32)


def test_mesh_container_equal():
    from substrata_tpu.server_side import asset_pipeline as jap
    v, t, m = grid_mesh(4)
    assert pack_mesh(v, t, m) == jap.pack_mesh(v, t, m)
    for a, b in zip(unpack_mesh(pack_mesh(v, t, m)), (v, t, m)):
        np.testing.assert_array_equal(a, b)


def _drain(worker, n, timeout=60.0):
    worker.start()
    assert wait_for(lambda: len(worker.generated) >= n or worker.errors, timeout)
    worker.stop()
    assert worker.errors == []


def test_lod_gen_thread_meshes_equal(tmp_path):
    from substrata_tpu.shared import lod as jlod
    rm = ResourceManager(str(tmp_path))
    v, t, m = grid_mesh(16)
    rm.store_resource("house.stme", pack_mesh(v, t, m))
    worker = MeshLODGenThread(rm, device="cpu")
    worker.enqueue("house.stme")
    _drain(worker, 2)
    ref = jlod.generate_lod_meshes(v, t, m)
    for level in (1, 2):
        got = unpack_mesh(rm.load_resource(lod_model_url("house.stme", level)))
        for a, b in zip(got, ref[level]):
            np.testing.assert_array_equal(a, b)


def test_texture_lod_gen_thread(tmp_path):
    rm = ResourceManager(str(tmp_path))
    img = np.random.default_rng(0).integers(0, 256, (300, 512, 3), np.uint8)
    rm.store_resource("wall.png", png.write_png(img))
    worker = MeshLODGenThread(rm, device="cpu")
    worker.enqueue_texture("wall.png")
    _drain(worker, 3)
    meta0, lv0 = read_ktx2(rm.load_resource(lod_texture_url("wall.png", 0)))
    assert (meta0["width"], meta0["height"]) == (512, 300)
    meta1, _ = read_ktx2(rm.load_resource(lod_texture_url("wall.png", 1)))
    assert (meta1["width"], meta1["height"]) == (256, 152)
    meta2, _ = read_ktx2(rm.load_resource(lod_texture_url("wall.png", 2)))
    assert (meta2["width"], meta2["height"]) == (64, 40)
    assert len(lv0[0]) == (512 // 4) * (300 // 4) * 8


def test_server_upload_produces_the_reference_ktx2(tmp_path):
    """An image uploaded over connection type 501 to a server with the LOD
    thread attached becomes three .ktx2 resources, each the reference's
    generate_compressed_texture bytes of the same image."""
    server = tserver.Server(port=0, udp_port=0, resource_dir=str(tmp_path), **PLAIN)
    server.lod_gen = MeshLODGenThread(server.resources, device="cpu")
    server.lod_gen.start()
    server.start()
    try:
        y, x = np.mgrid[0:96, 0:320]
        img = np.stack([x % 256, y * 2, (x + y) % 256], axis=-1).astype(np.uint8)
        data = png.write_png(img, filter_type=2)
        assert tclient.upload_resource("127.0.0.1", server.port, "mural.png", data,
                                       **PLAIN) == P.UPLOAD_ALLOWED
        assert wait_for(lambda: len(server.lod_gen.generated) >= 3
                        or server.lod_gen.errors, 60.0)
        assert server.lod_gen.errors == []
        for level in (0, 1, 2):
            got = server.resources.load_resource(lod_texture_url("mural.png", level))
            assert got == jtc.generate_compressed_texture(img, lod_level=level)
    finally:
        server.stop()
        server.lod_gen.stop()


def test_decode_image_bytes_png_without_pillow(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow")
        return real(name, *a, **k)
    img = np.random.default_rng(1).integers(0, 256, (9, 13, 3), np.uint8)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    np.testing.assert_array_equal(decode_image_bytes(png.write_png(img)), img)
    with pytest.raises(RuntimeError, match="JPEG needs Pillow"):
        decode_image_bytes(b"\xff\xd8\xff\xe0rest")


def test_chunk_gen_thread(tmp_path):
    rm = ResourceManager(str(tmp_path))
    v, t, m = grid_mesh(8)
    rm.store_resource("a.stme", pack_mesh(v, t, m))
    rm.store_resource("b.stme", pack_mesh(v, t, m))
    worker = ChunkGenThread(rm)
    m2 = np.eye(4, dtype=np.float32)
    m2[0, 3] = 10.0
    worker.enqueue("main", (0, 0), [("a.stme", np.eye(4, dtype=np.float32)),
                                    ("b.stme", m2)])
    _drain(worker, 1)
    cv, ct, _ = unpack_mesh(rm.load_resource(worker.generated[0]))
    assert cv[:, 0].max() > 10.0 and len(ct) < 2 * len(t)


def test_generate_world_lod_chunks(tmp_path):
    rm = ResourceManager(str(tmp_path))
    v, t, m = grid_mesh(8)
    rm.store_resource("house.stme", pack_mesh(v, t, m))
    ws = tserver.ServerAllWorldsState()
    with ws.lock:
        w = ws.get_world("")
        for i, x in enumerate([5.0, 20.0, 130.0]):
            ob = WorldObject(uid=i + 1, model_url="house.stme", pos=np.array([x, 10.0, 0.0]))
            w.objects[ob.uid] = ob
    chunks = generate_world_lod_chunks(ws, rm)
    assert {(c.x, c.y) for c in chunks} == {(0, 0), (1, 0)}
    cv, _, _ = unpack_mesh(rm.load_resource(ws.lod_chunks[("", 1, 0)].mesh_url))
    assert len(cv) > 0 and cv[:, 0].min() >= 129.0


def test_mesh_lod_thread_defaults_to_the_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        MeshLODGenThread(ResourceManager(str(tmp_path)))


def test_tls_connection_read_and_written_at_once(tmp_path):
    """12,000 objects created over TLS replicate to a second client.  Each
    connection is read by one thread while others write it; the
    reference's server and client let those overlap on one SSL object,
    which OpenSSL does not allow, and the connection died after a few
    hundred to a few thousand objects.  The port serialises them
    (net/tls.py:DuplexTLS)."""
    from substrata_tpu_torch import benchworld
    s = tserver.Server(port=0, udp_port=0, resource_dir=str(tmp_path))
    s.start()
    try:
        a = tclient.Client("127.0.0.1", s.port)
        a.start()
        for pos in benchworld.mesh_layout(12_000, 512):
            a.send_create_object(WorldObject(model_url="cube.bmesh", flags=1, pos=pos))
        b = tclient.Client("127.0.0.1", s.port)
        b.start()
        assert wait_for(lambda: b.world_state.num_objects() == 12_000
                        and a.world_state.num_objects() == 12_000, 60.0)
        assert a.connected and b.connected
        a.stop()
        b.stop()
    finally:
        s.stop()
