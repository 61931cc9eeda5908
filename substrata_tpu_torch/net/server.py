"""The game server.

Parity with server/Server.cpp + server/WorkerThread.cpp +
server/ServerWorldState.cpp:

- ListenerThread accepts TCP connections on the game port (7600 default)
  and spawns a worker per connection (ListenerThread.cpp).
- Each worker does the hello/version/connection-type handshake then
  dispatches every client->server message; ObjectPhysicsTransformUpdate is
  guarded to dynamic objects, stores state + client time + sender and marks
  the object dirty (WorkerThread.cpp:1968-2039); ObjectPhysicsOwnershipTaken
  is stored and rebroadcast (2237-2264); ObjectFullUpdate checks write
  permissions (2040-2090) and clamps audio volume.
- The main loop ticks every 100 ms (Server.cpp:626-628): drains worker
  messages, broadcasts dirty avatars and objects to every connection
  (875-1050), sends periodic TimeSync (9000), and flushes the record DB.
- ServerAllWorldsState holds many named worlds, each with object/avatar/
  parcel maps + dirty sets behind one lock, persisted via an append-only
  record database (ServerWorldState.cpp:132-353 load/save model).
- A UDP thread relays voice packets (type 1) to every registered client and
  learns client endpoints from discovery packets (type 2)
  (UDPHandlerThread.cpp:55-95).

A copy of ``substrata_tpu/net/server.py`` with the port's imports: importing
any module of the reference package loads jax, so the port keeps its own.
The server holds no tensors; an attached ``MeshLODGenThread`` encodes
uploaded textures on its own device.  What the port's path does not reach
raises NotImplementedError naming ROADMAP.md queue 1, item 8: photo
uploads (connection type 506, commerce records), parcel-NFT transaction
submission (ethereum) and BuilderAI sessions.  Uploads are read into a
bytearray (the reference concatenates bytes, quadratic in the size).  A
TLS connection is read and written through ``tls.DuplexTLS``: the
reference's worker reads its TLS socket (:265-280) while broadcasts write
it under a lock that guards only the writes (:244-248), which OpenSSL does
not allow; under a 12,000-object load the read fails and the connection
closes.  The wire bytes are the reference's.
"""

from __future__ import annotations

import io
import os
import socket
import ssl
import struct
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from substrata_tpu_torch.net import protocol as P
from substrata_tpu_torch.net import tls
from substrata_tpu_torch.shared import guarded
from substrata_tpu_torch.shared.avatar import Avatar
from substrata_tpu_torch.shared.parcel import Parcel
from substrata_tpu_torch.shared.world_object import WorldObject, DYNAMIC_FLAG

_NOT_PORTED_ITEM = "ROADMAP.md queue 1, item 8: the server's web and commerce services"


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet ({_NOT_PORTED_ITEM})")


AVATAR_UID_BASE = 1 << 24  # ephemeral avatar ids disjoint from UserIDs

SERVER_TICK = 0.1          # Server.cpp:626-628
TIME_SYNC_PERIOD = 2.0
DB_FLUSH_PERIOD = 10.0
DEFAULT_PORT = 7600
DEFAULT_UDP_PORT = 7601    # UDPHandlerThread.cpp:16


class RecordDatabase:
    """Append-only keyed record store (glare-core Database parity: the
    world checkpoint — ServerWorldState persistence).  Records are
    [u32 klen][key][u32 dlen][data]; later records override earlier ones;
    dlen = 0xFFFFFFFF tombstones a key; flush() compacts."""

    MAGIC = b"STDB0001"

    def __init__(self, path: str | None):
        self.path = path
        self.records: dict[bytes, bytes] = {}
        self._dirty = False
        if path and os.path.exists(path):
            self._load()

    def _load(self):
        with open(self.path, "rb") as f:
            data = f.read()
        if data[:8] != self.MAGIC:
            raise ValueError("bad database magic")
        off = 8
        while off + 8 <= len(data):
            (klen,) = struct.unpack_from("<I", data, off)
            off += 4
            key = data[off:off + klen]
            off += klen
            (dlen,) = struct.unpack_from("<I", data, off)
            off += 4
            if dlen == 0xFFFFFFFF:
                self.records.pop(key, None)
            else:
                self.records[key] = data[off:off + dlen]
                off += dlen

    def put(self, key: bytes, data: bytes):
        self.records[key] = data
        self._dirty = True

    def delete(self, key: bytes):
        self.records.pop(key, None)
        self._dirty = True

    def get(self, key: bytes):
        return self.records.get(key)

    def keys_with_prefix(self, prefix: bytes):
        return [k for k in self.records if k.startswith(prefix)]

    def flush(self):
        if not self.path or not self._dirty:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(self.MAGIC)
            for k, v in self.records.items():
                f.write(struct.pack("<I", len(k)))
                f.write(k)
                f.write(struct.pack("<I", len(v)))
                f.write(v)
        os.replace(tmp, self.path)
        self._dirty = False


@dataclass(eq=False)
class ServerWorldState:
    """One named world (server/ServerWorldState.h)."""

    name: str = ""
    objects: dict = field(default_factory=dict)   # uid -> WorldObject
    avatars: dict = field(default_factory=dict)   # uid -> Avatar
    parcels: dict = field(default_factory=dict)   # id -> Parcel
    settings: object = None                       # WorldSettings | None
    dirty_objects: set = field(default_factory=set)
    dirty_physics_objects: set = field(default_factory=set)
    dirty_avatars: set = field(default_factory=set)
    destroyed_objects: set = field(default_factory=set)
    db_dirty_objects: set = field(default_factory=set)

    def _guard_with(self, lock):
        """GUARDED_BY(all-worlds lock) for every container (checked only
        when SUBSTRATA_LOCK_CHECKS=1; see shared/guarded.py)."""
        for f in ("objects", "avatars", "parcels", "dirty_objects",
                  "dirty_physics_objects", "dirty_avatars",
                  "destroyed_objects", "db_dirty_objects"):
            setattr(self, f, guarded.guard(
                getattr(self, f), lock, f"ServerWorldState.{f}"))
        return self


class ServerAllWorldsState:
    """server/ServerWorldState.h ServerAllWorldsState: many named worlds,
    a record database, next-UID allocation, feature flags."""

    def __init__(self, db_path: str | None = None):
        # One mutex for all worlds (ServerWorldState.h semantics); GUARDED_BY
        # discipline checked when SUBSTRATA_LOCK_CHECKS=1 (shared/guarded.py).
        self.lock = guarded.make_lock("ServerAllWorldsState.lock")
        self.worlds: dict[str, ServerWorldState] = guarded.guard(
            {"": ServerWorldState(name="")._guard_with(self.lock)},
            self.lock, "ServerAllWorldsState.worlds")
        self.db = RecordDatabase(db_path)
        self.next_uid = 1
        # Avatar uids allocate from a base ABOVE any plausible account
        # UserID: both id kinds land in the same u32 fields (creator_id,
        # physics ownership), and an anonymous connection's avatar uid must
        # never alias a logged-in account (found by an end-to-end drive:
        # anonymous avatar 2 aliased account user 2).
        self.next_avatar_uid = AVATAR_UID_BASE + 1
        self.feature_flags = {"SERVER_SCRIPT_EXEC": True, "LUA_HTTP_REQUESTS": False}
        # Admin-settable site state (Server.cpp:1142 server_admin_message;
        # WorkerThread.cpp:1991 read-only mode).
        self.server_admin_message = ""
        self.read_only_mode = False
        # World metadata for the web world list (shared/WorldDetails.h).
        self.world_details: dict[str, object] = {}
        # Combined-LOD chunk records per world (shared/LODChunk.h).
        self.lod_chunks: dict[tuple, object] = {}
        self._load_from_db()

    def get_world(self, name: str = "") -> ServerWorldState:
        with self.lock:
            if name not in self.worlds:
                self.worlds[name] = ServerWorldState(
                    name=name)._guard_with(self.lock)
            return self.worlds[name]

    def alloc_uid(self) -> int:
        with self.lock:
            uid = self.next_uid
            self.next_uid += 1
            return uid

    def _load_from_db(self):
        with self.lock:
            for key in self.db.keys_with_prefix(b"ob/"):
                _, wname, uid = key.split(b"/", 2)
                ob = WorldObject.from_bytes(self.db.get(key))
                w = self.get_world(wname.decode())
                w.objects[ob.uid] = ob
                self.next_uid = max(self.next_uid, ob.uid + 1)
            for key in self.db.keys_with_prefix(b"parcel/"):
                _, wname, pid = key.split(b"/", 2)
                p = Parcel.from_bytes(self.db.get(key))
                self.get_world(wname.decode()).parcels[p.parcel_id] = p

    def save_dirty(self):
        with self.lock:
            for w in self.worlds.values():
                for uid in list(w.db_dirty_objects):
                    ob = w.objects.get(uid)
                    key = b"ob/" + w.name.encode() + b"/" + str(uid).encode()
                    if ob is None:
                        self.db.delete(key)
                    else:
                        self.db.put(key, ob.to_bytes())
                w.db_dirty_objects.clear()
            self.db.flush()


class WorkerConnection(threading.Thread):
    """Per-connection protocol endpoint (server/WorkerThread parity)."""

    def __init__(self, server: "Server", sock: socket.socket, addr,
                 tls_context=None):
        super().__init__(daemon=True)
        self.server = server
        self.sock = sock
        self.addr = addr
        self._tls_context = tls_context
        self.send_lock = threading.Lock()
        self.avatar_uid = 0
        # Account identity from a web session cookie (websocket connections
        # only, WorkerThread.cpp:183-187); 0 = anonymous, identity falls
        # back to the per-connection avatar uid.
        self.logged_in_user_id = 0
        self.world_name = ""
        self.udp_endpoint = None
        self.alive = True
        self.capabilities = 0
        self._builder_session = None
        self._io = None          # tls.DuplexTLS once a TLS connection is read

    def send_message(self, data: bytes):
        try:
            with self.send_lock:
                io = self._io
                if io is None:
                    self.sock.sendall(data)
                    return
            io.sendall(data)
        except OSError:
            self.alive = False

    @property
    def effective_user_id(self) -> int:
        return self.logged_in_user_id or self.avatar_uid

    def run(self):
        try:
            if self._tls_context is not None:
                # TLS handshake on the worker thread, AFTER accept — the
                # reference does exactly this (ListenerThread.cpp accepts,
                # then hands the socket to a TLSSocket handshake), so a
                # slow/handshake-stalling peer never blocks the accept loop.
                try:
                    self.sock = self._tls_context.wrap_socket(
                        self.sock, server_side=True)
                except (ssl.SSLError, OSError):
                    return
            self._handshake()
            reader = P.MessageReader()
            if isinstance(self.sock, ssl.SSLSocket):
                self._io = tls.DuplexTLS(self.sock, self.send_lock)
                read = lambda: self._io.recv(65536, 0.5)      # noqa: E731
            else:
                self.sock.settimeout(0.5)
                read = lambda: self.sock.recv(65536)          # noqa: E731
            while self.alive and self.server.running:
                try:
                    data = read()
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not data:
                    break
                reader.feed(data)
                for msg_type, payload in reader.messages():
                    self._dispatch(msg_type, payload)
        except (ConnectionError, ValueError, struct.error):
            pass
        finally:
            self.alive = False
            self.server.connection_closed(self)
            try:
                self.sock.close()
            except OSError:
                pass

    def _recv_exact(self, n):
        # A bytearray grows in amortised constant time per byte, where the
        # reference's ``bytes +=`` copies the whole buffer for each read
        # (quadratic in an upload of tens of MB).
        buf = bytearray()
        while len(buf) < n:
            d = self.sock.recv(min(n - len(buf), 1 << 20))
            if not d:
                raise ConnectionError("eof in handshake")
            buf += d
        return bytes(buf)

    def _handshake(self):
        """hello + version + connection type (Protocol.h:57-76;
        WorkerThread handshake + connection-type dispatch: updates /
        upload-resource 501 / download-resources 502)."""
        hello, version = struct.unpack("<II", self._recv_exact(8))
        if hello != P.CYBERSPACE_HELLO:
            raise ValueError("bad hello")
        if version < P.CYBERSPACE_PROTOCOL_VERSION:
            self.sock.sendall(struct.pack("<I", P.CLIENT_PROTOCOL_TOO_OLD))
            raise ValueError("client protocol too old")
        self.sock.sendall(struct.pack("<II", P.CLIENT_PROTOCOL_OK,
                                      P.CYBERSPACE_PROTOCOL_VERSION))
        (conn_type,) = struct.unpack("<I", self._recv_exact(4))
        (caps,) = struct.unpack("<I", self._recv_exact(4))
        self.capabilities = caps
        (nlen,) = struct.unpack("<I", self._recv_exact(4))
        self.world_name = self._recv_exact(nlen).decode() if nlen else ""
        self.conn_type = conn_type
        if conn_type == P.CONNECTION_TYPE_UPLOAD_RESOURCE:
            self._handle_upload_connection()
            self.alive = False
            return
        if conn_type == P.CONNECTION_TYPE_UPLOAD_PHOTO:
            self._handle_photo_upload_connection()
            self.alive = False
            return
        if conn_type == P.CONNECTION_TYPE_DOWNLOAD_RESOURCES:
            # Served by the normal message loop (GetFile/GetFiles handlers);
            # no avatar, no broadcasts, no initial world push.
            return
        # Updates connection: assign avatar uid + initial state push.  The
        # increment is read-modify-write, so it needs the lock (two clients
        # handshaking concurrently must not share an avatar uid).
        with self.server.worlds_state.lock:
            self.avatar_uid = self.server.worlds_state.next_avatar_uid
            self.server.worlds_state.next_avatar_uid += 1
        self.sock.sendall(struct.pack("<Q", self.avatar_uid))
        self.server.register_connection(self)
        self._send_initial_objects()
        self.send_message(P.make_message(P.TIME_SYNC_MESSAGE,
                                         P.pack_time_sync(self.server.global_time())))

    def _handle_upload_connection(self):
        """UploadResourceThread counterpart: one resource per connection —
        metadata, permission checks (UploadAllowed / error ids,
        Protocol.h:173-178), then the payload."""
        # Read metadata: url + flags + size.
        (ulen,) = struct.unpack("<I", self._recv_exact(4))
        url = self._recv_exact(ulen).decode("utf-8")
        (flags, size) = struct.unpack("<II", self._recv_exact(8))
        ext = os.path.splitext(url)[1].lower()
        if self.server.read_only:
            self.sock.sendall(struct.pack("<I", P.SERVER_IS_IN_READ_ONLY_MODE))
            return
        if size > self.server.MAX_UPLOAD_BYTES:
            self.sock.sendall(struct.pack("<I", P.INVALID_FILE_SIZE))
            return
        if ext not in self.server.ALLOWED_UPLOAD_EXTS:
            self.sock.sendall(struct.pack("<I", P.INVALID_FILE_TYPE))
            return
        self.sock.sendall(struct.pack("<I", P.UPLOAD_ALLOWED))
        data = self._recv_exact(size)
        self.server.resources.store_resource(url, data)
        # Kick compressed-texture LOD generation for image uploads
        # (Server.cpp enqueues to MeshLODGenThread on new resources).
        if self.server.lod_gen is not None:
            from substrata_tpu_torch.server_side.asset_pipeline import IMAGE_EXTS
            if ext in IMAGE_EXTS:
                self.server.lod_gen.enqueue_texture(url)
        # Tell every updates client the resource exists now
        # (NewResourceOnServer broadcast, Server.cpp new-resource path).
        self.server.broadcast(self.world_name,
                              P.make_message(P.NEW_RESOURCE_ON_SERVER,
                                             P.pack_string(url)))
        self.sock.sendall(struct.pack("<I", P.UPLOAD_ALLOWED))

    def _handle_photo_upload_connection(self):
        """ConnectionTypeUploadPhoto (506): photos are commerce records that
        the web pages browse; not on the port's path yet."""
        _not_ported("photo uploads (server_side/commerce.py and the webserver)")

    def _send_initial_objects(self):
        """ObjectInitialSend for every object (cell-query streaming is
        handled by QueryObjects; initial world push for small worlds).
        Clients advertising STREAMING_COMPRESSED_OBJECT_SUPPORT get ONE
        zlib-compressed batch (ObjectInitialSendCompressed, Protocol.h:137)
        instead of per-object messages."""
        w = self.server.worlds_state.get_world(self.world_name)
        with self.server.worlds_state.lock:
            obs = list(w.objects.values())
            parcels = list(w.parcels.values())
            avatars = list(w.avatars.values())
        if obs and (self.capabilities & P.STREAMING_COMPRESSED_OBJECT_SUPPORT):
            import zlib
            blob = io.BytesIO()
            blob.write(struct.pack("<I", len(obs)))
            for ob in obs:
                b = ob.to_bytes()
                blob.write(struct.pack("<I", len(b)))
                blob.write(b)
            self.send_message(P.make_message(
                P.OBJECT_INITIAL_SEND_COMPRESSED,
                zlib.compress(blob.getvalue(), level=1)))
        else:
            for ob in obs:
                self.send_message(P.make_message(P.OBJECT_INITIAL_SEND, ob.to_bytes()))
        for p in parcels:
            self.send_message(P.make_message(P.PARCEL_CREATED, p.to_bytes()))
        for av in avatars:
            self.send_message(P.make_message(P.AVATAR_IS_HERE, av.to_bytes()))
        if w.settings is not None:
            self.send_message(P.make_message(
                P.WORLD_SETTINGS_INITIAL_SEND_MESSAGE, w.settings.to_bytes()))

    def _send_file(self, url: str):
        """GetFile response: url + found flag + payload (DownloadResources
        serving path; reference streams over connection type 502)."""
        rm = self.server.resources
        if rm.is_file_present(url):
            data = rm.load_resource(url)
            body = P.pack_string(url) + struct.pack("<BI", 1, len(data)) + data
        else:
            body = P.pack_string(url) + struct.pack("<BI", 0, 0)
        self.send_message(P.make_message(P.GET_FILE, body))

    # ------------------------------------------------------------------
    def _dispatch(self, msg_type: int, payload: bytes):
        ws = self.server.worlds_state
        w = ws.get_world(self.world_name)
        if msg_type == P.OBJECT_PHYSICS_TRANSFORM_UPDATE:
            uid, pos, quat, linvel, angvel, ct, sender = \
                P.unpack_physics_transform_update(payload)
            with ws.lock:
                ob = w.objects.get(uid)
                # Dynamic-only guard (WorkerThread.cpp:1968-2039).
                if ob is not None and ob.is_dynamic() and not self.server.read_only:
                    ob.pos = pos.astype(np.float64)
                    ob.set_rotation_quat(quat)
                    ob.linear_vel = linvel
                    ob.angular_vel = angvel
                    ob.last_transform_client_time = ct
                    ob.last_transform_update_avatar_uid = self.avatar_uid
                    ob.from_remote_physics_transform_dirty = True
                    w.dirty_physics_objects.add(uid)
                    w.db_dirty_objects.add(uid)
        elif msg_type == P.OBJECT_PHYSICS_OWNERSHIP_TAKEN:
            uid, owner, t, flags = P.unpack_physics_ownership_taken(payload)
            with ws.lock:
                ob = w.objects.get(uid)
                if ob is not None:
                    ob.physics_owner_id = owner
                    ob.last_physics_ownership_change_global_time = t
                    w.db_dirty_objects.add(uid)
            # Rebroadcast to other clients (WorkerThread.cpp:2237-2264).
            self.server.broadcast(self.world_name,
                                  P.make_message(msg_type, payload), exclude=self)
        elif msg_type == P.OBJECT_CREATED:
            ob = WorldObject.from_bytes(payload)
            with ws.lock:
                if ob.uid == 0:
                    ob.uid = ws.alloc_uid()
                ob.creator_id = self.effective_user_id
                w.objects[ob.uid] = ob
                w.dirty_objects.add(ob.uid)
                w.db_dirty_objects.add(ob.uid)
        elif msg_type == P.OBJECT_FULL_UPDATE:
            ob_new = WorldObject.from_bytes(payload)
            with ws.lock:
                ob = w.objects.get(ob_new.uid)
                if ob is not None and self.server.user_has_object_write_perms(
                        self.effective_user_id, ob, w):
                    # Audio volume clamp (WorkerThread.cpp:2040-2090).
                    ob_new.audio_volume = float(np.clip(ob_new.audio_volume, 0.0, 4.0))
                    ob_new.physics_object = ob.physics_object
                    w.objects[ob_new.uid] = ob_new
                    w.dirty_objects.add(ob_new.uid)
                    w.db_dirty_objects.add(ob_new.uid)
        elif msg_type == P.OBJECT_DESTROYED:
            (uid,) = struct.unpack("<Q", payload[:8])
            with ws.lock:
                ob = w.objects.get(uid)
                if ob is not None and self.server.user_has_object_write_perms(
                        self.effective_user_id, ob, w):
                    del w.objects[uid]
                    w.destroyed_objects.add(uid)
                    w.db_dirty_objects.add(uid)
        elif msg_type == P.AVATAR_CREATED or msg_type == P.AVATAR_FULL_UPDATE:
            av = Avatar.from_bytes(payload)
            av.uid = self.avatar_uid
            with ws.lock:
                w.avatars[av.uid] = av
                w.dirty_avatars.add(av.uid)
            if msg_type == P.AVATAR_CREATED:
                self.server.broadcast(
                    self.world_name,
                    P.make_message(P.AVATAR_CREATED, av.to_bytes()), exclude=self)
        elif msg_type == P.AVATAR_TRANSFORM_UPDATE:
            (uid, pos, rot, anim, veh_uid, seat, bitflags) = \
                P.unpack_avatar_transform_update(payload)
            with ws.lock:
                av = w.avatars.get(self.avatar_uid)
                if av is not None:
                    av.pos = pos.astype(np.float64)
                    av.rotation = rot
                    av.anim_state = anim
                    av.entered_vehicle_uid = veh_uid
                    av.vehicle_seat_index = seat
                    av.last_physics_input_bitflags = bitflags
                    w.dirty_avatars.add(av.uid)
        elif msg_type == P.CHAT_MESSAGE_ID:
            name, msg = P.unpack_chat_message(payload)
            self.server.broadcast(self.world_name,
                                  P.make_message(P.CHAT_MESSAGE_ID,
                                                 P.pack_chat_message(name, msg)))
        elif msg_type == P.QUERY_OBJECTS or msg_type == P.QUERY_OBJECTS_IN_AABB:
            self._send_initial_objects()
        elif msg_type == P.GET_FILE:
            url, _ = P.unpack_string(payload, 0)
            self._send_file(url)
        elif msg_type == P.GET_FILES:
            (count,) = struct.unpack_from("<I", payload, 0)
            off = 4
            for _ in range(min(count, 4096)):
                url, off = P.unpack_string(payload, off)
                self._send_file(url)
        elif msg_type in (P.AVATAR_PERFORM_GESTURE, P.AVATAR_STOP_GESTURE):
            # Gesture playback relay (WorkerThread.cpp:1481-1547): record the
            # gesture on the avatar (late joiners get it re-sent with the
            # avatar state) and rebroadcast to everyone else.
            w = self.server.worlds_state.get_world(self.world_name)
            (av_uid,) = struct.unpack_from("<Q", payload, 0)
            with self.server.worlds_state.lock:
                av = w.avatars.get(av_uid)
                if av is not None:
                    if msg_type == P.AVATAR_PERFORM_GESTURE:
                        name, _ = P.unpack_string(payload, 8)
                        av.performing_gesture = name
                    else:
                        av.performing_gesture = ""
            self.server.broadcast(self.world_name,
                                  P.make_message(msg_type, payload),
                                  exclude=self)
        elif msg_type in (P.USER_SELECTED_OBJECT, P.USER_DESELECTED_OBJECT):
            # Selection-highlight relay (WorkerThread: pure rebroadcast).
            self.server.broadcast(self.world_name,
                                  P.make_message(msg_type, payload),
                                  exclude=self)
        elif msg_type in (P.OBJECT_FLAGS_CHANGED, P.OBJECT_MODEL_URL_CHANGED,
                          P.OBJECT_LIGHTMAP_URL_CHANGED):
            # Partial object updates (Protocol.h:3010-3012): cheaper than a
            # full update for single-field changes (the lightmapper bot
            # patches lightmap URLs this way).  Same write-permission gate
            # as ObjectFullUpdate.
            w = self.server.worlds_state.get_world(self.world_name)
            (uid,) = struct.unpack_from("<Q", payload, 0)
            with self.server.worlds_state.lock:
                ob = w.objects.get(uid)
                if ob is None or not self.server.user_has_object_write_perms(
                        self.effective_user_id, ob, w):
                    return
                if msg_type == P.OBJECT_FLAGS_CHANGED:
                    (ob.flags,) = struct.unpack_from("<I", payload, 8)
                elif msg_type == P.OBJECT_MODEL_URL_CHANGED:
                    ob.model_url, _ = P.unpack_string(payload, 8)
                else:
                    ob.lightmap_url, _ = P.unpack_string(payload, 8)
                w.dirty_objects.add(uid)
                w.db_dirty_objects.add(uid)
            self.server.broadcast(self.world_name,
                                  P.make_message(msg_type, payload),
                                  exclude=self)
        elif msg_type == P.CHANGE_TO_DIFFERENT_WORLD:
            # Switch this connection to another world and resend that
            # world's initial state (WorkerThread.cpp:1376-1395).
            new_world, _ = P.unpack_string(payload, 0)
            self.world_name = new_world
            self.server.worlds_state.get_world(new_world)  # ensure exists
            self._send_initial_objects()
        elif msg_type == P.SIGN_UP_MESSAGE:
            # Protocol-side account creation (Protocol.h:196-204 family).
            username, off = P.unpack_string(payload, 0)
            email, off = P.unpack_string(payload, off)
            password, _ = P.unpack_string(payload, off)
            try:
                user = self.server.accounts.create_user(username, email,
                                                        password)
            except ValueError as e:
                self.send_message(P.make_message(
                    P.LOG_IN_FAILURE, P.pack_string(str(e))))
            else:
                self.logged_in_user_id = user.user_id
                self.send_message(P.make_message(
                    P.SIGNED_UP_MESSAGE_ID,
                    struct.pack("<I", user.user_id)
                    + P.pack_string(user.name)))
        elif msg_type == P.LOG_OUT_MESSAGE:
            self.logged_in_user_id = 0
            self.send_message(P.make_message(P.LOGGED_OUT_MESSAGE_ID, b""))
        elif msg_type == P.LOG_IN_MESSAGE:
            # Protocol login on the updates connection (Protocol.h:196-204):
            # binds the ACCOUNT identity, like the reference's LogInMessage.
            username, off = P.unpack_string(payload, 0)
            password, _ = P.unpack_string(payload, off)
            user = self.server.accounts.users_by_name.get(username)
            if user is None or not user.is_password_valid(password):
                self.send_message(P.make_message(
                    P.LOG_IN_FAILURE, P.pack_string("Login failed.")))
            else:
                self.logged_in_user_id = user.user_id
                self.send_message(P.make_message(
                    P.LOGGED_IN_MESSAGE_ID,
                    struct.pack("<I", user.user_id)
                    + P.pack_string(user.name)))
        elif msg_type == P.PING:
            self.send_message(P.make_message(P.PONG, payload))
        elif msg_type == P.KEEP_ALIVE:
            pass
        elif msg_type == P.CLIENT_UDP_SOCKET_OPEN:
            (port,) = struct.unpack("<I", payload[:4])
            self.udp_endpoint = (self.addr[0], port)
        elif msg_type in (P.USER_TOUCHED_OBJECT_MESSAGE, P.USER_USED_OBJECT_MESSAGE,
                          P.USER_MOVED_NEAR_TO_OBJECT_MESSAGE,
                          P.USER_MOVED_AWAY_FROM_OBJECT_MESSAGE,
                          P.USER_ENTERED_PARCEL_MESSAGE,
                          P.USER_EXITED_PARCEL_MESSAGE):
            (uid,) = struct.unpack("<Q", payload[:8])
            self.server.script_events.append(
                (msg_type, self.world_name, uid, self.avatar_uid))
        elif msg_type == P.CREATE_OBJECT:
            # Client requests creation (Protocol.h CreateObject=3004); the
            # server allocates the UID and broadcasts ObjectCreated to ALL
            # clients including the sender (WorkerThread CreateObject path).
            if self.server.read_only:
                return
            ob = WorldObject.from_bytes(payload)
            with ws.lock:
                ob.uid = ws.alloc_uid()
                ob.creator_id = self.effective_user_id
                w.objects[ob.uid] = ob
                w.db_dirty_objects.add(ob.uid)
            self.server.broadcast(self.world_name,
                                  P.make_message(P.OBJECT_CREATED, ob.to_bytes()))
        elif msg_type == P.DESTROY_OBJECT:
            (uid,) = struct.unpack("<Q", payload[:8])
            with ws.lock:
                ob = w.objects.get(uid)
                allowed = (ob is not None
                           and self.server.user_has_object_write_perms(
                               self.effective_user_id, ob, w)
                           and not self.server.read_only)
                if allowed:
                    del w.objects[uid]
                    w.destroyed_objects.add(uid)
                    w.db_dirty_objects.add(uid)
            if allowed:
                self.server.broadcast(
                    self.world_name,
                    P.make_message(P.OBJECT_DESTROYED,
                                   struct.pack("<Q", uid)))
        elif msg_type in (P.OBJECT_MOVE_TO, P.OBJECT_ROTATE_TO):
            # Scripted moveTo/rotateTo relays (Protocol.h:123-124): the
            # authoritative endpoint transform is applied server-side, the
            # eased animation plays out client-side.
            uid = struct.unpack_from("<Q", payload, 0)[0]
            with ws.lock:
                ob = w.objects.get(uid)
                allowed = (ob is not None
                           and self.server.user_has_object_write_perms(
                               self.effective_user_id, ob, w))
                if allowed and msg_type == P.OBJECT_MOVE_TO:
                    _uid, _t0, _dur, _ease, _start, target = \
                        P.unpack_object_move_to(payload)
                    ob.pos = target.astype(np.float64)
                    w.db_dirty_objects.add(uid)
                elif allowed:
                    (_uid, _t0, _dur, _ease, _sax, _sang,
                     tax, tang) = P.unpack_object_rotate_to(payload)
                    ob.axis = tax
                    ob.angle = tang
                    w.db_dirty_objects.add(uid)
            if allowed:
                self.server.broadcast(self.world_name,
                                      P.make_message(msg_type, payload),
                                      exclude=self)
        elif msg_type == P.SUMMON_OBJECT:
            uid, pos, aa, _av = P.unpack_summon_object(payload)
            with ws.lock:
                ob = w.objects.get(uid)
                allowed = (ob is not None
                           and self.server.user_has_object_write_perms(
                               self.effective_user_id, ob, w))
                if allowed:
                    ob.pos = pos.astype(np.float64)
                    angle = float(np.linalg.norm(aa))
                    if angle > 1e-9:
                        ob.axis = (aa / angle).astype(np.float32)
                        ob.angle = angle
                    w.dirty_physics_objects.add(uid)
                    w.db_dirty_objects.add(uid)
            if allowed:
                # Tag with the summoner so the sender discards its echo
                # (SummonObjectMessageServerToClient semantics).
                body = P.pack_summon_object(uid, pos, aa, self.avatar_uid)
                self.server.broadcast(self.world_name,
                                      P.make_message(P.SUMMON_OBJECT, body))
        elif msg_type == P.QUERY_PARCELS:
            with ws.lock:
                parcels = list(w.parcels.values())
            body = struct.pack("<I", len(parcels))
            for p in parcels:
                blob = p.to_bytes()
                body += struct.pack("<I", len(blob)) + blob
            self.send_message(P.make_message(P.PARCEL_LIST, body))
        elif msg_type == P.WORLD_SETTINGS_UPDATE:
            # Only the god user / world gardeners may change world settings
            # (WorkerThread WorldSettingsUpdate permission gate).
            from substrata_tpu_torch.shared.records import WorldSettings
            if self.server.accounts.is_god_user(self.avatar_uid):
                with ws.lock:
                    w.settings = WorldSettings.from_bytes(payload)
                self.server.broadcast(self.world_name,
                                      P.make_message(msg_type, payload),
                                      exclude=self)
        elif msg_type in (P.AVATAR_EXITED_VEHICLE, P.AVATAR_SAT_ON_SEAT,
                          P.AVATAR_GOT_UP_FROM_SEAT):
            av_uid, veh_uid, seat = P.unpack_avatar_seat_change(payload)
            with ws.lock:
                av = w.avatars.get(self.avatar_uid)
                if av is not None:
                    if msg_type == P.AVATAR_SAT_ON_SEAT:
                        av.entered_vehicle_uid = veh_uid
                        av.vehicle_seat_index = seat
                    else:
                        av.entered_vehicle_uid = 0
                        av.vehicle_seat_index = 0
            body = P.pack_avatar_seat_change(self.avatar_uid, veh_uid, seat)
            self.server.broadcast(self.world_name,
                                  P.make_message(msg_type, body),
                                  exclude=self)
        elif msg_type in (P.AUDIO_STREAM_TO_SERVER_STARTED,
                          P.AUDIO_STREAM_TO_SERVER_ENDED):
            _uid, rate, stream_id = P.unpack_audio_stream_state(payload)
            with ws.lock:
                av = w.avatars.get(self.avatar_uid)
                if av is not None:
                    av.audio_stream_id = (
                        stream_id
                        if msg_type == P.AUDIO_STREAM_TO_SERVER_STARTED
                        else 0)
            body = P.pack_audio_stream_state(self.avatar_uid, rate, stream_id)
            self.server.broadcast(self.world_name,
                                  P.make_message(msg_type, body),
                                  exclude=self)
        elif msg_type == P.QUERY_USER_GEAR:
            gear = self.server.user_gear.get(self.avatar_uid, {})
            body = struct.pack("<I", len(gear))
            for g in gear.values():
                blob = g.to_bytes()
                body += struct.pack("<I", len(blob)) + blob
            self.send_message(P.make_message(P.USER_GEAR_LIST, body))
        elif msg_type == P.CREATE_GEAR_ITEM:
            from substrata_tpu_torch.shared.records import GearItem
            g = GearItem.from_bytes(payload)
            g.item_id = self.server.next_gear_id
            self.server.next_gear_id += 1
            g.owner_id = self.avatar_uid
            self.server.user_gear.setdefault(self.avatar_uid, {})[g.item_id] = g
            self.send_message(P.make_message(P.GEAR_ITEM_UPDATE, g.to_bytes()))
        elif msg_type in (P.PICK_UP_GEAR_ITEM, P.DROP_GEAR_ITEM):
            (item_id,) = struct.unpack("<Q", payload[:8])
            g = self.server.user_gear.get(self.avatar_uid, {}).get(item_id)
            if g is not None:
                g.equipped = msg_type == P.PICK_UP_GEAR_ITEM
                self.server.broadcast(
                    self.world_name,
                    P.make_message(P.GEAR_ITEM_UPDATE, g.to_bytes()))
        elif msg_type == P.CLONE_GEAR_ITEM_IN_INVENTORY:
            (item_id,) = struct.unpack("<Q", payload[:8])
            g = self.server.user_gear.get(self.avatar_uid, {}).get(item_id)
            if g is not None:
                from substrata_tpu_torch.shared.records import GearItem
                clone = GearItem.from_bytes(g.to_bytes())
                clone.item_id = self.server.next_gear_id
                self.server.next_gear_id += 1
                clone.equipped = False
                self.server.user_gear[self.avatar_uid][clone.item_id] = clone
                self.send_message(
                    P.make_message(P.GEAR_ITEM_UPDATE, clone.to_bytes()))
        elif msg_type == P.QUERY_MAP_TILES:
            tiles = list(self.server.site_data.map_tiles.items())
            body = struct.pack("<I", len(tiles))
            for (x, y, z), sid in tiles:
                body += struct.pack("<iiiI", x, y, z, sid)
            self.send_message(P.make_message(P.MAP_TILES_RESULT, body))
        elif msg_type == P.QUERY_LOD_CHUNKS_MESSAGE:
            chunks = [c for (wn, _x, _y), c in ws.lod_chunks.items()
                      if wn == self.world_name]
            for c in chunks:
                self.send_message(P.make_message(P.LOD_CHUNK_INITIAL_SEND,
                                                 c.to_bytes()))
        elif msg_type == P.SUBMIT_ETH_TRANSACTION_REQUEST:
            self._handle_eth_submit(payload)
        elif msg_type == P.BUILDER_AI_USER_MESSAGE:
            self._builder_ai().user_message(
                P.unpack_builder_ai_user_message(payload))
        elif msg_type == P.BUILDER_AI_CANCEL:
            if self._builder_session is not None:
                self._builder_session.cancel()
        else:
            self.server.unknown_messages.append(msg_type)

    # ------------------------------------------------------------------
    def _handle_eth_submit(self, payload: bytes):
        _not_ported("parcel-NFT transaction submission (server_side/ethereum.py)")

    def _builder_ai(self):
        _not_ported("BuilderAI sessions (server_side/builder_ai.py, llm_client.py)")


class Server:
    """server/Server.cpp parity: listener + workers + 100 ms broadcast tick
    + UDP voice relay + periodic DB flush."""

    MAX_UPLOAD_BYTES = 64 * 1024 * 1024  # InvalidFileSize threshold
    ALLOWED_UPLOAD_EXTS = (".bmesh", ".glb", ".gltf", ".vox", ".voxdata",
                           ".png", ".jpg", ".jpeg", ".ktx", ".ktx2", ".basis",
                           ".mp3", ".wav", ".xml", ".luau", ".lua", ".sub", "")

    def __init__(self, port: int = 0, udp_port: int = 0, db_path: str | None = None,
                 resource_dir: str | None = None, clock=time.monotonic,
                 tls_context=tls.DEV_TLS):
        # ``tls_context``: ssl.SSLContext to wrap every accepted game
        # connection.  The reference always TLS-wraps (ListenerThread.cpp),
        # so the DEFAULT here is TLS with the shared dev certificate;
        # pass ``tls_context=None`` for an explicit plaintext opt-out, or a
        # real ssl context for production certs.
        self.tls_context = tls.resolve_server_context(tls_context)
        self.worlds_state = ServerAllWorldsState(db_path)
        self.connections: list[WorkerConnection] = []
        self.conn_lock = threading.Lock()
        self.running = False
        self.read_only = False  # server read-only mode (WorkerThread.cpp:1991)
        # Server-side resource store for network asset transfer
        # (GetFile/GetFiles/NewResourceOnServer, Protocol.h:167-170).
        from substrata_tpu_torch.shared.resources import ResourceManager
        if resource_dir is None:
            import tempfile
            resource_dir = tempfile.mkdtemp(prefix="substrata_server_res_")
        self.resources = ResourceManager(resource_dir)
        # Optional background LOD pipeline (server/MeshLODGenThread): when
        # attached, uploaded textures get BC1/KTX2 LOD variants generated
        # (see server_side/asset_pipeline.py); started lazily by callers
        # that want it so unit-scale servers don't pay a worker thread.
        self.lod_gen = None
        self.script_events: list = []
        self.unknown_messages: list = []
        # Server-side scripting (ServerSideScripting parity): user-event
        # messages from workers fire handlers on this VM in the main tick
        # (Server.cpp:672-870), gated by the script-exec feature flag.
        from substrata_tpu_torch.scripting.events import ScriptVM
        self.script_vm = ScriptVM(clock=clock, is_server=True)
        self._clock = clock
        self._start_time = clock()
        # Gear registry (server User.h gear_ids; Protocol.h:1400-1406).
        self.user_gear: dict[int, dict[int, object]] = {}
        self.next_gear_id = 1
        # Site data (map tiles / screenshots) shared with the webserver.
        from substrata_tpu_torch.server_side.site_data import SiteDataStore
        self.site_data = SiteDataStore()
        # Tool layer reused by BuilderAI sessions (and optionally /mcp).
        from substrata_tpu_torch.server_side.accounts import AccountStore
        from substrata_tpu_torch.server_side.mcp import MCPEndpoint
        self.accounts = AccountStore()
        self.mcp = MCPEndpoint(self.worlds_state, self.accounts)
        # Eth transaction submission seam (server SubEthTransactions flow):
        # sign with the server key + record; a production deployment posts
        # the raw tx to an RPC node here.
        self.eth_submitted: list = []

        self.listen_sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listen_sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listen_sock.bind(("127.0.0.1", port))
        self.listen_sock.listen(64)
        self.port = self.listen_sock.getsockname()[1]

        self.udp_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.udp_sock.bind(("127.0.0.1", udp_port))
        self.udp_sock.settimeout(0.2)
        self.udp_port = self.udp_sock.getsockname()[1]
        self.udp_endpoints: dict = {}  # avatar_uid -> (host, port)
        self.udp_packets_received = 0

        self._threads: list[threading.Thread] = []

    def global_time(self) -> float:
        return self._clock() - self._start_time

    # ------------------------------------------------------------------
    def start(self):
        self.running = True
        for fn in (self._listen_loop, self._tick_loop, self._udp_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self):
        self.running = False
        try:
            self.listen_sock.close()
        except OSError:
            pass
        with self.conn_lock:
            for c in self.connections:
                c.alive = False
                try:
                    c.sock.close()
                except OSError:
                    pass
        self.worlds_state.save_dirty()
        for t in self._threads:
            t.join(timeout=2.0)

    def register_connection(self, conn: WorkerConnection):
        with self.conn_lock:
            self.connections.append(conn)

    def connection_closed(self, conn: WorkerConnection):
        with self.conn_lock:
            if conn in self.connections:
                self.connections.remove(conn)
        # Remove + broadcast avatar destroyed.
        w = self.worlds_state.get_world(conn.world_name)
        with self.worlds_state.lock:
            if conn.avatar_uid in w.avatars:
                del w.avatars[conn.avatar_uid]
        self.broadcast(conn.world_name,
                       P.make_message(P.AVATAR_DESTROYED,
                                      struct.pack("<Q", conn.avatar_uid)))
        self.udp_endpoints.pop(conn.avatar_uid, None)

    def broadcast(self, world_name: str, data: bytes, exclude=None):
        with self.conn_lock:
            conns = [c for c in self.connections
                     if c.world_name == world_name and c is not exclude and c.alive]
        for c in conns:
            c.send_message(data)

    def user_has_object_write_perms(self, avatar_uid: int, ob: WorldObject,
                                    world: ServerWorldState) -> bool:
        """ObjectPermissions core: creator, world owner, or parcel writers
        (server/ObjectPermissions; used WorkerThread.cpp:2069)."""
        if ob.creator_id == avatar_uid:
            return True
        for p in world.parcels.values():
            if p.contains(ob.pos) and p.user_has_write_perms(avatar_uid):
                return True
        return ob.is_dynamic()  # dynamic objects: physics updates allowed

    # ------------------------------------------------------------------
    def _listen_loop(self):
        self.listen_sock.settimeout(0.5)
        while self.running:
            try:
                sock, addr = self.listen_sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            WorkerConnection(self, sock, addr,
                             tls_context=self.tls_context).start()

    def _drain_script_events(self):
        """Execute queued user-event messages on the server script VM
        (Lua timer queue + script events in the main loop,
        Server.cpp:630-800)."""
        if not self.worlds_state.feature_flags.get("SERVER_SCRIPT_EXEC"):
            self.script_events.clear()
            return
        self.script_vm.update()
        events, self.script_events = self.script_events, []
        for msg_type, world_name, uid, avatar_uid in events:
            if msg_type == P.USER_TOUCHED_OBJECT_MESSAGE:
                self.script_vm.fire_user_touched_object(uid, avatar_uid)
            elif msg_type == P.USER_USED_OBJECT_MESSAGE:
                self.script_vm.fire_user_used_object(uid, avatar_uid)
            elif msg_type == P.USER_MOVED_NEAR_TO_OBJECT_MESSAGE:
                self.script_vm.fire_user_moved_near(uid, avatar_uid)
            elif msg_type == P.USER_MOVED_AWAY_FROM_OBJECT_MESSAGE:
                self.script_vm.fire_user_moved_away(uid, avatar_uid)

    def _tick_loop(self):
        last_time_sync = 0.0
        last_db_flush = 0.0
        while self.running:
            t0 = self._clock()
            self._drain_script_events()
            self._broadcast_dirty()
            if t0 - last_time_sync > TIME_SYNC_PERIOD:
                last_time_sync = t0
                self.broadcast_all(P.make_message(
                    P.TIME_SYNC_MESSAGE, P.pack_time_sync(self.global_time())))
            if t0 - last_db_flush > DB_FLUSH_PERIOD:
                last_db_flush = t0
                self.worlds_state.save_dirty()
            elapsed = self._clock() - t0
            time.sleep(max(0.0, SERVER_TICK - elapsed))

    def broadcast_all(self, data: bytes):
        with self.conn_lock:
            conns = list(self.connections)
        for c in conns:
            c.send_message(data)

    def _broadcast_dirty(self):
        """Per-world dirty broadcast (Server.cpp:875-1050)."""
        ws = self.worlds_state
        with ws.lock:
            work = []
            for name, w in ws.worlds.items():
                if (w.dirty_avatars or w.dirty_objects or w.dirty_physics_objects
                        or w.destroyed_objects):
                    work.append((
                        name,
                        [w.avatars.get(u) for u in w.dirty_avatars],
                        [w.objects.get(u) for u in w.dirty_objects],
                        [w.objects.get(u) for u in w.dirty_physics_objects],
                        list(w.destroyed_objects)))
                    w.dirty_avatars.clear()
                    w.dirty_objects.clear()
                    w.dirty_physics_objects.clear()
                    w.destroyed_objects.clear()
        for name, avatars, objects, phys, destroyed in work:
            for av in avatars:
                if av is not None:
                    self.broadcast(name, P.make_message(
                        P.AVATAR_TRANSFORM_UPDATE,
                        P.pack_avatar_transform_update(
                            av.uid, av.pos, av.rotation, av.anim_state,
                            av.entered_vehicle_uid, av.vehicle_seat_index,
                            av.last_physics_input_bitflags)))
            for ob in objects:
                if ob is not None:
                    self.broadcast(name, P.make_message(P.OBJECT_CREATED, ob.to_bytes()))
            for ob in phys:
                if ob is not None:
                    # Relay physics snapshots to everyone but the sender
                    # (the owner already has them).
                    msg = P.make_message(
                        P.OBJECT_PHYSICS_TRANSFORM_UPDATE,
                        P.pack_physics_transform_update(
                            ob.uid, ob.pos, ob.quat, ob.linear_vel, ob.angular_vel,
                            ob.last_transform_client_time,
                            ob.last_transform_update_avatar_uid))
                    with self.conn_lock:
                        conns = [c for c in self.connections
                                 if c.world_name == name and c.alive
                                 and c.avatar_uid != ob.last_transform_update_avatar_uid]
                    for c in conns:
                        c.send_message(msg)
            for uid in destroyed:
                self.broadcast(name, P.make_message(P.OBJECT_DESTROYED,
                                                    struct.pack("<Q", uid)))

    def _udp_loop(self):
        """Voice relay (UDPHandlerThread.cpp:55-95)."""
        while self.running:
            try:
                data, addr = self.udp_sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            if len(data) < 5:
                continue
            (ptype,) = struct.unpack_from("<B", data, 0)
            self.udp_packets_received += 1
            if ptype == P.UDP_DISCOVERY_PACKET:
                (avatar_uid,) = struct.unpack_from("<Q", data, 1)
                self.udp_endpoints[avatar_uid] = addr
            elif ptype == P.UDP_VOICE_PACKET:
                (sender_uid,) = struct.unpack_from("<Q", data, 1)
                for uid, ep in list(self.udp_endpoints.items()):
                    if uid != sender_uid:
                        try:
                            self.udp_sock.sendto(data, ep)
                        except OSError:
                            pass

    def get_diagnostics(self) -> str:
        with self.conn_lock:
            n = len(self.connections)
        with self.worlds_state.lock:
            nw = len(self.worlds_state.worlds)
            nob = sum(len(w.objects)
                      for w in self.worlds_state.worlds.values())
        return (f"Server: {n} connections, {nw} worlds, {nob} objects, "
                f"udp packets {self.udp_packets_received}")
