"""The game client's network endpoint + replicated world state.

Parity with gui_client/ClientThread.{h,cpp} (TCP reader applying protocol
messages to the client WorldState under lock, snapshot appends, TimeSync,
Ping RTT), gui_client/ClientSenderThread (out queue), and
gui_client/WorldState.{h,cpp} (objects/avatars/parcels maps, dirty-from-
remote/local sets, global-time estimation).

A copy of ``substrata_tpu/net/client.py`` with the port's imports: importing
any module of the reference package loads jax, so the port keeps its own.
"""

from __future__ import annotations

import socket
import ssl
import struct
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from substrata_tpu_torch.net import protocol as P
from substrata_tpu_torch.net import tls
from substrata_tpu_torch.net.snapshots import PhysicsOwnership, SnapshotRings
from substrata_tpu_torch.net.timesync import GlobalTimeSync
from substrata_tpu_torch.shared import guarded
from substrata_tpu_torch.shared.avatar import Avatar
from substrata_tpu_torch.shared.parcel import Parcel
from substrata_tpu_torch.shared.world_object import WorldObject


class ClientWorldState:
    """Client replica (gui_client/WorldState.h:44-70)."""

    def __init__(self, capacity: int = 16_384):
        # GUARDED_BY discipline checked dynamically when
        # SUBSTRATA_LOCK_CHECKS=1 (the reference's Clang thread-safety
        # annotations, WorldState.h:44-63; see shared/guarded.py).
        self.lock = guarded.make_lock("ClientWorldState.lock")
        self.objects: dict[int, WorldObject] = guarded.guard(
            {}, self.lock, "ClientWorldState.objects")
        self.avatars: dict[int, Avatar] = guarded.guard(
            {}, self.lock, "ClientWorldState.avatars")
        self.parcels: dict[int, Parcel] = guarded.guard(
            {}, self.lock, "ClientWorldState.parcels")
        self.dirty_from_remote_objects: set = guarded.guard(
            set(), self.lock, "ClientWorldState.dirty_from_remote_objects")
        self.dirty_from_local_objects: set = guarded.guard(
            set(), self.lock, "ClientWorldState.dirty_from_local_objects")
        self.snapshots = SnapshotRings(capacity)
        self.ownership = PhysicsOwnership(capacity)
        self._slot_by_uid: dict[int, int] = guarded.guard(
            {}, self.lock, "ClientWorldState._slot_by_uid")
        self._free_slots = list(range(capacity - 1, -1, -1))
        self.time_sync = GlobalTimeSync()
        self.world_settings = None        # WorldSettings replica (3700/3701)

    def slot_for(self, uid: int) -> int:
        # Self-locking: called from both the reader thread (message apply)
        # and the tick thread (ownership claims / snapshot sends); the map
        # mutation must be atomic between them.  RLock => fine under an
        # already-held world lock.
        with self.lock:
            s = self._slot_by_uid.get(uid)
            if s is None:
                s = self._free_slots.pop()
                self._slot_by_uid[uid] = s
            return s

    def release_slot(self, uid: int):
        with self.lock:
            s = self._slot_by_uid.pop(uid, None)
            if s is not None:
                self._free_slots.append(s)

    def global_time(self) -> float:
        return self.time_sync.global_time()

    # Locked snapshot accessors for cross-thread readers (bots, tools,
    # tests): take the lock, return a plain copy usable lock-free.
    def objects_snapshot(self) -> dict:
        with self.lock:
            return dict(self.objects)

    def avatars_snapshot(self) -> dict:
        with self.lock:
            return dict(self.avatars)

    def parcels_snapshot(self) -> dict:
        with self.lock:
            return dict(self.parcels)

    def num_objects(self) -> int:
        with self.lock:
            return len(self.objects)


@dataclass
class ClientEvents:
    """Messages surfaced to the app layer per tick."""

    chat: list = field(default_factory=list)
    logged_in: list = field(default_factory=list)  # (user_id, name)
    gestures: list = field(default_factory=list)   # (avatar_uid, name|"" )
    selections: list = field(default_factory=list)  # (avatar_uid?, ob_uid, selected)
    object_updates: list = field(default_factory=list)  # uids w/ changed fields
    info: list = field(default_factory=list)
    errors: list = field(default_factory=list)
    objects_created: list = field(default_factory=list)
    objects_destroyed: list = field(default_factory=list)
    avatars_created: list = field(default_factory=list)
    avatars_destroyed: list = field(default_factory=list)
    new_resources: list = field(default_factory=list)   # urls announced
    files_received: list = field(default_factory=list)  # (url, found)
    move_tos: list = field(default_factory=list)        # eased moveTo/rotateTo
    summons: list = field(default_factory=list)         # (uid, pos, axis_angle)
    parcel_lists: list = field(default_factory=list)    # [Parcel, ...] replies
    gear: list = field(default_factory=list)            # GearItem updates
    map_tiles: list = field(default_factory=list)       # [(x,y,z,sid), ...]
    lod_chunks: list = field(default_factory=list)      # LODChunk records
    seat_changes: list = field(default_factory=list)    # (type, av, veh, seat)
    audio_streams: list = field(default_factory=list)   # (type, av, rate, id)
    eth: list = field(default_factory=list)             # (ok, info)
    builder_ai: list = field(default_factory=list)      # (kind, text)


class Client:
    """gui_client/ClientThread parity over a blocking socket + reader
    thread; messages mutate ClientWorldState under its lock."""

    def __init__(self, host: str, port: int, world_name: str = "",
                 capabilities: int = P.STREAMING_COMPRESSED_OBJECT_SUPPORT,
                 tls_context=tls.DEV_TLS, server_hostname: str | None = None,
                 sock=None):
        self.world_state = ClientWorldState()
        self.events = ClientEvents()
        self.events_lock = threading.Lock()
        self.avatar_uid = 0
        self.logged_in_user_id = 0
        self.connected = False
        self.running = False
        self._reader_thread = None
        self._ping_sent_at: dict[bytes, float] = {}
        # Resource transfer: downloaded files land here (set by the app).
        self.resource_manager = None
        self._file_cv = threading.Condition()
        self._file_results: dict[str, bytes | None] = {}

        if sock is not None:
            # Pre-connected socket-like transport (e.g. a WebSocketStream
            # from a webserver upgrade) — the protocol handshake runs over
            # it unchanged.
            self.sock = sock
        else:
            self.sock = socket.create_connection((host, port), timeout=5.0)
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # TLS before the protocol handshake (reference: MySocket is
            # wrapped in TLSSocket before CyberspaceHello is sent).  The
            # DEFAULT is the dev-cert context (Server defaults to TLS too);
            # tls_context=None is the explicit plaintext opt-out.
            ctx = tls.resolve_client_context(tls_context)
            if ctx is not None:
                self.sock = ctx.wrap_socket(
                    self.sock, server_hostname=server_hostname or host)
        self.send_lock = threading.Lock()
        self._io = None          # tls.DuplexTLS once the reader runs over TLS
        self._handshake(world_name, capabilities)

    # ------------------------------------------------------------------
    def _recv_exact(self, n):
        buf = b""
        while len(buf) < n:
            d = self.sock.recv(n - len(buf))
            if not d:
                raise ConnectionError("eof in handshake")
            buf += d
        return buf

    def _handshake(self, world_name: str, capabilities: int):
        self.sock.sendall(struct.pack("<II", P.CYBERSPACE_HELLO,
                                      P.CYBERSPACE_PROTOCOL_VERSION))
        code, server_version = struct.unpack("<II", self._recv_exact(8))
        if code != P.CLIENT_PROTOCOL_OK:
            raise ConnectionError(f"server rejected protocol: {code}")
        self.server_protocol_version = server_version
        self.sock.sendall(struct.pack("<II", P.CONNECTION_TYPE_UPDATES, capabilities))
        wb = world_name.encode("utf-8")
        self.sock.sendall(struct.pack("<I", len(wb)) + wb)
        (self.avatar_uid,) = struct.unpack("<Q", self._recv_exact(8))
        self.connected = True

    def start(self):
        self.running = True
        self._reader_thread = threading.Thread(target=self._read_loop, daemon=True)
        self._reader_thread.start()

    def stop(self):
        self.running = False
        self.connected = False
        try:
            self.sock.close()
        except OSError:
            pass
        if self._reader_thread:
            self._reader_thread.join(timeout=2.0)

    def send_message(self, data: bytes):
        try:
            with self.send_lock:
                io = self._io
                if io is None:
                    self.sock.sendall(data)
                    return
            io.sendall(data)
        except OSError:
            self.connected = False

    # ------------------------------------------------------------------
    # Senders
    # ------------------------------------------------------------------
    def send_login(self, username: str, password: str):
        """LogInMessage 8000 (Protocol.h:196-204): bind the account
        identity to this game connection."""
        self.send_message(P.make_message(
            P.LOG_IN_MESSAGE,
            P.pack_string(username) + P.pack_string(password)))

    def send_perform_gesture(self, name: str, url: str = "",
                             flags: int = 0, start_global_time: float = 0.0):
        """AvatarPerformGesture 1010 (WorkerThread.cpp:1481 payload)."""
        self.send_message(P.make_message(
            P.AVATAR_PERFORM_GESTURE,
            struct.pack("<Q", self.avatar_uid) + P.pack_string(name)
            + P.pack_string(url) + struct.pack("<Id", flags,
                                               start_global_time)))

    def send_stop_gesture(self):
        self.send_message(P.make_message(
            P.AVATAR_STOP_GESTURE, struct.pack("<Q", self.avatar_uid)))

    def send_select_object(self, uid: int, selected: bool = True):
        self.send_message(P.make_message(
            P.USER_SELECTED_OBJECT if selected else P.USER_DESELECTED_OBJECT,
            struct.pack("<Q", uid)))

    def send_object_flags_changed(self, uid: int, flags: int):
        self.send_message(P.make_message(
            P.OBJECT_FLAGS_CHANGED, struct.pack("<QI", uid, flags)))

    def send_object_model_url_changed(self, uid: int, url: str):
        self.send_message(P.make_message(
            P.OBJECT_MODEL_URL_CHANGED,
            struct.pack("<Q", uid) + P.pack_string(url)))

    def send_object_lightmap_url_changed(self, uid: int, url: str):
        self.send_message(P.make_message(
            P.OBJECT_LIGHTMAP_URL_CHANGED,
            struct.pack("<Q", uid) + P.pack_string(url)))

    def send_change_world(self, world_name: str):
        """ChangeToDifferentWorld 600: switch this connection's world and
        receive the new world's initial state."""
        self.send_message(P.make_message(
            P.CHANGE_TO_DIFFERENT_WORLD, P.pack_string(world_name)))

    def send_sign_up(self, username: str, email: str, password: str):
        self.send_message(P.make_message(
            P.SIGN_UP_MESSAGE, P.pack_string(username) + P.pack_string(email)
            + P.pack_string(password)))

    def send_log_out(self):
        self.send_message(P.make_message(P.LOG_OUT_MESSAGE, b""))

    def send_create_object(self, ob: WorldObject):
        self.send_message(P.make_message(P.OBJECT_CREATED, ob.to_bytes()))

    def send_object_full_update(self, ob: WorldObject):
        self.send_message(P.make_message(P.OBJECT_FULL_UPDATE, ob.to_bytes()))

    def send_destroy_object(self, uid: int):
        self.send_message(P.make_message(P.OBJECT_DESTROYED, struct.pack("<Q", uid)))

    def send_physics_snapshot(self, uid: int, pos, quat, linvel, angvel):
        """ObjectPhysicsTransformUpdate at ~10 Hz from the physics owner
        (client tick step 13, GUIClient.cpp)."""
        self.send_message(P.make_message(
            P.OBJECT_PHYSICS_TRANSFORM_UPDATE,
            P.pack_physics_transform_update(
                uid, pos, quat, linvel, angvel,
                self.world_state.global_time(), self.avatar_uid)))

    def send_ownership_taken(self, uid: int, global_time: float):
        self.send_message(P.make_message(
            P.OBJECT_PHYSICS_OWNERSHIP_TAKEN,
            P.pack_physics_ownership_taken(uid, self.avatar_uid, global_time)))

    def send_avatar_created(self, av: Avatar):
        self.send_message(P.make_message(P.AVATAR_CREATED, av.to_bytes()))

    def send_avatar_transform(self, pos, rotation, anim_state: int = 0,
                              vehicle_uid: int = 0, seat: int = 0,
                              input_bitflags: int = 0):
        self.send_message(P.make_message(
            P.AVATAR_TRANSFORM_UPDATE,
            P.pack_avatar_transform_update(self.avatar_uid, pos, rotation,
                                           anim_state, vehicle_uid, seat,
                                           input_bitflags)))

    def send_chat(self, name: str, msg: str):
        self.send_message(P.make_message(P.CHAT_MESSAGE_ID,
                                         P.pack_chat_message(name, msg)))

    def request_create_object(self, ob: WorldObject):
        """CreateObject 3004: ask the server to allocate a UID and
        broadcast (vs send_create_object which pushes OBJECT_CREATED)."""
        self.send_message(P.make_message(P.CREATE_OBJECT, ob.to_bytes()))

    def request_destroy_object(self, uid: int):
        self.send_message(P.make_message(P.DESTROY_OBJECT,
                                         struct.pack("<Q", uid)))

    def send_object_move_to(self, uid: int, target_pos, duration: float = 1.0,
                            easing: int = 1, start_pos=None):
        ws = self.world_state
        with ws.lock:
            ob = ws.objects.get(uid)
            sp = (start_pos if start_pos is not None
                  else (ob.pos if ob is not None else target_pos))
        self.send_message(P.make_message(P.OBJECT_MOVE_TO,
            P.pack_object_move_to(uid, ws.global_time(), duration, easing,
                                  sp, target_pos)))

    def send_summon_object(self, uid: int, pos, axis_angle=(0.0, 0.0, 0.0)):
        self.send_message(P.make_message(P.SUMMON_OBJECT,
            P.pack_summon_object(uid, pos, axis_angle, self.avatar_uid)))

    def query_parcels(self):
        self.send_message(P.make_message(P.QUERY_PARCELS))

    def query_map_tiles(self):
        self.send_message(P.make_message(P.QUERY_MAP_TILES))

    def query_lod_chunks(self):
        self.send_message(P.make_message(P.QUERY_LOD_CHUNKS_MESSAGE))

    def send_seat_change(self, msg_type: int, vehicle_uid: int,
                         seat_index: int = 0):
        """AVATAR_SAT_ON_SEAT / AVATAR_GOT_UP_FROM_SEAT /
        AVATAR_EXITED_VEHICLE (Protocol.h:1101, 1110-1111)."""
        self.send_message(P.make_message(msg_type,
            P.pack_avatar_seat_change(self.avatar_uid, vehicle_uid,
                                      seat_index)))

    def send_audio_stream_state(self, started: bool, stream_id: int,
                                sample_rate: int = 48000):
        self.send_message(P.make_message(
            P.AUDIO_STREAM_TO_SERVER_STARTED if started
            else P.AUDIO_STREAM_TO_SERVER_ENDED,
            P.pack_audio_stream_state(self.avatar_uid, sample_rate,
                                      stream_id)))

    def query_user_gear(self):
        self.send_message(P.make_message(P.QUERY_USER_GEAR))

    def send_create_gear_item(self, gear):
        self.send_message(P.make_message(P.CREATE_GEAR_ITEM, gear.to_bytes()))

    def send_gear_action(self, msg_type: int, item_id: int):
        """PICK_UP_GEAR_ITEM / DROP_GEAR_ITEM / CLONE_GEAR_ITEM_IN_INVENTORY."""
        self.send_message(P.make_message(msg_type,
                                         struct.pack("<Q", item_id)))

    def submit_eth_transaction(self, parcel_id: int, to_address: str):
        self.send_message(P.make_message(
            P.SUBMIT_ETH_TRANSACTION_REQUEST,
            P.pack_eth_transaction_request(parcel_id, to_address)))

    def send_builder_ai_message(self, text: str):
        self.send_message(P.make_message(P.BUILDER_AI_USER_MESSAGE,
                                         P.pack_builder_ai_user_message(text)))

    def send_builder_ai_cancel(self):
        self.send_message(P.make_message(P.BUILDER_AI_CANCEL))

    # -- Resource transfer (Protocol.h:167-170; DownloadResourcesThread /
    #    UploadResourceThread counterparts) --------------------------------
    def request_files(self, urls):
        """Fire a GetFiles request; responses arrive async (files_received
        events + resource_manager storage)."""
        body = struct.pack("<I", len(urls))
        for u in urls:
            body += P.pack_string(u)
        self.send_message(P.make_message(P.GET_FILES, body))

    def download_files(self, urls, timeout: float = 10.0):
        """Blocking fetch over this connection: {url: bytes | None}."""
        with self._file_cv:
            for u in urls:
                self._file_results.pop(u, None)
        self.request_files(urls)
        deadline = time.monotonic() + timeout
        out = {}
        with self._file_cv:
            for u in urls:
                while u not in self._file_results:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self.connected:
                        out[u] = None
                        break
                    self._file_cv.wait(remaining)
                else:
                    out[u] = self._file_results[u]
        return out

    def _apply_object_initial_send(self, payload: bytes):
        ws = self.world_state
        ob = WorldObject.from_bytes(payload)
        with ws.lock:
            ws.objects[ob.uid] = ob
            ws.dirty_from_remote_objects.add(ob.uid)
            slot = ws.slot_for(ob.uid)
            ws.ownership.owner_id[slot] = ob.physics_owner_id
            ws.ownership.change_time[slot] = \
                ob.last_physics_ownership_change_global_time
        with self.events_lock:
            self.events.objects_created.append(ob.uid)

    def send_ping(self):
        token = struct.pack("<d", time.monotonic())
        self._ping_sent_at[token] = time.monotonic()
        self.send_message(P.make_message(P.PING, token))

    def pop_events(self) -> ClientEvents:
        with self.events_lock:
            ev = self.events
            self.events = ClientEvents()
        return ev

    # ------------------------------------------------------------------
    # Reader (ClientThread::doRun dispatch parity)
    # ------------------------------------------------------------------
    def _read_loop(self):
        reader = P.MessageReader()
        try:
            if isinstance(self.sock, ssl.SSLSocket):
                # Reads and writes of one TLS connection must not overlap
                # (tls.DuplexTLS; the reference's reader races its writers).
                self._io = tls.DuplexTLS(self.sock, self.send_lock)
                read = lambda: self._io.recv(65536, 0.5)      # noqa: E731
            else:
                self.sock.settimeout(0.5)
                read = lambda: self.sock.recv(65536)          # noqa: E731
        except OSError:  # stop() closed the socket before the thread ran
            self.connected = False
            return
        while self.running:
            try:
                data = read()
            except socket.timeout:
                continue
            except (OSError, ValueError):    # ValueError: stop() closed the socket
                break
            if not data:
                break
            try:
                reader.feed(data)
                for msg_type, payload in reader.messages():
                    self._dispatch(msg_type, payload)
            except (ValueError, struct.error):
                break
        self.connected = False

    def _dispatch(self, msg_type: int, payload: bytes):
        ws = self.world_state
        if msg_type in (P.OBJECT_INITIAL_SEND, P.OBJECT_CREATED):
            self._apply_object_initial_send(payload)
        elif msg_type == P.OBJECT_INITIAL_SEND_COMPRESSED:
            # One zlib batch of length-prefixed ObjectInitialSend payloads
            # (Protocol.h:137; we advertise the capability and the server
            # actually compresses).
            import zlib
            blob = zlib.decompress(payload)
            (count,) = struct.unpack_from("<I", blob, 0)
            off = 4
            for _ in range(count):
                (blen,) = struct.unpack_from("<I", blob, off)
                off += 4
                self._apply_object_initial_send(blob[off:off + blen])
                off += blen
        elif msg_type == P.NEW_RESOURCE_ON_SERVER:
            url, _ = P.unpack_string(payload, 0)
            with self.events_lock:
                self.events.new_resources.append(url)
        elif msg_type == P.GET_FILE:
            url, off = P.unpack_string(payload, 0)
            found, dlen = struct.unpack_from("<BI", payload, off)
            data = payload[off + 5:off + 5 + dlen] if found else None
            if found and self.resource_manager is not None:
                self.resource_manager.store_resource(url, data)
            with self.events_lock:
                self.events.files_received.append((url, bool(found)))
            with self._file_cv:
                self._file_results[url] = data
                self._file_cv.notify_all()
        elif msg_type == P.OBJECT_PHYSICS_TRANSFORM_UPDATE:
            uid, pos, quat, linvel, angvel, ct, sender = \
                P.unpack_physics_transform_update(payload)
            with ws.lock:
                ob = ws.objects.get(uid)
                if ob is None:
                    return
                slot = ws.slot_for(uid)
                # First snapshot from a new owner fixes the dejitter offset
                # (docs/networked physics.txt:42-55).
                ring = ws.snapshots
                if ring.next_i[slot] == 0 or sender != ob.last_transform_update_avatar_uid:
                    ring.set_transmission_time_offset(
                        slot, ws.global_time() - ct)
                ob.last_transform_update_avatar_uid = sender
                ring.insert_snapshot(slot, pos, quat, linvel, angvel, ct,
                                     ws.time_sync.local_time(), physics=True)
                ws.dirty_from_remote_objects.add(uid)
        elif msg_type == P.OBJECT_FULL_UPDATE:
            ob = WorldObject.from_bytes(payload)
            with ws.lock:
                ws.objects[ob.uid] = ob
                ws.dirty_from_remote_objects.add(ob.uid)
        elif msg_type == P.OBJECT_DESTROYED:
            (uid,) = struct.unpack("<Q", payload[:8])
            with ws.lock:
                ws.objects.pop(uid, None)
                ws.release_slot(uid)
            with self.events_lock:
                self.events.objects_destroyed.append(uid)
        elif msg_type == P.OBJECT_PHYSICS_OWNERSHIP_TAKEN:
            uid, owner, t, flags = P.unpack_physics_ownership_taken(payload)
            with ws.lock:
                ob = ws.objects.get(uid)
                if ob is not None:
                    slot = ws.slot_for(uid)
                    ws.ownership.apply_remote_claim(slot, owner, t)
                    ob.physics_owner_id = ws.ownership.owner_id[slot]
                    ob.last_physics_ownership_change_global_time = \
                        ws.ownership.change_time[slot]
                    # Ownership receipt re-anchors the dejitter offset.
                    ws.snapshots.set_transmission_time_offset(
                        slot, ws.global_time() - t)
        elif msg_type in (P.AVATAR_CREATED, P.AVATAR_IS_HERE, P.AVATAR_FULL_UPDATE):
            av = Avatar.from_bytes(payload)
            with ws.lock:
                ws.avatars[av.uid] = av
            with self.events_lock:
                self.events.avatars_created.append(av.uid)
        elif msg_type == P.AVATAR_TRANSFORM_UPDATE:
            (uid, pos, rot, anim, veh_uid, seat, bitflags) = \
                P.unpack_avatar_transform_update(payload)
            with ws.lock:
                av = ws.avatars.get(uid)
                if av is not None:
                    av.pos = pos.astype(np.float64)
                    av.rotation = rot
                    av.anim_state = anim
                    av.entered_vehicle_uid = veh_uid
                    av.vehicle_seat_index = seat
                    av.last_physics_input_bitflags = bitflags
        elif msg_type == P.AVATAR_DESTROYED:
            (uid,) = struct.unpack("<Q", payload[:8])
            with ws.lock:
                ws.avatars.pop(uid, None)
            with self.events_lock:
                self.events.avatars_destroyed.append(uid)
        elif msg_type == P.PARCEL_CREATED:
            p = Parcel.from_bytes(payload)
            with ws.lock:
                ws.parcels[p.parcel_id] = p
        elif msg_type == P.TIME_SYNC_MESSAGE:
            t = P.unpack_time_sync(payload)
            ws.time_sync.update_with_global_time_received(
                t, rtt=ws.time_sync.last_rtt or None)
        elif msg_type == P.PONG:
            sent = self._ping_sent_at.pop(payload, None)
            if sent is not None:
                ws.time_sync.last_rtt = time.monotonic() - sent
        elif msg_type in (P.AVATAR_PERFORM_GESTURE, P.AVATAR_STOP_GESTURE):
            (av_uid,) = struct.unpack_from("<Q", payload, 0)
            name = ""
            if msg_type == P.AVATAR_PERFORM_GESTURE:
                name, _ = P.unpack_string(payload, 8)
            with ws.lock:
                av = ws.avatars.get(av_uid)
                if av is not None:
                    av.performing_gesture = name
            with self.events_lock:
                self.events.gestures.append((av_uid, name))
        elif msg_type in (P.USER_SELECTED_OBJECT, P.USER_DESELECTED_OBJECT):
            (ob_uid,) = struct.unpack_from("<Q", payload, 0)
            with self.events_lock:
                self.events.selections.append(
                    (ob_uid, msg_type == P.USER_SELECTED_OBJECT))
        elif msg_type in (P.OBJECT_FLAGS_CHANGED, P.OBJECT_MODEL_URL_CHANGED,
                          P.OBJECT_LIGHTMAP_URL_CHANGED):
            (uid,) = struct.unpack_from("<Q", payload, 0)
            with ws.lock:
                ob = ws.objects.get(uid)
                if ob is not None:
                    if msg_type == P.OBJECT_FLAGS_CHANGED:
                        (ob.flags,) = struct.unpack_from("<I", payload, 8)
                    elif msg_type == P.OBJECT_MODEL_URL_CHANGED:
                        ob.model_url, _ = P.unpack_string(payload, 8)
                    else:
                        ob.lightmap_url, _ = P.unpack_string(payload, 8)
                    ws.dirty_from_remote_objects.add(uid)
            with self.events_lock:
                self.events.object_updates.append(uid)
        elif msg_type == P.LOGGED_IN_MESSAGE_ID:
            (uid_,) = struct.unpack_from("<I", payload, 0)
            name_, _ = P.unpack_string(payload, 4)
            self.logged_in_user_id = uid_
            with self.events_lock:
                self.events.logged_in.append((uid_, name_))
        elif msg_type == P.SIGNED_UP_MESSAGE_ID:
            (uid_,) = struct.unpack_from("<I", payload, 0)
            name_, _ = P.unpack_string(payload, 4)
            self.logged_in_user_id = uid_
            with self.events_lock:
                self.events.logged_in.append((uid_, name_))
        elif msg_type == P.LOGGED_OUT_MESSAGE_ID:
            self.logged_in_user_id = 0
        elif msg_type == P.LOG_IN_FAILURE:
            msg_, _ = P.unpack_string(payload, 0)
            with self.events_lock:
                self.events.errors.append(msg_)
        elif msg_type == P.CHAT_MESSAGE_ID:
            with self.events_lock:
                self.events.chat.append(P.unpack_chat_message(payload))
        elif msg_type == P.INFO_MESSAGE_ID:
            with self.events_lock:
                self.events.info.append(payload.decode("utf-8", "replace"))
        elif msg_type == P.ERROR_MESSAGE_ID:
            with self.events_lock:
                self.events.errors.append(payload.decode("utf-8", "replace"))
        elif msg_type in (P.OBJECT_MOVE_TO, P.OBJECT_ROTATE_TO):
            # Eased scripted motion: surfaced to the app layer which drives
            # an ObjectMoveToController (GUIClient ScriptedObMoveToMessage).
            if msg_type == P.OBJECT_MOVE_TO:
                uid, t0, dur, ease, sp, tp = P.unpack_object_move_to(payload)
                mv = {"uid": uid, "start_time": t0, "duration": dur,
                      "easing": ease, "start_pos": sp, "target_pos": tp,
                      "is_rotation": False}
            else:
                (uid, t0, dur, ease, sax, sang, tax,
                 tang) = P.unpack_object_rotate_to(payload)
                mv = {"uid": uid, "start_time": t0, "duration": dur,
                      "easing": ease, "start_axis": sax, "start_angle": sang,
                      "target_axis": tax, "target_angle": tang,
                      "is_rotation": True}
            with self.events_lock:
                self.events.move_tos.append(mv)
        elif msg_type == P.SUMMON_OBJECT:
            uid, pos, aa, sender = P.unpack_summon_object(payload)
            if sender != self.avatar_uid:     # discard own echo
                with ws.lock:
                    ob = ws.objects.get(uid)
                    if ob is not None:
                        ob.pos = pos.astype(np.float64)
                        ws.dirty_from_remote_objects.add(uid)
                with self.events_lock:
                    self.events.summons.append((uid, pos, aa))
        elif msg_type == P.PARCEL_LIST:
            (count,) = struct.unpack_from("<I", payload, 0)
            off = 4
            parcels = []
            for _ in range(min(count, 65536)):
                (n,) = struct.unpack_from("<I", payload, off)
                off += 4
                parcels.append(Parcel.from_bytes(payload[off:off + n]))
                off += n
            with ws.lock:
                for p in parcels:
                    ws.parcels[p.parcel_id] = p
            with self.events_lock:
                self.events.parcel_lists.append(parcels)
        elif msg_type in (P.WORLD_SETTINGS_INITIAL_SEND_MESSAGE,
                          P.WORLD_SETTINGS_UPDATE):
            from substrata_tpu_torch.shared.records import WorldSettings
            with ws.lock:
                ws.world_settings = WorldSettings.from_bytes(payload)
        elif msg_type in (P.USER_GEAR_LIST,):
            from substrata_tpu_torch.shared.records import GearItem
            (count,) = struct.unpack_from("<I", payload, 0)
            off = 4
            items = []
            for _ in range(min(count, 65536)):
                (n,) = struct.unpack_from("<I", payload, off)
                off += 4
                items.append(GearItem.from_bytes(payload[off:off + n]))
                off += n
            with self.events_lock:
                self.events.gear.extend(items)
        elif msg_type == P.GEAR_ITEM_UPDATE:
            from substrata_tpu_torch.shared.records import GearItem
            with self.events_lock:
                self.events.gear.append(GearItem.from_bytes(payload))
        elif msg_type == P.MAP_TILES_RESULT:
            (count,) = struct.unpack_from("<I", payload, 0)
            tiles = [struct.unpack_from("<iiiI", payload, 4 + 16 * i)
                     for i in range(min(count, 1_000_000))]
            with self.events_lock:
                self.events.map_tiles.extend(tiles)
        elif msg_type in (P.LOD_CHUNK_INITIAL_SEND,
                          P.LOD_CHUNK_UPDATED_MESSAGE):
            from substrata_tpu_torch.shared.records import LODChunk
            with self.events_lock:
                self.events.lod_chunks.append(LODChunk.from_bytes(payload))
        elif msg_type in (P.AVATAR_EXITED_VEHICLE, P.AVATAR_SAT_ON_SEAT,
                          P.AVATAR_GOT_UP_FROM_SEAT):
            av_uid, veh_uid, seat = P.unpack_avatar_seat_change(payload)
            with ws.lock:
                av = ws.avatars.get(av_uid)
                if av is not None:
                    if msg_type == P.AVATAR_SAT_ON_SEAT:
                        av.entered_vehicle_uid = veh_uid
                        av.vehicle_seat_index = seat
                    else:
                        av.entered_vehicle_uid = 0
                        av.vehicle_seat_index = 0
            with self.events_lock:
                self.events.seat_changes.append(
                    (msg_type, av_uid, veh_uid, seat))
        elif msg_type in (P.AUDIO_STREAM_TO_SERVER_STARTED,
                          P.AUDIO_STREAM_TO_SERVER_ENDED):
            av_uid, rate, sid = P.unpack_audio_stream_state(payload)
            with ws.lock:
                av = ws.avatars.get(av_uid)
                if av is not None:
                    av.audio_stream_id = (
                        sid if msg_type == P.AUDIO_STREAM_TO_SERVER_STARTED
                        else 0)
            with self.events_lock:
                self.events.audio_streams.append(
                    (msg_type, av_uid, rate, sid))
        elif msg_type == P.ETH_TRANSACTION_SUBMITTED:
            (parcel_id,) = struct.unpack_from("<I", payload, 0)
            raw_hex, _ = P.unpack_string(payload, 4)
            with self.events_lock:
                self.events.eth.append((True, parcel_id, raw_hex))
        elif msg_type == P.ETH_TRANSACTION_SUBMISSION_FAILED:
            err, _ = P.unpack_string(payload, 0)
            with self.events_lock:
                self.events.eth.append((False, None, err))
        elif msg_type in (P.BUILDER_AI_TEXT_DELTA, P.BUILDER_AI_TOOL_ACTIVITY,
                          P.BUILDER_AI_TURN_COMPLETE, P.BUILDER_AI_ERROR):
            kind = {P.BUILDER_AI_TEXT_DELTA: "text_delta",
                    P.BUILDER_AI_TOOL_ACTIVITY: "tool_activity",
                    P.BUILDER_AI_TURN_COMPLETE: "turn_complete",
                    P.BUILDER_AI_ERROR: "error"}[msg_type]
            text, _ = P.unpack_string(payload, 0)
            with self.events_lock:
                self.events.builder_ai.append((kind, text))


# ---------------------------------------------------------------------------
# Dedicated resource-transfer connections (Protocol.h:70-76 connection types)
# ---------------------------------------------------------------------------

def _resource_handshake(host, port, conn_type, world_name="",
                        tls_context=tls.DEV_TLS):
    sock = socket.create_connection((host, port), timeout=10.0)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    # Same TLS-by-default as the updates plane: the reference wraps EVERY
    # game-port connection type, including resource transfer.
    ctx = tls.resolve_client_context(tls_context)
    if ctx is not None:
        sock = ctx.wrap_socket(sock, server_hostname=host)
    sock.sendall(struct.pack("<II", P.CYBERSPACE_HELLO,
                             P.CYBERSPACE_PROTOCOL_VERSION))
    buf = b""
    while len(buf) < 8:
        d = sock.recv(8 - len(buf))
        if not d:
            raise ConnectionError("eof in handshake")
        buf += d
    code, _ = struct.unpack("<II", buf)
    if code != P.CLIENT_PROTOCOL_OK:
        raise ConnectionError(f"server rejected protocol: {code}")
    wb = world_name.encode("utf-8")
    sock.sendall(struct.pack("<II", conn_type, 0)
                 + struct.pack("<I", len(wb)) + wb)
    return sock


def upload_resource(host: str, port: int, url: str, data: bytes,
                    world_name: str = "", tls_context=tls.DEV_TLS) -> int:
    """UploadResourceThread counterpart: one resource over a
    ConnectionTypeUploadResource (501) connection.  Returns the server's
    response code (UploadAllowed on success, else an error id from
    Protocol.h:173-178).  ``tls_context`` as ``Client``'s (None: plaintext,
    for a server started with ``tls_context=None``)."""
    sock = _resource_handshake(host, port, P.CONNECTION_TYPE_UPLOAD_RESOURCE,
                               world_name, tls_context)
    try:
        ub = url.encode("utf-8")
        sock.sendall(struct.pack("<I", len(ub)) + ub
                     + struct.pack("<II", 0, len(data)))
        (code,) = struct.unpack("<I", sock.recv(4))
        if code != P.UPLOAD_ALLOWED:
            return code
        sock.sendall(data)
        (code,) = struct.unpack("<I", sock.recv(4))
        return code
    finally:
        sock.close()


def upload_photo(host: str, port: int, username: str, password: str,
                 image_data: bytes, caption: str = "",
                 world_name: str = "", parcel_id: int = -1,
                 cam_pos=(0.0, 0.0, 0.0), cam_angles=(0.0, 0.0, 0.0)) -> int:
    """Client photo-mode upload over a ConnectionTypeUploadPhoto (506)
    connection (server/WorkerThreadUploadPhotoHandling.cpp wire format:
    username/password auth, world name, parcel id, camera pose, caption,
    u64-length JPEG).  Returns the server response code
    (PHOTO_UPLOAD_SUCCEEDED on success)."""
    sock = _resource_handshake(host, port, P.CONNECTION_TYPE_UPLOAD_PHOTO,
                               world_name)
    try:
        sock.sendall(P.pack_string(username) + P.pack_string(password)
                     + P.pack_string(world_name)
                     + struct.pack("<I", parcel_id & 0xFFFFFFFF)
                     + struct.pack("<3d", *cam_pos)
                     + struct.pack("<3d", *cam_angles)
                     + P.pack_string(caption)
                     + struct.pack("<Q", len(image_data)))
        sock.sendall(image_data)
        (code,) = struct.unpack("<I", sock.recv(4))
        return code
    finally:
        sock.close()


class ResourceDownloader:
    """DownloadResourcesThread counterpart (gui_client, 387 LoC): a
    dedicated ConnectionTypeDownloadResources (502) connection that fetches
    resources the client is missing and stores them into its
    ResourceManager."""

    def __init__(self, host: str, port: int, resource_manager=None,
                 world_name: str = "", tls_context=tls.DEV_TLS):
        self.sock = _resource_handshake(
            host, port, P.CONNECTION_TYPE_DOWNLOAD_RESOURCES, world_name, tls_context)
        self.resource_manager = resource_manager
        self._reader = P.MessageReader()

    def fetch(self, urls, timeout: float = 10.0):
        """Blocking fetch: {url: bytes | None}."""
        body = struct.pack("<I", len(urls))
        for u in urls:
            body += P.pack_string(u)
        self.sock.sendall(P.make_message(P.GET_FILES, body))
        out = {}
        self.sock.settimeout(timeout)
        pending = set(urls)
        try:
            while pending:
                data = self.sock.recv(1 << 20)
                if not data:
                    break
                self._reader.feed(data)
                for msg_type, payload in self._reader.messages():
                    if msg_type != P.GET_FILE:
                        continue
                    url, off = P.unpack_string(payload, 0)
                    found, dlen = struct.unpack_from("<BI", payload, off)
                    blob = payload[off + 5:off + 5 + dlen] if found else None
                    out[url] = blob
                    pending.discard(url)
                    if found and self.resource_manager is not None:
                        self.resource_manager.store_resource(url, blob)
        except OSError:
            pass
        for u in pending:
            out.setdefault(u, None)
        return out

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass
